"""The LM serving record (``src/repro_torch/data/reference/
lm_serve_smoke.npz``, described in `repro_torch.testing.lm_record`).

This test regenerates the record from ``repro`` and asserts it is
unchanged, so it cannot go stale: weights, prompt and tokens exactly, the
logits to 1e-6 relative (the last bits of a float32 product may move with
the BLAS build).  It also holds the port's CPU run of the same loop
against the record: logits within ``LOGITS_TOL`` (1e-4) x max |logits|,
greedy tokens equal.  ``tests/test_torch_lm_card.py`` does the same on
the card.  Regenerate with
``PYTHONPATH=src python tests/test_torch_reference_record_lm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models import build_model
from repro.train import make_serve_step
from repro_torch.testing import lm_record as lr


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def build_record() -> dict:
    out = {}
    for arch in lr.ARCHS:
        cfg = get_smoke_config(arch).scaled(dtypes=lr.F32_DTYPES)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        prompt = lr.record_prompt(cfg)
        cache = model.init_cache(params, lr.BATCH, lr.PROMPT + lr.GEN + 1,
                                 dtype=jnp.float32)
        step = jax.jit(model.decode_step)
        serve = jax.jit(make_serve_step(model))
        logits = []
        for t in range(lr.PROMPT):
            lg, cache = step(params, cache, jnp.asarray(prompt[:, t:t + 1]))
            logits.append(np.asarray(lg))
        tok = jnp.argmax(logits[-1], axis=-1).astype(jnp.int32)[:, None]
        toks = []
        for _ in range(lr.GEN):
            cache, tok = serve(params, cache, tok)
            toks.append(np.asarray(tok))
        for path, a in _flat(params):
            out[f"{arch}:params/{path}"] = a
        out[f"{arch}:prompt"] = prompt
        out[f"{arch}:logits"] = np.stack(logits, 1)
        out[f"{arch}:tokens"] = np.concatenate(toks, 1)
    return out


@pytest.fixture(scope="module")
def record():
    return lr.load_record()


def test_record_is_current():
    fresh = build_record()
    with np.load(lr.RECORD) as z:
        assert sorted(z.files) == sorted(fresh)
        for key, want in fresh.items():
            got = z[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            if key.endswith(":logits"):
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
    assert lr.RECORD.stat().st_size < 1 << 20


@pytest.mark.parametrize("arch", lr.ARCHS)
def test_port_cpu_run_matches_record(record, arch):
    rec = record[arch]
    logits, tokens = lr.run_record(arch, rec["params"], rec["prompt"], "cpu")
    res = lr.compare(rec, logits, tokens)
    assert res["logits_err_rel"] < lr.LOGITS_TOL, res
    assert res["tokens_equal"], (tokens, rec["tokens"])


if __name__ == "__main__":
    np.savez_compressed(lr.RECORD, **build_record())
    print(f"wrote {lr.RECORD} ({lr.RECORD.stat().st_size} bytes)")
