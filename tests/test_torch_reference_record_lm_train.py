"""The LM training record (``src/repro_torch/data/reference/
lm_train_smoke.npz``, described in `repro_torch.testing.lm_train_record`).

This test regenerates the record from ``repro`` (three
``make_train_step`` steps from the serving record's weights) and asserts
it is unchanged, so it cannot go stale: ``lr`` exactly, the other arrays
to 1e-6 relative (the last bits of a float32 product may move with the
BLAS build).  It also holds the port's CPU run of the same steps against
the record with the module's tolerances (metrics within 1e-5 relative,
moments within 1e-5 of each leaf's largest, parameters within 1e-6
absolute but for the counted small-gradient elements, bounded by 2 x the
sum of lr).  ``tests/test_torch_lm_card.py`` does the same on the card.
Regenerate with
``PYTHONPATH=src python tests/test_torch_reference_record_lm_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_train_parity import few_threads  # an autouse fixture

from repro.configs import get_smoke_config
from repro.models import build_model
from repro.optim import adamw
from repro.train import TrainState, make_train_step
from repro_torch.testing import lm_record as lr
from repro_torch.testing import lm_train_record as ltr


def build_record() -> dict:
    serve = lr.load_record()
    out = {}
    for arch in ltr.ARCHS:
        cfg = get_smoke_config(arch).scaled(dtypes=lr.F32_DTYPES)
        model = build_model(cfg)
        params = jax.tree.map(jnp.asarray, serve[arch]["params"])
        state = TrainState(params=params, opt=adamw.init(params),
                           step=jnp.zeros((), jnp.int32))
        step = jax.jit(make_train_step(model))
        rows = {k: [] for k in ltr.METRICS}
        for toks in ltr.record_batches(cfg):
            state, m = step(state, {"tokens": jnp.asarray(toks)})
            for k in ltr.METRICS:
                rows[k].append(np.asarray(m[k]))
        for k, v in rows.items():
            out[f"{arch}:{k}"] = np.stack(v).astype(np.float32)
        for kind, tree in (("params", state.params), ("mu", state.opt.mu),
                           ("nu", state.opt.nu)):
            for path, a in ltr.flatten(jax.tree.map(np.asarray, tree)):
                out[f"{arch}:{kind}/{path}"] = a
    return out


@pytest.fixture(scope="module")
def record():
    return ltr.load_record()


def test_record_is_current():
    fresh = build_record()
    with np.load(ltr.RECORD) as z:
        assert sorted(z.files) == sorted(fresh)
        for key, want in fresh.items():
            got = z[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            if key.endswith(":lr"):
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=1e-6,
                    atol=1e-6 * max(float(np.abs(want).max()), 1e-30),
                    err_msg=key)
    assert ltr.RECORD.stat().st_size < 2_621_440


@pytest.mark.parametrize("arch", ltr.ARCHS)
def test_port_cpu_run_matches_record(record, arch):
    rec = record[arch]
    res = ltr.compare(rec, ltr.run_record(arch, rec["init"], "cpu"))
    assert ltr.passes(res), res


if __name__ == "__main__":
    np.savez_compressed(ltr.RECORD, **build_record())
    print(f"wrote {ltr.RECORD} ({ltr.RECORD.stat().st_size} bytes)")
