"""The port's models (``repro_torch.models``) against the reference's, for
every architecture's ``SMOKE`` config, on weights carried across by
`repro_torch.convert.lm_params_from_reference`:

- float32 dtypes: ``forward`` logits and the MoE auxiliary losses, and the
  logits of ``S`` decode steps, within 1e-4 x max |logits|; the greedy
  serve loop's tokens equal;
- the default dtypes (float32 parameters, bfloat16 compute, bfloat16
  cache): the first decode step's logits within 5e-2 x max |logits|
  (about six bfloat16 ulps of the largest logit: the two libraries round
  bfloat16 intermediates at different points, and the difference grows
  with depth);
- the compute-dtype copy has, leaf by leaf, the dtype of the reference's
  ``cast_params`` output (the stacked-leaf rule of `cast_params`);
- `lm_params_to_reference` inverts `lm_params_from_reference`: the
  reference's tree comes back exactly (keys, shapes, dtypes, values).

Then the port-only counterparts of ``tests/test_models.py``: decode equals
forward (dense, sliding window, mamba, hybrid MoE, encoder-decoder), the
SSD is invariant to the chunk size, flash equals vanilla attention.

Each reference model is built and initialised once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_smoke_config as jsmoke
from repro.models import build_model as jbuild, cast_params as jcast
from repro.train import make_serve_step as jserve_step
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (
    lm_params_from_reference, lm_params_to_reference,
)
from repro_torch.models import build_model, param_count
from repro_torch.models.layers import flash_attention
from repro_torch.train import make_serve_step

F32 = ("float32", "float32")
B, S, GEN = 2, 8, 6
TOL_F32, TOL_BF16 = 1e-4, 5e-2


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.num_patches:
        b["image_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in b.items()}


class _Ref:
    """One arch's reference model, weights and runs, made once."""

    def __init__(self, arch):
        self.arch = arch
        self.jm = jbuild(jsmoke(arch).scaled(dtypes=F32))
        self.params = self.jm.init(jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, self.params)
        self.batch = _batch(self.jm.cfg)

    def port(self, dtypes=F32):
        m = build_model(tsmoke(self.arch).scaled(dtypes=dtypes),
                        device="cpu")
        return lm_params_from_reference(m, self.tree)

    def cache(self, model, dtype, max_len):
        if model.cfg.is_encoder_decoder:
            return model.init_cache(self.params, _jb(self.batch), max_len,
                                    dtype=dtype)
        return model.init_cache(self.params, B, max_len, dtype=dtype)


@pytest.fixture(scope="module")
def refs():
    return {}


def _ref(refs, arch):
    if arch not in refs:
        refs[arch] = _Ref(arch)
    return refs[arch]


def _tcache(model, batch, dtype, max_len):
    if model.cfg.is_encoder_decoder:
        return model.init_cache(_tb(batch), max_len, dtype=dtype)
    return model.init_cache(B, max_len, dtype=dtype)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_matches_reference(refs, arch):
    r = _ref(refs, arch)
    jl, jaux = jax.jit(r.jm.forward)(r.params, _jb(r.batch))
    with torch.no_grad():
        tl, taux = r.port()(_tb(r.batch))
    assert _rel(tl.numpy(), jl) < TOL_F32
    for k in ("moe_lb_loss", "moe_z_loss"):
        want = float(jaux[k])
        assert abs(float(taux[k]) - want) <= TOL_F32 * max(abs(want), 1.0), k


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_and_greedy_tokens_match_reference(refs, arch):
    """S decode steps' logits, then the serve loop's GEN greedy tokens."""
    r = _ref(refs, arch)
    tm = r.port()
    toks = r.batch["tokens"]
    jcache = r.cache(r.jm, jnp.float32, S + GEN + 1)
    tcache = _tcache(tm, r.batch, torch.float32, S + GEN + 1)
    step = jax.jit(r.jm.decode_step)
    for t in range(S):
        jlg, jcache = step(r.params, jcache, jnp.asarray(toks[:, t:t + 1]))
        tlg, tcache = tm.decode_step(tcache, torch.from_numpy(
            toks[:, t:t + 1]).long())
        assert _rel(tlg.numpy(), jlg) < TOL_F32, t
    jserve, tserve = jax.jit(jserve_step(r.jm)), make_serve_step(tm)
    jtok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tlg, dim=-1)[:, None]
    jout, tout = [], []
    for _ in range(GEN):
        jcache, jtok = jserve(r.params, jcache, jtok)
        tcache, ttok = tserve(tcache, ttok)
        jout.append(np.asarray(jtok))
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_bf16_first_step_logits(refs, arch):
    r = _ref(refs, arch)
    jm = jbuild(jsmoke(arch))
    tm = r.port(dtypes=jsmoke(arch).dtypes)
    tok = r.batch["tokens"][:, :1]
    jlg, _ = jm.decode_step(r.params, r.cache(jm, jnp.bfloat16, 4),
                            jnp.asarray(tok))
    tlg, _ = tm.decode_step(_tcache(tm, r.batch, torch.bfloat16, 4),
                            torch.from_numpy(tok).long())
    assert str(tlg.dtype) == f"torch.{jlg.dtype}"
    assert _rel(tlg.float().numpy(), jlg.astype(jnp.float32)) < TOL_BF16


def _leaf_dtypes(tree, prefix=()):
    """{reference path: dtype name}; a port list level (periods) is
    dropped from the path, and its leaves gathered under one path."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaf_dtypes(v, prefix + (k,)))
    elif isinstance(tree, list):
        for v in tree:
            for path, dt in _leaf_dtypes(v, prefix).items():
                assert out.setdefault(path, dt) == dt, path
    else:
        out[prefix] = str(tree.dtype).removeprefix("torch.")
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m",
                                  "whisper-medium"])
def test_compute_copy_has_the_reference_cast_dtypes(refs, arch):
    """Default dtypes: every leaf of the port's compute copy has the
    dtype of the reference's leaf after ``cast_params`` (stacked norm
    scales, biases, A_log, dt_bias, ssm_D in bfloat16; final_norm and
    enc_norm float32)."""
    cfg = jsmoke(arch)
    jtree = jcast(jbuild(cfg).init(jax.random.PRNGKey(0)), cfg)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        want[tuple(p.key for p in path)] = str(leaf.dtype)
    m = build_model(tsmoke(arch), device="cpu")
    with torch.no_grad():
        got = _leaf_dtypes(m.compute_params())
    assert got == want
    assert "bfloat16" in got.values() and "float32" in got.values()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_to_reference_inverts_from_reference(refs, arch):
    r = _ref(refs, arch)
    got = lm_params_to_reference(r.port())
    want = r.tree
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("smoke", [False, True])
def test_registry_matches_reference(smoke):
    """Every config's fields, the shapes and the (arch, shape) cells."""
    from dataclasses import asdict

    import repro.configs as jc
    import repro_torch.configs as tc

    assert tc.ARCH_NAMES == jc.ARCH_NAMES
    get = "get_smoke_config" if smoke else "get_config"
    for arch in jc.ARCH_NAMES:
        j, t = getattr(jc, get)(arch), getattr(tc, get)(arch)
        assert asdict(t) == asdict(j), arch
        assert (t.hd, t.periods, t.layer_list()) == (j.hd, j.periods,
                                                     j.layer_list())
        assert str(t.param_dtype) == f"torch.{j.param_dtype}"
        assert str(t.compute_dtype) == f"torch.{j.compute_dtype}"
    assert {k: asdict(v) for k, v in tc.SHAPES.items()} == \
        {k: asdict(v) for k, v in jc.SHAPES.items()}
    assert tc.cells(include_skipped=True) == jc.cells(include_skipped=True)
    assert tc.NYTIMES == tc.spca_experiments.NYTIMES


# ----------------------------------- port-only model behaviour (test_models)
V = 128


def _toks(Bn=2, Sn=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, V, (Bn, Sn), generator=g)


def _check_decode(cfg, batch, tol=2e-3):
    m = build_model(cfg, device="cpu")
    with torch.no_grad():
        logits_full, _ = m(batch)
    toks = batch["tokens"]
    Bn, Sn = toks.shape
    if cfg.is_encoder_decoder:
        cache = m.init_cache(batch, Sn + 2, dtype=torch.float32)
    else:
        cache = m.init_cache(Bn, Sn + 2, dtype=torch.float32)
    outs = []
    for t in range(Sn):
        lg, cache = m.decode_step(cache, toks[:, t:t + 1])
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    err = float(torch.max(torch.abs(dec - logits_full)))
    scale = max(float(torch.max(torch.abs(logits_full))), 1.0)
    assert err < tol * scale, f"{cfg.name}: decode mismatch {err} (scale {scale})"


DECODE_CASES = {
    "dense": (dict(name="d", family="dense", n_layers=3, d_model=48,
                   n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=V,
                   dtypes=F32, qkv_bias=True), {}),
    "local_window": (dict(name="l", family="dense", n_layers=2, d_model=48,
                          n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=V,
                          window=4, dtypes=F32,
                          period=(("attn_local", "mlp"),)), {}),
    "mamba": (dict(name="m", family="ssm", n_layers=3, d_model=48,
                   n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=V,
                   dtypes=F32, period=(("mamba", None),), ssm_state=16,
                   ssm_heads=6, ssm_chunk=4), {}),
    "hybrid_moe": (dict(
        name="j", family="hybrid", n_layers=4, d_model=48, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab_size=V, dtypes=F32,
        period=(("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp"),
                ("mamba", "moe")),
        n_periods=1, n_experts=4, top_k=2, moe_d_ff=32, ssm_state=8,
        ssm_heads=4, ssm_chunk=4, moe_group_size=16,
        capacity_factor=4.0,  # no token dropping -> decode must match exactly
    ), {}),
    "encdec": (dict(name="w", family="audio", n_layers=2, d_model=48,
                    n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=V,
                    dtypes=F32, is_encoder_decoder=True,
                    n_encoder_layers=2, encoder_seq=8),
               {"enc_frames": (2, 8, 48)}),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_matches_forward(case):
    kw, extra = DECODE_CASES[case]
    batch = {"tokens": _toks()}
    g = torch.Generator().manual_seed(3)
    for k, shape in extra.items():
        batch[k] = torch.randn(shape, generator=g)
    _check_decode(ModelConfig(**kw), batch)


def test_ssd_chunk_size_invariance():
    """The chunked SSD must be invariant to the chunk size."""
    toks = _toks(2, 24)
    outs = []
    for chunk in (4, 8, 24):
        cfg = ModelConfig(name=f"m{chunk}", family="ssm", n_layers=2,
                          d_model=32, n_heads=4, n_kv_heads=4, d_ff=0,
                          vocab_size=V, dtypes=F32, period=(("mamba", None),),
                          ssm_state=8, ssm_heads=4, ssm_chunk=chunk)
        with torch.no_grad():
            lg, _ = build_model(cfg, device="cpu")({"tokens": toks})
        outs.append(lg.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 64])
def test_flash_equals_vanilla_gqa(window):
    rng = np.random.default_rng(0)
    Bn, Sn, K, rep, hd = 2, 512, 2, 3, 16
    q = torch.from_numpy(rng.normal(size=(Bn, Sn, K, rep, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(Bn, Sn, K, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(Bn, Sn, K, hd)).astype(np.float32))
    pos = torch.arange(Sn)[None, :]
    out_f = flash_attention(q, k, v, pos, pos, causal=True, window=window,
                            kv_block=128)
    sc = torch.einsum("bqkrd,bskd->bkrqs", q, k) * hd ** -0.5
    ok = pos[0][:, None] >= pos[0][None, :]
    if window:
        ok &= (pos[0][:, None] - pos[0][None, :]) < window
    sc = torch.where(ok[None, None, None], sc, -1e30)
    out_v = torch.einsum("bkrqs,bskd->bqkrd", torch.softmax(sc, -1), v)
    np.testing.assert_allclose(out_f.numpy(), out_v.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_vlm_loss_aligns_text_labels():
    cfg = ModelConfig(name="v", family="vlm", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=V,
                      dtypes=F32, num_patches=4)
    m = build_model(cfg, device="cpu")
    batch = {"tokens": _toks(2, 8),
             "image_embeds": torch.randn(
                 (2, 4, 32), generator=torch.Generator().manual_seed(2))}
    loss, metrics = m.loss(batch)
    assert np.isfinite(float(loss.detach()))
    logits, _ = m(batch)
    assert logits.shape == (2, 12, V)


def test_param_count_positive_and_grad_finite():
    cfg = ModelConfig(name="g", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=V,
                      dtypes=F32)
    m = build_model(cfg, device="cpu")
    assert param_count(m) == param_count(m.params()) > 0
    loss, _ = m.loss({"tokens": _toks()})
    loss.backward()
    for p in m.parameters():
        assert p.grad is not None and torch.all(torch.isfinite(p.grad))


def test_convert_refuses_missing_and_extra_leaves(refs):
    r = _ref(refs, "qwen2-0.5b")
    tree = {k: v for k, v in r.tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        lm_params_from_reference(
            build_model(tsmoke("qwen2-0.5b").scaled(dtypes=F32),
                        device="cpu"), tree)
    tree = dict(r.tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra"):
        lm_params_from_reference(
            build_model(tsmoke("qwen2-0.5b").scaled(dtypes=F32),
                        device="cpu"), tree)
