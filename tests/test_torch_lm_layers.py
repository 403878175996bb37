"""The port's LM layers (``repro_torch.models.{layers,moe,mamba2}``)
against the reference's on the same inputs: numpy arrays from a seed go
through the jax function and its port, every attention mode included
(causal, sliding window, bidirectional, cross, cross-decode with static
K/V, decode against a cache, flash and window-skip flash at
``attn_kv_block=4``), the MLP, embed/unembed, MoE (output and both
auxiliary losses) and Mamba2 (chunked forward and one decode step).

Tolerances, as |port - reference| <= tol x max |reference|: float32
1e-5; bfloat16 compute (inputs and weights rounded to bfloat16 the same
way on both sides) 2e-2, about three bfloat16 ulps of the largest value,
since the two libraries round their bfloat16 intermediates at different
points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import layers as jl, mamba2 as jm, moe as jmoe
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import layers as tl, mamba2 as tm, moe as tmoe

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")
B, S, D = 2, 8, 32


def _cfgs(dtype="float32", **kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=D, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=96,
                qkv_bias=True, dtypes=("float32", dtype))
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _jtree(tree, dtype):
    return jax.tree.map(lambda a: _j(a, dtype), tree)


def _ttree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _ttree(v, dtype) for k, v in tree.items()}
    return _t(tree, dtype)


def _params(init, cfg, seed=0):
    """Reference weights as numpy, with random norms and biases so those
    terms are exercised too."""
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 100)

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else
                (v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
                 if v.ndim == 1 else v) for k, v in t.items()}
    return fill(tree)


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= TOL[dtype] * scale, f"{err} > {TOL[dtype]} x {scale}"


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- norms ---
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    x, scale = _x((B, S, D)), _x((D,), 2) * 0.1
    _close(tl.rms_norm(_t(scale, "float32"), _t(x, dtype), eps=1e-6),
           jl.rms_norm(_j(scale, "float32"), _j(x, dtype), eps=1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    x = _x((B, S, 4, 8))
    pos = np.arange(3, 3 + S)[None, :]
    _close(tl.rope(_t(x, dtype), torch.from_numpy(pos), theta=1e4),
           jl.rope(_j(x, dtype), jnp.asarray(pos), theta=1e4), dtype)


# ------------------------------------------------------------ attention ---
ATTN_MODES = {
    "causal": dict(causal=True, window=None),
    "window": dict(causal=True, window=3),
    "bidirectional": dict(causal=False, window=None),
}


def _attn(mode, dtype, *, kv_block=1024, seq=S):
    jc, tc = _cfgs(dtype, attn_kv_block=kv_block)
    p = _params(jl.init_attention, jc)
    x = _x((B, seq, D))
    pos = np.arange(seq)[None, :]
    kw = dict(mode)
    jo, jcache = jl.attention(_jtree(p, dtype), _j(x, dtype), cfg=jc,
                              positions=jnp.asarray(pos), **kw)
    to, tcache = tl.attention(_ttree(p, dtype), _t(x, dtype), cfg=tc,
                              positions=torch.from_numpy(pos), **kw)
    assert jcache is None and tcache is None
    _close(to, jo, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", sorted(ATTN_MODES))
def test_attention_self(mode, dtype):
    _attn(ATTN_MODES[mode], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["causal", "window"])
def test_attention_flash_paths(mode, dtype):
    """attn_kv_block 4 over 16 positions: the blockwise flash form (full
    attention) and the window-skip form (sliding window 5)."""
    kw = dict(ATTN_MODES[mode])
    if mode == "window":
        kw["window"] = 5
    _attn(kw, dtype, kv_block=4, seq=16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_cross(dtype):
    jc, tc = _cfgs(dtype)
    p = _params(jl.init_attention, jc)
    x, kv = _x((B, S, D)), _x((B, 6, D), 2)
    pos, kpos = np.arange(S)[None, :], np.arange(6)[None, :]
    jo, _ = jl.attention(_jtree(p, dtype), _j(x, dtype), cfg=jc,
                         positions=jnp.asarray(pos), kv=_j(kv, dtype),
                         kv_positions=jnp.asarray(kpos), causal=False)
    to, _ = tl.attention(_ttree(p, dtype), _t(x, dtype), cfg=tc,
                         positions=torch.from_numpy(pos), kv=_t(kv, dtype),
                         kv_positions=torch.from_numpy(kpos), causal=False)
    _close(to, jo, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_static_kv(dtype):
    jc, tc = _cfgs(dtype)
    p = _params(jl.init_attention, jc)
    x = _x((B, 1, D))
    k, v = _x((B, 6, 2, 8), 2), _x((B, 6, 2, 8), 3)
    pos = np.array([[4]])
    jo, _ = jl.attention(_jtree(p, dtype), _j(x, dtype), cfg=jc,
                         positions=jnp.asarray(pos), causal=False,
                         static_kv={"k": _j(k, dtype), "v": _j(v, dtype)})
    to, _ = tl.attention(_ttree(p, dtype), _t(x, dtype), cfg=tc,
                         positions=torch.from_numpy(pos), causal=False,
                         static_kv={"k": _t(k, dtype), "v": _t(v, dtype)})
    _close(to, jo, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 3])
def test_attention_decode_with_cache(window, dtype):
    """One decode step at pos 5 against a cache whose first 5 positions
    hold earlier keys/values (the rest is garbage the mask must hide);
    the cache is bfloat16, as the launcher's default."""
    jc, tc = _cfgs(dtype)
    p = _params(jl.init_attention, jc)
    x = _x((B, 1, D))
    ck, cv = _x((B, 10, 2, 8), 2), _x((B, 10, 2, 8), 3)
    pos = 5
    jcache = {"k": _j(ck, "bfloat16"), "v": _j(cv, "bfloat16"),
              "pos": jnp.asarray(pos, jnp.int32)}
    tcache = {"k": _t(ck, "bfloat16"), "v": _t(cv, "bfloat16"), "pos": pos}
    jo, jn = jl.attention(_jtree(p, dtype), _j(x, dtype), cfg=jc,
                          positions=jnp.full((1, 1), pos), window=window,
                          cache=jcache)
    to, tn = tl.attention(_ttree(p, dtype), _t(x, dtype), cfg=tc,
                          positions=torch.full((1, 1), pos), window=window,
                          cache=tcache)
    _close(to, jo, dtype)
    _close(tn["k"], jn["k"], dtype)
    _close(tn["v"], jn["v"], dtype)
    assert tn["pos"] == int(jn["pos"]) == pos + 1


# -------------------------------------------------------- mlp / embed ---
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    jc, tc = _cfgs(dtype)
    p = _params(jl.init_mlp, jc)
    x = _x((B, S, D))
    _close(tl.mlp(_ttree(p, dtype), _t(x, dtype), cfg=tc),
           jl.mlp(_jtree(p, dtype), _j(x, dtype), cfg=jc), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed(tied, dtype):
    jc, tc = _cfgs(dtype)
    table = np.asarray(jl.init_embed(jax.random.PRNGKey(0), jc))
    head = _x((D, jc.vocab_size), 4) * D ** -0.5
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, S))
    jx = jl.embed(jnp.asarray(table), jnp.asarray(toks), jc)
    tx = tl.embed(torch.from_numpy(table), torch.from_numpy(toks), tc)
    _close(tx, jx, dtype)
    w = table if tied else head
    _close(tl.unembed(torch.from_numpy(w), tx, tc, tied=tied),
           jl.unembed(jnp.asarray(w), jx, jc, tied=tied), dtype)


# ------------------------------------------------------------------ moe ---
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", [0, 1])
def test_moe(shared, dtype):
    """4 experts top-2 in groups of 8 tokens with the default capacity
    factor, so some tokens are dropped; random inputs, no ties."""
    jc, tc = _cfgs(dtype, n_experts=4, top_k=2, moe_d_ff=24,
                   moe_group_size=8, n_shared_experts=shared)
    p = _params(jmoe.init_moe, jc)
    x = _x((B, S, D))
    jo, jaux = jmoe.moe(_jtree(p, dtype), _j(x, dtype), cfg=jc)
    to, taux = tmoe.moe(_ttree(p, dtype), _t(x, dtype), cfg=tc)
    _close(to, jo, dtype)
    for k in ("moe_lb_loss", "moe_z_loss"):
        _close(taux[k].reshape(1), jnp.reshape(jaux[k], (1,)), dtype)


def test_moe_decode_group_and_capacity():
    """At decode T = B: the port picks the reference's group size and
    capacity."""
    jc, tc = _cfgs(n_experts=4, top_k=2, moe_d_ff=24, moe_group_size=6)
    for T in (1, 2, 3, 4, 12, 64):
        g = tmoe._group_size(T, tc)
        jg = min(jc.moe_group_size, T)
        while T % jg:
            jg //= 2
        assert g == jg
        assert tmoe._capacity(g, tc) == jmoe._capacity(jg, jc)


# --------------------------------------------------------------- mamba2 ---
def _mcfgs(dtype):
    return _cfgs(dtype, family="ssm", ssm_state=8, ssm_heads=4, ssm_chunk=4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_mixer(dtype):
    jc, tc = _mcfgs(dtype)
    p = _params(jm.init_mamba, jc)
    x = _x((B, 16, D))
    _close(tm.mamba_mixer(_ttree(p, dtype), _t(x, dtype), cfg=tc),
           jm.mamba_mixer(_jtree(p, dtype), _j(x, dtype), cfg=jc), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode(dtype):
    jc, tc = _mcfgs(dtype)
    p = _params(jm.init_mamba, jc)
    x = _x((B, 1, D))
    d_in, H, P, N, conv_dim = tm._dims(tc)
    conv = _x((B, tc.ssm_conv - 1, conv_dim), 2)
    ssm = _x((B, H, N, P), 3)
    jo, jn = jm.mamba_decode(_jtree(p, dtype), _j(x, dtype),
                             {"conv": _j(conv, dtype),
                              "ssm": _j(ssm, "float32")}, cfg=jc)
    to, tn = tm.mamba_decode(_ttree(p, dtype), _t(x, dtype),
                             {"conv": _t(conv, dtype),
                              "ssm": _t(ssm, "float32")}, cfg=tc)
    _close(to, jo, dtype)
    _close(tn["conv"], jn["conv"], dtype)
    _close(tn["ssm"], jn["ssm"], dtype)
    assert str(tn["ssm"].dtype) == "torch.float32"


def test_mamba_long_chunk_gradients_are_finite():
    """A chunk of 128 tokens at A = -1: above the diagonal ``cum_q -
    cum_k`` passes 88 and ``exp`` overflows float32, so the reference's
    masked product has NaN gradients (0 x inf) for every leaf before the
    SSD.  The port masks inside the ``exp``: the reference's output
    (within the float32 bar), and every gradient finite and within 1e-5
    of its largest of the reference's gradient at chunk 8, where nothing
    overflows (the SSD is the same function at any chunk length)."""
    jc, tc = _cfgs(family="ssm", ssm_state=8, ssm_heads=4, ssm_chunk=128)
    jc8 = _cfgs(family="ssm", ssm_state=8, ssm_heads=4, ssm_chunk=8)[0]
    p = _params(jm.init_mamba, jc)
    x = _x((B, 128, D))
    jp, jx = _jtree(p, "float32"), _j(x, "float32")
    tp = {k: v.requires_grad_() for k, v in _ttree(p, "float32").items()}
    out = tm.mamba_mixer(tp, _t(x, "float32"), cfg=tc)
    _close(out.detach(), jm.mamba_mixer(jp, jx, cfg=jc), "float32")
    grads = torch.autograd.grad(out.sum(), list(tp.values()))

    def grad_of(cfg):
        return jax.grad(lambda q: jnp.sum(jm.mamba_mixer(q, jx, cfg=cfg)))(jp)

    assert not all(bool(jnp.isfinite(g).all()) for g in grad_of(jc).values())
    want = grad_of(jc8)
    for k, g in zip(tp, grads):
        w = np.asarray(want[k])
        assert bool(torch.isfinite(g).all()), k
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * np.abs(w).max(), k
