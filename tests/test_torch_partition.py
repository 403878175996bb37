"""The partitioned train step's blocks (``repro_torch.distributed.
partition.GroupPlan``) against the port's whole blocks and the
reference's, on the same numpy inputs (weights from the reference's init
at seed 0, with random norms and biases, ``test_torch_lm_layers.py``'s
way; inputs from seed 1).

Each case shards the block's leaves over a ``(1, M)`` mesh of CPU lanes by
``param_pspecs`` (as the sharded step stores them) and runs the lanes'
shares: attention in ``heads`` mode (K 2 at M 2: a lane's query heads
and the KV head they read) and in the reference's ``ctx`` mode (K 2 at
M 4: a lane's query rows against the whole K/V, each lane projecting
the K/V of its rows; causal, sliding window, the blockwise flash form),
cross attention (in ``ctx`` mode with the source's rows split over the
lanes, and with 6 rows over 4 lanes projected whole on lane 0), the MLP
split over its hidden dim, MoE over experts (with and without a shared expert), the
vocab-split embedding and the vocab-parallel cross entropy, and the
Mamba2 mixer split by head (``heads`` mode: a lane's columns of the
packed ``in_proj`` and ``conv`` with all of B and C, its rows of
``out_proj``, ``ssm_norm``'s mean pooled over the lanes), forward and
every leaf's gradient; with the heads not dividing over the lanes it
runs whole on lane 0.

Bar, float32: |split - whole| and |split - reference| at most 1e-6 x the
largest |whole|; the embedding lookup (one lane's row plus zeros) bit for
bit.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_layers import _cfgs, _j, _jtree, _params, _ttree, _x
from test_torch_train_parity import few_threads  # noqa: F401 (autouse)

from repro.models import layers as jl, mamba2 as jm, moe as jmoe
from repro.models.model import softmax_xent as jxent
from repro_torch.distributed import partition, sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tl, mamba2 as tm, moe as tmoe
from repro_torch.models.model import softmax_xent as txent

REL = 1e-6
B, S = 2, 8


@pytest.fixture(autouse=True)
def eight_lanes(monkeypatch):
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "8")


def _plan(tc, tree, M):
    """``tree`` (the model's layout, numpy leaves) sharded onto a (1, M)
    mesh of CPU lanes under ``param_pspecs``, and the group's plan."""
    mesh = tmesh.make_dev_mesh((1, M), ("data", "model"), device="cpu")
    t = sh.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                    tree)
    with sh.use_mesh(mesh):
        specs = sh.param_pspecs(t)
    params = sh.tree_map(lambda x, s: sh.shard(x, mesh, s), t, specs)
    return partition.GroupPlan(types.SimpleNamespace(cfg=tc), mesh,
                               partition.group_lanes(mesh)[0],
                               partition.Proxies(params))


def _share(tc, name, p, M, seq=S):
    plan = _plan(tc, {"stacks": {"s0": [{"b0": {name: p}}]}}, M)
    block = plan.proxies.tree["stacks"]["s0"][0]["b0"]
    return plan, plan._block_share(block, seq)


def _close(got, whole, ref=None):
    got, whole = got.detach(), whole.detach()
    assert got.shape == whole.shape
    scale = float(whole.abs().max())
    err = float((got - whole).abs().max())
    assert err <= REL * scale, f"split vs whole: {err} > {REL} x {scale}"
    if ref is not None:
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= REL * scale, f"split vs reference: {err}"


ATTN = {
    "heads_causal": (2, dict(causal=True, window=None), {}),
    "ctx_causal": (4, dict(causal=True, window=None), {}),
    "ctx_window": (4, dict(causal=True, window=3), {}),
    "ctx_flash": (4, dict(causal=True, window=None),
                  dict(attn_kv_block=4, seq=16)),
    "heads_cross": (2, dict(causal=False, window=None), dict(cross=6)),
    "ctx_cross": (4, dict(causal=False, window=None), dict(cross=8)),
    "ctx_cross_whole_source": (4, dict(causal=False, window=None),
                               dict(cross=6)),
}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_attention_split(case):
    M, kw, extra = ATTN[case]
    extra = dict(extra)
    seq, cross = extra.pop("seq", S), extra.pop("cross", None)
    jc, tc = _cfgs(**extra)
    p = _params(jl.init_attention, jc)
    x = _x((B, seq, jc.d_model))
    pos = np.arange(seq)[None, :]
    name = "mixer_attn" if cross is None else "cross"
    kv = kv_pos = jkv = jkv_pos = None
    if cross is not None:
        e = _x((B, cross, jc.d_model), 3)
        kv, jkv = torch.from_numpy(e), _j(e, "float32")
        kv_pos = torch.arange(cross)[None, :]
        jkv_pos = jnp.arange(cross)[None, :]
    ref, _ = jl.attention(_jtree(p, "float32"), _j(x, "float32"), cfg=jc,
                          positions=jnp.asarray(pos), kv=jkv,
                          kv_positions=jkv_pos, **kw)
    whole, _ = tl.attention(_ttree(p, "float32"), torch.from_numpy(x),
                            cfg=tc, positions=torch.from_numpy(pos), kv=kv,
                            kv_positions=kv_pos, **kw)
    plan, share = _share(tc, name, p, M, seq)
    assert share.modes[name] == case.split("_")[0]
    got = plan._attention(share, name, torch.from_numpy(x),
                          torch.from_numpy(pos), kv, kv_pos, **kw)
    _close(got, whole, ref)


@pytest.mark.parametrize("M", [2, 4])
def test_mlp_split(M):
    jc, tc = _cfgs()
    p = _params(jl.init_mlp, jc)
    x = _x((B, S, jc.d_model))
    plan, share = _share(tc, "ffn_mlp", p, M)
    assert share.modes["ffn_mlp"] == "split"
    got = plan._mlp(share, "ffn_mlp", torch.from_numpy(x))
    _close(got, tl.mlp(_ttree(p, "float32"), torch.from_numpy(x), cfg=tc),
           jl.mlp(_jtree(p, "float32"), _j(x, "float32"), cfg=jc))


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("M", [2, 4])
def test_moe_split_over_experts(M, shared):
    """4 experts top-2 in groups of 8 tokens (some tokens dropped), the
    experts split M ways; the auxiliary losses are lane 0's."""
    jc, tc = _cfgs(n_experts=4, top_k=2, moe_d_ff=24, moe_group_size=8,
                   n_shared_experts=shared)
    p = _params(jmoe.init_moe, jc)
    x = _x((B, S, jc.d_model))
    jo, jaux = jmoe.moe(_jtree(p, "float32"), _j(x, "float32"), cfg=jc)
    to, taux = tmoe.moe(_ttree(p, "float32"), torch.from_numpy(x), cfg=tc)
    plan, share = _share(tc, "ffn_moe", p, M)
    assert share.modes["ffn_moe"] == "split"
    assert share.modes["shared"] == ("split" if shared else "home")
    got, aux = plan._moe(share, torch.from_numpy(x))
    _close(got, to, jo)
    for k in ("moe_lb_loss", "moe_z_loss"):
        _close(aux[k].reshape(1), taux[k].reshape(1),
               jnp.reshape(jaux[k], (1,)))


def _top(tied, M):
    jc, tc = _cfgs(tie_embeddings=tied)
    table = np.asarray(jl.init_embed(jax.random.PRNGKey(0), jc))
    tree = {"embed": table,
            "final_norm": np.zeros((jc.d_model,), np.float32)}
    if not tied:
        tree["lm_head"] = _x((jc.d_model, jc.vocab_size), 4) \
            * jc.d_model ** -0.5
    plan = _plan(tc, tree, M)
    return jc, tc, tree, plan, plan.top()


@pytest.mark.parametrize("M", [2, 4])
def test_embedding_split_over_vocab(M):
    jc, tc, tree, plan, top = _top(True, M)
    assert plan._vocab_split("embed")
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, S))
    got = plan.embed(top, torch.from_numpy(toks))
    whole = tl.embed(torch.from_numpy(tree["embed"]),
                     torch.from_numpy(toks), tc)
    assert torch.equal(got, whole)
    _close(got, whole, jl.embed(jnp.asarray(tree["embed"]),
                                jnp.asarray(toks), jc))


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("M", [2, 4])
def test_vocab_parallel_cross_entropy(M, tied):
    """The loss of rows ``[0, S - 1)`` against the next tokens: a
    vocabulary slice of the logits a lane, max / sum of exponentials /
    the label's logit pooled over the lanes."""
    jc, tc, tree, plan, top = _top(tied, M)
    head = "embed" if tied else "lm_head"
    assert plan._vocab_split(head)
    xf = _x((B, S, jc.d_model), 6)
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (B, S))
    got = plan.xent(top, torch.from_numpy(xf), (0, S - 1),
                     torch.from_numpy(toks[:, 1:]))
    w = torch.from_numpy(tree[head])
    logits = tl.unembed(w, torch.from_numpy(xf), tc, tied=tied)
    whole = txent(logits[:, :-1], torch.from_numpy(toks[:, 1:]))
    jlog = jl.unembed(jnp.asarray(tree[head]), _j(xf, "float32"), jc,
                      tied=tied)
    ref = jxent(jlog[:, :-1], jnp.asarray(toks[:, 1:]))
    _close(got.reshape(1), whole.reshape(1), jnp.reshape(ref, (1,)))


def _mcfgs(**kw):
    """``test_torch_lm_layers.py``'s Mamba2 config: d_in 64, 4 heads of
    16, state 8, so ``in_proj`` is (32, 148): at M 2 and 4 its shards cut
    inside the x columns, not at a head."""
    return _cfgs(**{**dict(family="ssm", ssm_state=8, ssm_heads=4,
                           ssm_chunk=4), **kw})


def _mamba_grads(plan, share, x, r):
    """The split mixer's output on ``x`` and each leaf's gradient of
    ``sum(out * r)``, put together from its shards' gradients."""
    out = plan._mamba(share, x)
    inputs = plan.proxies.grad_inputs()
    grads = torch.autograd.grad(torch.sum(out * r), inputs,
                                allow_unused=True)
    whole, at = {}, 0
    block = plan.proxies.tree["stacks"]["s0"][0]["b0"]["mixer_ssm"]
    for k, name in enumerate(block):
        g = torch.zeros(plan.proxies.leaves[k].shape)
        for _, sl in plan.proxies.sources[k]:
            if grads[at] is not None:
                g[sl] = grads[at]
            at += 1
        whole[name] = g
    return out, whole


def _whole_grads(p, x, r, cfg):
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_()
              for k, v in p.items()}
    out = tm.mamba_mixer(leaves, x, cfg=cfg)
    names = list(leaves)
    grads = torch.autograd.grad(torch.sum(out * r),
                                [leaves[k] for k in names])
    return out, dict(zip(names, grads))


@pytest.mark.parametrize("M", [2, 4])
def test_mamba_split(M):
    """Lane ``m``'s heads ``[mH/M, (m+1)H/M)``: the output within 1e-6 of
    the whole mixer's largest value (and of the reference's), each leaf's
    gradient within 1e-6 of the whole mixer's gradient's largest; no lane
    gathers a whole ``in_proj`` or ``out_proj``."""
    jc, tc = _mcfgs()
    p = _params(jm.init_mamba, jc)
    x = torch.from_numpy(_x((B, 16, jc.d_model)))
    r = torch.from_numpy(_x((B, 16, jc.d_model), 8))
    plan, share = _share(tc, "mixer_ssm", p, M, 16)
    assert share.modes["mixer_ssm"] == "heads"
    d_in, H, P, N, conv_dim = tm._dims(tc)
    Hm = H // M
    for t in share.trees:
        m = t["mixer_ssm"]
        assert tuple(m["in_proj"].shape) == (jc.d_model,
                                            2 * Hm * P + 2 * N + Hm)
        assert tuple(m["conv"].shape) == (tc.ssm_conv, Hm * P + 2 * N)
        assert tuple(m["out_proj"].shape) == (Hm * P, jc.d_model)
        assert tuple(m["ssm_norm"].shape) == (Hm * P,)
        assert tuple(m["A_log"].shape) == (Hm,)
    got, grads = _mamba_grads(plan, share, x, r)
    whole, wgrads = _whole_grads(p, x, r, tc)
    _close(got, whole, jm.mamba_mixer(_jtree(p, "float32"),
                                      _j(x.numpy(), "float32"), cfg=jc))
    for k, g in wgrads.items():
        scale = float(g.abs().max())
        err = float((grads[k] - g).abs().max())
        assert err <= REL * scale, (k, err, scale)


def test_mamba_split_falls_back_where_heads_do_not_divide():
    """2 heads over 4 lanes: the mixer runs whole on lane 0 (its leaves
    gathered whole there, none on the other lanes), bit for bit the
    whole mixer."""
    jc, tc = _mcfgs(ssm_heads=2)
    p = _params(jm.init_mamba, jc)
    x = torch.from_numpy(_x((B, 16, jc.d_model)))
    plan, share = _share(tc, "mixer_ssm", p, 4, 16)
    assert share.modes["mixer_ssm"] == "home"
    assert [("mixer_ssm" in t) for t in share.trees] == [True] + [False] * 3
    got = plan._mamba(share, x)
    assert torch.equal(got, tm.mamba_mixer(_ttree(p, "float32"), x, cfg=tc))


def test_mamba_split_norms_over_all_channels():
    """``ssm_norm`` is one RMS norm over all ``d_in`` channels.  With the
    second half of the heads' ``z`` and ``x`` columns scaled by 8, a lane
    normalising its own channels alone is far from the whole mixer (more
    than 1e-2 of its largest value); the split mixer is within 1e-6."""
    jc, tc = _mcfgs()
    p = _params(jm.init_mamba, jc)
    d_in = tm._dims(tc)[0]
    w = np.array(p["in_proj"])
    for lo in (d_in // 2, d_in + d_in // 2):
        w[:, lo:lo + d_in // 2] *= 8.0
    p = {**p, "in_proj": w}
    x = torch.from_numpy(_x((B, 16, jc.d_model)))
    plan, share = _share(tc, "mixer_ssm", p, 2, 16)
    whole = tm.mamba_mixer(_ttree(p, "float32"), x, cfg=tc)
    _close(plan._mamba(share, x), whole)
    alone = 0
    for t in share.trees:
        t = t["mixer_ssm"]
        g = tm.mamba_gated(t, x, cfg=tc)
        alone = alone + tl.rms_norm(t["ssm_norm"], g, eps=tc.norm_eps) \
            @ t["out_proj"]
    gap = float((alone - whole).detach().abs().max())
    assert gap > 1e-2 * float(whole.abs().max()), gap
