"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's (``repro.optim``): the six cases of ``tests/test_optim.py``,
each run through both packages on the same numpy inputs, and AdamW's
``update`` on random trees with clipping on and off.

Tolerances: AdamW's parameters, moments and ``grad_norm`` within 1e-6
relative (float32 arithmetic in the same order; the reductions of the
norm differ in order), ``count`` equal, and so over the quadratic's
first 20 steps; `warmup_cosine` within one float32 ulp of its scale (the
spacing at 1.0) at every step from 0 to total + 10; `quantize`'s int8
payload and scales equal exactly (both libraries round half to even),
`dequantize` and `wire_bytes` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JCfg, adamw as jadamw
from repro.optim import warmup_cosine as jwarmup
from repro.optim.compression import (
    dequantize as jdequantize, quantize as jquantize, wire_bytes as jwire,
)
from repro_torch.optim import AdamWConfig, OptState, adamw, global_norm
from repro_torch.optim import warmup_cosine
from repro_torch.optim.compression import dequantize, quantize, wire_bytes


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _close(a, b, rtol):
    for x, y in zip(jax.tree.leaves(_np(a)), jax.tree.leaves(_np(b))):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=rtol,
                                   atol=rtol * max(np.abs(y).max(), 1e-30))


def test_adamw_converges_on_quadratic():
    """Both packages converge; in lockstep their iterates agree over the
    first ``LOCKSTEP`` steps.  Near the optimum Adam's step is lr times
    the sign of a vanishing gradient, so the two trajectories part by up
    to lr afterwards and are not compared there."""
    LOCKSTEP = 20
    target = np.random.default_rng(0).normal(size=(8, 8))
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.zeros((8, 8), dtype=torch.float64)}
    opt = adamw.init(params)
    tgt = torch.from_numpy(target)
    jt = jnp.asarray(target)
    jp, jo = {"w": jnp.zeros((8, 8))}, jadamw.init({"w": jnp.zeros((8, 8))})
    jcfg = JCfg(lr=0.1, weight_decay=0.0)

    @jax.jit
    def step(p, o):
        g = jax.grad(lambda p: jnp.sum((p["w"] - jt) ** 2))(p)
        return jadamw.update(g, o, p, jcfg)

    for i in range(300):
        w = params["w"].clone().requires_grad_(True)
        g = torch.autograd.grad(torch.sum((w - tgt) ** 2), w)[0]
        params, opt, m = adamw.update({"w": g}, opt, params, cfg)
        jp, jo, _ = step(jp, jo)
        if i < LOCKSTEP:
            np.testing.assert_allclose(params["w"].numpy(),
                                       np.asarray(jp["w"]), rtol=1e-6,
                                       atol=1e-7)
    assert float(torch.max(torch.abs(params["w"] - tgt))) < 1e-2
    assert float(jnp.max(jnp.abs(jp["w"] - jt))) < 1e-2
    assert int(opt.count) == int(jo.count) == 300


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((4,), dtype=torch.float64)}
    new, opt, metrics = adamw.update({"w": torch.full((4,), 1e6)},
                                     adamw.init(params), params, cfg)
    assert float(metrics["grad_norm"]) > 1e5  # reported norm is pre-clip
    jp = {"w": jnp.zeros((4,))}
    jnew, _, jm = jadamw.update({"w": jnp.full((4,), 1e6)}, jadamw.init(jp),
                                jp, JCfg(lr=1.0, clip_norm=1.0,
                                         weight_decay=0.0))
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(jm["grad_norm"]), rel=1e-6)
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-6)


def test_optimizer_state_structure_matches_params():
    params = {"a": torch.zeros((3, 3)), "b": {"c": torch.zeros((2,))}}
    opt = adamw.init(params)
    for tree in (opt.mu, opt.nu):
        assert list(tree) == list(params) and list(tree["b"]) == ["c"]
        assert tree["a"].shape == (3, 3) and tree["a"].dtype == torch.float32
    jopt = jadamw.init({"a": jnp.zeros((3, 3)), "b": {"c": jnp.zeros((2,))}})
    assert jax.tree.structure(jopt.mu) == jax.tree.structure(_np(opt.mu))
    assert opt.count.dtype == torch.int32 and int(opt.count) == 0
    assert isinstance(opt, OptState) and opt._fields == jopt._fields


def test_schedule_shape():
    assert float(warmup_cosine(0, warmup=10, total=100)) == 0.0
    assert abs(float(warmup_cosine(10, warmup=10, total=100)) - 1.0) < 1e-6
    end = float(warmup_cosine(100, warmup=10, total=100))
    assert abs(end - 0.1) < 1e-6  # floor
    mid = float(warmup_cosine(55, warmup=10, total=100))
    assert 0.1 < mid < 1.0


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.1),
                                                 (100, 10_000, 0.1),
                                                 (0, 50, 0.0), (7, 7, 0.3)])
def test_schedule_matches_reference_within_an_ulp(warmup, total, floor):
    steps = np.arange(0, total + 11)
    got = warmup_cosine(torch.from_numpy(steps), warmup=warmup, total=total,
                        floor=floor).numpy()
    want = np.asarray(jwarmup(jnp.asarray(steps), warmup=warmup, total=total,
                              floor=floor))
    assert got.dtype == want.dtype == np.float32
    # one ulp at the schedule's scale (the spacing at 1.0): torch's and
    # XLA's cosines differ by an ulp of the cosine, which is up to two
    # ulps of a result below 1/2
    ulp = np.spacing(np.float32(1.0))
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
    for s in (0, 1, warmup, total):
        assert float(warmup_cosine(s, warmup=warmup, total=total,
                                   floor=floor)) == pytest.approx(
            float(jwarmup(s, warmup=warmup, total=total, floor=floor)),
            abs=float(ulp))


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1024,)) * 5.0
    q, s, shape = quantize(torch.from_numpy(x), block=128)
    xr = dequantize(q, s, shape)
    blockmax = np.abs(x.reshape(-1, 128)).max(1)
    # per-block error <= scale/2 = max/254
    err = np.abs(xr.numpy() - x).reshape(-1, 128).max(1)
    assert (err <= blockmax / 254 + 1e-7).all()


@pytest.mark.parametrize("shape,block,scale", [((1024,), 128, 5.0),
                                               ((37, 11), 256, 1e-3),
                                               ((3, 5, 7), 16, 1e4),
                                               ((300,), 256, 0.0)])
def test_quantize_matches_reference_exactly(shape, block, scale):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x.reshape(-1)[:5] = [0.5, -0.5, 1.5, 2.5, -2.5]   # ties of the rounding
    q, s, shp = quantize(torch.from_numpy(x), block=block)
    jq, js, jshp = jquantize(jnp.asarray(x), block=block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert shp == tuple(jshp)
    np.testing.assert_array_equal(dequantize(q, s, shp).numpy(),
                                  np.asarray(jdequantize(jq, js, jshp)))
    assert wire_bytes(torch.from_numpy(x), block=block) == jwire(
        jnp.asarray(x), block=block)


def test_wire_bytes_compression_ratio():
    x = torch.zeros((1 << 20,), dtype=torch.float32)
    ratio = (x.numel() * 4) / wire_bytes(x)
    assert ratio > 3.8  # ~4x vs f32
    assert wire_bytes(x) == jwire(jnp.zeros((1 << 20,), jnp.float32))


def _random_tree(rng, scale):
    return {
        "w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
        "nested": {"b": (rng.normal(size=(5,)) * scale).astype(np.float32),
                   "a": (rng.normal(size=(2, 3, 4)) * scale)
                   .astype(np.float32)},
        "s": (rng.normal(size=()) * scale).astype(np.float32),
    }


@pytest.mark.parametrize("clip_norm,grad_scale", [(1.0, 10.0), (1.0, 1e-3),
                                                  (1e9, 1.0)],
                         ids=["clipped", "unclipped", "no_clip"])
def test_adamw_update_matches_reference_on_random_trees(clip_norm,
                                                         grad_scale):
    rng = np.random.default_rng(3)
    params = _random_tree(rng, 1.0)
    cfg = AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    jcfg = JCfg(lr=1e-2, clip_norm=clip_norm)
    tp, topt = _t(params), adamw.init(_t(params))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadamw.init(jp)
    for i in range(4):
        grads = _random_tree(rng, grad_scale)
        lr_scale = np.float32(0.25 * (i + 1))
        tp, topt, tm = adamw.update(_t(grads), topt, tp, cfg,
                                    lr_scale=torch.tensor(lr_scale))
        jp, jopt, jm = jadamw.update(jax.tree.map(jnp.asarray, grads), jopt,
                                     jp, jcfg, lr_scale=jnp.asarray(lr_scale))
        _close(tp, jp, 1e-6)
        _close(topt.mu, jopt.mu, 1e-6)
        _close(topt.nu, jopt.nu, 1e-6)
        assert int(topt.count) == int(jopt.count) == i + 1
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
    assert float(global_norm(_t(params))) == pytest.approx(
        float(jadamw.global_norm(jax.tree.map(jnp.asarray, params))),
        rel=1e-6)
