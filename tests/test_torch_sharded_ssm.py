"""The partitioned train step on the two configurations with Mamba2
blocks (mamba2-130m: every block; jamba-v0.1-52b: seven of eight, beside
attention, the MLP and MoE), float32 smoke configs, against the
reference and against the port's one-device step.

The reference side runs once, in a child interpreter with 8 forced XLA
devices (``tests/test_torch_sharded_train.py``'s way): for each config its
``PRNGKey(0)`` weights and two train steps on one batch (8 rows of 16
tokens, numpy seed 0), single-device, with ``microbatches=2`` and on a
``(2, 2)`` mesh.

Bars:
- the port's ``(2, 2)`` and ``(1, 4)`` steps (Mamba2 in ``heads`` mode:
  2 and 1 of the 4 heads a lane; jamba's attention, with 2 KV heads, in
  ``heads`` mode at M 2 and ``ctx`` mode at M 4) against the reference's
  single-device and ``(2, 2)`` steps, and mamba2-130m's at D 2 against
  its ``microbatches=2`` step: every metric of the three steps within
  1e-5 relative, and the parameters and both moments after the last step
  within 1e-4 absolute (the reference test's bars).  The MoE
  load-balancing loss (a product of two means over the tokens) is pooled
  over the data groups (`train_step._pooled_router_groups`), so jamba's
  mesh step at D 2 is the reference's whole-batch step;
- the MoE configs (jamba, phi3.5-moe, deepseek-moe) at ``(2, 2)``,
  ``(2, 1)`` and ``(1, 4)`` against the reference's single-device step,
  and jamba's ``(2, 2)`` step with ``microbatches=2`` (each group's
  microbatch the reference's rows) against the reference's
  ``microbatches=2`` step, within the same bars;
- a ``(2, 1)`` step against the port's one-device step with
  ``microbatches=2``: bit for bit (metrics, parameters, moments) for
  mamba2-130m; for jamba (MoE) against the reference's single-device
  step within the bars above, since its load-balancing loss is now the
  whole batch's, not the mean of two microbatches';
- counted by ``repro_torch.testing.tally.GatherTally`` and each gather's
  shape: no lane gathers a whole ``in_proj`` or ``out_proj``; each
  lane's Mamba2 block is exactly its share (``ln`` whole; of ``in_proj``
  the ``z``, ``x`` and ``dt`` columns of its heads and all of ``B`` and
  ``C``; of ``conv`` its heads' ``x`` channels and all of ``B``/``C``;
  ``1/M`` of ``out_proj`` and of the per-head leaves and ``ssm_norm``);
  and at mamba2-130m with 4 layers a lane's live gathered weights stay
  between one and two periods' shares above its embedding slice.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_train_parity import _state_np, few_threads  # noqa: F401

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import (
    lm_params_from_reference, train_state_to_reference,
)
from repro_torch.distributed import partition, sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model, mamba2
from repro_torch.testing.tally import GatherTally
from repro_torch.train import init_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mamba2-130m", "jamba-v0.1-52b")
MOE_ARCHS = ("jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b")
# the reference steps each config needs: (tag, mesh shape or None, mb)
REF_TAGS = {a: (("one", None, 1), ("mb2", None, 2), ("mesh", (2, 2), 1))
            for a in ARCHS}
REF_TAGS.update({a: (("one", None, 1),) for a in MOE_ARCHS[1:]})
F32 = ("float32", "float32")
ROWS, SEQ, STEPS = 8, 16, 3
METRIC_RTOL, STATE_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def eight_lanes(monkeypatch):
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "8")


def _unflatten(flat):
    out = {}
    for key, a in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{arch: {"toks", "init" (a tree), "one"/"mesh": {"metrics": [per
    step], "params"/"mu"/"nu": {path: array}}}}."""
    out = str(tmp_path_factory.mktemp("ref") / "ssm.npz")
    prog = textwrap.dedent(f"""
        import contextlib, os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_smoke_config
        from repro.distributed.sharding import use_mesh, _path_str
        from repro.launch.mesh import make_dev_mesh
        from repro.models import build_model
        from repro.train import init_state, make_train_step

        def flat(tree, tag):
            return {{tag + _path_str(p): np.asarray(x) for p, x in
                    jax.tree_util.tree_flatten_with_path(tree)[0]}}

        rec = {{}}
        for arch, tags in {REF_TAGS!r}.items():
            cfg = get_smoke_config(arch).scaled(dtypes={F32!r})
            m = build_model(cfg)
            state0 = init_state(m, jax.random.PRNGKey(0))
            toks = np.random.default_rng(0).integers(
                0, cfg.vocab_size, ({ROWS}, {SEQ})).astype(np.int32)
            rec[arch + ":toks"] = toks
            rec.update(flat(state0.params, arch + ":init:"))
            for tag, shape, mb in tags:
                mesh = shape and make_dev_mesh(shape, ("data", "model"))
                state = state0
                with (contextlib.nullcontext() if mesh is None
                      else use_mesh(mesh)):
                    step = jax.jit(make_train_step(m, microbatches=mb))
                    for i in range({STEPS}):
                        state, met = step(state, {{"tokens": jnp.asarray(toks)}})
                        for k, v in met.items():
                            rec[f"{{arch}}:{{tag}}:m{{i}}:{{k}}"] = np.asarray(v)
                for name, tree in (("params", state.params),
                                   ("mu", state.opt.mu),
                                   ("nu", state.opt.nu)):
                    rec.update(flat(tree, f"{{arch}}:{{tag}}:{{name}}:"))
        np.savez({out!r}, **rec)
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as z:
        rec = {k: z[k] for k in z.files}
    res = {}
    for arch, tags in REF_TAGS.items():
        def part(tag):
            n = len(tag)
            return {k[n:]: v for k, v in rec.items() if k.startswith(tag)}
        res[arch] = {"toks": rec[arch + ":toks"],
                     "init": _unflatten(part(arch + ":init:"))}
        for tag, _, _ in tags:
            got = {"metrics": [
                {k: float(v) for k, v in part(f"{arch}:{tag}:m{i}:").items()}
                for i in range(STEPS)]}
            for name in ("params", "mu", "nu"):
                got[name] = part(f"{arch}:{tag}:{name}:")
            res[arch][tag] = got
    return res


def _model(arch, reference, **overrides):
    cfg = tsmoke(arch).scaled(dtypes=F32, **overrides)
    m = build_model(cfg, device="cpu")
    if reference is not None:
        lm_params_from_reference(m, reference[arch]["init"])
    return m


def _run(arch, reference, *, shape=None, microbatches=1):
    """The port's ``STEPS`` steps from the reference's weights: per-step
    metrics and the final state in the reference's layout (numpy)."""
    m = _model(arch, reference)
    if shape is None:
        step = make_train_step(m, microbatches=microbatches)
    else:
        mesh = tmesh.make_dev_mesh(shape, ("data", "model"), device="cpu")
        with sh.use_mesh(mesh):
            step = make_train_step(m, microbatches=microbatches)
    batch = {"tokens": torch.from_numpy(reference[arch]["toks"])}
    state, metrics = init_state(m), []
    for _ in range(STEPS):
        state, met = step(state, batch)
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, _state_np(train_state_to_reference(state)), state


def _against(reference, arch, tags, metrics, state):
    for tag in tags:
        want = reference[arch][tag]
        for got_m, want_m in zip(metrics, want["metrics"]):
            assert set(got_m) == set(want_m)
            for k, v in want_m.items():
                assert abs(got_m[k] - v) <= METRIC_RTOL * max(1.0, abs(v)), \
                    (tag, k, got_m[k], v)
        for name in ("params", "mu", "nu"):
            assert set(state[name]) == set(want[name]), name
            d = max(float(np.abs(state[name][k] - a).max())
                    for k, a in want[name].items())
            assert d < STATE_ATOL, (tag, name, d)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_split_step_matches_the_reference(reference, arch, shape):
    """Against the reference's single-device and ``(2, 2)`` steps, and
    mamba2-130m's at D 2 its ``microbatches=2`` step (jamba's MoE
    load-balancing loss is pooled over the data groups, so its D 2 step
    is the whole batch's, as the reference's mesh step)."""
    metrics, state, _ = _run(arch, reference, shape=shape)
    tags = ("one", "mesh") if shape[0] == 1 or tsmoke(arch).n_experts \
        else ("one", "mesh", "mb2")
    _against(reference, arch, tags, metrics, state)


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 4)],
                         ids=["2x2", "2x1", "1x4"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mesh_step_matches_the_reference(reference, arch, shape):
    """The MoE configs' mesh steps against the reference's single-device
    step: the load-balancing loss pooled over the data groups is the
    whole batch's (it was the mean of each group's, 1.0e-2 apart on
    jamba at (2, 2): ROADMAP queue 3, repaired)."""
    metrics, state, _ = _run(arch, reference, shape=shape)
    _against(reference, arch, ("one",), metrics, state)


def test_moe_mesh_microbatches_take_the_reference_rows(reference):
    """jamba's ``(2, 2)`` step with ``microbatches=2``: microbatch ``j``
    is the reference's rows ``[4j, 4j + 4)``, split over the two groups,
    its load-balancing loss pooled over them: the reference's
    ``microbatches=2`` step."""
    arch = "jamba-v0.1-52b"
    metrics, state, _ = _run(arch, reference, shape=(2, 2), microbatches=2)
    _against(reference, arch, ("mb2",), metrics, state)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_mesh_step_equals_microbatches_bit_for_bit(reference, arch):
    """mamba2-130m: ``(2, 1)`` equals the one-device ``microbatches=2``
    step bit for bit.  jamba (MoE): its ``(2, 1)`` step pools the
    load-balancing loss over the groups, so it is the reference's
    single-device step's, within the bars, not two microbatches'."""
    m2, s2, _ = _run(arch, reference, shape=(2, 1))
    if tsmoke(arch).n_experts:
        _against(reference, arch, ("one",), m2, s2)
        assert (s2["count"], s2["step"]) == (STEPS, STEPS)
        return
    m1, s1, _ = _run(arch, reference, microbatches=2)
    assert m1 == m2
    for name in ("params", "mu", "nu"):
        for k, a in s1[name].items():
            assert np.array_equal(a.view(np.int32),
                                  s2[name][k].view(np.int32)), (name, k)
    assert (s1["count"], s1["step"]) == (s2["count"], s2["step"]) \
        == (STEPS, STEPS)


def _mamba_share_bytes(cfg, M) -> dict:
    """The float32 bytes of each leaf of a Mamba2 block a lane gathers at
    ``M`` lanes over ``model``."""
    d_in, H, P, N, _ = mamba2._dims(cfg)
    d, Hm, dm = cfg.d_model, H // M, d_in // M
    n = {"ln": d, "in_proj": d * (2 * dm + 2 * N + Hm),
         "conv": cfg.ssm_conv * (dm + 2 * N), "A_log": Hm, "ssm_D": Hm,
         "dt_bias": Hm, "ssm_norm": dm, "out_proj": dm * d}
    return {k: 4 * v for k, v in n.items()}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_no_lane_gathers_a_whole_mamba_block(arch, shape, monkeypatch):
    """Every Mamba2 block runs in ``heads`` mode, and every lane's share of
    it (each time it is gathered: the forward pass and the recompute) is
    the count of `_mamba_share_bytes`; no gather returns a whole
    ``in_proj`` or ``out_proj``.  mamba2-130m at 4 layers (4 periods,
    remat per period): a lane's live gathered weights lie between one and
    two periods' shares above its top-level leaves."""
    layers = dict(n_layers=4, n_periods=4) if arch == "mamba2-130m" else {}
    m = _model(arch, None, **layers)
    cfg = m.cfg
    n_blocks = sum(mixer == "mamba" for st in m.stack_specs
                   for mixer, _ in st.period) * cfg.n_periods
    mesh = tmesh.make_dev_mesh(shape, ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        step = make_train_step(m)
    modes, shares, seen = [], [], []
    block_modes, heads_tree = (partition.GroupPlan._block_modes,
                               partition.GroupPlan._heads_tree)

    def record_modes(self, block, seq):
        out = block_modes(self, block, seq)
        modes.extend(v for k, v in out.items() if k == "mixer_ssm")
        return out

    def record_share(self, sub, m):
        out = heads_tree(self, sub, m)
        shares.append((self.lanes[m], {
            k: v.numel() * v.element_size() for k, v in out.items()}))
        return out

    monkeypatch.setattr(partition.GroupPlan, "_block_modes", record_modes)
    monkeypatch.setattr(partition.GroupPlan, "_heads_tree", record_share)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (ROWS, SEQ)))
    with GatherTally() as tally:
        counted = sh.gather

        def record(s, *args, lane=None, **kw):
            out = counted(s, *args, lane=lane, **kw)
            seen.append((tuple(s.shape), tuple(out.shape)))
            return out

        monkeypatch.setattr(sh, "gather", record)
        state, _ = step(init_state(m), {"tokens": toks})
    d_in, H, P, N, _ = mamba2._dims(cfg)
    whole = {(cfg.d_model, 2 * d_in + 2 * N + H), (d_in, cfg.d_model)}
    assert not [f for f, got in seen if f in whole and got == f]
    share = _mamba_share_bytes(cfg, shape[1])
    assert modes and set(modes) == {"heads"}
    for lane in range(mesh.size):
        mine = [t for i, t in shares if i == lane]
        assert len(mine) >= n_blocks
        assert all(t == share for t in mine), (lane, mine[0], share)
    if arch != "mamba2-130m":
        return
    one = sum(share.values())
    for lane in range(mesh.size):
        top = sh.region_slices(state.params["embed"], lane, ("data",))
        top = 4 * int(np.prod([r.stop - r.start for r in top]))
        if mesh.coords(lane)["model"] == 0:
            top += 4 * cfg.d_model                  # final_norm, whole
        assert one + top <= tally.high[lane] <= 2 * one + top, \
            (lane, tally.high[lane], one, top)
        assert tally.live[lane] == 0
