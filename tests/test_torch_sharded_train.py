"""The port's sharded train step (``repro_torch.train.make_train_step``
under ``use_mesh`` of a ``LaneMesh``), its checkpoints and the launcher's
``--mesh`` against the one-device step and against the reference.

The reference side runs once, in a child interpreter with 8 forced XLA
devices (``tests/test_distributed.py``'s way): its single-device and
``(4, 2)`` steps on ``tests/test_distributed.py:182-210``'s config (2
layers, d 32, 4 heads, 2 KV heads, vocab 128, float32), and its training
launcher (``--mesh 1x1``, float32 dtypes, every step logged) from a
step-0 checkpoint of its ``PRNGKey(0)`` state.

Bars:
- a ``(D, 1)`` step (``(2, 1)``, ``(4, 1)``) on CPU lanes against the
  port's one-device step with ``microbatches=D``: bit for bit (loss,
  metrics, parameters, moments);
- the ``(4, 2)``, ``(2, 2)`` and ``(2, 4)`` steps, whose products split
  over ``model`` (`distributed.partition`: heads at M 2, the ``ctx``
  rows at M 4, the vocabulary), against the reference's single-device
  and ``(4, 2)`` steps: the reference test's 1e-5 on the loss and 1e-4
  on the parameters (and the same bars against the port's
  ``microbatches=D`` step);
- each lane holds exactly its shards at rest: the shard shapes of its
  spec, the slices of the gathered tensor;
- no lane holds a replica (4 layers, so two periods are half the
  model): counted by ``repro_torch.testing.tally.GatherTally``, a lane's
  live gathered weights never exceed two periods' leaves for it (its
  ``model`` slice, or the whole leaf where its share needs it) plus the
  embedding, head and final-norm leaves it takes; each gradient the step
  takes is of one shard;
- checkpoints: a ``2x1`` run's equals the ``1x1 --microbatches 2`` run's
  byte for byte (manifest and npz members), a ``2x2`` run's within 1e-4
  on every leaf (manifests equal); a ``2x2`` checkpoint resumed on ``1x1
  --microbatches 2`` ends within 1e-4 of the uninterrupted ``2x2`` run,
  and on ``4x1`` within 1e-6 absolute on every leaf; the reference
  restores the sharded run's checkpoint;
- the launcher's lines at ``--mesh 2x1`` equal ``--mesh 1x1
  --microbatches 2``'s (but for times), at ``--mesh 2x2`` their losses
  are within 1e-5; its losses are within ``test_torch_train_launch.py``'s
  float32 bar (1e-5 relative) of the reference launcher's at ``--mesh
  1x1``.
"""
import ast
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from test_torch_train_parity import few_threads  # noqa: F401 (autouse)

from repro.checkpoint import checkpoint as jck
from repro.configs import get_smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro.train import init_state as jinit
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (
    lm_params_from_reference, lm_params_to_reference,
)
from repro_torch.distributed import partition, sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim.adamw import _leaves
from repro_torch.testing.tally import GatherTally
from repro_torch.train import init_state, make_train_step
from repro_torch.train import train_step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab_size=128,
           dtypes=("float32", "float32"))
ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "6", "--batch", "4",
        "--seq", "16"]
F32 = ("float32", "float32")


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
    root = tmp_path_factory.mktemp("ref")
    start = str(root / "start")
    jck.save(start, 0, jinit(jbuild(jsmoke("qwen2-0.5b").scaled(dtypes=F32)),
                             jax.random.PRNGKey(0)))
    shutil.copytree(start, str(root / "launch"))
    out = str(root / "steps.npz")
    prog = textwrap.dedent(f"""
        import os, sys, io, contextlib
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs.base import ModelConfig
        from repro.distributed.sharding import use_mesh, _path_str
        from repro.launch.mesh import make_dev_mesh
        from repro.models import build_model
        from repro.train import init_state, make_train_step

        def flat(tree, tag):
            return {{tag + _path_str(p): np.asarray(x) for p, x in
                    jax.tree_util.tree_flatten_with_path(tree)[0]}}

        m = build_model(ModelConfig(**{CFG!r}))
        state = init_state(m, jax.random.PRNGKey(0))
        toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 128)
        s1, m1 = jax.jit(make_train_step(m))(state, {{"tokens": toks}})
        with use_mesh(make_dev_mesh((4, 2), ("data", "model"))):
            s2, m2 = jax.jit(make_train_step(m))(state, {{"tokens": toks}})
        np.savez({out!r}, toks=np.asarray(toks),
                 loss1=np.asarray(m1["loss"]), loss2=np.asarray(m2["loss"]),
                 **flat(state.params, "init:"), **flat(s1.params, "one:"),
                 **flat(s2.params, "mesh:"))

        from repro.launch import train
        config = train.TrainerConfig
        train.TrainerConfig = lambda **kw: config(**{{**kw, "log_every": 1}})
        smoke = train.get_smoke_config
        train.get_smoke_config = lambda a: smoke(a).scaled(
            dtypes=("float32", "float32"))
        sys.argv = ["train", *{ARGS!r}, "--ckpt-dir", {str(root / "launch")!r}]
        train.main()
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as z:
        rec = {k: z[k] for k in z.files}
    tree = lambda tag: _unflatten({  # noqa: E731
        k[len(tag):]: v for k, v in rec.items() if k.startswith(tag)})
    return {"toks": rec["toks"], "loss1": float(rec["loss1"]),
            "loss2": float(rec["loss2"]), "init": tree("init:"),
            "one": tree("one:"), "mesh": tree("mesh:"), "start": start,
            "launch_lines": r.stdout}


def _model(reference):
    return lm_params_from_reference(
        build_model(ModelConfig(**CFG), device="cpu"), reference["init"])


def _steps(reference, shape):
    """The port's ``microbatches=D`` step and its ``(D, M)`` step on the
    reference's batch and weights: (state, metrics) of each."""
    batch = {"tokens": torch.from_numpy(reference["toks"])}
    m1 = _model(reference)
    one = make_train_step(m1, microbatches=shape[0])(init_state(m1), batch)
    m2 = _model(reference)
    mesh = tmesh.make_dev_mesh(shape, ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        step = make_train_step(m2)
    assert step.mesh is mesh
    return one, step(init_state(m2), batch)


def _states(s1, s2):
    for tree in ("params", "mu", "nu"):
        a = s1.params if tree == "params" else getattr(s1.opt, tree)
        b = s2.params if tree == "params" else getattr(s2.opt, tree)
        for x, y in zip(_leaves(a), _leaves(b)):
            assert isinstance(y, sh.Sharded)
            yield tree, x, sh.gather(y)


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)], ids=["2x1", "4x1"])
def test_data_mesh_step_equals_microbatches_bit_for_bit(reference, shape):
    (s1, r1), (s2, r2) = _steps(reference, shape)
    for k in r1:
        assert torch.equal(r1[k], r2[k]), k
    for tree, x, y in _states(s1, s2):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), tree
    assert int(s2.step) == int(s2.opt.count) == 1


def _against_reference(reference, s1, r1, s2, r2):
    for k in r1:
        assert abs(float(r1[k]) - float(r2[k])) <= 1e-5 * max(
            1.0, abs(float(r1[k]))), k
    for tree, x, y in _states(s1, s2):
        assert float((x.detach() - y).abs().max()) < 1e-4, tree
    assert int(s2.step) == int(s2.opt.count) == 1
    m3 = build_model(ModelConfig(**CFG), device="cpu")
    with torch.no_grad():
        for p, v in zip(_leaves(m3.params()), _leaves(s2.params)):
            p.copy_(sh.gather(v))
    got = dict(_flat(lm_params_to_reference(m3)))
    for name, want_tree in (("one", reference["one"]),
                            ("mesh", reference["mesh"])):
        want = dict(_flat(want_tree))
        assert set(got) == set(want)
        d = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        assert d < 1e-4, (name, d)
    for loss in (reference["loss1"], reference["loss2"]):
        assert abs(float(r2["loss"]) - loss) < 1e-5


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_model_split_step_matches_the_reference(reference, shape):
    (s1, r1), (s2, r2) = _steps(reference, shape)
    _against_reference(reference, s1, r1, s2, r2)


def test_sharded_step_equals_one_device_and_the_reference(reference):
    (s1, r1), (s2, r2) = _steps(reference, (4, 2))
    _against_reference(reference, s1, r1, s2, r2)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_each_lane_holds_only_its_shards(reference):
    m = _model(reference)
    mesh = tmesh.make_dev_mesh((4, 2), ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        step = make_train_step(m)
    state, _ = step(init_state(m),
                    {"tokens": torch.from_numpy(reference["toks"])})
    specs = []
    sh.tree_map(specs.append, step.specs)
    full = sum(p.numel() * 4 for p in _leaves(m.params()))
    sharded = 0
    for tree in (state.params, state.opt.mu, state.opt.nu):
        for leaf, spec in zip(_leaves(tree), specs):
            assert leaf.spec == spec and len(leaf.shards) == 8
            whole = sh.gather(leaf)
            for i, t in enumerate(leaf.shards):
                assert tuple(t.shape) == sh.shard_shape(leaf.shape, mesh,
                                                        spec)
                assert torch.equal(t, whole[sh.shard_slices(
                    leaf.shape, mesh, spec, i)])
            sharded += any(p is not None for p in spec)
    lane0 = sum(leaf.lane_bytes(0) for tree in (state.params, state.opt.mu,
                                                 state.opt.nu)
                for leaf in _leaves(tree))
    assert sharded > 0 and lane0 < 3 * full / 2


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 1)],
                         ids=["2x2", "2x4", "4x1"])
def test_no_lane_holds_a_replica(shape, monkeypatch):
    """4 layers (4 periods, remat per period): each lane's live gathered
    weights against two periods' leaves for it plus the top-level leaves
    it takes, and every gradient the step takes against its shard."""
    _no_replica(shape, monkeypatch, seq_parallel=False)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_no_lane_holds_a_replica_with_row_blocks(shape, monkeypatch):
    """As above under ``cfg.seq_parallel``, where every lane gathers a
    period's leaves whole and the head and final norm whole (its rows'
    logits over the whole vocabulary), home the embedding whole (the
    lookup): still at most two periods at once, under a replica."""
    _no_replica(shape, monkeypatch, seq_parallel=True)


def _no_replica(shape, monkeypatch, seq_parallel):
    cfg = ModelConfig(**{**CFG, "n_layers": 4, "seq_parallel": seq_parallel})
    m = build_model(cfg, device="cpu")
    mesh = tmesh.make_dev_mesh(shape, ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        step = make_train_step(m)
    grads = []
    loss_and_grads = tstep._loss_and_grads

    def record(loss_fn, inputs, *args):
        out = loss_and_grads(loss_fn, inputs, *args)
        grads.append([(tuple(g.shape), tuple(p.shape))
                      for g, p in zip(out[2], inputs)])
        return out

    monkeypatch.setattr(tstep, "_loss_and_grads", record)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 128, (8, 16)))
    with GatherTally() as tally:
        state, _ = step(init_state(m), {"tokens": toks})
    M = shape[1]
    slice_axes, whole_axes = ("data",), ("data", "model")
    rows = seq_parallel and M > 1     # every product on whole weights
    ctx = cfg.n_kv_heads % M != 0     # attention on whole weights

    def nbytes(s, lane, axes):
        r = sh.region_slices(s, lane, axes)
        return 4 * int(np.prod([x.stop - x.start for x in r]))

    periods = state.params["stacks"]["s0"]
    for lane in range(mesh.size):
        m_coord = mesh.coords(lane)["model"]

        def period(p):
            return sum(
                nbytes(s, lane, whole_axes if rows or ctx
                       and name == "mixer_attn" else slice_axes)
                for name, block in p["b0"].items() for s in block.values())

        one = max(period(p) for p in periods)
        # the leaves alive while every period runs: all the top-level
        # ones, or, gathered at their first use in row blocks, home's
        # embedding (the head is gathered after the periods' forward and
        # freed before their recompute)
        if rows:
            top = sum(nbytes(state.params[k], lane, whole_axes)
                      for k in ("lm_head", "final_norm"))
            held = 0
            if m_coord == 0:
                held = nbytes(state.params["embed"], lane, whole_axes)
                top += held
        else:
            top = sum(nbytes(state.params[k], lane, slice_axes)
                      for k in ("embed", "lm_head"))
        if m_coord == 0 and not rows:
            top += nbytes(state.params["final_norm"], lane, whole_axes)
        if not rows:
            held = top
        everything = sum(period(p) for p in periods) + top
        assert one + held <= tally.high[lane] <= 2 * one + top < everything, \
            (lane, tally.high[lane], one, top)
        assert tally.live[lane] == 0
    assert len(grads) == shape[0]
    for group in grads:
        assert all(g == p for g, p in group)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_plan_counts_bound_the_tally(shape):
    """A group's own counts (`GroupPlan`: its gathers, their bytes, the
    top-level and largest period's bytes a lane), from which the dry-run
    reckons a lane's gathered weights, against the tally of the same
    loss and gradients (4 layers, remat per period): the same gathers and
    bytes, and a lane's live high-water between one and two periods'
    bytes above its top-level leaves'."""
    _plan_counts(shape, seq_parallel=False)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_plan_counts_bound_the_tally_with_row_blocks(shape):
    """As above under ``cfg.seq_parallel`` (whole periods, the top-level
    leaves gathered at their first use, so the high-water is bounded
    below by the periods alone)."""
    _plan_counts(shape, seq_parallel=True)


def _plan_counts(shape, seq_parallel):
    cfg = ModelConfig(**{**CFG, "n_layers": 4, "seq_parallel": seq_parallel})
    m = build_model(cfg, device="cpu")
    mesh = tmesh.make_dev_mesh(shape, ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        specs = sh.param_pspecs(m.params())
    params = sh.tree_map(lambda x, s: sh.shard(x.detach(), mesh, s),
                         m.params(), specs)
    proxies = partition.Proxies(params)
    lanes = partition.group_lanes(mesh)[0]
    plan = partition.GroupPlan(m, mesh, lanes, proxies)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 128, (4, 16)))
    with GatherTally() as tally:
        tstep._loss_and_grads(
            lambda b: m.loss(b, layout=plan.layout), proxies.grad_inputs(),
            {"tokens": toks}, 1, torch.device("cpu"))
    for k, lane in enumerate(lanes):
        assert plan.gathers[k] == tally.calls[lane] > 0
        assert plan.gathered[k] == tally.total[lane]
        top, one = plan.top_bytes[k], plan.period_bytes[k]
        # in row blocks the head is gathered after the periods' forward
        # and freed before their recompute
        held = 0 if seq_parallel else top
        assert 0 < one and held + one <= tally.high[lane] <= top + 2 * one, \
            (lane, tally.high[lane], top, one)


def test_released_model_resumes_from_a_checkpoint(tmp_path):
    """The step shards the state it is given in place and releases its
    model's parameters (meta); a checkpoint restored into that model gets
    storage again (`reclaim`, as the trainer's restore does), and the
    step from it equals the step from the sharded state bit for bit."""
    from repro_torch.convert import (
        train_state_from_reference, train_state_to_reference,
    )

    m = build_model(ModelConfig(**CFG), device="cpu")
    mesh = tmesh.make_dev_mesh((2, 2), ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        step = make_train_step(m)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (4, 16)))
    given = init_state(m)
    state, _ = step(given, {"tokens": toks})
    assert m.device.type == "meta"
    assert all(isinstance(x, sh.Sharded) for x in _leaves(given.params))
    ck.save(str(tmp_path), 1, train_state_to_reference(state))
    restored = ck.restore(str(tmp_path), 1,
                          train_state_to_reference(state, like=True))
    step.model.reclaim()
    again = train_state_from_reference(step.model, restored)
    assert m.device.type == "cpu"
    a, ra = step(state, {"tokens": toks})
    b, rb = step(again, {"tokens": toks})
    for k in ra:
        assert torch.equal(ra[k], rb[k]), k
    for _, x, y in _states(a, b):
        assert torch.equal(sh.gather(x), y)


def test_elastic_checkpoint_restore_across_meshes(tmp_path):
    """``tests/test_distributed.py:161-179``'s case: saved sharded on a
    (4, 2) mesh, restored onto a (2, 4) mesh with the axes swapped."""
    x = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)
    mesh1 = tmesh.make_dev_mesh((4, 2), ("data", "model"), device="cpu")
    xs = sh.shard(torch.from_numpy(x), mesh1, sh.P("data", "model"))
    ck.save(str(tmp_path), 1, {"w": xs})
    mesh2 = tmesh.make_dev_mesh((2, 4), ("data", "model"), device="cpu")
    r = ck.restore(str(tmp_path), 1, {"w": torch.empty(16, 8)},
                   {"w": sh.NamedSharding(mesh2, sh.P("model", "data"))})
    assert isinstance(r["w"], sh.Sharded) and r["w"].mesh is mesh2
    assert r["w"].spec == sh.P("model", "data")
    assert tuple(r["w"].shards[0].shape) == (4, 4)
    np.testing.assert_array_equal(sh.gather(r["w"]).numpy(), x)
    got = jck.restore(str(tmp_path), 1,
                      {"w": jax.ShapeDtypeStruct((16, 8), np.float32)})
    np.testing.assert_array_equal(np.asarray(got["w"]), x)


def _launch(ckpt_dir, argv, monkeypatch, capsys, start=None):
    if start is not None and not os.path.exists(ckpt_dir):
        shutil.copytree(start, ckpt_dir)
    config = ttrain.TrainerConfig
    monkeypatch.setattr(ttrain, "TrainerConfig", lambda **kw: config(
        **{**kw, "log_every": 1}))
    smoke = ttrain.get_smoke_config
    monkeypatch.setattr(ttrain, "get_smoke_config",
                        lambda a: smoke(a).scaled(dtypes=F32))
    capsys.readouterr()
    ttrain.main(argv + ["--device", "cpu", "--ckpt-dir", ckpt_dir])
    monkeypatch.setattr(ttrain, "TrainerConfig", config)
    monkeypatch.setattr(ttrain, "get_smoke_config", smoke)
    return capsys.readouterr().out.strip().splitlines()


def _events(lines):
    """The launcher's events without their times; ``straggler`` events,
    which a step's wall time alone decides, are left out."""
    events = (ast.literal_eval(x) for x in lines if x.startswith("{"))
    return [{k: v for k, v in e.items() if k not in ("time", "step_time")}
            for e in events if e["kind"] != "straggler"]


def _npz(d, step=6):
    with np.load(os.path.join(d, f"step_{step:09d}", "host_00000.npz")) as z:
        return {k: z[k] for k in z.files}


def test_launcher_mesh_checkpoints_and_elastic_resume(reference, tmp_path,
                                                      monkeypatch, capsys):
    start = reference["start"]
    d = {k: str(tmp_path / k)
         for k in ("mesh", "micro", "data", "part", "part4")}
    mesh = _launch(d["mesh"], ARGS + ["--mesh", "2x2"], monkeypatch, capsys,
                   start)
    micro = _launch(d["micro"], ARGS + ["--microbatches", "2"], monkeypatch,
                    capsys, start)
    data = _launch(d["data"], ARGS + ["--mesh", "2x1"], monkeypatch, capsys,
                   start)
    assert mesh[-1] == micro[-1] == data[-1] == "final step 6"
    assert _events(data) == _events(micro)
    split, whole = _events(mesh), _events(micro)
    assert [{k: v for k, v in e.items() if k != "loss"} for e in split] \
        == [{k: v for k, v in e.items() if k != "loss"} for e in whole]
    for t, w in zip(split, whole):
        if "loss" in w:
            assert abs(t["loss"] - w["loss"]) <= 1e-5
    ref = _events(reference["launch_lines"].strip().splitlines())
    got = _events(mesh)
    assert [(e["kind"], e["step"]) for e in got] == \
        [(e["kind"], e["step"]) for e in ref]
    for t, j in zip(got, ref):
        if "loss" in j:
            assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
    man = "step_000000006/manifest.json"
    assert open(os.path.join(d["mesh"], man)).read() == \
        open(os.path.join(d["micro"], man)).read() == \
        open(os.path.join(d["data"], man)).read()
    a, b, two = _npz(d["mesh"]), _npz(d["micro"]), _npz(d["data"])
    assert list(a) == list(b) == list(two)
    assert all(two[k].dtype == b[k].dtype
               and two[k].tobytes() == b[k].tobytes() for k in b)
    assert all(a[k].dtype == b[k].dtype for k in a)
    assert max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               for k in a) < 1e-4
    # the reference restores the sharded run's checkpoint
    like = jax.eval_shape(lambda: jinit(jbuild(jsmoke("qwen2-0.5b").scaled(
        dtypes=F32)), jax.random.PRNGKey(0)))
    got = jck.restore(d["mesh"], 6, like)
    np.testing.assert_array_equal(np.asarray(got.params["embed"]),
                                  a[".params/embed"])
    # kill at 3 on 2x2, resume on 1x1 (microbatches 2) and on 4x1
    _launch(d["part"], ARGS[:4] + ["3"] + ARGS[5:] + ["--mesh", "2x2"],
            monkeypatch, capsys, start)
    shutil.copytree(d["part"], d["part4"])
    one = _launch(d["part"], ARGS + ["--microbatches", "2"], monkeypatch,
                  capsys)
    four = _launch(d["part4"], ARGS + ["--mesh", "4x1"], monkeypatch, capsys)
    for lines in (one, four):
        assert _events(lines)[0] == {"kind": "resume", "step": 3}
        assert lines[-1] == "final step 6"
    c = _npz(d["part"])
    assert max(float(np.abs(a[k].astype(np.float64) - c[k]).max())
               for k in a) < 1e-4
    e = _npz(d["part4"])
    worst = max(float(np.abs(a[k].astype(np.float64) - e[k]).max())
                for k in a)
    assert worst < 1e-6, worst


def test_launcher_mesh_needs_its_lanes(tmp_path, monkeypatch):
    monkeypatch.delenv(tmesh.FORCE_LANES_ENV)
    with pytest.raises(RuntimeError, match=tmesh.FORCE_LANES_ENV):
        ttrain.main(ARGS + ["--device", "cpu", "--mesh", "2x2",
                            "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    monkeypatch.setenv(tmesh.FORCE_LANES_ENV, "4")
    with pytest.raises(ValueError, match="does not split over 4"):
        ttrain.main(ARGS + ["--device", "cpu", "--mesh", "4x1",
                            "--batch", "6", "--ckpt-dir", str(tmp_path)])
