"""``cfg.seq_parallel`` in the port's partitioned train step and prefill
(`distributed.partition`: each data group's hidden state held in row
blocks on its model lanes between blocks) against the reference, on CPU
lanes at the smoke size in float32.

The reference side runs once, in a child interpreter with 8 forced XLA
devices (``tests/test_distributed.py``'s way): for each of the ten smoke
configs its single-device train steps and its prefill tokens from
``PRNGKey(0)`` weights on one batch (8 rows of 16 tokens, the image and
frame stand-ins of ``tests/test_archs_smoke.py``), and its ``(4, 2)``
mesh step with ``seq_parallel=True`` on ``tests/test_distributed.py``'s
config.  The reference's hints fix layouts, not arithmetic, so the port's
row-split steps are held within the sharded bars (1e-5 on the metrics,
relative to the larger of 1 and the value, 1e-4 absolute on parameters
and moments), as ``tests/test_torch_sharded_train.py`` holds its steps.

Bars:
- all ten configs at ``(2, 2)`` and ``(1, 4)`` with the setting, two
  steps, against the reference's single-device steps (a MoE config's
  load-balancing loss is pooled over the data groups, so its ``(2, M)``
  step is the whole batch's); and qwen2-0.5b and gemma3-27b (its
  8-token window) with 4-token KV blocks, where a lane receives and
  scores only the keys its rows can attend, blockwise;
- the port's ``(4, 2)`` step with the setting against the reference's
  ``(4, 2)`` step with it, and against its single-device step;
- ``(2, 1)`` with the setting equal to ``microbatches=2`` bit for bit (one
  model lane splits nothing);
- a sequence the model lanes do not divide (18 tokens on 4) runs as
  without the setting, bit for bit;
- the partitioned prefill at ``(2, 2)`` with the setting gives the
  reference's next tokens;
- decode with the setting (its MLP whole on home, as the reference's
  ``ctx`` of length 1 is dropped) within 1e-4 of the largest logit of the
  decode without it;
- no lane keeps a larger part of a period's input than its rows: the
  tensors autograd saves outside the checkpointed periods, counted by lane
  (`launch.dryrun.train_saved`), hold on each lane exactly one row block
  a period (and the final hidden state's rows), and the rows split the
  whole input that home keeps without the setting;
- weights are gathered instead of activations: under the setting every
  lane gathers a period's leaves whole, the MLP's too, and the whole
  embedding where it takes logits (the plan's counts, equal to
  `GatherTally`'s), where without it a lane gathers its columns and its
  slice of the vocabulary.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_train_parity import (  # noqa: F401 (few_threads: autouse)
    _state_np, few_threads, smoke_batch,
)

from repro_torch.configs import ARCH_NAMES, get_smoke_config as tsmoke
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (
    lm_params_from_reference, train_state_to_reference,
)
from repro_torch.distributed import partition, sharding as sh
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import build_model
from repro_torch.testing.tally import GatherTally
from repro_torch.train import (
    init_state, make_prefill_step, make_serve_step, make_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = ("float32", "float32")
ROWS, SEQ, STEPS = 8, 16, 2
METRIC_RTOL, STATE_ATOL = 1e-5, 1e-4
# tests/test_distributed.py's config, as tests/test_torch_sharded_train.py
CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab_size=128, dtypes=F32)


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


# each run of the reference: its tag, its config and overrides; the
# 4-token KV blocks make the row blocks' key spans cut (`_key_span`)
RUNS = {a: (a, {}) for a in ARCH_NAMES}
RUNS.update({f"{a}@kv4": (a, {"attn_kv_block": 4})
             for a in ("qwen2-0.5b", "gemma3-27b")})


def _batches():
    return {t: smoke_batch(tsmoke(a).scaled(dtypes=F32), B=ROWS, S=SEQ)
            for t, (a, _) in RUNS.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{arch: {"batch", "init" (a tree), "prefill", "metrics" (a step
    each), "params"/"mu"/"nu"}, "mesh": the (4, 2) runs of ``CFG``}."""
    root = tmp_path_factory.mktemp("ref")
    batches = _batches()
    np.savez(str(root / "in.npz"), **{f"{a}:{k}": v for a, b in
                                      batches.items() for k, v in b.items()})
    out = str(root / "out.npz")
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_smoke_config
        from repro.configs.base import ModelConfig
        from repro.distributed.sharding import use_mesh, _path_str
        from repro.launch.mesh import make_dev_mesh
        from repro.models import build_model
        from repro.train import init_state, make_prefill_step, make_train_step

        def flat(tree, tag):
            return {{tag + _path_str(p): np.asarray(x) for p, x in
                    jax.tree_util.tree_flatten_with_path(tree)[0]}}

        rec = {{}}
        with np.load({str(root / "in.npz")!r}) as z:
            given = {{k: z[k] for k in z.files}}
        for arch, (name, over) in {RUNS!r}.items():
            m = build_model(get_smoke_config(name).scaled(dtypes={F32!r},
                                                          **over))
            state = init_state(m, jax.random.PRNGKey(0))
            batch = {{k.split(":")[1]: jnp.asarray(v)
                     for k, v in given.items() if k.startswith(arch + ":")}}
            rec.update(flat(state.params, arch + ":init:"))
            rec[arch + ":prefill"] = np.asarray(
                jax.jit(make_prefill_step(m))(state.params, batch))
            step = jax.jit(make_train_step(m))
            for i in range({STEPS}):
                state, met = step(state, batch)
                for k, v in met.items():
                    rec[f"{{arch}}:m{{i}}:{{k}}"] = np.asarray(v)
            for name, tree in (("params", state.params),
                               ("mu", state.opt.mu), ("nu", state.opt.nu)):
                rec.update(flat(tree, f"{{arch}}:{{name}}:"))

        m = build_model(ModelConfig(**{CFG!r}).scaled(seq_parallel=True))
        state = init_state(m, jax.random.PRNGKey(0))
        toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 128)
        rec["mesh:toks"] = np.asarray(toks)
        rec.update(flat(state.params, "mesh:init:"))
        s1, m1 = jax.jit(make_train_step(m))(state, {{"tokens": toks}})
        with use_mesh(make_dev_mesh((4, 2), ("data", "model"))):
            s2, m2 = jax.jit(make_train_step(m))(state, {{"tokens": toks}})
        for tag, s, met in (("one", s1, m1), ("sp", s2, m2)):
            rec.update(flat(s.params, f"mesh:{{tag}}:params:"))
            for k, v in met.items():
                rec[f"mesh:{{tag}}:m:{{k}}"] = np.asarray(v)
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

    def part(tag):
        return {k[len(tag):]: v for k, v in rec.items() if k.startswith(tag)}

    res = {}
    for arch in RUNS:
        res[arch] = {"batch": batches[arch],
                     "init": _unflatten(part(arch + ":init:")),
                     "prefill": rec[arch + ":prefill"],
                     "metrics": [{k: float(v) for k, v in
                                  part(f"{arch}:m{i}:").items()}
                                 for i in range(STEPS)]}
        for name in ("params", "mu", "nu"):
            res[arch][name] = part(f"{arch}:{name}:")
    res["mesh"] = {"toks": rec["mesh:toks"],
                   "init": _unflatten(part("mesh:init:"))}
    for tag in ("one", "sp"):
        res["mesh"][tag] = {"params": part(f"mesh:{tag}:params:"),
                            "metrics": {k: float(v) for k, v in
                                        part(f"mesh:{tag}:m:").items()}}
    return res


def _model(tag, init, **over):
    arch, base = RUNS[tag]
    m = build_model(tsmoke(arch).scaled(dtypes=F32, **base, **over),
                    device="cpu")
    return lm_params_from_reference(m, init)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _run(m, batch, shape=None, steps=STEPS, microbatches=1):
    """``steps`` train steps of model ``m`` (on ``shape``'s CPU lanes if
    given): per-step metrics and the final state."""
    if shape is None:
        step = make_train_step(m, microbatches=microbatches)
    else:
        mesh = tmesh.make_dev_mesh(shape, ("data", "model"), device="cpu")
        with sh.use_mesh(mesh):
            step = make_train_step(m, microbatches=microbatches)
    state, metrics = init_state(m), []
    for _ in range(steps):
        state, met = step(state, _torch_batch(batch))
        metrics.append(met)
    return metrics, state


def _close(got, want, tag):
    for k, v in want.items():
        assert abs(float(got[k]) - v) <= METRIC_RTOL * max(1.0, abs(v)), \
            (tag, k, float(got[k]), v)


def _state_close(state, want, names=("params", "mu", "nu")):
    got = _state_np(train_state_to_reference(state))
    for name in names:
        assert set(got[name]) == set(want[name]), name
        d = max(float(np.abs(got[name][k] - a).max())
                for k, a in want[name].items())
        assert d < STATE_ATOL, (name, d)


def _equal(run_a, run_b):
    (ma, sa), (mb, sb) = run_a, run_b
    for x, y in zip(ma, mb):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for a, b in zip(_state_np(train_state_to_reference(sa)).items(),
                    _state_np(train_state_to_reference(sb)).items()):
        if isinstance(a[1], dict):
            for k in a[1]:
                assert np.array_equal(a[1][k].view(np.int32),
                                      b[1][k].view(np.int32)), (a[0], k)
        else:
            assert a == b


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", list(RUNS))
def test_row_split_step_matches_the_reference(reference, arch, shape):
    ref = reference[arch]
    m = _model(arch, ref["init"], seq_parallel=True)
    metrics, state = _run(m, ref["batch"], shape)
    for got, want in zip(metrics, ref["metrics"]):
        _close(got, want, arch)
    _state_close(state, ref)


def test_row_split_mesh_step_matches_the_reference_mesh(reference):
    """The port's ``(4, 2)`` step with the setting against the reference's
    ``(4, 2)`` step with it (and its single-device step)."""
    ref = reference["mesh"]
    m = lm_params_from_reference(build_model(
        ModelConfig(**CFG).scaled(seq_parallel=True), device="cpu"),
        ref["init"])
    metrics, state = _run(m, {"tokens": ref["toks"]}, (4, 2), steps=1)
    for tag in ("sp", "one"):
        _close(metrics[0], ref[tag]["metrics"], tag)
        _state_close(state, ref[tag], names=("params",))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-medium"])
def test_one_model_lane_equals_microbatches_bit_for_bit(reference, arch):
    ref = reference[arch]
    _equal(_run(_model(arch, ref["init"], seq_parallel=True), ref["batch"],
                (2, 1)),
           _run(_model(arch, ref["init"]), ref["batch"], microbatches=2))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-27b"])
def test_undivided_sequence_runs_as_unset(reference, arch):
    ref = reference[arch]
    cfg = tsmoke(arch).scaled(dtypes=F32)
    batch = smoke_batch(cfg, B=ROWS, S=18)
    _equal(_run(_model(arch, ref["init"], seq_parallel=True), batch, (1, 4)),
           _run(_model(arch, ref["init"]), batch, (1, 4)))


@pytest.mark.parametrize("arch", list(RUNS))
def test_row_split_prefill_gives_the_reference_tokens(reference, arch):
    ref = reference[arch]
    m = _model(arch, ref["init"], seq_parallel=True)
    mesh = tmesh.make_dev_mesh((2, 2), ("data", "model"), device="cpu")
    got = make_prefill_step(m, mesh)(_torch_batch(ref["batch"]))
    np.testing.assert_array_equal(got.numpy(), ref["prefill"])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-27b",
                                  "jamba-v0.1-52b"])
def test_decode_with_the_setting_matches_decode_without(reference, arch):
    ref = reference[arch]
    mesh = tmesh.make_dev_mesh((2, 2), ("data", "model"), device="cpu")
    runs = []
    for sp in (False, True):
        m = _model(arch, ref["init"], seq_parallel=sp)
        cache = m.init_cache(ROWS, 8, dtype=torch.float32)
        step = make_serve_step(m, mesh)
        tok = torch.from_numpy(ref["batch"]["tokens"][:, :1]).long()
        logits = []
        for _ in range(4):
            cache, tok, lg = step(cache, tok, logits=True)
            logits.append(lg)
        runs.append(torch.stack(logits))
    scale = float(runs[0].abs().max())
    assert float((runs[1] - runs[0]).abs().max()) <= 1e-4 * scale


def _saved(arch, shape, sp):
    m = build_model(tsmoke(arch).scaled(dtypes=F32, seq_parallel=sp),
                    device="cpu")
    mesh = tmesh.make_dev_mesh(shape, ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        specs = sh.param_pspecs(m.params())
    params = sh.tree_map(lambda x, s: sh.shard(x.detach(), mesh, s),
                         m.params(), specs)
    cfg = m.cfg
    rows = ROWS // shape[0]
    batch = _torch_batch(smoke_batch(cfg, B=rows, S=SEQ))
    return m, dryrun.train_saved(m, mesh, params, batch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llava-next-34b",
                                  "mamba2-130m"])
def test_no_lane_keeps_more_than_its_rows(arch):
    """A lane keeps one row block of each checkpointed period's input (and
    of the final hidden state, which the float32 norm saves); without the
    setting home keeps the whole of each."""
    M = 2
    m, got = _saved(arch, (2, M), True)
    _, unset = _saved(arch, (2, M), False)
    cfg = m.cfg
    S = SEQ + cfg.num_patches
    periods = sum(st.n_periods for st in m.stack_specs)
    rows = (ROWS // 2) * (S // M) * cfg.d_model * 4
    assert got["inputs"] == [(periods + 1) * rows] * M, got
    assert unset["inputs"] == [(periods + 1) * rows * M, 0], unset


def test_row_blocks_gather_whole_periods():
    """Under the setting every lane gathers the whole of a period's leaves
    (the MLP too: weights gathered instead of activations), and of the
    embedding (the tied head); without it a lane gathers its columns of
    the MLP and its slice of the vocabulary: the plan's counts a lane."""
    cfg = tsmoke("qwen2-0.5b").scaled(dtypes=F32)
    got = {}
    for sp in (False, True):
        m = build_model(cfg.scaled(seq_parallel=sp), device="cpu")
        mesh = tmesh.make_dev_mesh((1, 2), ("data", "model"), device="cpu")
        with sh.use_mesh(mesh):
            specs = sh.param_pspecs(m.params())
        params = sh.tree_map(lambda x, s: sh.shard(x.detach(), mesh, s),
                             m.params(), specs)
        plan = partition.GroupPlan(m, mesh, [0, 1], partition.Resting(params))
        with GatherTally() as tally, torch.no_grad():
            lay = plan.layout(m)
            xf, _ = m._hidden(_torch_batch(smoke_batch(m.cfg, B=2, S=SEQ)),
                              lay)
            lay.greedy(lay.last(xf))
        assert plan.gathered == [tally.total[0], tally.total[1]]
        got[sp] = plan
    whole = sum(4 * p.numel() for p in m.stacks["s0"][0].parameters())
    table = 4 * m.embed.numel()
    assert got[True].period_bytes == [whole, whole]
    norm = 4 * cfg.d_model
    # home looks the tokens up, the last lane takes the last position's
    # logits
    assert got[True].top_bytes == [table + norm, table + norm]
    assert max(got[False].period_bytes) < whole
    assert got[False].top_bytes == [table // 2 + norm, table // 2]
