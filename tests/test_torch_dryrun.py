"""The port's dry-run inputs and harness (``repro_torch.launch.inputs``,
``repro_torch.launch.dryrun``) against ``repro.launch.inputs`` and
``tests/test_dryrun_unit.py``'s bars.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported, so it is never
imported here.  The reference's ``cell_specs`` needs a real 256- or
512-device mesh: it runs once, in a child interpreter with 512 forced
XLA devices, for qwen2-0.5b ``train_4k`` and ``decode_32k`` and
whisper-medium ``decode_32k`` on both production meshes; it reports every
leaf's spec and the bytes a device holds of the cell's arguments (the
sum over leaves of ``NamedSharding.shard_shape``).  Specs are compared
exactly (the port's per-period leaf against the reference's stacked leaf
with its leading entry dropped), and so are the bytes.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import get_smoke_config as jsmoke
from repro.launch import inputs as jinputs
from repro_torch.configs import ARCH_NAMES, SHAPES, ShapeSpec, cells
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch import dryrun, inputs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
         ("whisper-medium", "decode_32k")]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "specs.json")
    prog = textwrap.dedent(f"""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
        import jax, numpy as np
        from jax.sharding import Mesh, NamedSharding
        from repro.configs import SHAPES, get_config
        from repro.distributed.sharding import _path_str
        from repro.launch.inputs import cell_specs
        out = {{}}
        for shape, axes in (((16, 16), ("data", "model")),
                            ((2, 16, 16), ("pod", "data", "model"))):
            n = int(np.prod(shape))
            mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)
            for arch, sname in {CELLS!r}:
                model, kind, structs, shardings = cell_specs(
                    get_config(arch), SHAPES[sname], mesh)
                specs, nbytes = {{}}, 0
                for i, (st, sh) in enumerate(zip(structs, shardings)):
                    ls = jax.tree_util.tree_flatten_with_path(st)[0]
                    ss = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(
                        x, NamedSharding))
                    for (p, l), s in zip(ls, ss):
                        specs[f"{{i}}:" + _path_str(p)] = [
                            list(e) if isinstance(e, tuple) else e
                            for e in s.spec]
                        nbytes += int(np.prod(s.shard_shape(l.shape))) \\
                            * l.dtype.itemsize
                out[f"{{len(shape)}}:{{arch}}:{{sname}}"] = {{
                    "kind": kind, "specs": specs, "bytes": nbytes}}
        json.dump(out, open({out!r}, "w"))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.load(open(out))


def _port_specs(tree, i, out, path=(), periods=None):
    """``{"i:" + reference path: spec}`` of a port tree of shardings."""
    if isinstance(tree, NamedSharding):
        spec = [list(e) if isinstance(e, tuple) else e for e in tree.spec]
        out.setdefault(f"{i}:" + "/".join(path), []).append(
            (periods is not None, spec))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _port_specs(v, i, out, path + (str(k),), periods)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            _port_specs(v, i, out, path + (f".{f}",), periods)
    elif isinstance(tree, list) and periods is None:
        for v in tree:
            _port_specs(v, i, out, path, len(tree))
    else:
        for j, v in enumerate(tree):
            _port_specs(v, i, out, path + (str(j),), periods)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_batch_struct_shapes(arch):
    cfg, s = get_config(arch), SHAPES["train_4k"]
    b = inputs.train_batch_struct(cfg, s)
    total = b["tokens"].shape[1] + (cfg.num_patches or 0)
    assert total == s.seq_len
    assert b["tokens"].shape[0] == s.global_batch
    if cfg.is_encoder_decoder:
        assert b["enc_frames"].shape == (s.global_batch, cfg.encoder_seq,
                                         cfg.d_model)
    ref = jinputs.train_batch_struct(jget(arch), JSHAPES["train_4k"])
    assert set(b) == set(ref)
    for k, v in b.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(ref[k].shape)
        assert str(v.dtype).removeprefix("torch.") == str(ref[k].dtype)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llava-next-34b",
                                  "whisper-medium"])
def test_make_train_batch_matches_reference(arch):
    """Tokens bit for bit; bfloat16 embeddings bit for bit too (both
    round float64 through float32)."""
    shape = ShapeSpec("small", 64, 4, "train")
    got = inputs.make_train_batch(get_smoke_config(arch), shape, seed=3)
    want = jinputs.make_train_batch(jsmoke(arch), shape, seed=3)
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        if v.dtype == torch.bfloat16:
            assert np.array_equal(v.view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:
            assert v.dtype == torch.int32
            assert np.array_equal(v.numpy(), w), k


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_and_bytes_match_reference(reference, arch, shape):
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        ref = reference[f"{len(mesh.axis_names)}:{arch}:{shape}"]
        model, kind, structs, shardings = inputs.cell_specs(
            get_config(arch), SHAPES[shape], mesh)
        assert kind == ref["kind"]
        got = {}
        for i, sh in enumerate(shardings):
            _port_specs(sh, i, got)
        assert set(got) == set(ref["specs"])
        for key, items in got.items():
            want = ref["specs"][key]
            for stacked, spec in items:
                if stacked:
                    assert want[0] is None and spec == want[1:], key
                else:
                    assert spec == want, key
        plan = dryrun.plan_cell(get_config(arch), SHAPES[shape], mesh,
                                prove=False)
        assert plan["memory"]["argument_bytes"] == ref["bytes"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_probe_cfg_consistent(arch):
    cfg = get_config(arch)
    for n in (2, 4):
        pc = dryrun._probe_cfg(cfg, n)
        pc.validate()
        assert pc.unroll_stacks
        assert pc.periods == n
        assert len(pc.layer_list()) == len(cfg.period) * n


def test_cells_enumeration():
    runnable = cells()
    everything = cells(include_skipped=True)
    assert len(everything) == len(ARCH_NAMES) * len(SHAPES) == 40
    skipped = [c for c in everything if c[2]]
    assert len(skipped) == 7
    for arch, shape, _ in skipped:
        assert shape == "long_500k"
        assert not get_config(arch).sub_quadratic
    assert len(runnable) == 33
    assert ARCH_NAMES == JARCHS


def test_one_cell_end_to_end_on_meta(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
    train_4k``: the shape proof on both meshes, the FLOP counts at 2, 4
    and 24 periods on the reference's line ``A + n*B`` exactly, the
    ratio to the model FLOPs, the nulls with their reasons."""
    out = str(tmp_path / "dry.json")
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                        "--out", out]) == 0
    assert "[qwen2-0.5b x train_4k] OK" in capsys.readouterr().out
    rec, = json.load(open(out))
    assert rec["ok"], rec.get("error")
    sp, mp = rec["single_pod"], rec["multi_pod"]
    assert (sp["groups"], mp["groups"]) == (16, 32)
    line = rec["flop_line"]
    assert line["n"] == 24 and line["counted"] == line["predicted"]
    assert rec["probes"]["2"]["flops"] < rec["probes"]["4"]["flops"] \
        < sp["flops"] == sp["flops_per_group"] * 16
    assert 1.0 < sp["flops_over_model_flops"] < 1.5
    for key in ("temp_gb", "output_gb", "alias_gb", "code_mb"):
        assert sp["memory"][key] is None and rec["null_reasons"][key]
    assert sp["cost_once"]["bytes"] is None
    c = sp["collectives"]
    assert set(dryrun.COLLECTIVES) | {"n_ops", "total"} == set(c)
    assert c["total"] == sum(c[k] for k in dryrun.COLLECTIVES) > 0
    assert sp["memory"]["plan"] == "partitioned"
    assert sp["memory"]["fits_card"]


def test_import_sets_no_environment_variable():
    code = textwrap.dedent("""
        import os
        before = dict(os.environ)
        import repro_torch.launch.dryrun
        assert dict(os.environ) == before
        print("ENV-OK")
    """)
    env = {"PYTHONPATH": os.path.join(REPO, "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and "ENV-OK" in r.stdout, r.stderr[-2000:]


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-0.5b", ShapeSpec("decode_4k", 4_096, 128, "decode")),
    ("jamba-v0.1-52b", ShapeSpec("long_32k", 32_768, 1, "decode")),
    ("qwen2-0.5b", ShapeSpec("prefill_1k", 1_024, 32, "train"))],
    ids=["decode", "decode_b1", "prefill"])
def test_serve_cells_are_partitioned(arch, shape):
    """A decode cell (and one of a single row) and a prefill cell on the
    (16, 16) production mesh (shorter sequences than the production
    cells, the same layout): the shape proof runs the partitioned steps,
    the plan is ``partitioned``, a lane's bytes count its gathered
    shares (and prefill's working set), and its cache bytes equal those
    of the cache `sharding.shard_cache` places on the lanes."""
    from repro_torch.distributed.sharding import shard_cache

    cfg = get_config(arch)
    mesh = make_production_mesh(device="meta")
    rec = dryrun.plan_cell(cfg, shape, mesh, count_flops=True)
    mem = rec["memory"]
    assert rec["kind"] == ("decode" if shape.kind == "decode" else "prefill")
    assert mem["plan"] == "partitioned" and mem["fits_card"]
    assert mem["lane_bytes"] > mem["argument_bytes"] + mem["gathered_gb"] \
        * 2**30 * 0.99 > mem["argument_bytes"]
    assert (mem["working_set_gb"] > 0) == (shape.kind != "decode")
    assert rec["flops"] > 0 and rec["collectives"]["all-gather"] > 0
    if shape.kind != "decode":
        return
    cache = build_model(cfg, device="meta").init_cache(shape.global_batch,
                                                       shape.seq_len)
    leaves = []
    _tensors(cache, leaves)
    whole = sum(x.numel() * x.element_size() for x in leaves)
    shard_cache(cache, mesh, inputs.cache_shardings(
        cache, cfg, shape.global_batch, mesh))
    leaves = []
    _tensors(cache, leaves)
    lanes = {sum(x.lane_bytes(i) for x in leaves) for i in range(mesh.size)}
    assert lanes == {mem["cache_bytes"]}
    assert whole // mesh.size <= mem["cache_bytes"] < whole


def _tensors(t, out):
    if isinstance(t, dict):
        for v in t.values():
            _tensors(v, out)
    elif isinstance(t, list):
        for v in t:
            _tensors(v, out)
    elif not isinstance(t, int):
        out.append(t)


def test_row_split_train_cell_counts_a_lanes_rows():
    """``--set seq_parallel=true`` on a train cell (qwen2-0.5b on the
    (16, 16) production mesh, 1,024 tokens, 2 rows a data group): the
    plan names the row split; each lane keeps its rows of every period's
    input (bfloat16), where without the setting home keeps them whole and
    the other lanes none; the lane's saved activations fall by the other
    rows, and its gathered weights rise (every period's MLP and the head
    whole on every lane)."""
    shape = ShapeSpec("train_1k", 1_024, 32, "train")
    mesh = make_production_mesh(device="meta")
    cfg = get_config("qwen2-0.5b")
    rec = {sp: dryrun.plan_cell(cfg.scaled(seq_parallel=sp), shape, mesh)
           for sp in (False, True)}
    mem, unset = rec[True]["memory"], rec[False]["memory"]
    assert mem["plan"] == "partitioned, token rows over model (seq_parallel)"
    assert unset["plan"] == "partitioned"
    M = mesh.shape["model"]
    rows = 2 * (shape.seq_len // M) * cfg.d_model * 2
    assert mem["input_bytes"] == [cfg.periods * rows] * M
    assert unset["input_bytes"] == [cfg.periods * rows * M] + [0] * (M - 1)
    drop = unset["saved_bytes"][0] - mem["saved_bytes"][0]
    assert drop >= cfg.periods * rows * (M - 1) * 0.99
    assert mem["activation_gb"] < unset["activation_gb"]
    assert mem["gathered_gb"] > unset["gathered_gb"]
