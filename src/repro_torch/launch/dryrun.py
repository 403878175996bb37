"""Dry-run of every (arch x shape) cell on the production meshes, without a
card (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step with XLA on 512 forced
host devices, reads ``memory_analysis()`` and ``cost_analysis()`` on
python-unrolled probes at ``n_periods`` 2 and 4, and parses collective
bytes out of the post-SPMD HLO.  Eager PyTorch has no compiler, no
partitioner and no HLO, so none of that exists here.  What this module
does instead, for each cell on ``make_production_mesh(device="meta")``,
single-pod ``(16, 16)`` and multi-pod ``(2, 16, 16)``:

1. **Shape proof, in place of the compile proof.**  Nothing is compiled.
   The cell's step (train, prefill or decode, as the reference's
   ``_lower_cell`` picks) runs once end to end on ``meta`` tensors, with
   the stand-ins and specs of `launch.inputs`, as the port's sharded
   plan runs it (`train.train_step`): the batch splits over the batch
   axes, one data group's lane computes its rows on a whole replica, and
   (train) one lane's AdamW update runs on its shards.  Every data group
   has the same shapes, so one group's run proves them all.  A shape or
   spec mismatch raises and fails the cell, as a sharding mismatch fails
   the reference's compile.
2. **Memory**: the bytes each lane holds of the step's arguments
   (parameters, optimizer state, batch, cache: each leaf's shard under
   its spec; the guard keeps shards equal, so every lane holds the
   same), the counterpart of ``argument_size_in_bytes``, exact
   arithmetic.  Also the full replica that the plan gathers onto a
   compute lane (the parameters, and for train the pooled float32
   gradient), and both checked against the H100's 80 GB.  XLA's
   ``temp`` (activations), ``output``, ``alias`` and ``code`` have no
   counterpart: ``null``, with the reason in the record.
3. **Cost**: FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode``
   over the whole depth (there is no scan hiding a loop body), for the
   whole step (one group's count times the groups) and for one compute
   lane; and at the reference's probe depths (`_probe_cfg`, 2 and 4
   periods), to check that the three counts lie on the reference's line
   ``F(n) = A + n*B`` (``n = n_periods + n_remainder / period_len``, as
   ``benchmarks/roofline.py`` reads it).  The counter counts matrix
   products only, and it counts remat's recomputed forward; the ratio to
   `launch.analysis`'s model FLOPs is reported.  Bytes accessed have no
   counterpart: ``null``.
4. **Lane-to-lane bytes** of the port's plan, under the reference's
   collective keys; they describe the port's plan, not XLA's:
   ``all-gather`` the bytes the compute lanes fetch to put the whole
   parameters (and for decode their rows' cache) together from the
   shards; ``all-reduce`` the float32 gradients, loss and metrics the
   other groups' lanes send to lane 0 to be pooled; ``reduce-scatter``
   the pooled gradient's shards lane 0 sends to every other lane;
   ``all-to-all`` and ``collective-permute`` 0; ``n_ops`` the tensor
   copies; ``total`` their bytes; all summed over the mesh for one step.
   The HLO parser ``collective_bytes`` has no input here and is not
   ported.

The module sets no environment variable: meta lanes need none.  Results
append to a JSON file (default: ``repro_torch_dryrun.json`` in the temp
directory; ``benchmarks/`` is the reference's).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--jobs N] [--out FILE]
"""
from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from ..configs import SHAPES, cells, get_config
from ..optim import adamw
from ..optim.adamw import OptState
from ..distributed.sharding import NamedSharding, shard_shape
from . import analysis
from .inputs import cell_specs
from .mesh import make_production_mesh

CARD = "NVIDIA H100 80GB HBM3"
CARD_BYTES = 80e9
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
NULL_REASONS = {
    "temp_gb": "activations: eager PyTorch plans no buffers ahead of a run",
    "output_gb": "the port's train step updates its state in place",
    "alias_gb": "no buffer donation in eager PyTorch",
    "code_mb": "nothing is compiled",
    "bytes": "no cost model of memory traffic without XLA",
}
F32_BYTES = 4
INT_BYTES = 4           # an int leaf (a cache's pos) is the reference's 0-d int32


def _probe_cfg(cfg, n: int):
    """Same arch, n periods per stack, python-unrolled (cost probe)."""
    over = dict(unroll_stacks=True, remainder=(), n_periods=n,
                n_layers=len(cfg.period) * n)
    if cfg.is_encoder_decoder:
        over["n_encoder_layers"] = len(cfg.encoder_period) * n
    return cfg.scaled(**over)


# ------------------------------------------------------------- leaves ---
def _leaf_rows(tree, shardings):
    """``(shape, itemsize, spec)`` of every leaf of ``tree`` beside its
    sharding (an ``int`` leaf: shape (), the reference's int32)."""
    items, specs = [], []
    _walk_leaves(tree, items)
    _walk_leaves(shardings, specs,
                 is_leaf=lambda x: isinstance(x, NamedSharding))
    if len(items) != len(specs):
        raise ValueError(f"{len(items)} leaves for {len(specs)} shardings")
    rows = []
    for x, sh in zip(items, specs):
        if isinstance(x, torch.Tensor):
            rows.append((tuple(x.shape), x.element_size(), sh.spec))
        else:
            rows.append(((), INT_BYTES, sh.spec))
    return rows


def _walk_leaves(tree, out, is_leaf=lambda x: False):
    if is_leaf(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _walk_leaves(v, out, is_leaf)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _walk_leaves(v, out, is_leaf)
    else:
        out.append(tree)


def _lane_bytes(rows, mesh) -> int:
    """Bytes one lane holds of leaves ``rows`` (every lane holds the
    same: the guard keeps each shard an exact split)."""
    return sum(math.prod(shard_shape(shape, mesh, spec)) * size
               for shape, size, spec in rows)


def _full_bytes(rows) -> int:
    return sum(math.prod(shape) * size for shape, size, _ in rows)


def _groups(spec0, mesh) -> int:
    """How many ways the batch dim splits (its spec's axes' product)."""
    if spec0 is None:
        return 1
    axes = spec0 if isinstance(spec0, tuple) else (spec0,)
    return math.prod(mesh.shape[a] for a in axes)


# --------------------------------------------------------------- plan ---
def _rows_of(x, rows):
    return torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device="meta")


def _group_args(model, kind, structs, groups, seq_len):
    """One data group's arguments (meta): its rows of the batch, and for
    decode its rows' cache (an argument of the step, as in the reference:
    whisper's encoder runs here, not in the step)."""
    first = structs[2] if kind == "decode" else next(iter(
        structs[1].values()))
    B = first.shape[0]
    if B % groups:
        raise ValueError(f"{B} rows do not split over {groups} groups")
    rows = B // groups
    if kind != "decode":
        return rows, {k: _rows_of(v, rows) for k, v in structs[1].items()}
    cfg = model.cfg
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            cache = model.init_cache({"enc_frames": torch.empty(
                (rows, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                device="meta")}, seq_len)
        else:
            cache = model.init_cache(rows, seq_len)
    return rows, (cache, _rows_of(structs[2], rows))


def _run_group(model, kind, rows, args, microbatches=1):
    """One data group's step on meta (the shape proof): decode, prefill,
    or the loss and gradients of train."""
    from ..train.train_step import (
        _loss_and_grads, make_prefill_step, make_serve_step,
    )

    if kind == "decode":
        _, nxt = make_serve_step(model)(*args)
        if tuple(nxt.shape) != (rows, 1):
            raise ValueError(f"decode gave {tuple(nxt.shape)}")
    elif kind == "prefill":
        out = make_prefill_step(model)(args)
        if tuple(out.shape) != (rows,):
            raise ValueError(f"prefill gave {tuple(out.shape)}")
    else:
        leaves = list(adamw._leaves(model.params()))
        loss, _, grads = _loss_and_grads(model, leaves, args, microbatches)
        if loss.shape != () or any(g.shape != p.shape
                                   for g, p in zip(grads, leaves)):
            raise ValueError("train: a gradient's shape is not its "
                             "parameter's")


def _update_on_shards(params, specs, mesh):
    """AdamW's update on one lane's shards (meta): shapes only."""
    shards, sleaves = [], []
    _walk_leaves(specs, sleaves, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    for p, sh in zip(adamw._leaves(params), sleaves):
        shards.append(torch.empty(shard_shape(p.shape, mesh, sh.spec),
                                  dtype=p.dtype, device="meta"))
    zeros = [torch.empty(s.shape, dtype=torch.float32, device="meta")
             for s in shards]
    adamw.update(list(zeros), OptState(mu=list(zeros), nu=list(zeros),
                                       count=torch.zeros((), dtype=torch.int32)),
                 shards, adamw.AdamWConfig(),
                 gnorm=torch.empty((), device="meta"))


def _flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _collectives(kind, mesh, p_rows, c_rows, groups) -> dict:
    """Lane-to-lane bytes of the port's plan for one step (see the module
    note), summed over the mesh."""
    out = {k: 0 for k in COLLECTIVES}
    own = _lane_bytes(p_rows, mesh)
    out["all-gather"] = groups * (_full_bytes(p_rows) - own)
    n_ops = groups * len(p_rows)
    if kind == "decode":
        full_cache = _full_bytes(c_rows) // groups      # a group's rows
        out["all-gather"] += groups * max(
            full_cache - _lane_bytes(c_rows, mesh), 0)
        n_ops += groups * len(c_rows)
    if kind == "train":
        grads = sum(math.prod(s) * F32_BYTES for s, _, _ in p_rows)
        out["all-reduce"] = (groups - 1) * (grads + 4 * F32_BYTES)
        n_ops += (groups - 1) * (len(p_rows) + 4)
        shard32 = sum(math.prod(shard_shape(s, mesh, sp)) * F32_BYTES
                      for s, _, sp in p_rows)
        out["reduce-scatter"] = (mesh.size - 1) * shard32
        n_ops += (mesh.size - 1) * len(p_rows)
    out["n_ops"] = n_ops
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def plan_cell(cfg, shape, mesh, *, microbatches=1, count_flops=False,
              prove=True):
    """One cell on one mesh: its shape proof (raises on a mismatch; left
    out with ``prove=False``), its per-lane memory, its lane-to-lane
    bytes and (``count_flops``) the FLOPs of the step.  Returns a
    dict."""
    model, kind, structs, shardings = cell_specs(cfg, shape, mesh)
    if kind == "decode":
        p_rows = _leaf_rows(structs[0], shardings[0])
        c_rows = _leaf_rows(structs[1], shardings[1])
        b_rows = _leaf_rows({"t": structs[2]}, {"t": shardings[2]})
        groups = _groups(shardings[2].spec[0], mesh)
        opt_rows = []
    else:
        b_rows = _leaf_rows(structs[1], shardings[1])
        first = next(iter(shardings[1].values()))
        groups = _groups(first.spec[0], mesh)
        c_rows = []
        if kind == "train":
            state, s_shard = structs[0], shardings[0]
            p_rows = _leaf_rows(state.params, s_shard.params)
            opt_rows = _leaf_rows((state.opt, state.step),
                                  (s_shard.opt, s_shard.step))
        else:
            p_rows = _leaf_rows(structs[0], shardings[0])
            opt_rows = []
    t0 = time.perf_counter()
    group_flops = None
    if prove or count_flops:
        rows, args = _group_args(model, kind, structs, groups, shape.seq_len)
        run = lambda: _run_group(model, kind, rows, args,  # noqa: E731
                                 microbatches)
        group_flops = _flops(run) if count_flops else run()
        if kind == "train":
            _update_on_shards(structs[0].params, shardings[0].params, mesh)
    proof_s = time.perf_counter() - t0 if prove or count_flops else None
    lane = {name: _lane_bytes(rows, mesh) for name, rows in (
        ("params", p_rows), ("opt", opt_rows), ("batch", b_rows),
        ("cache", c_rows))}
    arg = sum(lane.values())
    replica = _full_bytes(p_rows)
    if kind == "train":
        replica += sum(math.prod(s) * F32_BYTES for s, _, _ in p_rows)
    mu_nu = _lane_bytes([r for r in opt_rows if r[0]], mesh)
    gb = 1 / 2**30
    memory = {
        "argument_gb": arg * gb, "argument_bytes": arg,
        "params_gb": lane["params"] * gb, "opt_gb": lane["opt"] * gb,
        "batch_gb": lane["batch"] * gb, "cache_gb": lane["cache"] * gb,
        "state_bytes": lane["params"] + mu_nu,
        "replica_gb": replica * gb,
        "compute_lane_gb": (arg + replica) * gb,
        "fits_card_at_rest": arg <= CARD_BYTES,
        "fits_card_with_replica": arg + replica <= CARD_BYTES,
        "card": CARD,
        "output_gb": None, "temp_gb": None, "alias_gb": None,
        "code_mb": None,
    }
    out = {"kind": kind, "groups": groups, "shape_proof_s": proof_s,
           "memory": memory,
           "collectives": _collectives(kind, mesh, p_rows, c_rows, groups)}
    if count_flops:
        out["flops_per_compute_lane"] = group_flops
        out["flops"] = group_flops * groups
    return out


def run_cell(arch: str, shape_name: str, *, probes: bool = True,
             overrides: dict | None = None) -> dict:
    overrides = dict(overrides or {})
    microbatches = overrides.pop("microbatches", 1)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind, "ok": False,
           "null_reasons": NULL_REASONS}
    if overrides or microbatches > 1:
        rec["overrides"] = {**overrides, "microbatches": microbatches}
    try:
        # --- multi-pod shape proof (512 lanes) ---
        rec["multi_pod"] = plan_cell(
            cfg, shape, make_production_mesh(multi_pod=True, device="meta"),
            microbatches=microbatches)
        # --- single-pod shape proof, memory and FLOPs (256 lanes) ---
        mesh_sp = make_production_mesh(multi_pod=False, device="meta")
        sp = plan_cell(cfg, shape, mesh_sp, microbatches=microbatches,
                       count_flops=True)
        sp["cost_once"] = {"flops": sp["flops"], "bytes": None}
        model_flops = analysis.model_flops_for(cfg, shape)
        sp["model_flops"] = model_flops
        sp["flops_over_model_flops"] = sp["flops"] / model_flops
        rec["single_pod"] = sp
        if probes:
            probe = {}
            for n in (2, 4):
                p = plan_cell(_probe_cfg(cfg, n), shape, mesh_sp,
                              microbatches=microbatches, count_flops=True)
                probe[str(n)] = {"flops": p["flops"], "bytes": None,
                                 "collectives": p["collectives"]}
            rec["probes"] = probe
            rec["n_periods"] = cfg.periods
            rec["n_remainder"] = len(cfg.remainder)
            rec["period_len"] = len(cfg.period)
            rec["flop_line"] = flop_line(rec)
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def flop_line(rec: dict) -> dict:
    """The reference's line ``F(n) = A + n*B`` through the probes, at the
    cell's depth, beside the full-depth count."""
    f2 = rec["probes"]["2"]["flops"]
    f4 = rec["probes"]["4"]["flops"]
    B = (f4 - f2) / 2.0
    A = f2 - 2.0 * B
    n = rec["n_periods"] + rec["n_remainder"] / max(rec["period_len"], 1)
    full = rec["single_pod"]["flops"]
    pred = A + n * B
    return {"A": A, "B": B, "n": n, "predicted": pred, "counted": full,
            "relative_residual": (full - pred) / full if full else 0.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb variants), "
                         "e.g. --set attn_kv_block=512 --set microbatches=2")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_dryrun.json"))
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                overrides[k] = float(v)

    if args.all and args.jobs > 1:
        # Fan out cells across subprocesses; merge results into --out.
        todo = cells()
        procs = []
        for arch, shape in todo:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", args.out,
                   *(f"--set={kv}" for kv in args.set)]
            if args.no_probes:
                cmd.append("--no-probes")
            procs.append((arch, shape, subprocess.Popen(cmd)))
            while len([p for *_, p in procs if p.poll() is None]) >= args.jobs:
                time.sleep(0.5)
        for arch, shape, p in procs:
            p.wait()
            print(f"[{arch} x {shape}] rc={p.returncode}")
        return 0

    todo = cells() if args.all else [(args.arch, args.shape)]
    recs = []
    for arch, shape in todo:
        t0 = time.time()
        rec = run_cell(arch, shape, probes=not args.no_probes,
                       overrides=overrides or None)
        rec["wall_s"] = round(time.time() - t0, 1)
        _append(args.out, rec)
        recs.append(rec)
        status = "OK" if rec["ok"] else f"FAIL: {rec.get('error')}"
        print(f"[{arch} x {shape}] {status} ({rec['wall_s']}s)", flush=True)
        if rec["ok"]:
            sp = rec["single_pod"]["memory"]
            print(f"    mem/lane: args {sp['argument_gb']:.2f} GB, "
                  f"with the replica {sp['compute_lane_gb']:.2f} GB "
                  f"(of {CARD}'s 80 GB)", flush=True)
    return 0 if all(r["ok"] for r in recs) else 1


def _append(path: str, rec: dict):
    import fcntl
    import json

    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        try:
            data = json.load(f)
        except (json.JSONDecodeError, ValueError):
            data = []
        data = [r for r in data
                if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"])]
        data.append(rec)
        f.seek(0)
        f.truncate()
        json.dump(data, f, indent=1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
