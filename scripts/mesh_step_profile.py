#!/usr/bin/env python3
"""Where the time of the partitioned sharded train step goes, on one card.

    python3 scripts/mesh_step_profile.py [--mesh 2x2] [--steps 4]

qwen2-0.5b at full width, B 8, S 128 (``chip_smoke.py``'s
``lm_train_mesh`` cell), on lanes forced onto the card
(``REPRO_TORCH_FORCE_LANES``), random tokens from seed 0.  It runs
``--steps`` steps of the step `make_train_step` builds under the mesh
(the first warms up; their wall times are printed), then one more under
``torch.profiler`` (CPU and CUDA activity), with the step's parts marked
by ``record_function`` for this run only (the program has no marks of
its own):

* ``gather``: `partition._Gather`'s forward, a leaf's region put together
  and cast for a lane (forward and recompute);
* ``gather_backward``: its backward, the region's gradient copied out to
  the shards;
* ``lanes.run``: `GroupPlan.run`, the lanes' shares of a product queued on
  their streams (their own gathers excluded, since a period's gathers run
  before its products);
* ``pool``: `_Mean.add`, a group's gradient added to the pooled one;
* ``clip_norm``: `adamw._sum_of_squares`, the global norm;
* ``adamw``: `adamw.update`, one lane's update of its shards.

It prints one JSON line: the unprofiled steps' wall ms, the profiled
step's wall ms, its device time (the sum of the kernels' own times) and
kernel count, each mark's count and its host ms (inclusive CPU time),
the step's operator count, and the 15 host events with the most host
time of their own.  Then the card's name and power limit.  The profiler
adds host time of its own, so the marks' shares of the profiled step are
what is read, beside the unprofiled wall time.  Exits non-zero without a
card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKS = ("gather", "gather_backward", "lanes.run", "pool", "clip_norm",
         "adamw")


def _mark(obj, attr, name, static=False):
    """Wrap ``obj.attr`` in ``record_function(name)``."""
    import functools

    import torch

    fn = getattr(obj, attr)

    @functools.wraps(fn)
    def marked(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    setattr(obj, attr, staticmethod(marked) if static else marked)


def _self_device_us(evt) -> float:
    for key in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, key):
            return float(getattr(evt, key))
    return 0.0


def main(argv):
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("mesh_step_profile: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    os.environ["REPRO_TORCH_FORCE_LANES"] = str(d * m)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train import train_step as ts

    cfg = get_config("qwen2-0.5b")
    mesh = make_dev_mesh((d, m), ("data", "model"), device="cuda")
    model = build_model(cfg, device=mesh.lanes[0].device)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 128),
                                     generator=gen)}
    with use_mesh(mesh):
        step = make_train_step(model)
    state = init_state(model)
    wall = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    _mark(partition._Gather, "forward", "gather", static=True)
    _mark(partition._Gather, "backward", "gather_backward", static=True)
    _mark(partition.GroupPlan, "run", "lanes.run")
    _mark(ts._Mean, "add", "pool")
    _mark(adamw, "_sum_of_squares", "clip_norm")
    _mark(adamw, "update", "adamw")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        profiled = (time.perf_counter() - t0) * 1e3
    # a mark is listed twice, as a host range and as the device's range
    # of its kernels; only the host's is read
    events = prof.key_averages()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key not in MARKS]
    marks = {e.key: {"count": e.count, "host_ms": e.cpu_time_total / 1e3}
             for e in host if e.key in MARKS}
    ops = [e for e in host if e.key.startswith("aten::")]
    top = sorted(host, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:15]
    row = {
        "mesh": args.mesh, "arch": "qwen2-0.5b", "batch": 8, "seq": 128,
        "step_ms": wall, "profiled_step_ms": profiled,
        "device_ms": sum(_self_device_us(e) for e in kernels) / 1e3,
        "kernel_launches": sum(e.count for e in kernels),
        "marks": marks,
        "aten_ops": sum(e.count for e in ops),
        "top_self_host": [{"op": e.key, "count": e.count,
                           "self_host_ms": e.self_cpu_time_total / 1e3}
                          for e in top],
    }
    print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
