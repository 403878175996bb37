#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's seven CUDA kernels from the sources in this checkout
(K1 ``bcd_fused``, K2 ``csr_stats``, K3 ``csr_gram``, K4 ``project``, K5
``variance``, K6 ``gram``, K7 ``bcd_sweep``; one ``nvcc`` each, all
started together), holds each against its plain PyTorch version on the
same inputs, and drives the port's paths at NYTimes width (102,660
words, 5 components, target cardinality 5):

* the dense fit of ``repro_torch.launch.spca_run`` at 30,000 docs,
  against the reference record in
  ``src/repro_torch/data/reference/spca_run_nytimes.json``; K1 is held
  to its plain version again at every shape the fits launched it with,
  timed at every n_hat the dense fit launched it at (the 8-sweep solve
  and the one-sweep fallback apart) beside the floor of its dependency
  chain, the batched solve runs at NYTimes' and PubMed's largest
  reduced sizes, and the fit's two solver programs are timed on one
  clock, with and without the profiler;
* on the same corpus, the dense row-block pipeline
  (``repro_torch.data.screen_and_gram_streaming`` over 256-row blocks:
  one K5 launch a block for the screen, one K6 launch a block for the
  Gram on the 500-word support) and the fit on its Sigma_hat, against
  ``dense_blocks_nytimes.json`` and exact float64 statistics; and the
  dense fit on the legacy per-row solver (``qp_impl='pallas'``: one K7
  launch a row update) against ``spca_run_nytimes.json``, then again
  under the profiler for K7's device time; K5, K6 and K7 are held to
  their plain versions on the path's blocks and Sigma_hat (K7's one-warp
  scheme also to its block-wide one, bit for bit) and timed at its
  shapes beside their bounds, K7 at every n_hat the per-row fit
  launched it at;
* the out-of-core fit (``--streaming``) at the paper's 300,000 docs,
  from a CSR store in a temporary directory (removed at the end),
  against ``spca_run_nytimes_streaming.json``; K2 and K3 are held to
  their plain versions on real megabatches of that store, both corpus
  passes are held to exact float64 statistics of the corpus, and both
  kernels are timed at the fit's shape beside their bounds;
* serving: the launcher's fit at 30,000 docs, registration, 4,000
  queries in batches of 64 (one K4 launch each) and both drift streams,
  against ``serve_topics_nytimes.json``; K4 is held to its plain version
  and to the record's reference scores, timed at B 64 and 512 beside its
  bound, ``X @ W`` and a one-element launch's device time, and a batch's
  time is split between its host and device parts;
* reliability, on the 300k store (``resume_streaming``): the streaming
  fit with pass and fit checkpoints (``resume_dir``) beside the fit
  without, in turns on one clock, with its checkpoints' count, bytes and
  span time; the fit killed by an injected read fault halfway into the
  Gram pass and resumed; the screen and Gram passes killed and resumed
  against uninterrupted ones (``sum``, ``sumsq``, ``g``, ``err``: a max
  abs difference of 0); the fit killed by an injected launch failure
  mid-search and resumed; and the pass watchdog expiring mid-pass and the
  fit resumed: every resumed fit equal to the clean card run, through
  K2, K3 and K1;
* live telemetry (``export``): the serving launcher with
  ``--export-port 0``, ``/metrics``, ``/healthz`` and ``/varz`` scraped
  while it serves and just before it stops; K4's count on ``/metrics``
  equal to its launches, docs/s beside the run without the exporter;
* the lambda-grid probe (``grid_probe``): the dense fit with
  ``lam_grid_probe=8``, one K1 launch a search, against the dense record,
  and K1's grid against its plain version on component 1's probe;
* the lane mesh, on lanes forced onto the card
  (``REPRO_TORCH_FORCE_LANES``, set in this process only): the device
  grid (``device_grid``: ``solve_bcd_many`` on the dense fit's problems
  at 4 lanes equal to one launch bit for bit, one K1 launch a lane), the
  300k store's passes at D 4 beside the engine's (58 + 58 dispatches, one
  K2 or K3 launch a lane, repeated bit for bit), ``spca_run --streaming
  --devices 4`` against the streaming record, the degrade ladder, a mesh
  pass killed and resumed, and what concurrent K2 and K3 launches on four
  streams do (``mesh_*``);
* the baselines (``baselines``): the first-order method's sandwich
  around the BCD solve, the power iteration against ``eigh``, and the
  dense pooled statistics on 4 lanes against 1.
* the LM serving path, after the rest (``lm_*``): the serve loop on the
  reference's smoke weights of qwen2-0.5b and mamba2-130m against
  ``lm_serve_smoke.npz`` (``lm_record``); qwen2-0.5b, mamba2-130m,
  whisper-medium and minitron-8b (drawn on the card) at their published
  widths in float32, decode against forward and the card against the
  CPU (``lm_full_width``); and ``launch/serve.py --arch qwen2-0.5b`` at
  full width, B 4 and B 64, with decode tok/s, ms a step, prefill
  seconds and peak memory beside the card's name and power limit
  (``lm_serve``);
* the LM training path, last (``lm_train*``): three train steps on the
  reference's smoke weights against ``lm_train_smoke.npz``
  (``lm_train_record``); one qwen2-0.5b train step at full width in
  float32, the card against the CPU (``lm_train_full_width``); and
  ``launch/train.py --arch qwen2-0.5b`` at full width, B 8, S 128, 60
  steps, with ms a step, tokens/s, peak memory and ``train_mfu`` beside
  the card's name and power limit, a profile, a batch fitted in 10
  steps, then a child launcher killed by SIGTERM and resumed against two
  uninterrupted runs (``lm_train``, ``lm_train_resume``); then
  ``launch/train.py --mesh 2x2`` on 4 lanes forced onto the card, 10
  steps at full width, against ``--mesh 1x1 --microbatches 2`` (the
  same losses) and ``--mesh 1x1``, each lane's bytes at rest beside the
  dry-run's count, and its step-5 checkpoint resumed on ``4x1`` and
  ``1x1``, and the 2x2 run again with ``cfg.seq_parallel`` (token rows
  kept on their model lanes between blocks; each lane's saved
  activations beside the dry-run's) (``lm_train_mesh``);
  ``launch/train.py --arch mamba2-130m
  --mesh 2x2`` at full width, 4 steps, its Mamba2 blocks split by head
  over ``model``, against ``--mesh 1x1 --microbatches 2`` and ``--mesh
  2x1``, each lane's gathered bytes for one Mamba2 period beside the
  whole block's (``lm_train_mesh_ssm``); the partitioned serve steps
  (``make_serve_step(model, mesh)``, ``make_prefill_step(model, mesh)``)
  of qwen2-0.5b on ``2x2``, ``1x4`` and ``2x1`` and mamba2-130m on
  ``2x2`` against one device (``lm_serve_mesh``); the dense pooled statistics on a (2, 2)
  lane mesh are held to a 2-lane data mesh bit for bit in
  ``baselines``.  The LM paths have no kernel of their own: the
  reference computes them with plain ``@`` and so does the port.

Each phase prints one JSON line; a failed check raises, so the script
exits non-zero.  The last lines are the kernel table, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores, SXM data sheet
H100_F64_FLOPS = 34e12          # float64 outside the tensor cores, SXM data sheet
H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_TF32_FLOPS = 495e12        # dense TF32 on the tensor cores, SXM data sheet
# float32-accurate products on the tensor cores: three TF32 products each
# (3xTF32), faster than the CUDA cores, so the floor of a float32 Gram
H100_F32_TC_FLOPS = H100_TF32_FLOPS / 3
FIT_ARGS = ["--corpus", "nytimes", "--docs", "30000", "--components", "5",
            "--target-card", "5"]
STREAM_ARGS = ["--streaming", "--corpus", "nytimes", "--docs", "300000",
               "--components", "5", "--target-card", "5", "--device", "cuda"]
SERVE_ARGS = ["--docs", "30000", "--words", "102660", "--components", "5",
              "--target-card", "5", "--queries", "4000", "--batch", "64",
              "--device", "cuda"]
KERNELS = ("bcd_fused", "csr_stats", "csr_gram", "project", "variance", "gram",
           "bcd_sweep")
CHUNK_ROWS, MEGABATCH = 512, 8   # the launcher's default pass geometry
# what every kernel measures beside the common keys: its device time alone
# and the library call's (None where no torch call computes the function)
DEVICE_KEYS = ("device_ms", "library_device_ms")
# K1's chain floor: the dependent operations of one box-QP coordinate step
# (g = w_i - y1 u_i; eta = -g / y1, at least a reciprocal, a multiply and
# a correction; two clamps; d = eta - u_i; w_(i+1) += X_(i,i+1) d, a
# multiply and an add): 9, at the 4-cycle dependent-issue latency of the
# H100's float32 pipes, and nothing for the broadcast between lanes
COORD_STEP_CYCLES = 9 * 4
DENSE_BLOCK = 256                # rows of a dense row block (the reference's tests)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bcd_ops(nv, qp_sweeps, tau_iters, sweeps):
    """Floating-point operations of one fused solve that ran ``sweeps``
    sweeps on ``nv`` valid coordinates (counted from the kernel's loops)."""
    row = (2 * nv * nv                              # w0 = Y s
           + qp_sweeps * (nv - 1) * (2 * nv + 10)   # coordinate steps
           + 4 * nv                                 # trace, u.w
           + 8 * tau_iters)                         # bisection
    return sweeps * (nv * row + 4 * nv * nv)        # + objective


def sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return 1e6 * float(out.stdout.split()[0])


def bcd_chain_steps(nv, qp_sweeps, sweeps):
    """Box-QP coordinate steps on K1's dependency chain: every sweep
    updates nv rows, each in ``qp_sweeps`` passes over its nv - 1 free
    coordinates, each step needing the w the previous one left."""
    return sweeps * nv * qp_sweeps * max(nv - 1, 0)


def chain_bound(nbytes, ops, steps, clock, flops=None):
    """The bound of a box-QP kernel (K1, K7): the largest of its bytes
    over the memory rate, its operations over the float32 rate, and its
    chain of ``steps`` dependent coordinate steps at `COORD_STEP_CYCLES`
    each on the SM ``clock`` (Hz).  The chain is operations too, each
    waiting on the last, so where it is the largest ``bound_by`` is
    ``operations``; the three floors are kept apart for the timing lines."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / (flops or H100_F32_FLOPS) * 1e3
    t_chain = steps * COORD_STEP_CYCLES / clock * 1e3
    bound = max(t_bytes, t_ops, t_chain)
    return {"bound_ms": bound,
            "bound_by": "bytes" if t_bytes == bound else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "chain_steps": steps, "chain_bound_ms": t_chain}


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=20, kernel=None):
    """Device time of one ``fn()`` call: for each CUDA kernel the profiler
    traces in ``reps`` calls (only those whose name holds ``kernel``, if
    given), its mean time times the launches it makes a call (its records
    over ``reps``, rounded up), summed; None where three sessions record
    no device time.  The mean, not the sum over ``reps``: on the H100 a
    session now and then drops some of its kernels' records (13 of 20
    kept in one; 8,306 of 8,320 in another), while the times it keeps
    agree to ~1 %.  Unlike `cuda_ms` it leaves out the host's time
    between launches, which bounds a short kernel's back-to-back rate on
    this host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a profiler session now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            t = (getattr(e, "self_device_time_total", 0)
                 or getattr(e, "self_cuda_time_total", 0))
            if t and e.count and (kernel is None or kernel in e.key):
                us += t / e.count * -(-e.count // reps)
        if us:
            return us / 1e3
    return None


def host_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_env():
    import torch

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build(KERNELS)
    wall = time.perf_counter() - t0
    ptxas = {}
    for name in KERNELS:
        log = os.path.join(_build.BUILD_DIR, f"{name}.log")
        if os.path.exists(log):
            ptxas[name] = [ln.strip() for ln in open(log)
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln]
    emit("env", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         build_s=round(wall, 3), built=built, ptxas=ptxas)


def _supports(X, sizes):
    from repro_torch.core.bcd import leading_sparse_component

    return [leading_sparse_component(X[b, :n, :n] / X[b, :n, :n].trace()) != 0
            for b, n in enumerate(sizes)]


def _hold(phase, label, S, X0, lams, betas, sizes, kw, schemes=("smem",
          "global"), ref_device=None, chaotic=None):
    """Kernel against its plain version on the same inputs: ``ops``
    dispatch (B = 1: ``bcd_solve``, else ``bcd_solve_batched``) with
    ``impl='cuda'`` in each forced scheme that fits, ``impl='ref'`` on
    ``ref_device`` (default the card; the host where the plain loop would
    take minutes on the card).  Float64: X and F to 1e-10 relative, equal
    sweeps.  Float32 (reductions in another order move X at ~1e-6): F to
    1e-4 relative, identical supports, equal sweeps.  A problem whose
    plain solve ends non-finite (float32 on some unstructured problems,
    as the reference's oracle does; ROADMAP queue 3) must end non-finite
    in the kernel too, and is left out of the other comparisons.
    ``chaotic`` (the
    case of ``testing.bcd_problems.CHAOTIC``): F over the first
    ``agree_sweeps`` sweeps to ``agree_rtol`` and equal sweeps, the bound
    two faithful float64 implementations share there.  Returns the worst
    |dX| over the schemes."""
    import torch

    from repro_torch.kernels import bcd_fused, ops

    dtype = S.dtype
    name = str(dtype).split(".")[-1]

    def solve(impl, scheme, dev):
        S_, X0_ = S.to(dev), X0.to(dev)
        if len(sizes) == 1:
            out = ops.bcd_solve(S_[0], lams[0], betas[0], X0_[0],
                                n_valid=sizes[0], impl=impl, scheme=scheme,
                                **kw)
            return tuple(o[None] for o in out)
        return ops.bcd_solve_batched(S_, lams, betas, X0_, sizes, impl=impl,
                                     scheme=scheme, **kw)

    ref = [o.to(S.device) for o in solve(
        "ref", "auto", S.device if ref_device is None else ref_device)]
    worst = 0.0
    for scheme in schemes:
        try:
            bcd_fused.plan_fused_solve(S.shape[-1], S.element_size(), scheme)
        except ValueError:
            emit(phase, dtype=name, case=label, scheme=scheme,
                 skipped="X does not fit a block's shared memory")
            continue
        got = solve("cuda", scheme, S.device)
        torch.cuda.synchronize()
        fin = torch.isfinite(ref[0]).flatten(1).all(1)
        same_fin = torch.equal(fin, torch.isfinite(got[0]).flatten(1).all(1))
        keep = [b for b in range(len(sizes)) if fin[b]]
        gX, rX, gF, rF = got[0][keep], ref[0][keep], got[1][keep], ref[1][keep]
        dX = float((gX - rX).abs().max()) if keep else 0.0
        dF = float((gF - rF).abs().max()) if keep else 0.0
        Fmax = float(rF.abs().max()) if keep else 0.0
        same_sweeps = bool(torch.equal(got[2].cpu(), ref[2].cpu()))
        supports = same_fin and all(torch.equal(a, b) for a, b in zip(
            _supports(gX, [sizes[b] for b in keep]),
            _supports(rX, [sizes[b] for b in keep])))
        agree = None
        if chaotic is not None:
            a = chaotic["agree_sweeps"]
            h, hr = got[3][:, :a], ref[3][:, :a]
            agree = float(((h - hr).abs() / (1 + hr.abs())).max())
            ok = agree <= chaotic["agree_rtol"]
            tol = (f"F over the first {a} sweeps to "
                   f"{chaotic['agree_rtol']:g} relative (chaotic after)")
        elif dtype == torch.float64:
            Xmax = float(ref[0].abs().max())
            ok = (same_fin and dX <= 1e-10 * max(1.0, Xmax)
                  and dF <= 1e-10 * max(1.0, Fmax))
            tol = "1e-10 relative (X and F)"
        else:
            ok = dF <= 1e-4 * (1.0 + Fmax) and supports
            tol = "F to 1e-4 relative, identical supports"
        worst = max(worst, dX)
        emit(phase, dtype=name, case=label, scheme=scheme,
             n=S.shape[-1], n_valid=sizes, max_abs_dX=dX, max_abs_dF=dF,
             max_abs_X=float(rX.abs().max()) if keep else None,
             sweeps=got[2].tolist(), sweeps_equal=same_sweeps,
             supports_equal=supports, early_F_rel_diff=agree,
             nonfinite=[b for b in range(len(sizes)) if not fin[b]],
             nonfinite_equal=same_fin, tolerance=tol, ok=ok)
        check(ok and same_sweeps, f"{phase} {name} {label} {scheme}")
    return worst


def _dtypes():
    import numpy as np
    import torch

    return ((torch.float32, np.float32), (torch.float64, np.float64))


def phase_kernel_parity():
    """The kernel against its plain version on the card, both schemes,
    both dtypes, n in {40, 100} inside n_pad 128; in float64 also with the
    early exit on, on a spiked problem (converges in 6 sweeps) and on the
    unstructured chaotic one.  Returns the worst |dX| by dtype over the
    cases whose X is held, and the chaotic case's |dX| apart."""
    import numpy as np
    import torch

    from repro_torch.testing import CHAOTIC, covariance_problems

    dev = torch.device("cuda")
    cases = {"B1_n40": [40], "B1_n100": [100], "B4_mixed": [40, 100, 64, 17]}
    short = dict(max_sweeps=3, qp_sweeps=2, tol=-1.0)
    worst, chaotic_dX = {}, 0.0
    for dtype, np_dtype in _dtypes():
        rng = np.random.default_rng(0)
        name = str(dtype).split(".")[-1]
        runs = [(case, sizes, covariance_problems(rng, sizes, 128, np_dtype),
                 short, None) for case, sizes in cases.items()]
        if dtype == torch.float64:
            runs.append(("B1_n40_tol_spiked", [40], covariance_problems(
                np.random.default_rng(0), [40], 128, np_dtype, spike=True),
                dict(max_sweeps=20, qp_sweeps=2, tol=1e-6), None))
            c = CHAOTIC
            runs.append(("B1_n40_tol_chaotic", c["sizes"], covariance_problems(
                np.random.default_rng(c["seed"]), c["sizes"], c["n_pad"],
                np_dtype), {k: c[k] for k in ("max_sweeps", "qp_sweeps",
                                              "tol")}, c))
        for label, sizes, (S, X0, lams, betas), kw, chaotic in runs:
            S, X0 = (torch.from_numpy(a).to(dev) for a in (S, X0))
            dX = _hold("kernel_parity", label, S, X0, lams, betas, sizes, kw,
                       chaotic=chaotic)
            if chaotic is None:
                worst[name] = max(worst.get(name, 0.0), dX)
            else:
                chaotic_dX = max(chaotic_dX, dX)
    return worst, chaotic_dX


def phase_kernel_parity_fit(shapes):
    """The kernel against its plain version at every shape the fits
    launched it with (``solver.solve`` n, ``solver.solve_many`` batch and
    n_pad): B = 1 at n, and B = 4 at n with mixed n_valid; each batched
    shape as launched, with mixed n_valid.  Both dtypes, every scheme that
    fits, 3 sweeps; the plain version runs on the host."""
    import numpy as np
    import torch

    from repro_torch.testing import covariance_problems

    dev = torch.device("cuda")
    kw = dict(max_sweeps=3, qp_sweeps=2, tol=-1.0)
    cases = []
    for n in shapes["single"]:
        cases += [(f"B1_n{n}", n, [n]),
                  (f"B4_n{n}", n, [n, max(1, 3 * n // 4), max(1, n // 2),
                                   max(1, n - 17)])]
    for B, n in shapes["batched"]:
        cases.append((f"B{B}_npad{n}", n,
                      [max(1, n - (n * b) // (2 * B)) for b in range(B)]))
    worst = {}
    for dtype, np_dtype in _dtypes():
        rng = np.random.default_rng(1)
        name = str(dtype).split(".")[-1]
        for label, n, sizes in cases:
            S, X0, lams, betas = covariance_problems(rng, sizes, n, np_dtype)
            S, X0 = (torch.from_numpy(a).to(dev) for a in (S, X0))
            worst[name] = max(worst.get(name, 0.0), _hold(
                "kernel_parity_fit", label, S, X0, lams, betas, sizes, kw,
                ref_device="cpu"))
    return worst


def _fit(extra):
    """Drive the launcher once with fresh counters; returns what it
    returned (or the divergence it raised, with the components completed
    before it), the counts, and the shapes the kernel was launched at."""
    from repro_torch.core.bcd import SolverDivergenceError
    from repro_torch.kernels import bcd_fused
    from repro_torch.launch import spca_run
    from repro_torch.obs import metrics, trace

    with metrics.use_registry() as reg, trace.enable() as tr:
        bcd_fused.reset_launches()
        t0 = time.perf_counter()
        try:
            out, err = spca_run.main(FIT_ARGS + ["--device", "cuda"] + extra), None
        except SolverDivergenceError as e:
            k = tr.find("fit.component")[-1].attrs["k"]
            out, err = None, {"component": int(k), "n": int(e.n),
                              "lam": float(e.lam), "message": str(e),
                              "completed": e.completed}
        fit_s = time.perf_counter() - t0
        shapes = {"single": sorted({int(sp.attrs["n"]) for sp
                                    in tr.find("solver.solve")}),
                  "batched": sorted({(int(sp.attrs["batch"]),
                                      int(sp.attrs["n_pad"])) for sp
                                     in tr.find("solver.solve_many")})}
        counts = {
            "kernel_launches": bcd_fused.launches,
            "kernel.launches.bcd_solve": reg.value("kernel.launches.bcd_solve"),
            "kernel.launches.bcd_solve_batched":
                reg.value("kernel.launches.bcd_solve_batched"),
            "solver.fallbacks": reg.value("solver.fallbacks"),
            "solver.stalled": reg.value("solver.stalled"),
            "solver.nonfinite": reg.value("solver.nonfinite"),
        }
    return out, err, fit_s, counts, shapes


def _pc_lines(corpus, results):
    return [{"words": [corpus.vocab[i] for i in r.support],
             "support": r.support.tolist(), "n_hat": r.reduced_n,
             "lam": r.lam, "variance": r.variance, "gap": r.gap}
            for r in results]


def _vs_record(results, rec):
    """Per component: the same support (the slice's criterion), and how
    its lambda and reduced size compare with the record's."""
    return [{"support_equal": r.support.tolist() == c["support"],
             "n_hat": [r.reduced_n, c["reduced_n"]],
             "lam": [r.lam, c["lam"]],
             "lam_rel_diff": abs(r.lam - c["lam"]) / c["lam"]}
            for r, c in zip(results, rec["components"])]


def _same_supports(results, rec):
    return (len(results) == len(rec["components"])
            and all(v["support_equal"] for v in _vs_record(results, rec)))


def phase_fit(record):
    out, err, fit_s, counts, shapes = _fit([])
    check(err is None, f"sequential fit raised {err}")
    corpus, results, diag = out
    emit("fit", seconds=fit_s, pcs=_pc_lines(corpus, results),
         solve_launches=diag["solve_launches"],
         fallbacks_per_component=[d["fallbacks"] for d in diag["components"]],
         kernel_shapes=shapes, **counts)
    check(counts["kernel.launches.bcd_solve"] > 0, "no fused solve launched")
    check(counts["kernel.launches.bcd_solve"] == diag["solve_launches"],
          "kernel.launches.bcd_solve != solve launches")
    check(counts["kernel_launches"] >= diag["solve_launches"],
          "fewer kernel launches than fused solves")
    emit("fit_vs_record", components=_vs_record(results, record["fit"]))
    check(_same_supports(results, record["fit"]),
          "sequential fit's supports differ from the reference record")
    return corpus, results, counts, shapes


def _fit_direct(corpus, solver_impl, **cfg):
    """The launcher's fit on an already generated corpus (the launcher's
    config and Gram), through `fit_components`; ``cfg`` sets further
    `SPCAConfig` fields."""
    import torch

    from repro_torch.core import SPCAConfig, fit_components
    from repro_torch.launch.spca_run import dense_stats

    diag = {}
    results = fit_components(
        None, 5, target_card=5, diagnostics=diag, device="cuda",
        cfg=SPCAConfig(max_sweeps=8, lam_search_evals=8,
                       solver_impl=solver_impl, **cfg),
        stats=dense_stats(corpus, torch.device("cuda")))
    torch.cuda.synchronize()
    return results, diag


def phase_fit_jnp(record, corpus):
    """Diagnosis: the same fit with solver_impl='jnp' — the whole-matrix
    program the reference's CPU launcher runs (on the card its sweeps are
    kernel launches, its stopping test the augmented objective on the
    host).  Where the default fused path's lambdas differ from the record,
    this shows whether the early-exit rule or the sweep arithmetic moved
    them."""
    t0 = time.perf_counter()
    results, diag = _fit_direct(corpus, "jnp")
    emit("fit_jnp", seconds=time.perf_counter() - t0,
         solve_launches=diag["solve_launches"],
         components=_vs_record(results, record["fit"]))
    check(_same_supports(results, record["fit"]),
          "solver_impl='jnp' fit's supports differ from the record")


def _device_events(prof):
    """(ms, count, name) of each device event kind in a torch.profiler
    run, largest first: kernels, copies, memsets."""
    import torch

    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((us / 1e3, e.count, e.key[:90]))
    return sorted(out, reverse=True)


def phase_profile(corpus):
    """Where the fit's time goes, and the two solver programs on one
    clock: the default fit (``'auto'``: one fused K1 launch a solve, the
    stall fallback one K1 launch a sweep) and ``solver_impl='jnp'`` (one
    K1 launch a sweep, the stopping test on the host), each timed by the
    host clock without the profiler, then under torch.profiler: device
    time by kernel, K1's device time summed over its launches, and the
    device's busy share of the fit's wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for impl, phase in (("jnp", "profile_jnp"), ("auto", "profile")):
        t0 = time.perf_counter()
        _fit_direct(corpus, impl)
        bare = time.perf_counter() - t0
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _fit_direct(corpus, impl)
            wall = time.perf_counter() - t0
        kernels = _device_events(prof)
        busy_ms = sum(k[0] for k in kernels)
        k1 = [k for k in kernels if "bcd_fused" in k[2]]
        emit(phase, solver_impl=impl, fit_wall_s_unprofiled=bare,
             fit_wall_s=wall, device_busy_ms=busy_ms,
             device_busy_share=busy_ms / 1e3 / wall,
             k1_device_ms=sum(k[0] for k in k1),
             k1_launches=sum(k[1] for k in k1),
             top=[{"ms": ms, "count": c, "name": name}
                  for ms, c, name in kernels[:8]])


def phase_fit_batched(record):
    out, err, fit_s, counts, shapes = _fit(["--batch-evals", "4"])
    rec = record["fit_batched"]
    done = None if err is None else err.pop("completed")
    emit("fit_batched", seconds=fit_s, diverged=err,
         pcs=None if out is None else _pc_lines(out[0], out[1]),
         completed=None if done is None else _vs_record(done, {
             "components": rec.get("completed", [])}),
         record=rec.get("diverged"), kernel_shapes=shapes, **counts)
    check(counts["kernel.launches.bcd_solve_batched"] > 0,
          "no batched solve launched")
    if "diverged" in rec:
        # The reference diverges here (float32, see ROADMAP queue 3): the
        # port must end the same way, in the same component and bucket,
        # with the same supports in the components completed before it.
        check(err is not None
              and err["component"] == rec["diverged"]["component"]
              and err["n"] == rec["diverged"]["n"],
              "batched fit does not end as the reference's does")
        check(_same_supports(done, {"components": rec["completed"]}),
              "batched fit's completed supports differ from the record")
    else:
        check(err is None and _same_supports(out[1], rec),
              "batched fit's supports differ from the reference record")
    return shapes


def phase_large_n(corpus):
    """Batched solves on Sigma_hat over the corpus's top-n variance words:
    n = 500 (NYTimes' expected_reduced_max), B = 4, float32, at the
    lambdas where the screen keeps between n/4 and n words (where a fit
    solves a problem this size); the same n in float64 at two lambdas far
    above most of those words' variances, and in float32 there, printed
    unchecked: it goes NaN, as the reference's own oracle does (ROADMAP
    queue 3); then n = 1000 (PubMed's) if one sweep fits the time.
    Global scheme throughout.  Last, the kernel against its plain version
    (on the host) at both n: one sweep, float64, B = 1; n = 1000 is where
    a thread owns several columns (512 threads, n_pad 1024).  Returns the
    worst |dX| of that comparison."""
    import numpy as np
    import torch

    from repro_torch.configs.spca_experiments import NYTIMES, PUBMED
    from repro_torch.kernels import bcd_fused, ref
    from repro_torch.launch.spca_run import dense_stats

    dev = torch.device("cuda")
    var, build = dense_stats(corpus, dev)
    order = np.argsort(-var, kind="stable")
    vs = var[order]
    n5, n10 = NYTIMES.expected_reduced_max, PUBMED.expected_reduced_max
    high = np.geomspace(vs[n5 - 1], vs[4], 6)[3:5]
    # (n, dtype, lambdas, checked): the float32 run at the high lambdas is
    # printed, not checked — it shows the reference's float32 fault
    runs = [(n5, torch.float32, np.geomspace(vs[n5 - 1], vs[n5 // 4], 6)[1:-1],
             True),
            (n5, torch.float64, high, True),
            (n5, torch.float32, high, False),
            (n10, torch.float32, np.geomspace(vs[n10 - 1], vs[n10 // 4], 3)[1:2],
             True)]
    s_per_sweep = None
    for n, dtype, lams, checked in runs:
        sweeps = 2 if n == n5 else 1
        if n == n10 and s_per_sweep * (n / n5) ** 3 > 150:
            emit("large_n", n=n, skipped="one sweep would not fit the time",
                 estimate_s=s_per_sweep * (n / n5) ** 3)
            continue
        B = len(lams)
        S = build(np.sort(order[:n])).to(dtype)
        Sig = S[None].expand(B, n, n).contiguous()
        X0 = torch.eye(n, dtype=dtype, device=dev)[None].expand(B, n, n)
        betas = [1e-4 * float(torch.trace(S)) / n] * B
        plan = bcd_fused.plan_fused_solve(n, S.element_size())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, F, k, _ = bcd_fused.bcd_solve_batched_cuda(
            Sig, lams, betas, X0.contiguous(), -1.0, [n] * B,
            max_sweeps=sweeps, qp_sweeps=4, tau_iters=80)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        if s_per_sweep is None:
            s_per_sweep = t / sweeps
        F_torch = torch.stack([ref.partial_objective(S, X[b], float(lams[b]))
                               for b in range(B)])
        finite = bool(torch.isfinite(X).all() and torch.isfinite(F).all())
        rtol = 1e-4 if dtype == torch.float32 else 1e-10
        F_ok = bool(torch.allclose(F, F_torch, rtol=rtol, atol=rtol))
        sym = bool(torch.equal(X, X.transpose(1, 2)))
        item = S.element_size()
        nbytes = item * B * (3 * plan.n_pad ** 2 + 4 + sweeps + 2)
        ops = B * bcd_ops(n, 4, 80, sweeps)
        peak = H100_F32_FLOPS if dtype == torch.float32 else H100_F64_FLOPS
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / peak
        emit("large_n", n=n, batch=B, dtype=str(dtype).split(".")[-1],
             scheme=plan.scheme, sweeps=int(k[0]), seconds=t,
             bound_s=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             s_per_sweep=t / sweeps, lams=lams.tolist(), F=F.tolist(),
             F_recomputed=F_torch.tolist(), finite=finite, F_matches=F_ok,
             symmetric=sym, checked=checked)
        check(not checked or (finite and F_ok and sym),
              f"large_n n={n} {dtype}")
    worst = 0.0
    for n in (n5, n10):
        S = build(np.sort(order[:n])).to(torch.float64)
        lam = float(np.geomspace(vs[n - 1], vs[n // 4], 3)[1])
        worst = max(worst, _hold(
            "large_n_parity", f"B1_n{n}", S[None],
            torch.eye(n, dtype=S.dtype, device=dev)[None], [lam],
            [1e-4 * float(torch.trace(S)) / n], [n],
            dict(max_sweeps=1, qp_sweeps=1, tol=-1.0), schemes=("global",),
            ref_device="cpu"))
    return worst


def phase_timing(corpus, results, clock):
    """K1 at the fit's shape: the first PC's cold solve (n_hat from the
    fit, float32, the launcher's sweep budget, early exit on) — kernel vs
    plain version, beside its bound (`chain_bound`).  The two results are held to each
    other: F to 1e-4 relative and identical supports (the early exit sits
    at float32's resolution of F, so the sweep counts are printed, not
    held)."""
    import torch

    from repro_torch.core.bcd import default_beta
    from repro_torch.kernels import bcd_fused, ref
    from repro_torch.launch.spca_run import dense_stats

    r = results[0]
    S = dense_stats(corpus, torch.device("cuda"))[1](r.reduced_support)
    n = S.shape[0]
    X0 = torch.eye(n, device=S.device)
    beta = default_beta(S)
    kw = dict(max_sweeps=8, qp_sweeps=4, tau_iters=80)
    res = bcd_fused.bcd_solve_cuda(S, r.lam, beta, X0, 1e-7, **kw)
    sweeps = int(res[2])
    def solve():
        return bcd_fused.bcd_solve_cuda(S, r.lam, beta, X0, 1e-7, **kw)
    ms = cuda_ms(solve, 20)
    dev_ms = device_ms(solve, 10)
    plain = []
    plain_ms = host_ms(lambda: plain.append(ref.bcd_solve_ref(
        S, r.lam, beta, X0, 1e-7, **kw)))
    Xp, Fp, kp, _ = plain[0]
    dX = float((res[0] - Xp).abs().max())
    dF = abs(float(res[1]) - float(Fp))
    supports = torch.equal(*_supports(torch.stack([res[0], Xp]), [n, n]))
    ok = dF <= 1e-4 * (1 + abs(float(Fp))) and supports
    n_pad = bcd_fused.pad32(n)
    nbytes = 4 * (3 * n_pad * n_pad + 4 + 8 + 2)
    ops = bcd_ops(n, 4, 80, sweeps)
    row = {"n_hat": n, "n_pad": n_pad, "sweeps": sweeps, "ms": ms,
           "device_ms": dev_ms, "library_device_ms": None,
           "plain_ms": plain_ms,
           **chain_bound(nbytes, ops, bcd_chain_steps(n, 4, sweeps), clock),
           "bytes": nbytes, "flops": ops, "library_ms": None,
           "max_abs_dX": dX, "max_abs_dF": dF, "plain_sweeps": int(kp),
           "supports_equal": supports, "ok": ok}
    emit("timing", **row)
    check(ok, "timing: kernel and plain version disagree at the fit shape")
    return row


def phase_fit_shape_timing(corpus, sizes, clock):
    """K1 at every n_hat the dense fit's ``solver.solve`` spans launched it
    with: the launcher's fused solve (8 sweeps, float32; the early exit
    off, as 16 of the fit's 19 solves stall at 8 sweeps) and the one-sweep
    launch of the stall fallback, timed apart.  The problem at n_hat n is
    Sigma_hat over the corpus's n highest-variance words at the lambda
    where the screen keeps exactly them (the (n + 1)-th variance),
    identity start.  Per row: ms (CUDA events), device ms (profiler), the
    bound (`chain_bound`: bytes, operations and the chain's coordinate
    steps at `COORD_STEP_CYCLES` each on the card's maximum SM clock), the
    reps chosen so each shape takes ~0.2 s."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.bcd import default_beta
    from repro_torch.kernels import bcd_fused
    from repro_torch.launch.spca_run import dense_stats

    var, build = dense_stats(corpus, torch.device("cuda"))
    order = np.argsort(-var, kind="stable")
    rows = []
    for n in sizes:
        S = build(np.sort(order[:n]))
        lam, beta = float(var[order[n]]), default_beta(S)
        X0 = torch.eye(n, device=S.device)
        for label, sweeps in (("fused", 8), ("one_sweep", 1)):
            def solve():
                return bcd_fused.bcd_solve_cuda(S, lam, beta, X0, -1.0,
                                                max_sweeps=sweeps,
                                                qp_sweeps=4, tau_iters=80)
            reps = int(min(20, max(2, 200.0 / host_ms(solve))))
            nbytes = 4 * (3 * bcd_fused.pad32(n) ** 2 + 4 + sweeps + 2)
            row = {"n_hat": n, "launch": label, "sweeps": sweeps,
                   "reps": reps, "ms": cuda_ms(solve, reps),
                   "device_ms": device_ms(solve, reps),
                   **chain_bound(nbytes, bcd_ops(n, 4, 80, sweeps),
                                 bcd_chain_steps(n, 4, sweeps), clock),
                   "plan": dataclasses.asdict(bcd_fused.plan_fused_solve(n))}
            emit("fit_shape_timing", **row)
            rows.append(row)
    return rows
# ------------------------------------------------- dense row blocks, per-row


U32 = 2.0 ** -24                # float32 unit roundoff


def _gamma(m):
    """gamma_m = m u / (1 - m u): two float32 sums of the same m terms, in
    any two orders, differ by at most 2 gamma_m times the sum of the
    terms' magnitudes."""
    return m * U32 / (1 - m * U32)


def phase_dense_blocks(record, corpus):
    """The dense row-block pipeline at NYTimes width, with every kernel
    count set to 0 just before and read just after: the record's lambda
    (the exact variances' 500th), ``screen_and_gram_streaming`` over
    ``corpus.batches(256)`` on the card (118 blocks a pass, one K5 and one
    K6 launch a block), then the fit on its Sigma_hat in float32 (the
    launcher's config, K1).  Held to ``dense_blocks_nytimes.json``: count,
    support, launches, Sigma_hat's diagonal, trace and Frobenius norm, the
    five word supports (lambdas reported); and to exact float64 statistics
    of the corpus: the screen's variances and Sigma_hat within 4 u cancel
    of the largest entry (u = 2^-24; cancel = max second moment / max
    result: float32 block sums of integer counts are exact, the float64 or
    compensated fold adds ~nothing, the float32 rounding of the variances
    and of the means in the centring costs u each, relative to the second
    moment).  Each pass's seconds come from this run (the second pass
    from the moment its blocks are asked for), and so do the first and
    the ragged last block the kernels are held to later."""
    import numpy as np
    import torch

    from repro_torch.configs.spca_experiments import NYTIMES
    from repro_torch.core import SPCAConfig, fit_components
    from repro_torch.core.elimination import lam_for_target_size
    from repro_torch.data import screen_and_gram_streaming
    from repro_torch.kernels import bcd_fused, gram, variance
    from repro_torch.obs import metrics

    dev = torch.device("cuda")
    mean_x, var_x = corpus.column_stats_exact()
    lam = lam_for_target_size(var_x, NYTIMES.expected_reduced_max)
    starts, kept = [], []

    def batches():
        starts.append(time.perf_counter())
        for b in corpus.batches(DENSE_BLOCK):
            if len(starts) == 1 and (not kept or b.shape[0] < DENSE_BLOCK):
                kept.append(b)
            yield b

    with metrics.use_registry() as reg:
        for k in (variance, gram, bcd_fused):
            k.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S, support, screen = screen_and_gram_streaming(
            batches, corpus.n_words, lam, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        results = fit_components(
            S.astype(np.float32), 5, target_card=5, is_covariance=True,
            cfg=SPCAConfig(max_sweeps=8, lam_search_evals=8), device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = {"column_stats": variance.launches, "gram": gram.launches,
                  "bcd_fused": bcd_fused.launches,
                  **{f"kernel.launches.{op}": reg.value(f"kernel.launches.{op}")
                     for op in ("column_stats", "gram", "bcd_solve")}}
    m = corpus.n_docs
    var = screen.variances.double().cpu().numpy()
    sec2 = np.bincount(corpus.word_idx, minlength=corpus.n_words,
                       weights=corpus.counts.astype(np.float64) ** 2) / m
    A = torch.from_numpy(corpus.columns_dense(support)).to(dev).double()
    second = (A.T @ A) / m
    A -= A.mean(0)
    S_x = ((A.T @ A) / m).cpu().numpy()
    del A
    tol_v = 4 * U32 * float(sec2.max() / var_x.max())
    tol_S = 4 * U32 * float(second.abs().max()) / float(np.abs(S_x).max())
    e_var, e_S = _rel_err(var, var_x), _rel_err(S, S_x)
    e_mean = _rel_err(screen.means.double().cpu(), mean_x)
    rs = record["sigma_hat"]
    words = [support[r.support] for r in results]
    comps = [{"support_equal": w.tolist() == c["support"],
              "words": [corpus.vocab[i] for i in w],
              "n_hat": [r.reduced_n, c["reduced_n"]], "lam": [r.lam, c["lam"]],
              "lam_rel_diff": abs(r.lam - c["lam"]) / c["lam"]}
             for r, w, c in zip(results, words, record["fit"]["components"])]
    same_support = support.tolist() == record["support"]
    inf = float("inf")
    diag_err = (_rel_err(np.diagonal(S), rs["diagonal"]) if same_support
                else inf)
    var_rec = (_rel_err(var[support], record["support_variances"])
               if same_support else inf)
    tr_err = abs(np.trace(S) - rs["trace"]) / rs["trace"]
    fro_err = abs(np.linalg.norm(S) - rs["frobenius"]) / rs["frobenius"]
    out = {"screen_pass_s": starts[1] - starts[0], "gram_pass_s": t1 - starts[1],
           "pipeline_s": t1 - t0, "fit_s": t2 - t1}
    emit("dense_blocks", **out, lam=lam, record_lam=record["lam"],
         count=screen.count, n_hat=int(support.size), **counts,
         record_launches=record["launches"],
         rel_err_var=e_var, rel_err_mean=e_mean, tolerance_var=tol_v,
         rel_err_sigma=e_S, tolerance_sigma=tol_S,
         vs_record={"support_variances": var_rec, "diagonal": diag_err,
                    "trace": tr_err, "frobenius": fro_err},
         components=comps)
    n_blocks = record["blocks"]
    check(lam == record["lam"], "lambda differs from the record's")
    check(screen.count == record["count"] == m, "count")
    check(same_support, "support differs from the record")
    check(counts["kernel.launches.column_stats"] == counts["column_stats"]
          == counts["kernel.launches.gram"] == counts["gram"] == n_blocks
          == record["launches"]["column_stats"] == record["launches"]["gram"],
          "K5 / K6 launches != blocks")
    check(e_var <= tol_v and e_mean <= tol_v, "screen vs exact statistics")
    check(e_S <= tol_S, "Sigma_hat vs the exact float64 covariance")
    check(max(var_rec, diag_err, tr_err, fro_err) <= 1e-6,
          "screen / Sigma_hat differ from the record")
    check(counts["bcd_fused"] > 0, "the fit did not launch K1")
    check(len(kept) == 2, "the last block is not ragged")
    check(len(results) == 5 and all(c["support_equal"] for c in comps),
          "the fit's word supports differ from the record's")
    return {"S": S, "support": support, "means": screen.means, "counts": counts,
            "blocks": tuple(kept), **out}


def phase_dense_pass_profile(corpus, dense):
    """Where a dense pass's time goes: each pass again under
    torch.profiler (the device's busy and idle share of its wall time, a
    host-to-device copy counting as busy), and the host's densify alone
    (``corpus.batches(256)`` with no device work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import StreamingGram, StreamingStats

    dev = torch.device("cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for kind in ("screen", "gram"):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            acc = (StreamingStats(corpus.n_words, device=dev) if kind == "screen"
                   else StreamingGram(dense["support"], device=dev))
            for b in corpus.batches(DENSE_BLOCK):
                acc.update(b)
            if kind == "screen":
                acc.finalize(dtype=torch.float32)
            else:
                acc.finalize(means=dense["means"].cpu().numpy())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = _device_events(prof)
        busy = sum(e[0] for e in events)
        out[kind] = {"profiled_s": wall, "device_busy_ms": busy,
                     "idle_share": 1 - busy / 1e3 / wall,
                     "top": [{"ms": ms, "count": c, "name": name}
                             for ms, c, name in events[:4]]}
    t0 = time.perf_counter()
    for _ in corpus.batches(DENSE_BLOCK):
        pass
    out["host_densify_s"] = time.perf_counter() - t0
    emit("dense_pass_profile", **out)
    return out


def _max_abs_diff(a, b):
    return float(max((x.double() - y.double()).abs().max() for x, y in
                     zip(a, b)))


def phase_dense_kernel_parity(corpus, dense):
    """K5, K6 and K7 against their plain versions on the card, each run
    twice (the run-to-run max |diff| must be 0: no atomics, fixed orders).
    K5 on the first and the ragged last NYTimes block, exactly (integer
    counts: every float32 partial sum is exact), and on random float32 /
    float64 blocks of odd shape within 2 gamma_(m+1) (sum |a|, sum a^2)
    elementwise.  K6 on real support blocks, exactly: the first block's
    500 support columns, the last block's, the first block's top-2048
    variance columns, 37 rows of one column, and integer counts up to 2048
    at (300, 130); and on random floats within 2 gamma_{m+1} |A|^T |A|
    elementwise, including the design's edges (n % 4 != 0 with the rows
    split in slabs and without, one tile in 8 slabs).  K7 on row updates of the
    pipeline's Sigma_hat (its top-n variance words, n 16 / 48 / 192 /
    500; X = I, the first row update of a solve, and X = Sigma_hat, a
    dense symmetric Y; j first, middle, last; 4 sweeps), each output (u,
    w, R2) against its own largest |value|: float64 to 1e-12, float32 to
    1e-4 (w = Y u0 and R2 are reduced in another order, ~n u relative,
    and the clipped steps carry it); where the one-warp scheme runs (n <=
    224 float32, 160 float64), its w and R2 are also held bit for bit to
    the block-wide scheme's, which reduces in the same order."""
    import numpy as np
    import torch

    from repro_torch.kernels import bcd_sweep, ops

    dev = torch.device("cuda")
    first, last = dense["blocks"]
    sup = dense["support"]
    order = np.argsort(-corpus.column_stats_exact()[1], kind="stable")
    worst = {"column_stats": 0.0, "gram": 0.0, "qp_sweeps": 0.0}
    rerun = dict.fromkeys(worst, 0.0)
    rng = np.random.default_rng(14)
    # K5
    cases = [("first_block", first, True), ("last_block", last, True)]
    for m, n, dt in ((255, 1001, np.float32), (49, 102_661, np.float32),
                     (131, 333, np.float64)):
        cases.append((f"random_{m}x{n}_{np.dtype(dt).name}",
                      (rng.normal(size=(m, n)) * rng.lognormal(size=n)
                       ).astype(dt), False))
    for label, A, exact in cases:
        Ad = torch.from_numpy(A).to(dev)
        got = ops.column_stats(Ad, impl="cuda")
        again = ops.column_stats(Ad, impl="cuda")
        want = ops.column_stats(Ad, impl="ref")
        torch.cuda.synchronize()
        diff, rr = _max_abs_diff(got, want), _max_abs_diff(got, again)
        A32 = Ad.float().double()
        g = _gamma(A.shape[0] + 1)
        bounds = (2 * g * A32.abs().sum(0), 2 * g * (A32 * A32).sum(0))
        ratio = max(float(((x.double() - y.double()).abs() / b.clamp_min(
            1e-300)).max()) for x, y, b in zip(got, want, bounds))
        ok = (diff == 0.0 if exact else ratio <= 1.0) and rr == 0.0
        emit("dense_kernel_parity", kernel="column_stats", case=label,
             shape=list(A.shape), dtype=str(A.dtype), max_abs_diff=diff,
             diff_over_bound=ratio, run_to_run_max_abs_diff=rr,
             tolerance="0 (integer counts)" if exact
             else "2 gamma_(m+1) (sum |a|, sum a^2) elementwise", ok=ok)
        check(ok, f"column_stats parity {label}")
        worst["column_stats"] = max(worst["column_stats"], diff)
        rerun["column_stats"] = max(rerun["column_stats"], rr)
    del cases
    # K6
    top2048 = np.sort(order[:2048])
    cases = [("first_block_support", first[:, sup], True),
             ("last_block_support", last[:, sup], True),
             ("first_block_top2048", first[:, top2048], True),
             ("first_block_37x1", first[:37, sup[:1]], True)]
    for m, n in ((256, 500), (48, 500), (37, 1),
                 # the design's edges: n % 4 != 0 (4-byte copies) with the
                 # rows split in slabs, and without; one tile in 8 slabs
                 (300, 130), (256, 2047), (1000, 64)):
        cases.append((f"random_{m}x{n}", rng.normal(size=(m, n)).astype(
            np.float32), False))
    counts = rng.poisson(0.5, size=(300, 130)).astype(np.float32)
    counts[rng.integers(0, 300, 3), rng.integers(0, 130, 3)] = [2048, 2047, 1025]
    cases.append(("counts_to_2048_300x130", counts, True))
    for label, A, exact in cases:
        Ad = torch.from_numpy(np.ascontiguousarray(A)).to(dev)
        got = ops.gram(Ad, impl="cuda")
        again = ops.gram(Ad, impl="cuda")
        want = ops.gram(Ad, impl="ref")
        torch.cuda.synchronize()
        diff, rr = _max_abs_diff([got], [want]), _max_abs_diff([got], [again])
        Aa = Ad.double().abs()
        bound = 2 * _gamma(A.shape[0] + 1) * (Aa.T @ Aa)
        ratio = float(((got.double() - want.double()).abs()
                       / bound.clamp_min(1e-300)).max())
        ok = ((diff == 0.0 if exact else ratio <= 1.0) and rr == 0.0
              and torch.equal(got, got.T))
        emit("dense_kernel_parity", kernel="gram", case=label,
             shape=list(A.shape), max_abs_diff=diff, diff_over_bound=ratio,
             max_abs_G=float(want.abs().max()), run_to_run_max_abs_diff=rr,
             symmetric=bool(torch.equal(got, got.T)),
             tolerance="0 (integer counts)" if exact
             else "2 gamma_(m+1) |A|^T|A| elementwise", ok=ok)
        check(ok, f"gram parity {label}")
        worst["gram"] = max(worst["gram"], diff)
        rerun["gram"] = max(rerun["gram"], rr)
    # K7
    S = dense["S"]
    top = np.argsort(-np.diagonal(S), kind="stable")
    by_dtype = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        rtol = 1e-12 if dtype == torch.float64 else 1e-4
        for n in (16, 48, 192, 500):
            idx = np.sort(top[:n])
            Sn = torch.tensor(S[np.ix_(idx, idx)], dtype=dtype, device=dev)
            for xname, X in (("X=I", torch.eye(n, dtype=dtype, device=dev)),
                             ("X=Sigma_hat", Sn)):
                for j in (0, n // 2, n - 1):
                    mask = torch.ones(n, dtype=dtype, device=dev)
                    mask[j] = 0
                    Y = X * mask[:, None] * mask[None, :]
                    s = Sn[:, j] * mask
                    lam = 0.25 * float(s.abs().max())
                    got = ops.qp_sweeps(Y, s, lam, s, j, impl="cuda")
                    again = ops.qp_sweeps(Y, s, lam, s, j, impl="cuda")
                    want = ops.qp_sweeps(Y, s, lam, s, j, impl="ref")
                    torch.cuda.synchronize()
                    diff = _max_abs_diff(got, want)
                    rr = _max_abs_diff(got, again)
                    # each output against its own scale: max|u|, max|w|, |R2|
                    per = {k: (_max_abs_diff([g], [w]), float(w.abs().max()))
                           for k, g, w in zip(("u", "w", "R2"), got, want)}
                    scheme = bcd_sweep.plan_qp_sweep(n, Y.element_size()).scheme
                    same = None
                    if scheme == "warp":
                        block = bcd_sweep.qp_sweep_cuda(Y, s, lam, s, j, 4,
                                                        "block")
                        same = (torch.equal(got[1], block[1])
                                and torch.equal(got[2], block[2]))
                    ok = rr == 0.0 and same is not False and all(
                        d <= rtol * sc for d, sc in per.values())
                    emit("dense_kernel_parity", kernel="qp_sweeps",
                         dtype=name, n=n, Y=xname, j=j, scheme=scheme,
                         w_R2_bits_equal_block_scheme=same, max_abs_diff=diff,
                         max_abs_diff_by_output={k: d for k, (d, _)
                                                 in per.items()},
                         max_abs_value_by_output={k: sc for k, (_, sc)
                                                  in per.items()},
                         run_to_run_max_abs_diff=rr,
                         tolerance=f"{rtol:g} of each output's largest "
                                   "|value|", ok=ok)
                    check(ok, f"qp_sweeps parity {name} n={n} {xname} j={j}")
                    by_dtype[name] = max(by_dtype.get(name, 0.0), diff)
                    rerun["qp_sweeps"] = max(rerun["qp_sweeps"], rr)
    worst["qp_sweeps"] = max(by_dtype.values())
    emit("dense_kernel_parity", summary=True, max_abs_diff=worst,
         qp_sweeps_by_dtype=by_dtype, run_to_run_max_abs_diff=rerun)
    return worst, rerun, by_dtype


def phase_fit_per_row(record, corpus):
    """The dense cell's fit on the legacy per-row solver path
    (``solver_impl='jnp', qp_impl='pallas'``), with K7's and K1's counts
    set to 0 just before and read just after: the record's supports
    (lambdas beside the record's, not gated: ROADMAP queue 3), one K7
    launch a row update, so ``kernel.launches.qp_sweeps`` = K7's count =
    sum over solves of sweeps x n_hat (each eval's n_hat from its
    ``solver.eval`` span, its sweeps from the ``solver.sweeps``
    histogram), and no K1 launch.  Returns the counts and the n_hat the
    fit launched K7 at."""
    from repro_torch.kernels import bcd_fused, bcd_sweep
    from repro_torch.obs import metrics, trace

    with metrics.use_registry() as reg, trace.enable() as tr:
        bcd_sweep.reset_launches()
        bcd_fused.reset_launches()
        t0 = time.perf_counter()
        results, diag = _fit_direct(corpus, "jnp", qp_impl="pallas")
        wall = time.perf_counter() - t0
        sizes = [int(sp.attrs["n_hat"]) for sp in tr.find("solver.eval")]
        sweeps = reg.histogram("solver.sweeps").window_samples()
        counts = {"qp_sweeps": bcd_sweep.launches,
                  "bcd_fused": bcd_fused.launches,
                  "kernel.launches.qp_sweeps":
                      reg.value("kernel.launches.qp_sweeps"),
                  "solver.fallbacks": reg.value("solver.fallbacks")}
    expected = sum(int(s) * n for s, n in zip(sweeps, sizes))
    emit("fit_per_row", seconds=wall, solve_launches=diag["solve_launches"],
         evals=len(sizes), n_hat=sizes, sweeps=[int(s) for s in sweeps],
         expected_qp_launches=expected, **counts,
         components=_vs_record(results, record["fit"]))
    check(_same_supports(results, record["fit"]),
          "per-row fit's supports differ from the record")
    check(len(sizes) == len(sweeps) == diag["solve_launches"] > 0,
          "one solve per eval")
    check(counts["qp_sweeps"] == counts["kernel.launches.qp_sweeps"]
          == expected > 0, "K7 launches != sum of sweeps x n_hat")
    check(counts["bcd_fused"] == 0, "the per-row fit launched K1")
    return counts, sorted(set(sizes))


def phase_per_row_profile(corpus):
    """The per-row fit of `phase_fit_per_row` again, under torch.profiler
    (device activity only): K7's device time summed over its launches,
    the device's busy share of the run's wall time, the largest device
    events.  Run last, after every `device_ms`: on the H100, the profiler
    sessions that followed this one (~10^5 device events) in the same
    process dropped records of their kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _fit_direct(corpus, "jnp", qp_impl="pallas")
        wall = time.perf_counter() - t0
    kernels = _device_events(prof)
    busy_ms = sum(k[0] for k in kernels)
    k7 = [k for k in kernels if "qp_sweep" in k[2]]
    emit("per_row_profile", seconds=wall, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / 1e3 / wall,
         k7_device_ms=sum(k[0] for k in k7),
         k7_launches=sum(k[1] for k in k7),
         top=[{"ms": ms, "count": c, "name": name}
              for ms, c, name in kernels[:6]])


def phase_dense_timing(corpus, dense, clock, qp_sizes):
    """K5, K6 and K7 at the path's shapes, ms per launch by CUDA events,
    beside the bound (the larger of bytes over 3.35 TB/s and operations
    over 67 TFLOP/s, float32 outside the tensor cores), the plain
    version's ms and the library call's: K5 at (256, 102,660) on the first
    block (105 MB, beyond L2: every launch reads HBM), library ``A.sum(0)``
    + ``(A * A).sum(0)``; K6 at (256, 500) on the first block's support
    columns and at (256, 2048), library ``A.T @ A`` with TF32 off, its
    operations those of the upper triangle C is mirrored from (m k (k + 1):
    a multiply and an add for each of k (k + 1) / 2 entries and m rows),
    its bound over the float32 rate of the tensor cores (3xTF32: 495 / 3
    TFLOP/s), the card's floor for a float32 Gram, which is also
    ``tc_bound_ms``, the bound of K6's own arithmetic; beside them
    ``cuda_core_bound_ms`` (those operations over 67 TFLOP/s), its launch
    plan, and both its and the library's device time alone
    (``device_ms``: the profiler's kernel time, no host gaps); K7 at every
    n in ``qp_sizes`` (the n_hat the per-row fit launched it at) and at 48
    and 192, on a dense row update (Y = Sigma_hat's top-n block with
    row/col 0 zeroed, 4 sweeps, float32), no library call, its bound
    `chain_bound`'s (the chain: 4 (n - 1) coordinate steps)."""
    import numpy as np
    import torch

    from repro_torch.kernels import bcd_sweep, gram, ref, variance

    dev = torch.device("cuda")
    first = dense["blocks"][0]
    rows = {}

    def row(name, ms, plain, lib, nbytes, ops, flops=H100_F32_FLOPS,
            steps=0, **kw):
        b = chain_bound(nbytes, ops, steps, clock, flops)
        r = {"name": name, "ms": ms, "plain_ms": plain, "library_ms": lib,
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             **({k: b[k] for k in ("bytes_bound_ms", "ops_bound_ms",
                                   "chain_steps", "chain_bound_ms")}
                if steps else {}),
             "bytes": nbytes, "ops": ops, **kw}
        emit("dense_timing", **r)
        return r

    A = torch.from_numpy(first).to(dev)
    m, n = A.shape
    rows["column_stats"] = row(
        "column_stats", cuda_ms(lambda: variance.column_stats_cuda(A), 20),
        cuda_ms(lambda: ref.column_stats_ref(A), 20),
        cuda_ms(lambda: (A.sum(0), (A * A).sum(0)), 20),
        m * n * 4 + 2 * n * 4, 3 * m * n, shape=[m, n],
        library="A.sum(0) + (A * A).sum(0)",
        device_ms=device_ms(lambda: variance.column_stats_cuda(A)),
        library_device_ms=device_ms(lambda: (A.sum(0), (A * A).sum(0))))
    del A
    order = np.argsort(-corpus.column_stats_exact()[1], kind="stable")
    for label, cols in (("gram", dense["support"]),
                        ("gram_2048", np.sort(order[:2048]))):
        B = torch.from_numpy(np.ascontiguousarray(first[:, cols])).to(dev)
        m, k = B.shape
        with ref.full_fp32():
            lib = cuda_ms(lambda: B.T @ B, 50)
            lib_dev = device_ms(lambda: B.T @ B)
        plan = gram.plan_gram(m, k)
        nbytes, ops = (m * k + k * k) * 4, m * k * (k + 1)
        tb = nbytes / H100_BYTES_PER_S * 1e3
        rows[label] = row(
            label, cuda_ms(lambda: gram.gram_cuda(B), 50),
            cuda_ms(lambda: ref.gram_ref(B), 50), lib,
            nbytes, ops, flops=H100_F32_TC_FLOPS, shape=[m, k],
            library="A.T @ A, TF32 off",
            device_ms=device_ms(lambda: gram.gram_cuda(B)),
            library_device_ms=lib_dev,
            tc_bound_ms=max(tb, ops / H100_F32_TC_FLOPS * 1e3),
            cuda_core_bound_ms=max(tb, ops / H100_F32_FLOPS * 1e3),
            plan={"tile": plan.tile, "split": plan.split,
                  "slab_rows": plan.slab_rows, "ctas": plan.blocks,
                  "smem_bytes": plan.smem_bytes})
    S = dense["S"]
    top = np.argsort(-np.diagonal(S), kind="stable")
    for n in sorted(set(qp_sizes) | {48, 192}):
        idx = np.sort(top[:n])
        Y = torch.tensor(S[np.ix_(idx, idx)], dtype=torch.float32, device=dev)
        s = Y[:, 0].clone()
        Y[0, :] = 0
        Y[:, 0] = 0
        s[0] = 0
        lam = 0.25 * float(s.abs().max())
        ms = cuda_ms(lambda: bcd_sweep.qp_sweep_cuda(Y, s, lam, s, 0, 4), 50)
        plain = cuda_ms(lambda: ref.qp_sweep_ref(Y, s, lam, s, 0, 4), 2)
        ops = 2 * n * n + 4 * (n - 1) * (2 * n + 10) + 2 * n
        rows[f"qp_sweeps_n{n}"] = row(
            f"qp_sweeps_n{n}", ms, plain, None, (n * n + 4 * n + 1) * 4, ops,
            steps=4 * (n - 1), n=n, sweeps=4, library=None, library_device_ms=None,
            scheme=bcd_sweep.plan_qp_sweep(n).scheme, device_ms=device_ms(
                lambda: bcd_sweep.qp_sweep_cuda(Y, s, lam, s, 0, 4)))
    return rows

# ---------------------------------------------------------------- streaming


def _stream_cfg(**kw):
    """The streaming launcher's configuration (its pass geometry at the
    defaults: chunk_nnz 16,384, chunk_rows 512, megabatch 8)."""
    from repro_torch.core import SPCAConfig

    return SPCAConfig(max_sweeps=8, lam_search_evals=8, **kw)


def _stream_fit(store_dir, cfg, *, traced=False):
    """``fit_components`` on a fresh handle of the 300k store (the
    launcher's path: the screen pass, one union-support Gram pass, the
    searches), its kernel counts set to 0 just before and read just
    after.  Returns (results, diagnostics, seconds, counts, spans)."""
    import contextlib

    import torch

    from repro_torch.core import fit_components
    from repro_torch.kernels import bcd_fused, csr_gram, csr_stats
    from repro_torch.obs import metrics, trace
    from repro_torch.sparse import SparseCorpus

    store = SparseCorpus.open(store_dir)
    diag = {}
    with metrics.use_registry() as reg, \
            (trace.enable() if traced else contextlib.nullcontext()) as tr:
        for k in (bcd_fused, csr_stats, csr_gram):
            k.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            results = fit_components(store, 5, target_card=5, cfg=cfg,
                                     diagnostics=diag)
        finally:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {"csr_stats": csr_stats.launches,
                      "csr_gram": csr_gram.launches,
                      "bcd_fused": bcd_fused.launches,
                      "fit.resume.checkpoints":
                          reg.value("fit.resume.checkpoints"),
                      "ingest.resume.checkpoints":
                          reg.value("ingest.resume.checkpoints")}
            spans = None
            if tr is not None:
                cps = tr.find("ingest.resume.checkpoint")
                spans = {"ingest.resume.checkpoint": len(cps),
                         "ingest.resume.checkpoint_s":
                             sum(sp.total_s for sp in cps),
                         "fit.checkpoint_s": sum(
                             sp.total_s for sp in tr.find("fit.checkpoint"))}
    return results, diag, wall, counts, spans


def _fit_key(results):
    return [(r.support.tolist(), r.lam, r.variance) for r in results]


def _ckpt_bytes(root):
    """Bytes of each checkpoint directory under a resume root (the newest
    checkpoint of each pass and of the fit)."""
    out = {}
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        out[name.rsplit("_", 1)[0]] = sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    return out


def _pass_state(root, kind):
    """The final accumulator state of a pass: its complete checkpoint."""
    import numpy as np

    (name,) = [n for n in os.listdir(root) if n.startswith(f"pass_{kind}_")]
    with np.load(os.path.join(root, name, "state.npz")) as z:
        return {k: z[k] for k in z.files}


def phase_resume_streaming(record, store_dir, support):
    """Kill-and-resume of the streaming fit on the 300k store (pass and
    fit checkpoints, fault injection, the pass watchdog) on the card:

    (a) the launcher's fit with ``resume_dir`` (16 megabatches between
        pass checkpoints), held to the streaming record's supports, its
        seconds beside the fit without checkpoints on the same clock (in
        turns, plain / checkpointed twice), the checkpoints, their bytes,
        and the time in ``ingest.resume.checkpoint`` spans (a traced run);
    (b) the fit killed by a read fault halfway into the Gram pass's reads
        (no retries), then run again: it resumes both passes
        (``resumed_megabatches`` > 0, fewer chunks than 2 x 3,658) through
        K3 (never the plain version) and gives (a)'s supports, lambdas and
        variances exactly;
    (c) the screen and Gram passes alone through ``sparse.engine``, killed
        and resumed, against uninterrupted passes: ``sum``, ``sumsq``,
        ``g`` and ``err`` with a max abs difference of 0;
    (d) the fit killed by a launch failure (K1's site ``bcd_solve``) on
        the second evaluation of the first component after the first that
        takes two (components 1-3 of this fit take one each: component
        4), then run again: the completed components restored, the
        evaluation skipped, 0 chunks re-streamed, (a)'s results exactly;
    (e) the fit under a pass deadline of half a screen pass: the watchdog
        raises ``PassDeadlineError`` mid-pass; run again without it, the
        fit resumes the pass and gives (a)'s results exactly."""
    import numpy as np
    import torch

    from repro_torch.obs.health import PassDeadlineError
    from repro_torch.sparse import SparseCorpus, engine
    from repro_torch.testing import (
        FaultInjector, InjectedDispatchError, SolverFaultInjector,
        dispatch_error, fail_nth_read, install, install_solver)

    smi = nvidia_smi()
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        # (a) clean runs, plain and checkpointed in turns, then one traced
        runs = []
        for turn in range(2):
            for ck in (False, True):
                rd = os.path.join(root, f"a{turn}") if ck else None
                res, diag, wall, counts, _ = _stream_fit(
                    store_dir, _stream_cfg(resume_dir=rd))
                runs.append({"checkpointed": ck, "seconds": wall,
                             "key": _fit_key(res), "diag": diag,
                             "counts": counts})
        clean = runs[1]
        res_a = clean["key"]
        res_t, _, wall_t, _, spans = _stream_fit(
            store_dir, _stream_cfg(resume_dir=os.path.join(root, "traced")),
            traced=True)
        plain_s = [r["seconds"] for r in runs if not r["checkpointed"]]
        ckpt_s = [r["seconds"] for r in runs if r["checkpointed"]]
        sizes = _ckpt_bytes(os.path.join(root, "a0"))
        ing = clean["diag"]["ingest"]
        per_pass = {k: ing[f"{k}_launches"] // 16 + 1
                    for k in ("screen", "gram")}
        rec = record["fit"]["components"]
        emit("resume_streaming", step="a_clean", nvidia_smi=smi,
             plain_s=plain_s, checkpointed_s=ckpt_s,
             traced_checkpointed_s=wall_t,
             pass_checkpoints=ing["resume_checkpoints"],
             checkpoints_per_pass=per_pass,
             fit_checkpoints=clean["counts"]["fit.resume.checkpoints"],
             checkpoint_bytes=sizes,
             pass_checkpoint_bytes_written=sum(
                 sizes[f"pass_{k}"] * n for k, n in per_pass.items()),
             spans=spans,
             components=[{"support_equal": k[0] == c["support"],
                          "lam": [k[1], c["lam"]], "variance": k[2]}
                         for k, c in zip(res_a, rec)],
             counts=clean["counts"])
        check(all(r["key"] == res_a for r in runs)
              and _fit_key(res_t) == res_a,
              "the checkpointed and plain fits differ")
        check([k[0] for k in res_a] == [c["support"] for c in rec],
              "the checkpointed fit's supports differ from the record")
        check(ing["resume_checkpoints"] == sum(per_pass.values()),
              "pass checkpoints != one every 16 megabatches + 1 complete")

        # (b) kill halfway into the Gram pass's reads, then resume
        probe = FaultInjector()
        with install(probe):
            engine.sparse_feature_variances(SparseCorpus.open(store_dir),
                                            device=dev)
        kill_at = probe.reads + probe.reads // 2
        rd = os.path.join(root, "b")
        cfg_b = _stream_cfg(resume_dir=rd, io_retries=0)
        kill = FaultInjector(fail_nth_read(kill_at, match="*.npy",
                                           times=10**9))
        killed = None
        try:
            with install(kill):
                _stream_fit(store_dir, cfg_b)
        except OSError as e:
            killed = f"{type(e).__name__}: {e}"
        res_b, diag_b, wall_b, counts_b, _ = _stream_fit(store_dir, cfg_b)
        ing_b = diag_b["ingest"]
        emit("resume_streaming", step="b_kill_mid_gram", nvidia_smi=smi,
             kill_at_read=kill_at, screen_pass_reads=probe.reads,
             killed=killed, resumed_seconds=wall_b,
             resumed_megabatches=diag_b["resumed_megabatches"],
             chunks=ing_b.get("chunks", 0),
             clean_chunks=clean["diag"]["ingest"]["chunks"],
             counts=counts_b, same_as_clean=_fit_key(res_b) == res_a)
        check(killed is not None and "injected" in killed,
              "the read fault did not kill the fit")
        check(diag_b["resumed_megabatches"] > 0
              and 0 < ing_b.get("chunks", 0)
              < clean["diag"]["ingest"]["chunks"],
              "the resumed fit re-streamed everything or nothing")
        check(counts_b["csr_gram"] == ing_b["gram_launches"] > 0
              and counts_b["csr_stats"] == ing_b.get("screen_launches", 0),
              "the resumed passes did not run on K2/K3")
        check(_fit_key(res_b) == res_a,
              "the resumed fit differs from the clean card run")

        # (c) the passes alone: killed + resumed vs uninterrupted, bit for bit
        t0 = time.perf_counter()
        scr = engine.sparse_feature_variances(
            SparseCorpus.open(store_dir), device=dev,
            resume_dir=os.path.join(root, "c0"))
        torch.cuda.synchronize()
        screen_s = time.perf_counter() - t0
        means = scr.means.cpu().numpy()
        engine.sparse_reduced_covariance(
            SparseCorpus.open(store_dir), support, means=means, device=dev,
            resume_dir=os.path.join(root, "c0"))
        diffs = {}
        resumed = {}
        for kind in ("screen", "gram"):
            def run(**kw):
                st = SparseCorpus.open(store_dir)
                if kind == "screen":
                    return engine.sparse_feature_variances(st, device=dev,
                                                           **kw)
                return engine.sparse_reduced_covariance(
                    st, support, means=means, device=dev, **kw)
            probe = FaultInjector()
            with install(probe):
                run()
            ctr = {}
            rd = os.path.join(root, "c1")
            try:
                with install(FaultInjector(fail_nth_read(
                        probe.reads // 2, match="*.npy", times=10**9))):
                    run(resume_dir=rd, io_retries=0)
                check(False, f"the {kind} pass was not killed")
            except OSError:
                pass
            run(resume_dir=rd, counters=ctr)
            resumed[kind] = ctr["resumed_megabatches"]
            want = _pass_state(os.path.join(root, "c0"), kind)
            got = _pass_state(rd, kind)
            for k in want:
                if k == "count":
                    check(int(got[k]) == int(want[k]), f"{kind} count")
                    continue
                diffs[k] = float(np.max(np.abs(
                    got[k].astype(np.float64) - want[k].astype(np.float64))))
        emit("resume_streaming", step="c_passes_bit_for_bit",
             nvidia_smi=smi, max_abs_diff=diffs,
             resumed_megabatches=resumed, screen_pass_s=screen_s)
        check(set(diffs) == {"sum", "sumsq", "g", "err"}
              and all(v == 0.0 for v in diffs.values())
              and all(v > 0 for v in resumed.values()),
              "a resumed pass differs from the uninterrupted one")

        # (d) kill on the second evaluation of the first component after
        # the first that takes two or more (K1's site; each evaluation is
        # one ``bcd_solve`` call on the card, its fallback re-solve none)
        evals = [c["evals"] for c in clean["diag"]["components"]]
        k = next((i for i, e in enumerate(evals) if i and e >= 2), None)
        check(k is not None, "no component after the first took 2 evals")
        rd = os.path.join(root, "d")
        inj = SolverFaultInjector(dispatch_error(n=sum(evals[:k]) + 1,
                                                 match="bcd_solve"))
        killed = None
        try:
            with install_solver(inj):
                _stream_fit(store_dir, _stream_cfg(resume_dir=rd))
        except InjectedDispatchError as e:
            killed = str(e)
        res_d, diag_d, wall_d, counts_d, _ = _stream_fit(
            store_dir, _stream_cfg(resume_dir=rd))
        fr = diag_d["fit_resume"]
        emit("resume_streaming", step="d_kill_mid_search", nvidia_smi=smi,
             killed=killed, component=k + 1, evals=evals, fit_resume=fr,
             resumed_seconds=wall_d,
             chunks=diag_d["ingest"].get("chunks", 0),
             resumed_megabatches=diag_d["resumed_megabatches"],
             counts=counts_d, same_as_clean=_fit_key(res_d) == res_a)
        check(killed is not None and inj.injected["dispatch"] == 1,
              "the launch failure did not kill the fit")
        check(fr["components_restored"] == k and fr["evals_skipped"] >= 1,
              "the search did not resume from its checkpoint")
        check(diag_d["ingest"].get("chunks", 0) == 0,
              "the search resume re-streamed the corpus")
        check(counts_d["bcd_fused"] > 0, "the resumed search did not run K1")
        check(_fit_key(res_d) == res_a,
              "the search-resumed fit differs from the clean card run")

        # (e) the pass watchdog at half a screen pass
        rd = os.path.join(root, "e")
        deadline = screen_s / 2
        expired = None
        try:
            _stream_fit(store_dir, _stream_cfg(resume_dir=rd,
                                               pass_deadline_s=deadline))
        except PassDeadlineError as e:
            expired = {"what": e.what, "budget_s": e.budget_s,
                       "elapsed_s": e.elapsed_s}
        res_e, diag_e, wall_e, counts_e, _ = _stream_fit(
            store_dir, _stream_cfg(resume_dir=rd))
        emit("resume_streaming", step="e_pass_deadline", nvidia_smi=smi,
             deadline_s=deadline, expired=expired, resumed_seconds=wall_e,
             resumed_megabatches=diag_e["resumed_megabatches"],
             chunks=diag_e["ingest"].get("chunks", 0), counts=counts_e,
             same_as_clean=_fit_key(res_e) == res_a)
        check(expired is not None, "the pass deadline did not expire")
        check(diag_e["resumed_megabatches"] > 0,
              "the expired pass did not resume from a checkpoint")
        check(_fit_key(res_e) == res_a,
              "the deadline-resumed fit differs from the clean card run")
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)


def phase_export(served):
    """The serving launcher at ``SERVE_ARGS`` with ``--export-port 0``:
    ``/metrics``, ``/healthz`` and ``/varz`` scraped on 127.0.0.1 from a
    thread while it serves and once more just before the exporter stops;
    K4's count on ``/metrics`` = the run's K4 launches (batches + 2);
    ``/healthz`` 200 with the serving rules quiet (no p99, shed or
    timeout rule firing; the solver pack's stall-burst warning may: the
    fit's fused solves stall and are re-solved); docs/s and p99 beside the
    `serve` phase's (no exporter)."""
    import re
    import threading
    import urllib.error
    import urllib.request

    from repro_torch.kernels import project
    from repro_torch.launch import serve_topics
    from repro_torch.obs import metrics

    def scrape(port):
        row = {}
        for path in ("/metrics", "/healthz", "/varz"):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                    row[path] = (r.status, r.read().decode())
            except urllib.error.HTTPError as e:
                row[path] = (e.code, e.read().decode())
        return row

    rows, final, stop = [], {}, threading.Event()

    def hook(exp):
        def loop():
            while not stop.is_set():
                rows.append(scrape(exp.port))
                stop.wait(0.25)

        t = threading.Thread(target=loop, daemon=True)
        orig_stop = exp.stop

        def stop_after_a_last_scrape():
            stop.set()
            t.join(timeout=60)
            final.update(scrape(exp.port))
            orig_stop()

        exp.stop = stop_after_a_last_scrape
        t.start()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_registry_") as root, \
            metrics.use_registry():
        project.reset_launches()
        out = serve_topics.main(
            SERVE_ARGS + ["--registry", root, "--export-port", "0",
                          "--export-interval", "0.5"], on_exporter=hook)
        launches = project.launches
    m = re.search(r"^kernel_launches_sparse_project_total (\d+)$",
                  final["/metrics"][1], re.M)
    scraped = int(m.group(1)) if m else None
    quiet = {"serve_p99_latency", "serve_shed_burst", "serve_timeout_burst"}
    fired = set()
    for r in rows:
        fired |= {f["rule"] for f in json.loads(r["/healthz"][1])["firing"]}
    serving = [json.loads(r["/healthz"][1])["status"] for r in rows]
    batches = sum(out["batches"])
    emit("export", nvidia_smi=nvidia_smi(), scrapes=len(rows),
         healthz_codes=sorted({r["/healthz"][0] for r in rows}),
         healthz_status_while_serving=sorted(set(serving)),
         rules_fired_while_serving=sorted(fired),
         final_healthz=[final["/healthz"][0],
                        json.loads(final["/healthz"][1])["status"]],
         metrics_bytes=len(final["/metrics"][1]),
         varz_keys=sorted(json.loads(final["/varz"][1])),
         k4_on_metrics=scraped, project_launches=launches,
         batches=out["batches"], warmups=out["warmups"],
         docs_per_s=out["served"] / out["serve_s"],
         docs_per_s_without_exporter=served["served"] / served["serve_s"],
         p99_ms=out["latency"]["p99_ms"],
         p99_ms_without_exporter=served["latency"]["p99_ms"])
    check(rows and all(r[p][0] == 200 for r in rows for p in r),
          "an endpoint did not answer 200 while serving")
    check(not fired & quiet and set(serving) <= {"ok", "degraded"},
          "a serving rule fired while serving")
    check(final["/healthz"][0] == 200, "/healthz did not answer 200")
    check(scraped == launches == batches + out["warmups"] > 0,
          "K4's count on /metrics != project_launches != batches + 2")


def _rel_err(got, want):
    """max |got - want| over max |want|, both moved to float64."""
    import torch

    got, want = (torch.as_tensor(x).double().cpu() for x in (got, want))
    if not want.numel():
        return 0.0
    scale = max(float(want.abs().max()), 1e-300)
    return float((got - want).abs().max()) / scale


def phase_fit_streaming(record, store_dir):
    """The out-of-core fit through the launcher (``--streaming``) at
    300,000 docs, with every kernel count set to 0 just before and read
    just after; held to the streaming record: identical supports, 2
    corpus passes, the record's screen and Gram launches, each one K2 or
    K3 launch."""
    from repro_torch.kernels import bcd_fused, csr_gram, csr_stats
    from repro_torch.launch import spca_run
    from repro_torch.obs import metrics

    with metrics.use_registry() as reg:
        for k in (bcd_fused, csr_stats, csr_gram):
            k.reset_launches()
        t0 = time.perf_counter()
        corpus, results, diag = spca_run.main(STREAM_ARGS + ["--store-dir",
                                                             store_dir])
        wall = time.perf_counter() - t0
        counts = {
            "csr_stats": csr_stats.launches, "csr_gram": csr_gram.launches,
            "bcd_fused": bcd_fused.launches,
            **{f"kernel.launches.{op}": reg.value(f"kernel.launches.{op}")
               for op in ("csr_column_stats", "csr_gram_batched",
                          "bcd_solve", "bcd_solve_batched")},
            "ingest.prefetch.consumer_stall_s":
                reg.value("ingest.prefetch.consumer_stall_s"),
            "ingest.prefetch.producer_stall_s":
                reg.value("ingest.prefetch.producer_stall_s"),
        }
    ing, rec = diag["ingest"], record["ingest"]
    emit("fit_streaming", seconds=wall, pcs=_pc_lines(corpus, results),
         components=_vs_record(results, record["fit"]),
         corpus_passes=diag["corpus_passes"], ingest=ing,
         record_ingest=rec, solve_launches=diag["solve_launches"],
         solver_fallbacks=diag.get("solver_fallbacks", 0), **counts)
    check(_same_supports(results, record["fit"]),
          "streaming fit's supports differ from the streaming record")
    check(diag["corpus_passes"] == 2 == rec["corpus_passes"],
          "streaming fit did not take 2 corpus passes")
    check(ing["screen_launches"] == rec["screen_launches"]
          and ing["gram_launches"] == rec["gram_launches"]
          and ing["chunks"] == rec["chunks"],
          "streaming fit's ingest launches differ from the record's")
    check(counts["kernel.launches.csr_column_stats"] == ing["screen_launches"]
          == counts["csr_stats"],
          "screen megabatches != K2 launches")
    check(counts["kernel.launches.csr_gram_batched"] == ing["gram_launches"]
          == counts["csr_gram"],
          "Gram megabatches != K3 launches")
    check(counts["bcd_fused"] >= diag["solve_launches"] > 0,
          "the streaming fit's solves did not launch K1")
    return corpus, counts


def _batches(store):
    """The first and the ragged final megabatch of a pass, copied out."""
    import numpy as np

    first = last = None
    for mb in store.iter_megabatches(reuse_buffers=False):
        if first is None:
            first = mb
        last = mb
    check(last.n_chunks < len(last.nnz), "the final megabatch is not ragged")
    return {"first": first, "last": last,
            "chunks": [int(first.n_chunks), int(last.n_chunks)],
            "empty_slots": int(np.sum(last.n_rows == 0))}


def _csr_supports(v, cfg):
    """The fit's union support (the one Gram pass's, from the launcher's
    config) and the top-500 / top-2048 variance supports."""
    import numpy as np

    from repro_torch.core import spca

    order = np.argsort(-v, kind="stable")
    return {"union": spca._union_base_support(v, 5, 5, cfg),
            "top500": np.sort(order[:500]), "top2048": np.sort(order[:2048])}


def _csr_edge_cases():
    """Synthetic megabatches at the gather-Gram kernel's edges: (label,
    values, local_cols, seg_ids, R, n_hat), rows unsorted, columns past
    n_hat (off-support) and value-0 padding included."""
    import numpy as np

    rng = np.random.default_rng(15)
    out = []
    for label, C, E, R, n_hat, nnz in (
            ("r908_slabs8", 2, 4096, 908, 97, [4096, 1500]),
            ("e1001_empty_chunk", 3, 1001, 64, 70, [1001, 0, 3]),
            ("c20", 20, 256, 16, 65, [256] * 19 + [9])):
        vals = np.zeros((C, E), np.float32)
        cols = np.zeros((C, E), np.int32)
        segs = np.zeros((C, E), np.int32)
        for c, k in enumerate(nnz):
            cells = rng.choice(R * (n_hat + 25), size=k, replace=False)
            vals[c, :k] = rng.normal(size=k)
            segs[c, :k], cols[c, :k] = np.divmod(cells, n_hat + 25)
        out.append((label, vals, cols, segs, R, n_hat))
    # bag-of-words counts with duplicate cells (each summed cell well
    # under 2048: the split is exact, so the kernel is too)
    C, E, R, n_hat = 8, 4096, 512, 220
    vals = rng.choice([1, 1, 1, 2, 3, 7, 40], size=(C, E)).astype(np.float32)
    segs = rng.integers(0, R, size=(C, E)).astype(np.int32)
    cols = rng.integers(0, n_hat + 25, size=(C, E)).astype(np.int32)
    dup = rng.random((C, E)) < 0.3
    src = rng.integers(0, np.arange(E) + 1, size=(C, E))
    for c in range(C):
        segs[c, dup[c]] = segs[c, src[c, dup[c]]]
        cols[c, dup[c]] = cols[c, src[c, dup[c]]]
    out.append(("duplicate_counts", vals, cols, segs, R, n_hat))
    return out


def phase_csr_kernel_parity(store, supports):
    """K2 and K3 against their plain versions on the card, on the first
    and the ragged final megabatch of the 300k store: K2 to 1e-6 of the
    largest |sum|, K3 to 1e-6 of the largest |G|, at the fit's union
    support and the top-500 / top-2048 variance supports, and one C = 1
    ``ops.csr_gram`` call; K3 also on `_csr_edge_cases`, symmetric.  Each
    kernel also runs twice on the same megabatch; the run-to-run max
    |diff| is printed."""
    import torch

    from repro_torch.data.bow import local_support_cols
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    mbs = _batches(store)
    worst = {"csr_stats": 0.0, "csr_gram": 0.0}
    rerun = {"csr_stats": 0.0, "csr_gram": 0.0}
    n = store.n_cols
    for label in ("first", "last"):
        mb = mbs[label]
        v, c, sg = (torch.from_numpy(a).to(dev) for a in
                    (mb.values, mb.col_ids, mb.seg_ids))
        got = ops.csr_column_stats(v, c, n=n, impl="cuda")
        again = ops.csr_column_stats(v, c, n=n, impl="cuda")
        want = ops.csr_column_stats(v, c, n=n, impl="ref")
        errs = [_rel_err(g, w) for g, w in zip(got, want)]
        diff = max(float((a - b).abs().max()) for a, b in zip(got, again))
        emit("csr_kernel_parity", kernel="csr_stats", batch=label,
             chunks=int(mb.n_chunks), n=n, rel_err=errs,
             max_abs_err=max(float((g - w).abs().max())
                             for g, w in zip(got, want)),
             run_to_run_max_abs_diff=diff, tolerance="1e-6 of max |sum|",
             ok=max(errs) <= 1e-6)
        check(max(errs) <= 1e-6, f"csr_stats parity on the {label} batch")
        worst["csr_stats"] = max(worst["csr_stats"], max(
            float((g - w).abs().max()) for g, w in zip(got, want)))
        rerun["csr_stats"] = max(rerun["csr_stats"], diff)
        for name, sup in supports.items():
            loc = torch.from_numpy(local_support_cols(sup, mb.col_ids)).to(dev)
            kw = dict(n_rows=CHUNK_ROWS, n_hat=int(sup.size))
            G = ops.csr_gram_batched(v, loc, sg, impl="cuda", **kw)
            G2 = ops.csr_gram_batched(v, loc, sg, impl="cuda", **kw)
            Gr = ops.csr_gram_batched(v, loc, sg, impl="ref", **kw)
            err = _rel_err(G, Gr)
            diff = float((G - G2).abs().max())
            abs_err = float((G - Gr).abs().max())
            emit("csr_kernel_parity", kernel="csr_gram", batch=label,
                 support=name, n_hat=int(sup.size), rel_err=err,
                 max_abs_err=abs_err, max_abs_G=float(Gr.abs().max()),
                 run_to_run_max_abs_diff=diff, symmetric=bool(
                     torch.equal(G, G.T)),
                 tolerance="1e-6 of max |G|", ok=err <= 1e-6)
            check(err <= 1e-6, f"csr_gram parity {label} {name}")
            worst["csr_gram"] = max(worst["csr_gram"], abs_err)
            rerun["csr_gram"] = max(rerun["csr_gram"], diff)
            if label == "first" and name == "union":
                # the single-chunk op (TPU kernel _kernel) at C = 1
                one = ops.csr_gram(v[0], loc[0], sg[0], impl="cuda", **kw)
                one_r = ops.csr_gram(v[0], loc[0], sg[0], impl="ref", **kw)
                err1 = _rel_err(one, one_r)
                emit("csr_kernel_parity", kernel="csr_gram", batch=label,
                     support=name, C=1, n_hat=int(sup.size), rel_err=err1,
                     max_abs_err=float((one - one_r).abs().max()),
                     tolerance="1e-6 of max |G|", ok=err1 <= 1e-6)
                check(err1 <= 1e-6, "csr_gram C=1 parity")
                worst["csr_gram"] = max(worst["csr_gram"],
                                        float((one - one_r).abs().max()))
    # the design's edges, on synthetic megabatches: the PR 12 kernel's row
    # cap (8 row slabs), E % 4 != 0 (4-byte copies) with a chunk of no
    # real entry, 20 chunks (3 a CTA), duplicate (row, col) counts; rows
    # unsorted, n_hat not a multiple of the 128-wide tile
    for label, vals, cols, segs, R, n_hat in _csr_edge_cases():
        v, loc, sg = (torch.from_numpy(a).to(dev) for a in (vals, cols, segs))
        kw = dict(n_rows=R, n_hat=n_hat)
        G = ops.csr_gram_batched(v, loc, sg, impl="cuda", **kw)
        G2 = ops.csr_gram_batched(v, loc, sg, impl="cuda", **kw)
        Gr = ops.csr_gram_batched(v, loc, sg, impl="ref", **kw)
        err, diff = _rel_err(G, Gr), float((G - G2).abs().max())
        abs_err = float((G - Gr).abs().max())
        ok = err <= 1e-6 and bool(torch.equal(G, G.T))
        emit("csr_kernel_parity", kernel="csr_gram", batch=label,
             shape=list(vals.shape), R=R, n_hat=n_hat, rel_err=err,
             max_abs_err=abs_err, max_abs_G=float(Gr.abs().max()),
             run_to_run_max_abs_diff=diff, symmetric=bool(
                 torch.equal(G, G.T)),
             tolerance="1e-6 of max |G|", ok=ok)
        check(ok, f"csr_gram parity {label}")
        worst["csr_gram"] = max(worst["csr_gram"], abs_err)
        rerun["csr_gram"] = max(rerun["csr_gram"], diff)
    emit("csr_kernel_parity", summary=True, batches=mbs["chunks"],
         empty_slots_in_final=mbs["empty_slots"], max_abs_err=worst,
         run_to_run_max_abs_diff=rerun)
    return worst, rerun, mbs["first"]


def phase_ingest_passes(corpus, store, support, exact):
    """The screen pass and the union-support Gram pass over the whole 300k
    store through K2 and K3, held to exact float64 statistics of the
    corpus (``column_stats_exact``; ``columns_dense`` and a float64
    product).  Tolerance, derived: each per-megabatch float32 sum rounds
    by at most 2^-24 of the sum of its terms' magnitudes (it is exact
    here, the counts being integers below 2^24); the float64 (or
    compensated float32) fold adds ~nothing; the centring cancels, so
    the error relative to the largest result grows by ``cancel`` =
    max second moment / max |result|: tolerance = 4 * 2^-24 * cancel.
    Both the float64 accumulation and the launcher's float32 (x64 off
    in the reference) are held.  Then the pass seconds (no profiler),
    the device's idle share over each pass (torch.profiler), and the
    host's own work per pass: reading and padding the megabatches, and
    mapping their columns onto the support."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.bow import local_support_cols
    from repro_torch.sparse import engine

    dev = torch.device("cuda")
    m = corpus.n_docs
    mean_x, var_x = exact
    A = torch.from_numpy(corpus.columns_dense(support)).to(dev).double()
    second = (A.T @ A) / m
    A -= A.mean(0)
    S_x = (A.T @ A) / m
    del A
    sec2 = np.bincount(corpus.word_idx, minlength=corpus.n_words,
                       weights=corpus.counts.astype(np.float64) ** 2)
    cancel_v = float(sec2.max() / m / var_x.max())
    cancel_S = float(second.abs().max() / S_x.abs().max())
    out = {}
    for acc in (torch.float64, torch.float32):
        name = str(acc).split(".")[-1]
        ctr = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scr = engine.sparse_feature_variances(store, counters=ctr,
                                              acc_dtype=acc, device=dev)
        torch.cuda.synchronize()
        t_screen = time.perf_counter() - t0
        means = scr.means.cpu().numpy()
        t0 = time.perf_counter()
        S = engine.sparse_reduced_covariance(store, support, means=means,
                                             counters=ctr, acc_dtype=acc,
                                             device=dev)
        torch.cuda.synchronize()
        t_gram = time.perf_counter() - t0
        e_var = _rel_err(scr.variances, var_x)
        e_mean = _rel_err(scr.means, mean_x)
        e_S = _rel_err(S, S_x)
        tol_v, tol_S = 4 * 2.0 ** -24 * cancel_v, 4 * 2.0 ** -24 * cancel_S
        ok = e_var <= tol_v and e_mean <= tol_v and e_S <= tol_S
        emit("ingest_passes", acc_dtype=name, screen_s=t_screen,
             gram_s=t_gram, n_hat=int(support.size),
             screen_megabatches=ctr["screen_launches"],
             gram_megabatches=ctr["gram_launches"], chunks=ctr["chunks"],
             prefetch_consumer_stall_s=ctr.get("prefetch_consumer_stall_s"),
             prefetch_producer_stall_s=ctr.get("prefetch_producer_stall_s"),
             rel_err_var=e_var, rel_err_mean=e_mean, rel_err_sigma=e_S,
             tolerance_var=tol_v, tolerance_sigma=tol_S, ok=ok)
        check(ok, f"ingest passes ({name}) disagree with the exact statistics")
        check(ctr["screen_launches"] == ctr["gram_launches"]
              == -(-store.n_chunks() // MEGABATCH),
              "one launch per megabatch")
        out[name] = {"screen_s": t_screen, "gram_s": t_gram}
    # the device's idle share over each pass (launcher's float32)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for kind in ("screen", "gram"):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if kind == "screen":
                engine.sparse_feature_variances(store, device=dev)
            else:
                engine.sparse_reduced_covariance(store, support,
                                                 means=mean_x, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(k[0] for k in _device_events(prof))
        out[f"{kind}_profiled_s"] = wall
        out[f"{kind}_device_busy_ms"] = busy
        out[f"{kind}_idle_share"] = 1 - busy / 1e3 / wall
    # host work alone: read + pad every megabatch; map columns to support
    t0 = time.perf_counter()
    n_mb = 0
    map_s = 0.0
    for mb in store.iter_megabatches():
        t1 = time.perf_counter()
        local_support_cols(support, mb.col_ids)
        map_s += time.perf_counter() - t1
        n_mb += 1
    out["host_read_pad_s"] = time.perf_counter() - t0 - map_s
    out["host_support_map_s"] = map_s
    out["megabatches"] = n_mb
    emit("ingest_passes", where_the_time_goes=out)
    return out


def _gram_timing(name, v, loc, sg, R, n_hat):
    """K3 at (C, E) = v.shape: ms, plain ms, the library's contraction of
    the already densified B (TF32 off), the bound from this data (its
    operations over the float32 rate of the tensor cores, 3xTF32: 495 / 3
    TFLOP/s, the card's floor for them), and beside it
    ``cuda_core_bound_ms`` (the operations over 67 TFLOP/s),
    ``tc_bound_ms``, the bound of the kernel's own 3xTF32 contraction of
    each chunk's occupied rows (3 sum_c R_occ,c n_hat (n_hat + 1)
    operations over 495 TFLOP/s, or the bytes), its launch plan, and both
    its and the library's device time alone (``device_ms``)."""
    import numpy as np
    import torch

    from repro_torch.kernels import csr_gram, ref

    C, E = v.shape
    one = C == 1
    args = (v[0], loc[0], sg[0]) if one else (v, loc, sg)
    plain_fn = ref.csr_gram_ref if one else ref.csr_gram_batched_ref
    ms = cuda_ms(lambda: csr_gram.csr_gram_cuda(*args, R, n_hat), 50)
    dev_ms = device_ms(lambda: csr_gram.csr_gram_cuda(*args, R, n_hat))
    plain = cuda_ms(lambda: plain_fn(*args, R, n_hat), 10)
    rows = (sg.long() + R * torch.arange(C, device=v.device)[:, None]
            ).reshape(-1)
    on = (loc.reshape(-1) < n_hat) & (v.reshape(-1) != 0)
    B = torch.zeros((C * R, n_hat), device=v.device)
    B.index_put_((rows[on], loc.reshape(-1)[on].long()), v.reshape(-1)[on],
                 accumulate=True)
    with ref.full_fp32():
        lib = cuda_ms(lambda: torch.matmul(B.T, B), 50)
        lib_dev = device_ms(lambda: torch.matmul(B.T, B))
    k_r = torch.bincount(rows[on], minlength=C * R).cpu().numpy()[:C * R]
    nbytes = 3 * C * E * 4 + n_hat * n_hat * 4
    ops = int(2 * np.sum(k_r.astype(np.int64) ** 2))
    dense_ops = 2 * C * R * n_hat * n_hat
    # the kernel's own arithmetic: 3 TF32 products a term over each
    # chunk's occupied rows (one past its highest row with an entry)
    occupied = (k_r.reshape(C, R) > 0)
    r_occ = np.where(occupied.any(1), R - np.argmax(occupied[:, ::-1], 1), 0)
    tc_ops = 3 * int(r_occ.sum()) * n_hat * (n_hat + 1)
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_TC_FLOPS * 1e3
    plan = csr_gram.plan_csr_gram(n_hat, R, C)
    return {"name": name, "C": C, "ms": ms, "plain_ms": plain,
            "library_ms": lib,
            "library": "torch.matmul(B.T, B), TF32 off: contraction only",
            "device_ms": dev_ms, "library_device_ms": lib_dev,
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "cuda_core_bound_ms": max(tb, ops / H100_F32_FLOPS * 1e3),
            "tc_bound_ms": max(tb, tc_ops / H100_TF32_FLOPS * 1e3),
            "bytes": nbytes, "ops": ops, "tc_ops": tc_ops,
            "occupied_rows": [int(x) for x in r_occ],
            "dense_contraction_ops": dense_ops,
            "dense_bound_ms": max(tb, dense_ops / H100_F32_FLOPS * 1e3),
            "plan": {"tile": plan.tile, "slabs": plan.slabs,
                     "groups": plan.groups,
                     "chunks_per_group": plan.chunks_per_group,
                     "ctas": plan.blocks, "smem_bytes": plan.smem_bytes},
            "n_hat": n_hat}


def phase_csr_timing(store, support, mb):
    """K2 and K3 at the streaming fit's shape (C = 8, E = 16,384, n =
    102,660; K3 at the union support, and at C = 1 on the batch's first
    chunk), on the first megabatch: ms per launch (CUDA events, 50
    launches), the plain version's ms, the library call's ms (K2: two
    ``index_add_``; K3: ``torch.matmul`` of the already densified B,
    TF32 off, the contraction only) and the bound: the larger of bytes
    over 3.35 TB/s and operations over 67 TFLOP/s (K3's over 495 / 3
    TFLOP/s, float32 products on the tensor cores), counted from this
    batch's data (real entries; K3 the sparse product's multiply-adds,
    2 sum_r k_r^2 with k_r the row's on-support entries)."""
    import numpy as np
    import torch

    from repro_torch.data.bow import local_support_cols
    from repro_torch.kernels import csr_stats, ref

    dev = torch.device("cuda")
    C, E = mb.values.shape
    n, R, n_hat = store.n_cols, CHUNK_ROWS, int(support.size)
    v, c, sg = (torch.from_numpy(a).to(dev) for a in
                (mb.values, mb.col_ids, mb.seg_ids))
    loc_np = local_support_cols(support, mb.col_ids)
    loc = torch.from_numpy(loc_np).to(dev)
    real = int(np.sum(mb.nnz))
    rows = []
    # K2
    ms = cuda_ms(lambda: csr_stats.csr_column_stats_cuda(v, c, n), 50)
    plain = cuda_ms(lambda: ref.csr_column_stats_batched_ref(v, c, n), 10)
    c64, vf = c.reshape(-1).long(), v.reshape(-1)

    def library():
        torch.zeros(n, device=dev).index_add_(0, c64, vf)
        torch.zeros(n, device=dev).index_add_(0, c64, vf * vf)
    lib = cuda_ms(library, 50)
    dev_ms = device_ms(lambda: csr_stats.csr_column_stats_cuda(v, c, n))
    lib_dev = device_ms(library)
    nbytes, ops = C * E * 8 + 2 * n * 4, 3 * real
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
    rows.append({"name": "csr_stats", "ms": ms, "plain_ms": plain,
                 "library_ms": lib, "library": "2 x index_add_ (float32)",
                 "device_ms": dev_ms, "library_device_ms": lib_dev,
                 "bound_ms": max(tb, to),
                 "bound_by": "bytes" if tb >= to else "operations",
                 "bytes": nbytes, "ops": ops, "real_entries": real})
    # K3 on the megabatch (TPU kernel _batched_kernel) and on its first
    # chunk alone (C = 1: TPU kernel _kernel)
    rows.append(_gram_timing("csr_gram", v, loc, sg, R, n_hat))
    rows.append(_gram_timing("csr_gram_c1", v[:1], loc[:1], sg[:1], R,
                             n_hat))
    for row in rows:
        emit("timing", **{"C": C, "E": E, "n": n, "R": R, **row})
    return {r["name"]: r for r in rows}

# ---------------------------------------------------------------- serving


def _dense_rows(docs, rows, n):
    """The first ``rows`` (word_ids, counts) documents as a dense (rows, n)
    float32 batch, scattered as the microbatcher does."""
    import numpy as np

    X = np.zeros((rows, n), np.float32)
    for r, (wi, ct) in zip(range(rows), docs):
        np.add.at(X[r], wi, ct)
    return X


def phase_serve(record):
    """The serving launcher at NYTimes width on the card, with K4's count
    and the registry set to 0 just before and read just after: the
    record's supports (lambdas beside it), the record's registry manifest,
    ``kernel.launches.sparse_project`` = K4's own count = batches served +
    the two warm-ups, one input shape (``trace_count == 1``), drift quiet
    in distribution and firing on the shifted stream, and the record's
    first 64 queries rebuilt (same nnz and count total)."""
    import numpy as np

    from repro_torch.kernels import project
    from repro_torch.launch import serve_topics
    from repro_torch.obs import metrics

    with tempfile.TemporaryDirectory(prefix="chip_smoke_registry_") as root, \
            metrics.use_registry() as reg:
        project.reset_launches()
        t0 = time.perf_counter()
        out = serve_topics.main(SERVE_ARGS + ["--registry", root])
        wall = time.perf_counter() - t0
        launches = project.launches
        dispatches = reg.value("kernel.launches.sparse_project")
        with open(os.path.join(root, "step_000000000", "manifest.json")) as f:
            manifest = f.read()
    results, mv, q = out["results"], out["version"], out["queries"]
    rec = record
    X64 = _dense_rows(serve_topics.iter_docs(q), 64, q.n_words)
    fq = rec["first_queries"]
    same_batch = (np.count_nonzero(X64, axis=1).tolist() == fq["doc_nnz"]
                  and float(X64.sum(dtype=np.float64)) == fq["count_total"])
    rep, rep2 = out["drift"], out["drift_shifted"]

    def report(r):
        return {"triggered": bool(r.triggered), "n_offending": r.n_offending,
                "offending": r.offending[:8].tolist(),
                "max_ratio": r.max_ratio, "docs_seen": r.docs_seen}

    batches = sum(out["batches"])
    emit("serve", seconds=wall, fit_s=out["fit_s"], serve_s=out["serve_s"],
         docs_per_s=out["served"] / out["serve_s"],
         p50_ms=out["latency"]["p50_ms"], p99_ms=out["latency"]["p99_ms"],
         served=out["served"], batches=out["batches"],
         warmups=out["warmups"], project_launches=launches,
         **{"kernel.launches.sparse_project": dispatches},
         trace_count=out["trace_count"],
         histogram=out["histogram"].tolist(),
         record_histogram=rec["serve"]["histogram"],
         components=_vs_record(results, rec["fit"]),
         pack={"k": mv.pack.k, "cap": mv.pack.cap, "nnz": mv.pack.nnz},
         record_pack={k: rec["pack"][k] for k in ("k", "cap", "nnz")},
         manifest_equal=manifest == rec["registry_manifest"],
         drift=report(rep), record_drift=rec["drift"]["in_distribution"],
         drift_shifted=report(rep2),
         record_drift_shifted=rec["drift"]["shifted"],
         first_queries_rebuilt=same_batch)
    check(_same_supports(results, rec["fit"]),
          "serving fit's supports differ from the serve record")
    check(manifest == rec["registry_manifest"],
          "the registry manifest differs from the reference launcher's")
    check(launches == dispatches == batches + out["warmups"] > 0,
          "K4 launches != kernel.launches.sparse_project != batches + 2")
    check(out["trace_count"] == 1, "the projector saw more than one shape")
    check(not rep.triggered and rep2.triggered,
          "drift not quiet in distribution or not firing on the shift")
    check(out["served"] == rec["serve"]["served"], "served count")
    check(same_batch, "the first 64 queries differ from the record's")
    return {**out, "k4_launches": launches}


def _pack_case(rng, n, k, cap, *, overlap=0, empty=None):
    """A random pack in the projector's layout (cards 4..cap, the first
    ``overlap`` words shared, component ``empty`` all padding)."""
    import numpy as np

    sidx = np.zeros((k, cap), np.int32)
    vals = np.zeros((k, cap), np.float32)
    shared = rng.choice(n, size=overlap, replace=False)
    for c in range(k):
        if c == empty:
            continue
        card = min(cap, 4 + c)
        own = rng.choice(n, size=card - overlap, replace=False)
        words = np.sort(np.concatenate([shared, own]))
        sidx[c, :words.size] = words
        vals[c, :words.size] = rng.normal(size=words.size)
    return sidx, vals


def phase_project_parity(record, queries):
    """K4 against its plain version on the card, within 1e-5 of the
    largest |score| (both sum a component's slots in slot order, multiply
    then add, so they should agree to the bit on finite input), and run to
    run: the record's packed model on the record's first 64 queries (also
    held to the record's reference scores, same tolerance); random packs
    at n = 102,660, k = 5, B in {1, 64, 512} x cap in {8, 16}; overlapping
    supports; a component that is all padding (its scores exactly 0).
    Returns the worst |diff| against the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve_topics

    dev = torch.device("cuda")
    n, k = queries.n_words, 5
    rng = np.random.default_rng(13)
    X64 = _dense_rows(serve_topics.iter_docs(queries), 64, n)
    rows = _dense_rows(serve_topics.iter_docs(queries), 512, n)
    cases = [("record_pack", X64, np.asarray(record["pack"]["support_idx"],
                                             np.int32),
              np.asarray(record["pack"]["values"], np.float32), None)]
    for B in (1, 64, 512):
        for cap in (8, 16):
            cases.append((f"B{B}_cap{cap}", rows[:B],
                          *_pack_case(rng, n, k, cap), None))
    cases.append(("overlap", rows[:64], *_pack_case(rng, n, k, 8, overlap=3),
                  None))
    cases.append(("all_padding", rows[:64],
                  *_pack_case(rng, n, k, 8, empty=2), 2))
    worst = rerun_worst = 0.0
    for label, X, sidx, vals, empty in cases:
        Xd, sd, vd = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in (X, sidx, vals))
        got = ops.sparse_project(Xd, sd, vd, impl="cuda")
        again = ops.sparse_project(Xd, sd, vd, impl="cuda")
        want = ops.sparse_project(Xd, sd, vd, impl="ref")
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        diff = float((got - want).abs().max())
        rerun = float((got - again).abs().max())
        ok = diff <= 1e-5 * scale and rerun == 0.0
        row = {"case": label, "B": X.shape[0], "cap": sidx.shape[1],
               "max_abs_diff": diff, "max_abs_score": scale,
               "run_to_run_max_abs_diff": rerun,
               "tolerance": "1e-5 of max |score|"}
        if label == "record_pack":
            recd = torch.tensor(record["first_queries"]["scores"],
                                device=dev)
            rdiff = float((got - recd).abs().max())
            row["vs_record_max_abs_diff"] = rdiff
            ok = ok and rdiff <= 1e-5 * scale
        if empty is not None:
            row["padding_component_zero"] = not bool(got[:, empty].any())
            ok = ok and row["padding_component_zero"]
        emit("project_parity", **row, ok=ok)
        check(ok, f"project_parity {label}")
        worst, rerun_worst = max(worst, diff), max(rerun_worst, rerun)
    return worst, rerun_worst


def phase_project_timing(record, queries):
    """K4 on the record's packed model at B 64 (the serving batch) and B
    512: ms per launch (CUDA events, 200 launches), the plain version's ms
    (no yardstick: it repeats the kernel's arithmetic in cap + 2 launches),
    ``X @ W`` with W the dense (n, k) float32 loading matrix (TF32 off: the
    one library call that computes the same function; it reads the whole
    batch), and the bound: the larger of the bytes the function needs (the
    B x live-word values of X it gathers, the pack, the output) over 3.35
    TB/s and its 2 multiply-adds per live slot over 67 TFLOP/s.  Beside
    them, on the same clock (`device_ms`), the launch floor: the device
    time of a one-element elementwise kernel (``x.add_(1)``), the least
    any launch takes; a note, not part of the bound."""
    import numpy as np
    import torch

    from repro_torch.kernels import project, ref
    from repro_torch.launch import serve_topics

    dev = torch.device("cuda")
    n = queries.n_words
    sidx = np.asarray(record["pack"]["support_idx"], np.int32)
    vals = np.asarray(record["pack"]["values"], np.float32)
    k, cap = sidx.shape
    W = np.zeros((n, k), np.float32)
    for c in range(k):
        np.add.at(W[:, c], sidx[c], vals[c])
    live = vals != 0
    words = np.unique(sidx[live]).size
    sd, vd, Wd = (torch.from_numpy(a).to(dev) for a in (sidx, vals, W))
    rows = _dense_rows(serve_topics.iter_docs(queries), 512, n)
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda: one.add_(1))
    out = {}
    for B in (64, 512):
        X = torch.from_numpy(rows[:B].copy()).to(dev)
        ms = cuda_ms(lambda: project.sparse_project_cuda(X, sd, vd), 200)
        plain = cuda_ms(lambda: ref.sparse_project_ref(X, sd, vd), 50)
        with ref.full_fp32():
            lib = cuda_ms(lambda: X @ Wd, 200)
            lib_dev = device_ms(lambda: X @ Wd)
        dev_ms = device_ms(lambda: project.sparse_project_cuda(X, sd, vd))
        nbytes = B * words * 4 + sidx.size * 8 + B * k * 4
        ops = 2 * B * int(live.sum())
        tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
        row = {"name": "sparse_project", "B": B, "n": n, "k": k, "cap": cap,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "library": "X @ W, W dense (n, k) float32, TF32 off",
               "device_ms": dev_ms, "library_device_ms": lib_dev,
               "launch_floor_device_ms": floor, "bound_ms": max(tb, to),
               "bound_by": "bytes" if tb >= to else "operations",
               "bytes": nbytes, "ops": ops, "live_slots": int(live.sum()),
               "dense_batch_bytes": B * n * 4}
        emit("timing", **row)
        out[B] = row
    return out


def phase_serve_split(mv, queries):
    """Where a serving batch's time goes, on the card, at batch 64: the
    launcher's serving loop again (4,000 queries, drift observer on) under
    torch.profiler for the device's busy and idle share of its wall time;
    then the batch's parts one by one on the first 64 batches of queries,
    each ending in a synchronise: host densify (zero the (64, n) matrix
    and scatter the requests, as ``MicroBatcher._collect`` does), the copy
    to the card, K4, the drift fold (its own copy to the card, the column
    moments and the pooled merge) and future resolution (the scores' copy
    back and 64 ``set_result``)."""
    from concurrent.futures import Future

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import as_tensor, to_host
    from repro_torch.launch import serve_topics
    from repro_torch.serve import BatcherConfig, DriftMonitor, MicroBatcher

    dev = torch.device("cuda")
    n, B = queries.n_words, 64
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    monitor = DriftMonitor(mv.screen, mv.lams, min_docs=B * 4)
    batcher = MicroBatcher(mv.projector, n,
                           BatcherConfig(max_batch=B, max_wait_ms=2.0),
                           observer=monitor.observe)
    with batcher:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            served, _ = serve_topics.serve_stream(
                batcher, serve_topics.iter_docs(queries))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy_ms = sum(e[0] for e in events)
    docs = list(serve_topics.iter_docs(queries))
    parts = {"densify": 0.0, "copy_to_card": 0.0, "k4": 0.0,
             "drift_fold": 0.0, "resolve": 0.0}
    fold = DriftMonitor(mv.screen, mv.lams, min_docs=B * 4)
    n_batches = 0
    for lo in range(0, min(len(docs), 64 * B), B):
        reqs = docs[lo:lo + B]
        t0 = time.perf_counter()
        X = np.zeros((B, n), np.float32)
        for i, (wi, ct) in enumerate(reqs):
            np.add.at(X[i], wi, ct)
        t1 = time.perf_counter()
        Xd = as_tensor(X, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores = mv.projector.project(Xd)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fold.observe(X[:len(reqs)])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        host = to_host(scores)
        for i in range(len(reqs)):
            Future().set_result(host[i])
        t5 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                   t5 - t4)):
            parts[key] += dt
        n_batches += 1
    per_batch_ms = {key: v / n_batches * 1e3 for key, v in parts.items()}
    total = sum(per_batch_ms.values())
    emit("serve_split", served=served, serve_wall_s=wall,
         device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / 1e3 / wall,
         top=[{"ms": ms, "count": c, "name": name}
              for ms, c, name in events[:8]],
         batches_timed=n_batches, per_batch_ms=per_batch_ms,
         share={key: v / total for key, v in per_batch_ms.items()})


# ------------------------------------------------------------ the lane mesh


def _kernel_intervals(prof, name):
    """(start_us, end_us, stream) of each device kernel whose name holds
    ``name`` in a torch.profiler run, from its Chrome trace."""
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name)).get("traceEvents", [])
    return sorted((e["ts"], e["ts"] + e.get("dur", 0),
                   e.get("args", {}).get("stream", e.get("tid")))
                  for e in events
                  if e.get("cat") == "kernel" and name in e.get("name", ""))


def _overlap(intervals):
    """How many kernels ran while another (on another stream) ran."""
    hit = 0
    for i, (a0, a1, sa) in enumerate(intervals):
        if any(b0 < a1 and a0 < b1 and sb != sa
               for j, (b0, b1, sb) in enumerate(intervals) if j != i):
            hit += 1
    return hit


class _forced_lanes:
    """``REPRO_TORCH_FORCE_LANES`` set in this process for a block."""

    def __init__(self, n):
        from repro_torch.launch.mesh import FORCE_LANES_ENV

        self.key, self.n = FORCE_LANES_ENV, str(n)

    def __enter__(self):
        self.prev = os.environ.get(self.key)
        os.environ[self.key] = self.n

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop(self.key, None)
        else:
            os.environ[self.key] = self.prev


def phase_grid_probe(record, corpus):
    """The dense fit (the ``fit`` phase's config) with the lambda-grid
    probe (``lam_grid_probe=8``): every search first solves 8 lambdas on
    its probe support in ONE `bcd.solve_bcd_grid` call, one K1 launch.
    Held to the dense record's supports; per component the probe's n, its
    K1 launches and K1's device ms, and the evaluations with and without
    the probe (the fit without it on the same clock).  K1's grid is then
    held to its plain version (``impl='fused_ref'``, on the host) on
    component 1's probe inputs, at the first and last lambda of the grid:
    equal cards, F to 1e-4 relative (the fit-shape bar), |dX| printed."""
    import torch

    from repro_torch.core import bcd
    from repro_torch.kernels import bcd_fused

    t_phase = time.perf_counter()
    _, d0 = _fit_direct(corpus, "auto")
    plain_s = time.perf_counter() - t_phase
    real = bcd.solve_bcd_grid
    calls = []

    def probe(Sigma, lams, **kw):
        k0 = bcd_fused.launches
        out = real(Sigma, lams, **kw)
        calls.append({"Sigma": Sigma, "lams": list(lams), "kw": kw,
                      "k1_launches": bcd_fused.launches - k0,
                      "sweeps": out.sweeps.tolist()})
        return out

    bcd.solve_bcd_grid = probe
    try:
        bcd_fused.reset_launches()
        t0 = time.perf_counter()
        results, diag = _fit_direct(corpus, "auto", lam_grid_probe=8)
        probe_s = time.perf_counter() - t0
        k1 = bcd_fused.launches
    finally:
        bcd.solve_bcd_grid = real
    comps = []
    for k, (c, dp, dn) in enumerate(zip(calls, diag["components"],
                                        d0["components"])):
        dev = device_ms(lambda: real(c["Sigma"], c["lams"], **c["kw"]),
                        reps=1, kernel="bcd_fused")
        comps.append({"k": k, "probe_n": int(c["Sigma"].shape[0]),
                      "probe_k1_launches": c["k1_launches"],
                      "probe_k1_device_ms": dev,
                      "probe_sweeps": c["sweeps"],
                      "evals_with_probe": dp["evals"],
                      "evals_without": dn["evals"],
                      "solve_launches": dp["solve_launches"]})
    c = calls[0]
    kw = {**c["kw"], "impl": "fused"}
    ends = [c["lams"][0], c["lams"][-1]]
    got = real(c["Sigma"], ends, **kw)
    t0 = time.perf_counter()
    want = real(c["Sigma"].cpu(), ends, **{**kw, "impl": "fused_ref"})
    plain_hold_s = time.perf_counter() - t0
    cards = [[int(torch.count_nonzero(bcd.leading_sparse_component(
        r.Z[i].cpu()))) for i in range(len(ends))] for r in (got, want)]
    dF = float((got.kernel_obj.cpu() - want.kernel_obj).abs().max())
    Fmax = float(want.kernel_obj.abs().max())
    hold = {"lams": ends, "n": int(c["Sigma"].shape[0]), "cards": cards[0],
            "plain_cards": cards[1], "max_abs_dX": float(
                (got.X.cpu() - want.X).abs().max()), "max_abs_dF": dF,
            "sweeps": got.sweeps.tolist(),
            "plain_sweeps": want.sweeps.tolist(),
            "plain_s": plain_hold_s}
    emit("grid_probe", phase_seconds=time.perf_counter() - t_phase,
         seconds=probe_s, seconds_without_probe=plain_s,
         k1_launches=k1, probe_calls=len(calls), components=comps,
         vs_record=_vs_record(results, record["fit"]), hold=hold)
    check(_same_supports(results, record["fit"]),
          "grid_probe: the fit with the probe differs from the dense record")
    check(len(calls) == 5 and all(x["k1_launches"] == 1 for x in calls),
          "grid_probe: a probe was not ONE K1 launch")
    check(all(d["solve_launches"] == d["evals"] + 1
              for d in diag["components"]),
          "grid_probe: solve launches != evals + 1")
    check(cards[0] == cards[1] and dF <= 1e-4 * (1 + Fmax),
          "grid_probe: K1's grid disagrees with its plain version")
    return {"k1": k1, "probe_k1": sum(x["k1_launches"] for x in calls)}


def phase_device_grid(corpus, results):
    """`solve_bcd_many` on the dense fit's problems (its five components'
    Sigma_hat at their lambdas, n_hat 48-192: B 5; and three more at 0.8x
    the first three lambdas: B 8) with ``devices=4`` on four forced lanes
    of the card, against ``devices=0``: X, obj, sweeps and history must
    differ by exactly 0; the registry counts ONE batched dispatch, K1's
    own count one launch a lane, and the profiler four K1 records;
    ``devices=8`` clamps to the four lanes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import bcd
    from repro_torch.kernels import bcd_fused
    from repro_torch.launch.spca_run import dense_stats
    from repro_torch.obs import metrics

    t_phase = time.perf_counter()
    build = dense_stats(corpus, torch.device("cuda"))[1]
    Sigmas = [build(r.reduced_support) for r in results]
    lams = [r.lam for r in results]
    cases = {"B5": (Sigmas, lams),
             "B8": (Sigmas + Sigmas[:3], lams + [0.8 * x for x in lams[:3]])}
    kw = dict(max_sweeps=8, qp_sweeps=4, tau_iters=80, tol=1e-7)
    rows, k1_total = [], 0
    with _forced_lanes(4):
        for label, (S, L) in cases.items():
            one = bcd.solve_bcd_many(S, L, **kw)
            with metrics.use_registry() as reg:
                bcd_fused.reset_launches()
                t0 = time.perf_counter()
                four = bcd.solve_bcd_many(S, L, devices=4, **kw)
                torch.cuda.synchronize()
                wall4 = time.perf_counter() - t0
                k1 = bcd_fused.launches
                dispatches = reg.value("kernel.launches.bcd_solve_batched")
                gauge = reg.gauge("mesh.devices").value
            k1_total += k1
            diff = max(max(float((a.X - b.X).abs().max()),
                           float((a.kernel_obj - b.kernel_obj).abs()),
                           float((a.history.nan_to_num()
                                  - b.history.nan_to_num()).abs().max()),
                           abs(int(a.sweeps) - int(b.sweeps)))
                       for a, b in zip(one, four))
            records = []
            for _ in range(3):     # a profiler session now and then drops records
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    bcd.solve_bcd_many(S, L, devices=4, **kw)
                    torch.cuda.synchronize()
                ivs = _kernel_intervals(prof, "bcd_fused")
                records.append(len(ivs))
                if len(ivs) == 4:
                    break
            t0 = time.perf_counter()
            bcd.solve_bcd_many(S, L, **kw)
            torch.cuda.synchronize()
            wall1 = time.perf_counter() - t0
            with metrics.use_registry() as reg:
                eight = bcd.solve_bcd_many(S, L, devices=8, **kw)
                clamp = reg.gauge("mesh.devices").value
            same8 = all(torch.equal(a.X, b.X) for a, b in zip(one, eight))
            rows.append({"case": label, "n_hat": [int(s.shape[0]) for s in S],
                         "max_abs_diff": diff, "dispatches": dispatches,
                         "k1_launches": k1, "mesh_devices": gauge,
                         "profiler_k1_records": records,
                         "k1_overlapping": _overlap(ivs),
                         "wall_ms_4_lanes": wall4 * 1e3,
                         "wall_ms_1_lane": wall1 * 1e3,
                         "devices_8_gauge": clamp, "devices_8_equal": same8})
            check(diff == 0.0, f"device_grid {label}: 4 lanes != 1 launch")
            check(dispatches == 1 and k1 == 4 and gauge == 4.0,
                  f"device_grid {label}: not one dispatch of four K1 launches")
            check(4 in records, f"device_grid {label}: no session showed "
                  "four K1 records")
            check(clamp == 4.0 and same8,
                  f"device_grid {label}: devices=8 did not clamp to 4 lanes")
    emit("device_grid", seconds=time.perf_counter() - t_phase, cases=rows)
    return k1_total


def phase_mesh_streaming(record, store_dir, support):
    """The streaming leg on four forced lanes of the card (the 300k store,
    229 megabatches a pass, the union support):

    (a) `mesh_feature_variances` and `mesh_reduced_covariance` at D 4
        beside the engine's passes, each under torch.profiler (pass
        seconds, the device's idle share, K2's and K3's launches and how
        many ran while another lane's ran), then the mesh passes again
        without it: max abs differences of variances, means and
        Sigma_hat against the engine's; 58 + 58 dispatches, 1 + 1 passes,
        229 + 229 kernel launches, the lanes' counters summing to the
        pass's chunks and nnz; the repeated pass equal to the first;
    (b) ``spca_run --streaming --devices 4``: the streaming record's
        supports, 58 + 58 dispatches;
    (c) the degrade ladder: one dispatch error at ``mesh.screen`` runs the
        screen at D 2, two at ``mesh.gram`` run the Gram on the engine,
        each equal to a clean pass at the D it ended on;
    (d) a mesh screen pass killed by a read fault resumes at D 4 to the
        uninterrupted pass bit for bit (checkpoints every 16 megabatches,
        on superbatch boundaries), and its D 4 checkpoint is not restored
        at D 2;
    (e) what concurrent launches on the lanes' four streams of one card
        do (`_lane_concurrency`)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import csr_gram, csr_stats
    from repro_torch.launch import spca_run
    from repro_torch.obs import metrics
    from repro_torch.sparse import SparseCorpus, engine, mesh_engine
    from repro_torch.testing import (
        FaultInjector, SolverFaultInjector, dispatch_error, fail_nth_read,
        install, install_solver)

    t_phase = time.perf_counter()
    geo = dict(chunk_nnz=16_384, chunk_rows=CHUNK_ROWS, megabatch=MEGABATCH,
               device="cuda")
    out = {}

    def run(kind, fn, D, **kw):
        c = {}
        with metrics.use_registry() as reg:
            csr_stats.reset_launches()
            csr_gram.reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(SparseCorpus.open(store_dir), counters=c, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy = sum(k[0] for k in _device_events(prof)) / 1e3
            name = "csr_stats" if kind == "screen" else "csr_gram"
            ivs = _kernel_intervals(prof, name)
            row = {"pass": kind, "devices": D, "seconds_profiled": wall,
                   "device_idle_share": 1 - busy / wall,
                   "k2_launches": csr_stats.launches,
                   "k3_launches": csr_gram.launches,
                   "kernels_overlapping": _overlap(ivs),
                   "kernel_records": len(ivs),
                   **{k: v for k, v in c.items()
                      if not k.startswith("prefetch")},
                   **{k: reg.value(k) for k in (
                       "ingest.shard.chunks", "ingest.shard.nnz",
                       "ingest.chunks")}}
        return res, row

    with _forced_lanes(4):
        scr_e, r1 = run("screen", engine.sparse_feature_variances, 1, **geo)
        means = scr_e.means.cpu().numpy()
        G_e, r2 = run("gram", lambda s, **kw: engine.sparse_reduced_covariance(
            s, support, means=means, **kw), 1, **geo)
        scr_m, r3 = run("screen", mesh_engine.mesh_feature_variances, 4,
                        devices=4, **geo)
        G_m, r4 = run("gram", lambda s, **kw: mesh_engine.
                      mesh_reduced_covariance(s, support, means=means, **kw),
                      4, devices=4, **geo)
        secs = {}
        t0 = time.perf_counter()
        scr_2 = mesh_engine.mesh_feature_variances(
            SparseCorpus.open(store_dir), devices=4, **geo)
        torch.cuda.synchronize()
        secs["screen"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        G_2 = mesh_engine.mesh_reduced_covariance(
            SparseCorpus.open(store_dir), support, devices=4, means=means,
            **geo)
        torch.cuda.synchronize()
        secs["gram"] = time.perf_counter() - t0
        store = SparseCorpus.open(store_dir)
        n_mega = r1["screen_launches"]
        disp = -(-n_mega // 4)
        diffs = {
            "variances": float((scr_m.variances - scr_e.variances).abs().max()),
            "means": float((scr_m.means - scr_e.means).abs().max()),
            "sigma_hat": float((G_m - G_e).abs().max()),
            "sigma_hat_max_abs": float(G_e.abs().max()),
            "repeat_variances": float((scr_2.variances
                                       - scr_m.variances).abs().max()),
            "repeat_sigma_hat": float((G_2 - G_m).abs().max())}
        emit("mesh_streaming_passes", passes=[r1, r2, r3, r4],
             mesh_seconds_unprofiled=secs, vs_engine=diffs,
             megabatches=n_mega, nnz=int(store.nnz))
        check(r3["screen_launches"] == r4["gram_launches"] == disp,
              "mesh passes: dispatches != ceil(megabatches / 4)")
        check(r3["screen_passes"] == r4["gram_passes"] == 1,
              "mesh passes: not 1 + 1 passes")
        check(r3["k2_launches"] == r4["k3_launches"] == n_mega
              and r3["k3_launches"] == r4["k2_launches"] == 0,
              "mesh passes: not one K2 / K3 launch a megabatch")
        for r in (r3, r4):
            check(r["ingest.shard.chunks"] == r["ingest.chunks"]
                  == r1["chunks"] and r["ingest.shard.nnz"] == store.nnz,
                  "mesh passes: lane counters do not sum to the pass")
        check(diffs["repeat_variances"] == 0 == diffs["repeat_sigma_hat"],
              "mesh passes: a repeated pass differs")
        check(diffs["variances"] <= 1e-6 * float(scr_e.variances.max())
              and diffs["sigma_hat"] <= 1e-6 * diffs["sigma_hat_max_abs"],
              "mesh passes: far from the engine's")
        out["k2"], out["k3"] = r3["k2_launches"], r4["k3_launches"]

        # (b) the launcher on four lanes
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as sd:
            csr_stats.reset_launches()
            csr_gram.reset_launches()
            t0 = time.perf_counter()
            corpus, results, diag = spca_run.main(
                STREAM_ARGS + ["--store-dir", sd, "--devices", "4"])
            wall = time.perf_counter() - t0
            k2, k3 = csr_stats.launches, csr_gram.launches
        ing = diag["ingest"]
        emit("mesh_streaming_fit", seconds=wall, pcs=_pc_lines(corpus, results),
             components=_vs_record(results, record["fit"]), ingest=ing,
             corpus_passes=diag["corpus_passes"], k2_launches=k2,
             k3_launches=k3, mesh_degraded=diag.get("mesh_degraded", 0))
        check(_same_supports(results, record["fit"]),
              "spca_run --devices 4: supports differ from the streaming record")
        check(ing["screen_launches"] == ing["gram_launches"] == disp
              and diag["corpus_passes"] == 2 and k2 == k3 == n_mega,
              "spca_run --devices 4: pass economics")
        out["fit_k2"], out["fit_k3"] = k2, k3
        del corpus

        # (c) the degrade ladder
        lad = {}
        c = {}
        with metrics.use_registry() as reg, install_solver(SolverFaultInjector(
                dispatch_error(n=0, match="mesh.screen"))):
            s_deg = mesh_engine.mesh_feature_variances(
                SparseCorpus.open(store_dir), devices=4, counters=c, **geo)
            lad["screen"] = {"mesh_degraded": c.get("mesh_degraded", 0),
                             "ended_at": reg.gauge("mesh.devices").value}
        s_d2 = mesh_engine.mesh_feature_variances(
            SparseCorpus.open(store_dir), devices=2, **geo)
        lad["screen"]["max_abs_diff_vs_clean_d2"] = float(
            (s_deg.variances - s_d2.variances).abs().max())
        lad["screen"]["max_abs_diff_vs_d4"] = float(
            (s_deg.variances - scr_m.variances).abs().max())
        c = {}
        with install_solver(SolverFaultInjector(
                dispatch_error(n=0, match="mesh.gram", times=2))):
            G_deg = mesh_engine.mesh_reduced_covariance(
                SparseCorpus.open(store_dir), support, devices=4,
                means=means, counters=c, **geo)
        lad["gram"] = {"mesh_degraded": c.get("mesh_degraded", 0),
                       "max_abs_diff_vs_engine": float(
                           (G_deg - G_e).abs().max())}
        emit("mesh_degrade", **lad)
        check(lad["screen"]["mesh_degraded"] == 1
              and lad["screen"]["ended_at"] == 2.0
              and lad["screen"]["max_abs_diff_vs_clean_d2"] == 0,
              "mesh degrade: the screen did not rerun cleanly at D 2")
        check(lad["gram"]["mesh_degraded"] == 2
              and lad["gram"]["max_abs_diff_vs_engine"] == 0,
              "mesh degrade: the Gram did not rerun cleanly on the engine")

        # (d) kill and resume
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mresume_") as rd:
            kw = dict(resume_dir=rd, checkpoint_every=16, io_retries=0, **geo)
            with install(FaultInjector(fail_nth_read(
                    4, match="*.values.npy", times=10**9))):
                try:
                    mesh_engine.mesh_feature_variances(
                        SparseCorpus.open(store_dir), devices=4, **kw)
                    killed = False
                except OSError:
                    killed = True
            c4, c2 = {}, {}
            s_res = mesh_engine.mesh_feature_variances(
                SparseCorpus.open(store_dir), devices=4, counters=c4, **kw)
            s_2 = mesh_engine.mesh_feature_variances(
                SparseCorpus.open(store_dir), devices=2, counters=c2, **kw)
        res = {"killed": killed,
               "resumed_megabatches": c4.get("resumed_megabatches", 0),
               "screen_launches_after_resume": c4.get("screen_launches", 0),
               "max_abs_diff_vs_uninterrupted": float(
                   (s_res.variances - scr_m.variances).abs().max()),
               "means_max_abs_diff": float(
                   (s_res.means - scr_m.means).abs().max()),
               "d2_resumed_megabatches": c2.get("resumed_megabatches", 0),
               "d2_screen_launches": c2.get("screen_launches", 0),
               "d2_max_abs_diff_vs_clean_d2": float(
                   (s_2.variances - s_d2.variances).abs().max())}
        emit("mesh_resume", **res)
        check(killed and 0 < res["resumed_megabatches"] < n_mega,
              "mesh resume: the pass was not killed mid-pass and resumed")
        check(res["max_abs_diff_vs_uninterrupted"] == 0
              == res["means_max_abs_diff"],
              "mesh resume: the resumed pass differs from the uninterrupted")
        check(res["d2_resumed_megabatches"] == 0
              and res["d2_screen_launches"] == -(-n_mega // 2),
              "mesh resume: a D 4 checkpoint was restored at D 2")
        _lane_concurrency(store_dir, support)
    emit("mesh_streaming", seconds=time.perf_counter() - t_phase)
    return out


def _lane_concurrency(store_dir, support):
    """Four K2 (and four K3) launches on the four lane streams of one
    card, back to back with their inputs already on the card (in a mesh
    pass each lane's blocking copy sits between them): whether they
    overlap, serialize or fail, their results against the same launches
    in turn on one stream (bit for bit), and the host ms of a round of
    four either way (10 rounds each, after one to warm up)."""
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.bow import local_support_cols
    from repro_torch.kernels import csr_gram, csr_stats
    from repro_torch.launch.mesh import lane_context, make_data_mesh, sync_lanes
    from repro_torch.sparse import SparseCorpus

    store = SparseCorpus.open(store_dir)
    mbs = list(itertools.islice(store.iter_megabatches(
        chunk_rows=CHUNK_ROWS, megabatch=MEGABATCH, reuse_buffers=False), 4))
    mesh = make_data_mesh(4)
    dev = mesh[0].device
    n, k = store.n_cols, int(support.size)
    ins = [tuple(torch.as_tensor(a, device=dev) for a in (
        mb.values, mb.col_ids, local_support_cols(support, mb.col_ids),
        mb.seg_ids)) for mb in mbs]
    kernels = {
        "csr_stats": lambda v, c, lc, sg: csr_stats.csr_column_stats_cuda(
            v, c, n),
        "csr_gram": lambda v, c, lc, sg: (csr_gram.csr_gram_cuda(
            v, lc, sg, CHUNK_ROWS, k),)}
    rows = {}
    for name, fn in kernels.items():
        def serial():
            out = [fn(*x) for x in ins]
            torch.cuda.synchronize()
            return out

        def lanes():
            out = []
            for lane, x in zip(mesh, ins):
                with lane_context(lane):
                    out.append(fn(*x))
            sync_lanes(mesh)
            return out

        one, four = serial(), lanes()
        equal = all(torch.equal(a, b) for x, y in zip(one, four)
                    for a, b in zip(x, y))
        ms = {}
        for label, f in (("one_stream", serial), ("four_streams", lanes)):
            f()
            ms[label] = sum(host_ms(f) for _ in range(10)) / 10
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                lanes()
        ivs = _kernel_intervals(prof, name)
        rows[name] = {"records": len(ivs), "overlapping": _overlap(ivs),
                      "streams": len({iv[2] for iv in ivs}),
                      "equal_to_one_stream": equal,
                      "host_ms_a_round": ms}
        check(equal, f"lane concurrency: {name} on four streams != in turn")
    emit("mesh_concurrency", **rows)


def phase_baselines(corpus, results):
    """The baselines on the card: the first-order DSPCA method on
    component 1's Sigma_hat at its lambda (float64) against the BCD solve,
    holding the reference's sandwich (its ``tests/test_bcd.py``): FO dual
    >= BCD phi >= FO best primal - 1e-4; the power iteration against
    ``torch.linalg.eigh``; and `distributed_screen_and_gram` on four
    forced lanes over the dense corpus's first 4,096 docs (1.68 GB
    float32) against one lane: the same support, Sigma_hat's difference
    printed; and on a (2, 2) ``("data", "model")`` lane mesh against a
    2-lane data mesh: the same support, screen and Sigma_hat bit for
    bit."""
    import numpy as np
    import torch

    from repro_torch.core import baselines, distributed, solve_bcd
    from repro_torch.core import solve_first_order
    from repro_torch.core.elimination import lam_for_target_size
    from repro_torch.launch.mesh import make_data_mesh, make_dev_mesh
    from repro_torch.launch.spca_run import dense_stats

    t_phase = time.perf_counter()
    r = results[0]
    S = dense_stats(corpus, torch.device("cuda"))[1](r.reduced_support)
    S = S.double()
    res = solve_bcd(S, r.lam, beta=1e-7, max_sweeps=60, tol=1e-13,
                    solver_impl="fused")
    iters = 2000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fo = solve_first_order(S, r.lam, max_iters=iters, eps=1e-3)
    fo_s = time.perf_counter() - t0
    phi = float(res.phi)
    v, lam_pow = baselines.pca_power(S, iters=5000)
    evals, evecs = torch.linalg.eigh(S)
    align = float(torch.abs(v @ evecs[:, -1]))
    A = torch.from_numpy(next(corpus.batches(4096))).cuda()
    with _forced_lanes(4):
        m1, m4 = make_data_mesh(1), make_data_mesh(4)
        v1 = distributed.distributed_variances(A, m1).variances
        lam = lam_for_target_size(v1.cpu().numpy(), 500)
        t0 = time.perf_counter()
        S1, sup1, _ = distributed.distributed_screen_and_gram(A, m1, lam)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        S4, sup4, _ = distributed.distributed_screen_and_gram(A, m4, lam)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        # the (2, 2) ("data", "model") mesh pools over 'data' only: the
        # same blocks and order as a 2-lane data mesh, bit for bit
        m2 = make_data_mesh(2)
        m22 = make_dev_mesh((2, 2), ("data", "model"))
        S2, sup2, sc2 = distributed.distributed_screen_and_gram(A, m2, lam)
        S22, sup22, sc22 = distributed.distributed_screen_and_gram(A, m22,
                                                                   lam)
        torch.cuda.synchronize()
        mesh2d_equal = bool(
            np.array_equal(sup2, sup22)
            and torch.equal(S2.view(torch.int32), S22.view(torch.int32))
            and torch.equal(sc2.variances.view(torch.int32),
                            sc22.variances.view(torch.int32)))
    emit("baselines", seconds=time.perf_counter() - t_phase,
         n_hat=int(S.shape[0]), lam=r.lam, bcd_phi=phi,
         fo_dual_min=float(fo.dual_history.min()),
         fo_primal_max=float(fo.primal_history.max()), fo_iters=iters,
         fo_iters_per_s=iters / fo_s, power_lambda=float(lam_pow),
         eigh_lambda=float(evals[-1]), power_alignment=align,
         dense_bytes=A.numel() * 4, dist_lam=lam, dist_support=int(sup1.size),
         dist_support_equal=bool(np.array_equal(sup1, sup4)),
         dist_sigma_max_abs_diff=float((S1 - S4).abs().max()),
         dist_sigma_max_abs=float(S1.abs().max()),
         dist_s_1_lane=t1 - t0, dist_s_4_lanes=t4 - t1,
         dist_2x2_mesh_equals_2_lanes_bitwise=mesh2d_equal,
         dist_2x2_support=int(sup22.size))
    check(float(fo.dual_history.min()) + 1e-4 >= phi
          >= float(fo.primal_history.max()) - 1e-4,
          "baselines: the first-order sandwich does not hold")
    check(abs(float(lam_pow) - float(evals[-1]))
          <= 1e-6 * float(evals[-1]), "baselines: power iteration != eigh")
    check(np.array_equal(sup1, sup4),
          "baselines: 4-lane support differs from 1 lane's")
    check(mesh2d_equal, "baselines: the (2, 2) mesh's pooled statistics "
          "differ from the 2-lane data mesh's")



LM_F32 = ("float32", "float32")


def _lm_free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_record():
    """The LM serving record on the card: the reference's ``PRNGKey(0)``
    weights of the qwen2-0.5b and mamba2-130m smoke configs, carried in
    by ``lm_params_from_reference``, through the port's serve loop in
    float32 with TF32 off; each prompt step's logits within the CPU test's
    ``LOGITS_TOL`` x max |logits| of the reference's, the greedy tokens
    equal."""
    import torch

    from repro_torch.testing import lm_record as lr

    t0 = time.perf_counter()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec = lr.load_record()
        out = {}
        for arch in lr.ARCHS:
            logits, tokens = lr.run_record(arch, rec[arch]["params"],
                                           rec[arch]["prompt"], "cuda")
            out[arch] = lr.compare(rec[arch], logits, tokens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    emit("lm_record", seconds=time.perf_counter() - t0, tol=lr.LOGITS_TOL,
         archs=out)
    for arch, res in out.items():
        check(res["logits_err_rel"] < lr.LOGITS_TOL,
              f"lm_record: {arch} logits {res['logits_err_rel']} from the "
              "reference's")
        check(res["tokens_equal"], f"lm_record: {arch} greedy tokens differ")


def _mem_available_bytes():
    for line in open("/proc/meminfo"):
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def _lm_full_width(arch, batch=2, steps=16, cpu_tokens=4, on_card=False):
    """One config at its published width in float32 dtypes, weights from
    a seeded generator: forward on the first ``cpu_tokens`` tokens on the
    CPU and on the card (held to each other), forward on all ``steps``
    tokens on the card, and ``steps`` decode steps (held to that forward,
    as ``tests/test_models.py`` holds the reference).  An encoder-decoder
    gets seeded ``enc_frames`` (its decode cache holds their cross K/V).
    ``on_card``: the weights are drawn on the card (a CUDA generator) and
    copied to the host afterwards, only if the host has room for them
    (``MemAvailable`` at least 1.5x their bytes); otherwise the CPU side
    is skipped and the row says why."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, param_count

    cfg = get_config(arch).scaled(dtypes=LM_F32)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=(batch, steps)),
                           dtype=torch.int64)
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.as_tensor(rng.normal(size=(
            batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32))

    def batch_of(t, n):
        b = {"tokens": t[:, :n]}
        if frames is not None:
            b["enc_frames"] = frames.to(t.device)
        return b

    t0 = time.perf_counter()
    gen = (torch.Generator("cuda") if on_card else torch.Generator()
           ).manual_seed(0)
    model = build_model(cfg, device="cuda" if on_card else "cpu",
                        generator=gen)
    init_s = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cpu_logits, cpu_skipped = None, None
    with torch.no_grad():
        if not on_card:
            cpu_logits = model(batch_of(toks, cpu_tokens))[0]
            model.to("cuda")
        toks = toks.cuda()
        short = model(batch_of(toks, cpu_tokens))[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        full = model(batch_of(toks, steps))[0]
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t1) * 1e3
        if cfg.is_encoder_decoder:
            cache = model.init_cache(batch_of(toks, 1), steps + 1,
                                     dtype=torch.float32)
        else:
            cache = model.init_cache(batch, steps + 1, dtype=torch.float32)
        outs = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(steps):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1])
            outs.append(lg)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3 / steps
        dec = torch.stack(outs, 1)
        peak = torch.cuda.max_memory_allocated()
        del cache, outs
        if on_card:
            avail = _mem_available_bytes()
            if avail >= 1.5 * nbytes:
                model.to("cpu")
                cpu_logits = model(batch_of(toks.cpu(), cpu_tokens))[0]
            else:
                cpu_skipped = (f"MemAvailable {avail} bytes < 1.5 x the "
                               f"{nbytes} bytes of weights")
    scale = float(full.abs().max())
    row = dict(
        arch=arch, params=param_count(model), weight_bytes=nbytes,
        batch=batch, steps=steps, cpu_tokens=cpu_tokens,
        built_on="cuda" if on_card else "cpu", init_s=init_s,
        forward_ms=fwd_ms, decode_ms_per_step=step_ms,
        max_memory_allocated=peak,
        finite=bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
        decode_vs_forward_rel=float((dec - full).abs().max()) / max(scale, 1.0),
        card_vs_cpu_rel=None if cpu_logits is None else float(
            (short.cpu() - cpu_logits).abs().max())
        / float(cpu_logits.abs().max()),
        cpu_skipped=cpu_skipped, max_abs_logit=scale)
    del model, dec, full, short
    _lm_free()
    return row


def phase_lm_full_width():
    """qwen2-0.5b, mamba2-130m, whisper-medium (B 1: its encoder runs on
    1,500 frames) and minitron-8b (drawn on the card: 9.9 B float32
    weights, 40 GB) at their published widths in float32 (TF32 off):
    decode of 16 tokens equals ``forward`` within 2e-3 x max |logits|,
    and the card's logits on 4 tokens equal the port's CPU logits on the
    same weights within 1e-4 x max |logits| (minitron's CPU side only if
    the host has the memory)."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for arch, kw in (("qwen2-0.5b", {}), ("mamba2-130m", {}),
                         ("whisper-medium", {"batch": 1}),
                         ("minitron-8b", {"on_card": True})):
            torch.cuda.reset_peak_memory_stats()
            rows.append(_lm_full_width(arch, **kw))
            emit("lm_full_width", **rows[-1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for row in rows:
        a = row["arch"]
        check(row["finite"], f"lm_full_width: {a} logits not finite")
        check(row["decode_vs_forward_rel"] < 2e-3,
              f"lm_full_width: {a} decode != forward "
              f"({row['decode_vs_forward_rel']})")
        check(row["card_vs_cpu_rel"] is not None or row["cpu_skipped"],
              f"lm_full_width: {a} has no CPU side")
        if row["card_vs_cpu_rel"] is not None:
            check(row["card_vs_cpu_rel"] < 1e-4,
                  f"lm_full_width: {a} card != CPU ({row['card_vs_cpu_rel']})")


def phase_lm_serve():
    """The port's ``launch/serve.py --arch qwen2-0.5b`` at its published
    width with its default dtypes (float32 parameters, bfloat16 compute
    and cache), prompt 16, 32 greedy steps, at B 4 and B 64: its two
    lines, then decode tok/s, ms a step (each step copies its tokens to
    the host, as the launcher does), the prefill's seconds (16 decode
    steps) and the peak device memory, beside the card's name and power
    limit."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    vocab = get_config("qwen2-0.5b").vocab_size
    smi = nvidia_smi()
    for batch in (4, 64):
        torch.cuda.reset_peak_memory_stats()
        res = serve.main(["--arch", "qwen2-0.5b", "--batch", str(batch),
                          "--prompt-len", "16", "--gen", "32"])
        toks = res["tokens"]
        gen = toks.shape[1]
        row = dict(arch="qwen2-0.5b", batch=batch, prompt_len=16, gen=gen,
                   decode_tok_s=gen * batch / res["decode_s"],
                   decode_ms_per_step=res["decode_s"] / gen * 1e3,
                   prefill_s=res["prefill_s"], setup_s=res["setup_s"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   card=smi)
        emit("lm_serve", **row)
        print(f"lm_serve qwen2-0.5b B {batch}: "
              f"{row['decode_tok_s']:.1f} decode tok/s, "
              f"{row['decode_ms_per_step']:.2f} ms a step, prefill "
              f"{row['prefill_s']:.3f} s, max memory "
              f"{row['max_memory_allocated'] / 2**30:.2f} GiB on {smi}",
              flush=True)
        check(toks.shape == (batch, 32) and toks.min() >= 0
              and toks.max() < vocab and np.isfinite(row["decode_tok_s"]),
              f"lm_serve: B {batch} tokens out of shape or vocabulary")
        _lm_free()
    _lm_serve_profile()


def _lm_serve_profile(batch=4, steps=8):
    """Where a decode step's time goes: ``steps`` greedy steps of the
    launcher's model (qwen2-0.5b, default dtypes, B 4, after 16 warm-up
    steps) under torch.profiler: wall ms a step, device-busy ms a step,
    device launches a step, the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_step

    model = build_model(get_config("qwen2-0.5b"), device="cuda")
    serve = make_serve_step(model)
    cache = model.init_cache(batch, 16 + steps + 1)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device="cuda")
    for _ in range(16):
        cache, tok = serve(cache, tok)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            cache, tok = serve(cache, tok)
            tok.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = _device_events(prof)
    busy_ms = sum(k[0] for k in ev)
    emit("lm_serve_profile", arch="qwen2-0.5b", batch=batch, steps=steps,
         wall_ms_per_step=wall * 1e3 / steps,
         device_busy_ms_per_step=busy_ms / steps,
         device_idle_share=1 - busy_ms / (wall * 1e3),
         device_events_per_step=sum(k[1] for k in ev) / steps,
         top=[{"ms_per_step": k[0] / steps, "count_per_step": k[1] / steps,
               "name": k[2]} for k in ev[:6]])
    del model, cache
    _lm_free()


H100_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores, SXM data sheet
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "128"]


def phase_lm_train_record():
    """Three train steps on the card from the training record's weights
    (``lm_train_smoke.npz``: the reference's steps on the qwen2-0.5b and
    mamba2-130m smoke configs in float32), TF32 off, held to the record
    with `lm_train_record.compare`'s tolerances."""
    import torch

    from repro_torch.testing import lm_train_record as ltr

    t0 = time.perf_counter()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec = ltr.load_record()
        out = {arch: ltr.compare(rec[arch], ltr.run_record(
            arch, rec[arch]["init"], "cuda")) for arch in ltr.ARCHS}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    emit("lm_train_record", seconds=time.perf_counter() - t0,
         metric_rtol=ltr.METRIC_RTOL, mu_tol=ltr.MOMENT_TOL,
         nu_tol=ltr.NU_TOL, param_atol=ltr.PARAM_ATOL, archs=out)
    for arch, res in out.items():
        check(ltr.passes(res), f"lm_train_record: {arch} {res}")
    _lm_free()


def phase_lm_train_full_width(batch=2, seq=32):
    """qwen2-0.5b at its published width in float32 (TF32 off), one set
    of weights (seed 0): one train step on the CPU and one on the card on
    the same batch (``TokenPipeline`` batch 0); the card's ``loss`` and
    ``grad_norm`` within 1e-5 relative of the CPU's, each first-moment
    leaf within 1e-4 of its largest magnitude."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import _leaves
    from repro_torch.train import init_state, make_train_step

    cfg = get_config("qwen2-0.5b").scaled(dtypes=LM_F32)
    toks = torch.as_tensor(TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, batch=batch, seq_len=seq)).batch_at(0))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = build_model(cfg, device="cpu")
        card = copy.deepcopy(cpu).to("cuda")
        out = {}
        for name, model in (("cpu", cpu), ("cuda", card)):
            t0 = time.perf_counter()
            state, m = make_train_step(model)(init_state(model),
                                              {"tokens": toks})
            loss = float(m["loss"])
            out[name] = dict(seconds=time.perf_counter() - t0, loss=loss,
                             grad_norm=float(m["grad_norm"]),
                             mu=[t.cpu() for t in _leaves(state.opt.mu)])
            del state
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    c, g = out["cpu"], out["cuda"]
    mu_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(g["mu"], c["mu"]))
    row = dict(arch="qwen2-0.5b", batch=batch, seq=seq,
               cpu_s=c["seconds"], card_s=g["seconds"],
               loss_cpu=c["loss"], loss_card=g["loss"],
               loss_rel=abs(g["loss"] - c["loss"]) / abs(c["loss"]),
               grad_norm_cpu=c["grad_norm"], grad_norm_card=g["grad_norm"],
               grad_norm_rel=abs(g["grad_norm"] - c["grad_norm"])
               / abs(c["grad_norm"]), mu_rel=mu_rel)
    emit("lm_train_full_width", **row)
    del cpu, card, out
    _lm_free()
    check(row["loss_rel"] < 1e-5, f"lm_train_full_width: loss {row}")
    check(row["grad_norm_rel"] < 1e-5, f"lm_train_full_width: grad_norm {row}")
    check(mu_rel < 1e-4, f"lm_train_full_width: mu {mu_rel}")


def _train_child(ckpt_dir, steps, *, ckpt_every=1000):
    """``launch/train.py`` at qwen2-0.5b's width in a child process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
         "--steps", str(steps), "--ckpt-every", str(ckpt_every),
         "--ckpt-dir", ckpt_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0,
          f"lm_train child exited {proc.returncode}: {err[-2000:]}")
    return out.splitlines()


def _ckpt_max_diff(dir_a, dir_b, step):
    """Largest absolute difference over every leaf of two checkpoints of
    one step (parameters, moments, count, step), read a member at a
    time."""
    import numpy as np

    name = os.path.join(f"step_{step:09d}", "host_00000.npz")
    worst = 0.0
    with np.load(os.path.join(dir_a, name)) as a, \
            np.load(os.path.join(dir_b, name)) as b:
        check(a.files == b.files, "lm_train: checkpoints differ in leaves")
        for k in a.files:
            worst = max(worst, float(np.abs(
                a[k].astype(np.float64) - b[k]).max(initial=0.0)))
    return worst


def _lm_train_kill_resume(root, steps=6, kill_after=0):
    """Two uninterrupted ``steps``-step runs of the launcher (their
    difference is the card's run-to-run floor) beside one sent SIGTERM
    after step ``kill_after``'s metrics line (the launcher logs every
    10th step; it must checkpoint after the step the signal lands in,
    print ``preempted`` and exit 0), then run again to ``steps`` while the
    other two finish; the largest difference between the resumed and the
    uninterrupted checkpoint of step ``steps``."""
    import ast
    import signal

    dirs = {k: os.path.join(root, k) for k in ("a", "b", "killed")}
    t0 = time.perf_counter()
    procs = [_train_child(dirs["a"], steps), _train_child(dirs["b"], steps),
             _train_child(dirs["killed"], steps)]
    try:
        killed, lines = procs[2], []
        for line in killed.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("{") and ast.literal_eval(line).get(
                    "step") == kill_after and "'metrics'" in line:
                killed.send_signal(signal.SIGTERM)
                break
        out, err = killed.communicate(timeout=600)
        lines += out.splitlines()
        check(killed.returncode == 0,
              f"lm_train: killed child exited {killed.returncode}: "
              f"{err[-2000:]}")
        events = [ast.literal_eval(x) for x in lines if x.startswith("{")]
        pre = [e for e in events if e["kind"] == "preempted"]
        check(len(pre) == 1, f"lm_train: no preempted event in {lines[-4:]}")
        stopped_at = pre[0]["step"]
        t1 = time.perf_counter()
        procs.append(_train_child(dirs["killed"], steps))   # the rerun
        for p in procs[:2]:
            _finish(p)
        resumed = _finish(procs[3])
        resumed_s = time.perf_counter() - t1
        wall_s = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    events = [ast.literal_eval(x) for x in resumed if x.startswith("{")]
    check(events[0]["kind"] == "resume" and events[0]["step"] == stopped_at
          and resumed[-1] == f"final step {steps}",
          f"lm_train: the rerun did not resume at {stopped_at}: {resumed[:2]}")
    floor = _ckpt_max_diff(dirs["a"], dirs["b"], steps)
    diff = _ckpt_max_diff(dirs["a"], dirs["killed"], steps)
    return dict(steps=steps, sigterm_after_step=kill_after,
                preempted_at=stopped_at, run_to_run_max_abs_diff=floor,
                resumed_max_abs_diff=diff, wall_s=wall_s, resume_s=resumed_s)


def _lm_train_profile(model, step, state, batch, steps=3):
    """Where a train step's time goes: ``steps`` steps under
    torch.profiler after the launcher's run (same model and batch shape):
    wall ms a step, device-busy ms a step, device launches a step, the
    largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = _device_events(prof)
    busy_ms = sum(k[0] for k in ev)
    return dict(steps=steps, wall_ms_per_step=wall * 1e3 / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1 - busy_ms / (wall * 1e3),
                device_events_per_step=sum(k[1] for k in ev) / steps,
                top=[{"ms_per_step": k[0] / steps,
                      "count_per_step": k[1] / steps, "name": k[2]}
                     for k in ev[:8]])


def _lm_train_one_batch(step, state, batch, steps=10):
    """``steps`` more train steps on one batch (the run's last): the
    losses, which must fall as the model fits the batch."""
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append(float(m["loss"]))
    return out


def _lm_train_small_vocab(vocab=512, steps=60):
    """The run that ``lm_train``'s flat loss is held against: the same
    train step (default AdamW and schedule, float32 parameters, bfloat16
    compute) at qwen2-0.5b's published width and depth with the
    vocabulary cut to ``vocab`` words, ``steps`` steps on the stream's
    batches (B 8, S 128) from seeded weights.  Its loss must fall (the
    mean of the last 10 below the first 10's).  A batch's 1,024 tokens
    are twice a 512-word vocabulary, and under 1 % of the full one."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import init_state, make_train_step

    model = build_model(get_config("qwen2-0.5b").scaled(vocab_size=vocab),
                        device="cuda")
    state, step = init_state(model), make_train_step(model)
    pipe = TokenPipeline(PipelineConfig(vocab_size=vocab, batch=8,
                                        seq_len=128))
    t0 = time.perf_counter()
    losses = []
    for t in range(steps):
        state, m = step(state, {"tokens": torch.as_tensor(pipe.batch_at(t))})
        losses.append(m["loss"])
    loss = np.array([float(x) for x in losses])
    wall = time.perf_counter() - t0
    del model, state, step, losses
    _lm_free()
    return dict(vocab=vocab, steps=steps, wall_s=wall,
                ln_vocab=float(np.log(vocab)),
                loss_first10=float(loss[:10].mean()),
                loss_last10=float(loss[-10:].mean()),
                losses_every_10=loss[::10].tolist(),
                finite=bool(np.isfinite(loss).all()))


def phase_lm_train():
    """``launch/train.py --arch qwen2-0.5b`` at its published width with
    its own dtypes (float32 parameters, bfloat16 compute), ``--batch 8
    --seq 128 --steps 40 --ckpt-every 20`` (100 and 50 before the serve
    mesh phase took their time, 60 and 30 before the row-split run of
    ``lm_train_mesh`` did): every loss finite; the means
    of the first and last 10 losses, reported and not gated (at the full
    151,936-word vocabulary the loss stays near ln V in 100 steps); the
    first 60 steps with the vocabulary cut to 512 words, whose loss must
    fall (`_lm_train_small_vocab`); 10 steps on the run's last batch,
    whose loss must fall by more than 1 (the model fits a batch); the
    step's ms (median of steps 10-39 of the trainer's own timing, each
    ending in a synchronize), tokens/s, peak device memory and
    ``train_mfu`` (``analysis.train_model_flops`` over the median step,
    over 989 TFLOP/s) beside the card's name and power limit; a profile
    of 3 more steps; then kill and resume (see `_lm_train_kill_resume`),
    gated on the run-to-run floor."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import analysis
    from repro_torch.launch import train as launcher

    smi = nvidia_smi()
    cfg = get_config("qwen2-0.5b")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = launcher.main([*TRAIN_ARGS, "--steps", "40", "--ckpt-every",
                             "20", "--ckpt-dir", os.path.join(root, "run")])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        trainer = res["trainer"]
        kinds = [(e["kind"], e["step"]) for e in trainer.events]
        _, loss, times = (np.array(c) for c in zip(*trainer.history))
        step_s = float(np.median(times[10:]))
        p90_s = float(np.percentile(times[10:], 90))
        flops = analysis.train_model_flops(cfg, 8, 128)
        step, state = trainer.train_step, res["state"]
        batch = trainer.make_batch(trainer.pipeline.batch_at(39))
        prof = _lm_train_profile(step.model, step, state, batch)
        fit = _lm_train_one_batch(step, state, batch)
        del res, trainer, step, state, batch
        _lm_free()
        witness = _lm_train_small_vocab()
        row = dict(arch="qwen2-0.5b", batch=8, seq=128, steps=len(loss),
                   wall_s=wall, step_ms_median=step_s * 1e3,
                   step_ms_p90=p90_s * 1e3, first_step_ms=times[0] * 1e3,
                   tokens_per_s=8 * 128 / step_s,
                   max_memory_allocated=peak, model_flops_per_step=flops,
                   train_mfu=flops / step_s / H100_BF16_FLOPS,
                   loss_first10=float(loss[:10].mean()),
                   loss_last10=float(loss[-10:].mean()),
                   losses_every_10=loss[::10].tolist(), events=kinds,
                   one_batch_losses=fit, vocab_512=witness, profile=prof,
                   card=smi)
        emit("lm_train", **row)
        print(f"lm_train qwen2-0.5b B 8 S 128: {row['step_ms_median']:.1f} "
              f"ms a step (median, steps 10-39), {row['tokens_per_s']:.0f} "
              f"tokens/s, train_mfu {row['train_mfu']:.4f}, max memory "
              f"{peak / 2**30:.2f} GiB, loss {row['loss_first10']:.3f} -> "
              f"{row['loss_last10']:.3f} (vocabulary 512: "
              f"{witness['loss_first10']:.3f} -> "
              f"{witness['loss_last10']:.3f}) on {smi}", flush=True)
        check(len(loss) == 40 and np.isfinite(loss).all(),
              "lm_train: a loss is not finite")
        check(witness["finite"]
              and witness["loss_last10"] < witness["loss_first10"],
              f"lm_train: at a 512-word vocabulary the loss did not fall: "
              f"{witness}")
        check(np.isfinite(fit).all() and fit[-1] < fit[0] - 1.0,
              f"lm_train: {len(fit)} steps on one batch did not fit it: "
              f"{fit}")
        check(kinds[-1] == ("checkpoint", 40)
              and ("checkpoint", 20) in kinds,
              f"lm_train: checkpoints {kinds}")
        shutil.rmtree(os.path.join(root, "run"))
        kr = _lm_train_kill_resume(root)
    emit("lm_train_resume", **kr, card=smi)
    check(kr["resumed_max_abs_diff"] <= kr["run_to_run_max_abs_diff"],
          f"lm_train: the resumed run differs by "
          f"{kr['resumed_max_abs_diff']}, more than two uninterrupted runs "
          f"({kr['run_to_run_max_abs_diff']})")


def _sharded_lane_bytes(state):
    """Bytes each lane holds at rest of a sharded state's parameters and
    AdamW moments, counted from its shards."""
    from repro_torch.optim.adamw import _leaves

    leaves = [x for t in (state.params, state.opt.mu, state.opt.nu)
              for x in _leaves(t)]
    return [sum(x.lane_bytes(i) for x in leaves)
            for i in range(len(leaves[0].shards))]


def _pooled_grad_bytes(state):
    """Bytes of the float32 pooled gradient each lane keeps in the
    partitioned step: one tensor for every distinct shard it is the first
    lane to hold (`distributed.sharding.gather_sources`)."""
    from repro_torch.distributed.sharding import gather_sources
    from repro_torch.optim.adamw import _leaves

    leaves = list(_leaves(state.params))
    out = [0] * len(leaves[0].shards)
    for s in leaves:
        for i, sl in gather_sources(s, tuple(slice(0, n) for n in s.shape)):
            out[i] += 4 * math.prod(x.stop - x.start for x in sl)
    return out


def _whole(state):
    """A state's parameters and moments as whole tensors on the card,
    gathered where sharded."""
    from repro_torch.distributed.sharding import Sharded, gather
    from repro_torch.optim.adamw import _leaves

    return [(gather(x) if isinstance(x, Sharded) else x).detach()
            for t in (state.params, state.opt.mu, state.opt.nu)
            for x in _leaves(t)]


def _leaf_paths(tree, prefix=""):
    """The paths of a tree's leaves in `adamw._leaves`'s order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _leaf_paths(t, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _update_errors(arch, a, b):
    """Each parameter's update (final less step-0 weights, the launcher's
    seed-0 draw) in the whole states ``a`` and ``b`` (`_whole`), as
    ``|update_a - update_b| / |update_b|``, the largest over the leaves
    of one name (``wq``, ``bk``, ...)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import _leaves

    model = build_model(get_config(arch), device="cpu")
    tree = model.params()
    out = {}
    for path, p0, x, y in zip(_leaf_paths(tree), _leaves(tree), a, b):
        p0 = p0.detach().to(x.device)
        ub = y - p0
        err = float((x - p0 - ub).norm() / ub.norm())
        name = path.rsplit("/", 1)[-1]
        out[name] = max(out.get(name, 0.0), err)
    del model, tree
    return out


def _max_diff(a, b):
    """The largest absolute difference over two lists of float32 tensors
    (0.0 exactly when every pair is equal)."""
    import torch

    worst = torch.zeros((), device=a[0].device)
    for x, y in zip(a, b):
        worst = torch.maximum(worst, (x - y).abs().max())
    return float(worst)


def _mesh_run(root, name, mesh, steps, extra=(), *, ckpt_every=1000,
              resume_from=None, tally=False, args=TRAIN_ARGS, cfg=None):
    """``launch/train.py`` in this process on ``--mesh mesh`` (``args``:
    qwen2-0.5b, B 8, S 128), optionally resumed from the checkpoint directory
    ``resume_from`` (linked into a directory of its own); the losses, ms
    a step (median of the steps after the first), peak memory and the
    whole final state on the card.  ``tally``: each lane's high-water of
    gathered weights (`repro_torch.testing.tally.GatherTally`).  ``cfg``:
    config fields the launcher's config takes for this run (such as
    ``seq_parallel``, which has no launcher flag, as the reference's
    launcher has none)."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.launch import train as launcher
    from repro_torch.testing.tally import GatherTally

    d = os.path.join(root, name)
    if resume_from is not None:
        shutil.copytree(resume_from, os.path.join(
            d, os.path.basename(resume_from)), copy_function=os.link)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    get_config = launcher.get_config
    if cfg:
        launcher.get_config = lambda arch: get_config(arch).scaled(**cfg)
    try:
        with (GatherTally() if tally else contextlib.nullcontext()) as count:
            res = launcher.main([*args, "--mesh", mesh, "--steps",
                                 str(steps), "--ckpt-every", str(ckpt_every),
                                 "--ckpt-dir", d, *extra])
    finally:
        launcher.get_config = get_config
    wall = time.perf_counter() - t0
    trainer, state = res["trainer"], res["state"]
    _, loss, times = (np.array(c) for c in zip(*trainer.history))
    out = dict(mesh=mesh, extra=list(extra), dir=d, wall_s=wall,
               steps=[int(e["step"]) for e in trainer.events
                      if e["kind"] == "resume"]
               + [int(trainer.history[-1][0]) + 1],
               losses=loss.tolist(),
               step_ms_median=float(np.median(times[1:])) * 1e3,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    if mesh != "1x1":
        out["lane_bytes"] = _sharded_lane_bytes(state)
    if tally:
        n = len(out["lane_bytes"])
        pooled = _pooled_grad_bytes(state)
        out["lanes"] = [dict(
            at_rest=out["lane_bytes"][i], pooled_grad=pooled[i],
            group_grad=pooled[i], gathered_high=count.high[i],
            gathers=count.calls[i],
            counted_high=out["lane_bytes"][i] + 2 * pooled[i]
            + count.high[i]) for i in range(n)]
    whole = _whole(state)
    del res, trainer, state
    _lm_free()
    return out, whole


UPDATE_BAR = 0.1
UPDATE_BARS = {"bk": 0.75}


def _saved_by_lane(mesh_shape=(2, 2)):
    """The activations each lane of the first data group keeps for the
    backward pass of the partitioned train step, without and with
    ``cfg.seq_parallel`` (qwen2-0.5b at full width, B 8, S 128, on 4
    lanes forced onto the card), counted by
    `repro_torch.launch.dryrun.train_saved` (saved tensors by lane; the
    periods' inputs; one period's), beside the dry-run's count of the
    same cell on ``meta`` lanes.  Seeded weights (drawn on the card) and
    int32 tokens, the dry-run's stand-in dtype."""
    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import build_model

    D, M = mesh_shape
    cell = ShapeSpec("train_b8_s128", 128, 8, "train")
    meta = make_dev_mesh(mesh_shape, ("data", "model"), device="meta")
    base = get_config("qwen2-0.5b")
    out = {}
    with _forced_lanes(D * M):
        model = build_model(base, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(0))
        mesh = make_dev_mesh(mesh_shape, ("data", "model"), device="cuda")
        with sharding.use_mesh(mesh):
            specs = sharding.param_pspecs(model.params())
        params = sharding.tree_map(
            lambda x, sp: sharding.shard(x.detach(), mesh, sp),
            model.params(), specs)
        model.release()
        tokens = torch.randint(0, base.vocab_size, (8 // D, 128),
                               generator=torch.Generator().manual_seed(0))
        for tag, sp in (("2x2", False), ("2x2_sp", True)):
            cfg = base.scaled(seq_parallel=sp)
            model.cfg = cfg
            dry = dryrun.plan_cell(cfg, cell, meta)["memory"]
            card = dryrun.train_saved(model, mesh, params, {
                "tokens": tokens.to("cuda", torch.int32)})
            out[tag] = dict(card=card, dry={k: dry[k] for k in (
                "saved_bytes", "input_bytes", "period_saved_bytes",
                "activation_gb", "gathered_gb", "lane_gb", "plan")})
        del model, params
        _lm_free()
    return out


def phase_lm_train_mesh(steps=6):
    """``launch/train.py --arch qwen2-0.5b --batch 8 --seq 128 --steps 6``
    at full width on lanes forced onto the card, the partitioned sharded
    step (`distributed.partition`): ``--mesh 2x2`` (products split over
    ``model``, weights gathered a period at a time over ``data``) against
    ``--mesh 1x1 --microbatches 2`` (every loss within 5e-4 relative, the
    final parameters and moments within 6e-4, each leaf's update within
    0.1 of its norm, ``bk``'s within 0.75, as
    ``tests/test_torch_train_launch.py`` holds them); ``--mesh 2x1`` against it
    bit for bit; each lane's bytes at rest, counted from its shards, equal
    to the dry-run's count for (2, 2) at B 8, S 128; each lane's counted
    high-water (bytes at rest, the pooled and one group's float32
    gradient, the most gathered weights it held at once) and the
    process's peak (at most 14.6 GB at 2x2); then the 2x2 run's
    mid-run checkpoint resumed to the end on ``2x2`` (equal to the
    uninterrupted run bit for bit: the step repeats with no difference)
    and on ``4x1``.  Then ``2x2_sp``: the same 2x2 run with
    ``cfg.seq_parallel`` set through the config (no launcher flag, as the
    reference's launcher has none; each data group's hidden state in row
    blocks on its model lanes between blocks, a period's weights gathered
    whole), held to the 2x2 run's bars against ``1x1 --microbatches 2``
    and its bytes at rest to the dry-run's; each lane's saved
    activations of one group's pass, with and without the setting,
    counted on the card (`dryrun.train_saved`) equal to the dry-run's
    count on ``meta`` lanes, and the setting's periods' inputs a lane
    1/M of the 2x2 run's home lane's.  Six steps (ten before the step
    was partitioned and took twice as long) keep the phase near its
    earlier time."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    dry = dryrun.plan_cell(
        get_config("qwen2-0.5b"),
        ShapeSpec("train_b8_s128", 128, 8, "train"),
        make_dev_mesh((2, 2), ("data", "model"), device="meta"),
        prove=False)["memory"]["state_bytes"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root, \
            _forced_lanes(4):
        half = steps // 2
        a, whole_a = _mesh_run(root, "2x2", "2x2", steps, ckpt_every=half,
                               tally=True)
        runs = {"2x2": a}
        mb2, whole_mb2 = _mesh_run(root, "1x1_microbatches_2", "1x1", steps,
                                   ["--microbatches", "2"])
        runs["1x1_microbatches_2"] = mb2
        for name, mesh, start, vs in (
                ("2x1", "2x1", None, "1x1_microbatches_2"),
                ("resume_2x2", "2x2", half, "2x2"),
                ("resume_4x1", "4x1", half, "2x2")):
            ckpt = None if start is None else os.path.join(
                a["dir"], f"step_{start:09d}")
            run, whole = _mesh_run(root, name, mesh, steps, resume_from=ckpt)
            want = whole_a if vs == "2x2" else whole_mb2
            run["vs"] = vs
            run["max_abs_diff"] = _max_diff(want, whole)
            ref = runs[vs]["losses"][-len(run["losses"]):]
            run["loss_max_rel_diff"] = max(
                abs(x - y) / abs(y) for x, y in zip(run["losses"], ref))
            runs[name] = run
            del whole
        mb2["vs"] = "2x2"
        mb2["max_abs_diff"] = _max_diff(whole_a, whole_mb2)
        mb2["update_rel_err"] = _update_errors("qwen2-0.5b", whole_a,
                                               whole_mb2)
        mb2["loss_max_rel_diff"] = max(
            abs(x - y) / abs(y) for x, y in zip(a["losses"], mb2["losses"]))
        del whole_a
        # cfg.seq_parallel: the hidden state in row blocks on the model
        # lanes between blocks, weights gathered whole instead
        sp, whole_sp = _mesh_run(root, "2x2_sp", "2x2", steps, tally=True,
                                 cfg={"seq_parallel": True})
        sp["vs"] = "1x1_microbatches_2"
        sp["max_abs_diff"] = _max_diff(whole_mb2, whole_sp)
        sp["update_rel_err"] = _update_errors("qwen2-0.5b", whole_sp,
                                              whole_mb2)
        sp["loss_max_rel_diff"] = max(
            abs(x - y) / abs(y) for x, y in zip(sp["losses"], mb2["losses"]))
        runs["2x2_sp"] = sp
        del whole_sp, whole_mb2
        _lm_free()
        saved = _saved_by_lane()
    for r in runs.values():
        r.pop("dir")
    row = dict(arch="qwen2-0.5b", batch=8, seq=128, steps=steps,
               dryrun_state_bytes_per_lane=dry, runs=runs, saved=saved,
               seconds=time.perf_counter() - t_phase, card=smi)
    emit("lm_train_mesh", **row)
    r21, r22, r41 = (runs[k] for k in ("2x1", "resume_2x2", "resume_4x1"))
    print(f"lm_train_mesh qwen2-0.5b B 8 S 128: 2x2 {a['step_ms_median']:.1f} "
          f"ms a step, 2x1 {r21['step_ms_median']:.1f}, 1x1 microbatches 2 "
          f"{mb2['step_ms_median']:.1f}; peak 2x2 "
          f"{a['max_memory_allocated'] / 1e9:.2f} GB, 2x1 "
          f"{r21['max_memory_allocated'] / 1e9:.2f}, microbatches 2 "
          f"{mb2['max_memory_allocated'] / 1e9:.2f}; counted high-water a "
          f"lane (GB) {[round(x['counted_high'] / 1e9, 3) for x in a['lanes']]}"
          f"; bytes at rest a lane {a['lane_bytes']} (dry-run {dry}); on "
          f"{smi}", flush=True)
    check(all(b == dry for b in a["lane_bytes"]),
          f"lm_train_mesh: bytes at rest {a['lane_bytes']} != dry-run {dry}")
    check(mb2["loss_max_rel_diff"] <= 5e-4 and mb2["max_abs_diff"] <= 6e-4,
          f"lm_train_mesh: 2x2 against microbatches 2: losses "
          f"{mb2['loss_max_rel_diff']}, state {mb2['max_abs_diff']}")
    # six warmup steps move a weight by at most ~6e-5, under the state
    # bar: the updates themselves are held within a share of their norm,
    # so a missing or wrong update (an error of 1 or more) fails
    bad = {k: v for k, v in mb2["update_rel_err"].items()
           if v > UPDATE_BARS.get(k, UPDATE_BAR)}
    check(not bad, f"lm_train_mesh: 2x2's updates against microbatches "
          f"2's: {bad}")
    check(r21["losses"] == mb2["losses"] and r21["max_abs_diff"] == 0.0,
          f"lm_train_mesh: 2x1 differs from microbatches 2: {r21}")
    check(r22["steps"] == [half, steps] and r41["steps"] == [half, steps],
          f"lm_train_mesh: resumed at {r22['steps']}, {r41['steps']}")
    check(r22["losses"] == a["losses"][half:] and r22["max_abs_diff"] == 0.0,
          f"lm_train_mesh: the 2x2 resume differs from the 2x2 run: {r22}")
    check(r41["loss_max_rel_diff"] <= 1e-3,
          f"lm_train_mesh: the 4x1 resume's losses differ: {r41}")
    check(a["max_memory_allocated"] <= 14.6e9,
          f"lm_train_mesh: the 2x2 run's peak {a['max_memory_allocated']} "
          "is above 14.6 GB")
    s2, s_unset = saved["2x2_sp"], saved["2x2"]
    print(f"lm_train_mesh 2x2_sp (seq_parallel): {sp['step_ms_median']:.1f} "
          f"ms a step, peak {sp['max_memory_allocated'] / 1e9:.2f} GB, "
          f"losses within {sp['loss_max_rel_diff']:.2e} of microbatches 2, "
          f"state {sp['max_abs_diff']:.2e}; saved activations a lane "
          f"{s2['card']['saved']} (dry-run {s2['dry']['saved_bytes']}), the "
          f"periods' inputs {s2['card']['inputs']} against the 2x2 run's "
          f"{s_unset['card']['inputs']}; gathered high-water a lane "
          f"{[x['gathered_high'] for x in sp['lanes']]} (2x2 "
          f"{[x['gathered_high'] for x in a['lanes']]}); on {smi}",
          flush=True)
    check(all(b == dry for b in sp["lane_bytes"]),
          f"lm_train_mesh: 2x2_sp bytes at rest {sp['lane_bytes']} != "
          f"dry-run {dry}")
    check(sp["loss_max_rel_diff"] <= 5e-4 and sp["max_abs_diff"] <= 6e-4,
          f"lm_train_mesh: 2x2_sp against microbatches 2: losses "
          f"{sp['loss_max_rel_diff']}, state {sp['max_abs_diff']}")
    bad = {k: v for k, v in sp["update_rel_err"].items()
           if v > UPDATE_BARS.get(k, UPDATE_BAR)}
    check(not bad, f"lm_train_mesh: 2x2_sp's updates against microbatches "
          f"2's: {bad}")
    for tag, got in saved.items():
        card, meta = got["card"], got["dry"]
        check(card["saved"] == meta["saved_bytes"]
              and card["inputs"] == meta["input_bytes"]
              and card["period"] == meta["period_saved_bytes"],
              f"lm_train_mesh: {tag}'s saved activations a lane on the card "
              f"{card} differ from the dry-run's {meta}")
    M = 2
    check(all(abs(M * x - s_unset["card"]["inputs"][0])
              <= 0.01 * s_unset["card"]["inputs"][0]
              for x in s2["card"]["inputs"]),
          f"lm_train_mesh: 2x2_sp's periods' inputs a lane "
          f"{s2['card']['inputs']} are not 1/{M} of the 2x2 run's home "
          f"lane's {s_unset['card']['inputs'][0]}")


SSM_TRAIN_ARGS = ["--arch", "mamba2-130m", "--batch", "8", "--seq", "128"]
# dt_bias, one scalar a head: its gradient sums terms of both signs over
# every token and the head's channels, so bfloat16 rounding moves a larger
# share of its update (0.169 at 2x2 against microbatches 2, where one
# device without microbatches is 0.054 from it); a missing or wrong update
# is still an error of 1 or more
SSM_UPDATE_BARS = {"dt_bias": 0.3}


def _ssm_period_bytes(cfg, M, itemsize):
    """The bytes of one Mamba2 block a lane gathers at ``M`` lanes over
    ``model`` in ``heads`` mode (``ln`` whole; the ``z``, ``x`` and ``dt``
    columns of its heads and all of ``B`` and ``C`` of ``in_proj``; its
    heads' ``x`` channels and all ``B``/``C`` ones of ``conv``; ``1/M``
    of ``out_proj``, the per-head leaves and ``ssm_norm``), and of the
    whole block."""
    from repro_torch.models import mamba2

    d_in, H, P, N, conv_dim = mamba2._dims(cfg)
    d, W = cfg.d_model, cfg.ssm_conv
    whole = (d + d * (2 * d_in + 2 * N + H) + W * conv_dim + 3 * H + d_in
             + d_in * d)
    dm, Hm = d_in // M, H // M
    share = (d + d * (2 * dm + 2 * N + Hm) + W * (dm + 2 * N) + 3 * Hm + dm
             + dm * d)
    return share * itemsize, whole * itemsize


def phase_lm_train_mesh_ssm(steps=4):
    """``launch/train.py --arch mamba2-130m --batch 8 --seq 128 --steps 4``
    at its published width (24 layers, d 768, 24 SSM heads of 64, state
    128, 50,280 words) on 4 lanes forced onto the card: ``--mesh 2x2``,
    whose Mamba2 blocks split by head over ``model`` (12 heads a lane;
    `distributed.partition`), against ``--mesh 1x1 --microbatches 2``
    with ``lm_train_mesh``'s bars (every loss within 5e-4 relative, the
    final parameters and moments within 6e-4, each leaf's update within
    0.1 of its norm, ``dt_bias``'s within 0.3: `SSM_UPDATE_BARS`), and
    ``--mesh 1x1`` against it as the bfloat16 floor of those differences
    (reported); ``--mesh 2x1`` against it bit for bit; each lane's
    bytes at rest equal to the dry-run's count for (2, 2) at B 8, S 128;
    each lane's gathered bytes for one Mamba2 period (counted by the
    plan) equal to its share and below the whole block's.  Reported, not
    gated: ms a step, peak memory, the card."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed import partition
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    cfg = get_config("mamba2-130m")
    dry = dryrun.plan_cell(
        cfg, ShapeSpec("train_b8_s128", 128, 8, "train"),
        make_dev_mesh((2, 2), ("data", "model"), device="meta"),
        prove=False)["memory"]["state_bytes"]
    share, block = _ssm_period_bytes(cfg, 2, cfg.compute_dtype.itemsize)
    periods = {}
    period = partition.GroupPlan._period

    def count_period(plan, ptree, seq):
        before = list(plan.gathered)
        out = period(plan, ptree, seq)
        for m, lane in enumerate(plan.lanes):
            periods.setdefault(lane, plan.gathered[m] - before[m])
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ssm_") as root, \
            _forced_lanes(4):
        partition.GroupPlan._period = count_period
        try:
            a, whole_a = _mesh_run(root, "2x2", "2x2", steps, tally=True,
                                   args=SSM_TRAIN_ARGS)
        finally:
            partition.GroupPlan._period = period
        mb2, whole_mb2 = _mesh_run(root, "1x1_microbatches_2", "1x1", steps,
                                   ["--microbatches", "2"],
                                   args=SSM_TRAIN_ARGS)
        r21, whole_21 = _mesh_run(root, "2x1", "2x1", steps,
                                  args=SSM_TRAIN_ARGS)
        r21["max_abs_diff"] = _max_diff(whole_mb2, whole_21)
        del whole_21
        # the bfloat16 floor: the one-device step without microbatches
        # against it, the same sums rounded in another order
        r11, whole_11 = _mesh_run(root, "1x1", "1x1", steps,
                                  args=SSM_TRAIN_ARGS)
        r11["update_rel_err"] = _update_errors("mamba2-130m", whole_11,
                                               whole_mb2)
        r11["max_abs_diff"] = _max_diff(whole_11, whole_mb2)
        r11["loss_max_rel_diff"] = max(
            abs(x - y) / abs(y) for x, y in zip(r11["losses"], mb2["losses"]))
        del whole_11
        mb2["max_abs_diff"] = _max_diff(whole_a, whole_mb2)
        mb2["update_rel_err"] = _update_errors("mamba2-130m", whole_a,
                                               whole_mb2)
        mb2["loss_max_rel_diff"] = max(
            abs(x - y) / abs(y) for x, y in zip(a["losses"], mb2["losses"]))
        del whole_a, whole_mb2
        _lm_free()
    runs = {"2x2": a, "1x1_microbatches_2": mb2, "2x1": r21, "1x1": r11}
    for r in runs.values():
        r.pop("dir")
    lanes = sorted(periods)
    row = dict(arch="mamba2-130m", batch=8, seq=128, steps=steps,
               dryrun_state_bytes_per_lane=dry, runs=runs,
               mamba_period_gathered_bytes=[periods[i] for i in lanes],
               mamba_period_share_bytes=share,
               mamba_block_whole_bytes=block,
               seconds=time.perf_counter() - t_phase, card=smi)
    emit("lm_train_mesh_ssm", **row)
    print(f"lm_train_mesh_ssm mamba2-130m B 8 S 128: 2x2 "
          f"{a['step_ms_median']:.1f} ms a step, 1x1 microbatches 2 "
          f"{mb2['step_ms_median']:.1f}, 2x1 {r21['step_ms_median']:.1f}, "
          f"1x1 {r11['step_ms_median']:.1f}; "
          f"peak 2x2 {a['max_memory_allocated'] / 1e9:.2f} GB, microbatches "
          f"2 {mb2['max_memory_allocated'] / 1e9:.2f}; a Mamba2 period "
          f"gathered a lane {row['mamba_period_gathered_bytes']} B of the "
          f"whole block's {block}; bytes at rest a lane {a['lane_bytes']} "
          f"(dry-run {dry}); on {smi}", flush=True)
    check(all(b == dry for b in a["lane_bytes"]),
          f"lm_train_mesh_ssm: bytes at rest {a['lane_bytes']} != dry-run "
          f"{dry}")
    check(len(lanes) == 4 and all(periods[i] == share < block
                                  for i in lanes),
          f"lm_train_mesh_ssm: a Mamba2 period's gathered bytes "
          f"{periods} against the share {share} (whole block {block})")
    check(mb2["loss_max_rel_diff"] <= 5e-4 and mb2["max_abs_diff"] <= 6e-4,
          f"lm_train_mesh_ssm: 2x2 against microbatches 2: losses "
          f"{mb2['loss_max_rel_diff']}, state {mb2['max_abs_diff']}")
    bad = {k: v for k, v in mb2["update_rel_err"].items()
           if v > SSM_UPDATE_BARS.get(k, UPDATE_BAR)}
    check(not bad, f"lm_train_mesh_ssm: 2x2's updates against "
          f"microbatches 2's: {bad}")
    check(r21["losses"] == mb2["losses"] and r21["max_abs_diff"] == 0.0,
          f"lm_train_mesh_ssm: 2x1 differs from microbatches 2: {r21}")


SERVE_MESH_BAR = 2e-3            # lm_full_width's decode-vs-forward bar
# bfloat16 compute and cache: one bfloat16 step of the largest logit is
# 3.9e-3 of it, and the meshes' sums in another order read 1.41e-2
# (qwen2-0.5b) and 2.19e-2 (mamba2-130m) of it; a wrong lane gives O(1)
SERVE_MESH_BF16_BAR = 5e-2
# a prompt of 12 (16 before the 2x2_sp run of lm_train_mesh took its time)
SERVE_ROWS, SERVE_PROMPT, SERVE_GEN, SERVE_CACHE = 8, 12, 8, 64


def _serve_run(model, feed, mesh=None, rows=slice(None)):
    """``SERVE_PROMPT + SERVE_GEN`` decode steps of ``model`` (one device,
    or partitioned over ``mesh``) on rows ``rows``: step ``t`` takes
    ``feed[t]``, or, past the end of ``feed``, the step's own greedy
    token.  Returns every step's logits (float32, on the CPU), the tokens
    fed, the greedy tokens from the prompt's last step on, the ms of each
    step after the prompt, the cache, and the prefill step's tokens on
    the prompt."""
    import torch

    from repro_torch.train import make_prefill_step, make_serve_step

    prompt = {"tokens": torch.cat(feed[:SERVE_PROMPT], 1)[rows].cuda()}
    B = prompt["tokens"].shape[0]
    # bfloat16 compute keeps the default bfloat16 cache; float32 compute
    # a float32 one, whose rounding would otherwise turn a float32
    # difference into a bfloat16 bit of a cached key
    cache = model.init_cache(B, SERVE_CACHE, dtype=model.cfg.compute_dtype)
    pre = make_prefill_step(model, mesh)(prompt)
    serve = make_serve_step(model, mesh)
    logits, fed, greedy, ms = [], [], [], []
    nxt = None
    for t in range(SERVE_PROMPT + SERVE_GEN):
        tok = feed[t][rows] if t < len(feed) else nxt
        fed.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mesh is None:
            lg, cache = model.decode_step(cache, tok.cuda())
            nxt = torch.argmax(lg, -1)[:, None]
        else:
            cache, nxt, lg = serve(cache, tok.cuda(), logits=True)
        nxt = nxt.cpu()
        if t >= SERVE_PROMPT:
            ms.append((time.perf_counter() - t0) * 1e3)
        if t >= SERVE_PROMPT - 1:
            greedy.append(nxt)
        logits.append(lg.float().cpu())
    return dict(logits=torch.stack(logits, 1), fed=fed,
                greedy=torch.cat(greedy, 1), ms=ms, cache=cache,
                prefill=pre.cpu())


def _cache_lane_bytes(cache, n):
    """Bytes each of ``n`` lanes holds at rest of a sharded cache."""
    from repro_torch.distributed.sharding import Sharded

    out = [0] * n

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif isinstance(t, Sharded):
            for i in range(n):
                out[i] += t.lane_bytes(i)
    walk(cache)
    return out


def phase_lm_serve_mesh():
    """The partitioned serve steps (``make_serve_step(model, mesh)``,
    ``make_prefill_step(model, mesh)``) at full width on lanes forced onto
    the card: qwen2-0.5b with its default dtypes (float32 weights,
    bfloat16 compute and cache), seed-0 weights, 8 rows, a cache of 64
    positions, a prompt of 12 fed through the decode step, then 8 greedy
    steps, on one device and on ``2x2`` (heads form: 7 query heads and 1
    KV head a lane), ``1x4`` (sequence form: 2 KV heads do not divide 4,
    16 positions a lane) and ``2x1``; the same in float32 (TF32 off) on
    ``2x2`` and ``1x4``; mamba2-130m in both dtypes on ``2x2`` (12 heads
    a lane, the conv state's regions across shards).  The meshes take one
    device's tokens (teacher-forced).  Logits within ``bar`` x max
    |logit| of one device's: 2e-3 in float32 (``lm_full_width``'s bar),
    5e-2 in bfloat16 (`SERVE_MESH_BF16_BAR`).  Greedy tokens: at every
    step the mesh's token is one device's top token or scores within 2 x
    bar x max |logit| of it on one device; they are equal wherever one
    device's top-2 gap exceeds that, which must hold for most steps.  The
    prefill's
    tokens equal; each lane's cache bytes, counted from its
    shards, equal the dry-run's count for that mesh (the default dtypes:
    the float32 runs keep a float32 cache); ``2x1`` equal bit
    for bit to one device on each half of the rows.  Reports ms a decode
    step and tokens/s (not gated: host-bound)."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import build_model

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    rows = []
    prev = torch.backends.cuda.matmul.allow_tf32
    for arch, dtypes, shapes in (
            ("qwen2-0.5b", None, ((2, 2), (1, 4), (2, 1))),
            ("qwen2-0.5b", LM_F32, ((2, 2), (1, 4))),
            ("mamba2-130m", None, ((2, 2),)),
            ("mamba2-130m", LM_F32, ((2, 2),))):
        cfg = get_config(arch)
        if dtypes is not None:
            cfg = cfg.scaled(dtypes=dtypes)
        # float32 runs with TF32 off, as lm_full_width holds its bar
        torch.backends.cuda.matmul.allow_tf32 = prev and dtypes is None
        rng = np.random.default_rng(0)
        prompt = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (SERVE_ROWS, SERVE_PROMPT)))
        feed = [prompt[:, t:t + 1] for t in range(SERVE_PROMPT)]

        def build():
            return build_model(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))

        # one device generates; its tokens are every other run's feed
        one = _serve_run(build(), feed)
        feed = one["fed"]
        _lm_free()
        scale = float(one["logits"].abs().max())
        # one device's logits at the steps that chose the greedy tokens
        gen = one["logits"][:, SERVE_PROMPT - 1:]
        top2 = torch.topk(gen, 2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        bar = SERVE_MESH_BAR if dtypes is not None else SERVE_MESH_BF16_BAR
        base = dict(arch=arch, dtypes=list(cfg.dtypes), rows=SERVE_ROWS,
                    prompt=SERVE_PROMPT, gen=SERVE_GEN, cache=SERVE_CACHE,
                    card=smi, max_abs_logit=scale, logits_bar=bar,
                    float32=dtypes is not None)
        rows.append(dict(base, mesh="1x1", ms_per_step=float(
            np.mean(one["ms"])), tokens_per_s=SERVE_ROWS * 1e3 / float(
            np.mean(one["ms"]))))
        emit("lm_serve_mesh", **rows[-1])
        for shape in shapes:
            name = "x".join(map(str, shape))
            with _forced_lanes(4):
                mesh = make_dev_mesh(shape, ("data", "model"))
                got = _serve_run(build(), feed, mesh)
            diff = (got["logits"] - one["logits"]).abs()
            rel = float(diff.max()) / scale
            same = got["greedy"] == one["greedy"]
            clear = gap > 2 * bar * scale
            # the mesh's token as one device scores it, below one device's top
            short = top2[..., 0] - torch.gather(gen, -1, got["greedy"][
                ..., None])[..., 0]
            dry = dryrun.plan_cell(
                cfg, ShapeSpec("lm_serve_mesh", SERVE_CACHE, SERVE_ROWS,
                               "decode"),
                make_dev_mesh(shape, ("data", "model"), device="meta"),
                prove=False)["memory"]["cache_bytes"]
            lanes = _cache_lane_bytes(got["cache"], mesh.size)
            k0 = got["cache"]["stacks"]["s0"][0]["b0"]["mixer"]
            row = dict(base, mesh=name, logits_rel=rel,
                       tokens_equal=bool(torch.equal(got["greedy"],
                                                     one["greedy"])),
                       tokens_equal_where_clear=bool((same | ~clear).all()),
                       clear_steps=int(clear.sum()),
                       steps=int(same.numel()),
                       token_shortfall_max=float(short.max()),
                       prefill_equal=bool(torch.equal(got["prefill"],
                                                      one["prefill"])),
                       cache_lane_bytes=lanes, dry_run_cache_bytes=dry,
                       ms_per_step=float(np.mean(got["ms"])),
                       tokens_per_s=SERVE_ROWS * 1e3 / float(
                           np.mean(got["ms"])))
            if "k" in k0:
                row["positions_a_lane"] = int(k0["k"].shards[0].shape[1])
            if shape == (2, 1):
                halves = [_serve_run(build(), feed, rows=slice(a, b))
                          for a, b in ((0, SERVE_ROWS // 2),
                                       (SERVE_ROWS // 2, SERVE_ROWS))]
                row["bit_equal_to_halves"] = bool(
                    torch.equal(got["logits"], torch.cat(
                        [h["logits"] for h in halves]))
                    and torch.equal(got["prefill"], torch.cat(
                        [h["prefill"] for h in halves])))
            rows.append(row)
            emit("lm_serve_mesh", **row)
            del got
            _lm_free()
    torch.backends.cuda.matmul.allow_tf32 = prev
    seconds = time.perf_counter() - t_phase
    emit("lm_serve_mesh_summary", seconds=seconds, card=smi)
    for r in rows:
        if r["mesh"] == "1x1":
            continue
        what = f"lm_serve_mesh: {r['arch']} {r['dtypes']} {r['mesh']}"
        check(r["logits_rel"] < r["logits_bar"],
              f"{what} logits {r['logits_rel']} of max from one device's "
              f"(bar {r['logits_bar']})")
        check(r["token_shortfall_max"] <= 2 * r["logits_bar"]
              * r["max_abs_logit"],
              f"{what} a greedy token scores {r['token_shortfall_max']} "
              f"below one device's top")
        check(r["tokens_equal_where_clear"]
              and 2 * r["clear_steps"] > r["steps"],
              f"{what} greedy tokens: {r['clear_steps']} of {r['steps']} "
              f"steps clear of the bar, equal there: "
              f"{r['tokens_equal_where_clear']}")
        check(r["prefill_equal"], f"{what} prefill tokens differ")
        # the dry-run counts the default bfloat16 cache
        check(r["float32"] or all(b == r["dry_run_cache_bytes"]
                                       for b in r["cache_lane_bytes"]),
              f"{what} cache bytes a lane {r['cache_lane_bytes']} != the "
              f"dry-run's {r['dry_run_cache_bytes']}")
        if r["mesh"] == "1x4":
            check(r["positions_a_lane"] == SERVE_CACHE // 4,
                  f"{what} a lane holds {r['positions_a_lane']} positions")
        if r["mesh"] == "2x1":
            check(r["bit_equal_to_halves"],
                  f"{what} != one device on each half of the rows")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    ref_dir = os.path.join(src, "repro_torch", "data", "reference")
    record = json.load(open(os.path.join(ref_dir, "spca_run_nytimes.json")))
    srecord = json.load(open(os.path.join(
        ref_dir, "spca_run_nytimes_streaming.json")))
    vrecord = json.load(open(os.path.join(ref_dir,
                                          "serve_topics_nytimes.json")))
    drecord = json.load(open(os.path.join(ref_dir,
                                          "dense_blocks_nytimes.json")))

    phase_env()
    clock = sm_clock_hz()       # the SM clock of the chain bounds (K1, K7)
    # slice (a): the dense fit and K1
    worst, chaotic_dX = phase_kernel_parity()
    corpus, results, fit_counts, shapes = phase_fit(record)
    phase_fit_jnp(record, corpus)
    shapes_b = phase_fit_batched(record)
    for name, err in phase_kernel_parity_fit({
            "single": sorted(set(shapes["single"] + shapes_b["single"])),
            "batched": shapes_b["batched"]}).items():
        worst[name] = max(worst[name], err)
    worst["float64"] = max(worst["float64"], phase_large_n(corpus))
    row = phase_timing(corpus, results, clock)
    worst["float32"] = max(worst["float32"], row["max_abs_dX"])
    shape_rows = phase_fit_shape_timing(corpus, shapes["single"], clock)
    phase_profile(corpus)
    # the lambda-grid probe (K1, one launch a search) and the device grid
    # (K1, one launch a lane)
    probe = phase_grid_probe(record, corpus)
    grid_k1 = phase_device_grid(corpus, results)
    # slice (d): the dense row-block pipeline (K5, K6) and the per-row
    # solver (K7), on the dense cell's corpus
    dense = phase_dense_blocks(drecord, corpus)
    phase_dense_pass_profile(corpus, dense)
    d_worst, d_rerun, k7_by_dtype = phase_dense_kernel_parity(corpus, dense)
    row_counts, qp_sizes = phase_fit_per_row(record, corpus)
    drow = phase_dense_timing(corpus, dense, clock, qp_sizes)
    dense_counts = dense["counts"]
    del dense
    # slice (b): the out-of-core fit and K2, K3
    import numpy as np

    from repro_torch.core import SPCAConfig
    from repro_torch.sparse import SparseCorpus

    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store_dir:
        s_corpus, s_counts = phase_fit_streaming(srecord, store_dir)
        store = SparseCorpus.open(store_dir)
        exact = s_corpus.column_stats_exact()
        sups = _csr_supports(exact[1].astype(np.float32),
                             SPCAConfig(max_sweeps=8, lam_search_evals=8))
        check(sups["union"].size == srecord["ingest"]["gram_pass_n_hat"][0],
              "the union support differs from the record's Gram pass")
        csr_worst, csr_rerun, first_mb = phase_csr_kernel_parity(store, sups)
        phase_ingest_passes(s_corpus, store, sups["union"], exact)
        trow = phase_csr_timing(store, sups["union"], first_mb)
        del store
        # slice (e): kill-and-resume of the streaming fit on the same store
        phase_resume_streaming(srecord, store_dir, sups["union"])
        # the lane mesh: the passes (K2, K3 on every lane) and the fit
        mesh = phase_mesh_streaming(srecord, store_dir, sups["union"])
    del s_corpus
    # slice (c): serving and K4
    served = phase_serve(vrecord)
    p_worst, p_rerun = phase_project_parity(vrecord, served["queries"])
    prow = phase_project_timing(vrecord, served["queries"])
    phase_serve_split(served["version"], served["queries"])
    phase_export(served)
    phase_baselines(corpus, results)
    phase_per_row_profile(corpus)
    del corpus
    # the LM serving path (no kernel of its own: plain torch products)
    phase_lm_record()
    phase_lm_full_width()
    phase_lm_serve()
    # the LM training path (no kernel of its own either)
    phase_lm_train_record()
    phase_lm_train_full_width()
    phase_lm_train()
    # the sharded train step on a 2x2 lane mesh (no kernel of its own):
    # qwen2-0.5b, then mamba2-130m with its blocks split by head
    phase_lm_train_mesh()
    phase_lm_train_mesh_ssm()
    # the partitioned serve steps on 2x2, 1x4 and 2x1 lane meshes
    phase_lm_serve_mesh()
    kernels = [{
        "name": "bcd_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bcd_fused.cu",
        "replaces": "src/repro/kernels/bcd_fused.py:116",
        "launches": fit_counts["kernel_launches"],
        "max_abs_err": max(worst.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, **{k: row[k] for k in DEVICE_KEYS},
        "new_path_launches": {"grid_probe_fit": probe["k1"],
                              "grid_probes": probe["probe_k1"],
                              "device_grid": grid_k1},
    }]
    for name, replaces in (("csr_stats", "src/repro/kernels/csr_stats.py:43"),
                           ("csr_gram", "src/repro/kernels/csr_gram.py:53")):
        t = trow[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": s_counts[name],
            "max_abs_err": csr_worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in DEVICE_KEYS},
            "new_path_launches": (
                {"mesh_screen_pass": mesh["k2"], "mesh_fit": mesh["fit_k2"]}
                if name == "csr_stats" else
                {"mesh_gram_pass": mesh["k3"], "mesh_fit": mesh["fit_k3"]})})
    p64 = prow[64]
    kernels.append({
        "name": "sparse_project", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/project.cu",
        "replaces": "src/repro/kernels/project.py:39",
        "launches": served["k4_launches"], "max_abs_err": p_worst,
        "ms": p64["ms"], "plain_ms": p64["plain_ms"],
        "bound_ms": p64["bound_ms"], "bound_by": p64["bound_by"],
        "library_ms": p64["library_ms"], **{k: p64[k] for k in DEVICE_KEYS}})
    for name, replaces, launches, t in (
            ("column_stats", "src/repro/kernels/variance.py:19",
             dense_counts["column_stats"], drow["column_stats"]),
            ("gram", "src/repro/kernels/gram.py:18", dense_counts["gram"],
             drow["gram"]),
            ("qp_sweeps", "src/repro/kernels/bcd_sweep.py:30",
             row_counts["qp_sweeps"], drow["qp_sweeps_n192"])):
        source = {"column_stats": "variance", "gram": "gram",
                  "qp_sweeps": "bcd_sweep"}[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": d_worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in DEVICE_KEYS}})
    emit("kernels", table=[
        {**kernels[0], "replaces_also": "src/repro/kernels/bcd_fused.py:197",
         "max_abs_err_by_dtype": worst, "chaotic_case_max_abs_dX": chaotic_dX,
         "n_hat": row["n_hat"],
         "fit_shapes": [{k: r[k] for k in (
             "n_hat", "launch", "ms", "device_ms", "bound_ms", "bound_by")}
             for r in shape_rows]},
        {**kernels[1], "run_to_run_max_abs_diff": csr_rerun["csr_stats"],
         "library": trow["csr_stats"]["library"]},
        {**kernels[2], "replaces_also": "src/repro/kernels/csr_gram.py:126",
         "run_to_run_max_abs_diff": csr_rerun["csr_gram"],
         "library": trow["csr_gram"]["library"],
         "single_chunk": {k: trow["csr_gram_c1"][k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             *DEVICE_KEYS)}},
        {**kernels[3], "run_to_run_max_abs_diff": p_rerun,
         "library": p64["library"],
         "launch_floor_device_ms": p64["launch_floor_device_ms"],
         "batch_512": {k: prow[512][k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             *DEVICE_KEYS)}},
        {**kernels[4], "run_to_run_max_abs_diff": d_rerun["column_stats"],
         "library": drow["column_stats"]["library"],
         "shape": drow["column_stats"]["shape"]},
        {**kernels[5], "run_to_run_max_abs_diff": d_rerun["gram"],
         "library": drow["gram"]["library"], "shape": drow["gram"]["shape"],
         "n_hat_2048": {k: drow["gram_2048"][k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             *DEVICE_KEYS)}},
        {**kernels[6], "run_to_run_max_abs_diff": d_rerun["qp_sweeps"],
         "max_abs_err_by_dtype": k7_by_dtype, "n": 192,
         "scheme": drow["qp_sweeps_n192"]["scheme"],
         "per_row_n_hat": [{k: drow[f"qp_sweeps_n{n}"][k] for k in (
             "n", "ms", "device_ms", "bound_ms")}
             for n in sorted(set(qp_sizes) | {48, 192})]}])
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
