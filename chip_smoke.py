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
  equal to its launches, docs/s beside the run without the exporter.

Each phase prints one JSON line; a failed check raises, so the script
exits non-zero.  The last lines are the kernel table, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import json
import os
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
    del s_corpus
    # slice (c): serving and K4
    served = phase_serve(vrecord)
    p_worst, p_rerun = phase_project_parity(vrecord, served["queries"])
    prow = phase_project_timing(vrecord, served["queries"])
    phase_serve_split(served["version"], served["queries"])
    phase_export(served)
    phase_per_row_profile(corpus)
    del corpus
    kernels = [{
        "name": "bcd_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bcd_fused.cu",
        "replaces": "src/repro/kernels/bcd_fused.py:116",
        "launches": fit_counts["kernel_launches"],
        "max_abs_err": max(worst.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, **{k: row[k] for k in DEVICE_KEYS},
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
            **{k: t[k] for k in DEVICE_KEYS}})
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
