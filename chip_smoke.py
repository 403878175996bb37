#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's three CUDA kernels from the sources in this checkout
(K1 ``bcd_fused``, K2 ``csr_stats``, K3 ``csr_gram``; one ``nvcc`` each,
all started together), holds each against its plain PyTorch version on
the same inputs, and drives both fits of ``repro_torch.launch.spca_run``
at NYTimes width (102,660 words, 5 components, target cardinality 5):

* the dense fit at 30,000 docs, against the reference record in
  ``src/repro_torch/data/reference/spca_run_nytimes.json``; K1 is held
  to its plain version again at every shape the fits launched it with,
  and the batched solve runs at NYTimes' and PubMed's largest reduced
  sizes;
* the out-of-core fit (``--streaming``) at the paper's 300,000 docs,
  from a CSR store in a temporary directory (removed at the end),
  against ``spca_run_nytimes_streaming.json``; K2 and K3 are held to
  their plain versions on real megabatches of that store, both corpus
  passes are held to exact float64 statistics of the corpus, and both
  kernels are timed at the fit's shape beside their bounds.

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
FIT_ARGS = ["--corpus", "nytimes", "--docs", "30000", "--components", "5",
            "--target-card", "5"]
STREAM_ARGS = ["--streaming", "--corpus", "nytimes", "--docs", "300000",
               "--components", "5", "--target-card", "5", "--device", "cuda"]
KERNELS = ("bcd_fused", "csr_stats", "csr_gram")
CHUNK_ROWS, MEGABATCH = 512, 8   # the launcher's default pass geometry


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
                           if "registers" in ln or "spill" in ln]
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


def _fit_direct(corpus, solver_impl):
    """The launcher's fit on an already generated corpus (the launcher's
    config and Gram), through `fit_components`."""
    import torch

    from repro_torch.core import SPCAConfig, fit_components
    from repro_torch.launch.spca_run import dense_stats

    diag = {}
    results = fit_components(
        None, 5, target_card=5, diagnostics=diag, device="cuda",
        cfg=SPCAConfig(max_sweeps=8, lam_search_evals=8,
                       solver_impl=solver_impl),
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
    """Where the fit's time goes: the default fit under torch.profiler,
    device time by kernel and the device's busy share of the fit's wall
    time (host clock, profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _fit_direct(corpus, "auto")
        wall = time.perf_counter() - t0
    kernels = _device_events(prof)
    busy_ms = sum(k[0] for k in kernels)
    emit("profile", fit_wall_s=wall, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / 1e3 / wall,
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


def phase_timing(corpus, results):
    """K1 at the fit's shape: the first PC's cold solve (n_hat from the
    fit, float32, the launcher's sweep budget, early exit on) — kernel vs
    plain version, beside its bound.  The two results are held to each
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
    ms = cuda_ms(lambda: bcd_fused.bcd_solve_cuda(S, r.lam, beta, X0, 1e-7,
                                                  **kw), 20)
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
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
    row = {"n_hat": n, "n_pad": n_pad, "sweeps": sweeps, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": ops, "library_ms": None,
           "max_abs_dX": dX, "max_abs_dF": dF, "plain_sweeps": int(kp),
           "supports_equal": supports, "ok": ok}
    emit("timing", **row)
    check(ok, "timing: kernel and plain version disagree at the fit shape")
    return row
# ---------------------------------------------------------------- streaming


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


def phase_csr_kernel_parity(store, supports):
    """K2 and K3 against their plain versions on the card, on the first
    and the ragged final megabatch of the 300k store: K2 to 1e-6 of the
    largest |sum|, K3 to 1e-6 of the largest |G|, at the fit's union
    support and the top-500 / top-2048 variance supports, and one C = 1
    ``ops.csr_gram`` call.  Each kernel also runs twice on the same
    megabatch; the run-to-run max |diff| is printed."""
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
    the already densified B (TF32 off), and the bound from this data."""
    import numpy as np
    import torch

    from repro_torch.kernels import csr_gram, ref

    C, E = v.shape
    one = C == 1
    args = (v[0], loc[0], sg[0]) if one else (v, loc, sg)
    plain_fn = ref.csr_gram_ref if one else ref.csr_gram_batched_ref
    ms = cuda_ms(lambda: csr_gram.csr_gram_cuda(*args, R, n_hat), 50)
    plain = cuda_ms(lambda: plain_fn(*args, R, n_hat), 10)
    rows = (sg.long() + R * torch.arange(C, device=v.device)[:, None]
            ).reshape(-1)
    on = (loc.reshape(-1) < n_hat) & (v.reshape(-1) != 0)
    B = torch.zeros((C * R, n_hat), device=v.device)
    B.index_put_((rows[on], loc.reshape(-1)[on].long()), v.reshape(-1)[on],
                 accumulate=True)
    with ref.full_fp32():
        lib = cuda_ms(lambda: torch.matmul(B.T, B), 50)
    k_r = torch.bincount(rows[on], minlength=C * R).cpu().numpy()
    nbytes = 3 * C * E * 4 + n_hat * n_hat * 4
    ops = int(2 * np.sum(k_r.astype(np.int64) ** 2))
    dense_ops = 2 * C * R * n_hat * n_hat
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
    return {"name": name, "C": C, "ms": ms, "plain_ms": plain,
            "library_ms": lib,
            "library": "torch.matmul(B.T, B), TF32 off: contraction only",
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops, "dense_contraction_ops": dense_ops,
            "dense_bound_ms": max(tb, dense_ops / H100_F32_FLOPS * 1e3),
            "n_hat": n_hat}


def phase_csr_timing(store, support, mb):
    """K2 and K3 at the streaming fit's shape (C = 8, E = 16,384, n =
    102,660; K3 at the union support, and at C = 1 on the batch's first
    chunk), on the first megabatch: ms per launch (CUDA events, 50
    launches), the plain version's ms, the library call's ms (K2: two
    ``index_add_``; K3: ``torch.matmul`` of the already densified B,
    TF32 off, the contraction only) and the bound: the larger of bytes
    over 3.35 TB/s and operations over 67 TFLOP/s, counted from this
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
    nbytes, ops = C * E * 8 + 2 * n * 4, 3 * real
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
    rows.append({"name": "csr_stats", "ms": ms, "plain_ms": plain,
                 "library_ms": lib, "library": "2 x index_add_ (float32)",
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

    phase_env()
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
    row = phase_timing(corpus, results)
    worst["float32"] = max(worst["float32"], row["max_abs_dX"])
    phase_profile(corpus)
    del corpus
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
    kernels = [{
        "name": "bcd_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bcd_fused.cu",
        "replaces": "src/repro/kernels/bcd_fused.py:116",
        "launches": fit_counts["kernel_launches"],
        "max_abs_err": max(worst.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
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
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    emit("kernels", table=[
        {**kernels[0], "replaces_also": "src/repro/kernels/bcd_fused.py:197",
         "max_abs_err_by_dtype": worst, "chaotic_case_max_abs_dX": chaotic_dX},
        {**kernels[1], "run_to_run_max_abs_diff": csr_rerun["csr_stats"],
         "library": trow["csr_stats"]["library"]},
        {**kernels[2], "replaces_also": "src/repro/kernels/csr_gram.py:126",
         "run_to_run_max_abs_diff": csr_rerun["csr_gram"],
         "library": trow["csr_gram"]["library"],
         "single_chunk": {k: trow["csr_gram_c1"][k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}])
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
