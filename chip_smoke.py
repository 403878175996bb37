#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the same inputs, drives the
dense sparse-PCA fit (``repro_torch.launch.spca_run``) at NYTimes width
(102,660 words, 30,000 docs, 5 components, target cardinality 5),
checks its supports against the reference record in
``src/repro_torch/data/reference/spca_run_nytimes.json``, holds the
kernel to its plain version again at every shape the fits launched it
with, and runs the batched solve at NYTimes' and PubMed's largest
reduced sizes.  Each phase prints one
JSON line; a failed check raises, so the script exits non-zero.  The
last lines are the kernel table, the card's name and power limit, and
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores, SXM data sheet
H100_F64_FLOPS = 34e12          # float64 outside the tensor cores, SXM data sheet
H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
FIT_ARGS = ["--corpus", "nytimes", "--docs", "30000", "--components", "5",
            "--target-card", "5"]


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
    built = _build.build(["bcd_fused"])
    wall = time.perf_counter() - t0
    log = os.path.join(_build.BUILD_DIR, "bcd_fused.log")
    ptxas = []
    if os.path.exists(log):
        ptxas = [ln.strip() for ln in open(log)
                 if "registers" in ln or "spill" in ln]
    emit("env", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         build_s=round(wall, 3), built=sorted(built), ptxas=ptxas)


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


def phase_profile(corpus):
    """Where the fit's time goes: the default fit under torch.profiler,
    device time by kernel and the device's busy share of the fit's wall
    time (host clock, profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _fit_direct(corpus, "auto")
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3, e.count, e.key[:90]))
    kernels.sort(reverse=True)
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
    record = json.load(open(os.path.join(
        src, "repro_torch", "data", "reference", "spca_run_nytimes.json")))

    phase_env()
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
    emit("kernels", table=[{
        **kernels[0], "replaces_also": "src/repro/kernels/bcd_fused.py:197",
        "max_abs_err_by_dtype": worst, "chaotic_case_max_abs_dX": chaotic_dX}])
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
