#!/usr/bin/env python3
"""Where the time of the port's kernels goes, phase by phase, on one card.

    python3 scripts/phase_trace.py [k1] [k2] [k3] [k6] [k7]    (default: all)

``ncu`` and ``nsys`` do not run where the card is, so this builds
instrumented copies of the kernels' sources (into
``src/repro_torch/kernels/build/trace/``; the package's own libraries are
not touched) that define their phase marks: ``GRAM_TRACE`` in K3 and K6
(``csrc/gram_tc.cuh``), ``PHASE_*`` in K1, K2 and K7
(``csrc/phase_trace.cuh``).  One thread of every unit (a CTA; in K1 a
problem) records the SM clock and the global timer.  Each kernel runs a
few times on the same inputs and the last launch's records are read back.
Times are in microseconds, SM clock cycles at the card's maximum clock.

* K6 ``gram`` at (256, 500) (the dense-block path's shape) with the
  rows split as its plan splits them and in 1 and 2 slabs, and at
  (256, 2048): phases ``loop`` (panels copied and contracted),
  ``cluster_sum`` (the partials added across the cluster), ``write``;
  per phase the p50, p90 and largest time since the CTA's start.
* K3 ``csr_gram`` and K2 ``csr_stats`` on the first megabatch of a CSR
  store of a generated NYTimes-width corpus (12,000 docs; the launcher's
  pass geometry, C 8, E 16,384, R 512), K3 at its 220 highest-variance
  words: K3's phases ``scan`` (the panels zeroed, the entries streamed
  and added), ``contract``, ``cluster_sum``, ``finish`` (the slabs'
  strips added and written); K2's ``scatter`` (entries added to the CTA's
  table of columns, or straight to the accumulator), ``flush`` (the
  table's sums added to the accumulator), ``grid_sync`` (every CTA's
  adds done) and ``finish`` (its slice of columns rounded to float32 and
  zeroed), each the p50, p90 and largest time since the CTA's start.
* K1 ``bcd_fused`` on the dense fit's problems (Sigma_hat over the
  corpus's n highest-variance words at the lambda keeping exactly them,
  identity start, float32, 4 QP passes, 80 tau steps at most) at n_hat
  48 and 192, as the fused solve (8 sweeps) and the fallback's one-sweep
  launch, and one sweep at n 500 (the ``global`` scheme, as
  ``chip_smoke.py`` ``large_n`` runs it): per problem the time summed
  over the solve in ``qp`` (the box
  QP's coordinate chain), ``tau`` (R2 and the bisection), ``matvec`` (w0
  = Y s), ``objective`` (F each sweep) and ``row_rest`` (trace, c, s and
  the write-back), the bisection steps taken per row update, and the QP's
  ns a coordinate step (``qp`` over sweeps x n x 4 x (n - 1) steps).
* K7 ``bcd_sweep`` (one warp, ``warp`` scheme) on a row update of the
  same Sigma_hat at n 48 and 192 (row and column 0 zeroed, s its column
  0, lam a quarter of max |s|, float32, 4 sweeps, as ``chip_smoke.py``
  ``dense_timing`` runs it): ``issue`` (the mbarrier set, Y's bulk copy
  issued, u0, s and Y's unaligned edges loaded), ``copy_wait`` (waiting
  for Y's copy to land), ``matvec`` (w0 = Y u0, row j of the copy
  zeroed),
  ``qp`` (the coordinate chain; its ns a step over 4 x (n - 1) steps,
  beside K1's at the same n when both are traced), ``r2_write`` (R2
  and the outputs written), and the launch's span on the SM clock.

Each instrumented kernel's result is held to the package's kernel or its
plain version (exact where the inputs are counts; K7's ``warp`` scheme to
its ``block`` scheme, bit for bit on w and R2); the script fails if one
disagrees.  Measured on the card, not in the package: the clock reads
and the records' stores are added to every unit.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK_QUERY = ["nvidia-smi", "--query-gpu=clocks.max.sm",
               "--format=csv,noheader,nounits"]
UNITS, COLS = 16384, 16

RECORDER = '''
__device__ unsigned long long g_trace[16384][16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int trace_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
extern "C" int trace_clear() {
  void* p;
  cudaError_t e = cudaGetSymbolAddress(&p, g_trace);
  return (int)(e ? e : cudaMemset(p, 0, sizeof(g_trace)));
}
// columns: 0 start, 1 the last mark (global timer), 2..13 the phases
// (SM clock); K3's and K6's marks keep the CTA's start clock in 14
__device__ __forceinline__ void phase_start(int unit) {
  unsigned long long* r = g_trace[unit];
  r[0] = gtime();
  r[14] = clock64();
}
__device__ __forceinline__ void phase_mark(int unit, int col) {
  unsigned long long* r = g_trace[unit];
  r[col] = clock64() - r[14];
  r[1] = gtime();
}
// K1 and K2: the unit's start clock and its last span's end live in
// registers (PHASE_START declares them), and a span is added with a
// fire-and-forget atomic, so a mark waits on no load
#define PHASE_START(who, unit)                                   \
  unsigned long long _phase_t0 = clock64(), _phase_prev = _phase_t0; \
  if (who) g_trace[unit][0] = gtime()
#define PHASE_MARK(who, unit, col)                               \
  do {                                                           \
    if (who) {                                                   \
      g_trace[unit][col] = clock64() - _phase_t0;                \
      g_trace[unit][1] = gtime();                                \
    }                                                            \
  } while (0)
#define PHASE_SPAN(who, unit, col)                               \
  do {                                                           \
    const unsigned long long _t = clock64();                     \
    if (who) atomicAdd(&g_trace[unit][col], _t - _phase_prev);   \
    _phase_prev = _t;                                            \
  } while (0)
#define PHASE_COUNT(who, unit, col, n)                           \
  do {                                                           \
    if (who) atomicAdd(&g_trace[unit][col], (unsigned long long)(n)); \
  } while (0)
#define GRAM_TRACE(col)                                          \\
  do {                                                           \\
    if (threadIdx.x == 0) {                                      \\
      if ((col) == 0) phase_start(blockIdx.x);                   \\
      else phase_mark(blockIdx.x, col);                          \\
    }                                                            \\
  } while (0)
'''
# the phases' columns, as the kernels' marks number them
K6_PHASES = (("loop", 2), ("cluster_sum", 3), ("write", 4))
K3_PHASES = (("scan", 2), ("contract", 3), ("cluster_sum", 4), ("finish", 5))
K2_PHASES = (("scatter", 2), ("flush", 3), ("grid_sync", 4), ("finish", 5))
K1_PHASES = (("qp", 2), ("tau", 3), ("matvec", 4), ("objective", 5),
             ("row_rest", 6))
K1_TAU_STEPS = 7                  # K1's column counting bisection steps
K1_END = 8                        # K1's end of the solve (since its start)
K7_PHASES = (("issue", 2), ("copy_wait", 3), ("matvec", 4), ("qp", 5),
             ("r2_write", 6))
K7_END = 8                        # K7's end of the launch (since its start)
SOURCES = {"k1": "bcd_fused", "k2": "csr_stats", "k3": "csr_gram",
           "k6": "gram", "k7": "bcd_sweep"}
QP_SIZES = (48, 192)              # n of K1's and K7's traced problems


def build(names):
    """Instrumented copies of ``csrc/<name>.cu`` and the shared headers,
    built by the package's own build (same flags, a library named by a
    hash of the copies) into ``build/trace/`` and loaded."""
    import ctypes
    import shutil

    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copyfile(header, out / header.name)
    for name in names:
        (out / f"{name}.cu").write_text(
            RECORDER + (_build.CSRC / f"{name}.cu").read_text())
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC = _build.BUILD_DIR = out
    try:
        _build.build(names)
        paths = {name: _build._target(name) for name in names}
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    libs = {}
    for name, path in paths.items():
        lib = libs[name] = ctypes.CDLL(str(path))
        lib.trace_read.argtypes = [ctypes.c_void_p]
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "gram":
            lib.gram_launch.argtypes = [p, i, i, i, i, p, p]
        elif name == "csr_gram":
            lib.csr_gram_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                            p, p, p, p]
    return libs


def records(lib, launch, units):
    """The records of ``units`` units after the 4th of 4 launches."""
    import numpy as np
    import torch

    for k in range(4):
        if k == 3:
            torch.cuda.synchronize()
            lib.trace_clear()
        rc = launch()
        if rc:
            raise SystemExit(f"phase_trace: launch failed ({rc})")
    torch.cuda.synchronize()
    buf = np.zeros((UNITS, COLS), np.uint64)
    lib.trace_read(buf.ctypes.data)
    return buf[:units].astype(np.int64)


def traced(lib, launch, blocks, phases, clock_hz):
    """Per phase the p50, p90 and largest time since a CTA's start (CTAs
    that never reached the mark left out), and the launch's span."""
    import numpy as np

    t = records(lib, launch, blocks)
    t = t[t[:, 0] > 0]
    out = {"span_us": float(t[:, 1].max() - t[:, 0].min()) / 1e3,
           "ctas": len(t)}
    for name, col in phases:
        us = t[:, col][t[:, col] > 0] / clock_hz * 1e6
        out[name] = ([round(float(x), 2)
                      for x in np.percentile(us, [50, 90, 100])]
                     if us.size else None)
        out[f"{name}_ctas"] = int(us.size)
    return out


def trace_k6(libs, clock_hz, dev, stream, emit):
    import numpy as np
    import torch

    from repro_torch.kernels import gram, ref

    rng = np.random.default_rng(0)
    for m, n, split in ((256, 500, None), (256, 500, 1), (256, 500, 2),
                        (256, 2048, None)):
        A = torch.from_numpy(rng.poisson(0.3, size=(m, n)).astype(
            np.float32)).to(dev)
        plan = gram.plan_gram(m, n)
        if split:
            per = -(-m // 32 // split)
            plan = dataclasses.replace(plan, split=split, slab_rows=per * 32,
                                       blocks=plan.tiles * split)
        C = torch.zeros((n, n), device=dev)

        def launch():
            return libs["gram"].gram_launch(A.data_ptr(), m, n, plan.split,
                                            plan.slab_rows, C.data_ptr(),
                                            stream)
        row = traced(libs["gram"], launch, plan.blocks, K6_PHASES, clock_hz)
        if not torch.equal(C, ref.gram_ref(A)):
            raise SystemExit("phase_trace: the traced K6 disagrees")
        emit({"kernel": "gram", "shape": [m, n], "split": plan.split, **row})


def first_megabatch(corpus, R):
    import numpy as np

    from repro_torch.sparse.store import write_corpus

    with tempfile.TemporaryDirectory(prefix="phase_trace_") as store_dir:
        mb = next(iter(write_corpus(corpus, store_dir).iter_megabatches(
            chunk_rows=R, reuse_buffers=False)))
    return (np.ascontiguousarray(mb.values, np.float32),
            np.ascontiguousarray(mb.col_ids, np.int32),
            np.ascontiguousarray(mb.seg_ids, np.int32))


def trace_k3(libs, clock_hz, dev, stream, emit, corpus, mb):
    import numpy as np
    import torch

    from repro_torch.data.bow import local_support_cols
    from repro_torch.kernels import csr_gram, ref

    n_hat, R = 220, 512
    sup = np.sort(np.argsort(-corpus.column_stats_exact()[1],
                             kind="stable")[:n_hat])
    v, loc, sg = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        mb[0], local_support_cols(sup, mb[1]).astype(np.int32), mb[2]))
    C_, E = v.shape
    plan = csr_gram.plan_csr_gram(n_hat, R, C_)
    work, counters = csr_gram.workspace(dev, stream, plan)
    G = torch.zeros((n_hat, n_hat), device=dev)

    def launch():
        return libs["csr_gram"].csr_gram_launch(
            v.data_ptr(), loc.data_ptr(), sg.data_ptr(), C_, E, R, n_hat,
            plan.slabs.bit_length() - 1, plan.panel_rows, plan.groups,
            plan.chunks_per_group, G.data_ptr(), work.data_ptr(),
            counters.data_ptr(), stream)
    row = traced(libs["csr_gram"], launch, plan.blocks, K3_PHASES, clock_hz)
    if not torch.equal(G, ref.csr_gram_batched_ref(v, loc, sg, R, n_hat)):
        raise SystemExit("phase_trace: the traced K3 disagrees")
    emit({"kernel": "csr_gram", "C": C_, "E": E, "R": R, "n_hat": n_hat,
          "slabs": plan.slabs, "groups": plan.groups, **row})


def _through_wrapper(name, lib):
    """Make the package's wrapper of ``name`` launch the traced ``lib``
    (it types the library's functions itself on first use)."""
    from repro_torch.kernels import _build

    _build._loaded[name] = lib


def trace_k2(libs, clock_hz, dev, emit, n_cols, mb):
    import torch

    from repro_torch.kernels import csr_stats, ref

    _through_wrapper("csr_stats", libs["csr_stats"])
    v, c = (torch.from_numpy(a).to(dev) for a in mb[:2])
    out = []

    def launch():
        out[:] = csr_stats.csr_column_stats_cuda(v, c, n_cols)
        return 0
    row = traced(libs["csr_stats"], launch, UNITS, K2_PHASES, clock_hz)
    want = ref.csr_column_stats_batched_ref(v, c, n_cols)
    if not all(torch.equal(a, b) for a, b in zip(out, want)):
        raise SystemExit("phase_trace: the traced K2 disagrees")
    emit({"kernel": "csr_stats", "C": v.shape[0], "E": v.shape[1],
          "n": n_cols, "real_entries": int((v != 0).sum()), **row})


def trace_k1(libs, clock_hz, dev, emit, corpus):
    import numpy as np
    import torch

    from repro_torch.core.bcd import default_beta
    from repro_torch.kernels import bcd_fused
    from repro_torch.launch.spca_run import dense_stats

    _through_wrapper("bcd_fused", libs["bcd_fused"])
    var, build_S = dense_stats(corpus, dev)
    order = np.argsort(-var, kind="stable")
    a, b = QP_SIZES
    for n, sweeps in ((a, 8), (a, 1), (b, 8), (b, 1), (500, 1)):
        S = build_S(np.sort(order[:n]))
        lam, beta = float(var[order[n]]), default_beta(S)
        X0 = torch.eye(n, device=dev)
        out = []

        def launch():
            out[:] = bcd_fused.bcd_solve_cuda(
                S, lam, beta, X0, -1.0, max_sweeps=sweeps, qp_sweeps=4,
                tau_iters=80)
            return 0
        t = records(libs["bcd_fused"], launch, 1)[0]
        row = {"kernel": "bcd_fused", "n_hat": n, "sweeps": sweeps,
               "scheme": bcd_fused.plan_fused_solve(n).scheme,
               "span_us": float(t[1] - t[0]) / 1e3,
               "solve_us": round(float(t[K1_END]) / clock_hz * 1e6, 2)}
        for name, col in K1_PHASES:
            row[f"{name}_us"] = round(float(t[col]) / clock_hz * 1e6, 2)
        row["tau_steps_per_row"] = float(t[K1_TAU_STEPS]) / (n * sweeps)
        row["qp_ns_per_step"] = row["qp_us"] * 1e3 / (sweeps * n * 4
                                                      * (n - 1))
        emit(row)


def trace_k7(libs, clock_hz, dev, emit, corpus):
    import numpy as np
    import torch

    from repro_torch.kernels import bcd_sweep
    from repro_torch.launch.spca_run import dense_stats

    _through_wrapper("bcd_sweep", libs["bcd_sweep"])
    var, build_S = dense_stats(corpus, dev)
    order = np.argsort(-var, kind="stable")
    for n in QP_SIZES:
        Y = build_S(np.sort(order[:n])).float().contiguous()
        s = Y[:, 0].clone()
        Y[0, :] = 0
        Y[:, 0] = 0
        s[0] = 0
        lam = 0.25 * float(s.abs().max())
        out = []

        def launch():
            out[:] = bcd_sweep.qp_sweep_cuda(Y, s, lam, s, 0, 4)
            return 0
        t = records(libs["bcd_sweep"], launch, 1)[0]
        block = bcd_sweep.qp_sweep_cuda(Y, s, lam, s, 0, 4, "block")
        if not (torch.equal(out[1], block[1]) and torch.equal(out[2],
                                                              block[2])):
            raise SystemExit("phase_trace: the traced K7 disagrees with "
                             "its block scheme")
        row = {"kernel": "bcd_sweep", "n": n, "sweeps": 4,
               "scheme": bcd_sweep.plan_qp_sweep(n).scheme,
               "span_us": float(t[1] - t[0]) / 1e3,
               "launch_us": round(float(t[K7_END]) / clock_hz * 1e6, 3)}
        for name, col in K7_PHASES:
            row[f"{name}_us"] = round(float(t[col]) / clock_hz * 1e6, 3)
        row["qp_ns_per_step"] = row["qp_us"] * 1e3 / (4 * (n - 1))
        emit(row)


def main(argv=None):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import json

    import torch

    want = set(argv if argv is not None else sys.argv[1:]) or set(SOURCES)
    if not want <= set(SOURCES):
        print(f"phase_trace: kernels are {sorted(SOURCES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("phase_trace: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.data.corpus import NYTIMES_TOPICS, make_corpus
    from repro_torch.kernels import _build

    def emit(row):
        print(json.dumps(row), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    clock_hz = 1e6 * float(subprocess.run(
        CLOCK_QUERY, capture_output=True, text=True,
        check=True).stdout.split()[0])
    libs = build([SOURCES[k] for k in sorted(want)])
    dev = torch.device("cuda")
    _, stream = _build.launch_on(dev)
    if "k6" in want:
        trace_k6(libs, clock_hz, dev, stream, emit)
    corpus = make_corpus(12_000, 102_660, topics=NYTIMES_TOPICS, seed=0)
    if want & {"k2", "k3"}:
        mb = first_megabatch(corpus, 512)
        if "k3" in want:
            trace_k3(libs, clock_hz, dev, stream, emit, corpus, mb)
        if "k2" in want:
            trace_k2(libs, clock_hz, dev, emit, corpus.n_words, mb)
    if "k1" in want:
        trace_k1(libs, clock_hz, dev, emit, corpus)
    if "k7" in want:
        trace_k7(libs, clock_hz, dev, emit, corpus)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
