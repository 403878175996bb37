#!/usr/bin/env python3
"""Where the time of the tensor-core Gram kernels (K3, K6) goes, phase by
phase, on one card.

    python3 scripts/gram_phase_trace.py

``ncu`` and ``nsys`` do not run where the card is, so this builds
instrumented copies of ``csrc/gram.cu`` and ``csrc/csr_gram.cu`` (into
``src/repro_torch/kernels/build/trace/``; the package's own libraries are
not touched) that define the kernels' ``GRAM_TRACE`` phase marks: thread
0 of every CTA records the SM clock at the end of each phase and the
global timer at its start and end.  Each kernel then
runs a few times on the same inputs and the last launch's records are
read back.  Printed per phase: the p50, p90 and largest time since the
CTA's start, in microseconds (SM clock at the card's maximum clock); per
launch: the span from the first CTA's start to the last one's end.

* K6 ``gram`` at (256, 500) (the dense-block path's shape) with the
  rows split as its plan splits them and in 1 and 2 slabs, and at
  (256, 2048): phases ``loop`` (panels copied and contracted),
  ``cluster_sum`` (the partials added across the cluster), ``write``.
* K3 ``csr_gram`` on the first megabatch of a CSR store of a generated
  NYTimes-width corpus (12,000 docs; the launcher's pass geometry, C 8,
  E 16,384, R 512) at its 220 highest-variance words: phases ``scan``
  (the panels zeroed, the entries streamed and added), ``contract``,
  ``cluster_sum``, ``finish`` (the slabs' strips added and written).

Each instrumented kernel's result is held to its plain version (exact:
the inputs are integer counts); the script fails if one disagrees.
Measured on the card, not in the package: the clock reads and the
records' stores are added to every CTA.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK_QUERY = ["nvidia-smi", "--query-gpu=clocks.max.sm",
               "--format=csv,noheader,nounits"]

RECORDER = '''
__device__ unsigned long long g_trace[16384][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int trace_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
// columns: 0 start, 1 end (global timer: the last mark's), 2.. the end of
// each phase (SM clock since the CTA's start), 7 the CTA's start clock
__device__ __forceinline__ void gram_trace(int col) {
  if (threadIdx.x != 0) return;
  unsigned long long* r = g_trace[blockIdx.x];
  if (col == 0) {
    r[0] = gtime();
    r[7] = clock64();
  } else {
    r[col] = clock64() - r[7];
    r[1] = gtime();
  }
}
#define GRAM_TRACE(col) gram_trace(col)
'''
# the phases' columns, as the kernels' GRAM_TRACE marks number them
K6_PHASES = (("loop", 2), ("cluster_sum", 3), ("write", 4))
K3_PHASES = (("scan", 2), ("contract", 3), ("cluster_sum", 4), ("finish", 5))


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
        else:
            lib.csr_gram_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                            p, p, p, p]
    return libs


def traced(lib, launch, blocks, phases, clock_hz):
    import numpy as np
    import torch

    for _ in range(4):
        rc = launch()
        if rc:
            raise SystemExit(f"gram_phase_trace: launch failed ({rc})")
    torch.cuda.synchronize()
    buf = np.zeros((16384, 8), np.uint64)
    lib.trace_read(buf.ctypes.data)
    t = buf[:blocks].astype(np.int64)
    out = {"span_us": float(t[:, 1].max() - t[:, 0].min()) / 1e3,
           "ctas": blocks}
    for name, col in phases:
        us = t[:, col] / clock_hz * 1e6
        out[name] = [round(float(x), 2)
                     for x in np.percentile(us, [50, 90, 100])]
    return out


def main():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import json

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gram_phase_trace: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.data.bow import local_support_cols
    from repro_torch.data.corpus import NYTIMES_TOPICS, make_corpus
    from repro_torch.kernels import _build, csr_gram, gram, ref
    from repro_torch.sparse.store import write_corpus

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    clock_hz = 1e6 * float(subprocess.run(
        CLOCK_QUERY, capture_output=True, text=True,
        check=True).stdout.split()[0])
    libs = build(("gram", "csr_gram"))
    dev = torch.device("cuda")
    _, stream = _build.launch_on(dev)
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
            raise SystemExit("gram_phase_trace: the traced K6 disagrees")
        print(json.dumps({"kernel": "gram", "shape": [m, n],
                          "split": plan.split, **row}))
    corpus = make_corpus(12_000, 102_660, topics=NYTIMES_TOPICS, seed=0)
    n_hat, R = 220, 512
    sup = np.sort(np.argsort(-corpus.column_stats_exact()[1],
                             kind="stable")[:n_hat])
    with tempfile.TemporaryDirectory(prefix="gram_phase_trace_") as store_dir:
        mb = next(iter(write_corpus(corpus, store_dir).iter_megabatches(
            chunk_rows=R, reuse_buffers=False)))
    v, loc, sg = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        mb.values.astype(np.float32),
        local_support_cols(sup, mb.col_ids).astype(np.int32),
        mb.seg_ids.astype(np.int32)))
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
        raise SystemExit("gram_phase_trace: the traced K3 disagrees")
    print(json.dumps({"kernel": "csr_gram", "C": C_, "E": E, "R": R,
                      "n_hat": n_hat, "slabs": plan.slabs,
                      "groups": plan.groups, **row}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
