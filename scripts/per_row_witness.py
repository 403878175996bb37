#!/usr/bin/env python3
"""Which side of the card's arithmetic moves the per-row fit's lambdas.

    python3 scripts/per_row_witness.py

On one card, the dense cell's fit on the legacy per-row solver
(``solver_impl='jnp', qp_impl='pallas'``: 30,000 docs at NYTimes width,
5 components, target cardinality 5, as ``chip_smoke.py``'s
``fit_per_row`` phase runs it) four times, on the same corpus:

* ``k7``: the box QP of every row update is one launch of kernel K7;
* ``plain``: the box QP is K7's plain PyTorch version on the same card
  (``ops.qp_sweeps(..., impl='ref')``: ``w = Y u0`` by cuBLAS, the
  coordinate steps elementwise, ``R2`` by ``torch.dot``); the rest of
  the solver (traces, the tau bisection, the X update) is the same code;
* ``plain_w0_k7_order``: the plain version with ``w = Y u0`` summed as
  K7 sums it, over q in index order (one multiply and one add a q,
  each rounded), everything else as ``plain``;
* ``plain_r2_k7_order``: the plain version with ``R2`` summed as K7
  sums it: a shuffle-down tree over each 32 indices, then the trees'
  totals in index order.

Each prints its components' supports and lambdas beside the reference
record (``src/repro_torch/data/reference/spca_run_nytimes.json``), and
the last line names, for each component whose lambdas differ between
the ``k7`` and ``plain`` runs, the run that keeps the record's lambda,
and each run's lambdas.  It fails if K7 was not launched in the ``k7``
run, or was launched in another.  About ten minutes on an H100, most of
it the plain runs' per-coordinate host round-trips.
"""
import functools
import json
import os
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(label, corpus, record):
    import chip_smoke
    from repro_torch.kernels import bcd_sweep
    from repro_torch.obs import metrics

    with metrics.use_registry() as reg:
        bcd_sweep.reset_launches()
        t0 = time.perf_counter()
        results, diag = chip_smoke._fit_direct(corpus, "jnp",
                                               qp_impl="pallas")
        wall = time.perf_counter() - t0
        out = {"run": label, "seconds": wall,
               "solve_launches": diag["solve_launches"],
               "k7_launches": bcd_sweep.launches,
               "kernel.launches.qp_sweeps":
                   reg.value("kernel.launches.qp_sweeps"),
               "components": chip_smoke._vs_record(results, record["fit"])}
    chip_smoke.emit("per_row_witness", **out)
    return out


def _plain_qp(order):
    """K7's plain version with one of its reductions in K7's order:
    ``'w0'`` (w = Y u0 over q in index order) or ``'r2'`` (R2 by 32-wide
    shuffle-down trees, then their totals in index order)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref as kref

    def qp(Y, s, lam, u0, j, *, sweeps=4, impl="auto"):
        ft = kref.np_scalar(Y.dtype)
        n = Y.shape[0]
        if order == "w0":
            w = torch.zeros_like(u0)
            for q in range(n):
                w = w + Y[q] * u0[q]
        else:
            w = Y @ u0
        u = [ft(x) for x in u0.tolist()]
        s_l = [ft(x) for x in s.tolist()]
        diag = [ft(x) for x in Y.diagonal().tolist()]
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            kref._coordinate_sweeps(Y, w, None, None, u, s_l, diag, ft(lam),
                                    int(j), sweeps, n, ft)
        u_t = torch.tensor([float(x) for x in u], dtype=Y.dtype,
                           device=Y.device)
        if order == "r2":
            v = torch.zeros(-(-n // 32) * 32, dtype=Y.dtype, device=Y.device)
            v[:n] = u_t * w + 0.0
            v = v.view(-1, 32)
            for off in (16, 8, 4, 2, 1):
                v = v[:, :off] + v[:, off:2 * off]
            R2 = ft(0)
            for t in v[:, 0].tolist():
                R2 = R2 + ft(t)
        else:
            R2 = ft(torch.dot(u_t, w).item())
        return u_t, w, torch.tensor(float(R2), dtype=Y.dtype,
                                    device=Y.device)
    return qp


def main():
    import torch

    if not torch.cuda.is_available():
        print("per_row_witness: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke
    from repro_torch.configs.spca_experiments import NYTIMES
    from repro_torch.data.corpus import NYTIMES_TOPICS, make_corpus
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False   # as the launcher sets it
    record = json.load(open(os.path.join(
        ROOT, "src", "repro_torch", "data", "reference",
        "spca_run_nytimes.json")))
    chip_smoke.emit("env", nvidia_smi=chip_smoke.nvidia_smi(),
                    torch=torch.__version__)
    corpus = make_corpus(30_000, NYTIMES.n_words, topics=NYTIMES_TOPICS,
                         alpha=NYTIMES.alpha, seed=NYTIMES.seed)
    k7 = _run("k7", corpus, record)
    plain_qp = functools.partial(ops.qp_sweeps, impl="ref")
    with mock.patch.object(ops, "qp_sweeps", plain_qp):
        plain = _run("plain", corpus, record)
    variants = []
    for order in ("w0", "r2"):
        with mock.patch.object(ops, "qp_sweeps", _plain_qp(order)):
            variants.append(_run(f"plain_{order}_k7_order", corpus, record))
    chip_smoke.check(k7["k7_launches"] > 0, "the k7 run launched no K7")
    for r in (plain, *variants):
        chip_smoke.check(r["k7_launches"] == 0, f"the {r['run']} run "
                         "launched K7")
    moved = []
    for k, (a, b) in enumerate(zip(k7["components"], plain["components"])):
        if a["lam"][0] != b["lam"][0]:
            keeps = [r["run"] for r, c in ((k7, a), (plain, b))
                     if c["lam"][0] == c["lam"][1]]
            moved.append({"component": k + 1, "lam_k7": a["lam"][0],
                          "lam_plain": b["lam"][0],
                          "lam_record": a["lam"][1],
                          "keeps_record_lam": keeps})
    runs = (k7, plain, *variants)
    chip_smoke.emit("per_row_witness", summary=True, differs=moved,
                    lams={r["run"]: [c["lam"][0] for c in r["components"]]
                          for r in runs},
                    record_lams=[c["lam"][1] for c in k7["components"]],
                    supports_equal_record={
                        r["run"]: all(c["support_equal"]
                                      for c in r["components"])
                        for r in runs})
    return 0


if __name__ == "__main__":
    sys.exit(main())
