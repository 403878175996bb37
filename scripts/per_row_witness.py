#!/usr/bin/env python3
"""Which side of the card's arithmetic moves the per-row fit's lambdas.

    python3 scripts/per_row_witness.py

On one card, the dense cell's fit on the legacy per-row solver
(``solver_impl='jnp', qp_impl='pallas'``: 30,000 docs at NYTimes width,
5 components, target cardinality 5, as ``chip_smoke.py``'s
``fit_per_row`` phase runs it) twice, on the same corpus:

* ``k7``: the box QP of every row update is one launch of kernel K7;
* ``plain``: the box QP is K7's plain PyTorch version on the same card
  (``ops.qp_sweeps(..., impl='ref')``: ``w = Y u0`` by cuBLAS, the
  coordinate steps elementwise, ``R2`` by ``torch.dot``); the rest of
  the solver (traces, the tau bisection, the X update) is the same code.

Each prints its components' supports and lambdas beside the reference
record (``src/repro_torch/data/reference/spca_run_nytimes.json``), and
the last line names, for each component whose lambdas differ between
the two runs, the run that keeps the record's lambda.  It fails if K7
was not launched in the ``k7`` run, or was launched in the ``plain``
run.  About five minutes on an H100, most of it the plain run's
per-coordinate host round-trips.
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
    chip_smoke.check(k7["k7_launches"] > 0, "the k7 run launched no K7")
    chip_smoke.check(plain["k7_launches"] == 0, "the plain run launched K7")
    moved = []
    for k, (a, b) in enumerate(zip(k7["components"], plain["components"])):
        if a["lam"][0] != b["lam"][0]:
            keeps = [r["run"] for r, c in ((k7, a), (plain, b))
                     if c["lam"][0] == c["lam"][1]]
            moved.append({"component": k + 1, "lam_k7": a["lam"][0],
                          "lam_plain": b["lam"][0],
                          "lam_record": a["lam"][1],
                          "keeps_record_lam": keeps})
    chip_smoke.emit("per_row_witness", summary=True, differs=moved,
                    supports_equal_record={
                        r["run"]: all(c["support_equal"]
                                      for c in r["components"])
                        for r in (k7, plain)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
