"""Readings that the check's limits are set from, on the chip at the
cell's own size.

    python3 portbench/control.py --workload nyt-fit --seeds 101 102 103
    python3 portbench/control.py --workload nyt-fit --corpora --seeds 101
    python3 portbench/control.py --workload nyt-fit --seeds 101 102 103 \\
        --fault state_unchanged

For each seed it runs the cell once with a short window (``--seconds``)
and prints one JSON line with the numbers the check compares: those of
the program (``program``) and, unless a fault is planted, those of the
control (``control``): the plain reference put in the program's place
and computed one precision lower than the configuration states: the
Grams in TF32 (inputs rounded to TF32's 10-bit mantissa, products summed
in float32) and the screen in float32 instead of float64.  A run's seed
orders the documents of the configuration's one corpus, as in the
benchmark; with ``--corpora`` each seed draws a corpus of its own from
the configuration's law as well, for readings over many corpora.  With
``--fault`` the program runs with that fault planted under its timed
path (one process a fault: the faults patch the program).  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def tf32(a) -> np.ndarray:
    """``a`` rounded to TF32 (float32 with a 10-bit mantissa), nearest."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return b.view(np.float32)


def tf32_gram(bag, support) -> np.ndarray:
    support = np.asarray(support, np.int64)
    pos = np.full(bag.n_words, -1, np.int64)
    pos[support] = np.arange(support.size)
    p = pos[bag.word_idx.astype(np.int64)]
    sel = p >= 0
    A = np.zeros((bag.n_docs, support.size), np.float32)
    A[bag.doc_idx[sel], p[sel]] = bag.counts[sel]
    A -= A.mean(axis=0)
    A = tf32(A)
    return (A.T @ A) / np.float32(bag.n_docs)


def fit_control(run) -> None:
    """Put the reference, one precision lower, in the program's place."""
    b = run.bag
    c = b.counts.astype(np.float32)
    s = np.bincount(b.word_idx, weights=c, minlength=b.n_words).astype(
        np.float32)
    ss = np.bincount(b.word_idx, weights=c * c, minlength=b.n_words).astype(
        np.float32)
    m = np.float32(b.n_docs)
    var32 = np.maximum(ss / m - (s / m) ** 2, np.float32(0)).astype(
        np.float64)
    for f in run.fits:
        f.variances = var32
        f.grams = [(sup, tf32_gram(b, sup)) for sup, _ in f.grams]
        for i, r in enumerate(f.results):
            words = np.asarray(r.support)
            S = tf32_gram(b, words).astype(np.float64)
            x = np.asarray(r.x)[words]
            f.results[i] = dataclasses.replace(r, variance=float(x @ S @ x))


def readings(c, seed: int, seconds: float, device, fault=None,
             control: bool = True, corpora: bool = False) -> dict:
    """The compared numbers of one short run, and of its control; with
    ``corpora`` the corpus is drawn from ``seed`` too."""
    if str(harness.SRC) not in sys.path:
        sys.path.insert(0, str(harness.SRC))
    if corpora:
        c = dataclasses.replace(c, config=dict(
            c.config, corpus=dict(c.config["corpus"], seed=seed)))
    driver = harness.load_module(harness.HERE / "drivers" / f"{c.driver}.py",
                                 f"portbench_driver_{c.driver}")
    run = driver.Run(c, seed=seed, device=device, fault=fault)
    t0 = time.perf_counter()
    run.setup()
    run.warm(trace=False)
    run.window(seconds, trace=False)
    run.release()
    t1 = time.perf_counter()
    out = {"seed": seed, "fault": fault, "corpora": corpora,
           "fits": len(run.fits),
           "cards": sorted({len(r.support) for f in run.fits
                            for r in f.results}),
           "program": {k: v for k, (v, _) in run.check().items()},
           "run_s": t1 - t0, "check_s": time.perf_counter() - t1}
    if control and fault is None:
        fit_control(run)
        out["control"] = {k: v for k, (v, _) in run.check().items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--corpora", action="store_true",
                    help="draw each seed's corpus from the seed as well")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    c = harness.cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        try:
            r = readings(c, seed, args.seconds, dev, args.fault,
                         corpora=args.corpora)
        except Exception as e:      # a run that raises gives no number
            r = {"seed": seed, "fault": args.fault,
                 "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
