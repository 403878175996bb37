"""Serving launcher: fit sparse topics, register, serve a live query stream.
Port of ``repro.launch.serve_topics``.

    PYTHONPATH=src python -m repro_torch.launch.serve_topics --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_topics \\
        --docs 30000 --words 102660 --components 5 --queries 4000

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the same steps on the CPU with the kernels' plain versions.

  1. fit     — the paper's pipeline (screen -> eliminate -> BCD) on a
               Zipf corpus with planted topics: one ``search_lambda`` per
               component, its solves on kernel K1, the reduced Gram one
               float32 product on the device (TF32 off);
  2. register— pack the components and hot-swap them into a versioned,
               checkpointed ``ModelRegistry`` (``--registry``, default a
               temporary directory removed at exit);
  3. serve   — a synthetic query stream (fresh draws from the training
               distribution) flows through the ``MicroBatcher`` into the
               gather-matvec projector, one launch of kernel K4 per
               batch; per-request latency and throughput are reported
               (p50/p99, docs/s);
  4. monitor — a ``DriftMonitor`` folds the served traffic into a running
               variance screen on the device and is then shown a
               *shifted* stream (tail words boosted) to demonstrate the
               refit flag firing when the Thm 2.1 elimination certificate
               goes stale.

The printed lines are the reference launcher's.  The training screen is
float32 with an int32 count, as the reference launcher holds it (x64 off),
so the two write the same registry manifest.

Live telemetry: ``--export-port P`` (0 = an ephemeral port, printed)
serves ``/metrics`` (Prometheus text: the ``serve.*`` instruments, the
kernels' ``kernel.launches.*`` counts), ``/healthz`` (200 unless a
critical rule of the serving and solver packs fires), ``/varz`` (with the
live batcher's snapshot) and ``/tracez`` on 127.0.0.1, sampling every
``--export-interval`` seconds.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile
import time

import numpy as np
import torch

from ..core import SPCAConfig, search_lambda
from ..core.elimination import Screen
from ..data.corpus import NYTIMES_TOPICS, make_corpus
from ..device import resolve
from ..obs import health, metrics, trace
from ..obs.export import TelemetryExporter
from ..serve import BatcherConfig, DriftMonitor, MicroBatcher, ModelRegistry
from .spca_run import gram_of_support


def iter_docs(corpus):
    """Yield each document as a sparse (word_ids, counts) pair."""
    order = np.argsort(corpus.doc_idx, kind="stable")
    di = corpus.doc_idx[order]
    wi = corpus.word_idx[order]
    ct = corpus.counts[order]
    starts = np.searchsorted(di, np.arange(corpus.n_docs + 1))
    for d in range(corpus.n_docs):
        lo, hi = starts[d], starts[d + 1]
        yield wi[lo:hi], ct[lo:hi]


def shifted_docs(docs, n_words: int, *, n_shift: int = 8, rate: float = 4.0,
                 seed: int = 0):
    """Traffic-drift injector: boost ``n_shift`` tail words in every doc.

    Tail words (the last Zipf ranks) had training variance far below lambda
    — exactly the features safe elimination removed — so this is the drift
    the certificate cannot absorb."""
    rng = np.random.default_rng(seed)
    hot = np.arange(n_words - n_shift, n_words, dtype=np.int64)
    for wi, ct in docs:
        extra = 1.0 + rng.poisson(rate, size=n_shift)
        yield (np.concatenate([np.asarray(wi, np.int64), hot]),
               np.concatenate([np.asarray(ct, np.float32),
                               extra.astype(np.float32)]))


def fit_topics(corpus, n_components: int, target_card: int, device):
    """The reference launcher's fit loop on ``device``: one lambda search
    per component over the words earlier components did not take.
    Returns (results, training screen)."""
    mean, var = corpus.column_stats_exact()
    build = gram_of_support(corpus, device)
    mask = np.ones(corpus.n_words, bool)
    cfg = SPCAConfig(max_sweeps=8, lam_search_evals=8)
    results = []
    for c in range(n_components):
        t0 = time.time()
        r = search_lambda(None, target_card, cfg=cfg, active_mask=mask,
                          stats=(var, build), device=device)
        results.append(r)
        mask[r.support] = False
        words = [corpus.vocab[i] for i in r.support]
        print(f"PC{c + 1}: card={r.cardinality} n_hat={r.reduced_n} "
              f"lam={r.lam:.3f} var={r.variance:.2f} "
              f"({time.time() - t0:.1f}s)  " + ", ".join(words[:8]))
    screen = Screen(
        variances=torch.as_tensor(var, dtype=torch.float32, device=device),
        means=torch.as_tensor(mean, dtype=torch.float32, device=device),
        count=np.asarray(corpus.n_docs, np.int32))
    return results, screen


def serve_stream(batcher, docs, *, inflight: int = 256):
    """Closed-loop client: keeps at most ``inflight`` requests outstanding
    (an open loop would just measure queue depth, not the server)."""
    pending = []
    served = 0
    topics = []
    for wi, ct in docs:
        pending.append(batcher.submit(wi, ct))
        if len(pending) >= inflight:
            for f in pending:
                topics.append(int(np.argmax(np.abs(f.result(timeout=60)))))
            served += len(pending)
            pending = []
    for f in pending:
        topics.append(int(np.argmax(np.abs(f.result(timeout=60)))))
    served += len(pending)
    return served, np.bincount(topics, minlength=batcher.projector.pack.k)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus, fast end-to-end run")
    ap.add_argument("--docs", type=int, default=8000)
    ap.add_argument("--words", type=int, default=10_000)
    ap.add_argument("--components", type=int, default=5)
    ap.add_argument("--target-card", type=int, default=5)
    ap.add_argument("--queries", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--registry", default=None,
                    help="persistence dir (default: a temp dir, removed "
                         "at exit)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write the host span timeline as Chrome "
                         "trace-event JSON (Perfetto-loadable)")
    ap.add_argument("--metrics", default="", metavar="PATH",
                    help="append one metrics-registry snapshot (JSON line) "
                         "at exit (with --export-port: a time series, one "
                         "line per exporter interval)")
    ap.add_argument("--export-port", type=int, default=None, metavar="PORT",
                    help="start the background telemetry exporter and serve "
                         "/metrics /healthz /varz /tracez on 127.0.0.1 at "
                         "this port (0 = ephemeral)")
    ap.add_argument("--export-interval", type=float, default=2.0,
                    metavar="S",
                    help="seconds between exporter samples (with "
                         "--export-port)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.docs = min(args.docs, 3000)
        args.words = min(args.words, 2500)
        args.components = min(args.components, 3)
        args.queries = max(min(args.queries, 1500), 1000)
    return args


def main(argv=None, *, on_exporter=None):
    """Run the launcher; returns what `run` returns.  ``on_exporter``, with
    ``--export-port``, is called with the started `TelemetryExporter`
    before the fit (a caller that scrapes the endpoints reads its port
    there)."""
    args = parse_args(argv)
    exporter = None
    if args.export_port is not None:
        exporter = TelemetryExporter(
            interval_s=args.export_interval, port=args.export_port,
            jsonl_path=args.metrics or None,
            rules=health.serving_rules() + health.solver_rules(),
            extra={"run": "serve_topics"})
    tracer = trace.install(trace.Tracer()) if args.trace else None
    try:
        if exporter is not None:
            exporter.start()
            print(f"telemetry: http://127.0.0.1:{exporter.port}"
                  "/{metrics,healthz,varz,tracez} "
                  f"(sampling every {args.export_interval:g}s)")
            if on_exporter is not None:
                on_exporter(exporter)
        out = run(args, exporter)
    finally:
        if exporter is not None:
            exporter.stop()
        if tracer is not None:
            trace.install(None)
    if tracer is not None:
        tracer.dump_chrome_trace(args.trace)
        print(f"trace: {args.trace} (load at ui.perfetto.dev)")
    if exporter is not None:
        print(exporter.health().describe())
    if args.metrics:
        if exporter is None:
            # one exit snapshot; with the exporter the file is already a
            # time series (final flush included by exporter.stop())
            metrics.get_registry().dump_jsonl(args.metrics,
                                              extra={"run": "serve_topics"})
        print(f"metrics: {args.metrics}")
    return out


def run(args, exporter=None):
    """The four steps; returns a summary dict (the fit, the registered
    version, the served counts, the latency snapshot and both drift
    reports) for callers that check the run."""
    device = resolve(args.device)
    # the reduced Gram is a full-float32 product, as the reference's is
    torch.backends.cuda.matmul.allow_tf32 = False
    with contextlib.ExitStack() as stack:
        root = args.registry or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="topic_registry_"))
        return _run(args, device, root, exporter)


def _run(args, device, root, exporter=None):
    # 1. fit ---------------------------------------------------------------
    print(f"corpus: {args.docs} docs x {args.words} words")
    corpus = make_corpus(args.docs, args.words, topics=NYTIMES_TOPICS, seed=0)
    t0 = time.perf_counter()
    results, screen = fit_topics(corpus, args.components, args.target_card,
                                 device)
    fit_s = time.perf_counter() - t0

    # 2. register ----------------------------------------------------------
    registry = ModelRegistry(root, device=device)
    prior = registry.load_all()   # a re-run extends the version history
    if prior:
        print(f"registry at {root} already holds versions {prior}")
    mv = registry.register(results, screen, n_features=args.words,
                           meta={"corpus": "nytimes-like"})
    print(f"registered v{mv.version} -> {root}  "
          f"(k={mv.pack.k} cap={mv.pack.cap} nnz={mv.pack.nnz} "
          f"lam={mv.lam:.3f})")

    # 3. serve -------------------------------------------------------------
    queries = make_corpus(args.queries, args.words, topics=NYTIMES_TOPICS,
                          seed=1)
    monitor = DriftMonitor(mv.screen, mv.lams, min_docs=args.batch * 4)
    batcher = MicroBatcher(
        mv.projector, args.words,
        BatcherConfig(max_batch=args.batch, max_wait_ms=2.0),
        observer=monitor.observe,
    )
    if exporter is not None:
        # /varz shows the live batcher (queue depth, timeouts, shed,
        # p50/p99) beside the registry snapshot
        exporter.add_snapshot_provider("serve.batcher", batcher.snapshot)
    with batcher:
        t0 = time.perf_counter()
        served, hist = serve_stream(batcher, iter_docs(queries))
        wall = time.perf_counter() - t0
    s = batcher.stats.snapshot()
    print(f"served {served} docs in {wall:.2f}s: "
          f"{served / wall:.0f} docs/s  "
          f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms  "
          f"({batcher.batches_served} batches, "
          f"{mv.projector.trace_count} trace(s))")
    print("topic histogram:", hist.tolist())

    # 4. drift -------------------------------------------------------------
    rep = monitor.check()
    print(f"drift on in-distribution traffic: triggered={rep.triggered} "
          f"max_ratio={rep.max_ratio:.2f} docs={rep.docs_seen}")
    shifted = DriftMonitor(mv.screen, mv.lams, min_docs=args.batch * 4)
    batcher2 = MicroBatcher(
        mv.projector, args.words,
        BatcherConfig(max_batch=args.batch, max_wait_ms=2.0),
        observer=shifted.observe,
    )
    with batcher2:
        serve_stream(
            batcher2,
            shifted_docs(iter_docs(queries), args.words, seed=2),
        )
    rep2 = shifted.check()
    print(f"drift on shifted traffic:          triggered={rep2.triggered} "
          f"max_ratio={rep2.max_ratio:.2f} "
          f"offending={rep2.offending[:8].tolist()}")
    if rep.triggered or not rep2.triggered:
        raise SystemExit("drift monitor misbehaved")
    print("ok: certificate quiet in-distribution, refit flag on drift")
    return {
        "corpus": corpus, "queries": queries, "results": results,
        "version": mv, "fit_s": fit_s, "served": served, "serve_s": wall,
        "histogram": hist, "latency": s,
        "batches": [batcher.batches_served, batcher2.batches_served],
        "warmups": 2, "trace_count": mv.projector.trace_count,
        "drift": rep, "drift_shifted": rep2,
    }


if __name__ == "__main__":
    main(sys.argv[1:])
