"""The paper's own pipeline as a launcher: corpus -> variance screen ->
safe elimination -> reduced Gram -> BCD -> topic tables.  Port of
``repro.launch.spca_run``.

    PYTHONPATH=src python -m repro_torch.launch.spca_run --corpus nytimes \\
        --docs 30000 --components 5 --target-card 5

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the same pipeline on the CPU with the kernels' plain versions.  Every
lambda-search solve is one launch of the fused BCD kernel
(``--batch-evals B``: one launch per round of B evaluations).  The reduced
Gram is one float32 matrix product on the device, with TF32 off, as the
reference's numpy product is full float32.

With ``--streaming`` the corpus is first written to a sharded CSR store
on disk (``--store-dir``, default a temporary directory removed after
the fit) and the fit runs out of core from the store: prefetched
megabatch passes through the CSR kernels (K2, the column-stats screen;
K3, the gather-Gram), 1 + 1 corpus passes for ALL components (the screen
and one union-support Gram shared by the deflation rounds), never an
(m, n) dense array.  The printed lines are the reference launcher's.

Reliability: ``--resume DIR`` checkpoints the fit into DIR (each corpus
pass every ``--checkpoint-every`` megabatches, every completed component
and the active lambda search's cursor); run the same command again after
a kill and the passes restart at their last megabatch boundary, the
solver phase at its last component/eval boundary, with the results of an
uninterrupted run ("resumed N megabatch(es)" in the report).  Give
``--store-dir`` with ``--streaming`` so the store outlives the run.
``--pass-deadline-s`` / ``--solve-deadline-s`` bound a pass / a search
round, raising at a resumable boundary.

Live telemetry: ``--export-port P`` (0 = an ephemeral port, printed)
serves ``/metrics`` (Prometheus text), ``/healthz``, ``/varz`` and
``/tracez`` on 127.0.0.1 while the fit runs, sampling every
``--export-interval`` seconds under the solver, ingestion and runtime
health rules.

Not ported yet: ``--devices`` (exits with ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile
import time

import numpy as np
import torch

from ..configs.spca_experiments import NYTIMES, PUBMED
from ..core import SPCAConfig, fit_components
from ..data.corpus import NYTIMES_TOPICS, PUBMED_TOPICS, make_corpus
from ..device import resolve
from ..obs import health, metrics, profile, trace
from ..obs.export import TelemetryExporter

_NOT_PORTED = {"devices": "queue 1 item 12 (mesh)"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--corpus", choices=("nytimes", "pubmed"),
                    default="nytimes")
    ap.add_argument("--docs", type=int, default=8000)
    ap.add_argument("--words", type=int, default=0,
                    help="0 = the corpus's real vocabulary width")
    ap.add_argument("--components", type=int, default=5)
    ap.add_argument("--target-card", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--no-solver-fallback", action="store_true",
                    help="disable the fused->plain solver fallback ladder "
                         "(an unhealthy fused solve then raises)")
    ap.add_argument("--batch-evals", type=int, default=0,
                    help=">1: run each lambda-search round as ONE batched "
                         "solve launch of this many evaluations")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write the host span timeline as Chrome "
                         "trace-event JSON and print the span tree")
    ap.add_argument("--metrics", default="", metavar="PATH",
                    help="append one metrics-registry snapshot (JSON line) "
                         "after the fit")
    ap.add_argument("--profile-dir", default="", metavar="DIR",
                    help="run a torch.profiler trace into DIR with the "
                         "kernel dispatch sites annotated")
    ap.add_argument("--streaming", action="store_true",
                    help="run out-of-core from a sharded CSR store on disk")
    ap.add_argument("--store-dir", default="",
                    help="where to write the CSR store (default: a temp "
                         "dir, removed after the fit)")
    ap.add_argument("--chunk-nnz", type=int, default=16_384)
    ap.add_argument("--chunk-rows", type=int, default=512)
    ap.add_argument("--megabatch", type=int, default=8,
                    help="chunks per ingest launch")
    ap.add_argument("--io-retries", type=int, default=2,
                    help="transient shard-read OSError retries before "
                         "giving up (exponential backoff; corruption is "
                         "never retried)")
    ap.add_argument("--resume", default="", metavar="DIR",
                    help="checkpoint the fit into DIR and resume a killed "
                         "run: streaming passes restart at the last "
                         "completed megabatch boundary and the solver "
                         "phase at the last completed component/eval "
                         "boundary")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="megabatches between pass checkpoints (with "
                         "--resume)")
    ap.add_argument("--pass-deadline-s", type=float, default=None,
                    metavar="S",
                    help="wall-clock budget per streaming corpus pass; "
                         "expiry raises PassDeadlineError at a resumable "
                         "megabatch boundary")
    ap.add_argument("--solve-deadline-s", type=float, default=None,
                    metavar="S",
                    help="wall-clock budget per lambda-search solve round; "
                         "expiry raises SolveDeadlineError at a "
                         "checkpointed eval boundary")
    ap.add_argument("--export-port", type=int, default=None, metavar="PORT",
                    help="start the background telemetry exporter and serve "
                         "/metrics /healthz /varz /tracez on 127.0.0.1 at "
                         "this port (0 = ephemeral)")
    ap.add_argument("--export-interval", type=float, default=2.0,
                    metavar="S",
                    help="seconds between exporter samples (with "
                         "--export-port; each interval appends one delta "
                         "snapshot to --metrics)")
    ap.add_argument("--devices", type=int, default=0,
                    help="(not ported yet)")
    args = ap.parse_args(argv)
    asked = {"devices": args.devices > 1}
    for name, item in _NOT_PORTED.items():
        if asked[name]:
            ap.exit(2, f"--{name.replace('_', '-')} is not ported yet: "
                       f"ROADMAP {item}\n")
    return args


def main(argv=None, *, on_exporter=None):
    """Run the launcher; returns ``(corpus, results, diagnostics)``.
    ``on_exporter``, with ``--export-port``, is called with the started
    `TelemetryExporter` before the fit (a caller that scrapes the
    endpoints reads its port there)."""
    args = parse_args(argv)
    exporter = None
    if args.export_port is not None:
        exporter = TelemetryExporter(
            interval_s=args.export_interval, port=args.export_port,
            jsonl_path=args.metrics or None,
            rules=(health.solver_rules() + health.ingestion_rules()
                   + health.runtime_rules()),
            extra={"run": "spca_run", "corpus": args.corpus})
    tracer = trace.install(trace.Tracer()) if args.trace else None
    try:
        if exporter is not None:
            exporter.start()
            print(f"telemetry: http://127.0.0.1:{exporter.port}"
                  "/{metrics,healthz,varz,tracez} "
                  f"(sampling every {args.export_interval:g}s)")
            if on_exporter is not None:
                on_exporter(exporter)
        with profile.trace_device(args.profile_dir or None):
            out = run(args)
    finally:
        if exporter is not None:
            exporter.stop()
        if tracer is not None:
            trace.install(None)
    if tracer is not None:
        tracer.dump_chrome_trace(args.trace)
        print(f"trace: {args.trace} (load at ui.perfetto.dev)")
        print(tracer.tree_str(min_s=0.005))
    if exporter is not None:
        print(exporter.health().describe())
    if args.metrics:
        if exporter is None:
            # one exit snapshot; with the exporter the file is already a
            # time series of interval samples, final flush included
            metrics.get_registry().dump_jsonl(
                args.metrics, extra={"run": "spca_run", "corpus": args.corpus})
        print(f"metrics: {args.metrics}")
    return out


def gram_of_support(corpus, device):
    """``build(support)``: the reduced Gram of a support as one product on
    ``device`` (columns centred on the host, as the reference does)."""
    def build(support):
        A = corpus.columns_dense(np.asarray(support))
        A = A - A.mean(0, keepdims=True)
        A = torch.from_numpy(A).to(device)
        return (A.T @ A) / corpus.n_docs

    return build


def dense_stats(corpus, device):
    """The dense mode's ``(variances, build)`` pair: exact variances from
    the sparse corpus on the host and `gram_of_support`'s ``build``."""
    _, var = corpus.column_stats_exact()
    return np.asarray(var), gram_of_support(corpus, device)


def streaming_stats(corpus, store_dir, cfg, ingest, device):
    """The streaming mode's ``(variances, build)`` pair: the corpus
    written to a CSR store in ``store_dir``, the screen pass run now and
    the Gram pass left to ``build``, both through the CSR kernels on
    ``device``; ``ingest`` collects the pass counters."""
    from ..sparse import write_corpus
    from ..sparse.engine import sparse_stats

    t0 = time.time()
    store = write_corpus(corpus, store_dir)
    mb = store.nnz * (4 + 4) / 1e6 + 8 * (store.n_rows + store.n_shards) / 1e6
    print(f"  wrote CSR store: {store.n_shards} shard(s), {mb:.1f} MB "
          f"at {store_dir} ({time.time() - t0:.1f}s)")
    t0 = time.time()
    var, build = sparse_stats(
        store, chunk_nnz=cfg.chunk_nnz, chunk_rows=cfg.chunk_rows,
        megabatch=cfg.megabatch_chunks, prefetch_depth=cfg.ingest_prefetch,
        impl=cfg.csr_impl, counters=ingest, io_retries=cfg.io_retries,
        io_backoff_s=cfg.io_backoff_s, resume_dir=cfg.resume_dir,
        checkpoint_every=cfg.checkpoint_every,
        pass_deadline_s=cfg.pass_deadline_s, device=device)
    resumed = ingest.get("resumed_megabatches", 0)
    print(f"  out-of-core variance screen: {time.time() - t0:.1f}s "
          f"(one pass over {store.nnz} nnz, "
          f"{ingest.get('screen_launches', 0)} megabatch launch(es)"
          + (f", resumed {resumed} megabatch(es)" if resumed else "") + ")")
    return var, build


def run(args):
    device = resolve(args.device)
    # A float32 matmul on the card defaults to full float32; say so
    # explicitly, since the reference's Gram is a full-float32 product.
    torch.backends.cuda.matmul.allow_tf32 = False
    exp = NYTIMES if args.corpus == "nytimes" else PUBMED
    topics = NYTIMES_TOPICS if args.corpus == "nytimes" else PUBMED_TOPICS
    n_words = args.words or exp.n_words
    print(f"generating {args.corpus}-like corpus: {args.docs} docs x "
          f"{n_words} words ...")
    t0 = time.time()
    corpus = make_corpus(args.docs, n_words, topics=topics, alpha=exp.alpha,
                         seed=exp.seed)
    print(f"  nnz={corpus.nnz} ({time.time() - t0:.1f}s)")

    cfg = SPCAConfig(max_sweeps=8, lam_search_evals=8,
                     chunk_nnz=args.chunk_nnz, chunk_rows=args.chunk_rows,
                     megabatch_chunks=args.megabatch,
                     batch_evals=args.batch_evals,
                     io_retries=args.io_retries,
                     resume_dir=args.resume or None,
                     checkpoint_every=args.checkpoint_every,
                     solver_fallback=not args.no_solver_fallback,
                     pass_deadline_s=args.pass_deadline_s,
                     solve_deadline_s=args.solve_deadline_s)
    ingest: dict = {}
    with contextlib.ExitStack() as stack:
        if args.streaming:
            store_dir = args.store_dir or stack.enter_context(
                tempfile.TemporaryDirectory(prefix="csr_store_"))
            stats = streaming_stats(corpus, store_dir, cfg, ingest, device)
        else:
            stats = dense_stats(corpus, device)
        # `core.spca` owns the cross-component pass economics: ONE eager
        # Gram build on the union support serves every deflated search
        # (with --streaming, ONE more corpus pass for ALL components).
        t0 = time.time()
        diag: dict = {}
        results = fit_components(
            None, args.components, target_card=args.target_card, cfg=cfg,
            stats=stats, diagnostics=diag, device=device,
        )
        fit_s = time.time() - t0
    for c, (r, d) in enumerate(zip(results, diag["components"])):
        words = [corpus.vocab[i] for i in r.support]
        print(f"PC{c + 1}: card={r.cardinality} n_hat={r.reduced_n} "
              f"lam={r.lam:.3f} var={r.variance:.2f} gap={r.gap:.1e} "
              f"launches={d['solve_launches']} evals={d['evals']} "
              f"cov_builds={d['cov_builds']}")
        print("   " + ", ".join(words))
    print(f"total: {diag['solve_launches']} solve launch(es) across "
          f"{args.components} components in {fit_s:.1f}s; gram builds: "
          f"{diag['cov_builds']}")
    if args.streaming:
        passes = ingest.get("screen_passes", 0) + ingest.get("gram_passes", 0)
        print(f"corpus passes: {passes} "
              f"(screen={ingest.get('screen_passes', 0)} "
              f"gram={ingest.get('gram_passes', 0)}; old scheme: "
              f"{1 + args.components}), ingest launches: "
              f"{ingest.get('screen_launches', 0) + ingest.get('gram_launches', 0)} "
              f"over {ingest.get('chunks', 0)} chunk(s)")
        diag.update(ingest=dict(ingest), corpus_passes=passes,
                    resumed_megabatches=ingest.get("resumed_megabatches", 0))
    extras = []
    if ingest.get("resumed_megabatches"):
        extras.append(f"resumed {ingest['resumed_megabatches']} "
                      "megabatch(es) from checkpoint")
    fr = diag.get("fit_resume") or {}
    if fr.get("components_restored"):
        extras.append(f"restored {fr['components_restored']} completed "
                      "component(s) from fit checkpoint")
    if fr.get("evals_skipped"):
        extras.append(f"skipped {fr['evals_skipped']} already-solved "
                      "lambda eval(s)")
    if diag.get("solver_fallbacks"):
        extras.append(f"took {diag['solver_fallbacks']} solver "
                      "fallback(s) to the oracle path")
    if ingest.get("io_retries"):
        extras.append(f"absorbed {ingest['io_retries']} transient "
                      "read error(s)")
    if extras:
        print("reliability: " + "; ".join(extras))
    return corpus, results, diag


if __name__ == "__main__":
    main(sys.argv[1:])
