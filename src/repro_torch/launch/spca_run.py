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

Not ported yet (each exits with the ROADMAP item that ports it):
``--devices`` (queue 1 item 12), ``--resume`` and ``--pass-deadline-s``
(item 8), ``--export-port`` (item 10).
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
from ..obs import metrics, profile, trace

_NOT_PORTED = {
    "devices": "queue 1 item 12 (mesh)",
    "resume": "queue 1 item 8 (reliability)",
    "pass_deadline_s": "queue 1 item 8 (reliability)",
    "export_port": "queue 1 item 10 (rest of obs/)",
}


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
    ap.add_argument("--devices", type=int, default=0,
                    help="(not ported yet)")
    ap.add_argument("--resume", default="", metavar="DIR",
                    help="(not ported yet)")
    ap.add_argument("--pass-deadline-s", type=float, default=None,
                    metavar="S", help="(not ported yet)")
    ap.add_argument("--export-port", type=int, default=None, metavar="PORT",
                    help="(not ported yet)")
    args = ap.parse_args(argv)
    asked = {"devices": args.devices > 1, "resume": bool(args.resume),
             "pass_deadline_s": args.pass_deadline_s is not None,
             "export_port": args.export_port is not None}
    for name, item in _NOT_PORTED.items():
        if asked[name]:
            ap.exit(2, f"--{name.replace('_', '-')} is not ported yet: "
                       f"ROADMAP {item}\n")
    return args


def main(argv=None):
    """Run the launcher; returns ``(corpus, results, diagnostics)``."""
    args = parse_args(argv)
    tracer = trace.install(trace.Tracer()) if args.trace else None
    try:
        with profile.trace_device(args.profile_dir or None):
            out = run(args)
    finally:
        if tracer is not None:
            trace.install(None)
    if tracer is not None:
        tracer.dump_chrome_trace(args.trace)
        print(f"trace: {args.trace} (load at ui.perfetto.dev)")
        print(tracer.tree_str(min_s=0.005))
    if args.metrics:
        metrics.get_registry().dump_jsonl(
            args.metrics, extra={"run": "spca_run", "corpus": args.corpus})
        print(f"metrics: {args.metrics}")
    return out


def dense_stats(corpus, device):
    """The dense mode's ``(variances, build)`` pair: exact variances from
    the sparse corpus on the host, and the reduced Gram of a support as
    one product on ``device`` (columns centred on the host, as the
    reference does)."""
    _, var = corpus.column_stats_exact()

    def build(support):
        A = corpus.columns_dense(np.asarray(support))
        A = A - A.mean(0, keepdims=True)
        A = torch.from_numpy(A).to(device)
        return (A.T @ A) / corpus.n_docs

    return np.asarray(var), build


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
        io_backoff_s=cfg.io_backoff_s, device=device)
    print(f"  out-of-core variance screen: {time.time() - t0:.1f}s "
          f"(one pass over {store.nnz} nnz, "
          f"{ingest.get('screen_launches', 0)} megabatch launch(es))")
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
                     solver_fallback=not args.no_solver_fallback)
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
        diag.update(ingest=dict(ingest), corpus_passes=passes)
    if ingest.get("io_retries"):
        print(f"reliability: absorbed {ingest['io_retries']} transient "
              "read error(s)")
    if diag.get("solver_fallbacks"):
        print(f"reliability: took {diag['solver_fallbacks']} solver "
              "fallback(s) to the oracle path")
    return corpus, results, diag


if __name__ == "__main__":
    main(sys.argv[1:])
