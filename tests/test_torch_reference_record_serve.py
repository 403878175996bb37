"""The reference record the port's serving launcher is checked against.

``src/repro_torch/data/reference/serve_topics_nytimes.json`` holds what the
JAX serving launcher's steps (``repro.launch.serve_topics``: fit,
register, serve, drift) produce on the CPU at NYTimes width: 30,000 docs x
102,660 words (``make_corpus(..., topics=NYTIMES_TOPICS, seed=0)``), 5
components, target cardinality 5, 4,000 queries (``seed=1``), batch 64,
with x64 off as the launcher runs (set process-wide for the run, so the
batcher's server thread sees it too, and restored after).  It keeps, per
component, the support, words, lambda, n_hat and variance; the packed
model and the per-component lambdas; the registry manifest the launcher
writes; the topic histogram and trace count; both drift reports;
and the reference projector's scores for the first 64 query documents
(with their nnz and count total, so a run elsewhere can check that it
rebuilt the same batch).  No times: the CPU's say nothing of the card.
``chip_smoke.py`` holds the port's launcher on the card against it.

This test regenerates the record from ``repro`` and asserts it is
unchanged, so it cannot go stale.  Integers, supports, words and verdicts
must match exactly; floats to 1e-6 relative (the last bits of a float32
fit may move with the BLAS build), but the drift reports' ``max_ratio`` to
1e-5: the running screen folds float32 batch moments, and how requests
coalesce into batches (a 2 ms window) changes from run to run, so the
fold's order does too.  The number of batches is not kept for the same
reason.  Regenerate with
``PYTHONPATH=src python tests/test_torch_reference_record_serve.py``.
"""
import json
import os
import pathlib
import sys
import tempfile

import jax
import numpy as np
import pytest

from repro.configs.spca_experiments import NYTIMES
from repro.data.corpus import NYTIMES_TOPICS, make_corpus
from repro.launch.serve_topics import (
    fit_topics, iter_docs, serve_stream, shifted_docs,
)
from repro.serve import BatcherConfig, DriftMonitor, MicroBatcher, ModelRegistry

RECORD = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "reference" / "serve_topics_nytimes.json")
DOCS, WORDS, COMPONENTS, TARGET = NYTIMES.n_docs, NYTIMES.n_words, 5, 5
QUERIES, BATCH, FIRST = 4000, 64, 64
COMMAND = ("python -m repro.launch.serve_topics --docs 30000 --words 102660 "
           "--components 5 --target-card 5 --queries 4000 --batch 64")


def _report(rep) -> dict:
    return {"triggered": bool(rep.triggered),
            "n_offending": int(rep.n_offending),
            "offending": rep.offending[:8].tolist(),
            "max_ratio": float(rep.max_ratio),
            "docs_seen": int(rep.docs_seen)}


def first_batch(queries, n_words: int, rows: int = FIRST) -> np.ndarray:
    """The first ``rows`` query documents as a dense (rows, n) float32
    batch, scattered as the microbatcher does."""
    X = np.zeros((rows, n_words), np.float32)
    for r, (wi, ct) in zip(range(rows), iter_docs(queries)):
        np.add.at(X[r], wi, ct)
    return X


def _serve(mv, queries, docs):
    monitor = DriftMonitor(mv.screen, mv.lams, min_docs=BATCH * 4)
    batcher = MicroBatcher(mv.projector, WORDS,
                           BatcherConfig(max_batch=BATCH, max_wait_ms=2.0),
                           observer=monitor.observe)
    with batcher:
        served, hist = serve_stream(batcher, docs)
    return served, hist, monitor.check()


def generate() -> dict:
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    try:
        corpus = make_corpus(DOCS, WORDS, topics=NYTIMES_TOPICS, seed=0)
        results, screen = fit_topics(corpus, COMPONENTS, TARGET)
        with tempfile.TemporaryDirectory(prefix="topic_registry_") as root:
            mv = ModelRegistry(root).register(
                results, screen, n_features=WORDS,
                meta={"corpus": "nytimes-like"})
            with open(os.path.join(root, "step_000000000",
                                   "manifest.json")) as f:
                manifest = f.read()
        queries = make_corpus(QUERIES, WORDS, topics=NYTIMES_TOPICS, seed=1)
        served, hist, rep = _serve(mv, queries, iter_docs(queries))
        _, _, rep2 = _serve(
            mv, queries, shifted_docs(iter_docs(queries), WORDS, seed=2))
        X = first_batch(queries, WORDS)
        scores = np.asarray(mv.projector.project(X))
    finally:
        jax.config.update("jax_enable_x64", prev)
    return {
        "command": COMMAND,
        "settings": {"docs": DOCS, "words": WORDS, "components": COMPONENTS,
                     "target_card": TARGET, "queries": QUERIES,
                     "batch": BATCH, "max_sweeps": 8, "lam_search_evals": 8,
                     "x64": False, "dtype": "float32",
                     "solver": "jnp (CPU)", "projector": "jnp oracle (CPU)"},
        "fit": {"components": [
            {"support": r.support.tolist(),
             "words": [corpus.vocab[i] for i in r.support],
             "cardinality": int(r.cardinality),
             "reduced_n": int(r.reduced_n), "lam": float(r.lam),
             "variance": float(r.variance)} for r in results]},
        "pack": {"k": mv.pack.k, "cap": mv.pack.cap, "nnz": mv.pack.nnz,
                 "support_idx": mv.pack.support_idx.tolist(),
                 "values": mv.pack.values.tolist(),
                 "lams": mv.lams.tolist(), "lam": float(mv.lam)},
        "registry_manifest": manifest,
        "serve": {"served": int(served), "histogram": hist.tolist(),
                  "trace_count": int(mv.projector.trace_count)},
        "drift": {"in_distribution": _report(rep),
                  "shifted": _report(rep2)},
        "first_queries": {
            "rows": FIRST,
            "doc_nnz": np.count_nonzero(X, axis=1).tolist(),
            "count_total": float(X.sum(dtype=np.float64)),
            "scores": scores.tolist()},
    }


def _assert_same(new, old, path="record"):
    if isinstance(old, dict):
        assert set(new) == set(old), path
        for k in old:
            _assert_same(new[k], old[k], f"{path}.{k}")
    elif path.endswith(".max_ratio"):
        assert new == pytest.approx(old, rel=1e-5), path
    elif isinstance(old, list):
        assert len(new) == len(old), path
        for i, (a, b) in enumerate(zip(new, old)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(old, float):
        assert new == pytest.approx(old, rel=1e-6, abs=1e-12), path
    else:
        assert new == old, path


def test_serve_reference_record_is_current():
    _assert_same(generate(), json.loads(RECORD.read_text()))


if __name__ == "__main__":
    RECORD.parent.mkdir(parents=True, exist_ok=True)
    RECORD.write_text(json.dumps(generate(), indent=1) + "\n")
    print(f"wrote {RECORD}", file=sys.stderr)
