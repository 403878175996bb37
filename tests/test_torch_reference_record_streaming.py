"""The reference record the port's streaming fit is checked against.

``src/repro_torch/data/reference/spca_run_nytimes_streaming.json`` holds
what the JAX launcher's out-of-core mode (``repro.launch.spca_run
--streaming``) produces on the CPU at the paper's NYTimes size: 300,000
docs x 102,660 words, 5 components, target cardinality 5, the launcher's
own ``SPCAConfig`` and pass geometry (chunk_nnz 16,384, chunk_rows 512,
megabatch 8), with x64 off as the launcher runs.  It keeps the supports,
words, lambdas and reduced sizes, the pass economics (corpus passes,
screen and Gram megabatch launches, chunks) and the union support size
of the one Gram pass.  ``chip_smoke.py`` holds the port's streaming fit
on the card against it.  This test regenerates the record from ``repro``
and asserts it is unchanged, so it cannot go stale.  Supports, words and
counts must match exactly; lambda and explained variance to 1e-6
relative (the last bits of a float32 fit may move with the BLAS build).

Regenerate with
``PYTHONPATH=src python tests/test_torch_reference_record_streaming.py``.
"""
import json
import pathlib
import sys
import tempfile

import jax
import numpy as np
import pytest

from repro.configs.spca_experiments import NYTIMES
from repro.core import SPCAConfig, fit_components
from repro.data.corpus import NYTIMES_TOPICS, make_corpus
from repro.obs import trace
from repro.sparse import write_corpus
from repro.sparse.engine import sparse_stats

RECORD = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "reference" / "spca_run_nytimes_streaming.json")
DOCS, COMPONENTS, TARGET = 300_000, 5, 5
CHUNK_NNZ, CHUNK_ROWS, MEGABATCH = 16_384, 512, 8
COMMAND = ("python -m repro.launch.spca_run --streaming --corpus nytimes "
           "--docs 300000 --components 5 --target-card 5")


def generate() -> dict:
    corpus = make_corpus(DOCS, NYTIMES.n_words, topics=NYTIMES_TOPICS,
                         alpha=NYTIMES.alpha, seed=NYTIMES.seed)
    cfg = SPCAConfig(max_sweeps=8, lam_search_evals=8, chunk_nnz=CHUNK_NNZ,
                     chunk_rows=CHUNK_ROWS, megabatch_chunks=MEGABATCH)
    ingest, diag = {}, {}
    with tempfile.TemporaryDirectory(prefix="csr_store_") as d, \
            jax.enable_x64(False), trace.enable() as tr:
        store = write_corpus(corpus, d)
        var, build = sparse_stats(
            store, chunk_nnz=cfg.chunk_nnz, chunk_rows=cfg.chunk_rows,
            megabatch=cfg.megabatch_chunks,
            prefetch_depth=cfg.ingest_prefetch, impl=cfg.csr_impl,
            counters=ingest, io_retries=cfg.io_retries,
            io_backoff_s=cfg.io_backoff_s)
        results = fit_components(None, COMPONENTS, target_card=TARGET,
                                 cfg=cfg, stats=(np.asarray(var), build),
                                 diagnostics=diag)
        store_info = {"n_shards": store.n_shards, "nnz": store.nnz,
                      "chunks_per_pass": store.n_chunks(CHUNK_NNZ,
                                                        CHUNK_ROWS)}
        gram_passes = [int(sp.attrs["n_hat"])
                       for sp in tr.find("ingest.gram_pass")]
    return {
        "command": COMMAND,
        "settings": {"docs": DOCS, "words": NYTIMES.n_words,
                     "components": COMPONENTS, "target_card": TARGET,
                     "max_sweeps": 8, "lam_search_evals": 8,
                     "chunk_nnz": CHUNK_NNZ, "chunk_rows": CHUNK_ROWS,
                     "megabatch": MEGABATCH, "dtype": "float32",
                     "solver": "jnp (CPU)", "csr": "host backend (CPU)"},
        "store": store_info,
        "fit": {
            "components": [
                {"support": r.support.tolist(),
                 "words": [corpus.vocab[i] for i in r.support],
                 "cardinality": int(r.cardinality),
                 "reduced_n": int(r.reduced_n), "lam": float(r.lam),
                 "variance": float(r.variance),
                 "solve_launches": int(d["solve_launches"]),
                 "evals": int(d["evals"])}
                for r, d in zip(results, diag["components"])],
            "solve_launches": int(diag["solve_launches"]),
            "cov_builds": int(diag["cov_builds"]),
        },
        "ingest": {
            "corpus_passes": int(ingest["screen_passes"]
                                 + ingest["gram_passes"]),
            "screen_passes": int(ingest["screen_passes"]),
            "gram_passes": int(ingest["gram_passes"]),
            "screen_launches": int(ingest["screen_launches"]),
            "gram_launches": int(ingest["gram_launches"]),
            "chunks": int(ingest["chunks"]),
            "gram_pass_n_hat": gram_passes,
        },
    }


def _assert_same(new, old, path="record"):
    if isinstance(old, dict):
        assert set(new) == set(old), path
        for k in old:
            _assert_same(new[k], old[k], f"{path}.{k}")
    elif isinstance(old, list):
        assert len(new) == len(old), path
        for i, (a, b) in enumerate(zip(new, old)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(old, float):
        assert new == pytest.approx(old, rel=1e-6), path
    else:
        assert new == old, path


def test_streaming_reference_record_is_current():
    _assert_same(generate(), json.loads(RECORD.read_text()))


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
    RECORD.parent.mkdir(parents=True, exist_ok=True)
    RECORD.write_text(json.dumps(generate(), indent=1) + "\n")
    print(f"wrote {RECORD}", file=sys.stderr)
