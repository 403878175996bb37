"""The reference record the port's dense row-block pipeline is checked
against.

``src/repro_torch/data/reference/dense_blocks_nytimes.json`` holds what
the JAX package's two-pass pipeline over dense row blocks
(``repro.data.screen_and_gram_streaming`` over ``Corpus.batches(256)``:
the column-stats screen, then the reduced Gram on the support) produces
on the CPU at NYTimes width: 30,000 docs x 102,660 words, lambda chosen
to keep 500 words (NYTimes' ``expected_reduced_max``) from the exact
variances, then the sparse-PCA fit on the resulting Sigma_hat (5
components, target cardinality 5, the launcher's ``SPCAConfig``), with
x64 off as the launcher runs.  It keeps lambda, the support, the count,
the kernels' dispatch counts (``kernel.launches.column_stats`` /
``gram``), the support's screen variances, Sigma_hat's diagonal, trace
and Frobenius norm, and the five components (their supports mapped
back through the screen's support to word ids).  ``chip_smoke.py`` holds
the port's pipeline on the card against it.  This test regenerates the
record from ``repro`` and asserts it is unchanged, so it cannot go
stale.  Supports, words and counts must match exactly; floats to 1e-6
relative (the last bits of a float32 fit may move with the BLAS build).

Regenerate with
``PYTHONPATH=src python tests/test_torch_reference_record_dense_blocks.py``.
"""
import json
import pathlib
import sys

import jax
import numpy as np
import pytest

from repro.configs.spca_experiments import NYTIMES
from repro.core import SPCAConfig, fit_components
from repro.core.elimination import lam_for_target_size
from repro.data import screen_and_gram_streaming
from repro.data.corpus import NYTIMES_TOPICS, make_corpus
from repro.obs import metrics

RECORD = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "reference" / "dense_blocks_nytimes.json")
DOCS, BATCH_DOCS, COMPONENTS, TARGET = 30_000, 256, 5, 5


def generate() -> dict:
    corpus = make_corpus(DOCS, NYTIMES.n_words, topics=NYTIMES_TOPICS,
                         alpha=NYTIMES.alpha, seed=NYTIMES.seed)
    lam = lam_for_target_size(corpus.column_stats_exact()[1],
                              NYTIMES.expected_reduced_max)
    cfg = SPCAConfig(max_sweeps=8, lam_search_evals=8)
    with jax.enable_x64(False), metrics.use_registry() as reg:
        Sigma_hat, support, screen = screen_and_gram_streaming(
            lambda: corpus.batches(BATCH_DOCS), corpus.n_words, lam)
        launches = {op: int(reg.value(f"kernel.launches.{op}"))
                    for op in ("column_stats", "gram")}
        diag = {}
        results = fit_components(Sigma_hat, COMPONENTS, target_card=TARGET,
                                 is_covariance=True, cfg=cfg,
                                 diagnostics=diag)
    S = np.asarray(Sigma_hat, np.float64)
    return {
        "settings": {"docs": DOCS, "words": NYTIMES.n_words,
                     "batch_docs": BATCH_DOCS,
                     "target_n_hat": NYTIMES.expected_reduced_max,
                     "max_reduced": 2048, "center": True,
                     "components": COMPONENTS, "target_card": TARGET,
                     "max_sweeps": 8, "lam_search_evals": 8,
                     "dtype": "float32", "solver": "jnp (CPU)"},
        "lam": float(lam),
        "count": int(screen.count),
        "blocks": -(-DOCS // BATCH_DOCS),
        "launches": launches,
        "support": support.tolist(),
        "support_variances": np.asarray(screen.variances)[support].astype(
            np.float64).tolist(),
        "sigma_hat": {"n_hat": int(S.shape[0]),
                      "diagonal": np.diagonal(S).tolist(),
                      "trace": float(np.trace(S)),
                      "frobenius": float(np.linalg.norm(S))},
        "fit": {
            "components": [
                {"support": support[r.support].tolist(),
                 "words": [corpus.vocab[i] for i in support[r.support]],
                 "cardinality": int(r.cardinality),
                 "reduced_n": int(r.reduced_n), "lam": float(r.lam),
                 "variance": float(r.variance)}
                for r in results],
            "solve_launches": int(diag["solve_launches"]),
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


def test_dense_blocks_reference_record_is_current():
    _assert_same(generate(), json.loads(RECORD.read_text()))


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
    RECORD.parent.mkdir(parents=True, exist_ok=True)
    RECORD.write_text(json.dumps(generate(), indent=1) + "\n")
    print(f"wrote {RECORD}", file=sys.stderr)
