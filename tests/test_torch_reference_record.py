"""The reference record the port's chip run is checked against.

``src/repro_torch/data/reference/spca_run_nytimes.json`` holds what the
JAX launcher (``repro.launch.spca_run``, dense mode) produces at the
NYTimes configuration on the CPU: 102,660 words, 30,000 docs, 5
components, target cardinality 5, the launcher's own ``SPCAConfig``,
sequential (``fit``) and with ``--batch-evals 4`` (``fit_batched``; it
diverges in its last component, so the record holds the divergence and
the components completed before it).
``chip_smoke.py`` holds the port's fit on the card against it.  This test
regenerates the record from ``repro`` and asserts it is unchanged, so it
cannot go stale.  Supports, words and counts must match exactly; lambda
and explained variance to 1e-6 relative (the last bits of a float32 fit
may move with the BLAS build).

Regenerate with ``PYTHONPATH=src python tests/test_torch_reference_record.py``.
"""
import json
import pathlib
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.spca_experiments import NYTIMES
from repro.core import SPCAConfig, fit_components, spca
from repro.core.bcd import SolverDivergenceError
from repro.data.corpus import NYTIMES_TOPICS, make_corpus
from repro.obs import trace

RECORD = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "reference" / "spca_run_nytimes.json")
DOCS, COMPONENTS, TARGET = 30_000, 5, 5
_search_lambda = spca.search_lambda
COMMAND = ("python -m repro.launch.spca_run --corpus nytimes --docs 30000 "
           "--components 5 --target-card 5")


def _component(corpus, r, d):
    return {"support": r.support.tolist(),
            "words": [corpus.vocab[i] for i in r.support],
            "cardinality": int(r.cardinality), "reduced_n": int(r.reduced_n),
            "lam": float(r.lam), "variance": float(r.variance),
            "solve_launches": int(d["solve_launches"]),
            "evals": int(d["evals"])}


def _fit(corpus, var, build, batch_evals):
    """One launcher fit (the launcher's config).  A divergence is recorded
    with the component it happened in and the components completed before
    it (each search's result, seen through a wrapper of
    `repro.core.spca.search_lambda`)."""
    cfg = SPCAConfig(max_sweeps=8, lam_search_evals=8,
                     batch_evals=batch_evals)
    diag = {}
    searched = []

    def search_lambda(*args, **kw):
        r = _search_lambda(*args, **kw)
        searched.append((r, kw["diagnostics"]))
        return r

    with trace.enable() as tr, mock.patch.object(spca, "search_lambda",
                                                 search_lambda):
        try:
            results = fit_components(None, COMPONENTS, target_card=TARGET,
                                     cfg=cfg, stats=(var, build),
                                     diagnostics=diag)
        except SolverDivergenceError as e:
            k = tr.find("fit.component")[-1].attrs["k"]
            return {"completed": [_component(corpus, r, d)
                                  for r, d in searched],
                    "diverged": {"component": int(k), "n": int(e.n),
                                 "lam": float(e.lam), "message": str(e)}}
    return {"components": [_component(corpus, r, d) for r, d
                           in zip(results, diag["components"])],
            "solve_launches": int(diag["solve_launches"])}


def generate() -> dict:
    corpus = make_corpus(DOCS, NYTIMES.n_words, topics=NYTIMES_TOPICS,
                         alpha=NYTIMES.alpha, seed=NYTIMES.seed)
    _, var = corpus.column_stats_exact()

    def build(support):                 # the launcher's dense Gram
        A = corpus.columns_dense(np.asarray(support))
        A = A - A.mean(0, keepdims=True)
        return jnp.asarray((A.T @ A) / corpus.n_docs)

    return {
        "command": COMMAND,
        "settings": {"docs": DOCS, "words": NYTIMES.n_words,
                     "components": COMPONENTS, "target_card": TARGET,
                     "max_sweeps": 8, "lam_search_evals": 8,
                     "dtype": "float32", "solver": "jnp (CPU)"},
        "fit": _fit(corpus, var, build, 0),
        "fit_batched": _fit(corpus, var, build, 4),
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
    elif path.endswith(".message"):
        pass          # carries the float lam at 6 digits; lam is compared
    else:
        assert new == old, path


def test_reference_record_is_current():
    _assert_same(generate(), json.loads(RECORD.read_text()))


if __name__ == "__main__":
    RECORD.parent.mkdir(parents=True, exist_ok=True)
    RECORD.write_text(json.dumps(generate(), indent=1) + "\n")
    print(f"wrote {RECORD}", file=sys.stderr)
