"""The frozen corpus generator: a pinned checksum and its law (CPU)."""
import hashlib
import json

import numpy as np
import pytest

from portbench import gen
from portbench.harness import HERE

SEED = 2**31 + 5      # past 32 signed bits, as a run's seed may be


def _law(n_words=400):
    law = json.loads((HERE / "configs" / "nytimes.json").read_text())["corpus"]
    return dict(law, n_words=n_words)


def test_pinned_checksum_at_a_tiny_size():
    b = gen.bag(_law(), 300, SEED, 0, "cpu")
    h = hashlib.sha256()
    for a in (b.doc_idx, b.word_idx, b.counts):
        h.update(np.ascontiguousarray(a).tobytes())
    assert (b.nnz, h.hexdigest()[:16]) == (41172, "2d909523bc2ff76e")


def test_same_seed_same_corpus_other_stream_other_corpus():
    a = gen.bag(_law(), 200, SEED, 0, "cpu")
    b = gen.bag(_law(), 200, SEED, 0, "cpu")
    c = gen.bag(_law(), 200, SEED, 1, "cpu")
    for x, y in ((a.doc_idx, b.doc_idx), (a.word_idx, b.word_idx),
                 (a.counts, b.counts)):
        assert np.array_equal(x, y)
    assert not (a.nnz == c.nnz and np.array_equal(a.word_idx, c.word_idx))


def test_law_planted_topics_and_rates():
    law = _law(2000)
    ids = gen.topic_ids(law)
    words = [w for t in law["topics"].values() for w in t]
    flat = [i for t in ids.values() for i in t]
    assert flat == list(range(50, 50 + 7 * len(words), 7))
    r = gen.word_rates(law)
    others = np.setdiff1d(np.arange(2000), flat)
    assert abs(r[others].sum() + r[flat].sum() - r.sum()) < 1e-9
    zipf = 1.0 / np.arange(1, 2001) ** law["alpha"]
    assert np.allclose(r[others], (law["rate_sum"] / zipf.sum())
                       * zipf[others])
    assert np.allclose(r[flat], law["topic_rate"])
    assert np.all(np.diff(r[others]) <= 0)


def test_counts_and_groups_follow_the_law():
    law = _law(300)
    b = gen.bag(law, 2000, SEED, 0, "cpu")
    assert b.counts.min() >= 1 and b.doc_idx.max() < 2000
    assert b.word_idx.max() < 300
    # no (document, word) pair twice
    pairs = b.doc_idx.astype(np.int64) * 300 + b.word_idx
    assert np.unique(pairs).size == b.nnz
    # a topic's words are boosted in its own slice of documents
    per = int(2000 * law["topic_doc_frac"])
    first = gen.topic_ids(law)["business"]
    hit = np.isin(b.word_idx, first)
    inside = b.counts[hit & (b.doc_idx < per)].sum() / per
    outside = b.counts[hit & (b.doc_idx >= per)].sum() / (2000 - per)
    assert inside > 2.0 * outside


def test_expected_document_matches_the_published_counts():
    """The configuration's law gives a document the source's NNZ / D
    distinct words and N / D words, within 0.1 %."""
    cfg = json.loads((HERE / "configs" / "nytimes.json").read_text())
    distinct, words = gen.per_doc(cfg["corpus"])
    assert distinct == pytest.approx(69_679_427 / 300_000, rel=1e-3)
    assert words == pytest.approx(100_000_000 / 300_000, rel=1e-3)
    assert cfg["corpus"]["n_docs"] == cfg["published"]["n_docs"]
    assert cfg["corpus"]["n_words"] == cfg["published"]["n_words"]


def test_expected_counts_by_brute_force():
    law = _law(300)
    b = gen.bag(law, 4000, SEED, 0, "cpu")
    distinct, words = gen.per_doc(law)
    assert b.nnz / 4000 == pytest.approx(distinct, rel=0.02)
    assert b.counts.sum() / 4000 == pytest.approx(words, rel=0.02)
