"""Synthetic bag-of-words corpora with NYTimes/PubMed-scale dimensions.

Port of ``repro.data.corpus`` (numpy only, the parts the launchers and
the dense row-block pipeline use): the same seed gives the same corpus bit for bit in both packages.

The UCI files the paper uses (NYTimes: 300k docs x 102,660 words, 1 GB;
PubMed: 8.2M docs x 141,043 words, 7.8 GB) are not available offline, so we
generate corpora that reproduce the two properties the paper's pipeline
exploits:

  1. **Zipf word-frequency decay** — word variances fall off as a power law
     (the paper's Fig. 2), which is what makes safe elimination so effective;
  2. **planted topics** — small sets of co-occurring words with boosted
     rates in a slice of the documents, which the sparse PCs must recover
     (the paper's Tables 1-2).

Documents are Poisson bags: count(doc d, word i) ~ Poisson(rate[group(d), i])
stored sparsely (COO) so NYTimes-scale corpora fit in memory.
(Sampling note: nonzero docs are Bernoulli(1-e^-r)-selected and their counts
drawn as 1+Poisson(r) — a cheap zero-truncated-Poisson surrogate; exactness
of the count law is irrelevant to the properties above.)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Largest dense (m, n) materialisation allowed before pointing the caller
# at the out-of-core sparse store (`repro_torch.sparse`).
DENSE_BYTE_BUDGET = 2 << 30   # 2 GiB

# Planted topics mirroring the paper's Table 1 (NYTimes) so the example
# output reads like the paper's.
NYTIMES_TOPICS: dict[str, list[str]] = {
    "business": ["million", "percent", "business", "company", "market", "companies"],
    "sports": ["point", "play", "team", "season", "game"],
    "us": ["official", "government", "united_states", "u_s", "attack"],
    "politics": ["president", "campaign", "bush", "administration"],
    "education": ["school", "program", "children", "student"],
}

PUBMED_TOPICS: dict[str, list[str]] = {
    "clinical": ["patient", "cell", "treatment", "protein", "disease"],
    "dosing": ["effect", "level", "activity", "concentration", "rat"],
    "molecular": ["human", "expression", "receptor", "binding"],
    "oncology": ["tumor", "mice", "cancer", "malignant", "carcinoma"],
    "pediatric": ["year", "infection", "age", "children", "child"],
}


@dataclass
class Corpus:
    """Sparse COO bag-of-words + vocabulary."""

    n_docs: int
    vocab: list[str]
    doc_idx: np.ndarray     # (nnz,) int32
    word_idx: np.ndarray    # (nnz,) int32
    counts: np.ndarray      # (nnz,) float32
    topics: dict[str, list[int]] = field(default_factory=dict)  # planted word ids

    @property
    def n_words(self) -> int:
        return len(self.vocab)

    @property
    def nnz(self) -> int:
        return int(self.counts.size)

    def column_stats_exact(self):
        """Exact per-word mean/variance straight from the sparse COO —
        the oracle for the streaming/kernel/distributed paths."""
        m = self.n_docs
        s = np.zeros(self.n_words)
        ss = np.zeros(self.n_words)
        np.add.at(s, self.word_idx, self.counts)
        np.add.at(ss, self.word_idx, self.counts.astype(np.float64) ** 2)
        mean = s / m
        var = np.maximum(ss / m - mean**2, 0.0)
        return mean, var

    def batches(self, batch_docs: int):
        """Yield dense (<=batch_docs, n_words) float32 row blocks in doc
        order: the dense streaming interface the column-stats (K5) and
        Gram (K6) kernels consume."""
        order = np.argsort(self.doc_idx, kind="stable")
        di, wi, ct = self.doc_idx[order], self.word_idx[order], self.counts[order]
        starts = np.searchsorted(di, np.arange(0, self.n_docs + batch_docs, batch_docs))
        for b in range(len(starts) - 1):
            lo, hi = starts[b], starts[b + 1]
            rows = di[lo:hi] - b * batch_docs
            n_rows = min(batch_docs, self.n_docs - b * batch_docs)
            if n_rows <= 0:
                break
            X = np.zeros((n_rows, self.n_words), np.float32)
            np.add.at(X, (rows, wi[lo:hi]), ct[lo:hi])
            yield X

    def columns_dense(self, word_ids: np.ndarray) -> np.ndarray:
        """Materialise only the selected columns (n_docs, k) — the
        post-elimination matrix A_S."""
        word_ids = np.asarray(word_ids)
        pos = -np.ones(self.n_words, np.int64)
        pos[word_ids] = np.arange(word_ids.size)
        sel = pos[self.word_idx] >= 0
        X = np.zeros((self.n_docs, word_ids.size), np.float32)
        np.add.at(
            X, (self.doc_idx[sel], pos[self.word_idx[sel]]), self.counts[sel]
        )
        return X


def zipf_rates(n_words: int, *, alpha: float = 1.1, doc_length: float = 120.0):
    """Per-word Poisson rates with Zipf decay, normalised to an expected
    document length."""
    r = 1.0 / np.arange(1, n_words + 1) ** alpha
    return r * (doc_length / r.sum())


def make_corpus(
    n_docs: int,
    n_words: int,
    *,
    topics: dict[str, list[str]] | None = None,
    topic_boost: float = 4.0,
    topic_doc_frac: float = 0.15,
    topic_word_rank: int = 50,
    topic_rate: float | None = None,
    alpha: float = 1.1,
    doc_length: float = 120.0,
    seed: int = 0,
) -> Corpus:
    """Zipf corpus with planted topics.

    Topic words mirror the paper's ("million", "percent", ... — frequent but
    not stopwords): their base rate is ``topic_rate`` (default: doc_length/60,
    i.e. a top-~50 word) and in a ``topic_doc_frac`` slice of documents it's
    multiplied by ``topic_boost``.  Signal math (Poisson mixture): per-word
    variance ~ r + f(1-f)((b-1)r)^2 stays BELOW the top Zipf word, while the
    topic block's leading eigenvalue ~ var + (k-1)·f(1-f)((b-1)r)^2 rises
    ABOVE it — so the sparse PC is the correlated topic, not a stopword,
    exactly the paper's Table 1/2 structure.
    """
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:06d}" for i in range(n_words)]
    topic_ids: dict[str, list[int]] = {}
    rank = topic_word_rank
    if topics:
        for tname, words in topics.items():
            ids = []
            for w in words:
                vocab[rank] = w
                ids.append(rank)
                rank += 7  # spread topic words over nearby ranks
            topic_ids[tname] = ids

    rates = zipf_rates(n_words, alpha=alpha, doc_length=doc_length)
    if topics:
        r_t = topic_rate if topic_rate is not None else doc_length / 60.0
        for ids in topic_ids.values():
            rates[ids] = r_t

    # Document groups: one background group + one per topic.
    names = list(topic_ids.keys())
    n_topic_docs = int(n_docs * topic_doc_frac)
    group_of_doc = np.zeros(n_docs, np.int32)
    for g, _ in enumerate(names):
        lo = g * n_topic_docs
        group_of_doc[lo : lo + n_topic_docs] = g + 1

    doc_i: list[np.ndarray] = []
    word_i: list[np.ndarray] = []
    cts: list[np.ndarray] = []
    groups = [(0, np.flatnonzero(group_of_doc == 0))]
    groups += [(g + 1, np.flatnonzero(group_of_doc == g + 1)) for g in range(len(names))]
    for g, docs in groups:
        if docs.size == 0:
            continue
        r = rates.copy()
        if g > 0:
            r[topic_ids[names[g - 1]]] *= topic_boost
        # Words worth sampling for this group (expected >=1 nonzero doc).
        p_nz = -np.expm1(-r)
        cand = np.flatnonzero(p_nz * docs.size > 0.01)
        for i in cand:
            k = rng.binomial(docs.size, p_nz[i])
            if k == 0:
                continue
            chosen = rng.choice(docs, size=k, replace=False)
            c = 1.0 + rng.poisson(r[i], size=k)
            doc_i.append(chosen.astype(np.int32))
            word_i.append(np.full(k, i, np.int32))
            cts.append(c.astype(np.float32))

    return Corpus(
        n_docs=n_docs,
        vocab=vocab,
        doc_idx=np.concatenate(doc_i) if doc_i else np.zeros(0, np.int32),
        word_idx=np.concatenate(word_i) if word_i else np.zeros(0, np.int32),
        counts=np.concatenate(cts) if cts else np.zeros(0, np.float32),
        topics=topic_ids,
    )


def nytimes_like(n_docs: int = 30_000, seed: int = 0) -> Corpus:
    """NYTimes-dimension corpus: 102,660 words, planted Table-1 topics."""
    return make_corpus(n_docs, 102_660, topics=NYTIMES_TOPICS, seed=seed,
                       alpha=1.1)


def pubmed_like(n_docs: int = 50_000, seed: int = 1) -> Corpus:
    """PubMed-dimension corpus: 141,043 words, planted Table-2 topics."""
    return make_corpus(n_docs, 141_043, topics=PUBMED_TOPICS, seed=seed,
                       alpha=1.05)
