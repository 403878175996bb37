"""The benchmark's corpus generator: Zipf bags of words with planted
topics, drawn on the device from the seed.

The law is the one `make_corpus` of the synthetic-corpus module states
(Zipf word rates ``r`` of exponent ``alpha`` summing to ``rate_sum``,
topic words at ranks ``topic_word_rank + 7 i`` with the rate
``topic_rate``, boosted ``topic_boost`` times in their own slice of
``topic_doc_frac`` of the documents; a word enters a document with
probability ``1 - exp(-r)`` and then counts ``1 + Poisson(r)``), kept
here so that a change to the program cannot move the yardstick.  A
document therefore holds ``sum(1 - exp(-r))`` distinct words and
``sum((1 - exp(-r)) (1 + r))`` words in expectation (`per_doc`), which a
configuration sets to its source's published counts.  It is drawn with a
`torch.Generator` on the device in a few large calls, one block of words
at a time, and not word by word on the host.  The same seed, stream and
device give the same corpus.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CELLS_PER_CALL = 1 << 26       # random draws a call: 512 MB in float64


@dataclass(frozen=True)
class Bag:
    """A COO bag of words on the host: int32 docs and words, float32
    counts, and the planted topics' word ids by topic name."""

    n_docs: int
    n_words: int
    doc_idx: np.ndarray
    word_idx: np.ndarray
    counts: np.ndarray
    topics: dict

    @property
    def nnz(self) -> int:
        return int(self.counts.size)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed`` (any
    whole number that fits 64 bits)."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), int(stream)])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return g


def topic_ids(law: dict) -> dict:
    """Each planted topic's word ids, in the law's order."""
    ids, rank = {}, int(law["topic_word_rank"])
    for name, words in law["topics"].items():
        ids[name] = list(range(rank, rank + 7 * len(words), 7))
        rank += 7 * len(words)
    return ids


def word_rates(law: dict) -> np.ndarray:
    """Zipf rates summing to ``rate_sum``, topic words at ``topic_rate``."""
    n = int(law["n_words"])
    r = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** float(law["alpha"])
    r *= float(law["rate_sum"]) / r.sum()
    for ids in topic_ids(law).values():
        r[ids] = float(law["topic_rate"])
    return r


def per_doc(law: dict) -> tuple[float, float]:
    """Expected ``(distinct words, words)`` of a document of the law, over
    its topic slices and the background."""
    base = word_rates(law)
    topics = list(topic_ids(law).values())
    frac = float(law["topic_doc_frac"])
    out = np.zeros(2)
    for share, boosted in [(frac, ids) for ids in topics] + [
            (1.0 - frac * len(topics), None)]:
        r = base.copy()
        if boosted is not None:
            r[boosted] *= float(law["topic_boost"])
        p = -np.expm1(-r)
        out += share * np.array([p.sum(), (p * (1.0 + r)).sum()])
    return float(out[0]), float(out[1])


def bag(law: dict, n_docs: int, seed: int, stream: int, device) -> Bag:
    """``n_docs`` documents of the law, drawn on ``device`` from stream
    ``stream`` of ``seed``."""
    dev = torch.device(device)
    g = generator(seed, stream, dev)
    n_words = int(law["n_words"])
    rates = word_rates(law)
    topics = topic_ids(law)
    per_topic = int(n_docs * float(law["topic_doc_frac"]))
    # document groups: one slice per topic, then the background
    groups = [(i * per_topic, (i + 1) * per_topic, ids)
              for i, ids in enumerate(topics.values())]
    groups.append((len(topics) * per_topic, n_docs, None))
    docs, words, counts = [], [], []
    for lo, hi, boosted in groups:
        size = hi - lo
        if size <= 0:
            continue
        r = rates.copy()
        if boosted is not None:
            r[boosted] *= float(law["topic_boost"])
        p = -np.expm1(-r)
        cand = np.flatnonzero(p * size > 0.01)
        r_t = torch.as_tensor(r[cand], device=dev)
        p_t = torch.as_tensor(p[cand], device=dev)
        cand_t = torch.as_tensor(cand, device=dev)
        step = max(1, CELLS_PER_CALL // size)
        for a in range(0, cand.size, step):
            b = min(a + step, cand.size)
            u = torch.rand((size, b - a), generator=g, device=dev,
                           dtype=torch.float64)
            d, w = torch.nonzero(u < p_t[a:b], as_tuple=True)
            del u
            c = 1.0 + torch.poisson(r_t[a:b][w], generator=g)
            docs.append((d + lo).to(torch.int32))
            words.append(cand_t[a:b][w].to(torch.int32))
            counts.append(c.to(torch.float32))

    def host(parts, dtype):
        if not parts:
            return np.zeros(0, dtype)
        return torch.cat(parts).cpu().numpy()
    return Bag(n_docs=n_docs, n_words=n_words,
               doc_idx=host(docs, np.int32), word_idx=host(words, np.int32),
               counts=host(counts, np.float32), topics=topics)


def reorder_docs(b: Bag, seed: int, device) -> Bag:
    """``b`` with its documents in an order drawn from ``seed``: the same
    corpus, so the same work, arriving in another order."""
    g = generator(seed, 3, torch.device(device))
    perm = torch.randperm(b.n_docs, generator=g, device=device).cpu().numpy()
    return Bag(n_docs=b.n_docs, n_words=b.n_words,
               doc_idx=perm[b.doc_idx].astype(np.int32), word_idx=b.word_idx,
               counts=b.counts, topics=b.topics)
