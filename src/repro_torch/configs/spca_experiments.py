"""The paper's own experiment configurations (Section 4 + Figs 1-2).

Corpus dims match the UCI datasets exactly; document counts are scaled to
what a CPU container can generate (the streaming pipeline is O(docs) and
the reduction-ratio / topic-recovery claims are dimension-driven).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class SPCAExperiment:
    name: str
    n_words: int
    n_docs: int
    n_components: int = 5
    target_card: int = 5
    alpha: float = 1.1          # Zipf exponent
    seed: int = 0
    expected_reduced_max: int = 1000   # paper: n_hat <= 500 (NYT) / 1000 (PubMed)


NYTIMES = SPCAExperiment(
    name="nytimes", n_words=102_660, n_docs=30_000, expected_reduced_max=500
)
PUBMED = SPCAExperiment(
    name="pubmed", n_words=141_043, n_docs=50_000, alpha=1.05,
    expected_reduced_max=1000, seed=1,
)
