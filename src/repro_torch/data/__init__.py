"""Data of the port: synthetic corpora (numpy copy of
``repro.data.corpus``), the streaming accumulators (`bow`: dense row-block
and CSR legs, and the two-pass dense pipeline), the LM token pipeline and
the prefetch of the corpus passes (`pipeline`)."""
from . import bow, corpus, pipeline
from .bow import StreamingGram, StreamingStats, screen_and_gram_streaming
from .corpus import Corpus, make_corpus, nytimes_like, pubmed_like, zipf_rates
from .pipeline import PipelineConfig, TokenPipeline, host_slice, prefetch

__all__ = [
    "bow", "corpus", "pipeline", "StreamingGram", "StreamingStats",
    "screen_and_gram_streaming", "Corpus", "make_corpus", "nytimes_like",
    "pubmed_like", "zipf_rates", "prefetch", "PipelineConfig", "TokenPipeline",
    "host_slice",
]
