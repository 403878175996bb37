"""Data of the port: synthetic corpora (numpy copy of
``repro.data.corpus``), the streaming accumulators (`bow`: dense row-block
and CSR legs, and the two-pass dense pipeline) and the prefetch pipeline
of the corpus passes (`pipeline`)."""
from .bow import StreamingGram, StreamingStats, screen_and_gram_streaming

__all__ = ["StreamingGram", "StreamingStats", "screen_and_gram_streaming"]
