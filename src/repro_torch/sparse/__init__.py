"""Out-of-core sparse corpus engine (port of ``repro.sparse``).

  store.py  — disk-backed sharded CSR store (writer, manifest v2 with
              crc32 checksums, mmap reader, fixed-shape padded chunk and
              megabatch iterators, retrying reader), byte-compatible with
              the reference's
  engine.py — streaming screen/Gram over a store through kernels K2
              (``kernels/csrc/csr_stats.cu``) and K3
              (``kernels/csrc/csr_gram.cu``), and the ``(variances,
              build)`` pair `core.spca` consumes

Not ported yet: ``mesh_engine`` (ROADMAP queue 1 item 12) and ``resume``
(item 8).
"""
from .engine import (
    screen_and_gram_sparse, sparse_feature_variances, sparse_reduced_covariance,
    sparse_stats,
)
from .store import (
    CSRChunk, CSRMegaBatch, CSRStoreWriter, DEFAULT_CHUNK_NNZ,
    DEFAULT_CHUNK_ROWS, ShardCorruptionError, SparseCorpus, write_corpus,
)

__all__ = [
    "CSRChunk", "CSRMegaBatch", "CSRStoreWriter", "DEFAULT_CHUNK_NNZ",
    "DEFAULT_CHUNK_ROWS", "ShardCorruptionError", "SparseCorpus",
    "write_corpus", "screen_and_gram_sparse", "sparse_feature_variances",
    "sparse_reduced_covariance", "sparse_stats",
]
