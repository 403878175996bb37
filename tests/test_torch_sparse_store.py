"""The port's sharded CSR store (``repro_torch.sparse.store``) against the
reference's (``repro.sparse.store``): a store written by either package
loads in the other, the two write the same bytes (manifest v2 JSON and
``.npy`` files) from the same corpus, and both iterate the same chunks and
megabatches.  Integrity and the chunk contract raise as in the reference.
Everything here is exact: the store moves bytes, it computes nothing.
"""
import json
import os

import numpy as np
import pytest

from repro.data.corpus import make_corpus as jmake_corpus
from repro.sparse import store as jstore
from repro_torch.data.corpus import make_corpus as tmake_corpus
from repro_torch.sparse import store as tstore

DOCS, WORDS, SHARD_NNZ = 600, 900, 9_000


@pytest.fixture(scope="module")
def corpora():
    return (jmake_corpus(DOCS, WORDS, seed=3), tmake_corpus(DOCS, WORDS, seed=3))


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def _same_chunks(a, b, **kw):
    ca, cb = list(a.iter_chunks(**kw)), list(b.iter_chunks(**kw))
    assert len(ca) == len(cb) > 1
    for x, y in zip(ca, cb):
        for f in x._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def _same_megabatches(a, b, **kw):
    # copy each batch out of the buffer ring before drawing the next
    def draw(store):
        return [{f: np.array(getattr(mb, f)) for f in mb._fields}
                for mb in store.iter_megabatches(**kw)]

    ma, mb_ = draw(a), draw(b)
    assert len(ma) == len(mb_) > 1
    assert ma[-1]["n_chunks"] < kw["megabatch"]   # a ragged final batch
    for x, y in zip(ma, mb_):
        assert x.keys() == y.keys()
        for f in x:
            np.testing.assert_array_equal(x[f], y[f])


def test_stores_are_byte_identical(tmp_path, corpora):
    jc, tc = corpora
    np.testing.assert_array_equal(jc.counts, tc.counts)
    ja = jstore.write_corpus(jc, str(tmp_path / "ref"), shard_nnz=SHARD_NNZ)
    ta = tstore.write_corpus(tc, str(tmp_path / "port"), shard_nnz=SHARD_NNZ)
    assert ja.n_shards == ta.n_shards > 2
    fa, fb = _files(ja.path), _files(ta.path)
    assert fa.keys() == fb.keys()
    for name in fa:
        assert fa[name] == fb[name], name
    assert json.loads(fa["manifest.json"])["version"] == 2


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_store_loads_in_the_other_package(tmp_path, corpora, writer):
    jc, tc = corpora
    path = str(tmp_path / writer)
    if writer == "ref":
        jstore.write_corpus(jc, path, shard_nnz=SHARD_NNZ)
    else:
        tstore.write_corpus(tc, path, shard_nnz=SHARD_NNZ)
    a, b = jstore.SparseCorpus.open(path), tstore.SparseCorpus.open(path)
    assert a.shape == b.shape == (DOCS, WORDS) and a.nnz == b.nnz == jc.nnz
    assert b.verify() == a.verify() == 3 * a.n_shards
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())
    for kw in (dict(chunk_nnz=2048, chunk_rows=64),
               dict(chunk_nnz=700, chunk_rows=512)):
        assert a.n_chunks(**kw) == b.n_chunks(**kw)
        _same_chunks(a, b, **kw)
        C = next(m for m in (3, 4, 5, 7) if a.n_chunks(**kw) % m)
        _same_megabatches(a, b, megabatch=C, **kw)
    _same_chunks(a, b, chunk_nnz=2048, chunk_rows=64, host_id=1,
                 num_hosts=2)


def test_flipped_byte_raises_shard_corruption(tmp_path, corpora):
    store = tstore.write_corpus(corpora[1], str(tmp_path / "s"),
                                shard_nnz=SHARD_NNZ)
    name = store.manifest["shards"][1]["files"]["values"]
    path = os.path.join(store.path, name)
    raw = bytearray(open(path, "rb").read())
    raw[-5] ^= 0x10
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tstore.ShardCorruptionError) as ei:
        list(tstore.SparseCorpus.open(store.path).iter_chunks())
    assert ei.value.shard == name
    with pytest.raises(tstore.ShardCorruptionError):
        tstore.SparseCorpus.open(store.path).verify()
    # the reference refuses the same file
    with pytest.raises(jstore.ShardCorruptionError):
        jstore.SparseCorpus.open(store.path).verify()


def test_truncated_manifest_is_corruption(tmp_path, corpora):
    store = tstore.write_corpus(corpora[1], str(tmp_path / "s"))
    path = os.path.join(store.path, tstore.MANIFEST_NAME)
    text = open(path).read()
    open(path, "w").write(text[: len(text) // 2])
    with pytest.raises(tstore.ShardCorruptionError, match="manifest"):
        tstore.SparseCorpus.open(store.path)


def test_row_larger_than_chunk_raises(tmp_path):
    w = tstore.CSRStoreWriter(str(tmp_path / "s"), 30, shard_nnz=100)
    w.append_csr(np.ones(20, np.float32), np.arange(20, dtype=np.int32),
                 np.array([0, 20], np.int64))
    store = w.finish()
    with pytest.raises(ValueError, match="chunk_nnz"):
        list(store.iter_chunks(chunk_nnz=8, chunk_rows=4))
    with pytest.raises(ValueError, match="chunk_nnz"):
        list(store.iter_megabatches(chunk_nnz=8, chunk_rows=4))


def test_writer_validates_inputs(tmp_path):
    w = tstore.CSRStoreWriter(str(tmp_path / "s"), 10)
    with pytest.raises(ValueError, match="row_ptr"):
        w.append_csr(np.ones(3, np.float32), np.arange(3), [0, 2])
    with pytest.raises(ValueError, match="range"):
        w.append_csr(np.ones(2, np.float32), np.array([0, 10]), [0, 2])


@pytest.mark.parametrize("seed", [4, 9])
def test_dense_equals_the_reference(tmp_path, seed):
    """``Corpus.dense`` against the reference's array, bit for bit (as
    ``tests/test_sparse_store.py::test_write_corpus_matches_dense`` holds
    the reference's store to it), and against the port's store."""
    t = tmake_corpus(300, 500, topics={"t": ["x", "y"]}, seed=seed)
    j = jmake_corpus(300, 500, topics={"t": ["x", "y"]}, seed=seed)
    X = t.dense()
    assert X.dtype == np.float32 and X.shape == (300, 500)
    np.testing.assert_array_equal(X, j.dense())
    store = tstore.write_corpus(t, str(tmp_path / "c"), shard_nnz=5_000)
    np.testing.assert_allclose(store.to_dense(), X, rtol=0, atol=0)


def test_dense_refuses_past_its_budget():
    from repro_torch.data.corpus import DENSE_BYTE_BUDGET, Corpus

    t = tmake_corpus(300, 500, seed=4)
    need = 300 * 500 * 4
    assert t.dense(max_bytes=need).shape == (300, 500)
    with pytest.raises(MemoryError, match="repro_torch.sparse.write_corpus"):
        t.dense(max_bytes=need - 1)
    empty = np.zeros(0, np.int32)
    big = Corpus(n_docs=DENSE_BYTE_BUDGET // 4000 + 1, vocab=["w"] * 1000,
                 doc_idx=empty, word_idx=empty,
                 counts=np.zeros(0, np.float32))
    with pytest.raises(MemoryError, match="out-of-core sparse store"):
        big.dense()
