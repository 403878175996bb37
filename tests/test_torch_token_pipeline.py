"""The port's LM token pipeline (``repro_torch.data.pipeline``) against
the reference's: `TokenPipeline.batch_at` gives the same int32 tokens bit
for bit for several (seed, step, host_lo, host_hi), and the cases of
``tests/test_data.py`` (seekable and deterministic, host slices of the
right shape, `host_slice` partitions the global batch)."""
import numpy as np
import pytest

from repro.data import PipelineConfig as JCfg, TokenPipeline as JPipe
from repro.data.pipeline import host_slice as jhost_slice
from repro_torch.data import PipelineConfig, TokenPipeline, host_slice


@pytest.mark.parametrize("vocab,batch,seq,seed,walk", [
    (1000, 4, 16, 3, 7), (151_936, 8, 128, 0, 7), (512, 2, 16, 0, 7),
    (97, 5, 33, 11, 2)])
@pytest.mark.parametrize("step,lo,hi", [(0, 0, None), (7, 0, None),
                                        (123_456, 2, 4), (3, 1, 2)])
def test_batch_at_equals_reference_bit_for_bit(vocab, batch, seq, seed,
                                               walk, step, lo, hi):
    if hi is not None and hi > batch:
        hi = batch
    got = TokenPipeline(PipelineConfig(vocab, batch, seq, seed, walk)) \
        .batch_at(step, host_lo=lo, host_hi=hi)
    want = JPipe(JCfg(vocab, batch, seq, seed, walk)).batch_at(
        step, host_lo=lo, host_hi=hi)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_pipeline_deterministic_and_seekable():
    tp = TokenPipeline(PipelineConfig(vocab_size=1000, batch=4, seq_len=16,
                                      seed=3))
    assert (tp.batch_at(7) == tp.batch_at(7)).all()
    assert not (tp.batch_at(7) == tp.batch_at(8)).all()
    assert tp.batch_at(0).shape == (4, 16)
    assert tp.batch_at(0).max() < 1000
    it = iter(tp)
    for t in range(3):
        np.testing.assert_array_equal(next(it), tp.batch_at(t))


def test_pipeline_host_slice_partition():
    tp = TokenPipeline(PipelineConfig(vocab_size=100, batch=8, seq_len=4))
    full = tp.batch_at(3)
    assert full.shape == (8, 4)
    # host slices are independent draws keyed by (seed, step, lo)
    part = tp.batch_at(3, host_lo=4, host_hi=8)
    assert part.shape == (4, 4)
    np.testing.assert_array_equal(
        part, JPipe(JCfg(vocab_size=100, batch=8, seq_len=4)).batch_at(
            3, host_lo=4, host_hi=8))


@pytest.mark.parametrize("global_batch,count", [(8, 1), (8, 2), (8, 4),
                                                (12, 3), (7, 2)])
def test_host_slice_partitions_like_the_reference(global_batch, count):
    got = [host_slice(global_batch, process_index=i, process_count=count)
           for i in range(count)]
    want = [jhost_slice(global_batch, process_index=i, process_count=count)
            for i in range(count)]
    assert got == want
    assert got[0][0] == 0 and all(a[1] == b[0] for a, b in zip(got, got[1:]))
    # one process by default, as the reference in this single process
    assert host_slice(global_batch) == jhost_slice(global_batch) \
        == (0, global_batch)
