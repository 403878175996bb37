"""The port's LM serving path on the card: the serve loop on the record's
weights (`repro_torch.testing.lm_record`) against the reference's logits
and greedy tokens, in float32 with TF32 off.

This file imports no jax, so it runs on a machine with a card and no jax
(``pytest --noconftest -m gpu tests/test_torch_lm_card.py``); without a
card its tests skip.  Tolerance: the CPU test's, ``LOGITS_TOL`` (1e-4) x
max |logits|, and equal tokens.
"""
import pytest
import torch

from repro_torch.testing import lm_record as lr


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", lr.ARCHS)
def test_card_run_matches_record(cuda, arch):
    rec = lr.load_record()[arch]
    logits, tokens = lr.run_record(arch, rec["params"], rec["prompt"], cuda)
    res = lr.compare(rec, logits, tokens)
    assert res["logits_err_rel"] < lr.LOGITS_TOL, res
    assert res["tokens_equal"], (tokens, rec["tokens"])
