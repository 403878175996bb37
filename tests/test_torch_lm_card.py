"""The port's LM path on the card, in float32 with TF32 off: the serve
loop on the serving record's weights (`repro_torch.testing.lm_record`)
against the reference's logits and greedy tokens, and three train steps
from those weights (`repro_torch.testing.lm_train_record`) against the
reference's metrics, parameters and AdamW moments.

This file imports no jax, so it runs on a machine with a card and no jax
(``pytest --noconftest -m gpu tests/test_torch_lm_card.py``); without a
card its tests skip.  Tolerances: the CPU tests', ``LOGITS_TOL`` (1e-4) x
max |logits| and equal tokens; `lm_train_record.passes` for training.
"""
import pytest
import torch

from repro_torch.testing import lm_record as lr
from repro_torch.testing import lm_train_record as ltr


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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ltr.ARCHS)
def test_card_train_steps_match_record(cuda, arch):
    rec = ltr.load_record()[arch]
    res = ltr.compare(rec, ltr.run_record(arch, rec["init"], cuda))
    assert ltr.passes(res), res
