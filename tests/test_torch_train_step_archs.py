"""The port's train step against the reference's on the five smoke
configs that ``tests/test_torch_train_step.py`` does not run (the ten
are split over two files so that a run spread by file balances them):
one and three steps in float32 from the reference's ``PRNGKey(0)``
weights on the same batch, with the tolerances of
``tests/test_torch_train_parity.py``.  Each reference model is built and its
train step jitted once."""
import pytest

from test_torch_train_parity import (  # few_threads: an autouse fixture
    assert_parity, few_threads, port_run, reference_run,
)

ARCHS = ("phi3.5-moe-42b-a6.6b", "minitron-8b", "deepseek-67b",
         "gemma3-27b", "jamba-v0.1-52b")
STEPS = 3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    init, jm, js = reference_run(arch, STEPS)
    tm, ts = port_run(arch, init, STEPS)
    assert_parity(tm, ts, jm, js)
