"""Test config: f64 for solver numerics (models pin their own dtypes).

NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests and
benches must see the real single device; multi-device tests spawn
subprocesses with their own XLA_FLAGS (see test_distributed.py).

Tier-1 (``python -m pytest -x -q``) deselects tests marked ``slow`` (the
heavier corpus/serving end-to-end runs) to keep the loop fast; run them
with ``pytest --runslow``.
"""
import jax
import pytest

jax.config.update("jax_enable_x64", True)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked @pytest.mark.slow",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy corpus/serve test, deselected by default"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA); skips without one"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
