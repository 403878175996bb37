"""Guards of the port's package boundary: ``repro_torch`` (and
``chip_smoke.py``) never import jax or the reference package, entry points
refuse a missing card instead of falling back to the CPU, and the kernel
tests that need a card skip without one."""
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s))",
    re.M)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import repro_torch
        from repro_torch.core import SPCAConfig, fit_components
        from repro_torch.launch import spca_run
        from repro_torch import convert
        import chip_smoke
        rng = np.random.default_rng(0)
        X = rng.poisson(1.0, size=(200, 30)).astype(float)
        X[:100, :3] += rng.poisson(5.0, size=(100, 3))
        pcs = fit_components(X, 1, target_card=3, device="cpu",
                             cfg=SPCAConfig(max_sweeps=3, lam_search_evals=3))
        assert pcs[0].cardinality > 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("BAD", bad)
        assert not bad, bad
    """)
    env = {"PYTHONPATH": f"{REPO / 'src'}:{REPO}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"
    # the pattern itself: the port's own name must not match
    assert not _FORBIDDEN.search("import repro_torch\nfrom repro_torch import x")
    assert _FORBIDDEN.search("from repro.core import x")
    assert _FORBIDDEN.search("import jax.numpy as jnp")


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from repro_torch import device
    from repro_torch.core import fit_components, search_lambda
    from repro_torch.launch import spca_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.ones((10, 4))
    with pytest.raises(device.DeviceUnavailable, match="device='cpu'"):
        fit_components(X, 1)
    with pytest.raises(device.DeviceUnavailable):
        search_lambda(X, 1)
    with pytest.raises(device.DeviceUnavailable):
        spca_run.main(["--docs", "50", "--words", "60", "--components", "1"])
    with pytest.raises(device.DeviceUnavailable):
        device.resolve("cuda:0")
    assert device.resolve("cpu").type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import ops

    S = torch.eye(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bcd_solve(S, 0.1, 1e-4, impl="cuda")


def test_chip_smoke_refuses_without_card_and_outside_checkout(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scheme", ["smem", "global"])
def test_kernel_matches_plain_version_on_card(cuda, dtype, scheme):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    sizes = [40, 100, 17]
    S = np.zeros((3, 128, 128))
    X0 = np.zeros_like(S)
    for b, n in enumerate(sizes):
        F = rng.normal(size=(n + 12, n))
        S[b, :n, :n] = F.T @ F / (n + 12)
        X0[b, :n, :n] = np.eye(n)
    S = torch.tensor(S, dtype=dtype, device=cuda)
    X0 = torch.tensor(X0, dtype=dtype, device=cuda)
    lams = [0.3 * float(S[b].diagonal().max()) for b in range(3)]
    kw = dict(max_sweeps=3, qp_sweeps=2, tol=-1.0)
    got = ops.bcd_solve_batched(S, lams, 1e-4, X0, sizes, impl="cuda",
                                scheme=scheme, **kw)
    want = ops.bcd_solve_batched(S, lams, 1e-4, X0, sizes, impl="ref", **kw)
    assert torch.equal(got[2].cpu(), want[2].cpu())
    if dtype == torch.float64:
        torch.testing.assert_close(got[0], want[0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
