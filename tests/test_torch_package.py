"""Guards of the port's package boundary: ``repro_torch`` (and
``chip_smoke.py``) never import jax or the reference package, entry points
refuse a missing card instead of falling back to the CPU, and the kernel
tests that need a card skip without one.  This file imports no jax, so
its ``gpu``-marked tests run on a machine with a card and no jax
(``pytest --noconftest -m gpu tests/test_torch_package.py``)."""
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
        from repro_torch.launch import serve_topics, spca_run
        from repro_torch import checkpoint, convert, serve
        from repro_torch import configs, models, train
        from repro_torch.launch import serve as lm_serve
        from repro_torch.testing import lm_record
        from repro_torch import optim
        from repro_torch.optim import adamw, compression, schedule
        from repro_torch.train import trainer
        from repro_torch.launch import analysis, train as lm_train
        from repro_torch.testing import lm_train_record
        from repro_torch import distributed
        from repro_torch.distributed import sharding
        from repro_torch.launch import dryrun, inputs, mesh
        from repro_torch.optim.compression import compressed_pmean
        from repro_torch.core.distributed import data_axes_of
        assert mesh.make_production_mesh(device="meta").shape == {
            "data": 16, "model": 16}
        assert analysis.count_params(configs.get_config("qwen2-0.5b"))[
            "total"] == 494032768
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
    names = {p.relative_to(REPO / "src" / "repro_torch").as_posix()
             for p in files}
    assert {"distributed/__init__.py", "distributed/sharding.py",
            "launch/inputs.py", "launch/dryrun.py"} <= names
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "scripts").glob("*.py"))
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
    from repro_torch.launch import serve_topics, spca_run
    from repro_torch.serve import ModelRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.ones((10, 4))
    with pytest.raises(device.DeviceUnavailable, match="device='cpu'"):
        fit_components(X, 1)
    with pytest.raises(device.DeviceUnavailable):
        search_lambda(X, 1)
    with pytest.raises(device.DeviceUnavailable):
        spca_run.main(["--docs", "50", "--words", "60", "--components", "1"])
    with pytest.raises(device.DeviceUnavailable):
        serve_topics.main(["--smoke", "--docs", "50", "--words", "60"])
    with pytest.raises(device.DeviceUnavailable):
        ModelRegistry(None)
    from repro_torch.launch import train as lm_train
    with pytest.raises(device.DeviceUnavailable):
        lm_train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])
    with pytest.raises(device.DeviceUnavailable):
        device.resolve("cuda:0")
    assert device.resolve("cpu").type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import ops

    S = torch.eye(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bcd_solve(S, 0.1, 1e-4, impl="cuda")


def test_build_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library's name hashes its source AND every shared ``csrc/*.cuh``,
    so an edited header is rebuilt, never loaded stale (no nvcc needed)."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._target(n) for n in ("gram", "csr_gram", "variance")}
    assert before["gram"] == _build._target("gram")        # deterministic
    header = csrc / "gram_tc.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    (csrc / "extra.cuh").write_text("// a new shared header\n")
    assert _build._target("gram") != after["gram"]
    (csrc / "extra.cuh").unlink()
    assert _build._target("gram") == after["gram"]


def test_phase_trace_reads_marks_the_kernels_carry():
    """``scripts/phase_trace.py`` reads the columns of the kernels' own
    phase marks (no source text matched): every phase it reads is marked
    in its kernel, and its copies define the marks ahead of the headers'
    empty defaults: ``GRAM_TRACE`` in K3 and K6, ``PHASE_*`` in K1 (the
    spans of a solve's phases and its bisection steps), K2 and K7 (the
    one-warp scheme's copy, matvec, chain and write-out)."""
    import importlib.util

    from repro_torch.kernels import _build

    spec = importlib.util.spec_from_file_location(
        "phase_trace", REPO / "scripts" / "phase_trace.py")
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    assert "#define GRAM_TRACE(col)" in trace.RECORDER
    assert "#ifndef GRAM_TRACE" in (_build.CSRC / "gram_tc.cuh").read_text()
    for name, phases in (("gram", trace.K6_PHASES),
                         ("csr_gram", trace.K3_PHASES)):
        marks = re.findall(r"GRAM_TRACE\((\d+)\)",
                           (_build.CSRC / f"{name}.cu").read_text())
        assert sorted(int(c) for c in marks) == [0] + sorted(
            col for _, col in phases), name
    for mark in ("START", "MARK", "SPAN", "COUNT"):
        assert f"#define PHASE_{mark}(" in trace.RECORDER
    assert "#ifndef PHASE_START" in (
        _build.CSRC / "phase_trace.cuh").read_text()
    for name, cols in (
            ("csr_stats", {c for _, c in trace.K2_PHASES}),
            ("bcd_fused", {c for _, c in trace.K1_PHASES}
             | {trace.K1_TAU_STEPS, trace.K1_END}),
            ("bcd_sweep", {c for _, c in trace.K7_PHASES} | {trace.K7_END})):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "phase_trace.cuh"' in src, name
        assert re.search(r"PHASE_START\(", src), name
        marked = {int(c) for c in re.findall(
            r"PHASE_(?:MARK|SPAN|COUNT)\([^;]*?,\s*(\d+)\s*[,)]", src)}
        assert marked == cols, (name, marked, cols)
    assert set(trace.SOURCES.values()) == {"bcd_fused", "csr_stats",
                                           "csr_gram", "gram", "bcd_sweep"}


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


def _hold_k1(S, X0, lams, betas, sizes, kw, dtype, scheme="auto"):
    """K1 against its plain version (on the host): float64 X and F to
    1e-10, float32 F to 1e-4 relative; equal sweep counts."""
    from repro_torch.kernels import ops

    got = ops.bcd_solve_batched(S, lams, betas, X0, sizes, impl="cuda",
                                scheme=scheme, **kw)
    want = ops.bcd_solve_batched(S.cpu(), lams, betas, X0.cpu(), sizes,
                                 impl="ref", **kw)
    got = [g.cpu() for g in got]
    assert torch.equal(got[2], want[2])
    if dtype == torch.float64:
        torch.testing.assert_close(got[0], want[0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_valid", [1, 31, 32, 33, 224])
def test_warp_kernel_at_lane_edges_on_card(cuda, dtype, n_valid):
    """One warp a problem: n_valid 1 (no free coordinate), 31/32/33 about
    a lane slot's edge, 224 (seven slots, the float32 ``smem`` limit; the
    ``global`` scheme in float64), in every scheme that fits."""
    from repro_torch.kernels import bcd_fused
    from repro_torch.testing import covariance_problems

    rng = np.random.default_rng(n_valid)
    S, X0, lams, betas = covariance_problems(
        rng, [n_valid], bcd_fused.pad32(n_valid),
        np.float32 if dtype == torch.float32 else np.float64)
    S, X0 = (torch.from_numpy(a).to(cuda) for a in (S, X0))
    kw = dict(max_sweeps=2, qp_sweeps=2, tol=-1.0)
    for scheme in ("smem", "global"):
        try:
            bcd_fused.plan_fused_solve(n_valid, S.element_size(), scheme)
        except ValueError:
            continue
        _hold_k1(S, X0, lams, betas, [n_valid], kw, dtype, scheme)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scheme", ["smem", "global"])
def test_mixed_batch_and_no_bisection_on_card(cuda, dtype, scheme):
    """Nine problems of mixed n_valid in one launch (a CTA each), against
    the plain version; then ``tau_iters`` 0 (tau the bracket's midpoint)
    on the same batch."""
    from repro_torch.testing import covariance_problems

    sizes = [60, 33, 1, 47, 64, 32, 2, 59, 17]
    S, X0, lams, betas = covariance_problems(
        np.random.default_rng(7), sizes, 64,
        np.float32 if dtype == torch.float32 else np.float64)
    S, X0 = (torch.from_numpy(a).to(cuda) for a in (S, X0))
    for tau_iters in (80, 0):
        kw = dict(max_sweeps=2, qp_sweeps=2, tol=-1.0, tau_iters=tau_iters)
        _hold_k1(S, X0, lams, betas, sizes, kw, dtype, scheme)


@pytest.mark.gpu
def test_kernel_division_is_the_cards_ieee_division(cuda):
    """K1 divides with the divisor's reciprocal formed ahead of the
    dividend: its quotients equal the card's IEEE `x / y` bit for bit,
    over 2^22 pairs spanning the exponent range and its edges (signed
    zeros, denormals, the fast path's range bounds, inf and NaN)."""
    from repro_torch.kernels import bcd_fused

    rng = np.random.default_rng(5)
    n = 1 << 22

    def draw():
        v = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-149, 128, n)
             * rng.choice([-1, 1], n)).astype(np.float32)
        near = rng.random(n) < 0.5                 # half near the fit's values
        v[near] = (rng.standard_normal(near.sum()) * 10.0 ** rng.uniform(
            -6, 4, near.sum())).astype(np.float32)
        edge = np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 2.0 ** -60,
                         2.0 ** 60, np.nextafter(np.float32(2.0 ** -60), 0),
                         np.nextafter(np.float32(2.0 ** 60), np.inf),
                         3.4028235e38, np.inf, -np.inf, np.nan, 1.0],
                        np.float32)
        v[rng.integers(0, n, 4096)] = rng.choice(edge, 4096)
        return v

    x, y = (torch.from_numpy(draw()).to(cuda) for _ in range(2))
    got = bcd_fused.divide_on_card(x, y)
    want = x / y
    same = got.view(torch.int32) == want.view(torch.int32)
    both_nan = torch.isnan(got) & torch.isnan(want)
    assert bool((same | both_nan).all()), int((~(same | both_nan)).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_hot_column", "table_overflow"])
def test_csr_stats_table_and_workspace_on_card(cuda, case):
    """K2 on integer counts: one column holding most entries (the table's
    hot slot), and more distinct columns in a CTA's share than its table
    holds (entries past the probes go straight to the accumulator).
    Exact against the plain version, identical run to run, and the
    stream's workspace zero after each call."""
    from repro_torch.kernels import _build, csr_stats, ops

    rng = np.random.default_rng(3)
    if case == "one_hot_column":              # the streaming fit's shape
        C, E, n = 8, 16384, 102_660
        cols = rng.integers(0, n, size=(C, E))
        cols[rng.random((C, E)) < 0.9] = 4242
    else:                                     # every column distinct
        C, E, n = 40, 16384, 700_000
        cols = rng.permutation(n)[:C * E].reshape(C, E)
        plan = csr_stats.plan_csr_stats(C * E, n)
        assert plan.share > plan.table_slots == csr_stats.MAX_SLOTS
    vals = rng.integers(1, 6, size=(C, E)).astype(np.float32)
    vals[:, -100:] = 0                        # padding
    cols = cols.astype(np.int32)
    cols[0, :5] = [-1, n, n + 7, -9, 0]       # dropped, and a real column 0
    v, c = torch.from_numpy(vals).to(cuda), torch.from_numpy(cols).to(cuda)
    want = ops.csr_column_stats(v, c, n=n, impl="ref")
    first = ops.csr_column_stats(v, c, n=n, impl="cuda")
    second = ops.csr_column_stats(v, c, n=n, impl="cuda")
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, w) and torch.equal(b, w)
    torch.cuda.synchronize()
    _, stream = _build.launch_on(cuda)
    acc = csr_stats.workspace(cuda, stream, n)
    assert int(torch.count_nonzero(acc)) == 0


def _csr_megabatch(C, E, R, n, nnz, seed):
    """C padded chunks: chunk c holds ``nnz[c]`` entries at distinct
    (row, col) in [0, R) x [0, n + 25) (columns >= n are off-support
    sentinels for the Gram), rows unsorted, then value-0 padding."""
    rng = np.random.default_rng(seed)
    vals = np.zeros((C, E), np.float32)
    cols = np.zeros((C, E), np.int32)
    segs = np.zeros((C, E), np.int32)
    for c, k in enumerate(nnz):
        cells = rng.choice(R * (n + 25), size=k, replace=False)
        vals[c, :k] = rng.normal(size=k)
        segs[c, :k], cols[c, :k] = np.divmod(cells, n + 25)
    return vals, cols, segs


@pytest.mark.gpu
@pytest.mark.parametrize("C,E,R,n_hat,nnz", [
    (4, 512, 32, 130, [512, 512, 300, 0]),   # a chunk with no real entry
    (1, 2048, 64, 33, [2000]),
    (8, 1024, 512, 300, [1024] * 7 + [17]),
    (8, 16384, 512, 220, [16384] * 8),       # the fit's shape: 4 slabs, 32 parts
    (2, 4096, 908, 97, [4096, 1500]),        # the PR 12 row cap: 8 slabs
    (3, 1001, 64, 70, [1001, 500, 3]),       # E % 4 != 0: 4-byte copies
    (20, 256, 16, 65, [256] * 19 + [9]),     # 20 chunks: 3 a CTA, cluster of 7
])
def test_csr_kernels_match_plain_versions_on_card(cuda, C, E, R, n_hat, nnz):
    """K2 and K3 against their plain versions: 1e-6 of the largest entry
    (float32 sums in another order); K3 symmetric and deterministic.
    Rows are unsorted; n_hat is not a multiple of the 64-wide tile."""
    from repro_torch.kernels import ops

    vals, cols, segs = (torch.from_numpy(a).to(cuda) for a in
                        _csr_megabatch(C, E, R, n_hat, nnz, C * E))

    def close(a, b):
        assert a.shape == b.shape
        tol = 1e-6 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol

    n = n_hat + 25
    for got, want in zip(ops.csr_column_stats(vals, cols, n=n, impl="cuda"),
                         ops.csr_column_stats(vals, cols, n=n, impl="ref")):
        close(got, want)
    kw = dict(n_rows=R, n_hat=n_hat)
    G = ops.csr_gram_batched(vals, cols, segs, impl="cuda", **kw)
    close(G, ops.csr_gram_batched(vals, cols, segs, impl="ref", **kw))
    assert torch.equal(G, G.T)
    assert torch.equal(G, ops.csr_gram_batched(vals, cols, segs, impl="cuda",
                                               **kw))
    close(ops.csr_gram(vals[0], cols[0], segs[0], impl="cuda", **kw),
          ops.csr_gram(vals[0], cols[0], segs[0], impl="ref", **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("C,E,R,n_hat", [(8, 4096, 512, 220), (1, 999, 37, 9),
                                         (3, 2048, 908, 130)])
def test_csr_gram_kernel_sums_duplicates_exactly_on_card(cuda, C, E, R,
                                                         n_hat):
    """K3 on bag-of-words counts with duplicate (row, col) entries,
    unsorted rows, off-support sentinels, rows past R and padding: equal
    to its plain version (each summed cell an integer of at most 11
    significant bits, so the 3xTF32 split is exact, and every partial sum
    an integer below 2^24), symmetric, the same bits on a second launch,
    one launch a call."""
    from repro_torch.kernels import csr_gram, ops

    rng = np.random.default_rng(C * E + R)
    vals = rng.choice([1, 1, 1, 2, 3, 7, 40], size=(C, E)).astype(np.float32)
    segs = rng.integers(0, R + 3, size=(C, E)).astype(np.int32)
    cols = rng.integers(-2, n_hat + 25, size=(C, E)).astype(np.int32)
    dup = rng.random((C, E)) < 0.3          # copy an earlier entry's cell
    src = rng.integers(0, np.arange(E) + 1, size=(C, E))
    for c in range(C):
        segs[c, dup[c]] = segs[c, src[c, dup[c]]]
        cols[c, dup[c]] = cols[c, src[c, dup[c]]]
    vals[:, E - E // 5:] = 0.0              # padding
    keep = (vals != 0) & (cols >= 0) & (cols < n_hat) & (segs < R)
    B = np.zeros((C, R, n_hat))
    np.add.at(B, (np.nonzero(keep)[0], segs[keep], cols[keep]), vals[keep])
    assert B.max() <= 2048
    vals, cols, segs = (torch.from_numpy(a).to(cuda) for a in
                        (vals, cols, segs))
    kw = dict(n_rows=R, n_hat=n_hat)
    want = ops.csr_gram_batched(vals, cols, segs, impl="ref", **kw)
    assert float(want.abs().max()) < 2 ** 24
    csr_gram.reset_launches()
    G = ops.csr_gram_batched(vals, cols, segs, impl="cuda", **kw)
    again = ops.csr_gram_batched(vals, cols, segs, **kw)
    torch.cuda.synchronize()
    assert csr_gram.launches == 2
    assert torch.equal(G, want) and torch.equal(G, again)
    assert torch.equal(G, G.T)


def _serving_pack(rng, n, k, cap, card, *, overlap=0, empty=None):
    """A packed model in the projector's layout: component c holds
    ``card[c]`` words (the first ``overlap`` shared by all), the rest of
    its ``cap`` slots padding (index 0, value 0); ``empty`` is a component
    that is all padding."""
    sidx = np.zeros((k, cap), np.int32)
    vals = np.zeros((k, cap), np.float32)
    shared = rng.choice(n, size=overlap, replace=False)
    for c in range(k):
        if c == empty:
            continue
        own = rng.choice(n, size=card[c] - overlap, replace=False)
        words = np.sort(np.concatenate([shared, own]))
        sidx[c, :words.size] = words
        vals[c, :words.size] = rng.normal(size=words.size)
    return sidx, vals


@pytest.mark.gpu
@pytest.mark.parametrize("B,cap,overlap,empty", [
    (64, 8, 0, None),        # the serving shape at NYTimes width
    (1, 8, 0, None),
    (512, 16, 3, None),
    (64, 8, 2, 3),
])
def test_sparse_project_kernel_matches_plain_version_on_card(cuda, B, cap,
                                                             overlap, empty):
    """K4 against its plain version at n = 102,660, k = 5: within 1e-5 of
    the largest |score| (both sum each component's slots in slot order,
    multiply then add, so they agree to the bit on finite input), the
    same on a second launch, and one launch per call."""
    from repro_torch.kernels import ops, project

    n, k = 102_660, 5
    rng = np.random.default_rng(B * cap + overlap)
    sidx, vals = _serving_pack(rng, n, k, cap,
                               [min(cap, 4 + c) for c in range(k)],
                               overlap=overlap, empty=empty)
    X = rng.poisson(0.002, size=(B, n)).astype(np.float32)
    X[:, sidx[sidx > 0]] += rng.poisson(2.0, size=(B, int((sidx > 0).sum())))
    X, sidx, vals = (torch.from_numpy(a).to(cuda) for a in (X, sidx, vals))
    project.reset_launches()
    got = ops.sparse_project(X, sidx, vals, impl="cuda")
    again = ops.sparse_project(X, sidx, vals)
    want = ops.sparse_project(X, sidx, vals, impl="ref")
    torch.cuda.synchronize()
    assert project.launches == 2
    assert got.shape == (B, k) and got.dtype == torch.float32
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, again)
    if empty is not None:
        assert not got[:, empty].any()


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(256, 1000), (48, 517), (1, 33), (300, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_column_stats_kernel_matches_plain_version_on_card(cuda, m, n, dtype):
    """K5: integer counts exactly (every float32 partial sum is exact), and
    the same bits on a second launch; random floats within 2 gamma_m of
    the sums of |a| and a^2 (two float32 sums of m terms in any order)."""
    from repro_torch.kernels import ops, variance

    rng = np.random.default_rng(m + n)
    counts = torch.from_numpy(rng.poisson(0.5, size=(m, n))).to(cuda, dtype)
    variance.reset_launches()
    got = ops.column_stats(counts, impl="cuda")
    again = ops.column_stats(counts)
    for g, a, w in zip(got, again, ops.column_stats(counts, impl="ref")):
        assert torch.equal(g, w) and torch.equal(g, a)
    assert variance.launches == 2
    A = torch.from_numpy(rng.normal(size=(m, n))).to(cuda, dtype)
    A32 = A.float().double()
    gamma = m * 2.0 ** -24 / (1 - m * 2.0 ** -24)
    bounds = (2 * gamma * A32.abs().sum(0), 2 * gamma * (A32 * A32).sum(0))
    for g, w, b in zip(ops.column_stats(A, impl="cuda"),
                       ops.column_stats(A, impl="ref"), bounds):
        assert bool(((g.double() - w.double()).abs() <= b).all())


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [
    (256, 500), (48, 500), (256, 2048), (37, 1), (65, 33),
    (300, 130),     # n % 4 != 0 (4-byte copies); 5 slabs of 64: split on
    (256, 2047),    # n % 4 != 0, 528 tiles: split off
    (1000, 64),     # one tile, 8 slabs of 128 rows; m not a multiple of 128
    (97, 4000),     # split off, m not a multiple of the 32-row panel
    (0, 7),         # no rows: zeros
])
def test_gram_kernel_matches_plain_version_on_card(cuda, m, n):
    """K6: integer counts exactly (a few up to 2048: the 3xTF32 split's lo
    is 0), symmetric, the same bits on a second launch; random floats
    within 2 gamma_(m+1) |A|^T |A| elementwise."""
    from repro_torch.kernels import gram, ops

    rng = np.random.default_rng(m * n)
    counts = rng.poisson(0.5, size=(m, n))
    if m:
        big = rng.integers(0, m, size=3), rng.integers(0, n, size=3)
        counts[big] = [2048, 2047, 1025]
    counts = torch.from_numpy(counts).to(cuda, torch.float32)
    gram.reset_launches()
    G = ops.gram(counts, impl="cuda")
    assert torch.equal(G, ops.gram(counts, impl="ref"))
    assert torch.equal(G, G.T) and torch.equal(G, ops.gram(counts))
    assert gram.launches == 2
    A = torch.from_numpy(rng.normal(size=(m, n))).to(cuda, torch.float32)
    Ad = A.double().abs()
    gamma = (m + 1) * 2.0 ** -24 / (1 - (m + 1) * 2.0 ** -24)
    diff = (ops.gram(A, impl="cuda").double()
            - ops.gram(A, impl="ref").double()).abs()
    assert bool((diff <= 2 * gamma * (Ad.T @ Ad)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,j", [(16, 0), (48, 17), (192, 191), (500, 250)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_qp_sweep_kernel_matches_plain_version_on_card(cuda, n, j, dtype):
    """K7 on a row update's symmetric Y, each output (u, w, R2) against
    its own largest |value|: float64 to 1e-12, float32 to 1e-4 (w = Y u0
    and R2 are reduced in another order); the pinned coordinate
    untouched; the same bits on a second launch."""
    from repro_torch.kernels import bcd_sweep, ops

    rng = np.random.default_rng(n + j)
    F = rng.normal(size=(n + 9, n))
    X = F.T @ F / (n + 9) + 0.1 * np.eye(n)
    m = np.ones(n)
    m[j] = 0.0
    Y = torch.tensor(X * m[:, None] * m[None, :], dtype=dtype, device=cuda)
    s = torch.tensor(rng.normal(size=n) * m, dtype=dtype, device=cuda)
    lam = 0.4 * float(s.abs().max())
    bcd_sweep.reset_launches()
    got = ops.qp_sweeps(Y, s, lam, s, j, sweeps=4, impl="cuda")
    again = ops.qp_sweeps(Y, s, lam, s, j, sweeps=4)
    want = ops.qp_sweeps(Y, s, lam, s, j, sweeps=4, impl="ref")
    torch.cuda.synchronize()
    assert bcd_sweep.launches == 2
    rtol = 1e-12 if dtype == torch.float64 else 1e-4
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert float((g - w).abs().max()) <= rtol * float(w.abs().max())
    assert float(got[0][j]) == 0.0


def _qp_row_update(n, j, kind, dtype, device, seed):
    """A row update's box QP on the card: ``(Y, s, lam)``, Y symmetric
    with row and column j zero, s_j zero.  ``dense``: X = F^T F / (n + 9)
    + 0.1 I; ``nonpos_diag``: that X with every third diagonal entry 0 or
    negative (the step's y1 <= 0 branch); ``identity``: X = I, the first
    row update of a solve from the identity (every dividend zero);
    ``row_j_kept``: the dense X with row and column j left as they are
    (the kernel must not rely on them being zero)."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n + 9, n))
    X = F.T @ F / (n + 9) + 0.1 * np.eye(n)
    if kind == "nonpos_diag":
        d = np.arange(0, n, 3)
        X[d, d] = -X[d, d] * (d % 2)
    elif kind == "identity":
        X = np.eye(n)
    m = np.ones(n)
    m[j] = 0.0
    S = F.T @ F / (n + 9)
    if kind != "row_j_kept":
        X = X * m[:, None] * m[None, :]
    Y = torch.tensor(X, dtype=dtype, device=device)
    s = torch.tensor(S[:, j] * m, dtype=dtype, device=device)
    return Y, s, 0.4 * float(s.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("sweeps", [0, 1])
@pytest.mark.parametrize("at", ["first", "last"])
@pytest.mark.parametrize("dtype,n", [
    (torch.float32, 9), (torch.float32, 33), (torch.float32, 97),
    (torch.float32, 224), (torch.float32, 225), (torch.float64, 160),
    (torch.float64, 161)])
def test_qp_sweep_schemes_match_plain_version_on_card(cuda, dtype, n, at,
                                                      sweeps):
    """K7 about its schemes' edges (float32 n 224 the last ``warp``, 225
    ``block``; float64 160 / 161), j first and last, no sweep and one, on
    a dense Y, one with non-positive diagonal entries, an identity start
    and a Y whose row and column j are not zero: each output against its
    own largest |value| (float64 1e-12, float32 1e-4), the pinned
    coordinate untouched, one launch each."""
    from repro_torch.kernels import bcd_sweep, ops

    j = 0 if at == "first" else n - 1
    for kind in ("dense", "nonpos_diag", "identity", "row_j_kept"):
        Y, s, lam = _qp_row_update(n, j, kind, dtype, cuda, seed=n + j)
        bcd_sweep.reset_launches()
        got = ops.qp_sweeps(Y, s, lam, s, j, sweeps=sweeps, impl="cuda")
        want = ops.qp_sweeps(Y, s, lam, s, j, sweeps=sweeps, impl="ref")
        torch.cuda.synchronize()
        assert bcd_sweep.launches == 1
        rtol = 1e-12 if dtype == torch.float64 else 1e-4
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= rtol * scale, kind
        assert float(got[0][j]) == float(s[j]) == 0.0, kind
        if sweeps == 0:
            assert torch.equal(got[0], s), kind


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n", [
    (torch.float32, 1), (torch.float32, 9), (torch.float32, 33),
    (torch.float32, 97), (torch.float32, 192), (torch.float32, 224),
    (torch.float64, 33), (torch.float64, 160)])
def test_qp_sweep_warp_and_block_give_the_same_bits_on_card(cuda, dtype, n):
    """Where both schemes fit, the one-warp kernel and the block-wide one
    reduce in one order: the same bits for w and R2, and u up to the sign
    of a zero, at j first, middle and last, 4 sweeps, on the four kinds
    of Y (row and column j kept among them), also with Y at a storage
    offset that no 16-byte boundary meets (the bulk copy's unaligned head
    and tail)."""
    from repro_torch.kernels import bcd_sweep

    for kind in ("dense", "nonpos_diag", "identity", "row_j_kept"):
        for j in sorted({0, n // 2, n - 1}):
            Y, s, lam = _qp_row_update(n, j, kind, dtype, cuda, seed=3 * n + j)
            for offset in (0, 1, 3):
                buf = torch.zeros(n * n + offset, dtype=dtype, device=cuda)
                buf[offset:] = Y.reshape(-1)
                Yv = buf[offset:].view(n, n)
                warp = bcd_sweep.qp_sweep_cuda(Yv, s, lam, s, j, 4, "warp")
                block = bcd_sweep.qp_sweep_cuda(Yv, s, lam, s, j, 4, "block")
                torch.cuda.synchronize()
                case = (kind, j, offset)
                assert torch.equal(warp[1], block[1]), case
                assert torch.equal(warp[2], block[2]), case
                assert torch.equal(warp[0] + 0.0, block[0] + 0.0), case
