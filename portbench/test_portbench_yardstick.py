"""The benchmark's arithmetic on synthetic samples and profiler events."""
import json
import types

import pytest

from portbench import yardstick as ys


def test_k1_counts_follow_the_loops():
    # one sweep over 2 coordinates, 1 box-QP pass, 1 bisection step:
    # a row is 2*4 + 1*1*(2*2+10) + 4*2 + 8 = 38; 2 rows + 4*4 = 92
    assert ys.k1_ops(2, 1, 1, 1) == 92
    assert ys.k1_ops(48, 4, 80, 0) == 0
    assert ys.k1_ops(48, 4, 80, 3) == 3 * ys.k1_ops(48, 4, 80, 1)
    assert ys.k1_bytes(4, 32, [2, 5]) == 4 * (3 * 32 * 32 + 6 + 2) \
        + 4 * (3 * 32 * 32 + 9 + 2)


def test_bound_is_the_larger_of_operations_and_bytes():
    # operations bound: 67e9 operations take 1 ms; bytes bound: 3.35 GB
    assert ys.bound_s(67e9, 1.0) == pytest.approx(1e-3)
    assert ys.bound_s(1.0, 3.35e9) == pytest.approx(1e-3)


def _events():
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}
    return [
        x("user_annotation", ys.WINDOW, 0, 1000),
        x("user_annotation", "portbench.screen", 0, 300),
        x("cpu_op", "aten::copy_", 250, 40),
        x("kernel", "bcd_fused_warp_kernel", 100, 100),
        x("kernel", "bcd_fused_warp_kernel", 150, 100),   # overlaps the last
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 400, 50,
          bytes=4096),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 10,
          bytes=64),
        x("kernel", "csr_gram_kernel", 900, 200),         # runs past the end
        {"ph": "i", "name": "marker", "ts": 5},
    ]


def test_trace_reduction_on_synthetic_events(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    ev = ys.load_trace(str(path))
    assert len(ev) == 8
    dev = ys.device_events(ev)
    lo, hi = ys.window_of(ev, ys.WINDOW)
    assert (lo, hi) == (0.0, 1000.0)
    # busy: [100, 250] + [400, 450] + [600, 610] + [900, 1000]
    assert ys.busy_us(dev, lo, hi) == pytest.approx(150 + 50 + 10 + 100)
    assert ys.kernel_us(dev, lo, hi, "bcd_fused") == pytest.approx(200)
    top = ys.top_ops(dev, lo, hi)
    assert top[0] == ["bcd_fused_warp_kernel", pytest.approx(200e-6)]
    gaps = ys.idle_gaps(ev, dev, lo, hi, k=4)
    # [610, 900] is the longest gap; [0, 100], the shortest, lies inside
    # the screen's annotation
    assert [g[1] * 1e6 for g in gaps] == pytest.approx([290, 150, 150, 100])
    assert gaps[0][0] == "idle"
    assert gaps[3][0] == "portbench.screen"
    assert ys.union([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
    t = types.SimpleNamespace(device=dev, lo=lo, hi=hi)
    assert ys.idle_pct(t) == pytest.approx(100.0 * (1000 - 310) / 1000)
    assert ys.idle_pct(types.SimpleNamespace(device=dev, lo=5.0,
                                             hi=5.0)) is None
