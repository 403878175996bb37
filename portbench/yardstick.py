"""The benchmark's arithmetic: the card's peaks, the operations and bytes
of each kernel counted from its shapes, and the reduction of a profiler
trace to busy time, idle gaps and kernel times.

The peaks and the K1 counts are those `chip_smoke.py` uses; they
are kept here so that a change to the program cannot change its own
yardstick.  A kernel's counts are of the work its inputs need (K1: the
sweeps each problem ran, as its launch reported them), whatever
implements it.
"""
from __future__ import annotations

import json

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12      # HBM3

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def k1_ops(n_valid: int, qp_sweeps: int, tau_iters: int, sweeps: int) -> int:
    """Floating-point operations of one BCD solve that ran ``sweeps``
    sweeps over ``n_valid`` coordinates: each row update's w = Y s, its
    box-QP coordinate steps, trace and u.w and the bisection in tau, and
    the objective after each sweep."""
    nv = int(n_valid)
    row = (2 * nv * nv + qp_sweeps * (nv - 1) * (2 * nv + 10) + 4 * nv
           + 8 * tau_iters)
    return int(sweeps) * (nv * row + 4 * nv * nv)


def k1_bytes(itemsize: int, n_pad: int, sweeps) -> int:
    """Bytes one K1 launch must move: each problem's Sigma and X0 read and
    X written (n_pad^2 each), its four scalars, its objective history and
    its two outputs of meta."""
    return int(sum(itemsize * (3 * n_pad * n_pad + 4 + int(s) + 2)
                   for s in sweeps))


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 rate and the bytes over the memory rate."""
    return max(ops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S)


# ------------------------------------------------------------ trace reduction

def load_trace(path: str) -> list[dict]:
    """The complete ("X") events of a `torch.profiler` Chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_events(events) -> list[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def window_of(events, name: str):
    """``(start, end)`` in trace microseconds of the host annotation
    ``name``, or None."""
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def clipped(events, lo: float, hi: float):
    """``(start, end, event)`` of each event, cut to [lo, hi]."""
    out = []
    for e in events:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b, e))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and merged."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(dev, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some kernel or copy ran."""
    return sum(b - a for a, b in union((a, b) for a, b, _ in
                                       clipped(dev, lo, hi)))


def top_ops(dev, lo: float, hi: float, k: int = 10):
    """The ``k`` device operations that took most time: [name, seconds]."""
    tot: dict[str, float] = {}
    for a, b, e in clipped(dev, lo, hi):
        tot[e["name"]] = tot.get(e["name"], 0.0) + (b - a)
    return [[n, us / 1e6] for n, us in
            sorted(tot.items(), key=lambda t: -t[1])[:k]]


def idle_gaps(events, dev, lo: float, hi: float, k: int = 10):
    """The ``k`` longest stretches of [lo, hi] with nothing on the device,
    each named by the innermost host annotation open at its middle (else
    the host operation, else ``idle``): [name, seconds]."""
    busy = union((a, b) for a, b, _ in clipped(dev, lo, hi))
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in ("user_annotation", "cpu_op")]
    out = []
    for a, b in gaps[:k]:
        mid = 0.5 * (a + b)
        best = None
        for e in host:
            s, f = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if s <= mid <= f and e["name"] != WINDOW:
                rank = (e.get("cat") == "user_annotation", -(f - s))
                if best is None or rank > best[0]:
                    best = (rank, e["name"])
        out.append([best[1] if best else "idle", (b - a) / 1e6])
    return out


WINDOW = "portbench.window"     # the annotation around the traced window


def idle_pct(t) -> float | None:
    """The share of a traced window (`harness.Traced`) in which nothing
    ran on the card, in %."""
    if t.hi <= t.lo:
        return None
    return 100.0 * (1.0 - busy_us(t.device, t.lo, t.hi) / (t.hi - t.lo))


def kernel_us(dev, lo: float, hi: float, needle: str) -> float:
    """Device microseconds of the kernels whose name holds ``needle``."""
    return sum(b - a for a, b, e in clipped(dev, lo, hi)
               if e.get("cat") == "kernel" and needle in e.get("name", ""))
