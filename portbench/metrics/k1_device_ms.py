"""Kernel K1: its device time in the profiler's trace, ms a fit."""
from portbench import yardstick as ys


def read(t):
    fits = len(t.run.fits)
    us = ys.kernel_us(t.device, t.lo, t.hi, "bcd_fused")
    return us / 1e3 / fits if fits and us > 0 else None
