"""Kernel K1 (`kernels/bcd_fused.py`): its launches a fit, by the
module's own ``launches`` counter over the window; beyond
`solve_launches` they are the supervisor's fallback re-solves, one
launch a sweep."""


def read(t):
    fits = len(t.run.fits)
    n = t.launches.get("k1_counted", 0)
    return n / fits if fits and n else None
