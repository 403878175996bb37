"""Kernel K1: the least time of its launches (each launch's operations
over the float32 rate or its bytes over the memory rate, whichever is
larger, counted from its shapes and the sweeps each problem ran) over
its device time, in %."""
from portbench import yardstick as ys


def read(t):
    us = ys.kernel_us(t.device, t.lo, t.hi, "bcd_fused")
    if not t.launches["k1"] or us <= 0:
        return None
    least = 0.0
    for L in t.launches["k1"]:
        sweeps = L["meta"][:, 1].detach().cpu().tolist()
        n_valid = L["n_valid"].detach().cpu().tolist()
        ops = sum(ys.k1_ops(int(n), L["qp_sweeps"], L["tau_iters"], int(s))
                  for n, s in zip(n_valid, sweeps))
        least += ys.bound_s(ops, ys.k1_bytes(L["itemsize"], L["n_pad"],
                                             sweeps))
    return 100.0 * least / (us / 1e6)
