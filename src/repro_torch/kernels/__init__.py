"""Kernels of the port.

  csrc/bcd_fused.cu — K1, fused whole-solve BCD for Hopper (CUDA C++, one
                      launch per solve or per batch of solves)
  bcd_fused.py      — its ctypes wrapper and launch plan
  csrc/csr_stats.cu — K2, CSR column stats (one launch per megabatch)
  csr_stats.py      — its ctypes wrapper
  csrc/csr_gram.cu  — K3, CSR gather-Gram (one launch per megabatch)
  csr_gram.py       — its ctypes wrapper and launch plan
  ref.py            — the plain PyTorch versions the kernels are held to
  ops.py            — the public wrappers (device dispatch, launch counts)
  _build.py         — nvcc build at first use
"""
from . import ops, ref
from .ops import SolvePlan, bcd_solve, bcd_solve_batched, plan_fused_solve

__all__ = ["ops", "ref", "SolvePlan", "bcd_solve", "bcd_solve_batched",
           "plan_fused_solve"]
