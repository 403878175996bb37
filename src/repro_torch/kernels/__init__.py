"""Kernels of the port.

  csrc/bcd_fused.cu — fused whole-solve BCD for Hopper (CUDA C++, one
                      launch per solve or per batch of solves)
  bcd_fused.py      — its ctypes wrapper and launch plan
  ref.py            — the plain PyTorch versions the kernel is held to
  ops.py            — the public wrappers (device dispatch, launch counts)
  _build.py         — nvcc build at first use
"""
from . import ops, ref
from .ops import SolvePlan, bcd_solve, bcd_solve_batched, plan_fused_solve

__all__ = ["ops", "ref", "SolvePlan", "bcd_solve", "bcd_solve_batched",
           "plan_fused_solve"]
