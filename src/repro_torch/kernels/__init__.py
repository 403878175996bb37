"""Kernels of the port.

  csrc/bcd_fused.cu — K1, fused whole-solve BCD for Hopper (CUDA C++, one
                      launch per solve or per batch of solves)
  bcd_fused.py      — its ctypes wrapper and launch plan
  csrc/csr_stats.cu — K2, CSR column stats (one launch per megabatch)
  csr_stats.py      — its ctypes wrapper
  csrc/csr_gram.cu  — K3, CSR gather-Gram (one launch per megabatch)
  csr_gram.py       — its ctypes wrapper and launch plan
  csrc/project.cu   — K4, sparse-projection gather-matvec (one launch per
                      serving batch)
  project.py        — its ctypes wrapper
  csrc/variance.cu  — K5, dense column stats (one launch per row block)
  variance.py       — its ctypes wrapper
  csrc/gram.cu      — K6, dense Gram A^T A (one launch per row block)
  gram.py           — its ctypes wrapper
  csrc/bcd_sweep.cu — K7, box-QP coordinate descent of one row update (one
                      launch per row update: the legacy per-row solver)
  bcd_sweep.py      — its ctypes wrapper and launch plan
  csrc/box_qp.cuh   — the box-QP coordinate step K1 and K7 share
  ref.py            — the plain PyTorch versions the kernels are held to
  ops.py            — the public wrappers (device dispatch, launch counts)
  _build.py         — nvcc build at first use
"""
from . import ops, ref
from .ops import SolvePlan, bcd_solve, bcd_solve_batched, plan_fused_solve

__all__ = ["ops", "ref", "SolvePlan", "bcd_solve", "bcd_solve_batched",
           "plan_fused_solve"]
