"""Test and smoke support: the BCD problems the kernel is held to its plain
version on (`repro_torch.testing.bcd_problems`), and deterministic fault
injection for the store's file seam and the solver's launch seam
(`repro_torch.testing.faults`)."""
from .bcd_problems import CHAOTIC, covariance_problems
from .faults import (
    FaultInjector, InjectedDispatchError, InjectedReadError,
    InjectedWriteError, SolverFaultInjector, corrupt_file, dispatch_error,
    fail_nth_read, flip_bytes, install, install_solver, nonfinite_solve,
    slow_read, stalled_solve, torn_write, truncate_file,
)

__all__ = [
    "CHAOTIC", "covariance_problems", "FaultInjector",
    "InjectedDispatchError", "InjectedReadError", "InjectedWriteError",
    "SolverFaultInjector", "corrupt_file", "dispatch_error",
    "fail_nth_read", "flip_bytes", "install", "install_solver",
    "nonfinite_solve", "slow_read", "stalled_solve", "torn_write",
    "truncate_file",
]
