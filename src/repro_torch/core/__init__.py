"""Core library of the port: Zhang & El Ghaoui (NIPS 2011) sparse PCA.

  elimination.select_support / safe_support / lam_for_target_size  (Thm 2.1)
  bcd.solve_bcd / solve_bcd_many / leading_sparse_component          (Algorithm 1)
  spca.solve_at_lambda / search_lambda / fit_components             (driver)
  validate.kkt_gap / duality_gap                                    (certificates)
"""
from . import bcd, elimination, spca, validate
from .bcd import (
    BCDResult, SolverDivergenceError, leading_sparse_component, solve_bcd,
)
from .elimination import safe_support, select_support
from .spca import (
    PCResult, SPCAConfig, fit_components, search_lambda, solve_at_lambda,
)
from .validate import cardinality, duality_gap, kkt_gap

__all__ = [
    "bcd", "elimination", "spca", "validate", "BCDResult",
    "SolverDivergenceError", "leading_sparse_component", "solve_bcd",
    "safe_support", "select_support", "PCResult", "SPCAConfig",
    "fit_components", "search_lambda", "solve_at_lambda", "cardinality",
    "duality_gap", "kkt_gap",
]
