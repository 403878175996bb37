"""Core library of the port: Zhang & El Ghaoui (NIPS 2011) sparse PCA.

  elimination.feature_variances / safe_support / eliminate          (Thm 2.1)
  bcd.solve_bcd / solve_bcd_many / solve_bcd_grid /
      leading_sparse_component                                      (Algorithm 1)
  first_order.solve_first_order                          (the [1] baseline)
  baselines.pca_power / pca_power_data / thresholded_pca    (PCA baselines)
  spca.solve_at_lambda / search_lambda / fit_components             (driver)
  validate.kkt_gap / duality_gap                              (certificates)
  distributed.distributed_variances / distributed_gram   (pooled over lanes)
  fitstate.FitCheckpointer / fit_fingerprint                 (solver resume)
"""
from . import (
    baselines, bcd, distributed, elimination, first_order, fitstate, spca,
    validate,
)
from .bcd import (
    BCDResult, SolverDivergenceError, leading_sparse_component, solve_bcd,
)
from .elimination import (
    eliminate, feature_variances, safe_support, select_support,
)
from .first_order import solve_first_order
from .fitstate import FitCheckpointer, FitState, fit_fingerprint
from .spca import (
    PCResult, SPCAConfig, fit_components, search_lambda, solve_at_lambda,
)
from .validate import cardinality, duality_gap, kkt_gap

__all__ = [
    "baselines", "bcd", "distributed", "elimination", "first_order",
    "fitstate", "spca", "validate", "BCDResult", "SolverDivergenceError",
    "leading_sparse_component", "solve_bcd", "eliminate",
    "feature_variances", "safe_support", "select_support",
    "solve_first_order", "FitCheckpointer", "FitState", "fit_fingerprint",
    "PCResult", "SPCAConfig", "fit_components", "search_lambda",
    "solve_at_lambda", "cardinality", "duality_gap", "kkt_gap",
]
