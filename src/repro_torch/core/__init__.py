"""repro_torch.core — the dense symmetric-definite generalized eigensolver
(the TD, TT, KE and KI pipelines) as PyTorch modules."""
from .batched import BatchedSolveResult, solve_batched
from .cholesky import cholesky_blocked, cholesky_upper
from .gsyeig import VARIANTS, GSyEigResult, solve
from .lanczos import LanczosResult, lanczos_solve
from .operators import ExplicitC, ImplicitC, apply_op
from .residuals import (AccuracyReport, accuracy_report, b_normalize,
                        b_orthogonality, relative_residual)
from .standard_form import to_standard_sygst, to_standard_two_trsm
from .tridiag import (TridiagResult, apply_q, apply_qt, tridiagonalize,
                      tridiagonalize_blocked)

__all__ = ["solve", "VARIANTS", "GSyEigResult", "solve_batched",
           "BatchedSolveResult", "lanczos_solve",
           "LanczosResult", "ExplicitC", "ImplicitC", "apply_op",
           "accuracy_report", "AccuracyReport", "b_orthogonality",
           "relative_residual", "b_normalize",
           "cholesky_upper", "cholesky_blocked",
           "to_standard_two_trsm", "to_standard_sygst",
           "tridiagonalize", "tridiagonalize_blocked", "apply_q", "apply_qt",
           "TridiagResult"]
