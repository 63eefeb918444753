"""repro_torch.core — the dense symmetric-definite generalized eigensolver
(the TD, KE and KI pipelines) as PyTorch modules."""
from .gsyeig import VARIANTS, GSyEigResult, solve
from .lanczos import LanczosResult, lanczos_solve
from .operators import ExplicitC, ImplicitC, apply_op
from .residuals import (AccuracyReport, accuracy_report, b_normalize,
                        b_orthogonality, relative_residual)

__all__ = ["solve", "VARIANTS", "GSyEigResult", "lanczos_solve",
           "LanczosResult", "ExplicitC", "ImplicitC", "apply_op",
           "accuracy_report", "AccuracyReport", "b_orthogonality",
           "relative_residual", "b_normalize"]
