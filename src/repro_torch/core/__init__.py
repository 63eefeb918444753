"""repro_torch.core — the dense symmetric-definite generalized eigensolver
(the TD pipeline) as PyTorch modules."""
from .gsyeig import VARIANTS, GSyEigResult, solve
from .residuals import (AccuracyReport, accuracy_report, b_normalize,
                        b_orthogonality, relative_residual)

__all__ = ["solve", "VARIANTS", "GSyEigResult", "accuracy_report",
           "AccuracyReport", "b_orthogonality", "relative_residual",
           "b_normalize"]
