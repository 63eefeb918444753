"""The blocked triangular solve: ``trsm`` (diagonal tiles + gemm updates)."""
