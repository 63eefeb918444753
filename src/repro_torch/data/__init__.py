"""Synthetic GSYEIG pencils shaped like the paper's two workloads."""
