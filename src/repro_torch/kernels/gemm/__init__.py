"""The tiled matrix product: ``gemm`` and its accumulate form ``gemm_accum``."""
