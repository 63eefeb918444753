"""repro_torch — the dense generalized eigensolvers of ``repro`` ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The layout mirrors ``repro`` module for module. The pipeline works in
float64; ``precision="mixed"``/``"fast"`` demote its GEMM-heavy stages to
float32/bfloat16 and refine the result in float64.
Entry points run on the card unless the caller passes ``device="cpu"``;
a kernel wrapper takes its plain PyTorch version only for a CPU tensor.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
