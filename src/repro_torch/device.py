"""Device policy of the port: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without CUDA raises: the port
    never falls back to the host on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the host")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, for a kernel launch.
    ``torch.cuda.current_stream(device)`` builds a Stream object on every
    call, a host cost the blocked solves pay on every block row."""
    return torch._C._cuda_getCurrentRawStream(device.index)
