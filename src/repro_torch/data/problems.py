"""Synthetic GSYEIG pencils shaped like the paper's two workloads.

Both are built as A = U^T C U, B = U^T U with a known spectrum for C, as
in ``repro.data.problems``: the generalized eigenvalues of (A, B) are the
chosen spectrum. The draws come from a ``torch.Generator`` seeded on the
target device, so they are not the reference's threefry draws; parity
tests hand the reference's arrays across (``repro_torch.interop``).

  * ``md_like``  — molecular-dynamics NMA: A and B both SPD, log-spaced
    spectrum over ~4 decades (paper Exp. 1).
  * ``dft_like`` — FLEUR/DFT: indefinite spectrum with a tightly clustered
    lower end, B close to I (paper Exp. 2).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


class GSyEigProblem(NamedTuple):
    A: torch.Tensor
    B: torch.Tensor
    exact_evals: torch.Tensor  # full spectrum, ascending
    name: str


def _random_orthogonal(n: int, gen: torch.Generator, device) -> torch.Tensor:
    M = torch.randn((n, n), generator=gen, dtype=torch.float64, device=device)
    Q, R = torch.linalg.qr(M)
    # fix signs for determinism
    return Q * torch.sign(torch.diagonal(R))[None, :]


def _assemble(n: int, spectrum: torch.Tensor, gen: torch.Generator, device,
              b_offdiag: float, name: str) -> GSyEigProblem:
    Q = _random_orthogonal(n, gen, device)
    C = (Q * spectrum[None, :]) @ Q.mT
    C = 0.5 * (C + C.mT)
    del Q
    # U = I + small strictly-upper noise: B = U^T U is SPD, well conditioned
    noise = torch.randn((n, n), generator=gen, dtype=torch.float64,
                        device=device) * (b_offdiag / math.sqrt(n))
    U = torch.triu(noise, diagonal=1)
    del noise
    torch.diagonal(U).add_(1.0)
    A = U.mT @ C @ U
    del C
    A = 0.5 * (A + A.mT)
    B = U.mT @ U
    B = 0.5 * (B + B.mT)
    return GSyEigProblem(A=A, B=B, exact_evals=torch.sort(spectrum).values,
                         name=name)


def md_like(n: int, seed: int = 9997, device=None) -> GSyEigProblem:
    """Both A, B SPD; spectrum spans ~4 decades, smooth low end (NMA modes)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = torch.logspace(-2.0, 2.0, n, dtype=torch.float64, device=dev)
    jitter = 1.0 + 0.01 * torch.rand((n,), generator=gen, dtype=torch.float64,
                                     device=dev)
    return _assemble(n, base * jitter, gen, dev, b_offdiag=0.3, name="md")


def dft_like(n: int, seed: int = 17243, device=None) -> GSyEigProblem:
    """Symmetric A (negative + positive), tight cluster at the low end; B≈I."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_low = max(n // 10, 4)
    # low cluster: tightly spaced "valence" states
    low = -1.0 + 0.02 * torch.arange(n_low, dtype=torch.float64,
                                     device=dev) / n_low
    # the rest: spread "conduction" states
    high = torch.linspace(0.0, 50.0, n - n_low, dtype=torch.float64,
                          device=dev)
    jitter = 1.0 + 1e-3 * torch.rand((n,), generator=gen, dtype=torch.float64,
                                     device=dev)
    spectrum = torch.cat([low, high]) * jitter
    return _assemble(n, spectrum, gen, dev, b_offdiag=0.1, name="dft")


def paper_shapes() -> dict:
    """The paper's two experiment sizes."""
    return {
        "md": dict(n=9_997, s=100),
        "dft": dict(n=17_243, s=448),
    }
