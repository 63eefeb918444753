"""Curvature spectrum probes — the paper's technique inside the trainer.

Variant KI's defining move is Lanczos on an *implicit* operator (never
materialize C, apply U^{-T} A U^{-1} per iteration). The training-time
analogue is Lanczos on the loss Hessian via hessian-vector products: the
operator is implicit, symmetric, and only its extremal eigenpairs are
wanted — exactly the GSYEIG s << n regime.

``curvature_spectrum`` runs an m-step full-reorthogonalization Lanczos
(no restarts — spectral density probes don't need ARPACK-grade residuals)
and returns the extremal Ritz values, the standard sharpness diagnostic.
The trainer exposes it via --spectral-every.

The flat vector: the parameters in ``named_parameters()`` order of the
``LM``, each raveled row-major and concatenated (``flat_params``);
``interop.reference_flat_to_port`` maps the reference's ``ravel_pytree``
order onto it. The Hessian-vector product is reverse over reverse:
``torch.autograd.grad`` of the gradient against the tangent, with the
loss evaluated at the flat vector through ``torch.func.functional_call``.
The gradient and its graph are made once a probe, so each product is one
pass of the double backward; on the card that pass is captured as a CUDA
graph and replayed for each tangent. The reference takes ``jvp`` of ``grad``
(forward over reverse); in torch both run every layer kind of the ten
smoke configs and agree within 1e-6 of max|Hv| on the CPU, but forward
over reverse reruns the forward and the backward for every tangent.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def flat_params(params: nn.Module) -> torch.Tensor:
    """The parameters as one detached vector, in the probe's order."""
    return torch.cat([p.detach().reshape(-1) for p in params.parameters()])


class _Probe(nn.Module):
    """Holds the model so that ``functional_call`` can swap its parameters
    for views of one flat vector and call the loss on it."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def make_hvp(loss_fn: Callable, params: nn.Module, batch: dict):
    """Returns (hvp(v), dim): the implicit Hessian-vector operator of
    ``loss_fn(params, batch)`` (a scalar) at the current parameters, on
    flat vectors in ``flat_params`` order."""
    names, shapes, sizes = [], [], []
    for name, p in params.named_parameters():
        names.append(f"model.{name}")
        shapes.append(p.shape)
        sizes.append(p.numel())
    flat = flat_params(params)
    probe = _Probe(params, loss_fn)

    def loss_flat(x: torch.Tensor) -> torch.Tensor:
        views = {n: t.reshape(s) for n, t, s in
                 zip(names, torch.split(x, sizes), shapes)}
        return torch.func.functional_call(probe, views, (batch,))

    x = flat.detach().requires_grad_(True)
    if x.is_cuda:
        return _graphed_hvp(loss_flat, x), flat.shape[0]
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_flat(x), x, create_graph=True)

    def hvp(v: torch.Tensor) -> torch.Tensor:
        (hv,) = torch.autograd.grad(g, x, grad_outputs=v, retain_graph=True)
        return hv.detach()

    return hvp, flat.shape[0]


def _graphed_hvp(loss_flat: Callable, x: torch.Tensor):
    """On the card: the double backward captured once as a CUDA graph and
    replayed for each tangent. A product is tens of thousands of small
    kernels (55k for xlstm-125m's smoke config at B=4, S=32), which eager
    launches one by one from the host. The gradient's graph is made on the
    capture stream, so that the backward of its nodes, which runs on the
    stream their forward ran on, lands in the capture."""
    dev = x.device
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    v_in = torch.zeros_like(x)
    with torch.cuda.stream(stream), torch.enable_grad():
        (g,) = torch.autograd.grad(loss_flat(x), x, create_graph=True)
        # the backward's first call makes its allocations outside capture
        torch.autograd.grad(g, x, grad_outputs=v_in, retain_graph=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream), torch.enable_grad():
        (hv_out,) = torch.autograd.grad(g, x, grad_outputs=v_in,
                                        retain_graph=True)
    torch.cuda.current_stream(dev).wait_stream(stream)

    def hvp(v: torch.Tensor) -> torch.Tensor:
        v_in.copy_(v)
        graph.replay()
        return hv_out.detach().clone()

    # the replay reads the gradient graph's saved tensors in place: they
    # must live as long as the product does
    hvp.keep_alive = (g, x)
    return hvp


def _lanczos_tridiag(matvec: Callable, v0: torch.Tensor, m: int):
    """m-step Lanczos with full re-orthogonalization (twice, against the
    columns made so far); returns (alpha, beta)."""
    n = v0.shape[0]
    V = torch.zeros((n, m + 1), dtype=v0.dtype, device=v0.device)
    V[:, 0] = v0 / torch.linalg.vector_norm(v0)
    alpha = torch.zeros((m,), dtype=v0.dtype, device=v0.device)
    beta = torch.zeros((m,), dtype=v0.dtype, device=v0.device)
    idx = torch.arange(m + 1, device=v0.device)
    for j in range(m):
        w = matvec(V[:, j].contiguous())
        mask = (idx <= j).to(v0.dtype)
        h = (V.T @ w) * mask
        w = w - V @ h
        h2 = (V.T @ w) * mask
        w = w - V @ h2
        b = torch.linalg.vector_norm(w)
        V[:, j + 1] = w / torch.clamp_min(b, 1e-30)
        alpha[j] = (h + h2)[j]
        beta[j] = b
    return alpha, beta


def curvature_spectrum(loss_fn: Callable, params: nn.Module, batch: dict,
                       m: int = 32,
                       generator: Optional[torch.Generator] = None) -> dict:
    """Extremal Hessian Ritz values (sharpness / most-negative curvature).
    ``v0`` is drawn from ``generator`` (a generator on the parameters'
    device; seed 0 when None)."""
    dev = next(params.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    hvp, dim = make_hvp(loss_fn, params, batch)
    v0 = torch.randn((dim,), generator=generator, dtype=torch.float32,
                     device=dev)
    m = min(m, dim - 1)
    alpha, beta = _lanczos_tridiag(hvp, v0, m)
    T = (torch.diag(alpha) + torch.diag(beta[:m - 1], 1)
         + torch.diag(beta[:m - 1], -1))
    theta = torch.linalg.eigvalsh(T)
    return {
        "sharpness": float(theta[-1]),       # lambda_max(H)
        "lambda_min": float(theta[0]),       # most negative curvature
        "ritz_values": theta,
        "dim": dim,
    }
