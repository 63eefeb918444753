"""Core layer primitives of the LM stack.

Parameters live in ``nn.Module``s whose attribute names are the keys of the
reference's parameter dicts (``w``/``b`` of a linear map, ``g`` of a norm,
``table`` of the embedding), with the reference's layouts: a linear weight
is ``(d_in, d_out)`` and applied as ``x @ w``. The forward passes are
functions of a module and a tensor, named as the reference's.

Dtype policy, the reference's: master parameters in ``cfg.param_dtype``
(f32), compute in ``cfg.dtype`` (bf16 at full size), norms, logits and
recurrent states in f32. ``linear`` casts the master weight to the compute
dtype at every call, as the reference does.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def normal_param(shape, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, scale: float) -> nn.Parameter:
    """A master parameter drawn from ``N(0, scale^2)`` with ``gen``, or left
    uninitialised when ``gen`` is None (the weights are then loaded, as
    ``interop.lm_params_from_numpy`` does)."""
    t = torch.empty(shape, dtype=pdtype(cfg), device=device)
    if gen is not None:
        t.normal_(generator=gen).mul_(scale)
    return nn.Parameter(t)


def const_param(t: torch.Tensor, cfg: ModelConfig) -> nn.Parameter:
    return nn.Parameter(t.to(pdtype(cfg)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``; ``F.softplus``
    returns x itself above 20 instead."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ----------------------------------------------------------------- linear --

class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, cfg: ModelConfig, gen=None,
                 device=None, bias: bool = False):
        super().__init__()
        self.w = normal_param((d_in, d_out), cfg, gen, device,
                              (2.0 / (d_in + d_out)) ** 0.5)
        self.b = (const_param(torch.zeros(d_out, device=device), cfg)
                  if bias else None)


def linear(p: Linear, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = x @ p.w.to(cdtype(cfg))
    if p.b is not None:
        y = y + p.b.to(cdtype(cfg))
    return y


# ---------------------------------------------------------------- rmsnorm --

class RMSNorm(nn.Module):
    def __init__(self, d: int, cfg: ModelConfig, device=None):
        super().__init__()
        self.g = const_param(torch.ones(d, device=device), cfg)


def rmsnorm(p: RMSNorm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps)
    return (y * p.g.float()).to(x.dtype)


# -------------------------------------------------------------- embedding --

class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.table = normal_param((cfg.vocab_size, cfg.d_model), cfg, gen,
                                  device, cfg.d_model ** -0.5)


def embed(p: Embedding, tokens: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    # gather, then cast: the reference's cast-then-gather, without casting
    # the whole table at every step (a cast is elementwise: same values)
    return p.table[tokens].to(cdtype(cfg))


def unembed(p: Embedding, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in f32 (loss numerics)."""
    return x.float() @ p.table.float().T


# ------------------------------------------------------------------- rope --

@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device
                ) -> torch.Tensor:
    """``theta ** (-arange(half) / half)`` in f32, made once a device (no
    caller writes to it)."""
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    freqs = _rope_freqs(head_dim // 2, theta, positions.device)
    ang = positions.float()[..., None] * freqs          # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd/2) broadcast over heads.
    Half-split (not interleaved) pairs, as the reference's."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- swiglu --

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        self.gate = Linear(cfg.d_model, d_ff, cfg, gen, device)
        self.up = Linear(cfg.d_model, d_ff, cfg, gen, device)
        self.down = Linear(d_ff, cfg.d_model, cfg, gen, device)


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = F.silu(linear(p.gate, x, cfg))
    u = linear(p.up, x, cfg)
    return linear(p.down, g * u, cfg)
