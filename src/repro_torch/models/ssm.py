"""Mamba-style selective SSM block (jamba's 'mamba' layers).

Selective state-space recurrence (Gu & Dao, arXiv:2312.00752) with input-
dependent (dt, B, C): h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ;
y_t = C_t h_t. The full-sequence pass is a time loop (the reference's
chunked scan, whose chunking only bounds what a backward pass stores), and
decode is an O(1) state update.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import Linear, cdtype, const_param, linear, normal_param, softplus


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state_dim
        self.in_proj = Linear(d, 2 * d_in, cfg, gen, device)   # x and gate z
        self.conv_w = normal_param((cfg.ssm_conv_dim, d_in), cfg, gen, device,
                                   0.2)
        self.conv_b = const_param(torch.zeros(d_in, device=device), cfg)
        self.bc_proj = Linear(d_in, 2 * n, cfg, gen, device)   # B_t, C_t
        self.dt_proj = Linear(d_in, d_in, cfg, gen, device, bias=True)
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
        self.A_log = const_param(a[None, :].repeat(d_in, 1), cfg)  # (d_in, n)
        self.D = const_param(torch.ones(d_in, device=device), cfg)
        self.out_proj = Linear(d_in, d, cfg, gen, device)


class MambaState(NamedTuple):
    h: torch.Tensor        # (B, d_in, n) SSM state
    conv: torch.Tensor     # (B, conv_dim-1, d_in) trailing inputs for the conv


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=None,
                     device=None) -> MambaState:
    d_in = cfg.ssm_expand * cfg.d_model
    return MambaState(
        h=torch.zeros((batch, d_in, cfg.ssm_state_dim), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_dim - 1, d_in),
                         dtype=dtype or cdtype(cfg), device=device))


def _causal_conv(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over sequence; x (B, S, d_in)."""
    k = cfg.ssm_conv_dim
    S = x.shape[1]
    w = p.conv_w.to(x.dtype)     # (k, d_in)
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if state is None else state)
    xp = torch.cat([pad, x], dim=1)     # (B, S+k-1, d_in)
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + S, :] * w[i]
    out = out + p.conv_b.to(x.dtype)
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return F.silu(out), new_state


def _selective_inputs(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                      conv_state: Optional[torch.Tensor] = None):
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state_dim
    xz = linear(p.in_proj, x, cfg)
    xs, z = xz[..., :d_in], xz[..., d_in:]
    xs, conv_state = _causal_conv(p, xs, cfg, state=conv_state)
    bc = linear(p.bc_proj, xs, cfg).float()                    # (B,S,2n)
    dt = softplus(linear(p.dt_proj, xs, cfg).float())          # (B,S,d_in)
    A = -torch.exp(p.A_log.float())                            # (d_in, n)
    return xs, z, bc[..., :n], bc[..., n:], dt, A, conv_state


def _ssm_step(h, xt, dtt, bt, ct, A):
    """xt/dtt (B,d_in), bt/ct (B,n): the new state and y_t (B,d_in)."""
    decay = torch.exp(dtt[..., None] * A[None])                # (B,d_in,n)
    h = decay * h + (dtt * xt)[..., None] * bt[:, None, :]
    return h, torch.einsum("bdn,bn->bd", h, ct)


def _out(p: Mamba, y, xf, z, cfg: ModelConfig):
    y = y + xf * p.D.float()
    return linear(p.out_proj, y.to(cdtype(cfg)) * F.silu(z), cfg)


def mamba(p: Mamba, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence pass; x (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    xs, z, Bt, Ct, dt, A, _ = _selective_inputs(p, x, cfg)
    xf = xs.float()
    h = torch.zeros((B, cfg.ssm_expand * D, cfg.ssm_state_dim),
                    dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h, y = _ssm_step(h, xf[:, t], dt[:, t], Bt[:, t], Ct[:, t], A)
        ys.append(y)
    return _out(p, torch.stack(ys, dim=1), xf, z, cfg)


def mamba_decode(p: Mamba, x: torch.Tensor, state: MambaState,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, MambaState]:
    """Single-token decode; x (B, 1, D). Updates ``state`` in place."""
    xs, z, Bt, Ct, dt, A, conv_state = _selective_inputs(
        p, x, cfg, conv_state=state.conv)
    xf = xs.float()
    h, y = _ssm_step(state.h, xf[:, 0], dt[:, 0], Bt[:, 0], Ct[:, 0], A)
    state.h.copy_(h)
    state.conv.copy_(conv_state)
    return _out(p, y[:, None, :], xf, z, cfg), state
