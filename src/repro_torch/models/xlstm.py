"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) + sLSTM (scalar).

The xlstm-125m config has d_ff = 0 — FFN capacity lives inside the blocks via
the pre-up-projection (factor ``xlstm_proj_factor``). Both blocks have a
full-sequence time loop and an O(1) decode step.

mLSTM: per-head matrix memory C_t = f_t C_{t-1} + i_t v_t k_t^T, query read
h_t = C_t q_t / max(|n_t^T q_t|, 1) with exponential gating stabilized by the
max-state m_t (as in the paper, App. A).
sLSTM: scalar-memory cells with exponential input gates and the same
stabilizer, block-diagonal recurrent weights (per head).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import Linear, cdtype, linear, normal_param, softplus


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    n_h = cfg.n_heads
    d_in = int(cfg.xlstm_proj_factor * cfg.d_model)
    # round head dim down to keep shapes consistent
    return n_h, d_in // n_h


def _up(p, x: torch.Tensor, cfg: ModelConfig, d_in: int):
    xu = linear(p.up, x, cfg)
    return xu[..., :d_in], xu[..., d_in:]


def _down(p, h: torch.Tensor, z: torch.Tensor, cfg: ModelConfig):
    return linear(p.down, h.to(cdtype(cfg)) * F.silu(z), cfg)


# ------------------------------------------------------------------ mLSTM --

class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        d = cfg.d_model
        n_h, hd = _heads(cfg)
        d_in = n_h * hd
        self.up = Linear(d, 2 * d_in, cfg, gen, device)         # x and gate z
        self.q = Linear(d_in, d_in, cfg, gen, device)
        self.k = Linear(d_in, d_in, cfg, gen, device)
        self.v = Linear(d_in, d_in, cfg, gen, device)
        self.ifg = Linear(d_in, 3 * n_h, cfg, gen, device, bias=True)  # i,f,o
        self.down = Linear(d_in, d, cfg, gen, device)


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, hd, hd) matrix memory
    n: torch.Tensor   # (B, H, hd)    normalizer
    m: torch.Tensor   # (B, H)        stabilizer (log domain)


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    n_h, hd = _heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((batch, n_h, hd, hd), **f32),
                      n=torch.zeros((batch, n_h, hd), **f32),
                      m=torch.full((batch, n_h), -1e30, **f32))


def _mlstm_inputs(p: MLSTM, xin: torch.Tensor, cfg: ModelConfig):
    """q, k, v (..., H, hd) and the gates i, f, o (..., H), all f32."""
    n_h, hd = _heads(cfg)
    shape = (*xin.shape[:-1], n_h, hd)
    q, k, v = (linear(w, xin, cfg).reshape(shape).float()
               for w in (p.q, p.k, p.v))
    i_, f_, o_ = torch.chunk(linear(p.ifg, xin, cfg).float(), 3, dim=-1)
    return q, k, v, i_, f_, o_


def _mlstm_step(carry: MLSTMState, qkvifo, hd: int):
    q, k, v, i_, f_, o_ = qkvifo    # q/k/v (B,H,hd); i/f/o (B,H)
    C, n, m = carry
    logf = -softplus(-f_)                        # log sigmoid(f)
    m_new = torch.maximum(logf + m, i_)
    fg = torch.exp(logf + m - m_new)             # stabilized forget
    ig = torch.exp(i_ - m_new)                   # stabilized input
    ks = k / (hd ** 0.5)
    C = fg[..., None, None] * C + ig[..., None, None] * (
        v[..., :, None] * ks[..., None, :])
    n = fg[..., None] * n + ig[..., None] * ks
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.clamp_min(torch.abs(torch.einsum("bhj,bhj->bh", n, q)), 1.0)
    h = torch.sigmoid(o_)[..., None] * num / den[..., None]
    return MLSTMState(C, n, m_new), h


def mlstm(p: MLSTM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, D = x.shape
    n_h, hd = _heads(cfg)
    xin, z = _up(p, x, cfg, n_h * hd)
    inputs = _mlstm_inputs(p, xin, cfg)
    st = init_mlstm_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        st, h = _mlstm_step(st, tuple(a[:, t] for a in inputs), hd)
        hs.append(h)
    return _down(p, torch.stack(hs, dim=1).reshape(B, S, n_h * hd), z, cfg)


def mlstm_decode(p: MLSTM, x: torch.Tensor, state: MLSTMState,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, MLSTMState]:
    """Single-token decode; x (B, 1, D). Updates ``state`` in place."""
    B = x.shape[0]
    n_h, hd = _heads(cfg)
    xin, z = _up(p, x, cfg, n_h * hd)
    inputs = _mlstm_inputs(p, xin[:, 0], cfg)
    st, h = _mlstm_step(state, inputs, hd)
    for old, new in zip(state, st):
        old.copy_(new)
    return _down(p, h.reshape(B, 1, n_h * hd), z, cfg), state


# ------------------------------------------------------------------ sLSTM --

class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        d = cfg.d_model
        n_h, hd = _heads(cfg)
        d_in = n_h * hd
        self.up = Linear(d, 2 * d_in, cfg, gen, device)
        self.wx = Linear(d_in, 4 * d_in, cfg, gen, device, bias=True)  # ifzo
        # block-diagonal recurrent weights (per head): (H, hd, 4*hd)
        self.wr = normal_param((n_h, hd, 4 * hd), cfg, gen, device,
                               (1.0 / d_in) ** 0.5)
        self.down = Linear(d_in, d, cfg, gen, device)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, hd)
    n: torch.Tensor  # (B, H, hd)
    h: torch.Tensor  # (B, H, hd)
    m: torch.Tensor  # (B, H, hd)


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> SLSTMState:
    n_h, hd = _heads(cfg)

    def z():
        return torch.zeros((batch, n_h, hd), dtype=torch.float32,
                           device=device)
    return SLSTMState(c=z(), n=z(), h=z(), m=torch.full_like(z(), -1e30))


def _slstm_step(p: SLSTM, carry: SLSTMState, gx, cfg: ModelConfig):
    c, n, h, m = carry
    gr = torch.einsum("bhj,hjk->bhk", h, p.wr.float())   # (B,H,4hd)
    g = gx + gr
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = -softplus(-gf)
    m_new = torch.maximum(logf + m, gi)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(gi - m_new)
    c = fg * c + ig * torch.tanh(gz)
    n = fg * n + ig
    h_new = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
    return SLSTMState(c, n, h_new, m_new), h_new


def slstm(p: SLSTM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, D = x.shape
    n_h, hd = _heads(cfg)
    xin, z = _up(p, x, cfg, n_h * hd)
    gx = linear(p.wx, xin, cfg).reshape(B, S, n_h, 4 * hd).float()
    st = init_slstm_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        st, h = _slstm_step(p, st, gx[:, t], cfg)
        hs.append(h)
    return _down(p, torch.stack(hs, dim=1).reshape(B, S, n_h * hd), z, cfg)


def slstm_decode(p: SLSTM, x: torch.Tensor, state: SLSTMState,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, SLSTMState]:
    """Single-token decode; x (B, 1, D). Updates ``state`` in place."""
    B = x.shape[0]
    n_h, hd = _heads(cfg)
    xin, z = _up(p, x, cfg, n_h * hd)
    gx = linear(p.wx, xin, cfg).reshape(B, n_h, 4 * hd).float()
    st, h = _slstm_step(p, state, gx, cfg)
    for old, new in zip(state, st):
        old.copy_(new)
    return _down(p, h.reshape(B, 1, n_h * hd), z, cfg), state
