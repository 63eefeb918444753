"""Mixture-of-Experts FFN with top-k routing (qwen2-moe, arctic, jamba).

Dispatch is grouped and sort-based, as the reference's: tokens are split
into groups of ``MOE_GROUP_SIZE``; within each group the (token, k) pairs
are sorted by expert id (a stable sort), the rank inside each expert
segment is the capacity slot (rank = position - searchsorted(segment
start)), tokens are written into per-expert buffers (a trash row takes the
drops) and gathered back out.

Supports the assignment's variants:
  * shared experts always-on (qwen2-moe: 4 shared + 60 routed top-4)
  * dense residual FFN in parallel (arctic: dense path + 128e top-2)
  * no_drop mode (decode: capacity = group size, nothing dropped)

Returns the Switch-style load-balancing aux loss.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, Linear, cdtype, mlp, normal_param


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        d_ff, e, d = cfg.expert_ff, cfg.n_experts, cfg.d_model
        scale = (2.0 / (d + d_ff)) ** 0.5
        self.router = Linear(d, e, cfg, gen, device)
        # stacked expert weights: (E, d, ff) / (E, ff, d)
        self.w_gate = normal_param((e, d, d_ff), cfg, gen, device, scale)
        self.w_up = normal_param((e, d, d_ff), cfg, gen, device, scale)
        self.w_down = normal_param((e, d_ff, d), cfg, gen, device, scale)
        if cfg.n_shared_experts > 0:
            self.shared = MLP(cfg, gen, device,
                              d_ff=d_ff * cfg.n_shared_experts)
        if cfg.moe_dense_residual:
            self.dense = MLP(cfg, gen, device, d_ff=cfg.d_ff)


MOE_GROUP_SIZE = 2048


def _dispatch_group(xg, gate_idx, gate_vals, wg, wu, wd, E, cap, dtype):
    """One token group: xg (Tg, D), gate_idx/vals (Tg, K) -> (Tg, D)."""
    Tg, D = xg.shape
    K = gate_idx.shape[-1]
    TK = Tg * K
    dev = xg.device
    flat_e = gate_idx.reshape(TK)
    flat_gate = gate_vals.reshape(TK)
    tok_of = torch.arange(Tg, device=dev).repeat_interleave(K)

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank inside the expert segment = index - start of segment
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(TK, device=dev) - seg_start
    # unsort the slot assignment back to (token, k) order
    slot = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    valid = slot < cap
    buf_idx = torch.where(valid, flat_e * cap + slot, E * cap)  # E*cap: trash

    # write tokens into per-expert buffers (+1 trash row for drops): every
    # kept (token, k) pair has a slot of its own, so a copy is the
    # reference's add onto zeros
    vals = xg[tok_of] * valid[:, None].to(xg.dtype)
    expert_in = torch.zeros((E * cap + 1, D), dtype=dtype, device=dev)
    expert_in.index_copy_(0, buf_idx, vals.to(dtype))
    expert_in = expert_in[:E * cap].reshape(E, cap, D)

    # expert FFN, batched over E
    h = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wu)
    expert_out = torch.bmm(h, wd).reshape(E * cap, D)
    expert_out = torch.cat(
        [expert_out, torch.zeros((1, D), dtype=dtype, device=dev)], dim=0)

    # gather back + gate-weighted combine over K: a sum in k order from
    # zero, the reference's sequential scatter-add (index_add_ on the card
    # adds in whatever order its atomics land)
    out_tk = (expert_out[buf_idx] * (flat_gate * valid)[:, None].to(dtype)
              ).reshape(Tg, K, D)
    out = torch.zeros((Tg, D), dtype=dtype, device=dev)
    for k in range(K):
        out = out + out_tk[:, k]

    # per-expert token counts for the aux loss (from segment boundaries)
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                side="left")
    ends = torch.cat([starts[1:], starts.new_full((1,), TK)])
    return out, (ends - starts).float()


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig,
            no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    no_drop=True sets capacity = group size (nothing can overflow) — the
    decode-path mode, where dropping a token would corrupt generation.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    Tg = min(MOE_GROUP_SIZE, T)
    G = T // Tg
    if G * Tg != T:           # ragged small inputs: one group
        Tg, G = T, 1
    cap = Tg if no_drop else max(int(cfg.capacity_factor * Tg * K / E), 1)
    cap = min(cap, Tg)
    xt = x.reshape(G, Tg, D)
    cd = cdtype(cfg)

    router_logits = xt.float() @ p.router.w.float()             # (G, Tg, E)
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)           # (G, Tg, K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    wg, wu, wd = p.w_gate.to(cd), p.w_up.to(cd), p.w_down.to(cd)
    xc = xt.to(cd)
    outs, counts = zip(*(
        _dispatch_group(xc[g], gate_idx[g], gate_vals[g].float(), wg, wu, wd,
                        E, cap, cd) for g in range(G)))
    out = torch.stack(outs).reshape(B, S, D).to(x.dtype)

    # Switch aux loss: E * sum_e(fraction_routed_e * mean_prob_e)
    frac = torch.sum(torch.stack(counts), dim=0) / (T * K)       # (E,)
    mean_p = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac * mean_p)

    if cfg.n_shared_experts > 0:
        out = out + mlp(p.shared, x, cfg)
    if cfg.moe_dense_residual:
        out = out + mlp(p.dense, x, cfg)
    return out, aux.float()
