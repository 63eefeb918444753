"""AdamW + cosine schedule + global-norm clipping, as plain tensor code.

The reference's arithmetic in its order: the global-norm clip, then the
count-based cosine schedule, the bias corrections and
``mhat / (sqrt(vhat) + eps) + wd * p``, all in f32. It is not
``torch.optim.AdamW``, whose clip, schedule and decay placement differ.
The state mirrors the parameters by name (``mu`` and ``nu`` are dicts
keyed as ``named_parameters()``), as the reference's pytree mirrors its
params. The elementwise updates run as ``torch._foreach_*`` ops over all
tensors at once (a few launches each on the card instead of one a
tensor), each op the reference's operation on the same operands.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor          # () int32


def named(params: Params) -> Dict[str, torch.Tensor]:
    """The parameters by name: ``named_parameters()`` of a module, or the
    mapping itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params: Params) -> AdamWState:
    ps = named(params)
    dev = next(iter(ps.values())).device
    return AdamWState(
        mu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in ps.items()},
        nu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in ps.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    step = step.float()
    warm = cfg.lr * torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [torch.sum(g.float() ** 2) for g in tree.values()]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Params, cfg: OptimizerConfig):
    """Returns (params, state, {"grad_norm", "lr"}). The new values are
    written in place into ``params``, ``state.mu``, ``state.nu`` and
    ``state.count`` (the reference returns new trees; in place, a full-size
    step holds one copy of each); ``grads`` is left as it was."""
    ps = named(params)
    names = list(ps)
    p = [ps[k] for k in names]
    mu = [state.mu[k] for k in names]
    nu = [state.nu[k] for k in names]
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    g = torch._foreach_mul([grads[k] for k in names], scale)
    state.count.add_(1)
    lr = lr_schedule(state.count, cfg)
    b1c = 1 - cfg.b1 ** state.count.float()
    b2c = 1 - cfg.b2 ** state.count.float()

    # mu = b1 * m + (1 - b1) * g
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - cfg.b1))
    # nu = b2 * v + (1 - b2) * g * g
    torch._foreach_mul_(nu, cfg.b2)
    gg = torch._foreach_mul(g, 1 - cfg.b2)
    torch._foreach_mul_(gg, g)
    del g
    torch._foreach_add_(nu, gg)
    del gg

    # p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)
    step = torch._foreach_div(mu, b1c)
    den = torch._foreach_div(nu, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(step, den)
    del den
    torch._foreach_add_(step, torch._foreach_mul(p, cfg.weight_decay))
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(p, step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
