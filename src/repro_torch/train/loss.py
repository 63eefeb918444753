"""Cross-entropy LM loss with z-loss regularizer, f32 numerics."""
from __future__ import annotations

import torch


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            z_loss_coef: float = 1e-4) -> tuple[torch.Tensor, dict]:
    """logits (B, S, V), labels (B, S) int. Mean over all tokens; returns
    (loss, {"nll", "z_loss", "ppl_proxy"}), all f32 tensors."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - tgt
    zl = z_loss_coef * (logz ** 2)
    loss = torch.mean(nll + zl)
    mean_nll = torch.mean(nll)
    metrics = {"nll": mean_nll, "z_loss": torch.mean(zl),
               "ppl_proxy": torch.exp(torch.clamp_max(mean_nll, 20.0))}
    return loss, metrics
