"""The serve step factories: the one-token decode step and the bulk
prefill, as the serving engine and the serving CLI call them."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DecodeState, decode_step, encode, forward


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, tokens (B,1), state) -> (logits, state) —
    the one-new-token decode."""

    def serve_step(params, tokens, state: DecodeState):
        return decode_step(params, tokens, state, cfg)

    return serve_step


def make_prefill(cfg: ModelConfig):
    @torch.no_grad()
    def prefill(params, tokens, embeds: Optional[torch.Tensor] = None):
        memory = None
        if cfg.encoder_decoder:
            memory = encode(params, embeds, cfg)
        logits, _ = forward(params, tokens, cfg, memory=memory)
        return logits

    return prefill
