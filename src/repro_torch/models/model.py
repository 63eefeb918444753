"""Model assembly: embeddings -> layers -> logits.

The parameters are an ``LM`` module: the embedding, one module per decoder
layer in ``layers`` (the reference's scanned ``(R, ...)`` period stacks and
its tail, unstacked into layer order by ``layer_plan``), the final norm,
and for encoder-decoder models the encoder layers and their norm. Names
below ``layers.<i>`` are the reference's parameter keys.

Two paths:
  * ``forward``      — full-sequence (train / prefill; ``remat=`` checkpoints
    each repeat of the layer period)
  * ``decode_step``  — one token with per-layer caches/states (ring-buffer KV
    for attention layers, O(1) states for mamba/xlstm), updated in place
Encoder-decoder (seamless) adds ``encode`` and cross-attention in the
decoder layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from .attention import (Attention, attention, attention_decode,
                        init_layer_cache)
from .config import ModelConfig
from .layers import (MLP, Embedding, RMSNorm, cdtype, embed, mlp, rmsnorm,
                     unembed)
from .moe import MoE, moe_ffn
from .ssm import Mamba, init_mamba_state, mamba, mamba_decode
from .xlstm import (MLSTM, SLSTM, init_mlstm_state, init_slstm_state, mlstm,
                    mlstm_decode, slstm, slstm_decode)

ATTN_KINDS = ("attn", "local", "global")


def _period(cfg: ModelConfig) -> int:
    kinds = cfg.layer_kinds()
    if cfg.block_pattern:
        p = len(cfg.block_pattern)
    elif cfg.local_global_ratio > 0:
        p = cfg.local_global_ratio + 1
    elif cfg.xlstm:
        p = 4
    else:
        p = 1
    return min(p, len(kinds))


def layer_plan(cfg: ModelConfig) -> tuple[tuple[str, ...], int, int, int]:
    """(kinds, period P, repeats R, tail length): layer r*P + i is period
    position i of repeat r, and layers P*R.. are the tail."""
    kinds = cfg.layer_kinds()
    P = _period(cfg)
    if cfg.is_moe and cfg.moe_every > 1:
        # period positions must have a fixed FFN type across repetitions
        assert P % cfg.moe_every == 0, (P, cfg.moe_every)
    R = len(kinds) // P
    tail = len(kinds) - P * R
    return kinds, P, R, tail


# --------------------------------------------------------------- params ---

class Layer(nn.Module):
    """One decoder layer: its mixer (attention, mamba or an xLSTM cell) and
    its FFN (dense, MoE or none), each behind an RMSNorm."""

    def __init__(self, cfg: ModelConfig, kind: str, fkind: str, gen=None,
                 device=None):
        super().__init__()
        self.kind, self.fkind = kind, fkind
        self.ln1 = RMSNorm(cfg.d_model, cfg, device)
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, gen, device)
            if cfg.encoder_decoder:
                self.lnx = RMSNorm(cfg.d_model, cfg, device)
                self.xattn = Attention(cfg, gen, device)
        elif kind == "mamba":
            self.mamba = Mamba(cfg, gen, device)
        elif kind == "slstm":
            self.cell = SLSTM(cfg, gen, device)
        elif kind == "mlstm":
            self.cell = MLSTM(cfg, gen, device)
        else:
            raise ValueError(kind)
        if fkind != "none":
            self.ln2 = RMSNorm(cfg.d_model, cfg, device)
            self.ffn = (MoE(cfg, gen, device) if fkind == "moe"
                        else MLP(cfg, gen, device))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg, device)
        self.attn = Attention(cfg, gen, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg, device)
        self.ffn = MLP(cfg, gen, device)


class LM(nn.Module):
    """The parameters of one model. ``gen=None`` leaves the drawn weights
    uninitialised, for a caller that loads them."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.embed = Embedding(cfg, gen, device)
        self.ln_f = RMSNorm(cfg.d_model, cfg, device)
        self.layers = nn.ModuleList(
            Layer(cfg, kind, fkind, gen, device)
            for kind, fkind in zip(cfg.layer_kinds(), cfg.ffn_kinds()))
        if cfg.encoder_decoder:
            self.encoder = nn.ModuleList(
                EncoderLayer(cfg, gen, device)
                for _ in range(cfg.n_encoder_layers))
            self.ln_enc = RMSNorm(cfg.d_model, cfg, device)


def init_params(key: Union[int, torch.Generator], cfg: ModelConfig,
                device=None) -> LM:
    """Random master weights drawn on ``device`` (the card unless
    ``device="cpu"``) from ``key``: a seed, or a ``torch.Generator`` on
    that device."""
    dev = resolve_device(device)
    gen = (key if isinstance(key, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(key)))
    return LM(cfg, gen, dev)


# ------------------------------------------------------------- forward ----

def _layer_fwd(p: Layer, x: torch.Tensor, cfg: ModelConfig, kind: str,
               fkind: str, aux: torch.Tensor,
               memory: Optional[torch.Tensor]) -> tuple:
    h = rmsnorm(p.ln1, x, cfg)
    if kind in ATTN_KINDS:
        window = cfg.sliding_window if kind == "local" else None
        x = x + attention(p.attn, h, cfg, window=window)
        if cfg.encoder_decoder and memory is not None:
            hx = rmsnorm(p.lnx, x, cfg)
            x = x + attention(p.xattn, hx, cfg, kv_src=memory, causal=False)
    elif kind == "mamba":
        x = x + mamba(p.mamba, h, cfg)
    elif kind == "slstm":
        x = x + slstm(p.cell, h, cfg)
    elif kind == "mlstm":
        x = x + mlstm(p.cell, h, cfg)
    if fkind != "none":
        h2 = rmsnorm(p.ln2, x, cfg)
        if fkind == "moe":
            f, a = moe_ffn(p.ffn, h2, cfg)
            aux = aux + a
        else:
            f = mlp(p.ffn, h2, cfg)
        x = x + f
    return x, aux


def encode(params: LM, embeds: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """Encoder stack (enc-dec models); embeds (B, S_enc, D) from the
    frontend stub."""
    x = embeds.to(cdtype(cfg))
    for p in params.encoder:
        h = rmsnorm(p.ln1, x, cfg)
        x = x + attention(p.attn, h, cfg, causal=False)
        x = x + mlp(p.ffn, rmsnorm(p.ln2, x, cfg), cfg)
    return rmsnorm(params.ln_enc, x, cfg)


def forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
            memory: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass -> (logits (B,S,V) f32, moe aux loss scalar).

    ``remat=True`` is the reference's ``jax.checkpoint`` of a superblock:
    each repeat of the period's P layers (``layer_plan``) keeps only its
    input for the backward pass and recomputes the rest; the tail layers
    are not checkpointed, as in the reference. The values do not change.
    """
    x = (embeds.to(cdtype(cfg)) if embeds is not None
         else embed(params.embed, tokens, cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    _, P, R, _ = layer_plan(cfg)
    layers = params.layers

    def superblock(x, aux, r: int):
        for p in layers[r * P:(r + 1) * P]:
            x, aux = _layer_fwd(p, x, cfg, p.kind, p.fkind, aux, memory)
        return x, aux

    for r in range(R):
        if remat:
            # the forward draws no random numbers: no RNG state to replay
            x, aux = checkpoint(superblock, x, aux, r, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = superblock(x, aux, r)
    for p in layers[P * R:]:
        x, aux = _layer_fwd(p, x, cfg, p.kind, p.fkind, aux, memory)
    x = rmsnorm(params.ln_f, x, cfg)
    return unembed(params.embed, x, cfg), aux


# ---------------------------------------------------------------- decode --

@dataclasses.dataclass
class DecodeState:
    """The caches and positions of a batch of decode slots, which
    ``decode_step`` and ``reset_decode_slot`` update in place (so make it
    outside ``torch.inference_mode``: the reset writes its rows there)."""
    caches: List[Any]               # per layer: LayerKVCache or its state
    pos: torch.Tensor               # (B,) int32: next position PER batch slot
    memory: Optional[torch.Tensor] = None  # enc-dec cross-attention memory


def _kind_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int,
                device):
    if kind in ATTN_KINDS:
        cap = capacity if kind != "local" else min(
            capacity, cfg.sliding_window or capacity)
        return init_layer_cache(cfg, batch, cap, device=device)
    if kind == "mamba":
        return init_mamba_state(cfg, batch, device=device)
    if kind == "slstm":
        return init_slstm_state(cfg, batch, device=device)
    if kind == "mlstm":
        return init_mlstm_state(cfg, batch, device=device)
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int,
                      memory: Optional[torch.Tensor] = None,
                      device=None) -> DecodeState:
    """Fresh caches and states for ``batch`` slots on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return DecodeState(
        caches=[_kind_cache(cfg, kind, batch, capacity, dev)
                for kind in cfg.layer_kinds()],
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
        memory=memory)


@torch.no_grad()
def reset_decode_slot(cfg: ModelConfig, state: DecodeState, slot: int,
                      capacity: int) -> DecodeState:
    """Re-initialize batch slot ``slot`` of ``state`` in place for a fresh
    request: position back to 0 and every per-slot row of every cache /
    recurrent state restored to its init value (zero KV rows, unit
    quantization scales, zero mamba/xlstm states).

    This is the admission-time reset a continuous-batching engine needs:
    without it a request admitted into a freed slot inherits the previous
    occupant's position and cached keys/values.
    """
    fresh = init_decode_state(cfg, 1, capacity, device=state.pos.device)
    for full, one in zip(state.caches, fresh.caches):
        for f, o in zip(full, one):
            f[slot] = o[0]
    state.pos[slot] = 0
    if state.memory is not None:
        # zero the slot's cross-attention memory too — stale encoder output
        # is the same leak class as stale KV. An enc-dec engine must install
        # the NEW request's encoder memory into this row after the reset.
        state.memory[slot] = 0
    return state


def _layer_dec(p: Layer, x: torch.Tensor, cache, pos, cfg: ModelConfig,
               kind: str, fkind: str, memory,
               rings: Optional[dict] = None) -> tuple:
    h = rmsnorm(p.ln1, x, cfg)
    if kind in ATTN_KINDS:
        window = cfg.sliding_window if kind == "local" else None
        y, cache = attention_decode(p.attn, h, cache, pos, cfg, window=window,
                                    rings=rings)
        x = x + y
        if cfg.encoder_decoder and memory is not None:
            hx = rmsnorm(p.lnx, x, cfg)
            x = x + attention(p.xattn, hx, cfg, kv_src=memory, causal=False)
    elif kind == "mamba":
        y, cache = mamba_decode(p.mamba, h, cache, cfg)
        x = x + y
    elif kind == "slstm":
        y, cache = slstm_decode(p.cell, h, cache, cfg)
        x = x + y
    elif kind == "mlstm":
        y, cache = mlstm_decode(p.cell, h, cache, cfg)
        x = x + y
    if fkind != "none":
        h2 = rmsnorm(p.ln2, x, cfg)
        if fkind == "moe":
            f, _ = moe_ffn(p.ffn, h2, cfg, no_drop=True)
        else:
            f = mlp(p.ffn, h2, cfg)
        x = x + f
    return x, cache


@torch.inference_mode()
def decode_step(params: LM, tokens: torch.Tensor, state: DecodeState,
                cfg: ModelConfig) -> tuple[torch.Tensor, DecodeState]:
    """tokens (B, 1) -> (logits (B, 1, V), state). ``state``'s caches,
    recurrent states and positions are updated in place (the reference's
    jitted step with its state donated); the logits are inference
    tensors."""
    x = embed(params.embed, tokens, cfg)
    rings: dict = {}        # the positions' derived tensors, once a step
    for p, cache in zip(params.layers, state.caches):
        x, _ = _layer_dec(p, x, cache, state.pos, cfg, p.kind, p.fkind,
                          state.memory, rings)
    x = rmsnorm(params.ln_f, x, cfg)
    logits = unembed(params.embed, x, cfg)
    state.pos += 1
    return logits, state
