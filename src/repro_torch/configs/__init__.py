"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the full-size ModelConfig;
``smoke_config(arch_id)`` returns the reduced same-family config used by the
CPU smoke tests (small widths/layers/experts/vocab, identical structure).
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import LM_SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "arctic-480b": "arctic_480b",
    "mistral-large-123b": "mistral_large_123b",
    "gemma3-27b": "gemma3_27b",
    "qwen1.5-32b": "qwen1p5_32b",
    "gemma3-1b": "gemma3_1b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "chameleon-34b": "chameleon_34b",
    "xlstm-125m": "xlstm_125m",
}

ARCH_IDS = tuple(_MODULES)

# archs whose every layer is full attention: long_500k is skipped — a 500k
# dense KV cache in every layer is the paper's "matrix exceeds device
# memory" regime.
FULL_ATTENTION_ARCHS = frozenset({
    "qwen2-moe-a2.7b", "arctic-480b", "mistral-large-123b", "qwen1.5-32b",
    "chameleon-34b", "seamless-m4t-medium",
})


def get_config(arch_id: str) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    cfg = get_config(arch_id)
    from repro_torch.models.model import _period
    P = _period(cfg)
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    # keep GQA ratio valid: heads % kv == 0
    while heads % kv:
        kv -= 1
    overrides = dict(
        n_layers=2 * P + (1 if cfg.n_layers % P else 0),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.is_moe:
        overrides.update(n_experts=8,
                         experts_per_token=min(cfg.experts_per_token, 2),
                         moe_d_ff=64,
                         # capacity == T at prefill: no token drops, so the
                         # decode == prefill equivalence test is exact
                         capacity_factor=4.0)
    if cfg.sliding_window:
        overrides.update(sliding_window=16)
    if cfg.encoder_decoder:
        overrides.update(n_encoder_layers=2)
    return cfg.scaled(**overrides)


def arch_shapes(arch_id: str) -> tuple[ShapeConfig, ...]:
    """The assigned shape cells that apply to this architecture."""
    shapes = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and arch_id in FULL_ATTENTION_ARCHS:
            continue  # documented skip
        shapes.append(s)
    return tuple(shapes)


__all__ = ["ARCH_IDS", "FULL_ATTENTION_ARCHS", "get_config", "smoke_config",
           "arch_shapes", "LM_SHAPES"]
