"""Analytic per-cell cost model: FLOPs / HBM bytes / collective bytes.

The port's copy of ``repro.analysis.analytic``, on
``repro_torch.models.config``; the arithmetic is the reference's, term for
term (the tests hold every function equal to it as floats). It holds no
hardware constant: a caller that turns a count into a rate brings the
device's peak (``chip_smoke.py`` phase 4h divides ``train_flops`` by a
measured step time).

Why analytic: every module is ours, so exact flop formulas are available
where a compiler's count of a loop body or a profiler's count of a
recomputed layer is not; the forward count is cross-checked against
``torch.utils.flop_counter.FlopCounterMode`` over the port's ``forward``
in ``tests/test_torch_analytic.py``.

Conventions:
  * train: fwd + bwd = 3x fwd matmul flops; remat adds ~1x fwd -> 4x.
  * attention score flops use the true causal/window footprint.
  * bytes: per-chip HBM traffic model (params + optimizer + activations +
    KV cache), documented inline per term.
  * collectives: per-chip bytes crossing the mesh, from the sharding rules
    (FSDP all-gathers, grad reduce-scatter, TP activation reductions,
    MoE all-to-all).
All numbers are GLOBAL totals; divide by chips for per-chip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class CellCost:
    flops: float            # global
    hbm_bytes: float        # global
    coll_bytes: float       # global
    detail: Dict[str, float]


def _attn_flops(cfg: ModelConfig, B: int, S: int, T: int, causal: bool,
                window: int | None) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    proj = 2.0 * B * S * d * (H * hd) + 2.0 * 2.0 * B * S * d * (Hkv * hd) \
        + 2.0 * B * S * (H * hd) * d
    if window is not None:
        t_eff = min(window, T)
        scores = 2.0 * 2.0 * B * H * S * t_eff * hd
    elif causal and S == T:
        scores = 2.0 * 2.0 * B * H * (S * (S + 1) / 2) * hd
    else:
        scores = 2.0 * 2.0 * B * H * S * T * hd
    return proj + scores


def _ffn_flops(cfg: ModelConfig, B: int, S: int, fkind: str) -> float:
    d = cfg.d_model
    if fkind == "none":
        return 0.0
    if fkind == "dense":
        return 2.0 * 3.0 * B * S * d * cfg.d_ff
    # moe
    ffe = cfg.expert_ff
    k = cfg.experts_per_token
    f = 2.0 * 3.0 * B * S * k * d * ffe               # routed experts
    f += 2.0 * B * S * d * cfg.n_experts               # router
    if cfg.n_shared_experts:
        f += 2.0 * 3.0 * B * S * d * (ffe * cfg.n_shared_experts)
    if cfg.moe_dense_residual:
        f += 2.0 * 3.0 * B * S * d * cfg.d_ff
    return f


def _mamba_flops(cfg: ModelConfig, B: int, S: int) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    f = 2.0 * B * S * d * 2 * di                       # in_proj
    f += 2.0 * B * S * di * cfg.ssm_conv_dim           # causal conv
    f += 2.0 * B * S * di * 2 * n                      # bc_proj
    f += 2.0 * B * S * di * di                         # dt_proj
    f += 9.0 * B * S * di * n                          # recurrence + read
    f += 2.0 * B * S * di * d                          # out_proj
    return f


def _xlstm_flops(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    d = cfg.d_model
    di = int(cfg.xlstm_proj_factor * d)
    H = cfg.n_heads
    hd = di // H
    f = 2.0 * B * S * d * 2 * di                       # up
    f += 2.0 * B * S * di * d                          # down
    if kind == "mlstm":
        f += 3.0 * 2.0 * B * S * di * di               # q,k,v
        f += 2.0 * B * S * di * 3 * H                  # gates
        f += 8.0 * B * S * H * hd * hd                 # C update + read
    else:  # slstm
        f += 2.0 * B * S * di * 4 * di                 # wx
        f += 2.0 * B * S * H * hd * 4 * hd             # recurrent wr
        f += 12.0 * B * S * di                         # gates/cell ops
    return f


def _embed_flops(cfg: ModelConfig, B: int, S: int, train: bool) -> float:
    # unembed matmul dominates (embedding lookup is a gather)
    f = 2.0 * B * S * cfg.d_model * cfg.vocab_size
    return f


def fwd_flops(cfg: ModelConfig, B: int, S: int, T: int | None = None,
              decode: bool = False) -> float:
    """Forward flops for S query tokens against history T (= S if None)."""
    T = T if T is not None else S
    kinds = cfg.layer_kinds()
    fkinds = cfg.ffn_kinds()
    total = 0.0
    for kind, fk in zip(kinds, fkinds):
        if kind in ("attn", "global"):
            total += _attn_flops(cfg, B, S, T, causal=not decode, window=None)
        elif kind == "local":
            total += _attn_flops(cfg, B, S, T, causal=not decode,
                                 window=cfg.sliding_window)
        elif kind == "mamba":
            total += _mamba_flops(cfg, B, S)
        elif kind in ("slstm", "mlstm"):
            total += _xlstm_flops(cfg, B, S, kind)
        total += _ffn_flops(cfg, B, S, fk)
    if cfg.encoder_decoder:
        Senc = T
        for _ in range(cfg.n_encoder_layers):
            total += _attn_flops(cfg, B, Senc, Senc, causal=False,
                                 window=None)
            total += _ffn_flops(cfg, B, Senc, "dense")
        # decoder cross-attention
        for kind in kinds:
            if kind in ("attn", "local", "global"):
                total += _attn_flops(cfg, B, S, Senc, causal=False,
                                     window=None)
    total += _embed_flops(cfg, B, S, train=not decode)
    return total


def train_flops(cfg: ModelConfig, shape: ShapeConfig,
                remat: bool = True) -> float:
    B, S = shape.global_batch, shape.seq_len
    f = fwd_flops(cfg, B, S)
    mult = 4.0 if remat else 3.0      # fwd + 2x bwd (+1x remat recompute)
    opt = 10.0 * cfg.param_count()    # AdamW elementwise
    return mult * f + opt


def decode_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    return fwd_flops(cfg, B, 1, T=S, decode=True)


def prefill_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    return fwd_flops(cfg, shape.global_batch, shape.seq_len)


# -------------------------------------------------------------- bytes -----

def _act_bytes_per_layer(cfg: ModelConfig, B: int, S: int) -> float:
    # ~16 d-wide tensors r/w per layer in compute dtype (empirical for our
    # blocks; dominated by the residual stream + projections)
    return 16.0 * B * S * cfg.d_model * 2.0


def train_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    n_params = cfg.param_count()
    # params: fwd read (bf16 cast) + bwd read + grad write + AdamW state r/w
    pbytes = n_params * (2.0 + 2.0 + 4.0 + 24.0)
    act = cfg.n_layers * _act_bytes_per_layer(cfg, B, S) * 2.0  # fwd+bwd
    # attention score traffic (chunked: logits written/read once per chunk)
    kinds = cfg.layer_kinds()
    score = 0.0
    for kind in kinds:
        if kind in ("attn", "global"):
            score += 4.0 * B * cfg.n_heads * S * S / 2
        elif kind == "local":
            w = cfg.sliding_window or S
            score += 4.0 * B * cfg.n_heads * S * min(w, S)
    return pbytes + act + score


def decode_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    n_active = cfg.param_count(active_only=True)
    pbytes = n_active * 2.0                      # read active params once
    # KV cache read per token (THE decode bottleneck); int8 mode halves it
    kv_b = 1.0 if cfg.kv_cache_dtype == "int8" else 2.0
    cache = 0.0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "global"):
            cache += B * S * cfg.n_kv_heads * cfg.head_dim * 2 * kv_b
        elif kind == "local":
            w = min(cfg.sliding_window or S, S)
            cache += B * w * cfg.n_kv_heads * cfg.head_dim * 2 * kv_b
        elif kind == "mamba":
            cache += B * cfg.ssm_expand * cfg.d_model * cfg.ssm_state_dim * 4
        elif kind in ("slstm", "mlstm"):
            di = int(cfg.xlstm_proj_factor * cfg.d_model)
            hd = di // cfg.n_heads
            cache += B * cfg.n_heads * hd * hd * 4.0
    act = cfg.n_layers * 16.0 * B * cfg.d_model * 2.0
    return pbytes + cache + act


def prefill_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    n_active = cfg.param_count(active_only=True)
    pbytes = n_active * 2.0
    act = cfg.n_layers * _act_bytes_per_layer(cfg, B, S)
    score = 0.0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "global"):
            score += 4.0 * B * cfg.n_heads * S * S / 2
        elif kind == "local":
            score += 4.0 * B * cfg.n_heads * S * min(cfg.sliding_window or S,
                                                     S)
    return pbytes + act + score


# --------------------------------------------------------- collectives ----

def train_coll_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                     tp: int = 16) -> float:
    """Global bytes crossing links per step under our sharding rules."""
    B, S = shape.global_batch, shape.seq_len
    n_params = cfg.param_count()
    # FSDP: all-gather params (bf16) fwd + bwd, reduce-scatter grads (f32).
    # ring cost ~ payload x (D-1)/D ~ payload, counted once per chip set.
    fsdp = n_params * 2.0 * 2.0 + n_params * 4.0
    # TP: 2 all-reduces of the (B, S, d) activations per attn/ffn layer pair
    act = B * S * cfg.d_model * 2.0
    tp_coll = cfg.n_layers * 2.0 * 2.0 * act
    # MoE all-to-all: tokens out + back, k copies
    moe = 0.0
    if cfg.is_moe:
        n_moe_layers = sum(1 for f in cfg.ffn_kinds() if f == "moe")
        moe = n_moe_layers * 2.0 * cfg.experts_per_token * act
    return fsdp + tp_coll + moe


def decode_coll_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                      serving_replicated: bool = False) -> float:
    """serving_replicated=True is §Perf iteration 1: weights replicated over
    the DP axes (TP-only sharding) — no per-token parameter all-gathers."""
    B = shape.global_batch
    act = B * 1 * cfg.d_model * 2.0
    # per layer: TP all-reduce of the single-token activations x2
    coll = cfg.n_layers * 2.0 * 2.0 * act
    if cfg.is_moe:
        n_moe = sum(1 for f in cfg.ffn_kinds() if f == "moe")
        coll += n_moe * 2.0 * cfg.experts_per_token * act
    if not serving_replicated:
        # FSDP-sharded weights: gather the active parameters every token
        coll += cfg.param_count(active_only=True) * 2.0
    return coll


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, chips: int,
              serving_replicated: bool = False) -> CellCost:
    if shape.kind == "train":
        return CellCost(train_flops(cfg, shape), train_bytes(cfg, shape),
                        train_coll_bytes(cfg, shape, chips),
                        {"fwd_flops": fwd_flops(cfg, shape.global_batch,
                                                shape.seq_len)})
    if shape.kind == "prefill":
        return CellCost(prefill_flops(cfg, shape), prefill_bytes(cfg, shape),
                        train_coll_bytes(cfg, shape, chips) / 3.0,
                        {})
    return CellCost(decode_flops(cfg, shape), decode_bytes(cfg, shape),
                    decode_coll_bytes(cfg, shape, chips,
                                      serving_replicated=serving_replicated),
                    {})
