"""Architecture configuration — one dataclass covers all 10 assigned archs.

Field semantics follow the assignment sheet; per-arch instances live in
``repro_torch.configs.<id>``. A field-for-field copy of the reference's
``ModelConfig``: configs are frozen and hashable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default d_model // n_heads

    # ---- MoE ----
    n_experts: int = 0                         # 0 => dense FFN
    experts_per_token: int = 0
    n_shared_experts: int = 0                  # qwen2-moe shared experts
    moe_dense_residual: bool = False           # arctic: dense FFN in parallel
    moe_d_ff: Optional[int] = None             # expert hidden if != d_ff
    moe_every: int = 1                         # jamba: MoE every 2nd layer
    capacity_factor: float = 1.25

    # ---- attention pattern ----
    sliding_window: Optional[int] = None       # window for 'local' layers
    local_global_ratio: int = 0                # gemma3: N local per 1 global
    attn_qkv_bias: bool = False                # qwen1.5: QKV bias
    attn_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0

    # ---- hybrid / SSM ----
    block_pattern: Tuple[str, ...] = ()        # repeating unit, e.g. 7x mamba + attn
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2

    # ---- xLSTM ----
    xlstm: bool = False                        # sLSTM/mLSTM alternating blocks
    xlstm_proj_factor: float = 2.0             # block up-projection (d_ff=0)

    # ---- encoder-decoder ----
    encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # ---- modality frontend (STUB per assignment) ----
    frontend: Optional[str] = None             # 'audio' | 'vision' | None

    # ---- numerics ----
    kv_cache_dtype: str = "compute"            # 'compute' | 'int8' (decode)
    dtype: str = "bfloat16"                    # activations/params compute dtype
    param_dtype: str = "float32"               # master params
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def layer_kinds(self) -> Tuple[str, ...]:
        """Resolved per-layer kind list of length n_layers (decoder side).

        Kinds: 'attn', 'local', 'global', 'mamba', 'slstm', 'mlstm'.
        """
        if self.xlstm:
            # xLSTM-7:1-style mix per arXiv:2405.04517 (sLSTM at positions of
            # every 4th block for the 125M config family)
            kinds = tuple("slstm" if i % 4 == 1 else "mlstm"
                          for i in range(self.n_layers))
            return kinds
        if self.block_pattern:
            period = len(self.block_pattern)
            return tuple(self.block_pattern[i % period]
                         for i in range(self.n_layers))
        if self.local_global_ratio > 0:
            period = self.local_global_ratio + 1
            # gemma3: L local then 1 global, repeating
            return tuple("global" if (i % period) == self.local_global_ratio
                         else "local" for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def ffn_kinds(self) -> Tuple[str, ...]:
        """Per-layer FFN type: 'moe' | 'dense' | 'none'."""
        kinds = self.layer_kinds()
        out = []
        for i, k in enumerate(kinds):
            if k in ("slstm", "mlstm"):
                out.append("none")      # xlstm: capacity inside the block
            elif self.is_moe and (i % self.moe_every == self.moe_every - 1
                                  if self.moe_every > 1 else True):
                out.append("moe")
            elif self.d_ff > 0:
                out.append("dense")
            else:
                out.append("none")
        return tuple(out)

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy (used by smoke tests)."""
        return dataclasses.replace(self, **overrides)

    # ---- parameter count (for roofline MODEL_FLOPS = 6 N D) -------------
    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.head_dim
        q = d * self.n_heads * h
        kv = 2 * d * self.n_kv_heads * h
        o = self.n_heads * h * d
        attn = q + kv + o

        def ffn_params(width: int) -> int:
            return 3 * d * width  # SwiGLU: gate, up, down

        kinds = self.layer_kinds()
        fkinds = self.ffn_kinds()
        total = 0
        active = 0
        for kind, fkind in zip(kinds, fkinds):
            if kind in ("attn", "local", "global"):
                total += attn
                active += attn
            elif kind == "mamba":
                d_in = self.ssm_expand * d
                m = (2 * d * d_in                            # in_proj (x, z)
                     + d_in * self.ssm_conv_dim
                     + d_in * 2 * self.ssm_state_dim         # B_t, C_t proj
                     + d_in * d_in + d_in                    # dt proj + bias
                     + d_in * self.ssm_state_dim + d_in      # A_log, D
                     + d_in * d)                             # out proj
                total += m
                active += m
            elif kind in ("slstm", "mlstm"):
                d_in = int(self.xlstm_proj_factor * d)
                m = 2 * d * d_in + d_in * d + 4 * d * d_in // 2
                total += m
                active += m
            if fkind == "moe":
                e_p = ffn_params(self.expert_ff)
                total += self.n_experts * e_p
                active += self.experts_per_token * e_p
                shared = self.n_shared_experts * e_p
                total += shared
                active += shared
                if self.moe_dense_residual:
                    total += ffn_params(self.d_ff)
                    active += ffn_params(self.d_ff)
                total += d * self.n_experts  # router
                active += d * self.n_experts
            elif fkind == "dense":
                total += ffn_params(self.d_ff)
                active += ffn_params(self.d_ff)
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        active += emb if self.tie_embeddings else 2 * emb
        if self.encoder_decoder:
            # encoder layers: self-attn + FFN; decoder adds cross-attn
            enc = self.n_encoder_layers * (attn + ffn_params(self.d_ff))
            dec_cross = self.n_layers * attn
            total += enc + dec_cross
            active += enc + dec_cross
        return active if active_only else total


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


LM_SHAPES = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
