"""jamba-1.5-large-398b — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave.
[arXiv:2403.19887]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24_576,
    moe_every=2,
    # period-8 unit: attention at position 3 (1 attn : 7 mamba, as in Jamba)
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    ssm_state_dim=16,
    ssm_expand=2,
)
