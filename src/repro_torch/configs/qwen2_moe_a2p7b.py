"""qwen2-moe-a2.7b — 24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE 60e top-4, 4 shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    n_experts=60,
    experts_per_token=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    attn_qkv_bias=True,
)
