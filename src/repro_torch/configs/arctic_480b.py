"""arctic-480b — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 PLUS a dense residual FFN in parallel.
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    moe_d_ff=4864,
)
