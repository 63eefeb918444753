"""gemma3-27b — 62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144,
5:1 local:global attention, 128k context. [hf:google/gemma-3 family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    local_global_ratio=5,
    sliding_window=1024,
    rope_theta=1_000_000.0,
)
