"""gemma3-1b — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global, 128k. [hf:google/gemma-3-1b-pt]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    local_global_ratio=5,
    sliding_window=512,
    rope_theta=1_000_000.0,
)
