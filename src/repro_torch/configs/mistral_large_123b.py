"""mistral-large-123b — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768, dense. [hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    n_layers=88,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    tie_embeddings=False,
)
