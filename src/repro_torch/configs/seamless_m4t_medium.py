"""seamless-m4t-medium — enc-dec 12L d_model=1024 16H d_ff=4096
vocab=256206, multimodal (audio frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings). [arXiv:2308.11596]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    encoder_decoder=True,
    n_encoder_layers=12,
    frontend="audio",
)
