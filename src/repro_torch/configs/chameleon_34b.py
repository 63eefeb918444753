"""chameleon-34b — 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536,
early-fusion VLM: VQ image tokens live in the text vocab, so the backbone
consumes plain token ids (frontend stub not needed at the input layer).
[arXiv:2405.09818]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=65_536,
    frontend="vision",
)
