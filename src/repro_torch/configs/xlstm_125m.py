"""xlstm-125m — 12L d_model=768 4H d_ff=0 vocab=50304, sLSTM + mLSTM blocks
(d_ff=0: capacity lives in the block up-projection). [arXiv:2405.04517]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    xlstm=True,
    xlstm_proj_factor=2.0,
)
