"""zamba2-7b — hybrid Mamba2 backbone + shared full-attention block. [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,         # shared block is full MHA
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    mlp_variant="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    chunk_size=256,
    attn_every=6,
)
