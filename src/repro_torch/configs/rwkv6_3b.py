"""rwkv6-3b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # 2560 / head_size 64
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    mlp_variant="relu2",   # rwkv channel-mix uses squared relu
    ssm_head_dim=64,
    chunk_size=64,         # WKV6 chunk length of the reference's chunked form
)
