"""grok-1-314b — MoE, 8 experts top-2. [hf:xai-org/grok-1]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    mlp_variant="gelu",
    n_experts=8,
    top_k=2,
    logit_softcap=30.0,
    sliding_window=8192,   # long_500k variant; 0-window full attn used for <=32k shapes
)
