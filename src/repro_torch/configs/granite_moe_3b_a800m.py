"""granite-moe-3b-a800m — MoE 40 experts top-8, per-expert d_ff=512.

[hf:ibm-granite/granite-3.0-1b-a400m-base] — assignment header says "MoE 40e
top-8"; the bracket note says 32 experts. We follow the explicit config line
(40 experts); see DESIGN.md §6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    mlp_variant="swiglu",
    n_experts=40,
    top_k=8,
    sliding_window=8192,
)
