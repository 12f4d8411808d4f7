"""pixtral-12b — VLM: pixtral-ViT frontend (STUB) + mistral-nemo decoder.

[hf:mistralai/Pixtral-12B-2409] — the vision encoder + projector is stubbed
per the assignment: callers pass its patch embeddings as ``batch["img"]``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    mlp_variant="swiglu",
    rope_theta=1e9,        # mistral-nemo long-context base
    n_img_tokens=1024,     # image-prefix length
    img_embed_dim=1024,    # pixtral-ViT hidden size (stub frontend output)
    sliding_window=8192,
)
