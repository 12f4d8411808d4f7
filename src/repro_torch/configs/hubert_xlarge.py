"""hubert-xlarge — encoder-only audio transformer (w2v2 arch). [arXiv:2106.07447]

The mel-spectrogram + conv feature extractor frontend is stubbed: inputs
are precomputed frame embeddings (``frame_embed_dim``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,        # masked-prediction codebook targets
    mlp_variant="gelu",
    causal=False,
    frame_embed_dim=512,   # conv-frontend output dim (stub)
    mask_prob=0.08,
)
