"""nemotron-4-340b — dense, GQA kv=8, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_variant="relu2",   # squared ReLU, 2-matrix MLP
    rope_theta=1e4,
    sliding_window=8192,
)
