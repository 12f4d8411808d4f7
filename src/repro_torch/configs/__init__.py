"""Architecture configs of the port: the backbones of the main path.

The paper's own feature extractors (ResNet-50 / ViT-B / CLIP ViT-B/32) are
stood in by a small encoder config (DESIGN.md §6).  ``hubert-xlarge``
(encoder), ``rwkv6-3b`` (ssm) and ``zamba2-7b`` (hybrid) are the
full-width feature backbones the port is driven at on the card;
``granite-3-2b`` (dense) is the full-width serving model, and ``yi-34b``
(dense) the ring-buffer test model, run ``reduced()``.  The moe / vlm
configs and the other large dense ones of ``repro/configs`` come with
ROADMAP item 11.
"""
from repro_torch.configs.granite_3_2b import CONFIG as _granite2
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv
from repro_torch.configs.yi_34b import CONFIG as _yi
from repro_torch.configs.zamba2_7b import CONFIG as _zamba
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [_yi, _rwkv, _granite2,
                                                _zamba, _hubert]}

FOUNDATION_STANDIN = ModelConfig(
    name="foundation-standin",
    family="encoder",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=64,
    mlp_variant="gelu",
    causal=False,
    frame_embed_dim=64,
)


def get_config(name: str) -> ModelConfig:
    if name == "foundation-standin":
        return FOUNDATION_STANDIN
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
