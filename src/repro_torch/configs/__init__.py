"""Architecture configs of the port: all ten of ``repro/configs``.

The paper's own feature extractors (ResNet-50 / ViT-B / CLIP ViT-B/32) are
stood in by a small encoder config (DESIGN.md §6).  ``hubert-xlarge``
(encoder), ``rwkv6-3b`` (ssm), ``zamba2-7b`` (hybrid) and
``granite-moe-3b-a800m`` (moe) are the full-width feature backbones the
port is driven at on the card; ``granite-3-2b`` (dense) is the full-width
serving model and ``yi-34b`` (dense) the ring-buffer test model.
``grok-1-314b`` (moe), ``pixtral-12b`` (vlm), ``nemotron-4-340b`` (dense,
relu2) and ``granite-34b`` (dense, MQA) run on the card at full width with
their depth cut.
"""
from repro_torch.configs.granite_34b import CONFIG as _granite34
from repro_torch.configs.granite_3_2b import CONFIG as _granite2
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granitemoe
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv
from repro_torch.configs.yi_34b import CONFIG as _yi
from repro_torch.configs.zamba2_7b import CONFIG as _zamba
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _grok, _granite34, _nemotron, _yi, _rwkv,
        _granite2, _granitemoe, _zamba, _hubert, _pixtral,
    ]
}

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
