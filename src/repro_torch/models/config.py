"""Model configuration (copy of ``repro/models/config.py``).

Every architecture is a frozen ``ModelConfig``; the port keeps every field
so configurations carry over unchanged, including ``head_dim`` as a stored
field (``dataclasses.replace(cfg, d_model=…)`` keeps it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ARCH_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of ARCH_FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads

    # --- MLP variant ---
    mlp_variant: str = "swiglu"      # "swiglu" (3 mats) | "relu2" (2 mats, squared relu) | "gelu" (2 mats)

    # --- MoE ---
    n_experts: int = 0               # 0 => dense MLP
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM / RWKV ---
    ssm_state: int = 0               # mamba2 state size N
    ssm_head_dim: int = 64           # mamba2 P / rwkv6 head size
    ssm_expand: int = 2              # mamba2 inner expansion
    conv_width: int = 4
    chunk_size: int = 256            # chunked-scan chunk length

    # --- hybrid (zamba2) ---
    attn_every: int = 6              # shared attention block period

    # --- attention ---
    rope_theta: float = 1e6
    sliding_window: int = 0          # 0 => full attention; >0 => window size
    causal: bool = True              # False for encoder-only

    # --- vlm ---
    n_img_tokens: int = 0            # image-prefix length (vlm only)
    img_embed_dim: int = 0           # stubbed vision-frontend output dim

    # --- audio/encoder ---
    frame_embed_dim: int = 0         # stubbed conv-frontend output dim
    mask_prob: float = 0.08          # masked-prediction corruption rate

    # --- training ---
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    logit_softcap: float = 0.0       # grok uses 30.0

    def __post_init__(self):
        assert self.family in ARCH_FAMILIES, self.family
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no autoregressive decode path."""
        return self.family != "encoder"

    @property
    def supports_long_context(self) -> bool:
        """True when decode memory/compute is sub-quadratic in context length.

        SSM/hybrid are O(1)-state; attention archs qualify via sliding window.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                n_experts: Optional[int] = None) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        n_heads = max(2, min(self.n_heads, d_model // 64))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        ne = self.n_experts
        if ne:
            ne = min(ne, 4 if n_experts is None else n_experts)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 2 * d_model),
            vocab_size=min(self.vocab_size, 512),
            n_experts=ne,
            top_k=min(self.top_k, ne) if ne else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            # rwkv requires n_heads * ssm_head_dim == d_model
            ssm_head_dim=(d_model // n_heads if self.family == "ssm"
                          else min(self.ssm_head_dim, 32)),
            chunk_size=32,
            attn_every=2,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_img_tokens=min(self.n_img_tokens, 16) if self.n_img_tokens else 0,
            img_embed_dim=min(self.img_embed_dim, 64) if self.img_embed_dim else 0,
            frame_embed_dim=min(self.frame_embed_dim, 64) if self.frame_embed_dim else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
