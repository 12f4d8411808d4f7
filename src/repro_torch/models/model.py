"""The encoder family of ``repro/models/model.py``: init and feature map.

``features`` is the FedPFT foundation feature map (the ``f`` in the paper's
``w = h ∘ f``): frame projection, a stack of bidirectional RoPE attention +
GELU-MLP blocks, ``rms_norm``, and a mean-pool over frames in f32.
Parameters are a plain dict in the reference's layout: per-layer weights
stacked on a leading ``(L, …)`` axis, ``x @ W`` orientation.  The other
families (dense / moe / vlm / ssm / hybrid) wait for their slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention, dense_init, mlp, rms_norm

Params = Dict[str, Any]

_BLOCK_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_in", "w_out")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def _check_encoder(cfg: ModelConfig) -> None:
    if cfg.family != "encoder":
        raise NotImplementedError(
            f"family {cfg.family!r} waits for its slice (ROADMAP, port "
            "queue: serving and decoder families; RWKV with wkv6; Mamba2 / "
            "hybrid with ssd); the port runs the encoder family")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random encoder weights from ``generator``, the law of the
    reference's ``init_params`` (N(0, 1)/√fan_in, norms at one)."""
    _check_encoder(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    d, L = cfg.d_model, cfg.n_layers
    h, hk, dh, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def dense(shape, scale=None):
        return dense_init(shape, dt, generator, dev, scale)
    blocks = {
        "ln1": torch.ones((L, d), dtype=dt, device=dev),
        "ln2": torch.ones((L, d), dtype=dt, device=dev),
        "wq": dense((L, d, h * dh)),
        "wk": dense((L, d, hk * dh)),
        "wv": dense((L, d, hk * dh)),
        "wo": dense((L, h * dh, d)),
        "w_in": dense((L, d, ff)),
        "w_out": dense((L, ff, d)),
    }
    return {
        "frame_proj": dense((cfg.frame_embed_dim, d)),
        "mask_emb": dense((d,), scale=0.02),
        "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "lm_head": dense((d, cfg.vocab_size)),
    }


def _embed_inputs(cfg: ModelConfig, params: Params, batch):
    """(x (B, S, d), positions (S,)) from ``batch["frames"]`` (B, S, F)."""
    x = batch["frames"].to(_dtype(cfg)) @ params["frame_proj"]
    if "mask" in batch:
        x = torch.where(batch["mask"][..., None],
                        params["mask_emb"].to(x.dtype), x)
    return x, torch.arange(x.shape[1], device=x.device)


def _run_transformer(cfg: ModelConfig, x, blocks, *, positions,
                     window: int = 0):
    for layer in range(cfg.n_layers):
        w = {k: blocks[k][layer] for k in _BLOCK_KEYS}
        x = x + attention(rms_norm(x, w["ln1"]), w, cfg,
                          positions=positions, window=window)
        x = x + mlp(rms_norm(x, w["ln2"]), w, cfg)
    return x


def final_hidden(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Post-norm final hidden states (B, S, d)."""
    _check_encoder(cfg)
    x, positions = _embed_inputs(cfg, params, batch)
    x = _run_transformer(cfg, x, params["blocks"], positions=positions)
    return rms_norm(x, params["final_norm"])


@torch.no_grad()
def features(cfg: ModelConfig, params: Params, batch,
             device: Optional[Union[str, torch.device]] = None
             ) -> torch.Tensor:
    """Mean-pooled final hidden state in f32: (B, d) features.

    Runs on ``cuda`` unless ``device="cpu"``; the batch is moved there and
    the parameters must already live there.
    """
    dev = resolve_device(device)
    if params["frame_proj"].device.type != dev.type:
        raise ValueError(f"features: parameters live on "
                         f"{params['frame_proj'].device}, not {dev}")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    return final_hidden(cfg, params, batch).float().mean(dim=1)
