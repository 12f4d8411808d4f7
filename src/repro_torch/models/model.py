"""Model assembly of ``repro/models/model.py``: init and the feature map.

``features`` is the FedPFT foundation feature map (the ``f`` in the paper's
``w = h ∘ f``): the input embedding, the block stack, ``rms_norm``, and a
mean-pool over positions in f32.  Three families run:

  encoder — frame projection, bidirectional RoPE attention + GELU-MLP blocks
  ssm     — token embedding, an RWKV6 stack (``models/rwkv.py``)
  hybrid  — token embedding, a Mamba2 stack (``models/mamba2.py``) with ONE
            shared causal attention + SwiGLU block after every
            ``attn_every`` layers (zamba2-style weight sharing)

Parameters are a plain dict in the reference's layout: per-layer weights
stacked on a leading ``(L, …)`` axis, ``x @ W`` orientation.  The dense /
moe / vlm families wait for their slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, dense_init, dense_stack,
                                       mlp, rms_norm)

Params = Dict[str, Any]

FAMILIES = ("encoder", "ssm", "hybrid")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} waits for its slice (ROADMAP, port "
            "queue: serving and decoder families); the port runs the "
            f"{', '.join(FAMILIES)} families")


def _init_transformer_stack(cfg: ModelConfig, n_layers: int, dt,
                            generator: torch.Generator, dev) -> Params:
    """Stacked (L, …) transformer weights, drawn one layer at a time."""
    d, L = cfg.d_model, n_layers
    h, hk, dh, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def dense(shape):
        return dense_stack(L, shape, dt, generator, dev)
    w = {"ln1": torch.ones((L, d), dtype=dt, device=dev),
         "ln2": torch.ones((L, d), dtype=dt, device=dev),
         "wq": dense((d, h * dh)), "wk": dense((d, hk * dh)),
         "wv": dense((d, hk * dh)), "wo": dense((h * dh, d)),
         "w_in": dense((d, ff)), "w_out": dense((ff, d))}
    if cfg.mlp_variant == "swiglu":
        w["w_gate"] = dense((d, ff))
    return w


def _init_shared_attn_block(cfg: ModelConfig, dt, generator, dev) -> Params:
    """Zamba2's shared block: one full transformer block, reused."""
    stacked = _init_transformer_stack(cfg, 1, dt, generator, dev)
    return {k: v[0] for k, v in stacked.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random weights from ``generator``, the law of the reference's
    ``init_params`` (N(0, 1)/√fan_in, norms at one).  Every stack is
    drawn layer by layer on the device (``dense_stack``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    d = cfg.d_model
    p: Params = {}
    if cfg.family == "encoder":
        p["blocks"] = _init_transformer_stack(cfg, cfg.n_layers, dt,
                                              generator, dev)
        p["frame_proj"] = dense_init((cfg.frame_embed_dim, d), dt, generator,
                                     dev)
        p["mask_emb"] = dense_init((d,), dt, generator, dev, scale=0.02)
    else:
        p["embed"] = dense_init((cfg.vocab_size, d), dt, generator, dev,
                                scale=0.02)
    if cfg.family == "ssm":
        p["blocks"] = rwkv_mod.init_rwkv_block(cfg, cfg.n_layers, dt,
                                               generator, dev)
    elif cfg.family == "hybrid":
        p["blocks"] = mamba_mod.init_mamba_block(cfg, cfg.n_layers, dt,
                                                 generator, dev)
        p["shared_attn"] = _init_shared_attn_block(cfg, dt, generator, dev)
    p["final_norm"] = torch.ones((d,), dtype=dt, device=dev)
    p["lm_head"] = dense_init((d, cfg.vocab_size), dt, generator, dev)
    return p


def _embed_inputs(cfg: ModelConfig, params: Params, batch):
    """(x (B, S, d), positions (S,)): frames (B, S, F) through
    ``frame_proj`` for the encoder, token ids (B, S) through ``embed``
    otherwise."""
    if cfg.family == "encoder":
        x = batch["frames"].to(_dtype(cfg)) @ params["frame_proj"]
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None],
                            params["mask_emb"].to(x.dtype), x)
    else:
        x = params["embed"][batch["tokens"].long()]
    return x, torch.arange(x.shape[1], device=x.device)


def _transformer_block(cfg: ModelConfig, x, w, *, positions,
                       window: int = 0):
    x = x + attention(rms_norm(x, w["ln1"]), w, cfg, positions=positions,
                      window=window)
    return x + mlp(rms_norm(x, w["ln2"]), w, cfg)


def _layer(blocks: Params, layer: int) -> Params:
    return {k: v[layer] for k, v in blocks.items()}


def _run_transformer(cfg: ModelConfig, x, blocks, *, positions,
                     window: int = 0):
    for layer in range(cfg.n_layers):
        x = _transformer_block(cfg, x, _layer(blocks, layer),
                               positions=positions, window=window)
    return x


def _run_rwkv(cfg: ModelConfig, x, blocks):
    """The RWKV6 stack from a zero state (every layer starts at zeros, so
    one layer's zeros serve them all)."""
    zero = {k: v[0] for k, v in rwkv_mod.init_rwkv_state(
        cfg, x.shape[0], x.device, n_layers=1).items()}
    for layer in range(cfg.n_layers):
        x, _ = rwkv_mod.rwkv_block(cfg, x, _layer(blocks, layer), zero)
    return x


def _run_hybrid(cfg: ModelConfig, x, params, *, positions, window: int = 0):
    """Mamba2 stack with the shared block after layers attn_every − 1,
    2·attn_every − 1, … (n_layers // attn_every uses); the last
    n_layers % attn_every layers are a tail without it.  The features path
    keeps no KV cache, so the reference's zero ``shared_kv`` has no
    counterpart here."""
    A = cfg.attn_every
    zero = {k: v[0] for k, v in mamba_mod.init_mamba_state(
        cfg, 1, x.shape[0], x.device).items()}
    blocks = params["blocks"]
    for layer in range(cfg.n_layers):
        x, _ = mamba_mod.mamba_block(cfg, x, _layer(blocks, layer), zero)
        if (layer + 1) % A == 0:
            x = _transformer_block(cfg, x, params["shared_attn"],
                                   positions=positions, window=window)
    return x


def final_hidden(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Post-norm final hidden states (B, S, d)."""
    _check_family(cfg)
    x, positions = _embed_inputs(cfg, params, batch)
    if cfg.family == "ssm":
        x = _run_rwkv(cfg, x, params["blocks"])
    elif cfg.family == "hybrid":
        x = _run_hybrid(cfg, x, params, positions=positions)
    else:
        x = _run_transformer(cfg, x, params["blocks"], positions=positions)
    return rms_norm(x, params["final_norm"])


@torch.no_grad()
def features(cfg: ModelConfig, params: Params, batch,
             device: Optional[Union[str, torch.device]] = None
             ) -> torch.Tensor:
    """Mean-pooled final hidden state in f32: (B, d) features.

    ``batch`` holds ``frames`` (encoder) or ``tokens`` (ssm, hybrid).  Runs
    on ``cuda`` unless ``device="cpu"``; the batch is moved there and the
    parameters must already live there.
    """
    dev = resolve_device(device)
    if params["final_norm"].device.type != dev.type:
        raise ValueError(f"features: parameters live on "
                         f"{params['final_norm'].device}, not {dev}")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    return final_hidden(cfg, params, batch).float().mean(dim=1)
