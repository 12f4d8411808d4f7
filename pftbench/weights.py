"""Random weights of a configuration, made on the device from the seed.

The law is the program's own initialisation (N(0, 1)/sqrt(fan_in) for
products, 0.02 N(0, 1) for the embedding, norms at one, Mamba2's A_log 0,
dt_bias -4, D 1, conv taps 0.5 N(0, 1)) in the layout the program serves:
per-layer weights stacked on a leading (L, ...) axis, ``x @ W`` orientation.
Each stacked leaf is drawn in bfloat16 by a few large calls of one torch
generator on the device (at most 2^30 values a call), never layer by layer.
Only what the feature map reads is made: no logits head, no mask embedding.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

_CALL = 1 << 30


def _normal(shape, scale: float, g: torch.Generator, dev, dtype):
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _CALL):
        part = flat[i:i + _CALL]
        part.normal_(0.0, 1.0, generator=g)
        part.mul_(scale)
    return out


def make(cfg: Dict, seed: int, device) -> Dict:
    """The parameter dict of model config ``cfg`` (the ``model`` group of a
    configuration file)."""
    dev = torch.device(device)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    d, L = cfg["d_model"], cfg["n_layers"]

    def normal(shape, fan_in=None, scale=None):
        s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        return _normal(shape, s, g, dev, dt)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def transformer(lead):
        H, Hk, D, ff = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                        cfg["d_ff"])
        w = {"ln1": full(lead + (d,), 1.0), "ln2": full(lead + (d,), 1.0),
             "wq": normal(lead + (d, H * D), d),
             "wk": normal(lead + (d, Hk * D), d),
             "wv": normal(lead + (d, Hk * D), d),
             "wo": normal(lead + (H * D, d), H * D),
             "w_in": normal(lead + (d, ff), d),
             "w_out": normal(lead + (ff, d), ff)}
        if cfg["mlp_variant"] == "swiglu":
            w["w_gate"] = normal(lead + (d, ff), d)
        return w

    p: Dict = {}
    if cfg["family"] == "encoder":
        p["frame_proj"] = normal((cfg["frame_embed_dim"], d),
                                 cfg["frame_embed_dim"])
        p["blocks"] = transformer((L,))
    elif cfg["family"] == "hybrid":
        di = cfg["ssm_expand"] * d
        N, P = cfg["ssm_state"], cfg["ssm_head_dim"]
        H = di // P
        conv_dim = di + 2 * N
        p["embed"] = normal((cfg["vocab_size"], d), scale=0.02)
        p["blocks"] = {
            "ln": full((L, d), 1.0),
            "w_in": normal((L, d, 2 * di + 2 * N + H), d),
            "conv_w": normal((L, cfg["conv_width"], conv_dim), scale=0.5),
            "conv_b": full((L, conv_dim), 0.0),
            "A_log": full((L, H), 0.0, torch.float32),
            "dt_bias": full((L, H), -4.0, torch.float32),
            "D": full((L, H), 1.0, torch.float32),
            "gn": full((L, di), 1.0),
            "w_out": normal((L, di, d), di)}
        p["shared_attn"] = transformer(())
    else:
        raise ValueError(f"no weights for family {cfg['family']!r}")
    p["final_norm"] = full((d,), 1.0)
    return p

