"""Shape stand-ins for every (architecture × input shape × mode), and the
round program's static inputs (port of ``repro/launch/input_specs.py``).

The reference hands ``ShapeDtypeStruct``\\ s to ``jit(...).lower()``.  The
port's stand-in is a ``(shape, dtype)`` pair for a batch, and a tree of
``meta`` tensors for parameters and caches: the model's own ``init_params``
/ ``init_cache`` run on the ``meta`` device, so the shapes cannot drift
from what the card allocates, and nothing is allocated.  The modality
carve-out lives here: audio frame and image patch embeddings come
pre-computed at the right shape (the vlm's text is the sequence less its
image prefix).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import InputShape, ModelConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


def long_window(cfg: ModelConfig) -> int:
    """The sub-quadratic window used for long_500k on attention archs."""
    return cfg.sliding_window if cfg.sliding_window > 0 else 8192


def window_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Full attention ≤ 32k; a sliding window only for the 500k decode."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        return long_window(cfg)
    return 0


def batch_specs_for(cfg: ModelConfig, shape: InputShape,
                    mode: str) -> Dict[str, Spec]:
    """The data batch (mode ∈ train | prefill | decode) as ``(shape,
    dtype)`` pairs."""
    B, S = shape.global_batch, shape.seq_len
    ti = torch.int32
    if mode == "decode":
        return {"tokens": ((B, 1), ti)}
    if cfg.family == "encoder":
        batch = {"frames": ((B, S, cfg.frame_embed_dim), torch.float32)}
        if mode == "train":
            batch["mask"] = ((B, S), torch.bool)
            batch["targets"] = ((B, S), ti)
        return batch
    if cfg.family == "vlm":
        s_text = S - cfg.n_img_tokens
        batch = {"tokens": ((B, s_text), ti),
                 "img": ((B, cfg.n_img_tokens, cfg.img_embed_dim),
                         torch.float32)}
        if mode == "train":
            batch["labels"] = ((B, s_text), ti)
        return batch
    batch = {"tokens": ((B, S), ti)}
    if mode == "train":
        batch["labels"] = ((B, S), ti)
    return batch


def round_specs_for(sig) -> Tuple[Optional[Spec], ...]:
    """``(shape, dtype)`` of each positional input of
    ``fl.round.round_program`` — ``(pi, mu, cov, counts, slot_labels)`` —
    by the signature's layout; ``slot_labels`` is None in the wire layout
    (the program derives the labels).  The port allocates from these the
    static input buffers a captured CUDA graph reads on every replay."""
    from repro_torch.fl.round import WIRE_DTYPES
    if sig.layout == "wire":
        wd = WIRE_DTYPES[sig.dtype]
        lead = (sig.M, sig.C)
        return ((lead + (sig.K,), wd),
                (lead + (sig.K, sig.d), wd),
                (lead + sig.cov_shape(packed=True), wd),
                (lead, torch.int32),
                None)
    return (((sig.M, sig.K), torch.float32),
            ((sig.M, sig.K, sig.d), torch.float32),
            ((sig.M,) + sig.cov_shape(packed=False), torch.float32),
            ((sig.M,), torch.int32),
            ((sig.M,), torch.int32))


def params_shapes(cfg: ModelConfig) -> Any:
    """The parameter tree as ``meta`` tensors (shapes and dtypes only)."""
    return M.init_params(cfg, torch.Generator(), device="meta")


def cache_shapes(cfg: ModelConfig, shape: InputShape) -> Any:
    """The decode cache of ``shape`` as ``meta`` tensors."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                        window_for(cfg, shape), device="meta")


def mode_of(cfg: ModelConfig, shape: InputShape) -> str:
    return shape.kind  # "train" | "prefill" | "decode"


def pair_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch, shape) pair."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, f"{cfg.name} is encoder-only: no decode step"
    return True, ""
