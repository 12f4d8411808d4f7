"""Serving steps (port of ``repro/serve/__init__.py``): prefill (context →
cache), decode (one token per row against its cache) and, for an encoder,
one full encode.

Positions are per row: the reference ``vmap``s a one-row decode over the
server's slots, the port gives each row of one decode its own position
(``models.layers.Positions``).  The steps take the device of the
parameters; the port does not jit, so a "compile" of the reference is a
distinct input shape here.  The cache is written in place and returned.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _device(params) -> torch.device:
    return params["final_norm"].device


def entry_device(params, device, who: str) -> torch.device:
    """The device a serving entry point runs on (``cuda`` unless
    ``device="cpu"``), where the parameters must already live."""
    dev = resolve_device(device)
    if _device(params).type != dev.type:
        raise ValueError(f"{who}: parameters live on {_device(params)}, "
                         f"not {dev}")
    return dev


def _prefill(cfg: ModelConfig, max_seq: int, window: int, params, batch,
             cache, last_only: bool = False):
    """forward over a prompt from position 0 into ``cache`` (a fresh
    ``init_cache`` when None): (logits (B, S, V), the primed cache).  A
    vlm prompt is its image prefix (``batch["img"]``) and then its text,
    at positions 0 … n_img + S − 1.  ``last_only``: the logits of the
    last position alone, (B, 1, V)."""
    if cfg.family == "vlm" and "img" not in batch:
        # the reference puts the text at positions n_img … n_img + S − 1
        # and fails to broadcast them against S tokens without an image
        raise ValueError(
            f"{cfg.name}: a vlm prefill needs batch['img'], its "
            f"{cfg.n_img_tokens} image-prefix embeddings: the reference "
            "places the text after them and cannot serve a prompt "
            "without one")
    if cache is None:
        B = next(iter(batch.values())).shape[0]
        cache = M.init_cache(cfg, B, max_seq, window, device=_device(params))
    logits, _, cache = M.forward(cfg, params, batch, cache=cache,
                                 window=window, use_cache=True,
                                 last_only=last_only)
    return logits, cache


def make_prefill_step(cfg: ModelConfig, max_seq: int,
                      window: int = 0) -> Callable:
    """prefill(params, batch, cache=None) -> (last-token logits (B, V),
    primed cache).  ``cache`` (a fresh ``init_cache`` by default) is
    written in place: the server passes its slot's view.  Only the last
    position's logits are computed (at 2 × 32768 tokens of a 256 000
    vocabulary all of them would take 33.5 GB in bf16)."""

    def prefill(params, batch, cache=None):
        logits, cache = _prefill(cfg, max_seq, window, params, batch, cache,
                                 last_only=True)
        return logits[:, -1], cache

    return prefill


def make_decode_step(cfg: ModelConfig, window: int = 0) -> Callable:
    """decode(params, cache, tokens (B, 1), pos) -> (logits (B, V), cache).

    ``pos`` is the absolute position of the new token: an int shared by
    the rows, or one per row ((B,) host array or tensor).
    """
    assert cfg.has_decode, f"{cfg.name} is encoder-only: no decode step"

    def decode(params, cache, tokens, pos):
        logits, _, cache = M.forward(cfg, params, {"tokens": tokens},
                                     cache=cache, positions=pos,
                                     window=window, use_cache=True)
        return logits[:, -1], cache

    return decode


def pow2_bucket(n: int, min_bucket: int = 8, max_bucket: int = 256) -> int:
    """Smallest power of two ≥ ``n`` clamped to [min_bucket, max_bucket].

    Prompts pad to these lengths, so a stream of varied-length prompts
    runs at most ``log2(max/min) + 1`` distinct prefill shapes."""
    if n < 1:
        raise ValueError(f"pow2_bucket: n={n} — prompts have ≥ 1 token")
    if n > max_bucket:
        raise ValueError(f"pow2_bucket: n={n} exceeds max_bucket="
                         f"{max_bucket} (the cache depth)")
    b = 1 << (int(n) - 1).bit_length()
    return min(max(b, min_bucket), max_bucket)


def pad_to_bucket(tokens, bucket: int):
    """Right-pad a ``(…, L)`` token batch (tensor or numpy) with zeros to
    ``(…, bucket)``.  Pads never reach the output: causal attention and
    the decode-time key mask hide positions ≥ the real length."""
    L = tokens.shape[-1]
    if L > bucket:
        raise ValueError(f"pad_to_bucket: length {L} > bucket {bucket}")
    if L == bucket:
        return tokens
    if isinstance(tokens, torch.Tensor):
        return torch.nn.functional.pad(tokens, (0, bucket - L))
    return np.pad(tokens, [(0, 0)] * (tokens.ndim - 1) + [(0, bucket - L)])


def make_bucketed_prefill_step(cfg: ModelConfig, max_seq: int,
                               window: int = 0) -> Callable:
    """Prefill over right-padded prompts: one shape per bucket.

    ``prefill(params, batch, length, cache=None)``: ``batch["tokens"]``
    is ``(B, S_b)`` padded to a bucket, ``length`` the real prompt length.
    Returns the logits at the last real token (after a vlm's image
    prefix) and the primed cache.
    Valid only for a dense (non-ring) attention cache: pads land in cache
    slots ≥ ``length``, which causal masking hides in the prefill and the
    decode's key mask afterwards, each decode step overwriting slot
    ``pos`` before attending it.  Recurrent state (ssm, hybrid) would
    fold the pads in, so callers gate on the family (``BatchedServer``).
    """
    def prefill(params, batch, length: int, cache=None):
        logits, cache = _prefill(cfg, max_seq, window, params, batch, cache)
        return logits[:, M.n_img(cfg) + int(length) - 1], cache

    return prefill


def make_feature_step(cfg: ModelConfig) -> Callable:
    """Masked FedPFT feature extraction over right-padded token batches.

    ``feats(params, tokens, length)``: ``tokens`` (B, S_b) right-padded,
    ``length`` (B,) real lengths → (B, d_model) f32, the mean-pooled
    final hidden state over the real positions only: exactly
    ``model.features`` on the unpadded sequence, because every
    decode-capable family is causal or left-to-right.  Rows with
    ``length == 0`` (unused slots) give zeros.
    """
    assert cfg.has_decode, (
        f"{cfg.name} is encoder-only: bidirectional attention mixes pad "
        "positions into real ones — serve unpadded batches instead")

    @torch.no_grad()
    def feats(params, tokens, length):
        h = M.final_hidden(cfg, params, {"tokens": tokens})
        length = length.to(h.device)
        mask = torch.arange(h.shape[1], device=h.device)[None, :] \
            < length[:, None]
        w = mask.float()[..., None]
        return (h.float() * w).sum(1) / length[:, None].float().clamp_min(
            1.0)

    return feats


def make_encode_step(cfg: ModelConfig, *,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Callable:
    """Encoder-only "serving": encode(params, batch) -> forward's logits
    (B, S, V) f32 of one full bidirectional encode of ``batch["frames"]``.
    Entry point: on ``cuda`` unless ``device="cpu"``; the parameters must
    live there, and the batch is moved there."""

    def encode(params, batch):
        dev = entry_device(params, device, "encode")
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        logits, _, _ = M.forward(cfg, params, batch)
        return logits

    return encode


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, prompt, n_new: int,
                    max_seq: int, window: int = 0, *,
                    device: Optional[Union[str, torch.device]] = None,
                    with_gaps: bool = False):
    """Prefill + greedy decode: (B, n_new) token ids.  Entry point: on
    ``cuda`` unless ``device="cpu"``; the parameters must live there.

    The reference runs one decode step past the last token and drops its
    result; the port stops at the last token, so a prompt of S tokens
    needs ``max_seq ≥ S + n_new − 1``.  ``with_gaps`` also returns each
    step's top-2 logit gap (B, n_new): where it is tiny, rounding may
    pick the other token.  A vlm raises ``ValueError``: the prompt has no
    image, and the reference cannot generate without one either.
    """
    dev = entry_device(params, device, "greedy_generate")
    prefill = make_prefill_step(cfg, max_seq, window)
    decode = make_decode_step(cfg, window)
    prompt = torch.as_tensor(prompt).to(dev)
    logits, cache = prefill(params, {"tokens": prompt})
    S = prompt.shape[1] + M.n_img(cfg)
    toks, gaps = [], []
    for i in range(n_new):
        top2 = torch.topk(logits, 2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        tok = torch.argmax(logits, -1)[:, None]
        toks.append(tok)
        if i + 1 < n_new:
            logits, cache = decode(params, cache, tok, S + i)
    out = torch.cat(toks, dim=1)
    return (out, torch.stack(gaps, 1)) if with_gaps else out
