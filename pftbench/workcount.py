"""The benchmark's yardstick: the chip's peaks, the model FLOPs of a features
pass, and each kernel's operations and bytes from its call shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W, dense.  A kernel's
bytes count each input read once and each output written once; its operations
are those of the algorithm at the call's shapes, whatever implements it.  A
kernel's least time is the larger of operations over the peak of its type and
bytes over the memory bandwidth.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores
F32_FLOPS = 67e12        # float32 on the CUDA cores (TF32 off)
HBM_BYTES_S = 3.35e12


def bound_s(work: Dict[str, float]) -> float:
    """The least time a kernel call can take on the chip."""
    return max(work["flops"] / work["peak"], work["bytes"] / HBM_BYTES_S)


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs a mask lets through, the queries at the last Sq of
    Sk positions."""
    pos = np.arange(Sk - Sq, Sk, dtype=np.int64)
    hi = pos if causal else np.full_like(pos, Sk - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_work(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int, *,
               causal: bool, window: int = 0, elem_bytes: int = 2) -> Dict:
    """softmax(q k^T / sqrt(D)) v: two products over the visible pairs; q,
    k, v read and o written once."""
    pairs = visible_pairs(Sq, Sk, causal, window)
    return {"flops": 4.0 * B * H * pairs * D,
            "bytes": elem_bytes * (2.0 * B * H * Sq * D
                                   + 2.0 * B * Hkv * Sk * D),
            "peak": BF16_FLOPS if elem_bytes == 2 else F32_FLOPS}


def ssd_work(B: int, H: int, T: int, P: int, N: int, *, chunk: int,
             elem_bytes: int = 2) -> Dict:
    """Chunked SSD with chunks of L = min(chunk, T): C B^T once per chunk for
    all heads, (decay . C B^T) x, C S and B^T x per head; x, y, B, C in the
    call's type, the log decays and both states float32."""
    L = min(chunk, T)
    n = B * H * T * P
    return {"flops": 2.0 * B * T * L * N
            + B * H * T * (2.0 * L * P + 4.0 * N * P),
            "bytes": elem_bytes * 2.0 * n + 4.0 * B * H * T
            + elem_bytes * 2.0 * B * T * N + 2 * 4.0 * B * H * N * P,
            "peak": BF16_FLOPS if elem_bytes == 2 else F32_FLOPS}


def estep_fused_work(Bx: int, B: int, N: int, K: int, d: int) -> Dict:
    """B diagonal fits over Bx shared (N, d) blocks: the (N, K) log
    numerators and the row logsumexp of every fit, float32."""
    return {"flops": 4.0 * B * N * K * d,
            "bytes": 4.0 * (Bx * N * d + 2 * B * K * d + B * K + B * N * K
                            + B * N),
            "peak": F32_FLOPS}


def estep_work(N: int, K: int, d: int) -> Dict:
    """One diagonal fit's (N, K) log numerators, float32."""
    return {"flops": 4.0 * N * K * d,
            "bytes": 4.0 * (N * d + 2 * K * d + K + N * K),
            "peak": F32_FLOPS}


def _mlp_mats(cfg: Dict) -> int:
    return 3 if cfg["mlp_variant"] == "swiglu" else 2


def _block_flops(cfg: Dict, S: int, causal: bool) -> float:
    """One transformer block over a sequence of S tokens."""
    d, H, Hk, D = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    proj = d * H * D * 2 + d * Hk * D * 2
    mlp = _mlp_mats(cfg) * d * cfg["d_ff"]
    attn = 4.0 * H * D * visible_pairs(S, S, causal)
    return 2.0 * S * (proj + mlp) + attn


def _mamba_flops(cfg: Dict, S: int) -> float:
    """One Mamba2 layer over S tokens: the projections, the depthwise conv and
    the recurrence (C^T S and the state update, per head)."""
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    N, P = cfg["ssm_state"], cfg["ssm_head_dim"]
    H = di // P
    proj = d * (2 * di + 2 * N + H) + di * d
    conv = cfg["conv_width"] * (di + 2 * N)
    return S * (2.0 * proj + 2.0 * conv + 4.0 * H * N * P)


def model_flops(cfg: Dict, seq_len: int) -> float:
    """Model FLOPs of one sample's features over ``seq_len`` real positions:
    every layer, every use of a shared block, no embedding lookup, no
    logits."""
    family, S = cfg["family"], seq_len
    if family == "encoder":
        return 2.0 * S * cfg["frame_embed_dim"] * cfg["d_model"] \
            + cfg["n_layers"] * _block_flops(cfg, S, causal=False)
    if family == "hybrid":
        uses = cfg["n_layers"] // cfg["attn_every"]
        return cfg["n_layers"] * _mamba_flops(cfg, S) \
            + uses * _block_flops(cfg, S, causal=True)
    raise ValueError(f"no FLOP count for family {family!r}")
