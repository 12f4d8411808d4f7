"""Tiny cells for the CPU tests: the round loop, its comparison and its control
at sizes a test run holds, through the program's plain CPU path."""
from __future__ import annotations

import copy
import time
from typing import Dict

ENCODER = {"name": "tiny-encoder", "family": "encoder", "n_layers": 2,
           "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
           "d_ff": 128, "vocab_size": 16, "mlp_variant": "gelu",
           "causal": False, "frame_embed_dim": 16, "rope_theta": 1e6,
           "dtype": "float32"}
HYBRID = {"name": "tiny-hybrid", "family": "hybrid", "n_layers": 4,
          "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
          "d_ff": 128, "vocab_size": 32, "mlp_variant": "swiglu",
          "ssm_state": 16, "ssm_head_dim": 16, "ssm_expand": 2,
          "conv_width": 4, "chunk_size": 16, "attn_every": 2,
          "rope_theta": 1e6, "causal": True, "dtype": "float32"}
FEDPFT = {"K": 2, "cov_type": "diag", "em_iters": 5, "kmeans_iters": 2,
          "reg": 1e-4, "wire": "bfloat16", "head_steps": 40,
          "head_batch": 16, "head_lr": 1e-2, "noise_window": 8,
          "topology": "star", "synthesis": "fused"}


def cell(model: Dict) -> Dict:
    """A round cell of ``model`` at a tiny size: 2 clients x 40 rows."""
    frames = model["family"] == "encoder"
    mix = {"kind": "round", "n_clients": 2, "rows_per_client": 40,
           "batch": 16, "n_classes": 3, "input_dim": 32 if frames else 24,
           "class_sep": 3.0,
           "input": ({"kind": "frames", "n_frames": 8} if frames
                     else {"kind": "tokens", "n_bins": 4}),
           "pool": 2, "fedpft": dict(FEDPFT), "check": {"feature_rows": 6}}
    return {"config_file": {"model": copy.deepcopy(model)}, "mix": mix}


def run(cell_: Dict, seed: int = 2**31 + 77, seconds: float = 0.0,
        trace: bool = False) -> Dict:
    """One run of the cell on the CPU: its record, with the numbers it
    compares under ``numbers``."""
    from pftbench.workloads import round as R
    rec = R.run(cell_, seed, seconds, trace, "cpu", time.perf_counter())
    rec["numbers"] = R.compare(rec)
    return rec


def service_cell(model: Dict = HYBRID, rate: float = 200.0) -> Dict:
    """A service cell of ``model`` at a tiny size: prompts of 16 to 64
    tokens over 4 slots, clients of 8 rows."""
    mix = {"kind": "service", "rate": rate, "infer_share": 0.5,
           "len_min": 16, "len_max": 64, "rows_per_client": 8,
           "n_classes": 3, "input_dim": 64, "class_sep": 3.0, "n_bins": 4,
           "service": {"n_slots": 4, "max_seq": 64, "extract_share": 0.5},
           "ingest": {"capacity": 16, "chunk_size": 4},
           "fedpft": dict(FEDPFT),
           "check": {"feature_rows": 6, "infer_rows": 6}}
    return {"config_file": {"model": copy.deepcopy(model)}, "mix": mix}


def run_service(cell_: Dict, seed: int = 2**31 + 78, seconds: float = 0.2,
                trace: bool = False) -> Dict:
    from pftbench.workloads import service as S
    rec = S.run(cell_, seed, seconds, trace, "cpu", time.perf_counter())
    rec["numbers"] = S.compare(rec)
    return rec
