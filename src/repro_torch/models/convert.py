"""Parameters of the reference model, carried into the port.

``params_from_numpy(cfg, tree)`` takes the reference's ``init_params``
pytree with every leaf as a numpy array (layer stacks ``(L, …)``,
``x @ W`` orientation — the port's own layout) and returns the port's
parameter dict, so both packages compute the same features from the same
weights.  Every leaf takes ``cfg.dtype`` except those the reference holds
in f32 whatever the config says (RWKV6's ``w0`` and ``u``, Mamba2's
``A_log``, ``dt_bias`` and ``D``, the MoE ``router``): casting them would
change the result.
The leaves land on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.resolve_device`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import mamba2, rwkv
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _dtype

F32_LEAVES = frozenset(rwkv.F32_LEAVES + mamba2.F32_LEAVES + ("router",))


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict[str, Any]:
    device = resolve_device(device)
    dt = _dtype(cfg)

    def conv(name, a):
        if isinstance(a, dict):
            return {k: conv(k, v) for k, v in a.items()}
        # via f32: bf16 leaves (ml_dtypes on the reference side) convert
        # exactly, and the port never needs to know that type
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=device,
            dtype=torch.float32 if name in F32_LEAVES else dt)
    return {k: conv(k, v) for k, v in tree.items()}
