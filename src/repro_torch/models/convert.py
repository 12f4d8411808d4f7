"""Parameters of the reference model, carried into the port.

``params_from_numpy(cfg, tree)`` takes the reference's ``init_params``
pytree with every leaf as a numpy array (layer stacks ``(L, …)``,
``x @ W`` orientation — the port's own layout) and returns the port's
parameter dict in ``cfg.dtype``, so both packages compute the same
features from the same weights.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _BLOCK_KEYS, _check_encoder, _dtype

_TOP_KEYS = ("frame_proj", "mask_emb", "final_norm", "lm_head")


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: Optional[Union[str, torch.device]] = "cpu"
                      ) -> Dict[str, Any]:
    _check_encoder(cfg)
    dt = _dtype(cfg)

    def conv(a):
        # via f32: bf16 leaves (ml_dtypes on the reference side) convert
        # exactly, and the port never needs to know that type
        return torch.from_numpy(np.asarray(a, np.float32).copy()) \
            .to(device=device, dtype=dt)
    out = {k: conv(tree[k]) for k in _TOP_KEYS}
    out["blocks"] = {k: conv(tree["blocks"][k]) for k in _BLOCK_KEYS}
    return out
