"""FedPFT in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

A port of the JAX package ``repro`` (the reference), module for module:
``repro_torch.core.gmm`` answers to ``repro.core.gmm`` and so on.  The
port never imports JAX or anything of ``repro``.

Entry points (``fl.api.FedSession.run`` with any topology, synthesis mode
or summarizer, ``models.model.features``, ``core.gmm.fit_classwise_gmms``,
``core.head.train_head_from_gmms``, ``core.fedpft.run_fedpft`` and
``client_update``, ``core.dp.run_dp_fedpft``,
``core.decentralized.run_chain`` and ``chain_step``,
``fl.baselines.fedavg``, ``models.model.init_cache``,
``serve.greedy_generate``, ``serve.server.BatchedServer`` and
``serve.service.FedPFTService``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise instead of carrying on on the
CPU (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is requested (explicitly or by default) and absent —
    the port never falls back to the CPU on its own.  ``meta`` is
    accepted for shape-only work (``launch.input_specs``' shapes and the
    operation count of ``launch.hlo_cost``): a meta tensor takes the
    kernels' plain versions, which is all a count needs.  On CUDA, TF32 is
    switched off: the reference holds f32, and the E-step's
    x²·inv − 2x·(μ·inv) cancels terms that TF32's 10-bit mantissa cannot
    carry to the 3e-4 tolerance it is held to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available — pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
