"""Decentralized FedPFT (paper §4.2, Figures 3/5/6; port of
``repro/core/decentralized.py``).

No server: clients form a chain.  Client i receives GMMs from client
i − 1, samples synthetic features from them, unions them with its own,
re-fits per-class GMMs on the union and passes those on: one pass
accumulates every client's knowledge into the last message, still one
message per client.  This is ``FedSession(topology=Chain())``; ``Ring``
(a chain with wraparound laps) goes through the same session.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.fedpft import ClientMessage, FedPFTConfig, session_for


def _as_v2(msg, n_classes: int, cov_type: str, codec):
    """A v1 :class:`ClientMessage` (raw ``gmms``) as an encoded message,
    its parameters through the codec round trip."""
    from repro_torch.fl import api as FA
    if isinstance(msg, FA.ClientMessage):
        return msg
    return FA.encode_message(msg.gmms, msg.counts, msg.logliks, kind="gmm",
                             cov_type=cov_type, n_classes=n_classes,
                             codec=codec)


def chain_step(feats, labels, n_classes: int,
               received: Optional[ClientMessage], cfg: FedPFTConfig, *,
               generator: Optional[torch.Generator] = None,
               device: Optional[str] = None) -> Tuple[object, Dict]:
    """One client's turn: union the local features with draws from the
    received message, re-fit, emit; also trains the local head on the
    union.  Entry point: runs on ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    sess = session_for(n_classes, cfg)
    if received is not None:
        received = _as_v2(received, n_classes, cfg.gmm.cov_type, sess.codec)
    return sess.chain_step(feats, labels, 0, received, generator=generator,
                           device=dev)


def run_chain(client_datasets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              n_classes: int, cfg: FedPFTConfig, *, seed: int = 0,
              device: Optional[str] = None) -> Tuple[List, List[Dict]]:
    """Linear topology (Figure 5): client 1 → 2 → … → I.  Entry point:
    runs on ``cuda`` unless ``device="cpu"``.  Returns the message each
    client sent and its local info (with its trained head)."""
    from repro_torch.fl import api as FA
    res = session_for(n_classes, cfg, topology=FA.Chain()).run(
        client_datasets, seed=seed, device=device)
    return res.messages, res.info["per_client"]
