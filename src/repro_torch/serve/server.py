"""Continuous-batching inference server (port of ``repro/serve/server.py``).

A fixed pool of B slots; each slot owns one request's cache or state.
Admission prefills a prompt straight into a free slot's rows of the pool's
cache; every ``step()`` advances ALL slots with ONE decode whose batch axis
is the slot axis, each row at its own absolute position (the reference
``vmap``s a one-row decode over the slots).  Greedy sampling; slots free
on EOS or at the sequence cap.  A mixture-of-experts decode routes each
slot as its own group, as the reference's one-row decodes do.  A request
carries no image, so a vlm's ``submit`` raises ``ValueError`` (the
reference cannot serve one either).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch import serve as _serve
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: object                # (S,) token ids, numpy or tensor
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    n_slots: int = 4
    max_seq: int = 256
    window: int = 0
    eos_id: int = -1              # -1: never stop early
    min_bucket: int = 8           # smallest padded prefill length


def _slot_view(tree, i: int):
    """Every leaf's rows of slot i (axis 1 of every cache leaf), as views."""
    return {k: _slot_view(v, i) if isinstance(v, dict) else v[:, i:i + 1]
            for k, v in tree.items()}


class BatchedServer:
    """Entry point: on ``cuda`` unless ``device="cpu"``; the parameters
    must live there."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServerConfig,
                 device: Optional[Union[str, torch.device]] = None):
        assert cfg.has_decode, f"{cfg.name} is encoder-only"
        self.device = _serve.entry_device(params, device, "BatchedServer")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        B, S = scfg.n_slots, scfg.max_seq
        self.cache = M.init_cache(cfg, B, S, scfg.window, device=self.device)
        self.positions = np.zeros((B,), np.int64)   # next position, host
        self.last_tok = torch.zeros((B, 1), dtype=torch.long,
                                    device=self.device)
        self.active: List[Optional[Request]] = [None] * B
        self.admitted_order: List[int] = []   # rids in admission order
        # Padded-prompt prefill needs a dense attention cache: pads park in
        # masked-out cache rows there, but would corrupt ssm/hybrid O(1)
        # recurrent state or a window > 0 ring buffer, which prefill at
        # their exact length.
        self.bucketed = (scfg.window == 0
                         and cfg.family not in ("ssm", "hybrid"))
        if self.bucketed:
            self._prefill = _serve.make_bucketed_prefill_step(
                cfg, S, window=scfg.window)
        else:
            self._prefill = _serve.make_prefill_step(cfg, S,
                                                     window=scfg.window)
        self._decode = _serve.make_decode_step(cfg, window=scfg.window)
        self._prefill_shapes: Set[Tuple[int, ...]] = set()

    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run so far (bounded by the buckets):
        the port does not jit, so this counts what the reference's jit
        would have compiled."""
        return len(self._prefill_shapes)

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _reset_slot(self, i: int) -> Dict:
        """Slot i's cache rows, recurrent state zeroed (a fresh request
        starts from zeros; stale KV rows are masked until overwritten)."""
        view = _slot_view(self.cache, i)
        recurrent = (view if self.cfg.family == "ssm" else
                     view.get("mamba", {}))
        for leaf in recurrent.values():
            leaf.zero_()
        return view

    def submit(self, req: Request) -> bool:
        """Admit a request (prefill now). False if no slot is free.

        The prefill itself generates the first token, so a request can
        TERMINATE here — ``max_new=1``, EOS as the first token, or a prompt
        already at the sequence cap never occupies a decode slot.
        """
        slots = self.free_slots()
        if not slots:
            return False
        i = slots[0]
        prompt = torch.as_tensor(req.prompt).to(self.device).long()
        L = prompt.shape[0]
        view = self._reset_slot(i)
        if self.bucketed:
            bucket = _serve.pow2_bucket(L, self.scfg.min_bucket,
                                        self.scfg.max_seq)
            tokens = _serve.pad_to_bucket(prompt[None, :], bucket)
            logits, _ = self._prefill(self.params, {"tokens": tokens}, L,
                                      cache=view)
        else:
            tokens = prompt[None, :]
            logits, _ = self._prefill(self.params, {"tokens": tokens},
                                      cache=view)
        self._prefill_shapes.add(tuple(tokens.shape))
        first = int(torch.argmax(logits[0]))
        req.out.append(first)
        self.admitted_order.append(req.rid)
        n_img = M.n_img(self.cfg)
        if (req.max_new <= 1 or first == self.scfg.eos_id
                or L + n_img >= self.scfg.max_seq):
            req.done = True           # finished at prefill: slot stays free
            return True
        self.positions[i] = L + n_img
        self.last_tok[i, 0] = first
        self.active[i] = req
        return True

    def step(self) -> int:
        """One decode step for every slot: a free slot runs at its frozen
        position on its own last token, and its rows are rewritten at its
        next admission.  Returns the number of requests still active."""
        if all(r is None for r in self.active):
            return 0
        logits, _ = self._decode(self.params, self.cache, self.last_tok,
                                 self.positions)
        self.last_tok = torch.argmax(logits, dim=-1)[:, None]
        nxt_h = self.last_tok[:, 0].cpu().numpy()   # one transfer a step
        n_active = 0
        for i, r in enumerate(self.active):
            if r is None:
                continue
            self.positions[i] += 1
            tok = int(nxt_h[i])
            r.out.append(tok)
            if (len(r.out) >= r.max_new
                    or tok == self.scfg.eos_id
                    or int(self.positions[i]) >= self.scfg.max_seq - 1):
                r.done = True
                self.active[i] = None
            else:
                n_active += 1
        return n_active

    # ------------------------------------------------------------------
    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve a request list to completion with continuous admission."""
        pending = list(requests)
        while pending or any(r is not None for r in self.active):
            while pending and self.free_slots():
                if not self.submit(pending[0]):
                    break
                pending.pop(0)
            self.step()
        return {r.rid: r.out for r in requests}
