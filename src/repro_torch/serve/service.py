"""FedPFT-as-a-service (port of ``repro/serve/service.py``): one process
closing the paper's loop (DESIGN.md §12).

The backbone serves **extraction** traffic (a whole prompt per request →
its pooled features); clients fit GMMs on those features and submit wire
messages through the session's :class:`~repro_torch.fl.ingest
.IngestBroker`; once a round closes, the trained global head serves
**inference** traffic (one masked forward + a head product).

Both traffic classes draw from ONE fixed pool of ``n_slots`` batch rows.
Admission is traffic-class aware: when both queues wait, extraction is
guaranteed ``ceil(extract_share · n_slots)`` rows and inference the rest;
an under-full class backfills the other's rows.  Every step is one
``(n_slots, S_bucket)`` masked feature batch, so the number of distinct
shapes is bounded by the power-of-two prompt buckets, never by traffic.

The round program sits behind the session's
:class:`~repro_torch.launch.aot_cache.ProgramCache`: :meth:`warmup`
captures the one slots-layout signature the broker closes with
(``aot_cache.serving_grid``), so :meth:`close_round` captures nothing in
the request path.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch import serve as _serve
from repro_torch.core import head as H
from repro_torch.fl import ingest as IG
from repro_torch.launch import aot_cache as AC
from repro_torch.models.config import ModelConfig

EXTRACT = "extract"
INFER = "infer"

# extract admission policies near the round deadline (DESIGN.md §13):
# "shed" refuses with AdmissionError, "defer" parks the request for the
# next round
SHED = "shed"
DEFER = "defer"


class AdmissionError(RuntimeError):
    """An extract request was refused: too close to the round deadline.

    Raised only under ``extract_admission="shed"``: a feature extracted
    with less than ``deadline_guard_s`` of round left cannot be fitted,
    encoded and submitted before the broker seals.  The client retries
    next round (or the deployment uses ``"defer"``).
    """


@dataclasses.dataclass
class ServiceRequest:
    """One request: a token prompt plus its latency lifecycle
    (``t_submit``/``t_admit``/``t_done`` readings of the service's clock;
    ``ns_submit``/``ns_admit`` the same moments on the tracing clock,
    ``time.time_ns()``, for the ``serve.queued`` interval)."""
    rid: int
    kind: str                      # EXTRACT | INFER
    tokens: np.ndarray             # (L,) prompt
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    ns_submit: int = 0
    ns_admit: int = 0
    feats: Optional[np.ndarray] = None   # (d,) — extraction result
    label: Optional[int] = None          # head argmax — inference result
    done: bool = False
    deferred: bool = False         # parked past a deadline, re-enqueued
    #                                at the next close_round


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    n_slots: int = 8
    max_seq: int = 64
    min_bucket: int = 8
    extract_share: float = 0.5     # guaranteed extract fraction of the pool
    # an extract arriving with < deadline_guard_s of round left cannot
    # round-trip (extract → fit → submit) before the broker seals; 0.0
    # disables the guard (inert anyway without an ingest deadline)
    deadline_guard_s: float = 0.0
    extract_admission: str = SHED  # SHED refuses, DEFER parks to next round

    def __post_init__(self):
        if not 0.0 <= self.extract_share <= 1.0:
            raise ValueError(f"ServiceConfig: extract_share="
                             f"{self.extract_share} must be in [0, 1]")
        if self.n_slots < 1:
            raise ValueError(f"ServiceConfig: n_slots={self.n_slots}")
        if self.deadline_guard_s < 0.0:
            raise ValueError(f"ServiceConfig: deadline_guard_s="
                             f"{self.deadline_guard_s} must be >= 0")
        if self.extract_admission not in (SHED, DEFER):
            raise ValueError(f"ServiceConfig: extract_admission="
                             f"{self.extract_admission!r} not in "
                             f"({SHED!r}, {DEFER!r})")


class FedPFTService:
    """The serving loop: extract / ingest / train / infer in one process.

    ``session`` must be a ``FedSession(ingest=IngestConfig(...))``: the
    session owns the admission policy, the reservoir capacity and (via
    ``program_cache=``) the round-program cache; the service adds the
    request-level slot pool in front and the served head behind.  Entry
    point: on ``cuda`` unless ``device="cpu"``; the parameters must live
    there.
    """

    def __init__(self, cfg: ModelConfig, params, session,
                 scfg: ServiceConfig = ServiceConfig(),
                 clock=time.perf_counter,
                 device: Optional[Union[str, torch.device]] = None):
        if session.ingest is None:
            raise ValueError(
                "FedPFTService needs FedSession(ingest=IngestConfig(...)): "
                "client GMM messages stream through the session's broker — "
                "an unbounded message list defeats the service memory law")
        self.device = _serve.entry_device(params, device, "FedPFTService")
        self.cfg, self.params, self.session, self.scfg = \
            cfg, params, session, scfg
        self.clock = clock
        self._feats = _serve.make_feature_step(cfg)
        self._feature_shapes: Set[Tuple[int, int]] = set()
        self.head: Optional[Dict] = None          # installed by close_round
        self.broker = self._fresh_broker()
        self.queues: Dict[str, Deque[ServiceRequest]] = {
            EXTRACT: collections.deque(), INFER: collections.deque()}
        self.rounds = 0
        self.steps = 0
        self._next_rid = 0
        self.completed: Dict[str, List[ServiceRequest]] = {
            EXTRACT: [], INFER: []}
        self.rejected_no_head = 0
        self.shed_extracts = 0
        self.deferred_extracts = 0
        self._deferred: Deque[ServiceRequest] = collections.deque()

    def _fresh_broker(self) -> IG.IngestBroker:
        return IG.IngestBroker(self.session.ingest, self.session.n_classes,
                               samples_per_class=self.session
                               .samples_per_class, clock=self.clock)

    # -- request ingress ----------------------------------------------------

    def _request(self, kind: str, tokens, **kw) -> ServiceRequest:
        req = ServiceRequest(rid=self._next_rid, kind=kind,
                             tokens=np.asarray(tokens),
                             t_submit=self.clock(), ns_submit=time.time_ns(),
                             **kw)
        self._next_rid += 1
        return req

    def _enqueue(self, kind: str, tokens) -> ServiceRequest:
        tokens = np.asarray(tokens)
        if tokens.ndim != 1 or tokens.shape[0] < 1:
            raise ValueError(f"FedPFTService: prompt must be (L≥1,), got "
                             f"shape {tokens.shape}")
        if tokens.shape[0] > self.scfg.max_seq:
            raise ValueError(f"FedPFTService: prompt length "
                             f"{tokens.shape[0]} > max_seq "
                             f"{self.scfg.max_seq}")
        req = self._request(kind, tokens)
        self.queues[kind].append(req)
        return req

    def submit_extract(self, tokens) -> ServiceRequest:
        """Queue a feature-extraction request (a client's raw sample).

        With less than ``deadline_guard_s`` of broker time left the
        request is shed (:class:`AdmissionError`) or deferred to the next
        round, per ``extract_admission``.
        """
        guard = self.scfg.deadline_guard_s
        if guard > 0.0:
            left = self.broker.time_remaining()
            if left is not None and left < guard:
                if self.scfg.extract_admission == SHED:
                    self.shed_extracts += 1
                    raise AdmissionError(
                        f"FedPFTService: {left:.3f}s left in the round < "
                        f"deadline_guard_s={guard}s — extraction cannot "
                        f"complete the fit/submit round-trip; retry next "
                        f"round")
                req = self._request(EXTRACT, tokens, deferred=True)
                self.deferred_extracts += 1
                self._deferred.append(req)
                return req
        return self._enqueue(EXTRACT, tokens)

    def submit_infer(self, tokens) -> ServiceRequest:
        """Queue a classification request against the served global head."""
        if self.head is None:
            self.rejected_no_head += 1
            raise RuntimeError(
                "FedPFTService: no head is being served yet — inference "
                "opens after the first close_round()")
        return self._enqueue(INFER, tokens)

    def submit_update(self, client_id: int, message) -> str:
        """Forward a client's GMM wire message to the round's broker and
        return its verdict (``admitted``/``late``/``duplicate``/
        ``over_capacity``/``quarantined``/``closed``)."""
        return self.broker.submit(client_id, message)

    # -- the serving step ---------------------------------------------------

    def _admit(self) -> List[ServiceRequest]:
        """Pull ≤ n_slots requests across both classes: extraction is
        guaranteed ``ceil(extract_share · n_slots)`` rows when both queues
        wait, and whatever one class leaves unused, the other backfills."""
        B = self.scfg.n_slots
        ext, inf = self.queues[EXTRACT], self.queues[INFER]
        if ext and inf:
            n_ext = min(len(ext),
                        int(np.ceil(self.scfg.extract_share * B)))
        else:
            n_ext = min(len(ext), B)
        batch = [ext.popleft() for _ in range(n_ext)]
        batch += [inf.popleft() for _ in range(min(len(inf),
                                                   B - len(batch)))]
        while len(batch) < B and ext:          # backfill unused infer rows
            batch.append(ext.popleft())
        return batch

    def step(self) -> int:
        """One serving step: admit, batch, extract, classify.  Returns the
        number of requests completed.  The device sees one fixed-shape
        ``(n_slots, S_bucket)`` batch whatever the traffic mix: short rows
        are right-padded (the masked mean ignores pads), unused rows have
        length 0 (zeros)."""
        batch = self._admit()
        if not batch:
            return 0
        with obs.span("serve.step"):
            t_admit, ns_admit = self.clock(), time.time_ns()
            B, S = self.scfg.n_slots, self.scfg.max_seq
            bucket = _serve.pow2_bucket(max(r.tokens.shape[0] for r in batch),
                                        self.scfg.min_bucket, S)
            tokens = np.zeros((B, bucket), dtype=np.int64)
            length = np.zeros((B,), dtype=np.int64)
            real = 0
            for i, r in enumerate(batch):
                L = r.tokens.shape[0]
                tokens[i, :L] = r.tokens
                length[i] = L
                real += L
                r.t_admit, r.ns_admit = t_admit, ns_admit
                obs.interval("serve.queued", r.ns_submit, ns_admit, rid=r.rid)
            obs.count("serve.real_tokens", real)
            obs.count("serve.slot_positions", B * bucket)
            self._feature_shapes.add((B, bucket))
            feats = self._feats(self.params,
                                torch.from_numpy(tokens).to(self.device),
                                torch.from_numpy(length).to(self.device))
            infer_rows = [i for i, r in enumerate(batch) if r.kind == INFER]
            labels_h = None
            with obs.span("serve.step.fetch"):
                if infer_rows:
                    labels_h = torch.argmax(H.head_logits(self.head, feats),
                                            dim=-1).cpu().numpy()
                feats_h = feats.cpu().numpy()
            t_done = self.clock()
            for i, r in enumerate(batch):
                if r.kind == EXTRACT:
                    r.feats = feats_h[i]
                else:
                    r.label = int(labels_h[i])
                r.t_done, r.done = t_done, True
                self.completed[r.kind].append(r)
            self.steps += 1
            return len(batch)

    def drain(self) -> int:
        """Step until both queues are empty; returns requests completed."""
        n = 0
        while self.queues[EXTRACT] or self.queues[INFER]:
            n += self.step()
        return n

    # -- the FL round -------------------------------------------------------

    def close_round(self, seed: int = 0):
        """Close the broker, train the global head, start serving it.

        The server's draws are ``FedSession.aggregate_from_broker``'s
        (``round_generator(seed, 0)``), so the service head is bitwise the
        offline session's on the same admitted cohort.  A fresh broker
        opens for the next round, and extracts deferred past the old
        round's deadline re-enter the work queue.
        """
        result = self.session.aggregate_from_broker(self.broker, seed=seed,
                                                    device=self.device)
        self.head = result.model
        self.broker = self._fresh_broker()
        self.rounds += 1
        while self._deferred:
            self.queues[EXTRACT].append(self._deferred.popleft())
        return result

    def warmup(self, d: int) -> Dict:
        """Capture the round program of this service's one closing
        signature (``aot_cache.serving_grid``); a no-op without a
        ``program_cache`` on the session."""
        cache = self.session.program_cache
        if cache is None:
            return {}
        summ = self.session.summarizer
        sigs = AC.serving_grid(self.session.ingest.capacity,
                               self.session.n_classes,
                               summ.gmm.n_components, d,
                               cov_types=(summ.cov_type,))
        return cache.warmup(sigs, self.session.head, device=self.device)

    # -- introspection ------------------------------------------------------

    def feature_compiles(self) -> int:
        """Distinct ``(n_slots, bucket)`` feature-step shapes run (≤ the
        prompt buckets): what the reference's jit would have compiled."""
        return len(self._feature_shapes)

    def stats(self) -> Dict:
        """Throughput, latency and queue wait (admission less submission)
        per traffic class, broker accounting."""
        out: Dict = {"steps": self.steps, "rounds": self.rounds,
                     "rejected_no_head": self.rejected_no_head,
                     "shed_extracts": self.shed_extracts,
                     "deferred_extracts": self.deferred_extracts,
                     "deferred_pending": len(self._deferred),
                     "feature_compiles": self.feature_compiles(),
                     "ingest": self.broker.accounting()}
        for kind, reqs in self.completed.items():
            if not reqs:
                out[kind] = {"n": 0}
                continue
            lat = np.asarray([r.t_done - r.t_submit for r in reqs])
            wait = np.asarray([r.t_admit - r.t_submit for r in reqs])
            span = (max(r.t_done for r in reqs)
                    - min(r.t_submit for r in reqs))
            out[kind] = {
                "n": len(reqs),
                "rps": len(reqs) / span if span > 0 else float("inf"),
                "p50_us": float(np.percentile(lat, 50) * 1e6),
                "p99_us": float(np.percentile(lat, 99) * 1e6),
                "wait_p50_us": float(np.percentile(wait, 50) * 1e6),
                "wait_p99_us": float(np.percentile(wait, 99) * 1e6),
            }
        return out
