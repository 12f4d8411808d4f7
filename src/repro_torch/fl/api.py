"""Federation API, host ``Star`` path (port of ``repro/fl/api.py``).

A :class:`FedSession` composes a summarizer (per-class GMMs), a wire codec
(a real quantize → bytes → dequantize round trip, so ``comm_bytes ==
len(payload)`` and the server computes on the decoded parameters) and the
``Star`` topology (clients → server, one shot).  The server trains the
head straight from the decoded mixture-slot stack
(``core.head.train_head_from_gmms``, ``synthesis="fused"``).

The wire is byte-identical to the reference's: present-class subsetting,
round-to-nearest-even into the codec dtype, fields in ``gmm.WIRE_FIELDS``
order.  bf16 rounding goes through ``torch`` (``.to(torch.bfloat16)`` is
round-to-nearest-even, as ``ml_dtypes`` is).

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item: streaming ingest, the round-program cache, resilience, DP,
mesh execution, Chain/Ring, streamed/pooled synthesis, head summaries
and head aggregation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import planner as P

__all__ = [
    "QuantizedCodec", "WireHeader", "ClientMessage", "GMMSummarizer", "Star",
    "FedSession", "SessionResult", "encode_message", "decode_payload",
    "stack_messages", "fused_slot_stack",
]

_WIRE_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                "float32": torch.float32}
_GMM_FIELDS = G.WIRE_FIELDS
_LATER = "waits for its slice (ROADMAP, port queue: {})"


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} " + _LATER.format(item))


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantizedCodec:
    """fp16 / bf16 / fp32 wire codec over flat parameter dicts.

    ``encode`` rounds each leaf to ``dtype`` and concatenates raw bytes in
    a fixed field order; ``decode`` reverses it back to f32 numpy.
    ``len(encode(t))`` is exactly ``n_scalars(t) * bytes_per_scalar``.
    """
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.dtype not in _WIRE_DTYPES:
            raise ValueError(f"QuantizedCodec: unknown dtype {self.dtype!r}")

    @property
    def bytes_per_scalar(self) -> int:
        return _WIRE_DTYPES[self.dtype].itemsize

    def encode(self, arrays: Dict[str, Any], fields: Sequence[str]) -> bytes:
        wd = _WIRE_DTYPES[self.dtype]
        out = []
        for f in fields:
            t = torch.as_tensor(arrays[f]).detach().float().cpu() \
                .contiguous().to(wd)
            out.append(t.view(torch.int16 if wd.itemsize == 2
                              else torch.int32).numpy().tobytes())
        return b"".join(out)

    def decode(self, payload: bytes, shapes: Dict[str, Tuple[int, ...]],
               fields: Sequence[str]) -> Dict[str, np.ndarray]:
        wd = _WIRE_DTYPES[self.dtype]
        raw_dt = np.int16 if wd.itemsize == 2 else np.int32
        out, off = {}, 0
        for f in fields:
            n = int(np.prod(shapes[f], dtype=np.int64)) if shapes[f] else 1
            raw = np.frombuffer(payload, dtype=raw_dt, count=n, offset=off)
            out[f] = torch.from_numpy(raw.copy()).view(wd).float().numpy() \
                .reshape(shapes[f])
            off += n * wd.itemsize
        if off != len(payload):
            raise ValueError(f"decode: schema covers {off} bytes, payload "
                             f"has {len(payload)}")
        return out

    def decode_checked(self, payload: bytes,
                       shapes: Dict[str, Tuple[int, ...]],
                       fields: Sequence[str]
                       ) -> Tuple[Optional[Dict[str, np.ndarray]],
                                  Optional[str]]:
        """:meth:`decode` that never raises: ``(params, None)`` when clean,
        ``(None, reason)`` on a length mismatch, ``(params, reason)`` on
        non-finite scalars."""
        itemsize = _WIRE_DTYPES[self.dtype].itemsize
        want = sum(int(np.prod(shapes[f], dtype=np.int64)) if shapes[f]
                   else 1 for f in fields) * itemsize
        if len(payload) != want:
            return None, (f"length_mismatch: payload is {len(payload)} "
                          f"bytes, schema says {want}")
        out = self.decode(payload, shapes, fields)
        bad = G.nonfinite_fields(out, tuple(fields))
        if bad:
            return out, (f"non_finite: fields {bad} carry NaN/Inf "
                         "after decode")
        return out, None


@dataclasses.dataclass(frozen=True)
class WireHeader:
    """Out-of-band message metadata, not counted in ``comm_bytes``."""
    kind: str                      # "gmm" | "head"
    cov_type: str                  # GMM family ("" for head messages)
    d: int                         # feature dim
    K: int                         # mixture components (1 for head)
    n_classes: int
    counts: Tuple[int, ...]        # per-class sample counts, len C
    dtype: str                     # codec dtype the payload was written in

    @property
    def present(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in range(self.n_classes)
                     if self.counts[c] > 0)


def _gmm_shapes(cov_type: str, Cp: int, K: int, d: int):
    if cov_type == "full":
        raise _later("the full-covariance tril_pack wire",
                     "full-covariance EM and the tril_pack wire")
    return {"pi": (Cp, K), "mu": (Cp, K, d),
            "cov": (Cp,) + G.packed_cov_shape(cov_type, K, d)}


def _scatter_present(sub: Dict[str, np.ndarray], present, C: int, K: int,
                     d: int, cov_shape) -> Dict[str, np.ndarray]:
    """Present-class rows back into the (C, …) stack; absent classes get
    the placeholder pi = 1/K, zero mu and zero cov."""
    out = {"pi": np.full((C, K), 1.0 / K, np.float32),
           "mu": np.zeros((C, K, d), np.float32),
           "cov": np.zeros((C,) + tuple(cov_shape), np.float32)}
    for f in _GMM_FIELDS:
        out[f][present] = sub[f]
    return out


@dataclasses.dataclass
class ClientMessage:
    """Encoded payload + its decoded (C, …) f32 parameters.

    ``params`` holds what the receiver computes on: the round-tripped
    ``pi (C, K)``, ``mu (C, K, d)``, ``cov (C, K, …)`` as tensors on the
    device of the parameters that were encoded.
    """
    params: Dict[str, torch.Tensor]
    logliks: Tuple[float, ...]
    header: WireHeader
    payload: bytes

    @property
    def counts(self) -> np.ndarray:
        return np.asarray(self.header.counts, np.int64)

    @property
    def comm_bytes(self) -> int:
        return len(self.payload)


def encode_message(params: Dict, counts, logliks, *, kind: str,
                   cov_type: str, n_classes: int,
                   codec: QuantizedCodec) -> ClientMessage:
    """Client → wire: subset to present classes, quantize, serialize."""
    if kind != "gmm":
        raise _later("head messages (one-shot baselines)",
                     "DP, Chain/Ring and baselines")
    device = torch.as_tensor(params["mu"]).device
    counts = np.asarray(torch.as_tensor(counts).cpu(), np.float64) \
        .astype(np.int64).ravel()
    host = {k: np.asarray(torch.as_tensor(v).detach().float().cpu())
            for k, v in params.items()}
    K, d = host["mu"].shape[-2], host["mu"].shape[-1]
    present = np.flatnonzero(counts > 0)
    shapes = _gmm_shapes(cov_type, len(present), K, d)
    payload = codec.encode({f: host[f][present] for f in _GMM_FIELDS},
                           _GMM_FIELDS)
    header = WireHeader(kind=kind, cov_type=cov_type, d=int(d), K=int(K),
                        n_classes=int(n_classes),
                        counts=tuple(int(c) for c in counts),
                        dtype=codec.dtype)
    decoded = _scatter_present(codec.decode(payload, shapes, _GMM_FIELDS),
                               present, n_classes, K, d,
                               host["cov"].shape[1:])
    lls = np.asarray(torch.as_tensor(logliks).detach().float().cpu()).ravel()
    return ClientMessage(
        params={k: torch.from_numpy(v).to(device) for k, v in decoded.items()},
        logliks=tuple(float(v) for v in lls), header=header, payload=payload)


def decode_payload(header: WireHeader, payload: bytes
                   ) -> Tuple[Optional[Dict[str, np.ndarray]],
                              Optional[str]]:
    """Wire → the full (C, …) f32 parameter stack; never raises on a bad
    payload: ``(params, None)`` when clean, ``(None, reason)`` when it
    cannot be decoded, ``(params, reason)`` when it carries NaN/Inf."""
    if header.kind != "gmm":
        return None, f"bad_header: kind={header.kind!r} — expected 'gmm'"
    if header.dtype not in _WIRE_DTYPES:
        return None, f"bad_header: unknown wire dtype {header.dtype!r}"
    if header.cov_type not in G.COV_TYPES:
        return None, f"bad_header: cov_type={header.cov_type!r}"
    C, K, d = header.n_classes, header.K, header.d
    present = np.asarray(header.present, np.int64)
    shapes = _gmm_shapes(header.cov_type, len(present), K, d)
    sub, err = QuantizedCodec(header.dtype).decode_checked(
        payload, shapes, _GMM_FIELDS)
    if sub is None:
        return None, err
    return _scatter_present(sub, present, C, K, d, shapes["cov"][1:]), err


def stack_messages(messages: Sequence[ClientMessage]
                   ) -> Dict[str, torch.Tensor]:
    """Homogeneous messages → the server's stacked (M, C, K, …) batch."""
    return {f: torch.stack([m.params[f] for m in messages])
            for f in _GMM_FIELDS}


def fused_slot_stack(batch: Dict[str, torch.Tensor], counts,
                     samples_per_class: Optional[int] = None):
    """The planner's slot-table rows gathered from a stacked (M, C, K, …)
    batch → (flat (G, K, …) stack, slot labels, slot counts, plan), ready
    for ``core.head.train_head_from_gmms``."""
    counts = np.asarray(counts, np.int64)
    if counts.ndim == 1:
        counts = counts[None]
        batch = {k: v[None] for k, v in batch.items()}
    M, C = counts.shape
    plan = P.plan_synthesis(counts, samples_per_class)
    table = plan.slot_table
    dev = batch["mu"].device
    slots = torch.as_tensor(table.slots, device=dev)
    stack = {k: batch[k].reshape((M * C,) + tuple(batch[k].shape[2:]))[slots]
             for k in _GMM_FIELDS}
    labels = torch.as_tensor((table.slots % C).astype(np.int64), device=dev)
    return stack, labels, torch.as_tensor(table.counts, device=dev), plan


# ---------------------------------------------------------------------------
# summarizer, topology, session
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GMMSummarizer:
    """The paper's summary: one GMM per present class (Algorithm 1,
    lines 5-10), all C fits as one batched EM whose E-step is one fused
    kernel launch per iteration."""
    gmm: G.GMMConfig = G.GMMConfig()

    kind = "gmm"

    @property
    def cov_type(self) -> str:
        return self.gmm.cov_type

    def summarize(self, feats, labels, n_classes: int, *,
                  generator: torch.Generator):
        gmms, counts, lls = G.fit_classwise_gmms_batched(
            feats[None], labels[None], n_classes, self.gmm,
            generator=generator)
        return {k: v[0] for k, v in gmms.items()}, counts[0], lls[0]


@dataclasses.dataclass
class SessionResult:
    """What a federation round produced."""
    model: Any                     # the global head
    info: Dict
    messages: List[ClientMessage]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class Star:
    """Clients → server, one shot (Algorithm 1)."""
    name = "star"

    def run(self, session: "FedSession", client_datasets, *,
            generator: torch.Generator, device: torch.device
            ) -> SessionResult:
        phase = {"client_fit_s": 0.0, "encode_s": 0.0}
        messages = []
        for i, (f, y) in enumerate(client_datasets):
            t0 = time.perf_counter()
            params, counts, lls = session.client_summary(
                f, y, i, generator=generator, device=device)
            _sync(device)
            t1 = time.perf_counter()
            messages.append(session.encode(params, counts, lls))
            t2 = time.perf_counter()
            phase["client_fit_s"] += t1 - t0
            phase["encode_s"] += t2 - t1
        t0 = time.perf_counter()
        result = session.server_aggregate(messages, generator=generator,
                                          device=device)
        _sync(device)
        phase["server_s"] = time.perf_counter() - t0
        result.info["phase_s"] = phase
        return result


@dataclasses.dataclass(frozen=True)
class FedSession:
    """One federation instance: GMM summarizer × codec × Star topology.

    >>> sess = FedSession(n_classes=10,
    ...                   summarizer=GMMSummarizer(G.GMMConfig(5, "diag")))
    >>> result = sess.run(clients)                      # doctest: +SKIP
    >>> result.info["comm_bytes"] == sum(len(m.payload)
    ...                                  for m in result.messages)

    ``run`` is the entry point: on ``cuda`` unless ``device="cpu"``.
    """
    n_classes: int
    summarizer: Any = GMMSummarizer()
    codec: QuantizedCodec = QuantizedCodec("bfloat16")
    topology: Any = Star()
    head: H.HeadConfig = H.HeadConfig()
    normalize_features: bool = False
    samples_per_class: Optional[int] = None
    min_class_count: int = 0
    synthesis: str = "fused"
    aggregate: str = "synthesize"
    dp: Optional[Any] = None
    ingest: Optional[Any] = None
    program_cache: Optional[Any] = None
    resilience: Optional[Any] = None
    mesh: Any = None
    shards: Optional[int] = None
    client_summarizers: Optional[Tuple[Any, ...]] = None

    def _check_supported(self) -> None:
        refused = [
            (self.dp is not None, "DP", "DP, Chain/Ring and baselines"),
            (not isinstance(self.topology, Star), "Chain/Ring topologies",
             "DP, Chain/Ring and baselines"),
            (self.aggregate != "synthesize", "head aggregation",
             "DP, Chain/Ring and baselines"),
            (self.synthesis != "fused", f"synthesis={self.synthesis!r}",
             "streamed/pooled synthesis"),
            (self.ingest is not None, "streaming ingest",
             "ingest and round cache"),
            (self.program_cache is not None, "the round-program cache",
             "ingest and round cache"),
            (self.resilience is not None, "resilience", "faults"),
            (self.mesh is not None or self.shards is not None,
             "mesh execution", "mesh, launch and analysis"),
            (self.client_summarizers is not None,
             "heterogeneous client summarizers", "streamed/pooled synthesis"),
            (getattr(self.summarizer, "kind", "gmm") != "gmm",
             "head summaries", "DP, Chain/Ring and baselines"),
        ]
        for bad, what, item in refused:
            if bad:
                raise _later(what, item)

    def _normalize(self, feats: torch.Tensor) -> torch.Tensor:
        if not self.normalize_features:
            return feats
        n = feats.norm(dim=-1, keepdim=True)
        return feats / n.clamp_min(1.0)

    # -- client side --------------------------------------------------------

    def client_summary(self, feats, labels, i: int = 0, *,
                       generator: torch.Generator, device: torch.device):
        """Client ``i``'s per-class GMMs, counts and log-likelihoods."""
        feats = self._normalize(torch.as_tensor(feats).to(device).float())
        labels = torch.as_tensor(labels).to(device).long()
        params, counts, lls = self.summarizer.summarize(
            feats, labels, self.n_classes, generator=generator)
        if self.min_class_count:
            counts = torch.where(counts >= self.min_class_count, counts,
                                 torch.zeros_like(counts))
        return params, counts, lls

    def encode(self, params, counts, lls) -> ClientMessage:
        return encode_message(params, counts, lls, kind=self.summarizer.kind,
                              cov_type=self.summarizer.cov_type,
                              n_classes=self.n_classes, codec=self.codec)

    # -- server side --------------------------------------------------------

    def server_aggregate(self, messages: Sequence[ClientMessage], *,
                         generator: torch.Generator,
                         device: torch.device) -> SessionResult:
        if not messages:
            raise ValueError("server_aggregate needs at least one message")
        info: Dict = {"comm_bytes": sum(m.comm_bytes for m in messages),
                      "synthesis": "fused"}
        sigs = {(m.header.cov_type,) + tuple(
            tuple(m.params[f].shape) for f in _GMM_FIELDS) for m in messages}
        if len(sigs) > 1:
            raise _later("heterogeneous cohorts (mixed K / cov family)",
                         "streamed/pooled synthesis")
        stack, slot_labels, slot_counts, plan = fused_slot_stack(
            stack_messages(messages),
            np.stack([m.counts for m in messages]), self.samples_per_class)
        info["synthesis_plans"] = [plan]
        if len(plan.slot_table) == 0:
            # every class filtered out: a cleanly initialized head
            d = messages[0].header.d
            info.update(head_losses=torch.zeros((0,), device=device),
                        empty_cohort=True)
            return SessionResult(
                model=H.init_head(d, self.n_classes, generator=generator,
                                  device=device),
                info=info, messages=list(messages))
        head_params, losses = H.train_head_from_gmms(
            stack["pi"], stack["mu"], stack["cov"], slot_labels, slot_counts,
            self.n_classes, self.head, messages[0].header.cov_type,
            device=device, generator=generator)
        info["head_losses"] = losses
        return SessionResult(model=head_params, info=info,
                             messages=list(messages))

    # -- entry point --------------------------------------------------------

    def run(self, client_datasets: Sequence[Tuple[Any, Any]], *,
            seed: int = 0, device: Optional[str] = None) -> SessionResult:
        """One-shot round over ``[(feats_i, labels_i)]``: every draw comes
        from one ``torch.Generator`` seeded with ``seed`` on the session's
        device.  ``info["phase_s"]`` holds the host wall time of the client
        fits, the encoding and the server phase."""
        self._check_supported()
        dev = resolve_device(device)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        return self.topology.run(self, client_datasets, generator=generator,
                                 device=dev)
