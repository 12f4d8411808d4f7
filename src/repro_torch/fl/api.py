"""Federation API (port of ``repro/fl/api.py``).

A :class:`FedSession` composes four pieces: a summarizer (per-class GMMs,
or locally trained heads for the one-shot baselines), a wire codec (a
real quantize → bytes → dequantize round trip, so ``comm_bytes ==
len(payload)`` and the server computes on the decoded parameters), a
topology (``Star``: clients → server; ``Chain``: client i → i + 1, §4.2;
``Ring``: a chain with wraparound laps) and an optional DP hook applied
to the summary before encoding (Theorem 4.1).

The server trains the head straight from the decoded mixture slots by
default (``synthesis="fused"``: ``fl.round.round_program`` over the
cohort's M·C slot grid, eager or from the program cache).
``"streamed"`` materializes the count-stratified planner's buckets as
chunks (:func:`synthesize_chunks`) and streams them into
``core.head.train_head_streaming``; ``"pooled"`` concatenates them and
trains on the pool.  A cohort of mixed K, covariance family or wire
dtype has no one signature (``fl.round.signature_of``) and falls back to
``"pooled"``.  Head
messages are aggregated instead (``aggregate="avg" | "ensemble" |
"fedbe"``).

The wire is byte-identical to the reference's: present-class subsetting,
full covariances as their row-major lower triangle, round-to-nearest-even
into the codec dtype, fields in ``gmm.WIRE_FIELDS`` order.  bf16 rounding
goes through ``torch`` (``.to(torch.bfloat16)`` is round-to-nearest-even,
as ``ml_dtypes`` is).

Draws: a Star round gives the server and every client a
``torch.Generator`` of its own, each seeded by a pure function of the
round's seed and its index (:func:`round_generator`: 0 the server, 1 + i
client i, through splitmix64), as the reference splits its key into
``keys[0]`` and ``keys[1 + i]``.  So a client's message does not depend on
which other clients ran, failed or were retried, and the laws that rest
on that hold: streaming ≡ fused (DESIGN §9), and a partial round ≡ an
offline round over the survivors (§13).  A Chain relays one stream from
client to client.  Every sampling function also takes its draws as
tensors (JAX's threefry and torch's Philox never match stream for
stream), so tests can feed the reference's.

Around the Star round (DESIGN §9, §11, §13): ``ingest=IngestConfig(...)``
streams the messages through ``fl.ingest.IngestBroker`` into a
fixed-capacity slot reservoir; ``program_cache=ProgramCache(...)`` runs
the fused server as a captured CUDA graph per canonical cohort signature
(``launch.aot_cache``); ``resilience=ResilienceConfig(...)`` retries
transient client failures and quarantines malformed messages;
``run(..., faults=FaultPlan(...))`` runs the streaming round under a
deterministic fault schedule (``fl.faults``).

Mesh execution (DESIGN.md §5): ``FedSession(mesh=…)`` or ``shards=n``
runs the round as ``torch.distributed`` collectives
(:meth:`FedSession.run_sharded`): each rank of the "data" axis fits its
clients, each as one batched EM of its C fits, the bf16 wire crosses the
mesh in one all-gather (``core.distributed.fedpft_transfer``), and every
rank decodes it through the host codec (:func:`messages_from_wire`) and
trains the same head.  A materializing server transforms each bucket's
rows rank by rank (:func:`_shard_bucket`) from draws every rank makes
whole, so the samples do not depend on the rank count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import distributed as DF
from repro_torch.core import dp as DP
from repro_torch.core import gmm as G
from repro_torch.core import head as H
from repro_torch.fl import baselines as FB
from repro_torch.fl import ingest as IG
from repro_torch.fl import planner as P
from repro_torch.fl import resilience as RS
from repro_torch.fl import round as FR

__all__ = [
    "QuantizedCodec", "WireHeader", "ClientMessage", "GMMSummarizer",
    "HeadSummarizer", "Star", "Chain", "Ring", "FedSession", "SessionResult",
    "SYNTHESIS_MODES", "encode_message", "decode_payload", "stack_messages",
    "fused_slot_stack", "synthesize_batched", "synthesize_chunks",
    "synthesize_group_chunks", "synthesize_groups", "synthesize_looped",
    "round_generator", "messages_from_wire",
]

SYNTHESIS_MODES = ("fused", "streamed", "pooled")
_WIRE_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                "float32": torch.float32}
_GMM_FIELDS = G.WIRE_FIELDS
_HEAD_FIELDS = ("w", "b")

# a bucket's draws: (its global slot ids, its padded S) → {"comp": (G_b, S),
# "eps": (G_b, S, d)}
DrawFn = Callable[[np.ndarray, int], Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


def _bf16_nan_bits(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """bf16 bits of ``x`` with every NaN as the quiet NaN of its sign
    (0x7FC0 / 0xFFC0), as ``ml_dtypes`` rounds NaN; torch's own NaN bits
    depend on the conversion path (0xFFFF on the CPU's vector path)."""
    nan = torch.isnan(x)
    if not bool(nan.any()):
        return bits
    quiet = torch.where(torch.signbit(x), torch.tensor(-64, dtype=torch.int16),
                        torch.tensor(0x7FC0, dtype=torch.int16))
    return torch.where(nan, quiet, bits)


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
            x = torch.as_tensor(arrays[f]).detach().float().cpu().contiguous()
            bits = x.to(wd).view(torch.int16 if wd.itemsize == 2
                                 else torch.int32)
            if wd == torch.bfloat16:
                bits = _bf16_nan_bits(x, bits)
            out.append(bits.numpy().tobytes())
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
    """Wire shapes of ``Cp`` present classes (full covs tril-packed)."""
    return {"pi": (Cp, K), "mu": (Cp, K, d),
            "cov": (Cp,) + G.packed_cov_shape(cov_type, K, d)}


def _pack_cov(cov: torch.Tensor, cov_type: str) -> torch.Tensor:
    """(…, d, d) full covariances → their row-major lower triangle
    (``gmm.tril_pack``) where they lie, so only the packed half crosses
    to the host; other families pass."""
    return G.tril_pack(cov) if cov_type == "full" else cov


def _unpack_cov(packed: torch.Tensor, cov_type: str, d: int) -> torch.Tensor:
    return G.tril_unpack(packed, d) if cov_type == "full" else packed


def _cov_shape(cov_type: str, K: int, d: int) -> Tuple[int, ...]:
    """One class's decoded cov shape."""
    return {"full": (K, d, d), "diag": (K, d), "spher": (K,)}[cov_type]


def _scatter_present(sub: Dict[str, np.ndarray], present, C: int, K: int,
                     d: int, cov_type: str,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Present-class rows back into the (C, …) stack on ``device``, full
    covariances unpacked there; absent classes get the placeholder
    pi = 1/K, zero mu and zero cov."""
    out = {"pi": torch.full((C, K), 1.0 / K, device=device),
           "mu": torch.zeros((C, K, d), device=device),
           "cov": torch.zeros((C,) + _cov_shape(cov_type, K, d),
                              device=device)}
    rows = torch.as_tensor(present, device=device)
    for f in _GMM_FIELDS:
        val = torch.from_numpy(sub[f]).to(device)
        out[f][rows] = _unpack_cov(val, cov_type, d) if f == "cov" else val
    return out


@dataclasses.dataclass
class ClientMessage:
    """Encoded payload + its decoded f32 parameters.

    ``params`` holds what the receiver computes on, as tensors on the
    device of the parameters that were encoded: the round-tripped ``pi
    (C, K)``, ``mu (C, K, d)``, ``cov (C, K, …)`` of a GMM message, or
    ``w (d, C)``, ``b (C,)`` of a head message.
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
    """Client → wire: subset a GMM message to present classes (a head
    message ships whole), quantize, serialize; the message carries the
    payload and the decoded parameters."""
    params = {k: torch.as_tensor(v).detach().float()
              for k, v in params.items()}
    device = (params["mu"] if kind == "gmm" else params["w"]).device
    counts = np.asarray(torch.as_tensor(counts).cpu(), np.float64) \
        .astype(np.int64).ravel()
    if kind == "gmm":
        K, d = params["mu"].shape[-2], params["mu"].shape[-1]
        present = np.flatnonzero(counts > 0)
        shapes = _gmm_shapes(cov_type, len(present), K, d)
        fields = _GMM_FIELDS
        rows = torch.as_tensor(present, device=device)
        sub = {"pi": params["pi"][rows], "mu": params["mu"][rows],
               "cov": _pack_cov(params["cov"].to(device)[rows], cov_type)}
    elif kind == "head":
        d, K = params["w"].shape[0], 1
        shapes = {"w": (d, n_classes), "b": (n_classes,)}
        fields = _HEAD_FIELDS
        sub = params
    else:
        raise ValueError(f"encode_message: unknown kind {kind!r}")
    payload = codec.encode(sub, fields)
    header = WireHeader(kind=kind, cov_type=cov_type if kind == "gmm" else "",
                        d=int(d), K=int(K), n_classes=int(n_classes),
                        counts=tuple(int(c) for c in counts),
                        dtype=codec.dtype)
    decoded = codec.decode(payload, shapes, fields)
    if kind == "gmm":
        decoded = _scatter_present(decoded, present, n_classes, K, d,
                                   cov_type, device)
    else:
        decoded = {k: torch.from_numpy(v).to(device)
                   for k, v in decoded.items()}
    lls = np.asarray(torch.as_tensor(logliks).detach().float().cpu()).ravel()
    return ClientMessage(params=decoded,
                         logliks=tuple(float(v) for v in lls), header=header,
                         payload=payload)


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
    out = _scatter_present(sub, present, C, K, d, header.cov_type,
                           torch.device("cpu"))
    return {k: v.numpy() for k, v in out.items()}, err


def stack_messages(messages: Sequence[ClientMessage]
                   ) -> Dict[str, torch.Tensor]:
    """Homogeneous messages → the server's stacked (M, C, K, …) batch."""
    return {f: torch.stack([m.params[f] for m in messages])
            for f in _GMM_FIELDS}


def messages_from_wire(wire: Dict[str, torch.Tensor], counts, cov_type: str,
                       n_classes: int, codec: QuantizedCodec,
                       logliks=None, validate: bool = False):
    """Replicated mesh wire → one :class:`ClientMessage` per client.

    ``wire`` is what ``core.distributed.fedpft_transfer``'s all-gather
    left on every rank: ``gmm.pack_wire``'s bf16 (I, C, K, …) layout,
    full covariances tril-packed.  The mesh path and the codec share one
    layout (``gmm.WIRE_FIELDS`` / ``gmm.tril_pack``), so this is
    ``gmm.unpack_wire`` and then the :func:`encode_message` a host client
    runs: with a bf16 codec each present class's payload scalars are the
    bits that crossed the mesh.  ``comm_bytes`` keeps the host codec's
    meaning (Eqs. 9-11 over present classes); the padded collective also
    carries absent classes' placeholders, which ``run_sharded`` reports
    as ``info["mesh_wire_bytes"]``.

    ``validate=True`` is the mesh path's quarantine gate (DESIGN.md §13):
    a client whose present classes carry NaN/Inf becomes a
    ``fl.resilience.Rejection`` instead of a message, accounted at the
    bytes its present classes would have taken on the host wire, and the
    return is ``(messages, rejections)``.
    """
    counts = np.asarray(torch.as_tensor(counts).cpu()).astype(np.int64)
    I = counts.shape[0]
    d = int(wire["mu"].shape[-1])
    unpacked = G.unpack_wire({k: torch.as_tensor(v) for k, v in wire.items()},
                             cov_type, d)
    if logliks is None:
        logliks = np.zeros((I, n_classes), np.float32)
    logliks = np.asarray(torch.as_tensor(logliks).float().cpu())
    messages: List[ClientMessage] = []
    rejections: List[RS.Rejection] = []
    for i in range(I):
        params = {k: v[i] for k, v in unpacked.items()}
        if validate:
            present = np.flatnonzero(counts[i] > 0)
            rows = torch.as_tensor(present, device=params["mu"].device)
            bad = G.nonfinite_fields({k: params[k][rows]
                                      for k in _GMM_FIELDS})
            if bad:
                K = params["mu"].shape[-2]
                rejections.append(RS.Rejection(
                    client_id=i, reason="non_finite",
                    detail=f"mesh wire fields {bad} carry NaN/Inf",
                    comm_bytes=G.comm_bytes(cov_type, d, K, len(present),
                                            codec.bytes_per_scalar)))
                continue
        messages.append(encode_message(
            params, counts[i], logliks[i], kind="gmm", cov_type=cov_type,
            n_classes=n_classes, codec=codec))
    if validate:
        return messages, rejections
    return messages


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
# materialized synthesis: one sample per count bucket of the planner
# ---------------------------------------------------------------------------


def _sample_stacked(pi, mu, cov, S: int, cov_type: str, *,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Dict[str, torch.Tensor]] = None,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S draws from every mixture of a flat (G, K, …) stack → (G, S, d).

    Component ∝ pi, Gaussian through ``gmm.sampling_factor`` — the same
    primitives as the fused head, so the transform cannot drift between
    the materializing and the fused server.  ``draws``: ``comp`` (G, S)
    and ``eps`` (G, S, d); the reference draws them from
    ``fold_in(key, global slot id)``.  Full covariance groups the draws by
    (slot, component), never gathering a d × d factor per draw.
    ``rows`` (indices into the G slots): the draws are made for all G,
    as without it, and only these rows are transformed → (len(rows), S,
    d), a mesh rank's share (:func:`_shard_bucket`).
    """
    Gn, d = mu.shape[0], mu.shape[-1]
    dev = mu.device
    if draws is None:
        comp = torch.multinomial(pi.float().clamp_min(1e-20), S,
                                 replacement=True, generator=generator)
        eps = torch.randn((Gn, S, d), generator=generator, device=dev,
                          dtype=torch.float32)
    else:
        comp = draws["comp"].to(dev).long()
        eps = draws["eps"].to(dev, torch.float32)
    if rows is not None:
        comp, eps, mu, cov = comp[rows], eps[rows], mu[rows], cov[rows]
    n = mu.shape[0]
    slot = torch.arange(n, device=dev)[:, None].expand(n, S)
    fac = G.sampling_factor(cov, cov_type)                    # (G, K, …)
    return G.slot_gaussian(slot, comp, eps, mu, fac, cov_type)


def _shard_bucket(mesh, n_slots: int, device) -> torch.Tensor:
    """This rank's rows of a bucket of ``n_slots`` slots laid out over the
    mesh's "data" axis: the bucket is padded to a multiple of the axis
    (repeating the last slot; the caller trims the padding rows off the
    gathered samples) and rank r takes the r-th run of ⌈n_slots / n⌉.
    Every rank draws the whole bucket (:func:`_sample_stacked`), so the
    gathered samples are the 1-rank samples bit for bit."""
    n = DF.data_axis_size(mesh, where="synthesize_chunks")
    per = -(-n_slots // n)
    r = mesh.get_local_rank("data")
    return torch.arange(r * per, (r + 1) * per,
                        device=device).clamp_max(n_slots - 1)


def _as_batch(batch, counts):
    """(counts (M, C) int64, batch as (M, C, K, …) tensors)."""
    counts = np.asarray(torch.as_tensor(counts).cpu(), np.float64) \
        .astype(np.int64)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if counts.ndim == 1:
        counts = counts[None]
        batch = {k: v[None] for k, v in batch.items()}
    return counts, batch


def synthesize_chunks(batch: Dict[str, torch.Tensor], counts, cov_type: str,
                      samples_per_class: Optional[int] = None,
                      policy: str = "pow2",
                      plan: Optional[P.SynthesisPlan] = None, mesh=None, *,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[DrawFn] = None
                      ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                                 P.SynthesisPlan]:
    """Algorithm 1, lines 13-16, bucket by bucket; runs where the batch
    lies.

    ``batch``: pi (M, C, K), mu (M, C, K, d), cov (M, C, K, …) — or one
    client's (C, K, …).  ``counts`` (M, C); slots with 0 are never drawn.
    Each power-of-two bucket of the plan (:mod:`repro_torch.fl.planner`)
    is one :func:`_sample_stacked` at the bucket's padded S, compacted by
    one gather: ≤ 2·Σcounts draws under any skew.  ``draws(slot_ids, S)``
    returns a bucket's draws for ``_sample_stacked``.  Returns (chunks,
    plan): compacted (feats (n, d), labels (n,)) pairs in ascending-bucket
    order, never empty (an all-zero cohort gives one (0, d) chunk).
    ``mesh``: each rank transforms its rows of every bucket
    (:func:`_shard_bucket`) and the samples are all-gathered; every rank
    returns the same chunks, those of a run without the mesh.
    """
    counts, batch = _as_batch(batch, counts)
    M, C = counts.shape
    if plan is None:
        plan = P.plan_synthesis(counts, samples_per_class, policy=policy)
    elif (plan.M, plan.C) != (M, C):
        raise ValueError(f"plan was built for a ({plan.M}, {plan.C}) "
                         f"cohort, counts are ({M}, {C})")
    dev = batch["mu"].device
    d = batch["mu"].shape[-1]
    if not plan.buckets:
        return [(torch.zeros((0, d), device=dev),
                 torch.zeros((0,), dtype=torch.long, device=dev))], plan
    flat = {k: v.reshape((M * C,) + tuple(v.shape[2:]))
            for k, v in batch.items()}
    chunks = []
    for b in plan.buckets:
        slots = torch.as_tensor(b.slots, device=dev)
        rows = None if mesh is None else _shard_bucket(mesh, len(b.slots),
                                                       dev)
        samples = _sample_stacked(
            flat["pi"][slots], flat["mu"][slots], flat["cov"][slots], b.S,
            cov_type, generator=generator,
            draws=None if draws is None else draws(b.slots, b.S), rows=rows)
        if mesh is not None:
            samples = DF.all_gather(samples, mesh.get_group("data"),
                                    "samples")[:len(b.slots)]
        keep = np.flatnonzero(np.arange(b.S)[None, :] < b.n_eff[:, None])
        labels = np.repeat((b.slots % C).astype(np.int64), b.S)[keep]
        feats = samples.reshape(len(b.slots) * b.S, d)[
            torch.as_tensor(keep, device=dev)]
        chunks.append((feats, torch.as_tensor(labels, device=dev)))
    return chunks, plan


def _concat(chunks) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.cat([f for f, _ in chunks]),
            torch.cat([y for _, y in chunks]))


def synthesize_batched(batch: Dict[str, torch.Tensor], counts, cov_type: str,
                       samples_per_class: Optional[int] = None,
                       policy: str = "pow2", *,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[DrawFn] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pooled view of :func:`synthesize_chunks` — same plan, same
    draws: (N, d) features and (N,) labels, N = Σ counts (or
    M·C_present·samples_per_class)."""
    chunks, _ = synthesize_chunks(batch, counts, cov_type, samples_per_class,
                                  policy=policy, generator=generator,
                                  draws=draws)
    return _concat(chunks)


def synthesize_group_chunks(items, samples_per_class: Optional[int] = None,
                            policy: str = "pow2", mesh=None, *,
                            generator: Optional[torch.Generator] = None,
                            draws: Optional[Sequence[DrawFn]] = None):
    """Planned synthesis over a possibly heterogeneous cohort.

    ``items``: ``(params, counts, cov_type)`` per client.  Clients with the
    same (cov_type, parameter shapes) stack into one group, one plan each
    (a mixed-K / mixed-family cohort, paper §6.3, gets one plan per
    family), in sorted group order.  ``draws``: one :func:`synthesize_chunks`
    draw function per group.  Returns (chunks, plans).
    """
    groups: Dict[Tuple, List] = {}
    for params, counts, cov_type in items:
        sig = (cov_type,) + tuple(tuple(torch.as_tensor(params[f]).shape)
                                  for f in _GMM_FIELDS)
        groups.setdefault(sig, []).append((params, counts))
    chunks, plans = [], []
    for gi, (sig, members) in enumerate(sorted(groups.items())):
        batch = {f: torch.stack([torch.as_tensor(p[f]) for p, _ in members])
                 for f in _GMM_FIELDS}
        counts = np.stack([np.asarray(torch.as_tensor(c).cpu())
                           for _, c in members])
        ch, plan = synthesize_chunks(
            batch, counts, sig[0], samples_per_class, policy=policy,
            mesh=mesh, generator=generator,
            draws=None if draws is None else draws[gi])
        chunks.extend(ch)
        plans.append(plan)
    return chunks, plans


def synthesize_groups(items, samples_per_class: Optional[int] = None, *,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Sequence[DrawFn]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pooled view of :func:`synthesize_group_chunks`."""
    chunks, _ = synthesize_group_chunks(items, samples_per_class,
                                        generator=generator, draws=draws)
    return _concat(chunks)


def synthesize_looped(batch: Dict, counts, cov_type: str,
                      samples_per_class: Optional[int] = None, *,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[DrawFn] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-(client, class) loop over ``gmm.sample`` — the equivalence
    yardstick of the bucketed path.  ``draws(slot_ids, n)`` as for
    :func:`synthesize_chunks`, called with one slot id at a time."""
    counts, batch = _as_batch(batch, counts)
    M, C = counts.shape
    dev = batch["mu"].device
    feats, labels = [], []
    for m in range(M):
        for c in range(C):
            n = int(counts[m, c])
            if samples_per_class is not None and n > 0:
                n = samples_per_class
            if n <= 0:
                continue
            g = {k: v[m, c] for k, v in batch.items()}
            dr = {} if draws is None else {
                k: v[0] for k, v in draws(np.asarray([m * C + c]), n).items()}
            feats.append(G.sample(g, n, cov_type, generator=generator,
                                  comp=dr.get("comp"), eps=dr.get("eps")))
            labels.append(torch.full((n,), c, dtype=torch.long, device=dev))
    if not feats:
        return (torch.zeros((0, batch["mu"].shape[-1]), device=dev),
                torch.zeros((0,), dtype=torch.long, device=dev))
    return torch.cat(feats), torch.cat(labels)


# ---------------------------------------------------------------------------
# summarizers: what a client puts on the wire
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GMMSummarizer:
    """The paper's summary: one GMM per present class (Algorithm 1,
    lines 5-10), all C fits as one batched EM — diag/spher with one fused
    E-step kernel launch per iteration, full on the Cholesky path."""
    gmm: G.GMMConfig = G.GMMConfig()

    kind = "gmm"

    @property
    def cov_type(self) -> str:
        return self.gmm.cov_type

    def summarize(self, feats, labels, n_classes: int, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None):
        """``draws``: the k-means ``init_idx`` (C, K) and ``jitter``
        (C, K, d) of ``gmm.fit_classwise_gmms_batched``."""
        dr = draws or {}
        gmms, counts, lls = G.fit_classwise_gmms_batched(
            feats[None], labels[None], n_classes, self.gmm,
            generator=generator, init_idx=dr.get("init_idx"),
            jitter=dr.get("jitter"))
        return {k: v[0] for k, v in gmms.items()}, counts[0], lls[0]


@dataclasses.dataclass(frozen=True)
class HeadSummarizer:
    """The one-shot baselines' summary (AVG / Ensemble / FedBE): a locally
    trained linear head instead of GMMs — same message schema, same codec,
    different aggregation.  ``draws``: ``init`` (d, C) and ``idx``
    (n_steps, batch) for ``baselines.local_train``."""
    n_steps: int = 150
    lr: float = 3e-3

    kind = "head"
    cov_type = ""

    def summarize(self, feats, labels, n_classes: int, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None):
        keep = labels >= 0                  # drop label −1 padding rows
        if not bool(keep.all()):
            feats, labels = feats[keep], labels[keep]
        d = int(feats.shape[1])
        head0 = H.init_head(d, n_classes, generator=generator,
                            normal=None if draws is None else draws["init"],
                            device=feats.device)
        head = FB.local_train(head0, feats, labels, n_classes,
                              n_steps=self.n_steps, lr=self.lr,
                              generator=generator,
                              idx=None if draws is None else draws["idx"])
        counts = torch.bincount(labels.long(), minlength=n_classes).float()
        return head, counts, torch.zeros((n_classes,), device=feats.device)


# ---------------------------------------------------------------------------
# topologies
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SessionResult:
    """What a federation round produced.  ``model`` is the global head
    (Star), the last client's head (Chain/Ring), or a list of heads
    (``aggregate="ensemble" | "fedbe"``)."""
    model: Any
    info: Dict
    messages: List[ClientMessage]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def round_generator(seed: int, index: int, device) -> torch.Generator:
    """The draw stream ``index`` of a round seeded ``seed``: 0 is the
    server's, 1 + i client i's.  Its seed is splitmix64 of the round's
    seed mixed with the index, a pure function of both, so each stream
    can be rebuilt alone (a retried client, an offline replay of the
    survivors)."""
    x = np.asarray([seed], np.uint64)
    h = IG._splitmix64(IG._splitmix64(x) ^ np.uint64(index))
    g = torch.Generator(device=device)
    g.manual_seed(int(h[0] >> np.uint64(1)))
    return g


def _fault_stats() -> Dict:
    """The client phase's retry ledger (one per round): what lands in
    ``info["faults"]`` beside the broker's verdict accounting."""
    return {"attempts": 0, "retries": 0, "backoff_s": 0.0, "failed": []}


def _merge_fault_info(info: Dict, acct: Dict,
                      expected: Optional[int] = None) -> None:
    """Fold broker accounting into ``info["faults"]``: coverage against the
    expected cohort and the ``degraded`` flag (any loss — missing,
    quarantined, late or after close — marks the round partial).  Keeps
    the client-phase retry stats already there."""
    if expected is None:
        expected = acct["clients_seen"]
    coverage = acct["admitted"] / expected if expected else 1.0
    degraded = (acct["admitted"] < expected or acct["quarantined"] > 0
                or acct["late"] > 0 or acct["closed"] > 0)
    faults = info.setdefault("faults", {})
    faults.update(degraded=bool(degraded), coverage=float(coverage),
                  expected_clients=int(expected))


@dataclasses.dataclass(frozen=True)
class Star:
    """Clients → server, one shot (Algorithm 1).  Client i draws from
    ``round_generator(seed, 1 + i)``, the server from
    ``round_generator(seed, 0)``."""
    name = "star"

    def run(self, session: "FedSession", client_datasets, *, seed: int,
            device: torch.device) -> SessionResult:
        phase = {"client_fit_s": 0.0, "encode_s": 0.0}
        stats = _fault_stats()
        messages = []
        for i, (f, y) in enumerate(client_datasets):
            msg = session._client_attempt(f, y, i, stats, seed=seed,
                                          device=device, phase=phase)
            if msg is None:
                # no broker in a non-streaming round: nothing can absorb
                # a lost client, so exhausted retries fail the round
                raise RS.TransientClientError(
                    f"client {i} still failing after "
                    f"{session.resilience.max_retries + 1} attempts — "
                    "use FedSession(ingest=...) to degrade instead")
            messages.append(msg)
        with obs.span("fl.server", timed=True) as sp:
            result = session.server_aggregate(
                messages, generator=round_generator(seed, 0, device),
                device=device)
            _sync(device)
        phase["server_s"] = sp.seconds
        result.info["phase_s"] = phase
        if stats["retries"]:
            result.info.setdefault("faults", {}).update(
                attempts=stats["attempts"], retries=stats["retries"],
                backoff_s=stats["backoff_s"])
        return result


@dataclasses.dataclass(frozen=True)
class Chain:
    """Linear topology (§4.2, Fig. 5): client 1 → 2 → … → M.  Each client
    samples synthetic features from the message it received, unions them
    with its own, re-fits, re-encodes and passes on; it also trains its
    own head on the union."""
    laps: int = 1
    name = "chain"

    def run(self, session: "FedSession", client_datasets, *, seed: int,
            device: torch.device) -> SessionResult:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        received = None
        messages, infos = [], []
        for i in list(range(len(client_datasets))) * self.laps:
            f, y = client_datasets[i]
            received, info = session.chain_step(
                f, y, i, received, generator=generator, device=device)
            messages.append(received)
            infos.append(info)
        return SessionResult(
            model=infos[-1]["head"],
            info={"comm_bytes": sum(m.comm_bytes for m in messages),
                  "per_client": infos},
            messages=messages)


@dataclasses.dataclass(frozen=True)
class Ring(Chain):
    """A chain with wraparound: after ``laps`` passes every client, the
    first too, has refit on the accumulated knowledge."""
    laps: int = 2
    name = "ring"


# ---------------------------------------------------------------------------
# FedSession
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FedSession:
    """One federation instance: summarizer × codec × topology (× DP).

    >>> sess = FedSession(n_classes=10,
    ...                   summarizer=GMMSummarizer(G.GMMConfig(5, "diag")))
    >>> result = sess.run(clients)                      # doctest: +SKIP
    >>> result.info["comm_bytes"] == sum(len(m.payload)
    ...                                  for m in result.messages)

    ``run`` is the entry point: on ``cuda`` unless ``device="cpu"``.
    ``client_summarizers`` gives each client its own summarizer (mixed K
    or covariance family, paper §6.3).  ``ingest`` (an
    ``fl.ingest.IngestConfig``) streams a Star round through the broker;
    ``program_cache`` (a ``launch.aot_cache.ProgramCache``) serves the
    fused server from captured round programs; ``resilience`` (an
    ``fl.resilience.ResilienceConfig``) retries transient client failures
    and quarantines malformed messages.  ``mesh`` (a ``DeviceMesh`` with a
    "data" axis) or ``shards=n`` (``launch.mesh.make_sim_mesh(n)``) runs
    the round over ``torch.distributed`` (:meth:`run_sharded`), the
    clients' draws seeded from ``transfer_seed``.
    """
    n_classes: int
    summarizer: Any = GMMSummarizer()
    codec: QuantizedCodec = QuantizedCodec("bfloat16")
    topology: Any = Star()
    head: H.HeadConfig = H.HeadConfig()
    normalize_features: bool = False
    dp: Optional[DP.DPConfig] = None
    samples_per_class: Optional[int] = None
    aggregate: str = "synthesize"  # or "avg" | "ensemble" | "fedbe"
    client_summarizers: Optional[Tuple[Any, ...]] = None
    min_class_count: int = 0
    synthesis: str = "fused"       # one of SYNTHESIS_MODES
    ingest: Optional[IG.IngestConfig] = None
    program_cache: Optional[Any] = None
    resilience: Optional[RS.ResilienceConfig] = None
    mesh: Any = None               # DeviceMesh with a "data" axis, or None
    shards: Optional[int] = None   # make_sim_mesh(shards)
    transfer_seed: int = 0         # per-client seed base of the mesh round

    def summarizer_for(self, i: int):
        if self.client_summarizers is not None:
            return self.client_summarizers[i]
        return self.summarizer

    def _normalize(self, feats: torch.Tensor) -> torch.Tensor:
        if not self.normalize_features:
            return feats
        n = feats.norm(dim=-1, keepdim=True)
        return feats / n.clamp_min(1.0)

    def _inputs(self, feats, labels, device):
        return (self._normalize(torch.as_tensor(feats).to(device).float()),
                torch.as_tensor(labels).to(device).long())

    # -- client side --------------------------------------------------------

    def client_summary(self, feats, labels, i: int = 0, *,
                       generator: torch.Generator, device: torch.device):
        """Client ``i``'s summary, counts and log-likelihoods, privatized
        when the session has a DP config."""
        summ = self.summarizer_for(i)
        feats, labels = self._inputs(feats, labels, device)
        params, counts, lls = summ.summarize(feats, labels, self.n_classes,
                                             generator=generator)
        if self.min_class_count and summ.kind == "gmm":
            counts = torch.where(counts >= self.min_class_count, counts,
                                 torch.zeros_like(counts))
        if self.dp is not None:
            if not (summ.kind == "gmm" and summ.cov_type == "full"
                    and params["mu"].shape[-2] == 1):
                raise ValueError("Theorem 4.1 requires K=1 full-covariance "
                                 "summaries")
            params = DP.privatize_classwise(params, counts, self.dp,
                                            generator=generator)
        return params, counts, lls

    def encode(self, params, counts, lls, i: int = 0) -> ClientMessage:
        summ = self.summarizer_for(i)
        return encode_message(params, counts, lls, kind=summ.kind,
                              cov_type=summ.cov_type,
                              n_classes=self.n_classes, codec=self.codec)

    def client_update(self, feats, labels, i: int = 0, *,
                      generator: torch.Generator, device: torch.device,
                      phase: Optional[Dict] = None) -> ClientMessage:
        """Client ``i``'s summary, encoded: its wire message.  ``phase``,
        when given, accumulates the fit and encode wall times (the
        ``fl.client.fit`` and ``fl.encode`` spans)."""
        timed = phase is not None
        with obs.span("fl.client.fit", timed=timed) as fit:
            params, counts, lls = self.client_summary(
                feats, labels, i, generator=generator, device=device)
            _sync(device)
        with obs.span("fl.encode", timed=timed) as enc:
            msg = self.encode(params, counts, lls, i)
        if timed:
            phase["client_fit_s"] += fit.seconds
            phase["encode_s"] += enc.seconds
        return msg

    def _client_attempt(self, feats, labels, i: int, stats: Dict, *,
                        seed: int, device: torch.device, client_fn=None,
                        advance=None, phase: Optional[Dict] = None):
        """Client ``i``'s message under the session's retry contract.

        Every attempt draws from a fresh ``round_generator(seed, 1 + i)``,
        so a replay sends the message a clean first attempt would have.
        With ``resilience`` set, :class:`~repro_torch.fl.resilience
        .TransientClientError` replays the attempt up to ``max_retries``
        times, backoff accounted on ``advance``.  Returns None when the
        client exhausted its attempts; the caller decides whether that
        drops the client (streaming and chaos rounds) or fails the round
        (Star).  ``client_fn`` (``client_update``'s signature) lets the
        chaos round wrap the client in a fault injector.
        """
        fn = self.client_update if client_fn is None else client_fn

        def attempt():
            return fn(feats, labels, i,
                      generator=round_generator(seed, 1 + i, device),
                      device=device, phase=phase)
        if self.resilience is None:
            stats["attempts"] += 1
            return attempt()
        ok, msg, attempts, backoff = RS.call_with_retry(
            attempt, self.resilience, advance=advance)
        stats["attempts"] += attempts
        stats["retries"] += attempts - 1
        stats["backoff_s"] += backoff
        if not ok:
            stats["failed"].append(i)
            return None
        return msg

    def chain_step(self, feats, labels, i: int,
                   received: Optional[ClientMessage], *,
                   generator: Optional[torch.Generator] = None,
                   device: torch.device,
                   draws: Optional[Dict[str, Any]] = None
                   ) -> Tuple[ClientMessage, Dict]:
        """One client's turn in a Chain/Ring pass: draw from the received
        message, union with the local features, re-fit, encode, and train
        the local head on the union.  ``draws`` replaces the draws:
        ``synthesis`` (a :func:`synthesize_chunks` draw function), ``fit``
        (the summarizer's) and ``head`` (``core.head.train_head``'s)."""
        dr = draws or {}
        if self.dp is not None:
            # Theorem 4.1 accounts for one summary of one client's data; a
            # chain message summarizes a union with other clients' samples
            raise NotImplementedError(
                "DP composition is only supported for the Star topology")
        summ = self.summarizer_for(i)
        if summ.kind != "gmm":
            raise NotImplementedError(
                "Chain/Ring topologies require a GMM summarizer")
        feats, labels = self._inputs(feats, labels, device)
        if received is not None and received.header.kind == "gmm":
            syn_f, syn_y = synthesize_batched(
                received.params, received.counts, received.header.cov_type,
                generator=generator, draws=dr.get("synthesis"))
            if syn_f.shape[0]:
                feats = torch.cat([feats, syn_f.to(device)])
                labels = torch.cat([labels, syn_y.to(device)])
        params, counts, lls = summ.summarize(feats, labels, self.n_classes,
                                             generator=generator,
                                             draws=dr.get("fit"))
        if self.min_class_count:
            counts = torch.where(counts >= self.min_class_count, counts,
                                 torch.zeros_like(counts))
        msg = self.encode(params, counts, lls, i)
        head_params, _ = H.train_head(feats, labels, self.n_classes,
                                      self.head, generator=generator,
                                      draws=dr.get("head"))
        return msg, {"head": head_params, "n_train": int(feats.shape[0])}

    # -- server side --------------------------------------------------------

    def _synthesis_mode(self) -> str:
        if self.synthesis not in SYNTHESIS_MODES:
            raise ValueError(
                f"FedSession: unknown synthesis={self.synthesis!r} — choose "
                f"one of {SYNTHESIS_MODES}")
        return self.synthesis

    def _empty_cohort_result(self, info: Dict, messages, *,
                             generator: torch.Generator,
                             device: torch.device,
                             d: Optional[int] = None) -> SessionResult:
        """Every class filtered out: a cleanly initialized head instead of
        training on a 0-row pool.  ``d`` gives the feature dim to callers
        that hold no message (the streaming round)."""
        if d is None:
            d = messages[0].header.d
        info.update(synthetic_feats=torch.zeros((0, d), device=device),
                    synthetic_labels=torch.zeros((0,), dtype=torch.long,
                                                 device=device),
                    head_losses=torch.zeros((0,), device=device),
                    empty_cohort=True)
        return SessionResult(
            model=H.init_head(d, self.n_classes, generator=generator,
                              device=device),
            info=info, messages=list(messages))

    def server_aggregate(self, messages: Sequence[ClientMessage], *,
                         generator: torch.Generator,
                         device: torch.device, mesh=None) -> SessionResult:
        """The server phase on decoded messages.  ``mesh``: a materializing
        server splits each bucket's transform over the mesh's ranks
        (:func:`synthesize_chunks`); the fused server and head training
        run whole on every rank, the same draws on each."""
        if not messages:
            raise ValueError("server_aggregate needs at least one message")
        info: Dict = {"comm_bytes": sum(m.comm_bytes for m in messages)}
        if messages[0].header.kind != "gmm":
            return self._aggregate_heads(messages, info, generator=generator)
        if self.ingest is not None:
            return self._ingest_aggregate(messages, info,
                                          generator=generator, device=device)
        mode = self._synthesis_mode()
        if self.resilience is not None and self.resilience.validate:
            # the wire-level quarantine (§13): drop malformed or
            # non-finite messages with a record instead of crashing
            d0 = int(messages[0].header.d)
            kept, rejs = RS.partition_valid(messages, self.n_classes)
            if rejs:
                info["quarantined"] = [dataclasses.asdict(r) for r in rejs]
                info["quarantined_bytes"] = sum(r.comm_bytes for r in rejs)
                info["faults"] = {"degraded": True,
                                  "coverage": len(kept) / len(messages)}
                if not kept:
                    return self._empty_cohort_result(
                        info, [], generator=generator, device=device, d=d0)
                messages = kept
        if mode == "fused":
            try:
                sig = FR.signature_of(messages)
            except ValueError:      # no one signature (§6.3)
                mode = "pooled"
                info["synthesis_fallback"] = "heterogeneous cohort"
            else:
                return self._fused_round(messages, sig, info,
                                         generator=generator, device=device)
        info["synthesis"] = mode
        chunks, plans = synthesize_group_chunks(
            [(m.params, m.counts, m.header.cov_type) for m in messages],
            self.samples_per_class, mesh=mesh, generator=generator)
        info["synthesis_plans"] = plans
        if sum(int(f.shape[0]) for f, _ in chunks) == 0:
            return self._empty_cohort_result(
                info, messages, generator=generator, device=device)
        if mode == "streamed":
            with obs.span("fl.server.head", device=device):
                head_params, losses = H.train_head_streaming(
                    chunks, self.n_classes, self.head, generator=generator)
            info.update(synthetic_chunks=chunks, head_losses=losses)
        else:
            feats, labels = _concat(chunks)
            with obs.span("fl.server.head", device=device):
                head_params, losses = H.train_head(
                    feats, labels, self.n_classes, self.head,
                    generator=generator)
            info.update(synthetic_feats=feats, synthetic_labels=labels,
                        head_losses=losses)
        obs.count("fl.server.head_steps", self.head.n_steps)
        return SessionResult(model=head_params, info=info,
                             messages=list(messages))

    # -- the fused server: one round program (DESIGN.md §11) -----------------

    def _run_round(self, sig, args, info: Dict,
                   samples_per_class: Optional[int], *,
                   generator: torch.Generator, device: torch.device):
        """``fl.round.round_program`` for ``sig`` on ``args`` (pi, mu, cov,
        counts, slot_labels), its draws from ``generator``.  Without a
        program cache it runs eagerly on ``device``.  With one, the
        caller has padded ``args`` to ``sig.canonical()`` (leading count-0
        ``gmm.identity_gmm`` rows, never drawn: the head is the unpadded
        program's bit for bit), the cache's entry runs them, and
        ``info["compile"]`` records hit or miss, capture against replay
        time, the capture time spread over the rounds the entry served,
        and the cache's counters."""
        cache = self.program_cache
        # counted here, not in the program: a replay runs no Python
        obs.count("fl.server.head_steps", self.head.n_steps)
        if cache is None:
            args = [None if a is None else torch.as_tensor(a).to(device)
                    for a in args]
            with obs.span("fl.server.head", device=device):
                return FR.round_program(*args, sig=sig, head_cfg=self.head,
                                        samples_per_class=samples_per_class,
                                        generator=generator)
        hits0 = cache.hits
        prog = cache.get(sig, self.head, samples_per_class=samples_per_class,
                         device=device)
        with obs.span("fl.server.head", device=device, timed=True) as sp:
            head_params, losses = prog(*args, generator=generator)
            _sync(device)
        run_us = sp.seconds * 1e6
        info["compile"] = {
            "hit": cache.hits > hits0, "aot": prog.aot,
            "signature": dataclasses.astuple(sig),
            "canonical": dataclasses.astuple(prog.sig),
            "compile_us": prog.compile_us, "run_us": run_us,
            "amortized_us": prog.compile_us / max(prog.uses, 1) + run_us,
            "cache": cache.stats(),
        }
        if prog.eager_reason is not None:
            info["compile"]["eager_reason"] = prog.eager_reason
        return head_params, losses

    def _fused_round(self, messages: Sequence[ClientMessage], sig,
                     info: Dict, *, generator: torch.Generator,
                     device: torch.device) -> SessionResult:
        """The fused server phase of a homogeneous cohort: the wire
        tensors' full M·C slot grid through :meth:`_run_round` (count-0
        slots are never drawn, so the head is the planner's compacted
        slot stack's bit for bit)."""
        stack, counts = FR.wire_stack(messages)
        plan = P.plan_synthesis(counts, self.samples_per_class)
        info.update(synthesis="fused", synthesis_plans=[plan])
        if len(plan.slot_table) == 0:
            return self._empty_cohort_result(info, messages,
                                             generator=generator,
                                             device=device)
        if self.program_cache is not None:
            stack, counts = FR.pad_cohort(stack, counts, sig,
                                          sig.canonical())
        args = [stack["pi"], stack["mu"], stack["cov"],
                torch.from_numpy(counts), None]
        head_params, losses = self._run_round(
            sig, args, info, self.samples_per_class, generator=generator,
            device=device)
        info["head_losses"] = losses
        return SessionResult(model=head_params, info=info,
                             messages=list(messages))

    # -- streaming ingestion (DESIGN.md §9) ---------------------------------

    def _check_ingest_mode(self) -> None:
        if self._synthesis_mode() != "fused":
            raise ValueError(
                "FedSession(ingest=...): streaming ingestion trains the "
                "head straight from the bounded slot reservoir — only "
                "synthesis='fused' never materializes the cohort; drop "
                "ingest= for the 'streamed'/'pooled' paths")

    def _train_from_state(self, state: IG.IngestState, info: Dict,
                          messages, *, generator: torch.Generator,
                          device: torch.device) -> SessionResult:
        """Fused head training on the reservoir's fixed-shape padded
        stack (``layout="slots"`` at M = capacity; ``samples_per_class``
        was applied at fold time): the streaming counterpart of
        :meth:`_fused_round`, its shape the capacity, not M."""
        sig = FR.signature_of_state(state)
        stack = state.padded_stack()
        if self.program_cache is not None:
            stack = FR.pad_slots(*stack, sig, sig.canonical())
        pi, mu, cov, slot_labels, slot_counts = (torch.from_numpy(a)
                                                 for a in stack)
        head_params, losses = self._run_round(
            sig, [pi, mu, cov, slot_counts, slot_labels], info, None,
            generator=generator, device=device)
        info["head_losses"] = losses
        return SessionResult(model=head_params, info=info,
                             messages=list(messages))

    def _broker(self, clock=None) -> IG.IngestBroker:
        return IG.IngestBroker(self.ingest, self.n_classes,
                               samples_per_class=self.samples_per_class,
                               clock=clock)

    def _ingest_aggregate(self, messages: Sequence[ClientMessage],
                          info: Dict, *, generator: torch.Generator,
                          device: torch.device) -> SessionResult:
        """The server phase through the streaming broker: the message list
        stands in for the arrival stream (position is the client id), so
        this path and :meth:`_run_streaming` share one state machine."""
        self._check_ingest_mode()
        broker = self._broker()
        for i, m in enumerate(messages):
            broker.submit(i, m)
        return self._close_broker(broker, info, generator=generator,
                                  device=device, messages=messages,
                                  expected_clients=len(messages))

    def _close_broker(self, broker: IG.IngestBroker, info: Dict, *,
                      generator: torch.Generator, device: torch.device,
                      messages=(), expected_clients: Optional[int] = None
                      ) -> SessionResult:
        state = broker.close()
        info["synthesis"] = "fused"
        acct = broker.accounting()
        info["ingest"] = acct
        info.setdefault("comm_bytes", acct["sent_bytes"])
        _merge_fault_info(info, acct, expected=expected_clients)
        if state is None or len(state.slot_table()) == 0:
            return self._empty_cohort_result(
                info, list(messages), generator=generator, device=device,
                d=broker.header_d)
        return self._train_from_state(state, info, messages,
                                      generator=generator, device=device)

    def aggregate_from_broker(self, broker: IG.IngestBroker, *,
                              seed: int = 0, device=None,
                              info: Optional[Dict] = None,
                              expected_clients: Optional[int] = None
                              ) -> SessionResult:
        """Close an externally owned :class:`~repro_torch.fl.ingest
        .IngestBroker` and train the head from its reservoir.  Entry
        point: runs on ``cuda`` unless ``device="cpu"``.

        The server draws from ``round_generator(seed, 0)``, as in
        ``run(seed=seed)``, so a round fed the same admitted messages
        gives the offline session's head bit for bit.  Partial rounds
        degrade instead of failing: ``info["faults"]`` reports
        ``degraded`` and the coverage against ``expected_clients``
        (default: the distinct client ids the broker saw).
        """
        self._check_ingest_mode()
        dev = resolve_device(device)
        return self._close_broker(
            broker, dict(info or {}), generator=round_generator(seed, 0, dev),
            device=dev, expected_clients=expected_clients)

    def _run_streaming(self, client_datasets, *, seed: int,
                       device: torch.device) -> SessionResult:
        """The Star round with M as a streaming axis: each client's message
        is produced, submitted to the broker and dropped, so the message
        list never exists and peak server memory is the broker's law.
        The draw streams are ``Star.run``'s, so under capacity the head
        is bit-identical to the non-streaming fused round's."""
        self._check_ingest_mode()
        self._check_streamable("FedSession(ingest=...)")
        if not client_datasets:
            raise ValueError("server_aggregate needs at least one message")
        broker = self._broker()
        comm = 0
        stats = _fault_stats()
        for i, (f, y) in enumerate(client_datasets):
            msg = self._client_attempt(f, y, i, stats, seed=seed,
                                       device=device)
            if msg is None:
                continue    # retries exhausted: lost at the source, the
                #   broker's coverage reports the gap
            comm += msg.comm_bytes
            broker.submit(i, msg)
            del msg
        info: Dict = {"comm_bytes": comm}
        if stats["retries"] or stats["failed"]:
            info["faults"] = {"attempts": stats["attempts"],
                              "retries": stats["retries"],
                              "backoff_s": stats["backoff_s"],
                              "failed_clients": stats["failed"]}
        return self._close_broker(
            broker, info, generator=round_generator(seed, 0, device),
            device=device, expected_clients=len(client_datasets))

    def _check_streamable(self, where: str) -> None:
        if not isinstance(self.topology, Star):
            raise NotImplementedError(
                f"{where}: the broker receives one-shot Star messages; "
                f"{self.topology.name!r} rounds are sequential relays with "
                "no cohort to stream")
        if self.summarizer.kind != "gmm" or (
                self.client_summarizers is not None and any(
                    s.kind != "gmm" for s in self.client_summarizers)):
            raise NotImplementedError(
                f"{where}: streaming ingestion folds GMM summaries; "
                "head-summary baselines aggregate via the non-streaming "
                "path (aggregate=...)")

    # -- the chaos round (DESIGN.md §13) ------------------------------------

    def _run_chaos(self, client_datasets, plan, *, seed: int,
                   device: torch.device) -> SessionResult:
        """The streaming Star round under a :class:`~repro_torch.fl.faults
        .FaultPlan`: produce every client's message (transient failures
        retried per the resilience contract), push the cohort through the
        plan's delivery schedule on a fake clock, and close the round on
        whatever the broker admitted.

        The draw streams are :meth:`_run_streaming`'s and a retry replays
        its client's stream, so the partial round's head is bit-identical
        to an offline broker round fed exactly the admitted clients, each
        from its own ``round_generator(seed, 1 + i)``.
        """
        from repro_torch.fl import faults as FJ
        if self.ingest is None:
            raise ValueError(
                "FedSession.run(faults=...): chaos rounds stream through "
                "the broker — set ingest=IngestConfig(...) so losses "
                "degrade coverage instead of failing the round")
        if self.mesh is not None or self.shards is not None:
            raise NotImplementedError(
                "FedSession.run(faults=...): chaos injection wraps the "
                "host wire; the mesh round has no per-message delivery "
                "to perturb")
        self._check_ingest_mode()
        self._check_streamable("FedSession.run(faults=...)")
        M = len(client_datasets)
        if not M:
            raise ValueError("server_aggregate needs at least one message")
        stats = _fault_stats()
        produced: List[Tuple[int, ClientMessage]] = []
        for i, (f, y) in enumerate(client_datasets):
            fate = plan.fate(i)
            fn = None
            if fate.transient_fails:
                fn = FJ.flaky(self.client_update, fate.transient_fails)
            msg = self._client_attempt(f, y, i, stats, seed=seed,
                                       device=device, client_fn=fn)
            if msg is not None:
                produced.append((i, msg))
        deliveries = FJ.schedule(plan, produced)
        fake = {"t": 0.0}
        broker = self._broker(clock=lambda: fake["t"])
        for ev in deliveries:
            fake["t"] = max(fake["t"], ev.t)   # arrivals are monotonic
            broker.submit(ev.client_id, ev.message)
        info: Dict = {"faults": {
            "plan_seed": plan.seed,
            "attempts": stats["attempts"],
            "retries": stats["retries"],
            "backoff_s": stats["backoff_s"],
            "failed_clients": stats["failed"],
            "produced": len(produced),
            "delivered": len(deliveries),
            # the survivors: an offline round fed exactly these clients
            # reproduces this round's head bit for bit
            "admitted_clients": list(broker.admitted_ids),
        }}
        return self._close_broker(
            broker, info, generator=round_generator(seed, 0, device),
            device=device, expected_clients=M)

    def _aggregate_heads(self, messages, info: Dict, *,
                         generator: torch.Generator) -> SessionResult:
        """The one-shot baselines' server: uniform AVG, the ensemble of
        the client heads, or FedBE with 10 posterior samples."""
        heads = [m.params for m in messages]
        if self.aggregate == "avg":
            model: Any = FB.avg_heads(heads)
        elif self.aggregate == "ensemble":
            model = list(heads)
        elif self.aggregate == "fedbe":
            model = FB.fedbe(heads, n_samples=10, generator=generator)
        else:
            raise ValueError(f"FedSession: aggregate={self.aggregate!r} "
                             "cannot combine head messages — choose avg, "
                             "ensemble or fedbe")
        return SessionResult(model=model, info=info, messages=list(messages))

    # -- mesh execution (DESIGN.md §5) --------------------------------------

    def _resolve_mesh(self, device: torch.device):
        if self.mesh is not None:
            n = DF.data_axis_size(self.mesh, where="FedSession")
            if self.shards is not None and self.shards != n:
                raise ValueError(
                    f"FedSession: mesh= is {n}-way on 'data' but shards="
                    f"{self.shards} — they disagree; pass one, or make "
                    "them match")
            return self.mesh
        if self.shards is None:
            raise ValueError(
                "FedSession: sharded execution needs mesh= (a DeviceMesh "
                "with a 'data' axis) or shards=n (builds "
                "launch.mesh.make_sim_mesh(n) over the process group)")
        from repro_torch.launch.mesh import make_sim_mesh
        return make_sim_mesh(self.shards, device=device)

    def _check_sharded_config(self, I: int, n_shards: int) -> None:
        """Every mesh-mode precondition, checked before any device work."""
        DF.validate_cohort(I, n_shards, where="FedSession(sharded)")
        if self.client_summarizers is not None:
            raise NotImplementedError(
                "FedSession(sharded): heterogeneous client_summarizers "
                "can't share the mesh round's one GMMConfig — run the host "
                "Star path for mixed-K/cov cohorts (paper §6.3)")
        if self.summarizer.kind != "gmm":
            raise NotImplementedError(
                "FedSession(sharded): the mesh round fits GMM summaries "
                "(core.distributed.fedpft_transfer); head-summary "
                "baselines run on the host Star path")
        if self.dp is not None:
            raise NotImplementedError(
                "FedSession(sharded): the DP mechanism (Theorem 4.1) is "
                "applied host-side before encoding — run the host Star "
                "path with dp=, or privatize before calling run_sharded")
        if not isinstance(self.topology, Star):
            raise NotImplementedError(
                f"FedSession(sharded): the one-shot all-gather IS the Star "
                f"round; {self.topology.name!r} topologies are host-only")
        if self.codec.dtype != "bfloat16":
            raise ValueError(
                f"FedSession(sharded): the mesh wire is bf16 "
                f"(gmm.pack_wire) but the codec is {self.codec.dtype!r} — "
                "comm accounting would not match the collective. Use "
                "QuantizedCodec('bfloat16') or the host path for fp16/fp32 "
                "wire ablations")

    def run_sharded(self, feats, labels, *, seed: int = 0,
                    device: Optional[str] = None) -> SessionResult:
        """One-shot round as mesh collectives.  Entry point: runs on
        ``cuda`` unless ``device="cpu"``.

        ``feats``: (I, N, d) — I clients, N padded samples; ``labels``:
        (I, N) with −1 padding; every rank passes the whole cohort.
        Client phase: each rank of the "data" axis fits its I / n clients'
        classwise GMMs, each client as one batched EM (client i's draws
        seeded ``transfer_seed + i``) and all-gathers the bf16 wire — that
        collective is the round.  Server phase: the replicated wire
        decodes through the host codec's layout
        (:func:`messages_from_wire`), and :meth:`server_aggregate` runs
        on every rank from ``round_generator(seed, 0)``.  Results do not
        depend on the rank count, bit for bit.  ``info`` adds ``n_shards``,
        ``mesh_axes``, ``mesh_wire_bytes`` (what the wire all-gather
        moved in all) and ``phase_s``.
        """
        from repro_torch.launch.mesh import axes_of
        dev = resolve_device(device)
        I = int(feats.shape[0])
        if self.mesh is None and self.shards is not None:
            # divisibility is checkable before building the mesh
            DF.validate_cohort(I, self.shards, where="FedSession(sharded)")
        mesh = self._resolve_mesh(dev)
        n_shards = DF.data_axis_size(mesh, where="FedSession(sharded)")
        self._check_sharded_config(I, n_shards)
        feats = self._normalize(torch.as_tensor(feats).to(dev).float())
        labels = torch.as_tensor(labels).to(dev)
        g = self.summarizer.gmm
        with obs.span("fl.client.fit", timed=True) as fit:
            wire, counts, lls = DF.fedpft_transfer(mesh, feats, labels,
                                                   self.n_classes, g,
                                                   seed=self.transfer_seed)
            _sync(dev)
        with obs.span("fl.encode", timed=True) as enc:
            counts = counts.cpu().numpy().astype(np.int64)
            if self.min_class_count:
                counts = np.where(counts >= self.min_class_count, counts, 0)
            validate = (self.resilience is not None
                        and self.resilience.validate)
            decoded = messages_from_wire(wire, counts, g.cov_type,
                                         self.n_classes, self.codec,
                                         logliks=lls, validate=validate)
            messages, wire_rejs = decoded if validate else (decoded, [])
        # the server phase runs whole on every rank, the same draws on
        # each, so every rank returns the same head
        generator = round_generator(seed, 0, dev)  # lint: disable=KEY-SHARD
        with obs.span("fl.server", timed=True) as server:
            if not messages:
                # every client quarantined at the mesh wire: the empty cohort
                info: Dict = {
                    "comm_bytes": 0,
                    "quarantined": [dataclasses.asdict(r) for r in wire_rejs],
                    "quarantined_bytes": sum(r.comm_bytes for r in wire_rejs),
                    "faults": {"degraded": True, "coverage": 0.0},
                }
                result = self._empty_cohort_result(
                    info, [], generator=generator, device=dev,
                    d=int(feats.shape[-1]))
            else:
                result = self.server_aggregate(messages, generator=generator,
                                               device=dev, mesh=mesh)
                if wire_rejs:
                    result.info.setdefault("quarantined", []).extend(
                        dataclasses.asdict(r) for r in wire_rejs)
                    result.info["quarantined_bytes"] = (
                        result.info.get("quarantined_bytes", 0)
                        + sum(r.comm_bytes for r in wire_rejs))
                    faults = result.info.setdefault("faults", {})
                    faults["degraded"] = True
                    faults["coverage"] = len(messages) / I
            _sync(dev)
        result.info.update(
            n_shards=n_shards, mesh_axes=tuple(axes_of(mesh)),
            # what the collective itself moved: the whole padded (I, C, …)
            # bf16 wire — absent and min_class_count-filtered classes
            # cross the mesh too, unlike the host codec's payloads
            mesh_wire_bytes=DF.expected_wire_bytes(
                g.cov_type, int(feats.shape[-1]), g.n_components,
                self.n_classes, I),
            phase_s={"client_fit_s": fit.seconds,
                     "encode_s": enc.seconds,
                     "server_s": server.seconds})
        return result

    # -- entry point --------------------------------------------------------

    def run(self, client_datasets: Sequence[Tuple[Any, Any]], *,
            seed: int = 0, device: Optional[str] = None,
            faults=None) -> SessionResult:
        """One round over ``[(feats_i, labels_i)]`` along the session's
        topology, its draws from generators seeded from ``seed`` on the
        session's device (:func:`round_generator`; a Chain relays one).
        With ``ingest`` set the Star round streams through the broker;
        ``faults`` (an ``fl.faults.FaultPlan``) runs it under a fault
        schedule; with ``mesh`` or ``shards`` the clients, stacked, go
        through :meth:`run_sharded`.  A Star round's ``info["phase_s"]``
        holds the host wall time of the client fits, the encoding and the
        server phase."""
        dev = resolve_device(device)
        if faults is not None:
            return self._run_chaos(client_datasets, faults, seed=seed,
                                   device=dev)
        if self.mesh is not None or self.shards is not None:
            shapes = {(tuple(f.shape), tuple(y.shape))
                      for f, y in client_datasets}
            if len(shapes) != 1:
                raise ValueError(
                    f"FedSession(sharded): clients must share one "
                    f"(N, d) / (N,) feats/labels shape to stack into the "
                    f"mesh round, got {sorted(shapes)} — pad to a common N "
                    "with label −1 rows, or run the host path (mesh=None, "
                    "shards=None)")
            feats = torch.stack([torch.as_tensor(f).to(dev)
                                 for f, _ in client_datasets])
            labels = torch.stack([torch.as_tensor(y).to(dev)
                                  for _, y in client_datasets])
            return self.run_sharded(feats, labels, seed=seed, device=dev)
        if self.ingest is not None:
            return self._run_streaming(client_datasets, seed=seed,
                                       device=dev)
        return self.topology.run(self, client_datasets, seed=seed,
                                 device=dev)
