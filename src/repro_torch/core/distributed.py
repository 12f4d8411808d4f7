"""Distributed FedPFT round over ``torch.distributed`` (port of
``repro/core/distributed.py``; DESIGN.md §5).

Each rank of the mesh's "data" axis owns I / n consecutive clients and
fits each client's classwise GMMs as one batched EM of its C fits (one
fused E-step launch per client and EM iteration on the card; a stack of
several clients would change the arithmetic's order with the rank
count), packs the bf16 wire (``gmm.pack_wire``) and all-gathers it: that
collective IS the one-shot round, so its operand bytes are exactly Eqs.
9-11 for the rank's clients.  Every rank returns the replicated (I, C,
K, …) wire, bit for bit the same for any rank count; the server side
then runs on it.

Each client's k-means draws come from a ``torch.Generator`` seeded by
``seed`` + its global id (:func:`client_seeds`), so the result does not
depend on the rank count.  The reference keys ``PRNGKey(seed + j)`` the
same way; threefry and Philox differ, so the parity tests pass the
reference's draws (``init_idx`` / ``jitter``) instead.

The bytes each collective hands over are tallied per rank, by kind, as
the reference's HloCost reads them (operand bytes): inside
:func:`record_collectives` every gather adds its operand's bytes to the
yielded tally, under its kind and under the tag of what it carried
(``wire``, ``counts``, ``logliks``, ``features``, ``labels``, …).
``launch.hlo_cost.count`` reads the same tally.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import gmm as G
from repro_torch.launch.mesh import axes_of

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# While ``record_collectives`` is active, the tally each collective adds
# its operand bytes to: {kind: bytes} and {"by_tag": {tag: bytes}}.
_TALLIES: List[Dict] = []


@contextlib.contextmanager
def record_collectives():
    """Tally the operand bytes of every collective inside the block: yields
    the tally, {kind: bytes} over ``COLLECTIVES`` and {"by_tag": {tag:
    bytes}}."""
    tally = {**{k: 0 for k in COLLECTIVES}, "by_tag": {}}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _note(kind: str, tag: str, t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    for tally in _TALLIES:
        tally[kind] += nbytes
        tally["by_tag"][tag] = tally["by_tag"].get(tag, 0) + nbytes


def all_gather(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0, in rank order.  Every
    dtype crosses as its bytes (gloo takes no 16-bit integers), so the
    gather is exact on every backend."""
    _note("all-gather", tag, t)
    n = dist.get_world_size(group)
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    return torch.cat(parts).view(t.dtype).reshape(
        (n * t.shape[0],) + tuple(t.shape[1:]))


def validate_cohort(I: int, n_shards: int, *, where: str = "fedpft_transfer"
                    ) -> None:
    """Reject cohorts that do not shard evenly before any collective."""
    if n_shards < 1:
        raise ValueError(f"{where}: mesh 'data' axis must have >= 1 shard, "
                         f"got {n_shards}")
    if I % n_shards != 0:
        valid = [n for n in range(1, I + 1) if I % n == 0]
        raise ValueError(
            f"{where}: cohort of I={I} clients does not shard evenly over "
            f"the {n_shards}-way 'data' mesh axis (I % n_shards == "
            f"{I % n_shards}). Each shard must own the same number of "
            f"clients — pad the cohort with empty clients to a multiple of "
            f"{n_shards}, or use a shard count that divides {I} "
            f"(one of {valid}).")


def data_axis_size(mesh, *, where: str = "fedpft_transfer") -> int:
    """The mesh's client-sharding degree, with an actionable error when
    the mesh has no "data" axis (shared by ``fl.api.FedSession``)."""
    axes = axes_of(mesh)
    if "data" not in axes:
        raise ValueError(
            f"{where}: mesh has axes {tuple(axes)} but "
            "the one-shot transfer shards clients over a 'data' axis — "
            "build the mesh with launch.mesh.make_sim_mesh(n) (simulated "
            "lane) or make_host_mesh()")
    return axes["data"]


def client_seeds(shard: int, I_local: int, seed: int) -> np.ndarray:
    """Globally unique per-client seeds of one shard: shard i owns clients
    [i·I_local, (i+1)·I_local), seeds ``seed`` + global id (uint32, as
    the reference's)."""
    return (np.arange(I_local, dtype=np.uint32)
            + np.uint32(shard) * np.uint32(I_local) + np.uint32(seed))


def fedpft_transfer(mesh, feats: torch.Tensor, labels: torch.Tensor,
                    n_classes: int, cfg: G.GMMConfig, seed: int = 0, *,
                    init_idx: Optional[torch.Tensor] = None,
                    jitter: Optional[torch.Tensor] = None):
    """One-shot FedPFT round over a client-sharded cohort.

    feats: (I, N, d) — every rank passes the whole cohort and fits its
    own clients; labels: (I, N) with −1 padding.  ``init_idx`` (I, C, K)
    and ``jitter`` (I, C, K, d) replace the k-means draws (the parity
    tests pass the reference's).  Returns (wire dict stacked (I, C, K, …)
    bf16, counts (I, C) int32, logliks (I, C) f32), the same on every
    rank.  The wire is ``gmm.pack_wire``'s layout, which
    ``fl.api.messages_from_wire`` accounts byte for byte.
    """
    I = feats.shape[0]
    n = data_axis_size(mesh)
    validate_cohort(I, n)
    if labels.shape[0] != I:
        raise ValueError(
            f"fedpft_transfer: feats carries I={I} clients but labels "
            f"carries {labels.shape[0]} — both lead with the client axis")
    group = mesh.get_group("data")
    shard = mesh.get_local_rank("data")
    I_local = I // n
    own = slice(shard * I_local, (shard + 1) * I_local)
    f = feats[own].float()
    y = labels[own].to(f.device).long()
    C, K, d = n_classes, cfg.n_components, f.shape[-1]
    if init_idx is None or jitter is None:
        # each client's draws from its own generator: rank-count invariant
        weights = G._one_hot(y, C).transpose(1, 2)            # (I_l,C,N)
        idx, jit = [], []
        for j, s in enumerate(client_seeds(shard, I_local, seed)):
            g = torch.Generator(device=f.device).manual_seed(int(s))
            i_j, j_j = G.kmeans_draws(weights[j], cfg, d, g)
            idx.append(i_j)
            jit.append(j_j)
        init_idx, jitter = torch.cat(idx), torch.cat(jit)
    else:
        init_idx = init_idx[own].reshape(I_local * C, K)
        jitter = jitter[own].reshape(I_local * C, K, d)
    # one batched EM per client (its C fits): a client's fit is then the
    # same computation whatever the rank count.  A stack of several
    # clients' fits is not: its size changes the E-step's launch plan,
    # cuBLAS's batched products and the reductions' order
    # (tests/probe_shard_fit.py), so 1 and n ranks would differ in bits
    fits = [G.fit_classwise_gmms_batched(
        f[j:j + 1], y[j:j + 1], C, cfg,
        init_idx=init_idx[j * C:(j + 1) * C],
        jitter=jitter[j * C:(j + 1) * C]) for j in range(I_local)]
    gmms = {k: torch.cat([g[k] for g, _, _ in fits]) for k in fits[0][0]}
    counts = torch.cat([c for _, c, _ in fits])
    lls = torch.cat([ll for _, _, ll in fits])
    packed = G.pack_wire(gmms, cfg.cov_type)
    # ---- the one-shot transfer: GMM parameters cross the mesh ----
    wire = {k: all_gather(v, group, "wire") for k, v in packed.items()}
    counts = all_gather(counts.to(torch.int32), group, "counts")
    lls = all_gather(lls.float(), group, "logliks")
    return wire, counts, lls


def raw_feature_transfer(mesh, feats: torch.Tensor, labels: torch.Tensor):
    """Centralized baseline: every client's raw features cross the mesh,
    bf16 (the paper's 16-bit encoding), labels int32."""
    I = feats.shape[0]
    n = data_axis_size(mesh, where="raw_feature_transfer")
    validate_cohort(I, n, where="raw_feature_transfer")
    group = mesh.get_group("data")
    shard = mesh.get_local_rank("data")
    own = slice(shard * (I // n), (shard + 1) * (I // n))
    return (all_gather(feats[own].to(torch.bfloat16), group, "features"),
            all_gather(labels[own].to(torch.int32), group, "labels"))


def expected_wire_bytes(cov_type: str, d: int, K: int, C: int,
                        n_clients: int) -> int:
    """What Eqs. 9-11 predict the wire all-gather moves for n_clients."""
    return G.comm_bytes(cov_type, d, K, C, 2) * n_clients
