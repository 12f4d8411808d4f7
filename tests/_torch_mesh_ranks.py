"""One rank of the port's mesh lane (``tests/test_torch_mesh_lane.py``).

Imports no JAX: each rank is a fresh process started by
``torch.multiprocessing`` with the ``spawn`` method.  It joins a gloo
group of each world size in turn through a file store (rank r takes part
in the worlds larger than r), and writes what it computed in world w to
``<tmp>/w<w>/rank<r>.pt``; the parent compares the world sizes with each
other and with the JAX reference.  ``run_nccl`` is one rank of an NCCL
group on its own card (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import dataclasses
import os
import sys

import torch
import torch.distributed as dist


def run(rank: int, worlds, tmp: str, inputs: str) -> None:
    """Rank ``rank`` of each world size in ``worlds`` that has it."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    torch.set_num_threads(1)
    inp = torch.load(inputs)
    for world in worlds:
        if rank >= world:
            continue
        if world > 1:
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
                world_size=world)
        res = _world(world, inp)
        torch.save(res, os.path.join(tmp, f"w{world}", f"rank{rank}.pt"))
        if world > 1:
            dist.barrier()
            dist.destroy_process_group()


def _world(world: int, inp) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as DF
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import sharding as S
    from repro_torch.models import model as M

    feats, labels, C, K = inp["feats"], inp["labels"], inp["C"], inp["K"]
    mesh = LM.make_sim_mesh(world, device="cpu")
    res = {}

    # the wire, with the reference's draws and with the port's own
    for cov in ("diag", "spher"):
        cfg = G.GMMConfig(n_components=K, cov_type=cov, n_iter=5)
        with DF.record_collectives() as tally:
            wire, counts, lls = DF.fedpft_transfer(
                mesh, feats, labels, C, cfg, seed=0,
                init_idx=inp["init_idx"], jitter=inp["jitter"])
        res[f"wire_ref_draws/{cov}"] = (wire, counts, lls, tally["by_tag"])
        res[f"wire_own_draws/{cov}"] = DF.fedpft_transfer(
            mesh, feats, labels, C, cfg, seed=0)

    # the session: streamed synthesis (buckets split over the ranks) and
    # the fused head (run whole on every rank)
    gcfg = G.GMMConfig(n_components=K, cov_type="diag", n_iter=5)
    hcfg = H.HeadConfig(n_steps=120, lr=3e-3)
    for mode in ("streamed", "fused"):
        sess = A.FedSession(n_classes=C, summarizer=A.GMMSummarizer(gcfg),
                            head=hcfg, shards=world, synthesis=mode)
        r = sess.run_sharded(feats, labels, device="cpu")
        pool = None
        if mode == "streamed":
            pool = (torch.cat([f for f, _ in r.info["synthetic_chunks"]]),
                    torch.cat([y for _, y in r.info["synthetic_chunks"]]))
        res[f"session/{mode}"] = {
            "model": r.model, "pool": pool,
            "params": [m.params for m in r.messages],
            "counts": [m.counts for m in r.messages],
            "comm_bytes": r.info["comm_bytes"],
            "payload": sum(len(m.payload) for m in r.messages),
            "n_shards": r.info["n_shards"],
            "mesh_wire_bytes": r.info["mesh_wire_bytes"]}

    # synthesis on one fixed wire: with the mesh, each rank transforms its
    # rows of every bucket; the gathered chunks must be those of the run
    # without it, bit for bit
    syn = inp["synthesis"]
    res["synthesis"] = [A.synthesize_chunks(
        syn["batch"], syn["counts"], "diag", mesh=m,
        generator=torch.Generator().manual_seed(11))[0]
        for m in (mesh, None)]

    # identical data on every client: globally disjoint seeds must still
    # give each client its own fit
    same_f = feats[:1].expand_as(feats).contiguous()
    same_y = labels[:1].expand_as(labels).contiguous()
    wire, _, _ = DF.fedpft_transfer(mesh, same_f, same_y, C, gcfg, seed=5)
    res["same_data_mu"] = wire["mu"]

    # an uneven cohort raises before any collective
    if world > 1:
        try:
            DF.fedpft_transfer(mesh, feats[:world + 1], labels[:world + 1],
                               C, gcfg)
            res["uneven"] = "no error"
        except ValueError as e:
            res["uneven"] = str(e)

    # DTensor placements from the sharding rules on a (world, 1) mesh
    if world == 2:
        from torch.distributed.tensor import distribute_tensor
        host = LM.make_host_mesh(device="cpu")
        cfg = dataclasses.replace(get_config("granite-3-2b").reduced(
            n_layers=2, d_model=64), vocab_size=96)
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        specs = S.param_specs(cfg, params, host)
        placed = S.named(specs, host)
        shapes = {}
        for k, v in params.items():
            leaves = v.items() if isinstance(v, dict) else [(None, v)]
            for kk, t in leaves:
                name = k if kk is None else f"{k}/{kk}"
                p = placed[k] if kk is None else placed[k][kk]
                sp = specs[k] if kk is None else specs[k][kk]
                local = distribute_tensor(t, host, p).to_local()
                shapes[name] = (tuple(t.shape), sp, tuple(local.shape))
        res["dtensor"] = shapes
    return res


def sharded_round(inp, shards: int, device) -> dict:
    """``FedSession.run_sharded`` on ``shards`` ranks of the current
    process group: the head and each client's decoded wire."""
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A

    sess = A.FedSession(
        n_classes=inp["C"], summarizer=A.GMMSummarizer(
            G.GMMConfig(inp["K"], "diag")),
        head=H.HeadConfig(n_steps=100), shards=shards, transfer_seed=2)
    res = sess.run_sharded(inp["feats"], inp["labels"], seed=5,
                           device=device)
    return {"head": {p: res.model[p].cpu() for p in ("w", "b")},
            "wire": [{f: m.params[f].cpu() for f in G.WIRE_FIELDS}
                     for m in res.messages]}


def run_nccl(rank: int, world: int, tmp: str, inputs: str) -> None:
    """Rank ``rank`` of a ``world``-rank NCCL group, one card a rank,
    joined through a file store: writes its ``sharded_round`` to
    ``<tmp>/nccl_rank<rank>.pt``."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp}/nccl_store", rank=rank,
        world_size=world)
    try:
        res = sharded_round(torch.load(inputs), world, "cuda")
        torch.save(res, os.path.join(tmp, f"nccl_rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
