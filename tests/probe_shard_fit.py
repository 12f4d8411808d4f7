"""Which stage of the batched EM makes a stack of some clients' fits
differ from the same clients' rows of a stack of all of them.

This is why ``core.distributed.fedpft_transfer`` fits each client as a
batched EM of its own: had each rank fitted its I / n clients as one
stack, the 1-rank and the n-rank rounds would differ in bits.  Here, on
one device, each stage of ``core.gmm.fit_gmm_batch`` runs on a
shard's rows and on the whole cohort from the same inputs (the cohort's
own k-means draws, initial mixture and responsibilities), and each
result is compared bit for bit with the cohort's rows of that shard:
the k-means start and its batched product, the global covariance, the
fused E-step (with the wrapper's launch plan for the shard's shape, and
pinned to the cohort's), the M-step and its parts (Σ_n resp, the two
batched weighted sums).  Prints one JSON line per (shape, ranks, rank):
each stage's ``equal``, elements differing and largest relative gap.

    PYTHONPATH=src python tests/probe_shard_fit.py [--device cuda]

The shapes: the card test's cohort (C 5, K 3, d 64, 8 clients of 300
rows) over 2 and 4 ranks, and the main path's (C 10, K 10, d 1280, 4
clients of 1000 rows) over 2 and 4.
"""
import argparse
import json
from unittest import mock

import torch

from repro_torch.core import distributed as DF
from repro_torch.core import gmm as G
from repro_torch.kernels import gmm_estep as GE
from repro_torch.kernels import ops

SHAPES = ((5, 3, 64, 8, 300, (2, 4)), (10, 10, 1280, 4, 1000, (2, 4)))


def compared(a, b) -> dict:
    return {"equal": bool(torch.equal(a, b)), "n_diff": int((a != b).sum()),
            "max_rel": float(((a - b).abs() / b.abs().clamp_min(1e-30))
                             .max())}


def cohort(C, K, d, I, N, dev):
    """Features, fit weights and the cohort's k-means draws (client i's
    from ``client_seeds``, as ``fedpft_transfer`` draws them)."""
    g = torch.Generator().manual_seed(0)
    labels = torch.randint(0, C, (I, N), generator=g)
    x = (torch.randn(I, N, d, generator=g)
         + 3.0 * torch.nn.functional.one_hot(labels, d).float()).to(dev)
    onehot = G._one_hot(labels.to(dev).long(), C)
    w = onehot.transpose(1, 2).reshape(I * C, -1).float()
    cfg = G.GMMConfig(K, "diag")
    idx, jit = [], []
    for j, s in enumerate(DF.client_seeds(0, I, 2)):
        gj = torch.Generator(device=dev).manual_seed(int(s))
        a, b = G.kmeans_draws(onehot.transpose(1, 2)[j], cfg, d, gj)
        idx.append(a)
        jit.append(b)
    return x, w, cfg, torch.cat(idx), torch.cat(jit)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    plan = GE.launch_plan.__wrapped__
    for C, K, d, I, N, worlds in SHAPES:
        x, w, cfg, idx, jit = cohort(C, K, d, I, N, dev)
        xsq = x.square()
        mu0 = G._kmeans_init(x, w, cfg, idx, jit)
        cov0 = G._global_cov(x, w, cfg)
        pi0 = torch.full((I * C, K), 1.0 / K, device=dev)
        lr, norm = ops.gmm_estep_fused(x, mu0, cov0, pi0)
        resp = torch.exp(lr - norm[..., None]) * w[..., None]
        m = G._m_step(x, xsq, resp, cfg)
        cross = torch.bmm(x, mu0.reshape(I, C * K, d).transpose(1, 2))
        for n in worlds:
            Il = I // n
            for r in range(n):
                o = slice(r * Il, (r + 1) * Il)
                f = slice(r * Il * C, (r + 1) * Il * C)
                xs, rs = x[o], resp[f]
                shard_lr = ops.gmm_estep_fused(xs, mu0[f], cov0[f], pi0[f])
                with mock.patch.object(GE, "launch_plan",
                                       lambda *a: plan(I, I * C, *a[2:])):
                    pinned_lr = ops.gmm_estep_fused(xs, mu0[f], cov0[f],
                                                    pi0[f])
                stages = {
                    "kmeans_init": (G._kmeans_init(xs, w[f], cfg, idx[f],
                                                   jit[f]), mu0[f]),
                    "kmeans_product": (torch.bmm(xs, mu0[f].reshape(
                        Il, C * K, d).transpose(1, 2)), cross[o]),
                    "global_cov": (G._global_cov(xs, w[f], cfg), cov0[f]),
                    "estep_lr": (shard_lr[0], lr[f]),
                    "estep_norm": (shard_lr[1], norm[f]),
                    "estep_lr_plan_pinned": (pinned_lr[0], lr[f]),
                    "mstep_mu": (G._m_step(xs, xsq[o], rs, cfg)["mu"],
                                 m["mu"][f]),
                    "resp_sum": (rs.sum(1), resp.sum(1)[f]),
                    "wsum_x": (G._wsum_rows(rs, xs),
                               G._wsum_rows(resp, x)[f]),
                    "wsum_xsq": (G._wsum_rows(rs, xsq[o]),
                                 G._wsum_rows(resp, xsq)[f])}
                print(json.dumps({
                    "device": (torch.cuda.get_device_name(0)
                               if dev.type == "cuda" else "cpu"),
                    "shape": {"C": C, "K": K, "d": d, "I": I, "N": N},
                    "ranks": n, "rank": r,
                    "plans": {"shard": str(plan(Il, Il * C, N, K, d)),
                              "cohort": str(plan(I, I * C, N, K, d))},
                    **{k: compared(*v) for k, v in stages.items()}}),
                    flush=True)


if __name__ == "__main__":
    main()
