"""End-to-end training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --layers 4 --d-model 512 --steps 300 --batch 8 --seq 256

Trains a reduced-config backbone (``ModelConfig.reduced``) on the
synthetic LM stream (``data.token_lm_batches``, 10 batches cycled) with
Adam under the cosine schedule (20 warmup steps), and saves
``{"params", "step"}`` to ``--ckpt`` when given.  The reference's flags
and defaults, plus ``--device`` (``cuda``; ``cpu`` for the tests).  It
prints the host mesh, ("data", "model") = (ranks, 1) as a shape-only
``launch.mesh.ShapeMesh`` (the ranks of a process group when one exists,
else 1: it starts none), with how many parameter leaves
``launch.sharding.param_specs`` shards on it.
The seed draws the weights from one ``torch.Generator`` and the data's
Gumbel noise from another (``--seed`` and ``--seed`` + 1).  ``main``
returns the last step's loss, ``run`` that and the trained parameters.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import checkpoint, data, optim, resolve_device, train
from repro_torch.configs import get_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import ShapeMesh, axes_of
from repro_torch.models import model as M


def run(argv=None) -> Tuple[float, Dict[str, Any]]:
    """The training loop: (the last step's loss, the trained parameters)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(n_layers=args.layers,
                                        d_model=args.d_model)
    g_init = torch.Generator(device=dev).manual_seed(args.seed)
    g_data = torch.Generator(device=dev).manual_seed(args.seed + 1)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = ShapeMesh(("data", "model"), (world, 1))
    params = M.init_params(cfg, g_init, device=dev)
    n_params = sum(p.numel() for p in optim.tree_leaves(params))
    specs = optim.tree_leaves(S.param_specs(cfg, params, mesh))
    n_sharded = sum(any(a is not None for a in s) for s in specs)
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, device={dev}, "
          f"mesh={axes_of(mesh)}, {n_sharded}/{len(specs)} leaves sharded")

    sched = optim.cosine_schedule(args.lr, args.steps, warmup_steps=20)
    opt = optim.adam(sched)
    opt_state = opt.init(params)
    step_fn = train.make_train_step(cfg, opt, microbatch=args.microbatch)
    batches = data.token_lm_batches(cfg.vocab_size, args.batch, args.seq, 10,
                                    generator=g_data, device=dev)
    t0 = time.time()
    for i in range(args.steps):
        batch = batches[i % len(batches)]
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"[train] step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, {"params": params, "step": args.steps})
        print(f"[train] saved {args.ckpt}")
    return float(metrics["loss"]), params


def main(argv=None) -> float:
    return run(argv)[0]


if __name__ == "__main__":
    main()
