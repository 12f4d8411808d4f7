"""Seed sweep of ``test_torch_cuda.py``'s card-against-CPU prefill and
decode check, on a card.

``test_prefill_and_decode_on_card_match_the_cpu_path`` holds the logits
of a ragged prefill and two decode steps (four rows, bf16) through the
kernels on the card against the plain CPU path at rtol = atol = 5e-2.
Here, for each seed s, the weights and the tokens come from generators
seeded s, and two card paths are held against the CPU's:

``kernels``: the wrappers launch the kernels, as in the test;
``plain_on_card``: the wrappers of ``kernels.ops`` swapped, in this script
alone, for their plain versions (``kernels.ref``) on the card, so the two
sides differ only in where the bf16 products round.

Prints one JSON line per (seed, path): the largest |card − CPU|, its
share of the test's bound 5e-2 + 5e-2·|CPU| (over 1 fails the test), the
(step, row, logit) where that share peaks and the CPU's |logit| there;
then a summary line per path with the spread over the seeds.  zamba2-7b
reduced to 5 layers by default, as the test runs it:

    PYTHONPATH=src:tests python tests/sweep_decode_logits.py \\
        [--model zamba2-7b] [--layers 5] [--seeds 10]
"""
import argparse
import json
from unittest import mock

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from test_torch_cuda import prefill_and_decode

TOL = 5e-2
PLAIN = {"attention": ref.attention_ref,
         "attention_cached": ref.attention_positions_ref,
         "wkv6": ref.wkv6_ref, "ssd": ref.ssd_ref}


def held(card, cpu) -> dict:
    err = (card - cpu).abs()
    share = err / (TOL + TOL * cpu.abs())
    at = int(share.argmax())
    idx = [int(i) for i in torch.unravel_index(torch.tensor(at),
                                               share.shape)]
    return {"max_abs_err": float(err.max()),
            "share_of_bound": float(share.max()),
            "at_step_row_logit": idx,
            "cpu_abs_there": float(cpu.abs().flatten()[at]),
            "max_abs_cpu": float(cpu.abs().max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_decode_logits: needs a CUDA card")
    cfg = get_config(args.model).reduced(n_layers=args.layers)
    dev = torch.device("cuda")
    rows = {"kernels": [], "plain_on_card": []}
    for seed in range(args.seeds):
        g = torch.Generator(device=dev).manual_seed(seed)
        params = M.init_params(cfg, g, device=dev)
        tokens = torch.randint(1, cfg.vocab_size, (4, 40), generator=g,
                               device=dev)
        (card, counts), (cpu, _) = prefill_and_decode(cfg, params, tokens)
        with mock.patch.multiple(ops, **PLAIN):
            ((plain, _),) = prefill_and_decode(cfg, params, tokens,
                                               where=("card",))
        for path, got in (("kernels", card), ("plain_on_card", plain)):
            row = {"seed": seed, "model": cfg.name, "n_layers": cfg.n_layers,
                   "path": path, **held(got, cpu)}
            rows[path].append(row)
            print(json.dumps(row), flush=True)
    for path, rs in rows.items():
        errs = [r["max_abs_err"] for r in rs]
        shares = [r["share_of_bound"] for r in rs]
        print(json.dumps({
            "summary": path, "model": cfg.name, "n_layers": cfg.n_layers,
            "seeds": len(rs), "max_abs_err_min": min(errs),
            "max_abs_err_max": max(errs),
            "max_abs_err_mean": sum(errs) / len(errs),
            "share_of_bound_max": max(shares),
            "seeds_over_the_bound": sum(s > 1 for s in shares),
            "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
