"""Seed sweep of ``test_torch_backbones.py``'s reference-bar round, under
the port's two Star draw streams.

``per-client``: the server and every client draw from a generator of its
own (``fl.api.round_generator(seed, index)``), as the port does now.
``shared``: one generator seeded with the round's seed, which every client
and then the server draw from in turn, as the port did before the
per-client streams; it is rebuilt here by handing every index of a round
the same generator.

Prints one JSON line per (backbone, stream): each seed's FedPFT accuracy,
their mean, min and max, the centralized accuracy and the bar
(centralized − 0.08).  On the CPU, about a minute:

    PYTHONPATH=src:tests python tests/sweep_backbone_bar.py [--seeds 12]
"""
import argparse
import json
from unittest import mock

import torch

from repro_torch.fl import api as A
from test_torch_backbones import REDUCED, backbone_rounds


def _shared_stream():
    """A ``round_generator`` stand-in that gives every index of a round
    one generator seeded with the round's seed."""
    made = {}

    def round_generator(seed, index, device):
        key = (seed, str(device))
        if key not in made:
            made.clear()                 # a new round: a fresh stream
            g = torch.Generator(device=device)
            g.manual_seed(seed)
            made[key] = g
        return made[key]
    return round_generator


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=12)
    args = ap.parse_args()
    for name in sorted(REDUCED):
        for stream in ("per-client", "shared"):
            if stream == "shared":
                with mock.patch.object(A, "round_generator",
                                       _shared_stream()):
                    accs, acc_c, _ = backbone_rounds(name, range(args.seeds))
            else:
                accs, acc_c, _ = backbone_rounds(name, range(args.seeds))
            print(json.dumps({
                "backbone": name, "stream": stream, "accs": accs,
                "mean": sum(accs) / len(accs), "min": min(accs),
                "max": max(accs), "mean_seeds_0_3": sum(accs[:4]) / 4,
                "centralized": acc_c, "bar": acc_c - 0.08}), flush=True)


if __name__ == "__main__":
    main()
