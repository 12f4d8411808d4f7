"""Traffic of the benchmark, generated from ``--seed`` and a mix file.

One general generator per kind of mix; a mix file (``mixes/<traffic>.json``)
holds only parameters.  Kind ``round``: the data of one-shot FedPFT rounds, a
pool of datasets each split iid over the clients; a round of the window takes
the pool's datasets in turn.

The class-Gaussian data and its framing are frozen copies of the program's
``data.make_dataset`` / ``iid_shards`` (numpy, so one seed gives the same
arrays anywhere) and of the chip smoke's ``frames_of`` / ``tokens_of``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from pftbench.reference.gmm import splitmix64

# make_dataset seeds numpy with seed * 9973 + ...: keep that under 2^32
_DATA_SEEDS = 400_000


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from the run's seed and a path of indices."""
    x = np.asarray([seed & 0xFFFFFFFFFFFFFFFF], np.uint64)
    for i in path:
        x = splitmix64(splitmix64(x) ^ np.uint64(i))
    return int(x[0] >> np.uint64(1))


def make_dataset(n_classes: int, n_per_class: int, input_dim: int,
                 class_sep: float, seed: int, split: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """x = center_c + N(0, 1) noise, one domain: (x float32 (n, input_dim),
    labels int32 (n,)), rows shuffled.  ``split`` varies the noise only."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_classes, input_dim) * class_sep
    rng.randn(1, input_dim)                          # the domain offsets
    rng.randn(input_dim, input_dim)                  # the domain mix
    rng_d = np.random.RandomState(seed * 9973 + split + 1)
    labels = np.repeat(np.arange(n_classes), n_per_class)
    x = centers[labels] + rng_d.randn(len(labels), input_dim)
    perm = rng_d.permutation(len(labels))
    return x[perm].astype(np.float32), labels[perm].astype(np.int32)


def iid_shards(n: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def frames_of(x: torch.Tensor, n_frames: int, frame_dim: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Each input vector cut into n_frames frames, zero-padded to frame_dim,
    where ``x`` lies."""
    n, d_in = x.shape
    per = d_in // n_frames
    out = torch.zeros((n, n_frames, frame_dim), dtype=dtype, device=x.device)
    out[..., :per] = x[:, :per * n_frames].reshape(n, n_frames, per)
    return out


def tokens_of(x: torch.Tensor, n_bins: int = 4) -> torch.Tensor:
    """Each value one token id: uniform bins of [-6, 6] into ids 1 ... n_bins,
    clipped at the ends, where ``x`` lies."""
    ids = torch.floor((x.float() + 6.0) / 12.0 * n_bins).long()
    return 1 + ids.clamp(0, n_bins - 1)


def model_inputs(x: torch.Tensor, mix: Dict, model: Dict) -> torch.Tensor:
    """A round mix's raw vectors as the backbone's input: frames in the
    model's type, or token ids."""
    inp = mix["input"]
    if inp["kind"] == "frames":
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            model["dtype"]]
        return frames_of(x, inp["n_frames"], model["frame_embed_dim"], dt)
    if inp["kind"] == "tokens":
        return tokens_of(x, inp["n_bins"])
    raise ValueError(f"unknown input kind {inp['kind']!r}")


def round_inputs(mix: Dict, seed: int, index: int) -> Dict:
    """Dataset ``index`` of a round mix: the raw vectors ``x`` (n, input_dim)
    float32, ``labels`` (n,) and the clients' row index arrays.  The class
    geometry is the run's; each index draws new noise."""
    n = mix["n_clients"] * mix["rows_per_client"]
    C = mix["n_classes"]
    geometry = sub_seed(seed, 0) % _DATA_SEEDS
    x, y = make_dataset(C, -(-n // C), mix["input_dim"], mix["class_sep"],
                        geometry, split=index)
    shards = iid_shards(n, mix["n_clients"], seed=sub_seed(seed, 1, index)
                        % (1 << 32))
    return {"x": x[:n], "labels": y[:n].astype(np.int64), "clients": shards}


def open_loop(mix: Dict, seed: int, seconds: float) -> Dict[str, np.ndarray]:
    """An open loop of ``round(rate * seconds)`` requests of a service mix.

    Every seed gets the same set of sizes and arrivals in another order:
    the gaps are the exponential law's quantiles at the mix's rate (a
    Poisson stream's), the prompt lengths the uniform law's over
    [len_min, len_max], and exactly ``infer_share`` of the requests
    inference, each set permuted by the seed.  ``due`` (s from the window's
    start), ``kind`` (0 extraction, 1 inference), ``length``, ``client``
    (extraction requests in due order, ``rows_per_client`` a client; -1 for
    inference) and ``row`` (the request's row of ``service_inputs``)."""
    n = max(1, int(round(mix["rate"] * seconds)))
    rng = np.random.RandomState(sub_seed(seed, 7) % (1 << 32))
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / mix["rate"])
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    lo, hi = mix["len_min"], mix["len_max"]
    length = rng.permutation(lo + np.floor(q * (hi - lo + 1)).astype(np.int64))
    n_inf = int(round(n * mix["infer_share"]))
    kind = rng.permutation(np.r_[np.ones(n_inf, np.int64),
                                 np.zeros(n - n_inf, np.int64)])
    client = np.full(n, -1, np.int64)
    ext = np.flatnonzero(kind == 0)
    client[ext] = np.arange(len(ext)) // mix["rows_per_client"]
    return {"due": due, "kind": kind, "length": length, "client": client,
            "row": np.arange(n)}


def service_inputs(mix: Dict, seed: int, n: int, split: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(token ids (n, input_dim) int64, labels (n,)) of a service mix: the
    class-Gaussian rows of the run's geometry, each value binned to an id."""
    C = mix["n_classes"]
    x, y = make_dataset(C, -(-n // C), mix["input_dim"], mix["class_sep"],
                        sub_seed(seed, 0) % _DATA_SEEDS, split=split)
    tokens = tokens_of(torch.from_numpy(x[:n]), mix["n_bins"]).numpy()
    return tokens, y[:n].astype(np.int64)
