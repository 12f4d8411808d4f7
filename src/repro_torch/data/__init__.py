"""Synthetic class-structured datasets and FL partitioners, in numpy, and
the synthetic token stream of backbone training.

A copy of the numpy parts of ``repro/data/__init__.py``: the same seeds give
bit-identical datasets and client splits, the §5.3 shift splits
(``disjoint_label_split``, ``covariate_shift_pair``, ``task_shift_pair``)
included.  ``make_dataset`` returns numpy
arrays; callers move them to a device.  ``token_lm_batches`` takes the
reference's ``jax.random`` draws as tensors (or draws its own from a
``torch.Generator``).  See DESIGN.md §6 for why synthetic
class-Gaussian data stands in for the paper's image datasets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    n_classes: int = 10
    n_per_class: int = 200
    input_dim: int = 64
    class_sep: float = 3.0      # distance scale between class centers
    noise: float = 1.0          # within-class stddev
    n_domains: int = 1          # covariate-shift domain count
    domain_shift: float = 2.0   # per-domain offset scale
    seed: int = 0


def make_dataset(cfg: DatasetConfig, domain: int = 0, split: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-Gaussian dataset: x = center_c + domain_offset + noise.

    ``split`` varies the sample noise only (0 = train, 1 = test, …) while
    keeping the class geometry fixed.  Returns (x f32 (n, input_dim),
    labels int32 (n,)).
    """
    rng = np.random.RandomState(cfg.seed)
    centers = rng.randn(cfg.n_classes, cfg.input_dim) * cfg.class_sep
    offsets = rng.randn(max(cfg.n_domains, 1), cfg.input_dim) \
        * cfg.domain_shift
    mixes = np.stack([
        np.eye(cfg.input_dim)
        + 0.1 * cfg.domain_shift * rng.randn(cfg.input_dim, cfg.input_dim)
        for _ in range(max(cfg.n_domains, 1))
    ])
    rng_d = np.random.RandomState(cfg.seed * 9973 + domain * 101 + split + 1)
    labels = np.repeat(np.arange(cfg.n_classes), cfg.n_per_class)
    x = centers[labels] + cfg.noise * rng_d.randn(len(labels), cfg.input_dim)
    if cfg.n_domains > 1:   # domain transform only in covariate-shift mode
        x = x @ mixes[domain].T + offsets[domain]
    perm = rng_d.permutation(len(labels))
    return x[perm].astype(np.float32), labels[perm].astype(np.int32)


def dirichlet_partition(labels, n_clients: int, beta: float = 0.1,
                        seed: int = 0) -> List[np.ndarray]:
    """Paper §5.2: per-class Dirichlet(β) allocation over clients."""
    labels = np.asarray(labels)
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    client_idx = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([beta] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].extend(part.tolist())
    return [np.asarray(sorted(ix), np.int64) for ix in client_idx]


def iid_shards(n: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def disjoint_label_split(labels) -> Tuple[np.ndarray, np.ndarray]:
    """§5.3 label shift: source gets classes [0, C/2), destination the rest."""
    labels = np.asarray(labels)
    C = int(labels.max()) + 1
    src = np.where(labels < C // 2)[0]
    dst = np.where(labels >= C // 2)[0]
    return src, dst


def covariate_shift_pair(cfg: DatasetConfig):
    """§5.3 covariate shift: same classes, two maximally distinct domains."""
    if cfg.n_domains < 2:
        raise ValueError(f"covariate_shift_pair: n_domains={cfg.n_domains} "
                         "— a covariate shift needs two domains")
    return make_dataset(cfg, domain=0), make_dataset(cfg, domain=1)


def task_shift_pair(cfg_a: DatasetConfig, cfg_b: DatasetConfig,
                    ) -> Tuple[Tuple, Tuple, int]:
    """§5.3 task shift: two disjoint datasets; labels of B are offset so the
    union is one C_a + C_b-way problem (Birds→Cars style)."""
    xa, ya = make_dataset(cfg_a)
    xb, yb = make_dataset(dataclasses.replace(cfg_b, seed=cfg_b.seed + 7919))
    yb = yb + cfg_a.n_classes
    return (xa, ya), (xb, yb), cfg_a.n_classes + cfg_b.n_classes


# ---------------------------------------------------------------------------
# synthetic token streams (backbone training / train_step inputs)
# ---------------------------------------------------------------------------


def token_lm_batches(vocab_size: int, batch: int, seq_len: int,
                     n_batches: int, *,
                     generator: Optional[torch.Generator] = None,
                     gumbel: Optional[Sequence] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> List[Dict[str, torch.Tensor]]:
    """Zipf-ish synthetic LM stream with next-token labels: ``n_batches``
    of {"tokens", "labels"}, each (batch, seq_len) int32.

    The reference draws each batch's (batch, seq_len + 1) ids with
    ``jax.random.categorical`` over logits −1.2·log1p(id), that is
    argmax(Gumbel + logits) over the vocabulary.  Here the Gumbel draws
    are tensors: ``gumbel``, one (batch, seq_len + 1, vocab_size) f32
    array per batch (fed the reference's draws, this gives its tokens), or
    drawn from ``generator`` on the device as −log(−log U), U uniform on
    [tiny, 1) (``jax.random.gumbel``'s law).  On ``cuda`` unless
    ``device="cpu"``.
    """
    dev = resolve_device(device)
    logits = -1.2 * torch.log1p(torch.arange(vocab_size, dtype=torch.float32,
                                             device=dev))
    shape = (batch, seq_len + 1, vocab_size)
    tiny = torch.finfo(torch.float32).tiny
    out = []
    for i in range(n_batches):
        if gumbel is not None:
            g = torch.as_tensor(gumbel[i], device=dev)
        else:
            u = torch.rand(shape, generator=generator, device=dev)
            g = -torch.log(-torch.log(u.clamp_min_(tiny)))
        toks = torch.argmax(g + logits, dim=-1).to(torch.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out
