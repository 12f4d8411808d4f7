"""GMM E-step on the card: wrapper of ``csrc/gmm_estep.cu``.

Port of ``repro/kernels/gmm_estep.py`` (Pallas ``estep_fused`` / ``estep``).
One CUDA source serves both entry points: ``estep_fused`` returns the
(B, N, K) log-numerators and their (B, N) row logsumexp, ``estep`` the
numerators of one fit.  One launch function runs a prep kernel for the
per-component terms ``inv = 1/var``, ``μ·inv`` and ``c_k = log π_k −
½(d·log2π + Σlog σ² + Σμ²/σ²)`` (the reference's ``_estep_call`` does them
in XLA ops) and the kernel for the two products over d and the logsumexp;
:func:`launch_plan` picks the kernel's tiles per shape (see the note at the
top of the ``.cu`` file for its design and bound).

These wrappers take CUDA tensors only; ``ops`` sends CPU tensors to the
plain versions in ``ref``.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

_SOURCE = "gmm_estep.cu"
_MAX_GRID_Y = 65535

LAUNCHES: Dict[str, int] = {"estep_fused": 0, "estep": 0}

# the kernel's tiles (csrc/gmm_estep.cu): each thread sums ROWS_PER_THREAD
# rows against one fit's K_TILE components over one of SPLITS slices of d,
# 4 consecutive d of every chunk of 4 × SPLITS; a block has at most
# MAX_THREADS threads, in whole warps
MAX_THREADS = 256
ROWS_PER_THREAD = 4
K_TILES = (2, 4, 8, 10, 12)
SPLITS = (8, 16, 32)
STAGES = 4
MAX_SMEM = 100 * 1024        # two blocks an SM
# ranking of the candidate plans only: the H100's SMs, and the rate at
# which one block stages x and the parameters there (about 11 GB/s,
# whatever the number of blocks: ``kernels/compare.py --sweep-estep``)
_SMS = 132
_BLOCK_BYTES_S = 11e9


class Plan(NamedTuple):
    """One launch of the kernel: K_TILE components, SPLITS slices of d,
    ``fits`` fits and ``slots`` row slots a block (``threads`` = fits ×
    slots × splits), so ``rows`` = ROWS_PER_THREAD × slots rows a block."""
    k_tile: int
    splits: int
    fits: int
    slots: int

    @property
    def rows(self) -> int:
        return ROWS_PER_THREAD * self.slots

    @property
    def threads(self) -> int:
        return self.fits * self.slots * self.splits

    def grid(self, Bx: int, B: int, N: int) -> Tuple[int, int]:
        r = B // Bx
        return -(-N // self.rows), Bx * -(-r // self.fits)

    def cells(self, Bx: int, B: int, N: int, K: int):
        """Every (b, n, k) log-numerator the kernel writes under this plan,
        block by block and thread by thread, in the index arithmetic of
        ``estep_kernel`` (``csrc/gmm_estep.cu``); the row logsumexp of
        (b, n) is written by the same thread."""
        r = B // Bx
        gx, gy = self.grid(Bx, B, N)
        nfg = -(-r // self.fits)
        for by in range(gy):
            bx, f0 = by // nfg, (by % nfg) * self.fits
            for blk in range(gx):
                for t in range(self.threads):
                    ds, grp = t % self.splits, t // self.splits
                    j, slot = grp % self.fits, grp // self.fits
                    n = blk * self.rows + slot + self.slots * ds
                    if ds >= ROWS_PER_THREAD or f0 + j >= r or n >= N:
                        continue
                    for k0 in range(0, K, self.k_tile):
                        for k in range(k0, min(K, k0 + self.k_tile)):
                            yield bx * r + f0 + j, n, k

    def smem_bytes(self) -> int:
        rows = self.rows + 2 * self.fits * self.k_tile
        return 4 * STAGES * rows * (4 * self.splits + 4) + 8 * rows


@functools.lru_cache(maxsize=256)
def launch_plan(Bx: int, B: int, N: int, K: int, d: int) -> Plan:
    """The tiles for one shape: among the plans that fit in 100 KB of
    shared memory, the one whose busiest SM, running ceil(blocks / SMs)
    blocks one after the other, stages the fewest bytes; each block stages
    its rows of x and its fits' parameters once per component tile.  Ties
    go to the plan with more threads a block."""
    r = B // Bx
    k_tile = next((t for t in K_TILES if t >= K), K_TILES[-1])
    n_kt = -(-K // k_tile)
    best = None
    for splits, fits, slots in itertools.product(
            SPLITS, (1, 2, 4, 8, 16), range(1, 17)):
        plan = Plan(k_tile, splits, fits, slots)
        if plan.threads % 32 or plan.threads > MAX_THREADS \
                or (fits > 1 and fits // 2 >= r) \
                or plan.smem_bytes() > MAX_SMEM:
            continue
        gx, gy = plan.grid(Bx, B, N)
        chunks = -(-d // (4 * splits))
        staged = 4.0 * n_kt * chunks * 4 * splits \
            * (plan.rows + 2 * fits * k_tile)              # a block's bytes
        key = (-(-gx * gy // _SMS) * staged / _BLOCK_BYTES_S, -plan.threads)
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1]


_FN = None


def _launch_fn():
    """``estep_launch`` of the built library, its argument types set once,
    and the current stream's handle by device index.  The E-step runs once
    per EM iteration on small shapes, so the host's work per call counts:
    ``torch.cuda.current_stream(dev).cuda_stream`` builds a stream object
    each call, ``torch._C._cuda_getCurrentRawStream`` returns the handle."""
    global _FN
    if _FN is None:
        fn = _build.load(_SOURCE).estep_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn, torch._C._cuda_getCurrentRawStream
    return _FN


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() \
        else t.float().contiguous()


def _prep(x, mu, var, pi):
    """Batched f32: x (Bx, N, d) and mu (B, K, d) contiguous; var (B, K, d)
    or spher (B, K); pi (B, K)."""
    batched = mu.dim() == 3
    if not batched:
        mu, var, pi = mu[None], var[None], pi[None]
    if x.dim() == 2:
        x = x[None]
    return batched, _f32(x), _f32(mu), _f32(var), _f32(pi)


def _launch(x, mu, var, pi, *, fused: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One call of the launch function: the prep kernel, then the kernel;
    the per-component terms live in one scratch tensor."""
    dev = x.get_device()
    if dev < 0 or any(t.get_device() != dev for t in (mu, var, pi)):
        raise ValueError(f"gmm_estep: x, mu, var, pi must be CUDA tensors "
                         f"on one device, got {x.device}, {mu.device}, "
                         f"{var.device}, {pi.device}")
    Bx, N, d = x.shape
    B, K = mu.shape[0], mu.shape[1]
    spher = var.dim() == 2
    if mu.shape[2] != d or var.shape != (mu.shape[:2] if spher else mu.shape) \
            or pi.shape != (B, K):
        raise ValueError(f"gmm_estep: shapes x {tuple(x.shape)}, mu "
                         f"{tuple(mu.shape)}, var {tuple(var.shape)}, pi "
                         f"{tuple(pi.shape)} do not agree")
    if Bx == 0 or B % Bx:
        raise ValueError(f"gmm_estep: batch {B} must be a multiple of the "
                         f"{Bx} shared feature blocks")
    if min(N, K, d) < 1:
        raise ValueError(f"gmm_estep: need N, K, d ≥ 1, got N={N} K={K} "
                         f"d={d}")
    plan = launch_plan(Bx, B, N, K, d)
    if plan.grid(Bx, B, N)[1] > _MAX_GRID_Y:
        raise ValueError(f"gmm_estep: {B} fits need more than "
                         f"{_MAX_GRID_Y} blocks along y")
    # inv and muinv (B, K, d), then c (B, K)
    scratch = torch.empty(B * K * (2 * d + 1), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((B, N, K), dtype=torch.float32, device=x.device)
    lse = torch.empty((B, N), dtype=torch.float32, device=x.device) \
        if fused else None
    inv = scratch.data_ptr()
    muinv = inv + 4 * B * K * d
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0
    fn, stream = _launch_fn()
    status = fn(
        x.data_ptr(), mu.data_ptr(), var.data_ptr(), 1 if spher else d,
        0 if spher else 1, pi.data_ptr(), inv, muinv, muinv + 4 * B * K * d,
        out.data_ptr(), lse.data_ptr() if fused else None,
        Bx, B, N, K, d, *plan, int(vec), stream(dev))
    _build.check(status, "estep_launch")
    _build.count(LAUNCHES, "estep_fused" if fused else "estep")
    return out, lse


def estep(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
          pi: torch.Tensor) -> torch.Tensor:
    """log[π_k N(x_n | μ_k, diag Σ_k)]: (N, d) × (K, d) → (N, K).

    ``var`` is diag (K, d) or spher (K,).  Matches ``ref.estep_ref``.
    """
    if mu.dim() != 2:
        raise ValueError(f"estep is single-fit (got mu {tuple(mu.shape)}); "
                         "use estep_fused")
    _, xb, mub, varb, pib = _prep(x, mu, var, pi)
    out, _ = _launch(xb, mub, varb, pib, fused=False)
    return out[0]


def estep_fused(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                pi: torch.Tensor):
    """Fused batched E-step: (log-numerators, row logsumexp).

    x: (Bx, N, d) or (N, d); mu: (B, K, d) or (K, d) with B % Bx == 0 —
    each run of B // Bx consecutive fits shares one feature block.  var:
    diag (…, K, d) or spher (…, K).  Returns ((B, N, K), (B, N)), or
    ((N, K), (N,)) for unbatched inputs.  Matches ``ref.estep_fused_ref``.
    """
    batched, xb, mub, varb, pib = _prep(x, mu, var, pi)
    out, lse = _launch(xb, mub, varb, pib, fused=True)
    if not batched:
        return out[0], lse[0]
    return out, lse
