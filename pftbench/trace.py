"""What the traced run reads from torch.profiler's trace of the window: each
device operation's time by name, the union of their intervals (the device's
busy time), and the longest idle gaps with what the host was doing then."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

# the profiler's kernel names of each kernel wrapper
KERNEL_NAMES = {
    "flash_attention": ("flash_mma_kernel", "flash_simt_kernel"),
    "ssd": ("ssd_mma_kernel", "ssd_kernel<"),
    "estep_fused": ("estep_prep", "estep_kernel"),
}


def _merge(iv: np.ndarray) -> np.ndarray:
    """Sorted (n, 2) intervals merged where they overlap."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = np.maximum.reduceat(iv[:, 1], idx)
    return np.stack([starts, stops], axis=1)


def read(prof, n_gaps: int = 10) -> Dict:
    """{busy_s, device_ops [(name, s)] by time, kernel_s {name: s},
    idle_gaps [(label, s)]} of a finished profile, from its raw events
    (building the profiler's event tree costs about 90 us an event)."""
    from torch.autograd import DeviceType

    dev: List[Tuple[int, int]] = []
    by_name: Dict[str, float] = defaultdict(float)
    cpu: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        name, t0, t1 = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            # the harness's spans also appear on the device's timeline, as
            # annotations over the kernels they cover, not operations
            if not (e.is_user_annotation() or name.startswith("pftbench.")):
                dev.append((t0, t1))
                by_name[name] += (t1 - t0) * 1e-9
        elif e.device_type() == DeviceType.CPU:
            cpu.append((t0, t1, name))
    iv = _merge(np.asarray(dev, np.float64).reshape(-1, 2))
    busy = float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9 if len(iv) else 0.0
    gaps = []
    if len(iv) > 1:
        lo, hi = iv[:-1, 1], iv[1:, 0]
        longest = np.argsort(lo - hi)[:n_gaps]
        cs = np.asarray([c[0] for c in cpu], np.float64)
        ce = np.asarray([c[1] for c in cpu], np.float64)
        for g in longest:
            mid = 0.5 * (lo[g] + hi[g])
            cover = np.flatnonzero((cs <= mid) & (ce >= mid))
            spans = [i for i in cover if cpu[i][2].startswith("pftbench.")]
            ops = [i for i in cover if not cpu[i][2].startswith("pftbench.")]
            parts = []
            if spans:      # the outermost of the harness's spans
                parts.append(cpu[min(spans, key=lambda i: cs[i])][2])
            if ops:        # the innermost operation of the host
                parts.append(cpu[min(ops, key=lambda i: ce[i] - cs[i])][2])
            gaps.append(("/".join(parts) or "host",
                         float(hi[g] - lo[g]) * 1e-9))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy, "device_ops": ops[:10], "kernel_s": dict(by_name),
            "idle_gaps": gaps}


def kernel_seconds(kernel_s: Dict[str, float], kernel: str) -> float:
    """Device seconds of every profiler kernel that implements ``kernel``."""
    subs = KERNEL_NAMES[kernel]
    return sum(v for k, v in kernel_s.items() if any(s in k for s in subs))
