"""Hand-written CUDA kernels for the hot spots, with plain PyTorch versions.

  gmm_estep        diag/spher GMM E-step (+ row logsumexp), f32
  flash_attention  online-softmax attention: causal, window, prefix, GQA
  attention_cached attention over a KV cache with per-row positions
                   (decode and ring-buffer chunks; no TPU counterpart)
  wkv6             RWKV6 recurrence with per-channel decay (rwkv6-3b)
  ssd              Mamba2 SSD recurrence with scalar decay (zamba2-7b)

``ops`` dispatches by tensor device; ``ref`` holds the plain versions that
define what each kernel computes.  Kernels build at first use (``_build``).
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
