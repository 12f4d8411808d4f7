"""Launch-side pieces of the port: the static input specs of the round
program (``input_specs``) and the cache that captures it once per
canonical cohort signature as a CUDA graph (``aot_cache``), and the
training launcher (``python -m repro_torch.launch.train``).  The mesh,
dry-run and roofline modules of the reference wait for ROADMAP item 9."""
from repro_torch.launch import aot_cache, input_specs

__all__ = ["aot_cache", "input_specs"]
