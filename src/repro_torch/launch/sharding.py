"""Pattern-based FSDP × TP sharding rules for every architecture family
(port of ``repro/launch/sharding.py``).

Scheme (DESIGN.md §5):
  * "data" axis  — FSDP: parameters sharded on their *input-feature* dim;
                   batch dim of activations/caches.
  * "model" axis — TP: output-feature / head / vocab dims.
  * "pod" axis   — pure data parallelism across pods: parameters replicated,
                   batch sharded, gradients all-reduced over ("pod","data").

Every rule degrades gracefully: a dim that does not divide its mesh axis
is left unsharded.  A spec is a tuple with one entry per tensor dim: an
axis name, a tuple of axis names, or None (replicated); ``()`` replicates
the whole leaf.  The rules read any mesh through ``launch.mesh.axes_of``
(a shape-only mesh, a ``DeviceMesh``, or an object with ``axis_names``
and ``shape``).  :func:`named` turns specs into DTensor placements on a
real ``DeviceMesh``.  Parameter paths are the reference's (``blocks/…``),
so the rules match the same leaves.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import torch

from repro_torch.launch.mesh import axes_of, mesh_size
from repro_torch.models.config import ModelConfig

Spec = Tuple[Any, ...]

# (regex over '/'-joined param path) -> spec for the NON-layer dims,
# i.e. excluding the leading stack axis when present.
# "D" = FSDP/data, "M" = TP/model, None = replicate.
_RULES = [
    (r"embed$",                  ("M", "D")),   # (V, d): vocab-parallel
    (r"lm_head$",                ("D", "M")),
    (r"frame_proj$|img_proj$",   ("D", "M")),
    (r"mask_emb$",               (None,)),
    # attention
    (r"w[qkv]$",                 ("D", "M")),
    (r"wo$",                     ("M", "D")),
    # dense mlp
    (r"w_in$|w_gate$",           ("D", "M")),
    (r"w_out$",                  ("M", "D")),
    # moe (experts replicated across axis; d→FSDP, ff→TP inside each
    # expert); the router is tiny (d×E) and stays replicated
    (r"router$",                 (None, None)),
    (r"we_in$|we_gate$",         (None, "D", "M")),
    (r"we_out$",                 (None, "M", "D")),
    # rwkv
    (r"wr$|wk$|wv$|wg$",         ("D", "M")),
    (r"wc_in$",                  ("D", "M")),
    (r"wc_out$",                 ("M", "D")),
    (r"wA1$",                    ("D", None)),
    (r"wA2$",                    (None, "D")),
    (r"u$",                      (None, None)),
    # mamba2
    (r"conv_w$",                 (None, "M")),
    (r"conv_b$",                 ("M",)),
    (r"A_log$|dt_bias$|D$",      (None,)),
    # norms / scalars / mixes — replicated
    (r"ln\d?$|final_norm$|gn$|mix_.*$|w0$",  None),
]


def _axis_ok(dim: int, axes: Dict[str, int], name: str) -> bool:
    return name in axes and dim % axes[name] == 0


def _leaf_spec(path: str, shape: Tuple[int, ...], axes: Dict[str, int],
               has_layer_axis: bool) -> Spec:
    for pat, spec in _RULES:
        if re.search(pat, path):
            if spec is None:
                return ()
            dims = list(shape[1:] if has_layer_axis else shape)
            if len(spec) != len(dims):      # rank mismatch → replicate
                return ()
            out = []
            for dim, s in zip(dims, spec):
                ax = {"D": "data", "M": "model"}.get(s)
                out.append(ax if ax and _axis_ok(dim, axes, ax) else None)
            if has_layer_axis:
                out = [None] + out
            return tuple(out)
    return ()                                # unknown leaf → replicate


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over nested dicts, '/'-joined paths."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(cfg: ModelConfig, params_shape: Any, mesh) -> Any:
    """Spec tree matching a params (or ``meta`` shape) tree.  Stacked block
    params (leading n_layers axis) are found by the path prefix
    'blocks/'; zamba2's shared block has no layer axis."""
    axes = axes_of(mesh)
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), axes,
                                      path.startswith("blocks/")),
        params_shape)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------


def _batch_dim_spec(B: int, axes: Dict[str, int]):
    names = tuple(a for a in ("pod", "data") if a in axes)
    total = 1
    for a in names:
        total *= axes[a]
    if B % total == 0:
        return names if len(names) > 1 else names[0]
    if "data" in axes and B % axes["data"] == 0:
        return "data"
    return None


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, or a ``(shape, dtype)`` spec's."""
    return tuple(leaf[0] if isinstance(leaf, tuple) else leaf.shape)


def batch_specs(batch_shape: Any, mesh) -> Any:
    """Shard dim 0 (global batch) over ("pod", "data"); rest replicated.
    Leaves are tensors or ``input_specs.batch_specs_for``'s pairs."""
    axes = axes_of(mesh)

    def spec_of(_, leaf):
        shape = _shape(leaf)
        return (_batch_dim_spec(shape[0], axes),) + (None,) * (len(shape)
                                                               - 1)
    return _map_with_path(spec_of, batch_shape)


def cache_specs(cache_shape: Any, mesh) -> Any:
    """Decode-state sharding: batch dim → data; best trailing dim → model.

    Layout conventions (models/model.py): KV k/v (L, B, S, Hkv, Dh);
    mamba conv (L, B, Kw-1, C) and S (L, B, H, N, P); rwkv sx (L, B, d)
    and S (L, B, H, Dh, Dh).  Dim 1 is always batch; dim 0 the layer
    stack.
    """
    axes = axes_of(mesh)

    def spec_of(_, leaf):
        dims = list(leaf.shape)
        spec: list = [None] * len(dims)
        if len(dims) >= 2:
            spec[1] = _batch_dim_spec(dims[1], axes)
        # the LAST dim (searching backwards, skipping dims 0/1) that
        # divides the model axis — heads for KV, channels for conv, etc.
        if "model" in axes:
            m = axes["model"]
            for i in range(len(dims) - 1, 1, -1):
                if dims[i] % m == 0 and dims[i] >= m:
                    spec[i] = "model"
                    break
        return tuple(spec)
    return _map_with_path(spec_of, cache_shape)


def activation_constraint(mesh):
    """The activation hook ``fn(x, kind)``: the identity on one rank (the
    port runs the model on one card)."""
    if mesh_size(mesh) != 1:
        raise ValueError(
            f"activation_constraint: the port runs the model on one card, "
            f"not on a {axes_of(mesh)} mesh")

    def fn(x, kind):
        return x
    return fn


def opt_specs(param_spec_tree: Any, opt_state_shape: Any) -> Any:
    """Optimizer moments mirror their parameter's spec; scalars (the step
    count) replicate."""
    def spec_of(path, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0 \
                or "count" in path:
            return ()
        # strip the leading 'm/..' or 'v/..' to find the param path
        node = param_spec_tree
        for p in path.split("/")[1:]:
            if not isinstance(node, dict) or p not in node:
                return ()
            node = node[p]
        return node if isinstance(node, tuple) else ()
    return _map_with_path(spec_of, opt_state_shape)


def named(tree_of_specs: Any, mesh) -> Any:
    """DTensor placements per leaf on a ``DeviceMesh``: for each mesh dim,
    ``Shard(i)`` where the spec puts that axis on tensor dim i, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(axes_of(mesh))

    def placements(_, spec):
        out = []
        for name in names:
            dims = [i for i, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)
    return _map_with_path(placements, tree_of_specs)
