"""Checkpoints: trees of tensors ⇄ ``.npz`` (port of
``repro/checkpoint/__init__.py``), in the reference's file layout.

Keys are '/'-joined paths through nested dicts (lists and tuples by
index); bf16 is stored as its ``uint16`` bits under a ``#bf16`` suffix
(npz has no bfloat16), a None leaf as an empty int8 array under ``#none``,
and every other dtype as itself.  So a file written by either package
loads in the other with every array bitwise equal.  The bf16 bits pass
through ``torch`` views, not ``ml_dtypes``.  ``load`` returns CPU tensors
(lists come back as dicts keyed "0", "1", …); ``restore_like`` casts and
reshapes them into a template's structure, dtypes and devices.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix.rstrip("/") + "#none"] = np.zeros((0,), np.int8)
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _to_numpy(v) -> np.ndarray:
    """A leaf as numpy, bf16 as its uint16 bits (the caller tags it)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(v)


def save(path: str, tree: Any) -> None:
    arrays = {}
    for k, v in _flatten(tree).items():
        a = _to_numpy(v)
        is_bf16 = isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
        arrays[k + "#bf16" if is_bf16 else k] = a
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def _from_numpy(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load(path: str) -> Dict:
    """The nested-dict tree of CPU tensors (lists load back as dicts keyed
    by index)."""
    tree: Dict = {}
    with np.load(path) as z:
        for k in z.files:
            v = z[k]
            if k.endswith("#none"):
                k, v = k[:-5], None
            elif k.endswith("#bf16"):
                k, v = k[:-5], _from_numpy(v, True)
            else:
                v = _from_numpy(v, False)
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


def restore_like(template: Any, loaded: Dict) -> Any:
    """``loaded`` in the exact structure of ``template``: each tensor leaf
    cast to the template's dtype and shape, on its device; a non-tensor
    leaf (a step count) as the loaded 0-d value's Python scalar."""
    flat_l = _flatten(loaded)

    def leaf(key: str, tv):
        if tv is None:
            return None
        assert key in flat_l, f"missing key {key}"
        lv = flat_l[key]
        if isinstance(tv, torch.Tensor):
            return lv.to(device=tv.device, dtype=tv.dtype).reshape(tv.shape)
        return lv.item() if isinstance(lv, torch.Tensor) else lv

    def walk(t, prefix: str):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{prefix}{i}/") for i, v in enumerate(t))
        return leaf(prefix.rstrip("/"), t)
    return walk(template, "")
