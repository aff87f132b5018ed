"""Checkpointing, ported from ``repro.checkpoint.io``: flat-key npz files of
the port's parameter trees (dicts and lists of tensors).

A leaf's key is its path joined by ``"##"``, named as JAX's
``tree_flatten_with_path`` names it (dict keys, list indices:
``blocks##0##attn##wq``), beside ``__step__`` and ``__meta__`` (JSON), so a
checkpoint of either package loads in the other. A bfloat16 leaf is stored
as raw 2-byte records (numpy's ``|V2``: what ``np.savez`` writes for JAX's
bfloat16 arrays, whose ml_dtypes descriptor it cannot keep) through an int16
view, and an ``|V2`` record is read back as bfloat16 bits; no ml_dtypes is
needed. (The JAX ``load_checkpoint`` cannot read its own bfloat16 leaves
back with ``like=``: numpy has no cast from ``|V2``.)
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "##"


def _flatten(tree, prefix=()) -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {_SEP.join(prefix): tree}
    flat: Dict[str, torch.Tensor] = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (str(k),)))
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def save_checkpoint(path: str, params, step: int = 0, metadata: Optional[Dict] = None):
    """Write ``params`` (its leaves brought to the host) to ``path`` (npz;
    ``.npz`` is appended where missing), with the step and the metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(params).items()}
    np.savez(path, __step__=step, __meta__=json.dumps(metadata or {}), **flat)


def load_checkpoint(path: str, like=None) -> Tuple[Any, int, Dict]:
    """Returns (tree, step, metadata). With ``like`` (a tree of the same
    structure) each leaf is restored into its structure, on its device and
    in its dtype; without it, the flat {key: tensor} dict on the CPU."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as data:
        step = int(data["__step__"])
        meta = json.loads(str(data["__meta__"]))
        flat = {k: _to_tensor(data[k]) for k in data.files if not k.startswith("__")}
    if like is None:
        return flat, step, meta

    def restore(node, prefix=()):
        if isinstance(node, dict):
            return {k: restore(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [restore(v, prefix + (str(i),)) for i, v in enumerate(node)]
        return flat[_SEP.join(prefix)].to(device=node.device, dtype=node.dtype)

    return restore(like), step, meta
