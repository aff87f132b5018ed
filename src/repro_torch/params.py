"""Weight bridge: the JAX ``init_params`` tree, as numpy, to torch tensors.

``repro.models.init_params`` returns a nested dict (lists for the stacked
layer groups) of arrays. A caller converts its leaves to numpy and hands the
tree here; the port's parameters keep the same nesting and key names
(``embed.table``, ``blocks[0].attn.wq``/``bq``/…, ``mlp.w_gate``/``w_up``/
``w_down``, ``norm1``/``norm2.scale``, ``final_norm``, ``lm_head.w``) and the
same per-layer-group stacking: ``blocks`` a list of one tree per position
in the period, each leaf with a leading axis of num_layers / period.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``."""
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}") from None


def _leaf(x, dtype: torch.dtype, device) -> torch.Tensor:
    # numpy views of JAX arrays are read-only: copy, or torch.from_numpy warns
    # and aliases the JAX buffer. bfloat16 leaves arrive as ml_dtypes.bfloat16,
    # which torch.from_numpy rejects, so they go through float32.
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    t = torch.from_numpy(a)
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts and lists (tuples become
    lists), with the matching leaves of the trees ``rest`` of the same
    structure as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts and lists, depth first, dicts in their
    insertion order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def params_from_numpy(cfg: ModelConfig, tree: Any, device) -> Any:
    """Convert a numpy-leaved ``init_params`` tree to the port's parameters
    on ``device``, floating leaves cast to ``cfg.dtype``."""
    dtype = torch_dtype(cfg)
    return tree_map(lambda x: _leaf(x, dtype, device), tree)
