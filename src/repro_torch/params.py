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

from typing import Any

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


def params_from_numpy(cfg: ModelConfig, tree: Any, device) -> Any:
    """Convert a numpy-leaved ``init_params`` tree to the port's parameters
    on ``device``, floating leaves cast to ``cfg.dtype``."""
    dtype = torch_dtype(cfg)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf(node, dtype, device)

    return walk(tree)
