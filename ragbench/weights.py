"""A model's weights, drawn on the device from the seed in the dtype they
are served in, one call a stacked leaf, in the tree the port's step
functions read (``embed.table``; ``blocks[0]`` with every leaf stacked over
the layers: ``norm1.scale``, ``attn.wq``/``wk``/``wv``/``wo`` (and
``bq``/``bk``/``bv``), ``norm2.scale``, ``mlp.w_gate``/``w_up``/
``w_down``; ``final_norm.scale``; ``lm_head.w`` unless tied).

Projections are N(0, 1/d_in), the embedding and the head N(0, 0.02), biases
N(0, 0.02), norm scales 1 + N(0, 0.05). The embedding's rows and the head's
columns past ``vocab_size`` (the port pads the vocabulary to a multiple of
128) are zero, as a checkpoint padded to that width would hold them. The
same tensors go to the port and to the plain reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ragbench.corpus import generator

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def padded_vocab(vocab: int) -> int:
    return (vocab + 127) // 128 * 128


def shapes(m: dict) -> Dict[str, Any]:
    """Leaf shapes of the tree for the model file ``m``."""
    L, D, F = m["num_hidden_layers"], m["hidden_size"], m["intermediate_size"]
    H, KVH, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    V = padded_vocab(m["vocab_size"])
    attn = {"wq": (L, D, H * hd), "wk": (L, D, KVH * hd), "wv": (L, D, KVH * hd),
            "wo": (L, H * hd, D)}
    if m.get("qkv_bias"):
        attn.update(bq=(L, H * hd), bk=(L, KVH * hd), bv=(L, KVH * hd))
    tree = {
        "embed": {"table": (V, D)},
        "blocks": [{"norm1": {"scale": (L, D)}, "attn": attn, "norm2": {"scale": (L, D)},
                    "mlp": {"w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)}}],
        "final_norm": {"scale": (D,)},
    }
    if not m["tie_word_embeddings"]:
        tree["lm_head"] = {"w": (D, V)}
    return tree


def _draw(name: str, shape, gen, dtype, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=device)
    if name == "scale":
        return t.normal_(1.0, 0.05, generator=gen)
    if name in ("table", "w") or name.startswith("b"):
        return t.normal_(0.0, 0.02, generator=gen)
    return t.normal_(0.0, 1.0 / math.sqrt(shape[-2]), generator=gen)


def draw(m: dict, seed: int, device) -> Dict[str, Any]:
    """The weights of the model file ``m`` for ``seed`` on ``device``."""
    dtype = DTYPES[m["torch_dtype"]]
    gen = generator(seed, "weights", device)

    def walk(node):
        if isinstance(node, list):
            return [walk(x) for x in node]
        return {k: walk(v) if not isinstance(v, tuple) else _draw(k, v, gen, dtype, device)
                for k, v in node.items()}

    tree = walk(shapes(m))
    V = m["vocab_size"]
    tree["embed"]["table"][V:] = 0
    if "lm_head" in tree:
        tree["lm_head"]["w"][:, V:] = 0
    return tree
