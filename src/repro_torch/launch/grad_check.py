"""What a stack's gradient check needs: the stack with its attention and
recurrences through their plain versions (``plain_kernels``), the depth cut
of a stack (``cut_depth``) and the paths of its leaves (``leaf_paths``).
chip_smoke.py's stack check takes each leaf's gradient through the kernels
and through ``plain_kernels`` at a cut depth and compares them leaf by leaf.
"""
from __future__ import annotations

import contextlib
from typing import List


@contextlib.contextmanager
def plain_kernels():
    """The stack's attention through ``ref_flash_attention`` and its
    recurrences through ``ref_rwkv6_chunked`` and ``ref_ssm_scan``, all
    under autograd (the plain versions differentiated by PyTorch), in place
    of the kernels' trainable Functions, in the forms the models ask for."""
    from repro_torch.configs.base import ATTN_CHUNKED_LOCAL, ATTN_FULL, ATTN_SWA
    from repro_torch.kernels.flash_attention import ref_flash_attention
    from repro_torch.kernels.rwkv6_scan import ref_rwkv6_chunked
    from repro_torch.kernels.ssm_scan import ref_ssm_scan
    from repro_torch.models import attention as attn
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models import ssm as ssm_mod

    def plain_attention(q, k, v, *, attn_type=ATTN_FULL, window=0, chunk=0, causal=True):
        return ref_flash_attention(q, k, v, causal=causal,
                                   window=window if attn_type == ATTN_SWA else 0,
                                   chunk=chunk if attn_type == ATTN_CHUNKED_LOCAL else 0)

    real = (attn.blockwise_attention, rwkv_mod.trainable_rwkv6_chunked,
            ssm_mod.trainable_ssm_scan)
    attn.blockwise_attention = plain_attention
    rwkv_mod.trainable_rwkv6_chunked, ssm_mod.trainable_ssm_scan = ref_rwkv6_chunked, ref_ssm_scan
    try:
        yield
    finally:
        (attn.blockwise_attention, rwkv_mod.trainable_rwkv6_chunked,
         ssm_mod.trainable_ssm_scan) = real


def leaf_paths(tree, prefix="") -> List[str]:
    """'##'-joined paths of a params tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}{k}##")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}##")]
    return [prefix[:-2]]


def cut_depth(cfg, layers: int):
    """``cfg`` with its depth cut to ``layers``. llama4-scout's period (a
    global layer every 4th) does not divide 1 or 2 layers; its first three
    layers are chunked-local, so the cut stack keeps that kind alone."""
    cfg = cfg.replace(num_layers=layers)
    if cfg.global_layer_every and layers % cfg.global_layer_every:
        cfg = cfg.replace(global_layer_every=0)
    return cfg
