"""PyTorch/CUDA port of the Patchwork serving stack.

A sibling of the JAX package ``repro`` with the same layout and names; it
imports ``torch`` and numpy and nothing of JAX or ``repro``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; where no GPU is
visible and the caller did not ask for the CPU they raise (``resolve_device``).
On the CPU the attention wrappers run their plain PyTorch versions; on a
CUDA tensor they launch the hand-written kernels in ``csrc/``; on a ``meta``
tensor (the dry run, which asks for it by name) they return outputs of
their contract's shapes and count its work (``kernels.work``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked. Raises when CUDA is requested (explicitly or by default) and
    no GPU is visible — the port never falls back to the CPU silently.
    ``"meta"`` (shapes only: the dry run, ``launch.dryrun``) is taken only
    when the caller passes it, never by default."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
