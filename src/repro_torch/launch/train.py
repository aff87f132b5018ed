"""Training launcher of the port: train a reduced or full model on one
device with AdamW and a cosine schedule on the synthetic token dataset,
ported from ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke --device cpu \
        --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 50 --batch 8 \
        --seq 256

Weights are random, drawn by ``init_params`` from ``train``'s ``seed`` (0
from the command line), which also seeds the dataset. Runs on
``cuda`` unless ``--device cpu`` is given (and raises without a GPU). On the
card the attention runs the flash kernel forward and backward, which take
every form of the forward (causal or not, a sliding window, a chunk, cross
attention, MLA's split head dims), and the recurrences run the WKV and
selective-scan kernels forward and backward (the autograd Functions
``WKV6`` and ``SelectiveScan``): every arch of the zoo trains there
(smollm-135m, qwen2.5-3b and its SWA variant, minicpm3-4b, whisper-large-v3,
internvl2-1b, phi3-medium-14b, rwkv6-7b, hymba-1.5b, mixtral-8x22b,
llama4-scout-17b-a16e), within the memory its weights leave: at 12 bytes a
parameter (bf16 parameter and gradient, two f32 AdamW moments) rwkv6-7b,
mixtral-8x22b and llama4-scout at their published depth do not fit one 80
GB card (chip_smoke.py trains them at 16, 2 and 1 layers). On the CPU every arch trains through the plain versions. It prints each logged step's loss,
grad norm and seconds a step, on CUDA the peak memory, and asserts that the
loss fell.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.data.workload import TokenDataset
from repro_torch.models import init_params, make_train_step
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.params import torch_dtype, tree_leaves


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0, log_every: int = 10,
          checkpoint: Optional[str] = None, microbatches: int = 1,
          device: Optional[str] = "cuda", params=None) -> List[float]:
    """Train ``steps`` steps of ``batch`` x ``seq`` tokens; returns the
    losses, one a step. ``params``, if given, are the starting weights (on
    ``device``), trained in place; by default ``init_params`` draws them
    from ``seed``."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{steps} steps @ batch={batch} seq={seq} on {dev}")

    opt = AdamW(lr=cosine_schedule(lr, warmup=max(steps // 20, 1), total=steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, microbatches=microbatches)

    ds = TokenDataset(cfg.vocab_size, seq, seed=seed)
    losses = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    for step, tokens in enumerate(ds.batches(batch, steps)):
        batch_dict = {"tokens": torch.from_numpy(tokens).to(dev)}
        if cfg.num_patch_tokens:
            batch_dict["patch_embeds"] = torch.zeros(
                (batch, cfg.num_patch_tokens, cfg.d_model), dtype=torch_dtype(cfg), device=dev)
        if cfg.is_encoder_decoder:
            batch_dict["frames"] = torch.zeros(
                (batch, cfg.encoder_seq, cfg.d_model), dtype=torch_dtype(cfg), device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch_dict)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"  step {step:4d}  loss {loss:.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)")
    if dev.type == "cuda":
        print(f"[train] peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if checkpoint:
        save_checkpoint(checkpoint, params, step=steps,
                        metadata={"arch": cfg.name, "final_loss": losses[-1]})
        print(f"[train] checkpoint -> {checkpoint}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   args.lr, checkpoint=args.checkpoint,
                   microbatches=args.microbatches, device=args.device)
    print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "training loss did not decrease"


if __name__ == "__main__":
    main()
