"""Dry run on the meta device: build every (architecture x input shape)
step of the JAX package's dry run with meta tensors, run it once under
``torch.utils.flop_counter.FlopCounterMode`` with the kernel wrappers'
meta counters beside it (``kernels.work``), and report what the step
needs, without touching a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.jsonl]

It is the port's counterpart of ``repro.launch.dryrun`` (lower + compile +
``memory_analysis`` / ``cost_analysis``), with the same flags and steps:
the train step (AdamW, bf16 first moments for the MoE archs, JAX's
microbatch rule), prefill, and decode of one token against a ``seq_len``
cache. Per shape it reports

* **per device, at the named mesh** ((16, 16) or (2, 16, 16)): the
  argument bytes (params, optimizer state, cache, inputs) from the ported
  sharding policy (``models.sharding``), each leaf divided by its spec;
* **for the whole step at world size 1**: the FLOPs (the aten ops'
  ``FlopCounterMode`` count plus each kernel's contract work; the train
  step's layer-group recompute included, as XLA's count includes remat),
  the kernels' contract bytes, a peak estimate (the most bytes of live
  meta storages at any op, arguments included) and whether that peak
  ``fits`` one H100 80GB HBM3 (``kernels.work.CARD_BYTES``);
* **collectives**: with ``--serve-shard``, the all-reduces of the explicit
  Megatron schedule the sharded paged engine runs (``models.shardmap_tp.
  megatron_collectives``; archs that engine serves). GSPMD's FSDP
  schedule has no counterpart without a partitioner, and is not modelled.
* **pool**: with ``--serve-shard`` on a serve shape, a rank's paged KV pool
  when the mesh's "data" rows are replicas over block ranges
  (``serving.sharded_pool.ShardedPoolLayout(dp_blocks=True).pool_shape``).

Nothing is allocated or launched: every tensor lives on ``meta``, which
the dry run passes by name (``resolve_device`` never picks it).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, arch_runs_shape, get_arch, get_shape
from repro_torch.kernels import work as kwork
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
from repro_torch.models import model as M
from repro_torch.models import sharding as shd
from repro_torch.models.shardmap_tp import megatron_collectives
from repro_torch.optim import AdamW
from repro_torch.params import tree_leaves


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def train_microbatches(cfg, shape, axis_sizes) -> int:
    """JAX's microbatch rule: min(16 for MoE archs else 8, the batch over
    the (pod x data) axes)."""
    nb = math.prod(axis_sizes[a] for a in shd.batch_axes(axis_sizes))
    return min(16 if cfg.is_moe else 8, max(shape.global_batch // nb, 1))


def build_step(arch, shape_name, mesh, dtype: str = "bfloat16",
               moe_mode: str = "tp", serve_shard: bool = False, kv_int8: bool = False):
    """Returns (fn, args, specs): the step function, its meta arguments and
    their spec trees at ``mesh``, as the JAX function's (jitted_fn,
    arg_specs) with the shardings apart. ``arch`` and ``shape_name`` are
    names of the registries, or a ``ModelConfig`` and a ``ShapeConfig``
    (a reduced variant, as the tests take)."""
    cfg = (get_arch(arch) if isinstance(arch, str) else arch).replace(
        dtype=dtype, kv_cache_quant=kv_int8)
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    axis_sizes = mesh_axis_sizes(mesh)
    params = M.abstract_params(cfg)
    pspecs = shd.param_pspecs(cfg, params, axis_sizes, moe_mode=moe_mode,
                              serve=serve_shard and shape.kind != "train")
    batch = M.input_specs(cfg, shape)
    bspecs = shd.input_pspecs(cfg, shape, batch, axis_sizes)

    if shape.kind == "train":
        opt = AdamW(lr=3e-4, momentum_dtype="bfloat16" if cfg.is_moe else "float32")
        opt_state = opt.init(params)
        ospecs = shd.opt_state_pspecs(pspecs)
        step = M.make_train_step(cfg, opt,
                                 microbatches=train_microbatches(cfg, shape, axis_sizes))
        return step, (params, opt_state, batch), (pspecs, ospecs, bspecs)

    if shape.kind == "prefill":

        def prefill_step(params, batch):
            return M.prefill(cfg, params, batch)

        return prefill_step, (params, batch), (pspecs, bspecs)

    # decode: one new token a row against a seq_len cache; pos a scalar, as
    # the JAX step's, broadcast to the port's per-row positions
    B = shape.global_batch
    cache = M.abstract_cache(cfg, B, shape.seq_len)
    cspecs = shd.cache_pspecs(cfg, shape, cache, axis_sizes)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    tok_spec = shd.input_pspecs(cfg, shape, {"tokens": tokens}, axis_sizes)["tokens"]

    def serve_step(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache, tokens, pos.expand(B))

    return serve_step, (params, cache, tokens, pos), (pspecs, cspecs, tok_spec, shd.Spec())


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------


def _leaf_bytes(t: torch.Tensor, spec, axis_sizes) -> int:
    return math.prod(shd.shard_shape(tuple(t.shape), spec, axis_sizes)) * t.element_size()


def argument_bytes(args, specs, axis_sizes) -> Dict[str, int]:
    """Per-device bytes of each argument (by position) and their total:
    every leaf's shard under its spec."""
    out = {}
    for i, (a, s) in enumerate(zip(args, specs)):
        per = []
        shd.tree_map_with_path(lambda _p, t, sp: per.append(_leaf_bytes(t, sp, axis_sizes)),
                               a, s)
        out[i] = sum(per)
    out["total"] = sum(out[i] for i in range(len(args)))
    return out


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of the live storages of a meta run: each storage an
    op creates is counted when it appears and taken off when it dies (a
    finalizer on the storage), so ``peak`` is the most bytes alive at any
    op. Storages of the arguments are counted from the start. What the
    autograd graph saves and the layer-group recompute decide the peak; no
    allocator rounding, fragmentation or workspace is counted."""

    def __init__(self, args):
        super().__init__()
        self._live: Dict[int, int] = {}
        self.live = 0
        for t in tree_leaves(args):
            self._track(t)
        self.peak = self.live

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.peak = max(self.peak, self.live)
        return out


def run_step(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` on meta under the counters: aten FLOPs, the
    kernels' contract work, and the peak of live bytes."""
    kwork.reset_meta_work()
    live = LiveBytes(args)
    counter = FlopCounterMode(display=False)
    with counter, live:
        fn(*args)
    kernels = kwork.meta_work_snapshot()
    aten = counter.get_total_flops()
    k_flops = sum(w.flops for w in kernels.values())
    return {
        "aten_flops": aten,
        "kernel_flops": k_flops,
        "flops": aten + k_flops,
        "kernel_bytes": sum(w.nbytes for w in kernels.values()),
        "kernels": {k: {"calls": w.calls, "flops": w.flops, "bytes": w.nbytes}
                    for k, w in sorted(kernels.items())},
        "peak_bytes_est": live.peak,
    }


def serve_collectives(cfg, shape, axis_sizes) -> Dict[str, Any]:
    """The explicit Megatron schedule's all-reduces on one device at
    ``axis_sizes``: the archs the sharded paged engine serves (period-1
    full-attention GQA stacks), the step's tokens on one device."""
    if not M.paged_cache_supported(cfg):
        return {"modelled": False,
                "reason": f"{cfg.name}: the sharded paged engine serves period-1 full-attention "
                          f"GQA stacks only"}
    baxes = shd.batch_axes(axis_sizes)
    nb = math.prod(axis_sizes[a] for a in baxes)
    B = shape.global_batch
    rows = B // nb if B % nb == 0 else B
    tokens = rows * (1 if shape.kind == "decode" else shape.seq_len)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return {"modelled": True, **megatron_collectives(cfg, tokens, item,
                                                     axis_sizes.get("model", 1))}


def serve_pool(cfg, shape, mesh, block_size: int = 16) -> Dict[str, Any]:
    """A rank's paged KV pool at ``mesh`` under ``--serve-shard``: one
    ``DataParallelEngineGroup`` replica a "data" row, each serving its share
    of the batch at ``seq_len``, provisioned as the engine provisions (rows
    x (blocks a sequence + 1) + 1 blocks a replica), the block axis over
    "data" (``dp_blocks``) and the KV heads over "model" where they divide;
    archs the paged engine serves."""
    from repro_torch.serving.sharded_pool import ShardedPoolLayout

    if not M.paged_cache_supported(cfg):
        return {"modelled": False,
                "reason": f"{cfg.name}: the paged engine serves period-1 full-attention GQA "
                          f"stacks only"}
    axis_sizes = mesh_axis_sizes(mesh)
    dp = axis_sizes.get("data", 1)
    B = shape.global_batch
    rows = B // dp if B % dp == 0 else B
    per = rows * (-(-shape.seq_len // block_size) + 1) + 1
    layout = ShardedPoolLayout(mesh, dp_blocks=True)
    local = layout.pool_shape(cfg, per * dp, block_size)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return {"modelled": True, "n_blocks": per * dp, "block_size": block_size,
            "shape_per_rank": local, "bytes_per_rank": 2 * math.prod(local) * item}


def dryrun(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True,
           moe_mode: str = "tp", serve_shard: bool = False,
           kv_int8: bool = False) -> Dict[str, Any]:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    if not arch_runs_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "SKIP",
                "reason": "full-attention arch skips long_500k"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    axis_sizes = mesh_axis_sizes(mesh)
    t0 = time.time()
    fn, args, specs = build_step(arch, shape_name, mesh, moe_mode=moe_mode,
                                 serve_shard=serve_shard, kv_int8=kv_int8)
    per_dev = argument_bytes(args, specs, axis_sizes)
    t1 = time.time()
    step = run_step(fn, args)
    t2 = time.time()
    run_cfg = cfg.replace(dtype="bfloat16", kv_cache_quant=kv_int8)
    out = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "status": "OK",
        "build_s": round(t1 - t0, 2),
        "run_s": round(t2 - t1, 2),
        "per_device": {"argument_bytes": per_dev["total"]},
        "whole_step": {
            "argument_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(args)),
            **{k: step[k] for k in ("flops", "aten_flops", "kernel_flops", "kernel_bytes",
                                    "peak_bytes_est")},
            "fits": step["peak_bytes_est"] <= kwork.CARD_BYTES,
            "kernels": step["kernels"],
        },
        "collectives": (serve_collectives(run_cfg, shape, axis_sizes) if serve_shard else
                        {"modelled": False,
                         "reason": "GSPMD's FSDP collective schedule has no counterpart "
                                   "without a partitioner"}),
    }
    if serve_shard and shape.kind != "train":
        out["pool"] = serve_pool(run_cfg, shape, mesh)
    if verbose:
        ws = out["whole_step"]
        print(f"[dryrun] {arch} x {shape_name} mesh={out['mesh']}: "
              f"args/device {per_dev['total'] / 2**30:.2f} GiB; whole step "
              f"{ws['flops']:.3e} FLOPs ({ws['kernel_flops']:.3e} in kernels), "
              f"peak est {ws['peak_bytes_est'] / 2**30:.2f} GiB, "
              f"fits one H100 ({kwork.CARD_BYTES / 2**30:.2f} GiB): {ws['fits']} "
              f"({out['run_s']}s)")
        c = out["collectives"]
        print(f"  collectives: {c}" if c["modelled"] else f"  collectives: not modelled "
              f"({c['reason']})")
        p = out.get("pool")
        if p is not None:
            print(f"  pool a rank: {p['shape_per_rank']} of {p['n_blocks']} blocks, "
                  f"{p['bytes_per_rank'] / 2**30:.2f} GiB k+v" if p["modelled"] else
                  f"  pool: not modelled ({p['reason']})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None, help="append results to this JSONL file")
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE sharding")
    ap.add_argument("--serve-shard", action="store_true",
                    help="TP-resident serving weights, no FSDP")
    ap.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    results, failed = [], []
    for a, s, mp in combos:
        try:
            r = dryrun(a, s, multi_pod=mp, moe_mode="ep" if args.moe_ep else "tp",
                       serve_shard=args.serve_shard, kv_int8=args.kv_int8)
        except Exception as e:  # noqa: BLE001 — report, keep going
            r = {"arch": a, "shape": s, "mesh": "pod2x16x16" if mp else "16x16",
                 "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
            print(f"[dryrun] {a} x {s} FAILED: {e}")
            failed.append(r)
        results.append(r)
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(r) + "\n")

    ok = sum(1 for r in results if r["status"] == "OK")
    skip = sum(1 for r in results if r["status"] == "SKIP")
    print(f"\n[dryrun] {ok} OK, {skip} SKIP, {len(failed)} FAIL / {len(results)} total")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
