"""Tensor-parallel blocks with explicit collectives, ported from
``repro.models.shardmap_tp``.

The Megatron schedule, written out:

    column-parallel:  y_local = x @ W1_local          (no communication)
    row-parallel:     z = all_reduce(y_local @ W2_local)   (one all-reduce)

``make_tp_block`` is that block on one rank of a process group (each rank
holds ``shard_tp_weights``' slices), ``tp_block_reference`` the unsharded
oracle, and ``tp_block_dtensor`` the same block through DTensor
(``torch.distributed.tensor``: weights placed with ``Shard`` placements,
the schedule left to DTensor's propagation), the counterpart of JAX's
``tp_block_pjit``, kept so the two schedules can be compared.
``count_collectives`` runs a function under the step audit's dispatch
probe (``analysis.step_audit``) and returns its census.

``all_reduce`` is the port's one all-reduce: every collective of the
sharded paged engine goes through it (``models.transformer`` calls it
after the attention output projection and after the MLP's down
projection). A gloo group takes CUDA tensors as they are (gloo stages them
through host memory itself). ``megatron_collectives`` is the schedule's
closed form, which the dry run reports and the census is held to.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place and return it (one ``c10d``
    all-reduce)."""
    dist.all_reduce(x, group=group)
    return x


def megatron_collectives(cfg, n_tokens: int, itemsize: int, tp: int) -> dict:
    """The explicit schedule's collectives for one step of ``n_tokens``
    tokens on one rank at TP degree ``tp``: an all-reduce of the (tokens,
    d_model) activations after each layer's attention output projection
    and after its MLP down projection, none at ``tp == 1``. Returns
    {"all-reduce": count, "all-reduce_bytes": bytes handed to them}."""
    if tp <= 1:
        return {"all-reduce": 0, "all-reduce_bytes": 0}
    n = 2 * cfg.num_layers
    return {"all-reduce": n, "all-reduce_bytes": n * n_tokens * cfg.d_model * itemsize}


def tp_block_reference(x, w_in, w_out):
    """Unsharded oracle: x (B, D) @ w_in (D, F) -> gelu -> @ w_out (F, D)
    (JAX's default gelu, the tanh form)."""
    return F.gelu(x @ w_in, approximate="tanh") @ w_out


def make_tp_block(mesh, axis: str = "model"):
    """The TP block on this rank: ``block(x, w_in_local, w_out_local)``
    with w_in column-split (D, F / tp), w_out row-split (F / tp, D) and x
    replicated; one all-reduce over ``axis``'s group."""
    group = mesh.get_group(axis)

    def block(x, w_in_local, w_out_local):
        h = F.gelu(x @ w_in_local, approximate="tanh")   # (B, F / tp), local
        z = h @ w_out_local                               # (B, D), a partial sum
        return all_reduce(z, group)

    return block


def shard_tp_weights(mesh, w_in, w_out, axis: str = "model"):
    """This rank's slices of the full weights, in the layout the block
    expects: w_in's columns and w_out's rows of its shard of F."""
    tp = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    f = w_in.shape[1] // tp
    return (w_in[:, r * f:(r + 1) * f].contiguous(),
            w_out[r * f:(r + 1) * f].contiguous())


def tp_block_dtensor(mesh, axis: str = "model"):
    """The same block through DTensor: ``block(x, w_in, w_out)`` takes the
    full tensors, places x replicated, w_in as ``Shard(1)`` and w_out as
    ``Shard(0)`` over ``axis`` and returns the replicated result, with the
    collectives DTensor's propagation chooses."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    sub = mesh[axis] if mesh.ndim > 1 else mesh

    def block(x, w_in, w_out):
        xd = distribute_tensor(x, sub, [Replicate()])
        wi = distribute_tensor(w_in, sub, [Shard(1)])
        wo = distribute_tensor(w_out, sub, [Shard(0)])
        z = F.gelu(xd @ wi, approximate="tanh") @ wo
        return z.redistribute(sub, [Replicate()]).to_local()

    return block


def count_collectives(fn, args) -> dict:
    """Collective census of one call of ``fn(*args)`` (the step audit's
    dispatch probe): kind -> count for the five kinds JAX's census names,
    and kind + "_bytes" -> the bytes handed to them."""
    from repro_torch.analysis.step_audit import collective_bytes, collective_census, trace_step

    trace = trace_step(fn, tuple(args))
    census, nbytes = collective_census(trace), collective_bytes(trace)
    out = {k: census.get(k, 0) for k in COLLECTIVE_KINDS}
    out.update({f"{k}_bytes": nbytes.get(k, 0) for k in COLLECTIVE_KINDS})
    for k, v in census.items():        # any other kind the probe saw
        if k not in out:
            out[k] = v
    return out
