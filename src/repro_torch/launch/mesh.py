"""Meshes of the port, ported from ``repro.launch.mesh``.

* ``make_production_mesh`` gives the dry run (``launch.dryrun``) a mesh of
  axis names and sizes, (16, 16) over ("data", "model") or (2, 16, 16)
  over ("pod", "data", "model"), with no processes behind it: the dry run
  only divides shapes by it.
* ``make_serving_mesh(tp, dp)`` builds a
  ``torch.distributed.device_mesh.DeviceMesh`` over the initialised
  process group, ("model",) for tensor parallelism, ("data", "model") of
  (dp, tp) with data-parallel rows (``serving.sharded_pool``: each row one
  replica); it raises, as JAX's does, when the world does not hold ``tp *
  dp`` ranks.
* ``mesh_axis_sizes`` reads axis name -> size from either kind.

``run_on_ranks`` runs a job on ``tp * dp`` spawned processes over gloo,
each with its serving mesh of that shape (``launch.serve --tp [--dp]``,
the tests, ``chip_smoke.py``).

``make_production_mesh`` and ``make_serving_mesh`` are functions, never
module-level constants, so that importing this module touches no process
group. The JAX module's v5e hardware constants have no counterpart here:
the H100's rates and memory live in ``kernels.work``, beside the work
counts that use them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: what the dry run divides by."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_serving_mesh(tp: int = 1, dp: int = 1):
    """``DeviceMesh`` of the sharded paged engine over the default process
    group: ("model",) of size ``tp`` (``dp == 1``), else ("data", "model")
    of (dp, tp). The mesh names ranks and their groups; the engine places
    its tensors itself (a gloo group takes CPU and CUDA tensors alike), so
    the mesh's device type is "cpu" on either. Raises ``ValueError`` when
    the group does not hold ``tp * dp`` ranks, and ``RuntimeError`` when no
    process group is initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if tp * dp != n:
        raise ValueError(f"serving mesh tp={tp} dp={dp} needs {tp * dp} ranks, have {n}")
    import torch

    ranks = torch.arange(n)
    if dp > 1:
        return DeviceMesh("cpu", ranks.reshape(dp, tp), mesh_dim_names=("data", "model"))
    return DeviceMesh("cpu", ranks, mesh_dim_names=("model",))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def rank_device(device, rank: int, world: int):
    """The device of ``rank``: ``"cuda"`` takes ``cuda:<rank>`` and raises
    when fewer than ``world`` GPUs are visible (no rank shares a card
    unasked); an indexed ``"cuda:i"`` puts every rank on that card, as its
    caller asked; ``"cpu"`` the CPU."""
    import torch

    from repro_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n < world:
            raise ValueError(f"{world} ranks on cuda, one GPU a rank: needs {world} GPUs, "
                             f"{n} visible (cuda:<i> puts every rank on one)")
        return torch.device("cuda", rank)
    return dev


def _rank_main(rank, world, dp, store_path, out_dir, job, device, args):
    import datetime

    import torch
    import torch.distributed as dist

    # a rank that fails leaves the others waiting in a collective: gloo's
    # timeout, and the parent's join, end them
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        dev = rank_device(device, rank, world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:   # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        result = job(rank, make_serving_mesh(world // dp, dp), dev, *args)
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_on_ranks(job, tp: int, device, *args, dp: int = 1):
    """Run ``job(rank, mesh, device, *args)`` on ``tp * dp`` processes,
    SPMD: each a rank of a gloo group (``torch.multiprocessing``, start
    method "spawn", rendezvous through a ``FileStore`` in a temporary
    directory, so no network), ``mesh`` its ``make_serving_mesh(tp, dp)``
    (rank r at row r // tp, column r % tp) and ``device`` its
    ``rank_device``. ``job`` is a module-level function; what it returns
    comes back through ``torch.save``. Returns the results in rank order;
    a rank that raises raises here."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    world = tp * dp
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank_main, args=(world, dp, os.path.join(d, "store"), d, job,
                                             device, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

