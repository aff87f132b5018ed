"""Declarative contract audit of the engine's step programs, ported from
``repro.analysis.jaxpr_audit``.

``GenerationEngine.step_program(which)`` exposes every step program the
serving loop can dispatch — the fused ragged/padded mixed-batch steps, the
paged-kernel and gather-oracle decode programs, and the bare pool
gather/scatter roundtrip. The port's steps are eager: there is no traced
program to walk, so the audit RUNS one call of each program (pad-only
tables, zero tokens; the writes land in the scratch block) under
instruments and checks a :class:`StepContract` against what they saw:

* **collectives** — a census of the ``c10d`` / ``_c10d_functional`` ops a
  ``TorchDispatchMode`` sees during the call, each with the bytes of the
  tensors it was handed and the process group it ran on. An engine off any
  mesh must show none; a sharded engine (``pool_layout``, tensor parallel
  over a "model" axis) at most 2 x num_layers all-reduces on its step
  programs (the Megatron pair, one after the attention output projection
  and one after the MLP down projection a layer), none on the bare pool
  roundtrip, and never an all-gather. On a mesh with a "data" axis they
  must run on the rank's "model" group, and no collective may run on its
  "data" group or any other (``group_census``): a replica's block gather
  never leaves its rank. (JAX allows one data-axis all-reduce a pool read
  there, the combine GSPMD puts after a masked local gather; without a
  partitioner there is none. The host-tier and load exchanges of
  ``serving.engine.DataParallelEngineGroup`` run between step programs,
  on the host, and the audit does not see them.)
* **host-sync** (the JAX audit's ``callbacks``) — no host round-trip inside
  a step: the dispatch mode flags ``_local_scalar_dense`` (``.item()``,
  ``bool()``/``int()`` of a tensor), ``nonzero``, ``unique*``,
  ``masked_select``, ``equal``, ``is_nonzero``, ``repeat_interleave``
  without ``output_size``, and any copy of a non-CPU tensor to the CPU. On
  CUDA the call also runs under ``torch.cuda.set_sync_debug_mode("error")``,
  which catches what dispatch cannot see (a copy from pageable host memory);
  the mode is restored afterwards. A hidden sync per step destroys the
  double-buffered dispatch overlap, and it is what breaks CUDA graph
  capture of a step.
* **int8-flow** — on int8 engines with the paged kernels, (a) *no
  whole-pool upcast*: no op converts to a float dtype an int8 tensor that
  shares the pool's storage and covers at least one layer group's slice
  (gathered copies, which have storage of their own, are the legal requant
  and oracle paths and are not flagged), and (b) *reached*: a paged kernel
  wrapper received the int8 pools (the dispatch mode cannot see the ctypes
  launches, so the wrappers call ``kernels.decode_attention.observer``).
* **cache-sentinel** — after ``warmup_step_variants()`` every packed length
  the ragged step has met must be one that warmup ran (a new length is a
  shape the serving clock pays for first); on CUDA, in addition, no kernel
  library may be built (``kernels._build.load_library``'s cache must not
  grow) while the audited programs run.

Run via ``audit_engine(engine)``, ``python -m repro_torch.analysis audit``
or ``launch/serve.py --audit``. Each check is mutation-tested
(``--mutate audit-*``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = [
    "StepContract", "Finding", "AuditReport", "StepTrace", "audit_engine",
    "audit_program", "default_contracts", "cache_sentinel", "trace_step",
    "collective_census", "collective_bytes", "group_census", "mesh_groups",
    "find_host_syncs", "int8_kernel_flow",
]

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
# op-name prefix (underscores and "_base" dropped) -> census kind
_COLLECTIVE_KINDS = (
    ("allreduce", "all-reduce"),
    ("allgather", "all-gather"),
    ("alltoall", "all-to-all"),
    ("reducescatter", "reduce-scatter"),
    ("broadcast", "broadcast"),
    ("send", "collective-permute"),
    ("recv", "collective-permute"),
)
# completions and autograd wrappers of functional collectives, not
# collectives of their own
_COLLECTIVE_WAITS = ("waittensor", "wraptensorautograd")

_HOST_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive", "masked_select", "equal",
    "is_nonzero",
})


def _collective_kind(name: str) -> Optional[str]:
    key = name.replace("_base", "").replace("_", "").lower()
    if key.startswith(_COLLECTIVE_WAITS):
        return None
    for prefix, kind in _COLLECTIVE_KINDS:
        if key.startswith(prefix):
            return kind
    return "other"


@dataclass(frozen=True)
class StepContract:
    """Declarative expectations for one step program."""
    program: str                       # step_program() target name
    max_all_gather: int = 0            # census bound (0 on every path)
    max_all_reduce: Optional[int] = None   # None = unbounded (TP matmuls)
    forbid_kinds: Tuple[str, ...] = ("all-to-all", "reduce-scatter", "broadcast",
                                     "collective-permute", "other")
    allow_host_sync: bool = False
    require_int8_kernel_path: bool = False
    # on a data-axis mesh: (group name, axis) of the rank's groups; every
    # collective must then run on its "model" group
    axis_groups: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class Finding:
    program: str
    check: str      # collectives / host-sync / int8-flow / cache-sentinel
    ok: bool
    detail: str

    def __str__(self) -> str:
        mark = " ok " if self.ok else "FAIL"
        return f"[{mark}] {self.program:>13s} {self.check:<13s} {self.detail}"


@dataclass
class AuditReport:
    findings: List[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(f.ok for f in self.findings)

    def failures(self) -> List[Finding]:
        return [f for f in self.findings if not f.ok]

    def render(self) -> str:
        head = "step-program contract audit"
        tail = ("all contracts hold" if self.ok
                else f"{len(self.failures())} contract violation(s)")
        return "\n".join([head, *(str(f) for f in self.findings), tail])


# ------------------------------------------------------------- instruments
@dataclass
class StepTrace:
    """What the instruments saw during one call of a step program."""
    collectives: List[Tuple[str, str]] = field(default_factory=list)  # (kind, op)
    collective_nbytes: List[int] = field(default_factory=list)  # each one's tensor bytes
    collective_groups: List[Optional[str]] = field(default_factory=list)  # each one's group
    host_syncs: List[str] = field(default_factory=list)
    upcasts: List[str] = field(default_factory=list)
    kernel_pools: List[Tuple[str, torch.dtype, torch.dtype]] = field(default_factory=list)
    sync_error: Optional[str] = None   # what set_sync_debug_mode("error") raised


def _group_name(func, args, kwargs) -> Optional[str]:
    """The name of the process group a collective op was handed: a
    ``c10d`` op's boxed ``ProcessGroup``, a functional op's
    ``group_name`` argument."""
    import torch.distributed as dist

    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_name":
            return kwargs.get("group_name", args[i] if i < len(args) else None)
    for t in tree_leaves((args, kwargs)):
        if isinstance(t, torch.ScriptObject) and "ProcessGroup" in str(t._type()):
            return dist.ProcessGroup.unbox(t).group_name
    return None


def _storage_ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _StepProbe(TorchDispatchMode):
    """Sees every aten / c10d op of the call (not the ctypes launches, and
    not the ops a kernel runs inside itself). Records an op before running
    it, so an op that raises is on the record too."""

    def __init__(self, trace: StepTrace, pools: Sequence[torch.Tensor]):
        super().__init__()
        self.trace = trace
        # int8 pool storages -> the element count of one layer group's slice
        self.pool_slices = {_storage_ptr(p): p[0].numel() for p in pools
                            if p is not None and p.dtype == torch.int8}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns, _, name = func._schema.name.partition("::")
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _collective_kind(name)
            if kind is not None:
                self.trace.collectives.append((kind, f"{ns}.{name}"))
                self.trace.collective_nbytes.append(sum(
                    t.numel() * t.element_size() for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)))
                self.trace.collective_groups.append(_group_name(func, args, kwargs))
        elif self._syncs(name, func, args, kwargs):
            self.trace.host_syncs.append(f"{ns}.{name}")
        out = func(*args, **kwargs)
        if self.pool_slices:
            self._check_upcast(name, args, kwargs, out)
        return out

    @staticmethod
    def _syncs(name, func, args, kwargs) -> bool:
        if name in _HOST_SYNC_OPS:
            return True
        if name == "repeat_interleave":
            return (func._overloadname in ("Tensor", "self_Tensor")
                    and kwargs.get("output_size") is None)
        if name == "_to_copy":
            dev = kwargs.get("device")
            return (dev is not None and torch.device(dev).type == "cpu"
                    and args[0].device.type != "cpu")
        if name == "copy_":
            return args[0].device.type == "cpu" and args[1].device.type != "cpu"
        return False

    def _check_upcast(self, name, args, kwargs, out) -> None:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        floats = [t for t in outs if t.is_floating_point()]
        if not floats:
            return
        for t in tree_leaves((args, kwargs)):
            if not isinstance(t, torch.Tensor) or t.dtype != torch.int8:
                continue
            slice_numel = self.pool_slices.get(_storage_ptr(t))
            if slice_numel is not None and t.numel() >= slice_numel:
                self.trace.upcasts.append(
                    f"{name} int8{list(t.shape)} -> {str(floats[0].dtype)[6:]} "
                    f"(whole-pool dequant outside the kernel)")


def trace_step(fn: Callable, args: tuple, pools: Sequence[torch.Tensor] = (),
               sync_debug: bool = True) -> StepTrace:
    """Run ``fn(*args)`` once under the instruments, without autograd.
    ``pools``: the int8 pool tensors whose whole-pool upcasts to flag. On
    CUDA (with ``sync_debug``) the call runs under
    ``set_sync_debug_mode("error")`` (restored afterwards); a sync it raises
    on is recorded, not propagated."""
    from repro_torch.kernels import decode_attention

    trace = StepTrace()
    cuda = sync_debug and any(isinstance(a, torch.Tensor) and a.is_cuda
                              for a in tree_leaves(args))
    prev_observer = decode_attention.observer
    decode_attention.observer = lambda name, kd, vd: trace.kernel_pools.append((name, kd, vd))
    prev_mode = None
    try:
        if cuda:
            torch.cuda.synchronize()
            prev_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad(), _StepProbe(trace, pools):
                fn(*args)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            trace.sync_error = str(e).strip().splitlines()[0]
    finally:
        if prev_mode is not None:
            torch.cuda.set_sync_debug_mode(prev_mode)
            torch.cuda.synchronize()
        decode_attention.observer = prev_observer
    return trace


def collective_census(trace: StepTrace) -> Dict[str, int]:
    """Collective kind -> count over the call."""
    out: Dict[str, int] = {}
    for kind, _op in trace.collectives:
        out[kind] = out.get(kind, 0) + 1
    return out


def collective_bytes(trace: StepTrace) -> Dict[str, int]:
    """Collective kind -> the bytes of the tensors handed to its ops over
    the call (an all-reduce's: the tensor reduced in place)."""
    out: Dict[str, int] = {}
    for (kind, _op), n in zip(trace.collectives, trace.collective_nbytes):
        out[kind] = out.get(kind, 0) + n
    return out


def mesh_groups(layout) -> Dict[str, str]:
    """Group name -> axis ("model", "data") of a layout's process groups on
    this rank (an axis of size 1 has none); empty off a mesh."""
    if layout is None:
        return {}
    groups = {"model": layout.tp_group, "data": layout.dp_group}
    return {g.group_name: axis for axis, g in groups.items() if g is not None}


def group_census(trace: StepTrace, layout) -> Dict[str, Dict[str, int]]:
    """Axis -> collective kind -> count over the call, and kind + "_bytes"
    -> the bytes handed to them: the collectives on the rank's "model" and
    "data" groups of ``layout`` (``serving.sharded_pool``), and under
    "other" those on any other group."""
    names = mesh_groups(layout)
    out: Dict[str, Dict[str, int]] = {"model": {}, "data": {}}
    for (kind, _op), n, g in zip(trace.collectives, trace.collective_nbytes,
                                 trace.collective_groups):
        c = out.setdefault(names.get(g, "other"), {})
        c[kind] = c.get(kind, 0) + 1
        c[f"{kind}_bytes"] = c.get(f"{kind}_bytes", 0) + n
    return out


def find_host_syncs(trace: StepTrace) -> List[str]:
    """The syncing ops the dispatch mode saw, and the sync that
    ``set_sync_debug_mode("error")`` raised on (CUDA)."""
    hits = list(trace.host_syncs)
    if trace.sync_error is not None:
        hits.append(f"set_sync_debug_mode('error'): {trace.sync_error}")
    return hits


def int8_kernel_flow(trace: StepTrace) -> Tuple[bool, List[str]]:
    """``(reached, upcasts)``: whether a paged kernel wrapper received int8
    pools, and every whole-pool conversion to a float dtype seen."""
    int8 = torch.int8
    reached = any(kd == int8 and vd == int8 for _n, kd, vd in trace.kernel_pools)
    return reached, list(trace.upcasts)


# -------------------------------------------------------- cache sentinel
def _libraries_loaded(engine) -> int:
    """Kernel libraries loaded in this process (CUDA engines; 0 on the CPU,
    where no wrapper loads one)."""
    if engine.device.type != "cuda":
        return 0
    from repro_torch.kernels._build import load_library

    return load_library.cache_info().currsize


def cache_sentinel(engine, warm: bool = True, libraries_built: int = 0) -> Finding:
    """After warmup, the ragged step must have met only the warmed packed
    lengths, and (CUDA) ``libraries_built`` kernel libraries must be 0
    (``audit_engine`` counts them over the audited programs)."""
    if engine.backend != "paged" or not engine.interleave or not engine.ragged:
        return Finding("fused_ragged", "cache-sentinel", True,
                       "n/a (no ragged variants on this engine)")
    if warm:
        engine.warmup_step_variants()
    met, warmed = engine._packed_lengths, engine._warm_lengths
    libs = ("" if engine.device.type != "cuda" else
            f"; {libraries_built} kernel librar{'y' if libraries_built == 1 else 'ies'} "
            f"built during the audited steps")
    if not warmed:
        return Finding("fused_ragged", "cache-sentinel", libraries_built == 0,
                       f"{len(met)} packed length(s) met (no warmup baseline){libs}")
    off = sorted(met - warmed)
    ok = not off and libraries_built == 0
    return Finding(
        "fused_ragged", "cache-sentinel", ok,
        f"{len(met)} packed length(s) met vs {len(warmed)} warmed" + libs
        + (f" — off-bucket packed length(s) {off} ran" if off else ""))


# ----------------------------------------------------------- program audit
def audit_program(engine, contract: StepContract,
                  traces: Optional[List[StepTrace]] = None) -> List[Finding]:
    """Run one step program under the instruments and check its contract;
    returns findings for the collective census, the host-sync scan and (if
    required) the int8 flow. ``traces``, if given, receives the call's
    ``StepTrace`` (the census with each collective's bytes). A contract
    that allows host syncs runs without ``set_sync_debug_mode``."""
    fn, args = engine.step_program(contract.program)
    kv = engine.kv
    # the audit's own call is a probe, not a serving call: the packed
    # length it runs does not count against the sentinel
    met = set(engine._packed_lengths)
    try:
        trace = trace_step(fn, args, pools=(kv.k, kv.v),
                           sync_debug=not contract.allow_host_sync)
    finally:
        engine._packed_lengths = met
    if traces is not None:
        traces.append(trace)
    findings: List[Finding] = []

    census = collective_census(trace)
    problems = []
    if census.get("all-gather", 0) > contract.max_all_gather:
        problems.append(f"all-gather={census['all-gather']} > {contract.max_all_gather}")
    for kind in contract.forbid_kinds:
        if census.get(kind, 0):
            problems.append(f"{kind}={census[kind]} (forbidden)")
    if (contract.max_all_reduce is not None
            and census.get("all-reduce", 0) > contract.max_all_reduce):
        problems.append(f"all-reduce={census['all-reduce']} > {contract.max_all_reduce}")
    if contract.axis_groups:
        names = dict(contract.axis_groups)
        by_axis: Dict[str, int] = {}
        for g in trace.collective_groups:
            axis = names.get(g, "other")
            by_axis[axis] = by_axis.get(axis, 0) + 1
        for axis, n in sorted(by_axis.items()):
            if axis != "model":
                problems.append(f"{n} collective(s) on the {axis} group (none may run there)")
        census_axes = " ".join(f"{a}:{n}" for a, n in sorted(by_axis.items()))
    else:
        census_axes = ""
    ops = sorted({op for _k, op in trace.collectives})
    findings.append(Finding(
        contract.program, "collectives", not problems,
        ("; ".join(problems) if problems else
         " ".join(f"{k}={v}" for k, v in sorted(census.items()) if v) or "collective-free")
        + (f"; by group {census_axes}" if census_axes else "")
        + (f"; ops: {', '.join(ops)}" if ops else "")))

    syncs = find_host_syncs(trace)
    findings.append(Finding(
        contract.program, "host-sync", contract.allow_host_sync or not syncs,
        "none" if not syncs else
        f"host round-trip inside step: {', '.join(sorted(set(syncs)))}"))

    if contract.require_int8_kernel_path:
        reached, upcasts = int8_kernel_flow(trace)
        ok = reached and not upcasts
        if ok:
            detail = "int8 pools reach the paged kernels un-upcast"
        elif not reached:
            detail = ("no paged kernel wrapper receives the int8 pools "
                      "(dequant happens outside the kernel)")
        else:
            detail = "; ".join(sorted(set(upcasts)))
        findings.append(Finding(contract.program, "int8-flow", ok, detail))
    return findings


def default_contracts(engine) -> List[StepContract]:
    """The engine's standing contracts, derived from its configuration:
    every program is all-gather-free; off a mesh every program is
    collective-free; on a mesh (``engine.pool_layout``) the step programs
    may all-reduce at most 2 x num_layers times (the Megatron pair a layer)
    and the bare pool roundtrip not at all (on the card over a gloo group,
    whose all-reduce of a CUDA tensor waits on the stream and goes through
    host memory, the step programs may sync); int8 engines with the paged
    kernels must dequantize in-kernel on the kernelized programs (the fused
    step, the live decode). On a mesh with a "data" axis every program's
    collectives must run on the rank's "model" group: none on its "data"
    group (nor on any other)."""
    layout = getattr(engine, "pool_layout", None)
    on_mesh = layout is not None
    axes = {}
    if on_mesh and layout.dp_degree > 1:
        axes = dict(axis_groups=tuple(mesh_groups(layout).items()))
    ar = 2 * engine.cfg.num_layers if on_mesh else 0
    # a gloo group all-reduces a CUDA tensor through host memory, waiting
    # on the stream: the sharded steps on the card sync by construction
    gloo_sync = on_mesh and engine.device.type == "cuda" and engine._tp_group is not None
    int8k = engine.kv_dtype == "int8" and engine.kernel_impl == "pallas"
    fused = "fused_ragged" if engine.ragged else "fused_padded"
    return [
        StepContract(fused, max_all_reduce=ar, allow_host_sync=gloo_sync,
                     require_int8_kernel_path=int8k, **axes),
        StepContract("decode", max_all_reduce=ar, allow_host_sync=gloo_sync,
                     require_int8_kernel_path=int8k, **axes),
        StepContract("decode_ref", max_all_reduce=ar, allow_host_sync=gloo_sync, **axes),
        StepContract("pool", max_all_reduce=0, **axes),
    ]


def audit_engine(engine, contracts: Optional[Sequence[StepContract]] = None,
                 warm: bool = True) -> AuditReport:
    """Audit every (or the given) step-program contract plus the cache
    sentinel. ``warm=True`` runs ``warmup_step_variants()`` first, so the
    sentinel has its baseline and the audited steps run on built kernels.
    Takes a paged engine (the step programs are the paged backend's)."""
    if engine.backend != "paged":
        raise ValueError("the step audit takes a paged engine; this one is "
                         f"{engine.backend!r}")
    if warm:
        engine.warmup_step_variants()
    report = AuditReport()
    before = _libraries_loaded(engine)
    for c in (default_contracts(engine) if contracts is None else contracts):
        report.findings.extend(audit_program(engine, c))
    report.findings.append(cache_sentinel(
        engine, warm=False, libraries_built=_libraries_loaded(engine) - before))
    return report
