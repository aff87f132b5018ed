"""Generation engine: continuous batching on the paged KV cache or a dense
per-slot cache, ported from ``repro.serving.engine``.

The serving loop of the JAX package's main path —
``GenerationEngine(backend="paged", interleave=True, ragged=True,
pipeline=True)`` — on PyTorch:

    submit(prompt) -> admission (prefix sharing) -> one StepPlan per step
    (decode rows + prefill chunks packed in one flat token buffer, bounded
    by a token budget) -> device step -> sample -> stream tokens out.

A host-side ``ControlPlane`` builds an immutable ``StepPlan`` per step and a
``DeviceRunner`` dispatches it: mixed steps run ``models.prefill_packed``
(attention through ``kernels.paged_chunk_attention``), decode-only steps run
``models.decode_step_paged`` (``kernels.paged_decode_attention``).
``pipeline=True`` materializes sampled tokens one plan late, so plan N+1 is
built while step N runs on the card; ``pipeline=False`` is the eager
oracle, greedy-token-identical. Token delivery is out of band through
per-request ``StreamingObject``s and one shared ``PriorityFlusher``.

``kv_dtype="int8"`` (the default for a ``cfg.kv_cache_quant`` config) stores
the paged pools as int8 with per-(block, KV head) running-max scales: the
step programs quantize at scatter time (plain tensor ops) and the two paged
kernels dequantize as they read.

Pool exhaustion preempts the youngest request. ``preempt="recompute"``
releases its blocks and re-queues its continuation; ``"swap"`` parks its
block chain in the host tier (``serving.host_tier.HostBlockStore``) and
restores it on re-admission without repaying the prefill; ``"cost"`` picks
per victim from a swap-versus-recompute cost model. The host tier
(``host_store``/``host_blocks``, provisioned automatically for swap and
cost) also takes the warm blocks the pool evicts, and admission promotes
them back. Device->host copies (swap fills, demotions) are gathered when
they are enqueued and land through a ``CopyEngine`` drained between
dispatches.

``backend="dense"`` is the JAX package's parity oracle and the fallback for
architectures outside the paged contract: a contiguous (G, B, max_seq, KVH,
hd) cache, each admitted request prefilled whole (``models.forward``, its
attention through ``kernels.flash_attention``) at a power-of-two bucket
capped at ``max_seq``, then one batched ``models.decode_step`` per step
(``kernels.decode_attention``). Segmented prompts are served flat. An
RWKV-6 stack (rwkv6-7b; ``backend="paged"`` falls back to it, as in JAX)
keeps a per-slot recurrent state instead, prefilled at the prompt's own
length: zero pad tokens would enter the state, so the port does not pad
where the JAX engine does (ROADMAP §3). Its recurrences run through
``kernels.rwkv6_scan.rwkv6_chunked``. A hybrid stack (hymba-1.5b) is
prefilled unpadded too, its meta tokens first: each row keeps a ring of
min(max_seq + M, window) K/V slots beside its SSM state, and decodes at
absolute position M + its text position (``kernels.flash_attention`` with a
window, ``kernels.decode_attention``, ``kernels.ssm_scan.ssm_scan``). A
sliding-window stack (qwen2.5-3b-swa, mixtral-8x22b) is prefilled unpadded
as well, into a ring of min(max_seq, window) K/V slots: a bucket longer than
the window would keep its pad tokens' keys in place of the prompt's last
ones (ROADMAP §3). An MoE layer's feed-forward (mixtral-8x22b) is
``models.moe``, plain torch on any device. internvl2-1b is served text
only, padded to its bucket, as the JAX dense engine serves it (its patch
prefix reaches the model through the model API alone). A
``kv_cache_quant`` config on the dense backend keeps the int8 dense cache:
int8 K/V with per-slot, per-KV-head float32 scales, dequantized whole
before each decode attention, as in JAX. An encoder-decoder (whisper) is
refused with a ``ValueError``: the engine has no frames input, and the JAX
engine cannot serve one either.

The paged backend keeps the JAX engine's oracle paths: ``interleave=False``
is the sequential loop (blocking chunked prefill at admission, one
request at a time, then one batched decode per step), ``ragged=False`` the
padded mixed batch (every row a chunk-width slab; needs
``kernel="reference"``), and ``kernel="reference"`` reads attention through
the gather oracles: the ragged step through ``ref_paged_chunk_attention``,
decode plans through the gathered contiguous view and the dense
``decode_step`` (whose attention is the dense ``decode_attention`` kernel
on the card). ``kernel="pallas"`` (the port's default; JAX defaults to
``"reference"``) reads attention through the paged kernels. Each gives the
JAX engine's plans and greedy tokens under the same settings. ``sanitize=True`` shadows every
block lifecycle transition of the pool, the host tier and the copy engine
in an ``analysis.kvsan.KVSanitizer`` (``self.sanitizer``).

The engine runs on ``cuda`` unless ``device="cpu"`` is passed. The
attention wrappers launch the CUDA kernels for CUDA tensors and run their
plain PyTorch versions for CPU tensors; ``stats()["kernel"]`` says which,
``stats()["kernel_impl"]`` which selector the engine was given.
``DataParallelEngineGroup`` runs DP replicas over block ranges of one
shared pool on one device (``kv=`` injects a replica's cache), and
``step_program(which)`` hands each step program to the step audit
(``analysis.step_audit``). ``mesh=`` / ``pool_layout=`` (a
``serving.sharded_pool.ShardedPoolLayout`` over a "model" axis) make the
engine one rank of a tensor-parallel group, SPMD over processes: every
rank runs the same host logic, holds its shard of the weights and ``KVH /
tp`` heads of every pool block, and each step program ends its layers'
attention output and MLP down projections in one all-reduce each (the
engine passes its group as the step functions' ``tp_group``). On a mesh
with a "data" axis a lone engine is replicated over it: every row runs the
same engine on its "model" group (a layout with ``dp_blocks=True`` is the
group's: ``DataParallelEngineGroup``). As in JAX, a mesh takes
``kernel="reference"`` and float pools only.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import QueuePolicy, make_policy
from repro_torch.core.streaming import PriorityFlusher, StreamingObject
from repro_torch.core.telemetry import Recorder, clock
from repro_torch.models import (
    decode_step,
    decode_step_paged,
    dense_cache_supported,
    forward,
    init_cache,
    init_params,
    paged_cache_supported,
    prefill_chunk,
    prefill_packed,
    prefills_unpadded,
)
from repro_torch.serving.control_plane import ControlPlane, CopyEngine
from repro_torch.serving.device_runner import (
    DeviceRunner,
    PlanExec,
    _substitute_packed,
)
from repro_torch.serving.host_tier import HostBlockStore
from repro_torch.params import torch_dtype
from repro_torch.serving.paged_cache import (
    PagedKVCache,
    device_to_host,
    gather_paged_batch,
    gather_paged_batch_dq,
    write_paged_chunk,
    write_paged_chunk_batch,
    write_paged_chunk_batch_q,
    write_paged_chunk_q,
)
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.segments import KIND_DOC, SegmentedPrompt, build_layout

_NULL_SEQ = -1  # owner of the reserved scratch block


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.0
    priority: float = 0.0            # predicted slack (EDF); smaller = more urgent
    out_tokens: List[int] = field(default_factory=list)
    slot: int = -1
    pos: int = 0
    prefill_pos: int = 0             # cache slots already populated (computed/shared)
    prefill_cap: int = 0             # effective prompt length (post-truncation)
    done: bool = False
    truncated: bool = False          # prompt exceeded engine capacity
    shared_prefix_tokens: int = 0    # prompt tokens served from shared blocks
    host_prefix_tokens: int = 0      # non-session prompt tokens promoted from host
    # session-history hit tokens: a SUBSET of shared_prefix_tokens, and
    # DISJOINT from host_prefix_tokens (host promotions split doc/session)
    session_shared_tokens: int = 0
    session_host_tokens: int = 0
    segprompt: Optional[SegmentedPrompt] = None  # retrieval-aware structure
    layout: Any = None               # SegmentLayout (built at admission)
    probe_layout: Any = None         # residency-probe layout (pre-admission)
    shared_spans: List = field(default_factory=list)  # token ranges served from cache
    swapped: bool = False            # KV chain parked in the host tier
    swap_len: int = 0                # cache length to restore on swap-in
    # stamps on telemetry.clock; admission's are the first admission's
    # (preemption and swap-in keep them)
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    submitted_step: int = 0          # the engine's step count at submission
    admitted_step: Optional[int] = None  # and at admission
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    token_gaps: List[float] = field(default_factory=list)  # inter-token intervals
    max_token_gap: float = 0.0       # worst inter-token stall (decode SLO signal)
    planned: int = 0                 # tokens scheduled by plans (>= len(out_tokens))
    _tok_src: tuple = (-1, -1)       # (plan_id, row) holding the last sampled token
    swap_keys: List = field(default_factory=list)  # prefix keys of the swap chain
    stream: Optional[StreamingObject] = None       # out-of-band token delivery
    delivered: List[int] = field(default_factory=list)  # tokens flushed downstream

    @property
    def prefilling(self) -> bool:
        return self.slot >= 0 and self.prefill_pos < self.prefill_cap

    @property
    def queued_steps(self) -> int:
        """Engine steps between submission and admission (0 until admitted)."""
        return 0 if self.admitted_step is None else self.admitted_step - self.submitted_step

    def stamp_admitted(self, steps: int) -> None:
        """Stamp the first admission (``steps``: the engine's step count)."""
        if self.admitted_at is None:
            self.admitted_at = clock()
            self.admitted_step = steps

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of the (truncated) prompt served from shared blocks."""
        return self.shared_prefix_tokens / self.prefill_cap if self.prefill_cap else 0.0

    @property
    def host_hit_rate(self) -> float:
        """Fraction of the prompt promoted from the host tier, session-history
        promotions excluded (``session_hit_rate``)."""
        return self.host_prefix_tokens / self.prefill_cap if self.prefill_cap else 0.0

    @property
    def session_hit_rate(self) -> float:
        """Fraction of the prompt that is session history promoted from the
        host tier (disjoint from ``host_hit_rate``)."""
        return self.session_host_tokens / self.prefill_cap if self.prefill_cap else 0.0


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


def normalize_spans(spans) -> List:
    """Sorted, disjoint, coalesced ``[lo, hi)`` spans (empties dropped) —
    the normal form the cursor/grant helpers below assume."""
    out: List = []
    for lo, hi in sorted((int(s), int(e)) for s, e in spans if e > s):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _advance_cursor(req: Request) -> None:
    """Skip the prefill cursor over cache-served spans (shared blocks
    already hold the K/V); never past an uncached gap."""
    for s, e in req.shared_spans:
        if s <= req.prefill_pos < e:
            req.prefill_pos = e
        elif s > req.prefill_pos:
            break
    req.prefill_pos = min(req.prefill_pos, req.prefill_cap)


def _max_grant(req: Request, limit: int) -> int:
    """Largest prefill chunk startable at the cursor: clipped by the chunk
    size, the prompt end, and the next shared span (shared blocks are
    immutable — a chunk must never write into them)."""
    c = min(limit, req.prefill_cap - req.prefill_pos)
    for s, _e in req.shared_spans:
        if s > req.prefill_pos:
            c = min(c, s - req.prefill_pos)
            break
    return max(c, 0)


class GenerationEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params=None,
        max_batch: int = 4,
        max_seq: int = 256,
        seed: int = 0,
        eos_token: int = -1,
        backend: str = "paged",
        block_size: int = 16,
        prefill_chunk_size: int = 64,
        n_blocks: Optional[int] = None,
        prefix_sharing: bool = True,
        interleave: bool = True,
        token_budget: Optional[int] = None,
        scheduler: Any = "fifo",
        max_finished: int = 10_000,
        mesh: Any = None,
        pool_layout: Any = None,
        kv: Any = None,
        preempt: str = "recompute",
        host_store: Any = None,
        host_blocks: Optional[int] = None,
        pipeline: bool = True,
        flusher: Optional[PriorityFlusher] = None,
        host_bw_bytes_s: float = 8e9,
        copy_budget: int = 4,
        kernel: str = "pallas",
        ragged: bool = True,
        pack_align: int = 4,
        kv_dtype: Optional[str] = None,
        sanitize: bool = False,
        device=None,
    ):
        """``device`` is where the pools, weights and steps live: ``cuda``
        by default (raises without a GPU), ``"cpu"`` for the plain versions.
        ``params`` (the ``init_params`` tree, e.g. from
        ``params.params_from_numpy``) default to ``init_params`` drawn from a
        ``torch.Generator`` seeded with ``seed``; sampled rows draw from a
        generator seeded with ``seed + 1``. ``host_store`` (a
        ``HostBlockStore``) or ``host_blocks`` (the size of a fresh one,
        pinned on ``cuda``) attach the host tier, which ``preempt="swap"``
        and ``"cost"`` provision pool-sized when neither is given;
        ``host_bw_bytes_s`` is the cost model's host-link rate. ``kernel``
        is ``"pallas"`` (the hand-written paged kernels; the port's default)
        or ``"reference"`` (the gather oracles), as in the JAX engine, whose
        default is ``"reference"``; ``"pallas"`` requires ``ragged=True``.
        ``kv`` injects a ``PagedKVCache`` (a DP replica's, over a block
        range of a shared pool box): it decides the pool format, brings its
        host store and, when ``device`` is not given, the device; with a
        layout, ``params`` given beside it are taken as already placed (the
        group's shard). The other arguments mean what they mean in the JAX
        engine."""
        on_mesh = mesh is not None or pool_layout is not None or (
            kv is not None and kv.layout is not None)
        if kernel == "pallas" and on_mesh:
            raise ValueError(
                "kernel='pallas' is single-device only: the Pallas paged kernels do not "
                "partition under shard_map meshes yet")
        if on_mesh and (kv_dtype is not None or cfg.kv_cache_quant):
            raise ValueError(
                "kv_dtype='int8' is single-device only: the parallel scale pools do not "
                "shard over a mesh yet")
        if kv is not None and device is None:
            device = kv.device
        if backend not in ("paged", "dense"):
            raise ValueError(f"unknown backend {backend!r}")
        if preempt not in ("recompute", "swap", "cost"):
            raise ValueError(f"unknown preempt strategy {preempt!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        if kernel not in ("reference", "pallas"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if kernel == "pallas" and not ragged:
            raise ValueError("kernel='pallas' requires the ragged fused layout: the "
                             "chunk kernel consumes the packed token buffer")
        if not paged_cache_supported(cfg):
            # JAX serves such archs on the dense backend; the port's covers
            # the stacks of dense_cache_supported
            if not dense_cache_supported(cfg):
                raise NotImplementedError(
                    f"{cfg.name} is outside the paged contract and the port's dense stacks")
            if cfg.is_encoder_decoder:
                raise ValueError(
                    f"{cfg.name} is an encoder-decoder: the engine takes token prompts and no "
                    "encoder frames, so it cannot serve one, and neither can the JAX engine "
                    "(its dense prefill calls forward without frames); use the model API "
                    "(forward, prefill, decode_step)")
            backend = "dense"
        if on_mesh and backend != "paged":
            raise ValueError(f"a mesh shards the paged backend; {cfg.name} is served on "
                             f"the {backend} backend")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_token = eos_token
        self.backend = backend
        self.interleave = interleave and backend == "paged"
        self.ragged = bool(ragged)
        self.kernel = "cuda" if self.device.type == "cuda" else "plain"
        self.kernel_impl = kernel
        self.scheduler: QueuePolicy = make_policy(scheduler)
        # never mutate a caller-supplied policy: bind residency into a copy
        if isinstance(scheduler, QueuePolicy):
            self.scheduler = copy.copy(self.scheduler)
        self.scheduler.bind_residency(self._residency)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.waiting: List[Request] = []
        # rolling window of completed requests backing latency_summary()
        self.finished: List[Request] = []
        self.max_finished = max_finished
        self._next_id = 0
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.steps = 0
        self.tokens_out = 0
        self.prefill_tokens = 0
        self.preemptions = 0
        # spans of each step and the admission counters (core.telemetry)
        self.telemetry = Recorder()
        self.swap_outs = 0
        self.swap_ins = 0
        self.swap_out_bytes = 0          # host-tier bytes parked by swap-outs
        self.swap_in_bytes = 0           # and copied back by swap-ins
        self.cost_swap_choices = 0
        self.cost_recompute_choices = 0
        self.swap_reshared_blocks = 0
        self.preempt = preempt
        self.host_store = host_store
        self.host_bw_bytes_s = host_bw_bytes_s
        self.kv_dtype = None
        self.pack_align = max(int(pack_align), 1)
        # fused-batch occupancy: device slots dispatched vs slots holding a
        # real token (1 - valid/slot is the padded fraction)
        self.fused_slot_tokens = 0
        self.fused_valid_tokens = 0
        self.pipeline = bool(pipeline) and self.interleave
        self.flusher = flusher if flusher is not None else PriorityFlusher()
        self.copy_budget = copy_budget
        self._copy = CopyEngine()
        self._inflight: Optional[PlanExec] = None
        self._build_emitted: Optional[Dict[int, List[int]]] = None
        self.sanitizer = None
        self.pool_layout = None
        self._tp_group = None
        if self.backend == "dense":
            # a row's cache holds its meta tokens too (a hybrid layer's
            # K/V: a ring of min(max_seq + M, window) slots); int8 with its
            # scales for cfg.kv_cache_quant
            self.cache = init_cache(cfg, max_batch, max_seq + cfg.num_meta_tokens, self.device)
            return

        self.block_size = block_size
        self.max_blocks = -(-max_seq // block_size)
        self.prefill_chunk_size = prefill_chunk_size
        # budget for one step's valid tokens (decode rows + prefill chunks)
        self.token_budget = token_budget or (max_batch + prefill_chunk_size)
        self._view_blocks = self.max_blocks + -(-prefill_chunk_size // block_size)
        if n_blocks is None:
            # full provisioning: every slot can reach max_seq (+ slack), +1 scratch
            n_blocks = max_batch * (self.max_blocks + 1) + 1
        if kv_dtype is None and cfg.kv_cache_quant:
            kv_dtype = "int8"  # quant configs store int8 pools
        if pool_layout is None and mesh is not None:
            from repro_torch.serving.sharded_pool import ShardedPoolLayout

            pool_layout = ShardedPoolLayout(mesh)
        if kv is not None and kv.layout is not None:
            pool_layout = kv.layout
        # the config of the step programs' layers: a rank's heads and MLP
        # columns on a mesh, where the weights become this rank's shard once,
        # at construction (deployment), never a step
        step_cfg = cfg
        if pool_layout is not None:
            pool_layout.validate(cfg)
            if kv is None and pool_layout.splits_blocks(cfg, n_blocks):
                raise ValueError(
                    "a lone engine addresses the whole pool, and dp_blocks=True splits it over "
                    "the data axis: serve replicas over block ranges through "
                    "DataParallelEngineGroup, or keep the blocks whole (dp_blocks=False)")
            # an injected cache is a group's replica: the group placed the
            # params it passes, once for all its replicas
            if kv is None or params is None:
                self.params = pool_layout.place_params(cfg, self.params)
            step_cfg = pool_layout.local_config(cfg)
            self._tp_group = pool_layout.tp_group
        self.pool_layout = pool_layout
        self._step_cfg = step_cfg
        if kv is not None:
            self.kv = kv
            kv_dtype = kv.kv_dtype  # the injected cache decides the pool format
            if self.host_store is None:
                self.host_store = kv.host_store  # a DP group's shared tier
        else:
            if self.host_store is None and (host_blocks or preempt in ("swap", "cost")):
                self.host_store = HostBlockStore.for_config(
                    step_cfg, host_blocks or n_blocks, block_size, kv_dtype=kv_dtype,
                    pin=self.device.type == "cuda")
            self.kv = PagedKVCache(cfg, n_blocks, block_size, self.max_blocks,
                                   prefix_sharing=prefix_sharing, device=self.device,
                                   layout=pool_layout, host_store=self.host_store,
                                   kv_dtype=kv_dtype, sanitize=sanitize)
        self.kv_dtype = kv_dtype
        # one sanitizer (if any) shadows the pool, the host store and the
        # copy engine's tag queue (the swap-in sync(tag) happens-before edge)
        self.sanitizer = self.kv.sanitizer
        self._copy.sanitizer = self.sanitizer
        # the oracle steps run the stack over gathered float views (an int8
        # pool is dequantized by the gather, requantized by the _q writes),
        # never through the dense int8 cache
        self._oracle_cfg = (step_cfg.replace(kv_cache_quant=False) if step_cfg.kv_cache_quant
                            else step_cfg)
        # decode plans: the paged decode kernel, or the gather oracle
        self._decode_dispatch = (self._decode_step if kernel == "pallas"
                                 else self._decode_paged)
        # reserved scratch block: swallows pad-token and unbacked writes (its
        # id as the device array's: the pool's ids rebased by its base)
        self._null_block = self.kv.pool.allocate(_NULL_SEQ, 1)[0] - self.kv.pool.base
        # the cache's demotions and write-through copies and the engine's
        # swap-set fills drain through the copy engine between dispatches
        self.kv.copy_engine = self._copy
        self.control = ControlPlane(self)
        self.runner = DeviceRunner(self)
        # the packed lengths the ragged step has run, and those warmup ran:
        # the audit's cache sentinel holds the first to the second
        self._packed_lengths: set = set()
        self._warm_lengths: set = set()

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_new: int = 16, temperature: float = 0.0,
               priority: float = 0.0) -> Request:
        """``prompt`` is a flat token array, or a ``SegmentedPrompt`` whose
        per-document segments enable order-independent KV reuse."""
        segprompt = prompt if isinstance(prompt, SegmentedPrompt) else None
        if segprompt is not None:
            prompt = segprompt.tokens
        prompt = np.atleast_1d(np.asarray(prompt, np.int32))
        if prompt.size == 0:
            prompt = np.zeros(1, np.int32)  # empty prompt: decode from pad token
            segprompt = None
        req = Request(self._next_id, prompt, max_new, temperature, priority)
        req.segprompt = segprompt
        req.submitted_at = clock()
        req.submitted_step = self.steps
        # out-of-band delivery through the shared PriorityFlusher, EDF order
        req.stream = StreamingObject(priority=priority)
        req.stream.on_chunk(self._make_chunk_cb(req))
        self._next_id += 1
        self.waiting.append(req)
        return req

    def _make_chunk_cb(self, req: Request):
        def cb(chunk):
            if chunk is None:
                return  # EOS marker: nothing left to transport
            self.flusher.submit(req.stream, chunk, req.delivered.extend)
        return cb

    @property
    def pending(self) -> bool:
        """True while a dispatched plan's tokens await materialization."""
        return self._inflight is not None

    def run_until_done(self, max_steps: int = 10_000) -> None:
        while (self.waiting or any(self.slots) or self.pending) and max_steps:
            self.step()
            max_steps -= 1
        self._drain_copies(full=True)
        self.flusher.flush()

    def stats(self) -> Dict[str, Any]:
        s: Dict[str, Any] = {
            "backend": self.backend,
            "interleave": self.interleave,
            "pipeline": self.pipeline,
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            "prefill_tokens": self.prefill_tokens,
            "preemptions": self.preemptions,
            "stream_backlog": self.flusher.backlog,
            "kernel": self.kernel,
            "device": str(self.device),
            "telemetry": self.telemetry.snapshot(),
        }
        if self.backend != "paged":
            return s
        s.update({
            "utilization": self.kv.utilization(),
            "prefix_hit_tokens": self.kv.shared_token_hits,
            "host_hit_tokens": self.kv.host_token_hits,
            "session_hit_tokens": self.kv.session_host_token_hits,
            "session_shared_tokens": self.kv.session_token_hits,
            "free_blocks": self.kv.pool.n_free,
            "measured_hit_rate": self.measured_hit_rate(),
            "measured_host_hit_rate": self.measured_host_hit_rate(),
            "measured_session_hit_rate": self.measured_session_hit_rate(),
            "preempt": self.preempt,
            "kv_dtype": self.kv_dtype or self.cfg.dtype,
            "tp_degree": self.pool_layout.tp_degree if self.pool_layout else 1,
            "kernel_impl": self.kernel_impl,
            "ragged": self.ragged,
            "fused_slot_tokens": self.fused_slot_tokens,
            "fused_valid_tokens": self.fused_valid_tokens,
            "padded_token_fraction": (
                1.0 - self.fused_valid_tokens / self.fused_slot_tokens
                if self.fused_slot_tokens else 0.0
            ),
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swap_out_bytes": self.swap_out_bytes,
            "swap_in_bytes": self.swap_in_bytes,
            "swap_reshared_blocks": self.swap_reshared_blocks,
            "cost_swap_choices": self.cost_swap_choices,
            "cost_recompute_choices": self.cost_recompute_choices,
            "copy_backlog": self._copy.backlog,
            "copy_ops_drained": self._copy.drained,
            "stream_chunk_size": self.control.last_chunk_size,
        })
        s.update(self.runner.summary())
        if self.host_store is not None:
            s["host_store"] = self.host_store.stats()
        return s

    @torch.no_grad()
    def warmup_step_variants(self) -> int:
        """Run every packed fused-step length once, off the serving clock:
        the first call builds the CUDA kernels, and each length warms the
        caching allocator for its shapes. The packed length is bounded by
        the token budget (+1 floor grant) and by B * C. Each call packs only
        pad tokens (``row_of = -1``), whose K/V writes land in the scratch
        block, so no request state changes. Returns the number of lengths
        run (0 on the dense backend and the paged oracle paths, which have
        no packed step)."""
        if self.backend != "paged" or not self.interleave or not self.ragged:
            return 0
        B, C = self.max_batch, self.prefill_chunk_size
        cap = min(max(self.token_budget + 1, B + 1), B * C)
        cap_pad = -(-cap // self.pack_align) * self.pack_align
        dev = self.device
        tables = torch.full((B, self._view_blocks), -1, dtype=torch.int32, device=dev)
        last = torch.zeros((B,), dtype=torch.int32, device=dev)
        no_slot = torch.full((B,), -1, dtype=torch.int32, device=dev)
        n = 0
        for T in range(self.pack_align, cap_pad + 1, self.pack_align):
            z = torch.zeros((T,), dtype=torch.int32, device=dev)
            pad = torch.full((T,), -1, dtype=torch.int32, device=dev)
            toks = _substitute_packed(z, last, no_slot, last)
            self._ragged_step(tables, toks, pad, z, z, z, z, last)
            self._warm_lengths.add(T)
            n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return n

    def step_program(self, which: str):
        """Return ``(callable, example_args)`` for one of the engine's step
        programs, the entry point of the step audit
        (``analysis.step_audit``):

        * ``"fused_ragged"`` — the packed mixed-batch step (``_ragged_step``,
          the main path), against a packed buffer of
          ``ceil(B * C / pack_align) * pack_align`` tokens.
        * ``"fused_padded"`` — the padded fused step (``_fused_step``, the
          oracle of the ragged one).
        * ``"decode"`` — the live decode dispatch: the paged decode kernel
          under ``kernel="pallas"``, else the gather oracle.
        * ``"decode_ref"`` — always the gather-oracle decode.
        * ``"pool"`` — a bare ``gather_paged_batch`` then
          ``write_paged_chunk_batch`` roundtrip of the K pool (the chunk
          scatter in isolation), returning ``(new pool, view)``.

        The callables are the engine's bound step functions (they read the
        params and pools from the engine); the example arguments are shaped
        like real dispatches, as in the JAX engine: pad-only tables, zero
        tokens. A call changes no request state: its writes land in the
        scratch block (the pool program returns a new pool and leaves the
        engine's alone). Call under ``torch.no_grad()``, as the runner does."""
        B, C, dev = self.max_batch, self.prefill_chunk_size, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        tokens = torch.zeros((B, C), **i32)
        starts = torch.zeros((B,), **i32)
        n_valid = torch.ones((B,), **i32)
        seg = torch.zeros((B, C), **i32)
        if which == "fused_ragged":
            T = -(-(B * C) // self.pack_align) * self.pack_align
            flat = torch.zeros((T,), **i32)
            tables = torch.full((B, self._view_blocks), -1, **i32)
            return self._ragged_step, (tables, flat, flat, flat, flat, flat, flat,
                                       torch.zeros((B,), **i32))
        if which == "fused_padded":
            tables = torch.full((B, self._view_blocks), self._null_block, **i32)
            return self._fused_step, (tables, tokens, starts, n_valid, seg, seg, seg)
        if which in ("decode", "decode_ref"):
            tables = torch.full((B, self.max_blocks), self._null_block, **i32)
            fn = self._decode_dispatch if which == "decode" else self._decode_paged
            return fn, (tables, tokens[:, :1].contiguous(), starts)
        if which == "pool":
            bs, null = self.block_size, self._null_block

            def roundtrip(k_pool, tables, starts, new_kv, n_valid):
                view = gather_paged_batch(k_pool, tables)
                out = write_paged_chunk_batch(k_pool, tables, starts, new_kv, bs, n_valid,
                                              null)
                return out, view

            k = self.kv.k
            G, KVH, hd = k.shape[0], k.shape[3], k.shape[4]
            new_kv = torch.zeros((G, B, C, KVH, hd), dtype=k.dtype, device=dev)
            tables = torch.full((B, self._view_blocks), self._null_block, **i32)
            return roundtrip, (k, tables, starts, new_kv, n_valid)
        raise ValueError(f"unknown step program {which!r}")

    def audit_collectives(self, which: str = "fused", by_group: bool = False) -> Dict[str, Any]:
        """Collective census of one call of a step program (the step audit's
        probe, ``models.shardmap_tp.count_collectives``): ``"fused"`` (the
        mixed step), ``"decode"`` (the gather-oracle decode) or ``"pool"``
        (the bare pool roundtrip) -> kind -> count, and kind + "_bytes" ->
        the bytes handed to them; with ``by_group``, that census for each of
        the rank's "model" and "data" groups (``analysis.step_audit.
        group_census``). On a mesh the step programs show only the Megatron
        all-reduces, on the "model" group, and the pool roundtrip none."""
        from repro_torch.analysis.step_audit import group_census, trace_step
        from repro_torch.models.shardmap_tp import count_collectives

        alias = {"fused": "fused_ragged" if self.ragged else "fused_padded",
                 "decode": "decode_ref"}
        fn, args = self.step_program(alias.get(which, which))
        met = set(self._packed_lengths)
        try:
            if by_group:
                return group_census(trace_step(fn, args), self.pool_layout)
            return count_collectives(fn, args)
        finally:
            self._packed_lengths = met

    # token-weighted windows below this many prompt tokens are "cold"
    hit_rate_min_tokens: int = 64
    cold_start_hit_rate: float = 0.0

    # cursor helpers shared with the control plane
    _advance_cursor = staticmethod(_advance_cursor)
    _max_grant = staticmethod(_max_grant)

    def _measured_rate(self, hit_tokens, window: int, min_tokens: Optional[int],
                       default: Optional[float]) -> float:
        """Rolling token-weighted hit rate of one tier (``hit_tokens`` of a
        finished request) over the last ``window`` finished requests; below
        ``min_tokens`` prompt tokens in the window, ``default`` (or the
        cold-start rate)."""
        done = [r for r in (self.finished[-window:] if window > 0 else [])
                if r.prefill_cap > 0]
        total = sum(r.prefill_cap for r in done)
        lo = self.hit_rate_min_tokens if min_tokens is None else min_tokens
        if total < max(lo, 1):
            return self.cold_start_hit_rate if default is None else default
        return sum(hit_tokens(r) for r in done) / total

    def measured_hit_rate(self, window: int = 256,
                          min_tokens: Optional[int] = None,
                          default: Optional[float] = None) -> float:
        """Rolling token-weighted prefix (device-shared) hit rate."""
        return self._measured_rate(lambda r: r.shared_prefix_tokens,
                                   window, min_tokens, default)

    def measured_host_hit_rate(self, window: int = 256,
                               min_tokens: Optional[int] = None,
                               default: Optional[float] = None) -> float:
        """Rolling token-weighted host-tier hit rate (non-session tokens)."""
        return self._measured_rate(lambda r: r.host_prefix_tokens,
                                   window, min_tokens, default)

    def measured_session_hit_rate(self, window: int = 256,
                                  min_tokens: Optional[int] = None,
                                  default: Optional[float] = None) -> float:
        """Rolling token-weighted session-history host hit rate."""
        return self._measured_rate(lambda r: r.session_host_tokens,
                                   window, min_tokens, default)

    def latency_summary(self) -> Dict[str, float]:
        """TTFT/TPOT/e2e percentiles (seconds) over finished requests, the
        hit rates of both tiers, and on the paged backend the measured host gap —
        wall time the device sat idle between the end of one dispatched step
        and the next dispatch (total and per-dispatch mean)."""
        done = [r for r in self.finished
                if r.first_token_at is not None and r.finished_at is not None]
        out: Dict[str, float] = {"n_finished": float(len(done))}
        if self.backend == "paged":
            rs = self.runner.summary()
            out["host_gap_total_s"] = float(rs["host_gap_s"])
            out["host_gap_mean_s"] = float(rs["host_gap_mean_s"])
            out["dispatches"] = float(rs["dispatches"])
        if not done:
            return out
        ttft = [r.first_token_at - r.submitted_at for r in done]
        e2e = [r.finished_at - r.submitted_at for r in done]
        tpot = [g for r in done for g in r.token_gaps]
        gaps = [r.max_token_gap for r in done if len(r.out_tokens) > 1]
        for name, xs in (("ttft", ttft), ("tpot", tpot), ("e2e", e2e), ("gap", gaps)):
            if xs:
                out[f"{name}_p50"] = float(np.percentile(xs, 50))
                out[f"{name}_p95"] = float(np.percentile(xs, 95))
        out["ttft_mean"] = float(np.mean(ttft))
        capped = [r for r in done if r.prefill_cap > 0]
        if capped:
            total = sum(r.prefill_cap for r in capped)
            out["prefix_hit_rate"] = float(
                sum(r.shared_prefix_tokens for r in capped) / total)
            out["prefix_hit_rate_p50"] = float(
                np.percentile([r.prefix_hit_rate for r in capped], 50))
            out["host_hit_rate"] = float(
                sum(r.host_prefix_tokens for r in capped) / total)
            out["session_hit_rate"] = float(
                sum(r.session_host_tokens for r in capped) / total)
        return out

    def _residency(self, req: Request) -> float:
        """Eviction-aware admission signal: fraction of a waiting request's
        prompt whose keyed blocks are resident — device-indexed blocks weigh
        1.0, host-tier blocks 0.5 (a promotion still costs a copy); 0 on the
        dense backend, which shares nothing."""
        if self.backend != "paged" or not self.kv.prefix_sharing:
            return 0.0
        lay = req.layout if req.layout is not None else req.probe_layout
        if lay is None:
            lay = build_layout(
                req.segprompt if req.segprompt is not None else req.prompt,
                self.block_size, self._prompt_cap(req),
            )
            req.probe_layout = lay
        host = self.kv.host_store
        tok = 0.0
        for key in lay.block_keys:
            if key is None:
                continue
            if key in self.kv._prefix_index:
                tok += self.block_size
            elif host is not None and host.contains(key):
                tok += 0.5 * self.block_size
        return tok / max(lay.n_tokens, 1)

    # ------------------------------------------------------------ admission
    def _prompt_cap(self, req: Request) -> int:
        # a full-length prompt samples one token from the last-position
        # logits and finishes before any decode write could overflow
        return min(len(req.prompt), self.max_seq)

    def _try_admit(self, req: Request) -> bool:
        if self.backend != "paged":
            return True  # dense: a free slot is the only admission resource
        if req.swapped:
            return self._swap_in(req)
        cap = self._prompt_cap(req)
        if self.kv.pool.blocks_needed(cap + self.block_size) > self.kv.pool.n_owned - 1:
            # can never fit, even with the whole pool free: fail the request
            # instead of wedging the queue
            req.done = True
            req.truncated = True
            req.finished_at = clock()
            self.finished.append(req)
            if req.stream is not None and not req.stream.closed:
                req.stream.close()
            return False
        layout = build_layout(
            req.segprompt if req.segprompt is not None else req.prompt,
            self.block_size, cap,
        )
        adm = self.kv.admit_tokens(req.req_id, req.prompt[:cap], layout)
        if adm is None:
            return False  # backpressure: stays queued until blocks free up
        req.layout = layout
        req.shared_spans = normalize_spans(adm.shared_spans)
        req.shared_prefix_tokens = adm.n_shared
        # host promotions split into the doc/other class and the session-
        # history class: disjoint counters, separately measured rates
        req.host_prefix_tokens = adm.n_host - adm.n_host_session
        req.session_shared_tokens = adm.n_shared_session
        req.session_host_tokens = adm.n_host_session
        return True

    # ----------------------------------------------------- swap preemption
    def _swap_tag(self, req: Request):
        """Store tag of a request's swap set, namespaced by the cache's
        client tag (a store may be shared by caches with their own ids)."""
        return (self.kv.client_tag, req.req_id)

    def _swap_out(self, victim: Request) -> bool:
        """Park a victim's block chain in the host tier. The capacity check
        and slot pinning are synchronous (``reserve_seq``, all-or-nothing:
        False means fall back to recompute); the chain is gathered into a
        fresh device tensor now, behind the steps that wrote it, and its
        copy to host lands through the copy engine (``_swap_in`` syncs the
        tag before reading). The chain's prefix keys are kept
        (``swap_keys``) so re-admission can re-share blocks still indexed."""
        blocks = list(self.kv.pool.tables.get(victim.req_id, []))
        if self.host_store is None or not blocks:
            return False
        tag = self._swap_tag(victim)
        if self.host_store.reserve_seq(tag, len(blocks)) is None:
            return False
        victim.swap_keys = [self.kv._block_key.get(b) for b in blocks]
        # quantized pools park int8 payloads with their per-block scales
        host, wait = device_to_host(*self.kv.gather_blocks(blocks))
        store = self.host_store

        def _fill(host=host, wait=wait):
            wait()
            store.fill_seq(tag, *host)

        self._copy.submit(_fill, tag=tag)
        self.swap_out_bytes += len(blocks) * store.block_bytes
        victim.swap_len = self.kv.lengths.get(victim.req_id, victim.pos)
        victim.swapped = True
        self.kv.release(victim.req_id)
        if victim.slot >= 0 and self.slots[victim.slot] is victim:
            self.slots[victim.slot] = None
        victim.slot = -1
        self.waiting.insert(0, victim)
        self.preemptions += 1
        self.swap_outs += 1
        return True

    def _swap_in(self, req: Request) -> bool:
        """Restore a swapped-out request with its cursor and position state
        as swap-out left them — no prefill is repaid. All-or-nothing: on
        backpressure the swap set stays pinned and the request queued. A
        chain block whose key is still in the device index is re-shared;
        only the other blocks are copied back (with their scales, verbatim,
        for an int8 pool)."""
        tag = self._swap_tag(req)
        self._copy.sync(tag)  # the deferred fill must land before the read
        n = self.host_store.saved_blocks(tag)
        keys = req.swap_keys if len(req.swap_keys) == n else [None] * n
        shared: Dict[int, int] = {}
        if self.kv.prefix_sharing:
            for i, key in enumerate(keys):
                if key is not None:
                    b = self.kv._prefix_index.get(key)
                    if b is not None:
                        shared[i] = b
        n_fresh = n - len(shared)
        n_warm = sum(1 for b in set(shared.values())
                     if self.kv.pool.refcounts.get(b, 0) == 0)
        if n_fresh + n_warm > self.kv.pool.n_free:
            return False  # backpressure: blocks not yet available
        restored = self.host_store.restore_seq(tag)
        fresh_ords: List[int] = []
        fresh_ids: List[int] = []
        for i in range(n):
            if i in shared:
                self.kv.pool.share(req.req_id, shared[i])
            else:
                fresh_ords.append(i)
                fresh_ids.append(self.kv.pool.allocate(req.req_id, 1)[0])
        if fresh_ids:
            sel = torch.as_tensor(fresh_ords, dtype=torch.long)
            self.kv.write_blocks(fresh_ids, *(t[:, sel] for t in restored))
            self.swap_in_bytes += len(fresh_ids) * self.host_store.block_bytes
        self.kv.lengths[req.req_id] = req.swap_len
        self.swap_reshared_blocks += len(shared)
        req.swap_keys = []
        req.swapped = False
        self.swap_ins += 1
        return True

    def _swap_is_cheaper(self, victim: Request) -> bool:
        """Cost model of ``preempt="cost"``: the estimated swap time (the
        chain's bytes over ``host_bw_bytes_s``, both ways) against the
        estimated recompute time (tokens to re-prefill x the runner's
        per-token step time, discounted by the share of the chain still in
        the device prefix index, which re-shares for free)."""
        chain = self.kv.pool.tables.get(victim.req_id, [])
        if self.host_store is None or not chain:
            return False
        shape = self.kv.k.shape  # (G, n_blocks, bs, KVH, hd)
        blk_bytes = 2 * shape[0] * int(np.prod(shape[2:])) * self.kv.k.element_size()
        if self.kv.quantized:
            blk_bytes += 2 * shape[0] * shape[3] * 4  # the f32 scales, k and v
        swap_s = 2.0 * len(chain) * blk_bytes / max(self.host_bw_bytes_s, 1.0)
        tok_s = self.runner.token_time_ema
        if tok_s is None:
            tok_s = 1e-3  # prior before any plan has materialized
        resident = sum(1 for b in set(chain) if b in self.kv._block_key)
        residency = resident / max(len(chain), 1)
        n_tok = self.kv.lengths.get(victim.req_id, victim.pos)
        recompute_s = n_tok * tok_s * (1.0 - residency)
        return swap_s < recompute_s

    # ---------------------------------------------------------- step programs
    def _ragged_step(self, tables, tokens, row_of, slots, positions, p_end,
                     s_start, last_idx):
        """One ragged fused step: T packed tokens read and write the pools
        in place through RAW block tables (``models.prefill_packed``).
        Returns each row's last-valid-token logits (gathered by
        ``last_idx``), so the sampler keeps its (B,) contract. Attention
        reads through the chunk kernel, or under ``kernel="reference"``
        through its gather oracle."""
        self._packed_lengths.add(tokens.shape[0])
        logits = prefill_packed(
            self._step_cfg, self.params, self.kv.k, self.kv.v, tables, tokens,
            row_of, slots, positions, p_end, s_start,
            block_size=self.block_size, null_block=self._null_block,
            k_scales=self.kv.k_scale, v_scales=self.kv.v_scale, impl=self.kernel_impl,
            tp_group=self._tp_group,
        )
        return logits[last_idx.long()]

    def _decode_step(self, tables, tokens, pos):
        """Batched paged decode: each row's new K/V is scattered in place and
        its block chain streams through ``paged_decode_attention``."""
        return decode_step_paged(
            self._step_cfg, self.params, self.kv.k, self.kv.v, tables, tokens, pos,
            block_size=self.block_size, null_block=self._null_block,
            k_scales=self.kv.k_scale, v_scales=self.kv.v_scale, tp_group=self._tp_group,
        )

    # the oracle steps: gathered contiguous views through the dense-cache
    # stack, new K/V written back as new pools (as the JAX step programs do)
    def _views(self, tables):
        """Each row's contiguous view of both pools, (G, B, mb*bs, KVH, hd)
        in the config's dtype (an int8 pool dequantized): one cache entry
        {k, v} for the dense-cache stack."""
        dt = torch_dtype(self.cfg)
        kv = self.kv
        return ({"k": gather_paged_batch_dq(kv.k, kv.k_scale, tables, out_dtype=dt),
                 "v": gather_paged_batch_dq(kv.v, kv.v_scale, tables, out_dtype=dt)},)

    def _write_back(self, write, write_q, tables, starts, newk, newv, n_valid=None):
        """Land new K/V entries in the pools through ``write`` (a float
        pool) or ``write_q`` (an int8 pool, with its scales): the new pools
        replace the old in the cache box. Padding (past ``n_valid``) goes
        to the scratch block."""
        kv, bs, nb = self.kv, self.block_size, self._null_block
        if kv.quantized:
            kv.k, kv.k_scale = write_q(kv.k, kv.k_scale, tables, starts, newk, bs, n_valid, nb)
            kv.v, kv.v_scale = write_q(kv.v, kv.v_scale, tables, starts, newv, bs, n_valid, nb)
        else:
            kv.k = write(kv.k, tables, starts, newk, bs, n_valid, nb)
            kv.v = write(kv.v, tables, starts, newv, bs, n_valid, nb)

    def _prefill_chunk(self, table_row, tokens, start: int, n_valid: int, positions,
                       p_end, s_start):
        """One chunked-prefill step of one request (the sequential path):
        gather its view, run the (1, C) chunk at slot ``start`` through the
        stack (``models.prefill_chunk``), write its ``n_valid`` new entries
        back. Returns the last valid token's logits (V,)."""
        caches = self._views(table_row[None])
        logits, caches = prefill_chunk(self._oracle_cfg, self.params, caches, tokens, start,
                                       positions, p_end, s_start, self._tp_group)
        pc = tokens.shape[1]
        newk = caches[0]["k"][:, 0, start:start + pc]            # (G, C, KVH, hd)
        newv = caches[0]["v"][:, 0, start:start + pc]
        self._write_back(write_paged_chunk, write_paged_chunk_q, table_row, start, newk,
                         newv, n_valid)
        return logits[0, n_valid - 1]

    def _fused_step(self, tables, tokens, starts, n_valid, positions, p_end, s_start):
        """One padded fused step: every row a C-token chunk at its own
        cursor (decode rows one valid token), through the rows' gathered
        views; the valid entries are written back (padding to the scratch
        block). Returns each row's last-valid-token logits (B, V)."""
        caches = self._views(tables)
        logits, caches = prefill_chunk(self._oracle_cfg, self.params, caches, tokens, starts,
                                       positions, p_end, s_start, self._tp_group)
        B, C = tokens.shape
        b = torch.arange(B, device=tokens.device)
        idx = starts.long()[:, None] + torch.arange(C, device=tokens.device)
        newk = caches[0]["k"][:, b[:, None], idx]                # (G, B, C, KVH, hd)
        newv = caches[0]["v"][:, b[:, None], idx]
        self._write_back(write_paged_chunk_batch, write_paged_chunk_batch_q, tables, starts,
                         newk, newv, n_valid)
        return logits[b, (n_valid.long() - 1).clamp(min=0)]

    def _decode_paged(self, tables, tokens, pos):
        """The gather-oracle decode: each row's contiguous view through the
        dense ``decode_step`` (its attention is ``decode_attention``), the
        new entries scattered back at ``pos``. Returns logits (B, V)."""
        logits, caches = decode_step(self._oracle_cfg, self.params, self._views(tables),
                                     tokens, pos, self._tp_group)
        b = torch.arange(tables.shape[0], device=tables.device)
        p = pos.long()
        newk = caches[0]["k"][:, b, p][:, :, None]                # (G, B, 1, KVH, hd)
        newv = caches[0]["v"][:, b, p][:, :, None]
        self._write_back(write_paged_chunk_batch, write_paged_chunk_batch_q, tables, pos,
                         newk, newv)
        return logits

    def _seg_arrays(self, req: Request, pos: int, c: int, width: int) -> tuple:
        """(positions, p_end, s_start) (1, width) slices of the request's
        layout at [pos, pos+c): the segmented prompt's rope positions and
        attention spans of one chunk (padding columns stay zero; n_valid
        masks them downstream)."""
        positions = np.zeros((1, width), np.int32)
        p_end = np.zeros((1, width), np.int32)
        s_start = np.zeros((1, width), np.int32)
        lay = req.layout
        positions[0, :c] = lay.pos_ids[pos : pos + c]
        p_end[0, :c] = lay.attn_p_end[pos : pos + c]
        s_start[0, :c] = lay.attn_s_start[pos : pos + c]
        return positions, p_end, s_start

    @torch.no_grad()
    def _prefill_paged(self, req: Request, slot: int):
        """Sequential path: prefill the admitted request's whole prompt in
        chunks of ``prefill_chunk_size`` (skipping cache-served spans),
        publish its prefix blocks and emit its first token."""
        cap = self._prompt_cap(req)
        req.truncated = cap < len(req.prompt)
        toks = np.asarray(req.prompt[:cap], np.int32)
        pc = self.prefill_chunk_size
        # pad-ok: prefill gathers only blocks already reserved for this
        # request; the gathers and _chunk_dest clamp pads to block 0.
        (table,), _ = self.runner.upload(
            self.kv.pool.table_array([req.req_id], self._view_blocks)[0])
        req.prefill_cap = cap
        req.prefill_pos = 0
        _advance_cursor(req)  # shared blocks already carry their K/V
        last = None
        while req.prefill_pos < cap:
            pos = req.prefill_pos
            C = _max_grant(req, pc)
            chunk = np.zeros((1, pc), np.int32)
            chunk[0, :C] = toks[pos : pos + C]
            arrays, _ = self.runner.upload(chunk, *self._seg_arrays(req, pos, C, pc))
            last = self._prefill_chunk(table, arrays[0], pos, C, *arrays[1:])
            req.prefill_pos = pos + C
            self.prefill_tokens += C
            _advance_cursor(req)
        self.kv.lengths[req.req_id] = cap
        self.kv.register_prefix(req.req_id, toks, req.layout)
        req.slot = slot
        req.pos = cap
        req.prefill_pos = cap
        tok = int(sample_tokens(self._generator, last[None], req.temperature)[0])
        self._emit(req, tok)

    # ----------------------------------------------------------- preemption
    def _preempt(self, victim: Request):
        """Apply the engine's preemption strategy to ``victim``.

        ``swap``: park the block chain in the host tier and re-queue with all
        cursor state intact (``_swap_out``; falls back to recompute when the
        store cannot pin the chain). ``recompute``: release the blocks and
        re-queue the continuation (prompt + generated tokens); re-admission
        re-prefills, reusing any of its prefix blocks that survived in the
        warm cache or the host tier. A mid-prefill victim restarts its
        cursor from scratch. ``cost``: per victim, swap when
        ``_swap_is_cheaper``."""
        # the continuation and the swap snapshot must be complete: land any
        # inflight plan first
        self._sync_inflight()
        strategy = self.preempt
        if strategy == "cost":
            strategy = "swap" if self._swap_is_cheaper(victim) else "recompute"
            if strategy == "swap":
                self.cost_swap_choices += 1
            else:
                self.cost_recompute_choices += 1
        if strategy == "swap" and self._swap_out(victim):
            return
        self.kv.release(victim.req_id)
        if victim.slot >= 0 and self.slots[victim.slot] is victim:
            self.slots[victim.slot] = None
        victim.slot = -1
        if victim.segprompt is not None:
            victim.segprompt = victim.segprompt.extended(victim.out_tokens)
        victim.prompt = np.concatenate(
            [np.asarray(victim.prompt, np.int32),
             np.asarray(victim.out_tokens, np.int32)]
        )
        victim.shared_prefix_tokens = 0
        victim.host_prefix_tokens = 0
        victim.session_shared_tokens = 0
        victim.session_host_tokens = 0
        victim.shared_spans = []
        victim.layout = None
        victim.probe_layout = None  # continuation content changed
        victim.prefill_pos = 0
        victim.prefill_cap = 0
        self.waiting.insert(0, victim)
        self.preemptions += 1

    def _ensure_decode_capacity(self):
        """Every decode-phase slot needs a block backing its next write
        position; preempt youngest-first when the pool runs dry."""
        for r in [r for r in self.slots if r is not None]:
            if r.slot < 0 or self.slots[r.slot] is not r:
                continue  # already preempted this round
            if r.prefilling:
                continue
            while True:
                try:
                    nb = self.kv.pool.extend_for(r.req_id, r.pos + 1)
                    if nb is not None:
                        # a fresh block must not inherit its previous
                        # tenant's absmax (running-max scales)
                        self.kv.reset_block_scales([nb])
                    break
                except MemoryError:
                    active = [x for x in self.slots if x is not None]
                    victim = max(active, key=lambda x: x.req_id)
                    self._preempt(victim)
                    if victim is r:
                        break

    # ------------------------------------------------------------- stepping
    def step(self) -> Dict[int, List[int]]:
        """One engine iteration: the control plane builds one StepPlan and
        the device runner dispatches it; sampled tokens materialize this
        step (``pipeline=False``) or next step (``pipeline=True``). Returns
        the tokens whose emission LANDED this step. The dense backend and
        the sequential paged path (``interleave=False``) admit (blocking
        whole-prompt prefill) and then run one batched decode.

        ``telemetry`` times each step as ``engine.step``; on the interleaved
        path its children are ``plan`` (``ControlPlane.build_plan``, with
        ``plan.admit``), ``launch`` (``DeviceRunner.dispatch``), ``copies``
        (the copy engine's drain), ``wait`` (the wait for a plan's sampled
        tokens) and ``emit`` (landing them, and the stream flush). A
        preemption mid-build lands the inflight plan inside ``plan``."""
        with self.telemetry.span("engine.step"):
            if self.interleave:
                return self._step_interleaved()
            out = self._step_sequential()
            self._drain_copies(full=True)
            self.flusher.flush()
            return out

    def _step_interleaved(self) -> Dict[int, List[int]]:
        rec = self.telemetry
        emitted: Dict[int, List[int]] = {}
        # preemption inside build may have to sync the inflight plan; its
        # emissions land in this step's result
        self._build_emitted = emitted
        try:
            self.runner.probe_idle()
            with rec.span("plan"):
                plan = self.control.build_plan()
        finally:
            self._build_emitted = None
        ex = None
        if plan is not None:
            with rec.span("launch"):
                ex = self.runner.dispatch(plan)
            self.steps += 1
        with rec.span("copies"):
            self._drain_copies(full=ex is None)
        prev, self._inflight = self._inflight, ex
        if prev is not None:
            _merge_emitted(emitted, self._materialize(prev))
        if self._inflight is not None and (not self.pipeline or self.eos_token >= 0):
            # sync oracle — or eos enabled: completion must be observed
            # before the next plan is built, so pipelining degenerates
            cur, self._inflight = self._inflight, None
            _merge_emitted(emitted, self._materialize(cur))
        with rec.span("emit"):
            self.flusher.flush()
        return emitted

    def _materialize(self, ex: PlanExec) -> Dict[int, List[int]]:
        """Land a dispatched plan's emissions: pull the sampled tokens to the
        host, write them to out_tokens + streams, finalize finishing rows."""
        toks = self.runner.materialize(ex)
        emitted: Dict[int, List[int]] = {}
        with self.telemetry.span("emit"):
            for req, row, finishing in ex.plan.emit_rows:
                tok = int(toks[row])
                self._emit_token(req, tok)
                emitted.setdefault(req.req_id, []).append(tok)
                if finishing or tok == self.eos_token:
                    self._finalize(req)
        return emitted

    def _sync_inflight(self) -> None:
        """Materialize the inflight plan NOW (mid-build): preemption must see
        complete out_tokens before capturing a victim's continuation."""
        if self._inflight is None:
            return
        ex, self._inflight = self._inflight, None
        out = self._materialize(ex)
        if self._build_emitted is not None:
            _merge_emitted(self._build_emitted, out)

    def _retire_slot(self, req: Request) -> None:
        """Build-time completion: free the slot and release the block chain
        as soon as the plan decides the request is done, so the next plan
        can reuse both. Stream order guarantees the released blocks' final
        writes land before any later step touches them."""
        if req.slot >= 0 and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        self.kv.release(req.req_id)

    def _drain_copies(self, full: bool = False) -> None:
        """Advance the async copy engine: the whole backlog when ``full``
        (idle steps, drain and exit paths), else up to ``copy_budget`` ops —
        bounded host work per step, scheduled between dispatches."""
        if self.backend == "paged":
            self.kv.flush_write_through()
        self._copy.drain(None if full else self.copy_budget)

    def _prefix_pending(self, req: Request) -> bool:
        """True while an active request is still mid-prefill on content this
        request could share (the same first block, or a shareable document
        segment): deferring admission until the leader publishes its blocks
        lets a same-context RAG burst reuse them."""
        if not self.kv.prefix_sharing:
            return False
        bs = self.block_size
        docs = _shareable_doc_heads(req.segprompt, bs)
        if docs:
            for r in self.slots:
                if (r is not None and r.prefilling
                        and docs & _shareable_doc_heads(r.segprompt, bs)):
                    return True
        if len(req.prompt) <= bs:
            return False
        head = np.asarray(req.prompt[:bs])
        for r in self.slots:
            if (r is not None and r.prefilling and len(r.prompt) >= bs
                    and np.array_equal(np.asarray(r.prompt[:bs]), head)):
                return True
        return False

    def _emit_token(self, req: Request, tok: int):
        """Emission side effects of one materialized token: timestamps,
        out_tokens, counters, and the out-of-band stream write."""
        now = clock()
        if req.first_token_at is None:
            req.first_token_at = now
        elif req.last_token_at is not None:
            req.token_gaps.append(now - req.last_token_at)
            req.max_token_gap = max(req.max_token_gap, now - req.last_token_at)
        req.last_token_at = now
        req.out_tokens.append(tok)
        self.tokens_out += 1
        if req.stream is not None:
            req.stream.write(tok)

    def _finalize(self, req: Request):
        """Completion side effects (idempotent): done flag, finished window,
        stream close, and slot/block release where the plan did not already
        retire the request (eos hits)."""
        if req.done:
            return
        req.done = True
        req.finished_at = (req.last_token_at if req.last_token_at is not None
                           else clock())
        self.finished.append(req)
        if len(self.finished) > self.max_finished:
            del self.finished[: -self.max_finished]
        if req.slot >= 0 and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        if self.backend == "paged":
            self.kv.release(req.req_id)  # no-op if already released
        if req.stream is not None and not req.stream.closed:
            req.stream.close()

    # ------------------------------------------- sequential and dense paths
    def _prefill_one(self, req: Request, slot: int):
        """Prefill the whole prompt (truncated to ``max_seq``), write its
        cache into row ``slot`` and emit the first token. Full-attention
        stacks run it zero-padded to its bucket, as the JAX engine does
        (decode masks the pad slots). The stacks of
        ``models.prefills_unpadded`` run it at its own length: a recurrent
        state (RWKV-6, or the SSM of a hybrid stack) would carry the pad
        tokens, and a K/V ring as long as the window (a sliding-window or
        hybrid stack) or the chunk (a chunked-local layer) would keep the
        pads' keys in place of the prompt's last ones (ROADMAP §3). An MoE
        layer's capacity is then that of the prompt's own tokens."""
        Lp = len(req.prompt)
        if prefills_unpadded(self.cfg):
            eff = min(Lp, self.max_seq)
            toks, mode = np.asarray(req.prompt[:eff], np.int32)[None], "last"
        else:
            bucket = min(_bucket(Lp), self.max_seq)
            eff = min(Lp, bucket)  # tokens that actually entered the cache
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :eff] = req.prompt[:eff]
            mode = "all"
        req.truncated = eff < Lp
        logits, _, pcache = forward(
            self.cfg, self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            want_cache=True, logits_mode=mode)
        _merge_cache(self.cache, pcache, slot)
        self.prefill_tokens += eff
        req.slot = slot
        # NOT Lp: a truncated prompt must not overrun its cache. pos counts
        # text tokens, as in JAX; decode adds the meta prefix (_decode_batch)
        req.pos = eff
        req.prefill_pos = eff
        req.prefill_cap = eff
        last = logits[0, -1] if mode == "last" else logits[0, eff - 1]
        tok = int(sample_tokens(self._generator, last[None], req.temperature)[0])
        self._emit(req, tok)

    def _step_sequential(self) -> Dict[int, List[int]]:
        """Fill free slots from the queue in policy order (on the paged
        backend through admission, which may backpressure or fail an
        unfittable request; a swapped-out request is restored in place),
        prefilling each admitted request whole, then one batched decode."""
        blocked = False
        for slot in range(self.max_batch):
            while self.slots[slot] is None and self.waiting and not blocked:
                i = self.scheduler.select(self.waiting)
                req = self.waiting[i]
                was_swapped = req.swapped  # _try_admit clears it on restore
                if not self._try_admit(req):
                    if req.done:  # unfittable request failed out; try the next
                        self.waiting.pop(i)
                        continue
                    blocked = True  # the policy's head-of-line waits for blocks
                    break
                self.waiting.pop(i)
                self.slots[slot] = req
                req.stamp_admitted(self.steps)
                if was_swapped:
                    # restored in place: KV, position and cursor resume as
                    # they were (sequential victims are always decode-phase)
                    req.slot = slot
                elif self.backend == "paged":
                    self._prefill_paged(req, slot)
                else:
                    self._prefill_one(req, slot)
        if self.backend == "paged":
            self._ensure_decode_capacity()
        active = [r for r in self.slots if r is not None]
        if not active:
            return {}
        return self._decode_batch(active)

    @torch.no_grad()
    def _decode_batch(self, active: List[Request]) -> Dict[int, List[int]]:
        """One batched decode over every slot. Paged: through the decode
        dispatch (kernel or gather oracle) on scratch-filled tables.
        Dense: inactive rows decode token 0 at position 0 of their own
        (unused) cache row (an RWKV-6 or SSM row's state advances on it;
        admission overwrites the row), and a row's absolute position counts
        its ``num_meta_tokens`` meta tokens before its text (JAX decodes at
        the text position: ROADMAP §3)."""
        B = self.max_batch
        tokens = np.zeros((B, 1), np.int32)
        pos = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        for r in active:
            tokens[r.slot, 0] = r.out_tokens[-1] if r.out_tokens else 0
            pos[r.slot] = self.cfg.num_meta_tokens + r.pos
            temps[r.slot] = r.temperature
        if self.backend == "paged":
            tables = np.full((B, self.max_blocks), self._null_block, np.int32)
            rows = self.kv.batch_tables([r.req_id for r in active])
            for i, r in enumerate(active):
                valid = rows[i] >= 0
                tables[r.slot, valid] = rows[i][valid]
            (t_tables, t_tokens, t_pos), _ = self.runner.upload(tables, tokens, pos)
            logits = self._decode_dispatch(t_tables, t_tokens, t_pos)
            for r in active:
                self.kv.lengths[r.req_id] = r.pos + 1
        else:
            logits, self.cache = decode_step(
                self.cfg, self.params, self.cache, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(pos).to(self.device))
        self.steps += 1
        toks = sample_tokens(self._generator, logits, temps).cpu().numpy()
        emitted: Dict[int, List[int]] = {}
        for r in list(active):
            tok = int(toks[r.slot])
            r.pos += 1
            self._emit(r, tok)
            emitted.setdefault(r.req_id, []).append(tok)
            if r.done:
                self.slots[r.slot] = None
        return emitted

    def _emit(self, req: Request, tok: int):
        """Eager emit (sequential and dense paths): token side effects plus
        the completion check applied immediately."""
        self._emit_token(req, tok)
        req.planned = len(req.out_tokens)
        if (
            len(req.out_tokens) >= req.max_new
            or tok == self.eos_token
            or req.pos >= self.max_seq - 1
        ):
            self._finalize(req)


# Request fields a data-axis group copies from a replica's finished request
# onto its stand-ins on the other rows
_MIRRORED_FIELDS = ("out_tokens", "done", "truncated", "shared_prefix_tokens",
                    "host_prefix_tokens", "session_shared_tokens", "session_host_tokens",
                    "submitted_step", "admitted_step", "submitted_at", "admitted_at",
                    "first_token_at", "last_token_at", "finished_at", "token_gaps",
                    "max_token_gap", "planned", "delivered")


class RowReplica:
    """Replica ``index`` of a ``DataParallelEngineGroup`` on a data-axis
    mesh, as every rank sees it: ``submit`` routes a request to that
    replica through the group (on every rank, so that the load book and
    the stand-in requests stay the same everywhere); every other attribute
    is its engine's on the ranks of its row, and raises elsewhere."""

    def __init__(self, group, index: int):
        self._group = group
        self.index = index

    @property
    def local(self) -> bool:
        return self.index == self._group.row

    def submit(self, prompt, max_new: int = 16, temperature: float = 0.0,
               priority: float = 0.0) -> Request:
        return self._group._submit_to(self.index, prompt, max_new, temperature, priority)

    def __getattr__(self, name):
        if name == "_group" or not self.local:
            raise AttributeError(f"replica {self.index} runs on row {self.index} of the mesh; "
                                 f"this rank is on row {self._group.row}: no {name!r} here")
        return getattr(self._group.engine, name)


class DataParallelEngineGroup:
    """DP replicas of the paged engine over ONE block pool, partitioned by
    block range.

    Each replica is a full ``GenerationEngine`` with **independent
    admission**: its own free list over a disjoint block range
    (``sharded_pool.block_range``), its own refcounts, prefix index, warm
    LRU and scratch block — no cross-replica coordination on the hot path.
    Replicas do NOT share device prefix blocks (each index only points into
    its own range), but a shared host tier (``host_store=`` /
    ``host_blocks=``) gives them the next-best thing: every replica writes
    its newly published prefix blocks through to it, so a document
    prefilled on replica 0 is a *host hit* on replica 1 — one host->device
    block copy instead of a re-prefill. Content-hash keys make the sharing
    exact, and the store's ``cross_hits`` counter makes it observable
    (``stats()["cross_replica_host_hits"]``). ``submit`` routes
    least-loaded (fewest active + queued requests); ``step`` advances every
    busy replica once. A replica's greedy tokens are those of a lone engine
    serving the same requests in the same order — same params, same plans,
    same per-request math. (A lone engine serving every replica's requests
    batches them differently: on the card other packed lengths can round
    bf16 sums otherwise.)

    ``pool_layout`` places the group as JAX's does, in one of three forms:

    * **None**: every replica on one device over one shared ``PoolArrays``
      box and one params tree (the weights are on the card once), one
      ``PriorityFlusher``, one host store and, with ``sanitize=True``, one
      ``KVSanitizer`` for the group. The replicas dispatch onto one CUDA
      stream, in turn, and write disjoint blocks of the box; an int8
      pool's scatter rewrites a whole layer's scales, which is safe only
      because the steps run in stream order.
    * **A layout of one "model" axis** (tensor parallelism): every TP rank
      builds all ``dp`` replicas over its head shard of one box, and they
      step in turn, each all-reducing over the layout's ``tp_group``. This
      is JAX's group exactly: routing, plans and ``cross_replica_host_hits``
      are JAX's.
    * **A layout with a "data" axis** (``launch.mesh.make_serving_mesh(tp,
      dp)``; ``dp`` must equal its size): row d of the mesh is replica d,
      SPMD. Each rank builds only its row's engine, on the row's "model"
      group, over its head shard of the pool, and with ``dp_blocks=True``
      over blocks ``block_range(total, dp, d)`` only. Every rank calls
      ``submit`` with the same arguments in the same order; the least-loaded
      choice reads a load book that every rank holds the same, refreshed
      after each group step by one all-gather of the replicas' (waiting +
      active) counts over each "data" group. ``engines`` holds one
      ``RowReplica`` a replica; a request routed to another row is a
      stand-in whose ``out_tokens`` (and hit counts and times) arrive at the
      end of ``run_until_done``, by an all-gather of the finished requests,
      so every rank returns every request's tokens; its stream is flushed
      by its own row's flusher. ``run_until_done`` loops while any row is
      busy (a MAX all-reduce of one int); an idle row takes part in the
      exchanges only. Each rank keeps a host store of its heads: after each
      group step the rows of a "data" group exchange the blocks their
      replicas put into it that step (key, owner tag, K/V), in rank order,
      and each rank puts its peers' blocks into its own store under their
      owner tags, so ``cross_hits`` counts as in JAX; within a group step a
      replica sees its siblings' write-throughs of the step before (JAX
      steps the replicas in turn in one process). ``stats()`` gathers the
      rows' stats, so every rank returns the group's dict with JAX's keys.

    ``params`` (default: drawn from ``seed``) and ``device`` are the
    replicas'; the other arguments are the JAX group's."""

    def __init__(self, cfg, dp: int = 2, max_batch: int = 4, max_seq: int = 256,
                 block_size: int = 16, n_blocks_per_replica: Optional[int] = None,
                 prefix_sharing: bool = True, pool_layout: Any = None, seed: int = 0,
                 host_store: Optional[HostBlockStore] = None,
                 host_blocks: Optional[int] = None, kv_dtype: Optional[str] = None,
                 sanitize: bool = False, params=None, device=None, **engine_kwargs):
        from repro_torch.serving.sharded_pool import block_range

        if dp < 1:
            raise ValueError("dp must be >= 1")
        device = resolve_device(device)
        max_blocks = -(-max_seq // block_size)
        per = n_blocks_per_replica or (max_batch * (max_blocks + 1) + 1)
        total = per * dp
        self.dp = dp
        self.pool_layout = pool_layout
        if kv_dtype is None and cfg.kv_cache_quant:
            kv_dtype = "int8"
        if kv_dtype is not None and pool_layout is not None:
            raise ValueError("kv_dtype='int8' does not shard over a mesh yet")
        # on a data-axis mesh this rank's row is its replica
        self.row = None
        if pool_layout is not None:
            pool_layout.validate(cfg)
            if pool_layout.dp_degree > 1:
                if dp != pool_layout.dp_degree:
                    raise ValueError(
                        f"dp={dp} replicas on a mesh whose data axis has "
                        f"{pool_layout.dp_degree} rows: each row is one replica")
                self.row = pool_layout.dp_rank
        if host_store is None and (host_blocks
                                   or engine_kwargs.get("preempt") in ("swap", "cost")):
            store_cfg = pool_layout.local_config(cfg) if pool_layout is not None else cfg
            host_store = HostBlockStore.for_config(
                store_cfg, host_blocks or total, block_size, kv_dtype=kv_dtype,
                pin=device.type == "cuda")
        self.host_store = host_store
        # one shared transport: chunks from every local replica's streams
        # flush in global EDF-slack order, not per-replica order
        self.flusher = PriorityFlusher()
        engine_kwargs.setdefault("flusher", self.flusher)
        # one sanitizer spans the local replicas: a shared shadow also
        # catches cross-replica double ownership of a block of a shared box
        self.sanitizer = None
        if sanitize:
            from repro_torch.analysis.kvsan import KVSanitizer

            self.sanitizer = KVSanitizer()
        if pool_layout is not None:
            # placed once: the replicas share this rank's shard
            if params is None:
                params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                     device)
            params = pool_layout.place_params(cfg, params)
        built: Dict[int, GenerationEngine] = {}
        arrays = None
        for rank in (range(dp) if self.row is None else (self.row,)):
            kv = PagedKVCache(
                cfg, total, block_size, max_blocks, prefix_sharing=prefix_sharing,
                device=device, layout=pool_layout, block_range=block_range(total, dp, rank),
                arrays=arrays, host_store=host_store, client_tag=rank, kv_dtype=kv_dtype,
                sanitizer=self.sanitizer,
                # write-through: siblings should host-hit a doc without
                # waiting for the producing replica to evict it
                host_write_through=host_store is not None,
            )
            eng = GenerationEngine(cfg, params=params, max_batch=max_batch, max_seq=max_seq,
                                   seed=seed, block_size=block_size, kv=kv, device=device,
                                   **engine_kwargs)
            arrays = kv._arrays   # replicas 1.. attach to replica 0's box
            params = eng.params   # and reuse its params tree
            built[rank] = eng
        if self.row is None:
            self.engine = None
            self.engines: List[Any] = [built[r] for r in range(dp)]
            return
        self.engine = built[self.row]
        self.engines = [RowReplica(self, d) for d in range(dp)]
        self._dp_group = pool_layout.dp_group
        self._load = [0] * dp                  # the load book: waiting + active a replica
        self._n_submitted = [0] * dp
        self._submitted: List[tuple] = []      # (replica, request) in submission order
        self._mirrored: set = set()            # local request ids already sent
        # (host blocks, their bytes) the rows of this rank's "data" group
        # exchanged, a group step each
        self.exchanges: List[tuple] = []
        if host_store is not None:
            host_store.journal = []

    # --------------------------------------------------------------- routing
    def submit(self, prompt, max_new: int = 16, temperature: float = 0.0,
               priority: float = 0.0) -> Request:
        if self.row is None:
            eng = min(self.engines,
                      key=lambda e: len(e.waiting) + sum(s is not None for s in e.slots))
            return eng.submit(prompt, max_new, temperature, priority)
        d = min(range(self.dp), key=lambda i: self._load[i])
        return self._submit_to(d, prompt, max_new, temperature, priority)

    def _submit_to(self, d: int, prompt, max_new, temperature, priority) -> Request:
        """Route one request to replica ``d`` (a data-axis group): the row's
        engine takes it, every other row keeps a stand-in."""
        self._load[d] += 1
        rid = self._n_submitted[d]
        self._n_submitted[d] += 1
        if d == self.row:
            req = self.engine.submit(prompt, max_new, temperature, priority)
            if req.req_id != rid:
                raise RuntimeError("a data-axis group's engine takes its requests through the "
                                   "group only (submit on every rank, in the same order)")
        else:
            tokens = prompt.tokens if isinstance(prompt, SegmentedPrompt) else prompt
            req = Request(rid, np.atleast_1d(np.asarray(tokens, np.int32)), max_new,
                          temperature, priority)
            req.segprompt = prompt if isinstance(prompt, SegmentedPrompt) else None
            req.submitted_at = clock()
        self._submitted.append((d, req))
        return req

    def replica_of(self, req: Request) -> int:
        """The replica a request was routed to."""
        if self.row is None:
            return next(i for i, e in enumerate(self.engines)
                        if any(r is req for r in (*e.waiting, *e.slots, *e.finished)))
        return next(d for d, r in self._submitted if r is req)

    # -------------------------------------------------------------- stepping
    @staticmethod
    def _busy(eng) -> bool:
        return bool(eng.waiting or any(eng.slots) or eng.pending)

    def step(self) -> None:
        if self.row is None:
            for eng in self.engines:
                if self._busy(eng):
                    eng.step()
            return
        if self._busy(self.engine):
            self.engine.step()
        self._exchange()

    def _any_busy(self) -> bool:
        if self.row is None:
            return any(self._busy(e) for e in self.engines)
        import torch.distributed as dist

        flag = torch.tensor([int(self._busy(self.engine))])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._dp_group)
        return bool(flag.item())

    def run_until_done(self, max_steps: int = 10_000) -> None:
        while max_steps and self._any_busy():
            self.step()
            max_steps -= 1
        for eng in ([self.engine] if self.row is not None else self.engines):
            eng._drain_copies(full=True)
        self.flusher.flush()
        if self.row is not None:
            self._exchange()          # the write-throughs the drain landed
            self._mirror_finished()

    def _gather(self, obj) -> list:
        """``obj`` of every row of this rank's "data" group, in row order."""
        import torch.distributed as dist

        out = [None] * self.dp
        dist.all_gather_object(out, obj, group=self._dp_group)
        return out

    def _exchange(self) -> None:
        """After a group step: refresh the load book from every row, and put
        the host blocks the other rows' replicas put this step into this
        rank's store under their owner tags."""
        eng, store = self.engine, self.host_store
        blocks = []
        if store is not None:
            for key, owner in store.journal:
                b = store.block(key)
                if b is not None:
                    blocks.append((key, owner, b))
            store.journal = []
        load = len(eng.waiting) + sum(s is not None for s in eng.slots)
        rows = self._gather((load, blocks))
        self._load = [n for n, _ in rows]
        self.exchanges.append((sum(len(b) for _, b in rows), sum(
            t.numel() * t.element_size() for _, b in rows for _k, _o, ts in b
            for t in ts if t is not None)))
        if store is None:
            return
        store.journal = None          # a peer's block is not this replica's put
        try:
            for d, (_, theirs) in enumerate(rows):
                if d == self.row:
                    continue
                for key, owner, (k, v, ks, vs) in theirs:
                    store.put(key, k, v, owner=owner, k_scale=ks, v_scale=vs)
        finally:
            store.journal = []

    def _mirror_finished(self) -> None:
        """Send this row's newly finished requests to every row and fill
        the stand-ins with what their replica sent."""
        mine = {}
        for d, req in self._submitted:
            if d == self.row and req.done and req.req_id not in self._mirrored:
                mine[req.req_id] = {f: getattr(req, f) for f in _MIRRORED_FIELDS}
                self._mirrored.add(req.req_id)
        rows = self._gather(mine)
        for d, req in self._submitted:
            if d != self.row and req.req_id in rows[d]:
                for f, v in rows[d][req.req_id].items():
                    setattr(req, f, v)

    # ----------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        if self.row is None:
            per = [e.stats() for e in self.engines]
            hosts = None
        else:
            rows = self._gather((self.engine.stats(), None if self.host_store is None
                                 else self.host_store.stats()))
            per = [p for p, _ in rows]
            hosts = [h for _, h in rows]
        out = {
            "dp_degree": self.dp,
            "tokens_out": sum(s["tokens_out"] for s in per),
            "prefill_tokens": sum(s["prefill_tokens"] for s in per),
            "preemptions": sum(s["preemptions"] for s in per),
            "host_hit_tokens": sum(s.get("host_hit_tokens", 0) for s in per),
            "replicas": per,
        }
        if self.host_store is not None:
            host = self.host_store.stats() if hosts is None else _merged_host_stats(
                hosts, self.row)
            out["cross_replica_host_hits"] = host["cross_hits"]
            out["host_store"] = host
        return out


def _merged_host_stats(rows: List[Dict[str, Any]], row: int) -> Dict[str, Any]:
    """The host tier of a data-axis group as one store: the keyed blocks
    are every row's (each rank's store holds its peers' puts too, so its
    own counts them), the reads and swap sets each replica's own."""
    out = dict(rows[row])
    for k in ("hits", "cross_hits", "swap_outs", "swap_ins", "n_swapped"):
        out[k] = sum(r[k] for r in rows)
    out["n_free"] = rows[row]["n_free"] - (out["n_swapped"] - rows[row]["n_swapped"])
    out["utilization"] = 1.0 - out["n_free"] / max(out["n_blocks"], 1)
    return out


def _merge_emitted(into: Dict[int, List[int]], more: Dict[int, List[int]]) -> None:
    for rid, toks in more.items():
        into.setdefault(rid, []).extend(toks)


# cache entries with a sequence axis at dim 2: GQA K/V (and the int8
# cache's scales), MLA's latents
_SEQUENCE_ENTRIES = ("k", "v", "k_scale", "v_scale", "c_kv", "k_rope")


def _merge_cache(batch_cache, one_cache, slot: int):
    """Write a B=1 prefill cache into row ``slot`` of the batch cache, in
    place, entry by entry (one per position in the period, each with its own
    Sc). A K/V entry (G, B, Sc, KVH, hd) or an MLA latent (G, B, Sc, n) has
    a sequence axis at dim 2, as have the int8 cache's scales (G, B, Sc,
    KVH): the row's slots past the prefill are zeroed, as the JAX function
    pads them. A ring (a sliding-window, hybrid or
    chunked-local layer's) keeps position p at slot p % Sc in both caches:
    the prefill's ring is shorter than the batch's only when it has not
    wrapped, so its slots go to the same indices. A recurrent entry (RWKV-6
    state and token shifts, the SSM's conv tail and h) has none: the whole
    row is copied."""
    for bc_entry, oc_entry in zip(batch_cache, one_cache):
        for name, bc in bc_entry.items():
            oc = oc_entry[name]
            if name not in _SEQUENCE_ENTRIES:
                bc[:, slot] = oc[:, 0]
                continue
            n = oc.shape[2]
            bc[:, slot, :n] = oc[:, 0]
            bc[:, slot, n:] = 0


def _shareable_doc_heads(segprompt, block_size: int) -> set:
    """Content fingerprints of a prompt's document segments big enough to
    yield at least one shareable (full) block."""
    if segprompt is None:
        return set()
    return {
        seg.tokens.tobytes()
        for seg in segprompt.segments
        if seg.kind == KIND_DOC and len(seg.tokens) >= block_size
    }
