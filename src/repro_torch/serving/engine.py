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
window, ``kernels.decode_attention``, ``kernels.ssm_scan.ssm_scan``).

The engine runs on ``cuda`` unless ``device="cpu"`` is passed. The
attention wrappers launch the CUDA kernels for CUDA tensors and run their
plain PyTorch versions for CPU tensors; ``stats()["kernel"]`` says which.
Arguments of later slices — meshes and pool layouts, an injected cache, the
int8 dense cache, the sequential and padded oracles of the paged backend,
the rest of the zoo on the dense backend and the sanitizer — raise
``NotImplementedError``.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import QueuePolicy, make_policy
from repro_torch.core.streaming import PriorityFlusher, StreamingObject
from repro_torch.models import (
    decode_step,
    decode_step_paged,
    dense_cache_supported,
    forward,
    has_recurrent_state,
    init_cache,
    init_params,
    paged_cache_supported,
    prefill_packed,
)
from repro_torch.serving.control_plane import ControlPlane, CopyEngine
from repro_torch.serving.device_runner import (
    DeviceRunner,
    PlanExec,
    _substitute_packed,
)
from repro_torch.serving.host_tier import HostBlockStore
from repro_torch.serving.paged_cache import PagedKVCache, device_to_host
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
    queued_steps: int = 0            # engine steps spent waiting for admission
    submitted_at: float = 0.0
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
        ``host_bw_bytes_s`` is the cost model's host-link rate. The other
        arguments mean what they mean in the JAX engine."""
        later = {"mesh": mesh, "pool_layout": pool_layout, "kv": kv}
        for name, value in later.items():
            if value is not None:
                raise NotImplementedError(f"GenerationEngine({name}=...) is not ported yet")
        if backend not in ("paged", "dense"):
            raise ValueError(f"unknown backend {backend!r}")
        if preempt not in ("recompute", "swap", "cost"):
            raise ValueError(f"unknown preempt strategy {preempt!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        if sanitize:
            raise NotImplementedError("the KV sanitizer is not ported yet")
        if not paged_cache_supported(cfg):
            # JAX serves such archs on the dense backend; its port covers
            # full-attention GQA and RWKV-6 stacks
            if not dense_cache_supported(cfg):
                raise NotImplementedError(
                    f"{cfg.name} is outside the paged contract; the rest of the zoo "
                    "on the dense backend is not ported yet")
            backend = "dense"
        if backend == "paged" and (not interleave or not ragged):
            raise NotImplementedError(
                "only the interleaved, ragged (packed) paged step is ported")
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
        self.interleave = backend == "paged"
        self.ragged = backend == "paged"
        self.kernel = "cuda" if self.device.type == "cuda" else "plain"
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
        if self.backend == "dense":
            # a row's cache holds its meta tokens too (a hybrid layer's
            # K/V: a ring of min(max_seq + M, window) slots); init_cache
            # raises for the int8 dense cache (cfg.kv_cache_quant)
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
        self.kv_dtype = kv_dtype
        if self.host_store is None and (host_blocks or preempt in ("swap", "cost")):
            self.host_store = HostBlockStore.for_config(
                cfg, host_blocks or n_blocks, block_size, kv_dtype=kv_dtype,
                pin=self.device.type == "cuda")
        self.kv = PagedKVCache(cfg, n_blocks, block_size, self.max_blocks,
                               prefix_sharing=prefix_sharing, device=self.device,
                               host_store=self.host_store, kv_dtype=kv_dtype)
        # reserved scratch block: swallows pad-token and unbacked writes
        self._null_block = self.kv.pool.allocate(_NULL_SEQ, 1)[0]
        # the cache's demotions and write-through copies and the engine's
        # swap-set fills drain through the copy engine between dispatches
        self.kv.copy_engine = self._copy
        self.control = ControlPlane(self)
        self.runner = DeviceRunner(self)

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
        req.submitted_at = time.monotonic()
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
        run (0 on the dense backend, which has no packed step)."""
        if self.backend != "paged":
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
            n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return n

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
        if req.swapped:
            return self._swap_in(req)
        cap = self._prompt_cap(req)
        if self.kv.pool.blocks_needed(cap + self.block_size) > self.kv.pool.n_owned - 1:
            # can never fit, even with the whole pool free: fail the request
            # instead of wedging the queue
            req.done = True
            req.truncated = True
            req.finished_at = time.monotonic()
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
        ``last_idx``), so the sampler keeps its (B,) contract."""
        logits = prefill_packed(
            self.cfg, self.params, self.kv.k, self.kv.v, tables, tokens,
            row_of, slots, positions, p_end, s_start,
            block_size=self.block_size, null_block=self._null_block,
            k_scales=self.kv.k_scale, v_scales=self.kv.v_scale,
        )
        return logits[last_idx.long()]

    def _decode_step(self, tables, tokens, pos):
        """Batched paged decode: each row's new K/V is scattered in place and
        its block chain streams through ``paged_decode_attention``."""
        return decode_step_paged(
            self.cfg, self.params, self.kv.k, self.kv.v, tables, tokens, pos,
            block_size=self.block_size, null_block=self._null_block,
            k_scales=self.kv.k_scale, v_scales=self.kv.v_scale,
        )

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
        the tokens whose emission LANDED this step. The dense backend admits
        (blocking whole-prompt prefill) and then runs one batched decode."""
        for r in self.waiting:
            r.queued_steps += 1
        if self.backend == "dense":
            out = self._step_sequential()
            self._drain_copies(full=True)
            self.flusher.flush()
            return out
        emitted: Dict[int, List[int]] = {}
        # preemption inside build may have to sync the inflight plan; its
        # emissions land in this step's result
        self._build_emitted = emitted
        try:
            self.runner.probe_idle()
            plan = self.control.build_plan()
        finally:
            self._build_emitted = None
        ex = self.runner.dispatch(plan) if plan is not None else None
        if ex is not None:
            self.steps += 1
        self._drain_copies(full=ex is None)
        prev, self._inflight = self._inflight, ex
        if prev is not None:
            _merge_emitted(emitted, self._materialize(prev))
        if self._inflight is not None and (not self.pipeline or self.eos_token >= 0):
            # sync oracle — or eos enabled: completion must be observed
            # before the next plan is built, so pipelining degenerates
            cur, self._inflight = self._inflight, None
            _merge_emitted(emitted, self._materialize(cur))
        self.flusher.flush()
        return emitted

    def _materialize(self, ex: PlanExec) -> Dict[int, List[int]]:
        """Land a dispatched plan's emissions: pull the sampled tokens to the
        host, write them to out_tokens + streams, finalize finishing rows."""
        toks = self.runner.materialize(ex)
        emitted: Dict[int, List[int]] = {}
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
        now = time.monotonic()
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
                           else time.monotonic())
        self.finished.append(req)
        if len(self.finished) > self.max_finished:
            del self.finished[: -self.max_finished]
        if req.slot >= 0 and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        if self.backend == "paged":
            self.kv.release(req.req_id)  # no-op if already released
        if req.stream is not None and not req.stream.closed:
            req.stream.close()

    # ---------------------------------------------------------- dense path
    def _prefill_one(self, req: Request, slot: int):
        """Prefill the whole prompt (truncated to ``max_seq``), write its
        cache into row ``slot`` and emit the first token. Attention stacks
        run it zero-padded to its bucket, as the JAX engine does (decode
        masks the pad slots). A stack that carries a recurrent state (RWKV-6,
        or the SSM of a hybrid stack) runs it at its own length: its
        recurrence would carry the pad tokens into the state (ROADMAP §3)."""
        Lp = len(req.prompt)
        if has_recurrent_state(self.cfg):
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
        """Fill free slots from the queue (a free slot is the dense backend's
        only admission resource), then one batched decode."""
        for slot in range(self.max_batch):
            while self.slots[slot] is None and self.waiting:
                req = self.waiting.pop(self.scheduler.select(self.waiting))
                self.slots[slot] = req
                self._prefill_one(req, slot)
        active = [r for r in self.slots if r is not None]
        if not active:
            return {}
        return self._decode_batch(active)

    def _decode_batch(self, active: List[Request]) -> Dict[int, List[int]]:
        """One batched decode over every slot; inactive rows decode token 0
        at position 0 of their own (unused) cache row (an RWKV-6 or SSM row's
        state advances on it; admission overwrites the row). A row's absolute
        position counts its ``num_meta_tokens`` meta tokens before its text
        (JAX decodes at the text position: ROADMAP §3)."""
        B = self.max_batch
        tokens = np.zeros((B, 1), np.int32)
        pos = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        for r in active:
            tokens[r.slot, 0] = r.out_tokens[-1] if r.out_tokens else 0
            pos[r.slot] = self.cfg.num_meta_tokens + r.pos
            temps[r.slot] = r.temperature
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
        """Eager emit (dense path): token side effects plus the completion
        check applied immediately."""
        self._emit_token(req, tok)
        req.planned = len(req.out_tokens)
        if (
            len(req.out_tokens) >= req.max_new
            or tok == self.eos_token
            or req.pos >= self.max_seq - 1
        ):
            self._finalize(req)


def _merge_emitted(into: Dict[int, List[int]], more: Dict[int, List[int]]) -> None:
    for rid, toks in more.items():
        into.setdefault(rid, []).extend(toks)


def _merge_cache(batch_cache, one_cache, slot: int):
    """Write a B=1 prefill cache into row ``slot`` of the batch cache, in
    place. A K/V entry (G, B, Sc, KVH, hd) has a sequence axis at dim 2: the
    row's slots past the prefill are zeroed, as the JAX function pads them.
    A hybrid layer's ring keeps position p at slot p % Sc in both caches:
    the prefill's ring is shorter than the batch's only when it has not
    wrapped, so its slots go to the same indices. A recurrent entry (RWKV-6
    state and token shifts, the SSM's conv tail and h) has none: the whole
    row is copied."""
    for bc_entry, oc_entry in zip(batch_cache, one_cache):
        for name, bc in bc_entry.items():
            oc = oc_entry[name]
            if name not in ("k", "v"):
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
