"""Device runtime: executes ``StepPlan``s, double-buffered. Ported from
``repro.serving.device_runner``.

* **Same programs, same numerics.** The runner calls the engine's own step
  programs (``_ragged_step``, the padded oracle's ``_fused_step``, and
  ``_decode_dispatch``: the paged decode kernel or the gather oracle, by
  the engine's ``kernel``); around them sit a
  prev-token substitution (decode rows feed the previous plan's sampled
  token straight from device memory, no host roundtrip) and the sampler.

* **Deferred materialization.** ``dispatch`` only ENQUEUES work on the
  current CUDA stream: the plan's int32 arrays go up in one pinned,
  non-blocking copy, the step's kernels are queued, and the sampled tokens
  are copied back into a pinned host buffer with an event recorded after
  the copy. ``materialize`` waits on that event only — not on later work in
  the stream — so the engine can build and dispatch plan N+1 while step N
  runs. The previous step's tokens stay on the device for substitution.

* **Host-gap accounting.** The wall time the device sat idle between the
  completion of one step and the dispatch of the next, measured with
  ``Event.query()`` at build start and the blocking materializes. It
  misses idle time inside a step; the engine's ``telemetry`` spans
  (``launch``, ``wait``, ...) show where the host spends a step.

* **Per-token step time.** ``token_time_ema``: an EMA of (materialize -
  dispatch wall time) / the plan's valid tokens, which the cost model of
  ``preempt="cost"`` reads.

On the CPU everything runs synchronously: a dispatched plan is ready at once.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.telemetry import clock
from repro_torch.serving.control_plane import StepPlan
from repro_torch.serving.sampler import sample_tokens


def _substitute(tokens, prev, prev_slots):
    """Replace column 0 of rows with ``prev_slots[b] >= 0`` by the previous
    plan's device-resident sampled token for that row."""
    idx = prev_slots.clamp(min=0).long()
    col0 = torch.where(prev_slots >= 0, prev[idx], tokens[:, 0])
    return torch.cat([col0[:, None], tokens[:, 1:]], dim=1)


def _substitute_packed(tokens, prev, prev_slots, decode_idx):
    """Ragged-layout substitution: a decode row's single token lives at flat
    index ``decode_idx[b]``; rows with ``prev_slots[b] >= 0`` take the
    previous plan's device-resident sampled token. Non-substituting rows
    scatter into a dropped extra slot."""
    T = tokens.shape[0]
    idx = torch.where(prev_slots >= 0, decode_idx,
                      torch.full_like(decode_idx, T)).long()
    vals = prev[prev_slots.clamp(min=0).long()]
    ext = torch.cat([tokens, tokens.new_zeros(1)])
    ext.scatter_(0, idx, vals)
    return ext[:T]


class PlanExec:
    """A dispatched plan: its sampled tokens on the device, the pinned host
    buffer they are copied into, and the event recorded after that copy
    (None on the CPU, where the tokens are ready at once)."""

    __slots__ = ("plan", "tokens", "host", "event", "staging", "dispatched_at", "_host")

    def __init__(self, plan: StepPlan, tokens, host, event, staging, dispatched_at):
        self.plan = plan
        self.dispatched_at = dispatched_at
        self.tokens = tokens          # (B,) device tensor, possibly in flight
        self.host = host              # (B,) host tensor the copy lands in
        self.event = event
        self.staging = staging        # pinned upload buffer, held until done
        self._host: Optional[np.ndarray] = None

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()


class DeviceRunner:
    def __init__(self, engine):
        self.eng = engine
        self.device = engine.device
        self.last_plan_id = -1
        self._last: Optional[PlanExec] = None         # prev-token source
        self._outstanding: Optional[PlanExec] = None  # newest unmaterialized
        self._idle_mark: Optional[float] = None       # when idleness observed
        self.host_gap_s = 0.0
        self.n_gaps = 0           # dispatches that closed a gap (0 s if busy)
        self.n_dispatched = 0
        # online per-valid-token step time (EMA over materialized plans);
        # the cost-model preemption's recompute estimate consumes it
        self.token_time_ema: Optional[float] = None
        self._no_prev = torch.zeros((engine.max_batch,), dtype=torch.int32,
                                    device=self.device)

    # --------------------------------------------------------------- upload
    def upload(self, *arrays: np.ndarray):
        """Move int32 host arrays to the device in ONE copy: pinned and
        non-blocking on CUDA. Returns (device tensors, staging buffer)."""
        flat = np.concatenate([np.ascontiguousarray(a, np.int32).ravel()
                               for a in arrays])
        host = torch.from_numpy(flat)
        staging = None
        if self.device.type == "cuda":
            staging = host.pin_memory()
            buf = staging.to(self.device, non_blocking=True)
        else:
            buf = host
        out, off = [], 0
        for a in arrays:
            out.append(buf[off : off + a.size].view(a.shape))
            off += a.size
        return out, staging

    # --------------------------------------------------------------- probes
    def probe_idle(self) -> None:
        """Called at plan-build start: if the outstanding step already
        finished, the device is idle from NOW until the next dispatch."""
        if (self._outstanding is not None and self._idle_mark is None
                and self._outstanding.is_ready()):
            self._idle_mark = clock()

    # ------------------------------------------------------------- dispatch
    @torch.no_grad()
    def dispatch(self, plan: StepPlan) -> PlanExec:
        eng = self.eng
        now = clock()
        if self._outstanding is not None and self._idle_mark is None:
            # late probe: the step may have finished mid-build; counting the
            # gap from now underestimates, never inflates, the idle time
            if self._outstanding.is_ready():
                self._idle_mark = now
        if self._idle_mark is not None:
            self.host_gap_s += max(now - self._idle_mark, 0.0)
            self.n_gaps += 1
        elif self._outstanding is not None:
            self.n_gaps += 1  # device still busy: zero gap
        self._idle_mark = None

        prev = self._last.tokens if self._last is not None else self._no_prev
        if plan.kind == "ragged":
            (tables, toks, prev_slots, decode_idx, row_of, slots, positions,
             p_end, s_start, last_idx), staging = self.upload(
                plan.tables, plan.tokens, plan.prev_slots, plan.decode_idx,
                plan.row_of, plan.slots, plan.positions, plan.p_end,
                plan.s_start, plan.last_idx)
            toks_in = _substitute_packed(toks, prev, prev_slots, decode_idx)
            logits = eng._ragged_step(tables, toks_in, row_of, slots,
                                      positions, p_end, s_start, last_idx)
        elif plan.kind == "fused":
            (tables, toks, prev_slots, starts, n_valid, positions, p_end,
             s_start), staging = self.upload(
                plan.tables, plan.tokens, plan.prev_slots, plan.starts,
                plan.n_valid, plan.positions, plan.p_end, plan.s_start)
            toks_in = _substitute(toks, prev, prev_slots)
            logits = eng._fused_step(tables, toks_in, starts, n_valid,
                                     positions, p_end, s_start)
        else:
            (tables, toks, prev_slots, starts), staging = self.upload(
                plan.tables, plan.tokens, plan.prev_slots, plan.starts)
            toks_in = _substitute(toks, prev, prev_slots)
            logits = eng._decode_dispatch(tables, toks_in, starts)
        toks = sample_tokens(eng._generator, logits, plan.temps)
        event = None
        host = toks
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        ex = PlanExec(plan, toks, host, event, staging, now)
        self._last = ex
        self._outstanding = ex
        self.last_plan_id = plan.plan_id
        self.n_dispatched += 1
        return ex

    # ---------------------------------------------------------- materialize
    def materialize(self, ex: PlanExec) -> np.ndarray:
        """Block until ``ex``'s sampled tokens are on the host (idempotent).
        When ``ex`` is the newest dispatched work, the device is idle from
        here until the next dispatch — start the gap clock."""
        if ex._host is None:
            with self.eng.telemetry.span("wait"):
                if ex.event is not None:
                    ex.event.synchronize()
            ex._host = ex.host.numpy().copy()
            ex.staging = None
            t = clock()
            if self._outstanding is ex:
                self._outstanding = None
                self._idle_mark = t
            if ex.plan.n_tokens > 0:
                per = max(t - ex.dispatched_at, 1e-9) / ex.plan.n_tokens
                self.token_time_ema = (per if self.token_time_ema is None
                                       else 0.8 * self.token_time_ema + 0.2 * per)
        return ex._host

    # ---------------------------------------------------------------- stats
    def summary(self) -> dict:
        return {
            "host_gap_s": self.host_gap_s,
            "host_gap_mean_s": self.host_gap_s / self.n_gaps if self.n_gaps else 0.0,
            "dispatches": self.n_dispatched,
        }
