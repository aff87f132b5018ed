"""Host-side control plane: immutable per-step plans for the device runtime.

A copy of ``repro.serving.control_plane`` for the port: mixed steps are
packed ("ragged", the main path) or, with ``ragged=False``, padded to a
chunk-width slab per row ("fused", the packing oracle). The plan SEQUENCE
(grants, bookkeeping, emissions) is the same under both layouts.

Admission, block allocation, chunk grants and the bookkeeping of a step
are host work; this module keeps them off the device's critical path. It is
the host half of the split (the device half is ``serving.device_runner``):

* ``StepPlan`` — an immutable snapshot of ONE engine step: which rows
  decode, which mid-prefill rows got how much of the token budget, the
  fully-assembled batch arrays (tokens/cursors/block tables/segment spans),
  and which rows' sampled token will be delivered. Everything the device
  needs, nothing it has to ask the host for mid-step.

* ``ControlPlane`` — builds plans entirely host-side: admission in policy
  order (with prefix-leader deferral), decode-capacity preemption, token-
  budget grants, batch assembly, and the *build-time* bookkeeping (cursor
  advances, ``kv.lengths``, prefix publication, count-based completion →
  slot/block release). Because bookkeeping that affects the NEXT plan is
  applied at build time, the plan sequence is identical whether the engine
  materializes each step eagerly (sync oracle) or one step late (pipelined)
  — which is what makes pipelined mode token-exact by construction.

* ``CopyEngine`` — a bounded host-side queue of deferred device<->host
  copies (swap-set fills, warm-block demotions, write-through publishes).
  A copy op gathers its source into a fresh tensor and starts the copy to
  pinned memory when it is enqueued (the pools change in place); only the
  wait for that copy and the store's bookkeeping are deferred off the
  critical path. ``sync(tag)`` gives readers (swap-in) a happens-before
  edge against their own pending writes.

Completion bookkeeping splits across the two timelines: the *plan* decides
a request is finishing (its ``planned`` count hit ``max_new``) and releases
its blocks immediately — device program order guarantees the released
blocks' last writes land before any later plan reuses them — while the
emission side effects (``out_tokens``, timestamps, stream writes, the
``done`` flag) happen when the sampled tokens materialize, one step later
in pipelined mode.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.streaming import streaming_chunk_policy


@dataclass(frozen=True, eq=False)
class StepPlan:
    """One engine step, fully decided host-side. Arrays are plain numpy —
    the runner uploads them; nothing here holds device state."""

    plan_id: int
    kind: str                # "ragged" (packed mixed batch) | "fused"
    #                          (padded mixed batch) | "decode"
    tokens: np.ndarray       # ragged: (T,) flat packed tokens; fused: (B, C)
    #                          chunk tokens; decode: (B, 1)
    starts: np.ndarray       # (B,) int32 per-row cursor / decode position
    temps: np.ndarray        # (B,) float32 sampling temperatures
    tables: np.ndarray       # (B, view_blocks | max_blocks) int32 block
    #                          tables — RAW (-1 holes) for ragged plans,
    #                          scratch-filled for fused/decode
    # rows whose decode token must be substituted with the PREVIOUS plan's
    # device-resident sampled token (-1 = feed the host-provided token)
    prev_slots: np.ndarray   # (B,) int32
    # rows whose sampled token is delivered: (request, row, finishing)
    emit_rows: Tuple[Tuple[Any, int, bool], ...]
    n_tokens: int            # valid tokens this step (per-token calibration)
    n_valid: Optional[np.ndarray] = None     # mixed only: (B,) valid counts
    positions: Optional[np.ndarray] = None   # mixed only: rope positions —
    #                                          (T,) ragged, (B, C) fused
    p_end: Optional[np.ndarray] = None       # mixed only: attention span ends
    s_start: Optional[np.ndarray] = None     # mixed only: span starts
    # ragged layout only: the packed batch's row-offset arrays
    row_of: Optional[np.ndarray] = None      # (T,) owning batch row, -1 = pad
    slots: Optional[np.ndarray] = None       # (T,) absolute cache slot
    decode_idx: Optional[np.ndarray] = None  # (B,) flat index of the row's
    #                                          decode token (-1 = not decoding)
    last_idx: Optional[np.ndarray] = None    # (B,) flat index of the row's
    #                                          last valid token (0 = unused row)


def padded_plan_difference(rp: StepPlan, fp: StepPlan) -> Optional[str]:
    """Where the plan of one step under the packed layout (``rp``) departs
    from the plan of the same step under the padded one (``fp``); None when
    it re-encodes it. Decode plans are equal; a mixed plan unpacked (each
    row a contiguous run of the packed buffer, the pads a tail run with
    ``row_of`` -1) gives the padded rows' tokens, positions, spans and
    slots, with the same plan id, token count, starts and ``n_valid``."""
    if (rp.plan_id, rp.n_tokens) != (fp.plan_id, fp.n_tokens):
        return f"plan {rp.plan_id}/{fp.plan_id}: ids or token counts differ"
    where = f"plan {rp.plan_id}"
    if not np.array_equal(rp.starts, fp.starts):
        return f"{where}: starts {rp.starts} vs {fp.starts}"
    if fp.kind == "decode":
        if rp.kind != "decode":
            return f"{where}: kinds {rp.kind} vs decode"
        if not (np.array_equal(rp.tokens, fp.tokens) and np.array_equal(rp.tables, fp.tables)):
            return f"{where}: decode tokens or tables differ"
        return None
    if (rp.kind, fp.kind) != ("ragged", "fused"):
        return f"{where}: kinds {rp.kind} vs {fp.kind}"
    if not np.array_equal(rp.n_valid, fp.n_valid):
        return f"{where}: n_valid {rp.n_valid} vs {fp.n_valid}"
    row_of = np.asarray(rp.row_of)
    n_packed = int((row_of >= 0).sum())
    if not np.all(row_of[n_packed:] == -1):
        return f"{where}: pads are not a tail run"
    for b, nv in enumerate(np.asarray(fp.n_valid).tolist()):
        idx = np.nonzero(row_of == b)[0]
        if len(idx) != nv:
            return f"{where} row {b}: {len(idx)} packed tokens, n_valid {nv}"
        if not nv:
            continue
        if not np.array_equal(idx, np.arange(idx[0], idx[0] + nv)):
            return f"{where} row {b}: not a contiguous run"
        for name in ("tokens", "positions", "p_end", "s_start"):
            if not np.array_equal(np.asarray(getattr(rp, name))[idx],
                                  np.asarray(getattr(fp, name))[b, :nv]):
                return f"{where} row {b}: {name} differ"
        if not np.array_equal(np.asarray(rp.slots)[idx],
                              np.arange(fp.starts[b], fp.starts[b] + nv)):
            return f"{where} row {b}: slots differ"
        if rp.last_idx[b] != idx[-1]:
            return f"{where} row {b}: last_idx {rp.last_idx[b]} vs {idx[-1]}"
        if rp.decode_idx[b] >= 0 and (nv != 1 or rp.decode_idx[b] != idx[0]):
            return f"{where} row {b}: decode_idx {rp.decode_idx[b]} vs {idx[0]}"
    return None


class CopyEngine:
    """Bounded FIFO of deferred host<->device copy closures.

    Each op is a zero-arg callable whose expensive part is the wait for a
    device→host copy (an event) and the host store's slab write; the
    device-side gather and the copy were already enqueued with the op, so
    draining is pure host work that the engine schedules BETWEEN dispatches.
    Ordering is FIFO — a demotion enqueued after a write-through of the same
    block drains after it, so the host tier always converges to the latest
    publication. ``submit`` force-drains the oldest ops past ``max_pending``
    (bounded memory: each pending op holds one gathered block set)."""

    def __init__(self, max_pending: int = 32):
        self.max_pending = max_pending
        self._q: Deque[Tuple[Any, Callable[[], None]]] = deque()
        self.submitted = 0
        self.drained = 0
        self.forced = 0   # ops drained early by the bound, not by schedule
        # optional analysis.kvsan.KVSanitizer: tracks per-tag pending copies
        # so the shadow can enforce the sync(tag) happens-before edge (a
        # swap-set restore must not read ahead of its deferred fill)
        self.sanitizer: Optional[Any] = None

    @property
    def backlog(self) -> int:
        return len(self._q)

    def submit(self, op: Callable[[], None], tag: Any = None) -> None:
        if self.sanitizer is not None:
            self.sanitizer.copy_submit(tag)
        self._q.append((tag, op))
        self.submitted += 1
        while len(self._q) > self.max_pending:
            self.forced += 1
            self._run_one()

    def _run_one(self) -> None:
        tag, op = self._q.popleft()
        self.drained += 1
        if self.sanitizer is not None:
            self.sanitizer.copy_drained(tag)
        op()

    def drain(self, budget: Optional[int] = None) -> int:
        """Run up to ``budget`` pending ops (all of them when None)."""
        n = len(self._q) if budget is None else min(budget, len(self._q))
        for _ in range(n):
            self._run_one()
        return n

    def sync(self, tag: Any) -> None:
        """Drain (in order) until no pending op carries ``tag`` — the
        happens-before edge a reader needs against its own deferred writes
        (e.g. swap-in after a deferred swap-set fill)."""
        while any(t == tag for t, _ in self._q):
            self._run_one()


class ControlPlane:
    """Builds ``StepPlan``s for one engine: admission, capacity, grants,
    batch assembly, and build-time bookkeeping. Owns no device state."""

    def __init__(self, engine):
        self.eng = engine
        self._next_plan_id = 0
        self.plans_built = 0
        self.last_load = 0.0
        self.last_chunk_size: Optional[int] = None
        # a list here collects every StepPlan built, in build order (the
        # oracle comparisons read them); None keeps none
        self.recorded: Optional[List[StepPlan]] = None

    # ------------------------------------------------------------ admission
    def admit(self) -> None:
        """Fill free slots from the waiting queue in policy order, allocating
        blocks only — prefill itself runs inside later plans via the
        request's cursor. A stop at a request whose prefix a leader is
        still prefilling counts as ``admit.deferred_prefix``."""
        eng = self.eng
        free = [s for s in range(eng.max_batch) if eng.slots[s] is None]
        while free and eng.waiting:
            i = eng.scheduler.select(eng.waiting)
            req = eng.waiting[i]
            if not req.swapped and eng._prefix_pending(req):
                eng.telemetry.count("admit.deferred_prefix")
                break  # leader still prefilling this prefix; wait to share it
            was_swapped = req.swapped  # _try_admit clears it on restore
            if not eng._try_admit(req):
                if req.done:  # unfittable request failed out; try the next
                    eng.waiting.pop(i)
                    continue
                break  # the policy's head-of-line waits for blocks
            eng.waiting.pop(i)
            slot = free.pop(0)
            if not was_swapped:
                cap = eng._prompt_cap(req)
                req.truncated = cap < len(req.prompt)
                req.prefill_cap = cap
                req.prefill_pos = 0
                eng._advance_cursor(req)  # shared blocks already carry K/V
            # a swap-restored request keeps its cursor/position state: it
            # resumes mid-prefill or mid-decode exactly where swap-out left it
            req.slot = slot
            eng.slots[slot] = req
            req.stamp_admitted(eng.steps)

    # ----------------------------------------------------------- chunk knob
    def _apply_chunk_policy(self, active: List) -> None:
        """Load-driven streaming granularity (paper §3.3.1): fine-grained
        chunks at low load overlap delivery with downstream work; coarse
        chunks at high load keep flush work off the busy engine."""
        eng = self.eng
        load = min(1.0, (len(active) + len(eng.waiting)) / max(eng.max_batch, 1))
        size = streaming_chunk_policy(load)
        self.last_load = load
        self.last_chunk_size = size
        for r in active:
            if r.stream is not None:
                r.stream.set_chunk_size(size)

    # ------------------------------------------------------------- planning
    def build_plan(self) -> Optional[StepPlan]:
        """One step's decisions, host-side only. Returns None when there is
        nothing to run (no active slots after admission)."""
        eng = self.eng
        with eng.telemetry.span("plan.admit"):
            self.admit()
        eng._ensure_decode_capacity()
        active = [r for r in eng.slots if r is not None]
        self._apply_chunk_policy(active)
        if not active:
            return None
        plan_id = self._next_plan_id
        self._next_plan_id += 1
        self.plans_built += 1

        prefill_rows = sorted((r for r in active if r.prefilling),
                              key=lambda r: r.req_id)
        decode_rows = [r for r in active if not r.prefilling]
        B = eng.max_batch
        prev_slots = np.full((B,), -1, np.int32)

        if prefill_rows:
            assemble = (self._assemble_ragged if eng.ragged
                        else self._assemble_fused)
            plan = assemble(plan_id, active, prefill_rows, decode_rows,
                            prev_slots)
        else:
            plan = self._assemble_decode(plan_id, active, prev_slots)

        # build-time completion: finishing rows release slot + blocks NOW so
        # the next plan can admit into them; emission happens at materialize
        for req, _row, finishing in plan.emit_rows:
            if finishing:
                eng._retire_slot(req)
        if self.recorded is not None:
            self.recorded.append(plan)
        return plan

    def _grants(self, prefill_rows, decode_rows) -> Dict[int, int]:
        """Token-budget grants: decode rows reserve one token each; the
        remaining budget goes to mid-prefill rows in policy order (always
        at least one token, so prefill can never fully starve). The same
        for both mixed layouts."""
        eng = self.eng
        budget = max(eng.token_budget - len(decode_rows), 1)
        grants: Dict[int, int] = {}
        for r in eng.scheduler.order(prefill_rows):
            if budget <= 0:
                break
            c = min(eng._max_grant(r, eng.prefill_chunk_size), budget)
            grants[r.req_id] = c
            budget -= c
        return grants

    def _mixed_bookkeeping(self, plan_id, prefill_rows, decode_rows, grants):
        """Build-time bookkeeping for one mixed step (the state the NEXT
        plan reads): cursor/position advances, kv lengths, prefix
        publication, and the emit list."""
        eng = self.eng
        emit: List[Tuple[Any, int, bool]] = []
        n_tok = 0
        for r in decode_rows:
            r.pos += 1
            eng.kv.lengths[r.req_id] = r.pos
            n_tok += 1
            emit.append(self._mark_sampled(r, plan_id))
        for r in prefill_rows:
            c = grants.get(r.req_id, 0)
            if c == 0:
                continue  # no budget this step; cursor holds
            r.prefill_pos += c
            eng.prefill_tokens += c
            n_tok += c
            eng._advance_cursor(r)  # skip cache-served spans for free
            eng.kv.lengths[r.req_id] = r.prefill_pos
            if r.prefill_pos >= r.prefill_cap:
                # prefill complete: publish prompt blocks; the first token
                # samples from this plan's last-valid-position logits
                eng.kv.register_prefix(
                    r.req_id, np.asarray(r.prompt[: r.prefill_cap], np.int32),
                    r.layout,
                )
                r.pos = r.prefill_cap
                emit.append(self._mark_sampled(r, plan_id))
        return emit, n_tok

    def _assemble_fused(self, plan_id, active, prefill_rows, decode_rows,
                        prev_slots) -> StepPlan:
        """Padded mixed batch: every row a chunk-width slab at its own
        cursor, decode rows one valid token in C columns; tables
        scratch-filled. The layout oracle of the ragged packing
        (``ragged=False``)."""
        eng = self.eng
        grants = self._grants(prefill_rows, decode_rows)

        B, C = eng.max_batch, eng.prefill_chunk_size
        tokens = np.zeros((B, C), np.int32)
        starts = np.zeros((B,), np.int32)
        n_valid = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        positions = np.zeros((B, C), np.int32)
        p_end = np.zeros((B, C), np.int32)
        s_start = np.zeros((B, C), np.int32)
        tables = np.full((B, eng._view_blocks), eng._null_block, np.int32)
        rows = eng.kv.pool.table_array([r.req_id for r in active],
                                       eng._view_blocks)
        for i, r in enumerate(active):
            backed = rows[i] >= 0
            tables[r.slot, backed] = rows[i][backed]
            temps[r.slot] = r.temperature
            if r.prefilling:
                c = grants.get(r.req_id, 0)
                tokens[r.slot, :c] = r.prompt[r.prefill_pos : r.prefill_pos + c]
                starts[r.slot] = r.prefill_pos
                n_valid[r.slot] = c
                pp, pe, ss = eng._seg_arrays(r, r.prefill_pos, c, C)
                positions[r.slot], p_end[r.slot], s_start[r.slot] = pp[0], pe[0], ss[0]
            else:
                tokens[r.slot, 0] = self._decode_token(r, prev_slots)
                starts[r.slot] = r.pos
                n_valid[r.slot] = 1
                positions[r.slot, 0] = r.pos  # decoded tokens: position == slot

        emit, n_tok = self._mixed_bookkeeping(
            plan_id, prefill_rows, decode_rows, grants
        )
        eng.fused_slot_tokens += B * C
        eng.fused_valid_tokens += n_tok
        return StepPlan(
            plan_id=plan_id, kind="fused", tokens=tokens, starts=starts,
            temps=temps, tables=tables, prev_slots=prev_slots,
            emit_rows=tuple(emit), n_tokens=n_tok, n_valid=n_valid,
            positions=positions, p_end=p_end, s_start=s_start,
        )

    def _assemble_ragged(self, plan_id, active, prefill_rows, decode_rows,
                         prev_slots) -> StepPlan:
        """Packed mixed batch: one flat token buffer, rows back to back in
        slot order — a decode row occupies ONE slot instead of a chunk-width
        slab, so padding is only the tail alignment (``eng.pack_align``).
        Tables stay RAW (-1 holes): the attention masks unbacked pages
        instead of rerouting them to the scratch block."""
        eng = self.eng
        grants = self._grants(prefill_rows, decode_rows)

        B = eng.max_batch
        toks: List[np.ndarray] = []
        row_l: List[np.ndarray] = []
        slot_l: List[np.ndarray] = []
        pos_l: List[np.ndarray] = []
        pend_l: List[np.ndarray] = []
        sstart_l: List[np.ndarray] = []
        starts = np.zeros((B,), np.int32)
        n_valid = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        decode_idx = np.full((B,), -1, np.int32)
        last_idx = np.zeros((B,), np.int32)
        tables = np.full((B, eng._view_blocks), -1, np.int32)
        # pad-ok: ragged tables ship to the device RAW; the paged chunk
        # kernel (and its reference path) masks blk < 0 per step itself, and
        # packed_slots routes a write through a -1 entry to the scratch block.
        rows = eng.kv.pool.table_array([r.req_id for r in active],
                                       eng._view_blocks)
        cursor = 0
        for i, r in enumerate(active):   # slot order (eng.slots scan order)
            tables[r.slot] = rows[i]
            temps[r.slot] = r.temperature
            if r.prefilling:
                c = grants.get(r.req_id, 0)
                starts[r.slot] = r.prefill_pos
                n_valid[r.slot] = c
                if c == 0:
                    continue  # no budget: the row contributes no tokens
                p0 = r.prefill_pos
                toks.append(np.asarray(r.prompt[p0 : p0 + c], np.int32))
                row_l.append(np.full(c, r.slot, np.int32))
                slot_l.append(np.arange(p0, p0 + c, dtype=np.int32))
                lay = r.layout
                pos_l.append(np.asarray(lay.pos_ids[p0 : p0 + c], np.int32))
                pend_l.append(np.asarray(lay.attn_p_end[p0 : p0 + c], np.int32))
                sstart_l.append(np.asarray(lay.attn_s_start[p0 : p0 + c], np.int32))
            else:
                toks.append(np.array([self._decode_token(r, prev_slots)], np.int32))
                row_l.append(np.array([r.slot], np.int32))
                slot_l.append(np.array([r.pos], np.int32))
                pos_l.append(np.array([r.pos], np.int32))
                pend_l.append(np.zeros(1, np.int32))
                sstart_l.append(np.zeros(1, np.int32))
                starts[r.slot] = r.pos
                n_valid[r.slot] = 1
                decode_idx[r.slot] = cursor
            last_idx[r.slot] = cursor + len(toks[-1]) - 1
            cursor += len(toks[-1])

        # tail-align the flat buffer so the set of packed lengths stays
        # bounded (warmup covers each); pad tokens carry row_of = -1
        T = max(cursor, 1)
        T_pad = -(-T // eng.pack_align) * eng.pack_align

        def flat(parts, fill=0):
            out = np.full((T_pad,), fill, np.int32)
            if parts:
                cat = np.concatenate(parts)
                out[: len(cat)] = cat
            return out

        emit, n_tok = self._mixed_bookkeeping(
            plan_id, prefill_rows, decode_rows, grants
        )
        eng.fused_slot_tokens += T_pad
        eng.fused_valid_tokens += cursor
        return StepPlan(
            plan_id=plan_id, kind="ragged", tokens=flat(toks),
            starts=starts, temps=temps, tables=tables, prev_slots=prev_slots,
            emit_rows=tuple(emit), n_tokens=n_tok, n_valid=n_valid,
            positions=flat(pos_l), p_end=flat(pend_l),
            s_start=flat(sstart_l),
            row_of=flat(row_l, fill=-1),
            slots=flat(slot_l), decode_idx=decode_idx, last_idx=last_idx,
        )

    def _assemble_decode(self, plan_id, active, prev_slots) -> StepPlan:
        eng = self.eng
        B = eng.max_batch
        tokens = np.zeros((B, 1), np.int32)
        starts = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        tables = np.full((B, eng.max_blocks), eng._null_block, np.int32)
        rows = eng.kv.batch_tables([r.req_id for r in active])
        for i, r in enumerate(active):
            valid = rows[i] >= 0
            tables[r.slot, valid] = rows[i][valid]
            tokens[r.slot, 0] = self._decode_token(r, prev_slots)
            starts[r.slot] = r.pos
            temps[r.slot] = r.temperature
        emit: List[Tuple[Any, int, bool]] = []
        for r in active:
            r.pos += 1
            eng.kv.lengths[r.req_id] = r.pos
            emit.append(self._mark_sampled(r, plan_id))
        return StepPlan(
            plan_id=plan_id, kind="decode", tokens=tokens, starts=starts,
            temps=temps, tables=tables, prev_slots=prev_slots,
            emit_rows=tuple(emit), n_tokens=len(active),
        )

    # ------------------------------------------------------------- helpers
    def _decode_token(self, r, prev_slots: np.ndarray) -> int:
        """Decode-row input token. If the request's previous token was
        sampled by the plan the runner dispatched LAST, it is still device-
        resident — mark the row for on-device substitution (no host
        roundtrip, possibly not even materialized yet). Otherwise (fresh
        admission, swap-in, or a flushed pipeline) feed the host value."""
        src_plan, src_row = r._tok_src
        if src_plan >= 0 and src_plan == self.eng.runner.last_plan_id:
            prev_slots[r.slot] = src_row
            return 0  # placeholder; the runner substitutes on device
        return r.out_tokens[-1] if r.out_tokens else 0

    def _mark_sampled(self, r, plan_id: int) -> Tuple[Any, int, bool]:
        """Account one sampled token at BUILD time: bump the planned count,
        remember where the device will hold it, and decide completion by
        count (eos is checked at materialize; with the engine's default
        eos=-1 it never fires and completion is exact here)."""
        r.planned += 1
        r._tok_src = (plan_id, r.slot)
        finishing = r.planned >= r.max_new or r.pos >= self.eng.max_seq - 1
        return (r, r.slot, finishing)
