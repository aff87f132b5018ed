"""Segmented prompts: retrieval-aware prompt structure for KV reuse.

Patchwork's cross-component claim applied to the cache layer: the Retriever
knows *which documents* it returned, so the Generator should not see a flat
token array — it should see a :class:`SegmentedPrompt` whose per-document
segments carry retrieval-assigned ``doc_id``s. The paged cache then keys a
document's KV blocks by segment-scoped content hashes instead of one
whole-prompt chained hash, and a document's blocks survive re-ranking /
re-ordering across requests.

Exactness. Naively reusing a document's KV at a different prompt position is
wrong: causal attention and RoPE make every K/V entry depend on absolute
position and on everything before it. The segmented layout therefore changes
the *prefill semantics* for document segments (Prompt-Cache / parallel-
context-windows style), making their KV genuinely order-independent:

  * layout order is ``[prelude (system)] [doc_1] ... [doc_K] [tail (query)]``;
  * prelude tokens behave classically: RoPE position == cache slot, causal;
  * each doc segment attends ONLY the prelude plus itself, and its RoPE
    positions restart at ``len(prelude)`` — so its K/V depends on
    (prelude tokens, own tokens) and nothing else;
  * tail tokens and all decoded tokens attend everything, position == slot.

Under these semantics a doc's KV blocks are bit-identical wherever the doc
lands in the prompt, so prefix sharing stays greedy-token-exact (parity with
``prefix_sharing=False`` holds by determinism), while shuffled-document RAG
workloads recover the prefill savings the whole-prompt chained hash loses.

Cache-slot layout stays contiguous (no holes): segments are packed
back-to-back, and only FULL blocks lying entirely inside one segment get
share keys. Blocks straddling a segment boundary (partial tails) are never
keyed and never shared.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

KIND_SYSTEM = "system"   # prelude: fully causal, position == slot
KIND_DOC = "doc"         # order-independent: attends prelude + self
KIND_TAIL = "tail"       # query / generation prompt: attends everything
# Multi-turn conversation history (serving.session.Session). Layout semantics
# are identical to KIND_SYSTEM — a leading history segment is prelude, fully
# causal, keyed by the legacy whole-prefix chain — but the kind survives into
# ``seg_spans`` so admission can classify its block hits as the session hit
# class (host-tier promotions of history KV are counted separately from doc
# promotions in telemetry and the Generator cost model).
KIND_HISTORY = "history"


@dataclass(frozen=True)
class Segment:
    tokens: np.ndarray
    kind: str = KIND_TAIL
    doc_id: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self, "tokens", np.atleast_1d(np.asarray(self.tokens, np.int32))
        )


@dataclass
class SegmentedPrompt:
    """System / per-document / query segments, in layout order. Document
    segments must come between the prelude (leading non-doc segments) and the
    tail (trailing non-doc segments); the assembler below enforces this."""

    segments: List[Segment]

    @property
    def tokens(self) -> np.ndarray:
        if not self.segments:
            return np.zeros(0, np.int32)
        return np.concatenate([s.tokens for s in self.segments])

    def __len__(self) -> int:
        return int(sum(len(s.tokens) for s in self.segments))

    @staticmethod
    def flat(tokens) -> "SegmentedPrompt":
        """Degenerate single-segment prompt: reproduces the classic
        whole-prompt chained-hash caching exactly."""
        return SegmentedPrompt([Segment(tokens, KIND_SYSTEM)])

    def extended(self, extra_tokens) -> "SegmentedPrompt":
        """Continuation prompt for preemption/requeue: generated tokens are
        appended to the tail segment (or become one)."""
        extra = np.atleast_1d(np.asarray(extra_tokens, np.int32))
        if extra.size == 0:
            return SegmentedPrompt(list(self.segments))
        segs = list(self.segments)
        if segs and segs[-1].kind == KIND_TAIL:
            last = segs.pop()
            segs.append(Segment(np.concatenate([last.tokens, extra]), KIND_TAIL))
        else:
            segs.append(Segment(extra, KIND_TAIL))
        return SegmentedPrompt(segs)


def assemble_prompt(
    query_tokens,
    doc_token_lists: Sequence,
    doc_ids: Optional[Sequence[int]] = None,
    system_tokens=None,
) -> SegmentedPrompt:
    """Canonical RAG layout: [system][doc_1..doc_K][query]. The query rides in
    the tail so document KV never depends on it (cross-request reuse)."""
    segs: List[Segment] = []
    if system_tokens is not None and np.asarray(system_tokens).size:
        segs.append(Segment(system_tokens, KIND_SYSTEM))
    for i, toks in enumerate(doc_token_lists):
        did = int(doc_ids[i]) if doc_ids is not None else None
        segs.append(Segment(toks, KIND_DOC, doc_id=did))
    if query_tokens is not None and np.asarray(query_tokens).size:
        segs.append(Segment(query_tokens, KIND_TAIL))
    if not segs:
        segs.append(Segment(np.zeros(1, np.int32), KIND_TAIL))
    return SegmentedPrompt(segs)


# ---------------------------------------------------------------------------
# layout: positions, attention spans, and block share-keys
# ---------------------------------------------------------------------------


@dataclass
class SegmentLayout:
    """Host-side per-request prefill plan for a (possibly truncated) prompt.

    ``pos_ids[t]``      RoPE position of the token at cache slot ``t``.
    ``attn_p_end[t]``   slots ``< attn_p_end[t]`` are always attendable
                        (the prelude, for doc tokens).
    ``attn_s_start[t]`` slots ``attn_s_start[t] .. t`` are attendable
                        (the token's own segment so far).
    ``block_keys[b]``   segment-scoped content-hash share key of FULL block
                        ``b``, or None when the block straddles a segment
                        boundary / the prompt end (never shared).

    The flat single-segment layout degenerates to ``pos_ids == arange``,
    ``attn_p_end == attn_s_start == 0`` (plain causal) and ``block_keys ==
    prefix_block_keys`` — the classic whole-prompt chained hash.
    """

    tokens: np.ndarray
    block_size: int
    pos_ids: np.ndarray
    attn_p_end: np.ndarray
    attn_s_start: np.ndarray
    block_keys: List[Optional[bytes]]
    seg_spans: List[Tuple[int, int, str]] = field(default_factory=list)

    @property
    def n_tokens(self) -> int:
        return int(len(self.tokens))

    def history_block_set(self) -> set:
        """Block ordinals lying ENTIRELY inside a conversation-history segment
        (``KIND_HISTORY``) — the session hit class. Blocks straddling a
        history/non-history boundary are conservatively classified as ordinary
        blocks (they are either unkeyed straddlers or prelude-chain blocks
        whose tokens are not purely history)."""
        out: set = set()
        bs = self.block_size
        for start, end, kind in self.seg_spans:
            if kind != KIND_HISTORY:
                continue
            b = -(-start // bs)               # first block fully >= start
            while (b + 1) * bs <= end:
                out.add(b)
                b += 1
        return out


def _h(*parts: bytes) -> bytes:
    h = hashlib.sha1()
    for p in parts:
        h.update(p)
    return h.digest()


def _tok_bytes(tokens: np.ndarray) -> bytes:
    return np.ascontiguousarray(tokens, dtype=np.int64).tobytes()


def _segment_block_keys(
    keys: List[Optional[bytes]],
    seed: bytes,
    seg_tokens: np.ndarray,
    start: int,
    block_size: int,
    chain_seeded: bool,
) -> None:
    """Assign chained keys to the full blocks lying entirely inside the
    segment spanning slots ``[start, start + len(seg_tokens))``.

    ``chain_seeded=False`` reproduces the legacy whole-prompt chain for the
    prelude (H_0 = sha1(b"" || block_0) == prefix_block_keys); doc/tail
    segments chain from ``seed`` and fold the segment's unaligned head slice
    first, so a key captures everything the block's KV depends on."""
    bs = block_size
    end = start + len(seg_tokens)
    first_block = -(-start // bs)                 # first block fully >= start
    off = first_block * bs - start                # unaligned head tokens
    running = seed
    if chain_seeded and off:
        running = _h(running, _tok_bytes(seg_tokens[:off]))
    b = first_block
    while (b + 1) * bs <= end:
        lo = b * bs - start
        running = _h(running, _tok_bytes(seg_tokens[lo : lo + bs]))
        keys[b] = running
        b += 1


def build_layout(prompt, block_size: int, cap: Optional[int] = None) -> SegmentLayout:
    """Compute the prefill plan for ``prompt`` (SegmentedPrompt or flat
    tokens), truncated to ``cap`` tokens (engine capacity).

    Invariants the paged cache and engine rely on:

    * **packing**: segments occupy contiguous cache slots in layout order
      with no holes; ``tokens`` is exactly the packed (truncated) prompt and
      ``len(block_keys) == ceil(len(tokens) / block_size)``.
    * **key scoping**: ``block_keys[b]`` is non-None only for a FULL block
      lying entirely inside one segment. A doc block's key depends on
      (prelude tokens, the doc's own tokens up to that block) and NOTHING
      else — that is the exact set its K/V depends on under the segmented
      prefill semantics, so equal key <=> bit-identical block. Blocks
      straddling a segment boundary, trailing partial blocks, and anything
      past ``cap`` are never keyed (never shared).
    * **flat degeneration**: a flat/single-segment prompt yields ``pos_ids ==
      arange``, ``attn_p_end == attn_s_start == 0`` (plain causal) and
      ``block_keys == prefix_block_keys(tokens)`` — the classic whole-prompt
      chained hash, so flat and segmented requests share one index.
    * **attention spans**: for every token ``t``, the attendable slot set is
      ``[0, attn_p_end[t]) U [attn_s_start[t], t]``; prelude/tail tokens have
      both bounds 0 (full causal), doc tokens have ``p_end = prelude_end``
      and ``s_start`` = their segment start, and their ``pos_ids`` restart at
      ``prelude_end`` — the order-independence construction.
    * **truncation**: ``cap`` truncates mid-segment rather than dropping
      whole segments; a truncated doc segment keeps its (now shorter) span
      and keys only the full blocks that survived.
    """
    if not isinstance(prompt, SegmentedPrompt):
        prompt = SegmentedPrompt.flat(prompt)
    bs = block_size
    # ---- pack segments into contiguous slots, truncating at cap
    spans: List[Tuple[int, int, str, Optional[int], np.ndarray]] = []
    cursor = 0
    for seg in prompt.segments:
        if cap is not None and cursor >= cap:
            break
        toks = seg.tokens
        if cap is not None and cursor + len(toks) > cap:
            toks = toks[: cap - cursor]
        if len(toks) == 0:
            continue
        spans.append((cursor, cursor + len(toks), seg.kind, seg.doc_id, toks))
        cursor += len(toks)
    L = cursor
    pos_ids = np.arange(max(L, 1), dtype=np.int32)[:L]
    p_end = np.zeros(L, np.int32)
    s_start = np.zeros(L, np.int32)
    n_blocks = -(-L // bs) if L else 0
    keys: List[Optional[bytes]] = [None] * n_blocks

    # prelude = leading non-doc segments (classic causal, position == slot);
    # everything after the first doc that is not a doc is tail (attends all)
    first_doc = next((i for i, sp in enumerate(spans) if sp[2] == KIND_DOC), None)
    prelude_end = spans[first_doc][0] if first_doc is not None else L
    prelude_toks = (
        np.concatenate([sp[4] for sp in spans[:first_doc]])
        if first_doc not in (None, 0)
        else np.zeros(0, np.int32)
    )
    prelude_hash = _h(b"prelude", _tok_bytes(prelude_toks))

    # legacy chained keys over the prelude region (and the whole flat prompt)
    running = b""
    b = 0
    while (b + 1) * bs <= prelude_end:
        running = _h(running, _tok_bytes(prompt_slice(spans, b * bs, (b + 1) * bs)))
        keys[b] = running
        b += 1

    for start, end, kind, doc_id, toks in spans:
        if kind == KIND_DOC:
            p_end[start:end] = prelude_end
            s_start[start:end] = start
            pos_ids[start:end] = prelude_end + np.arange(end - start)
            seed = _h(b"doc", prelude_hash)
            _segment_block_keys(keys, seed, toks, start, bs, chain_seeded=True)
        # non-doc segments after the first doc form the tail: full causal
        # (p_end/s_start stay 0, position == slot); their keys are chained
        # over the ENTIRE preceding layout below — shareable only on an exact
        # whole-prefix match, since their KV depends on everything before
    if first_doc is not None:
        # hash everything before the tail region (prelude + docs, in order)
        tail_start = max((sp[1] for sp in spans if sp[2] == KIND_DOC), default=prelude_end)
        pre_tail = prompt_slice(spans, 0, tail_start)
        seed = _h(b"tail", _tok_bytes(pre_tail))
        tail_toks = prompt_slice(spans, tail_start, L)
        if len(tail_toks):
            _segment_block_keys(keys, seed, tail_toks, tail_start, bs, chain_seeded=True)

    seg_spans = [(sp[0], sp[1], sp[2]) for sp in spans]
    return SegmentLayout(
        tokens=prompt_slice(spans, 0, L),
        block_size=bs,
        pos_ids=pos_ids,
        attn_p_end=p_end,
        attn_s_start=s_start,
        block_keys=keys,
        seg_spans=seg_spans,
    )


def prompt_slice(spans, lo: int, hi: int) -> np.ndarray:
    """Tokens at layout slots [lo, hi) from packed segment spans."""
    parts = []
    for start, end, _kind, _did, toks in spans:
        a, b = max(lo, start), min(hi, end)
        if a < b:
            parts.append(toks[a - start : b - start])
    if not parts:
        return np.zeros(0, np.int32)
    return np.concatenate(parts)
