"""Multi-turn conversation sessions over the paged serving stack.

A :class:`Session` carries a conversation's accumulated history tokens and
builds each turn's prompt with the history as a leading ``KIND_HISTORY``
segment. Because a leading non-doc segment is prelude (classic causal,
position == slot, keyed by the legacy whole-prefix chain — see
``serving.segments.build_layout``), turn N+1's history prefix hashes to
exactly the block keys turn N published:

  * while the blocks are still warm in HBM, the next turn HBM-hits them
    (``Request.shared_prefix_tokens`` / ``session_shared_tokens``);
  * once evicted, the reference demotes them into its host block tier and
    the next turn's admission promotes them back (the *session hit class*).
    The port has no host tier yet, so an evicted history block is simply
    recomputed by the next turn.

No engine changes are needed per turn: the session only shapes prompts and
accumulates history; every turn re-reads the entire conversation so far,
which makes session history a very prefix-heavy workload.

History growth is token-exact: ``commit`` appends the turn's query and the
decoded answer, so the next prompt's history region reproduces, token for
token, a prefix of what the previous turn computed (prompt blocks were
published at prefill completion; decode tokens are recomputed once and then
published by the turn that carried them in its history).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.segments import (
    KIND_DOC,
    KIND_HISTORY,
    KIND_TAIL,
    Segment,
    SegmentedPrompt,
)


class Session:
    """One conversation: builds per-turn prompts, accumulates history.

    ``max_history`` caps the history region (in tokens): once reached the
    history stops growing — trimming from the front would change the prefix
    chain and forfeit every cached block, so a capped session keeps serving
    its frozen prefix instead.
    """

    def __init__(self, session_id: int = 0, system_tokens=None,
                 max_history: Optional[int] = None):
        self.session_id = session_id
        self.max_history = max_history
        if system_tokens is not None and np.asarray(system_tokens).size:
            self.history = np.atleast_1d(np.asarray(system_tokens, np.int32))
        else:
            self.history = np.zeros(0, np.int32)
        self.turns = 0

    def __len__(self) -> int:
        return int(len(self.history))

    def prompt(self, query_tokens, doc_token_lists: Sequence = (),
               doc_ids: Optional[Sequence[int]] = None) -> SegmentedPrompt:
        """This turn's prompt: ``[history][doc_1..doc_K][query]``. Without
        docs the whole prompt is prelude, so even the query blocks become
        reusable by the next turn's longer history."""
        segs: List[Segment] = []
        if len(self.history):
            segs.append(Segment(self.history, KIND_HISTORY))
        for i, toks in enumerate(doc_token_lists):
            did = int(doc_ids[i]) if doc_ids is not None else None
            segs.append(Segment(toks, KIND_DOC, doc_id=did))
        q = np.atleast_1d(np.asarray(query_tokens, np.int32))
        if q.size:
            segs.append(Segment(q, KIND_TAIL))
        if not segs:
            segs.append(Segment(np.zeros(1, np.int32), KIND_TAIL))
        return SegmentedPrompt(segs)

    def commit(self, query_tokens, answer_tokens) -> None:
        """Fold a completed turn's exchange into the history."""
        q = np.atleast_1d(np.asarray(query_tokens, np.int32))
        a = np.atleast_1d(np.asarray(answer_tokens, np.int32))
        if self.max_history is None or len(self.history) < self.max_history:
            grown = np.concatenate([self.history, q, a])
            if self.max_history is not None:
                grown = grown[: self.max_history]
            self.history = grown
        self.turns += 1
