"""The arithmetic the metric readers share: whole-window percentiles, the
samples of each latency, goodput against both limits, and the FLOPs a
window computed.

Every figure is taken over the whole measured window ``[w0, w1)`` of one
run, on the benchmark's own clock: time to first token from each request's
due time (in the sweep's unloaded phase, its send time), every gap between two
answer tokens that both land in the window, and tokens delivered in it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ragbench import peaks


@dataclass
class Sent:
    """One request as the client saw it (times on the benchmark's clock)."""
    plan: object
    due: float                       # when it was due (or, unloaded, sent)
    released: float                  # when the client loop released it
    deadline_s: float                # its class's deadline, from ``due``
    segments: tuple = ()             # (prelude, docs, query) token arrays
    docs: np.ndarray = None          # the ids retrieval returned, as served
    req: object = None               # the engine's Request
    token_times: List[float] = field(default_factory=list)
    failed: bool = False             # refused by the engine
    feats: dict = field(default_factory=dict)  # the slack model's features

    @property
    def first(self) -> Optional[float]:
        return self.token_times[0] if self.token_times else None

    @property
    def finished_at(self) -> Optional[float]:
        if len(self.token_times) == self.plan.max_new:
            return self.token_times[-1]
        return None


def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile of every value (linear interpolation), or None."""
    return float(np.percentile(np.asarray(values, float), q)) if len(values) else None


def ttft_samples(sent: List[Sent], w0: float, w1: float) -> List[float]:
    """Seconds from due time to first token of every request due in the
    window; one without a token by the window's end counts at (w1 - due)."""
    out = []
    for s in sent:
        if w0 <= s.due < w1:
            out.append((s.first if s.first is not None and s.first < w1 else w1) - s.due)
    return out


def tpot_samples(sent: List[Sent], w0: float, w1: float) -> List[float]:
    """Every gap between two consecutive answer tokens inside the window."""
    out = []
    for s in sent:
        t = np.asarray(s.token_times)
        t = t[(t >= w0) & (t < w1)]
        out.extend(np.diff(t).tolist())
    return out


def good(s: Sent, ttft_limit_s: float) -> bool:
    """Finished, first token within the TTFT limit and last token within
    the class's deadline, both from the due time."""
    return (s.finished_at is not None and s.first - s.due <= ttft_limit_s
            and s.finished_at - s.due <= s.deadline_s)


def goodput_rps(sent: List[Sent], w0: float, w1: float, ttft_limit_s: float) -> float:
    """Requests finished in the window that met both limits, a second."""
    n = sum(1 for s in sent if s.finished_at is not None and w0 <= s.finished_at < w1
            and good(s, ttft_limit_s))
    return n / (w1 - w0)


def _spans(s: Sent):
    """Slot spans [start, end) of each document and the prelude's end."""
    pe = len(s.segments[0])
    spans, start = [], pe
    for d in s.segments[1]:
        spans.append((start, start + len(d)))
        start += len(d)
    return pe, spans


def visible_keys(s: Sent, lo: int, hi: int) -> int:
    """Keys that the prompt slots [lo, hi) attend in all, under the segment
    mask (a document's token: the prelude and its own segment so far; any
    other token: every slot up to its own)."""
    if hi <= lo:
        return 0
    pe, spans = _spans(s)
    total = peaks.causal_keys(lo, hi)
    for a, b in spans:
        x, y = max(lo, a), min(hi, b)
        if x < y:
            # causal over [x, y) would see slots 0..t; the mask keeps pe + (t - a + 1)
            total -= peaks.causal_keys(x, y) - (pe * (y - x) + peaks.causal_keys(x - a, y - a))
    return total


def computed_prefill(s: Sent, pos0: int, pos1: int):
    """(tokens, visible keys) of the prompt slots the program computed
    between cursor ``pos0`` and ``pos1``: the slots outside the spans the
    shared cache served."""
    shared = list(getattr(s.req, "shared_spans", []) or [])
    tokens = keys = 0
    cur = pos0
    for a, b in sorted(shared) + [(pos1, pos1)]:
        a, b = min(max(a, pos0), pos1), min(max(b, pos0), pos1)
        if a > cur:
            tokens += a - cur
            keys += visible_keys(s, cur, a)
        cur = max(cur, b)
        if cur >= pos1:
            break
    return tokens, keys


@dataclass
class Window:
    """What the client loop read at the window's edges: its clock and the
    engine's counters, each request's prefill cursor, and the prompt tokens
    (capped) and shared-block tokens of each request admitted by then."""
    t: float
    steps: int
    prefill_tokens: int
    tokens_out: int
    cursors: Dict[int, int]
    admitted: Dict[int, tuple]
    waiting: int = 0        # requests queued for admission


def window_flops(m: dict, sent: List[Sent], a: Window, b: Window) -> float:
    """The FLOPs of the tokens the program computed in the window: prompt
    slots it prefilled (not served from shared blocks) and answer tokens it
    decoded, each at ``peaks.token_flops`` for the keys it attends; the head
    is counted once for each token the window sampled."""
    flops = 0.0
    for s in sent:
        if s.req is None:
            continue
        p0 = a.cursors.get(id(s), 0)
        p1 = b.cursors.get(id(s), p0)
        n, keys = computed_prefill(s, p0, p1)
        flops += peaks.token_flops(m, n, keys, sampled=0)
        P = s.req.prefill_cap
        for i, t in enumerate(s.token_times):
            if a.t <= t < b.t:
                if i == 0:
                    flops += peaks.token_flops(m, 0, 0, sampled=1)
                else:
                    flops += peaks.token_flops(m, 1, P + i, sampled=1)
    return flops


# ---------------------------------------------------------------------------
# the readings the metric files take
# ---------------------------------------------------------------------------


def prefix_hit_share(run) -> Optional[float]:
    """Shared-block tokens over prompt tokens of the requests admitted in
    the window, as a share."""
    new = [v for k, v in run.b.admitted.items() if k not in run.a.admitted]
    cap = sum(c for c, _ in new)
    return sum(h for _, h in new) / cap if cap else None


def steps(run) -> int:
    return run.b.steps - run.a.steps


def tokens_per_step(run) -> Optional[float]:
    """Valid tokens a step in the window: prompt tokens prefilled and
    answer tokens decoded (tokens out less the first tokens, which the last
    prefill chunk yields)."""
    n = steps(run)
    if n <= 0:
        return None
    firsts = sum(1 for s in run.sent if s.first is not None and run.w0 <= s.first < run.w1)
    return ((run.b.prefill_tokens - run.a.prefill_tokens) + (run.b.tokens_out - run.a.tokens_out)
            - firsts) / n


def step_ms(run) -> Optional[float]:
    n = steps(run)
    return 1e3 * (run.w1 - run.w0) / n if n > 0 else None


def mfu_share(run) -> Optional[float]:
    """The window's computed FLOPs over (window x the bf16 dense peak)."""
    f = window_flops(run.model, run.sent, run.a, run.b)
    return f / ((run.w1 - run.w0) * peaks.PEAK_OPS_S["bfloat16"]) if f > 0 else None
