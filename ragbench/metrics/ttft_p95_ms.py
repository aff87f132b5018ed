"""ttft_p95_ms (open-loop cells): the 95th percentile, over every request
due in the window, of the time from its due time to its first answer token,
retrieval included; a request still without a token at the window's end
counts at (end - due)."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    v = stats.percentile(stats.ttft_samples(run.sent, run.w0, run.w1), 95)
    return None if v is None else 1e3 * v
