"""arrival_lag_p99_ms (open-loop cells; the client loop and the slack
model): the 99th percentile, over the requests due in the window, of how
late the loop released each one after its due time."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    lags = [s.released - s.due for s in run.sent if run.w0 <= s.due < run.w1]
    v = stats.percentile(lags, 99)
    return None if v is None else 1e3 * v
