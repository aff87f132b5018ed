"""tpot_p95_ms.open (open-loop cells; the model step): the 95th percentile
of every gap between two consecutive answer tokens of a request, both
inside the window. A token gap is a step of the host-bound engine loop, so
it moves with the host's speed from run to run; goodput_rps, which holds
each request to its deadline, is the end-to-end metric it moves."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    v = stats.percentile(stats.tpot_samples(run.sent, run.w0, run.w1), 95)
    return None if v is None else 1e3 * v
