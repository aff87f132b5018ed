"""prefix_hit_rate.open (open-loop cells; ``serving/paged_cache.py``):
the sum of ``shared_prefix_tokens`` over the sum of ``prefill_cap`` of the
requests admitted in the window, in percent."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    v = stats.prefix_hit_share(run)
    return None if v is None else 100.0 * v
