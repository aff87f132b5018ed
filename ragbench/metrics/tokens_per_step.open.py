"""tokens_per_step.open (open-loop cells; ``serving/engine.py`` and
``serving/control_plane.py``): valid tokens a step over the window, from the
engine's counters (prompt tokens prefilled plus answer tokens decoded,
over its steps)."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    return stats.tokens_per_step(run)
