"""step_ms.open (open-loop cells; ``serving/device_runner.py`` and
``models/model.py``): the window's wall time over the engine steps in it."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    return stats.step_ms(run)
