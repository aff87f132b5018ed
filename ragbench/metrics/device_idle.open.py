"""device_idle.open (open-loop cells; the device): the share of the
measured window in which no operation ran on the device, in percent, as
1 - (the device's busy time a step in the traced slice) / (the window's
mean step time). The profiler slows the host loop (the slice's steps run
longer than the window's, and the run prints both), which lengthens the
slice's idle gaps but not the device's work a step; so the busy time a step
comes from the trace and the step's length from the untraced window."""
from ragbench import stats


def read(run):
    if run.loop != "open" or run.trace is None or not run.trace.get("slice_steps"):
        return None
    window_step_s = stats.step_ms(run)
    if window_step_s is None:
        return None
    busy_step_s = run.trace["busy_s"] / run.trace["slice_steps"]
    return 100.0 * (1.0 - busy_step_s / (window_step_s / 1e3))
