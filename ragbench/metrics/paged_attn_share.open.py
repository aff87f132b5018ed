"""paged_attn_share.open (open-loop cells; ``csrc/paged_attention.cu``):
the profiler's device time in the paged chunk and decode kernels (their
tile plan and split merge with them) over the device's busy time in the
traced slice, in percent."""

def read(run):
    if run.loop != "open" or run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.trace["paged_s"] / run.trace["busy_s"]
