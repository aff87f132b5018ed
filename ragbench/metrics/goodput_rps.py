"""goodput_rps (open-loop cells): requests finished in the window whose first
token came within the mix's TTFT limit and whose last token within their
class's deadline, both from the due time, over the window's seconds."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    return stats.goodput_rps(run.sent, run.w0, run.w1, run.traffic.ttft_limit_s)
