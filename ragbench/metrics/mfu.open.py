"""mfu.open (open-loop cells; the whole step): the FLOPs of the tokens the
program computed in the window (``stats.window_flops``: prompt tokens not
served from shared blocks and decoded tokens, at ``peaks.token_flops``)
over the window's seconds times the card's dense bf16 peak, in percent.
The peak is the 700 W datasheet rate; the run prints the card's limit."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    v = stats.mfu_share(run)
    return None if v is None else 100.0 * v
