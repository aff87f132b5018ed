"""The metric arithmetic: whole-window percentiles, the censoring of
requests without a token at the window's end, goodput against both
limits, and the keys a token attends under the segment mask."""
import numpy as np
import pytest

from ragbench import peaks, stats
from ragbench.workload import Plan


def sent(due, times, max_new=None, deadline=10.0):
    p = Plan(0, due, 0, max_new or len(times), np.zeros(1, np.int32), np.zeros(1, np.int64))
    return stats.Sent(p, due, due, deadline, token_times=list(times))


def test_percentile_is_over_every_value():
    xs = list(range(1, 201))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([], 95) is None


def test_ttft_counts_requests_due_in_the_window_and_censors_at_its_end():
    w0, w1 = 10.0, 20.0
    rs = [sent(9.0, [9.5]),            # due before the window: not counted
          sent(11.0, [11.4, 11.5]),    # 0.4 s
          sent(15.0, []),              # no token yet: counts at 20 - 15
          sent(18.0, [21.0]),          # first token after the end: 20 - 18
          sent(20.0, [20.1])]          # due at the end: not counted
    assert sorted(stats.ttft_samples(rs, w0, w1)) == pytest.approx([0.4, 2.0, 5.0])


def test_tpot_takes_gaps_inside_the_window_only():
    rs = [sent(0.0, [9.0, 10.5, 11.0, 12.5, 21.0])]
    assert stats.tpot_samples(rs, 10.0, 20.0) == pytest.approx([0.5, 1.5])


def test_goodput_needs_both_limits_and_a_finish_inside_the_window():
    w0, w1, ttft = 0.0, 10.0, 1.0
    rs = [sent(1.0, [1.5, 2.0, 3.0], deadline=5.0),     # good
          sent(1.0, [2.5, 3.0], deadline=5.0),          # TTFT 1.5 > 1
          sent(1.0, [1.2, 7.0], deadline=5.0),          # end-to-end 6 > 5
          sent(1.0, [1.2, 2.0], max_new=3),             # unfinished
          sent(8.0, [8.5, 10.5], deadline=5.0)]         # finishes after the window
    assert stats.goodput_rps(rs, w0, w1, ttft) == pytest.approx(1 / 10)


def brute_keys(pe, docs, lo, hi):
    """Visible keys of slots [lo, hi) from the mask itself."""
    n = max(pe + sum(docs), hi) + 1
    p_end, s_start = np.zeros(n, int), np.zeros(n, int)
    start = pe
    for d in docs:
        p_end[start:start + d], s_start[start:start + d] = pe, start
        start += d
    total = 0
    for t in range(lo, hi):
        u = np.arange(t + 1)
        total += int(((u < p_end[t]) | (u >= s_start[t])).sum())
    return total


@pytest.mark.parametrize("lo,hi", [(0, 16), (5, 50), (16, 80), (40, 100), (90, 110), (0, 110)])
def test_visible_keys_follow_the_segment_mask(lo, hi):
    docs = [32, 20, 28]
    s = stats.Sent(None, 0.0, 0.0, 1.0, (np.zeros(16), [np.zeros(d) for d in docs], np.zeros(10)))
    assert stats.visible_keys(s, lo, hi) == brute_keys(16, docs, lo, hi)


def test_computed_prefill_leaves_out_the_shared_spans():
    docs = [32, 32]
    s = stats.Sent(None, 0.0, 0.0, 1.0, (np.zeros(16), [np.zeros(d) for d in docs], np.zeros(8)))

    class Req:
        shared_spans = [(0, 16), (48, 80)]

    s.req = Req()
    n, keys = stats.computed_prefill(s, 0, 88)
    assert n == 88 - 16 - 32
    assert keys == brute_keys(16, docs, 16, 48) + brute_keys(16, docs, 80, 88)
    assert stats.computed_prefill(s, 20, 60) == (28, brute_keys(16, docs, 20, 48))


def test_token_flops():
    m = {"num_hidden_layers": 2, "hidden_size": 8, "intermediate_size": 16,
         "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4, "vocab_size": 10}
    per_layer = 8 * (8 + 2 * 4) + 8 * 8 + 3 * 8 * 16
    assert peaks.layer_matmul_params(m) == per_layer
    assert peaks.token_flops(m, 3, 7, 1) == 2 * per_layer * 3 * 2 + 4 * 2 * 4 * 7 * 2 + 2 * 8 * 10
    assert peaks.causal_keys(3, 6) == 4 + 5 + 6
