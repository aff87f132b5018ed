"""How the port's scan kernels cut the time axis, on the CPU (no kernel is
launched): the segment rules of the WKV kernel (``wkv_segments``) and the
selective scan (``ssm_segments``) and of their backward kernels
(``wkv_backward_segments``, ``ssm_backward_segments``: whole chunks a
segment, one wave of the output pass), and the segmented algebra both kernels
run on the card, written out here in plain torch: a segment pass gives each
segment's end state from a zero state (segment 0 from the given state) and
its decay, a carry gives each segment's start state, and an output pass
runs each segment from it with y (the WKV kernel chunk by chunk, as its
tensor-core products compute it; the scan step by step). Held against
the port's plain versions (``ref_rwkv6_chunked``, ``ref_ssm_scan``) and the
JAX package's (``repro.kernels.ref.rwkv6_ref``, ``ssm_scan_ref``) on the
same numpy inputs, at the kernels' tolerances, including decays near 0 and
extreme dt. The card tests hold the kernels' own segment counts to these
rules (``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import rwkv6_scan as kw
from repro_torch.kernels import ssm_scan as ks

# output-pass blocks the H100's 132 SMs hold at once, at 4 or 6 blocks an SM
# (the wrappers ask the CUDA occupancy query; these cover both counts)
SLOTS = (132 * 4, 132 * 6)
WKV_SERVE = (1, 64)          # rwkv6-7b prefill: B, H
SSM_SERVE = (1, 1600, 16)    # hymba-1.5b prefill: B, Di, N
# the kernels' tolerances against their plain versions (f32 on both sides)
WKV_TOL = dict(atol=1e-4, rtol=1e-4)
SSM_TOL = dict(atol=1e-4, rtol=1e-4)
LOG2E = 1.4426950408889634


def _rule(which, S, slots=SLOTS[0]):
    if which == "wkv":
        return kw.wkv_segments(slots, *WKV_SERVE, S)
    return ks.ssm_segments(slots, *SSM_SERVE, S)


def _blocks_a_segment(which):
    """Output-pass blocks of one segment at the serve shapes: one a head
    (WKV), one per 64 channels (the scan at N 16)."""
    return 64 if which == "wkv" else -(-1600 // 64)


def _serve_seg(which):
    """seg_len at the serve phase's longest prefill (2048 / 1664 steps)."""
    return _rule(which, 2048 if which == "wkv" else 1664)[1]


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("which", ["wkv", "ssm"])
@pytest.mark.parametrize("S", ["1", "2", "seg-1", "seg", "seg+1", "2048"])
def test_segments_cover_every_step_once(S, which, slots):
    seg = _serve_seg(which)
    S = {"1": 1, "2": 2, "seg-1": seg - 1, "seg": seg, "seg+1": seg + 1, "2048": 2048}[S]
    n_seg, seg_len = _rule(which, S, slots)
    assert n_seg >= 1 and seg_len >= 1
    covered = np.zeros(S, np.int64)
    for j in range(n_seg):
        s0, s1 = j * seg_len, min(S, (j + 1) * seg_len)
        assert s1 > s0                                  # no segment is empty
        covered[s0:s1] += 1
    np.testing.assert_array_equal(covered, 1)
    if n_seg > 1:
        assert seg_len >= 32                            # _MIN_SEGMENT


@pytest.mark.parametrize("S", [1, 2, 16])
def test_decode_takes_one_segment(S):
    for slots in SLOTS:
        assert kw.wkv_segments(slots, 8, 64, S) == (1, S)
        assert ks.ssm_segments(slots, 8, 1600, 16, S) == (1, S)
        assert kw.wkv_segments(slots, 1, 64, S) == (1, S)
        assert ks.ssm_segments(slots, 1, 1600, 16, S) == (1, S)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("which,S", [("wkv", 301), ("wkv", 1519), ("wkv", 2048),
                                     ("ssm", 429), ("ssm", 1647), ("ssm", 1664)])
def test_serve_prefill_is_split_within_one_wave(which, S, slots):
    """The serve phase's prefills (rwkv6-7b prompts of 301-1519 tokens up to
    the 2048 the engine admits; hymba-1.5b's 429-1647 positions up to 1664)
    get several segments, and the output pass's blocks fit the card at once
    but would not with one segment more (where the length allows it)."""
    n_seg, seg_len = _rule(which, S, slots)
    assert n_seg > 1
    assert n_seg * _blocks_a_segment(which) <= slots
    if S // (n_seg + 1) >= 32:
        assert (n_seg + 1) * _blocks_a_segment(which) > slots


# ---------------------------------------------------------------------------
# the backward kernels' segments
# ---------------------------------------------------------------------------

# backward output-pass blocks the H100 holds at once, at 1, 2 or 3 blocks an
# SM (the wrappers ask the CUDA occupancy query; these cover the counts)
BWD_SLOTS = (132, 132 * 2, 132 * 3)
WKV_TRAIN = (1, 64)           # rwkv6-7b's training microbatch: B, H (S 2048)
SSM_TRAIN = (1, 1600, 16)     # hymba-1.5b's: B, Di, N (S 2176: 128 meta + 2048 tokens)


def _bwd_rule(which, S, slots):
    if which == "wkv":
        return kw.wkv_backward_segments(slots, *WKV_TRAIN, S)
    return ks.ssm_backward_segments(slots, *SSM_TRAIN, S)


def _bwd_chunk(which):
    return kw.BACKWARD_CHUNK if which == "wkv" else ks.BACKWARD_CHUNK


def _bwd_blocks_a_segment(which):
    """Output-pass blocks of one backward segment at the training shapes: one
    a head (WKV), one per 1024 / N channels (the scan)."""
    return 64 if which == "wkv" else -(-1600 // (1024 // 16))


@pytest.mark.parametrize("slots", BWD_SLOTS)
@pytest.mark.parametrize("which", ["wkv", "ssm"])
@pytest.mark.parametrize("S", ["1", "2", "chunk-1", "chunk", "chunk+1", "seg-1", "seg", "seg+1",
                               "train"])
def test_backward_segments_cover_every_step_once(S, which, slots):
    """Whole chunks a segment, none empty, every step in exactly one, at
    lengths about a chunk's and a segment's edges (the segment the rule
    gives at the training length)."""
    chunk = _bwd_chunk(which)
    train = 2048 if which == "wkv" else 2176
    seg = _bwd_rule(which, train, slots)[1]
    S = {"1": 1, "2": 2, "chunk-1": chunk - 1, "chunk": chunk, "chunk+1": chunk + 1,
         "seg-1": seg - 1, "seg": seg, "seg+1": seg + 1, "train": train}[S]
    n_seg, seg_len = _bwd_rule(which, S, slots)
    assert n_seg >= 1 and seg_len >= chunk and seg_len % chunk == 0
    covered = np.zeros(S, np.int64)
    for j in range(n_seg):
        s0, s1 = j * seg_len, min(S, (j + 1) * seg_len)
        assert s1 > s0                                  # no segment is empty
        covered[s0:s1] += 1
    np.testing.assert_array_equal(covered, 1)
    if n_seg > 1:                                       # _BACKWARD_MIN_CHUNKS
        assert seg_len >= (kw._BACKWARD_MIN_CHUNKS if which == "wkv"
                           else ks._BACKWARD_MIN_CHUNKS) * chunk


@pytest.mark.parametrize("which", ["wkv", "ssm"])
def test_backward_segments_are_a_function_of_shapes_alone(which):
    """The rule reads nothing but its arguments: the same shapes and slots
    give the same cut, one step (a single chunk) gives one segment, and a
    batch too wide for one wave gives one segment a row."""
    for S in (1, 37, 1000, 2048):
        assert _bwd_rule(which, S, 264) == _bwd_rule(which, S, 264)
    assert _bwd_rule(which, 1, 264) == (1, _bwd_chunk(which))
    if which == "wkv":
        assert kw.wkv_backward_segments(264, 8, 64, 2048) == (1, 2048)
    else:
        assert ks.ssm_backward_segments(264, 16, 1600, 16, 2176) == (1, 2176)


@pytest.mark.parametrize("slots", BWD_SLOTS)
@pytest.mark.parametrize("which,S", [("wkv", 2048), ("wkv", 1000), ("wkv", 513),
                                     ("ssm", 2176), ("ssm", 1000), ("ssm", 257)])
def test_backward_blocks_fit_one_wave(which, S, slots):
    """At the training shapes the backward's output-pass blocks fit the card
    at once, and segments one chunk shorter would not (where the length
    allows that many: at most one segment per _BACKWARD_MIN_CHUNKS
    chunks)."""
    n_seg, seg_len = _bwd_rule(which, S, slots)
    blocks = _bwd_blocks_a_segment(which)
    assert n_seg * blocks <= slots
    chunk = _bwd_chunk(which)
    per, n_chunk = seg_len // chunk, -(-S // chunk)
    min_chunks = kw._BACKWARD_MIN_CHUNKS if which == "wkv" else ks._BACKWARD_MIN_CHUNKS
    shorter = -(-n_chunk // (per - 1)) if per > 1 else n_chunk + 1
    if shorter <= n_chunk // min_chunks:     # the length allows that many
        assert shorter * blocks > slots


# ---------------------------------------------------------------------------
# the segmented algebra
# ---------------------------------------------------------------------------

def _segments(n_seg, seg_len, S):
    return [(j * seg_len, min(S, (j + 1) * seg_len)) for j in range(n_seg)]


def wkv_chunks(r, k, v, w, u, state, with_y, L=16):
    """The WKV kernel's passes over one segment, chunk by chunk, as its
    tensor-core products compute them: for each chunk of L steps (padded
    with k = v = r = 0, w = 1) and its start state S_c,

        y_t   = R~_t S_c + sum_{tau <= t} A[t, tau] v_tau,
        S_c' = diag(prod_t w_t) S_c + sum_tau K~_tau v_tau^T,

    with R~_t = r_t * prod_{s < t} w_s, K~_tau = k_tau * prod_{s > tau} w_s,
    A[t, tau] = sum_k r_t[k] k_tau[k] prod_{tau < s < t} w_s[k] (tau < t)
    and A[t, t] = sum_k r_t[k] u[k] k_t[k]: products of decays, never a
    quotient. Returns (y of the segment or None, end state)."""
    B, T, H, hd = k.shape
    ys = []
    for c0 in range(0, T, L):
        tc = min(L, T - c0)

        def pad(x, fill):
            return torch.cat([x[:, c0:c0 + tc], torch.full((B, L - tc, H, hd), fill)], 1)

        kc, wc, vc = pad(k, 0.0), pad(w, 1.0), pad(v, 0.0)
        suffix = torch.ones((B, H, hd))
        kt = [None] * L
        for t in reversed(range(L)):
            kt[t] = kc[:, t] * suffix
            suffix = suffix * wc[:, t]
        if with_y:
            rc = pad(r, 0.0)
            prefix = torch.ones((B, H, hd))
            rt = []
            for t in range(L):
                rt.append(rc[:, t] * prefix)
                prefix = prefix * wc[:, t]
            A = torch.zeros((B, H, L, L))
            for tau in range(L):
                q = kc[:, tau]
                A[:, :, tau, tau] = (rc[:, tau] * u * q).sum(-1)
                for t in range(tau + 1, L):
                    A[:, :, t, tau] = (rc[:, t] * q).sum(-1)
                    q = q * wc[:, t]
            y = (torch.einsum("bhtk,bhkv->bhtv", torch.stack(rt, 2), state)
                 + torch.einsum("bhts,bshv->bhtv", A, vc))
            ys.append(y[:, :, :tc].transpose(1, 2))
        state = (suffix[..., None] * state
                 + torch.einsum("tbhk,bthv->bhkv", torch.stack(kt), vc))
    return (torch.cat(ys, 1) if with_y else None), state


def wkv_segmented(r, k, v, w, u, state0, n_seg, seg_len):
    """The WKV kernel's algebra: the segment pass gives the end state of
    segments 0 .. n_seg - 2 (segment 0 from state0, the others from a zero
    state) and their decays D = prod_t w_t; the carry S_start[j] = D[j-1] *
    S_start[j-1] + S_loc[j-1]; the output pass runs each segment from its
    start state with y. Both passes go chunk by chunk (``wkv_chunks``)."""
    B, S, H, hd = r.shape
    segs = _segments(n_seg, seg_len, S)
    zero = torch.zeros((B, H, hd, hd))
    ends, decays = [], []
    for j, (s0, s1) in enumerate(segs[:-1]):
        part = [t[:, s0:s1] for t in (r, k, v, w)]
        _, end = wkv_chunks(*part, u, state0 if j == 0 and state0 is not None else zero,
                            with_y=False)
        ends.append(end)
        decays.append(torch.prod(w[:, s0:s1], dim=1))
    ys, state = [], None
    for j, (s0, s1) in enumerate(segs):
        if j == 0:
            start = state0 if state0 is not None else zero
        else:
            start = ends[0]
            for i in range(1, j):
                start = decays[i][..., None] * start + ends[i]
        y, state = wkv_chunks(*(t[:, s0:s1] for t in (r, k, v, w)), u, start, with_y=True)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssm_segmented(dt, x, bm, cm, a_log, h0, n_seg, seg_len):
    """The scan kernel's algebra: segments 0 .. n_seg - 2 give h_loc from a
    zero state (segment 0 from h0) and the sum of dt; the carry h_start[j] =
    exp2(A log2(e) sum dt[j-1]) * h_start[j-1] + h_loc[j-1]; the output pass
    reruns the scan over each segment with y."""
    S = dt.shape[1]
    segs = _segments(n_seg, seg_len, S)
    a2 = -torch.exp(a_log.float()) * LOG2E
    ends, dsums = [], []
    for j, (s0, s1) in enumerate(segs[:-1]):
        part = [t[:, s0:s1] for t in (dt, x, bm, cm)]
        _, h_end = ks.ref_ssm_scan(*part, a_log, h0 if j == 0 else None)
        ends.append(h_end)
        dsums.append(dt[:, s0:s1].float().sum(1))
    ys, h = [], None
    for j, (s0, s1) in enumerate(segs):
        if j == 0:
            start = h0
        else:
            start = ends[0]
            for i in range(1, j):
                start = torch.exp2(a2[None] * dsums[i][..., None]) * start + ends[i]
        y, h = ks.ref_ssm_scan(*(t[:, s0:s1] for t in (dt, x, bm, cm)), a_log, start)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _wkv_inputs(seed, B, S, H, hd, decay):
    rng = np.random.default_rng(seed)
    r, k = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(2))
    v = rng.standard_normal((B, S, H, hd))
    if decay is None:    # realistic Finch decay: w = exp(-exp(z)), z ~ N(0, 0.5)
        w = np.exp(-np.exp(0.5 * rng.standard_normal((B, S, H, hd))))
    else:
        w = np.full((B, S, H, hd), decay)
    u = 0.3 * rng.standard_normal((H, hd))
    state0 = 0.5 * rng.standard_normal((B, H, hd, hd))
    return [a.astype(np.float32) for a in (r, k, v, w, u, state0)]


@pytest.mark.parametrize("S,decay", [(300, None), (257, 0.45), (200, 1e-6), (64, None)],
                         ids=["S300", "w0.45", "w1e-6", "S64"])
def test_wkv_segmented_algebra_matches_the_recurrence(S, decay):
    """Cut by the rule at rwkv6-7b's serve shapes, on 2 heads of hd 64."""
    n_seg, seg_len = _rule("wkv", S)
    assert n_seg > 1
    arrays = _wkv_inputs(S, 2, S, 2, 64, decay)
    r, k, v, w, u, state0 = map(torch.from_numpy, arrays)
    y, st = wkv_segmented(r, k, v, w, u, state0, n_seg, seg_len)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    y_ref, st_ref = kw.ref_rwkv6_chunked(r, k, v, w, u, state0)
    torch.testing.assert_close(y, y_ref, **WKV_TOL)
    torch.testing.assert_close(st, st_ref, **WKV_TOL)
    y_jax, st_jax = jax_ref.rwkv6_ref(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **WKV_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_jax), **WKV_TOL)
    # from a zero state
    y0, st0 = wkv_segmented(r, k, v, w, u, None, n_seg, seg_len)
    y0_jax, st0_jax = jax_ref.rwkv6_ref(*map(jnp.asarray, arrays[:5]))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_jax), **WKV_TOL)
    np.testing.assert_allclose(st0.numpy(), np.asarray(st0_jax), **WKV_TOL)


def _ssm_inputs(seed, B, S, Di, N, extreme):
    """dt = softplus(z), z ~ N(-2, 1) (dt * A near -0.1 .. -2), or for
    ``extreme`` z ~ N(0, 2) (dt up to ~6, dt * A down to about -100)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, S, Di)) * (2.0 if extreme else 1.0) - (0.0 if extreme else 2.0)
    dt = np.log1p(np.exp(z))
    x = rng.standard_normal((B, S, Di))
    bm, cm = (0.5 * rng.standard_normal((B, S, N)) for _ in range(2))
    a_log = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float64), (Di, N)))
    return [a.astype(np.float32) for a in (dt, x, bm, cm, a_log)]


@pytest.mark.parametrize("S,N,extreme", [(320, 16, False), (200, 16, True), (129, 8, False),
                                         (64, 16, True)],
                         ids=["S320", "S200-extreme", "N8-S129", "S64-extreme"])
def test_ssm_segmented_algebra_matches_the_scan(S, N, extreme):
    """Cut by the rule at hymba-1.5b's serve shapes, on 48 channels; h0 is
    the state after a 24-step prefix, so the JAX scan over prefix + sequence
    is the reference."""
    n_seg, seg_len = _rule("ssm", S)
    assert n_seg > 1
    pre = 24
    dt, x, bm, cm, a_log = _ssm_inputs(S + N, 2, pre + S, 48, N, extreme)
    y_jax, h_jax = jax_ref.ssm_scan_ref(*map(jnp.asarray, (dt, x, bm, cm, a_log)))
    _, h0_jax = jax_ref.ssm_scan_ref(*(jnp.asarray(a[:, :pre]) for a in (dt, x, bm, cm)),
                                     jnp.asarray(a_log))
    h0 = torch.from_numpy(np.asarray(h0_jax).copy())
    seq = [torch.from_numpy(a[:, pre:].copy()) for a in (dt, x, bm, cm)]
    a = torch.from_numpy(a_log)
    y, h = ssm_segmented(*seq, a, h0, n_seg, seg_len)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_ref, h_ref = ks.ref_ssm_scan(*seq, a, h0)
    torch.testing.assert_close(y, y_ref, **SSM_TOL)
    torch.testing.assert_close(h, h_ref, **SSM_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax)[:, pre:], **SSM_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_jax), **SSM_TOL)
