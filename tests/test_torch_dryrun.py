"""The dry run on the meta device (``repro_torch.launch.dryrun``) and the
meta rule of the kernel wrappers (``repro_torch.kernels.work``).

* every wrapper handed meta tensors returns its contract's shapes and
  dtypes, counts its contract work, and neither launches nor runs its
  plain version (both are made to raise here);
* the work functions moved out of ``chip_smoke.py`` reproduce the bounds
  ``PERF.md`` prints at the main path's shapes, and the closed-form pair
  count equals the plain mask's;
* the dry run's FLOPs at smoke width equal a closed form: 2 T per matmul
  weight element, per norm's f32 sum of squares 2 T D, plus each kernel's
  contract work (the train step: forward, backward and the layer-group
  recompute, which stops at the group's last matmul);
* its per-device argument bytes equal XLA's ``argument_size_in_bytes`` of
  JAX's own ``build_step`` on a forced (2, 4) CPU mesh (a subprocess);
* the CLI reports OK / SKIP as JAX's rules say.
"""
import json
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, card_smoke_variant, get_arch, \
    smoke_variant
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as ka
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import rwkv6_scan as kw
from repro_torch.kernels import ssm_scan as ks
from repro_torch.kernels import topk_retrieval as tk
from repro_torch.kernels import work
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import AbstractMesh

MESH1 = AbstractMesh(("data", "model"), (1, 1))


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def no_plain_no_launch(monkeypatch):
    """The plain versions and the kernel build raise: a meta call that
    reached either fails."""
    def boom(*a, **k):
        raise AssertionError("a meta call ran a plain version or built a kernel")

    for mod, names in ((ka, ("ref_paged_decode_attention", "ref_paged_chunk_attention",
                             "ref_decode_attention")),
                       (kf, ("ref_flash_attention", "ref_flash_attention_backward")),
                       (kw, ("ref_rwkv6_chunked", "ref_rwkv6_chunked_backward")),
                       (ks, ("ref_ssm_scan", "ref_ssm_scan_backward")),
                       (tk, ("ref_topk_retrieval",))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    monkeypatch.setattr(_build, "load_library", boom)
    work.reset_meta_work()
    yield
    work.reset_meta_work()


def _one_call(name, out, want_shapes, nbytes, flops):
    outs = out if isinstance(out, tuple) else (out,)
    assert [(tuple(t.shape), t.dtype) for t in outs] == want_shapes
    assert all(t.is_meta for t in outs)
    w = work.META_WORK.pop(name)
    assert (w.calls, w.nbytes, w.flops) == (1, nbytes, flops)


# ----------------------------------------------------------- the meta rule
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_rule_attention_wrappers(no_plain_no_launch, dtype):
    B, mb, bs, KVH, G, hd, T = 3, 5, 16, 2, 4, 64, 11
    pool = meta(20, bs, KVH, hd, dtype=dtype)
    tables = meta(B, mb, dtype=torch.int32)
    i32 = meta(B, dtype=torch.int32)
    q = meta(B, KVH * G, hd, dtype=dtype)
    n0 = ka.paged_decode_attention.launches
    _one_call("paged_decode_attention", ka.paged_decode_attention(q, pool, pool, tables, i32),
              [((B, KVH * G, hd), dtype)], *work.paged_work(q, pool, tables))
    qc, t32 = meta(T, KVH * G, hd, dtype=dtype), meta(T, dtype=torch.int32)
    _one_call("paged_chunk_attention",
              ka.paged_chunk_attention(qc, pool, pool, tables, t32, t32, t32, t32),
              [((T, KVH * G, hd), dtype)], *work.paged_work(qc, pool, tables))
    cache = meta(B, 100, KVH, hd, dtype=dtype)
    _one_call("decode_attention", ka.decode_attention(q, cache, cache, i32),
              [((B, KVH * G, hd), dtype)],
              *work.decode_work(q, cache, [100] * B))
    assert ka.paged_decode_attention.launches == n0
    S = 70
    qf, kv = meta(2, S, 8, 64, dtype=dtype), meta(2, S, 2, 64, dtype=dtype)
    for form in ({"causal": True}, {"causal": True, "window": 16}, {"causal": True, "chunk": 32},
                 {"causal": False}):
        _one_call("flash_attention", kf.flash_attention(qf, kv, kv, **form),
                  [((2, S, 8, 64), dtype)], *work.flash_work(qf, kv, kv, **form))
        _one_call("flash_attention_backward",
                  kf.flash_attention_backward(qf, kv, kv, qf, qf, **form),
                  [((2, S, 8, 64), dtype), ((2, S, 2, 64), dtype), ((2, S, 2, 64), dtype)],
                  *work.backward_work(2, S, 8, 2, 64, qf.element_size(), **form))
    # a form the card refuses is refused on meta too
    with pytest.raises(ValueError):
        kf.flash_attention(meta(1, 8, 4, 48, dtype=dtype), meta(1, 8, 4, 48, dtype=dtype),
                           meta(1, 8, 4, 48, dtype=dtype))


def test_meta_rule_scans_and_topk(no_plain_no_launch):
    B, S, H, hd = 2, 300, 4, 64
    r, w = meta(B, S, H, hd, dtype=torch.bfloat16), meta(B, S, H, hd)
    u, st = meta(H, hd), meta(B, H, hd, hd)
    y_state = [((B, S, H, hd), torch.float32), ((B, H, hd, hd), torch.float32)]
    _one_call("rwkv6_chunked", kw.rwkv6_chunked(r, r, r, w, u, st), y_state,
              *work.wkv_work(r, st))
    grads = [((B, S, H, hd), torch.bfloat16)] * 3 + [((B, S, H, hd), torch.float32),
                                                     ((H, hd), torch.float32),
                                                     ((B, H, hd, hd), torch.float32)]
    _one_call("rwkv6_chunked_backward", kw.rwkv6_chunked_backward(r, r, r, w, u, st, w),
              grads, *work.scan_backward_work("rwkv6_chunked_backward",
                                              (r, r, r, w, u, st, w, st))[:2])
    Di, N = 64, 16
    dt, bm, a, h = (meta(B, S, Di, dtype=torch.bfloat16), meta(B, S, N, dtype=torch.bfloat16),
                    meta(Di, N), meta(B, Di, N))
    nbytes, flops, exps = work.ssm_work(dt, bm, h)
    ks_out = ks.ssm_scan(dt, dt, bm, bm, a, h)
    assert [(tuple(t.shape), t.dtype) for t in ks_out] == [((B, S, Di), torch.float32),
                                                           ((B, Di, N), torch.float32)]
    wk = work.META_WORK.pop("ssm_scan")
    assert (wk.calls, wk.nbytes, wk.flops, wk.exps) == (1, nbytes, flops, exps)
    dy = meta(B, S, Di)
    ks.ssm_scan_backward(dt, dt, bm, bm, a, h, dy)
    wk = work.META_WORK.pop("ssm_scan_backward")
    assert (wk.nbytes, wk.flops) == work.scan_backward_work(
        "ssm_scan_backward", (dt, dt, bm, bm, a, h, dy, h))[:2]
    q, docs = meta(4, 64), meta(1000, 64, dtype=torch.bfloat16)
    nbytes, flops, _ = work.topk_work(q, docs, 10)
    _one_call("topk_retrieval", tk.topk_retrieval(q, docs, 10),
              [((4, 10), torch.float32), ((4, 10), torch.int32)], nbytes, flops)


def test_trainable_functions_on_meta_count_forward_and_backward(no_plain_no_launch):
    q = meta(1, 64, 4, 64, dtype=torch.bfloat16).requires_grad_()
    kv = meta(1, 64, 2, 64, dtype=torch.bfloat16).requires_grad_()
    out = kf.trainable_flash_attention(q, kv, kv)
    torch.autograd.grad(out.float().sum(), (q, kv))
    assert work.META_WORK["flash_attention"].calls == 1
    assert work.META_WORK["flash_attention_backward"].calls == 1
    with pytest.raises(NotImplementedError):     # no backward kernel for this form
        kf.trainable_flash_attention(meta(1, 8, 4, 48).requires_grad_(), meta(1, 8, 4, 48),
                                     meta(1, 8, 4, 48))


# ------------------------------------------- the moved work and the bounds
def bound_ms(nbytes, ops, dtype_name):
    """(the larger of bytes over the HBM rate and operations over their
    type's peak, in ms; which one) as chip_smoke.py computes its bounds."""
    bytes_ms = nbytes / work.HBM_BYTES_S * 1e3
    ops_ms = ops / work.PEAK_OPS_S[dtype_name] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def test_work_functions_reproduce_the_printed_bounds():
    """Bounds PERF.md §6 prints (chip_smoke.py), recomputed by the package:
    flash causal S 2048 bf16 0.01738 ms, its backward 0.04345, WKV prefill
    0.04069, the scan's backward 0.01497 (its bytes 0.01271), top-k f32
    1.9231."""
    bf, f32 = torch.bfloat16, torch.float32
    q, k = meta(1, 2048, 16, 128, dtype=bf), meta(1, 2048, 2, 128, dtype=bf)
    assert round(bound_ms(*work.flash_work(q, k, k), "bfloat16")[0], 5) \
        == 0.01738
    bwd = work.backward_work(1, 2048, 16, 2, 128, 2, causal=True)
    assert bound_ms(*bwd, "bfloat16") == (pytest.approx(0.04345, abs=5e-6), "operations")
    r, st = meta(1, 2048, 64, 64, dtype=bf), meta(1, 64, 64, 64)
    assert bound_ms(*work.wkv_work(r, st), "float32") == \
        (pytest.approx(0.04069, abs=5e-6), "operations")
    dt, bm, a, h = meta(1, 2176, 1600, dtype=bf), meta(1, 2176, 16, dtype=bf), meta(1600, 16), \
        meta(1, 1600, 16)
    case = (dt, dt, bm, bm, a, h, meta(1, 2176, 1600), h)
    nbytes, ops, _ = work.scan_backward_work("ssm_scan_backward", case)
    assert ops / work.PEAK_OPS_S["float32"] * 1e3 == pytest.approx(0.01497, abs=5e-6)
    assert nbytes / work.HBM_BYTES_S * 1e3 == pytest.approx(0.01271, abs=5e-6)
    nbytes, flops, _ = work.topk_work(meta(32, 768), meta(2**21, 768, dtype=f32), 10)
    assert bound_ms(nbytes, flops, "tf32") == (pytest.approx(1.9231, abs=5e-5), "bytes")


@pytest.mark.parametrize("S,S_kv,form", [
    (70, 70, {"causal": True}), (70, 70, {"causal": False}), (70, 70, {"window": 16}),
    (130, 130, {"chunk": 48}), (130, 130, {"causal": False, "chunk": 48}),
    (37, 90, {"causal": False}), (64, 64, {"causal": True, "window": 64})])
def test_visible_pairs_equal_the_plain_mask(S, S_kv, form):
    want = int((~kf.hidden_mask(S, S_kv, form.get("causal", True), form.get("window", 0),
                                form.get("chunk", 0))).sum())
    assert work.visible_pairs(S, S_kv, **form) == want


# ----------------------------------------------------------- the dry run
def _weights(cfg):
    """Matmul weight elements of one layer and the unembedding's."""
    D, H, K, hd, F = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    return D * H * hd * 2 + 2 * D * K * hd + 3 * D * F, D * cfg.padded_vocab


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dry_run_flops_equal_the_closed_form(kind):
    """smollm-135m's smoke variant (2 layers, tied embeddings, SwiGLU), B 4
    x S 64: aten FLOPs 2 T per weight element per matmul pass (forward;
    train: also the two backward products and the recompute, which stops
    before each group's last matmul, the down projection, as the
    non-reentrant checkpoint does), 2 T D per norm's sum of squares (a
    bmm), plus the kernels' contract work."""
    cfg = smoke_variant(get_arch("smollm-135m"))
    B, S, L, Dm = 4, 64, cfg.num_layers, cfg.d_model
    W, Wh = _weights(cfg)
    fn, args, _ = D_build(cfg, ShapeConfig(kind, S, B, kind))
    out = D.run_step(fn, args)
    norms = 2 * L + 1
    # the attention's 4 hd flops a query head and visible (query, key) pair
    pair_flops = 4 * cfg.head_dim * cfg.num_heads
    if kind == "prefill":
        T = B * S
        aten = 2 * T * W * L + 2 * B * Wh + norms * 2 * T * Dm
        kern = pair_flops * B * S * (S + 1) // 2 * L
    elif kind == "decode":
        T = B
        aten = 2 * T * W * L + 2 * B * Wh + norms * 2 * T * Dm
        kern = pair_flops * B * S * L
    else:
        T = B * S
        down = cfg.d_ff * Dm
        aten = (8 * T * W - 2 * T * down) * L + 6 * T * Wh \
            + (4 * 2 * L + 3) * 2 * T * Dm         # norms: fwd, recompute, 2 backward
        mb = D.train_microbatches(cfg, ShapeConfig(kind, S, B, kind), {"data": 1, "model": 1})
        fwd = pair_flops * (B // mb) * S * (S + 1) // 2
        bwd = work.backward_work(B // mb, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 2,
                                 causal=True)[1]
        kern = mb * L * (2 * fwd + bwd)
    assert out["aten_flops"] == aten
    assert out["kernel_flops"] == kern
    assert out["flops"] == aten + kern
    assert out["peak_bytes_est"] > sum(t.numel() * t.element_size() for t in _leaves(args))


def D_build(cfg, shape):
    return D.build_step(cfg, shape, MESH1)


def _leaves(tree):
    from repro_torch.params import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - {"smollm-135m"}))
def test_dry_run_runs_every_arch_at_smoke_width(arch):
    """Every arch's train, prefill and decode steps run on meta (minicpm3
    at its card smoke dims: the card has no (48, 32) kernel) with each
    step's kernels counted and a positive peak."""
    cfg = card_smoke_variant(arch)
    for kind in ("train", "prefill", "decode"):
        fn, args, specs = D_build(cfg, ShapeConfig(kind, 32, 4, kind))
        out = D.run_step(fn, args)
        assert out["flops"] > out["aten_flops"] > 0 or cfg.name.startswith("minicpm3")
        assert out["peak_bytes_est"] > 0
        assert D.argument_bytes(args, specs, {"data": 1, "model": 1})["total"] == \
            sum(t.numel() * t.element_size() for t in _leaves(args))


JAX_ARGS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import repro.launch.dryrun as D
from repro.configs import smoke_variant
from repro.launch.mesh import make_mesh_compat
orig = D.get_arch
D.get_arch = lambda name: smoke_variant(orig(name))   # this process only
mesh = make_mesh_compat((2, 4), ("data", "model"))
out = {}
for arch, shape in json.loads(sys.argv[1]):
    with mesh:
        fn, specs = D.build_step(arch, shape, mesh)
        out[arch + "/" + shape] = fn.lower(*specs).compile().memory_analysis().argument_size_in_bytes
print(json.dumps(out))
"""


def test_per_device_argument_bytes_equal_xla():
    """JAX's own ``build_step`` at smoke width on a forced (2, 4) CPU mesh,
    compiled in a subprocess: ``argument_size_in_bytes`` equals the port's
    per-device argument bytes, for a train and a decode step (XLA adds no
    padding to these shards)."""
    cases = [["smollm-135m", "train_4k"], ["qwen2.5-3b", "decode_32k"]]
    res = subprocess.run([sys.executable, "-c", JAX_ARGS, json.dumps(cases)],
                         capture_output=True, text=True, timeout=600, cwd=".")
    assert res.returncode == 0, res.stderr[-3000:]
    xla = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = AbstractMesh(("data", "model"), (2, 4))
    for arch, shape in cases:
        fn, args, specs = D.build_step(smoke_variant(get_arch(arch)), shape, mesh)
        got = D.argument_bytes(args, specs, {"data": 2, "model": 4})["total"]
        assert got == xla[f"{arch}/{shape}"], (arch, shape, got, xla)


def test_cli_reports_ok_and_skip(capsys, tmp_path):
    out = tmp_path / "dry.jsonl"
    assert D.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--json", str(out)]) == 0
    assert D.main(["--arch", "qwen2.5-3b", "--shape", "long_500k", "--json", str(out),
                   "--serve-shard"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in rows] == ["OK", "SKIP"]
    ok = rows[0]
    ws = ok["whole_step"]
    assert ok["per_device"]["argument_bytes"] > 0
    assert ws["fits"] is (ws["peak_bytes_est"] <= work.CARD_BYTES)
    # 128 rows against a 32k-slot cache: 30 GiB of K/V alone at world size 1
    assert ws["peak_bytes_est"] > ws["argument_bytes"] > 30 * 2**30
    assert ok["collectives"]["modelled"] is False
    assert "1 OK, 0 SKIP, 0 FAIL" in capsys.readouterr().out


def test_serve_shard_collectives_are_the_megatron_formula():
    r = D.dryrun("qwen2.5-3b", "decode_32k", verbose=False, serve_shard=True)
    cfg = get_arch("qwen2.5-3b")
    c = r["collectives"]
    assert c["modelled"] and c["all-reduce"] == 2 * cfg.num_layers
    rows = SHAPES["decode_32k"].global_batch // 16
    assert c["all-reduce_bytes"] == 2 * cfg.num_layers * rows * cfg.d_model * 2
    assert not D.dryrun("rwkv6-7b", "decode_32k", verbose=False,
                        serve_shard=True)["collectives"]["modelled"]
    assert 79 * 2**30 < work.CARD_BYTES < 80 * 2**30      # the card's total_memory
