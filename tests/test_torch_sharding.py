"""The port's shapes, abstract trees and sharding policy against the JAX
package's, leaf by leaf: ``ShapeConfig`` / ``SHAPES`` / ``get_shape`` /
``arch_runs_shape``; ``abstract_params`` / ``abstract_cache`` /
``input_specs`` (the port's on the meta device, JAX's from
``jax.eval_shape``) for every arch of ``ARCHS`` at full width and every
shape; every spec function of ``models.sharding`` at the axis sizes
{"data": 16, "model": 16} and {"pod": 2, "data": 16, "model": 16}, with
``moe_mode="ep"`` and ``serve`` on and off; ``tests/test_sharding.py``'s
cases on the port; the meshes of ``launch.mesh``."""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jc
from repro.models import model as JM
from repro.models import sharding as JSH
from repro_torch import configs as tc
from repro_torch import resolve_device
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.models import sharding as TSH
from repro_torch.params import tree_leaves

AX = {"data": 16, "model": 16}
AX_MP = {"pod": 2, "data": 16, "model": 16}
ARCHS = list(tc.ARCHS)


# ---------------------------------------------------------------- helpers
def _jax_leaves(tree):
    """path -> (shape, dtype name) of a JAX tree of ShapeDtypeStructs."""
    return {JSH._path_str(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _torch_leaves(tree):
    out = {}
    TSH.tree_map_with_path(
        lambda p, t: out.__setitem__(p, (tuple(t.shape), str(t.dtype).replace("torch.", ""))),
        tree)
    return out


def _jax_specs(tree):
    return {JSH._path_str(path): tuple(spec) for path, spec in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P))}


def _torch_specs(tree):
    out = {}
    TSH.tree_map_with_path(lambda p, s: out.__setitem__(p, tuple(s)), tree)
    return out


@functools.lru_cache(maxsize=None)
def _abstract(name):
    """(JAX config, JAX abstract params, port config, port abstract params)."""
    jcfg, tcfg = jc.ARCHS[name], tc.ARCHS[name]
    return jcfg, JM.abstract_params(jcfg), tcfg, TM.abstract_params(tcfg)


# ------------------------------------------------------------------ shapes
def test_shapes_equal_jax():
    assert list(tc.SHAPES) == list(jc.SHAPES)
    for name, s in jc.SHAPES.items():
        t = tc.get_shape(name)
        assert (t.name, t.seq_len, t.global_batch, t.kind) == \
            (s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_runs_shape_equals_jax(arch):
    for name in jc.SHAPES:
        assert tc.arch_runs_shape(tc.ARCHS[arch], tc.SHAPES[name]) == \
            jc.arch_runs_shape(jc.ARCHS[arch], jc.SHAPES[name])
    assert tc.ARCHS[arch].subquadratic == jc.ARCHS[arch].subquadratic


# ---------------------------------------------------------- abstract trees
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_jax(arch):
    _, jp, _, tp = _abstract(arch)
    assert _torch_leaves(tp) == _jax_leaves(jp)
    assert all(t.is_meta for t in tree_leaves(tp))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "kv_int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_and_inputs_equal_jax(arch, quant):
    """Leaf by leaf at every shape's sequence length (two rows; the batch
    only scales a dim). A hybrid layer's K/V is the one documented
    difference: the port keeps a ring of min(S, window) slots where JAX
    sizes it S, linear (ROADMAP §3), so there the port's length is held to
    min(S, window) and JAX's to S."""
    jcfg = jc.ARCHS[arch].replace(kv_cache_quant=quant)
    tcfg = tc.ARCHS[arch].replace(kv_cache_quant=quant)
    for name, shape in jc.SHAPES.items():
        want = _jax_leaves(JM.abstract_cache(jcfg, 2, shape.seq_len))
        got = _torch_leaves(TM.abstract_cache(tcfg, 2, shape.seq_len))
        if tcfg.attn_type == "hybrid":
            for key in [k for k in ("0/k", "0/v", "0/k_scale", "0/v_scale") if k in want]:
                dims = list(want[key][0])
                assert dims[2] == shape.seq_len
                dims[2] = min(shape.seq_len, tcfg.window)
                want[key] = (tuple(dims), want[key][1])
        assert got == want, (name, sorted(set(got.items()) ^ set(want.items()))[:4])
        assert _torch_leaves(TM.input_specs(tcfg, tc.SHAPES[name])) == \
            _jax_leaves(JM.input_specs(jcfg, shape)), name


# ------------------------------------------------------------- spec trees
@pytest.mark.parametrize("axes", [AX, AX_MP], ids=["16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, axes):
    jcfg, jp, tcfg, tp = _abstract(arch)
    for mode in ("tp", "ep"):
        for serve in (False, True):
            assert _torch_specs(TSH.param_pspecs(tcfg, tp, axes, moe_mode=mode, serve=serve)) \
                == _jax_specs(JSH.param_pspecs(jcfg, jp, axes, moe_mode=mode, serve=serve)), \
                (mode, serve)
    assert _torch_specs(TSH.serve_engine_pspecs(tcfg, tp, axes)) == \
        _jax_specs(JSH.serve_engine_pspecs(jcfg, jp, axes))
    pj = JSH.param_pspecs(jcfg, jp, axes)
    pt = TSH.param_pspecs(tcfg, tp, axes)
    assert _torch_specs(TSH.opt_state_pspecs(pt)) == _jax_specs(JSH.opt_state_pspecs(pj))


@pytest.mark.parametrize("axes", [AX, AX_MP], ids=["16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_input_pool_specs_equal_jax(arch, axes):
    jcfg, tcfg = jc.ARCHS[arch], tc.ARCHS[arch]
    for name, shape in jc.SHAPES.items():
        B = shape.global_batch
        assert _torch_specs(TSH.cache_pspecs(tcfg, tc.SHAPES[name],
                                             TM.abstract_cache(tcfg, B, 64), axes)) == \
            _jax_specs(JSH.cache_pspecs(jcfg, shape, JM.abstract_cache(jcfg, B, 64), axes)), name
        assert _torch_specs(TSH.input_pspecs(tcfg, tc.SHAPES[name],
                                             TM.input_specs(tcfg, tc.SHAPES[name]), axes)) == \
            _jax_specs(JSH.input_pspecs(jcfg, shape, JM.input_specs(jcfg, shape), axes)), name
    for dp_blocks in (False, True):
        for n_blocks in (None, 70, 64):
            assert tuple(TSH.pool_pspecs(tcfg, axes, dp_blocks, n_blocks)) == \
                tuple(JSH.pool_pspecs(jcfg, axes, dp_blocks, n_blocks))
    assert TSH.batch_axes(axes) == JSH.batch_axes(axes)


# ------------------------------------- tests/test_sharding.py on the port
def _leaves_with_specs(arch, axes):
    _, _, cfg, params = _abstract(arch)
    specs = TSH.param_pspecs(cfg, params, axes)
    out = []
    TSH.tree_map_with_path(lambda p, t, s: out.append((p, t, s)), params, specs)
    return out


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "mixtral-8x22b", "rwkv6-7b",
                                  "minicpm3-4b", "hymba-1.5b"])
def test_param_specs_divisible(arch):
    for _, leaf, spec in _leaves_with_specs(arch, AX):
        assert TSH.shard_shape(tuple(leaf.shape), spec, AX)   # raises if one does not divide


def test_big_weights_are_sharded():
    for path, leaf, spec in _leaves_with_specs("mixtral-8x22b", AX):
        if leaf.numel() * 2 > 64 * 2**20:
            assert any(a is not None for a in spec), (path, leaf.shape)


def test_multipod_fsdp_expands():
    assert any(isinstance(a, tuple) and set(a) == {"pod", "data"}
               for _, _, spec in _leaves_with_specs("mixtral-8x22b", AX_MP) for a in spec)


def test_cache_specs_batch_vs_context_parallel():
    cfg = tc.get_arch("phi3-medium-14b")
    shape = tc.SHAPES["decode_32k"]
    k = TSH.cache_pspecs(cfg, shape, TM.abstract_cache(cfg, shape.global_batch, 32768), AX)[0]["k"]
    assert k[1] == "data" and k[2] == "model"
    cfg2 = tc.get_arch("mixtral-8x22b")
    k2 = TSH.cache_pspecs(cfg2, tc.SHAPES["long_500k"], TM.abstract_cache(cfg2, 1, 524288),
                          AX)[0]["k"]
    assert k2[1] is None and k2[2] == "data"
    rw = tc.get_arch("rwkv6-7b")
    assert TSH.cache_pspecs(rw, shape, TM.abstract_cache(rw, 128, 32768), AX)[0]["state"][2] \
        == "model"


def test_ep_and_serve_modes():
    _, _, cfg, params = _abstract("llama4-scout-17b-a16e")
    ep = _torch_specs(TSH.param_pspecs(cfg, params, AX, moe_mode="ep"))
    assert any(spec[1] == "model" for path, spec in ep.items() if "moe/w_gate" in path)
    _, _, mx, mp = _abstract("mixtral-8x22b")   # 8 experts: ep does not divide 16
    assert _torch_specs(TSH.param_pspecs(mx, mp, AX, moe_mode="ep")) == \
        _torch_specs(TSH.param_pspecs(mx, mp, AX, moe_mode="tp"))
    _, _, phi, pp = _abstract("phi3-medium-14b")
    for path, spec in _torch_specs(TSH.param_pspecs(phi, pp, AX, serve=True)).items():
        if "attn/wq" in path or "mlp/w_gate" in path:
            assert "data" not in spec, (path, spec)


def test_pool_and_engine_specs():
    phi, qwen = tc.get_arch("phi3-medium-14b"), tc.get_arch("qwen2.5-3b")
    assert TSH.pool_pspecs(phi, {"model": 16}) == TSH.Spec(None, None, None, None, None)
    assert TSH.pool_pspecs(qwen, {"model": 2}) == TSH.Spec(None, None, None, "model", None)
    assert TSH.pool_pspecs(qwen, {"data": 4, "model": 2}, dp_blocks=True, n_blocks=70) == \
        TSH.Spec(None, None, None, "model", None)
    _, _, cfg, params = _abstract("qwen2.5-3b")
    for path, spec in _torch_specs(TSH.serve_engine_pspecs(cfg, params, {"model": 2})).items():
        if path.startswith(("embed", "lm_head")):
            assert all(a is None for a in spec), (path, spec)
        if "attn/wq" in path:
            assert "model" in spec and "data" not in spec, (path, spec)


def test_spec_normalises_one_name_tuples_as_partition_spec():
    assert TSH.Spec(("data",), None) == tuple(P(("data",), None))
    assert TSH.Spec(("pod", "data")) == tuple(P(("pod", "data")))


# ------------------------------------------------------------------ meshes
def test_meshes():
    mesh = tmesh.make_production_mesh()
    assert tmesh.mesh_axis_sizes(mesh) == {"data": 16, "model": 16}
    assert tmesh.mesh_axis_sizes(tmesh.make_production_mesh(multi_pod=True)) == AX_MP
    with pytest.raises(RuntimeError):      # no process group
        tmesh.make_serving_mesh(tp=2)
    # JAX's v5e constants have no counterpart; the H100's live in kernels.work
    from repro_torch.kernels import work

    assert not any(hasattr(tmesh, n) for n in ("PEAK_FLOPS_BF16", "HBM_BW", "CHIP_HBM_BYTES"))
    assert work.HBM_BYTES_S == 3.35e12 and work.PEAK_OPS_S["bfloat16"] == 989e12
    assert work.CARD_BYTES == 85_017_493_504      # an H100 80GB HBM3's total_memory


def test_serving_mesh_world_size_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        assert tmesh.mesh_axis_sizes(tmesh.make_serving_mesh(tp=1)) == {"model": 1}
        with pytest.raises(ValueError):
            tmesh.make_serving_mesh(tp=4)
    finally:
        dist.destroy_process_group()


def test_resolve_device_takes_meta_only_by_name():
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("xla")
