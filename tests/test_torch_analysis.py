"""The port's analysis tools (``repro_torch.analysis``: the step-program
audit, the lint, the CLI) on the CPU, against the JAX package's.

* Lint: the port's tree is clean; each lint mutant fires the same rule id
  as the JAX mutant of the same id does in JAX's lint; the pragmas
  suppress, and the three ``# pad-ok:`` pragmas and the lazy ``torch``
  import of ``core/components.py`` are load-bearing (without them the real
  files fire R002 / R001); R004's torch form catches each way of drawing
  twice or from a generator of the runner's own.
* Audit: on the smoke engine, float and int8 pools, the port's
  ``audit_engine`` and JAX's both hold and list the same ``(program,
  check)`` pairs (JAX's ``callbacks`` is the port's ``host-sync``); the
  dispatch-mode probe flags each syncing op and a whole-pool int8 upcast
  but not a gathered one; the audit changes no request state; the
  ``"pool"`` program gives JAX's output on the same seeded pool.
* CLI: every registered mutation exits nonzero, the registry covers every
  JAX id's counterpart, the clean ``lint`` and ``all --device cpu`` exit 0,
  and ``serve.py --audit`` exits before any traffic on a violation.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.__main__ import _lint_mutants as jax_lint_mutants
from repro.analysis.__main__ import all_mutations as jax_all_mutations
from repro.analysis.jaxpr_audit import audit_engine as jax_audit_engine
from repro.analysis.lint import run_lint as jax_run_lint
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_params as jax_init_params
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.analysis.__main__ import (
    AUDIT_ENGINE_MUTANTS,
    KVSAN_MUTANTS,
    _lint_mutants,
    all_mutations,
    main,
    off_bucket_call,
)
from repro_torch.analysis.lint import lint_source, run_lint
from repro_torch.analysis.step_audit import (
    StepContract,
    audit_engine,
    audit_program,
    cache_sentinel,
    default_contracts,
    find_host_syncs,
    int8_kernel_flow,
    trace_step,
)
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.paged_cache import _quantized_scatter

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

ENGINE_KW = dict(max_batch=2, max_seq=64, prefill_chunk_size=16, token_budget=20)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


def _engine(weights, **kw):
    return GenerationEngine(weights[2], params=weights[3], device="cpu", **ENGINE_KW, **kw)


# --------------------------------------------------------------------- lint
def test_lint_clean_tree():
    assert run_lint() == []
    assert main(["lint"]) == 0


@pytest.mark.parametrize("mid,rule", [
    ("lint-layering", "R001"),
    ("lint-pad", "R002"),
    ("lint-determinism", "R003"),
    ("lint-prng", "R004"),
])
def test_lint_mutants_fire_the_jax_rule(mid, rule):
    jax_rules = {v.rule for v in jax_run_lint(sources=jax_lint_mutants()[mid])}
    port_rules = {v.rule for v in run_lint(sources=_lint_mutants()[mid])}
    assert jax_rules == port_rules == {rule}
    assert main(["lint", "--mutate", mid]) == 1


def test_lint_pragmas_suppress():
    src = ("import time\n\n"
           "def build_plan(state):\n"
           "    return time.time()  # lint: disable=R003\n")
    assert lint_source("serving/control_plane.py", src) == []
    assert lint_source("serving/control_plane.py", src.replace("  # lint: disable=R003", ""))
    body = ("def consume(pool, ids, width):\n"
            "    rows = pool.table_array(ids, width)\n"
            "    return rows\n")
    assert lint_source("serving/x.py", body)
    assert lint_source("serving/x.py", body.replace("return rows", "return rows[rows >= 0]")) == []
    assert lint_source("serving/x.py", body.replace(
        "    rows =", "    # pad-ok: rows fully backed here\n    rows =")) == []
    # a lazy torch import inside a core helper is legal, a module-level one is not
    lazy = "def calibrate():\n    import torch\n    return torch\n"
    assert lint_source("core/profiling.py", lazy) == []
    assert lint_source("core/profiling.py", "import torch\n")
    assert lint_source("serving/control_plane.py", lazy)   # strict: not even lazily


@pytest.mark.parametrize("rel,needle,rule,count", [
    ("serving/control_plane.py", "# pad-ok:", "R002", 1),
    ("serving/engine.py", "# pad-ok:", "R002", 1),
    ("serving/paged_cache.py", "# pad-ok:", "R002", 1),
])
def test_pad_pragmas_are_load_bearing(rel, needle, rule, count):
    src = (PORT / rel).read_text()
    assert src.count(needle) == count
    stripped = src.replace(needle, "# pad:")
    assert [v.rule for v in lint_source(rel, stripped)] == [rule] * count


def test_core_components_imports_torch_lazily():
    rel = "core/components.py"
    src = (PORT / rel).read_text()
    assert lint_source(rel, src) == []
    eager = src.replace("import numpy as np\n", "import numpy as np\nimport torch\n", 1)
    assert [v.rule for v in lint_source(rel, eager)] == ["R001"]


@pytest.mark.parametrize("body", [
    "    return sample_tokens(eng._generator, logits)\n\n"
    "def warm(eng, logits):\n    return sample_tokens(eng._generator, logits)\n",
    "    g = torch.Generator().manual_seed(0)\n    return sample_tokens(g, logits)\n",
    "    eng._generator.manual_seed(1)\n    return sample_tokens(eng._generator, logits)\n",
    "    noise = torch.rand(logits.shape)\n    return sample_tokens(eng._generator, logits + noise)\n",
    "    return logits.softmax(-1).multinomial(1)\n",
], ids=["sample-outside-dispatch", "own-generator", "reseed", "torch-rand", "no-draw"])
def test_r004_torch_form(body):
    src = "import torch\n\ndef dispatch(eng, logits):\n" + body
    assert {v.rule for v in lint_source("serving/device_runner.py", src)} == {"R004"}
    real = (PORT / "serving/device_runner.py").read_text()
    assert real.count("sample_tokens(") == 1 and lint_source("serving/device_runner.py", real) == []


# -------------------------------------------------------------------- audit
def _pairs(report, rename=None):
    rename = rename or {}
    return sorted((f.program, rename.get(f.check, f.check)) for f in report.findings)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_audit_matches_jax_on_the_smoke_engine(weights, kv_dtype):
    jcfg, jparams = weights[:2]
    kw = dict(kernel="pallas", kv_dtype=kv_dtype) if kv_dtype else {}
    jrep = jax_audit_engine(JaxEngine(jcfg, params=jparams, **ENGINE_KW, **kw))
    rep = audit_engine(_engine(weights, **kw))
    assert jrep.ok, jrep.render()
    assert rep.ok, rep.render()
    assert _pairs(rep) == _pairs(jrep, {"callbacks": "host-sync"})
    flows = {f.program for f in rep.findings if f.check == "int8-flow"}
    assert flows == ({"fused_ragged", "decode"} if kv_dtype else set())
    text = rep.render().splitlines()
    assert text[0] == "step-program contract audit" and text[-1] == "all contracts hold"


def test_audit_changes_no_request_state(weights):
    """The step programs' writes land in the scratch block: an audited
    engine serves the tokens an unaudited one does."""
    prompts = [np.arange(5, 40) % 90, np.arange(3, 20) % 90]
    out = []
    for audited in (True, False):
        eng = _engine(weights)
        if audited:
            assert audit_engine(eng).ok
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run_until_done()
        out.append([r.out_tokens for r in reqs])
        assert eng.kv.pool.n_free == eng.kv.pool.n_owned - 1
    assert out[0] == out[1]


@pytest.mark.parametrize("op", [
    lambda x: x.sum().item(),
    lambda x: bool(x.sum() > 0),
    lambda x: x.nonzero(),
    lambda x: torch.unique(x),
    lambda x: x.masked_select(x > 0),
    lambda x: torch.equal(x, x),
    lambda x: torch.repeat_interleave(torch.tensor([1, 2])),
], ids=["item", "bool", "nonzero", "unique", "masked_select", "equal", "repeat_interleave"])
def test_probe_flags_each_syncing_op(op):
    x = torch.arange(6.0) - 2
    assert find_host_syncs(trace_step(op, (x,)))
    assert find_host_syncs(trace_step(lambda x: x * 2 + 1, (x,))) == []
    ok = lambda x: torch.repeat_interleave(torch.tensor([1, 2]), output_size=3)
    assert find_host_syncs(trace_step(ok, (x,))) == []


def test_int8_flow_flags_a_whole_pool_upcast_not_a_gathered_one():
    pool = torch.zeros((2, 8, 16, 2, 4), dtype=torch.int8)
    scales = torch.ones((2, 8, 2))
    for fn in (lambda p: p.float().sum(), lambda p: p[1].to(torch.bfloat16),
               lambda p: p * scales[..., None, :, None]):
        reached, ups = int8_kernel_flow(trace_step(fn, (pool,), pools=(pool,)))
        assert ups and not reached
    blk = torch.tensor([0, 3])
    for fn in (lambda p: p[:, blk].float().sum(), lambda p: p[0, :2].float()):
        assert int8_kernel_flow(trace_step(fn, (pool,), pools=(pool,)))[1] == []
    # the quantized scatter upcasts only its gathered blocks
    dest = torch.tensor([5, 17, 40])
    new = torch.randn((2, 3, 2, 4))
    fn = lambda p: _quantized_scatter(p, scales.clone(), dest, new)
    assert int8_kernel_flow(trace_step(fn, (pool,), pools=(pool,)))[1] == []


def test_audit_mutations_are_caught_by_their_check(weights):
    eng = _engine(weights)
    pool = [c for c in default_contracts(eng) if c.program == "pool"]
    for mid, check in (("audit-host-sync", "host-sync"), ("audit-collective", "collectives")):
        e = _engine(weights)
        AUDIT_ENGINE_MUTANTS[mid](e)
        if mid == "audit-collective":
            from repro_torch.analysis.__main__ import one_rank_gloo

            with one_rank_gloo():
                findings = audit_program(e, pool[0])
        else:
            findings = audit_program(e, pool[0])
        assert {f.check for f in findings if not f.ok} == {check}, (mid, findings)
    i8 = _engine(weights, kv_dtype="int8")
    bad = audit_program(i8, StepContract("decode_ref", max_all_reduce=0,
                                         require_int8_kernel_path=True))
    flow = [f for f in bad if f.check == "int8-flow"][0]
    assert not flow.ok and "no paged kernel" in flow.detail
    n = eng.warmup_step_variants()
    assert cache_sentinel(eng).ok
    T = off_bucket_call(eng)
    finding = cache_sentinel(eng)
    assert not finding.ok and f"{n + 1} packed length(s) met" in finding.detail
    assert str([T]) in finding.detail


def test_pool_program_matches_jax(weights):
    """``step_program("pool")``: the gather-then-chunk-write roundtrip of the
    same seeded pool gives JAX's new pool and view, bit for bit."""
    jcfg, jparams = weights[:2]
    jeng = JaxEngine(jcfg, params=jparams, **ENGINE_KW)
    eng = _engine(weights)
    rng = np.random.default_rng(3)
    pool = rng.standard_normal(tuple(eng.kv.k.shape)).astype(np.float32)
    assert tuple(jeng.kv.k.shape) == pool.shape
    jeng.kv.k = jnp.asarray(pool)
    eng.kv.k = torch.from_numpy(pool.copy())
    jfn, jargs = jeng.step_program("pool")
    fn, args = eng.step_program("pool")
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs]
    with torch.no_grad():
        out, view = fn(*args)
    jout, jview = jfn(*jargs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(view.numpy(), np.asarray(jview))
    assert not np.array_equal(out.numpy(), pool)        # the pad writes landed ...
    np.testing.assert_array_equal(eng.kv.k.numpy(), pool)   # ... in a new pool
    for which in ("fused_ragged", "fused_padded", "decode", "decode_ref"):
        _, a = eng.step_program(which)
        assert [tuple(x.shape) for x in a] == \
            [tuple(x.shape) for x in jeng.step_program(which)[1][5:]]
    with pytest.raises(ValueError):
        eng.step_program("nope")


# ---------------------------------------------------------------------- CLI
JAX_TO_PORT = {"jaxpr-collective": "audit-collective", "jaxpr-callback": "audit-host-sync",
               "jaxpr-int8-upcast": "audit-int8-upcast",
               "jaxpr-cache-buckets": "audit-cache-buckets"}


def test_mutation_registry_covers_the_jax_registry():
    reg = all_mutations()
    assert sorted(reg) == sorted(JAX_TO_PORT.get(m, m) for m in jax_all_mutations())
    assert set(reg.values()) == {"lint", "kvsan", "audit"}
    assert len(_lint_mutants()) == 4 and len(KVSAN_MUTANTS) == 6


@pytest.mark.parametrize("mid", sorted(all_mutations()))
def test_every_registered_mutation_exits_nonzero(mid):
    sub = all_mutations()[mid]
    argv = [sub, "--mutate", mid] + (["--device", "cpu"] if sub == "audit" else [])
    assert main(argv) == 1


def test_cli_clean_runs_and_refusals(capsys):
    assert main(["all", "--device", "cpu"]) == 0
    assert main(["audit", "--device", "cpu", "--int8"]) == 0
    assert main(["lint", "--mutate", "kvsan-double-free"]) == 1
    assert main(["audit", "--mutate", "no-such-id"]) == 1
    assert main(["all", "--list-mutations"]) == 0
    out = capsys.readouterr().out
    for mid in all_mutations():
        assert mid in out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "lint"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "0 violation(s)" in res.stdout


def test_serve_audit_runs_before_traffic(monkeypatch, capsys):
    from repro_torch.analysis import step_audit
    from repro_torch.launch.serve import serve_real

    grp = serve_real("smollm-135m", n_requests=2, max_new=3, smoke=True, device="cpu",
                     dp=2, host_blocks=16, audit=True)
    out = capsys.readouterr().out
    assert "[serve:audit] all contracts hold" in out and "dp=2" in out
    assert sum(len(e.finished) for e in grp.engines) == 2
    monkeypatch.setattr(step_audit, "default_contracts", lambda eng: [StepContract(
        "decode_ref", max_all_reduce=0, require_int8_kernel_path=True)])
    with pytest.raises(SystemExit, match="contract violated"):
        serve_real("smollm-135m", n_requests=2, smoke=True, device="cpu", audit=True)
    assert "[serve:audit] [FAIL]" in capsys.readouterr().out
