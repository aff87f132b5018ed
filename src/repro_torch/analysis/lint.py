"""Repo-specific AST lint for the port's serving stack, ported from
``repro.analysis.lint``.

Generic linters cannot see this codebase's load-bearing conventions; these
rules encode them directly (each is mutation-tested through
``python -m repro_torch.analysis lint --mutate <id>``):

* **R001 host/device layering** — ``serving/control_plane.py`` and
  ``core/scheduler.py`` are pure host-side planning: no ``torch`` import or
  use at all (the control plane must stay dispatchable without touching
  device state). Other ``core/*`` modules may lazy-import torch inside a
  function (e.g. profiling calibration helpers, ``Retriever.retrieve``) but
  never at module level.
* **R002 block-table pad contract** — ``PagedPool.table_array`` /
  ``PagedKVCache.batch_tables`` return int32 tables padded with ``-1``
  (NEVER 0 — block 0 is allocatable). Every function consuming them must
  visibly handle the pad (a ``>= 0``/``< 0`` comparison, a ``maximum``
  clamp, or rewriting pads to the engine's ``_null_block``) or carry a
  ``# pad-ok: <reason>`` pragma explaining why no entry can be ``-1`` on
  that path.
* **R003 scheduling determinism** — no wall-clock (``time.*``) or
  unseeded randomness (``random.*`` / ``np.random.*``) in the scheduling
  and plan-building paths (``core/scheduler.py``,
  ``serving/control_plane.py``): plans must be a pure function of engine
  state so pipelined mode stays token-exact against the sync oracle.
* **R004 generator discipline** (the torch form of the JAX package's PRNG
  split rule) — ``serving/device_runner.py``'s ``dispatch`` draws from the
  engine's ``torch.Generator`` exactly once per dispatch: one
  ``sample_tokens`` call in ``dispatch``, none anywhere else, and no
  function of the runner constructs a ``torch.Generator``, reseeds one
  (``manual_seed``/``seed``) or draws random numbers itself
  (``torch.rand*``/``randn*``/``multinomial``, ...). A second draw or a
  fresh generator changes sampling streams between pipelined and sync
  modes.

Any rule can be suppressed on a specific line with ``# lint: disable=RXXX``.
Run via ``python -m repro_torch.analysis lint`` or ``run_lint()``, which
walks ``src/repro_torch`` (never ``src/repro``).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["LintViolation", "run_lint", "RULES", "lint_source"]


@dataclass(frozen=True)
class LintViolation:
    file: str     # path relative to the repro_torch package root
    line: int     # 1-indexed
    rule: str     # R00x
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} {self.message}"


# modules that must stay entirely torch-free (host-side planning layer)
STRICT_HOST_MODULES = ("serving/control_plane.py", "core/scheduler.py")
# modules whose plan construction must be deterministic
DETERMINISTIC_MODULES = ("serving/control_plane.py", "core/scheduler.py")
# the dispatch-discipline module
RUNNER_MODULE = "serving/device_runner.py"

_TABLE_CALLS = ("table_array", "batch_tables")
# functions that DEFINE/forward the table contract rather than consume it
_TABLE_DEFINERS = ("table_array", "batch_tables")


def _suppressed(lines: List[str], lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(lines):
        return f"lint: disable={rule}" in lines[lineno - 1]
    return False


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target / attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _calls(fn: ast.AST) -> List[ast.Call]:
    return [node for node in ast.walk(fn) if isinstance(node, ast.Call)]


# --------------------------------------------------------------------- R001
def _r001_layering(path: str, tree: ast.Module, lines: List[str]):
    strict = path.endswith(STRICT_HOST_MODULES)
    in_core = "/core/" in f"/{path}" or path.startswith("core/")
    if not strict and not in_core:
        return
    for node in ast.walk(tree):
        names: List[Tuple[str, int]] = []
        if isinstance(node, ast.Import):
            names = [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [(node.module, node.lineno)]
        for name, lineno in names:
            if not (name == "torch" or name.startswith("torch.")):
                continue
            toplevel = any(node is n for n in tree.body)
            if strict:
                yield LintViolation(
                    path, lineno, "R001",
                    f"host-side planning module imports {name!r}: the "
                    f"control/scheduling layer must not touch device ops",
                )
            elif toplevel:
                yield LintViolation(
                    path, lineno, "R001",
                    f"core module imports {name!r} at module level: "
                    f"importing core must not need torch "
                    f"(lazy-import inside the function that needs it)",
                )


# --------------------------------------------------------------------- R002
def _has_pad_guard(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            callee = _dotted(node.func)
            if callee.endswith(("maximum", "clip")):
                return True
        if isinstance(node, ast.Compare):
            operands = [node.left, *node.comparators]
            cmp0 = any(
                isinstance(o, ast.Constant) and o.value == 0 for o in operands
            )
            signed = any(isinstance(op, (ast.GtE, ast.Lt, ast.Gt, ast.LtE))
                         for op in node.ops)
            if cmp0 and signed:
                return True
        if isinstance(node, (ast.Attribute, ast.Name)):
            name = node.attr if isinstance(node, ast.Attribute) else node.id
            if name == "_null_block":
                return True
    return False


def _fn_has_pragma(lines: List[str], fn: ast.AST, pragma: str) -> bool:
    end = getattr(fn, "end_lineno", fn.lineno)
    return any(pragma in line for line in lines[fn.lineno - 1 : end])


def _r002_table_pads(path: str, tree: ast.Module, lines: List[str]):
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in _TABLE_DEFINERS:
            continue
        calls = [
            node for node in _calls(fn)
            if isinstance(node.func, ast.Attribute) and node.func.attr in _TABLE_CALLS
        ]
        if not calls:
            continue
        if _has_pad_guard(fn) or _fn_has_pragma(lines, fn, "# pad-ok:"):
            continue
        lineno = calls[0].lineno
        if _suppressed(lines, lineno, "R002"):
            continue
        yield LintViolation(
            path, lineno, "R002",
            f"function {fn.name!r} consumes a block table (int32, pad=-1, "
            f"never 0) without a visible pad guard (>= 0 mask / maximum "
            f"clamp / _null_block rewrite) — add one or a '# pad-ok: "
            f"<reason>' pragma",
        )


# --------------------------------------------------------------------- R003
_FORBIDDEN_CALL_PREFIXES = (
    "time.time", "time.monotonic", "time.perf_counter", "time.process_time",
    "random.", "np.random.", "numpy.random.",
)


def _r003_determinism(path: str, tree: ast.Module, lines: List[str]):
    if not path.endswith(DETERMINISTIC_MODULES):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "random":
                    yield LintViolation(
                        path, node.lineno, "R003",
                        "scheduling path imports 'random': plan building "
                        "must be a pure function of engine state",
                    )
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func)
        if any(callee == p.rstrip(".") or callee.startswith(p)
               for p in _FORBIDDEN_CALL_PREFIXES):
            if _suppressed(lines, node.lineno, "R003"):
                continue
            yield LintViolation(
                path, node.lineno, "R003",
                f"nondeterministic call {callee!r} in a scheduling path: "
                f"pipelined plans must replay token-exactly against the "
                f"sync oracle",
            )


# --------------------------------------------------------------------- R004
# torch functions that draw random numbers, and tensor methods that do
_TORCH_DRAWS = ("rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
                "randperm", "multinomial", "bernoulli", "normal", "poisson")
_METHOD_DRAWS = ("multinomial", "bernoulli_", "normal_", "uniform_", "exponential_",
                 "random_", "cauchy_", "geometric_", "log_normal_")


def _is_draw(call: ast.Call) -> bool:
    callee = _dotted(call.func)
    head, _, last = callee.rpartition(".")
    if head == "torch" and last in _TORCH_DRAWS:
        return True
    return isinstance(call.func, ast.Attribute) and call.func.attr in _METHOD_DRAWS


def _r004_generator(path: str, tree: ast.Module, lines: List[str]):
    if not path.endswith(RUNNER_MODULE):
        return
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = _calls(fn)
        samples = [c for c in calls if _dotted(c.func).endswith("sample_tokens")]
        fresh = [c for c in calls
                 if _dotted(c.func).endswith("Generator")
                 or (isinstance(c.func, ast.Attribute)
                     and c.func.attr in ("manual_seed", "seed"))
                 or _is_draw(c)]
        if fn.name == "dispatch":
            if len(samples) != 1:
                lineno = samples[1].lineno if len(samples) > 1 else fn.lineno
                if not _suppressed(lines, lineno, "R004"):
                    yield LintViolation(
                        path, lineno, "R004",
                        f"dispatch() must draw from the engine's generator "
                        f"exactly once per dispatch (found {len(samples)} "
                        f"sample_tokens calls): extra draws desynchronize "
                        f"sampling between pipelined and sync modes",
                    )
        elif samples:
            if not _suppressed(lines, samples[0].lineno, "R004"):
                yield LintViolation(
                    path, samples[0].lineno, "R004",
                    f"sample_tokens outside dispatch() (in {fn.name!r}): "
                    f"the once-per-dispatch draw lives in dispatch alone",
                )
        if fresh:
            if not _suppressed(lines, fresh[0].lineno, "R004"):
                yield LintViolation(
                    path, fresh[0].lineno, "R004",
                    f"runner makes, reseeds or draws from a generator of its "
                    f"own (in {fn.name!r}: {_dotted(fresh[0].func)!r}): "
                    f"generators originate in the engine and are drawn "
                    f"from once per dispatch",
                )


RULES: Dict[str, Tuple[str, Callable]] = {
    "R001": ("host/device layering", _r001_layering),
    "R002": ("block-table pad=-1 contract", _r002_table_pads),
    "R003": ("scheduling determinism", _r003_determinism),
    "R004": ("generator drawn once per dispatch", _r004_generator),
}


def lint_source(path: str, source: str) -> List[LintViolation]:
    """Lint one module's source under its repro_torch-relative ``path``
    (e.g. ``"serving/control_plane.py"``). Used directly by the mutation
    tests, which lint deliberately broken in-memory variants of the real
    files."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [LintViolation(path, e.lineno or 0, "R000",
                              f"syntax error: {e.msg}")]
    lines = source.splitlines()
    out: List[LintViolation] = []
    for _rule_id, (_doc, check) in sorted(RULES.items()):
        for v in check(path, tree, lines) or ():
            if not _suppressed(lines, v.line, v.rule):
                out.append(v)
    return out


def _package_root() -> Path:
    return Path(__file__).resolve().parent.parent  # src/repro_torch


def run_lint(root: Optional[Path] = None,
             sources: Optional[Dict[str, str]] = None) -> List[LintViolation]:
    """Lint the repro_torch package tree (or injected ``sources``: a mapping
    of repro_torch-relative path -> source text, for mutation testing).
    Returns all violations sorted by (file, line)."""
    out: List[LintViolation] = []
    if sources is not None:
        for path, src in sources.items():
            out.extend(lint_source(path, src))
        return sorted(out, key=lambda v: (v.file, v.line))
    root = Path(root) if root is not None else _package_root()
    for py in sorted(root.rglob("*.py")):
        rel = py.relative_to(root).as_posix()
        out.extend(lint_source(rel, py.read_text()))
    return sorted(out, key=lambda v: (v.file, v.line))
