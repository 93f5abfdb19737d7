"""Host-sync lint: AST pass forbidding device→host syncs in hot paths.

The port of the reference's ``repro.analyze.ast_lint``, with rules for
torch in place of jnp. A serving or training hot path must never
silently block on device values: ``.item()``, ``float(torch.max(...))``,
``x.cpu()`` and ``torch.cuda.synchronize()`` each stall the launch queue
for a full device round trip — the difference between a queue that
drains and one that backs up. The measurement harness
(``tune/measure.py``) and the benchmarks do this *on purpose* (timing
needs a fence), so they are allow-listed; anything else under
``serving/``, ``runtime/`` and ``kernels/`` is a finding.

Rules (IDs and severities as in the reference):

  * **HS001** (error)   — ``x.item()``: per-element device sync.
  * **HS002** (error)   — a ``synchronize()`` call
    (``torch.cuda.synchronize()``, a stream's or an event's): an explicit
    fence outside a measurement harness.
  * **HS003** (warning) — ``float(...)`` / ``int(...)`` / ``bool(...)``
    around a torch reduction: ``torch.max(...)`` (any ``torch.*`` call
    named in ``_REDUCTIONS``), or ``<expr>.sum()`` where ``<expr>`` is a
    torch expression (holds a ``torch.*`` call). A reduction method on a
    bare name is not flagged: numpy arrays share the method names and
    the AST cannot tell them apart. (``float(torch.finfo(...).max)`` and
    other metadata accessors are *not* flagged.)
  * **HS004** (warning) — ``x.cpu()``, ``x.numpy()``, ``x.tolist()``
    (``.numpy()`` / ``.tolist()`` directly on a ``.cpu()`` count once,
    at the ``.cpu()``), or ``np.asarray`` / ``np.array`` over a torch
    expression: a whole-tensor device→host transfer.
  * **RT101** (error)   — ``torch.compile(...)``, ``torch.jit.script``
    or ``torch.jit.trace`` inside a ``for``/``while`` body: every
    iteration builds a fresh compiled callable, a guaranteed rebuild per
    iteration. (Reported under the retrace pass; it is a *source*
    pattern, so it lives with the AST walker.)

Suppression: a comment containing ``analyze: allow(HS004)`` (or
``allow(host-sync)`` for the whole pass) on the offending line.
"""
from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.analyze.report import Finding

PASS = "host-sync"

# tensor-producing reductions whose float()/int() coercion is a device
# sync; metadata helpers (finfo, iinfo, shape, ndim, size) are not
_REDUCTIONS = frozenset({
    "max", "min", "sum", "mean", "prod", "argmax", "argmin", "all", "any",
    "median", "norm", "dot", "vdot", "count_nonzero", "nanmax", "nanmin",
    "nansum", "nanmean",
})

# module aliases treated as "the torch family" when they head an
# attribute chain: torch.max(...), torch.linalg.norm(...), F.relu(...)
_TORCH_ROOTS = frozenset({"torch", "F"})

# the compile entry points RT101 looks for inside loop bodies
_COMPILERS = (["torch", "compile"], ["torch", "jit", "script"],
              ["torch", "jit", "trace"])

# hot-path packages, relative to src/repro_torch
HOT_PATHS = ("serving", "runtime", "kernels")

# path substrings exempt from the pass (measurement needs fences)
DEFAULT_ALLOW = ("tune/measure.py", "benchmarks/")

_ALLOW_RE = re.compile(r"analyze:\s*allow\(([A-Za-z0-9_,\s-]+)\)")


def allow_tokens(source_line: str) -> frozenset[str]:
    """The ``analyze: allow(...)`` tokens on one source line (empty when
    there is no allow comment). Shared by every source-level pass and by
    the SUP001 stale-suppression check."""
    m = _ALLOW_RE.search(source_line)
    if not m:
        return frozenset()
    return frozenset(t.strip() for t in m.group(1).split(",") if t.strip())


def _suppressed(source_line: str, rule: str, pass_name: str) -> bool:
    tokens = allow_tokens(source_line)
    return rule in tokens or pass_name in tokens


def _attr_chain(node: ast.AST) -> list[str]:
    """['torch', 'cuda', 'synchronize'] for torch.cuda.synchronize; []
    when not a chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        return []
    return parts[::-1]


def _contains_torch_call(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = _attr_chain(sub.func)
            if chain and chain[0] in _TORCH_ROOTS:
                return True
    return False


def _is_torch_reduction_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call) or \
            not isinstance(node.func, ast.Attribute) or \
            node.func.attr not in _REDUCTIONS:
        return False
    chain = _attr_chain(node.func)
    if len(chain) >= 2 and chain[0] in _TORCH_ROOTS:
        return True                      # torch.max(x), torch.linalg.norm
    return _contains_torch_call(node.func.value)   # torch.ones(3).sum()


def _is_cpu_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and node.func.attr == "cpu"


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, lines: list[str], suppress: bool = True):
        self.path = path
        self.lines = lines
        self.suppress = suppress
        self.findings: list[Finding] = []
        self._loop_depth = 0

    def _emit(self, rule: str, severity: str, node: ast.AST, msg: str,
              pass_name: str = PASS) -> None:
        line = self.lines[node.lineno - 1] if \
            0 < node.lineno <= len(self.lines) else ""
        if self.suppress and _suppressed(line, rule, pass_name):
            return
        self.findings.append(Finding(
            rule=rule, severity=severity, pass_name=pass_name, message=msg,
            location=f"{self.path}:{node.lineno}"))

    # -- loops gate RT101 --------------------------------------------------

    def visit_For(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_While(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    # -- calls -------------------------------------------------------------

    def visit_Call(self, node: ast.Call):
        chain = _attr_chain(node.func)

        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "item" and not node.args:
                self._emit("HS001", "error", node,
                           ".item() forces a per-element device sync; "
                           "batch the transfer (one copy to the host) "
                           "outside the hot path")
            if attr == "synchronize":
                self._emit("HS002", "error", node,
                           "synchronize() is a device fence; only "
                           "measurement harnesses may block the hot path")
            if attr == "cpu" or (attr in ("numpy", "tolist") and
                                 not _is_cpu_call(node.func.value)):
                self._emit("HS004", "warning", node,
                           f".{attr}() transfers the whole tensor to the "
                           f"host; keep hot-path values on the device (or "
                           f"annotate the deliberate materialization "
                           f"point)")

        if isinstance(node.func, ast.Name) and \
                node.func.id in ("float", "int", "bool") and node.args:
            if _is_torch_reduction_call(node.args[0]):
                self._emit("HS003", "warning", node,
                           f"{node.func.id}() around a device reduction "
                           f"syncs per call; hoist to host data or keep "
                           f"the comparison on the device")

        if chain[-2:] == ["np", "asarray"] or chain[-2:] == ["np", "array"]:
            if node.args and _contains_torch_call(node.args[0]):
                self._emit("HS004", "warning", node,
                           "np.asarray over a torch expression is a hidden "
                           "device→host transfer")

        if chain in _COMPILERS and self._loop_depth > 0:
            self._emit("RT101", "error", node,
                       f"{'.'.join(chain)} inside a loop body builds a "
                       f"fresh compiled callable every iteration — a "
                       f"guaranteed rebuild; hoist it outside the loop",
                       pass_name="retrace")

        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>", *,
                suppress: bool = True) -> list[Finding]:
    """Lint one module's source text. Syntax errors are reported as a
    finding (the analyzer must not crash on a broken tree).
    ``suppress=False`` ignores ``analyze: allow(...)`` comments — the
    SUP001 stale-suppression check uses it to learn what each comment
    would have suppressed."""
    try:
        tree = ast.parse(source)
    except SyntaxError as err:
        return [Finding(rule="HS000", severity="error", pass_name=PASS,
                        message=f"unparseable module: {err}",
                        location=f"{path}:{err.lineno or 0}")]
    v = _Visitor(path, source.splitlines(), suppress=suppress)
    v.visit(tree)
    return v.findings


def lint_paths(roots, *, allow=DEFAULT_ALLOW,
               repo_root: pathlib.Path | None = None) -> list[Finding]:
    """Lint every ``.py`` file under ``roots`` (files or directories),
    skipping paths whose POSIX form contains an ``allow`` substring."""
    out: list[Finding] = []
    for root in roots:
        root = pathlib.Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            posix = f.as_posix()
            if any(a in posix for a in allow):
                continue
            rel = (f.relative_to(repo_root).as_posix()
                   if repo_root and f.is_relative_to(repo_root) else posix)
            out.extend(lint_source(f.read_text(), rel))
    return out


def lint_hot_paths(src_root: pathlib.Path | None = None) -> list[Finding]:
    """Lint the port's serving/runtime/kernels hot paths."""
    if src_root is None:
        src_root = pathlib.Path(__file__).resolve().parent.parent
    roots = [src_root / p for p in HOT_PATHS]
    return lint_paths([r for r in roots if r.exists()],
                      repo_root=src_root.parent.parent)
