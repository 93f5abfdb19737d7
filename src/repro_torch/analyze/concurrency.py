"""Lock-discipline lint: static concurrency analysis of the serving stack.

A copy of the reference's ``repro.analyze.concurrency``: given the same
source text, the same findings. The serving stack is concurrent — a
background thread steps the engine while caller threads
submit/poll/mutate/reload and the stream trainer fine-tunes alongside —
so this pass walks the AST of the port's ``serving/``, ``runtime/`` and
``stream/`` and builds a per-class model of

  * the **locks** a class owns (``self.x = threading.Lock()`` / ``RLock``
    / ``Condition``, or the sanitizer factories ``new_lock`` /
    ``new_rlock`` / ``new_condition`` from
    :mod:`repro_torch.analyze.lock_sanitizer`),
  * the **attributes written inside** ``with self.<lock>:`` blocks, and
  * explicit ``# guarded-by: <lock>`` annotations on attribute
    assignments. An annotation naming a lock of the *same class*
    (``# guarded-by: _cv``) makes the guard mandatory everywhere; any
    other token (``# guarded-by: Server._step_lock``, ``# guarded-by:
    caller``) documents an *external* serialization invariant the class
    relies on — the attribute is exempt here, and the comment is the
    audit trail a reader (and the README concurrency-model table)
    checks against the caller.

Rules:

  * **CL001** (error)   — an attribute whose guard is known (annotated,
    or inferred because every other write takes the same lock) is
    written without that lock held.
  * **CL002** (error)   — the lock-acquisition-order graph has a cycle:
    some code path acquires B while holding A and another acquires A
    while holding B — a deadlock waiting for the right interleaving.
    Edges are collected lexically *and* through self/attribute method
    calls whose receiver class is statically known (``self._store =
    runtime.GraphStore(...)`` makes ``self._store.get()`` resolvable).
  * **CL003** (warning) — blocking work lexically inside a ``with
    self.<lock>:`` block (``block_until_ready``, ``runtime.compile``,
    ``jax.device_get``, ``time.sleep``): a serving-stall hazard — every
    thread needing the lock waits out the device/compile round trip.
    (``Condition.wait`` is fine: it releases the lock.)
  * **CL004** (error)   — unsynchronized read-modify-write on shared
    state: ``self.stats["x"] += 1`` outside any lock (any scanned
    class), or a plain ``self.x += 1`` outside any lock in a class that
    owns locks. ``+=`` is a read, an add and a write — two threads
    interleaving lose updates. Annotate the external invariant or take
    a lock.
  * **CL005** (warning) — a mutable container attribute (dict/list/set
    built in ``__init__``) ``return``-ed from inside a locked region
    without a copy: the caller now mutates/iterates shared state
    *outside* the lock the region promised.

What the pass deliberately does not try: aliasing (``q = self._queues[k];
heapq.heappush(q, ...)``), closures (nested ``def``/``lambda`` bodies are
skipped), and dynamic dispatch through unknown receivers. The dynamic
half — :mod:`repro_torch.analyze.lock_sanitizer` — covers what static scoping
cannot see.

Suppression: the repo-wide ``# analyze: allow(CL003)`` /
``allow(concurrency)`` comment contract (see :mod:`.ast_lint`).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from repro_torch.analyze.ast_lint import _attr_chain, _suppressed
from repro_torch.analyze.report import Finding

PASS = "concurrency"

# packages scanned by default, relative to src/repro_torch (the threads:
# Server thread + callers, runtime caches, stream trainer)
ROOTS = ("serving", "runtime", "stream")

# terminal callee names that construct a lock (stdlib + sanitizer factories)
_LOCK_FACTORIES = frozenset({
    "Lock", "RLock", "Condition", "new_lock", "new_rlock", "new_condition",
})

# container-mutator method names: self.x.append(...) is a write to x
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "move_to_end", "appendleft",
    "popleft",
})

# __init__-built container constructors that make an attribute "mutable
# internal state" for CL005
_CONTAINER_CTORS = frozenset({
    "dict", "list", "set", "OrderedDict", "defaultdict", "deque", "Counter",
})

_GUARDED_BY_RE = re.compile(r"guarded-by:\s*([A-Za-z_][\w.]*)")

# sentinel guard: the attribute is exempt (external invariant documented)
_EXEMPT = "<exempt>"


def _self_attr(node: ast.AST) -> str | None:
    """'x' for the expression ``self.x``; None otherwise."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _is_blocking(chain: list[str]) -> bool:
    if not chain:
        return False
    if chain[-1] == "block_until_ready":
        return True
    if chain == ["time", "sleep"]:
        return True
    if chain[0] == "jax" and chain[-1] == "device_get":
        return True
    if chain[0] == "runtime" and chain[-1] in ("compile", "fit"):
        return True
    return False


@dataclasses.dataclass
class _Write:
    attr: str
    lineno: int
    held: tuple          # lock attrs held at the write, outermost first
    in_init: bool
    kind: str            # assign | augassign | assign-subscript |
    #                      augassign-subscript | mutcall | del


@dataclasses.dataclass
class _Acquire:
    lock: str
    lineno: int
    held: tuple          # locks already held when this one is taken


@dataclasses.dataclass
class _CallSite:
    recv: str            # "self" or the self-attribute the call goes through
    meth: str
    lineno: int
    held: tuple


@dataclasses.dataclass
class _Method:
    name: str
    acquires: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _ClassModel:
    name: str
    path: str
    locks: dict = dataclasses.field(default_factory=dict)        # attr->line
    annotations: dict = dataclasses.field(default_factory=dict)  # attr->tok
    mutable_attrs: set = dataclasses.field(default_factory=set)
    attr_classes: dict = dataclasses.field(default_factory=dict)  # attr->cls
    writes: list = dataclasses.field(default_factory=list)
    returns: list = dataclasses.field(default_factory=list)   # (attr,ln,held)
    blocking: list = dataclasses.field(default_factory=list)  # (desc,ln,held)
    methods: dict = dataclasses.field(default_factory=dict)   # name->_Method


class _ClassScanner:
    def __init__(self, node: ast.ClassDef, path: str, lines: list[str]):
        self.node = node
        self.path = path
        self.lines = lines

    def scan(self) -> _ClassModel:
        cm = _ClassModel(name=self.node.name, path=self.path)
        funcs = [n for n in self.node.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # phase 1: lock inventory, guarded-by annotations, __init__ facts
        for fn in funcs:
            init = fn.name in ("__init__", "__post_init__")
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in targets:
                        attr = _self_attr(t)
                        if attr is None:
                            continue
                        self._note_annotation(cm, attr, sub.lineno)
                        value = getattr(sub, "value", None)
                        if isinstance(sub, ast.AugAssign) or value is None:
                            continue
                        self._classify_value(cm, attr, value, init)
        # phase 2: lexical held-lock tracking through every method body
        for fn in funcs:
            m = _Method(name=fn.name)
            cm.methods[fn.name] = m
            self._block(fn.body, (), cm, m,
                        fn.name in ("__init__", "__post_init__"))
        return cm

    def _note_annotation(self, cm: _ClassModel, attr: str,
                         lineno: int) -> None:
        if 0 < lineno <= len(self.lines):
            mt = _GUARDED_BY_RE.search(self.lines[lineno - 1])
            if mt:
                cm.annotations[attr] = mt.group(1)

    def _classify_value(self, cm: _ClassModel, attr: str, value: ast.AST,
                        in_init: bool) -> None:
        if isinstance(value, ast.Call):
            chain = _attr_chain(value.func)
            tail = chain[-1] if chain else ""
            if tail in _LOCK_FACTORIES:
                cm.locks[attr] = value.lineno
                return
            if in_init:
                if tail in _CONTAINER_CTORS:
                    cm.mutable_attrs.add(attr)
                elif tail and tail[0].isupper():
                    cm.attr_classes[attr] = tail
        elif in_init and isinstance(value, (ast.Dict, ast.List, ast.Set,
                                            ast.ListComp, ast.DictComp,
                                            ast.SetComp)):
            cm.mutable_attrs.add(attr)

    # -- statement walk with a lexical held-locks tuple ---------------------

    def _block(self, stmts, held, cm, m, in_init) -> None:
        for s in stmts:
            self._stmt(s, held, cm, m, in_init)

    def _stmt(self, s, held, cm, m, in_init) -> None:
        if isinstance(s, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in s.items:
                lock = _self_attr(item.context_expr)
                if lock is not None and lock in cm.locks:
                    m.acquires.append(_Acquire(lock, item.context_expr.lineno,
                                               new_held))
                    if lock not in new_held:
                        new_held = new_held + (lock,)
                else:
                    self._expr(item.context_expr, held, cm, m, in_init)
            self._block(s.body, new_held, cm, m, in_init)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            pass  # closures/nested scopes: out of lexical scope (see doc)
        elif isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            aug = isinstance(s, ast.AugAssign)
            for t in targets:
                self._target(t, s.lineno, held, cm, m, in_init, aug)
            if getattr(s, "value", None) is not None:
                self._expr(s.value, held, cm, m, in_init)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                    if attr is not None:
                        cm.writes.append(_Write(attr, s.lineno, held,
                                                in_init, "del"))
                    self._expr(t.slice, held, cm, m, in_init)
                else:
                    self._expr(t, held, cm, m, in_init)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                attr = _self_attr(s.value)
                if attr is not None:
                    cm.returns.append((attr, s.lineno, held))
                self._expr(s.value, held, cm, m, in_init)
        else:
            self._generic(s, held, cm, m, in_init)

    def _generic(self, node, held, cm, m, in_init) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child, held, cm, m, in_init)
            elif isinstance(child, ast.expr):
                self._expr(child, held, cm, m, in_init)
            else:  # ExceptHandler, withitem, match cases, ...
                self._generic(child, held, cm, m, in_init)

    def _target(self, t, lineno, held, cm, m, in_init, aug) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._target(e, lineno, held, cm, m, in_init, aug)
            return
        if isinstance(t, ast.Starred):
            self._target(t.value, lineno, held, cm, m, in_init, aug)
            return
        attr = _self_attr(t)
        if attr is not None:
            cm.writes.append(_Write(attr, lineno, held, in_init,
                                    "augassign" if aug else "assign"))
            return
        if isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
            if attr is not None:
                cm.writes.append(_Write(
                    attr, lineno, held, in_init,
                    "augassign-subscript" if aug else "assign-subscript"))
            else:
                self._expr(t.value, held, cm, m, in_init)
            self._expr(t.slice, held, cm, m, in_init)

    def _expr(self, e, held, cm, m, in_init) -> None:
        if e is None or isinstance(e, ast.Lambda):
            return
        if isinstance(e, ast.Call):
            self._record_call(e, held, cm, m, in_init)
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self._expr(child, held, cm, m, in_init)
            elif isinstance(child, (ast.keyword, ast.comprehension)):
                for c2 in ast.iter_child_nodes(child):
                    if isinstance(c2, ast.expr):
                        self._expr(c2, held, cm, m, in_init)

    def _record_call(self, e: ast.Call, held, cm, m, in_init) -> None:
        chain = _attr_chain(e.func)
        if held and _is_blocking(chain):
            cm.blocking.append((".".join(chain), e.lineno, held))
        if isinstance(e.func, ast.Attribute):
            recv_attr = _self_attr(e.func.value)
            if e.func.attr in _MUTATORS and recv_attr is not None \
                    and recv_attr not in cm.locks:
                cm.writes.append(_Write(recv_attr, e.lineno, held, in_init,
                                        "mutcall"))
            if isinstance(e.func.value, ast.Name) and \
                    e.func.value.id == "self":
                m.calls.append(_CallSite("self", e.func.attr, e.lineno, held))
            elif recv_attr is not None:
                m.calls.append(_CallSite(recv_attr, e.func.attr, e.lineno,
                                         held))


# -- per-class rules ---------------------------------------------------------


def _guard_of(cm: _ClassModel, attr: str) -> str | None:
    """The lock guarding ``attr``: a same-class lock attr, ``_EXEMPT``
    (documented external invariant / the lock object itself), or None
    (no guard is known — CL004 territory)."""
    token = cm.annotations.get(attr)
    if token is not None:
        cand = token[5:] if token.startswith("self.") else token
        return cand if cand in cm.locks else _EXEMPT
    if attr in cm.locks:
        return _EXEMPT
    locked = [set(w.held) for w in cm.writes
              if w.attr == attr and not w.in_init and w.held]
    if not locked:
        return None
    common = set.intersection(*locked)
    return sorted(common)[0] if common else None


def _class_findings(cm: _ClassModel) -> list[Finding]:
    out: list[Finding] = []
    guards = {a: _guard_of(cm, a) for a in {w.attr for w in cm.writes}}
    for w in cm.writes:
        if w.in_init:
            continue
        g = guards[w.attr]
        if g == _EXEMPT:
            continue
        if g is not None:
            if g not in w.held:
                ann = cm.annotations.get(w.attr)
                how = f"annotated guarded-by: {ann}" if ann else \
                    "inferred: every other write holds it"
                out.append(Finding(
                    rule="CL001", severity="error", pass_name=PASS,
                    message=f"{cm.name}.{w.attr} is guarded by "
                            f"self.{g} ({how}) but written here without "
                            f"the lock held",
                    location=f"{cm.path}:{w.lineno}"))
            continue
        if w.held:
            continue
        if w.kind == "augassign-subscript" or \
                (w.kind == "augassign" and cm.locks):
            out.append(Finding(
                rule="CL004", severity="error", pass_name=PASS,
                message=f"unsynchronized read-modify-write on "
                        f"{cm.name}.{w.attr}: += outside any lock loses "
                        f"updates under concurrent callers; take a lock "
                        f"or document the single-writer invariant with "
                        f"`# guarded-by: <who>`",
                location=f"{cm.path}:{w.lineno}"))
    for desc, lineno, held in cm.blocking:
        out.append(Finding(
            rule="CL003", severity="warning", pass_name=PASS,
            message=f"blocking call {desc}() while holding "
                    f"self.{held[-1]}: every thread contending on the "
                    f"lock stalls for the full device/compile round trip",
            location=f"{cm.path}:{lineno}"))
    for attr, lineno, held in cm.returns:
        if held and attr in cm.mutable_attrs:
            out.append(Finding(
                rule="CL005", severity="warning", pass_name=PASS,
                message=f"mutable internal state {cm.name}.{attr} "
                        f"escapes the self.{held[-1]} region by "
                        f"reference; return a copy (dict(...), list(...)) "
                        f"so callers cannot mutate/iterate it unlocked",
                location=f"{cm.path}:{lineno}"))
    return out


# -- CL002: cross-method / cross-class acquisition-order cycles --------------


def _order_findings(models: list[_ClassModel]) -> list[Finding]:
    by_name: dict[str, _ClassModel] = {}
    for cm in models:
        by_name.setdefault(cm.name, cm)

    # node = (class, lock attr); edge a->b = "b acquired while a held"
    edges: dict[tuple, tuple[str, str]] = {}

    def add_edge(a, b, loc, via):
        if a != b:
            edges.setdefault((a, b), (loc, via))

    memo: dict[tuple, set] = {}

    def acquired_by(cls_name: str, meth: str, stack: frozenset) -> set:
        """Transitive set of (class, lock) nodes a call to
        ``cls_name.meth`` may acquire."""
        key = (cls_name, meth)
        if key in memo:
            return memo[key]
        if key in stack:
            return set()
        cm = by_name.get(cls_name)
        if cm is None or meth not in cm.methods:
            return set()
        out: set = set()
        stack = stack | {key}
        mm = cm.methods[meth]
        for acq in mm.acquires:
            out.add(((cls_name, acq.lock), f"{cm.path}:{acq.lineno}"))
        for cs in mm.calls:
            tgt = cls_name if cs.recv == "self" \
                else cm.attr_classes.get(cs.recv)
            if tgt is not None:
                out |= acquired_by(tgt, cs.meth, stack)
        memo[key] = out
        return out

    for cm in models:
        for mm in cm.methods.values():
            for acq in mm.acquires:
                for h in acq.held:
                    add_edge((cm.name, h), (cm.name, acq.lock),
                             f"{cm.path}:{acq.lineno}",
                             f"{cm.name}.{mm.name}")
            for cs in mm.calls:
                if not cs.held:
                    continue
                tgt = cm.name if cs.recv == "self" \
                    else cm.attr_classes.get(cs.recv)
                if tgt is None:
                    continue
                for node, loc in acquired_by(tgt, cs.meth, frozenset()):
                    for h in cs.held:
                        add_edge((cm.name, h), node,
                                 f"{cm.path}:{cs.lineno}",
                                 f"{cm.name}.{mm.name} -> "
                                 f"{tgt}.{cs.meth} ({loc})")

    # Tarjan SCCs over the edge graph; any SCC with >= 2 nodes is a cycle
    adj: dict[tuple, list[tuple]] = {}
    nodes: set[tuple] = set()
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
        nodes.add(a)
        nodes.add(b)

    index: dict[tuple, int] = {}
    low: dict[tuple, int] = {}
    on_stack: set[tuple] = set()
    stack: list[tuple] = []
    sccs: list[list[tuple]] = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(adj.get(v, ())))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)

    out: list[Finding] = []
    for scc in sccs:
        if len(scc) < 2:
            continue
        members = set(scc)
        # witness cycle inside the SCC via DFS from its smallest node
        start = min(scc)
        path = _cycle_path(start, adj, members)
        steps = []
        for a, b in zip(path, path[1:]):
            loc, via = edges[(a, b)]
            steps.append(f"{a[0]}.{a[1]} -> {b[0]}.{b[1]} "
                         f"[{via} at {loc}]")
        first_loc = edges[(path[0], path[1])][0]
        out.append(Finding(
            rule="CL002", severity="error", pass_name=PASS,
            message="lock-acquisition-order cycle (deadlock hazard): "
                    + "; ".join(steps),
            location=first_loc))
    return out


def _cycle_path(start, adj, members) -> list:
    """A cycle [start, ..., start] staying inside ``members``."""
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        for nxt in adj.get(node, ()):
            if nxt not in members:
                continue
            if nxt == start:
                return path + [start]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return [start, start]  # unreachable for a true SCC


# -- entry points ------------------------------------------------------------


def scan_source(source: str, path: str = "<string>"
                ) -> tuple[list[_ClassModel], list[Finding]]:
    """Per-class models for one module (syntax errors become a CL000
    finding instead of an exception)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as err:
        return [], [Finding(
            rule="CL000", severity="error", pass_name=PASS,
            message=f"unparseable module: {err}",
            location=f"{path}:{err.lineno or 0}")]
    lines = source.splitlines()
    models = [_ClassScanner(n, path, lines).scan()
              for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    return models, []


def _apply_suppression(findings: list[Finding],
                       lines_by_path: dict[str, list[str]]) -> list[Finding]:
    out = []
    for f in findings:
        path, _, lineno = f.location.rpartition(":")
        lines = lines_by_path.get(path)
        line = ""
        if lines and lineno.isdigit() and 0 < int(lineno) <= len(lines):
            line = lines[int(lineno) - 1]
        if not _suppressed(line, f.rule, f.pass_name):
            out.append(f)
    return out


def lint_sources(named_sources, *, suppress: bool = True) -> list[Finding]:
    """Run every CL rule over ``[(path, source), ...]`` together —
    CL002's acquisition-order graph spans all of them."""
    models: list[_ClassModel] = []
    findings: list[Finding] = []
    lines_by_path: dict[str, list[str]] = {}
    for path, source in named_sources:
        lines_by_path[path] = source.splitlines()
        ms, errs = scan_source(source, path)
        models.extend(ms)
        findings.extend(errs)
    for cm in models:
        findings.extend(_class_findings(cm))
    findings.extend(_order_findings(models))
    if suppress:
        findings = _apply_suppression(findings, lines_by_path)
    return findings


def lint_source(source: str, path: str = "<string>", *,
                suppress: bool = True) -> list[Finding]:
    """Single-module convenience wrapper over :func:`lint_sources`."""
    return lint_sources([(path, source)], suppress=suppress)


def lint_paths(roots, *, allow=(), repo_root: pathlib.Path | None = None,
               suppress: bool = True) -> list[Finding]:
    """Lint every ``.py`` under ``roots`` as one corpus (CL002 edges
    cross files), mirroring :func:`.ast_lint.lint_paths`."""
    named: list[tuple[str, str]] = []
    for root in roots:
        root = pathlib.Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            posix = f.as_posix()
            if any(a in posix for a in allow):
                continue
            rel = (f.relative_to(repo_root).as_posix()
                   if repo_root and f.is_relative_to(repo_root) else posix)
            named.append((rel, f.read_text()))
    return lint_sources(named, suppress=suppress)


def lint_default_paths(src_root: pathlib.Path | None = None
                       ) -> list[Finding]:
    """Lint the port's serving/runtime/stream packages."""
    if src_root is None:
        src_root = pathlib.Path(__file__).resolve().parent.parent
    roots = [src_root / p for p in ROOTS]
    return lint_paths([r for r in roots if r.exists()],
                      repo_root=src_root.parent.parent)
