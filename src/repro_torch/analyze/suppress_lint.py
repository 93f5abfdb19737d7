"""SUP001: stale ``# analyze: allow(...)`` comments (unused-noqa analogue).

A copy of the reference's ``repro.analyze.suppress_lint``, over the
port's passes and packages.

A suppression comment is a standing claim — "there IS a finding here and
we accept it". When the code under it changes, the comment can outlive
the finding and silently blanket future, *different* findings on the same
line. This pass keeps the suppression surface honest: for every line
carrying an ``analyze: allow(...)`` comment it re-runs the source-level
passes with suppression disabled (``suppress=False``) and checks that
each token actually matches a finding (by rule, e.g. ``HS004``, or by
pass name, e.g. ``host-sync``) on that line. Tokens that suppress
nothing are flagged as **SUP001** (warning).

Which passes are candidates depends on where the file lives — a token
can only be "used" by a pass that scans that path:

  * ``host-sync`` rules (HS*/RT101): files under the
    :data:`.ast_lint.HOT_PATHS` roots (serving/runtime/kernels of
    ``src/repro_torch``), minus
    its measurement allow-list;
  * ``concurrency`` rules (CL*): files under the
    :data:`.concurrency.ROOTS` roots (serving/runtime/stream).

``allow(SUP001)`` / ``allow(suppression)`` on the same line opts a
deliberate keep-alive comment out of this check.
"""
from __future__ import annotations

import pathlib

from repro_torch.analyze import ast_lint, concurrency
from repro_torch.analyze.ast_lint import _suppressed, allow_tokens
from repro_torch.analyze.report import Finding

PASS = "suppression"

# tokens that can never match a *candidate* source finding but are
# legitimate on a line (suppressing this very check)
_META_TOKENS = frozenset({"SUP001", PASS})


def check_source(source: str, path: str = "<string>", *,
                 passes=("host-sync", "concurrency")) -> list[Finding]:
    """Flag stale allow-tokens in one module. ``passes`` names the
    source-level passes that actually scan this file (see module doc)."""
    lines = source.splitlines()
    comment_lines = {i + 1: allow_tokens(line)
                     for i, line in enumerate(lines)
                     if allow_tokens(line)}
    if not comment_lines:
        return []

    candidates: list[Finding] = []
    if "host-sync" in passes:
        candidates += ast_lint.lint_source(source, path, suppress=False)
    if "concurrency" in passes:
        candidates += concurrency.lint_source(source, path, suppress=False)
    by_line: dict[int, list[Finding]] = {}
    for f in candidates:
        _, _, ln = f.location.rpartition(":")
        if ln.isdigit():
            by_line.setdefault(int(ln), []).append(f)

    out: list[Finding] = []
    for lineno, tokens in sorted(comment_lines.items()):
        here = by_line.get(lineno, [])
        matchable = {t for f in here for t in (f.rule, f.pass_name)}
        stale = sorted(tokens - matchable - _META_TOKENS)
        if not stale:
            continue
        line = lines[lineno - 1]
        if _suppressed(line, "SUP001", PASS):
            continue
        out.append(Finding(
            rule="SUP001", severity="warning", pass_name=PASS,
            message=f"stale suppression: allow({', '.join(stale)}) "
                    f"matches no finding on this line; remove it (or fix "
                    f"the token) so the comment stays a true claim",
            location=f"{path}:{lineno}"))
    return out


def _passes_for(rel_path: str) -> tuple[str, ...]:
    """Which source passes scan a repo-relative path."""
    passes = []
    posix = pathlib.PurePosixPath(rel_path).as_posix()
    in_hot = any(f"repro_torch/{r}/" in posix for r in ast_lint.HOT_PATHS)
    if in_hot and not any(a in posix for a in ast_lint.DEFAULT_ALLOW):
        passes.append("host-sync")
    if any(f"repro_torch/{r}/" in posix for r in concurrency.ROOTS):
        passes.append("concurrency")
    return tuple(passes)


def check_paths(roots, *, repo_root: pathlib.Path | None = None
                ) -> list[Finding]:
    out: list[Finding] = []
    for root in roots:
        root = pathlib.Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            rel = (f.relative_to(repo_root).as_posix()
                   if repo_root and f.is_relative_to(repo_root)
                   else f.as_posix())
            out.extend(check_source(f.read_text(), rel,
                                    passes=_passes_for(rel)))
    return out


def check_default_paths(src_root: pathlib.Path | None = None
                        ) -> list[Finding]:
    """Audit every package of the port any source-level pass scans."""
    if src_root is None:
        src_root = pathlib.Path(__file__).resolve().parent.parent
    pkgs = sorted(set(ast_lint.HOT_PATHS) | set(concurrency.ROOTS))
    roots = [src_root / p for p in pkgs]
    return check_paths([r for r in roots if r.exists()],
                       repo_root=src_root.parent.parent)
