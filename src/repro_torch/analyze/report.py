"""Findings + severity-leveled report: the output side of
:mod:`repro_torch.analyze`.

Every pass (retrace, dtype, host-sync, concurrency, suppression,
lock-order, plan, comm) produces :class:`Finding`s — one rule violation
at one location — and the callers (the ``launch.analyze`` CLI,
``runtime.compile(analyze=...)``, the ``Server`` preflight) aggregate
them into a :class:`Report` that renders itself, serializes to JSON and
answers the one question a gate asks: *did anything at or above the
fail threshold fire?* Given the same findings, ``render()`` and
``to_json()`` equal the reference's.

Severities:

  * ``error``   — the artifact is wrong or will break at run time
    (illegal plan, contract violation, a rebuild on every request);
  * ``warning`` — a correctness or performance hazard that needs human
    judgement (host sync in a hot path, a non-float32 entry input);
  * ``info``    — context the operator should see.

Suppression (source-based passes only): a line containing
``analyze: allow(<rule-or-pass>)`` inside any comment suppresses findings
of that rule (or that whole pass) on that line.
"""
from __future__ import annotations

import dataclasses

SEVERITIES = ("info", "warning", "error")

# pass names, in report order
PASSES = ("retrace", "dtype", "host-sync", "concurrency", "suppression",
          "lock-order", "plan", "comm")


def severity_rank(severity: str) -> int:
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(f"unknown severity {severity!r}; "
                         f"choose {SEVERITIES}") from None


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location."""

    rule: str           # e.g. "HS001"
    severity: str       # "info" | "warning" | "error"
    pass_name: str      # one of PASSES
    message: str
    location: str = ""  # "path:line", plan/layer id, or entry-point name

    def __post_init__(self):
        severity_rank(self.severity)   # validate eagerly

    def render(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.severity:<7} {self.rule} ({self.pass_name}){loc}: " \
               f"{self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Finding":
        return cls(**d)


class AnalysisError(RuntimeError):
    """Raised by the ``analyze="error"`` integration hooks when a report
    holds error-severity findings; carries the report for post-mortems."""

    def __init__(self, report: "Report"):
        self.report = report
        super().__init__(report.render())


@dataclasses.dataclass
class Report:
    """Aggregated findings of one analysis run."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    timings_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    # pass -> human reason it did not run; a skip is visible, never silent
    skipped: dict[str, str] = dataclasses.field(default_factory=dict)

    def add(self, *findings: Finding) -> None:
        self.findings.extend(findings)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def merge(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.timings_ms.update(other.timings_ms)
        self.skipped.update(other.skipped)

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    def at_least(self, severity: str) -> list[Finding]:
        floor = severity_rank(severity)
        return [f for f in self.findings
                if severity_rank(f.severity) >= floor]

    def worst(self) -> str | None:
        if not self.findings:
            return None
        return max((f.severity for f in self.findings), key=severity_rank)

    def failed(self, fail_on: str) -> bool:
        """True when any finding is at/above the threshold. ``fail_on``
        is a severity or ``"never"`` (gate disabled)."""
        if fail_on == "never":
            return False
        return bool(self.at_least(fail_on))

    def render(self) -> str:
        lines = []
        order = {p: i for i, p in enumerate(PASSES)}
        for f in sorted(self.findings,
                        key=lambda f: (-severity_rank(f.severity),
                                       order.get(f.pass_name, len(order)),
                                       f.rule, f.location)):
            lines.append(f.render())
        for pass_name, why in self.skipped.items():
            lines.append(f"skipped {pass_name}: {why}")
        counts = ", ".join(f"{self.count(s)} {s}" for s in
                           reversed(SEVERITIES))
        total_ms = sum(self.timings_ms.values())
        lines.append(f"analyze: {counts} across "
                     f"{len(self.timings_ms)} passes "
                     f"({total_ms:.0f} ms)")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"findings": [f.to_json() for f in self.findings],
                "timings_ms": {k: round(v, 3)
                               for k, v in self.timings_ms.items()},
                "skipped": dict(self.skipped),
                "counts": {s: self.count(s) for s in SEVERITIES}}
