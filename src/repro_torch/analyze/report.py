"""Findings: the output side of :mod:`repro_torch.analyze`.

Every pass produces findings (:class:`Finding`), each one rule
violation at one location, with one of three severities:

  * ``error``   — the artifact is wrong or will break at run time
    (an illegal plan);
  * ``warning`` — a correctness or performance hazard that needs human
    judgement;
  * ``info``    — context the operator should see.

The reference's ``Report`` and ``AnalysisError`` come with the rest of
the analysis passes (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses

SEVERITIES = ("info", "warning", "error")

# pass names, in report order (the reference's, ported or not)
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

    rule: str           # e.g. "PL001"
    severity: str       # "info" | "warning" | "error"
    pass_name: str      # "plan", ...
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
