"""repro_torch.analyze — static checks over what the port produces.

Two passes are ported: plan legality (:mod:`repro_torch.analyze.plan_lint`,
which the autotuner prunes its candidates with) and the comm contract of
sharded execution (:mod:`repro_torch.analyze.comm_lint`, over counted
collectives), with the findings they report
(:mod:`repro_torch.analyze.report`). The reference's other passes
(host-sync, concurrency, lock order, the compile and serving hooks, the
CLI gate) are ROADMAP.md Queue 1 item 6.
"""
from repro_torch.analyze.report import (PASSES, SEVERITIES, Finding,
                                        severity_rank)

__all__ = ["Finding", "SEVERITIES", "PASSES", "severity_rank"]
