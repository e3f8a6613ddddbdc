"""Shadow-scheduler divergence auditor (the port's copy of the JAX
package's shadow/; its docs/OBSERVABILITY.md).

The reference's whole value is answering "will it schedule, and where"
with the real kube-scheduler engine (PAPER.md §0); this package closes
the loop in the other direction: take the decisions a REAL scheduler
actually made — tailed live from a cluster (``ingest``) or read from a
recorded decision log (``log``) — replay each one through simon's own
oracle/scan against the same evolving cluster state (``replay``), and
explain every disagreement with per-node filter verdicts and weighted
score vectors (``report``).

Three cooperating uses:

- **continuous conformance**: replaying a production scheduler's log
  reports the agreement rate and a divergence taxonomy (node /
  feasibility / ordering), so simon's answers can be trusted at the
  scale they are meant for;
- **self-conformance**: ``record`` writes a log of simon's OWN serial
  placements; replaying it must report 100% agreement (tests gate it) —
  a loud tripwire for any drift between the serial cycle and the
  warm replay path;
- **trace generation**: a recorded log doubles as the arrival/churn
  trace the time-stepped simulation roadmap item needs.

Entry point: ``simon shadow`` (cli.py).
"""

from .log import (
    DecisionLogWriter,
    Step,
    cluster_fingerprint,
    read_decision_log,
)
from .record import record_simulation
from .replay import ShadowReplayer
from .report import DivergenceReport

__all__ = [
    "DecisionLogWriter",
    "DivergenceReport",
    "ShadowReplayer",
    "Step",
    "cluster_fingerprint",
    "read_decision_log",
    "record_simulation",
]
