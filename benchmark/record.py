"""What one run recorded, as the metric readers (`metrics/<name>.py`)
see it. Each reader defines `read(run: Run) -> Optional[float]` and
returns None where it finds nothing to read; the harness then leaves
its metric out of the result's line."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .devtrace import DeviceTrace


@dataclass
class Request:
    """One `simon apply` of the window."""

    tag: str  # the instance it answered
    ok: bool  # it returned an answer (exit code 0)
    seconds: float  # host clock, call to return
    phases: Dict[str, float] = field(default_factory=dict)  # the program's phase totals, s
    launches: Dict[str, int] = field(default_factory=dict)  # launches by site
    pods: int = 0  # pods the answer placed
    count: int = 0  # new nodes the answer added
    scan_bound_ms: Optional[float] = None  # frozen bound of one scan at `count`


@dataclass
class Run:
    workload: str
    kind: str  # the traffic's kind: "plan" or "deploy"
    setup_s: float
    window_s: float  # the window's start to its last completion, host clock
    requests: List[Request] = field(default_factory=list)
    trace: Optional[DeviceTrace] = None  # traced runs on the card only

    @property
    def done(self) -> List[Request]:
        return [r for r in self.requests if r.ok]

    def mean_phase_ms(self, names) -> Optional[float]:
        """Mean over answered requests of the summed seconds of the
        program's phases `names`, in ms."""
        done = self.done
        if not done:
            return None
        return sum(sum(r.phases.get(n, 0.0) for n in names) for r in done) * 1e3 / len(done)
