"""The program's phases as the per-layer metrics of a `simon apply`
request read them (`Request.phases`: the totals of utils/trace.py
`phase()`, which the port starts afresh at each command's start).

`TOP_LEVEL` are the phases of the cells' requests that no other phase
encloses: `cli/args` (before the command's root span opens), then the
command's own, in the order they run. A request's time outside them is
the program's unattributed time. A program that does not time the
command's own phases (no `cli/args`) gives the readers nothing to read.
"""

from __future__ import annotations

from typing import List, Optional

TOP_LEVEL = (
    "cli/args", "cli/config", "apply/load", "sweep/pad", "sweep/expand", "sweep/encode",
    "sweep/index", "apply/lower-bound", "apply/probe-search", "apply/replay", "apply/check",
    "apply/report", "apply/gc", "cli/print", "cli/release",
)
# the command's work around the plan: arguments, configuration, the
# closing collection, the printed answer and the request's release
OVERHEAD = ("cli/args", "cli/config", "apply/gc", "cli/print", "cli/release")


def _timed(run, kind: str, names) -> Optional[List]:
    """The answered requests of a `kind` run, where each has every phase
    of `names`; None otherwise."""
    done = run.done
    if run.kind != kind or not done:
        return None
    if any(n not in r.phases for r in done for n in names):
        return None
    return done


def phases_ms(run, kind: str, names) -> Optional[float]:
    """Mean over answered requests of the summed seconds of `names`, ms."""
    if _timed(run, kind, names) is None:
        return None
    return run.mean_phase_ms(names)


def unattributed_ms(run, kind: str) -> Optional[float]:
    """Mean over answered requests of the harness's clock around the
    request less its top-level phases, ms."""
    done = _timed(run, kind, ("cli/args",))
    if done is None:
        return None
    return sum(r.seconds - sum(r.phases.get(n, 0.0) for n in TOP_LEVEL)
               for r in done) * 1e3 / len(done)
