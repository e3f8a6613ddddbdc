"""The traced run's reading of the card: `torch.profiler` (CUDA activity
through CUPTI) over the measured window, with the program's own phase
spans (its span recorder, `obs/spans.py`) beside it so that each idle
stretch of the card is named by the phase the host was in.

The two clocks meet at one marker: the window opens with a profiler
`record_function` and a span of the same name at the same instant.
Where the profiler records no CUDA activity in the window, the trace
has nothing to say of the card: `Tracer` raises, and the run prints no
result.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_MARK = "bench/window"


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    # (name, start, end) of each device operation in seconds from the
    # window's start, clipped to the window
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    # (phase the host was in, seconds) of each stretch the card was idle
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds_of(self, needle: str) -> float:
        """Device seconds of the operations whose name holds `needle`."""
        return sum(e - s for name, s, e in self.ops if needle in name)

    def idle_by_phase(self) -> Dict[str, float]:
        """Idle seconds of the card summed by the host's phase."""
        out: Dict[str, float] = defaultdict(float)
        for name, secs in self.gaps:
            out[name] += secs
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by_name[_short(name)] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _short(name: str) -> str:
    """A device operation's name without its return type and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(", 1)[0][:120]


class Tracer:
    """Context manager around the measured window of a traced run."""

    def __init__(self):
        self.trace: Optional[DeviceTrace] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from open_simulator_tpu_torch.obs.spans import RECORDER

        RECORDER.enable()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark = record_function(WINDOW_MARK)
        self._mark.__enter__()
        self._span = RECORDER.span(WINDOW_MARK)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        from open_simulator_tpu_torch.obs.spans import RECORDER

        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        spans = RECORDER.snapshot()
        RECORDER.disable()
        if exc[0] is None:
            self.trace = _read(self._prof, spans)
        return False


def _read(prof, spans) -> DeviceTrace:
    events = prof.profiler.kineto_results.events()
    # the mark's host range; the profiler mirrors it on the device's
    # timeline as an annotation, which is no device work
    marks = [e for e in events if e.name() == WINDOW_MARK and "CPU" in str(e.device_type())]
    w0 = marks[0].start_ns()
    w1 = w0 + marks[0].duration_ns()
    window_s = (w1 - w0) / 1e9
    ops = []
    for e in events:
        if "CUDA" not in str(e.device_type()) or e.name() == WINDOW_MARK:
            continue
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        s = max(e.start_ns(), w0)
        t = min(e.start_ns() + e.duration_ns(), w1)
        if t > s:
            ops.append((e.name(), (s - w0) / 1e9, (t - w0) / 1e9))
    if not ops:
        raise RuntimeError("the profiler recorded no device activity in the traced window")
    ops.sort(key=lambda o: o[1])
    busy, gaps_at = 0.0, []
    cur_s, cur_e = None, 0.0
    for _, s, e in ops:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps_at.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps_at.append((cur_e, window_s))
    # the spans' clock: seconds from the recorder's epoch; the window's
    # span opened at the profiler's mark
    anchor = next(sp for sp in spans if sp.name == WINDOW_MARK)
    segments = _innermost(spans, anchor.t0)
    gaps = []
    for a, b in gaps_at:
        if b > a:
            gaps.extend(_split(a, b, segments))
    return DeviceTrace(window_s=window_s, busy_s=busy, ops=ops, gaps=gaps)


def _innermost(spans, t0: float) -> List[Tuple[float, float, str]]:
    """The window cut where any of the program's spans opens or closes,
    each piece named by the innermost span open over it (in seconds from
    the window's start)."""
    inner = [(sp.t0 - t0, sp.t1 - t0, sp.name) for sp in spans if sp.name != WINDOW_MARK]
    cuts = sorted({t for a, b, _ in inner for t in (a, b)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        around = [sp for sp in inner if sp[0] <= mid <= sp[1]]
        if around:
            out.append((a, b, max(around, key=lambda sp: (sp[0], -sp[1]))[2]))
    return out


def _split(a: float, b: float, segments) -> List[Tuple[str, float]]:
    """An idle stretch [a, b) cut by the host's phases: (phase, seconds)
    of each piece, "harness" where no phase of the program was open."""
    pieces, covered = [], 0.0
    for s, e, name in segments:
        lo, hi = max(a, s), min(b, e)
        if hi > lo:
            if pieces and pieces[-1][0] == name:
                pieces[-1] = (name, pieces[-1][1] + hi - lo)
            else:
                pieces.append((name, hi - lo))
            covered += hi - lo
    if b - a - covered > 1e-9:
        pieces.append(("harness", b - a - covered))
    return pieces
