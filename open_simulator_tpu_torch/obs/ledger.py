"""Device-memory ledger: how much of the card's memory is in use, has
peaked, and would be after a launch.

The port's counterpart of the JAX package's obs/ledger.py, on PyTorch's
caching allocator:

- ``poll(device)``: the bytes the allocator holds for tensors now
  (``torch.cuda.memory_stats(dev)["allocated_bytes.all.current"]``) and
  its peak (``...peak``). Polled at every instrumented launch
  (obs/profile.py) and at top-level span boundaries, keeping the
  process peak and a watermark per top-level span. A CPU launch has no
  allocator stats and is not polled.
- ``predict_fit(estimate_bytes)``: would a launch that allocates
  ``estimate_bytes`` (obs/costs.py ``workspace_bytes``) fit beside what
  is in use, under the budget? True / False / None (no budget known:
  the caller stays reactive). ``guard.run_chunked`` asks before every
  chunk and splits a chunk predicted not to fit before launching it.
- the verdicts are counted (``ledger_predict_*``), and the executor
  counts a hit or a miss after the launch;
- the mesh (parallel/mesh.py): ``watch(devices)`` adds a mesh's cards to
  every poll, so ``device_summary`` has one row a distinct device;
  ``predict_fit(..., shards=N)`` compares a PER-DEVICE estimate with the
  tightest watched device's room (a sharded launch lives or dies on its
  tightest shard), and ``would_fit`` is the verdict without the
  counters, for the layout planner's probes.

The budget is ``SIMON_DEVICE_MEM_BUDGET`` (bytes) when set, else the
card's total memory from ``torch.cuda.mem_get_info``. On the CPU there
are no allocator stats: the budget is the environment variable's or
unknown (``predict_fit`` answers None), and nothing is in use.

``ledger.predict_fit`` is an injection seam (runtime/inject.py):
``lie:low`` answers True, ``lie:high`` False, through the same counters.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from ..utils.trace import COUNTERS

# fraction of the budget a predicted launch may fill: allocator
# fragmentation and the CUDA context's own memory mean "exactly fits"
# is already an OOM in practice
DEFAULT_HEADROOM = 0.92


def _env_budget() -> Optional[int]:
    env = os.environ.get("SIMON_DEVICE_MEM_BUDGET")
    try:
        return int(env) if env else None
    except ValueError:
        return None


def _card():
    """The torch device the ledger reads: the current CUDA device once
    CUDA is initialised in this process, else None (a CPU run, which
    must not create a CUDA context to read the ledger)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def device_memory_stats(device=None):
    """(bytes_in_use, peak_bytes, bytes_limit, source) of `device` (the
    current card when None). ``source`` is "cuda_allocator" on the card
    and "none" where there are no allocator stats (the CPU)."""
    import torch

    dev = torch.device(device) if device is not None else _card()
    if dev is None or dev.type != "cuda":
        return 0, 0, _env_budget(), "none"
    stats = torch.cuda.memory_stats(dev)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    peak = int(stats.get("allocated_bytes.all.peak", 0))
    limit = _env_budget()
    if limit is None:
        limit = int(torch.cuda.mem_get_info(dev)[1])
    return in_use, peak, limit, "cuda_allocator"


def device_memory_stats_per_device(devices):
    """[{device, in_use, limit}] for each distinct device of `devices`
    that has allocator stats (none on the CPU)."""
    import torch

    rows = []
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        in_use, _peak, limit, source = device_memory_stats(dev)
        if source != "none":
            rows.append({"device": str(dev), "in_use": in_use, "limit": limit})
    return rows


class MemoryLedger:
    """Process-wide memory observatory; all mutation under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.peak_bytes = 0
        self.samples = 0
        self.source = "unpolled"
        self.device = None
        self.limit = None
        self._last_in_use = 0
        # mesh devices polled beside the launch's own (watch), and the
        # last row of every device polled, in first-poll order
        self._watched: list = []
        self._rows: Dict[str, dict] = {}
        # open top-level spans: frame id -> [name, peak while open];
        # closed frames fold into `watermarks` (max per name)
        self._frames: Dict[int, list] = {}
        self._next_frame = 1
        self.watermarks: Dict[str, int] = {}

    def watch(self, devices) -> None:
        """Poll `devices` (a mesh's) at every poll from now on."""
        import torch

        with self._lock:
            for d in devices:
                d = torch.device(d)
                if d.type == "cuda" and d not in self._watched:
                    self._watched.append(d)

    def _poll_watched(self, primary) -> None:
        with self._lock:
            watched = [d for d in self._watched if str(d) != primary]
        for dev in watched:
            in_use, peak, limit, source = device_memory_stats(dev)
            if source == "none":
                continue
            with self._lock:
                self._rows[str(dev)] = {"device": str(dev), "in_use": in_use, "limit": limit}
                self.peak_bytes = max(self.peak_bytes, peak, in_use)

    def poll(self, device=None) -> int:
        """Sample the card's allocator (and every watched mesh device's);
        update the process peak, every open span frame and the exported
        gauges. Returns the bytes in use on `device` (0 where there are
        no allocator stats)."""
        in_use, peak, limit, source = device_memory_stats(device)
        primary = None
        if source != "none":
            primary = str(device if device is not None else _card())
        self._poll_watched(primary)
        if source == "none":
            return 0
        with self._lock:
            self.samples += 1
            self.source = source
            self.device = primary
            self.limit = limit
            self._last_in_use = in_use
            self._rows[primary] = {"device": primary, "in_use": in_use, "limit": limit}
            self.peak_bytes = max(self.peak_bytes, peak, in_use)
            for frame in self._frames.values():
                # the allocator's peak spans the whole process: a frame
                # keeps only what was in use while it was open
                frame[1] = max(frame[1], in_use)
            top = self.peak_bytes
        COUNTERS.gauge("device_mem_bytes_in_use", float(in_use))
        COUNTERS.gauge("device_mem_peak_bytes", float(top))
        if limit:
            COUNTERS.gauge("device_mem_bytes_limit", float(limit))
        return in_use

    def span_open(self, name: str) -> int:
        """Begin a top-level-span watermark frame (the spans.py boundary
        hook). Returns the frame id to close with."""
        in_use = self.poll()
        with self._lock:
            fid = self._next_frame
            self._next_frame += 1
            self._frames[fid] = [name, in_use]
        return fid

    def span_close(self, fid: int) -> None:
        self.poll()
        with self._lock:
            frame = self._frames.pop(fid, None)
            if frame is None:
                return
            name, peak = frame
            if peak > self.watermarks.get(name, 0):
                self.watermarks[name] = peak

    # -- prediction ---------------------------------------------------------

    def predict_fit(self, estimate_bytes: int, *, headroom: float = DEFAULT_HEADROOM,
                    label: str = "", device=None, shards: int = 1) -> Optional[bool]:
        """Would a launch allocating ``estimate_bytes`` fit now? None
        when no budget is known; every verdict is counted. With
        ``shards`` > 1 the launch is split over the mesh and the
        estimate is PER DEVICE: it is compared with the tightest watched
        device's room, never with a summed budget divided by the shard
        count."""
        from ..runtime import inject as _inject

        lie = _inject.value("ledger.predict_fit")
        if lie in ("low", "high"):
            fits = lie == "low"
        elif shards > 1 and self._watched:
            fits = self._fits_per_device(int(estimate_bytes), headroom)
            if fits is None:
                return None
        else:
            fits = self.would_fit(estimate_bytes, headroom=headroom, device=device)
            if fits is None:
                return None
        COUNTERS.inc("ledger_predictions_total")
        COUNTERS.inc("ledger_predict_fit_total" if fits else "ledger_predict_unfit_total")
        if not fits and label:
            COUNTERS.inc(f"ledger_predict_unfit_{label}")
        return fits

    def _fits_per_device(self, per_device_bytes: int, headroom: float) -> Optional[bool]:
        """Would ``per_device_bytes`` fit on the TIGHTEST watched device?
        None when no device reports a limit."""
        with self._lock:
            watched = list(self._watched)
        limited = [r for r in device_memory_stats_per_device(watched) if r.get("limit")]
        if not limited:
            return None
        return per_device_bytes <= min(r["limit"] * headroom - r["in_use"] for r in limited)

    def would_fit(self, estimate_bytes: int, *, headroom: float = DEFAULT_HEADROOM,
                  device=None) -> Optional[bool]:
        """predict_fit's single-device verdict WITHOUT the counters: for
        planning probes (parallel/mesh.py plan_layout) that are no
        launch, so that the predicted-vs-actual counts stay about
        launches that ran."""
        in_use, _peak, limit, _src = device_memory_stats(device)
        if not limit:
            return None
        return in_use + int(estimate_bytes) <= limit * headroom

    # -- reporting ----------------------------------------------------------

    def device_summary(self) -> list:
        """One row ({device, in_use, limit}) a device polled (the
        launches' cards and every watched mesh device), from its last
        poll; none before the first."""
        with self._lock:
            return [dict(r) for r in self._rows.values()]

    def reset(self) -> None:
        with self._lock:
            self.peak_bytes = 0
            self.samples = 0
            self.source = "unpolled"
            self.device = None
            self.limit = None
            self._last_in_use = 0
            self._watched.clear()
            self._rows.clear()
            self._frames.clear()
            self.watermarks.clear()

    def summary(self, top: int = 8) -> dict:
        """The ``ledger`` block of trace artifacts."""
        rows = self.device_summary()
        with self._lock:
            marks = sorted(self.watermarks.items(), key=lambda kv: -kv[1])[:top]
            out = {
                "peak_bytes": self.peak_bytes,
                "samples": self.samples,
                "source": self.source,
                "watermarks": dict(marks),
                "per_device": rows,
            }
        out["predictions"] = {
            "total": COUNTERS.get("ledger_predictions_total"),
            "fit": COUNTERS.get("ledger_predict_fit_total"),
            "unfit": COUNTERS.get("ledger_predict_unfit_total"),
            "miss": COUNTERS.get("ledger_predict_miss_total"),
            "hit": COUNTERS.get("ledger_predict_hit_total"),
        }
        return out


LEDGER = MemoryLedger()


def _span_boundary(event: str, name: str, token=None):
    """obs.spans boundary hook: top-level spans open and close ledger
    watermark frames (installed by obs/profile.py at import)."""
    if event == "open":
        return LEDGER.span_open(name)
    LEDGER.span_close(token)
    return None
