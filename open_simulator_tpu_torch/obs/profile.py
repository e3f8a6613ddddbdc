"""Instrumented launches: launch counters, device-time histograms, cost
records, memory polls and the fault-injection seam at every launch of
the port's device work.

The port's counterpart of the JAX package's ``InstrumentedJit``
(obs/profile.py there). JAX wraps its jitted entry points; the port
wraps the three places that start device work:

- ``fused_scan.run_fused_scan`` / ``run_fused_scan_batch`` (the
  fused-scan kernels, ops/fused_scan.py; on a CPU plan their plain
  versions);
- ``stream_bench.run_stream`` (the streaming-bandwidth probe);
- ``scan.run_scan_masked`` (the eager torch scan's dispatch).

Each runs inside ``launch(site, device)``, which

- fires the injection seam ``jit.<site>`` (runtime/inject.py) before the
  launch, so ``--inject 'jit.sweep_many=oom@1'`` raises where the launch
  would have run;
- counts the launch: ``launches_total`` and ``launches_<site>``, and
  ``device_launches_total`` for one on the card (a launch the seam
  stopped is not counted, so on the card the count equals the kernels'
  own ``LAUNCHES``);
- records the launch's DEVICE time by two CUDA events into the
  ``launch/<site>`` histogram (obs/histo.py). A host clock around an
  asynchronous launch would measure the enqueue, not the kernel; the
  events are read once the caller has synchronised (it reads its
  placements), so they add no synchronisation of their own. On the CPU
  the histogram takes the plain version's host time. The events are
  read on the thread that recorded them (a daemon launches from its
  dispatcher thread and from request-handler threads; each resolves its
  own, after its own sync);
- makes the ``CostRecord`` of a shape on its first launch (obs/costs.py)
  and counts every launch of it;
- polls the memory ledger (obs/ledger.py) after a launch on the card;
- opens a ``launch/<site>`` span when the span recorder is on.

Sites keep the JAX package's names for the launch that does that
site's work, so one ``--inject`` spec drives both packages alike:
``scan`` (a ``simulate()`` batch), ``sweep_probe`` (one capacity
probe), ``sweep_many`` (a batch of capacity probes), ``<site>_sweep``
(the chaos and N+K outage rows, e.g. ``chaos_sweep``), ``defrag_sweep``
(a defrag depth batch), and ``stream_bench``.

The nvcc builds of utils/nvcc.py count in place of the JAX package's
recompiles: ``nvcc_builds_total`` and ``nvcc_cache_hits_total``.

``set_profile_dir`` arms ``torch.profiler`` captures of the device
phases only (utils/trace.py ``profiled``: ``engine/scan``,
``sweep/probe``, ``chaos/sweep``, ``defrag/scan``), not the YAML load.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..runtime import inject as _inject
from ..utils.trace import COUNTERS
from . import spans as _spans
from .costs import COSTS
from .histo import HISTOS
from .ledger import LEDGER, _span_boundary

# the ledger's top-level-span watermark frames ride the span recorder's
# boundary hook
_spans.set_boundary_hook(_span_boundary)

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("simon_launch", default=None)
# thread id -> [(site, start event, end event)] of card launches not
# yet read: each thread reads only the events it recorded
_PENDING: dict = {}
_PENDING_LOCK = threading.Lock()


class Launch:
    """One instrumented launch: its site and device, and the CUDA events
    that bracket the kernel on the card."""

    __slots__ = ("site", "device", "_start", "timed")

    def __init__(self, site: str, device):
        self.site = site
        self.device = device
        self._start = None
        self.timed = False

    def start(self) -> None:
        """Record the start event on the current stream, right before
        the kernel is enqueued (a no-op off the card)."""
        if self.device.type != "cuda":
            return
        import torch

        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record()

    def stop(self) -> None:
        """Record the end event after the kernel; its time is read once
        the caller has synchronised."""
        if self._start is None:
            return
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record()
        with _PENDING_LOCK:
            _PENDING.setdefault(threading.get_ident(), []).append(
                (self.site, self._start, end))
        self._start = None
        self.timed = True

    def cost(self, key: tuple, make_record) -> None:
        """Count this launch under its shape's cost record, made by
        `make_record()` on the shape's first launch."""
        if not COSTS.has(self.site, key):
            COSTS.record(self.site, key, make_record())
        COSTS.on_launch(self.site, key)


def current() -> Optional[Launch]:
    """The launch the calling code runs inside, or None."""
    return _CURRENT.get()


def resolve_pending(wait: bool = False) -> int:
    """Move the device times of the calling thread's finished card
    launches into their histograms; with `wait`, wait for each of them
    first. Returns how many were read."""
    me = threading.get_ident()
    with _PENDING_LOCK:
        pending = _PENDING.pop(me, [])
    done, keep = [], []
    for site, start, end in pending:
        if wait:
            end.synchronize()
        (done if end.query() else keep).append((site, start, end))
    if keep:
        with _PENDING_LOCK:
            _PENDING[me] = keep + _PENDING.get(me, [])
    for site, start, end in done:
        HISTOS.observe(f"launch/{site}", start.elapsed_time(end) / 1e3)
    return len(done)


@contextmanager
def launch(site: str, device):
    """Instrument one launch of device work at `site` on `device` (a
    torch.device): see the module docstring."""
    # the seam first: a launch a fault stops never ran, and is not counted
    _inject.fire(f"jit.{site}")
    COUNTERS.inc("launches_total")
    COUNTERS.inc(f"launches_{site}")
    on_card = device.type == "cuda"
    if on_card:
        COUNTERS.inc("device_launches_total")
    if on_card:
        resolve_pending()
    ln = Launch(site, device)
    token = _CURRENT.set(ln)
    span_cm = (_spans.RECORDER.span(f"launch/{site}", site=site, device=device.type)
               if _spans.RECORDER.enabled else None)
    if span_cm is not None:
        span_cm.__enter__()
    t0 = time.perf_counter()
    try:
        yield ln
    finally:
        _CURRENT.reset(token)
        if not ln.timed:
            HISTOS.observe(f"launch/{site}", time.perf_counter() - t0)
        if span_cm is not None:
            span_cm.__exit__(None, None, None)
        if on_card:
            LEDGER.poll(device)


# ------------------------------------------------------ transfer gauges


def record_d2h(nbytes: int) -> None:
    """Bytes read back from the card (placements and final rows)."""
    COUNTERS.inc("device_transfer_d2h_bytes_total", int(nbytes))


def to_host(t):
    """`t` (a tensor) as a numpy array, counting the bytes read back
    when it lies on the card."""
    if t.device.type == "cuda":
        record_d2h(t.numel() * t.element_size())
    return t.cpu().numpy()


def record_h2d(nbytes: int) -> None:
    """Bytes sent to the card (a launch's masks and pins)."""
    COUNTERS.inc("device_transfer_h2d_bytes_total", int(nbytes))


# ------------------------------------------------------ profiler capture


def set_profile_dir(path: Optional[str]) -> None:
    """Arm (or disarm with None) the ``torch.profiler`` capture of the
    device phases (utils/trace.py ``profiled``): one Chrome trace a
    phase run, ``<path>/<phase>-<n>.json``."""
    if path:
        os.makedirs(path, exist_ok=True)
        os.environ["SIMON_PROFILE_DIR"] = path
    else:
        os.environ.pop("SIMON_PROFILE_DIR", None)


# ------------------------------------------------------ snapshot helpers


_KEYS = (
    "launches_total",
    "device_launches_total",
    "nvcc_builds_total",
    "nvcc_cache_hits_total",
    "device_transfer_d2h_bytes_total",
    "device_transfer_h2d_bytes_total",
)


def snapshot() -> dict:
    """Current values of the headline launch counters."""
    return {k: COUNTERS.get(k) for k in _KEYS}


def delta(since: dict) -> dict:
    """Counter movement since a previous ``snapshot()``."""
    now = snapshot()
    return {k: now[k] - since.get(k, 0) for k in _KEYS}
