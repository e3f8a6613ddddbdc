"""Micro-batching request coalescer — the serving core of `simon serve`.

The shape is continuous batching from inference serving, applied to
what-if scheduling: HTTP handler threads only parse and enqueue; ONE
dispatcher thread drains up to ``max_batch`` queued requests per tick
and answers all of them with a single launch of the batch kernel
(serve/session.evaluate_batch), so B concurrent requests cost
``ceil(B / max_batch)`` launches instead of B — the counters at
``/metrics`` prove it (tests/test_torch_serve.py asserts the bound).
The port's copy of the JAX package's serve/coalescer.py.

Backpressure contract (docs/SERVING.md):

- the queue is BOUNDED (``queue_depth``): a submit against a full
  queue is rejected immediately — the HTTP layer turns that into
  503 + Retry-After, the shed counter increments, and the daemon's
  latency distribution stays honest instead of growing an unbounded
  tail (the same load-shedding posture as runtime/retry's circuit
  breakers: fail fast, recover fast)
- every request carries a ``Budget`` (runtime/budget.py): a request
  whose deadline expired while it sat in the queue is SHED at pickup
  with a machine-readable PARTIAL body — device time is never spent on
  an answer nobody is waiting for. Once dispatched, a request runs to
  completion (the scan has no per-request halt boundary).
- SIGTERM drains: ``close()`` stops intake (submits reject as
  draining), the dispatcher finishes every queued request, then the
  thread exits. ``drain(timeout)`` bounds the wait; leftovers past the
  timeout are shed with the drain body.

Single-dispatcher concurrency contract: all expansion, encode, scan,
and replay run on the dispatcher thread — the warm identity caches are
effectively single-threaded (docs/PERFORMANCE.md "warm-cache
concurrency contract"); handler threads touch only the queue, the
counters, and their own parsed request.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

from ..obs.histo import HISTOS
from ..runtime import inject as _inject
from ..runtime.budget import Budget
from ..utils.trace import COUNTERS
from .session import Session, WhatIfReply, WhatIfRequest

log = logging.getLogger(__name__)

# dispatcher-death watchdog poll interval: cheap enough to always run,
# fast enough that a died dispatcher answers its casualties typed well
# before any client's deadline
WATCHDOG_INTERVAL_S = 0.25


def partial_body(
    reason: str, message: str, request_id: Optional[str] = None
) -> bytes:
    """Machine-readable shed body — the HTTP analogue of the CLI's
    PARTIAL report (cli._emit_partial): same `partial`/`reason` keys,
    so one client-side parser reads both surfaces. ``request_id``
    (when the request got far enough to have one) rides along so a
    caller-supplied correlation ID survives the shed path verbatim."""
    doc = {"partial": True, "reason": reason, "message": message}
    if request_id:
        doc["requestId"] = request_id
    return json.dumps(doc).encode()


@dataclass
class PendingRequest:
    """One enqueued question plus its rendezvous with the handler
    thread (`done` fires when `reply` is set). ``route`` is the
    admission verdict: "batch" rides the coalesced scan, "serial"
    was routed to a standalone simulate() (predicted device memory /
    oversize — serve/admission.py). ``tenant`` attributes the request's
    counters."""

    request: WhatIfRequest
    budget: Budget
    route: str = "batch"
    tenant: str = "default"
    route_reason: str = ""
    # correlation ID (X-Simon-Request-Id or minted — obs/telemetry.py):
    # echoed in reply headers/shed bodies, stamped on the request's
    # span subtree, distinct per member of a coalesced batch
    request_id: str = ""
    # cross-process trace context (X-Simon-Trace-Context): the fleet
    # router's forward-span id + hop count. Span ids are process-local,
    # so the remote parent rides the serve/request root as an ATTR
    # (fleet/trace.py stitches the two id spaces into one tree)
    trace_parent: Optional[int] = None
    trace_hop: int = 0
    enqueued_at: float = field(default_factory=time.monotonic)
    # perf_counter twin of enqueued_at: synthesized per-request spans
    # (queue_wait/evaluate) must live in the recorder's clock domain
    enqueued_perf: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event)
    reply: Optional[WhatIfReply] = None

    def finish(self, reply: WhatIfReply):
        self.reply = reply
        self.done.set()


class Coalescer:
    def __init__(
        self,
        session: Session,
        max_batch: int = 16,
        queue_depth: int = 64,
        on_tick=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.session = session
        self.max_batch = max_batch
        self.queue_depth = queue_depth
        self.on_tick = on_tick  # daemon hook (session-cache pressure check)
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._wakeup = threading.Event()
        self._closing = False
        self._drained = threading.Event()
        # requests popped from the queue but not yet answered: if the
        # dispatcher thread DIES mid-batch, the watchdog fails exactly
        # these typed instead of leaving their handlers waiting forever
        self._inflight_batch: List[PendingRequest] = []
        # tests set this to hold the dispatcher between ticks, so a
        # burst enqueued while held provably coalesces into one tick
        self.hold: Optional[threading.Event] = None
        # dispatcher-thread management is its own lock: the watchdog
        # swaps the thread while handler threads keep using _lock for
        # the queue (consistent order: _restart_lock before _lock)
        self._restart_lock = threading.Lock()
        self._thread = self._new_dispatcher()
        self._watchdog_thread = threading.Thread(
            target=self._watch, name="simon-serve-watchdog", daemon=True
        )
        self.restarts = 0

    def _new_dispatcher(self) -> threading.Thread:
        return threading.Thread(
            target=self._run, name="simon-serve-dispatcher", daemon=True
        )

    def start(self):
        with self._restart_lock:
            self._thread.start()
        self._watchdog_thread.start()

    # -- dispatcher watchdog ------------------------------------------------

    def _watch(self):
        """Monitor loop: as long as the coalescer is live, a died
        dispatcher thread is restarted and its in-flight requests are
        failed typed (docs/SERVING.md). Exits once the drain
        completes."""
        while not self._drained.wait(timeout=WATCHDOG_INTERVAL_S):
            self.ensure_dispatcher()

    def ensure_dispatcher(self) -> bool:
        """Restart a died dispatcher; returns True when a restart
        happened. The died thread's picked-but-unanswered requests are
        answered 500 with a typed body — a dead dispatcher must fail
        loudly, never wedge the queue behind handler threads waiting
        on replies that will never come."""
        with self._restart_lock:
            t = self._thread
            if t.is_alive() or not t.ident or self._drained.is_set():
                return False
            with self._lock:
                casualties = self._inflight_batch
                self._inflight_batch = []
            self.restarts += 1
            fresh = self._new_dispatcher()
            self._thread = fresh
        COUNTERS.inc("serve_watchdog_restarts_total")
        log.error(
            "serve dispatcher thread died; restarting (restart #%d, "
            "%d in-flight request(s) failed typed)",
            self.restarts, len(casualties),
        )
        for p in casualties:
            COUNTERS.inc("serve_dispatcher_casualties_total")
            self._finish_counted(
                p,
                WhatIfReply(
                    status=500,
                    body=json.dumps(
                        {
                            "error": "dispatcher thread died while this "
                            "request was being evaluated; the watchdog "
                            "restarted it",
                            "errorType": "ConformanceError",
                        }
                    ).encode(),
                    meta={"engine": "watchdog"},
                ),
            )
        fresh.start()
        self._wakeup.set()
        return True

    # -- intake (handler threads) -------------------------------------------

    def submit(self, req: PendingRequest) -> bool:
        """Enqueue; False = rejected (queue full or draining). The
        caller owns the 503 rendering."""
        with self._lock:
            if self._closing or len(self._queue) >= self.queue_depth:
                COUNTERS.inc("serve_shed_total")
                COUNTERS.inc(
                    "serve_shed_draining_total"
                    if self._closing
                    else "serve_shed_overload_total"
                )
                return False
            self._queue.append(req)
            COUNTERS.gauge("serve_queue_depth", len(self._queue))
        self._wakeup.set()
        return True

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def retry_after_s(self) -> int:
        """Overload hint: how long until the backlog plausibly clears,
        from the observed per-tick latency (>= 1s so clients never busy
        spin)."""
        tick_s = COUNTERS.mean("serve_tick_seconds") or 1.0
        ticks = max(1, -(-self.depth // self.max_batch))
        return max(1, int(round(ticks * tick_s)))

    def _finish_counted(self, pending: PendingRequest, reply: WhatIfReply):
        """Answer one request AND account for it: every answered
        request — simulate result or shed — counts in
        serve_requests_total and the latency window ('Requests
        answered (any status)', serve/server.render_metrics), so the
        exported distribution keeps its worst cases exactly when the
        daemon is shedding."""
        latency = time.monotonic() - pending.enqueued_at
        COUNTERS.observe("serve_latency_seconds", latency)
        # the long-memory histogram complement of the bounded-window
        # observation above: never evicts, exported as Prometheus
        # histogram exposition with p50/p95/p99 (obs/histo.py)
        HISTOS.observe("serve/request", latency)
        COUNTERS.mark("serve_completions")
        COUNTERS.inc("serve_requests_total")
        pending.finish(reply)

    # -- dispatch (the one dispatcher thread) -------------------------------

    def _drain_tick(self) -> List[PendingRequest]:
        """Take up to max_batch requests, shedding any whose deadline
        already expired in the queue (503 PARTIAL, no device time)."""
        picked: List[PendingRequest] = []
        while len(picked) < self.max_batch:
            with self._lock:
                if not self._queue:
                    break
                req = self._queue.popleft()
                COUNTERS.gauge("serve_queue_depth", len(self._queue))
            if req.budget.expired() or req.budget.interrupted:
                COUNTERS.inc("serve_shed_total")
                COUNTERS.inc("serve_shed_deadline_total")
                self._record_request_spans(req, evaluated=False)
                self._finish_counted(
                    req,
                    WhatIfReply(
                        status=503,
                        body=partial_body(
                            "deadline",
                            f"deadline of {req.budget.deadline_s:g}s expired "
                            f"after {req.budget.elapsed():.2f}s in the queue",
                            request_id=req.request_id,
                        ),
                        meta={"engine": "shed-deadline"},
                    ),
                )
                continue
            picked.append(req)
        return picked

    def _run(self):
        while True:
            if self.hold is not None:
                self.hold.wait()
            self._wakeup.wait(timeout=0.05)
            self._wakeup.clear()
            # chaos seam: `serve.tick` faults land HERE, on the
            # dispatcher thread — a `crash` clause kills the thread
            # (InjectedCrash is a BaseException) and the watchdog must
            # restart it; Exception-shaped faults ride the per-batch
            # recovery below once a batch is in flight
            _inject.fire("serve.tick")
            batch = self._drain_tick()
            if not batch:
                with self._lock:
                    if self._closing and not self._queue:
                        break
                continue
            with self._lock:
                self._inflight_batch = list(batch)
            # NO finally here: if _evaluate_tick dies (a crash-shaped
            # BaseException, or a bug in the reply bookkeeping), the
            # batch must STAY in _inflight_batch so the watchdog can
            # fail exactly these requests typed — clearing it on the
            # way down would strand their handlers waiting forever
            self._evaluate_tick(batch)
            with self._lock:
                self._inflight_batch = []
            if self.on_tick is not None:
                try:
                    self.on_tick()
                except Exception:  # noqa: BLE001 - a failing pressure hook must not kill the dispatcher
                    log.exception("serve on_tick hook failed")
        self._drained.set()

    def _evaluate_tick(self, batch: List[PendingRequest]):
        """Answer one tick's worth of picked requests: admission-
        routed serial requests individually through the host oracle,
        everything else in ONE coalesced device dispatch. Under the
        flight recorder, the tick is one ``serve/batch`` span LINKING
        every member's request ID, and each member gets its own
        synthesized span subtree (queue_wait / evaluate) stamped with
        its ID — N requests, N traceable subtrees, zero extra device
        work."""
        from ..obs.spans import RECORDER

        t0 = time.monotonic()
        t0_perf = time.perf_counter()
        COUNTERS.observe("serve_batch_fill", len(batch))
        COUNTERS.inc("serve_batches_total")
        for p in batch:
            HISTOS.observe("serve/queue_wait", t0 - p.enqueued_at)
        scan = [p for p in batch if p.route != "serial"]
        serial = [p for p in batch if p.route == "serial"]
        with RECORDER.span(
            "serve/batch",
            requests=len(batch),
            request_ids=[p.request_id for p in batch if p.request_id],
        ) as batch_span:
            replies: List[WhatIfReply] = []
            if scan:
                try:
                    replies = self.session.evaluate_batch(
                        [p.request for p in scan]
                    )
                except Exception as e:  # noqa: BLE001 - the daemon must outlive any one batch
                    # a failed batch answers its waiters (500) and the
                    # dispatcher keeps serving; an unhandled raise here
                    # would strand every queued request forever
                    COUNTERS.inc("serve_batch_errors_total")
                    replies = [
                        self._error_reply(e, p.request_id) for p in scan
                    ]
            serial_replies: List[WhatIfReply] = []
            for p in serial:
                try:
                    serial_replies.append(
                        self.session.evaluate_serial(
                            p.request, reason=p.route_reason or "admission"
                        )
                    )
                except Exception as e:  # noqa: BLE001 - ditto: one bad serial request must not strand the rest
                    COUNTERS.inc("serve_batch_errors_total")
                    serial_replies.append(
                        self._error_reply(e, p.request_id)
                    )
        tick_s = time.monotonic() - t0
        t1_perf = time.perf_counter()
        COUNTERS.observe("serve_tick_seconds", tick_s)
        HISTOS.observe("serve/evaluate", tick_s)
        for pending, reply in list(zip(scan, replies)) + list(
            zip(serial, serial_replies)
        ):
            reply.meta.setdefault("batchSize", len(batch))
            reply.meta["queueSeconds"] = round(t0 - pending.enqueued_at, 6)
            self._record_request_spans(
                pending,
                evaluated=True,
                t0_perf=t0_perf,
                t1_perf=t1_perf,
                batch_span=batch_span,
                engine=str(reply.meta.get("engine", "")),
            )
            self._finish_counted(pending, reply)

    @staticmethod
    def _record_request_spans(
        pending: PendingRequest,
        evaluated: bool,
        t0_perf: Optional[float] = None,
        t1_perf: Optional[float] = None,
        batch_span=None,
        engine: str = "",
    ):
        """Synthesize one request's span subtree from timings the
        dispatcher already measured: a ``serve/request`` root spanning
        enqueue -> answer, with ``queue_wait`` and (when the request
        was evaluated rather than shed) ``evaluate`` children — each
        stamped with the request's own ID, the batch span linked on
        the root. Host-side bookkeeping only: correlation costs zero
        jit-cache misses by construction (CI-gated)."""
        from ..obs.spans import RECORDER

        if not RECORDER.enabled:
            return
        now_perf = time.perf_counter()
        attrs = {"request_id": pending.request_id or None}
        if batch_span is not None:
            attrs["batch_span"] = batch_span
        if engine:
            attrs["engine"] = engine
        if pending.trace_parent is not None:
            attrs["remote_parent"] = pending.trace_parent
            attrs["fleet_hop"] = pending.trace_hop
        if not evaluated:
            attrs["shed"] = True
        root = RECORDER.record_span(
            "serve/request", pending.enqueued_perf, now_perf, **attrs
        )
        if root is None:
            return
        wait_end = t0_perf if evaluated and t0_perf is not None else now_perf
        RECORDER.record_span(
            "serve/request/queue_wait",
            pending.enqueued_perf,
            wait_end,
            parent_id=root,
            request_id=pending.request_id or None,
        )
        if evaluated and t0_perf is not None and t1_perf is not None:
            RECORDER.record_span(
                "serve/request/evaluate",
                t0_perf,
                t1_perf,
                parent_id=root,
                request_id=pending.request_id or None,
            )

    @staticmethod
    def _error_reply(e: Exception, request_id: str = "") -> WhatIfReply:
        """Typed 500 body: the taxonomy class name rides along so a
        client (and the chaos matrix) can route on the failure kind
        without parsing message text."""
        doc = {
            "error": f"evaluation failed: {e}",
            "errorType": type(e).__name__,
        }
        if request_id:
            doc["requestId"] = request_id
        return WhatIfReply(
            status=500,
            body=json.dumps(doc).encode(),
            meta={"engine": "error"},
        )

    # -- shutdown -----------------------------------------------------------

    def close(self):
        """Stop intake; the dispatcher exits once the queue is empty."""
        with self._lock:
            self._closing = True
        self._wakeup.set()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued request is answered (True) or the
        timeout passes (False — leftovers are shed with the drain
        body so no handler thread waits forever)."""
        self.close()
        ok = self._drained.wait(timeout=timeout)
        if not ok:
            while True:
                with self._lock:
                    if not self._queue:
                        break
                    req = self._queue.popleft()
                COUNTERS.inc("serve_shed_total")
                COUNTERS.inc("serve_shed_draining_total")
                self._finish_counted(
                    req,
                    WhatIfReply(
                        status=503,
                        body=partial_body(
                            "drain",
                            "daemon shutting down before this request "
                            "could be evaluated",
                            request_id=req.request_id,
                        ),
                        meta={"engine": "shed-drain"},
                    ),
                )
        return ok
