"""Cost-predictive admission control for `simon serve`.

The bounded queue (serve/coalescer.py) sheds on DEPTH — it reacts
after the backlog exists. This module sheds on PREDICTED COST before
a request ever occupies a queue slot, using the observability the
observatory already exports. The port's copy of the JAX package's
serve/admission.py:

- **Predicted device memory** (obs/costs.py + obs/ledger.py): would
  one more full coalesced tick of the batch kernel fit in device
  memory next to what is live right now? When the workspace the cost
  records count for such a launch says no, the request is SERIALLY
  ROUTED — a standalone ``simulate()`` on the session's device answers
  it, one pod batch of one scenario (byte-identical body,
  ``X-Simon-Engine: serial``), and the doomed batch launch never
  runs. Memory pressure degrades throughput before availability.
- **Predicted latency** (obs/histo.py): the p95 of the coalescer's
  evaluate phase times the ticks already queued ahead is the wait
  this request would see. Past ``--tick-budget`` the request is SHED
  with **429 Too Many Requests** and a ``Retry-After`` derived from
  the same prediction — the client-visible half of the contract:
  429 = "you would not get an answer in time, come back in N",
  503 = "the queue itself is full / draining" (docs/SERVING.md).
- **Oversize requests** (``--max-request-pods``): a request whose
  estimated pod count exceeds the bound routes serial — one giant
  request must not hold the batch launch up for everyone else.

Per-tenant accounting: every verdict counts under the request's
tenant (``X-Simon-Tenant`` header or the JSON envelope's ``tenant``
key), exported as ``simon_serve_tenant_requests_total{tenant=...}`` /
``..._shed_total{tenant=...}`` so a noisy neighbor is visible in one
/metrics scrape.

With no tick budget configured and no device-memory budget known,
every verdict is ``admit`` — admission control costs nothing until
the signals it needs exist (conformance tests run in that mode).
"""

from __future__ import annotations

import math
import re
import threading
from dataclasses import dataclass
from typing import Optional

from ..utils.trace import COUNTERS

_TENANT_RE = re.compile(r"[^A-Za-z0-9_.-]")
DEFAULT_TENANT = "default"

#: distinct tenant labels a daemon will ever mint; the client-supplied
#: header must not grow counters/exposition without bound for the life
#: of the process, so tenant N+1.. all collapse into one bucket
MAX_TENANTS = 64
OVERFLOW_TENANT = "overflow"
_seen_tenants: set = set()
_tenants_lock = threading.Lock()

#: the launch site whose cost records price a coalesced tick
SCAN_SITE = "scenario_scan"


def sanitize_tenant(raw: Optional[str]) -> str:
    """Counter/label-safe tenant name (bounded in charset, length AND
    cardinality: a tenant header must not be able to mint unbounded
    metric keys, nor smuggle quotes into exposition). Once
    ``MAX_TENANTS`` distinct names exist, further new names share the
    ``overflow`` bucket — known tenants keep their own series."""
    if not raw:
        return DEFAULT_TENANT
    name = _TENANT_RE.sub("_", str(raw))[:64] or DEFAULT_TENANT
    with _tenants_lock:
        if name in _seen_tenants:
            return name
        if len(_seen_tenants) >= MAX_TENANTS:
            return OVERFLOW_TENANT
        _seen_tenants.add(name)
    return name


def reset_tenant_registry():
    """Forget seen tenants (tests: the registry is process-global)."""
    with _tenants_lock:
        _seen_tenants.clear()


@dataclass
class Verdict:
    """One admission decision. ``action``: admit | serial | shed."""

    action: str
    reason: str = ""
    retry_after_s: int = 1

    @property
    def admitted(self) -> bool:
        return self.action != "shed"


class AdmissionController:
    """Stateless policy over the process-wide observability registries
    (cost registry, memory ledger, latency histograms) — all state it
    reads is already maintained by the instrumented dispatch path."""

    def __init__(
        self,
        max_batch: int,
        tick_budget_s: Optional[float] = None,
        max_request_pods: Optional[int] = None,
    ):
        self.max_batch = max(1, int(max_batch))
        self.tick_budget_s = tick_budget_s
        self.max_request_pods = max_request_pods

    # -- the three signals --------------------------------------------------

    def _predicted_tick_s(self) -> float:
        """p95 of the coalescer's evaluate phase; 0.0 until observed."""
        from ..obs.histo import HISTOS

        h = HISTOS.peek("serve/evaluate")
        if h is None:
            return 0.0
        return float(h.percentile(95.0))

    def _device_mem_fits(self) -> Optional[bool]:
        """Ledger verdict for one more full-batch launch of the scan
        site; None until the site has a plan or no budget is known."""
        from ..obs.costs import COSTS
        from ..obs.ledger import LEDGER

        est = COSTS.estimate_bytes(SCAN_SITE, self.max_batch)
        if est is None:
            return None
        return LEDGER.predict_fit(int(est), label="serve_admission")

    # -- policy -------------------------------------------------------------

    def decide(self, *, est_pods: int, queue_depth: int) -> Verdict:
        """One verdict per incoming request, BEFORE it takes a queue
        slot. Order: oversize (cheapest, request-local), predicted
        device memory (degrades to serial), predicted latency (sheds).
        Tenant-blind by design: per-tenant accounting lives with the
        caller (do_POST), and tenancy never changes an answer."""
        COUNTERS.inc("serve_admission_total")
        if (
            self.max_request_pods is not None
            and est_pods > self.max_request_pods
        ):
            COUNTERS.inc("serve_admission_serial_total")
            return Verdict(
                "serial",
                f"estimated {est_pods} pods exceeds "
                f"--max-request-pods {self.max_request_pods}",
            )
        if self._device_mem_fits() is False:
            COUNTERS.inc("serve_admission_serial_total")
            return Verdict(
                "serial",
                "memory ledger predicts a full coalesced tick will not "
                "fit in device memory; routing to a standalone simulate()",
            )
        if self.tick_budget_s:
            tick_s = self._predicted_tick_s()
            if tick_s > 0.0:
                ticks_ahead = queue_depth // self.max_batch + 1
                predicted_wait = tick_s * ticks_ahead
                if predicted_wait > self.tick_budget_s:
                    COUNTERS.inc("serve_admission_shed_total")
                    return Verdict(
                        "shed",
                        f"predicted wait {predicted_wait:.3f}s "
                        f"(p95 tick {tick_s:.3f}s x {ticks_ahead} "
                        f"tick(s) queued) exceeds --tick-budget "
                        f"{self.tick_budget_s:g}s",
                        retry_after_s=max(1, math.ceil(predicted_wait)),
                    )
        return Verdict("admit")

    def retry_after_hint(self, queue_depth: int = 0) -> int:
        """The backoff hint a degraded /healthz advertises, derived
        from the SAME latency prediction as the 429 shed path (p95
        coalescer tick x ticks queued ahead, floored at one second) —
        probers and load balancers back off uniformly with shed
        clients instead of hot-looping a degraded replica."""
        tick_s = self._predicted_tick_s()
        ticks_ahead = queue_depth // self.max_batch + 1
        return max(1, math.ceil(tick_s * ticks_ahead))


def estimate_request_pods(req) -> int:
    """Cheap pre-expansion pod-count estimate of a WhatIfRequest:
    workload replicas are declared in the spec, so the estimate reads
    them without paying generate_valid_pods_from_app (which runs on
    the dispatcher thread, after admission)."""
    total = 0
    for app in req.apps:
        res = app.resource
        total += len(getattr(res, "pods", ()) or ())
        for field in (
            "deployments",
            "stateful_sets",
            "replica_sets",
            "replication_controllers",
            "jobs",
            "cron_jobs",
        ):
            for obj in getattr(res, field, ()) or ():
                spec = obj.get("spec") or {}
                replicas = spec.get("replicas")
                if replicas is None:
                    replicas = spec.get("parallelism", 1)
                try:
                    total += max(1, int(replicas))
                except (TypeError, ValueError):
                    total += 1
        for ds in getattr(res, "daemon_sets", ()) or ():
            total += 1  # per-node expansion is cluster-sized; count one
    return total
