"""Warm what-if session: one loaded cluster, many simulate questions.

The port's copy of the JAX package's serve/session.py, on the card.

The one-shot CLI pays process startup, cluster build, encode, and the
kernel library's load for every question. A ``Session`` loads the
cluster ONCE and keeps everything derivable from it warm across
requests:

- the ``Oracle`` over the cluster nodes (never mutated — replay happens
  on per-request oracles), whose ``ClusterStatic`` encoding is cached
  inside the shared ``TorchEngine``
- the expanded cluster pods and the generated-name counter state after
  their expansion, replayed before every request's app expansion so a
  coalesced request mints exactly the pod names a standalone
  ``simulate()`` would (models/workloads.name_counter_state)
- the kernel library, built by nvcc once per checkout and loaded once
  per process (``warm()`` is where that happens)

``evaluate_batch`` answers B requests with ONE launch of the batch
kernel (B6, ``TorchEngine.scan_scenarios`` at the site
``scenario_scan``): each request becomes one scenario row of a batched
masked scan — the same
per-scenario pod-activity masking the capacity sweep and the chaos
engine use (parallel/sweep.py) — and each row's placements replay into
a fresh per-request oracle for the report. Responses are byte-identical
to a standalone ``simulate()`` of the same request (conformance-gated,
tests/test_serve.py); requests the batched scan cannot model (priority
/ preemption semantics, per-pod host callbacks) fall back to a real
``simulate()`` call inside the dispatcher, so the answer is identical
either way — only the latency differs.

The session is keyed by a fingerprint of the loaded cluster
(runtime/journal.config_fingerprint), reported at ``/healthz`` so
clients can detect a daemon serving stale state after a config change.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..models import workloads as wl
from ..models.decode import ResourceTypes
from ..runtime.journal import config_fingerprint
from ..scheduler.core import (
    AppResource,
    NodeStatus,
    SimulateResult,
    UnscheduledPod,
    _sort_app_pods,
    simulate,
)
from ..scheduler.oracle import Oracle
from ..utils.trace import COUNTERS

# pod absent from a scenario — must match the scan sentinel
# (parallel/sweep.py asserts the same identity against ops.scan)
INACTIVE = -2


@dataclass
class WhatIfRequest:
    """One decoded /v1/simulate question: apps in deployment order.
    ``tenant`` is the accounting identity (JSON envelope ``tenant``
    key / X-Simon-Tenant header) — it never changes the answer, only
    whose counters the request lands in (serve/admission.py)."""

    apps: List[AppResource]
    tenant: str = "default"


@dataclass
class WhatIfReply:
    """The evaluated answer. `body` is the canonical response bytes
    (byte-identical across the coalesced and serial paths); `meta` is
    per-request diagnostics exported as HTTP headers, NEVER mixed into
    the body (a batch-dependent body would break the conformance
    contract)."""

    status: int
    body: bytes
    meta: dict = field(default_factory=dict)


def result_payload(result: SimulateResult) -> bytes:
    """Canonical response body of one simulate answer. Key-sorted,
    separator-normalized JSON: the bytes are a pure function of the
    placements and reasons, so coalesced and standalone evaluations of
    the same request compare equal byte-for-byte."""
    out = {
        "success": not result.unscheduled_pods,
        "unscheduledPods": [
            {
                "namespace": (up.pod.get("metadata") or {}).get("namespace"),
                "name": (up.pod.get("metadata") or {}).get("name"),
                "reason": up.reason,
            }
            for up in result.unscheduled_pods
        ],
        "nodes": [
            {
                "name": (ns.node.get("metadata") or {}).get("name"),
                "pods": [
                    {
                        "namespace": (p.get("metadata") or {}).get("namespace"),
                        "name": (p.get("metadata") or {}).get("name"),
                        "app": ((p.get("metadata") or {}).get("labels") or {}).get(
                            "simon/app-name"
                        ),
                    }
                    for p in ns.pods
                ],
            }
            for ns in result.node_status
        ],
    }
    return json.dumps(out, sort_keys=True, separators=(",", ":")).encode()


# Shallow-clone of a pod's mutation surface (bind writes spec.nodeName
# / status.phase / metadata.annotations) so replaying a scenario never
# pollutes the shared cluster pods or a request's expansion — the next
# batch re-encodes those dicts and a stale nodeName would read as a
# pin. ONE definition, shared with the committed-scan machinery: the
# mutation surface must never diverge between the two replay paths.
from ..incremental.resim import own_pod as _own_pod  # noqa: E402


class Session:
    """One warm cluster + the machinery to answer request batches.

    With ``incremental`` (the default; ``--no-incremental`` disables),
    the session keeps its cluster pods COMMITTED in a resident oracle
    (incremental/resim.CommittedScan): each what-if tick then scans
    ONLY the request pods (the suffix) against that warm state instead
    of re-scanning the whole roster per scenario row, and a
    ``/v1/cluster-delta`` re-simulates only the journal suffix the
    conservative dependency rule says could change. Bodies stay
    byte-identical to the full path (conformance-gated); ineligible
    clusters (priority, plugins) and a device OOM degrade to the
    full path, counted and trace-noted.

    ``device`` is where every scan of the session runs: the card unless
    the caller names another (``fused_scan.resolve_device``). The
    degrade rule is the port's (runtime/guard.py): only a device OOM
    degrades — the committed build or a re-simulation falls back to the
    full per-tick scan, still on the card, and a tick's chunk halves; a
    single row that still runs out raises (a 5xx body) and reaches the
    serial oracle only in a ``device="cpu"`` session. A build or launch
    error propagates."""

    def __init__(self, cluster: ResourceTypes, incremental: bool = True,
                 device=None):
        import threading

        from ..ops.fused_scan import resolve_device
        from ..scheduler.engine import TorchEngine
        from ..scheduler.preemption import build_priority_resolver, pod_uses_priority
        from ..utils.trace import phase

        self.cluster = cluster
        self.incremental = bool(incremental)
        self.device = resolve_device(device)
        self._committed = None  # CommittedScan, built lazily
        self._committed_broken = False  # classified build fault: stay full
        self.fingerprint = config_fingerprint(
            {k: getattr(cluster, k) for k in sorted(vars(cluster))}
        )
        # delta application (apply_delta) vs the dispatcher's ticks:
        # one reentrant lock serializes roster/oracle mutation against
        # batch evaluation (the dispatcher is single-threaded, but
        # /v1/cluster-delta arrives on handler threads). A _reload()
        # re-runs this constructor while HOLDING the lock — it must
        # never be rebound mid-rebuild, or a concurrent thread would
        # acquire a fresh unheld lock and see a half-built session
        if getattr(self, "_delta_lock", None) is None:
            self._delta_lock = threading.RLock()
        self.delta_seq = 0
        self.delta_reloads = 0
        with phase("serve/session-build"):
            wl.reset_name_counter()
            pods: List[dict] = []
            pods.extend(wl.pods_excluding_daemon_sets(cluster))
            # bare cluster pods expand 1:1 and FIRST; delta arrivals
            # insert at the end of that section so warm roster order
            # equals the cold expansion order of the materialized
            # cluster (cluster.pods + deltas, then workloads, then
            # daemonsets)
            self._bare_end = len(cluster.pods)
            for ds in cluster.daemon_sets:
                pods.extend(wl.pods_from_daemon_set(ds, cluster.nodes))
            self.cluster_pods = pods
            # every request's app expansion restarts from this state
            self._counter0 = wl.name_counter_state()
            self.oracle = Oracle(cluster.nodes)
            self.engine = TorchEngine(self.oracle, device=self.device)
            self._resolver = build_priority_resolver(cluster.priority_classes)
            # the batched scan cannot model priority/preemption or
            # per-pod host callbacks; a cluster that carries either
            # routes EVERY request through the serial path. The gate
            # must cover every condition scheduler/core treats as
            # scan-breaking, or batched answers would diverge from
            # simulate(): permit/stateful hooks (needs_serial), a
            # custom queue-sort comparator (reorders pods before the
            # scan would see them), a custom post_filter (acts on ANY
            # failed pod — core routes those through the escape path),
            # and priority-bearing cluster pods
            self.force_serial_reason = ""
            registry = self.oracle.registry
            if registry.needs_serial:
                self.force_serial_reason = "plugin registry needs serial engine"
            elif registry.queue_sort_plugin is not None:
                self.force_serial_reason = "custom queue-sort plugin orders pods"
            elif registry.has_post_filter:
                self.force_serial_reason = "custom post_filter plugin registered"
            elif any(pod_uses_priority(p, self._resolver) for p in pods):
                self.force_serial_reason = "cluster pods carry priority"
            self._pod_uses_priority = pod_uses_priority

    def state_digest(self) -> str:
        """Canonical digest of the delta-mutated session state (node
        set + pod roster) — the fleet dict-identity gate
        (docs/FLEET.md): a journal-replayed replacement replica must
        report the SAME digest as the replica it replaced; equal across
        the two packages on the same roster. Cheap on
        purpose: no committed-scan build, no device work, so
        GET /v1/state-digest is safe to poll."""
        from ..runtime.journal import config_fingerprint

        with self._delta_lock:
            return config_fingerprint(
                [
                    (n.get("metadata") or {}).get("name")
                    for n in self.cluster.nodes
                ],
                self.cluster_pods,
            )

    def warm(self):
        """Build and load the kernel library (nvcc, on a cold checkout),
        build the ClusterStatic encoding and the committed scan, so the
        first real request does not pay the daemon's cold start."""
        warm_app = ResourceTypes()
        warm_app.pods = [
            {
                "kind": "Pod",
                "metadata": {"name": "serve-warm", "namespace": "default"},
                "spec": {
                    "containers": [
                        {
                            "name": "c",
                            "image": "warm",
                            "resources": {
                                "requests": {"cpu": "1m", "memory": "1Mi"}
                            },
                        }
                    ],
                    "schedulerName": "default-scheduler",
                },
            }
        ]
        self.evaluate_batch(
            [WhatIfRequest(apps=[AppResource("serve-warm", warm_app)])]
        )

    # -- expansion ----------------------------------------------------------

    def _expand_request(self, req: WhatIfRequest) -> List[dict]:
        """Expand one request's apps exactly like a standalone run:
        counter re-seated to the post-cluster state, apps in order,
        each app's pods through the affinity/toleration queue sorts
        (the zero-priority ordering of scheduler/core.schedule_app)."""
        wl.set_name_counter(self._counter0)
        pods: List[dict] = []
        for app in req.apps:
            app_pods = wl.generate_valid_pods_from_app(
                app.name, app.resource, self.cluster.nodes
            )
            pods.extend(_sort_app_pods(app_pods))
        return pods

    # -- evaluation ---------------------------------------------------------

    def evaluate_batch(self, reqs: List[WhatIfRequest]) -> List[WhatIfReply]:
        """Answer every request of one coalesced tick: expansion and
        routing per request, then ONE batch-kernel launch for all
        scan-eligible scenarios (chunk-halving on device OOM, the serial
        host-oracle floor on the CPU only — runtime/guard.run_chunked),
        then per
        request a replay into a fresh oracle and the canonical body.

        Under `--trace-out` each tick is one span on the dispatcher
        thread's own tree (`serve/tick`, batch size attached), with the
        expand/encode/scan/replay phases nesting below it."""
        from ..obs import profile
        from ..obs.spans import RECORDER

        with RECORDER.span("serve/tick", requests=len(reqs)):
            # deltas (/v1/cluster-delta, handler threads) never land
            # mid-tick: a batch evaluates against one consistent state,
            # and no two threads launch at once
            with self._delta_lock:
                try:
                    return self._evaluate_batch(reqs)
                finally:
                    # the tick's launch times are read on the thread that
                    # launched them (its placements are on the host, so
                    # the events have completed)
                    profile.resolve_pending(wait=True)

    def _evaluate_batch(self, reqs: List[WhatIfRequest]) -> List[WhatIfReply]:
        from ..models.validation import InputError
        from ..runtime.guard import run_chunked
        from ..utils.trace import phase

        replies: List[Optional[WhatIfReply]] = [None] * len(reqs)
        expanded: List[Optional[List[dict]]] = [None] * len(reqs)
        batched: List[int] = []
        with phase("serve/expand"):
            for r_i, req in enumerate(reqs):
                try:
                    pods = self._expand_request(req)
                except (InputError, ValueError, KeyError) as e:
                    replies[r_i] = WhatIfReply(
                        status=400,
                        body=json.dumps(
                            {"error": f"invalid request: {e}"}
                        ).encode(),
                        meta={"engine": "rejected"},
                    )
                    continue
                expanded[r_i] = pods
                if self.force_serial_reason or any(
                    self._pod_uses_priority(p, self._resolver) for p in pods
                ):
                    replies[r_i] = self._evaluate_serial(
                        req,
                        reason=self.force_serial_reason
                        or "request carries priority",
                    )
                else:
                    batched.append(r_i)
        if not batched:
            return replies

        # one pod axis for the whole tick: cluster pods first (active
        # in every scenario), then each request's pods (active only in
        # its own row) — scenario r's scan order equals the standalone
        # run's schedule order. With a committed scan resident
        # (incremental/resim.py) the cluster pods are ALREADY committed
        # in its warm oracle, so the pod axis carries only the request
        # pods (the suffix) and the roster is never re-scanned — the
        # sequential-commit property keeps placements identical
        # (exactly the multi-batch contract of schedule_app)
        committed = self._committed_scan()
        scan_engine = committed.engine if committed is not None else self.engine
        scan_oracle = committed.oracle if committed is not None else self.oracle
        all_pods = [] if committed is not None else list(self.cluster_pods)
        req_span = {}
        for r_i in batched:
            lo = len(all_pods)
            all_pods.extend(expanded[r_i])
            req_span[r_i] = (lo, len(all_pods))
        node_index = scan_oracle.node_index
        # pods pinned to unknown nodes never reach the scheduler
        # (begin_batch contract; reference simulator.go:221-229)
        pos_of = np.full(len(all_pods), -1, dtype=np.int64)
        batch_idx = []
        for i, pod in enumerate(all_pods):
            name = (pod.get("spec") or {}).get("nodeName")
            if name and name not in node_index:
                continue
            pos_of[i] = len(batch_idx)
            batch_idx.append(i)
        n_batch = len(batch_idx)
        n_cluster = len(all_pods) - sum(
            hi - lo for lo, hi in req_span.values()
        )

        bidx_arr = np.asarray(batch_idx, dtype=np.int64)
        actives = np.zeros((len(batched), n_batch), dtype=bool)
        for row, r_i in enumerate(batched):
            lo, hi = req_span[r_i]
            actives[row] = (bidx_arr < n_cluster) | (
                (bidx_arr >= lo) & (bidx_arr < hi)
            )
        if committed is not None:
            # suffix accounting: this tick dispatched only the request
            # pods; the committed roster rode along as warm state
            COUNTERS.inc("incremental_suffix_pods_total", n_batch)
            COUNTERS.inc(
                "incremental_prefix_reused_pods_total", committed.total
            )

        if n_batch:
            with phase("serve/encode"):
                scan_engine.begin_batch([all_pods[i] for i in batch_idx])
                plan = scan_engine.scenario_plan()

            def evaluate(lo, hi):
                COUNTERS.inc("serve_device_dispatches_total")
                rows = scan_engine.scan_scenarios(actives[lo:hi], plan=plan)
                return [np.asarray(r) for r in rows]

            def serial_fallback(i):
                return self._serial_placements(
                    actives[i], batch_idx, all_pods, base=committed
                )

            from ..obs.costs import COSTS

            rows = run_chunked(
                evaluate,
                len(batched),
                label="serve",
                # work on the card never moves to the host: a single
                # row that still runs out of device memory raises
                serial_fallback=(
                    serial_fallback if self.device.type == "cpu" else None
                ),
                estimate=(
                    COSTS.chunk_estimator("scenario_scan", plan, n_batch)
                    if plan is not None else None
                ),
            )
        else:
            rows = [np.zeros(0, dtype=np.int64) for _ in batched]

        with phase("serve/replay"):
            for row, r_i in enumerate(batched):
                lo, hi = req_span[r_i]
                # lo >= n_cluster always, so this is scan order
                scenario_pods = [
                    (i, all_pods[i])
                    for i in list(range(n_cluster)) + list(range(lo, hi))
                ]
                meta = {"engine": "coalesced-scan"}
                if committed is not None:
                    result = self._assemble_incremental(
                        committed, scenario_pods, rows[row], pos_of
                    )
                    # same coalesced contract, suffix-only dispatch;
                    # the body stays byte-identical — only this
                    # diagnostic header differs
                    meta["incremental"] = "suffix"
                else:
                    result = self._replay(scenario_pods, rows[row], pos_of)
                replies[r_i] = WhatIfReply(
                    status=200, body=result_payload(result), meta=meta
                )
        return replies

    # -- incremental committed state (incremental/resim.py) -----------------

    def _committed_scan(self):
        """The resident CommittedScan, built lazily at the first
        eligible batched tick (so daemon warm-up pays the one full
        scan, not the first caller). None = run the full per-tick
        path: incremental off, cluster ineligible (serial reasons),
        or a device OOM latched the degradation (the only fault that
        degrades: runtime/guard.OOM_ERRORS)."""
        if (
            not self.incremental
            or self.force_serial_reason
            or self._committed_broken
        ):
            return None
        if self._committed is None:
            from ..incremental.resim import CommittedScan
            from ..runtime.guard import OOM_ERRORS
            from ..utils.trace import GLOBAL

            try:
                self._committed = CommittedScan(
                    self.cluster.nodes, self.cluster_pods, device=self.device
                )
            except OOM_ERRORS as e:
                import logging

                COUNTERS.inc("incremental_fallbacks_total")
                GLOBAL.note(
                    "incremental-degraded",
                    f"committed build: {type(e).__name__}",
                )
                logging.getLogger(__name__).warning(
                    "incremental committed scan unavailable (%s); serving "
                    "the full per-tick scan path", e,
                )
                self._committed_broken = True
                return None
        return self._committed

    def _update_committed(self, kind, positions=(), insert_position=None):
        """Delta follow-up: re-simulate the affected journal suffix of
        the resident committed scan (suffix_for_delta's conservative
        rule), falling back to the full re-scan — identical results —
        on a device OOM; a second OOM there leaves the per-tick path.
        Any other fault propagates. Caller holds the delta lock."""
        if self._committed is None:
            return
        if self.force_serial_reason:
            # the delta made the cluster scan-ineligible (priority):
            # every later request routes serial; drop the warm state
            self._committed = None
            return
        from ..incremental.resim import CommittedScan, suffix_for_delta
        from ..runtime.guard import OOM_ERRORS
        from ..utils.trace import GLOBAL

        committed = self._committed
        decision = suffix_for_delta(
            kind,
            len(self.cluster_pods),
            positions=positions,
            insert_position=insert_position,
            has_side_effects=not committed.bulk_eligible,
        )
        try:
            if decision.trivial:
                return
            if decision.full:
                GLOBAL.note("incremental-full-rescan", decision.reason)
                COUNTERS.inc("incremental_full_rebuilds_total")
                self._committed = CommittedScan(
                    self.cluster.nodes, self.cluster_pods, device=self.device
                )
            else:
                self._committed = committed.resimulate(
                    self.cluster_pods, decision.start
                )
        except OOM_ERRORS as e:
            import logging

            COUNTERS.inc("incremental_fallbacks_total")
            GLOBAL.note(
                "incremental-degraded", f"{kind}: {type(e).__name__}"
            )
            logging.getLogger(__name__).warning(
                "incremental suffix re-simulation degraded to a full "
                "re-scan (%s)", e,
            )
            try:
                COUNTERS.inc("incremental_full_rebuilds_total")
                self._committed = CommittedScan(
                    self.cluster.nodes, self.cluster_pods, device=self.device
                )
            except OOM_ERRORS:
                # even the full re-scan runs out of device memory: revert
                # to the (chunk-halving) per-tick path until a reload
                self._committed = None
                self._committed_broken = True

    def _assemble_incremental(
        self, committed, scenario_pods, placements, pos_of
    ) -> SimulateResult:
        """One scenario's SimulateResult on top of the committed
        prefix. All-placed scenarios (the warm common case) append the
        request placements to the committed node lists — zero host
        replay of the roster. A scenario with failures takes the
        exact-reasons path: a scratch oracle seeded from the committed
        state, request pods replayed per the engine-replay contract,
        so reasons read their own step's state — still no device
        work. Committed-pod failures carry their build-time reasons
        (same prefix state, deterministic formula)."""
        oracle = committed.oracle
        has_failure = False
        for i, pod in scenario_pods:
            pos = int(pos_of[i])
            if pos < 0:
                continue
            place = int(placements[pos])
            if place == INACTIVE:
                continue
            if place < 0 and not (pod.get("spec") or {}).get("nodeName"):
                has_failure = True
                break
        if has_failure:
            return self._replay_on_committed(
                committed, scenario_pods, placements, pos_of
            )
        appended = {}
        for i, pod in scenario_pods:
            pos = int(pos_of[i])
            if pos < 0:
                continue  # dangling: tracked, absent from node status
            place = int(placements[pos])
            if place == INACTIVE:  # pragma: no cover - defensive
                continue
            name = (pod.get("spec") or {}).get("nodeName")
            idx = oracle.node_index[name] if name else place
            appended.setdefault(int(idx), []).append(pod)
        status = [
            NodeStatus(
                node=ns.node,
                pods=list(ns.pods) + appended.get(idx, []),
            )
            for idx, ns in enumerate(oracle.nodes)
        ]
        return SimulateResult(
            unscheduled_pods=list(committed.failed), node_status=status
        )

    def _replay_on_committed(
        self, committed, scenario_pods, placements, pos_of
    ) -> SimulateResult:
        """Exact-reasons scenario replay: scratch oracle holding the
        committed state (host-only place_existing walk over the
        committed node lists — the twin's _scratch_oracle pattern),
        then the request pods in scan order."""
        oracle = Oracle([ns.node for ns in committed.oracle.nodes])
        for ns in committed.oracle.nodes:
            for p in ns.pods:
                oracle.place_existing_pod(_own_pod(p))
        failed: List[UnscheduledPod] = list(committed.failed)
        for i, pod in scenario_pods:
            pos = int(pos_of[i])
            if pos < 0:
                continue
            place = int(placements[pos])
            if place == INACTIVE:  # pragma: no cover - defensive
                continue
            pod2 = _own_pod(pod)
            if (pod.get("spec") or {}).get("nodeName"):
                oracle.place_existing_pod(pod2)
            elif place < 0:
                _, reasons, _ = oracle._find_feasible(pod2)
                failed.append(
                    UnscheduledPod(
                        pod=pod2,
                        reason=Oracle._failure_message(pod2, reasons),
                    )
                )
            else:
                oracle._reserve_and_bind(pod2, oracle.nodes[place])
        status = [
            NodeStatus(node=ns.node, pods=list(ns.pods)) for ns in oracle.nodes
        ]
        return SimulateResult(unscheduled_pods=failed, node_status=status)

    def _replay(self, scenario_pods, placements, pos_of) -> SimulateResult:
        """Mirror one scenario's placements into a fresh host oracle in
        scan order — the engine-replay contract of scheduler/engine.py:
        failure reasons read the oracle state of their own step, so
        they match what the standalone run reports. Pods replay as
        copies (_own_pod): the session's shared dicts stay pristine for
        the next batch's encode."""
        oracle = Oracle([ns.node for ns in self.oracle.nodes])
        failed: List[UnscheduledPod] = []
        for i, pod in scenario_pods:
            pos = int(pos_of[i])
            pod2 = _own_pod(pod)
            if pos < 0:
                # dangling (unknown spec.nodeName): tracked, never
                # scheduled, absent from node status — like simulate()
                continue
            place = int(placements[pos])
            if place == INACTIVE:  # pragma: no cover - defensive
                continue
            if (pod.get("spec") or {}).get("nodeName"):
                oracle.place_existing_pod(pod2)
            elif place < 0:
                _, reasons, _ = oracle._find_feasible(pod2)
                failed.append(
                    UnscheduledPod(
                        pod=pod2, reason=Oracle._failure_message(pod2, reasons)
                    )
                )
            else:
                oracle._reserve_and_bind(pod2, oracle.nodes[place])
        status = [
            NodeStatus(node=ns.node, pods=list(ns.pods)) for ns in oracle.nodes
        ]
        return SimulateResult(unscheduled_pods=failed, node_status=status)

    def _serial_placements(
        self, active, batch_idx, all_pods, base=None
    ) -> np.ndarray:
        """Deterministic host-oracle evaluation of ONE scenario row —
        the chunked executor's floor in a ``device="cpu"`` session, when
        even a single-scenario launch runs out of memory. Same conventions as the scan: node index,
        -1 unschedulable, INACTIVE for masked-off positions. ``base``
        (a CommittedScan) seeds the scratch with the committed state
        first — the incremental path's rows carry only request pods,
        so the roster must arrive through the prefix."""
        oracle = Oracle([ns.node for ns in self.oracle.nodes])
        if base is not None:
            for ns in base.oracle.nodes:
                for p in ns.pods:
                    oracle.place_existing_pod(_own_pod(p))
        node_index = self.oracle.node_index
        out = np.full(len(batch_idx), INACTIVE, dtype=np.int64)
        for pos, i in enumerate(batch_idx):
            if not active[pos]:
                continue
            pod2 = _own_pod(all_pods[i])
            if (pod2.get("spec") or {}).get("nodeName"):
                oracle.place_existing_pod(pod2)
                out[pos] = node_index[pod2["spec"]["nodeName"]]
                continue
            name, _reason = oracle.schedule_pod(pod2)
            out[pos] = -1 if name is None else node_index[name]
        return out

    def evaluate_serial(self, req: WhatIfRequest, reason: str) -> WhatIfReply:
        """Admission-routed serial evaluation (serve/admission.py):
        the same full-fidelity path the scan-ineligible requests take,
        exposed for requests ROUTED serial by policy (predicted device
        memory pressure, oversize) rather than by semantics. The body stays
        byte-identical to the coalesced answer — only the engine
        header and the latency differ."""
        return self._evaluate_serial(req, reason=reason)

    def _evaluate_serial(self, req: WhatIfRequest, reason: str) -> WhatIfReply:
        """The full-fidelity path for requests the batched scan cannot
        model: a real simulate() over deep copies (the session's loaded
        cluster must stay pristine — simulate binds pods in place), on
        the session's device."""
        from ..utils.trace import phase

        with phase("serve/serial"), self._delta_lock:
            wl.reset_name_counter()
            cluster = copy.deepcopy(self.cluster)
            apps = [
                AppResource(a.name, copy.deepcopy(a.resource)) for a in req.apps
            ]
            result = simulate(cluster, apps, engine="cuda", device=self.device)
        return WhatIfReply(
            status=200,
            body=result_payload(result),
            meta={"engine": "serial", "serialReason": reason},
        )

    # -- cluster deltas (the shared substrate, twin/deltas.py) --------------

    def apply_delta(self, delta) -> str:
        """Apply one ``ClusterDelta`` to this WARM session — ROADMAP
        item 2's watch-style delta update, on the twin substrate's
        vocabulary. Roster application: arrived/bound pods enter the
        session's pod roster at the bare-pod boundary (so they ride
        every subsequent tick exactly where a cold reload of the
        mutated cluster would expand them), evict/delete remove by
        key, a node join is one incremental ``add_node``. Node drains
        — and any node delta on a daemonset-bearing cluster, whose
        per-node pods consume the generated-name counter — REBUILD the
        session (counted, ``serve_delta_reloads_total``). The
        conformance contract (tests/test_twin.py, CI-gated): after any
        delta stream, this session answers byte-identically to a fresh
        Session over its mutated ``self.cluster``."""
        return self.apply_delta_seq(delta)[0]

    def apply_delta_seq(self, delta) -> "tuple[str, int]":
        """``apply_delta`` returning ``(outcome, seq)`` where ``seq``
        is the EXACT delta sequence this apply was assigned under the
        lock. The journal record must be stamped with this value, not
        a later read of ``self.delta_seq`` — under concurrent handler
        threads the later read can observe another thread's apply, and
        a misstamped record would double-apply (or drop) a delta on
        snapshot-then-suffix restore."""
        from ..obs import profile
        from ..twin.deltas import RELOADED, SKIPPED

        with self._delta_lock:
            try:
                out = self._apply_delta(delta)
            finally:
                # a re-simulation's launch times, read on this thread
                profile.resolve_pending(wait=True)
            self.delta_seq += 1
            seq = self.delta_seq
            COUNTERS.inc(f"serve_delta_{delta.kind}_total")
            if out == SKIPPED:
                COUNTERS.inc("serve_delta_skips_total")
            else:
                COUNTERS.inc("serve_deltas_applied_total")
                if out == RELOADED:
                    COUNTERS.inc("serve_delta_reloads_total")
        return out, seq

    def restore_state(self, cluster: ResourceTypes, delta_seq: int) -> str:
        """Adopt a checkpointed cluster as this session's committed
        state (runtime/checkpoint.py): swap the cluster in, rebuild via
        ``_reload`` (fresh expansion/oracle/engine — identical to a
        cold load of the mutated cluster), and advance ``delta_seq`` to
        the checkpoint's sequence so the journal suffix replay skips
        exactly the absorbed prefix. The caller verifies the payload
        digest BEFORE calling this (fleet/replay.restore_into_session);
        a refused checkpoint must leave the session untouched."""
        with self._delta_lock:
            self.cluster = cluster
            out = self._reload()
            self.delta_seq = int(delta_seq)
        return out

    def _apply_delta(self, delta) -> str:
        from ..twin import deltas as dl

        kind = delta.kind
        if kind in (dl.POD_ARRIVE, dl.POD_BIND):
            raw = copy.deepcopy(delta.pod)
            if kind == dl.POD_BIND:
                raw.setdefault("spec", {})["nodeName"] = delta.node_name
            # re-arrival of a live key replaces the stale entry (its
            # roster slot moves to the section end — the order a cold
            # reload of the mutated cluster.pods list would expand)
            removed_at = self._remove_roster_pod(delta.pod_key)
            valid = wl.pod_from_pod(copy.deepcopy(raw))
            insert_at = self._bare_end
            self.cluster.pods.append(raw)
            self.cluster_pods.insert(self._bare_end, valid)
            self._bare_end += 1
            if not self.force_serial_reason and self._pod_uses_priority(
                valid, self._resolver
            ):
                self.force_serial_reason = "cluster pods carry priority"
            self._update_committed(
                kind, positions=(removed_at,), insert_position=insert_at
            )
            return dl.APPLIED
        if kind in (dl.POD_EVICT, dl.POD_DELETE):
            removed_at = self._remove_roster_pod(delta.pod_key)
            if removed_at is None:
                return dl.SKIPPED
            self._update_committed(kind, positions=(removed_at,))
            return dl.APPLIED
        if kind == dl.NODE_JOIN:
            if any(
                (n.get("metadata") or {}).get("name") == delta.node_name
                for n in self.cluster.nodes
            ):
                return dl.SKIPPED  # re-join of a known node
            self.cluster.nodes.append(delta.node)
            if self.cluster.daemon_sets:
                return self._reload()
            self.oracle.add_node(delta.node)
            self._update_committed(kind)
            return dl.APPLIED
        # node_drain: node identity is baked into every encoding
        from ..models.validation import InputError

        if not any(
            (n.get("metadata") or {}).get("name") == delta.node_name
            for n in self.cluster.nodes
        ):
            raise InputError(
                f"node_drain delta names unknown node {delta.node_name!r}"
            )
        self.cluster.nodes = [
            n
            for n in self.cluster.nodes
            if (n.get("metadata") or {}).get("name") != delta.node_name
        ]
        return self._reload()

    def _remove_roster_pod(self, key) -> Optional[int]:
        """Drop a bare-section roster pod (and its cluster.pods source
        entry) by (namespace, name); returns the roster position it
        held (the suffix rule's touch point) or None when the key is
        unknown. Workload-expanded replicas are out of scope: their
        source object is the workload, which a delta stream cannot
        partially shrink — counted skip instead."""
        for i in range(self._bare_end):
            meta = self.cluster_pods[i].get("metadata") or {}
            if (meta.get("namespace") or "default", meta.get("name", "")) == key:
                self.cluster_pods.pop(i)
                self._bare_end -= 1
                for j, p in enumerate(self.cluster.pods):
                    pm = p.get("metadata") or {}
                    if (
                        pm.get("namespace") or "default",
                        pm.get("name", ""),
                    ) == key:
                        self.cluster.pods.pop(j)
                        break
                return i
        return None

    def _reload(self) -> str:
        """Counted session rebuild over the mutated cluster: the
        constructor body re-runs (fresh oracle/engine/expansion) with
        the caller still holding the delta lock (the constructor
        preserves an existing lock, so no thread can observe the
        half-built state); the session identity (fingerprint) and
        delta bookkeeping survive. The cross-run identity caches keep
        unchanged node templates and pristine encodings warm
        underneath."""
        from ..twin.deltas import RELOADED

        fp = self.fingerprint
        seq, reloads = self.delta_seq, self.delta_reloads
        self.__init__(self.cluster, incremental=self.incremental,
                      device=self.device)
        self.fingerprint = fp
        self.delta_seq, self.delta_reloads = seq, reloads + 1
        return RELOADED


# -- checkpoint capture / materialization (runtime/checkpoint.py) -----------


def cluster_payload(cluster: ResourceTypes) -> dict:
    """The delta-mutated cluster as a JSON-clean checkpoint payload:
    one key per ResourceTypes field, deep-copied so the snapshot writer
    never aliases the live roster the handler threads keep mutating."""
    return {
        f: copy.deepcopy(getattr(cluster, f))
        for f in cluster.__dataclass_fields__
    }


def cluster_from_payload(payload: dict) -> ResourceTypes:
    """Inverse of ``cluster_payload``; unknown keys (a future field
    this build does not model) are refused by the caller's toolchain
    gate before this runs, so plain field assignment suffices."""
    cluster = ResourceTypes()
    for f in cluster.__dataclass_fields__:
        setattr(cluster, f, copy.deepcopy(payload.get(f, [])))
    return cluster


def materialized_state_digest(cluster: ResourceTypes) -> str:
    """``Session.state_digest()`` of a FRESH expansion over a cluster,
    WITHOUT building a Session (no oracle, no engine, no device work).
    By the warm==cold conformance contract the warm roster order equals
    the cold expansion order of the mutated cluster — so this digest
    matching a live session's proves the checkpoint payload
    re-materializes to the same committed state. Callers verifying
    against a LIVE session must hold that session's ``_delta_lock``:
    the generated-name counter this expansion saves/restores is global
    and is otherwise raced by request expansion."""
    saved = wl.name_counter_state()
    try:
        wl.reset_name_counter()
        pods: List[dict] = []
        pods.extend(wl.pods_excluding_daemon_sets(cluster))
        for ds in cluster.daemon_sets:
            pods.extend(wl.pods_from_daemon_set(ds, cluster.nodes))
    finally:
        wl.set_name_counter(saved)
    return config_fingerprint(
        [(n.get("metadata") or {}).get("name") for n in cluster.nodes],
        pods,
    )


def verify_payload_digest(session: Session, payload: dict) -> str:
    """The CheckpointManager ``materialized_digest`` hook for a serve
    session: re-materialize the payload cluster and digest it, under
    the session's delta lock (the name-counter race documented on
    ``materialized_state_digest``)."""
    with session._delta_lock:
        return materialized_state_digest(cluster_from_payload(payload))


def session_checkpoint_state(session: Session):
    """The CheckpointManager ``capture`` hook: one consistent cut of
    the committed session — the ``/v1/state-digest`` triple plus the
    full mutated cluster — taken under the delta lock so the captured
    ``delta_seq`` counts exactly the deltas the payload absorbed."""
    from ..runtime.checkpoint import CheckpointState

    with session._delta_lock:
        return CheckpointState(
            fingerprint=session.fingerprint,
            delta_seq=session.delta_seq,
            state_digest=session.state_digest(),
            payload=cluster_payload(session.cluster),
        )
