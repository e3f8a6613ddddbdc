"""The windowed timeline stepper.

The naive discrete-event simulation schedules one pod per event — a
1000-step trace is 1000 ``simulate()`` calls. Here the timeline rides
the batched masked scan instead (the chaos substrate,
parallel/sweep.py probe_scenarios): every node and every pod that EVER
exists in the trace is encoded ONCE, and the cluster's state at any
instant is a (node_valid, pod_active, pinned) triple —

- nodes that are up (base nodes minus drains/reclaims, plus joins and
  enabled autoscaler candidates) form ``node_valid``;
- pods that have arrived and not departed form ``pod_active``
  (daemonset pods follow their node's validity for free, exactly like
  the capacity sweep's disabled-node convention);
- pods placed in earlier windows pin to their nodes (pins commit
  unconditionally in the scan's first pass — real pods do not move),
  pods displaced by a drain/reclaim and pods still pending are free
  and reschedule through the full filter+score cycle in arrival order.

A WINDOW is a run of consecutive arrivals between boundaries (node
churn, autoscale-decision cadence ticks, warm-up activations, the
arrival cap). One window = ONE launch of the batch kernel's
pins-first mode (B6, csrc/fused_scan.cu) evaluating every policy's row
— so N policies over a 1000-step trace cost a handful of launches
total, not 1000·N simulate() calls. The probe policy's decision is one
more such launch, a row a candidate count. The launches count under
the site ``timeline_sweep`` (obs/profile.py; ``--inject
jit.timeline_sweep=oom@1`` halves a chunk). Within-window curves are
reconstructed host-side from the window's placements in arrival order
(report.py).

Quantization semantics (the JAX package's docs/TIMELINE.md): departures and churn
falling inside a window take effect at the window's CLOSE — capacity
is never freed early, so a placement never uses capacity that is not
surely free; arrivals schedule at their own event times in order.
The serial conformance path (``engine="oracle"``) evaluates the exact
same per-window (valid, active, pinned) state through the host oracle
(CapacitySweep.serial_scenario), so windowed-vs-serial equivalence is
a testable contract, not an approximation claim.

Budget deadlines are checked at every window boundary; with a journal,
completed window placements (and the probe policy's decision scans)
replay from disk and a resumed run re-executes zero device work.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.validation import InputError
from ..models import workloads as wl
from ..parallel.scans import utilisation
from ..parallel.sweep import CapacitySweep, ProbeResult
from ..resilience.chaos import displaced_free_mask
from ..runtime.errors import ExecutionHalted
from .autoscaler import Policy, PolicyObservation
from .events import (
    AUTOSCALE_DECISION,
    CHURN_KINDS,
    NODE_DRAIN,
    NODE_JOIN,
    POD_ARRIVAL,
    POD_DEPARTURE,
    SPOT_RECLAIM,
    Event,
    trace_fingerprint,
)
from .report import PolicyTimeline, StepSample, TimelineComparison

_INF = float("inf")


@dataclass
class _PolicyState:
    """Per-policy mutable timeline state."""

    policy: Policy
    tl: PolicyTimeline
    placed: np.ndarray  # [P] current node index of ~had pods, -1 free
    node_up: np.ndarray  # [N] bool
    cand_up: int = 0  # enabled candidates (always a prefix)
    # committed scale-ups still warming: (t_effective, add_count)
    activations: List[Tuple[float, int]] = field(default_factory=list)
    cost: float = 0.0  # node-seconds accumulated up to window start

    def next_activation(self) -> float:
        return min((t for t, _ in self.activations), default=_INF)


class TimelineStepper:
    """Run one trace through N same-score-profile policies.

    Policies with different score profiles need their own encoding
    (the scan's score weights are compile-time static); the comparison
    harness (compare.py) groups them and merges the reports."""

    def __init__(
        self,
        cluster,
        events: List[Event],
        policies: List[Policy],
        new_node_spec: Optional[dict] = None,
        max_nodes: int = 8,
        cadence_s: float = 60.0,
        warmup_s: float = 0.0,
        window_arrivals: int = 256,
        engine: str = "cuda",
        score_weights=None,
        budget=None,
        journal=None,
        journal_prefix: str = "",
        device=None,
    ):
        if engine not in ("cuda", "oracle"):
            raise InputError(f"timeline engine must be cuda|oracle, not {engine!r}")
        if cadence_s <= 0:
            raise InputError(f"decision cadence must be > 0s, got {cadence_s}")
        if warmup_s < 0:
            raise InputError(f"warm-up delay must be >= 0s, got {warmup_s}")
        if window_arrivals < 1:
            raise InputError(
                f"window arrival cap must be >= 1, got {window_arrivals}"
            )
        if not policies:
            raise InputError("timeline needs at least one policy")
        self.events = list(events)
        self.engine = engine
        self.cadence_s = float(cadence_s)
        self.warmup_s = float(warmup_s)
        self.window_arrivals = int(window_arrivals)
        self.budget = budget
        self.journal = journal
        self.journal_prefix = journal_prefix
        self.trace_fp = trace_fingerprint(self.events)

        # ---- the encode-once universe: every node and pod that ever exists
        arrival_events = [ev for ev in self.events if ev.kind == POD_ARRIVAL]
        join_nodes: List[dict] = []
        base_names = {
            ((n.get("metadata") or {}).get("name")) for n in cluster.nodes
        }
        seen_joins = set(base_names)
        for ev in self.events:
            if ev.kind != NODE_JOIN:
                continue
            name = ((ev.node or {}).get("metadata") or {}).get("name")
            if not name:
                raise InputError(
                    f"NodeJoin event at t={ev.time} carries no node name"
                )
            if name in seen_joins:
                continue  # re-join of a known node: mask flip only
            seen_joins.add(name)
            join_nodes.append(wl.make_valid_node(ev.node, name))
        tl_cluster = cluster.copy()
        tl_cluster.nodes = list(cluster.nodes) + join_nodes
        tl_cluster.pods = list(cluster.pods) + [ev.pod for ev in arrival_events]
        # workload expansion names pods from a process-global counter;
        # reset so repeated in-process runs (and compare.py's per-profile
        # re-encodings) expand the identical sequence (the chaos rule)
        wl.reset_name_counter()
        self.sweep = CapacitySweep(
            tl_cluster,
            [],
            new_node_spec,
            max_nodes,
            score_weights=score_weights,
            device=device,
        )
        self.n = self.sweep.n
        self.p = len(self.sweep.pods)
        self.n_base = self.sweep.n_base
        self.cand_total = self.sweep.max_count
        self.n_real_base = len(cluster.nodes)  # up at t=0

        # arrival event k -> sweep pod index (positional: resources.pods
        # entries expand 1:1 in order, cluster pods first)
        self.arrival_pod_idx = [
            len(cluster.pods) + k for k in range(len(arrival_events))
        ]
        self._arrival_seq = {
            id(ev): self.arrival_pod_idx[k]
            for k, ev in enumerate(arrival_events)
        }
        # namespace/name -> sweep pod indices (departure resolution;
        # latest-arrived wins when a name recurs, e.g. evict + re-create)
        self._ref_idx: Dict[str, List[int]] = {}
        for p_i, pod in enumerate(self.sweep.pods):
            meta = pod.get("metadata") or {}
            ref = f"{meta.get('namespace') or 'default'}/{meta.get('name') or ''}"
            self._ref_idx.setdefault(ref, []).append(p_i)

        # shared presence state
        self.arrived = np.zeros(self.p, dtype=bool)
        day0 = set(range(self.p)) - set(self.arrival_pod_idx)
        self.arrived[list(day0)] = True
        self.departed = np.zeros(self.p, dtype=bool)
        self.had = np.asarray(self.sweep.had_node_name, dtype=bool)
        self.orig_pin = np.asarray(self.sweep.batch.pinned_node, dtype=np.int64)
        cls = np.asarray(self.sweep.batch.class_of_pod, dtype=np.int64)
        self._req_c = np.asarray(self.sweep.batch.req_mcpu)[cls].astype(np.int64)
        self._req_m = np.asarray(self.sweep.batch.req_mem)[cls].astype(np.int64)

        node_up0 = np.zeros(self.n, dtype=bool)
        node_up0[: self.n_real_base] = True
        self.states = [
            _PolicyState(
                policy=pol,
                tl=PolicyTimeline(policy=pol.name),
                placed=np.full(self.p, -1, dtype=np.int64),
                node_up=node_up0.copy(),
            )
            for pol in policies
        ]
        self.windows = 0
        self.dispatches = 0
        self._partial = False
        self._last_close = 0.0

    # ------------------------------------------------------------ utilities

    def _node_idx(self, name: str, ev: Event) -> int:
        idx = self.sweep.oracle.node_index.get(name)
        if idx is None:
            raise InputError(
                f"{ev.kind} event at t={ev.time} names unknown node {name!r}"
            )
        return int(idx)

    def _present(self) -> np.ndarray:
        return self.arrived & ~self.departed

    def _active(self, st: _PolicyState) -> np.ndarray:
        return self.sweep.pod_active(st.node_up) & self._present()

    def _pinned(self, st: _PolicyState) -> np.ndarray:
        return np.where(self.had, self.orig_pin, st.placed).astype(np.int64)

    def _free_mask(self, st: _PolicyState) -> np.ndarray:
        return self._active(st) & ~self.had & (st.placed < 0)

    def _usage(self, st: _PolicyState, accounted: np.ndarray) -> tuple:
        """(used_mcpu, used_mem, denom_mcpu, denom_mem) over up nodes —
        the same arithmetic as the scan layer's host_sums
        (parallel/scans.py), in cumulative form for intra-window
        samples."""
        v = st.node_up
        d, c_enc = self.sweep.dyn, self.sweep.cluster_enc
        used_c = int(d.used_mcpu[v].sum()) + int(self._req_c[accounted].sum())
        used_m = int(d.used_mem[v].sum()) + int(self._req_m[accounted].sum())
        denom_c = max(int(c_enc.alloc_mcpu[v].sum()), 1)
        denom_m = max(int(c_enc.alloc_mem[v].sum()), 1)
        return used_c, used_m, denom_c, denom_m

    def _pinned_had_mask(self, st: _PolicyState) -> np.ndarray:
        """Node-bound pods occupying capacity: original spec.nodeName
        pods that are present, active, and whose node is up."""
        return (
            self.had
            & self._active(st)
            & (self.orig_pin >= 0)
            & st.node_up[np.clip(self.orig_pin, 0, None)]
        )

    def _sample(self, st: _PolicyState, t: float, t_start: float) -> StepSample:
        """Full-state sample at `t` (window-boundary form)."""
        acc = ((st.placed >= 0) & ~self.had) | self._pinned_had_mask(st)
        used_c, used_m, den_c, den_m = self._usage(st, acc)
        pending = int(self._free_mask(st).sum())
        nodes = int(st.node_up.sum())
        return StepSample(
            time=t,
            pending=pending,
            running=int(((st.placed >= 0) & ~self.had).sum()),
            nodes_up=nodes,
            candidates_up=int(st.node_up[self.n_base :].sum()),
            cpu_util=100.0 * used_c / den_c,
            mem_util=100.0 * used_m / den_m,
            cost_node_s=st.cost + nodes * (t - t_start),
        )

    # ------------------------------------------------------------ main loop

    def run(self) -> TimelineComparison:
        try:
            return self._run_inner()
        except ExecutionHalted as e:
            self._partial = True
            report = self.comparison()
            e.partial = {"phase": "timeline", "report": report.as_dict()}
            e.partial_report = report
            raise

    def _run_inner(self) -> TimelineComparison:
        from ..utils.trace import GLOBAL

        events = self.events
        horizon = events[-1].time if events else 0.0
        next_tick = 0.0  # decisions run at t=0 too (initial provisioning)
        i = 0
        while True:
            # chaos seam: deterministic faults at the window boundary
            # (runtime/inject.py; ExecutionHalted here carries the
            # partial report through run()'s handler like a deadline)
            from ..runtime import inject as _inject

            _inject.fire("timeline.tick", window=self.windows)
            if self.budget is not None:
                self.budget.check(f"timeline window {self.windows}")
            t_start = self._last_close if self.windows else 0.0
            t_act = min(st.next_activation() for st in self.states)
            t_bound = min(next_tick, t_act)
            # ---- collect the window (for-loop: bounded by the stream)
            arrivals: List[int] = []  # event indices, in order
            departures: List[int] = []
            boundary_ev: Optional[Event] = None
            t_close = None
            j = i
            for j in range(i, len(events)):
                ev = events[j]
                if ev.time >= t_bound:
                    t_close = t_bound
                    break
                if ev.kind in CHURN_KINDS:
                    boundary_ev = ev
                    t_close = ev.time
                    j += 1
                    break
                if ev.kind == POD_ARRIVAL:
                    if len(arrivals) >= self.window_arrivals:
                        t_close = ev.time  # cap boundary; ev stays queued
                        break
                    arrivals.append(j)
                elif ev.kind == POD_DEPARTURE:
                    departures.append(j)
            else:
                # normal exhaustion: every event consumed. On breaks,
                # `j` is the resume point (the churn branch advanced
                # past its consumed event; the boundary/cap breaks
                # leave event j queued for the next window).
                j = len(events)
            exhausted = False
            if t_close is None:  # stream ran out before any boundary
                if t_bound <= horizon:
                    t_close = t_bound
                else:
                    t_close = max(horizon, t_start)
                    exhausted = True
            i = j

            # ---- arrivals become present and the window dispatches
            arr_pods = [self._arrival_seq[id(events[k])] for k in arrivals]
            arr_times = [events[k].time for k in arrivals]
            self.arrived[arr_pods] = True
            rows = self._dispatch_window(arr_pods)
            self._emit_samples(rows, arr_pods, arr_times, t_start, t_close)

            # ---- close: departures, then cost roll-forward
            self._apply_departures(departures)
            changed = bool(departures)
            for st in self.states:
                st.cost += int(st.node_up.sum()) * (t_close - t_start)
            self._last_close = t_close
            self.windows += 1

            # ---- boundary effects
            if boundary_ev is not None:
                self._apply_churn(boundary_ev)
                changed = True
            for st in self.states:
                due = [a for a in st.activations if a[0] <= t_close]
                if due:
                    st.activations = [
                        a for a in st.activations if a[0] > t_close
                    ]
                    for _t, k in due:
                        self._scale_up_now(st, k)
                    changed = True
            if next_tick <= t_close:
                self._decide(next_tick)
                while next_tick <= t_close:
                    if self.budget is not None:
                        self.budget.check("timeline tick advance")
                    next_tick += self.cadence_s
                changed = True
            if changed:
                for st in self.states:
                    st.tl.samples.append(self._sample(st, t_close, t_close))
            if exhausted:
                break

        for st in self.states:
            if st.activations:
                GLOBAL.append_note(
                    "timeline-warmup",
                    f"{st.policy.name}: {len(st.activations)} scale-up(s) "
                    "still warming at the horizon (never activated)",
                )
        GLOBAL.note("timeline-windows", str(self.windows))
        GLOBAL.note("timeline-dispatches", str(self.dispatches))
        return self.comparison()

    # ------------------------------------------------------------ dispatch

    def _dispatch_window(self, arr_pods: List[int]):
        """One batched dispatch over every policy that has free pods to
        (re)schedule; returns {state index: placements row} and updates
        each dispatched policy's `placed`."""
        from ..utils.trace import phase

        work = [
            k for k, st in enumerate(self.states)
            if bool(self._free_mask(st).any())
        ]
        if not work:
            return {}
        valids = np.stack([self.states[k].node_up for k in work])
        actives = np.stack([self._active(self.states[k]) for k in work])
        pins = np.stack([self._pinned(self.states[k]) for k in work])
        key = f"{self.journal_prefix}tlw:{self.windows}"
        names = [self.states[k].policy.name for k in work]
        rows: Dict[int, np.ndarray] = {}
        journaled = None
        if self.journal is not None:
            rec = self.journal.get_scenario(key)
            if rec is not None and all(
                name in (rec.get("placements") or {}) for name in names
            ):
                journaled = rec
        if journaled is not None:
            for k, name in zip(work, names):
                rows[k] = np.asarray(
                    journaled["placements"][name], dtype=np.int64
                )
        else:
            with phase("timeline/window"):
                if self.engine == "cuda":
                    placements, _u, _c, _m, _v = self.sweep.probe_scenarios(
                        valids, actives, pins, site="timeline"
                    )
                else:
                    placements = np.stack([
                        self.sweep.serial_scenario(
                            valids[r], actives[r], pins[r], pins_first=True
                        )[0]
                        for r in range(len(work))
                    ])
            self.dispatches += 1
            # incremental accounting: each
            # window re-decides only its FREE pods — rows placed in
            # earlier windows ride along as pins, the reused prefix
            from ..utils.trace import COUNTERS

            free_rows = int(
                sum(self._free_mask(self.states[k]).sum() for k in work)
            )
            pinned_rows = int((pins >= 0).sum())
            COUNTERS.inc("incremental_suffix_pods_total", free_rows)
            COUNTERS.inc("incremental_prefix_reused_pods_total", pinned_rows)
            for r, k in enumerate(work):
                rows[k] = np.asarray(placements[r], dtype=np.int64)
            if self.journal is not None:
                self.journal.record_scenario(
                    key,
                    {
                        "placements": {
                            name: [int(x) for x in rows[k]]
                            for k, name in zip(work, names)
                        }
                    },
                )
        for k in work:
            st = self.states[k]
            free = self._free_mask(st)
            row = rows[k]
            st.placed[free] = np.where(row[free] >= 0, row[free], -1)
        return rows

    def _emit_samples(self, rows, arr_pods, arr_times, t_start, t_close):
        """Reconstruct intra-window curve points per policy: retried
        pods commit at the window start, each arrival at its own event
        time, in arrival order (= batch order = scan commit order).
        An arrival-free window that still dispatched (displaced pods
        requeueing after churn) samples once at its close so the
        curves show the recovery."""
        if not arr_pods:
            for k in rows:
                st = self.states[k]
                st.tl.samples.append(self._sample(st, t_close, t_start))
            return
        arr_mask = np.zeros(self.p, dtype=bool)
        if arr_pods:
            arr_mask[np.asarray(arr_pods, dtype=np.int64)] = True
        for k, st in enumerate(self.states):
            nodes = int(st.node_up.sum())
            cand = int(st.node_up[self.n_base :].sum())
            active = self._active(st)
            pinned_had = self._pinned_had_mask(st)
            acc = ((st.placed >= 0) & ~self.had) | pinned_had
            acc_start = acc & ~arr_mask
            used_c, used_m, den_c, den_m = self._usage(st, acc_start)
            running = int((acc_start & ~self.had).sum())
            pending = int((self._free_mask(st) & ~arr_mask).sum())
            for p_i, t in zip(arr_pods, arr_times):
                if st.placed[p_i] >= 0:
                    used_c += int(self._req_c[p_i])
                    used_m += int(self._req_m[p_i])
                    running += 1
                elif pinned_had[p_i]:
                    # a pre-bound arrival occupies capacity unscheduled
                    used_c += int(self._req_c[p_i])
                    used_m += int(self._req_m[p_i])
                elif active[p_i] and not self.had[p_i]:
                    pending += 1
                st.tl.samples.append(StepSample(
                    time=t,
                    pending=pending,
                    running=running,
                    nodes_up=nodes,
                    candidates_up=cand,
                    cpu_util=100.0 * used_c / den_c,
                    mem_util=100.0 * used_m / den_m,
                    cost_node_s=st.cost + nodes * (t - t_start),
                ))

    # ------------------------------------------------------------ boundary

    def _apply_departures(self, departures: List[int]):
        for k in departures:
            ev = self.events[k]
            candidates = [
                p_i
                for p_i in self._ref_idx.get(ev.pod_ref, ())
                if self.arrived[p_i] and not self.departed[p_i]
            ]
            if not candidates:
                raise InputError(
                    f"PodDeparture at t={ev.time} references "
                    f"{ev.pod_ref!r}, which is not present in the timeline"
                )
            p_i = candidates[-1]  # latest arrival of a recurring name
            self.departed[p_i] = True
            for st in self.states:
                if not self.had[p_i] and st.placed[p_i] < 0:
                    st.tl.never_scheduled += 1
                st.placed[p_i] = -1

    def _take_node_down(self, st: _PolicyState, idx: int, reason: str):
        if not st.node_up[idx]:
            return
        st.node_up[idx] = False
        active_after = self._active(st)
        disp = displaced_free_mask(st.placed, st.node_up, self.had, active_after)
        n_disp = int(disp.sum())
        if n_disp:
            st.placed[disp] = -1
            st.tl.displaced_total += n_disp
            st.tl.displaced_by[reason] = (
                st.tl.displaced_by.get(reason, 0) + n_disp
            )
        present = self._present()
        lost_ds = int(
            ((np.asarray(self.sweep._ds_target) == idx) & present).sum()
        )
        lost_bound = int(
            (self.had & (self.orig_pin == idx) & present).sum()
        )
        st.tl.lost_total += lost_ds + lost_bound

    def _apply_churn(self, ev: Event):
        if ev.kind == NODE_JOIN:
            name = ((ev.node or {}).get("metadata") or {}).get("name")
            idx = self._node_idx(name, ev)
            for st in self.states:
                st.node_up[idx] = True
        elif ev.kind in (NODE_DRAIN, SPOT_RECLAIM):
            idx = self._node_idx(ev.node_name, ev)
            if idx >= self.n_base:
                raise InputError(
                    f"{ev.kind} event names autoscaler candidate "
                    f"{ev.node_name!r}; the candidate pool belongs to the "
                    "policies (use AutoscaleDecision deltas)"
                )
            for st in self.states:
                self._take_node_down(st, idx, ev.kind)
        elif ev.kind == AUTOSCALE_DECISION:
            # a recorded decision in the INPUT trace applies verbatim to
            # every policy's candidate pool (replaying one run's
            # decisions against another workload)
            for st in self.states:
                self._apply_delta(st, ev.delta, ev.time, warmup=0.0,
                                  reason=ev.reason or "trace")

    # ------------------------------------------------------------ decisions

    def _scale_up_now(self, st: _PolicyState, k: int):
        lo = self.n_base + int(st.node_up[self.n_base :].sum())
        hi = min(lo + k, self.n)
        st.node_up[lo:hi] = True

    def _apply_delta(self, st: _PolicyState, delta: int, t: float,
                     warmup: float, reason: str):
        """Apply a scale delta: +k warms the next k candidates
        (activation after `warmup`), -k drains the highest-index
        enabled candidates immediately (pending warm-ups cancel
        first)."""
        if delta > 0:
            room = self.cand_total - st.cand_up
            k = min(delta, room)
            if k <= 0:
                return
            st.cand_up += k
            if warmup > 0:
                st.activations.append((t + warmup, k))
            else:
                self._scale_up_now(st, k)
            st.tl.decisions.append(
                {"time": t, "delta": k, "reason": reason,
                 "effective": t + warmup}
            )
        elif delta < 0:
            total = min(-delta, st.cand_up)
            if total <= 0:
                return
            st.cand_up -= total
            # cancel warming capacity before draining live nodes
            k = total
            while k and st.activations:
                t_eff, n_act = st.activations[-1]
                take = min(k, n_act)
                if take == n_act:
                    st.activations.pop()
                else:
                    st.activations[-1] = (t_eff, n_act - take)
                k -= take
            enabled = int(st.node_up[self.n_base :].sum())
            for d in range(k):
                self._take_node_down(
                    st, self.n_base + enabled - 1 - d, "scale-down"
                )
            st.tl.decisions.append(
                {"time": t, "delta": -total, "reason": reason, "effective": t}
            )

    def _pending_need_nodes(self, st: _PolicyState) -> int:
        """Candidate nodes the pending pods need by aggregate request —
        apply's escalation estimate (CapacitySweep.estimate_extra) on a
        synthetic probe whose failures are exactly the pending set."""
        free = self._free_mask(st)
        if not free.any() or self.cand_total == 0:
            return 0
        fake = ProbeResult(
            count=0, unscheduled=int(free.sum()), cpu_util=0.0,
            mem_util=0.0, vg_util=0.0,
            placements=np.where(free, -1, 0).astype(np.int64),
        )
        return int(self.sweep.estimate_extra(fake))

    def _probe_counts(self, st: _PolicyState, counts: List[int]):
        """The probe policy's decision scan: every candidate count as
        one batched row over the CURRENT timeline state (pins kept,
        pending pods free) — one device dispatch per decision."""
        key = f"{self.journal_prefix}tlp:{self.windows}:{st.policy.name}"
        rec = self.journal.get_scenario(key) if self.journal is not None else None
        if rec is not None and rec.get("counts") == list(counts) and "vg" in rec:
            return [
                ProbeResult(
                    count=int(c), unscheduled=int(u), cpu_util=float(cu),
                    mem_util=float(mu), vg_util=float(vu), placements=None,
                )
                for c, u, cu, mu, vu in zip(
                    rec["counts"], rec["unscheduled"], rec["cpu"],
                    rec["mem"], rec["vg"],
                )
            ]
        valids, actives, pins = [], [], []
        for c in counts:
            v = st.node_up.copy()
            v[self.n_base : self.n_base + c] = True
            v[self.n_base + c :] = False
            placed_ok = (st.placed >= 0) & v[np.clip(st.placed, 0, None)]
            pin = np.where(
                self.had, self.orig_pin, np.where(placed_ok, st.placed, -1)
            ).astype(np.int64)
            valids.append(v)
            actives.append(self.sweep.pod_active(v) & self._present())
            pins.append(pin)
        from ..utils.trace import phase

        with phase("timeline/probe"):
            if self.engine == "cuda":
                _pl, unsched, cpu, mem, vg = self.sweep.probe_scenarios(
                    np.stack(valids), np.stack(actives), np.stack(pins),
                    site="timeline",
                )
            else:
                rows = [
                    self.sweep.serial_scenario(
                        valids[r], actives[r], pins[r], pins_first=True
                    )[0]
                    for r in range(len(counts))
                ]
                stats = [
                    utilisation(rows[r], *self.sweep.scans.host_sums(valids[r], rows[r]))
                    for r in range(len(counts))
                ]
                unsched = [s[0] for s in stats]
                cpu = [s[1] for s in stats]
                mem = [s[2] for s in stats]
                vg = [s[3] for s in stats]
        self.dispatches += 1
        out = [
            ProbeResult(
                count=int(c), unscheduled=int(u), cpu_util=float(cu),
                mem_util=float(mu), vg_util=float(vu), placements=None,
            )
            for c, u, cu, mu, vu in zip(counts, unsched, cpu, mem, vg)
        ]
        if self.journal is not None:
            self.journal.record_scenario(key, {
                "counts": [int(c) for c in counts],
                "unscheduled": [int(r.unscheduled) for r in out],
                "cpu": [float(r.cpu_util) for r in out],
                "mem": [float(r.mem_util) for r in out],
                "vg": [float(r.vg_util) for r in out],
            })
        return out

    def _decide(self, t: float):
        from ..utils.trace import phase

        with phase("timeline/decide"):
            for st in self.states:
                free = self._free_mask(st)
                acc = ((st.placed >= 0) & ~self.had) | self._pinned_had_mask(st)
                used_c, used_m, den_c, den_m = self._usage(st, acc)
                obs = PolicyObservation(
                    time=t,
                    pending=int(free.sum()),
                    pending_need_nodes=self._pending_need_nodes(st),
                    cpu_util=100.0 * used_c / den_c,
                    mem_util=100.0 * used_m / den_m,
                    nodes_up=int(st.node_up.sum()),
                    candidates_up=st.cand_up,
                    candidates_total=self.cand_total,
                )
                delta = st.policy.decide(
                    obs, probe=lambda counts, _st=st: self._probe_counts(_st, counts)
                )
                if delta:
                    self._apply_delta(
                        st, int(delta), t, self.warmup_s,
                        reason=f"policy:{st.policy.name}",
                    )

    # ------------------------------------------------------------ results

    def comparison(self) -> TimelineComparison:
        return TimelineComparison(
            trace_fingerprint=self.trace_fp,
            events=len(self.events),
            arrivals=len(self.arrival_pod_idx),
            windows=self.windows,
            dispatches=self.dispatches,
            horizon_s=self.events[-1].time if self.events else 0.0,
            engine=self.engine,
            policies=[st.tl for st in self.states],
            partial=self._partial,
            meta={
                "cadenceSeconds": self.cadence_s,
                "warmupSeconds": self.warmup_s,
                "windowArrivalCap": self.window_arrivals,
                "candidateNodes": self.cand_total,
            },
        )
