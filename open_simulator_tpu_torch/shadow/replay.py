"""Warm step-by-step replay of real scheduler decisions.

One ``ShadowReplayer`` holds ONE warm ``Oracle`` (and, on the cuda
engine, one ``TorchEngine`` with its cached ``ClusterStatic`` encoding)
for the whole trace: each step's probe runs against the oracle's
CURRENT state and each real decision commits into it incrementally —
a 1000-step trace is 1000 incremental commits on copy-on-write
NodeStates and warm identity caches, not 1000 cluster reloads. The
only reload is a ``remove_node`` delta (node identity is baked into
every encoding), counted in the report.

The probe is READ-ONLY: it answers "where would simon place this pod
right now" without binding and without preemption (an eviction would
corrupt the mirrored state; preemption-capable failures are classified
as ordering-divergence instead, with the gate condition cited). On the
cuda engine the probe is one single-pod masked scan per step: one
launch of the fused-scan kernel (B1 on a base plan, its B2-B5 blocks
where the cluster uses them) on the card, or of its plain version on a
CPU device. The kernel library is built by nvcc once, at the first
launch, and every later step launches it again, so replay stays at zero
nvcc builds after the first step of each shape. That contract is
MEASURED, not assumed: every step's build-counter movement
(``nvcc_builds_total``, obs/profile.py) is attributed to a shape
signature of the encoded batch, and a build on an already-seen
signature counts as a ``warm_build`` (tests gate this at zero).

After the probe, the REAL decision commits — even when simon disagrees
— so the mirrored state keeps tracking the production cluster and
later steps are judged against reality, not against simon's
counterfactual.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.decode import ResourceTypes
from ..models.validation import InputError
from ..obs import profile as obs_profile
from ..obs.explain import EXPLAIN
from ..obs.spans import RECORDER
from ..scheduler.oracle import Oracle
from ..utils.trace import COUNTERS, phase
from .log import Step, cluster_fingerprint
from .report import (
    CLASS_AGREE,
    DivergenceReport,
    StepOutcome,
    classify,
)

# score-vector rows carried per divergence (disputed nodes are always
# included on top of this cap)
MAX_SCORE_ROWS = 16


def _own_pod(p: dict) -> dict:
    """Shallow-clone a pod's mutation surface (bind writes
    spec.nodeName / status / metadata.annotations) so replaying from an
    in-memory step list leaves the steps reusable."""
    q = dict(p)
    q["spec"] = dict(p.get("spec") or {})
    meta = dict(p.get("metadata") or {})
    if meta.get("annotations") is not None:
        meta["annotations"] = dict(meta["annotations"])
    q["metadata"] = meta
    if isinstance(q.get("status"), dict):
        q["status"] = dict(q["status"])
    return q


def _pod_name(pod: dict) -> str:
    meta = pod.get("metadata") or {}
    return f"{meta.get('namespace') or 'default'}/{meta.get('name', '')}"


class ShadowReplayer:
    """Replays decision-log steps against a warm mirrored cluster."""

    def __init__(
        self,
        cluster: ResourceTypes,
        engine: str = "cuda",
        explain_divergences: bool = True,
        device=None,
    ):
        if engine not in ("cuda", "oracle"):
            raise InputError(f"unknown shadow engine {engine!r}")
        from ..twin.deltas import MirrorApplicator

        self.cluster = cluster
        self.engine_kind = engine
        self.explain_divergences = explain_divergences
        self.report = DivergenceReport(
            fingerprint=cluster_fingerprint(cluster), engine=engine
        )
        self._obs_before = obs_profile.snapshot()
        self._shapes: set = set()
        # the replayer's mirrored state lives on the shared
        # cluster-delta substrate (twin/deltas.py): the applicator owns
        # the warm Oracle/TorchEngine and every delta op routes through
        # it, so shadow replay, the twin mirror, and the conformance
        # gate can never fork their application semantics
        self._app = MirrorApplicator(cluster, engine=engine, device=device)

    @property
    def oracle(self) -> Oracle:
        return self._app.oracle

    @property
    def _engine(self):
        return self._app.engine

    # -- cluster deltas -----------------------------------------------------

    def _apply_delta(self, op: dict):
        from ..twin.deltas import RELOADED, SKIPPED, from_shadow_op

        out = self._app.apply(from_shadow_op(op))
        if out == SKIPPED:
            # a live tail can observe a deletion racing a node it never
            # mirrored (or a dangling pre-bound pod); counted, never
            # fatal to an hours-long audit
            COUNTERS.inc("shadow_delta_skips_total")
        elif out == RELOADED:
            self.report.reloads += 1
            COUNTERS.inc("shadow_reloads_total")

    # -- the probe ----------------------------------------------------------

    def _shape_key(self) -> tuple:
        """Signature of everything that determines the scan's shapes
        for the current single-pod batch: cluster width, the static
        ScanFeatures, and every array shape/dtype in the encoding. An
        nvcc build on an already-seen signature is a warm-path
        regression."""
        eng = self._engine
        parts: List[tuple] = [("n", eng.cluster_static().n, ""),
                              ("features", eng._features, "")]

        def walk(obj, prefix: str):
            if isinstance(obj, np.ndarray):
                parts.append((prefix, obj.shape, str(obj.dtype)))
            elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                for f in dataclasses.fields(obj):
                    if f.name == "class_pods":
                        continue  # host-only representatives
                    walk(getattr(obj, f.name), f"{prefix}.{f.name}")

        walk(eng._batch, "batch")
        return tuple(parts)

    def _probe(self, pod: dict) -> Optional[str]:
        """Simon's placement for `pod` against current state, no
        commit. cuda: one masked single-pod scan, one kernel launch;
        oracle: the serial filter+score walk with the first-max tie
        rule."""
        if self._engine is not None:
            eng = self._engine
            before = COUNTERS.get("nvcc_builds_total")
            with phase("shadow/probe"):
                eng.begin_batch([pod])
                placements = eng.scan_active(np.ones(1, dtype=bool))
            built = COUNTERS.get("nvcc_builds_total") - before
            sig = self._shape_key()
            if built:
                # 0-based index of the CURRENT step (steps was already
                # bumped when this one began)
                self.report.build_steps.append(self.report.steps - 1)
                if sig in self._shapes:
                    self.report.warm_builds += built
                    COUNTERS.inc("shadow_warm_builds_total", built)
                else:
                    self.report.new_shape_builds += built
            self._shapes.add(sig)
            place = int(placements[0])
            return self.oracle.nodes[place].name if place >= 0 else None
        node, _, _, _ = self._probe_serial(pod)
        return node

    def _probe_serial(self, pod: dict):
        """Serial probe: (node_or_None, reasons, codes, (feasible,
        scores)) — the same _find_feasible + _prioritize + first-max
        walk as Oracle._select_and_bind, minus the bind."""
        o = self.oracle
        feasible, reasons, codes = o._find_feasible(pod)
        if not feasible:
            return None, reasons, codes, ([], [])
        scores = o._prioritize(pod, feasible)
        best, best_score = feasible[0], scores[0]
        for ns, sc in zip(feasible[1:], scores[1:]):
            if sc > best_score:
                best, best_score = ns, sc
        return best.name, reasons, codes, (feasible, scores)

    # -- divergence explanation ---------------------------------------------

    def _explain_walk(self, pod: dict):
        """Full per-node verdict + score walk against CURRENT state —
        run only for divergent steps (O(nodes) serial Python)."""
        o = self.oracle
        ctx = o._pod_filter_ctx(pod)
        pre = o._prefilter(pod)
        verdicts: List[Tuple[str, Optional[str], str]] = []
        feasible = []
        for ns in o.nodes:
            r = o._check_node(pod, ctx, pre, ns)
            if r is None:
                feasible.append(ns)
                verdicts.append((ns.name, None, "feasible"))
            else:
                verdicts.append((ns.name, r[0], r[1]))
        scores = o._prioritize(pod, feasible) if feasible else []
        return verdicts, feasible, scores

    def _divergence_detail(
        self, pod: dict, real_node: Optional[str], simon_node: Optional[str]
    ) -> dict:
        verdicts, feasible, scores = self._explain_walk(pod)
        verdict_of = {name: (reason, code) for name, reason, code in verdicts}
        score_of = {ns.name: sc for ns, sc in zip(feasible, scores)}
        disputed: Dict[str, dict] = {}
        for name in (real_node, simon_node):
            if not name:
                continue
            reason, code = verdict_of.get(name, ("node not in cluster", "unknown-node"))
            disputed[name] = {
                "verdict": "feasible" if reason is None else reason,
                "code": code,
                "score": score_of.get(name),
            }
        reasons: Dict[str, int] = {}
        for _n, reason, _c in verdicts:
            if reason is not None:
                reasons[reason] = reasons.get(reason, 0) + 1
        # score vector: top rows by score, disputed nodes always kept
        ranked = sorted(score_of.items(), key=lambda kv: (-kv[1], kv[0]))
        keep = {name for name, _ in ranked[:MAX_SCORE_ROWS]} | set(disputed)
        vector = [
            {"node": name, "score": sc}
            for name, sc in ranked
            if name in keep
        ]
        return {
            "disputedNodes": disputed,
            "scoreVector": vector,
            "feasibleNodes": len(feasible),
            "totalNodes": len(verdicts),
            "reasonCounts": reasons,
        }

    def _ordering_evidence(
        self, st: Step, pod: dict, simon_node: Optional[str], real_node: Optional[str]
    ) -> Optional[str]:
        evictions = [op for op in st.deltas if op.get("op") == "evict_pod"]
        if evictions:
            victims = ", ".join(
                f"{op.get('namespace')}/{op.get('name')}" for op in evictions
            )
            return (
                f"real scheduler preempted {len(evictions)} pod(s) for this "
                f"decision ({victims})"
            )
        if simon_node is None and real_node is not None:
            # the probe never preempts; a preemption-capable failure is
            # ordering, not policy — mirror the serial cycle's own gate
            # (oracle._post_filter_preempt)
            o = self.oracle
            prio = o.pod_priority(pod)
            if o.enable_preemption and prio > o._min_prio:
                _, _, codes = o._find_feasible(pod)
                if any(c == "unschedulable" for c in codes.values()):
                    return (
                        f"pod priority {prio} exceeds the committed minimum "
                        f"({o._min_prio}) and preemption-helpable nodes "
                        "exist; the read-only shadow probe does not preempt"
                    )
        return None

    # -- stepping -----------------------------------------------------------

    def step(self, st: Step) -> Optional[StepOutcome]:
        """Apply one log step. Returns the classified outcome for
        decision steps, None for bare deltas."""
        if RECORDER.enabled:
            with RECORDER.span("shadow/step", seq=st.seq, kind=st.kind):
                return self._step(st)
        return self._step(st)

    def _step(self, st: Step) -> Optional[StepOutcome]:
        self.report.steps += 1
        COUNTERS.inc("shadow_steps_total")
        for op in st.deltas:
            self._apply_delta(op)
        if st.kind != "decision":
            return None
        pod = _own_pod(st.pod)
        if (pod.get("spec") or {}).get("nodeName"):
            raise InputError(
                f"decision step {st.seq} pod {_pod_name(pod)} carries "
                "spec.nodeName — pre-bound pods belong in a place_pod delta"
            )
        real_node = st.node
        if real_node is not None and real_node not in self.oracle.node_index:
            raise InputError(
                f"decision step {st.seq} names unknown node {real_node!r}"
            )
        simon_node = self._probe(pod)
        simon_reason = ""
        if simon_node is None:
            # exact failure message from the serial walk at this step's
            # state (the scan path has no reason strings)
            _, reasons, _, _ = self._probe_serial(pod)
            simon_reason = Oracle._failure_message(pod, reasons)
        evidence = None
        if real_node != simon_node:
            evidence = self._ordering_evidence(st, pod, simon_node, real_node)
        cls = classify(real_node, simon_node, evidence)
        outcome = StepOutcome(
            seq=st.seq,
            pod=_pod_name(pod),
            cls=cls,
            real_node=real_node,
            real_reason=st.reason,
            simon_node=simon_node,
            simon_reason=simon_reason,
            evidence=evidence,
        )
        if cls != CLASS_AGREE and self.explain_divergences:
            outcome.detail = self._divergence_detail(pod, real_node, simon_node)
        # flight-recorder hook: a --explain'd pod gets its full
        # decision captured at exactly this step's oracle state, with
        # shadow provenance stamped (obs/explain.capture contract)
        if EXPLAIN.enabled and EXPLAIN.should_record(pod):
            idx = (
                self.oracle.node_index[real_node]
                if real_node is not None
                else None
            )
            EXPLAIN.capture(self.oracle, pod, idx)
            EXPLAIN.annotate(
                pod,
                engine="shadow-replay",
                shadow_seq=st.seq,
                shadow_class=cls,
                real_node=real_node or "",
                simon_node=simon_node or "",
            )
        # commit REALITY, not simon's counterfactual: later steps are
        # judged against the cluster as it actually evolved (a failed
        # real decision leaves the pod pending on the substrate — the
        # population the twin forecast requeues)
        with phase("shadow/commit"):
            if real_node is not None:
                self._app.commit_decision(pod, self.oracle.node_index[real_node])
            else:
                self._app.note_pending(pod)
        self.report.add(outcome)
        COUNTERS.inc("shadow_decisions_total")
        if cls == CLASS_AGREE:
            COUNTERS.inc("shadow_agree_total")
        else:
            COUNTERS.inc("shadow_divergence_total")
            COUNTERS.inc(
                "shadow_divergence_%s_total" % cls.split("-")[0]
            )
        return outcome

    def run(self, steps, budget=None) -> DivergenceReport:
        """Replay a step sequence and finish the report. Budget is
        checked between steps — the finest safe boundary replay has."""
        for i, st in enumerate(steps):
            if budget is not None and i % 64 == 0:
                budget.check(f"shadow replay (step {i})")
            self.step(st)
        return self.finish()

    def finish(self) -> DivergenceReport:
        self.report.finish(obs_profile.delta(self._obs_before))
        COUNTERS.gauge("shadow_agreement_rate", self.report.agreement_rate)
        return self.report
