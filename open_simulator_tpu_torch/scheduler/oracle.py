"""Serial oracle scheduler.

A pure-Python, bit-exact reimplementation of one kube-scheduler v1.20.5
scheduling cycle (vendor/.../scheduler/core/generic_scheduler.go:131-180)
with the simulator's plugin profile:

  Filter:  NodeUnschedulable, NodeName, TaintToleration, NodeAffinity,
           NodePorts, NodeResourcesFit, PodTopologySpread,
           InterPodAffinity, Open-Local, Open-Gpu-Share
  Score:   NodeResourcesBalancedAllocation(1), ImageLocality(1),
           InterPodAffinity(1), NodeResourcesLeastAllocated(1),
           NodeAffinity(1), NodePreferAvoidPods(10000),
           PodTopologySpread(2), TaintToleration(1), Simon(1),
           Open-Local(1), Open-Gpu-Share(1)
           (default registry algorithmprovider/registry.go:118-131 plus
           the three custom plugins appended by
           pkg/simulator/utils.go:229-241)

The volume plugins of the default profile (VolumeRestrictions,
NodeVolumeLimits, VolumeBinding, VolumeZone) are vacuous here because
MakeValidPod rewrites every PVC volume to a hostPath (pkg/utils/
utils.go:476-484), so no pod ever carries a PVC volume source.

Deviation from the reference (documented, deliberate): selectHost uses
reservoir sampling among top-score nodes (generic_scheduler.go:186-209,
rand.Intn) — by default we pin the deterministic first maximum in node
order so the oracle and the scan engine agree bit-for-bit. The opt-in
`select_host="sample"` mode reproduces the reference's reservoir
sampling algorithm with exact per-tie Intn consumption semantics
(utils/gorand.py ports Go math/rand, whose global source the reference
never seeds, i.e. the seed-1 stream); the stream itself is
bit-identical to Go's only when the rngCooked warm-up table is
supplied (SIMON_GO_RNG_COOKED — see gorand.py docstring).
tests/test_selecthost.py pins the measured first-max divergence on
tie-heavy clusters.

This oracle exists for conformance: the fused scan
(ops/fused_scan.py) must reproduce its placements exactly.
It is also the semantic documentation of every plugin formula.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from ..models import labels as lbl
from ..models import requests as req
from ..models import storage as stor
from ..obs.explain import EXPLAIN
from ..utils.memo import IdentityMemo

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0

# ImageLocality thresholds (vendor/.../imagelocality/image_locality.go)
_MB = 1024 * 1024
IMG_MIN_THRESHOLD = 23 * _MB
IMG_MAX_CONTAINER_THRESHOLD = 1000 * _MB

HARD_POD_AFFINITY_WEIGHT = 1  # interpodaffinity args default


# ---------------------------------------------------------------- node state


@dataclass
class GpuState:
    """Per-device GPU memory accounting (open-gpu-share GpuNodeInfo)."""

    count: int
    per_device_mem: int
    used: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.used:
            self.used = [0] * self.count

    def available(self) -> List[int]:
        return [self.per_device_mem - u for u in self.used]

    def allocatable_count(self) -> int:
        """Number of fully-idle devices (NodeGpuInfo.GpuAllocatable)."""
        return sum(1 for u in self.used if u == 0)

    def allocate_gpu_ids(self, per_gpu_mem: int, count: int) -> Optional[List[int]]:
        """AllocateGpuId (gpunodeinfo.go:232-291).

        1 GPU: tightest fit (min idle memory that still fits, lowest
        device id wins ties via strict '<' on idle memory).
        k GPUs: two-pointer greedy packing in device-id order.
        """
        if per_gpu_mem <= 0 or count <= 0:
            return None
        avail = self.available()
        if count == 1:
            best, best_mem = None, None
            for dev in range(self.count):
                idle = avail[dev]
                if idle >= per_gpu_mem:
                    if best is None or idle < best_mem:
                        best, best_mem = dev, idle
            return None if best is None else [best]
        out: List[int] = []
        dev = 0
        picked = 0
        while dev < self.count and picked < count:
            if avail[dev] >= per_gpu_mem:
                out.append(dev)
                avail[dev] -= per_gpu_mem
                picked += 1
            else:
                dev += 1
        return out if picked == count else None

    def commit(self, devs: List[int], per_gpu_mem: int):
        for d in devs:
            self.used[d] += per_gpu_mem


@dataclass
class NodeState:
    node: dict
    index: int
    pods: List[dict] = field(default_factory=list)
    # Requested (true requests) and NonZeroRequested (scoring defaults)
    req_mcpu: int = 0
    req_mem: int = 0
    req_eph: int = 0
    req_scalar: Dict[str, int] = field(default_factory=dict)
    nz_mcpu: int = 0
    nz_mem: int = 0
    # floor-semantics totals (PodRequestsAndLimits-based report code) —
    # kept alongside the ceil accounting so report/caps aggregation can
    # read node totals instead of re-walking 100k pods
    req_floor_mcpu: int = 0
    req_floor_mem: int = 0
    used_ports: set = field(default_factory=set)  # (ip, proto, port)
    gpu: Optional[GpuState] = None
    storage: Optional[stor.NodeStorage] = None
    # mutable allocatable (gpu-count is updated by the GPU plugin Reserve)
    alloc: Dict[str, Fraction] = field(default_factory=dict)
    # open-local allocations committed at bind, keyed by (namespace,
    # name) — recorded so preemption can reverse them exactly
    local_allocs: Dict[Tuple[str, str], tuple] = field(default_factory=dict)
    # copy-on-write: a pristine NodeState shares the decoded node dict
    # read-only; the ONLY binding-time node mutation is the open-local
    # storage annotation, which clones the metadata layers first via
    # own_node(). (An eager 4-dict clone per node cost ~40 ms per
    # Oracle at 10k nodes for runs that never touch storage.)
    owns_node: bool = False

    def own_node(self) -> dict:
        """Clone the node's metadata layers before the first
        annotation write, leaving the decoded source dict untouched
        (spec/status stay shared read-only, as before)."""
        if not self.owns_node:
            meta = self.node.get("metadata") or {}
            self.node = {
                **self.node,
                "metadata": {
                    **meta,
                    "labels": dict(meta.get("labels") or {}),
                    "annotations": dict(meta.get("annotations") or {}),
                },
            }
            self.owns_node = True
        return self.node

    @property
    def name(self) -> str:
        return (self.node.get("metadata") or {}).get("name", "")

    @property
    def labels(self) -> dict:
        return (self.node.get("metadata") or {}).get("labels") or {}

    def alloc_milli_cpu(self) -> int:
        v = self.alloc.get(req.CPU, Fraction(0)) * 1000
        return v.numerator // v.denominator

    def alloc_int(self, resource: str) -> int:
        v = self.alloc.get(resource, Fraction(0))
        return v.numerator // v.denominator


# per-source-node template memo (allocatable dict + GPU geometry):
# one identity-keyed lookup per add_node instead of three — the entry
# holds a strong ref to the node, so a key hit proves identity
# (utils/memo.py contract; registered with clear_all_memos below)
_NODE_TMPL_CACHE: dict = {}
_NODE_TMPL_CACHE_MAX = 1 << 17


def _node_template(node: dict):
    hit = _NODE_TMPL_CACHE.get(id(node))
    if hit is not None:
        return hit[1], hit[2], hit[3]
    alloc = req.node_allocatable(node)
    gpu_count = stor.node_gpu_count(node)
    per_dev = stor.node_gpu_per_device_memory(node) if gpu_count > 0 else 0
    if len(_NODE_TMPL_CACHE) >= _NODE_TMPL_CACHE_MAX:
        _NODE_TMPL_CACHE.clear()
    _NODE_TMPL_CACHE[id(node)] = (node, alloc, gpu_count, per_dev)
    return alloc, gpu_count, per_dev


def _register_node_tmpl_cache():
    from ..utils.memo import register_cache

    register_cache(_NODE_TMPL_CACHE.clear)


_register_node_tmpl_cache()


# replica clones share their containers list, so the port scan runs
# once per template instead of once per pod on the commit path
# (utils/memo.py contract); hostNetwork rides in the source tuple via
# its interned bool singleton
_PORTS_MEMO = IdentityMemo()


def _pod_host_ports(pod: dict) -> List[Tuple[str, str, int]]:
    spec = pod.get("spec") or {}
    host_net = bool(spec.get("hostNetwork"))
    return _PORTS_MEMO.get(
        (spec.get("containers"), host_net),
        lambda: _scan_host_ports(spec, host_net),
    )


def _scan_host_ports(spec: dict, host_net: bool) -> List[Tuple[str, str, int]]:
    out = []
    for c in spec.get("containers") or []:
        for p in c.get("ports") or []:
            port = p.get("hostPort")
            if not port and host_net:
                port = p.get("containerPort")
            if not port:
                continue
            ip = p.get("hostIP") or "0.0.0.0"
            proto = p.get("protocol") or "TCP"
            out.append((ip, proto, int(port)))
    return out


def _ports_conflict(want: List[Tuple[str, str, int]], used: set) -> bool:
    for ip, proto, port in want:
        for uip, uproto, uport in used:
            if uport != port or uproto != proto:
                continue
            if ip == "0.0.0.0" or uip == "0.0.0.0" or ip == uip:
                return True
    return False


# ------------------------------------------------------------------- oracle


def simple_commit_mask(batch, has_extenders: bool):
    """Per-CLASS mask of pods whose bind has no GPU/storage/extender
    side effects, so replay can use Oracle.commit_simple with a
    per-class ClassCommitCache instead of the general _reserve_and_bind
    (shared by engine.commit_host_at and applier.replay_scenario — the
    eligibility rule must stay identical in both)."""
    import numpy as np

    if has_extenders:
        return np.zeros(batch.u, bool)
    return (np.asarray(batch.gpu_mem) <= 0) & ~np.asarray(batch.wants_storage)


class ClassCommitCache:
    """(request summary, host-port tuple) per batch-scoped pod class —
    class members share request/port content by class-key construction
    (ops/encode.py:_class_key), so the walk runs once per class."""

    __slots__ = ("_info",)

    def __init__(self):
        self._info: Dict[int, tuple] = {}

    def commit(self, oracle: "Oracle", pod: dict, ns: "NodeState", cls: int):
        info = self._info.get(cls)
        if info is None:
            info = self._info[cls] = (
                req.pod_request_summary(pod),
                tuple(_pod_host_ports(pod)),
            )
        oracle.commit_simple(pod, ns, info[0], info[1])


@dataclass
class PreemptedPod:
    """One eviction performed by DefaultPreemption."""

    pod: dict
    node_name: str
    preemptor: str


class PostFilterContext:
    """The narrow cluster view handed to out-of-tree post_filter
    plugins (plugins.py SchedulerPlugin.post_filter): enough to
    implement a custom preemption policy without exposing oracle
    internals. Evictions are recorded exactly like DefaultPreemption's
    (the Simulator re-enqueues the victims; committed plugin state
    unreserves)."""

    def __init__(self, oracle: "Oracle", preemptor: dict):
        self._oracle = oracle
        self._preemptor = ((preemptor.get("metadata") or {}).get("name", ""))

    @property
    def nodes(self) -> List[dict]:
        return [ns.node for ns in self._oracle.nodes]

    def pods_on(self, node_name: str) -> List[dict]:
        idx = self._oracle.node_index.get(node_name)
        if idx is None:
            return []
        return list(self._oracle.nodes[idx].pods)

    def evict(self, pod: dict, node_name: str) -> None:
        idx = self._oracle.node_index.get(node_name)
        if idx is None:
            raise ValueError(f"unknown node {node_name!r}")
        ns = self._oracle.nodes[idx]
        if not any(p is pod for p in ns.pods):
            raise ValueError(
                f"pod {(pod.get('metadata') or {}).get('name', '')!r} "
                f"is not on node {node_name!r}"
            )
        self._oracle.evict_pod(ns, pod)
        self._oracle.preempted.append(
            PreemptedPod(pod=pod, node_name=node_name, preemptor=self._preemptor)
        )


class Oracle:
    """Serial scheduler over mutable node states."""

    def __init__(
        self,
        nodes: List[dict],
        registry=None,
        extenders=None,
        pdbs=None,
        priority_classes=None,
        enable_preemption: bool = True,
        score_weights=None,
        select_host: str = "first-max",
        rng=None,
    ):
        if registry is None:
            from .plugins import default_registry

            registry = default_registry
        self.registry = registry
        # score-plugin weights from an optional KubeSchedulerConfiguration
        # (schedconfig.py); None = the default profile
        from .schedconfig import DEFAULT_SCORE_WEIGHTS

        self.score_weights = (
            score_weights if score_weights is not None else DEFAULT_SCORE_WEIGHTS
        )
        # HTTP scheduler extenders (extender.py); host-side RPC, so a
        # simulation using them runs on this serial path only
        self.extenders = list(extenders or [])
        # DefaultPreemption inputs (scheduler/preemption.py)
        from .preemption import build_priority_resolver

        self.pdbs = list(pdbs or [])
        self._prio_resolver = build_priority_resolver(priority_classes or [])
        self.enable_preemption = enable_preemption
        # selectHost tie rule: "first-max" (default, deterministic,
        # scan-conformant) or "sample" (the reference's reservoir
        # sampling; `rng` must expose .intn(n), default GoRand(1) —
        # see module docstring deviation note)
        if select_host not in ("first-max", "sample"):
            raise ValueError(f"unknown select_host mode {select_host!r}")
        self.select_host = select_host
        if select_host == "sample" and rng is None:
            from ..utils.gorand import GoRand

            rng = GoRand(1)
        self._rng = rng
        # priority bookkeeping: commit sequence is the start-time proxy
        # for MoreImportantPod ties; _min_prio gates the preemption
        # attempt (a preemptor needs a strictly lower-priority pod to
        # exist at all, so the all-default-priority case pays nothing)
        self._seq_counter = 0
        self.commit_seq: Dict[Tuple[str, str], int] = {}
        self._min_prio = math.inf
        self.saw_priority = False
        self.preempted: List[PreemptedPod] = []
        # bumped whenever a node's mutable allocatable changes (GPU
        # Reserve adjusting gpu-count); TpuEngine keys its ClusterStatic
        # cache on this so stale allocatables never reach the scan
        self.alloc_epoch = 0
        self.nodes: List[NodeState] = []
        self.node_index: Dict[str, int] = {}
        # source (pre-clone) node dicts, in add order: the cross-run
        # ClusterStatic cache keys on their identities (encode.py
        # encode_cluster_cached) — strong refs per the IdentityMemo
        # contract, so a key hit proves the same objects
        self.source_nodes: List[dict] = []
        for n in nodes:
            self.add_node(n)
        # a fresh Oracle is a fresh scheduler run: stateful custom
        # plugins reset their per-run caches (plugins.py lifecycle)
        self.registry.begin_run(nodes)

    # -- priority helpers ---------------------------------------------------

    def pod_priority(self, pod: dict) -> int:
        return self._prio_resolver.priority(pod)

    def pod_preemption_policy(self, pod: dict) -> str:
        return self._prio_resolver.preemption_policy(pod)

    def commit_seq_of(self, pod: dict) -> int:
        meta = pod.get("metadata") or {}
        return self.commit_seq.get(
            (meta.get("namespace") or "default", meta.get("name", "")), 0
        )

    def drain_preempted(self) -> List[PreemptedPod]:
        out, self.preempted = self.preempted, []
        return out

    # -- cluster mutation ---------------------------------------------------

    def add_node(self, node: dict):
        # binding mutates ONLY node metadata annotations (storage VG
        # state via set_node_storage; gpu goes through ns.alloc) and
        # labels are report-read — so the decoded dict is shared
        # read-only and the metadata layers clone lazily on the FIRST
        # storage-annotation write (NodeState.own_node copy-on-write;
        # a full deepcopy of 10k nodes cost ~1 s per Oracle at bench
        # scale, the eager metadata clone still ~40 ms)
        self.source_nodes.append(node)
        ns = NodeState(node=node, index=len(self.nodes))
        alloc, gpu_count, per_dev = _node_template(node)
        if gpu_count > 0:
            # copy: GPU accounting writes ns.alloc[gpu-count]; non-GPU
            # nodes share the memoized allocatable read-only (no write
            # path touches ns.alloc when ns.gpu is None)
            ns.alloc = dict(alloc)
            ns.gpu = GpuState(count=gpu_count, per_device_mem=per_dev)
        else:
            ns.alloc = alloc
        ns.storage = stor.parse_node_storage(node)
        self.nodes.append(ns)
        self.node_index[ns.name] = ns.index

    def place_existing_pod(self, pod: dict):
        """Admit a pod that already has spec.nodeName (no scheduling).

        GPU accounting mirrors the reference cache build from running
        pods (open-gpu-share cache.AddOrUpdatePod): a pod carrying a
        gpu-index annotation charges those devices; one without an index
        gets devices allocated as AllocateGpuId would.
        """
        name = (pod.get("spec") or {}).get("nodeName")
        if name not in self.node_index:
            return
        ns = self.nodes[self.node_index[name]]
        gpu_mem, gpu_cnt = stor.pod_gpu_request(pod)
        if gpu_mem > 0 and ns.gpu is not None:
            anno = (pod.get("metadata") or {}).get("annotations") or {}
            idx = anno.get(stor.GPU_INDEX_ANNO)
            if idx:
                devs = [int(d) for d in str(idx).split("-") if str(d).isdigit()]
            else:
                devs = ns.gpu.allocate_gpu_ids(gpu_mem, gpu_cnt or 1)
                if devs:
                    # stamp the allocation so eviction (remove_pod_from_node)
                    # can release exactly these devices
                    pod.setdefault("metadata", {}).setdefault("annotations", {})[
                        stor.GPU_INDEX_ANNO
                    ] = "-".join(str(d) for d in devs)
            if devs:
                ns.gpu.commit(devs, gpu_mem)
                ns.alloc[stor.GPU_COUNT_ANNO] = Fraction(ns.gpu.allocatable_count())
                self.alloc_epoch += 1
        # stateful custom plugins hear about the pre-bound pod through
        # reserve with the veto ignored (the tracker adds it regardless
        # — same as the reference cache's informer ADD event); this
        # keeps their caches balanced with the unreserve on eviction
        for plugin in self.registry.plugins:
            plugin.reserve(pod, ns.node)
        self._commit(pod, ns)

    # -- the scheduling cycle ----------------------------------------------

    def schedule_pod(self, pod: dict) -> Tuple[Optional[str], str]:
        """One scheduleOne cycle. Returns (node_name, reason)."""
        from .extender import ExtenderError

        meta = pod.get("metadata") or {}
        if not self.saw_priority:
            from .preemption import pod_uses_priority

            if pod_uses_priority(pod, self._prio_resolver):
                self.saw_priority = True
        try:
            feasible, reasons, codes = self._find_feasible(pod)
        except ExtenderError as e:
            # a non-ignorable extender failure fails this pod's cycle
            # (scheduleOne error path), not the whole simulation
            return None, (
                f"failed to schedule pod ({meta.get('namespace', 'default')}/"
                f"{meta.get('name', '')}): {e}"
            )
        if not feasible:
            placed = self._post_filter_preempt(pod, codes)
            if placed is not None:
                return placed, ""
            return None, self._failure_message(pod, reasons)
        try:
            # the binder extender runs before any local mutation, so a
            # failure here leaves no partial commit
            best, rejecter = self._select_and_bind(pod, feasible)
        except ExtenderError as e:
            return None, (
                f"failed to bind pod ({meta.get('namespace', 'default')}/"
                f"{meta.get('name', '')}): {e}"
            )
        if rejecter is not None:
            # a plugin veto (permit/reserve/prebind) fails the cycle
            # outright (scheduler.go:536-553) — no retry on other nodes
            return None, (
                f"failed to schedule pod ({meta.get('namespace', 'default')}/"
                f"{meta.get('name', '')}): rejected by {rejecter}"
            )
        return best.name, ""

    def _select_and_bind(self, pod: dict, feasible: List[NodeState]):
        """prioritizeNodes + selectHost (first-max tie rule, see module
        docstring) + the Reserve/Permit/PreBind/Bind/PostBind sequence
        of scheduleOne (scheduler.go:457-620, custom-plugin hooks per
        interface.go:412-524). Returns (node, None) on success or
        (None, 'phase plugin "name"') on a plugin veto; any veto after
        Reserve unreserves in reverse order first. May raise
        ExtenderError from a binder extender."""
        from .extender import ExtenderError

        scores = self._prioritize(pod, feasible)
        best = feasible[0]
        best_score = scores[0]
        if self.select_host == "sample":
            # selectHost (generic_scheduler.go:186-209): keep a count of
            # max-score nodes seen; replace the candidate with
            # probability 1/count — one Intn per tie, same consumption
            # order as the reference
            cnt = 1
            for ns, sc in zip(feasible[1:], scores[1:]):
                if sc > best_score:
                    best, best_score = ns, sc
                    cnt = 1
                elif sc == best_score:
                    cnt += 1
                    if self._rng.intn(cnt) == 0:
                        best = ns
        else:
            for ns, sc in zip(feasible[1:], scores[1:]):
                if sc > best_score:
                    best, best_score = ns, sc
        if EXPLAIN.enabled and EXPLAIN.should_record(pod):
            # the exact weighted score vector selectHost just consumed
            EXPLAIN.record_scores(
                pod,
                [(ns.name, sc) for ns, sc in zip(feasible, scores)],
                best.name,
            )
        # custom Reserve plugins claim state first; any later veto rolls
        # them back in reverse order (framework.go RunReservePlugins*)
        reserved = []

        def unreserve_all():
            for p in reversed(reserved):
                p.unreserve(pod, best.node)

        for plugin in self.registry.plugins:
            if not plugin.reserve(pod, best.node):
                unreserve_all()
                return None, f'reserve plugin "{plugin.name}"'
            reserved.append(plugin)
        for plugin in self.registry.plugins:
            if not plugin.permit(pod, best.node):
                unreserve_all()
                return None, f'permit plugin "{plugin.name}"'
        for plugin in self.registry.plugins:
            if not plugin.prebind(pod, best.node):
                unreserve_all()
                return None, f'prebind plugin "{plugin.name}"'
        # custom Bind plugins (interface.go:499-524): first non-skip
        # verdict handles the bind; the simulator still records the
        # placement locally below (like binder extenders,
        # _reserve_and_bind) so the run keeps tracking it
        for plugin in self.registry.bind_plugins:
            verdict = plugin.bind(pod, best.node)
            if verdict == "success":
                break
            if verdict != "skip":
                unreserve_all()
                return None, f'bind plugin "{plugin.name}"'
        try:
            self._reserve_and_bind(pod, best)
        except ExtenderError:
            # a binder-extender failure aborts the bind after Reserve —
            # the framework runs Unreserve then (scheduler.go:597-608);
            # the caller (schedule_pod) attaches the extender's message
            # to the pod's unschedulable event ("failed to bind pod").
            # Anything else is an internal bug and stays loud: no
            # unreserve, the whole simulation dies with the traceback
            unreserve_all()
            raise
        for plugin in self.registry.plugins:
            plugin.postbind(pod, best.node)
        return best, None

    def _post_filter_preempt(self, pod: dict, codes: Dict[int, str]) -> Optional[str]:
        """DefaultPreemption PostFilter (registered by
        algorithmprovider/registry.go:106-109; logic in
        scheduler/preemption.py). On success the victims are evicted
        from their node, recorded in self.preempted (the Simulator
        re-enqueues them), and the preemptor is scheduled in a fresh
        retry cycle — the reference requeues the nominated pod and
        reruns scheduleOne (scheduler.go:320-369); with the victims
        gone the retry binds.
        """
        # out-of-tree PostFilter plugins run first, in registration
        # order; the first returning a node wins and the built-in
        # DefaultPreemption is skipped for this pod (the framework runs
        # PostFilter plugins until the first Success status). They run
        # even with preemption disabled — that switch disables the
        # DefaultPreemption plugin, not the PostFilter stage
        for plugin in self.registry.post_filter_plugins:
            nominated = plugin.post_filter(pod, PostFilterContext(self, pod))
            if nominated is not None:
                return self._retry_cycle(pod)
        if not self.enable_preemption:
            return None
        prio = self.pod_priority(pod)
        # a victim must have strictly lower priority than the preemptor;
        # when nothing committed is lower, skip the whole dry run
        if not (prio > self._min_prio):
            return None
        from .extender import ExtenderError
        from .preemption import run_preemption

        try:
            result = run_preemption(self, pod, codes)
        except ExtenderError:
            # non-ignorable preempt-verb extender failure: the PostFilter
            # returns an error status and the pod stays unschedulable
            # (CallExtenders error path, default_preemption.go:146-149)
            return None
        if result is None:
            return None
        preemptor = (pod.get("metadata") or {}).get("name", "")
        ns = self.nodes[result.node_index]
        for victim in result.victims:
            self.evict_pod(ns, victim)
            self.preempted.append(
                PreemptedPod(pod=victim, node_name=ns.name, preemptor=preemptor)
            )
        if EXPLAIN.enabled and EXPLAIN.should_record(pod):
            # namespace-qualified victims: the JSON payload's structured
            # `preemption` block (explain.as_dict) is citable by the
            # shadow auditor's ordering-divergence class
            EXPLAIN.annotate(
                pod,
                preemption_node=ns.name,
                preempted=[
                    "%s/%s"
                    % (
                        (v.get("metadata") or {}).get("namespace") or "default",
                        (v.get("metadata") or {}).get("name", ""),
                    )
                    for v in result.victims
                ],
            )
        # retry cycle: with victims evicted the pod fits on the
        # nominated node (it may score another feasible node higher —
        # same as the reference's fresh scheduleOne after requeue).
        # Victims stay evicted even if the retry fails (the reference
        # likewise never restores PrepareCandidate's deletions); an
        # extender error here fails this pod's cycle, not the run.
        return self._retry_cycle(pod)

    def _retry_cycle(self, pod: dict):
        """Fresh filter+score+bind cycle after a PostFilter mutated the
        cluster (built-in preemption or a custom post_filter plugin).
        The nominated node is not forced: the fresh cycle may pick any
        feasible node, like the reference's re-queued scheduleOne."""
        from .extender import ExtenderError

        try:
            feasible, _, _ = self._find_feasible(pod)
            if not feasible:
                return None
            best, rejecter = self._select_and_bind(pod, feasible)
        except ExtenderError:
            return None
        if rejecter is not None:
            return None
        return best.name

    # -- filters ------------------------------------------------------------

    # Per-node failure codes mirror framework.Status codes: a node
    # rejected "unresolvable" (UnschedulableAndUnresolvable) cannot be
    # helped by preemption (nodesWherePreemptionMightHelp,
    # default_preemption.go:259-271). Sources: nodeunschedulable/
    # nodename/nodeaffinity/tainttoleration filters, PodTopologySpread
    # missing-topology-key (filtering.go:298), InterPodAffinity required
    # affinity rules (filtering.go:389).

    def _pod_filter_ctx(self, pod: dict) -> dict:
        """Pod-level filter inputs that do not depend on cluster state."""
        gpu_mem, gpu_cnt = stor.pod_gpu_request(pod)
        lvm_vols, dev_vols = stor.parse_pod_local_volumes(pod)
        return {
            "spec": pod.get("spec") or {},
            "pod_req": req.pod_requests(pod),
            "want_ports": _pod_host_ports(pod),
            "lvm_vols": lvm_vols,
            "dev_vols": dev_vols,
            "gpu_mem": gpu_mem,
            "gpu_cnt": gpu_cnt,
            "gpu_mem_total": stor.pod_gpu_memory(pod),
        }

    def _prefilter(self, pod: dict) -> dict:
        """Cluster-state-dependent PreFilter states (recomputed after
        any mutation — the preemption dry run relies on this instead of
        the reference's incremental AddPod/RemovePod extensions)."""
        return {
            "topo": self._topology_spread_prefilter(pod),
            "ipa": self._interpod_prefilter(pod),
        }

    def _check_node(self, pod: dict, ctx: dict, pre: dict, ns: NodeState):
        """All framework filters against one node. Returns None when the
        node is feasible, else (reason, code)."""
        spec = ctx["spec"]
        node = ns.node
        nspec = node.get("spec") or {}
        # NodeUnschedulable
        if nspec.get("unschedulable") and not lbl.tolerations_tolerate_taint(
            spec.get("tolerations") or [],
            {"key": "node.kubernetes.io/unschedulable", "effect": "NoSchedule"},
        ):
            return "node(s) were unschedulable", "unresolvable"
        # NodeName
        if spec.get("nodeName") and spec["nodeName"] != ns.name:
            return "node(s) didn't match the requested hostname", "unresolvable"
        # TaintToleration
        taint = lbl.find_untolerated_taint(
            nspec.get("taints") or [], spec.get("tolerations") or []
        )
        if taint is not None:
            return (
                "node(s) had taint {%s: %s}, that the pod didn't tolerate"
                % (taint.get("key", ""), taint.get("value", "")),
                "unresolvable",
            )
        # NodeAffinity
        if not lbl.pod_matches_node_selector_and_affinity(spec, node):
            return "node(s) didn't match node selector", "unresolvable"
        # NodePorts
        if _ports_conflict(ctx["want_ports"], ns.used_ports):
            return (
                "node(s) didn't have free ports for the requested pod ports",
                "unschedulable",
            )
        # NodeResourcesFit
        r = self._fits_resources(ctx["pod_req"], ns)
        if r:
            return r, "unschedulable"
        # PodTopologySpread
        r = self._topology_spread_filter(pod, pre["topo"], ns)
        if r:
            return "node(s) didn't match pod topology spread constraints", r
        # InterPodAffinity
        r = self._interpod_filter(pod, pre["ipa"], ns)
        if r:
            code = (
                "unresolvable"
                if r == "node(s) didn't match pod affinity rules"
                else "unschedulable"
            )
            return r, code
        # Open-Local
        r = self._open_local_filter(ctx["lvm_vols"], ctx["dev_vols"], ns)
        if r:
            return r, "unschedulable"
        # Open-Gpu-Share
        if ctx["gpu_mem_total"] > 0:
            if ns.gpu is None or ns.gpu.count * ns.gpu.per_device_mem < ctx["gpu_mem_total"]:
                return "Insufficient GPU memory", "unschedulable"
            if ns.gpu.allocate_gpu_ids(ctx["gpu_mem"], ctx["gpu_cnt"]) is None:
                return "No GPU device can fit the pod", "unschedulable"
        # out-of-tree custom plugins (stateless filter contract)
        for plugin in self.registry.plugins:
            if not plugin.filter(pod, ns.node):
                return f"node(s) didn't pass plugin {plugin.name}", "unschedulable"
        return None

    def _find_feasible(self, pod: dict):
        ctx = self._pod_filter_ctx(pod)
        pre = self._prefilter(pod)

        feasible = []
        reasons: Dict[str, int] = {}
        codes: Dict[int, str] = {}
        # flight-recorder hook (--explain): keep every node's verdict,
        # not just the aggregate counts — one attribute read when off
        explain = EXPLAIN.enabled and EXPLAIN.should_record(pod)
        verdicts = [] if explain else None

        def fail(reason: str):
            reasons[reason] = reasons.get(reason, 0) + 1

        for ns in self.nodes:
            r = self._check_node(pod, ctx, pre, ns)
            if r is None:
                feasible.append(ns)
                if explain:
                    verdicts.append((ns.name, None, "feasible"))
                continue
            reason, code = r
            fail(reason)
            codes[ns.index] = code
            if explain:
                verdicts.append((ns.name, reason, code))
        if self.extenders:
            from .extender import filter_with_extenders

            before = {ns.index for ns in feasible}
            on_node_fail = None
            if explain:
                # the verdict row gets the extender's ACTUAL per-node
                # message — the same string `fail` just aggregated —
                # so the explain block's failure message stays equal
                # to the report's (verdict rows parallel self.nodes)
                def on_node_fail(name, msg):
                    idx = self.node_index.get(name)
                    if idx is not None:
                        verdicts[idx] = (name, msg, "unschedulable")

            feasible = filter_with_extenders(
                self.extenders, pod, feasible, fail, on_node_fail=on_node_fail
            )
            for idx in before - {ns.index for ns in feasible}:
                codes[idx] = "unschedulable"
                if explain and verdicts[idx][1] is None:
                    # dropped without a message: keep reason None so
                    # the aggregate counts still mirror `fail` exactly;
                    # the status code alone records the drop
                    verdicts[idx] = (verdicts[idx][0], None, "unschedulable")
        if explain:
            EXPLAIN.record_filter(pod, verdicts, len(feasible))
        return feasible, reasons, codes

    def passes_filters_on_node(self, pod: dict, ns: NodeState, ctx=None) -> bool:
        """PodPassesFiltersOnNode for the preemption dry run: framework
        filters only (extenders join preemption via ProcessPreemption —
        preemption.run_preemption calls them over the finished candidate
        map, not per dry-run node), with PreFilter state recomputed against current
        cluster state. `ctx` (state-independent, from _pod_filter_ctx)
        may be precomputed by the caller and reused across calls."""
        if ctx is None:
            ctx = self._pod_filter_ctx(pod)
        pre = self._prefilter(pod)
        return self._check_node(pod, ctx, pre, ns) is None

    def _fits_resources(self, pod_req: dict, ns: NodeState) -> Optional[str]:
        """fitsRequest (noderesources/fit.go:230-303)."""
        allowed_pods = ns.alloc_int(req.PODS)
        if len(ns.pods) + 1 > allowed_pods:
            return "Too many pods"
        mcpu = pod_req.get(req.CPU, Fraction(0)) * 1000
        mcpu = -((-mcpu.numerator) // mcpu.denominator)
        mem = pod_req.get(req.MEMORY, Fraction(0))
        mem = -((-mem.numerator) // mem.denominator)
        eph = pod_req.get(req.EPHEMERAL, Fraction(0))
        eph = -((-eph.numerator) // eph.denominator)
        scalars = {
            name: v
            for name, v in pod_req.items()
            if name not in (req.CPU, req.MEMORY, req.EPHEMERAL, req.PODS)
            and req.is_scalar_resource(name)
        }
        if mcpu == 0 and mem == 0 and eph == 0 and not scalars:
            return None
        if ns.alloc_milli_cpu() < mcpu + ns.req_mcpu:
            return "Insufficient cpu"
        if ns.alloc_int(req.MEMORY) < mem + ns.req_mem:
            return "Insufficient memory"
        if ns.alloc_int(req.EPHEMERAL) < eph + ns.req_eph:
            return "Insufficient ephemeral-storage"
        for name, v in scalars.items():
            iv = -((-v.numerator) // v.denominator)
            if ns.alloc_int(name) < iv + ns.req_scalar.get(name, 0):
                return f"Insufficient {name}"
        return None

    # -- topology spread ----------------------------------------------------

    def _hard_spread_constraints(self, pod: dict) -> list:
        out = []
        for c in (pod.get("spec") or {}).get("topologySpreadConstraints") or []:
            if c.get("whenUnsatisfiable", "DoNotSchedule") == "DoNotSchedule":
                out.append(c)
        return out

    def _soft_spread_constraints(self, pod: dict) -> list:
        return [
            c
            for c in (pod.get("spec") or {}).get("topologySpreadConstraints") or []
            if c.get("whenUnsatisfiable") == "ScheduleAnyway"
        ]

    def _count_matching_pods(self, ns: NodeState, selector, namespace: str) -> int:
        """countPodsMatchSelector: same namespace, selector match, not
        terminating (we have no deletion timestamps)."""
        n = 0
        for p in ns.pods:
            pm = p.get("metadata") or {}
            if (pm.get("namespace") or "default") != namespace:
                continue
            if lbl.match_labels_selector(selector, pm.get("labels") or {}):
                n += 1
        return n

    def _topology_spread_prefilter(self, pod: dict):
        """calPreFilterState (podtopologyspread/filtering.go:197-275)."""
        constraints = self._hard_spread_constraints(pod)
        if not constraints:
            return None
        namespace = (pod.get("metadata") or {}).get("namespace") or "default"
        spec = pod.get("spec") or {}
        # candidate topology domains: nodes passing nodeSelector/affinity
        # and having every constraint topology key
        counts: List[Dict[str, int]] = [dict() for _ in constraints]
        for ns in self.nodes:
            node = ns.node
            if not lbl.pod_matches_node_selector_and_affinity(spec, node):
                continue
            nl = ns.labels
            if not all(c.get("topologyKey", "") in nl for c in constraints):
                continue
            for i, c in enumerate(constraints):
                counts[i].setdefault(nl[c["topologyKey"]], 0)
        for ns in self.nodes:
            nl = ns.labels
            for i, c in enumerate(constraints):
                key = c.get("topologyKey", "")
                if key not in nl or nl[key] not in counts[i]:
                    continue
                counts[i][nl[key]] += self._count_matching_pods(
                    ns, c.get("labelSelector"), namespace
                )
        min_counts = [min(v.values()) if v else 0 for v in counts]
        return constraints, counts, min_counts

    def _topology_spread_filter(self, pod: dict, state, ns: NodeState) -> Optional[str]:
        """Returns None (feasible) or the failure code: a missing
        topology key is UnschedulableAndUnresolvable (filtering.go:298),
        a skew violation plain Unschedulable (filtering.go:330)."""
        if state is None:
            return None
        constraints, counts, min_counts = state
        meta = pod.get("metadata") or {}
        pod_labels = meta.get("labels") or {}
        nl = ns.labels
        for i, c in enumerate(constraints):
            key = c.get("topologyKey", "")
            if key not in nl:
                return "unresolvable"
            self_match = 1 if lbl.match_labels_selector(c.get("labelSelector"), pod_labels) else 0
            match_num = counts[i].get(nl[key], 0)
            skew = match_num + self_match - min_counts[i]
            if skew > int(c.get("maxSkew", 1)):
                return "unschedulable"
        return None

    # -- interpod affinity --------------------------------------------------

    def _interpod_prefilter(self, pod: dict):
        """PreFilter (interpodaffinity/filtering.go:241-275): three
        topology-pair count maps."""
        req_aff = lbl.resolve_affinity_terms(
            pod, "podAffinity", "requiredDuringSchedulingIgnoredDuringExecution"
        )
        req_anti = lbl.resolve_affinity_terms(
            pod, "podAntiAffinity", "requiredDuringSchedulingIgnoredDuringExecution"
        )
        # existing pods' required anti-affinity vs the incoming pod
        existing_anti: Dict[Tuple[str, str], int] = {}
        for ns in self.nodes:
            nl = ns.labels
            for p in ns.pods:
                for term in lbl.resolve_affinity_terms(
                    p, "podAntiAffinity", "requiredDuringSchedulingIgnoredDuringExecution"
                ):
                    if term.matches_pod(pod) and term.topology_key in nl:
                        pair = (term.topology_key, nl[term.topology_key])
                        existing_anti[pair] = existing_anti.get(pair, 0) + 1
        # incoming pod's terms vs existing pods
        aff_counts: Dict[Tuple[str, str], int] = {}
        anti_counts: Dict[Tuple[str, str], int] = {}
        for ns in self.nodes:
            nl = ns.labels
            for p in ns.pods:
                # affinity: pod must match ALL terms to count
                if req_aff and all(t.matches_pod(p) for t in req_aff):
                    for t in req_aff:
                        if t.topology_key in nl:
                            pair = (t.topology_key, nl[t.topology_key])
                            aff_counts[pair] = aff_counts.get(pair, 0) + 1
                for t in req_anti:
                    if t.matches_pod(p) and t.topology_key in nl:
                        pair = (t.topology_key, nl[t.topology_key])
                        anti_counts[pair] = anti_counts.get(pair, 0) + 1
        return req_aff, req_anti, existing_anti, aff_counts, anti_counts

    def _interpod_filter(self, pod: dict, state, ns: NodeState) -> Optional[str]:
        req_aff, req_anti, existing_anti, aff_counts, anti_counts = state
        nl = ns.labels
        # satisfyPodAffinity
        if req_aff:
            pods_exist = True
            for t in req_aff:
                if t.topology_key not in nl:
                    return "node(s) didn't match pod affinity rules"
                if aff_counts.get((t.topology_key, nl[t.topology_key]), 0) <= 0:
                    pods_exist = False
            if not pods_exist:
                # bootstrap: no matching pod anywhere and the pod matches
                # its own affinity terms
                if not (not aff_counts and all(t.matches_pod(pod) for t in req_aff)):
                    return "node(s) didn't match pod affinity rules"
        # satisfyPodAntiAffinity
        for t in req_anti:
            if t.topology_key in nl and anti_counts.get((t.topology_key, nl[t.topology_key]), 0) > 0:
                return "node(s) didn't match pod anti-affinity rules"
        # satisfyExistingPodsAntiAffinity
        if existing_anti:
            for k, v in nl.items():
                if existing_anti.get((k, v), 0) > 0:
                    return "node(s) didn't satisfy existing pods anti-affinity rules"
        return None

    # -- open-local ---------------------------------------------------------

    def _lvm_fit(self, lvm_vols, storage: stor.NodeStorage) -> Optional[list]:
        """ProcessLVMPVCPredicate/Priority with the Binpack strategy:
        tightest VG first. Returns allocation [(vg_index, size)] or None.

        Our pod volumes never carry an explicit VG (the reference's
        simon/pod-local-storage volumes don't either), so only the
        without-VG path matters.
        """
        free = [vg.capacity - vg.requested for vg in storage.vgs]
        if not storage.vgs:
            return None
        out = []
        for vol in lvm_vols:
            order = sorted(range(len(free)), key=lambda i: free[i])
            placed = False
            for i in order:
                if free[i] >= vol.size:
                    free[i] -= vol.size
                    out.append((i, vol.size))
                    placed = True
                    break
            if not placed:
                return None
        return out

    def _device_fit(self, dev_vols, storage: stor.NodeStorage) -> Optional[list]:
        """ProcessDevicePVC: SSD then HDD; volumes ascending by size
        against free devices ascending by capacity. Returns [(device
        index in storage.devices, size)] or None."""
        out = []
        for media in ("ssd", "hdd"):
            vols = sorted(
                [v for v in dev_vols if v.kind.lower() == media], key=lambda v: v.size
            )
            if not vols:
                continue
            devs = [
                (i, d)
                for i, d in enumerate(storage.devices)
                if not d.is_allocated and d.media_type == media
            ]
            if len(devs) < len(vols):
                return None
            devs.sort(key=lambda t: t[1].capacity)
            vi = 0
            for j, (idx, d) in enumerate(devs):
                if vi >= len(vols):
                    break
                if d.capacity < vols[vi].size:
                    if j == len(devs) - 1:
                        return None
                    continue
                out.append((idx, vols[vi].size))
                vi += 1
            if vi < len(vols):
                return None
        return out

    def _open_local_filter(self, lvm_vols, dev_vols, ns: NodeState) -> Optional[str]:
        if not lvm_vols and not dev_vols:
            return None
        if ns.storage is None:
            return "no local storage on node"
        if lvm_vols and self._lvm_fit(lvm_vols, ns.storage) is None:
            return "not enough LVM storage"
        if dev_vols and self._device_fit(dev_vols, ns.storage) is None:
            return "not enough device storage"
        return None

    # -- scoring ------------------------------------------------------------

    def _prioritize(self, pod: dict, feasible: List[NodeState]) -> List[int]:
        """prioritizeNodes: per-plugin score + normalize + weighted sum
        (generic_scheduler.go:470-566)."""
        total = [0] * len(feasible)

        def add(scores: List[int], weight: int):
            for i, s in enumerate(scores):
                total[i] += s * weight

        w = self.score_weights
        if w.balanced:
            add(self._score_balanced_allocation(pod, feasible), w.balanced)
        if w.image:
            add(self._score_image_locality(pod, feasible), w.image)
        if w.ipa:
            add(self._score_interpod_affinity(pod, feasible), w.ipa)
        if w.least:
            add(self._score_least_allocated(pod, feasible), w.least)
        if w.nodeaff:
            add(self._score_node_affinity(pod, feasible), w.nodeaff)
        if w.avoid:
            add(self._score_prefer_avoid_pods(pod, feasible), w.avoid)
        if w.spread:
            add(self._score_topology_spread(pod, feasible), w.spread)
        if w.tainttol:
            add(self._score_taint_toleration(pod, feasible), w.tainttol)
        if w.simon:
            add(self._score_simon(pod, feasible), w.simon)
        if w.openlocal:
            add(self._score_open_local(pod, feasible), w.openlocal)
        if w.gpushare:
            add(self._score_gpu_share(pod, feasible), w.gpushare)
        for plugin in self.registry.plugins:
            raw = [int(plugin.score(pod, ns.node)) for ns in feasible]
            if plugin.normalize == "default":
                raw = self._default_normalize(raw, reverse=False)
            elif plugin.normalize == "reverse":
                raw = self._default_normalize(raw, reverse=True)
            elif plugin.normalize == "minmax":
                raw = self._minmax_normalize(raw)
            add(raw, plugin.weight)
        if self.extenders:
            from .extender import extender_scores

            add(extender_scores(self.extenders, pod, feasible), 1)
        return total

    @staticmethod
    def _default_normalize(scores: List[int], reverse: bool) -> List[int]:
        max_count = max(scores) if scores else 0
        if max_count == 0:
            return [MAX_NODE_SCORE if reverse else 0 for _ in scores]
        out = []
        for s in scores:
            v = MAX_NODE_SCORE * s // max_count
            out.append(MAX_NODE_SCORE - v if reverse else v)
        return out

    @staticmethod
    def _minmax_normalize(scores: List[int]) -> List[int]:
        """Simon/Open-Local/Open-Gpu-Share NormalizeScore
        (simon.go:75-100): min-max rescale, all-equal -> MinNodeScore."""
        if not scores:
            return scores
        hi, lo = max(scores), min(scores)
        old_range = hi - lo
        if old_range == 0:
            return [MIN_NODE_SCORE for _ in scores]
        return [
            (s - lo) * (MAX_NODE_SCORE - MIN_NODE_SCORE) // old_range + MIN_NODE_SCORE
            for s in scores
        ]

    def _score_balanced_allocation(self, pod: dict, feasible) -> List[int]:
        cpu_req = req.pod_nonzero_request(pod, req.CPU)
        mem_req = req.pod_nonzero_request(pod, req.MEMORY)
        out = []
        for ns in feasible:
            cpu_alloc = ns.alloc_milli_cpu()
            mem_alloc = ns.alloc_int(req.MEMORY)
            cpu_frac = (ns.nz_mcpu + cpu_req) / cpu_alloc if cpu_alloc else 1.0
            mem_frac = (ns.nz_mem + mem_req) / mem_alloc if mem_alloc else 1.0
            if cpu_frac >= 1 or mem_frac >= 1:
                out.append(0)
                continue
            out.append(int((1 - abs(cpu_frac - mem_frac)) * MAX_NODE_SCORE))
        return out

    def _score_least_allocated(self, pod: dict, feasible) -> List[int]:
        cpu_req = req.pod_nonzero_request(pod, req.CPU)
        mem_req = req.pod_nonzero_request(pod, req.MEMORY)
        out = []
        for ns in feasible:
            cpu_alloc = ns.alloc_milli_cpu()
            mem_alloc = ns.alloc_int(req.MEMORY)

            def least(requested, capacity):
                if capacity == 0 or requested > capacity:
                    return 0
                return (capacity - requested) * MAX_NODE_SCORE // capacity

            s = least(ns.nz_mcpu + cpu_req, cpu_alloc) + least(ns.nz_mem + mem_req, mem_alloc)
            out.append(s // 2)
        return out

    def _score_image_locality(self, pod: dict, feasible) -> List[int]:
        containers = (pod.get("spec") or {}).get("containers") or []
        if not containers:
            return [0] * len(feasible)
        total_nodes = len(self.nodes)
        wanted = set()
        for c in containers:
            name = c.get("image", "")
            if ":" not in name.rsplit("/", 1)[-1]:
                name = name + ":latest"
            wanted.add(name)
        # image -> number of nodes having it (ImageStateSummary.NumNodes),
        # computed once per cycle rather than per candidate node
        spread: Dict[str, int] = {w: 0 for w in wanted}
        for ns in self.nodes:
            seen = set()
            for img in ((ns.node.get("status") or {}).get("images")) or []:
                for n in img.get("names") or []:
                    if n in wanted and n not in seen:
                        spread[n] += 1
                        seen.add(n)
        out = []
        for ns in feasible:
            images = {}
            for img in ((ns.node.get("status") or {}).get("images")) or []:
                size = int(img.get("sizeBytes", 0))
                for name in img.get("names") or []:
                    if name in wanted:
                        images[name] = size
            s = 0
            for c in containers:
                name = c.get("image", "")
                if ":" not in name.rsplit("/", 1)[-1]:
                    name = name + ":latest"
                if name in images:
                    s += int(images[name] * (spread[name] / total_nodes))
            max_threshold = IMG_MAX_CONTAINER_THRESHOLD * len(containers)
            s = min(max(s, IMG_MIN_THRESHOLD), max_threshold)
            out.append(MAX_NODE_SCORE * (s - IMG_MIN_THRESHOLD) // (max_threshold - IMG_MIN_THRESHOLD))
        return out

    def _score_node_affinity(self, pod: dict, feasible) -> List[int]:
        raw = [lbl.preferred_node_affinity_score(pod.get("spec") or {}, ns.node) for ns in feasible]
        return self._default_normalize(raw, reverse=False)

    def _score_taint_toleration(self, pod: dict, feasible) -> List[int]:
        tolerations = (pod.get("spec") or {}).get("tolerations") or []
        raw = [
            lbl.count_intolerable_prefer_no_schedule(
                (ns.node.get("spec") or {}).get("taints") or [], tolerations
            )
            for ns in feasible
        ]
        return self._default_normalize(raw, reverse=True)

    def _score_prefer_avoid_pods(self, pod: dict, feasible) -> List[int]:
        """NodePreferAvoidPods: 0 when the node's
        scheduler.alpha.kubernetes.io/preferAvoidPods annotation matches
        the pod's RC/RS controller, else 100."""
        refs = (pod.get("metadata") or {}).get("ownerReferences") or []
        ctrl = next((r for r in refs if r.get("controller")), None)
        if ctrl is not None and ctrl.get("kind") not in ("ReplicationController", "ReplicaSet"):
            ctrl = None
        out = []
        for ns in feasible:
            if ctrl is None:
                out.append(MAX_NODE_SCORE)
                continue
            anno = (ns.node.get("metadata") or {}).get("annotations") or {}
            raw = anno.get("scheduler.alpha.kubernetes.io/preferAvoidPods")
            avoided = False
            if raw:
                import json as _json

                try:
                    avoids = _json.loads(raw)
                    for item in avoids.get("preferAvoidPods") or []:
                        pc = ((item.get("podSignature") or {}).get("podController")) or {}
                        if pc.get("kind") == ctrl.get("kind") and (
                            not pc.get("uid") or pc.get("uid") == ctrl.get("uid")
                        ):
                            avoided = True
                except (ValueError, AttributeError):
                    avoided = False
            out.append(0 if avoided else MAX_NODE_SCORE)
        return out

    def _score_topology_spread(self, pod: dict, feasible) -> List[int]:
        """PodTopologySpread PreScore/Score/NormalizeScore
        (podtopologyspread/scoring.go)."""
        constraints = self._soft_spread_constraints(pod)
        if not constraints:
            # empty state: every node normalizes to MaxNodeScore
            return [MAX_NODE_SCORE] * len(feasible)
        namespace = (pod.get("metadata") or {}).get("namespace") or "default"
        spec = pod.get("spec") or {}
        # candidate domains from FEASIBLE nodes; ignored = feasible nodes
        # missing a topology key
        ignored = set()
        pair_counts: List[Dict[str, int]] = [dict() for _ in constraints]
        topo_size = [0] * len(constraints)
        for ns in feasible:
            nl = ns.labels
            if not all(c.get("topologyKey", "") in nl for c in constraints):
                ignored.add(ns.index)
                continue
            for i, c in enumerate(constraints):
                key = c["topologyKey"]
                if key == "kubernetes.io/hostname":
                    continue
                val = nl[key]
                if val not in pair_counts[i]:
                    pair_counts[i][val] = 0
                    topo_size[i] += 1
        weights = []
        for i, c in enumerate(constraints):
            sz = topo_size[i]
            if c.get("topologyKey") == "kubernetes.io/hostname":
                sz = len(feasible) - len(ignored)
            weights.append(math.log(sz + 2))
        # count matching pods over ALL nodes that qualify
        for ns in self.nodes:
            nl = ns.labels
            if not lbl.pod_matches_node_selector_and_affinity(spec, ns.node):
                continue
            if not all(c.get("topologyKey", "") in nl for c in constraints):
                continue
            for i, c in enumerate(constraints):
                key = c["topologyKey"]
                if key == "kubernetes.io/hostname":
                    continue
                val = nl[key]
                if val in pair_counts[i]:
                    pair_counts[i][val] += self._count_matching_pods(
                        ns, c.get("labelSelector"), namespace
                    )
        raw = []
        for ns in feasible:
            if ns.index in ignored:
                raw.append(-1)  # invalidScore marker
                continue
            score = 0.0
            nl = ns.labels
            for i, c in enumerate(constraints):
                key = c.get("topologyKey", "")
                if key in nl:
                    if key == "kubernetes.io/hostname":
                        cnt = self._count_matching_pods(ns, c.get("labelSelector"), namespace)
                    else:
                        cnt = pair_counts[i].get(nl[key], 0)
                    score += cnt * weights[i] + (int(c.get("maxSkew", 1)) - 1)
            raw.append(int(score))
        # normalize
        valid = [s for s in raw if s != -1]
        if not valid:
            return [0] * len(feasible)
        min_s, max_s = min(valid), max(valid)
        out = []
        for s in raw:
            if s == -1:
                out.append(0)
            elif max_s == 0:
                out.append(MAX_NODE_SCORE)
            else:
                out.append(MAX_NODE_SCORE * (max_s + min_s - s) // max_s)
        return out

    def _score_interpod_affinity(self, pod: dict, feasible) -> List[int]:
        """InterPodAffinity PreScore/Score/NormalizeScore
        (interpodaffinity/scoring.go)."""
        pref_aff = lbl.resolve_affinity_terms(
            pod, "podAffinity", "preferredDuringSchedulingIgnoredDuringExecution"
        )
        pref_anti = lbl.resolve_affinity_terms(
            pod, "podAntiAffinity", "preferredDuringSchedulingIgnoredDuringExecution"
        )
        topo_score: Dict[Tuple[str, str], int] = {}

        def bump(term: lbl.AffinityTerm, target: dict, node_labels: dict, mult: int):
            if not node_labels:
                return
            if term.matches_pod(target) and term.topology_key in node_labels:
                pair = (term.topology_key, node_labels[term.topology_key])
                topo_score[pair] = topo_score.get(pair, 0) + term.weight * mult

        for ns in self.nodes:
            nl = ns.labels
            for existing in ns.pods:
                for t in pref_aff:
                    bump(t, existing, nl, 1)
                for t in pref_anti:
                    bump(t, existing, nl, -1)
                for t in lbl.resolve_affinity_terms(
                    existing, "podAffinity", "requiredDuringSchedulingIgnoredDuringExecution"
                ):
                    t2 = lbl.AffinityTerm(
                        t.selector, t.topology_key, t.namespaces, HARD_POD_AFFINITY_WEIGHT
                    )
                    bump(t2, pod, nl, 1)
                for t in lbl.resolve_affinity_terms(
                    existing, "podAffinity", "preferredDuringSchedulingIgnoredDuringExecution"
                ):
                    bump(t, pod, nl, 1)
                for t in lbl.resolve_affinity_terms(
                    existing, "podAntiAffinity", "preferredDuringSchedulingIgnoredDuringExecution"
                ):
                    bump(t, pod, nl, -1)
        raw = []
        for ns in feasible:
            s = 0
            for (key, val), v in topo_score.items():
                if ns.labels.get(key) == val:
                    s += v
            raw.append(s)
        if not topo_score:
            return [0] * len(feasible)
        max_c = max(max(raw), 0)
        min_c = min(min(raw), 0)
        diff = max_c - min_c
        out = []
        for s in raw:
            if diff > 0:
                # float64(100) * (float64(s-min) / float64(diff)), as
                # scoring.go NormalizeScore orders it
                out.append(int(MAX_NODE_SCORE * ((s - min_c) / diff)))
            else:
                out.append(0)
        return out

    def _simon_raw(self, pod: dict, ns: NodeState) -> int:
        """Simon plugin Score (plugin/simon.go:44-67): max over node
        allocatable resources of share(podReq, alloc - podReq)."""
        requests = req.pod_requests(pod)
        limits = req.pod_limits(pod)
        if not requests and not limits:
            return MAX_NODE_SCORE
        res = 0.0
        for name, alloc in ns.alloc.items():
            pr = float(requests.get(name, Fraction(0)))
            avail = float(alloc) - pr
            if avail == 0:
                share = 0.0 if pr == 0 else 1.0
            else:
                share = pr / avail
            if share > res:
                res = share
        return int((MAX_NODE_SCORE - MIN_NODE_SCORE) * res)

    def _score_simon(self, pod: dict, feasible) -> List[int]:
        raw = [self._simon_raw(pod, ns) for ns in feasible]
        return self._minmax_normalize(raw)

    def _score_gpu_share(self, pod: dict, feasible) -> List[int]:
        # identical formula to Simon (open-gpu-share.go:84-109)
        raw = [self._simon_raw(pod, ns) for ns in feasible]
        return self._minmax_normalize(raw)

    def _score_open_local(self, pod: dict, feasible) -> List[int]:
        """Open-Local Score (open-local.go:93-137): ScoreLVM (binpack:
        sum used/capacity over touched VGs / count * 10) + ScoreDevice
        (sum requested/allocated / count * 10), then min-max normalized."""
        lvm_vols, dev_vols = stor.parse_pod_local_volumes(pod)
        raw = []
        for ns in feasible:
            if not lvm_vols and not dev_vols:
                raw.append(0)
                continue
            if ns.storage is None:
                raw.append(0)
                continue
            score = 0
            if lvm_vols:
                alloc = self._lvm_fit(lvm_vols, ns.storage)
                if alloc:
                    per_vg: Dict[int, int] = {}
                    for vg_idx, size in alloc:
                        per_vg[vg_idx] = per_vg.get(vg_idx, 0) + size
                    f = 0.0
                    for vg_idx, used in per_vg.items():
                        f += used / ns.storage.vgs[vg_idx].capacity
                    score += int(f / len(per_vg) * 10)
            if dev_vols:
                alloc = self._device_fit(dev_vols, ns.storage)
                if alloc:
                    f = 0.0
                    for dev_idx, size in alloc:
                        f += size / ns.storage.devices[dev_idx].capacity
                    score += int(f / len(alloc) * 10)
            raw.append(score)
        return self._minmax_normalize(raw)

    # -- reserve + bind -----------------------------------------------------

    def _reserve_and_bind(self, pod: dict, ns: NodeState):
        meta = pod.setdefault("metadata", {})
        spec = pod.setdefault("spec", {})
        # a binder extender is delegated the bind (scheduler.go bind();
        # extender.go:385-399); local state is updated either way so the
        # simulation keeps tracking the placement
        for ext in self.extenders:
            if ext.is_binder and ext.is_interested(pod):
                ext.bind(pod, ns.name)
                break
        # Open-Gpu-Share Reserve: allocate device ids, update node
        gpu_mem, gpu_cnt = stor.pod_gpu_request(pod)
        if stor.pod_gpu_memory(pod) > 0 and ns.gpu is not None:
            devs = ns.gpu.allocate_gpu_ids(gpu_mem, gpu_cnt)
            if devs is not None:
                ns.gpu.commit(devs, gpu_mem)
                meta.setdefault("annotations", {})[stor.GPU_INDEX_ANNO] = "-".join(
                    str(d) for d in devs
                )
                ns.alloc[stor.GPU_COUNT_ANNO] = Fraction(ns.gpu.allocatable_count())
                self.alloc_epoch += 1
        # Open-Local Bind: commit VG/device allocation (recorded for
        # exact reversal by preemption eviction)
        lvm_vols, dev_vols = stor.parse_pod_local_volumes(pod)
        if ns.storage is not None and (lvm_vols or dev_vols):
            alloc = self._lvm_fit(lvm_vols, ns.storage) if lvm_vols else []
            for vg_idx, size in alloc or []:
                ns.storage.vgs[vg_idx].requested += size
            dalloc = self._device_fit(dev_vols, ns.storage) if dev_vols else []
            for dev_idx, _size in dalloc or []:
                ns.storage.devices[dev_idx].is_allocated = True
            stor.set_node_storage(ns.own_node(), ns.storage)
            ns.local_allocs[self._pod_key(pod)] = (alloc or [], dalloc or [])
        # Simon Bind
        spec["nodeName"] = ns.name
        pod.setdefault("status", {})["phase"] = "Running"
        self._commit(pod, ns)

    @staticmethod
    def _pod_key(pod: dict) -> Tuple[str, str]:
        meta = pod.get("metadata") or {}
        return (meta.get("namespace") or "default", meta.get("name", ""))

    def commit_simple(self, pod: dict, ns: NodeState, s, ports) -> None:
        """The reduction of _reserve_and_bind for a pod with no
        GPU/storage/extender side effects (see simple_commit_mask):
        Simon Bind (nodeName + phase) + NodeInfo accounting, with the
        request summary and port tuple supplied by the caller's
        per-class cache."""
        pod.setdefault("spec", {})["nodeName"] = ns.name
        pod.setdefault("status", {})["phase"] = "Running"
        self._commit_known(pod, ns, s, ports)

    def _commit(self, pod: dict, ns: NodeState):
        """NodeInfo.AddPod accounting."""
        return self._commit_known(
            pod, ns, req.pod_request_summary(pod), None
        )

    def commit_simple_bulk(
        self, pods, node_idx, cls_ids, field_tbl, ports_of_cls, scalars_of_cls,
        prios=None,
    ):
        """Vectorized `commit_simple` over a contiguous run of
        side-effect-free placements (the batched host replay of the
        tiered scan engine and the capacity replay). Exact reduction of
        per-pod `commit_simple` + `_commit_known` in the same order:

        - per-NODE resource aggregates land as one scatter-add of the
          per-class summary deltas (`field_tbl[u]` = (mcpu, mem, eph,
          floor_mcpu, floor_mem, nz_mcpu, nz_mem) int64 — the exact
          RequestSummary integers, summed in int64 so arithmetic stays
          exact), applied once per touched node;
        - `ns.pods` grows by one grouped extend per node, preserving
          batch order within each node (stable argsort) — the order
          MoreImportantPod's commit-seq proxy and the PDB walk read;
        - commit_seq numbers are assigned in batch order from one
          counter advance; `_min_prio`/`saw_priority` update from the
          batch min (prios=None means the caller proved every pod's
          effective priority is 0 — the priority-free engine route);
        - ports / scalar resources are per-pod only for classes that
          carry them (ports_of_cls / scalars_of_cls, usually empty).

        Callers must guarantee every pod is unpinned, placed, and in a
        class with no GPU/storage/extender side effects
        (`simple_commit_mask`); anything else takes the per-pod path.
        """
        import numpy as np

        k = len(pods)
        if k == 0:
            return
        node_idx = np.asarray(node_idx, dtype=np.int64)
        cls_ids = np.asarray(cls_ids, dtype=np.int64)
        nodes = self.nodes
        # per-node aggregate deltas: sum class rows per touched node
        touched, inv = np.unique(node_idx, return_inverse=True)
        sums = np.zeros((len(touched), field_tbl.shape[1]), dtype=np.int64)
        np.add.at(sums, inv, field_tbl[cls_ids])
        for t_i, n_i in enumerate(touched.tolist()):
            ns = nodes[n_i]
            s = sums[t_i]
            ns.req_mcpu += int(s[0])
            ns.req_mem += int(s[1])
            ns.req_eph += int(s[2])
            ns.req_floor_mcpu += int(s[3])
            ns.req_floor_mem += int(s[4])
            ns.nz_mcpu += int(s[5])
            ns.nz_mem += int(s[6])
        # rare per-class extras (most classes have neither)
        has_extra = np.array(
            [bool(ports_of_cls[u]) or bool(scalars_of_cls[u])
             for u in range(len(ports_of_cls))],
            dtype=bool,
        )
        any_extra = bool(has_extra[cls_ids].any())
        # bind writes + per-node pod lists, grouped by node in batch order
        order = np.argsort(node_idx, kind="stable")
        sorted_nodes = node_idx[order]
        group_bounds = np.flatnonzero(np.diff(sorted_nodes)) + 1
        cls_list = cls_ids.tolist() if any_extra else None
        for g in np.split(order, group_bounds):
            ns = nodes[int(node_idx[g[0]])]
            name = ns.name
            plist = ns.pods
            for j in g.tolist():
                pod = pods[j]
                pod.setdefault("spec", {})["nodeName"] = name
                pod.setdefault("status", {})["phase"] = "Running"
                plist.append(pod)
                if any_extra and has_extra[cls_list[j]]:
                    u = cls_list[j]
                    for port in ports_of_cls[u]:
                        ns.used_ports.add(port)
                    for sname, iv in scalars_of_cls[u]:
                        ns.req_scalar[sname] = ns.req_scalar.get(sname, 0) + iv
        # commit sequence + priority bookkeeping, batch order
        seq = self._seq_counter
        commit_seq = self.commit_seq
        for pod in pods:
            meta = pod.get("metadata") or {}
            seq += 1
            commit_seq[(meta.get("namespace") or "default",
                        meta.get("name", ""))] = seq
        self._seq_counter = seq
        if prios is None:
            if self._min_prio > 0:
                self._min_prio = 0
        else:
            mn = int(np.min(prios))
            if mn < self._min_prio:
                self._min_prio = mn
            if not self.saw_priority and bool((np.asarray(prios) != 0).any()):
                self.saw_priority = True

    def _commit_known(self, pod: dict, ns: NodeState, s, ports):
        """_commit with the pod's request summary (and optionally its
        host-port tuple) already in hand — the capacity replay passes
        per-CLASS values so the 100k-pod walk does only aggregate
        arithmetic per pod (class members share request/port content by
        class-key construction, ops/encode.py:_class_key)."""
        ns.pods.append(pod)
        ns.req_mcpu += s.mcpu
        ns.req_mem += s.mem
        ns.req_eph += s.eph
        ns.req_floor_mcpu += s.floor_mcpu
        ns.req_floor_mem += s.floor_mem
        for name, iv in s.scalars:
            ns.req_scalar[name] = ns.req_scalar.get(name, 0) + iv
        ns.nz_mcpu += s.nz_mcpu
        ns.nz_mem += s.nz_mem
        for port in _pod_host_ports(pod) if ports is None else ports:
            ns.used_ports.add(port)
        # priority bookkeeping for DefaultPreemption
        self._seq_counter += 1
        self.commit_seq[self._pod_key(pod)] = self._seq_counter
        prio = self.pod_priority(pod)
        if prio < self._min_prio:
            self._min_prio = prio
        # pod_uses_priority(pod) is exactly `effective priority != 0`
        # (preemption.py:119) — reuse the value already resolved
        if prio != 0 and not self.saw_priority:
            self.saw_priority = True

    # -- pod removal (preemption) -------------------------------------------

    def remove_pod_from_node(self, ns: NodeState, pod: dict):
        """Reverse of _commit + the Reserve/Bind side effects, used by
        the preemption dry run (selectVictimsOnNode's removePod) and by
        the real eviction. Returns an undo token for
        restore_pod_to_node — the token pins the exact GPU device ids
        and open-local allocation so a restore is bit-identical.
        """
        for i, p in enumerate(ns.pods):
            if p is pod:
                pos = i
                break
        else:
            raise ValueError("pod not on node")
        ns.pods.pop(pos)
        s = req.pod_request_summary(pod)
        ns.req_mcpu -= s.mcpu
        ns.req_mem -= s.mem
        ns.req_eph -= s.eph
        ns.req_floor_mcpu -= s.floor_mcpu
        ns.req_floor_mem -= s.floor_mem
        for name, iv in s.scalars:
            ns.req_scalar[name] = ns.req_scalar.get(name, 0) - iv
        ns.nz_mcpu -= s.nz_mcpu
        ns.nz_mem -= s.nz_mem
        for port in _pod_host_ports(pod):
            ns.used_ports.discard(port)
        # GPU devices (from the gpu-index annotation Reserve wrote)
        gpu_devs: List[int] = []
        gpu_mem, _ = stor.pod_gpu_request(pod)
        if gpu_mem > 0 and ns.gpu is not None:
            anno = (pod.get("metadata") or {}).get("annotations") or {}
            idx = anno.get(stor.GPU_INDEX_ANNO)
            if idx:
                gpu_devs = [int(d) for d in str(idx).split("-") if str(d).isdigit()]
                for d in gpu_devs:
                    ns.gpu.used[d] -= gpu_mem
                ns.alloc[stor.GPU_COUNT_ANNO] = Fraction(ns.gpu.allocatable_count())
                self.alloc_epoch += 1
        # open-local allocation
        local = ns.local_allocs.pop(self._pod_key(pod), None)
        if local is not None and ns.storage is not None:
            alloc, dalloc = local
            for vg_idx, size in alloc:
                ns.storage.vgs[vg_idx].requested -= size
            for dev_idx, _size in dalloc:
                ns.storage.devices[dev_idx].is_allocated = False
            stor.set_node_storage(ns.own_node(), ns.storage)
        return (pos, gpu_devs, gpu_mem, local)

    def restore_pod_to_node(self, ns: NodeState, pod: dict, token):
        """Exact inverse of remove_pod_from_node."""
        pos, gpu_devs, gpu_mem, local = token
        ns.pods.insert(pos, pod)
        s = req.pod_request_summary(pod)
        ns.req_mcpu += s.mcpu
        ns.req_mem += s.mem
        ns.req_eph += s.eph
        ns.req_floor_mcpu += s.floor_mcpu
        ns.req_floor_mem += s.floor_mem
        for name, iv in s.scalars:
            ns.req_scalar[name] = ns.req_scalar.get(name, 0) + iv
        ns.nz_mcpu += s.nz_mcpu
        ns.nz_mem += s.nz_mem
        for port in _pod_host_ports(pod):
            ns.used_ports.add(port)
        if gpu_devs and ns.gpu is not None:
            for d in gpu_devs:
                ns.gpu.used[d] += gpu_mem
            ns.alloc[stor.GPU_COUNT_ANNO] = Fraction(ns.gpu.allocatable_count())
            self.alloc_epoch += 1
        if local is not None and ns.storage is not None:
            alloc, dalloc = local
            for vg_idx, size in alloc:
                ns.storage.vgs[vg_idx].requested += size
            for dev_idx, _size in dalloc:
                ns.storage.devices[dev_idx].is_allocated = True
            stor.set_node_storage(ns.own_node(), ns.storage)
            ns.local_allocs[self._pod_key(pod)] = (alloc, dalloc)

    def evict_pod(self, ns: NodeState, pod: dict):
        """Evict a victim for real (PrepareCandidate's DeletePod): the
        binding state written into the pod dict is stripped so the
        Simulator can re-enqueue it as a fresh, schedulable pod.
        Stateful custom plugins get `unreserve` — the analogue of the
        pod-delete informer event their live cache would consume."""
        for plugin in self.registry.plugins:
            plugin.unreserve(pod, ns.node)
        self.remove_pod_from_node(ns, pod)
        (pod.get("spec") or {}).pop("nodeName", None)
        pod.pop("status", None)
        anno = (pod.get("metadata") or {}).get("annotations")
        if anno:
            anno.pop(stor.GPU_INDEX_ANNO, None)

    # -- misc ---------------------------------------------------------------

    @staticmethod
    def _failure_message(pod: dict, reasons: Dict[str, int]) -> str:
        meta = pod.get("metadata") or {}
        parts = ", ".join(f"{n} {r}" for r, n in sorted(reasons.items()))
        total = sum(reasons.values())
        return (
            f"failed to schedule pod ({meta.get('namespace', 'default')}/{meta.get('name', '')}): "
            f"Unschedulable: 0/{total} nodes are available: {parts}."
        )
