"""Plain reference of the simulator's semantics for the benchmark's
requests, in Python and NumPy.

It follows the kube-scheduler v1.20.5 scheduling cycle with simon's
plugin profile, as the configurations' `guarantees` state it, and reads
only the benchmark's own inputs (`generate.Instance`), never anything
the program made:

- queue: pods with tolerations first, then pods with a nodeSelector,
  otherwise in workload order (simon's pkg/algo sorts);
- filters: TaintToleration (NoSchedule), NodeResourcesFit (pod count,
  CPU, memory), InterPodAffinity (required anti-affinity terms on
  kubernetes.io/hostname, the pod's own and the placed pods'),
  PodTopologySpread (DoNotSchedule constraints with their maxSkew,
  domains every node that carries the key: `Terms`);
- scores: NodeResourcesBalancedAllocation and
  NodeResourcesLeastAllocated over the pods' non-zero requests, in
  float64 and integer arithmetic as upstream. Every other plugin of the
  profile scores every node alike on these requests (no images on the
  nodes, no preferred terms, no soft spread, no PreferNoSchedule taints,
  one node shape, so Simon's min-max term is 0), so it cannot move the
  choice and is left out;
- selectHost: the first node of the highest score in node order (the
  existing nodes in file order, then the new nodes in the order the
  plan adds them).

A node's score for a pod depends only on that node's state and the
pod's requests, so a pod's placement changes the scores of one node:
the serial pass keeps a score row per request shape and rescores the
one node after each placement. `schedule_full` is the same cycle with
every node rescored for every pod, the form to read against upstream;
the tests hold the two equal.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from ..check import Answer
from ..generate import HOSTNAME_KEY, Instance, cpu_milli, mem_bytes

MAX_SCORE = 100
DEFAULT_MILLI_CPU = 100  # non-zero request defaults (util/non_zero.go)
DEFAULT_MEMORY = 200 * 1024 * 1024


class Cluster:
    """The nodes of one scenario: the existing nodes and the first
    `count` new nodes, with their running totals."""

    def __init__(self, inst: Instance, count: int):
        if inst.new_node_spec != inst.node_spec:
            raise NotImplementedError(
                "the reference covers one node shape: Simon's min-max score "
                "would differ between shapes")
        n = inst.n_base + count
        self.n = n
        self.cpu = [int(v) for v in inst.node_cpu_m] + [cpu_milli(inst.new_node_spec["cpu"])] * count
        self.mem = [int(v) for v in inst.node_mem] + [mem_bytes(inst.new_node_spec["memory"])] * count
        self.cap = [int(v) for v in inst.node_pods] + [int(inst.new_node_spec["pods"])] * count
        self.tainted = [bool(v) for v in inst.tainted] + [False] * count
        self.zone = np.concatenate([inst.zone, np.full(count, inst.new_node_zone)]).astype(np.int64)
        self.n_zones = len(inst.zone_names)
        self.used_cpu = [0] * n
        self.used_mem = [0] * n
        self.nz_cpu = [0] * n
        self.nz_mem = [0] * n
        self.pods = [0] * n

    def score(self, shape: Tuple[int, int, bool], j: int) -> int:
        """Filters and scores of one request shape on node j: -1 where
        a filter fails, else BalancedAllocation + LeastAllocated."""
        rc, rm, tolerate = shape
        if self.tainted[j] and not tolerate:
            return -1
        if self.pods[j] + 1 > self.cap[j]:
            return -1
        cpu, mem = self.cpu[j], self.mem[j]
        if (rc or rm) and (self.used_cpu[j] + rc > cpu or self.used_mem[j] + rm > mem):
            return -1
        nzc = self.nz_cpu[j] + (rc or DEFAULT_MILLI_CPU)
        nzm = self.nz_mem[j] + (rm or DEFAULT_MEMORY)
        cf = nzc / cpu if cpu else 1.0
        mf = nzm / mem if mem else 1.0
        balanced = 0 if (cf >= 1 or mf >= 1) else int((1 - abs(cf - mf)) * MAX_SCORE)
        least_cpu = 0 if (cpu == 0 or nzc > cpu) else (cpu - nzc) * MAX_SCORE // cpu
        least_mem = 0 if (mem == 0 or nzm > mem) else (mem - nzm) * MAX_SCORE // mem
        return balanced + (least_cpu + least_mem) // 2

    def place(self, shape: Tuple[int, int, bool], j: int) -> None:
        rc, rm, _ = shape
        self.used_cpu[j] += rc
        self.used_mem[j] += rm
        self.nz_cpu[j] += rc or DEFAULT_MILLI_CPU
        self.nz_mem[j] += rm or DEFAULT_MEMORY
        self.pods[j] += 1


def _shapes(inst: Instance):
    shapes: List[Tuple[int, int, bool]] = []
    of: Dict[int, int] = {}
    for wi, w in enumerate(inst.workloads):
        s = (w.cpu_m, w.mem, w.tolerate)
        if s not in shapes:
            shapes.append(s)
        of[wi] = shapes.index(s)
    return shapes, of


def _pick(row: np.ndarray, tie: str) -> int:
    if tie == "first":
        return int(np.argmax(row))
    if tie == "last":
        return len(row) - 1 - int(np.argmax(row[::-1]))
    raise ValueError(f"unknown tie rule {tie!r}")


def _matches(selector: dict, labels: dict) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


class Terms:
    """The pod-to-pod constraints of a request: for each label selector
    that a term names, the pods placed on each node that it selects;
    for each workload with anti-affinity terms, its pods on each node.

    Required anti-affinity is on kubernetes.io/hostname only (a node is
    its own domain), both ways: a pod may not land beside a pod its
    terms select, nor beside a pod whose terms select it. A spread
    constraint's domains are the values of its key, every node carrying
    both keys; its skew is the domain's count, plus one where the pod
    matches the selector, less the least count over the domains."""

    def __init__(self, inst: Instance, cl: Cluster):
        self.cl = cl
        self.selectors: List[dict] = []
        for w in inst.workloads:
            if any(t["key"] != HOSTNAME_KEY for t in w.anti):
                raise NotImplementedError("anti-affinity on a key other than the hostname")
            if any(c["key"] not in (HOSTNAME_KEY, inst.zone_key) for c in w.spread):
                raise NotImplementedError("a spread over a key other than the hostname or zone")
            for t in w.anti + w.spread:
                if t["selector"] not in self.selectors:
                    self.selectors.append(t["selector"])
        self.count = np.zeros((len(self.selectors), cl.n), dtype=np.int64)
        self.owner = {wi: np.zeros(cl.n, dtype=np.int64)
                      for wi, w in enumerate(inst.workloads) if w.anti}
        self.workloads = inst.workloads
        # the selectors each workload's pods match
        self.selected_by = [[s for s, sel in enumerate(self.selectors)
                             if _matches(sel, w.pod_labels)] for w in inst.workloads]

    def mask(self, wi: int, row: np.ndarray) -> np.ndarray:
        """The score row of a pod of workload `wi` with its terms and
        the placed pods' terms applied."""
        w = self.workloads[wi]
        if not (w.anti or w.spread or self.owner):
            return row
        bad = np.zeros(self.cl.n, dtype=bool)
        for t in w.anti:
            bad |= self.count[self.selectors.index(t["selector"])] > 0
        for ui, placed in self.owner.items():
            if any(_matches(t["selector"], w.pod_labels) for t in self.workloads[ui].anti):
                bad |= placed > 0
        for c in w.spread:
            s = self.selectors.index(c["selector"])
            own = int(s in self.selected_by[wi])
            if c["key"] == HOSTNAME_KEY:
                per_node = self.count[s]
                bad |= per_node + own - per_node.min() > int(c["max_skew"])
            else:
                zc = np.bincount(self.cl.zone, weights=self.count[s],
                                 minlength=self.cl.n_zones)
                bad |= (zc + own - zc.min() > int(c["max_skew"]))[self.cl.zone]
        return np.where(bad, -1, row) if bad.any() else row

    def place(self, wi: int, j: int) -> None:
        for s in self.selected_by[wi]:
            self.count[s, j] += 1
        if wi in self.owner:
            self.owner[wi][j] += 1


def _answer(inst: Instance, cl: Cluster, count: int, placed: Counter, unscheduled: int) -> Answer:
    return Answer(count=count, success=unscheduled == 0, nodes=cl.n,
                  cpu_req=np.asarray(cl.used_cpu, dtype=np.int64),
                  mem_req=np.asarray(cl.used_mem, dtype=np.int64),
                  pod_count=np.asarray(cl.pods, dtype=np.int64),
                  cpu_alloc=np.asarray(cl.cpu, dtype=np.int64),
                  mem_alloc=np.asarray(cl.mem, dtype=np.int64),
                  pods=placed, unscheduled=unscheduled)


def schedule(inst: Instance, count: int, tie: str = "first", cluster=Cluster) -> Answer:
    """Place every pod of `inst` on the existing nodes and `count` new
    ones, one pod at a time (`cluster` the nodes' filters and scores)."""
    cl = cluster(inst, count)
    terms = Terms(inst, cl)
    shapes, shape_of = _shapes(inst)
    rows = np.array([[cl.score(s, j) for j in range(cl.n)] for s in shapes],
                    dtype=np.int64).reshape(len(shapes), cl.n)
    placed: Counter = Counter()
    unscheduled = 0
    for wi in inst.queue():
        s = shape_of[wi]
        for key in inst.workloads[wi].pod_keys():
            row = terms.mask(wi, rows[s])
            j = _pick(row, tie)
            if row[j] < 0:
                unscheduled += 1
                continue
            cl.place(shapes[s], j)
            for t, shape in enumerate(shapes):
                rows[t, j] = cl.score(shape, j)
            terms.place(wi, j)
            placed[(j, key)] += 1
    return _answer(inst, cl, count, placed, unscheduled)


def schedule_full(inst: Instance, count: int, tie: str = "first") -> Answer:
    """`schedule` with every node filtered and scored anew for every
    pod: slow, and the plain form of the cycle."""
    cl = Cluster(inst, count)
    terms = Terms(inst, cl)
    shapes, shape_of = _shapes(inst)
    placed: Counter = Counter()
    unscheduled = 0
    for wi in inst.queue():
        shape = shapes[shape_of[wi]]
        for key in inst.workloads[wi].pod_keys():
            row = np.array([cl.score(shape, j) for j in range(cl.n)], dtype=np.int64)
            row = terms.mask(wi, row)
            j = _pick(row, tie)
            if row[j] < 0:
                unscheduled += 1
                continue
            cl.place(shape, j)
            terms.place(wi, j)
            placed[(j, key)] += 1
    return _answer(inst, cl, count, placed, unscheduled)


def lower_bound(inst: Instance) -> int:
    """The smallest count whose total CPU, memory and pod capacity
    holds the total requests."""
    new_cpu = cpu_milli(inst.new_node_spec["cpu"])
    new_mem = mem_bytes(inst.new_node_spec["memory"])
    new_pods = int(inst.new_node_spec["pods"])
    need = [sum(w.replicas * w.cpu_m for w in inst.workloads),
            sum(w.replicas * w.mem for w in inst.workloads), inst.pods]
    have = [int(inst.node_cpu_m.sum()), int(inst.node_mem.sum()), int(inst.node_pods.sum())]
    per = [new_cpu, new_mem, new_pods]
    count = 0
    for nd, hv, p in zip(need, have, per):
        if nd > hv:
            count = max(count, -(-(nd - hv) // p))
    return min(count, inst.max_new)


def plan(inst: Instance, tie: str = "first", cluster=Cluster) -> Answer:
    """The capacity plan: the smallest new-node count in [0, max_new]
    that schedules every pod, by bisection above the aggregate bound
    (more nodes never schedule fewer pods), and its placement. Without
    one, the placement at max_new, not a success."""
    lo = lower_bound(inst)
    best = schedule(inst, lo, tie, cluster)
    if best.success:
        return best
    top = schedule(inst, inst.max_new, tie, cluster)
    if not top.success:
        return top
    best, hi = top, inst.max_new
    while hi - lo > 1:
        mid = (lo + hi) // 2
        res = schedule(inst, mid, tie, cluster)
        if res.success:
            best, hi = res, mid
        else:
            lo = mid
    return best
