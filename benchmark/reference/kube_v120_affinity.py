"""Plain reference of the simulator's semantics for requests whose pods
carry inter-pod affinity of every kind, in Python and NumPy.

It is `kube_v120`'s cycle (the queue, NodeResourcesFit, the resource
scores and the tie rule are taken from there) with InterPodAffinity as
kube-scheduler v1.20.5 computes it
(pkg/scheduler/framework/plugins/interpodaffinity), on any topology
key the nodes carry (kubernetes.io/hostname, whose domain is the node,
and the configuration's zone key), reading only the benchmark's own
inputs (`generate_affinity.Instance`):

- Filter: the pod's required affinity terms: the node carries every
  term's key, and in the node's domain of each key some placed pod
  matches all of the terms; while no placed pod matches them anywhere,
  a pod that matches its own terms passes (the first of a series). Its
  required anti-affinity terms: no placed pod the term selects in the
  node's domain. The placed pods' required anti-affinity terms: none
  that selects the pod has its owner in the node's domain.
- Score: by topology domain, the pod's preferred affinity terms add
  their weight for each placed pod they select, its preferred
  anti-affinity terms take it away; each placed pod adds
  hardPodAffinityWeight (1) for each of its required affinity terms
  that selects the pod, and the weight of each of its preferred
  affinity terms that selects it, and takes away that of each of its
  preferred anti-affinity terms that selects it. A node scores its
  domains' sums. NormalizeScore over the feasible nodes: max and min
  start at 0, int64(100 * ((s - min) / (max - min))) in float64, 0
  where max equals min.

A term selects a pod when the pod's namespace is among the term's and
its labels match the term's matchLabels (a key whose value is "" is
matched only by a label of that key with the empty value). Every term
of the benchmark names the request's namespace, where every pod lives.

The other score plugins of the port's profile
(scheduler/schedconfig.py `ScoreWeights`) score every node alike on
these requests, so none can move a choice: ImageLocality (the nodes
list no images), NodeAffinity (no preferred node affinity: 0),
NodePreferAvoidPods (no node carries the annotation: 100),
PodTopologySpread (no ScheduleAnyway constraint: MaxNodeScore
everywhere), TaintToleration (no taints: 100), Simon (one node shape,
so its min-max range is 0), Open-Gpu-Share and Open-Local (no GPU, no
storage: 0). NodeResourcesBalancedAllocation and
NodeResourcesLeastAllocated are `kube_v120.Cluster.score`.

The serial pass (`schedule`) keeps each workload's placed pods per
node and each request shape's resource score row, rescoring the one
node a placement changes; `schedule_full` rescores every node for
every pod and builds InterPodAffinity's maps from the list of placed
pods as upstream's PreFilter and PreScore do, the form to read against
upstream. The tests hold the two equal.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..check import Answer
from ..generate import HOSTNAME_KEY
from . import kube_v120

MAX_SCORE = kube_v120.MAX_SCORE
HARD_POD_AFFINITY_WEIGHT = 1


def selects(term: dict, labels: dict) -> bool:
    """A term's matchLabels against a pod's labels (the namespaces agree
    for every pod of a request)."""
    return all(k in labels and labels[k] == v for k, v in term["selector"].items())


def normalize(raw: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """InterPodAffinity's NormalizeScore over the feasible nodes."""
    if not feasible.any():
        return np.zeros_like(raw)
    hi = max(int(raw[feasible].max()), 0)
    lo = min(int(raw[feasible].min()), 0)
    if hi == lo:
        return np.zeros_like(raw)
    return (float(MAX_SCORE) * ((raw - lo) / float(hi - lo))).astype(np.int64)


class Topology:
    """Each node's domain of each topology key: the node itself for the
    hostname, the zone's index for the zone key; a key no node carries
    has none."""

    def __init__(self, inst, cl: kube_v120.Cluster):
        self.n = cl.n
        self.zone_key = inst.zone_key if inst.zone_names else None
        self.zone = cl.zone
        self.n_zones = max(cl.n_zones, 1)

    def has(self, key: str) -> bool:
        return key == HOSTNAME_KEY or key == self.zone_key

    def spread(self, per_node: np.ndarray, key: str) -> np.ndarray:
        """The sum of `per_node` over each node's domain of `key`."""
        if key == HOSTNAME_KEY:
            return per_node
        tot = np.bincount(self.zone, weights=per_node, minlength=self.n_zones)
        return tot.astype(np.int64)[self.zone]


class _Rules:
    """What InterPodAffinity reads for a pod of one workload: which
    workloads' placed pods each of its filters and score terms count."""

    def __init__(self, wi: int, workloads):
        w = workloads[wi]
        labels = [v.pod_labels for v in workloads]
        own = w.pod_labels
        self.affinity = list(w.affinity)
        # workloads whose pods match every required affinity term
        self.match_all = [v for v, lab in enumerate(labels)
                          if all(selects(t, lab) for t in w.affinity)]
        self.self_match = all(selects(t, own) for t in w.affinity)
        self.anti = [(t["key"], [v for v, lab in enumerate(labels) if selects(t, lab)])
                     for t in w.anti]
        # placed workloads whose required anti-affinity selects this pod
        self.placed_anti = [(v, t["key"]) for v, u in enumerate(workloads)
                            for t in u.anti if selects(t, own)]
        # (workload counted, topology key, weight) of each score term
        self.score: List[Tuple[int, str, int]] = []
        for t in w.pref_affinity:
            self.score += [(v, t["key"], int(t["weight"]))
                           for v, lab in enumerate(labels) if selects(t, lab)]
        for t in w.pref_anti:
            self.score += [(v, t["key"], -int(t["weight"]))
                           for v, lab in enumerate(labels) if selects(t, lab)]
        for v, u in enumerate(workloads):
            self.score += [(v, t["key"], HARD_POD_AFFINITY_WEIGHT)
                           for t in u.affinity if selects(t, own)]
            self.score += [(v, t["key"], int(t["weight"]))
                           for t in u.pref_affinity if selects(t, own)]
            self.score += [(v, t["key"], -int(t["weight"]))
                           for t in u.pref_anti if selects(t, own)]


class Terms:
    """The placed pods of each workload on each node, and
    InterPodAffinity's filter and raw score from them."""

    def __init__(self, inst, cl: kube_v120.Cluster):
        self.topo = Topology(inst, cl)
        self.placed = np.zeros((len(inst.workloads), cl.n), dtype=np.int64)
        self.rules = [_Rules(wi, inst.workloads) for wi in range(len(inst.workloads))]

    def filter(self, wi: int) -> np.ndarray:
        r, topo = self.rules[wi], self.topo
        ok = np.ones(topo.n, dtype=bool)
        if r.affinity:
            matched = self.placed[r.match_all].sum(axis=0)
            exist = np.ones(topo.n, dtype=bool)
            for t in r.affinity:
                if not topo.has(t["key"]):
                    return np.zeros(topo.n, dtype=bool)  # every key must be on the node
                exist &= topo.spread(matched, t["key"]) > 0
            # upstream's count map is empty when no matching pod sits on
            # a node carrying a term's key, and every node carries them
            if not (matched.sum() == 0 and r.self_match):
                ok &= exist
        for key, vs in r.anti:
            if topo.has(key) and vs:
                ok &= topo.spread(self.placed[vs].sum(axis=0), key) == 0
        for v, key in r.placed_anti:
            if topo.has(key):
                ok &= topo.spread(self.placed[v], key) == 0
        return ok

    def raw(self, wi: int) -> Optional[np.ndarray]:
        """The raw score of every node, or None where no term scores."""
        terms = [(v, key, wt) for v, key, wt in self.rules[wi].score if self.topo.has(key)]
        if not terms:
            return None
        out = np.zeros(self.topo.n, dtype=np.int64)
        for v, key, wt in terms:
            out += wt * self.topo.spread(self.placed[v], key)
        return out

    def place(self, wi: int, j: int) -> None:
        self.placed[wi, j] += 1


def schedule(inst, count: int, tie: str = "first", normalizer=normalize) -> Answer:
    """Place every pod of `inst` on the existing nodes and `count` new
    ones, one pod at a time (`normalizer` InterPodAffinity's
    NormalizeScore)."""
    cl = kube_v120.Cluster(inst, count)
    terms = Terms(inst, cl)
    shapes, shape_of = kube_v120._shapes(inst)
    rows = np.array([[cl.score(s, j) for j in range(cl.n)] for s in shapes],
                    dtype=np.int64).reshape(len(shapes), cl.n)
    placed: Counter = Counter()
    unscheduled = 0
    for wi in inst.queue():
        s = shape_of[wi]
        for key in inst.workloads[wi].pod_keys():
            feasible = (rows[s] >= 0) & terms.filter(wi)
            if not feasible.any():
                unscheduled += 1
                continue
            total = rows[s].copy()
            raw = terms.raw(wi)
            if raw is not None:
                total += normalizer(raw, feasible)
            j = kube_v120._pick(np.where(feasible, total, -1), tie)
            cl.place(shapes[s], j)
            for t, shape in enumerate(shapes):
                rows[t, j] = cl.score(shape, j)
            terms.place(wi, j)
            placed[(j, key)] += 1
    return kube_v120._answer(inst, cl, count, placed, unscheduled)


def _labels(inst, cl: kube_v120.Cluster) -> List[Dict[str, str]]:
    """Each node's labels that a topology key can name."""
    out = []
    for j in range(cl.n):
        lab = {HOSTNAME_KEY: f"node-{j}"}
        if inst.zone_names:
            lab[inst.zone_key] = inst.zone_names[int(cl.zone[j])]
        out.append(lab)
    return out


def _ipa_full(inst, w, node_labels, pods_on) -> Tuple[np.ndarray, np.ndarray]:
    """(filter, raw score) of a pod of `w` on every node, from the list
    of placed pods (`pods_on[j]`: the workloads of node j's pods), as
    upstream's PreFilter, Filter, PreScore and Score compute them."""
    own = w.pod_labels
    placed = [(inst.workloads[v], j) for j, vs in enumerate(pods_on) for v in vs]
    affinity_counts: Counter = Counter()
    anti_counts: Counter = Counter()
    existing_anti: Counter = Counter()
    topology_score: Dict[Tuple[str, str], int] = {}
    for u, j in placed:
        lab = node_labels[j]
        if w.affinity and all(selects(t, u.pod_labels) for t in w.affinity):
            for t in w.affinity:
                if t["key"] in lab:
                    affinity_counts[(t["key"], lab[t["key"]])] += 1
        for t in w.anti:
            if selects(t, u.pod_labels) and t["key"] in lab:
                anti_counts[(t["key"], lab[t["key"]])] += 1
        for t in u.anti:
            if selects(t, own) and t["key"] in lab:
                existing_anti[(t["key"], lab[t["key"]])] += 1
        # processExistingPod: (term, the pod it must select, weight)
        scored = ([(t, u.pod_labels, int(t["weight"])) for t in w.pref_affinity]
                  + [(t, u.pod_labels, -int(t["weight"])) for t in w.pref_anti]
                  + [(t, own, HARD_POD_AFFINITY_WEIGHT) for t in u.affinity]
                  + [(t, own, int(t["weight"])) for t in u.pref_affinity]
                  + [(t, own, -int(t["weight"])) for t in u.pref_anti])
        for t, target, wt in scored:
            if selects(t, target) and t["key"] in lab:
                pair = (t["key"], lab[t["key"]])
                topology_score[pair] = topology_score.get(pair, 0) + wt
    n = len(node_labels)
    ok = np.ones(n, dtype=bool)
    raw = np.zeros(n, dtype=np.int64)
    for j, lab in enumerate(node_labels):
        if w.affinity:  # satisfyPodAffinity
            if any(t["key"] not in lab for t in w.affinity):
                ok[j] = False
            elif any(affinity_counts[(t["key"], lab[t["key"]])] <= 0 for t in w.affinity):
                ok[j] = (not affinity_counts
                         and all(selects(t, own) for t in w.affinity))
        if any(t["key"] in lab and anti_counts[(t["key"], lab[t["key"]])] > 0
               for t in w.anti):  # satisfyPodAntiAffinity
            ok[j] = False
        if any(existing_anti[pair] > 0 for pair in lab.items()):
            ok[j] = False  # satisfyExistingPodsAntiAffinity
        raw[j] = sum(v for (key, val), v in topology_score.items() if lab.get(key) == val)
    return ok, (raw if topology_score else None)


def schedule_full(inst, count: int, tie: str = "first", normalizer=normalize) -> Answer:
    """`schedule` with every node filtered and scored anew for every
    pod: slow, and the plain form of the cycle."""
    cl = kube_v120.Cluster(inst, count)
    node_labels = _labels(inst, cl)
    pods_on: List[List[int]] = [[] for _ in range(cl.n)]
    shapes, shape_of = kube_v120._shapes(inst)
    placed: Counter = Counter()
    unscheduled = 0
    for wi in inst.queue():
        w = inst.workloads[wi]
        shape = shapes[shape_of[wi]]
        for key in w.pod_keys():
            row = np.array([cl.score(shape, j) for j in range(cl.n)], dtype=np.int64)
            ok, raw = _ipa_full(inst, w, node_labels, pods_on)
            feasible = (row >= 0) & ok
            if not feasible.any():
                unscheduled += 1
                continue
            total = row + (normalizer(raw, feasible) if raw is not None else 0)
            j = kube_v120._pick(np.where(feasible, total, -1), tie)
            cl.place(shape, j)
            pods_on[j].append(wi)
            placed[(j, key)] += 1
    return kube_v120._answer(inst, cl, count, placed, unscheduled)


def plan(inst, tie: str = "first", normalizer=normalize) -> Answer:
    """The capacity plan as `kube_v120.plan` searches it, with this
    module's cycle."""
    lo = kube_v120.lower_bound(inst)
    best = schedule(inst, lo, tie, normalizer)
    if best.success:
        return best
    top = schedule(inst, inst.max_new, tie, normalizer)
    if not top.success:
        return top
    best, hi = top, inst.max_new
    while hi - lo > 1:
        mid = (lo + hi) // 2
        res = schedule(inst, mid, tie, normalizer)
        if res.success:
            best, hi = res, mid
        else:
            lo = mid
    return best
