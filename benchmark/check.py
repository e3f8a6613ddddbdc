"""The comparison that decides `correct`.

The program's answer is the text `simon apply` prints (its report: the
new-node count, the Node Info table with each node's requests and pod
count, and the Pod Info table with every pod's node). `parse` reads it
into an `Answer`; `compare` holds it against the plain reference run on
the same inputs: the count must be the smallest that schedules every
pod (the reference schedules them all at that count and not at one
fewer), every pod must sit where the reference puts it, and every
node's reported allocation must equal the reference's totals. Each
number is exact, so each limit is 0.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np

from .generate import Instance

# the numbers compared, each with its limit
LIMITS = {
    "wrong_counts": 0,  # answers whose new-node count is not the reference's least
    "misplaced_pods": 0,  # pods listed on a node where the reference has no such pod
    "missing_pods": 0,  # pods the reference places that the answer does not list
    "wrong_alloc_nodes": 0,  # nodes whose reported allocation differs, or are absent or extra
    "unreadable_answers": 0,  # answers whose report cannot be read
}
# the numbers of an answer whose report cannot be read
UNREADABLE = {k: 0 for k in LIMITS} | {"unreadable_answers": 1}


@dataclass
class Answer:
    """One answer of `simon apply`: the plan's new-node count, each
    node's allocation and where each pod went."""

    count: int
    success: bool
    nodes: int
    cpu_req: np.ndarray  # millicores requested on each node
    mem_req: np.ndarray  # bytes requested on each node
    pod_count: np.ndarray
    cpu_alloc: np.ndarray
    mem_alloc: np.ndarray
    # (node index, pod key) -> pods; a pod key is a StatefulSet pod's
    # name or a Deployment's name (its replicas are interchangeable)
    pods: Counter = field(default_factory=Counter)
    unscheduled: int = 0

    @property
    def placed(self) -> int:
        return sum(self.pods.values())


_BIN = {"Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30, "Ti": 1 << 40, "Pi": 1 << 50, "Ei": 1 << 60}


def _cpu(cell: str) -> int:
    v = cell.split("(", 1)[0]
    return int(v[:-1]) if v.endswith("m") else int(v) * 1000


def _mem(cell: str) -> int:
    v = cell.split("(", 1)[0]
    mult = _BIN.get(v[-2:])
    return int(v[:-2]) * mult if mult else int(v)


def _rows(lines, start: int):
    """The data rows of the table whose title line is at `start`."""
    i = start + 4  # title, rule, header, double rule
    while i < len(lines) and lines[i].startswith("| "):
        yield [c.strip() for c in lines[i][2:-2].split(" | ")]
        i += 2  # each row is followed by a rule


def parse(text: str, inst: Instance) -> Answer:
    """The answer in the text of one `simon apply` (table format)."""
    lines = text.split("\n")
    success = bool(lines) and lines[0].strip() == "Simulation success!"
    count = 0
    for line in lines[:3]:
        if line.startswith("new nodes added:"):
            count = int(line.split(":", 1)[1])
    try:
        node_at = lines.index("Node Info")
        pod_at = lines.index("Pod Info")
    except ValueError:
        return Answer(count=count, success=False, nodes=0, cpu_req=np.zeros(0, np.int64),
                      mem_req=np.zeros(0, np.int64), pod_count=np.zeros(0, np.int64),
                      cpu_alloc=np.zeros(0, np.int64), mem_alloc=np.zeros(0, np.int64))
    names, cpu_a, cpu_r, mem_a, mem_r, npods = [], [], [], [], [], []
    for row in _rows(lines, node_at):
        names.append(row[0])
        cpu_a.append(_cpu(row[1]))
        cpu_r.append(_cpu(row[2]))
        mem_a.append(_mem(row[3]))
        mem_r.append(_mem(row[4]))
        npods.append(int(row[5]))
    # existing nodes by name; new nodes by their place after them
    index = {n: i for i, n in enumerate(inst.node_names)}
    node_idx = {}
    extra = inst.n_base
    for name in names:
        if name in index:
            node_idx[name] = index[name]
        else:
            node_idx[name] = extra
            extra += 1
    sts = {k for w in inst.workloads if w.kind == "StatefulSet" for k in w.pod_keys()}
    deploys = {w.name for w in inst.workloads if w.kind != "StatefulSet"}
    pods: Counter = Counter()
    for row in _rows(lines, pod_at):
        name = row[1].split("/", 1)[-1]
        if name not in sts:
            owner = name.rsplit("-", 2)[0]
            name = owner if owner in deploys else f"?{name}"
        pods[(node_idx.get(row[0], -1), name)] += 1
    order = np.argsort([node_idx[n] for n in names], kind="stable")

    def arr(v):
        return np.asarray(v, dtype=np.int64)[order]

    return Answer(count=count, success=success, nodes=len(names), cpu_req=arr(cpu_r),
                  mem_req=arr(mem_r), pod_count=arr(npods), cpu_alloc=arr(cpu_a),
                  mem_alloc=arr(mem_a), pods=pods)


def compare(ans: Answer, inst: Instance, reference: Callable[[int], Answer]) -> Dict[str, int]:
    """The numbers of one answer against `reference(count)`, the
    reference's placement with `count` new nodes."""
    ref = reference(ans.count)
    least = ref.success and (ans.count == 0 or not reference(ans.count - 1).success)
    diff = Counter(ans.pods)
    diff.subtract(ref.pods)
    misplaced = sum(v for v in diff.values() if v > 0)
    n = min(ans.nodes, ref.nodes)
    off = np.zeros(n, dtype=bool)
    for field in ("cpu_req", "mem_req", "pod_count", "cpu_alloc", "mem_alloc"):
        off |= getattr(ans, field)[:n] != getattr(ref, field)[:n]
    return {
        "wrong_counts": int(not (ans.success and least)),
        "misplaced_pods": int(misplaced),
        "missing_pods": int(max(ref.placed - ans.placed, 0)),
        "wrong_alloc_nodes": int(off.sum()) + abs(ans.nodes - ref.nodes),
        "unreadable_answers": 0,
    }


class Reference:
    """The reference's placements, each computed once: a run checks
    several answers of one instance, at one or two counts each."""

    def __init__(self, schedule: Callable[[Instance, int], Answer]):
        self._schedule = schedule
        self._memo: Dict[tuple, Answer] = {}

    def at(self, inst: Instance) -> Callable[[int], Answer]:
        def reference(count: int) -> Answer:
            key = (inst.tag, count)
            if key not in self._memo:
                self._memo[key] = self._schedule(inst, count)
            return self._memo[key]

        return reference


def verdict(numbers: Dict[str, int], failed: int) -> bool:
    return failed == 0 and all(numbers[k] <= lim for k, lim in LIMITS.items())
