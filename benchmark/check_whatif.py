"""The comparison that decides `correct` for `simon serve`'s what-ifs.

A what-if's answer is the body `POST /v1/simulate` replies with: every
node of the cluster with its pods (namespace, name, app), and the pods
left unscheduled. `parse` reads it into a `check.Answer` keyed by
Deployment (a pod's owner, its name less the two generated suffixes;
its replicas are interchangeable); `compare` holds it against the plain
reference's answer to the same what-if (reference/kube_v120_whatif.py):
every pod, the committed ones and the request's own, where the
reference puts it, none missing, and each node's pod count the
reference's. The body names no allocation; every pod of the cell
requests the same, so a node's pod count stands for it. A pod of
another caller's request, or one in a namespace not its owner's, is
misplaced. Each number is exact, so each limit is 0.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict

import numpy as np

from .check import Answer
from .generate import Instance

# the numbers compared, each with its limit
LIMITS = {
    "misplaced_pods": 0,  # pods listed on a node where the reference has no such pod
    "missing_pods": 0,  # pods the reference places that the answer does not list
    "wrong_alloc_nodes": 0,  # nodes whose pod count differs, or are absent or extra
    "unreadable_answers": 0,  # answers whose body cannot be read
}
UNREADABLE = {k: 0 for k in LIMITS} | {"unreadable_answers": 1}


def parse(body: bytes, inst: Instance, committed: Instance) -> Answer:
    """The answer in one reply's body to the what-if `inst` on the
    cluster whose committed workload is `committed`'s."""
    doc = json.loads(body)
    owners = {w.name: committed.namespace for w in committed.workloads}
    owners.update({w.name: inst.namespace for w in inst.workloads})
    index = {n: i for i, n in enumerate(inst.node_names)}
    pods: Counter = Counter()
    counts = np.zeros(inst.n_base, dtype=np.int64)
    for node in doc["nodes"]:
        j = index.get(node["name"], -1)
        if j < 0:
            continue
        counts[j] = len(node["pods"])
        for p in node["pods"]:
            owner = p["name"].rsplit("-", 2)[0]
            key = owner if owners.get(owner) == p["namespace"] else f"?{p['namespace']}/{owner}"
            pods[(j, key)] += 1
    zeros = np.zeros(inst.n_base, dtype=np.int64)
    return Answer(count=0, success=bool(doc["success"]), nodes=len(doc["nodes"]),
                  cpu_req=zeros, mem_req=zeros, pod_count=counts, cpu_alloc=zeros,
                  mem_alloc=zeros, pods=pods, unscheduled=len(doc["unscheduledPods"]))


def own_pods(ans: Answer, inst: Instance) -> int:
    """Pods of the request's own workloads the answer places."""
    names = {w.name for w in inst.workloads}
    return sum(v for (_, key), v in ans.pods.items() if key in names)


def compare(ans: Answer, ref: Answer) -> Dict[str, int]:
    diff = Counter(ans.pods)
    diff.subtract(ref.pods)
    return {
        "misplaced_pods": int(sum(v for v in diff.values() if v > 0)),
        "missing_pods": int(max(ref.placed - ans.placed, 0)),
        "wrong_alloc_nodes": int((ans.pod_count != ref.pod_count).sum())
        + abs(ans.nodes - ref.nodes),
        "unreadable_answers": 0,
    }


def judge(body: bytes, inst: Instance, committed: Instance, ref: Answer) -> tuple:
    """(the numbers compared, the request's own pods placed, the
    error where the body cannot be read) of one reply."""
    try:
        ans = parse(body, inst, committed)
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        return dict(UNREADABLE), 0, f"an answer that cannot be read: {e!r}"
    return compare(ans, ref), own_pods(ans, inst), None
