"""Plain reference of `simon serve`'s what-ifs, in Python and NumPy.

A what-if's answer is a standalone simulation of the cluster plus that
one request: the cluster's committed workload placed first, then the
request's pods, each by kube-scheduler v1.20.5's cycle with simon's
plugins (benchmark/reference/kube_v120.py: the same queue, filters,
scores and selectHost). The committed pods are placed once (`Committed`),
and each what-if on its own copy of that state, so that no what-if sees
another's pods. It reads only the benchmark's own inputs
(`generate.Instance`), never anything the program made.
"""

from __future__ import annotations

import copy
from collections import Counter

from ..check import Answer
from ..generate import Instance
from . import kube_v120

# the per-node totals a placement changes (kube_v120.Cluster)
_STATE = ("used_cpu", "used_mem", "nz_cpu", "nz_mem", "pods")


def _copy(cl: kube_v120.Cluster) -> kube_v120.Cluster:
    out = copy.copy(cl)
    for name in _STATE:
        setattr(out, name, list(getattr(cl, name)))
    return out


class Committed:
    """The cluster's committed workload, placed once; `place` answers a
    what-if on a copy of that state. `tie` is selectHost's rule."""

    def __init__(self, cluster: Instance, tie: str = "first"):
        made = []

        def capture(inst, count):
            made.append(kube_v120.Cluster(inst, count))
            return made[-1]

        self.tie = tie
        self.answer = kube_v120.schedule(cluster, 0, tie, cluster=capture)
        self.state = made[0]

    def place(self, whatif: Instance, state=None) -> Answer:
        """`whatif`'s workloads placed on the committed state (or on
        `state`, a copy the caller keeps), answered with the committed
        pods beside its own."""
        cl = state if state is not None else _copy(self.state)
        ans = kube_v120.schedule(whatif, 0, self.tie, cluster=lambda inst, count: cl)
        pods = Counter(self.answer.pods)
        pods.update(ans.pods)
        ans.pods = pods
        ans.unscheduled += self.answer.unscheduled
        ans.success = ans.unscheduled == 0
        return ans

    def fresh(self) -> kube_v120.Cluster:
        """A copy of the committed state."""
        return _copy(self.state)


def schedule(inst: Instance, count: int = 0, tie: str = "first") -> Answer:
    """A what-if as one Instance: its first workload the committed one,
    the rest the request's. `count` must be 0: a what-if adds no node."""
    if count:
        raise ValueError("a what-if adds no node")
    cluster = copy.copy(inst)
    cluster.workloads = inst.workloads[:1]
    whatif = copy.copy(inst)
    whatif.workloads = inst.workloads[1:]
    return Committed(cluster, tie).place(whatif)
