"""The least time a scan of a request could take on one H100: a frozen
count of its operations and bytes, from the benchmark's own inputs.

The operation count is the one the program's observatory keeps
(open_simulator_tpu_torch/obs/costs.py: `visit_ops`, `launch_ops`),
copied here so that a change to the program cannot move the yardstick:
every pod visits every node of its scenario once at its class's cost,
a count of the kernel source's integer and f64 operations per visit.
Here the scenario's nodes are the ones that exist in it (the existing
nodes and the new nodes the answer adds), and a class's term rows and
spread slots come from the request's own constraints: the request has a
term row for each distinct (topology key, selector) of its anti-affinity
terms and spread constraints; a class reads the rows of its own
anti-affinity terms and those whose selector matches its labels, and a
hard slot for each of its spread constraints.

Bytes count each input read once and each output written once: each
node's capacities and starting state, each class's requests and its
static feasibility and score rows over the nodes, the pods' classes and
masks, the term rows' topology ids and counts, and the placements and
final state written back.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM and 67 TFLOP/s outside the tensor cores (the scan's
int64 and f64 work has no faster path).
"""

from __future__ import annotations

from typing import Tuple

from ..generate import HOSTNAME_KEY, Instance

HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
OPS_PER_NODE_VISIT = 50
OPS_PER_TERM_ROW = 14
OPS_PER_HARD_SLOT = 12


def _row(t: dict) -> tuple:
    return t["key"], tuple(sorted(t["selector"].items()))


def all_rows(inst: Instance) -> list:
    """The request's term rows: one a distinct (topology key, selector)
    of its anti-affinity terms and spread constraints."""
    rows = []
    for w in inst.workloads:
        for t in w.anti + w.spread:
            if _row(t) not in rows:
                rows.append(_row(t))
    return rows


def term_rows(w, inst: Instance) -> list:
    """The term rows a pod of workload `w` reads: those of its own
    anti-affinity terms and those whose selector matches its labels."""
    labels = w.pod_labels
    own = {_row(t) for t in w.anti}
    return [r for r in all_rows(inst)
            if r in own or all(labels.get(k) == v for k, v in r[1])]


def visit_ops(w, inst: Instance) -> int:
    """Operations of one pod of workload `w` visiting one node."""
    return (OPS_PER_NODE_VISIT + OPS_PER_TERM_ROW * len(term_rows(w, inst))
            + OPS_PER_HARD_SLOT * len(w.spread))


def scan_ops(inst: Instance, count: int) -> int:
    """Operations of one scan of every pod of `inst` with `count` new
    nodes."""
    nodes = inst.n_base + count
    return sum(w.replicas * visit_ops(w, inst) for w in inst.workloads) * nodes


def scan_bytes(inst: Instance, count: int) -> int:
    """Bytes one such scan must move."""
    n = inst.n_base + count
    pods = inst.pods
    classes = len(inst.workloads)  # each workload's pods are a class of their own
    nodes_b = n * (4 + 6) * 8  # capacities, starting state
    class_b = classes * (6 * 8 + n * (1 + 4 * 8))  # requests; feasibility, score rows
    pods_b = pods * (4 + 1 + 4)  # classes, active mask, pins
    rows = all_rows(inst)
    values = sum(n if key == HOSTNAME_KEY else len(inst.zone_names) for key, _ in rows)
    term_b = len(rows) * n * 4 + 4 * 8 * values  # topology ids, four counts a value
    out_b = pods * 4 + 6 * 8 * n  # placements, final state
    return nodes_b + class_b + pods_b + term_b + n + out_b


def bound(inst: Instance, count: int) -> Tuple[float, str]:
    """(milliseconds, what bounds it) of one scan of `inst` with
    `count` new nodes: the larger of its bytes over HBM bandwidth and
    its operations over the core rate."""
    t_bytes = scan_bytes(inst, count) / HBM_BYTES_PER_S
    t_ops = scan_ops(inst, count) / CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
