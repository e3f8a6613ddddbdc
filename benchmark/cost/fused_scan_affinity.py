"""The least time a scan of a request with inter-pod affinity of every
kind could take on one H100: `fused_scan`'s frozen count, with the rows
and the work that the other kinds of term add, from the benchmark's own
inputs (`generate_affinity.Instance`).

The request has a term row for each distinct (topology key, selector)
of its terms of every kind (required affinity and anti-affinity,
preferred affinity and anti-affinity) and of its spread constraints; a
class reads the rows of its own terms and those whose selector matches
its labels, at `fused_scan.OPS_PER_TERM_ROW` each. A class with
required affinity terms also reads a group row for each of them (the
count of the pods that match all of them, by the row's topology), at
OPS_PER_GROUP_ROW, the program's observatory's count
(open_simulator_tpu_torch/obs/costs.py) copied here. A class whose
InterPodAffinity score can be non-empty (it has preferred terms, or
its labels match a term that some workload carries as required
affinity or as a preferred term) takes that score's NormalizeScore at
every node of every step: the bounds over the feasible nodes and the
normalised score (a subtraction, an f64 divide, an f64 multiply, a
truncation and the weighted add), OPS_PER_NORMALISED_VISIT.

Bytes add, to `fused_scan`'s, the rows of the other kinds (each a
topology id a node and four counts a topology value) and the group rows
(a topology id a node, a count a topology value and a total).
"""

from __future__ import annotations

from typing import Tuple

from ..generate import HOSTNAME_KEY
from ..generate_affinity import TERM_KINDS
from . import fused_scan as base

OPS_PER_GROUP_ROW = 5
OPS_PER_NORMALISED_VISIT = 8


def _terms(w) -> list:
    return [t for kind in TERM_KINDS for t in getattr(w, kind, [])]


def _selects(row: tuple, labels: dict) -> bool:
    return all(k in labels and labels[k] == v for k, v in row[1])


def all_rows(inst) -> list:
    """The request's term rows: one a distinct (topology key, selector)
    of its terms of every kind and its spread constraints."""
    rows = []
    for w in inst.workloads:
        for t in _terms(w) + w.spread:
            if base._row(t) not in rows:
                rows.append(base._row(t))
    return rows


def term_rows(w, inst) -> list:
    """The term rows a pod of workload `w` reads: those of its own terms
    and those whose selector matches its labels."""
    own = {base._row(t) for t in _terms(w)}
    return [r for r in all_rows(inst) if r in own or _selects(r, w.pod_labels)]


def group_rows(w) -> list:
    """The group rows of workload `w`: one a distinct row of its
    required affinity terms."""
    return sorted({base._row(t) for t in getattr(w, "affinity", [])})


def scored(w, inst) -> bool:
    """Whether InterPodAffinity's score of a pod of `w` can be non-empty."""
    if getattr(w, "pref_affinity", []) or getattr(w, "pref_anti", []):
        return True
    carried = [t for u in inst.workloads
               for kind in ("affinity", "pref_affinity", "pref_anti")
               for t in getattr(u, kind, [])]
    return any(_selects(base._row(t), w.pod_labels) for t in carried)


def visit_ops(w, inst) -> int:
    """Operations of one pod of workload `w` visiting one node."""
    return (base.OPS_PER_NODE_VISIT + base.OPS_PER_TERM_ROW * len(term_rows(w, inst))
            + OPS_PER_GROUP_ROW * len(group_rows(w)) + base.OPS_PER_HARD_SLOT * len(w.spread)
            + (OPS_PER_NORMALISED_VISIT if scored(w, inst) else 0))


def scan_ops(inst, count: int) -> int:
    """Operations of one scan of every pod of `inst` with `count` new
    nodes."""
    nodes = inst.n_base + count
    return sum(w.replicas * visit_ops(w, inst) for w in inst.workloads) * nodes


def _values(inst, rows, n: int) -> int:
    return sum(n if key == HOSTNAME_KEY else len(inst.zone_names) for key, _ in rows)


def scan_bytes(inst, count: int) -> int:
    """Bytes one such scan must move."""
    n = inst.n_base + count
    pods = inst.pods
    classes = len(inst.workloads)  # each workload's pods are a class of their own
    nodes_b = n * (4 + 6) * 8  # capacities, starting state
    class_b = classes * (6 * 8 + n * (1 + 4 * 8))  # requests; feasibility, score rows
    pods_b = pods * (4 + 1 + 4)  # classes, active mask, pins
    rows = all_rows(inst)
    term_b = len(rows) * n * 4 + 4 * 8 * _values(inst, rows, n)  # ids, four counts a value
    groups = {r for w in inst.workloads for r in group_rows(w)}
    group_b = len(groups) * (n * 4 + 8) + 8 * _values(inst, groups, n)  # ids, total, counts
    out_b = pods * 4 + 6 * 8 * n  # placements, final state
    return nodes_b + class_b + pods_b + term_b + group_b + n + out_b


def bound(inst, count: int) -> Tuple[float, str]:
    """(milliseconds, what bounds it) of one scan of `inst` with
    `count` new nodes: the larger of its bytes over HBM bandwidth and
    its operations over the core rate."""
    t_bytes = scan_bytes(inst, count) / base.HBM_BYTES_PER_S
    t_ops = scan_ops(inst, count) / base.CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
