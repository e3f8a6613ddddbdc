"""The least time the scenario scan (B6) of a round of what-ifs could
take on one H100: a frozen count of its operations and bytes, from the
benchmark's own inputs.

Each what-if is one row of the launch. In each row every active pod,
the request's own, visits every node once at its class's cost
(benchmark/cost/fused_scan.py's count of the kernel source's operations
a visit, imported from there). The rows' inactive pod steps, which the
kernel pays for the other rows' pods, are counted nowhere: a change that
skips them raises the share instead of moving the yardstick.

Bytes count each input read once and each output written once: each
node's capacities and committed state, once a launch; each class's
requests and its static feasibility and score rows over the nodes,
once a class (each what-if's workloads are classes of their own); each
row's active pods' classes, masks and pins, its term rows' topology ids
and counts; and each row's placements and final state written back.
The round is bounded as one launch of all its rows.
"""

from __future__ import annotations

from typing import List, Tuple

from ..generate import HOSTNAME_KEY, Instance
from .fused_scan import CORE_OPS_PER_S, HBM_BYTES_PER_S, all_rows, visit_ops


def launch_ops(rows: List[Instance]) -> int:
    """Operations of one launch whose rows are the what-ifs `rows`."""
    return sum(w.replicas * visit_ops(w, inst) * inst.n_base
               for inst in rows for w in inst.workloads)


def launch_bytes(rows: List[Instance]) -> int:
    """Bytes one such launch must move."""
    n = rows[0].n_base
    nodes_b = n * (4 + 6) * 8  # capacities, committed state
    classes = sum(len(inst.workloads) for inst in rows)
    class_b = classes * (6 * 8 + n * (1 + 4 * 8))  # requests; feasibility, score rows
    row_b = 0
    for inst in rows:
        terms = all_rows(inst)
        values = sum(n if key == HOSTNAME_KEY else len(inst.zone_names) for key, _ in terms)
        row_b += inst.pods * (4 + 1 + 4)  # classes, active mask, pins
        row_b += len(terms) * n * 4 + 4 * 8 * values  # topology ids, four counts a value
        row_b += inst.pods * 4 + 6 * 8 * n  # placements, final state
    return nodes_b + class_b + row_b


def bound(rows: List[Instance]) -> Tuple[float, str]:
    """(milliseconds, what bounds it) of one launch of `rows`: the
    larger of its bytes over HBM bandwidth and its operations over the
    core rate."""
    t_bytes = launch_bytes(rows) / HBM_BYTES_PER_S
    t_ops = launch_ops(rows) / CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
