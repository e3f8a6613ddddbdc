"""Cost records of the port's kernel launches: what each launch must
move, compute and allocate on the card.

The JAX package reads these figures from XLA (``cost_analysis()`` and
``memory_analysis()`` of an ahead-of-time compile). A hand-written CUDA
kernel has no such analysis, so the port counts them from the plan and
the launch's inputs:

- ``launch_bytes``: the bytes a launch must move, each input read once
  and each output written once (the plan's tensors, the pods' classes,
  each scenario's masks, pins, placements and state rows);
- ``launch_ops``: the integer and f64 operations this launch's pods
  need: per scanned (pod, node) visit, ``visit_ops`` of the pod's class
  (a count of csrc/fused_scan.cu's source, not a measurement); a pinned
  pod only commits and counts nothing;
- ``workspace_bytes``: the device memory one launch allocates: its
  per-call inputs, outputs and scratch (ops/fused_scan.py
  ``_scenario_inputs`` and ``_launch_inputs``), each rounded as the
  CUDA caching allocator charges it. ``fused_scan.scratch_bytes`` is
  the scratch part.

``bound`` turns the first two into the least time the card could take
(the larger of the bytes over HBM bandwidth and the operations over the
core rate): the bound column of PERF.md and of chip_smoke.py's kernel
line, and the cost records' figure, come from this one count.

``COSTS`` keeps one ``CostRecord`` a (site, kernel instantiation, launch
shape), made on the shape's first launch (obs/profile.py). The chunked
executor asks ``estimate_bytes(site, rows)`` (through
``chunk_estimator``) for the workspace of a chunk of ``rows`` scenarios
before it launches one; the memory ledger (obs/ledger.py) compares that
with the card's free budget.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from ..utils.trace import COUNTERS

# bytes/s of HBM and the non-tensor f32 rate of one H100 SXM (NVIDIA
# data sheet); the scan's int64/f64 work has no faster path than that
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# integer and f64 operations per (pod, node) visit: fit (~10),
# least (~10), balanced (~10), normalisation bounds (~5), pass 2 (~15);
# the B2 blocks add about 3 per scalar kind, 2 per port word and 4 per
# GPU device (a GPU-share class only)
OPS_PER_NODE_VISIT = 50
OPS_PER_SCALAR, OPS_PER_PORT_WORD, OPS_PER_GPU_DEVICE = 3, 2, 4
# the storage block, for a class with volumes: about 6 per (LVM volume,
# VG) of the binpack, 8 per VG of the score and 4 per device of the
# first-fit walk; the term block: about 14 per relevant term row (a
# topology value, four counts, the filters and the raw score), 5 per
# affinity-group row, 12 per hard-spread constraint (its minimum and
# its filter) and 12 per soft-spread constraint (stamp, count, score)
OPS_PER_VG_VOLUME, OPS_PER_VG, OPS_PER_DEVICE = 6, 8, 4
OPS_PER_TERM_ROW, OPS_PER_GROUP_ROW, OPS_PER_HARD_SLOT, OPS_PER_SOFT_SLOT = 14, 5, 12, 12

# the CUDA caching allocator charges a request in 512-byte blocks; a
# request above 1 MiB may take a cached block up to 1 MiB larger whole
# (it splits a block only when more than 1 MiB would remain)
ALLOC_BLOCK = 512
LARGE_ALLOC = 1 << 20
# the largest cluster a scenario runs on (fused_scan.CLUSTER_SIZES): an
# estimate made before the rule chooses one takes it
MAX_CLUSTER = 16


def visit_ops(plan) -> np.ndarray:
    """Integer and f64 operations of one (pod, node) visit, per class:
    the base count plus the blocks the class runs."""
    from ..ops import fused_scan

    d = fused_scan.block_dims(plan)
    visit = np.full(plan.u, OPS_PER_NODE_VISIT + OPS_PER_SCALAR * d["k"]
                    + OPS_PER_PORT_WORD * d["w"], dtype=np.int64)
    if plan.has_gpu:
        visit += OPS_PER_GPU_DEVICE * d["g"] * (plan.gpu_cls[:, 0].cpu().numpy() > 0)
    if plan.has_store:
        lv = (plan.cls_lvm.cpu().numpy() > 0).sum(axis=1)
        wants = plan.cls_wants.cpu().numpy() > 0
        visit += wants * (OPS_PER_VG_VOLUME * lv * d["v"] + OPS_PER_VG * d["v"]
                          + OPS_PER_DEVICE * (d["ds"] + d["dh"]))
    if plan.has_terms:
        def slots(t):
            return (t.cpu().numpy() >= 0).sum(axis=1)

        visit += (OPS_PER_TERM_ROW * slots(plan.cls_rows)
                  + OPS_PER_GROUP_ROW * slots(plan.cls_grows)
                  + OPS_PER_HARD_SLOT * slots(plan.cls_hrows)
                  + OPS_PER_SOFT_SLOT * slots(plan.cls_srows))
    return visit


def plan_bytes(plan) -> int:
    """Bytes of the plan's tensors, read once by a launch."""
    import torch

    return sum(t.numel() * t.element_size() for t in vars(plan).values()
               if isinstance(t, torch.Tensor))


def launch_bytes(plan, pods: int, scenarios: int) -> int:
    """Bytes a launch of `scenarios` scenarios over `pods` pods must
    move: the plan and the pods' classes read once; per scenario its
    active and valid masks and pins read, its placements and final
    state rows written."""
    from ..ops import fused_scan

    n, p = plan.n, pods
    d = fused_scan.block_dims(plan)
    state = n * (6 * 8 + d["k"] * 8 + d["g"] * 8 + d["w"] * 4
                 + d["v"] * 8 + d["ds"] + d["dh"])
    state += 8 * (4 * d["vt"] + d["va"] + d["a"] + d["vs"])
    per_scenario = p * (1 + 4) + n + p * 4 + state
    return plan_bytes(plan) + p * 4 + scenarios * per_scenario


def launch_ops(plan, class_of_pod, scenarios) -> int:
    """Operations this launch's pods need: each scanned pod visits every
    node at its class's cost; a pinned pod only commits."""
    cls = np.asarray(class_of_pod)
    visit = visit_ops(plan)
    ops = 0
    for active, _valid, pinned in scenarios:
        # a new array: the caller's active rows stay as they are
        scanned = np.array(active, bool)
        if pinned is not None:
            scanned &= np.asarray(pinned) < 0
        ops += int(visit[cls[scanned]].sum()) * plan.n
    return ops


def bound_of(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by) of work that moves `nbytes` and does `ops`."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / CORE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def bound(plan, class_of_pod, scenarios) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the scans must move
    (each input read once, each output written once) over HBM bandwidth
    and the operations this run's pods need over the core rate."""
    return bound_of(launch_bytes(plan, len(class_of_pod), len(scenarios)),
                    launch_ops(plan, class_of_pod, scenarios))


def alloc_bytes(nbytes: int) -> int:
    """What the caching allocator may charge for one request of
    `nbytes`, at most."""
    if nbytes <= 0:
        return 0
    rounded = -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK
    return rounded + (LARGE_ALLOC if rounded > LARGE_ALLOC else 0)


def _requests(plan, pods: int, scenarios: int, cluster: int) -> list:
    """The device allocations of one launch, in bytes: the per-call
    inputs (ops/fused_scan.py _scenario_inputs), then the outputs and
    scratch of _launch_inputs."""
    from ..ops import fused_scan

    n, p, s = plan.n, pods, scenarios
    d = fused_scan.block_dims(plan)

    def copies(t):
        return s * t.numel() * t.element_size()

    out = [p * 4, s * p, s * n, s * p * 4, s * 6 * n * 8, s * p * 4, s * max(n, 1) * 8]
    if plan.has_scal:
        out.append(s * d["k"] * n * 8)
    if plan.has_gpu:
        out.append(s * d["g"] * n * 8)
    if plan.has_ports:
        out.append(s * d["w"] * n * 4)
    if plan.has_store:
        out += [copies(plan.vg_init), copies(plan.ssd_init), copies(plan.hdd_init),
                s * d["v"] * n * 8]
    if plan.has_terms:
        out += [copies(plan.t_init), copies(plan.g_init), copies(plan.gt_init),
                copies(plan.s_init), s * cluster * d["vs"] * 8,
                s * cluster * max(fused_scan.replica_len(plan), 1) * 8]
    if plan.has_store or plan.has_terms:
        out.append(s * 3 * max(n, 1) * 8)
    return out


def workspace_bytes(plan, pods: int, scenarios: int, cluster: int = MAX_CLUSTER) -> int:
    """Device bytes one launch of `scenarios` scenarios over `pods` pods
    allocates, on clusters of `cluster` blocks (the largest by default):
    every input, output and scratch tensor, each as the caching
    allocator may charge it. An upper bound of the allocator's increase
    over the launch (a term plan whose replicas stay in shared memory
    allocates less)."""
    return sum(alloc_bytes(b) for b in _requests(plan, pods, scenarios, cluster))


@dataclass
class CostRecord:
    """One (site, kernel instantiation, launch shape): what its launch
    must move (`bytes`), compute (`ops`) and allocate on the card
    (`workspace_bytes`), counted from its first launch, and how many
    launches the shape has had. `shape` names the launch's dimensions."""

    site: str
    kernel: str
    shape: dict
    bytes: int
    ops: int
    workspace_bytes: int
    launches: int = 0

    def as_dict(self) -> dict:
        ms, by = bound_of(self.bytes, self.ops)
        return {"kernel": self.kernel, **self.shape, "bytes": self.bytes,
                "ops": self.ops, "workspace_bytes": self.workspace_bytes,
                "bound_ms": ms, "bound_by": by, "launches": self.launches}


def fused_scan_record(site: str, kernel: str, plan, class_of_pod, scenarios,
                      cluster: Optional[int]) -> CostRecord:
    """The cost record of one fused-scan launch of `scenarios` (a list of
    (active, valid, pinned)) at `site`, on clusters of `cluster` blocks
    (None for the plain version, whose workspace is counted at the
    largest cluster)."""
    p, s = len(class_of_pod), len(scenarios)
    return CostRecord(
        site=site, kernel=kernel,
        shape={"scenarios": s, "pods": p, "nodes": plan.n, "cluster": cluster},
        bytes=launch_bytes(plan, p, s), ops=launch_ops(plan, class_of_pod, scenarios),
        workspace_bytes=workspace_bytes(plan, p, s, cluster or MAX_CLUSTER))


class CostRegistry:
    """Process-wide (site, kernel, shape) -> CostRecord store, mirrored
    into the ``Counters`` registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[str, Dict[tuple, CostRecord]] = {}
        # site -> (plan, pods) declared by a chunked caller before its
        # first launch
        self._declared: Dict[str, tuple] = {}

    def has(self, site: str, key: tuple) -> bool:
        with self._lock:
            return key in self._records.get(site, {})

    def record(self, site: str, key: tuple, rec: CostRecord) -> None:
        with self._lock:
            self._records.setdefault(site, {})[key] = rec
        COUNTERS.inc("cost_records_total")
        COUNTERS.gauge(f"cost_bytes_{site}", float(rec.bytes))
        COUNTERS.gauge(f"cost_ops_{site}", float(rec.ops))
        COUNTERS.gauge(f"cost_workspace_bytes_{site}", float(rec.workspace_bytes))

    def on_launch(self, site: str, key: tuple) -> None:
        """Count a launch of a recorded shape and its moved bytes and
        operations."""
        with self._lock:
            rec = self._records.get(site, {}).get(key)
            if rec is None:
                return
            rec.launches += 1
        COUNTERS.inc("cost_bytes_launched_total", int(rec.bytes))
        COUNTERS.inc("cost_ops_launched_total", int(rec.ops))

    def records_for(self, site: str) -> Dict[tuple, CostRecord]:
        with self._lock:
            return dict(self._records.get(site, {}))

    def sites(self):
        with self._lock:
            return sorted(self._records)

    def declare(self, site: str, plan, pods: int) -> None:
        """A chunked caller's plan at `site`: its chunks' workspace is
        known before the site's first launch."""
        with self._lock:
            self._declared[site] = (plan, int(pods))

    def declare_bytes(self, site: str, nbytes: int) -> None:
        """The device bytes one scan at `site` needs, for a site with no
        kernel plan (the torch scan's, ``scan_bytes``)."""
        with self._lock:
            self._declared[site] = (None, int(nbytes))

    def estimate_bytes(self, site: str, rows: int, shards: int = 1) -> Optional[int]:
        """Predicted device workspace of one launch of `rows` scenarios
        at `site`, on clusters of the largest size (``workspace_bytes``
        of the plan its caller declared); None for a site with nothing
        declared, which stays reactive. With ``shards`` > 1 the rows are
        split over a mesh (parallel/mesh.py), one launch a device: the
        estimate is PER DEVICE, the workspace of ceil(rows / shards)."""
        with self._lock:
            declared = self._declared.get(site)
        if declared is None:
            return None
        plan, pods = declared
        if plan is None:
            return pods
        if shards > 1:
            rows = -(-int(rows) // int(shards))
        return workspace_bytes(plan, pods, int(rows))

    def chunk_estimator(self, site: str, plan=None, pods: int = 0, shards: int = 1
                        ) -> Callable[[int, int], Optional[int]]:
        """An ``estimate(lo, hi)`` for guard.run_chunked: the predicted
        workspace of launching rows [lo, hi) at `site`, per device of a
        ``shards``-device mesh. With a plan the estimate exists before
        the first launch."""
        if plan is not None:
            self.declare(site, plan, pods)

        def estimate(lo: int, hi: int) -> Optional[int]:
            return self.estimate_bytes(site, hi - lo, shards=shards)

        return estimate

    def summary(self) -> dict:
        """Per-site cost table for trace artifacts: every recorded shape
        of the site, largest first, with its launches."""
        out = {}
        for site in self.sites():
            recs = sorted(self.records_for(site).values(),
                          key=lambda r: -r.workspace_bytes)
            if not recs:
                continue
            out[site] = {"signatures": len(recs), "records": [r.as_dict() for r in recs]}
        if out:
            out["_totals"] = {
                "records": COUNTERS.get("cost_records_total"),
                "bytes_launched": COUNTERS.get("cost_bytes_launched_total"),
                "ops_launched": COUNTERS.get("cost_ops_launched_total"),
            }
        return out


def scan_bytes(static, init) -> int:
    """Device bytes of one torch scan (ops/scan.py): its static tensors,
    the initial state and the state the scan clones from it."""
    def nbytes(tup):
        return sum(t.numel() * t.element_size() for t in tup if t is not None)

    return nbytes(static) + 2 * nbytes(init)


COSTS = CostRegistry()
