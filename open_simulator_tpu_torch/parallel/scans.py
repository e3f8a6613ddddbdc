"""The scan layer: how the scans of one encoding run.

Between the callers (parallel/sweep.py's probes and outage rows,
scheduler/engine.py's batches and serve ticks, parallel/defrag.py's
drain depths) and the implementations, this is the only code that
chooses a scan's route and holds what each route needs: the CUDA kernel
(ops/fused_scan.py; one scenario, or a batch of rows in one launch, B6,
pins-first for the outage rows) from one plan and its pins-on copy; the
eager torch scan (ops/scan.py), a row at a time, for a batch
`fused_scan.torch_scan_reason` says the kernel does not carry; the mesh
(parallel/mesh.py), rows split one batch launch a device or one torch
scan split by node, as the layout planner picks; and the serial oracle,
only as the chunked executor's floor on the CPU.

Every route gives a row's placements and its integer sums over the
valid nodes; `utilisation` divides them, the one place the port does.
Phases, trace notes, journals and masks stay with the callers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..obs.costs import COSTS, scan_bytes
from ..obs.profile import to_host
from ..ops import fused_scan
from ..runtime.guard import run_chunked
from . import mesh as mesh_mod

__all__ = ["Scans", "utilisation"]


def utilisation(placements, used_c, alloc_c, used_m, alloc_m, used_v, cap_v):
    """(unscheduled, cpu %, mem %, vg %) of one scan from its placements
    and its sums over the valid nodes (the JAX package's _pallas_result
    arithmetic)."""
    return (
        int((np.asarray(placements) == -1).sum()),
        100.0 * float(used_c) / max(int(alloc_c), 1),
        100.0 * float(used_m) / max(int(alloc_m), 1),
        100.0 * float(used_v) / max(int(cap_v), 1),
    )


def _stack(ts):
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


class Scans:
    """The scans of one encoding (ClusterStatic, PodBatch, ScanFeatures)
    on `device`, against the dynamic state `dyn` (`set_dynamic` moves
    it). The kernel plan and the torch scan's inputs are built at first
    use and kept until the state moves; the torch scan's static tensors
    stay for the encoding's life."""

    def __init__(self, cluster, batch, features, device, dyn=None):
        self.cluster = cluster
        self.batch = batch
        self.features = features
        self.device = device
        self.reason = fused_scan.torch_scan_reason(features)
        self._static = None
        self.set_dynamic(dyn)

    def set_dynamic(self, dyn) -> None:
        self.dyn = dyn
        self._plan = self._pins_plan = self._state = self._node_plan = None
        self._mesh_plans: dict = {}

    @property
    def n(self) -> int:
        return int(self.cluster.n)

    @property
    def kernel(self) -> bool:
        """The kernel carries the batch (else the torch scan runs it)."""
        return self.reason is None

    @property
    def plan(self) -> Optional[fused_scan.FusedPlan]:
        """The kernel plan; None for a batch on the torch scan."""
        if self._plan is None and self.kernel:
            self._plan = fused_scan.build_plan(self.cluster, self.batch, self.dyn,
                                               self.features, device=self.device)
        return self._plan

    def pins_plan(self) -> fused_scan.FusedPlan:
        """The plan with pins on (the same tensors): outage rows pin
        survivors even when the batch itself carries no pin."""
        if self._pins_plan is None:
            self._pins_plan = dataclasses.replace(self.plan, has_pins=True)
        return self._pins_plan

    def torch_inputs(self):
        """The torch scan's (ScanStatic, ScanState)."""
        from ..ops.encode import to_scan_state, to_scan_static

        if self._static is None:
            self._static = to_scan_static(self.cluster, self.batch, device=self.device)
        if self._state is None:
            self._state = to_scan_state(self.dyn, self.batch, device=self.device)
        return self._static, self._state

    def prepare(self) -> Optional[fused_scan.FusedPlan]:
        """Build the kernel plan now, where the caller times it (the
        torch scan's inputs are built at its first row)."""
        return self.plan

    def label(self, batch: bool = False, pins_first: bool = False) -> str:
        """What runs, for the callers' trace notes."""
        if not self.kernel:
            return f"torch-scan ({self.reason})"
        if not batch:
            return fused_scan.kernel_label(self.plan)
        name = fused_scan.PINS_FIRST_KERNEL_NAME if pins_first else fused_scan.BATCH_KERNEL_NAME
        return f"{name} ({self.plan.device.type})"

    # -- the layout planner -------------------------------------------------

    def _layout(self, site: str, mesh, n_scenarios: int) -> str:
        return mesh_mod.plan_layout(site, mesh=mesh, n_scenarios=n_scenarios, n_nodes=self.n,
                                    sample=bool(getattr(self.features, "sample", False))).axis

    def scenario_mesh(self, site: str, n_scenarios: int, mesh):
        """`mesh` when the planner splits `n_scenarios` rows at `site`
        over it, else None."""
        return mesh if self._layout(site, mesh, n_scenarios) == "scenario" else None

    def node_route(self, site: str, mesh, declare: bool = False) -> bool:
        """Whether the planner sends one torch scan at `site` to the node
        axis of `mesh`; `declare` first declares the scan's workspace at
        `site` for the ledger's fit prediction."""
        if declare:
            COSTS.declare_bytes(site, scan_bytes(*self.torch_inputs()))
        return self._layout(site, mesh, 1) == "node"

    # -- the kernel ---------------------------------------------------------

    def inputs(self, rows):
        """The kernel inputs of `rows` [(active, valid, pinned)], made
        ahead of `launch` so a caller can time their copy."""
        return fused_scan.scenario_inputs(self.plan, self.batch.class_of_pod, rows)

    def launch(self, rows, site: str, *, batch: bool = True, pins_first: bool = False,
               mesh=None, inputs=None):
        """Launch `rows` [(active, valid, pinned)] at `site` without
        waiting: one scenario on the single-scan kernel (`batch` False),
        else one batch launch, or with `mesh` one a mesh device over its
        share. Returns [(plan, lo, hi, [(placements, final), ...])] in
        row order, on the launches' devices."""
        plan = self.pins_plan() if pins_first else self.plan
        cls = self.batch.class_of_pod
        if mesh is not None:
            return mesh_mod.launch_rows(mesh, plan, cls, rows, site=site, pins_first=pins_first,
                                        plans=self._mesh_plans)
        if not batch:
            ((active, valid, pinned),) = rows
            return [(plan, 0, 1, [fused_scan.run_fused_scan(
                plan, cls, active, valid, pinned=pinned, site=site, inputs=inputs)])]
        return [(plan, 0, len(rows), fused_scan.run_fused_scan_batch(
            plan, cls, rows, pins_first=pins_first, site=site, inputs=inputs))]

    def read(self, shares, valid=None):
        """The launches' rows read back: their placements [Sc, P], or with
        `valid` (the rows' node masks) [(placements [P] int64, sums)]
        row by row."""
        if valid is None:
            return np.concatenate([to_host(_stack([r[0] for r in rows]))
                                   for _p, _lo, _hi, rows in shares])
        out = []
        for _p, lo, hi, rows in shares:
            out.extend(self._reduce([r[0] for r in rows], [r[1] for r in rows], valid[lo:hi]))
        return out

    def _reduce(self, placements, finals, valid):
        """(placements, sums) of one launch's rows: the used sums reduced
        on its device (two reads in all), the allocatable ones on the
        host; a plan without the storage block never grows VG usage, so
        its base is final."""
        placements = _stack(placements)
        dev = placements.device
        valid = np.asarray(valid, dtype=bool)
        v = torch.from_numpy(np.ascontiguousarray(valid)).to(dev)
        cols = [_stack([f["used_mcpu"] for f in finals]), _stack([f["used_mem"] for f in finals])]
        if "vg_used" in finals[0]:
            cols.append(_stack([f["vg_used"].sum(0) for f in finals]))
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        used = to_host(torch.stack([torch.where(v, c, zero).sum(1) for c in cols], 1))
        c, i64 = self.cluster, np.int64
        alloc_c, alloc_m, cap_v = (valid @ np.asarray(x, i64) for x in (
            c.alloc_mcpu, c.alloc_mem, np.asarray(c.vg_cap, i64).sum(1)))
        used_v = used[:, 2] if len(cols) > 2 else valid @ np.asarray(self.dyn.vg_used, i64).sum(1)
        placements = to_host(placements).astype(np.int64)
        return [(placements[k], (int(used[k, 0]), int(alloc_c[k]), int(used[k, 1]),
                                 int(alloc_m[k]), int(used_v[k]), int(cap_v[k])))
                for k in range(len(finals))]

    def host_sums(self, valid, placements):
        """The sums of placements made on the host (the serial oracle):
        each placed pod's request onto the encoded base usage."""
        b, d, c = self.batch, self.dyn, self.cluster
        v = np.asarray(valid)
        cls = np.asarray(b.class_of_pod)[np.asarray(placements) >= 0]
        return (int(d.used_mcpu[v].sum()) + int(b.req_mcpu[cls].sum()), int(c.alloc_mcpu[v].sum()),
                int(d.used_mem[v].sum()) + int(b.req_mem[cls].sum()), int(c.alloc_mem[v].sum()),
                int(d.vg_used[v].sum()) + int(b.lvm_sizes[cls].sum()), int(c.vg_cap[v].sum()))

    # -- the torch scan -----------------------------------------------------

    def torch_scan(self, active, valid, pinned, site: str, pins_first: bool = False,
                   state=None):
        """One row on the torch scan from `state` (default: the encoded
        one): one pass at `site` in pod order, or with `pins_first` the
        reference's two chained passes (_scenario_pinned_impl), every
        pinned pod first. Returns (placements, final state) as
        run_scan_masked does."""
        from ..ops import scan as scan_ops

        static, init = self.torch_inputs()
        init = init if state is None else state
        cls = self.batch.class_of_pod
        valid = np.asarray(valid, dtype=bool)
        active = np.asarray(active, dtype=bool)
        pinned = np.asarray(pinned, dtype=np.int64)
        if not pins_first:
            return scan_ops.run_scan_masked(static, init, cls, pinned, valid, active,
                                            features=self.features, site=site)
        features = self.features._replace(pins=True)
        p1, mid = scan_ops.run_scan_masked(static, init, cls, pinned, valid, active & (pinned >= 0),
                                           features=features, site=site)
        p2, final = scan_ops.run_scan_masked(static, mid, cls, pinned, valid, active & (pinned < 0),
                                             features=features, site=site)
        return torch.where(torch.as_tensor(pinned >= 0, device=p1.device), p1, p2), final

    def torch_row(self, active, valid, pinned, site: str, pins_first: bool = False):
        """(placements [P] int64, sums) of one row on the torch scan."""
        placements, final = self.torch_scan(active, valid, pinned, site, pins_first)
        used = {"used_mcpu": final.used_mcpu, "used_mem": final.used_mem,
                "vg_used": final.vg_used.T}
        return self._reduce([placements], [used], [valid])[0]

    def node_sharded(self, active, valid, mesh):
        """(placements [P] int64, sums) of one torch scan split by node
        over `mesh` (site `mesh_scan`); the split state is made once a
        state and mesh."""
        if self._node_plan is None or self._node_plan.mesh is not mesh:
            static, init = self.torch_inputs()
            self._node_plan = mesh_mod.NodeShardPlan(mesh, static, init, self.batch.class_of_pod,
                                                     self.batch.pinned_node, self.features)
        return self._node_plan.run(valid, active)

    # -- rows through the chunked executor ----------------------------------

    def chunked(self, evaluate, n: int, *, site: str, label: str, pins_first: bool = False,
                mesh=None, serial: Optional[Callable] = None, budget=None) -> list:
        """`evaluate(lo, hi)` over `n` rows through the chunked executor:
        a device OOM halves a chunk, against the workspace estimate of a
        launch at `site` a mesh device; `serial(i)` is the floor of a
        single row that still runs out, on the CPU only (on the card the
        row raises)."""
        shards = mesh.size if mesh is not None and self.kernel else 1
        estimate = (COSTS.chunk_estimator(site, self.pins_plan() if pins_first else self.plan,
                                          len(self.batch.class_of_pod), shards=shards)
                    if self.kernel else None)
        return run_chunked(evaluate, n, label=label, budget=budget, estimate=estimate,
                           serial_fallback=serial if self.device.type == "cpu" else None,
                           shards=shards)

    def run_rows(self, n: int, row: Callable, *, site: str, label: str,
                 pins_first: bool = False, mesh=None, mesh_site: Optional[str] = None,
                 serial: Optional[Callable] = None, budget=None) -> tuple:
        """`n` rows, `row(i)` = (active, valid, pinned), each one scan at
        `site` (`mesh_site` on a mesh), in pod order or `pins_first`: a
        chunk is one kernel launch (one a mesh device) or its rows one
        by one on the torch scan. `serial` is the serial oracle
        (CapacitySweep.serial_scenario), the CPU floor. Returns
        (placements [n, P], unscheduled [n], cpu [n], mem [n], vg [n])
        as numpy arrays."""
        def result(placements, sums):
            return (placements, *utilisation(placements, *sums))

        def evaluate(lo, hi):
            rows = [row(i) for i in range(lo, hi)]
            if not self.kernel:
                return [result(*self.torch_row(*r, site=site, pins_first=pins_first))
                        for r in rows]
            shares = self.launch(rows, mesh_site if mesh is not None and mesh_site else site,
                                 pins_first=pins_first, mesh=mesh)
            return [result(*r) for r in self.read(shares, [r[1] for r in rows])]

        def floor(i):
            active, valid, pinned = row(i)
            placements, _reasons = serial(valid, active, pinned, pins_first=pins_first)
            return result(placements, self.host_sums(valid, placements))

        rows = self.chunked(evaluate, n, site=site, label=label, pins_first=pins_first,
                            mesh=mesh, serial=floor if serial is not None else None,
                            budget=budget)
        return (np.stack([np.asarray(r[0]) for r in rows]),
                np.array([int(r[1]) for r in rows], dtype=np.int64),
                *(np.array([float(r[k]) for r in rows]) for k in (2, 3, 4)))
