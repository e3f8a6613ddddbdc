"""Torch engine: drives the fused scan (ops/fused_scan.py) and mirrors
its placements back into the host-side Oracle state.

The Oracle stays the single source of truth for object-level state
(annotations, reports, reason strings); the scan is the compute path.
Every commit the scan makes is replayed on the host through the same
binding code the oracle uses, so oracle state after an engine batch is
identical to having scheduled serially.

Batch lifecycle: `begin_batch` encodes a pod batch ONCE — class
tensors and features; `scan_active(mask)` then runs one scan over any
active subset of that batch against the oracle's CURRENT dynamic
state. A priority round that escapes re-runs the same encoding with
the committed prefix masked off instead of re-encoding the shrinking
remainder.

On a CUDA device the scan is the hand-written kernel; on the CPU it is
the kernel's plain PyTorch version. A batch the kernel does not carry
(custom score plugins, select_host="sample") is routed by its features,
before anything runs, to the eager torch scan (ops/scan.py) on the same
device, as the JAX engine routes it to its XLA scan; the trace notes
`torch-scan (<reason>)`. That is routing by input, not a fallback: a
kernel that fails raises. Storage classes replay through the oracle's
general bind, pod by pod (simple_commit_mask).

`scan_scenarios(actives)` is the serve daemon's coalesced tick: every
row of `actives` an independent masked scan over the begin_batch
encoding, all rows in ONE launch of the batch kernel (B6) at the site
`scenario_scan`.

The device mesh (parallel/mesh.py; `engine.mesh`, else the process-wide
`current_mesh`): the layout planner splits scan_scenarios' rows into one
B6 launch a mesh device when it picks the scenario axis, and sends a
torch-scan batch of scan_active to the node-sharded torch scan (site
`mesh_scan`) when it picks the node axis. A batch the kernel carries
never takes the node route: the mesh serves only what the kernel does
not, as the JAX engine's mesh serves only what its Pallas plan does not.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.encode import (
    ClusterStatic,
    encode_batch,
    encode_cluster_cached,
    encode_dynamic,
    features_of_batch,
)
from ..obs.profile import to_host
from ..ops.fused_scan import resolve_device
from ..runtime.errors import GuardError
from .oracle import Oracle

__all__ = ["SampleRngOverflow", "TorchEngine"]

# per-class summary integers above this magnitude lose int64 headroom
# in the bulk scatter-add; such classes (a >2^55-byte request is ~36 PB
# — malformed input, not a workload) take the per-pod commit path
_BULK_MAX_ABS = 1 << 55


class SampleRngOverflow(GuardError, RuntimeError):
    """A sample-mode Intn draw needed more rejection retries than the
    torch scan's bound (ops/scan.py _RNG_KMAX; p < 1e-17 per draw).
    Raised BEFORE any commit is replayed, so the caller
    (core._schedule_pods) can rerun the batch on the serial oracle,
    whose rejection loop is unbounded."""


class TorchEngine:
    """Holds the oracle plus a per-node-set cache of the cluster
    encoding: with K apps on an N-node cluster the O(N) ClusterStatic
    build runs once, not K times."""

    def __init__(self, oracle: Oracle, device=None):
        self.oracle = oracle
        self.device = resolve_device(device)
        self._cluster: ClusterStatic = None
        self._cache_key = None
        # per-batch replay fast path (class ids are batch scoped):
        # classes with no GPU/storage/extender side effects commit via
        # per-class summaries instead of the general bind
        self._last_class_of = None
        self._last_simple = None
        self._class_commit_info = None
        # batch encoding reused across masked rounds (begin_batch)
        self._batch = None
        self._batch_pods: Optional[List[dict]] = None
        self._features = None
        self._bulk_tbl = None
        # the torch scan's static tensors, reused across masked rounds
        # until a ClusterStatic rebuild (GPU alloc epoch)
        self._scan_static = None
        self._scan_static_cluster = None
        # sample mode: (pre-round rng history, per-pod consumed-word
        # cumsum) of the last scan; rewind_sample_rng uses it when a
        # priority-scan escape discards the scanned tail
        self._last_rng = None
        # device mesh override (None = the process-wide configured mesh,
        # parallel/mesh.py current_mesh)
        self.mesh = None

    def _mesh(self):
        from ..parallel import mesh as mesh_mod

        return self.mesh if self.mesh is not None else mesh_mod.current_mesh(self.device)

    def cluster_static(self) -> ClusterStatic:
        # keyed on (node count, alloc epoch): a bind that mutates node
        # allocatables invalidates the cache for the next batch
        key = (len(self.oracle.nodes), self.oracle.alloc_epoch)
        if self._cluster is None or self._cache_key != key:
            self._cluster = encode_cluster_cached(self.oracle)
            self._cache_key = key
        return self._cluster

    def begin_batch(self, pods: List[dict], groups=None) -> None:
        """Encode `pods` once for any number of scan_active calls.

        Pods with a spec.nodeName naming an unknown node must be
        filtered out by the caller. `groups` is the (group_of, firsts)
        content-group index from workload expansion
        (workloads.ExpandIndex) — class keys then resolve once per group
        instead of once per pod."""
        from ..utils.trace import phase
        from .oracle import ClassCommitCache, simple_commit_mask

        oracle = self.oracle
        with phase("engine/encode"):
            cluster = self.cluster_static()
            batch = encode_batch(oracle, cluster, pods, groups=groups)
            self._batch = batch
            self._batch_pods = pods
            self._last_class_of = np.asarray(batch.class_of_pod)
            self._last_simple = simple_commit_mask(batch, bool(oracle.extenders))
            self._class_commit_info = ClassCommitCache()
            self._bulk_tbl = None
            self._scan_static = None
            sample = getattr(oracle, "select_host", "first-max") == "sample"
            self._features = features_of_batch(
                cluster, batch,
                weights=getattr(oracle, "score_weights", None),
                sample=sample,
            )

    def scan_active(
        self, active: np.ndarray, valid: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """One masked scan over the begin_batch encoding against the
        oracle's CURRENT state. Returns placements for the full batch:
        node index, -1 (active but unschedulable), or -2 (inactive —
        positions masked off by `active`). `valid` gates candidate nodes
        (default: all)."""
        from ..ops import fused_scan
        from ..utils.trace import GLOBAL, phase, profiled

        batch = self._batch
        reason = fused_scan.torch_scan_reason(self._features)
        with phase("engine/encode"):
            cluster = self.cluster_static()
            node_valid = (
                np.ones(cluster.n, bool) if valid is None else np.asarray(valid, bool)
            )
            dyn = encode_dynamic(self.oracle, cluster)
            if reason is None:
                plan = fused_scan.build_plan(
                    cluster, batch, dyn, self._features, device=self.device
                )
        if reason is not None:
            return self._torch_scan(cluster, dyn, active, node_valid, reason, node_route=True)
        GLOBAL.note("batch-kernel", fused_scan.kernel_label(plan))
        with profiled("engine/scan"):
            out, _final = fused_scan.run_fused_scan(
                plan,
                batch.class_of_pod,
                np.asarray(active, bool),
                node_valid,
                pinned=batch.pinned_node,
            )
            return to_host(out)  # waits for the device

    def schedule(self, pods: List[dict]) -> np.ndarray:
        """Returns placements[P]: node index or -1 (unschedulable)."""
        self.begin_batch(pods)
        return self.scan_active(np.ones(len(pods), bool))

    def scenario_plan(self):
        """The kernel plan of the begin_batch encoding against the
        oracle's CURRENT state, for scan_scenarios (and the chunked
        executor's workspace estimate); None for a batch the kernel does
        not carry, which runs on the torch scan."""
        from ..ops import fused_scan
        from ..utils.trace import phase

        if fused_scan.torch_scan_reason(self._features) is not None:
            return None
        with phase("engine/encode"):
            cluster = self.cluster_static()
            dyn = encode_dynamic(self.oracle, cluster)
            return fused_scan.build_plan(
                cluster, self._batch, dyn, self._features, device=self.device
            )

    def scan_scenarios(self, actives: np.ndarray, plan=None) -> np.ndarray:
        """Batch-of-requests entry point (serve/session.py): every row
        of `actives` [Sc, P] is an independent masked scan over the
        begin_batch encoding against the oracle's CURRENT state, all
        nodes valid, the batch's one pin vector committed in pod order.
        Each row's placements equal scan_active(row) run alone
        (scenarios never see each other's commits; nothing is replayed
        here). On a kernel plan the rows are ONE launch of the batch
        kernel (B6) at the site `scenario_scan`; a batch the kernel does
        not carry (custom score plugins) runs row by row on the torch
        scan, trace-noted, as the sweep's probe_scenarios does. `plan`
        is scenario_plan()'s, when the caller built it already against
        the same state (the serve tick, whose halved chunks share it).

        Returns placements [Sc, P]: node index, -1 (active but
        unschedulable), or -2 (masked off in that scenario)."""
        from ..obs import profile
        from ..ops import fused_scan
        from ..utils.trace import GLOBAL, phase, profiled

        if bool(getattr(self._features, "sample", False)):
            # the Go-RNG stream is a single serial sequence; scenario
            # rows would race for it (core.py routes sample serially)
            raise ValueError(
                "sample-mode batches cannot ride the scenario scan"
            )
        batch = self._batch
        actives_arr = np.asarray(actives, bool)
        if not len(actives_arr):
            return np.zeros((0, len(batch.class_of_pod)), np.int32)
        reason = fused_scan.torch_scan_reason(self._features)
        if reason is not None:
            with phase("engine/encode"):
                cluster = self.cluster_static()
                dyn = encode_dynamic(self.oracle, cluster)
            valid = np.ones(cluster.n, bool)
            GLOBAL.note("scenario-kernel", f"torch-scan ({reason})")
            rows = [self._torch_scan(cluster, dyn, row, valid, reason,
                                     site="scenario_scan")
                    for row in actives_arr]
            return np.stack(rows)
        if plan is None:
            plan = self.scenario_plan()
        valid = np.ones(plan.n, bool)
        scenarios = [(row, valid, batch.pinned_node) for row in actives_arr]
        # the scenario axis: coalesced request rows are independent, so
        # a mesh splits them into one launch a device
        from ..parallel import mesh as mesh_mod

        m = self._mesh()
        if m is not None:
            layout = mesh_mod.plan_layout("scenario_scan", mesh=m,
                                          n_scenarios=len(actives_arr), n_nodes=plan.n)
            if layout.axis != "scenario":
                m = None
        GLOBAL.note("batch-kernel", f"{fused_scan.BATCH_KERNEL_NAME} ({self.device.type})")
        profile.record_h2d(actives_arr.nbytes)
        with profiled("engine/scan"):
            if m is not None:
                shares = mesh_mod.launch_rows(m, plan, batch.class_of_pod, scenarios,
                                              site="scenario_scan")
                return np.concatenate([
                    to_host(torch.stack([placements for placements, _final in outs]))
                    for _p, _lo, _hi, outs in shares])
            out = fused_scan.run_fused_scan_batch(
                plan,
                batch.class_of_pod,
                scenarios,
                pins_first=False,
                site="scenario_scan",
            )
            return to_host(torch.stack([placements for placements, _final in out]))

    def _torch_scan(self, cluster, dyn, active, node_valid, reason,
                    site: str = "scan", node_route: bool = False) -> np.ndarray:
        """scan_active for a batch the kernel does not carry: the eager
        torch scan (ops/scan.py) on the engine's device. Under sample
        the oracle's Go RNG history goes in and the advanced history is
        written back, so the serial path continues the exact stream.
        With `node_route` the layout planner may send the scan to the
        node-sharded torch scan over the mesh (never under sample)."""
        from ..obs.costs import COSTS, scan_bytes
        from ..ops import scan as scan_ops
        from ..ops.encode import to_scan_static, to_scan_state
        from ..utils.trace import GLOBAL, phase, profiled

        oracle = self.oracle
        batch = self._batch
        sample = bool(self._features.sample)
        with phase("engine/encode"):
            if self._scan_static is None or self._scan_static_cluster is not cluster:
                self._scan_static = to_scan_static(cluster, batch, device=self.device)
                self._scan_static_cluster = cluster
            init = to_scan_state(dyn, batch, device=self.device)
            if sample:
                hist0 = oracle._rng.history()
                init = init._replace(rng_hist=torch.as_tensor(
                    np.array(hist0, dtype=np.uint64).view(np.int64), device=self.device))
        m = self._mesh() if node_route and not sample else None
        if m is not None:
            from ..parallel import mesh as mesh_mod

            # site "scan": the single-device torch scan whose workspace
            # says whether one device holds it
            COSTS.declare_bytes("scan", scan_bytes(self._scan_static, init))
            layout = mesh_mod.plan_layout("scan", mesh=m, n_scenarios=1, n_nodes=cluster.n)
            if layout.axis == "node":
                GLOBAL.note("batch-kernel", f"mesh-scan ({reason})")
                GLOBAL.note("scan-device", self.device.type)
                with profiled("engine/scan"):
                    out, *_stats = mesh_mod.run_node_sharded(
                        m, self._scan_static, init, batch.class_of_pod, batch.pinned_node,
                        node_valid, np.asarray(active, bool), self._features)
                return out
        GLOBAL.note("batch-kernel", f"torch-scan ({reason})")
        GLOBAL.note("scan-device", self.device.type)
        with profiled("engine/scan"):
            placements, final = scan_ops.run_scan_masked(
                self._scan_static, init, batch.class_of_pod, batch.pinned_node,
                node_valid, np.asarray(active, bool), features=self._features,
                site=site,
            )
            if sample:
                placements, consumed = placements
            out = to_host(placements)  # waits for the device
        if sample:
            if bool(final.rng_overflow):
                # oracle state is untouched (commits replay only after
                # this returns); core catches this and reruns serially
                raise SampleRngOverflow(
                    "sample-mode RNG rejection overflow; rerunning the "
                    "batch on the serial oracle"
                )
            self._last_rng = (hist0, np.cumsum(consumed.cpu().numpy()))
            oracle._rng.set_history(
                [int(x) for x in final.rng_hist.cpu().numpy().view(np.uint64)]
            )
        return out

    def rewind_sample_rng(self, batch_pos: int) -> None:
        """Reposition the oracle's sample-mode stream to where it stood
        BEFORE the last scanned round's pod at `batch_pos` consumed its
        draws. A priority-scan escape discards every scanned placement
        from the escape point on and reschedules those pods, so their
        draws must be un-consumed: the pre-round history advanced by the
        consumed-word prefix is exactly that position
        (gorand.advance_history). Masked-off pods consume zero words."""
        if self._last_rng is None:
            return
        from ..utils.gorand import advance_history

        hist0, consumed_cum = self._last_rng
        k = int(consumed_cum[batch_pos - 1]) if batch_pos > 0 else 0
        self.oracle._rng.set_history(advance_history(hist0, k))

    def commit_host(self, pod: dict, node_idx: int):
        """Replay one placement into oracle state (same binding code the
        serial path uses, incl. GPU/storage side effects)."""
        self.oracle._reserve_and_bind(pod, self.oracle.nodes[int(node_idx)])

    def commit_host_at(self, pod: dict, node_idx: int, batch_pos: int):
        """commit_host with the pod's position in the last scheduled
        batch: classes with no GPU/storage/extender side effects reduce
        _reserve_and_bind to nodeName+phase+commit, and class members
        share request/port content by class-key construction, so the
        summary/port walk runs once per class."""
        cls_of = self._last_class_of
        if cls_of is not None and batch_pos < len(cls_of):
            cls = int(cls_of[batch_pos])
            if self._last_simple[cls]:
                self._class_commit_info.commit(
                    self.oracle, pod, self.oracle.nodes[int(node_idx)], cls
                )
                return
        self.commit_host(pod, node_idx)

    def bulk_tables(self):
        """(field_tbl[U,7] int64, ports_of_cls, scalars_of_cls,
        bulk_ok[U] bool) for commit_host_bulk — the per-class
        RequestSummary integers resolved once per batch."""
        if self._bulk_tbl is None:
            self._bulk_tbl = build_bulk_tables(self._batch, self._last_simple)
        return self._bulk_tbl

    def commit_host_bulk(self, pods, node_idx, cls_ids, prios=None):
        """Bulk replay of a contiguous run of simple-class placements
        (oracle.commit_simple_bulk). Callers gate on `simple &
        bulk_ok`; anything else goes through commit_host_at."""
        field_tbl, ports_of, scalars_of, _ok = self.bulk_tables()
        self.oracle.commit_simple_bulk(
            pods, node_idx, cls_ids, field_tbl, ports_of, scalars_of,
            prios=prios,
        )


def build_bulk_tables(batch, simple_mask):
    """Per-class commit tables from a PodBatch's class representatives.
    Only classes marked simple get real rows; the rest never reach the
    bulk path."""
    from ..models import requests as req
    from .oracle import _pod_host_ports

    u = batch.u
    field_tbl = np.zeros((u, 7), dtype=np.int64)
    ports_of = [()] * u
    scalars_of = [()] * u
    bulk_ok = np.zeros(u, dtype=bool)
    for u_i, pod in enumerate(batch.class_pods):
        if not simple_mask[u_i]:
            continue
        s = req.pod_request_summary(pod)
        vals = (s.mcpu, s.mem, s.eph, s.floor_mcpu, s.floor_mem,
                s.nz_mcpu, s.nz_mem)
        if any(abs(v) > _BULK_MAX_ABS for v in vals) or any(
            abs(iv) > _BULK_MAX_ABS for _n, iv in s.scalars
        ):
            continue  # int64 headroom guard: per-pod path
        field_tbl[u_i] = vals
        ports_of[u_i] = tuple(_pod_host_ports(pod))
        scalars_of[u_i] = s.scalars
        bulk_ok[u_i] = True
    return field_tbl, ports_of, scalars_of, bulk_ok
