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

The scan layer (parallel/scans.py) runs every scan. On a CUDA device
the scan is the hand-written kernel; on the CPU it is the kernel's
plain PyTorch version. A batch the kernel does not carry (custom score
plugins, select_host="sample") is routed by its features, before
anything runs, to the eager torch scan (ops/scan.py) on the same
device, as the JAX engine routes it to its XLA scan; the trace notes
`torch-scan (<reason>)`. That is routing by input, not a fallback: a
kernel that fails raises. Storage classes replay through the oracle's
general bind, pod by pod (simple_commit_mask).

`scan_scenarios(actives)` is the serve daemon's coalesced tick: every
row of `actives` an independent masked scan over the begin_batch
encoding, all rows in ONE launch of the batch kernel (B6) at the site
`scenario_scan`.

The device mesh (parallel/mesh.py; `engine.mesh`, else the process-wide
`current_mesh`): the scan layer's layout planner splits scan_scenarios'
rows into one B6 launch a mesh device when it picks the scenario axis,
and sends a torch-scan batch of scan_active to the node-sharded torch
scan (site `mesh_scan`) when it picks the node axis. A batch the kernel
carries never takes the node route: the mesh serves only what the
kernel does not, as the JAX engine's mesh serves only what its Pallas
plan does not.
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
from ..parallel.scans import Scans
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
        # batch encoding reused across masked rounds (begin_batch), and
        # its scan layer (parallel/scans.py)
        self._batch = None
        self._batch_pods: Optional[List[dict]] = None
        self._features = None
        self._bulk_tbl = None
        self._scans: Optional[Scans] = None
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
            sample = getattr(oracle, "select_host", "first-max") == "sample"
            self._features = features_of_batch(
                cluster, batch,
                weights=getattr(oracle, "score_weights", None),
                sample=sample,
            )
            self._scans = Scans(cluster, batch, self._features, self.device)

    def _scans_now(self) -> Scans:
        """The scan layer over the begin_batch encoding against the
        oracle's CURRENT state (a ClusterStatic rebuild makes a new one;
        the torch scan's static tensors live as long as it does)."""
        cluster = self.cluster_static()
        if self._scans.cluster is not cluster:
            self._scans = Scans(cluster, self._batch, self._features, self.device)
        self._scans.set_dynamic(encode_dynamic(self.oracle, cluster))
        return self._scans

    def scan_active(
        self, active: np.ndarray, valid: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """One masked scan over the begin_batch encoding against the
        oracle's CURRENT state. Returns placements for the full batch:
        node index, -1 (active but unschedulable), or -2 (inactive —
        positions masked off by `active`). `valid` gates candidate nodes
        (default: all)."""
        from ..utils.trace import GLOBAL, phase, profiled

        with phase("engine/encode"):
            scans = self._scans_now()
            node_valid = (
                np.ones(scans.n, bool) if valid is None else np.asarray(valid, bool)
            )
            scans.prepare()
        if not scans.kernel:
            return self._torch_scan(scans, active, node_valid, node_route=True)
        GLOBAL.note("batch-kernel", scans.label())
        with profiled("engine/scan"):
            shares = scans.launch([(np.asarray(active, bool), node_valid,
                                    self._batch.pinned_node)], "scan", batch=False)
            return scans.read(shares)[0]  # waits for the device

    def schedule(self, pods: List[dict]) -> np.ndarray:
        """Returns placements[P]: node index or -1 (unschedulable)."""
        self.begin_batch(pods)
        return self.scan_active(np.ones(len(pods), bool))

    def scenario_plan(self):
        """The kernel plan of the begin_batch encoding against the
        oracle's CURRENT state, for scan_scenarios (and the chunked
        executor's workspace estimate); None for a batch the kernel does
        not carry, which runs on the torch scan."""
        from ..utils.trace import phase

        if not self._scans.kernel:
            return None
        with phase("engine/encode"):
            return self._scans_now().plan

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
        from ..utils.trace import GLOBAL, phase, profiled

        if bool(getattr(self._features, "sample", False)):
            # the Go-RNG stream is a single serial sequence; scenario
            # rows would race for it (core.py routes sample serially)
            raise ValueError(
                "sample-mode batches cannot ride the scenario scan"
            )
        actives_arr = np.asarray(actives, bool)
        if not len(actives_arr):
            return np.zeros((0, len(self._batch.class_of_pod)), np.int32)
        if not self._scans.kernel:
            with phase("engine/encode"):
                scans = self._scans_now()
            valid = np.ones(scans.n, bool)
            GLOBAL.note("scenario-kernel", scans.label())
            return np.stack([self._torch_scan(scans, row, valid, site="scenario_scan")
                             for row in actives_arr])
        if plan is None:
            self.scenario_plan()
        scans = self._scans
        valid = np.ones(scans.n, bool)
        rows = [(row, valid, self._batch.pinned_node) for row in actives_arr]
        # the scenario axis: coalesced request rows are independent, so
        # a mesh splits them into one launch a device
        m = self._mesh()
        if m is not None:
            m = scans.scenario_mesh("scenario_scan", len(actives_arr), m)
        GLOBAL.note("batch-kernel", scans.label(batch=True))
        profile.record_h2d(actives_arr.nbytes)
        with profiled("engine/scan"):
            return scans.read(scans.launch(rows, "scenario_scan", mesh=m))

    def _torch_scan(self, scans, active, node_valid, site: str = "scan",
                    node_route: bool = False) -> np.ndarray:
        """scan_active for a batch the kernel does not carry: the eager
        torch scan (ops/scan.py) on the engine's device. Under sample
        the oracle's Go RNG history goes in and the advanced history is
        written back, so the serial path continues the exact stream.
        With `node_route` the layout planner may send the scan to the
        node-sharded torch scan over the mesh (never under sample)."""
        from ..utils.trace import GLOBAL, phase, profiled

        oracle = self.oracle
        sample = bool(self._features.sample)
        with phase("engine/encode"):
            _static, init = scans.torch_inputs()
            if sample:
                hist0 = oracle._rng.history()
                init = init._replace(rng_hist=torch.as_tensor(
                    np.array(hist0, dtype=np.uint64).view(np.int64), device=self.device))
        m = self._mesh() if node_route and not sample else None
        # site "scan": the single-device torch scan whose workspace
        # says whether one device holds it
        if m is not None and scans.node_route("scan", m, declare=True):
            GLOBAL.note("batch-kernel", f"mesh-scan ({scans.reason})")
            GLOBAL.note("scan-device", self.device.type)
            with profiled("engine/scan"):
                return scans.node_sharded(active, node_valid, m)[0]
        GLOBAL.note("batch-kernel", scans.label())
        GLOBAL.note("scan-device", self.device.type)
        with profiled("engine/scan"):
            placements, final = scans.torch_scan(active, node_valid, self._batch.pinned_node,
                                                 site, state=init)
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
