"""Fused sequential-commit scheduling scan: the GPU counterpart of the
JAX package's ops/pallas_scan.py.

One CUDA kernel (csrc/fused_scan.cu) runs the whole pod loop on the
card: per pod, filter (NodeResourcesFit on cpu/memory/ephemeral with
the zero-request gate, pod count, the class's static feasible row, the
scenario's node mask), score (LeastAllocated, BalancedAllocation in
f64, Simon min-max, NodeAffinity and TaintToleration normalised over
the feasible nodes, the prefolded ImageLocality / NodePreferAvoidPods
row), first-max select with ties to the lowest node index, nodeName
pins, INACTIVE pods, and the commit of the per-node states. Launch
shapes, counted apart:

- `fused_scan_base`: one scenario, base plan;
- `fused_scan_ext`: one scenario with any of the scalar-resource,
  hostPort and GPU-share blocks (compile-time flags of the same
  kernel), which extend the fit and the commit;
- `fused_scan_store`, `fused_scan_terms`, `fused_scan_store_terms`: one
  scenario with the open-local storage block, the inter-pod affinity /
  topology-spread block, or both (the B2 blocks ride along as runtime
  branches there);
- `fused_scan_batch`: several (active, valid, pinned) scenarios of one
  plan in one launch, one cluster per scenario, with the same flags;
  with its pins-first mode on (a runtime flag, counted apart as
  `fused_scan_batch (pins-first)`) each scenario commits its pinned
  pods before any free pod schedules: the outage rows of the chaos
  engine (the JAX package's two chained scans, _scenario_pinned_impl).

The semantics are those of the JAX package's XLA scan (ops/scan.py),
which is conformance-tested against the serial oracle; the TPU kernel's
layout is not copied: state and class tables are int64 in true units
over the unpadded node axis, with no GCD scaling, no (R, 128) tiles, no
class-row dedup and no cap on scalar kinds, GPUs per node, ports, VGs,
devices, volumes, term rows or spread constraints. Inter-pod term
counts live in VALUE space (one ragged row of counts per term row,
indexed by topology value, `t_off` giving each row's offset): a read is
the gather `count[off[r] + topo[r, n]]`, a commit one add per row.

Kernel note. It replaces `pallas_scan._make_kernel` (the `pl.pallas_call`
in `run_scan_pallas`, resident and streamed term layouts alike) and
`run_scan_pallas_batch`. On an H100 it is bound by its serial chain: P
pod steps, each depending on the previous step's commit, each passes
over the node axis around reductions over all of it. Every
instantiation runs one scenario on a thread-block cluster of C blocks
(`cluster_size`: C grows with the node count up to 16 and steps down
so that a batch's clusters are resident together), each block owning a
contiguous node slice whose rows stay in its shared memory when they
fit (`launch_shape`); cluster barriers join the blocks' reductions, two
a step for the base plan. A term row whose values each sit on one node
(`node_owned`: hostname keys) keeps its counts in the scenario's value
space, touched only by the block owning the node; every block keeps a
replica of the other rows' counts and applies every commit to it.
Every node has one owner thread; see the source for the details.

`fused_scan_batch_reference` is the plain PyTorch version of the same
function: an eager loop over the pods, one step vectorised over the
[scenario, node] axes each; `fused_scan_reference` is its one-scenario
case. The wrappers take the plain version for a plan on the CPU and
launch the kernel for a plan on a CUDA device; there is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..obs import profile
from ..utils import nvcc

MAX_SCORE = 100
INACTIVE = -2
KERNEL_NAME = "fused_scan_base"
EXT_KERNEL_NAME = "fused_scan_ext"
STORE_KERNEL_NAME = "fused_scan_store"
TERMS_KERNEL_NAME = "fused_scan_terms"
STORE_TERMS_KERNEL_NAME = "fused_scan_store_terms"
BATCH_KERNEL_NAME = "fused_scan_batch"
# the scenario batch with its pins-first mode on (the same
# instantiations, a runtime flag): counted apart
PINS_FIRST_KERNEL_NAME = "fused_scan_batch (pins-first)"
STATE_FIELDS = ("used_mcpu", "used_mem", "used_eph", "nz_mcpu", "nz_mem", "pod_cnt")
# value-space term state rows of the [4, VT] array, in order
TERM_FIELDS = ("tgt", "own_anti_req", "own_aff_pref_w", "own_anti_pref_w")
# final rows of the storage block and the term block
STORE_ROWS = ("vg_used", "ssd_used", "hdd_used")
TERM_ROWS = TERM_FIELDS + ("group_counts", "group_total", "soft_counts")

# launches per kernel, counted where the wrapper launches it and
# nowhere else (chip_smoke.py reads them around each path)
LAUNCHES = {name: 0 for name in (
    KERNEL_NAME, EXT_KERNEL_NAME, STORE_KERNEL_NAME, TERMS_KERNEL_NAME,
    STORE_TERMS_KERNEL_NAME, BATCH_KERNEL_NAME, PINS_FIRST_KERNEL_NAME)}
# the cluster size of each kernel's last launch
CLUSTERS = {name: None for name in LAUNCHES}

SOURCE = nvcc.CSRC / "fused_scan.cu"
_LIB = None
# first use may come from several threads at once (the serve daemon's
# dispatcher and a /v1/cluster-delta handler): one builds and loads
_LIB_LOCK = threading.Lock()


class OutOfSliceError(NotImplementedError):
    """The input uses a feature the GPU port does not carry yet. Names
    the feature and the ROADMAP.md item that ports it."""

    def __init__(self, feature: str, item: str):
        self.feature = feature
        self.item = item
        super().__init__(
            f"{feature} is not in the GPU port yet (ROADMAP.md {item})"
        )


class NoCardError(RuntimeError):
    """An entry point was asked for the card and there is none."""


class NotInKernelError(ValueError):
    """A batch the fused kernel does not carry was given to build_plan.
    The engine routes such a batch to the eager torch scan (ops/scan.py)
    by its features, before it builds a plan."""


# (ScanFeatures flag, what it is): batches the kernel does not carry;
# the torch scan carries them, as the JAX package's XLA scan carries
# what its Pallas plan rejects
_NOT_IN_KERNEL = (
    ("custom", "custom score plugins"),
    ("sample", 'select_host="sample"'),
)


def torch_scan_reason(features) -> Optional[str]:
    """Why the batch runs on the torch scan and not on the kernel, or
    None when the kernel carries it."""
    found = [what for flag, what in _NOT_IN_KERNEL if getattr(features, flag, False)]
    return " and ".join(found) or None


def check_in_kernel(features) -> None:
    """Raise NotInKernelError for a batch the kernel does not carry."""
    reason = torch_scan_reason(features)
    if reason is not None:
        raise NotInKernelError(
            f"{reason}: not in the fused kernel; the torch scan "
            "(ops/scan.py run_scan_masked) carries them"
        )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. A CUDA device without a card raises; it never turns
    into the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCardError(
            "the CUDA engine needs a GPU but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain version"
        )
    return dev


@dataclass
class FusedPlan:
    """The kernel's inputs for one batch, int64 in true units. The rows
    of an optional block are None when the batch does not use it."""

    n: int
    u: int
    alloc: torch.Tensor  # [4, N] mcpu, mem, eph, pods
    init: torch.Tensor  # [6, N] state rows in STATE_FIELDS order
    cls_req: torch.Tensor  # [U, 6] req mcpu/mem/eph, nz mcpu/mem, has_request
    feasible: torch.Tensor  # [U, N] bool static feasibility
    cls_tab: torch.Tensor  # [4, U, N] simon, nodeaff, taint, prefolded base
    # (least, balanced, simon + gpushare, nodeaff, tainttol, spread, ipa,
    # openlocal): the JAX PallasPlan's `w` order
    weights: tuple
    has_pins: bool
    # extended scalar resources, K kinds
    scal_alloc: Optional[torch.Tensor] = None  # [K, N]
    scal_init: Optional[torch.Tensor] = None  # [K, N] used
    scal_req: Optional[torch.Tensor] = None  # [U, K]
    # open-gpu-share, G devices per node
    gpu_node: Optional[torch.Tensor] = None  # [3, N] per-device mem, count, total
    gpu_init: Optional[torch.Tensor] = None  # [G, N] per-device used mem
    gpu_cls: Optional[torch.Tensor] = None  # [U, 2] per-GPU mem, GPU count
    # hostPorts as int32 words over the port vocab (port p = bit p & 31
    # of word p >> 5)
    port_init: Optional[torch.Tensor] = None  # [W, N] occupied ports
    port_cls: Optional[torch.Tensor] = None  # [2, U, W] want, conflict
    # open-local storage (B3): capacities with invalid slots at 0, SSD /
    # HDD devices ascending by capacity, volume sizes 0-padded (device
    # volumes ascending)
    vg_cap: Optional[torch.Tensor] = None  # [V, N]
    vg_init: Optional[torch.Tensor] = None  # [V, N] requested
    ssd_cap: Optional[torch.Tensor] = None  # [Ds, N]
    ssd_init: Optional[torch.Tensor] = None  # [Ds, N] uint8 allocated
    hdd_cap: Optional[torch.Tensor] = None  # [Dh, N]
    hdd_init: Optional[torch.Tensor] = None  # [Dh, N] uint8
    has_storage: Optional[torch.Tensor] = None  # [N] uint8
    cls_lvm: Optional[torch.Tensor] = None  # [U, Lv] in declaration order
    cls_ssd: Optional[torch.Tensor] = None  # [U, Sv]
    cls_hdd: Optional[torch.Tensor] = None  # [U, Hv]
    cls_wants: Optional[torch.Tensor] = None  # [U] uint8
    # inter-pod affinity + topology spread (B4): T term rows, A
    # required-affinity group rows, Ch hard and Cs soft constraint
    # instances; value-space rows offset by t_off / g_off / s_off
    topo: Optional[torch.Tensor] = None  # [T, N] int32 value id, -1 = no key
    t_off: Optional[torch.Tensor] = None  # [T + 1]
    # match, carry_anti_req, carry_pref_comb (HARD_POD_AFFINITY_WEIGHT x
    # required + preferred affinity), carry_anti_pref_w, carry_aff_pref_w
    t_cls: Optional[torch.Tensor] = None  # [5, U, T]
    cls_rows: Optional[torch.Tensor] = None  # [U, R] int32, -1 pad
    g_topo: Optional[torch.Tensor] = None  # [A, N] int32
    g_off: Optional[torch.Tensor] = None  # [A + 1]
    g_match: Optional[torch.Tensor] = None  # [U, A] uint8 class matches the group
    cls_grows: Optional[torch.Tensor] = None  # [U, Gm] int32, -1 pad
    cls_gid: Optional[torch.Tensor] = None  # [U] int32, -1 = no required affinity
    g_self: Optional[torch.Tensor] = None  # [U] uint8 class matches its own group
    h_row: Optional[torch.Tensor] = None  # [Ch] int32 term row
    h_skew: Optional[torch.Tensor] = None  # [Ch] maxSkew
    h_self: Optional[torch.Tensor] = None  # [Ch, U] uint8
    h_cand: Optional[torch.Tensor] = None  # [Ch, N] uint8 candidate nodes
    cls_hrows: Optional[torch.Tensor] = None  # [U, Hm] int32, -1 pad
    s_row: Optional[torch.Tensor] = None  # [Cs] int32 term row
    s_host: Optional[torch.Tensor] = None  # [Cs] uint8 hostname key
    s_skew: Optional[torch.Tensor] = None  # [Cs] maxSkew
    s_q: Optional[torch.Tensor] = None  # [Cs, N] uint8 qualifying nodes
    cls_srows: Optional[torch.Tensor] = None  # [U, Sm] int32, -1 pad
    s_haskeys: Optional[torch.Tensor] = None  # [U, N] uint8
    s_off: Optional[torch.Tensor] = None  # [Cs + 1]
    log_tab: Optional[torch.Tensor] = None  # [N + 1] f64 log(k + 2)
    t_init: Optional[torch.Tensor] = None  # [4, VT] TERM_FIELDS
    g_init: Optional[torch.Tensor] = None  # [VA] group counts
    gt_init: Optional[torch.Tensor] = None  # [A] group totals
    s_init: Optional[torch.Tensor] = None  # [VS] soft counts
    # each term, group and soft row's offset in a block's replica of the
    # shared rows' counts, -1 for a node-owned row (replica_offsets)
    t_rep: Optional[torch.Tensor] = None  # [T]
    g_rep: Optional[torch.Tensor] = None  # [A]
    s_rep: Optional[torch.Tensor] = None  # [Cs]

    @property
    def device(self) -> torch.device:
        return self.alloc.device

    @property
    def has_scal(self) -> bool:
        return self.scal_alloc is not None

    @property
    def has_gpu(self) -> bool:
        return self.gpu_node is not None

    @property
    def has_ports(self) -> bool:
        return self.port_init is not None

    @property
    def has_store(self) -> bool:
        return self.vg_cap is not None

    @property
    def has_terms(self) -> bool:
        return self.topo is not None

    @property
    def ext(self) -> bool:
        """Whether any of the B2 blocks is on."""
        return self.has_scal or self.has_gpu or self.has_ports

    def to(self, device) -> "FusedPlan":
        moved = {}
        for f in fields(self):
            v = getattr(self, f.name)
            moved[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return FusedPlan(**moved)


def _score_weights(features):
    """The batch's ScoreWeights (the default profile's when unset)."""
    from ..scheduler.schedconfig import DEFAULT_SCORE_WEIGHTS, ScoreWeights

    w = features.weights
    return DEFAULT_SCORE_WEIGHTS if w is None else ScoreWeights(*w)


def _weights(w) -> tuple:
    return (int(w.least), int(w.balanced), int(w.simon) + int(w.gpushare),
            int(w.nodeaff), int(w.tainttol), int(w.spread), int(w.ipa),
            int(w.openlocal))


def pack_port_words(mask_tn: np.ndarray) -> np.ndarray:
    """(T, N) bool -> (max(ceil(T/32), 1), N) int32 words, row t at bit
    t & 31 of word t >> 5."""
    mask_tn = np.asarray(mask_tn, dtype=bool)
    t_rows, n_cols = mask_tn.shape
    words = np.zeros((max(-(-t_rows // 32), 1), n_cols), dtype=np.uint32)
    for t in range(t_rows):
        words[t >> 5] |= mask_tn[t].astype(np.uint32) << np.uint32(t & 31)
    return words.view(np.int32)


def _ragged(topo: np.ndarray):
    """The value-space offsets of a [R, N] value-id table: row r holds
    values 0..max(topo[r]), its counts start at off[r]. Every
    value-space array is one longer than off[-1]: the spare slot keeps
    the gather of a row without values in range."""
    topo = np.asarray(topo)
    nv = (topo.max(axis=1, initial=-1).astype(np.int64) + 1 if topo.size
          else np.zeros(topo.shape[0], np.int64))
    off = np.zeros(topo.shape[0] + 1, dtype=np.int64)
    np.cumsum(nv, out=off[1:])
    return off


def node_owned(topo: np.ndarray) -> np.ndarray:
    """[R] bool: whether no value of row r is held by two nodes (a
    hostname key). Such a row's count at a value is read and committed
    only at the one node holding it, so on the card it stays in the
    scenario's value space, touched only by the block that owns that
    node; every other row is shared and each block keeps a replica."""
    topo = np.asarray(topo)
    owned = np.ones(topo.shape[0], dtype=bool)
    for r in range(topo.shape[0]):
        vals = topo[r][topo[r] >= 0]
        owned[r] = np.unique(vals).size == vals.size
    return owned


def replica_offsets(owned: np.ndarray, off: np.ndarray) -> np.ndarray:
    """[R] int64: the offset of each shared row's value range in a
    block's replica (the shared rows' ranges packed in row order), -1
    for a node-owned row."""
    owned = np.asarray(owned, dtype=bool)
    sizes = np.where(owned, 0, np.diff(np.asarray(off, dtype=np.int64)))
    return np.where(owned, -1, np.cumsum(sizes) - sizes).astype(np.int64)


def _replica_len(rep: torch.Tensor, off: torch.Tensor) -> int:
    """Entries of the replica that `rep` packs (off: the value-space
    offsets of the same rows)."""
    sizes = off[1:] - off[:-1]
    return int((sizes * (rep >= 0)).sum()) if rep.numel() else 0


def _dense_to_value(dense: np.ndarray, off: np.ndarray) -> np.ndarray:
    """[R, V] counts (row r's values at columns 0..) -> ragged value
    space."""
    out = np.zeros(int(off[-1]) + 1, dtype=np.int64)
    dense = np.asarray(dense, dtype=np.int64)
    for r in range(len(off) - 1):
        k = int(off[r + 1] - off[r])
        out[off[r]:off[r] + k] = dense[r, :k]
    return out


def _node_to_value(node_space: np.ndarray, topo: np.ndarray, off: np.ndarray) -> np.ndarray:
    """[R, N] node-space counts (the count at each node's own value, as
    the XLA scan carries them) -> ragged value space."""
    out = np.zeros(int(off[-1]) + 1, dtype=np.int64)
    node_space = np.asarray(node_space, dtype=np.int64)
    topo = np.asarray(topo)
    for r in range(topo.shape[0]):
        has = topo[r] >= 0
        out[off[r] + topo[r, has]] = node_space[r, has]
    return out


def value_to_node(value_space, topo, off) -> np.ndarray:
    """Ragged value space -> [R, N] node space (0 where the key is
    missing): the XLA scan's ScanState layout."""
    vs = np.asarray(value_space, dtype=np.int64)
    topo = np.asarray(topo).astype(np.int64)
    off = np.asarray(off, dtype=np.int64)
    g = vs[off[:-1, None] + np.maximum(topo, 0)]
    return np.where(topo >= 0, g, 0)


def _base_arrays(cluster, batch, dyn, features) -> dict:
    """The base and B2 plan rows from node, class and state arrays with
    the encoder's names (ops/encode.py ClusterStatic / PodBatch /
    DynamicState, or the JAX package's ScanStatic / ScanState)."""
    w = _score_weights(features)
    a = np.asarray
    i64 = np.int64
    base = (a(batch.image_score, dtype=i64) * int(w.image)
            + a(batch.avoid_score, dtype=i64) * int(w.avoid))
    arrays = dict(
        alloc=np.stack([a(cluster.alloc_mcpu, i64), a(cluster.alloc_mem, i64),
                        a(cluster.alloc_eph, i64), a(cluster.alloc_pods, i64)]),
        init=np.stack([a(getattr(dyn, f), i64) for f in STATE_FIELDS]),
        cls_req=np.stack([a(batch.req_mcpu, i64), a(batch.req_mem, i64),
                          a(batch.req_eph, i64), a(batch.nz_mcpu, i64),
                          a(batch.nz_mem, i64), a(batch.has_request, i64)], axis=1),
        feasible=a(batch.static_feasible, dtype=bool),
        cls_tab=np.stack([a(batch.simon_raw, i64), a(batch.nodeaff_raw, i64),
                          a(batch.taint_intol, i64), base]),
    )
    if features.scalars:
        arrays.update(
            scal_alloc=a(cluster.scalar_alloc, i64),
            scal_init=a(dyn.used_scalar, i64),
            scal_req=a(batch.req_scalar, i64),
        )
    if features.gpu:
        arrays.update(
            gpu_node=np.stack([a(cluster.gpu_per_dev, i64), a(cluster.gpu_count, i64),
                               a(cluster.gpu_total, i64)]),
            gpu_init=a(dyn.gpu_used, i64).T,
            gpu_cls=np.stack([a(batch.gpu_mem, i64), a(batch.gpu_cnt, i64)], axis=1),
        )
    if features.ports:
        arrays.update(
            port_init=pack_port_words(a(dyn.ports_used, bool).T),
            port_cls=np.stack([pack_port_words(a(batch.want_ports, bool).T).T,
                               pack_port_words(a(batch.conflict_ports, bool).T).T]),
        )
    if features.storage:
        arrays.update(_storage_arrays(
            vg_cap=a(cluster.vg_cap, i64) * a(cluster.vg_valid, i64),
            vg_used=a(dyn.vg_used, i64),
            ssd_cap=a(cluster.ssd_cap, i64) * a(cluster.ssd_valid, i64),
            ssd_used=a(dyn.ssd_used, bool),
            hdd_cap=a(cluster.hdd_cap, i64) * a(cluster.hdd_valid, i64),
            hdd_used=a(dyn.hdd_used, bool),
            has_storage=a(cluster.has_storage, bool),
            lvm=a(batch.lvm_sizes, i64), ssd=a(batch.ssd_sizes, i64),
            hdd=a(batch.hdd_sizes, i64), wants=a(batch.wants_storage, bool),
        ))
    return arrays


def _storage_arrays(vg_cap, vg_used, ssd_cap, ssd_used, hdd_cap, hdd_used,
                    has_storage, lvm, ssd, hdd, wants) -> dict:
    """Storage plan rows from [N, slot] node arrays (invalid slots with
    capacity 0: a positive volume never fits them, which is the XLA
    scan's valid mask for every volume that counts) and [U, slot]
    class arrays. The kernel walks each media's devices once per pod,
    which needs each class's positive device volumes in ascending order
    (the encoder sorts them so): then every volume lands past the one
    before it."""
    for name, sizes in (("ssd", ssd), ("hdd", hdd)):
        for row in sizes:
            pos = row[row > 0]
            if (np.diff(pos) < 0).any():
                raise ValueError(f"{name} volume sizes of a class are not ascending")
    return dict(
        vg_cap=vg_cap.T, vg_init=vg_used.T,
        ssd_cap=ssd_cap.T, ssd_init=ssd_used.T.astype(np.uint8),
        hdd_cap=hdd_cap.T, hdd_init=hdd_used.T.astype(np.uint8),
        has_storage=has_storage.astype(np.uint8),
        cls_lvm=lvm, cls_ssd=ssd, cls_hdd=hdd, cls_wants=wants.astype(np.uint8),
    )


def _term_arrays(topo, match, c_anti, c_comb, c_panti, c_paff, cls_rows, g_topo,
                 group_of_row, match_all, cls_grows, cls_gid, h_row, h_self, h_skew,
                 h_cand, cls_hrows, s_row, s_host, s_skew, s_q, cls_srows, s_haskeys,
                 init) -> dict:
    """Term plan rows from the term tables' static arrays ([T, U] class
    columns as ops/terms.py builds them) and `init(off, g_off, s_off)`,
    which returns the value-space initial state (t_init [4, VT], g_init,
    gt_init, s_init)."""
    a = np.asarray
    i64 = np.int64
    topo = a(topo, np.int32)
    n = topo.shape[1]
    g_topo = a(g_topo, np.int32)
    s_row = a(s_row, np.int32)
    t_off, g_off, s_off = _ragged(topo), _ragged(g_topo), _ragged(topo[s_row])
    cls_gid = a(cls_gid, np.int32)
    match_all = a(match_all, bool)
    t_init, g_init, gt_init, s_init = init(t_off, g_off, s_off)
    t_owned = node_owned(topo)
    return dict(
        topo=topo, t_off=t_off,
        t_cls=np.stack([a(x, i64).T for x in (match, c_anti, c_comb, c_panti, c_paff)]),
        cls_rows=a(cls_rows, np.int32),
        g_topo=g_topo, g_off=g_off,
        g_match=match_all[a(group_of_row, np.int64)].T.astype(np.uint8),
        cls_grows=a(cls_grows, np.int32), cls_gid=cls_gid,
        g_self=match_all[np.maximum(cls_gid, 0), np.arange(len(cls_gid))].astype(np.uint8),
        h_row=a(h_row, np.int32), h_skew=a(h_skew, i64),
        h_self=a(h_self, bool).astype(np.uint8), h_cand=a(h_cand, bool).astype(np.uint8),
        cls_hrows=a(cls_hrows, np.int32),
        s_row=s_row, s_host=a(s_host, bool).astype(np.uint8), s_skew=a(s_skew, i64),
        s_q=a(s_q, bool).astype(np.uint8), cls_srows=a(cls_srows, np.int32),
        s_haskeys=a(s_haskeys, bool).astype(np.uint8), s_off=s_off,
        # log(sz + 2) of the soft-spread weight, as a host f64 table
        # (pallas_scan.py builds the same one): kernel and plain read it
        log_tab=np.log(np.arange(n + 1, dtype=np.float64) + 2.0),
        t_init=t_init, g_init=g_init, gt_init=gt_init, s_init=s_init,
        t_rep=replica_offsets(t_owned, t_off),
        g_rep=replica_offsets(node_owned(g_topo), g_off),
        s_rep=replica_offsets(t_owned[s_row.astype(np.int64)], s_off),
    )


def _terms_from_tables(t) -> dict:
    """Term plan rows from the encoder's TermTables (value-space init)."""
    from .terms import combined_pref_carry, combined_pref_init

    def init(t_off, g_off, s_off):
        return (
            np.stack([_dense_to_value(x, t_off) for x in (
                t.init_tgt, t.init_own_anti_req, combined_pref_init(t),
                t.init_own_anti_pref_w)]),
            _dense_to_value(t.init_group_counts, g_off),
            np.asarray(t.init_group_counts, np.int64).sum(axis=1),
            _dense_to_value(t.init_soft_counts, s_off),
        )

    return _term_arrays(
        t.topo_val, t.match, t.carry_anti_req, combined_pref_carry(t),
        t.carry_anti_pref_w, t.carry_aff_pref_w, t.cls_rows,
        np.asarray(t.topo_val)[np.asarray(t.group_rows)], t.group_of_row, t.match_all,
        t.cls_group_rows, t.cls_group_id, t.h_row, t.h_self, t.h_max_skew,
        t.h_cand_nodes, t.cls_h_rows, t.s_row, t.s_is_host, t.s_max_skew, t.s_q,
        t.cls_s_rows, t.cls_s_haskeys, init)


def _tensor(v: np.ndarray, device) -> torch.Tensor:
    v = np.ascontiguousarray(v)
    if not v.flags.writeable:  # a view of another framework's buffer
        v = v.copy()
    return torch.from_numpy(v).to(device)


def _make_plan(arrays: dict, n: int, u: int, weights: tuple, has_pins: bool,
               device) -> FusedPlan:
    return FusedPlan(n=n, u=u, weights=weights, has_pins=has_pins,
                     **{k: _tensor(v, device) for k, v in arrays.items()})


def build_plan(cluster, batch, dyn, features, device="cpu") -> FusedPlan:
    """The kernel plan from the numpy ClusterStatic + PodBatch +
    DynamicState (ops/encode.py). Raises NotInKernelError for a batch
    the kernel does not carry (custom score plugins, sample)."""
    check_in_kernel(features)
    arrays = _base_arrays(cluster, batch, dyn, features)
    if features.terms:
        arrays.update(_terms_from_tables(batch.terms))
    return _make_plan(arrays, int(cluster.n), int(np.asarray(batch.req_mcpu).shape[0]),
                      _weights(_score_weights(features)), bool(features.pins), device)


def plan_from_scan_arrays(static, state, features, device="cpu") -> FusedPlan:
    """The port's plan from the JAX package's XLA-scan inputs: its
    ScanStatic and ScanState (any objects with their fields, as numpy
    arrays or array-likes) and its ScanFeatures. The node-space term
    state (count at each node's own value) becomes value space, so the
    port and the XLA scan run on the very same arrays."""
    check_in_kernel(features)
    a = np.asarray
    arrays = _base_arrays(static, static, state, features)
    if features.terms:
        topo = a(static.topo_val)

        def init(t_off, g_off, s_off):
            return (
                np.stack([_node_to_value(getattr(state, f), topo, t_off)
                          for f in TERM_FIELDS]),
                _node_to_value(state.group_counts, a(static.g_topo_val), g_off),
                a(state.group_total, np.int64),
                _node_to_value(state.soft_counts, topo[a(static.s_row)], s_off),
            )

        arrays.update(_term_arrays(
            topo, static.term_match, static.carry_anti_req, static.carry_pref_comb,
            static.carry_anti_pref_w, static.carry_aff_pref_w, static.cls_rows,
            static.g_topo_val, static.group_of_row, static.match_all,
            static.cls_group_rows, static.cls_group_id, static.h_row, static.h_self,
            static.h_max_skew, static.h_cand_nodes, static.cls_h_rows, static.s_row,
            static.s_is_host, static.s_max_skew, static.s_q, static.cls_s_rows,
            static.cls_s_haskeys, init))
    return _make_plan(arrays, int(a(static.alloc_mcpu).shape[0]),
                      int(a(static.req_mcpu).shape[0]), _weights(_score_weights(features)),
                      bool(features.pins), device)


def plan_from_jax_arrays(jplan, device="cpu") -> FusedPlan:
    """The port's plan from the numpy arrays of a JAX package
    PallasPlan (any object with its fields): un-pad the (R, 128) node
    tiles, expand the class-row dedup map, multiply the GCD-scaled
    memory, ephemeral and storage quantities back into true units, and
    unpack the scalar, GPU, port and storage rows. The PallasPlan keeps
    no scale for the scalar kinds and GPU memory, so those rows stay in
    its per-kind GCD units; the fit, device choice and commit are
    linear in them, so placements are unchanged. Its term block is a
    lossy TPU prefolding (bitplanes, double-single logs, deduplicated
    tiles): a plan with terms comes from plan_from_scan_arrays."""
    if getattr(jplan, "terms", None) is not None:
        raise ValueError(
            "a PallasPlan's term block cannot be unfolded; build the plan "
            "from the XLA scan's arrays with plan_from_scan_arrays"
        )
    n, u = int(jplan.n), int(jplan.u)
    i64 = np.int64

    def nodes(tile, scale=1):
        return np.asarray(tile).reshape(-1)[:n].astype(i64) * scale

    def rows(tiles):
        tiles = np.asarray(tiles)
        return tiles.reshape(tiles.shape[0], -1)[:, :n]

    def table(tiles, row_of):
        return rows(tiles)[row_of].astype(i64)

    clsmap = np.asarray(jplan.clsmap).reshape(8, -1)[:, :u]
    cs = np.asarray(jplan.class_scalars).astype(i64)
    cls_req = np.stack([cs[:, 0], cs[:, 1] * jplan.s_mem, cs[:, 2] * jplan.s_eph,
                        cs[:, 3], cs[:, 4] * jplan.s_nzmem, cs[:, 5]], axis=1)
    arrays = dict(
        alloc=np.stack([nodes(jplan.alloc_mcpu), nodes(jplan.alloc_mem_s, jplan.s_mem),
                        nodes(jplan.alloc_eph_s, jplan.s_eph), nodes(jplan.alloc_pods)]),
        init=np.stack([nodes(jplan.init_used_mcpu),
                       nodes(jplan.init_used_mem_s, jplan.s_mem),
                       nodes(jplan.init_used_eph_s, jplan.s_eph),
                       nodes(jplan.init_nz_mcpu),
                       nodes(jplan.init_nz_mem_s, jplan.s_nzmem),
                       nodes(jplan.init_pod_cnt)]),
        cls_req=cls_req.reshape(u, 6),
        feasible=table(jplan.static_feasible, clsmap[0]) != 0,
        cls_tab=np.stack([table(jplan.simon_raw, clsmap[1]),
                          table(jplan.nodeaff_raw, clsmap[3]),
                          table(jplan.taint_intol, clsmap[4]),
                          table(jplan.base_score, clsmap[2])]),
    )
    k = int(getattr(jplan, "s_n", 0))
    if k:
        arrays.update(
            scal_alloc=rows(jplan.alloc_scal)[:k].astype(i64),
            scal_init=rows(jplan.iscal0)[:k].astype(i64),
            scal_req=np.asarray(jplan.req_scal).astype(i64).reshape(u, k),
        )
    g = int(getattr(jplan, "g_n", 0))
    if g:
        arrays.update(
            gpu_node=np.stack([nodes(jplan.gpu_per_dev), nodes(jplan.gpu_cnt_n),
                               nodes(jplan.gpu_tot)]),
            gpu_init=rows(jplan.igpu0)[:g].astype(i64),
            gpu_cls=np.stack([np.asarray(jplan.gpu_mem_u).astype(i64),
                              np.asarray(jplan.gpu_cnt_u).astype(i64)], axis=1),
        )
    pw = int(getattr(jplan, "pw", 0))
    if pw:
        arrays.update(
            port_init=rows(jplan.ports0)[:pw].astype(np.int32),
            port_cls=np.stack([np.asarray(jplan.want_w).reshape(u, pw),
                               np.asarray(jplan.confl_w).reshape(u, pw)]
                              ).astype(np.int32),
        )
    st = getattr(jplan, "store", None)
    if st is not None:
        # caps, init usage and volume sizes are in units of the plan's
        # collective GCD; `storow` only indexes its host score tables,
        # so each node's own capacity tiles are the un-deduplicated rows
        s = int(st.scale)
        cfg = st.cfg

        def slots(tiles, scale=1):
            return rows(tiles).astype(i64) * scale  # [slot, N]

        def sizes(flat, k_slots):
            return np.asarray(flat).astype(i64).reshape(u, k_slots) * s

        arrays.update(_storage_arrays(
            vg_cap=slots(st.vg_cap_s, s).T, vg_used=slots(st.ivg0, s).T,
            ssd_cap=slots(st.ssd_cap_s, s).T, ssd_used=slots(st.issd0).T != 0,
            hdd_cap=slots(st.hdd_cap_s, s).T, hdd_used=slots(st.ihdd0).T != 0,
            has_storage=nodes(st.has_store) != 0,
            lvm=sizes(st.lvm_mi, cfg.lv), ssd=sizes(st.ssd_mi, cfg.sv),
            hdd=sizes(st.hdd_mi, cfg.hv), wants=np.asarray(st.wants_u).reshape(u) != 0,
        ))
    w = tuple(int(x) for x in jplan.w)
    return _make_plan(arrays, n, u, w, bool(jplan.has_pins), device)


def _scenario_inputs(plan: FusedPlan, class_of_pod, scenarios):
    """Per-call inputs as contiguous tensors on the plan's device —
    class_of_pod [P] int32, active [S, P] uint8, valid [S, N] uint8,
    pinned [S, P] int32 — with their ranges checked on the host (the
    kernel indexes with them)."""
    cls = np.asarray(class_of_pod, dtype=np.int64).reshape(-1)
    p = cls.shape[0]
    if not scenarios:
        raise ValueError("no scenarios")
    if p and (cls.min() < 0 or cls.max() >= plan.u):
        raise ValueError(f"class_of_pod outside [0, {plan.u})")
    acts, vals, pins = [], [], []
    for active, valid, pinned in scenarios:
        act = np.asarray(active, dtype=bool).reshape(-1)
        val = np.asarray(valid, dtype=bool).reshape(-1)
        pin = (np.full(p, -1, dtype=np.int64) if pinned is None
               else np.asarray(pinned, dtype=np.int64).reshape(-1))
        if act.shape != (p,) or pin.shape != (p,) or val.shape != (plan.n,):
            raise ValueError(
                f"shape mismatch: class_of_pod {cls.shape}, active {act.shape}, "
                f"pinned {pin.shape}, valid {val.shape} for {plan.n} nodes"
            )
        if p and pin.max() >= plan.n:
            raise ValueError(f"pinned node outside [0, {plan.n})")
        pin = np.where(pin >= 0, pin, -1)
        if (pin >= 0).any() and not plan.has_pins:
            raise ValueError("pinned pods but the plan was built without pins")
        acts.append(act)
        vals.append(val)
        pins.append(pin)
    dev = plan.device
    host = (cls.astype(np.int32), np.stack(acts).astype(np.uint8),
            np.stack(vals).astype(np.uint8), np.stack(pins).astype(np.int32))
    if dev.type == "cuda":
        profile.record_h2d(sum(a.nbytes for a in host))
    return tuple(torch.from_numpy(a).to(dev) for a in host)


def _final(s: int, state, blocks: dict) -> dict:
    """Scenario s's final state: the six base rows, plus `used_scalar`
    [K, N], `gpu_used` [G, N], `ports_used` [W, N] (words), the storage
    rows `vg_used` [V, N], `ssd_used` / `hdd_used` [D, N] (uint8) and
    the value-space term rows (TERM_ROWS) for the blocks the plan has.
    `blocks` maps each such row name to its [S, ...] tensor."""
    out = {name: state[s, k] for k, name in enumerate(STATE_FIELDS)}
    out.update({name: rows[s] for name, rows in blocks.items()})
    return out


def _state_blocks(plan: FusedPlan, scal, gpu, ports, store, terms) -> dict:
    """The [S, ...] tensors of each final row past the base six."""
    blocks = {}
    if plan.has_scal:
        blocks["used_scalar"] = scal
    if plan.has_gpu:
        blocks["gpu_used"] = gpu
    if plan.has_ports:
        blocks["ports_used"] = ports
    if plan.has_store:
        blocks.update(zip(STORE_ROWS, store))
    if plan.has_terms:
        t_state, g_state, gt_state, s_state = terms
        blocks.update({f: t_state[:, k] for k, f in enumerate(TERM_FIELDS)})
        blocks.update(group_counts=g_state, group_total=gt_state, soft_counts=s_state)
    return blocks


def _class_slots(table: torch.Tensor) -> list:
    """Per class, the non-negative entries of a [U, slots] -1-padded
    table, in slot order."""
    return [[int(x) for x in row if x >= 0] for row in table.cpu().tolist()]


class _PlainStore:
    """The storage block of the plain version: XLA scan semantics
    (_local_storage_eval) vectorised over [scenario, node]."""

    def __init__(self, plan: FusedPlan, s_n: int):
        self.vg_cap = plan.vg_cap
        self.ssd_cap, self.hdd_cap = plan.ssd_cap, plan.hdd_cap
        self.vg = plan.vg_init.unsqueeze(0).repeat(s_n, 1, 1)
        self.ssd = plan.ssd_init.bool().unsqueeze(0).repeat(s_n, 1, 1)
        self.hdd = plan.hdd_init.bool().unsqueeze(0).repeat(s_n, 1, 1)
        self.has = plan.has_storage.bool()[None, :]
        self.lvm = plan.cls_lvm.cpu().tolist()
        self.ssd_sizes = plan.cls_ssd.cpu().tolist()
        self.hdd_sizes = plan.cls_hdd.cpu().tolist()
        self.wants = plan.cls_wants.cpu().tolist()

    @staticmethod
    def _fit_devices(cap, used, sizes):
        """First fit of the volumes onto free devices in device order:
        (ok, take [S, D, N] bool, frac f64, count)."""
        take = torch.zeros_like(used)
        s_n, _, n = used.shape
        ok = torch.ones((s_n, n), dtype=torch.bool, device=used.device)
        frac = torch.zeros((s_n, n), dtype=torch.float64, device=used.device)
        cnt = torch.zeros((s_n, n), dtype=torch.int64, device=used.device)
        for size in sizes:
            if size <= 0:
                continue
            elig = ~used & ~take & (cap[None] >= size)
            first = elig & (elig.long().cumsum(dim=1) == 1)
            ok_i = elig.any(dim=1)
            take |= first
            chosen_cap = (first.long() * cap[None]).sum(dim=1)
            frac = frac + torch.where(
                ok_i, float(size) / chosen_cap.clamp(min=1).double(), 0.0)
            cnt += ok_i.long()
            ok &= ok_i
        return ok, take, frac, cnt

    def eval(self, u: int):
        """(ok, raw, vg_take, ssd_take, hdd_take) of class u at every
        node, or None when the class asks for no storage."""
        if not self.wants[u]:
            return None
        big = torch.iinfo(torch.int64).max
        cap = self.vg_cap[None]
        take = torch.zeros_like(self.vg)
        lvm_ok = torch.ones_like(self.has.expand(self.vg.shape[0], -1))
        for size in self.lvm[u]:
            if size <= 0:
                continue
            free = cap - self.vg - take
            elig = free >= size
            key = torch.where(elig, free, big)
            best = elig & (key == key.amin(dim=1, keepdim=True))
            best &= best.long().cumsum(dim=1) == 1  # lowest VG index on ties
            take += best.long() * size
            lvm_ok &= elig.any(dim=1)
        s_ok, s_take, s_frac, s_cnt = self._fit_devices(
            self.ssd_cap, self.ssd, self.ssd_sizes[u])
        h_ok, h_take, h_frac, h_cnt = self._fit_devices(
            self.hdd_cap, self.hdd, self.hdd_sizes[u])
        touched = take > 0
        lvm_frac = torch.zeros(lvm_ok.shape, dtype=torch.float64, device=take.device)
        for v in range(take.shape[1]):  # slot order, as the kernel adds
            lvm_frac = lvm_frac + torch.where(
                touched[:, v],
                take[:, v].double() / self.vg_cap[v].clamp(min=1).double(), 0.0)
        lvm_cnt = touched.sum(dim=1)
        lvm_score = torch.where(
            lvm_cnt > 0, (lvm_frac / lvm_cnt.clamp(min=1).double() * 10).long(), 0)
        dev_cnt = s_cnt + h_cnt
        dev_score = torch.where(
            dev_cnt > 0, ((s_frac + h_frac) / dev_cnt.clamp(min=1).double() * 10).long(), 0)
        ok = self.has & lvm_ok & s_ok & h_ok
        raw = torch.where(self.has, lvm_score + dev_score, 0)
        return ok, raw, take, s_take, h_take

    def commit(self, sel, ev) -> None:
        if ev is None:
            return
        _ok, _raw, take, s_take, h_take = ev
        self.vg += sel[:, None, :] * take
        self.ssd |= sel.bool()[:, None, :] & s_take
        self.hdd |= sel.bool()[:, None, :] & h_take

    def final(self):
        return self.vg, self.ssd.to(torch.uint8), self.hdd.to(torch.uint8)


class _PlainTerms:
    """The inter-pod affinity and topology-spread block of the plain
    version: XLA scan semantics (_terms_eval, _terms_commit, the IPA
    normalisation) vectorised over [scenario, node], with the counts in
    value space."""

    def __init__(self, plan: FusedPlan, s_n: int):
        self.p = plan
        self.topo = plan.topo.long()
        self.g_topo = plan.g_topo.long()
        self.s_topo = self.topo[plan.s_row.long()]
        self.t_off = plan.t_off
        self.g_off = plan.g_off
        self.s_off = plan.s_off
        self.ts = plan.t_init.unsqueeze(0).repeat(s_n, 1, 1)  # [S, 4, VT]
        self.gs = plan.g_init.unsqueeze(0).repeat(s_n, 1)
        self.gt = plan.gt_init.unsqueeze(0).repeat(s_n, 1)
        self.ss = plan.s_init.unsqueeze(0).repeat(s_n, 1)
        self.t_cls = plan.t_cls  # [5, U, T]
        self.rows = _class_slots(plan.cls_rows)
        self.grows = _class_slots(plan.cls_grows)
        self.hrows = _class_slots(plan.cls_hrows)
        self.srows = _class_slots(plan.cls_srows)
        self.gid = plan.cls_gid.cpu().tolist()
        self.g_self = plan.g_self.cpu().tolist()
        self.tab = plan.t_cls.cpu().tolist()  # [5][U][T]
        self.t_off_h = plan.t_off.cpu().tolist()
        self.g_off_h = plan.g_off.cpu().tolist()
        self.s_off_h = plan.s_off.cpu().tolist()
        self.h_row = plan.h_row.cpu().tolist()
        self.h_skew = plan.h_skew.cpu().tolist()
        self.h_self = plan.h_self.cpu().tolist()
        self.s_row = plan.s_row.cpu().tolist()
        self.s_host = plan.s_host.cpu().tolist()
        self.s_skew = plan.s_skew.cpu().tolist()

    def _at(self, state, off: int, vals):
        """state[:, off + vals] with 0 where vals < 0 — [S, N]."""
        got = state[:, off + vals.clamp(min=0)]
        return torch.where(vals[None, :] >= 0, got, 0)

    def filter(self, u: int, valid_b):
        """(ok [S, N], ipa raw [S, N]) of class u: the InterPodAffinity
        filter and raw score and the hard-spread filter."""
        p = self.p
        s_n, n = valid_b.shape
        dev = valid_b.device
        ok = torch.ones((s_n, n), dtype=torch.bool, device=dev)
        raw = torch.zeros((s_n, n), dtype=torch.int64, device=dev)
        m_u, anti_u, _comb, panti_u, paff_u = (self.tab[k][u] for k in range(5))
        for r in self.rows[u]:
            vals = self.topo[r]
            off = self.t_off_h[r]
            tgt = self._at(self.ts[:, 0], off, vals)
            own_anti = self._at(self.ts[:, 1], off, vals)
            own_paff = self._at(self.ts[:, 2], off, vals)
            own_panti = self._at(self.ts[:, 3], off, vals)
            if m_u[r]:
                ok &= ~(own_anti > 0)  # satisfyExistingPodsAntiAffinity
            if anti_u[r] > 0:
                ok &= ~(tgt > 0)  # satisfyPodAntiAffinity
            raw += (paff_u[r] - panti_u[r]) * tgt + m_u[r] * (own_paff - own_panti)
        if self.gid[u] >= 0:  # satisfyPodAffinity
            keys_ok = torch.ones_like(ok)
            exist = torch.ones_like(ok)
            total = torch.zeros(s_n, dtype=torch.int64, device=dev)
            for a in self.grows[u]:
                vals = self.g_topo[a]
                gc = self._at(self.gs, self.g_off_h[a], vals)
                keys_ok &= (vals >= 0)[None, :]
                exist &= gc > 0
                total += self.gt[:, a]
            boot = (total == 0) & bool(self.g_self[u])
            ok &= keys_ok & (exist | boot[:, None])
        big = torch.iinfo(torch.int64).max
        for h in self.hrows[u]:  # hard topology spread
            r = self.h_row[h]
            vals = self.topo[r]
            cnt = self._at(self.ts[:, 0], self.t_off_h[r], vals)
            cand = p.h_cand[h].bool()[None, :] & valid_b
            minc = torch.where(cand, cnt, big).amin(dim=1)
            minc = torch.where(cand.any(dim=1), minc, 0)
            cnt_eff = torch.where(cand & (vals >= 0)[None, :], cnt, 0)
            skew = cnt_eff + self.h_self[h][u] - minc[:, None]
            ok &= (skew <= self.h_skew[h]) & (vals >= 0)[None, :]
        return ok, raw

    def soft(self, u: int, feas):
        """The normalised soft-spread score [S, N] of class u over the
        final feasible set, or None when the class has no soft
        constraint (every node then scores MAX_SCORE: a constant)."""
        if not self.srows[u]:
            return None
        p = self.p
        eligible = feas & p.s_haskeys[u].bool()[None, :]
        acc = torch.zeros(eligible.shape, dtype=torch.float64, device=feas.device)
        for c in self.srows[u]:  # slot order, as the kernel adds
            vals = self.s_topo[c]
            if self.s_host[c]:
                sz = eligible.sum(dim=1)
                cnt = self._at(self.ts[:, 0], self.t_off_h[self.s_row[c]], vals)
            else:
                nv = self.s_off_h[c + 1] - self.s_off_h[c]
                idx = torch.where(eligible & (vals >= 0)[None, :], vals[None, :], nv)
                present = torch.zeros((feas.shape[0], nv + 1), dtype=torch.int64,
                                      device=feas.device)
                present.scatter_(1, idx, 1)
                sz = present[:, :nv].sum(dim=1)
                cnt = self._at(self.ss, self.s_off_h[c], vals)
            weight = p.log_tab[sz]
            acc = acc + (cnt.double() * weight[:, None] + float(self.s_skew[c] - 1))
        raw = acc.long()
        big = torch.iinfo(torch.int64).max
        mx = torch.where(eligible, raw, -big).amax(dim=1, keepdim=True)
        mn = torch.where(eligible, raw, big).amin(dim=1, keepdim=True)
        norm = torch.where(mx == 0, MAX_SCORE,
                           MAX_SCORE * (mx + mn - raw) // mx.clamp(min=1))
        out = torch.where(eligible, norm, 0)
        return torch.where(eligible.any(dim=1, keepdim=True), out, 0)

    def commit(self, u: int, place) -> None:
        """AddPod of class u at each scenario's placement [S] (ignored
        where negative): one add per term, group and soft row."""
        ok = place >= 0
        at = place.clamp(min=0)
        t_n = self.topo.shape[0]
        vals = self.topo[:, at].T  # [S, T]
        okv = ((vals >= 0) & ok[:, None]).long()
        idx = self.t_off[:t_n][None, :] + vals.clamp(min=0)
        for k in range(4):
            self.ts[:, k].scatter_add_(1, idx, self.t_cls[k, u][None, :] * okv)
        a_n = self.g_topo.shape[0]
        gv = self.g_topo[:, at].T  # [S, A]
        okg = ((gv >= 0) & ok[:, None] & self.p.g_match[u].bool()[None, :]).long()
        self.gs.scatter_add_(1, self.g_off[:a_n][None, :] + gv.clamp(min=0), okg)
        self.gt += okg
        c_n = self.s_topo.shape[0]
        sv = self.s_topo[:, at].T  # [S, Cs]
        s_match = self.t_cls[0, u][self.p.s_row.long()] != 0
        oks = ((sv >= 0) & self.p.s_q[:, at].T.bool() & ok[:, None]
               & s_match[None, :]).long()
        self.ss.scatter_add_(1, self.s_off[:c_n][None, :] + sv.clamp(min=0), oks)

    def final(self):
        return self.ts, self.gs, self.gt, self.ss


def fused_scan_batch_reference(plan: FusedPlan, class_of_pod, scenarios,
                               pins_first: bool = False):
    """The plain PyTorch version of the batch: an eager loop over the
    pods, one step vectorised over the [scenario, node] axes each.
    `scenarios` is a list of (active[P], valid[N], pinned[P] or None).
    With `pins_first` the loop runs twice: the pinned pods' commits,
    then the free pods' steps (the kernel's pins-first mode). Returns
    [(placements[P] int32, final state dict), ...]. It repeats the
    kernel's arithmetic and is no yardstick of speed."""
    cls_t, act_t, val_t, pin_t = _scenario_inputs(plan, class_of_pod, scenarios)
    dev = plan.device
    n, p = plan.n, cls_t.shape[0]
    s_n = act_t.shape[0]
    # host copies of the per-pod decisions, so the loop never syncs
    cls = cls_t.cpu().tolist()
    act = act_t.cpu().numpy().astype(bool)
    pin = pin_t.cpu().numpy().astype(np.int64)
    valid_host = val_t.cpu().numpy().astype(bool)
    pinned_ok = np.take_along_axis(valid_host, np.maximum(pin, 0), axis=1)
    host_place = np.where(pin >= 0, np.where(pinned_ok, pin, INACTIVE), -1)
    host_place = np.where(act, host_place, INACTIVE)
    scanned = act & (pin < 0)  # [S, P]: pods that run filter and score
    # each pass: the pods that run filter and score, and what the others
    # commit (a node, or -1 / INACTIVE for nothing)
    if pins_first:
        passes = [(np.zeros_like(scanned), np.where(pin >= 0, host_place, -1)),
                  (scanned, np.where(pin >= 0, -1, host_place))]
    else:
        passes = [(scanned, host_place)]
    reqs = plan.cls_req.cpu().tolist()
    w_least, w_bal, w_simon, w_na, w_tt, w_spread, w_ipa, w_local = plan.weights
    big = torch.iinfo(torch.int64).max
    valid_b = val_t.bool()
    alloc_c, alloc_m, alloc_e, alloc_p = plan.alloc.unbind(0)
    alloc_c1 = alloc_c.clamp(min=1)
    alloc_m1 = alloc_m.clamp(min=1)
    alloc_cf = alloc_c1.double()
    alloc_mf = alloc_m1.double()
    state = plan.init.unsqueeze(0).repeat(s_n, 1, 1)  # [S, 6, N]
    used_c, used_m, used_e, nz_c, nz_m, pods = state.unbind(1)
    scal = plan.scal_init.unsqueeze(0).repeat(s_n, 1, 1) if plan.has_scal else None
    gpu = plan.gpu_init.unsqueeze(0).repeat(s_n, 1, 1) if plan.has_gpu else None
    ports = plan.port_init.unsqueeze(0).repeat(s_n, 1, 1) if plan.has_ports else None
    store = _PlainStore(plan, s_n) if plan.has_store else None
    terms = _PlainTerms(plan, s_n) if plan.has_terms else None
    if plan.has_scal:
        scal_req = plan.scal_req
    if plan.has_gpu:
        per_dev, dev_cnt, gpu_tot = plan.gpu_node.unbind(0)
        dvalid = (torch.arange(gpu.shape[1], device=dev)[:, None] < dev_cnt[None, :])
        gpu_cls = plan.gpu_cls.cpu().tolist()
    if plan.has_ports:
        want_w, confl_w = plan.port_cls.unbind(0)
    node_idx = torch.arange(n, device=dev)
    out = torch.from_numpy(host_place.astype(np.int32)).to(dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def minmax_norm(raw, feas):
        """Simon / Open-Local NormalizeScore over the feasible set."""
        hi = torch.where(feas, raw, -big).amax(dim=1, keepdim=True)
        lo = torch.where(feas, raw, big).amin(dim=1, keepdim=True)
        rng = hi - lo
        return torch.where(rng > 0, (raw - lo) * MAX_SCORE // rng.clamp(min=1), zero)

    for scan_np, fixed_np in passes:
        scan_rows = torch.from_numpy(scan_np).to(dev)
        fixed_t = torch.from_numpy(fixed_np).to(dev)
        scan_any = scan_np.any(axis=0)
        for i in range(p):
            u = cls[i]
            rc, rm, re, nzc, nzm, has_req = reqs[u]
            if not (fixed_np[:, i] >= 0).any() and not scan_any[i]:
                continue  # nothing to run or commit in this pass
            gm, gc = gpu_cls[u] if plan.has_gpu else (0, 0)
            if gm > 0:
                # open-gpu-share device choice at every node (scan.py
                # _gpu_allocate), from the state before this pod's commit
                avail = per_dev[None, None, :] - gpu  # [S, G, N]
                if gc == 1:
                    fits = dvalid[None] & (avail >= gm)
                    found = fits.any(dim=1)
                    best = torch.where(fits, avail, big).argmin(dim=1)  # first on ties
                    take = (torch.arange(gpu.shape[1], device=dev)[None, :, None]
                            == best[:, None, :]).long() * found[:, None, :].long()
                else:
                    cap = torch.where(dvalid[None], avail // max(gm, 1), zero).clamp(min=0)
                    prefix = cap.cumsum(dim=1) - cap
                    take = torch.minimum((gc - prefix).clamp(min=0), cap)
                    found = cap.sum(dim=1) >= gc
                gpu_ok = (gpu_tot[None, :] >= gm) & found
            # storage takes at every node, from the state before the commit
            st = store.eval(u) if store is not None else None
            if scan_any[i]:
                feas = plan.feasible[u][None, :] & valid_b & (pods + 1 <= alloc_p)
                if has_req:
                    feas &= (alloc_c >= used_c + rc) & (alloc_m >= used_m + rm) & (
                        alloc_e >= used_e + re)
                    if plan.has_scal:
                        feas &= (plan.scal_alloc[None] >= scal + scal_req[u][None, :, None]
                                 ).all(dim=1)
                if plan.has_ports:
                    feas &= ((ports & confl_w[u][None, :, None]) == 0).all(dim=1)
                if gm > 0:
                    feas &= gpu_ok
                if st is not None:
                    feas &= st[0]
                if terms is not None:
                    term_ok, ipa_raw = terms.filter(u, valid_b)
                    feas &= term_ok
                total = plan.cls_tab[3, u].unsqueeze(0).repeat(s_n, 1)
                totc = nz_c + nzc
                totm = nz_m + nzm
                if w_least:
                    lc = torch.where((alloc_c > 0) & (totc <= alloc_c),
                                     (alloc_c - totc) * MAX_SCORE // alloc_c1, zero)
                    lm = torch.where((alloc_m > 0) & (totm <= alloc_m),
                                     (alloc_m - totm) * MAX_SCORE // alloc_m1, zero)
                    total += (lc + lm) // 2 * w_least
                if w_bal:
                    cf = torch.where(alloc_c > 0, totc.double() / alloc_cf, 1.0)
                    mf = torch.where(alloc_m > 0, totm.double() / alloc_mf, 1.0)
                    bal = torch.where((cf >= 1) | (mf >= 1), zero,
                                      ((1 - (cf - mf).abs()) * MAX_SCORE).long())
                    total += bal * w_bal
                if w_simon:
                    total += minmax_norm(plan.cls_tab[0, u][None, :], feas) * w_simon
                if w_na:
                    raw = plan.cls_tab[1, u][None, :]
                    mx = torch.where(feas, raw, zero).amax(dim=1, keepdim=True)
                    total += torch.where(
                        mx > 0, MAX_SCORE * raw // mx.clamp(min=1), zero) * w_na
                if w_tt:
                    raw = plan.cls_tab[2, u][None, :]
                    mx = torch.where(feas, raw, zero).amax(dim=1, keepdim=True)
                    total += torch.where(
                        mx > 0, MAX_SCORE - MAX_SCORE * raw // mx.clamp(min=1),
                        MAX_SCORE) * w_tt
                if st is not None and w_local:
                    # a class without volumes scores 0 everywhere
                    total += minmax_norm(st[1], feas) * w_local
                if terms is not None:
                    if w_ipa:
                        # InterPodAffinity NormalizeScore: bounds include 0,
                        # f64 divide, int64 truncation
                        masked = torch.where(feas, ipa_raw, zero)
                        mx = masked.amax(dim=1, keepdim=True).clamp(min=0)
                        mn = masked.amin(dim=1, keepdim=True).clamp(max=0)
                        diff = (mx - mn).double()
                        total += torch.where(
                            diff > 0,
                            ((MAX_SCORE * (ipa_raw - mn)).double() / diff.clamp(min=1.0)).long(),
                            zero) * w_ipa
                    soft = terms.soft(u, feas) if w_spread else None
                    if soft is not None:
                        total += soft * w_spread
                masked = torch.where(feas, total, torch.iinfo(torch.int64).min)
                chosen = torch.where(feas.any(dim=1), masked.argmax(dim=1), -1)
                place = torch.where(scan_rows[:, i], chosen, fixed_t[:, i].long())
                out[:, i] = torch.where(scan_rows[:, i], chosen.int(), out[:, i])
            else:
                place = fixed_t[:, i].long()
            sel = (node_idx[None, :] == place[:, None]).long()  # [S, N]
            used_c += sel * rc
            used_m += sel * rm
            used_e += sel * re
            nz_c += sel * nzc
            nz_m += sel * nzm
            pods += sel
            if plan.has_scal:
                scal += sel[:, None, :] * scal_req[u][None, :, None]
            if plan.has_ports:
                ports |= sel[:, None, :].int() * want_w[u][None, :, None]
            if gm > 0:
                gpu += sel[:, None, :] * take * gm
            if store is not None:
                store.commit(sel, st)
            if terms is not None:
                terms.commit(u, place)
    blocks = _state_blocks(plan, scal, gpu, ports,
                           store.final() if store is not None else None,
                           terms.final() if terms is not None else None)
    return [(out[s], _final(s, state, blocks)) for s in range(s_n)]


def fused_scan_reference(plan: FusedPlan, class_of_pod, active, valid, pinned=None):
    """The plain PyTorch version of one scan: the batch reference with
    one scenario. Returns (placements[P] int32, final state dict)."""
    return fused_scan_batch_reference(plan, class_of_pod, [(active, valid, pinned)])[0]


# length of the int64 argument vector of fused_scan_launch (the
# kArg* enum of csrc/fused_scan.cu); checked against the library
_N_ARGS = 108


def _library():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        # compiled for sm_90a into build/torch_kernels/ at first use
        lib = ctypes.CDLL(str(nvcc.build_library(SOURCE)))
        lib.fused_scan_arg_count.argtypes = []
        lib.fused_scan_arg_count.restype = ctypes.c_int64
        if lib.fused_scan_arg_count() != _N_ARGS:
            raise RuntimeError(
                f"fused_scan library takes {lib.fused_scan_arg_count()} "
                f"arguments, the wrapper passes {_N_ARGS}"
            )
        lib.fused_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.fused_scan_launch.restype = ctypes.c_int
        lib.fused_scan_max_clusters.argtypes = [ctypes.c_int64] * 10 + [ctypes.c_void_p]
        lib.fused_scan_max_clusters.restype = ctypes.c_int
        lib.fused_scan_static_smem.argtypes = [ctypes.c_int64, ctypes.c_void_p]
        lib.fused_scan_static_smem.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def block_dims(plan: FusedPlan) -> dict:
    """The block sizes the kernel takes (0 for a block that is off)."""
    d = dict(k=0, g=0, w=0, v=0, ds=0, dh=0, lv=0, sv=0, hv=0, t=0, r=0, a=0,
             gm=0, ch=0, hm=0, cs=0, sm=0, vt=0, va=0, vs=0, vr=0, vgr=0, vsr=0)
    if plan.has_scal:
        d["k"] = plan.scal_alloc.shape[0]
    if plan.has_gpu:
        d["g"] = plan.gpu_init.shape[0]
    if plan.has_ports:
        d["w"] = plan.port_init.shape[0]
    if plan.has_store:
        d.update(v=plan.vg_cap.shape[0], ds=plan.ssd_cap.shape[0],
                 dh=plan.hdd_cap.shape[0], lv=plan.cls_lvm.shape[1],
                 sv=plan.cls_ssd.shape[1], hv=plan.cls_hdd.shape[1])
    if plan.has_terms:
        d.update(t=plan.topo.shape[0], r=plan.cls_rows.shape[1], a=plan.g_topo.shape[0],
                 gm=plan.cls_grows.shape[1], ch=plan.h_row.shape[0],
                 hm=plan.cls_hrows.shape[1], cs=plan.s_row.shape[0],
                 sm=plan.cls_srows.shape[1], vt=plan.t_init.shape[1],
                 va=plan.g_init.shape[0], vs=plan.s_init.shape[0],
                 vr=_replica_len(plan.t_rep, plan.t_off),
                 vgr=_replica_len(plan.g_rep, plan.g_off),
                 vsr=_replica_len(plan.s_rep, plan.s_off))
    return d


def replica_len(plan: FusedPlan) -> int:
    """int64 entries of one block's replica: the shared term rows' four
    fields [4, VR], the shared group rows [VGR], the group totals [A] and
    the shared soft rows [VSR] (0 without terms)."""
    d = block_dims(plan)
    return 4 * d["vr"] + d["vgr"] + d["a"] + d["vsr"]


def _plan_checks(plan: FusedPlan, d: dict) -> list:
    n, u = plan.n, plan.u
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    checks = [
        ("alloc", torch.int64, (4, n)), ("init", i64, (6, n)), ("cls_req", i64, (u, 6)),
        ("feasible", torch.bool, (u, n)), ("cls_tab", i64, (4, u, n)),
    ]
    if plan.has_scal:
        checks += [("scal_alloc", i64, (d["k"], n)), ("scal_init", i64, (d["k"], n)),
                   ("scal_req", i64, (u, d["k"]))]
    if plan.has_gpu:
        checks += [("gpu_node", i64, (3, n)), ("gpu_init", i64, (d["g"], n)),
                   ("gpu_cls", i64, (u, 2))]
    if plan.has_ports:
        checks += [("port_init", i32, (d["w"], n)), ("port_cls", i32, (2, u, d["w"]))]
    if plan.has_store:
        checks += [("vg_cap", i64, (d["v"], n)), ("vg_init", i64, (d["v"], n)),
                   ("ssd_cap", i64, (d["ds"], n)), ("ssd_init", u8, (d["ds"], n)),
                   ("hdd_cap", i64, (d["dh"], n)), ("hdd_init", u8, (d["dh"], n)),
                   ("has_storage", u8, (n,)), ("cls_lvm", i64, (u, d["lv"])),
                   ("cls_ssd", i64, (u, d["sv"])), ("cls_hdd", i64, (u, d["hv"])),
                   ("cls_wants", u8, (u,))]
    if plan.has_terms:
        t, a, ch, cs = d["t"], d["a"], d["ch"], d["cs"]
        checks += [
            ("topo", i32, (t, n)), ("t_off", i64, (t + 1,)), ("t_cls", i64, (5, u, t)),
            ("cls_rows", i32, (u, d["r"])), ("g_topo", i32, (a, n)),
            ("g_off", i64, (a + 1,)), ("g_match", u8, (u, a)),
            ("cls_grows", i32, (u, d["gm"])), ("cls_gid", i32, (u,)), ("g_self", u8, (u,)),
            ("h_row", i32, (ch,)), ("h_skew", i64, (ch,)), ("h_self", u8, (ch, u)),
            ("h_cand", u8, (ch, n)), ("cls_hrows", i32, (u, d["hm"])),
            ("s_row", i32, (cs,)), ("s_host", u8, (cs,)), ("s_skew", i64, (cs,)),
            ("s_q", u8, (cs, n)), ("cls_srows", i32, (u, d["sm"])),
            ("s_haskeys", u8, (u, n)), ("s_off", i64, (cs + 1,)),
            ("log_tab", torch.float64, (n + 1,)), ("t_init", i64, (4, d["vt"])),
            ("g_init", i64, (d["va"],)), ("gt_init", i64, (a,)), ("s_init", i64, (d["vs"],)),
            ("t_rep", i64, (t,)), ("g_rep", i64, (a,)), ("s_rep", i64, (cs,)),
        ]
        # the kernel indexes value space with these: check them here
        for name, off, total in (("t_off", plan.t_off, d["vt"]), ("g_off", plan.g_off, d["va"]),
                                 ("s_off", plan.s_off, d["vs"])):
            if int(off[-1]) >= total:
                raise ValueError(f"{name} runs past its {total}-entry value space")
        for name, tab, hi in (("cls_rows", plan.cls_rows, t), ("cls_grows", plan.cls_grows, a),
                              ("cls_hrows", plan.cls_hrows, ch), ("cls_srows", plan.cls_srows, cs),
                              ("h_row", plan.h_row, t), ("s_row", plan.s_row, t)):
            if tab.numel() and int(tab.max()) >= hi:
                raise ValueError(f"{name} names a row outside [0, {hi})")
        for name, tab, off, total in (("t_rep", plan.t_rep, plan.t_off, d["vr"]),
                                      ("g_rep", plan.g_rep, plan.g_off, d["vgr"]),
                                      ("s_rep", plan.s_rep, plan.s_off, d["vsr"])):
            ends = torch.where(tab >= 0, tab + off[1:] - off[:-1], 0)
            if tab.numel() and int(ends.max()) > total:
                raise ValueError(f"{name} runs past its {total}-entry replica")
    return [(getattr(plan, name), name, dtype, shape) for name, dtype, shape in checks]


def kernel_name(plan: FusedPlan, batch: bool = False) -> str:
    """The launch counter (and instantiation) a scan of this plan
    runs under."""
    if batch:
        return BATCH_KERNEL_NAME
    if plan.has_store and plan.has_terms:
        return STORE_TERMS_KERNEL_NAME
    if plan.has_store:
        return STORE_KERNEL_NAME
    if plan.has_terms:
        return TERMS_KERNEL_NAME
    return EXT_KERNEL_NAME if plan.ext else KERNEL_NAME


def scratch_bytes(plan: FusedPlan, scenarios: int = 1, cluster: int = 1) -> int:
    """Bytes one launch allocates per call for its state and scratch
    (the state copies of the new blocks, the per-node scratch rows, the
    soft-spread stamps of each block and the blocks' replicas of the
    shared term counts in global memory), for `scenarios` scenarios on
    clusters of `cluster` blocks."""
    d = block_dims(plan)
    n = plan.n
    per = n * 8 * (6 + 1 + d["k"] + d["g"]) + n * 4 * d["w"]
    if plan.has_store:
        per += n * (8 * 2 * d["v"] + d["ds"] + d["dh"])
    if plan.has_store or plan.has_terms:
        per += n * 8 * 3
    if plan.has_terms:
        per += 8 * (4 * d["vt"] + d["va"] + d["a"] + d["vs"])
        per += 8 * cluster * d["vs"]
        if not launch_shape(plan, cluster).replica:
            per += 8 * cluster * max(replica_len(plan), 1)
    return per * scenarios


# ---- launch shape: one cluster of C blocks a scenario ---------------------

# cluster sizes the kernel takes (16 is Hopper's non-portable maximum)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# shared memory one block may use on an H100 (227 KB)
SMEM_PER_BLOCK = 232_448
# the static shared arrays of the base and B2 instantiations, in int64:
# the pass-1 and pass-2 block exchanges [5][32] and [2][32], the cluster
# exchanges [16][5] and [16][2], and the one-entry stubs of the term
# block's three exchanges (csrc/fused_scan.cu; the library's
# fused_scan_static_smem, the compiler's own figure, is held to at most
# static_smem on the card)
STATIC_SMEM = 8 * (5 * 32 + 2 * 32 + 16 * 5 + 16 * 2 + 3)
# the storage and term instantiations': ten pass-1 values, [10][32] and
# [16][10]; with terms the exchanges of a round of hard-spread (min, any)
# pairs [2][16][4][2], of soft-spread domain counts [2][16][4] and of the
# soft min-max [16][2], else their stubs
KROUND = 4  # the kernel's kRound: slots a hard- or soft-spread exchange folds
STATIC_SMEM_STORE = 8 * (10 * 32 + 2 * 32 + 16 * 10 + 16 * 2 + 3)
STATIC_SMEM_TERMS = 8 * (10 * 32 + 2 * 32 + 16 * 10 + 16 * 2 + 2 * 16 * KROUND * 2
                         + 2 * 16 * KROUND + 16 * 2)
# the rule's slice: the smallest cluster whose slices hold at most this
# many nodes, about two a thread of a block
SLICE_NODES = 640


def static_smem(plan: FusedPlan) -> int:
    """The static shared memory of the instantiation this plan runs."""
    if plan.has_terms:
        return STATIC_SMEM_TERMS
    return STATIC_SMEM_STORE if plan.has_store else STATIC_SMEM


@dataclass(frozen=True)
class LaunchShape:
    """How one launch runs each scenario: on a cluster of `cluster`
    blocks, each block's node slice in `smem` bytes of dynamic shared
    memory when `resident`, else in global memory; `cached`, with the
    per-(class, node) caches of the passes there too (the base and B2
    instantiations); `replica`, with the block's replica of the shared
    term counts there too (a term plan, whose dynamic shared memory
    always holds the step's hard-spread minima). The kernel library sets
    the threads a block: 384 for a resident slice, 512 for one in global
    memory."""

    cluster: int
    resident: bool
    smem: int
    cached: bool = False
    replica: bool = False

    @property
    def layout(self) -> int:
        """The kernel's `resident` argument: bit 0 resident, bit 1
        cached, bit 2 replica."""
        return int(self.resident) | (2 if self.cached else 0) | (4 if self.replica else 0)


def slices(n: int, cluster: int) -> list:
    """The node slices [lo, hi) of a cluster's blocks, in rank order:
    block r owns [r*m, min((r+1)*m, n)) with m = ceil(n / cluster); the
    last blocks may own none."""
    m = -(-n // cluster)
    return [(min(r * m, n), min((r + 1) * m, n)) for r in range(cluster)]


def slice_bytes(plan: FusedPlan, m: int) -> int:
    """Shared memory of a resident slice of m nodes: the 8-byte rows
    (four allocatable, six state, partial, each scalar kind's
    allocatable and used, the three GPU node rows and each device's
    used; a storage or term plan's three scratch rows; a storage plan's
    VG capacities, usage and takes and its SSD and HDD capacities), the
    4-byte port words and the byte rows (the node mask; a storage plan's
    storage flag and SSD and HDD usage) (csrc/fused_scan.cu dyn_bytes)."""
    d = block_dims(plan)
    rows8 = 4 + 6 + 1
    rows1 = 1
    if plan.has_scal:
        rows8 += 2 * d["k"]
    if plan.has_gpu:
        rows8 += 3 + d["g"]
    if _big(plan):
        rows8 += 3
    if plan.has_store:
        rows8 += 3 * d["v"] + d["ds"] + d["dh"]
        rows1 += 1 + d["ds"] + d["dh"]
    ports = 4 * d["w"] if plan.has_ports else 0
    return m * (8 * rows8 + ports + rows1)


def cache_bytes(plan: FusedPlan, m: int) -> int:
    """Shared memory of a slice's per-(class, node) caches: pass 1's
    part and pass 2's normalised terms [U, m], each node's last commit
    step [m] and six values a class (csrc/fused_scan.cu dyn_bytes)."""
    return 8 * ((2 * plan.u + 1) * m + 6 * plan.u)


def _even8(k: int) -> int:
    """Bytes of k int64 rounded up to 16 (the kernel keeps rows aligned)."""
    return 8 * (k + (k & 1))


def term_bytes(plan: FusedPlan) -> int:
    """Dynamic shared memory every layout of a term plan holds: the
    step's hard-spread minima, one a class slot (0 without terms)."""
    return _even8(block_dims(plan)["hm"]) if plan.has_terms else 0


def replica_bytes(plan: FusedPlan) -> int:
    """Dynamic shared memory of a block's replica of the shared term
    counts when it stays there (0 without terms)."""
    return _even8(replica_len(plan)) if plan.has_terms else 0


def _big(plan: FusedPlan) -> bool:
    return plan.has_store or plan.has_terms


def launch_shape(plan: FusedPlan, cluster: int) -> LaunchShape:
    """The shape of a launch of this plan on clusters of `cluster`
    blocks: the slices live in shared memory when one fits beside the
    static arrays. The base and B2 instantiations add the passes'
    caches when those fit too; a term plan first places the hard-spread
    minima and, when it fits, its replica of the shared counts, then the
    slice when that fits beside them."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster {cluster} not in {CLUSTER_SIZES}")
    m = -(-plan.n // cluster)
    need = slice_bytes(plan, m)
    static = static_smem(plan)
    if not _big(plan):
        if need + static > SMEM_PER_BLOCK:
            return LaunchShape(cluster, False, 0)
        with_caches = need + cache_bytes(plan, m)
        if with_caches + static <= SMEM_PER_BLOCK:
            return LaunchShape(cluster, True, with_caches, True)
        return LaunchShape(cluster, True, need)
    fixed = term_bytes(plan)
    if fixed + static > SMEM_PER_BLOCK:
        raise ValueError(f"{kernel_name(plan)}: {block_dims(plan)['hm']} hard-spread slots a "
                         f"class need {fixed} bytes of shared memory, past a block's")
    rep = replica_bytes(plan)
    replica = rep > 0 and fixed + rep + static <= SMEM_PER_BLOCK
    held = fixed + (rep if replica else 0)
    if held + need + static <= SMEM_PER_BLOCK:
        return LaunchShape(cluster, True, held + need, replica=replica)
    return LaunchShape(cluster, False, held, replica=replica)


def cluster_size(n: int, scenarios: int, max_active) -> int:
    """The cluster size of a launch of `scenarios` scans over n nodes,
    for every instantiation. `max_active(c)` is how many clusters of c
    blocks the card holds at once for this launch. The smallest size
    whose slices hold at most SLICE_NODES nodes (1 for small n, at most
    16), stepped down while the S clusters would not all be resident
    and a smaller size lets them be; when none does, 1 (the most
    scenarios at once, in waves)."""
    want = 1
    while want < CLUSTER_SIZES[-1] and -(-n // want) > SLICE_NODES:
        want *= 2
    for c in reversed([c for c in CLUSTER_SIZES if c <= want]):
        if max_active(c) >= scenarios:
            return c
    return 1


def _flags(plan: FusedPlan, batch: bool) -> int:
    return ((8 if batch else 0) | (4 if plan.has_scal else 0)
            | (2 if plan.has_gpu else 0) | (1 if plan.has_ports else 0)
            | (16 if plan.has_store else 0) | (32 if plan.has_terms else 0))


_MAX_ACTIVE: dict = {}


def max_active_clusters(plan: FusedPlan, scenarios: int, batch: bool, cluster: int) -> int:
    """How many clusters of `cluster` blocks of this plan's
    instantiation the current card holds at once (the CUDA occupancy
    query), cached per instantiation and shape."""
    shape = launch_shape(plan, cluster)
    d = block_dims(plan)
    dev = plan.device
    key = (_flags(plan, batch), plan.n, plan.u, d["k"], d["g"], d["w"], scenarios, shape,
           dev.index if dev.index is not None else torch.cuda.current_device())
    if key not in _MAX_ACTIVE:
        out = ctypes.c_int64(0)
        with torch.cuda.device(plan.device):
            err = _library().fused_scan_max_clusters(
                *key[:7], shape.cluster, shape.layout, shape.smem, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"{kernel_name(plan, batch)}: the occupancy query of "
                               f"{shape} failed: cudaError {err}")
        _MAX_ACTIVE[key] = out.value
    return _MAX_ACTIVE[key]


def choose_cluster(plan: FusedPlan, scenarios: int, batch: bool) -> int:
    """cluster_size for a launch of this plan on the current card."""
    return cluster_size(plan.n, scenarios,
                        lambda c: max_active_clusters(plan, scenarios, batch, c))


def _launch_inputs(plan: FusedPlan, cls_t, act_t, val_t, pin_t, batch: bool,
                   launch: LaunchShape, pins_first: bool = False):
    """The kernel's argument vector for the [S, ...] inputs in `launch`,
    and the
    (placements, state, block rows) it writes: outputs and scratch are
    allocated here, the new blocks' state copied from the plan's init."""
    dev = plan.device
    n, u, p = plan.n, plan.u, cls_t.shape[0]
    s_n = act_t.shape[0]
    d = block_dims(plan)
    for t, name, dtype, shape in _plan_checks(plan, d):
        _check(t, name, dtype, shape, dev)

    def empty(shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device=dev)

    def copies(t):
        # the kernel copies only the B1/B2 rows from their init
        return t.unsqueeze(0).repeat(s_n, *([1] * t.dim())).contiguous()

    k, g, w = d["k"], d["g"], d["w"]
    state = empty((s_n, 6, n))
    scal = empty((s_n, k, n)) if plan.has_scal else None
    gpu = empty((s_n, g, n)) if plan.has_gpu else None
    ports = empty((s_n, w, n), torch.int32) if plan.has_ports else None
    store = ((copies(plan.vg_init), copies(plan.ssd_init), copies(plan.hdd_init))
             if plan.has_store else None)
    terms = ((copies(plan.t_init), copies(plan.g_init), copies(plan.gt_init),
              copies(plan.s_init)) if plan.has_terms else None)
    placements = empty((s_n, p), torch.int32)
    partial = empty((s_n, max(n, 1)))
    aux = empty((s_n, 3, max(n, 1))) if _big(plan) else None
    vg_take = empty((s_n, d["v"], n)) if plan.has_store else None
    # a term plan's per-block scratch: the soft-spread stamps, and the
    # replicas of the shared counts when they are not in shared memory
    blocks_n = s_n * launch.cluster
    stamps = (torch.full((blocks_n, d["vs"]), -1, dtype=torch.int64, device=dev)
              if plan.has_terms else None)
    replicas = (empty((blocks_n, max(replica_len(plan), 1)))
                if plan.has_terms and not launch.replica else None)
    vg_s, ssd_s, hdd_s = store if store is not None else (None,) * 3
    t_s, g_s, gt_s, s_s = terms if terms is not None else (None,) * 4

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    args = [ptr(t) for t in (
        plan.alloc, plan.init, plan.feasible, plan.cls_tab, plan.cls_req, cls_t,
        plan.scal_alloc, plan.scal_init, plan.scal_req,
        plan.gpu_node, plan.gpu_init, plan.gpu_cls,
        plan.port_init, plan.port_cls,
        act_t, pin_t, val_t, state, scal, gpu, ports, partial, placements,
        plan.vg_cap, plan.ssd_cap, plan.hdd_cap, plan.has_storage,
        plan.cls_lvm, plan.cls_ssd, plan.cls_hdd, plan.cls_wants,
        vg_s, ssd_s, hdd_s, vg_take,
        plan.topo, plan.t_off, plan.t_cls, plan.cls_rows, plan.g_topo, plan.g_off,
        plan.g_match, plan.cls_grows, plan.cls_gid, plan.g_self,
        plan.h_row, plan.h_skew, plan.h_self, plan.h_cand, plan.cls_hrows,
        plan.s_row, plan.s_host, plan.s_skew, plan.s_q, plan.cls_srows,
        plan.s_haskeys, plan.s_off, plan.log_tab, plan.t_rep, plan.g_rep, plan.s_rep,
        t_s, g_s, gt_s, s_s, stamps, replicas, aux,
    )] + [n, u, p, k, g, w,
          d["v"], d["ds"], d["dh"], d["lv"], d["sv"], d["hv"],
          d["t"], d["r"], d["a"], d["gm"], d["ch"], d["hm"], d["cs"], d["sm"],
          d["vt"], d["va"], d["vs"], d["vr"], d["vgr"], d["vsr"],
          *plan.weights, s_n, _flags(plan, batch),
          launch.cluster, launch.layout, launch.smem, int(pins_first)]
    assert len(args) == _N_ARGS
    blocks = _state_blocks(plan, scal, gpu, ports, store, terms)
    # the scratch rides along so that it outlives the call's enqueue
    return args, (placements, state, blocks, (partial, aux, vg_take, stamps, replicas))


def _launch(plan: FusedPlan, cls_t, act_t, val_t, pin_t, batch: bool,
            cluster: Optional[int] = None, pins_first: bool = False) -> list:
    """Launch the kernel over the scenarios of the [S, ...] inputs: one
    cluster per scenario when `batch`, else one cluster (S == 1), of the
    size the rule chooses unless `cluster` names one; `pins_first` runs
    the pinned pods' pass before the free pods' (batch only). Counts the
    launch under its kernel's name and records the cluster size it ran."""
    dev = plan.device
    s_n, p = act_t.shape[0], cls_t.shape[0]
    if cluster is None:
        cluster = choose_cluster(plan, s_n, batch)
    shape = launch_shape(plan, cluster)
    args, (placements, state, blocks, _scratch) = _launch_inputs(
        plan, cls_t, act_t, val_t, pin_t, batch, shape, pins_first)
    name = PINS_FIRST_KERNEL_NAME if pins_first else kernel_name(plan, batch)
    if p == 0:
        state.copy_(plan.init.expand_as(state))
        for key, init in (("used_scalar", plan.scal_init), ("gpu_used", plan.gpu_init),
                          ("ports_used", plan.port_init)):
            if key in blocks:
                blocks[key].copy_(init.expand_as(blocks[key]))
    else:
        argv = (ctypes.c_int64 * _N_ARGS)(*args)
        lib = _library()
        ln = profile.current()
        # the kernel runs after this returns; tensors freed here go back
        # to the caching allocator on this stream, which orders any
        # reuse after the kernel
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if ln is not None:
                ln.start()
            err = lib.fused_scan_launch(argv, _N_ARGS, stream)
            if ln is not None:
                ln.stop()
        if err != 0:
            raise RuntimeError(f"{name} launch of {shape} failed: cudaError {err}")
        LAUNCHES[name] += 1
        CLUSTERS[name] = shape.cluster
    return [(placements[s], _final(s, state, blocks)) for s in range(s_n)]


def _device_of(plan: FusedPlan) -> str:
    dev = plan.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused scan for device {dev}")
    return dev.type


def _cost(ln, plan: FusedPlan, class_of_pod, scenarios, name: str) -> None:
    """Count this launch under the cost record of its shape (obs/costs.py):
    the cluster the card ran it on, none for the plain version."""
    from ..obs import costs

    cluster = CLUSTERS[name] if plan.device.type == "cuda" else None
    p = len(class_of_pod)
    key = (name, len(scenarios), p, plan.n, cluster)
    ln.cost(key, lambda: costs.fused_scan_record(
        ln.site, name, plan, class_of_pod, scenarios, cluster))


def run_fused_scan(plan: FusedPlan, class_of_pod, active, valid, pinned=None,
                   site: str = "scan"):
    """Run one scan. Returns (placements[P] int32, final state dict of
    [N] int64 rows keyed by STATE_FIELDS, plus the rows of the blocks
    the plan has), on the plan's device. A plan on the CPU takes the
    plain version; a plan on a CUDA device takes the kernel or raises.
    The launch is instrumented at `site` (obs/profile.py)."""
    scenarios = [(active, valid, pinned)]
    with profile.launch(site, plan.device) as ln:
        if _device_of(plan) == "cpu":
            out = fused_scan_reference(plan, class_of_pod, active, valid, pinned)
        else:
            inputs = _scenario_inputs(plan, class_of_pod, scenarios)
            out = _launch(plan, *inputs, batch=False)[0]
        _cost(ln, plan, class_of_pod, scenarios, kernel_name(plan))
    return out


def run_fused_scan_batch(plan: FusedPlan, class_of_pod, scenarios, pins_first=False,
                         site: str = "scan"):
    """Several independent scans of one plan: `scenarios` is a list of
    (active[P], valid[N], pinned[P] or None). Returns [(placements,
    final), ...] in scenario order — the contract of the JAX package's
    run_scan_pallas_batch. With `pins_first` each scenario commits its
    pinned pods before any free pod schedules (two passes over the pod
    order in the one launch: the JAX package's _scenario_pinned_impl).
    On a CUDA plan all scenarios go in one launch on one stream (one
    cluster each); a CPU plan takes the plain version. The launch is
    instrumented at `site` (obs/profile.py)."""
    with profile.launch(site, plan.device) as ln:
        if _device_of(plan) == "cpu":
            out = fused_scan_batch_reference(plan, class_of_pod, scenarios,
                                             pins_first=pins_first)
        else:
            inputs = _scenario_inputs(plan, class_of_pod, scenarios)
            out = _launch(plan, *inputs, batch=True, pins_first=pins_first)
        _cost(ln, plan, class_of_pod, scenarios,
              PINS_FIRST_KERNEL_NAME if pins_first else BATCH_KERNEL_NAME)
    return out


def _run_with_cluster(plan: FusedPlan, class_of_pod, scenarios, batch: bool,
                      cluster: int, pins_first: bool = False) -> list:
    """The kernel on a CUDA plan with the cluster size given, not
    chosen: for holding every size against the plain version
    (chip_smoke.py, the `cuda` tests). `batch` False takes one scenario.
    Raises for a size the instantiation does not take."""
    if _device_of(plan) != "cuda":
        raise ValueError("the kernel runs on a CUDA plan")
    if not batch and len(scenarios) != 1:
        raise ValueError("a single launch takes one scenario")
    launch_shape(plan, cluster)  # raises before any copy
    inputs = _scenario_inputs(plan, class_of_pod, scenarios)
    return _launch(plan, *inputs, batch=batch, cluster=cluster, pins_first=pins_first)


def kernel_label(plan: FusedPlan) -> str:
    """What a single scan of this plan runs, for the `batch-kernel`
    trace note: on the card the instantiation and its cluster size."""
    name = kernel_name(plan)
    if plan.device.type == "cuda":
        return f"cuda-{name} (cluster {choose_cluster(plan, 1, False)})"
    return f"torch-plain-{name} ({plan.device.type})"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = [
    "BATCH_KERNEL_NAME",
    "CLUSTERS",
    "CLUSTER_SIZES",
    "EXT_KERNEL_NAME",
    "FusedPlan",
    "INACTIVE",
    "KERNEL_NAME",
    "LAUNCHES",
    "LaunchShape",
    "NoCardError",
    "NotInKernelError",
    "OutOfSliceError",
    "PINS_FIRST_KERNEL_NAME",
    "STORE_KERNEL_NAME",
    "STORE_TERMS_KERNEL_NAME",
    "TERMS_KERNEL_NAME",
    "TERM_ROWS",
    "block_dims",
    "cache_bytes",
    "node_owned",
    "replica_bytes",
    "replica_len",
    "replica_offsets",
    "build_plan",
    "check_in_kernel",
    "choose_cluster",
    "cluster_size",
    "fused_scan_batch_reference",
    "fused_scan_reference",
    "kernel_label",
    "kernel_name",
    "launch_shape",
    "max_active_clusters",
    "pack_port_words",
    "plan_from_jax_arrays",
    "plan_from_scan_arrays",
    "reset_launch_counts",
    "resolve_device",
    "run_fused_scan",
    "run_fused_scan_batch",
    "scratch_bytes",
    "slice_bytes",
    "slices",
    "static_smem",
    "term_bytes",
    "torch_scan_reason",
    "value_to_node",
]
