"""Host-side tensorization of cluster + pod-batch state.

The fake-apiserver object store of the reference (client-go ObjectTracker
+ scheduler cache snapshot, vendor/.../internal/cache/snapshot.go:29)
collapses into dense arrays:

- per-node allocatable vectors (cpu milli, memory bytes, ephemeral,
  pod slots) and a generic `[R, N]` allocatable matrix for the Simon
  max-share score (plugin/simon.go:44-67)
- per-pod-CLASS static matrices `[U, N]`: everything that does not
  depend on placement state — taint/affinity/nodename/unschedulable
  feasibility, preferred-node-affinity raw scores, PreferNoSchedule
  intolerable-taint counts, NodePreferAvoidPods, ImageLocality, Simon
  raw shares. Pods expanded from the same workload share a class, so
  the O(pods x nodes) host work shrinks to O(classes x nodes).
- a small host-port vocabulary with a pairwise conflict matrix
  (wildcard-IP semantics of HostPortInfo.CheckConflict)
- per-device GPU memory state for the open-gpu-share plugin

Dynamic state (requested resources, pod counts, port usage, GPU usage)
is read off the oracle by `encode_dynamic` and becomes the fused
scan's initial state (ops/fused_scan.py), or, through `to_scan_static`
/ `to_scan_state`, the eager torch scan's (ops/scan.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, NamedTuple

import numpy as np

from ..models import labels as lbl
from ..models import requests as req
from ..models import storage as stor
from ..utils.memo import IdentityMemo, register_cache
from ..utils.trace import phase
from .profiles import freeze as _freeze
from .profiles import node_profiles_cached as _shared_node_profiles
from .profiles import uses_match_fields as _uses_match_fields
from .terms import TermTables, build_term_tables, combined_pref_carry, combined_pref_init
from ..scheduler.oracle import (
    Oracle,
    _pod_host_ports,
    IMG_MIN_THRESHOLD,
    IMG_MAX_CONTAINER_THRESHOLD,
    MAX_NODE_SCORE,
)


def _ceil(v: Fraction) -> int:
    return -((-v.numerator) // v.denominator)


@dataclass
class ClusterStatic:
    """Placement-independent cluster tensors."""

    n: int
    node_names: List[str]
    alloc_mcpu: np.ndarray  # [N] i64
    alloc_mem: np.ndarray  # [N] i64
    alloc_eph: np.ndarray  # [N] i64
    alloc_pods: np.ndarray  # [N] i64
    # Simon score: allocatable matrix over the union of resource names
    simon_resources: List[str]
    simon_alloc: np.ndarray  # [R, N] f64
    # scalar (extended) resources tracked by NodeResourcesFit
    scalar_names: List[str]
    scalar_alloc: np.ndarray  # [S, N] i64
    # GPU share
    g: int  # max devices on any node
    gpu_count: np.ndarray  # [N] i64
    gpu_per_dev: np.ndarray  # [N] i64
    gpu_total: np.ndarray  # [N] i64 (capacity gpu-mem)
    # open-local storage: VGs and exclusive devices (devices sorted
    # ascending by capacity per media type, CheckExclusiveResource...
    # semantics, open-local algo/common.go:290-351)
    v: int  # max VGs per node
    vg_cap: np.ndarray  # [N, V] i64
    vg_valid: np.ndarray  # [N, V] bool
    has_storage: np.ndarray  # [N] bool (node has the storage annotation)
    d_ssd: int
    d_hdd: int
    ssd_cap: np.ndarray  # [N, Ds] i64 (ascending)
    ssd_valid: np.ndarray  # [N, Ds] bool
    hdd_cap: np.ndarray  # [N, Dh] i64 (ascending)
    hdd_valid: np.ndarray  # [N, Dh] bool
    # ports vocabulary
    port_vocab: List[tuple]
    port_conflict: np.ndarray  # [Pt, Pt] bool


@dataclass
class DynamicState:
    """The scan carry, as host arrays (mirrors oracle NodeState)."""

    used_mcpu: np.ndarray
    used_mem: np.ndarray
    used_eph: np.ndarray
    used_scalar: np.ndarray  # [S, N]
    nz_mcpu: np.ndarray
    nz_mem: np.ndarray
    pod_cnt: np.ndarray
    ports_used: np.ndarray  # [N, Pt] bool
    gpu_used: np.ndarray  # [N, G] i64
    vg_used: np.ndarray  # [N, V] i64
    ssd_used: np.ndarray  # [N, Ds] bool
    hdd_used: np.ndarray  # [N, Dh] bool


@dataclass
class PodBatch:
    """A batch of pods to schedule, class-deduplicated."""

    p: int
    u: int
    class_of_pod: np.ndarray  # [P] i32
    pinned_node: np.ndarray  # [P] i32, -1 when loose
    # per-class request vectors
    req_mcpu: np.ndarray  # [U]
    req_mem: np.ndarray
    req_eph: np.ndarray
    req_scalar: np.ndarray  # [U, S]
    has_request: np.ndarray  # [U] bool (any nonzero native/scalar request)
    nz_mcpu: np.ndarray
    nz_mem: np.ndarray
    gpu_mem: np.ndarray  # [U] per-GPU memory
    gpu_cnt: np.ndarray  # [U]
    want_ports: np.ndarray  # [U, Pt] bool (ports the pod binds)
    conflict_ports: np.ndarray  # [U, Pt] bool (vocab entries that would conflict)
    # open-local volume requests (sizes padded with 0)
    lvm_sizes: np.ndarray  # [U, Lv] i64, in declaration order
    ssd_sizes: np.ndarray  # [U, Sv] i64, ascending
    hdd_sizes: np.ndarray  # [U, Hv] i64, ascending
    wants_storage: np.ndarray  # [U] bool
    terms: TermTables  # affinity/spread tables
    # out-of-tree custom plugins (stateless: folded per class)
    custom_raw: np.ndarray  # [K, U, N] i64 raw scores (K>=1, dummy row 0)
    custom_mode: np.ndarray  # [K] i32: 0 none, 1 default, 2 reverse, 3 minmax
    custom_weight: np.ndarray  # [K] i64
    # static per-class matrices
    static_feasible: np.ndarray  # [U, N] bool
    simon_raw: np.ndarray  # [U, N] i64
    nodeaff_raw: np.ndarray  # [U, N] i64
    taint_intol: np.ndarray  # [U, N] i64
    avoid_score: np.ndarray  # [U, N] i64
    image_score: np.ndarray  # [U, N] i64
    # one representative pod per class (host-only, never shipped to
    # device): the bulk replay resolves per-class commit summaries from
    # these (engine.build_bulk_tables) — class members share
    # request/port content by class-key construction
    class_pods: list = None


# the expensive spec-side deep freeze runs once per workload template
# instead of once per pod (~7 s saved at 100k pods): replica clones
# share their containers / tolerations / affinity / selector objects
# (workloads.py _expand_template; utils/memo.py contract)
_SPEC_KEY_MEMO = IdentityMemo()


def _spec_key(spec: dict):
    parts = (
        spec.get("containers"),
        spec.get("initContainers"),
        spec.get("nodeSelector"),
        spec.get("affinity"),
        spec.get("topologySpreadConstraints"),
        spec.get("tolerations"),
        spec.get("overhead"),
    )
    return _SPEC_KEY_MEMO.get(parts, lambda: _freeze_spec_parts(spec))


def _freeze_spec_parts(spec: dict):
    containers = [
        {
            "resources": c.get("resources"),
            "ports": c.get("ports"),
            "image": c.get("image"),
        }
        for c in spec.get("containers") or []
    ]
    inits = [{"resources": c.get("resources")} for c in spec.get("initContainers") or []]
    return _freeze(
        {
            "nodeSelector": spec.get("nodeSelector"),
            "affinity": spec.get("affinity"),
            "topologySpreadConstraints": spec.get("topologySpreadConstraints"),
            "tolerations": spec.get("tolerations"),
            "overhead": spec.get("overhead"),
            "containers": containers,
            "inits": inits,
        }
    )


class _InternedKey:
    """A (spec_key, frozen_labels) pair with its deep hash computed
    once. Canonicalized by content in _KEY_INTERN, so equal content —
    even from distinct templates — is the SAME object and the classes
    dict compares by the `is` fast path instead of re-hashing a nested
    tuple per pod."""

    __slots__ = ("key", "_hash")

    def __init__(self, key):
        self.key = key
        self._hash = hash(key)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return self is other or (
            isinstance(other, _InternedKey) and self.key == other.key
        )


_KEY_INTERN: dict = {}
_CLASS_PREFIX_MEMO = IdentityMemo()
register_cache(_KEY_INTERN.clear)


def _class_prefix(spec: dict, labels):
    """Identity-memoized, content-interned heavy part of the class key.
    The memo sources are every object `_spec_key`/`_freeze` read, so an
    identity hit implies identical content; template-expanded replicas
    share all of them (workloads._expand_template)."""

    def make():
        k = (_spec_key(spec), _freeze(labels))
        tok = _KEY_INTERN.get(k)
        if tok is None:
            tok = _KEY_INTERN[k] = _InternedKey(k)
        return tok

    return _CLASS_PREFIX_MEMO.get(
        (
            spec.get("containers"),
            spec.get("initContainers"),
            spec.get("nodeSelector"),
            spec.get("affinity"),
            spec.get("topologySpreadConstraints"),
            spec.get("tolerations"),
            spec.get("overhead"),
            labels,
        ),
        make,
    )


def _class_key(pod: dict):
    spec = pod.get("spec") or {}
    meta = pod.get("metadata") or {}
    anno = meta.get("annotations") or {}
    ctrl_kind = None
    for r in meta.get("ownerReferences") or ():
        if r.get("controller"):
            ctrl_kind = r.get("kind")
            break
    # content-based equality is preserved: the interned prefix compares
    # by content (identical content from distinct templates interns to
    # one object), per-pod cheap fields ride alongside
    return (
        _class_prefix(spec, meta.get("labels")),
        meta.get("namespace"),
        spec.get("nodeName"),
        spec.get("hostNetwork"),
        anno.get(stor.GPU_MEM_ANNO),
        anno.get(stor.GPU_COUNT_ANNO),
        anno.get(stor.ANNO_POD_LOCAL_STORAGE),
        ctrl_kind,
    )


# cross-run ClusterStatic cache: planners and benches call simulate()
# repeatedly over the SAME decoded node dicts, and a fresh Oracle's
# pristine (alloc_epoch == 0) encoding is a pure function of those
# source objects — same identity-memo warm-cache contract as the
# request/port memos (utils/memo.py; clear_all_memos releases it).
# port_vocab/port_conflict are per-batch fields set by encode_batch
# BEFORE every use, so sharing the carrier object is safe
# single-threaded. GPU runs bump alloc_epoch and bypass this cache.
_CLUSTER_MEMO = IdentityMemo(max_entries=64)


def encode_cluster_cached(oracle: Oracle) -> ClusterStatic:
    src = getattr(oracle, "source_nodes", None)
    if src is None or oracle.alloc_epoch != 0:
        return encode_cluster(oracle)
    return _CLUSTER_MEMO.get(tuple(src), lambda: encode_cluster(oracle))


def encode_cluster(oracle: Oracle) -> ClusterStatic:
    nodes = oracle.nodes
    n = len(nodes)
    alloc_mcpu = np.array([ns.alloc_milli_cpu() for ns in nodes], dtype=np.int64)
    alloc_mem = np.array([ns.alloc_int(req.MEMORY) for ns in nodes], dtype=np.int64)
    alloc_eph = np.array([ns.alloc_int(req.EPHEMERAL) for ns in nodes], dtype=np.int64)
    alloc_pods = np.array([ns.alloc_int(req.PODS) for ns in nodes], dtype=np.int64)

    simon_resources = sorted({name for ns in nodes for name in ns.alloc})
    simon_alloc = np.zeros((len(simon_resources), n), dtype=np.float64)
    for r_i, name in enumerate(simon_resources):
        for n_i, ns in enumerate(nodes):
            simon_alloc[r_i, n_i] = float(ns.alloc.get(name, Fraction(0)))

    scalar_names = sorted(
        {
            name
            for ns in nodes
            for name in ns.alloc
            if name not in (req.CPU, req.MEMORY, req.EPHEMERAL, req.PODS)
            and req.is_scalar_resource(name)
        }
    )
    scalar_alloc = np.zeros((len(scalar_names), n), dtype=np.int64)
    for s_i, name in enumerate(scalar_names):
        for n_i, ns in enumerate(nodes):
            scalar_alloc[s_i, n_i] = ns.alloc_int(name)

    gpu_count = np.array([ns.gpu.count if ns.gpu else 0 for ns in nodes], dtype=np.int64)
    gpu_per_dev = np.array(
        [ns.gpu.per_device_mem if ns.gpu else 0 for ns in nodes], dtype=np.int64
    )
    gpu_total = np.array(
        [stor.node_total_gpu_memory(ns.node) for ns in nodes], dtype=np.int64
    )
    g = int(gpu_count.max()) if n else 0

    # open-local storage layout
    has_storage = np.array([ns.storage is not None for ns in nodes], dtype=bool)
    v = max((len(ns.storage.vgs) for ns in nodes if ns.storage), default=0)
    d_ssd = max(
        (
            sum(1 for d in ns.storage.devices if d.media_type == "ssd")
            for ns in nodes
            if ns.storage
        ),
        default=0,
    )
    d_hdd = max(
        (
            sum(1 for d in ns.storage.devices if d.media_type == "hdd")
            for ns in nodes
            if ns.storage
        ),
        default=0,
    )
    vg_cap = np.zeros((n, max(v, 1)), dtype=np.int64)
    vg_valid = np.zeros((n, max(v, 1)), dtype=bool)
    ssd_cap = np.zeros((n, max(d_ssd, 1)), dtype=np.int64)
    ssd_valid = np.zeros((n, max(d_ssd, 1)), dtype=bool)
    hdd_cap = np.zeros((n, max(d_hdd, 1)), dtype=np.int64)
    hdd_valid = np.zeros((n, max(d_hdd, 1)), dtype=bool)
    for n_i, ns in enumerate(nodes):
        if not ns.storage:
            continue
        for v_i, vg in enumerate(ns.storage.vgs):
            vg_cap[n_i, v_i] = vg.capacity
            vg_valid[n_i, v_i] = True
        # devices ascending by capacity (stable), matching the oracle's
        # _device_fit sort; is_allocated state goes in DynamicState
        for media, cap_arr, valid_arr in (
            ("ssd", ssd_cap, ssd_valid),
            ("hdd", hdd_cap, hdd_valid),
        ):
            devs = sorted(
                (d for d in ns.storage.devices if d.media_type == media),
                key=lambda d: d.capacity,
            )
            for d_i, dev in enumerate(devs):
                cap_arr[n_i, d_i] = dev.capacity
                valid_arr[n_i, d_i] = True

    # port vocab built later (needs the pod batch); placeholder
    return ClusterStatic(
        n=n,
        node_names=[ns.name for ns in nodes],
        alloc_mcpu=alloc_mcpu,
        alloc_mem=alloc_mem,
        alloc_eph=alloc_eph,
        alloc_pods=alloc_pods,
        simon_resources=simon_resources,
        simon_alloc=simon_alloc,
        scalar_names=scalar_names,
        scalar_alloc=scalar_alloc,
        g=g,
        gpu_count=gpu_count,
        gpu_per_dev=gpu_per_dev,
        gpu_total=gpu_total,
        v=v,
        vg_cap=vg_cap,
        vg_valid=vg_valid,
        has_storage=has_storage,
        d_ssd=d_ssd,
        d_hdd=d_hdd,
        ssd_cap=ssd_cap,
        ssd_valid=ssd_valid,
        hdd_cap=hdd_cap,
        hdd_valid=hdd_valid,
        port_vocab=[],
        port_conflict=np.zeros((0, 0), dtype=bool),
    )


def encode_dynamic(oracle: Oracle, cluster: ClusterStatic) -> DynamicState:
    nodes = oracle.nodes
    n = cluster.n
    s = len(cluster.scalar_names)
    pt = len(cluster.port_vocab)
    g = max(cluster.g, 1)
    st = DynamicState(
        used_mcpu=np.array([ns.req_mcpu for ns in nodes], dtype=np.int64),
        used_mem=np.array([ns.req_mem for ns in nodes], dtype=np.int64),
        used_eph=np.array([ns.req_eph for ns in nodes], dtype=np.int64),
        used_scalar=np.zeros((s, n), dtype=np.int64),
        nz_mcpu=np.array([ns.nz_mcpu for ns in nodes], dtype=np.int64),
        nz_mem=np.array([ns.nz_mem for ns in nodes], dtype=np.int64),
        pod_cnt=np.array([len(ns.pods) for ns in nodes], dtype=np.int64),
        ports_used=np.zeros((n, pt), dtype=bool),
        gpu_used=np.zeros((n, g), dtype=np.int64),
        vg_used=np.zeros((n, max(cluster.v, 1)), dtype=np.int64),
        ssd_used=np.zeros((n, max(cluster.d_ssd, 1)), dtype=bool),
        hdd_used=np.zeros((n, max(cluster.d_hdd, 1)), dtype=bool),
    )
    for s_i, name in enumerate(cluster.scalar_names):
        for n_i, ns in enumerate(nodes):
            st.used_scalar[s_i, n_i] = ns.req_scalar.get(name, 0)
    for n_i, ns in enumerate(nodes):
        for port in ns.used_ports:
            if port in cluster.port_vocab:
                st.ports_used[n_i, cluster.port_vocab.index(port)] = True
        if ns.gpu:
            for g_i, used in enumerate(ns.gpu.used):
                st.gpu_used[n_i, g_i] = used
        if ns.storage:
            for v_i, vg in enumerate(ns.storage.vgs):
                st.vg_used[n_i, v_i] = vg.requested
            for media, used_arr in (("ssd", st.ssd_used), ("hdd", st.hdd_used)):
                devs = sorted(
                    (d for d in ns.storage.devices if d.media_type == media),
                    key=lambda d: d.capacity,
                )
                for d_i, dev in enumerate(devs):
                    used_arr[n_i, d_i] = dev.is_allocated
    return st


def _ports_conflict_pair(a: tuple, b: tuple) -> bool:
    (aip, aproto, aport), (bip, bproto, bport) = a, b
    if aport != bport or aproto != bproto:
        return False
    return aip == "0.0.0.0" or bip == "0.0.0.0" or aip == bip


def _image_scores_by_profile(
    pod: dict, oracle: Oracle, rep_idx, profile_counts
) -> np.ndarray:
    """ImageLocality raw scores per node profile (mirrors
    Oracle._score_image_locality bit for bit; image spread counts come
    from profile counts instead of a scan over every node)."""
    containers = (pod.get("spec") or {}).get("containers") or []
    nc = len(rep_idx)
    if not containers:
        return np.zeros(nc, dtype=np.int64)
    total_nodes = len(oracle.nodes)
    wanted = set()
    norm_names = []
    for c in containers:
        name = c.get("image", "")
        if ":" not in name.rsplit("/", 1)[-1]:
            name = name + ":latest"
        wanted.add(name)
        norm_names.append(name)
    # per-profile image presence/size
    rep_images: List[dict] = []
    for r in rep_idx:
        images = {}
        for img in ((oracle.nodes[int(r)].node.get("status") or {}).get("images")) or []:
            size = int(img.get("sizeBytes", 0))
            for name in img.get("names") or []:
                if name in wanted:
                    images[name] = size
        rep_images.append(images)
    spread: Dict[str, int] = {w: 0 for w in wanted}
    for c_i, images in enumerate(rep_images):
        for name in images:
            spread[name] += int(profile_counts[c_i])
    out = np.zeros(nc, dtype=np.int64)
    max_threshold = IMG_MAX_CONTAINER_THRESHOLD * len(containers)
    for c_i, images in enumerate(rep_images):
        s = 0
        for name in norm_names:
            if name in images:
                s += int(images[name] * (spread[name] / total_nodes))
        s = min(max(s, IMG_MIN_THRESHOLD), max_threshold)
        out[c_i] = (
            MAX_NODE_SCORE * (s - IMG_MIN_THRESHOLD) // (max_threshold - IMG_MIN_THRESHOLD)
        )
    return out


def encode_batch(
    oracle: Oracle, cluster: ClusterStatic, pods: List[dict], groups=None
) -> PodBatch:
    """Build class-deduplicated static tensors for a pod batch.

    `groups` is the optional (group_of, firsts) content-group index
    from workload expansion (workloads.ExpandIndex): group members are
    content-identical except metadata.name, so the class key, host
    ports, and pin target resolve once per GROUP and broadcast to pods
    by numpy indexing — the class-dedup loop drops from O(pods) dict
    work to O(groups)."""
    # port vocabulary over batch + existing usage
    vocab: List[tuple] = []
    seen = set()
    for ns in oracle.nodes:
        for port in sorted(ns.used_ports):
            if port not in seen:
                seen.add(port)
                vocab.append(port)
    port_scan = pods if groups is None else groups[1]
    for pod in port_scan:
        for port in _pod_host_ports(pod):
            if port not in seen:
                seen.add(port)
                vocab.append(port)
    pt = len(vocab)
    conflict = np.zeros((pt, pt), dtype=bool)
    for i in range(pt):
        for j in range(pt):
            conflict[i, j] = _ports_conflict_pair(vocab[i], vocab[j])
    cluster.port_vocab = vocab
    cluster.port_conflict = conflict

    # class dedup
    class_ids: Dict[str, int] = {}
    class_pods: List[dict] = []
    if groups is not None:
        group_of, firsts = groups
        ng = len(firsts)
        g2c = np.zeros(ng, dtype=np.int32)
        g_pin = np.full(ng, -1, dtype=np.int32)
        node_index = oracle.node_index
        for g_i, first in enumerate(firsts):
            key = _class_key(first)
            if key not in class_ids:
                class_ids[key] = len(class_pods)
                class_pods.append(first)
            g2c[g_i] = class_ids[key]
            node_name = (first.get("spec") or {}).get("nodeName")
            if node_name:
                g_pin[g_i] = node_index.get(node_name, -1)
        if len(pods):
            class_of_pod = g2c[group_of].astype(np.int32, copy=False)
            pinned = g_pin[group_of].astype(np.int32, copy=False)
        else:
            class_of_pod = np.zeros(0, dtype=np.int32)
            pinned = np.full(0, -1, dtype=np.int32)
    else:
        class_of_pod = np.zeros(len(pods), dtype=np.int32)
        pinned = np.full(len(pods), -1, dtype=np.int32)
        for p_i, pod in enumerate(pods):
            key = _class_key(pod)
            if key not in class_ids:
                class_ids[key] = len(class_pods)
                class_pods.append(pod)
            class_of_pod[p_i] = class_ids[key]
            node_name = (pod.get("spec") or {}).get("nodeName")
            if node_name:
                pinned[p_i] = oracle.node_index.get(node_name, -1)

    u = len(class_pods)
    n = cluster.n
    s = len(cluster.scalar_names)

    req_mcpu = np.zeros(u, dtype=np.int64)
    req_mem = np.zeros(u, dtype=np.int64)
    req_eph = np.zeros(u, dtype=np.int64)
    req_scalar = np.zeros((u, s), dtype=np.int64)
    has_request = np.zeros(u, dtype=bool)
    nz_mcpu = np.zeros(u, dtype=np.int64)
    nz_mem = np.zeros(u, dtype=np.int64)
    gpu_mem = np.zeros(u, dtype=np.int64)
    gpu_cnt = np.zeros(u, dtype=np.int64)
    want_ports = np.zeros((u, pt), dtype=bool)
    conflict_ports = np.zeros((u, pt), dtype=bool)
    class_volumes = [stor.parse_pod_local_volumes(p) for p in class_pods]
    lv = max((len(lvm) for lvm, _dev in class_volumes), default=0)
    sv = max(
        (sum(1 for d in dev if d.kind == "SSD") for _lvm, dev in class_volumes), default=0
    )
    hv = max(
        (sum(1 for d in dev if d.kind == "HDD") for _lvm, dev in class_volumes), default=0
    )
    lvm_sizes = np.zeros((u, max(lv, 1)), dtype=np.int64)
    ssd_sizes = np.zeros((u, max(sv, 1)), dtype=np.int64)
    hdd_sizes = np.zeros((u, max(hv, 1)), dtype=np.int64)
    wants_storage = np.zeros(u, dtype=bool)
    static_feasible = np.ones((u, n), dtype=bool)
    simon_raw = np.zeros((u, n), dtype=np.int64)
    nodeaff_raw = np.zeros((u, n), dtype=np.int64)
    taint_intol = np.zeros((u, n), dtype=np.int64)
    avoid_score = np.zeros((u, n), dtype=np.int64)
    image_score = np.zeros((u, n), dtype=np.int64)

    node_class_of, rep_idx = _shared_node_profiles(
        [ns.node for ns in oracle.nodes], class_pods,
        cache_sources=getattr(oracle, "source_nodes", None),
    )
    profile_counts = np.bincount(node_class_of, minlength=len(rep_idx))

    for u_i, pod in enumerate(class_pods):
        spec = pod.get("spec") or {}
        requests = req.pod_requests(pod)
        req_mcpu[u_i] = _ceil(requests.get(req.CPU, Fraction(0)) * 1000)
        req_mem[u_i] = _ceil(requests.get(req.MEMORY, Fraction(0)))
        req_eph[u_i] = _ceil(requests.get(req.EPHEMERAL, Fraction(0)))
        any_scalar = False
        for s_i, name in enumerate(cluster.scalar_names):
            if name in requests:
                req_scalar[u_i, s_i] = _ceil(requests[name])
                any_scalar = any_scalar or req_scalar[u_i, s_i] != 0
        # scalar request on a resource NO node advertises still blocks
        # scheduling via fitsRequest; treat as statically infeasible
        unknown_scalar = any(
            name not in (req.CPU, req.MEMORY, req.EPHEMERAL, req.PODS)
            and req.is_scalar_resource(name)
            and name not in cluster.scalar_names
            and _ceil(requests[name]) > 0
            for name in requests
        )
        has_request[u_i] = bool(
            req_mcpu[u_i] or req_mem[u_i] or req_eph[u_i] or any_scalar or unknown_scalar
        )
        nz_mcpu[u_i] = req.pod_nonzero_request(pod, req.CPU)
        nz_mem[u_i] = req.pod_nonzero_request(pod, req.MEMORY)
        g_mem, g_cnt = stor.pod_gpu_request(pod)
        gpu_mem[u_i] = g_mem
        gpu_cnt[u_i] = g_cnt
        lvm_vols, dev_vols = class_volumes[u_i]
        wants_storage[u_i] = bool(lvm_vols or dev_vols)
        for i, vol in enumerate(lvm_vols):
            lvm_sizes[u_i, i] = vol.size
        # device volumes ascending by size per media (the oracle's
        # _device_fit sorts them the same way)
        for kind, arr in (("SSD", ssd_sizes), ("HDD", hdd_sizes)):
            sizes = sorted(v.size for v in dev_vols if v.kind == kind)
            for i, size in enumerate(sizes):
                arr[u_i, i] = size
        for port in _pod_host_ports(pod):
            w_i = vocab.index(port)
            want_ports[u_i, w_i] = True
        conflict_ports[u_i] = (
            want_ports[u_i].astype(np.int32) @ conflict.astype(np.int32)
        ) > 0

        tolerations = spec.get("tolerations") or []
        unsched_tolerated = lbl.tolerations_tolerate_taint(
            tolerations,
            {"key": "node.kubernetes.io/unschedulable", "effect": "NoSchedule"},
        )
        simon_empty = not requests and not req.pod_limits(pod)

        # label/taint feasibility + static scores, evaluated once per
        # node profile (per node when the class reads node names)
        if _uses_match_fields(spec):
            dom = np.arange(n, dtype=np.int64)
            inv = None
        else:
            dom = rep_idx
            inv = node_class_of
        nd = len(dom)
        ok_d = np.empty(nd, dtype=bool)
        aff_d = np.empty(nd, dtype=np.int64)
        intol_d = np.empty(nd, dtype=np.int64)
        for j in range(nd):
            ns = oracle.nodes[int(dom[j])]
            node = ns.node
            nspec = node.get("spec") or {}
            taints = nspec.get("taints") or []
            ok = True
            if nspec.get("unschedulable") and not unsched_tolerated:
                ok = False
            if ok and unknown_scalar:
                ok = False
            if ok and lbl.find_untolerated_taint(taints, tolerations):
                ok = False
            if ok and not lbl.pod_matches_node_selector_and_affinity(spec, node):
                ok = False
            ok_d[j] = ok
            aff_d[j] = lbl.preferred_node_affinity_score(spec, node)
            intol_d[j] = lbl.count_intolerable_prefer_no_schedule(taints, tolerations)
        if inv is None:
            static_feasible[u_i] = ok_d
            nodeaff_raw[u_i] = aff_d
            taint_intol[u_i] = intol_d
            avoid_score[u_i] = _avoid_scores(pod, oracle)
            image_score[u_i] = _image_scores(pod, oracle)
        else:
            static_feasible[u_i] = ok_d[inv]
            nodeaff_raw[u_i] = aff_d[inv]
            taint_intol[u_i] = intol_d[inv]
            rep_states = [oracle.nodes[int(r)] for r in rep_idx]
            avoid_score[u_i] = np.asarray(
                Oracle._score_prefer_avoid_pods(oracle, pod, rep_states),
                dtype=np.int64,
            )[inv]
            image_score[u_i] = _image_scores_by_profile(
                pod, oracle, rep_idx, profile_counts
            )[inv]

        # Simon raw share (static: pod annotations never enter podReq),
        # vectorized over the node axis (plugin/simon.go:44-67 semantics)
        if simon_empty:
            simon_raw[u_i] = MAX_NODE_SCORE
        else:
            pr = np.array(
                [float(requests.get(name, Fraction(0))) for name in cluster.simon_resources],
                dtype=np.float64,
            )
            avail = cluster.simon_alloc - pr[:, None]  # [R, N]
            with np.errstate(divide="ignore", invalid="ignore"):
                share = np.where(
                    avail == 0.0,
                    (pr != 0.0).astype(np.float64)[:, None],
                    pr[:, None] / avail,
                )
            res = np.maximum(share.max(axis=0), 0.0) if len(pr) else np.zeros(n)
            simon_raw[u_i] = (MAX_NODE_SCORE * res).astype(np.int64)

    # out-of-tree custom plugins: stateless verdicts folded per class
    # (the engine-side analogue of WithFrameworkOutOfTreeRegistry)
    plugins = oracle.registry.plugins
    k = max(len(plugins), 1)
    custom_raw = np.zeros((k, u, n), dtype=np.int64)
    custom_mode = np.zeros(k, dtype=np.int32)
    custom_weight = np.zeros(k, dtype=np.int64)
    mode_ids = {"none": 0, "default": 1, "reverse": 2, "minmax": 3}
    for k_i, plugin in enumerate(plugins):
        custom_mode[k_i] = mode_ids[plugin.normalize]
        custom_weight[k_i] = plugin.weight
        for u_i, pod in enumerate(class_pods):
            for n_i, ns in enumerate(oracle.nodes):
                if not static_feasible[u_i, n_i]:
                    continue  # already ruled out; raw score is masked anyway
                if not plugin.filter(pod, ns.node):
                    static_feasible[u_i, n_i] = False
                else:
                    custom_raw[k_i, u_i, n_i] = int(plugin.score(pod, ns.node))

    with phase("encode/terms"):
        terms = build_term_tables(oracle, class_pods, profiles=(node_class_of, rep_idx))

    return PodBatch(
        p=len(pods),
        u=u,
        class_of_pod=class_of_pod,
        pinned_node=pinned,
        req_mcpu=req_mcpu,
        req_mem=req_mem,
        req_eph=req_eph,
        req_scalar=req_scalar,
        has_request=has_request,
        nz_mcpu=nz_mcpu,
        nz_mem=nz_mem,
        gpu_mem=gpu_mem,
        gpu_cnt=gpu_cnt,
        want_ports=want_ports,
        conflict_ports=conflict_ports,
        lvm_sizes=lvm_sizes,
        ssd_sizes=ssd_sizes,
        hdd_sizes=hdd_sizes,
        wants_storage=wants_storage,
        terms=terms,
        custom_raw=custom_raw,
        custom_mode=custom_mode,
        custom_weight=custom_weight,
        static_feasible=static_feasible,
        simon_raw=simon_raw,
        nodeaff_raw=nodeaff_raw,
        taint_intol=taint_intol,
        avoid_score=avoid_score,
        image_score=image_score,
        class_pods=class_pods,
    )


class ScanFeatures(NamedTuple):
    """Which optional subsystems the current batch actually exercises.

    The scan specializes to the batch: a batch with no GPU pods carries
    no GPU allocator in its step, a batch with no affinity terms carries
    no gather/scatter machinery, etc. Every gate is exactness-preserving
    — the disabled block's contribution is the identity (all-feasible /
    zero score) whenever the feature is unused, so placements are
    bit-identical to the ungated scan. The fused kernel's plan
    (ops/fused_scan.py build_plan) reads it to decide whether a batch is
    inside the kernel's base plan.
    """

    gpu: bool
    storage: bool
    ipa: bool  # inter-pod (anti-)affinity filters + score
    hard_spread: bool  # required topologySpreadConstraints
    soft_spread: bool  # ScheduleAnyway topologySpreadConstraints
    ports: bool
    scalars: bool  # extended scalar resources
    custom: bool  # out-of-tree plugin scores
    pins: bool  # any pod arrives with spec.nodeName
    # ((mode, weight), ...) per custom plugin
    custom_spec: tuple = None
    # in-tree + simulator score-plugin weights from an optional
    # KubeSchedulerConfiguration (scheduler/schedconfig.py); a
    # zero-weight plugin is skipped; None = the default profile weights
    weights: tuple = None
    # selectHost="sample": reservoir sampling over score ties with the
    # Go math/rand stream carried in the scan state
    sample: bool = False

    @property
    def terms(self) -> bool:
        """Whether per-topology target counts (state.tgt) are live."""
        return self.ipa or self.hard_spread or self.soft_spread


def features_of(static, pinned_node, weights=None,
                sample: bool = False) -> ScanFeatures:
    """Derive the feature set from a scan static: any object carrying
    the per-class arrays named below (numpy arrays or CPU tensors) —
    the same result as features_of_batch on the encodings it was built
    from."""
    def a(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    return ScanFeatures(
        sample=sample,
        weights=weights,
        gpu=bool(a(static.gpu_mem).max(initial=0) > 0),
        storage=bool(a(static.wants_storage).any()),
        ipa=bool(
            (a(static.cls_rows) >= 0).any() or (a(static.cls_group_id) >= 0).any()
        ),
        hard_spread=bool((a(static.cls_h_rows) >= 0).any()),
        soft_spread=bool((a(static.cls_s_rows) >= 0).any()),
        ports=bool(a(static.want_ports).any()),
        scalars=static.scalar_alloc.shape[0] > 0,
        custom=bool((a(static.custom_weight) != 0).any()),
        pins=bool((a(pinned_node) >= 0).any()),
        custom_spec=tuple(
            zip(
                (int(m) for m in a(static.custom_mode)),
                (int(w) for w in a(static.custom_weight)),
            )
        ),
    )


def features_of_batch(cluster: ClusterStatic, batch: PodBatch, weights=None,
                      sample: bool = False):
    """ScanFeatures from the host-side encodings — same result as
    scan.features_of(static, pinned) but without device->host transfers
    (the arrays are still numpy here). `weights` is an optional
    schedconfig.ScoreWeights overlay (static per compile); `sample`
    routes selectHost through the carried Go RNG (oracle
    select_host="sample")."""
    t = batch.terms
    return ScanFeatures(
        sample=sample,
        weights=weights,
        gpu=bool(batch.gpu_mem.max(initial=0) > 0),
        storage=bool(batch.wants_storage.any()),
        ipa=bool((t.cls_rows >= 0).any() or (t.cls_group_id >= 0).any()),
        hard_spread=bool((t.cls_h_rows >= 0).any()),
        soft_spread=bool((t.cls_s_rows >= 0).any()),
        ports=bool(batch.want_ports.any()),
        scalars=cluster.scalar_alloc.shape[0] > 0,
        custom=bool((batch.custom_weight != 0).any()),
        pins=bool((batch.pinned_node >= 0).any()),
        custom_spec=tuple(
            zip(
                (int(m) for m in batch.custom_mode),
                (int(w) for w in batch.custom_weight),
            )
        ),
    )


def _scan_tensor(x, device):
    """A host array as a scan tensor: integers int64, flags bool."""
    import torch

    x = np.asarray(x)
    if x.dtype != np.bool_ and x.dtype.kind in "iu":
        x = x.astype(np.int64)
    return torch.as_tensor(x, device=device)


def to_scan_static(cluster: ClusterStatic, batch: PodBatch, device="cpu"):
    """Assemble the torch scan's ScanStatic (ops/scan.py) on `device`
    from the host encodings: the one place its input layout is defined.
    Integers become int64 tensors, flags bool."""
    from . import scan as scan_ops

    def t(x):
        return _scan_tensor(x, device)

    n, g = cluster.n, max(cluster.g, 1)
    dev_valid = np.arange(g)[None, :] < np.asarray(cluster.gpu_count)[:, None]
    tt = batch.terms
    return scan_ops.ScanStatic(
        alloc_mcpu=t(cluster.alloc_mcpu),
        alloc_mem=t(cluster.alloc_mem),
        alloc_eph=t(cluster.alloc_eph),
        alloc_pods=t(cluster.alloc_pods),
        scalar_alloc=t(cluster.scalar_alloc),
        gpu_per_dev=t(cluster.gpu_per_dev),
        gpu_total=t(cluster.gpu_total),
        gpu_count=t(cluster.gpu_count),
        dev_valid=t(dev_valid.reshape(n, g)),
        vg_cap=t(cluster.vg_cap),
        vg_valid=t(cluster.vg_valid),
        has_storage=t(cluster.has_storage),
        ssd_cap=t(cluster.ssd_cap),
        ssd_valid=t(cluster.ssd_valid),
        hdd_cap=t(cluster.hdd_cap),
        hdd_valid=t(cluster.hdd_valid),
        static_feasible=t(batch.static_feasible),
        simon_raw=t(batch.simon_raw),
        nodeaff_raw=t(batch.nodeaff_raw),
        taint_intol=t(batch.taint_intol),
        avoid_score=t(batch.avoid_score),
        image_score=t(batch.image_score),
        req_mcpu=t(batch.req_mcpu),
        req_mem=t(batch.req_mem),
        req_eph=t(batch.req_eph),
        req_scalar=t(batch.req_scalar),
        has_request=t(batch.has_request),
        nz_mcpu=t(batch.nz_mcpu),
        nz_mem=t(batch.nz_mem),
        gpu_mem=t(batch.gpu_mem),
        gpu_cnt=t(batch.gpu_cnt),
        want_ports=t(batch.want_ports),
        conflict_ports=t(batch.conflict_ports),
        lvm_sizes=t(batch.lvm_sizes),
        ssd_sizes=t(batch.ssd_sizes),
        hdd_sizes=t(batch.hdd_sizes),
        wants_storage=t(batch.wants_storage),
        topo_val=t(tt.topo_val),
        term_match=t(tt.match),
        carry_anti_req=t(tt.carry_anti_req),
        carry_aff_pref_w=t(tt.carry_aff_pref_w),
        carry_pref_comb=t(combined_pref_carry(tt)),
        carry_anti_pref_w=t(tt.carry_anti_pref_w),
        cls_rows=t(tt.cls_rows),
        group_of_row=t(tt.group_of_row),
        match_all=t(tt.match_all),
        cls_group_rows=t(tt.cls_group_rows),
        cls_group_id=t(tt.cls_group_id),
        h_row=t(tt.h_row),
        h_self=t(tt.h_self),
        h_max_skew=t(tt.h_max_skew),
        h_cand_nodes=t(tt.h_cand_nodes),
        cls_h_rows=t(tt.cls_h_rows),
        s_row=t(tt.s_row),
        s_is_host=t(tt.s_is_host),
        s_max_skew=t(tt.s_max_skew),
        s_q=t(tt.s_q),
        cls_s_rows=t(tt.cls_s_rows),
        cls_s_haskeys=t(tt.cls_s_haskeys),
        g_topo_val=t(tt.topo_val[tt.group_rows]),
        s_topo_val=t(tt.topo_val[tt.s_row]),
        s_val_onehot=t(_soft_value_onehot(tt)),
        custom_raw=t(batch.custom_raw),
        custom_mode=t(batch.custom_mode),
        custom_weight=t(batch.custom_weight),
    )


def _soft_value_onehot(t) -> np.ndarray:
    """[Cs, Vs, N] static value one-hot for the soft-spread distinct-
    domain count (scan.py soft_score). Hostname rows stay all-zero —
    their domain count is the eligible-node count (s_is_host branch) —
    so Vs is bounded by the small non-hostname vocab, not N."""
    s_tv = t.topo_val[t.s_row]  # [Cs, N]
    if not (t.cls_s_rows >= 0).any():
        # no real soft constraint: Cs=1 is pure padding whose s_row
        # points at row 0; a hostname row 0 must not blow Vs up to N
        return np.zeros((s_tv.shape[0], 1, s_tv.shape[1]), dtype=bool)
    nonhost = ~t.s_is_host
    vs = 1
    if nonhost.any():
        mx = int(s_tv[nonhost].max(initial=-1))
        vs = max(mx + 1, 1)
    out = np.zeros((s_tv.shape[0], vs, s_tv.shape[1]), dtype=bool)
    for c_i in range(s_tv.shape[0]):
        if not nonhost[c_i]:
            continue
        vals = s_tv[c_i]
        mask = vals >= 0
        out[c_i, vals[mask], np.nonzero(mask)[0]] = True
    return out


def _value_to_node_space(init_v: np.ndarray, topo: np.ndarray) -> np.ndarray:
    """[R, V] value-space counts -> [R, N] node-space (count at each
    node's own value; 0 where the key is missing)."""
    g = np.take_along_axis(init_v, np.maximum(topo, 0).astype(np.int64), axis=1)
    return np.where(topo >= 0, g, 0)


def to_scan_state(dyn: DynamicState, batch: PodBatch, device="cpu"):
    """The torch scan's initial ScanState on `device` (term counts in
    node space); rng_hist is left None for the engine to fill."""
    from . import scan as scan_ops

    def t(x):
        return _scan_tensor(x, device)

    tt = batch.terms
    tv = tt.topo_val
    return scan_ops.ScanState(
        used_mcpu=t(dyn.used_mcpu),
        used_mem=t(dyn.used_mem),
        used_eph=t(dyn.used_eph),
        used_scalar=t(dyn.used_scalar),
        nz_mcpu=t(dyn.nz_mcpu),
        nz_mem=t(dyn.nz_mem),
        pod_cnt=t(dyn.pod_cnt),
        ports_used=t(dyn.ports_used),
        gpu_used=t(dyn.gpu_used),
        vg_used=t(dyn.vg_used),
        ssd_used=t(dyn.ssd_used),
        hdd_used=t(dyn.hdd_used),
        tgt=t(_value_to_node_space(tt.init_tgt, tv)),
        own_anti_req=t(_value_to_node_space(tt.init_own_anti_req, tv)),
        own_aff_pref_w=t(_value_to_node_space(combined_pref_init(tt), tv)),
        own_anti_pref_w=t(_value_to_node_space(tt.init_own_anti_pref_w, tv)),
        group_counts=t(_value_to_node_space(tt.init_group_counts, tv[tt.group_rows])),
        group_total=t(tt.init_group_counts.sum(axis=1)),
        soft_counts=t(_value_to_node_space(tt.init_soft_counts, tv[tt.s_row])),
    )


def _avoid_scores(pod: dict, oracle: Oracle) -> np.ndarray:
    out = np.zeros(len(oracle.nodes), dtype=np.int64)
    scores = Oracle._score_prefer_avoid_pods(oracle, pod, oracle.nodes)
    out[:] = scores
    return out


def _image_scores(pod: dict, oracle: Oracle) -> np.ndarray:
    out = np.zeros(len(oracle.nodes), dtype=np.int64)
    scores = Oracle._score_image_locality(oracle, pod, oracle.nodes)
    out[:] = scores
    return out
