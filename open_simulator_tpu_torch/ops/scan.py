"""Sequential-commit scheduling scan, eager PyTorch: the counterpart of
the JAX package's XLA scan (`open_simulator_tpu/ops/scan.py`).

It carries the batches the fused CUDA kernel (ops/fused_scan.py) does
not: out-of-tree custom score plugins and `select_host="sample"`
(reservoir sampling over score ties with the Go math/rand stream in
the scan state). The engine routes such a batch here by its features,
before anything is launched; every other batch runs on the kernel.
Every feature of the XLA scan is in, because a custom-plugin batch may
also carry GPU-share, open-local storage, inter-pod terms, hostPorts,
scalar resources or nodeName pins.

The `lax.scan` of the JAX version becomes a Python loop over the pods.
Each step is the whole scheduling cycle fused over the node axis, on
the device of the scan's tensors:

  filter  = static_feasible & NodeResourcesFit & NodePorts & GPU fit
            & Open-Local & InterPodAffinity & hard PodTopologySpread
  score   = Balanced + Least + ImageLocality + NodeAffinity'
            + PreferAvoid*10000 + TopologySpread' * 2 + TaintToleration'
            + Simon' + GpuShare' + OpenLocal' + InterPodAffinity'
            + custom'                                  (' = normalized)
  select  = first-index argmax over feasible nodes, or the Go-RNG
            reservoir walk under sample
  commit  = rank-1 state update at the placed node

Semantics are the JAX version's, bit for bit: integer arithmetic on
int64 with floor division and floor modulo (`torch.div(...,
rounding_mode="floor")`, `torch.remainder`), f64 where the XLA scan
uses f64, sums of f64 terms taken one slot after another in slot order
(never a reduction whose order could differ between the CPU and the
card), and the soft-spread log weights read from one host f64 table
(`np.log`), so the CPU and the card compute the same bits. Term counts
stay in NODE space, as in the XLA scan (entry [row, n] is the count at
node n's topology value).

Differences of form, none of meaning:
- the state is updated in place: the scan clones `init` once and each
  commit is an `index_add_` (or an OR) at the placed node;
- the per-class scalars (requests, volume sizes, GPU asks, term-row
  lists, pins, the pod and node masks) are read on the host, so a
  block whose contribution is the identity for the class at hand (no
  volume, no GPU ask, no term row, no conflicting port) is skipped
  rather than computed as zeros, and an inactive pod costs nothing;
- under sample, the check for a rejected Intn draw (the `lax.cond` on
  `any(rej0)`) is one host sync a step (`.item()`), and the rare
  rejection fixpoint (the `while_loop`) one more sync an iteration.

Every cross-node reduction of a step goes through a reduction context
(`ctx`), as in the JAX version: `_LocalCtx` here, the identity, and the
node-sharded scan's `_ShardCtx` (parallel/mesh.py), whose combines
exchange every shard's value. A block is skipped only on replicated
data (the class, the pin, the features), never on a shard's own nodes,
so every shard makes the same exchanges in the same order. Sample mode
stays on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..obs import profile
from ..scheduler.schedconfig import DEFAULT_SCORE_WEIGHTS as _DEFAULT_WEIGHTS
from .encode import features_of

MAX_SCORE = 100
INACTIVE = -2  # pod not present in this scenario (capacity-sweep masking)
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)

# sample-mode rejection-retry bound per Intn draw: Go's Int31n rejects
# values above 2^31-1 - 2^31%n (probability < n/2^31), so more than 4
# consecutive rejections has probability < 1e-17 per draw; if it ever
# happens the overflow flag trips and the engine reruns the batch on
# the serial oracle instead of diverging from the Go stream
_RNG_KMAX = 4
_MASK63 = (1 << 63) - 1
_RNG_LEN, _RNG_TAP = 607, 273

__all__ = [
    "INACTIVE",
    "MAX_SCORE",
    "ScanState",
    "ScanStatic",
    "features_of",
    "run_scan",
    "run_scan_masked",
]


class ScanStatic(NamedTuple):
    """Tensors the scan reads and never writes (static per batch), all
    on one device: integers as int64, flags as bool."""

    alloc_mcpu: torch.Tensor  # [N]
    alloc_mem: torch.Tensor
    alloc_eph: torch.Tensor
    alloc_pods: torch.Tensor
    scalar_alloc: torch.Tensor  # [S, N]
    gpu_per_dev: torch.Tensor  # [N]
    gpu_total: torch.Tensor  # [N]
    gpu_count: torch.Tensor  # [N]
    dev_valid: torch.Tensor  # [N, G] bool (device exists on node)
    # open-local storage
    vg_cap: torch.Tensor  # [N, V]
    vg_valid: torch.Tensor  # [N, V]
    has_storage: torch.Tensor  # [N] bool
    ssd_cap: torch.Tensor  # [N, Ds] ascending
    ssd_valid: torch.Tensor  # [N, Ds]
    hdd_cap: torch.Tensor  # [N, Dh] ascending
    hdd_valid: torch.Tensor  # [N, Dh]
    # per-class static matrices
    static_feasible: torch.Tensor  # [U, N]
    simon_raw: torch.Tensor  # [U, N]
    nodeaff_raw: torch.Tensor  # [U, N]
    taint_intol: torch.Tensor  # [U, N]
    avoid_score: torch.Tensor  # [U, N]
    image_score: torch.Tensor  # [U, N]
    # per-class request vectors
    req_mcpu: torch.Tensor  # [U]
    req_mem: torch.Tensor
    req_eph: torch.Tensor
    req_scalar: torch.Tensor  # [U, S]
    has_request: torch.Tensor  # [U] bool
    nz_mcpu: torch.Tensor
    nz_mem: torch.Tensor
    gpu_mem: torch.Tensor  # [U]
    gpu_cnt: torch.Tensor  # [U]
    want_ports: torch.Tensor  # [U, Pt]
    conflict_ports: torch.Tensor  # [U, Pt]
    lvm_sizes: torch.Tensor  # [U, Lv]
    ssd_sizes: torch.Tensor  # [U, Sv] ascending
    hdd_sizes: torch.Tensor  # [U, Hv] ascending
    wants_storage: torch.Tensor  # [U] bool
    # inter-pod affinity + topology spread term tables (ops/terms.py)
    topo_val: torch.Tensor  # [T, N]
    term_match: torch.Tensor  # [T, U] bool
    carry_anti_req: torch.Tensor  # [T, U]
    carry_aff_pref_w: torch.Tensor  # [T, U]
    carry_anti_pref_w: torch.Tensor  # [T, U]
    cls_rows: torch.Tensor  # [U, Rmax]
    # prefolded commit increment for the combined own-affinity state:
    # HARD_POD_AFFINITY_WEIGHT * carry_aff_req + carry_aff_pref_w
    carry_pref_comb: torch.Tensor  # [T, U]
    group_of_row: torch.Tensor  # [A]
    match_all: torch.Tensor  # [Gn, U]
    cls_group_rows: torch.Tensor  # [U, Gmax]
    cls_group_id: torch.Tensor  # [U]
    h_row: torch.Tensor  # [Ch]
    h_self: torch.Tensor  # [Ch, U]
    h_max_skew: torch.Tensor  # [Ch]
    h_cand_nodes: torch.Tensor  # [Ch, N]
    cls_h_rows: torch.Tensor  # [U, Hmax]
    s_row: torch.Tensor  # [Cs]
    s_is_host: torch.Tensor  # [Cs]
    s_max_skew: torch.Tensor  # [Cs]
    s_q: torch.Tensor  # [Cs, N]
    cls_s_rows: torch.Tensor  # [U, Smax]
    cls_s_haskeys: torch.Tensor  # [U, N]
    g_topo_val: torch.Tensor  # [A, N] = topo_val[group_rows]
    s_topo_val: torch.Tensor  # [Cs, N] = topo_val[s_row]
    # value one-hot for the soft-spread distinct-domain count; hostname
    # rows are all-zero (their domain count is the eligible-node count)
    s_val_onehot: torch.Tensor  # [Cs, Vs, N] bool
    custom_raw: torch.Tensor  # [K, U, N]
    custom_mode: torch.Tensor  # [K]
    custom_weight: torch.Tensor  # [K]


class ScanState(NamedTuple):
    """The scan carry. Term counts are in node space: entry [row, n] is
    the count at node n's topology value (nodes sharing a value share
    the count, nodes missing the key hold 0)."""

    used_mcpu: torch.Tensor  # [N]
    used_mem: torch.Tensor
    used_eph: torch.Tensor
    used_scalar: torch.Tensor  # [S, N]
    nz_mcpu: torch.Tensor
    nz_mem: torch.Tensor
    pod_cnt: torch.Tensor
    ports_used: torch.Tensor  # [N, Pt] bool
    gpu_used: torch.Tensor  # [N, G]
    vg_used: torch.Tensor  # [N, V]
    ssd_used: torch.Tensor  # [N, Ds] bool
    hdd_used: torch.Tensor  # [N, Dh] bool
    tgt: torch.Tensor  # [T, N] pods matching row selector at n's value
    own_anti_req: torch.Tensor  # [T, N] carried required anti-affinity
    # HARD_POD_AFFINITY_WEIGHT x required affinity + preferred affinity
    own_aff_pref_w: torch.Tensor  # [T, N]
    own_anti_pref_w: torch.Tensor  # [T, N] carried preferred-anti weight
    group_counts: torch.Tensor  # [A, N] all-terms-match counts per group row
    group_total: torch.Tensor  # [A] total matching pods per group row
    soft_counts: torch.Tensor  # [Cs, N] qualifying-node-restricted counts
    # sample mode: the last 607 outputs of Go's ALFG(607,273) in order
    # (gorand.GoRand.history()) as int64 bit patterns of the uint64
    # words, and a sticky flag set when a draw needs more than
    # _RNG_KMAX rejection retries; None on other batches
    rng_hist: torch.Tensor = None  # [607] int64
    rng_overflow: torch.Tensor = None  # [] bool


class _LocalCtx:
    """Node-axis reduction context of the single-device scan (the JAX
    package's ops/scan.py _LocalCtx): every cross-node combine is the
    identity (the local reduction already saw the whole axis), a gather
    is plain indexing and the select a first-max argmax. The
    node-sharded scan (parallel/mesh.py _ShardCtx) substitutes a context
    whose combines exchange every shard's value, so one step serves both
    layouts and the sharded scan cannot drift from this one."""

    def combine_max(self, x):
        return x

    def combine_min(self, x):
        return x

    def combine_sum(self, x):
        return x

    def combine_any(self, x):
        return x

    def total_nodes(self, n_local: int) -> int:
        """The node count of the whole axis (a shard's is its own)."""
        return n_local

    def gather_vec(self, vec, idx: int):
        """vec[idx] of a host vector at a GLOBAL node index."""
        return vec[idx]

    def gather_cols(self, arr, idx):
        """arr[..., idx] at a GLOBAL node index (a 0-d tensor)."""
        return arr.index_select(arr.dim() - 1, idx.view(1))[..., 0]

    def first_max_index(self, masked):
        """GLOBAL index (0-d tensor) of the first maximum."""
        return masked.argmax()

    def commit_onehot(self, node, inc):
        """The commit at a GLOBAL node as the (index [1], increment) pair
        the in-place commit takes: the JAX package's one-hot in index
        form. A shard that does not hold the node adds 0."""
        return node.view(1), inc


LOCAL_CTX = _LocalCtx()


def _fdiv(a, b):
    """Integer floor division, as jnp's `//`."""
    return torch.div(a, b, rounding_mode="floor")


def _default_normalize(raw, feasible, reverse: bool, ctx=LOCAL_CTX):
    """DefaultNormalizeScore (plugins/helper/normalize_score.go:26-53)
    over the feasible set."""
    max_count = ctx.combine_max(torch.where(feasible, raw, 0).max())
    base = torch.where(max_count > 0, _fdiv(MAX_SCORE * raw, max_count.clamp(min=1)), 0)
    if reverse:
        return torch.where(max_count > 0, MAX_SCORE - base, MAX_SCORE)
    return base


def _minmax_normalize(raw, feasible, ctx=LOCAL_CTX):
    """Simon/GpuShare/OpenLocal NormalizeScore (plugin/simon.go:75-100)
    over the feasible set; all-equal collapses to MinNodeScore=0."""
    hi = ctx.combine_max(torch.where(feasible, raw, -_I64_MAX).max())
    lo = ctx.combine_min(torch.where(feasible, raw, _I64_MAX).min())
    rng = hi - lo
    return torch.where(rng > 0, _fdiv((raw - lo) * MAX_SCORE, rng.clamp(min=1)), 0)


def _least_requested(requested, capacity):
    """leastRequestedScore (noderesources/least_allocated.go:108-117)."""
    ok = (capacity > 0) & (requested <= capacity)
    return torch.where(
        ok, _fdiv((capacity - requested) * MAX_SCORE, capacity.clamp(min=1)), 0
    )


class _Host:
    """Host copies of the static tables a step reads as scalars or index
    lists (per-class requests, volume sizes, row lists), each fetched
    once per scan at first use, so no step waits on the device for
    them."""

    def __init__(self, static: ScanStatic):
        self._static = static

    def __getattr__(self, name: str) -> np.ndarray:
        value = getattr(self._static, name).cpu().numpy()
        setattr(self, name, value)
        return value


class _Rows:
    """Index tensors on the scan's device, made once per (kind, class):
    the valid (non-negative) entries of a class's padded row list."""

    def __init__(self, host: _Host, device):
        self.host = host
        self.device = device
        self._cache = {}

    def __call__(self, kind: str, u: int) -> torch.Tensor:
        key = (kind, u)
        t = self._cache.get(key)
        if t is None:
            table = getattr(self.host, kind)
            vals = table[u][table[u] >= 0]
            t = torch.as_tensor(vals.astype(np.int64), device=self.device)
            self._cache[key] = t
        return t


def _local_storage_eval(static: ScanStatic, state: ScanState, u: int, host: _Host):
    """Open-Local filter + score + hypothetical allocation, all nodes
    at once.

    LVM (open-local common.go ProcessLVMPVCPredicate/Binpack): each
    volume in declaration order goes to the VG with the least free
    space that still fits (ties: lowest VG index). Devices
    (ProcessDevicePVC): per media type, volumes ascending meet free
    devices ascending by capacity, first fit. Score = ScoreLVM +
    ScoreDevice (common.go:660-692, 753-761) with the Binpack strategy.
    A zero-size (padding) volume changes nothing and is skipped.

    Returns (ok[N], raw_score[N], vg_take[N,V], ssd_take[N,Ds] bool,
    hdd_take[N,Dh] bool).
    """
    n, v = static.vg_cap.shape
    dev = static.vg_cap.device
    wants = bool(host.wants_storage[u])

    vg_take = torch.zeros((n, v), dtype=torch.int64, device=dev)
    lvm_ok = torch.ones(n, dtype=torch.bool, device=dev)
    for size in host.lvm_sizes[u].tolist():
        if size <= 0:
            continue
        free = static.vg_cap - state.vg_used - vg_take
        eligible = static.vg_valid & (free >= size)
        chosen = torch.where(eligible, free, _I64_MAX).argmin(dim=1)
        ok_i = eligible.any(dim=1)
        onehot = torch.nn.functional.one_hot(chosen, v) * ok_i[:, None]
        vg_take = vg_take + onehot * size
        lvm_ok = lvm_ok & ok_i

    def fit_devices(cap, valid, used, sizes):
        """First-fit of ascending sizes onto ascending-capacity free
        devices; returns (ok[N], take[N,D] bool, frac_sum[N], count)."""
        take = torch.zeros(cap.shape, dtype=torch.bool, device=dev)
        ok = torch.ones(cap.shape[0], dtype=torch.bool, device=dev)
        frac = torch.zeros(cap.shape[0], dtype=torch.float64, device=dev)
        cnt = torch.zeros(cap.shape[0], dtype=torch.int64, device=dev)
        for size in sizes.tolist():
            if size <= 0:
                continue
            eligible = valid & ~used & ~take & (cap >= size)
            ok_i = eligible.any(dim=1)
            # first eligible in ascending-capacity order
            chosen = eligible.to(torch.uint8).argmax(dim=1)
            onehot = torch.nn.functional.one_hot(chosen, cap.shape[1]).bool() & ok_i[:, None]
            take = take | onehot
            chosen_cap = cap.gather(1, chosen[:, None])[:, 0]
            frac = frac + torch.where(
                ok_i, float(size) / chosen_cap.clamp(min=1).double(), 0.0
            )
            cnt = cnt + ok_i.long()
            ok = ok & ok_i
        return ok, take, frac, cnt

    ssd_ok, ssd_take, ssd_frac, ssd_cnt = fit_devices(
        static.ssd_cap, static.ssd_valid, state.ssd_used, host.ssd_sizes[u]
    )
    hdd_ok, hdd_take, hdd_frac, hdd_cnt = fit_devices(
        static.hdd_cap, static.hdd_valid, state.hdd_used, host.hdd_sizes[u]
    )

    if wants:
        ok = static.has_storage & lvm_ok & ssd_ok & hdd_ok
    else:
        ok = torch.ones(n, dtype=torch.bool, device=dev)

    # ScoreLVM (Binpack): mean over touched VGs of used/capacity * 10,
    # the fractions summed in VG slot order
    touched = vg_take > 0
    frac_v = torch.where(touched, vg_take.double() / static.vg_cap.clamp(min=1).double(), 0.0)
    lvm_frac = torch.zeros(n, dtype=torch.float64, device=dev)
    for k in range(v):
        lvm_frac = lvm_frac + frac_v[:, k]
    lvm_cnt = touched.sum(dim=1)
    lvm_score = torch.where(
        lvm_cnt > 0, (lvm_frac / lvm_cnt.clamp(min=1) * 10).to(torch.int64), 0
    )
    # ScoreDevice: mean over ALL device units of requested/allocated * 10
    dev_cnt = ssd_cnt + hdd_cnt
    dev_score = torch.where(
        dev_cnt > 0,
        ((ssd_frac + hdd_frac) / dev_cnt.clamp(min=1) * 10).to(torch.int64),
        0,
    )
    if wants:
        raw = torch.where(static.has_storage, lvm_score + dev_score, 0)
    else:
        raw = torch.zeros(n, dtype=torch.int64, device=dev)
    return ok, raw, vg_take, ssd_take, hdd_take


def _rng_gen_words(hist, wbuf: int):
    """The history followed by the next `wbuf` (or a few more) outputs
    of the ALFG(607,273) recurrence: outputs n..n+272 depend only on
    the 607 before them (y_n = y_{n-607} + y_{n-273}), so each block of
    273 is one vector add into a preallocated buffer. The uint64 words
    are held as int64 bit patterns; the int64 add wraps modulo 2^64 as
    the uint64 add does."""
    blocks = -(-wbuf // _RNG_TAP)
    ext = torch.empty(_RNG_LEN + blocks * _RNG_TAP, dtype=torch.int64, device=hist.device)
    ext[:_RNG_LEN] = hist
    for b in range(blocks):
        o = b * _RNG_TAP
        torch.add(ext[o:o + _RNG_TAP], ext[o + _RNG_LEN - _RNG_TAP:o + _RNG_LEN],
                  out=ext[_RNG_LEN + o:_RNG_LEN + o + _RNG_TAP])
    return ext


def _sample_select(masked, feasible, rng_hist, n: int):
    """selectHost reservoir sampling (generic_scheduler.go:186-209)
    with bit-exact Go math/rand consumption, vectorised over nodes.

    The serial walk keeps a running max and, at every node TYING it,
    draws Intn(cnt) (replacing the candidate on 0). Vectorised:
    - running max = cummax; a node is an IMPROVEMENT when it strictly
      exceeds the previous prefix max, a TIE when it equals the
      current one without improving,
    - cnt at a tie = ties since the last improvement + 1,
    - the j-th tie in node order consumes the j-th Intn draw; each
      draw takes 1 + (#rejections) int31 words (Rand.Int31n's
      modulo-bias rejection loop; power-of-two n never rejects), so
      word offsets are a fixpoint of the per-draw consumption,
    - the selected node is the LAST improvement-or-winning-draw.

    The caller runs it only for a pod that draws (active, not pinned);
    a pod with no feasible node has no tie and consumes nothing.
    Returns (best index, new history, overflow flag, words consumed),
    all 0-d or [607] tensors. One host sync: whether any draw of the
    step rejects (probability ~1e-6), which takes the fixpoint branch.
    """
    dev = masked.device
    cm = torch.cummax(masked, dim=0).values
    prev = torch.cat([torch.full((1,), _I64_MIN, dtype=masked.dtype, device=dev), cm[:-1]])
    imp = feasible & (masked > prev)
    tie = feasible & ~imp & (masked == cm)
    tie_i = tie.long()
    cumt = torch.cumsum(tie_i, dim=0)
    cumt_excl = cumt - tie_i
    # ties before the current run started (cumt_excl at the last
    # improvement; cumt_excl is nondecreasing so cummax works)
    base = torch.cummax(torch.where(imp, cumt_excl, -1), dim=0).values
    cnt = torch.where(tie, cumt - base + 1, 2)
    pow2 = (cnt & (cnt - 1)) == 0
    maxv = (2**31 - 1) - torch.remainder(torch.full_like(cnt, 2**31), cnt)

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    wbuf = n + 64
    ext = _rng_gen_words(rng_hist, wbuf)
    words = ext[_RNG_LEN:_RNG_LEN + wbuf]
    w31 = (words & _MASK63) >> 32

    # fast path: resolve every draw with one gather assuming no
    # rejection, and take the fixpoint branch only when one occurred
    w0 = w31[cumt_excl.clamp(0, wbuf - 1)]
    rej0 = tie & ~pow2 & (w0 > maxv)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if bool(rej0.any()):  # host sync, once a step
        def consumption(c):
            o = torch.cumsum(c, dim=0) - c
            cc = tie_i
            lead = tie
            for k in range(_RNG_KMAX):
                w = w31[(o + k).clamp(0, wbuf - 1)]
                rej = lead & ~pow2 & (w > maxv)
                cc = cc + rej.long()
                lead = rej
            return cc, lead

        c, lead = consumption(tie_i)
        prev_c = tie_i
        overflow = lead.any()
        iters = 0
        while iters < 16 and bool((c != prev_c).any()):  # host sync an iteration
            cc, lead = consumption(c)
            prev_c, c = c, cc
            overflow = overflow | lead.any()
            iters += 1
        if iters >= 16:
            overflow = torch.ones((), dtype=torch.bool, device=dev)
        o = torch.cumsum(c, dim=0) - c
        acc = w31[(o + c - 1).clamp(0, wbuf - 1)]
    else:
        c, acc = tie_i, w0
    r = torch.where(pow2, acc & (cnt - 1), torch.remainder(acc, cnt))
    hit = tie & (r == 0)
    event = imp | hit
    best = torch.where(event, idx, -1).max()
    t_used = c.sum()
    overflow = overflow | (t_used > wbuf - _RNG_KMAX)
    # dynamic_slice clamps its start so the window stays inside
    start = t_used.clamp(max=wbuf)
    new_hist = ext[start + torch.arange(_RNG_LEN, device=dev)]
    return best, new_hist, overflow, t_used


def _terms_eval(static: ScanStatic, state: ScanState, u: int, node_valid, features,
                host: _Host, rows: _Rows, log_w, ctx=LOCAL_CTX):
    """InterPodAffinity filter + raw score and PodTopologySpread hard
    filter + soft score for pod class u over all nodes.

    Returns (ipa_ok[N] or None, spread_ok[N] or None, ipa_raw[N] or
    None, soft score fn). None stands for the identity (all feasible,
    zero score). Only the class's valid rows are read: a padding row
    contributes nothing in the XLA scan either. The soft-spread score
    depends on the feasible set, so it is returned as a closure
    evaluated after all filters are combined.
    """
    n = static.topo_val.shape[1]
    dev = static.topo_val.device
    ipa_ok = spread_ok = ipa_raw = None

    if features.ipa:
        r = rows("cls_rows", u)
        if r.numel():
            vals = static.topo_val[r]  # [R, N]
            has = vals >= 0

            # node-space state: counts at each node's own value are
            # plain row reads, no value gather
            def gather(counts_n):
                return torch.where(has, counts_n[r], 0)

            tgt_at = gather(state.tgt)
            own_anti_at = gather(state.own_anti_req)
            own_affpref_at = gather(state.own_aff_pref_w)
            own_antipref_at = gather(state.own_anti_pref_w)

            m = static.term_match[r, u]  # [R]
            c_anti = static.carry_anti_req[r, u]
            c_paff = static.carry_aff_pref_w[r, u]
            c_panti = static.carry_anti_pref_w[r, u]

            # satisfyExistingPodsAntiAffinity (filtering.go:313-326)
            fail_exist_anti = (m[:, None] & (own_anti_at > 0)).any(dim=0)
            # satisfyPodAntiAffinity (filtering.go:329-340)
            fail_own_anti = ((c_anti > 0)[:, None] & (tgt_at > 0)).any(dim=0)
            # InterPodAffinity raw score (scoring.go processExistingPod)
            ipa_raw = (
                (c_paff - c_panti)[:, None] * tgt_at
                + m.long()[:, None] * (own_affpref_at - own_antipref_at)
            ).sum(dim=0)
            ipa_ok = ~fail_own_anti & ~fail_exist_anti

        # satisfyPodAffinity (filtering.go:343-371)
        gid = int(host.cls_group_id[u])
        if gid >= 0:
            ga = rows("cls_group_rows", u)
            gvals = static.g_topo_val[ga]  # [Gm, N]
            has_g = gvals >= 0
            gc = torch.where(has_g, state.group_counts[ga], 0)
            keys_ok = has_g.all(dim=0)
            pods_exist = (gc > 0).all(dim=0)
            total_counts = state.group_total[ga].sum()
            self_ok = static.match_all[gid, u]
            bootstrap = (total_counts == 0) & self_ok
            aff_ok = keys_ok & (pods_exist | bootstrap)
            ipa_ok = aff_ok if ipa_ok is None else ipa_ok & aff_ok
        if ipa_raw is None:
            ipa_raw = torch.zeros(n, dtype=torch.int64, device=dev)

    if features.hard_spread:
        # hard topology spread (filtering.go:276-337): node-space counts
        # make the per-value min a plain min over candidate nodes
        h = rows("cls_h_rows", u)
        if h.numel():
            hrow = static.h_row[h]
            hvals = static.topo_val[hrow]  # [Hm, N]
            cand_nodes = static.h_cand_nodes[h] & node_valid[None, :]
            counts_h = state.tgt[hrow]  # [Hm, N]
            minc = ctx.combine_min(
                torch.where(cand_nodes, counts_h, _I64_MAX).min(dim=1).values)
            minc = torch.where(ctx.combine_any(cand_nodes.any(dim=1)), minc, 0)
            pair_in = cand_nodes & (hvals >= 0)
            cnt_eff = torch.where(pair_in, counts_h, 0)
            selfm = static.h_self[h, u]
            skew = cnt_eff + selfm[:, None] - minc[:, None]
            ok_c = (skew <= static.h_max_skew[h][:, None]) & (hvals >= 0)
            spread_ok = ok_c.all(dim=0)

    s_slots = host.cls_s_rows[u]
    s_slots = s_slots[s_slots >= 0].tolist()
    if not features.soft_spread or not s_slots:
        # NormalizeScore's no-constraint branch: MaxNodeScore everywhere
        return ipa_ok, spread_ok, ipa_raw, None

    # ---- soft topology spread score (scoring.go) -------------------------
    def soft_score(feasible_final):
        has_keys = static.cls_s_haskeys[u]  # [N]
        eligible = feasible_final & has_keys
        score_f = torch.zeros(n, dtype=torch.float64, device=dev)
        for s in s_slots:
            srow = int(host.s_row[s])
            svals = static.topo_val[srow]
            if host.s_is_host[s]:
                # hostname rows: the domain count is the eligible-node count
                sz = ctx.combine_sum(eligible.sum())
                cnt = state.tgt[srow]
            else:
                # distinct eligible topology values through the static
                # value one-hot [Vs, N]
                sz = ctx.combine_any(
                    (static.s_val_onehot[s] & eligible[None, :]).any(dim=1)).sum()
                cnt = state.soft_counts[s]
            cnt = cnt * (svals >= 0)
            weight = log_w[sz]  # np.log(sz + 2.0), one host table
            score_f = score_f + (cnt * weight + float(int(host.s_max_skew[s]) - 1))
        raw = score_f.to(torch.int64)
        any_valid = ctx.combine_any(eligible.any())
        mx = ctx.combine_max(torch.where(eligible, raw, -_I64_MAX).max())
        mn = ctx.combine_min(torch.where(eligible, raw, _I64_MAX).min())
        normalized = torch.where(
            mx == 0, MAX_SCORE, _fdiv(MAX_SCORE * (mx + mn - raw), mx.clamp(min=1))
        )
        out = torch.where(eligible, normalized, 0)
        return torch.where(any_valid, out, 0)

    return ipa_ok, spread_ok, ipa_raw, soft_score


def _terms_commit(static: ScanStatic, state: ScanState, u: int, node, inc, features,
                  ctx=LOCAL_CTX):
    """Rank-1 count updates after a commit (AddPod semantics), in place.

    Node-space form: incrementing the count at the placed value means
    incrementing every node sharing that value, a masked broadcast
    `(topo_val == placed value) * inc` over the [T, N] table. `node` is
    the placed node (0-d GLOBAL index, clamped at 0) and `inc` 1 or 0
    (committed or not); rows the class does not touch carry a zero
    increment. The placed node's values come from the shard holding it
    (ctx.gather_cols); every shard then updates its own nodes."""
    if features.terms:
        val_at = ctx.gather_cols(static.topo_val, node)  # [T]
        eqi = ((static.topo_val == val_at[:, None]) & (val_at >= 0)[:, None]).long()
        state.tgt.add_((static.term_match[:, u].long() * inc)[:, None] * eqi)

    if features.ipa:
        state.own_anti_req.add_((static.carry_anti_req[:, u] * inc)[:, None] * eqi)
        state.own_aff_pref_w.add_((static.carry_pref_comb[:, u] * inc)[:, None] * eqi)
        state.own_anti_pref_w.add_((static.carry_anti_pref_w[:, u] * inc)[:, None] * eqi)

        g_val = ctx.gather_cols(static.g_topo_val, node)  # [A]
        g_ok = g_val >= 0
        g_eq = (static.g_topo_val == g_val[:, None]) & g_ok[:, None]
        g_match = static.match_all[:, u][static.group_of_row]  # [A]
        g_inc = (g_match & g_ok).long() * inc
        state.group_counts.add_(g_inc[:, None] * g_eq.long())
        state.group_total.add_(g_inc)

    if features.soft_spread:
        # soft spread counts restricted to qualifying PLACED nodes (s_q
        # gates who counts, not who reads)
        s_val = ctx.gather_cols(static.s_topo_val, node)  # [Cs]
        s_ok = (s_val >= 0) & ctx.gather_cols(static.s_q, node)
        s_eq = (static.s_topo_val == s_val[:, None]) & s_ok[:, None]
        s_match = static.term_match[:, u][static.s_row]  # [Cs]
        s_inc = (s_match & s_ok).long() * inc
        state.soft_counts.add_(s_inc[:, None] * s_eq.long())


def _gpu_allocate(avail, dev_valid, per_gpu_mem: int, count: int):
    """AllocateGpuId vectorised (open-gpu-share gpunodeinfo.go:232-291).

    Returns (found[N], take[N, G]): take = per-device number of GPU
    shares allocated. Single-GPU: tightest fit (min idle that fits,
    first index on ties). Multi-GPU: two-pointer greedy in device order,
    a device may host several shares.
    """
    if count == 1:
        fits = dev_valid & (avail >= per_gpu_mem)  # [N, G]
        best = torch.where(fits, avail, _I64_MAX).argmin(dim=1)  # first on ties
        found = fits.any(dim=1)
        take = torch.nn.functional.one_hot(best, avail.shape[1]) * found[:, None].long()
        return found, take
    # multi: capacity in units of per_gpu_mem per device, greedy prefix
    cap = torch.where(dev_valid, _fdiv(avail, max(per_gpu_mem, 1)), 0).clamp(min=0)
    prefix = torch.cumsum(cap, dim=1) - cap  # exclusive prefix
    take = torch.minimum((count - prefix).clamp(min=0), cap)
    found = cap.sum(dim=1) >= count
    return found, take


def _score(static: ScanStatic, state: ScanState, u: int, feasible, features, w,
           custom_spec, host: _Host, ipa_raw, soft_score, local_raw, ctx=LOCAL_CTX):
    """The weighted sum of every score plugin for pod class u over all
    nodes (int64); the normalisations run over the feasible set."""
    n = static.alloc_mcpu.shape[0]
    dev = static.alloc_mcpu.device
    total = torch.zeros(n, dtype=torch.int64, device=dev)
    cpu_req_total = state.nz_mcpu + int(host.nz_mcpu[u])
    mem_req_total = state.nz_mem + int(host.nz_mem[u])
    if w.least:
        least = _fdiv(
            _least_requested(cpu_req_total, static.alloc_mcpu)
            + _least_requested(mem_req_total, static.alloc_mem), 2
        )
        total = total + least * w.least
    if w.balanced:
        cpu_frac = torch.where(static.alloc_mcpu > 0, cpu_req_total.double()
                               / static.alloc_mcpu.clamp(min=1).double(), 1.0)
        mem_frac = torch.where(static.alloc_mem > 0, mem_req_total.double()
                               / static.alloc_mem.clamp(min=1).double(), 1.0)
        balanced = torch.where(
            (cpu_frac >= 1) | (mem_frac >= 1),
            0,
            ((1 - (cpu_frac - mem_frac).abs()) * MAX_SCORE).to(torch.int64),
        )
        total = total + balanced * w.balanced
    if w.nodeaff:
        total = total + _default_normalize(
            static.nodeaff_raw[u], feasible, reverse=False, ctx=ctx) * w.nodeaff
    if w.tainttol:
        total = total + _default_normalize(
            static.taint_intol[u], feasible, reverse=True, ctx=ctx) * w.tainttol
    if w.simon or w.gpushare:
        # Simon and Open-Gpu-Share share one formula (simon.go:44-67)
        total = total + _minmax_normalize(static.simon_raw[u], feasible, ctx) * (
            w.simon + w.gpushare)
    if w.spread:
        # PodTopologySpread soft score (MaxNodeScore everywhere when
        # the pod has no soft constraint)
        spread = MAX_SCORE if soft_score is None else soft_score(feasible)
        total = total + spread * w.spread
    if w.image:
        total = total + static.image_score[u] * w.image
    if w.avoid:
        total = total + static.avoid_score[u] * w.avoid
    if features.ipa and w.ipa:
        # InterPodAffinity NormalizeScore (scoring.go:246-270): bounds
        # include 0, float divide, int64 truncation
        ipa_mx = ctx.combine_max(torch.where(feasible, ipa_raw, 0).max()).clamp(min=0)
        ipa_mn = ctx.combine_min(torch.where(feasible, ipa_raw, 0).min()).clamp(max=0)
        ipa_diff = (ipa_mx - ipa_mn).double()
        ipa = torch.where(
            ipa_diff > 0,
            ((MAX_SCORE * (ipa_raw - ipa_mn)).double() / ipa_diff.clamp(min=1.0)).to(
                torch.int64),
            0,
        )
        total = total + ipa * w.ipa
    if features.storage and w.openlocal:
        total = total + _minmax_normalize(local_raw, feasible, ctx) * w.openlocal
    if features.custom:
        # out-of-tree custom plugins: 0 none, 1 default, 2 reverse,
        # 3 min-max
        for k_i, (mode_k, weight_k) in enumerate(custom_spec):
            if weight_k == 0:
                continue
            raw_k = static.custom_raw[k_i, u]
            if mode_k == 0:
                score_k = raw_k
            elif mode_k == 1:
                score_k = _default_normalize(raw_k, feasible, reverse=False, ctx=ctx)
            elif mode_k == 2:
                score_k = _default_normalize(raw_k, feasible, reverse=True, ctx=ctx)
            else:
                score_k = _minmax_normalize(raw_k, feasible, ctx)
            total = total + score_k * weight_k
    return total


def _clone_state(init: ScanState) -> ScanState:
    return ScanState(*(None if t is None else t.clone() for t in init))


def run_scan(static: ScanStatic, init: ScanState, class_of_pod, pinned_node,
             features=None, weights=None):
    """Schedule every pod in order; returns (placements[P], final state).

    placements[p] = node index, or -1 when unschedulable. With
    features.sample the first element is a (placements[P],
    consumed_words[P]) pair: per-pod Go-RNG consumption, which the
    engine uses to rewind the stream to an escape point
    (engine.rewind_sample_rng).
    """
    n = static.alloc_mcpu.shape[0]
    p = len(class_of_pod)
    return run_scan_masked(static, init, class_of_pod, pinned_node,
                           np.ones(n, bool), np.ones(p, bool),
                           features=features, weights=weights)


def _host_array(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=dtype)


def run_scan_masked(static: ScanStatic, init: ScanState, class_of_pod, pinned_node,
                    node_valid, pod_active, features=None, weights=None, site: str = "scan",
                    ctx=None):
    """The masked scan below, as one instrumented dispatch at `site`
    (obs/profile.py): counted, its device time taken by CUDA events
    around the whole eager loop on the card."""
    with profile.launch(site, static.alloc_mcpu.device) as ln:
        ln.start()
        out = _run_scan_masked(static, init, class_of_pod, pinned_node, node_valid,
                               pod_active, features=features, weights=weights, ctx=ctx)
        ln.stop()
    return out


def _run_scan_masked(static: ScanStatic, init: ScanState, class_of_pod, pinned_node,
                     node_valid, pod_active, features=None, weights=None, ctx=None):
    """run_scan with scenario masks: `node_valid[n]` gates candidate
    nodes, `pod_active[p]` skips pods that do not exist in this
    scenario. An inactive pod commits nothing, consumes no Go-RNG word
    and reports INACTIVE (the escape rewind of the priority-scan engine
    relies on that).

    `features` (a ScanFeatures) selects the blocks the step runs; None
    derives it from `static`/`pinned_node`. `weights` (score weights)
    only applies when `features` is derived here; passing both is a
    caller bug. The masks and the per-pod arrays may be numpy arrays or
    tensors; the scan runs on the device of `static`, and `init` is
    cloned there, so the caller's state is not changed.

    With features.sample the returned placements are a (placements,
    consumed_words) pair and init.rng_hist must carry the GoRand
    607-output history (int64 bit patterns).

    `ctx` is the node-axis reduction context (None: the single-device
    `LOCAL_CTX`). Under parallel/mesh.py's `_ShardCtx`, `static`,
    `init` and `node_valid` are one shard's node slice, while the pins
    stay GLOBAL node indices and the placements come out global.
    """
    if ctx is None:
        ctx = LOCAL_CTX
    if features is not None and weights is not None:
        raise ValueError(
            "pass weights inside features (features_of_batch(..., weights=)) "
            "or alone, not both"
        )
    if features is None:
        features = features_of(static, _host_array(pinned_node, np.int64), weights=weights)
    if features.sample and init.rng_hist is None:
        raise ValueError(
            "features.sample needs init.rng_hist (the GoRand 607-output "
            "history; gorand.GoRand.history())"
        )
    dev = static.alloc_mcpu.device
    n = static.alloc_mcpu.shape[0]
    cls_h = _host_array(class_of_pod, np.int64)
    pin_h = _host_array(pinned_node, np.int64)
    active_h = _host_array(pod_active, bool)
    valid_h = _host_array(node_valid, bool)
    p = cls_h.shape[0]
    node_valid = torch.as_tensor(valid_h, device=dev)

    host = _Host(static)
    rows = _Rows(host, dev)
    state = _clone_state(init)
    if features.sample and state.rng_overflow is None:
        state = state._replace(rng_overflow=torch.zeros((), dtype=torch.bool, device=dev))
    # log(k + 2) for every domain count k a soft constraint can see
    log_w = torch.as_tensor(
        np.log(np.arange(max(ctx.total_nodes(n), static.s_val_onehot.shape[1]) + 1,
                         dtype=np.float64) + 2.0),
        device=dev,
    )
    w = features.weights if features.weights is not None else _DEFAULT_WEIGHTS
    custom_spec = features.custom_spec
    if features.custom and custom_spec is None:
        custom_spec = tuple(zip(static.custom_mode.tolist(), static.custom_weight.tolist()))

    placements = torch.full((p,), INACTIVE, dtype=torch.int64, device=dev)
    consumed = torch.zeros(p, dtype=torch.int64, device=dev) if features.sample else None
    one = torch.ones((), dtype=torch.int64, device=dev)

    for i in range(p):
        if not active_h[i]:
            continue
        u = int(cls_h[i])
        pin = int(pin_h[i]) if features.pins else -1
        if pin >= 0 and not ctx.gather_vec(valid_h, pin):
            # a pod pinned to a masked-out node does not exist in this
            # scenario; never commit resources outside node_valid
            continue
        # the hypothetical allocations the commit charges (a pinned pod
        # is charged them at its node too)
        gpu_mem_u = int(host.gpu_mem[u]) if features.gpu else 0
        if gpu_mem_u > 0:
            avail = static.gpu_per_dev[:, None] - state.gpu_used
            gpu_found, gpu_take = _gpu_allocate(
                avail, static.dev_valid, gpu_mem_u, int(host.gpu_cnt[u])
            )
        if features.storage:
            local_ok, local_raw, vg_take, ssd_take, hdd_take = _local_storage_eval(
                static, state, u, host
            )

        if pin >= 0:
            # pinned pods never run filter, score or selectHost (and
            # draw no Go-RNG word)
            node = torch.full((), pin, dtype=torch.int64, device=dev)
            placements[i] = pin
            inc = one
        else:
            feasible = static.static_feasible[u] & node_valid
            # NodeResourcesFit (noderesources/fit.go:230-303)
            fit = state.pod_cnt + 1 <= static.alloc_pods
            if host.has_request[u]:
                # zero-request pods skip everything but the pod-count check
                fit_res = (
                    (static.alloc_mcpu >= int(host.req_mcpu[u]) + state.used_mcpu)
                    & (static.alloc_mem >= int(host.req_mem[u]) + state.used_mem)
                    & (static.alloc_eph >= int(host.req_eph[u]) + state.used_eph)
                )
                if features.scalars:
                    fit_res = fit_res & (
                        static.scalar_alloc >= static.req_scalar[u][:, None] + state.used_scalar
                    ).all(dim=0)
                fit = fit & fit_res
            feasible = feasible & fit
            # NodePorts
            if features.ports and host.conflict_ports[u].any():
                clash = (state.ports_used & static.conflict_ports[u][None, :]).any(dim=1)
                feasible = feasible & ~clash
            # GPU share, Open-Local
            if gpu_mem_u > 0:
                feasible = feasible & (static.gpu_total >= gpu_mem_u) & gpu_found
            if features.storage:
                feasible = feasible & local_ok
            # InterPodAffinity + PodTopologySpread
            ipa_ok, spread_ok, ipa_raw, soft_score = _terms_eval(
                static, state, u, node_valid, features, host, rows, log_w, ctx
            )
            if ipa_ok is not None:
                feasible = feasible & ipa_ok
            if spread_ok is not None:
                feasible = feasible & spread_ok
            total = _score(static, state, u, feasible, features, w, custom_spec, host,
                           ipa_raw, soft_score, local_raw if features.storage else None,
                           ctx)

            # select: first max over feasible, or the reservoir walk
            masked = torch.where(feasible, total, _I64_MIN)
            found = ctx.combine_any(feasible.any())
            if features.sample:
                best, new_hist, step_ovf, used = _sample_select(
                    masked, feasible, state.rng_hist, n
                )
                state.rng_hist.copy_(new_hist)
                state.rng_overflow.logical_or_(step_ovf)
                consumed[i] = used
            else:
                best = ctx.first_max_index(masked)
            placement = torch.where(found, best, -1)
            placements[i] = placement
            node = placement.clamp(min=0)
            inc = found.long()

        # ---- commit at the placed node, in place (adds 0 when the pod
        # found no node, or on a shard that does not hold it) ----
        idx, inc_at = ctx.commit_onehot(node, inc)
        for row, val in ((state.used_mcpu, host.req_mcpu[u]), (state.used_mem, host.req_mem[u]),
                         (state.used_eph, host.req_eph[u]), (state.nz_mcpu, host.nz_mcpu[u]),
                         (state.nz_mem, host.nz_mem[u]), (state.pod_cnt, 1)):
            if val:
                row.index_add_(0, idx, (inc_at * int(val)).view(1))
        if features.scalars:
            state.used_scalar.index_add_(1, idx, (static.req_scalar[u] * inc_at)[:, None])
        if features.ports:
            state.ports_used[idx] |= static.want_ports[u][None, :] & (inc_at > 0)
        if gpu_mem_u > 0:
            state.gpu_used.index_add_(0, idx, gpu_take[idx] * (gpu_mem_u * inc_at))
        if features.storage:
            state.vg_used.index_add_(0, idx, vg_take[idx] * inc_at)
            state.ssd_used[idx] |= ssd_take[idx] & (inc_at > 0)
            state.hdd_used[idx] |= hdd_take[idx] & (inc_at > 0)
        _terms_commit(static, state, u, node, inc, features, ctx)

    if features.sample:
        return (placements, consumed), state
    return placements, state
