"""Fused sequential-commit scheduling scan: the GPU counterpart of the
JAX package's ops/pallas_scan.py.

One CUDA kernel (csrc/fused_scan.cu) runs the whole pod loop on the
card: per pod, filter (NodeResourcesFit on cpu/memory/ephemeral with
the zero-request gate, pod count, the class's static feasible row, the
scenario's node mask), score (LeastAllocated, BalancedAllocation in
f64, Simon min-max, NodeAffinity and TaintToleration normalised over
the feasible nodes, the prefolded ImageLocality / NodePreferAvoidPods
row), first-max select with ties to the lowest node index, nodeName
pins, INACTIVE pods, and the commit of the per-node states. Three
launch shapes, counted apart:

- `fused_scan_base`: one scenario, base plan;
- `fused_scan_ext`: one scenario with any of the scalar-resource,
  hostPort and GPU-share blocks (compile-time flags of the same
  kernel), which extend the fit and the commit;
- `fused_scan_batch`: several (active, valid, pinned) scenarios of one
  plan in one launch, one block per scenario, with the same flags.

The semantics are those of the JAX package's XLA scan (ops/scan.py),
which is conformance-tested against the serial oracle; the TPU kernel's
layout is not copied: state and class tables are int64 in true units
over the unpadded node axis, with no GCD scaling, no (R, 128) tiles, no
class-row dedup and no cap on scalar kinds, GPUs per node or ports.

Kernel note. It replaces `pallas_scan._make_kernel` (the `pl.pallas_call`
in `run_scan_pallas`) and `run_scan_pallas_batch`. On an H100 it is
bound by its serial chain: P pod steps, each depending on the previous
step's commit, each two block-wide barriers around two passes over the
node axis that read about 110 bytes of state and class rows per node
from L2. The design keeps the whole loop inside one launch of one
1024-thread block per scenario, gives every node one owner thread (so
the commit needs no barrier), and reduces with warp shuffles and one
shared-memory exchange per reduction; see the source for the details.

`fused_scan_batch_reference` is the plain PyTorch version of the same
function: an eager loop over the pods, one step vectorised over the
[scenario, node] axes each; `fused_scan_reference` is its one-scenario
case. The wrappers take the plain version for a plan on the CPU and
launch the kernel for a plan on a CUDA device; there is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Optional

import numpy as np
import torch

MAX_SCORE = 100
INACTIVE = -2
KERNEL_NAME = "fused_scan_base"
EXT_KERNEL_NAME = "fused_scan_ext"
BATCH_KERNEL_NAME = "fused_scan_batch"
STATE_FIELDS = ("used_mcpu", "used_mem", "used_eph", "nz_mcpu", "nz_mem", "pod_cnt")

# launches per kernel, counted where the wrapper launches it and
# nowhere else (chip_smoke.py reads them around each path)
LAUNCHES = {KERNEL_NAME: 0, EXT_KERNEL_NAME: 0, BATCH_KERNEL_NAME: 0}

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_scan.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_LIB = None


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


# (ScanFeatures flag, what it is, ROADMAP.md item that ports it)
_OUT_OF_SLICE = (
    ("custom", "out-of-tree custom score plugins", "A2"),
    ("sample", 'select_host="sample"', "A2"),
    ("storage", "open-local storage", "B3"),
    ("ipa", "inter-pod affinity terms", "B4"),
    ("hard_spread", "hard topology-spread terms", "B4"),
    ("soft_spread", "soft topology-spread terms", "B4"),
)


def check_in_slice(features) -> None:
    """Raise OutOfSliceError when the batch needs a block the kernel
    does not have yet."""
    for flag, what, item in _OUT_OF_SLICE:
        if getattr(features, flag, False):
            raise OutOfSliceError(what, item)


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
    """The kernel's inputs for one batch, int64 in true units. The
    scalar, GPU and port rows are None when the batch does not use the
    block."""

    n: int
    u: int
    alloc: torch.Tensor  # [4, N] mcpu, mem, eph, pods
    init: torch.Tensor  # [6, N] state rows in STATE_FIELDS order
    cls_req: torch.Tensor  # [U, 6] req mcpu/mem/eph, nz mcpu/mem, has_request
    feasible: torch.Tensor  # [U, N] bool static feasibility
    cls_tab: torch.Tensor  # [4, U, N] simon, nodeaff, taint, prefolded base
    # (least, balanced, simon + gpushare, nodeaff, tainttol)
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
    def ext(self) -> bool:
        """Whether any of the B2 blocks is on."""
        return self.has_scal or self.has_gpu or self.has_ports

    def to(self, device) -> "FusedPlan":
        moved = {}
        for f in fields(self):
            v = getattr(self, f.name)
            moved[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return FusedPlan(**moved)


def _weights(w) -> tuple:
    return (int(w.least), int(w.balanced), int(w.simon) + int(w.gpushare),
            int(w.nodeaff), int(w.tainttol))


def pack_port_words(mask_tn: np.ndarray) -> np.ndarray:
    """(T, N) bool -> (max(ceil(T/32), 1), N) int32 words, row t at bit
    t & 31 of word t >> 5."""
    mask_tn = np.asarray(mask_tn, dtype=bool)
    t_rows, n_cols = mask_tn.shape
    words = np.zeros((max(-(-t_rows // 32), 1), n_cols), dtype=np.uint32)
    for t in range(t_rows):
        words[t >> 5] |= mask_tn[t].astype(np.uint32) << np.uint32(t & 31)
    return words.view(np.int32)


def build_plan(cluster, batch, dyn, features, device="cpu") -> FusedPlan:
    """The kernel plan from the numpy ClusterStatic + PodBatch +
    DynamicState (ops/encode.py). Raises OutOfSliceError for a batch
    that needs a block the kernel does not have."""
    from ..scheduler.schedconfig import DEFAULT_SCORE_WEIGHTS, ScoreWeights

    check_in_slice(features)
    w = features.weights
    w = DEFAULT_SCORE_WEIGHTS if w is None else ScoreWeights(*w)
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
    n = int(cluster.n)
    u = int(a(batch.req_mcpu).shape[0])
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
    return FusedPlan(
        n=n, u=u, weights=_weights(w),
        has_pins=bool(features.pins),
        **{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in arrays.items()},
    )


def plan_from_jax_arrays(jplan, device="cpu") -> FusedPlan:
    """The port's plan from the numpy arrays of a JAX package
    PallasPlan (any object with its fields): un-pad the (R, 128) node
    tiles, expand the class-row dedup map, multiply the GCD-scaled
    memory and ephemeral quantities back into true units, and unpack
    the scalar, GPU and port rows. The PallasPlan keeps no scale for
    the scalar kinds and GPU memory, so those rows stay in its per-kind
    GCD units; the fit, device choice and commit are linear in them,
    so placements are unchanged."""
    for field, what, item in (
        ("terms", "inter-pod affinity / topology-spread terms", "B4"),
        ("store", "open-local storage", "B3"),
    ):
        if getattr(jplan, field, None) is not None:
            raise OutOfSliceError(what, item)
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
    w = tuple(jplan.w)
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
    return FusedPlan(
        n=n, u=u, weights=(w[0], w[1], w[2], w[3], w[4]),
        has_pins=bool(jplan.has_pins),
        **{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in arrays.items()},
    )


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
    return (
        torch.from_numpy(cls.astype(np.int32)).to(dev),
        torch.from_numpy(np.stack(acts).astype(np.uint8)).to(dev),
        torch.from_numpy(np.stack(vals).astype(np.uint8)).to(dev),
        torch.from_numpy(np.stack(pins).astype(np.int32)).to(dev),
    )


def _final(plan: FusedPlan, state, scal, gpu, ports) -> dict:
    """One scenario's final state: the six base rows, plus
    `used_scalar` [K, N], `gpu_used` [G, N] and `ports_used` [W, N]
    (words) for the blocks the plan has."""
    out = {name: state[k] for k, name in enumerate(STATE_FIELDS)}
    if plan.has_scal:
        out["used_scalar"] = scal
    if plan.has_gpu:
        out["gpu_used"] = gpu
    if plan.has_ports:
        out["ports_used"] = ports
    return out


def fused_scan_batch_reference(plan: FusedPlan, class_of_pod, scenarios):
    """The plain PyTorch version of the batch: an eager loop over the
    pods, one step vectorised over the [scenario, node] axes each.
    `scenarios` is a list of (active[P], valid[N], pinned[P] or None).
    Returns [(placements[P] int32, final state dict), ...]. It repeats
    the kernel's arithmetic and is no yardstick of speed."""
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
    scan_any = scanned.any(axis=0)
    reqs = plan.cls_req.cpu().tolist()
    w_least, w_bal, w_simon, w_na, w_tt = plan.weights
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
    host_place_t = out.clone()
    scan_rows = torch.from_numpy(scanned).to(dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(p):
        u = cls[i]
        rc, rm, re, nzc, nzm, has_req = reqs[u]
        if not (host_place[:, i] >= 0).any() and not scan_any[i]:
            continue  # inactive everywhere
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
                raw = plan.cls_tab[0, u][None, :]
                hi = torch.where(feas, raw, -big).amax(dim=1, keepdim=True)
                lo = torch.where(feas, raw, big).amin(dim=1, keepdim=True)
                rng = hi - lo
                total += torch.where(
                    rng > 0, (raw - lo) * MAX_SCORE // rng.clamp(min=1), zero
                ) * w_simon
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
            masked = torch.where(feas, total, torch.iinfo(torch.int64).min)
            chosen = torch.where(feas.any(dim=1), masked.argmax(dim=1), -1)
            place = torch.where(scan_rows[:, i], chosen, host_place_t[:, i].long())
            out[:, i] = place.int()
        else:
            place = host_place_t[:, i].long()
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
    return [
        (out[s], _final(plan, state[s], None if scal is None else scal[s],
                        None if gpu is None else gpu[s],
                        None if ports is None else ports[s]))
        for s in range(s_n)
    ]


def fused_scan_reference(plan: FusedPlan, class_of_pod, active, valid, pinned=None):
    """The plain PyTorch version of one scan: the batch reference with
    one scenario. Returns (placements[P] int32, final state dict)."""
    return fused_scan_batch_reference(plan, class_of_pod, [(active, valid, pinned)])[0]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_library() -> Path:
    """Compile csrc/fused_scan.cu for sm_90a into build/torch_kernels/,
    keyed by a hash of the source, unless that library exists. Returns
    its path. The compiler's register and spill report is kept beside
    it (`.log`)."""
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _BUILD_DIR / f"fused_scan_{key}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = res.stdout + res.stderr
    lib.with_suffix(".log").write_text(log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib


# length of the int64 argument vector of fused_scan_launch (the
# kArg* enum of csrc/fused_scan.cu); checked against the library
_N_ARGS = 36


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.fused_scan_arg_count.argtypes = []
        lib.fused_scan_arg_count.restype = ctypes.c_int64
        if lib.fused_scan_arg_count() != _N_ARGS:
            raise RuntimeError(
                f"fused_scan library takes {lib.fused_scan_arg_count()} "
                f"arguments, the wrapper passes {_N_ARGS}"
            )
        lib.fused_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.fused_scan_launch.restype = ctypes.c_int
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


def _launch(plan: FusedPlan, cls_t, act_t, val_t, pin_t, batch: bool) -> list:
    """Launch the kernel over the scenarios of the [S, ...] inputs: one
    block per scenario when `batch`, else one block (S == 1). Counts the
    launch under its kernel's name."""
    dev = plan.device
    n, u, p = plan.n, plan.u, cls_t.shape[0]
    s_n = act_t.shape[0]
    k = plan.scal_alloc.shape[0] if plan.has_scal else 0
    g = plan.gpu_init.shape[0] if plan.has_gpu else 0
    w = plan.port_init.shape[0] if plan.has_ports else 0
    checks = [
        (plan.alloc, "alloc", torch.int64, (4, n)),
        (plan.init, "init", torch.int64, (6, n)),
        (plan.cls_req, "cls_req", torch.int64, (u, 6)),
        (plan.feasible, "feasible", torch.bool, (u, n)),
        (plan.cls_tab, "cls_tab", torch.int64, (4, u, n)),
    ]
    if plan.has_scal:
        checks += [(plan.scal_alloc, "scal_alloc", torch.int64, (k, n)),
                   (plan.scal_init, "scal_init", torch.int64, (k, n)),
                   (plan.scal_req, "scal_req", torch.int64, (u, k))]
    if plan.has_gpu:
        checks += [(plan.gpu_node, "gpu_node", torch.int64, (3, n)),
                   (plan.gpu_init, "gpu_init", torch.int64, (g, n)),
                   (plan.gpu_cls, "gpu_cls", torch.int64, (u, 2))]
    if plan.has_ports:
        checks += [(plan.port_init, "port_init", torch.int32, (w, n)),
                   (plan.port_cls, "port_cls", torch.int32, (2, u, w))]
    for t, name, dtype, shape in checks:
        _check(t, name, dtype, shape, dev)

    def empty(shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device=dev)

    state = empty((s_n, 6, n))
    scal = empty((s_n, k, n)) if plan.has_scal else None
    gpu = empty((s_n, g, n)) if plan.has_gpu else None
    ports = empty((s_n, w, n), torch.int32) if plan.has_ports else None
    placements = empty((s_n, p), torch.int32)
    if p == 0:
        state.copy_(plan.init.expand(s_n, 6, n))
        for out, init in ((scal, plan.scal_init), (gpu, plan.gpu_init),
                          (ports, plan.port_init)):
            if out is not None:
                out.copy_(init.expand_as(out))
    else:
        partial = empty((s_n, max(n, 1)))

        def ptr(t):
            return 0 if t is None else t.data_ptr()

        flags = ((8 if batch else 0) | (4 if plan.has_scal else 0)
                 | (2 if plan.has_gpu else 0) | (1 if plan.has_ports else 0))
        args = [ptr(t) for t in (
            plan.alloc, plan.init, plan.feasible, plan.cls_tab, plan.cls_req, cls_t,
            plan.scal_alloc, plan.scal_init, plan.scal_req,
            plan.gpu_node, plan.gpu_init, plan.gpu_cls,
            plan.port_init, plan.port_cls,
            act_t, pin_t, val_t, state, scal, gpu, ports, partial, placements,
        )] + [n, u, p, k, g, w, *plan.weights, s_n, flags]
        assert len(args) == _N_ARGS
        argv = (ctypes.c_int64 * _N_ARGS)(*args)
        # the kernel runs after this returns; tensors freed here go back
        # to the caching allocator on this stream, which orders any
        # reuse after the kernel
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _library().fused_scan_launch(argv, _N_ARGS, stream)
        name = (BATCH_KERNEL_NAME if batch
                else EXT_KERNEL_NAME if plan.ext else KERNEL_NAME)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        LAUNCHES[name] += 1
    return [
        (placements[s], _final(plan, state[s], None if scal is None else scal[s],
                               None if gpu is None else gpu[s],
                               None if ports is None else ports[s]))
        for s in range(s_n)
    ]


def _device_of(plan: FusedPlan) -> str:
    dev = plan.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused scan for device {dev}")
    return dev.type


def run_fused_scan(plan: FusedPlan, class_of_pod, active, valid, pinned=None):
    """Run one scan. Returns (placements[P] int32, final state dict of
    [N] int64 rows keyed by STATE_FIELDS, plus the B2 rows the plan
    has), on the plan's device. A plan on the CPU takes the plain
    version; a plan on a CUDA device takes the kernel or raises."""
    if _device_of(plan) == "cpu":
        return fused_scan_reference(plan, class_of_pod, active, valid, pinned)
    inputs = _scenario_inputs(plan, class_of_pod, [(active, valid, pinned)])
    return _launch(plan, *inputs, batch=False)[0]


def run_fused_scan_batch(plan: FusedPlan, class_of_pod, scenarios):
    """Several independent scans of one plan: `scenarios` is a list of
    (active[P], valid[N], pinned[P] or None). Returns [(placements,
    final), ...] in scenario order — the contract of the JAX package's
    run_scan_pallas_batch. On a CUDA plan all scenarios go in one
    launch on one stream (one block each); a CPU plan takes the plain
    version."""
    if _device_of(plan) == "cpu":
        return fused_scan_batch_reference(plan, class_of_pod, scenarios)
    inputs = _scenario_inputs(plan, class_of_pod, scenarios)
    return _launch(plan, *inputs, batch=True)


def kernel_label(plan: FusedPlan) -> str:
    """What a single scan of this plan runs, for the `batch-kernel`
    trace note."""
    name = EXT_KERNEL_NAME if plan.ext else KERNEL_NAME
    if plan.device.type == "cuda":
        return f"cuda-{name}"
    return f"torch-plain-{name} ({plan.device.type})"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = [
    "BATCH_KERNEL_NAME",
    "EXT_KERNEL_NAME",
    "FusedPlan",
    "INACTIVE",
    "KERNEL_NAME",
    "LAUNCHES",
    "NoCardError",
    "OutOfSliceError",
    "build_library",
    "build_plan",
    "check_in_slice",
    "fused_scan_batch_reference",
    "fused_scan_reference",
    "kernel_label",
    "pack_port_words",
    "plan_from_jax_arrays",
    "reset_launch_counts",
    "resolve_device",
    "run_fused_scan",
    "run_fused_scan_batch",
]
