"""Mesh-sharded scanning over the local CUDA devices: the port of the JAX
package's parallel/mesh.py.

Two shardable axes, one planner:

- **scenario axis**: rows of a batched launch (capacity counts, chaos
  outage rows, timeline policy windows, coalesced serve requests,
  defrag depths) are independent scans. ``shard_scenario_rows`` splits
  them into contiguous, near-equal shares, one per mesh device, and
  ``launch_rows`` makes ONE launch of the batch kernel (B6,
  ops/fused_scan.py) a device over its share, the plan copied to that
  device. No padding: each share is its own launch, and its placements
  are those of the one-launch answer, row for row.
- **node axis**: ONE scan over a cluster the planner sends off a single
  device. Every node-axis field of ``ScanStatic``/``ScanState`` is
  padded to a multiple of the shard count and split; one Python thread
  a shard runs the eager torch scan (ops/scan.py) on its node slice
  with a ``_ShardCtx``, whose cross-node reductions are exchanges
  (``_Exchange``, a token ring): every shard's contribution is
  gathered on the host, reduced once, and handed back on the shard's
  own device. Every combine is a max, min, any or int64 sum and every
  score is per node, so the placements equal the unsharded scan's bit
  for bit.

The **layout planner** (``plan_layout``) keeps the JAX package's table:
no mesh, one device or a sample-mode batch -> none; two or more
scenarios -> the scenario axis; one scenario -> the node axis when the
memory ledger (obs/ledger.py ``would_fit``) predicts that the site's
workspace (obs/costs.py ``estimate_bytes``) does not fit on one device,
or past the node threshold; else none.

A ``Mesh`` is one process over local devices, as the JAX mesh is over
``jax.local_devices()``: the CLI, ``simon serve`` and each fleet
replica are one process, so there is no ``torch.distributed`` process
group. ``mesh_from_spec`` resolves against the entry point's device:
the cards ``torch.cuda.device_count()`` reports, or one CPU device. A
``Mesh`` may also be built directly with one device repeated (N shards
on ``cpu`` or on ``cuda:0``): the tests and chip_smoke.py hold the
sharded paths so on one device; the CLI never builds one.

Selection is process-wide (``configure``/``current_mesh``), wired to
``--mesh auto|off|N`` on apply, chaos and timeline and to the
SIMON_MESH environment variable, which every other command reads
through ``current_mesh``. Unlike the JAX package, a fault on a sharded
launch is never retired to the single-device path: a device OOM halves
a chunk of scenario rows (runtime/guard.py ``run_chunked``, told the
shard count), and every other fault propagates. The sharded launches
are instrumented sites (obs/profile.py): ``mesh_scan`` for the node
axis and ``mesh_<site>_sweep`` for the outage rows, each an
``--inject`` seam (``jit.mesh_*``).
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..models.validation import InputError

MESH_AXIS = "devices"

# single-device node count past which the planner sends one scan to the
# node axis even when memory is not predicted tight: the JAX package's
# threshold, kept so that both packages route the same inputs alike
DEFAULT_NODE_THRESHOLD = 25_000

# seconds a shard of the node-sharded scan waits for its turn before the
# scan fails (the other shards stopped exchanging)
EXCHANGE_TIMEOUT_S = 600.0


def node_threshold() -> int:
    env = os.environ.get("SIMON_MESH_NODE_THRESHOLD")
    try:
        return int(env) if env else DEFAULT_NODE_THRESHOLD
    except ValueError:
        return DEFAULT_NODE_THRESHOLD


# ---------------------------------------------------------------- config


class Mesh:
    """An ordered tuple of torch devices along one axis. A device may
    repeat (N shards on one card or on the CPU): ``size`` counts shards,
    ``effective_parallelism`` distinct devices."""

    __slots__ = ("devices", "axis_name")

    def __init__(self, devices, axis_name: str = MESH_AXIS):
        out = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", 0)
            out.append(d)
        if not out:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(out)
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r})"


_LOCK = threading.Lock()
# spec None: the SIMON_MESH environment variable, read at resolution;
# cache: (spec, device type) -> resolved mesh
_STATE = {"spec": None, "cache": {}}


def parse_mesh_spec(spec: Optional[str]) -> Optional[int]:
    """``auto`` -> -1, ``off``/empty/None -> None, ``N`` -> N (>= 1).
    Raises InputError on anything else (CLI exit 2)."""
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if s in ("", "off", "0", "none"):
        return None
    if s == "auto":
        return -1
    try:
        n = int(s)
    except ValueError:
        raise InputError(
            f"--mesh {spec!r}: expected auto, off, or a device count"
        ) from None
    if n < 1:
        raise InputError(f"--mesh {spec!r}: device count must be >= 1")
    return n


def configure(spec: Optional[str]) -> None:
    """Set the process-wide mesh selection (CLI ``--mesh``). Validates
    the spec now (InputError on junk) and resolves devices at the first
    ``current_mesh``. None returns to the SIMON_MESH default."""
    parse_mesh_spec(spec)
    with _LOCK:
        _STATE["spec"] = spec
        _STATE["cache"] = {}


def _spec() -> str:
    spec = _STATE["spec"]
    return spec if spec is not None else os.environ.get("SIMON_MESH", "off")


def local_devices(device=None) -> List[torch.device]:
    """The local devices of the entry point's device type: every card
    ``torch.cuda.device_count()`` reports for ``cuda`` (the default),
    one device for ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(dev.type)]


def mesh_from_spec(spec: Optional[str], device=None) -> Optional[Mesh]:
    """The ``Mesh`` a spec names on the entry point's device type, or
    None (no mesh: one device). ``auto`` = every local device (None
    when there is only one); ``N`` = the first N devices, ``1`` None; a
    count beyond the local devices raises InputError."""
    want = parse_mesh_spec(spec)
    if want is None:
        return None
    devices = local_devices(device)
    if want == -1:
        if len(devices) < 2:
            return None
        return Mesh(devices)
    if want > len(devices):
        raise InputError(
            f"--mesh {want}: only {len(devices)} local device(s) available"
        )
    if want == 1:
        return None
    return Mesh(devices[:want])


def current_mesh(device=None) -> Optional[Mesh]:
    """The configured process-wide mesh on the entry point's device type
    (None = one device). Resolved once per (spec, device type)."""
    spec = _spec()
    key = (spec, torch.device("cuda" if device is None else device).type)
    with _LOCK:
        if key in _STATE["cache"]:
            return _STATE["cache"][key]
    mesh = mesh_from_spec(spec, device)
    with _LOCK:
        _STATE["cache"][key] = mesh
    if mesh is not None:
        from ..utils.trace import COUNTERS

        COUNTERS.gauge("mesh_devices", float(mesh.size))
    return mesh


def effective_parallelism(mesh) -> int:
    """How many devices can work at once: the distinct devices of the
    mesh (a mesh repeating one card is 1), on the CPU at most its core
    count."""
    if mesh is None:
        return 1
    distinct = mesh.distinct()
    if distinct[0].type == "cpu":
        return max(1, min(len(distinct), os.cpu_count() or 1))
    return len(distinct)


# ---------------------------------------------------------------- planner


@dataclass(frozen=True)
class LayoutDecision:
    """One request's sharding verdict. ``axis`` is "scenario", "node",
    or "none" (one device); ``shards`` is the shard count the launch
    uses (1 for "none")."""

    axis: str
    shards: int
    reason: str


def plan_layout(
    site: str,
    *,
    mesh,
    n_scenarios: int,
    n_nodes: int,
    sample: bool = False,
) -> LayoutDecision:
    """Pick the shard layout of one request from the mesh, the site's
    workspace estimate (obs/costs.py) and the memory ledger's fit
    prediction. Every decision is counted (``mesh_layout_<axis>_total``)
    and trace-noted (``mesh-layout``):

    - no mesh (or one shard) -> none;
    - sample-mode batch -> none: the Go-RNG stream is one serial
      sequence;
    - >= 2 scenarios -> the scenario axis over the whole mesh;
    - 1 scenario -> the node axis when the ledger predicts that the
      site's single-device workspace will NOT fit, or the cluster is
      past the node threshold (SIMON_MESH_NODE_THRESHOLD, default
      25,000); else none.
    """
    from ..utils.trace import COUNTERS, GLOBAL

    def decide(axis: str, shards: int, reason: str) -> LayoutDecision:
        COUNTERS.inc(f"mesh_layout_{axis}_total")
        GLOBAL.append_note("mesh-layout", f"{site}: {axis} x{shards} ({reason})")
        return LayoutDecision(axis=axis, shards=shards, reason=reason)

    if mesh is None:
        return decide("none", 1, "no mesh configured")
    n_dev = int(mesh.size)
    if n_dev <= 1:
        return decide("none", 1, "mesh has a single device")
    from ..obs.ledger import LEDGER

    LEDGER.watch(mesh.devices)
    if sample:
        return decide("none", 1, "sample-mode serial RNG stream")
    if n_scenarios >= 2:
        return decide(
            "scenario", n_dev,
            f"{n_scenarios} independent scenario rows over {n_dev} devices",
        )
    if n_nodes < n_dev:
        return decide("none", 1, f"{n_nodes} nodes < {n_dev} devices")
    from ..obs.costs import COSTS

    # a planning probe, not a launch: would_fit leaves the prediction
    # counters to launches that ran. `site` names the single-device
    # launch whose workspace is in question
    est = COSTS.estimate_bytes(site, 1)
    fits = LEDGER.would_fit(int(est), device=mesh.devices[0]) if est is not None else None
    if fits is False:
        return decide(
            "node", n_dev,
            f"ledger predicts {est} bytes will not fit on one device",
        )
    if n_nodes >= node_threshold():
        return decide(
            "node", n_dev,
            f"{n_nodes} nodes past the single-device threshold "
            f"({node_threshold()})",
        )
    return decide("none", 1, "single-device warm path fits")


# ------------------------------------------------- scenario-axis sharding


def shard_scenario_rows(mesh, arrays):
    """Split the leading (scenario) axis of every array (or list) into
    contiguous, near-equal shares, one per mesh device in mesh order:
    [(device, lo, hi, [a[lo:hi] for a in arrays])], shares that would
    be empty left out. No padding: each share is its own launch."""
    rows = len(arrays[0])
    base, extra = divmod(rows, mesh.size)
    out = []
    lo = 0
    for i, dev in enumerate(mesh.devices):
        hi = lo + base + (1 if i < extra else 0)
        if hi > lo:
            out.append((dev, lo, hi, [a[lo:hi] for a in arrays]))
        lo = hi
    return out


def plan_on(plan, device, plans: Optional[dict] = None):
    """`plan` (a FusedPlan) on `device`: itself there, else a copy,
    kept in `plans` ((device, id) -> (plan, copy)) for the next call
    with the same plan."""
    device = torch.device(device)
    if plan.device == device:
        return plan
    key = (device, id(plan))
    if plans is not None:
        hit = plans.get(key)
        if hit is not None and hit[0] is plan:
            return hit[1]
    moved = plan.to(device)
    if plans is not None:
        plans[key] = (plan, moved)
    return moved


def launch_rows(mesh, plan, class_of_pod, scenarios, *, site: str,
                pins_first: bool = False, plans: Optional[dict] = None):
    """One batch-kernel launch (``run_fused_scan_batch``) a mesh device
    over its share of `scenarios` ([(active, valid, pinned)]), every
    launch enqueued before any result is read. Returns [(plan on the
    share's device, lo, hi, [(placements, final), ...])] in scenario
    order; on a CUDA plan each launch is made under its device, its
    cluster size chosen for its own share."""
    from ..ops import fused_scan

    out = []
    for dev, lo, hi, (share,) in shard_scenario_rows(mesh, [list(scenarios)]):
        p = plan_on(plan, dev, plans)
        out.append((p, lo, hi, fused_scan.run_fused_scan_batch(
            p, class_of_pod, share, pins_first=pins_first, site=site)))
    return out


# ----------------------------------------------------- node-axis sharding

# node-axis position per ScanStatic field; unlisted fields carry only
# class/term/port axes and replicate. Keyed by NAME so that a new field
# fails the axis-table test instead of replicating a node-sized tensor
# onto every shard.
_STATIC_NODE_AXIS = {
    "alloc_mcpu": 0, "alloc_mem": 0, "alloc_eph": 0, "alloc_pods": 0,
    "scalar_alloc": 1,
    "gpu_per_dev": 0, "gpu_total": 0, "gpu_count": 0, "dev_valid": 0,
    "vg_cap": 0, "vg_valid": 0, "has_storage": 0,
    "ssd_cap": 0, "ssd_valid": 0, "hdd_cap": 0, "hdd_valid": 0,
    "static_feasible": 1, "simon_raw": 1, "nodeaff_raw": 1,
    "taint_intol": 1, "avoid_score": 1, "image_score": 1,
    "topo_val": 1, "h_cand_nodes": 1, "s_q": 1, "cls_s_haskeys": 1,
    "g_topo_val": 1, "s_topo_val": 1, "s_val_onehot": 2,
    "custom_raw": 2,
}

# node-axis position per ScanState field; group_total is a per-row TOTAL
# (every shard adds the same increment after the placed node's values
# are gathered) and rng_hist/rng_overflow are sample-mode-only, so they
# replicate
_STATE_NODE_AXIS = {
    "used_mcpu": 0, "used_mem": 0, "used_eph": 0, "used_scalar": 1,
    "nz_mcpu": 0, "nz_mem": 0, "pod_cnt": 0, "ports_used": 0,
    "gpu_used": 0, "vg_used": 0, "ssd_used": 0, "hdd_used": 0,
    "tgt": 1, "own_anti_req": 1, "own_aff_pref_w": 1,
    "own_anti_pref_w": 1, "group_counts": 1, "soft_counts": 1,
}

# fields whose node axis pads with -1 ("missing topology key") instead
# of 0: a padded node must never look like it shares topology value 0
_PAD_NEG1 = {"topo_val", "g_topo_val", "s_topo_val"}


def _pad_along(t: torch.Tensor, axis: int, pad: int, name: str) -> torch.Tensor:
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[axis] = pad
    fill = -1 if name in _PAD_NEG1 else (False if t.dtype == torch.bool else 0)
    return torch.cat([t, torch.full(shape, fill, dtype=t.dtype, device=t.device)], dim=axis)


def padded_node_count(n: int, shards: int) -> int:
    return int(math.ceil(n / shards) * shards)


def pad_static(static, shards: int):
    """Pad every node-axis field of a ScanStatic to a multiple of the
    shard count. Padded nodes are inert: allocatables 0, validity masks
    False, topology values -1, and the caller's node_valid is padded
    False, so no filter passes one."""
    n = int(static.alloc_mcpu.shape[0])
    pad = padded_node_count(n, shards) - n
    if pad == 0:
        return static
    return static._replace(**{name: _pad_along(getattr(static, name), ax, pad, name)
                              for name, ax in _STATIC_NODE_AXIS.items()})


def pad_state(init, shards: int):
    n = int(init.used_mcpu.shape[0])
    pad = padded_node_count(n, shards) - n
    if pad == 0:
        return init
    return init._replace(**{name: _pad_along(getattr(init, name), ax, pad, name)
                            for name, ax in _STATE_NODE_AXIS.items()})


def pad_valid(node_valid, shards: int) -> np.ndarray:
    node_valid = np.asarray(node_valid, bool)
    pad = padded_node_count(node_valid.shape[0], shards) - node_valid.shape[0]
    if pad == 0:
        return node_valid
    return np.concatenate([node_valid, np.zeros(pad, bool)])


def _slice(tup, table: dict, lo: int, hi: int, device):
    """One shard's copy of a ScanStatic/ScanState: node-axis fields
    narrowed to [lo, hi), the rest whole, all on `device`."""
    kw = {}
    for name in tup._fields:
        t = getattr(tup, name)
        if t is None:
            continue
        ax = table.get(name)
        if ax is not None:
            t = t.narrow(ax, lo, hi - lo)
        kw[name] = t.to(device)
    return tup._replace(**kw)


class ShardMismatch(RuntimeError):
    """The shards of one node-sharded scan made different exchanges (a
    step decided something on a shard's own nodes), or one waited past
    the timeout for its turn."""


class _Aborted(Exception):
    """Another shard failed: this one stops at its next turn."""


class _Exchange:
    """The shards' meeting point, a token ring: one shard's Python runs
    at a time (shard 0 first), up to its next exchange, where it leaves
    its contribution and hands the token on; the last shard reduces the
    round's contributions once and hands the token back to shard 0.
    Contributions stay device tensors until that reduction, so each
    card works through its own step while the others' Python runs, and
    eight shard threads never contend for the interpreter lock. Two slot
    rows alternate: a shard writes round k + 1's contribution while the
    others still read round k's result."""

    def __init__(self, shards: int, timeout: Optional[float]):
        self.n = shards
        self.timeout = timeout
        self._turn = [threading.Event() for _ in range(shards)]
        self._slots = ([None] * shards, [None] * shards)
        self._result = [None, None]
        self._rounds = [0] * shards
        self._done = [False] * shards
        self.aborted = False
        self._turn[0].set()

    def wait_turn(self, rank: int) -> None:
        if not self._turn[rank].wait(self.timeout):
            raise ShardMismatch(
                f"node-sharded scan: shard {rank} waited longer than {self.timeout} s "
                f"for its turn at exchange {self._rounds[rank]}")
        self._turn[rank].clear()
        if self.aborted:
            raise _Aborted()

    def _check(self, rank: int, slots: list) -> None:
        kinds = {kind for kind, _v in slots}
        if any(self._done) or len(set(self._rounds)) != 1 or len(kinds) != 1:
            raise ShardMismatch(
                f"node-sharded scan: the shards' exchanges differ (shard {rank}: "
                f"rounds {self._rounds}, kinds {sorted(kinds)}, finished {self._done})")

    def reduce(self, rank: int, kind: str, value, op):
        """Every shard's `value` of this round, reduced by `op` (a list
        in shard order -> the result) once, on the last shard's turn.
        `kind` names the reduction: every shard must make the same one."""
        k = self._rounds[rank]
        self._rounds[rank] = k + 1
        self._slots[k & 1][rank] = (kind, value)
        if rank == self.n - 1:
            slots = list(self._slots[k & 1])
            self._check(rank, slots)
            self._result[k & 1] = op([v for _kind, v in slots])
        self._turn[(rank + 1) % self.n].set()
        self.wait_turn(rank)
        return self._result[k & 1]

    def finish(self, rank: int) -> None:
        """This shard's scan ended: the next shard finishes its own."""
        self._done[rank] = True
        if len(set(self._rounds)) != 1:
            raise ShardMismatch(
                f"node-sharded scan: shard {rank} ended after {self._rounds[rank]} "
                f"exchanges, the shards made {self._rounds}")
        self._turn[(rank + 1) % self.n].set()

    def abort(self) -> None:
        self.aborted = True
        for ev in self._turn:
            ev.set()


def _host_stack(vals):
    return torch.stack([v.cpu() for v in vals])


class _ShardCtx:
    """ops/scan.py reduction context of one shard of the node axis:
    combines gather every shard's value on the host and reduce it
    there, a gather returns the owning shard's value (the JAX
    package's +1 sum), and the select is the per-shard first maximum
    reduced to the global first maximum in node order."""

    __slots__ = ("rank", "offset", "n_local", "n_total", "_ex")

    def __init__(self, exchange: _Exchange, rank: int, offset: int, n_local: int,
                 n_total: int):
        self._ex = exchange
        self.rank = rank
        self.offset = offset
        self.n_local = n_local
        self.n_total = n_total

    def _reduce(self, kind, x, op):
        return self._ex.reduce(self.rank, kind, x,
                               lambda vals: op(_host_stack(vals))).to(x.device)

    def combine_max(self, x):
        return self._reduce("max", x, lambda v: v.amax(dim=0))

    def combine_min(self, x):
        return self._reduce("min", x, lambda v: v.amin(dim=0))

    def combine_sum(self, x):
        # int64 counts only (as in the JAX scan): exact in any order
        return self._reduce("sum", x, lambda v: v.sum(dim=0))

    def combine_any(self, x):
        return self._reduce("any", x, lambda v: v.any(dim=0))

    def total_nodes(self, n_local: int) -> int:
        return self.n_total

    def gather_vec(self, vec, idx: int):
        lp = idx - self.offset
        mine = vec[lp] if 0 <= lp < self.n_local else None
        return self._ex.reduce(self.rank, "gather_vec", mine,
                               lambda vals: next(v for v in vals if v is not None))

    def gather_cols(self, arr, idx):
        lp = idx - self.offset
        own = (lp >= 0) & (lp < self.n_local)
        col = arr.index_select(arr.dim() - 1, lp.clamp(0, self.n_local - 1).view(1))[..., 0]
        total = self._reduce("gather_cols", torch.where(own, col.long() + 1, 0),
                             lambda v: v.sum(dim=0))
        return (total - 1).to(arr.dtype)

    def first_max_index(self, masked):
        best = masked.argmax()

        def first_max(vals):
            v = _host_stack(vals)
            return v[:, 1][v[:, 0] == v[:, 0].max()].min()

        pair = torch.stack([masked[best], best + self.offset])
        return self._ex.reduce(self.rank, "first_max", pair, first_max).to(masked.device)

    def commit_onehot(self, node, inc):
        lp = node - self.offset
        own = (lp >= 0) & (lp < self.n_local)
        return lp.clamp(0, self.n_local - 1).view(1), inc * own


def _run_shards(devices, work, timeout):
    """Run `work(rank, exchange)` on one thread a shard, each under its
    device, taking turns through the exchange; their results in shard
    order. The first error a shard raises aborts the exchange, so every
    other shard stops at its next turn, and is raised here once every
    thread has ended: no hang, no partial result."""
    shards = len(devices)
    ex = _Exchange(shards, timeout)
    results = [None] * shards
    errors: list = []
    lock = threading.Lock()

    def body(rank):
        dev = devices[rank]
        try:
            ex.wait_turn(rank)
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    results[rank] = work(rank, ex)
            else:
                results[rank] = work(rank, ex)
            ex.finish(rank)
        except BaseException as e:  # noqa: BLE001 - handed to the caller below
            with lock:
                errors.append(e)
            ex.abort()

    threads = [threading.Thread(target=body, args=(r,), name=f"mesh-shard-{r}", daemon=True)
               for r in range(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if not isinstance(e, _Aborted)), None)
    if first is not None:
        raise first
    return results


def _valid_sums(static, valid, final):
    """(used cpu, alloc cpu, used mem, alloc mem, used VG, VG capacity)
    over one shard's valid nodes, as Python ints: parallel/scans.py's
    sums."""
    v = valid
    return [int(torch.where(v, x, 0).sum()) for x in (
        final.used_mcpu, static.alloc_mcpu, final.used_mem, static.alloc_mem)] + [
        int(torch.where(v[:, None], x, 0).sum()) for x in (final.vg_used, static.vg_cap)]


class NodeShardPlan:
    """The padded, split node-sharded state of one (static, init) pair,
    for repeated scans over it (the capacity search probes many counts
    against one encoding): the pad and the copies are made once."""

    def __init__(self, mesh, static, init, class_of_pod, pinned, features,
                 timeout: Optional[float] = EXCHANGE_TIMEOUT_S):
        if bool(getattr(features, "sample", False)):
            raise InputError(
                "sample-mode batches cannot ride the node-sharded scan "
                "(serial Go-RNG stream); the layout planner excludes them"
            )
        self.mesh = mesh
        self.shards = int(mesh.size)
        self.features = features
        self.timeout = timeout
        self.cls = np.asarray(class_of_pod, np.int64)
        self.pinned = np.asarray(pinned, np.int64)
        self.n = int(static.alloc_mcpu.shape[0])
        self.n_pad = padded_node_count(self.n, self.shards)
        self.n_local = self.n_pad // self.shards
        static_p = pad_static(static, self.shards)
        init_p = pad_state(init, self.shards)
        self._parts = [
            (_slice(static_p, _STATIC_NODE_AXIS, r * self.n_local, (r + 1) * self.n_local, d),
             _slice(init_p, _STATE_NODE_AXIS, r * self.n_local, (r + 1) * self.n_local, d))
            for r, d in enumerate(mesh.devices)
        ]

    def run(self, node_valid, pod_active, site: str = "mesh_scan"):
        """One masked scan, sharded: (placements [P] int64 numpy, its
        sums over the valid nodes as parallel/scans.py `utilisation`
        takes them), the placements equal to ops.scan.run_scan_masked's.
        One instrumented launch at `site`."""
        from ..obs import profile
        from ..ops import scan as scan_ops

        valid = pad_valid(node_valid, self.shards)
        active = np.asarray(pod_active, bool)
        m = self.n_local

        def work(rank, ex):
            static, init = self._parts[rank]
            dev = static.alloc_mcpu.device
            ctx = _ShardCtx(ex, rank, rank * m, m, self.n_pad)
            valid_l = valid[rank * m:(rank + 1) * m]
            placements, final = scan_ops._run_scan_masked(
                static, init, self.cls, self.pinned, valid_l, active,
                features=self.features, ctx=ctx)
            sums = _valid_sums(static, torch.as_tensor(valid_l, device=dev), final)
            return (placements if rank == 0 else None), sums

        with profile.launch(site, self.mesh.devices[0]):
            out = _run_shards(self.mesh.devices, work, self.timeout)
        placements = profile.to_host(out[0][0]).astype(np.int64)
        return placements, tuple(sum(s[1][k] for s in out) for k in range(6))


def run_node_sharded(
    mesh, static, init, class_of_pod, pinned, node_valid, pod_active,
    features, timeout: Optional[float] = EXCHANGE_TIMEOUT_S,
):
    """ONE masked scan with the node axis split across the mesh
    (``NodeShardPlan``, made for this scan): host-side (placements [P],
    unscheduled, cpu_util, mem_util, vg_util), placements equal to
    ``ops.scan.run_scan_masked``'s. A sample-mode batch raises (the
    planner never sends one here)."""
    from .scans import utilisation

    plan = NodeShardPlan(mesh, static, init, class_of_pod, pinned, features, timeout=timeout)
    placements, sums = plan.run(node_valid, pod_active)
    return (placements, *utilisation(placements, *sums))


__all__ = [
    "DEFAULT_NODE_THRESHOLD",
    "EXCHANGE_TIMEOUT_S",
    "LayoutDecision",
    "MESH_AXIS",
    "Mesh",
    "NodeShardPlan",
    "configure",
    "current_mesh",
    "effective_parallelism",
    "launch_rows",
    "local_devices",
    "mesh_from_spec",
    "node_threshold",
    "pad_state",
    "pad_static",
    "pad_valid",
    "padded_node_count",
    "parse_mesh_spec",
    "plan_layout",
    "plan_on",
    "run_node_sharded",
    "shard_scenario_rows",
    "ShardMismatch",
]
