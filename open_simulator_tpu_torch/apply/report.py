"""Placement report tables.

A copy of the JAX package's apply/report.py (pure host code), with its
imports resolving to this package. Mirrors pkg/apply/apply.go:309-609
(reportClusterInfo / reportNodeInfo):
node info table, extended-resource tables (local storage VG/device, GPU
per-device), and the per-node pod table. Rendered with a small built-in
ASCII table writer (the reference uses olekukonko/tablewriter).

The Node Info and Pod Info tables print the same bytes as the JAX
package's, but are made from what repeats in them: the Node Info cells
after a node's name once for each distinct value of them; the Pod Info
table in runs, a node's consecutive pods whose rows differ only in the
pod's name, each run one string join of the names, with the column
widths taken from the distinct cells, not from every row.
"""

from __future__ import annotations

from typing import List, Optional

from ..models import requests as req
from ..models import storage as stor
from ..models import workloads as wl
from ..utils.quantity import format_quantity_bin
from ..utils.trace import COUNTERS, phase

# read-only stand-in for a missing mapping
_NO: dict = {}
# the value before a table's first run: equal to nothing
_START = object()


class _Layout:
    """The lines and the row format of a table whose columns are
    `widths` wide, for every writer of a table."""

    def __init__(self, headers: List[str], widths: List[int]):
        self.sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        # one C-level str.format per row beats per-cell ljust+join at
        # 100k rows (capacity-report host tail)
        self._cols = [f"{{:<{w}}}" for w in widths]
        self._fmt = "| " + " | ".join(self._cols) + " |"
        self.row = self._fmt.format
        # what lies between two rows
        self.rule = f"\n{self.sep}\n"
        self.head = "\n".join((self.sep, self.row(*headers), self.sep.replace("-", "=")))

    def around(self, col: int) -> tuple:
        """The row format cut at column `col`: (the format of the cells
        before it, the format of the cells after it), each with its
        borders."""
        start = 2 + sum(len(c) + 3 for c in self._cols[:col])
        return self._fmt[:start].format, self._fmt[start + len(self._cols[col]):].format

    def lines(self, rows) -> list:
        """The table of `rows` as lines to join with newlines: the
        header, then each of `rows` (the text of a row, or of a run of
        rows joined by `rule`) and a separator line after it. The caller
        joins them once, into the whole report."""
        out = [self.head]
        for row in rows:
            out.append(row)
            out.append(self.sep)
        return out


def render_table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in headers]
    str_rows = [
        row if all(type(c) is str for c in row) else [str(c) for c in row]
        for row in rows
    ]
    for row in str_rows:
        for i, cell in enumerate(row):
            if len(cell) > widths[i]:
                widths[i] = len(cell)
    layout = _Layout(headers, widths)
    fmt_row = layout.row
    return "\n".join(layout.lines([fmt_row(*row) for row in str_rows]))


def _text(cell) -> str:
    """A cell as `render_table` prints it."""
    return cell if type(cell) is str else str(cell)


def _allocatable(node: dict, seen: dict) -> tuple:
    """(allocatable mCPU, allocatable memory) of a node, read once for
    each distinct allocatable in `seen`, keyed by its value: every node
    of a loaded cluster holds a dict of its own, and the reads' Fraction
    arithmetic costs more than the key."""
    status = node.get("status") or _NO
    alloc = status.get("allocatable")
    if alloc is None:
        alloc = status.get("capacity")
    key = tuple(alloc.items()) if alloc else ()
    hit = seen.get(key)
    if hit is None:
        hit = seen[key] = (req.node_alloc_milli_cpu(node), req.node_alloc_int(node, req.MEMORY))
    return hit


def node_state_index(oracle):
    """{id(node dict): NodeState} for the oracle-backed fast paths
    (report node table, satisfy_resource_setting). Empty when no
    oracle is in play."""
    if oracle is None:
        return {}
    return {id(ns.node): ns for ns in oracle.nodes}


def matched_node_state(by_node, status):
    """The NodeState backing `status`, or None when the fast path is
    unsound for it. Identity match proves the status was built from
    this oracle's node; the pod-list check guards against a status
    whose pod list was filtered or extended after the fact — length
    alone would accept a same-length rewrite, so the endpoints must
    also be the very same pod objects."""
    state = by_node.get(id(status.node))
    if (
        state is not None
        and len(state.pods) == len(status.pods)
        and (
            not state.pods
            or (
                state.pods[0] is status.pods[0]
                and state.pods[-1] is status.pods[-1]
            )
        )
    ):
        return state
    return None


def _fmt_cpu(mcpu: int) -> str:
    if mcpu % 1000 == 0:
        return str(mcpu // 1000)
    return f"{mcpu}m"


def _pct(numer: float, denom: float) -> int:
    return int(numer / denom * 100) if denom else 0


def _pod_req_summary(pod: dict):
    s = req.pod_request_summary(pod)
    return s.floor_mcpu, s.floor_mem


def report(
    node_statuses,
    extended_resources: Optional[List[str]] = None,
    select_nodes=None,
    oracle=None,
) -> str:
    """Render the result tables. `select_nodes` (a set of node names, or
    None for all) filters the Pod Info table only — the reference's
    interactive node multi-select (reportNodeInfo, apply.go:510-530)
    narrows the pod table while the cluster tables stay complete.
    `oracle` (when the caller just replayed into one) lets the node
    table read per-node floor aggregates instead of re-walking every
    pod (r4 capacity host-tail trim)."""
    extended_resources = extended_resources or []
    allocs: dict = {}  # allocatable -> its reads, for both tables
    out = ["Node Info"]
    with phase("report/nodes"):
        out.append(_node_table(node_statuses, extended_resources, allocs, oracle=oracle))
    if extended_resources:
        out.append("")
        out.append("Extended Resource Info")
        if "open-local" in extended_resources:
            out.append("Node Local Storage")
            out.append(_storage_table(node_statuses))
        if "gpu" in extended_resources:
            out.append("GPU Node Resource")
            out.append(_gpu_table(node_statuses))
    out.append("")
    out.append("Pod Info")
    with phase("report/pods"):
        pod_statuses = (
            node_statuses
            if select_nodes is None
            else [
                ns
                for ns in node_statuses
                if ((ns.node.get("metadata") or {}).get("name")) in select_nodes
            ]
        )
        out += _pod_table(pod_statuses, extended_resources, allocs)
    return "\n".join(out)


def _node_table(node_statuses, extended_resources, allocs, oracle=None) -> str:
    headers = ["Node", "CPU Allocatable", "CPU Requests", "Memory Allocatable", "Memory Requests"]
    gpu = "gpu" in extended_resources
    if gpu:
        headers += ["GPU Mem Allocatable", "GPU Mem Requests"]
    headers += ["Pod Count", "New Node"]
    # fast path: the replay oracle tracks floor-semantics totals per
    # node (NodeState.req_floor_*), identical to summing the per-pod
    # floors below. NOT used for the gpu column: its per-pod
    # g_mem*g_cnt semantics diverge from the commit-time device
    # accounting on degenerate annotations (mem without count), and
    # the report must render identically on every code path
    by_node = node_state_index(oracle) if not gpu else {}
    summary = req.pod_request_summary
    # the cells after the node's name, once for each distinct value
    tails: dict = {}
    rows = []
    for status in node_statuses:
        node = status.node
        meta = node.get("metadata") or _NO
        alloc_mcpu, alloc_mem = _allocatable(node, allocs)
        used_mcpu = used_mem = 0
        gpu_req = 0
        state = matched_node_state(by_node, status)
        if state is not None:
            used_mcpu = state.req_floor_mcpu
            used_mem = state.req_floor_mem
        else:
            for pod in status.pods:
                s = summary(pod)
                used_mcpu += s.floor_mcpu
                used_mem += s.floor_mem
                if gpu:  # column only rendered for the gpu table
                    g_mem, g_cnt = stor.pod_gpu_request(pod)
                    gpu_req += g_mem * g_cnt
        key = (
            alloc_mcpu, alloc_mem, used_mcpu, used_mem, len(status.pods),
            wl.LABEL_NEW_NODE in (meta.get("labels") or _NO),
            stor.node_total_gpu_memory(node) if gpu else 0, gpu_req,
        )
        tail = tails.get(key)
        if tail is None:
            tail = tails[key] = _node_cells(key, gpu)
        rows.append([meta.get("name", ""), *tail])
    return render_table(headers, rows)


def _node_cells(key: tuple, gpu: bool) -> tuple:
    """The Node Info cells after the node's name, from the row's values."""
    alloc_mcpu, alloc_mem, used_mcpu, used_mem, pods, new, gpu_total, gpu_req = key
    cells = (
        _fmt_cpu(alloc_mcpu),
        f"{_fmt_cpu(used_mcpu)}({_pct(used_mcpu, alloc_mcpu)}%)",
        format_quantity_bin(alloc_mem),
        f"{format_quantity_bin(used_mem)}({_pct(used_mem, alloc_mem)}%)",
    )
    if gpu:
        cells += (
            format_quantity_bin(gpu_total),
            f"{format_quantity_bin(gpu_req)}({_pct(gpu_req, gpu_total)}%)",
        )
    return cells + (str(pods), "√" if new else "")


def _storage_table(node_statuses) -> str:
    headers = ["Node", "Storage Kind", "Storage Name", "Storage Allocatable", "Storage Requests"]
    rows = []
    for status in node_statuses:
        node = status.node
        storage = stor.parse_node_storage(node)
        if storage is None:
            continue
        name = (node.get("metadata") or {}).get("name", "")
        for vg in storage.vgs:
            rows.append(
                [
                    name,
                    "VG",
                    vg.name,
                    format_quantity_bin(vg.capacity),
                    f"{format_quantity_bin(vg.requested)}({_pct(vg.requested, vg.capacity)}%)",
                ]
            )
        for dev in storage.devices:
            rows.append(
                [
                    name,
                    f"Device({dev.media_type})",
                    dev.name,
                    format_quantity_bin(dev.capacity),
                    "used" if dev.is_allocated else "unused",
                ]
            )
    return render_table(headers, rows)


def _gpu_table(node_statuses) -> str:
    headers = ["Node", "GPU ID", "GPU Request/Capacity", "Pod List"]
    rows = []
    for status in node_statuses:
        node = status.node
        count = stor.node_gpu_count(node)
        if count == 0:
            continue
        name = (node.get("metadata") or {}).get("name", "")
        per_dev = stor.node_gpu_per_device_memory(node)
        used = [0] * count
        pods_per_dev: List[List[str]] = [[] for _ in range(count)]
        for pod in status.pods:
            mem, _cnt = stor.pod_gpu_request(pod)
            if mem <= 0:
                continue
            idx = ((pod.get("metadata") or {}).get("annotations") or {}).get(stor.GPU_INDEX_ANNO)
            if idx is None:
                continue
            for d in str(idx).split("-"):
                d = int(d)
                used[d] += mem
                pods_per_dev[d].append(pod["metadata"]["name"])
        total_used = sum(used)
        rows.append(
            [
                name,
                "ALL",
                f"{format_quantity_bin(total_used)}/{format_quantity_bin(per_dev * count)}",
                "",
            ]
        )
        for d in range(count):
            rows.append(
                [
                    name,
                    str(d),
                    f"{format_quantity_bin(used[d])}/{format_quantity_bin(per_dev)}",
                    ", ".join(pods_per_dev[d]),
                ]
            )
    return render_table(headers, rows)


def _pod_table(node_statuses, extended_resources, allocs) -> list:
    headers = ["Node", "Pod", "CPU Requests", "Memory Requests"]
    local = "open-local" in extended_resources
    gpu = "gpu" in extended_resources
    if local:
        headers.append("Volume Request")
    if gpu:
        headers.append("GPU Mem Requests")
    headers.append("APP Name")
    # A run: a node's consecutive pods whose rows differ only in the
    # pod's name, i.e. that share the identity of their request sources
    # (pod_request_summary's memo key), their namespace, their per-pod
    # cells and their app label. Its request summary is read once, its
    # cells formatted once for each distinct value (value-keyed, so
    # snapshot-loaded pods with sources of their own still share the
    # strings). A pod's own work is its dict reads: the names are kept
    # as they are, and joined into the table once.
    cell_pair: dict = {}
    tails: dict = {}  # the distinct cells after the pod's name -> their number
    # (allocatable, the sources' identities, own cells, app) -> that number
    known: dict = {}
    nodes = []  # (node name, [(namespace, tail's number, names)])
    name_w = len(headers[1])
    summary = req.pod_request_summary
    app_label = wl.LABEL_APP_NAME
    own = local or gpu
    for status in node_statuses:
        pods = status.pods
        if not pods:
            continue
        node = status.node
        alloc = _allocatable(node, allocs)
        runs = []
        nodes.append((_text((node.get("metadata") or _NO).get("name", "")), runs))
        # the run's key, and the last pod's labels dict and namespace,
        # whose app label and text are `app` and `space`
        c0 = i0 = o0 = app0 = space0 = labels0 = ns0 = _START
        extra = extra0 = ()
        for pod in pods:
            meta = pod.get("metadata") or _NO
            spec = pod.get("spec") or _NO
            labels = meta.get("labels")
            ns = meta.get("namespace", "default")
            c = spec.get("containers")
            i = spec.get("initContainers")
            o = spec.get("overhead")
            if own:
                extra = _pod_cells(pod, meta, local, gpu)
            # replicas share one labels dict, their sources and their
            # namespace: then nothing is compared by value
            if (labels is not labels0 or ns is not ns0 or c is not c0 or i is not i0
                    or o is not o0 or extra is not extra0):
                if labels is not labels0:
                    labels0 = labels
                    app = _text(labels.get(app_label, "") if labels else "")
                if ns is not ns0:
                    ns0 = ns
                    space = _text(ns)
                if (c is not c0 or i is not i0 or o is not o0 or extra != extra0
                        or app != app0 or space != space0):
                    c0, i0, o0, extra0, app0, space0 = c, i, o, extra, app, space
                    key = (alloc, id(c), id(i), id(o), extra, app)
                    number = known.get(key)
                    if number is None:
                        s = summary(pod)
                        mcpu, mem = s.floor_mcpu, s.floor_mem
                        ck = (mcpu, mem, alloc)
                        cells = cell_pair.get(ck)
                        if cells is None:
                            cells = cell_pair[ck] = (
                                f"{_fmt_cpu(mcpu)}({_pct(mcpu, alloc[0])}%)",
                                f"{format_quantity_bin(mem)}({_pct(mem, alloc[1])}%)",
                            )
                        number = known[key] = tails.setdefault((*cells, *extra, app), len(tails))
                    names = []
                    runs.append((space, number, names))
                    # the width of "namespace/" in this run
                    lead_w = len(space) + 1
            name = meta.get("name", "")
            if type(name) is not str:
                name = str(name)
            names.append(name)
            if len(name) + lead_w > name_w:
                name_w = len(name) + lead_w
    rows = n_runs = 0
    node_w = len(headers[0])
    for node_name, runs in nodes:
        node_w = max(node_w, len(node_name))
        for _, _, names in runs:
            rows += len(names)
        n_runs += len(runs)
    COUNTERS.inc("report_pod_rows_total", rows)
    COUNTERS.inc("report_pod_runs_total", n_runs)
    # the later columns' widths from the distinct tails
    layout = _Layout(headers, [node_w, name_w] + [
        max([len(header)] + [len(tail[j]) for tail in tails])
        for j, header in enumerate(headers[2:])
    ])
    before, after = layout.around(1)
    suffixes = [after(*tail) for tail in tails]
    rule = layout.rule
    out = []
    append = out.append
    for node_name, runs in nodes:
        prefix = before(node_name)
        space0 = None
        for space, number, names in runs:
            suffix = suffixes[number]
            if space is not space0:
                space0 = space
                lead = f"{prefix}{space}/"
                width = name_w - len(space) - 1
            append(lead + (suffix + rule + lead).join(
                [name.ljust(width) for name in names]) + suffix)
    return layout.lines(out)


def _pod_cells(pod: dict, meta: dict, local: bool, gpu: bool) -> tuple:
    """A pod's own Volume Request and GPU Mem Requests cells."""
    cells = ()
    if local:
        lvm, dev = stor.parse_pod_local_volumes(pod)
        cells += (", ".join(f"{v.kind}:{format_quantity_bin(v.size)}" for v in lvm + dev),)
    if gpu:
        g_mem, g_cnt = stor.pod_gpu_request(pod)
        idx = (meta.get("annotations") or _NO).get(stor.GPU_INDEX_ANNO, "")
        cells += (f"{format_quantity_bin(g_mem)}x{g_cnt}@{idx}" if g_mem else "",)
    return cells
