"""Placement report tables.

A copy of the JAX package's apply/report.py (pure host code), with its
imports resolving to this package. Mirrors pkg/apply/apply.go:309-609
(reportClusterInfo / reportNodeInfo):
node info table, extended-resource tables (local storage VG/device, GPU
per-device), and the per-node pod table. Rendered with a small built-in
ASCII table writer (the reference uses olekukonko/tablewriter).
"""

from __future__ import annotations

from typing import List, Optional

from ..models import requests as req
from ..models import storage as stor
from ..models import workloads as wl
from ..utils.quantity import format_quantity_bin


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

    def line(ch="-", junction="+"):
        return junction + junction.join(ch * (w + 2) for w in widths) + junction

    # one C-level str.format per row beats per-cell ljust+join at 100k
    # rows (capacity-report host tail)
    row_fmt = "| " + " | ".join(f"{{:<{w}}}" for w in widths) + " |"
    fmt_row = row_fmt.format

    sep = line()  # identical between every row: render once, not per row
    out = [sep, fmt_row(*headers), line("=")]
    for row in str_rows:
        out.append(fmt_row(*row))
        out.append(sep)
    return "\n".join(out)


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
    out = ["Node Info"]
    out.append(_node_table(node_statuses, extended_resources, oracle=oracle))
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
    pod_statuses = (
        node_statuses
        if select_nodes is None
        else [
            ns
            for ns in node_statuses
            if ((ns.node.get("metadata") or {}).get("name")) in select_nodes
        ]
    )
    out.append(_pod_table(pod_statuses, extended_resources))
    return "\n".join(out)


def _node_table(node_statuses, extended_resources, oracle=None) -> str:
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
    rows = []
    for status in node_statuses:
        node = status.node
        alloc_mcpu = req.node_alloc_milli_cpu(node)
        alloc_mem = req.node_alloc_int(node, req.MEMORY)
        used_mcpu = used_mem = 0
        gpu_req = 0
        state = matched_node_state(by_node, status)
        if state is not None:
            used_mcpu = state.req_floor_mcpu
            used_mem = state.req_floor_mem
        else:
            summary = req.pod_request_summary
            for pod in status.pods:
                s = summary(pod)
                used_mcpu += s.floor_mcpu
                used_mem += s.floor_mem
                if gpu:  # column only rendered for the gpu table
                    g_mem, g_cnt = stor.pod_gpu_request(pod)
                    gpu_req += g_mem * g_cnt
        labels = (node.get("metadata") or {}).get("labels") or {}
        row = [
            (node.get("metadata") or {}).get("name", ""),
            _fmt_cpu(alloc_mcpu),
            f"{_fmt_cpu(used_mcpu)}({_pct(used_mcpu, alloc_mcpu)}%)",
            format_quantity_bin(alloc_mem),
            f"{format_quantity_bin(used_mem)}({_pct(used_mem, alloc_mem)}%)",
        ]
        if gpu:
            total = stor.node_total_gpu_memory(node)
            row += [
                format_quantity_bin(total),
                f"{format_quantity_bin(gpu_req)}({_pct(gpu_req, total)}%)",
            ]
        row += [str(len(status.pods)), "√" if wl.LABEL_NEW_NODE in labels else ""]
        rows.append(row)
    return render_table(headers, rows)


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


def _pod_table(node_statuses, extended_resources) -> str:
    headers = ["Node", "Pod", "CPU Requests", "Memory Requests"]
    local = "open-local" in extended_resources
    gpu = "gpu" in extended_resources
    if local:
        headers.append("Volume Request")
    if gpu:
        headers.append("GPU Mem Requests")
    headers.append("APP Name")
    rows = []
    # identical (request, allocatable) pairs repeat across thousands of
    # pods at scale — format each value combination once (value-keyed,
    # so snapshot-loaded pods with per-pod summary objects still hit)
    cell_pair: dict = {}
    summary = req.pod_request_summary
    append = rows.append
    for status in node_statuses:
        node = status.node
        node_name = (node.get("metadata") or {}).get("name", "")
        alloc_mcpu = req.node_alloc_milli_cpu(node)
        alloc_mem = req.node_alloc_int(node, req.MEMORY)
        for pod in status.pods:
            s = summary(pod)
            mcpu, mem = s.floor_mcpu, s.floor_mem
            ck = (mcpu, mem, alloc_mcpu, alloc_mem)
            cells = cell_pair.get(ck)
            if cells is None:
                cells = cell_pair[ck] = (
                    f"{_fmt_cpu(mcpu)}({_pct(mcpu, alloc_mcpu)}%)",
                    f"{format_quantity_bin(mem)}({_pct(mem, alloc_mem)}%)",
                )
            meta = pod.get("metadata") or {}
            row = [
                node_name,
                f"{meta.get('namespace', 'default')}/{meta.get('name', '')}",
                cells[0],
                cells[1],
            ]
            if local:
                lvm, dev = stor.parse_pod_local_volumes(pod)
                vols = [f"{v.kind}:{format_quantity_bin(v.size)}" for v in lvm + dev]
                row.append(", ".join(vols))
            if gpu:
                g_mem, g_cnt = stor.pod_gpu_request(pod)
                idx = (meta.get("annotations") or {}).get(stor.GPU_INDEX_ANNO, "")
                row.append(f"{format_quantity_bin(g_mem)}x{g_cnt}@{idx}" if g_mem else "")
            row.append((meta.get("labels") or {}).get(wl.LABEL_APP_NAME, ""))
            append(row)
    return render_table(headers, rows)
