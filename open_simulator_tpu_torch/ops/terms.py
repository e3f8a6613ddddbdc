"""Term tables: inter-pod affinity and topology-spread state encoding.

The order-dependent plugins carry state that previous placements feed:

- InterPodAffinity (vendor/.../interpodaffinity/filtering.go:241-430,
  scoring.go:47-270): required (anti)affinity of the incoming pod,
  required anti-affinity of existing pods, and four kinds of preferred
  contributions.
- PodTopologySpread (vendor/.../podtopologyspread/filtering.go:197-337,
  scoring.go:60-270): per-topology-domain match counts with min-count
  skew checks and log-weighted scoring.

All of them reduce to counts over (term row, topology value) where a
"term row" is a deduplicated (label selector, namespace set, topology
key) triple. This module builds the tables in VALUE space `[T, V]`
(natural for the host-side init accounting); the scan carries them in
NODE space `[T, N]` — count at each node's own value — so per-step
reads are row indexing and commits are masked broadcasts.

Topology-value space: per-key vocab over node labels; rows whose key is
kubernetes.io/hostname use the node index itself as the value id, so V
= max(non-hostname vocab, N) when hostname terms exist.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models import labels as lbl
from ..utils.trace import COUNTERS

HOSTNAME_KEY = "kubernetes.io/hostname"
HARD_POD_AFFINITY_WEIGHT = 1


def combined_pref_init(tables: "TermTables"):
    """Init for the combined own-affinity state (one array holds
    HARD_POD_AFFINITY_WEIGHT x required + preferred weights — their
    only reader sums them, scoring.go processExistingPod)."""
    return (
        HARD_POD_AFFINITY_WEIGHT * tables.init_own_aff_req
        + tables.init_own_aff_pref_w
    )


def combined_pref_carry(tables: "TermTables"):
    """Per-(row, class) commit increment for the combined state."""
    return (
        HARD_POD_AFFINITY_WEIGHT * tables.carry_aff_req
        + tables.carry_aff_pref_w
    )


def _selector_key(selector) -> str:
    return json.dumps(selector, sort_keys=True, default=str)


@dataclass
class _Row:
    selector: Optional[dict]
    namespaces: frozenset
    topo_key: str

    def matches_pod(self, pod: dict) -> bool:
        meta = pod.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        if ns not in self.namespaces:
            return False
        return lbl.match_labels_selector(self.selector, meta.get("labels") or {})


@dataclass
class TermTables:
    t: int  # term rows
    v: int  # topology-value space
    a: int  # required-affinity group rows
    ch: int  # hard spread constraint instances
    cs: int  # soft spread constraint instances
    rmax: int  # max relevant rows per class
    gmax: int  # max group rows per class
    hmax: int  # max hard spread rows per class
    smax: int  # max soft spread rows per class

    topo_val: np.ndarray  # [T, N] i32 (-1 = key missing)
    # per-class statics
    match: np.ndarray  # [T, U] bool
    carry_anti_req: np.ndarray  # [T, U] i64
    carry_aff_req: np.ndarray  # [T, U] i64
    carry_aff_pref_w: np.ndarray  # [T, U] i64
    carry_anti_pref_w: np.ndarray  # [T, U] i64
    cls_rows: np.ndarray  # [U, Rmax] i32 (-1 pad): rows relevant to class
    # required-affinity groups
    group_rows: np.ndarray  # [A] i32 -> term row
    group_of_row: np.ndarray  # [A] i32 -> group id
    match_all: np.ndarray  # [Gn, U] bool: class matches ALL terms of group
    cls_group_rows: np.ndarray  # [U, Gmax] i32 (-1 pad): A-rows of class's group
    cls_group_id: np.ndarray  # [U] i32 (-1 = no required affinity)
    # hard topology spread
    h_row: np.ndarray  # [Ch] i32 -> term row (selector counts)
    h_self: np.ndarray  # [Ch, U] bool (pod matches own constraint selector)
    h_max_skew: np.ndarray  # [Ch] i64
    h_cand_nodes: np.ndarray  # [Ch, N] bool (candidate nodes; values derive in-step)
    cls_h_rows: np.ndarray  # [U, Hmax] i32 (-1 pad)
    # soft topology spread
    s_row: np.ndarray  # [Cs] i32 -> term row
    s_is_host: np.ndarray  # [Cs] bool
    s_max_skew: np.ndarray  # [Cs] i64
    s_q: np.ndarray  # [Cs, N] bool (qualifying nodes for counting)
    cls_s_rows: np.ndarray  # [U, Smax] i32 (-1 pad)
    cls_s_haskeys: np.ndarray  # [U, N] bool (node has ALL soft keys of class)
    # initial counts (existing cluster pods)
    init_tgt: np.ndarray  # [T, V]
    init_own_anti_req: np.ndarray  # [T, V]
    init_own_aff_req: np.ndarray  # [T, V]
    init_own_aff_pref_w: np.ndarray  # [T, V]
    init_own_anti_pref_w: np.ndarray  # [T, V]
    init_group_counts: np.ndarray  # [A, V]
    init_soft_counts: np.ndarray  # [Cs, V]


class _TableBuilder:
    def __init__(self, nodes: List[dict]):
        self.nodes = nodes
        self.rows: List[_Row] = []
        self.row_ids: Dict[str, int] = {}
        self.key_vocab: Dict[str, Dict[str, int]] = {}
        self.has_hostname = False

    def row(self, selector, namespaces: frozenset, topo_key: str) -> int:
        key = f"{_selector_key(selector)}|{sorted(namespaces)}|{topo_key}"
        if key not in self.row_ids:
            self.row_ids[key] = len(self.rows)
            self.rows.append(_Row(selector, namespaces, topo_key))
            if topo_key == HOSTNAME_KEY:
                self.has_hostname = True
        return self.row_ids[key]

    def value_id(self, topo_key: str, value: str, node_idx: int) -> int:
        if topo_key == HOSTNAME_KEY:
            return node_idx
        vocab = self.key_vocab.setdefault(topo_key, {})
        if value not in vocab:
            vocab[value] = len(vocab)
        return vocab[value]


def _pod_terms(pod: dict):
    """All four term categories of a pod, as resolved AffinityTerms."""
    return (
        lbl.resolve_affinity_terms(
            pod, "podAffinity", "requiredDuringSchedulingIgnoredDuringExecution"
        ),
        lbl.resolve_affinity_terms(
            pod, "podAntiAffinity", "requiredDuringSchedulingIgnoredDuringExecution"
        ),
        lbl.resolve_affinity_terms(
            pod, "podAffinity", "preferredDuringSchedulingIgnoredDuringExecution"
        ),
        lbl.resolve_affinity_terms(
            pod, "podAntiAffinity", "preferredDuringSchedulingIgnoredDuringExecution"
        ),
    )


def _spread_constraints(pod: dict, mode: str) -> list:
    out = []
    ns = (pod.get("metadata") or {}).get("namespace") or "default"
    for c in (pod.get("spec") or {}).get("topologySpreadConstraints") or []:
        when = c.get("whenUnsatisfiable", "DoNotSchedule")
        if when != mode:
            continue
        out.append(
            {
                "selector": c.get("labelSelector"),
                "ns": frozenset([ns]),
                "key": c.get("topologyKey", ""),
                "max_skew": int(c.get("maxSkew", 1)),
            }
        )
    return out


def _count_rows(term_rows, spreads, match, preferred, carried) -> None:
    """One request's term rows by the kind of term that names them (a
    row two kinds name counts under both) and its classes with a
    non-empty InterPodAffinity score: those with preferred terms (a
    [T, U] weight of `preferred` set), and those a row matches on which
    some pod carries a required affinity or a preferred term (a [T, *]
    entry of `carried` set) (utils/trace.py COUNTERS)."""
    kinds = [set(), set(), set()]  # required affinity, required anti, preferred
    for aff, anti, paff, panti in term_rows:
        kinds[0].update(aff)
        kinds[1].update(anti)
        kinds[2].update(paff + panti)
    spread = {c["row"] for cs in spreads for c in cs}
    scoring_rows = np.any([(x != 0).any(axis=1) for x in carried], axis=0)
    scored = (np.any([(x != 0).any(axis=0) for x in preferred], axis=0)
              | (match & scoring_rows[:, None]).any(axis=0))
    for name, n in (("affinity", len(kinds[0])), ("anti", len(kinds[1])),
                    ("preferred", len(kinds[2])), ("spread", len(spread))):
        COUNTERS.inc(f"terms_rows_{name}_total", n)
    COUNTERS.inc("terms_scored_classes_total", int(scored.sum()))


def build_term_tables(oracle, class_pods: List[dict], profiles=None) -> TermTables:
    """Construct the tables from the batch classes + existing pods.

    class_pods: one representative pod dict per class.
    profiles: optional (node_class_of, rep_idx) from ops/profiles.py,
    to share the node-profile dedup with encode_batch.
    """
    nodes = [ns.node for ns in oracle.nodes]
    n = len(nodes)
    u = len(class_pods)
    b = _TableBuilder(nodes)

    # -- discover rows from batch classes and existing pods ---------------
    cls_terms = [_pod_terms(p) for p in class_pods]
    existing_pods = [(p, ns.index) for ns in oracle.nodes for p in ns.pods]
    ex_terms = [_pod_terms(p) for p, _ in existing_pods]

    def rows_for(terms) -> List[List[int]]:
        return [[b.row(t.selector, t.namespaces, t.topology_key) for t in cat] for cat in terms]

    cls_term_rows = [rows_for(terms) for terms in cls_terms]
    ex_term_rows = [rows_for(terms) for terms in ex_terms]

    cls_hard = [_spread_constraints(p, "DoNotSchedule") for p in class_pods]
    cls_soft = [_spread_constraints(p, "ScheduleAnyway") for p in class_pods]
    for cs in cls_hard + cls_soft:
        for c in cs:
            c["row"] = b.row(c["selector"], c["ns"], c["key"])

    # -- topology values ---------------------------------------------------
    # one pass per distinct topology key (not per row): nodes are read
    # once per key, rows sharing the key share the value column
    node_labels = [((node.get("metadata") or {}).get("labels") or {}) for node in nodes]
    key_vals: Dict[str, np.ndarray] = {}
    for row in b.rows:
        if row.topo_key in key_vals:
            continue
        vals = np.full(n, -1, dtype=np.int32)
        for n_i, labels in enumerate(node_labels):
            if row.topo_key in labels:
                vals[n_i] = b.value_id(row.topo_key, labels[row.topo_key], n_i)
        key_vals[row.topo_key] = vals
    t = max(len(b.rows), 1)
    v_vocab = max((len(vv) for vv in b.key_vocab.values()), default=0)
    v = max(v_vocab, n if b.has_hostname else 0, 1)

    topo_val = np.full((t, n), -1, dtype=np.int32)
    for t_i, row in enumerate(b.rows):
        topo_val[t_i] = key_vals[row.topo_key]

    # -- per-class match/carry --------------------------------------------
    match = np.zeros((t, u), dtype=bool)
    carry_anti_req = np.zeros((t, u), dtype=np.int64)
    carry_aff_req = np.zeros((t, u), dtype=np.int64)
    carry_aff_pref_w = np.zeros((t, u), dtype=np.int64)
    carry_anti_pref_w = np.zeros((t, u), dtype=np.int64)
    for u_i, pod in enumerate(class_pods):
        for t_i, row in enumerate(b.rows):
            match[t_i, u_i] = row.matches_pod(pod)
        aff_req, anti_req, aff_pref, anti_pref = cls_terms[u_i]
        r_aff, r_anti, r_paff, r_panti = cls_term_rows[u_i]
        for term, r in zip(aff_req, r_aff):
            carry_aff_req[r, u_i] += 1
        for term, r in zip(anti_req, r_anti):
            carry_anti_req[r, u_i] += 1
        for term, r in zip(aff_pref, r_paff):
            carry_aff_pref_w[r, u_i] += term.weight
        for term, r in zip(anti_pref, r_panti):
            carry_anti_pref_w[r, u_i] += term.weight

    # relevant rows per class: any carried term or any selector match
    relevant = (
        match
        | (carry_anti_req > 0)
        | (carry_aff_req > 0)
        | (carry_aff_pref_w != 0)
        | (carry_anti_pref_w != 0)
    )
    rmax = max(int(relevant.sum(axis=0).max()) if u else 0, 1)
    cls_rows = np.full((u, rmax), -1, dtype=np.int32)
    for u_i in range(u):
        idx = np.nonzero(relevant[:, u_i])[0]
        cls_rows[u_i, : len(idx)] = idx

    # -- required-affinity groups -----------------------------------------
    group_keys: Dict[tuple, int] = {}
    group_rows_list: List[int] = []
    group_of_row_list: List[int] = []
    cls_group_id = np.full(u, -1, dtype=np.int32)
    groups_terms: List[list] = []
    for u_i, pod in enumerate(class_pods):
        aff_req = cls_terms[u_i][0]
        if not aff_req:
            continue
        gk = tuple(sorted(cls_term_rows[u_i][0]))
        if gk not in group_keys:
            group_keys[gk] = len(group_keys)
            groups_terms.append(aff_req)
            for r in cls_term_rows[u_i][0]:
                group_rows_list.append(r)
                group_of_row_list.append(group_keys[gk])
        cls_group_id[u_i] = group_keys[gk]
    gn = max(len(group_keys), 1)
    a = max(len(group_rows_list), 1)
    group_rows = np.zeros(a, dtype=np.int32)
    group_of_row = np.zeros(a, dtype=np.int32)
    for i, (r, g) in enumerate(zip(group_rows_list, group_of_row_list)):
        group_rows[i] = r
        group_of_row[i] = g
    match_all = np.zeros((gn, u), dtype=bool)
    for gk, g_i in group_keys.items():
        terms = groups_terms[g_i]
        for u_i, pod in enumerate(class_pods):
            match_all[g_i, u_i] = all(term.matches_pod(pod) for term in terms)
    gmax = max((int((group_of_row == g).sum()) for g in range(gn)), default=1)
    gmax = max(gmax, 1)
    cls_group_rows = np.full((u, gmax), -1, dtype=np.int32)
    for u_i in range(u):
        g = cls_group_id[u_i]
        if g < 0:
            continue
        idx = np.nonzero(group_of_row == g)[0]
        cls_group_rows[u_i, : len(idx)] = idx

    # -- per-class node masks (profile-deduplicated) ----------------------
    # selector/affinity match and topo-key presence run once per node
    # profile and scatter to [N] (ops/profiles.py)
    from .profiles import node_profiles, uses_match_fields

    if profiles is not None:
        prof_of, prof_reps = profiles
    else:
        prof_of, prof_reps = node_profiles(nodes, class_pods)
    _match_cache: Dict[int, np.ndarray] = {}

    def _sel_match_mask(u_i: int) -> np.ndarray:
        """bool[N]: nodes passing the class's nodeSelector + required
        node affinity (filtering.go:231-247 candidate filtering)."""
        m = _match_cache.get(u_i)
        if m is not None:
            return m
        spec = class_pods[u_i].get("spec") or {}
        if uses_match_fields(spec):
            m = np.fromiter(
                (lbl.pod_matches_node_selector_and_affinity(spec, node) for node in nodes),
                bool,
                n,
            )
        else:
            ok = np.fromiter(
                (
                    lbl.pod_matches_node_selector_and_affinity(spec, nodes[int(r)])
                    for r in prof_reps
                ),
                bool,
                len(prof_reps),
            )
            m = ok[prof_of]
        _match_cache[u_i] = m
        return m

    def _haskeys_mask(constraints: list) -> np.ndarray:
        """bool[N]: node has every constraint's topology key."""
        keys = [c["key"] for c in constraints]
        ok = np.fromiter(
            (all(k in node_labels[int(r)] for k in keys) for r in prof_reps),
            bool,
            len(prof_reps),
        )
        return ok[prof_of]

    # -- hard spread constraint instances ---------------------------------
    h_entries: Dict[tuple, int] = {}
    h_list: List[dict] = []
    cls_h: List[List[int]] = [[] for _ in range(u)]
    for u_i, constraints in enumerate(cls_hard):
        if not constraints:
            continue
        # candidate nodes: pass pod's nodeSelector/affinity AND have
        # every constraint key (filtering.go:231-247)
        cand_mask = _sel_match_mask(u_i) & _haskeys_mask(constraints)
        cand_nodes = np.nonzero(cand_mask)[0]
        for c in constraints:
            key = (
                c["row"],
                c["max_skew"],
                cand_mask.tobytes(),
                _selector_key(c["selector"]),
            )
            if key not in h_entries:
                h_entries[key] = len(h_list)
                h_list.append({**c, "cand_nodes": cand_nodes})
            cls_h[u_i].append(h_entries[key])
    ch = max(len(h_list), 1)
    h_row = np.zeros(ch, dtype=np.int32)
    h_max_skew = np.ones(ch, dtype=np.int64)
    h_cand_nodes = np.zeros((ch, n), dtype=bool)
    h_self = np.zeros((ch, u), dtype=bool)
    for c_i, c in enumerate(h_list):
        h_row[c_i] = c["row"]
        h_max_skew[c_i] = c["max_skew"]
        for n_i in c["cand_nodes"]:
            h_cand_nodes[c_i, n_i] = True
        row = b.rows[c["row"]]
        for u_i, pod in enumerate(class_pods):
            h_self[c_i, u_i] = row.matches_pod(pod)
    hmax = max((len(x) for x in cls_h), default=1)
    hmax = max(hmax, 1)
    cls_h_rows = np.full((u, hmax), -1, dtype=np.int32)
    for u_i, lst in enumerate(cls_h):
        cls_h_rows[u_i, : len(lst)] = lst

    # -- soft spread constraint instances ---------------------------------
    s_entries: Dict[tuple, int] = {}
    s_list: List[dict] = []
    cls_s: List[List[int]] = [[] for _ in range(u)]
    cls_s_haskeys = np.ones((u, n), dtype=bool)
    for u_i, constraints in enumerate(cls_soft):
        if not constraints:
            continue
        # qualifying nodes for counting (scoring.go processAllNode):
        # nodeSelector/affinity AND all soft keys present
        haskeys = _haskeys_mask(constraints)
        cls_s_haskeys[u_i] = haskeys
        q = haskeys & _sel_match_mask(u_i)
        for c in constraints:
            key = (c["row"], c["max_skew"], q.tobytes())
            if key not in s_entries:
                s_entries[key] = len(s_list)
                s_list.append({**c, "q": q.copy()})
            cls_s[u_i].append(s_entries[key])
    cs = max(len(s_list), 1)
    s_row = np.zeros(cs, dtype=np.int32)
    s_is_host = np.zeros(cs, dtype=bool)
    s_max_skew = np.ones(cs, dtype=np.int64)
    s_q = np.zeros((cs, n), dtype=bool)
    for c_i, c in enumerate(s_list):
        s_row[c_i] = c["row"]
        s_is_host[c_i] = c["key"] == HOSTNAME_KEY
        s_max_skew[c_i] = c["max_skew"]
        s_q[c_i] = c["q"]
    smax = max((len(x) for x in cls_s), default=1)
    smax = max(smax, 1)
    cls_s_rows = np.full((u, smax), -1, dtype=np.int32)
    for u_i, lst in enumerate(cls_s):
        cls_s_rows[u_i, : len(lst)] = lst

    # -- initial counts from existing pods --------------------------------
    init_tgt = np.zeros((t, v), dtype=np.int64)
    init_own_anti_req = np.zeros((t, v), dtype=np.int64)
    init_own_aff_req = np.zeros((t, v), dtype=np.int64)
    init_own_aff_pref_w = np.zeros((t, v), dtype=np.int64)
    init_own_anti_pref_w = np.zeros((t, v), dtype=np.int64)
    init_group_counts = np.zeros((a, v), dtype=np.int64)
    init_soft_counts = np.zeros((cs, v), dtype=np.int64)
    for (pod, n_i), terms, term_rows in zip(existing_pods, ex_terms, ex_term_rows):
        for t_i, row in enumerate(b.rows):
            if row.matches_pod(pod):
                val = topo_val[t_i, n_i]
                if val >= 0:
                    init_tgt[t_i, val] += 1
        aff_req, anti_req, aff_pref, anti_pref = terms
        r_aff, r_anti, r_paff, r_panti = term_rows
        for term, r in zip(aff_req, r_aff):
            val = topo_val[r, n_i]
            if val >= 0:
                init_own_aff_req[r, val] += 1
        for term, r in zip(anti_req, r_anti):
            val = topo_val[r, n_i]
            if val >= 0:
                init_own_anti_req[r, val] += 1
        for term, r in zip(aff_pref, r_paff):
            val = topo_val[r, n_i]
            if val >= 0:
                init_own_aff_pref_w[r, val] += term.weight
        for term, r in zip(anti_pref, r_panti):
            val = topo_val[r, n_i]
            if val >= 0:
                init_own_anti_pref_w[r, val] += term.weight
        for a_i in range(len(group_rows_list)):
            g_i = group_of_row_list[a_i]
            # group counting: pod must match ALL terms of the group
            if all(term.matches_pod(pod) for term in groups_terms[g_i]):
                r = group_rows_list[a_i]
                val = topo_val[r, n_i]
                if val >= 0:
                    init_group_counts[a_i, val] += 1
        for c_i, c in enumerate(s_list):
            if c["q"][n_i]:
                row = b.rows[c["row"]]
                if row.matches_pod(pod):
                    val = topo_val[c["row"], n_i]
                    if val >= 0:
                        init_soft_counts[c_i, val] += 1

    _count_rows(cls_term_rows + ex_term_rows, cls_hard + cls_soft, match,
                preferred=(carry_aff_pref_w, carry_anti_pref_w),
                carried=(carry_aff_req, carry_aff_pref_w, carry_anti_pref_w,
                         init_own_aff_req, init_own_aff_pref_w, init_own_anti_pref_w))
    return TermTables(
        t=t,
        v=v,
        a=a,
        ch=ch,
        cs=cs,
        rmax=rmax,
        gmax=gmax,
        hmax=hmax,
        smax=smax,
        topo_val=topo_val,
        match=match,
        carry_anti_req=carry_anti_req,
        carry_aff_req=carry_aff_req,
        carry_aff_pref_w=carry_aff_pref_w,
        carry_anti_pref_w=carry_anti_pref_w,
        cls_rows=cls_rows,
        group_rows=group_rows,
        group_of_row=group_of_row,
        match_all=match_all,
        cls_group_rows=cls_group_rows,
        cls_group_id=cls_group_id,
        h_row=h_row,
        h_self=h_self,
        h_max_skew=h_max_skew,
        h_cand_nodes=h_cand_nodes,
        cls_h_rows=cls_h_rows,
        s_row=s_row,
        s_is_host=s_is_host,
        s_max_skew=s_max_skew,
        s_q=s_q,
        cls_s_rows=cls_s_rows,
        cls_s_haskeys=cls_s_haskeys,
        init_tgt=init_tgt,
        init_own_anti_req=init_own_anti_req,
        init_own_aff_req=init_own_aff_req,
        init_own_aff_pref_w=init_own_aff_pref_w,
        init_own_anti_pref_w=init_own_anti_pref_w,
        init_group_counts=init_group_counts,
        init_soft_counts=init_soft_counts,
    )
