"""Cross-process trace stitching: one span tree per fleet request (the
port's copy of the JAX package's fleet/trace.py).

A request forwarded by the fleet router produces spans in TWO
processes with TWO independent id spaces and clock epochs: the router
records ``fleet/request`` -> ``fleet/forward`` (plus ``fleet/reroute``
siblings for failed attempts and a ``fleet/shed`` leaf on
exhaustion), and the replica that answered records its own
``serve/request`` subtree (queue_wait / evaluate — serve/coalescer.py)
carrying the router's forward-span id as a ``remote_parent``
ATTRIBUTE (propagated in ``X-Simon-Trace-Context``; span ids are
process-local so a remote id can never be a structural parent).

This module is the collector that makes those halves ONE tree:

- ``fetch_replica_spans`` drains a replica's span ring through its
  existing ``POST /debug/dump`` surface (no new replica endpoint, no
  extra work on the request hot path);
- ``stitch_request_trace`` is the pure core: select both sides'
  spans for one request id, remap every span into one fresh id
  space, attach each replica ``serve/request`` root under the router
  ``fleet/forward`` span whose id it names (and whose slot matches
  the dump it came from — the slot check keeps a shared-recorder
  test double from stitching the same subtree twice), and re-base
  replica timestamps into the router's clock domain;
- ``trace_endpoint`` serves ``GET /v1/fleet/trace?requestId=...`` on
  the router: a Chrome-trace-exportable document (``traceEvents``
  with ``args.span_id``/``args.parent_id``) that
  ``tools/validate_trace.py`` validates unchanged.

Reroutes and failovers are visible BY CONSTRUCTION: every attempt —
the failed forward, the reroute marker, the answering forward — is a
sibling under the same ``fleet/request`` root.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from ..obs.spans import RECORDER

#: spans fetched per replica dump — mirrors telemetry.DUMP_MAX_SPANS;
#: the stitcher reads the dump's inline event list, never the full ring
FETCH_TIMEOUT_S = 10.0


def _rid_of(event: dict) -> Optional[str]:
    attrs = event.get("attrs")
    return attrs.get("request_id") if isinstance(attrs, dict) else None


def fetch_replica_spans(
    url: str, timeout_s: float = FETCH_TIMEOUT_S
) -> List[dict]:
    """One replica's recorded span events (``as_dict`` shape) via its
    ``POST /debug/dump`` endpoint. Raises OSError/URLError on an
    unreachable replica — the caller decides whether a missing dump
    degrades or fails the stitch."""
    req = urllib.request.Request(
        url + "/debug/dump", data=b"", method="POST"
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        doc = json.loads(resp.read().decode("utf-8"))
    spans = doc.get("spans") if isinstance(doc, dict) else None
    events = spans.get("events") if isinstance(spans, dict) else None
    return [e for e in (events or []) if isinstance(e, dict)]


def stitch_request_trace(
    rid: str,
    router_events: List[dict],
    replica_events_by_slot: Dict[str, List[dict]],
) -> List[dict]:
    """One request's stitched span forest as a list of plain dicts
    ``{id, parent, name, t0, t1, tid, pid, attrs}`` in ONE id space
    and the ROUTER'S clock domain. Pure: feed it recorded events from
    any source (live dumps, test recorders, archived dumps)."""
    fresh = 0
    out: List[dict] = []

    def emit(event, parent, t_offset, pid):
        nonlocal fresh
        fresh += 1
        attrs = dict(event.get("attrs") or {})
        out.append(
            {
                "id": fresh,
                "parent": parent,
                "name": event.get("name", "?"),
                "t0": float(event.get("t0", 0.0)) + t_offset,
                "t1": float(event.get("t1", 0.0)) + t_offset,
                "tid": event.get("tid", 0),
                "pid": pid,
                "attrs": attrs,
            }
        )
        return fresh

    # -- router side: the fleet/* spans recorded for this request
    r_events = [
        e
        for e in router_events
        if _rid_of(e) == rid and str(e.get("name", "")).startswith("fleet/")
    ]
    r_ids = {e.get("id") for e in r_events}
    children: Dict[Optional[int], List[dict]] = {}
    for e in r_events:
        parent = e.get("parent")
        children.setdefault(parent if parent in r_ids else None, []).append(e)
    # old forward-span id -> (new id, slot, new-domain t0): what a
    # replica root's remote_parent attr resolves against
    forwards: Dict[int, tuple] = {}

    def walk(event, parent_new):
        nid = emit(event, parent_new, 0.0, pid=0)
        if event.get("name") == "fleet/forward":
            attrs = event.get("attrs") or {}
            forwards[event.get("id")] = (
                nid,
                str(attrs.get("slot", "")),
                float(event.get("t0", 0.0)),
            )
        for child in sorted(
            children.get(event.get("id"), []),
            key=lambda c: float(c.get("t0", 0.0)),
        ):
            walk(child, nid)

    roots = sorted(
        children.get(None, []), key=lambda e: float(e.get("t0", 0.0))
    )
    for root in roots:
        walk(root, None)

    # -- replica side: serve/request roots naming one of our forwards
    for slot in sorted(replica_events_by_slot):
        events = [
            e
            for e in replica_events_by_slot[slot]
            if _rid_of(e) == rid
            and str(e.get("name", "")).startswith("serve/")
        ]
        ids = {e.get("id") for e in events}
        kids: Dict[int, List[dict]] = {}
        for e in events:
            parent = e.get("parent")
            if parent in ids:
                kids.setdefault(parent, []).append(e)
        for root in events:
            if root.get("name") != "serve/request":
                continue
            if (root.get("parent") in ids):
                continue  # nested under another serve span: not a root
            remote = (root.get("attrs") or {}).get("remote_parent")
            match = forwards.get(remote)
            if match is None or match[1] != slot:
                # not stitched by THIS router's forwards (a direct
                # request, or — shared-recorder double — a dump that
                # also contains the other slot's spans)
                continue
            fwd_new, _, fwd_t0 = match
            # re-base into the router's clock domain: the replica
            # subtree starts where its forward span started (span
            # NESTING is structural via parent ids; the time shift
            # only makes the Chrome rendering sensible)
            offset = fwd_t0 - float(root.get("t0", 0.0))
            pid = 1 + sorted(replica_events_by_slot).index(slot)

            def walk_replica(event, parent_new):
                nid = emit(event, parent_new, offset, pid)
                for child in sorted(
                    kids.get(event.get("id"), []),
                    key=lambda c: float(c.get("t0", 0.0)),
                ):
                    walk_replica(child, nid)

            walk_replica(root, fwd_new)
    return out


def chrome_trace_doc(stitched: List[dict], rid: str) -> dict:
    """A Chrome trace-event document of one stitched request tree —
    the exact shape ``tools/validate_trace.py`` checks (``X`` events,
    microsecond ts, span/parent ids in ``args``)."""
    events = []
    for s in stitched:
        args = {"span_id": s["id"], "parent_id": s["parent"]}
        args.update(
            {k: v for k, v in (s.get("attrs") or {}).items() if v is not None}
        )
        events.append(
            {
                "name": s["name"],
                "ph": "X",
                "ts": round(s["t0"] * 1e6, 3),
                "dur": round(max(s["t1"] - s["t0"], 0.0) * 1e6, 3),
                "pid": s.get("pid", 0),
                "tid": s.get("tid", 0),
                "args": args,
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "simonFleetTrace": {"requestId": rid, "spans": len(events)},
    }


def collect_request_trace(
    router, rid: str, timeout_s: float = FETCH_TIMEOUT_S
) -> dict:
    """Stitch one request's trace from the LIVE fleet: the router's
    own recorder plus a span drain of every reachable replica. An
    unreachable replica degrades to a router-only tree (its absence
    is visible as a forward span with no serve subtree), it never
    fails the collection."""
    router_events = [s.as_dict() for s in RECORDER.snapshot()]
    replica_events: Dict[str, List[dict]] = {}
    for slot in sorted(router.replicas):
        replica = router.replicas[slot]
        if not replica.url or router._health.get(slot) == "down":
            continue
        try:
            replica_events[slot] = fetch_replica_spans(
                replica.url, timeout_s=timeout_s
            )
        except (OSError, urllib.error.URLError, ValueError):
            continue
    stitched = stitch_request_trace(rid, router_events, replica_events)
    return chrome_trace_doc(stitched, rid)


def trace_endpoint(router, path: str) -> tuple:
    """GET /v1/fleet/trace handler body: ``requestId`` query param
    selects the request; answers the stitched Chrome trace document,
    404 when no span on either side carries that id. Returns
    ``(status, payload dict)``."""
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    rids = q.get("requestId") or []
    if not rids:
        return 400, {"error": "missing requestId query parameter"}
    from ..obs.telemetry import sanitize_request_id

    rid = sanitize_request_id(rids[-1])
    if not rid:
        return 400, {"error": "empty requestId"}
    doc = collect_request_trace(router, rid)
    if not doc["traceEvents"]:
        return 404, {
            "error": f"no spans recorded for request id {rid!r} "
            "(expired from the ring, or never routed here)"
        }
    return 200, doc
