"""`simon twin` — the live digital twin (the port's copy of the JAX
package's twin/).

One resident process that continuously mirrors a cluster and answers
anything against LIVE state: the shadow tailer's ingest
(shadow/ingest.py), the serve daemon's warm sessions, and the
timeline's forward stepping, fused on one substrate — the typed
``ClusterDelta`` vocabulary and its incremental applicator
(``deltas``). ``mirror`` tails a feed or a live cluster through the
shadow replayer, ``queries`` answers what-if, drain, N+K and forecast
questions (one kernel launch a what-if, drain or N+K trial, one
pins-first launch a forecast window on the card), ``server`` is the
HTTP daemon behind ``simon twin``.
"""

from .deltas import (  # noqa: F401
    APPLIED,
    DELTA_KINDS,
    RELOADED,
    SKIPPED,
    ClusterDelta,
    MirrorApplicator,
    cold_reload,
    deltas_to_events,
    from_shadow_op,
    materialize,
    state_dict,
    steps_to_deltas,
)
