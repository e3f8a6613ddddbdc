"""The cluster-delta substrate of the digital twin (twin/deltas.py).

The typed ``ClusterDelta`` vocabulary and its incremental applicator,
shared by the shadow replayer (shadow/replay.py) and the timeline's
event stream (``deltas_to_events``). The twin daemon itself (mirror,
queries, server) is not ported yet (ROADMAP.md A9).
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
