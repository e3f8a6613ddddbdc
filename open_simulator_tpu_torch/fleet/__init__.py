"""N-replica serve fleet of the GPU port: consistent-hash routing,
replica supervision, and journal-replay failover (the port's copy of
the JAX package's ``fleet/``, public names kept).

- ``hashing``  — slot-affine consistent-hash ring (tenant-affine
  routing; a replacement replica inherits its slot, so failover moves
  ZERO keys).
- ``replica``  — supervised port ``simon serve`` subprocesses: spawn,
  /healthz probing, restart-with-backoff, slot lock files that refuse
  split-brain double-spawns. Each replica runs its ticks (one
  batch-kernel launch each) and committed scans on the card unless
  ``--device cpu`` is passed through.
- ``replay``   — bootstrap a replacement session from the dead
  replica's checkpoint and cluster-delta journal, torn tail tolerated,
  interior damage refused loudly (``simon serve --replay-snapshot``).
- ``audit``    — the fsync'd failover timeline (probe_flap ->
  declared_dead -> lock_reclaim -> respawn -> replay_progress ->
  first_200) and its validator.
- ``trace``    — one stitched span tree per routed request, from the
  router's spans and the answering replica's.
- ``router``   — the HTTP router daemon behind ``simon fleet``:
  failover reroutes carry their ORIGINAL request IDs (429/503 +
  Retry-After when saturated, never silent drops), fleet-aggregated
  /metrics with cardinality-bounded per-replica labels (the port's
  nvcc builds and launches among them), fleet /healthz + telemetry for
  ``simon top --fleet``.

The replicas share one kernel-library store (incremental/store.py):
the first fills it, the rest and every replacement load from it and
run no nvcc. Injection seams ``fleet.route``, ``fleet.probe``,
``fleet.replay``, ``fleet.spawn`` join the runtime/inject.py grammar.
"""

from .hashing import HashRing  # noqa: F401
from .replay import read_session_events, replay_into_session, restore_into_session  # noqa: F401
from .replica import DoubleSpawnError, ReplicaProcess, SlotLock  # noqa: F401
from .router import FleetRouter, render_fleet_metrics  # noqa: F401
