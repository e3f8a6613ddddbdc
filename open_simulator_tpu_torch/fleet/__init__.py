"""Failover for the serve daemon: snapshot-then-suffix bootstrap of a
replacement (``replay``), the port's copy of the JAX package's
``fleet/replay.py``. ``simon serve --replay-snapshot`` and the twin's
restore walk (twin/mirror.py ``replay_mirror_journal``) run it. The
rest of the JAX package's ``fleet/`` — the consistent-hash router,
supervised replicas and the failover audit behind ``simon fleet`` — is
not ported yet (ROADMAP.md A10).
"""

from .replay import read_session_events, replay_into_session, restore_into_session  # noqa: F401
