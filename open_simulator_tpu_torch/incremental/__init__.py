"""Incremental execution: delta re-simulation over the committed
placement journal (``resim.py``).

A warm serve session keeps its cluster pods COMMITTED in a resident
oracle (the "committed scan"), so a what-if request launches only its
own few pods (the suffix) instead of re-scanning the whole roster, and a
``/v1/cluster-delta`` re-simulates only the journal suffix its
conservative dependency rule says could change — placements stay
identical to a full re-scan.

The port's copy of the JAX package's ``incremental/``. Its artifact
store (``store.py``) is not ported yet (ROADMAP.md A8).
"""

from .resim import CommittedScan, SuffixDecision, own_pod, suffix_for_delta  # noqa: F401
