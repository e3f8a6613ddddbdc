"""Incremental execution: delta re-simulation over the committed
placement journal (``resim.py``) and cold starts without nvcc
(``store.py``).

- ``resim.py`` — a warm serve session keeps its cluster pods COMMITTED
  in a resident oracle (the "committed scan"), so a what-if request
  launches only its own few pods (the suffix) instead of re-scanning the
  whole roster, and a ``/v1/cluster-delta`` re-simulates only the
  journal suffix its conservative dependency rule says could change —
  placements stay identical to a full re-scan.
- ``store.py`` — a persistent, content-addressed store of the built
  kernel libraries, keyed by source and toolchain: a fresh ``simon
  serve`` / ``simon twin`` pointed at a warm store answers its first
  request with zero nvcc builds; stale, corrupt or wrong-toolchain
  entries are refused loudly and rebuilt.

The port's copy of the JAX package's ``incremental/``.
"""

from .resim import CommittedScan, SuffixDecision, own_pod, suffix_for_delta  # noqa: F401
from .store import (  # noqa: F401
    ArtifactStore,
    aot_store_block,
    configure_store,
    current_store,
    incremental_block,
)
