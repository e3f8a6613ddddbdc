"""`simon serve`: the long-lived what-if scheduling daemon.

Three layers (docs/SERVING.md):

- ``session``  — one warm loaded cluster; answers request batches as
  scenario rows of one launch of the batch kernel (B6) on the card,
  byte-identical to standalone ``simulate()`` runs
- ``coalescer`` — bounded queue + single dispatcher thread draining up
  to ``max_batch`` requests per tick (micro-batching), deadline sheds,
  drain-on-shutdown
- ``server`` — JSON-over-HTTP surface (``POST /v1/simulate``,
  ``GET /healthz``, ``GET /metrics``), SIGTERM drain lifecycle

The port's copy of the JAX package's ``serve/``.
"""

from .coalescer import Coalescer, PendingRequest, partial_body
from .server import ServeDaemon, parse_request_body, render_metrics
from .session import Session, WhatIfReply, WhatIfRequest, result_payload

__all__ = [
    "Coalescer",
    "PendingRequest",
    "partial_body",
    "ServeDaemon",
    "parse_request_body",
    "render_metrics",
    "Session",
    "WhatIfReply",
    "WhatIfRequest",
    "result_payload",
]
