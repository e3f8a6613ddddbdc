"""The scope of a request's cyclic garbage collection.

A request (`simon apply`, a capacity plan) allocates hundreds of
thousands of short-lived objects and frees nearly all of them through
their reference counts; the few dozen cycles it makes are the only
work it leaves the cyclic collector. A full collection to find them
walks the process's whole long-lived heap (torch's and the port's
modules, some 170,000 objects), and, while the answer is alive, every
object of the answer too.

`collection_scope()` holds the collector off for the scope, so all the
scope allocates stays in the youngest generation, and closes with one
collection of the young generations only: every cycle the scope made,
and nothing of the old heap. A scope entered while the collector is
already off (an outer scope, or a caller that paused it) neither
collects nor turns the collector back on, so the outermost scope
collects once, after what it encloses has released what it can.
"""

from __future__ import annotations

import gc
from contextlib import contextmanager

from .trace import COUNTERS, phase

# gc.collect(1) collects generations 0 and 1: what the scope allocated
# (all in generation 0, with the collector off) and the young objects
# from before it; survivors move to the old generation
YOUNG = 1


@contextmanager
def collection_scope():
    """Hold the cyclic collector off for the block; on leaving it, if
    this scope turned the collector off, collect the young generations
    once (the phase `apply/gc`) and turn the collector back on.

    Counts `gc_request_collections_total:<generation>` and what those
    collections found unreachable, `gc_request_unreachable_total`."""
    if not gc.isenabled():
        yield
        return
    gc.disable()
    try:
        yield
    finally:
        try:
            with phase("apply/gc"):
                found = gc.collect(YOUNG)
            COUNTERS.inc(f"gc_request_collections_total:{YOUNG}")
            COUNTERS.inc("gc_request_unreachable_total", found)
        finally:
            gc.enable()
