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
and nothing of the old heap. Only a thread's outermost scope closes: it
first drops the identity memos' strong references to the request's
object graph (utils/memo.py `clear_all_memos`), then collects, once,
after what it encloses has released what it can. A scope nested in
another does neither, and a scope entered while the collector is
already off (a caller that paused it) clears the memos but neither
collects nor turns the collector back on.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

from .memo import clear_all_memos
from .trace import COUNTERS, phase

# gc.collect(1) collects generations 0 and 1: what the scope allocated
# (all in generation 0, with the collector off) and the young objects
# from before it; survivors move to the old generation
YOUNG = 1

# how deep each thread is in collection scopes
_DEPTH = threading.local()


@contextmanager
def collection_scope(name: str = "apply/gc", clear_memos: bool = True):
    """Hold the cyclic collector off for the block; on leaving the
    thread's outermost scope, clear the memos and, if this scope turned
    the collector off, collect the young generations once (together the
    phase `name`) and turn the collector back on. The serve daemon's
    tick passes `clear_memos=False`: its memos serve the next tick and
    are never cleared under it (utils/memo.py).

    Counts `gc_request_collections_total:<generation>` and what those
    collections found unreachable, `gc_request_unreachable_total`."""
    depth = getattr(_DEPTH, "n", 0)
    own = depth == 0 and gc.isenabled()
    if own:
        gc.disable()
    _DEPTH.n = depth + 1
    try:
        yield
    finally:
        _DEPTH.n = depth
        if depth == 0:
            try:
                with phase(name):
                    if clear_memos:
                        clear_all_memos()
                    found = gc.collect(YOUNG) if own else 0
                if own:
                    COUNTERS.inc(f"gc_request_collections_total:{YOUNG}")
                    COUNTERS.inc("gc_request_unreachable_total", found)
            finally:
                if own:
                    gc.enable()
