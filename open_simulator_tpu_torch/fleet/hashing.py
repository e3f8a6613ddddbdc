"""Slot-affine consistent-hash ring (the port's copy of the JAX
package's fleet/hashing.py: the same ring points, so both packages
route every key to the same slot).

The router hashes a routing key (the request's tenant — warm
sessions, committed scans, and delta journals are tenant-affine, so
every request for one tenant should land on one replica and stay
there) onto a ring of virtual nodes. Properties the fleet leans on:

- **Deterministic**: ring points are sha256 of ``"slot#i"`` — no
  process-local randomness, so every router instance (and every test)
  agrees on the mapping.
- **Minimal movement**: adding or removing one slot moves only the
  keys that hash into that slot's arcs (~1/N of the keyspace), never
  reshuffles the rest. tests/test_torch_fleet.py pins this
  against the JAX package's ring.
- **Slot identity, not process identity**: members are slot names
  (``r0``, ``r1``, ...). A replacement replica inherits the dead
  replica's slot, so a failover moves ZERO keys — the replacement
  serves exactly the tenants the dead replica owned, which is what
  makes journal-replay bootstrap (fleet/replay.py) sufficient to
  restore its warm state.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List

from ..models.validation import InputError

#: virtual nodes per slot — enough to keep per-slot load within a few
#: percent of uniform at small N without bloating ring rebuilds
DEFAULT_VNODES = 64


def _point(label: str) -> int:
    return int.from_bytes(
        hashlib.sha256(label.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Consistent-hash ring over named slots."""

    def __init__(self, slots: List[str] = (), vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise InputError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: List[int] = []  # sorted ring positions
        self._owner: Dict[int, str] = {}  # position -> slot
        self._slots: List[str] = []
        for s in slots:
            self.add(s)

    # -- membership ----------------------------------------------------------

    def add(self, slot: str):
        if slot in self._slots:
            return
        self._slots.append(slot)
        for i in range(self.vnodes):
            p = _point(f"{slot}#{i}")
            # sha256 collisions across distinct labels are not a real
            # concern; first writer keeps the point for determinism
            if p in self._owner:
                continue
            bisect.insort(self._points, p)
            self._owner[p] = slot

    def remove(self, slot: str):
        if slot not in self._slots:
            return
        self._slots.remove(slot)
        for i in range(self.vnodes):
            p = _point(f"{slot}#{i}")
            if self._owner.get(p) == slot:
                del self._owner[p]
                idx = bisect.bisect_left(self._points, p)
                if idx < len(self._points) and self._points[idx] == p:
                    del self._points[idx]

    def slots(self) -> List[str]:
        return list(self._slots)

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, slot: str) -> bool:
        return slot in self._slots

    # -- routing -------------------------------------------------------------

    def route(self, key: str) -> str:
        """The slot owning ``key`` (first ring point at or after the
        key's hash, wrapping)."""
        if not self._points:
            raise InputError("cannot route on an empty hash ring")
        p = _point(key)
        idx = bisect.bisect_right(self._points, p)
        if idx == len(self._points):
            idx = 0
        return self._owner[self._points[idx]]

    def route_order(self, key: str) -> List[str]:
        """Every slot in failover-preference order for ``key``: the
        owner first, then the distinct slots met walking the ring.
        The router tries these in order when the owner is down, so a
        tenant's failover target is stable too (requests rerouted
        mid-burst all land on the SAME surviving replica)."""
        if not self._points:
            return []
        p = _point(key)
        start = bisect.bisect_right(self._points, p)
        order: List[str] = []
        n = len(self._points)
        for off in range(n):
            slot = self._owner[self._points[(start + off) % n]]
            if slot not in order:
                order.append(slot)
                if len(order) == len(self._slots):
                    break
        return order
