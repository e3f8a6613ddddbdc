"""The chunked executor of device work and the device-error taxonomy.

The port's copy of the JAX package's runtime/guard.py, with one
deliberate difference: the only device fault it degrades on is device
memory exhaustion. Every call site that runs scenarios on the card —
the capacity sweep's probes, chaos scenario batches (probe_scenarios),
defrag's depth batch — goes through here.

- ``DeviceOOM`` (``torch.cuda.OutOfMemoryError``, ``MemoryError``):
  a chunk of scenarios is halved and each half launched again, on the
  same kernel. A single scenario that still exhausts memory raises
  DeviceOOM. Only a caller whose work is on the CPU already passes a
  ``serial_fallback`` (the host oracle, trace-noted
  ``<label>-serial-fallback``): work on the card never moves to the host.
- Everything else propagates unchanged: a kernel build failure
  (``nvcc``), a launch error, an illegal address, a shape bug. The
  reference's ``CompileFailure`` / ``BackendUnavailable`` rungs, which
  send such a failure to a slower engine, would be exactly the hidden
  fallback the port forbids: on a CUDA tensor a wrapper launches its
  kernel or raises. So the reference's ``note_downgrade``,
  ``try_downgrade`` and ``run_laddered`` have no counterpart here.

The memory ledger's predictive split is ported: given an ``estimate``
(obs/costs.py ``chunk_estimator``), ``run_chunked`` asks the ledger
(obs/ledger.py) before each chunk and splits one predicted not to fit
before launching it. One departure from the reference: a single item
predicted not to fit goes to the serial floor only where the caller
passes one (work on the CPU); on the card it is launched anyway, and a
real OOM raises DeviceOOM.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import torch

from .errors import DeviceOOM, ExecutionHalted

log = logging.getLogger(__name__)


#: device-memory exhaustion: the CUDA caching allocator's
#: OutOfMemoryError, a host MemoryError, or an already-typed DeviceOOM
OOM_ERRORS = (torch.cuda.OutOfMemoryError, MemoryError, DeviceOOM)


def is_oom(e: BaseException) -> bool:
    """Device-memory exhaustion (``OOM_ERRORS``). Decided by type, never
    by message: a build or launch error whose text mentions memory is
    not an OOM."""
    return isinstance(e, OOM_ERRORS)


def classify_device_error(e: BaseException):
    """The taxonomy class of a device-side exception: DeviceOOM for
    memory exhaustion, None for everything else, which must propagate
    unchanged (the port degrades on nothing but memory)."""
    return DeviceOOM if is_oom(e) else None


def _reason(e: BaseException) -> str:
    return str(e).split("\n", 1)[0][:120]


def run_chunked(
    evaluate,
    n_items: int,
    *,
    label: str,
    serial_fallback=None,
    trace=None,
    budget=None,
    estimate=None,
    shards=1,
):
    """Evaluate items [0, n_items) in device chunks with halving on
    device OOM.

    ``evaluate(lo, hi)`` runs one contiguous chunk (one kernel launch)
    and returns a list of per-item results. On DeviceOOM the chunk is
    split in half and each half launched again; a single item that still
    exhausts memory raises DeviceOOM, or goes through
    ``serial_fallback(i)`` (the host oracle), trace-noted, where the
    caller's work is on the CPU and passes one. Every
    other error propagates unchanged.

    ``estimate(lo, hi)`` is the predictive half: the device workspace
    bytes of launching that chunk (obs/costs.py). When the memory ledger
    predicts the chunk will not fit beside what is in use, it is split
    without being launched (``guard_oom_predicted_total``, note
    ``<label>-chunk-predicted-split``); a single item predicted not to
    fit takes ``serial_fallback`` where there is one and is launched
    otherwise. Each launch after a verdict counts a hit or a miss
    (``ledger_predict_hit_total`` / ``ledger_predict_miss_total``).
    ``budget.check`` runs between chunks; on expiry the raised
    ExecutionHalted carries ``partial_results`` (None where
    incomplete).

    ``shards`` is the device count of a launch split over a mesh
    (parallel/mesh.py): an int, or a callable read before each chunk.
    The estimate is then PER DEVICE (``chunk_estimator(...,
    shards=)``), and the ledger compares it with the tightest mesh
    device's room."""
    from ..utils.trace import COUNTERS, GLOBAL

    tr = trace or GLOBAL
    out = [None] * n_items
    done = [False] * n_items
    pending: List[Tuple[int, int]] = [(0, n_items)] if n_items else []
    halvings = serial = 0
    while pending:
        if budget is not None:
            try:
                budget.check(f"{label} chunk boundary")
            except ExecutionHalted as e:
                e.partial_results = [r if ok else None for r, ok in zip(out, done)]
                raise
        lo, hi = pending.pop()
        predicted_fit = None
        if estimate is not None:
            est = estimate(lo, hi)
            if est is not None:
                from ..obs.ledger import LEDGER

                cur_shards = shards() if callable(shards) else shards
                predicted_fit = LEDGER.predict_fit(int(est), label=label,
                                                   shards=int(cur_shards))
                if predicted_fit is False and hi - lo > 1:
                    COUNTERS.inc("guard_oom_predicted_total")
                    mid = (lo + hi) // 2
                    halvings += 1
                    tr.append_note(f"{label}-chunk-predicted-split",
                                   f"[{lo},{hi}) -> [{lo},{mid})+[{mid},{hi}): ledger "
                                   f"predicts {est} workspace bytes will not fit")
                    log.info("%s: ledger predicts chunk [%d,%d) (%d workspace bytes) "
                             "will not fit; splitting before launch", label, lo, hi, est)
                    pending.append((mid, hi))
                    pending.append((lo, mid))
                    continue
                if predicted_fit is False and serial_fallback is not None:
                    COUNTERS.inc("guard_oom_predicted_total")
                    serial += 1
                    tr.append_note(f"{label}-serial-fallback",
                                   f"item {lo} via serial oracle after ledger "
                                   f"predicted {est} bytes will not fit")
                    out[lo] = serial_fallback(lo)
                    done[lo] = True
                    continue
                # a single item on the card: nothing to split it into, and
                # card work never moves to the host; launch it
        try:
            results = evaluate(lo, hi)
        except Exception as e:  # classified, then re-raised or halved
            if classify_device_error(e) is None:
                raise
            COUNTERS.inc("guard_oom_reactive_total")
            if predicted_fit is True:
                COUNTERS.inc("ledger_predict_miss_total")
            reason = _reason(e)
            if hi - lo == 1:
                if serial_fallback is None:
                    raise DeviceOOM(
                        f"{label}: single-item chunk still exhausts device "
                        f"memory: {reason}") from e
                serial += 1
                tr.append_note(f"{label}-serial-fallback",
                               f"item {lo} via serial oracle after {reason}")
                log.warning("%s: item %d falling back to the serial oracle "
                            "after device OOM even alone (%s)", label, lo, reason)
                out[lo] = serial_fallback(lo)
                done[lo] = True
                continue
            mid = (lo + hi) // 2
            halvings += 1
            tr.append_note(f"{label}-chunk-halving",
                           f"[{lo},{hi}) -> [{lo},{mid})+[{mid},{hi}) after {reason}")
            log.warning("%s: chunk [%d,%d) exhausted device memory; launching "
                        "it as two halves (%s)", label, lo, hi, reason)
            # LIFO: push the upper half first so the lower half runs next
            pending.append((mid, hi))
            pending.append((lo, mid))
            continue
        if predicted_fit is True:
            COUNTERS.inc("ledger_predict_hit_total")
        out[lo:hi] = results
        done[lo:hi] = [True] * (hi - lo)
    if halvings or serial:
        tr.note(f"{label}-degraded",
                f"{halvings} chunk-halving(s), {serial} serial fallback(s)")
    return out
