"""Structured error taxonomy of the execution-guard runtime.

Every way a plan can die maps to one typed error (docs/ROBUSTNESS.md):

- ``DeviceOOM``: the accelerator ran out of memory (device
  out-of-memory / host MemoryError). Recoverable by the guard's
  chunk-halving ladder (runtime/guard.py).
- ``CompileFailure``: compilation of a device program failed. Halving
  cannot help, and the guard never downgrades it: it propagates.
- ``BackendUnavailable``: the device backend died or refused to
  initialize mid-run.
- ``DeadlineExceeded`` / ``Interrupted``: the run hit its ``--deadline``
  wall-clock budget or received SIGINT and stopped at the next safe
  boundary (runtime/budget.py). Both carry a machine-readable
  ``partial`` payload describing completed work and map to distinct
  exit codes.
- ``ExternalIOError``: an external dependency (kube apiserver, HTTP
  scheduler extender, credential-plugin subprocess) failed after the
  retry policy was exhausted or its circuit breaker opened
  (runtime/retry.py). Carries the endpoint URL or subprocess argv.

The CLI exit-code contract (docs/ROBUSTNESS.md):

====  =========================================================
code  meaning
====  =========================================================
0     success (plan feasible / every chaos scenario survives)
1     infeasible (valid input, negative answer)
2     input error (bad config, bad flags, refused resume)
3     partial result: deadline expired at a safe boundary
4     partial result: interrupted (SIGINT) at a safe boundary
====  =========================================================

``simon serve`` maps its lifecycle onto the same codes: 0 = clean
SIGTERM/SIGINT drain (every queued request answered), 2 = input error
before listening, 3 = drain timeout expired with requests still
queued (shed with a machine-readable PARTIAL 503 body). Per-request
overload/deadline shedding stays at the HTTP layer (503), never a
process exit (docs/SERVING.md, docs/ROBUSTNESS.md).
"""

from __future__ import annotations

EXIT_OK = 0
EXIT_INFEASIBLE = 1
EXIT_INPUT_ERROR = 2
EXIT_PARTIAL_DEADLINE = 3
EXIT_INTERRUPTED = 4


class GuardError(Exception):
    """Base of the execution-guard taxonomy.

    ``descent`` is the reference's degradation-ladder trace, one
    ``"<rung>: <why>"`` entry per rung tried; the port has no ladder, so
    it stays empty."""

    descent: tuple = ()


class DeviceOOM(GuardError):
    """Device memory exhausted (RESOURCE_EXHAUSTED / MemoryError)."""


class CompileFailure(GuardError):
    """Compilation of a device program failed."""


class BackendUnavailable(GuardError):
    """The device backend died or refused to initialize."""


class ExternalIOError(GuardError):
    """An external I/O dependency failed after retries (or its circuit
    breaker is open). Carries the endpoint or subprocess argv so the
    report names what actually failed."""

    def __init__(self, message: str, *, endpoint=None, argv=None):
        super().__init__(message)
        self.endpoint = endpoint
        self.argv = list(argv) if argv is not None else None


class ConformanceError(GuardError, RuntimeError):
    """Two engines (or a replay and its scan) disagreed, or a scan
    invariant was violated — an internal defect, never an input
    problem. Inherits RuntimeError so pre-taxonomy ``except
    RuntimeError`` handlers keep catching it; raised by the defensive
    cross-checks (probe replay vs scan, serial confirmation vs batched
    sweep, masked-off placement indices)."""


class ExecutionHalted(GuardError):
    """The run stopped early at a safe boundary. ``partial`` is a
    machine-readable payload describing the work that DID complete
    (the CLI renders it as the partial report)."""

    exit_code = EXIT_PARTIAL_DEADLINE
    reason = "halted"

    def __init__(self, message: str, partial=None):
        super().__init__(message)
        self.partial = partial


class DeadlineExceeded(ExecutionHalted):
    """The wall-clock budget (``--deadline``) expired."""

    exit_code = EXIT_PARTIAL_DEADLINE
    reason = "deadline"


class Interrupted(ExecutionHalted):
    """SIGINT / KeyboardInterrupt observed at a safe boundary."""

    exit_code = EXIT_INTERRUPTED
    reason = "interrupt"
