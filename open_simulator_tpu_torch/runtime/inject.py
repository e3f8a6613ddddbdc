"""Deterministic, seeded fault injection at every guard seam.

The runtime has degradation machinery (the typed taxonomy, retry +
circuit breakers) — but nothing systematically *proves* those paths
degrade gracefully instead of hanging or corrupting. This module is the chaos half: named injection points at
every guard seam raise the exact fault shapes the guards classify,
on a deterministic schedule, so the chaos matrix
(tests/test_chaos_matrix.py, docs/ROBUSTNESS.md) can assert every
(taxonomy error x subsystem) combination yields its documented exit
code / HTTP status / PARTIAL body — and `simon serve` can be soaked
with mid-stream OOMs and backend flaps in CI.

Activation: ``SIMON_INJECT=<spec>`` in the environment or ``--inject
<spec>`` on the guarded commands (apply / chaos / serve / shadow /
timeline). When no spec is armed, every hook is a single attribute
test on a module-level singleton — production code paths run
unmodified (tests/test_inject.py gates both the inertness and the
zero-counter contract).

Spec grammar (';'-separated clauses)::

    clause  := SITE '=' FAULT [':' PARAM] ['@' N] ['x' COUNT | 'x*']
               ['%' EVERY] ['~' PROB]

- ``SITE``: an ``fnmatch`` glob over the injection-point name
  (``jit.scenario_scan``, ``io.kube LIST /api/v1/pods``,
  ``journal.fsync.apply``, ``serve.tick``, ``shadow.poll``,
  ``timeline.tick``, ``budget.check``, ``ledger.predict_fit``,
  and the fleet router seams ``fleet.route``, ``fleet.probe``,
  ``fleet.replay``, ``fleet.spawn``).
- ``FAULT``: what happens when the clause triggers (table below).
- ``@N``: first hit of the site to fire at (1-based, default 1).
- ``xCOUNT``: consecutive hits to fire for (default 1; ``x*`` =
  every hit from N on).
- ``%EVERY``: fire on every EVERY-th hit instead of a contiguous run.
- ``~PROB``: fire with probability PROB per otherwise-eligible hit,
  decided by a hash of (seed, site, hit) — deterministic given
  ``SIMON_INJECT_SEED`` (default 0), so a "random" soak replays
  byte-identically.

Fault kinds (the raised shapes are what the real faults look like, so
classification — guard.classify_device_error, retry_io's ``catch``,
the kubeclient's 410 handling — is exercised for real):

=============  ========================================================
fault          effect at the injection point
=============  ========================================================
``oom``        torch.cuda.OutOfMemoryError — what the caching
               allocator raises; classifies DeviceOOM, drives halving
``compile``    RuntimeError("... compilation failure ...") — the port's
               guard classifies nothing but memory: it propagates
``backend``    RuntimeError("UNAVAILABLE: ...") — propagates alike
``reset``      ConnectionResetError — retried by retry_io, counts
               against the endpoint's breaker when exhausted
``timeout``    TimeoutError (an OSError) — ditto
``http:CODE``  urllib HTTPError with that status (410 exercises the
               kubeclient's anchored re-list restart path)
``slow:S``     sleep S seconds, then proceed (latency, not failure)
``crash``      write a TORN PREFIX of the pending record, fsync, and
               raise InjectedCrash (a BaseException — recovery paths
               that catch Exception must not swallow a "process
               death"); ``crash:FRAC`` cuts at FRAC of the record.
               Only meaningful at ``journal.fsync.*`` crash points;
               at plain fire points it just raises InjectedCrash
``deadline``   raise DeadlineExceeded (the --deadline partial path)
``interrupt``  raise Interrupted (the SIGINT partial path)
``exio``       raise ExternalIOError carrying the site as endpoint
``conformance``raise ConformanceError (must stay LOUD — never
               degraded around)
``lie:low``    ledger.predict_fit only: claim everything fits
               (suppresses the predictive path; reactive must save us)
``lie:high``   ledger.predict_fit only: claim nothing fits (forces
               predictive splits / serial routing with zero real OOMs)
``raise:Name`` raise taxonomy class Name from runtime.errors (or
               ExtenderError) — generic coverage
               for every GuardError subtype (simonlint rule RT002)
``error``      RuntimeError("injected error") — an UNclassified fault:
               must propagate loudly, never be degraded around
=============  ========================================================

Thread-safety: ``configure``/``clear`` happen before (or between)
runs on one thread; the armed flag and rule list are replaced
atomically and only READ on hot paths. Per-site hit counts mutate
under one lock.
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..models.validation import InputError
from . import errors as _errors

SPEC_ENV = "SIMON_INJECT"
SEED_ENV = "SIMON_INJECT_SEED"


class InjectedCrash(BaseException):
    """Simulated process death at a crash point (journal fsync, the
    serve dispatcher tick). Inherits BaseException ON PURPOSE: the
    recovery paths under test catch ``Exception`` — a real kill -9
    would not be caught there, so the simulated one must not be
    either (the serve watchdog and the journal torn-tail recovery are
    exactly the machinery that must cope)."""


# value-kind faults: consumed via value() overrides, never raised
_VALUE_FAULTS = {"lie"}


@dataclass
class Rule:
    """One parsed clause of the spec."""

    pattern: str
    fault: str
    param: str = ""
    at: int = 1
    count: int = 1  # -1 = forever
    every: int = 0  # >0: fire on every EVERY-th hit instead of [at, at+count)
    prob: float = 1.0
    clause: str = ""

    def triggers(self, hit: int, site: str, seed: int) -> bool:
        if self.every > 0:
            if hit % self.every != 0:
                return False
        elif hit < self.at or (
            self.count >= 0 and hit >= self.at + self.count
        ):
            return False
        if self.prob < 1.0:
            digest = hashlib.sha256(
                f"{seed}:{site}:{hit}".encode()
            ).digest()
            draw = int.from_bytes(digest[:8], "big") / float(1 << 64)
            if draw >= self.prob:
                return False
        return True


def parse_spec(spec: str) -> List[Rule]:
    """Parse a spec string; raises InputError (exit 2) on bad grammar
    so a typo'd --inject fails before any work starts."""
    rules: List[Rule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise InputError(
                f"--inject clause {clause!r}: expected SITE=FAULT"
                "[:PARAM][@N][xCOUNT][%EVERY][~PROB]"
            )
        site, rhs = clause.split("=", 1)
        site = site.strip()
        if not site:
            raise InputError(f"--inject clause {clause!r}: empty site")
        rule = Rule(pattern=site, fault="", clause=clause)
        # strip modifiers right-to-left; what remains is FAULT[:PARAM]
        body = rhs.strip()
        try:
            if "~" in body:
                body, prob = body.rsplit("~", 1)
                rule.prob = float(prob)
                if not 0.0 < rule.prob <= 1.0:
                    raise ValueError(f"probability {rule.prob} not in (0, 1]")
            if "%" in body:
                body, every = body.rsplit("%", 1)
                rule.every = int(every)
                if rule.every < 1:
                    raise ValueError(f"period {rule.every} must be >= 1")
            if "x" in body:
                head, cnt = body.rsplit("x", 1)
                # only treat as a count modifier when it parses as one
                # ("x" can appear inside a param, e.g. raise:XThing)
                if cnt == "*":
                    body, rule.count = head, -1
                elif cnt.isdigit():
                    body, rule.count = head, int(cnt)
                    if rule.count < 1:
                        raise ValueError(f"count {rule.count} must be >= 1")
            if "@" in body:
                body, at = body.rsplit("@", 1)
                rule.at = int(at)
                if rule.at < 1:
                    raise ValueError(f"start hit {rule.at} must be >= 1")
        except ValueError as e:
            raise InputError(f"--inject clause {clause!r}: {e}") from e
        body = body.strip()
        if ":" in body:
            rule.fault, rule.param = body.split(":", 1)
        else:
            rule.fault = body
        rule.fault = rule.fault.strip().lower()
        if rule.fault not in _FAULTS:
            raise InputError(
                f"--inject clause {clause!r}: unknown fault "
                f"{rule.fault!r} (known: {', '.join(sorted(_FAULTS))})"
            )
        _validate_param(rule, clause)
        rules.append(rule)
    return rules


def _validate_param(rule: Rule, clause: str):
    """Param errors must fail at parse time (exit 2 before any work),
    not mid-run on the Nth hit — a typo'd raise:Name on the serve
    dispatcher thread would otherwise kill the dispatcher instead of
    rejecting the spec at startup."""
    try:
        if rule.fault == "raise":
            _taxonomy_class(rule.param.strip())
        elif rule.fault == "slow" and rule.param:
            float(rule.param)
        elif rule.fault == "http" and rule.param:
            int(rule.param)
        elif rule.fault == "crash" and rule.param:
            frac = float(rule.param)
            if not 0.0 < frac < 1.0:
                raise ValueError(f"crash fraction {frac} not in (0, 1)")
        elif rule.fault == "lie" and rule.param not in ("low", "high"):
            raise ValueError(
                f"lie param {rule.param!r} must be 'low' or 'high'"
            )
    except ValueError as e:
        raise InputError(f"--inject clause {clause!r}: {e}") from e


_FAULTS = {
    "oom", "compile", "backend", "reset", "timeout", "http", "slow",
    "crash", "deadline", "interrupt", "exio", "conformance", "lie",
    "raise", "error",
}

# taxonomy classes reachable via raise:Name without importing heavy
# modules; engine/extender types resolve lazily in _taxonomy_class
_RAISE_BASE = {
    "GuardError": _errors.GuardError,
    "DeviceOOM": _errors.DeviceOOM,
    "CompileFailure": _errors.CompileFailure,
    "BackendUnavailable": _errors.BackendUnavailable,
    "ExternalIOError": _errors.ExternalIOError,
    "ConformanceError": _errors.ConformanceError,
    "ExecutionHalted": _errors.ExecutionHalted,
    "DeadlineExceeded": _errors.DeadlineExceeded,
    "Interrupted": _errors.Interrupted,
}


def _taxonomy_class(name: str):
    cls = _RAISE_BASE.get(name)
    if cls is not None:
        return cls
    if name == "ExtenderError":
        from ..scheduler.extender import ExtenderError

        return ExtenderError
    raise InputError(f"--inject raise:{name}: unknown taxonomy class")


def _build_error(rule: Rule, site: str) -> BaseException:
    """The exception a triggered rule raises — shaped like the REAL
    fault so downstream classification runs for real."""
    tag = f"injected by {SPEC_ENV} ({rule.clause}) at {site}"
    fault = rule.fault
    if fault == "oom":
        import torch

        return torch.cuda.OutOfMemoryError(f"CUDA out of memory; {tag}")
    if fault == "compile":
        return RuntimeError(f"XLA compilation failure; {tag}")
    if fault == "backend":
        return RuntimeError(f"UNAVAILABLE: backend lost; {tag}")
    if fault == "reset":
        return ConnectionResetError(f"connection reset by peer; {tag}")
    if fault == "timeout":
        return TimeoutError(f"timed out; {tag}")
    if fault == "http":
        import email.message
        import io
        import urllib.error

        code = int(rule.param or 500)
        return urllib.error.HTTPError(
            f"inject://{site}", code, f"HTTP {code}; {tag}",
            email.message.Message(), io.BytesIO(b""),
        )
    if fault == "crash":
        return InjectedCrash(f"simulated process death; {tag}")
    if fault == "deadline":
        return _errors.DeadlineExceeded(f"deadline expired; {tag}")
    if fault == "interrupt":
        return _errors.Interrupted(f"interrupted; {tag}")
    if fault == "exio":
        return _errors.ExternalIOError(
            f"external dependency failed; {tag}", endpoint=site
        )
    if fault == "conformance":
        return _errors.ConformanceError(f"engines disagreed; {tag}")
    if fault == "raise":
        cls = _taxonomy_class(rule.param.strip())
        return cls(f"{rule.param}; {tag}")
    return RuntimeError(f"injected error; {tag}")  # fault == "error"


def _site_key(site: str) -> str:
    """Counter-safe site name (spaces/slashes -> underscores)."""
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in site)


class Injector:
    """Process-wide injection registry. One instance (``INJECT``)."""

    def __init__(self):
        self.armed = False
        self._rules: List[Rule] = []
        self._seed = 0
        self._hits: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- configuration ------------------------------------------------------

    def configure(self, spec: Optional[str], seed: Optional[int] = None):
        """Arm (or, with a falsy spec, disarm) the injector. Spec
        errors raise InputError before anything is armed."""
        if seed is None:
            raw = os.environ.get(SEED_ENV, "")
            try:
                seed = int(raw) if raw else 0
            except ValueError as e:
                raise InputError(f"{SEED_ENV}={raw!r} is not an integer") from e
        if not spec:
            self.clear()
            return
        rules = parse_spec(spec)
        with self._lock:
            self._hits.clear()
        self._seed = seed
        self._rules = rules
        self.armed = bool(rules)
        if self.armed:
            from ..utils.trace import COUNTERS

            COUNTERS.gauge("inject_armed", 1.0)

    def clear(self):
        self.armed = False
        self._rules = []
        with self._lock:
            self._hits.clear()

    def describe(self) -> List[str]:
        return [r.clause for r in self._rules]

    # -- consultation -------------------------------------------------------

    def _consult(self, site: str, kinds=None) -> Optional[Rule]:
        """Count one hit of ``site`` and return the first rule that
        triggers on it (restricted to fault ``kinds`` when given)."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
        for rule in self._rules:
            if kinds is not None and rule.fault not in kinds:
                continue
            if kinds is None and rule.fault in _VALUE_FAULTS:
                continue
            if not fnmatch.fnmatchcase(site, rule.pattern):
                continue
            if rule.triggers(hit, site, self._seed):
                from ..utils.trace import COUNTERS

                COUNTERS.inc("inject_fired_total")
                COUNTERS.inc(f"inject_fired_{_site_key(site)}")
                return rule
        return None

    def fire(self, site: str, **ctx):
        """Raise (or sleep) when a clause matches this hit of
        ``site``; a no-op otherwise. ``ctx`` joins the message."""
        rule = self._consult(site)
        if rule is None:
            return
        if rule.fault == "slow":
            time.sleep(float(rule.param or 0.05))
            return
        err = _build_error(rule, site)
        if ctx:
            # some shapes (urllib HTTPError) carry an EMPTY args tuple
            head = err.args[0] if err.args else str(err)
            err.args = (
                f"{head} [{', '.join(f'{k}={v}' for k, v in sorted(ctx.items()))}]",
            )
        raise err

    def value(self, site: str) -> Optional[str]:
        """Value override for lie-style faults: returns the param
        (e.g. 'low'/'high') when a value clause matches this hit."""
        rule = self._consult(site, kinds=_VALUE_FAULTS)
        return rule.param if rule is not None else None

    def crash_write(self, site: str, f, data: str):
        """Crash point for the JSONL writers: when a ``crash`` clause
        matches this hit, write a TORN PREFIX of ``data`` (never the
        whole record, never zero bytes), fsync so the damage is
        durable like a real mid-append death, and raise InjectedCrash.
        Returns silently otherwise — the caller then performs the
        normal append."""
        rule = self._consult(site, kinds=("crash",))
        if rule is None:
            return
        frac = float(rule.param or 0.5)
        cut = max(1, min(len(data) - 2, int(len(data) * frac)))
        f.write(data[:cut])
        f.flush()
        os.fsync(f.fileno())
        err = InjectedCrash(
            f"simulated process death mid-append at {site} "
            f"({cut}/{len(data)} bytes written); {rule.clause}"
        )
        raise err

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


INJECT = Injector()
# arm from the environment at import so subprocess surfaces (the CI
# serve soak, journal crash tests driving the CLI) need no flag wiring.
# A malformed env spec must NOT crash the import (every command
# transitively imports this module): stash the error and stay
# disarmed; cli._arm_injection re-raises it as the clean exit-2 path.
IMPORT_SPEC_ERROR: Optional[InputError] = None
if os.environ.get(SPEC_ENV):
    try:
        INJECT.configure(os.environ[SPEC_ENV])
    except InputError as e:
        IMPORT_SPEC_ERROR = e


def fire(site: str, **ctx):
    """Module-level fast path: a single attribute test when disarmed."""
    if INJECT.armed:
        INJECT.fire(site, **ctx)


def value(site: str) -> Optional[str]:
    if INJECT.armed:
        return INJECT.value(site)
    return None


def crash_write(site: str, f, data: str):
    if INJECT.armed:
        INJECT.crash_write(site, f, data)
