"""Supervised serve replica subprocesses (the port's copy of the JAX
package's fleet/replica.py). Each replica is a port ``simon serve``
child (``python -m open_simulator_tpu_torch.cli serve``) that runs its
ticks and committed scans on the card unless ``--device cpu`` is
passed through; a child that cannot get the card exits 2 before
listening, and its spawn fails (nothing falls back to the CPU).

One ``ReplicaProcess`` owns one fleet slot (``r0``, ``r1``, ...): the
slot's lock file, its session snapshot journal, and at most one live
``simon serve`` child at a time. The supervision contract:

- **Spawn** launches the child with ``--port 0`` and parses the
  machine-readable ``simon serve listening on http://HOST:PORT``
  stdout line for the base URL; stdout/stderr stream to per-slot log
  files in the fleet directory. Spawn failures retry with the PR-2
  capped-exponential backoff (``runtime.retry.backoff_delay``) —
  every attempt passes the ``fleet.spawn`` injection seam first.
- **Slot locks refuse split-brain**: ``fleet-dir/<slot>.lock`` holds
  the supervisor pid. A second spawn against a slot whose lock holder
  is still alive raises ``DoubleSpawnError`` (an input error — two
  replicas appending the same snapshot journal would corrupt it, so
  the refusal is loud and immediate, never retried). A stale lock
  (holder dead) is reclaimed silently: that is exactly the failover
  path.
- **Probe** is one GET /healthz through the ``fleet.probe`` seam with
  a hard timeout. A degraded replica's ``Retry-After`` hint is
  surfaced so the router backs off probing instead of hot-looping.
- **Kill/terminate** are idempotent; ``alive()`` is the supervisor's
  death detector.

The slot's snapshot journal path is stable across restarts, so a
replacement child resumes the dead child's journal and — with
``--replay-snapshot`` — replays its delta stream (fleet/replay.py)
before answering its first request. The replicas share one
kernel-library store (incremental/store.py), so a replacement loads
its libraries and runs no nvcc. A replica killed with SIGKILL leaves
its slot lock behind (reclaimed by the stale-holder path below); its
card memory is freed with its CUDA context when the process is reaped.
"""

from __future__ import annotations

import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

from ..models.validation import InputError
from ..runtime import inject as _inject
from ..runtime.errors import BackendUnavailable
from ..runtime.retry import backoff_delay
from ..utils.trace import COUNTERS

log = logging.getLogger("simon.fleet")

#: the machine-parsable readiness line printed by cmd_serve
_LISTENING_RE = re.compile(r"listening on (http://\S+)")

#: consecutive failed probes before the supervisor declares a replica
#: dead (one flaky probe must not trigger a full restart)
PROBE_FAILURE_THRESHOLD = 3

DEFAULT_SPAWN_ATTEMPTS = 4
DEFAULT_READY_TIMEOUT_S = 180.0


class DoubleSpawnError(InputError):
    """A second replica was spawned against a slot whose lock holder
    is still alive — split-brain on the slot's snapshot journal.
    Refused loudly (exit 2 posture), never retried."""


class SlotLock:
    """Pid lock file guarding one fleet slot. Created exclusively;
    a stale lock (holder pid dead) is reclaimed, a live one refuses."""

    def __init__(self, path: str):
        self.path = path
        self.held = False

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        if pid <= 0:
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True
        except OSError:
            return False
        return True

    def acquire(self, owner_pid: Optional[int] = None):
        pid = os.getpid() if owner_pid is None else owner_pid
        for _ in range(2):  # second pass after reclaiming a stale lock
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                holder = self._read_holder()
                if holder is not None and self._pid_alive(holder):
                    if holder == pid:
                        return  # re-acquire by the same supervisor
                    raise DoubleSpawnError(
                        f"slot lock {self.path} is held by live pid "
                        f"{holder}; refusing double-spawn (two replicas "
                        "on one slot would corrupt its snapshot journal)"
                    )
                # stale: holder died without releasing — the failover
                # path. Reclaim and retry the exclusive create.
                try:
                    os.unlink(self.path)
                except OSError:
                    log.debug("stale lock %s vanished under reclaim", self.path)
                continue
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps({"pid": pid}))
            self.held = True
            return
        raise DoubleSpawnError(
            f"slot lock {self.path} could not be acquired (lost the "
            "reclaim race to another supervisor)"
        )

    def _read_holder(self) -> Optional[int]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return int((json.load(f) or {}).get("pid", 0)) or None
        except (OSError, ValueError):
            return None

    def release(self):
        if not self.held:
            return
        self.held = False
        try:
            os.unlink(self.path)
        except OSError:
            log.debug("slot lock %s already removed", self.path)


class ReplicaProcess:
    """One supervised serve child bound to one fleet slot."""

    def __init__(
        self,
        slot: str,
        argv: List[str],
        fleet_dir: str,
        probe_timeout_s: float = 5.0,
        ready_timeout_s: float = DEFAULT_READY_TIMEOUT_S,
    ):
        self.slot = slot
        self.argv = list(argv)
        self.fleet_dir = fleet_dir
        self.probe_timeout_s = probe_timeout_s
        self.ready_timeout_s = ready_timeout_s
        self.lock = SlotLock(os.path.join(fleet_dir, f"{slot}.lock"))
        self.snapshot_path = os.path.join(fleet_dir, f"{slot}.snapshot.jsonl")
        self.url: Optional[str] = None
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.probe_failures = 0  # consecutive; reset on success
        self.retry_after_s = 0  # degraded replica's backoff hint
        self._ready = threading.Event()
        self._reader: Optional[threading.Thread] = None

    # -- identity ------------------------------------------------------------

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    # -- spawn ---------------------------------------------------------------

    def spawn(
        self, attempts: int = DEFAULT_SPAWN_ATTEMPTS, sleep=time.sleep
    ) -> str:
        """Launch the child and block until its listening line appears
        (returns the base URL). Spawn faults (the ``fleet.spawn``
        seam, exec failures, a child that dies before listening) retry
        with capped-exponential backoff; ``DoubleSpawnError`` refuses
        immediately. Raises the last failure when attempts run out."""
        self.lock.acquire()
        last: Optional[BaseException] = None
        for attempt in range(1, attempts + 1):
            try:
                _inject.fire("fleet.spawn", slot=self.slot, attempt=attempt)
                # the slot lock MUST be held across the launch — that
                # is the split-brain guarantee, not an accidental hold
                return self._spawn_once()  # simonlint: disable=CONC002
            except DoubleSpawnError:
                raise
            except Exception as e:  # noqa: BLE001 - retried, re-raised on exhaustion
                last = e
                self._reap()
                COUNTERS.inc("fleet_spawn_retry_total")
                if attempt < attempts:
                    sleep(backoff_delay(f"fleet.spawn.{self.slot}", attempt))
        assert last is not None
        raise last

    def _spawn_once(self) -> str:
        self.url = None
        self._ready.clear()
        stderr_log = open(  # noqa: SIM115 - lifetime is the child's
            os.path.join(self.fleet_dir, f"{self.slot}.stderr.log"),
            "ab",
        )
        # the child imports open_simulator_tpu_torch by module path; when the
        # package runs from a source checkout (not installed), its root
        # must be on the child's PYTHONPATH. The child inherits the
        # supervisor's cwd so relative paths inside the config (e.g.
        # the example CR's customConfig dir) keep resolving.
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else pkg_root
        )
        try:
            self.proc = subprocess.Popen(
                self.argv,
                stdout=subprocess.PIPE,
                stderr=stderr_log,
                env=env,
            )
        finally:
            stderr_log.close()  # child holds its own descriptor
        COUNTERS.inc("fleet_spawn_total")
        self._reader = threading.Thread(
            target=self._pump_stdout, args=(self.proc,), daemon=True
        )
        self._reader.start()
        deadline = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < deadline:
            if self._ready.wait(timeout=0.1):
                assert self.url is not None
                self.probe_failures = 0
                return self.url
            if self.proc.poll() is not None:
                raise BackendUnavailable(
                    f"replica {self.slot} exited rc={self.proc.returncode} "
                    "before listening (see its stderr log in the fleet dir)"
                )
        self.kill()
        raise BackendUnavailable(
            f"replica {self.slot} did not print its listening line within "
            f"{self.ready_timeout_s:.0f}s"
        )

    def _pump_stdout(self, proc: subprocess.Popen):
        log_path = os.path.join(self.fleet_dir, f"{self.slot}.stdout.log")
        with open(log_path, "ab") as log:
            for raw in iter(proc.stdout.readline, b""):
                log.write(raw)
                log.flush()
                if not self._ready.is_set():
                    m = _LISTENING_RE.search(raw.decode("utf-8", "replace"))
                    if m:
                        self.url = m.group(1).rstrip("/")
                        self._ready.set()

    def _reap(self):
        if self.proc is not None and self.proc.poll() is None:
            self.kill()
        self.proc = None
        self.url = None

    # -- probe ---------------------------------------------------------------

    def probe(self) -> dict:
        """One GET /healthz. Returns the health document augmented
        with ``probeOk``; a connection failure returns
        ``{"probeOk": False, ...}`` and bumps the consecutive-failure
        count. A degraded replica's Retry-After header is kept as the
        probing backoff hint. (The ``fleet.probe`` injection seam
        fires in the router's supervision pass, which wraps this.)"""
        if not self.url:
            self.probe_failures += 1
            return {"probeOk": False, "error": "no url (not spawned)"}
        try:
            with urllib.request.urlopen(
                self.url + "/healthz", timeout=self.probe_timeout_s
            ) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
                retry_after = resp.headers.get("Retry-After")
        except (OSError, urllib.error.URLError, ValueError) as e:
            self.probe_failures += 1
            COUNTERS.inc("fleet_probe_failures_total")
            return {"probeOk": False, "error": str(e)}
        self.probe_failures = 0
        self.retry_after_s = int(retry_after) if retry_after else 0
        doc["probeOk"] = True
        return doc

    # -- teardown ------------------------------------------------------------

    def terminate(self):
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                log.debug("replica %s exited before SIGTERM landed", self.slot)

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                log.debug("replica %s exited before SIGKILL landed", self.slot)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                log.warning("replica %s unreaped after SIGKILL", self.slot)

    def wait(self, timeout_s: float) -> Optional[int]:
        if self.proc is None:
            return None
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None

    def release(self):
        self.lock.release()


def serve_argv(
    config_path: str,
    *,
    aot_store: str,
    snapshot_path: str,
    checkpoint_interval: Optional[int] = None,
    keep_checkpoints: Optional[int] = None,
    device: Optional[str] = None,
    extra: List[str] = (),
) -> List[str]:
    """The canonical replica command line: ephemeral port, shared
    kernel-library store, the slot's snapshot journal, and journal
    replay on boot — the no-build warm-bootstrap contract in one argv.
    With ``checkpoint_interval`` the replica also writes verified state
    checkpoints, so its replacement's replay is bounded by the
    interval instead of the slot's lifetime (runtime/checkpoint.py).
    ``device`` is passed through as ``--device`` (the card when None)."""
    argv = [
        sys.executable,
        "-m",
        "open_simulator_tpu_torch.cli",
        "serve",
        "-f",
        config_path,
        "--port",
        "0",
        "--aot-store",
        aot_store,
        "--snapshot",
        snapshot_path,
        "--replay-snapshot",
    ]
    if checkpoint_interval:
        argv += ["--checkpoint-interval", str(int(checkpoint_interval))]
    if keep_checkpoints:
        argv += ["--keep-checkpoints", str(int(keep_checkpoints))]
    if device:
        argv += ["--device", str(device)]
    argv += list(extra)
    return argv
