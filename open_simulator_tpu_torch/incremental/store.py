"""Persistent kernel-library store: cold starts without a build.

The port's kernels are shared libraries built by nvcc (utils/nvcc.py)
into `build/torch_kernels/` at first use: a fresh checkout, or a new
daemon on a fresh disk, pays the whole build before its first answer.
An armed store (``--aot-store DIR`` or ``SIMON_AOT_STORE``) is a
library directory that outlives the process and the checkout, with a
manifest beside each library that is checked before the library is
opened: the port's counterpart of the JAX package's store of
serialized executables (its incremental/store.py).

- **One entry per (source, toolchain).** The port's libraries do not
  depend on the shape. An entry is the library utils/nvcc.py names,
  ``<stem>_<key>.so``, keyed by the source bytes and the toolchain
  digest (the compiler's ``nvcc --version`` text, ``FLAGS`` and the
  arch), beside its nvcc report (``.log``) and its manifest
  (``.json``): the schema, the key, the payload's sha256 and size, the
  driver and torch versions and the nvcc report. The driver and torch
  versions are recorded but do not key the entry: the library is SASS
  for ``sm_90a`` behind a plain C interface, and neither of them
  changes its bytes. The key reads ``nvcc --version``, so the CUDA
  toolkit must be installed where a store is loaded: what the store
  saves is the build, not the compiler.
- **Writes are crash-safe:** nvcc writes the library to a temporary
  that is renamed into place; the manifest follows by temporary and
  rename, so it is the commit point. Two processes that fill one store
  are safe through the rename.
- **Loads verify before anything opens the library:** the payload's
  sha256 must equal the manifest's before ``ctypes.CDLL`` opens it (a
  library cannot be opened through a header, so this is the safe
  order).
- **Refused, loudly:** a torn manifest, an unparseable one, a digest
  mismatch, a missing payload and a payload sha256 mismatch each log a
  warning naming the file and the reason and count
  ``aot_store_reject_total``. The library is then built by nvcc,
  counted (``nvcc_builds_total``), and committed over the entry. An
  nvcc failure still raises: a rebuild is never a fallback to a
  kernel's plain version.

Verification and commits run under utils/nvcc.py's build lock. The
verification is the ``aot.store_load`` injection seam
(runtime/inject.py): an I/O fault there is a counted reject and a
rebuild.

Counters (``/metrics`` as ``simon_aot_store_*``, trace artifacts via
``aot_store_block``): ``aot_store_hit_total``, ``aot_store_miss_total``,
``aot_store_reject_total``, ``aot_store_save_total``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import threading
from contextlib import suppress
from pathlib import Path
from typing import Optional

from ..utils.trace import COUNTERS

log = logging.getLogger(__name__)

STORE_ENV = "SIMON_AOT_STORE"

#: bump when the entry layout changes: older manifests are then refused
_SCHEMA = "simon-kernel-store-1"


def _driver_version() -> Optional[int]:
    """The CUDA driver's version (cuDriverGetVersion), or None where no
    driver is installed. Recorded, never keyed."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    out = ctypes.c_int(0)
    if lib.cuDriverGetVersion(ctypes.byref(out)) != 0:
        return None
    return int(out.value)


def _torch_version() -> str:
    import torch

    return str(torch.__version__)


def _write_atomic(dest: Path, data: bytes) -> None:
    """`data` into `dest` through a temporary in the same directory,
    fsync'd and renamed; the temporary never outlives a failure."""
    fd, tmp = tempfile.mkstemp(dir=str(dest.parent), prefix=dest.name + ".tmp.")
    renamed = False
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dest)
        renamed = True
    finally:
        if not renamed:
            with suppress(OSError):
                os.unlink(tmp)


class ArtifactStore:
    """One directory of kernel libraries, each with its manifest. Callers
    hold utils/nvcc.py's build lock around `verify` and `commit`; the
    files themselves are written by rename, so processes sharing a
    directory are safe."""

    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def verify(self, source: Path, lib: Path) -> bool:
        """Whether `lib`, the library of `source` in this directory, is a
        committed entry whose payload matches its manifest. False,
        counted as a miss (no manifest) or a reject, means: build."""
        from ..runtime import inject as _inject
        from ..runtime.errors import ExternalIOError
        from ..utils import nvcc

        manifest_path = lib.with_suffix(".json")
        if not manifest_path.exists():
            COUNTERS.inc("aot_store_miss_total")
            return False
        try:
            _inject.fire("aot.store_load", jit_site=Path(source).stem)
            raw = manifest_path.read_bytes()
            if not raw.endswith(b"\n"):
                return self._reject(manifest_path, "torn manifest (no final newline)")
            try:
                manifest = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                manifest = None
            if not isinstance(manifest, dict):
                return self._reject(manifest_path, "unparseable manifest")
            digest = nvcc.library_key(source)
            if manifest.get("schema") != _SCHEMA or manifest.get("digest") != digest:
                return self._reject(
                    manifest_path,
                    f"digest mismatch (entry {manifest.get('schema')!r} "
                    f"{manifest.get('digest')!r}, wanted {_SCHEMA!r} {digest!r})",
                )
            if not lib.exists():
                return self._reject(lib, "payload missing")
            if hashlib.sha256(lib.read_bytes()).hexdigest() != manifest.get("payload_sha256"):
                return self._reject(lib, "payload sha256 mismatch (corrupt entry)")
        except (OSError, ExternalIOError) as e:
            return self._reject(manifest_path, f"{type(e).__name__}: {str(e)[:120]}")
        COUNTERS.inc("aot_store_hit_total")
        return True

    def _reject(self, path: Path, reason: str) -> bool:
        log.warning("aot store: %s: %s; refusing and rebuilding with nvcc", path, reason)
        COUNTERS.inc("aot_store_reject_total")
        return False

    def commit(self, source: Path, lib: Path, report: str) -> bool:
        """Write the manifest of `lib`, just built from `source` in this
        directory, by temporary and rename. A failed commit is logged and
        skipped (the entry then misses next time): the store keeps
        builds, it never decides one."""
        import sys

        from ..utils import nvcc

        manifest_path = lib.with_suffix(".json")
        try:
            payload = lib.read_bytes()
            manifest = {
                "schema": _SCHEMA,
                "source": Path(source).name,
                "digest": nvcc.library_key(source),
                "payload_sha256": hashlib.sha256(payload).hexdigest(),
                "payload_bytes": len(payload),
                "driver": _driver_version(),
                "torch": _torch_version(),
                "python": sys.version.split()[0],
                "nvcc_version": nvcc.nvcc_version(),
                "nvcc_report": report,
            }
            _write_atomic(manifest_path,
                          (json.dumps(manifest, sort_keys=True) + "\n").encode())
        except OSError as e:
            log.warning("aot store: commit of %s failed (%s); entry skipped",
                        manifest_path, str(e)[:120])
            return False
        COUNTERS.inc("aot_store_save_total")
        return True


# ---------------------------------------------------------- process wiring

_STORE: Optional[ArtifactStore] = None
_STORE_LOCK = threading.Lock()
_ENV_CHECKED = False


def configure_store(path: Optional[str]) -> Optional[ArtifactStore]:
    """Arm (or disarm with None/'') the process-wide store: the
    ``--aot-store DIR`` wiring. Returns the live store."""
    global _STORE, _ENV_CHECKED
    with _STORE_LOCK:
        _ENV_CHECKED = True
        _STORE = ArtifactStore(path) if path else None
        return _STORE


def current_store() -> Optional[ArtifactStore]:
    """The armed store, configured from ``SIMON_AOT_STORE`` on first
    consultation (a subprocess needs no flag)."""
    global _STORE, _ENV_CHECKED
    if _STORE is None and not _ENV_CHECKED:
        with _STORE_LOCK:
            if not _ENV_CHECKED:
                _ENV_CHECKED = True
                env = os.environ.get(STORE_ENV, "")
                if env:
                    _STORE = ArtifactStore(env)
    return _STORE


# ---------------------------------------------------------- obs blocks


def aot_store_block() -> dict:
    """Store counters for trace artifacts and the doctor (hit_rate is
    the doctor-gated dimension); the JAX package's function."""
    hits = COUNTERS.get("aot_store_hit_total")
    misses = COUNTERS.get("aot_store_miss_total")
    rejects = COUNTERS.get("aot_store_reject_total")
    saves = COUNTERS.get("aot_store_save_total")
    if not (hits or misses or rejects or saves):
        return {}
    return {
        "hits": hits,
        "misses": misses,
        "rejects": rejects,
        "saves": saves,
        "hit_rate": round(hits / max(1, hits + misses), 4),
    }


def incremental_block() -> dict:
    """Delta re-simulation counters (resim.py and the serve and twin
    wiring) for trace artifacts — suffix_fraction is the doctor-gated
    dimension: re-launched rows over rows the prefix reuse saved. The
    JAX package's function."""
    suffix = COUNTERS.get("incremental_suffix_pods_total")
    prefix = COUNTERS.get("incremental_prefix_reused_pods_total")
    if not (suffix or prefix):
        return {}
    return {
        "suffix_pods": suffix,
        "prefix_reused_pods": prefix,
        "suffix_fraction": round(suffix / max(1, suffix + prefix), 6),
        "resims": COUNTERS.get("incremental_resims_total"),
        "full_rebuilds": COUNTERS.get("incremental_full_rebuilds_total"),
        "fallbacks": COUNTERS.get("incremental_fallbacks_total"),
    }
