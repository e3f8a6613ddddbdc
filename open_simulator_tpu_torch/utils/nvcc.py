"""Build the port's CUDA sources (`open_simulator_tpu_torch/csrc/*.cu`)
into shared libraries with a plain C interface, for `ctypes`.

One `nvcc` per source, for `sm_90a`, into `build/torch_kernels/` beside
the package (listed in `.gitignore`). A library is keyed by its source
bytes AND the toolchain that builds it (`toolchain_digest`: the
compiler's `nvcc --version` text, `FLAGS` and `ARCH`), so a library
built by another compiler or under other flags (`--fmad=false`, on
which every kernel's exactness against its plain version rests) is
never loaded as current: it has another name. `nvcc --version` runs
once a process for each compiler path; its text is cached.

`build_libraries` starts the compilers of several sources together and
waits for all of them; it counts each build and each library found
built (`nvcc_builds_total`, `nvcc_cache_hits_total`: the port's
counterpart of the JAX package's recompile counters). The compiler's
register and spill report (`-Xptxas -v`) is kept beside each library as
`.log`. With a kernel-library store armed (`--aot-store DIR` or
`SIMON_AOT_STORE`, incremental/store.py) the store's directory is the
library directory: a library is used only once the sha256 manifest
beside it verifies, and every build there gets its manifest. The key
reads `nvcc --version`, so the CUDA toolkit must be installed wherever
a library is loaded, from a store too.

Builds are safe from several threads: one lock a process spans the
check, the compilers and the rename, so a source two threads ask for at
once is compiled once (the second finds it built). The compiler writes
to a temporary named by the process, renamed into place once it
succeeds.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = "sm_90a"
# round-to-nearest f64 without contraction (the XLA scan's semantics);
# --split-compile=0 runs the optimizer on a thread a core (chip_smoke.py's
# build of both sources, fused_scan.cu's 22 instantiations the long one:
# 19.78 s with it, 59.26 s in the run before it, on the H100 machine)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "--split-compile=0", "-Xptxas", "-v", "-shared",
         "-Xcompiler", "-fPIC")
# bump when what keys a library changes: every older name then misses
_KEY_SCHEMA = "simon-nvcc-1"
_BUILD_LOCK = threading.Lock()
_VERSION_LOCK = threading.Lock()
_VERSIONS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def nvcc_version() -> str:
    """The `nvcc --version` text of the compiler `_nvcc()` names, run
    once a process for each compiler path. Raises RuntimeError when the
    compiler cannot say (a library cannot be keyed without it)."""
    path = _nvcc()
    with _VERSION_LOCK:
        if path not in _VERSIONS:
            try:
                proc = subprocess.run([path, "--version"], capture_output=True, text=True,
                                      timeout=60)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"cannot run {path} --version: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"{path} --version failed ({proc.returncode}): "
                                   f"{proc.stderr.strip()[:500]}")
            _VERSIONS[path] = proc.stdout
        return _VERSIONS[path]


def toolchain_digest() -> str:
    """Digest of everything besides the source that decides a library's
    bytes: the compiler's version text, `FLAGS` and `ARCH`."""
    parts = (_KEY_SCHEMA, nvcc_version(), "\0".join(FLAGS), ARCH)
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()


def library_key(source: Path) -> str:
    """sha256 of the source bytes and the toolchain digest."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(b"\0" + toolchain_digest().encode())
    return h.hexdigest()


def library_dir() -> Path:
    """Where libraries land: the armed store's directory, else BUILD_DIR."""
    from ..incremental.store import current_store

    store = current_store()
    return store.root if store is not None else BUILD_DIR


def library_path(source: Path) -> Path:
    """Where the library of `source` lands: `<stem>_<key>.so`."""
    return library_dir() / f"{Path(source).stem}_{library_key(source)[:16]}.so"


def build_libraries(sources: Sequence[Path]) -> List[Path]:
    """Compile every source whose library does not exist yet (with a
    store armed: does not verify), all compilers started together;
    returns the libraries' paths in the order of `sources`. Raises if a
    compiler fails, with its report."""
    with _BUILD_LOCK:
        return _build_locked(sources)


def _build_locked(sources: Sequence[Path]) -> List[Path]:
    from ..incremental.store import current_store
    from .trace import COUNTERS

    store = current_store()
    library_dir().mkdir(parents=True, exist_ok=True)
    libs = [library_path(s) for s in sources]
    running = []
    for src, lib in zip(sources, libs):
        if store is not None:
            if store.verify(src, lib):
                continue
        elif lib.exists():
            COUNTERS.inc("nvcc_cache_hits_total")
            continue
        COUNTERS.inc("nvcc_builds_total")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((proc, tmp, src, lib))
    failed = []
    for proc, tmp, src, lib in running:
        try:
            log, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.append(f"{lib.name}: nvcc timed out\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        if store is not None:
            store.commit(src, lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build_library(source: Path) -> Path:
    """The library of one source, compiled if it does not exist."""
    return build_libraries([source])[0]
