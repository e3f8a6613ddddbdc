"""Build the port's CUDA sources (`open_simulator_tpu_torch/csrc/*.cu`)
into shared libraries with a plain C interface, for `ctypes`.

One `nvcc` per source, for `sm_90a`, into `build/torch_kernels/` beside
the package (listed in `.gitignore`), keyed by a hash of the source: a
library that exists is reused, so a source is compiled once per
checkout and edit. `build_libraries` starts the compilers of several
sources together and waits for all of them; it counts each build and
each library found built (`nvcc_builds_total`, `nvcc_cache_hits_total`:
the port's counterpart of the JAX package's recompile counters). The compiler's register and
spill report (`-Xptxas -v`) is kept beside each library as `.log`.

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
from typing import List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# round-to-nearest f64 without contraction (the XLA scan's semantics);
# --split-compile=0 runs the optimizer on a thread a core (chip_smoke.py's
# build of both sources, fused_scan.cu's 22 instantiations the long one:
# 19.78 s with it, 59.26 s in the run before it, on the H100 machine)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "--split-compile=0", "-Xptxas", "-v", "-shared",
         "-Xcompiler", "-fPIC")
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path(source: Path) -> Path:
    """Where the library of `source` lands: `<stem>_<hash>.so`."""
    key = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{key}.so"


def build_libraries(sources: Sequence[Path]) -> List[Path]:
    """Compile every source whose library does not exist yet, all
    compilers started together; returns the libraries' paths in the
    order of `sources`. Raises if a compiler fails, with its report."""
    with _BUILD_LOCK:
        return _build_locked(sources)


def _build_locked(sources: Sequence[Path]) -> List[Path]:
    from .trace import COUNTERS

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = [library_path(s) for s in sources]
    running = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            COUNTERS.inc("nvcc_cache_hits_total")
            continue
        COUNTERS.inc("nvcc_builds_total")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((proc, tmp, lib))
    failed = []
    for proc, tmp, lib in running:
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
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build_library(source: Path) -> Path:
    """The library of one source, compiled if it does not exist."""
    return build_libraries([source])[0]
