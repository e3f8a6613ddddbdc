"""First use of the port's kernel libraries from several threads at
once (a serve daemon's dispatcher and a request-handler thread).

A stub `nvcc` (a script that sleeps, then writes its `-o`; asked for
`--version`, it prints a version line, which keys the library) stands
in for the compiler: two threads that build one source together get the
same library, and it is compiled once."""

import os
import stat
import threading

import pytest

from open_simulator_tpu_torch.utils import nvcc
from open_simulator_tpu_torch.utils.trace import COUNTERS

STUB = """#!/bin/sh
if [ "$1" = "--version" ]; then
  echo "nvcc: stub compiler, release 0.0"
  exit 0
fi
sleep 0.5
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "$$" >> "$(dirname "$out")/calls"
printf 'lib' > "$out"
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "nvcc"
    stub.write_text(STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// a kernel source\n")
    return src


def test_two_threads_build_one_source_once(stub_nvcc):
    b0 = COUNTERS.get("nvcc_builds_total")
    h0 = COUNTERS.get("nvcc_cache_hits_total")
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def build(i):
        try:
            start.wait()
            got[i] = nvcc.build_library(stub_nvcc)
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    assert got[0] == got[1] == nvcc.library_path(stub_nvcc)
    assert got[0].read_text() == "lib"
    assert COUNTERS.get("nvcc_builds_total") - b0 == 1
    assert COUNTERS.get("nvcc_cache_hits_total") - h0 == 1
    assert len((nvcc.BUILD_DIR / "calls").read_text().split()) == 1
    assert not list(nvcc.BUILD_DIR.glob("*.tmp"))


def test_kernel_library_loads_once_from_two_threads(monkeypatch):
    """`fused_scan._library()` builds and loads under a lock: two
    threads at first use load one library."""
    from open_simulator_tpu_torch.ops import fused_scan

    loads = []

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.fused_scan_arg_count = lambda: fused_scan._N_ARGS
            for name in ("fused_scan_launch", "fused_scan_max_clusters",
                         "fused_scan_static_smem"):
                setattr(self, name, lambda *a: 0)

    def slow_build(source):
        import time

        time.sleep(0.3)
        return source

    monkeypatch.setattr(fused_scan, "_LIB", None)
    monkeypatch.setattr(fused_scan.nvcc, "build_library", slow_build)
    monkeypatch.setattr(fused_scan.ctypes, "CDLL", FakeLib)
    out = [None, None]
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, fused_scan._library()))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert out[0] is out[1] is not None
    assert len(loads) == 1
