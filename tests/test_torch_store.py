"""The kernel-library key and store of the GPU port (utils/nvcc.py,
incremental/store.py).

A stub `nvcc` stands in for the compiler: asked for `--version` it
prints the text in its `version` file, and asked to compile it writes
the source's bytes and a marker to its `-o` and logs the call. The
library key covers the source, `FLAGS`, the version text and the arch,
so a library built under other flags or by another compiler is never
loaded as current. An armed store is the library directory: a second
process pointed at a filled store builds nothing; a corrupt payload, a
torn or unparseable manifest, a digest mismatch, a missing payload and
a library without a manifest are each refused (or missed), counted and
rebuilt. The obs blocks equal
the JAX package's functions on the same counter values.
"""

import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

from open_simulator_tpu_torch.incremental import store as port_store
from open_simulator_tpu_torch.utils import nvcc
from open_simulator_tpu_torch.utils.trace import COUNTERS

STUB = """#!/bin/sh
here="$(dirname "$0")"
if [ "$1" = "--version" ]; then
  echo "$$" >> "$here/version-calls"
  cat "$here/version"
  exit 0
fi
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
echo "$$" >> "$here/calls"
{ cat "$src"; printf 'built'; } > "$out"
echo "ptxas info: stub report"
"""

KEYS = ("nvcc_builds_total", "nvcc_cache_hits_total", "aot_store_hit_total",
        "aot_store_miss_total", "aot_store_reject_total", "aot_store_save_total")

# a second process: the stub on PATH, its own build directory, the store
# armed by the environment (SIMON_AOT_STORE); one build of the source
_CHILD = r"""
import json, sys
from pathlib import Path
from open_simulator_tpu_torch.utils import nvcc
from open_simulator_tpu_torch.utils.trace import COUNTERS
nvcc.BUILD_DIR = Path(sys.argv[1])
lib = nvcc.build_library(Path(sys.argv[2]))
keys = %r
print(json.dumps({"lib": lib.read_text(), "log": lib.with_suffix(".log").read_text(),
                  **{k: COUNTERS.get(k) for k in keys}}))
""" % (KEYS,)


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """(bin dir, source): the stub compiler on PATH, the build directory
    and the version cache private to the test, no store armed."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    script = bindir / "nvcc"
    script.write_text(STUB)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    (bindir / "version").write_text("nvcc: stub compiler, release 12.4\n")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.delenv(port_store.STORE_ENV, raising=False)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nvcc, "_VERSIONS", {})
    monkeypatch.setattr(port_store, "_STORE", None)
    monkeypatch.setattr(port_store, "_ENV_CHECKED", True)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel source\n")
    return bindir, src


def _calls(bindir: Path, name="calls") -> int:
    path = bindir / name
    return len(path.read_text().split()) if path.exists() else 0


def _moved(before):
    return {k: COUNTERS.get(k) - v for k, v in before.items()}


def _snap():
    return {k: COUNTERS.get(k) for k in KEYS}


# ------------------------------------------------------------------ C3


def test_version_runs_once_a_process(stub):
    bindir, src = stub
    first = nvcc.library_path(src)
    assert nvcc.library_path(src) == first
    nvcc.toolchain_digest()
    assert _calls(bindir, "version-calls") == 1


@pytest.mark.parametrize("change", ["flags", "version", "arch", "source"])
def test_toolchain_change_gives_a_new_library_and_one_build_each(stub, monkeypatch, change):
    """C3: the key covers the source, FLAGS, the nvcc version text and
    the arch; a library built under other flags or by another compiler
    is not loaded as current, it is built again, once."""
    bindir, src = stub
    b0 = _snap()
    old = nvcc.build_library(src)
    assert nvcc.build_library(src) == old  # found built
    if change == "flags":
        monkeypatch.setattr(nvcc, "FLAGS", tuple(f for f in nvcc.FLAGS if f != "--fmad=false"))
    elif change == "version":
        (bindir / "version").write_text("nvcc: stub compiler, release 12.8\n")
        monkeypatch.setattr(nvcc, "_VERSIONS", {})
    elif change == "arch":
        monkeypatch.setattr(nvcc, "ARCH", "sm_100a")
    else:
        src.write_text("// an edited kernel source\n")
    new = nvcc.library_path(src)
    assert new != old and old.exists() and not new.exists()
    assert nvcc.build_library(src) == new
    assert nvcc.build_library(src) == new
    moved = _moved(b0)
    assert moved["nvcc_builds_total"] == 2 and moved["nvcc_cache_hits_total"] == 2
    assert _calls(bindir) == 2


def test_a_compiler_that_cannot_say_its_version_raises(stub):
    bindir, src = stub
    (bindir / "nvcc").write_text("#!/bin/sh\nexit 3\n")
    with pytest.raises(RuntimeError, match="--version failed"):
        nvcc.library_path(src)


# ---------------------------------------------------------------- store


def _child(bindir, build_dir, src, store_dir):
    env = dict(os.environ)
    env["PATH"] = f"{bindir}{os.pathsep}{env.get('PATH', '')}"
    env[port_store.STORE_ENV] = str(store_dir)
    out = subprocess.run([sys.executable, "-c", _CHILD, str(build_dir), str(src)],
                         capture_output=True, text=True, timeout=120, env=env,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def _no_temporaries(*dirs):
    for d in dirs:
        left = [p.name for p in Path(d).iterdir() if ".tmp" in p.name]
        assert not left, left


def test_store_round_trip_in_a_second_process_builds_nothing(stub, tmp_path):
    bindir, src = stub
    store_dir = tmp_path / "store"
    cold, _ = _child(bindir, tmp_path / "b1", src, store_dir)
    assert cold["nvcc_builds_total"] == 1 and cold["aot_store_miss_total"] == 1
    assert cold["aot_store_save_total"] == 1 and cold["aot_store_hit_total"] == 0
    warm, _ = _child(bindir, tmp_path / "b2", src, store_dir)
    assert warm["nvcc_builds_total"] == 0 and warm["aot_store_hit_total"] == 1
    assert warm["aot_store_reject_total"] == 0 and warm["aot_store_save_total"] == 0
    assert warm["lib"] == cold["lib"] == src.read_text() + "built"
    assert warm["log"] == cold["log"] == "ptxas info: stub report\n"
    assert _calls(bindir) == 1
    entries = sorted(p.suffix for p in store_dir.iterdir())
    assert entries == [".json", ".log", ".so"]
    manifest = json.loads(next(store_dir.glob("*.json")).read_text())
    assert manifest["payload_bytes"] == len(cold["lib"])
    assert "release 12.4" in manifest["nvcc_version"]
    assert manifest["nvcc_report"] == cold["log"]
    assert {"driver", "torch", "digest", "payload_sha256"} <= set(manifest)
    # the store is the library directory: neither build directory is used
    assert not (tmp_path / "b1").exists() and not (tmp_path / "b2").exists()
    _no_temporaries(store_dir)


def _corrupt(store_dir: Path, kind: str):
    payload = next(store_dir.glob("*.so"))
    manifest = next(store_dir.glob("*.json"))
    if kind == "payload":
        data = bytearray(payload.read_bytes())
        data[0] ^= 0xFF
        payload.write_bytes(bytes(data))
    elif kind == "torn":
        raw = manifest.read_bytes()
        manifest.write_bytes(raw[: len(raw) // 2])
    elif kind == "unparseable":
        manifest.write_bytes(b"{not json\n")
    elif kind == "digest":
        doc = json.loads(manifest.read_text())
        doc["digest"] = "0" * 32
        manifest.write_text(json.dumps(doc) + "\n")
    elif kind == "unmanifested":  # a crash between the payload and the manifest
        manifest.unlink()
    else:  # the payload gone
        payload.unlink()


def _build_in(monkeypatch, build_dir, src, store_dir):
    """One build of `src` in this process with its own build directory
    and the store at `store_dir` armed: the counters it moved and the
    library's text."""
    monkeypatch.setattr(nvcc, "BUILD_DIR", build_dir)
    port_store.configure_store(str(store_dir))
    b0 = _snap()
    try:
        lib = nvcc.build_library(src)
    finally:
        port_store.configure_store(None)
    return dict(_moved(b0), lib=lib.read_text())


@pytest.mark.parametrize("kind", ["payload", "torn", "unparseable", "digest", "missing"])
def test_bad_entry_is_refused_counted_and_rebuilt(stub, tmp_path, monkeypatch, caplog, kind):
    bindir, src = stub
    store_dir = tmp_path / "store"
    _build_in(monkeypatch, tmp_path / "b1", src, store_dir)
    _corrupt(store_dir, kind)
    with caplog.at_level("WARNING", logger=port_store.log.name):
        got = _build_in(monkeypatch, tmp_path / "b2", src, store_dir)
    assert got["aot_store_reject_total"] == 1 and got["nvcc_builds_total"] == 1
    assert got["aot_store_hit_total"] == 0 and got["aot_store_save_total"] == 1
    assert got["lib"] == src.read_text() + "built"
    warned = [r.getMessage() for r in caplog.records]
    assert any("refusing and rebuilding with nvcc" in m and str(store_dir) in m
               for m in warned), warned
    # the rebuild was saved over the entry: the next build loads it
    again = _build_in(monkeypatch, tmp_path / "b3", src, store_dir)
    assert again["nvcc_builds_total"] == 0 and again["aot_store_hit_total"] == 1
    assert _calls(bindir) == 2
    _no_temporaries(store_dir)


def test_a_failed_build_still_raises_with_the_store_armed(stub, tmp_path):
    bindir, src = stub
    (bindir / "nvcc").write_text('#!/bin/sh\nif [ "$1" = "--version" ]; then cat '
                                 f'"{bindir}/version"; exit 0; fi\necho boom; exit 1\n')
    port_store.configure_store(str(tmp_path / "store"))
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            nvcc.build_library(src)
    finally:
        port_store.configure_store(None)
    assert not [p.name for p in (tmp_path / "store").iterdir() if p.suffix != ".log"]


def test_a_library_without_its_manifest_is_a_miss_and_rebuilt(stub, tmp_path, monkeypatch):
    """A library in the store's directory with no manifest (a crash
    between the compiler's rename and the commit) is not opened: it
    misses, is built again and committed."""
    bindir, src = stub
    store_dir = tmp_path / "store"
    _build_in(monkeypatch, tmp_path / "b1", src, store_dir)
    _corrupt(store_dir, "unmanifested")
    got = _build_in(monkeypatch, tmp_path / "b2", src, store_dir)
    assert got["aot_store_miss_total"] == 1 and got["aot_store_reject_total"] == 0
    assert got["nvcc_builds_total"] == 1 and got["aot_store_save_total"] == 1
    again = _build_in(monkeypatch, tmp_path / "b3", src, store_dir)
    assert again["nvcc_builds_total"] == 0 and again["aot_store_hit_total"] == 1
    assert _calls(bindir) == 2


def test_a_build_directory_library_is_not_taken_into_a_store(stub, tmp_path):
    """With a store armed the library directory is the store: a library
    built before in the build directory is not used, nor copied; the
    store gets its own build, committed with its manifest."""
    bindir, src = stub
    lib = nvcc.build_library(src)
    b0 = _snap()
    store = port_store.configure_store(str(tmp_path / "store"))
    try:
        got = nvcc.build_library(src)
        assert got == store.root / lib.name and got.read_text() == lib.read_text()
        assert got.with_suffix(".json").exists()
        assert nvcc.build_library(src) == got
    finally:
        port_store.configure_store(None)
    moved = _moved(b0)
    assert moved["nvcc_builds_total"] == 1 and moved["aot_store_miss_total"] == 1
    assert moved["aot_store_save_total"] == 1 and moved["aot_store_hit_total"] == 1
    assert _calls(bindir) == 2


def test_store_env_arms_on_first_consultation(tmp_path, monkeypatch):
    monkeypatch.setattr(port_store, "_STORE", None)
    monkeypatch.setattr(port_store, "_ENV_CHECKED", False)
    monkeypatch.setenv(port_store.STORE_ENV, str(tmp_path / "s"))
    got = port_store.current_store()
    assert got is not None and got.root == tmp_path / "s" and (tmp_path / "s").is_dir()
    assert port_store.current_store() is got


# ------------------------------------------------------------ obs blocks


class _Counts:
    def __init__(self, values):
        self.values = values

    def get(self, name):
        return self.values.get(name, 0)


@pytest.mark.parametrize("values", [
    {},
    {"aot_store_hit_total": 3, "aot_store_miss_total": 1},
    {"aot_store_reject_total": 2, "aot_store_save_total": 2},
    {"incremental_suffix_pods_total": 7, "incremental_prefix_reused_pods_total": 9993,
     "incremental_resims_total": 4, "incremental_full_rebuilds_total": 1},
    {"incremental_prefix_reused_pods_total": 20000, "incremental_fallbacks_total": 2,
     "aot_store_hit_total": 1},
])
def test_obs_blocks_equal_the_jax_package(monkeypatch, values):
    from open_simulator_tpu.incremental import store as jax_store

    monkeypatch.setattr(port_store, "COUNTERS", _Counts(values))
    monkeypatch.setattr(jax_store, "COUNTERS", _Counts(values))
    assert port_store.aot_store_block() == jax_store.aot_store_block()
    assert port_store.incremental_block() == jax_store.incremental_block()
