"""The GPU port imports neither JAX nor the JAX package, and its entry
point runs on the card unless the caller asks for the CPU.

The import check runs in a subprocess: tests/conftest.py imports `jax`
into every pytest process."""

import subprocess
import sys

import pytest

_CHECK = r"""
import importlib, pkgutil, sys
import open_simulator_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k.split(".")[0] == "open_simulator_tpu")
print(len(mods), bad)
assert not bad, bad
assert "yaml" not in sys.modules, "PyYAML imported at module load"
for want in ("parallel.sweep", "apply.applier", "apply.report", "cli", "models.chart",
             "ops.scan", "tools.stream_bench", "utils.nvcc",
             "runtime.journal", "runtime.guard", "scheduler.snapshot", "parallel.defrag",
             "resilience", "resilience.chaos", "models.kubeclient", "apply.interactive",
             "obs.costs", "obs.ledger", "obs.histo", "obs.profile", "obs.doctor",
             "twin", "twin.deltas", "shadow", "shadow.log", "shadow.record",
             "shadow.report", "shadow.replay", "shadow.ingest", "timeline",
             "timeline.events", "timeline.autoscaler", "timeline.report",
             "timeline.stepper", "timeline.compare", "serve", "serve.session",
             "serve.admission", "serve.coalescer", "serve.sessions", "serve.server",
             "incremental", "incremental.resim", "obs.telemetry", "obs.slo",
             "runtime.checkpoint", "incremental.store", "fleet", "fleet.replay",
             "twin.mirror", "twin.queries", "twin.server", "fleet.hashing",
             "fleet.replica", "fleet.router", "fleet.audit", "fleet.trace",
             "parallel.mesh"):
    assert f"open_simulator_tpu_torch.{want}" in mods, want
"""

# the apply path end to end in a fresh interpreter: the CLI plans an
# example config on the CPU and no JAX module gets loaded
_APPLY = r"""
import runpy, sys
sys.argv = ["cli", "apply", "-f", sys.argv[1], "--format", "json", "--device", "cpu"]
try:
    runpy.run_module("open_simulator_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "open_simulator_tpu"))
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    n_mods = int(out.stdout.split()[0])
    assert n_mods >= 30


def _apply(config):
    out = subprocess.run(
        [sys.executable, "-c", _APPLY, config], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert '"success": true' in out.stdout


def test_apply_path_imports_no_jax():
    _apply("example/simon-gpushare-config.yaml")


def test_quickstart_apply_path_imports_no_jax():
    """The quickstart, with its Helm chart (models.chart), open-local
    storage and anti-affinity (the B3 and B4 plan rows)."""
    _apply("example/simon-config.yaml")


# the chaos, N+K, snapshot and defrag paths in a fresh interpreter, on
# the CPU: no JAX module gets loaded
_RESILIENCE = r"""
import runpy, sys
cfg, snap = sys.argv[1], sys.argv[2]
for argv, want in (
    (["chaos", "-f", cfg, "--failures", "2", "--format", "json"], (0, 1)),
    (["apply", "-f", cfg, "--format", "json", "--tolerate-node-failures", "1",
      "--snapshot", snap], (0, 1)),
    (["defrag", "--snapshot", snap, "--format", "json"], (0,)),
):
    sys.argv = ["cli", *argv, "--device", "cpu"]
    try:
        runpy.run_module("open_simulator_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code in want, (argv, e.code)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "open_simulator_tpu"))
assert not bad, bad
"""


def test_resilience_paths_import_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _RESILIENCE, "example/simon-gpushare-config.yaml",
         str(tmp_path / "snap.json")],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert '"drainOrder"' in out.stdout and '"serialConfirmed"' in out.stdout


# the slice-8 paths in a fresh interpreter, on the CPU: the observability
# and guard flags, the interactive shell, doctor and version
_OBS = r"""
import io, runpy, sys
tmp = sys.argv[1]
for argv, want, stdin in (
    (["apply", "-f", "example/simon-config.yaml", "--format", "json", "--explain",
      "--trace-out", tmp + "/t.json", "--profile-dir", tmp + "/prof"], (0,), ""),
    (["apply", "-f", "example/simon-config.yaml", "--inject", "budget.check=deadline@1"],
     (3,), ""),
    (["apply", "-f", "example/simon-config.yaml", "-i"], (0,), "\n1\n1\n\n"),
    (["chaos", "-f", "example/simon-config.yaml", "--trace-out", tmp + "/c.jsonl"], (0, 1), ""),
    (["doctor", "BENCH_r01.json", "BENCH_r02.json"], (0, 1), None),
    (["version"], (0,), None),
):
    sys.argv = ["cli", *argv] + (["--device", "cpu"] if stdin is not None else [])
    sys.stdin = io.StringIO(stdin or "")
    try:
        runpy.run_module("open_simulator_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code in want, (argv, e.code)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "open_simulator_tpu"))
assert not bad, bad
"""


def test_observability_paths_import_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _OBS, str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "PARTIAL RESULT" in out.stdout and "simon-torch version" in out.stdout


# the slice-9 paths in a fresh interpreter, on the CPU: shadow's record
# and replay on both engines, the timeline from a synthetic trace and
# from the recorded log, and the twin's delta substrate
_TIMELINE = r"""
import runpy, sys
tmp = sys.argv[1]
log = tmp + "/sd.jsonl"
for argv, want in (
    (["shadow", "-f", "example/simon-config.yaml", "--record", log], (0,)),
    (["shadow", "-f", "example/simon-config.yaml", "--decision-log", log,
      "--format", "json", "--device", "cpu"], (0,)),
    (["shadow", "-f", "example/simon-config.yaml", "--decision-log", log,
      "--engine", "oracle"], (0,)),
    (["timeline", "-f", "example/simon-config.yaml", "--synthetic", "60",
      "--compare", "static:1,threshold,probe", "--max-nodes", "2",
      "--save-trace", tmp + "/tl.jsonl", "--device", "cpu"], (0,)),
    (["timeline", "-f", "example/simon-config.yaml", "--from-decision-log", log,
      "--policy", "probe", "--format", "json", "--device", "cpu"], (0,)),
):
    sys.argv = ["cli", *argv]
    try:
        runpy.run_module("open_simulator_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code in want, (argv, e.code)
from open_simulator_tpu_torch.shadow.log import read_decision_log
from open_simulator_tpu_torch.twin import deltas_to_events, steps_to_deltas
steps, _ = read_decision_log(log)
assert deltas_to_events(steps_to_deltas(steps))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "open_simulator_tpu"))
assert not bad, bad
"""


def test_timeline_and_shadow_paths_import_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _TIMELINE, str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"agreementRate": 1.0' in out.stdout and "Shadow Audit Report" in out.stdout
    assert '"traceFingerprint"' in out.stdout and "per-step curves" in out.stdout


# the slice-10 path in a fresh interpreter, on the CPU: the daemon over
# HTTP (a what-if, a cluster delta, the state digest, /metrics) and its
# drain
_SERVE = r"""
import json, sys, urllib.request
from open_simulator_tpu_torch.apply.applier import Applier, SimonConfig
from open_simulator_tpu_torch.serve.server import ServeDaemon
from open_simulator_tpu_torch.serve.session import Session
cluster = Applier(SimonConfig.from_file("example/simon-config.yaml"),
                  device="cpu").load_cluster()
d = ServeDaemon(Session(cluster, device="cpu"), port=0, max_batch=4)
d.start()
base = f"http://{d.host}:{d.port}"
dep = {"kind": "Deployment", "metadata": {"name": "w", "namespace": "x"},
       "spec": {"replicas": 2, "template": {"spec": {"containers": [{"name": "c",
       "image": "i", "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}]}}}}
def post(path, doc):
    req = urllib.request.Request(base + path, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=120).read())
print(post("/v1/simulate", {"apps": [{"name": "w", "yaml": json.dumps(dep)}]})["success"])
print(post("/v1/cluster-delta", {"kind": "pod_arrive", "pod": {"kind": "Pod", "metadata": {
      "name": "q", "namespace": "x"}, "spec": {"containers": [{"name": "c", "image": "i",
      "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}]}}})["applied"])
print(sorted(json.loads(urllib.request.urlopen(base + "/v1/state-digest").read())))
assert b"simon_launches_total" in urllib.request.urlopen(base + "/metrics").read()
assert d.shutdown() == 0
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "open_simulator_tpu"))
assert not bad, bad
"""


def test_serve_path_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _SERVE], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["True", "1"]
    assert "stateDigest" in out.stdout


# the slice-11 paths in a fresh interpreter, on the CPU: the twin daemon
# tailing a recorded feed (a what-if and a drain over HTTP), `simon top`
# against it, the serve failover replay and the kernel-library store's
# obs block
_TWIN = r"""
import contextlib, io, json, sys, urllib.request
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.apply.applier import Applier, SimonConfig
from open_simulator_tpu_torch.shadow.log import read_decision_log
from open_simulator_tpu_torch.twin.mirror import ClusterMirror, FeedSource
from open_simulator_tpu_torch.twin.server import TwinDaemon
from open_simulator_tpu_torch.fleet.replay import replay_into_session
from open_simulator_tpu_torch.incremental.store import configure_store, aot_store_block
log = sys.argv[1] + "/feed.jsonl"
with contextlib.redirect_stdout(io.StringIO()):
    assert cli.main(["shadow", "-f", "example/simon-config.yaml", "--record", log]) == 0
cluster = Applier(SimonConfig.from_file("example/simon-config.yaml")).load_cluster()
steps, _meta = read_decision_log(log)
mirror = ClusterMirror(cluster, FeedSource(steps, batch=64), device="cpu")
mirror.bootstrap()
d = TwinDaemon(mirror, port=0, poll_interval_s=0.02)
d.start()
base = f"http://{d.host}:{d.port}"
for _ in range(200):
    h = json.loads(urllib.request.urlopen(base + "/healthz").read())
    if h["mirror"]["feedExhausted"] and h["mirror"]["backlog"] == 0:
        break
def post(path, doc):
    req = urllib.request.Request(base + path, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=120).read())
pod = {"kind": "Pod", "metadata": {"name": "q", "namespace": "x"}, "spec": {"containers": [
       {"name": "c", "image": "i", "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}]}}
print(post("/v1/whatif", {"apps": [{"name": "q", "yaml": json.dumps(pod)}]})["kind"])
print(post("/v1/drain", {"nodes": [cluster.nodes[0]["metadata"]["name"]]})["kind"])
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert cli.main(["top", "--url", base, "--once"]) == 0
assert "simon top" in out.getvalue()
assert d.shutdown() == 0
configure_store(sys.argv[1] + "/store")
print(aot_store_block(), h["mirror"]["agreementRate"])
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "open_simulator_tpu"))
assert not bad, bad
"""


def test_twin_top_and_failover_paths_import_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _TWIN, str(tmp_path)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["whatif", "drain", "{}", "1.0"]


# the fleet path in a fresh interpreter, on the CPU: the fleet router
# in front of a port serve daemon, a routed what-if, its stitched trace,
# `top --fleet` against the router and the audit validator; the replica
# argv names the port's CLI. (`simon fleet` with replica processes runs
# in tests/test_torch_fleet.py)
_FLEET = r"""
import contextlib, io, json, sys, urllib.request
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.apply.applier import Applier, SimonConfig
from open_simulator_tpu_torch.fleet.audit import FailoverAudit, validate_audit_log
from open_simulator_tpu_torch.fleet.replica import serve_argv
from open_simulator_tpu_torch.fleet.router import FleetRouter
from open_simulator_tpu_torch.obs.telemetry import arm_flight_recorder
from open_simulator_tpu_torch.serve.server import ServeDaemon
from open_simulator_tpu_torch.serve.session import Session
argv = serve_argv("cfg.yaml", aot_store="s", snapshot_path="j", device="cpu")
assert argv[1:4] == ["-m", "open_simulator_tpu_torch.cli", "serve"], argv
assert argv[-2:] == ["--device", "cpu"], argv
cluster = Applier(SimonConfig.from_file("example/simon-config.yaml"),
                  device="cpu").load_cluster()
d = ServeDaemon(Session(cluster, device="cpu"), port=0, max_batch=4)
d.start()
class Replica:
    slot, restarts, probe_failures, retry_after_s = "r0", 0, 0, 0
    url = f"http://{d.host}:{d.port}"
    def probe(self):
        return {"probeOk": True, "degraded": False}
arm_flight_recorder()
audit = FailoverAudit(sys.argv[1] + "/audit.jsonl")
router = FleetRouter([Replica()], port=0, probe_interval_s=0, audit=audit)
router.start()
base = f"http://{router.host}:{router.port}"
dep = {"kind": "Deployment", "metadata": {"name": "w", "namespace": "x"},
       "spec": {"replicas": 2, "template": {"spec": {"containers": [{"name": "c",
       "image": "i", "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}]}}}}
req = urllib.request.Request(base + "/v1/simulate", data=json.dumps(
    {"apps": [{"name": "w", "yaml": json.dumps(dep)}]}).encode(),
    headers={"Content-Type": "application/json", "X-Simon-Request-Id": "nojax"})
with urllib.request.urlopen(req, timeout=120) as resp:
    print(json.loads(resp.read())["success"], resp.headers["X-Simon-Request-Id"])
with urllib.request.urlopen(base + "/v1/fleet/trace?requestId=nojax", timeout=60) as resp:
    names = {e["name"] for e in json.loads(resp.read())["traceEvents"]}
assert {"fleet/request", "fleet/forward", "serve/request"} <= names, names
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert cli.main(["top", "--fleet", "--url", base, "--once"]) == 0
assert "slot" in out.getvalue()
print(router.shutdown(), d.shutdown(), validate_audit_log(sys.argv[1] + "/audit.jsonl")["events"])
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "open_simulator_tpu"))
assert not bad, bad
"""


def test_fleet_path_imports_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _FLEET, str(tmp_path)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["True", "nojax", "0", "0", "0"]


@pytest.mark.parametrize("argv", [
    ["chaos", "-f", "example/simon-gpushare-config.yaml"],
    ["defrag", "--snapshot", "SNAP"],
    ["timeline", "-f", "example/simon-config.yaml", "--synthetic", "5"],
    ["shadow", "-f", "example/simon-config.yaml", "--decision-log", "LOG"],
    ["serve", "-f", "example/simon-config.yaml", "--port", "0"],
    ["twin", "-f", "example/simon-config.yaml", "--feed", "LOG", "--port", "0"],
    ["fleet", "-f", "example/simon-config.yaml", "--port", "0", "--fleet-dir", "FLEET"],
])
def test_chaos_and_defrag_default_to_the_card(argv, tmp_path, monkeypatch):
    """Without `--device cpu` the new commands ask for the card: with
    none they exit 2 with the "needs a GPU" error."""
    import contextlib
    import io
    import json

    import torch

    from open_simulator_tpu_torch import cli

    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps({"version": 1, "nodes": [
        {"metadata": {"name": f"n{i}"}, "status": {"allocatable": {
            "cpu": "4", "memory": "8Gi", "pods": "110"}}} for i in range(2)],
        "pods": [{"metadata": {"name": "p", "namespace": "d"},
                  "spec": {"nodeName": "n0", "containers": [{"name": "c", "resources": {
                      "requests": {"cpu": "1", "memory": "1Gi"}}}]}}]}))
    log = tmp_path / "log.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["shadow", "-f", "example/simon-config.yaml", "--record",
                         str(log)]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = io.StringIO()
    subs = {"SNAP": str(snap), "LOG": str(log), "FLEET": str(tmp_path / "fleet")}
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main([subs.get(a, a) for a in argv])
    assert rc == 2 and "needs a GPU" in err.getvalue()


def test_chip_smoke_imports_no_jax():
    check = (
        "import sys, runpy; runpy.run_path('chip_smoke.py', run_name='not_main'); "
        "import open_simulator_tpu_torch.scheduler.core; "
        "assert not [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'open_simulator_tpu')]"
    )
    out = subprocess.run(
        [sys.executable, "-c", check], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr


def test_simulate_without_a_card_raises(monkeypatch):
    import torch

    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.scheduler.core import simulate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        simulate(ResourceTypes(), [])
    with pytest.raises(RuntimeError, match="is_available"):
        simulate(ResourceTypes(), [], engine="cuda", device="cuda")
    # the CPU is taken only when asked for, and the serial oracle needs
    # no device at all
    assert simulate(ResourceTypes(), [], device="cpu").all_scheduled
    assert simulate(ResourceTypes(), [], engine="oracle").all_scheduled


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Alone in a directory, or with no card, the smoke prints no ok
    line and exits non-zero."""
    import shutil

    shutil.copy("chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
