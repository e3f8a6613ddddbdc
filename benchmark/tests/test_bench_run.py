"""The harness end to end on the CPU: the contract line, the refusal
without a card or without the program, and no JAX in the process."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _subprocess(code: str, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.fspath(tiny.REPO))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("workload", ["basic-plan", "spread-deploy"])
def test_dry_run_prints_one_contract_line_and_loads_no_jax(tiny_root, workload):
    code = (
        "import sys, json\n"
        "from benchmark import run\n"
        f"rc = run.main({tiny.argv(workload)!r}, root={tiny_root!r}, device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})), file=sys.stderr)\n"
        "sys.exit(rc)\n")
    proc = _subprocess(code, tiny.REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(out) == 1
    line = json.loads(out[0])
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) >= {"setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["device"]["count"] == 1
    loaded = set(json.loads(proc.stderr.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "open_simulator_tpu"}
    assert "open_simulator_tpu_torch" in loaded
    # the numbers compared, each beside its limit, end stderr's check lines
    checks = [ln for ln in proc.stderr.splitlines() if ln.startswith("check ")]
    assert checks and all("(limit" in ln for ln in checks)


def test_no_card_fails_and_prints_no_result(tiny_root, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(tiny.argv("basic-plan"), root=tiny_root) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA card" in cap.err


def test_too_few_cards_fails(tiny_root, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(tiny.argv("spread-deploy"), root=tiny_root) == 2
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_files_fail(tmp_path):
    """A directory with BENCHMARK.json and the files under `paths`
    alone has no program: the run exits non-zero and prints nothing."""
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\nfrom benchmark import run\n"
            f"sys.exit(run.main({tiny.argv('spread-deploy')!r}, device='cpu'))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "open_simulator_tpu_torch_x", sys)
    assert "open_simulator_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


@pytest.mark.parametrize("seconds,least", [(2.0, 2), (0.0, 1)])
def test_window_runs_its_seconds(tiny_root, capsys, seconds, least):
    argv = tiny.argv("spread-deploy", seconds=seconds)
    assert run.main(argv, root=tiny_root, device="cpu") == 0
    line = tiny.result_line(capsys.readouterr().out)
    assert line["attempted"] >= least and line["correct"] is True
    assert line["metrics"]["deploy_pods_per_s"]["unit"] == "pods/s"


@pytest.mark.cuda
def test_cell_on_the_card(tiny_root, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    assert run.main(tiny.argv("spread-deploy", trace=1), root=tiny_root) == 0
    line = tiny.result_line(capsys.readouterr().out)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


def _rollout(nodes: int, sets: int, seed: int = 2**31 + 77, index: int = -1):
    """A rollout of `sets` StatefulSets of 100 pods of 500m / 1Gi on
    `nodes` nodes of 32 CPU / 128Gi in 3 zones, every 23rd node tainted,
    half the sets (drawn from the seed) with hostname anti-affinity
    against their own label and the others with a zone spread of maxSkew
    1: the request on which the fault was first seen, drawn from the
    seed as it was then."""
    import numpy as np

    from benchmark import generate

    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), index + 1]))
    ids = np.arange(nodes)
    tainted = ((ids - int(rng.integers(23))) % 23) == 0
    zone = (ids + int(rng.integers(3))) % 3
    tag = f"rollout-{index + 1}-{generate._token(rng)}"
    anti = np.zeros(sets, dtype=bool)
    anti[rng.permutation(sets)[:round(sets * 0.5)]] = True
    token = generate._token(rng)
    node = {"cpu": "32", "memory": "128Gi", "pods": "110"}
    zone_key = "topology.kubernetes.io/zone"
    inst = generate.Instance(
        tag=tag, namespace="rollout", node_names=[f"node-{i:05d}" for i in range(nodes)],
        node_cpu_m=np.full(nodes, 32000), node_mem=np.full(nodes, 128 << 30),
        node_pods=np.full(nodes, 110), tainted=tainted, zone=zone,
        zone_names=["zone-a", "zone-b", "zone-c"], zone_key=zone_key,
        taint={"key": "dedicated", "value": "infra", "effect": "NoSchedule"},
        node_spec=node, new_node_spec=node, new_node_zone=0, max_new=100)
    for i in range(sets):
        name = f"svc-{token}-{i:03d}"
        own = {"app": name}
        inst.workloads.append(generate.Workload(
            name=name, kind="StatefulSet", replicas=100, cpu="500m", memory="1Gi",
            anti=[{"key": generate.HOSTNAME_KEY, "selector": own}] if anti[i] else [],
            spread=[] if anti[i] else [{"key": zone_key, "max_skew": 1, "selector": own}]))
    return inst


FAULT = pytest.mark.xfail(strict=True, raises=RuntimeError,
                          reason="the fused_scan_terms launch fails with cudaError 1 at 30 "
                          "sets x 100 pods on 300 nodes: PERF.md, Open questions")


@pytest.mark.cuda
@pytest.mark.parametrize("nodes,sets", [(200, 20), pytest.param(300, 30, marks=FAULT)])
def test_terms_launch_at_200_nodes_on_the_card(tmp_path, nodes, sets):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from benchmark import check
    from benchmark.reference import kube_v120
    from open_simulator_tpu_torch import cli

    inst = _rollout(nodes, sets)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["apply", "-f", inst.write(str(tmp_path / "req"))])
    assert rc == 0
    ans = check.parse(out.getvalue(), inst)
    ref = check.Reference(kube_v120.schedule)
    assert check.compare(ans, inst, ref.at(inst)) == {k: 0 for k in check.LIMITS}


def test_the_rollout_of_the_fault_is_sound_on_the_cpu(tmp_path):
    """The plain versions answer that request as the reference does."""
    from benchmark import check
    from benchmark.reference import kube_v120
    from open_simulator_tpu_torch import cli

    inst = _rollout(200, 20)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["apply", "-f", inst.write(str(tmp_path / "req")), "--device", "cpu"])
    assert rc == 0
    ans = check.parse(out.getvalue(), inst)
    ref = check.Reference(kube_v120.schedule)
    assert check.compare(ans, inst, ref.at(inst)) == {k: 0 for k in check.LIMITS}
