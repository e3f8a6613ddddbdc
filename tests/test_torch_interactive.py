"""The GPU port's interactive shell (`simon apply -i`,
open_simulator_tpu_torch/apply/interactive.py) against the JAX
package's, exactly: the scripted transcripts of tests/test_interactive.py's
cases (show reasons, add nodes, exit, pick by name, narrow the node
report, the serial evaluator of a priority workload, EOF and junk input,
the utilization-cap loop) give identical bytes and identical results,
the port's guesses on the kernels' plain versions on the CPU."""

import io
import os

import pytest
import yaml

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.apply import applier as japplier
from open_simulator_tpu.apply import interactive as jinteractive
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu.testing import make_fake_node
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.apply import applier as papplier
from open_simulator_tpu_torch.apply import interactive as pinteractive
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.obs.explain import EXPLAIN as PEXPLAIN
from tests.test_torch_apply import _run as _run_cli


def _write_yaml(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)


def _deployment(name, replicas, cpu, priority=None):
    spec = {"containers": [{"name": "c", "image": "img",
                            "resources": {"requests": {"cpu": cpu}}}]}
    if priority is not None:
        spec["priority"] = priority
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"replicas": replicas, "selector": {"matchLabels": {"app": name}},
                 "template": {"metadata": {"labels": {"app": name}}, "spec": spec}},
    }


def _setup(tmp_path, replicas=4, priority=None):
    """A 1-cpu node; the app needs 0.5 cpu a replica; a 2-cpu newNode."""
    root = str(tmp_path)
    _write_yaml(os.path.join(root, "cluster", "node.yaml"), make_fake_node("node-1", "1", "4Gi"))
    _write_yaml(os.path.join(root, "app", "deploy.yaml"),
                _deployment("web", replicas, "500m", priority))
    _write_yaml(os.path.join(root, "newnode", "node.yaml"),
                make_fake_node("template", "2", "8Gi"))
    cfg = os.path.join(root, "simon.yaml")
    _write_yaml(cfg, {
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "i"},
        "spec": {"cluster": {"customConfig": os.path.join(root, "cluster")},
                 "appList": [{"name": "web", "path": os.path.join(root, "app")}],
                 "newNode": os.path.join(root, "newnode")}})
    return cfg


def _transcript(mod, applier_mod, reset, cfg, script, **kw):
    reset()
    fin = io.StringIO("\n".join(script) + "\n")
    fout = io.StringIO()
    applier = applier_mod.Applier(applier_mod.SimonConfig.from_file(cfg), interactive=True, **kw)
    result = mod.run_interactive(applier, shell=mod.Shell(fin=fin, fout=fout))
    return (fout.getvalue(), result.success, result.new_node_count, result.message,
            result.report_text)


def _both(cfg, script):
    want = _transcript(jinteractive, japplier, jax_reset, cfg, script)
    got = _transcript(pinteractive, papplier, port_reset, cfg, script, device="cpu")
    assert got == want
    return got


CASES = {
    # name: (replicas, priority, MaxCPU, script, success, count)
    "show-reasons-add-nodes": (4, None, None, ["", "0", "1", "2", ""], True, 2),
    "exit-with-unscheduled": (4, None, None, ["", "2"], False, 0),
    "select-by-name-narrow-report": (4, None, None, ["web", "1", "1", "0"], True, 1),
    "priority-serial-evaluator": (4, 10, None, ["", "1", "2", ""], True, 2),
    "eof-mid-menu": (4, None, None, [""], False, 0),
    "unparseable-selection": (4, None, None, ["", "zzz"], False, 0),
    "unparseable-node-number": (4, None, None, ["", "1", "abc", "1", "2", ""], True, 2),
    "cap-loop-add-nodes": (1, None, "10", ["", "0", "2", ""], True, 2),
    "cap-loop-exit": (1, None, "10", ["", "1"], False, 0),
    "cap-loop-eof": (1, None, "10", [""], False, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transcript_equals_the_jax_shell(case, tmp_path, monkeypatch):
    replicas, priority, max_cpu, script, success, count = CASES[case]
    if max_cpu is not None:
        monkeypatch.setenv("MaxCPU", max_cpu)
    out, ok, n, _msg, _report = _both(_setup(tmp_path, replicas, priority), script)
    assert (ok, n) == (success, count)
    assert out


def test_show_reasons_with_explain_equals_the_jax_shell(tmp_path):
    """`apply -i --explain`: the verdict tables recorded during a guess's
    replay follow the reasons, in both packages."""
    from open_simulator_tpu.obs.explain import EXPLAIN as JEXPLAIN

    cfg = _setup(tmp_path)
    JEXPLAIN.enable(None)
    PEXPLAIN.enable(None)
    try:
        out, *_ = _both(cfg, ["", "0", "1", "2", ""])
    finally:
        JEXPLAIN.disable()
        PEXPLAIN.disable()
    assert "Placement Explanations" in out


def test_each_guess_is_one_probe_on_the_sweep(tmp_path):
    """A guess on the batched sweep is one instrumented scan at the
    `sweep_probe` site: the shell above asks two counts (0, then 2)."""
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    before = COUNTERS.get("launches_sweep_probe")
    _transcript(pinteractive, papplier, port_reset, _setup(tmp_path),
                ["", "1", "2", ""], device="cpu")
    assert COUNTERS.get("launches_sweep_probe") - before == 2


def test_cli_interactive_prints_the_jax_bytes(tmp_path, monkeypatch):
    """`apply -i` through the CLI on a scripted stdin."""
    cfg = _setup(tmp_path)
    outs = []
    for main, reset, extra in ((jax_cli.main, jax_reset, []),
                               (port_cli.main, port_reset, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO("\n1\n2\n\n"))
        outs.append(_run_cli(main, reset, ["apply", "-f", cfg, "-i", *extra])[:2])
    assert outs[1] == outs[0] and outs[0][0] == 0
    assert "new nodes added: 2" in outs[0][1]
