"""The GPU port's observability and guard flags against the JAX
package's CLI, on the CPU (`--device cpu`, the kernels' plain versions):

- `--explain` (all unschedulable pods, or one named pod), in table and
  JSON form, on the quickstart and on a failing config, prints the JAX
  bytes; so do `defrag --explain` and `chaos --explain`;
- `--inject 'budget.check=deadline@N'` and `...=interrupt@N` give the
  JAX PARTIAL bytes and exit codes 3 and 4 (apply and chaos, table and
  JSON); `-i` with `--deadline` is refused with exit 2 in both;
- `--inject 'io.kube*=reset@1x3'` on a kubeConfig cluster and a bad
  spec exit 2 in both;
- `--inject 'jit.sweep_many=oom@1'` halves the port's batch of probes,
  notes it, and answers as a clean run does;
- `--trace-out` writes a well-formed Chrome trace (`.json`) or JSONL
  stream (`.jsonl`) with a span for every launch and the observatory
  block; `--profile-dir` writes one capture a device phase;
- `version`, `gen-doc` and `doctor` run."""

import json
import os

import pytest

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu.runtime.inject import INJECT as JINJECT
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.runtime.inject import INJECT as PINJECT
from tests.test_torch_apply import _config, _run, _synthetic

QUICKSTART = "example/simon-config.yaml"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    JINJECT.clear()
    PINJECT.clear()


def _both(argv, port_extra=("--device", "cpu")):
    """(rc, stdout, stderr) of the JAX CLI and of the port's."""
    j = _run(jax_cli.main, jax_reset, list(argv))
    JINJECT.clear()
    p = _run(port_cli.main, port_reset, list(argv) + list(port_extra))
    PINJECT.clear()
    return j, p


def _same(argv, port_extra=("--device", "cpu")):
    j, p = _both(argv, port_extra)
    assert p[:2] == j[:2], p[2]
    return p


def _a_pod_name():
    rc, out, _ = _run(port_cli.main, port_reset,
                      ["apply", "-f", QUICKSTART, "--format", "json", "--device", "cpu"])
    doc = json.loads(out)
    pods = [p for n in doc["nodes"] for p in n["pods"] if p["app"] == "web"]
    return f"{pods[0]['namespace']}/{pods[0]['name']}"


@pytest.mark.parametrize("fmt", ["table", "json"])
@pytest.mark.parametrize("target", ["all", "pod"])
def test_explain_prints_the_jax_bytes(fmt, target):
    argv = ["apply", "-f", QUICKSTART, "--format", fmt, "--explain"]
    if target == "pod":
        argv.append(_a_pod_name())
    rc, out, _ = _same(argv)
    assert rc == 0
    if target == "pod":
        text = json.dumps(json.loads(out)["explain"]) if fmt == "json" else out
        assert "scheduled on" in text or "chosen" in text


@pytest.mark.parametrize("fmt", ["table", "json"])
def test_explain_on_a_failing_config_prints_the_jax_bytes(fmt, tmp_path):
    """No newNode spec and pods that do not fit: the unschedulable pods'
    verdict tables."""
    nodes, apps, _new_node, _ = _synthetic("base")
    cfg = _config(tmp_path, nodes, apps, None)
    rc, out, _ = _same(["apply", "-f", cfg, "--format", fmt, "--explain"])
    assert rc == 1
    if fmt == "json":
        assert json.loads(out)["explain"]
    else:
        assert "Filter Verdict" in out


@pytest.mark.parametrize("fmt", ["table", "json"])
def test_explain_on_a_cap_failure_prints_the_jax_bytes(fmt, monkeypatch):
    monkeypatch.setenv("MaxVG", "20")
    rc, _, _ = _same(["apply", "-f", QUICKSTART, "--format", fmt, "--explain"])
    assert rc == 1


@pytest.mark.parametrize("cmd", ["apply", "chaos"])
@pytest.mark.parametrize("fmt", ["table", "json"])
@pytest.mark.parametrize("spec,code", [("budget.check=deadline@1", 3),
                                        ("budget.check=deadline@2", 3),
                                        ("budget.check=interrupt@1", 4)])
def test_partial_reports_equal_the_jax_package(cmd, fmt, spec, code):
    rc, out, _ = _same([cmd, "-f", QUICKSTART, "--format", fmt, "--inject", spec])
    if cmd == "apply" and spec.endswith("@2"):
        # the quickstart's plan has one capacity-probe boundary
        assert rc == 0
        return
    assert rc == code
    if fmt == "json":
        doc = json.loads(out)
        assert doc["partial"] and doc["exitCode"] == code
    else:
        assert out.startswith("PARTIAL RESULT")


def test_partial_report_names_the_journal(tmp_path):
    """A halted run with --journal names it in the PARTIAL body; the
    JAX package's and the port's journals differ in path only."""
    outs = []
    for main, reset, extra in ((jax_cli.main, jax_reset, []),
                               (port_cli.main, port_reset, ["--device", "cpu"])):
        journal = tmp_path / "plan.jsonl"
        outs.append(_run(main, reset, ["apply", "-f", QUICKSTART, "--journal", str(journal),
                                       "--inject", "budget.check=deadline@1", *extra])[:2])
        JINJECT.clear()
        PINJECT.clear()
        journal.unlink()
    assert outs[1] == outs[0] and outs[0][0] == 3
    assert f"--resume {tmp_path / 'plan.jsonl'}" in outs[0][1]


def test_interactive_refuses_a_deadline():
    (jrc, jout, jerr), (prc, pout, perr) = _both(
        ["apply", "-f", QUICKSTART, "-i", "--deadline", "5"])
    assert (prc, pout, perr) == (jrc, jout, jerr) and prc == 2


@pytest.mark.parametrize("spec", ["bogus", "jit.scan=nosuchfault", "budget.check=oom@0"])
def test_bad_inject_spec_exits_2(spec):
    (jrc, jout, _), (prc, pout, _) = _both(["apply", "-f", QUICKSTART, "--inject", spec])
    assert (prc, pout) == (jrc, jout) and prc == 2


def test_kube_resets_exit_2(tmp_path, stub):
    from open_simulator_tpu.runtime.retry import reset_io_state as jreset_io
    from open_simulator_tpu_torch.runtime.retry import reset_io_state as preset_io
    from tests.test_torch_kubeclient import _live_config, _live_stub

    cfg = _live_config(tmp_path, _live_stub(stub))
    for spec in ("io.kube*=reset@1x3",):
        jreset_io()
        preset_io()
        (jrc, jout, _), (prc, pout, perr) = _both(["apply", "-f", cfg, "--inject", spec])
        assert (prc, pout) == (jrc, jout) and prc == 2
        assert "error:" in perr
    jreset_io()
    preset_io()


@pytest.fixture
def stub():
    from tests.test_torch_kubeclient import _StubApiServer

    servers = []

    def make(**kw):
        srv = _StubApiServer(**kw)
        servers.append(srv)
        return srv

    yield make
    for srv in servers:
        srv.stop()


def test_oom_at_the_batch_launch_halves_and_answers_alike(tmp_path):
    """`jit.sweep_many=oom@1`: the port's first batch of probes (a plan
    that must add nodes searches in pairs) raises a device OOM where it
    would launch; the chunked executor halves it (trace note
    `sweep-chunk-halving`) and the plan's bytes are a clean run's, which
    are the JAX package's."""
    nodes, apps, new_node, extra = _synthetic("gpushare")
    argv = ["apply", "-f", _config(tmp_path, nodes, apps, new_node, extra), "--format", "json"]
    j = _run(jax_cli.main, jax_reset, argv)
    p = _run(port_cli.main, port_reset,
             argv + ["--device", "cpu", "--trace", "--inject", "jit.sweep_many=oom@1"])
    assert p[:2] == j[:2]
    notes = json.loads(p[2].strip().splitlines()[-1])["notes"]
    assert "sweep-chunk-halving" in notes and "sweep-degraded" in notes


def _spans_of(path):
    if path.endswith(".jsonl"):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return [(r["id"], r.get("parent"), r["name"]) for r in rows if r["kind"] == "span"], None
    with open(path) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    for e in xs:
        assert e["dur"] >= 0 and {"name", "ts", "dur", "pid", "tid"} <= set(e)
    return ([(e["args"]["span_id"], e["args"].get("parent_id"), e["name"]) for e in xs],
            doc.get("simonObservatory"))


def _depth(spans):
    parent = {sid: pid for sid, pid, _ in spans}

    def d(sid):
        n = 0
        while sid is not None:
            n += 1
            sid = parent.get(sid)
        return n

    return max(d(sid) for sid, _, _ in spans)


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_trace_out_is_well_formed(tmp_path, suffix):
    from open_simulator_tpu_torch.utils.trace import COUNTERS
    from tools.validate_trace import _validate_histograms

    path = str(tmp_path / f"t{suffix}")
    before = COUNTERS.get("launches_total")
    rc, out, err = _run(port_cli.main, port_reset,
                        ["apply", "-f", QUICKSTART, "--device", "cpu", "--trace-out", path])
    assert rc == 0 and f"span trace written to {path}" in err
    launches = COUNTERS.get("launches_total") - before
    spans, block = _spans_of(path)
    names = [n for _, _, n in spans]
    assert names.count("simon apply") == 1 and _depth(spans) >= 3
    assert sum(n.startswith("launch/") for n in names) == launches > 0
    if suffix == ".json":
        assert {"costs", "histograms"} <= set(block)
        assert _validate_histograms(block["histograms"]) >= 1
        for site, row in block["costs"].items():
            if site == "_totals":
                continue
            assert row["signatures"] == len(row["records"]) >= 1
            for rec in row["records"]:
                assert rec["bytes"] > 0 and rec["workspace_bytes"] > 0
                assert rec["bound_by"] in ("bytes", "operations")


def test_defrag_and_chaos_explain_print_the_jax_bytes(tmp_path):
    snaps = [tmp_path / "j.json", tmp_path / "p.json"]
    _run(jax_cli.main, jax_reset, ["apply", "-f", QUICKSTART, "--snapshot", str(snaps[0])])
    _run(port_cli.main, port_reset,
         ["apply", "-f", QUICKSTART, "--snapshot", str(snaps[1]), "--device", "cpu"])
    j = _run(jax_cli.main, jax_reset,
             ["defrag", "--snapshot", str(snaps[0]), "--format", "json", "--explain"])
    p = _run(port_cli.main, port_reset, ["defrag", "--snapshot", str(snaps[1]), "--format",
                                         "json", "--explain", "--device", "cpu"])
    assert p[:2] == j[:2]
    _same(["chaos", "-f", QUICKSTART, "--explain"])


def test_profile_dir_captures_the_device_phases(tmp_path):
    """On the CPU the capture holds the plain version's CPU activity (the
    phase's work is on the CPU); one Chrome trace a device phase run, no
    capture of the YAML load."""
    d = tmp_path / "prof"
    rc, _, err = _run(port_cli.main, port_reset, ["apply", "-f", QUICKSTART, "--device", "cpu",
                                                 "--profile-dir", str(d)])
    assert rc == 0 and "torch.profiler capture(s)" in err
    names = sorted(os.listdir(d))
    assert names and all(n.startswith(("sweep_probe-", "engine_scan-")) for n in names)
    with open(d / names[0]) as f:
        assert json.load(f)["traceEvents"]
    assert "SIMON_PROFILE_DIR" not in os.environ


def test_version_gen_doc_and_doctor_run(tmp_path):
    rc, out, _ = _run(port_cli.main, port_reset, ["version"])
    assert rc == 0 and out.startswith("simon-torch version ")
    rc, out, _ = _run(port_cli.main, port_reset, ["gen-doc", "--output", str(tmp_path)])
    pages = sorted(os.listdir(tmp_path))
    assert rc == 0 and "simon.md" in pages and "simon_apply.md" in pages
    with open(tmp_path / "simon_apply.md") as f:
        page = f.read()
    assert "--trace-out" in page and "--inject" in page and "--interactive" in page
    rc, out, _ = _run(port_cli.main, port_reset, ["doctor", "BENCH_r08.json", "BENCH_r08.json"])
    assert rc == 0
