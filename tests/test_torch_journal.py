"""The GPU port's resumable planning journal (`runtime/journal.py`,
`CapacitySweep.attach_journal`, `Applier.open_journal`, `apply
--journal / --resume`) on the CPU:

- a `--journal` run, then `--resume`, prints identical report bytes and
  the resume runs zero probes (no scan of the kernel or its plain
  version);
- a changed config refuses to resume (JournalMismatch, exit 2);
- the probe records equal the JAX package's for the same plan (the JAX
  sweep's Pallas plan forced on, in interpret mode, so that both
  searches ask for the same counts); only the header's fingerprint
  differs, since the port's engine is `cuda`;
- the N+K escalation journals its scenario verdicts and a resume
  replays them;
- `simon chaos --journal` / `--resume` replays every scenario verdict;
- a torn final line is dropped and the run continues."""

import contextlib
import io
import json

import pytest

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu.ops import pallas_scan
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.ops import fused_scan
from open_simulator_tpu_torch.runtime.journal import Journal, JournalMismatch
from open_simulator_tpu_torch.utils.trace import GLOBAL
from tests.test_torch_apply import _config, _deploy, _node, _synthetic

QUICKSTART = "example/simon-config.yaml"


def _cli(main, reset, argv):
    reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _port(argv):
    return _cli(port_cli.main, port_reset, argv + ["--device", "cpu"])


@pytest.fixture
def scans(monkeypatch):
    """Counts the scans the port's sweep runs (single and batch)."""
    seen = []
    single, batch = fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch

    def count_single(*a, **k):
        seen.append("single")
        return single(*a, **k)

    def count_batch(*a, **k):
        seen.append("batch")
        return batch(*a, **k)

    monkeypatch.setattr(fused_scan, "run_fused_scan", count_single)
    monkeypatch.setattr(fused_scan, "run_fused_scan_batch", count_batch)
    return seen


def _records(path):
    lines = [json.loads(x) for x in open(path)]
    return lines[0], lines[1:]


@pytest.mark.parametrize("case", ["base", "quickstart"])
def test_resume_reruns_no_probe_and_prints_the_same_bytes(case, tmp_path, scans):
    if case == "quickstart":
        cfg = QUICKSTART
    else:
        nodes, apps, new_node, _ = _synthetic("base")
        cfg = _config(tmp_path, nodes, apps, new_node)
    path = str(tmp_path / "plan.jsonl")
    first = _port(["apply", "-f", cfg, "--format", "json", "--journal", path])
    assert first[0] == 0 and scans
    header, recs = _records(path)
    assert header["kind"] == "header" and recs and all(r["kind"] == "probe" for r in recs)
    scans.clear()
    GLOBAL.reset()
    again = _port(["apply", "-f", cfg, "--format", "json", "--resume", path, "--trace"])
    assert again[:2] == first[:2]
    # the resume replays the journal: no scan, one serve from the journal
    # for each count the search asks for
    assert scans == []
    assert json.loads(again[2])["notes"]["journal-resume"] == f"{len(recs)} record(s) replayed"


def test_changed_config_refuses_to_resume(tmp_path):
    nodes, apps, new_node, _ = _synthetic("base")
    (tmp_path / "a").mkdir()
    cfg = _config(tmp_path / "a", nodes, apps, new_node)
    path = str(tmp_path / "plan.jsonl")
    assert _port(["apply", "-f", cfg, "--format", "json", "--journal", path])[0] == 0
    (tmp_path / "b").mkdir()
    other = _config(tmp_path / "b", nodes, [("web", [_deploy("web", 15)])], new_node)
    rc, out, err = _port(["apply", "-f", other, "--format", "json", "--resume", path])
    assert rc == 2 and not out and "fingerprint" in err
    from open_simulator_tpu_torch.apply.applier import Applier, SimonConfig

    a = Applier(SimonConfig.from_file(other), resume_path=path, device="cpu")
    with pytest.raises(JournalMismatch):
        a.run()


def test_probe_records_equal_the_jax_packages(tmp_path, monkeypatch):
    nodes, apps, new_node, _ = _synthetic("base")
    cfg = _config(tmp_path, nodes, apps, new_node)
    monkeypatch.setattr(pallas_scan, "FORCE_ENABLE", True)
    jpath, ppath = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    want = _cli(jax_cli.main, jax_reset, ["apply", "-f", cfg, "--format", "json",
                                          "--journal", jpath])
    got = _port(["apply", "-f", cfg, "--format", "json", "--journal", ppath])
    assert got[:2] == want[:2]
    jhead, jrecs = _records(jpath)
    phead, precs = _records(ppath)
    assert precs == jrecs and len(precs) >= 2
    assert {r["count"] for r in precs} >= {json.loads(got[1])["newNodeCount"]}
    assert phead["version"] == jhead["version"] and phead["fingerprint"] != jhead["fingerprint"]


def test_nplusk_journals_scenario_verdicts(tmp_path, scans):
    """N+1 on two nodes: the escalation journals its probes and every
    scenario verdict; the resume replays them without a scan and
    prints the same report."""
    nodes = [_node(f"n{i}") for i in range(2)]
    cfg = _config(tmp_path, nodes, [("web", [_deploy("web", 6)])], _node("template"))
    path = str(tmp_path / "nplusk.jsonl")
    argv = ["apply", "-f", cfg, "--format", "json", "--tolerate-node-failures", "1"]
    first = _port(argv + ["--journal", path])
    assert first[0] == 0 and json.loads(first[1])["newNodeCount"] == 1
    _, recs = _records(path)
    kinds = [r["kind"] for r in recs]
    assert "scenario" in kinds and "probe" in kinds
    scans.clear()
    GLOBAL.reset()
    again = _port(argv + ["--resume", path, "--trace"])
    assert again[:2] == first[:2] and scans == []
    assert "scenario verdict(s) replayed" in json.loads(again[2])["notes"]["chaos-journal"]


def test_torn_tail_is_dropped_and_appending_continues(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = Journal.create(path, "fp")
    j.record_probe({"count": 1, "unscheduled": 0})
    j.record_probe({"count": 2, "unscheduled": 0})
    j.close()
    with open(path, "a") as f:
        f.write('{"count": 3, "unsch')
    r = Journal.resume(path, "fp")
    assert (r.replayed, r.dropped) == (2, 1) and sorted(r.probes) == [1, 2]
    r.record_probe({"count": 3, "unscheduled": 1})
    r.close()
    again = Journal.resume(path, "fp")
    assert sorted(again.probes) == [1, 2, 3] and again.dropped == 0
    again.close()
    with pytest.raises(JournalMismatch):
        Journal.resume(path, "other")


def test_chaos_journal_resume_replays_every_verdict(tmp_path, scans):
    """`simon chaos --journal` then `--resume`: the same bytes as the
    JAX CLI's run, every scenario verdict replayed and no scan."""
    cfg = "example/simon-gpushare-config.yaml"
    path = str(tmp_path / "chaos.jsonl")
    argv = ["chaos", "-f", cfg, "--failures", "2", "--format", "json"]
    want = _cli(jax_cli.main, jax_reset, argv)
    first = _port(argv + ["--journal", path])
    assert first[:2] == want[:2]
    _, recs = _records(path)
    n_scen = sum(r["kind"] == "scenario" for r in recs)
    assert n_scen == json.loads(first[1])["total"]
    scans.clear()
    GLOBAL.reset()
    again = _port(argv + ["--resume", path, "--trace"])
    assert again[:2] == want[:2] and scans == []
    note = json.loads(again[2])["notes"]["chaos-journal"]
    assert note.endswith(f"{n_scen}/{n_scen} scenario verdict(s) replayed from the journal")
