"""BENCHMARK.json against the contract's rules, and every part of a
cell found by its name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import cells, run
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = tiny.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [c["name"] for c in MAN["configs"]] + CELLS
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(MAN)) < 64 * 1024
    for conf in MAN["configs"]:
        assert set(conf) == {"name", "source", "file", "reduced", "why"}
    for cell in MAN["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1
    for entry in MAN["configs"] + MAN["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_reports_what_the_contract_asks(workload):
    e2e = {m["name"] for m in MAN["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]}
    per = [m for m in MAN["per_layer"] if "workloads" not in m or workload in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e and m["layer"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_parts_found_by_name(workload):
    root = str(tiny.REPO)
    cell = cells.load_cell(root, workload)
    entry = next(w for w in MAN["workloads"] if w["name"] == workload)
    assert cell.config["name"] == entry["config"] and cell.chips == entry["chips"] == 1
    assert (tiny.BENCH / "traffic" / f"{entry['traffic']}.json").is_file()
    assert cells.load_driver(root, cell).Driver
    assert {m.name for m in cell.metrics} >= {"setup_s"}
    for m in cell.metrics:
        assert callable(m.read)
    assert cells.load_reference(cell.config).__module__.startswith("benchmark.reference.")


def test_config_files_name_their_reductions():
    for conf in MAN["configs"]:
        with open(tiny.REPO / conf["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
        assert cfg["source"] == conf["source"]


def test_unknown_parts_are_refused(tiny_root):
    with pytest.raises(cells.CellError):
        cells.load_cell(tiny_root, "no-such-cell")
    Path(tiny_root, "benchmark", "metrics", "plan_s.py").unlink()
    with pytest.raises(cells.CellError):
        cells.load_cell(tiny_root, "basic-plan")


COUNTING_DRIVER = """\
from benchmark.drivers import simon_apply

LIMITS = simon_apply.LIMITS


class Driver(simon_apply.Driver):
    def judge(self, inst, text):
        numbers, facts = super().judge(inst, text)
        return numbers, dict(facts, judged_by="counting_apply")
"""


def test_new_cell_added_by_new_files_alone(tiny_root, capsys):
    """A configuration, a traffic mix with a driver of its own and a
    per-layer metric added as new files, with entries in BENCHMARK.json,
    run with no edit to a file that was there."""
    root = Path(tiny_root)
    cfg = json.loads((root / "benchmark/configs/k8s-5k-basic.json").read_text())
    cfg["name"], cfg["nodes"] = "k8s-small-basic", 20
    (root / "benchmark/configs/k8s-small-basic.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/capacity-plan.json").read_text())
    traffic["ring"], traffic["driver"] = 2, "counting_apply"
    traffic["workloads"][0]["replicas"] = 820  # 20 nodes hold 800: the plan adds one
    (root / "benchmark/traffic/small-plan.json").write_text(json.dumps(traffic))
    (root / "benchmark/drivers/counting_apply.py").write_text(COUNTING_DRIVER)
    (root / "benchmark/metrics/requests_judged.plan.py").write_text(
        "def read(run):\n"
        "    return float(sum(getattr(r, 'judged_by', '') == 'counting_apply'\n"
        "                     for r in run.done))\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "k8s-small-basic", "source": cfg["source"],
                           "file": "benchmark/configs/k8s-small-basic.json", "reduced": []})
    man["workloads"].append({"name": "small-plan", "config": "k8s-small-basic",
                             "traffic": "small-plan", "chips": 1, "why": "a test's cell"})
    for m in man["end_to_end"]:
        if "workloads" in m and "basic-plan" in m["workloads"]:
            m["workloads"].append("small-plan")
    man["per_layer"].append({"name": "requests_judged.plan", "unit": "requests",
                             "better": "higher", "source": "program_counter",
                             "layer": "front end", "moves": "plan_s",
                             "workloads": ["small-plan"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert run.main(tiny.argv("small-plan", trace=1), root=tiny_root, device="cpu") == 0
    line = tiny.result_line(capsys.readouterr().out)
    assert line["correct"] is True
    assert line["metrics"]["requests_judged.plan"]["value"] == line["attempted"] >= 1


def test_reader_that_finds_nothing_is_left_out(tiny_root, capsys):
    assert run.main(tiny.argv("spread-deploy", trace=1), root=tiny_root, device="cpu") == 0
    line = tiny.result_line(capsys.readouterr().out)
    # no card: no device metric is read, and none is written as zero
    assert "device_idle_pct.deploy" not in line["metrics"]
    assert "terms_roofline.deploy" not in line["metrics"]
    assert {"front_ms.deploy", "encode_ms.deploy", "replay_ms.deploy"} <= set(line["metrics"])

