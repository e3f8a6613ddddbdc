"""The report's readers (`metrics/report_ms.plan.py`, `report_ms.deploy.py`):
the sum of the program's `report/nodes` and `report/pods` phases a
request, read from a run the harness recorded, and nothing from a
program without those phases."""

import pytest

from benchmark import cells, run
from benchmark.record import Request, Run
from benchmark.tests import tiny

READERS = {"plan": "report_ms.plan", "deploy": "report_ms.deploy"}


def _run(kind, phases):
    return Run(workload="w", kind=kind, setup_s=1.0, window_s=2.0,
               requests=[Request(tag=f"r{i}", ok=True, seconds=1.0, phases=p)
                         for i, p in enumerate(phases)])


@pytest.mark.parametrize("kind", sorted(READERS))
def test_the_mean_of_both_tables_in_ms(kind):
    read = cells.load_reader(str(tiny.REPO), READERS[kind])
    both = [{"apply/report": 0.5, "report/nodes": 0.01, "report/pods": 0.2},
            {"apply/report": 0.4, "report/nodes": 0.03, "report/pods": 0.3}]
    assert read(_run(kind, both)) == pytest.approx(270.0)
    # the other kind of run, and a program without the phases (the
    # parent's: `apply/report` alone), give nothing
    other = "deploy" if kind == "plan" else "plan"
    assert read(_run(other, both)) is None
    assert read(_run(kind, [{"apply/report": 0.5}, {"apply/report": 0.4}])) is None
    assert read(_run(kind, [both[0], {"apply/report": 0.4, "report/nodes": 0.03}])) is None


@pytest.mark.parametrize("workload,name", [("basic-plan", "report_ms.plan"),
                                           ("spread-deploy", "report_ms.deploy")])
def test_read_from_a_recorded_run(tiny_root, capsys, workload, name):
    assert run.main(tiny.argv(workload, trace=1), root=tiny_root, device="cpu") == 0
    line = tiny.result_line(capsys.readouterr().out)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert 0 < metrics[name]["value"] < metrics[f"front_ms.{name.split('.')[1]}"]["value"]
    assert metrics[name]["unit"] == "ms"
