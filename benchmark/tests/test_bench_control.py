"""The comparison's control and the faults it has to catch.

The controls are the reference in the program's place with a stated
guarantee broken (benchmark/reference/control.py); each fault breaks the
port's timed path underneath a whole run (the harness's look for a card
skipped, the kernels' plain versions on the CPU). Every one of them has
to come out as not correct."""

import numpy as np
import pytest

from benchmark import cells, check, run
from benchmark.reference import control
from benchmark.tests import tiny

CELLS = ["basic-plan", "spread-deploy"]


# each cell's control, and the number it has to fail there
CONTROLS = {"basic-plan": ("fit_strict", "wrong_counts"),
            "spread-deploy": ("tie_last", "misplaced_pods")}
FAULTS_IN_REFERENCE = {"half_left_out": "missing_pods", "count_off": "wrong_counts",
                       "state_unchanged": "wrong_alloc_nodes"}
CASES = [(cell, *CONTROLS[cell]) for cell in CELLS] + [
    (cell, variant, number) for cell in CELLS for variant, number in FAULTS_IN_REFERENCE.items()]


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
@pytest.mark.parametrize("workload,variant,number", CASES)
def test_control_and_planted_faults_are_not_correct(tiny_root, workload, variant, number, seed):
    cell = cells.load_cell(tiny_root, workload)
    nums = control.readings(cell, seed, variant)
    assert not check.verdict(nums, failed=0), nums
    assert nums[number] > 0, nums


def _alter_first(placements, valid):
    p = placements.clone()
    nodes = np.flatnonzero(np.asarray(valid))
    i = int((p >= 0).nonzero()[0][0])
    p[i] = int(nodes[nodes != int(p[i])][0])
    return p


def _answer_altered(monkeypatch):
    """One pod's node changed where the scan produces it."""
    from open_simulator_tpu_torch.ops import fused_scan

    one, many = fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch

    def run_one(plan, class_of_pod, active, valid, *a, **k):
        placements, final = one(plan, class_of_pod, active, valid, *a, **k)
        return _alter_first(placements, valid), final

    def run_many(plan, class_of_pod, scenarios, *a, **k):
        out = many(plan, class_of_pod, scenarios, *a, **k)
        return [(_alter_first(p, s[1]), f) for (p, f), s in zip(out, scenarios)]

    monkeypatch.setattr(fused_scan, "run_fused_scan", run_one)
    monkeypatch.setattr(fused_scan, "run_fused_scan_batch", run_many)


def _state_unchanged(monkeypatch):
    """The replay's commit step returns the nodes' state unchanged."""
    from open_simulator_tpu_torch.scheduler.oracle import Oracle

    monkeypatch.setattr(Oracle, "commit_simple_bulk", lambda self, *a, **k: None)


def _half_left_out(monkeypatch):
    """Half of each workload's pods left out of the request."""
    from open_simulator_tpu_torch.models import workloads

    expand = workloads._expand_template
    monkeypatch.setattr(workloads, "_expand_template",
                        lambda owner, kind, count: expand(owner, kind, count // 2))


def _report_garbled(monkeypatch):
    """The report's rows cut where they are written."""
    from open_simulator_tpu_torch.apply import report

    render = report.render_table
    monkeypatch.setattr(report, "render_table",
                        lambda headers, rows: render(headers, [r[:2] + ["?"] + r[3:]
                                                               for r in rows]))


FAULTS = {"answer_altered": _answer_altered, "state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out, "report_garbled": _report_garbled}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_under_a_whole_run_is_not_correct(tiny_root, workload, fault, monkeypatch,
                                                capsys):
    FAULTS[fault](monkeypatch)
    assert run.main(tiny.argv(workload), root=tiny_root, device="cpu") == 0
    line = tiny.result_line(capsys.readouterr().out)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_root, workload, capsys):
    assert run.main(tiny.argv(workload), root=tiny_root, device="cpu") == 0
    line = tiny.result_line(capsys.readouterr().out)
    assert line["correct"] is True, line["checks"]
