"""The GPU port's `simon doctor` (open_simulator_tpu_torch/obs/doctor.py)
against the JAX package's: on pairs of the repo's BENCH_r*.json (the JAX
package's bench-record format), and on a seeded regression, the port's
text and JSON reports and exit codes equal the JAX doctor's."""

import glob
import json

import pytest

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu.obs import doctor as jdoctor
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.obs import doctor as pdoctor
from tests.test_torch_apply import _run

RECORDS = sorted(glob.glob("BENCH_r*.json"))
PAIRS = [(a, a) for a in RECORDS[:2]] + list(zip(RECORDS, RECORDS[1:]))


def test_the_repo_has_bench_records():
    assert len(RECORDS) >= 2


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("base,cand", PAIRS)
def test_doctor_reports_equal_the_jax_doctor(base, cand, fmt):
    argv = ["doctor", base, cand, "--format", fmt]
    j = _run(jax_cli.main, jax_reset, argv)
    p = _run(port_cli.main, port_reset, argv)
    assert p == j
    assert p[0] in (0, 1)


def test_seeded_regression_is_caught_alike(tmp_path):
    rec = pdoctor.load_bench_record(RECORDS[-1])
    assert rec == jdoctor.load_bench_record(RECORDS[-1])
    worse = json.loads(json.dumps(rec))
    worse.setdefault("obs", {})["jax_dispatches"] = worse["obs"].get("jax_dispatches", 0) + 7
    path = tmp_path / "worse.json"
    path.write_text(json.dumps(worse))
    argv = ["doctor", RECORDS[-1], str(path), "--format", "json"]
    j = _run(jax_cli.main, jax_reset, argv)
    p = _run(port_cli.main, port_reset, argv)
    assert p == j and p[0] == 1
    assert any(r["regressed"] for r in json.loads(p[1])["rows"])


def test_unreadable_record_exits_2(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("not json at all")
    argv = ["doctor", str(bad), RECORDS[0]]
    j = _run(jax_cli.main, jax_reset, argv)
    p = _run(port_cli.main, port_reset, argv)
    assert (p[0], p[1]) == (j[0], j[1]) and p[0] == 2
