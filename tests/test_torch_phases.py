"""The port's phase totals (utils/trace.py `phase()`) over a whole
`simon apply`: one capacity plan and one spread rollout of the
benchmark's cells at its test sizes (benchmark/tests/tiny.py), through
`cli.main` on the CPU. Every phase the command is split into is timed;
with the span recorder on, the root span is covered by its phases; the
top-level phases the benchmark's readers list (benchmark/phases.py) are
the span tree's; each command, and each interactive run, reports its
own totals; and every span of one command carries one request id."""

import contextlib
import io
import os

import pytest

from benchmark import phases as bench_phases
from benchmark.tests import tiny
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.obs.spans import RECORDER
from open_simulator_tpu_torch.utils.trace import GLOBAL

QUICKSTART = os.path.join(os.path.dirname(__file__), "..", "example", "simon-config.yaml")

# the phases of the command, the load and the probe, beside the ones the
# apply path had (apply/load, sweep/*, apply/probe-search, ...)
COMMAND = ("cli/args", "cli/config", "apply/check", "apply/gc", "cli/print", "cli/release")
LOAD = ("load/read", "load/parse", "load/decode")
SWEEP = ("sweep/pad", "sweep/index")
PROBE = ("probe/inputs", "probe/wait", "probe/readback")

CELLS = {
    "plan": ("k8s-5k-basic", "capacity-plan"),
    "rollout": ("k8s-5k-spread", "spread-rollout"),
}


@pytest.fixture(scope="module")
def requests(tmp_path_factory):
    """Each cell's request written out, and answered once (the imports
    and first-call work of the process fall outside the checks)."""
    where = tmp_path_factory.mktemp("phases")
    out = {}
    for kind, (conf, mix) in CELLS.items():
        inst = tiny.instance(conf, mix, tiny.TINY_NODES[conf], tiny.TINY_REPLICAS[mix])
        out[kind] = inst.write(str(where / kind))
        _apply(out[kind])
    return out


def _apply(path, *flags):
    """One `simon apply` of the request; its phase totals."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["apply", "-f", path, "--device", "cpu", *flags])
    assert rc == 0, out.getvalue()[-2000:]
    return {p["name"]: p["count"] for p in GLOBAL.as_dict()["phases"]}


def _recorded(path):
    """(phase counts, spans) of one command with the span recorder on."""
    RECORDER.enable()
    try:
        counts = _apply(path)
        spans = RECORDER.snapshot()
    finally:
        RECORDER.disable()
        RECORDER.reset()
    return counts, spans


def _is_phase(span) -> bool:
    return span.attrs.get("kind") == "phase"


def _top_level(spans) -> set:
    """Names of the phase spans that no other phase span encloses."""
    by_id = {s.span_id: s for s in spans}

    def enclosed(s):
        while s.parent_id is not None:
            s = by_id[s.parent_id]
            if _is_phase(s):
                return True
        return False

    return {s.name for s in spans if _is_phase(s) and not enclosed(s)}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_every_phase_of_the_command_is_timed(requests, kind):
    counts = _apply(requests[kind])
    missing = [n for n in COMMAND + LOAD + SWEEP + PROBE if n not in counts]
    assert not missing
    # each phase a layer boundary: entered a few times a request, never
    # once a pod, node or file
    assert max(counts.values()) <= 5, counts


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_root_span_is_covered_by_its_phases(requests, kind):
    _, spans = _recorded(requests[kind])
    root = next(s for s in spans if s.name == "simon apply")
    kids = sorted((s.t0, s.t1) for s in spans if s.parent_id == root.span_id)
    covered, end = 0.0, root.t0
    for t0, t1 in kids:
        covered += max(t1 - max(t0, end), 0.0)
        end = max(end, t1)
    assert root.duration - covered < 0.05 * root.duration, (root.duration, covered)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_readers_top_level_phases_are_the_span_trees(requests, kind):
    counts, spans = _recorded(requests[kind])
    assert _top_level(spans) == set(bench_phases.TOP_LEVEL)
    assert set(bench_phases.OVERHEAD) <= set(bench_phases.TOP_LEVEL) <= set(counts)
    # cli/args is timed before the command's root span opens
    root = next(s for s in spans if s.name == "simon apply")
    args = next(s for s in spans if s.name == "cli/args")
    assert args.parent_id is None and args.t1 <= root.t0


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_each_command_reports_its_own_totals(requests, kind):
    first = _apply(requests[kind])
    second = _apply(requests[kind])
    assert first == second and first["cli/args"] == 1


def test_the_interactive_shell_resets_once_a_run(monkeypatch):
    runs = []
    for _ in range(2):
        monkeypatch.setattr("sys.stdin", io.StringIO("\n1\n1\n\n"))
        runs.append(_apply(QUICKSTART, "-i"))
    assert runs[0] == runs[1]
    assert runs[0]["cli/args"] == runs[0]["apply/load"] == runs[0]["cli/print"] == 1


def test_one_request_id_a_command(requests):
    ids = []
    for kind in sorted(CELLS):
        _, spans = _recorded(requests[kind])
        got = {s.attrs.get("request_id") for s in spans}
        assert len(got) == 1 and None not in got, got
        ids.append(got.pop())
    assert ids[0] != ids[1]


def test_span_clock_moves_the_spans_by_the_wait():
    """tools/span_clock.py on made-up intervals: spans 500 µs early on
    the device's timeline (the marker's error, read at the host's wait
    on a spin kernel) still nest the kernel once moved."""
    from tools.span_clock import check

    device = [("spin_kernel", 0.001, 0.011), ("fused_scan_kernel<b>", 1.0, 1.7),
              ("spin_kernel", 2.0, 2.01)]
    runtime = [("cudaEventSynchronize", 0.0015, 0.01101),
               ("cudaEventSynchronize", 1.001, 1.70002),
               ("cudaEventSynchronize", 2.001, 2.01001)]
    host = [("span-clock/sync", 0.001, 0.01051), ("launch/sweep_probe", 0.998, 0.9991),
            ("probe/wait", 0.9993, 1.69953), ("span-clock/sync", 2.0005, 2.00951)]
    out = check(device, runtime, host, 50e-6)
    assert out["ok"] and [c["span_error_us"] for c in out["calibration"]] == [500.0, 500.0]
    row = out["rows"][0]
    assert row["before_wait_closes_us"] == -470.0 and row["before_wait_closes_moved_us"] == 30.0
    # a wait that closes 100 µs before the kernel ends, once moved
    early = [h if h[0] != "probe/wait" else ("probe/wait", 0.9993, 1.6994) for h in host]
    assert not check(device, runtime, early, 50e-6)["ok"]
