"""The GPU port's chunked executor and device-error taxonomy
(`runtime/guard.py`) on the CPU, against the JAX package's behaviour
where the two agree and asserting the port's deliberate difference
where they do not:

- `run_chunked` halves a chunk on an injected
  `torch.cuda.OutOfMemoryError` and trace-notes it; a single item that
  still runs out reaches the serial floor, trace-noted, where the caller
  passes one (work on the CPU); without a floor it raises DeviceOOM;
- a non-OOM RuntimeError, an `nvcc` build error and a CUDA launch error
  propagate unchanged. The JAX package degrades a compile or backend
  failure to the serial rung (its guard.py CompileFailure /
  BackendUnavailable); the port never does;
- the sweep's many-count batches under injected OOM equal a clean run
  on the CPU; on the card a single count that still runs out raises,
  and a single probe's OOM propagates: work on the card never moves to
  the host oracle."""

import numpy as np
import pytest
import torch

import open_simulator_tpu.runtime.guard as jguard
import open_simulator_tpu_torch.runtime.guard as guard
from open_simulator_tpu_torch.runtime.errors import DeviceOOM
from open_simulator_tpu_torch.utils.trace import GLOBAL


def _oom_above(limit, log, evaluate):
    """`evaluate` that runs out of device memory on a chunk longer than
    `limit`, logging every chunk's length."""
    def run(lo, hi):
        log.append(hi - lo)
        if hi - lo > limit:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate (test)")
        return evaluate(lo, hi)
    return run


def test_run_chunked_halves_on_oom_and_notes():
    calls = []
    GLOBAL.reset()
    out = guard.run_chunked(_oom_above(2, calls, lambda lo, hi: [i * 10 for i in range(lo, hi)]),
                            8, label="sweep")
    assert out == [i * 10 for i in range(8)]
    assert max(calls) == 8 and calls.count(2) == 4
    assert "CUDA out of memory" in GLOBAL.notes["sweep-chunk-halving"]
    assert GLOBAL.notes["sweep-degraded"] == "3 chunk-halving(s), 0 serial fallback(s)"


def test_single_item_oom_reaches_the_serial_floor():
    GLOBAL.reset()
    out = guard.run_chunked(_oom_above(0, [], lambda lo, hi: list(range(lo, hi))), 3,
                            label="chaos", serial_fallback=lambda i: -i)
    assert out == [0, -1, -2]
    assert "via serial oracle" in GLOBAL.notes["chaos-serial-fallback"]
    assert GLOBAL.notes["chaos-degraded"] == "2 chunk-halving(s), 3 serial fallback(s)"
    with pytest.raises(DeviceOOM, match="CUDA out of memory"):
        guard.run_chunked(_oom_above(0, [], lambda lo, hi: list(range(lo, hi))), 2,
                          label="sweep")


@pytest.mark.parametrize("error", [
    RuntimeError("fused_scan_batch launch of LaunchShape(...) failed: cudaError 700"),
    RuntimeError("fused_scan_0123.so: nvcc failed (1):\nerror: out of memory in ptxas"),
    FileNotFoundError(2, "No such file or directory", "/usr/local/cuda/bin/nvcc"),
    ValueError("shape mismatch"),
])
def test_build_and_launch_errors_propagate_unchanged(error):
    """Build and launch failures are never downgraded: not by
    run_chunked, even with a serial floor, and not even when the
    message mentions memory."""
    def boom(_lo, _hi):
        raise error

    GLOBAL.reset()
    with pytest.raises(type(error)) as got:
        guard.run_chunked(boom, 4, label="sweep", serial_fallback=lambda i: i)
    assert got.value is error
    assert guard.classify_device_error(error) is None and not guard.is_oom(error)
    assert not any(k.endswith("-downgrade") or "serial" in k or "halving" in k
                   for k in GLOBAL.notes)


def test_the_reference_degrades_where_the_port_raises():
    """The difference, stated: the JAX package's taxonomy sends a
    compile failure to its serial rung; the port's classifies nothing
    but memory."""
    compile_err = RuntimeError("Mosaic compilation failed")
    assert jguard.classify_device_error(compile_err) is not None
    assert guard.classify_device_error(compile_err) is None
    assert guard.classify_device_error(torch.cuda.OutOfMemoryError("x")) is DeviceOOM
    assert guard.classify_device_error(MemoryError()) is DeviceOOM


def _small_sweep():
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.parallel.sweep import CapacitySweep
    from open_simulator_tpu_torch.scheduler.core import AppResource
    from tests.test_torch_apply import _deploy, _node

    cluster = ResourceTypes()
    cluster.nodes = [_node(f"n{i}") for i in range(2)]
    res = ResourceTypes()
    res.deployments = [_deploy("web", 12)]
    return CapacitySweep(cluster, [AppResource("a", res)], _node("template"), 5, device="cpu")


def _launch_oom_above(sweep, limit, monkeypatch):
    """The sweep's kernel launches (its scan layer's) run out of device
    memory above `limit` rows."""
    real = sweep.scans.launch

    def launch(rows, site, **kw):
        if len(rows) > limit:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(rows, site, **kw)

    monkeypatch.setattr(sweep.scans, "launch", launch)


def test_sweep_under_oom_equals_a_clean_run(monkeypatch):
    """probe_many on a CPU sweep with every batch above two counts
    running out: halved chunks with the clean run's answers; with every
    batch running out, the serial floor with the same answers. A single
    probe that runs out raises: it has no ladder."""
    sweep = _small_sweep()
    counts = list(range(6))
    clean = sweep.probe_many(counts)
    _launch_oom_above(sweep, 2, monkeypatch)
    GLOBAL.reset()
    halved = sweep.probe_many(counts)
    assert "sweep-chunk-halving" in GLOBAL.notes
    _launch_oom_above(sweep, 0, monkeypatch)
    floor = sweep.probe_many(counts)
    assert "sweep-serial-fallback" in GLOBAL.notes
    for got in (halved, floor):
        np.testing.assert_array_equal(got.placements, clean.placements)
        np.testing.assert_array_equal(got.unscheduled, clean.unscheduled)
        np.testing.assert_allclose(got.cpu_util, clean.cpu_util, rtol=0, atol=1e-9)

    def oom(*_a, **_k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(sweep.scans, "launch", oom)
    GLOBAL.reset()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        sweep.probe(3)
    assert not any(k.endswith("-downgrade") or "serial" in k for k in GLOBAL.notes)


def test_sweep_on_the_card_never_reaches_the_serial_floor(monkeypatch):
    """A sweep whose work is on the card halves a batch that runs out
    of device memory, and raises DeviceOOM at a single count that still
    runs out: the host oracle never takes the card's work."""
    sweep = _small_sweep()
    counts = list(range(6))
    clean = sweep.probe_many(counts)
    monkeypatch.setattr(sweep.scans, "device", torch.device("cuda"))

    def unreachable(*_a, **_k):
        raise AssertionError("the serial oracle ran for work on the card")

    monkeypatch.setattr(sweep, "_probe_serial", unreachable)
    _launch_oom_above(sweep, 2, monkeypatch)
    GLOBAL.reset()
    halved = sweep.probe_many(counts)
    np.testing.assert_array_equal(halved.placements, clean.placements)
    _launch_oom_above(sweep, 0, monkeypatch)
    GLOBAL.reset()
    with pytest.raises(DeviceOOM, match="single-item chunk"):
        sweep.probe_many(counts)
    assert "sweep-chunk-halving" in GLOBAL.notes
    assert not any("serial" in k for k in GLOBAL.notes)
