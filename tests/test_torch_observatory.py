"""The GPU port's device observatory on the CPU: histograms
(obs/histo.py, the JAX package's own against numpy and against the JAX
copy), the cost count (obs/costs.py) against the bound figures
chip_smoke.py computed before it moved there, the workspace count
against the tensors a launch allocates, the memory ledger under
SIMON_DEVICE_MEM_BUDGET (predicted splits in run_chunked with the same
results, the `lie:high` / `lie:low` seam), and the instrumented launch
(counters, cost records, the `jit.<site>` seam)."""

import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from chip_smoke import build_fuzz_scenario
from open_simulator_tpu.obs import histo as jhisto
from open_simulator_tpu_torch.obs import costs
from open_simulator_tpu_torch.obs import histo as histo_mod
from open_simulator_tpu_torch.obs import ledger as ledger_mod
from open_simulator_tpu_torch.obs import profile
from open_simulator_tpu_torch.obs.histo import HISTOS, Histogram, bucket_of
from open_simulator_tpu_torch.obs.ledger import LEDGER
from open_simulator_tpu_torch.ops import fused_scan
from open_simulator_tpu_torch.runtime import guard
from open_simulator_tpu_torch.runtime.errors import DeviceOOM
from open_simulator_tpu_torch.runtime.inject import INJECT
from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL
from tests.test_torch_pins_first import _case, _encode, _outage_rows


class _Delta:
    KEYS = ("guard_oom_predicted_total", "guard_oom_reactive_total",
            "ledger_predictions_total", "ledger_predict_fit_total",
            "ledger_predict_unfit_total", "ledger_predict_hit_total",
            "ledger_predict_miss_total")

    def __init__(self):
        self._before = {k: COUNTERS.get(k) for k in self.KEYS}

    def __getitem__(self, key):
        return COUNTERS.get(key) - self._before[key]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    INJECT.clear()


# ---------------------------------------------------------------- histograms


def test_bucket_boundaries_are_half_open():
    assert bucket_of(0.0) == 0
    assert bucket_of(histo_mod.LOW / 2) == 0
    assert bucket_of(histo_mod.HIGH) == histo_mod.N_BUCKETS - 1
    assert bucket_of(1e9) == histo_mod.N_BUCKETS - 1
    for i in range(1, histo_mod.N_BUCKETS - 1):
        lo = histo_mod._UPPER[i - 1]
        assert bucket_of(lo) == i and bucket_of(lo * 1.0001) == i


def test_histogram_percentiles_vs_numpy_and_the_jax_copy():
    rng = np.random.default_rng(7)
    samples = rng.lognormal(mean=-5.0, sigma=1.5, size=20_000)
    h, jh = Histogram(), jhisto.Histogram()
    for s in samples:
        h.record(float(s))
        jh.record(float(s))
    assert h.count == len(samples) and h.counts == jh.counts
    assert math.isclose(h.mean(), float(samples.mean()), rel_tol=1e-9)
    tol = histo_mod.RATIO - 1.0
    for q in (10, 50, 90, 95, 99):
        ref = float(np.percentile(samples, q))
        assert abs(h.percentile(q) - ref) <= ref * tol + 1e-12
        assert h.percentile(q) == jh.percentile(q)
    assert h.percentile(0) == float(samples.min())
    assert h.percentile(100) == float(samples.max())


def test_histogram_concurrent_recorders():
    h = Histogram()
    values = [0.001, 0.01, 0.1, 1.0]

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(2500):
            h.record(values[rng.integers(len(values))])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert h.count == sum(h.counts) == 8 * 2500
    assert h.min == min(values) and h.max == max(values)


def test_histogram_rejects_negative_and_nan():
    h = Histogram()
    h.record(-1.0)
    h.record(float("nan"))
    assert h.count == 0
    h.record(0.5)
    assert h.count == 1


def test_registry_summary_with_buckets():
    HISTOS.reset()
    try:
        for v in (0.002, 0.004, 0.008, 5.0):
            HISTOS.observe("obstest/phase", v)
        s = HISTOS.summary(with_buckets=True)["obstest/phase"]
        assert s["count"] == 4 and sum(s["buckets"]) == 4
        assert s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    finally:
        HISTOS.reset()


# ------------------------------------------------------------------- costs

# chip_smoke.py's bound() as it stood before the count moved to
# obs/costs.py, copied as the reference
_HBM, _CORE = 3.35e12, 67e12
_VISIT, _SCALAR, _PORT, _GPU = 50, 3, 2, 4
_VGVOL, _VG, _DEV = 6, 8, 4
_TROW, _GROW, _HARD, _SOFT = 14, 5, 12, 12


def _old_visit_ops(plan):
    d = fused_scan.block_dims(plan)
    visit = np.full(plan.u, _VISIT + _SCALAR * d["k"] + _PORT * d["w"], dtype=np.int64)
    if plan.has_gpu:
        visit += _GPU * d["g"] * (plan.gpu_cls[:, 0].cpu().numpy() > 0)
    if plan.has_store:
        lv = (plan.cls_lvm.cpu().numpy() > 0).sum(axis=1)
        wants = plan.cls_wants.cpu().numpy() > 0
        visit += wants * (_VGVOL * lv * d["v"] + _VG * d["v"] + _DEV * (d["ds"] + d["dh"]))
    if plan.has_terms:
        def slots(t):
            return (t.cpu().numpy() >= 0).sum(axis=1)

        visit += (_TROW * slots(plan.cls_rows) + _GROW * slots(plan.cls_grows)
                  + _HARD * slots(plan.cls_hrows) + _SOFT * slots(plan.cls_srows))
    return visit


def _old_bound(plan, class_of_pod, scenarios):
    n, p = plan.n, len(class_of_pod)
    d = fused_scan.block_dims(plan)
    plan_bytes = sum(t.numel() * t.element_size() for t in vars(plan).values()
                     if isinstance(t, torch.Tensor))
    state_bytes = n * (6 * 8 + d["k"] * 8 + d["g"] * 8 + d["w"] * 4
                       + d["v"] * 8 + d["ds"] + d["dh"])
    state_bytes += 8 * (4 * d["vt"] + d["va"] + d["a"] + d["vs"])
    per_scenario = p * (1 + 4) + n + p * 4 + state_bytes
    total_bytes = plan_bytes + p * 4 + len(scenarios) * per_scenario
    cls = np.asarray(class_of_pod)
    visit = _old_visit_ops(plan)
    ops = 0
    for active, _valid, pinned in scenarios:
        scanned = np.array(active, bool)
        if pinned is not None:
            scanned &= np.asarray(pinned) < 0
        ops += int(visit[cls[scanned]].sum()) * n
    t_bytes = total_bytes / _HBM
    t_ops = ops / _CORE
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _plans():
    """(name, plan, batch) for every flag set: base, B2 (GPU, ports,
    scalars), storage, terms, and storage with terms (the fuzz mix)."""
    out = []
    for kind, n, p in (("base", 24, 120), ("b2", 16, 80), ("storage", 20, 60),
                       ("terms", 32, 90)):
        nodes, pods = _case(kind, n, p, seed=3)
        c, b, d, f = _encode("open_simulator_tpu_torch", nodes, pods)
        out.append((kind, dataclasses.replace(fused_scan.build_plan(c, b, d, f),
                                              has_pins=True), b))
    nodes, pods = build_fuzz_scenario(48, 160, seed=7)
    c, b, d, f = _encode("open_simulator_tpu_torch", nodes, pods)
    out.append(("fuzz", fused_scan.build_plan(c, b, d, f), b))
    return out


PLANS = _plans()


@pytest.mark.parametrize("name,plan,batch", PLANS, ids=[p[0] for p in PLANS])
def test_cost_count_equals_the_old_chip_smoke_bound(name, plan, batch):
    flags = (plan.has_scal, plan.has_gpu, plan.has_ports, plan.has_store, plan.has_terms)
    assert any(flags) or name == "base"
    n, p = plan.n, len(batch.class_of_pod)
    one = [(np.ones(p, bool), np.ones(n, bool), None)]
    valids, actives, pins = _outage_rows(n, p, 5, seed=11)
    if not plan.has_pins:
        pins = np.full_like(pins, -1)
    rows = list(zip(actives, valids, pins))
    for scen in (one, rows):
        assert costs.bound(plan, batch.class_of_pod, scen) == \
            _old_bound(plan, batch.class_of_pod, scen)
    np.testing.assert_array_equal(costs.visit_ops(plan), _old_visit_ops(plan))
    rec = costs.fused_scan_record("t", "k", plan, batch.class_of_pod, rows, 4)
    ms, by = _old_bound(plan, batch.class_of_pod, rows)
    assert rec.as_dict()["bound_ms"] == ms and rec.as_dict()["bound_by"] == by


@pytest.mark.parametrize("name,plan,batch", PLANS, ids=[p[0] for p in PLANS])
@pytest.mark.parametrize("scenarios", [1, 3])
def test_workspace_counts_every_tensor_a_launch_allocates(name, plan, batch, scenarios):
    """The workspace count's requests are the tensors the launch's inputs
    and _launch_inputs allocate (on a CPU plan here), one for one; the
    estimate adds the caching allocator's rounding on top."""
    n, p = plan.n, len(batch.class_of_pod)
    scen = [(np.ones(p, bool), np.ones(n, bool), None)] * scenarios
    inputs = fused_scan._scenario_inputs(plan, batch.class_of_pod, scen)
    cluster = 4
    shape = dataclasses.replace(fused_scan.launch_shape(plan, 1), cluster=cluster, replica=False)
    _args, (placements, state, blocks, scratch) = fused_scan._launch_inputs(
        plan, *inputs, True, shape)
    seen, tensors = set(), []
    for t in [*inputs, placements, state, *blocks.values(), *scratch]:
        if t is None:
            continue
        base = t._base if t._base is not None else t
        if id(base) not in seen:
            seen.add(id(base))
            tensors.append(base)
    got = sorted(t.numel() * t.element_size() for t in tensors)
    want = sorted(b for b in costs._requests(plan, p, scenarios, cluster) if b)
    assert sorted(g for g in got if g) == want
    assert costs.workspace_bytes(plan, p, scenarios, cluster) >= sum(want)
    assert costs.workspace_bytes(plan, p, scenarios) >= \
        costs.workspace_bytes(plan, p, scenarios, cluster)


def test_alloc_rounding():
    assert costs.alloc_bytes(0) == 0
    assert costs.alloc_bytes(1) == 512 and costs.alloc_bytes(513) == 1024
    big = (1 << 20) + 1
    assert costs.alloc_bytes(big) == (1 << 20) + 512 + (1 << 20)


def test_declared_estimate_is_the_workspace_of_the_chunk():
    _name, plan, batch = PLANS[0]
    reg = costs.CostRegistry()
    assert reg.estimate_bytes("s", 3) is None
    est = reg.chunk_estimator("s", plan, len(batch.class_of_pod))
    assert est(2, 7) == costs.workspace_bytes(plan, len(batch.class_of_pod), 5)
    assert est(0, 1) < est(0, 8)


# ------------------------------------------------------------------- ledger


def _budget(monkeypatch, nbytes):
    monkeypatch.setenv("SIMON_DEVICE_MEM_BUDGET", str(nbytes))


def test_cpu_ledger_knows_no_budget_without_the_variable(monkeypatch):
    monkeypatch.delenv("SIMON_DEVICE_MEM_BUDGET", raising=False)
    assert LEDGER.predict_fit(10**15) is None
    assert ledger_mod.device_memory_stats("cpu") == (0, 0, None, "none")
    _budget(monkeypatch, 1000)
    assert LEDGER.predict_fit(900) is True
    assert LEDGER.predict_fit(1000) is False  # above the 92% headroom


def test_predicted_splits_give_the_same_results(monkeypatch):
    """Under a budget only chunks of two fit (300 B a row, 920 usable):
    run_chunked splits before launching and every launched chunk fits."""
    _budget(monkeypatch, 1000)
    calls = []

    def evaluate(lo, hi):
        calls.append(hi - lo)
        if hi - lo > 2:
            raise torch.cuda.OutOfMemoryError("would not fit")
        return [i * 10 for i in range(lo, hi)]

    delta = _Delta()
    GLOBAL.reset()
    out = guard.run_chunked(evaluate, 8, label="obstest",
                            estimate=lambda lo, hi: (hi - lo) * 300)
    assert out == [i * 10 for i in range(8)] and max(calls) <= 2
    assert delta["guard_oom_reactive_total"] == 0
    assert delta["guard_oom_predicted_total"] >= 1
    assert delta["ledger_predict_hit_total"] == len(calls)
    assert "obstest-chunk-predicted-split" in GLOBAL.notes
    calls.clear()
    assert guard.run_chunked(evaluate, 8, label="obstest") == out
    assert max(calls) == 8  # without the estimate the doomed launch happens


def test_single_item_predicted_unfit(monkeypatch):
    """A single item predicted not to fit takes the serial floor where the
    caller has one (work on the CPU), and is launched where it has none
    (the card's rule: card work never moves to the host)."""
    _budget(monkeypatch, 1000)
    launched = []

    def evaluate(lo, hi):
        launched.append((lo, hi))
        return list(range(lo, hi))

    out = guard.run_chunked(evaluate, 3, label="obstest", serial_fallback=lambda i: -i,
                            estimate=lambda lo, hi: (hi - lo) * 5000)
    assert out == [0, -1, -2] and launched == []
    out = guard.run_chunked(evaluate, 3, label="obstest",
                            estimate=lambda lo, hi: (hi - lo) * 5000)
    assert out == [0, 1, 2] and launched == [(0, 1), (1, 2), (2, 3)]


def test_predict_miss_is_counted(monkeypatch):
    _budget(monkeypatch, 10**9)
    delta = _Delta()

    def evaluate(lo, hi):
        if hi - lo > 2:
            raise torch.cuda.OutOfMemoryError("x")
        return list(range(lo, hi))

    assert guard.run_chunked(evaluate, 4, label="obstest",
                             estimate=lambda lo, hi: 1) == [0, 1, 2, 3]
    assert delta["ledger_predict_miss_total"] >= 1
    assert delta["guard_oom_reactive_total"] >= 1


@pytest.mark.parametrize("lie,fits", [("high", False), ("low", True)])
def test_predict_fit_lies(lie, fits, monkeypatch):
    monkeypatch.delenv("SIMON_DEVICE_MEM_BUDGET", raising=False)
    INJECT.configure(f"ledger.predict_fit=lie:{lie}")
    delta = _Delta()
    assert LEDGER.predict_fit(1) is fits
    assert delta["ledger_predictions_total"] == 1


def test_lie_high_splits_a_sweep_to_singles_with_the_same_rows():
    """`ledger.predict_fit=lie:high@1x*` on a CPU sweep's outage rows:
    every chunk splits before it is launched, each single row takes the
    serial floor, and the rows equal a clean run's; `lie:high` alone
    lies once: one split, then two launches."""
    from tests.test_torch_apply import _deploy, _node
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.parallel.sweep import CapacitySweep
    from open_simulator_tpu_torch.scheduler.core import AppResource

    nodes = [_node(f"n{i}") for i in range(4)]
    apps = [AppResource("web", ResourceTypes(deployments=[_deploy("web", 6)]))]
    sweep = CapacitySweep(ResourceTypes(nodes=nodes), apps, _node("t"), 2, device="cpu")
    n, p = sweep.n, len(sweep.pods)
    valids, actives, pins = _outage_rows(n, p, 4, seed=2)
    pins = np.where(pins >= 0, pins, -1)
    clean = sweep.probe_scenarios(valids, actives, pins)
    INJECT.configure("ledger.predict_fit=lie:high@1x*")
    delta = _Delta()
    GLOBAL.reset()
    lied = sweep.probe_scenarios(valids, actives, pins)
    for a, b in zip(clean, lied):
        np.testing.assert_array_equal(a, b)
    assert delta["guard_oom_predicted_total"] == 3 + 4
    assert "chaos-chunk-predicted-split" in GLOBAL.notes
    assert "chaos-serial-fallback" in GLOBAL.notes
    INJECT.configure("ledger.predict_fit=lie:high")
    before = COUNTERS.get("launches_chaos_sweep")
    delta = _Delta()
    once = sweep.probe_scenarios(valids, actives, pins)
    for a, b in zip(clean, once):
        np.testing.assert_array_equal(a, b)
    assert delta["guard_oom_predicted_total"] == 1
    assert COUNTERS.get("launches_chaos_sweep") - before == 2


# ------------------------------------------------------- instrumented launch


def test_instrumented_launch_counts_costs_and_fires_its_seam():
    _name, plan, batch = PLANS[0]
    n, p = plan.n, len(batch.class_of_pod)
    scen = [(np.ones(p, bool), np.ones(n, bool), None)] * 2
    before = profile.snapshot()
    site_before = COUNTERS.get("launches_obstest")
    hist = HISTOS.summary().get("launch/obstest", {}).get("count", 0)
    fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen, site="obstest")
    fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen, site="obstest")
    assert profile.delta(before)["launches_total"] == 2
    assert profile.delta(before)["device_launches_total"] == 0  # the CPU
    assert COUNTERS.get("launches_obstest") - site_before == 2
    assert HISTOS.summary()["launch/obstest"]["count"] - hist == 2
    recs = costs.COSTS.records_for("obstest")
    rec = recs[(fused_scan.BATCH_KERNEL_NAME, 2, p, n, None)]
    assert rec.launches >= 2 and rec.shape["cluster"] is None
    INJECT.configure("jit.obstest=oom@1")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        fused_scan.run_fused_scan(plan, batch.class_of_pod, *scen[0], site="obstest")
    assert guard.classify_device_error(torch.cuda.OutOfMemoryError("x")) is DeviceOOM


def test_torch_scan_dispatch_is_instrumented():
    from open_simulator_tpu_torch.ops import scan as scan_ops
    from open_simulator_tpu_torch.ops.encode import to_scan_state, to_scan_static

    nodes, pods = _case("base", 8, 20, seed=1)
    c, b, d, _f = _encode("open_simulator_tpu_torch", nodes, pods)
    before = COUNTERS.get("launches_obstest_scan")
    scan_ops.run_scan_masked(to_scan_static(c, b), to_scan_state(d, b), b.class_of_pod,
                             b.pinned_node, np.ones(c.n, bool), np.ones(len(pods), bool),
                             site="obstest_scan")
    assert COUNTERS.get("launches_obstest_scan") - before == 1


def test_observatory_block_shape_after_launches():
    from open_simulator_tpu_torch.obs.spans import observatory_block

    _name, plan, batch = PLANS[0]
    n, p = plan.n, len(batch.class_of_pod)
    fused_scan.run_fused_scan(plan, batch.class_of_pod, np.ones(p, bool), np.ones(n, bool),
                              site="obstest_block")
    block = observatory_block()
    assert {"costs", "histograms"} <= set(block)
    assert "obstest_block" in block["costs"] and "launch/obstest_block" in block["histograms"]
    # the store and re-simulation blocks (incremental/store.py) are
    # there exactly when their counters moved in this process
    from open_simulator_tpu_torch.incremental.store import aot_store_block, incremental_block

    assert block.get("incremental", {}) == incremental_block()
    assert block.get("aot_store", {}) == aot_store_block()


def test_ledger_span_watermarks_need_a_card():
    """On the CPU the ledger is not polled: no samples, no ledger block."""
    LEDGER.reset()
    assert LEDGER.poll(torch.device("cpu")) == 0
    assert LEDGER.summary()["samples"] == 0 and LEDGER.device_summary() == []
