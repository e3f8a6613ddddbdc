"""Production telemetry of the GPU port (`open_simulator_tpu_torch` ->
obs/telemetry.py, obs/slo.py) against the JAX package's, exactly.

The same samples, made with numpy from a seed, go through both
packages: the series rings (bounded, chronological, the seeded
downsampling, window deltas and fractions), `/v1/obs/series` query
shapes, SLO parsing and its refusals, the multi-window burn-rate states,
request IDs, the sparkline and the `simon top` frames. Then the port's
own registries: the sampler lands the port's counters, histograms and
ledger, the serve `/metrics` exposition conforms, and the debug dump
carries launches and nvcc builds and loads in the port's doctor.
"""

import importlib
import json
import time

import numpy as np
import pytest

from test_telemetry import check_exposition

PKGS = ("open_simulator_tpu", "open_simulator_tpu_torch")


def _tm(pkg):
    return importlib.import_module(f"{pkg}.obs.telemetry")


def _slo(pkg):
    return importlib.import_module(f"{pkg}.obs.slo")


@pytest.fixture(autouse=True)
def _pristine_recorders():
    yield
    for pkg in PKGS:
        rec = importlib.import_module(f"{pkg}.obs.spans").RECORDER
        rec.disable()
        rec.ring = False
        rec.max_spans = rec.MAX_SPANS
        rec.reset()
        _tm(pkg).SERIES.reset()


def _samples(seed, n=300):
    rng = np.random.RandomState(seed)
    t = 1000.0 + np.cumsum(rng.uniform(0.5, 1.5, n))
    counter = np.cumsum(rng.randint(0, 5, n)).astype(float)
    gauge = rng.uniform(0.0, 1.0, n)
    return [(float(a), float(b), float(c)) for a, b, c in zip(t, counter, gauge)]


def _stores(seed, cap=32):
    stores = []
    for pkg in PKGS:
        s = _tm(pkg).SeriesStore(capacity=cap, seed=seed)
        for t, c, g in _samples(seed):
            s.record("counter/x", t, c)
            s.record("gauge/g", t, g)
        stores.append(s)
    return stores


@pytest.mark.parametrize("seed", [0, 7, 1113])
def test_series_rings_equal_the_jax_package(seed):
    jax_s, port_s = _stores(seed)
    now = _samples(seed)[-1][0]
    for name in ("counter/x", "gauge/g"):
        for res in (1, 8, 64):
            assert port_s.query(name, resolution=res) == jax_s.query(name, resolution=res)
        for w in (5.0, 30.0, 500.0, 10_000.0):
            assert port_s.delta(name, w, now=now) == jax_s.delta(name, w, now=now)
            assert port_s.window(name, w, now=now) == jax_s.window(name, w, now=now)
            for below in (True, False):
                assert (port_s.frac_beyond(name, 0.5, w, now=now, below=below)
                        == jax_s.frac_beyond(name, 0.5, w, now=now, below=below))
    assert port_s.stats() == jax_s.stats()
    assert port_s.names() == jax_s.names()


def test_series_bounds_and_refusals_equal_the_jax_package():
    outs = []
    for pkg in PKGS:
        tm = _tm(pkg)
        s = tm.SeriesStore(capacity=4)
        for i in range(tm.MAX_SERIES + 5):
            s.record(f"gauge/g{i}", 1000.0, 1.0)
        s.record("counter/r", 1000.0, 50.0)
        s.record("counter/r", 1001.0, 3.0)  # a reset clamps to zero
        outs.append((s.stats(), s.delta("counter/r", 10.0, now=1001.0), tm.MAX_SERIES, tm.AGG))
        validation = importlib.import_module(f"{pkg}.models.validation")
        with pytest.raises(validation.InputError):
            s.query("counter/r", resolution=7)
        with pytest.raises(validation.InputError):
            tm.TelemetryRuntime(cadence_s=0.0)
    assert outs[0] == outs[1]


def test_series_endpoint_equals_the_jax_package():
    paths = ["/v1/obs/series", "/v1/obs/series?name=counter/endpoint_test&sinceSeconds=60",
             "/v1/obs/series?name=counter/endpoint_test&resolution=8",
             "/v1/obs/series?resolution=13&name=x", "/v1/obs/series?sinceSeconds=abc&name=x"]
    now = time.time()
    outs = []
    for pkg in PKGS:
        tm = _tm(pkg)
        for i in range(40):
            tm.SERIES.record("counter/endpoint_test", now - 40 + i, float(i))
        got = [tm.series_endpoint(p) for p in paths]
        for _status, doc in got:
            doc.pop("now", None)  # the wall clock of the call
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[1][1][0] == 200 and outs[1][1][1]["series"]["counter/endpoint_test"]
    assert outs[1][3][0] == 400


def test_request_ids_equal_the_jax_package():
    for raw in (None, "", "ok-id_1:2.3", 'we"ird\nid', "x" * 500):
        got = [_tm(pkg).sanitize_request_id(raw) for pkg in PKGS]
        assert got[0] == got[1]
    tm = _tm("open_simulator_tpu_torch")
    a, b = tm.new_request_id(), tm.new_request_id()
    assert a != b and a.startswith("req-")
    with tm.request_scope("rid-1"):
        assert tm.current_request_id() == "rid-1"
    assert tm.current_request_id() is None
    assert tm.parse_trace_context("parent=12;hop=3") == _tm(PKGS[0]).parse_trace_context(
        "parent=12;hop=3")


def _avail(**kw):
    rec = {"name": "availability", "kind": "availability", "target": 0.9,
           "total": "req_total", "bad": "bad_total",
           "fastWindowSeconds": 10, "slowWindowSeconds": 30}
    rec.update(kw)
    return rec


BAD_SLOS = [
    [],
    [{"name": "x", "kind": "nope"}],
    [_avail(name='we"ird')],
    [_avail(target=1.0)],
    [_avail(slowWindowSeconds=5)],
    [_avail(), _avail()],
    [{"name": "l", "kind": "latency", "site": "serve/request"}],
]


@pytest.mark.parametrize("objs", BAD_SLOS)
def test_slo_parse_refuses_what_the_jax_parser_refuses(objs):
    msgs = []
    for pkg in PKGS:
        validation = importlib.import_module(f"{pkg}.models.validation")
        with pytest.raises(validation.InputError) as exc:
            _slo(pkg).parse_objectives(objs)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


OBJECTIVES = [
    _avail(),
    {"name": "builds", "kind": "counter_budget", "counter": "builds_total",
     "maxPerWindow": 0, "fastWindowSeconds": 10, "slowWindowSeconds": 30},
    {"name": "agreement", "kind": "gauge_min", "gauge": "agreement_rate", "min": 0.99,
     "budget": 0.2, "fastWindowSeconds": 10, "slowWindowSeconds": 30},
    {"name": "p95", "kind": "latency", "site": "serve/request", "percentile": 95,
     "thresholdMs": 100.0, "budget": 0.2, "fastWindowSeconds": 10, "slowWindowSeconds": 30},
    {"name": "fleet", "kind": "fleet_availability", "target": 0.99,
     "fastWindowSeconds": 10, "slowWindowSeconds": 30},
]


@pytest.fixture
def own_slo_counters(monkeypatch):
    """Each package's SLO engine counts its alerts in a Counters of the
    test's own: the exposition lines carry `slo_alerts_*_total`, and the
    process-wide registries hold whatever earlier tests in the same
    process fired (pytest-xdist's loadfile runs several files in one)."""
    for pkg in PKGS:
        counters = importlib.import_module(f"{pkg}.utils.trace").Counters()
        monkeypatch.setattr(_slo(pkg), "COUNTERS", counters)


@pytest.mark.parametrize("seed", [3, 11])
def test_slo_burn_states_equal_the_jax_package(seed, own_slo_counters):
    """Seeded traffic with a fault storm and a recovery: at each
    evaluation both engines report the same states, and the serialized
    engine and its exposition lines are equal."""
    rng = np.random.RandomState(seed)
    bad_rate = np.r_[np.zeros(40), rng.uniform(0.3, 0.7, 20), np.zeros(20)]
    traffic = rng.randint(1, 20, 80)
    runs = []
    for pkg in PKGS:
        tm, slo = _tm(pkg), _slo(pkg)
        s = tm.SeriesStore(capacity=128)
        now = [1000.0]
        eng = slo.SLOEngine(slo.parse_objectives(OBJECTIVES), series=s, clock=lambda: now[0])
        req = bad = builds = 0.0
        states = []
        for i in range(80):
            t = 1000.0 + i
            req += traffic[i]
            bad += round(traffic[i] * bad_rate[i])
            builds += 1.0 if 40 <= i < 60 else 0.0
            for name, v in (("counter/req_total", req), ("counter/bad_total", bad),
                            ("counter/builds_total", builds),
                            ("counter/fleet_requests_total", req),
                            ("counter/fleet_shed_total", bad),
                            ("gauge/agreement_rate", 1.0 - bad_rate[i]),
                            ("histo/serve/request/p95_ms", 50.0 + 900.0 * bad_rate[i])):
                s.record(name, t, float(v))
            if i % 10 == 9:
                now[0] = t
                states.append([(st.alerting, st.burn_fast, st.burn_slow, st.fired_total,
                                st.cleared_total) for st in eng.evaluate()])
        runs.append((states, eng.as_dict(), eng.prometheus_lines(), eng.reasons()))
    assert runs[0] == runs[1]
    assert any(any(a for a, *_ in row) for row in runs[1][0])


def test_sparkline_and_top_frames_equal_the_jax_package():
    snapshot = {"daemon": "serve", "health": "degraded", "uptimeSeconds": 12.0,
                "recorder": {"spans": 5, "dropped": 2}, "seriesStats": {"series": 3},
                "slo": {"alerting": ["availability"],
                        "states": [{"objective": {"name": "availability"},
                                    "burnFast": 3.2, "burnSlow": 1.5}]}}
    series_doc = {"series": {
        "counter/serve_requests_total": [[1.0, 0.0, 0.0, 0.0], [2.0, 5.0, 5.0, 5.0],
                                         [3.0, 9.0, 9.0, 9.0]],
        "gauge/serve_queue_depth": [[1.0, 2.0, 2.0, 2.0]]}}
    frames = []
    for pkg in PKGS:
        tm = _tm(pkg)
        frames.append((tm.sparkline([]), tm.sparkline([1.0, 1.0]),
                       tm.sparkline(list(range(10))),
                       tm.render_top_frame(snapshot, series_doc, "http://x:1")))
    assert frames[0] == frames[1]
    assert "BURNING" in frames[1][3] and "dropped 2" in frames[1][3]


def test_sampler_reads_the_port_registries():
    from open_simulator_tpu_torch.obs import telemetry as tm
    from open_simulator_tpu_torch.obs.histo import HISTOS
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    s = tm.SeriesStore(capacity=16)
    COUNTERS.inc("telemetry_test_total", 3)
    COUNTERS.gauge("telemetry_test_gauge", 1.5)
    HISTOS.observe("telemetry/test", 0.01)
    rt = tm.TelemetryRuntime(cadence_s=1.0, series=s, clock=lambda: 2000.0)
    rt.sample_once()
    assert s.last("counter/telemetry_test_total")[1] == 3.0
    assert s.last("gauge/telemetry_test_gauge")[1] == 1.5
    assert s.last("histo/telemetry/test/p95_ms")[1] > 0
    assert s.last("ledger/peak_bytes") is not None
    assert s.last("recorder/spans_dropped") is not None


def _port_session():
    from open_simulator_tpu.testing import make_fake_node
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.serve.session import Session

    cluster = ResourceTypes()
    cluster.nodes = [make_fake_node(f"tel-n-{i}", "8", "32Gi") for i in range(2)]
    return Session(cluster, device="cpu")


def _request(name, replicas=2):
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.scheduler.core import AppResource
    from open_simulator_tpu_torch.serve.session import WhatIfRequest

    res = ResourceTypes()
    res.deployments = [{"kind": "Deployment", "metadata": {"name": name, "namespace": "tel"},
                        "spec": {"replicas": replicas, "template": {"spec": {"containers": [
                            {"name": "c", "image": "x", "resources": {
                                "requests": {"cpu": "100m", "memory": "128Mi"}}}]}}}}]
    return WhatIfRequest(apps=[AppResource(name, res)])


def test_serve_metrics_exposition_conforms():
    from open_simulator_tpu_torch.obs.slo import SLOEngine, parse_objectives
    from open_simulator_tpu_torch.serve.coalescer import Coalescer
    from open_simulator_tpu_torch.serve.server import render_metrics
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    session = _port_session()
    coal = Coalescer(session, max_batch=4, queue_depth=8)
    session.evaluate_batch([_request("expo-a"), _request("expo-b", 3)])
    COUNTERS.inc('retry_attempts_ep:we"ird\\label\nname')
    COUNTERS.inc("serve_tenant_requests:tenant-a")
    engine = SLOEngine(parse_objectives([_avail(total="serve_requests_total",
                                                bad="serve_shed_total")]))
    engine.evaluate()
    text = render_metrics(coal, engine).decode()
    assert check_exposition(text) > 50
    assert 'simon_slo_alert{slo="availability"}' in text
    assert "simon_spans_dropped_total" in text and "simon_latency_seconds_bucket" in text
    assert 'simon_launches_site_total{site="scenario_scan"}' in text
    assert "jax" not in text


def test_debug_dump_counts_launches_and_loads_in_the_doctor(tmp_path, monkeypatch):
    from open_simulator_tpu_torch.obs import spans
    from open_simulator_tpu_torch.obs import telemetry as tm
    from open_simulator_tpu_torch.obs.doctor import diff_records, load_bench_record

    spans.RECORDER.ring = True
    spans.RECORDER.enable()
    _port_session().evaluate_batch([_request("dump-a")])
    rt = tm.TelemetryRuntime(cadence_s=1.0)
    rt.sample_once()
    monkeypatch.chdir(tmp_path)
    status, doc = tm.handle_debug_dump(json.dumps({"path": "dump.json"}).encode(),
                                       runtime=rt, label="serve")
    assert status == 200 and doc["written"]
    loaded = load_bench_record(str(tmp_path / "dump.json"))
    assert loaded["metric"] == "serve-debug-dump"
    assert loaded["obs"]["launches"] >= 1 and "nvcc_builds" in loaded["obs"]
    assert not any(k.startswith("jax") for k in loaded["obs"])
    assert diff_records(loaded, loaded).ok
    status, inline = tm.handle_debug_dump(b"", runtime=rt, label="serve")
    assert status == 200 and inline["spans"]["events"] and inline["series"]
    assert tm.handle_debug_dump(b"not json", runtime=rt)[0] == 400
    status, err = tm.handle_debug_dump(json.dumps({"path": "../x.json"}).encode(), runtime=rt)
    assert status == 400 and "escapes" in err["error"]
