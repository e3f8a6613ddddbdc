"""`simon top` of the GPU port (cli.py cmd_top) against the JAX package's:
a port of tests/test_telemetry.py's top-frame case, the same frames and
JSON from both CLIs against a daemon that answers fixed documents, and
against each package's running serve daemon with the timings masked.
`top` is a client: it does no device work."""

import contextlib
import importlib
import io
import json
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

JAX = "open_simulator_tpu"
PORT = "open_simulator_tpu_torch"
PKGS = (JAX, PORT)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


SNAPSHOT = {
    "daemon": "serve",
    "health": "degraded",
    "uptimeSeconds": 12.0,
    "recorder": {"spans": 5, "dropped": 2},
    "seriesStats": {"series": 3},
    "latest": {"counter/serve_requests_total": 9.0, "gauge/serve_queue_depth": 2.0},
    "slo": {
        "alerting": ["availability"],
        "states": [{"objective": {"name": "availability"}, "burnFast": 3.2,
                    "burnSlow": 1.5}],
    },
}
SERIES = {
    "series": {
        "counter/serve_requests_total": [[1.0, 0.0, 0.0, 0.0], [2.0, 5.0, 5.0, 5.0],
                                         [3.0, 9.0, 9.0, 9.0]],
        "gauge/serve_queue_depth": [[1.0, 2.0, 2.0, 2.0]],
    }
}


def test_top_frame_renders_slo_and_sparklines():
    """tests/test_telemetry.py's case on the port's renderer, which
    draws the JAX package's frame."""
    tm = _mod(PORT, "obs.telemetry")
    assert tm.sparkline([]) == ""
    assert tm.sparkline([1.0, 1.0]) == "▁▁"
    line = tm.sparkline(list(range(10)))
    assert line[0] == "▁" and line[-1] == "█"
    frame = tm.render_top_frame(SNAPSHOT, SERIES, "http://x:1")
    assert "BURNING" in frame and "availability" in frame
    assert "serve_requests_total Δ" in frame
    assert "dropped 2" in frame
    assert frame == _mod(JAX, "obs.telemetry").render_top_frame(SNAPSHOT, SERIES, "http://x:1")


def _run(pkg, argv):
    """(exit code, stdout, stderr) of `pkg`'s CLI in this process."""
    cli = _mod(pkg, "cli")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def fixed_daemon():
    """A daemon stand-in answering SNAPSHOT and SERIES; logs the paths."""
    paths = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            paths.append(self.path)
            doc = SNAPSHOT if self.path == "/v1/obs/snapshot" else SERIES
            body = json.dumps(doc).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", paths
    httpd.shutdown()
    httpd.server_close()


@pytest.mark.parametrize("flags", [["--once"], ["--format", "json"],
                                   ["--once", "--series", "gauge/serve_queue_depth"]])
def test_top_equals_the_jax_cli_on_fixed_documents(fixed_daemon, flags):
    url, paths = fixed_daemon
    got = {}
    for pkg in PKGS:
        paths.clear()
        rc, out, err = _run(pkg, ["top", "--url", url, *flags])
        got[pkg] = (rc, out, err, list(paths))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == 0 and got[PORT][1]


def test_top_input_errors_and_unreachable_daemon_equal_the_jax_cli():
    for argv, code in ((["top", "--interval", "0", "--once"], 2),
                       (["top", "--url", "http://127.0.0.1:9", "--once", "--timeout", "2"], 1)):
        port, jax = _run(PORT, argv), _run(JAX, argv)
        assert port == jax and port[0] == code


@pytest.mark.parametrize("router_pkg", PKGS)
def test_top_fleet_waits_for_the_fleet_router(router_pkg):
    """`top --fleet` reads a fleet router (each package's, in front of
    two stub replicas): both CLIs print the same frame and JSON with the
    timings masked, with a pane for each slot; without a router it
    cannot connect (exit 1, as the JAX CLI)."""
    from test_torch_fleet import StubReplica

    reps = [StubReplica("r0"), StubReplica("r1")]
    router = _mod(router_pkg, "fleet.router").FleetRouter(reps, port=0, probe_interval_s=0,
                                                          obs_cadence_s=0.2)
    router.start()
    url = f"http://{router.host}:{router.port}"
    try:
        for i in range(6):
            req = urllib.request.Request(url + "/v1/simulate", data=b"{}", headers={
                "Content-Type": "application/json", "X-Simon-Tenant": f"top-t{i}"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
        # one last sample, then the frame holds still for both CLIs
        router.telemetry.stop()
        for flags in (["--once"], ["--format", "json"]):
            port, jax = _run(PORT, ["top", "--fleet", "--url", url, *flags]), \
                _run(JAX, ["top", "--fleet", "--url", url, *flags])
            assert port[0] == jax[0] == 0
            assert _mask(port[1]) == _mask(jax[1])
            if "json" in flags:
                assert json.loads(port[1])["snapshot"]["daemon"] == "fleet"
            else:
                assert "slot" in port[1] and "\nr0 " in port[1] and "\nr1 " in port[1]
    finally:
        for r in reps:
            r.stop()
        router.httpd.shutdown()
        router.httpd.server_close()
    argv = ["top", "--fleet", "--once", "--url", "http://127.0.0.1:9", "--timeout", "2"]
    assert _run(PORT, argv) == _run(JAX, argv) and _run(PORT, argv)[0] == 1


def _mask(text: str) -> str:
    """Timings and sparklines out: numbers and block characters."""
    text = re.sub(r"[▁▂▃▄▅▆▇█]+", "~", text)
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text)


def _serve_daemon(pkg):
    decode = _mod(pkg, "models.decode")
    cluster = decode.ResourceTypes()
    cluster.nodes = [{"kind": "Node", "metadata": {"name": f"top-n-{i}"},
                      "status": {"allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}}}
                     for i in range(2)]
    kw = {"device": "cpu"} if pkg == PORT else {}
    session = _mod(pkg, "serve.session").Session(cluster, **kw)
    d = _mod(pkg, "serve.server").ServeDaemon(session, port=0, max_batch=2,
                                              obs_cadence_s=0.2)
    d.start()
    return d


@pytest.mark.parametrize("daemon_pkg", PKGS)
def test_top_against_each_package_daemon_equals_the_jax_cli(daemon_pkg):
    d = _serve_daemon(daemon_pkg)
    url = f"http://{d.host}:{d.port}"
    try:
        body = json.dumps({"apps": [{"name": "t", "yaml": json.dumps({
            "kind": "Pod", "metadata": {"name": "t", "namespace": "top"},
            "spec": {"containers": [{"name": "c", "image": "i", "resources": {
                "requests": {"cpu": "1", "memory": "1Gi"}}}]}})}]}).encode()
        req = urllib.request.Request(url + "/v1/simulate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
        time.sleep(0.6)  # a few telemetry samples after the request
        # the sampler stops after one last sample, which sees the
        # request: both CLIs then read one frame (under load the 0.6 s
        # may pass without a sample, and the second CLI would read a
        # line the first did not)
        d.telemetry.stop()
        series = ["--series", "counter/serve_requests_total",
                  "--series", "gauge/serve_queue_depth"]
        for flags in (["--once", *series], ["--format", "json", *series]):
            port, jax = _run(PORT, ["top", "--url", url, *flags]), \
                _run(JAX, ["top", "--url", url, *flags])
            assert port[0] == jax[0] == 0
            assert _mask(port[1]) == _mask(jax[1])
            if "json" in flags:
                doc = json.loads(port[1])
                assert doc["snapshot"]["daemon"] == "serve"
                assert doc["series"]["series"]["counter/serve_requests_total"]
            else:
                assert "serve_requests_total Δ" in port[1]
    finally:
        d.shutdown()
