"""The GPU port's live-cluster import (`open_simulator_tpu_torch` ->
models/kubeclient.py) against the JAX package's, exactly.

One in-file stub apiserver on 127.0.0.1 serves the seven LIST
endpoints; for every scenario of tests/test_kubeclient.py (the pod
filters, the PDB v1 fallback, the token file and data certificates,
pagination, the exec and auth-provider credential plugins, both 410
paths, the kubeconfig errors) the two packages' clients import the same
ResourceTypes and send the same requests. `apply --device cpu` on a
kubeConfig cluster prints the JAX CLI's bytes, and `chaos` plans it as
the JAX CLI does."""

import dataclasses
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlsplit

import pytest
import yaml

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models import kubeclient as jkc
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu.runtime.retry import reset_io_state as jax_reset_io
from open_simulator_tpu.testing import make_fake_node
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models import kubeclient as pkc
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.runtime.retry import reset_io_state as port_reset_io
from tests.test_torch_apply import _deploy, _run

BOTH = (jkc, pkc)


def _pod(name, phase="Running", owner_kind=None, deleting=False, node=None, cpu=None):
    pod = {
        "metadata": {"name": name, "namespace": "d"},
        "spec": {"containers": [{"name": "c", "image": "img"}]},
        "status": {"phase": phase},
    }
    if cpu:
        pod["spec"]["containers"][0]["resources"] = {"requests": {"cpu": cpu,
                                                                   "memory": "1Gi"}}
    if node:
        pod["spec"]["nodeName"] = node
    if owner_kind:
        pod["metadata"]["ownerReferences"] = [{"kind": owner_kind, "name": "o"}]
    if deleting:
        pod["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    return pod


class _StubApiServer:
    """Serves the seven LIST endpoints with limit/continue paging; records
    each request's auth header and query."""

    def __init__(self, pdb_version="v1beta1", expire_continue=False,
                 expire_continue_once=False, nodes=None, pods=None):
        self.seen_auth = []
        self.seen_queries = []
        self.expire_continue = expire_continue
        self.expire_continue_once = expire_continue_once
        self._expired = set()
        outer = self
        nodes = nodes or [make_fake_node("live-0", cpu="8", memory="16Gi")]
        pods = pods or [
            _pod("static-ok"),
            _pod("pending", phase="Pending"),
            _pod("ds-owned", owner_kind="DaemonSet"),
            _pod("rs-owned", owner_kind="ReplicaSet"),
            _pod("terminating", deleting=True),
        ]
        self.routes = {
            "/api/v1/nodes": ("NodeList", "v1", nodes),
            "/api/v1/pods": ("PodList", "v1", pods),
            f"/apis/policy/{pdb_version}/poddisruptionbudgets": (
                "PodDisruptionBudgetList", f"policy/{pdb_version}",
                [{"metadata": {"name": "pdb-1", "namespace": "d"}, "spec": {}}]),
            "/api/v1/services": ("ServiceList", "v1",
                                 [{"metadata": {"name": "svc", "namespace": "d"},
                                   "spec": {"selector": {"app": "x"}}}]),
            "/apis/storage.k8s.io/v1/storageclasses": (
                "StorageClassList", "storage.k8s.io/v1",
                [{"metadata": {"name": "standard"}, "provisioner": "x"}]),
            "/api/v1/persistentvolumeclaims": (
                "PersistentVolumeClaimList", "v1",
                [{"metadata": {"name": "claim", "namespace": "d"},
                  "spec": {"storageClassName": "standard"}}]),
            "/apis/apps/v1/daemonsets": ("DaemonSetList", "apps/v1", []),
        }

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                outer.seen_auth.append(self.headers.get("Authorization"))
                split = urlsplit(self.path)
                query = parse_qs(split.query)
                outer.seen_queries.append((split.path, query))
                route = outer.routes.get(split.path)
                if route is None:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b"{}")
                    return
                kind, api_version, items = route
                limit = int(query.get("limit", ["0"])[0] or 0)
                expire = outer.expire_continue or (
                    outer.expire_continue_once and split.path not in outer._expired)
                if expire and "continue" in query:
                    outer._expired.add(split.path)
                    self.send_response(410)
                    self.end_headers()
                    self.wfile.write(b"{}")
                    return
                start = int(query.get("continue", ["0"])[0] or 0)
                meta = {"resourceVersion": "42"}
                page = items
                if limit:
                    page = items[start:start + limit]
                    if start + limit < len(items):
                        meta["continue"] = str(start + limit)
                body = json.dumps({"kind": kind, "apiVersion": api_version,
                                   "metadata": meta, "items": page}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_port}"

    def reset_log(self):
        self.seen_auth.clear()
        self.seen_queries.clear()
        self._expired.clear()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture
def stub():
    servers = []

    def make(**kw):
        srv = _StubApiServer(**kw)
        servers.append(srv)
        return srv

    yield make
    for srv in servers:
        srv.stop()


def _kubeconfig(tmp_path, server, user=None, name="kubeconfig", cluster_extra=None):
    cfg = {
        "apiVersion": "v1", "kind": "Config", "current-context": "ctx",
        "contexts": [{"name": "ctx", "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {"server": server, **(cluster_extra or {})}}],
        "users": [{"name": "u", "user": user or {"token": "sekret"}}],
    }
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def _import_both(srv, kc):
    """Each package's import of the stub's cluster, with the requests
    each one sent."""
    out = []
    for mod in BOTH:
        srv.reset_log()
        res = mod.create_cluster_resource_from_client(kc)
        out.append((_fields(res), list(srv.seen_auth), list(srv.seen_queries)))
    return out


def _assert_same_import(srv, kc):
    (jres, jauth, jq), (pres, pauth, pq) = _import_both(srv, kc)
    assert pres == jres
    assert (pauth, pq) == (jauth, jq)
    return pres, pauth, pq


def test_import_filters_pods_and_sets_kinds(tmp_path, stub):
    srv = stub()
    res, auth, _ = _assert_same_import(srv, _kubeconfig(tmp_path, srv.url))
    assert sorted(p["metadata"]["name"] for p in res["pods"]) == ["rs-owned", "static-ok"]
    assert [s["metadata"]["name"] for s in res["services"]] == ["svc"]
    assert [c["metadata"]["name"] for c in res["persistent_volume_claims"]] == ["claim"]
    assert set(auth) == {"Bearer sekret"}


def test_import_pdb_v1_fallback(tmp_path, stub):
    srv = stub(pdb_version="v1")
    res, _, _ = _assert_same_import(srv, _kubeconfig(tmp_path, srv.url))
    assert [p["metadata"]["name"] for p in res["pod_disruption_budgets"]] == ["pdb-1"]


@pytest.mark.parametrize("doc,match", [
    ({"contexts": []}, "current-context"),
    ({"current-context": "nope", "contexts": []}, "not found"),
])
def test_kubeconfig_errors(tmp_path, doc, match):
    path = tmp_path / "kc"
    path.write_text(yaml.safe_dump(doc))
    msgs = []
    for mod in BOTH:
        with pytest.raises(mod.KubeConfigError, match=match) as err:
            mod.KubeClient(str(path))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_kubeconfig_token_file_and_data_certs(tmp_path):
    tok = tmp_path / "token"
    tok.write_text("from-file\n")
    kc = _kubeconfig(tmp_path, "https://example:6443", user={"tokenFile": str(tok)},
                     cluster_extra={"insecure-skip-tls-verify": True})
    for mod in BOTH:
        client = mod.KubeClient(kc)
        assert client.token == "from-file"
        assert client._ssl_ctx is not None
        client.close()


def test_list_pagination_follows_continue(tmp_path, stub, monkeypatch):
    for mod in BOTH:
        monkeypatch.setattr(mod, "LIST_PAGE_LIMIT", 2)
    srv = stub(nodes=[make_fake_node(f"pg-{i}", cpu="1", memory="1Gi") for i in range(5)])
    res, _, queries = _assert_same_import(srv, _kubeconfig(tmp_path, srv.url))
    assert [n["metadata"]["name"] for n in res["nodes"]] == [f"pg-{i}" for i in range(5)]
    node_queries = [q for p, q in queries if p == "/api/v1/nodes"]
    assert [q.get("continue") for q in node_queries] == [None, ["2"], ["4"]]


def _exec_user(tmp_path, body):
    script = tmp_path / "cred-plugin.py"
    script.write_text(body)
    return {"exec": {"apiVersion": "client.authentication.k8s.io/v1beta1",
                     "command": sys.executable, "args": [str(script)],
                     "env": [{"name": "PLUGIN_MARK", "value": "on"}]}}


def test_exec_credential_plugin_token(tmp_path, stub):
    body = (
        "import json, os\n"
        "info = json.loads(os.environ['KUBERNETES_EXEC_INFO'])\n"
        "tok = 'exec-' + os.environ['PLUGIN_MARK'] + '-' + info['kind']\n"
        "print(json.dumps({'apiVersion': 'client.authentication.k8s.io/v1beta1',"
        " 'kind': 'ExecCredential', 'status': {'token': tok}}))\n"
    )
    srv = stub()
    _, auth, _ = _assert_same_import(
        srv, _kubeconfig(tmp_path, srv.url, user=_exec_user(tmp_path, body)))
    assert set(auth) == {"Bearer exec-on-ExecCredential"}


def test_exec_credential_plugin_failure_raises(tmp_path):
    kc = _kubeconfig(tmp_path, "http://127.0.0.1:1",
                     user=_exec_user(tmp_path, "import sys\nsys.exit(3)\n"))
    msgs = []
    for mod in BOTH:
        with pytest.raises(mod.KubeConfigError, match="exec credential plugin") as err:
            mod.KubeClient(kc)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_auth_provider_access_token_and_cmd(tmp_path):
    cached = {"auth-provider": {"name": "gcp", "config": {"access-token": "cached-tok"}}}
    script = tmp_path / "gcloud.py"
    script.write_text("import json\n"
                      "print(json.dumps({'credential': {'access_token': 'fresh-tok'}}))\n")
    fresh = {"auth-provider": {"name": "gcp", "config": {
        "cmd-path": sys.executable, "cmd-args": str(script),
        "token-key": "{.credential.access_token}"}}}
    for user, name, want in ((cached, "kc1", "cached-tok"), (fresh, "kc2", "fresh-tok")):
        kc = _kubeconfig(tmp_path, "http://x", user=user, name=name)
        assert [mod.KubeClient(kc).token for mod in BOTH] == [want, want]


def test_list_410_relists_chunked_anchored_at_resource_version(tmp_path, stub, monkeypatch):
    for mod in BOTH:
        monkeypatch.setattr(mod, "LIST_PAGE_LIMIT", 2)
    srv = stub(expire_continue_once=True,
               nodes=[make_fake_node(f"rv-{i}", cpu="1", memory="1Gi") for i in range(5)])
    res, _, queries = _assert_same_import(srv, _kubeconfig(tmp_path, srv.url))
    assert [n["metadata"]["name"] for n in res["nodes"]] == [f"rv-{i}" for i in range(5)]
    node_queries = [q for p, q in queries if p == "/api/v1/nodes"]
    assert all(q.get("limit") == ["2"] for q in node_queries)
    anchored = [q for q in node_queries if "resourceVersion" in q]
    assert anchored and anchored[0]["resourceVersion"] == ["42"]


def test_list_410_expired_continue_falls_back_to_full_list(tmp_path, stub, monkeypatch):
    for mod in BOTH:
        monkeypatch.setattr(mod, "LIST_PAGE_LIMIT", 2)
    srv = stub(expire_continue=True,
               nodes=[make_fake_node(f"ch-{i}", cpu="1", memory="1Gi") for i in range(5)])
    res, _, _ = _assert_same_import(srv, _kubeconfig(tmp_path, srv.url))
    assert [n["metadata"]["name"] for n in res["nodes"]] == [f"ch-{i}" for i in range(5)]


def test_unreachable_apiserver_fails_typed(tmp_path, monkeypatch):
    """A refused connection exhausts the retries and fails typed, as
    ExternalIOError naming the endpoint, in both packages."""
    from open_simulator_tpu.runtime import ExternalIOError as JErr
    from open_simulator_tpu_torch.runtime import ExternalIOError as PErr

    monkeypatch.setenv("SIMON_IO_ATTEMPTS", "1")
    kc = _kubeconfig(tmp_path, "http://127.0.0.1:1")
    for mod, err, reset in ((jkc, JErr, jax_reset_io), (pkc, PErr, port_reset_io)):
        reset()
        with pytest.raises(err) as raised:
            mod.create_cluster_resource_from_client(kc)
        assert "/api/v1/nodes" in str(raised.value)
        reset()


def _live_config(tmp_path, srv):
    """A simon Config over the stub's cluster: an app that needs new
    nodes, and a newNode spec."""
    kc = _kubeconfig(tmp_path, srv.url)
    app = tmp_path / "app"
    app.mkdir()
    (app / "web.yaml").write_text(yaml.safe_dump(_deploy("web", 12, cpu="2")))
    nn = tmp_path / "newnode"
    nn.mkdir()
    (nn / "node.yaml").write_text(yaml.safe_dump(make_fake_node("template", cpu="8",
                                                                memory="16Gi")))
    cfg = tmp_path / "simon.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "live"},
        "spec": {"cluster": {"kubeConfig": kc},
                 "appList": [{"name": "web", "path": str(app)}], "newNode": str(nn)}}))
    return str(cfg)


def _live_stub(stub):
    nodes = [make_fake_node(f"live-{i}", cpu="8", memory="16Gi") for i in range(3)]
    pods = [_pod(f"bound-{i}", node=f"live-{i % 3}", cpu="1") for i in range(6)]
    pods += [_pod("pending", phase="Pending"), _pod("ds", owner_kind="DaemonSet", node="live-0"),
             _pod("gone", deleting=True, node="live-1")]
    return stub(nodes=nodes, pods=pods)


@pytest.mark.parametrize("fmt", ["json", "table"])
def test_apply_on_a_kubeconfig_cluster_prints_the_jax_bytes(tmp_path, stub, fmt):
    srv = _live_stub(stub)
    argv = ["apply", "-f", _live_config(tmp_path, srv), "--format", fmt]
    jrc, jout, _ = _run(jax_cli.main, jax_reset, argv)
    prc, pout, perr = _run(port_cli.main, port_reset, argv + ["--device", "cpu"])
    assert (prc, pout) == (jrc, jout), perr
    assert prc == 0
    if fmt == "json":
        doc = json.loads(pout)
        assert doc["success"] and doc["newNodeCount"] > 0
        bound = {p["name"] for n in doc["nodes"] for p in n["pods"]}
        assert {f"bound-{i}" for i in range(6)} <= bound
        assert not bound & {"pending", "ds", "gone"}


def test_chaos_on_a_kubeconfig_cluster_prints_the_jax_bytes(tmp_path, stub):
    srv = _live_stub(stub)
    argv = ["chaos", "-f", _live_config(tmp_path, srv), "--format", "json"]
    jrc, jout, _ = _run(jax_cli.main, jax_reset, argv)
    prc, pout, perr = _run(port_cli.main, port_reset, argv + ["--device", "cpu"])
    assert (prc, pout) == (jrc, jout), perr
    assert json.loads(pout)["total"] > 0
