"""The eager torch scan of the GPU port (open_simulator_tpu_torch/ops/
scan.py) on the CPU against the JAX package's XLA scan, exactly: the
placements, every final state row, the Go-RNG words each pod consumed
and the final 607-word history are integers, so the tolerance is
equality.

- run_scan_masked of both packages on `to_scan_static` / `to_scan_state`
  of the same encodings: each custom-plugin normalisation (none,
  default, reverse, min-max), select_host="sample" on tie-heavy
  identical nodes, with pins and with pods that cannot be placed (which
  consume no word), node and pod masks, and GPU-share, storage, terms,
  hostPorts and scalars together with a custom plugin;
- the reservoir walk alone on a crafted history whose draws reject
  (Rand.Int31n's modulo-bias loop), as tests/test_sample_scan.py pins it;
- `simulate(engine="cuda", device="cpu")` against the JAX package's
  `simulate(engine="tpu")` under sample and a custom plugin, including
  a priority batch whose escapes rewind the stream, the serial rerun on
  a sample overflow, and the rule that a custom rng with only `.intn`
  stays serial.

Inputs are small clusters made from numpy seeds. The card's run of the
same scan is held against this CPU run in tests/test_torch_cuda.py."""

import copy
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import build_fuzz_scenario, build_scenario
from open_simulator_tpu.ops import scan as jscan
from open_simulator_tpu.utils.gorand import GoRand as JaxGoRand
from open_simulator_tpu_torch.ops import scan as tscan
from open_simulator_tpu_torch.utils.gorand import GoRand as PortGoRand

JAX_PKG = "open_simulator_tpu"
PORT_PKG = "open_simulator_tpu_torch"
MODES = ("none", "default", "reverse", "minmax")


def _plugin(pkg, mode, weight=3):
    """A stateless custom score plugin: the score depends on the node's
    name and on the pod's labels, so classes differ."""
    base = importlib.import_module(f"{pkg}.scheduler.plugins").SchedulerPlugin

    class NameScore(base):
        name = f"name-score-{mode}"
        normalize = mode

        def score(self, pod, node):
            digits = "".join(c for c in node["metadata"]["name"] if c.isdigit())
            key = len(str((pod.get("metadata") or {}).get("labels") or {}))
            return (int(digits or 0) * 7 + key) % 11

    plug = NameScore()
    plug.weight = weight
    return plug


@pytest.fixture
def register():
    """register(mode, weight) adds the same plugin to both packages'
    default registries; they are emptied after the test."""
    regs = [importlib.import_module(f"{pkg}.scheduler.plugins").default_registry
            for pkg in (JAX_PKG, PORT_PKG)]
    for reg in regs:
        reg.clear()

    def add(mode, weight=3):
        for pkg, reg in zip((JAX_PKG, PORT_PKG), regs):
            reg.register(_plugin(pkg, mode, weight))

    yield add
    for reg in regs:
        reg.clear()


def _node(i, cpu="4", mem="8Gi"):
    return {"kind": "Node",
            "metadata": {"name": f"n{i:03d}", "labels": {"kubernetes.io/hostname": f"n{i:03d}"}},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}}}


def _pod(name, cpu="100m", mem="64Mi", node_name=None):
    pod = {"metadata": {"name": name, "namespace": "s", "labels": {}},
           "spec": {"containers": [{"name": "c", "image": "i", "resources": {
               "requests": {"cpu": cpu, "memory": mem}}}]}}
    if node_name:
        pod["spec"]["nodeName"] = node_name
    return pod


def _gpu(nodes, pods, seed):
    """GPU-share devices on a quarter of the nodes and single- and
    two-GPU asks on a tenth of the pods."""
    rng = np.random.RandomState(seed)
    gi = 1 << 30
    for node in nodes[::4]:
        cap = node["status"].setdefault("capacity", dict(node["status"]["allocatable"]))
        cap["alibabacloud.com/gpu-count"] = "4"
        cap["alibabacloud.com/gpu-mem"] = str(4 * 16 * gi)
    for pod in pods:
        if rng.rand() < 0.1 and not pod["spec"].get("nodeName"):
            meta = pod["metadata"] = dict(pod["metadata"])
            meta["annotations"] = dict(meta.get("annotations") or {})
            meta["annotations"]["alibabacloud.com/gpu-mem"] = str(int(rng.choice([4, 8])) * gi)
            meta["annotations"]["alibabacloud.com/gpu-count"] = str(int(rng.choice([1, 2])))


def _scan(pkg, nodes, pods, sample=False, valid=None, active=None, hist=None):
    """run_scan_masked of `pkg` on a fresh cluster: (placements,
    consumed words or None, final state as numpy arrays)."""
    oracle = importlib.import_module(f"{pkg}.scheduler.oracle").Oracle(copy.deepcopy(nodes))
    enc = importlib.import_module(f"{pkg}.ops.encode")
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    features = enc.features_of_batch(cluster, batch, sample=sample)
    static, init = enc.to_scan_static(cluster, batch), enc.to_scan_state(dyn, batch)
    valid = np.ones(cluster.n, bool) if valid is None else valid
    active = np.ones(batch.p, bool) if active is None else active
    if sample:
        words = np.array(hist if hist is not None else JaxGoRand(11).history(), dtype=np.uint64)
        init = init._replace(rng_hist=jnp.asarray(words) if pkg == JAX_PKG
                             else torch.as_tensor(words.view(np.int64)))
    if pkg == JAX_PKG:
        out, final = jscan.run_scan_masked(
            static, init, jnp.asarray(batch.class_of_pod), jnp.asarray(batch.pinned_node),
            jnp.asarray(valid), jnp.asarray(active), features=features)
    else:
        out, final = tscan.run_scan_masked(static, init, batch.class_of_pod,
                                           batch.pinned_node, valid, active,
                                           features=features)
    consumed = None
    if sample:
        out, consumed = out
        consumed = np.asarray(consumed).astype(np.int64)
    rows = {}
    for field, value in final._asdict().items():
        if value is None:
            continue
        arr = np.asarray(value)
        rows[field] = arr.view(np.int64) if arr.dtype == np.uint64 else arr.astype(np.int64)
    return np.asarray(out).astype(np.int64), consumed, rows, features


def _assert_same(nodes, pods, **kw):
    jp, jc, jrows, jf = _scan(JAX_PKG, nodes, pods, **kw)
    tp, tc, trows, tf = _scan(PORT_PKG, nodes, pods, **kw)
    assert tuple(jf) == tuple(tf)
    np.testing.assert_array_equal(tp, jp)
    if jc is not None:
        np.testing.assert_array_equal(tc, jc)
    assert sorted(trows) == sorted(jrows)
    for field in jrows:
        np.testing.assert_array_equal(trows[field], jrows[field], err_msg=field)
    return tp, tc, tf


@pytest.mark.parametrize("mode", MODES)
def test_custom_modes_equal_the_xla_scan(register, mode):
    register(mode)
    nodes, pods = build_scenario(24, 120, seed=3)
    place, _c, features = _assert_same(nodes, pods)
    assert features.custom and (place >= 0).any() and (place == -1).sum() < len(place)


@pytest.mark.parametrize("mode", ["minmax", "reverse"])
def test_sample_with_a_custom_plugin_equals_the_xla_scan(register, mode):
    register(mode, weight=1)
    nodes, pods = build_scenario(30, 150, seed=4)
    place, consumed, features = _assert_same(nodes, pods, sample=True)
    assert features.sample and features.custom and consumed.sum() > 0


def test_sample_tie_heavy_identical_nodes():
    # all nodes and pods identical: the first pod sees 40 tied nodes
    # (39 Intn draws), and every pod draws for the nodes tied with its
    # pick
    nodes = [_node(i) for i in range(40)]
    pods = [_pod(f"p{i:03d}") for i in range(120)]
    place, consumed, _f = _assert_same(nodes, pods, sample=True)
    assert len(set(place.tolist())) > 10
    assert consumed[0] == 39 and (consumed > 0).all()


def test_sample_pins_and_unschedulable_pods_consume_no_words():
    nodes = [_node(i, cpu="1") for i in range(8)]
    pods = []
    for i in range(40):
        pin = f"n{i % 8:03d}" if i % 7 == 3 else None
        pods.append(_pod(f"p{i:03d}", cpu="300m", node_name=pin))
    place, consumed, features = _assert_same(nodes, pods, sample=True)
    assert features.pins
    pinned = np.array([i % 7 == 3 for i in range(40)])
    assert (consumed[pinned] == 0).all()
    assert (place == -1).any() and (consumed[place == -1] == 0).all()


@pytest.mark.parametrize("sample", [False, True])
def test_node_and_pod_masks(register, sample):
    register("default")
    nodes, pods = build_scenario(20, 100, seed=5)
    rng = np.random.RandomState(6)
    valid = rng.rand(20) < 0.7
    active = rng.rand(100) < 0.8
    place, consumed, _f = _assert_same(nodes, pods, sample=sample, valid=valid,
                                       active=active)
    assert (place[~active] == tscan.INACTIVE).all()
    assert np.isin(place[active & (place >= 0)], np.flatnonzero(valid)).all()
    if sample:
        assert (consumed[~active] == 0).all()


@pytest.mark.parametrize("sample", [False, True])
def test_every_block_with_a_custom_plugin(register, sample):
    """GPU-share, open-local storage, inter-pod terms (affinity groups,
    hard and soft spread), hostPorts, a scalar resource and pins in one
    batch with a custom plugin."""
    register("minmax")
    nodes, pods = build_fuzz_scenario(48, 160, seed=7)
    _gpu(nodes, pods, seed=8)
    place, _c, f = _assert_same(nodes, pods, sample=sample)
    assert (f.gpu and f.storage and f.ipa and f.hard_spread and f.soft_spread and f.ports
            and f.scalars and f.pins and f.custom)
    assert (place >= 0).sum() > 100


def test_sample_walk_with_rejected_draws():
    """The second draw, Intn(3), reads a word above the modulo-bias
    threshold and rejects: it consumes two words, as the host GoRand's
    walk does. Compared with the JAX walk on the same crafted history,
    with the host walk as the third witness."""
    hist = [0] * 607
    hist[0] = 7 << 32  # Intn(2): a power of two, no rejection
    hist[1] = ((1 << 31) - 1) << 32  # Intn(3) -> 2^31-1 > maxv: rejected
    hist[2] = 5 << 32  # the retry: 5 % 3 = 2, no hit
    scores = np.array([5, 5, 5], dtype=np.int64)
    feas = np.ones(3, bool)

    host = PortGoRand(1)
    host.set_history(hist)
    best_host, cnt = 0, 1
    for i in (1, 2):
        cnt += 1
        if host.intn(cnt) == 0:
            best_host = i

    words = np.array(hist, dtype=np.uint64)
    jbest, jhist, jovf, jused = jscan._sample_select(
        jnp.asarray(scores), jnp.asarray(feas), jnp.asarray(True), jnp.asarray(words), 3)
    tbest, thist, tovf, tused = tscan._sample_select(
        torch.as_tensor(scores), torch.as_tensor(feas), torch.as_tensor(words.view(np.int64)), 3)
    assert int(tused) == int(jused) == 3
    assert int(tbest) == int(jbest) == best_host
    assert bool(tovf) == bool(jovf) is False
    assert thist.numpy().view(np.uint64).tolist() == np.asarray(jhist).tolist() \
        == host.history()


def test_sample_scan_with_rejections_equals_the_xla_scan():
    """A whole scan whose draws reject: with the upper part of the
    history zero, the first 273 generated words are the history's first
    273, and every fourth of them is the largest int31, which rejects
    for any Intn(n) with n not a power of two."""
    hist = [0] * 607
    for j in range(273):
        hist[j] = ((1 << 31) - 1 if j % 4 == 1 else (j * 40503) % (1 << 31)) << 32
    nodes = [_node(i) for i in range(12)]
    pods = [_pod(f"p{i:03d}") for i in range(30)]
    _place, consumed, _f = _assert_same(nodes, pods, sample=True, hist=hist)
    # the first pod ties all 12 nodes: 11 draws, and the rejected ones
    # take one more word each
    assert consumed[0] > 11


# ---- simulate() against the JAX package's -----------------------------

def _resources(pkg, **fields):
    res = importlib.import_module(f"{pkg}.models.decode").ResourceTypes()
    for k, v in fields.items():
        setattr(res, k, copy.deepcopy(v))
    return res


def _simulate(pkg, cluster_fields, apps_fields, **kw):
    core = importlib.import_module(f"{pkg}.scheduler.core")
    importlib.import_module(f"{pkg}.models.workloads").reset_name_counter()
    cluster = _resources(pkg, **cluster_fields)
    apps = [core.AppResource(name, _resources(pkg, **f)) for name, f in apps_fields]
    if pkg == PORT_PKG:
        kw.setdefault("engine", "cuda")
        kw.setdefault("device", "cpu")
        kw["rng"] = PortGoRand(kw.pop("seed", 1))
    else:
        kw.setdefault("engine", "tpu")
        kw["rng"] = JaxGoRand(kw.pop("seed", 1))
    rng = kw["rng"]
    res = core.simulate(cluster, apps, **kw)
    return (
        [(ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods])
         for ns in res.node_status],
        [(u.pod["metadata"]["name"], u.reason) for u in res.unscheduled_pods],
        rng.history(),
    )


def _same_simulate(cluster_fields, apps_fields, **kw):
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    ref = _simulate(JAX_PKG, cluster_fields, apps_fields, **dict(kw))
    GLOBAL.reset()
    port = _simulate(PORT_PKG, cluster_fields, apps_fields, **dict(kw))
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    return port, dict(GLOBAL.notes)


@pytest.mark.parametrize("custom,sample", [(True, False), (False, True), (True, True)])
def test_simulate_equals_the_jax_package(register, custom, sample):
    if custom:
        register("minmax")
    nodes, pods = build_scenario(30, 160, seed=9)
    kw = {"select_host": "sample", "seed": 5} if sample else {}
    (placed, failed, _hist), notes = _same_simulate(
        {"nodes": nodes}, [("a", {"pods": pods[:80]}), ("b", {"pods": pods[80:]})], **kw)
    want = " and ".join(w for w, on in (("custom score plugins", custom),
                                        ('select_host="sample"', sample)) if on)
    assert notes["batch-kernel"] == f"torch-scan ({want})"
    assert sum(len(p) for _n, p in placed) + len(failed) == 160


def test_simulate_sample_priority_escapes_rewind_the_stream(register):
    """Priority pods that preempt escape the scan to the serial cycle;
    the scan consumed Go-RNG words for the discarded tail, so the engine
    rewinds the stream to the escape point (tests/test_sample_scan.py's
    scenario, with a custom plugin on top)."""
    register("default", weight=1)
    nodes = [_node(i, cpu="1", mem="4Gi") for i in range(16)]
    victims = [_pod(f"victim-{i}", cpu="800m", mem="1Gi", node_name=f"n{i:03d}")
               for i in range(16)]
    pre = []
    for i in range(2):
        p = _pod(f"pre-{i}", cpu="800m", mem="1Gi")
        p["spec"]["priority"] = 100
        pre.append(p)
    ties = [_pod(f"tie-{i:03d}", cpu="50m", mem="8Mi") for i in range(100)]
    (placed, _failed, _hist), notes = _same_simulate(
        {"nodes": nodes, "pods": victims}, [("a", {"pods": pre + ties})],
        select_host="sample", seed=3)
    assert notes["engine"] == "priority-scan"
    assert notes.get("priority-scan-escapes", 0) >= 1
    assert notes["batch-kernel"].startswith("torch-scan")


def _force_overflow(monkeypatch):
    """Every torch scan reports a sample rejection overflow."""
    real = tscan.run_scan_masked

    def overflowing(*args, **kw):
        out, final = real(*args, **kw)
        return out, final._replace(rng_overflow=torch.ones((), dtype=torch.bool))

    monkeypatch.setattr(tscan, "run_scan_masked", overflowing)


def test_sample_overflow_reruns_the_batch_serially(monkeypatch):
    nodes = [_node(i) for i in range(20)]
    pods = [_pod(f"p{i:03d}") for i in range(90)]
    _force_overflow(monkeypatch)
    ref = _simulate(PORT_PKG, {"nodes": nodes}, [("a", {"pods": pods})], engine="oracle",
                    select_host="sample", seed=2)
    (placed, failed, hist), notes = _same_simulate(
        {"nodes": nodes}, [("a", {"pods": pods})], select_host="sample", seed=2)
    assert notes["engine"] == "serial-oracle (sample rng overflow)"
    assert (placed, failed, hist) == ref


def test_sample_overflow_in_a_priority_batch_finishes_serially(monkeypatch):
    nodes = [_node(i) for i in range(12)]
    pods = [_pod(f"p{i:03d}") for i in range(80)]
    for p in pods[:10]:
        p["spec"]["priority"] = 10
    _force_overflow(monkeypatch)
    ref = _simulate(PORT_PKG, {"nodes": nodes}, [("a", {"pods": pods})], engine="oracle",
                    select_host="sample", seed=4)
    (placed, failed, hist), notes = _same_simulate(
        {"nodes": nodes}, [("a", {"pods": pods})], select_host="sample", seed=4)
    assert notes["priority-scan-sample-overflow"] == 80
    assert (placed, failed, hist) == ref


def test_custom_rng_with_only_intn_stays_serial():
    """A custom rng that offers only `.intn(n)` cannot be carried in
    the scan (no history), so the batch runs on the serial oracle."""
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.scheduler.core import AppResource, simulate
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    class Counting:
        def __init__(self):
            self.calls = 0

        def intn(self, n):
            self.calls += 1
            return self.calls % n

    def run(engine):
        cluster = ResourceTypes()
        cluster.nodes = [_node(i) for i in range(10)]
        app = ResourceTypes()
        app.pods = [_pod(f"p{i:03d}") for i in range(70)]
        rng = Counting()
        res = simulate(cluster, [AppResource("a", app)], engine=engine, device="cpu",
                       select_host="sample", rng=rng)
        return ({p["metadata"]["name"]: ns.node["metadata"]["name"]
                 for ns in res.node_status for p in ns.pods}, rng.calls)

    GLOBAL.reset()
    got = run("cuda")
    assert GLOBAL.notes["engine"] == "serial-oracle"
    assert got == run("oracle") and got[1] > 0
