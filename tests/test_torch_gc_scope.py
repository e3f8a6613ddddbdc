"""The scope of a `simon apply` request's cyclic garbage collection
(`utils/gcscope.py` `collection_scope`): the command holds the collector
off from its start until its answer is released, then clears the
identity memos and collects the young generations once, the request's
one `apply/gc`; a plan inside it does neither of its own, a plan
outside any scope closes with one clear and one young collection. On
the CPU, over one capacity plan and one spread rollout of the
benchmark's cells at their test sizes (benchmark/tests/tiny.py), through
`cli.main`."""

import contextlib
import gc
import io
import weakref

import pytest

from benchmark.tests import tiny
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.apply import applier as applier_mod
from open_simulator_tpu_torch.utils import gcscope
from open_simulator_tpu_torch.utils.gcscope import YOUNG, collection_scope
from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL

CELLS = {
    "plan": ("k8s-5k-basic", "capacity-plan"),
    "rollout": ("k8s-5k-spread", "spread-rollout"),
}
COLLECTIONS = f"gc_request_collections_total:{YOUNG}"
UNREACHABLE = "gc_request_unreachable_total"


@pytest.fixture(scope="module")
def requests(tmp_path_factory):
    """Each cell's request written out, and answered once (the imports
    and first-call work of the process fall outside the checks)."""
    where = tmp_path_factory.mktemp("gcscope")
    out = {}
    for kind, (conf, mix) in CELLS.items():
        inst = tiny.instance(conf, mix, tiny.TINY_NODES[conf], tiny.TINY_REPLICAS[mix])
        out[kind] = inst.write(str(where / kind))
        _apply(out[kind])
    return out


def _apply(path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["apply", "-f", path, "--device", "cpu"])
    assert rc == 0, out.getvalue()[-2000:]


class Collections:
    """The cyclic collections that start while `inside` is set, as
    (generation, what each found unreachable), by a `gc.callbacks` hook."""

    def __init__(self):
        self.inside = False
        self.seen = []
        self.current = None

    def __call__(self, what, info):
        if what == "start":
            self.current = info["generation"] if self.inside else None
        elif self.current is not None:
            self.seen.append((self.current, info["collected"] + info["uncollectable"]))
            self.current = None

    @property
    def generations(self):
        return [g for g, _ in self.seen]


@pytest.fixture
def collections(monkeypatch):
    """Collections inside the `simon apply` command: from after
    `cli/args` (the command's function is called) to its return."""
    rec = Collections()
    command = cli.cmd_apply

    def watched(args):
        rec.inside = True
        try:
            return command(args)
        finally:
            rec.inside = False

    monkeypatch.setattr(cli, "cmd_apply", watched)
    gc.callbacks.append(rec)
    try:
        yield rec
    finally:
        gc.callbacks.remove(rec)


@pytest.fixture
def clears(monkeypatch):
    """How many times the scopes have cleared the identity memos."""
    seen = []
    real = gcscope.clear_all_memos

    def clear():
        seen.append(1)
        real()

    monkeypatch.setattr(gcscope, "clear_all_memos", clear)
    return seen


@contextlib.contextmanager
def collector(enabled: bool):
    """The collector set as asked, after a full collection: no automatic
    one falls due in the few allocations before a scope opens."""
    was = gc.isenabled()
    gc.collect()
    (gc.enable if enabled else gc.disable)()
    try:
        yield
    finally:
        (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_command_runs_no_full_collection(requests, collections, clears, kind):
    with collector(True):
        _apply(requests[kind])
    assert 2 not in collections.generations, collections.seen
    # its one collection: the young generations, after the release
    assert [g for g in collections.generations if g >= 1] == [YOUNG], collections.seen
    # one `apply/gc` a request, the last phase: one clear, then the collection
    assert len(clears) == 1
    assert GLOBAL.phases["apply/gc"].count == 1 and GLOBAL.order[-1] == "apply/gc"


@pytest.mark.parametrize("enabled", [True, False], ids=["enabled", "disabled"])
def test_the_collector_is_left_as_it_was_found(requests, collections, enabled):
    with collector(enabled):
        _apply(requests["rollout"])
        assert gc.isenabled() is enabled
    if not enabled:
        # a caller that paused the collector keeps it paused: nothing runs
        assert collections.seen == []


def test_tracked_objects_do_not_grow_across_commands(requests):
    with collector(True):
        _apply(requests["rollout"])
        gc.collect()
        before = len(gc.get_objects())
        for _ in range(5):
            _apply(requests["rollout"])
        gc.collect()
        grown = len(gc.get_objects()) - before
    assert grown < 500, grown


def test_a_cycle_on_the_answer_is_reclaimed_by_the_command(requests, collections, monkeypatch):
    class Link:
        pass

    dead = []
    run = applier_mod.Applier.run

    def run_with_a_cycle(self, *a, **kw):
        result = run(self, *a, **kw)
        link = Link()
        link.loop = link
        result.cycle = link
        # the generation of the collection that reclaims the cycle
        dead.append(weakref.ref(link, lambda _: dead.append(collections.current)))
        return result

    monkeypatch.setattr(applier_mod.Applier, "run", run_with_a_cycle)
    with collector(True):
        _apply(requests["plan"])
        assert dead[0]() is None
    assert dead[1:] == [YOUNG]


def _inputs(path):
    """A plan's cluster, apps and new node, as `simon apply` loads them."""
    config = applier_mod.SimonConfig.from_file(path)
    app = applier_mod.Applier(config, device="cpu")
    return app.load_cluster(), app.load_apps(), app.load_new_node()


def test_a_plan_inside_a_scope_collects_nothing_of_its_own(requests, collections, clears):
    cluster, apps, new_node = _inputs(requests["plan"])
    with collector(True):
        with collection_scope():
            collections.inside = True
            result = applier_mod.probe_plan(cluster, apps, new_node, device="cpu")
            collections.inside = False
            assert not gc.isenabled()
            # nor clears the memos: the outer scope does, once
            assert clears == []
        assert collections.seen == [] and result.success
        assert gc.isenabled() and len(clears) == 1


def test_a_plan_outside_any_scope_closes_with_one_young_collection(requests, collections,
                                                                  clears):
    cluster, apps, new_node = _inputs(requests["plan"])
    with collector(True):
        collections.inside = True
        result = applier_mod.probe_plan(cluster, apps, new_node, device="cpu")
        collections.inside = False
        assert gc.isenabled()
    assert 2 not in collections.generations and YOUNG in collections.generations
    assert result.success and len(clears) == 1


def test_the_counters_count_the_commands_collection(requests, collections):
    runs0, found0 = COUNTERS.get(COLLECTIONS), COUNTERS.get(UNREACHABLE)
    with collector(True):
        _apply(requests["rollout"])
    assert COUNTERS.get(COLLECTIONS) - runs0 == 1
    found = [n for g, n in collections.seen if g == YOUNG]
    assert COUNTERS.get(UNREACHABLE) - found0 == found[0]


def test_nested_scopes_collect_once_and_an_error_passes_through():
    rec = Collections()
    gc.callbacks.append(rec)
    runs0 = COUNTERS.get(COLLECTIONS)
    try:
        with collector(True):
            rec.inside = True
            with pytest.raises(KeyError):
                with collection_scope():
                    with collection_scope():
                        assert not gc.isenabled()
                    assert rec.seen == [] and not gc.isenabled()
                    raise KeyError("inside")
            rec.inside = False
            assert gc.isenabled()
    finally:
        gc.callbacks.remove(rec)
    assert rec.generations == [YOUNG]
    assert COUNTERS.get(COLLECTIONS) - runs0 == 1
