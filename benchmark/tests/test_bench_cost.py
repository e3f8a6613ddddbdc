"""The frozen count of a scan against the program's observatory today
(obs/costs.py), at three shapes: the base block, the term block with two
spread constraints, and with anti-affinity terms."""

import pytest

from benchmark.cost import fused_scan as frozen
from benchmark.tests import tiny
from benchmark.tests.test_bench_reference import _anti_instance


def _program_count(inst, tmp_path):
    import numpy as np

    from open_simulator_tpu_torch.apply.applier import Applier, SimonConfig
    from open_simulator_tpu_torch.obs import costs
    from open_simulator_tpu_torch.parallel.sweep import CapacitySweep

    inst.max_new = 0  # no padding: the scan's nodes are the scenario's
    path = inst.write(str(tmp_path / inst.tag))
    app = Applier(SimonConfig.from_file(path), device="cpu")
    sweep = CapacitySweep(app.load_cluster(), app.load_apps(), app.load_new_node(), 0,
                          device="cpu")
    active, valid, pinned = sweep._scenario(0)
    scen = [(np.asarray(active), np.asarray(valid), pinned)]
    return (costs.launch_ops(sweep.plan, sweep.batch.class_of_pod, scen),
            costs.bound(sweep.plan, sweep.batch.class_of_pod, scen))


SHAPES = {
    "basic": lambda: tiny.instance("k8s-5k-basic", "capacity-plan", 40, [1200]),
    "spread": lambda: tiny.instance("k8s-5k-spread", "spread-rollout", 300, [300, 200]),
    "anti": _anti_instance,
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_frozen_count_equals_the_program_today(shape, tmp_path):
    inst = SHAPES[shape]()
    ops, (bound_ms, bound_by) = _program_count(inst, tmp_path)
    assert frozen.scan_ops(inst, 0) == ops
    if shape == "anti":
        return  # 12 nodes: the program's plan bytes bound it, a count of its own
    ms, by = frozen.bound(inst, 0)
    assert by == bound_by == "operations"
    assert ms == pytest.approx(bound_ms, rel=1e-12)


def test_the_spread_cell_is_bound_by_operations():
    inst = tiny.instance("k8s-5k-spread", "spread-rollout", 5000, [5000, 2000])
    ms, by = frozen.bound(inst, 0)
    assert by == "operations"
    assert frozen.scan_bytes(inst, 0) / frozen.HBM_BYTES_PER_S * 1e3 < ms / 2
