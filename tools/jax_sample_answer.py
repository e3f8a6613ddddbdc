"""The JAX package's answer to chip_smoke.py phase 13: the default
scenario's 10,000 nodes with its pods cut to chip_smoke.A2_PODS, the
custom min-max score plugin chip_smoke.a2_plugin registered, scheduled
by the JAX package's `simulate(engine="tpu", select_host="sample")` on
a GoRand(chip_smoke.A2_SEED) stream, on the JAX CPU backend (its XLA
scan carries custom plugins and sample).

    JAX_PLATFORMS=cpu python tools/jax_sample_answer.py

Prints the digest of the result (chip_smoke.a2_digest: every node's
pods in order, the unscheduled pods with their reasons and the RNG's
final 607-word history), the wall time and the largest resident set;
the digest is the constant JAX_SAMPLE_ANSWER of chip_smoke.py.
"""

import resource
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import chip_smoke
    from open_simulator_tpu.models.decode import ResourceTypes
    from open_simulator_tpu.models.workloads import reset_name_counter
    from open_simulator_tpu.scheduler.core import AppResource, simulate
    from open_simulator_tpu.scheduler.plugins import SchedulerPlugin, default_registry
    from open_simulator_tpu.utils.gorand import GoRand
    from open_simulator_tpu.utils.trace import GLOBAL

    nodes, pods = chip_smoke.a2_inputs()
    cluster = ResourceTypes()
    cluster.nodes = nodes
    app = ResourceTypes()
    app.pods = pods
    plugin = chip_smoke.a2_plugin(SchedulerPlugin)
    default_registry.register(plugin)
    reset_name_counter()
    GLOBAL.reset()
    rng = GoRand(chip_smoke.A2_SEED)
    t0 = time.perf_counter()
    try:
        result = simulate(cluster, [AppResource(chip_smoke.A2_APP, app)], engine="tpu",
                          select_host="sample", rng=rng)
    finally:
        default_registry.unregister(plugin.name)
    seconds = time.perf_counter() - t0
    view = chip_smoke.a2_view(result, rng)
    placed = sum(len(pods) for _name, pods in view["nodes"])
    print(f"digest {chip_smoke.a2_digest(view)}")
    print(f"{placed} pods placed, {len(view['unscheduled'])} unscheduled, batch-kernel "
          f"{GLOBAL.notes.get('batch-kernel')!r}, {seconds:.1f} s (CPU wall time)")
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
