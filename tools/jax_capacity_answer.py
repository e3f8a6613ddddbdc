"""The JAX package's answer to the capacity scenario that chip_smoke.py
phase 6 plans on the GPU port: 10,000 nodes x 100,000 pods
(bench.py build_capacity_scenario), planned by
open_simulator_tpu.apply.applier.probe_plan on the JAX CPU backend.

    JAX_PLATFORMS=cpu python tools/jax_capacity_answer.py

Prints the new-node count, the wall time and the phase trace. Takes a
few minutes on a CPU (about 0.5 GiB resident); its answer is the
constant JAX_CAPACITY_ANSWER of chip_smoke.py.
"""

import resource
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import bench
    from open_simulator_tpu.apply.applier import probe_plan
    from open_simulator_tpu.models.workloads import reset_name_counter
    from open_simulator_tpu.utils.trace import GLOBAL

    cluster, apps, new_node = bench.build_capacity_scenario()
    reset_name_counter()
    t0 = time.perf_counter()
    res = probe_plan(cluster, apps, new_node)
    seconds = time.perf_counter() - t0
    print(f"nodes {bench.CAP_NODES} pods {bench.CAP_PODS}: success {res.success}, "
          f"newNodeCount {res.new_node_count}, {seconds:.1f} s")
    print(GLOBAL.as_json())
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0 if res.success else 1


if __name__ == "__main__":
    sys.exit(main())
