"""The JAX package's answer to the full-width plan that chip_smoke.py
phase 11 runs through the GPU port's CLI: the simon config of
chip_smoke.write_plan_config (10,000 zone-labelled open-local nodes, the
repo's `hello` chart, 100 anti-affinity / topology-spread StatefulSets
of 50 replicas, an LVM StatefulSet and a Deployment that fits only new
nodes), planned by the JAX package's CLI (`apply --format json`) on the
JAX CPU backend (the XLA scan).

    JAX_PLATFORMS=cpu python tools/jax_plan_answer.py

Prints the new-node count, the wall time and the largest resident set;
its answer is the constant JAX_PLAN_ANSWER of chip_smoke.py.
"""

import contextlib
import io
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import chip_smoke
    from open_simulator_tpu import cli
    from open_simulator_tpu.models.workloads import reset_name_counter

    with tempfile.TemporaryDirectory() as root:
        cfg = chip_smoke.write_plan_config(root)
        reset_name_counter()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["apply", "-f", cfg, "--format", "json"])
        seconds = time.perf_counter() - t0
    doc = json.loads(out.getvalue())
    placed = sum(len(n["pods"]) for n in doc["nodes"])
    print(f"rc {rc}: success {doc['success']}, newNodeCount {doc['newNodeCount']}, "
          f"{placed} pods placed, {len(doc['unscheduledPods'])} unscheduled, {seconds:.1f} s")
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0 if rc == 0 and doc["success"] else 1


if __name__ == "__main__":
    sys.exit(main())
