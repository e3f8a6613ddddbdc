"""The JAX package's answer to chip_smoke.py phase 18: the capacity
scenario cut to chip_smoke.A1G_NODES nodes x chip_smoke.A1G_PODS pods
(chip_smoke.write_capacity_config), with the custom min-max score
plugin chip_smoke.a1g_plugin registered, planned by the JAX package's
`apply -f cfg --format json` on its CPU backend (the XLA scan carries
custom plugins).

    JAX_PLATFORMS=cpu python tools/jax_custom_plan_answer.py

Prints the sha256 of the command's stdout (chip_smoke.JAX_A1G_ANSWER),
its exit code and new-node count, the wall time and the largest
resident set.
"""

import contextlib
import hashlib
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
    from open_simulator_tpu.scheduler.plugins import SchedulerPlugin, default_registry

    plugin = chip_smoke.a1g_plugin(SchedulerPlugin)
    default_registry.register(plugin)
    try:
        with tempfile.TemporaryDirectory() as root:
            cfg = chip_smoke.write_capacity_config(root, chip_smoke.A1G_NODES,
                                                   chip_smoke.A1G_PODS)
            reset_name_counter()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["apply", "-f", cfg, "--format", "json"])
            secs = time.perf_counter() - t0
    finally:
        default_registry.unregister(plugin.name)
    text = out.getvalue()
    print(f"JAX_A1G_ANSWER {hashlib.sha256(text.encode()).hexdigest()} (exit {rc}, "
          f"+{json.loads(text)['newNodeCount']}, {secs:.1f} s CPU wall time)")
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
