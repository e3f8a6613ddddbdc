"""The JAX package's answer to chip_smoke.py phase 27's cut: the twin's
cluster cut to chip_smoke.TWIN_JAX_NODES nodes and
chip_smoke.TWIN_JAX_BOUND bound pods, a feed of
chip_smoke.TWIN_JAX_DECISIONS decisions recorded on the serial oracle and tailed by the JAX package's
`ClusterMirror` and `TwinDaemon` in this process on its CPU backend (the
XLA scan), then the what-if, drain, N+K and forecast queries over HTTP and
the state digest (chip_smoke.twin_cut_digest):

    JAX_PLATFORMS=cpu python tools/jax_twin_answer.py

Prints the sha256 of the feed, the answers and the state digest
(chip_smoke.JAX_TWIN_ANSWER) with the wall time, a CPU figure. With
`--port` it runs the GPU port's classes instead, on the CPU
(`device="cpu"`, the kernels' plain versions): the same digest.
"""

import resource
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import chip_smoke

    if "--port" in sys.argv[1:]:
        pkg, engine, mirror_kw = "open_simulator_tpu_torch", "cuda", {"device": "cpu"}
    else:
        pkg, engine, mirror_kw = "open_simulator_tpu", "tpu", {}
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    digest, secs, _answers = chip_smoke.twin_cut_digest(
        mod("twin.mirror").ClusterMirror, mod("twin.mirror").FeedSource,
        mod("twin.server").TwinDaemon, mod("models.decode").ResourceTypes,
        mod("scheduler.core").AppResource, mod("shadow.record").record_simulation,
        mod("models.workloads").reset_name_counter, engine, engine, **mirror_kw)
    print(f"JAX_TWIN_ANSWER {digest} ({pkg}, {chip_smoke.TWIN_JAX_NODES} nodes x "
          f"{chip_smoke.TWIN_JAX_BOUND} bound pods, {chip_smoke.TWIN_JAX_DECISIONS} decisions, "
          f"four queries, {secs:.1f} s CPU wall time)", flush=True)
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
