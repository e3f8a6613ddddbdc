"""The JAX package's answer to chip_smoke.py phase 24c's cut: the serve
cluster cut to chip_smoke.SERVE_JAX_NODES nodes and
chip_smoke.SERVE_JAX_PODS committed pods, run through the JAX package's
`Session` and `ServeDaemon` in this process on its CPU backend (the XLA
scan): one tick of chip_smoke.SERVE_CUT_REQUESTS, two evictions and two
arrivals over POST /v1/cluster-delta, GET /v1/state-digest, the same
requests in a second tick (chip_smoke.serve_cut_digest):

    JAX_PLATFORMS=cpu python tools/jax_serve_answer.py

Prints the sha256 of the bodies and state digests
(chip_smoke.JAX_SERVE_ANSWER) with the wall time, a CPU figure. With
`--port` it runs the GPU port's Session and ServeDaemon instead, on the
CPU (`device="cpu"`, the kernels' plain versions): the same digest.
"""

import resource
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import chip_smoke

    if "--port" in sys.argv[1:]:
        from open_simulator_tpu_torch.models.decode import ResourceTypes
        from open_simulator_tpu_torch.models.workloads import reset_name_counter
        from open_simulator_tpu_torch.serve.server import ServeDaemon
        from open_simulator_tpu_torch.serve.session import Session

        pkg, session_kw = "open_simulator_tpu_torch", {"device": "cpu"}
    else:
        from open_simulator_tpu.models.decode import ResourceTypes
        from open_simulator_tpu.models.workloads import reset_name_counter
        from open_simulator_tpu.serve.server import ServeDaemon
        from open_simulator_tpu.serve.session import Session

        pkg, session_kw = "open_simulator_tpu", {}
    digest, secs = chip_smoke.serve_cut_digest(Session, ServeDaemon, ResourceTypes,
                                               reset_name_counter, **session_kw)
    print(f"JAX_SERVE_ANSWER {digest} ({pkg}, {chip_smoke.SERVE_JAX_NODES} nodes x "
          f"{chip_smoke.SERVE_JAX_PODS} pods, {2 * len(chip_smoke.SERVE_CUT_REQUESTS)} "
          f"requests around 4 deltas, {secs:.1f} s CPU wall time)", flush=True)
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
