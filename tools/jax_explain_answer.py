"""The JAX package's answer to chip_smoke.py phase 21: the quickstart
(chip_smoke.QUICKSTART) planned with `--explain chip_smoke.EXPLAIN_POD`,
through the JAX package's CLI on its CPU backend (the XLA scan):

- `apply -f example/simon-config.yaml --format json --explain POD`
  (chip_smoke.JAX_EXPLAIN_ANSWER).

    JAX_PLATFORMS=cpu python tools/jax_explain_answer.py

Prints the sha256 of the command's stdout, its exit code, its wall time
and its length; the card's run of the port's CLI must print the same
bytes.
"""

import contextlib
import hashlib
import io
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke
    from open_simulator_tpu import cli
    from open_simulator_tpu.models.workloads import reset_name_counter

    os.chdir(ROOT)
    reset_name_counter()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["apply", "-f", chip_smoke.QUICKSTART, "--format", "json", "--explain",
                       chip_smoke.EXPLAIN_POD])
    text = out.getvalue()
    print(f"JAX_EXPLAIN_ANSWER {hashlib.sha256(text.encode()).hexdigest()} (exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s CPU wall time, {len(text)} bytes)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
