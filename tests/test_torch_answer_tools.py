"""The JAX package's own answer to chip_smoke.py phase 27's cut:
tools/jax_twin_answer.py run on the JAX package (its CPU backend)
prints chip_smoke.JAX_TWIN_ANSWER, the digest the phase holds the port
to on the card (tests/test_torch_twin.py runs the tool's `--port` mode,
the port on the CPU, against the same constant)."""

import os
import subprocess
import sys

import chip_smoke


def test_jax_twin_answer_tool_prints_the_constant_on_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/jax_twin_answer.py"], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"JAX_TWIN_ANSWER {chip_smoke.JAX_TWIN_ANSWER} (open_simulator_tpu, " in out.stdout
