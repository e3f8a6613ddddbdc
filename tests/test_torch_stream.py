"""The streaming-bandwidth probe of the GPU port
(open_simulator_tpu_torch/tools/stream_bench.py) on the CPU: its plain
version `stream_reference` equals the JAX package's Pallas
`stream_kernel` (tools/stream_bench.py, unchanged, run through
`pl.pallas_call(..., interpret=True)` as that tool builds it), exactly:
the output is int32, so the tolerance is equality. The shapes include
sums that wrap int32 and states whose lanes are all INT32_MIN, where
the kernel's floor of -(2^31) + 1 decides every step.

The CUDA kernel equals the plain version in tests/test_torch_cuda.py
(needs the card)."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from open_simulator_tpu_torch.tools import stream_bench

TOOL = Path(__file__).resolve().parent.parent / "tools" / "stream_bench.py"
INT32_MIN = -(2**31)


def _tool():
    spec = importlib.util.spec_from_file_location("jax_stream_bench", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pallas_stream(state: np.ndarray, steps: int, block_rows: int) -> np.ndarray:
    """The TPU tool's pallas_call on `state`, in interpret mode."""
    kernel = functools.partial(_tool().stream_kernel,
                               n_blocks=state.shape[0] // block_rows, block_rows=block_rows)
    call = pl.pallas_call(
        kernel,
        grid=(steps,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, 128), lambda s: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.int32),
        scratch_shapes=[pltpu.VMEM((2, block_rows, 128), jnp.int32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(state)))


def _state(kind: str, rows: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "tool":  # the tool's values, [0, 2^20): no wrap in a few steps
        return rng.randint(0, 1 << 20, (rows, 128), dtype=np.int32)
    if kind == "full":  # the whole int32 range: sums wrap
        return rng.randint(INT32_MIN, 2**31 - 1, (rows, 128), dtype=np.int64).astype(np.int32)
    if kind == "high":  # maxima near 2^30: five steps pass 2^31
        return rng.randint(1 << 29, 1 << 30, (rows, 128), dtype=np.int32)
    if kind == "floor":  # every lane INT32_MIN: the floor is each step's max
        return np.full((rows, 128), INT32_MIN, dtype=np.int32)
    if kind == "mixed":  # half the lanes INT32_MIN, the rest negative or high
        out = rng.randint(1 << 29, 1 << 30, (rows, 128), dtype=np.int32)
        out[:, ::2] = INT32_MIN
        out[: rows // 2, 1::4] = -5
        return out
    raise ValueError(kind)


CASES = {
    # kind, rows, steps, block_rows
    "tool": ("tool", 32, 3, 8),
    "full-range-wraps": ("full", 32, 3, 8),
    "high-wraps": ("high", 64, 5, 16),
    "all-int32-min": ("floor", 16, 3, 8),
    "mixed-lanes": ("mixed", 48, 6, 16),
    "one-block": ("high", 8, 4, 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_equals_the_pallas_kernel(name):
    kind, rows, steps, block_rows = CASES[name]
    state = _state(kind, rows, seed=len(name))
    want = pallas_stream(state, steps, block_rows)
    got = stream_bench.stream_reference(torch.as_tensor(state), steps)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_wrapped_and_the_floored_sums():
    """The two details of the function, by hand: five steps of a max of
    2^30 sum to 5 * 2^30, which wraps to 2^30 + 2^31 - 2^32; three
    floored steps sum to 3 * (-(2^31) + 1) modulo 2^32."""
    high = np.full((8, 128), 1 << 30, dtype=np.int32)
    got = stream_bench.stream_reference(torch.as_tensor(high), 5).numpy()
    assert (got == np.int32(5 * (1 << 30) - (1 << 32))).all()
    floor = np.full((8, 128), INT32_MIN, dtype=np.int32)
    got = stream_bench.stream_reference(torch.as_tensor(floor), 3).numpy()
    want = (3 * stream_bench.FLOOR + 2**31) % 2**32 - 2**31
    assert (got == want).all() and want == -2147483645


def test_wrapper_takes_the_plain_version_on_the_cpu():
    state = torch.as_tensor(_state("full", 16, 3))
    before = dict(stream_bench.LAUNCHES)
    out = stream_bench.run_stream(state, 4)
    assert torch.equal(out, stream_bench.stream_reference(state, 4))
    # the plain version never counts a kernel launch
    assert stream_bench.LAUNCHES == before


def test_state_shape_and_seed_follow_the_tool():
    assert stream_bench.state_rows(8) == 8 * 2**20 // 512
    assert stream_bench.state_rows(480000 / 2**20, block_rows=8) == 936
    assert [stream_bench.tool_steps(mb) for mb in stream_bench.SIZES_MB] == [4000, 2000,
                                                                           1000, 500]
    a = stream_bench.make_state(0.25, seed=3)
    b = stream_bench.make_state(0.25, seed=3)
    assert a.dtype == torch.int32 and tuple(a.shape) == (512, 128) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 20


def test_main_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stream_bench.main([]) == 2
    assert "is_available" in capsys.readouterr().err


def test_main_on_the_cpu_names_the_plain_version(monkeypatch, capsys):
    monkeypatch.setattr(stream_bench, "SIZES_MB", (0.25, 0.5))
    monkeypatch.setattr(stream_bench, "tool_steps", lambda mb: 2)
    assert stream_bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert all("GB/s achieved (plain version on the CPU: not a device number)" in ln
               for ln in lines)
    assert stream_bench.run(0.25, 2, device="cpu") > 0
