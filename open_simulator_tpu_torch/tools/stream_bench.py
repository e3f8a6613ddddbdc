"""Streaming-bandwidth probe on the card: the counterpart of the JAX
package's tools/stream_bench.py, whose Pallas kernel measures what a
node-blocked scan step costs on a TPU when it streams the whole state
through VMEM every pod step.

The kernel (csrc/stream_bench.cu) streams an int32 state [rows, 128]
through every SM once a step, folds a lane-wise max, and separates the
steps with a grid-wide barrier:

    out[l] = sum over s < steps of max(-(2^31) + 1, max_r state[r, l])

summed with int32 wrap-around. Its time is the floor of a scan step
whose node axis is split over all SMs: the state's bytes over the
memory rate, or the barrier when the state is small.

    python -m open_simulator_tpu_torch.tools.stream_bench [--device cpu]

prints the achieved GB/s at the TPU tool's four sizes (8, 16, 32 and 64
MiB, steps = max(1, int(2000 * 16 / mb))) and, on the card, whether each
state fits the L2 (then the steps after the first read L2) or streams
from device memory. Without a card it exits 2, unless asked for the
CPU, where the plain version runs (a CPU number, not a device one).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import threading
import time

import numpy as np
import torch

from ..obs import profile
from ..ops.fused_scan import NoCardError, resolve_device
from ..utils import nvcc

LANES = 128
FLOOR = -(2**31) + 1
KERNEL_NAME = "stream_bench"
SOURCE = nvcc.CSRC / "stream_bench.cu"
SIZES_MB = (8, 16, 32, 64)
# launches of the kernel, counted where the wrapper launches it and
# nowhere else
LAUNCHES = {KERNEL_NAME: 0}
_LIB = None
_LIB_LOCK = threading.Lock()  # one thread builds and loads at first use


def tool_steps(state_mb: float) -> int:
    """The TPU tool's step count for a size: about constant total bytes."""
    return max(1, int(2000 * 16 / state_mb))


def state_rows(state_mb: float, block_rows: int = 256) -> int:
    """Rows of the state at `state_mb` MiB, a multiple of block_rows (the
    TPU tool's shape rule; the card's kernel has no tile of that size)."""
    rows = int(state_mb * 2**20) // (LANES * 4)
    return (rows // block_rows) * block_rows


def make_state(state_mb: float, block_rows: int = 256, seed: int = 0,
               device="cpu") -> torch.Tensor:
    """The int32 state [rows, 128], values in [0, 2^20), from a numpy
    RandomState(seed), on `device`."""
    rows = state_rows(state_mb, block_rows)
    vals = np.random.RandomState(seed).randint(0, 1 << 20, (rows, LANES), dtype=np.int32)
    return torch.as_tensor(vals, device=device)


def stream_reference(state: torch.Tensor, steps: int) -> torch.Tensor:
    """The plain PyTorch version, step by step: each step reads the whole
    state, takes its lane-wise max floored at -(2^31) + 1, and adds it
    to the accumulator, which is folded back into int32 (wrap-around)
    after every add. Returns [1, 128] int32."""
    acc = torch.zeros(LANES, dtype=torch.int64, device=state.device)
    for _ in range(steps):
        if state.shape[0]:
            m = state.amax(dim=0).long().clamp(min=FLOOR)
        else:
            m = torch.full((LANES,), FLOOR, dtype=torch.int64, device=state.device)
        acc = torch.remainder(acc + m + 2**31, 2**32) - 2**31
    return acc.to(torch.int32).view(1, LANES)


def _library():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        # compiled for sm_90a into build/torch_kernels/ at first use
        lib = ctypes.CDLL(str(nvcc.build_library(SOURCE)))
        lib.stream_bench_grid.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.stream_bench_grid.restype = ctypes.c_int
        lib.stream_bench_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.stream_bench_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_record(state: torch.Tensor, steps: int, grid: int):
    """The cost record of one launch (obs/costs.py): the state read once
    a step, one max a value a step, and the partial and output rows it
    allocates."""
    from ..obs import costs

    nbytes = state.numel() * state.element_size()
    return costs.CostRecord(
        site="stream_bench", kernel=KERNEL_NAME,
        shape={"rows": int(state.shape[0]), "steps": int(steps), "grid": grid},
        bytes=nbytes * int(steps), ops=state.numel() * int(steps),
        workspace_bytes=costs.alloc_bytes(2 * grid * LANES * 4) + costs.alloc_bytes(LANES * 4))


def run_stream(state: torch.Tensor, steps: int) -> torch.Tensor:
    """out [1, 128] int32 of `steps` streaming steps over `state`. A
    state on the CPU takes the plain version; one on a CUDA device
    launches the kernel (asynchronously, on the current stream) or
    raises. The launch is instrumented at site `stream_bench`
    (obs/profile.py)."""
    with profile.launch("stream_bench", state.device) as ln:
        if state.device.type == "cpu":
            return stream_reference(state, steps)
        return _launch(state, steps, ln)


def _launch(state: torch.Tensor, steps: int, ln) -> torch.Tensor:
    if state.device.type != "cuda":
        raise ValueError(f"stream_bench runs on the CPU or a CUDA device, not {state.device}")
    if state.dtype != torch.int32 or state.dim() != 2 or state.shape[1] != LANES:
        raise ValueError(f"state: want int32 [rows, {LANES}], got {state.dtype} "
                         f"{tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("state is not contiguous")
    lib = _library()
    with torch.cuda.device(state.device):
        grid = ctypes.c_int(0)
        err = lib.stream_bench_grid(ctypes.byref(grid))
        if err != 0:
            raise RuntimeError(f"{KERNEL_NAME}: occupancy query failed: cudaError {err}")
        partial = torch.empty((2, grid.value, LANES), dtype=torch.int32, device=state.device)
        out = torch.empty((1, LANES), dtype=torch.int32, device=state.device)
        stream = torch.cuda.current_stream(state.device).cuda_stream
        ln.start()
        err = lib.stream_bench_launch(state.data_ptr(), state.shape[0], int(steps),
                                      partial.data_ptr(), out.data_ptr(), grid.value, stream)
        ln.stop()
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {err}")
    LAUNCHES[KERNEL_NAME] += 1
    ln.cost((int(state.shape[0]), int(steps), grid.value),
            lambda: stream_record(state, steps, grid.value))
    return out


def reset_launch_counts() -> None:
    LAUNCHES[KERNEL_NAME] = 0


def run(state_mb: float, steps: int, block_rows: int = 256, device=None,
        seed: int = 0) -> float:
    """Achieved GB/s of `steps` steps over a `state_mb` MiB state: one
    warm-up launch, then one timed by CUDA events on the card (by the
    host clock for the plain version on the CPU)."""
    dev = resolve_device(device)
    state = make_state(state_mb, block_rows, seed, dev)
    run_stream(state, steps)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        run_stream(state, steps)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        run_stream(state, steps)
        seconds = time.perf_counter() - t0
    return state.numel() * 4 * steps / 1e9 / seconds


def l2_bytes(device) -> int:
    """The card's L2 size (50 MB on an H100 when the property is absent)."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "L2_cache_size", 50 * 10**6))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m open_simulator_tpu_torch.tools.stream_bench",
        description="streaming-bandwidth probe of a node-blocked scan step")
    parser.add_argument("--device", default=None,
                        help="the card (default) or 'cpu' for the plain version")
    args = parser.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except NoCardError as e:
        print(f"stream_bench: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        where = torch.cuda.get_device_name(dev)
        l2 = l2_bytes(dev)
    else:
        where = "plain version on the CPU: not a device number"
        l2 = None
    for mb in SIZES_MB:
        steps = tool_steps(mb)
        bw = run(mb, steps, device=dev)
        regime = ""
        if l2 is not None:
            nbytes = state_rows(mb) * LANES * 4
            regime = ", in L2 after the first step" if nbytes <= l2 else ", from device memory"
        print(f"state {mb:3g} MB, {steps} steps: {bw:7.1f} GB/s achieved ({where}{regime})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
