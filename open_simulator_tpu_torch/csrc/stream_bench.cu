// Streaming-bandwidth probe for Hopper (sm_90a): what one step of a
// scan costs that streams a node-state array through every SM and
// separates its steps with a grid-wide barrier.
//
// Replaces the TPU kernel `stream_kernel` of tools/stream_bench.py (its
// pl.pallas_call walks a grid of pod steps, and each step copies every
// (block_rows, 128) int32 block of the state from HBM into VMEM, double
// buffered, and folds a lane-wise max). The function is the same:
//
//   out[l] = sum over s < steps of max(-(2^31) + 1, max_r state[r, l])
//
// summed with int32 wrap-around, the state read in full at every step.
//
// The TPU layout is not carried over. Its (256, 128) int32 tile is 128
// KB, two of them more than a block's 227 KB of shared memory, and the
// TPU's grid runs its steps in order on one core. Here the kernel is
// persistent and cooperative: one block of 512 threads per SM (launched
// with cudaLaunchCooperativeKernel, so all blocks are resident), each
// block owning a contiguous slice of rows. A warp reads one 512-byte row
// per instruction (16 bytes a thread, neighbouring threads on
// neighbouring addresses) and keeps kUnroll rows in flight, so a block
// has 32 KB of loads in flight: the stages live in registers, not in
// shared memory, since a max-reduce reads each byte once and needs no
// reuse. Loads bypass L1 (ld.global.cg): every step reads the slice from
// L2 or device memory, as the TPU kernel reads it from HBM. The 16 warps
// fold their lane maxima through shared memory into one 128-lane partial
// per block, written to a buffer chosen by step parity; one grid barrier
// a step (cooperative_groups grid.sync) then lets block 0 fold the
// partials of that step into the wrapping accumulator (its four groups
// of 128 threads each fold a quarter of the partials). Parity double
// buffering makes one barrier a step enough: a block writes the other
// buffer at step s + 1, and reaches the buffer of step s again only
// after the barrier of step s + 1, which block 0 passes only after its
// fold of step s.
//
// What bounds it on an H100: bytes. A step moves the whole state and
// does one integer max per 4 bytes, so the bound is state bytes x steps
// over the memory rate (3.35 TB/s for device memory). A state of up to
// ~40 MB stays in the 50 MB L2 after the first step, so there the probe
// measures L2 bandwidth and the barrier; past it (64 MiB) it streams
// from device memory. With a small state the barrier is the step: the
// scan-step probe (480,000 bytes, the six int64 state rows at 10,000
// nodes) reads 3.6 KB a block and then waits at the barrier, so its
// microseconds a step are the floor of a multi-block scan step on this
// card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;           // int32 lanes of a state row
constexpr int kThreads = 512;         // 16 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // rows in flight a warp
constexpr int kGroups = kThreads / kLanes;  // 128-thread groups of block 0's fold
constexpr int32_t kFloor = -2147483647;  // -(2^31) + 1

static_assert(kLanes == 4 * 32, "a warp reads one 512-byte row, one int4 a thread");

__device__ __forceinline__ void fold(int4 v, int32_t& m0, int32_t& m1, int32_t& m2,
                                     int32_t& m3) {
  m0 = max(m0, v.x);
  m1 = max(m1, v.y);
  m2 = max(m2, v.z);
  m3 = max(m3, v.w);
}

// state [rows, 128] int32 as int4 [rows, 32]; partial [2, gridDim.x,
// 128] int32 scratch; out [128] int32.
__global__ void __launch_bounds__(kThreads)
stream_kernel(const int4* __restrict__ state, int64_t rows, int64_t steps,
              int32_t* __restrict__ partial, int32_t* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t red[kWarps][kLanes];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t nb = gridDim.x;
  const int64_t r0 = rows * blockIdx.x / nb;
  const int64_t r1 = rows * (blockIdx.x + 1) / nb;
  uint32_t acc = 0;  // block 0, thread l < 128: the wrapping sum of lane l

  for (int64_t s = 0; s < steps; ++s) {
    int32_t m0 = kFloor, m1 = kFloor, m2 = kFloor, m3 = kFloor;
    int64_t r = r0 + warp;
    for (; r + (kUnroll - 1) * kWarps < r1; r += kUnroll * kWarps) {
      int4 v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        v[k] = __ldcg(state + (r + k * kWarps) * 32 + lane);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) fold(v[k], m0, m1, m2, m3);
    }
    for (; r < r1; r += kWarps) fold(__ldcg(state + r * 32 + lane), m0, m1, m2, m3);
    red[warp][lane * 4 + 0] = m0;
    red[warp][lane * 4 + 1] = m1;
    red[warp][lane * 4 + 2] = m2;
    red[warp][lane * 4 + 3] = m3;
    __syncthreads();
    int32_t* buf = partial + (s & 1) * nb * kLanes;
    if (threadIdx.x < kLanes) {
      int32_t m = red[0][threadIdx.x];
      for (int w = 1; w < kWarps; ++w) m = max(m, red[w][threadIdx.x]);
      buf[blockIdx.x * kLanes + threadIdx.x] = m;
    }
    // every block's partial of step s is written and visible; red[] is
    // free again (grid.sync is a block barrier too)
    grid.sync();
    if (blockIdx.x == 0) {
      // the fold of step s: each of the block's kThreads / kLanes groups
      // of 128 threads takes every kGroups-th partial, then thread l
      // combines lane l of the groups
      const int g = threadIdx.x / kLanes, l = threadIdx.x % kLanes;
      int32_t m = kFloor;
#pragma unroll 8
      for (int64_t b = g; b < nb; b += kGroups) m = max(m, __ldcg(buf + b * kLanes + l));
      red[g][l] = m;
      __syncthreads();
      if (threadIdx.x < kLanes) {
        for (int k = 1; k < kGroups; ++k) m = max(m, red[k][threadIdx.x]);
        acc += static_cast<uint32_t>(m);
      }
      // the next step writes red[] again: order the fold's reads first
      __syncthreads();
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < kLanes) out[threadIdx.x] = static_cast<int32_t>(acc);
}

}  // namespace

// The grid the launch takes on the current device: one block per SM,
// never more than the device can keep resident at once (a cooperative
// launch refuses a larger grid). Returns the cudaError_t of the queries.
extern "C" int stream_bench_grid(int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = per_sm > 0 ? sms : 0;
  return per_sm > 0 ? 0 : static_cast<int>(cudaErrorLaunchOutOfResources);
}

// One launch on `stream`: state [rows, 128] int32, partial [2, grid,
// 128] int32 scratch, out [128] int32. Returns the cudaError_t of the
// cooperative launch (0 = launched).
extern "C" int stream_bench_launch(const void* state, int64_t rows, int64_t steps,
                                   void* partial, void* out, int grid, void* stream) {
  const int4* s = static_cast<const int4*>(state);
  int32_t* p = static_cast<int32_t*>(partial);
  int32_t* o = static_cast<int32_t*>(out);
  void* args[] = {&s, &rows, &steps, &p, &o};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stream_kernel), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
