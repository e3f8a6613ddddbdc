// Fused sequential-commit scheduling scan for Hopper (sm_90a): the base
// plan, the scalar / hostPort / GPU-share blocks, and the scenario batch.
//
// Replaces the TPU kernel of the JAX package's ops/pallas_scan.py
// (_make_kernel -> kernel -> step, launched by run_scan_pallas) and its
// scenario batch (run_scan_pallas_batch). Base plan: NodeResourcesFit on
// cpu/memory/ephemeral storage with the zero-request gate, the pod-count
// limit, the class's static feasible row and the scenario's node mask;
// LeastAllocated, BalancedAllocation (f64), Simon min-max, NodeAffinity
// and TaintToleration normalised over the feasible nodes, plus the
// prefolded ImageLocality/NodePreferAvoidPods row; first-max selection
// with ties to the lowest node index; nodeName pins; INACTIVE pods; and
// the commit of the six per-node states. Optional blocks, each a
// compile-time flag so that a plan without them runs the base code:
//   kScal  extended scalar resources join the fit (inside the
//          zero-request gate) and are committed at the placed node;
//   kPorts NodePorts: a node clashes when any occupied port word meets
//          the class's conflict word; the commit ORs in the class's
//          want word (the two differ: the wildcard and the protocol
//          are folded into the conflict words by the encoder);
//   kGpu   open-gpu-share: per-device memory fit, one GPU takes the
//          tightest fit (strict <, first device on ties), several GPUs
//          the greedy prefix of per-device capacities in device order;
//          the owner thread of the placed node recomputes that choice
//          from the node's state and charges it (pins included).
// Semantics follow the JAX package's XLA scan (ops/scan.py, _gpu_allocate
// for the device choice): int64 state and class tables in true units over
// the unpadded node axis, with no cap on scalar kinds, devices per node
// or port words.
//
// kBatch runs one independent scenario per block (blockIdx.x): each
// block reads the shared plan and its own active/pinned/valid rows and
// keeps its own state rows and scratch, so S capacity probes run in one
// launch at about the wall time of one (one scan occupies one SM).
//
// What bounds it on an H100: the scan is a serial chain of P pod steps.
// Every step depends on the previous step's commit, so the steps cannot
// overlap, and each step is two block-wide reductions (two
// __syncthreads barriers) around two passes over the node axis. Per
// step the block reads the six int64 state rows, four allocatable rows,
// the feasible byte row, the node mask and four int64 class rows: about
// 110 bytes per node, 1.1 MB at 10,000 nodes, which one SM pulls from L2
// (it does not fit in that SM's L1). The arithmetic, about 50 integer
// and f64 operations per node, is small beside that. The GPU block adds
// a 64-bit software division per device per feasible node for a
// multi-GPU class.
//
// What the design does about it: one block of 1024 threads runs the
// whole pod loop inside the kernel, so a step costs no launch and no
// host round trip. Thread t owns nodes t, t+1024, ...: it is the only
// thread that reads or writes those nodes' state, so the commit needs
// no barrier and the state stays in device memory (L2-resident). Pass
// 1 computes feasibility, the feasibility-independent scores and the
// min/max the normalisations need; pass 2 adds the normalised scores
// and reduces (score, -index) to the first maximum. Each reduction is
// warp shuffles, one shared-memory exchange and one barrier; the two
// reductions use separate shared buffers so that no third barrier is
// needed between pods. Pinned and inactive pods skip both passes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxScore = 100;
constexpr int32_t kInactive = -2;
constexpr int64_t kI64Max = 0x7fffffffffffffffLL;
constexpr int64_t kI64Min = -kI64Max - 1;
// "-big" of the XLA scan's min-max sentinel (jnp.iinfo(int64).max negated)
constexpr int64_t kNegBig = -kI64Max;

// int64 arithmetic that wraps like XLA's instead of being undefined
__device__ __forceinline__ int64_t add_w(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t sub_w(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t mul_w(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
// floor division (jnp's //) for a positive divisor
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    int64_t x = __shfl_xor_sync(0xffffffffu, v, o);
    v = x > v ? x : v;
  }
  return v;
}
__device__ __forceinline__ int64_t warp_min(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    int64_t x = __shfl_xor_sync(0xffffffffu, v, o);
    v = x < v ? x : v;
  }
  return v;
}
// (score, index) pair: larger score wins, ties to the lower index
__device__ __forceinline__ void warp_argmax(int64_t& s, int64_t& i) {
  for (int o = 16; o > 0; o >>= 1) {
    int64_t xs = __shfl_xor_sync(0xffffffffu, s, o);
    int64_t xi = __shfl_xor_sync(0xffffffffu, i, o);
    if (xs > s || (xs == s && xi < i)) {
      s = xs;
      i = xi;
    }
  }
}

// state rows of the [6, N] state array
enum { kUsedCpu = 0, kUsedMem, kUsedEph, kNzCpu, kNzMem, kPodCnt };
// rows of the [4, N] allocatable array
enum { kAllocCpu = 0, kAllocMem, kAllocEph, kAllocPods };
// tables of the [4, U, N] class array
enum { kTabSimon = 0, kTabNodeAff, kTabTaint, kTabBase };
// columns of the [U, 6] class request array
enum { kReqCpu = 0, kReqMem, kReqEph, kReqNzCpu, kReqNzMem, kReqHas };
// rows of the [3, N] GPU node array
enum { kGpuPerDev = 0, kGpuCount, kGpuTotal };

struct Weights {
  int64_t least, balanced, simon, nodeaff, tainttol;
};

// The arguments of one launch, gathered on the host from the wrapper's
// int64 vector. Plan arrays are shared by all scenarios; the
// per-scenario arrays are [S, ...] with S = gridDim.x for the batch
// kernel and S = 1 otherwise. B2 pointers are null when their block is
// off.
struct ScanArgs {
  const int64_t* alloc;         // [4, N]
  const int64_t* init;          // [6, N]
  const uint8_t* feasible;      // [U, N]
  const int64_t* cls_tab;       // [4, U, N]
  const int64_t* cls_req;       // [U, 6]
  const int32_t* class_of_pod;  // [P]
  const int64_t* scal_alloc;    // [K, N] scalar kinds
  const int64_t* scal_init;     // [K, N]
  const int64_t* scal_req;      // [U, K]
  const int64_t* gpu_node;      // [3, N] per-device memory, devices, total
  const int64_t* gpu_init;      // [G, N] per-device used memory
  const int64_t* gpu_cls;       // [U, 2] per-GPU memory, GPU count
  const int32_t* port_init;     // [W, N] occupied-port words
  const int32_t* port_cls;      // [2, U, W] want words, conflict words
  const uint8_t* active;        // [S, P]
  const int32_t* pinned;        // [S, P]
  const uint8_t* valid;         // [S, N]
  int64_t* state;               // [S, 6, N]
  int64_t* scal_state;          // [S, K, N]
  int64_t* gpu_state;           // [S, G, N]
  int32_t* port_state;          // [S, W, N]
  int64_t* partial;             // [S, N] scratch
  int32_t* placements;          // [S, P]
  int64_t n, u_n, p_n, k_n, g_n, w_n;
  Weights w;
};

// open-gpu-share filter at one node (scan.py _gpu_allocate's `found`,
// gated by the node's total GPU memory)
__device__ __forceinline__ bool gpu_fits(const int64_t* used, int64_t n, int64_t i,
                                         int64_t g_n, int64_t per_dev, int64_t cnt,
                                         int64_t total, int64_t gm, int64_t gc) {
  if (total < gm) return false;
  if (gc == 1) {
    for (int64_t g = 0; g < g_n && g < cnt; ++g) {
      if (sub_w(per_dev, used[g * n + i]) >= gm) return true;
    }
    return false;
  }
  // several GPUs: the capacities avail // gm summed in device order
  const int64_t gm1 = gm > 1 ? gm : 1;
  int64_t sum = 0;
  if (sum >= gc) return true;
  for (int64_t g = 0; g < g_n && g < cnt; ++g) {
    const int64_t cap = floordiv(sub_w(per_dev, used[g * n + i]), gm1);
    if (cap > 0) sum = add_w(sum, cap);
    if (sum >= gc) return true;
  }
  return false;
}

// charge the device choice at the placed node (scan.py commit:
// gpu_used += take * gpu_mem on that node only)
__device__ __forceinline__ void gpu_commit(int64_t* used, int64_t n, int64_t i,
                                           int64_t g_n, int64_t per_dev, int64_t cnt,
                                           int64_t gm, int64_t gc) {
  if (gc == 1) {
    // tightest fit: strict < keeps the first device on ties
    int64_t best = -1, key = kI64Max;
    for (int64_t g = 0; g < g_n && g < cnt; ++g) {
      const int64_t avail = sub_w(per_dev, used[g * n + i]);
      if (avail >= gm && avail < key) {
        key = avail;
        best = g;
      }
    }
    if (best >= 0) used[best * n + i] = add_w(used[best * n + i], gm);
    return;
  }
  // two-pointer greedy: take clip(gc - prefix, 0, cap) on each device
  const int64_t gm1 = gm > 1 ? gm : 1;
  int64_t prefix = 0;
  for (int64_t g = 0; g < g_n && g < cnt; ++g) {
    int64_t cap = floordiv(sub_w(per_dev, used[g * n + i]), gm1);
    cap = cap > 0 ? cap : 0;
    int64_t take = sub_w(gc, prefix);
    take = take > 0 ? take : 0;
    take = take < cap ? take : cap;
    used[g * n + i] = add_w(used[g * n + i], mul_w(take, gm));
    prefix = add_w(prefix, cap);
  }
}

template <bool kBatch, bool kScal, bool kGpu, bool kPorts>
__global__ void __launch_bounds__(kThreads, 1) fused_scan_kernel(
    const int64_t* __restrict__ alloc, const int64_t* __restrict__ init,
    const uint8_t* __restrict__ feasible, const int64_t* __restrict__ cls_tab,
    const int64_t* __restrict__ cls_req, const int32_t* __restrict__ class_of_pod,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ pinned,
    const uint8_t* __restrict__ valid, int64_t* __restrict__ state,
    int64_t* __restrict__ partial, int32_t* __restrict__ placements, int64_t n,
    int64_t u_n, int64_t p_n, Weights w, const int64_t* __restrict__ scal_alloc,
    const int64_t* __restrict__ scal_init, const int64_t* __restrict__ scal_req,
    int64_t* __restrict__ scal_used, const int64_t* __restrict__ gpu_node,
    const int64_t* __restrict__ gpu_init, const int64_t* __restrict__ gpu_cls,
    int64_t* __restrict__ gpu_used, const int32_t* __restrict__ port_init,
    const int32_t* __restrict__ port_cls, int32_t* __restrict__ port_used, int64_t k_n,
    int64_t g_n, int64_t w_n) {
  // pass-1 exchange: simon hi, simon lo, nodeaff max, taint max, any
  __shared__ int64_t red1[5][kWarps];
  // pass-2 exchange: (score, index)
  __shared__ int64_t red2[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (kBatch) {
    // this block's scenario: its masks, pins, state rows and scratch
    const int64_t sc = blockIdx.x;
    active += sc * p_n;
    pinned += sc * p_n;
    valid += sc * n;
    state += sc * 6 * n;
    partial += sc * n;
    placements += sc * p_n;
    if (kScal) scal_used += sc * k_n * n;
    if (kGpu) gpu_used += sc * g_n * n;
    if (kPorts) port_used += sc * w_n * n;
  }

  const int64_t* alloc_c = alloc + kAllocCpu * n;
  const int64_t* alloc_m = alloc + kAllocMem * n;
  const int64_t* alloc_e = alloc + kAllocEph * n;
  const int64_t* alloc_p = alloc + kAllocPods * n;
  int64_t* used_c = state + kUsedCpu * n;
  int64_t* used_m = state + kUsedMem * n;
  int64_t* used_e = state + kUsedEph * n;
  int64_t* nz_c = state + kNzCpu * n;
  int64_t* nz_m = state + kNzMem * n;
  int64_t* pods = state + kPodCnt * n;

  // each thread copies the initial state of the nodes it owns
  for (int64_t i = tid; i < n; i += kThreads) {
    for (int k = 0; k < 6; ++k) state[k * n + i] = init[k * n + i];
    if (kScal) {
      for (int64_t k = 0; k < k_n; ++k) scal_used[k * n + i] = scal_init[k * n + i];
    }
    if (kGpu) {
      for (int64_t g = 0; g < g_n; ++g) gpu_used[g * n + i] = gpu_init[g * n + i];
    }
    if (kPorts) {
      for (int64_t v = 0; v < w_n; ++v) port_used[v * n + i] = port_init[v * n + i];
    }
  }

  for (int64_t p = 0; p < p_n; ++p) {
    const int64_t u = class_of_pod[p];
    const int64_t* req = cls_req + u * 6;
    const int64_t rc = req[kReqCpu], rm = req[kReqMem], re = req[kReqEph];
    const int64_t nzc = req[kReqNzCpu], nzm = req[kReqNzMem];
    const bool has_req = req[kReqHas] != 0;
    const int32_t pin = pinned[p];
    const int64_t* sreq = kScal ? scal_req + u * k_n : nullptr;
    const int64_t gm = kGpu ? gpu_cls[u * 2] : 0;
    const int64_t gc = kGpu ? gpu_cls[u * 2 + 1] : 0;
    const int32_t* want_w = kPorts ? port_cls + u * w_n : nullptr;
    const int32_t* confl_w = kPorts ? port_cls + (u_n + u) * w_n : nullptr;

    int64_t place;
    if (!active[p]) {
      place = kInactive;
    } else if (pin >= 0) {
      // a pin overrides feasibility; outside the node mask it is INACTIVE
      place = valid[pin] ? pin : kInactive;
    } else {
      const uint8_t* feas_row = feasible + u * n;
      const int64_t* simon_row = cls_tab + (kTabSimon * u_n + u) * n;
      const int64_t* na_row = cls_tab + (kTabNodeAff * u_n + u) * n;
      const int64_t* tt_row = cls_tab + (kTabTaint * u_n + u) * n;
      const int64_t* base_row = cls_tab + (kTabBase * u_n + u) * n;

      // ---- pass 1: filter, state-only scores, normalisation bounds
      int64_t hi = kNegBig, lo = kI64Max, na_mx = 0, tt_mx = 0, any = 0;
      for (int64_t i = tid; i < n; i += kThreads) {
        bool ok = feas_row[i] && valid[i] && add_w(pods[i], 1) <= alloc_p[i];
        if (ok && has_req) {
          ok = alloc_c[i] >= add_w(rc, used_c[i]) && alloc_m[i] >= add_w(rm, used_m[i]) &&
               alloc_e[i] >= add_w(re, used_e[i]);
          if (kScal) {
            for (int64_t k = 0; ok && k < k_n; ++k) {
              ok = scal_alloc[k * n + i] >= add_w(sreq[k], scal_used[k * n + i]);
            }
          }
        }
        if (kPorts) {
          for (int64_t v = 0; ok && v < w_n; ++v) ok = (port_used[v * n + i] & confl_w[v]) == 0;
        }
        if (kGpu && ok && gm > 0) {
          ok = gpu_fits(gpu_used, n, i, g_n, gpu_node[kGpuPerDev * n + i],
                        gpu_node[kGpuCount * n + i], gpu_node[kGpuTotal * n + i], gm, gc);
        }
        int64_t part = kI64Min;  // marks an infeasible node for pass 2
        if (ok) {
          any = 1;
          part = base_row[i];
          const int64_t ac = alloc_c[i], am = alloc_m[i];
          const int64_t totc = add_w(nz_c[i], nzc), totm = add_w(nz_m[i], nzm);
          if (w.least) {
            int64_t lc = (ac > 0 && totc <= ac)
                             ? floordiv(mul_w(sub_w(ac, totc), kMaxScore), ac > 1 ? ac : 1)
                             : 0;
            int64_t lm = (am > 0 && totm <= am)
                             ? floordiv(mul_w(sub_w(am, totm), kMaxScore), am > 1 ? am : 1)
                             : 0;
            part = add_w(part, mul_w(floordiv(add_w(lc, lm), 2), w.least));
          }
          if (w.balanced) {
            double cf = ac > 0 ? __ddiv_rn(__ll2double_rn(totc), __ll2double_rn(ac > 1 ? ac : 1))
                               : 1.0;
            double mf = am > 0 ? __ddiv_rn(__ll2double_rn(totm), __ll2double_rn(am > 1 ? am : 1))
                               : 1.0;
            int64_t bal = 0;
            if (!(cf >= 1.0 || mf >= 1.0)) {
              bal = __double2ll_rz(__dmul_rn(__dsub_rn(1.0, fabs(__dsub_rn(cf, mf))),
                                             (double)kMaxScore));
            }
            part = add_w(part, mul_w(bal, w.balanced));
          }
          if (w.simon) {
            const int64_t r = simon_row[i];
            hi = r > hi ? r : hi;
            lo = r < lo ? r : lo;
          }
          if (w.nodeaff) {
            const int64_t r = na_row[i];
            na_mx = r > na_mx ? r : na_mx;
          }
          if (w.tainttol) {
            const int64_t r = tt_row[i];
            tt_mx = r > tt_mx ? r : tt_mx;
          }
        }
        partial[i] = part;
      }
      hi = warp_max(hi);
      lo = warp_min(lo);
      na_mx = warp_max(na_mx);
      tt_mx = warp_max(tt_mx);
      any = warp_max(any);
      if (lane == 0) {
        red1[0][warp] = hi;
        red1[1][warp] = lo;
        red1[2][warp] = na_mx;
        red1[3][warp] = tt_mx;
        red1[4][warp] = any;
      }
      __syncthreads();
      // every warp finishes the reduction itself: no second barrier
      hi = warp_max(red1[0][lane]);
      lo = warp_min(red1[1][lane]);
      na_mx = warp_max(red1[2][lane]);
      tt_mx = warp_max(red1[3][lane]);
      any = warp_max(red1[4][lane]);

      // ---- pass 2: normalised scores, first maximum
      const int64_t rng = sub_w(hi, lo);
      int64_t best_s = kI64Min, best_i = kI64Max;
      for (int64_t i = tid; i < n; i += kThreads) {
        int64_t total = partial[i];
        if (total == kI64Min) continue;
        if (w.simon) {
          int64_t s = rng > 0 ? floordiv(mul_w(sub_w(simon_row[i], lo), kMaxScore), rng) : 0;
          total = add_w(total, mul_w(s, w.simon));
        }
        if (w.nodeaff) {
          int64_t s = na_mx > 0 ? floordiv(mul_w(kMaxScore, na_row[i]), na_mx) : 0;
          total = add_w(total, mul_w(s, w.nodeaff));
        }
        if (w.tainttol) {
          int64_t s = tt_mx > 0 ? kMaxScore - floordiv(mul_w(kMaxScore, tt_row[i]), tt_mx)
                                : kMaxScore;
          total = add_w(total, mul_w(s, w.tainttol));
        }
        // nodes are visited in increasing order: strict > keeps the first
        if (best_i == kI64Max || total > best_s) {
          best_s = total;
          best_i = i;
        }
      }
      warp_argmax(best_s, best_i);
      if (lane == 0) {
        red2[0][warp] = best_s;
        red2[1][warp] = best_i;
      }
      __syncthreads();
      best_s = red2[0][lane];
      best_i = red2[1][lane];
      warp_argmax(best_s, best_i);
      place = any ? best_i : -1;
    }

    if (place >= 0 && (place % kThreads) == tid) {
      // the owner thread commits; the next step's pass 1 reads these
      // nodes from the same thread, so no barrier is needed
      used_c[place] = add_w(used_c[place], rc);
      used_m[place] = add_w(used_m[place], rm);
      used_e[place] = add_w(used_e[place], re);
      nz_c[place] = add_w(nz_c[place], nzc);
      nz_m[place] = add_w(nz_m[place], nzm);
      pods[place] = add_w(pods[place], 1);
      if (kScal) {
        for (int64_t k = 0; k < k_n; ++k) {
          scal_used[k * n + place] = add_w(scal_used[k * n + place], sreq[k]);
        }
      }
      if (kPorts) {
        for (int64_t v = 0; v < w_n; ++v) port_used[v * n + place] |= want_w[v];
      }
      if (kGpu && gm > 0) {
        gpu_commit(gpu_used, n, place, g_n, gpu_node[kGpuPerDev * n + place],
                   gpu_node[kGpuCount * n + place], gm, gc);
      }
    }
    if (tid == 0) placements[p] = (int32_t)place;
  }
}

using LaunchFn = int (*)(const ScanArgs&, int64_t, cudaStream_t);

template <bool kBatch, bool kScal, bool kGpu, bool kPorts>
int launch(const ScanArgs& a, int64_t scenarios, cudaStream_t stream) {
  fused_scan_kernel<kBatch, kScal, kGpu, kPorts><<<(unsigned)scenarios, kThreads, 0, stream>>>(
      a.alloc, a.init, a.feasible, a.cls_tab, a.cls_req, a.class_of_pod, a.active, a.pinned,
      a.valid, a.state, a.partial, a.placements, a.n, a.u_n, a.p_n, a.w, a.scal_alloc,
      a.scal_init, a.scal_req, a.scal_state, a.gpu_node, a.gpu_init, a.gpu_cls, a.gpu_state,
      a.port_init, a.port_cls, a.port_state, a.k_n, a.g_n, a.w_n);
  return static_cast<int>(cudaGetLastError());
}

#define FS_LAUNCH_ROW(B)                                                          \
  launch<B, false, false, false>, launch<B, false, false, true>,                  \
      launch<B, false, true, false>, launch<B, false, true, true>,                \
      launch<B, true, false, false>, launch<B, true, false, true>,                \
      launch<B, true, true, false>, launch<B, true, true, true>

// indexed by batch << 3 | scal << 2 | gpu << 1 | ports
const LaunchFn kLaunch[16] = {FS_LAUNCH_ROW(false), FS_LAUNCH_ROW(true)};

// layout of the int64 argument vector the wrapper passes
enum {
  kArgAlloc = 0, kArgInit, kArgFeasible, kArgClsTab, kArgClsReq, kArgClassOfPod,
  kArgScalAlloc, kArgScalInit, kArgScalReq, kArgGpuNode, kArgGpuInit, kArgGpuCls,
  kArgPortInit, kArgPortCls, kArgActive, kArgPinned, kArgValid, kArgState,
  kArgScalState, kArgGpuState, kArgPortState, kArgPartial, kArgPlacements,
  kArgN, kArgU, kArgP, kArgK, kArgG, kArgW,
  kArgWLeast, kArgWBalanced, kArgWSimon, kArgWNodeAff, kArgWTaintTol,
  kArgScenarios, kArgFlags, kArgCount
};

template <typename T>
T ptr(const int64_t* v, int k) {
  return reinterpret_cast<T>(static_cast<uintptr_t>(v[k]));
}

}  // namespace

// The argument vector's length, so that the wrapper can check it agrees
// with this build.
extern "C" int64_t fused_scan_arg_count() { return kArgCount; }

// One launch: `args` holds kArgCount int64 values in the order above
// (pointers as integers; null for an absent block). flags bit 3 = one
// block per scenario, bit 2 = scalars, bit 1 = GPU-share, bit 0 =
// hostPorts. Returns the cudaError_t of the launch (0 = launched).
extern "C" int fused_scan_launch(const int64_t* args, int64_t n_args, void* stream) {
  if (n_args != kArgCount) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* v = args;
  ScanArgs a;
  a.alloc = ptr<const int64_t*>(v, kArgAlloc);
  a.init = ptr<const int64_t*>(v, kArgInit);
  a.feasible = ptr<const uint8_t*>(v, kArgFeasible);
  a.cls_tab = ptr<const int64_t*>(v, kArgClsTab);
  a.cls_req = ptr<const int64_t*>(v, kArgClsReq);
  a.class_of_pod = ptr<const int32_t*>(v, kArgClassOfPod);
  a.scal_alloc = ptr<const int64_t*>(v, kArgScalAlloc);
  a.scal_init = ptr<const int64_t*>(v, kArgScalInit);
  a.scal_req = ptr<const int64_t*>(v, kArgScalReq);
  a.gpu_node = ptr<const int64_t*>(v, kArgGpuNode);
  a.gpu_init = ptr<const int64_t*>(v, kArgGpuInit);
  a.gpu_cls = ptr<const int64_t*>(v, kArgGpuCls);
  a.port_init = ptr<const int32_t*>(v, kArgPortInit);
  a.port_cls = ptr<const int32_t*>(v, kArgPortCls);
  a.active = ptr<const uint8_t*>(v, kArgActive);
  a.pinned = ptr<const int32_t*>(v, kArgPinned);
  a.valid = ptr<const uint8_t*>(v, kArgValid);
  a.state = ptr<int64_t*>(v, kArgState);
  a.scal_state = ptr<int64_t*>(v, kArgScalState);
  a.gpu_state = ptr<int64_t*>(v, kArgGpuState);
  a.port_state = ptr<int32_t*>(v, kArgPortState);
  a.partial = ptr<int64_t*>(v, kArgPartial);
  a.placements = ptr<int32_t*>(v, kArgPlacements);
  a.n = v[kArgN];
  a.u_n = v[kArgU];
  a.p_n = v[kArgP];
  a.k_n = v[kArgK];
  a.g_n = v[kArgG];
  a.w_n = v[kArgW];
  a.w = Weights{v[kArgWLeast], v[kArgWBalanced], v[kArgWSimon], v[kArgWNodeAff],
                v[kArgWTaintTol]};
  const int64_t scenarios = v[kArgScenarios];
  const int64_t flags = v[kArgFlags];
  if (flags < 0 || flags > 15 || scenarios < 1 || (scenarios > 1 && !(flags & 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kLaunch[flags](a, scenarios, static_cast<cudaStream_t>(stream));
}
