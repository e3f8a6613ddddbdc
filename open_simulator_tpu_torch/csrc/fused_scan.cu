// Fused sequential-commit scheduling scan for Hopper (sm_90a): the base
// plan, the scalar / hostPort / GPU-share blocks, the open-local storage
// block, the inter-pod affinity / topology-spread block, and the
// scenario batch.
//
// Replaces the TPU kernel of the JAX package's ops/pallas_scan.py
// (_make_kernel -> kernel -> step, launched by run_scan_pallas, with its
// resident and streamed term layouts) and its scenario batch
// (run_scan_pallas_batch). Base plan: NodeResourcesFit on
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
//          from the node's state and charges it (pins included);
//   kStore open-local: each LVM volume in declaration order goes to the
//          VG with the least free space that fits (lowest VG on ties);
//          SSD/HDD volumes, ascending, take free devices first-fit in
//          device order (ascending capacity); the score is ScoreLVM +
//          ScoreDevice in f64 (take/cap means x 10, truncated), min-max
//          normalised; the owner thread of the placed node recomputes
//          the takes from the node's state and commits them;
//   kTerms inter-pod (anti-)affinity filter and score, required
//          affinity groups, hard topology spread (skew against the
//          minimum over candidate nodes, a block reduction before the
//          filter) and the soft spread score (distinct eligible domains
//          of the final feasible set, log-weighted f64 sum in slot
//          order, min-max over the eligible nodes). Counts live in
//          VALUE space: one ragged row of counts per term row (offsets
//          t_off), read as count[off[r] + topo[r, n]] and committed as
//          one add per row by all threads, then a barrier.
// kStore and kTerms are instantiated with kScal, kGpu and kPorts on:
// there those blocks run as runtime branches (zero scalar kinds, zero
// port words, no GPU rows), so the base instantiations keep their code.
// Semantics follow the JAX package's XLA scan (ops/scan.py): int64 state
// and class tables in true units over the unpadded node axis, f64 with
// round-to-nearest intrinsics (--fmad=false), with no cap on scalar
// kinds, devices, port words, VGs, volumes, term rows, classes or spread
// constraints.
//
// kBatch runs one independent scenario per block (blockIdx.x): each
// block reads the shared plan and its own active/pinned/valid rows and
// keeps its own state rows, term counts and scratch, so S capacity
// probes run in one launch at about the wall time of one (one scan
// occupies one SM).
//
// What bounds it on an H100: the scan is a serial chain of P pod steps.
// Every step depends on the previous step's commit, so the steps cannot
// overlap, and each step is block-wide reductions (__syncthreads
// barriers) around passes over the node axis. Per step the block reads
// the six int64 state rows, four allocatable rows, the feasible byte
// row, the node mask and four int64 class rows: about 110 bytes per
// node, 1.1 MB at 10,000 nodes, which one SM pulls from L2 (it does not
// fit in that SM's L1). The arithmetic, about 50 integer and f64
// operations per node, is small beside that. The storage block adds its
// VG and device rows and about 10 operations per VG a volume and 8 per
// device a node; the term block adds the class's term rows (a topology
// value and four counts each) and one barrier per hard-spread slot, per
// non-hostname soft slot, for the soft min-max and after the commit.
//
// What the design does about it: one block of 1024 threads runs the
// whole pod loop inside the kernel, so a step costs no launch and no
// host round trip. Thread t owns nodes t, t+1024, ...: it is the only
// thread that reads or writes those nodes' state, so the per-node
// commit needs no barrier and the state stays in device memory
// (L2-resident). Pass 1 computes feasibility, the feasibility-independent
// scores and the min/max the normalisations need; pass 2 adds the
// normalised scores and reduces (score, -index) to the first maximum.
// Each reduction is warp shuffles, one shared-memory exchange and one
// barrier; consecutive reductions use separate shared buffers so that
// no extra barrier is needed between them. Pinned and inactive pods
// skip both passes.

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
__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) v = add_w(v, __shfl_xor_sync(0xffffffffu, v, o));
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
// tables of the [5, U, T] term class array
enum { kTMatch = 0, kTAnti, kTComb, kTPAnti, kTPAff };
// rows of the [S, 3, N] per-node scratch of the storage and term blocks
enum { kAuxStore = 0, kAuxIpa, kAuxSoft };

struct Weights {
  int64_t least, balanced, simon, nodeaff, tainttol, spread, ipa, openlocal;
};

// open-local storage rows (kStore); per-scenario arrays are [S, ...]
struct StoreArgs {
  const int64_t* vg_cap;   // [V, N] (invalid slots 0)
  const int64_t* ssd_cap;  // [Ds, N] ascending per node
  const int64_t* hdd_cap;  // [Dh, N]
  const uint8_t* has;      // [N] node has the storage annotation
  const int64_t* lvm;      // [U, Lv] volume sizes, 0 = no volume
  const int64_t* ssd;      // [U, Sv] ascending
  const int64_t* hdd;      // [U, Hv] ascending
  const uint8_t* wants;    // [U]
  int64_t* vg_used;        // [S, V, N]
  uint8_t* ssd_used;       // [S, Ds, N]
  uint8_t* hdd_used;       // [S, Dh, N]
  int64_t* vg_take;        // [S, V, N] scratch: one pod's takes
  int64_t v_n, ds_n, dh_n, lv_n, sv_n, hv_n;
};

// inter-pod affinity / topology-spread rows (kTerms); value-space state
// is [S, ...], the stamps and the hard-spread minima are scratch
struct TermArgs {
  const int32_t* topo;       // [T, N] value id, -1 = key missing
  const int64_t* t_off;      // [T + 1] value-space row offsets
  const int64_t* t_cls;      // [5, U, T] match, carries (kT*)
  const int32_t* cls_rows;   // [U, R] relevant term rows, -1 pad
  const int32_t* g_topo;     // [A, N] values of the group rows
  const int64_t* g_off;      // [A + 1]
  const uint8_t* g_match;    // [U, A] class matches the row's group
  const int32_t* cls_grows;  // [U, Gm] group rows of the class's group
  const int32_t* cls_gid;    // [U] -1 = no required affinity
  const uint8_t* g_self;     // [U] class matches its own group
  const int32_t* h_row;      // [Ch] term row of a hard constraint
  const int64_t* h_skew;     // [Ch]
  const uint8_t* h_self;     // [Ch, U]
  const uint8_t* h_cand;     // [Ch, N] candidate nodes
  const int32_t* cls_hrows;  // [U, Hm]
  const int32_t* s_row;      // [Cs] term row of a soft constraint
  const uint8_t* s_host;     // [Cs] hostname key
  const int64_t* s_skew;     // [Cs]
  const uint8_t* s_q;        // [Cs, N] nodes whose pods count
  const int32_t* cls_srows;  // [U, Sm]
  const uint8_t* s_haskeys;  // [U, N] node has every soft key of the class
  const int64_t* s_off;      // [Cs + 1]
  const double* log_tab;     // [N + 1] log(k + 2)
  int64_t* t_state;          // [S, 4, VT] tgt, own anti, own aff (combined), own pref anti
  int64_t* g_state;          // [S, VA] group counts
  int64_t* gt_state;         // [S, A] group totals
  int64_t* s_state;          // [S, VS] soft counts
  int64_t* stamps;           // [S, VS] last pod step a value was eligible
  int64_t* hmin;             // [S, Hm] hard-spread minimum of the step
  int64_t t_n, r_n, a_n, gm_n, ch_n, hm_n, cs_n, sm_n, vt_n, va_n, vs_n;
};

// The arguments of one launch, gathered on the host from the wrapper's
// int64 vector. Plan arrays are shared by all scenarios; the
// per-scenario arrays are [S, ...] with S = gridDim.x for the batch
// kernel and S = 1 otherwise. Pointers of a block that is off are null.
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
  int64_t* aux;                 // [S, 3, N] scratch of kStore / kTerms
  int64_t n, u_n, p_n, k_n, g_n, w_n;
  Weights w;
  StoreArgs st;
  TermArgs tm;
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

// First fit of one media's volumes (ascending, 0 = no volume) onto the
// node's free devices in device order (scan.py _local_storage_eval
// fit_devices). Ascending sizes make each chosen device lie past the one
// chosen before, so one walk over the devices serves every volume.
// Adds size / capacity of each placed volume to `frac` in volume order
// and counts it; with kCommit marks the chosen devices used.
template <bool kCommit>
__device__ bool device_fit(const int64_t* cap, uint8_t* used, int64_t d_n,
                           const int64_t* sizes, int64_t k_n, int64_t n, int64_t i,
                           double& frac, int64_t& cnt) {
  bool ok = true;
  int64_t d = 0;
  for (int64_t j = 0; j < k_n; ++j) {
    const int64_t size = sizes[j];
    if (size <= 0) continue;
    int64_t e = d;
    while (e < d_n && (used[e * n + i] || cap[e * n + i] < size)) ++e;
    if (e >= d_n) {
      ok = false;  // and every larger volume after it
      continue;
    }
    const int64_t c = cap[e * n + i];
    frac = __dadd_rn(frac, __ddiv_rn(__ll2double_rn(size), __ll2double_rn(c > 1 ? c : 1)));
    ++cnt;
    if (kCommit) used[e * n + i] = 1;
    d = e + 1;
  }
  return ok;
}

// The open-local filter and raw score of class u at node i from the
// node's own state (scan.py _local_storage_eval): writes the LVM takes
// into the thread-owned scratch column, returns whether every volume
// fits, and with kCommit charges the takes and marks the devices.
template <bool kCommit>
__device__ bool store_eval(const StoreArgs& st, int64_t* vg_used, uint8_t* ssd_used,
                           uint8_t* hdd_used, int64_t* vg_take, int64_t u, int64_t n,
                           int64_t i, int64_t& raw) {
  const int64_t v_n = st.v_n;
  for (int64_t v = 0; v < v_n; ++v) vg_take[v * n + i] = 0;
  bool ok = st.has[i] != 0;
  const int64_t* lvm = st.lvm + u * st.lv_n;
  for (int64_t j = 0; j < st.lv_n; ++j) {
    const int64_t size = lvm[j];
    if (size <= 0) continue;
    // Binpack: the least free space that still fits, lowest VG on ties
    int64_t best = -1, key = kI64Max;
    for (int64_t v = 0; v < v_n; ++v) {
      const int64_t at = v * n + i;
      const int64_t free = sub_w(sub_w(st.vg_cap[at], vg_used[at]), vg_take[at]);
      if (free >= size && free < key) {
        key = free;
        best = v;
      }
    }
    if (best < 0) {
      ok = false;
    } else {
      vg_take[best * n + i] = add_w(vg_take[best * n + i], size);
    }
  }
  double ssd_frac = 0.0, hdd_frac = 0.0;
  int64_t dev_cnt = 0;
  const bool ssd_ok = device_fit<kCommit>(st.ssd_cap, ssd_used, st.ds_n, st.ssd + u * st.sv_n,
                                          st.sv_n, n, i, ssd_frac, dev_cnt);
  const bool hdd_ok = device_fit<kCommit>(st.hdd_cap, hdd_used, st.dh_n, st.hdd + u * st.hv_n,
                                          st.hv_n, n, i, hdd_frac, dev_cnt);
  raw = 0;
  if (st.has[i]) {
    // ScoreLVM: mean over touched VGs of take / capacity x 10; summed
    // in VG slot order as the XLA scan sums them
    double lvm_frac = 0.0;
    int64_t lvm_cnt = 0;
    for (int64_t v = 0; v < v_n; ++v) {
      const int64_t t = vg_take[v * n + i];
      if (t > 0) {
        const int64_t c = st.vg_cap[v * n + i];
        lvm_frac = __dadd_rn(lvm_frac, __ddiv_rn(__ll2double_rn(t), __ll2double_rn(c > 1 ? c : 1)));
        ++lvm_cnt;
      }
    }
    if (lvm_cnt > 0) {
      raw = __double2ll_rz(__dmul_rn(__ddiv_rn(lvm_frac, __ll2double_rn(lvm_cnt)), 10.0));
    }
    // ScoreDevice: mean over the placed device volumes
    if (dev_cnt > 0) {
      raw = add_w(raw, __double2ll_rz(__dmul_rn(
                           __ddiv_rn(__dadd_rn(ssd_frac, hdd_frac), __ll2double_rn(dev_cnt)),
                           10.0)));
    }
  }
  if (kCommit) {
    for (int64_t v = 0; v < v_n; ++v) {
      vg_used[v * n + i] = add_w(vg_used[v * n + i], vg_take[v * n + i]);
    }
  }
  return ok && ssd_ok && hdd_ok;
}

// The InterPodAffinity filter and raw score and the hard-spread filter
// of class u at node i (scan.py _terms_eval), from the value-space
// counts. `g_total` is the class's group total, `hmin` the step's
// hard-spread minima per class slot.
__device__ bool terms_eval(const TermArgs& tm, const int64_t* t_state, const int64_t* g_state,
                           const int64_t* hmin, int64_t u, int64_t u_n, int64_t n, int64_t i,
                           bool valid_i, int64_t g_total, int64_t& raw) {
  const int64_t vt = tm.vt_n;
  const int64_t* m_tab = tm.t_cls + (kTMatch * u_n + u) * tm.t_n;
  const int64_t* anti_tab = tm.t_cls + (kTAnti * u_n + u) * tm.t_n;
  const int64_t* panti_tab = tm.t_cls + (kTPAnti * u_n + u) * tm.t_n;
  const int64_t* paff_tab = tm.t_cls + (kTPAff * u_n + u) * tm.t_n;
  bool ok = true;
  int64_t acc = 0;
  const int32_t* rows = tm.cls_rows + u * tm.r_n;
  for (int64_t j = 0; j < tm.r_n; ++j) {
    const int64_t r = rows[j];
    if (r < 0) continue;
    const int32_t v = tm.topo[r * n + i];
    int64_t tgt = 0, own_anti = 0, own_aff = 0, own_panti = 0;
    if (v >= 0) {
      const int64_t at = tm.t_off[r] + v;
      tgt = t_state[at];
      own_anti = t_state[vt + at];
      own_aff = t_state[2 * vt + at];
      own_panti = t_state[3 * vt + at];
    }
    const int64_t m = m_tab[r];
    // satisfyExistingPodsAntiAffinity, satisfyPodAntiAffinity
    if (m != 0 && own_anti > 0) ok = false;
    if (anti_tab[r] > 0 && tgt > 0) ok = false;
    // processExistingPod: own_aff already carries the required-affinity
    // weight (combined state)
    acc = add_w(acc, add_w(mul_w(sub_w(paff_tab[r], panti_tab[r]), tgt),
                           mul_w(m, sub_w(own_aff, own_panti))));
  }
  raw = acc;
  // satisfyPodAffinity: every group row's key present and a matching pod
  // in each, unless no pod matches the group anywhere and the pod itself
  // does (bootstrap)
  if (tm.cls_gid[u] >= 0) {
    bool keys_ok = true, exist = true;
    const int32_t* grows = tm.cls_grows + u * tm.gm_n;
    for (int64_t j = 0; j < tm.gm_n; ++j) {
      const int64_t a = grows[j];
      if (a < 0) continue;
      const int32_t v = tm.g_topo[a * n + i];
      if (v < 0) {
        keys_ok = false;
        exist = false;
      } else if (g_state[tm.g_off[a] + v] <= 0) {
        exist = false;
      }
    }
    const bool boot = g_total == 0 && tm.g_self[u] != 0;
    if (!(keys_ok && (exist || boot))) ok = false;
  }
  // hard topology spread: skew against the minimum over candidates
  const int32_t* hrows = tm.cls_hrows + u * tm.hm_n;
  for (int64_t j = 0; j < tm.hm_n; ++j) {
    const int64_t h = hrows[j];
    if (h < 0) continue;
    const int64_t r = tm.h_row[h];
    const int32_t v = tm.topo[r * n + i];
    if (v < 0) {
      ok = false;
      continue;
    }
    const int64_t cnt = (tm.h_cand[h * n + i] && valid_i) ? t_state[tm.t_off[r] + v] : 0;
    const int64_t skew = sub_w(add_w(cnt, tm.h_self[h * u_n + u]), hmin[j]);
    if (skew > tm.h_skew[h]) ok = false;
  }
  return ok;
}

template <bool kBatch, bool kScal, bool kGpu, bool kPorts, bool kStore, bool kTerms>
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
    int64_t g_n, int64_t w_n, StoreArgs st, TermArgs tm, int64_t* __restrict__ aux) {
  constexpr bool kBig = kStore || kTerms;
  // pass-1 exchange: simon hi, simon lo, nodeaff max, taint max, any;
  // with kStore / kTerms also storage hi, storage lo, ipa max, ipa min
  // and the eligible-node count of the soft spread
  __shared__ int64_t red1[kBig ? 10 : 5][kWarps];
  // pass-2 exchange: (score, index)
  __shared__ int64_t red2[2][kWarps];
  // the other reductions of kStore / kTerms, two values each; they
  // alternate between the two buffers (a 1-entry stub elsewhere)
  __shared__ int64_t xbuf[kBig ? 2 : 1][kBig ? 2 : 1][kBig ? kWarps : 1];

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
    if constexpr (kBig) aux += sc * 3 * n;
    if constexpr (kStore) {
      st.vg_used += sc * st.v_n * n;
      st.ssd_used += sc * st.ds_n * n;
      st.hdd_used += sc * st.dh_n * n;
      st.vg_take += sc * st.v_n * n;
    }
    if constexpr (kTerms) {
      tm.t_state += sc * 4 * tm.vt_n;
      tm.g_state += sc * tm.va_n;
      tm.gt_state += sc * tm.a_n;
      tm.s_state += sc * tm.vs_n;
      tm.stamps += sc * tm.vs_n;
      tm.hmin += sc * tm.hm_n;
    }
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

  // each thread copies the initial state of the nodes it owns (the
  // storage and term state arrive initialised from the wrapper)
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
  int xb = 0;  // next xbuf buffer: every thread flips it at the same reductions

  for (int64_t p = 0; p < p_n; ++p) {
    const int64_t u = class_of_pod[p];
    const int64_t* req = cls_req + u * 6;
    const int64_t rc = req[kReqCpu], rm = req[kReqMem], re = req[kReqEph];
    const int64_t nzc = req[kReqNzCpu], nzm = req[kReqNzMem];
    const bool has_req = req[kReqHas] != 0;
    const int32_t pin = pinned[p];
    const int64_t* sreq = kScal ? scal_req + u * k_n : nullptr;
    const int64_t gm = (kGpu && g_n > 0) ? gpu_cls[u * 2] : 0;
    const int64_t gc = (kGpu && g_n > 0) ? gpu_cls[u * 2 + 1] : 0;
    const int32_t* want_w = kPorts ? port_cls + u * w_n : nullptr;
    const int32_t* confl_w = kPorts ? port_cls + (u_n + u) * w_n : nullptr;
    bool wants = false;
    if constexpr (kStore) wants = st.wants[u] != 0;
    // the class's soft-spread slots (kTerms): whether it has any
    bool has_soft = false;
    if constexpr (kTerms) {
      for (int64_t j = 0; j < tm.sm_n; ++j) has_soft = has_soft || tm.cls_srows[u * tm.sm_n + j] >= 0;
    }
    const bool soft_on = has_soft && w.spread != 0;

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

      // ---- pass 0 (kTerms): the hard-spread minimum of each of the
      // class's constraints over the scenario's candidate nodes
      int64_t g_total = 0;
      if constexpr (kTerms) {
        const int32_t* grows = tm.cls_grows + u * tm.gm_n;
        for (int64_t j = 0; j < tm.gm_n; ++j) {
          if (grows[j] >= 0) g_total = add_w(g_total, tm.gt_state[grows[j]]);
        }
        bool any_h = false;
        const int32_t* hrows = tm.cls_hrows + u * tm.hm_n;
        for (int64_t j = 0; j < tm.hm_n; ++j) {
          const int64_t h = hrows[j];
          if (h < 0) continue;
          any_h = true;
          const int64_t r = tm.h_row[h];
          const int32_t* vals = tm.topo + r * n;
          const uint8_t* cand = tm.h_cand + h * n;
          const int64_t* cnt = tm.t_state + tm.t_off[r];
          int64_t mn = kI64Max, anyc = 0;
          for (int64_t i = tid; i < n; i += kThreads) {
            if (cand[i] && valid[i]) {
              const int32_t v = vals[i];
              const int64_t c = v >= 0 ? cnt[v] : 0;
              mn = c < mn ? c : mn;
              anyc = 1;
            }
          }
          mn = warp_min(mn);
          anyc = warp_max(anyc);
          int64_t (*buf)[kWarps] = xbuf[xb];
          xb ^= 1;
          if (lane == 0) {
            buf[0][warp] = mn;
            buf[1][warp] = anyc;
          }
          __syncthreads();
          mn = warp_min(buf[0][lane]);
          anyc = warp_max(buf[1][lane]);
          if (tid == 0) tm.hmin[j] = anyc ? mn : 0;
        }
        if (any_h) __syncthreads();  // the minima are visible to every thread
      }

      // ---- pass 1: filter, state-only scores, normalisation bounds
      int64_t hi = kNegBig, lo = kI64Max, na_mx = 0, tt_mx = 0, any = 0;
      int64_t st_hi = kNegBig, st_lo = kI64Max, ipa_mx = 0, ipa_mn = 0, elig = 0;
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
        int64_t st_raw = 0, ipa_raw = 0;
        if constexpr (kStore) {
          if (ok && wants) {
            ok = store_eval<false>(st, st.vg_used, st.ssd_used, st.hdd_used, st.vg_take, u, n, i,
                                   st_raw);
          }
        }
        if constexpr (kTerms) {
          if (ok) {
            ok = terms_eval(tm, tm.t_state, tm.g_state, tm.hmin, u, u_n, n, i, valid[i] != 0,
                            g_total, ipa_raw);
          }
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
          if constexpr (kStore) {
            aux[kAuxStore * n + i] = st_raw;
            st_hi = st_raw > st_hi ? st_raw : st_hi;
            st_lo = st_raw < st_lo ? st_raw : st_lo;
          }
          if constexpr (kTerms) {
            aux[kAuxIpa * n + i] = ipa_raw;
            ipa_mx = ipa_raw > ipa_mx ? ipa_raw : ipa_mx;
            ipa_mn = ipa_raw < ipa_mn ? ipa_raw : ipa_mn;
            if (soft_on && tm.s_haskeys[u * n + i]) {
              // an eligible node: stamp its value of each non-hostname
              // soft constraint with this step
              ++elig;
              for (int64_t j = 0; j < tm.sm_n; ++j) {
                const int64_t c = tm.cls_srows[u * tm.sm_n + j];
                if (c < 0 || tm.s_host[c]) continue;
                const int32_t v = tm.topo[tm.s_row[c] * n + i];
                if (v >= 0) tm.stamps[tm.s_off[c] + v] = p;
              }
            }
          }
        }
        partial[i] = part;
      }
      hi = warp_max(hi);
      lo = warp_min(lo);
      na_mx = warp_max(na_mx);
      tt_mx = warp_max(tt_mx);
      any = warp_max(any);
      if constexpr (kBig) {
        st_hi = warp_max(st_hi);
        st_lo = warp_min(st_lo);
        ipa_mx = warp_max(ipa_mx);
        ipa_mn = warp_min(ipa_mn);
        elig = warp_sum(elig);
      }
      if (lane == 0) {
        red1[0][warp] = hi;
        red1[1][warp] = lo;
        red1[2][warp] = na_mx;
        red1[3][warp] = tt_mx;
        red1[4][warp] = any;
        if constexpr (kBig) {
          red1[5][warp] = st_hi;
          red1[6][warp] = st_lo;
          red1[7][warp] = ipa_mx;
          red1[8][warp] = ipa_mn;
          red1[9][warp] = elig;
        }
      }
      __syncthreads();
      // every warp finishes the reduction itself: no second barrier
      hi = warp_max(red1[0][lane]);
      lo = warp_min(red1[1][lane]);
      na_mx = warp_max(red1[2][lane]);
      tt_mx = warp_max(red1[3][lane]);
      any = warp_max(red1[4][lane]);
      if constexpr (kBig) {
        st_hi = warp_max(red1[5][lane]);
        st_lo = warp_min(red1[6][lane]);
        ipa_mx = warp_max(red1[7][lane]);
        ipa_mn = warp_min(red1[8][lane]);
        elig = warp_sum(red1[9][lane]);
      }

      // ---- soft spread (kTerms): per constraint, the distinct
      // eligible domains, then each eligible node's f64 score summed in
      // slot order, truncated, and its min / max over the eligible nodes
      int64_t s_mx = 0, s_mn = 0;
      const bool soft_scored = soft_on && elig > 0;
      if constexpr (kTerms) {
        if (soft_scored) {
          int64_t* acc = aux + kAuxSoft * n;
          for (int64_t i = tid; i < n; i += kThreads) acc[i] = __double_as_longlong(0.0);
          for (int64_t j = 0; j < tm.sm_n; ++j) {
            const int64_t c = tm.cls_srows[u * tm.sm_n + j];
            if (c < 0) continue;
            const bool host = tm.s_host[c] != 0;
            int64_t sz = elig;  // a hostname domain is a node
            if (!host) {
              int64_t cnt = 0;
              for (int64_t x = tm.s_off[c] + tid; x < tm.s_off[c + 1]; x += kThreads) {
                cnt += tm.stamps[x] == p;
              }
              cnt = warp_sum(cnt);
              int64_t (*buf)[kWarps] = xbuf[xb];
              xb ^= 1;
              if (lane == 0) buf[0][warp] = cnt;
              __syncthreads();
              sz = warp_sum(buf[0][lane]);
            }
            const double weight = tm.log_tab[sz];
            const double skew1 = __ll2double_rn(sub_w(tm.s_skew[c], 1));
            const int64_t r = tm.s_row[c];
            const int32_t* vals = tm.topo + r * n;
            const int64_t* counts = host ? tm.t_state + tm.t_off[r] : tm.s_state + tm.s_off[c];
            for (int64_t i = tid; i < n; i += kThreads) {
              if (partial[i] == kI64Min || !tm.s_haskeys[u * n + i]) continue;
              const int32_t v = vals[i];
              const int64_t k = v >= 0 ? counts[v] : 0;
              const double term = __dadd_rn(__dmul_rn(__ll2double_rn(k), weight), skew1);
              acc[i] = __double_as_longlong(__dadd_rn(__longlong_as_double(acc[i]), term));
            }
          }
          int64_t mx = kNegBig, mn = kI64Max;
          for (int64_t i = tid; i < n; i += kThreads) {
            if (partial[i] == kI64Min || !tm.s_haskeys[u * n + i]) continue;
            const int64_t raw = __double2ll_rz(__longlong_as_double(acc[i]));
            acc[i] = raw;
            mx = raw > mx ? raw : mx;
            mn = raw < mn ? raw : mn;
          }
          mx = warp_max(mx);
          mn = warp_min(mn);
          int64_t (*buf)[kWarps] = xbuf[xb];
          xb ^= 1;
          if (lane == 0) {
            buf[0][warp] = mx;
            buf[1][warp] = mn;
          }
          __syncthreads();
          s_mx = warp_max(buf[0][lane]);
          s_mn = warp_min(buf[1][lane]);
        }
      }

      // ---- pass 2: normalised scores, first maximum
      const int64_t rng = sub_w(hi, lo);
      const int64_t st_rng = sub_w(st_hi, st_lo);
      const int64_t ipa_diff = sub_w(ipa_mx, ipa_mn);
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
        if constexpr (kStore) {
          // Open-Local, min-max over the feasible nodes
          if (w.openlocal && wants && st_rng > 0) {
            const int64_t s =
                floordiv(mul_w(sub_w(aux[kAuxStore * n + i], st_lo), kMaxScore), st_rng);
            total = add_w(total, mul_w(s, w.openlocal));
          }
        }
        if constexpr (kTerms) {
          // InterPodAffinity NormalizeScore: bounds include 0, f64 divide
          if (w.ipa && ipa_diff > 0) {
            const int64_t s = __double2ll_rz(__ddiv_rn(
                __ll2double_rn(mul_w(kMaxScore, sub_w(aux[kAuxIpa * n + i], ipa_mn))),
                __ll2double_rn(ipa_diff)));
            total = add_w(total, mul_w(s, w.ipa));
          }
          // PodTopologySpread: eligible nodes by (max + min - raw) / max
          if (soft_scored) {
            int64_t s = 0;
            if (tm.s_haskeys[u * n + i]) {
              s = s_mx == 0 ? kMaxScore
                            : floordiv(mul_w(kMaxScore, sub_w(add_w(s_mx, s_mn),
                                                              aux[kAuxSoft * n + i])),
                                       s_mx > 1 ? s_mx : 1);
            }
            total = add_w(total, mul_w(s, w.spread));
          }
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
      if constexpr (kStore) {
        if (wants) {
          int64_t unused = 0;
          store_eval<true>(st, st.vg_used, st.ssd_used, st.hdd_used, st.vg_take, u, n, place,
                           unused);
        }
      }
    }
    if constexpr (kTerms) {
      if (place >= 0) {
        // AddPod: one add per term, group and soft row at the placed
        // node's value; rows are spread over the threads (distinct rows
        // never share a count), then a barrier before the next read
        const int64_t vt = tm.vt_n;
        for (int64_t r = tid; r < tm.t_n; r += kThreads) {
          const int32_t v = tm.topo[r * n + place];
          if (v < 0) continue;
          const int64_t at = tm.t_off[r] + v;
          for (int k = 0; k < 4; ++k) {
            tm.t_state[k * vt + at] =
                add_w(tm.t_state[k * vt + at], tm.t_cls[(k * u_n + u) * tm.t_n + r]);
          }
        }
        for (int64_t a = tid; a < tm.a_n; a += kThreads) {
          const int32_t v = tm.g_topo[a * n + place];
          if (v < 0 || !tm.g_match[u * tm.a_n + a]) continue;
          tm.g_state[tm.g_off[a] + v] = add_w(tm.g_state[tm.g_off[a] + v], 1);
          tm.gt_state[a] = add_w(tm.gt_state[a], 1);
        }
        for (int64_t c = tid; c < tm.cs_n; c += kThreads) {
          const int64_t r = tm.s_row[c];
          const int32_t v = tm.topo[r * n + place];
          if (v < 0 || !tm.s_q[c * n + place] || tm.t_cls[(kTMatch * u_n + u) * tm.t_n + r] == 0) {
            continue;
          }
          tm.s_state[tm.s_off[c] + v] = add_w(tm.s_state[tm.s_off[c] + v], 1);
        }
        __syncthreads();
      }
    }
    if (tid == 0) placements[p] = (int32_t)place;
  }
}

using LaunchFn = int (*)(const ScanArgs&, int64_t, cudaStream_t);

template <bool kBatch, bool kScal, bool kGpu, bool kPorts, bool kStore, bool kTerms>
int launch(const ScanArgs& a, int64_t scenarios, cudaStream_t stream) {
  fused_scan_kernel<kBatch, kScal, kGpu, kPorts, kStore, kTerms>
      <<<(unsigned)scenarios, kThreads, 0, stream>>>(
          a.alloc, a.init, a.feasible, a.cls_tab, a.cls_req, a.class_of_pod, a.active,
          a.pinned, a.valid, a.state, a.partial, a.placements, a.n, a.u_n, a.p_n, a.w,
          a.scal_alloc, a.scal_init, a.scal_req, a.scal_state, a.gpu_node, a.gpu_init,
          a.gpu_cls, a.gpu_state, a.port_init, a.port_cls, a.port_state, a.k_n, a.g_n, a.w_n,
          a.st, a.tm, a.aux);
  return static_cast<int>(cudaGetLastError());
}

#define FS_LAUNCH_ROW(B)                                                                      \
  launch<B, false, false, false, false, false>, launch<B, false, false, true, false, false>,  \
      launch<B, false, true, false, false, false>, launch<B, false, true, true, false, false>, \
      launch<B, true, false, false, false, false>, launch<B, true, false, true, false, false>, \
      launch<B, true, true, false, false, false>, launch<B, true, true, true, false, false>

// the base and B2 instantiations, indexed by batch << 3 | scal << 2 |
// gpu << 1 | ports
const LaunchFn kLaunch[16] = {FS_LAUNCH_ROW(false), FS_LAUNCH_ROW(true)};
// the storage / term instantiations (B2 blocks as runtime branches),
// indexed by [batch][store | terms << 1 minus 1]
const LaunchFn kLaunchBig[2][3] = {
    {launch<false, true, true, true, true, false>, launch<false, true, true, true, false, true>,
     launch<false, true, true, true, true, true>},
    {launch<true, true, true, true, true, false>, launch<true, true, true, true, false, true>,
     launch<true, true, true, true, true, true>},
};

// layout of the int64 argument vector the wrapper passes
enum {
  kArgAlloc = 0, kArgInit, kArgFeasible, kArgClsTab, kArgClsReq, kArgClassOfPod,
  kArgScalAlloc, kArgScalInit, kArgScalReq, kArgGpuNode, kArgGpuInit, kArgGpuCls,
  kArgPortInit, kArgPortCls, kArgActive, kArgPinned, kArgValid, kArgState,
  kArgScalState, kArgGpuState, kArgPortState, kArgPartial, kArgPlacements,
  kArgVgCap, kArgSsdCap, kArgHddCap, kArgHasStorage, kArgClsLvm, kArgClsSsd, kArgClsHdd,
  kArgClsWants, kArgVgState, kArgSsdState, kArgHddState, kArgVgTake,
  kArgTopo, kArgTOff, kArgTCls, kArgClsRows, kArgGTopo, kArgGOff, kArgGMatch, kArgClsGrows,
  kArgClsGid, kArgGSelf, kArgHRow, kArgHSkew, kArgHSelf, kArgHCand, kArgClsHrows,
  kArgSRow, kArgSHost, kArgSSkew, kArgSQ, kArgClsSrows, kArgSHaskeys, kArgSOff, kArgLogTab,
  kArgTState, kArgGState, kArgGtState, kArgSState, kArgStamps, kArgHmin, kArgAux,
  kArgN, kArgU, kArgP, kArgK, kArgG, kArgW,
  kArgV, kArgDs, kArgDh, kArgLv, kArgSv, kArgHv,
  kArgT, kArgR, kArgA, kArgGm, kArgCh, kArgHm, kArgCs, kArgSm, kArgVt, kArgVa, kArgVs,
  kArgWLeast, kArgWBalanced, kArgWSimon, kArgWNodeAff, kArgWTaintTol, kArgWSpread,
  kArgWIpa, kArgWOpenLocal,
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
// (pointers as integers; null for an absent block). flags bit 5 = terms,
// bit 4 = storage, bit 3 = one block per scenario, bit 2 = scalars, bit
// 1 = GPU-share, bit 0 = hostPorts. Returns the cudaError_t of the
// launch (0 = launched).
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
  a.aux = ptr<int64_t*>(v, kArgAux);
  a.n = v[kArgN];
  a.u_n = v[kArgU];
  a.p_n = v[kArgP];
  a.k_n = v[kArgK];
  a.g_n = v[kArgG];
  a.w_n = v[kArgW];
  a.w = Weights{v[kArgWLeast], v[kArgWBalanced], v[kArgWSimon], v[kArgWNodeAff],
                v[kArgWTaintTol], v[kArgWSpread], v[kArgWIpa], v[kArgWOpenLocal]};
  StoreArgs& st = a.st;
  st.vg_cap = ptr<const int64_t*>(v, kArgVgCap);
  st.ssd_cap = ptr<const int64_t*>(v, kArgSsdCap);
  st.hdd_cap = ptr<const int64_t*>(v, kArgHddCap);
  st.has = ptr<const uint8_t*>(v, kArgHasStorage);
  st.lvm = ptr<const int64_t*>(v, kArgClsLvm);
  st.ssd = ptr<const int64_t*>(v, kArgClsSsd);
  st.hdd = ptr<const int64_t*>(v, kArgClsHdd);
  st.wants = ptr<const uint8_t*>(v, kArgClsWants);
  st.vg_used = ptr<int64_t*>(v, kArgVgState);
  st.ssd_used = ptr<uint8_t*>(v, kArgSsdState);
  st.hdd_used = ptr<uint8_t*>(v, kArgHddState);
  st.vg_take = ptr<int64_t*>(v, kArgVgTake);
  st.v_n = v[kArgV];
  st.ds_n = v[kArgDs];
  st.dh_n = v[kArgDh];
  st.lv_n = v[kArgLv];
  st.sv_n = v[kArgSv];
  st.hv_n = v[kArgHv];
  TermArgs& tm = a.tm;
  tm.topo = ptr<const int32_t*>(v, kArgTopo);
  tm.t_off = ptr<const int64_t*>(v, kArgTOff);
  tm.t_cls = ptr<const int64_t*>(v, kArgTCls);
  tm.cls_rows = ptr<const int32_t*>(v, kArgClsRows);
  tm.g_topo = ptr<const int32_t*>(v, kArgGTopo);
  tm.g_off = ptr<const int64_t*>(v, kArgGOff);
  tm.g_match = ptr<const uint8_t*>(v, kArgGMatch);
  tm.cls_grows = ptr<const int32_t*>(v, kArgClsGrows);
  tm.cls_gid = ptr<const int32_t*>(v, kArgClsGid);
  tm.g_self = ptr<const uint8_t*>(v, kArgGSelf);
  tm.h_row = ptr<const int32_t*>(v, kArgHRow);
  tm.h_skew = ptr<const int64_t*>(v, kArgHSkew);
  tm.h_self = ptr<const uint8_t*>(v, kArgHSelf);
  tm.h_cand = ptr<const uint8_t*>(v, kArgHCand);
  tm.cls_hrows = ptr<const int32_t*>(v, kArgClsHrows);
  tm.s_row = ptr<const int32_t*>(v, kArgSRow);
  tm.s_host = ptr<const uint8_t*>(v, kArgSHost);
  tm.s_skew = ptr<const int64_t*>(v, kArgSSkew);
  tm.s_q = ptr<const uint8_t*>(v, kArgSQ);
  tm.cls_srows = ptr<const int32_t*>(v, kArgClsSrows);
  tm.s_haskeys = ptr<const uint8_t*>(v, kArgSHaskeys);
  tm.s_off = ptr<const int64_t*>(v, kArgSOff);
  tm.log_tab = ptr<const double*>(v, kArgLogTab);
  tm.t_state = ptr<int64_t*>(v, kArgTState);
  tm.g_state = ptr<int64_t*>(v, kArgGState);
  tm.gt_state = ptr<int64_t*>(v, kArgGtState);
  tm.s_state = ptr<int64_t*>(v, kArgSState);
  tm.stamps = ptr<int64_t*>(v, kArgStamps);
  tm.hmin = ptr<int64_t*>(v, kArgHmin);
  tm.t_n = v[kArgT];
  tm.r_n = v[kArgR];
  tm.a_n = v[kArgA];
  tm.gm_n = v[kArgGm];
  tm.ch_n = v[kArgCh];
  tm.hm_n = v[kArgHm];
  tm.cs_n = v[kArgCs];
  tm.sm_n = v[kArgSm];
  tm.vt_n = v[kArgVt];
  tm.va_n = v[kArgVa];
  tm.vs_n = v[kArgVs];
  const int64_t scenarios = v[kArgScenarios];
  const int64_t flags = v[kArgFlags];
  if (flags < 0 || flags > 63 || scenarios < 1 || (scenarios > 1 && !(flags & 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t big = (flags >> 4) & 3;
  if (big) return kLaunchBig[(flags >> 3) & 1][big - 1](a, scenarios, s);
  return kLaunch[flags & 15](a, scenarios, s);
}
