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
//          minimum over candidate nodes, a cluster-wide fold before the
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
// kBatch runs one independent scenario per thread-block cluster: each
// cluster reads the shared plan and its own active/pinned/valid rows and
// keeps its own state rows, term counts and scratch, so S capacity
// probes run in one launch at about the wall time of one.
//
// pins_first (a runtime argument of every instantiation, one value per
// launch) runs the pod loop twice over the same pod order: the first pass
// takes only the pods whose pin is >= 0 (each committed at its pin, or
// INACTIVE when the pin is masked out or the pod inactive), the second
// only the pods whose pin is < 0, through the full filter, score and
// commit cycle from the first pass's state. That is the outage model of
// the JAX package's _scenario_pinned_impl (parallel/sweep.py: two chained
// masked scans), in one launch. The pod step is unchanged; a pod skipped
// by a pass runs nothing in it, in every block alike, since the pass and
// the pin are the same in every block of the cluster. The per-node
// commit steps and the soft-spread stamps count steps across both passes
// (pass * P + p), so they only grow.
//
// What bounds it on an H100: the scan is a serial chain of P pod steps.
// Every step depends on the previous step's commit, so the steps cannot
// overlap, and each step is reductions over the whole node axis (the
// normalisation bounds, then the first maximum) around passes over it.
// Per step a scan reads the six int64 state rows, four allocatable rows,
// the feasible byte row, the node mask and four int64 class rows: about
// 110 bytes per node, 1.1 MB at 10,000 nodes. The arithmetic, about 50
// integer and f64 operations per node, is small beside that. On one SM a
// step pulls those bytes from L2 at one SM's rate: 34-38 us at 10,000
// nodes. The storage block adds its VG and device rows and about 10
// operations per VG a volume and 8 per device a node; the term block adds
// the class's term rows (a topology value and four counts each) and up to
// three more cross-block folds a step.
//
// What the design does about it. Every instantiation runs one scenario on
// one cluster of C blocks (C in 1, 2, 4, 8, 16, chosen by the wrapper; 16
// is Hopper's non-portable maximum): block r of the cluster owns the
// contiguous node slice [r*m, min((r+1)*m, N)), m = ceil(N / C), and at
// kernel start copies its slice's allocatable rows, state rows, node mask,
// B2 rows and storage rows (capacities, usage, the takes and the three
// scratch rows of kStore / kTerms) into dynamic shared memory, where they
// stay for the whole pod loop (the wrapper chooses that layout when the
// slice fits in 227 KB; else the same code reads and writes those rows in
// place in global memory, through the same pointers). So a step reads
// only the class's rows (feasible byte and four int64 rows, the term
// topology and candidate rows, 1/C of them per SM) from L2 and every
// other row from shared memory. Inside the slice thread t owns every
// blockDim-th node, so each thread visits its nodes in increasing order
// and the per-node commit needs no barrier: the owner thread of the
// placed node commits (its storage takes included), and the next step's
// pass 1 reads that node from the same thread. Pass 1 computes
// feasibility, the feasibility-independent scores and the min/max the
// normalisations need; pass 2 adds the normalised scores and reduces
// (score, -index) to the first maximum. Where the slice's shared memory
// has room, the base and B2 instantiations also cache per (class, node)
// pass 1's part (base + LeastAllocated + BalancedAllocation: a function
// of the node's state, which only a commit changes) and pass 2's
// normalised terms (a function of constant class rows and the class's
// bounds), so that a step recomputes the divisions only for nodes placed
// on since the class's last step, and for every node only when the
// class's bounds moved.
//
// The term counts. Every read of a count is at the reading node's own
// value. A row whose values are each held by one node (a hostname key;
// the wrapper's node_owned) is node-owned: its counts stay in the
// scenario's value space, read only by the block owning the node that
// holds a value and committed only by that block. Every other row (zone,
// region, rack) is shared: each block keeps a replica of its counts, and
// of the group totals, in shared memory when they fit (else in its own
// global rows), and every block applies every commit's add to its own
// replica. The adds are the same in every block, since every block
// derives the same placement from the same folds, so the replicas stay
// equal without any block writing another's memory; block 0's goes back
// to the value space at the end.
//
// The cross-block folds. Each reduction is warp shuffles, one
// shared-memory exchange and one __syncthreads; then thread q < C of each
// block r stores the block's values into row r of block q's exchange (a
// remote store through distributed shared memory), one cluster barrier
// (barrier.cluster, in hardware, release / acquire) makes every row
// visible, and every warp of every block folds the C rows of its own copy.
// Every fold is an int64 max, min, sum, the `any` flag or the (score,
// -index) argmax, so its result does not depend on the order it is folded
// in, and every block derives the same placement. A step has these
// exchanges, in this order: (0) kTerms, the hard-spread (min, any) of
// each of the class's slots, kRound slots an exchange, into each block's
// own minima; (1) pass 1's bounds, with kStore / kTerms also the storage
// and IPA bounds and the eligible-node count of the soft spread; (2)
// kTerms, when the soft spread scores, the distinct eligible domains of
// each non-hostname soft slot, kRound slots an exchange: every block
// stamps the step into its own stamp row at each eligible node's value,
// block r counts the values of its share (every C-th) that some block
// stamped, read from L2 past the barrier of (1), and the counts are
// summed; (3) the soft min-max; (4) pass 2's argmax. Whether (0), (2) and
// (3) run depends only on the class and on (1)'s folded eligible count,
// so every block runs the same barriers; a class without terms or
// storage pays (1) and (4) only (kStore / kTerms run (1) through the
// exchange even on one block, so that its barrier separates the reads of
// the block exchange from its next use).
//
// Why no buffer is written while a block may still read it. Each kind of
// exchange has its own buffer, and a block reads it after that kind's
// barrier and before it arrives at the next barrier of the step's
// sequence; another block writes the same buffer again only at the same
// kind's next exchange, which it reaches only past that next barrier, so
// only after every block arrived there. The rounds of (0) and of (2)
// follow each other with no other barrier between, so they alternate
// between two buffers: round k + 2 is written only past round k + 1's
// barrier. Pinned and inactive pods skip every exchange in every block
// alike. A final cluster barrier keeps every block resident until the
// others' last stores into it have landed, and one after the replicas'
// first copy keeps block 0's final copy from overtaking another block's
// read of the value space. With C = 1 the same code runs on one block, a
// cluster barrier being a block barrier. pins_first keeps all of this:
// whether a pod runs in a pass depends only on the launch's flag and the
// scenario's pin row, which every block of the cluster reads alike, so
// every block skips or runs the same steps and meets the same barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;  // rows of a block exchange: a warp each, up to 1024 threads
// threads a block: the launch bound of every instantiation, so that a
// thread may keep up to 128 registers (at 1024 threads it gets 64 and
// spills), and the block size when the slice's rows stay in global
// memory; a slice resident in shared memory runs on fewer (the fastest of
// 128-512 at 10,000 nodes on 16 blocks on an H100; with rows in global
// memory 512 were the fastest, their loads overlapping across more warps)
constexpr int kClusterThreads = 512;
constexpr int kResidentThreads = 384;
constexpr int kMaxCluster = 16;  // Hopper's non-portable maximum
// hard-spread or soft-spread slots of a class folded across the cluster in
// one exchange; a class with more takes one exchange per kRound slots
constexpr int kRound = 4;
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
// The same, exact, without the card's int64 division (a software
// sequence of some hundred cycles) where the quotient is small: a float
// estimate of a / b is within 4e-7 of it relatively (two roundings of the
// operands and __fdividef's two ulp), so below 2^20 it is off by less
// than one, and one int64 correction of the remainder fixes its floor.
// Operands past 2^61 (where q * b could overflow) and larger quotients
// take floordiv.
__device__ __forceinline__ int64_t floordiv_fast(int64_t a, int64_t b) {
  constexpr int64_t kLim = 1LL << 61;
  const float qf = floorf(__fdividef(__ll2float_rn(a), __ll2float_rn(b)));
  if (a > -kLim && a < kLim && b < kLim && fabsf(qf) < 1048576.0f) {
    int64_t q = static_cast<int64_t>(qf);
    const int64_t r = a - q * b;
    if (r < 0) {
      --q;
    } else if (r >= b) {
      ++q;
    }
    return q;
  }
  return floordiv(a, b);
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

// A block's view of the storage rows of its node slice: rows of stride
// `ls` indexed by the local node index, in shared memory when the slice
// is resident, else the scenario's global rows offset by the slice start
struct StoreView {
  const int64_t* vg_cap;
  const int64_t* ssd_cap;
  const int64_t* hdd_cap;
  const uint8_t* has;
  int64_t* vg_used;
  uint8_t* ssd_used;
  uint8_t* hdd_used;
  int64_t* vg_take;
  int64_t ls;
};

// inter-pod affinity / topology-spread rows (kTerms); value-space state
// is [S, ...], the stamps and the replicas are scratch. A row is
// node-owned when no value of it is held by two nodes (hostname keys): its
// counts stay in the scenario's value space, where only the block that
// owns the node holding a value reads or commits it. Every other row
// (zone, region) is shared: each block keeps a replica of its counts
// (t_rep / g_rep / s_rep give the row's offset in the replica, -1 for a
// node-owned row) and applies every commit to it.
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
  int64_t* stamps;           // [S, C, VS] last pod step a block saw a value eligible
  const int64_t* t_rep;      // [T] replica offset of a shared term row, -1 = node-owned
  const int64_t* g_rep;      // [A]
  const int64_t* s_rep;      // [Cs]
  // [S, C, RW] the blocks' replicas in global memory when they do not stay
  // in shared memory: term counts [4, VR], group counts [VGR], group
  // totals [A], soft counts [VSR]
  int64_t* rep;
  int64_t t_n, r_n, a_n, gm_n, ch_n, hm_n, cs_n, sm_n, vt_n, va_n, vs_n, vr_n, vgr_n, vsr_n;
};

// int64 entries of one block's replica
__host__ __device__ __forceinline__ int64_t replica_len(const TermArgs& tm) {
  return 4 * tm.vr_n + tm.vgr_n + tm.a_n + tm.vsr_n;
}
// the counts of term row r's field k (value-indexed), in the block's
// replica or the scenario's value space
__device__ __forceinline__ int64_t* t_counts(const TermArgs& tm, int64_t* rep, int k, int64_t r) {
  const int64_t o = tm.t_rep[r];
  return o >= 0 ? rep + k * tm.vr_n + o : tm.t_state + k * tm.vt_n + tm.t_off[r];
}
__device__ __forceinline__ int64_t* g_counts(const TermArgs& tm, int64_t* rep, int64_t a) {
  const int64_t o = tm.g_rep[a];
  return o >= 0 ? rep + 4 * tm.vr_n + o : tm.g_state + tm.g_off[a];
}
__device__ __forceinline__ int64_t* g_totals(const TermArgs& tm, int64_t* rep) {
  return rep + 4 * tm.vr_n + tm.vgr_n;
}
__device__ __forceinline__ int64_t* s_counts(const TermArgs& tm, int64_t* rep, int64_t c) {
  const int64_t o = tm.s_rep[c];
  return o >= 0 ? rep + 4 * tm.vr_n + tm.vgr_n + tm.a_n + o : tm.s_state + tm.s_off[c];
}

// The arguments of one launch, gathered on the host from the wrapper's
// int64 vector. Plan arrays are shared by all scenarios; the
// per-scenario arrays are [S, ...] with S = gridDim.x / C for the batch
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
  int64_t pins_first;           // 1: the pinned pods' pass, then the free pods'
  Weights w;
  StoreArgs st;
  TermArgs tm;
};

// open-gpu-share filter at one node (scan.py _gpu_allocate's `found`,
// gated by the node's total GPU memory); `used` rows have stride ls
__device__ __forceinline__ bool gpu_fits(const int64_t* used, int64_t ls, int64_t i,
                                         int64_t g_n, int64_t per_dev, int64_t cnt,
                                         int64_t total, int64_t gm, int64_t gc) {
  if (total < gm) return false;
  if (gc == 1) {
    for (int64_t g = 0; g < g_n && g < cnt; ++g) {
      if (sub_w(per_dev, used[g * ls + i]) >= gm) return true;
    }
    return false;
  }
  // several GPUs: the capacities avail // gm summed in device order
  const int64_t gm1 = gm > 1 ? gm : 1;
  int64_t sum = 0;
  if (sum >= gc) return true;
  for (int64_t g = 0; g < g_n && g < cnt; ++g) {
    const int64_t cap = floordiv(sub_w(per_dev, used[g * ls + i]), gm1);
    if (cap > 0) sum = add_w(sum, cap);
    if (sum >= gc) return true;
  }
  return false;
}

// charge the device choice at the placed node (scan.py commit:
// gpu_used += take * gpu_mem on that node only)
__device__ __forceinline__ void gpu_commit(int64_t* used, int64_t ls, int64_t i,
                                           int64_t g_n, int64_t per_dev, int64_t cnt,
                                           int64_t gm, int64_t gc) {
  if (gc == 1) {
    // tightest fit: strict < keeps the first device on ties
    int64_t best = -1, key = kI64Max;
    for (int64_t g = 0; g < g_n && g < cnt; ++g) {
      const int64_t avail = sub_w(per_dev, used[g * ls + i]);
      if (avail >= gm && avail < key) {
        key = avail;
        best = g;
      }
    }
    if (best >= 0) used[best * ls + i] = add_w(used[best * ls + i], gm);
    return;
  }
  // two-pointer greedy: take clip(gc - prefix, 0, cap) on each device
  const int64_t gm1 = gm > 1 ? gm : 1;
  int64_t prefix = 0;
  for (int64_t g = 0; g < g_n && g < cnt; ++g) {
    int64_t cap = floordiv(sub_w(per_dev, used[g * ls + i]), gm1);
    cap = cap > 0 ? cap : 0;
    int64_t take = sub_w(gc, prefix);
    take = take > 0 ? take : 0;
    take = take < cap ? take : cap;
    used[g * ls + i] = add_w(used[g * ls + i], mul_w(take, gm));
    prefix = add_w(prefix, cap);
  }
}

// First fit of one media's volumes (ascending, 0 = no volume) onto the
// node's free devices in device order (scan.py _local_storage_eval
// fit_devices). Ascending sizes make each chosen device lie past the one
// chosen before, so one walk over the devices serves every volume.
// Adds size / capacity of each placed volume to `frac` in volume order
// and counts it; with kCommit marks the chosen devices used. Device rows
// have stride ls.
template <bool kCommit>
__device__ bool device_fit(const int64_t* cap, uint8_t* used, int64_t d_n,
                           const int64_t* sizes, int64_t k_n, int64_t ls, int64_t i,
                           double& frac, int64_t& cnt) {
  bool ok = true;
  int64_t d = 0;
  for (int64_t j = 0; j < k_n; ++j) {
    const int64_t size = sizes[j];
    if (size <= 0) continue;
    int64_t e = d;
    while (e < d_n && (used[e * ls + i] || cap[e * ls + i] < size)) ++e;
    if (e >= d_n) {
      ok = false;  // and every larger volume after it
      continue;
    }
    const int64_t c = cap[e * ls + i];
    frac = __dadd_rn(frac, __ddiv_rn(__ll2double_rn(size), __ll2double_rn(c > 1 ? c : 1)));
    ++cnt;
    if (kCommit) used[e * ls + i] = 1;
    d = e + 1;
  }
  return ok;
}

// The open-local filter and raw score of class u at the slice's node i
// from the node's own state (scan.py _local_storage_eval): writes the LVM
// takes into the thread-owned scratch column, returns whether every
// volume fits, and with kCommit charges the takes and marks the devices.
template <bool kCommit>
__device__ bool store_eval(const StoreArgs& st, const StoreView& sv, int64_t u, int64_t i,
                           int64_t& raw) {
  const int64_t v_n = st.v_n;
  const int64_t ls = sv.ls;
  for (int64_t v = 0; v < v_n; ++v) sv.vg_take[v * ls + i] = 0;
  bool ok = sv.has[i] != 0;
  const int64_t* lvm = st.lvm + u * st.lv_n;
  for (int64_t j = 0; j < st.lv_n; ++j) {
    const int64_t size = lvm[j];
    if (size <= 0) continue;
    // Binpack: the least free space that still fits, lowest VG on ties
    int64_t best = -1, key = kI64Max;
    for (int64_t v = 0; v < v_n; ++v) {
      const int64_t at = v * ls + i;
      const int64_t free = sub_w(sub_w(sv.vg_cap[at], sv.vg_used[at]), sv.vg_take[at]);
      if (free >= size && free < key) {
        key = free;
        best = v;
      }
    }
    if (best < 0) {
      ok = false;
    } else {
      sv.vg_take[best * ls + i] = add_w(sv.vg_take[best * ls + i], size);
    }
  }
  double ssd_frac = 0.0, hdd_frac = 0.0;
  int64_t dev_cnt = 0;
  const bool ssd_ok = device_fit<kCommit>(sv.ssd_cap, sv.ssd_used, st.ds_n, st.ssd + u * st.sv_n,
                                          st.sv_n, ls, i, ssd_frac, dev_cnt);
  const bool hdd_ok = device_fit<kCommit>(sv.hdd_cap, sv.hdd_used, st.dh_n, st.hdd + u * st.hv_n,
                                          st.hv_n, ls, i, hdd_frac, dev_cnt);
  raw = 0;
  if (sv.has[i]) {
    // ScoreLVM: mean over touched VGs of take / capacity x 10; summed
    // in VG slot order as the XLA scan sums them
    double lvm_frac = 0.0;
    int64_t lvm_cnt = 0;
    for (int64_t v = 0; v < v_n; ++v) {
      const int64_t t = sv.vg_take[v * ls + i];
      if (t > 0) {
        const int64_t c = sv.vg_cap[v * ls + i];
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
      sv.vg_used[v * ls + i] = add_w(sv.vg_used[v * ls + i], sv.vg_take[v * ls + i]);
    }
  }
  return ok && ssd_ok && hdd_ok;
}

// The InterPodAffinity filter and raw score and the hard-spread filter
// of class u at node gi (a global node index), from the counts at the
// node's own values (t_counts / g_counts). `g_total` is the class's group
// total, `hmin` the step's hard-spread minima per class slot.
__device__ bool terms_eval(const TermArgs& tm, int64_t* rep, const int64_t* hmin, int64_t u,
                           int64_t u_n, int64_t n, int64_t gi, bool valid_i, int64_t g_total,
                           int64_t& raw) {
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
    const int32_t v = tm.topo[r * n + gi];
    int64_t tgt = 0, own_anti = 0, own_aff = 0, own_panti = 0;
    if (v >= 0) {
      tgt = t_counts(tm, rep, 0, r)[v];
      own_anti = t_counts(tm, rep, 1, r)[v];
      own_aff = t_counts(tm, rep, 2, r)[v];
      own_panti = t_counts(tm, rep, 3, r)[v];
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
      const int32_t v = tm.g_topo[a * n + gi];
      if (v < 0) {
        keys_ok = false;
        exist = false;
      } else if (g_counts(tm, rep, a)[v] <= 0) {
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
    const int32_t v = tm.topo[r * n + gi];
    if (v < 0) {
      ok = false;
      continue;
    }
    const int64_t cnt = (tm.h_cand[h * n + gi] && valid_i) ? t_counts(tm, rep, 0, r)[v] : 0;
    const int64_t skew = sub_w(add_w(cnt, tm.h_self[h * u_n + u]), hmin[j]);
    if (skew > tm.h_skew[h]) ok = false;
  }
  return ok;
}

// one cluster barrier: release / acquire across the cluster's blocks, or
// the block barrier when the cluster is one block
__device__ __forceinline__ void cluster_barrier(const cg::cluster_group& cluster, int64_t csize) {
  if (csize > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

// where block `q` of the cluster holds `p` (a shared-memory address of this
// block): distributed shared memory, or p itself in a one-block cluster
template <typename T>
__device__ __forceinline__ T* at_rank(const cg::cluster_group& cluster, int64_t csize, T* p,
                                      int64_t q) {
  return csize > 1 ? cluster.map_shared_rank(p, static_cast<unsigned>(q)) : p;
}

template <bool kBatch, bool kScal, bool kGpu, bool kPorts, bool kStore, bool kTerms>
__global__ void __launch_bounds__(kClusterThreads, 1) fused_scan_kernel(
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
    int64_t g_n, int64_t w_n, StoreArgs st, TermArgs tm, int64_t* __restrict__ aux,
    int64_t resident, int64_t pins_first) {
  constexpr bool kBig = kStore || kTerms;
  // pass-1 exchange: simon hi, simon lo, nodeaff max, taint max, any;
  // with kStore / kTerms also storage hi, storage lo, ipa max, ipa min
  // and the eligible-node count of the soft spread. kTerms also folds a
  // round of hard-spread (min, any) pairs and of soft-spread domain counts
  // through it
  __shared__ int64_t red1[kBig ? 10 : 5][kWarps];
  // pass-2 exchange: (score, index); kTerms folds the soft min-max here
  __shared__ int64_t red2[2][kWarps];
  // the cluster's exchanges: block r's values land in row r of every
  // block's copy. Pass 1 (five values, ten with kStore / kTerms) and pass 2
  // (score, index); kTerms: a round of hard-spread (min, any) pairs and of
  // soft-spread domain counts, each in two alternating buffers, and the
  // soft min-max (1-entry stubs elsewhere)
  __shared__ int64_t xch1[kMaxCluster][kBig ? 10 : 5];
  __shared__ int64_t xch2[kMaxCluster][2];
  __shared__ int64_t xhard[kTerms ? 2 : 1][kTerms ? kMaxCluster : 1][kTerms ? kRound : 1]
                          [kTerms ? 2 : 1];
  __shared__ int64_t xdom[kTerms ? 2 : 1][kTerms ? kMaxCluster : 1][kTerms ? kRound : 1];
  __shared__ int64_t xsoft[kTerms ? kMaxCluster : 1][kTerms ? 2 : 1];
  // kTerms: the hard-spread minima [Hm] and the replica when it stays in
  // shared memory; then the slice's per-node rows when `resident`
  extern __shared__ __align__(16) unsigned char dyn_smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthr = (int)blockDim.x;
  const int nwarps = nthr >> 5;
  // this block's place in its cluster
  const cg::cluster_group cluster = cg::this_cluster();
  const int64_t csize = cluster.num_blocks();
  const int64_t crank = cluster.block_rank();
  if (kBatch) {
    // this cluster's scenario: its masks, pins, state rows and scratch
    const int64_t sc = blockIdx.x / csize;
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
    }
  }
  // kTerms: the scenario's stamp rows (one a block, blocks in rank order)
  // and this block's own
  int64_t* my_stamps = nullptr;
  if constexpr (kTerms) {
    tm.stamps += (blockIdx.x - crank) * tm.vs_n;
    my_stamps = tm.stamps + crank * tm.vs_n;
  }

  // The block's node slice [lo, lo + cnt) and the rows it works on,
  // indexed by the local node index i (node lo + i). Resident: rows of
  // stride m in shared memory; else the global rows (stride n) offset by
  // lo.
  const int64_t m = (n + csize - 1) / csize;
  const int64_t lo = crank * m < n ? crank * m : n;
  const int64_t cnt = (lo + m < n ? lo + m : n) - lo;
  const bool in_smem = (resident & 1) != 0;
  const bool cached = !kBig && in_smem && (resident & 2) != 0;
  const bool rep_smem = kTerms && (resident & 4) != 0;
  const bool gpu_on = kGpu && gpu_node != nullptr;
  const int64_t ls = in_smem ? m : n;  // row stride
  // the per-(class, node) caches when `cached`: pass 1's part (base +
  // LeastAllocated + BalancedAllocation) and pass 2's normalised terms
  // [U, m]; each node's last commit step [m]; per class the step of its
  // last pass 1 and the bounds its cached pass-2 terms were taken with
  // (lo, hi, nodeaff max, taint max, set) [U, 6]
  int64_t* c_part = nullptr;
  int64_t* c_norm = nullptr;
  int64_t* c_node = nullptr;
  int64_t* c_cls = nullptr;
  const int64_t* __restrict__ l_alloc = alloc + lo;
  int64_t* __restrict__ l_state = state + lo;
  int64_t* __restrict__ l_part = partial + lo;
  const uint8_t* __restrict__ l_valid = valid + lo;
  const int64_t* __restrict__ l_scal_alloc = kScal ? scal_alloc + lo : nullptr;
  int64_t* __restrict__ l_scal = kScal ? scal_used + lo : nullptr;
  const int64_t* __restrict__ l_gpu_node = gpu_on ? gpu_node + lo : nullptr;
  int64_t* __restrict__ l_gpu = gpu_on ? gpu_used + lo : nullptr;
  int32_t* __restrict__ l_ports = kPorts ? port_used + lo : nullptr;
  // kStore / kTerms: the per-node scratch rows (store raw score, IPA raw
  // score, soft accumulator) and the storage rows of the slice
  int64_t* l_aux = kBig ? aux + lo : nullptr;
  StoreView sv = {};
  if constexpr (kStore) {
    sv = StoreView{st.vg_cap + lo,   st.ssd_cap + lo,  st.hdd_cap + lo,
                   st.has + lo,      st.vg_used + lo,  st.ssd_used + lo,
                   st.hdd_used + lo, st.vg_take + lo,  n};
  }
  int64_t* q = reinterpret_cast<int64_t*>(dyn_smem);
  // kTerms: the step's hard-spread minima and this block's replica
  int64_t* hmin = nullptr;
  int64_t* rep = nullptr;
  if constexpr (kTerms) {
    hmin = q;
    q += (tm.hm_n + 1) & ~int64_t(1);
    if (rep_smem) {
      rep = q;
      q += (replica_len(tm) + 1) & ~int64_t(1);
    } else {
      rep = tm.rep + blockIdx.x * replica_len(tm);
    }
  }
  if (in_smem) {
    // 8-byte rows first, then the 4-byte port words, then the byte
    // rows: every row stays aligned (the wrapper's slice_bytes)
    int64_t* a_s = q;
    q += 4 * m;
    l_state = q;
    q += 6 * m;
    l_part = q;
    q += m;
    int64_t* sa_s = q;
    if (kScal) {
      q += k_n * m;
      l_scal = q;
      q += k_n * m;
    }
    int64_t* gn_s = q;
    if (gpu_on) {
      q += 3 * m;
      l_gpu = q;
      q += g_n * m;
    }
    if (cached) {
      c_part = q;
      q += u_n * m;
      c_norm = q;
      q += u_n * m;
      c_node = q;
      q += m;
      c_cls = q;
      q += 6 * u_n;
    }
    if constexpr (kBig) {
      l_aux = q;
      q += 3 * m;
    }
    // kStore: capacities, VG usage and takes, then (below) the byte rows
    int64_t* vgc_s = q;
    int64_t* vgu_s = q;
    int64_t* vgt_s = q;
    int64_t* ssdc_s = q;
    int64_t* hddc_s = q;
    if constexpr (kStore) {
      vgu_s = vgc_s + st.v_n * m;
      vgt_s = vgu_s + st.v_n * m;
      ssdc_s = vgt_s + st.v_n * m;
      hddc_s = ssdc_s + st.ds_n * m;
      q = hddc_s + st.dh_n * m;
    }
    int32_t* q4 = reinterpret_cast<int32_t*>(q);
    if (kPorts) {
      l_ports = q4;
      q4 += w_n * m;
    }
    uint8_t* v_s = reinterpret_cast<uint8_t*>(q4);
    uint8_t* has_s = v_s + m;
    uint8_t* ssdu_s = has_s + m;
    uint8_t* hddu_s = ssdu_s + (kStore ? st.ds_n * m : 0);
    // the slice's rows, each node by its owner thread: the read-only
    // rows, and the storage state as the wrapper initialised it
    for (int64_t i = tid; i < cnt; i += nthr) {
      for (int k = 0; k < 4; ++k) a_s[k * m + i] = alloc[k * n + lo + i];
      v_s[i] = valid[lo + i];
      if (kScal) {
        for (int64_t k = 0; k < k_n; ++k) sa_s[k * m + i] = scal_alloc[k * n + lo + i];
      }
      if (gpu_on) {
        for (int k = 0; k < 3; ++k) gn_s[k * m + i] = gpu_node[k * n + lo + i];
      }
      if (cached) c_node[i] = -1;
      if constexpr (kStore) {
        for (int64_t v = 0; v < st.v_n; ++v) {
          vgc_s[v * m + i] = st.vg_cap[v * n + lo + i];
          vgu_s[v * m + i] = st.vg_used[v * n + lo + i];
        }
        for (int64_t d = 0; d < st.ds_n; ++d) {
          ssdc_s[d * m + i] = st.ssd_cap[d * n + lo + i];
          ssdu_s[d * m + i] = st.ssd_used[d * n + lo + i];
        }
        for (int64_t d = 0; d < st.dh_n; ++d) {
          hddc_s[d * m + i] = st.hdd_cap[d * n + lo + i];
          hddu_s[d * m + i] = st.hdd_used[d * n + lo + i];
        }
        has_s[i] = st.has[lo + i];
      }
    }
    if (cached) {
      // no class has a pass 1 yet (step -1) nor cached pass-2 terms
      for (int64_t k = tid; k < 6 * u_n; k += nthr) c_cls[k] = k % 6 == 0 ? -1 : 0;
      __syncthreads();
    }
    l_alloc = a_s;
    l_valid = v_s;
    l_scal_alloc = sa_s;
    l_gpu_node = gn_s;
    if constexpr (kStore) {
      sv = StoreView{vgc_s, ssdc_s, hddc_s, has_s, vgu_s, ssdu_s, hddu_s, vgt_s, m};
    }
  }
  const int64_t* alloc_c = l_alloc + kAllocCpu * ls;
  const int64_t* alloc_m = l_alloc + kAllocMem * ls;
  const int64_t* alloc_e = l_alloc + kAllocEph * ls;
  const int64_t* alloc_p = l_alloc + kAllocPods * ls;
  int64_t* used_c = l_state + kUsedCpu * ls;
  int64_t* used_m = l_state + kUsedMem * ls;
  int64_t* used_e = l_state + kUsedEph * ls;
  int64_t* nz_c = l_state + kNzCpu * ls;
  int64_t* nz_m = l_state + kNzMem * ls;
  int64_t* pods = l_state + kPodCnt * ls;

  // each thread copies the initial state of the nodes it owns (the
  // storage and term state arrive initialised from the wrapper)
  for (int64_t i = tid; i < cnt; i += nthr) {
    for (int k = 0; k < 6; ++k) l_state[k * ls + i] = init[k * n + lo + i];
    if (kScal) {
      for (int64_t k = 0; k < k_n; ++k) l_scal[k * ls + i] = scal_init[k * n + lo + i];
    }
    if (gpu_on) {
      for (int64_t g = 0; g < g_n; ++g) l_gpu[g * ls + i] = gpu_init[g * n + lo + i];
    }
    if (kPorts) {
      for (int64_t v = 0; v < w_n; ++v) l_ports[v * ls + i] = port_init[v * n + lo + i];
    }
  }
  if constexpr (kTerms) {
    // this block's replica of the shared rows' counts, from the scenario's
    // value space; the barrier also keeps block 0's final copy back from
    // overtaking another block's read here
    for (int64_t r = 0; r < tm.t_n; ++r) {
      const int64_t o = tm.t_rep[r];
      if (o < 0) continue;
      const int64_t nv = tm.t_off[r + 1] - tm.t_off[r];
      for (int64_t x = tid; x < 4 * nv; x += nthr) {
        const int64_t k = x / nv, v = x - k * nv;
        rep[k * tm.vr_n + o + v] = tm.t_state[k * tm.vt_n + tm.t_off[r] + v];
      }
    }
    for (int64_t a = 0; a < tm.a_n; ++a) {
      const int64_t o = tm.g_rep[a];
      if (o >= 0) {
        for (int64_t v = tid; v < tm.g_off[a + 1] - tm.g_off[a]; v += nthr) {
          rep[4 * tm.vr_n + o + v] = tm.g_state[tm.g_off[a] + v];
        }
      }
      if (tid == 0) g_totals(tm, rep)[a] = tm.gt_state[a];
    }
    for (int64_t c = 0; c < tm.cs_n; ++c) {
      const int64_t o = tm.s_rep[c];
      if (o < 0) continue;
      int64_t* dst = rep + 4 * tm.vr_n + tm.vgr_n + tm.a_n + o;
      for (int64_t v = tid; v < tm.s_off[c + 1] - tm.s_off[c]; v += nthr) {
        dst[v] = tm.s_state[tm.s_off[c] + v];
      }
    }
    cluster_barrier(cluster, csize);
  }

  // one pass over the pods, or two with pins_first: the pinned pods, then
  // the free ones; `step` numbers the pod steps across both
  const int passes = pins_first ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
  for (int64_t p = 0; p < p_n; ++p) {
    if (pins_first && (pinned[p] >= 0) != (pass == 0)) continue;
    const int64_t step = pass * p_n + p;
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
      // a pin overrides feasibility; outside the node mask it is
      // INACTIVE (every block reads the scenario's global mask alike)
      place = valid[pin] ? pin : kInactive;
    } else {
      const uint8_t* feas_row = feasible + u * n + lo;
      const int64_t* simon_row = cls_tab + (kTabSimon * u_n + u) * n + lo;
      const int64_t* na_row = cls_tab + (kTabNodeAff * u_n + u) * n + lo;
      const int64_t* tt_row = cls_tab + (kTabTaint * u_n + u) * n + lo;
      const int64_t* base_row = cls_tab + (kTabBase * u_n + u) * n + lo;

      // ---- pass 0 (kTerms): the hard-spread minimum of each of the
      // class's constraints over the scenario's candidate nodes, folded
      // kRound slots an exchange: each slot's (min, any) over the slice,
      // the block's fold in warp w of the round's slot w, its store into
      // every block's exchange, one cluster barrier, then each block folds
      // the C rows into its own minima
      int64_t g_total = 0;
      if constexpr (kTerms) {
        const int32_t* grows = tm.cls_grows + u * tm.gm_n;
        const int64_t* gt = g_totals(tm, rep);
        for (int64_t j = 0; j < tm.gm_n; ++j) {
          if (grows[j] >= 0) g_total = add_w(g_total, gt[grows[j]]);
        }
        const int32_t* hrows = tm.cls_hrows + u * tm.hm_n;
        int rounds = 0;  // exchanges so far: the buffer alternates
        for (int64_t j0 = 0; j0 < tm.hm_n; j0 += kRound) {
          bool any_slot = false;  // a class-wide fact: every block agrees
          for (int x = 0; x < kRound && j0 + x < tm.hm_n; ++x) any_slot |= hrows[j0 + x] >= 0;
          if (!any_slot) continue;
          const int par = rounds & 1;
          for (int x = 0; x < kRound; ++x) {
            const int64_t h = j0 + x < tm.hm_n ? hrows[j0 + x] : -1;
            int64_t mn = kI64Max, anyc = 0;
            if (h >= 0) {
              const int64_t r = tm.h_row[h];
              const int32_t* vals = tm.topo + r * n + lo;
              const uint8_t* cand = tm.h_cand + h * n + lo;
              const int64_t* cnt_row = t_counts(tm, rep, 0, r);
              for (int64_t i = tid; i < cnt; i += nthr) {
                if (cand[i] && l_valid[i]) {
                  const int32_t v = vals[i];
                  const int64_t c = v >= 0 ? cnt_row[v] : 0;
                  mn = c < mn ? c : mn;
                  anyc = 1;
                }
              }
            }
            mn = warp_min(mn);
            anyc = warp_max(anyc);
            if (lane == 0) {
              red1[2 * x][warp] = mn;
              red1[2 * x + 1][warp] = anyc;
            }
          }
          __syncthreads();
          if (warp < kRound) {
            const bool wl = lane < nwarps;
            const int64_t mn = warp_min(wl ? red1[2 * warp][lane] : kI64Max);
            const int64_t anyc = warp_max(wl ? red1[2 * warp + 1][lane] : 0);
            if (lane < csize) {
              int64_t* x = at_rank(cluster, csize, &xhard[par][crank][warp][0], lane);
              x[0] = mn;
              x[1] = anyc;
            }
          }
          cluster_barrier(cluster, csize);
          if (tid < kRound && j0 + tid < tm.hm_n) {
            int64_t mn = kI64Max, anyc = 0;
            for (int64_t r = 0; r < csize; ++r) {
              const int64_t c = xhard[par][r][tid][0];
              mn = c < mn ? c : mn;
              anyc |= xhard[par][r][tid][1];
            }
            hmin[j0 + tid] = anyc ? mn : 0;
          }
          ++rounds;
        }
        if (rounds > 0) __syncthreads();  // the minima are visible to every thread
      }

      // ---- pass 1: filter, state-only scores, normalisation bounds.
      // Cached, a node's part is recomputed only when the node took a
      // pod at or after the class's last pass 1 (its inputs are the
      // node's state, which only a commit changes, and constant rows)
      int64_t* c_cls_u = cached ? c_cls + u * 6 : nullptr;
      int64_t* c_part_u = cached ? c_part + u * m : nullptr;
      const int64_t part_step = cached ? c_cls_u[0] : 0;
      int64_t hi = kNegBig, lo_s = kI64Max, na_mx = 0, tt_mx = 0, any = 0;
      int64_t st_hi = kNegBig, st_lo = kI64Max, ipa_mx = 0, ipa_mn = 0, elig = 0;
      for (int64_t i = tid; i < cnt; i += nthr) {
        // the node's rows are read up front, so that their loads overlap
        // instead of following the filter's branches one by one
        const bool feas_i = feas_row[i] != 0, valid_i = l_valid[i] != 0;
        const int64_t pods_i = pods[i], cap_i = alloc_p[i];
        const int64_t ac = alloc_c[i], am = alloc_m[i], ae = alloc_e[i];
        const int64_t uc = used_c[i], um = used_m[i], ue = used_e[i];
        const int64_t nzc_i = nz_c[i], nzm_i = nz_m[i];
        const int64_t base_i = base_row[i];
        const int64_t simon_i = w.simon ? simon_row[i] : 0;
        const int64_t na_i = w.nodeaff ? na_row[i] : 0;
        const int64_t tt_i = w.tainttol ? tt_row[i] : 0;
        bool ok = feas_i && valid_i && add_w(pods_i, 1) <= cap_i;
        if (ok && has_req) {
          ok = ac >= add_w(rc, uc) && am >= add_w(rm, um) && ae >= add_w(re, ue);
          if (kScal) {
            for (int64_t k = 0; ok && k < k_n; ++k) {
              ok = l_scal_alloc[k * ls + i] >= add_w(sreq[k], l_scal[k * ls + i]);
            }
          }
        }
        if (kPorts) {
          for (int64_t v = 0; ok && v < w_n; ++v) ok = (l_ports[v * ls + i] & confl_w[v]) == 0;
        }
        if (kGpu && ok && gm > 0) {
          ok = gpu_fits(l_gpu, ls, i, g_n, l_gpu_node[kGpuPerDev * ls + i],
                        l_gpu_node[kGpuCount * ls + i], l_gpu_node[kGpuTotal * ls + i], gm, gc);
        }
        int64_t st_raw = 0, ipa_raw = 0;
        if constexpr (kStore) {
          if (ok && wants) ok = store_eval<false>(st, sv, u, i, st_raw);
        }
        if constexpr (kTerms) {
          if (ok) ok = terms_eval(tm, rep, hmin, u, u_n, n, lo + i, valid_i, g_total, ipa_raw);
        }
        int64_t part = kI64Min;  // marks an infeasible node for pass 2
        if (ok && cached && c_node[i] < part_step) {
          any = 1;
          part = c_part_u[i];
        } else if (ok) {
          any = 1;
          part = base_i;
          const int64_t totc = add_w(nzc_i, nzc), totm = add_w(nzm_i, nzm);
          if (w.least) {
            int64_t lc = (ac > 0 && totc <= ac)
                             ? floordiv_fast(mul_w(sub_w(ac, totc), kMaxScore), ac > 1 ? ac : 1)
                             : 0;
            int64_t lm = (am > 0 && totm <= am)
                             ? floordiv_fast(mul_w(sub_w(am, totm), kMaxScore), am > 1 ? am : 1)
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
          if (cached) c_part_u[i] = part;
        }
        if (ok) {
          if (w.simon) {
            hi = simon_i > hi ? simon_i : hi;
            lo_s = simon_i < lo_s ? simon_i : lo_s;
          }
          if (w.nodeaff) na_mx = na_i > na_mx ? na_i : na_mx;
          if (w.tainttol) tt_mx = tt_i > tt_mx ? tt_i : tt_mx;
          if constexpr (kStore) {
            l_aux[kAuxStore * ls + i] = st_raw;
            st_hi = st_raw > st_hi ? st_raw : st_hi;
            st_lo = st_raw < st_lo ? st_raw : st_lo;
          }
          if constexpr (kTerms) {
            l_aux[kAuxIpa * ls + i] = ipa_raw;
            ipa_mx = ipa_raw > ipa_mx ? ipa_raw : ipa_mx;
            ipa_mn = ipa_raw < ipa_mn ? ipa_raw : ipa_mn;
            if (soft_on && tm.s_haskeys[u * n + lo + i]) {
              // an eligible node: stamp its value of each non-hostname
              // soft constraint with this step, in this block's stamps
              ++elig;
              for (int64_t j = 0; j < tm.sm_n; ++j) {
                const int64_t c = tm.cls_srows[u * tm.sm_n + j];
                if (c < 0 || tm.s_host[c]) continue;
                const int32_t v = tm.topo[tm.s_row[c] * n + lo + i];
                if (v >= 0) my_stamps[tm.s_off[c] + v] = step;
              }
            }
          }
        }
        l_part[i] = part;
      }
      hi = warp_max(hi);
      lo_s = warp_min(lo_s);
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
        red1[1][warp] = lo_s;
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
      // every thread has read part_step: this pass is the class's last
      if (cached && tid == 0) c_cls_u[0] = step;
      // every warp finishes the reduction itself: no second barrier
      // (lanes past the block's warps hold each fold's identity); in a
      // cluster, and always for kStore / kTerms, only warp 0 needs the
      // block's values, to store them into the exchange
      const bool wl = lane < nwarps;
      const bool xch = kBig || csize > 1;
      if (!xch || warp == 0) {
        hi = warp_max(wl ? red1[0][lane] : kNegBig);
        lo_s = warp_min(wl ? red1[1][lane] : kI64Max);
        na_mx = warp_max(wl ? red1[2][lane] : 0);
        tt_mx = warp_max(wl ? red1[3][lane] : 0);
        any = warp_max(wl ? red1[4][lane] : 0);
        if constexpr (kBig) {
          st_hi = warp_max(wl ? red1[5][lane] : kNegBig);
          st_lo = warp_min(wl ? red1[6][lane] : kI64Max);
          ipa_mx = warp_max(wl ? red1[7][lane] : 0);
          ipa_mn = warp_min(wl ? red1[8][lane] : 0);
          elig = warp_sum(wl ? red1[9][lane] : 0);
        }
      }
      if (xch) {
        // the cluster's fold: thread q < C stores this block's values
        // into row `crank` of block q's exchange (distributed shared
        // memory), one cluster barrier (release / acquire) makes them
        // visible, then every warp folds the C rows of its own copy. For
        // kStore / kTerms a one-block cluster takes the same path, so
        // that the barrier separates the reads of red1 from its next use
        if (tid < csize) {
          int64_t* x = at_rank(cluster, csize, &xch1[crank][0], tid);
          x[0] = hi;
          x[1] = lo_s;
          x[2] = na_mx;
          x[3] = tt_mx;
          x[4] = any;
          if constexpr (kBig) {
            x[5] = st_hi;
            x[6] = st_lo;
            x[7] = ipa_mx;
            x[8] = ipa_mn;
            x[9] = elig;
          }
        }
        cluster_barrier(cluster, csize);
        const bool cl = lane < csize;
        hi = warp_max(cl ? xch1[lane][0] : kNegBig);
        lo_s = warp_min(cl ? xch1[lane][1] : kI64Max);
        na_mx = warp_max(cl ? xch1[lane][2] : 0);
        tt_mx = warp_max(cl ? xch1[lane][3] : 0);
        any = warp_max(cl ? xch1[lane][4] : 0);
        if constexpr (kBig) {
          st_hi = warp_max(cl ? xch1[lane][5] : kNegBig);
          st_lo = warp_min(cl ? xch1[lane][6] : kI64Max);
          ipa_mx = warp_max(cl ? xch1[lane][7] : 0);
          ipa_mn = warp_min(cl ? xch1[lane][8] : 0);
          elig = warp_sum(cl ? xch1[lane][9] : 0);
        }
      }

      // ---- soft spread (kTerms): per constraint, the distinct eligible
      // domains of the cluster, then each eligible node's f64 score summed
      // in slot order, truncated, and its min / max over the eligible
      // nodes. `elig` is the cluster's count here, so every block takes
      // the same branch. A non-hostname slot's domains are the values
      // stamped with this step in any block's stamps: block r counts the
      // values of its share (every C-th from the r-th) that some block
      // stamped, and the cluster sums the counts, kRound slots an exchange
      int64_t s_mx = 0, s_mn = 0;
      const bool soft_scored = soft_on && elig > 0;
      if constexpr (kTerms) {
        if (soft_scored) {
          int64_t* acc = l_aux + kAuxSoft * ls;
          for (int64_t i = tid; i < cnt; i += nthr) acc[i] = __double_as_longlong(0.0);
          const int32_t* srows = tm.cls_srows + u * tm.sm_n;
          int rounds = 0;  // exchanges so far: the buffer alternates
          for (int64_t j0 = 0; j0 < tm.sm_n; j0 += kRound) {
            bool any_dom = false;  // a class-wide fact: every block agrees
            for (int x = 0; x < kRound && j0 + x < tm.sm_n; ++x) {
              const int64_t c = srows[j0 + x];
              any_dom |= c >= 0 && !tm.s_host[c];
            }
            const int par = rounds & 1;
            if (any_dom) {
              for (int x = 0; x < kRound; ++x) {
                const int64_t c = j0 + x < tm.sm_n ? srows[j0 + x] : -1;
                int64_t cnt_v = 0;
                if (c >= 0 && !tm.s_host[c]) {
                  const int64_t end = tm.s_off[c + 1];
                  for (int64_t v = tm.s_off[c] + crank + tid * csize; v < end; v += nthr * csize) {
                    bool seen = false;
                    // another block's stamps: past its cluster barrier,
                    // read from L2, never a stale L1 line
                    for (int64_t r = 0; r < csize && !seen; ++r) {
                      seen = __ldcg(reinterpret_cast<const long long*>(
                                 tm.stamps + r * tm.vs_n + v)) == step;
                    }
                    cnt_v += seen;
                  }
                }
                cnt_v = warp_sum(cnt_v);
                if (lane == 0) red1[x][warp] = cnt_v;
              }
              __syncthreads();
              if (warp < kRound) {
                const int64_t sum = warp_sum(lane < nwarps ? red1[warp][lane] : 0);
                if (lane < csize) *at_rank(cluster, csize, &xdom[par][crank][warp], lane) = sum;
              }
              cluster_barrier(cluster, csize);
              ++rounds;
            }
            for (int x = 0; x < kRound && j0 + x < tm.sm_n; ++x) {
              const int64_t c = srows[j0 + x];
              if (c < 0) continue;
              const bool host = tm.s_host[c] != 0;
              int64_t sz = elig;  // a hostname domain is a node
              if (!host) {
                sz = 0;
                for (int64_t r = 0; r < csize; ++r) sz += xdom[par][r][x];
              }
              const double weight = tm.log_tab[sz];
              const double skew1 = __ll2double_rn(sub_w(tm.s_skew[c], 1));
              const int64_t r = tm.s_row[c];
              const int32_t* vals = tm.topo + r * n + lo;
              const int64_t* counts = host ? t_counts(tm, rep, 0, r) : s_counts(tm, rep, c);
              for (int64_t i = tid; i < cnt; i += nthr) {
                if (l_part[i] == kI64Min || !tm.s_haskeys[u * n + lo + i]) continue;
                const int32_t v = vals[i];
                const int64_t k = v >= 0 ? counts[v] : 0;
                const double term = __dadd_rn(__dmul_rn(__ll2double_rn(k), weight), skew1);
                acc[i] = __double_as_longlong(__dadd_rn(__longlong_as_double(acc[i]), term));
              }
            }
          }
          int64_t mx = kNegBig, mn = kI64Max;
          for (int64_t i = tid; i < cnt; i += nthr) {
            if (l_part[i] == kI64Min || !tm.s_haskeys[u * n + lo + i]) continue;
            const int64_t raw = __double2ll_rz(__longlong_as_double(acc[i]));
            acc[i] = raw;
            mx = raw > mx ? raw : mx;
            mn = raw < mn ? raw : mn;
          }
          // the block's min-max in red2 (free until pass 2, which the
          // cluster barrier below separates), then the cluster's
          mx = warp_max(mx);
          mn = warp_min(mn);
          if (lane == 0) {
            red2[0][warp] = mx;
            red2[1][warp] = mn;
          }
          __syncthreads();
          if (warp == 0) {
            mx = warp_max(lane < nwarps ? red2[0][lane] : kNegBig);
            mn = warp_min(lane < nwarps ? red2[1][lane] : kI64Max);
            if (lane < csize) {
              int64_t* x = at_rank(cluster, csize, &xsoft[crank][0], lane);
              x[0] = mx;
              x[1] = mn;
            }
          }
          cluster_barrier(cluster, csize);
          s_mx = kNegBig;
          s_mn = kI64Max;
          for (int64_t r = 0; r < csize; ++r) {
            s_mx = xsoft[r][0] > s_mx ? xsoft[r][0] : s_mx;
            s_mn = xsoft[r][1] < s_mn ? xsoft[r][1] : s_mn;
          }
        }
      }

      // ---- pass 2: normalised scores, first maximum. The simon,
      // nodeaff and taint terms depend only on constant class rows and
      // the bounds: cached, they are taken again only when the class's
      // bounds moved since its last pass 2, then for every node of the
      // slice (a sum of wrapping adds: the order does not change it)
      const int64_t rng = sub_w(hi, lo_s);
      const int64_t st_rng = sub_w(st_hi, st_lo);
      const int64_t ipa_diff = sub_w(ipa_mx, ipa_mn);
      const bool norm_hit = cached && c_cls_u[5] && c_cls_u[1] == lo_s && c_cls_u[2] == hi &&
                            c_cls_u[3] == na_mx && c_cls_u[4] == tt_mx;
      int64_t* c_norm_u = cached ? c_norm + u * m : nullptr;
      int64_t best_s = kI64Min, best_i = kI64Max;
      for (int64_t i = tid; i < cnt; i += nthr) {
        int64_t total = l_part[i];
        int64_t norm = 0;
        if (norm_hit) {
          if (total == kI64Min) continue;
          norm = c_norm_u[i];
        } else {
          const int64_t simon_i = w.simon ? simon_row[i] : 0;
          const int64_t na_i = w.nodeaff ? na_row[i] : 0;
          const int64_t tt_i = w.tainttol ? tt_row[i] : 0;
          if (total == kI64Min && !cached) continue;
          if (w.simon) {
            int64_t s = rng > 0 ? floordiv_fast(mul_w(sub_w(simon_i, lo_s), kMaxScore), rng) : 0;
            norm = add_w(norm, mul_w(s, w.simon));
          }
          if (w.nodeaff) {
            int64_t s = na_mx > 0 ? floordiv_fast(mul_w(kMaxScore, na_i), na_mx) : 0;
            norm = add_w(norm, mul_w(s, w.nodeaff));
          }
          if (w.tainttol) {
            int64_t s = tt_mx > 0 ? kMaxScore - floordiv_fast(mul_w(kMaxScore, tt_i), tt_mx)
                                  : kMaxScore;
            norm = add_w(norm, mul_w(s, w.tainttol));
          }
          if (cached) c_norm_u[i] = norm;
          if (total == kI64Min) continue;
        }
        total = add_w(total, norm);
        if constexpr (kStore) {
          // Open-Local, min-max over the feasible nodes
          if (w.openlocal && wants && st_rng > 0) {
            const int64_t s =
                floordiv_fast(mul_w(sub_w(l_aux[kAuxStore * ls + i], st_lo), kMaxScore), st_rng);
            total = add_w(total, mul_w(s, w.openlocal));
          }
        }
        if constexpr (kTerms) {
          // InterPodAffinity NormalizeScore: bounds include 0, f64 divide
          if (w.ipa && ipa_diff > 0) {
            const int64_t s = __double2ll_rz(__ddiv_rn(
                __ll2double_rn(mul_w(kMaxScore, sub_w(l_aux[kAuxIpa * ls + i], ipa_mn))),
                __ll2double_rn(ipa_diff)));
            total = add_w(total, mul_w(s, w.ipa));
          }
          // PodTopologySpread: eligible nodes by (max + min - raw) / max
          if (soft_scored) {
            int64_t s = 0;
            if (tm.s_haskeys[u * n + lo + i]) {
              s = s_mx == 0 ? kMaxScore
                            : floordiv_fast(mul_w(kMaxScore, sub_w(add_w(s_mx, s_mn),
                                                              l_aux[kAuxSoft * ls + i])),
                                       s_mx > 1 ? s_mx : 1);
            }
            total = add_w(total, mul_w(s, w.spread));
          }
        }
        // nodes are visited in increasing order: strict > keeps the first
        if (best_i == kI64Max || total > best_s) {
          best_s = total;
          best_i = lo + i;
        }
      }
      warp_argmax(best_s, best_i);
      if (lane == 0) {
        red2[0][warp] = best_s;
        red2[1][warp] = best_i;
      }
      __syncthreads();
      if (cached && !norm_hit && tid == 0) {
        // every thread has read the old bounds: record this pass's
        c_cls_u[1] = lo_s;
        c_cls_u[2] = hi;
        c_cls_u[3] = na_mx;
        c_cls_u[4] = tt_mx;
        c_cls_u[5] = 1;
      }
      if (csize == 1 || warp == 0) {
        best_s = wl ? red2[0][lane] : kI64Min;
        best_i = wl ? red2[1][lane] : kI64Max;
        warp_argmax(best_s, best_i);
      }
      if (csize > 1) {
        if (tid < csize) {
          int64_t* x = cluster.map_shared_rank(&xch2[crank][0], tid);
          x[0] = best_s;
          x[1] = best_i;
        }
        cluster.sync();
        const bool cl = lane < csize;
        best_s = cl ? xch2[lane][0] : kI64Min;
        best_i = cl ? xch2[lane][1] : kI64Max;
        warp_argmax(best_s, best_i);
      }
      place = any ? best_i : -1;
    }

    // the owner thread of the placed node commits; the next step's pass
    // 1 reads that node from the same thread, so no barrier is needed
    const int64_t j = place - lo;
    const bool mine = place >= 0 && j < cnt && j >= 0;  // this block owns the node
    if (mine && (j % nthr) == tid) {
      used_c[j] = add_w(used_c[j], rc);
      used_m[j] = add_w(used_m[j], rm);
      used_e[j] = add_w(used_e[j], re);
      nz_c[j] = add_w(nz_c[j], nzc);
      nz_m[j] = add_w(nz_m[j], nzm);
      pods[j] = add_w(pods[j], 1);
      if (cached) c_node[j] = step;
      if (kScal) {
        for (int64_t k = 0; k < k_n; ++k) l_scal[k * ls + j] = add_w(l_scal[k * ls + j], sreq[k]);
      }
      if (kPorts) {
        for (int64_t v = 0; v < w_n; ++v) l_ports[v * ls + j] |= want_w[v];
      }
      if (kGpu && gm > 0) {
        gpu_commit(l_gpu, ls, j, g_n, l_gpu_node[kGpuPerDev * ls + j],
                   l_gpu_node[kGpuCount * ls + j], gm, gc);
      }
      if constexpr (kStore) {
        if (wants) {
          int64_t unused = 0;
          store_eval<true>(st, sv, u, j, unused);
        }
      }
    }
    if constexpr (kTerms) {
      if (place >= 0) {
        // AddPod: one add per term, group and soft row at the placed
        // node's value; rows are spread over the threads (distinct rows
        // never share a count), then a barrier before the next read. A
        // shared row's add goes into every block's replica alike; a
        // node-owned row's only into the scenario's value space, by the
        // block that owns the node
        for (int64_t r = tid; r < tm.t_n; r += nthr) {
          const int32_t v = tm.topo[r * n + place];
          if (v < 0 || (tm.t_rep[r] < 0 && !mine)) continue;
          for (int k = 0; k < 4; ++k) {
            int64_t* row = t_counts(tm, rep, k, r);
            row[v] = add_w(row[v], tm.t_cls[(k * u_n + u) * tm.t_n + r]);
          }
        }
        int64_t* gt = g_totals(tm, rep);
        for (int64_t a = tid; a < tm.a_n; a += nthr) {
          const int32_t v = tm.g_topo[a * n + place];
          if (v < 0 || !tm.g_match[u * tm.a_n + a]) continue;
          gt[a] = add_w(gt[a], 1);
          if (tm.g_rep[a] < 0 && !mine) continue;
          int64_t* row = g_counts(tm, rep, a);
          row[v] = add_w(row[v], 1);
        }
        for (int64_t c = tid; c < tm.cs_n; c += nthr) {
          const int64_t r = tm.s_row[c];
          const int32_t v = tm.topo[r * n + place];
          if (v < 0 || !tm.s_q[c * n + place] || tm.t_cls[(kTMatch * u_n + u) * tm.t_n + r] == 0) {
            continue;
          }
          if (tm.s_rep[c] < 0 && !mine) continue;
          int64_t* row = s_counts(tm, rep, c);
          row[v] = add_w(row[v], 1);
        }
        __syncthreads();
      }
    }
    if (tid == 0 && crank == 0) placements[p] = (int32_t)place;
  }
  }

  if (in_smem) {
    // the final state of the slice back to the scenario's rows, each
    // node by its owner thread
    for (int64_t i = tid; i < cnt; i += nthr) {
      for (int k = 0; k < 6; ++k) state[k * n + lo + i] = l_state[k * m + i];
      if (kScal) {
        for (int64_t k = 0; k < k_n; ++k) scal_used[k * n + lo + i] = l_scal[k * m + i];
      }
      if (gpu_on) {
        for (int64_t g = 0; g < g_n; ++g) gpu_used[g * n + lo + i] = l_gpu[g * m + i];
      }
      if (kPorts) {
        for (int64_t v = 0; v < w_n; ++v) port_used[v * n + lo + i] = l_ports[v * m + i];
      }
      if constexpr (kStore) {
        for (int64_t v = 0; v < st.v_n; ++v) st.vg_used[v * n + lo + i] = sv.vg_used[v * m + i];
        for (int64_t d = 0; d < st.ds_n; ++d) st.ssd_used[d * n + lo + i] = sv.ssd_used[d * m + i];
        for (int64_t d = 0; d < st.dh_n; ++d) st.hdd_used[d * n + lo + i] = sv.hdd_used[d * m + i];
      }
    }
  }
  if constexpr (kTerms) {
    // the replicas agree: block 0's goes back to the scenario's value
    // space (the node-owned rows are there already)
    if (crank == 0) {
      for (int64_t r = 0; r < tm.t_n; ++r) {
        const int64_t o = tm.t_rep[r];
        if (o < 0) continue;
        const int64_t nv = tm.t_off[r + 1] - tm.t_off[r];
        for (int64_t x = tid; x < 4 * nv; x += nthr) {
          const int64_t k = x / nv, v = x - k * nv;
          tm.t_state[k * tm.vt_n + tm.t_off[r] + v] = rep[k * tm.vr_n + o + v];
        }
      }
      for (int64_t a = 0; a < tm.a_n; ++a) {
        const int64_t o = tm.g_rep[a];
        if (o >= 0) {
          for (int64_t v = tid; v < tm.g_off[a + 1] - tm.g_off[a]; v += nthr) {
            tm.g_state[tm.g_off[a] + v] = rep[4 * tm.vr_n + o + v];
          }
        }
        if (tid == 0) tm.gt_state[a] = g_totals(tm, rep)[a];
      }
      for (int64_t c = 0; c < tm.cs_n; ++c) {
        const int64_t o = tm.s_rep[c];
        if (o < 0) continue;
        const int64_t* src = rep + 4 * tm.vr_n + tm.vgr_n + tm.a_n + o;
        for (int64_t v = tid; v < tm.s_off[c + 1] - tm.s_off[c]; v += nthr) {
          tm.s_state[tm.s_off[c] + v] = src[v];
        }
      }
    }
  }
  // no block leaves while another may still store into its exchange
  if (csize > 1) cluster.sync();
}

// How one launch is shaped: S scenarios, each on a cluster of `cluster`
// blocks, with `smem` bytes of dynamic shared memory a block. `resident`
// bit 0: the slices' rows are resident there; bit 1: with the
// per-(class, node) caches (the base and B2 instantiations); bit 2: the
// term replicas too (kTerms). The threads a block follow from the layout.
struct Shape {
  int64_t scenarios, cluster, resident, smem;
};

// The dynamic shared memory a layout takes for slices of m nodes (the
// wrapper's launch_shape, slice_bytes and cache_bytes): kTerms' hard-spread
// minima and, with bit 2, its replica (each rounded up to 16 bytes); with
// bit 0 the slice: the 8-byte rows (four allocatable, six state, partial,
// the scalar kinds' allocatable and used, the three GPU node rows and the
// per-device used; kStore / kTerms the three scratch rows; kStore the VG
// capacities, usage and takes and the SSD and HDD capacities), the port
// words, then the byte rows (the node mask; kStore the storage flag and
// the SSD and HDD usage); with bit 1, two [U, m] rows, the node stamps and
// [U, 6].
template <bool kScal, bool kGpu, bool kPorts, bool kStore, bool kTerms>
int64_t dyn_bytes(const ScanArgs& a, int64_t m, int64_t resident) {
  int64_t b = 0;
  if (kTerms) {
    b += 8 * ((a.tm.hm_n + 1) & ~int64_t(1));
    if (resident & 4) b += 8 * ((replica_len(a.tm) + 1) & ~int64_t(1));
  }
  if (resident & 1) {
    int64_t rows8 = 4 + 6 + 1;
    int64_t rows1 = 1;
    if (kScal) rows8 += 2 * a.k_n;
    if (kGpu && a.gpu_node != nullptr) rows8 += 3 + a.g_n;
    if (kStore || kTerms) rows8 += 3;
    if (kStore) {
      rows8 += 3 * a.st.v_n + a.st.ds_n + a.st.dh_n;
      rows1 += 1 + a.st.ds_n + a.st.dh_n;
    }
    b += m * (8 * rows8 + (kPorts ? 4 * a.w_n : 0) + rows1);
    if (resident & 2) b += 8 * ((2 * a.u_n + 1) * m + 6 * a.u_n);
  }
  return b;
}

// What a call to one instantiation does: launch it, ask how many of its
// clusters of a shape the card holds at once, or ask its static shared
// memory.
enum class Ask { kLaunch, kMaxClusters, kStaticSmem };

// One instantiation: do `ask`, the answer into *out. Returns the first
// cudaError_t of the attribute calls, the query and the launch.
using RunFn = int (*)(const ScanArgs&, const Shape&, cudaStream_t, Ask, int64_t*);

template <bool kBatch, bool kScal, bool kGpu, bool kPorts, bool kStore, bool kTerms>
int run(const ScanArgs& a, const Shape& sh, cudaStream_t stream, Ask ask, int64_t* out) {
  constexpr bool kBig = kStore || kTerms;
  auto* kernel = fused_scan_kernel<kBatch, kScal, kGpu, kPorts, kStore, kTerms>;
  if (ask == Ask::kStaticSmem) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    *out = static_cast<int64_t>(fa.sharedSizeBytes);
    return static_cast<int>(err);
  }
  // the layouts each instantiation takes: the caches only beside a
  // resident slice of the base and B2 instantiations, the replicas only
  // with kTerms
  const int64_t layouts = !kBig ? 3 : (kTerms ? 5 : 1);
  const bool shape_ok =
      sh.scenarios >= 1 && (sh.scenarios == 1 || kBatch) && sh.cluster >= 1 &&
      sh.cluster <= kMaxCluster && (sh.cluster & (sh.cluster - 1)) == 0 && sh.smem >= 0 &&
      sh.scenarios * sh.cluster <= 0x7fffffff && sh.resident >= 0 &&
      (sh.resident & ~layouts) == 0 && sh.resident != 2 &&
      (ask != Ask::kLaunch ||
       sh.smem >= dyn_bytes<kScal, kGpu, kPorts, kStore, kTerms>(
                      a, (a.n + sh.cluster - 1) / sh.cluster, sh.resident));
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (sh.cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && sh.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sh.smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(sh.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(sh.scenarios * sh.cluster));
  cfg.blockDim = dim3((sh.resident & 1) ? kResidentThreads : kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(sh.smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (ask == Ask::kMaxClusters) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *out = clusters;
    return static_cast<int>(err);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a.alloc, a.init, a.feasible, a.cls_tab, a.cls_req,
                           a.class_of_pod, a.active, a.pinned, a.valid, a.state, a.partial,
                           a.placements, a.n, a.u_n, a.p_n, a.w, a.scal_alloc, a.scal_init,
                           a.scal_req, a.scal_state, a.gpu_node, a.gpu_init, a.gpu_cls,
                           a.gpu_state, a.port_init, a.port_cls, a.port_state, a.k_n, a.g_n,
                           a.w_n, a.st, a.tm, a.aux, sh.resident, a.pins_first);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

#define FS_RUN_ROW(B)                                                                   \
  run<B, false, false, false, false, false>, run<B, false, false, true, false, false>,  \
      run<B, false, true, false, false, false>, run<B, false, true, true, false, false>, \
      run<B, true, false, false, false, false>, run<B, true, false, true, false, false>, \
      run<B, true, true, false, false, false>, run<B, true, true, true, false, false>

// the base and B2 instantiations, indexed by batch << 3 | scal << 2 |
// gpu << 1 | ports
const RunFn kRun[16] = {FS_RUN_ROW(false), FS_RUN_ROW(true)};
// the storage / term instantiations (B2 blocks as runtime branches),
// indexed by [batch][store | terms << 1 minus 1]
const RunFn kRunBig[2][3] = {
    {run<false, true, true, true, true, false>, run<false, true, true, true, false, true>,
     run<false, true, true, true, true, true>},
    {run<true, true, true, true, true, false>, run<true, true, true, true, false, true>,
     run<true, true, true, true, true, true>},
};

RunFn run_of(int64_t flags) {
  if (flags < 0 || flags > 63) return nullptr;
  const int64_t big = (flags >> 4) & 3;
  return big ? kRunBig[(flags >> 3) & 1][big - 1] : kRun[flags & 15];
}

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
  kArgTRep, kArgGRep, kArgSRep,
  kArgTState, kArgGState, kArgGtState, kArgSState, kArgStamps, kArgRep, kArgAux,
  kArgN, kArgU, kArgP, kArgK, kArgG, kArgW,
  kArgV, kArgDs, kArgDh, kArgLv, kArgSv, kArgHv,
  kArgT, kArgR, kArgA, kArgGm, kArgCh, kArgHm, kArgCs, kArgSm, kArgVt, kArgVa, kArgVs,
  kArgVr, kArgVgr, kArgVsr,
  kArgWLeast, kArgWBalanced, kArgWSimon, kArgWNodeAff, kArgWTaintTol, kArgWSpread,
  kArgWIpa, kArgWOpenLocal,
  kArgScenarios, kArgFlags, kArgCluster, kArgResident, kArgSmem, kArgPinsFirst, kArgCount
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
// bit 4 = storage, bit 3 = one cluster per scenario, bit 2 = scalars,
// bit 1 = GPU-share, bit 0 = hostPorts; then the launch's Shape.
// Returns the first cudaError_t of the attribute calls and the launch
// (0 = launched).
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
  a.pins_first = v[kArgPinsFirst] != 0;
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
  tm.t_rep = ptr<const int64_t*>(v, kArgTRep);
  tm.g_rep = ptr<const int64_t*>(v, kArgGRep);
  tm.s_rep = ptr<const int64_t*>(v, kArgSRep);
  tm.rep = ptr<int64_t*>(v, kArgRep);
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
  tm.vr_n = v[kArgVr];
  tm.vgr_n = v[kArgVgr];
  tm.vsr_n = v[kArgVsr];
  const Shape sh{v[kArgScenarios], v[kArgCluster], v[kArgResident], v[kArgSmem]};
  const RunFn fn = run_of(v[kArgFlags]);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(a, sh, static_cast<cudaStream_t>(stream), Ask::kLaunch, nullptr);
}

// How many clusters of `cluster` blocks (with `smem` bytes of dynamic
// shared memory each) of the instantiation `flags` the current card holds
// at once, for a plan of n nodes, u classes, k scalar kinds, g GPUs and w
// port words, into *out. Returns the cudaError_t of the attribute calls
// and the occupancy query.
extern "C" int fused_scan_max_clusters(int64_t flags, int64_t n, int64_t u_n, int64_t k_n,
                                       int64_t g_n, int64_t w_n, int64_t scenarios,
                                       int64_t cluster, int64_t resident, int64_t smem,
                                       int64_t* out) {
  const RunFn fn = run_of(flags);
  if (fn == nullptr || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a = {};
  a.n = n;
  a.u_n = u_n;
  a.k_n = k_n;
  a.g_n = g_n;
  a.w_n = w_n;
  return fn(a, Shape{scenarios, cluster, resident, smem}, nullptr, Ask::kMaxClusters, out);
}

// The static shared memory of the instantiation `flags` (its exchange
// arrays), in bytes, into *out: what the wrapper counts beside a resident
// slice. Returns the cudaError_t of the query.
extern "C" int fused_scan_static_smem(int64_t flags, int64_t* out) {
  const RunFn fn = run_of(flags);
  if (fn == nullptr || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(ScanArgs{}, Shape{}, nullptr, Ask::kStaticSmem, out);
}
