// uct_select.cu — Tree-Parallel Selection + virtual loss, with the BSP
// expansion-assignment pass fused in, over a [G]-slot tree arena.
//
// Replaces: src/repro/kernels/uct_select.py, select_arena -> _select_kernel
// (:56, the TPU Pallas kernel), plus the jit assignment post-pass that the
// JAX ops wrapper runs after it (src/repro/core/intree.py,
// _assign_expansions).
//
// What it computes, per active slot g (one warp per slot): p workers run
// strictly in order; each adds one in-flight visit to the root, then
// descends at most D levels.  At each non-leaf node it scores the node's
// Fp edges with the scoring spec of core/scoring.py (Eq. 1 or PUCT, WU or
// constant virtual loss, Qm.16 fixed point), takes the first maximum,
// adds one virtual loss to edge_VL[node, a] and one in-flight visit to
// node_O of the child, and memoizes (node, a) in its path.  Worker k sees
// the virtual loss of workers < k.  Then the warp assigns expansions in
// worker order.  An inactive slot returns at once with fixed dead rows,
// its tree untouched.
//
// Bit-exactness: every float op is the correctly rounded intrinsic of the
// reference's op order (__int2float_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn,
// __fadd_rn, rintf), the library is built with --fmad=false and never
// with fast math, and ties go to the lowest lane.
//
// What bounds it on the H100: latency.  The work is a dependent chain of
// p x depth levels per slot (99 at the Pong main path's shape) of a few
// hundred bytes each, about 6.8 KB in all, so bytes and operations bound
// it at nanoseconds; what costs is each level's trips to L2 and its
// scoring arithmetic, one after the other.  The trees do
// not fit in shared memory (Pong: X=56,000, Fp=8, about 10.8 MB per tree;
// Gomoku: X=48,000, Fp=64, about 61 MB): Pong's tree stays in the 50 MB
// L2 across launches, Gomoku's edge arrays do not.
//
// The chain per level, before (the first port of this kernel): the
// node's leaf flags, then node_N and a volatile node_O, then
// log_table[ns], then the edge row with a volatile edge_VL, then
// child[row + a] again, then lane 0's two volatile read-modify-writes of
// edge_VL and node_O, which the next level waited for at __syncwarp:
// about six dependent round trips, 1.35 us a level.  After: a level waits
// for one batch of loads, its edge row, requested as soon as the last
// argmax named the node; what is still dependent is the chosen child's
// node_O and then its ln entry (two L2 trips, which the scoring overlaps),
// so a level costs those plus the scoring, about 0.85 us (PERF.md).
//   - One batch of loads per level.  The node's leaf flags, node_N + node_O
//     and ln entry arrive with the level before (below), so a level waits
//     only for its edge row (child, N, W, P, VL), issued as soon as the
//     argmax names the node, before the leaf test.  nxt comes out of the
//     row by __shfl_sync; nothing is reloaded.  A node is always an
//     in-range id: nothing is loaded at a NULL child.
//   - In-flight counts off the chain.  The virtual loss and the child's
//     in-flight visit are fire-and-forget atomicAdds whose results are
//     unused (RED), issued by the lane that owns the chosen edge.  A word
//     they change is read again in this launch only by that same thread
//     (edge (n, a) and node_O of child[n, a] both belong to lane a of n's
//     row), with a strong load at GPU scope (ld.relaxed.gpu, served by L2
//     where the REDs land), so program order alone makes the next worker
//     see them.  The root's own in-flight count is kept in a register
//     (read once at launch, +1 per worker): nothing else changes it.
//     Nothing assumes edge_VL / node_O are zero at launch.  (Of the two
//     ways to take the counts off the chain, REDs and this launch's deltas
//     in shared memory, the REDs are the one that needs no table keyed by
//     node; they are right on the card and nothing waits on them.)
//   - The child's scalars and ln entry, one level ahead.  While a level
//     scores, each lane with a child loads that child's num_expanded,
//     num_actions, terminal, node_N and node_O; once the argmax names
//     lane a, its owner loads log_table[min(N + O + 1, 2X+3)] (the +1 is
//     the in-flight visit this worker adds to the child; min(N, 2X+3) with
//     constant virtual loss) while the next edge row is in flight.  The
//     scalars are shuffled out at once, the ln entry after the next leaf
//     test, so a walk's last level never waits for it.  A node occurs at
//     most once on a worker's path, so nothing prefetched goes stale
//     within a walk.
//   - Scoring without the slow path.  A zero dividend or radicand (an
//     unvisited edge's W, ln 1 = 0, an empty prior, the padding lanes)
//     sends the correctly rounded division or square root down its slow
//     path; div_rn / sqrt_rn branch around it, returning that zero.  On
//     the H100 this alone took a level at the Pong main path's shape from
//     about 1.06 us to 0.85 us.
//   - The argmax is two warp reductions (__reduce_max_sync on the score,
//     __reduce_min_sync on the lane among the maxima) instead of ten
//     dependent shuffles.
//   - The assignment pass runs off shared memory.  Each walk leaves its
//     leaf, depth and the leaf's num_expanded / num_actions / terminal in
//     shared memory (20 B a worker); the pass takes 32 workers at a time,
//     one per lane, and counts earlier workers at the same leaf with
//     __match_any_sync / __ballot_sync / __popc (a loop over earlier
//     chunks only when p > 32).  Budget and insert_base are warp scans;
//     only expand-all chunks whose expansions overrun the budget walk
//     their 32 lanes in order.  The [G, p] outputs are written once.
// Out of scope here: caching tree rows across workers, prefetching whole
// child rows, more than one warp per slot.

#include <cuda_runtime.h>
#include <limits.h>

#define NULL_ID (-1)
#define FX_FORCE_EXPLORE (1 << 28)
#define FX_NEG_INF (-(1 << 30))
// The clip bounds as the f32 values the reference clips with
// (np.float32((1 << 27) - 1) rounds up to 2^27).
#define FX_MIN_F (-134217728.0f)
#define FX_MAX_F (134217728.0f)
#define FX_INV_SCALE (1.0f / 65536.0f)
#define FULL_MASK 0xffffffffu
#define SMEM_INTS_PER_WORKER 5   // leaf, depth, and the leaf's nexp, na, term

// Where a level goes.  Built with -DUCT_SELECT_STAMPS (chip_smoke.py's
// instrumented copy; never the library the wrapper loads), every thread
// adds the clock64 cycles of each stretch of the walk to a register, and
// thread 0 of slot 0 leaves its sums in uct_select_cycles for
// uct_select_cycles_read.  Stretches: 0 the leaf test (waits for the
// child's scalars), 1 the edge row's wait and the children's loads
// issued, 2 the ln entry's wait, 3 the scoring and the argmax's two
// reductions, 4 nxt's shuffle, the REDs and path stores, 5 the next
// row's and ln entry's loads issued and four shuffles, 6 a worker's end
// (its last leaf test, the path's tail, shared memory), 7 the assignment.
// Without the flag the stamps compile to nothing.
#ifdef UCT_SELECT_STAMPS
#define N_STAMPS 8
__device__ long long uct_select_cycles[N_STAMPS];
#define STAMP_START long long stamp_acc[N_STAMPS] = {}, stamp_t = clock64()
#define STAMP(i) do { const long long c_ = clock64(); \
    stamp_acc[i] += c_ - stamp_t; stamp_t = c_; } while (0)
#define STAMP_END do { if (g == 0 && t == 0) { \
    for (int i_ = 0; i_ < N_STAMPS; ++i_) uct_select_cycles[i_] = stamp_acc[i_]; \
  } } while (0)
#else
#define STAMP_START
#define STAMP(i)
#define STAMP_END
#endif

__device__ __forceinline__ int encode_fx(float x) {
  float y = rintf(__fmul_rn(x, 65536.0f));   // round half to even
  y = fminf(fmaxf(y, FX_MIN_F), FX_MAX_F);
  return (int)y;                              // y is integral: exact
}

// The correctly rounded division and square root with a zero operand
// branched around: ptxas's sequences send a zero dividend or radicand down
// their slow path (a call, and a warp waits for its slowest lane), while
// 0 / b (b >= 1 at every call below) and sqrt(0) are that same zero.
__device__ __forceinline__ float div_rn(float a, float b) {
  if (a == 0.0f) return a;
  return __fdiv_rn(a, b);
}

__device__ __forceinline__ float sqrt_rn(float a) {
  if (a == 0.0f) return a;
  return __fsqrt_rn(a);
}

// core/scoring.py edge_scores_fx for one lane, same op order.
__device__ __forceinline__ int lane_score(
    int lane, int na, int ch, int eN, int eW, int eVL, int eP, int ns,
    float log_ns, int wu, int vl_const_fx, int puct, float beta) {
  const bool valid = (lane < na) && (ch != NULL_ID);
  const int ne = wu ? eN + eVL : eN;
  const float ne_safe = __int2float_rn(ne > 1 ? ne : 1);
  float q = div_rn(__fmul_rn(__int2float_rn(eW), FX_INV_SCALE), ne_safe);
  int base;
  if (!puct) {
    const float u = __fmul_rn(beta, sqrt_rn(div_rn(log_ns, ne_safe)));
    base = (ne == 0) ? FX_FORCE_EXPLORE : encode_fx(__fadd_rn(q, u));
  } else {
    if (ne == 0) q = 0.0f;
    const float sqrt_ns = sqrt_rn(__int2float_rn(ns));
    const float p_f = __fmul_rn(__int2float_rn(eP), FX_INV_SCALE);
    const float u = div_rn(__fmul_rn(__fmul_rn(beta, p_f), sqrt_ns),
                           __fadd_rn(1.0f, __int2float_rn(ne)));
    base = encode_fx(__fadd_rn(q, u));
  }
  if (!wu)  // constant virtual loss: exact (wrapping) int32 arithmetic
    base = (int)((unsigned)base - (unsigned)vl_const_fx * (unsigned)eVL);
  return valid ? base : FX_NEG_INF;
}

// A load that sees this launch's REDs: strong at GPU scope, so it is
// served by L2 and never by a stale L1 line.
__device__ __forceinline__ int ld_l2(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// v[k] for a warp-uniform k, without a local-memory array.
template <int NL>
__device__ __forceinline__ int pick(const int (&v)[NL], int k) {
  int r = v[0];
#pragma unroll
  for (int i = 1; i < NL; ++i) r = (k == i) ? v[i] : r;
  return r;
}

// One warp per slot; thread t owns lanes t + 32k, k < NL (NL = Fp / 32
// rounded up: 1, 2 or 4).
template <int NL>
__global__ void __launch_bounds__(32) uct_select_kernel(
    const int* __restrict__ child, const int* __restrict__ edge_N,
    const int* __restrict__ edge_W, const int* __restrict__ edge_P,
    int* edge_VL, const int* __restrict__ node_N, int* node_O,
    const int* __restrict__ num_expanded, const int* __restrict__ num_actions,
    const int* __restrict__ terminal, const float* __restrict__ log_table,
    const int* __restrict__ root, const int* __restrict__ size,
    const int* __restrict__ active,
    int* __restrict__ path_nodes, int* __restrict__ path_actions,
    int* __restrict__ depths, int* __restrict__ leaves,
    int* __restrict__ expand_action, int* __restrict__ n_insert,
    int* __restrict__ insert_base,
    int X, int Fp, int D, int p, int L, int wu, int vl_const_fx, int puct,
    float beta, int leaf_partial, int expand_all) {
  extern __shared__ int smem[];
  int* s_leaf = smem;
  int* s_dep = smem + p;
  int* s_nexp = smem + 2 * p;
  int* s_na = smem + 3 * p;
  int* s_term = smem + 4 * p;

  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const long long eoff = (long long)g * X * Fp;
  const long long noff = (long long)g * X;
  child += eoff; edge_N += eoff; edge_W += eoff; edge_P += eoff;
  edge_VL += eoff;
  node_N += noff; node_O += noff; num_expanded += noff; num_actions += noff;
  terminal += noff;
  log_table += (long long)g * L;
  int* pn = path_nodes + (long long)g * p * D;
  int* pa = path_actions + (long long)g * p * D;
  int* dep = depths + (long long)g * p;
  int* lv = leaves + (long long)g * p;
  int* ea = expand_action + (long long)g * p;
  int* ni = n_insert + (long long)g * p;
  int* ib = insert_base + (long long)g * p;

  const int r = root[g];
  const int sz = size[g];
  if (!active[g]) {
    for (int i = t; i < p * D; i += 32) { pn[i] = NULL_ID; pa[i] = NULL_ID; }
    for (int j = t; j < p; j += 32) {
      dep[j] = 0; lv[j] = r; ea[j] = NULL_ID; ni[j] = 0; ib[j] = sz;
    }
    return;
  }
  STAMP_START;
  const int ns_cap = 2 * X + 3;
  // The root's scalars: select writes none of them but node_O, and of
  // node_O[r] only thread 0's +1 per worker below (so thread 0 reads it).
  const int r_nexp = num_expanded[r], r_na = num_actions[r];
  const int r_term = terminal[r], r_N = node_N[r];
  int r_O = __shfl_sync(FULL_MASK, (wu && t == 0) ? ld_l2(node_O + r) : 0, 0);

  // The node's edge row, and its children's scalars (lanes past Fp keep
  // these values and are never chosen).
  int ch[NL], eN[NL] = {}, eW[NL] = {}, eP[NL] = {}, eVL[NL] = {};
  int cx[NL] = {}, cna[NL] = {}, ctm[NL] = {}, cN[NL] = {}, cO[NL] = {};
#pragma unroll
  for (int k = 0; k < NL; ++k) ch[k] = NULL_ID;
  auto load_row = [&](int node) {
    const long long row = (long long)node * Fp;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const int l = t + 32 * k;
      if (l < Fp) {
        ch[k] = child[row + l];
        eN[k] = edge_N[row + l];
        eW[k] = edge_W[row + l];
        eP[k] = puct ? edge_P[row + l] : 0;
        eVL[k] = ld_l2(edge_VL + row + l);
      }
    }
  };

  for (int j = 0; j < p; ++j) {
    if (t == 0) atomicAdd(node_O + r, 1);
    r_O += 1;
    int node = r, depth = 0;
    int nexp = r_nexp, na = r_na, term = r_term;
    int ns = wu ? r_N + r_O : r_N;
    ns = ns < ns_cap ? ns : ns_cap;
    float log_ns = log_table[ns], log_next = 0.0f;
    int owner = 0;
    load_row(node);
    for (int d = 0; d < D; ++d) {
      const bool open = leaf_partial ? (nexp < na) : (nexp == 0);
      if (open || term != 0 || na == 0) break;                  // leaf
      STAMP(0);
      // this level's children: their scalars travel while it scores
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        const int l = t + 32 * k;
        if (l < Fp && ch[k] != NULL_ID) {
          cx[k] = num_expanded[ch[k]];
          cna[k] = num_actions[ch[k]];
          ctm[k] = terminal[ch[k]];
          cN[k] = node_N[ch[k]];
          cO[k] = wu ? ld_l2(node_O + ch[k]) : 0;
        }
      }
      STAMP(1);
      // the ln entry the last level's owner loaded (a leaf never waits on it)
      if (d > 0) log_ns = __shfl_sync(FULL_MASK, log_next, owner);
      STAMP(2);
      int best = INT_MIN, best_l = INT_MAX;
#pragma unroll
      for (int k = 0; k < NL; ++k) {           // ascending: first max wins
        const int l = t + 32 * k;
        if (l < Fp) {
          const int s = lane_score(l, na, ch[k], eN[k], eW[k], eVL[k], eP[k],
                                   ns, log_ns, wu, vl_const_fx, puct, beta);
          if (s > best) { best = s; best_l = l; }
        }
      }
      const int top = __reduce_max_sync(FULL_MASK, best);
      const int a = __reduce_min_sync(FULL_MASK, best == top ? best_l : INT_MAX);
      STAMP(3);
      const int ka = a >> 5;
      owner = a & 31;
      const int nxt = __shfl_sync(FULL_MASK, pick<NL>(ch, ka), owner);
      // A consistent tree has a child in each of a non-leaf node's first
      // na lanes, so this never stops a walk; it keeps every load in range.
      if (nxt == NULL_ID) break;
      if (t == owner) {
        atomicAdd(edge_VL + (long long)node * Fp + a, 1);
        atomicAdd(node_O + nxt, 1);
        pn[j * D + d] = node;
        pa[j * D + d] = a;
      }
      STAMP(4);
      node = nxt;
      depth += 1;
      load_row(node);                          // the next level's one wait
      int ns_next = 0;
      if (t == owner) {
        ns_next = wu ? pick<NL>(cN, ka) + pick<NL>(cO, ka) + 1 : pick<NL>(cN, ka);
        ns_next = ns_next < ns_cap ? ns_next : ns_cap;
        log_next = log_table[ns_next];
      }
      nexp = __shfl_sync(FULL_MASK, pick<NL>(cx, ka), owner);
      na = __shfl_sync(FULL_MASK, pick<NL>(cna, ka), owner);
      term = __shfl_sync(FULL_MASK, pick<NL>(ctm, ka), owner);
      ns = __shfl_sync(FULL_MASK, ns_next, owner);
      STAMP(5);
    }
    for (int i = depth + t; i < D; i += 32) {
      pn[j * D + i] = NULL_ID;
      pa[j * D + i] = NULL_ID;
    }
    if (t == 0) {
      s_leaf[j] = node; s_dep[j] = depth;
      s_nexp[j] = nexp; s_na[j] = na; s_term[j] = term;
    }
    STAMP(6);
  }
  __syncwarp();

  // Expansion assignment (core/intree.py _assign_expansions), worker order,
  // 32 workers at a time.  With `before` = earlier workers at the same
  // leaf that can expand, the sequential rules reduce to:
  //   single: the first na - nexp of a leaf's workers that can expand get
  //     action nexp + before, while fewer than X - size such workers came
  //     first (each takes one node of the budget);
  //   expand-all: only a leaf's first candidate can claim it, and gets it
  //     if its na nodes fit in what earlier claims left of the budget.
  const int budget0 = X - sz;
  const unsigned lt = (1u << t) - 1u;
  int used = 0, cands = 0;              // over earlier chunks
  for (int c = 0; c < p; c += 32) {
    const int j = c + t;
    const bool in = j < p;
    const int leaf = in ? s_leaf[j] : INT_MIN + t;   // unique when out
    const int dj = in ? s_dep[j] : 0;
    const int nexp = in ? s_nexp[j] : 0, na = in ? s_na[j] : 0;
    const bool can = in && s_term[j] == 0 && dj < D;
    const bool cand = expand_all ? (can && nexp == 0 && na > 0) : can;
    int before = 0;                     // workers < c at this leaf
    for (int i = 0; i < c; ++i) {
      if (s_leaf[i] != leaf || s_term[i] != 0 || s_dep[i] >= D) continue;
      before += expand_all ? (s_nexp[i] == 0 && s_na[i] > 0) : 1;
    }
    const unsigned same = __match_any_sync(FULL_MASK, leaf);
    before += __popc(same & __ballot_sync(FULL_MASK, cand) & lt);
    int e = NULL_ID, k = 0;
    if (expand_all) {
      const bool first = cand && before == 0;
      const int want = first ? na : 0;
      const int total = __reduce_add_sync(FULL_MASK, want);
      bool ok = first;
      if (used + total > budget0) {     // overrun: walk the lanes in order
        int left = budget0 - used;
        for (int i = 0; i < 32; ++i) {
          const int w = __shfl_sync(FULL_MASK, want, i);
          const bool fits = w > 0 && left >= w;
          if (t == i) ok = fits;
          left -= fits ? w : 0;
        }
      }
      if (ok) { e = -2; k = na; }
    } else {
      const bool sel = cand && before < na - nexp;
      const unsigned sels = __ballot_sync(FULL_MASK, sel);
      if (sel && cands + __popc(sels & lt) < budget0) { e = nexp + before; k = 1; }
      cands += __popc(sels);
    }
    int base = k;                       // inclusive scan of k over lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, base, off);
      if (t >= off) base += v;
    }
    if (in) {
      dep[j] = dj; lv[j] = leaf; ea[j] = e; ni[j] = k;
      ib[j] = sz + used + base - k;
    }
    used += __shfl_sync(FULL_MASK, base, 31);
  }
  STAMP(7);
  STAMP_END;
}

template <int NL>
static int launch(const void* const* ptrs, int G, int X, int Fp, int D,
                  int p, int L, int wu, int vl_const_fx, int puct,
                  float beta, int leaf_partial, int expand_all,
                  cudaStream_t stream) {
  const size_t smem = (size_t)SMEM_INTS_PER_WORKER * p * sizeof(int);
  if (smem > 48 * 1024) {   // per call: the attribute is per device
    const cudaError_t err = cudaFuncSetAttribute(
        uct_select_kernel<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  uct_select_kernel<NL><<<G, 32, smem, stream>>>(
      (const int*)ptrs[0], (const int*)ptrs[1], (const int*)ptrs[2],
      (const int*)ptrs[3], (int*)ptrs[4], (const int*)ptrs[5], (int*)ptrs[6],
      (const int*)ptrs[7], (const int*)ptrs[8], (const int*)ptrs[9],
      (const float*)ptrs[10], (const int*)ptrs[11], (const int*)ptrs[12],
      (const int*)ptrs[13], (int*)ptrs[14], (int*)ptrs[15], (int*)ptrs[16],
      (int*)ptrs[17], (int*)ptrs[18], (int*)ptrs[19], (int*)ptrs[20],
      X, Fp, D, p, L, wu, vl_const_fx, puct, beta, leaf_partial, expand_all);
  return (int)cudaGetLastError();
}

extern "C" int uct_select_launch(
    const void* child, const void* edge_N, const void* edge_W,
    const void* edge_P, void* edge_VL, const void* node_N, void* node_O,
    const void* num_expanded, const void* num_actions, const void* terminal,
    const void* log_table, const void* root, const void* size,
    const void* active, void* path_nodes, void* path_actions, void* depths,
    void* leaves, void* expand_action, void* n_insert, void* insert_base,
    int G, int X, int Fp, int D, int p, int L, int wu, int vl_const_fx,
    int puct, float beta, int leaf_partial, int expand_all, void* stream) {
  if (G <= 0) return 0;
  const void* ptrs[21] = {
      child, edge_N, edge_W, edge_P, edge_VL, node_N, node_O, num_expanded,
      num_actions, terminal, log_table, root, size, active, path_nodes,
      path_actions, depths, leaves, expand_action, n_insert, insert_base};
  const cudaStream_t s = (cudaStream_t)stream;
  if (Fp <= 32)
    return launch<1>(ptrs, G, X, Fp, D, p, L, wu, vl_const_fx, puct, beta,
                     leaf_partial, expand_all, s);
  if (Fp <= 64)
    return launch<2>(ptrs, G, X, Fp, D, p, L, wu, vl_const_fx, puct, beta,
                     leaf_partial, expand_all, s);
  if (Fp <= 128)
    return launch<4>(ptrs, G, X, Fp, D, p, L, wu, vl_const_fx, puct, beta,
                     leaf_partial, expand_all, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef UCT_SELECT_STAMPS
// The stamps of the last launch's slot 0 (N_STAMPS int64 cycle sums).
extern "C" int uct_select_cycles_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, uct_select_cycles,
                                   N_STAMPS * sizeof(long long));
}
#endif

// The latency floor of the tree kernels: one thread's chain of `steps`
// dependent strong loads (ld_l2, as the selection walk's) over a slot's
// child array, from `start` down lane (step mod 8) of each row, back to
// `start` at a missing child.  Timed by the caller at two step counts;
// writes the last node so the chain is not optimized away.
__global__ void uct_chase_kernel(const int* child, int Fp, int start,
                                 int steps, int* out) {
  int node = start;
  for (int i = 0; i < steps; ++i) {
    const int c = ld_l2(child + (long long)node * Fp + (i & 7) % Fp);
    node = c == NULL_ID ? start : c;
  }
  out[0] = node;
}

extern "C" int uct_chase_launch(const void* child, int Fp, int start,
                                int steps, void* out, void* stream) {
  uct_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)child, Fp, start, steps, (int*)out);
  return (int)cudaGetLastError();
}
