// uct_select.cu — Tree-Parallel Selection + virtual loss, with the BSP
// expansion-assignment pass fused in, over a [G]-slot tree arena.
//
// Replaces: src/repro/kernels/uct_select.py, select_arena -> _select_kernel
// (the TPU Pallas kernel), plus the jit assignment post-pass that the JAX
// ops wrapper runs after it (src/repro/core/intree.py, _assign_expansions).
//
// What it computes, per active slot g (one block per slot): p workers run
// strictly in order; each adds one in-flight visit to the root, then
// descends at most D levels.  At each non-leaf node it scores the node's
// Fp edges with the scoring spec of core/scoring.py (Eq. 1 or PUCT, WU or
// constant virtual loss, Qm.16 fixed point), takes the first maximum,
// adds one virtual loss to edge_VL[node, a] and one in-flight visit to
// node_O of the child, and memoizes (node, a) in its path.  Worker k sees
// the virtual loss of workers < k.  Then one thread walks the p workers
// in order and assigns expansions (pending/claimed per leaf as an O(p^2)
// scan over earlier workers, no X-sized scratch).  An inactive slot
// returns at once with fixed dead rows, its tree untouched.
//
// Bit-exactness: every float op is the correctly rounded intrinsic of the
// reference's op order (__int2float_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn,
// __fadd_rn, rintf), the library is built with --fmad=false and never
// with fast math, and ties go to the lowest lane.
//
// What bounds it on the H100: latency, not bytes or operations.  The work
// is a dependent chain of p x depth levels per slot; each level is a few
// dependent global loads (leaf test, then the node's edge row and ln
// entry, then the chosen child) of a few hundred bytes.  At the paper's
// sizes (Pong: X=56,000, Fp=8, about 10.8 MB per tree; Gomoku: X=48,000,
// Fp=64, about 61 MB) the tree does not fit in the 227 KB of shared
// memory a block may use, so it is read from global memory: Pong's tree
// stays in the 50 MB L2 across launches, Gomoku's edge arrays do not.
// What the design does about it: one warp per slot, each thread owning
// ceil(Fp/32) lanes so a node's row is one coalesced load per array and
// the argmax is a 5-step shuffle reduction; lane 0 alone writes the
// virtual loss, path and in-flight counts, and __syncwarp() orders those
// writes before the next level reads them.  Slots run in parallel, one
// block each.  Staging the hot top of the tree in shared memory is left
// to a later change.

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

__device__ __forceinline__ int encode_fx(float x) {
  float y = rintf(__fmul_rn(x, 65536.0f));   // round half to even
  y = fminf(fmaxf(y, FX_MIN_F), FX_MAX_F);
  return (int)y;                              // y is integral: exact
}

// core/scoring.py edge_scores_fx for one lane, same op order.
__device__ __forceinline__ int lane_score(
    int lane, int na, int ch, int eN, int eW, int eVL, int eP, int ns,
    float log_ns, int wu, int vl_const_fx, int puct, float beta) {
  const bool valid = (lane < na) && (ch != NULL_ID);
  const int ne = wu ? eN + eVL : eN;
  const float ne_safe = __int2float_rn(ne > 1 ? ne : 1);
  float q = __fdiv_rn(__fmul_rn(__int2float_rn(eW), FX_INV_SCALE), ne_safe);
  int base;
  if (!puct) {
    const float u = __fmul_rn(beta, __fsqrt_rn(__fdiv_rn(log_ns, ne_safe)));
    base = (ne == 0) ? FX_FORCE_EXPLORE : encode_fx(__fadd_rn(q, u));
  } else {
    if (ne == 0) q = 0.0f;
    const float sqrt_ns = __fsqrt_rn(__int2float_rn(ns));
    const float p_f = __fmul_rn(__int2float_rn(eP), FX_INV_SCALE);
    const float u = __fdiv_rn(__fmul_rn(__fmul_rn(beta, p_f), sqrt_ns),
                              __fadd_rn(1.0f, __int2float_rn(ne)));
    base = encode_fx(__fadd_rn(q, u));
  }
  if (!wu)  // constant virtual loss: exact (wrapping) int32 arithmetic
    base = (int)((unsigned)base - (unsigned)vl_const_fx * (unsigned)eVL);
  return valid ? base : FX_NEG_INF;
}

__global__ void __launch_bounds__(32) uct_select_kernel(
    const int* __restrict__ child, const int* __restrict__ edge_N,
    const int* __restrict__ edge_W, const int* __restrict__ edge_P,
    int* edge_VL, const int* __restrict__ node_N, int* node_O,
    const int* __restrict__ num_expanded, const int* __restrict__ num_actions,
    const int* __restrict__ terminal, const float* __restrict__ log_table,
    const int* __restrict__ root, const int* __restrict__ size,
    const int* __restrict__ active,
    int* path_nodes, int* path_actions, int* depths, int* leaves,
    int* expand_action, int* n_insert, int* insert_base,
    int X, int Fp, int D, int p, int L, int wu, int vl_const_fx, int puct,
    float beta, int leaf_partial, int expand_all) {
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
  // edge_VL / node_O are written by lane 0 and read by every lane
  volatile int* vl = edge_VL;
  volatile int* no = node_O;

  for (int i = t; i < p * D; i += 32) { pn[i] = NULL_ID; pa[i] = NULL_ID; }
  const int r = root[g];
  const int sz = size[g];
  if (!active[g]) {
    for (int j = t; j < p; j += 32) {
      dep[j] = 0; lv[j] = r; ea[j] = NULL_ID; ni[j] = 0; ib[j] = sz;
    }
    return;
  }
  const int ns_cap = 2 * X + 3;

  for (int j = 0; j < p; ++j) {
    if (t == 0) no[r] += 1;
    __syncwarp();
    int node = r, depth = 0;
    for (int d = 0; d < D; ++d) {
      const int nexp = num_expanded[node];
      const int na = num_actions[node];
      const int term = terminal[node];
      const bool open = leaf_partial ? (nexp < na) : (nexp == 0);
      if (open || term != 0 || depth >= D || na == 0) break;   // leaf
      int ns = wu ? node_N[node] + no[node] : node_N[node];
      ns = ns < ns_cap ? ns : ns_cap;
      const float log_ns = log_table[ns];
      int best = INT_MIN, best_l = INT_MAX;
      const long long row = (long long)node * Fp;
      for (int l = t; l < Fp; l += 32) {      // ascending: first max wins
        const int s = lane_score(l, na, child[row + l], edge_N[row + l],
                                 edge_W[row + l], vl[row + l], edge_P[row + l],
                                 ns, log_ns, wu, vl_const_fx, puct, beta);
        if (s > best) { best = s; best_l = l; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int os = __shfl_xor_sync(FULL_MASK, best, off);
        const int ol = __shfl_xor_sync(FULL_MASK, best_l, off);
        if (os > best || (os == best && ol < best_l)) { best = os; best_l = ol; }
      }
      const int a = best_l;
      const int nxt = child[row + a];
      if (t == 0) {
        vl[row + a] += 1;
        pn[j * D + d] = node;
        pa[j * D + d] = a;
        no[nxt] += 1;
      }
      node = nxt;
      depth += 1;
      __syncwarp();
    }
    if (t == 0) { dep[j] = depth; lv[j] = node; }
    __syncwarp();
  }

  // Expansion assignment (core/intree.py _assign_expansions), worker order.
  if (t == 0) {
    int budget = X - sz, base = sz;
    for (int j = 0; j < p; ++j) {
      const int leaf = lv[j];
      const bool can = terminal[leaf] == 0 && dep[j] < D;
      int e = NULL_ID, k = 0;
      if (expand_all) {
        const int kk = num_actions[leaf];
        bool claimed = false;
        for (int i = 0; i < j; ++i) claimed |= (ea[i] == -2 && lv[i] == leaf);
        if (can && !claimed && num_expanded[leaf] == 0 && kk > 0 && budget >= kk) {
          e = -2; k = kk;
        }
      } else {
        int pending = 0;
        for (int i = 0; i < j; ++i) pending += (ea[i] >= 0 && lv[i] == leaf);
        const int a = num_expanded[leaf] + pending;
        if (can && a < num_actions[leaf] && budget >= 1) { e = a; k = 1; }
      }
      ea[j] = e; ni[j] = k; ib[j] = base;
      base += k; budget -= k;
    }
  }
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
  uct_select_kernel<<<G, 32, 0, (cudaStream_t)stream>>>(
      (const int*)child, (const int*)edge_N, (const int*)edge_W,
      (const int*)edge_P, (int*)edge_VL, (const int*)node_N, (int*)node_O,
      (const int*)num_expanded, (const int*)num_actions,
      (const int*)terminal, (const float*)log_table, (const int*)root,
      (const int*)size, (const int*)active, (int*)path_nodes,
      (int*)path_actions, (int*)depths, (int*)leaves, (int*)expand_action,
      (int*)n_insert, (int*)insert_base, X, Fp, D, p, L, wu, vl_const_fx,
      puct, beta, leaf_partial, expand_all);
  return (int)cudaGetLastError();
}
