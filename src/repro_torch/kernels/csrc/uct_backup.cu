// uct_backup.cu — BackUp from the memoized selection paths over a
// [G]-slot tree arena, straggler mask included.
//
// Replaces: src/repro/kernels/uct_backup.py, backup_arena -> _backup_kernel
// (the TPU Pallas kernel), and the jit masked backup the JAX executor runs
// for straggler-masked supersteps (src/repro/core/intree.py, backup_batch
// with `dropped`), so the port has one BackUp path.
//
// What it computes, per active slot g (one block per slot): for every
// worker j and every level d of its memoized path, edge_N += 1,
// edge_W += sign * v_j (Qm.16; sign alternates by depth when asked),
// node_N += 1, and the recovery edge_VL -= 1, node_O -= 1.  Then, per
// worker, the leaf's node_N += 1 / node_O -= 1, and in single-expand mode
// the expansion edge is seeded (edge_N += 1, edge_W += sign * v, node_N of
// the simulated node += 1).  A dropped worker only recovers its virtual
// loss and in-flight counts.  Inactive slots are untouched.
//
// Exactness: every update is an int32 atomicAdd.  Integer adds commute,
// so the result is exact and independent of the order the atomics land
// in (src/repro/kernels/uct_backup.py, header).  The alternating sign
// uses (x & 1), which is floor-mod parity, as the reference's % 2 is.
//
// What bounds it on the H100: latency and atomics, not bandwidth.  The
// work is p x depth read-modify-writes of scattered 4-byte words (at the
// paper's Pong size, p=16 and depth <= 9: at most 144 edges and nodes,
// a few KB).  The design spreads the (worker, level) pairs over the
// threads of the block so all of a slot's atomics are in flight at once
// instead of one dependent chain; the atomics resolve in L2.

#include <cuda_runtime.h>

#define NULL_ID (-1)

__global__ void uct_backup_kernel(
    const int* __restrict__ path_nodes, const int* __restrict__ path_actions,
    const int* __restrict__ depths, const int* __restrict__ leaves,
    const int* __restrict__ expand_action, const int* __restrict__ sim_nodes,
    const int* __restrict__ values_fx, const int* __restrict__ dropped,
    const int* __restrict__ active, int* edge_N, int* edge_W, int* edge_VL,
    int* node_N, int* node_O, int X, int Fp, int D, int p, int alternating,
    int expand_all) {
  const int g = blockIdx.x;
  if (!active[g]) return;
  const long long eoff = (long long)g * X * Fp;
  const long long noff = (long long)g * X;
  edge_N += eoff; edge_W += eoff; edge_VL += eoff;
  node_N += noff; node_O += noff;
  const long long woff = (long long)g * p;
  const int* pn = path_nodes + woff * D;
  const int* pa = path_actions + woff * D;

  for (int i = threadIdx.x; i < p * D; i += blockDim.x) {
    const int node = pn[i];
    if (node == NULL_ID) continue;
    const int j = i / D, d = i - j * D;
    const bool alive = dropped == nullptr || dropped[woff + j] == 0;
    const bool expanded = !expand_all && expand_action[woff + j] >= 0;
    const int sim_depth = depths[woff + j] + (expanded ? 1 : 0);
    const int sign = (alternating && ((sim_depth - d) & 1)) ? -1 : 1;
    const long long e = (long long)node * Fp + pa[i];
    if (alive) {
      atomicAdd(&edge_N[e], 1);
      atomicAdd(&edge_W[e], sign * values_fx[woff + j]);
      atomicAdd(&node_N[node], 1);
    }
    atomicAdd(&edge_VL[e], -1);
    atomicAdd(&node_O[node], -1);
  }

  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const bool alive = dropped == nullptr || dropped[woff + j] == 0;
    const int leaf = leaves[woff + j];
    if (alive) atomicAdd(&node_N[leaf], 1);
    atomicAdd(&node_O[leaf], -1);
    const int ea = expand_action[woff + j];
    if (alive && !expand_all && ea >= 0) {
      // the expansion edge sits at depth `depth`, one above the sim node
      const int sign = alternating ? -1 : 1;
      const long long e = (long long)leaf * Fp + ea;
      atomicAdd(&edge_N[e], 1);
      atomicAdd(&edge_W[e], sign * values_fx[woff + j]);
      atomicAdd(&node_N[sim_nodes[woff + j]], 1);
    }
  }
}

extern "C" int uct_backup_launch(
    const void* path_nodes, const void* path_actions, const void* depths,
    const void* leaves, const void* expand_action, const void* sim_nodes,
    const void* values_fx, const void* dropped, const void* active,
    void* edge_N, void* edge_W, void* edge_VL, void* node_N, void* node_O,
    int G, int X, int Fp, int D, int p, int alternating, int expand_all,
    void* stream) {
  if (G <= 0) return 0;
  int threads = ((p * D + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  uct_backup_kernel<<<G, threads, 0, (cudaStream_t)stream>>>(
      (const int*)path_nodes, (const int*)path_actions, (const int*)depths,
      (const int*)leaves, (const int*)expand_action, (const int*)sim_nodes,
      (const int*)values_fx, (const int*)dropped, (const int*)active,
      (int*)edge_N, (int*)edge_W, (int*)edge_VL, (int*)node_N, (int*)node_O,
      X, Fp, D, p, alternating, expand_all);
  return (int)cudaGetLastError();
}
