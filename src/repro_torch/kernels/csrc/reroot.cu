// reroot.cu — the subtree-reusing re-root of one arena slot, in place on
// the card.
//
// Replaces no TPU kernel: the JAX package re-roots on the host
// (src/repro/core/reroot.py, reroot: a Python BFS over a numpy snapshot
// of the slot, then every array rebuilt).  On the H100 that path copied
// the slot's whole tree to pageable host memory and back at every
// committed move (X x (5 Fp + 6) x 4 B each way: 10.75 MB at Pong's
// X=56,000, Fp=8; 61 MB at Gomoku's X=48,000, Fp=64), and the move commit
// paced the service.  This kernel keeps the tree on the card: only the
// root's row (2 Fp + 1 ints) and the kept ids (X + 1 ints) cross PCIe.
//
// What it computes (equal, field for field, to reroot()): the kept ids
// in BFS order from `new_root` -- the UCT is a tree, so that order is
// level order keyed by (the parent's new id, the child's lane) -- their
// rows moved to ids 0..n-1 with `child` remapped through old2new and
// `node_depth` less the new root's depth, rows n..X-1 fresh (child NULL,
// everything else 0), size = n, root = 0; log_table untouched.
//
// Three launches on the caller's stream, and a row read:
//   reroot_row_launch    the root's id, child row and edge_N row, to the
//                        host (one small kernel and one copy)
//   reroot_launch        pass 1, one block: the levels.  Each thread
//                        takes a frontier node, counts its non-NULL
//                        children; a block-wide exclusive scan gives each
//                        node its children's first new id; order[] and
//                        old2new[] are written; until the frontier is
//                        empty (no depth is assumed).
//                        pass 2, a grid: the n kept rows gathered into a
//                        one-slot scratch tree, child remapped; then
//                        order[] copied to the host.
//   reroot_write_launch  pass 3, a grid: the slot written from the scratch
//                        (rows < n) or fresh (rows >= n), size and root.
// The scratch is needed because a kept row's new id can exceed its old
// id, so an in-place gather would overwrite rows not yet read.  Every
// arena tensor keeps its address (a captured CUDA graph over the arena
// stays valid); nothing is allocated here.
//
// What bounds it on the H100: bytes.  At most X x (5 Fp + 6) x 4 B read
// and the same written (6.4 us at Pong, 37 us at Gomoku at 3.35 TB/s);
// pass 1 adds a dependent round trip per level and per 1,024 nodes of a
// level.  Passes 2 and 3 are coalesced grid-stride loops over
// consecutive ints; pass 3 writes the fresh rows without reading them.

#include <cuda_runtime.h>

#define NULL_ID (-1)
#define ORDER_THREADS 1024
#define GRID_THREADS 256

// Block-wide exclusive scan of v over ORDER_THREADS threads; *total gets
// the block's sum.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = ORDER_THREADS / 32;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

__device__ __forceinline__ int count_children(const int* row, int Fp) {
  int cnt = 0;
  if ((Fp & 3) == 0) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
    for (int j = 0; j < (Fp >> 2); ++j) {
      const int4 v = r4[j];
      cnt += (v.x != NULL_ID) + (v.y != NULL_ID) + (v.z != NULL_ID) +
             (v.w != NULL_ID);
    }
  } else {
    for (int j = 0; j < Fp; ++j) cnt += row[j] != NULL_ID;
  }
  return cnt;
}

__global__ void reroot_row_kernel(const int* __restrict__ child,
                                  const int* __restrict__ edge_N,
                                  const int* __restrict__ root, int g, int X,
                                  int Fp, int* __restrict__ out) {
  const int r = root[g];
  const long long base = ((long long)g * X + r) * Fp;
  if (threadIdx.x == 0) out[0] = r;
  for (int j = threadIdx.x; j < Fp; j += blockDim.x) {
    out[1 + j] = child[base + j];
    out[1 + Fp + j] = edge_N[base + j];
  }
}

// Pass 1.  child: the slot's [X, Fp] child array.  order: [1 + X], n then
// the kept old ids in new-id order.  old2new: [X].
__global__ void __launch_bounds__(ORDER_THREADS)
reroot_order_kernel(const int* __restrict__ child, int X, int Fp,
                    int new_root, int* __restrict__ order,
                    int* __restrict__ old2new) {
  __shared__ int warp_sums[32];
  int* ids = order + 1;
  for (int i = threadIdx.x; i < X; i += ORDER_THREADS) old2new[i] = NULL_ID;
  __syncthreads();
  if (threadIdx.x == 0) {
    ids[0] = new_root;
    old2new[new_root] = 0;
  }
  __syncthreads();
  int lo = 0, hi = 1;  // the current level is ids[lo, hi)
  while (lo < hi) {
    int next = hi;     // the next free new id
    for (int base = lo; base < hi; base += ORDER_THREADS) {
      const int i = base + threadIdx.x;
      const int node = i < hi ? ids[i] : NULL_ID;
      const int* row = child + (long long)(node < 0 ? 0 : node) * Fp;
      const int cnt = node == NULL_ID ? 0 : count_children(row, Fp);
      int total;
      const int off = block_exclusive_scan(cnt, warp_sums, &total);
      if (cnt) {
        int id = next + off;
        for (int j = 0; j < Fp; ++j) {
          const int c = row[j];
          if (c != NULL_ID && id < X) {
            ids[id] = c;
            old2new[c] = id;
            ++id;
          }
        }
      }
      next = min(next + total, X);  // a tree holds at most X nodes
    }
    __syncthreads();   // this level's ids are the next level's frontier
    lo = hi;
    hi = next;
  }
  if (threadIdx.x == 0) order[0] = hi;
}

struct SlotArrays {   // one slot's arrays: 5 edge [X, Fp], 6 node [X]
  int* edge[5];       // child, edge_N, edge_W, edge_VL, edge_P
  int* node[6];       // node_N, node_O, num_expanded, num_actions,
                      // node_depth, terminal
};

__device__ __forceinline__ SlotArrays scratch_arrays(int* sc, int X, int Fp) {
  SlotArrays s;
  const long long E = (long long)X * Fp;
  for (int k = 0; k < 5; ++k) s.edge[k] = sc + k * E;
  for (int k = 0; k < 6; ++k) s.node[k] = sc + 5 * E + (long long)k * X;
  return s;
}

// Pass 2: the n kept rows of the slot into the scratch tree.
__global__ void reroot_gather_kernel(SlotArrays slot, int* __restrict__ sc,
                                     const int* __restrict__ order,
                                     const int* __restrict__ old2new, int X,
                                     int Fp, int new_root) {
  const int n = order[0];
  const int* ids = order + 1;
  const SlotArrays out = scratch_arrays(sc, X, Fp);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ne = (long long)n * Fp;
  const int shift = __ffs(Fp) - 1;   // Fp is a power of two
  for (long long e = t0; e < ne; e += stride) {
    const long long s = ((long long)ids[e >> shift] << shift) + (e & (Fp - 1));
    const int c = slot.edge[0][s];
    out.edge[0][e] = c == NULL_ID ? NULL_ID : old2new[c];
#pragma unroll
    for (int k = 1; k < 5; ++k) out.edge[k][e] = slot.edge[k][s];
  }
  const int d0 = slot.node[4][new_root];
  for (long long r = t0; r < n; r += stride) {
    const int s = ids[r];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      out.node[k][r] = slot.node[k][s] - (k == 4 ? d0 : 0);
  }
}

// Pass 3: the slot from the scratch tree (rows < n) or fresh (rows >= n).
__global__ void reroot_write_kernel(SlotArrays slot, int* __restrict__ size,
                                    int* __restrict__ root,
                                    const int* __restrict__ sc,
                                    const int* __restrict__ order, int X,
                                    int Fp) {
  const int n = order[0];
  const SlotArrays in = scratch_arrays(const_cast<int*>(sc), X, Fp);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long E = (long long)X * Fp, kept = (long long)n * Fp;
  for (long long e = t0; e < E; e += stride) {
    if (e < kept) {
#pragma unroll
      for (int k = 0; k < 5; ++k) slot.edge[k][e] = in.edge[k][e];
    } else {
      slot.edge[0][e] = NULL_ID;
#pragma unroll
      for (int k = 1; k < 5; ++k) slot.edge[k][e] = 0;
    }
  }
  for (long long r = t0; r < X; r += stride) {
#pragma unroll
    for (int k = 0; k < 6; ++k) slot.node[k][r] = r < n ? in.node[k][r] : 0;
  }
  if (t0 == 0) {
    *size = n;
    *root = 0;
  }
}

static SlotArrays slot_arrays(void* const* edge, void* const* node, int g,
                              int X, int Fp) {
  SlotArrays s;
  const long long E = (long long)X * Fp;
  for (int k = 0; k < 5; ++k) s.edge[k] = (int*)edge[k] + (long long)g * E;
  for (int k = 0; k < 6; ++k) s.node[k] = (int*)node[k] + (long long)g * X;
  return s;
}

static int grid_blocks(long long work) {
  long long b = (work + GRID_THREADS - 1) / GRID_THREADS;
  if (b > 132 * 8) b = 132 * 8;   // grid-stride beyond 8 blocks an SM
  return b < 1 ? 1 : (int)b;
}

extern "C" int reroot_row_launch(const void* child, const void* edge_N,
                                 const void* root, int g, int X, int Fp,
                                 void* dev_row, void* host_row,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  reroot_row_kernel<<<1, Fp < 32 ? 32 : (Fp > 128 ? 128 : Fp), 0, s>>>(
      (const int*)child, (const int*)edge_N, (const int*)root, g, X, Fp,
      (int*)dev_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyAsync(host_row, dev_row, (size_t)(1 + 2 * Fp) * 4,
                              cudaMemcpyDeviceToHost, s);
}

// edge: child, edge_N, edge_W, edge_VL, edge_P (the arena's [G, X, Fp]);
// node: node_N, node_O, num_expanded, num_actions, node_depth, terminal
// (the arena's [G, X]); scratch: X x (5 Fp + 6) ints; order and
// host_order: 1 + X ints (host_order pinned host memory).
extern "C" int reroot_launch(void* const* edge, void* const* node,
                             void* scratch, void* order, void* old2new,
                             void* host_order, int g, int X, int Fp,
                             int new_root, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const SlotArrays slot = slot_arrays(edge, node, g, X, Fp);
  reroot_order_kernel<<<1, ORDER_THREADS, 0, s>>>(
      slot.edge[0], X, Fp, new_root, (int*)order, (int*)old2new);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reroot_gather_kernel<<<grid_blocks((long long)X * Fp), GRID_THREADS, 0,
                         s>>>(slot, (int*)scratch, (const int*)order,
                              (const int*)old2new, X, Fp, new_root);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyAsync(host_order, order, (size_t)(1 + X) * 4,
                              cudaMemcpyDeviceToHost, s);
}

extern "C" int reroot_write_launch(void* const* edge, void* const* node,
                                   void* size, void* root,
                                   const void* scratch, const void* order,
                                   int g, int X, int Fp, void* stream) {
  const SlotArrays slot = slot_arrays(edge, node, g, X, Fp);
  reroot_write_kernel<<<grid_blocks((long long)X * Fp), GRID_THREADS, 0,
                        (cudaStream_t)stream>>>(
      slot, (int*)size + g, (int*)root + g, (const int*)scratch,
      (const int*)order, X, Fp);
  return (int)cudaGetLastError();
}
