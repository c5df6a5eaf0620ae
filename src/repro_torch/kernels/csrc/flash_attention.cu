// flash_attention.cu — FlashAttention forward (causal / sliding window /
// GQA) for the LM's prefill: bf16 on Hopper's tensor cores (wgmma + TMA),
// f32 on the SIMT cores.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention ->
// _flash_kernel (the TPU Pallas kernel, a (batch, q_heads, q_blocks) grid of
// 128 x 128 VMEM tiles).
//
// What it computes, for every (b, h, query row i):
//   out[b,i,h,:] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,h/g,:]) v[b,j,h/g,:]
// over the keys j that are not masked: j < Sk, and j <= i when causal, and
// j > i - window when a window is given (g = H / Hkv, scale = 1/sqrt(dh)).
// Masked scores are -2e38 (NEG), as in the JAX package.  The key tiles
// outside the mask's range are skipped, not merely masked: causal stops at
// the tile holding the tile's last query, and a window starts at tile
// (q0 - window) / BK (flash_attention.py:77-80).  out = acc / max(l, 1e-30),
// cast to q's dtype.  Causal masking takes query 0 to sit at key 0; the
// wrapper refuses causal with Sq != Sk.  A row whose first tiles are all
// masked carries m = NEG and exp(0) = 1 weights until its first real key,
// whose alpha = exp(NEG - m) = 0 wipes them, as in the Pallas kernel.
//
// Layout: q [B,Sq,H,dh], k/v [B,Sk,Hkv,dh], out [B,Sq,H,dh], read and
// written through their element strides (the head_dim axis contiguous).
//
// What bounds it on the H100: operations.  4 * B * H * Sq * Sk * dh FLOPs
// (about halved when causal) against 989 TFLOP/s on bf16 tensor cores (the
// llama3.2-1b prefill at B=16, S=2048: 2.75e11 FLOPs, 0.278 ms); the bytes
// (q, k, v read once, out written once: 335 MB at that shape, 0.100 ms)
// are not the limit.
//
// bf16 (flash_fwd_bf16): one CTA of one warpgroup per (64-query tile,
// head, batch), the longest causal tiles first, 4 CTAs per SM at dh <= 64.
// Thread 0 brings Q once and K/V tiles into two K and two V buffers by TMA
// (4-D tensor maps over the caller's [B,S,H,dh] strides, 128-byte swizzle,
// out-of-bounds rows and columns filled with zeros, which covers ragged S
// and head dims under 64), each completing on its mbarrier; a buffer is
// refilled as soon as the wgmma that reads it has landed, so no producer
// warp holds registers and no empty barriers are needed.  Per key tile:
//   S = Q.K^T      wgmma m64nBKk16, bf16 in shared memory, f32 accumulate.
//                  Products of bf16 values are exact in f32, so S is the
//                  JAX kernel's f32 matmul up to summation order; `scale`
//                  multiplies S in f32 afterwards (scaling q in bf16 would
//                  round it).
//   softmax        online, in f32 registers on the accumulator layout: a
//                  thread holds 2 rows x BK/4 columns, a row's max reduces
//                  over the 4 threads of a quad; masks only on the tiles
//                  that cross the diagonal, the window's edge or Sk.  In
//                  log2 units: p = 2^(s log2(e) - m) by ex2.approx (relative
//                  error about 1e-6 over the weights that matter).
//   O += P.V       P is split, P_hi = bf16(p), P_lo = bf16(p - P_hi), and
//                  both go through wgmma m64n64k16 with A from registers
//                  (the accumulator's fragment layout is the A operand's,
//                  no shuffles) and V as the MN-major B operand, into one
//                  f32 accumulator.  P_hi + P_lo carries p to 2^-16
//                  relative; a single bf16 P (2^-8) puts short rows, where
//                  a few weights carry the output, 40x past the check that
//                  holds this kernel to the f32 plain version within one
//                  bf16 rounding (tests/test_torch_flash.py emulates both).
//                  The split costs 1.5x the tensor FLOPs of a standard
//                  forward (floor 0.417 ms at the shape above).
// The softmax of tile i runs while tile i's S and tile i-1's P.V are in
// flight on the tensor cores (FlashAttention-3's intra-warpgroup overlap).
// Head dims 16 and 32 run as one zero-padded 64-column chunk (the Q.K^T
// k-steps stop at dh; P.V computes the padding and drops it); 128 and 256
// run as 2 and 4 chunks of 64 columns, each a 128-byte swizzled TMA box
// with its own wgmma descriptors.  dh = 256 takes 32-key tiles to keep the
// accumulators (128 + 16 f32 a thread) in registers.  The wrapper refuses
// a bf16 tensor whose base or strides are not 16-byte aligned (TMA).
//
// f32 (flash_fwd_f32): the SIMT kernel below, every product and sum in f32
// FMAs (written out as fmaf: the build passes --fmad=false for the tree
// kernels' exactness), expf, no fast math; one block per (b, h, 64-query
// tile), 4 threads per query row, K/V tiles staged in shared memory.  It
// agrees with its plain version to the JAX test's f32 tolerance (2e-5).
// TF32 wgmma (relative 2^-11) could not; f32 is used only by references
// and tests.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#define NEG (-2.0e38f)

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------

constexpr int BQ = 64;                  // query rows per block
constexpr int LANES = 4;                // threads per query row
constexpr int THREADS = BQ * LANES;

// Shared-memory tiles of one block, f32: q [BQ][LD], k and v [BK][LD],
// p [BQ][PLD].  The +4 paddings keep float4 rows 16-byte aligned and put
// the rows that one warp reads at once in distinct banks.
template <int DH>
struct Tile {
    static constexpr int BK = DH >= 128 ? 32 : 64;   // keys per tile
    static constexpr int LD = DH + 4;
    static constexpr int PLD = BK + 4;
    static constexpr int SMEM = (BQ * LD + 2 * BK * LD + BQ * PLD) * 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {
    long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int group, Strides st, int causal,
    int window, float scale) {
    constexpr int BK = Tile<DH>::BK, LD = Tile<DH>::LD, PLD = Tile<DH>::PLD;
    constexpr int KPT = BK / LANES;          // keys per thread (scores)
    constexpr int G4 = DH / (4 * LANES);     // float4 groups per thread (acc)
    extern __shared__ float4 smem4[];
    float* sq = reinterpret_cast<float*>(smem4);
    float* sk = sq + BQ * LD;
    float* sv = sk + BK * LD;
    float* sp = sv + BK * LD;

    const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
    const int tid = threadIdx.x, r = tid / LANES, j = tid % LANES;
    const int q0 = blockIdx.x * BQ, qrow = q0 + r;
    const T* qb = q + b * st.qb + h * st.qh;
    const T* kb = k + b * st.kb + hk * st.kh;
    const T* vb = v + b * st.vb + hk * st.vh;

    // the query tile, scaled in f32 (rows past Sq are zeros, never stored)
    for (int idx = tid; idx < BQ * DH; idx += THREADS) {
        const int rr = idx / DH, d = idx % DH, qp = q0 + rr;
        sq[rr * LD + d] = qp < Sq ? to_f32(qb[qp * st.qs + d]) * scale : 0.f;
    }

    // key tiles [lo, hi): causal stops at the tile of the tile's last query;
    // a window skips the tiles left of it (the Pallas kernel's range, with
    // the last query in place of the first so that BK < BQ stays right)
    const int nk = (Sk + BK - 1) / BK;
    int hi = nk;
    if (causal) hi = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);
    int lo = 0;
    if (window > 0) lo = max(0, (q0 - window) / BK);

    float m_run = NEG, l_run = 0.f;
    float4 acc[G4];
#pragma unroll
    for (int g = 0; g < G4; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* qs = sq + r * LD;

    for (int kt = lo; kt < hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();        // the last tile's readers are done
        for (int idx = tid; idx < BK * DH; idx += THREADS) {
            const int kk = idx / DH, d = idx % DH, kp = k0 + kk;
            float kv = 0.f, vv = 0.f;
            if (kp < Sk) {
                kv = to_f32(kb[kp * st.ks + d]);
                vv = to_f32(vb[kp * st.vs + d]);
            }
            sk[kk * LD + d] = kv;
            sv[kk * LD + d] = vv;
        }
        __syncthreads();

        // scores of this thread's keys j, j + LANES, ...
        float s[KPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) s[i] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DH; d += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + d);
#pragma unroll
            for (int i = 0; i < KPT; ++i) {
                const float4 kv =
                    *reinterpret_cast<const float4*>(sk + (j + LANES * i) * LD + d);
                s[i] = fmaf(qv.x, kv.x, s[i]);
                s[i] = fmaf(qv.y, kv.y, s[i]);
                s[i] = fmaf(qv.z, kv.z, s[i]);
                s[i] = fmaf(qv.w, kv.w, s[i]);
            }
        }
        float tmax = NEG;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const int kp = k0 + j + LANES * i;
            bool ok = kp < Sk;
            if (causal) ok = ok && kp <= qrow;
            if (window > 0) ok = ok && kp > qrow - window;
            s[i] = ok ? s[i] : NEG;
            tmax = fmaxf(tmax, s[i]);
        }
        // the row's LANES threads are adjacent lanes of one warp
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m_run, tmax);
        const float alpha = expf(m_run - m_new);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const float pi = expf(s[i] - m_new);
            psum += pi;
            sp[r * PLD + j + LANES * i] = pi;
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l_run = l_run * alpha + psum;
        m_run = m_new;
        __syncwarp();           // the row's p are in shared memory

        // acc = acc * alpha + p @ v over this thread's head_dim columns
#pragma unroll
        for (int g = 0; g < G4; ++g) {
            acc[g].x *= alpha; acc[g].y *= alpha;
            acc[g].z *= alpha; acc[g].w *= alpha;
        }
        const float* ps = sp + r * PLD;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            const float pk = ps[kk];
            const float* vr = sv + kk * LD + 4 * j;
#pragma unroll
            for (int g = 0; g < G4; ++g) {
                const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * LANES * g);
                acc[g].x = fmaf(pk, vv.x, acc[g].x);
                acc[g].y = fmaf(pk, vv.y, acc[g].y);
                acc[g].z = fmaf(pk, vv.z, acc[g].z);
                acc[g].w = fmaf(pk, vv.w, acc[g].w);
            }
        }
    }

    if (qrow < Sq) {
        const float den = fmaxf(l_run, 1e-30f);
        T* orow = o + b * st.ob + qrow * st.os + h * st.oh + 4 * j;
#pragma unroll
        for (int g = 0; g < G4; ++g) {
            T* od = orow + 4 * LANES * g;
            od[0] = from_f32<T>(acc[g].x / den);
            od[1] = from_f32<T>(acc[g].y / den);
            od[2] = from_f32<T>(acc[g].z / den);
            od[3] = from_f32<T>(acc[g].w / den);
        }
    }
}

// Calls f(std::integral_constant<int, dh>{}) for a head dim in HEAD_DIMS:
// the one switch over dh, shared by every entry point.
template <typename F>
static int with_head_dim(int dh, F&& f) {
    switch (dh) {
        case 16: return f(std::integral_constant<int, 16>{});
        case 32: return f(std::integral_constant<int, 32>{});
        case 64: return f(std::integral_constant<int, 64>{});
        case 128: return f(std::integral_constant<int, 128>{});
        case 256: return f(std::integral_constant<int, 256>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

// Raises a kernel's dynamic shared memory limit to smem on the current
// device.  The attribute is per device, so `done` (one per kernel) keeps a
// bit for each device already raised; a device past 63 is raised every time.
template <typename Kernel>
static int allow_smem(Kernel kernel, int smem, std::atomic<unsigned long long>& done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (done.load(std::memory_order_relaxed) & bit) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    done.fetch_or(bit);
    return 0;
}

template <typename T, int DH>
static int launch_dh(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int Hkv, const Strides& st,
                     int causal, int window, float scale, cudaStream_t stream) {
    static std::atomic<unsigned long long> raised{0};
    constexpr int smem = Tile<DH>::SMEM;
    const int rc = allow_smem(flash_fwd_kernel<T, DH>, smem, raised);
    if (rc) return rc;
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Sq, Sk, H / Hkv, st, causal, window, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o, int B,
                  int Sq, int Sk, int H, int Hkv, int dh, const Strides& st,
                  int causal, int window, float scale, cudaStream_t stream) {
    return with_head_dim(dh, [&](auto d) {
        return launch_dh<T, decltype(d)::value>(q, k, v, o, B, Sq, Sk, H, Hkv, st,
                                                causal, window, scale, stream);
    });
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int WBQ = 64;                  // query rows per CTA
constexpr int WTHREADS = 128;            // one warpgroup
constexpr int CHUNK = 64;                // bf16 columns in a 128-byte row
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory (1024-byte aligned for the 128-byte swizzle): Q as NCH
// chunks of [WBQ][64], two K and two V buffers of NCH chunks of [BK][64],
// then the mbarriers full_k[2], full_v[2] and full_q.
template <int DH>
struct WTile {
    static constexpr int NCH = DH > CHUNK ? DH / CHUNK : 1;
    static constexpr int BK = DH == 256 ? 32 : 64;        // keys per tile
    static constexpr int KSTEPS = DH / 16;                // Q.K^T k-steps
    static constexpr int KK = BK / 16;                    // P.V k-steps
    static constexpr int Q_BYTES = NCH * WBQ * 128;
    static constexpr int KV_BYTES = NCH * BK * 128;       // one K or V tile
    static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES + 8 * 5;
    // CTAs per SM the registers are capped for: 4 at dh <= 64 (42 KB of
    // shared memory each); above, shared memory allows 2
    static constexpr int MIN_CTAS = DH <= 64 ? 4 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// One box of a 4-D tensor map {dh, heads, seq, batch} into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// ----- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets (16-byte units).  K-major tiles (Q, K):
// SBO = 1024 (8 rows of 128 bytes), LBO unused; a k-step of 16 columns
// adds 32 bytes to the start.  MN-major (V): SBO = 1024 (8 keys), LBO the
// stride between 64-column chunks.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(1024 >> 4) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// not move their uses across this point (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D[64 x N] += A[64 x 16] . B[16 x N], A and B K-major in shared memory.
template <int N> __device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
        "},\n"
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n"
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15"
        "},\n"
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A (bf16 pairs) in registers in the
// accumulator's layout, B MN-major in shared memory (transposed: tnspB = 1).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
        "},\n"
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The two bf16 of a pair as one register, .x in the low half.
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(v.x))
         | static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16;
}

// Shared-memory addresses of one CTA's buffers and barriers.  Tile i of
// the key range uses K and V buffers i % 2 and their full barriers, whose
// phase for tile i has parity (i / 2) % 2.
template <int DH>
struct Smem {
    using W = WTile<DH>;
    uint32_t q, k, v, bars;
    __device__ explicit Smem(const uint8_t* raw) {
        q = (smem_u32(raw) + 1023) & ~1023u;
        k = q + W::Q_BYTES;
        v = k + 2 * W::KV_BYTES;
        bars = v + 2 * W::KV_BYTES;
    }
    __device__ uint32_t kbuf(int i) const { return k + (i & 1) * W::KV_BYTES; }
    __device__ uint32_t vbuf(int i) const { return v + (i & 1) * W::KV_BYTES; }
    __device__ uint32_t full_k(int i) const { return bars + 8 * (i & 1); }
    __device__ uint32_t full_v(int i) const { return bars + 16 + 8 * (i & 1); }
    __device__ uint32_t full_q() const { return bars + 32; }
};

__device__ __forceinline__ uint32_t parity(int i) { return (i >> 1) & 1; }

// One K or V tile (NCH boxes of [BK keys][64 columns]) into `buf`.
template <int DH>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t buf, uint32_t bar,
                                          int k0, int hk, int b) {
    using W = WTile<DH>;
    mbar_expect_tx(bar, W::KV_BYTES);
    for (int c = 0; c < W::NCH; ++c)
        tma_load(buf + c * W::BK * 128, map, bar, c * CHUNK, hk, k0, b);
}

// Issue S = Q . K^T into `sc` (one committed group).
template <int DH>
__device__ __forceinline__ void issue_qk(float (&sc)[WTile<DH>::BK / 2], uint32_t sq,
                                        uint32_t kb) {
    using W = WTile<DH>;
#pragma unroll
    for (int i = 0; i < W::BK / 2; ++i) sc[i] = 0.f;
    pin(sc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < W::KSTEPS; ++ks) {
        const uint32_t chunk = ks / 4, off = (ks % 4) * 32;
        mma_ss<W::BK>(sc, desc(sq + chunk * WBQ * 128 + off, 16),
                      desc(kb + chunk * W::BK * 128 + off, 16));
    }
    wg_commit();
}

// Issue O += P_hi . V + P_lo . V (one committed group).
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[WTile<DH>::NCH][32],
                                        uint32_t (&p_hi)[WTile<DH>::KK][4],
                                        uint32_t (&p_lo)[WTile<DH>::KK][4], uint32_t vb) {
    using W = WTile<DH>;
#pragma unroll
    for (int c = 0; c < W::NCH; ++c) pin(acc[c]);
#pragma unroll
    for (int kk = 0; kk < W::KK; ++kk) { pin(p_hi[kk]); pin(p_lo[kk]); }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < W::KK; ++kk) {
#pragma unroll
        for (int c = 0; c < W::NCH; ++c) {
            const uint64_t dv = desc(vb + c * W::BK * 128 + kk * 16 * 128, W::BK * 128);
            mma_rs(acc[c], p_hi[kk], dv);
            mma_rs(acc[c], p_lo[kk], dv);
        }
    }
    wg_commit();
}

// After the P.V group has landed: its registers are free again.
template <int DH>
__device__ __forceinline__ void pv_done(float (&acc)[WTile<DH>::NCH][32],
                                       uint32_t (&p_hi)[WTile<DH>::KK][4],
                                       uint32_t (&p_lo)[WTile<DH>::KK][4]) {
#pragma unroll
    for (int c = 0; c < WTile<DH>::NCH; ++c) pin(acc[c]);
#pragma unroll
    for (int kk = 0; kk < WTile<DH>::KK; ++kk) { pin(p_hi[kk]); pin(p_lo[kk]); }
}

template <int DH>
__device__ __forceinline__ void rescale(float (&acc)[WTile<DH>::NCH][32], const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < WTile<DH>::NCH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
}

// Online softmax of one tile of scores, in place: sc holds raw Q.K^T on
// entry and p on exit.  The thread holds rows r0 and r0 + 8 and, of each
// 8-column group j, columns 8j + 2t and 8j + 2t + 1 (register 4j + 2 r + e).
// Units are y = s * log2(e), so p = 2^(y - m); scale_log2 turns a raw score
// into y.  Masks only on edge tiles, where a masked y is NEG and
// p = 2^(y - m) keeps the sentinel's meaning (1 while m is NEG, else 0);
// elsewhere p = 2^(fma(raw, scale_log2, -m)).  l sums this thread's columns.
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m_run)[2],
                                        float (&l_run)[2], float (&alpha)[2], bool edge,
                                        int k0, int r0, int t, int Sk, int causal,
                                        int window, float scale_log2) {
    float mx[2] = {m_run[0], m_run[1]};
    if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            const int r = (i >> 1) & 1;
            const int row = r0 + 8 * r;
            const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            bool ok = key < Sk;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && key > row - window;
            sc[i] = ok ? sc[i] * scale_log2 : NEG;
            mx[r] = fmaxf(mx[r], sc[i]);
        }
    } else {
        float raw[2] = {sc[0], sc[2]};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], raw[r] * scale_log2);
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m_run[r] - mx[r]);
        m_run[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = edge ? ex2(sc[i] - mx[r]) : ex2(fmaf(sc[i], scale_log2, -mx[r]));
        psum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
}

// p split into bf16 hi and lo in the A operand's register layout: register
// e of k-step kk holds accumulator columns 8kk + 2e and 8kk + 2e + 1.
template <int KK>
__device__ __forceinline__ void split(const float (&p)[8 * KK], uint32_t (&p_hi)[KK][4],
                                      uint32_t (&p_lo)[KK][4]) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p0 = p[8 * kk + 2 * e], p1 = p[8 * kk + 2 * e + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
            const float2 back = __bfloat1622float2(hi);
            p_hi[kk][e] = bits(hi);
            p_lo[kk][e] = bits(__floats2bfloat162_rn(p0 - back.x, p1 - back.y));
        }
    }
}

// One warpgroup per CTA.  Thread 0 issues every TMA load; each buffer is
// refilled as soon as the wgmma group that reads it has landed.  Tile i's
// S = Q.K^T and tile i-1's P.V are in flight together while the softmax of
// tile i runs on the CUDA cores (FlashAttention-3's intra-warpgroup overlap).
template <int DH>
__global__ void __launch_bounds__(WTHREADS, WTile<DH>::MIN_CTAS) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
    const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int group, long long ob, long long os, long long oh,
    int causal, int window, float scale) {
    using W = WTile<DH>;
    constexpr int BK = W::BK, NCH = W::NCH, KK = W::KK;
    extern __shared__ uint8_t smem_raw[];
    const Smem<DH> sm(smem_raw);

    const int q0 = (gridDim.x - 1 - blockIdx.x) * WBQ;   // longest rows first
    const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
    // key tiles [lo, lo + n), as the SIMT kernel
    const int nk = (Sk + BK - 1) / BK;
    int hi = nk;
    if (causal) hi = min(nk, (min(q0 + WBQ, Sq) - 1) / BK + 1);
    int lo = 0;
    if (window > 0) lo = max(0, (q0 - window) / BK);
    const int n = hi - lo;
    const bool leader = threadIdx.x == 0;
    auto key0 = [&](int i) { return (lo + i) * BK; };
    // a tile needs masks if it crosses Sk, the diagonal or the window's edge
    auto edge = [&](int i) {
        const int k0 = key0(i);
        return k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
               (window > 0 && k0 <= q0 + WBQ - 1 - window);
    };

    if (leader) {
        for (int i = 0; i < 5; ++i) mbar_init(sm.bars + 8 * i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (leader) {
        mbar_expect_tx(sm.full_q(), W::Q_BYTES);
        for (int c = 0; c < NCH; ++c)
            tma_load(sm.q + c * WBQ * 128, &tmq, sm.full_q(), c * CHUNK, h, q0, b);
        for (int i = 0; i < 2 && i < n; ++i) {
            load_tile<DH>(&tmk, sm.kbuf(i), sm.full_k(i), key0(i), hk, b);
            load_tile<DH>(&tmv, sm.vbuf(i), sm.full_v(i), key0(i), hk, b);
        }
    }
    __syncwarp();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + 16 * warp + g;
    const float scale_log2 = scale * LOG2E;
    float acc[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f}, alpha[2];
    float sc[BK / 2];
    uint32_t p_hi[KK][4], p_lo[KK][4];

    mbar_wait(sm.full_q(), 0);
    if (n > 0) {                                          // tile 0: S only
        mbar_wait(sm.full_k(0), 0);
        issue_qk<DH>(sc, sm.q, sm.kbuf(0));
        wg_wait<0>();
        pin(sc);
        if (leader && n > 2) load_tile<DH>(&tmk, sm.kbuf(0), sm.full_k(0), key0(2), hk, b);
        __syncwarp();
        softmax<BK>(sc, m_run, l_run, alpha, edge(0), key0(0), r0, t, Sk, causal, window,
                    scale_log2);
        split<KK>(sc, p_hi, p_lo);
    }
    for (int i = 1; i < n; ++i) {
        mbar_wait(sm.full_k(i), parity(i));
        issue_qk<DH>(sc, sm.q, sm.kbuf(i));              // S_i
        rescale<DH>(acc, alpha);                          // by tile i-1's alpha
        mbar_wait(sm.full_v(i - 1), parity(i - 1));
        issue_pv<DH>(acc, p_hi, p_lo, sm.vbuf(i - 1));  // O += P_{i-1} V_{i-1}
        wg_wait<1>();                                     // S_i has landed
        pin(sc);
        if (leader && i + 2 < n) load_tile<DH>(&tmk, sm.kbuf(i), sm.full_k(i), key0(i + 2), hk, b);
        __syncwarp();
        softmax<BK>(sc, m_run, l_run, alpha, edge(i), key0(i), r0, t, Sk, causal, window,
                    scale_log2);
        wg_wait<0>();                                     // P_{i-1} V_{i-1} has landed
        pv_done<DH>(acc, p_hi, p_lo);
        if (leader && i + 1 < n) load_tile<DH>(&tmv, sm.vbuf(i + 1), sm.full_v(i + 1), key0(i + 1), hk, b);
        __syncwarp();
        split<KK>(sc, p_hi, p_lo);
    }
    if (n > 0) {                                          // the last tile's P.V
        rescale<DH>(acc, alpha);
        mbar_wait(sm.full_v(n - 1), parity(n - 1));
        issue_pv<DH>(acc, p_hi, p_lo, sm.vbuf(n - 1));
        wg_wait<0>();
        pv_done<DH>(acc, p_hi, p_lo);
    }

    // out = acc / max(l, 1e-30): l sums over the quad's columns
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        den[r] = fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= Sq) continue;
        __nv_bfloat16* orow = o + b * ob + row * os + h * oh;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = c * CHUNK + 8 * j + 2 * t;
                if (col >= DH) continue;
                const __nv_bfloat162 v2 = __halves2bfloat162(
                    __float2bfloat16_rn(acc[c][4 * j + 2 * r] / den[r]),
                    __float2bfloat16_rn(acc[c][4 * j + 2 * r + 1] / den[r]));
                *reinterpret_cast<__nv_bfloat162*>(orow + col) = v2;
            }
        }
    }
}

// ----- host side: tensor maps, launch

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Errors of the tensor-map encoding are returned as TENSOR_MAP_ERROR + the
// CUresult (TENSOR_MAP_ERROR alone: the driver has no cuTensorMapEncodeTiled).
constexpr int TENSOR_MAP_ERROR = 100000;

static EncodeTiled encode_fn() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
        if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    }
    return fn;
}

// A tensor map over [B, S, heads, dh] bf16 with element strides (sb, ss,
// sh), boxes of {64 columns, 1 head, rows, 1 batch}.  A dimension of size 1
// is never stepped, so its stride is replaced by an aligned one.
static int encode(CUtensorMap* map, const void* ptr, int dh, int heads, int S, int B,
                  long long sh, long long ss, long long sb, int rows) {
    EncodeTiled fn = encode_fn();
    if (!fn) return TENSOR_MAP_ERROR;
    const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
    const long long el[3] = {sh, ss, sb};
    cuuint64_t strides[3];
    cuuint64_t inner = (cuuint64_t)dh * 2;
    for (int i = 0; i < 3; ++i) {
        strides[i] = dims[i + 1] > 1 ? (cuuint64_t)el[i] * 2 : (inner + 15) / 16 * 16;
        inner = strides[i] * dims[i + 1];
    }
    const cuuint32_t box[4] = {(cuuint32_t)CHUNK, 1, (cuuint32_t)rows, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                          dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// Raise the kernel's dynamic shared memory limit on the current device.
template <int DH>
static int configure() {
    static std::atomic<unsigned long long> raised{0};
    return allow_smem(flash_fwd_wgmma_kernel<DH>, WTile<DH>::SMEM, raised);
}

template <int DH>
static int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int H, int Hkv, const Strides& st, int causal,
                     int window, float scale, cudaStream_t stream) {
    using W = WTile<DH>;
    CUtensorMap tq, tk, tv;
    int rc = configure<DH>();
    if (!rc) rc = encode(&tq, q, DH, H, Sq, B, st.qh, st.qs, st.qb, WBQ);
    if (!rc) rc = encode(&tk, k, DH, Hkv, Sk, B, st.kh, st.ks, st.kb, W::BK);
    if (!rc) rc = encode(&tv, v, DH, Hkv, Sk, B, st.vh, st.vs, st.vb, W::BK);
    if (rc) return rc;
    const dim3 grid((Sq + WBQ - 1) / WBQ, H, B);
    flash_fwd_wgmma_kernel<DH><<<grid, WTHREADS, W::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H / Hkv, st.ob, st.os, st.oh,
        causal, window, scale);
    return (int)cudaGetLastError();
}

static int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                  int Sk, int H, int Hkv, int dh, const Strides& st, int causal,
                  int window, float scale, cudaStream_t stream) {
    return with_head_dim(dh, [&](auto d) {
        return launch_dh<decltype(d)::value>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal,
                                             window, scale, stream);
    });
}

template <int DH>
static int config_dh(int* smem, int* ctas_per_sm) {
    *smem = WTile<DH>::SMEM;
    const int rc = configure<DH>();
    if (rc) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, flash_fwd_wgmma_kernel<DH>, WTHREADS, WTile<DH>::SMEM);
}

static int config(int dh, int* smem, int* ctas_per_sm) {
    return with_head_dim(dh, [&](auto d) {
        return config_dh<decltype(d)::value>(smem, ctas_per_sm);
    });
}

}  // namespace hopper

// C entry points (ctypes).  Strides are in elements: (batch, seq, head) of
// q, k, v and out in that order.  window <= 0 means none.  They return
// cudaGetLastError() after the launch, or hopper::TENSOR_MAP_ERROR + the
// driver's error when a bf16 tensor map cannot be built.
#define FLASH_ENTRY(NAME, LAUNCH)                                                  \
    extern "C" int NAME(const void* q, const void* k, const void* v, void* o,     \
                        int B, int Sq, int Sk, int H, int Hkv, int dh,            \
                        long long qb, long long qs, long long qh, long long kb,   \
                        long long ks, long long kh, long long vb, long long vs,   \
                        long long vh, long long ob, long long os, long long oh,   \
                        int causal, int window, float scale, cudaStream_t stream) { \
        const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};         \
        return LAUNCH(q, k, v, o, B, Sq, Sk, H, Hkv, dh, st, causal, window,      \
                      scale, stream);                                             \
    }

FLASH_ENTRY(flash_fwd_f32, launch<float>)
FLASH_ENTRY(flash_fwd_bf16, hopper::launch)

// The bf16 kernel's launch configuration for head dim dh (no launch): its
// dynamic shared memory in bytes and how many of its CTAs fit on one SM.
extern "C" int flash_bf16_config(int dh, int* smem, int* ctas_per_sm) {
    return hopper::config(dh, smem, ctas_per_sm);
}
