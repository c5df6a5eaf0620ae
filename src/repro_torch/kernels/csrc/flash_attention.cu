// flash_attention.cu — FlashAttention-2 forward (causal / sliding window /
// GQA) for the LM's prefill, f32 or bf16 in, f32 online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention ->
// _flash_kernel (the TPU Pallas kernel, a (batch, q_heads, q_blocks) grid of
// 128 x 128 VMEM tiles).
//
// What it computes, for every (b, h, query row i):
//   out[b,i,h,:] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,h/g,:]) v[b,j,h/g,:]
// over the keys j that are not masked: j < Sk, and j <= i when causal, and
// j > i - window when a window is given (g = H / Hkv, scale = 1/sqrt(dh)
// applied to q in f32).  Masked scores are -2e38 (NEG), as in the JAX
// package.  The key tiles outside the mask's range are skipped, not merely
// masked: causal stops at the tile holding the tile's last query, and a
// window starts at tile (q0 - window) / BK (flash_attention.py:77-80).
// out = acc / max(l, 1e-30), cast to q's dtype.  Causal masking takes
// query 0 to sit at key 0; the wrapper refuses causal with Sq != Sk.
//
// Numerics: every product and sum in f32 (bf16 inputs widened with
// __bfloat162float); fmaf is written out (the build passes --fmad=false for
// the tree kernels' exactness, which would otherwise split these into
// separate multiplies and adds); expf, not __expf; no fast math.  The sums
// run in another order than the TPU's 128-blocks, so the kernel agrees
// with its plain version to the JAX test's tolerances (f32 2e-5, bf16
// 2e-2), not bit for bit.  A row whose first tiles are all masked carries
// m = NEG and exp(0) = 1 weights until its first real key, whose
// alpha = exp(NEG - m) = 0 wipes them, as in the Pallas kernel.
//
// What bounds it on the H100: operations.  4 * B * H * Sq * Sk * dh FLOPs
// (halved when causal) against 989 TFLOP/s on bf16 tensor cores (the
// llama3.2-1b prefill at B=16, S=2048: 2.75e11 FLOPs, 0.278 ms), or 67
// TFLOP/s for f32 SIMT, which is what this first design runs on: the bytes
// (q, k, v read once, out written once: 335 MB at that shape, 0.100 ms)
// are not the limit.  The design does nothing about the tensor cores yet:
// it is SIMT (one block per (b, h, 64-query tile), 4 threads per query row,
// K/V tiles staged in shared memory as f32).  wgmma, TMA and warp
// specialisation are the work of the PR that makes it fast.
//
// Layout: q [B,Sq,H,dh], k/v [B,Sk,Hkv,dh], out [B,Sq,H,dh], read and
// written through their element strides (the head_dim axis contiguous).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG (-2.0e38f)

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

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

template <typename T, int DH>
static int launch_dh(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int Hkv, const Strides& st,
                     int causal, int window, float scale, cudaStream_t stream) {
    static bool configured = false;
    constexpr int smem = Tile<DH>::SMEM;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
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
    switch (dh) {
        case 16: return launch_dh<T, 16>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, scale, stream);
        case 32: return launch_dh<T, 32>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, scale, stream);
        case 64: return launch_dh<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, scale, stream);
        case 128: return launch_dh<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, scale, stream);
        case 256: return launch_dh<T, 256>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// C entry points (ctypes).  Strides are in elements: (batch, seq, head) of
// q, k, v and out in that order.  window <= 0 means none.  They return
// cudaGetLastError() after the launch.
#define FLASH_ENTRY(NAME, T)                                                       \
    extern "C" int NAME(const void* q, const void* k, const void* v, void* o,     \
                        int B, int Sq, int Sk, int H, int Hkv, int dh,            \
                        long long qb, long long qs, long long qh, long long kb,   \
                        long long ks, long long kh, long long vb, long long vs,   \
                        long long vh, long long ob, long long os, long long oh,   \
                        int causal, int window, float scale, cudaStream_t stream) { \
        const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};         \
        return launch<T>(q, k, v, o, B, Sq, Sk, H, Hkv, dh, st, causal, window,   \
                         scale, stream);                                          \
    }

FLASH_ENTRY(flash_fwd_f32, float)
FLASH_ENTRY(flash_fwd_bf16, __nv_bfloat16)
