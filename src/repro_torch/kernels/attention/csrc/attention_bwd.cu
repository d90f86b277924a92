// Flash attention backward on Hopper (sm_90a), plain float32 FMAs: the
// route for float32 and for dh 32 (`plan_bwd` in ../kernel.py); bf16 at
// dh 64 and 128 runs the tensor-core kernels of attention_bwd_tc.cu, which
// call this file's pre-pass (`flash_bwd_pre_launch`). TF32 would not meet
// float32's 1e-4, the reason the forward keeps `flash_fwd_f32`. Plain C
// interface, loaded with ctypes by ../../_build.py beside attention.cu; the
// wrapper, its launch counters and the torch.autograd.Function that pairs
// it with the forward kernel live in ../kernel.py and ../ops.py, the plain
// PyTorch version in ../ref.py (`attention_bwd_ref`).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and
// differentiates `blockwise_attention` (src/repro/models/blocks.py:76)
// with XLA. The port's forward is a hand-written kernel that autograd
// cannot see through, so training needs this one. It computes, for the
// forward's function (layout q, o, dO (B, S, H, dh), k, v (B, T, KV, dh);
// query head h reads KV head h / (H / KV); the forward's masks: key
// position >= 0, causal, window; positions shared or one row a batch
// row), with P = softmax(q·k^T / sqrt(dh)) over the allowed keys:
//   dV = P^T·dO, dP = dO·V^T, dS = P ∘ (dP - Δ), Δ = rowsum(dO ∘ O),
//   dQ = dS·K / sqrt(dh), dK = dS^T·Q / sqrt(dh),
// dK and dV summed over the g = H / KV query heads of each KV head. A
// query row with no allowed key (the forward gives it zeros) gets zeros.
//
// Bound: operations. The least work is 5 products of 2·dh flops for each
// (query, key, head) that may attend (the scores again, dP, dV, dK, dQ): at
// (2, 4096, 64/8, 128) causal 1.37e12 flops, 1.39 ms at 989 TFLOP/s bf16,
// against about 0.1 ms of bytes. This kernel does 8 (the pre-pass's
// scores, and the scores and dP again in the dQ pass).
//
// Design: three launches, no float atomics (a resumed run can be compared
// bit for bit), fp32 arithmetic on plain FMAs (inputs converted from bf16
// as they are staged in shared memory, rows padded by 4 floats so 16-byte
// loads from different rows hit different banks), outputs in the inputs'
// dtype. Each thread holds a small block in registers: 2 x 2 of the
// scores (and of dP), 4 keys x 4 columns of dK and dV, 4 rows x 4
// columns of dQ, so one 16-byte shared load feeds 4 to 8 FMAs.
//   bwd_pre: one block a (b, head, 32-query tile): Δ, and each row's
//     log-sum-exp recomputed over its allowed keys unless the forward's is
//     given (lse_ready: the bf16 prefill kernel writes it).
//   bwd_dkdv: one block a (b, KV head, 32-key tile): loops over the g heads
//     and over the 32-query tiles whose positions can see the tile,
//     recomputes P and dS in shared memory, and accumulates dK and dV in
//     registers.
//   bwd_dq: one block a (b, head, 32-query tile): loops over the key tiles
//     it can see, accumulates dQ.
// Tiles that no pair may attend to are skipped from the tiles' position
// ranges, so positions need not be sorted.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int B_THREADS = 256;
constexpr int BM = 32;               // query rows a tile
constexpr int BN = 32;               // keys a tile
constexpr int PS = BN + 4;           // P / dS row pitch (floats)

struct BwdArgs {
    const void* q;                   // (B, S, H, dh)
    const void* k;                   // (B, T, KV, dh)
    const void* v;
    const void* o;                   // (B, S, H, dh)
    const void* dout;
    void* dq;
    void* dk;
    void* dv;
    float* lse;                      // (B, S, H) scratch
    float* delta;                    // (B, S, H) scratch
    const int* qpos;                 // (S,)/(B, S) or null: arange(S) + T - S
    const int* kpos;                 // (T,)/(B, T) or null: arange(T)
    int qpos_bs, kpos_bs;
    int B, S, T, H, KV, causal, window;
    float scale;                     // 1 / sqrt(dh)
    int lse_ready;                   // lse holds the forward's
};

// four consecutive elements as floats (8-byte bf16 or 16-byte float loads)
__device__ __forceinline__ float4 ld4(const float* p, size_t i) {
    return *reinterpret_cast<const float4*>(p + i);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, size_t i) {
    const uint2 w = *reinterpret_cast<const uint2*>(p + i);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st4(float* p, size_t i, float4 x) {
    *reinterpret_cast<float4*>(p + i) = x;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, size_t i, float4 x) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p + i) = w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// INT_MIN past the end: a row or key that is not there
__device__ __forceinline__ int q_position(const BwdArgs& a, int b, int s) {
    if (s >= a.S) return INT_MIN;
    return a.qpos ? a.qpos[(size_t)b * a.qpos_bs + s] : s + a.T - a.S;
}

__device__ __forceinline__ int k_position(const BwdArgs& a, int b, int t) {
    if (t >= a.T) return INT_MIN;
    return a.kpos ? a.kpos[(size_t)b * a.kpos_bs + t] : t;
}

__device__ __forceinline__ bool allowed(const BwdArgs& a, int qp, int kp) {
    return qp != INT_MIN && kp >= 0 && (!a.causal || qp >= kp) &&
           (a.window <= 0 || (long long)qp - kp < a.window);
}

// May some query position in [qmin, qmax] attend to some key position in
// [kmin, kmax] (valid keys only; kmin > kmax: none)?
__device__ __forceinline__ bool tiles_meet(const BwdArgs& a, int qmin,
                                           int qmax, int kmin, int kmax) {
    if (kmin > kmax || qmin > qmax) return false;
    if (a.causal && kmin > qmax) return false;
    if (a.window > 0 && (long long)qmin - kmax >= a.window) return false;
    return true;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
    return x;
}

// over the 16 lanes of a half-warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
    for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
    return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
    for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
    return x;
}

// [lo, hi] of the valid positions in pos[0, n) (n <= 32), by warp 0;
// INT_MAX / INT_MIN when none. The caller syncs.
__device__ __forceinline__ void range32(const int* pos, int n, bool keys,
                                        int* lo, int* hi) {
    if (threadIdx.x < 32) {
        const int p = threadIdx.x < n ? pos[threadIdx.x] : INT_MIN;
        const bool ok = keys ? p >= 0 : p != INT_MIN;
        int mn = ok ? p : INT_MAX, mx = ok ? p : INT_MIN;
#pragma unroll
        for (int o = 16; o; o >>= 1) {
            mn = min(mn, __shfl_xor_sync(~0u, mn, o));
            mx = max(mx, __shfl_xor_sync(~0u, mx, o));
        }
        if (threadIdx.x == 0) { *lo = mn; *hi = mx; }
    }
}

// rows [s0, s0 + BM) of head h into dst (BM x (DH + 4) floats), zeros past S
template <int DH, typename T>
__device__ void load_rows(const BwdArgs& a, const T* src, float* dst, int b,
                          int h, int s0) {
    constexpr int PD = DH + 4;
    for (int i = threadIdx.x; i < BM * DH / 4; i += B_THREADS) {
        const int r = i / (DH / 4), d = 4 * (i % (DH / 4)), s = s0 + r;
        const float4 x = s < a.S
            ? ld4(src, (((size_t)b * a.S + s) * a.H + h) * DH + d)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dst + r * PD + d) = x;
    }
}

// keys [t0, t0 + BN) of KV head kvh into dst (BN x (DH + 4)), zeros past T
template <int DH, typename T>
__device__ void load_keys(const BwdArgs& a, const T* src, float* dst, int b,
                          int kvh, int t0) {
    constexpr int PD = DH + 4;
    for (int i = threadIdx.x; i < BN * DH / 4; i += B_THREADS) {
        const int c = i / (DH / 4), d = 4 * (i % (DH / 4)), t = t0 + c;
        const float4 x = t < a.T
            ? ld4(src, (((size_t)b * a.T + t) * a.KV + kvh) * DH + d)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dst + c * PD + d) = x;
    }
}

// S = Q·K^T (and dP = dO·V^T when DP) for this thread's 2 x 2 entries:
// rows rq and rq + 16, keys cq and cq + 16 (rq = tid / 16, cq = tid % 16)
template <int DH, bool DP>
__device__ __forceinline__ void products(const float* Qs, const float* Ks,
                                         const float* dOs, const float* Vs,
                                         float (&s)[2][2], float (&dp)[2][2]) {
    constexpr int PD = DH + 4;
    const int rq = threadIdx.x >> 4, cq = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
        const float4 q0 = ld4(Qs, rq * PD + d), q1 = ld4(Qs, (rq + 16) * PD + d);
        const float4 k0 = ld4(Ks, cq * PD + d), k1 = ld4(Ks, (cq + 16) * PD + d);
        s[0][0] = dot4(q0, k0, s[0][0]);
        s[0][1] = dot4(q0, k1, s[0][1]);
        s[1][0] = dot4(q1, k0, s[1][0]);
        s[1][1] = dot4(q1, k1, s[1][1]);
        if (DP) {
            const float4 o0 = ld4(dOs, rq * PD + d);
            const float4 o1 = ld4(dOs, (rq + 16) * PD + d);
            const float4 v0 = ld4(Vs, cq * PD + d);
            const float4 v1 = ld4(Vs, (cq + 16) * PD + d);
            dp[0][0] = dot4(o0, v0, dp[0][0]);
            dp[0][1] = dot4(o0, v1, dp[0][1]);
            dp[1][0] = dot4(o1, v0, dp[1][0]);
            dp[1][1] = dot4(o1, v1, dp[1][1]);
        }
    }
}

// P and dS of this thread's 2 x 2 entries into Ps / dSs (BM x PS), and dS
// transposed into dSt (BN x (BM + 4)) when given
template <int DH>
__device__ __forceinline__ void probs(const BwdArgs& a, const float* Qs,
                                      const float* dOs, const float* Ks,
                                      const float* Vs, const float* lse_s,
                                      const float* dl_s, const int* qp_s,
                                      const int* kp_s, float* Ps, float* dSs,
                                      float* dSt) {
    float s[2][2], dp[2][2];
    products<DH, true>(Qs, Ks, dOs, Vs, s, dp);
    const int rq = threadIdx.x >> 4, cq = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = rq + 16 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int c = cq + 16 * j;
            float p = 0.f, ds = 0.f;
            if (allowed(a, qp_s[r], kp_s[c])) {
                p = expf(s[i][j] * a.scale - lse_s[r]);
                ds = p * (dp[i][j] - dl_s[r]);
            }
            if (Ps) Ps[r * PS + c] = p;
            if (dSs) dSs[r * PS + c] = ds;
            if (dSt) dSt[c * (BM + 4) + r] = ds;
        }
    }
}

// ---------------------------------------------------------------- bwd_pre
template <int DH, typename T>
__global__ void __launch_bounds__(B_THREADS)
bwd_pre(const BwdArgs a) {
    constexpr int PD = DH + 4;
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;                        // BM x PD
    float* Ks = Qs + BM * PD;                // BN x PD
    __shared__ int qp_s[BM], kp_s[BN];
    __shared__ int q_lo, q_hi, k_lo, k_hi;
    const int s0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (a.H / a.KV);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    // Δ: a warp a row, four columns a lane
    for (int r = warp; r < BM; r += B_THREADS / 32) {
        const int s = s0 + r;
        if (s >= a.S) continue;
        const size_t base = (((size_t)b * a.S + s) * a.H + h) * DH;
        float x = 0.f;
        for (int d = 4 * lane; d < DH; d += 128)
            x = dot4(ld4(static_cast<const T*>(a.dout), base + d),
                     ld4(static_cast<const T*>(a.o), base + d), x);
        x = warp_sum(x);
        if (lane == 0) a.delta[((size_t)b * a.S + s) * a.H + h] = x;
    }
    if (a.lse_ready) return;

    load_rows<DH>(a, static_cast<const T*>(a.q), Qs, b, h, s0);
    if (threadIdx.x < BM) qp_s[threadIdx.x] = q_position(a, b, s0 + threadIdx.x);
    __syncthreads();
    range32(qp_s, BM, false, &q_lo, &q_hi);
    const int rq = threadIdx.x >> 4, cq = threadIdx.x & 15;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int t0 = 0; t0 < a.T; t0 += BN) {
        __syncthreads();
        if (threadIdx.x < BN) kp_s[threadIdx.x] = k_position(a, b, t0 + threadIdx.x);
        __syncthreads();
        range32(kp_s, BN, true, &k_lo, &k_hi);
        __syncthreads();
        if (!tiles_meet(a, q_lo, q_hi, k_lo, k_hi)) continue;
        load_keys<DH>(a, static_cast<const T*>(a.k), Ks, b, kvh, t0);
        __syncthreads();
        float s[2][2], unused[2][2];
        products<DH, false>(Qs, Ks, nullptr, nullptr, s, unused);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int qp = qp_s[rq + 16 * i];
            const bool ok0 = allowed(a, qp, kp_s[cq]);
            const bool ok1 = allowed(a, qp, kp_s[cq + 16]);
            const float s0v = ok0 ? s[i][0] * a.scale : -INFINITY;
            const float s1v = ok1 ? s[i][1] * a.scale : -INFINITY;
            // every lane shuffles; a row with no allowed key yet keeps
            // m = -inf and adds nothing
            const float mx = fmaxf(m[i], half_max(fmaxf(s0v, s1v)));
            const float add = half_sum((ok0 ? expf(s0v - mx) : 0.f)
                                       + (ok1 ? expf(s1v - mx) : 0.f));
            if (mx != -INFINITY) {
                l[i] = l[i] * (m[i] == -INFINITY ? 0.f : expf(m[i] - mx))
                       + add;
                m[i] = mx;
            }
        }
    }
    if (cq == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int s = s0 + rq + 16 * i;
            if (s < a.S)
                a.lse[((size_t)b * a.S + s) * a.H + h] =
                    l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
        }
    }
}

// --------------------------------------------------------------- bwd_dkdv
template <int DH, typename T>
__global__ void __launch_bounds__(B_THREADS)
bwd_dkdv(const BwdArgs a) {
    constexpr int PD = DH + 4;
    constexpr int CP = BN * DH / (4 * B_THREADS);   // keys a thread: 4, 2, 1
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;
    float* Vs = Ks + BN * PD;
    float* Qs = Vs + BN * PD;
    float* dOs = Qs + BM * PD;
    float* Ps = dOs + BM * PD;               // BM x PS
    float* dSs = Ps + BM * PS;
    __shared__ float lse_s[BM], dl_s[BM];
    __shared__ int qp_s[BM], kp_s[BN];
    __shared__ int q_lo, q_hi, k_lo, k_hi;
    const int t0 = blockIdx.x * BN, kvh = blockIdx.y, b = blockIdx.z;
    const int g = a.H / a.KV;
    // this thread's dK / dV block: keys c0 .. c0 + CP - 1, columns d0 .. + 3
    const int d0 = 4 * (threadIdx.x % (DH / 4));
    const int c0 = CP * (threadIdx.x / (DH / 4));

    if (threadIdx.x < BN) kp_s[threadIdx.x] = k_position(a, b, t0 + threadIdx.x);
    load_keys<DH>(a, static_cast<const T*>(a.k), Ks, b, kvh, t0);
    load_keys<DH>(a, static_cast<const T*>(a.v), Vs, b, kvh, t0);
    __syncthreads();
    range32(kp_s, BN, true, &k_lo, &k_hi);

    float dk[CP][4], dv[CP][4];
#pragma unroll
    for (int i = 0; i < CP; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) { dk[i][e] = 0.f; dv[i][e] = 0.f; }

    for (int j = 0; j < g; ++j) {
        const int h = kvh * g + j;
        for (int s0 = 0; s0 < a.S; s0 += BM) {
            __syncthreads();                 // last tile consumed
            if (threadIdx.x < BM) {
                const int s = s0 + threadIdx.x;
                qp_s[threadIdx.x] = q_position(a, b, s);
                const size_t at = ((size_t)b * a.S + s) * a.H + h;
                lse_s[threadIdx.x] = s < a.S ? a.lse[at] : INFINITY;
                dl_s[threadIdx.x] = s < a.S ? a.delta[at] : 0.f;
            }
            __syncthreads();
            range32(qp_s, BM, false, &q_lo, &q_hi);
            __syncthreads();
            if (!tiles_meet(a, q_lo, q_hi, k_lo, k_hi)) continue;
            load_rows<DH>(a, static_cast<const T*>(a.q), Qs, b, h, s0);
            load_rows<DH>(a, static_cast<const T*>(a.dout), dOs, b, h, s0);
            __syncthreads();
            probs<DH>(a, Qs, dOs, Ks, Vs, lse_s, dl_s, qp_s, kp_s, Ps, dSs,
                      nullptr);
            __syncthreads();
#pragma unroll 4
            for (int r = 0; r < BM; ++r) {
                const float4 o = ld4(dOs, r * PD + d0);
                const float4 q = ld4(Qs, r * PD + d0);
                float p[CP], ds[CP];
#pragma unroll
                for (int i = 0; i < CP; ++i) {
                    p[i] = Ps[r * PS + c0 + i];
                    ds[i] = dSs[r * PS + c0 + i];
                }
#pragma unroll
                for (int i = 0; i < CP; ++i) {
                    dv[i][0] = fmaf(p[i], o.x, dv[i][0]);
                    dv[i][1] = fmaf(p[i], o.y, dv[i][1]);
                    dv[i][2] = fmaf(p[i], o.z, dv[i][2]);
                    dv[i][3] = fmaf(p[i], o.w, dv[i][3]);
                    dk[i][0] = fmaf(ds[i], q.x, dk[i][0]);
                    dk[i][1] = fmaf(ds[i], q.y, dk[i][1]);
                    dk[i][2] = fmaf(ds[i], q.z, dk[i][2]);
                    dk[i][3] = fmaf(ds[i], q.w, dk[i][3]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < CP; ++i) {
        const int t = t0 + c0 + i;
        if (t < a.T) {
            const size_t at = (((size_t)b * a.T + t) * a.KV + kvh) * DH + d0;
            st4(static_cast<T*>(a.dk), at,
                make_float4(dk[i][0] * a.scale, dk[i][1] * a.scale,
                            dk[i][2] * a.scale, dk[i][3] * a.scale));
            st4(static_cast<T*>(a.dv), at,
                make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]));
        }
    }
}

// ----------------------------------------------------------------- bwd_dq
template <int DH, typename T>
__global__ void __launch_bounds__(B_THREADS)
bwd_dq(const BwdArgs a) {
    constexpr int PD = DH + 4;
    constexpr int RP = BM * DH / (4 * B_THREADS);   // rows a thread
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* dOs = Qs + BM * PD;
    float* Ks = dOs + BM * PD;
    float* Vs = Ks + BN * PD;
    float* dSt = Vs + BN * PD;               // BN x (BM + 4): dS transposed
    __shared__ float lse_s[BM], dl_s[BM];
    __shared__ int qp_s[BM], kp_s[BN];
    __shared__ int q_lo, q_hi, k_lo, k_hi;
    const int s0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (a.H / a.KV);
    const int d0 = 4 * (threadIdx.x % (DH / 4));
    const int r0 = RP * (threadIdx.x / (DH / 4));

    if (threadIdx.x < BM) {
        const int s = s0 + threadIdx.x;
        qp_s[threadIdx.x] = q_position(a, b, s);
        const size_t at = ((size_t)b * a.S + s) * a.H + h;
        lse_s[threadIdx.x] = s < a.S ? a.lse[at] : INFINITY;
        dl_s[threadIdx.x] = s < a.S ? a.delta[at] : 0.f;
    }
    load_rows<DH>(a, static_cast<const T*>(a.q), Qs, b, h, s0);
    load_rows<DH>(a, static_cast<const T*>(a.dout), dOs, b, h, s0);
    __syncthreads();
    range32(qp_s, BM, false, &q_lo, &q_hi);

    float acc[RP][4];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int t0 = 0; t0 < a.T; t0 += BN) {
        __syncthreads();
        if (threadIdx.x < BN) kp_s[threadIdx.x] = k_position(a, b, t0 + threadIdx.x);
        __syncthreads();
        range32(kp_s, BN, true, &k_lo, &k_hi);
        __syncthreads();
        if (!tiles_meet(a, q_lo, q_hi, k_lo, k_hi)) continue;
        load_keys<DH>(a, static_cast<const T*>(a.k), Ks, b, kvh, t0);
        load_keys<DH>(a, static_cast<const T*>(a.v), Vs, b, kvh, t0);
        __syncthreads();
        probs<DH>(a, Qs, dOs, Ks, Vs, lse_s, dl_s, qp_s, kp_s, nullptr,
                  nullptr, dSt);
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < BN; ++c) {
            const float4 k = ld4(Ks, c * PD + d0);
            float ds[RP];
#pragma unroll
            for (int i = 0; i < RP; ++i) ds[i] = dSt[c * (BM + 4) + r0 + i];
#pragma unroll
            for (int i = 0; i < RP; ++i) {
                acc[i][0] = fmaf(ds[i], k.x, acc[i][0]);
                acc[i][1] = fmaf(ds[i], k.y, acc[i][1]);
                acc[i][2] = fmaf(ds[i], k.z, acc[i][2]);
                acc[i][3] = fmaf(ds[i], k.w, acc[i][3]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RP; ++i) {
        const int s = s0 + r0 + i;
        if (s < a.S)
            st4(static_cast<T*>(a.dq),
                (((size_t)b * a.S + s) * a.H + h) * DH + d0,
                make_float4(acc[i][0] * a.scale, acc[i][1] * a.scale,
                            acc[i][2] * a.scale, acc[i][3] * a.scale));
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

template <int DH, typename T>
cudaError_t launch_pre(const BwdArgs& a, cudaStream_t st) {
    const size_t pre_smem = (size_t)(BM + BN) * (DH + 4) * sizeof(float);
    cudaError_t err = allow_smem(bwd_pre<DH, T>, pre_smem);
    if (err != cudaSuccess) return err;
    const dim3 qgrid((a.S + BM - 1) / BM, a.H, a.B);
    bwd_pre<DH, T><<<qgrid, B_THREADS, pre_smem, st>>>(a);
    return cudaGetLastError();
}

template <int DH, typename T>
cudaError_t launch_typed(const BwdArgs& a, cudaStream_t st) {
    constexpr int PD = DH + 4;
    const size_t kv_smem = ((size_t)(2 * BM + 2 * BN) * PD + 2 * BM * PS)
                           * sizeof(float);
    const size_t q_smem = ((size_t)(2 * BM + 2 * BN) * PD + BN * (BM + 4))
                          * sizeof(float);
    cudaError_t err = launch_pre<DH, T>(a, st);
    if (err == cudaSuccess) err = allow_smem(bwd_dkdv<DH, T>, kv_smem);
    if (err == cudaSuccess) err = allow_smem(bwd_dq<DH, T>, q_smem);
    if (err != cudaSuccess) return err;
    const dim3 qgrid((a.S + BM - 1) / BM, a.H, a.B);
    const dim3 kgrid((a.T + BN - 1) / BN, a.KV, a.B);
    bwd_dkdv<DH, T><<<kgrid, B_THREADS, kv_smem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dq<DH, T><<<qgrid, B_THREADS, q_smem, st>>>(a);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const BwdArgs& a, bool bf16, bool pre_only,
                      cudaStream_t st) {
    if (pre_only)
        return bf16 ? launch_pre<DH, __nv_bfloat16>(a, st)
                    : launch_pre<DH, float>(a, st);
    return bf16 ? launch_typed<DH, __nv_bfloat16>(a, st)
                : launch_typed<DH, float>(a, st);
}

int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, const int* qpos, const int* kpos, int qpos_bs,
           int kpos_bs, int B, int S, int T, int H, int KV, int dh,
           int causal, int window, int bf16, int lse_ready, bool pre_only,
           void* stream) {
    if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || !lse ||
        !delta || qpos_bs < 0 || kpos_bs < 0 || B > 65535 || H > 65535 ||
        (dh != 32 && dh != 64 && dh != 128))
        return (int)cudaErrorInvalidValue;
    const BwdArgs a{q, k, v, o, dout, dq, dk, dv,
                    static_cast<float*>(lse), static_cast<float*>(delta),
                    qpos, kpos, qpos_bs, kpos_bs, B, S, T, H, KV, causal,
                    window, (float)(1.0 / sqrt((double)dh)), lse_ready != 0};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 32: return (int)launch_dh<32>(a, bf16 != 0, pre_only, st);
        case 64: return (int)launch_dh<64>(a, bf16 != 0, pre_only, st);
        default: return (int)launch_dh<128>(a, bf16 != 0, pre_only, st);
    }
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, S, H, dh); k, v, dk, dv (B, T, KV, dh); contiguous, all
// bf16 (bf16 = 1) or all float32; dh 32, 64 or 128. lse, delta float32
// [B·S·H]: lse holds the forward's log-sum-exp when lse_ready, else the
// pre-pass computes it there; delta is scratch. qpos (S,)/(B, S), kpos
// (T,)/(B, T) int32 or null with batch strides (0: one row shared).
// window <= 0 means none. Returns the launches' cudaError_t (0 on
// success).
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, void* lse, void* delta, const int* qpos,
                     const int* kpos, int qpos_bs, int kpos_bs, int B, int S,
                     int T, int H, int KV, int dh, int causal, int window,
                     int bf16, int lse_ready, void* stream) {
    return launch(q, k, v, o, dout, dq, dk, dv, lse, delta, qpos, kpos,
                  qpos_bs, kpos_bs, B, S, T, H, KV, dh, causal, window, bf16,
                  lse_ready, false, stream);
}

// The pre-pass alone (Δ, and the log-sum-exp unless lse_ready), for the
// tensor-core route (attention_bwd_tc.cu); arguments as above.
int flash_bwd_pre_launch(const void* q, const void* k, const void* o,
                         const void* dout, void* lse, void* delta,
                         const int* qpos, const int* kpos, int qpos_bs,
                         int kpos_bs, int B, int S, int T, int H, int KV,
                         int dh, int causal, int window, int bf16,
                         int lse_ready, void* stream) {
    return launch(q, k, nullptr, o, dout, nullptr, nullptr, nullptr, lse,
                  delta, qpos, kpos, qpos_bs, kpos_bs, B, S, T, H, KV, dh,
                  causal, window, bf16, lse_ready, true, stream);
}

}  // extern "C"
