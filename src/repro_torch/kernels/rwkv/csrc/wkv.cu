// RWKV-6 wkv recurrence (forward) on Hopper (sm_90a). Plain C interface,
// loaded with ctypes by ../../_build.py; the wrapper, its launch counter
// and `plan`, which decides every launch, live in ../kernel.py, the plain
// PyTorch version in ../ref.py.
//
// Replaces `wkv_pallas` / `_kernel` of src/repro/kernels/rwkv/kernel.py
// (:25-76, `pl.pallas_call` at :61). For each (b, h) and step t, over a
// (dh, dh) float32 state S (key index i, value index j):
//     out_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j]  = w_t[i] S[i][j] + k_t[i] v_t[j]
// Beyond the TPU kernel, which the model could not call as it stands:
//   - layout: r, k, v, w and out are (B, S, H, dh), as the model holds
//     them, contiguous; no transposes to (B·H, S, dh).
//   - an optional initial state s0 (B, H, dh, dh) (null: zeros) and the
//     final state s_fin (B, H, dh, dh) as a second output, so that
//     prefill can hand its state to decode.
//   - any S >= 1 (the TPU wrapper wants S < 128 or a multiple of 128).
// r, k, v are bf16 or float32; w, u, s0, out and s_fin are float32 (a
// decay of 0.999 is 0.99609 in bf16, which over 2000 steps is the whole
// state).
//
// The trap carried over from the TPU: wkv_pallas keeps S in VMEM scratch
// across a chunk grid axis that the TPU runs in sequence. CUDA blocks run
// concurrently, so here a block walks all S steps of its part of the
// state itself; nothing carries between blocks.
//
// Bound on an H100 SXM (700 W): per (b, t, h) 2·dh² FMAs (4·dh² flops)
// against 67 TFLOP/s float32, and r/k/v once at their width, w and out in
// float32, s0/s_fin in float32 against 3.35 TB/s. The rwkv6-3b prefill
// shape (4, 2000, 40, 64, bf16) moves about 0.29 GB (0.086 ms) against
// 5.2e9 flops (0.078 ms): bytes bound it, the two close. Decode (S = 1)
// moves the 2.6 MB state in and out, about 1.6 µs.
//
// wkv_prefill (S > 1): the chunked form on tensor cores. Done step by step
// the recurrence is a chain per state element, 2000 steps long, and costs
// 3 FP32 instructions per element and step (k·v, the state's FMA, the
// output's FMA): 0.118 ms of the whole card's FP32 issue at the prefill
// shape, before any load or sum. Over a chunk of T = 16 steps from state
// S0 it is instead, with products of w in float32 and never a quotient (so
// w = 0 and w = 1 need no care and nothing underflows into a division):
//     r~_t = r_t ⊙ prod_{s<t} w_s            W = prod_{s<T} w_s
//     k~_t = k_t ⊙ prod_{s>t} w_s
//     A[t][τ] = sum_i r_t[i] k_τ[i] prod_{τ<s<t} w_s[i]   (τ < t)
//     A[t][t] = sum_i r_t[i] u[i] k_t[i],  A[t][τ] = 0     (τ > t)
//     out_t = r~_t S0 + sum_τ A[t][τ] v_τ
//     S     = W ⊙ S0 + sum_t k~_t v_t^T     (W scales the rows i)
// and A itself is a sum of products over 4 levels (`prepare_chunk`). Every
// product runs as mma.sync m16n8k8 TF32 with each float32 operand split
// in two TF32 parts (hi·hi + hi·lo + lo·hi: about 2^-22 of each product);
// bf16 v is exact in TF32 and is not split; the state's update stays FP32.
// A block owns 64 value columns of one (b, h) (32 at dh = 32) and all dh
// keys, and is two teams that hand chunks over through named barriers
// and two buffers of shared memory:
//   - 4 producer warps load a chunk's r, k, w (all keys) and v (the
//     block's columns) by cp.async (16 bytes, zero-filled past S) into one
//     of 3 stages, a chunk ahead, and prepare it: r~, k~ (stored split,
//     16 bytes a key pair), W, and A by its levels;
//   - a consumer warp per 16 columns holds S^T for them in the mma
//     accumulator layout, 4·dh/8 registers across all chunks, which the
//     chunk's output product takes as its A operand as it stands (the keys
//     of each 8 in the order 0 2 4 6 1 3 5 7, which r~ is read in too); it
//     runs the output's and the state's products interleaved, writes out
//     in 32-byte segments and updates S = fma(W, S, X).
// Steps past S take w = 1, r = k = v = 0, so they leave the state as it
// is. At the prefill shape: 160 blocks of 8 warps, two to an SM at most
// (128 registers, 90,624 bytes of shared memory), so 28 of the 132 SMs
// hold two heads and set the time.
//
// wkv_decode (S = 1). A block owns D_JT = 32 value columns of one (b, h)
// and all dh keys, one thread per (key, 4 columns): a 16-byte streaming
// load of s0 and a 16-byte streaming store of s_fin each, every load of
// the block in flight at once. out sums over the keys in the warp
// (shuffles over its 4 keys) and once through shared memory: one launch,
// no memset. At (4, 1, 40, 64): 320 blocks of 512 threads.
//
// wkv_launch takes the grid, block and shared-memory size that
// ../kernel.py's `plan` chose and refuses any that the kernels were not
// built for. ptxas reports the registers (`-Xptxas -v`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wkv_chunk.cuh"

namespace {

constexpr int P_T = 16;                      // prefill: steps per chunk
constexpr int P_NP = 4;                      // prefill: producer warps
constexpr int P_NS = 3;                      // prefill: stages of raw input
constexpr int D_JT = 32;                     // decode: columns per block
constexpr int D_Q = D_JT / 4;                // decode: threads per key

// The prefill kernel's block for a head size: JT value columns, NC
// consumer warps of 16 columns each, P_NP producer warps; barrier ids (0
// is __syncthreads).
template <int DH>
struct PrefillCfg {
    static constexpr int JT = DH >= 64 ? 64 : 32, NC = JT / 16;
    static constexpr int THREADS = 32 * (NC + P_NP);
    // two blocks an SM up to dh = 64 (160 heads on 132 SMs), so at most
    // 128 registers a thread
    static constexpr int MIN_BLOCKS = DH <= 64 ? 2 : 1;
    static constexpr int BAR_P = 1, BAR_FULL = 2, BAR_EMPTY = 4;
};

// Shared memory of the prefill kernel, in bytes: P_NS stages of raw
// inputs (r, k, w for all keys and v for the block's columns; the
// consumers read v there), two buffers of a prepared chunk, and the
// producers' level vectors. In a buffer r~ is kept as float4 {hi, hi, lo,
// lo} of a key pair, k~ as float4 {hi, lo, hi, lo} of a key pair and A as
// float2 {hi, lo} (TF32 parts); rows are padded so that a warp's fragment
// loads take the fewest shared-memory wavefronts.
template <int DH, typename E>
struct PrefillSmem {
    static constexpr int ES = sizeof(E), JT = PrefillCfg<DH>::JT;
    static constexpr int RS = 2 * DH + 16, KS = 2 * DH + 16;
    static constexpr int AS = 2 * (P_T + 4), BS = DH + 4;
    static constexpr size_t RAW_R = 0;
    static constexpr size_t RAW_K = RAW_R + (size_t)P_T * DH * ES;
    static constexpr size_t RAW_W = RAW_K + (size_t)P_T * DH * ES;
    static constexpr size_t RAW_V = RAW_W + (size_t)P_T * DH * 4;
    static constexpr size_t STAGE = RAW_V + (size_t)P_T * JT * ES;
    static constexpr size_t RT = 0;                  // offsets in a buffer
    static constexpr size_t KT = RT + (size_t)P_T * RS * 4;
    static constexpr size_t AM = KT + (size_t)P_T * KS * 4;
    static constexpr size_t WC = AM + (size_t)P_T * AS * 4;
    static constexpr size_t BUF = WC + (size_t)DH * 4;
    static constexpr size_t BUF0 = P_NS * STAGE;
    // the level vectors of `prepare_chunk`, 4 levels × 8 rows each side
    static constexpr size_t RB = BUF0 + 2 * BUF;
    static constexpr size_t KB = RB + (size_t)32 * BS * 4;
    static constexpr size_t BYTES = KB + (size_t)32 * BS * 4;
};

// 8 consecutive values at p (32-byte aligned for float, 16 for bf16) as
// float32.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 b = *reinterpret_cast<const uint4*>(p);
    x[0] = lo_bf16(b.x); x[1] = hi_bf16(b.x);
    x[2] = lo_bf16(b.y); x[3] = hi_bf16(b.y);
    x[4] = lo_bf16(b.z); x[5] = hi_bf16(b.z);
    x[6] = lo_bf16(b.w); x[7] = hi_bf16(b.w);
}

// Named barriers: `sync` waits for n threads, `arrive` counts this one
// without waiting (shared-memory writes before it are seen after the
// matching sync).
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Chunk c's r, k, w (all keys) and v (the block's columns) into a stage,
// zero-filled past S, by the NT producer threads.
template <int DH, typename E>
__device__ __forceinline__ void issue_chunk(
        unsigned char* stage, const E* r, const E* k, const E* v,
        const float* w, size_t row0, size_t step, int j0, int t0, int S,
        int ptid) {
    using L = PrefillSmem<DH, E>;
    constexpr int ES = L::ES, JT = L::JT, NT = 32 * P_NP;
    constexpr int RU = DH * ES / 16, WU = DH / 4, VU = JT * ES / 16;
#pragma unroll
    for (int n = 0; n < (P_T * RU + NT - 1) / NT; ++n) {
        const int x = ptid + n * NT, t = x / RU, q = x % RU;
        if (P_T * RU % NT == 0 || x < P_T * RU) {
            const bool ok = t0 + t < S;
            const size_t at = (row0 + (size_t)(ok ? t0 + t : 0) * step) * ES
                + q * 16;
            cp_async16(stage + L::RAW_R + (t * DH * ES + q * 16),
                       reinterpret_cast<const unsigned char*>(r) + at, ok);
            cp_async16(stage + L::RAW_K + (t * DH * ES + q * 16),
                       reinterpret_cast<const unsigned char*>(k) + at, ok);
        }
    }
#pragma unroll
    for (int n = 0; n < (P_T * WU + NT - 1) / NT; ++n) {
        const int x = ptid + n * NT, t = x / WU, q = x % WU;
        if (P_T * WU % NT == 0 || x < P_T * WU) {
            const bool ok = t0 + t < S;
            cp_async16(stage + L::RAW_W + (t * DH + q * 4) * 4,
                       w + row0 + (size_t)(ok ? t0 + t : 0) * step + q * 4,
                       ok);
        }
    }
#pragma unroll
    for (int n = 0; n < (P_T * VU + NT - 1) / NT; ++n) {
        const int x = ptid + n * NT, t = x / VU, q = x % VU;
        if (P_T * VU % NT == 0 || x < P_T * VU) {
            const bool ok = t0 + t < S;
            const size_t at = (row0 + (size_t)(ok ? t0 + t : 0) * step + j0)
                * ES + q * 16;
            cp_async16(stage + L::RAW_V + (t * JT * ES + q * 16),
                       reinterpret_cast<const unsigned char*>(v) + at, ok);
        }
    }
}

// Keys 2q and 2q + 1 of row t as float32.
__device__ __forceinline__ float2 load_pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
    const uint32_t b = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(lo_bf16(b), hi_bf16(b));
}

// The chunk at step t0 in a stage into a buffer, by the NT producer
// threads: r~, k~ and W, and A, split into TF32 parts; w counts as 1 past
// S. A[t][τ] for τ < t is exact in products: with m the middle of the
// smallest aligned block of steps that holds both (level b = the highest
// bit in which t and τ differ), prod_{τ<s<t} w_s = prod_{τ<s<m} w_s ·
// prod_{m<=s<t} w_s, so A[t][τ] = RB_b[t] · KB_b[τ] over the keys, with
//     RB_b[t] = r_t ⊙ prod_{m<=s<t} w_s   (t in the upper half of a block)
//     KB_b[τ] = k_τ ⊙ prod_{τ<s<m} w_s    (τ in the lower half)
// 8 rows each side at each of the 4 levels. A thread per (role, key pair)
// forms r~ and W, RB, k~ or KB; then a thread per (t, 8 keys) forms the
// diagonal, summed over the dh/8 consecutive lanes of a t (ub holds u of
// the thread's keys), and producer warp b runs level b's 8 × 8 products
// as TF32 mma.
template <int DH, typename E>
__device__ __forceinline__ void prepare_chunk(
        unsigned char* smem, unsigned char* buf, const unsigned char* stage,
        const float (&ub)[8], int t0, int S, int ptid) {
    using L = PrefillSmem<DH, E>;
    constexpr int NT = 32 * P_NP, G = DH / 8, HP = DH / 2, BS = L::BS;
    static_assert(P_T == 16 && P_NP == 4, "a producer warp per level");
    static_assert(32 % G == 0 && (2 * DH) % 32 == 0, "whole warps");
    const E* rr = reinterpret_cast<const E*>(stage + L::RAW_R);
    const E* kr = reinterpret_cast<const E*>(stage + L::RAW_K);
    const float* wr = reinterpret_cast<const float*>(stage + L::RAW_W);
    float* rt = reinterpret_cast<float*>(buf + L::RT);
    float* kt = reinterpret_cast<float*>(buf + L::KT);
    float* am = reinterpret_cast<float*>(buf + L::AM);
    float* wc = reinterpret_cast<float*>(buf + L::WC);
    float* rb = reinterpret_cast<float*>(smem + L::RB);
    float* kb = reinterpret_cast<float*>(smem + L::KB);
    const int n = S - t0;                       // live steps (>= 1)
#pragma unroll
    for (int m = 0; m < (4 * HP + NT - 1) / NT; ++m) {
        const int x = ptid + m * NT, role = x / HP, q = x % HP;
        if ((4 * HP) % NT != 0 && x >= 4 * HP) break;
        const E* src = role < 2 ? rr : kr;
        float2 a[P_T], wv[P_T];
#pragma unroll
        for (int t = 0; t < P_T; ++t) {
            a[t] = load_pair(src + t * DH + 2 * q);
            wv[t] = t < n ? load_pair(wr + t * DH + 2 * q)
                          : make_float2(1.f, 1.f);
        }
        if (role == 0) {                        // r~ and W
            float2 p = make_float2(1.f, 1.f);
#pragma unroll
            for (int t = 0; t < P_T; ++t) {
                const float2 y0 = split(a[t].x * p.x);
                const float2 y1 = split(a[t].y * p.y);
                *reinterpret_cast<float4*>(rt + t * L::RS + 4 * q) =
                    make_float4(y0.x, y1.x, y0.y, y1.y);
                p.x *= wv[t].x;
                p.y *= wv[t].y;
            }
            *reinterpret_cast<float2*>(wc + 2 * q) = p;
        } else if (role == 2) {                 // k~
            float2 p = make_float2(1.f, 1.f);
#pragma unroll
            for (int t = P_T - 1; t >= 0; --t) {
                const float2 y0 = split(a[t].x * p.x);
                const float2 y1 = split(a[t].y * p.y);
                *reinterpret_cast<float4*>(kt + t * L::KS + 4 * q) =
                    make_float4(y0.x, y0.y, y1.x, y1.y);
                p.x *= wv[t].x;
                p.y *= wv[t].y;
            }
        } else {
            // RB (role 1) up from the middle of each block, KB (role 3)
            // down to it: 8 rows at each of 4 levels, row 8 b + jj; within
            // a block the running product starts again at 1
            const bool up = role == 1;
            float* o = (up ? rb : kb) + 2 * q;
            float2 p = make_float2(1.f, 1.f);
#pragma unroll
            for (int idx = 0; idx < 32; ++idx) {
                const int b = idx / 8, jj = idx % 8, h = 1 << b;
                const int blk = jj / h, o2 = jj % h;
                if (o2 == 0) p = make_float2(1.f, 1.f);
                const int tu = (2 * blk + 1) * h + o2;       // RB's step
                const int td = (2 * blk + 1) * h - 1 - o2;   // KB's step
                const float2 at = up ? a[tu] : a[td];
                const float2 wt = up ? wv[tu] : wv[td];
                const int row = 8 * b + blk * h + (up ? o2 : h - 1 - o2);
                *reinterpret_cast<float2*>(o + row * BS) =
                    make_float2(at.x * p.x, at.y * p.y);
                p.x *= wt.x;
                p.y *= wt.y;
            }
        }
    }
    bar_sync(PrefillCfg<DH>::BAR_P, NT);        // the level vectors are in

    // the diagonal, A[t][t] = sum_i r_t[i] u[i] k_t[i] (it reads only the
    // raw stage, and runs beside the level products)
#pragma unroll
    for (int m = 0; m < (P_T * G + NT - 1) / NT; ++m) {
        const int x = ptid + m * NT;
        if (x >= P_T * G) break;                // whole warps
        const int t = x / G, i0 = (x % G) * 8;
        float rv[8], kv[8];
        load8(rr + t * DH + i0, rv);
        load8(kr + t * DH + i0, kv);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(rv[e] * ub[e], kv[e], d);
#pragma unroll
        for (int o = 1; o < G; o <<= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
        if (x % G == 0)
            *reinterpret_cast<float2*>(am + t * L::AS + 2 * t) = split(d);
    }

    // level b = this warp: M[j][l] = RB_b[j] · KB_b[l] (m16n8k8, rows 8-15
    // zero), kept where upper row j and lower row l share a block; the
    // k-steps alternate between two sets of accumulators
    const int b = ptid >> 5, lane = ptid & 31, g = lane >> 2, c = lane & 3;
    const float* rbw = rb + (8 * b + g) * BS + c;
    const float* kbw = kb + (8 * b + g) * BS + c;
    float mc[2][3][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
        const float2 a0 = split(rbw[8 * kk]), a2 = split(rbw[8 * kk + 4]);
        const float2 b0 = split(kbw[8 * kk]), b1 = split(kbw[8 * kk + 4]);
        const uint32_t ah[4] = {__float_as_uint(a0.x), 0u,
                                __float_as_uint(a2.x), 0u};
        const uint32_t al[4] = {__float_as_uint(a0.y), 0u,
                                __float_as_uint(a2.y), 0u};
        float (&acc)[3][4] = mc[kk & 1];
        mma(acc[0], ah, b0.x, b1.x);
        mma(acc[1], ah, b0.y, b1.y);
        mma(acc[2], al, b0.x, b1.x);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int j = g, l = 2 * c + e;
        if ((j >> b) == (l >> b)) {
            const int lo = (1 << b) - 1;
            const int t = ((j >> b) << (b + 1)) + (1 << b) + (j & lo);
            const int tau = ((l >> b) << (b + 1)) + (l & lo);
            *reinterpret_cast<float2*>(am + t * L::AS + 2 * tau) = split(
                (mc[0][0][e] + mc[1][0][e])
                + ((mc[0][1][e] + mc[1][1][e]) + (mc[0][2][e] + mc[1][2][e])));
        }
    }
}

// One consumer warp's products for the chunk in a buffer (v in the raw
// stage): out for its 16 columns (jw the first, jl its offset in the
// block's tile) and its part of S^T, s[ν][e] = S[8ν + 2c + (e & 1)][jw + g
// + 8 (e >> 1)] with g = lane / 4, c = lane % 4 (the accumulator layout of
// m16n8, m = column, n = key). The state's products V^T k~ do not depend
// on S and are interleaved with the output's.
template <int DH, typename E>
__device__ __forceinline__ void mma_chunk(
        const unsigned char* buf, const unsigned char* stage,
        float (&s)[DH / 8][4], float* __restrict__ out, size_t row0,
        size_t step, int jw, int jl, int t0, int S, int lane) {
    using L = PrefillSmem<DH, E>;
    constexpr bool SPLIT_V = L::ES == 4;        // bf16 v is exact in TF32
    constexpr int NK = DH / 8, JT = L::JT;
    const int g = lane >> 2, c = lane & 3;
    const E* vr = reinterpret_cast<const E*>(stage + L::RAW_V);
    const float* rt = reinterpret_cast<const float*>(buf + L::RT);
    const float* kt = reinterpret_cast<const float*>(buf + L::KT);
    const float* am = reinterpret_cast<const float*>(buf + L::AM);
    const float* wc = reinterpret_cast<const float*>(buf + L::WC);

    // V^T as the A operand (m = column, k = step), both k-steps of 8
    uint32_t va[2][4], vl[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int t = 8 * ks + c + 4 * (e >> 1), j = jl + g + 8 * (e & 1);
            const float y = to_float(vr[t * JT + j]);
            if constexpr (SPLIT_V) {
                const float2 z = split(y);
                va[ks][e] = __float_as_uint(z.x);
                vl[ks][e] = __float_as_uint(z.y);
            } else {
                va[ks][e] = __float_as_uint(y);
            }
        }

    // out^T (m = column, n = step) = S^T r~^T + V^T A^T (hi·hi and the
    // small terms in accumulators of their own); X = V^T k~ (m = column,
    // n = key)
    float o[2][2][4] = {}, x[NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
        uint32_t ah[4], al[4];
        const int pick[4] = {0, 2, 1, 3};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 y = split(s[kk][pick[e]]);
            ah[e] = __float_as_uint(y.x);
            al[e] = __float_as_uint(y.y);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            const float4 b = *reinterpret_cast<const float4*>(
                rt + (8 * nt + g) * L::RS + 16 * kk + 4 * c);
            mma(o[0][nt], ah, b.x, b.y);
            mma(o[1][nt], ah, b.z, b.w);
            mma(o[1][nt], al, b.x, b.y);
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            // k~ of key 8 kk + g at steps 8 ks + c and + 4: {hi, lo}
            const float2 b0 = *reinterpret_cast<const float2*>(
                kt + (8 * ks + c) * L::KS + 2 * (8 * kk + g));
            const float2 b1 = *reinterpret_cast<const float2*>(
                kt + (8 * ks + c + 4) * L::KS + 2 * (8 * kk + g));
            mma(x[kk], va[ks], b0.x, b1.x);
            mma(x[kk], va[ks], b0.y, b1.y);
            if constexpr (SPLIT_V) mma(x[kk], vl[ks], b0.x, b1.x);
        }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            const float2 b0 = *reinterpret_cast<const float2*>(
                am + (8 * nt + g) * L::AS + 2 * (8 * ks + c));
            const float2 b1 = *reinterpret_cast<const float2*>(
                am + (8 * nt + g) * L::AS + 2 * (8 * ks + c + 4));
            mma(o[0][nt], va[ks], b0.x, b1.x);
            mma(o[1][nt], va[ks], b0.y, b1.y);
            if constexpr (SPLIT_V) mma(o[1][nt], vl[ks], b0.x, b1.x);
        }
    // out[t0 + t][jw + g (+ 8)] for t = 8 nt + 2c (+ 1): four rows, the
    // steps past S left out only in the last chunk
    float* ob = out + row0 + (size_t)(t0 + 2 * c) * step + jw + g;
    const int live = S - t0 - 2 * c;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int t = 8 * nt + (e & 1);
            if (live >= P_T || t < live)
                __stcs(ob + t * step + 8 * (e >> 1),
                       o[0][nt][e] + o[1][nt][e]);
        }

    // S^T = W ⊙ S^T + X, the update in FP32
#pragma unroll
    for (int nu = 0; nu < NK; ++nu) {
        const float2 wv = *reinterpret_cast<const float2*>(
            wc + 8 * nu + 2 * c);
        s[nu][0] = fmaf(wv.x, s[nu][0], x[nu][0]);
        s[nu][1] = fmaf(wv.y, s[nu][1], x[nu][1]);
        s[nu][2] = fmaf(wv.x, s[nu][2], x[nu][2]);
        s[nu][3] = fmaf(wv.y, s[nu][3], x[nu][3]);
    }
}

template <int DH, typename E>
__global__ void __launch_bounds__(PrefillCfg<DH>::THREADS,
                                  PrefillCfg<DH>::MIN_BLOCKS)
wkv_prefill(const E* __restrict__ r, const E* __restrict__ k,
            const E* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ s_fin, int S,
            int H) {
    using C = PrefillCfg<DH>;
    using L = PrefillSmem<DH, E>;
    constexpr int TILES = DH / C::JT, ALL = C::THREADS, NP = 32 * P_NP;
    static_assert(DH % C::JT == 0, "head size");
    extern __shared__ __align__(16) unsigned char smem[];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tile = blockIdx.x % TILES;
    const size_t bh = blockIdx.x / TILES;
    const int h = (int)(bh % H);
    const size_t b = bh / H;
    const int j0 = tile * C::JT;
    const size_t step = (size_t)H * DH;                  // stride of t
    const size_t row0 = (b * S * H + h) * DH;            // (b, 0, h, 0)
    const int n_chunks = (S + P_T - 1) / P_T;

    if (warp >= C::NC) {                                 // producers
        const int ptid = tid - 32 * C::NC;
        float ub[8];                  // u of the keys of a diagonal thread
        const int i0 = (ptid % (DH / 8)) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) ub[e] = u[h * DH + i0 + e];
        // A[t][τ] = 0 for τ > t, in both buffers, once
        for (int x = ptid; x < P_T * P_T; x += NP) {
            const int t = x / P_T, tau = x % P_T;
            if (tau > t)
#pragma unroll
                for (int bf = 0; bf < 2; ++bf)
                    *reinterpret_cast<float2*>(
                        smem + L::BUF0 + bf * L::BUF + L::AM
                        + (t * L::AS + 2 * tau) * 4) = make_float2(0.f, 0.f);
        }
        // chunk c goes to stage c % P_NS, one chunk ahead, once the
        // consumers are done with the chunk that was there (they read its v)
        issue_chunk<DH, E>(smem, r, k, v, w, row0, step, j0, 0, S, ptid);
        cp_async_commit();
        for (int ch = 0; ch < n_chunks; ++ch) {
            cp_async_wait<0>();        // chunk ch is in (this thread's part)
            bar_sync(C::BAR_P, NP);    // ... everyone's; chunk ch-1 prepared
            if (ch >= 2) bar_sync(C::BAR_EMPTY + (ch & 1), ALL);
            if (ch + 1 < n_chunks) {
                issue_chunk<DH, E>(smem + ((ch + 1) % P_NS) * L::STAGE, r, k,
                                   v, w, row0, step, j0, (ch + 1) * P_T, S,
                                   ptid);
                cp_async_commit();
            }
            prepare_chunk<DH, E>(smem, smem + L::BUF0 + (ch & 1) * L::BUF,
                                 smem + (ch % P_NS) * L::STAGE, ub, ch * P_T,
                                 S, ptid);
            bar_arrive(C::BAR_FULL + (ch & 1), ALL);
        }
        return;
    }

    // consumers: warp `warp` owns columns j0 + 16 warp .. + 15
    const int g = lane >> 2, c = lane & 3, jl = 16 * warp;
    const size_t state0 = bh * DH * DH + j0 + jl + g;    // (b, h, 0, col)
    float s[DH / 8][4];
#pragma unroll
    for (int nu = 0; nu < DH / 8; ++nu)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[nu][e] = s0 ? s0[state0 + (size_t)(8 * nu + 2 * c + (e & 1))
                               * DH + 8 * (e >> 1)]
                          : 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
        bar_sync(C::BAR_FULL + (ch & 1), ALL);
        mma_chunk<DH, E>(smem + L::BUF0 + (ch & 1) * L::BUF,
                         smem + (ch % P_NS) * L::STAGE, s, out, row0, step,
                         j0 + jl, jl, ch * P_T, S, lane);
        if (ch + 2 < n_chunks) bar_arrive(C::BAR_EMPTY + (ch & 1), ALL);
    }
#pragma unroll
    for (int nu = 0; nu < DH / 8; ++nu)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s_fin[state0 + (size_t)(8 * nu + 2 * c + (e & 1)) * DH
                  + 8 * (e >> 1)] = s[nu][e];
}

template <typename E>
__device__ __forceinline__ float4 load4(const E* p);
template <>
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 b = *reinterpret_cast<const uint2*>(p);
    return make_float4(lo_bf16(b.x), hi_bf16(b.x), lo_bf16(b.y),
                       hi_bf16(b.y));
}

template <int DH, typename E>
__global__ void __launch_bounds__(DH * D_Q)
wkv_decode(const E* __restrict__ r, const E* __restrict__ k,
           const E* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ out, float* __restrict__ s_fin, int H) {
    constexpr int WARPS = DH * D_Q / 32, TILES = DH / D_JT;
    static_assert((D_Q & (D_Q - 1)) == 0 && D_Q <= 16, "lanes per key");
    __shared__ float4 red[WARPS][D_Q];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int i = tid / D_Q, q = tid % D_Q;
    const int tile = blockIdx.x % TILES;
    const size_t bh = blockIdx.x / TILES;
    const int h = (int)(bh % H);
    const int j = tile * D_JT + q * 4;
    const size_t row = bh * DH;                      // (b, 0, h, 0): S = 1
    const size_t at = (row + i) * DH + j;            // (b, h, i, j)

    const float4 sv = s0 ? __ldcs(reinterpret_cast<const float4*>(s0 + at))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ri = to_float(r[row + i]), ki = to_float(k[row + i]);
    const float wi = w[row + i], ui = u[h * DH + i];
    const float4 vq = load4(v + row + j);
    const float a = ri * ui * ki;

    float4 p = make_float4(fmaf(ri, sv.x, a * vq.x), fmaf(ri, sv.y, a * vq.y),
                           fmaf(ri, sv.z, a * vq.z), fmaf(ri, sv.w, a * vq.w));
    __stcs(reinterpret_cast<float4*>(s_fin + at),
           make_float4(fmaf(wi, sv.x, ki * vq.x), fmaf(wi, sv.y, ki * vq.y),
                       fmaf(wi, sv.z, ki * vq.z), fmaf(wi, sv.w, ki * vq.w)));
#pragma unroll
    for (int o = D_Q; o < 32; o <<= 1) {             // the warp's keys
        p.x += __shfl_xor_sync(0xffffffffu, p.x, o);
        p.y += __shfl_xor_sync(0xffffffffu, p.y, o);
        p.z += __shfl_xor_sync(0xffffffffu, p.z, o);
        p.w += __shfl_xor_sync(0xffffffffu, p.w, o);
    }
    if (lane < D_Q) red[warp][lane] = p;
    __syncthreads();
    if (tid < D_Q) {
        float4 acc = red[0][tid];
#pragma unroll
        for (int wv = 1; wv < WARPS; ++wv) {
            const float4 y = red[wv][tid];
            acc.x += y.x; acc.y += y.y; acc.z += y.z; acc.w += y.w;
        }
        *reinterpret_cast<float4*>(out + row + tile * D_JT + tid * 4) = acc;
    }
}

// ------------------------------------------------------------------ host
// Sets a kernel's dynamic shared memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned& ready) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < 32 && (ready >> dev & 1u))) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess && dev < 32) ready |= 1u << dev;
    return err;
}

struct Args {
    const void *r, *k, *v;
    const float *w, *u, *s0;
    float *out, *s_fin;
    long long BH;
    int S, H;
    long long blocks;
    int threads;
    long long smem;
    cudaStream_t st;
};

template <int DH, typename E>
cudaError_t launch_decode(const Args& a) {
    constexpr int THREADS = DH * D_Q;
    if (a.threads != THREADS || a.blocks != a.BH * (DH / D_JT)
        || a.smem != (long long)(THREADS / 32 * D_Q * 16))
        return cudaErrorInvalidValue;
    wkv_decode<DH, E><<<(unsigned)a.blocks, THREADS, 0, a.st>>>(
        static_cast<const E*>(a.r), static_cast<const E*>(a.k),
        static_cast<const E*>(a.v), a.w, a.u, a.s0, a.out, a.s_fin, a.H);
    return cudaGetLastError();
}

template <int DH, typename E>
cudaError_t launch_prefill(const Args& a) {
    using C = PrefillCfg<DH>;
    using L = PrefillSmem<DH, E>;
    if (a.threads != C::THREADS || a.blocks != a.BH * (DH / C::JT)
        || a.smem != (long long)L::BYTES)
        return cudaErrorInvalidValue;
    static unsigned ready = 0;
    const cudaError_t err = allow_smem(wkv_prefill<DH, E>, L::BYTES, ready);
    if (err != cudaSuccess) return err;
    wkv_prefill<DH, E><<<(unsigned)a.blocks, C::THREADS, L::BYTES, a.st>>>(
        static_cast<const E*>(a.r), static_cast<const E*>(a.k),
        static_cast<const E*>(a.v), a.w, a.u, a.s0, a.out, a.s_fin, a.S,
        a.H);
    return cudaGetLastError();
}

template <int DH, typename E>
cudaError_t launch_t(const Args& a) {
    return a.S == 1 ? launch_decode<DH, E>(a) : launch_prefill<DH, E>(a);
}

template <int DH>
cudaError_t launch_dh(const Args& a, bool bf16) {
    return bf16 ? launch_t<DH, __nv_bfloat16>(a) : launch_t<DH, float>(a);
}

}  // namespace

extern "C" {

// r, k, v (B, S, H, dh) all bf16 (bf16 = 1) or all float32 (bf16 = 0);
// w, out (B, S, H, dh), u (H, dh), s0 (or null) and s_fin (B, H, dh, dh)
// float32; all contiguous and 16-byte aligned; dh is 32, 64 or 128. S = 1
// launches wkv_decode, S > 1 wkv_prefill, with the blocks, threads per
// block and shared-memory bytes of ../kernel.py's `plan`. Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for a plan
// the kernels were not built for).
int wkv_launch(const void* r, const void* k, const void* v, const float* w,
               const float* u, const float* s0, float* out, float* s_fin,
               int B, int S, int H, int dh, int bf16, long long blocks,
               int threads, long long smem, void* stream) {
    if (B < 1 || S < 1 || H < 1 || blocks < 1 || blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const Args a{r, k, v, w, u, s0, out, s_fin, (long long)B * H, S, H,
                 blocks, threads, smem, static_cast<cudaStream_t>(stream)};
    switch (dh) {
        case 32: return (int)launch_dh<32>(a, bf16 != 0);
        case 64: return (int)launch_dh<64>(a, bf16 != 0);
        case 128: return (int)launch_dh<128>(a, bf16 != 0);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
