// RWKV-6 wkv recurrence, backward, on Hopper (sm_90a). Plain C interface,
// loaded with ctypes by ../../_build.py beside wkv.cu (one library); the
// wrapper, its launch counter and `plan_bwd`, which decides every launch,
// live in ../kernel.py, the plain PyTorch version (`wkv_bwd_ref`) in
// ../ref.py.
//
// Port only: the JAX package has no kernel here. It differentiates its
// XLA form of the recurrence (`wkv_chunked`, src/repro/models/rwkv6.py)
// by autodiff; the port's forward is a ctypes launch that autograd cannot
// see through, so this kernel is its backward. For each (b, h) and step t,
// over the (dh, dh) float32 state S (key index i, value index j), with
// S_{t-1} the state before step t and G_t the loss's gradient with respect
// to the state after it (G_{S-1} = ds_fin, or 0):
//     dr_t[i] = sum_j dout_t[j] S_{t-1}[i][j] + u[i] k_t[i] (v_t . dout_t)
//     dk_t[i] = sum_j G_t[i][j] v_t[j]        + r_t[i] u[i] (v_t . dout_t)
//     dv_t[j] = sum_i G_t[i][j] k_t[i]        + dout_t[j] (r_t . u k_t)
//     dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]        (the decay w itself)
//     du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dout_t)
//     G_{t-1} = w_t G_t + r_t dout_t^T,          ds0 = G_{-1}
// r, k, v and dr, dk, dv are bf16 or float32; w, u, s0, dout, ds_fin, dw,
// du and ds0 float32.
//
// The trap: dw needs S_{t-1} while G runs backwards in time. S_{t-1} is
// never recovered by dividing by w (exp(-exp(.)) underflows to 0, and the
// edge cases hold keys at w = 0 and w = 1 exactly), and not every state
// is stored (5.4 GB a layer at (2, 4096, 40, 64)).
//
// Design: three kernels in one launch call, parallel over chunks of BC =
// 16 steps where the recurrence allows it.
//   wkv_bwd_states: the two serial passes, over chunks rather than steps,
//     in the chunked product form of wkv_prefill (its TF32 helpers in
//     wkv_chunk.cuh). A block walks one (b, h)'s chunks for 32 value
//     columns, a warp holding 16 columns and half the keys of the state in
//     the mma accumulator layout, the inputs three stages deep by
//     cp.async:
//       forward  (k~_t = k_t prod_{s>t} w_s):  S <- W S + sum_t k~_t v_t^T
//       backward (r~_t = r_t prod_{s<t} w_s):  G <- W G + sum_t r~_t dout_t^T
//     (W = prod_t w_t of the chunk, the rows i scaled), the second walking
//     the chunks from the last. Each writes its matrix at every chunk
//     boundary: S_c, the state before chunk c, and G_c, the gradient after
//     chunk c's last step (0.34 GB each at the train shape); the backward
//     pass's last G is ds0. Products of w only, so w = 0 and 1 need no
//     care. The chunk's product runs as mma.sync m16n8k8 TF32 with split
//     operands (bf16 v is exact in TF32 and is not split).
//   wkv_bwd_chunk: a block per (b, h, chunk) and tile of 64 keys (all of
//     them up to dh = 64), two blocks an SM. It never forms S_{t-1} or G_t
//     of a step: expanding both over the chunk from S_c and G_c turns every
//     gradient into chunk products and per-key sums over the chunk's steps
//     (`wkv_bwd_chunks_ref` in ../ref.py spells them out), with P_t =
//     prod_{s<t} w_s, Q_t = prod_{s>t} w_s and pi(a, b) = prod_{a<s<b} w_s:
//       X = S_c Dout^T, Y = G_c V^T, B = Dout V^T, Z = (K Q) G_c   (mma)
//       g = rowsum(G_c . S_c)
//       dr_t = P_t X[t] + sum_{s<t} k_s pi(s, t) B[t][s] + u k_t B[t][t]
//       dk_t = Q_t Y[t] + sum_{s>t} r_s pi(t, s) B[s][t] + r_t u B[t][t]
//       dw_t = Q_t P_t g + Q_t sum_{s<t} k_s pi(s, t) Y[s]
//              + P_t sum_{s>t} r_s pi(t, s) X[s] + (the two chunk sums
//              crossed through B)
//       dv_t = Z_t + sum_{s>=t} A[s][t] dout_s,  A the chunk's r.k decays
//     The products are mma.sync TF32 with split operands; the per-key sums
//     are four threads a key (steps [0, 8), [8, 11), [11, 14), [14, 16):
//     a step's sums grow with t), forward for dr and backward for dk and
//     dw, each range starting from its sums formed directly. No sum over a key's columns or a
//     column's keys crosses a block; at dh = 128 a tile's dv is a float
//     partial.
//   wkv_bwd_finish: du over (b, chunk) in order, and at dh = 128 dv over
//     the two key tiles in order.
// No float atomics: every sum has one order, so two calls agree bit for
// bit.
//
// Bound on an H100 SXM (700 W) at (2, 4096, 40, 64) bf16: r, k, v, w,
// dout read and dr, dk, dv, dw written once (0.15 ms at 3.35 TB/s);
// 14 float32 flops per (b, t, h) and state entry (the state once, G's
// update, one FMA each of dr, dk, dv and dw's sums) against 67 TFLOP/s:
// 0.28 ms, so operations bound it. This kernel's chunk matrices S_c and
// G_c (0.67 GB written and read again at that shape) are its own
// traffic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "wkv_chunk.cuh"

namespace {

constexpr int BC = 16;                       // steps a chunk
constexpr int NSTAGE = 3;                    // states pass: input stages

// ---------------------------------------------------------- wkv_bwd_states
template <int DH>
struct StatesCfg {
    static constexpr int JT = DH < 32 ? DH : 32;     // columns a block
    static constexpr int KSP = 2;                    // key halves
    static constexpr int NW = JT / 16 * KSP;         // a warp per 16
    static constexpr int THREADS = 32 * NW;          // columns and half
    static constexpr int CT = DH / JT;               // column tiles
    static constexpr int KS = 2 * DH + 8;            // floats a row of a~
    static constexpr int BS = JT + 8;                // elements a row of b
};

// Byte offsets of the states kernel's shared memory: NSTAGE stages of raw
// input (a: r or k, all keys, in r's dtype; w; b: v or dout, the block's
// columns, in rows of BS elements of at most 4 bytes), then the prepared
// chunk: a~ as {hi, lo} pairs in rows of KS floats, and W.
template <int DH, typename T>
struct StatesSmem {
    using C = StatesCfg<DH>;
    static constexpr size_t A = 0;
    static constexpr size_t W = A + (size_t)BC * DH * sizeof(T);
    static constexpr size_t B = W + (size_t)BC * DH * 4;
    static constexpr size_t STAGE = B + (size_t)BC * C::BS * 4;
    static constexpr size_t AT = NSTAGE * STAGE;
    static constexpr size_t WC = AT + (size_t)BC * C::KS * 4;
    static constexpr size_t BYTES = WC + (size_t)DH * 4;
};

// One direction of the states pass for one block. `a` is k (forward) or
// r (backward) in TA, `b` v or dout in TB; `init` s0 or ds_fin (null:
// zeros); `out` the (B·H, chunks, dh, dh) matrices; `last` (ds0, may be
// null) takes the matrix after the last chunk.
template <int DH, typename TA, typename TB, bool BACK>
__device__ __forceinline__ void states_pass(
        unsigned char* smem, const TA* __restrict__ a,
        const TB* __restrict__ bv, const float* __restrict__ w,
        const float* __restrict__ init, float* __restrict__ out,
        float* __restrict__ last, long long bh, int S, int H, int chunks,
        int tile) {
    using C = StatesCfg<DH>;
    using L = StatesSmem<DH, TA>;
    constexpr int JT = C::JT, TH = C::THREADS, KS = C::KS, BS = C::BS;
    constexpr int NK = DH / 8 / C::KSP;      // the warp's tiles of 8 keys
    constexpr bool SPLIT_B = sizeof(TB) == 4;  // bf16 is exact in TF32
    constexpr int AU = DH * (int)sizeof(TA) / 16;    // 16-byte pieces a row
    constexpr int WU = DH / 4, BU = JT * (int)sizeof(TB) / 16;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3, jw = 16 * (warp % (JT / 16));
    const int kb = warp / (JT / 16) * (DH / C::KSP);   // its first key
    const int j0 = tile * JT;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const size_t row = (size_t)H * DH;
    const size_t base = ((size_t)b * S * H + h) * DH;   // (b, 0, h, 0)
    float* at = reinterpret_cast<float*>(smem + L::AT);
    float* wc = reinterpret_cast<float*>(smem + L::WC);

    auto fetch_chunk = [&](int ch, int st) {
        unsigned char* stage = smem + st * L::STAGE;
        const int t0 = ch * BC;
        for (int x = tid; x < BC * AU; x += TH) {
            const int t = x / AU, q = x % AU;
            const bool ok = t0 + t < S;
            const size_t off = base + (size_t)(ok ? t0 + t : 0) * row;
            cp_async16(stage + L::A + (size_t)(t * DH) * sizeof(TA) + q * 16,
                       reinterpret_cast<const unsigned char*>(a + off) +
                           q * 16, ok);
        }
        for (int x = tid; x < BC * WU; x += TH) {
            const int t = x / WU, q = x % WU;
            const bool ok = t0 + t < S;
            const size_t off = base + (size_t)(ok ? t0 + t : 0) * row;
            cp_async16(stage + L::W + (size_t)(t * DH + 4 * q) * 4,
                       w + off + 4 * q, ok);
        }
        for (int x = tid; x < BC * BU; x += TH) {
            const int t = x / BU, q = x % BU;
            const bool ok = t0 + t < S;
            const size_t off = base + (size_t)(ok ? t0 + t : 0) * row + j0;
            cp_async16(stage + L::B + (size_t)(t * BS) * sizeof(TB) + q * 16,
                       reinterpret_cast<const unsigned char*>(bv + off) +
                           q * 16, ok);
        }
        cp_async_commit();
    };

    // the warp's columns and keys of the matrix, s[nu][e] = M[kb + 8 nu +
    // 2c + (e & 1)][j0 + jw + g + 8 (e >> 1)] (the m16n8 accumulator, m =
    // column)
    float s[NK][4];
    const size_t mat0 = (size_t)bh * DH * DH + (size_t)kb * DH + j0 + jw + g;
#pragma unroll
    for (int nu = 0; nu < NK; ++nu)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[nu][e] = init ? init[mat0 + (size_t)(8 * nu + 2 * c + (e & 1))
                                   * DH + 8 * (e >> 1)]
                            : 0.f;

    auto order = [&](int it) { return BACK ? chunks - 1 - it : it; };
    fetch_chunk(order(0), 0);
    if (chunks > 1) fetch_chunk(order(1), 1);
    for (int it = 0; it < chunks; ++it) {
        const int ch = order(it);
        if (it + 2 < chunks) {               // two chunks ahead
            fetch_chunk(order(it + 2), (it + 2) % NSTAGE);
            cp_async_wait<2>();
        } else if (it + 1 < chunks) {
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                     // stage it % NSTAGE is in
        const unsigned char* stage = smem + (it % NSTAGE) * L::STAGE;
        const TA* ar = reinterpret_cast<const TA*>(stage + L::A);
        const float* wr = reinterpret_cast<const float*>(stage + L::W);
        const TB* br = reinterpret_cast<const TB*>(stage + L::B);
        const int live = S - ch * BC;        // w = 1 past S
        // a~ and W, a thread per key: products of w in step order
        for (int i = tid; i < DH; i += TH) {
            float p = 1.f;
#pragma unroll
            for (int n = 0; n < BC; ++n) {
                const int t = BACK ? n : BC - 1 - n;
                *reinterpret_cast<float2*>(at + t * KS + 2 * i) =
                    split(to_float(ar[t * DH + i]) * p);
                if (t < live) p *= wr[t * DH + i];
            }
            wc[i] = p;
        }
        __syncthreads();                     // the prepared chunk is in

        // the matrix at this chunk's boundary, then X^T = B^T a~
        float* mo = out + ((size_t)bh * chunks + ch) * DH * DH +
                    (size_t)kb * DH + j0 + jw + g;
#pragma unroll
        for (int nu = 0; nu < NK; ++nu)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                mo[(size_t)(8 * nu + 2 * c + (e & 1)) * DH + 8 * (e >> 1)] =
                    s[nu][e];
        // B^T as the A operand (m = column, k = step), both k-steps of 8
        uint32_t va[2][4], vl[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = 8 * ks + c + 4 * (e >> 1);
                const float y = to_float(br[t * BS + jw + g + 8 * (e & 1)]);
                if constexpr (SPLIT_B) {
                    const float2 z = split(y);
                    va[ks][e] = __float_as_uint(z.x);
                    vl[ks][e] = __float_as_uint(z.y);
                } else {
                    va[ks][e] = __float_as_uint(y);
                }
            }
        // a tile of 8 keys at a time: X^T = B^T a~ (the k-steps in
        // accumulators of their own), then M = W M + X
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
            float x[2][4] = {};
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
                const float2 b0 = *reinterpret_cast<const float2*>(
                    at + (8 * ks + c) * KS + 2 * (kb + 8 * kk + g));
                const float2 b1 = *reinterpret_cast<const float2*>(
                    at + (8 * ks + c + 4) * KS + 2 * (kb + 8 * kk + g));
                mma(x[ks], va[ks], b0.x, b1.x);
                mma(x[ks], va[ks], b0.y, b1.y);
                if constexpr (SPLIT_B) mma(x[ks], vl[ks], b0.x, b1.x);
            }
            const float2 wv = *reinterpret_cast<const float2*>(
                wc + kb + 8 * kk + 2 * c);
            s[kk][0] = fmaf(wv.x, s[kk][0], x[0][0] + x[1][0]);
            s[kk][1] = fmaf(wv.y, s[kk][1], x[0][1] + x[1][1]);
            s[kk][2] = fmaf(wv.x, s[kk][2], x[0][2] + x[1][2]);
            s[kk][3] = fmaf(wv.y, s[kk][3], x[0][3] + x[1][3]);
        }
        __syncthreads();                     // before the next prepare
    }
    if (last) {
        float* lo = last + mat0;
#pragma unroll
        for (int nu = 0; nu < NK; ++nu)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                lo[(size_t)(8 * nu + 2 * c + (e & 1)) * DH + 8 * (e >> 1)] =
                    s[nu][e];
    }
}

struct BwdArgs {
    const void *r, *k, *v;
    const float *w, *u, *s0, *dout, *ds_fin;
    void *dr, *dk, *dv;
    float *dw, *du, *ds0;
    float *smat, *gmat, *pdu, *pdv;          // scratch
    int B, S, H, chunks;
};

// Blocks [0, B·H·CT): the forward pass (S_c); the rest: the backward
// pass (G_c and ds0). The column tile is fastest.
template <typename T, int DH>
__global__ void __launch_bounds__(StatesCfg<DH>::THREADS)
wkv_bwd_states(const BwdArgs a) {
    using C = StatesCfg<DH>;
    extern __shared__ __align__(16) unsigned char smem[];
    const long long per = (long long)a.B * a.H * C::CT;
    const bool back = blockIdx.x >= per;
    const long long x = back ? blockIdx.x - per : blockIdx.x;
    const int tile = (int)(x % C::CT);
    const long long bh = x / C::CT;
    if (back)
        states_pass<DH, T, float, true>(
            smem, static_cast<const T*>(a.r), a.dout, a.w, a.ds_fin, a.gmat,
            a.ds0, bh, a.S, a.H, a.chunks, tile);
    else
        states_pass<DH, T, T, false>(
            smem, static_cast<const T*>(a.k), static_cast<const T*>(a.v),
            a.w, a.s0, a.smat, nullptr, bh, a.S, a.H, a.chunks, tile);
}

// ----------------------------------------------------------- wkv_bwd_chunk
// A block per (b, h, chunk, tile of KT keys): the chunk's gradients as
// chunk products of S_c, G_c and its inputs (see the header), no walk over
// the steps' states.
template <int DH>
struct ChunkCfg {
    static constexpr int KT = DH < 64 ? DH : 64;     // keys a block
    static constexpr int KTILES = DH / KT;
    static constexpr int THREADS = 256, NW = THREADS / 32;
    static constexpr int MIN_BLOCKS = DH <= 64 ? 2 : 1;
    static constexpr int RS = DH + 4;        // floats a row of S_c, G_c, v...
    static constexpr int TS = BC + 1;        // floats a row of X, Y, B, A
    static constexpr int KS = 2 * KT + 8;    // floats a row of k~ {hi, lo}
    static constexpr int CWS = BC * (BC - 1) / 2 + 1;   // a key's Cw
    // float offsets: the union U holds S_c and G_c's rows first, then each
    // key's Cw and the staged dr, dk, dw
    static constexpr int U_SG = 2 * KT * RS;
    static constexpr int U_CW = KT * CWS + 3 * BC * KT;
    static constexpr int U = U_SG > U_CW ? U_SG : U_CW;
    static constexpr int R = U, K = R + BC * KT, W = K + BC * KT;
    static constexpr int V = W + BC * KT, D = V + BC * RS;
    static constexpr int P = D + BC * RS, Q = P + BC * KT;
    static constexpr int KTL = Q + BC * KT;  // k~ = k Q, split
    static constexpr int X = KTL + BC * KS, Y = X + KT * TS;
    static constexpr int B = Y + KT * TS, A = B + BC * TS;
    static constexpr int G = A + BC * TS, Z = G + KT;
    static constexpr int J = Z + BC * RS, DU = J + BC * KT;
    // a key's steps split among PARTS threads at 8, 11 and 14 (the work of
    // a step grows with t)
    static constexpr int PARTS = THREADS / KT;
    static constexpr int SMEM = DU + PARTS * KT;  // floats
    static_assert(KT % 32 == 0 && (PARTS == 4 || PARTS == 8), "parts");
};

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

// x as TF32 hi + lo by truncation: three instructions to split()'s five,
// and the products' error about 2^-20 of each (the operands' lower bits
// cut twice) against split()'s 2^-22.
__device__ __forceinline__ float2 split_trunc(float x) {
    const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
    return make_float2(
        hi, __uint_as_float(__float_as_uint(x - hi) & 0xffffe000u));
}

// One m16n8k8 tile of M = Am · Bm^T over KD (a multiple of 8): Am rows
// m0.. m0 + 15 and Bm rows n0.. n0 + 7 of row stride `ld` in shared memory,
// both float32, Am split into TF32 hi and lo, and Bm too when SB (hi·hi +
// hi·lo + lo·hi; a Bm from bf16 is exact in TF32). acc in the accumulator
// layout: (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1).
template <int KD, bool SB>
__device__ __forceinline__ void mma_nt(float (&acc)[4], const float* am,
                                       const float* bm, int lda, int ldb,
                                       int lane) {
    const int g = lane >> 2, c = lane & 3;
    float x[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < KD; k0 += 8) {
        uint32_t ah[4], al[4];
        const float av[4] = {am[g * lda + k0 + c], am[(g + 8) * lda + k0 + c],
                             am[g * lda + k0 + c + 4],
                             am[(g + 8) * lda + k0 + c + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 z = split_trunc(av[e]);
            ah[e] = __float_as_uint(z.x);
            al[e] = __float_as_uint(z.y);
        }
        float (&xs)[4] = x[(k0 >> 3) & 1];
        if constexpr (SB) {
            const float2 b0 = split_trunc(bm[g * ldb + k0 + c]);
            const float2 b1 = split_trunc(bm[g * ldb + k0 + c + 4]);
            mma(xs, ah, b0.x, b1.x);
            mma(xs, ah, b0.y, b1.y);
            mma(xs, al, b0.x, b1.x);
        } else {
            const float b0 = bm[g * ldb + k0 + c];
            const float b1 = bm[g * ldb + k0 + c + 4];
            mma(xs, ah, b0, b1);
            mma(xs, al, b0, b1);
        }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = x[0][e] + x[1][e];
}

template <typename T, int DH>
__global__ void __launch_bounds__(ChunkCfg<DH>::THREADS,
                                  ChunkCfg<DH>::MIN_BLOCKS)
wkv_bwd_chunk(const BwdArgs a) {
    using C = ChunkCfg<DH>;
    constexpr int KT = C::KT, TH = C::THREADS, RS = C::RS, TS = C::TS,
                  KS = C::KS, CWS = C::CWS, NW = C::NW;
    extern __shared__ __align__(16) float sm[];
    float* sS = sm;                          // [KT][RS]: S_c's rows
    float* sG = sm + KT * RS;                // [KT][RS]: G_c's rows
    float* sCw = sm;                         // [KT][CWS], after the products
    float* sdr = sm + KT * CWS;              // [BC][KT]
    float* sdk = sdr + BC * KT;
    float* sdw = sdk + BC * KT;
    float* sr = sm + C::R;                   // [BC][KT]
    float* sk = sm + C::K;
    float* sw = sm + C::W;
    float* sv = sm + C::V;                   // [BC][RS]
    float* sd = sm + C::D;
    float* sP = sm + C::P;                   // [BC][KT]
    float* sQ = sm + C::Q;
    float* skt = sm + C::KTL;                // [BC][KS]
    float* sX = sm + C::X;                   // [KT][TS]
    float* sY = sm + C::Y;
    float* sB = sm + C::B;                   // [BC][TS]
    float* sA = sm + C::A;
    float* sg = sm + C::G;                   // [KT]
    float* sZ = sm + C::Z;                   // [BC][RS]
    float* sJ = sm + C::J;                   // [BC][KT]
    float* sdu = sm + C::DU;                 // [PARTS][KT]

    const T* r = static_cast<const T*>(a.r);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const int S = a.S, H = a.H, chunks = a.chunks;
    const int ktile = blockIdx.x % C::KTILES;
    const long long item = blockIdx.x / C::KTILES;   // (b, h, chunk)
    const int ch = (int)(item % chunks);
    const long long bh = item / chunks;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int t0 = ch * BC, i0 = ktile * KT;
    const size_t row = (size_t)H * DH;       // stride of t
    const size_t base = ((size_t)b * S * H + h) * DH;   // (b, 0, h, 0)
    const size_t nel = (size_t)a.B * S * H * DH;

    // S_c's and G_c's rows of the tile's keys, by cp.async
    {
        const size_t mat = ((size_t)bh * chunks + ch) * DH * DH +
                           (size_t)i0 * DH;
        constexpr int PIECES = KT * DH / 4;
        for (int x = tid; x < 2 * PIECES; x += TH) {
            const int m = x / PIECES, e = x % PIECES;
            const int i = e / (DH / 4), q = e % (DH / 4);
            cp_async16(sm + m * KT * RS + i * RS + 4 * q,
                       (m ? a.gmat : a.smat) + mat + (size_t)i * DH + 4 * q,
                       true);
        }
        cp_async_commit();
    }
    // the chunk's inputs, every load in flight before the first store;
    // steps past S: w = 1 and r = k = v = dout = 0
    {
        constexpr int NI = BC * KT / TH, NJ = BC * DH / TH;
        static_assert(NI * TH == BC * KT && NJ * TH == BC * DH, "tiling");
        float lr[NI], lk[NI], lw[NI], lv[NJ], ld[NJ];
#pragma unroll
        for (int n = 0; n < NI; ++n) {
            const int e = tid + n * TH, t = t0 + e / KT;
            const bool ok = t < S;
            const size_t off = base + (size_t)t * row + i0 + e % KT;
            lr[n] = ok ? to_float(r[off]) : 0.f;
            lk[n] = ok ? to_float(k[off]) : 0.f;
            lw[n] = ok ? a.w[off] : 1.f;
        }
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
            const int e = tid + n * TH, t = t0 + e / DH;
            const bool ok = t < S;
            const size_t off = base + (size_t)t * row + e % DH;
            lv[n] = ok ? to_float(v[off]) : 0.f;
            ld[n] = ok ? a.dout[off] : 0.f;
        }
#pragma unroll
        for (int n = 0; n < NI; ++n) {
            const int e = tid + n * TH;
            sr[e] = lr[n];
            sk[e] = lk[n];
            sw[e] = lw[n];
        }
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
            const int e = tid + n * TH;
            sv[e / DH * RS + e % DH] = lv[n];
            sd[e / DH * RS + e % DH] = ld[n];
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // P_t, Q_t and k~ = k Q (split), a thread per key
    for (int i = tid; i < KT; i += TH) {
        float p = 1.f;
#pragma unroll
        for (int t = 0; t < BC; ++t) {
            sP[t * KT + i] = p;
            p *= sw[t * KT + i];
        }
        p = 1.f;
#pragma unroll
        for (int t = BC - 1; t >= 0; --t) {
            sQ[t * KT + i] = p;
            *reinterpret_cast<float2*>(skt + t * KS + 2 * i) =
                split_trunc(sk[t * KT + i] * p);
            p *= sw[t * KT + i];
        }
    }
    // g = rowsum(G_c ⊙ S_c), TH / KT lanes a key
    {
        constexpr int TPK = TH / KT;
        const int i = tid / TPK, part = tid % TPK;
        float acc = 0.f;
        for (int j = part; j < DH; j += TPK)
            acc = fmaf(sG[i * RS + j], sS[i * RS + j], acc);
#pragma unroll
        for (int o = 1; o < TPK; o <<= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (part == 0) sg[i] = acc;
    }
    // X = S_c Dout^T, Y = G_c V^T (keys × steps) and B = Dout V^T
    // (steps × steps, B[t][s] = dout_t . v_s): a warp a 16 × 8 tile
    for (int task = warp; task < KT / 4 + 2; task += NW) {
        const int which = task / (KT / 8), n0 = task % 2 * 8;
        const int m0 = which < 2 ? (task % (KT / 8)) / 2 * 16 : 0;
        const float* am = which == 0 ? sS : which == 1 ? sG : sd;
        float acc[4];
        if (which == 0)
            mma_nt<DH, true>(acc, am + m0 * RS, sd + n0 * RS, RS, RS, lane);
        else
            mma_nt<DH, sizeof(T) == 4>(acc, am + m0 * RS, sv + n0 * RS, RS,
                                       RS, lane);
        float* out = which == 0 ? sX : which == 1 ? sY : sB;
        out[(m0 + g) * TS + n0 + 2 * c] = acc[0];
        out[(m0 + g) * TS + n0 + 2 * c + 1] = acc[1];
        out[(m0 + g + 8) * TS + n0 + 2 * c] = acc[2];
        out[(m0 + g + 8) * TS + n0 + 2 * c + 1] = acc[3];
    }
    __syncthreads();

    // Z = k~ G_c (steps × columns): a warp an 8-column tile
    for (int n0 = 8 * warp; n0 < DH; n0 += 8 * NW) {
        float x[2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < KT; k0 += 8) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 z = *reinterpret_cast<const float2*>(
                    skt + (g + 8 * (e & 1)) * KS + 2 * (k0 + c + 4 * (e >> 1)));
                ah[e] = __float_as_uint(z.x);
                al[e] = __float_as_uint(z.y);
            }
            const float2 b0 = split_trunc(sG[(k0 + c) * RS + n0 + g]);
            const float2 b1 = split_trunc(sG[(k0 + c + 4) * RS + n0 + g]);
            float (&xs)[4] = x[(k0 >> 3) & 1];
            mma(xs, ah, b0.x, b1.x);
            mma(xs, ah, b0.y, b1.y);
            mma(xs, al, b0.x, b1.x);
        }
        sZ[g * RS + n0 + 2 * c] = x[0][0] + x[1][0];
        sZ[g * RS + n0 + 2 * c + 1] = x[0][1] + x[1][1];
        sZ[(g + 8) * RS + n0 + 2 * c] = x[0][2] + x[1][2];
        sZ[(g + 8) * RS + n0 + 2 * c + 1] = x[0][3] + x[1][3];
    }
    __syncthreads();                         // S_c and G_c are free

    // the keys' forward part: dr, J (to sJ) and each step's Cw (to sCw),
    // four threads a key, steps [0, 8), [8, 11), [11, 14) and [14, BC);
    // each but the first starts from Cw[T0] formed directly
    const int i = tid % KT, part = tid / KT;
    const float ui = a.u[h * DH + i0 + (tid % KT)];
    auto forward = [&](auto first, auto last) {
        constexpr int T0 = decltype(first)::value, T1 = decltype(last)::value;
        float cw[BC], du = 0.f;
        if constexpr (T0 > 0) {              // Cw[T0][s] = k_s π(s, T0)
            float p = 1.f;
#pragma unroll
            for (int s2 = T0 - 1; s2 >= 0; --s2) {
                cw[s2] = sk[s2 * KT + i] * p;
                p *= sw[s2 * KT + i];
            }
        }
#pragma unroll
        for (int t = T0; t < T1; ++t) {
            const float kt = sk[t * KT + i];
            float dri = 0.f, ji = 0.f;
#pragma unroll
            for (int s2 = 0; s2 < t; ++s2) {
                dri = fmaf(cw[s2], sB[t * TS + s2], dri);
                ji = fmaf(cw[s2], sY[i * TS + s2], ji);
                sCw[i * CWS + t * (t - 1) / 2 + s2] = cw[s2];
            }
            sJ[t * KT + i] = ji;
            const float btt = sB[t * TS + t];
            sdr[t * KT + i] = fmaf(sP[t * KT + i], sX[i * TS + t], dri) +
                              ui * kt * btt;
            du = fmaf(sr[t * KT + i] * kt, btt, du);
            const float wt = sw[t * KT + i];
#pragma unroll
            for (int s2 = 0; s2 < t; ++s2) cw[s2] *= wt;
            cw[t] = kt;
        }
        sdu[part * KT + i] = du;
    };
    // the keys' backward part: dk and dw over the same four ranges of
    // steps [T0, T1), the last from L = M = 0 and the others from L_{T1-1}
    // and M_{T1-1} formed directly, where L_t[s] = sum over tau > t of
    // r_tau π(t, tau) B[tau][s] and M_t the same over X[tau]
    auto backward = [&](auto first, auto last) {
        constexpr int T0 = decltype(first)::value, T1 = decltype(last)::value;
        float L[BC], M = 0.f;
#pragma unroll
        for (int s2 = 0; s2 < BC; ++s2) L[s2] = 0.f;
        if constexpr (T1 < BC) {
            float p = 1.f;
#pragma unroll
            for (int tau = T1; tau < BC; ++tau) {
                const float rho = sr[tau * KT + i] * p;
#pragma unroll
                for (int s2 = 0; s2 < T1; ++s2)
                    L[s2] = fmaf(rho, sB[tau * TS + s2], L[s2]);
                M = fmaf(rho, sX[i * TS + tau], M);
                p *= sw[tau * KT + i];
            }
        }
        const float gi = sg[i];
#pragma unroll
        for (int t = T1 - 1; t >= T0; --t) {
            const float pt = sP[t * KT + i], qt = sQ[t * KT + i],
                        wt = sw[t * KT + i], rt = sr[t * KT + i];
            sdk[t * KT + i] = fmaf(qt, sY[i * TS + t], L[t]) +
                              rt * ui * sB[t * TS + t];
            float d2 = 0.f;
#pragma unroll
            for (int s2 = 0; s2 < t; ++s2)
                d2 = fmaf(sCw[i * CWS + t * (t - 1) / 2 + s2], L[s2], d2);
            sdw[t * KT + i] = qt * pt * gi + qt * sJ[t * KT + i] + pt * M +
                              d2;
#pragma unroll
            for (int s2 = 0; s2 < t; ++s2)
                L[s2] = fmaf(wt, L[s2], rt * sB[t * TS + s2]);
            M = fmaf(wt, M, rt * sX[i * TS + t]);
        }
    };
    using I0 = std::integral_constant<int, 0>;
    using I8 = std::integral_constant<int, 8>;
    using I11 = std::integral_constant<int, 11>;
    using I14 = std::integral_constant<int, 14>;
    using I16 = std::integral_constant<int, BC>;
    static_assert(BC == 16, "the four ranges of steps");
    switch (part) {
        case 0: forward(I0{}, I8{}); break;
        case 1: forward(I8{}, I11{}); break;
        case 2: forward(I11{}, I14{}); break;
        case 3: forward(I14{}, I16{}); break;
        default: break;
    }
    __syncthreads();
    switch (part) {
        case 0: backward(I0{}, I8{}); break;
        case 1: backward(I8{}, I11{}); break;
        case 2: backward(I11{}, I14{}); break;
        case 3: backward(I14{}, I16{}); break;
        default: break;
    }
    __syncthreads();

    // A[t][s] = sum over the keys of r_t Cw[t][s] (s < t): two threads an
    // entry, a half of the keys each; A[t][t] = sum of r_t u k_t; du
    {
        const int e = tid >> 1, part = tid & 1;
        int t = 1;
        while ((t + 1) * t / 2 <= e) ++t;
        float acc = 0.f;
        if (e < CWS - 1)
            for (int ii = part * KT / 2; ii < (part + 1) * KT / 2; ++ii)
                acc = fmaf(sr[t * KT + ii], sCw[ii * CWS + e], acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (e < CWS - 1 && part == 0) sA[t * TS + e - t * (t - 1) / 2] = acc;
    }
    if (tid >= 2 * (CWS - 1) && tid < 2 * (CWS - 1) + BC) {
        const int t = tid - 2 * (CWS - 1);
        float acc = 0.f;
        for (int ii = 0; ii < KT; ++ii)
            acc = fmaf(sr[t * KT + ii] * a.u[h * DH + i0 + ii],
                       sk[t * KT + ii], acc);
        sA[t * TS + t] = acc;
    }
    for (int ii = tid; ii < KT; ii += TH)
        a.pdu[((size_t)bh * chunks + ch) * DH + i0 + ii] =
            (sdu[ii] + sdu[KT + ii]) + (sdu[2 * KT + ii] + sdu[3 * KT + ii]);
    __syncthreads();

    // dv = Z + sum over s >= t of A[s][t] dout_s (the tile's keys)
    for (int e = tid; e < BC * DH; e += TH) {
        const int t = e / DH, j = e % DH;
        if (t0 + t < S) {
            float acc = sZ[t * RS + j];
            for (int s2 = t; s2 < BC; ++s2)
                acc = fmaf(sA[s2 * TS + t], sd[s2 * RS + j], acc);
            const size_t off = base + (size_t)(t0 + t) * row + j;
            if constexpr (C::KTILES == 1)
                put(static_cast<T*>(a.dv) + off, acc);
            else
                a.pdv[(size_t)ktile * nel + off] = acc;
        }
    }
    // dr, dk, dw, coalesced over the keys
    for (int e = tid; e < BC * KT; e += TH) {
        const int t = e / KT;
        if (t0 + t < S) {
            const size_t off = base + (size_t)(t0 + t) * row + i0 + e % KT;
            put(static_cast<T*>(a.dr) + off, sdr[e]);
            put(static_cast<T*>(a.dk) + off, sdk[e]);
            a.dw[off] = sdw[e];
        }
    }
}

// du: the (b, chunk) partials in eight interleaved sums (chunk mod 8) over
// b and the chunks in order, then those in one order; with more
// than one key tile, dv: the tiles' partials in tile order, cast to T.
template <typename T, int KTILES>
__global__ void wkv_bwd_finish(const BwdArgs a, int DH) {
    const size_t nel = (size_t)a.B * a.S * a.H * DH;
    const size_t hd = (size_t)a.H * DH;
    const size_t total = KTILES > 1 && nel > hd ? nel : hd;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += stride) {
        if (idx < hd) {              // eight sums in flight, then in order
            const int h = (int)(idx / DH), i = (int)(idx % DH);
            float s[8] = {};
            for (int b = 0; b < a.B; ++b) {
                const float* p = a.pdu + ((size_t)(b * a.H + h) * a.chunks) *
                                 DH + i;
                int c = 0;
                for (; c + 8 <= a.chunks; c += 8)
#pragma unroll
                    for (int q = 0; q < 8; ++q) s[q] += p[(size_t)(c + q) * DH];
                for (; c < a.chunks; ++c) s[0] += p[(size_t)c * DH];
            }
            a.du[idx] = ((s[0] + s[1]) + (s[2] + s[3])) +
                        ((s[4] + s[5]) + (s[6] + s[7]));
        }
        if constexpr (KTILES > 1) {
            if (idx < nel) {
                float s = 0.f;
#pragma unroll
                for (int tl = 0; tl < KTILES; ++tl) s += a.pdv[tl * nel + idx];
                put(static_cast<T*>(a.dv) + idx, s);
            }
        }
    }
}

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

struct Plan {
    long long state_blocks;
    int state_threads;
    long long state_smem, blocks;
    int threads;
    long long smem, scratch;
};

template <typename T, int DH>
cudaError_t launch_bwd(BwdArgs a, const Plan& p, float* scratch,
                       cudaStream_t st) {
    using SC = StatesCfg<DH>;
    using SL = StatesSmem<DH, T>;
    using C = ChunkCfg<DH>;
    const long long bh = (long long)a.B * a.H;
    const size_t mats = (size_t)bh * a.chunks * DH * DH;
    const size_t nel = (size_t)a.B * a.S * a.H * DH;
    const long long want = 2LL * (long long)mats +
                           bh * a.chunks * DH +
                           (C::KTILES > 1 ? (long long)C::KTILES * nel : 0);
    if (p.state_blocks != 2 * bh * SC::CT ||
        p.state_threads != SC::THREADS ||
        p.state_smem != (long long)SL::BYTES ||
        p.blocks != bh * a.chunks * C::KTILES || p.threads != C::THREADS ||
        p.smem != (long long)sizeof(float) * C::SMEM || p.scratch != want)
        return cudaErrorInvalidValue;
    a.smat = scratch;
    a.gmat = scratch + mats;
    a.pdu = scratch + 2 * mats;
    a.pdv = C::KTILES > 1 ? a.pdu + (size_t)bh * a.chunks * DH : nullptr;
    static unsigned ready_s = 0, ready_c = 0;
    cudaError_t err = allow_smem(wkv_bwd_states<T, DH>, SL::BYTES, ready_s);
    if (err != cudaSuccess) return err;
    err = allow_smem(wkv_bwd_chunk<T, DH>, (size_t)p.smem, ready_c);
    if (err != cudaSuccess) return err;
    wkv_bwd_states<T, DH><<<dim3((unsigned)p.state_blocks),
                            dim3(SC::THREADS), SL::BYTES, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wkv_bwd_chunk<T, DH><<<dim3((unsigned)p.blocks), dim3(C::THREADS),
                           (size_t)p.smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t hd = (size_t)a.H * DH;
    const size_t total = C::KTILES > 1 && nel > hd ? nel : hd;
    const size_t want_blocks = (total + 255) / 256;
    wkv_bwd_finish<T, C::KTILES><<<(unsigned)(want_blocks < 132 * 16
                                                  ? want_blocks : 132 * 16),
                                   256, 0, st>>>(a, DH);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd_dh(const BwdArgs& a, bool bf16, const Plan& p,
                          float* scratch, cudaStream_t st) {
    return bf16 ? launch_bwd<__nv_bfloat16, DH>(a, p, scratch, st)
                : launch_bwd<float, DH>(a, p, scratch, st);
}

}  // namespace

extern "C" {

// r, k, v, dr, dk, dv (B, S, H, dh) all bf16 (bf16 = 1) or all float32;
// w, dout, dw (B, S, H, dh), u, du (H, dh), s0, ds_fin, ds0 (B, H, dh,
// dh; each may be null) float32; scratch of `scratch_floats` floats; all
// contiguous and 16-byte aligned; dh 32, 64 or 128. Launches
// wkv_bwd_states, wkv_bwd_chunk and wkv_bwd_finish with the blocks,
// threads, shared-memory bytes and scratch size of ../kernel.py's
// `plan_bwd` (refusing any other). Returns the cudaError_t (0 on
// success; cudaErrorInvalidValue for a plan not built).
int wkv_bwd_launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   const float* dout, const float* ds_fin, void* dr, void* dk,
                   void* dv, float* dw, float* du, float* ds0, float* scratch,
                   int B, int S, int H, int dh, int bf16,
                   long long state_blocks, int state_threads,
                   long long state_smem, long long blocks, int threads,
                   long long smem, long long scratch_floats, void* stream) {
    if (B < 1 || S < 1 || H < 1 || blocks < 1 || blocks > 0x7fffffffLL ||
        state_blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const BwdArgs a{r, k, v, w, u, s0, dout, ds_fin, dr, dk, dv, dw, du, ds0,
                    nullptr, nullptr, nullptr, nullptr, B, S, H,
                    (S + BC - 1) / BC};
    const Plan p{state_blocks, state_threads, state_smem, blocks, threads,
                 smem, scratch_floats};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 32: return (int)launch_bwd_dh<32>(a, bf16 != 0, p, scratch, st);
        case 64: return (int)launch_bwd_dh<64>(a, bf16 != 0, p, scratch, st);
        case 128: return (int)launch_bwd_dh<128>(a, bf16 != 0, p, scratch,
                                                 st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
