// Int8 decode attention on Hopper (sm_90a): attention of a few query rows
// against an int8 KV cache with per-(b, t, kv head) bf16 scales. Plain C
// interface, loaded with ctypes by ../../_build.py beside attention.cu;
// the wrapper, its plan and its launch counters live in ../kernel.py
// (`flash_decode_int8`, `plan_int8`), the plain PyTorch version in
// ../ref.py (`attention_int8_ref`).
//
// Replaces no Pallas kernel: the JAX package computes the int8 path of
// `blockwise_attention` (src/repro/models/blocks.py:112-147) with XLA
// einsums, which the port has no counterpart for. It computes exactly
// that function, at S·H/KV <= 64 rows per (b, kv head):
//   qs = max_d |q| / 127 + 1e-9 per (b, s, head) row (float32), q8 =
//   clamp(rint(q / qs)); s = float(q8·k8 in int32) · qs · (1/sqrt(dh)) ·
//   k_scale; masks kpos >= 0, causal, window (a masked score is -1e30);
//   p = softmax(s) in float32, times v_scale; ps = max_t p / 127 + 1e-12;
//   p8 = clamp(rint(p / ps)) (round half to even); out = float(p8·v8 in
//   int32) · ps, in q's dtype. A row whose keys are all masked averages
//   over all of them, as the softmax of -1e30 everywhere does.
//
// Bound: bytes. A decode step reads the K and V cache and their scales
// once (2·B·T·KV·(dh + 2) bytes) and does 4·dh integer operations a (row,
// key); at the decode_32k shape (B 128, T 32768, KV 8, dh 128, 8 rows a
// KV head) that is 8.73 GB against 1.37e11 operations: 2.605 ms of bytes
// at 3.35 TB/s against 69 µs at the int8 tensor cores' 1,979 TOPS.
//
// ps needs the largest p·v_scale of the whole row before any p is
// quantized, so one online pass over the keys cannot give it. Two routes,
// which ../kernel.py's `plan_int8` picks by shape:
//
// "cluster" (one launch, K and V each read once): a thread-block cluster
// of C blocks (1 to 16) per (b, kv head), grid (C, KV, B), 256 threads a
// block; block c takes keys [c·keys, (c + 1)·keys). Each block quantizes
// the rows' q itself (their fragments stay in registers) and streams its
// K, then its V, as one stream of C_BN-key tiles through a ring of
// C_STAGES slots (one TMA copy a tile, swizzled, zero past T, completing
// the slot's mbarrier; a tile's scales and positions are loaded into
// registers C_STAGES - 1 tiles ahead), so the first V tiles are asked
// for while the last K tiles are scored. Scores: S^T = K·q8^T on the int8 tensor cores (mma.sync
// m16n8k32, keys as M, rows as N, K's fragments by ldmatrix from a
// swizzled tile), kept in shared memory as the float32 values above with
// the keys' v_scale. Then every block reads every block's row
// statistics through distributed shared memory, after one cluster barrier
// each: the row maxima M; then, after a pass that puts e = exp(s - M) in
// place of s, the sums L of e (added in rank order, so every block holds
// the same bits) and the largest e·v_scale, E; ps = E / L / 127 + 1e-12
// (max p in exact arithmetic, as the split route takes it). A second
// pass puts p8 = rint(p / ps), p = e / L · v_scale, in place. PV: out^T =
// V^T·p8^T on the tensor cores (int8 operands are K-major only: each
// thread reads four keys' words of V and transposes them with byte
// permutes into its A fragment; its B fragment is a word of p8). The
// blocks' int32 partials are summed across the cluster (exact, so the
// output does not depend on C) and scaled by ps. No global scratch. At
// decode_32k (C 16, 2,048 keys a block) a block takes 113 KB of shared
// memory, two an SM.
//
// "split" (three launches; for rows and lengths whose scores no cluster's
// shared memory holds), the T keys cut into n_split ranges of split_keys
// keys (grid (n_split, KV, B)):
//   int8_stats: each block quantizes its rows' q, streams 64-key tiles of
//     K (16-byte loads) into shared memory, takes q8·k8 with __dp4a, and
//     keeps per row the largest score m, the sum of exp(s - m) and the
//     largest exp(s - m)·v_scale over its range; written to `stats`.
//   int8_pv: each block first merges every split's stats into the row's
//     max M, sum L and ps (the block of split 0 writes them to `rowps`),
//     then reads K again to recompute its range's scores, p = exp(s - M) /
//     L · v_scale, p8, and accumulates p8·v8 with __dp4a over four keys at
//     a time (V's tile transposed in shared memory with byte permutes)
//     into int32 per (row, d); written to `part`.
//   int8_out: sums the splits' int32 partials and scales by ps.
// On both routes the integer products are exact and the scores are the
// same float32 products in the same order as the reference's. What may
// differ is exp and the order of the softmax's sum (and, on the split
// route, ps's E / L against max(p)), by an ulp, which can move a p / ps
// that lies within an ulp of a rounding boundary to the next integer.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float MASKED = -1e30f;     // score of a masked pair
constexpr int I_THREADS = 128;
constexpr int I_BN = 64;             // keys per tile
constexpr int I_ROWS = 64;           // rows (query position, head) per block
constexpr int PW = I_BN / 4 + 1;     // padded words per transposed row

struct I8Args {
    const void* q;                   // (B, S, H, dh), bf16 or float32
    const int8_t* k;                 // (B, T, KV, dh)
    const int8_t* v;
    const __nv_bfloat16* ks;         // (B, T, KV)
    const __nv_bfloat16* vs;
    void* o;                         // (B, S, H, dh), q's dtype
    const int* qpos;                 // (S,)/(B, S) or null: arange(S) + T - S
    const int* kpos;                 // (T,)/(B, T) or null: arange(T)
    int qpos_bs, kpos_bs;            // batch strides; 0: one row shared
    int B, S, T, H, KV, causal, window, q_bf16;
    float scale;                     // 1 / sqrt(dh)
    int split_keys, n_split;
    float* stats;                    // (B, KV, n_split, R, 3): m, l, e
    int* part;                       // (B, KV, n_split, R, dh)
    float* rowps;                    // (B, KV, R, 3): M, L, ps
};

__device__ __forceinline__ int q_position(const I8Args& a, int b, int s) {
    return a.qpos ? a.qpos[(size_t)b * a.qpos_bs + s] : s + a.T - a.S;
}

__device__ __forceinline__ int k_position(const I8Args& a, int b, int t) {
    return a.kpos ? a.kpos[(size_t)b * a.kpos_bs + t] : t;
}

__device__ __forceinline__ bool allowed(const I8Args& a, int qp, int kp) {
    return kp >= 0 && (!a.causal || qp >= kp) &&
           (a.window <= 0 || (long long)qp - kp < a.window);
}

__device__ __forceinline__ float load_q(const I8Args& a, size_t i) {
    return a.q_bf16 ? __bfloat162float(
                          static_cast<const __nv_bfloat16*>(a.q)[i])
                    : static_cast<const float*>(a.q)[i];
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
    return x;
}

// Shared state both passes build: the rows' packed q8 and scales, and one
// tile of K (packed words, padded) with its keys' positions and scales.
template <int DH>
struct Tile {
    static constexpr int QW = DH / 4 + 1;   // padded words a row of q8 / k8
    int q8[I_ROWS][QW];
    float qs[I_ROWS];
    int qp[I_ROWS];
    int k8[I_BN][QW];
    int kp[I_BN];                    // INT_MIN: past the range (absent)
    float ksc[I_BN];
    float vsc[I_BN];
};

// Quantize the q row (b, s, h) into DH / 4 packed words at `words`, by
// one warp; returns its scale qs (every lane).
template <int DH>
__device__ float quantize_row(const I8Args& a, int b, int s, int h,
                              int* words) {
    const int lane = threadIdx.x & 31;
    const size_t base = (((size_t)b * a.S + s) * a.H + h) * DH;
    float x[(DH / 4 + 31) / 32][4];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < (DH / 4 + 31) / 32; ++j) {
        const int w = lane + 32 * j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            x[j][e] = w < DH / 4 ? load_q(a, base + 4 * w + e) : 0.f;
            amax = fmaxf(amax, fabsf(x[j][e]));
        }
    }
    amax = warp_max(amax);
    const float qs = amax / 127.0f + 1e-9f;
#pragma unroll
    for (int j = 0; j < (DH / 4 + 31) / 32; ++j) {
        const int w = lane + 32 * j;
        if (w >= DH / 4) continue;
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float qv = fminf(fmaxf(rintf(x[j][e] / qs), -127.f),
                                   127.f);
            word |= (uint32_t)(uint8_t)(int8_t)qv << (8 * e);
        }
        words[w] = (int)word;
    }
    return qs;
}

// Quantize rows [0, R) of (b, kvh) into t.q8 / t.qs and their positions.
// A warp a row; ends with a barrier.
template <int DH>
__device__ void quantize_q(const I8Args& a, Tile<DH>& t, int b, int kvh,
                           int g, int R) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < R; r += I_THREADS / 32) {
        const int s = r / g;
        const float qs = quantize_row<DH>(a, b, s, kvh * g + r % g, t.q8[r]);
        if (lane == 0) {
            t.qs[r] = qs;
            t.qp[r] = q_position(a, b, s);
        }
    }
    __syncthreads();
}

// Load keys [t0, t0 + I_BN) of (b, kvh) (absent past t1) into the tile.
template <int DH>
__device__ void load_k_tile(const I8Args& a, Tile<DH>& t, int b, int kvh,
                            int t0, int t1) {
    constexpr int VEC = DH / 16;             // 16-byte vectors a key
    for (int i = threadIdx.x; i < I_BN * VEC; i += I_THREADS) {
        const int key = i / VEC, c = i % VEC;
        int4 w = make_int4(0, 0, 0, 0);
        if (t0 + key < t1)
            w = *reinterpret_cast<const int4*>(
                a.k + (((size_t)b * a.T + t0 + key) * a.KV + kvh) * DH
                + 16 * c);
        t.k8[key][4 * c] = w.x;
        t.k8[key][4 * c + 1] = w.y;
        t.k8[key][4 * c + 2] = w.z;
        t.k8[key][4 * c + 3] = w.w;
    }
    if (threadIdx.x < I_BN) {
        const int key = threadIdx.x, tt = t0 + key;
        const bool here = tt < t1;
        const size_t at = ((size_t)b * a.T + tt) * a.KV + kvh;
        t.kp[key] = here ? k_position(a, b, tt) : INT_MIN;
        t.ksc[key] = here ? __bfloat162float(a.ks[at]) : 0.f;
        t.vsc[key] = here ? __bfloat162float(a.vs[at]) : 0.f;
    }
}

// The score of row r against key `key` of the tile: -INFINITY when the
// key is absent, MASKED when it is masked.
template <int DH>
__device__ __forceinline__ float score(const I8Args& a, const Tile<DH>& t,
                                       int r, int key) {
    const int kp = t.kp[key];
    if (kp == INT_MIN) return -INFINITY;
    int dot = 0;
#pragma unroll
    for (int w = 0; w < DH / 4; ++w) dot = __dp4a(t.q8[r][w], t.k8[key][w], dot);
    const float s = (float)dot * t.qs[r] * a.scale * t.ksc[key];
    return allowed(a, t.qp[r], kp) ? s : MASKED;
}

template <int DH>
__global__ void __launch_bounds__(I_THREADS)
int8_stats(const I8Args a) {
    __shared__ Tile<DH> t;
    __shared__ float sc[I_ROWS][I_BN + 1];
    __shared__ float st[I_ROWS][3];
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int g = a.H / a.KV, R = a.S * g;
    const int t_begin = split * a.split_keys;
    const int t_end = min(a.T, t_begin + a.split_keys);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = threadIdx.x; r < R; r += I_THREADS) {
        st[r][0] = -INFINITY;
        st[r][1] = 0.f;
        st[r][2] = 0.f;
    }
    quantize_q<DH>(a, t, b, kvh, g, R);
    for (int t0 = t_begin; t0 < t_end; t0 += I_BN) {
        load_k_tile<DH>(a, t, b, kvh, t0, t_end);
        __syncthreads();
        for (int i = threadIdx.x; i < R * I_BN; i += I_THREADS)
            sc[i / I_BN][i % I_BN] = score<DH>(a, t, i / I_BN, i % I_BN);
        __syncthreads();
        for (int r = warp; r < R; r += I_THREADS / 32) {
            const float s0 = sc[r][lane], s1 = sc[r][lane + 32];
            const float m_old = st[r][0];
            const float m = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
            const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m);
            const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m);
            const float l = warp_sum(p0 + p1);
            const float e = warp_max(fmaxf(p0 * t.vsc[lane],
                                           p1 * t.vsc[lane + 32]));
            if (lane == 0) {
                const float alpha = m_old == -INFINITY ? 0.f
                                                       : expf(m_old - m);
                st[r][0] = m;
                st[r][1] = st[r][1] * alpha + l;
                st[r][2] = fmaxf(st[r][2] * alpha, e);
            }
        }
        __syncthreads();
    }
    for (int r = threadIdx.x; r < R; r += I_THREADS) {
        float* out = a.stats +
            ((((size_t)b * a.KV + kvh) * a.n_split + split) * R + r) * 3;
        out[0] = st[r][0];
        out[1] = st[r][1];
        out[2] = st[r][2];
    }
}

// MR: the most rows the launch has (16 or 64), which sizes the int32
// accumulators a thread holds
template <int DH, int MR>
__global__ void __launch_bounds__(I_THREADS)
int8_pv(const I8Args a) {
    __shared__ Tile<DH> t;
    __shared__ int vt[DH][PW];               // V tile, 4 keys a word
    __shared__ int p8[I_ROWS][PW];           // quantized p, 4 keys a word
    __shared__ float rM[I_ROWS], rL[I_ROWS], rps[I_ROWS];
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int g = a.H / a.KV, R = a.S * g;
    const int t_begin = split * a.split_keys;
    const int t_end = min(a.T, t_begin + a.split_keys);

    // the row's softmax max and sum, and ps, from every split's stats
    for (int r = threadIdx.x; r < R; r += I_THREADS) {
        const float* st = a.stats + (((size_t)b * a.KV + kvh) * a.n_split
                                     * R + r) * 3;
        float M = -INFINITY;
        for (int i = 0; i < a.n_split; ++i) M = fmaxf(M, st[3 * (size_t)i * R]);
        float L = 0.f, E = 0.f;
        for (int i = 0; i < a.n_split; ++i) {
            const float* si = st + 3 * (size_t)i * R;
            const float w = si[0] == -INFINITY ? 0.f : expf(si[0] - M);
            L += si[1] * w;
            E = fmaxf(E, si[2] * w);
        }
        const float ps = E / L / 127.0f + 1e-12f;
        rM[r] = M;
        rL[r] = L;
        rps[r] = ps;
        if (split == 0) {
            float* out = a.rowps + (((size_t)b * a.KV + kvh) * R + r) * 3;
            out[0] = M;
            out[1] = L;
            out[2] = ps;
        }
    }
    quantize_q<DH>(a, t, b, kvh, g, R);

    constexpr int NACC = MR * DH / I_THREADS;
    int acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0;

    for (int t0 = t_begin; t0 < t_end; t0 += I_BN) {
        load_k_tile<DH>(a, t, b, kvh, t0, t_end);
        // V: a 4-key × 4-d block a step, transposed with byte permutes so
        // that word (d, k4) holds keys 4·k4 .. 4·k4 + 3 of column d
        for (int i = threadIdx.x; i < (I_BN / 4) * (DH / 4); i += I_THREADS) {
            const int kq = i / (DH / 4), dq = i % (DH / 4);
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int tt = t0 + 4 * kq + e;
                w[e] = tt < t_end ? *reinterpret_cast<const uint32_t*>(
                    a.v + (((size_t)b * a.T + tt) * a.KV + kvh) * DH + 4 * dq)
                    : 0u;
            }
            const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
            const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
            const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
            const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
            vt[4 * dq][kq] = (int)__byte_perm(lo01, lo23, 0x5410);
            vt[4 * dq + 1][kq] = (int)__byte_perm(lo01, lo23, 0x7632);
            vt[4 * dq + 2][kq] = (int)__byte_perm(hi01, hi23, 0x5410);
            vt[4 * dq + 3][kq] = (int)__byte_perm(hi01, hi23, 0x7632);
        }
        __syncthreads();
        // p8 for four keys of one row a step, packed into one word
        for (int i = threadIdx.x; i < R * (I_BN / 4); i += I_THREADS) {
            const int r = i / (I_BN / 4), kq = i % (I_BN / 4);
            uint32_t word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float s = score<DH>(a, t, r, 4 * kq + e);
                float q = 0.f;
                if (s != -INFINITY) {
                    const float p = expf(s - rM[r]) / rL[r]
                                    * t.vsc[4 * kq + e];
                    q = fminf(fmaxf(rintf(p / rps[r]), -127.f), 127.f);
                }
                word |= (uint32_t)(uint8_t)(int8_t)q << (8 * e);
            }
            p8[r][kq] = (int)word;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < NACC; ++j) {
            const int i = threadIdx.x + j * I_THREADS;
            const int r = i / DH, d = i % DH;
            if (r < R) {
                int x = acc[j];
#pragma unroll
                for (int kq = 0; kq < I_BN / 4; ++kq)
                    x = __dp4a(p8[r][kq], vt[d][kq], x);
                acc[j] = x;
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
        const int i = threadIdx.x + j * I_THREADS;
        const int r = i / DH, d = i % DH;
        if (r < R)
            a.part[((((size_t)b * a.KV + kvh) * a.n_split + split) * R + r)
                   * DH + d] = acc[j];
    }
}

template <int DH>
__global__ void int8_out(const I8Args a) {
    const size_t n = (size_t)a.B * a.S * a.H * DH;
    const int g = a.H / a.KV, R = a.S * g;
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        const int d = (int)(i % DH);
        const int h = (int)(i / DH % a.H);
        const int s = (int)(i / ((size_t)DH * a.H) % a.S);
        const int b = (int)(i / ((size_t)DH * a.H * a.S));
        const int kvh = h / g, r = s * g + h % g;
        const size_t base = ((size_t)b * a.KV + kvh) * a.n_split;
        int sum = 0;
        for (int sp = 0; sp < a.n_split; ++sp)
            sum += a.part[(((base + sp) * R) + r) * DH + d];
        const float ps = a.rowps[(((size_t)b * a.KV + kvh) * R + r) * 3 + 2];
        const float out = (float)sum * ps;
        if (a.q_bf16)
            static_cast<__nv_bfloat16*>(a.o)[i] = __float2bfloat16(out);
        else
            static_cast<float*>(a.o)[i] = out;
    }
}

template <int DH>
cudaError_t launch_dh(const I8Args& a, cudaStream_t st) {
    const dim3 grid(a.n_split, a.KV, a.B);
    int8_stats<DH><<<grid, I_THREADS, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (a.S * (a.H / a.KV) <= 16)
        int8_pv<DH, 16><<<grid, I_THREADS, 0, st>>>(a);
    else
        int8_pv<DH, I_ROWS><<<grid, I_THREADS, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t n = (size_t)a.B * a.S * a.H * DH;
    const unsigned blocks = (unsigned)((n + 255) / 256 < 65536
                                       ? (n + 255) / 256 : 65536);
    int8_out<DH><<<blocks, 256, 0, st>>>(a);
    return cudaGetLastError();
}

// ------------------------------------------------------- cluster route
constexpr int C_THREADS = 256;       // eight warps
constexpr int C_WARPS = C_THREADS / 32;
constexpr int C_BN = 64;             // keys a tile
constexpr int C_KWARPS = C_BN / 16;  // warps taking a tile's scores
constexpr int C_STAGES = 5;          // tiles in the ring
constexpr int C_MAX_CLUSTER = 16;
constexpr unsigned C_MAX_SMEM = 232448;   // a block's most on sm_90

// Per-row and per-tile state of a cluster block: the ring's barriers;
// q's scales and positions until the scores' loop, then the rows' merged
// statistics; this block's row statistics (red_*), which the other
// blocks of the cluster read; the score warps' row maxima, then a pass's
// per-warp sums and maxima; two K tiles' k_scale and key positions.
struct CSmall {
    uint64_t full[C_STAGES];         // a ring slot's tile has landed
    union {
        struct { float qs[I_ROWS]; int qp[I_ROWS]; } q;
        struct { float M[I_ROWS], L[I_ROWS], ps[I_ROWS]; } st;
    } u;
    float red_m[I_ROWS], red_l[I_ROWS], red_e[I_ROWS];
    union {
        float wmax[C_KWARPS][I_ROWS];
        struct { float l[I_ROWS], e[I_ROWS]; } part;
    } w;
    float kss[2][C_BN];
    int kps[2][C_BN];
};

// A cluster block's dynamic shared memory, in bytes from its first
// 1024-byte boundary (TMA's 128-byte swizzle needs it; the total counts
// the 1 KB it may cost): the ring of K / V tiles (its last slot holds q8
// [NT·8][dh] until the fragments are read), the scores [R][P] (P ≡ 4 mod
// 32 words and at least dh: they hold the int32 partial [R][dh] at the
// end), the keys' v_scale (bf16) and CSmall. kernel.py's
// `int8_cluster_smem` computes the same total.
struct CLayout {
    int P;
    unsigned scores, vsc, small, total;
};

__host__ __device__ inline CLayout cluster_layout(int R, int keys, int dh) {
    CLayout l;
    int p = ((keys > dh ? keys : dh) + 3) & ~3;
    p += (4 - p % 32 + 32) % 32;
    l.P = p;
    l.scores = (unsigned)C_STAGES * C_BN * dh;
    l.vsc = l.scores + (unsigned)R * p * 4;
    l.small = l.vsc + ((unsigned)keys * 2 + 15) / 16 * 16;
    l.total = 1024 + l.small + ((unsigned)sizeof(CSmall) + 15) / 16 * 16;
    return l;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// d += a · b for one m16n8k32 tile: s8 inputs (a row-major, b
// column-major: both K-major), s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where 16-byte chunk c of key row `key` of a K or V tile (rows of dh
// bytes) lies: TMA's 128-, 64- or 32-byte swizzle, so that ldmatrix's 8
// rows of one chunk hit 8 distinct bank groups.
template <int DH>
__device__ __forceinline__ int k_chunk(int key, int c) {
    constexpr int CH = DH / 16, SH = CH == 8 ? 0 : CH == 4 ? 1 : 2;
    return c ^ ((key >> SH) & (CH - 1));
}

// Byte transpose of four words: byte e of o[j] is byte j of w[e].
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    o[0] = __byte_perm(lo01, lo23, 0x5410);
    o[1] = __byte_perm(lo01, lo23, 0x7632);
    o[2] = __byte_perm(hi01, hi23, 0x5410);
    o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// p8 of four keys' p (0 from key `valid` on), packed low key first.
__device__ __forceinline__ uint32_t pack_p8(float4 p, int valid, float ps) {
    const float x[4] = {p.x, p.y, p.z, p.w};
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float q = e < valid
            ? fminf(fmaxf(rintf(x[e] / ps), -127.f), 127.f) : 0.f;
        word |= (uint32_t)(uint8_t)(int8_t)q << (8 * e);
    }
    return word;
}

// Element i of x in each of the cluster's C blocks, all asked for at once
// (`none` past C).
template <typename T>
__device__ __forceinline__ void gather(cg::cluster_group& cluster, T* x,
                                       int i, int C,
                                       T (&v)[C_MAX_CLUSTER], T none) {
#pragma unroll
    for (int c = 0; c < C_MAX_CLUSTER; ++c)
        v[c] = c < C ? cluster.map_shared_rank(x, c)[i] : none;
}

// Four keys' bf16 v_scale (8-byte aligned) as float32.
__device__ __forceinline__ float4 v_scales(const __nv_bfloat16* v) {
    const uint2 w = *reinterpret_cast<const uint2*>(v);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One block of a cluster: keys [rank·keys, (rank + 1)·keys) of (b, kvh),
// a.split_keys being the keys a block and a.n_split the cluster's size.
// NT: n-tiles of 8 rows (R <= 8·NT).
template <int DH, int NT>
__global__ void __launch_bounds__(C_THREADS, NT <= 2 ? 2 : 1)
int8_cluster(const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const I8Args a) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023))
                                      & 1023);
    cg::cluster_group cluster = cg::this_cluster();
    const int C = a.n_split, rank = blockIdx.x;
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int g = a.H / a.KV, R = a.S * g;
    const int t_begin = rank * a.split_keys;
    const int t_end = min(a.T, t_begin + a.split_keys);
    const int nk = max(0, t_end - t_begin);
    const int n_tiles = (nk + C_BN - 1) / C_BN;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const CLayout lay = cluster_layout(R, a.split_keys, DH);
    const int P = lay.P;
    int8_t* ring = reinterpret_cast<int8_t*>(smem);
    int8_t* q8 = ring + (C_STAGES - 1) * C_BN * DH;       // [NT·8][DH]
    float* sc = reinterpret_cast<float*>(smem + lay.scores);
    __nv_bfloat16* vsc = reinterpret_cast<__nv_bfloat16*>(smem + lay.vsc);
    CSmall& sm = *reinterpret_cast<CSmall*>(smem + lay.small);
    const size_t kv_base = (size_t)b * a.T * a.KV + kvh;   // key 0's row

    // The ring carries one stream of 2·n_tiles tiles, K's then V's: tile
    // u goes into slot u % C_STAGES by one TMA copy (keys past T zero),
    // which completes the slot's barrier, so the first V tiles are asked
    // for while the last K tiles are scored.
    auto issue = [&](int u) {
        const bool is_k = u < n_tiles;
        const int tile = is_k ? u : u - n_tiles;
        if (tile >= n_tiles || tid != 0) return;
        uint64_t* bar = &sm.full[u % C_STAGES];
        mbar_arrive_expect_tx(bar, C_BN * DH);
        tma_load_4d(ring + (u % C_STAGES) * C_BN * DH, is_k ? &kmap : &vmap,
                    bar, 0, kvh, t_begin + tile * C_BN, b);
    };
    auto landed = [&](int u) {
        mbar_wait(&sm.full[u % C_STAGES], (u / C_STAGES) & 1);
    };
    // this thread's key of a tile: k_scale, v_scale, position
    auto scales = [&](int tile, float& ks, float& vs, int& kp) {
        const int t = t_begin + tile * C_BN + tid;
        ks = vs = 0.f;
        kp = INT_MIN;
        if (tid < C_BN && t < t_end) {
            const size_t at = kv_base + (size_t)t * a.KV;
            ks = __bfloat162float(a.ks[at]);
            vs = __bfloat162float(a.vs[at]);
            kp = k_position(a, b, t);
        }
    };
    // the k_scale and positions of tile i (from registers) into buffer
    // i & 1, its v_scale into vsc
    auto publish = [&](int i, float ks, float vs, int kp) {
        if (tid < C_BN) {
            sm.kss[i & 1][tid] = ks;
            sm.kps[i & 1][tid] = kp;
            if (i * C_BN + tid < nk)
                vsc[i * C_BN + tid] = __float2bfloat16(vs);
        }
    };

    if (tid == 0) {
        for (int s = 0; s < C_STAGES; ++s) mbar_init(&sm.full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    constexpr int AHEAD = C_STAGES - 1;
    float rks[AHEAD], rvs[AHEAD];
    int rkp[AHEAD];
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        issue(s);
        if (s < n_tiles) scales(s, rks[s], rvs[s], rkp[s]);
    }

    // ---- q8, a warp a row; rows past R are zeros
    for (int r = warp; r < NT * 8; r += C_WARPS) {
        int* words = reinterpret_cast<int*>(q8 + r * DH);
        if (r < R) {
            const int s = r / g;
            const float qs = quantize_row<DH>(a, b, s, kvh * g + r % g,
                                              words);
            if (lane == 0) {
                sm.u.q.qs[r] = qs;
                sm.u.q.qp[r] = q_position(a, b, s);
            }
        } else {
            for (int w = lane; w < DH / 4; w += 32) words[w] = 0;
        }
    }
    if (n_tiles) publish(0, rks[0], rvs[0], rkp[0]);
    // q8's slot is TMA's next: order these writes before its copy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    uint32_t qf[NT][DH / 32][2];             // B fragments of q8^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int ks = 0; ks < DH / 32; ++ks) {
            const int8_t* row = q8 + (n * 8 + gid) * DH + ks * 32 + 4 * tig;
            qf[n][ks][0] = *reinterpret_cast<const uint32_t*>(row);
            qf[n][ks][1] = *reinterpret_cast<const uint32_t*>(row + 16);
        }

    // ---- scores: S^T = K · q8^T, warp w < C_KWARPS taking keys 16·w..
    // of each tile; this thread's rows n·8 + 2·tig + j of the
    // accumulators, their scale, position and running maximum
    float mx[NT][2], rqs[NT][2];
    int rqp[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int row = n * 8 + 2 * tig + j;
            mx[n][j] = -INFINITY;
            rqs[n][j] = row < R ? sm.u.q.qs[row] : 0.f;
            rqp[n][j] = row < R ? sm.u.q.qp[row] : 0;
        }
    for (int base = 0; base < n_tiles; base += AHEAD) {
#pragma unroll
        for (int s = 0; s < AHEAD; ++s) {
            const int i = base + s;
            if (i >= n_tiles) continue;
            landed(i);
            __syncthreads();                 // tile i landed; i - 1 done
            if (i + 1 < n_tiles)
                publish(i + 1, rks[(s + 1) % AHEAD], rvs[(s + 1) % AHEAD],
                        rkp[(s + 1) % AHEAD]);
            issue(i + AHEAD);
            if (i + AHEAD < n_tiles)
                scales(i + AHEAD, rks[s], rvs[s], rkp[s]);
            if (warp >= C_KWARPS) continue;
            const int8_t* tile = ring + (i % C_STAGES) * C_BN * DH;
            int acc[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
                acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
            const int lkey = warp * 16 + (lane >> 3 & 1) * 8 + (lane & 7);
#pragma unroll
            for (int ks = 0; ks < DH / 32; ++ks) {
                uint32_t af[4];
                ldmatrix_x4(af, tile + lkey * DH + 16 * k_chunk<DH>(
                    lkey, 2 * ks + (lane >> 4)));
#pragma unroll
                for (int n = 0; n < NT; ++n)
                    mma_s8(acc[n], af, qf[n][ks][0], qf[n][ks][1]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {    // keys gid and gid + 8
                const int key = warp * 16 + gid + 8 * h;
                const int kt = i * C_BN + key;
                if (kt >= nk) continue;
                const float ksc = sm.kss[i & 1][key];
                const int kp = sm.kps[i & 1][key];
#pragma unroll
                for (int n = 0; n < NT; ++n)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int row = n * 8 + 2 * tig + j;
                        if (row >= R) continue;
                        float sv = (float)acc[n][2 * h + j] * rqs[n][j]
                                   * a.scale * ksc;
                        if (!allowed(a, rqp[n][j], kp)) sv = MASKED;
                        sc[row * P + kt] = sv;
                        mx[n][j] = fmaxf(mx[n][j], sv);
                    }
            }
        }
    }
    // this block's row maxima
    if (warp < C_KWARPS) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                float m = mx[n][j];
                m = fmaxf(m, __shfl_xor_sync(~0u, m, 4));
                m = fmaxf(m, __shfl_xor_sync(~0u, m, 8));
                m = fmaxf(m, __shfl_xor_sync(~0u, m, 16));
                const int row = n * 8 + 2 * tig + j;
                if (gid == 0 && row < R) sm.w.wmax[warp][row] = m;
            }
    }
    __syncthreads();                         // wmax written
    for (int r = tid; r < R; r += C_THREADS) {
        float m = sm.w.wmax[0][r];
#pragma unroll
        for (int w = 1; w < C_KWARPS; ++w) m = fmaxf(m, sm.w.wmax[w][r]);
        sm.red_m[r] = m;
    }
    cluster.sync();
    for (int r = tid; r < R; r += C_THREADS) {
        float v[C_MAX_CLUSTER];
        gather(cluster, sm.red_m, r, C, v, -INFINITY);
        float m = v[0];
#pragma unroll
        for (int c = 1; c < C_MAX_CLUSTER; ++c) m = fmaxf(m, v[c]);
        sm.u.st.M[r] = m;
    }
    __syncthreads();

    // The two passes over the kept scores, four keys a lane: warp w takes
    // item w, w + C_WARPS, ..., item i being part i % wpr of row i / wpr
    // (keys [k_lo, k_hi), a multiple of 4 long); the parts' sums are added
    // in order, so the result does not depend on timing.
    const int wpr = R >= C_WARPS ? 1 : C_WARPS / R;
    const int chunk = ((nk + wpr - 1) / wpr + 3) & ~3;
    // e = exp(s - M) in place; this block's sums of e and largest e·v_scale
    for (int item = warp; item < R * wpr; item += C_WARPS) {
        const int r = item / wpr, k_lo = item % wpr * chunk;
        const int k_hi = min(nk, k_lo + chunk);
        float* row = sc + r * P;
        const float m = sm.u.st.M[r];
        float l = 0.f, ev = 0.f;
#pragma unroll 4
        for (int k = k_lo + 4 * lane; k < k_hi; k += 128) {
            float4 x = *reinterpret_cast<float4*>(row + k);
            const float4 v = v_scales(vsc + k);
            x.x = expf(x.x - m);
            x.y = expf(x.y - m);
            x.z = expf(x.z - m);
            x.w = expf(x.w - m);
            *reinterpret_cast<float4*>(row + k) = x;
            l += x.x;
            ev = fmaxf(ev, x.x * v.x);
            if (k + 1 < k_hi) {
                l += x.y;
                ev = fmaxf(ev, x.y * v.y);
            }
            if (k + 2 < k_hi) {
                l += x.z;
                ev = fmaxf(ev, x.z * v.z);
            }
            if (k + 3 < k_hi) {
                l += x.w;
                ev = fmaxf(ev, x.w * v.w);
            }
        }
        l = warp_sum(l);
        ev = warp_max(ev);
        if (lane == 0) {
            sm.w.part.l[item] = l;
            sm.w.part.e[item] = ev;
        }
    }
    __syncthreads();
    for (int r = tid; r < R; r += C_THREADS) {
        float l = 0.f, ev = 0.f;
        for (int j = 0; j < wpr; ++j) {
            l += sm.w.part.l[r * wpr + j];
            ev = fmaxf(ev, sm.w.part.e[r * wpr + j]);
        }
        sm.red_l[r] = l;
        sm.red_e[r] = ev;
    }
    cluster.sync();
    for (int r = tid; r < R; r += C_THREADS) {
        float vl[C_MAX_CLUSTER], ve[C_MAX_CLUSTER];
        gather(cluster, sm.red_l, r, C, vl, 0.f);
        gather(cluster, sm.red_e, r, C, ve, 0.f);
        float l = vl[0], ev = ve[0];
#pragma unroll
        for (int c = 1; c < C_MAX_CLUSTER; ++c) {   // rank order: the same
            l += vl[c];                             // bits in every block
            ev = fmaxf(ev, ve[c]);
        }
        sm.u.st.L[r] = l;
        sm.u.st.ps[r] = ev / l / 127.0f + 1e-12f;
    }
    __syncthreads();
    // p8 in place: p = e / L · v_scale, the word of keys k..k + 3 in the
    // place of e[k]
    for (int item = warp; item < R * wpr; item += C_WARPS) {
        const int r = item / wpr, k_lo = item % wpr * chunk;
        const int k_hi = min(nk, k_lo + chunk);
        float* row = sc + r * P;
        const float l = sm.u.st.L[r], ps = sm.u.st.ps[r];
#pragma unroll 4
        for (int k = k_lo + 4 * lane; k < k_hi; k += 128) {
            const float4 x = *reinterpret_cast<const float4*>(row + k);
            const float4 v = v_scales(vsc + k);
            reinterpret_cast<uint32_t*>(row)[k] = pack_p8(
                make_float4(x.x / l * v.x, x.y / l * v.y, x.z / l * v.z,
                            x.w / l * v.w), k_hi - k, ps);
        }
    }

    // ---- out^T = V^T · p8^T: a warp 32 d's (two m16 tiles: accumulator
    // j of m-tile m is d = 32·dg + 4·gid + 2·m + j / 2) over a slice of
    // each tile's 32-key steps
    constexpr int DG = DH / 32, NSL = C_WARPS / DG;
    const int dg = warp % DG, slice = warp / DG;
    const int byte = dg * 32 + 4 * gid;      // this thread's 4 d's in a row
    int acc[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
            acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0;
    for (int i = 0; i < n_tiles; ++i) {
        landed(n_tiles + i);
        __syncthreads();                     // tile landed; i - 1 done
        issue(n_tiles + i + AHEAD);
        const int8_t* tile = ring + ((n_tiles + i) % C_STAGES) * C_BN * DH;
        for (int ks = slice; ks < C_BN / 32; ks += NSL) {
            uint32_t w0[4], w1[4], t0[4], t1[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k0 = ks * 32 + 4 * tig + e, k1 = k0 + 16;
                w0[e] = *reinterpret_cast<const uint32_t*>(
                    tile + k0 * DH + 16 * k_chunk<DH>(k0, byte >> 4)
                    + (byte & 15));
                w1[e] = *reinterpret_cast<const uint32_t*>(
                    tile + k1 * DH + 16 * k_chunk<DH>(k1, byte >> 4)
                    + (byte & 15));
            }
            transpose4(w0, t0);
            transpose4(w1, t1);
            const uint32_t a0[4] = {t0[0], t0[1], t1[0], t1[1]};
            const uint32_t a1[4] = {t0[2], t0[3], t1[2], t1[3]};
            // p8 of keys kt.. (the tile holds the next block's keys past
            // nk, whose p8 is 0)
            const int kt = i * C_BN + ks * 32 + 4 * tig;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int row = n * 8 + gid;
                const uint32_t* p8 = reinterpret_cast<const uint32_t*>(
                    sc + (row < R ? row : 0) * P + kt);
                const uint32_t b0 = row < R && kt < nk ? p8[0] : 0u;
                const uint32_t b1 = row < R && kt + 16 < nk ? p8[16] : 0u;
                mma_s8(acc[0][n], a0, b0, b1);
                mma_s8(acc[1][n], a1, b0, b1);
            }
        }
    }
    __syncthreads();                         // the scores are free
    int* part = reinterpret_cast<int*>(sc);  // [R][DH]
    for (int i = tid; i < R * DH; i += C_THREADS) part[i] = 0;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int row = n * 8 + 2 * tig + (j & 1);
                if (row < R && acc[m][n][j])
                    atomicAdd(&part[row * DH + byte + 2 * m + (j >> 1)],
                              acc[m][n][j]);
            }
    cluster.sync();
    // this block's share of the R·DH outputs, summed over the cluster
    const int E = R * DH, per = (E + C - 1) / C;
    for (int i = rank * per + tid; i < min(E, (rank + 1) * per);
         i += C_THREADS) {
        int v[C_MAX_CLUSTER];
        gather(cluster, part, i, C, v, 0);
        int sum = 0;
#pragma unroll
        for (int c = 0; c < C_MAX_CLUSTER; ++c) sum += v[c];
        const int row = i / DH, s = row / g;
        const size_t at = (((size_t)b * a.S + s) * a.H + kvh * g + row % g)
                          * DH + i % DH;
        const float out = (float)sum * sm.u.st.ps[row];
        if (a.q_bf16)
            static_cast<__nv_bfloat16*>(a.o)[at] = __float2bfloat16(out);
        else
            static_cast<float*>(a.o)[at] = out;
    }
    cluster.sync();                          // keep `part` until all read
}

// K or V (B, T, KV, dh) int8 as a 4D map {dh, KV, T, B} with boxes of
// C_BN keys of one KV head, each row one swizzle span, zero past T.
bool kv_map_int8(CUtensorMap* map, const int8_t* base, const I8Args& a,
                 int dh) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)a.KV,
                                (cuuint64_t)a.T, (cuuint64_t)a.B};
    const cuuint64_t strides[3] = {(cuuint64_t)dh, (cuuint64_t)a.KV * dh,
                                   (cuuint64_t)a.T * a.KV * dh};
    const cuuint32_t box[4] = {(cuuint32_t)dh, 1, C_BN, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                  const_cast<int8_t*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  dh == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : dh == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int NT>
cudaError_t launch_cluster_nt(const I8Args& a, cudaStream_t st) {
    const int R = a.S * (a.H / a.KV);
    const CLayout lay = cluster_layout(R, a.split_keys, DH);
    CUtensorMap kmap, vmap;
    if (!kv_map_int8(&kmap, a.k, a, DH) || !kv_map_int8(&vmap, a.v, a, DH))
        return cudaErrorInvalidValue;
    auto kernel = int8_cluster<DH, NT>;
    // the same values on every call, so concurrent launches cannot undo
    // each other's
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C_MAX_SMEM);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.n_split, a.KV, a.B);
    cfg.blockDim = dim3(C_THREADS);
    cfg.dynamicSmemBytes = lay.total;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    err = cudaLaunchKernelEx(&cfg, kernel, kmap, vmap, a);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <int DH>
cudaError_t launch_cluster(const I8Args& a, cudaStream_t st) {
    const int R = a.S * (a.H / a.KV);
    if (R <= 8) return launch_cluster_nt<DH, 1>(a, st);
    if (R <= 16) return launch_cluster_nt<DH, 2>(a, st);
    if (R <= 32) return launch_cluster_nt<DH, 4>(a, st);
    return launch_cluster_nt<DH, 8>(a, st);
}

}  // namespace

extern "C" {

// q, o (B, S, H, dh) bf16 (q_bf16 = 1) or float32; k, v (B, T, KV, dh)
// int8; ks, vs (B, T, KV) bf16; all contiguous, k and v 16-byte aligned;
// dh is 32, 64 or 128 and S·H/KV <= 64. qpos (S,)/(B, S), kpos (T,)/(B, T)
// int32 or null, with batch strides qpos_bs / kpos_bs (0: one row shared).
// window <= 0 means none. split_keys: keys a split, the splits being
// ⌈T / split_keys⌉; stats float32 [B·KV·splits·R·3], part int32
// [B·KV·splits·R·dh], rowps float32 [B·KV·R·3], R = S·H/KV. Returns the
// launches' cudaError_t (0 on success).
int flash_decode_int8_launch(const void* q, const void* k, const void* v,
                             const void* ks, const void* vs, void* o,
                             const int* qpos, const int* kpos, int qpos_bs,
                             int kpos_bs, int B, int S, int T, int H, int KV,
                             int dh, int causal, int window, int q_bf16,
                             int split_keys, void* stats, void* part,
                             void* rowps, void* stream) {
    if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 ||
        S * (H / KV) > I_ROWS || split_keys < 1 || qpos_bs < 0 ||
        kpos_bs < 0 || !stats || !part || !rowps ||
        (dh != 32 && dh != 64 && dh != 128) || B > 65535 || KV > 65535)
        return (int)cudaErrorInvalidValue;
    const int n_split = (T + split_keys - 1) / split_keys;
    const I8Args a{q, static_cast<const int8_t*>(k),
                   static_cast<const int8_t*>(v),
                   static_cast<const __nv_bfloat16*>(ks),
                   static_cast<const __nv_bfloat16*>(vs), o, qpos, kpos,
                   qpos_bs, kpos_bs, B, S, T, H, KV, causal, window, q_bf16,
                   (float)(1.0 / sqrt((double)dh)), split_keys, n_split,
                   static_cast<float*>(stats), static_cast<int*>(part),
                   static_cast<float*>(rowps)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 32: return (int)launch_dh<32>(a, st);
        case 64: return (int)launch_dh<64>(a, st);
        default: return (int)launch_dh<128>(a, st);
    }
}

// The cluster route: a cluster of `cluster` blocks (1, 2, 4, 8 or 16) per
// (b, kv head), `keys` keys a block (cluster · keys >= T); the other
// arguments as above, no scratch. Returns cudaErrorInvalidValue on a
// shape it does not take (its shared memory over 227 KB among them),
// cudaErrorInvalidConfiguration when no such cluster fits on the card,
// else the launch's cudaError_t.
int flash_decode_int8_cluster_launch(const void* q, const void* k,
                                     const void* v, const void* ks,
                                     const void* vs, void* o,
                                     const int* qpos, const int* kpos,
                                     int qpos_bs, int kpos_bs, int B, int S,
                                     int T, int H, int KV, int dh,
                                     int causal, int window, int q_bf16,
                                     int cluster, int keys, void* stream) {
    if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 ||
        S * (H / KV) > I_ROWS || qpos_bs < 0 || kpos_bs < 0 ||
        (dh != 32 && dh != 64 && dh != 128) || B > 65535 || KV > 65535 ||
        cluster < 1 || cluster > C_MAX_CLUSTER ||
        (cluster & (cluster - 1)) || keys < 1 ||
        (long long)cluster * keys < T)
        return (int)cudaErrorInvalidValue;
    const int R = S * (H / KV);
    if (cluster_layout(R, keys, dh).total > C_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    const I8Args a{q, static_cast<const int8_t*>(k),
                   static_cast<const int8_t*>(v),
                   static_cast<const __nv_bfloat16*>(ks),
                   static_cast<const __nv_bfloat16*>(vs), o, qpos, kpos,
                   qpos_bs, kpos_bs, B, S, T, H, KV, causal, window, q_bf16,
                   (float)(1.0 / sqrt((double)dh)), keys, cluster,
                   nullptr, nullptr, nullptr};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 32: return (int)launch_cluster<32>(a, st);
        case 64: return (int)launch_cluster<64>(a, st);
        default: return (int)launch_cluster<128>(a, st);
    }
}

}  // extern "C"
