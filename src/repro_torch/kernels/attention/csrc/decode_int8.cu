// Int8 decode attention on Hopper (sm_90a): attention of a few query rows
// against an int8 KV cache with per-(b, t, kv head) bf16 scales. Plain C
// interface, loaded with ctypes by ../../_build.py beside attention.cu;
// the wrapper and its launch counter live in ../kernel.py
// (`flash_decode_int8`), the plain PyTorch version in ../ref.py
// (`attention_int8_ref`).
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
// Bound: bytes. A decode step reads the K and V cache once (B·T·KV·dh
// bytes each) and does 4·dh integer operations a (row, key); at the
// decode_32k shape (B 128, T 32768, KV 8, dh 128, 8 rows a KV head) that is
// 8.6 GB against 1.1e13 operations, 2.6 ms of bytes at 3.35 TB/s against
// 5.6 µs of int8 tensor-core rate.
//
// Design. ps needs the largest p·v_scale of the whole row before any p is
// quantized, so one online pass cannot give it. Three launches, the T
// keys cut into n_split ranges of split_keys keys (grid (n_split, KV, B)):
//   int8_stats: each block quantizes its rows' q, streams 64-key tiles of
//     K (16-byte loads) into shared memory, takes q8·k8 with __dp4a, and
//     keeps per row the largest score m, the sum of exp(s - m) and the
//     largest exp(s - m)·v_scale over its range; written to `stats`.
//   int8_pv: each block first merges every split's stats into the row's
//     max M, sum L and ps (the block of split 0 writes them to `rowps`),
//     then recomputes its range's scores, p = exp(s - M) / L · v_scale,
//     p8, and accumulates p8·v8 with __dp4a over four keys at a time (V's
//     tile transposed in shared memory with byte permutes) into int32
//     per (row, d); written to `part`.
//   int8_out: sums the splits' int32 partials (exact, so the output does
//   not depend on the split) and scales by ps.
// Integer products are exact; the scores are the same float32 products
// in the same order as the reference's. What may differ is exp and the
// sum of the softmax, by an ulp, which can move a p / ps that lies within
// an ulp of a rounding boundary to the next integer. `__dp4a` rather
// than int8 tensor cores (mma.sync m16n8k32): a first kernel that is
// right; its time stands in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

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

// Quantize rows [0, R) of (b, kvh) into t.q8 / t.qs and their positions.
// A warp a row; ends with a barrier.
template <int DH>
__device__ void quantize_q(const I8Args& a, Tile<DH>& t, int b, int kvh,
                           int g, int R) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < R; r += I_THREADS / 32) {
        const int s = r / g, h = kvh * g + r % g;
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
            t.q8[r][w] = (int)word;
        }
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

}  // extern "C"
