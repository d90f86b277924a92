// Flash attention (forward) on Hopper (sm_90a). Plain C interface, loaded
// with ctypes by ../../_build.py; the wrapper and its launch counter live
// in ../kernel.py, the plain PyTorch version in ../ref.py.
//
// Replaces `flash_attention` / `_kernel` of
// src/repro/kernels/attention/kernel.py (:26-87): blockwise online-softmax
// attention with a running max m, normaliser l and accumulator in fp32,
// masked scores of -1e30, and output acc / max(l, 1e-30) in q's dtype.
// Beyond the TPU kernel, which the model could not call as it stands:
//   - layout: q, o (B, S, H, dh) and k, v (B, T, KV, dh), as the model
//     holds them, contiguous; no transposes and no GQA repeat of K/V.
//     Query head h reads KV head h / (H / KV), as jnp.repeat does.
//   - positions: optional int32 q_pos (S,) and k_pos (T,). A negative key
//     position is an empty cache slot and is masked. Without them q_pos
//     is arange(S) + T - S and k_pos arange(T), the TPU kernel's end-
//     aligned default. Causal keeps q_pos >= k_pos, a window keeps
//     q_pos - k_pos < window.
//   - ragged lengths: any S, T >= 1 (the TPU kernel wants multiples of
//     128); the tail of the last tile is masked.
//   - a query row that may attend to no key at all comes out as zeros.
//     The kernel skips tiles no row of its block may attend to, so it
//     cannot reproduce the TPU kernel's average over masked keys there;
//     neither the model's decode (its own slot is always valid) nor
//     end-aligned causal prefill with S <= T produces such a row.
//
// Bound on an H100 SXM (700 W): 4·dh flops per allowed (query, key) pair
// and head (QK^T and PV) against 989 TFLOP/s bf16; bytes are q, k, v and
// o once each against 3.35 TB/s. Prefill (B=4, H=64, KV=8, S=T=2000,
// dh=128, causal) does about 2.6e11 flops, about 0.26 ms, against about
// 0.09 ms of bytes: operations bound it. Decode (S=1 against a 2032-slot
// cache) reads about 33 MB of K/V, about 10 µs: bytes bound it.
//
// Design. Rows of a block are (query position, head of the KV group)
// pairs: row r of KV head kvh is query s = r / g, head kvh·g + r % g, with
// g = H / KV. One block owns one (b, kvh, row tile) and streams that KV
// head's K/V tiles through shared memory once for all g heads of the
// group; decode (S = 1) gets g useful rows per tile instead of one. The
// grid is (row tiles, KV, B). A tile that no row of the block may attend
// to (causal, window, empty slots) is skipped after reading its
// positions only, which halves causal prefill. Each thread issues all
// its loads of a tile before it stores any to shared memory, so their
// latencies overlap.
//   bf16 — flash_fwd_bf16: 4 warps of 16 rows, 64-key tiles. QK^T and PV
//     run on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     accumulate); Q fragments stay in registers for the whole loop, K is
//     staged row-major and V transposed, both with rows padded by 8
//     elements so fragment reads hit 32 distinct banks. The score
//     fragment is reused in registers as the A operand of PV. The TPU
//     kernel keeps p in fp32 for PV; here p is split into two bf16 terms
//     (hi + lo, about 16 bits of mantissa) and both are multiplied, so
//     rounding p to bf16 does not enter the result.
//   f32 — flash_fwd_f32: plain FMAs (the tensor cores have no fp32 mode
//     that meets a 2e-5 tolerance; TF32 keeps about 10 bits). 32 rows,
//     16-key tiles, four threads per row; every shared array is padded to
//     avoid bank conflicts.
// No split-KV, no TMA/wgmma, no pipelining of the tile loads: a decode
// step runs B·KV blocks only. Those are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -1e30f;     // score of a masked pair, as on the TPU

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    const int* qpos;                 // (S,) or null: arange(S) + T - S
    const int* kpos;                 // (T,) or null: arange(T)
    int B, S, T, H, KV, causal, window;   // window <= 0: none
    float scale;                     // 1 / sqrt(dh)
};

__device__ __forceinline__ int q_position(const Args& a, int s) {
    return a.qpos ? a.qpos[s] : s + a.T - a.S;
}

// -1 (masked) past the end, so the ragged tail needs no other test
__device__ __forceinline__ int k_position(const Args& a, int t) {
    return t >= a.T ? -1 : (a.kpos ? a.kpos[t] : t);
}

__device__ __forceinline__ bool allowed(const Args& a, int qp, int kp) {
    return kp >= 0 && (!a.causal || qp >= kp) &&
           (a.window <= 0 || (long long)qp - kp < a.window);
}

// Can any query position in [qmin, qmax] attend to key position kp?
__device__ __forceinline__ bool needed(const Args& a, int qmin, int qmax,
                                       int kp) {
    return kp >= 0 && (!a.causal || kp <= qmax) &&
           (a.window <= 0 || (long long)qmin - kp < a.window);
}

// Element offset of row r (query s = r / g, head kvh·g + r % g) in q / o.
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int kvh,
                                             int g, int r, int dh) {
    const int s = r / g, j = r - s * g;
    return (((size_t)b * a.S + s) * a.H + (size_t)kvh * g + j) * dh;
}

// The range of query positions over rows [r0, r1) of this block, into
// *lo / *hi (shared). Ends with a barrier.
__device__ void block_q_range(const Args& a, int g, int r0, int r1, int* lo,
                              int* hi) {
    if (threadIdx.x == 0) { *lo = INT_MAX; *hi = INT_MIN; }
    __syncthreads();
    for (int s = r0 / g + threadIdx.x; s <= (r1 - 1) / g; s += blockDim.x) {
        const int p = q_position(a, s);
        atomicMin(lo, p);
        atomicMax(hi, p);
    }
    __syncthreads();
}

// The largest value over the four threads that share a row.
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ bf16
constexpr int MMA_WARPS = 4;
constexpr int MMA_BM = 16 * MMA_WARPS;   // rows per block
constexpr int MMA_BN = 64;               // keys per tile

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) as bf16 pairs hi and lo with hi + lo = (x0, x1) to ~16 bits;
// x0 goes to the low half, the lower column of an mma fragment.
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = bf16x2_bits(h);
    lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// d += a · b for one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
__global__ void __launch_bounds__(32 * MMA_WARPS)
flash_fwd_bf16(const Args a) {
    static_assert(DH % 16 == 0, "head size");
    constexpr int KP = DH + 8;          // K row pitch (elements)
    constexpr int VP = MMA_BN + 8;      // V^T row pitch (elements)
    __shared__ __align__(16) __nv_bfloat16 Ks[MMA_BN * KP];
    __shared__ __align__(16) __nv_bfloat16 Vt[DH * VP];
    __shared__ int kp_s[MMA_BN];
    __shared__ int q_lo, q_hi;

    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);

    const int g = a.H / a.KV, R = a.S * g;
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int r0 = blockIdx.x * MMA_BM;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = lane >> 2, tig = lane & 3;
    // this thread holds fragment rows grp and grp + 8 of its warp's 16
    const int rA = r0 + warp * 16 + grp, rB = rA + 8;
    const bool okA = rA < R, okB = rB < R;

    block_q_range(a, g, r0, min(r0 + MMA_BM, R), &q_lo, &q_hi);
    const int qmin = q_lo, qmax = q_hi;
    const int qpA = okA ? q_position(a, rA / g) : 0;
    const int qpB = okB ? q_position(a, rB / g) : 0;

    // Q fragments (A operand, row-major 16x16 per k-step), held all along
    uint32_t qf[DH / 16][4];
    {
        const __nv_bfloat16* qa = q + (okA ? row_offset(a, b, kvh, g, rA, DH) : 0);
        const __nv_bfloat16* qb = q + (okB ? row_offset(a, b, kvh, g, rB, DH) : 0);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
            const int c = kk * 16 + tig * 2;
            qf[kk][0] = okA ? *reinterpret_cast<const uint32_t*>(qa + c) : 0u;
            qf[kk][1] = okB ? *reinterpret_cast<const uint32_t*>(qb + c) : 0u;
            qf[kk][2] = okA ? *reinterpret_cast<const uint32_t*>(qa + c + 8) : 0u;
            qf[kk][3] = okB ? *reinterpret_cast<const uint32_t*>(qb + c + 8) : 0u;
        }
    }

    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
    float acc[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
        acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

    const size_t kv_pitch = (size_t)a.KV * DH;      // from key t to t + 1
    const size_t kv_base = ((size_t)b * a.T * a.KV + kvh) * DH;
    constexpr int CH = DH / 8;                      // 16-byte chunks a row
    constexpr int PER = MMA_BN * CH / (32 * MMA_WARPS);  // chunks a thread
    static_assert(MMA_BN * CH % (32 * MMA_WARPS) == 0, "tile split");

    for (int t0 = 0; t0 < a.T; t0 += MMA_BN) {
        __syncthreads();                            // last tile consumed
        int live = 0;
        if (tid < MMA_BN) {
            const int kp = k_position(a, t0 + tid);
            kp_s[tid] = kp;
            live = needed(a, qmin, qmax, kp);
        }
        if (!__syncthreads_or(live)) continue;

        // every thread's 16-byte chunks of K and V are loaded before any
        // is stored, so their latencies overlap instead of adding up
        uint4 kld[PER], vld[PER];
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int i = tid + u * 32 * MMA_WARPS;
            const int tk = i / CH, ck = (i % CH) * 8;       // K: row-major
            const int tv = i % MMA_BN, cv = (i / MMA_BN) * 8;  // V: t fastest
            kld[u] = vld[u] = make_uint4(0u, 0u, 0u, 0u);   // zeros past T
            if (t0 + tk < a.T)
                kld[u] = *reinterpret_cast<const uint4*>(
                    k + kv_base + (size_t)(t0 + tk) * kv_pitch + ck);
            if (t0 + tv < a.T)
                vld[u] = *reinterpret_cast<const uint4*>(
                    v + kv_base + (size_t)(t0 + tv) * kv_pitch + cv);
        }
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int i = tid + u * 32 * MMA_WARPS;
            const int tk = i / CH, ck = (i % CH) * 8;
            const int tv = i % MMA_BN, cv = (i / MMA_BN) * 8;
            *reinterpret_cast<uint4*>(Ks + tk * KP + ck) = kld[u];
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&vld[u]);
#pragma unroll
            for (int x = 0; x < 8; ++x) Vt[(cv + x) * VP + tv] = e[x];
        }
        __syncthreads();

        // S = Q K^T: n-tile j covers keys j*8 .. j*8+7 of the tile
        float sc[MMA_BN / 8][4];
#pragma unroll
        for (int j = 0; j < MMA_BN / 8; ++j) {
            sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
            const __nv_bfloat16* kr = Ks + (j * 8 + grp) * KP + tig * 2;
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
                mma_bf16(sc[j], qf[kk],
                         *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                         *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
        }

        // mask, scale, online softmax; e >> 1 picks row A or row B
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < MMA_BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int kp = kp_s[j * 8 + tig * 2 + (e & 1)];
                const float x = allowed(a, (e >> 1) ? qpB : qpA, kp)
                                    ? sc[j][e] * a.scale : MASKED;
                sc[j][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = quad_max(mx[h]);
            alpha[h] = expf(m[h] - mx[h]);
            m[h] = mx[h];
        }
#pragma unroll
        for (int j = 0; j < MMA_BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(sc[j][e] - m[e >> 1]);
                sc[j][e] = p;
                rs[e >> 1] += p;
            }
        // l stays a per-thread partial sum until the end: alpha is the
        // same on the four threads of a row
        l[0] = l[0] * alpha[0] + rs[0];
        l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
            acc[nd][0] *= alpha[0]; acc[nd][1] *= alpha[0];
            acc[nd][2] *= alpha[1]; acc[nd][3] *= alpha[1];
        }

        // O += P V: score n-tiles 2kc and 2kc+1 form the A operand of k-step kc
#pragma unroll
        for (int kc = 0; kc < MMA_BN / 16; ++kc) {
            uint32_t hi[4], lo[4];
            split_bf16x2(sc[2 * kc][0], sc[2 * kc][1], hi[0], lo[0]);
            split_bf16x2(sc[2 * kc][2], sc[2 * kc][3], hi[1], lo[1]);
            split_bf16x2(sc[2 * kc + 1][0], sc[2 * kc + 1][1], hi[2], lo[2]);
            split_bf16x2(sc[2 * kc + 1][2], sc[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int nd = 0; nd < DH / 8; ++nd) {
                const __nv_bfloat16* vr = Vt + (nd * 8 + grp) * VP + kc * 16 + tig * 2;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
                mma_bf16(acc[nd], hi, b0, b1);
                mma_bf16(acc[nd], lo, b0, b1);
            }
        }
    }

    // rows whose max never rose above MASKED saw no key: zeros
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] = quad_sum(l[h]);
        inv[h] = m[h] == MASKED ? 0.f : 1.f;
        l[h] = fmaxf(l[h], 1e-30f);
    }
    if (okA) {
        __nv_bfloat16* oa = o + row_offset(a, b, kvh, g, rA, DH) + tig * 2;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd)
            *reinterpret_cast<__nv_bfloat162*>(oa + nd * 8) = __floats2bfloat162_rn(
                inv[0] * (acc[nd][0] / l[0]), inv[0] * (acc[nd][1] / l[0]));
    }
    if (okB) {
        __nv_bfloat16* ob = o + row_offset(a, b, kvh, g, rB, DH) + tig * 2;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd)
            *reinterpret_cast<__nv_bfloat162*>(ob + nd * 8) = __floats2bfloat162_rn(
                inv[1] * (acc[nd][2] / l[1]), inv[1] * (acc[nd][3] / l[1]));
    }
}

// ------------------------------------------------------------------- f32
constexpr int F_THREADS = 128;
constexpr int F_BM = F_THREADS / 4;     // rows per block, 4 threads a row
constexpr int F_BN = 16;                // keys per tile

template <int DH>
__global__ void __launch_bounds__(F_THREADS)
flash_fwd_f32(const Args a) {
    static_assert(DH % 32 == 0, "head size");
    __shared__ float Qs[F_BM][DH + 1];  // q · scale, as the TPU kernel
    __shared__ float Ks[F_BN][DH + 1];
    __shared__ float Vs[F_BN][DH];
    __shared__ float Ps[F_BM][F_BN + 1];
    __shared__ int kp_s[F_BN];
    __shared__ int q_lo, q_hi;

    const float* q = static_cast<const float*>(a.q);
    const float* k = static_cast<const float*>(a.k);
    const float* v = static_cast<const float*>(a.v);
    float* o = static_cast<float*>(a.o);

    const int g = a.H / a.KV, R = a.S * g;
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int r0 = blockIdx.x * F_BM, r1 = min(r0 + F_BM, R);
    const int tid = threadIdx.x, row = tid >> 2, qt = tid & 3;
    const bool ok = r0 + row < R;

    block_q_range(a, g, r0, r1, &q_lo, &q_hi);
    const int qmin = q_lo, qmax = q_hi;
    const int qp = ok ? q_position(a, (r0 + row) / g) : 0;

    for (int i = tid; i < F_BM * DH; i += F_THREADS) {
        const int rr = i / DH, d = i % DH;
        Qs[rr][d] = r0 + rr < R
            ? q[row_offset(a, b, kvh, g, r0 + rr, DH) + d] * a.scale : 0.f;
    }

    float m = MASKED, l = 0.f, acc[DH / 4];
#pragma unroll
    for (int j = 0; j < DH / 4; ++j) acc[j] = 0.f;

    const size_t kv_pitch = (size_t)a.KV * DH;
    const size_t kv_base = ((size_t)b * a.T * a.KV + kvh) * DH;
    constexpr int F_PER = F_BN * DH / F_THREADS;    // elements a thread
    static_assert(F_BN * DH % F_THREADS == 0, "tile split");

    for (int t0 = 0; t0 < a.T; t0 += F_BN) {
        __syncthreads();                            // last tile consumed
        int live = 0;
        if (tid < F_BN) {
            const int kp = k_position(a, t0 + tid);
            kp_s[tid] = kp;
            live = needed(a, qmin, qmax, kp);
        }
        if (!__syncthreads_or(live)) continue;
        float kf[F_PER], vf[F_PER];     // all loads issued before stores
#pragma unroll
        for (int u = 0; u < F_PER; ++u) {
            const int i = tid + u * F_THREADS, t = i / DH, d = i % DH;
            const size_t at = kv_base + (size_t)(t0 + t) * kv_pitch + d;
            kf[u] = t0 + t < a.T ? k[at] : 0.f;
            vf[u] = t0 + t < a.T ? v[at] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < F_PER; ++u) {
            const int i = tid + u * F_THREADS, t = i / DH, d = i % DH;
            Ks[t][d] = kf[u];
            Vs[t][d] = vf[u];
        }
        __syncthreads();

        // this thread's keys are qt, qt + 4, qt + 8, qt + 12 of the tile
        float s[F_BN / 4];
#pragma unroll
        for (int i = 0; i < F_BN / 4; ++i) s[i] = 0.f;
        for (int d = 0; d < DH; ++d) {
            const float x = Qs[row][d];
#pragma unroll
            for (int i = 0; i < F_BN / 4; ++i) s[i] = fmaf(x, Ks[qt + 4 * i][d], s[i]);
        }
        float mx = m;
#pragma unroll
        for (int i = 0; i < F_BN / 4; ++i) {
            s[i] = allowed(a, qp, kp_s[qt + 4 * i]) ? s[i] : MASKED;
            mx = fmaxf(mx, s[i]);
        }
        mx = quad_max(mx);
        const float alpha = expf(m - mx);
        m = mx;
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < F_BN / 4; ++i) {
            const float p = expf(s[i] - m);
            rs += p;
            Ps[row][qt + 4 * i] = p;
        }
        l = l * alpha + rs;
        __syncwarp();                   // a row's four threads share a warp
#pragma unroll
        for (int j = 0; j < DH / 4; ++j) acc[j] *= alpha;
        for (int c = 0; c < F_BN; ++c) {
            const float p = Ps[row][c];
#pragma unroll
            for (int j = 0; j < DH / 4; ++j) acc[j] = fmaf(p, Vs[c][qt + 4 * j], acc[j]);
        }
    }

    l = fmaxf(quad_sum(l), 1e-30f);
    if (ok) {
        const float keep = m == MASKED ? 0.f : 1.f;
        float* orow = o + row_offset(a, b, kvh, g, r0 + row, DH);
#pragma unroll
        for (int j = 0; j < DH / 4; ++j) orow[qt + 4 * j] = keep * (acc[j] / l);
    }
}

template <int DH>
void launch_dh(const Args& a, bool bf16, cudaStream_t stream) {
    const long long rows = (long long)a.S * (a.H / a.KV);
    if (bf16) {
        const dim3 grid((unsigned)((rows + MMA_BM - 1) / MMA_BM), a.KV, a.B);
        flash_fwd_bf16<DH><<<grid, 32 * MMA_WARPS, 0, stream>>>(a);
    } else {
        const dim3 grid((unsigned)((rows + F_BM - 1) / F_BM), a.KV, a.B);
        flash_fwd_f32<DH><<<grid, F_THREADS, 0, stream>>>(a);
    }
}

}  // namespace

extern "C" {

// q, o (B, S, H, dh); k, v (B, T, KV, dh); contiguous, all bf16 (bf16 = 1)
// or all float32 (bf16 = 0); dh is 32, 64 or 128. qpos (S,) / kpos (T,)
// int32 or null. window <= 0 means none. Returns the launch's cudaError_t
// (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const int* qpos, const int* kpos, int B,
                           int S, int T, int H, int KV, int dh, int causal,
                           int window, int bf16, void* stream) {
    if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 ||
        (dh != 32 && dh != 64 && dh != 128))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, o, qpos, kpos, B, S, T, H, KV, causal, window,
                 (float)(1.0 / sqrt((double)dh))};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 32: launch_dh<32>(a, bf16 != 0, st); break;
        case 64: launch_dh<64>(a, bf16 != 0, st); break;
        default: launch_dh<128>(a, bf16 != 0, st); break;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
