// Mamba selective (diagonal) state-space scan, forward, on Hopper
// (sm_90a). Plain C interface, loaded with ctypes by ../../_build.py; the
// wrappers and their launch counters live in ../kernel.py, the plain
// PyTorch versions in ../ref.py. Two kernels:
//
// scan_fwd — the unfused scan, the counterpart of `selective_scan_pallas`
// / `_kernel` of src/repro/kernels/ssm/kernel.py (:24-65). For each (b, d,
// n), over a float32 state h:
//     h_t[d][n] = a_t[d][n] * h_{t-1}[d][n] + b_t[d][n]
//     y_t[d]    = sum_n h_t[d][n] * c_t[n]
// Beyond the TPU kernel, which the model could not call as it stands:
//   - layout: a, b (B, S, D, N), c (B, S, N) and y (B, S, D) as the model
//     holds them, contiguous, read in place.
//   - an optional initial state h0 (B, D, N) (null: zeros) and the final
//     state h_fin (B, D, N) as a second output, so that prefill can hand
//     its state to decode and decode can run as S = 1.
//   - any S >= 1 and any D (the TPU wrapper asserts D % 128 == 0 and
//     S % 64 == 0); N from 1 to 32.
// Everything is float32. The update rounds a*h and then the sum, as the
// plain version does (__fmul_rn / __fadd_rn keep nvcc from contracting
// them into one FMA), so h_fin can equal the plain version's bit for bit;
// y differs from it only by the order of the N-term sum.
//
// The trap carried over from the TPU: selective_scan_pallas keeps the
// (BD, N) state in VMEM scratch across a chunk grid axis that the TPU
// runs in sequence. CUDA blocks run at once and in no order, so here one
// thread owns one (b, d, n) recurrence and walks all S steps with h in a
// register; nothing carries between blocks.
//
// Bound on an H100 SXM (700 W): a and b read once (8 bytes per (b, t, d,
// n)), c, y, h0 and h_fin once, against 3.35 TB/s; the work is 4 flops
// per (b, t, d, n), far below the float32 rate. At the Jamba prefill
// shape (4, 2000, 8192, 16) that is 8.65 GB, 2.58 ms: bytes bound it.
//
// Design: the work is wide (B·D·N = 524,288 independent recurrences at
// that shape), so the whole card streams a and b once. n is fastest
// across the lanes: a group of NP lanes (N rounded up to a power of two)
// holds one d, so a warp's loads of a_t and b_t are 128 contiguous bytes
// each at N = 16. Steps go in chunks of UNROLL: a thread issues every
// load of the chunk (streaming, they are read once) before the dependent
// chain of updates, so many loads stay in flight. y_t is a shuffle
// reduction over the group's lanes; c_t is one (N,) row shared by every
// d, a cached broadcast load. Lane 0 of each group writes y_t[d].
//
// scan_fused — the same recurrence from the Mamba layer's own inputs, the
// scan the model runs (models/mamba.py). It is what JAX's `_ssm_inputs`,
// scan and D skip compute together (src/repro/models/mamba.py:47-66,
// :121-126, :143-146), without the (B, S, D, N) tensors a and b, which
// XLA built around the TPU kernel and which cost 8.4 GB of reads and
// about 25 GB of elementwise traffic per Jamba layer. For each (b, t, d,
// n), with the plain version's roundings:
//     a = expf(dt·A)      b = (dt·B_[n])·x
//     h = a·h + b         y_t[d] = sum_n h·C_[n] + D[d]·x
// dt (B, S, D) float32, A (D, N) float32, x (B, S, D), and B_, C_ (B, S,
// N) rows of the x projection at any row stride (the model passes strided
// slices of it); x, B_ and C_ are all bfloat16 or all float32 (the kernel
// is a template on that type; bf16 goes through __bfloat162float, which
// is exact); D (D,) and h0 (B, D, N) float32 or null.
//
// Bound at the Jamba prefill shape, bf16, no h0: dt, x and y once, B_,
// C_, A and h_fin: 658.5 MB, 0.197 ms at 3.35 TB/s; 7 float32 operations
// per element, 0.110 ms at 67 TFLOP/s; one MUFU.EX2 per element,
// 1.05 G on 132 SMs × 16 a clock × 1.98 GHz: 0.25 ms. The exponentials
// set the bound, and an accurate expf is about 8 instructions (range
// reduction, EX2, scale), so the rate of instruction dispatch sets the pace:
// about 15 instructions per element.
//
// Traps, each handled here:
//   - expf, not __expf, and no fast math (_build.py passes none): the
//     plain version's exp is PyTorch's CUDA exp, which is the same expf.
//   - no flush of denormals (nvcc's default -ftz=false): dt·A below about
//     -87 gives a denormal a, below about -104 it gives 0, as PyTorch's
//     exp does; a·h with a denormal a rounds as the plain version's.
//   - every product and sum is __fmul_rn / __fadd_rn, so no FMA forms:
//     h_fin can equal the plain version's bit for bit; y's N-term sum
//     takes the order of scan_fwd's shuffle reduction, the order in which
//     PyTorch's CUDA sum over 16 values also adds, so y can as well.
//   - S = 1 from h0 (decode) and ragged edges: a d past D reads zeros and
//     writes nothing; states n >= N (N rounded up to NP) run on zeros
//     (A = B_ = C_ = h = 0) and are never written. With non-finite dt or
//     x such a padded state can turn NaN and reach y, where the plain
//     version gives inf or NaN anyway.
//
// Design: a block of FT = 128 threads takes one b and DPB columns d; a
// thread holds NPT states of one d (all 16 at N = 16, so y's sum stays in
// the thread: G = NP / NPT lanes share a d, G = 1 up to N = 16), with A
// and h in registers. At the Jamba shape that is 1,024 warps, two a
// sub-partition: each step's 16 independent exponential chains are the
// latency hiding. dt and x are read once per (b, t, d) and B_, C_ once
// per (b, t) row by the block: chunks of FU steps (dt and x for the
// block's columns, the B_ and C_ rows, as float32) go to shared memory,
// double-buffered: each thread requests its coalesced loads of chunk c + 1
// into registers before it scans chunk c and stores them after, so one
// barrier per chunk separates the buffers. A and h0 come in as the
// block's contiguous slices (coalesced; at decode they are most of the
// bytes), requested with chunk 0 before the first wait, and h_fin goes
// out the same way. The tuning constants SCAN_FUSED_NPT, SCAN_FUSED_STEPS
// and SCAN_FUSED_THREADS may be set with -D
// (scripts/scan_fused_variants.py builds and times such variants);
// PERF.md gives the values measured and why these were kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_states.cuh"

#ifndef SCAN_FUSED_NPT
#define SCAN_FUSED_NPT 16        // states a thread holds (at most)
#endif
#ifndef SCAN_FUSED_STEPS
#define SCAN_FUSED_STEPS 16      // steps per shared-memory chunk
#endif
#ifndef SCAN_FUSED_THREADS
#define SCAN_FUSED_THREADS 128   // threads a block
#endif

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

template <int NP>
__global__ void __launch_bounds__(THREADS)
scan_fwd(const float* __restrict__ a, const float* __restrict__ b,
         const float* __restrict__ c, const float* __restrict__ h0,
         float* __restrict__ y, float* __restrict__ h_fin, int S, int D,
         int N, int blocks_per_b) {
    const int bi = blockIdx.x / blocks_per_b;
    const int j = (blockIdx.x - bi * blocks_per_b) * THREADS + threadIdx.x;
    const int d = j / NP, n = j % NP;
    // a dead lane (n >= N, or d past D) still walks the steps with its
    // group, so that every shuffle has all 32 lanes; it loads nothing.
    const bool live = d < D && n < N;
    const bool writer = d < D && n == 0;
    const size_t step = (size_t)D * N;                  // stride of t
    const size_t base = (size_t)bi * S * step + (size_t)d * N + n;
    const float* cb = c + (size_t)bi * S * N + n;
    float* yb = y + (size_t)bi * S * D + d;
    const size_t state = ((size_t)bi * D + d) * N + n;

    float h = (live && h0) ? h0[state] : 0.f;
    for (int t0 = 0; t0 < S; t0 += UNROLL) {
        float la[UNROLL], lb[UNROLL], lc[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {              // all loads first
            const int t = t0 + u;
            if (live && t < S) {
                const size_t off = base + (size_t)t * step;
                la[u] = __ldcs(a + off);
                lb[u] = __ldcs(b + off);
                lc[u] = __ldg(cb + (size_t)t * N);
            } else {                 // h stays as it is: 1·h + 0 == h
                la[u] = 1.f;
                lb[u] = 0.f;
                lc[u] = 0.f;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            h = __fadd_rn(__fmul_rn(la[u], h), lb[u]);
            float part = __fmul_rn(h, lc[u]);
#pragma unroll
            for (int o = NP / 2; o > 0; o >>= 1)
                part += __shfl_xor_sync(0xffffffffu, part, o);
            if (writer && t0 + u < S) yb[(size_t)(t0 + u) * D] = part;
        }
    }
    if (live) h_fin[state] = h;
}

template <int NP>
void launch_np(const float* a, const float* b, const float* c,
               const float* h0, float* y, float* h_fin, int B, int S, int D,
               int N, cudaStream_t st) {
    const long long lanes = (long long)D * NP;
    const int blocks_per_b = (int)((lanes + THREADS - 1) / THREADS);
    scan_fwd<NP><<<dim3(B * blocks_per_b), dim3(THREADS), 0, st>>>(
        a, b, c, h0, y, h_fin, S, D, N, blocks_per_b);
}

// ------------------------------------------------------------ scan_fused
constexpr int FT = SCAN_FUSED_THREADS;   // threads a block
constexpr int FU = SCAN_FUSED_STEPS;     // steps a chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
    return __ushort_as_bfloat16((unsigned short)0);
}

// NPT consecutive floats of shared memory into registers (16-byte loads
// where NPT allows; the address is then 16-byte aligned).
template <int NPT>
__device__ __forceinline__ void lds(const float* p, float* out) {
    if constexpr (NPT % 4 == 0) {
#pragma unroll
        for (int k = 0; k < NPT; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(p + k);
            out[k] = v.x; out[k + 1] = v.y; out[k + 2] = v.z; out[k + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < NPT; ++k) out[k] = p[k];
    }
}

// j with its log2(NPT) bits reversed.
template <int NPT>
__device__ constexpr int bit_reverse(int j) {
    int r = 0;
    for (int w = 1; w < NPT; w <<= 1, j >>= 1) r = (r << 1) | (j & 1);
    return r;
}

// Pairwise sum of NPT values, neighbours first, each addition rounded on
// its own. Over the values in bit-reversed order it adds as scan_fwd's
// shuffle reduction does (p[k] + p[k + NPT/2] first, then halves again),
// while each pair is ready as soon as its two values are.
template <int NPT>
__device__ __forceinline__ float tree_sum(float* q) {
#pragma unroll
    for (int w = 1; w < NPT; w <<= 1) {
#pragma unroll
        for (int j = 0; j + w < NPT; j += 2 * w) q[j] = __fadd_rn(q[j], q[j + w]);
    }
    return q[0];
}

// The block's shared memory, in floats: two chunk buffers, each dt and x
// (FU × DPB) then the B_ and C_ rows (2 × FU × NP), and the block's (d,
// n) slice of the state (rows padded to SH = NP + 4 floats, so that a
// thread's 16-byte reads of its row do not conflict). The slice of A is
// staged in buffer 1 before chunk 1 needs it.
template <int NP, int NPT>
struct FusedSmem {
    static constexpr int G = NP / NPT, DPB = FT / G, SH = NP + 4;
    static constexpr int BUF = 2 * FU * DPB + 2 * FU * NP, H = 2 * BUF,
                         FLOATS = H + DPB * SH, A = BUF;
    static_assert(DPB * SH <= BUF, "A's slice fits a chunk buffer");
};

template <typename T, int NP, int NPT>
__global__ void __launch_bounds__(FT)
scan_fused(const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const T* __restrict__ x, const float* __restrict__ Dv,
           const float* __restrict__ h0, float* __restrict__ y,
           float* __restrict__ h_fin, float* __restrict__ states, int S,
           int D, int N, long long ldb, long long ldc, int blocks_per_b) {
    using L = FusedSmem<NP, NPT>;
    constexpr int G = L::G, DPB = L::DPB, SH = L::SH;
    constexpr int PF = FU * DPB / FT;        // dt (and x) loads a chunk
    constexpr int BC = 2 * FU * NP;          // B_ and C_ values a chunk
    constexpr int PB = (BC + FT - 1) / FT;   // of which a thread loads PB
    static_assert(FT % DPB == 0 && (FU * DPB) % FT == 0, "tiling");
    static_assert(DPB * NP == FT * NPT, "a slice is NPT values a thread");
    static_assert(FU % SCAN_STATE_STEPS == 0, "states at chunk steps");

    extern __shared__ __align__(16) float smem[];
    struct Buf {
        float dx[2][FU][DPB];                // dt, x: [u][column]
        float bc[2][FU][NP];                 // B_, C_: [u][n]
    };
    Buf* sb = reinterpret_cast<Buf*>(smem);  // sb[0], sb[1]
    static_assert(sizeof(Buf) == sizeof(float) * L::BUF, "layout");
    float* sA = smem + L::A;
    float* sH = smem + L::H;

    const int bi = blockIdx.x / blocks_per_b;
    const int d0 = (blockIdx.x - bi * blocks_per_b) * DPB;
    const int dcount = min(DPB, D - d0);
    const int dl = threadIdx.x / G, g = threadIdx.x % G, n0 = g * NPT;
    const int d = d0 + dl;
    const size_t row0 = (size_t)bi * S;      // (b, t) row of t = 0
    const int slice = dcount * N;            // the block's A and h0 values

    // chunk loads, requested into registers a chunk ahead
    float pdt[PF];
    T px[PF], pbc[PB];
    const int col = threadIdx.x % DPB;       // the column this thread loads
    auto fetch = [&](int t0) {
#pragma unroll
        for (int i = 0; i < PF; ++i) {
            const int t = t0 + (threadIdx.x + i * FT) / DPB;
            const bool ok = t < S && col < dcount;
            const size_t off = (row0 + t) * D + d0 + col;
            pdt[i] = ok ? __ldcs(dt + off) : 0.f;
            px[i] = ok ? x[off] : zero_of<T>();
        }
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            const int e = threadIdx.x + i * FT;
            const int which = e / (FU * NP), r = e % (FU * NP);
            const int t = t0 + r / NP, n = r % NP;
            const bool ok = e < BC && t < S && n < N;
            pbc[i] = !ok ? zero_of<T>()
                   : which ? Cm[(row0 + t) * ldc + n]
                           : Bm[(row0 + t) * ldb + n];
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int i = 0; i < PF; ++i) {
            const int u = (threadIdx.x + i * FT) / DPB;
            sb[buf].dx[0][u][col] = pdt[i];
            sb[buf].dx[1][u][col] = to_float(px[i]);
        }
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            const int e = threadIdx.x + i * FT;
            if (e < BC) (&sb[buf].bc[0][0][0])[e] = to_float(pbc[i]);
        }
    };

    // Prologue: the block's slices of A and h0 (contiguous, so coalesced)
    // and chunk 0 are all requested before the first wait.
    float ra[NPT], rh[NPT];
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
        const int e = threadIdx.x + i * FT;
        ra[i] = e < slice ? A[(size_t)d0 * N + e] : 0.f;
        rh[i] = (h0 && e < slice) ? h0[((size_t)bi * D + d0) * N + e] : 0.f;
    }
    fetch(0);
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
        const int e = threadIdx.x + i * FT;
        if (e < slice) {
            const int r = e / N, at = r * SH + e - r * N;
            sA[at] = ra[i];
            sH[at] = rh[i];
        }
    }
    stash(0);
    __syncthreads();
    float Ar[NPT], h[NPT];
    const bool live = dl < dcount;
    lds<NPT>(sA + dl * SH + n0, Ar);
    lds<NPT>(sH + dl * SH + n0, h);
#pragma unroll
    for (int k = 0; k < NPT; ++k)            // rows past the slice, n >= N
        if (!live || n0 + k >= N) Ar[k] = h[k] = 0.f;
    const float Dd = (Dv && live) ? Dv[d] : 0.f;
    __syncthreads();                         // buffer 1 is free for chunk 1

    const int chunks = (S + FU - 1) / FU;
    const int n_states = (S + SCAN_STATE_STEPS - 1) / SCAN_STATE_STEPS;
    for (int c = 0; c < chunks; ++c) {
        const int t0 = c * FU, buf = c & 1;
        if (c + 1 < chunks) fetch(t0 + FU);
        const int steps = min(FU, S - t0);
#pragma unroll 4
        for (int u = 0; u < steps; ++u) {
            if (states && u % SCAN_STATE_STEPS == 0) {
                // the state for the backward: the warp's (d, n) rows
                // through its rows of sH (free in the loop), then out as
                // consecutive floats
                if constexpr (NPT % 4 == 0) {
#pragma unroll
                    for (int k = 0; k < NPT; k += 4)
                        *reinterpret_cast<float4*>(sH + dl * SH + n0 + k) =
                            make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]);
                } else {
#pragma unroll
                    for (int k = 0; k < NPT; ++k) sH[dl * SH + n0 + k] = h[k];
                }
                __syncwarp();
                const int lane = threadIdx.x & 31;
                const int wd0 = (threadIdx.x >> 5) * (32 / G);
                const int rows = min(32 / G, dcount - wd0);
                float* st = states + (((size_t)bi * n_states +
                                       (t0 + u) / SCAN_STATE_STEPS) * D + d0
                                      + wd0) * N;
                if (NP % 4 == 0 && N == NP) {    // rows of NP / 4 float4s
                    constexpr int Q4 = NP / 4 > 0 ? NP / 4 : 1;
                    for (int f = lane; f < rows * Q4; f += 32)
                        *reinterpret_cast<float4*>(st + f / Q4 * NP +
                                                   4 * (f % Q4)) =
                            *reinterpret_cast<const float4*>(
                                sH + (wd0 + f / Q4) * SH + 4 * (f % Q4));
                } else {
                    for (int f = lane; f < rows * N; f += 32)
                        st[f] = sH[(wd0 + f / N) * SH + f % N];
                }
                __syncwarp();
            }
            const float dtv = sb[buf].dx[0][u][dl], xv = sb[buf].dx[1][u][dl];
            float bv[NPT], cv[NPT], q[NPT];
            lds<NPT>(&sb[buf].bc[0][u][n0], bv);
            lds<NPT>(&sb[buf].bc[1][u][n0], cv);
#pragma unroll
            for (int j = 0; j < NPT; ++j) {          // states in bit-reversed
                const int k = bit_reverse<NPT>(j);   // order, for tree_sum
                const float a = expf(__fmul_rn(dtv, Ar[k]));
                const float bk = __fmul_rn(__fmul_rn(dtv, bv[k]), xv);
                h[k] = __fadd_rn(__fmul_rn(a, h[k]), bk);
                q[j] = __fmul_rn(h[k], cv[k]);
            }
            float ys = tree_sum<NPT>(q);
#pragma unroll
            for (int o = G / 2; o > 0; o >>= 1)       // the G lanes of a d
                ys = __fadd_rn(ys, __shfl_xor_sync(0xffffffffu, ys, o));
            if (g == 0 && live) {
                if (Dv) ys = __fadd_rn(ys, __fmul_rn(Dd, xv));
                y[(row0 + t0 + u) * D + d] = ys;
            }
        }
        if (c + 1 < chunks) stash(buf ^ 1);
        __syncthreads();
    }

    // h_fin: the block's slice through sH, written coalesced
#pragma unroll
    for (int k = 0; k < NPT; ++k)
        if (live && n0 + k < N) sH[dl * SH + n0 + k] = h[k];
    __syncthreads();
    float* out = h_fin + ((size_t)bi * D + d0) * N;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
        const int e = threadIdx.x + i * FT;
        if (e < slice) {
            const int r = e / N;
            out[e] = sH[r * SH + e - r * N];
        }
    }
}

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

template <typename T, int NP>
cudaError_t launch_fused_np(const float* dt, const float* A, const void* Bm,
                            const void* Cm, const void* x, const float* Dv,
                            const float* h0, float* y, float* h_fin,
                            float* states, int B, int S, int D, int N,
                            long long ldb, long long ldc, cudaStream_t st) {
    constexpr int NPT = NP < SCAN_FUSED_NPT ? NP : SCAN_FUSED_NPT;
    using L = FusedSmem<NP, NPT>;
    constexpr size_t bytes = sizeof(float) * L::FLOATS;
    if constexpr (bytes > 48 * 1024) {       // beyond the default limit
        static unsigned ready = 0;
        const cudaError_t err =
            allow_smem(scan_fused<T, NP, NPT>, bytes, ready);
        if (err != cudaSuccess) return err;
    }
    const int blocks_per_b = (D + L::DPB - 1) / L::DPB;
    scan_fused<T, NP, NPT><<<dim3(B * blocks_per_b), dim3(FT), bytes, st>>>(
        dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
        static_cast<const T*>(x), Dv, h0, y, h_fin, states, S, D, N, ldb,
        ldc, blocks_per_b);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fused_t(const float* dt, const float* A, const void* Bm,
                           const void* Cm, const void* x, const float* Dv,
                           const float* h0, float* y, float* h_fin,
                           float* states, int B, int S, int D, int N,
                           long long ldb, long long ldc, int np,
                           cudaStream_t st) {
#define SCAN_FUSED_CASE(P)                                                  \
    case P:                                                                 \
        return launch_fused_np<T, P>(dt, A, Bm, Cm, x, Dv, h0, y, h_fin,    \
                                     states, B, S, D, N, ldb, ldc, st);
    switch (np) {
        SCAN_FUSED_CASE(1)
        SCAN_FUSED_CASE(2)
        SCAN_FUSED_CASE(4)
        SCAN_FUSED_CASE(8)
        SCAN_FUSED_CASE(16)
        default: SCAN_FUSED_CASE(32)
    }
#undef SCAN_FUSED_CASE
}

}  // namespace

extern "C" {

// a, b (B, S, D, N), c (B, S, N), h0 (B, D, N) or null, y (B, S, D),
// h_fin (B, D, N); all float32 and contiguous; 1 <= N <= 32. Returns the
// launch's cudaError_t (0 on success).
int selective_scan_launch(const float* a, const float* b, const float* c,
                          const float* h0, float* y, float* h_fin, int B,
                          int S, int D, int N, void* stream) {
    if (B < 1 || S < 1 || D < 1 || N < 1 || N > 32)
        return (int)cudaErrorInvalidValue;
    int np = 1;
    while (np < N) np <<= 1;
    const long long blocks =
        (long long)B * (((long long)D * np + THREADS - 1) / THREADS);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (np) {
        case 1: launch_np<1>(a, b, c, h0, y, h_fin, B, S, D, N, st); break;
        case 2: launch_np<2>(a, b, c, h0, y, h_fin, B, S, D, N, st); break;
        case 4: launch_np<4>(a, b, c, h0, y, h_fin, B, S, D, N, st); break;
        case 8: launch_np<8>(a, b, c, h0, y, h_fin, B, S, D, N, st); break;
        case 16: launch_np<16>(a, b, c, h0, y, h_fin, B, S, D, N, st); break;
        default: launch_np<32>(a, b, c, h0, y, h_fin, B, S, D, N, st); break;
    }
    return (int)cudaGetLastError();
}

// dt (B, S, D) float32, A (D, N) float32, B_ and C_ (B, S, N) as rows of
// N at row strides ldb and ldc (elements; row b·S + t), x (B, S, D); x, B_
// and C_ bfloat16 (bf16 = 1) or float32 (bf16 = 0); Dv (D,) or null, h0
// (B, D, N) or null, y (B, S, D), h_fin (B, D, N) float32; dt, A, x, Dv,
// h0, y and h_fin contiguous; 1 <= N <= 32; states (B, ceil(S /
// SCAN_STATE_STEPS), D, N) float32 contiguous or null: the state before
// every SCAN_STATE_STEPS-th step, for the backward. Returns the launch's
// cudaError_t (0 on success).
int selective_scan_fused_launch(const float* dt, const float* A,
                                const void* Bm, const void* Cm,
                                const void* x, const float* Dv,
                                const float* h0, float* y, float* h_fin,
                                float* states, int B, int S, int D, int N,
                                long long ldb, long long ldc, int bf16,
                                void* stream) {
    if (B < 1 || S < 1 || D < 1 || N < 1 || N > 32 || ldb < 0 || ldc < 0)
        return (int)cudaErrorInvalidValue;
    int np = 1;
    while (np < N) np <<= 1;
    const int npt = np < SCAN_FUSED_NPT ? np : SCAN_FUSED_NPT;
    const long long dpb = FT / (np / npt);      // columns d a block
    if ((long long)B * ((D + dpb - 1) / dpb) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(bf16 ? launch_fused_t<__nv_bfloat16>(dt, A, Bm, Cm, x, Dv, h0,
                                                     y, h_fin, states, B, S,
                                                     D, N, ldb, ldc, np, st)
                      : launch_fused_t<float>(dt, A, Bm, Cm, x, Dv, h0, y,
                                              h_fin, states, B, S, D, N, ldb,
                                              ldc, np, st));
}

}  // extern "C"
