// Mamba selective (diagonal) state-space scan, forward, on Hopper
// (sm_90a). Plain C interface, loaded with ctypes by ../../_build.py; the
// wrapper and its launch counter live in ../kernel.py, the plain PyTorch
// version in ../ref.py.
//
// Replaces `selective_scan_pallas` / `_kernel` of
// src/repro/kernels/ssm/kernel.py (:24-65). For each (b, d, n), over a
// float32 state h:
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

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
