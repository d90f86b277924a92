// RWKV-6 wkv recurrence (forward) on Hopper (sm_90a). Plain C interface,
// loaded with ctypes by ../../_build.py; the wrapper and its launch
// counter live in ../kernel.py, the plain PyTorch version in ../ref.py.
//
// Replaces `wkv_pallas` / `_kernel` of src/repro/kernels/rwkv/kernel.py
// (:25-76). For each (b, h) and step t, over a (dh, dh) float32 state S
// (key index i, value index j):
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
// state). Everything is computed in float32.
//
// The trap carried over from the TPU: wkv_pallas keeps S in VMEM scratch
// across a chunk grid axis that the TPU runs in sequence. CUDA blocks run
// concurrently, so here one block owns one (b, h) and walks all S steps
// itself; nothing carries between blocks.
//
// Bound on an H100 SXM (700 W): per (b, t, h) 2·dh² FMAs (4·dh² flops)
// against 67 TFLOP/s float32, and r/k/v once at their width, w and out in
// float32, s0/s_fin in float32 against 3.35 TB/s. The rwkv6-3b prefill
// shape (4, 2000, 40, 64, bf16) moves about 0.29 GB (0.086 ms) against
// 5.2e9 flops (0.078 ms): bytes bound it, the two close. Decode (S = 1)
// moves the 5.2 MB state twice, about 1.6 µs; launch overhead dominates.
// The recurrence is a chain of S dependent steps per (b, h), and there
// are only B·H = 160 of those on 132 SMs, so this kernel sits well above
// the bound; it is the simple, right design.
//
// Design (that of RWKV's own reference CUDA kernel). dh threads; thread j
// owns value column j of S as dh float32 registers. Steps go in chunks of
// CHUNK: every thread issues all its global loads of the chunk (its
// element of r, k, v, w for each step) before it stores any to shared
// memory, so their latencies overlap. The per-step sum shared by every j,
// sum_i r[i] u[i] k[i], is a warp reduction of each thread's own term at
// load time, so the step needs no cross-thread reduction:
//     out[j] = sum_i r[i] S[i][j] + v[j] · sum_i r[i] u[i] k[i].
// The sum over i reads r, k, w of the step from shared memory as float4
// broadcasts and keeps four partial sums to break the FMA chain. ptxas
// reports the registers (`-Xptxas -v`); at dh = 128 a thread holds 128
// state registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <int DH>
struct Tile {
    static constexpr int CHUNK = DH == 128 ? 8 : 16;   // steps per load
    static constexpr int WARPS = DH / 32;
};

template <int DH, typename T>
__global__ void __launch_bounds__(DH)
wkv_fwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ s0,
        float* __restrict__ out, float* __restrict__ s_fin, int S, int H) {
    constexpr int CHUNK = Tile<DH>::CHUNK, WARPS = Tile<DH>::WARPS;
    __shared__ __align__(16) float sr[CHUNK][DH];
    __shared__ __align__(16) float sk[CHUNK][DH];
    __shared__ __align__(16) float sw[CHUNK][DH];
    __shared__ float sv[CHUNK][DH];
    __shared__ float bonus[CHUNK][WARPS];

    const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
    const int b = blockIdx.x / H, h = blockIdx.x - b * H;
    const size_t state0 = ((size_t)b * H + h) * DH * DH + j;
    const size_t step = (size_t)H * DH;                 // stride of t
    const size_t base = (size_t)b * S * step + (size_t)h * DH + j;
    const float uj = u[h * DH + j];

    float s[DH];                                        // S[:, j]
#pragma unroll
    for (int i = 0; i < DH; ++i) s[i] = s0 ? s0[state0 + (size_t)i * DH] : 0.f;

    for (int t0 = 0; t0 < S; t0 += CHUNK) {
        const int n = min(CHUNK, S - t0);
        float lr[CHUNK], lk[CHUNK], lv[CHUNK], lw[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {               // all loads first
            if (c < n) {
                const size_t off = base + (size_t)(t0 + c) * step;
                lr[c] = to_float(r[off]);
                lk[c] = to_float(k[off]);
                lv[c] = to_float(v[off]);
                lw[c] = w[off];
            } else {
                lr[c] = lk[c] = lv[c] = 0.f;
                lw[c] = 1.f;
            }
        }
        __syncthreads();               // the previous chunk's reads are done
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            sr[c][j] = lr[c];
            sk[c][j] = lk[c];
            sv[c][j] = lv[c];
            sw[c][j] = lw[c];
            const float part = warp_sum(lr[c] * uj * lk[c]);
            if (lane == 0) bonus[c][warp] = part;
        }
        __syncthreads();

#pragma unroll 1
        for (int c = 0; c < n; ++c) {
            const float vj = sv[c][j];
            float ruk = 0.f;
#pragma unroll
            for (int q = 0; q < WARPS; ++q) ruk += bonus[c][q];
            const float4* r4 = reinterpret_cast<const float4*>(sr[c]);
            const float4* k4 = reinterpret_cast<const float4*>(sk[c]);
            const float4* w4 = reinterpret_cast<const float4*>(sw[c]);
            float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
            for (int q = 0; q < DH / 4; ++q) {
                const float4 rr = r4[q], kk = k4[q], ww = w4[q];
                a0 = fmaf(rr.x, s[4 * q], a0);
                a1 = fmaf(rr.y, s[4 * q + 1], a1);
                a2 = fmaf(rr.z, s[4 * q + 2], a2);
                a3 = fmaf(rr.w, s[4 * q + 3], a3);
                s[4 * q] = fmaf(ww.x, s[4 * q], kk.x * vj);
                s[4 * q + 1] = fmaf(ww.y, s[4 * q + 1], kk.y * vj);
                s[4 * q + 2] = fmaf(ww.z, s[4 * q + 2], kk.z * vj);
                s[4 * q + 3] = fmaf(ww.w, s[4 * q + 3], kk.w * vj);
            }
            out[base + (size_t)(t0 + c) * step] =
                (a0 + a1) + (a2 + a3) + vj * ruk;
        }
    }

#pragma unroll
    for (int i = 0; i < DH; ++i) s_fin[state0 + (size_t)i * DH] = s[i];
}

template <int DH>
void launch_dh(const void* r, const void* k, const void* v, const float* w,
               const float* u, const float* s0, float* out, float* s_fin,
               int B, int S, int H, bool bf16, cudaStream_t st) {
    const dim3 grid(B * H), block(DH);
    if (bf16)
        wkv_fwd<DH, __nv_bfloat16><<<grid, block, 0, st>>>(
            static_cast<const __nv_bfloat16*>(r),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), w, u, s0, out, s_fin, S, H);
    else
        wkv_fwd<DH, float><<<grid, block, 0, st>>>(
            static_cast<const float*>(r), static_cast<const float*>(k),
            static_cast<const float*>(v), w, u, s0, out, s_fin, S, H);
}

}  // namespace

extern "C" {

// r, k, v (B, S, H, dh) all bf16 (bf16 = 1) or all float32 (bf16 = 0);
// w, out (B, S, H, dh), u (H, dh), s0 (or null) and s_fin (B, H, dh, dh)
// float32; all contiguous; dh is 32, 64 or 128. Returns the launch's
// cudaError_t (0 on success).
int wkv_launch(const void* r, const void* k, const void* v, const float* w,
               const float* u, const float* s0, float* out, float* s_fin,
               int B, int S, int H, int dh, int bf16, void* stream) {
    if (B < 1 || S < 1 || H < 1 || (long long)B * H > 0x7fffffffLL ||
        (dh != 32 && dh != 64 && dh != 128))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 32: launch_dh<32>(r, k, v, w, u, s0, out, s_fin, B, S, H,
                               bf16 != 0, st); break;
        case 64: launch_dh<64>(r, k, v, w, u, s0, out, s_fin, B, S, H,
                               bf16 != 0, st); break;
        default: launch_dh<128>(r, k, v, w, u, s0, out, s_fin, B, S, H,
                                bf16 != 0, st); break;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
