// Mamba's fused selective scan, backward, on Hopper (sm_90a). Plain C
// interface, loaded with ctypes by ../../_build.py beside
// selective_scan.cu (one library); the wrapper, its launch counter and
// `plan_fused_bwd` live in ../kernel.py, the plain PyTorch version
// (`selective_scan_fused_bwd_ref`) in ../ref.py.
//
// Port only: the JAX package has no kernel here. It differentiates its
// XLA scan (`chunked_diag_scan`, src/repro/models/mamba.py) by autodiff;
// the port's forward (`scan_fused`) is a ctypes launch that autograd
// cannot see through, so this kernel is its backward. For each (b, d, n),
// with a_t = exp(dt_t A[n]), h_{t-1} the state before step t and G_t the
// loss's gradient with respect to h_t:
//     G_t     = dy_t[d] C_t[n] + a_{t+1} G_{t+1}   (G_{S-1} adds dh_fin)
//     d(dt)_t = sum_n (G_t h_{t-1} a_t A[n] + G_t B_t[n] x_t)
//     dx_t    = dt_t sum_n G_t B_t[n] + D[d] dy_t
//     dA[d,n] = sum_{b,t} G_t h_{t-1} a_t dt_t,   dD[d] = sum_{b,t} dy_t x_t
//     dB_t[n] = sum_d G_t dt_t x_t,               dC_t[n] = sum_d dy_t h_t
//     dh0     = a_0 G_0
// dt, A, D, h0, dy, dh_fin, d(dt), dA, dD and dh0 are float32; x, B_, C_
// and dx, dB_, dC_ all bfloat16 or all float32 (a template on that type);
// B_ and C_ are read as rows of N at any row stride, as the forward reads
// the model's slices of its x projection, and dB_ and dC_ come out as
// contiguous (B, S, N).
//
// The trap: da_t needs h_{t-1} while G runs backwards. h_{t-1} is never
// recovered by dividing by a (exp(dt·A) underflows to 0 for dt·A below
// about -104), and not every state is stored (4.3 GB a layer at the
// Jamba train shape). The forward kernel (scan_fused) writes the state
// before each chunk of BC = SCAN_STATE_STEPS = 8 steps when asked
// (`states`, (B, S / 8, D, N)); this kernel reloads it, recomputes the
// chunk's 8 states and their a_t into registers with the forward's
// roundings (so the states equal the forward kernel's bit for bit), then
// walks the chunk backwards with G in registers: one exponential an
// element, the recomputation's. Where no forward saved the states, the
// wrapper runs scan_fused for them first, in the same launch call.
//
// Design: a block of BT = 256 threads takes one b and DPB columns d; a
// thread holds NPT = 4 states of one d (all of them when N <= 4), G = NP /
// NPT consecutive lanes sharing a d. Each chunk of dt, x, dy (the block's
// columns) and of the B_ and C_ rows goes to shared memory, the next
// chunk's loads in flight in registers while this one is walked. d(dt)
// and dx sum over n in the thread and over the d's lanes by a
// reduce-scatter of shuffles (one lane ends with d(dt), the next with
// dx's sum). dB_ and dC_ sum over d: within the warp each step through
// the warp's own two buffers of shared memory (16-byte stores, one warp
// barrier; each lane then adds one (n, B_ or C_) over the warp's d's in
// order), then over the warps once a chunk in warp order; each block
// writes its partial sums, and `scan_bwd_finish` adds the blocks in block
// order (and dA and dD over b). No block-wide barrier in the step loop,
// and no float atomics: two calls agree bit for bit.
//
// Bound on an H100 SXM (700 W) at the Jamba train shape (2, 4096, 8192,
// 16) bf16: dt, x, dy read and d(dt), dx written once per (b, t, d), B_,
// C_ and their gradients per (b, t), A, dA once (0.32 ms at 3.35 TB/s),
// which bounds it; 19 float32 flops per (b, t, d, n), each counted once
// (the state again, G, da, dA, d(dt)'s sum, the sum of G B_ that d(dt)
// and dx share, dB_, dC_, the carry), and 8 per (b, t, d), against 67
// TFLOP/s: 0.31 ms; one exponential per (b, t, d, n) on the
// special-function units, 0.26 ms. The saved states (B, S/8, D, N) and
// the blocks' partials of dB_ and dC_ are its own traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_states.cuh"

namespace {

constexpr int BT = 256;                      // threads a block
constexpr int BC = SCAN_STATE_STEPS;         // steps a chunk

template <int NP>
struct ScanBwdCfg {
    static constexpr int NPT = NP < 4 ? NP : 4, G = NP / NPT, DPB = BT / G;
    static constexpr int NW = BT / 32, DPW = 32 / G;    // d's a warp
    // a step's dB_/dC_ terms of a warp's d's: rows of 2 NP and padding, so
    // that a quarter-warp's 16-byte stores meet no bank twice
    static constexpr int WROW = 2 * NP + (NP >= 16 ? 16 : 8);
    // floats of shared memory: dt, x, dy [BC][DPB]; B_, C_ rows [BC][NP];
    // the warps' dB_/dC_ sums [BC][NW][2 NP]; each warp's terms of a step,
    // two buffers [NW][2][DPW][WROW]
    static constexpr int SMEM = 3 * BC * DPB + 2 * BC * NP + BC * NW * 2 * NP +
                                NW * 2 * DPW * WROW;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
    return __ushort_as_bfloat16((unsigned short)0);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// Sums v[0..CUR) over the lanes that differ in the bits O, 2 O, ... below
// END of the lane index, scattering: at each bit while CUR > 1 a lane
// keeps the half of the values its bit names (the upper half when set)
// and adds its partner's copy of it; once one value is left the rest of
// the bits add it whole. The order of every sum is fixed.
template <int CUR, int O, int END>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
    if constexpr (O < END) {
        if constexpr (CUR > 1) {
            const bool up = (lane & O) != 0;
#pragma unroll
            for (int i = 0; i < CUR / 2; ++i) {
                const float keep = up ? v[i + CUR / 2] : v[i];
                const float send = up ? v[i] : v[i + CUR / 2];
                v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
            }
            reduce_scatter<CUR / 2, O * 2, END>(v, lane);
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
            reduce_scatter<1, O * 2, END>(v, lane);
        }
    }
}

// Which of the V values a lane holds after reduce_scatter<V, O, END>
// (the first of the values left), and whether it is the lane that
// writes them (its bits past the scattering ones are 0).
template <int V, int O, int END>
__device__ __forceinline__ int scatter_index(int lane, bool& writer) {
    int idx = 0, cur = V;
    writer = true;
    for (int o = O; o < END; o <<= 1) {
        if (cur > 1) {
            if (lane & o) idx += cur / 2;
            cur /= 2;
        } else if (lane & o) {
            writer = false;
        }
    }
    return idx;
}

struct ScanBwdArgs {
    const float *dt, *A;
    const void *Bm, *Cm, *x;
    const float *Dv, *h0, *dy, *dh_fin, *states;
    float *ddt, *dA;
    void *dB, *dC, *dx;
    float *dD, *dh0, *scratch;
    int B, S, D, N;
    long long ldb, ldc;
    int blocks_per_b, chunks;
};

template <typename T, int NP>
__global__ void __launch_bounds__(BT, 2)
scan_bwd(const ScanBwdArgs a) {
    using C = ScanBwdCfg<NP>;
    constexpr int NPT = C::NPT, G = C::G, DPB = C::DPB, NW = C::NW;
    constexpr int V = 2 * NPT;               // dB_, dC_ terms a thread
    constexpr int PF = BC * DPB / BT;        // dt, x, dy loads a chunk
    constexpr int PB = (2 * BC * NP + BT - 1) / BT;   // B_, C_ loads
    static_assert((BC * DPB) % BT == 0, "tiling");
    extern __shared__ __align__(16) float sm[];
    float* sdt = sm;                         // [BC][DPB]
    float* sx = sdt + BC * DPB;
    float* sdy = sx + BC * DPB;
    float* sb = sdy + BC * DPB;              // [BC][NP]
    float* sc = sb + BC * NP;
    float* sred = sc + BC * NP;              // [BC][NW][2 NP]

    const int S = a.S, D = a.D, N = a.N;
    const int bi = blockIdx.x / a.blocks_per_b;
    const int blk = blockIdx.x % a.blocks_per_b;
    const int d0 = blk * DPB;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int dl = tid / G, g = tid % G, n0 = g * NPT;
    const int d = d0 + dl;
    const bool live = d < D;
    const size_t row0 = (size_t)bi * S;      // (b, t) row of t = 0
    const T* Bm = static_cast<const T*>(a.Bm);
    const T* Cm = static_cast<const T*>(a.Cm);
    const T* x = static_cast<const T*>(a.x);
    float* pbc = a.scratch;                  // (blocks, B, S, 2, N)
    float* pA = pbc + (size_t)a.blocks_per_b * a.B * S * 2 * N;   // (B, D, N)
    float* pD = pA + (size_t)a.B * D * N;    // (B, D)

    float Ar[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k)
        Ar[k] = (live && n0 + k < N) ? a.A[(size_t)d * N + n0 + k] : 0.f;

    // A chunk's loads into registers, then into shared memory; steps past
    // S, columns past D and states past N read zeros (dt = 0: a = 1 and b
    // = 0, h stays).
    const int col = tid % DPB;               // the column this thread loads
    float pdt[PF], pdy[PF];
    T px[PF], pbcv[PB];
    auto fetch = [&](int t0) {
#pragma unroll
        for (int i = 0; i < PF; ++i) {
            const int t = t0 + (tid + i * BT) / DPB;
            const bool ok = t < S && d0 + col < D;
            const size_t off = (row0 + t) * D + d0 + col;
            pdt[i] = ok ? a.dt[off] : 0.f;
            px[i] = ok ? x[off] : zero_of<T>();
            pdy[i] = ok ? a.dy[off] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            const int e = tid + i * BT;
            const int which = e / (BC * NP), r = e % (BC * NP);
            const int t = t0 + r / NP, n = r % NP;
            const bool ok = e < 2 * BC * NP && t < S && n < N;
            pbcv[i] = !ok ? zero_of<T>()
                    : which ? Cm[(row0 + t) * a.ldc + n]
                            : Bm[(row0 + t) * a.ldb + n];
        }
    };
    auto stash = [&]() {
#pragma unroll
        for (int i = 0; i < PF; ++i) {
            const int e = tid + i * BT;
            sdt[e] = pdt[i];
            sx[e] = to_f(px[i]);
            sdy[e] = pdy[i];
        }
#pragma unroll
        for (int i = 0; i < PB; ++i) {
            const int e = tid + i * BT;
            if (e < 2 * BC * NP) sb[e] = to_f(pbcv[i]);   // sb, then sc
        }
    };

    float carry[NPT], dA_acc[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
        carry[k] = (a.dh_fin && live && n0 + k < N)
                       ? a.dh_fin[((size_t)bi * D + d) * N + n0 + k] : 0.f;
        dA_acc[k] = 0.f;
    }
    const float Dd = (a.Dv && live) ? a.Dv[d] : 0.f;
    float dD_acc = 0.f;
    T* dx = static_cast<T*>(a.dx);
    // the lane that writes d(dt) (idx 0) and dx's (idx 1) of its d
    bool dd_writer;
    const int dd_idx = scatter_index<2, 1, G>(lane, dd_writer);
    // the lane's (B_ or C_, n) sums of dB_ and dC_ over the warp's d's
    const int dsub = lane / G;               // this thread's d in the warp
    float* sterm = sred + BC * NW * 2 * NP + warp * 2 * C::DPW * C::WROW;

    fetch((a.chunks - 1) * BC);
    stash();
    __syncthreads();
    for (int c = a.chunks - 1; c >= 0; --c) {
        const int t0 = c * BC;
        if (c > 0) fetch(t0 - BC);           // in flight during the walk
        float h[NPT];
#pragma unroll
        for (int k = 0; k < NPT; ++k)
            h[k] = (live && n0 + k < N)
                       ? a.states[(((size_t)bi * a.chunks + c) * D + d) * N +
                                  n0 + k]
                       : 0.f;
        float hs[BC][NPT], as[BC][NPT];      // h_{t-1} and a_t of each step
#pragma unroll
        for (int uu = 0; uu < BC; ++uu) {
            const float dtv = sdt[uu * DPB + dl], xv = sx[uu * DPB + dl];
#pragma unroll
            for (int k = 0; k < NPT; ++k) {
                hs[uu][k] = h[k];
                const float av = expf(__fmul_rn(dtv, Ar[k]));
                as[uu][k] = av;
                const float bv = __fmul_rn(__fmul_rn(dtv, sb[uu * NP + n0 + k]),
                                           xv);
                h[k] = __fadd_rn(__fmul_rn(av, h[k]), bv);
            }
        }
        // h is now h_t of the chunk's last step
#pragma unroll
        for (int uu = BC - 1; uu >= 0; --uu) {
            const int t = t0 + uu;
            const float dtv = sdt[uu * DPB + dl], xv = sx[uu * DPB + dl],
                        dyv = sdy[uu * DPB + dl];
            const float dtx = dtv * xv;
            float dd[2] = {0.f, 0.f};        // sum of da A, sum of G B_
            float v[V];                      // dB_ terms, then dC_ terms
#pragma unroll
            for (int k = 0; k < NPT; ++k) {
                const float bn = sb[uu * NP + n0 + k],
                            cn = sc[uu * NP + n0 + k];
                const float gk = fmaf(dyv, cn, carry[k]);
                v[NPT + k] = dyv * h[k];
                carry[k] = as[uu][k] * gk;   // a_t G_t, also da's factor
                const float da = carry[k] * hs[uu][k];
                dA_acc[k] = fmaf(da, dtv, dA_acc[k]);
                dd[0] = fmaf(da, Ar[k], dd[0]);
                dd[1] = fmaf(gk, bn, dd[1]);
                v[k] = gk * dtx;
                h[k] = hs[uu][k];
            }
            dd[0] = fmaf(dd[1], xv, dd[0]);  // d(dt)'s part: + x sum G B_
            reduce_scatter<2, 1, G>(dd, lane);       // the d's lanes
            if (live && t < S && dd_writer) {
                const size_t off = (row0 + t) * D + d;
                if constexpr (G == 1) {
                    a.ddt[off] = dd[0];
                    put(dx + off, fmaf(dd[1], dtv, Dd * dyv));
                    dD_acc = fmaf(dyv, xv, dD_acc);
                } else if (dd_idx == 0) {
                    a.ddt[off] = dd[0];
                    dD_acc = fmaf(dyv, xv, dD_acc);
                } else {
                    put(dx + off, fmaf(dd[0], dtv, Dd * dyv));
                }
            }
            // dB_, dC_ over the warp's d's: the terms through this warp's
            // buffer for the step, each lane then adding one (B_ or C_, n)
            // over the d's in order
            float* buf = sterm + (uu & 1) * C::DPW * C::WROW + dsub * C::WROW;
            if constexpr (NPT % 4 == 0) {
#pragma unroll
                for (int k = 0; k < NPT; k += 4) {
                    *reinterpret_cast<float4*>(buf + n0 + k) =
                        make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
                    *reinterpret_cast<float4*>(buf + NP + n0 + k) =
                        make_float4(v[NPT + k], v[NPT + k + 1],
                                    v[NPT + k + 2], v[NPT + k + 3]);
                }
            } else {
#pragma unroll
                for (int k = 0; k < NPT; ++k) {
                    buf[n0 + k] = v[k];
                    buf[NP + n0 + k] = v[NPT + k];
                }
            }
            __syncwarp();
            const float* tb = sterm + (uu & 1) * C::DPW * C::WROW;
            for (int vi = lane; vi < 2 * NP; vi += 32) {
                float acc = 0.f;
#pragma unroll
                for (int ds = 0; ds < C::DPW; ++ds) acc += tb[ds * C::WROW + vi];
                sred[(uu * NW + warp) * 2 * NP + vi] = acc;
            }
        }
        __syncthreads();                     // the warps' sums are in
        for (int e = tid; e < BC * 2 * NP; e += BT) {
            const int uu = e / (2 * NP), wn = e % (2 * NP);
            const int w = wn / NP, n = wn % NP, t = t0 + uu;
            if (t < S && n < N) {
                float acc = 0.f;
#pragma unroll
                for (int ww = 0; ww < NW; ++ww)
                    acc += sred[(uu * NW + ww) * 2 * NP + wn];
                pbc[(((size_t)blk * a.B + bi) * S + t) * 2 * N + w * N + n] =
                    acc;
            }
        }
        if (c > 0) stash();                  // the walk is done with it
        __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
        if (!live || n0 + k >= N) continue;
        const size_t at = ((size_t)bi * D + d) * N + n0 + k;
        if (a.dh0) a.dh0[at] = carry[k];
        pA[at] = dA_acc[k];
    }
    if (live && dd_writer && (G == 1 || dd_idx == 0))
        pD[(size_t)bi * D + d] = dD_acc;
}

// dB_ and dC_ (cast to T): the blocks' partial sums added in block order;
// dA and dD: the per-b partials added in b order.
template <typename T>
__global__ void scan_bwd_finish(const float* __restrict__ pbc,
                                const float* __restrict__ pA,
                                const float* __restrict__ pD, T* dB, T* dC,
                                float* dA, float* dD, int B, int S, int D,
                                int N, int blocks_per_b) {
    const size_t rows = (size_t)B * S * N, dn = (size_t)D * N;
    const size_t total = rows > dn ? rows : dn;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += stride) {
        if (idx < rows) {
            const size_t bt = idx / N, n = idx % N;
            float s0 = 0.f, s1 = 0.f;
            for (int blk = 0; blk < blocks_per_b; ++blk) {
                const size_t at = ((size_t)blk * B * S + bt) * 2 * N + n;
                s0 += pbc[at];
                s1 += pbc[at + N];
            }
            put(dB + idx, s0);
            put(dC + idx, s1);
        }
        if (idx < dn) {
            float s = 0.f;
            for (int b = 0; b < B; ++b) s += pA[(size_t)b * dn + idx];
            dA[idx] = s;
        }
        if (dD && idx < (size_t)D) {
            float s = 0.f;
            for (int b = 0; b < B; ++b) s += pD[(size_t)b * D + idx];
            dD[idx] = s;
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

template <typename T, int NP>
cudaError_t launch_bwd_np(ScanBwdArgs a, long long scratch_floats,
                          cudaStream_t st) {
    using C = ScanBwdCfg<NP>;
    a.blocks_per_b = (a.D + C::DPB - 1) / C::DPB;
    a.chunks = (a.S + BC - 1) / BC;
    const long long want = (long long)a.blocks_per_b * a.B * a.S * 2 * a.N +
                           (long long)a.B * a.D * a.N + (long long)a.B * a.D;
    const long long blocks = (long long)a.B * a.blocks_per_b;
    if (scratch_floats != want || blocks > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    constexpr size_t bytes = sizeof(float) * C::SMEM;
    static unsigned ready = 0;
    cudaError_t err = allow_smem(scan_bwd<T, NP>, bytes, ready);
    if (err != cudaSuccess) return err;
    scan_bwd<T, NP><<<dim3((unsigned)blocks), dim3(BT), bytes, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t rows = (size_t)a.B * a.S * a.N, dn = (size_t)a.D * a.N;
    const size_t total = rows > dn ? rows : dn;
    const size_t grid = (total + 255) / 256;
    float* pbc = a.scratch;
    float* pA = pbc + (size_t)a.blocks_per_b * a.B * a.S * 2 * a.N;
    scan_bwd_finish<T><<<(unsigned)(grid < 132 * 16 ? grid : 132 * 16), 256, 0,
                         st>>>(pbc, pA, pA + dn * a.B, static_cast<T*>(a.dB),
                               static_cast<T*>(a.dC), a.dA, a.dD, a.B, a.S,
                               a.D, a.N, a.blocks_per_b);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_t(const ScanBwdArgs& a, int np,
                         long long scratch_floats, cudaStream_t st) {
    switch (np) {
        case 1: return launch_bwd_np<T, 1>(a, scratch_floats, st);
        case 2: return launch_bwd_np<T, 2>(a, scratch_floats, st);
        case 4: return launch_bwd_np<T, 4>(a, scratch_floats, st);
        case 8: return launch_bwd_np<T, 8>(a, scratch_floats, st);
        case 16: return launch_bwd_np<T, 16>(a, scratch_floats, st);
        default: return launch_bwd_np<T, 32>(a, scratch_floats, st);
    }
}

}  // namespace

extern "C" {

// The fused scan's inputs as selective_scan_fused_launch takes them, dy
// (B, S, D) float32 contiguous, dh_fin (B, D, N) float32 or null and the
// forward's chunk states (B, ceil(S / SCAN_STATE_STEPS), D, N) float32;
// out: ddt (B, S, D) float32, dA (D, N) float32, dB, dC (B, S, N) and dx
// (B, S, D) in x's dtype, dD (D,) float32 (null when Dv is), dh0 (B, D,
// N) float32 or null; scratch of `scratch_floats` floats, which must be
// ../kernel.py's `plan_fused_bwd` size. Launches scan_bwd, then
// scan_bwd_finish. Returns the cudaError_t (0 on success).
int selective_scan_fused_bwd_launch(
        const float* dt, const float* A, const void* Bm, const void* Cm,
        const void* x, const float* Dv, const float* h0, const float* dy,
        const float* dh_fin, const float* states, float* ddt, float* dA,
        void* dB, void* dC, void* dx, float* dD, float* dh0, float* scratch,
        int B, int S, int D, int N, long long ldb, long long ldc, int bf16,
        long long scratch_floats, void* stream) {
    if (B < 1 || S < 1 || D < 1 || N < 1 || N > 32 || ldb < 0 || ldc < 0 ||
        states == nullptr || (dD != nullptr) != (Dv != nullptr))
        return (int)cudaErrorInvalidValue;
    int np = 1;
    while (np < N) np <<= 1;
    const ScanBwdArgs a{dt, A, Bm, Cm, x, Dv, h0, dy, dh_fin, states, ddt,
                        dA, dB, dC, dx, dD, dh0, scratch, B, S, D, N, ldb,
                        ldc, 0, 0};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(bf16 ? launch_bwd_t<__nv_bfloat16>(a, np, scratch_floats, st)
                      : launch_bwd_t<float>(a, np, scratch_floats, st));
}

}  // extern "C"
