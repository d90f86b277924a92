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
// Jamba train shape). A forward sweep saves the state before each chunk
// of BC = 16 steps in the scratch buffer; the reverse sweep reloads it,
// recomputes the chunk's 16 states into registers with the forward's
// roundings (so they equal the forward kernel's bit for bit), then walks
// the chunk backwards with G in registers.
//
// Design: scan_fused's layout with fewer states a thread: a block of BT =
// 256 threads takes one b and DPB columns d; a thread holds NPT = 4
// states of one d (all of them when N <= 4), G = NP / NPT consecutive
// lanes sharing a d. Each chunk of dt, x, dy (the block's columns) and of
// the B_ and C_ rows goes to shared memory. d(dt) and dx sum over n in
// the thread and over the d's lanes by shuffles. dB_ and dC_ sum over d,
// across blocks: every U = 4 steps the block's per-(d, n) terms go
// through shared memory and are added over its DPB columns in one order;
// each block writes its partial sums, and `scan_bwd_finish` adds the
// blocks in block order (and dA and dD over b). No float atomics: two
// calls agree bit for bit.
//
// Bound on an H100 SXM (700 W) at the Jamba train shape (2, 4096, 8192,
// 16) bf16: dt, x, dy read and d(dt), dx written once per (b, t, d), B_,
// C_ and their gradients per (b, t), A, dA once (0.32 ms at 3.35 TB/s),
// which bounds it; 19 float32 flops per (b, t, d, n), each counted once
// (the state again, G, da, dA, d(dt)'s sum, the sum of G B_ that d(dt)
// and dx share, dB_, dC_, the carry), and 8 per (b, t, d), against 67
// TFLOP/s: 0.31 ms; one exponential per (b, t, d, n) on the
// special-function units, 0.26 ms. This kernel takes the exponential three times (the
// saving sweep, the chunk's recomputed states, the step's own a_t), and
// its saved states (B, S/16, D, N) and the blocks' partials of dB_ and
// dC_ are its own traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 256;                      // threads a block
constexpr int BC = 16;                       // steps a chunk
constexpr int U = 4;                         // steps a dB_/dC_ reduction

template <int NP>
struct ScanBwdCfg {
    static constexpr int NPT = NP < 4 ? NP : 4, G = NP / NPT, DPB = BT / G;
    // floats of shared memory: dt, x, dy [BC][DPB]; B_, C_ rows [BC][NP];
    // the dB_/dC_ terms of U steps [U][DPB][2 NP]
    static constexpr int SMEM = 3 * BC * DPB + 2 * BC * NP + U * DPB * 2 * NP;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

struct ScanBwdArgs {
    const float *dt, *A;
    const void *Bm, *Cm, *x;
    const float *Dv, *h0, *dy, *dh_fin;
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
    constexpr int NPT = C::NPT, G = C::G, DPB = C::DPB;
    constexpr int OUT = U * 2 * NP, TPO = BT / OUT;   // threads an output
    static_assert(BC % U == 0 && BT % OUT == 0 && TPO <= 32, "tiling");
    extern __shared__ __align__(16) float sm[];
    float* sdt = sm;                         // [BC][DPB]
    float* sx = sdt + BC * DPB;
    float* sdy = sx + BC * DPB;
    float* sb = sdy + BC * DPB;              // [BC][NP]
    float* sc = sb + BC * NP;
    float* sred = sc + BC * NP;              // [U][DPB][2 NP]

    const int S = a.S, D = a.D, N = a.N;
    const int bi = blockIdx.x / a.blocks_per_b;
    const int blk = blockIdx.x % a.blocks_per_b;
    const int d0 = blk * DPB;
    const int tid = threadIdx.x, dl = tid / G, g = tid % G, n0 = g * NPT;
    const int d = d0 + dl;
    const bool live = d < D;
    const size_t row0 = (size_t)bi * S;      // (b, t) row of t = 0
    const T* Bm = static_cast<const T*>(a.Bm);
    const T* Cm = static_cast<const T*>(a.Cm);
    const T* x = static_cast<const T*>(a.x);
    float* ckpt = a.scratch;                 // (B, chunks, D, N)
    float* pbc = ckpt + (size_t)a.B * a.chunks * D * N;  // (blocks, B, S, 2, N)
    float* pA = pbc + (size_t)a.blocks_per_b * a.B * S * 2 * N;   // (B, D, N)
    float* pD = pA + (size_t)a.B * D * N;    // (B, D)

    float Ar[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k)
        Ar[k] = (live && n0 + k < N) ? a.A[(size_t)d * N + n0 + k] : 0.f;

    // One chunk into shared memory; steps past S, columns past D and
    // states past N read zeros (dt = 0: a = 1 and b = 0, h stays).
    auto stage = [&](int t0) {
        for (int e = tid; e < BC * DPB; e += BT) {
            const int t = t0 + e / DPB, col = e % DPB;
            const bool ok = t < S && d0 + col < D;
            const size_t off = (row0 + t) * D + d0 + col;
            sdt[e] = ok ? a.dt[off] : 0.f;
            sx[e] = ok ? to_f(x[off]) : 0.f;
            sdy[e] = ok ? a.dy[off] : 0.f;
        }
        for (int e = tid; e < BC * NP; e += BT) {
            const int t = t0 + e / NP, n = e % NP;
            const bool ok = t < S && n < N;
            sb[e] = ok ? to_f(Bm[(row0 + t) * a.ldb + n]) : 0.f;
            sc[e] = ok ? to_f(Cm[(row0 + t) * a.ldc + n]) : 0.f;
        }
        __syncthreads();
    };
    auto ckpt_at = [&](int c, int k) {
        return ckpt + (((size_t)bi * a.chunks + c) * D + d) * N + n0 + k;
    };

    // ---- forward sweep: the state before each chunk, saved
    float h[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k)
        h[k] = (a.h0 && live && n0 + k < N)
                   ? a.h0[((size_t)bi * D + d) * N + n0 + k] : 0.f;
    for (int c = 0; c < a.chunks; ++c) {
        stage(c * BC);
#pragma unroll
        for (int k = 0; k < NPT; ++k)
            if (live && n0 + k < N) *ckpt_at(c, k) = h[k];
#pragma unroll 4
        for (int uu = 0; uu < BC; ++uu) {
            const float dtv = sdt[uu * DPB + dl], xv = sx[uu * DPB + dl];
#pragma unroll
            for (int k = 0; k < NPT; ++k) {
                const float av = expf(__fmul_rn(dtv, Ar[k]));
                const float bv = __fmul_rn(__fmul_rn(dtv, sb[uu * NP + n0 + k]),
                                           xv);
                h[k] = __fadd_rn(__fmul_rn(av, h[k]), bv);
            }
        }
        __syncthreads();                     // before the next stage
    }

    // ---- reverse sweep
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
    for (int c = a.chunks - 1; c >= 0; --c) {
        const int t0 = c * BC;
        stage(t0);
#pragma unroll
        for (int k = 0; k < NPT; ++k)
            h[k] = (live && n0 + k < N) ? *ckpt_at(c, k) : 0.f;
        float hs[BC][NPT];                   // h_{t-1} of the chunk's steps
#pragma unroll
        for (int uu = 0; uu < BC; ++uu) {
            const float dtv = sdt[uu * DPB + dl], xv = sx[uu * DPB + dl];
#pragma unroll
            for (int k = 0; k < NPT; ++k) {
                hs[uu][k] = h[k];
                const float av = expf(__fmul_rn(dtv, Ar[k]));
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
            float pdt = 0.f, pgb = 0.f, vb[NPT], vc[NPT];
#pragma unroll
            for (int k = 0; k < NPT; ++k) {
                const float bn = sb[uu * NP + n0 + k], cn = sc[uu * NP + n0 + k];
                const float av = expf(__fmul_rn(dtv, Ar[k]));
                const float gk = carry[k] + dyv * cn;
                vc[k] = dyv * h[k];
                const float da = gk * hs[uu][k] * av;
                dA_acc[k] += da * dtv;
                pdt += da * Ar[k] + gk * bn * xv;
                pgb += gk * bn;
                vb[k] = gk * dtv * xv;
                carry[k] = av * gk;
                h[k] = hs[uu][k];
            }
#pragma unroll
            for (int o = 1; o < G; o <<= 1) {         // the d's lanes
                pdt += __shfl_xor_sync(0xffffffffu, pdt, o);
                pgb += __shfl_xor_sync(0xffffffffu, pgb, o);
            }
            if (g == 0 && live && t < S) {
                const size_t off = (row0 + t) * D + d;
                a.ddt[off] = pdt;
                put(dx + off, pgb * dtv + Dd * dyv);
                dD_acc += dyv * xv;
            }
            const int slot = uu % U;
#pragma unroll
            for (int k = 0; k < NPT; ++k) {
                float* at = sred + ((size_t)slot * DPB + dl) * 2 * NP + n0 + k;
                at[0] = vb[k];
                at[NP] = vc[k];
            }
            if (slot == 0) {                  // steps uu .. uu + U - 1
                __syncthreads();
                const int o = tid / TPO, part = tid % TPO;
                const int s = o / (2 * NP), wn = o % (2 * NP);
                float acc = 0.f;
                for (int dd = part; dd < DPB; dd += TPO)
                    acc += sred[((size_t)s * DPB + dd) * 2 * NP + wn];
#pragma unroll
                for (int q = 1; q < TPO; q <<= 1)
                    acc += __shfl_xor_sync(0xffffffffu, acc, q);
                const int ts = t + s, w = wn / NP, n = wn % NP;
                if (part == 0 && ts < S && n < N)
                    pbc[(((size_t)blk * a.B + bi) * S + ts) * 2 * N + w * N +
                        n] = acc;
                __syncthreads();
            }
        }
        __syncthreads();                     // before the next stage
    }
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
        if (!live || n0 + k >= N) continue;
        const size_t at = ((size_t)bi * D + d) * N + n0 + k;
        if (a.dh0) a.dh0[at] = carry[k];
        pA[at] = dA_acc[k];
    }
    if (live && g == 0) pD[(size_t)bi * D + d] = dD_acc;
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
    const long long want = (long long)a.B * a.chunks * a.D * a.N +
                           (long long)a.blocks_per_b * a.B * a.S * 2 * a.N +
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
    float* pbc = a.scratch + (size_t)a.B * a.chunks * a.D * a.N;
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
// (B, S, D) float32 contiguous and dh_fin (B, D, N) float32 or null; out:
// ddt (B, S, D) float32, dA (D, N) float32, dB, dC (B, S, N) and dx (B, S,
// D) in x's dtype, dD (D,) float32 (null when Dv is), dh0 (B, D, N)
// float32 or null; scratch of `scratch_floats` floats, which must be
// ../kernel.py's `plan_fused_bwd` size. Launches scan_bwd, then
// scan_bwd_finish. Returns the cudaError_t (0 on success).
int selective_scan_fused_bwd_launch(
        const float* dt, const float* A, const void* Bm, const void* Cm,
        const void* x, const float* Dv, const float* h0, const float* dy,
        const float* dh_fin, float* ddt, float* dA, void* dB, void* dC,
        void* dx, float* dD, float* dh0, float* scratch, int B, int S, int D,
        int N, long long ldb, long long ldc, int bf16,
        long long scratch_floats, void* stream) {
    if (B < 1 || S < 1 || D < 1 || N < 1 || N > 32 || ldb < 0 || ldc < 0 ||
        (dD != nullptr) != (Dv != nullptr))
        return (int)cudaErrorInvalidValue;
    int np = 1;
    while (np < N) np <<= 1;
    const ScanBwdArgs a{dt, A, Bm, Cm, x, Dv, h0, dy, dh_fin, ddt, dA, dB, dC,
                        dx, dD, dh0, scratch, B, S, D, N, ldb, ldc, 0, 0};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(bf16 ? launch_bwd_t<__nv_bfloat16>(a, np, scratch_floats, st)
                      : launch_bwd_t<float>(a, np, scratch_floats, st));
}

}  // extern "C"
