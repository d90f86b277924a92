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
// never recovered by dividing by w (exp(-exp(.)) underflows to 0), and
// not every state is stored (5.4 GB a layer at (2, 4096, 40, 64)). A
// forward sweep saves the state before each chunk of BC = 16 steps in the
// scratch buffer; the reverse sweep reloads a chunk's state, recomputes
// the chunk's 16 states forward into registers, then walks the chunk
// backwards with G in registers.
//
// Design: a block owns JT value columns (32; 16 at dh = 128) of one (b,
// h) and all dh keys, a thread one key i and E = 4 consecutive columns,
// the L = JT / 4 threads of a key consecutive lanes of a warp. Each chunk
// of r, k, w (all keys) and v, dout (the block's columns) goes to shared
// memory, with each step's r . (u k) and the block's v . dout. A step's
// sums over j (dr, dk, dw) are shuffles over the key's L lanes; dv's sum
// over i is a shuffle over the warp's keys and then, once a chunk, a sum
// over the warps in shared memory in warp order. dr, dk and dw of a step
// cover only the block's columns: each block writes its tile's partial
// sums, and `wkv_bwd_finish` adds the dh / JT tiles in tile order (and du
// over b and tiles), then casts dr and dk to r's dtype. No float atomics:
// every sum has one order, so two calls agree bit for bit.
//
// Bound on an H100 SXM (700 W) at (2, 4096, 40, 64) bf16: r, k, v, w,
// dout read and dr, dk, dv, dw written once (0.15 ms at 3.35 TB/s);
// 14 float32 flops per (b, t, h) and state entry (the state once, G's
// update, one FMA each of dr, dk, dv and dw's sums) against 67 TFLOP/s:
// 0.28 ms, so operations bound it. This kernel computes the state twice
// (the saving sweep and the chunk's recomputation), and its tile
// partials and saved states (0.8 GB at that shape) are its own traffic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BC = 16;                       // steps a chunk

template <int DH>
struct BwdCfg {
    static constexpr int JT = DH >= 128 ? 16 : 32;   // columns a block
    static constexpr int E = 4;                      // columns a thread
    static constexpr int L = JT / E;                 // threads a key
    static constexpr int THREADS = DH * L;
    static constexpr int WARPS = THREADS / 32;
    static constexpr int KPW = 32 / L;               // keys a warp
    static constexpr int TILES = DH / JT;
    // floats of shared memory: r, k, w [BC][DH]; v, dout [BC][JT]; r.uk
    // and v.dout [BC]; dv's warp sums [BC][WARPS][JT]
    static constexpr int SMEM = BC * (3 * DH + 2 * JT + 2) + BC * WARPS * JT;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

struct BwdArgs {
    const void *r, *k, *v;
    const float *w, *u, *s0, *dout, *ds_fin;
    void *dr, *dk, *dv;
    float *dw, *du, *ds0, *scratch;
    int B, S, H, chunks;
};

template <typename T, int DH>
__global__ void __launch_bounds__(BwdCfg<DH>::THREADS, 1)
wkv_bwd(const BwdArgs a) {
    using C = BwdCfg<DH>;
    constexpr int JT = C::JT, E = C::E, L = C::L, TH = C::THREADS,
                  WARPS = C::WARPS, TILES = C::TILES;
    extern __shared__ __align__(16) float sm[];
    float* sr = sm;                          // [BC][DH]
    float* sk = sr + BC * DH;
    float* sw = sk + BC * DH;
    float* sv = sw + BC * DH;                // [BC][JT]
    float* sd = sv + BC * JT;
    float* srku = sd + BC * JT;              // [BC]
    float* svd = srku + BC;                  // [BC]
    float* sdv = svd + BC;                   // [BC][WARPS][JT]

    const T* r = static_cast<const T*>(a.r);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const int S = a.S, H = a.H, chunks = a.chunks;
    const int tile = blockIdx.x % TILES;
    const long long bh = blockIdx.x / TILES;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int i = warp * C::KPW + lane / L;  // this thread's key
    const int jl = (lane % L) * E;           // its first column in the tile
    const int j0 = tile * JT + jl;           // ... and in the head
    const bool key_lead = lane % L == 0;
    const size_t row = (size_t)H * DH;       // stride of t
    const size_t base = ((size_t)b * S * H + h) * DH;   // (b, 0, h, 0)
    const size_t nel = (size_t)a.B * S * H * DH;
    float* ckpt = a.scratch + (size_t)bh * chunks * DH * DH;
    float* pdr = a.scratch + (size_t)a.B * H * chunks * DH * DH;
    float* pdk = pdr + TILES * nel;
    float* pdw = pdk + TILES * nel;
    float* pdu = pdw + TILES * nel;          // [B·H][TILES][DH]

    // One chunk of inputs into shared memory (steps past S: w = 1 and r =
    // k = v = dout = 0, which leave S and G as they are), then each step's
    // r . (u k) over all keys and v . dout over the tile, in lane order.
    auto stage = [&](int t0) {
        for (int e = tid; e < BC * DH; e += TH) {
            const int t = t0 + e / DH;
            const size_t off = base + (size_t)t * row + e % DH;
            const bool ok = t < S;
            sr[e] = ok ? to_f(r[off]) : 0.f;
            sk[e] = ok ? to_f(k[off]) : 0.f;
            sw[e] = ok ? a.w[off] : 1.f;
        }
        for (int e = tid; e < BC * JT; e += TH) {
            const int t = t0 + e / JT;
            const size_t off = base + (size_t)t * row + tile * JT + e % JT;
            const bool ok = t < S;
            sv[e] = ok ? to_f(v[off]) : 0.f;
            sd[e] = ok ? a.dout[off] : 0.f;
        }
        __syncthreads();
        for (int uu = warp; uu < BC; uu += WARPS) {
            float p = 0.f, q = 0.f;
            for (int ii = lane; ii < DH; ii += 32)
                p += sr[uu * DH + ii] * a.u[h * DH + ii] * sk[uu * DH + ii];
            for (int jj = lane; jj < JT; jj += 32)
                q += sv[uu * JT + jj] * sd[uu * JT + jj];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                p += __shfl_xor_sync(0xffffffffu, p, o);
                q += __shfl_xor_sync(0xffffffffu, q, o);
            }
            if (lane == 0) {
                srku[uu] = p;
                svd[uu] = q;
            }
        }
        __syncthreads();
    };

    // ---- forward sweep: the state before each chunk, saved
    float st[E];
    if (a.s0) {
        const float4 s4 = *reinterpret_cast<const float4*>(
            a.s0 + ((size_t)bh * DH + i) * DH + j0);
        st[0] = s4.x; st[1] = s4.y; st[2] = s4.z; st[3] = s4.w;
    } else {
#pragma unroll
        for (int e = 0; e < E; ++e) st[e] = 0.f;
    }
    for (int c = 0; c < chunks; ++c) {
        stage(c * BC);
        *reinterpret_cast<float4*>(ckpt + ((size_t)c * DH + i) * DH + j0) =
            make_float4(st[0], st[1], st[2], st[3]);
#pragma unroll
        for (int uu = 0; uu < BC; ++uu) {
            const float wi = sw[uu * DH + i], ki = sk[uu * DH + i];
#pragma unroll
            for (int e = 0; e < E; ++e)
                st[e] = wi * st[e] + ki * sv[uu * JT + jl + e];
        }
        __syncthreads();                     // before the next stage
    }

    // ---- reverse sweep
    float G[E];
    if (a.ds_fin) {
        const float4 g4 = *reinterpret_cast<const float4*>(
            a.ds_fin + ((size_t)bh * DH + i) * DH + j0);
        G[0] = g4.x; G[1] = g4.y; G[2] = g4.z; G[3] = g4.w;
    } else {
#pragma unroll
        for (int e = 0; e < E; ++e) G[e] = 0.f;
    }
    const float ui = a.u[h * DH + i];
    float du_acc = 0.f;
    T* dv = static_cast<T*>(a.dv);
    for (int c = chunks - 1; c >= 0; --c) {
        const int t0 = c * BC;
        stage(t0);
        const float4 s4 = *reinterpret_cast<const float4*>(
            ckpt + ((size_t)c * DH + i) * DH + j0);
        st[0] = s4.x; st[1] = s4.y; st[2] = s4.z; st[3] = s4.w;
        float hs[BC][E];                     // S_{t-1} of the chunk's steps
#pragma unroll
        for (int uu = 0; uu < BC; ++uu) {
            const float wi = sw[uu * DH + i], ki = sk[uu * DH + i];
#pragma unroll
            for (int e = 0; e < E; ++e) {
                hs[uu][e] = st[e];
                st[e] = wi * st[e] + ki * sv[uu * JT + jl + e];
            }
        }
#pragma unroll
        for (int uu = BC - 1; uu >= 0; --uu) {
            const int t = t0 + uu;
            const float ri = sr[uu * DH + i], ki = sk[uu * DH + i],
                        wi = sw[uu * DH + i];
            float vj[E], dj[E], dvp[E];
            float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                vj[e] = sv[uu * JT + jl + e];
                dj[e] = sd[uu * JT + jl + e];
                pr += dj[e] * hs[uu][e];
                pk += G[e] * vj[e];
                pw += G[e] * hs[uu][e];
                dvp[e] = G[e] * ki;
            }
#pragma unroll
            for (int o = 1; o < L; o <<= 1) {         // the key's columns
                pr += __shfl_xor_sync(0xffffffffu, pr, o);
                pk += __shfl_xor_sync(0xffffffffu, pk, o);
                pw += __shfl_xor_sync(0xffffffffu, pw, o);
            }
#pragma unroll
            for (int o = L; o < 32; o <<= 1)          // the warp's keys
#pragma unroll
                for (int e = 0; e < E; ++e)
                    dvp[e] += __shfl_xor_sync(0xffffffffu, dvp[e], o);
            if (lane < L) {
#pragma unroll
                for (int e = 0; e < E; ++e)
                    sdv[(uu * WARPS + warp) * JT + jl + e] = dvp[e];
            }
            if (key_lead && t < S) {
                const float vd = svd[uu];
                const size_t off = (size_t)tile * nel + base +
                                   (size_t)t * row + i;
                pdr[off] = pr + ui * ki * vd;
                pdk[off] = pk + ri * ui * vd;
                pdw[off] = pw;
                du_acc += ri * ki * vd;
            }
#pragma unroll
            for (int e = 0; e < E; ++e) G[e] = wi * G[e] + ri * dj[e];
        }
        __syncthreads();
        for (int e = tid; e < BC * JT; e += TH) {     // dv: warps in order
            const int uu = e / JT, jj = e % JT, t = t0 + uu;
            if (t < S) {
                float s = sd[e] * srku[uu];
                for (int ww = 0; ww < WARPS; ++ww)
                    s += sdv[(uu * WARPS + ww) * JT + jj];
                put(dv + base + (size_t)t * row + tile * JT + jj, s);
            }
        }
        __syncthreads();                     // before the next stage
    }
    if (a.ds0)
        *reinterpret_cast<float4*>(a.ds0 + ((size_t)bh * DH + i) * DH + j0) =
            make_float4(G[0], G[1], G[2], G[3]);
    if (key_lead) pdu[((size_t)bh * TILES + tile) * DH + i] = du_acc;
}

// dr, dk (cast to T) and dw: the tiles' partial sums added in tile order;
// du: the (b, tile) partials added in b-major order.
template <typename T, int TILES>
__global__ void wkv_bwd_finish(const float* __restrict__ part, T* dr, T* dk,
                               float* dw, const float* __restrict__ pdu,
                               float* du, size_t nel, int B, int H, int DH) {
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         idx < nel; idx += stride) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int tl = 0; tl < TILES; ++tl) {
            s0 += part[tl * nel + idx];
            s1 += part[(TILES + tl) * nel + idx];
            s2 += part[(2 * TILES + tl) * nel + idx];
        }
        put(dr + idx, s0);
        put(dk + idx, s1);
        dw[idx] = s2;
        if (idx < (size_t)H * DH) {
            const int h = (int)(idx / DH), i = (int)(idx % DH);
            float s = 0.f;
            for (int b = 0; b < B; ++b)
                for (int tl = 0; tl < TILES; ++tl)
                    s += pdu[(((size_t)b * H + h) * TILES + tl) * DH + i];
            du[idx] = s;
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

template <typename T, int DH>
cudaError_t launch_bwd(const BwdArgs& a, long long blocks, int threads,
                       long long smem, cudaStream_t st) {
    using C = BwdCfg<DH>;
    if (blocks != (long long)a.B * a.H * C::TILES || threads != C::THREADS ||
        smem != (long long)sizeof(float) * C::SMEM)
        return cudaErrorInvalidValue;
    static unsigned ready = 0;
    cudaError_t err = allow_smem(wkv_bwd<T, DH>, (size_t)smem, ready);
    if (err != cudaSuccess) return err;
    wkv_bwd<T, DH><<<dim3((unsigned)blocks), dim3(threads), (size_t)smem,
                     st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t nel = (size_t)a.B * a.S * a.H * DH;
    const size_t want = (nel + 255) / 256;
    const unsigned grid = (unsigned)(want < 132 * 16 ? want : 132 * 16);
    float* part = a.scratch + (size_t)a.B * a.H * a.chunks * DH * DH;
    wkv_bwd_finish<T, C::TILES><<<grid, 256, 0, st>>>(
        part, static_cast<T*>(a.dr), static_cast<T*>(a.dk), a.dw,
        part + 3 * C::TILES * nel, a.du, nel, a.B, a.H, DH);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd_dh(const BwdArgs& a, bool bf16, long long blocks,
                          int threads, long long smem, cudaStream_t st) {
    return bf16 ? launch_bwd<__nv_bfloat16, DH>(a, blocks, threads, smem, st)
                : launch_bwd<float, DH>(a, blocks, threads, smem, st);
}

}  // namespace

extern "C" {

// r, k, v, dr, dk, dv (B, S, H, dh) all bf16 (bf16 = 1) or all float32;
// w, dout, dw (B, S, H, dh), u, du (H, dh), s0, ds_fin, ds0 (B, H, dh,
// dh; each may be null) float32; scratch of ../kernel.py's `plan_bwd`
// floats; all contiguous and 16-byte aligned; dh 32, 64 or 128. Launches
// wkv_bwd with the blocks, threads and shared-memory bytes of `plan_bwd`
// (refusing any other), then wkv_bwd_finish. Returns the cudaError_t (0
// on success; cudaErrorInvalidValue for a plan not built).
int wkv_bwd_launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   const float* dout, const float* ds_fin, void* dr, void* dk,
                   void* dv, float* dw, float* du, float* ds0, float* scratch,
                   int B, int S, int H, int dh, int bf16, long long blocks,
                   int threads, long long smem, void* stream) {
    if (B < 1 || S < 1 || H < 1 || blocks < 1 || blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const BwdArgs a{r, k, v, w, u, s0, dout, ds_fin, dr, dk, dv, dw, du, ds0,
                    scratch, B, S, H, (S + BC - 1) / BC};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 32: return (int)launch_bwd_dh<32>(a, bf16 != 0, blocks, threads,
                                               smem, st);
        case 64: return (int)launch_bwd_dh<64>(a, bf16 != 0, blocks, threads,
                                               smem, st);
        case 128: return (int)launch_bwd_dh<128>(a, bf16 != 0, blocks,
                                                 threads, smem, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
