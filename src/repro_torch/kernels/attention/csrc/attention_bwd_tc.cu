// Flash attention backward on Hopper's tensor cores (sm_90a): the bf16
// route at dh 64 and 128. Plain C interface, loaded with ctypes by
// ../../_build.py beside attention.cu and attention_bwd.cu (the float32
// and dh 32 route, whose pre-pass this route calls); the wrapper and its
// route choice (`plan_bwd`) live in ../kernel.py, the plain PyTorch version
// in ../ref.py (`attention_bwd_ref`).
//
// Replaces no Pallas kernel: the JAX package differentiates
// `blockwise_attention` (src/repro/models/blocks.py:76) with XLA. It
// computes the function attention_bwd.cu states (dV = P^T·dO, dP = dO·V^T,
// dS = P ∘ (dP - Δ) with Δ = rowsum(dO ∘ O), dQ = dS·K / sqrt(dh), dK =
// dS^T·Q / sqrt(dh); the forward's masks; dK and dV summed over the g
// query heads of each KV head; zeros for a row with no allowed key), with
// P = exp(s / sqrt(dh) - lse) from each row's log-sum-exp, which the
// forward prefill kernel writes (attention.cu) or the pre-pass recomputes.
//
// Bound: operations. The least work is 5 products of 2·dh flops for each
// (query, key, head) that may attend (the scores again, dP, dV, dK, dQ): at
// (2, 4096, 64/8, 128) causal 1.37e12 flops, 1.39 ms at 989 TFLOP/s bf16,
// against about 0.1 ms of bytes. This route does 7: the dK/dV kernel 4
// (S^T, dP^T, dV, dK) and the dQ kernel 3 (S and dP again, dQ).
//
// No atomics: dK/dV and dQ are separate kernels, so each output tile is
// summed by one block in a fixed order and two runs give the same bits
// (a resumed training run repeats its losses bit for bit). The two
// recomputed products are the price; float atomics on dQ (FA2's way) would
// save them and make every run's rounding differ.
//
// What the design does about the bound: every product is a wgmma on the
// bf16 tensor cores with float32 accumulators; P and dS are rounded to
// bf16 once, as operands. Both kernels are persistent (one block of 384
// threads per SM, the heaviest items first): warpgroup 0 gives up
// registers (setmaxnreg) and one warp of it loads, with TMA (4D tensor
// maps over {dh, heads, positions, B}, boxes of 64 columns, 128-byte
// swizzle, zero fill past the end), an item's 128 rows into shared memory
// and streams 64-row tiles of the other operand pair through a ring of
// full/empty mbarriers, skipping tiles that no pair of the item may attend
// to (a test on the position ranges, so positions need not be sorted);
// two computing warpgroups own 64 rows of the item each. Masks are applied
// only on tiles where some pair may be masked.
//   bwd_dkdv_tc: an item is (b, KV head, 128 keys); K and V stay in shared
//     memory. Tiles are 64 query positions of one head of the group, with
//     their positions, log-sum-exp and Δ staged beside them; the loop
//     covers every visible tile of each of the g heads. Per tile: S^T = K
//     Q^T and dP^T = V dO^T (both operands from shared memory), P^T =
//     exp2(S^T·scale·log2 e - lse·log2 e), dS^T = P^T ∘ (dP^T - Δ); then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers and dO
//     and Q through the instruction's transpose bit. The two groups take
//     turns to start their products (named barriers), so one group's
//     exponentials run while the other's products do.
//   bwd_dq_tc: an item is (b, head, 128 query positions); Q and dO stay in
//     shared memory, 64-key tiles of K and V stream. Per tile: S = Q K^T,
//     dP = dO V^T, P and dS as above from the rows' lse and Δ, dQ += dS K
//     (K through the transpose bit), left running across the next tile's
//     S and dP; its tile's stage is freed once the next tile's S is done.
// Against dQ waited for at each tile and groups that issue freely, the
// last two choices gained 2-8% each on their kernel; a ring of 4 stages
// gained nothing over 3. PERF.md has what was measured.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// attention_bwd.cu: Δ, and the log-sum-exp unless lse_ready
extern "C" int flash_bwd_pre_launch(const void* q, const void* k,
                                    const void* o, const void* dout,
                                    void* lse, void* delta, const int* qpos,
                                    const int* kpos, int qpos_bs,
                                    int kpos_bs, int B, int S, int T, int H,
                                    int KV, int dh, int causal, int window,
                                    int bf16, int lse_ready, void* stream);

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;         // warpgroup 0 loads, 1 and 2 compute
constexpr int LOAD_REGS = 40, MATH_REGS = 232;   // 128·40 + 256·232
constexpr int ITEM_ROWS = 128;       // an item's rows: 64 a computing group
constexpr int TILE_ROWS = 64;        // rows of a streamed tile

constexpr int STAGES = 3;            // ring of streamed tiles

struct TcArgs {
    void* dq;                        // (B, S, H, dh)
    void* dk;                        // (B, T, KV, dh)
    void* dv;
    const float* lse;                // (B, S, H)
    const float* delta;
    const int* qpos;                 // (S,)/(B, S) or null: arange(S) + T - S
    const int* kpos;                 // (T,)/(B, T) or null: arange(T)
    int qpos_bs, kpos_bs;
    int B, S, T, H, KV, causal, window;
    float scale;                     // 1 / sqrt(dh)
};

// INT_MIN past the end: a row that is not there
__device__ __forceinline__ int q_position(const TcArgs& a, int b, int s) {
    if (s >= a.S) return INT_MIN;
    return a.qpos ? a.qpos[(size_t)b * a.qpos_bs + s] : s + a.T - a.S;
}

// -1 (masked) past the end
__device__ __forceinline__ int k_position(const TcArgs& a, int b, int t) {
    if (t >= a.T) return -1;
    return a.kpos ? a.kpos[(size_t)b * a.kpos_bs + t] : t;
}

__device__ __forceinline__ bool allowed(const TcArgs& a, int qp, int kp) {
    return qp != INT_MIN && kp >= 0 && (!a.causal || qp >= kp) &&
           (a.window <= 0 || (long long)qp - kp < a.window);
}

// May some query position in [qmin, qmax] attend to some key position in
// [kmin, kmax] (empty ranges: lo > hi)?
__device__ __forceinline__ bool ranges_meet(const TcArgs& a, int qmin,
                                            int qmax, int kmin, int kmax) {
    if (kmin > kmax || qmin > qmax) return false;
    if (a.causal && kmin > qmax) return false;
    if (a.window > 0 && (long long)qmin - kmax >= a.window) return false;
    return true;
}

// May every query position in [qmin, qmax] attend to every key position
// in [kmin, kmax]?
__device__ __forceinline__ bool ranges_whole(const TcArgs& a, int qmin,
                                             int qmax, int kmin, int kmax) {
    return (!a.causal || kmax <= qmin) &&
           (a.window <= 0 || (long long)qmax - kmin < a.window);
}

__device__ __forceinline__ void warp_range(int& lo, int& hi) {
#pragma unroll
    for (int d = 16; d; d >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    }
}

// ROWS rows of DH bf16 in shared memory: DH / 64 boxes of ROWS rows of 64
// elements (one 128-byte swizzle span a row), as TMA writes them.
template <int DH, int ROWS>
struct Tile {
    static constexpr int BOXES = DH / 64;
    static constexpr int BOX_BYTES = ROWS * 128;
    static constexpr int BYTES = BOXES * BOX_BYTES;
};

// Descriptor of a K-major operand (the contracted dh contiguous) starting
// at row `row` of a tile with boxes `box_bytes` apart: k-step kk reads 16
// of dh at byte 32·kk of the swizzled rows, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int box_bytes,
                                           int row, int kk) {
    return smem_desc(tile + (kk >> 2) * box_bytes + row * 128 + (kk & 3) * 32,
                     16, 1024, 1);
}

// Descriptor of an N-major B operand (dh across, the contracted rows
// down): k-step kc starts 16 rows on; boxes of 64 columns lie box_bytes
// apart.
__device__ __forceinline__ uint64_t nmajor(uint32_t tile, int box_bytes,
                                           int kc) {
    return smem_desc(tile + kc * 16 * 128, box_bytes, 1024, 1);
}

// The accumulator (64 x 64 fp32: n-tile j, element e) as bf16 A fragments
// of four k-steps of 16
__device__ __forceinline__ void pack_a(const float (&c)[32],
                                       uint32_t (&f)[4][4]) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        const int j = 8 * kc;
        f[kc][0] = pack_bf16x2(c[j], c[j + 1]);
        f[kc][1] = pack_bf16x2(c[j + 2], c[j + 3]);
        f[kc][2] = pack_bf16x2(c[j + 4], c[j + 5]);
        f[kc][3] = pack_bf16x2(c[j + 6], c[j + 7]);
    }
}

// Stores this thread's part of a 64 x DH accumulator, times `mul`, as
// bf16: rows rA and rA + 8 at element offsets offA / offB (ok: in range).
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t offA,
                                           size_t offB, bool okA, bool okB,
                                           int tig, const float (&acc)[DH / 2],
                                           float mul) {
    if (okA) {
        __nv_bfloat16* p = base + offA + tig * 2;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(p + j * 8) =
                __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    }
    if (okB) {
        __nv_bfloat16* p = base + offB + tig * 2;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(p + j * 8) =
                __floats2bfloat162_rn(acc[4 * j + 2] * mul,
                                      acc[4 * j + 3] * mul);
    }
}

struct Ring {
    uint64_t full[STAGES], empty[STAGES];
    uint64_t item_full, item_empty;  // the item's own rows
    int end[STAGES];                 // 1: the item's end, no tile
    int whole[STAGES];               // every pair of the tile may attend
};

__device__ void init_ring(Ring& r) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&r.full[s], 32);       // the loading warp
            mbar_init(&r.empty[s], 8);       // the computing warps
        }
        mbar_init(&r.item_full, 1);
        mbar_init(&r.item_empty, 8);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
}

// ------------------------------------------------------------ dK / dV
struct KvStage {
    int qp[STAGES][TILE_ROWS];       // query positions (INT_MIN past S)
    float lse2[STAGES][TILE_ROWS];   // log-sum-exp · log2 e (+inf past S)
    float dl[STAGES][TILE_ROWS];     // Δ (0 past S)
};

template <int DH>
constexpr size_t dkdv_smem_bytes() {
    return 1024 + 2ull * Tile<DH, ITEM_ROWS>::BYTES
           + 2ull * STAGES * Tile<DH, TILE_ROWS>::BYTES + sizeof(Ring)
           + sizeof(KvStage);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap domap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const TcArgs a) {
    using It = Tile<DH, ITEM_ROWS>;
    using Tt = Tile<DH, TILE_ROWS>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* Ks = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* Vs = Ks + It::BYTES;
    unsigned char* Qring = Vs + It::BYTES;
    unsigned char* Oring = Qring + STAGES * Tt::BYTES;
    Ring& ring = *reinterpret_cast<Ring*>(Oring + STAGES * Tt::BYTES);
    KvStage& st = *reinterpret_cast<KvStage*>(&ring + 1);

    const int g = a.H / a.KV;
    const int key_tiles = (a.T + ITEM_ROWS - 1) / ITEM_ROWS;
    const int items = key_tiles * a.KV * a.B;
    // item w is (key tile, b, kvh), the first key tiles first (causal:
    // the most queries see them); block i takes i, i + gridDim.x, ...
    auto item = [&](int w, int& t0, int& b, int& kvh) {
        t0 = w / (a.KV * a.B) * ITEM_ROWS;
        b = w / a.KV % a.B;
        kvh = w % a.KV;
    };
    init_ring(ring);
    const int tid = threadIdx.x;

    if (tid < 128) {
        // ---- loader: one warp
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(LOAD_REGS));
        if (tid >= 32) return;
        const int lane = tid;
        int n = 0, it = 0;                    // stages filled, items loaded
        for (int w = blockIdx.x; w < items; w += gridDim.x, ++it) {
            int t0, b, kvh;
            item(w, t0, b, kvh);
            // the item's valid key positions: range, and whether any slot
            // within T is empty
            int kmin = INT_MAX, kmax = INT_MIN;
            bool neg = false;
#pragma unroll
            for (int u = 0; u < ITEM_ROWS / 32; ++u) {
                const int t = t0 + lane + 32 * u;
                const int kp = k_position(a, b, t);
                if (kp >= 0) { kmin = min(kmin, kp); kmax = max(kmax, kp); }
                else if (t < a.T) neg = true;
            }
            warp_range(kmin, kmax);
            neg = __any_sync(0xffffffffu, neg);
            mbar_wait(&ring.item_empty, (it & 1) ^ 1);
            if (lane == 0) {
                mbar_arrive_expect_tx(&ring.item_full, 2 * It::BYTES);
#pragma unroll
                for (int c = 0; c < It::BOXES; ++c) {
                    tma_load_4d(Ks + c * It::BOX_BYTES, &kmap,
                                &ring.item_full, c * 64, kvh, t0, b);
                    tma_load_4d(Vs + c * It::BOX_BYTES, &vmap,
                                &ring.item_full, c * 64, kvh, t0, b);
                }
            }
            for (int s0 = 0; s0 < a.S; s0 += TILE_ROWS) {
                const int sa = s0 + lane, sb = sa + 32;
                const int qa = q_position(a, b, sa), qb = q_position(a, b, sb);
                int qmin = INT_MAX, qmax = INT_MIN;
                if (qa != INT_MIN) { qmin = qa; qmax = qa; }
                if (qb != INT_MIN) { qmin = min(qmin, qb); qmax = max(qmax, qb); }
                warp_range(qmin, qmax);
                if (!ranges_meet(a, qmin, qmax, kmin, kmax)) continue;
                const int whole = !neg && ranges_whole(a, qmin, qmax, kmin,
                                                       kmax);
                for (int j = 0; j < g; ++j) {
                    const int h = kvh * g + j;
                    const size_t ra = ((size_t)b * a.S + sa) * a.H + h;
                    const size_t rb = ((size_t)b * a.S + sb) * a.H + h;
                    const float la = sa < a.S ? a.lse[ra] * LOG2E : INFINITY;
                    const float lb = sb < a.S ? a.lse[rb] * LOG2E : INFINITY;
                    const float da = sa < a.S ? a.delta[ra] : 0.f;
                    const float db = sb < a.S ? a.delta[rb] : 0.f;
                    const int s = n % STAGES, ph = (n / STAGES) & 1;
                    mbar_wait(&ring.empty[s], ph ^ 1);
                    st.qp[s][lane] = qa;
                    st.qp[s][lane + 32] = qb;
                    st.lse2[s][lane] = la;
                    st.lse2[s][lane + 32] = lb;
                    st.dl[s][lane] = da;
                    st.dl[s][lane + 32] = db;
                    if (lane == 0) {
                        ring.end[s] = 0;
                        ring.whole[s] = whole;
                        mbar_arrive_expect_tx(&ring.full[s], 2 * Tt::BYTES);
#pragma unroll
                        for (int c = 0; c < Tt::BOXES; ++c) {
                            const int at = s * Tt::BYTES + c * Tt::BOX_BYTES;
                            tma_load_4d(Qring + at, &qmap, &ring.full[s],
                                        c * 64, h, s0, b);
                            tma_load_4d(Oring + at, &domap, &ring.full[s],
                                        c * 64, h, s0, b);
                        }
                    } else {
                        mbar_arrive(&ring.full[s]);
                    }
                    ++n;
                }
            }
            const int s = n % STAGES, ph = (n / STAGES) & 1;
            mbar_wait(&ring.empty[s], ph ^ 1);
            if (lane == 0) ring.end[s] = 1;  // the end of the item
            mbar_arrive(&ring.full[s]);
            ++n;
        }
        return;
    }

    // ---- two computing warpgroups, 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(MATH_REGS));
    const int ct = tid - 128, wg = ct >> 7, lane = ct & 31;
    const int grp = lane >> 2, tig = lane & 3;
    const int krow = wg * 64 + ((ct >> 5) & 3) * 16 + grp;   // row A of the item
    const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);
    const float sl2 = a.scale * LOG2E;
    float dk[DH / 2], dv[DH / 2];             // wgmma m64nDH accumulators
    float sacc[TILE_ROWS / 2], dpacc[TILE_ROWS / 2];   // m64n64: S^T, dP^T
    uint32_t pf[4][4], dsf[4][4];             // P^T, dS^T as A fragments
    int slot = 0, it = 0;
    // named barriers 1 and 2: a group waits on its own before issuing a
    // batch of products and then lets the other go; group 0 goes first
    auto my_turn = [&]() {
        asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
    };
    auto your_turn = [&]() {
        asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
    };
    if (wg == 1) your_turn();

    for (int w = blockIdx.x; w < items; w += gridDim.x, ++it) {
        int t0, b, kvh;
        item(w, t0, b, kvh);
        const int tA = t0 + krow, tB = tA + 8;
        const int kpA = k_position(a, b, tA), kpB = k_position(a, b, tB);
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) { dk[i] = 0.f; dv[i] = 0.f; }
        mbar_wait(&ring.item_full, it & 1);
        for (;;) {
            const int s = slot % STAGES;
            mbar_wait(&ring.full[s], (slot / STAGES) & 1);
            ++slot;
            if (ring.end[s]) {
                if (lane == 0) mbar_arrive(&ring.empty[s]);
                break;
            }
            const uint32_t qt = smem_u32(Qring + s * Tt::BYTES);
            const uint32_t ot = smem_u32(Oring + s * Tt::BYTES);
            my_turn();
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
                wgmma_ss<TILE_ROWS>(sacc, kmajor(ks, It::BOX_BYTES, wg * 64, kk),
                                    kmajor(qt, Tt::BOX_BYTES, 0, kk), kk > 0);
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
                wgmma_ss<TILE_ROWS>(dpacc, kmajor(vs, It::BOX_BYTES, wg * 64, kk),
                                    kmajor(ot, Tt::BOX_BYTES, 0, kk), kk > 0);
            wgmma_commit();
            your_turn();
            wgmma_wait<1>();                  // S^T done, dP^T running
            fence_regs(sacc);
            // P^T: row = key (A or B), column c = query 8j + 2·tig + (e & 1)
            const int* qp = st.qp[s];
            const float* lse2 = st.lse2[s];
            const float* dl = st.dl[s];
            if (ring.whole[s]) {
#pragma unroll
                for (int j = 0; j < TILE_ROWS / 8; ++j) {
                    const float2 l = *reinterpret_cast<const float2*>(
                        lse2 + 8 * j + 2 * tig);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        sacc[4 * j + e] = fast_exp2(fmaf(
                            sacc[4 * j + e], sl2, (e & 1) ? -l.y : -l.x));
                }
            } else {
#pragma unroll
                for (int j = 0; j < TILE_ROWS / 8; ++j) {
                    const float2 l = *reinterpret_cast<const float2*>(
                        lse2 + 8 * j + 2 * tig);
                    const int2 q2 = *reinterpret_cast<const int2*>(
                        qp + 8 * j + 2 * tig);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = fast_exp2(fmaf(
                            sacc[4 * j + e], sl2, (e & 1) ? -l.y : -l.x));
                        sacc[4 * j + e] =
                            allowed(a, (e & 1) ? q2.y : q2.x,
                                    (e >> 1) ? kpB : kpA) ? p : 0.f;
                    }
                }
            }
            wgmma_wait<0>();
            fence_regs(dpacc);
#pragma unroll
            for (int j = 0; j < TILE_ROWS / 8; ++j) {
                const float2 d = *reinterpret_cast<const float2*>(
                    dl + 8 * j + 2 * tig);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dpacc[4 * j + e] = sacc[4 * j + e] *
                        (dpacc[4 * j + e] - ((e & 1) ? d.y : d.x));
            }
            pack_a(sacc, pf);
            pack_a(dpacc, dsf);
            // dV += P^T dO, dK += dS^T Q: the tiles N-major through the
            // transpose bit
            my_turn();
            wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < TILE_ROWS / 16; ++kc)
                wgmma<DH, 1>(dv, pf[kc], nmajor(ot, Tt::BOX_BYTES, kc), 1);
#pragma unroll
            for (int kc = 0; kc < TILE_ROWS / 16; ++kc)
                wgmma<DH, 1>(dk, dsf[kc], nmajor(qt, Tt::BOX_BYTES, kc), 1);
            wgmma_commit();
            your_turn();
            wgmma_wait<0>();
            fence_regs(dv);
            fence_regs(dk);
            if (lane == 0) mbar_arrive(&ring.empty[s]);   // stage free
        }
        if (lane == 0) mbar_arrive(&ring.item_empty);    // K, V free
        const size_t offA = (((size_t)b * a.T + tA) * a.KV + kvh) * DH;
        const size_t offB = offA + (size_t)8 * a.KV * DH;
        store_rows<DH>(static_cast<__nv_bfloat16*>(a.dk), offA, offB,
                       tA < a.T, tB < a.T, tig, dk, a.scale);
        store_rows<DH>(static_cast<__nv_bfloat16*>(a.dv), offA, offB,
                       tA < a.T, tB < a.T, tig, dv, 1.f);
    }
}

// ----------------------------------------------------------------- dQ
struct QStage {
    int kp[STAGES][TILE_ROWS];       // key positions (-1 past T)
};

template <int DH>
constexpr size_t dq_smem_bytes() {
    return 1024 + 2ull * Tile<DH, ITEM_ROWS>::BYTES
           + 2ull * STAGES * Tile<DH, TILE_ROWS>::BYTES + sizeof(Ring)
           + sizeof(QStage);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_tc(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap domap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const TcArgs a) {
    using It = Tile<DH, ITEM_ROWS>;
    using Tt = Tile<DH, TILE_ROWS>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* Qs = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* Os = Qs + It::BYTES;
    unsigned char* Kring = Os + It::BYTES;
    unsigned char* Vring = Kring + STAGES * Tt::BYTES;
    Ring& ring = *reinterpret_cast<Ring*>(Vring + STAGES * Tt::BYTES);
    QStage& st = *reinterpret_cast<QStage*>(&ring + 1);

    const int g = a.H / a.KV;
    const int row_tiles = (a.S + ITEM_ROWS - 1) / ITEM_ROWS;
    const int items = row_tiles * a.H * a.B;
    // item w is (row tile, b, head), the last row tiles first (causal:
    // they see the most keys); neighbouring items share a KV head
    auto item = [&](int w, int& s0, int& b, int& h) {
        s0 = (row_tiles - 1 - w / (a.H * a.B)) * ITEM_ROWS;
        b = w / a.H % a.B;
        h = w % a.H;
    };
    init_ring(ring);
    const int tid = threadIdx.x;

    if (tid < 128) {
        // ---- loader: one warp
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(LOAD_REGS));
        if (tid >= 32) return;
        const int lane = tid;
        int n = 0, it = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x, ++it) {
            int s0, b, h;
            item(w, s0, b, h);
            const int kvh = h / g;
            int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
            for (int u = 0; u < ITEM_ROWS / 32; ++u) {
                const int qp = q_position(a, b, s0 + lane + 32 * u);
                if (qp != INT_MIN) { qmin = min(qmin, qp); qmax = max(qmax, qp); }
            }
            warp_range(qmin, qmax);
            mbar_wait(&ring.item_empty, (it & 1) ^ 1);
            if (lane == 0) {
                mbar_arrive_expect_tx(&ring.item_full, 2 * It::BYTES);
#pragma unroll
                for (int c = 0; c < It::BOXES; ++c) {
                    tma_load_4d(Qs + c * It::BOX_BYTES, &qmap,
                                &ring.item_full, c * 64, h, s0, b);
                    tma_load_4d(Os + c * It::BOX_BYTES, &domap,
                                &ring.item_full, c * 64, h, s0, b);
                }
            }
            for (int t0 = 0; t0 < a.T; t0 += TILE_ROWS) {
                const int ka = k_position(a, b, t0 + lane);
                const int kb = k_position(a, b, t0 + lane + 32);
                int kmin = INT_MAX, kmax = INT_MIN;
                if (ka >= 0) { kmin = ka; kmax = ka; }
                if (kb >= 0) { kmin = min(kmin, kb); kmax = max(kmax, kb); }
                // every slot of the tile valid (within T, not empty)
                const bool full_tile = __all_sync(0xffffffffu, ka >= 0 && kb >= 0);
                warp_range(kmin, kmax);
                if (!ranges_meet(a, qmin, qmax, kmin, kmax)) continue;
                const int whole = full_tile && ranges_whole(a, qmin, qmax,
                                                            kmin, kmax);
                const int s = n % STAGES, ph = (n / STAGES) & 1;
                mbar_wait(&ring.empty[s], ph ^ 1);
                st.kp[s][lane] = ka;
                st.kp[s][lane + 32] = kb;
                if (lane == 0) {
                    ring.end[s] = 0;
                    ring.whole[s] = whole;
                    mbar_arrive_expect_tx(&ring.full[s], 2 * Tt::BYTES);
#pragma unroll
                    for (int c = 0; c < Tt::BOXES; ++c) {
                        const int at = s * Tt::BYTES + c * Tt::BOX_BYTES;
                        tma_load_4d(Kring + at, &kmap, &ring.full[s],
                                    c * 64, kvh, t0, b);
                        tma_load_4d(Vring + at, &vmap, &ring.full[s],
                                    c * 64, kvh, t0, b);
                    }
                } else {
                    mbar_arrive(&ring.full[s]);
                }
                ++n;
            }
            const int s = n % STAGES, ph = (n / STAGES) & 1;
            mbar_wait(&ring.empty[s], ph ^ 1);
            if (lane == 0) ring.end[s] = 1;
            mbar_arrive(&ring.full[s]);
            ++n;
        }
        return;
    }

    // ---- two computing warpgroups, 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(MATH_REGS));
    const int ct = tid - 128, wg = ct >> 7, lane = ct & 31;
    const int grp = lane >> 2, tig = lane & 3;
    const int qrow = wg * 64 + ((ct >> 5) & 3) * 16 + grp;   // row A of the item
    const float sl2 = a.scale * LOG2E;
    float dq[DH / 2];                         // wgmma m64nDH accumulator
    float sacc[TILE_ROWS / 2], dpacc[TILE_ROWS / 2];   // m64n64: S, dP
    uint32_t dsf[4][4];                       // dS as A fragments
    const uint32_t qs = smem_u32(Qs), os = smem_u32(Os);
    int slot = 0, it = 0;

    for (int w = blockIdx.x; w < items; w += gridDim.x, ++it) {
        int s0, b, h;
        item(w, s0, b, h);
        const int sA = s0 + qrow, sB = sA + 8;
        const int qpA = q_position(a, b, sA), qpB = q_position(a, b, sB);
        const size_t rA = ((size_t)b * a.S + sA) * a.H + h;
        const size_t rB = rA + (size_t)8 * a.H;
        const float lA = sA < a.S ? a.lse[rA] * LOG2E : INFINITY;
        const float lB = sB < a.S ? a.lse[rB] * LOG2E : INFINITY;
        const float dA = sA < a.S ? a.delta[rA] : 0.f;
        const float dB = sB < a.S ? a.delta[rB] : 0.f;
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
        mbar_wait(&ring.item_full, it & 1);
        int prev = -1;                        // the stage dQ still reads
        int s;
        for (;;) {
            s = slot % STAGES;
            mbar_wait(&ring.full[s], (slot / STAGES) & 1);
            ++slot;
            if (ring.end[s]) break;
            const uint32_t kt = smem_u32(Kring + s * Tt::BYTES);
            const uint32_t vt = smem_u32(Vring + s * Tt::BYTES);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
                wgmma_ss<TILE_ROWS>(sacc, kmajor(qs, It::BOX_BYTES, wg * 64, kk),
                                    kmajor(kt, Tt::BOX_BYTES, 0, kk), kk > 0);
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
                wgmma_ss<TILE_ROWS>(dpacc, kmajor(os, It::BOX_BYTES, wg * 64, kk),
                                    kmajor(vt, Tt::BOX_BYTES, 0, kk), kk > 0);
            wgmma_commit();
            wgmma_wait<1>();                  // S (and the last dQ) done
            fence_regs(sacc);
            if (prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);
            prev = -1;
            // P: row = query (A or B), column = key 8j + 2·tig + (e & 1)
            if (ring.whole[s]) {
#pragma unroll
                for (int i = 0; i < TILE_ROWS / 2; ++i)
                    sacc[i] = fast_exp2(fmaf(sacc[i], sl2,
                                             ((i >> 1) & 1) ? -lB : -lA));
            } else {
                const int* kp = st.kp[s];
#pragma unroll
                for (int j = 0; j < TILE_ROWS / 8; ++j) {
                    const int2 k2 = *reinterpret_cast<const int2*>(
                        kp + 8 * j + 2 * tig);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = fast_exp2(fmaf(
                            sacc[4 * j + e], sl2, (e >> 1) ? -lB : -lA));
                        sacc[4 * j + e] =
                            allowed(a, (e >> 1) ? qpB : qpA,
                                    (e & 1) ? k2.y : k2.x) ? p : 0.f;
                    }
                }
            }
            wgmma_wait<0>();
            fence_regs(dpacc);
#pragma unroll
            for (int i = 0; i < TILE_ROWS / 2; ++i)
                dpacc[i] = sacc[i] * (dpacc[i] - (((i >> 1) & 1) ? dB : dA));
            pack_a(dpacc, dsf);
            // dQ += dS K: K N-major through the transpose bit
            wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < TILE_ROWS / 16; ++kc)
                wgmma<DH, 1>(dq, dsf[kc], nmajor(kt, Tt::BOX_BYTES, kc), 1);
            wgmma_commit();
            prev = s;                         // done at the next tile's wait
        }
        wgmma_wait<0>();
        fence_regs(dq);
        if (lane == 0) {
            if (prev >= 0) mbar_arrive(&ring.empty[prev]);
            mbar_arrive(&ring.empty[s]);      // the end marker's stage
            mbar_arrive(&ring.item_empty);    // Q, dO free
        }
        const size_t offA = rA * DH;
        const size_t offB = rB * DH;
        store_rows<DH>(static_cast<__nv_bfloat16*>(a.dq), offA, offB,
                       sA < a.S, sB < a.S, tig, dq, a.scale);
    }
}

// ---------------------------------------------------------------- host
int sm_count() {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
        return 0;
    return sms;
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const TcArgs& a, cudaStream_t st) {
    CUtensorMap qi, oi, kt, vt;               // the dQ kernel's
    CUtensorMap qt, ot, ki, vi;               // the dK/dV kernel's
    if (!rows_map(&qi, q, a.B, a.S, a.H, DH, ITEM_ROWS, 64) ||
        !rows_map(&oi, dout, a.B, a.S, a.H, DH, ITEM_ROWS, 64) ||
        !rows_map(&kt, k, a.B, a.T, a.KV, DH, TILE_ROWS, 64) ||
        !rows_map(&vt, v, a.B, a.T, a.KV, DH, TILE_ROWS, 64) ||
        !rows_map(&qt, q, a.B, a.S, a.H, DH, TILE_ROWS, 64) ||
        !rows_map(&ot, dout, a.B, a.S, a.H, DH, TILE_ROWS, 64) ||
        !rows_map(&ki, k, a.B, a.T, a.KV, DH, ITEM_ROWS, 64) ||
        !rows_map(&vi, v, a.B, a.T, a.KV, DH, ITEM_ROWS, 64))
        return cudaErrorInvalidValue;
    constexpr size_t kv_smem = dkdv_smem_bytes<DH>();
    constexpr size_t q_smem = dq_smem_bytes<DH>();
    static unsigned kv_ready = 0, q_ready = 0;
    cudaError_t err = allow_smem(bwd_dkdv_tc<DH>, kv_smem, kv_ready);
    if (err == cudaSuccess) err = allow_smem(bwd_dq_tc<DH>, q_smem, q_ready);
    if (err != cudaSuccess) return err;
    const int sms = sm_count();
    if (sms < 1) return cudaErrorInvalidDevice;
    const long long kv_items =
        (long long)(a.T + ITEM_ROWS - 1) / ITEM_ROWS * a.KV * a.B;
    const long long q_items =
        (long long)(a.S + ITEM_ROWS - 1) / ITEM_ROWS * a.H * a.B;
    if (kv_items > INT_MAX || q_items > INT_MAX) return cudaErrorInvalidValue;
    bwd_dkdv_tc<DH><<<(unsigned)(kv_items < sms ? kv_items : sms), THREADS,
                      kv_smem, st>>>(qt, ot, ki, vi, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dq_tc<DH><<<(unsigned)(q_items < sms ? q_items : sms), THREADS,
                    q_smem, st>>>(qi, oi, kt, vt, a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, S, H, dh); k, v, dk, dv (B, T, KV, dh); contiguous,
// 16-byte aligned, all bf16; dh 64 or 128. lse, delta float32 [B·S·H]:
// lse holds the forward's log-sum-exp when lse_ready (the prefill kernel
// writes it), else the pre-pass computes it there; delta is scratch.
// qpos (S,)/(B, S), kpos (T,)/(B, T) int32 or null with batch strides (0:
// one row shared). window <= 0 means none. Returns the launches'
// cudaError_t (0 on success).
int flash_bwd_tc_launch(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, void* lse, void* delta, const int* qpos,
                        const int* kpos, int qpos_bs, int kpos_bs, int B,
                        int S, int T, int H, int KV, int dh, int causal,
                        int window, int lse_ready, void* stream) {
    if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || !lse ||
        !delta || qpos_bs < 0 || kpos_bs < 0 || (dh != 64 && dh != 128))
        return (int)cudaErrorInvalidValue;
    int rc = flash_bwd_pre_launch(q, k, o, dout, lse, delta, qpos, kpos,
                                  qpos_bs, kpos_bs, B, S, T, H, KV, dh,
                                  causal, window, 1, lse_ready, stream);
    if (rc) return rc;
    const TcArgs a{dq, dk, dv, static_cast<const float*>(lse),
                   static_cast<const float*>(delta), qpos, kpos, qpos_bs,
                   kpos_bs, B, S, T, H, KV, causal, window,
                   (float)(1.0 / sqrt((double)dh))};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dh == 64 ? (int)launch_tc<64>(q, k, v, dout, a, st)
                    : (int)launch_tc<128>(q, k, v, dout, a, st);
}

}  // extern "C"
