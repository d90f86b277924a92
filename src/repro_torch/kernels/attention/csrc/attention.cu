// Flash attention (forward) on Hopper (sm_90a). Plain C interface, loaded
// with ctypes by ../../_build.py; the wrapper, its launch counter and the
// choice between the bf16 kernels live in ../kernel.py, the plain PyTorch
// version in ../ref.py.
//
// Replaces `flash_attention` / `_kernel` of
// src/repro/kernels/attention/kernel.py (:26-87, `pl.pallas_call` at :75):
// blockwise online-softmax attention with a running max m, normaliser l
// and accumulator in fp32, masked scores of -1e30, and output
// acc / max(l, 1e-30) in q's dtype. Beyond the TPU kernel, which the model
// could not call as it stands:
//   - layout: q, o (B, S, H, dh) and k, v (B, T, KV, dh), as the model
//     holds them, contiguous; no transposes and no GQA repeat of K/V.
//     Query head h reads KV head h / (H / KV), as jnp.repeat does.
//   - positions: optional int32 q_pos (S,) or (B, S) and k_pos (T,) or
//     (B, T), as the model's `blockwise_attention` takes them: a batch
//     stride of 0 shares one row of positions across the batch (M-RoPE's
//     temporal ids differ per row). A negative key position is an empty
//     cache slot and is masked. Without them q_pos is arange(S) + T - S
//     and k_pos arange(T), the TPU kernel's end-aligned default. Causal
//     keeps q_pos >= k_pos, a window keeps q_pos - k_pos < window. No
//     kernel assumes key positions sorted (a rolling cache's are not):
//     every skip and mask tests each key's own position.
//   - ragged lengths: any S, T >= 1 (the TPU kernel wants multiples of
//     128); the tail of the last tile is masked.
//   - a query row that may attend to no key at all comes out as zeros.
//     The kernels skip tiles no row of a block may attend to, so they
//     cannot reproduce the TPU kernel's average over masked keys there;
//     neither the model's decode (its own slot is always valid) nor
//     end-aligned causal prefill with S <= T produces such a row.
//
// Rows. Every kernel here packs (query position, head of the KV group)
// pairs into rows: row r of KV head kvh is query s = r / g, head
// kvh·g + r % g, with g = H / KV. A block owns rows of one (b, kvh) and
// reads that KV head's K/V tiles once for all g heads of the group.
//
// Bounds on an H100 SXM (700 W): 4·dh flops per allowed (query, key) pair
// and head (QK^T and PV) against 989 TFLOP/s bf16; bytes are q, k, v and
// o once each against 3.35 TB/s. Prefill (B=4, H=64, KV=8, S=T=2000,
// dh=128, causal) does about 2.6e11 flops, about 0.26 ms, against about
// 0.09 ms of bytes: operations bound it. Decode (S=1 against a 2032-slot
// cache) reads about 33 MB of K/V, about 10 µs: bytes bound it. So the
// two get different designs; kernel.py's `plan` sends S·g <= 64 rows per
// (b, kvh) to the first and the rest to the second.
//
//   flash_decode_bf16 (split-KV, bytes-bound). Grid (n_split, KV, B):
//     each block takes all S·g (<= 64) rows of one (b, kvh) against one
//     contiguous range of keys, so a decode step runs B·KV·n_split blocks
//     (352 at the shape above, 11 splits of 185 keys) instead of B·KV.
//     Four warps; 64-key tiles of K, V and their positions stream through
//     a two-stage ring with cp.async (16 bytes, .cg; zero-filled past the
//     range), issued before anything else the block does. Products are
//     mma.sync m16n8k16, enough at this bound: one m16 tile holds the
//     group's 8 or 4 rows, the warps split each tile's keys between them,
//     V is read with ldmatrix.trans, and p is multiplied as two bf16 terms
//     (hi + lo), which costs nothing here. Each block merges its warps and
//     writes fp32 acc and (m, l) per row to a workspace; the last block of
//     a (b, kvh) to finish (an atomic ticket, which that block resets to
//     0, so no memset is launched) merges the splits by the rescale-and-
//     add rule, 16-byte loads in flight together, and writes o. A split
//     with no allowed key gives l = 0 and acc = 0 and adds nothing.
//   flash_prefill_bf16 (TMA + wgmma, operations-bound). Persistent: one
//     block of 384 threads per SM walks work items (a row tile of 128
//     rows of one (b, kvh)), the heaviest row tiles first. Warpgroup 0
//     gives up registers (setmaxnreg) and one warp of it streams 128-key
//     tiles of K and V with TMA into a three-stage ring (4D tensor maps
//     over {dh, KV, T, B}, boxes of {<= 64, 1, 128, 1}, 128-byte swizzle,
//     64-byte for dh 32; the map zero-fills past T) with full/empty
//     mbarriers, skips tiles no row of the item may attend to, stages
//     each tile's key positions and whether it needs masks, and ends an
//     item with a marker, running ahead into the next item. Two computing
//     warpgroups of 64 rows each take Q from shared memory (staged with
//     cp.async during the item before) into registers; each step issues
//     S = Q·K^T of tile i (wgmma m64n128k16, K from shared memory) and
//     O += P·V of tile i-1 (wgmma with P from registers in bf16 and V
//     from shared memory through the instruction's transpose bit, so
//     there is no transpose pass), waits for S only, and runs the online
//     softmax (exp2 with the scale folded into one FFMA; masks only on
//     tiles that straddle the diagonal, the window edge, empty slots or
//     the tail) while P·V runs. p is rounded to bf16 once: both errors
//     are in PERF.md.
//   f32 — flash_fwd_f32: plain FMAs (the tensor cores have no fp32 mode
//     that meets a 2e-5 tolerance; TF32 keeps about 10 bits). 32 rows,
//     16-key tiles, four threads per row; every shared array is padded to
//     avoid bank conflicts. Not on the model's bf16 path.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -1e30f;     // score of a masked pair, as on the TPU
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    const int* qpos;                 // (S,) or null: arange(S) + T - S
    const int* kpos;                 // (T,) or null: arange(T)
    int qpos_bs, kpos_bs;            // batch strides of qpos / kpos; 0: shared
    int B, S, T, H, KV, causal, window;   // window <= 0: none
    float scale;                     // 1 / sqrt(dh)
};

__device__ __forceinline__ int q_position(const Args& a, int b, int s) {
    return a.qpos ? a.qpos[(size_t)b * a.qpos_bs + s] : s + a.T - a.S;
}

// Batch row b's key positions: null for arange(T)
__device__ __forceinline__ const int* key_positions(const Args& a, int b) {
    return a.kpos ? a.kpos + (size_t)b * a.kpos_bs : nullptr;
}

// -1 (masked) past the end, so the ragged tail needs no other test
__device__ __forceinline__ int k_position(const Args& a, int b, int t) {
    const int* kp = key_positions(a, b);
    return t >= a.T ? -1 : (kp ? kp[t] : t);
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

// May every query position in [qmin, qmax] attend to key position kp?
__device__ __forceinline__ bool needed_by_all(const Args& a, int qmin,
                                              int qmax, int kp) {
    return kp >= 0 && (!a.causal || kp <= qmin) &&
           (a.window <= 0 || (long long)qmax - kp < a.window);
}

// Element offset of row r (query s = r / g, head kvh·g + r % g) in q / o.
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int kvh,
                                             int g, int r, int dh) {
    const int s = r / g, j = r - s * g;
    return (((size_t)b * a.S + s) * a.H + (size_t)kvh * g + j) * dh;
}

// The range of query positions over rows [r0, r1) of batch row b in this
// block, into *lo / *hi (shared). Ends with a barrier.
__device__ void block_q_range(const Args& a, int b, int g, int r0, int r1,
                              int* lo, int* hi) {
    if (threadIdx.x == 0) { *lo = INT_MAX; *hi = INT_MIN; }
    __syncthreads();
    for (int s = r0 / g + threadIdx.x; s <= (r1 - 1) / g; s += blockDim.x) {
        const int p = q_position(a, b, s);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) as one bf16 pair; x0 in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16x2(float x0, float x1) {
    return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
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

// Q fragments of rows rA and rB = rA + 8 (mma A operand, row-major 16x16
// per k-step); zeros for a row past the end.
template <int DH>
__device__ __forceinline__ void load_q_fragments(
        const Args& a, int b, int kvh, int g, int rA, bool okA, bool okB,
        int tig, uint32_t (&qf)[DH / 16][4]) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    const __nv_bfloat16* qa = q + (okA ? row_offset(a, b, kvh, g, rA, DH) : 0);
    const __nv_bfloat16* qb =
        q + (okB ? row_offset(a, b, kvh, g, rA + 8, DH) : 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk * 16 + tig * 2;
        qf[kk][0] = okA ? *reinterpret_cast<const uint32_t*>(qa + c) : 0u;
        qf[kk][1] = okB ? *reinterpret_cast<const uint32_t*>(qb + c) : 0u;
        qf[kk][2] = okA ? *reinterpret_cast<const uint32_t*>(qa + c + 8) : 0u;
        qf[kk][3] = okB ? *reinterpret_cast<const uint32_t*>(qb + c + 8) : 0u;
    }
}

// 2^x to about 22 bits (one MUFU instruction; 0 far below the range).
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Raw scores q·k of one thread's two rows (e >> 1 picks row A or B;
// element e of n-tile j is key j·8 + 2·tig + (e & 1)) into probabilities,
// updating the running max m and per-thread partial sum l; returns the
// factor by which the accumulators must shrink. m is kept in base 2 (the
// score times scale·log2 e), so p = 2^(score·scale·log2 e − m) is one FFMA
// and one ex2; a masked pair gets p = 0. With MASK,
// `kp(c)` gives key c's position and each pair is tested; without it
// every row may attend to every key of the tile (the caller branches once
// per tile, not once per pair).
template <bool MASK, int NT, typename KeyPos>
__device__ __forceinline__ void online_softmax(
        const Args& a, float (&sc)[NT][4], int qpA, int qpB, int tig,
        KeyPos kp, float (&m)[2], float (&l)[2], float (&alpha)[2]) {
    const float scale = a.scale * LOG2E;
    float mx[2] = {-INFINITY, -INFINITY};     // raw scores
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (MASK && !allowed(a, (e >> 1) ? qpB : qpA,
                                 kp(j * 8 + tig * 2 + (e & 1))))
                sc[j][e] = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        // m stays MASKED while every pair so far was masked
        const float mn = fmaxf(m[h], quad_max(mx[h]) * scale);
        alpha[h] = fast_exp2(m[h] - mn);
        m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(fmaf(sc[j][e], scale, -m[e >> 1]));
            sc[j][e] = p;                     // 0 where masked
            rs[e >> 1] += p;
        }
    // l stays a per-thread partial sum until the end: alpha is the same
    // on the four threads of a row
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
}

// ------------------------------------------------------- bf16 decode
constexpr int D_BN = 64;            // keys per tile
constexpr int D_STAGES = 2;         // tiles in flight per block
constexpr int D_WARPS = 4;
constexpr int D_ROWS = 64;          // rows per (b, kvh) the kernel takes
constexpr int D_MAX_SPLITS = 64;

template <int DH>
constexpr size_t decode_smem_bytes() {
    const size_t ring = 2ull * D_STAGES * D_BN * (DH + 8) * 2;
    const size_t part = (size_t)D_WARPS * 16 * (DH + 2) * 4;
    const size_t weights = (2ull * D_ROWS * D_MAX_SPLITS + 2 * D_ROWS) * 4;
    return ring > part ? (ring > weights ? ring : weights)
                       : (part > weights ? part : weights);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give matrix i's rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// MT m16 tiles of rows (1, 2 or 4); warp w takes m-tile w % MT and the
// (w / MT)-th of the D_WARPS / MT equal parts of every key tile.
template <int DH, int MT>
__global__ void __launch_bounds__(32 * D_WARPS)
flash_decode_bf16(const Args a, const int split_keys, float* __restrict__ ws,
                  int* __restrict__ tickets) {
    static_assert(DH % 16 == 0 && D_WARPS % MT == 0, "shape");
    constexpr int KP = DH + 8;                // row pitch (elements)
    constexpr int KG = D_WARPS / MT, KW = D_BN / KG;   // key parts, width
    constexpr int CH = DH / 8;                // 16-byte chunks a row
    constexpr int PER = D_BN * CH / (32 * D_WARPS);
    static_assert(KW % 16 == 0 && D_BN * CH % (32 * D_WARPS) == 0, "tile");
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Vs = Ks + D_STAGES * D_BN * KP;
    __shared__ int kps[D_STAGES][D_BN];     // key positions of the tiles
    __shared__ int is_last;

    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);

    const int g = a.H / a.KV, R = a.S * g;
    const int split = blockIdx.x, n_split = gridDim.x;
    const int kvh = blockIdx.y, b = blockIdx.z, bk = b * a.KV + kvh;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = lane >> 2, tig = lane & 3;
    const int mt = warp % MT, kg = warp / MT;
    const int rA = mt * 16 + grp, rB = rA + 8;
    const bool okA = rA < R, okB = rB < R;
    // this split's keys; the wrapper leaves none empty
    const int t_begin = split * split_keys;
    const int t_end = min(a.T, t_begin + split_keys);
    const int ntiles = (t_end - t_begin + D_BN - 1) / D_BN;

    // The loads go out first: a split is a few tiles, and the block's
    // time is the chain of its memory round trips. Every key of the split
    // is read; those no row may attend to (empty slots, causal, window)
    // are masked. Keys past t_end are zero-filled, never read.
    const size_t kv_pitch = (size_t)a.KV * DH;      // from key t to t + 1
    const size_t kv_base = ((size_t)b * a.T * a.KV + kvh) * DH;
    const int* kpos = key_positions(a, b);
    auto load = [&](int stage, int tile) {
        const int t0 = t_begin + tile * D_BN;
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int i = tid + u * 32 * D_WARPS;
            const int row = i / CH, col = (i % CH) * 8, t = t0 + row;
            const bool ok = t < t_end;
            const size_t at = kv_base + (size_t)(ok ? t : 0) * kv_pitch + col;
            const int sm = (stage * D_BN + row) * KP + col;
            cp_async16(Ks + sm, k + at, ok);
            cp_async16(Vs + sm, v + at, ok);
        }
        if (kpos && tid < D_BN) {
            const bool ok = t0 + tid < t_end;
            cp_async4(&kps[stage][tid], kpos + (ok ? t0 + tid : 0), ok);
        }
    };
    // position of key t of tile i (masked past the split)
    auto key_pos = [&](int i, int t) {
        return t >= t_end ? -1
             : kpos ? kps[i % D_STAGES][t - t_begin - i * D_BN] : t;
    };

#pragma unroll
    for (int s = 0; s < D_STAGES - 1; ++s) {
        if (s < ntiles) load(s, s);
        cp_async_commit();
    }
    const int qpA = okA ? q_position(a, b, rA / g) : 0;
    const int qpB = okB ? q_position(a, b, rB / g) : 0;
    uint32_t qf[DH / 16][4];
    load_q_fragments<DH>(a, b, kvh, g, rA, okA, okB, tig, qf);
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
    float acc[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
        acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

    for (int i = 0; i < ntiles; ++i) {
        const int next = i + D_STAGES - 1;          // into the stage freed
        if (next < ntiles) load(next % D_STAGES, next);   // last round
        cp_async_commit();
        cp_async_wait<D_STAGES - 1>();              // tile i is in
        __syncthreads();
        const int at = ((i % D_STAGES) * D_BN + kg * KW) * KP;
        const __nv_bfloat16* Kt = Ks + at;  // this warp's keys of tile i
        const __nv_bfloat16* Vt = Vs + at;
        const int t0 = t_begin + i * D_BN + kg * KW;    // this warp's keys

        // S = Q K^T: n-tile j covers keys j*8 .. j*8+7 of the warp's part
        float sc[KW / 8][4];
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
            sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
            const __nv_bfloat16* kr = Kt + (j * 8 + grp) * KP + tig * 2;
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
                mma_bf16(sc[j], qf[kk],
                         *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                         *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
        }
        float alpha[2];
        online_softmax<true, KW / 8>(
            a, sc, qpA, qpB, tig, [&](int c) { return key_pos(i, t0 + c); },
            m, l, alpha);
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
            acc[nd][0] *= alpha[0]; acc[nd][1] *= alpha[0];
            acc[nd][2] *= alpha[1]; acc[nd][3] *= alpha[1];
        }

        // O += P V: score n-tiles 2kc and 2kc+1 form the A operand of
        // k-step kc; ldmatrix.trans reads V's fragments for two n-tiles
        const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kc = 0; kc < KW / 16; ++kc) {
            uint32_t hi[4], lo[4];
            split_bf16x2(sc[2 * kc][0], sc[2 * kc][1], hi[0], lo[0]);
            split_bf16x2(sc[2 * kc][2], sc[2 * kc][3], hi[1], lo[1]);
            split_bf16x2(sc[2 * kc + 1][0], sc[2 * kc + 1][1], hi[2], lo[2]);
            split_bf16x2(sc[2 * kc + 1][2], sc[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int np = 0; np < DH / 16; ++np) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, Vt + (kc * 16 + vrow) * KP
                                          + (2 * np + (lane >> 4)) * 8);
                mma_bf16(acc[2 * np], hi, bv[0], bv[1]);
                mma_bf16(acc[2 * np], lo, bv[0], bv[1]);
                mma_bf16(acc[2 * np + 1], hi, bv[2], bv[3]);
                mma_bf16(acc[2 * np + 1], lo, bv[2], bv[3]);
            }
        }
        __syncthreads();                    // the stage is free to refill
    }
    cp_async_wait<0>();                     // only empty groups remain

    // merge the warps that shared a row's keys: (m, l, acc) per warp row
    float* pm = reinterpret_cast<float*>(smem);     // [D_WARPS][16]
    float* pl = pm + D_WARPS * 16;                  // [D_WARPS][16]
    float* pa = pl + D_WARPS * 16;                  // [D_WARPS][16][DH]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float lsum = quad_sum(l[h]);
        if (tig == 0) {
            pm[warp * 16 + grp + 8 * h] = m[h];
            pl[warp * 16 + grp + 8 * h] = lsum;
        }
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
        float* ra = pa + (warp * 16 + grp) * DH + nd * 8 + tig * 2;
        ra[0] = acc[nd][0];
        ra[1] = acc[nd][1];
        ra[8 * DH] = acc[nd][2];
        ra[8 * DH + 1] = acc[nd][3];
    }
    __syncthreads();
    // this split's acc (R × DH) and (m, l) per row, in two regions of the
    // workspace; l = 0 and acc = 0 where it saw no allowed key, so it adds
    // nothing in the merge
    const size_t rows = (size_t)a.B * a.KV * n_split * R;     // all blocks'
    const size_t row0 = ((size_t)bk * n_split + split) * R;
    float2* ml = reinterpret_cast<float2*>(ws + rows * DH);
    auto part_max = [&](int r) {
        float mm = MASKED;
#pragma unroll
        for (int part = 0; part < KG; ++part)
            mm = fmaxf(mm, pm[(part * MT + r / 16) * 16 + r % 16]);
        return mm;
    };
    for (int i = tid; i < R * DH; i += blockDim.x) {
        const int r = i / DH, d = i - r * DH;
        const float mm = part_max(r);
        float val = 0.f;
        if (mm != MASKED)
#pragma unroll
            for (int part = 0; part < KG; ++part) {
                const int w = (part * MT + r / 16) * 16 + r % 16;
                val += exp2f(pm[w] - mm) * pa[w * DH + d];
            }
        ws[row0 * DH + i] = val;
    }
    for (int r = tid; r < R; r += blockDim.x) {
        const float mm = part_max(r);
        float sum = 0.f;
        if (mm != MASKED)
#pragma unroll
            for (int part = 0; part < KG; ++part) {
                const int w = (part * MT + r / 16) * 16 + r % 16;
                sum += exp2f(pm[w] - mm) * pl[w];
            }
        ml[row0 + r] = make_float2(mm, sum);
    }

    // the last split of this (b, kvh) to finish merges all of them
    __threadfence();
    __syncthreads();
    if (tid == 0)
        is_last = atomicAdd(tickets + bk, 1) == n_split - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const size_t first = (size_t)bk * n_split * R;    // split 0, row 0
    float* wm = reinterpret_cast<float*>(smem);       // [R][n_split] m, weight
    float* wl = wm + R * n_split;                     // [R][n_split] l
    float* row_m = wl + R * n_split;                  // [R]
    float* row_inv = row_m + R;                       // [R]
    for (int i = tid; i < R * n_split; i += blockDim.x) {
        const int r = i / n_split, s = i - r * n_split;
        const float2 x = __ldcg(ml + first + (size_t)s * R + r);
        wm[i] = x.x;
        wl[i] = x.y;
    }
    __syncthreads();
    for (int r = tid; r < R; r += blockDim.x) {
        float mm = MASKED, sum = 0.f;
        for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, wm[r * n_split + s]);
        for (int s = 0; s < n_split; ++s)
            sum += wl[r * n_split + s] * exp2f(wm[r * n_split + s] - mm);
        row_m[r] = mm;
        // a row no split could attend with comes out as zeros
        row_inv[r] = mm == MASKED ? 0.f : 1.f / fmaxf(sum, 1e-30f);
    }
    __syncthreads();
    for (int i = tid; i < R * n_split; i += blockDim.x) {
        const int r = i / n_split;
        wm[i] = row_inv[r] * exp2f(wm[i] - row_m[r]);
    }
    __syncthreads();
    const float4* acc4 = reinterpret_cast<const float4*>(ws + first * DH);
    for (int i = tid; i < R * DH / 4; i += blockDim.x) {
        const int r = i / (DH / 4), d4 = i - r * (DH / 4);
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int s = 0; s < n_split; ++s) {
            const float w = wm[r * n_split + s];
            const float4 x = __ldcg(acc4 + ((size_t)s * R + r) * (DH / 4) + d4);
            sum.x += w * x.x; sum.y += w * x.y;
            sum.z += w * x.z; sum.w += w * x.w;
        }
        __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
            o + row_offset(a, b, kvh, g, r, DH) + 4 * d4);
        out[0] = __floats2bfloat162_rn(sum.x, sum.y);
        out[1] = __floats2bfloat162_rn(sum.z, sum.w);
    }
    if (tid == 0) tickets[bk] = 0;          // ready for the next launch
}

// ------------------------------------------------------ bf16 prefill
// d (64 x 32, fp32) += a (64 x 16 bf16, registers) . b (16 x 32 bf16, shared
// memory at descriptor b); TRANS = 1 reads b N-major. scale_d = 0 drops d.
template <int TRANS>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,"
        "%8,%9,%10,%11,%12,%13,%14,%15"
        "}, {%16,%17,%18,%19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TRANS));
}

// d (64 x 64, fp32) += a (64 x 16 bf16, registers) . b (16 x 64 bf16, shared
// memory at descriptor b); TRANS = 1 reads b N-major. scale_d = 0 drops d.
template <int TRANS>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,"
        "%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,"
        "%24,%25,%26,%27,%28,%29,%30,%31"
        "}, {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TRANS));
}

// d (64 x 128, fp32) += a (64 x 16 bf16, registers) . b (16 x 128 bf16, shared
// memory at descriptor b); TRANS = 1 reads b N-major. scale_d = 0 drops d.
template <int TRANS>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,"
        "%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,"
        "%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,"
        "%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,"
        "%56,%57,%58,%59,%60,%61,%62,%63"
        "}, {%64,%65,%66,%67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TRANS));
}

template <int N, int TRANS>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t b, int scale_d) {
    if constexpr (N == 32) wgmma_m64n32<TRANS>(d, a, b, scale_d);
    else if constexpr (N == 64) wgmma_m64n64<TRANS>(d, a, b, scale_d);
    else wgmma_m64n128<TRANS>(d, a, b, scale_d);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {   // at most N groups pending
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving uses of wgmma's registers across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle layout (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
           (uint64_t)((sbo >> 4) & 0x3FFF) << 32 |
           (uint64_t)swizzle << 62;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One box of a 4D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
        : "memory");
}

constexpr int P_BM = 128;           // rows per block: two warpgroups of 64
constexpr int P_BN = 128;           // keys per tile
constexpr int P_STAGES = 3;         // ring of K/V tiles
constexpr int P_THREADS = 384;      // warpgroup 0 loads, 1 and 2 compute
constexpr int P_LOAD_REGS = 40, P_MATH_REGS = 232;   // 128·40 + 256·232

// A K or V tile in shared memory: DH / CH boxes of P_BN rows of CH
// elements, each row one swizzle span (128 bytes; 64 for dh 32).
template <int DH>
struct PrefillTile {
    static constexpr int CH = DH < 64 ? DH : 64;
    static constexpr int ROW_BYTES = CH * 2;
    static constexpr int BOXES = DH / CH;
    static constexpr int BOX_BYTES = P_BN * ROW_BYTES;
    static constexpr int BYTES = BOXES * BOX_BYTES;
    static constexpr uint32_t SWIZZLE = ROW_BYTES == 128 ? 1 : 2;
};

struct PrefillShared {
    uint64_t full[P_STAGES], empty[P_STAGES];
    int kp[P_STAGES][P_BN];          // key positions of the staged tile
    int t0[P_STAGES];                // its first key; -1: an item's end
    int whole[P_STAGES];             // every row may attend to every key
};

// the ring, Q of the next item (P_BM rows), the barriers and flags
template <int DH>
constexpr size_t prefill_smem_bytes() {
    return 1024 + 2ull * P_STAGES * PrefillTile<DH>::BYTES + P_BM * DH * 2
           + sizeof(PrefillShared);
}

// Chunk c (16 bytes) of a staged Q row sits at chunk c ^ (row mod 8, or
// mod 4 for dh 32), so fragment reads of 8 rows hit distinct banks.
template <int DH>
__device__ __forceinline__ int q_chunk(int row, int c) {
    return c ^ (row & (DH / 8 < 8 ? DH / 8 - 1 : 7));
}

__device__ __forceinline__ void group_sync(int id) {   // one warpgroup
    asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

template <int DH>
__global__ void __launch_bounds__(P_THREADS, 1)
flash_prefill_bf16(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const Args a) {
    using Tl = PrefillTile<DH>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* Kring = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* Vring = Kring + P_STAGES * Tl::BYTES;
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
        Vring + P_STAGES * Tl::BYTES);
    PrefillShared& sh = *reinterpret_cast<PrefillShared*>(Qs + P_BM * DH);

    const int g = a.H / a.KV, R = a.S * g;
    const int row_tiles = (R + P_BM - 1) / P_BM;
    const int items = row_tiles * a.KV * a.B;
    const int tid = threadIdx.x;
    // Work item w is (row tile, b, kvh), the heaviest row tiles first
    // (causal: the last positions attend to the most keys); block i takes
    // items i, i + gridDim.x, ... Its loader runs ahead into the next item
    // while the computing warps finish the last one.
    auto item = [&](int w, int& r0, int& b, int& kvh) {
        r0 = (row_tiles - 1 - w / (a.KV * a.B)) * P_BM;
        b = w / a.KV % a.B;
        kvh = w % a.KV;
    };

    if (tid == 0) {
        for (int s = 0; s < P_STAGES; ++s) {
            mbar_init(&sh.full[s], 32);         // the loading warp
            mbar_init(&sh.empty[s], 8);         // the computing warps
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid < 128) {
        // ---- loader: one warp walks each item's key tiles, skips those
        // no row of the item may attend to, keeps P_STAGES in flight
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(P_LOAD_REGS));
        if (tid >= 32) return;
        int n = 0;                              // stages filled
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
            int r0, b, kvh;
            item(w, r0, b, kvh);
            int qmin = INT_MAX, qmax = INT_MIN;   // over the item's rows
            const int s_hi = (min(r0 + P_BM, R) - 1) / g;
            for (int s = r0 / g + tid; s <= s_hi; s += 32) {
                const int qp = q_position(a, b, s);
                qmin = min(qmin, qp);
                qmax = max(qmax, qp);
            }
            for (int d = 16; d; d >>= 1) {
                qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, d));
                qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, d));
            }
            // a lane holds the positions of keys t0 + lane + 32·u, and
            // loads those of the next tile one tile ahead
            constexpr int KL = P_BN / 32;
            int kpn[KL];
#pragma unroll
            for (int u = 0; u < KL; ++u)
                kpn[u] = k_position(a, b, tid + 32 * u);
            bool sent = false;
            for (int t0 = 0; t0 < a.T; t0 += P_BN) {
                int kp[KL];
                bool any = false, all = true;
#pragma unroll
                for (int u = 0; u < KL; ++u) {
                    kp[u] = kpn[u];
                    kpn[u] = k_position(a, b, t0 + P_BN + tid + 32 * u);
                    any = any || needed(a, qmin, qmax, kp[u]);
                    all = all && needed_by_all(a, qmin, qmax, kp[u]);
                }
                // an item that needs no key still gets its last tile,
                // all masked: the computing loop needs a first tile
                if (!__any_sync(0xffffffffu, any) &&
                    (sent || t0 + P_BN < a.T))
                    continue;
                sent = true;
                const bool whole = __all_sync(0xffffffffu, all);
                const int s = n % P_STAGES, ph = (n / P_STAGES) & 1;
                mbar_wait(&sh.empty[s], ph ^ 1);
#pragma unroll
                for (int u = 0; u < KL; ++u)
                    sh.kp[s][tid + 32 * u] = kp[u];
                if (tid == 0) {
                    sh.t0[s] = t0;
                    sh.whole[s] = whole;
                    mbar_arrive_expect_tx(&sh.full[s], 2 * Tl::BYTES);
#pragma unroll
                    for (int c = 0; c < Tl::BOXES; ++c) {
                        const int at = s * Tl::BYTES + c * Tl::BOX_BYTES;
                        tma_load_4d(Kring + at, &kmap, &sh.full[s],
                                    c * Tl::CH, kvh, t0, b);
                        tma_load_4d(Vring + at, &vmap, &sh.full[s],
                                    c * Tl::CH, kvh, t0, b);
                    }
                } else {
                    mbar_arrive(&sh.full[s]);
                }
                ++n;
            }
            const int s = n % P_STAGES, ph = (n / P_STAGES) & 1;
            mbar_wait(&sh.empty[s], ph ^ 1);
            if (tid == 0) sh.t0[s] = -1;          // the end of the item
            mbar_arrive(&sh.full[s]);
            ++n;
        }
        return;
    }

    // ---- two computing warpgroups, 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(P_MATH_REGS));
    const int ct = tid - 128, wg = ct >> 7, lane = ct & 31;
    const int grp = lane >> 2, tig = lane & 3;
    uint32_t qf[DH / 16][4];                  // Q of the item's rows
    int qpA, qpB;                             // their positions
    float m[2], l[2];
    float acc[DH / 2];                        // wgmma m64nDH accumulator

    // Step i issues Q·K^T of tile i and then P·V of tile i-1, waits for the
    // first only, and runs tile i's softmax while P·V runs; acc is
    // rescaled once P·V is done. No product is issued under a branch:
    // ptxas would serialize them all.
    uint32_t pf[P_BN / 16][4];                // P of the previous tile, bf16
    float sacc[P_BN / 2];                     // wgmma m64nP_BN accumulator

    // O += P V: V is N-major (a key's dh contiguous), read through the
    // transpose bit; k-step kc starts 16 rows on, boxes of CH columns lie
    // BOX_BYTES apart, 8-row groups 8 rows apart
    auto issue_pv = [&](int stage) {
        const uint32_t vt = smem_u32(Vring + stage * Tl::BYTES);
#pragma unroll
        for (int kc = 0; kc < P_BN / 16; ++kc)
            wgmma<DH, 1>(acc, pf[kc],
                         smem_desc(vt + kc * 16 * Tl::ROW_BYTES, Tl::BOX_BYTES,
                                   8 * Tl::ROW_BYTES, Tl::SWIZZLE),
                         1);
        wgmma_commit();
    };
    // S = Q K^T: K is K-major (a key's dh contiguous); k-step kk reads 16
    // of dh at byte 32·kk of the swizzled rows, 8-row groups 8 rows apart
    auto issue_qk = [&](int stage) {
        const uint32_t kt = smem_u32(Kring + stage * Tl::BYTES);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
            wgmma<P_BN, 0>(sacc, qf[kk],
                           smem_desc(kt + (kk * 16 / Tl::CH) * Tl::BOX_BYTES
                                         + (kk * 16 % Tl::CH) * 2,
                                     16, 8 * Tl::ROW_BYTES, Tl::SWIZZLE),
                           kk > 0);
        wgmma_commit();
    };
    // softmax of the tile in `stage` (masks only where a pair may be
    // masked), probabilities left in sacc
    auto softmax_tile = [&](int stage, float (&alpha)[2]) {
        // the accumulator's n-group j is the score n-tile j of the mma path
        float (&sc)[P_BN / 8][4] =
            *reinterpret_cast<float (*)[P_BN / 8][4]>(sacc);
        const int* kp = sh.kp[stage];
        auto key = [&](int c) { return kp[c]; };
        if (sh.whole[stage])
            online_softmax<false, P_BN / 8>(a, sc, qpA, qpB, tig, key, m, l,
                                            alpha);
        else
            online_softmax<true, P_BN / 8>(a, sc, qpA, qpB, tig, key, m, l,
                                           alpha);
    };
    // acc rescaled (its products done) and P packed to bf16: score n-tiles
    // 2kc and 2kc+1 form the A operand of k-step kc
    auto rescale_pack = [&](const float (&alpha)[2]) {
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
            acc[4 * j] *= alpha[0]; acc[4 * j + 1] *= alpha[0];
            acc[4 * j + 2] *= alpha[1]; acc[4 * j + 3] *= alpha[1];
        }
#pragma unroll
        for (int kc = 0; kc < P_BN / 16; ++kc) {
            const int j = 8 * kc;             // sacc index of n-tile 2kc
            pf[kc][0] = pack_bf16x2(sacc[j], sacc[j + 1]);
            pf[kc][1] = pack_bf16x2(sacc[j + 2], sacc[j + 3]);
            pf[kc][2] = pack_bf16x2(sacc[j + 4], sacc[j + 5]);
            pf[kc][3] = pack_bf16x2(sacc[j + 6], sacc[j + 7]);
        }
    };

    // Q of an item's 64 rows for this group, staged with cp.async while
    // the group works on the item before
    __nv_bfloat16* Qg = Qs + wg * 64 * DH;
    auto stage_q = [&](int w) {
        int r0, b, kvh;
        item(w, r0, b, kvh);
        const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
        constexpr int CH = DH / 8;            // 16-byte chunks a row
#pragma unroll
        for (int i = ct % 128; i < 64 * CH; i += 128) {
            const int row = i / CH, c = i % CH, r = r0 + wg * 64 + row;
            const bool ok = r < R;
            cp_async16(Qg + row * DH + q_chunk<DH>(row, c) * 8,
                       q + (ok ? row_offset(a, b, kvh, g, r, DH) : 0) + c * 8,
                       ok);
        }
        cp_async_commit();
    };
    // this thread's A fragments from the staged rows (zeros past R)
    auto read_q = [&]() {
        const int ra = ((ct >> 5) & 3) * 16 + grp, rb = ra + 8;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
            const int c = tig * 2;
            qf[kk][0] = *reinterpret_cast<const uint32_t*>(
                Qg + ra * DH + q_chunk<DH>(ra, 2 * kk) * 8 + c);
            qf[kk][1] = *reinterpret_cast<const uint32_t*>(
                Qg + rb * DH + q_chunk<DH>(rb, 2 * kk) * 8 + c);
            qf[kk][2] = *reinterpret_cast<const uint32_t*>(
                Qg + ra * DH + q_chunk<DH>(ra, 2 * kk + 1) * 8 + c);
            qf[kk][3] = *reinterpret_cast<const uint32_t*>(
                Qg + rb * DH + q_chunk<DH>(rb, 2 * kk + 1) * 8 + c);
        }
    };

    int slot = 0;                             // stages taken
    if (blockIdx.x < items) stage_q(blockIdx.x);
    auto take = [&]() {                       // the next stage, once full
        const int s = slot % P_STAGES;
        mbar_wait(&sh.full[s], (slot / P_STAGES) & 1);
        ++slot;
        return s;
    };

    for (int w = blockIdx.x; w < items; w += gridDim.x) {
        int r0, b, kvh;
        item(w, r0, b, kvh);
        // accumulator rows grp and grp + 8 of this warp's 16
        const int rA = r0 + wg * 64 + ((ct >> 5) & 3) * 16 + grp, rB = rA + 8;
        const bool okA = rA < R, okB = rB < R;
        qpA = okA ? q_position(a, b, rA / g) : 0;
        qpB = okB ? q_position(a, b, rB / g) : 0;
        cp_async_wait<0>();
        group_sync(1 + wg);                   // the group's rows are in
        read_q();
        group_sync(1 + wg);                   // and read: stage the next
        if (w + (int)gridDim.x < items) stage_q(w + gridDim.x);
        m[0] = m[1] = MASKED;
        l[0] = l[1] = 0.f;
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

        // the loader sends at least one tile an item, then an end marker
        float alpha[2];
        int prev = take();
        wgmma_fence();
        issue_qk(prev);
        wgmma_wait<0>();
        fence_regs(sacc);
        softmax_tile(prev, alpha);
        rescale_pack(alpha);
        for (;;) {
            const int s = take();
            if (sh.t0[s] < 0) {               // the item's end
                if (lane == 0) mbar_arrive(&sh.empty[s]);
                break;
            }
            wgmma_fence();
            issue_qk(s);
            issue_pv(prev);
            wgmma_wait<1>();                  // Q·K^T done, P·V running
            fence_regs(sacc);
            softmax_tile(s, alpha);
            wgmma_wait<0>();
            fence_regs(acc);
            if (lane == 0) mbar_arrive(&sh.empty[prev]);   // stage free
            rescale_pack(alpha);
            prev = s;
        }
        wgmma_fence();
        issue_pv(prev);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&sh.empty[prev]);

        // rows whose max never rose above MASKED saw no key: zeros
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);
        float inv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float sum = quad_sum(l[h]);
            inv[h] = m[h] == MASKED ? 0.f : 1.f / fmaxf(sum, 1e-30f);
        }
        if (okA) {
            __nv_bfloat16* oa = o + row_offset(a, b, kvh, g, rA, DH) + tig * 2;
#pragma unroll
            for (int j = 0; j < DH / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(oa + j * 8) =
                    __floats2bfloat162_rn(acc[4 * j] * inv[0],
                                          acc[4 * j + 1] * inv[0]);
        }
        if (okB) {
            __nv_bfloat16* ob = o + row_offset(a, b, kvh, g, rB, DH) + tig * 2;
#pragma unroll
            for (int j = 0; j < DH / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(ob + j * 8) =
                    __floats2bfloat162_rn(acc[4 * j + 2] * inv[1],
                                          acc[4 * j + 3] * inv[1]);
        }
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

    block_q_range(a, b, g, r0, r1, &q_lo, &q_hi);
    const int qmin = q_lo, qmax = q_hi;
    const int qp = ok ? q_position(a, b, (r0 + row) / g) : 0;

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
            const int kp = k_position(a, b, t0 + tid);
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

// ------------------------------------------------------------------ host
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

template <int DH, int MT>
cudaError_t launch_decode_mt(const Args& a, dim3 grid, int split_keys,
                             float* ws, int* tickets, cudaStream_t st) {
    constexpr size_t smem = decode_smem_bytes<DH>();
    static unsigned ready = 0;
    const cudaError_t err = allow_smem(flash_decode_bf16<DH, MT>, smem, ready);
    if (err != cudaSuccess) return err;
    flash_decode_bf16<DH, MT><<<grid, 32 * D_WARPS, smem, st>>>(
        a, split_keys, ws, tickets);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_decode(const Args& a, int split_keys, float* ws,
                          int* tickets, cudaStream_t st) {
    const int R = a.S * (a.H / a.KV);
    if (R > D_ROWS || !ws || !tickets) return cudaErrorInvalidValue;
    const int n_split = (a.T + split_keys - 1) / split_keys;
    if (n_split > D_MAX_SPLITS) return cudaErrorInvalidValue;
    const dim3 grid(n_split, a.KV, a.B);
    if (R <= 16)
        return launch_decode_mt<DH, 1>(a, grid, split_keys, ws, tickets, st);
    if (R <= 32)
        return launch_decode_mt<DH, 2>(a, grid, split_keys, ws, tickets, st);
    return launch_decode_mt<DH, 4>(a, grid, split_keys, ws, tickets, st);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found =
            cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found);
#endif
        if (found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// K or V (B, T, KV, dh) as a 4D map {dh, KV, T, B} with boxes {CH, 1, P_BN,
// 1}: one box is P_BN keys of one KV head, zero past T.
template <int DH>
bool kv_map(CUtensorMap* map, const void* base, const Args& a) {
    using Tl = PrefillTile<DH>;
    const EncodeTiled encode = encode_tiled();
    if (!encode) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)a.KV,
                                (cuuint64_t)a.T, (cuuint64_t)a.B};
    const cuuint64_t strides[3] = {(cuuint64_t)DH * 2,
                                   (cuuint64_t)a.KV * DH * 2,
                                   (cuuint64_t)a.T * a.KV * DH * 2};
    const cuuint32_t box[4] = {(cuuint32_t)Tl::CH, 1, (cuuint32_t)P_BN, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  Tl::SWIZZLE == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_prefill(const Args& a, cudaStream_t st) {
    CUtensorMap kmap, vmap;
    if (!kv_map<DH>(&kmap, a.k, a) || !kv_map<DH>(&vmap, a.v, a))
        return cudaErrorInvalidValue;
    constexpr size_t smem = prefill_smem_bytes<DH>();
    static unsigned ready = 0;
    const cudaError_t err = allow_smem(flash_prefill_bf16<DH>, smem, ready);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const long long rows = (long long)a.S * (a.H / a.KV);
    const long long items = (rows + P_BM - 1) / P_BM * a.KV * a.B;
    if (items > INT_MAX) return cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(items < sms ? items : sms);  // one a SM
    flash_prefill_bf16<DH><<<grid, P_THREADS, smem, st>>>(kmap, vmap, a);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const Args& a, bool bf16, int split_keys, float* ws,
                      int* tickets, cudaStream_t st) {
    if (!bf16) {
        const long long rows = (long long)a.S * (a.H / a.KV);
        const dim3 grid((unsigned)((rows + F_BM - 1) / F_BM), a.KV, a.B);
        flash_fwd_f32<DH><<<grid, F_THREADS, 0, st>>>(a);
        return cudaGetLastError();
    }
    return split_keys > 0 ? launch_decode<DH>(a, split_keys, ws, tickets, st)
                          : launch_prefill<DH>(a, st);
}

}  // namespace

extern "C" {

// q, o (B, S, H, dh); k, v (B, T, KV, dh); contiguous, all bf16 (bf16 = 1)
// or all float32 (bf16 = 0); dh is 32, 64 or 128. qpos (S,) or (B, S) /
// kpos (T,) or (B, T) int32, or null; qpos_bs / kpos_bs are their batch
// strides (S / T for a row each, 0 for one row shared by the batch).
// window <= 0 means none. bf16 only: split_keys > 0 runs
// the decode kernel over ⌈T / split_keys⌉ splits of split_keys keys (at
// most 64 splits, S·H/KV <= 64 rows) with ws, float32
// [B·KV·splits·S·(H/KV)·(dh + 2)], and tickets, int32 [B·KV] zeros (left
// zero); split_keys = 0 runs the prefill kernel. Returns the launch's
// cudaError_t (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const int* qpos, const int* kpos,
                           int qpos_bs, int kpos_bs, int B, int S, int T,
                           int H, int KV, int dh, int causal, int window,
                           int bf16, int split_keys, void* ws, void* tickets,
                           void* stream) {
    if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 ||
        (dh != 32 && dh != 64 && dh != 128) || split_keys < 0 ||
        qpos_bs < 0 || kpos_bs < 0)
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, o, qpos, kpos, qpos_bs, kpos_bs, B, S, T, H, KV,
                 causal, window, (float)(1.0 / sqrt((double)dh))};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* w = static_cast<float*>(ws);
    int* t = static_cast<int*>(tickets);
    switch (dh) {
        case 32: return (int)launch_dh<32>(a, bf16 != 0, split_keys, w, t, st);
        case 64: return (int)launch_dh<64>(a, bf16 != 0, split_keys, w, t, st);
        default: return (int)launch_dh<128>(a, bf16 != 0, split_keys, w, t, st);
    }
}

}  // extern "C"
