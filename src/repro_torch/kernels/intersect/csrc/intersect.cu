// IoU Sketch query combine on Hopper (sm_90a): L-way AND + popcount, and
// the AND/OR/ANDNOT program evaluator. Plain C interface, loaded with
// ctypes by ../_build.py; wrappers and launch counters live in ../ops.py,
// the plain PyTorch versions in ../ref.py.
//
// Layout: bitmaps are row-major (rows, L, W) uint32 document bitsets
// (W = ceil(n_docs / 32) words), programs (rows, S, 3) int32 rows of
// (opcode, slot_a, slot_b). Results are (rows, W) uint32 and per-row
// counts are uint64, which the wrapper zero-fills before the launch.
//
// and_popcount — replaces `_kernel`/`intersect_pallas` (kernel.py:56-85)
//   and `_batch_kernel`/`intersect_batch_pallas` (kernel.py:88-95,
//   220-245) of src/repro/kernels/intersect/kernel.py.
// combine_program — replaces `_combine_kernel`/`combine_batch_pallas`
//   (kernel.py:102-156) and `_cluster_kernel`/`combine_cluster_pallas`
//   (kernel.py:159-217): the cluster kernel's (shard, query) grid axes
//   are flattened into one row axis, so combine_batch is its G=1 case.
//
// Bound on an H100 SXM (3.35 TB/s, 700 W): no tensor cores and about
// one integer op per byte, so both are memory-bound. and_popcount must
// read all L layers: 4·rows·(L+1)·W bytes of bitmaps in and out, plus
// 8·rows bytes of counts; e.g. (128, 3, 22346) moves about 46 MB,
// about 14 µs at 3.35 TB/s. combine_program reads only the layers its
// steps name (the planner pads ragged L with unnamed layers): 4·W bytes
// per named (row, layer) and per output row, plus 12·rows·S bytes of
// programs and the counts.
//
// Design against that bound: each input word is read once and each
// output word written once. A thread owns one word column of one row
// and walks the layers (or program steps) in registers/local memory,
// so neighbouring threads read neighbouring words — every load and
// store is coalesced. There is no padding to the TPU's 1024-word tile:
// the ragged edge is masked with `w < W` and masked lanes count zero.
// Counts are a warp-shuffle + shared-memory block sum of __popc and ONE
// 64-bit atomicAdd per block; integer addition makes the total the same
// in any order. The grid is (word tiles, rows): blocks run in any order,
// so nothing carries over between them (the TPU grid ran in sequence).
// Program slots are data-indexed: input layers are read straight from
// global memory when a step names them, step results live in a per-
// thread array of MAX_STEPS words (local memory, cached in L1), and the
// wrapper refuses programs longer than MAX_STEPS rather than truncate.

// From posting ranks to candidate keys (the index path's route):
//
// combine_postings — replaces the same four TPU kernels on the index
//   path, from what the host already has: each (row, layer) is a sorted
//   list of int32 ranks into one sorted universe of keys shared by every
//   row of the launch (CSR: one flat rank array and (rows, L, 2)
//   [start, end) bounds into it; rows may share a list). A block owns
//   one tile of TILE_W words (tile_w·32 ranks) of one row. It loads the
//   row's program and its lists' bounds into shared memory, binary-
//   searches each list for the tile's ranks (they are contiguous: the
//   list is sorted), sets their bits into shared-memory layer tiles,
//   evaluates the program word-parallel from shared memory (every slot a
//   tile there, no per-thread array), and writes the tile's result words
//   and its popcount to a (rows, tiles) int32 array: no global atomic,
//   no zero-filled output, the same counts on every run. An L-way AND is
//   the program of L - 1 AND steps.
// bits_to_keys — from those result words and the exclusive offsets of
//   the tile counts (one int64 cumsum between the launches), writes each
//   set bit's universe key into one flat int64 array, row after row in
//   ascending order: row r's keys are universe[flatnonzero(bits[r])].
//   Without a universe (identity: the sketch's doc ids) the key is the
//   rank. Given a rank array it also writes each key's int32 rank there
//   (the planner recovers document lengths from the ranks).
//
// Bounds on an H100 SXM (3.35 TB/s): both move bytes. combine_postings
// reads 4 B for each rank of a list a program names, 8 B of bounds per
// (row, layer), 12 B per program step, and writes 4 B per result word
// (ceil(U / 32) a row; the padding of the last tile is not counted) and
// per tile count; its integer work (one shared atomic per run of ranks
// in a word, one LOP3 per step and word, popc) is a small fraction of
// that at the INT32 rate. bits_to_keys reads those words and the tile
// offsets and writes 8 B per key (and 4 B per rank when asked); it
// reads 8 B of universe for each distinct universe entry its keys hit
// (all rows gather from one universe, which fits in the 50 MB L2, so an
// entry hit by many rows comes from HBM once). Design against the
// bounds: ranks are read once per (row, list)
// with coalesced 4-byte loads by all warps of the block in turn; the
// lanes of a warp that hit the same word (contiguous, as the list is
// sorted) OR their bits together with five shuffles, so one shared
// atomic lands per word a warp touches, however dense the list; result
// words leave as 16-byte stores; the tile count is a block sum written
// once. bits_to_keys reads 16 bytes a thread, places each warp's keys by
// a block scan of the threads' popcounts, and has each warp write its
// keys (and ranks) 32 consecutive ones a round, so its stores coalesce
// however the bits fall. Rows walk gridDim.y in a grid-stride
// loop, so any number of rows fits CUDA's 65535 limit on gridDim.y.
// The wrapper picks tile_w (a power of two from 32 to 1024 words) so
// that the (L + S) slot tiles fit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_STEPS 128
#define MAX_TILE_W (4 * THREADS)     // words; 4 a thread in bits_to_keys

static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block size");

// Sum `c` over the block and add it to *cnt with one atomic.
__device__ __forceinline__ void add_block_count(unsigned c,
                                                unsigned long long* cnt) {
    __shared__ unsigned warp_sums[THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0) warp_sums[warp] = c;
    __syncthreads();
    if (warp == 0) {
        c = lane < THREADS / 32 ? warp_sums[lane] : 0u;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            c += __shfl_down_sync(0xffffffffu, c, off);
        if (lane == 0 && c) atomicAdd(cnt, (unsigned long long)c);
    }
}

__global__ void __launch_bounds__(THREADS)
and_popcount(const uint32_t* __restrict__ bm, uint32_t* __restrict__ out,
             unsigned long long* __restrict__ cnt, int L, int W) {
    const size_t row = blockIdx.y;
    const int w = blockIdx.x * THREADS + threadIdx.x;
    uint32_t acc = 0;
    if (w < W) {
        const uint32_t* src = bm + row * (size_t)L * W + w;
        acc = __ldg(src);
        for (int l = 1; l < L; ++l) acc &= __ldg(src + (size_t)l * W);
        out[row * (size_t)W + w] = acc;
    }
    add_block_count(__popc(acc), cnt + row);
}

__global__ void __launch_bounds__(THREADS)
combine_program(const uint32_t* __restrict__ bm,
                const int32_t* __restrict__ prog,
                uint32_t* __restrict__ out,
                unsigned long long* __restrict__ cnt, int L, int S, int W) {
    extern __shared__ int32_t sprog[];          // this row's (S, 3) program
    const size_t row = blockIdx.y;
    for (int i = threadIdx.x; i < 3 * S; i += THREADS)
        sprog[i] = prog[row * 3 * (size_t)S + i];
    __syncthreads();
    const int w = blockIdx.x * THREADS + threadIdx.x;
    uint32_t acc = 0;
    if (w < W) {
        const uint32_t* src = bm + row * (size_t)L * W + w;
        uint32_t steps[MAX_STEPS];              // slot L+s lives in steps[s]
        for (int s = 0; s < S; ++s) {
            const int op = sprog[3 * s], a = sprog[3 * s + 1],
                      b = sprog[3 * s + 2];
            const uint32_t va = a < L ? __ldg(src + (size_t)a * W)
                                      : steps[a - L];
            const uint32_t vb = b < L ? __ldg(src + (size_t)b * W)
                                      : steps[b - L];
            steps[s] = op == 0 ? (va & vb) : op == 1 ? (va | vb)
                                                     : (va & ~vb);
        }
        acc = S ? steps[S - 1] : __ldg(src + (size_t)(L - 1) * W);
        out[row * (size_t)W + w] = acc;
    }
    add_block_count(__popc(acc), cnt + row);
}


// Tile count of a block: the sum of `c` over its threads, for thread 0.
__device__ __forceinline__ unsigned block_sum(unsigned c) {
    __shared__ unsigned warp_sums[THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0) warp_sums[warp] = c;
    __syncthreads();
    c = 0;
    if (threadIdx.x == 0)
        for (int w = 0; w < THREADS / 32; ++w) c += warp_sums[w];
    return c;
}

// First index in the sorted ranks[lo, hi) that is >= target.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ ranks,
                                           int lo, int hi, int target) {
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (__ldg(ranks + mid) < target) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Shared memory: the row's program (3·S ints) and each layer's ranks in
// this tile ([lo, hi) for each of L layers), padded to 16 bytes, then
// L + S slot tiles of tile_w words: layers first, then one per step.
__global__ void __launch_bounds__(THREADS)
combine_postings(const int32_t* __restrict__ ranks,
                 const int32_t* __restrict__ bounds,
                 const int32_t* __restrict__ prog,
                 uint32_t* __restrict__ out, int32_t* __restrict__ tile_cnt,
                 int rows, int L, int S, int tile_w) {
    extern __shared__ __align__(16) int32_t smem_i[];
    int32_t* sprog = smem_i;
    int32_t* span = smem_i + 3 * S;
    uint32_t* slots = (uint32_t*)(smem_i + ((3 * S + 2 * L + 3) & ~3));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile = blockIdx.x, tiles = gridDim.x;
    const int tile_bits = tile_w * 32, first = tile * tile_bits;
    const int groups = tile_w / 4;             // 16-byte word groups

    for (int row = blockIdx.y; row < rows; row += gridDim.y) {
        const size_t r = row;
        for (int i = threadIdx.x; i < 3 * S; i += THREADS)
            sprog[i] = prog[r * 3 * S + i];
        // thread 2l + e finds where layer l's ranks reach the tile's
        // first rank (e = 0) and pass its last (e = 1)
        for (int i = threadIdx.x; i < 2 * L; i += THREADS) {
            const int start = bounds[r * 2 * L + (i & ~1)];
            const int end = bounds[r * 2 * L + (i | 1)];
            span[i] = lower_bound(ranks, start, end,
                                  first + (i & 1) * tile_bits);
        }
        uint4* layers4 = (uint4*)slots;
        for (int i = threadIdx.x; i < L * groups; i += THREADS)
            layers4[i] = make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();

        // set the bits: all warps walk each layer's ranks in turn, 32 a
        // warp; lanes of one word OR their bits (a suffix OR over the
        // contiguous run) and the run's first lane sets them
        for (int l = 0; l < L; ++l) {
            const int lo = span[2 * l], hi = span[2 * l + 1];
            uint32_t* dst = slots + (size_t)l * tile_w;
            for (int base = lo + warp * 32; base < hi; base += THREADS) {
                const int i = base + lane;
                const bool ok = i < hi;
                const int rk = ok ? __ldg(ranks + i) - first : 0;
                const int word = ok ? rk >> 5 : -1;
                uint32_t bits = ok ? 1u << (rk & 31) : 0u;
#pragma unroll
                for (int off = 1; off < 32; off <<= 1) {
                    const uint32_t b = __shfl_down_sync(0xffffffffu, bits,
                                                        off);
                    const int w = __shfl_down_sync(0xffffffffu, word, off);
                    if (lane + off < 32 && w == word) bits |= b;
                }
                const int prev = __shfl_up_sync(0xffffffffu, word, 1);
                if (ok && (lane == 0 || prev != word))
                    atomicOr(dst + word, bits);
            }
        }
        __syncthreads();

        // evaluate the program: a thread owns 16-byte word groups and
        // reads and writes only its own columns of the slot tiles
        unsigned c = 0;
        uint4* out4 = (uint4*)(out + (r * tiles + tile) * (size_t)tile_w);
        for (int g = threadIdx.x; g < groups; g += THREADS) {
            const uint4* s4 = (const uint4*)slots;
            uint4 acc = S ? make_uint4(0u, 0u, 0u, 0u)
                          : s4[(size_t)(L - 1) * groups + g];
            for (int s = 0; s < S; ++s) {
                const int op = sprog[3 * s];
                const uint4 a = s4[(size_t)sprog[3 * s + 1] * groups + g];
                const uint4 b = s4[(size_t)sprog[3 * s + 2] * groups + g];
                acc = op == 0 ? make_uint4(a.x & b.x, a.y & b.y, a.z & b.z,
                                           a.w & b.w)
                    : op == 1 ? make_uint4(a.x | b.x, a.y | b.y, a.z | b.z,
                                           a.w | b.w)
                              : make_uint4(a.x & ~b.x, a.y & ~b.y,
                                           a.z & ~b.z, a.w & ~b.w);
                ((uint4*)slots)[(size_t)(L + s) * groups + g] = acc;
            }
            out4[g] = acc;
            c += __popc(acc.x) + __popc(acc.y) + __popc(acc.z)
               + __popc(acc.w);
        }
        c = block_sum(c);
        if (threadIdx.x == 0) tile_cnt[r * tiles + tile] = (int32_t)c;
        __syncthreads();                 // shared memory is reused by row
    }
}

// The place (0..127) of the n-th set bit (n from 0) of the 128 bits
// x, y, z, w hold (bit b of word k is place 32·k + b); n < their popcount.
__device__ __forceinline__ int nth_set_bit(uint32_t x, uint32_t y,
                                           uint32_t z, uint32_t w,
                                           unsigned n) {
    int place = 0;
    uint32_t word = x;
    unsigned c = __popc(x);
    if (n >= c) {
        n -= c; place = 32; word = y; c = __popc(y);
        if (n >= c) {
            n -= c; place = 64; word = z; c = __popc(z);
            if (n >= c) { n -= c; place = 96; word = w; }
        }
    }
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) {
        c = __popc(word & ((1u << half) - 1u));
        if (n >= c) { n -= c; place += half; word >>= half; }
    }
    return place;
}

// words (rows, tiles·tile_w), offsets (rows·tiles,) exclusive int64
// prefix of the tile counts → keys (sum of counts,) int64 and, unless
// key_ranks is NULL, each key's rank (sum of counts,) int32.
//
// A thread loads 4 words (16 bytes); a block scan of the threads'
// popcounts places each warp's keys, which are contiguous in the output.
// The warp then writes them together, 32 consecutive keys a round: lane
// i takes key j = round + i, finds the lane whose bits hold it (a binary
// search over the lanes' exclusive counts by shuffles) and its place in
// that lane's 128 bits, so every store of a round is coalesced.
__global__ void __launch_bounds__(THREADS)
bits_to_keys(const uint32_t* __restrict__ words,
             const int64_t* __restrict__ offsets,
             const int64_t* __restrict__ universe,
             int64_t* __restrict__ keys, int32_t* __restrict__ key_ranks,
             int rows, int tile_w) {
    __shared__ unsigned warp_sums[THREADS / 32];
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile = blockIdx.x, tiles = gridDim.x, g = threadIdx.x;
    for (int row = blockIdx.y; row < rows; row += gridDim.y) {
        const size_t t = (size_t)row * tiles + tile;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (4 * g < tile_w)
            v = __ldg((const uint4*)(words + t * tile_w) + g);
        const unsigned c = __popc(v.x) + __popc(v.y) + __popc(v.z)
                         + __popc(v.w);
        // inclusive scan of c within the warp; the warps' totals place
        // each warp's keys in the tile's
        unsigned incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const unsigned n = __shfl_up_sync(full, incl, off);
            if (lane >= off) incl += n;
        }
        if (lane == 31) warp_sums[warp] = incl;
        __syncthreads();
        int64_t base = offsets[t];
        for (int w = 0; w < warp; ++w) base += warp_sums[w];
        const unsigned total = warp_sums[warp], excl = incl - c;
        // rank of the warp's first bit
        const int64_t rank0 = ((int64_t)tile * tile_w + 128 * warp) * 32;
        for (unsigned round = 0; round < total; round += 32) {
            const unsigned j = round + lane;
            // the last lane whose exclusive count is <= j holds key j
            // (a lane without bits shares its count with the next one)
            int src = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1)
                if (__shfl_sync(full, excl, src + step) <= j) src += step;
            const uint32_t x = __shfl_sync(full, v.x, src),
                           y = __shfl_sync(full, v.y, src),
                           z = __shfl_sync(full, v.z, src),
                           w = __shfl_sync(full, v.w, src);
            const unsigned n = j - __shfl_sync(full, excl, src);
            if (j < total) {
                const int64_t rk = rank0 + 128 * src
                                 + nth_set_bit(x, y, z, w, n);
                if (key_ranks) key_ranks[base + j] = (int32_t)rk;
                keys[base + j] = universe ? __ldg(universe + rk) : rk;
            }
        }
        __syncthreads();                 // warp_sums is reused by row
    }
}

extern "C" {

int intersect_max_steps(void) { return MAX_STEPS; }

// bm (rows, L, W) → out (rows, W), cnt (rows,). Returns cudaGetLastError().
int and_popcount_launch(const void* bm, void* out, void* cnt, int rows,
                        int L, int W, void* stream) {
    const dim3 grid((W + THREADS - 1) / THREADS, rows);
    and_popcount<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bm, (uint32_t*)out, (unsigned long long*)cnt, L, W);
    return (int)cudaGetLastError();
}

// bm (rows, L, W), prog (rows, S, 3) → out (rows, W), cnt (rows,).
int combine_program_launch(const void* bm, const void* prog, void* out,
                           void* cnt, int rows, int L, int S, int W,
                           void* stream) {
    const dim3 grid((W + THREADS - 1) / THREADS, rows);
    combine_program<<<grid, THREADS, 3 * S * sizeof(int32_t),
                      (cudaStream_t)stream>>>(
        (const uint32_t*)bm, (const int32_t*)prog, (uint32_t*)out,
        (unsigned long long*)cnt, L, S, W);
    return (int)cudaGetLastError();
}

int intersect_max_tile_words(void) { return MAX_TILE_W; }

// Shared memory combine_postings needs at these sizes (bytes).
static size_t postings_smem(int L, int S, int tile_w) {
    return 4 * (size_t)((3 * S + 2 * L + 3) & ~3)
         + 4 * (size_t)(L + S) * tile_w;
}

// ranks (n,), bounds (rows, L, 2), prog (rows, S, 3) → out (rows,
// tiles·tile_w), tile_cnt (rows, tiles). Returns cudaGetLastError().
int combine_postings_launch(const void* ranks, const void* bounds,
                            const void* prog, void* out, void* tile_cnt,
                            int rows, int L, int S, int tiles, int tile_w,
                            void* stream) {
    const size_t smem = postings_smem(L, S, tile_w);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            combine_postings, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(tiles, rows < 65535 ? rows : 65535);
    combine_postings<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)ranks, (const int32_t*)bounds, (const int32_t*)prog,
        (uint32_t*)out, (int32_t*)tile_cnt, rows, L, S, tile_w);
    return (int)cudaGetLastError();
}

// words (rows, tiles·tile_w), offsets (rows·tiles,), universe (U,) or
// NULL → keys, and key_ranks unless NULL. Returns cudaGetLastError().
int bits_to_keys_launch(const void* words, const void* offsets,
                        const void* universe, void* keys, void* key_ranks,
                        int rows, int tiles, int tile_w, void* stream) {
    const dim3 grid(tiles, rows < 65535 ? rows : 65535);
    bits_to_keys<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int64_t*)offsets,
        (const int64_t*)universe, (int64_t*)keys, (int32_t*)key_ranks,
        rows, tile_w);
    return (int)cudaGetLastError();
}

}  // extern "C"
