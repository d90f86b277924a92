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

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_STEPS 128

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

}  // extern "C"
