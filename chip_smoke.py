#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

    python3 chip_smoke.py [--docs 250000] [--B 50000] [--seed 0]
                          [--lm-layers 8] [--jamba-layers 8] [--profile]

Builds the CUDA kernels from `src/repro_torch/kernels/*/csrc` (one nvcc
per library, started together) and holds each against its plain PyTorch
version on the card (`edge`: the four bitmap intersect kernels on ragged
shapes, then the key route's `combine_postings` and `bits_to_keys` on
`kernels.intersect.cases`, bit for bit and against NumPy's sets;
`attn_edge`, also with positions per batch row, wrapped rings and
non-causal cross and encoder attention (`kernels.attention.cases`);
`wkv_edge`: the wkv kernels
over S in {1, 37, 128, 2000}, head sizes 32/64/128, bf16 and float32
r/k/v, then the model's decays (with keys held at w = 0 and w = 1) at S
in {1, T-1, T, T+1, 2T+1} for the prefill kernel's chunk T, and a B·H
that overfills one wave, with and without an initial state, out and
final state within 1e-4 of their largest |value|; `scan_edge`: the
unfused selective scan over S in {1, 37, 128, 2000}, N in {4, 8, 16}, D
in {96, 8192}, with and without an initial state, then the fused scan
over the same grid with and without the D skip, in bf16 and float32,
B_ and C_ strided views, dt drawn as the model draws it with keys pushed
into and below the range of denormal exp(dt·A); y and final state within
1e-5 of their largest |value|; `int8_edge`: the int8 decode kernel
against `attention_int8_ref` on `kernels.attention.cases.int8_cases`
(empty slots, an unsorted ring, a window, positions per row, g = 1, 8
and 48, ragged T, a single valid key, every key masked, 48 rows against
20,000 keys), bf16 and float32 queries, by each route that takes the
case (the cluster route where `plan_int8` gives one, the split route
always), within 1e-2 of the output's scale; `attn_bwd_edge`: the
attention backward against `attention_bwd_ref` on `bwd_cases` (causal,
window, positions per row, g = 1, 8 and 48, dh 64 and 128, ragged S, S =
1, several 128-row items with S not a multiple of 64, a window narrower
than a tile, g = 8 at dh 64 with positions per row), dq, dk and dv
within 1e-4 (float32: the FMA route) and 2e-2 (bf16: the tensor-core
route) of their joint scale, each dtype on the route `plan_bwd` names;
also cross attention with S != T and the encoder's non-causal items);
`wkv_bwd_edge` and `scan_bwd_edge`: the wkv and fused scan backwards
against `wkv_bwd_ref` and `selective_scan_fused_bwd_ref` on
`kernels.rwkv.cases` and `kernels.ssm.cases` (initial states and the
final state's gradient, dh 32/64/128, S = 1 and off the chunk, bf16 and
float32, decays held at 0 and 1, strided B_ and C_, D omitted, exp's
denormal range), float32 gradients within 1e-4 of their scale and bf16
ones one rounding more, every third case twice, bit for bit; the scan's
by both routes, from states a forward launch saved and without them,
its launches counted by route exactly).
Then it drives fifteen paths at a real size, each with the launch
counts zeroed just before it and read just after:

- the index query path: an HDFS-shaped log corpus (`--docs` lines) →
  `Builder` → `Searcher` on the card → `query_batch` of 256 queries, top
  10 (half multi-term ANDs, half planner trees with NOT/phrases) under
  `impl="bitmap"`, checked against `impl="sorted"`;
  `IoUSketch.query(impl="bitmap")` on sampled words; and
  `combine_cluster_planned` over 16 groups. All four go through the key
  route (posting ranks in, candidate keys out): exactly one launch per
  combine call (32 for the sketch's words) and none of the bitmap
  kernels. Then one batch traced by torch.profiler and one by cProfile
  (`index_profile`: the card's busy time and idle share, its kernels,
  the host's top functions);
- the serving tier over the same corpus and queries (`serving`): a
  4-shard `ShardedIndex` of all of it and a segmented `Index` of its
  first 50,000 lines plus a committed segment of 10,000 new lines
  and a memory segment of 5,000; `SearchService.search_batch` over the
  segmented index (one AND and one planner launch per unit, equal to
  `impl="sorted"` in refs, texts and stats); 4 client threads through a
  `Frontend` over the cluster (every answer equal to the service's
  sorted one; launches equal to the served micro-batches replayed); the
  fused `ClusterSearcher` (one `combine_cluster_keys` launch a batch,
  its output bit for bit the plain version's on the same inputs) at top
  10 under both budgets (identical, true hits) and at top None
  (equal to the unsharded searcher); none of the bitmap kernels; then
  one fused batch under torch.profiler;
- cluster management on that cluster (`cluster_admin`), on a fresh
  handle: `reshard` to twice the slots, `split` and `replicate` in
  alias mode (each writes only its manifest), `compact`
  of one aliased shard, `append` of 4,000 new lines and
  `collect_garbage(keep=1)` past the grace window; after each, two
  fused batches of one `combine_cluster_keys` launch each (bit for bit
  the plain version on the captured inputs, no other kernel): light
  queries at top None, byte-identical to the untouched cluster through
  `compact` and to the per-shard sorted legs after `append`, and heavy
  ones at top 10 (true hits); GC deletes nothing the kept generation
  reaches, and a reopened handle answers alike;
- RAG serving (`rag`): `granite-20b` at full width (d_model 6144, 48
  query heads on one KV head of 128, d_ff 24576, vocab 49152) cut to
  RAG_LAYERS of its 52 layers, random bf16 weights, `RAGPipeline` over
  a `SearchService` of the serving phase's segmented index: three
  queries, 8 documents and 16 greedy tokens each (exactly 3 · 8 · 17
  attention launches); each shape it launched held to the plain
  attention, and the run's logits to the same model through the plain
  attention, teacher-forced, within 3e-2 of their scale;
- LM serving: `qwen3-32b` at full width (d_model 5120, 64 heads over 8
  KV heads, head size 128, d_ff 25600, vocab 151936) cut to
  `--lm-layers` of its 64 layers, random bf16 weights from a seeded
  `torch.Generator`, `decode_loop` over 4 prompts of 2000 random tokens
  and 32 greedy tokens; then the same prefill + decode with attention
  swapped for its plain version, teacher-forced on the same tokens, must
  give the same logits to 3e-2 of their scale;
- RWKV serving (`rwkv`): `rwkv6-3b` at its published widths and all 32
  layers (d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536), random
  bf16 weights from a seeded `torch.Generator`, `decode_loop` over 4
  prompts of 2000 random tokens and 32 greedy tokens (exactly 32 × 33
  wkv launches); then the same tokens teacher-forced through the plain
  wkv must give the same logits: in float32 to 1e-4 of their scale at 4
  layers and 2e-3 at 32; in bf16, where random weights amplify rounding
  with depth, printed at 4, 8 and 16 layers and bounded at 32 only by
  their scale (`RWKV_CHECKS`);
- Jamba serving (`jamba`): `jamba-v0.1-52b` at its published widths
  (d_model 4096, 32 heads over 8 KV heads of 128, d_ff 14336, 16 experts
  top-2 on every second layer, Mamba d_inner 8192, d_state 16, d_conv 4,
  dt_rank 256, vocab 65536) cut to `--jamba-layers` of its 32 layers (a
  multiple of its period of 8), random bf16 weights from a seeded
  `torch.Generator`, `decode_loop` with the traffic of the LM path
  (exactly 33 fused scan launches per Mamba layer, no unfused one, and
  33 attention launches per attention layer); then the same tokens
  teacher-forced through the plain fused scan: in bf16 printed and
  bounded only by the logits' scale, in float32 (2 prompts of 512
  tokens, 8 forced steps) within 1e-4 of it;
- Mixtral serving (`mixtral`): `mixtral-8x22b` at its published widths
  (d_model 6144, 48 heads over 8 KV heads of 128, d_ff 16384, 8 experts
  top-2 in every layer, vocab 32768, a sliding window of 4096) cut to
  MIXTRAL_LAYERS of its 56 layers, `decode_loop` over 2 prompts of 5000
  tokens (the window masks in prefill) and 32 greedy tokens; then the
  ring: the prompt's last 4096 positions laid into a `cache_desc` cache
  of 4096 slots at slot pos % 4096 decode the same tokens, teacher-
  forced, to the full cache's logits within 3e-2 of their scale;
- VLM serving (`vlm`): `qwen2-vl-72b` at its published widths (d_model
  8192, 64 heads over 8 KV heads of 128, QKV bias, d_ff 29568, vocab
  152064, M-RoPE sections (16, 24, 24)) cut to VLM_LAYERS of its 80,
  4 rows of 500 image patches on four other grids and 1500 text tokens
  at Qwen2-VL's position ids (so each row's query positions differ),
  then 32 greedy tokens with (B, 1, 3) ids;
- encoder-decoder serving (`encdec`): `seamless-m4t-medium`, all 12 + 12
  layers (d_model 1024, 16 heads of 64, d_ff 4096, vocab 256206), 4
  utterances of 4096 encoder frames, a 32-token decoder prompt, 32
  greedy tokens: bidirectional encoder attention, causal decoder
  self-attention and cross-attention (the split-KV decode kernel, non-
  causal, at S = 32 and S = 1).
Each of the three: exact attention launch counts, each launched shape
against the plain attention, and the logits through the kernel against
the same model through the plain attention, teacher-forced, within 3e-2
of their scale;
- int8 decode (`lm_int8`): `qwen3-32b` as the opt decode variant gives it
  (`launch.steps.apply_variant(..., "decode_32k", "opt")`: the int8 KV
  cache) at the `lm` path's depth and traffic: exactly one bf16 prefill
  and 32 int8 decode launches a layer, every one on the cluster route;
  logits vs the plain int8
  attention within 3e-2 and vs the bf16 cache within 0.1 of their scale
  (the JAX package's own bound), decode ms a token, cache bytes;
- training (`train`): `launch/train.py`'s flow on `qwen3-32b` at its
  published widths cut to 4 of 64 layers (3.51 B parameters): the logs
  index, its keyword-filtered `IndexedCorpusLoader` (2 × 4096 tokens),
  20 steps of `training.run` (AdamW, async checkpoints every 10 steps
  into host memory): exactly 2 forward (one the remat's recompute) and 1
  backward attention launch a layer and step, every backward launch on
  the tensor-core route (`BWD_ROUTES`), the loss falling; a fresh
  run from other weights resumes from the step-10 checkpoint and must
  give steps 11-20's losses bit for bit; one step's loss and gradients
  through the backward kernel vs plain autograd on a 1-layer cut;
- training RWKV-6, Jamba and the encoder-decoder (`train_rwkv`,
  `train_jamba`, `train_encdec`), the same flow for 8 steps with
  checkpoints every 4 and a resume from step 4 (bit for bit): `rwkv6-3b`
  at its published widths, 8 of 32 layers (2 wkv and 1 `wkv_bwd` launch
  a layer and step); `jamba-v0.1-52b` at its published widths as one
  period of 8 layers without experts (2 fused scan and 1 backward launch
  a Mamba layer and step, the backward reading the states the forward
  saved; 2 attention and 1 `flash_bwd`); and
  `seamless-m4t-medium` whole with seeded frames of 4096 a row (2 forward
  and 1 backward launch for each of its 36 attentions a step, all on the
  tensor cores); each with a gradient check through the kernels vs
  plain autograd through the plain versions on a cut (1 layer; the same
  period on 512 tokens; 1 + 1 layers);
- sharding on the card (`sharded`): a DeviceMesh ("data", "model") =
  (1, 1) over an NCCL group of one rank, formed once after the build.
  `train`, `train_jamba` and `train_rwkv` each restore their own
  mid-run checkpoint onto it (`launch.elastic.reshard_restore`, the
  `baseline` rules) and take 3, 2 and 2 steps through
  `launch.steps.make_train_step(cfg, mesh=)` on the batches their
  unsharded run took there, every kernel (flash attention and
  `flash_bwd`, the fused scan and its backward, wkv and its backward)
  on the rank's shards through `local_map`, exactly as often as
  unsharded; the losses against the unsharded run's (bit for bit
  expected, within 1e-6). The `lm` path's model and weights take a
  sharded prefill and 4 teacher-forced decode steps
  (`make_prefill_step`/`make_decode_step(cfg, mesh=)`) beside the same
  unsharded: one attention launch a layer and step, the logits within
  1e-5 of their scale (bit for bit expected);
- the roofline (`roofline`): the `lm` path's prefill and one decode step
  and one more step of the `train` path, each run once on the card under
  the port's counter (`launch.hlo_cost.analyze_step`) and once on meta
  tensors of the same shapes in the same process: the FLOPs and each
  kernel's launches, flops and bytes (`launch.roofline`'s formulas) must
  be equal, the aten ops' bytes within 1%. The line gives each step's
  counted FLOPs and bytes, the step time its path measured outside the
  counter, `mfu` = FLOPs / (time × 989 TFLOP/s) and the roofline
  fraction and bottleneck of `launch.roofline` on one card.

Last, each kernel is timed at the shapes its path gave it (attention
also at the windowed prefill, the per-row-position prefill beside the
shared arange at its shape, the encoder's prefill and the cross-
attention; median of
CUDA-event timings, L2 flushed before each; the key route's kernels on
the main path's own inputs, with the host's plan, the H2D and D2H
copies and the universe's sort timed beside them, and the bitmap kernel
each route replaced at the same (rows, L, W); the wkv kernels also by the
profiler's device time, the kernel alone) beside the plain version, one
PyTorch library call where there is one, and the least time the card
needs for the same work; the int8 decode kernel at decode_32k's shape
(B 128, T 32768) by both routes beside the bf16 decode kernel and SDPA
on the same cache in bf16, and at the `lm_int8` path's own shape; the
attention backward at the train path's shape on both
routes (the tensor-core one with the forward's log-sum-exp, the FMA one
recomputing it) beside SDPA's backward alone and its forward and
backward through autograd, and the forward there with and without the
log-sum-exp write; both scan kernels, the fused one at the Jamba
path's shapes and the unfused one at the same (B, S, D, N), also by the
profiler's device time; the wkv and fused scan backwards at their
training paths' shapes, (2, 4096, 40, 64) and (2, 4096, 8192, 16) bf16,
with the profiler's device time of each of their kernels, beside their
plain versions, the forward kernel at the same shape as the training
path runs it (the fused scan's saving its states) and the two together.

Every phase prints one JSON line; any failure raises and the script
exits nonzero. The last lines are the kernels line, the card's name and
power limit from nvidia-smi, and `{"ok": true, "device": {...}}`.
Without a CUDA card, or without the repo's `src/` beside it, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
SRC = ROOT / "src"

# The H100's published peaks and the model kernels' cost formulas are
# the port's (`repro_torch.launch.roofline`): the bounds below turn its
# (flops, bytes) into ms. main() puts src/ on the path before any phase.

# The main path's traffic: QUERIES queries with top TOP_K, half of them
# planner trees, of which GROUPS groups of PER go to combine_cluster.
QUERIES, TOP_K = 256, 10
GROUPS, PER = 16, 8
assert QUERIES // 2 == GROUPS * PER

# The serving tier over the main path's corpus: a cluster of
# SERVING_SHARDS shards over all of it; a segmented index of its first
# SEG_BASE lines (a second whole-corpus build and sorted batch put the
# script 116-170 s over its time before the serving phase)
# plus SEG_APPEND new lines committed and SEG_ADD more in a memory
# segment; FE_CLIENTS client threads through the frontend,
# micro-batches of at most FE_MAX_BATCH. The fused cluster builds a
# DocRef and a priority for every candidate on the host, so its top-K
# drive takes the main path's queries in order of their unsharded
# candidate count while their total stays within FUSED_CANDIDATES (at
# 1M lines the queries split into about half with at most a few
# hundred candidates and half with about 140,000, at 250k lines a
# quarter of that: all of the first and a few of the second); its
# top-None drive takes the queries whose unsharded result has at most
# FUSED_FULL_MAX candidates. PR 28 cut this host-bound depth (`--docs`,
# SEG_*, FUSED_CANDIDATES, ADMIN_*, the alias changes) to keep the
# script inside its time with the `sharded` phase (PERF.md §4).
SERVING_SHARDS = 4
SEG_BASE, SEG_APPEND, SEG_ADD = 50_000, 10_000, 5_000
FE_CLIENTS, FE_MAX_BATCH = 4, 64
FUSED_CANDIDATES = 250_000
FUSED_FULL_MAX = 1000

REPLACES = {
    "intersect": "src/repro/kernels/intersect/kernel.py:66",
    "intersect_batch": "src/repro/kernels/intersect/kernel.py:221",
    "combine_batch": "src/repro/kernels/intersect/kernel.py:128",
    "combine_cluster": "src/repro/kernels/intersect/kernel.py:185",
}
SOURCE = "src/repro_torch/kernels/intersect/csrc/intersect.cu"
# The index path's key route, by the bitmap entry point it took over from
# (the route counted in LAUNCHES) and that entry's bitmap kernel
KEY_ROUTES = {"intersect": "intersect_keys",
              "intersect_batch": "intersect_batch_keys",
              "combine_batch": "combine_batch_keys",
              "combine_cluster": "combine_cluster_keys"}
BITMAP_KERNEL = {"intersect": "and_popcount",
                 "intersect_batch": "and_popcount",
                 "combine_batch": "combine_program",
                 "combine_cluster": "combine_program"}

# RWKV serving: the same traffic as the LM path, all 32 layers. The model
# through the kernel is held to the same model through the plain wkv,
# teacher-forced, at each (dtype, layers, bound) of RWKV_CHECKS: the
# largest logit difference over the largest |logit| must stay within the
# bound (None: printed only; layers 0: the configuration's full depth).
# With random weights a one-ulp bf16 rounding of the wkv output grows
# 2.4-4x with each doubling of depth, to half the logits' scale at 32
# layers (PERF.md, section 6). So at full depth bf16 only shows both runs
# finite and of one scale (RWKV_BF16_TOL); the float32 runs, whose
# roundings are 2^16 times smaller, hold the kernel to 1e-4 at 4 layers
# and to 2e-3 at 32.
RWKV_ARCH = "rwkv6-3b"
RWKV_BF16_TOL = 1.0
RWKV_CHECKS = (("bfloat16", 0, RWKV_BF16_TOL), ("bfloat16", 4, None),
               ("bfloat16", 8, None), ("bfloat16", 16, None),
               ("float32", 4, 1e-4), ("float32", 0, 2e-3))
WKV_TOL = 1e-4                    # of the largest |value|, out and state
WKV_SOURCE = "src/repro_torch/kernels/rwkv/csrc/wkv.cu"
WKV_REPLACES = "src/repro/kernels/rwkv/kernel.py:50"

# Jamba serving: the traffic of the LM path through `--jamba-layers` of
# jamba-v0.1-52b's 32 layers. The model through the scan kernel is held
# to the same model through the plain scan, teacher-forced. The two
# differ only in the order of the scan's 16-term sums of y; in bf16 such
# a difference flips a rounding here and there, which random weights
# grow with depth (PERF.md, section 6) and which may also flip a top-2
# routing or a capacity decision of the MoE, so bf16 is printed and
# bounded only by the logits' scale; float32, whose roundings are 2^16
# times finer, on 2 prompts of 512 tokens and 8 forced steps, within
# JAMBA_F32_TOL. Each scan kernel alone against its plain version: y and
# the final state within SCAN_TOL of their scale, the order of the sums
# of y being the only difference (the state's update, and in the fused
# kernel exp(dt·A) and dt·B_·x, round as the plain version does). The
# path's attention kernel is held to the plain attention at each shape
# the path launched, within ATTN_TOL.
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_BF16_TOL = 1.0
JAMBA_F32_TOL = 1e-4
JAMBA_F32_BATCH, JAMBA_F32_PROMPT, JAMBA_F32_TOKENS = 2, 512, 8
SCAN_TOL = 1e-5
SCAN_SOURCE = "src/repro_torch/kernels/ssm/csrc/selective_scan.cu"
SCAN_REPLACES = "src/repro/kernels/ssm/kernel.py:46"

# LM serving: 4 prompts of 2000 tokens (deliberately not a multiple of
# the kernel's tiles), 32 greedy tokens, logits held to LM_TOL of their
# scale between the kernel and the plain attention (see PERF.md)
LM_ARCH, LM_BATCH, LM_PROMPT, LM_TOKENS = "qwen3-32b", 4, 2000, 32
LM_TOL = 3e-2
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_SOURCE = "src/repro_torch/kernels/attention/csrc/attention.cu"
ATTN_REPLACES = "src/repro/kernels/attention/kernel.py:63"

# Mixtral serving: mixtral-8x22b at its published widths cut to
# MIXTRAL_LAYERS of its 56 layers (about 10.4 B parameters, 20.8 GB bf16),
# MIXTRAL_BATCH prompts of MIXTRAL_PROMPT tokens, past its window of 4096
# so that the window masks in prefill, and LM_TOKENS greedy tokens
MIXTRAL_ARCH, MIXTRAL_LAYERS = "mixtral-8x22b", 4
MIXTRAL_BATCH, MIXTRAL_PROMPT = 2, 5000
# VLM serving: qwen2-vl-72b at its published widths cut to VLM_LAYERS of
# its 80 (about 9.5 B parameters); one row a grid of VLM_GRIDS, each
# 500 image patches (the JAX package's VLM_PATCH_FRAC of 0.25 of
# VLM_SEQ positions) and then text, so that the rows' text positions,
# and their queries' positions, differ
VLM_ARCH, VLM_LAYERS, VLM_SEQ = "qwen2-vl-72b", 8, 2000
VLM_GRIDS = ((20, 25), (25, 20), (10, 50), (50, 10))
# Encoder-decoder serving: seamless-m4t-medium, all 12 + 12 layers;
# ENCDEC_BATCH utterances of the config's ENC_FRAMES frames, a decoder
# prompt of ENCDEC_PROMPT tokens, LM_TOKENS greedy tokens
ENCDEC_ARCH, ENCDEC_BATCH, ENCDEC_PROMPT = "seamless-m4t-medium", 4, 32


# Cluster management on the serving phase's cluster (`cluster_admin`):
# ADMIN_LIGHT light queries at top None and, at top TOP_K, ADMIN_HEAVY
# heavy queries beside ADMIN_TOPK_LIGHT light ones, all from the fused
# drive's queries, after each membership change; ADMIN_SHARD is the
# shard replicated and compacted; ADMIN_APPEND new lines are appended.
ADMIN_LIGHT, ADMIN_TOPK_LIGHT, ADMIN_HEAVY = 16, 8, 1
ADMIN_SHARD, ADMIN_APPEND = 0, 4000

# RAG serving: granite-20b (MQA, 48 query heads on one KV head) at its
# published widths cut to RAG_LAYERS of its 52 layers, retrieving
# RAG_DOCS log lines (a prompt of about 100 tokens) for each of
# RAG_QUERIES from the serving phase's segmented index and decoding
# RAG_TOKENS greedy tokens
RAG_ARCH, RAG_LAYERS, RAG_TOKENS, RAG_DOCS = "granite-20b", 8, 16, 8
RAG_QUERIES = ("error fetch", "received AND exception",
               "stored OR terminating")


# int8 decode (`lm_int8`): qwen3-32b as the opt decode variant gives it
# (`apply_variant(..., "decode_32k", "opt")`: the int8 KV cache) at the
# `lm` path's depth and traffic. Kernel vs plain within INT8_TOL of the
# output's scale: one step of a quantized probability (up to 1/127 of
# it), and in bf16 one rounding of the output (2^-8) more; the path's logits
# vs the plain int8 attention within LM_TOL; vs the bf16 cache's logits
# within INT8_VS_BF16_TOL of their scale, the JAX package's own bound
# (tests/test_opt_variants.py).
INT8_TOL = {"float32": 1e-2, "bfloat16": 2e-2}
INT8_VS_BF16_TOL = 0.1
INT8_SOURCE = "src/repro_torch/kernels/attention/csrc/decode_int8.cu"
# the backward's two routes (kernels.attention.plan_bwd): bf16 at dh 64
# and 128 on the tensor cores (the train path's), float32 and dh 32 on FMAs
BWD_SOURCE = "src/repro_torch/kernels/attention/csrc/attention_bwd_tc.cu"
BWD_FMA_SOURCE = "src/repro_torch/kernels/attention/csrc/attention_bwd.cu"
PORT_ONLY = "none: port only (the JAX package computes it with XLA, {})"
# the attention backward vs its plain version, of the gradients' joint
# scale: float32 sums in another order; bf16 one rounding of each output
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Training (`train`): launch/train.py's flow on qwen3-32b at its published
# widths cut to TRAIN_LAYERS of 64 (3.51 B parameters; bf16 weights and
# gradients and float32 moments, about 42 GB), TRAIN_BATCH rows of
# train_4k's TRAIN_SEQ tokens from the logs index's keyword-filtered
# loader, TRAIN_STEPS steps, async checkpoints every TRAIN_CKPT_EVERY
# into host memory; then a fresh run resumes from the step-10 checkpoint.
# One step's loss and gradients through flash_bwd vs plain autograd on a
# GRAD_CHECK_LAYERS-layer cut (the plain (B, H, S, S) scores of more
# layers do not fit beside it): the loss within GRAD_LOSS_TOL and each
# leaf's ||g_kernel - g_plain|| within GRAD_LEAF_TOL of ||g_plain|| (bf16
# weights and activations; the two attentions round at other places).
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "qwen3-32b", 4, 2, 4096
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_QUERY, TRAIN_LR = 20, 10, "block", 3e-4
GRAD_CHECK_LAYERS, GRAD_LOSS_TOL, GRAD_LEAF_TOL = 1, 1e-2, 5e-2
# Training RWKV-6, Jamba and the encoder-decoder (`train_rwkv`,
# `train_jamba`, `train_encdec`): the `train` flow at published widths,
# TRAIN_BATCH × TRAIN_SEQ tokens, TRAIN_NEW_STEPS steps with checkpoints
# every TRAIN_NEW_CKPT and a resume from the middle one; rwkv6-3b cut to
# RWKV_TRAIN_LAYERS of 32 (about 1.0 B parameters, 12 GB with float32
# moments); jamba-v0.1-52b as one period of 8 layers without experts
# (about 2.7 B parameters, 33 GB), its gradient check on JAMBA_GRAD_SEQ
# tokens; seamless-m4t-medium whole with seeded frames of
# ENCDEC_TRAIN_FRAMES. The backward kernels vs their plain versions
# within each case module's BWD_TOL of each output's scale.
TRAIN_NEW_STEPS, TRAIN_NEW_CKPT = 8, 4
RWKV_TRAIN_LAYERS, JAMBA_GRAD_SEQ, ENCDEC_TRAIN_FRAMES = 8, 512, 4096
WKV_BWD_SOURCE = "src/repro_torch/kernels/rwkv/csrc/wkv_bwd.cu"
SCAN_BWD_SOURCE = "src/repro_torch/kernels/ssm/csrc/selective_scan_bwd.cu"
# Sharding on the card (`sharded`): one DeviceMesh ("data", "model") =
# (1, 1) over an NCCL group of one rank, formed once in `main` (no
# fallback). Each training path's run restores its own step-`every`
# checkpoint onto the mesh (`launch.elastic.reshard_restore`, the
# `baseline` rules) and takes SHARD_STEPS[path] steps through
# `launch.steps.make_train_step(cfg, mesh=)` on the batches its
# unsharded run took there; the `lm` path's model takes a sharded prefill
# and SHARD_DECODE teacher-forced decode steps beside the same unsharded.
# On one rank every collective is the identity and each kernel sees the
# whole tensors, so bit for bit is expected; held within SHARD_LOSS_TOL
# (losses, relative) and SHARD_LOGIT_TOL (logits, of their scale).
SHARD_STEPS = {"train": 3, "train_jamba": 2, "train_rwkv": 2}
SHARD_DECODE, SHARD_LOSS_TOL, SHARD_LOGIT_TOL = 4, 1e-6, 1e-5
SHARD = {}                             # "mesh": the (1, 1) DeviceMesh


def scan_fwd_bwd(*args):
    """The fused scan's backward from the states of a forward launch
    that writes them, as `ops._ScanFused` runs the two: one launch of
    each kernel."""
    from repro_torch.kernels import ssm as ts
    states = ts.selective_scan_fused_cuda(*args[:7], states=True)[2]
    return ts.selective_scan_fused_bwd_cuda(*args, states)


def emit(obj) -> None:
    """One JSON line; a phase's line also gets `t_s`, the seconds since
    the script started, so that a run's time can be split by phase."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    """`name, power.limit` of card 0, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


# ------------------------------------------------------------ inputs
def random_bitmaps(rng, shape) -> "np.ndarray":
    import numpy as np
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def random_programs(rng, rows: int, L: int, S: int,
                    n_real: int | None = None) -> list[list[tuple]]:
    """Well-formed programs of up to S steps (ANDNOT-rich); `n_real`
    caps the real steps so `pack_programs` pads the rest with the
    chained identity."""
    progs = []
    for _ in range(rows):
        n = S if n_real is None else min(S, int(rng.integers(0, n_real + 1)))
        steps = []
        for s in range(n):
            op = int(rng.integers(0, 3))
            a = L + s - 1 if s else int(rng.integers(0, L))
            steps.append((op, a, int(rng.integers(0, L + s))))
        progs.append(steps)
    return progs


# --------------------------------------------------------- comparisons
def compare(name: str, got, want) -> int:
    """Kernel vs plain (bitmaps, counts) on the card: bit-exact or raise.
    Returns the largest absolute difference (0)."""
    import torch
    (out_k, cnt_k), (out_p, cnt_p) = got, want
    torch.cuda.synchronize()
    if out_k.shape != out_p.shape or cnt_k.shape != cnt_p.shape:
        raise AssertionError(f"{name}: shapes {tuple(out_k.shape)}/"
                             f"{tuple(cnt_k.shape)} vs {tuple(out_p.shape)}/"
                             f"{tuple(cnt_p.shape)}")
    words = (out_k.to(torch.int64) & 0xFFFFFFFF) \
        - (out_p.to(torch.int64) & 0xFFFFFFFF)
    err = max(int(words.abs().max()) if words.numel() else 0,
              int((cnt_k - cnt_p).abs().max()) if cnt_k.numel() else 0)
    if err:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (max abs err {err})")
    return err


def call_pair(tx, name: str, inputs: tuple, device):
    fn = getattr(tx, name)
    return fn(*inputs, device=device), fn(*inputs, impl="ref", device=device)


def edge_phase(tx, device, rng) -> dict[str, int]:
    """Small ragged shapes: W=1, W not a multiple of 32 or of the block,
    one layer, ANDNOT programs and chained-identity padding."""
    errs = dict.fromkeys(REPLACES, 0)
    cases = 0
    for L, W in ((1, 1), (2, 1), (3, 7), (1, 33), (4, 255), (2, 257),
                 (5, 1000)):
        bm = random_bitmaps(rng, (4, 3, L, W))
        bm[0, 0, -1] = 0xFFFFFFFF              # an all-ones padding layer
        prog = tx.pack_cluster_programs(
            [random_programs(rng, 3, L, 4, n_real=3) for _ in range(4)], L)
        for name, inputs in (("intersect", (bm[0, 0],)),
                             ("intersect_batch", (bm[0],)),
                             ("combine_batch", (bm[0], prog[0])),
                             ("combine_cluster", (bm, prog))):
            got, want = call_pair(tx, name, inputs, device)
            errs[name] = max(errs[name], compare(name, got, want))
            cases += 1
    # a one-step ANDNOT program and the empty program (identity padding)
    bm = random_bitmaps(rng, (2, 2, 40))
    prog = tx.pack_programs([[(tx.OP_ANDNOT, 0, 1)], []], 2)
    got, want = call_pair(tx, "combine_batch", (bm, prog), device)
    errs["combine_batch"] = max(errs["combine_batch"],
                                compare("combine_batch", got, want))
    expect = (bm[0, 0] & ~bm[0, 1], bm[1, 0])
    for q in range(2):
        if not (tx.to_numpy(got[0][q]) == expect[q]).all():
            raise AssertionError("combine_batch: ANDNOT/identity program "
                                 "differs from NumPy")
    fused = fused_edge(tx, device)
    errs.update(dict.fromkeys(KEY_ROUTES.values(), 0))
    emit({"phase": "edge", "cases": cases + 1, "bit_exact": True,
          "fused_cases": fused, "fused_bit_exact": True})
    return errs


def fused_check(tx, name: str, rows, progs, n_docs, device) -> None:
    """The key route on the card against its plain version, bit for bit:
    the entry point's keys and counts, and kernel by kernel on the same
    plan (result words, tile counts, keys and their ranks); then the
    keys against NumPy sets and, for programs, the lengths recovered on
    the card against the planner's host rule (`cases.numpy_sets`,
    `cases.host_lengths`). Raises on any difference."""
    import numpy as np
    import torch
    from repro_torch.kernels.intersect import ops as txo
    from repro_torch.kernels.intersect.cases import host_lengths, numpy_sets

    def route(**kw):
        if progs is None:
            return tx.intersect_keys(rows, n_docs=n_docs, **kw)
        return tx.combine_keys(rows, progs, **kw)
    got, want = route(device=device), route(impl="ref", device=device)
    plan = txo.plan_keys(rows, progs, n_docs, device)
    kern = txo.keys_kernels(plan, ranks=True)
    plain = txo.keys_plain(plan, ranks=True)
    torch.cuda.synchronize()
    for what, a, b in (("keys", got[0], want[0]),
                       ("counts", got[1], want[1]),
                       ("result words", kern[0], plain[0]),
                       ("tile counts", kern[1], plain[1]),
                       ("bits_to_keys keys", kern[2], plain[2]),
                       ("bits_to_keys ranks", kern[3], plain[3])):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} of the kernels differ "
                                 "from the plain version")
    found = tx.keys_per_row(*got)
    for q, (keys, expect) in enumerate(zip(found, numpy_sets(rows, progs))):
        if not np.array_equal(keys, expect):
            raise AssertionError(f"{name}: row {q}'s keys differ from "
                                 "NumPy's sets")
    if progs is None:
        return
    # document lengths recovered on the card: the last leaf holding a
    # key gives its length (lengths differ between leaves here)
    rng = np.random.default_rng(len(name))
    lengths = [[rng.integers(1, 2**40, len(a), dtype=np.uint64)
                for a in row] for row in rows]
    keys, counts, key_len = tx.combine_keys(rows, progs, device=device,
                                            lengths=lengths)
    for q, got_len in enumerate(tx.keys_per_row(key_len, counts)):
        if not np.array_equal(got_len, host_lengths(found[q], rows[q],
                                                    lengths[q])):
            raise AssertionError(f"{name}: row {q}'s lengths differ from "
                                 "the planner's host rule")


def fused_edge(tx, device) -> int:
    """The key route's kernels on `kernels.intersect.cases`: an empty
    leaf, universes of 1, 31, 32, 33 and one tile ± 1 keys, one tile
    filled, most tiles empty, ANDNOT and identity-padded programs, keys
    just below 2**63. Returns the number of cases."""
    from repro_torch.kernels.intersect.cases import EDGE_CASES, edge_case
    for name in EDGE_CASES:
        fused_check(tx, name, *edge_case(name), device)
    return len(EDGE_CASES)


# ----------------------------------------------------------- main path
def make_queries(docs: list[str], n: int, seed: int, parse_words):
    """n/2 multi-term ANDs (→ intersect_batch) and n/2 planner trees
    with NOT / phrases (→ combine_batch), words drawn from the corpus."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ands: list[str] = []
    planned: list[str] = []
    while len(ands) < n // 2 or len(planned) < n - n // 2:
        toks = parse_words(docs[int(rng.integers(len(docs)))])
        words = list(dict.fromkeys(toks))
        other = parse_words(docs[int(rng.integers(len(docs)))])
        if len(words) < 4:
            continue
        a, b, c = (words[int(i)] for i in
                   rng.choice(len(words), 3, replace=False))
        x = other[int(rng.integers(len(other)))]
        i = int(rng.integers(len(toks) - 1))
        if toks[i] == toks[i + 1]:
            continue
        if len(ands) < n // 2:
            ands.append(f"{a} AND {b}" if len(ands) % 2 else
                        f"{a} AND {b} AND {c}")
        if len(planned) < n - n // 2 and x not in (a, b, c):
            shape = len(planned) % 4
            planned.append([
                f'"{toks[i]} {toks[i + 1]}"',
                f"{a} AND {b} AND NOT {x}",
                f"({a} OR {x}) AND NOT {c}",
                f'"{toks[i]} {toks[i + 1]}" OR ({a} AND {x})',
            ][shape])
    return ands, planned


def main_phase(args, device) -> dict:
    import numpy as np
    import torch
    from collections import Counter

    from repro_torch.core.optimizer import InfeasibleSketchError
    from repro_torch.core.sketch import IoUSketch, SketchSpec
    from repro_torch.core.hashing import word_fingerprint
    from repro_torch.data import make_logs_like, parse_words, write_corpus
    from repro_torch.index import Builder, BuilderConfig, Searcher, parse
    from repro_torch.index import planner as tp
    from repro_torch.index.searcher import lookup_units
    from repro_torch.kernels import intersect as tx
    from repro_torch.storage import (InMemoryBlobStore, SimCloudStore,
                                     SimCloudTransport)

    t0 = time.perf_counter()
    docs = make_logs_like(args.docs, seed=args.seed)
    store = InMemoryBlobStore()
    corpus = write_corpus(store, "corpus/hdfs", docs, n_blobs=16)
    gen_s = time.perf_counter() - t0

    B = args.B
    t0 = time.perf_counter()
    while True:
        try:
            report = Builder(BuilderConfig(B=B, F0=1.0)).build(
                corpus, store, "index/hdfs")
            break
        except InfeasibleSketchError:
            B *= 2
    build_s = time.perf_counter() - t0
    emit({"phase": "build_index", "docs": args.docs, "B": B,
          "B_raised": B != args.B, "L": report.L,
          "index_bytes": report.index_bytes, "generate_s": gen_s,
          "build_s": build_s})

    # in-memory sketch of the same corpus for IoUSketch.query
    t0 = time.perf_counter()
    _profile, postings = Builder().profile(corpus)
    n_common = int(0.01 * B)
    common = [w for w, _ in Counter(
        {w: len(d) for w, d in postings.items()}).most_common(n_common)]
    sketch = IoUSketch.build(postings, SketchSpec(
        B=B, L=report.L, n_common=len(common), seed=args.seed),
        common_words=common)
    rng = np.random.default_rng(args.seed)
    hashed = [w for w in postings if not sketch.is_common(w)]
    sample = [hashed[int(i)] for i in rng.choice(len(hashed), 32,
                                                 replace=False)]
    sketch_s = time.perf_counter() - t0
    del postings

    ands, planned = make_queries(docs, QUERIES, args.seed, parse_words)
    queries = [parse(t) for t in ands + planned]

    def searcher():
        return Searcher(SimCloudTransport(SimCloudStore(store,
                                                        seed=args.seed)),
                        "index/hdfs", device=device)

    s_bitmap, s_sorted, s_plan = searcher(), searcher(), searcher()
    jobs = [j for j in tp.plan_batch([parse(t) for t in planned],
                                     units=(s_plan,)) if j.plan is not None]
    G, per = GROUPS, PER
    if len(jobs) < G * per:
        raise AssertionError(f"only {len(jobs)} planner jobs")
    jobs = jobs[:G * per]
    outs, _ = lookup_units([s_plan], [j.lookup_q for j in jobs],
                           s_plan._fetcher)
    plans = [[j.plan for j in jobs[g * per:(g + 1) * per]]
             for g in range(G)]
    words = [outs[0][g * per:(g + 1) * per] for g in range(G)]

    def is_common(w):
        return word_fingerprint(w) in s_plan.common

    # ---- the main path: counts zeroed before, read after -------------
    captured, release = capture_key_calls(tx)
    tx.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res_bitmap = s_bitmap.query_batch(queries, top_k=TOP_K)
    torch.cuda.synchronize()
    bitmap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sketch_bitmap = [sketch.query(w, impl="bitmap", n_docs=args.docs,
                                  device=device) for w in sample]
    torch.cuda.synchronize()
    sketch_bitmap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cluster, counts = tp.combine_cluster_planned(
        plans, words, [is_common] * G, device=device)
    torch.cuda.synchronize()
    cluster_s = time.perf_counter() - t0
    launches = dict(tx.LAUNCHES)
    shapes = dict(tx.LAST_SHAPE)
    peak_bytes = torch.cuda.max_memory_allocated()
    release()
    # -------------------------------------------------------------------

    # every route through the key kernels, as often as the path calls it;
    # the bitmap kernels not at all
    expect = {"intersect_keys": len(sample), "intersect_batch_keys": 1,
              "combine_batch_keys": 1, "combine_cluster_keys": 1}
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"main path launched the key route "
                             f"{ {k: launches[k] for k in expect} }, "
                             f"expected {expect}")
    bitmap = {k: launches[k] for k in KEY_ROUTES if launches[k]}
    if bitmap:
        raise AssertionError(f"main path launched bitmap kernels {bitmap}")

    t0 = time.perf_counter()
    res_sorted = s_sorted.query_batch(queries, top_k=TOP_K, impl="sorted")
    sorted_s = time.perf_counter() - t0
    for q, (a, b) in enumerate(zip(res_bitmap, res_sorted)):
        if a.refs != b.refs or a.texts != b.texts or a.stats != b.stats:
            raise AssertionError(f"query {q} ({(ands + planned)[q]!r}): "
                                 "bitmap on the card != sorted")
    if sum(bool(r.refs) for r in res_bitmap) < len(queries) // 2:
        raise AssertionError("fewer than half the queries found documents")

    for w, got in zip(sample, sketch_bitmap):
        if not np.array_equal(got, sketch.query(w, impl="sorted")):
            raise AssertionError(f"IoUSketch.query({w!r}) bitmap != sorted")

    cpu, cpu_counts = tp.combine_cluster_planned(
        plans, words, [is_common] * G, device="cpu")
    if not np.array_equal(counts, cpu_counts):
        raise AssertionError("combine_cluster_planned counts: card != cpu")
    for g in range(G):
        plain = tp.combine_planned(plans[g], words[g], is_common,
                                   impl="sorted")
        for q in range(per):
            for got, c, p in zip(cluster[g][q], cpu[g][q], plain[q]):
                if not (np.array_equal(got, c) and np.array_equal(got, p)):
                    raise AssertionError(f"combine_cluster_planned group "
                                         f"{g} query {q} differs")

    index_profile(searcher, queries, TOP_K)
    if args.profile:
        for impl in ("bitmap", "sorted"):
            host_profile(searcher(), queries, TOP_K, impl)

    emit({"phase": "main", "queries": len(queries), "ands": len(ands),
          "planned": len(planned), "top_k": TOP_K,
          "with_results": sum(bool(r.refs) for r in res_bitmap),
          "identical_to_sorted": True,
          "batch_wall_s": {"bitmap_cuda": bitmap_s, "sorted": sorted_s},
          "sketch_words": len(sample), "sketch_build_s": sketch_s,
          "sketch_bitmap_s": sketch_bitmap_s,
          "cluster": {"G": G, "Q": per, "wall_s": cluster_s,
                      "candidates": int(counts.sum())},
          "launches": launches, "shapes": shapes,
          "peak_device_bytes": peak_bytes})
    return {"launches": launches, "shapes": shapes, "captured": captured,
            "store": store, "corpus": corpus, "B": B, "searcher": searcher,
            "queries": queries, "query_texts": ands + planned,
            "res_sorted": res_sorted}


def capture_key_calls(tx, outputs: dict | None = None):
    """Wrap the key route's entry points so that each route keeps the
    inputs of its latest call, to time its kernels on the main path's
    own data (and, given `outputs`, what that call returned, to hold it
    to the plain version). Returns (captured, release); `release()`
    unwraps."""
    captured: dict[str, tuple] = {}
    intersect_keys, combine_keys = tx.intersect_keys, tx.combine_keys

    def wrapped_intersect(rows, n_docs=None, **kw):
        route = "intersect" if n_docs is not None else "intersect_batch"
        captured[route] = (rows, None, n_docs, None, None)
        got = intersect_keys(rows, n_docs=n_docs, **kw)
        if outputs is not None:
            outputs[route] = got
        return got

    def wrapped_combine(rows, programs, groups=None, lengths=None, **kw):
        route = "combine_cluster" if groups is not None else "combine_batch"
        captured[route] = (rows, programs, None, groups, lengths)
        got = combine_keys(rows, programs, groups=groups, lengths=lengths,
                           **kw)
        if outputs is not None:
            outputs[route] = got
        return got

    def release():
        tx.intersect_keys, tx.combine_keys = intersect_keys, combine_keys
    tx.intersect_keys, tx.combine_keys = wrapped_intersect, wrapped_combine
    return captured, release


def index_profile(searcher, queries, top_k: int) -> None:
    """One `query_batch` on the card under torch.profiler (the card's busy
    time and idle share against the host's wall, the kernels that take
    it), then one under cProfile (the host's top functions)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    s = searcher()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.query_batch(queries, top_k=top_k)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, events, by_name = _device_time(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    host = host_profile(searcher(), queries, top_k, "bitmap", n=10,
                        show=False)
    emit({"phase": "index_profile", "queries": len(queries),
          "host_wall_us": wall_us, "device_busy_us": busy_us,
          "device_idle_share": 1 - busy_us / wall_us if events else None,
          "device_events": events,
          "top_kernels_us": [[name[:90], us, n] for name, (us, n) in top],
          "host_profile_total_s": host["total_s"],
          "host_top_own_s": host["top_own_s"]})


def host_profile(searcher, queries, top_k: int, impl: str,
                 n: int = 15, show: bool = True) -> dict:
    """cProfile one `query_batch`: the functions with the most own time
    (host clock; profiling adds its own overhead); printed as a
    `host_profile` line when `show`, and returned."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    prof.enable()
    searcher.query_batch(queries, top_k=top_k, impl=impl)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    out = {"phase": "host_profile", "impl": impl,
           "total_s": sum(v[2] for v in stats.values()),
           "top_own_s": [[f"{Path(f).name}:{line}({fn})", own, cum]
                         for (f, line, fn), (_cc, _nc, own, cum, _) in rows]}
    if show:
        emit(out)
    return out


# ------------------------------------------------------------ serving
def _launched(tx) -> dict:
    return {k: v for k, v in tx.LAUNCHES.items() if v}


def _hits(results) -> list:
    return [(r.refs, r.texts) for r in results]


def _wall(fn):
    """(fn's result, its host-clock seconds ending in a device sync)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _fresh_clock(transport, seed: int) -> None:
    """Restart a simulated transport's clock and latency draws, so two
    drives through it see the same virtual latencies."""
    import numpy as np
    transport.cloud._rng = np.random.default_rng(seed)
    transport.cloud.clock_s = 0.0


def serving_phase(args, device, main: dict) -> dict:
    """The serving tier on the card over `main`'s corpus and store: a
    4-shard `ShardedIndex` and a segmented `Index` (base, one committed
    segment of SEG_APPEND new lines, one memory segment of SEG_ADD),
    then four drives, each with the launch counts zeroed before and read
    after: `SearchService.search_batch` of the main path's queries over
    the segmented index (== its own `impl="sorted"` in refs, texts and
    stats); FE_CLIENTS client threads through a started `Frontend` over
    a `SearchService` of the reopened cluster (every future == the
    service's sorted answer; launches == the served micro-batches
    replayed one by one, each at most one AND and one planner launch a
    shard); and the fused `ClusterSearcher` over per-shard simulated
    transports at top TOP_K under both budgets (beside the same
    session's per-shard legs under `impl="sorted"`; byte-identical to
    each other, every hit a true hit of the corpus, as many as the
    unsharded index finds, and each batch's `combine_cluster_keys`
    output bit for bit its plain version's on the same inputs) on the
    queries FUSED_CANDIDATES admits, light and heavy, and
    at top None on the queries the unsharded index answers with at most
    FUSED_FULL_MAX candidates (== the unsharded searcher). Then one
    fused top-K batch under torch.profiler."""
    import threading

    import torch

    from repro_torch.core.optimizer import InfeasibleSketchError
    from repro_torch.data import make_logs_like, write_corpus
    from repro_torch.data.corpus import Corpus
    from repro_torch.index import BuilderConfig, Index
    from repro_torch.index import planner as tp
    from repro_torch.kernels import intersect as tx
    from repro_torch.serving import (Frontend, FrontendConfig,
                                     SearchService, ShardedIndex)
    from repro_torch.serving.cluster import _accept
    from repro_torch.storage import SimCloudStore, SimCloudTransport
    from torch.profiler import ProfilerActivity, profile

    store, corpus, queries = main["store"], main["corpus"], main["queries"]
    texts = main["query_texts"]

    def sim(seed):
        return SimCloudTransport(SimCloudStore(store, seed=seed))

    # ---- builds ---------------------------------------------------------
    # a shard holds 1/SERVING_SHARDS of the documents: as many bins a
    # document as the unsharded index (B bins a shard took twice as long
    # to build)
    B = main["B"] // SERVING_SHARDS
    t0 = time.perf_counter()
    while True:
        try:
            cluster = ShardedIndex.build(
                corpus, BuilderConfig(F0=1.0, B=B), store, "cluster/hdfs",
                n_shards=SERVING_SHARDS, device=device)
            break
        except InfeasibleSketchError:
            B *= 2
    cluster_build_s = time.perf_counter() - t0
    n_base = min(SEG_BASE, corpus.n_docs)
    base = corpus if n_base == corpus.n_docs else Corpus(
        store=corpus.store, refs=corpus.refs[:n_base],
        texts=corpus.texts[:n_base] if corpus.texts is not None else None)
    added = [write_corpus(store, f"corpus/hdfs-{name}",
                          make_logs_like(n, seed=args.seed + 1 + i),
                          n_blobs=2)
             for i, (name, n) in enumerate((("append", SEG_APPEND),
                                            ("add", SEG_ADD)))]
    seg_seed = args.seed + 11
    t0 = time.perf_counter()
    seg_B = main["B"]
    while True:
        try:
            segmented = Index.build(base, BuilderConfig(F0=1.0, B=seg_B),
                                    sim(seg_seed), "index/hdfs-seg",
                                    device=device)
            break
        except InfeasibleSketchError:
            seg_B *= 2
    seg_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = segmented.writer()
    seg_report = w.append(added[0])
    w.commit()
    mem_report = segmented.writer().add(added[1])
    seg_add_s = time.perf_counter() - t0
    emit({"phase": "build_serving",
          "cluster": {"docs": corpus.n_docs, "shards": SERVING_SHARDS,
                      "B": B, "build_s": cluster_build_s,
                      "index_bytes": sum(idx.report.index_bytes
                                         for idx in cluster.shards
                                         if idx is not None),
                      "shard_docs": [e["n_docs"] for e in
                                     cluster.manifest["shards"]]},
          "segmented": {"base_docs": n_base, "B": seg_B,
                        "build_s": seg_build_s,
                        "index_bytes": segmented.report.index_bytes,
                        "append_docs": SEG_APPEND, "add_docs": SEG_ADD,
                        "append_add_commit_s": seg_add_s,
                        "segment_bytes": seg_report.index_bytes,
                        "memory_bytes": mem_report.index_bytes}})
    torch.cuda.reset_peak_memory_stats()
    out: dict = {"launches": {}}

    # ---- the segmented service ------------------------------------------
    svc = SearchService(segmented)
    n_units = svc.searcher.n_units
    _fresh_clock(segmented.transport, seg_seed)
    tx.reset_launches()
    got, seg_card_s = _wall(lambda: svc.search_batch(queries, top_k=TOP_K))
    seg_launches = _launched(tx)
    _fresh_clock(segmented.transport, seg_seed)
    want, seg_sorted_s = _wall(lambda: svc.search_batch(
        queries, top_k=TOP_K, impl="sorted"))
    for q, (a, b) in enumerate(zip(got, want)):
        if (a.refs, a.texts, a.stats) != (b.refs, b.texts, b.stats):
            raise AssertionError(f"segmented query {q} ({texts[q]!r}): "
                                 "the card != sorted")
    expect = {"intersect_batch_keys": n_units, "combine_batch_keys": n_units}
    if seg_launches != expect:
        raise AssertionError(f"segmented service launched {seg_launches}, "
                             f"expected {expect}")
    svc.close()
    out["launches"]["segmented"] = seg_launches

    # ---- the frontend over the reopened cluster --------------------------
    svc = SearchService(ShardedIndex.open(store, "cluster/hdfs",
                                          device=device))
    want, fe_sorted_s = _wall(lambda: svc.search_batch(
        queries, top_k=TOP_K, impl="sorted"))
    batches, search_batch = [], svc.search_batch

    def recording(qs, **kw):
        batches.append((list(qs), kw))
        return search_batch(qs, **kw)

    svc.search_batch = recording
    fe = Frontend(svc, FrontendConfig(max_queue=len(queries),
                                      max_batch=FE_MAX_BATCH))
    futs: list = [None] * len(queries)
    submitted, latency = [0.0] * len(queries), [0.0] * len(queries)

    def client(c):
        for i in range(c, len(queries), FE_CLIENTS):
            submitted[i] = time.perf_counter()
            futs[i] = fe.submit(queries[i], top_k=TOP_K)
            futs[i].add_done_callback(
                lambda _f, i=i: latency.__setitem__(
                    i, time.perf_counter() - submitted[i]))

    tx.reset_launches()
    fe.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(FE_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    fe_got = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    fe_card_s = time.perf_counter() - t0
    fe_launches = _launched(tx)
    fe.close()
    stats = fe.stats.summary()
    if _hits(fe_got) != _hits(want):
        bad = next(q for q, (a, b) in enumerate(zip(fe_got, want))
                   if _hits([a]) != _hits([b]))
        raise AssertionError(f"frontend query {bad} ({texts[bad]!r}) != "
                             "the service's sorted answer")
    if stats["n_shed"] or stats["n_expired"] or \
            stats["n_served"] != len(queries):
        raise AssertionError(f"frontend dropped requests: {stats}")
    # replayed one by one, each micro-batch launches at most one AND and
    # one planner combine a shard, and none of the bitmap kernels
    replayed: dict = {}
    for qs, kw in batches:
        tx.reset_launches()
        search_batch(qs, **kw)
        one = _launched(tx)
        if not set(one) <= {"intersect_batch_keys", "combine_batch_keys"} \
                or max(one.values(), default=0) > SERVING_SHARDS:
            raise AssertionError(f"a frontend micro-batch of {len(qs)} "
                                 f"launched {one} over {SERVING_SHARDS} "
                                 "shards")
        for k, v in one.items():
            replayed[k] = replayed.get(k, 0) + v
    if fe_launches != replayed or len(batches) != stats["n_batches"]:
        raise AssertionError(f"frontend launched {fe_launches} over "
                             f"{stats['n_batches']} batches; the "
                             f"{len(batches)} batches replayed alone "
                             f"launch {replayed}")
    svc.close()
    out["launches"]["frontend"] = fe_launches
    lat = sorted(latency)

    # ---- the fused cluster -----------------------------------------------
    def sources(s):
        return sim(args.seed + 100 + s)

    cs = ShardedIndex.open(store, "cluster/hdfs", device=device).searcher(
        replica_sources=[sources], fused=True)
    by_size = sorted(range(len(queries)),
                     key=lambda q: main["res_sorted"][q].stats.n_candidates)
    picked, total = [], 0
    for q in by_size:
        total += main["res_sorted"][q].stats.n_candidates
        if total > FUSED_CANDIDATES:
            break
        picked.append(q)
    picked.sort()
    fq = [queries[q] for q in picked]
    if not cs._independent_clocks():
        raise AssertionError("fused legs do not run concurrently")
    heavy = sum(main["res_sorted"][q].stats.n_candidates > FUSED_FULL_MAX
                for q in picked)
    if not heavy:
        raise AssertionError("the fused top-K batch holds no heavy query")
    fused, fused_s, fused_launches, reports = {}, {}, {}, {}
    combine_keys, combined = tx.combine_keys, []

    def recorded(rows, programs, **kw):
        got = combine_keys(rows, programs, **kw)
        combined.append((rows, programs, kw, got))
        return got

    for budget in ("global", "per_shard"):
        tx.reset_launches()
        tx.combine_keys = recorded
        try:
            fused[budget], fused_s[budget] = _wall(lambda: cs.query_batch(
                fq, top_k=TOP_K, budget=budget))
        finally:
            tx.combine_keys = combine_keys
        fused_launches[budget] = _launched(tx)
        reports[budget] = cs.last_scatter
        if fused_launches[budget] != {"combine_cluster_keys": 1}:
            raise AssertionError(f"fused batch ({budget}) launched "
                                 f"{fused_launches[budget]}")
    if _hits(fused["global"]) != _hits(fused["per_shard"]):
        raise AssertionError("fused budgets differ")
    # the kernel's keys, counts and lengths in both batches, bit for bit
    # the plain version's on the same inputs (its memory kept out of the
    # drives' peak)
    peak = torch.cuda.max_memory_allocated()
    fused_keys = 0
    for rows, programs, kw, got in combined:
        want = combine_keys(rows, programs, **{**kw, "impl": "ref"})
        if len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("the fused batch's combine_cluster_keys "
                                 "!= its plain version")
        fused_keys = int(got[0].numel())
    if len(combined) != 2:
        raise AssertionError(f"{len(combined)} fused combines in 2 batches")
    del combined, got, want
    torch.cuda.reset_peak_memory_stats()
    # the host's counterpart: the same session's per-shard legs, sorted
    tx.reset_launches()
    _legs, legs_sorted_s = _wall(lambda: cs.query_batch(
        fq, top_k=TOP_K, impl="sorted", fused=False))
    if _launched(tx):
        raise AssertionError(f"sorted legs launched {_launched(tx)}")
    # true hits: corpus documents the query's own predicate accepts, as
    # many as the unsharded index returns
    jobs = tp.plan_batch(fq, top_k=TOP_K)
    in_corpus = set(corpus.refs)
    for job, q, res in zip(jobs, picked, fused["global"]):
        mono, cache = main["res_sorted"][q], {}
        ok = len(res.refs) == len(mono.refs) and all(
            ref in in_corpus and _accept(job, (ref.blob, ref.offset,
                                               ref.length), text, cache)
            for ref, text in zip(res.refs, res.texts))
        if not ok or (len(mono.refs) < TOP_K and
                      set(res.refs) != set(mono.refs)):
            raise AssertionError(f"fused query {q} ({texts[q]!r}) returned "
                                 "other than true hits")
    small = [q for q, r in enumerate(main["res_sorted"])
             if r.stats.n_candidates <= FUSED_FULL_MAX]
    mono_searcher = main["searcher"]()
    full_want = mono_searcher.query_batch([queries[q] for q in small],
                                          impl="sorted")
    tx.reset_launches()
    full_got, full_s = _wall(lambda: cs.query_batch(
        [queries[q] for q in small]))
    if _launched(tx) != {"combine_cluster_keys": 1}:
        raise AssertionError(f"fused full batch launched {_launched(tx)}")
    if _hits(full_got) != _hits(full_want):
        raise AssertionError("fused top-None != the unsharded index")
    out["launches"]["fused"] = {k: fused_launches["global"][k] +
                                fused_launches["per_shard"][k] + 1
                                for k in fused_launches["global"]}
    peak = max(peak, torch.cuda.max_memory_allocated())

    # ---- one fused batch, traced ------------------------------------------
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.query_batch(fq, top_k=TOP_K)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, events, _by_name = _device_time(prof)
    cs.close()
    emit({"phase": "serving", "queries": len(queries), "top_k": TOP_K,
          "segmented": {"units": n_units, "identical_to_sorted": True,
                        "wall_s": {"bitmap_cuda": seg_card_s,
                                   "sorted": seg_sorted_s}},
          "frontend": {"clients": FE_CLIENTS, "max_batch": FE_MAX_BATCH,
                       "batches": stats["n_batches"],
                       "mean_batch": stats["mean_batch_size"],
                       "identical_to_sorted": True,
                       "wall_s": {"bitmap_cuda": fe_card_s,
                                  "sorted_service": fe_sorted_s},
                       "latency_s": {
                           "p50": statistics.median(lat),
                           "p99": lat[min(len(lat) - 1,
                                          int(0.99 * len(lat)))],
                           "max": lat[-1]}},
          "fused": {"shards": cs.n_shards, "budgets_identical": True,
                    "true_hits": True,
                    "wall_s": {**{f"{b}_cuda": fused_s[b] for b in fused_s},
                               "per_shard_legs_sorted": legs_sorted_s,
                               "full_cuda": full_s},
                    "queries": len(fq), "heavy_queries": heavy,
                    "kernel_identical_to_plain": True,
                    "combined_keys": fused_keys,
                    "unsharded_candidates": total - (
                        main["res_sorted"][by_size[len(picked)]].stats
                        .n_candidates if len(picked) < len(queries) else 0),
                    "full_queries": len(small),
                    "full_identical_to_unsharded": True,
                    "round2_bytes": {b: reports[b].round2_bytes
                                     for b in reports},
                    "round2_requests": {b: reports[b].round2_requests
                                        for b in reports},
                    "shard_candidates": reports["global"].shard_candidates},
          "launches": out["launches"], "peak_device_bytes": peak,
          "fused_profile": {"host_wall_us": wall_us,
                            "device_busy_us": busy_us,
                            "device_idle_share": 1 - busy_us / wall_us
                            if events else None,
                            "device_events": events}})
    out.update(cluster_prefix="cluster/hdfs", fused_picked=picked,
               segmented=segmented)
    return out


# --------------------------------------------------------- cluster admin
def cluster_admin_phase(args, device, main: dict, serving: dict) -> dict:
    """Membership changes and GC on the serving phase's cluster, on a
    fresh handle on the card: `reshard` to 2·SERVING_SHARDS slots, `split`
    and `replicate` (alias mode: each writes only its manifest),
    `compact` of one aliased shard (the one step that builds),
    `append` of ADMIN_APPEND new lines, then `collect_garbage(keep=1)`
    past the grace window. After each step, `refresh()` and two fused
    batches, each exactly one `combine_cluster_keys` launch and nothing
    else, its output bit for bit the plain version's on the captured
    inputs: ADMIN_LIGHT light queries at top None (byte-identical to the
    untouched cluster's answer through step 4; equal to the same
    handle's per-shard `impl="sorted"` legs from step 5 on, when the
    appended lines change the answer) and, at top TOP_K, ADMIN_HEAVY
    heavy queries beside ADMIN_TOPK_LIGHT light ones (true hits, as many
    as the corpus holds up to TOP_K: a top-K answer is a sample whose
    selection follows the units' layout, so it is not compared byte for
    byte across layouts). After GC a reopened handle answers both
    batches alike, and no blob the kept generation reaches was
    deleted."""
    import torch

    from repro_torch.data import make_logs_like, write_corpus
    from repro_torch.index import planner as tp
    from repro_torch.index.lifecycle import DEFAULT_GRACE_S
    from repro_torch.kernels import intersect as tx
    from repro_torch.serving import ShardedIndex
    from repro_torch.serving.cluster import (_accept,
                                             cluster_reachable_blobs)
    from repro_torch.storage import SimCloudStore, SimCloudTransport

    store, queries, texts = main["store"], main["queries"], \
        main["query_texts"]
    res_sorted, prefix = main["res_sorted"], serving["cluster_prefix"]
    picked = serving["fused_picked"]

    def n_cand(q):
        return res_sorted[q].stats.n_candidates
    light = [q for q in picked if n_cand(q) <= FUSED_FULL_MAX]
    heavy = [q for q in picked if n_cand(q) > FUSED_FULL_MAX]
    full_q = light[:ADMIN_LIGHT]
    topk_q = sorted(light[:ADMIN_TOPK_LIGHT] + heavy[:ADMIN_HEAVY])
    if len(full_q) < ADMIN_LIGHT or len(heavy) < ADMIN_HEAVY:
        raise AssertionError(f"the fused queries hold {len(light)} light "
                             f"and {len(heavy)} heavy ones")
    extra = write_corpus(store, "corpus/hdfs-admin",
                         make_logs_like(ADMIN_APPEND, seed=args.seed + 3),
                         n_blobs=1)
    in_corpus = set(main["corpus"].refs)
    jobs = tp.plan_batch([queries[q] for q in topk_q], top_k=TOP_K)

    def sources(s):
        return SimCloudTransport(SimCloudStore(store,
                                               seed=args.seed + 200 + s))

    def fused_batch(handle, qs, top_k, name):
        """One fused batch: its results, wall, launches, replica rows."""
        cs = handle.searcher(replica_sources=[sources], fused=True)
        outputs: dict = {}
        captured, release = capture_key_calls(tx, outputs)
        tx.reset_launches()
        try:
            res, wall = _wall(lambda: cs.query_batch(
                [queries[q] for q in qs], top_k=top_k))
        finally:
            release()
        launched = _launched(tx)
        if launched != {"combine_cluster_keys": 1}:
            raise AssertionError(f"{name}: the fused batch launched "
                                 f"{launched}")
        # the plain version's memory kept out of the drive's peak
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        rows, programs, _n, groups, lengths = captured["combine_cluster"]
        want = tx.combine_keys(rows, programs, groups=groups,
                               lengths=lengths, impl="ref", device=device)
        got = outputs["combine_cluster"]
        if len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: combine_cluster_keys != its "
                                 "plain version")
        del want, got, outputs
        torch.cuda.reset_peak_memory_stats()
        rows_per_shard = [len(r) for r in cs.shard_replicas]
        cs.close()
        return res, wall, rows_per_shard

    def check_topk(res, name, grown):
        """True hits, as many as the corpus holds up to TOP_K."""
        cache: dict = {}
        docs = in_corpus | set(extra.refs) if grown else in_corpus
        for job, q, r in zip(jobs, topk_q, res):
            base = len(res_sorted[q].refs)
            ok = all(ref in docs and _accept(job, (ref.blob, ref.offset,
                                                   ref.length), t, cache)
                     for ref, t in zip(r.refs, r.texts))
            count = base <= len(r.refs) <= TOP_K if grown else \
                len(r.refs) == base
            if not (ok and count):
                raise AssertionError(f"{name}: query {q} ({texts[q]!r}) "
                                     "returned other than true hits")

    peak = [0]
    torch.cuda.reset_peak_memory_stats()
    handle = ShardedIndex.open(store, prefix, device=device)
    base_full, base_s, _rows = fused_batch(handle, full_q, None, "untouched")
    base_topk, base_topk_s, _rows = fused_batch(handle, topk_q, TOP_K,
                                                "untouched")
    check_topk(base_topk, "untouched", False)
    now = time.time() + 2 * DEFAULT_GRACE_S
    steps = [
        ("reshard", lambda: handle.reshard(
            SERVING_SHARDS, n_slots=2 * SERVING_SHARDS)),
        ("split", lambda: handle.split(0)),
        ("replicate", lambda: handle.replicate(ADMIN_SHARD, 2)),
        ("compact", lambda: handle.compact(ADMIN_SHARD)),
        ("append", lambda: handle.append(extra)),
        ("collect_garbage", lambda: handle.collect_garbage(keep=1,
                                                           now=now)),
    ]
    report, launches = [], 0
    for i, (name, step) in enumerate(steps):
        grown = name in ("append", "collect_garbage")
        before = set(store.list(prefix + "/"))
        reach = cluster_reachable_blobs(store, prefix, keep=1) \
            if name == "collect_garbage" else None
        t0 = time.perf_counter()
        out = step()
        step_s = time.perf_counter() - t0
        written = set(store.list(prefix + "/")) - before
        entry = {"step": name, "wall_s": step_s,
                 "generation": handle.generation,
                 "shards": handle.n_shards,
                 "aliased": list(handle.aliased_shards),
                 "blobs_written": len(written),
                 "bytes_written": sum(store.size(n) for n in written)}
        if name == "reshard" and written != {
                f"{prefix}/cluster-{handle.generation:08d}.airc"}:
            raise AssertionError(f"alias reshard wrote {sorted(written)}")
        if name == "compact" and ADMIN_SHARD in handle.aliased_shards:
            raise AssertionError("compact left its shard aliased")
        if name == "collect_garbage":
            lost = set(out.deleted) & reach
            if lost or not out.deleted:
                raise AssertionError(f"GC deleted {len(out.deleted)} "
                                     f"blobs, {len(lost)} of them "
                                     "reachable from the kept generation")
            entry.update(deleted=len(out.deleted),
                         bytes_reclaimed=out.bytes_reclaimed,
                         kept_grace=len(out.kept_grace))
        handle.refresh()
        full, full_s, rows_per_shard = fused_batch(handle, full_q, None,
                                                   name)
        topk, topk_s, _rows = fused_batch(handle, topk_q, TOP_K, name)
        launches += 2
        check_topk(topk, name, grown)
        if not grown:
            if _hits(full) != _hits(base_full):
                raise AssertionError(f"{name}: top None != the untouched "
                                     "cluster's answer")
        else:
            legs = handle.searcher()
            want, legs_s = _wall(lambda: legs.query_batch(
                [queries[q] for q in full_q], impl="sorted", fused=False))
            legs.close()
            if _hits(full) != _hits(want):
                raise AssertionError(f"{name}: the fused top None != the "
                                     "per-shard sorted legs")
            if name == "append" and _hits(full) == _hits(base_full):
                raise AssertionError("the appended lines changed no "
                                     "answer")
            entry["sorted_legs_wall_s"] = legs_s
        entry.update(batch_wall_s={"full_cuda": full_s, "topk_cuda": topk_s},
                     replica_rows=rows_per_shard)
        report.append(entry)
        emit({"phase": "cluster_admin_step", **entry})
    reopened = ShardedIndex.open(store, prefix, device=device)
    again, _s, _r = fused_batch(reopened, full_q, None, "reopened")
    again_topk, _s, _r = fused_batch(reopened, topk_q, TOP_K, "reopened")
    launches += 2
    if _hits(again) != _hits(full) or _hits(again_topk) != _hits(topk):
        raise AssertionError("a reopened handle answers otherwise after GC")
    emit({"phase": "cluster_admin", "docs": main["corpus"].n_docs,
          "appended": ADMIN_APPEND, "full_queries": len(full_q),
          "topk_queries": len(topk_q), "heavy_queries": ADMIN_HEAVY,
          "untouched_wall_s": {"full_cuda": base_s,
                               "topk_cuda": base_topk_s},
          "identical_through_compact": True,
          "equal_to_sorted_legs_after_append": True,
          "kernel_identical_to_plain": True,
          "reopened_after_gc_identical": True,
          "combine_cluster_launches": launches + 2,
          "peak_device_bytes": max(peak[0],
                                   torch.cuda.max_memory_allocated()),
          "steps": {e["step"]: e["wall_s"] for e in report}})
    return {"launches": {"combine_cluster_keys": launches + 2}}


# ------------------------------------------------------------------ RAG
def rag_phase(args, device, serving: dict) -> dict:
    """`RAGPipeline` on the card: `granite-20b` at full width cut to
    RAG_LAYERS layers, random bf16 weights, retrieving through a
    `SearchService` over the serving phase's segmented index. Each of
    RAG_QUERIES retrieves RAG_DOCS documents, prefills them and decodes
    RAG_TOKENS greedy tokens: exactly RAG_LAYERS · (1 + RAG_TOKENS)
    attention launches a query (the prefill kernel for the prompt, the
    split-KV decode kernel for each step's 48 rows on one KV head). The
    run's logits are held to the same model through the plain
    attention, teacher-forced on the run's own prompt and tokens, within
    LM_TOL of their scale."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as ta
    from repro_torch.kernels import intersect as tx
    from repro_torch.models import build_model, init_params, param_count
    from repro_torch.models.transformer import TransformerModel
    from repro_torch.serving import RAGPipeline, SearchService

    cfg = get_config(RAG_ARCH).with_(n_layers=RAG_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model.param_desc(),
                         torch.Generator(device=device).manual_seed(args.seed),
                         device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calls: list = []

    def timed(kind, batch, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*a)
        torch.cuda.synchronize()
        calls.append((kind, batch["tokens"], logits,
                      time.perf_counter() - t0))
        return logits, cache

    class TimedRAG(RAGPipeline):
        """Records each model call's tokens, logits and wall time (a
        subclass, so that no reference cycle keeps the weights alive
        past the phase)."""

        def _prefill(self, params, batch, pad_to):
            return timed("prefill", batch, super()._prefill, params, batch,
                         pad_to)

        def _decode(self, params, cache, batch):
            return timed("decode", batch, super()._decode, params, cache,
                         batch)

    svc = SearchService(serving["segmented"])
    rag = TimedRAG(svc, model, params, vocab_size=cfg.vocab)
    rag.generate(RAG_QUERIES[0], max_new_tokens=2)            # warm-up
    calls.clear()

    # ---- the rag path: counts zeroed before, read after ----------------
    ta.reset_launches()
    tx.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = [rag.generate(q, top_k_docs=RAG_DOCS,
                            max_new_tokens=RAG_TOKENS)
               for q in RAG_QUERIES]
    wall_s = time.perf_counter() - t0
    launches = ta.LAUNCHES["flash_attention"]
    shapes = dict(ta.LAUNCH_SHAPES)
    key_launches = _launched(tx)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------
    svc.close()

    want = len(RAG_QUERIES) * cfg.n_layers * (1 + RAG_TOKENS)
    if launches != want:
        raise AssertionError(f"flash_attention launched {launches} times on "
                             f"the rag path, expected {want}")
    per = 1 + RAG_TOKENS
    if len(calls) != len(RAG_QUERIES) * per or \
            not all(len(r.retrieved) == RAG_DOCS for r in results):
        raise AssertionError(f"{len(calls)} model calls on the rag path, "
                             f"{[len(r.retrieved) for r in results]} "
                             "documents retrieved")
    # the kernel alone against the plain attention at each shape the path
    # launched: a prefill at its last query, a decode step at the first
    # step (the slots past it empty) and the last
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    attn_errs = dict.fromkeys(ATTN_TOL, 0.0)
    for key in shapes:
        B, S, T, H, KV, dh, dtype_name = key
        q, k, v = attn_inputs(gen, (B, S, H, dh), (B, T, KV, dh),
                              getattr(torch, dtype_name), device)
        for pos in ((S - 1,) if S > 1 else (T - RAG_TOKENS, T - 1)):
            kpos = torch.arange(T, dtype=torch.int32, device=device)
            kpos[pos + 1:] = -1
            err = attn_compare(ta, f"flash_attention rag {key} pos={pos}",
                               q, k, v, causal=True,
                               q_positions=kpos[pos + 1 - S:pos + 1].clone(),
                               kv_positions=kpos)
            attn_errs[dtype_name] = max(attn_errs[dtype_name], err)
        del q, k, v
    plain_model = TransformerModel(cfg, attn_impl="ref")
    queries, worst = [], 0.0
    for i, (q, res) in enumerate(zip(RAG_QUERIES, results)):
        run = calls[i * per:(i + 1) * per]
        prompt = run[0][1]
        tokens = torch.from_numpy(res.tokens).to(device)[None]
        if res.n_decoded != RAG_TOKENS or any(
                not torch.equal(c[1][:, 0], tokens[:, t])
                for t, c in enumerate(run[1:])):
            raise AssertionError(f"rag query {q!r}: malformed run")
        kern = torch.stack([c[2] for c in run])
        if kern.shape != (per, 1, cfg.vocab) or \
                not torch.isfinite(kern).all():
            raise AssertionError(f"rag query {q!r}: malformed logits")
        with torch.inference_mode():
            plain = teacher_forced(plain_model, params, prompt, tokens)
        scale = float(plain.abs().max())
        rel = float((kern - plain).abs().max()) / scale
        worst = max(worst, rel)
        queries.append({
            "query": q, "retrieved": len(res.retrieved),
            "prompt_tokens": int(prompt.shape[1]),
            "retrieval_ms_simulated": res.retrieval_ms,
            "prefill_ms": 1e3 * run[0][3],
            "decode_ms_per_token": 1e3 * sum(c[3] for c in run[1:])
            / RAG_TOKENS,
            "tokens": res.tokens.tolist(),
            "max_err_over_max_logit": rel, "max_logit": scale,
            "argmax_agreement": float((kern.argmax(-1) == plain.argmax(-1))
                                      .float().mean())})
    emit({"phase": "rag", "arch": RAG_ARCH, "layers": cfg.n_layers,
          "layers_published": get_config(RAG_ARCH).n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv,
          "head_dim": cfg.dh, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "params": param_count(params), "init_s": init_s,
          "new_tokens": RAG_TOKENS, "queries": queries, "wall_s": wall_s,
          "attention_launches": launches,
          "attention_shapes": {str(k): v for k, v in shapes.items()},
          "retrieval_launches": key_launches,
          "attention_vs_plain_max_abs_err": attn_errs,
          "vs_plain_attention": {"max_err_over_max_logit": worst,
                                 "tolerance": LM_TOL},
          "peak_device_bytes": peak_bytes})
    if not worst <= LM_TOL:
        raise AssertionError(f"rag logits through the kernel differ from "
                             f"the plain attention by {worst} of their "
                             f"scale (> {LM_TOL})")
    return {"launches": launches, "errs": attn_errs}


# --------------------------------------------------------------- timing
def cuda_ms(fn, flush, iters: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of `fn`, L2 flushed before each run."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_parts(fn, flush, keys, iters: int = 10) -> dict:
    """Median device ms a run of `fn` spends in each kernel whose name
    holds one of `keys` (the longest key that matches), from
    torch.profiler over `iters` runs, L2 flushed before each. The
    profiler may miss runs of its window, at times most of them: a window
    that shows fewer than half the runs of a kernel is taken again, up to
    three; a kernel still seen in fewer is None. It traces the host too:
    a card-only trace taken after the train phase's host-and-card trace
    in the same process has seen no kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        times: dict[str, list] = {key: [] for key in keys}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            hits = [key for key in keys if key in e.name]
            if hits:
                times[max(hits, key=len)].append(
                    1e-3 * (e.time_range.end - e.time_range.start))
        if all(len(v) >= iters // 2 for v in times.values()):
            break
    return {key: (statistics.median(v) if len(v) >= iters // 2 else None)
            for key, v in times.items()}


def device_ms(fn, flush, match: str, iters: int = 20) -> float:
    """Median device time (ms) of the kernel whose name holds `match`
    (`device_ms_parts`): the kernel alone, without the card's own launch
    latency that CUDA events around a kernel of a few µs also count.
    Raises when three profiler windows each saw it in fewer than half
    the runs."""
    ms = device_ms_parts(fn, flush, (match,), iters)[match]
    if ms is None:
        raise AssertionError(f"profiler saw fewer than {iters // 2} "
                             f"{match!r} kernels of {iters}, three times")
    return ms


def bound(host, prog=None) -> tuple[float, str]:
    """Least card time (ms) for the work on these inputs: each input read
    once and each output written once over HBM bandwidth, against the
    32-bit integer ops over the INT32 rate; the larger, and which it is.

    `host` is the (…, L, W) bitmaps. An L-way AND reads every layer. A
    combine program reads only the layers its steps name (the planner
    pads ragged L with layers no step names), so its rows are counted
    one by one; `prog` is the (…, S, 3) programs."""
    import numpy as np

    from repro_torch.launch import roofline as rl
    L, W = host.shape[-2:]
    rows = host.size // (L * W)
    if prog is None:
        layers_read = rows * L
        ops = rows * W * L                      # L-1 ANDs + popc per word
        prog_bytes = 0
    else:
        prog = prog.reshape(rows, -1, 3)
        S = prog.shape[1]
        named = np.zeros((rows, L), dtype=bool)
        for col in (1, 2):
            slots = prog[:, :, col]
            r, s = np.nonzero(slots < L)
            named[r, slots[r, s]] = True
        layers_read = int(named.sum())
        ops = rows * W * (S + 1)                # one LOP3 per step + popc
        prog_bytes = prog.nbytes
    nbytes = 4 * W * (layers_read + rows) + prog_bytes + 8 * rows
    t_bytes, t_ops = nbytes / rl.HBM_BYTES_PER_S, ops / rl.INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def timing_phase(tx, device, rng, shapes: dict, errs: dict) -> list[dict]:
    import numpy as np
    import torch

    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    rows_of = {"intersect": lambda s: (1,) + s,
               "intersect_batch": lambda s: s,
               "combine_batch": lambda s: s,
               "combine_cluster": lambda s: (s[0] * s[1],) + s[2:]}
    plain_of = {"intersect": tx.intersect_ref,
                "intersect_batch": tx.intersect_batch_ref,
                "combine_batch": tx.combine_batch_ref,
                "combine_cluster": tx.combine_cluster_ref}
    kernels = []
    for name, shape in shapes.items():
        bm_shape = tuple(shape[0])
        host = random_bitmaps(rng, bm_shape)
        rows, L, W = rows_of[name](bm_shape)
        host_prog = None
        if len(shape) == 2:
            S = shape[1][-2]
            progs = tx.pack_programs(random_programs(rng, rows, L, S), L)
            host_prog = progs.reshape(*bm_shape[:-2], S, 3)
        inputs = (host,) if host_prog is None else (host, host_prog)
        got, want = call_pair(tx, name, inputs, device)
        errs[name] = max(errs[name], compare(name, got, want))

        bm = torch.from_numpy(host.view(np.int32)).to(device)
        prog = None if host_prog is None else \
            torch.from_numpy(np.ascontiguousarray(host_prog)).to(device)
        out = torch.empty((rows, W), dtype=torch.int32, device=device)
        cnt = torch.zeros(rows, dtype=torch.int64, device=device)
        bm3 = bm.view(rows, L, W)
        prog3 = None if prog is None else prog.view(rows, -1, 3)

        def kernel():
            tx.launch(name, bm3, prog3, out, cnt)

        def plain():
            return plain_of[name](*((bm,) if prog is None else (bm, prog)))
        kernel_ms = cuda_ms(kernel, flush)
        plain_ms = cuda_ms(plain, flush)
        h2d_ms = cuda_ms(lambda: torch.from_numpy(host.view(np.int32))
                         .to(device), flush)
        d2h_ms = cuda_ms(lambda: out.cpu(), flush)
        bound_ms, bound_by = bound(host, host_prog)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "shape": [list(s) for s in shape],
            "max_abs_err": errs[name], "bit_exact": errs[name] == 0,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "kernel_us": 1e3 * kernel_ms, "plain_us": 1e3 * plain_ms,
            "bound_us": 1e3 * bound_ms, "h2d_ms": h2d_ms, "d2h_ms": d2h_ms})
    return kernels


def host_ms(fn, iters: int = 5) -> float:
    """Median host-clock time (ms) of `fn` ending in a device
    synchronise, after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def keys_bound(plan, n_keys: int, n_hit: int, ranks: bool,
               ) -> dict[str, tuple[float, str]]:
    """Least card time (ms) of each key-route kernel on this plan's data,
    and which term bounds it: bytes over HBM bandwidth against integer
    operations over the INT32 rate. W = ceil(U / 32) words a row: the
    padding of the last tile is work of the kernel, not of the function.

    combine_postings reads the ranks of every list a program names, each
    distinct list once (4 B a rank), the (row, layer) bounds (8 B each)
    and the programs (12 B a step), and writes 4 B per result word and
    per tile count; it sets one bit per rank of each named (row, layer)
    and does one op per step and word plus a popc. bits_to_keys reads the
    words and the int64 tile offsets and writes 8 B per key (and 4 B per
    rank with `ranks`); it reads 8 B for each of the `n_hit` distinct
    universe entries its keys hit (all rows gather from one universe,
    which fits in L2), none for the identity universe."""
    import numpy as np
    r = plan.ranked
    bounds, prog = r.bounds.cpu().numpy(), plan.programs.cpu().numpy()
    rows, L, _ = bounds.shape
    S = prog.shape[1]
    named = np.zeros((rows, L), dtype=bool)
    for col in (1, 2):
        slots = prog[:, :, col]
        rr, ss = np.nonzero(slots < L)
        named[rr, slots[rr, ss]] = True
    spans = bounds[named]
    distinct = np.unique(spans, axis=0) if len(spans) else spans
    n_words = rows * ((r.n_bits + 31) // 32)

    def pair(nbytes, ops):
        from repro_torch.launch import roofline as rl
        t_bytes, t_ops = nbytes / rl.HBM_BYTES_PER_S, ops / rl.INT32_OPS_PER_S
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                          else "operations")
    return {
        "combine_postings": pair(
            4 * int((distinct[:, 1] - distinct[:, 0]).sum()) + bounds.nbytes
            + prog.nbytes + 4 * n_words + 4 * rows * plan.tiles,
            int((spans[:, 1] - spans[:, 0]).sum()) + n_words * (S + 1)),
        "bits_to_keys": pair(
            4 * n_words + 8 * rows * plan.tiles
            + (12 if ranks else 8) * n_keys
            + (0 if r.universe is None else 8 * n_hit),
            n_words + n_keys)}


def keys_timing_phase(tx, device, rng, main: dict, errs: dict,
                      ) -> list[dict]:
    """The key route's kernels at each route's last inputs on the main
    path, one entry per TPU kernel it replaces: `ms` is combine_postings
    plus bits_to_keys by CUDA events (L2 flushed), `plain_ms` their plain
    versions, `bound_ms` the sum of their bounds, `parts` each kernel
    alone; beside them the work around the kernels: the host's plan
    (`plan_ms`, host clock: leaf checks, H2D, universe, programs), the
    leaves' H2D copy, the universe's sort and ranking on the card, the
    keys' D2H copy, and the entry point whole (`entry_ms`), each as the
    main path called it (`ranks`: bits_to_keys also wrote the keys'
    ranks, for the lengths `combine_keys` recovers). `routes`
    gives the bitmap kernel that route took before, timed at the same
    (rows, L, W) on random bitmaps (0 launches on the main path)."""
    import numpy as np
    import torch
    from repro_torch.kernels.intersect import ops as txo

    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    bitmap_shapes, plans = {}, {}
    for name, route in KEY_ROUTES.items():
        rows, progs, n_docs, groups, _lengths = main["captured"][name]
        plan = plans[name] = txo.plan_keys(rows, progs, n_docs, device)
        n, L, S = len(rows), plan.ranked.bounds.shape[1], \
            plan.programs.shape[1]
        W = (plan.ranked.n_bits + 31) // 32
        bitmap_shapes[name] = {
            "intersect": ((L, W),), "intersect_batch": ((n, L, W),),
            "combine_batch": ((n, L, W), (n, S, 3)),
            "combine_cluster": ((groups, n // (groups or 1), L, W),
                                (groups, n // (groups or 1), S, 3)),
        }[name]
    bitmap = {k["name"]: k for k in timing_phase(tx, device, rng,
                                                  bitmap_shapes, errs)}
    kernels = []
    for name, route in KEY_ROUTES.items():
        rows, progs, n_docs, groups, lengths = main["captured"][name]
        plan, r = plans[name], plans[name].ranked
        ranks = lengths is not None
        got = txo.keys_kernels(plan, ranks)
        words, tile_cnt, keys, key_ranks = got
        plain = txo.keys_plain(plan, ranks)
        torch.cuda.synchronize()
        for a, b in zip(got[:4 if ranks else 3], plain):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{route}: kernels differ from the "
                                     "plain version on the main path's "
                                     "inputs")
        flat = tile_cnt.view(-1).to(torch.int64)
        offsets = torch.cumsum(flat, 0) - flat
        out_w, out_c = torch.empty_like(words), torch.empty_like(tile_cnt)
        out_k = torch.empty_like(keys)
        out_r = None if key_ranks is None else torch.empty_like(key_ranks)
        parts = {
            "combine_postings": {
                "ms": cuda_ms(lambda: txo.launch_combine_postings(
                    r.ranks, r.bounds, plan.programs, out_w, out_c,
                    plan.tiles, plan.tile_w), flush),
                "plain_ms": cuda_ms(lambda: tx.combine_postings_ref(
                    r.ranks, r.bounds, plan.programs, plan.tiles,
                    plan.tile_w), flush)},
            "bits_to_keys": {
                "ms": cuda_ms(lambda: txo.launch_bits_to_keys(
                    words, offsets, r.universe, out_k, plan.tiles,
                    plan.tile_w, out_r), flush),
                "plain_ms": cuda_ms(lambda: tx.bits_to_keys_ref(
                    words, r.universe, ranks), flush)}}
        # distinct keys = distinct universe entries hit (a bijection)
        n_hit = torch.unique(keys).numel() if r.universe is not None else 0
        for part, (ms, by) in keys_bound(plan, keys.numel(), n_hit,
                                         ranks).items():
            parts[part].update(bound_ms=ms, bound_by=by)
        # the work around the kernels
        seen, distinct = set(), []
        for row in rows:
            for leaf in row:
                if id(leaf) not in seen:
                    seen.add(id(leaf))
                    distinct.append(np.asarray(leaf).astype(np.int64))
        host = np.concatenate(distinct)
        on_card = torch.from_numpy(host).to(device)
        if progs is None:
            def entry():
                return tx.intersect_keys(rows, n_docs=n_docs, device=device)
        else:
            def entry():
                return tx.combine_keys(rows, progs, groups=groups,
                                       device=device, lengths=lengths)
        cp, bk = parts["combine_postings"], parts["bits_to_keys"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "kernels": ["combine_postings", "bits_to_keys"],
            "entry": route, "shape": main["shapes"][route],
            "ranks": ranks,
            "launches": main["launches"][route],
            "max_abs_err": errs[route], "bit_exact": errs[route] == 0,
            "ms": cp["ms"] + bk["ms"],
            "plain_ms": cp["plain_ms"] + bk["plain_ms"],
            "bound_ms": cp["bound_ms"] + bk["bound_ms"],
            "bound_by": max((cp, bk), key=lambda p: p["bound_ms"])[
                "bound_by"],
            "library_ms": None, "parts": parts,
            "h2d_bytes": host.nbytes,
            "h2d_ms": cuda_ms(lambda: torch.from_numpy(host).to(device),
                              flush),
            "universe_ms": None if n_docs is not None else cuda_ms(
                lambda: torch.searchsorted(torch.unique(on_card), on_card,
                                           out_int32=True), flush),
            "d2h_bytes": keys.numel() * 8,
            "d2h_ms": cuda_ms(lambda: keys.cpu(), flush),
            "plan_ms": host_ms(lambda: txo.plan_keys(rows, progs, n_docs,
                                                     device, lengths)),
            "entry_ms": host_ms(entry),
            "routes": {"bitmap": dict(
                bitmap[name], kernel=BITMAP_KERNEL[name],
                launches=main["launches"][name])}})
    return kernels


# ------------------------------------------------------------ attention
def attn_inputs(gen, shape_q, shape_kv, dtype, device):
    import torch
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for shape in (shape_q, shape_kv, shape_kv))


def attn_compare(ta, name: str, q, k, v, **kw) -> float:
    """Kernel vs plain attention on the card; raises above ATTN_TOL."""
    import torch
    got = ta.attention(q, k, v, device=q.device, **kw)
    want = ta.attention(q, k, v, impl="ref", device=q.device, **kw)
    torch.cuda.synchronize()
    dtype = str(q.dtype).removeprefix("torch.")
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = float((got.float() - want.float()).abs().max())
    if not err <= ATTN_TOL[dtype]:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version by {err} (> {ATTN_TOL[dtype]})")
    return err


def attn_edge_phase(ta, device, seed: int) -> dict[str, float]:
    """Small shapes: causal, window, bidirectional, S < T end-aligned,
    ragged S and T, S = 1 against a cache with empty (-1) slots, GQA
    g = 1, 4, 8 and 48, head sizes 32/64/128, bfloat16 and float32. In
    bfloat16 both device kernels run (`ta.plan`); the 2032-slot decode
    cases leave the splits past the query's slot wholly empty."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    cases = [  # B, S, T, H, KV, dh, causal, window, decode slots
        (1, 128, 128, 2, 2, 64, True, None, False),
        (2, 256, 256, 8, 1, 128, True, None, False),
        (1, 100, 300, 8, 1, 64, True, None, False),
        (2, 77, 77, 4, 2, 128, True, 32, False),
        (1, 130, 130, 2, 2, 64, False, None, False),
        (1, 5, 3, 2, 1, 32, False, None, False),
        (3, 1, 77, 8, 1, 128, True, None, True),
        (2, 1, 200, 16, 2, 64, True, 50, True),
        (4, 1, 2032, 64, 8, 128, True, None, True),
        (1, 300, 300, 32, 8, 128, True, None, False),
        (2, 1, 2032, 32, 8, 128, True, None, True),
        # granite-20b's MQA, g = 48: a ragged prefill of a RAG prompt, and
        # a decode step (48 rows on one KV head) in a padded cache
        (1, 101, 101, 48, 1, 128, True, None, False),
        (1, 1, 117, 48, 1, 128, True, None, True),
    ]
    errs = dict.fromkeys(ATTN_TOL, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, T, H, KV, dh, causal, window, slots in cases:
            q, k, v = attn_inputs(gen, (B, S, H, dh), (B, T, KV, dh), dtype,
                                  device)
            kw = {"causal": causal, "window": window}
            if slots:        # one query at pos, slots past it empty
                pos = T * 2 // 3
                kpos = torch.arange(T, dtype=torch.int32, device=device)
                kpos[pos + 1:] = -1
                kw.update(q_positions=kpos[pos:pos + 1].clone(),
                          kv_positions=kpos)
            name = f"attn {dtype} {(B, S, T, H, KV, dh, causal, window)}"
            key = str(dtype).removeprefix("torch.")
            errs[key] = max(errs[key], attn_compare(ta, name, q, k, v, **kw))
    from repro_torch.kernels.attention.cases import position_cases
    positioned = position_cases(device)
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, S, T, H, KV, dh), kw in positioned:
            q, k, v = attn_inputs(gen, (B, S, H, dh), (B, T, KV, dh), dtype,
                                  device)
            key = str(dtype).removeprefix("torch.")
            errs[key] = max(errs[key], attn_compare(
                ta, f"attn {dtype} {name} {(B, S, T, H, KV, dh)}", q, k, v,
                **kw))
    emit({"phase": "attn_edge", "cases": 2 * (len(cases) + len(positioned)),
          "position_cases": [name for name, _, _ in positioned],
          "max_abs_err": errs, "tolerance": ATTN_TOL})
    return errs


def int8_edge_phase(ta, device) -> dict[str, float]:
    """`flash_decode_int8` vs `attention_int8_ref` on the int8 edge cases
    (`kernels.attention.cases.int8_cases`), bf16 and float32 queries, by
    each route that takes the case (the bare launch with `route=`):
    within INT8_TOL[dtype] of the output's scale."""
    import torch
    from repro_torch.kernels.attention import kernel as tk
    from repro_torch.kernels.attention.cases import int8_cases, int8_inputs
    errs, by_route, routes = {}, {}, {}
    cases = int8_cases(device)
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        errs[key] = 0.0
        for i, (name, shape, kw) in enumerate(cases):
            B, S, T, H, KV, dh = shape
            q, k8, v8, ks, vs = int8_inputs(shape, i, device, dtype)
            want = ta.attention_int8(q, k8, v8, ks, vs, device=device,
                                     impl="ref", **kw)
            plan = tk.plan_int8(B, T, KV, S * H // KV, dh)
            routes[name] = {"planned": list(plan),
                            "ran": ["cluster", "split"]
                            if plan[0] == "cluster" else ["split"]}
            for route in routes[name]["ran"]:
                got = torch.empty_like(q)
                ta.launch_int8(q, k8, v8, ks, vs, got, kw.get("causal", True),
                               kw.get("window"), kw["q_positions"],
                               kw["kv_positions"], route=route)
                torch.cuda.synchronize()
                rel = float((got.float() - want.float()).abs().max()) / max(
                    float(want.float().abs().max()), 1e-12)
                if not rel <= INT8_TOL[key]:
                    raise AssertionError(f"flash_decode_int8 {name} {key} "
                                         f"({route}): {rel} of the scale "
                                         f"(> {INT8_TOL[key]})")
                errs[key] = max(errs[key], rel)
                by_route[f"{route} {key}"] = max(
                    by_route.get(f"{route} {key}", 0.0), rel)
    emit({"phase": "int8_edge", "cases": 2 * len(cases),
          "runs": 2 * sum(len(r["ran"]) for r in routes.values()),
          "routes": routes, "max_err_over_scale": errs,
          "max_err_by_route": by_route, "tolerance": INT8_TOL})
    return errs


def attn_bwd_edge_phase(ta, device) -> dict[str, float]:
    """`flash_bwd` vs `attention_bwd_ref` on the backward edge cases
    (`kernels.attention.cases.bwd_cases`: causal, window, positions per
    row, g = 1, 8 and 48, dh 32, 64 and 128, S ragged and S = 1, cross
    attention with S != T, the encoder's non-causal items), float32
    and bf16: the largest error of dq, dk and dv over their joint scale,
    within BWD_TOL. Each case runs with the log-sum-exp recomputed by the
    pre-pass and, where the forward kernel writes it (`forward_lse`: bf16
    prefill, as on the train path), once more with the forward's."""
    import torch
    from repro_torch.kernels.attention.cases import (bwd_cases, bwd_inputs,
                                                     kv_len)
    errs, routes, handed = {}, {}, {}
    cases = bwd_cases(device)
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        errs[key] = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
        handed[key] = []
        ta.reset_launches()
        for i, (name, shape, kw) in enumerate(cases):
            q, k, v, do = bwd_inputs(shape, i, device, dtype,
                                     T=kv_len(shape, kw))
            out = ta.attention(q, k, v, device=device, **kw)
            runs = [ta.attention_bwd(q, k, v, out, do, device=device, **kw)]
            want = ta.attention_bwd(q, k, v, out, do, device=device,
                                    impl="ref", **kw)
            if ta.forward_lse(q, k):
                lse = torch.empty(q.shape[:3], dtype=torch.float32,
                                  device=device)
                out_l = ta.flash_attention(q, k, v, lse=lse, **kw)
                if not torch.equal(out_l, out):
                    raise AssertionError(f"flash_attention {name} {key}: "
                                         "the output moved with lse=")
                runs.append(ta.flash_bwd(q, k, v, out, do, lse=lse, **kw))
                handed[key].append(name)
            torch.cuda.synchronize()
            scale = max(float(w.float().abs().max()) for w in want)
            for got, how in zip(runs, ("recomputed", "forward's")):
                for grad, g, w in zip(("dq", "dk", "dv"), got, want):
                    rel = float((g.float() - w.float()).abs().max()) / scale
                    if not (g.dtype == dtype and rel <= BWD_TOL[key]):
                        raise AssertionError(
                            f"flash_bwd {name} {key} {grad} ({how} lse): "
                            f"{rel} of the gradients' scale "
                            f"(> {BWD_TOL[key]})")
                    errs[key][grad] = max(errs[key][grad], rel)
        routes[key] = dict(ta.BWD_ROUTES)
        want = {ta.plan_bwd(dtype, shape[4]) for _, shape, _ in cases}
        if set(routes[key]) != want or sum(routes[key].values()) != \
                len(cases) + len(handed[key]):
            raise AssertionError(f"flash_bwd {key} routes {routes[key]}")
    if not handed["bfloat16"] or handed["float32"]:
        raise AssertionError(f"forward lse handed over in {handed}")
    emit({"phase": "attn_bwd_edge", "cases": 2 * len(cases),
          "names": [c[0] for c in cases], "max_err_over_scale": errs,
          "routes": routes, "forward_lse_cases": handed,
          "tolerance": BWD_TOL})
    return {key: max(e.values()) for key, e in errs.items()}


def teacher_forced(model, params, prompt, tokens):
    """Prefill + decode fed `tokens` (B, n): logits (n + 1, B, vocab)."""
    import torch
    from repro_torch.launch.serve import prefill
    n = tokens.shape[1]
    logits, cache = prefill(model, params, prompt, n)
    steps = [logits]
    for t in range(n):
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": tokens[:, t:t + 1]})
        steps.append(logits)
    return torch.stack(steps)


def logits_versus(kern, plain) -> dict:
    """Two runs' logits (steps, B, vocab): the largest difference over the
    largest |logit|, per step too, and the share of equal argmaxes."""
    import torch
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise AssertionError("teacher-forced logits are not finite")
    diff = (kern - plain).abs()
    return {"max_err_over_max_logit": float(diff.max())
            / float(plain.abs().max()),
            "per_step": (diff.amax(dim=(1, 2))
                         / plain.abs().amax(dim=(1, 2))).tolist(),
            "argmax_agreement": float((kern.argmax(-1) == plain.argmax(-1))
                                      .float().mean()),
            "max_logit": float(plain.abs().max()), "tolerance": LM_TOL}


def lm_phase(args, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as ta
    from repro_torch.launch.serve import decode_loop
    from repro_torch.models import build_model, init_params, param_count
    from repro_torch.models.transformer import TransformerModel

    cfg = get_config(LM_ARCH).with_(n_layers=args.lm_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model.param_desc(),
                         torch.Generator(device=device).manual_seed(args.seed),
                         device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.from_numpy(np.random.default_rng(args.seed).integers(
        4, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    decode_loop(model, params, prompt[:, :64], 2)          # warm-up

    # ---- the main path: counts zeroed before, read after -------------
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = decode_loop(model, params, prompt, LM_TOKENS)
    launches = ta.LAUNCHES["flash_attention"]
    shapes = dict(ta.LAUNCH_SHAPES)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------

    want = cfg.n_layers * (1 + LM_TOKENS)
    if launches != want:
        raise AssertionError(f"flash_attention launched {launches} times on "
                             f"the LM path, expected {want}")
    if out.logits.shape != (LM_BATCH, cfg.vocab) \
            or out.tokens.shape != (LM_BATCH, LM_TOKENS) \
            or not torch.isfinite(out.logits).all():
        raise AssertionError("decode_loop gave malformed or non-finite "
                             "logits")

    # the same prefill + decode, kernel vs plain attention, teacher-forced
    t0 = time.perf_counter()
    kern = teacher_forced(model, params, prompt, out.tokens)
    plain = teacher_forced(TransformerModel(cfg, attn_impl="ref"), params,
                           prompt, out.tokens)
    versus = logits_versus(kern, plain)
    versus["wall_s"] = time.perf_counter() - t0
    rel = versus["max_err_over_max_logit"]
    repeat = float((kern[-1] - out.logits).abs().max())
    emit({"phase": "lm", "arch": LM_ARCH, "layers": cfg.n_layers,
          "layers_published": get_config(LM_ARCH).n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv,
          "head_dim": cfg.dh, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "params": param_count(params), "init_s": init_s,
          "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_TOKENS,
          "cache_slots": LM_PROMPT + LM_TOKENS,
          "prefill_s": out.prefill_s, "decode_s": out.decode_s,
          "decode_s_per_token": out.decode_s / LM_TOKENS,
          "decode_tok_per_s": LM_BATCH * LM_TOKENS / out.decode_s,
          "peak_device_bytes": peak_bytes,
          "attention_launches": launches,
          "attention_shapes": {str(k): v for k, v in shapes.items()},
          "greedy_tokens": out.tokens.tolist(),
          "vs_plain_attention": versus,
          "decode_loop_vs_forced_rerun_max_abs": repeat})
    if not rel <= LM_TOL:
        raise AssertionError(f"LM logits through the kernel differ from the "
                             f"plain attention by {rel} of their scale "
                             f"(> {LM_TOL})")
    if args.profile:
        lm_profile(model, params, prompt)
    roofline = lm_roofline(model, params, prompt, out.tokens)
    sharded = sharded_lm_run(cfg, params, prompt, out.tokens, device)
    return {"launches": launches, "shapes": shapes, "sharded": sharded,
            "roofline": roofline, "layers": cfg.n_layers,
            "prefill_s": out.prefill_s,
            "decode_step_s": out.decode_s / LM_TOKENS}


def _device_time(prof):
    """The card's busy µs (the union of its kernels' intervals), its event
    count, and µs and count by kernel name, from a torch.profiler run."""
    import torch
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + end - start, count + 1)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):              # union of intervals
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us, len(spans), by_name


def lm_profile(model, params, prompt, steps: int = 4,
               phase: str = "lm_profile") -> None:
    """torch.profiler over one prefill and then `steps` decode steps: the
    card's busy time against the host's wall time for the same work, and
    the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import prefill

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        return out, wall_us, _device_time(prof)

    (logits, cache), pre_wall, (pre_busy, _, pre_names) = traced(
        lambda: prefill(model, params, prompt, steps + 1))
    logits, cache = model.decode_step(                      # warm-up step
        params, cache, {"tokens": logits.argmax(-1).to(torch.int32)[:, None]})

    def decode():
        nonlocal logits, cache
        for _ in range(steps):
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": tok})
    _, wall_us, (busy_us, events, by_name) = traced(decode)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    pre_top = sorted(pre_names.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": phase, "decode_steps": steps,
          "host_wall_us_per_step": wall_us / steps,
          "device_busy_us_per_step": busy_us / steps,
          "device_idle_share": 1 - busy_us / wall_us if events else None,
          "device_events": events,
          "top_kernels_us_per_step": [[name[:90], us / steps, n / steps]
                                      for name, (us, n) in top],
          "prefill": {"host_wall_us": pre_wall, "device_busy_us": pre_busy,
                      "device_idle_share": 1 - pre_busy / pre_wall,
                      "top_kernels_us": [[name[:90], us, n] for name, (us, n)
                                         in pre_top]}})


def attn_bound(qpos, kpos, B, S, T, H, KV, dh, nbytes_el, causal=True,
               window=None) -> tuple:
    """Least card time (ms) for one attention call on these positions
    ((S,)/(T,) shared by the batch, or (B, S)/(B, T)): 4·dh flops per
    allowed (query, key) pair and head over the bf16 (or float32) rate,
    against q, k, v, o and positions moved once over HBM bandwidth; the
    larger, and which it is. The pairs are counted from the positions;
    `launch.roofline.attn_cost` gives the work."""
    from repro_torch.kernels.attention.ref import _allowed
    from repro_torch.launch import roofline as rl
    pairs = int(_allowed(B, S, T, causal, window, qpos, kpos,
                         qpos.device).sum())
    flops, nbytes = rl.attn_cost(B, S, T, H, KV, dh, nbytes_el, causal,
                                 window, pairs=pairs,
                                 pos_elems=qpos.numel() + kpos.numel())
    return float_bound(flops, nbytes, nbytes_el)


def float_bound(flops, nbytes, nbytes_el: int, rate=None) -> tuple:
    """(ms, "operations" or "bytes", flops, bytes): the larger of `flops`
    over `rate` (the bf16 tensor-core rate for 2-byte elements, else the
    float32 rate) and `nbytes` over HBM bandwidth."""
    from repro_torch.launch import roofline as rl
    if rate is None:
        rate = rl.BF16_FLOPS_PER_S if nbytes_el == 2 else rl.F32_FLOPS_PER_S
    t_ops, t_bytes = flops / rate, nbytes / rl.HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def attn_time_shape(ta, flush, gen, name: str, key: tuple, kw: dict,
                    launches: int) -> dict:
    """The kernel at one shape and set of positions (`kw`: causal,
    window, q_positions, kv_positions): checked against the plain version,
    then the bare launch, the plain version and one SDPA call timed
    (CUDA events, L2 flushed), beside the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention.ref import _allowed
    B, S, T, H, KV, dh, dtype_name = key
    dev = flush.device
    q, k, v = attn_inputs(gen, (B, S, H, dh), (B, T, KV, dh),
                          getattr(torch, dtype_name), dev)
    qpos, kpos = kw["q_positions"], kw["kv_positions"]
    causal, window = kw["causal"], kw.get("window")
    err = attn_compare(ta, f"flash_attention {name} {key}", q, k, v, **kw)
    out = torch.empty_like(q)
    kernel_ms = cuda_ms(lambda: ta.launch(q, k, v, out, causal, window,
                                          qpos, kpos), flush)
    # the prefill kernel also writing the rows' log-sum-exp, as the train
    # path's forward runs it
    lse_ms = None
    if ta.forward_lse(q, k):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
        lse_ms = cuda_ms(lambda: ta.launch(q, k, v, out, causal, window,
                                           qpos, kpos, lse), flush)
    plain_ms = cuda_ms(lambda: ta.attention_ref(q, k, v, **kw), flush)
    # the library yardstick: one SDPA call, (B, H, S, dh) views; causal
    # where the positions are the shared arange(S) of a prefill, no mask
    # where every pair may attend, else the allowed pairs as a mask
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ok = _allowed(B, S, T, causal, window, qpos, kpos, dev)
    arange = qpos.dim() == 1 and kpos.dim() == 1 and S == T and \
        torch.equal(qpos, kpos) and torch.equal(
            qpos.long(), torch.arange(S, device=dev))
    if bool(ok.all()):
        sdpa = lambda: F.scaled_dot_product_attention(    # noqa: E731
            qt, kt, vt, enable_gqa=True)
        mask = "none"
    elif causal and window is None and arange:
        sdpa = lambda: F.scaled_dot_product_attention(    # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        mask = "is_causal"
    else:
        allowed = ok[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(    # noqa: E731
            qt, kt, vt, attn_mask=allowed, enable_gqa=True)
        mask = "bool (B, 1, S, T)"
    del ok
    sdpa_err = float((sdpa().transpose(1, 2).float()
                      - out.float()).abs().max())
    library_ms = cuda_ms(sdpa, flush)
    bound_ms, bound_by, flops, nbytes = attn_bound(
        qpos, kpos, B, S, T, H, KV, dh, q.element_size(), causal, window)
    kernel, n_split, _ = (ta.plan(B, S, T, H, KV) if dtype_name ==
                          "bfloat16" else ("float32", 1, T))
    return {
        "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "dh": dh,
                  "dtype": dtype_name},
        "causal": causal, "window": window,
        "positions": "per row" if qpos.dim() == 2 or kpos.dim() == 2
        else "shared",
        "kernel": kernel, "n_split": n_split,
        "launches": launches, "ms": kernel_ms, "ms_with_lse": lse_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms, "library": "scaled_dot_product_attention"
        f"(enable_gqa=True, mask {mask})", "library_max_abs_diff": sdpa_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
        "bytes": nbytes, "max_abs_err": err,
        "share_of_bound": bound_ms / kernel_ms}


def attn_timing_phase(ta, device, seed: int, shapes: dict,
                      edge_errs: dict) -> dict:
    """Time the kernel at the LM path's prefill and decode shapes."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    picked = {}
    for key in shapes:
        picked["decode" if key[1] == 1 else "prefill"] = key
    out_shapes = {}
    errs = dict(edge_errs)
    for kind, key in sorted(picked.items(), reverse=True):
        B, S, T, H, KV, dh, dtype_name = key
        kpos = torch.arange(T, dtype=torch.int32, device=device)
        # prefill: the model's arange positions; decode: the last step of
        # the main path, one query at T - 1 against a full cache
        qpos = kpos.clone() if S == T else kpos[T - S:].clone()
        out_shapes[kind] = attn_time_shape(
            ta, flush, gen, kind, key,
            {"causal": True, "q_positions": qpos, "kv_positions": kpos},
            shapes[key])
        errs[dtype_name] = max(errs[dtype_name],
                               out_shapes[kind]["max_abs_err"])
    main = out_shapes["prefill"]
    return {"name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ATTN_REPLACES,
            "launches": sum(shapes.values()),
            "max_abs_err": max(errs.values()),
            "max_abs_err_by_dtype": errs, "tolerance": ATTN_TOL,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "at": "prefill",
            "shapes": out_shapes}


# ------------------------------------------------------------------ wkv
def wkv_inputs(gen, B, S, H, dh, dtype, device, decay="uniform"):
    """r, k, v (dtype), w, u and s0 (float32): the JAX package's test
    distributions. `decay` "uniform" draws w in (0.5, 0.999); "model"
    draws the model's kind of decay, exp(-exp(N(0, 1))), with key 0 held
    at exactly 1 and key 1 at exactly 0 on every step."""
    import torch

    def normal(shape, std):
        return std * torch.randn(shape, generator=gen, device=device)
    r, k, v = (normal((B, S, H, dh), std).to(dtype) for std in (1, 0.3, 1))
    if decay == "uniform":
        w = 0.5 + 0.499 * torch.rand((B, S, H, dh), generator=gen,
                                     device=device)
    else:
        w = torch.exp(-torch.exp(normal((B, S, H, dh), 1.0)))
        w[..., 0], w[..., 1] = 1.0, 0.0
    return r, k, v, w, normal((H, dh), 0.3), normal((B, H, dh, dh), 0.1)


def wkv_compare(tr, name: str, r, k, v, w, u, s0) -> tuple[float, float]:
    """Kernel vs plain wkv on the card: the largest absolute difference
    and the largest over the plain version's largest |value|, each of out
    and the final state; raises above WKV_TOL."""
    import torch
    got = tr.wkv(r, k, v, w, u, s0, device=r.device)
    want = tr.wkv(r, k, v, w, u, s0, impl="ref", device=r.device)
    torch.cuda.synchronize()
    abs_err = scaled = 0.0
    for what, g, p in zip(("out", "s_fin"), got, want):
        if g.shape != p.shape or g.dtype != p.dtype:
            raise AssertionError(f"{name} {what}: {g.shape}/{g.dtype} vs "
                                 f"{p.shape}/{p.dtype}")
        err = float((g - p).abs().max())
        rel = err / max(float(p.abs().max()), 1e-30)
        if not rel <= WKV_TOL:
            raise AssertionError(f"{name} {what}: kernel disagrees with the "
                                 f"plain version by {rel} of its scale "
                                 f"(> {WKV_TOL})")
        abs_err, scaled = max(abs_err, err), max(scaled, rel)
    return abs_err, scaled


def wkv_edge_cases(tr) -> list[tuple]:
    """(B, S, H, dh, dtype name, decay) of the `wkv_edge` phase: the grid
    S in {1, 37, 128, 2000} × head sizes × bf16/float32 r/k/v at uniform
    decays; then the model's decays (with keys held at w = 0 and w = 1) at
    S = 1 and on either side of the prefill kernel's chunk T (T - 1, T,
    T + 1, 2T + 1); then B·H = 270 (6 × 45: at dh 64, 270 prefill blocks,
    two to an SM, and 540 decode blocks), whose blocks leave the last wave
    of the card part empty, at S = 37 and 1. Each case runs with and
    without s0."""
    T = tr.kernel.CHUNK
    cases = [(2, S, 3, dh, dtype, "uniform") for S in (1, 37, 128, 2000)
             for dh in tr.HEAD_DIMS for dtype in ("float32", "bfloat16")]
    cases += [(2, S, 3, dh, dtype, "model")
              for S in (1, T - 1, T, T + 1, 2 * T + 1)
              for dh in tr.HEAD_DIMS for dtype in ("float32", "bfloat16")]
    cases += [(6, S, 45, 64, "bfloat16", "model") for S in (37, 1)]
    return cases


def wkv_edge_phase(tr, device, seed: int) -> dict:
    """Every case of `wkv_edge_cases`, kernel against plain, out and final
    state within WKV_TOL of their scale."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    errs = {"max_abs_err": 0.0, "max_scaled_err": 0.0}
    cases = 0
    kernels = set()
    for B, S, H, dh, dtype_name, decay in wkv_edge_cases(tr):
        dtype = getattr(torch, dtype_name)
        kernels.add(tr.plan(B, S, H, dh, dtype).kernel)
        r, k, v, w, u, s0 = wkv_inputs(gen, B, S, H, dh, dtype, device,
                                       decay)
        for init in (None, s0):
            a, rel = wkv_compare(
                tr, f"wkv {(B, S, H, dh)} {dtype_name} {decay} s0="
                f"{init is not None}", r, k, v, w, u, init)
            errs["max_abs_err"] = max(errs["max_abs_err"], a)
            errs["max_scaled_err"] = max(errs["max_scaled_err"], rel)
            cases += 1
    emit({"phase": "wkv_edge", "cases": cases, "kernels": sorted(kernels),
          **errs, "tolerance": WKV_TOL})
    return errs


def rwkv_phase(args, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv as tr
    from repro_torch.launch.serve import decode_loop
    from repro_torch.models import (RWKVModel, build_model, init_params,
                                    param_count)
    from repro_torch.models.common import tree_map

    t_phase = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model.param_desc(),
                         torch.Generator(device=device).manual_seed(args.seed),
                         device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.from_numpy(np.random.default_rng(args.seed).integers(
        4, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    decode_loop(model, params, prompt[:, :64], 2)          # warm-up

    # ---- the main path: counts zeroed before, read after -------------
    tr.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = decode_loop(model, params, prompt, LM_TOKENS)
    launches = tr.LAUNCHES["wkv"]
    shapes = dict(tr.LAUNCH_SHAPES)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------

    want = cfg.n_layers * (1 + LM_TOKENS)
    if launches != want:
        raise AssertionError(f"wkv launched {launches} times on the RWKV "
                             f"path, expected {want}")
    if out.logits.shape != (LM_BATCH, cfg.vocab) \
            or out.tokens.shape != (LM_BATCH, LM_TOKENS) \
            or not torch.isfinite(out.logits).all():
        raise AssertionError("decode_loop gave malformed or non-finite "
                             "logits")

    def versus_plain(cfg_, params_):
        """Teacher-forced logits through the kernel and the plain wkv:
        their largest difference over the largest |logit|, per step too,
        the share of equal argmaxes, and both logits."""
        kern = teacher_forced(RWKVModel(cfg_), params_, prompt, out.tokens)
        plain = teacher_forced(RWKVModel(cfg_, wkv_impl="ref"), params_,
                               prompt, out.tokens)
        torch.cuda.synchronize()
        if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
            raise AssertionError("teacher-forced logits are not finite")
        diff = (kern - plain).abs()
        return {"max_err_over_max_logit": float(diff.max())
                / float(plain.abs().max()),
                "per_step": (diff.amax(dim=(1, 2))
                             / plain.abs().amax(dim=(1, 2))).tolist(),
                "argmax_agreement": float((kern.argmax(-1)
                                           == plain.argmax(-1)).float()
                                          .mean()),
                "max_logit": float(plain.abs().max())}, kern

    # the same prefill + decode, kernel vs plain wkv, teacher-forced, in
    # bf16 and float32 at several depths
    checks, repeat = [], None
    for dtype, layers, tol in RWKV_CHECKS:
        n = min(layers or cfg.n_layers, cfg.n_layers)
        t0 = time.perf_counter()
        sliced = params if n == cfg.n_layers else {
            **params, "layers": tree_map(lambda a: a[:n], params["layers"])}
        if dtype == "float32":
            sliced = tree_map(lambda a: a.float(), sliced)
        res, kern = versus_plain(cfg.with_(n_layers=n), sliced)
        if dtype == "bfloat16" and n == cfg.n_layers:
            repeat = float((kern[-1] - out.logits).abs().max())
        del sliced, kern
        checks.append({"dtype": dtype, "layers": n, **res, "tolerance": tol,
                       "wall_s": time.perf_counter() - t0})
    emit({"phase": "rwkv", "arch": RWKV_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "head_dim": cfg.rwkv_head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "params": param_count(params),
          "init_s": init_s, "batch": LM_BATCH, "prompt": LM_PROMPT,
          "new_tokens": LM_TOKENS,
          "prefill_s": out.prefill_s, "decode_s": out.decode_s,
          "decode_s_per_token": out.decode_s / LM_TOKENS,
          "decode_tok_per_s": LM_BATCH * LM_TOKENS / out.decode_s,
          "peak_device_bytes": peak_bytes, "wkv_launches": launches,
          "wkv_shapes": {str(k): v for k, v in shapes.items()},
          "greedy_tokens": out.tokens.tolist(),
          "vs_plain_wkv": checks,
          "decode_loop_vs_forced_rerun_max_abs": repeat,
          "wall_s": time.perf_counter() - t_phase})
    for c in checks:
        if c["tolerance"] is not None \
                and not c["max_err_over_max_logit"] <= c["tolerance"]:
            raise AssertionError(
                f"RWKV {c['dtype']} logits at {c['layers']} layers through "
                f"the kernel differ from the plain wkv by "
                f"{c['max_err_over_max_logit']} of their scale "
                f"(> {c['tolerance']})")
    if args.profile:
        lm_profile(model, params, prompt, phase="rwkv_profile")
    return {"launches": launches, "shapes": shapes}


def wkv_bound(B, S, H, dh, nbytes_el, with_s0) -> tuple:
    """Least card time (ms) for one wkv call: r, k, v read once at their
    width, w read and out written in float32, u, s0 (when given) and
    s_fin in float32, over HBM bandwidth, against 2·dh² FMAs per (b, t,
    h) over the float32 rate (`launch.roofline.wkv_cost`); the larger,
    and which it is."""
    from repro_torch.launch import roofline as rl
    return float_bound(*rl.wkv_cost(B, S, H, dh, nbytes_el, with_s0), 4)


def wkv_timing_phase(tr, device, seed: int, shapes: dict,
                     edge_errs: dict) -> dict:
    """Time the kernel at the RWKV path's prefill and decode shapes."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    picked = {}
    for key in shapes:
        picked["decode" if key[1] == 1 else "prefill"] = key
    out_shapes = {}
    errs = dict(edge_errs)
    for kind, key in sorted(picked.items(), reverse=True):
        B, S, H, dh, dtype_name, with_s0 = key
        r, k, v, w, u, s0 = wkv_inputs(gen, B, S, H, dh,
                                       getattr(torch, dtype_name), device)
        s0 = s0 if with_s0 else None
        err, rel = wkv_compare(tr, f"wkv {kind} {key}", r, k, v, w, u, s0)
        errs["max_abs_err"] = max(errs["max_abs_err"], err)
        errs["max_scaled_err"] = max(errs["max_scaled_err"], rel)
        out = torch.empty(r.shape, dtype=torch.float32, device=device)
        s_fin = torch.empty((B, H, dh, dh), dtype=torch.float32,
                            device=device)

        def kernel():
            tr.launch(r, k, v, w, u, s0, out, s_fin)
        kernel_ms = cuda_ms(kernel, flush)
        run = tr.plan(B, S, H, dh, r.dtype)
        kernel_device_ms = device_ms(kernel, flush, f"wkv_{run.kernel}")
        # the plain version walks S steps from Python: fewer repeats
        slow = S > 100
        plain_ms = cuda_ms(lambda: tr.wkv_ref(r, k, v, w, u, s0), flush,
                           iters=5 if slow else 30, warmup=1 if slow else 5)
        bound_ms, bound_by, flops, nbytes = wkv_bound(
            B, S, H, dh, r.element_size(), with_s0)
        out_shapes[kind] = {
            "shape": {"B": B, "S": S, "H": H, "dh": dh, "dtype": dtype_name,
                      "s0": with_s0},
            "kernel": f"wkv_{run.kernel}", "plan": run._asdict(),
            "launches": shapes[key], "ms": kernel_ms,
            "device_ms": kernel_device_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes, "max_abs_err": err,
            "max_scaled_err": rel, "share_of_bound": bound_ms / kernel_ms,
            "device_share_of_bound": bound_ms / kernel_device_ms}
    main = out_shapes["prefill"]
    return {"name": "wkv", "route": "cuda", "source": WKV_SOURCE,
            "replaces": WKV_REPLACES, "launches": sum(shapes.values()),
            "max_abs_err": errs["max_abs_err"],
            "max_scaled_err": errs["max_scaled_err"], "tolerance": WKV_TOL,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "at": "prefill",
            "shapes": out_shapes}


# ----------------------------------------------------------- selective scan
def scan_inputs(gen, B, S, D, N, device):
    """a in (0.4, 0.99), b, c and h0 normal (float32): the JAX package's
    test distributions."""
    import torch

    def normal(shape, std):
        return std * torch.randn(shape, generator=gen, device=device)
    a = 0.4 + 0.59 * torch.rand((B, S, D, N), generator=gen, device=device)
    return (a, normal((B, S, D, N), 0.3), normal((B, S, N), 1.0),
            normal((B, D, N), 0.1))


def scan_fused_inputs(gen, B, S, D, N, dtype, device, edge=False):
    """The fused scan's inputs as the model draws them: dt = softplus(N(0,
    1)) float32, A = -exp(A_log) with A_log ~ 0.5·N(0, 1) (its init), x
    ~ N(0, 1) in `dtype`, and B_ and C_ strided slices of one (B, S, 5 +
    2N) projection in `dtype`, as the model slices its x projection; D
    about 1 and h0 ~ 0.1·N(0, 1) float32. With `edge`, three keys reach
    exp's denormal range: d = 1 has dt·A = -95 (a denormal) and x = 0, so
    its state decays through denormals to 0; d = 2 has dt·A = -110 (a =
    0); d = 3 sweeps dt·A from -80 across both edges over n."""
    import torch
    import torch.nn.functional as F

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device)
    dt = F.softplus(normal((B, S, D)))
    A = -torch.exp(0.5 * normal((D, N)))
    x = normal((B, S, D))
    if edge:
        A[1:4] = -1.0
        A[3] = -(1.0 + torch.arange(N, device=device) / 8.0)
        dt[..., 1], dt[..., 2], dt[..., 3] = 95.0, 110.0, 80.0
        x[..., 1] = 0.0
        x[..., 2:4] /= dt[..., 2:4]
    proj = normal((B, S, 5 + 2 * N)).to(dtype)
    return (dt, A, proj[..., 5:5 + N], proj[..., 5 + N:], x.to(dtype),
            1.0 + 0.1 * normal((D,)), 0.1 * normal((B, D, N)))


def scan_check(name: str, got, want) -> tuple[float, float, bool, bool]:
    """A scan kernel's (y, h_fin) against its plain version's on the card:
    the largest absolute difference and the largest over the plain
    version's largest |value|, each of y and the final state, and whether
    the final states and whether the y are bit-exact; raises above
    SCAN_TOL."""
    import torch
    torch.cuda.synchronize()
    abs_err = scaled = 0.0
    for what, g, p in zip(("y", "h_fin"), got, want):
        if g.shape != p.shape or g.dtype != p.dtype:
            raise AssertionError(f"{name} {what}: {g.shape}/{g.dtype} vs "
                                 f"{p.shape}/{p.dtype}")
        if not (torch.isfinite(g).all() and torch.isfinite(p).all()):
            raise AssertionError(f"{name} {what}: not finite")
        err = float((g - p).abs().max())
        rel = err / max(float(p.abs().max()), 1e-30)
        if not rel <= SCAN_TOL:
            raise AssertionError(f"{name} {what}: kernel disagrees with the "
                                 f"plain version by {rel} of its scale "
                                 f"(> {SCAN_TOL})")
        abs_err, scaled = max(abs_err, err), max(scaled, rel)
    return (abs_err, scaled, bool(torch.equal(got[1], want[1])),
            bool(torch.equal(got[0], want[0])))


def scan_compare(ts, name: str, a, b, c, h0) -> tuple:
    """The unfused kernel against the plain scan (`scan_check`)."""
    return scan_check(name, ts.selective_scan(a, b, c, h0, device=a.device),
                      ts.selective_scan(a, b, c, h0, impl="ref",
                                        device=a.device))


def scan_fused_compare(ts, name: str, *args) -> tuple:
    """The fused kernel against its plain version (`scan_check`); args
    are (dt, A, B_, C_, x, D, h0)."""
    dev = args[0].device
    return scan_check(name, ts.selective_scan_fused(*args, device=dev),
                      ts.selective_scan_fused(*args, impl="ref", device=dev))


def scan_edge_phase(ts, device, seed: int) -> dict:
    """The unfused scan: S in {1, 37, 128, 2000} × N in {4, 8, 16} × D in
    {96, 8192} × with and without h0, B = 2. The fused scan: the same grid
    × with and without the D skip × bf16 and float32 x, B_ and C_, on
    `scan_fused_inputs` with its edge keys."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    errs = {"max_abs_err": 0.0, "max_scaled_err": 0.0}
    cases = exact = y_exact = 0
    for S in (1, 37, 128, 2000):
        for N in (4, 8, 16):
            for D in (96, 8192):
                a, b, c, h0 = scan_inputs(gen, 2, S, D, N, device)
                for init in (None, h0):
                    err, rel, same, y_same = scan_compare(
                        ts, f"selective_scan {(2, S, D, N)} h0="
                        f"{init is not None}", a, b, c, init)
                    errs["max_abs_err"] = max(errs["max_abs_err"], err)
                    errs["max_scaled_err"] = max(errs["max_scaled_err"], rel)
                    cases += 1
                    exact += same
                    y_exact += y_same
                del a, b, c, h0
    fused = {"max_abs_err": 0.0, "max_scaled_err": 0.0}
    f_cases, f_exact, f_y_exact = 0, {}, 0
    for S in (1, 37, 128, 2000):
        for N in (4, 8, 16):
            for D in (96, 8192):
                for dtype in (torch.bfloat16, torch.float32):
                    dt, A, B_, C_, x, Dv, h0 = scan_fused_inputs(
                        gen, 2, S, D, N, dtype, device, edge=True)
                    for init in (None, h0):
                        for skip in (None, Dv):
                            err, rel, same, y_same = scan_fused_compare(
                                ts, f"selective_scan_fused {(2, S, D, N)} "
                                f"{dtype} h0={init is not None} "
                                f"D={skip is not None}",
                                dt, A, B_, C_, x, skip, init)
                            fused["max_abs_err"] = max(fused["max_abs_err"],
                                                       err)
                            fused["max_scaled_err"] = max(
                                fused["max_scaled_err"], rel)
                            f_cases += 1
                            key = str(dtype).removeprefix("torch.")
                            f_exact[key] = f_exact.get(key, 0) + same
                            f_y_exact += y_same
                    del dt, A, B_, C_, x, Dv, h0
    emit({"phase": "scan_edge", "cases": cases, **errs,
          "h_fin_bit_exact_cases": exact, "y_bit_exact_cases": y_exact,
          "tolerance": SCAN_TOL,
          "fused": {"cases": f_cases, **fused,
                    "h_fin_bit_exact_cases": sum(f_exact.values()),
                    "h_fin_bit_exact_by_dtype": f_exact,
                    "y_bit_exact_cases": f_y_exact}})
    return {"max_abs_err": max(errs["max_abs_err"], fused["max_abs_err"]),
            "max_scaled_err": max(errs["max_scaled_err"],
                                  fused["max_scaled_err"])}


def _to_float32_in_place(tree) -> None:
    """Each leaf of a parameter tree cast to float32 in place, the old
    leaf dropped as it goes, so that both copies never coexist."""
    import torch
    for key in list(tree):
        if isinstance(tree[key], dict):
            _to_float32_in_place(tree[key])
        else:
            tree[key] = tree[key].float()
            torch.cuda.empty_cache()


def jamba_phase(args, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as ta
    from repro_torch.kernels import ssm as ts
    from repro_torch.launch.serve import decode_loop
    from repro_torch.models import (HybridModel, build_model, init_params,
                                    param_count)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    published = get_config(JAMBA_ARCH)
    if args.jamba_layers % published.attn_every or args.jamba_layers < 1:
        raise SystemExit(f"--jamba-layers must be a multiple of "
                         f"{published.attn_every}")
    cfg = published.with_(n_layers=args.jamba_layers)
    model = build_model(cfg)
    n_attn = cfg.n_layers // cfg.attn_every
    n_mamba = cfg.n_layers - n_attn
    t0 = time.perf_counter()
    params = init_params(model.param_desc(),
                         torch.Generator(device=device).manual_seed(args.seed),
                         device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    prompt = torch.from_numpy(np.random.default_rng(args.seed).integers(
        4, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    decode_loop(model, params, prompt[:, :64], 2)          # warm-up

    # ---- the main path: counts zeroed before, read after -------------
    ts.reset_launches()
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = decode_loop(model, params, prompt, LM_TOKENS)
    scan_launches = ts.LAUNCHES["selective_scan_fused"]
    unfused_launches = ts.LAUNCHES["selective_scan"]
    attn_launches = ta.LAUNCHES["flash_attention"]
    scan_shapes = dict(ts.LAUNCH_SHAPES["selective_scan_fused"])
    attn_shapes = dict(ta.LAUNCH_SHAPES)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------

    for what, got, want in (("selective_scan_fused", scan_launches,
                             n_mamba * (1 + LM_TOKENS)),
                            ("selective_scan", unfused_launches, 0),
                            ("flash_attention", attn_launches,
                             n_attn * (1 + LM_TOKENS))):
        if got != want:
            raise AssertionError(f"{what} launched {got} times on the Jamba "
                                 f"path, expected {want}")
    if out.logits.shape != (LM_BATCH, cfg.vocab) \
            or out.tokens.shape != (LM_BATCH, LM_TOKENS) \
            or not torch.isfinite(out.logits).all():
        raise AssertionError("decode_loop gave malformed or non-finite "
                             "logits")

    # this path's attention (a GQA group of 4) against the plain attention
    # at each shape it launched: prefill at the model's positions; decode
    # at the first step (pos = prompt length, the slots past it empty) and
    # the last (a full cache)
    gen = torch.Generator(device=device).manual_seed(args.seed + 6)
    attn_errs = dict.fromkeys(ATTN_TOL, 0.0)
    for key in attn_shapes:
        B, S, T, H, KV, dh, dtype_name = key
        q, k, v = attn_inputs(gen, (B, S, H, dh), (B, T, KV, dh),
                              getattr(torch, dtype_name), device)
        for pos in ((S - 1,) if S > 1 else (LM_PROMPT, T - 1)):
            kpos = torch.arange(T, dtype=torch.int32, device=device)
            kpos[pos + 1:] = -1
            err = attn_compare(ta, f"flash_attention jamba {key} pos={pos}",
                               q, k, v, causal=True, window=cfg.swa,
                               q_positions=kpos[pos + 1 - S:pos + 1].clone(),
                               kv_positions=kpos)
            attn_errs[dtype_name] = max(attn_errs[dtype_name], err)
        del q, k, v

    def versus_plain(params_, prompt_, tokens_):
        """Teacher-forced logits through the fused kernel and its plain
        version (`scan_impl="ref"`):
        their largest difference over the largest |logit|, per step too,
        the share of equal argmaxes, and the kernel's logits."""
        kern = teacher_forced(model, params_, prompt_, tokens_)
        plain = teacher_forced(HybridModel(cfg, scan_impl="ref"), params_,
                               prompt_, tokens_)
        return logits_versus(kern, plain), kern

    checks = []
    t0 = time.perf_counter()
    res, kern = versus_plain(params, prompt, out.tokens)
    repeat = float((kern[-1] - out.logits).abs().max())
    del kern
    checks.append({"dtype": "bfloat16", "layers": cfg.n_layers,
                   "batch": LM_BATCH, "prompt": LM_PROMPT,
                   "forced_steps": LM_TOKENS, **res,
                   "tolerance": JAMBA_BF16_TOL,
                   "wall_s": time.perf_counter() - t0})
    if args.profile:
        lm_profile(model, params, prompt, phase="jamba_profile")

    # float32: the bf16 and float32 weights together do not fit one card
    t0 = time.perf_counter()
    _to_float32_in_place(params)
    f32_prompt = prompt[:JAMBA_F32_BATCH, :JAMBA_F32_PROMPT]
    res, kern = versus_plain(params, f32_prompt,
                             out.tokens[:JAMBA_F32_BATCH, :JAMBA_F32_TOKENS])
    del kern, params
    torch.cuda.empty_cache()
    checks.append({"dtype": "float32", "layers": cfg.n_layers,
                   "batch": JAMBA_F32_BATCH, "prompt": JAMBA_F32_PROMPT,
                   "forced_steps": JAMBA_F32_TOKENS, **res,
                   "tolerance": JAMBA_F32_TOL,
                   "wall_s": time.perf_counter() - t0})
    emit({"phase": "jamba", "arch": JAMBA_ARCH, "layers": cfg.n_layers,
          "layers_published": published.n_layers, "mamba_layers": n_mamba,
          "attention_layers": n_attn,
          "moe_layers": cfg.n_layers // cfg.moe.every,
          "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv,
          "head_dim": cfg.dh, "d_ff": cfg.d_ff,
          "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
          "d_inner": cfg.mamba.d_inner(cfg.d_model),
          "d_state": cfg.mamba.d_state, "vocab": cfg.vocab,
          "params": n_params, "init_s": init_s, "batch": LM_BATCH,
          "prompt": LM_PROMPT, "new_tokens": LM_TOKENS,
          "prefill_s": out.prefill_s, "decode_s": out.decode_s,
          "decode_s_per_token": out.decode_s / LM_TOKENS,
          "decode_tok_per_s": LM_BATCH * LM_TOKENS / out.decode_s,
          "peak_device_bytes": peak_bytes, "scan_launches": scan_launches,
          "unfused_scan_launches": unfused_launches,
          "scan_shapes": {str(k): v for k, v in scan_shapes.items()},
          "attention_launches": attn_launches,
          "attention_shapes": {str(k): v for k, v in attn_shapes.items()},
          "attention_vs_plain_max_abs_err": attn_errs,
          "greedy_tokens": out.tokens.tolist(), "vs_plain_scan": checks,
          "decode_loop_vs_forced_rerun_max_abs": repeat,
          "wall_s": time.perf_counter() - t_phase})
    for c in checks:
        if not c["max_err_over_max_logit"] <= c["tolerance"]:
            raise AssertionError(
                f"Jamba {c['dtype']} logits through the scan kernel differ "
                f"from the plain scan by {c['max_err_over_max_logit']} of "
                f"their scale (> {c['tolerance']})")
    return {"launches": scan_launches, "shapes": scan_shapes,
            "attn_launches": attn_launches, "attn_errs": attn_errs}


# ------------------------------------------- mixtral, vlm and encdec
def qwen2_vl_positions(grids, n_text: int):
    """Qwen2-VL's position ids (B, S, 3) as numpy int32: an h × w grid of
    image patches at (t, h, w) = (0, row, col), then the text from the
    largest id + 1 with all three ids equal; and each row's next text
    id."""
    import numpy as np
    rows, nxt = [], []
    for h, w in grids:
        r, c = np.divmod(np.arange(h * w), w)
        img = np.stack([np.zeros_like(r), r, c], -1)
        start = max(h, w)
        txt = np.repeat(np.arange(start, start + n_text)[:, None], 3, -1)
        rows.append(np.concatenate([img, txt]))
        nxt.append(start + n_text)
    return np.stack(rows).astype(np.int32), np.array(nxt, np.int32)


def serve_forced(model, params, batch, pad_to: int, extra, n: int,
                 tokens=None):
    """`model.prefill(batch, pad_to)`, then `n` decode steps, each fed its
    token and `extra(t)` (a VLM's M-RoPE ids, else nothing): the greedy
    token where `tokens` is None, else tokens[:, t]. Returns (the tokens
    fed (B, n), logits (n + 1, B, vocab), prefill s, decode s, the
    cache), host clock ending in a device synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, pad_to=pad_to)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps, fed = [logits], []
    for t in range(n):
        tok = (logits.argmax(-1).to(torch.int32)[:, None] if tokens is None
               else tokens[:, t:t + 1])
        fed.append(tok)
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": tok, **extra(t)})
        steps.append(logits)
    torch.cuda.synchronize()
    return (torch.cat(fed, dim=1), torch.stack(steps), t1 - t0,
            time.perf_counter() - t1, cache)


def path_attention_errs(ta, device, seed: int, name: str, shapes: dict,
                        cases) -> dict:
    """The kernel against the plain attention at each shape a path
    launched, on random q, k, v: `cases(key)` gives the path's
    (causal, window, q_positions, kv_positions) at that shape."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    errs = dict.fromkeys(ATTN_TOL, 0.0)
    for key in shapes:
        B, S, T, H, KV, dh, dtype_name = key
        q, k, v = attn_inputs(gen, (B, S, H, dh), (B, T, KV, dh),
                              getattr(torch, dtype_name), device)
        for i, kw in enumerate(cases(key)):
            err = attn_compare(ta, f"flash_attention {name} {key} #{i}",
                               q, k, v, **kw)
            errs[dtype_name] = max(errs[dtype_name], err)
        del q, k, v
    return errs


def check_path(name: str, launches: int, want: int, logits, B: int,
               vocab: int, versus: dict) -> None:
    if launches != want:
        raise AssertionError(f"flash_attention launched {launches} times on "
                             f"the {name} path, expected {want}")
    if logits.shape != (1 + LM_TOKENS, B, vocab) \
            or not bool(logits.isfinite().all()):
        raise AssertionError(f"the {name} path gave malformed or non-finite"
                             " logits")
    if not versus["max_err_over_max_logit"] <= LM_TOL:
        raise AssertionError(
            f"{name} logits through the kernel differ from the plain "
            f"attention by {versus['max_err_over_max_logit']} of their "
            f"scale (> {LM_TOL})")


def model_fields(cfg, published, params, init_s: float) -> dict:
    from repro_torch.models import param_count
    return {"arch": published.name, "layers": cfg.n_layers,
            "layers_published": published.n_layers, "d_model": cfg.d_model,
            "heads": cfg.n_heads, "kv_heads": cfg.n_kv, "head_dim": cfg.dh,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "params": param_count(params), "init_s": init_s}


def new_params(model, seed: int, device):
    import torch

    from repro_torch.models import init_params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(model.param_desc(),
                         torch.Generator(device=device).manual_seed(seed),
                         device)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def routed_alike(run_a, run_b):
    """`run_a()` with the MoE routing it computes, recorded call by call;
    then `run_b()` with that routing replayed: each call's top-k experts
    per token and each expert's capacity picks are run_a's, the gates run
    b's own renormalised probabilities on them. A bf16 difference of
    attention output (kernel against plain, or a ring against a full
    cache) can flip a near tie of the router; replayed, the two runs
    differ in attention alone, which is what their comparison is about.
    Returns (run_a's result, run_b's, the decisions that run_b's own
    routing would have taken otherwise: tokens whose top-k set, and
    experts whose capacity picks, differ)."""
    import torch

    from repro_torch.models import blocks
    orig = blocks.moe_ffn_global
    calls, flips = [], {"top_k": 0, "capacity": 0, "calls": 0}

    def moe(x, p, cfg, replay):
        moe_cfg = cfg.moe
        B, S, D = x.shape
        N, E, K = B * S, moe_cfg.n_experts, moe_cfg.top_k
        xf = x.reshape(N, D)
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        own_top = torch.topk(probs, K, dim=-1).indices
        top = calls[flips["calls"]][0] if replay else own_top
        vals = probs.gather(-1, top)
        keep = torch.zeros_like(probs).scatter_(
            -1, top, vals / vals.sum(-1, keepdim=True))
        C = min(max(int(moe_cfg.capacity_factor * K * N / E), 1), N)
        own_gate, own_tok = torch.topk(keep.T, C, dim=-1)
        if replay:
            tok = calls[flips["calls"]][1]
            gate = keep.T.gather(1, tok)
            flips["top_k"] += int((own_top.sort(-1).values
                                   != top.sort(-1).values).any(-1).sum())
            flips["capacity"] += int((own_tok.sort(-1).values
                                      != tok.sort(-1).values).any(-1).sum())
            flips["calls"] += 1
        else:
            gate, tok = own_gate, own_tok
            calls.append((top, tok))
        y = blocks._experts(xf[tok.reshape(-1)].reshape(E, C, D), p, gate)
        out = torch.zeros((N, D), dtype=y.dtype, device=x.device)
        out.index_add_(0, tok.reshape(-1), y.reshape(E * C, D))
        return out.reshape(B, S, D)
    try:
        blocks.moe_ffn_global = lambda x, p, cfg, *_: moe(x, p, cfg, False)
        a = run_a()
        blocks.moe_ffn_global = lambda x, p, cfg, *_: moe(x, p, cfg, True)
        b = run_b()
    finally:
        blocks.moe_ffn_global = orig
    if flips["calls"] != len(calls):
        raise AssertionError(f"run_b made {flips['calls']} MoE calls, "
                             f"run_a {len(calls)}")
    return a, b, flips


def mixtral_phase(args, device) -> dict:
    """Mixtral's sliding window: prompts past the window, so it masks in
    prefill; decode against the full cache; then the ring check: the
    prompt's last MIXTRAL_WINDOW positions laid into a `cache_desc` ring
    at slot pos % window, decoded teacher-forced, must give the full
    cache's logits (both mask the same keys)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as ta
    from repro_torch.launch.serve import decode_loop, prefill
    from repro_torch.models import TransformerModel, build_model

    t_phase = time.perf_counter()
    published = get_config(MIXTRAL_ARCH)
    cfg = published.with_(n_layers=MIXTRAL_LAYERS)
    W = cfg.swa
    model = build_model(cfg)
    params, init_s = new_params(model, args.seed, device)
    prompt = torch.from_numpy(np.random.default_rng(args.seed).integers(
        4, cfg.vocab, (MIXTRAL_BATCH, MIXTRAL_PROMPT))).to(device)
    decode_loop(model, params, prompt[:, :64], 2)          # warm-up

    # ---- the main path: counts zeroed before, read after -------------
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = decode_loop(model, params, prompt, LM_TOKENS)
    launches = ta.LAUNCHES["flash_attention"]
    shapes = dict(ta.LAUNCH_SHAPES)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------

    # kernel vs plain attention and then the ring vs the full cache, each
    # pair with the first run's MoE routing replayed in the second
    # (`routed_alike`): teacher-forced bf16 runs that differ in attention
    # rounding flip a near tie of the router now and then (measured: 0.14
    # of the logits' scale at one step of 32, the rest under 1.3e-2)
    t0 = time.perf_counter()
    kern, plain, flips = routed_alike(
        lambda: teacher_forced(model, params, prompt, out.tokens),
        lambda: teacher_forced(TransformerModel(cfg, attn_impl="ref"),
                               params, prompt, out.tokens))
    versus = logits_versus(kern, plain)
    versus["wall_s"] = time.perf_counter() - t0
    versus["routing_replayed"] = flips
    del plain
    repeat = float((kern[-1] - out.logits).abs().max())
    check_path("mixtral", launches, cfg.n_layers * (1 + LM_TOKENS), kern,
               MIXTRAL_BATCH, cfg.vocab, versus)

    # the ring: a `cache_desc` cache of W slots holding the prompt's last W
    # positions at slot p % W (kpos to match), decoded teacher-forced
    S = MIXTRAL_PROMPT
    logits, full = prefill(model, params, prompt, LM_TOKENS)
    ring_desc = model.cache_desc(MIXTRAL_BATCH, S + LM_TOKENS)
    if ring_desc["k"].shape[2] != W:
        raise AssertionError(f"cache_desc gave {ring_desc['k'].shape[2]} "
                             f"slots under a window of {W}")
    held = torch.arange(S - W, S, device=device)
    ring = {"k": torch.zeros(ring_desc["k"].shape, dtype=torch.bfloat16,
                             device=device),
            "kpos": torch.full((W,), -1, dtype=torch.int32, device=device),
            "pos": torch.tensor(S, dtype=torch.int32)}
    ring["v"] = torch.zeros_like(ring["k"])
    for name in ("k", "v"):
        ring[name][:, :, held % W] = full[name][:, :, held]
    ring["kpos"][held % W] = held.to(torch.int32)
    def decode_from(cache):
        steps = [logits]
        for t in range(LM_TOKENS):
            lt, cache = model.decode_step(
                params, cache, {"tokens": out.tokens[:, t:t + 1]})
            steps.append(lt)
        return torch.stack(steps), cache
    (full_logits, _), (ring_logits, ring), flips = routed_alike(
        lambda: decode_from(full), lambda: decode_from(ring))
    ring_versus = logits_versus(ring_logits, full_logits)
    ring_versus["routing_replayed"] = flips
    wrapped = ring["kpos"].cpu().numpy()
    want_kpos = np.arange(S + LM_TOKENS - W, S + LM_TOKENS)
    if not np.array_equal(wrapped[want_kpos % W], want_kpos):
        raise AssertionError("the ring's kpos is not the last window")

    def cases(key):
        B, S_, T, H, KV, dh, _ = key
        pos = torch.arange(T, dtype=torch.int32, device=device)
        if S_ > 1:                   # prefill: arange, the window masks
            return [{"causal": True, "window": W, "q_positions": pos,
                     "kv_positions": pos}]
        out_ = []                    # decode: its first step and its last
        for p in (S, T - 1):
            kp = pos.clone()
            kp[p + 1:] = -1
            out_.append({"causal": True, "window": W,
                         "q_positions": kp[p:p + 1].clone(),
                         "kv_positions": kp})
        return out_
    errs = path_attention_errs(ta, device, args.seed + 8, "mixtral", shapes,
                               cases)
    emit({"phase": "mixtral", **model_fields(cfg, published, params, init_s),
          "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
          "window": W, "batch": MIXTRAL_BATCH, "prompt": MIXTRAL_PROMPT,
          "new_tokens": LM_TOKENS, "cache_slots": S + LM_TOKENS,
          "prefill_s": out.prefill_s, "decode_s": out.decode_s,
          "decode_s_per_token": out.decode_s / LM_TOKENS,
          "decode_tok_per_s": MIXTRAL_BATCH * LM_TOKENS / out.decode_s,
          "peak_device_bytes": peak_bytes, "attention_launches": launches,
          "attention_shapes": {str(k): v for k, v in shapes.items()},
          "attention_vs_plain_max_abs_err": errs,
          "greedy_tokens": out.tokens.tolist(), "vs_plain_attention": versus,
          "decode_loop_vs_forced_rerun_max_abs": repeat,
          "ring": {"slots": W, "held": [S - W, S - 1], **ring_versus},
          "wall_s": time.perf_counter() - t_phase})
    if not ring_versus["max_err_over_max_logit"] <= LM_TOL:
        raise AssertionError(
            f"mixtral: decoding from the ring differs from the full cache "
            f"by {ring_versus['max_err_over_max_logit']} of the logits' "
            f"scale (> {LM_TOL})")
    return {"launches": launches, "shapes": shapes, "errs": errs,
            "window": W}


def vlm_phase(args, device) -> dict:
    """Qwen2-VL: rows of image patches and text at M-RoPE ids, each row
    its own grid, so that every row's query positions differ."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as ta
    from repro_torch.models import TransformerModel, build_model

    t_phase = time.perf_counter()
    published = get_config(VLM_ARCH)
    cfg = published.with_(n_layers=VLM_LAYERS)
    model = build_model(cfg)
    params, init_s = new_params(model, args.seed, device)
    B, S = len(VLM_GRIDS), VLM_SEQ
    n_img = VLM_GRIDS[0][0] * VLM_GRIDS[0][1]
    n_text = S - n_img
    ids, nxt = qwen2_vl_positions(VLM_GRIDS, n_text)
    gen = torch.Generator(device=device).manual_seed(args.seed + 9)
    batch = {"tokens": torch.randint(4, cfg.vocab, (B, n_text), generator=gen,
                                     device=device, dtype=torch.int32),
             "patches": torch.randn(B, n_img, cfg.d_model, generator=gen,
                                    device=device).to(torch.bfloat16),
             "positions": torch.from_numpy(ids).to(device)}
    nxt = torch.from_numpy(nxt).to(device)

    def extra(t):                     # each row's next text id, (B, 1, 3)
        return {"positions": (nxt + t)[:, None, None].expand(B, 1, 3)
                .contiguous()}
    warm = {"tokens": batch["tokens"][:, :48],
            "patches": batch["patches"][:, :16],
            "positions": batch["positions"][:, :64]}
    serve_forced(model, params, warm, 66, extra, 2)          # warm-up

    # ---- the main path: counts zeroed before, read after -------------
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tokens, logits, prefill_s, decode_s, _ = serve_forced(
        model, params, batch, S + LM_TOKENS, extra, LM_TOKENS)
    launches = ta.LAUNCHES["flash_attention"]
    shapes = dict(ta.LAUNCH_SHAPES)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------

    t0 = time.perf_counter()
    kern = serve_forced(model, params, batch, S + LM_TOKENS, extra,
                        LM_TOKENS, tokens)[1]
    plain = serve_forced(TransformerModel(cfg, attn_impl="ref"), params,
                         batch, S + LM_TOKENS, extra, LM_TOKENS, tokens)[1]
    versus = logits_versus(kern, plain)
    versus["wall_s"] = time.perf_counter() - t0
    repeat = float((kern - logits).abs().max())
    del plain, kern
    check_path("vlm", launches, cfg.n_layers * (1 + LM_TOKENS), logits, B,
               cfg.vocab, versus)
    q_ids = batch["positions"][..., 0].contiguous()

    def cases(key):
        T = key[2]
        if key[1] > 1:               # prefill: the rows' own temporal ids
            return [{"causal": True, "window": None, "q_positions": q_ids,
                     "kv_positions": q_ids}]
        kp = torch.full((T,), -1, dtype=torch.int32, device=device)
        kp[:S] = q_ids[0]            # row 0's ids, as the model's cache
        kp[S] = S                    # and the first step's slot (pos)
        return [{"causal": True, "window": None,
                 "q_positions": nxt[:, None].contiguous(),
                 "kv_positions": kp}]
    errs = path_attention_errs(ta, device, args.seed + 10, "vlm", shapes,
                               cases)
    emit({"phase": "vlm", **model_fields(cfg, published, params, init_s),
          "mrope_sections": list(cfg.mrope_sections), "batch": B,
          "positions": S, "patches_per_row": n_img, "text_per_row": n_text,
          "grids": [list(g) for g in VLM_GRIDS], "next_ids": nxt.tolist(),
          "new_tokens": LM_TOKENS, "cache_slots": S + LM_TOKENS,
          "prefill_s": prefill_s, "decode_s": decode_s,
          "decode_s_per_token": decode_s / LM_TOKENS,
          "decode_tok_per_s": B * LM_TOKENS / decode_s,
          "peak_device_bytes": peak_bytes, "attention_launches": launches,
          "attention_shapes": {str(k): v for k, v in shapes.items()},
          "attention_vs_plain_max_abs_err": errs,
          "greedy_tokens": tokens.tolist(), "vs_plain_attention": versus,
          "greedy_vs_forced_rerun_max_abs": repeat,
          "wall_s": time.perf_counter() - t_phase})
    return {"launches": launches, "shapes": shapes, "errs": errs,
            "q_ids": q_ids}


def encdec_phase(args, device) -> dict:
    """SeamlessM4T-medium: utterances of ENC_FRAMES encoder frames, a
    decoder prompt, greedy tokens; every layer, encoder and decoder."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.seamless_m4t_medium import ENC_FRAMES
    from repro_torch.kernels import attention as ta
    from repro_torch.models import EncDecModel, build_model

    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    params, init_s = new_params(model, args.seed, device)
    B, S = ENCDEC_BATCH, ENCDEC_PROMPT
    gen = torch.Generator(device=device).manual_seed(args.seed + 11)
    batch = {"frames": torch.randn(B, ENC_FRAMES, cfg.d_model, generator=gen,
                                   device=device).to(torch.bfloat16),
             "tokens": torch.randint(4, cfg.vocab, (B, S), generator=gen,
                                     device=device, dtype=torch.int32)}

    def extra(t):
        return {}
    serve_forced(model, params, {"frames": batch["frames"][:, :64],
                                 "tokens": batch["tokens"][:, :8]},
                 10, extra, 2)                                # warm-up

    # ---- the main path: counts zeroed before, read after -------------
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tokens, logits, prefill_s, decode_s, cache = serve_forced(
        model, params, batch, S + LM_TOKENS, extra, LM_TOKENS)
    launches = ta.LAUNCHES["flash_attention"]
    shapes = dict(ta.LAUNCH_SHAPES)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------
    cross_shape = tuple(cache["cross_k"].shape)
    del cache

    t0 = time.perf_counter()
    kern = serve_forced(model, params, batch, S + LM_TOKENS, extra,
                        LM_TOKENS, tokens)[1]
    plain = serve_forced(EncDecModel(cfg, attn_impl="ref"), params, batch,
                         S + LM_TOKENS, extra, LM_TOKENS, tokens)[1]
    versus = logits_versus(kern, plain)
    versus["wall_s"] = time.perf_counter() - t0
    repeat = float((kern - logits).abs().max())
    del plain, kern
    n_dec = model.n_dec
    check_path("encdec", launches,
               cfg.n_layers + 2 * n_dec + LM_TOKENS * 2 * n_dec, logits, B,
               cfg.vocab, versus)

    def cases(key):
        _, S_, T, *_ = key
        ar = torch.arange(T, dtype=torch.int32, device=device)
        if T == ENC_FRAMES:          # encoder self or cross: no mask
            q = ar if S_ == T else torch.arange(S_, dtype=torch.int32,
                                                device=device)
            return [{"causal": False, "window": None, "q_positions": q,
                     "kv_positions": ar}]
        if S_ > 1:                   # decoder self-attention at prefill
            return [{"causal": True, "window": None, "q_positions": ar,
                     "kv_positions": ar}]
        out_ = []                    # decode: its first step and its last
        for p in (S, T - 1):
            kp = ar.clone()
            kp[p + 1:] = -1
            out_.append({"causal": True, "window": None,
                         "q_positions": kp[p:p + 1].clone(),
                         "kv_positions": kp})
        return out_
    errs = path_attention_errs(ta, device, args.seed + 12, "encdec", shapes,
                               cases)
    emit({"phase": "encdec",
          **model_fields(cfg, cfg, params, init_s),
          "encoder_layers": cfg.n_layers, "decoder_layers": n_dec,
          "batch": B, "encoder_frames": ENC_FRAMES, "prompt": S,
          "new_tokens": LM_TOKENS, "cache_slots": S + LM_TOKENS,
          "cross_cache_shape": list(cross_shape),
          "prefill_s": prefill_s, "decode_s": decode_s,
          "decode_s_per_token": decode_s / LM_TOKENS,
          "decode_tok_per_s": B * LM_TOKENS / decode_s,
          "peak_device_bytes": peak_bytes, "attention_launches": launches,
          "attention_shapes": {str(k): v for k, v in shapes.items()},
          "attention_vs_plain_max_abs_err": errs,
          "greedy_tokens": tokens.tolist(), "vs_plain_attention": versus,
          "greedy_vs_forced_rerun_max_abs": repeat,
          "wall_s": time.perf_counter() - t_phase})
    return {"launches": launches, "shapes": shapes, "errs": errs}


def attn_paths_timing(ta, device, seed: int, attn: dict, mixtral: dict,
                      vlm: dict, encdec: dict) -> None:
    """Time the attention shapes the mixtral, vlm and encdec paths
    launched, into the kernels line's attention entry: the windowed
    prefill; the per-row-position prefill beside the shared arange at
    the same shape; the encoder's prefill; the cross-attention decode
    step and the decoder prompt's cross-attention."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 13)

    def ar(n):
        return torch.arange(n, dtype=torch.int32, device=device)

    def shape_of(shapes, pick):
        keys = [k for k in shapes if pick(k)]
        if len(keys) != 1:
            raise AssertionError(f"expected one shape, got {keys}")
        return keys[0], shapes[keys[0]]
    out = attn["shapes"]
    key, n = shape_of(mixtral["shapes"], lambda k: k[1] > 1)
    out["mixtral_prefill"] = attn_time_shape(
        ta, flush, gen, "mixtral_prefill", key,
        {"causal": True, "window": mixtral["window"],
         "q_positions": ar(key[1]), "kv_positions": ar(key[2])}, n)
    key, n = shape_of(vlm["shapes"], lambda k: k[1] > 1)
    q_ids = vlm["q_ids"]
    out["vlm_prefill_rows"] = attn_time_shape(
        ta, flush, gen, "vlm_prefill_rows", key,
        {"causal": True, "window": None, "q_positions": q_ids,
         "kv_positions": q_ids}, n)
    out["vlm_prefill_shared"] = attn_time_shape(
        ta, flush, gen, "vlm_prefill_shared", key,
        {"causal": True, "window": None, "q_positions": ar(key[1]),
         "kv_positions": ar(key[2])}, 0)
    shapes = encdec["shapes"]
    frames = max(k[2] for k in shapes)         # the encoder's memory
    for label, pick in (("encoder_prefill", lambda k: k[1] == k[2] == frames),
                        ("cross_decode", lambda k: k[1] == 1
                         and k[2] == frames),
                        ("cross_prefill", lambda k: 1 < k[1] < k[2])):
        key, n = shape_of(shapes, pick)
        out[label] = attn_time_shape(
            ta, flush, gen, label, key,
            {"causal": False, "window": None, "q_positions": ar(key[1]),
             "kv_positions": ar(key[2])}, n)
    rows, shared = out["vlm_prefill_rows"], out["vlm_prefill_shared"]
    rows["ms_over_shared"] = rows["ms"] / shared["ms"]
    errs = attn["max_abs_err_by_dtype"]
    for entry in out.values():
        dtype = entry["shape"]["dtype"]
        errs[dtype] = max(errs[dtype], entry["max_abs_err"])


def scan_bound(B, S, D, N, with_h0) -> tuple:
    """Least card time (ms) for one scan: a and b read once, c read once,
    y written once, h0 (when given) read and h_fin written once, all
    float32, over HBM bandwidth, against 4 flops per (b, t, d, n) (a
    multiply and an add of the update, a multiply and an add of y's sum)
    over the float32 rate (`launch.roofline.scan_cost`); the larger, and
    which it is."""
    from repro_torch.launch import roofline as rl
    return float_bound(*rl.scan_cost(B, S, D, N, with_h0), 4)


def scan_fused_bound(B, S, D, N, nbytes_el, with_h0, with_D) -> dict:
    """Least card time (ms) for one fused scan, the largest of three
    terms: bytes (dt and y float32, x at its width, read or written once
    per (b, t, d); the B_ and C_ values once per (b, t); A, D, h0 and
    h_fin once) over HBM bandwidth; float32 operations (dt·A, the two
    products of b, the update's two, y's product and sum: 7 per (b, t, d,
    n), and the D skip's 2 per (b, t, d)) over the float32 rate; one ex2
    per (b, t, d, n) over the special-function units' rate. `bound_by` is
    "bytes" or "operations", `term` names the term. The flops and bytes
    are `launch.roofline.scan_fused_cost`'s."""
    from repro_torch.launch import roofline as rl
    return three_terms(*rl.scan_fused_cost(B, S, D, N, nbytes_el, with_h0,
                                           with_D), B * S * D * N)


def three_terms(flops, nbytes, exps) -> dict:
    """The largest of bytes over HBM bandwidth, float32 flops over the
    float32 rate and `exps` ex2 over the special-function units' rate."""
    from repro_torch.launch import roofline as rl
    terms = {"bytes": nbytes / rl.HBM_BYTES_PER_S,
             "float32": flops / rl.F32_FLOPS_PER_S,
             "sfu": exps / rl.SFU_OPS_PER_S}
    term = max(terms, key=terms.get)
    return {"bound_ms": 1e3 * terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "term": term, "terms_ms": {k: 1e3 * v for k, v in terms.items()},
            "flops": flops, "exp": exps, "bytes": nbytes}


def scan_timing_phase(ts, device, seed: int, shapes: dict,
                      edge_errs: dict) -> dict:
    """Time the fused kernel at the Jamba path's prefill and decode shapes
    and the unfused kernel at the same (B, S, D, N, h0): CUDA events, the
    profiler's device time, the plain versions."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    picked = {}
    for key in shapes:
        picked["decode" if key[1] == 1 else "prefill"] = key
    fused_shapes, unfused_shapes = {}, {}
    errs = dict(edge_errs)

    def record(err, rel):
        errs["max_abs_err"] = max(errs["max_abs_err"], err)
        errs["max_scaled_err"] = max(errs["max_scaled_err"], rel)

    for kind, key in sorted(picked.items(), reverse=True):
        B, S, D, N, dtype_name, with_h0, with_D = key
        # the plain versions walk S steps from Python: fewer repeats
        slow = S > 100
        reps = {"iters": 5, "warmup": 1} if slow else {}

        args = list(scan_fused_inputs(gen, B, S, D, N,
                                      getattr(torch, dtype_name), device))
        args[5] = args[5] if with_D else None
        args[6] = args[6] if with_h0 else None
        err, rel, same, y_same = scan_fused_compare(
            ts, f"selective_scan_fused {kind} {key}", *args)
        record(err, rel)
        y = torch.empty((B, S, D), dtype=torch.float32, device=device)
        h_fin = torch.empty((B, D, N), dtype=torch.float32, device=device)

        def fused():
            ts.launch_fused(*args, y, h_fin)
        kernel_ms = cuda_ms(fused, flush)
        bound = scan_fused_bound(B, S, D, N, args[4].element_size(),
                                 with_h0, with_D)
        fused_shapes[kind] = {
            "shape": {"B": B, "S": S, "D": D, "N": N, "dtype": dtype_name,
                      "h0": with_h0, "D_skip": with_D},
            "kernel": "scan_fused", "launches": shapes[key],
            "ms": kernel_ms, "device_ms": device_ms(fused, flush,
                                                    "scan_fused"),
            "plain_ms": cuda_ms(lambda: ts.selective_scan_fused_ref(*args),
                                flush, **reps),
            "library_ms": None, **bound, "max_abs_err": err,
            "max_scaled_err": rel, "h_fin_bit_exact": same,
            "y_bit_exact": y_same,
            "share_of_bound": bound["bound_ms"] / kernel_ms}
        del args, y, h_fin

        a, b, c, h0 = scan_inputs(gen, B, S, D, N, device)
        h0 = h0 if with_h0 else None
        err, rel, same, y_same = scan_compare(
            ts, f"selective_scan {kind} {(B, S, D, N, with_h0)}", a, b, c, h0)
        record(err, rel)
        y = torch.empty((B, S, D), dtype=torch.float32, device=device)
        h_fin = torch.empty((B, D, N), dtype=torch.float32, device=device)

        def unfused():
            ts.launch(a, b, c, h0, y, h_fin)
        kernel_ms = cuda_ms(unfused, flush)
        bound_ms, bound_by, flops, nbytes = scan_bound(B, S, D, N, with_h0)
        unfused_shapes[kind] = {
            "shape": {"B": B, "S": S, "D": D, "N": N, "h0": with_h0},
            "kernel": "scan_fwd", "launches": 0, "ms": kernel_ms,
            "device_ms": device_ms(unfused, flush, "scan_fwd"),
            "plain_ms": cuda_ms(lambda: ts.selective_scan_ref(a, b, c, h0),
                                flush, **reps),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes, "max_abs_err": err,
            "max_scaled_err": rel, "h_fin_bit_exact": same,
            "y_bit_exact": y_same, "share_of_bound": bound_ms / kernel_ms}
        del a, b, c, h0, y, h_fin
    main = fused_shapes["prefill"]
    return {"name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
            "replaces": SCAN_REPLACES, "launches": sum(shapes.values()),
            "kernel": "scan_fused",
            "max_abs_err": errs["max_abs_err"],
            "max_scaled_err": errs["max_scaled_err"], "tolerance": SCAN_TOL,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "at": "prefill",
            "shapes": fused_shapes,
            "routes": {"scan_fused": {"launches": sum(shapes.values()),
                                      "shapes": fused_shapes},
                       "scan_fwd": {"launches": 0,
                                    "shapes": unfused_shapes}}}


# ------------------------------------------------------- int8 decode path
def lm_int8_phase(args, device) -> dict:
    """qwen3-32b with the int8 KV cache (the opt decode variant) at the
    `lm` path's depth and traffic: `decode_loop` through the kernels
    (exactly one bf16 prefill and LM_TOKENS int8 decode launches a
    layer), then teacher-forced logits vs the plain int8 attention and vs
    the bf16 cache (the same weights and tokens)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as ta
    from repro_torch.launch.serve import decode_loop
    from repro_torch.launch.steps import apply_variant
    from repro_torch.models import build_model
    from repro_torch.models.transformer import TransformerModel

    published = get_config(LM_ARCH)
    cfg, profile, _ = apply_variant(published, "decode_32k", "opt")
    if not cfg.kv_quant:
        raise AssertionError("the opt decode variant lost the int8 cache")
    cfg = cfg.with_(n_layers=args.lm_layers)
    model = build_model(cfg)
    params, init_s = new_params(model, args.seed, device)
    prompt = torch.from_numpy(np.random.default_rng(args.seed).integers(
        4, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    decode_loop(model, params, prompt[:, :64], 2)          # warm-up

    # ---- the main path: counts zeroed before, read after -------------
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = decode_loop(model, params, prompt, LM_TOKENS)
    launches = dict(ta.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------

    routes = dict(ta.INT8_ROUTES)
    want = {"flash_attention": cfg.n_layers,
            "flash_decode_int8": cfg.n_layers * LM_TOKENS, "flash_bwd": 0}
    if launches != want or routes != {"cluster": cfg.n_layers * LM_TOKENS}:
        raise AssertionError(f"the int8 path launched {launches} by routes "
                             f"{routes}, expected {want}, all on the "
                             "cluster route")
    if out.logits.shape != (LM_BATCH, cfg.vocab) \
            or not torch.isfinite(out.logits).all():
        raise AssertionError("the int8 path gave malformed logits")
    kern = teacher_forced(model, params, prompt, out.tokens)
    plain = teacher_forced(TransformerModel(cfg, attn_impl="ref"), params,
                           prompt, out.tokens)
    versus = logits_versus(kern, plain)
    bf16 = teacher_forced(TransformerModel(cfg.with_(kv_quant=False)),
                          params, prompt, out.tokens)
    vs_bf16 = logits_versus(kern, bf16)
    vs_bf16["tolerance"] = INT8_VS_BF16_TOL
    T = LM_PROMPT + LM_TOKENS
    int8_bytes = 2 * cfg.n_layers * LM_BATCH * T * cfg.n_kv * (cfg.dh + 2)
    bf16_bytes = 2 * cfg.n_layers * LM_BATCH * T * cfg.n_kv * cfg.dh * 2
    emit({"phase": "lm_int8", **model_fields(cfg, published, params, init_s),
          "variant": "opt", "cell": "decode_32k", "profile": profile,
          "kv_quant": cfg.kv_quant, "batch": LM_BATCH, "prompt": LM_PROMPT,
          "new_tokens": LM_TOKENS, "prefill_s": out.prefill_s,
          "decode_s": out.decode_s,
          "decode_ms_per_token": 1e3 * out.decode_s / LM_TOKENS,
          "kv_cache_bytes": int8_bytes, "kv_cache_bytes_bf16": bf16_bytes,
          "kv_cache_ratio": int8_bytes / bf16_bytes,
          "peak_device_bytes": peak_bytes, "launches": launches,
          "int8_routes": routes, "vs_plain_attention": versus,
          "vs_bf16_cache": vs_bf16})
    if not versus["max_err_over_max_logit"] <= LM_TOL:
        raise AssertionError(f"int8 path logits vs plain: {versus}")
    if not (vs_bf16["max_err_over_max_logit"] <= INT8_VS_BF16_TOL):
        raise AssertionError(f"int8 path logits vs the bf16 cache: {vs_bf16}")
    return {"launches": launches, "routes": routes,
            "errs": versus["max_err_over_max_logit"]}


# ------------------------------------------------------------- training
def _host_mb() -> dict:
    """This process's resident and peak resident host memory, MB."""
    out = {}
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith(("VmRSS", "VmHWM")):
            out[line.split(":")[0]] = int(line.split()[1]) // 1024
    return out


def train_profile(model, state, batch, device) -> dict:
    """One more train step on `state` under torch.profiler: the card's
    busy time against the host's wall, and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training import OptimizerConfig, make_train_step
    step = make_train_step(model, OptimizerConfig(lr=TRAIN_LR))
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, events, by_name = _device_time(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # the attention kernels of the step, however small: the backward's
    # three (bwd_pre, bwd_dkdv*, bwd_dq*) and the forward's
    attn = {name[:90]: [us, n] for name, (us, n) in by_name.items()
            if "bwd_" in name or "flash_" in name}
    return {"host_wall_us": wall_us, "device_busy_us": busy_us,
            "device_idle_share": 1 - busy_us / wall_us if events else None,
            "device_events": events,
            "top_kernels_us": [[name[:90], us, n] for name, (us, n) in top],
            "attention_kernels_us": attn,
            "flash_bwd_us": sum(us for name, (us, _) in attn.items()
                                if "bwd_" in name)}


def train_phase(args, device) -> dict:
    """qwen3-32b at its published widths, TRAIN_LAYERS of 64 layers, in
    `train_arch_phase`'s flow over TRAIN_STEPS steps with a checkpoint
    every TRAIN_CKPT_EVERY and one profiled step after the resume: each
    step runs every layer's flash_attention twice (remat) and flash_bwd
    once; the gradient check on a GRAD_CHECK_LAYERS-layer cut at the
    full sequence."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import TransformerModel
    published = get_config(TRAIN_ARCH)
    cfg = published.with_(n_layers=TRAIN_LAYERS)
    cut = cfg.with_(n_layers=GRAD_CHECK_LAYERS)
    L, G = cfg.n_layers, cut.n_layers
    return train_arch_phase(
        args, device, "train", published, cfg,
        {"flash_attention": 2 * L, "flash_bwd": L},
        [f"layers {L} of {published.n_layers}",
         "batch 2 of train_4k's 256"],
        {"kernel": build_model(cut), "plain": TransformerModel(
            cut, attn_impl="ref"), "cut": f"{G} layer", "seq": TRAIN_SEQ,
         "want": {"flash_attention": 2 * G, "flash_bwd": G}},
        steps=TRAIN_STEPS, every=TRAIN_CKPT_EVERY, profile=True)


# --------------------------------------------- timing of the new kernels
def bwd_bound(B, S, H, KV, dh, nbytes_el) -> tuple:
    """Least card time (ms) of the causal backward at (B, S, H/KV, dh):
    5 products of 2·dh flops per allowed (query, key) pair and head (the
    scores again, dP, dV, dK, dQ) over the bf16 rate, against q, k, v, o,
    dO read and dq, dk, dv written once (`launch.roofline.bwd_cost`); the
    larger, and which."""
    from repro_torch.launch import roofline as rl
    return float_bound(*rl.bwd_cost(B, S, S, H, KV, dh, nbytes_el),
                       nbytes_el)


def bwd_timing_phase(ta, device, seed: int, launches: dict,
                     edge_err: dict, train: dict) -> dict:
    """flash_bwd at the train path's shape (TRAIN_BATCH, TRAIN_SEQ, 64/8,
    128) bf16 causal, in one call: the tensor-core route with the
    forward's log-sum-exp (as the train path runs it), the FMA route
    (its pre-pass recomputing the log-sum-exp, as without the forward's),
    the plain version, SDPA's backward alone (its forward run once
    outside the timed window) and SDPA's forward + backward; and the
    forward kernel at that shape with and without the log-sum-exp
    write."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention.cases import bwd_inputs
    cfg_h, cfg_kv, dh = 64, 8, 128
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg_h, cfg_kv, dh)
    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    q, k, v, do = bwd_inputs(shape, seed, device, torch.bfloat16)
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=device)
    kw = {"causal": True, "q_positions": pos, "kv_positions": pos}
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
    out = ta.flash_attention(q, k, v, lse=lse, **kw)
    fwd_ms = cuda_ms(lambda: ta.launch(q, k, v, out, True, None, pos, pos),
                     flush, iters=10, warmup=2)
    fwd_lse_ms = cuda_ms(lambda: ta.launch(q, k, v, out, True, None, pos,
                                           pos, lse), flush, iters=10,
                         warmup=2)
    want = ta.attention_bwd(q, k, v, out, do, device=device, impl="ref",
                            **kw)
    scale = max(float(w.float().abs().max()) for w in want)
    scratch = torch.empty(2, TRAIN_BATCH * TRAIN_SEQ * cfg_h,
                          dtype=torch.float32, device=device)
    timed, err = {}, {}
    for route, given in (("tc", lse), ("fma", None)):
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        timed[route] = cuda_ms(
            lambda: ta.launch_bwd(q, k, v, out, do, dq, dk, dv, True, None,
                                  pos, pos, scratch, lse=given,
                                  route=route),
            flush, iters=10, warmup=2)
        err[route] = max(float((g.float() - w.float()).abs().max()) / scale
                         for g, w in zip((dq, dk, dv), want))
        del dq, dk, dv
    del want
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: ta.attention_bwd(q, k, v, out, do,
                                                device=device, impl="ref",
                                                **kw), flush, iters=3,
                       warmup=1)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    library_fwd_bwd_ms = cuda_ms(sdpa, flush, iters=10, warmup=2)
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True), flush, iters=10,
        warmup=2)
    del o_sdpa
    bound_ms, bound_by, flops, nbytes = bwd_bound(
        TRAIN_BATCH, TRAIN_SEQ, cfg_h, cfg_kv, dh, 2)
    for route in timed:
        if not err[route] <= BWD_TOL["bfloat16"]:
            raise AssertionError(f"flash_bwd ({route}) at the train shape: "
                                 f"{err[route]}")
    train_routes = train["bwd_routes"]
    return {"name": "flash_bwd", "route": "cuda", "source": BWD_SOURCE,
            "replaces": PORT_ONLY.format("jax.grad of "
                                         "src/repro/models/blocks.py:76"),
            "launches": launches["flash_bwd"],
            "launches_by_path": {"train": launches["flash_bwd"]},
            "routes": {
                "tc": {"source": BWD_SOURCE, "takes": "bf16, dh 64 and 128",
                       "launches": train_routes.get("tc", 0),
                       "ms": timed["tc"], "with": "the forward's lse"},
                "fma": {"source": BWD_FMA_SOURCE,
                        "takes": "float32, dh 32",
                        "launches": train_routes.get("fma", 0),
                        "ms": timed["fma"],
                        "with": "the lse recomputed by its pre-pass"}},
            "max_abs_err": max(max(edge_err.values()), *err.values(),
                               train["grad_err"]),
            "max_err_by_check": {"attn_bwd_edge": edge_err,
                                 "train_shape": err,
                                 "train_grad_leaf_norm_rel":
                                     train["grad_err"]},
            "tolerance": BWD_TOL, "ms": timed["tc"], "fma_ms": timed["fma"],
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention's backward alone "
                       "(is_causal, enable_gqa): autograd.grad with the "
                       "graph kept, its forward run once outside",
            "library_fwd_bwd_ms": library_fwd_bwd_ms,
            "share_of_bound": bound_ms / timed["tc"],
            "forward_ms": {"without_lse": fwd_ms, "with_lse": fwd_lse_ms},
            "shape": {"B": TRAIN_BATCH, "S": TRAIN_SEQ, "H": cfg_h,
                      "KV": cfg_kv, "dh": dh, "dtype": "bfloat16",
                      "causal": True}}


# ------------------------- training RWKV-6, Jamba and the encoder-decoder
def wkv_bwd_bound(B, S, H, dh, nbytes_el) -> dict:
    """Least card time (ms) of the wkv backward: r, k, v at their width,
    w and dout float32 read once, dr, dk, dv at r's width and dw float32
    written once, u and du; against 14 flops per (b, t, h) and state
    entry (i, j) over the float32 rate: the state once (k·v and an FMA),
    G's update (r·dout and an FMA), and one FMA each of dr, dk, dv and
    dw's sums (`launch.roofline.wkv_bwd_cost`). The larger, and which it
    is."""
    from repro_torch.launch import roofline as rl
    ms, by, flops, nbytes = float_bound(
        *rl.wkv_bwd_cost(B, S, H, dh, nbytes_el), 4)
    return {"bound_ms": ms, "bound_by": by, "flops": flops, "bytes": nbytes}


def scan_bwd_bound(B, S, D, N, nbytes_el) -> dict:
    """Least card time (ms) of the fused scan's backward with the D skip,
    the largest of three terms: bytes (dt, dy and d(dt) float32, x and dx
    at x's width per (b, t, d); B_, C_, dB_, dC_ per (b, t, n); A, dA, D,
    dD) over HBM bandwidth; float32 operations, each counted once, over
    the float32 rate: 19 per (b, t, d, n) (the state h_{t-1} again:
    dt·A, (dt·x)·B_ and the update's FMA, 4; G's FMA, 2; da = G·h·a, 2;
    dA's FMA, 2; d(dt)'s sum of da·A, 2; the sum of G·B_ that d(dt) and
    dx share, 2; dB_'s sum over d of G·(dt·x), 2; dC_'s of dy·h, 2; the
    carry a·G, 1) and 8 per (b, t, d) (dt·x, 1; d(dt)'s FMA of that
    shared sum with x, 2; dx = sum·dt + D·dy, 3; dD's FMA, 2); one ex2
    per (b, t, d, n) over the special-function units' rate. `bound_by`
    is "bytes" or "operations", `term` names the term. The flops and
    bytes are `launch.roofline.scan_bwd_cost`'s."""
    from repro_torch.launch import roofline as rl
    return three_terms(*rl.scan_bwd_cost(B, S, D, N, nbytes_el),
                       B * S * D * N)


def bwd_kernel_check(name: str, got, want, names, tol: dict,
                     again=None) -> dict[str, float]:
    """A backward kernel's gradients against its plain version's on the
    card: each output's largest difference over the plain version's
    largest |value|, raising above `tol` of the output's dtype; with
    `again` (a second call's gradients) also raises unless it is the
    first bit for bit."""
    import torch
    torch.cuda.synchronize()
    out = {}
    for what, g, w in zip(names, got, want):
        if g is None and w is None:
            continue
        if g is None or w is None or g.shape != w.shape \
                or g.dtype != w.dtype:
            raise AssertionError(f"{name} {what}: {g} vs {w}")
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{name} {what}: not finite")
        rel = float((g.float() - w.float()).abs().max()) / max(
            float(w.float().abs().max()), 1e-30)
        limit = tol["bfloat16" if g.dtype == torch.bfloat16 else "float32"]
        if not rel <= limit:
            raise AssertionError(f"{name} {what}: kernel disagrees with the "
                                 f"plain version by {rel} of its scale "
                                 f"(> {limit})")
        out[what] = rel
    if again is not None:
        for what, g, h in zip(names, got, again):
            if g is not None and not torch.equal(g, h):
                raise AssertionError(f"{name} {what}: a second call differs")
    return out


def bwd_edge_phase(kind: str, kernel_fn, plain_fn, cases_mod, kernels,
                   per_call: dict, device, seed: int) -> dict:
    """Every case of `cases_mod.bwd_cases()` through `kernel_fn` (a call
    of the backward kernel on the case's inputs) against its plain
    version within `cases_mod.BWD_TOL` of each output's scale; every
    third case run twice, bit for bit. `kernels` (the kernels' module)
    must count exactly `per_call` launches a call (kernel name -> n) and
    no other."""
    worst: dict[str, float] = {}
    calls = twice = 0
    kernels.reset_launches()
    t0 = time.perf_counter()
    for i, case in enumerate(cases_mod.bwd_cases()):
        args = cases_mod.bwd_inputs(case, seed + i, device)
        want = plain_fn(*args)
        got = kernel_fn(*args)
        again = kernel_fn(*args) if i % 3 == 0 else None
        calls += 1 + (again is not None)
        twice += again is not None
        errs = bwd_kernel_check(f"{kind} {case[0]}", got, want,
                                cases_mod.GRADS, cases_mod.BWD_TOL, again)
        for what, rel in errs.items():
            worst[what] = max(worst.get(what, 0.0), rel)
        del args, want, got, again
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if launches != {k: n * calls for k, n in per_call.items()}:
        raise AssertionError(f"{kind}: {calls} calls launched {launches}, "
                             f"expected {per_call} a call")
    emit({"phase": f"{kind}_edge", "cases": len(cases_mod.bwd_cases()),
          "calls": calls, "launches": launches,
          "bitwise_repeats": twice, "max_scaled_err_by_output": worst,
          "tolerance": cases_mod.BWD_TOL, "wall_s": time.perf_counter() - t0})
    return worst


def bwd_kernel_timing(entry: dict, cases_mod, case: tuple, seed: int,
                      device, plain_fn, kernel_fn, setup, edge: dict,
                      parts: tuple = ()) -> dict:
    """`entry` (a backward kernel's name, source, bound, launches...)
    with what is measured at its train path's shape `case`: the bare
    launch by CUDA events (L2 flushed), the profiler's device ms of each
    kernel in `parts`, the plain version's time, its forward kernel's
    and the forward and backward together as the train path runs them,
    and the error (`max_abs_err`: the largest over the outputs' scales
    and the edge phase's, a bf16 output's one rounding included;
    `max_abs_err_float32`: the same shape in float32, every output
    float32). `setup(args)` gives the bare launch, the gradient buffers
    it fills, the forward's bare launch as the train path runs it, and
    other launches to time (name -> call)."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    args = cases_mod.bwd_inputs(case, seed, device)
    launch, grads, forward, others = setup(args)
    ms = cuda_ms(launch, flush, iters=10, warmup=2)
    device_parts = device_ms_parts(launch, flush, parts) if parts else {}
    errs = bwd_kernel_check(f"{entry['name']} train shape", grads + [None],
                            plain_fn(*args), cases_mod.GRADS,
                            cases_mod.BWD_TOL)
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: plain_fn(*args), flush, iters=2, warmup=0)
    forward_ms = cuda_ms(forward, flush, iters=10, warmup=2)

    def both():
        forward()
        launch()
    fwd_bwd_ms = cuda_ms(both, flush, iters=10, warmup=2)
    other_ms = {name: cuda_ms(fn, flush, iters=10, warmup=2)
                for name, fn in others.items()}
    del args, launch, grads, forward, others
    torch.cuda.empty_cache()
    args32 = cases_mod.bwd_inputs((case[0], case[1], "float32", *case[3:]),
                                  seed, device)
    errs32 = bwd_kernel_check(f"{entry['name']} train shape float32",
                              kernel_fn(*args32), plain_fn(*args32),
                              cases_mod.GRADS, cases_mod.BWD_TOL)
    del args32
    torch.cuda.empty_cache()
    return {"route": "cuda", **entry,
            "max_abs_err": max(*errs.values(), *edge.values()),
            "max_abs_err_float32": max(errs32.values()),
            "max_err_by_check": {f"{entry['name']}_edge": edge,
                                 "train_shape": errs,
                                 "train_shape_float32": errs32},
            "tolerance": cases_mod.BWD_TOL, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "share_of_bound": entry["bound_ms"] / ms,
            "device_ms_by_kernel": device_parts, "forward_ms": forward_ms,
            "forward_and_backward_ms": fwd_bwd_ms, **other_ms}


def wkv_bwd_timing_phase(tr, device, seed: int, launches: dict,
                         edge: dict) -> dict:
    """The wkv backward at the RWKV train path's shape (TRAIN_BATCH,
    TRAIN_SEQ, 40, 64) bf16 from the model's decays, no state, through
    `bwd_kernel_timing`."""
    import torch

    from repro_torch.kernels.rwkv import cases
    B, S, H, dh = TRAIN_BATCH, TRAIN_SEQ, 40, 64
    plan = tr.plan_bwd(B, S, H, dh)

    def setup(args):
        r, k, v, w, u, _, dout, _ = args
        f32 = dict(dtype=torch.float32, device=device)
        grads = [torch.empty_like(r) for _ in range(3)] + [
            torch.empty(r.shape, **f32), torch.empty((H, dh), **f32)]
        scratch = torch.empty(plan.scratch_floats, **f32)
        out, state = (torch.empty(r.shape, **f32),
                      torch.empty((B, H, dh, dh), **f32))
        return (lambda: tr.launch_bwd(r, k, v, w, u, None, dout, None,
                                      *grads, None, scratch), grads,
                lambda: tr.launch(r, k, v, w, u, None, out, state), {})
    entry = {"name": "wkv_bwd", "source": WKV_BWD_SOURCE,
             "replaces": PORT_ONLY.format("jax.grad of wkv_chunked, "
                                          "src/repro/models/rwkv6.py:111"),
             "launches": launches["wkv_bwd"],
             "launches_by_path": {"train_rwkv": launches["wkv_bwd"]},
             **wkv_bwd_bound(B, S, H, dh, 2),
             "library": "none: no PyTorch call computes the wkv backward",
             "plan": plan._asdict(),
             "shape": {"B": B, "S": S, "H": H, "dh": dh,
                       "dtype": "bfloat16", "s0": False}}
    return bwd_kernel_timing(
        entry, cases, ("train", (B, S, H, dh), "bfloat16", False, "model"),
        seed + 11, device, tr.wkv_bwd_ref, tr.wkv_bwd_cuda, setup, edge,
        ("wkv_bwd_states", "wkv_bwd_chunk", "wkv_bwd_finish"))


def scan_bwd_timing_phase(ts, device, seed: int, launches: dict,
                          edge: dict) -> dict:
    """The fused scan's backward at the Jamba train path's shape
    (TRAIN_BATCH, TRAIN_SEQ, 8192, 16) bf16 with the D skip, no state,
    through `bwd_kernel_timing`."""
    import torch

    from repro_torch.kernels.ssm import cases
    B, S, D, N = TRAIN_BATCH, TRAIN_SEQ, 8192, 16
    plan = ts.plan_fused_bwd(B, S, D, N)

    def setup(args):
        dt, A, B_, C_, x, Dv, _, dy, _ = args
        f32 = dict(dtype=torch.float32, device=device)
        grads = [torch.empty((B, S, D), **f32), torch.empty((D, N), **f32),
                 torch.empty((B, S, N), dtype=x.dtype, device=device),
                 torch.empty((B, S, N), dtype=x.dtype, device=device),
                 torch.empty_like(x), torch.empty((D,), **f32)]
        scratch = torch.empty(plan["scratch_floats"], **f32)
        y, h_fin = torch.empty((B, S, D), **f32), torch.empty((B, D, N), **f32)
        states = torch.empty(ts.states_shape(B, S, D, N), **f32)
        ts.launch_fused(dt, A, B_, C_, x, Dv, None, y, h_fin, states)
        # the train path's forward saves the states the backward reads
        return (lambda: ts.launch_bwd(dt, A, B_, C_, x, Dv, None, dy, None,
                                      states, *grads, None, scratch), grads,
                lambda: ts.launch_fused(dt, A, B_, C_, x, Dv, None, y, h_fin,
                                        states),
                {"forward_without_states_ms": lambda: ts.launch_fused(
                    dt, A, B_, C_, x, Dv, None, y, h_fin)})
    entry = {"name": "scan_bwd", "source": SCAN_BWD_SOURCE,
             "replaces": PORT_ONLY.format("jax.grad of chunked_diag_scan, "
                                          "src/repro/models/mamba.py:68"),
             "launches": launches["selective_scan_fused_bwd"],
             "launches_by_path": {
                 "train_jamba": launches["selective_scan_fused_bwd"]},
             **scan_bwd_bound(B, S, D, N, 2),
             "library": "none: no PyTorch call computes the scan's backward",
             "plan": plan,
             "shape": {"B": B, "S": S, "D": D, "N": N, "dtype": "bfloat16",
                       "h0": False, "D_skip": True}}
    return bwd_kernel_timing(
        entry, cases, ("train", (B, S, D, N), "bfloat16", False, True, False),
        seed + 12, device, ts.selective_scan_fused_bwd_ref, scan_fwd_bwd,
        setup, edge,
        ("scan_bwd", "scan_bwd_finish"))


class FramesLoader:
    """A loader's batches with seeded encoder frames (rows, frames,
    d_model) bf16 added: one draw a step from `seed`, so a resumed run
    sees the same frames at the same step."""

    def __init__(self, loader, rows: int, frames: int, d_model: int,
                 seed: int):
        self.loader, self.shape, self.seed = loader, (rows, frames,
                                                      d_model), seed

    def batch(self, step: int) -> dict:
        import torch
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + step)
        return dict(self.loader.batch(step), frames=torch.randn(
            self.shape, generator=gen).to(torch.bfloat16))

    def batches(self, start: int, n: int):
        for step in range(start, start + n):
            yield step, self.batch(step)


def _all_launches() -> dict:
    from repro_torch.kernels import attention as ta
    from repro_torch.kernels import rwkv as tr
    from repro_torch.kernels import ssm as ts
    return {**ta.LAUNCHES, **tr.LAUNCHES, **ts.LAUNCHES}


def _reset_all_launches() -> None:
    from repro_torch.kernels import attention as ta
    from repro_torch.kernels import rwkv as tr
    from repro_torch.kernels import ssm as ts
    for mod in (ta, tr, ts):
        mod.reset_launches()


def _grad_check_pair(kernel_model, plain_model, batch, device, seed: int,
                     want: dict) -> dict:
    """One step's loss and every leaf's gradient through the kernels
    (`kernel_model`) against plain autograd through the plain versions
    (`plain_model`), the same seeded weights and batch; the kernel run's
    launches must be `want` (the rest 0), the plain run's all 0."""
    import torch

    from repro_torch.kernels import attention as ta
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.checkpoint import _paths

    params, _ = new_params(kernel_model, seed, device)
    leaves = tree_leaves(params)
    names = [n for n, _ in _paths(params)]
    out = {}
    for impl, m in (("cuda", kernel_model), ("ref", plain_model)):
        for leaf in leaves:
            leaf.requires_grad_(True)
        _reset_all_launches()
        loss = m.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        out[impl] = (float(loss.detach()), [g.float() for g in grads],
                     {k: v for k, v in _all_launches().items() if v},
                     dict(ta.BWD_ROUTES))
        del loss, grads
        torch.cuda.empty_cache()
    (lk, gk, nk, rk), (lp, gp, np_, _) = out["cuda"], out["ref"]
    if nk != want or np_:
        raise AssertionError(f"grad check launches {nk} (want {want}) / "
                             f"plain {np_}")
    per_leaf = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
                for n, a, b in zip(names, gk, gp)}
    per_leaf_max = {n: float((a - b).abs().max() / b.abs().max()
                             .clamp_min(1e-30))
                    for n, a, b in zip(names, gk, gp)}
    del params, leaves, gk, gp
    torch.cuda.empty_cache()
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel": abs(lk - lp) / abs(lp), "launches": nk,
            "bwd_routes": rk, "leaf_norm_rel": per_leaf,
            "leaf_max_rel": per_leaf_max,
            "tolerance": {"loss": GRAD_LOSS_TOL, "leaf": GRAD_LEAF_TOL}}


def shard_mesh(device) -> None:
    """The NCCL group of one rank (localhost, a free port) and the (1, 1)
    ("data", "model") mesh over it, in SHARD["mesh"]."""
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, device_id=device)
    SHARD["mesh"] = make_smoke_mesh(1, model=1)


def _placed(tree) -> dict:
    """How many leaves of `tree` are DTensors, and the distinct
    placements among them."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.common import tree_leaves
    leaves = tree_leaves(tree)
    return {"leaves": len(leaves),
            "dtensors": sum(isinstance(t, DTensor) for t in leaves),
            "placements": sorted({str(t.placements) for t in leaves
                                  if isinstance(t, DTensor)})}


def sharded_train_run(name: str, cfg, ckpts, ckpt_cfg, loader, every: int,
                      steps: int, whole, want: dict, device) -> dict:
    """The `sharded` phase's run on a training path: the path's
    step-`every` checkpoint restored onto SHARD["mesh"] by
    `reshard_restore`, then SHARD_STEPS[name] steps of
    `make_train_step(cfg, mesh=)` (the kernels through `local_map` on the
    rank's shards) on the batches the unsharded run took at steps every
    + 1, ...; their losses against that run's, the launches `want` a
    step (the rest 0), the step ms beside the unsharded run's."""
    import gc

    import torch

    from repro_torch.launch.elastic import reshard_restore
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training import CheckpointManager, OptimizerConfig

    n, mesh = SHARD_STEPS[name], SHARD["mesh"]
    bundle = make_train_step(
        cfg, OptimizerConfig(lr=TRAIN_LR, total_steps=steps,
                             warmup_steps=max(steps // 10, 1)), mesh=mesh)
    t0 = time.perf_counter()
    state, manifest = reshard_restore(CheckpointManager(ckpts, ckpt_cfg),
                                      bundle.model, mesh, step=every)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    placed = _placed(state)
    want_all = {k: 0 for k in _all_launches()}
    want_all.update({k: v * n for k, v in want.items()})
    losses, step_s = [], []
    # ---- the sharded path: counts zeroed before, read after ----------
    _reset_all_launches()
    for i in range(n):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in loader.batch(every + i).items()}
        t0 = time.perf_counter()
        state, metrics = bundle.fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = _all_launches()
    # -------------------------------------------------------------------
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ref = whole.losses[every:every + n]
    diff = max(abs(a - b) for a, b in zip(losses, ref))
    emit({"phase": "sharded", "run": name, "mesh": dict(zip(
        mesh.mesh_dim_names, mesh.shape)), "profile": "baseline",
        "restored_step": manifest["step"], "restore_s": restore_s,
        "placed": placed, "steps": n, "losses": losses,
        "unsharded_losses": ref, "max_abs_diff": diff,
        "bitwise": diff == 0.0, "tolerance_rel": SHARD_LOSS_TOL,
        "step_ms": [1e3 * t for t in step_s],
        "unsharded_step_ms": [1e3 * t for t in
                              whole.seconds[every:every + n]],
        "launches": launches, "launches_per_step": want})
    if placed["dtensors"] != placed["leaves"]:
        raise AssertionError(f"sharded {name}: {placed}")
    if launches != want_all:
        raise AssertionError(f"sharded {name} launched {launches}, "
                             f"expected {want_all}")
    if not diff <= SHARD_LOSS_TOL * max(abs(x) for x in ref):
        raise AssertionError(f"sharded {name}: losses {losses} vs the "
                             f"unsharded run's {ref}")
    return {"launches": launches, "bitwise": diff == 0.0}


def sharded_lm_run(cfg, params, prompt, tokens, device) -> dict:
    """The `sharded` phase's run on the `lm` path's model and weights: a
    prefill of `prompt` and SHARD_DECODE decode steps fed `tokens`
    through `make_prefill_step`/`make_decode_step(cfg, mesh=)` on the
    weights placed by the `baseline` rules, against the same unsharded;
    exactly one flash_attention launch a layer and step."""
    import torch

    from repro_torch.kernels import attention as ta
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.common import whole

    mesh = SHARD["mesh"]
    n, S = SHARD_DECODE, prompt.shape[1]

    def forced(prefill, decode, p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(p, {"tokens": prompt}, pad_to=S + n)
        out = [whole(logits)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(n):
            logits, cache = decode(p, cache, {"tokens": tokens[:, t:t + 1]})
            out.append(whole(logits))
        torch.cuda.synchronize()
        return torch.stack(out), t1 - t0, (time.perf_counter() - t1) / n, \
            cache

    one_p, one_d = make_prefill_step(cfg), make_decode_step(cfg)
    ref, ref_prefill_s, ref_decode_s, _ = forced(one_p.fn, one_d.fn, params)
    pre, dec = make_prefill_step(cfg, mesh=mesh), make_decode_step(
        cfg, mesh=mesh)
    sharded = pre.distribute(params)
    placed = _placed(sharded)
    # ---- the sharded path: counts zeroed before, read after ----------
    ta.reset_launches()
    got, prefill_s, decode_s, cache = forced(pre.fn, dec.fn, sharded)
    launches = dict(ta.LAUNCHES)
    # -------------------------------------------------------------------
    cache_placed = _placed({"k": cache["k"], "v": cache["v"]})
    del sharded, cache
    torch.cuda.empty_cache()
    err = float((got - ref).abs().max() / ref.abs().max())
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers * (1 + n)
    emit({"phase": "sharded", "run": "lm", "mesh": dict(zip(
        mesh.mesh_dim_names, mesh.shape)), "profile": "baseline",
        "layers": cfg.n_layers, "batch": prompt.shape[0], "prompt": S,
        "decode_steps": n, "placed": placed, "cache_placed": cache_placed,
        "max_err_over_max_logit": err, "bitwise": err == 0.0,
        "tolerance": SHARD_LOGIT_TOL, "prefill_ms": 1e3 * prefill_s,
        "unsharded_prefill_ms": 1e3 * ref_prefill_s,
        "decode_ms_per_step": 1e3 * decode_s,
        "unsharded_decode_ms_per_step": 1e3 * ref_decode_s,
        "launches": launches})
    if placed["dtensors"] != placed["leaves"] or \
            cache_placed["dtensors"] != 2:
        raise AssertionError(f"sharded lm: {placed} {cache_placed}")
    if launches != want:
        raise AssertionError(f"sharded lm launched {launches}, expected "
                             f"{want}")
    if not err <= SHARD_LOGIT_TOL:
        raise AssertionError(f"sharded lm logits differ by {err} of their "
                             "scale from the unsharded path's")
    return {"launches": launches["flash_attention"], "bitwise": err == 0.0}


def train_arch_phase(args, device, name: str, published, cfg, want: dict,
                     reduced: list, grad: dict, frames: int = 0,
                     steps: int = TRAIN_NEW_STEPS, every: int = TRAIN_NEW_CKPT,
                     profile: bool = False) -> dict:
    """`launch/train.py`'s flow on `cfg`: the logs index's
    keyword-filtered loader (with seeded frames when `frames`), `steps`
    AdamW steps (eager, remat) with async checkpoints every `every` into
    host memory, the launch counts `want` per step (the rest 0, every
    `flash_bwd` on the tensor cores); then a fresh run from other weights
    resumes from the middle checkpoint and must give the same losses bit
    for bit (with `profile`, one more step on its state under
    torch.profiler); then `grad`'s check (`_grad_check_pair` on its cut
    and sequence length)."""
    import gc
    import shutil
    import statistics as stats
    import tempfile

    import torch

    from repro_torch.kernels import attention as ta
    from repro_torch.launch.train import logs_store, make_loader, train
    from repro_torch.models import param_count
    from repro_torch.storage import InMemoryBlobStore
    from repro_torch.training import CheckpointConfig

    gc.collect()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="train-", dir=ROOT / "build")
    t0 = time.perf_counter()
    store = logs_store(workdir)
    loader = make_loader(store, cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_QUERY,
                         device)
    if frames:
        loader = FramesLoader(loader, TRAIN_BATCH, frames, cfg.d_model,
                              args.seed)
    setup_s = time.perf_counter() - t0
    ckpts = InMemoryBlobStore()
    ckpt_cfg = CheckpointConfig(keep_last_k=2)
    want_all = {k: 0 for k in _all_launches()}
    want_all.update({k: v * steps for k, v in want.items()})

    # ---- the main path: counts zeroed before, read after -------------
    _reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, state, whole = train(cfg, store, loader, steps=steps, lr=TRAIN_LR,
                            ckpt_every=every, device=device, log_every=1,
                            ckpt_config=ckpt_cfg, ckpt_store=ckpts,
                            seed=args.seed)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _all_launches()
    bwd_routes = dict(ta.BWD_ROUTES)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------
    n_params = param_count(state["params"])
    host_after = _host_mb()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if launches != want_all:
        raise AssertionError(f"{name} launched {launches}, expected "
                             f"{want_all}")
    if bwd_routes != ({"tc": want_all["flash_bwd"]}
                      if want_all["flash_bwd"] else {}):
        raise AssertionError(f"{name}'s attention backward took the routes "
                             f"{bwd_routes}, not the tensor cores' alone")
    saved = sorted(int(n.split("step-")[1][:10]) for n in
                   ckpts.list("ckpt/") if n.endswith("MANIFEST.json"))
    if saved != [every, steps]:
        raise AssertionError(f"{name} checkpoints at {saved}")
    for blob in ckpts.list(f"ckpt/step-{steps:010d}"):
        ckpts.delete(blob)               # the run is cut after `every`
    t0 = time.perf_counter()
    model, state, resumed = train(cfg, store, loader, steps=steps,
                                  lr=TRAIN_LR, ckpt_every=every,
                                  device=device, log_every=1,
                                  ckpt_config=ckpt_cfg, ckpt_store=ckpts,
                                  seed=args.seed + 1)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resume_launches = _all_launches()
    step_profile = (train_profile(model, state, loader.batch(steps), device)
                    if profile else None)
    roofline = (train_roofline(model, state, {
        k: torch.as_tensor(v, device=device)
        for k, v in loader.batch(steps).items()}, steps)
        if profile else None)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    sharded = (sharded_train_run(name, cfg, ckpts, ckpt_cfg, loader, every,
                                 steps, whole, want, device)
               if name in SHARD_STEPS else None)
    del ckpts
    gc.collect()
    tail = whole.losses[every:]
    diff = max(abs(a - b) for a, b in zip(tail, resumed.losses))
    batch = {k: torch.as_tensor(v, device=device)[:, :grad["seq"]]
             if k != "frames" else torch.as_tensor(v, device=device)
             for k, v in loader.batch(0).items()}
    t0 = time.perf_counter()
    check = _grad_check_pair(grad["kernel"], grad["plain"], batch, device,
                             args.seed, grad["want"])
    check.update(cut=grad["cut"], layers=grad["kernel"].cfg.n_layers,
                 seq=grad["seq"], wall_s=time.perf_counter() - t0)
    shutil.rmtree(workdir, ignore_errors=True)
    step_s = stats.median(whole.seconds[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"phase": name, "arch": published.name, "layers": cfg.n_layers,
          "dec_layers": cfg.n_dec_layers,
          "layers_published": published.n_layers, "params": n_params,
          "reduced": reduced, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "frames": frames or None, "steps": steps, "ckpt_every": every,
          "query": TRAIN_QUERY, "lr": TRAIN_LR, "remat": cfg.remat,
          "ce_chunk": cfg.ce_chunk, "setup_s": setup_s, "wall_s": wall_s,
          "losses": whole.losses, "first_loss": whole.losses[0],
          "last_loss": whole.losses[-1], "grad_norms": whole.grad_norms,
          "step_ms_median": 1e3 * step_s, "step_s": whole.seconds,
          "tokens_per_s": tokens / step_s, "peak_device_bytes": peak_bytes,
          "host_mb_after_run": host_after, "launches": launches,
          "launches_per_step": want, "bwd_routes": bwd_routes,
          "resumed_from": resumed.resumed_from, "resume_wall_s": resume_s,
          "resume_launches": resume_launches,
          "resumed_losses": resumed.losses, "resume_max_abs_diff": diff,
          "resume_bitwise": diff == 0.0, "grad_check": check,
          "step_profile": step_profile, "host_mb": _host_mb()})
    if not whole.losses[-1] < whole.losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: "
                             f"{whole.losses}")
    if resumed.resumed_from != every or \
            resumed.steps != list(range(every + 1, steps + 1)):
        raise AssertionError(f"{name}: resume ran steps {resumed.steps}")
    if diff != 0.0:
        raise AssertionError(f"{name}: resumed losses differ by {diff}: "
                             f"{tail} vs {resumed.losses}")
    if not (check["loss_rel"] <= GRAD_LOSS_TOL and max(
            check["leaf_norm_rel"].values()) <= GRAD_LEAF_TOL):
        raise AssertionError(f"{name}: gradients through the kernels vs "
                             f"plain: {check}")
    return {"launches": launches, "bwd_routes": bwd_routes,
            "grad_err": max(check["leaf_norm_rel"].values()),
            "sharded": sharded, "roofline": roofline, "step_s": step_s}


def train_rwkv_phase(args, device) -> dict:
    """rwkv6-3b at its published widths, RWKV_TRAIN_LAYERS of 32 layers:
    each step runs every layer's wkv forward twice (remat) and its
    backward once; the gradient check on a 1-layer cut at the full
    sequence."""
    from repro_torch.configs import get_config
    from repro_torch.models import RWKVModel
    published = get_config(RWKV_ARCH)
    cfg = published.with_(n_layers=RWKV_TRAIN_LAYERS)
    cut = published.with_(n_layers=1)
    L = cfg.n_layers
    return train_arch_phase(
        args, device, "train_rwkv", published, cfg,
        {"wkv": 2 * L, "wkv_bwd": L},
        [f"layers {L} of {published.n_layers}",
         "batch 2 of train_4k's 256"],
        {"kernel": RWKVModel(cut), "plain": RWKVModel(cut, wkv_impl="ref"),
         "cut": "1 layer", "seq": TRAIN_SEQ,
         "want": {"wkv": 2, "wkv_bwd": 1}})


def train_jamba_phase(args, device) -> dict:
    """jamba-v0.1-52b at its published widths as one period of 8 layers
    (7 Mamba layers and the attention slot) with every slot's FFN dense
    (`moe=None`): one period with its 4 MoE layers holds about 12.9 B
    parameters, about 155 GB of training state, beyond one card until
    sharding. Each step runs every Mamba layer's fused scan twice (the
    period is recomputed) and its backward once, the attention forward
    twice and `flash_bwd` once. The gradient check runs the same period
    on JAMBA_GRAD_SEQ tokens: the plain scan's autograd keeps (B, D, N)
    float32 states a step and layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import HybridModel
    published = get_config(JAMBA_ARCH)
    cfg = published.with_(n_layers=published.attn_every, moe=None)
    mamba = cfg.attn_every - 1
    return train_arch_phase(
        args, device, "train_jamba", published, cfg,
        {"selective_scan_fused": 2 * mamba,
         "selective_scan_fused_bwd": mamba, "flash_attention": 2,
         "flash_bwd": 1},
        [f"layers {cfg.n_layers} of {published.n_layers} (one period)",
         "moe None: every slot's FFN dense, no experts (one period with "
         "its 4 MoE layers is about 12.9 B parameters, 155 GB of training "
         "state)", "batch 2 of train_4k's 256"],
        {"kernel": HybridModel(cfg), "plain": HybridModel(
            cfg, scan_impl="ref", attn_impl="ref"),
         "cut": "the same period", "seq": JAMBA_GRAD_SEQ,
         "want": {"selective_scan_fused": 2 * mamba,
                  "selective_scan_fused_bwd": mamba, "flash_attention": 2,
                  "flash_bwd": 1}})


def train_encdec_phase(args, device) -> dict:
    """seamless-m4t-medium, all 12 + 12 layers, with seeded frames of
    ENCDEC_TRAIN_FRAMES a row: each step runs 36 attentions (the encoder's,
    the decoder's self and cross) forward twice and backward once; the
    gradient check on 1 + 1 layers."""
    from repro_torch.configs import get_config
    from repro_torch.models import EncDecModel
    published = get_config(ENCDEC_ARCH)
    cut = published.with_(n_layers=1, n_dec_layers=1)
    n = published.n_layers + 2 * (published.n_dec_layers or
                                  published.n_layers)
    return train_arch_phase(
        args, device, "train_encdec", published, published,
        {"flash_attention": 2 * n, "flash_bwd": n},
        ["batch 2 of train_4k's 256"],
        {"kernel": EncDecModel(cut), "plain": EncDecModel(
            cut, attn_impl="ref"), "cut": "1 + 1 layers", "seq": TRAIN_SEQ,
         "want": {"flash_attention": 6, "flash_bwd": 3}},
        frames=ENCDEC_TRAIN_FRAMES)


def int8_bound(B, S, T, H, KV, dh, q_bytes) -> tuple:
    """Least card time (ms) of int8 decode attention: K and V int8 and
    their bf16 scales read once, q read and o written once, against 4·dh
    int8 operations a (row, key) over the int8 tensor-core rate
    (`launch.roofline.int8_cost`)."""
    from repro_torch.launch import roofline as rl
    return float_bound(*rl.int8_cost(B, S, T, H, KV, dh, q_bytes), q_bytes,
                       rate=rl.INT8_OPS_PER_S)


def int8_inputs_random(B, T, H, KV, dh, gen, device) -> tuple:
    """bf16 q (B, 1, H, dh), random int8 k and v (B, T, KV, dh), their
    bf16 scales in [0.01, 0.03), and end-aligned causal positions."""
    import torch
    q = torch.randn(B, 1, H, dh, generator=gen, device=device).bfloat16()
    k8, v8 = (torch.randint(-127, 128, (B, T, KV, dh), generator=gen,
                            device=device, dtype=torch.int8)
              for _ in range(2))
    ks, vs = ((torch.rand(B, T, KV, generator=gen, device=device) * 0.02
               + 0.01).bfloat16() for _ in range(2))
    kw = {"causal": True,
          "q_positions": torch.tensor([T - 1], dtype=torch.int32,
                                      device=device),
          "kv_positions": torch.arange(T, dtype=torch.int32, device=device)}
    return q, k8, v8, ks, vs, kw


def int8_timing_phase(ta, device, seed: int, lm_int8: dict,
                      errs: dict) -> dict:
    """flash_decode_int8 at decode_32k's shape (B 128, T 32768, 64/8 heads
    of 128; 8.7 GB of int8 K/V and scales) by both routes in one call,
    against its bytes bound, its plain version, and the bf16 decode kernel
    (and SDPA) on the same cache dequantized to bf16 (17.2 GB); then at
    the `lm_int8` path's own shape (B LM_BATCH, T LM_PROMPT + LM_TOKENS)
    on the route its launches took."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as tk
    B, T, H, KV, dh = 128, 32768, 64, 8, 128
    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    q, k8, v8, ks, vs, kw = int8_inputs_random(B, T, H, KV, dh, gen, device)
    qpos, kpos = kw["q_positions"], kw["kv_positions"]
    plan = tk.plan_int8(B, T, KV, H // KV, dh)
    outs, timed = {}, {}
    for route in ("split", "cluster", "cluster", "split"):
        out = torch.empty_like(q)
        scratch = tk.int8_scratch(q, k8) if route == "split" else None
        ms = cuda_ms(lambda: ta.launch_int8(q, k8, v8, ks, vs, out, True,
                                            None, qpos, kpos, scratch,
                                            route=route),
                     flush, iters=10, warmup=2)
        timed.setdefault(route, []).append(ms)
        outs[route] = out
    want = ta.attention_int8(q, k8, v8, ks, vs, device=device, impl="ref",
                             **kw)
    err = {route: float((out.float() - want.float()).abs().max())
           / float(want.float().abs().max()) for route, out in outs.items()}
    plain_ms = cuda_ms(lambda: ta.attention_int8(
        q, k8, v8, ks, vs, device=device, impl="ref", **kw), flush, iters=3,
        warmup=1)
    del want
    kb = (k8.to(torch.bfloat16) * ks[..., None])
    del k8
    vb = (v8.to(torch.bfloat16) * vs[..., None])
    del v8
    torch.cuda.empty_cache()
    ob = torch.empty_like(q)
    bf16_ms = cuda_ms(lambda: ta.launch(q, kb, vb, ob, True, None, qpos,
                                        kpos), flush, iters=10, warmup=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kb, vb))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True), flush, iters=10, warmup=2)
    int8_vs_bf16 = float((outs["cluster"].float() - ob.float()).abs().max()
                         ) / float(ob.float().abs().max())
    bound_ms, bound_by, ops, nbytes = int8_bound(B, 1, T, H, KV, dh, 2)
    from repro_torch.launch import roofline as rl
    bf16_bound = 1e3 * (2 * B * T * KV * dh * 2 + 4 * B * H * dh) \
        / rl.HBM_BYTES_PER_S
    del kb, vb, qt, kt, vt, outs
    torch.cuda.empty_cache()
    for route, e in err.items():
        if not e <= INT8_TOL["bfloat16"]:
            raise AssertionError(f"flash_decode_int8 ({route}) at "
                                 f"decode_32k: {e}")

    # the lm_int8 path's shape, on the route its launches took
    pB, pT = LM_BATCH, LM_PROMPT + LM_TOKENS
    q, k8, v8, ks, vs, kw = int8_inputs_random(pB, pT, H, KV, dh, gen,
                                               device)
    path_plan = tk.plan_int8(pB, pT, KV, H // KV, dh)
    out = torch.empty_like(q)
    path_ms = cuda_ms(lambda: ta.launch_int8(
        q, k8, v8, ks, vs, out, True, None, kw["q_positions"],
        kw["kv_positions"]), flush, iters=30, warmup=5)
    want = ta.attention_int8(q, k8, v8, ks, vs, device=device, impl="ref",
                             **kw)
    path_err = float((out.float() - want.float()).abs().max()) / float(
        want.float().abs().max())
    path_plain_ms = cuda_ms(lambda: ta.attention_int8(
        q, k8, v8, ks, vs, device=device, impl="ref", **kw), flush)
    path_bound = int8_bound(pB, 1, pT, H, KV, dh, 2)
    if not path_err <= INT8_TOL["bfloat16"]:
        raise AssertionError(f"flash_decode_int8 at the lm_int8 shape: "
                             f"{path_err}")
    launches = lm_int8["launches"]["flash_decode_int8"]
    ms = statistics.median(timed["cluster"])
    return {"name": "flash_decode_int8", "route": "cuda",
            "source": INT8_SOURCE,
            "replaces": PORT_ONLY.format(
                "src/repro/models/blocks.py:112-147"),
            "launches": launches,
            "launches_by_path": {"lm_int8": launches},
            "routes": {"lm_int8": lm_int8["routes"],
                       "decode_32k": plan[0], "lm_int8_shape": path_plan[0]},
            "max_abs_err": max(max(errs.values()), *err.values(), path_err),
            "max_err_by_check": {"int8_edge": errs, "decode_32k": err,
                                 "lm_int8_shape": path_err},
            "tolerance": INT8_TOL, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "operations": ops,
            "bytes": nbytes, "library_ms": None,
            "library": "none computes int8 attention with these scales",
            "share_of_bound": bound_ms / ms,
            "split_ms": statistics.median(timed["split"]),
            "runs_ms": timed, "cluster_size": plan[1],
            "keys_per_block": plan[2],
            "split_plan": list(tk.plan_int8_split(B, T, KV)),
            "bf16_cache": {"flash_decode_bf16_ms": bf16_ms,
                           "sdpa_ms": sdpa_ms, "bound_ms": bf16_bound,
                           "int8_vs_bf16_max_err_over_scale": int8_vs_bf16},
            "shape": {"B": B, "S": 1, "T": T, "H": H, "KV": KV, "dh": dh,
                      "q_dtype": "bfloat16"},
            "path_shape": {"B": pB, "S": 1, "T": pT, "H": H, "KV": KV,
                           "dh": dh, "plan": list(path_plan),
                           "ms": path_ms, "plain_ms": path_plain_ms,
                           "bound_ms": path_bound[0],
                           "bound_by": path_bound[1],
                           "share_of_bound": path_bound[0] / path_ms}}


def build_phase(libraries) -> None:
    """One nvcc per kernel library, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.lib(), libraries))
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "libraries": {lib.name: {
              "nvcc_s": lib.build_info["seconds"],
              "library": lib.build_info["path"],
              "ptxas": [ln.strip() for ln in
                        lib.build_info["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling entry" in ln]}
              for lib in libraries}})


# ------------------------------------------------------------- roofline
ROOFLINE_BYTES_TOL = 0.01     # aten bytes, card against meta (relative)


def to_meta(tree):
    """`tree` (dicts, lists, tuples of tensors) with each tensor of rank >=
    1 on the meta device, same shape, dtype and strides; 0-dim tensors
    (the step count, the cache's position: read on the host) copied to
    the CPU."""
    import torch
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if tree.dim() == 0:
        return tree.detach().cpu().clone()
    return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype,
                               device="meta")


def count_step(name: str, fn, card_args: tuple) -> dict:
    """`fn` once under the port's counter (`launch.hlo_cost.analyze_step`)
    on the card, then on meta tensors of the same shapes: FLOPs and each
    kernel's launches, flops and bytes must be equal, the aten ops' bytes
    within ROOFLINE_BYTES_TOL. Returns the card's counts."""
    import torch

    from repro_torch.launch.hlo_cost import analyze_step
    meta_args = to_meta(card_args)
    card = analyze_step(fn, *card_args)
    torch.cuda.synchronize()
    meta = analyze_step(fn, *meta_args)

    def aten_bytes(summary):
        return summary.bytes_accessed - sum(
            b for _, _, b in summary.kernels.values())
    card_aten, meta_aten = aten_bytes(card), aten_bytes(meta)
    out = {"flops": card.flops, "bytes": card.bytes_accessed,
           "aten_bytes": card_aten, "meta_aten_bytes": meta_aten,
           "meta_flops": meta.flops,
           "kernels": {k: list(v) for k, v in card.kernels.items()},
           "temp_bytes": card.temp_bytes}
    if card.flops != meta.flops or card.kernels != meta.kernels:
        raise AssertionError(f"roofline {name}: the card counted "
                             f"{card.flops} flops and {card.kernels}, meta "
                             f"{meta.flops} and {meta.kernels}")
    if not abs(card_aten - meta_aten) <= ROOFLINE_BYTES_TOL * meta_aten:
        raise AssertionError(f"roofline {name}: aten bytes {card_aten} on "
                             f"the card, {meta_aten} on meta")
    return out


def lm_roofline(model, params, prompt, tokens) -> dict:
    """The `lm` path's prefill of `prompt` (room for LM_TOKENS more) and
    one decode step, each counted on the card and on meta (`count_step`)."""
    from repro_torch.launch.serve import prefill

    def pre(params, prompt):
        return prefill(model, params, prompt, LM_TOKENS)
    t0 = time.perf_counter()
    _, cache = pre(params, prompt)
    out = {"prefill": count_step("lm prefill", pre, (params, prompt)),
           "decode": count_step("lm decode", model.decode_step,
                                (params, cache,
                                 {"tokens": tokens[:, :1].contiguous()}))}
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in cache.values())
    out["count_s"] = time.perf_counter() - t0
    return out


def train_roofline(model, state, batch, steps: int) -> dict:
    """One more step of the `train` path's eager step (AdamW as `launch.
    train.train` configures it) on `state`, counted on the card and on
    meta (`count_step`)."""
    from repro_torch.training import OptimizerConfig
    from repro_torch.training.train_loop import make_train_step
    t0 = time.perf_counter()
    step = make_train_step(model, OptimizerConfig(
        lr=TRAIN_LR, total_steps=steps, warmup_steps=max(steps // 10, 1)))
    out = {"train": count_step("train", step, (state, batch))}
    out["count_s"] = time.perf_counter() - t0
    return out


def roofline_phase(card: str, lm: dict, train: dict) -> dict:
    """The `lm` path's prefill and decode step and the `train` path's
    step as counted on the card (and held to their meta counts by
    `count_step`), beside the step times those paths measured (untimed,
    outside the counter): `mfu` = counted FLOPs / (time × the bf16
    peak), and `launch.roofline`'s roofline fraction and bottleneck on
    one card."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.dryrun import count_params
    t0 = time.perf_counter()
    lm_cfg = get_config(LM_ARCH).with_(n_layers=lm["layers"])
    train_cfg = get_config(TRAIN_ARCH).with_(n_layers=TRAIN_LAYERS)
    steps = {
        "train": (train_cfg, ShapeCell("train", "train", TRAIN_SEQ,
                                       TRAIN_BATCH),
                  train["roofline"]["train"], train["step_s"]),
        "lm_prefill": (lm_cfg, ShapeCell("prefill", "prefill", LM_PROMPT,
                                         LM_BATCH),
                       lm["roofline"]["prefill"], lm["prefill_s"]),
        "lm_decode": (lm_cfg, ShapeCell("decode", "decode",
                                        LM_PROMPT + LM_TOKENS, LM_BATCH),
                      lm["roofline"]["decode"], lm["decode_step_s"]),
    }
    out = {}
    for name, (cfg, cell, counts, step_s) in steps.items():
        total, active = count_params(cfg)
        mbytes = rl.model_bytes(cfg, cell, active,
                                lm["roofline"]["cache_bytes"]) \
            if cell.step == "decode" else 0.0
        roof = rl.Roofline(counts["flops"], counts["bytes"], 0.0, 1, {},
                           rl.model_flops(cfg, cell, total, active), mbytes,
                           cell.step)
        out[name] = {
            "layers": cfg.n_layers, "batch": cell.global_batch,
            "seq": cell.seq_len, "flops": counts["flops"],
            "bytes": counts["bytes"], "aten_bytes": counts["aten_bytes"],
            "meta_aten_bytes": counts["meta_aten_bytes"],
            "kernels": counts["kernels"],
            "step_s": step_s,
            "mfu": counts["flops"] / (step_s * rl.PEAK_FLOPS),
            "roofline_fraction": roof.roofline_fraction,
            "achieved_over_bound": roof.t_bound / step_s,
            "bottleneck": roof.bottleneck, "t_bound_s": roof.t_bound,
            "model_flops": roof.model_flops_global}
    # the counting ran inside the two paths' phases (count_s)
    count_s = lm["roofline"]["count_s"] + train["roofline"]["count_s"]
    emit({"phase": "roofline", "nvidia_smi": card, "steps": out,
          "count_s": count_s, "wall_s": time.perf_counter() - t0 + count_s})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=250_000)
    ap.add_argument("--B", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-layers", type=int, default=8,
                    help=f"layers of {LM_ARCH}'s 64 on the LM path")
    ap.add_argument("--jamba-layers", type=int, default=8,
                    help=f"layers of {JAMBA_ARCH}'s 32 on the Jamba path "
                    "(a multiple of 8; its float32 check holds 4 bytes a "
                    "parameter, which one 80 GB card affords for 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also cProfile one bitmap and one sorted batch, "
                    "and trace a prefill and four decode steps of each LM "
                    "with torch.profiler")
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "kernels").is_dir():
        raise SystemExit(f"chip_smoke: the port's sources are not at {SRC}")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available()"
                         " is false)")
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.kernels import attention as ta
    from repro_torch.kernels import intersect as tx
    from repro_torch.kernels import rwkv as tr
    from repro_torch.kernels import ssm as ts
    from repro_torch.kernels.rwkv import cases as rwkv_cases
    from repro_torch.kernels.ssm import cases as ssm_cases

    device = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "numpy": np.__version__})

    # full float32 products in every plain version (PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase([tx.LIBRARY, ta.LIBRARY, tr.LIBRARY, ts.LIBRARY])
    shard_mesh(device)

    rng = np.random.default_rng(args.seed)
    errs = edge_phase(tx, device, rng)
    attn_errs = attn_edge_phase(ta, device, args.seed)
    wkv_errs = wkv_edge_phase(tr, device, args.seed)
    scan_errs = scan_edge_phase(ts, device, args.seed)
    int8_errs = int8_edge_phase(ta, device)
    bwd_errs = attn_bwd_edge_phase(ta, device)
    wkv_bwd_errs = bwd_edge_phase("wkv_bwd", tr.wkv_bwd_cuda,
                                  tr.wkv_bwd_ref, rwkv_cases, tr,
                                  {"wkv_bwd": 1}, device, args.seed)
    scan_bwd_errs = bwd_edge_phase(
        "scan_bwd", scan_fwd_bwd, ts.selective_scan_fused_bwd_ref,
        ssm_cases, ts, {"selective_scan_fused": 1,
                        "selective_scan_fused_bwd": 1}, device, args.seed)
    main = main_phase(args, device)
    serving = serving_phase(args, device, main)
    admin = cluster_admin_phase(args, device, main, serving)
    rag = rag_phase(args, device, serving)
    kernels = keys_timing_phase(tx, device, rng, main, errs)
    # the key route runs on three paths: `launches` stays the main path's,
    # and `launches_by_path` adds the serving and cluster_admin phases'
    for entry in kernels:
        route = KEY_ROUTES[entry["name"]]
        entry["launches_by_path"] = {
            "main": entry["launches"],
            "serving": sum(drive.get(route, 0) for drive in
                           serving["launches"].values()),
            "cluster_admin": admin["launches"].get(route, 0)}
    del main, serving
    lm = lm_phase(args, device)
    attn = attn_timing_phase(ta, device, args.seed, lm["shapes"], attn_errs)
    kernels.append(attn)
    rwkv = rwkv_phase(args, device)
    wkv = wkv_timing_phase(tr, device, args.seed, rwkv["shapes"], wkv_errs)
    wkv["launches_by_path"] = {"rwkv": wkv["launches"]}
    kernels.append(wkv)
    jamba = jamba_phase(args, device)
    scan = scan_timing_phase(ts, device, args.seed, jamba["shapes"],
                             scan_errs)
    scan["launches_by_path"] = {"jamba": scan["launches"]}
    kernels.append(scan)
    mixtral = mixtral_phase(args, device)
    vlm = vlm_phase(args, device)
    encdec = encdec_phase(args, device)
    attn_paths_timing(ta, device, args.seed, attn, mixtral, vlm, encdec)
    lm_int8 = lm_int8_phase(args, device)
    kernels.append(int8_timing_phase(ta, device, args.seed, lm_int8,
                                     int8_errs))
    train = train_phase(args, device)
    bwd = bwd_timing_phase(ta, device, args.seed, train["launches"],
                           bwd_errs, train)
    kernels.append(bwd)
    roofline_phase(card, lm, train)
    train_rwkv = train_rwkv_phase(args, device)
    kernels.append(wkv_bwd_timing_phase(tr, device, args.seed,
                                        train_rwkv["launches"],
                                        wkv_bwd_errs))
    train_jamba = train_jamba_phase(args, device)
    kernels.append(scan_bwd_timing_phase(ts, device, args.seed,
                                         train_jamba["launches"],
                                         scan_bwd_errs))
    train_encdec = train_encdec_phase(args, device)
    # the forward kernels' training launches, and flash_bwd's on every
    # training path (all on the tensor cores, asserted by each phase)
    for entry, path, key, phase in (
            (wkv, "train_rwkv", "wkv", train_rwkv),
            (scan, "train_jamba", "selective_scan_fused", train_jamba)):
        entry["launches_by_path"][path] = phase["launches"][key]
        entry["launches"] = sum(entry["launches_by_path"].values())
    for path, phase in (("train_jamba", train_jamba),
                        ("train_encdec", train_encdec)):
        bwd["launches_by_path"][path] = phase["launches"]["flash_bwd"]
        bwd["routes"]["tc"]["launches"] += phase["bwd_routes"].get("tc", 0)
    bwd["launches"] = sum(bwd["launches_by_path"].values())
    # the attention kernel runs on eight paths: its launches and its
    # errors against the plain version are summed over all
    attn["launches_by_path"] = {"lm": attn["launches"],
                                "jamba": jamba["attn_launches"],
                                "rag": rag["launches"],
                                "mixtral": mixtral["launches"],
                                "vlm": vlm["launches"],
                                "encdec": encdec["launches"],
                                "lm_int8": lm_int8["launches"][
                                    "flash_attention"],
                                "train": train["launches"][
                                    "flash_attention"],
                                "train_jamba": train_jamba["launches"][
                                    "flash_attention"],
                                "train_encdec": train_encdec["launches"][
                                    "flash_attention"]}
    # the sharded phase's launches (one card, its kernels on local shards)
    attn["launches_by_path"]["sharded_lm"] = lm["sharded"]["launches"]
    for path, phase in (("sharded_train", train),
                        ("sharded_train_jamba", train_jamba),
                        ("sharded_train_rwkv", train_rwkv)):
        got = phase["sharded"]["launches"]
        for entry, key in ((attn, "flash_attention"), (bwd, "flash_bwd"),
                           (wkv, "wkv"), (scan, "selective_scan_fused")):
            if got[key]:
                entry["launches_by_path"][path] = got[key]
        for kname, key in (("wkv_bwd", "wkv_bwd"),
                           ("scan_bwd", "selective_scan_fused_bwd")):
            if got[key]:
                entry = next(e for e in kernels if e["name"] == kname)
                entry.setdefault("launches_by_path", {})[path] = got[key]
    for entry in (bwd, wkv, scan, *[e for e in kernels if e["name"] in
                                    ("wkv_bwd", "scan_bwd")]):
        entry["launches"] = sum(entry["launches_by_path"].values())
    attn["launches"] = sum(attn["launches_by_path"].values())
    for errs_of_path in (jamba["attn_errs"], rag["errs"], mixtral["errs"],
                         vlm["errs"], encdec["errs"]):
        for dtype, err in errs_of_path.items():
            attn["max_abs_err_by_dtype"][dtype] = max(
                attn["max_abs_err_by_dtype"][dtype], err)
    attn["max_abs_err"] = max(attn["max_abs_err_by_dtype"].values())
    emit({"kernels": kernels})
    import torch.distributed as dist
    dist.destroy_process_group()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
