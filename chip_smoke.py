#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases:
  1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source into ``build/kernels``, all started together), report
     each source's registers and spills, and print the card's name and
     power limit;
  2. hold ``block_spmm`` against its plain PyTorch version on the card, at
     unit shapes (small integers, values above 255 in every K slab or in
     some, counts near 2^24), at fp32-route shapes whose plan splits K
     (every operand, semiring, output and mask case; two launches
     bit-identical) and at the FinBench workload shape, and time kernel,
     plain version and a ``torch.matmul`` fp32 yardstick;
  3. the SNB main path: ``snb_like(seed=0)`` through ``GraphSession``,
     the workload driver's table run as checks: each read without views,
     three fused view builds, each read with views equal in rows to the
     same read without, then CE/DE/DV with recover and every view
     ``check_consistency``; it reports the reads compared, the views
     checked and the writes' targets (``mvbench/`` times this path);
  4. FinBench the same way through the kernel: a session with dense hops
     on ``block_spmm`` against a segment-hop session, every read bit-exact
     in reach rows and DBHit/Rows before and after the writes, both
     sessions' views consistent and storing the same pairs; the u8 K
     slabs that took the CUDA cores in phases 3-4 are counted after;
  5. segment aggregation: ``segment_multi_agg`` against its plain version
     at unit shapes (ragged N, W from 1 to 70, rows all valid and empty,
     one to three column chunks), and on messages bucketed from the
     SNB graph and from one ten times its size, in fp32 and bf16, with max
     and min bit for bit against a scatter formulation; each SNB shape
     timed on the device from a profiler trace with the L2 flushed, per
     call with the host, beside its byte bound, its plain version and
     ``bucketize_messages``; NaN cases (a NaN of a valid slot reaches all
     four outputs, one of an invalid slot neither max nor min); then its
     main path, ``bucketize_messages`` + ``segment_multi_agg`` at both SNB
     shapes, checked against the scatter formulation;
  6. attention: ``flash_attention`` against its plain version at the
     reference's test shapes (fp32), at decode shapes that split over keys
     (bf16 and fp32, two fp32 launches bit for bit) and at starcoder2-3b
     and gemma-2b shapes (bf16), timed beside
     ``scaled_dot_product_attention``, the fp32 route at one unit shape and
     at starcoder2-3b's chunked decode and prefill beside its bound, its
     planned split and SDPA on fp32 inputs; then its main path, the three
     model shapes once more;
  7. serving, after phase 4's sessions are freed: (a) SNB through
     ``GraphSession.serve`` with the workload driver's serve script (each
     read unbound and for 16 clients bound to one start node, a fence a
     round, 2 rounds), every ticket equal to a sequential twin's
     ``query``/``apply_writes`` replay; (b) the same on FinBench with the
     served session's dense hops on ``block_spmm`` against a segment-hop
     twin; (c) online view selection on SNB against a views-off engine (4
     rounds);
  8. the view-fed GNN on SNB: SAGE trains on the ``REFRESH DEFERRED`` view
     KNOWS2 through ``train_on_view`` (3 epochs, segment path, finite
     losses); one ``knows`` write rebuilds the maintained CSR once and its
     batch equals a views-off twin's re-extraction; ``embed_on_view``
     through ``block_spmm``'s fp32 route over KNOWS2 and ROOT_POST equals
     the segment path; a ``ViewEmbedder`` behind a ``ServeEngine``
     answers before and after a ``knows`` fence; then one launch at each
     view's shape is held to the plain version and to a second launch,
     and timed beside ``torch.matmul`` with its split-K plan;
  9. sharded execution on SNB at half scale: a session with
     ``ExecConfig(data_shards=4)`` and ``shard_devices=["cuda:0"] * 4``
     (four logical shards on one card, named explicitly) held read by read
     to an unsharded session on the same graph, without and with views,
     through CE/DE/DV with recover, then through a cut of phase 7a's serve
     script (every ticket and the shared groups equal); it prints the
     sweeps by owner shard, its seconds and its peak device memory;
 10. the side stacks: (a) PNA at full width on a padded random graph of
     2,708 nodes and 10,556 edges, forward pass, loss and gradient on the
     card equal to the CPU's, timed; PNA's aggregation (segment ops, the
     path PNA takes) held to ``segment_multi_agg`` at the SNB x10 messages
     of phase 5 and timed beside it; (b) starcoder2-3b at full width
     (4.16 B parameters, bf16, drawn on the card from a seed) served by the
     LLM engine, 8 requests through 4 slots, every request at its length
     and a repeated prompt giving the same output, with prefill and decode
     times, tokens/s, peak memory and the decode step's byte bound; then
     ``chunked_attention`` at the prefill shape beside ``flash_attention``
     and SDPA; (c) starcoder2-3b and qwen2-moe-a2.7b at full width cut to 2
     layers in fp32, prefill and decode steps on the card equal to the CPU,
     and the 4-slot engine's outputs equal to each request served alone;
 11. training and the last side stacks: (a) starcoder2-3b at full width
     (bf16, remat, weights drawn on the card) trained 3 steps of
     ``make_train_step`` with fp32 AdamW moments, each step two
     microbatches of 4,096 tokens, with the loss, ms, tokens/s, model
     FLOP/s against the bf16 peak and the peak memory (under 79 GB); one
     step at 2 layers in fp32 on the card equal to the CPU (loss,
     gradients, updated parameters); (b) ``launch/train.py``'s 100m preset,
     40 steps with checkpoints every 10 and a failure injected at step 25,
     recovering once to within 5e-2 of an uninterrupted run's final loss,
     and a state with 8-bit moments saved and restored bit for bit; (c)
     DimeNet, NequIP and MACE at full width on 128 molecules of 30 atoms,
     forward, loss and gradient on the card equal to the CPU, 3 trainer
     steps timed, NequIP's forces, and (NequIP, MACE) energies invariant
     and forces rotating under a rotation; (d) MIND at full width, loss and
     gradient at a batch of 256, ``score_candidates`` at 512 x 100 and
     ``retrieval_scores`` over its 1,000,000 items on the card equal to
     the CPU, then 3 trainer steps at a batch of 32,768 (the shape's
     65,536 halved for memory) with the peak memory.

 12. the multi-device layer: four ranks on the one card, started by
     ``launch/spawn.py`` with backend gloo named explicitly (collectives
     staged through host memory), a 2 data x 2 model mesh: (a)
     qwen2-moe-a2.7b's MoE layer at full width (60 experts top-4, d_model
     2,048, bf16, 2 x 4,096 tokens a data rank) expert-parallel, equal to
     ``moe_apply`` forward and backward at capacity factor 15 (nothing
     drops; each rank in turn holds the single-process twin), then at the
     config's 1.25 its dropped share, ms and collectives; (b) PNA at full
     width on phase 10a's graph, dst-partitioned over the 4 ranks, forward,
     loss and gradient equal to the single-process run; (c)
     context-parallel attention at yi-34b's heads (56 q / 8 kv, Dh 128, S
     4,096, B 2, bf16) equal to ``chunked_attention`` forward and backward,
     and ``combine_partials`` of split-KV decode equal to
     ``decode_attention``; then on a 4 x 1 mesh over the same ranks (d)
     the 100m preset's compressed data-parallel step, 2 steps, parameters,
     moments, loss and error feedback against the one-process step over 4
     shards, and (e) MIND at full width, its in-batch logits' rows over the
     4 ranks at a batch of 32,768, loss and gradients equal to rank 0's
     single-process run; it prints each sub-phase's seconds, collectives
     and per-rank peak memory.

 13. the cells (``launch/steps.py``): the same four ranks on a 2 x 2 mesh
     run the per-rank programs ``build_cell`` makes for qwen2-moe-a2.7b at
     full width cut to 2 layers: (a) ``train_4k`` (sequence-parallel
     boundaries, TP attention with 16 heads over 2, expert parallelism on
     the sequence slices, vocab-parallel loss, ZeRO gathers) at a global
     batch of 2 sequences of 4,096 tokens, one fp32 step equal to the
     single-process twin (loss, gradient norm, every updated parameter and
     moment block; each rank in turn holds the twin), then a bf16 step
     timed beside the bound the port's dry run counts for the same cell on
     the same mesh; (b) ``decode_32k`` at a batch of 4 against the full
     32,768-position cache (split-KV over the model axis,
     ``dispatch_pspec``'s expert layer), one fp32 step, timed, equal to
     the twin (logits, cache blocks).

``python3 chip_smoke.py --only=snb,finbench,sharded,pna,llm,train,molecular,recsys,multidevice,cells``
runs the named phases alone (after the build; ``pna`` and ``llm`` are
phase 10's halves; ``train``, ``molecular`` and ``recsys`` phase 11's:
11a-b, 11c and 11d; ``multidevice`` phase 12; ``cells`` phase 13) and
prints no result line.

Each kernel's launch count is zeroed just before its main path and read
just after it: phases 3-4, the serve run of 7b and phase 8's path for
``block_spmm``, the ends of phases 5 and 6 for the others (comparison
launches do not count); phase 9, whose hops are all segment hops, must
launch none, and phases 10 and 11, whose reference modules call no
kernel, must launch none either; phase 12's and 13's ranks check that they
launched none.  ``block_spmm`` and
``flash_attention`` also count launches by route: ``tc`` (tensor cores)
and ``fp32`` (CUDA cores).  Every failed check raises, so the script exits
non-zero and prints no result line.  It needs one CUDA device; without one
it exits with code 2.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# card peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

UNIT_SHAPES = [(8, 16, 12), (128, 128, 128), (100, 200, 150), (256, 384, 128)]
# fp32 route shapes whose few output tiles make the kernel split K: S <= 128
# with K >= 8,192, aligned; the ragged (100, 9000, 150) (N % 4 != 0, and
# K % 16 != 0 for a uint8 F); and one with K % 4 != 0 as well.  Each in
# count (fp32, int32 out) and bool (fp32, int32, uint8 out), masked or not,
# for F x A in fp32 x fp32, fp32 x int32, int32 x fp32, bool x fp32
FP32_SPLIT_SHAPES = [(64, 8192, 128), (100, 9000, 150), (37, 8195, 61)]
FP32_SPLIT_OPERANDS = [(torch.float32, torch.float32),
                       (torch.float32, torch.int32),
                       (torch.int32, torch.float32),
                       (torch.bool, torch.float32)]
FP32_SPLIT_OUTS = [(True, torch.float32), (True, torch.int32),
                   (False, torch.float32), (False, torch.int32),
                   (False, torch.uint8)]
WORKLOAD_SHAPE = (256, 27264, 27264)   # src_block x node_cap x node_cap
# frontier rows of the serve path's adaptive blocks (8, 16, ..., 256) at
# the FinBench shape: checked exactly at these rungs, timed at 8 and 256
SERVE_ROWS = (8, 16, 64)

# segment_multi_agg: the reference's test shapes [N, W, D], then W > 64,
# W = 1 and two slot chunks, with N not a multiple of the kernel's 8 rows a
# block, at widths that fill every lane's columns (D = 96) or not (75), and
# in three column chunks of 128 (300, 333); the reference's tolerances;
# messages of PNA's full width (d_hidden = 75) on the SNB graph's edges, at
# the generator's defaults and at ten times its sizes (SNB_X10), where the
# valid slots' messages alone outgrow the card's 50 MB L2
AGG_UNIT_SHAPES = [(16, 4, 8), (64, 16, 128), (33, 7, 75), (257, 70, 96),
                   (9, 1, 75), (50, 33, 333), (40, 40, 300)]
AGG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
AGG_OUTPUTS = ("mean", "max", "min", "std")
PNA_D_HIDDEN = 75
SNB_X10 = {"n_person": 20000, "n_post": 15000, "n_comment": 120000,
           "n_place": 600, "n_tag": 3000}
L2_FLUSH_BYTES = 128 << 20          # 2.5 times the H100's 50 MB L2

# flash_attention: unit shapes (B, Hq, Hkv, Sq, Sk, D) in fp32 -- the
# reference's test shapes, then decode (Sq < Sk, ragged) and grouped-KV
# shapes that hold the shifted diagonal and the head mapping -- and model
# shapes in bf16, causal, from the configs of starcoder2-3b (24 query heads
# over 2 KV heads, head_dim 128) and gemma-2b (8 over 1, head_dim 256)
ATTN_UNIT_SHAPES = [(1, 2, 2, 128, 128, 64), (2, 4, 4, 256, 256, 128),
                    (1, 1, 1, 384, 384, 128), (1, 4, 2, 100, 173, 64),
                    (1, 6, 2, 128, 4096, 128), (1, 4, 1, 64, 300, 256)]
# decode shapes whose few query blocks make both kernels split over keys,
# with a shorter last chunk: bf16 11 chunks of 6, 6, ..., 4 kv tiles of 64
# keys and 32 chunks of 3, ..., 1 tiles of 32 keys, the last one ragged;
# fp32 (32-key tiles, its occupancy on 132 SMs) 11 chunks of 12, ..., 8
# and 16 chunks of 6, ..., 4
ATTN_SPLIT_SHAPES = [(1, 24, 2, 1, 4096, 128), (1, 8, 1, 37, 3001, 256)]
# the fp32 route's timed shape, one of the unit shapes, causal
ATTN_FP32_TIMED = (2, 4, 4, 256, 256, 128)
ATTN_MODEL_SHAPES = {
    "starcoder2-3b prefill": (1, 24, 2, 4096, 4096, 128),
    "starcoder2-3b chunked decode": (1, 24, 2, 128, 4096, 128),
    "gemma-2b prefill": (1, 8, 1, 4096, 4096, 256),
}
# the fp32 route's timed shapes, causal: the unit shape above, then
# starcoder2-3b's chunked decode (split over keys) and prefill (not split)
ATTN_FP32_SHAPES = {
    "timed": ATTN_FP32_TIMED,
    "starcoder2-3b chunked decode":
        ATTN_MODEL_SHAPES["starcoder2-3b chunked decode"],
    "starcoder2-3b prefill": ATTN_MODEL_SHAPES["starcoder2-3b prefill"],
}
# the fp32 kernel's device work a call: the attention kernel and, split
# over keys, the merge of its chunks
ATTN_FP32_KERNELS = ("flash_fp32_kernel", "merge_kernel")
# (rtol, atol).  Kernel and plain version both compute in fp32 and round
# once to the output type, so a bf16 output may differ by one bf16 step
# (2^-8 to 2^-7 of its magnitude) and no more; a diagonal shifted by one
# key at the decode shape moves outputs by several steps.
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-4)}

# phase 7: the workload driver's serve script (clients bound to one random
# start node each, one fence a round) and the online bench's rounds, cut
# from 12 to 6 (12 rounds took 197 s of a 538 s smoke on an NVIDIA H100
# 80GB HBM3 at 700 W), then to 4 once phase 11 joined the smoke (the whole
# call took 626.6 s of command with 6 rounds on that card): the selector
# evaluates once, after round 3 (8 clients in place of 16 took as long:
# 7a 76.9-77.4 s against 77.9 s on an NVIDIA H100 80GB HBM3 at 700 W)
SERVE_CLIENTS = 16
SERVE_ROUNDS = 2
ONLINE_ROUNDS = 4
# phase 9: the sharded session, 4 logical shards on one card, and the cut
# of phase 7a's serve script it serves beside its unsharded twin (with the
# scheduler's window pinned, so both make the same decisions); on SNB cut
# to half its scale once phase 12 joined the smoke (full SNB took 122.8 s
# of a 599.1 s call on an NVIDIA H100 80GB HBM3 at 700 W, phase 12 63 s)
SHARD_SCALE = 0.5
SHARDS = 4
SHARD_SERVE_CLIENTS = 4
SHARD_SERVE_ROUNDS = 1
SHARD_SERVE_WINDOW = 64
# phase 8: the reference GNN bench's view and policy
# (benchmarks/run.py::bench_gnn) on full SNB, beside ROOT_POST
KNOWS2_MATCH = "MATCH (a:Person)-[:knows]->(m:Person)-[:knows]->(b:Person)"
KNOWS2_DDL = ("CREATE VIEW KNOWS2 AS (CONSTRUCT (a)-[r:KNOWS2]->(b) "
              + KNOWS2_MATCH + ") REFRESH DEFERRED")
# (rtol, atol): SAGE through block_spmm against its segment path, the
# reference's own tolerance for its Pallas path (tests/test_view_gnn.py)
EMBED_TOL = (2e-4, 2e-4)
# phase 10: PNA at full width (configs/pna.py) on a random graph of
# full_graph_sm's size (configs/shapes.py: 2,708 nodes, 10,556 edges, 1,433
# features); starcoder2-3b at full width served by the LLM engine (4 slots,
# max_len 1,024, 8 requests of 64-512 prompt tokens, 32 new tokens each);
# card-against-CPU parity at full width cut to 2 layers in fp32, on prompts
# of PARITY_PROMPT tokens
PNA_GRAPH = (2708, 10556)
LLM_SLOTS = 4
LLM_MAX_LEN = 1024
LLM_REQUESTS = 8
LLM_PROMPT_LENS = (64, 512)
LLM_NEW_TOKENS = 32
PARITY_LAYERS = 2
PARITY_PROMPT = 96
# (rtol, atol as a share of the CPU value's largest magnitude): the card
# against the CPU in fp32, where only the summation orders differ (cuBLAS
# against the CPU's GEMMs, atomic scatter sums).  PNA's gradient gets a
# wider atol: ReLU derivatives and max/min selections are discontinuous, so
# another summation order can flip a pre-activation near zero or a near tie
# and move gradient mass.  A parting of two greedy outputs is taken only
# where the top two logits lie within NEAR_TIE of the logit scale.
FP32_TOL = (1e-4, 1e-4)
PNA_GRAD_TOL = (1e-4, 2e-3)
NEAR_TIE = 1e-4
# phase 11: starcoder2-3b trained at full width on LM_SHAPES["train_4k"]'s
# sequence of 4,096 tokens, its global batch of 256 cut to 2 (two
# microbatches of one sequence a step) for memory and time, and checked
# against the CPU at 2 layers on shorter sequences; launch/train.py's 100m
# preset with a failure injected at step CLI_FAIL of CLI_STEPS; the
# molecular GNNs on GNN_SHAPES["molecule"] (128 molecules of 30 atoms and
# 64 bonds), padded to 512 as the reference's cell pads them; MIND on
# RECSYS_SHAPES' serve_p99 and retrieval_cand, and on train_batch halved
# from 65,536 to 32,768: at 65,536 the [B, B] fp32 in-batch logits (17.2
# GB) and three such buffers of their backward ran out of the card's 80 GB
# (an NVIDIA H100 80GB HBM3 at 700 W: 16 GiB asked with 67.3 GiB held)
TRAIN_SEQ = 4096
TRAIN_ACCUM = 2
TRAIN_STEPS = 3
TRAIN_PARITY_SEQ = 128
TRAIN_MEM_LIMIT = 79e9
PEAK_NAME = "NVIDIA H100 SXM bf16 dense, 989 TFLOP/s (data sheet)"
CLI_STEPS = 40
CLI_FAIL = 25
CLI_CKPT_EVERY = 10
MOLECULE = (30, 64, 128)
MOLECULE_PAD = 512
GNN_STEPS = 3
MIND_BATCH = 32768
MIND_STEPS = 3
MIND_SERVE = (512, 100)
# phase 12: four ranks on one card (gloo, collectives staged through host
# memory), a 2 data x 2 model mesh, then 4 x 1 for the data-parallel parts;
# qwen2-moe-a2.7b's MoE layer at full width on 2 x 4,096 tokens a data
# rank, with drops off (capacity factor E/K = 15) and at its 1.25; PNA on
# phase 10a's graph; yi-34b's attention heads at 4,096 tokens; the 100m
# preset's compressed step; MIND at phase 11d's batch
MD_RANKS = 4
MD_MESH = (2, 2)
MD_DP_MESH = (4, 1)
MD_TIMEOUT = 600.0
MD_MOE_TOKENS = (2, 4096)
MD_CP = (2, 56, 8, 4096, 128)        # B, Hq, Hkv, S, Dh
MD_DECODE_LEN = (3001, 4096)
MD_DP_BATCH = (8, 128)
MD_STEPS = 2                         # 12d's steps, cut from 3 for phase 13
# bf16 results against a single-process twin: relative Frobenius error
# (a wrong block order or a lost term is of order 1; bf16 rounding of two
# differently shaped GEMMs a few 2^-9); a token whose top-k experts differ
# between the two runs is taken only at a near tie of its router logits
BF16_REL = 2.0 ** -5
MOE_NEAR_TIE = 0.05
# phase 13: the cells of launch/steps.py, each a per-rank program, on four
# ranks of the one card (gloo, a 2 data x 2 model mesh): qwen2-moe-a2.7b
# at full width cut to 2 layers; train_4k's global batch of 256 sequences
# of 4,096 tokens cut to 2 (one a data rank; the fp32 twin's logits alone
# take 5 GB a sequence), decode_32k's 128 sequences cut to 4 against the
# full 32,768-position cache
CELL_ARCH = "qwen2-moe-a2.7b"
CELL_MESH = (2, 2)
CELL_LAYERS = 2
CELL_TRAIN = (2, 4096)               # global batch, sequence
# the fp32 parity step's batch: its capacity lets every expert take every
# token (nothing drops), so its dense expert buffers are E/K = 15 times the
# routed work (at 4,096 tokens a twin step's buffers hold 3.4 PFLOP of fp32
# GEMMs, about 50 s at the 67 TFLOP/s peak), so parity runs 2 sequences of
# 256 tokens, the timed bf16 step the cell's 2 x 4,096 at its capacity
CELL_PARITY = (2, 256)
CELL_DECODE = (4, 32768)
CELL_TIMED = 2                       # bf16 steps timed, the first cold
CELL_SEED = 5
CELL_TIMEOUT = 420.0
# fp32 parity against the single-process twin, as phase 11's: each leaf
# within CELL_TOL of the twin's largest magnitude in that leaf
CELL_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` calls in a row (after
    one warm-up), by CUDA events: it holds the host's time to issue each
    call wherever that exceeds the device's work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str = "", iters: int = 20,
              flush: bool = True, per_launch: bool = False) -> float:
    """Mean device time per call of ``fn``: the device work whose name
    holds ``kernel`` (all of it where ``kernel`` is empty), summed from a
    ``torch.profiler`` trace, so no host time enters.  With ``flush``, a
    128 MB write evicts the L2 before each call (it is not counted), as a
    caller that moved other data just before would leave it.  With
    ``per_launch``, for kernels that ``fn`` launches once a call each: the
    mean over each kernel's traced launches, summed over the kernels, so a
    trace that dropped some launches (the profiler can, late in a long
    process) still gives the call's time."""
    from torch.profiler import ProfilerActivity, profile
    check(bool(kernel) or not flush, "device_ms would count the L2 flush")
    buf = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
           if flush else None)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if buf is not None:
                buf.zero_()
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and kernel in e.name:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    n = sum(len(v) for v in by_name.values())
    check(n >= (1 if per_launch else iters),
          f"the profiler saw {n} device ops named {kernel!r} in {iters} "
          f"calls")
    if per_launch:
        return sum(sum(v) / len(v) for v in by_name.values()) / 1e3
    return sum(sum(v) for v in by_name.values()) / iters / 1e3


def reset_launches(ops) -> None:
    for fn in (ops.block_spmm, ops.spmm_slab_map, ops.segment_multi_agg,
               ops.flash_attention):
        fn.launches = 0
    for fn in (ops.block_spmm, ops.flash_attention):
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


# ---------------------------------------------------------------------------
# phase 2: block_spmm against its plain version
# ---------------------------------------------------------------------------

def spmm_bound_ms(S: int, K: int, N: int) -> tuple:
    """The least time of an int32 count hop: the larger of 2·S·K·N over
    the int8 tensor-core peak (integer operands multiply exactly there)
    and int32 F, A and out moved once over the memory rate."""
    t_ops = 2.0 * S * K * N / PEAK_INT8_OPS
    t_bytes = 4.0 * (S * K + K * N + S * N) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def wide_cases(dev) -> dict:
    """Integer operands outside the u8 range, each with the number of
    (block, K slab) pairs that must take the CUDA cores: values above 255
    in every slab, in one slab only, and walk counts near 2^24 (below it,
    where the plain fp32 version is exact).  Shapes (S, K, N) = (130, 200,
    150): one block of two row tiles per column block, two column blocks,
    four K slabs."""
    g = np.random.default_rng(1)
    S, K, N = 130, 200, 150
    F = g.integers(0, 3, (S, K))
    A = (g.random((K, N)) < 0.3).astype(np.int64)
    above = (F * g.integers(100, 1000, (S, K)), A * g.integers(1, 300, (K, N)))
    Fm, Am = F.copy(), A.copy()
    Fm[:, 64:128] *= 300
    Am[64:128] *= 257
    Fn, An = np.zeros((S, K), np.int64), np.zeros((K, N), np.int64)
    Fn[:, 7], An[7] = 16000, 1040          # 16,640,000 < 2^24 = 16,777,216
    Fn[:, 100:200], An[100:200] = 2, 3
    cases = {"above 255": (*above, 8), "mixed slabs": (Fm, Am, 2),
             "near 2^24": (Fn, An, 2)}
    out = {}
    for name, (f, a, n_slow) in cases.items():
        check(int((f @ a).max()) < 2 ** 24, f"{name}: a sum reaches 2^24")
        out[name] = (torch.from_numpy(f.astype(np.int32)).to(dev),
                     torch.from_numpy(a.astype(np.int32)).to(dev), n_slow)
    return out


def finbench_like_adjacency(K: int, tile: tuple, dev) -> tuple:
    """An int32 [K, K] adjacency shaped as one of FinBench's: node ids
    contiguous by label, every edge inside one label block (the second
    quarter of the ids) from a source to 1 + zipf(1.8) ids past it, so
    the live tiles hug the diagonal, most column blocks hold no edge and
    lists end in -1 tails; one far transfer, from the block's first id to
    its last, leaves a gap in its column block's list; one edge weighs 300,
    so one tile needs the CUDA cores.  Returns (A, the (slab, column
    block) of that tile)."""
    g = np.random.default_rng(2)
    lo, hi = K // 4, K // 2
    src = g.integers(lo, hi - 1, 20000)
    dst = np.minimum(src + g.zipf(1.8, src.shape[0]), hi - 1)
    A = torch.zeros((K, K), dtype=torch.int32, device=dev)
    A.index_put_((torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(
        dev)), torch.ones(src.shape[0], dtype=torch.int32, device=dev),
        accumulate=True)
    A[lo, hi - 1] += 1
    A[int(src[0]), int(dst[0])] = 300
    _, bn, bk = tile
    return A, (int(src[0]) // bk, int(dst[0]) // bn)


def spmm_sparse_checks(ops, ref, F, mask) -> dict:
    """The walk the main path runs: a FinBench-like A at the workload
    shape (``finbench_like_adjacency``).  The kernels' slab map equals the
    plain twin's; the hop over it equals the plain version bit for bit in
    count/bool x mask/no mask, with the tile above 255 alone on the CUDA
    cores; a map given is used, and an A without one gets one built in the
    call.  Times the walk with its map and the map's build."""
    S, K = F.shape
    dev = F.device
    A, (bad_slab, bad_cb) = finbench_like_adjacency(K, ops.SPMM_TILE, dev)
    n0 = ops.spmm_slab_map.launches
    smap = ops.spmm_slab_map(A)
    check(ops.spmm_slab_map.launches == n0 + 1,
          "spmm_slab_map did not count its launch")
    slabs, counts = ref.spmm_slab_map_ref(A)
    check(torch.equal(smap.slabs, slabs) and torch.equal(smap.counts, counts),
          "the kernels' slab map != the plain twin at the workload shape")
    n_cb, n_slabs = smap.slabs.shape
    lists = [smap.slabs[cb, :int(counts[cb])].tolist() for cb in range(n_cb)]
    live = int(counts.sum())
    check(0 < live < smap.tiles and int((counts == 0).sum()) > 0
          and any(ls and ls != list(range(ls[0], ls[0] + len(ls)))
                  for ls in lists)
          and bad_slab in lists[bad_cb],
          f"the FinBench-like A lacks an empty column block, a list with a "
          f"gap or its tile above 255: counts {counts.tolist()}")
    slow = ops.spmm_slow_slabs(dev)
    row_blocks = -(-S // ops.SPMM_TILE[0])
    n0 = ops.spmm_slab_map.launches
    for counting in (True, False):
        for m in (None, mask):
            semiring = "count" if counting else "bool"
            out_dtype = torch.int32 if counting else torch.uint8
            slow.zero_()
            got = ops.block_spmm(F, A, m, counting=counting,
                                 out_dtype=out_dtype, slab_map=smap)
            want = ref.block_spmm_ref(F, A, m, semiring=semiring)
            torch.cuda.synchronize()
            check(got.dtype == out_dtype
                  and torch.equal(got.to(torch.float32), want),
                  f"block_spmm over its slab map != plain on the "
                  f"FinBench-like A ({semiring}, mask={m is not None})")
            check(int(slow) == row_blocks,
                  f"FinBench-like A ({semiring}): {int(slow)} slabs on the "
                  f"CUDA cores, expected {row_blocks}")
    check(ops.spmm_slab_map.launches == n0,
          "block_spmm built a map though one was given")
    check(torch.equal(
        ops.block_spmm(F, A, counting=True, out_dtype=torch.int32),
        ops.block_spmm(F, A, counting=True, out_dtype=torch.int32,
                       slab_map=smap)),
          "block_spmm with a map built in the call != with the map given")
    check(ops.spmm_slab_map.launches == n0 + 1,
          "block_spmm without a map did not build one")
    rec = {"live_tiles": live, "tiles": smap.tiles,
           "longest_list": int(counts.max()),
           "busy_colblocks": int((counts > 0).sum()),
           "ms": cuda_ms(lambda: ops.block_spmm(
               F, A, counting=True, out_dtype=torch.int32, slab_map=smap), 5),
           "map_ms": cuda_ms(lambda: ops.spmm_slab_map(A), 5)}
    del A, smap
    return rec


def spmm_fp32_split_checks(ops, ref, dev, rng) -> dict:
    """The fp32 route where its plan splits K: ``FP32_SPLIT_SHAPES`` on
    integer-valued operands, equal to the plain version in every operand,
    semiring, output and mask case; then random fp32 operands, where two
    launches give the same bits and stay within the any-order bound of the
    plain version (positive terms: 2(K+1)·2^-24 relative)."""
    cases, n_split = 0, {}
    for (S, K, N) in FP32_SPLIT_SHAPES:
        if dev.type == "cuda":
            plan = ops.spmm_fp32_launch_plan(
                torch.empty((S, K), device=dev), torch.empty((K, N),
                                                             device=dev))
            check(plan.n_split > 1, f"no split at {(S, K, N)}: {plan}")
            n_split[str((S, K, N))] = plan.n_split
        Fi = torch.from_numpy(rng.integers(0, 3, (S, K))).to(dev)
        Ai = torch.from_numpy((rng.random((K, N)) < 0.2).astype(np.int32)
                              ).to(dev)
        m = torch.from_numpy(rng.integers(0, 2, N)).to(dev)
        for f_dtype, a_dtype in FP32_SPLIT_OPERANDS:
            F, A = Fi.to(f_dtype), Ai.to(a_dtype)
            for counting, out_dtype in FP32_SPLIT_OUTS:
                for mask in (None, m):
                    semiring = "count" if counting else "bool"
                    got = ops.block_spmm(F, A, mask, counting=counting,
                                         out_dtype=out_dtype)
                    want = ref.block_spmm_ref(F, A, mask, semiring=semiring)
                    check(got.dtype == out_dtype
                          and torch.equal(got.to(torch.float32), want),
                          f"block_spmm fp32 route != plain at {(S, K, N)} "
                          f"F={f_dtype} A={a_dtype} {semiring} "
                          f"out={out_dtype} mask={mask is not None}")
                    cases += 1
        F = torch.from_numpy(rng.random((S, K), dtype=np.float32)).to(dev)
        A = torch.from_numpy(rng.random((K, N), dtype=np.float32)).to(dev)
        first = ops.block_spmm(F, A)
        check(torch.equal(first, ops.block_spmm(F, A)),
              f"two fp32 launches differ at {(S, K, N)}")
        within(first.cpu().numpy(), ref.block_spmm_ref(F, A).cpu().numpy(),
               2 * (K + 1) * 2.0 ** -24, 1e-6,
               f"block_spmm fp32 random operands at {(S, K, N)}")
    return {"cases": cases, "n_split": n_split}


def spmm_checks(ops, ref) -> dict:
    """Exact kernel == plain comparisons (integer-valued inputs) plus the
    workload-shape timings.  Returns the kernel's JSON record fields."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = 0.0
    for (S, K, N) in UNIT_SHAPES:
        for counting in (True, False):
            for f_dtype in (torch.float32, torch.int32, torch.bool):
                for masked in (False, True):
                    F = torch.from_numpy(rng.integers(0, 3, (S, K))).to(dev)
                    F = F.to(f_dtype)
                    A = torch.from_numpy(
                        (rng.random((K, N)) < 0.2).astype(np.int32)).to(dev)
                    m = (torch.from_numpy(rng.integers(0, 2, N)).to(dev)
                         if masked else None)
                    got = ops.block_spmm(F, A, m, counting=counting)
                    want = ref.block_spmm_ref(
                        F, A, m, semiring="count" if counting else "bool")
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max()) if got.numel() else 0.0
                    max_err = max(max_err, err)
                    check(torch.equal(got, want),
                          f"block_spmm != plain at {(S, K, N)} "
                          f"counting={counting} F={f_dtype} mask={masked}")
    log(f"phase 2: unit shapes exact ({len(UNIT_SHAPES) * 12} cases)")
    split = spmm_fp32_split_checks(ops, ref, dev, rng)
    log(f"phase 2: fp32 route split cases exact ({split['cases']} cases), "
        f"two launches bit-identical; n_split by shape "
        + json.dumps(split["n_split"]))
    slow = ops.spmm_slow_slabs(dev)
    wide = wide_cases(dev)
    for case, (F, A, want_slow) in wide.items():
        for m in (None, torch.from_numpy(rng.integers(0, 2, A.shape[1])).to(
                dev)):
            slow.zero_()
            got = ops.block_spmm(F, A, m, counting=True,
                                 out_dtype=torch.int32)
            want = ref.block_spmm_ref(F, A, m)
            torch.cuda.synchronize()
            check(torch.equal(got.to(torch.float32), want),
                  f"block_spmm != plain at {case} mask={m is not None}")
            check(int(slow) == want_slow,
                  f"block_spmm {case}: {int(slow)} slabs on the CUDA cores, "
                  f"expected {want_slow}")
    log(f"phase 2: values above 255 exact, their slabs alone on the CUDA "
        f"cores ({len(wide) * 2} cases); routes "
        + json.dumps(ops.block_spmm.launches_by_route))

    S, K, N = WORKLOAD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    A = (torch.rand((K, N), generator=gen, device=dev) < 0.2).to(torch.int32)
    F = torch.randint(0, 3, (S, K), generator=gen, device=dev,
                      dtype=torch.int32)
    mask = (torch.rand(N, generator=gen, device=dev) < 0.5).to(torch.float32)
    Ff, Af = F.to(torch.float32), A.to(torch.float32)
    smap = ops.spmm_slab_map(A)      # built once, as a cached adjacency's
    timings = {}
    for counting in (True, False):
        for m in (None, mask):
            semiring = "count" if counting else "bool"
            out_dtype = torch.int32 if counting else torch.uint8
            got = ops.block_spmm(F, A, m, counting=counting,
                                 out_dtype=out_dtype)
            want = ref.block_spmm_ref(F, A, m, semiring=semiring)
            torch.cuda.synchronize()
            err = float((got.to(torch.float32) - want).abs().max())
            max_err = max(max_err, err)
            check(err == 0.0, f"block_spmm != plain at the workload shape "
                              f"({semiring}, mask={m is not None}): {err}")
            key = f"{semiring}{'+mask' if m is not None else ''}"
            timings[key] = {
                "ms": cuda_ms(lambda: ops.block_spmm(
                    F, A, m, counting=counting, out_dtype=out_dtype,
                    slab_map=smap), 5),
                "plain_ms": cuda_ms(lambda: ref.block_spmm_ref(
                    F, A, m, semiring=semiring), 5),
            }
    library_ms = cuda_ms(lambda: torch.matmul(Ff, Af), 5)
    log(f"phase 2: workload shape {WORKLOAD_SHAPE} exact in count/bool x "
        f"mask/no mask (every tile live); ms: " + json.dumps(timings)
        + f"; torch.matmul fp32 {library_ms:.3f} ms")
    sparse = spmm_sparse_checks(ops, ref, F, mask)
    log(f"phase 2: FinBench-like A at {WORKLOAD_SHAPE}: slab map == plain "
        f"twin, hop exact in count/bool x mask/no mask over it, its tile "
        f"above 255 on the CUDA cores; " + json.dumps(sparse))
    bound_ms, bound_by = spmm_bound_ms(S, K, N)
    by_rows = {S: {"ms": timings["count"]["ms"],
                   "plain_ms": timings["count"]["plain_ms"],
                   "bound_ms": bound_ms, "bound_by": bound_by}}
    for rows in SERVE_ROWS:             # the serve path's small frontiers
        Fs = torch.randint(0, 3, (rows, K), generator=gen, device=dev,
                           dtype=torch.int32)
        for counting in (True, False):
            for m in (None, mask):
                semiring = "count" if counting else "bool"
                got = ops.block_spmm(Fs, A, m, counting=counting,
                                     out_dtype=torch.int32 if counting
                                     else torch.uint8)
                want = ref.block_spmm_ref(Fs, A, m, semiring=semiring)
                torch.cuda.synchronize()
                err = float((got.to(torch.float32) - want).abs().max())
                max_err = max(max_err, err)
                check(err == 0.0, f"block_spmm != plain at S={rows} "
                                  f"({semiring}, mask={m is not None}): {err}")
        if rows == SERVE_ROWS[0]:
            b_ms, b_by = spmm_bound_ms(rows, K, N)
            by_rows[rows] = {
                "ms": cuda_ms(lambda: ops.block_spmm(
                    Fs, A, counting=True, out_dtype=torch.int32,
                    slab_map=smap), 5),
                "plain_ms": cuda_ms(lambda: ref.block_spmm_ref(Fs, A), 5),
                "bound_ms": b_ms, "bound_by": b_by}
    log(f"phase 2: S = {list(SERVE_ROWS)} at K = N = {K} exact in count/bool "
        f"x mask/no mask; count hop by S: " + json.dumps(by_rows))
    del A, F, Ff, Af, Fs, wide, smap
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "ms": timings["count"]["ms"],
            "plain_ms": timings["count"]["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "timings": timings, "by_rows": by_rows, "sparse": sparse}


# ---------------------------------------------------------------------------
# phases 3-4: the session main path
# ---------------------------------------------------------------------------

def write_targets(sess, rng):
    """A base edge to delete, endpoints for a new edge, and a node (the
    workload driver's CE/DE/DV targets)."""
    from repro_torch.utils import host
    g = sess.g
    alive = np.flatnonzero(host(g.edge_alive))
    view_lids = [v.label_id for v in sess.views.values()]
    labels = host(g.edge_label)[alive]
    base = alive[~np.isin(labels, view_lids)]
    eid = int(rng.choice(base))
    src, dst = int(host(g.edge_src)[eid]), int(host(g.edge_dst)[eid])
    elabel = sess.schema.edge_labels.name_of(int(host(g.edge_label)[eid]))
    nid = int(rng.choice(np.flatnonzero(host(g.node_alive))))
    return eid, (src, dst, elabel), nid


def run_writes(sess, seed: int = 0) -> dict:
    """CE, DE and DV with recover, as the paper workload runs them; returns
    their targets."""
    from repro_torch.core import graph as G
    from repro_torch.utils import host
    eid, (src, dst, elabel), nid = write_targets(sess, np.random.default_rng(seed))
    slot = sess.create_edge(src, dst, elabel)        # CE (maintained)
    sess.delete_edge(slot)                           # recover
    sess.delete_edge(eid)                            # DE
    sess.create_edge(src, dst, elabel)               # recover
    g = sess.g                                       # DV
    e_alive, e_src = host(g.edge_alive), host(g.edge_src)
    e_dst, e_lab = host(g.edge_dst), host(g.edge_label)
    inc = np.flatnonzero(e_alive & ((e_src == nid) | (e_dst == nid)))
    nlabel, nkey = int(host(g.node_label)[nid]), int(host(g.node_key)[nid])
    sess.delete_node(nid)
    sess.g = G.create_node(sess.g, nid, nlabel, nkey)  # recover
    view_lids = {v.label_id for v in sess.views.values()}
    for e in inc:
        if int(e_lab[e]) not in view_lids:
            sess.create_edge(int(e_src[e]), int(e_dst[e]),
                             sess.schema.edge_labels.name_of(int(e_lab[e])))
    return {"CE": [src, dst, elabel], "DE": eid, "DV": nid}


def check_views(sess, what: str) -> list:
    """Every view of ``sess`` consistent; returns their names."""
    for name in sess.views:
        check(sess.check_consistency(name), f"{what}: view {name} inconsistent")
    return list(sess.views)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def workload_checks(sess, wl, twin=None, what: str = "") -> dict:
    """The workload driver's table on one session, as checks: each read
    without views, the views built, each read with views held to its rows
    without; then CE/DE/DV (:func:`run_writes`) and every view consistent.
    With ``twin`` (a session of another backend), every read's rows and
    DBHit/Rows must equal the twin's, read by read, and the twin's views
    must store the same pairs after the same writes.  Returns what was
    checked: the reads compared each way, the views checked after the
    writes and the writes' targets."""
    rec = {"reads_compared": {"without_views": 0, "with_views": 0}}
    base = []

    def reads(use_views: bool, key: str) -> None:
        for i, q in enumerate(wl.reads):
            res = sess.query(q, use_views=use_views)
            if twin is not None:
                rt = twin.query(q, use_views=use_views)
                check(np.array_equal(res.reach, rt.reach)
                      and res.metrics == rt.metrics,
                      f"{what} Q{i + 1} ({key}): sessions differ "
                      f"({res.metrics} vs {rt.metrics})")
            if use_views:
                check(np.array_equal(res.reach, base[i][0])
                      and res.num_results() == base[i][1],
                      f"{what} Q{i + 1}: rows with views differ from rows "
                      f"without")
            else:
                base.append((res.reach, res.num_results()))
            rec["reads_compared"][key] += 1

    reads(False, "without_views")
    for v in wl.views:
        sess.create_view(v)
        if twin is not None:
            twin.create_view(v)
    reads(True, "with_views")
    base.clear()
    check_views(sess, f"{what} after build")
    rec["writes"] = run_writes(sess)
    rec["views_checked"] = check_views(sess, f"{what} after CE/DE/DV")
    if twin is not None:
        run_writes(twin)                # the same writes, slot for slot
        check_views(twin, f"{what} twin after CE/DE/DV")
        for name in sess.views:
            check(sess.views[name].pair_slot == twin.views[name].pair_slot,
                  f"{what} view {name}: the sessions store other pairs")
    return rec


def snb_phase(scale: float = 1.0, device: str = "cuda") -> dict:
    """SNB's table as checks (:func:`workload_checks`)."""
    from repro_torch.configs.mv4pg import SNB_WORKLOAD as WL
    from repro_torch.core import GraphSession
    from repro_torch.data.synthetic import snb_like
    g, schema, _ = snb_like(seed=0, n_person=int(2000 * scale),
                            n_post=int(1500 * scale),
                            n_comment=int(12000 * scale), device=device)
    sess = GraphSession(g, schema, device=device)
    log(f"phase 3: snb_like nodes={g.num_nodes()} edges={g.num_edges()} "
        f"node_cap={g.node_cap}")
    return {"nodes": g.num_nodes(), "node_cap": g.node_cap,
            "checks": workload_checks(sess, WL, what="SNB")}


def finbench_phase(scale: float = 1.0, device: str = "cuda") -> dict:
    """Session K (dense hops on ``block_spmm``) held read by read and write
    by write to session S (segment hops), and read by read once more after
    the writes."""
    from repro_torch.configs.mv4pg import FINBENCH_WORKLOAD as WL
    from repro_torch.core import ExecConfig, GraphSession
    from repro_torch.data.synthetic import finbench_like
    sessions = {}
    for name, cfg in (("K", ExecConfig(backend="dense", use_kernel=True)),
                      ("S", ExecConfig())):
        g, schema, _ = finbench_like(
            seed=0, n_account=int(4000 * scale), n_person=int(1500 * scale),
            n_company=int(500 * scale), n_loan=int(800 * scale),
            device=device)
        sessions[name] = GraphSession(g, schema, cfg, device=device)
    K, S = sessions["K"], sessions["S"]
    log(f"phase 4: finbench_like nodes={K.g.num_nodes()} "
        f"node_cap={K.g.node_cap}")
    rec = workload_checks(K, WL, twin=S, what="FinBench")
    for i, q in enumerate(WL.reads):
        rk, rs = K.query(q, use_views=True), S.query(q, use_views=True)
        check(np.array_equal(rk.reach, rs.reach)
              and rk.metrics == rs.metrics,
              f"FinBench Q{i + 1} after writes: kernel session differs")
    rec["reads_compared"]["after_writes"] = len(WL.reads)
    return {"checks": rec,
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if device == "cuda" else None)}


# ---------------------------------------------------------------------------
# phase 7: the serve engine and online view selection
# ---------------------------------------------------------------------------

def serve_script(sess, wl, clients: int, rounds: int, rng) -> list:
    """The workload driver's serve replay as an op list: per round, every
    read once unbound plus once per client bound to a random node of its
    start label, then one fence that deletes and re-creates a random base
    edge.  Targets come from the initial graph, so the list replays
    identically on a twin session."""
    from repro_torch.core import WriteBatch, parse_query
    from repro_torch.utils import host
    g = sess.g
    parsed = {q: parse_query(q) for q in wl.reads}
    n_alive = np.flatnonzero(host(g.node_alive))
    pools = {}
    for q in wl.reads:
        label = parsed[q].path.start.label
        if label not in pools:
            ids = np.flatnonzero(host(g.node_mask(
                sess.schema.node_label_id(label))))
            pools[label] = ids if ids.size else n_alive
    alive_e = np.flatnonzero(host(g.edge_alive))
    e_lab, e_src, e_dst = host(g.edge_label), host(g.edge_src), host(g.edge_dst)
    view_lids = [v.label_id for v in sess.views.values()]
    base_e = alive_e[~np.isin(e_lab[alive_e], view_lids)]
    fence_eids = rng.choice(base_e, size=rounds, replace=False)
    ops = []
    for r in range(rounds):
        for q in wl.reads:
            ops.append(("read", parsed[q], None))
            pool = pools[parsed[q].path.start.label]
            for _ in range(clients):
                ops.append(("read", parsed[q],
                            np.asarray([int(rng.choice(pool))], np.int32)))
        eid = int(fence_eids[r])
        label = sess.schema.edge_labels.name_of(int(e_lab[eid]))
        ops.append(("write", WriteBatch(edge_deletes=[eid]).create_edge(
            int(e_src[eid]), int(e_dst[eid]), label), None))
    return ops


def served_vs_sequential(served, twin, ops, what: str, kops=None) -> dict:
    """Submit ``ops`` to an engine of ``served`` and run it; replay them on
    ``twin`` with ``query``/``apply_writes`` in order, holding every
    ticket's source ids, rows and DBHit/Rows to the twin's.  With ``kops``
    (the kernel wrappers), the kernels' counts are zeroed just before the
    serve run and read just after it."""
    eng = served.serve()
    if kops is not None:
        reset_launches(kops)
        kops.spmm_slow_slabs(served.device).zero_()
    t0 = time.perf_counter()
    tickets = [eng.submit(p, sources=src) if kind == "read"
               else eng.submit_writes(p) for kind, p, src in ops]
    st = eng.run()
    serve_s = time.perf_counter() - t0
    rec = {}
    if kops is not None:
        rec.update(launches=kops.block_spmm.launches,
                   launches_by_route=dict(kops.block_spmm.launches_by_route),
                   slow_slabs=int(kops.spmm_slow_slabs(served.device)),
                   slab_maps=kops.spmm_slab_map.launches)
    seq_s = seq_read_s = 0.0
    for t, (kind, payload, src) in zip(tickets, ops):
        t0 = time.perf_counter()
        if kind == "write":
            twin.apply_writes(payload)
            seq_s += time.perf_counter() - t0
            continue
        want = twin.query(payload, sources=src)
        dt = time.perf_counter() - t0
        seq_s, seq_read_s = seq_s + dt, seq_read_s + dt
        got = t.result
        check(np.array_equal(got.src_ids, want.src_ids)
              and np.array_equal(got.reach, want.reach)
              and got.metrics == want.metrics,
              f"{what}: ticket {t.uid} ({t.via}) differs from the sequential "
              f"twin ({got.metrics} vs {want.metrics})")
        t.result = None                  # free its rows
    check_views(served, f"{what} after serving")
    n = st.queries
    rec.update(summary=st.summary(), queries=n, windows=st.windows,
               executions=st.executions, groups=st.groups,
               share_rate=st.share_rate, memo_hits=st.memo_hits,
               gathers=st.gathers, hoisted=st.hoisted, fences=st.write_batches,
               block_sizes={str(k): st.block_sizes.count(k)
                            for k in sorted(set(st.block_sizes))},
               serve_s=serve_s, sequential_s=seq_s,
               serve_s_per_query=serve_s / max(n, 1),
               sequential_read_s_per_query=seq_read_s / max(n, 1))
    return rec


def serve_snb(scale: float = 1.0, device: str = "cuda",
              clients: int = SERVE_CLIENTS, rounds: int = SERVE_ROUNDS):
    """7a: SNB through the serve engine (all-segment plans: shared
    structural programs, no kernel) against a sequential twin."""
    from repro_torch.configs.mv4pg import SNB_WORKLOAD as WL
    from repro_torch.core import GraphSession
    from repro_torch.data.synthetic import snb_like
    served, twin = (GraphSession(*snb_like(
        seed=0, n_person=int(2000 * scale), n_post=int(1500 * scale),
        n_comment=int(12000 * scale), device=device)[:2], device=device)
        for _ in range(2))
    for v in WL.views:
        served.create_view(v)
        twin.create_view(v)
    ops = serve_script(served, WL, clients, rounds, np.random.default_rng(0))
    return served_vs_sequential(served, twin, ops, "SNB serve")


def serve_finbench(kops=None, scale: float = 1.0, device: str = "cuda",
                   clients: int = SERVE_CLIENTS, rounds: int = SERVE_ROUNDS):
    """7b: FinBench served by a kernel session (dense hops on
    ``block_spmm``) against a segment-hop twin."""
    from repro_torch.configs.mv4pg import FINBENCH_WORKLOAD as WL
    from repro_torch.core import ExecConfig, GraphSession
    from repro_torch.data.synthetic import finbench_like
    served, twin = (GraphSession(*finbench_like(
        seed=0, n_account=int(4000 * scale), n_person=int(1500 * scale),
        n_company=int(500 * scale), n_loan=int(800 * scale),
        device=device)[:2], cfg, device=device)
        for cfg in (ExecConfig(backend="dense", use_kernel=True),
                    ExecConfig()))
    for v in WL.views:
        served.create_view(v)
        twin.create_view(v)
    ops = serve_script(served, WL, clients, rounds, np.random.default_rng(0))
    return served_vs_sequential(served, twin, ops, "FinBench serve", kops)


def online_phase(scale: float = 1.0, device: str = "cuda",
                 rounds: int = ONLINE_ROUNDS) -> dict:
    """7c: online view selection on SNB, after the online bench: the three
    view-shaped reads twice each per round and a replyOf and a knows write,
    into an engine with online selection beside a views-off engine; the
    pair counts must agree every round."""
    from repro_torch.configs.mv4pg import SNB_WORKLOAD as WL
    from repro_torch.core import GraphSession, WriteBatch
    from repro_torch.core.online_selection import OnlineSelectionConfig
    from repro_torch.data.synthetic import snb_like
    from repro_torch.serve import ServeConfig
    from repro_torch.utils import host
    sizes = dict(seed=0, n_person=int(2000 * scale), n_post=int(1500 * scale),
                 n_comment=int(12000 * scale), device=device)
    auto = GraphSession(*snb_like(**sizes)[:2], device=device)
    plain = GraphSession(*snb_like(**sizes)[:2], auto_optimize=False,
                         device=device)
    engines = {"auto": auto.serve(ServeConfig(
        online_selection=OnlineSelectionConfig(
            min_observations=12, evaluate_every=18, min_uses=2.0,
            max_views=3))), "plain": plain.serve(ServeConfig())}
    hot = [WL.reads[0], WL.reads[4], WL.reads[2]]
    ids = {lbl: np.flatnonzero(host(auto.g.node_mask(
        auto.schema.node_label_id(lbl)))) for lbl in ("Person", "Comment",
                                                       "Post")}
    rng = np.random.default_rng(0)
    seconds = dict.fromkeys(engines, 0.0)
    for r in range(rounds):
        c, p = (int(rng.choice(ids[k])) for k in ("Comment", "Post"))
        a, b = (int(rng.choice(ids["Person"])) for _ in range(2))
        pairs = {}
        for name, eng in engines.items():
            t0 = time.perf_counter()
            tickets = []
            for q in hot:
                tickets.append(eng.submit(q))
                eng.submit(q)            # same-fingerprint repeat
            eng.submit_writes(WriteBatch().create_edge(c, p, "replyOf")
                              .create_edge(a, b, "knows"))
            eng.run()
            seconds[name] += time.perf_counter() - t0
            pairs[name] = [t.result.num_pairs() for t in tickets]
        check(pairs["auto"] == pairs["plain"],
              f"online selection round {r}: pairs {pairs}")
    sel = engines["auto"].selector
    check(sel.stats.creates >= 1, "online selection created no view")
    owned = sorted(sel.owned_views())
    for name in owned:
        check(auto.check_consistency(name), f"owned view {name} inconsistent")
    return {"rounds": rounds, "creates": sel.stats.creates,
            "drops": sel.stats.drops, "reused_builds": sel.stats.reused_builds,
            "evaluations": sel.stats.evaluations, "owned": owned,
            "actions": sel.stats.actions, "select_s": sel.stats.select_seconds,
            "create_s": sel.stats.create_seconds,
            "auto_s": seconds["auto"], "plain_s": seconds["plain"],
            "summary": engines["auto"].stats.summary()}


# ---------------------------------------------------------------------------
# phase 9: sharded execution
# ---------------------------------------------------------------------------

def digest(res) -> list:
    """What is kept of a read once it is checked: its shape, its pairs and
    path counts summed, and DBHit/Rows (one SNB read's rows can take 3 GB
    of host memory)."""
    return [list(res.reach.shape), int(np.count_nonzero(res.reach)),
            int(res.reach.sum(dtype=np.int64)), res.metrics.db_hits,
            res.metrics.rows]


def sharded_phase(scale: float = 1.0, device: str = "cuda",
                  shards: int = SHARDS, clients: int = SHARD_SERVE_CLIENTS,
                  rounds: int = SHARD_SERVE_ROUNDS) -> dict:
    """SNB on a session sharded ``shards`` ways, every shard on ``device``
    (the list names it ``shards`` times: a session on the card with
    ``shard_devices=None`` would take one card per shard, and raises when
    fewer are visible), held to an unsharded session on the same graph:
    SNB_WORKLOAD's 7 reads without and then with its 3 views, read by read,
    rows and DBHit/Rows bit for bit with both sessions alive; CE/DE/DV with
    recover and every view consistent, the same pairs in both; then a cut
    of phase 7a's serve script through both sessions' serve engines (the
    window pinned), every ticket and the shared groups equal."""
    from repro_torch.configs.mv4pg import SNB_WORKLOAD as WL
    from repro_torch.core import ExecConfig, GraphSession
    from repro_torch.data.synthetic import snb_like
    from repro_torch.serve import ServeConfig
    sizes = dict(seed=0, n_person=int(2000 * scale), n_post=int(1500 * scale),
                 n_comment=int(12000 * scale), device=device)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        device)
    shard_devices = [dev] * shards
    one = GraphSession(*snb_like(**sizes)[:2], device=device)
    sh = GraphSession(*snb_like(**sizes)[:2], ExecConfig(data_shards=shards),
                      device=device, shard_devices=shard_devices)
    N = sh.g.node_cap
    rec = {"shards": shards, "shard_devices": [str(d) for d in
                                               sh.engine.shard_devices()],
           "nodes": sh.g.num_nodes(), "node_cap": N,
           "n_loc": sh.engine.node_pad() // shards,
           "read_s": {"sharded": 0.0, "unsharded": 0.0}, "reads": []}

    def reads(use_views: bool) -> None:
        for i, q in enumerate(WL.reads):
            t0 = time.perf_counter()
            got = sh.query(q, use_views=use_views)
            t1 = time.perf_counter()
            want = one.query(q, use_views=use_views)
            rec["read_s"]["sharded"] += t1 - t0
            rec["read_s"]["unsharded"] += time.perf_counter() - t1
            check(np.array_equal(got.reach, want.reach)
                  and got.metrics == want.metrics,
                  f"sharded SNB Q{i + 1} (views {use_views}): differs from "
                  f"the unsharded session ({got.metrics} vs {want.metrics})")
            rec["reads"].append(digest(got))
            del got, want

    reads(False)
    for v in WL.views:
        sh.create_view(v)
        one.create_view(v)
    reads(True)
    for sess in (sh, one):
        run_writes(sess)
    # the sharded session's views checked against a recompute; the
    # unsharded session's must then store the very same pairs
    check_views(sh, "sharded SNB after CE/DE/DV")
    for name in sh.views:
        check(sh.views[name].pair_slot == one.views[name].pair_slot,
              f"sharded SNB view {name}: stores other pairs")
    rec["sweeps_by_owner"] = dict(sorted(sh.engine.shard_sweeps.items()))
    rec["view_owners"] = {name: sh.engine.shard_owner_of(v.label_id)
                          for name, v in sh.views.items()}

    ops = serve_script(sh, WL, clients, rounds, np.random.default_rng(0))
    pin = ServeConfig(window_init=SHARD_SERVE_WINDOW,
                      window_min=SHARD_SERVE_WINDOW,
                      window_max=SHARD_SERVE_WINDOW)
    stats, tickets = {}, {}
    for name, sess in (("sharded", sh), ("unsharded", one)):
        eng = sess.serve(pin)
        t0 = time.perf_counter()
        tickets[name] = [eng.submit(p, sources=src) if kind == "read"
                         else eng.submit_writes(p) for kind, p, src in ops]
        stats[name] = eng.run()
        rec[f"serve_s_{name}"] = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(tickets["sharded"], tickets["unsharded"])):
        if ops[i][0] != "read":
            continue
        check(np.array_equal(a.result.src_ids, b.result.src_ids)
              and np.array_equal(a.result.reach, b.result.reach)
              and a.result.metrics == b.result.metrics,
              f"sharded serve: ticket {i} differs from the unsharded twin")
        a.result = b.result = None
    st, su = stats["sharded"], stats["unsharded"]
    check(st.shared_groups == su.shared_groups
          and st.warm_pool_hits == su.warm_pool_hits,
          f"sharded serve: shared groups {st.shared_groups} / warm pool "
          f"{st.warm_pool_hits} vs {su.shared_groups} / {su.warm_pool_hits}")
    check(st.shared_groups > 0, "sharded serve shared no group")
    check_views(sh, "sharded SNB after serving")
    rec.update(serve_queries=st.queries, shared_groups=st.shared_groups,
               warm_pool_hits=st.warm_pool_hits, serve_windows=st.windows,
               sweeps_by_owner_after_serve=dict(
                   sorted(sh.engine.shard_sweeps.items())))
    return rec


# ---------------------------------------------------------------------------
# phase 8: the view-fed GNN
# ---------------------------------------------------------------------------

def gnn_views(device: str, scale: float):
    """A session over ``snb_like(seed=0)`` with KNOWS2 (the reference GNN
    bench's view and policy) and ROOT_POST, and a views-off twin."""
    from repro_torch import mv4pg as pg
    from repro_torch.configs.mv4pg import SNB_WORKLOAD as WL
    from repro_torch.data.synthetic import snb_like
    sessions = []
    for views in ((KNOWS2_DDL, WL.views[0]), ()):
        g, schema, ids = snb_like(
            seed=0, n_person=int(2000 * scale), n_post=int(1500 * scale),
            n_comment=int(12000 * scale), device=device)
        sess = pg.GraphSession(g, schema, device=device)
        for ddl in views:
            sess.create_view(ddl)
        sessions.append(sess)
    check("ROOT_POST" in sessions[0].views, "SNB_WORKLOAD.views[0] is not "
                                             "ROOT_POST")
    return sessions[0], sessions[1], ids["persons"]


def knows_write(sess, persons, rng):
    """One ``knows`` create/delete pair: a new edge between two persons with
    none, and the deletion of an alive base ``knows`` edge (the same slot
    in a views-off twin: view edges take slots after the base edges)."""
    from repro_torch import mv4pg as pg
    from repro_torch.utils import host
    g = sess.g
    lid = sess.schema.edge_labels.id_of("knows")
    knows = np.flatnonzero(host(g.edge_alive) & (host(g.edge_label) == lid))
    pairs = set(zip(host(g.edge_src)[knows].tolist(),
                    host(g.edge_dst)[knows].tolist()))
    while True:
        a, b = (int(x) for x in rng.choice(persons, 2, replace=False))
        if (a, b) not in pairs:
            break
    return pg.WriteBatch(edge_creates=[(a, b, "knows")],
                         edge_deletes=[int(rng.choice(knows))])


def twin_batch(twin, device: str):
    """KNOWS2 re-extracted from scratch: its MATCH on the views-off twin,
    through the canonical batch builder (``bench_gnn``'s end-state check)."""
    from repro_torch.graphops.view_subgraph import build_graphbatch
    from repro_torch.utils import host
    rows = twin.query(KNOWS2_MATCH, use_views=False).pairs()
    return build_graphbatch(
        rows.src.astype(np.int64), rows.dst.astype(np.int64),
        node_label=host(twin.g.node_label), num_nodes=int(twin.g.node_cap),
        weight=rows.count.astype(np.int64), device=device)


def within(got: np.ndarray, want: np.ndarray, rtol: float, atol: float,
            what: str) -> float:
    """Check ``got`` against ``want`` within (rtol, atol); the largest
    absolute difference."""
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{what}: shape {got.shape} vs {want.shape} or not finite")
    err = np.abs(got.astype(np.float64) - want)
    bad = int((err > atol + rtol * np.abs(want)).sum())
    check(bad == 0, f"{what}: {bad} values outside (rtol {rtol}, atol "
                    f"{atol}), max abs err {err.max()}")
    return float(err.max()) if err.size else 0.0


def sage_spmm_operands(sess, view: str, params):
    """``block_spmm``'s operands in the first layer of SAGE's aggregation
    over ``view``'s maintained subgraph: the dense fp32 adjacency and the
    encoded features ``h``."""
    from repro_torch.models.common import dense
    from repro_torch.models.gnn.sage import dense_adjacency
    batch = sess.view(view).subgraph().to_graphbatch()
    with torch.no_grad():
        h = torch.relu(dense(params["enc"], batch.node_feat))
        h = (h * batch.node_mask[:, None]).contiguous()
    return dense_adjacency(batch), h


def spmm_fp32_bound_ms(S: int, K: int, N: int) -> tuple:
    """The least time of the fp32 product: the larger of 2·S·K·N over the
    card's fp32 peak outside the tensor cores and fp32 F, A and out moved
    once over the memory rate."""
    t_ops = 2.0 * S * K * N / PEAK_FP32_FLOPS
    t_bytes = 4.0 * (S * K + K * N + S * N) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def spmm_fp32_check(ops, ref, adj, h, what: str) -> dict:
    """One ``block_spmm`` launch on its fp32 route against the plain
    version and against a second launch (the same bits); on the card its
    split-K plan, and its time per call (CUDA events) and on the device
    alone (profiler) beside the plain version's and ``torch.matmul``'s
    (TF32 off)."""
    S, K = adj.shape
    N = h.shape[1]
    got = ops.block_spmm(adj, h, counting=True, out_dtype=torch.float32)
    want = ref.block_spmm_ref(adj, h)
    # Both sum the same k nonzero products of nonnegative fp32 values (an
    # adjacency row, relu outputs) in another order.  Any order of such a
    # sum lies within k·2^-24 of the exact one, relative to it, so the two
    # differ by at most 2k·2^-24 of the output; zero terms add exactly.
    k = int(adj.count_nonzero(dim=1).max()) if S else 0
    tol = (2 * (k + 1) * 2.0 ** -24, 1e-6)
    rec = {"shape": [S, K, N], "max_row_nonzeros": k, "tolerance": tol,
           "max_abs_err": within(got.cpu().numpy(), want.cpu().numpy(),
                                 *tol, what)}
    check(torch.equal(got, ops.block_spmm(adj, h, counting=True,
                                          out_dtype=torch.float32)),
          f"{what}: two launches differ")
    rec["bound_ms"], rec["bound_by"] = spmm_fp32_bound_ms(S, K, N)
    rec["bound_rates"] = {"fp32_flop_per_s": PEAK_FP32_FLOPS,
                          "bytes_per_s": PEAK_BYTES}
    if adj.device.type == "cuda":
        plan = ops.spmm_fp32_launch_plan(adj, h)
        rec["plan"] = {"n_split": plan.n_split, "grid": list(plan.grid),
                       "slots": plan.slots, "waves": plan.waves,
                       "workspace_bytes": 4 * plan.workspace}
        rec["ms"] = cuda_ms(lambda: ops.block_spmm(
            adj, h, counting=True, out_dtype=torch.float32), 20)
        rec["plain_ms"] = cuda_ms(lambda: ref.block_spmm_ref(adj, h), 20)
        rec["library_ms"] = cuda_ms(lambda: torch.matmul(adj, h), 20)
        # on the device alone (profiler): each of the route's kernels by
        # its mean launch, and the library call's
        kernels = ("spmm_fp32_kernel",) + (
            ("spmm_fp32_finish",) if plan.n_split > 1 else ())
        rec["device_ms_by_kernel"] = {k: device_ms(lambda: ops.block_spmm(
            adj, h, counting=True, out_dtype=torch.float32), k,
            flush=False, per_launch=True) for k in kernels}
        rec["device_ms"] = sum(rec["device_ms_by_kernel"].values())
        rec["library_device_ms"] = device_ms(lambda: torch.matmul(adj, h),
                                             flush=False, per_launch=True)
    return rec


def gnn_phase(ops, ref, scale: float = 1.0, device: str = "cuda",
              cfg=None) -> dict:
    """Phase 8: SAGE trains on KNOWS2 (``REFRESH DEFERRED``) on the segment
    path; one ``knows`` write reaches the maintained subgraph (one CSR
    rebuild, batch equal to the twin's re-extraction); ``embed_on_view``
    through ``block_spmm``'s fp32 route over KNOWS2 and ROOT_POST equals
    the segment path; a ``ViewEmbedder`` answers behind a ``knows`` fence.
    ``block_spmm``'s counts are zeroed before that path and read after it;
    then one launch at ROOT_POST's shape is checked and timed."""
    from repro_torch import mv4pg as pg
    cfg = cfg or pg.TrainConfig()
    spmm_cfg = dataclasses.replace(cfg, use_block_spmm=True)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    sess, twin, persons = gnn_views(device, scale)
    sub = sess.view("KNOWS2").subgraph(weighted=True)
    rec = {"setup_s": time.perf_counter() - t0,
           "knows2_edges": sub.edge_count,
           "root_post_edges": sess.view("ROOT_POST").subgraph().edge_count}
    reset_launches(ops)

    t0 = time.perf_counter()
    params, rpt = pg.train_on_view(sess, "KNOWS2", cfg)
    if device == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(rpt.steps > 0 and all(np.isfinite(x) for x in rpt.losses),
          f"KNOWS2 training losses {rpt.losses}")
    rec.update(epochs=rpt.epochs, steps=rpt.steps, losses=rpt.losses,
               final_acc=rpt.final_acc, train_s=train_s,
               s_per_step=train_s / rpt.steps)

    t0 = time.perf_counter()
    wb = knows_write(sess, persons, rng)
    sess.apply_writes(wb)
    twin.apply_writes(wb)
    rebuilds = sub.csr_rebuilds
    check(sub.refresh() and sub.csr_rebuilds == rebuilds + 1
          and not sub.refresh(), "the knows write did not rebuild KNOWS2's "
                                 "CSR exactly once")
    got, want = sub.to_graphbatch(), twin_batch(twin, device)
    for f in ("node_feat", "edge_src", "edge_dst", "edge_mask", "node_mask",
              "graph_id", "labels", "edge_weight"):
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"KNOWS2 batch after the write: {f} differs from the "
              f"re-extraction")
    rec["write_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    embed_err = {}
    for view in ("KNOWS2", "ROOT_POST"):
        a = pg.embed_on_view(sess, view, params, spmm_cfg)
        b = pg.embed_on_view(sess, view, params, cfg)
        embed_err[view] = within(a, b, *EMBED_TOL,
                                  f"{view}: block_spmm embeddings vs segment")
        rec[f"{view.lower()}_nodes"] = a.shape[0]
    rec["embed_max_abs_err"] = embed_err
    rec["embed_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    eng = sess.serve()
    eng.register_embedder(pg.ViewEmbedder(sess, "KNOWS2", params, spmm_cfg))
    ids = sess.view("KNOWS2").subgraph().nodes()[:16]
    t_pre = eng.submit_embed("KNOWS2", ids)
    eng.submit_writes(knows_write(sess, persons, rng))
    t_post = eng.submit_embed("KNOWS2", ids)
    eng.run()
    rec["launches"] = ops.block_spmm.launches
    rec["launches_by_route"] = dict(ops.block_spmm.launches_by_route)
    check(eng.stats.embed_refreshes == 2 and eng.stats.embed_reads == 2
          and t_post.embed_result.version > t_pre.embed_result.version,
          f"served embeddings: {eng.stats.summary()}")
    rec["serve_max_abs_err"] = within(
        t_post.embed_result.embeddings,
        pg.embed_on_view(sess, "KNOWS2", params, spmm_cfg, node_ids=ids),
        1e-5, 1e-6, "served embeddings after the fence vs embed_on_view")
    rec["serve_s"] = time.perf_counter() - t0

    for view, key in (("KNOWS2", "kernel_knows2"), ("ROOT_POST", "kernel")):
        adj, h = sage_spmm_operands(sess, view, params)
        rec[key] = spmm_fp32_check(ops, ref, adj, h,
                                   f"block_spmm fp32 at {view}'s shape")
        del adj, h
    return rec


# ---------------------------------------------------------------------------
# phase 5: segment aggregation
# ---------------------------------------------------------------------------

def agg_inputs(shape, dtype, gen, device):
    """Seeded messages [N, W, D] in ``dtype`` and validity [N, W] (70% of
    slots), with row 0 all valid and rows 1-2, where there are such rows,
    empty."""
    msg = torch.randn(shape, generator=gen, device=device).to(dtype)
    valid = torch.rand(shape[:2], generator=gen, device=device) < 0.7
    valid[0] = True
    valid[1:3] = False
    return msg, valid


def nan_inputs(dtype, D: int, gen, device):
    """Messages [24, 40, D] with a NaN in a valid slot before finite values
    (row 0, column 3), one after them (row 1, column 5, its last valid
    slot) and one in an invalid slot (row 2, column 7)."""
    msg, valid = agg_inputs((24, 40, D), dtype, gen, device)
    valid[0:2, :6] = True
    valid[1, 6:] = False
    valid[2, 9], valid[2, 10] = False, True
    msg[0, 0, 3] = msg[1, 5, 5] = msg[2, 9, 7] = float("nan")
    return msg, valid


def agg_check(ops, ref, msg, valid, what: str) -> float:
    """Kernel against plain version (messages cast to fp32, as the kernel
    casts them) at the reference's tolerance, a NaN equal only to a NaN;
    returns the max abs error over outputs that are not NaN."""
    got = ops.segment_multi_agg(msg, valid)
    want = ref.segment_multi_agg_ref(msg.to(torch.float32), valid)
    tol = AGG_TOL[msg.dtype]
    err = 0.0
    for name, g, w in zip(AGG_OUTPUTS, got, want):
        check(torch.allclose(g, w, rtol=tol, atol=tol, equal_nan=True),
              f"segment_multi_agg {name} != plain at {what}")
        if g.numel():
            err = max(err, float((g - w).nan_to_num(0.0).abs().max()))
    return err


def agg_nan_check(ops, ref, dtype, D: int, gen, device) -> float:
    """NaN as the reference gives it: a NaN in a valid slot makes all four
    outputs of its column NaN (``jnp.max`` and ``jnp.min`` propagate it),
    and a NaN in an invalid slot (row 2) shows in neither max nor min.
    Against the plain version as ``agg_check``, but for the mean and std of
    row 2: the plain version, as the reference, takes the invalid slot
    times 0, and the kernel never reads it (invalid slots must be finite).
    Returns the max abs error over outputs that are not NaN."""
    msg, valid = nan_inputs(dtype, D, gen, device)
    got = ops.segment_multi_agg(msg, valid)
    want = ref.segment_multi_agg_ref(msg.to(torch.float32), valid)
    rows = torch.arange(msg.shape[0], device=msg.device) != 2
    tol = AGG_TOL[dtype]
    err = 0.0
    for name, g, w in zip(AGG_OUTPUTS, got, want):
        check(bool(g[0, 3].isnan()) and bool(g[1, 5].isnan()),
              f"segment_multi_agg {name} drops a NaN of a valid slot "
              f"({dtype}, D={D})")
        if name in ("max", "min"):
            check(bool(g[2].isfinite().all()),
                  f"segment_multi_agg {name} shows a NaN of an invalid slot "
                  f"({dtype}, D={D})")
        else:
            g, w = g[rows], w[rows]
        check(torch.allclose(g, w, rtol=tol, atol=tol, equal_nan=True),
              f"segment_multi_agg {name} != plain at NaN case {dtype} D={D}")
        err = max(err, float((g - w).nan_to_num(0.0).abs().max()))
    return err


def snb_messages(gen, device, **sizes):
    """Destinations of the alive edges of ``snb_like(seed=0, **sizes)`` and
    seeded fp32 messages of PNA's width for them: (dst, msg, num_nodes)."""
    from repro_torch.data.synthetic import snb_like
    g, _, _ = snb_like(seed=0, device=device, **sizes)
    dst = g.edge_dst[g.edge_alive].to(torch.int64)
    msg = torch.randn((dst.shape[0], PNA_D_HIDDEN), generator=gen,
                      device=device)
    return dst, msg, g.num_nodes()


def agg_bytes(valid, n_valid: int, D: int, elem: int) -> int:
    """Bytes the kernel must move: the validity bytes, the valid slots'
    messages (``elem`` bytes a value) and four fp32 [N, D] outputs."""
    return valid.numel() + n_valid * D * elem + 4 * valid.shape[0] * D * 4


def scatter_aggregates(dst, msg, num_nodes: int):
    """Mean (float64 sums by ``index_add_``), max and min
    (``scatter_reduce``) per destination: the reference's scatter oracle."""
    D = msg.shape[1]
    d64 = msg.to(torch.float64)
    s = torch.zeros((num_nodes, D), dtype=torch.float64,
                    device=msg.device).index_add_(0, dst, d64)
    cnt = torch.bincount(dst, minlength=num_nodes).to(torch.float64)
    mean = (s / cnt.clamp_min(1.0)[:, None]).to(torch.float32)
    idx = dst[:, None].expand_as(msg)
    zero = torch.zeros((num_nodes, D), device=msg.device)
    mx = zero.scatter_reduce(0, idx, msg, "amax", include_self=False)
    mn = zero.scatter_reduce(0, idx, msg, "amin", include_self=False)
    return mean, mx, mn


def scatter_check(outs, dst, msg, num_nodes: int, what: str) -> None:
    """Max and min bit for bit, mean within 1e-5/1e-6, of the scatter
    oracle on the same messages (cast to fp32, as the kernel reads them)."""
    mean, mx, mn = outs[:3]
    want_mean, want_max, want_min = scatter_aggregates(
        dst, msg.to(torch.float32), num_nodes)
    check(torch.equal(mx, want_max) and torch.equal(mn, want_min),
          f"segment aggregation max/min differ from the scatter oracle at "
          f"{what}")
    check(torch.allclose(mean, want_mean, rtol=1e-5, atol=1e-6),
          f"segment aggregation mean differs from the scatter oracle at "
          f"{what}")


def segment_phase(ops, ref) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for shape in AGG_UNIT_SHAPES:
        for dtype in AGG_TOL:
            msg, valid = agg_inputs(shape, dtype, gen, dev)
            max_err = max(max_err, agg_check(ops, ref, msg, valid,
                                             f"{shape} {dtype}"))
    log(f"phase 5: unit shapes within tolerance "
        f"({len(AGG_UNIT_SHAPES) * len(AGG_TOL)} cases)")

    cases = {"SNB": snb_messages(gen, dev),
             "SNB x10": snb_messages(gen, dev, **SNB_X10)}
    records = {}
    for name, (dst, msg_e, N) in cases.items():
        rec = {"bucketize_ms": cuda_ms(
                   lambda: ops.bucketize_messages(dst, msg_e, N), 3),
               "bucketize_device_ms": device_ms(
                   lambda: ops.bucketize_messages(dst, msg_e, N), iters=3,
                   flush=False)}
        bucketed, valid = ops.bucketize_messages(dst, msg_e, N)
        W, n_valid = bucketed.shape[1], int(valid.sum())
        check(n_valid == dst.shape[0], f"bucketize_messages dropped messages "
                                       f"below the maximum in-degree ({name})")
        rec.update(shape=[N, W, PNA_D_HIDDEN], valid_slots=n_valid,
                   bucketed_bytes=bucketed.numel() * 4)
        for dtype in AGG_TOL:
            m = bucketed.to(dtype)
            what = f"{name} [{N}, {W}, {PNA_D_HIDDEN}] {dtype}"
            max_err = max(max_err, agg_check(ops, ref, m, valid, what))
            scatter_check(ops.segment_multi_agg(m, valid), dst,
                          msg_e.to(dtype), N, what)
            need = agg_bytes(valid, n_valid, PNA_D_HIDDEN, m.element_size())
            rec[str(dtype).replace("torch.", "")] = {
                "device_ms": device_ms(
                    lambda: ops.segment_multi_agg(m, valid), "agg_kernel"),
                "per_call_ms": cuda_ms(
                    lambda: ops.segment_multi_agg(m, valid), 20),
                "plain_ms": cuda_ms(lambda: ref.segment_multi_agg_ref(
                    m.to(torch.float32), valid), 3),
                "bytes": need, "bound_ms": need / PEAK_BYTES * 1e3}
            del m
        del bucketed, valid
        rec["pna_aggregate"] = pna_aggregate_check(ops, dst, msg_e, N, name)
        records[name] = rec
        log(f"phase 5: {name} messages E={dst.shape[0]} within tolerance "
            f"in fp32 and bf16, max/min == scatter oracle; "
            + json.dumps(rec))
    torch.cuda.empty_cache()

    for dtype in AGG_TOL:
        for D in (PNA_D_HIDDEN, 96):       # lane columns idle, and not
            max_err = max(max_err, agg_nan_check(ops, ref, dtype, D, gen,
                                                 dev))
    log("phase 5: a NaN of a valid slot reaches all four outputs, one of "
        "an invalid slot neither max nor min (fp32 and bf16, D = 75 and 96)")

    reset_launches(ops)
    outs = {}
    for name, (dst, msg_e, N) in cases.items():           # the main path
        outs[name] = ops.segment_multi_agg(*ops.bucketize_messages(
            dst, msg_e, N))
    launches = ops.segment_multi_agg.launches
    for name, (dst, msg_e, N) in cases.items():
        scatter_check(outs[name], dst, msg_e, N, f"{name}, main path")
        std = outs[name][3]
        check(bool(torch.isfinite(std).all()) and tuple(std.shape) == (
            N, PNA_D_HIDDEN), f"segment aggregation std not finite or "
                              f"misshapen ({name})")
    log(f"phase 5: main path bucketize + segment_multi_agg == scatter "
        f"oracle at both SNB shapes; segment_multi_agg launches {launches}")
    del outs, cases
    torch.cuda.empty_cache()
    head = records["SNB x10"]["float32"]
    return {"max_abs_err": max_err, "launches": launches,
            "ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "per_call_ms": head["per_call_ms"],
            "pna_x10": records["SNB x10"]["pna_aggregate"]}


# ---------------------------------------------------------------------------
# phase 6: attention
# ---------------------------------------------------------------------------

def sdpa(q, k, v, causal: bool):
    """The library yardstick: one ``scaled_dot_product_attention`` call with
    the kernel's semantics (lower-right causal diagonal, grouped KV)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    Sq, Sk = q.shape[2], k.shape[2]
    if causal and Sq != Sk:
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal_lower_right(Sq, Sk), enable_gqa=True)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def sdpa_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs (the SDPA
    backend), from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return sorted(n[:96] for n in names) or ["not traced"]


def attn_bound_ms(q, k, causal: bool) -> tuple:
    """The larger of 4·B·Hq·D·(visible pairs) over the dtype's peak and q,
    k, v, o moved once over the memory rate."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    pairs = (Sq * (Sk - Sq + 1) + Sq * (Sq - 1) // 2) if causal else Sq * Sk
    flops = 4.0 * B * Hq * D * pairs
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attn_compare(ops, ref, q, k, v, causal: bool, what: str) -> tuple:
    """``flash_attention`` held to its plain version within ``ATTN_TOL``:
    the output and the largest absolute difference."""
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = ATTN_TOL[q.dtype]
    g, w = got.to(torch.float32), want.to(torch.float32)
    check(torch.allclose(g, w, rtol=rtol, atol=atol),
          f"flash_attention != plain at {what}")
    return got, float((g - w).abs().max())


def device_ms_split(calls: dict, groups: dict, rest: str,
                    iters: int) -> tuple:
    """Mean device ms a call of each of ``calls``, from one profiler trace
    of ``iters`` calls of each in turn, and the names of its device ops:
    an op whose name holds a substring of ``groups[key]`` counts for
    ``key``, any other op for ``rest``.  Each op name counts its mean time
    a launch times its launches a call, so a trace that dropped a few
    launches still gives the call's time."""
    from torch.profiler import ProfilerActivity, profile
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ms, names = dict.fromkeys(calls, 0.0), {key: [] for key in calls}
    for name, us in by_name.items():
        key = next((k for k, subs in groups.items()
                    if any(sub in name for sub in subs)), rest)
        ms[key] += sum(us) / len(us) * max(1, round(len(us) / iters)) / 1e3
        names[key].append(name[:96])
    check(all(names.values()), f"the profiler saw no device op of "
                               f"{[k for k, v in names.items() if not v]}")
    return ms, {key: sorted(v) for key, v in names.items()}


def attn_fp32_record(ops, ref, q, k, v, what: str) -> dict:
    """The fp32 route at one causal shape: held to the plain version within
    ``ATTN_TOL`` and to a second launch bit for bit, its planned split and
    the kernel's blocks an SM, then timed per call (CUDA events, host
    included) and on the device (one profiler trace: the kernel and the
    merge) beside its bound, the plain version and SDPA on fp32 (TF32 off)
    on the same inputs.  SDPA takes grouped KV heads on its math backend
    only, so with Hkv < Hq it is also timed on K and V repeated to Hq heads
    beforehand (``library_repeat_kv``: its CUTLASS fp32 kernel).  Each SDPA
    call is held to the kernel's output within 1e-4 first."""
    got, err = attn_compare(ops, ref, q, k, v, True, what)
    check(torch.equal(got, ops.flash_attention(q, k, v)),
          f"two fp32 flash_attention launches differ at {what}")
    big = q.shape[2] * k.shape[2] * q.shape[1] > 1 << 26
    iters = 10 if big else 20
    calls = {"kernel": lambda: ops.flash_attention(q, k, v),
             "library": lambda: sdpa(q, k, v, True)}
    groups = {"kernel": ATTN_FP32_KERNELS}
    if k.shape[1] != q.shape[1]:
        kr, vr = (x.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
                  for x in (k, v))
        calls["library_repeat_kv"] = lambda: sdpa(q, kr, vr, True)
        groups["library_repeat_kv"] = ("fmha_cutlassF",)
    rec = {"shape": [q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                     k.shape[2], q.shape[3]],
           "n_split_tiles": list(ops.attention_launch_splits(q, k)),
           "blocks_per_sm": ops.attention_fp32_blocks_per_sm(
               q.device.index, q.shape[3]),
           "max_abs_err": err,
           **dict(zip(("bound_ms", "bound_by"), attn_bound_ms(q, k, True))),
           "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v),
                               2 if big else 5)}
    for key, fn in calls.items():
        if key != "kernel":
            check(torch.allclose(fn(), got, rtol=1e-4, atol=1e-4),
                  f"scaled_dot_product_attention ({key}) disagrees in fp32 "
                  f"at {what}")
        rec[("" if key == "kernel" else key + "_") + "ms"] = cuda_ms(fn,
                                                                   iters)
    dev, names = device_ms_split(calls, groups, "library", iters)
    for key in calls:
        prefix = "" if key == "kernel" else key + "_"
        rec[prefix + "device_ms"] = dev[key]
        if key != "kernel":
            rec[key] = names[key]
    return rec


def attention_phase(ops, ref) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, Hq, Hkv, Sq, Sk, D, dtype, qk_scale=1.0):
        q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev) * qk_scale
        k = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev) * qk_scale
        v = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def compare(q, k, v, causal, what):
        return attn_compare(ops, ref, q, k, v, causal, what)

    max_err = 0.0
    for shape in ATTN_UNIT_SHAPES:
        for causal in (True, False):
            q, k, v = qkv(*shape, torch.float32, 0.5)
            max_err = max(max_err, compare(q, k, v, causal,
                                           f"{shape} causal={causal}")[1])
    log(f"phase 6: unit shapes within (rtol, atol) "
        f"{ATTN_TOL[torch.float32]} in fp32 ({len(ATTN_UNIT_SHAPES) * 2} "
        f"cases)")
    fp32_rec = {}
    for name, shape in ATTN_FP32_SHAPES.items():
        q, k, v = qkv(*shape, torch.float32, 0.5)
        fp32_rec[name] = attn_fp32_record(ops, ref, q, k, v, f"fp32 {name}")
        max_err = max(max_err, fp32_rec[name]["max_abs_err"])
        log(f"phase 6: fp32 route (TF32 off) at {name} "
            f"{json.dumps(fp32_rec[name])}")
        del q, k, v
    splits = {}
    for shape in ATTN_SPLIT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k, v = qkv(*shape, dtype, 0.5)
                route = "tc" if dtype == torch.bfloat16 else "fp32"
                splits[f"{route} {shape}"] = ops.attention_launch_splits(q, k)
                check(splits[f"{route} {shape}"][0] > 1,
                      f"flash_attention {route} did not split at {shape}")
                before = ops.flash_attention.launches_by_route[route]
                got, err = compare(q, k, v, causal,
                                   f"{shape} {dtype} causal={causal}")
                max_err = max(max_err, err)
                check(ops.flash_attention.launches_by_route[route]
                      == before + 1, f"flash_attention {dtype} left the "
                                     f"{route} route")
                if route == "fp32":
                    check(torch.equal(got, ops.flash_attention(
                        q, k, v, causal=causal)), f"two fp32 launches "
                          f"differ at {shape} causal={causal}")
    log(f"phase 6: split-KV shapes within tolerance in bf16 and fp32 "
        f"({len(ATTN_SPLIT_SHAPES) * 4} cases, fp32 twice bit for bit); "
        f"(n_split, kv tiles per chunk) {json.dumps(splits)}")

    models, records = {}, {}
    for name, (B, Hq, Hkv, Sq, Sk, D) in ATTN_MODEL_SHAPES.items():
        q, k, v = qkv(B, Hq, Hkv, Sq, Sk, D, torch.bfloat16)
        out, err = compare(q, k, v, True, name)
        max_err = max(max_err, err)
        lib = sdpa(q, k, v, True)
        check(torch.allclose(lib.to(torch.float32), out.to(torch.float32),
                             rtol=3e-2, atol=3e-2),
              f"scaled_dot_product_attention disagrees at {name}")
        bound_ms, bound_by = attn_bound_ms(q, k, True)
        rec = {"shape": [B, Hq, Hkv, Sq, Sk, D], "max_abs_err": err,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ms": cuda_ms(lambda: ops.flash_attention(q, k, v), 5),
               "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v),
                                   3),
               "library_ms": cuda_ms(lambda: sdpa(q, k, v, True), 10),
               "library": sdpa_kernels(lambda: sdpa(q, k, v, True))}
        records[name] = rec
        models[name] = (q, k, v, out)
        log(f"phase 6: {name} {json.dumps(rec)}")

    reset_launches(ops)
    for name, (q, k, v, out) in models.items():         # the main path
        again = ops.flash_attention(q, k, v, causal=True)
        check(bool(torch.isfinite(again.to(torch.float32)).all())
              and again.dtype == q.dtype and torch.equal(again, out),
              f"flash_attention main path at {name}: not finite or not "
              f"the checked result")
    launches = ops.flash_attention.launches
    routes = dict(ops.flash_attention.launches_by_route)
    check(routes["tc"] == launches,
          f"bf16 flash_attention left the tensor-core route: {routes}")
    log(f"phase 6: main path over {len(models)} model shapes; "
        f"flash_attention launches {launches}, routes {json.dumps(routes)}")
    head = records["starcoder2-3b prefill"]
    del models
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "launches": launches,
            "launches_by_route": routes, "fp32": fp32_rec,
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}, "shapes": records}


# ---------------------------------------------------------------------------
# phase 10: the side stacks, PNA and LLM serving
# ---------------------------------------------------------------------------

def tensors_within(got, want, tol, what: str) -> float:
    """``got`` (any device) against ``want`` within (rtol, atol), the atol
    a share of ``max|want|`` (at least 1); the largest absolute
    difference."""
    rtol, atol = tol
    w = want.detach().to(torch.float64).cpu().numpy()
    g = got.detach().to(torch.float64).cpu().numpy()
    scale = max(float(np.abs(w).max(initial=0.0)), 1.0)
    return within(g, w, rtol, atol * scale, what)


def device_profile(fn, iters: int = 3, top: int = 0) -> dict:
    """The device ops one call of ``fn`` runs and their summed time, from a
    ``torch.profiler`` trace, beside the call's wall time (device synced,
    the profiler's cost included): the device's busy share of a call;
    with ``top``, the names of the ``top`` device ops of most summed time
    and their ms a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / iters / 1e3
    rec = {"wall_ms": wall_ms, "device_ms": busy_ms,
           "device_ops": len(events) / iters, "busy_share": busy_ms / wall_ms}
    if top:
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / iters / 1e3
        rec["top_ops_ms"] = dict(sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:top])
    return rec


def pna_graph(cfg, n_nodes: int, n_edges: int, device, seed: int = 0):
    """A seeded random graph of ``n_nodes`` and ``n_edges`` with
    ``cfg.d_in`` features and labels, padded by ``pad_graph`` to multiples
    of 128 (padded edges and nodes); its last node has no in-edge."""
    from repro_torch.models.gnn.graphdata import pad_graph
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes - 1, n_edges)
    feat = rng.standard_normal((n_nodes, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n_nodes)
    return pad_graph(feat, src, dst, labels=labels, device=device)


def pna_phase(cfg=None, n_nodes: int = PNA_GRAPH[0],
              n_edges: int = PNA_GRAPH[1], device: str = "cuda") -> dict:
    """PNA's forward pass, ``loss_fn`` and its gradient on ``device``
    against the same on the CPU, from the same weights (drawn on the CPU
    from a seed); on the card, the forward and forward + backward times."""
    from repro_torch.configs import pna as pna_configs
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.gnn import pna
    from repro_torch.utils import host
    cfg = cfg or pna_configs.full()
    params = pna.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    on_dev = tree_map(lambda t: t.to(device), params)
    for t in tree_leaves(params) + tree_leaves(on_dev):
        t.requires_grad_(True)
    host_gb = pna_graph(cfg, n_nodes, n_edges, "cpu")
    gb = pna_graph(cfg, n_nodes, n_edges, device)
    check(int(host(gb.edge_mask.sum())) == n_edges < gb.n_edges,
          "the PNA graph has no padded edge")

    def loss_and_grads(p, g):
        loss = pna.loss_fn(p, g, cfg)
        return loss, torch.autograd.grad(loss, tree_leaves(p))

    with torch.no_grad():
        err = tensors_within(pna.forward(on_dev, gb, cfg),
                             pna.forward(params, host_gb, cfg), FP32_TOL,
                             "PNA forward, card against CPU")
    loss, grads = loss_and_grads(on_dev, gb)
    want_loss, want = loss_and_grads(params, host_gb)
    err = max(err, tensors_within(loss, want_loss, FP32_TOL, "PNA loss"))
    grad_err = 0.0
    for i, (g, w) in enumerate(zip(grads, want)):
        grad_err = max(grad_err, tensors_within(g, w, PNA_GRAD_TOL,
                                                f"PNA gradient, leaf {i}"))
    rec = {"config": {"n_layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
                      "d_in": cfg.d_in, "n_classes": cfg.n_classes},
           "nodes": [n_nodes, gb.n_nodes], "edges": [n_edges, gb.n_edges],
           "loss": float(host(loss)), "max_abs_err": err,
           "grad_max_abs_err": grad_err}
    if torch.device(device).type == "cuda":
        def fwd():
            with torch.no_grad():
                return pna.forward(on_dev, gb, cfg)
        rec["forward_ms"] = cuda_ms(fwd, 10)
        rec["forward_backward_ms"] = cuda_ms(
            lambda: loss_and_grads(on_dev, gb), 10)
        rec["forward_trace"] = device_profile(fwd)
    return rec


def pna_aggregate_check(ops, dst, msg, num_nodes: int, what: str) -> dict:
    """PNA's ``_aggregate`` (segment sums and extrema over the edge list,
    the path PNA takes) on ``msg`` [E, D] fp32 into ``dst``, against the
    scatter oracle and against ``bucketize_messages`` +
    ``segment_multi_agg`` on the same messages; on the card, both timed
    per call (CUDA events, host included).

    Max and min bit for bit and the mean within 1e-5/1e-6 of the scatter
    oracle; mean, max and min within the kernel's fp32 tolerance of the
    kernel.  Both take the std as sqrt(E[x²] - E[x]² + eps) from fp32 sums
    of the row's n messages, PNA's in the order of the atomic adds, the
    kernel's slot by slot, so their variances may differ by the two sums'
    rounding, at most (6(n - 1) + 2)·2^-24·E[x²] (recursive summation's
    forward error bound, for E[x²] and for E[x]²), and their stds by that
    over the sum of the two stds: a std near sqrt(eps) takes the
    variance's rounding times up to 1/(2·sqrt(eps)).  The std is held to
    the kernel's within that bound plus the kernel's tolerance, and each
    one's distance from the std of float64 sums is recorded."""
    from repro_torch.models.gnn import pna
    emask = torch.ones(dst.shape[0], dtype=torch.bool, device=dst.device)

    def path():
        return pna._aggregate(msg, dst, emask, num_nodes)[0]

    def kernel():
        return ops.segment_multi_agg(*ops.bucketize_messages(
            dst, msg, num_nodes))

    outs = path().split(msg.shape[1], dim=1)
    scatter_check(outs, dst, msg, num_nodes, f"PNA's aggregate, {what}")
    tol = AGG_TOL[torch.float32]
    kern = kernel()
    err = 0.0
    for name, g, w in list(zip(AGG_OUTPUTS, outs, kern))[:3]:
        check(torch.allclose(g, w, rtol=tol, atol=tol),
              f"PNA's aggregate {name} != segment_multi_agg at {what}")
        err = max(err, float((g - w).abs().max()))
    m64 = msg.to(torch.float64)
    zeros = torch.zeros((num_nodes, msg.shape[1]), dtype=torch.float64,
                        device=msg.device)
    n = torch.bincount(dst, minlength=num_nodes).to(torch.float64)[:, None]
    mean64 = zeros.index_add(0, dst, m64) / n.clamp_min(1.0)
    sq64 = zeros.index_add(0, dst, m64 * m64) / n.clamp_min(1.0)
    std64 = torch.where(n > 0, torch.sqrt(
        (sq64 - mean64 * mean64).clamp_min(0.0) + 1e-5), 0.0)
    std, k_std = outs[3].to(torch.float64), kern[3].to(torch.float64)
    bound = tol + (6 * (n - 1).clamp_min(0.0) + 2) * 2.0 ** -24 * sq64 / (
        std + k_std).clamp_min(2 * 1e-5 ** 0.5)
    gap = (std - k_std).abs()
    check(bool((gap <= bound).all()),
          f"PNA's aggregate std != segment_multi_agg at {what} beyond the "
          f"fp32 bound of E[x²] - E[x]²: {float(gap.max())}")
    rec = {"edges": int(dst.shape[0]), "max_abs_err_vs_kernel": err,
           "std_max_abs_err_vs_kernel": float(gap.max()),
           "std_gap_over_bound": float((gap / bound).max()),
           "std_err_vs_fp64": {"pna": float((std - std64).abs().max()),
                               "kernel": float((k_std - std64).abs().max())}}
    if msg.device.type == "cuda":
        rec["pna_path_ms"] = cuda_ms(path, 5)
        rec["kernel_path_ms"] = cuda_ms(kernel, 5)
        rec["pna_path_ms_again"] = cuda_ms(path, 5)
    return rec


def llm_serve_phase(cfg=None, slots: int = LLM_SLOTS,
                    requests: int = LLM_REQUESTS,
                    prompt_lens: tuple = LLM_PROMPT_LENS,
                    max_new: int = LLM_NEW_TOKENS,
                    max_len: int = LLM_MAX_LEN, device: str = "cuda",
                    seed: int = 0) -> dict:
    """The LLM engine serving ``requests`` greedy requests through ``slots``
    slots, on weights drawn on ``device`` from a seeded generator; the last
    request repeats the first one's prompt.  Every request must end with
    exactly ``max_new`` tokens and the repeated prompt must give the same
    output.  Records each prefill's and decode step's time (the device
    synced around each call), tokens/s, peak device memory and the decode
    step's byte bound."""
    from repro_torch.configs import starcoder2_3b
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import count_params, tree_leaves
    from repro_torch.serve.llm import Request, ServeEngine
    cfg = cfg or starcoder2_3b.full()
    dev = torch.device(device)
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(seed),
                             cfg, device=dev)
    sync(dev)
    rec = {"arch": cfg.name, "params": count_params(params),
           "init_s": time.perf_counter() - t0}
    check(rec["params"] == cfg.param_count(),
          f"{cfg.name}: {rec['params']} parameters, the config counts "
          f"{cfg.param_count()}")
    eng = ServeEngine(params, cfg, batch_slots=slots, max_len=max_len,
                      eos_id=-1)
    prefills, decodes = [], []

    def timed_call(fn, log):
        def run(p, tokens, *rest):
            sync(dev)
            t = time.perf_counter()
            out = fn(p, tokens, *rest)
            sync(dev)
            log.append([int(tokens.shape[-1]),
                        (time.perf_counter() - t) * 1e3])
            return out
        return run

    with torch.no_grad():                       # warm-up, not counted
        warm = torch.zeros((1, prompt_lens[0]), dtype=torch.int32,
                           device=dev)
        _, cache = eng._prefill1(params, warm)
        eng._decode(params, warm[0, :slots].contiguous(), tfm.init_kv_cache(
            cfg, slots, max_len, device=dev))
        del cache
    eng._prefill1 = timed_call(eng._prefill1, prefills)
    eng._decode = timed_call(eng._decode, decodes)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(prompt_lens[0], prompt_lens[1] + 1,
                                     requests)]
    prompts[-1] = prompts[0]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run_to_completion()
    sync(dev)
    wall = time.perf_counter() - t0
    check(all(r.done and len(r.output) == max_new for r in reqs),
          f"a request ended without its {max_new} tokens: "
          f"{[len(r.output) for r in reqs]}")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.output),
          "a token outside the vocabulary")
    check(reqs[-1].output == reqs[0].output,
          "the same prompt gave two outputs")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    cache_bytes = sum(eng.cache[k].numel() * eng.cache[k].element_size()
                      for k in ("k", "v"))
    tokens = sum(len(r.output) for r in reqs)
    step_ms = [ms for _, ms in decodes]
    rec.update(
        slots=slots, requests=requests, max_len=max_len, new_tokens=max_new,
        prompt_lens=[len(p) for p in prompts], tokens=tokens,
        seconds=wall, tokens_per_s=tokens / wall,
        prefill_ms_by_len=sorted(prefills), decode_steps=len(decodes),
        decode_ms_median=float(np.median(step_ms)),
        decode_ms_min=float(np.min(step_ms)),
        decode_ms_max=float(np.max(step_ms)),
        param_bytes=param_bytes, cache_bytes=cache_bytes,
        decode_bound_ms=(param_bytes + cache_bytes) / PEAK_BYTES * 1e3,
        weights_bound_ms=param_bytes / PEAK_BYTES * 1e3,
        bound_by="bytes", first_output=reqs[0].output[:8])
    if dev.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        step = torch.zeros(slots, dtype=torch.int32, device=dev)
        prompt = torch.zeros((1, prompt_lens[1]), dtype=torch.int32,
                             device=dev)
        with torch.no_grad():
            rec["decode_trace"] = device_profile(
                lambda: tfm.decode_step(params, step, eng.cache, cfg))
            rec["prefill_trace"] = device_profile(
                lambda: tfm.prefill(params, prompt, cfg, max_len))
    return rec


def prefill_attention_times(ops, device: str = "cuda") -> dict:
    """The port's ``chunked_attention`` (what ``prefill`` runs) at the
    starcoder2-3b prefill shape in bf16, held to ``flash_attention`` and
    SDPA within SDPA's check of phase 6 and timed beside both, in turns
    (chunked, flash, SDPA, SDPA, flash, chunked)."""
    from repro_torch.models import attention as attn
    B, Hq, Hkv, Sq, Sk, D = ATTN_MODEL_SHAPES["starcoder2-3b prefill"]
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, device=device).to(
        torch.bfloat16) for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D),
                                  (B, Hkv, Sk, D)))
    fns = {"chunked": lambda: attn.chunked_attention(q, k, v, causal=True,
                                                     chunk=512),
           "flash": lambda: ops.flash_attention(q, k, v, causal=True),
           "sdpa": lambda: sdpa(q, k, v, True)}
    got = fns["chunked"]().to(torch.float32)
    err = {}
    for name in ("flash", "sdpa"):
        other = fns[name]().to(torch.float32)
        check(torch.allclose(got, other, rtol=3e-2, atol=3e-2),
              f"chunked_attention disagrees with {name} at the prefill "
              f"shape")
        err[name] = float((got - other).abs().max())
    ms = {name: [] for name in fns}
    for name in ("chunked", "flash", "sdpa", "sdpa", "flash", "chunked"):
        ms[name].append(cuda_ms(fns[name], 5))
    return {"shape": [B, Hq, Hkv, Sq, Sk, D], "max_abs_err_vs": err,
            "ms": ms}


def decode_parity(params, host_params, cfg, toks: np.ndarray, steps: int,
                  max_len: int, what: str) -> float:
    """``prefill`` then ``steps`` ``decode_step``s on the device of
    ``params`` against the same on the CPU (``host_params``), fed the
    CPU's greedy tokens: logits and caches within ``FP32_TOL``."""
    from repro_torch.models import transformer as tfm
    dev = params["embed"]["table"].device
    with torch.no_grad():
        t = torch.from_numpy(toks)
        got, cache = tfm.prefill(params, t.to(dev), cfg, max_len)
        want, host_cache = tfm.prefill(host_params, t, cfg, max_len)
        err = 0.0
        for step in range(steps + 1):
            err = max(err, tensors_within(got, want, FP32_TOL,
                                          f"{what} logits, step {step}"))
            for key in ("k", "v"):
                err = max(err, tensors_within(
                    cache[key], host_cache[key], FP32_TOL,
                    f"{what} cache {key}, step {step}"))
            check(torch.equal(cache["len"].cpu(), host_cache["len"]),
                  f"{what} cache lengths, step {step}")
            if step == steps:
                break
            nxt = torch.argmax(want, dim=-1).to(torch.int32)
            got, cache = tfm.decode_step(params, nxt.to(dev), cache, cfg)
            want, host_cache = tfm.decode_step(host_params, nxt, host_cache,
                                               cfg)
    return err


def engine_parity(params, cfg, prompts, max_new: int, slots: int,
                  max_len: int) -> dict:
    """The ``slots``-slot engine's outputs against each request served
    alone through a 1-slot engine, token for token.  Where two outputs
    part, the parting is taken only at a near tie: the gap between the
    two top logits at that step (``prefill`` over the prompt and the
    common prefix) must be below ``NEAR_TIE`` of the logits' largest
    magnitude."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.llm import Request, ServeEngine
    from repro_torch.utils import host

    def serve(batch, n_slots):
        eng = ServeEngine(params, cfg, batch_slots=n_slots, max_len=max_len,
                          eos_id=-1)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(batch)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return [r.output for r in reqs]

    together = serve(prompts, slots)
    partings = []
    for i, (p, out) in enumerate(zip(prompts, together)):
        alone = serve([p], 1)[0]
        if alone == out:
            continue
        at = next(j for j, (a, b) in enumerate(zip(alone, out)) if a != b)
        dev = params["embed"]["table"].device
        ctx = np.concatenate([p, np.asarray(alone[:at], np.int32)])
        with torch.no_grad():
            logits = tfm.prefill(params, torch.from_numpy(ctx)[None].to(dev),
                                 cfg, len(ctx) + 1)[0][0]
        top = torch.topk(logits, 2).values
        gap = float(host((top[0] - top[1]) / logits.abs().max()))
        log(f"phase 10c: request {i} parts from its 1-slot run at token "
            f"{at}: top-2 logit gap {gap:.3e} of the logit scale")
        check(gap < NEAR_TIE, f"request {i}: the {slots}-slot and 1-slot "
                              f"outputs part at token {at} where the top two "
                              f"logits are {gap:.3e} of the scale apart")
        partings.append({"request": i, "token": at, "gap": gap})
    return {"requests": len(prompts), "slots": slots, "partings": partings}


def llm_parity_phase(device: str = "cuda", starcoder=None, qwen=None,
                     layers: int = PARITY_LAYERS, seed: int = 0) -> dict:
    """(c) starcoder2-3b at full width cut to ``layers`` layers in fp32:
    ``prefill`` and 4 ``decode_step``s on ``device`` against the CPU, then
    the 4-slot engine against 1-slot runs; qwen2-moe-a2.7b at full width
    cut the same way: ``prefill`` and 2 ``decode_step``s against the CPU.
    Weights are drawn on ``device`` and copied to the CPU."""
    from repro_torch.configs import qwen2_moe_a2_7b, starcoder2_3b
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import tree_map
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    rec = {}
    for name, base, batch, steps in (
            ("starcoder2-3b", starcoder or starcoder2_3b.full(), 2, 4),
            ("qwen2-moe-a2.7b", qwen or qwen2_moe_a2_7b.full(), 1, 2)):
        cfg = dataclasses.replace(base, n_layers=layers,
                                  dtype=torch.float32)
        params = tfm.init_params(torch.Generator(device=dev).manual_seed(
            seed), cfg, device=dev)
        host_params = tree_map(lambda t: t.cpu(), params)
        toks = rng.integers(0, cfg.vocab, (batch, PARITY_PROMPT)).astype(
            np.int32)
        r = {"layers": layers, "d_model": cfg.d_model, "batch": batch,
             "prompt": PARITY_PROMPT, "decode_steps": steps,
             "max_abs_err": decode_parity(params, host_params, cfg, toks,
                                          steps, PARITY_PROMPT + steps + 4,
                                          name)}
        if name == "starcoder2-3b":
            prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
                       for n in rng.integers(8, PARITY_PROMPT, 6)]
            r["engine"] = engine_parity(params, cfg, prompts, 8, LLM_SLOTS,
                                        PARITY_PROMPT + 16)
        rec[name] = r
        del params, host_params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rec


def run_side_stacks(ops, only, seconds: dict, agg_x10=None) -> dict:
    """Phase 10 with every kernel count zeroed just before its path and
    read just after: the reference's PNA and transformer call no kernel,
    so neither does the port's path.  The comparisons with the kernels
    (PNA's aggregate, prefill attention) come after the counts are read."""
    dev = torch.device("cuda")
    out = {}
    reset_launches(ops)
    if "pna" in only:
        t0 = time.perf_counter()
        out["pna"] = pna_phase()
        seconds["pna"] = time.perf_counter() - t0
    if "llm" in only:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out["llm"] = llm_serve_phase()
        seconds["llm_serve"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["parity"] = llm_parity_phase()
        seconds["llm_parity"] = time.perf_counter() - t0
    launches = {fn: getattr(ops, fn).launches for fn in
                ("block_spmm", "segment_multi_agg", "flash_attention")}
    check(not any(launches.values()),
          f"phase 10's path launched a kernel: {launches}")
    t0 = time.perf_counter()
    if "pna" in only:
        if agg_x10 is None:
            dst, msg, N = snb_messages(torch.Generator(
                device=dev).manual_seed(0), dev, **SNB_X10)
            agg_x10 = pna_aggregate_check(ops, dst, msg, N, "SNB x10")
            del dst, msg
        out["pna"]["aggregate_snb_x10"] = agg_x10
        log("phase 10a: PNA full width, card == CPU; " + json.dumps(
            out["pna"]))
    if "llm" in only:
        out["llm"]["prefill_attention"] = prefill_attention_times(ops)
        log("phase 10b: starcoder2-3b full width served; " + json.dumps(
            out["llm"]))
        log("phase 10c: card == CPU at 2 layers in fp32, 4-slot == 1-slot; "
            + json.dumps(out["parity"]))
    seconds["side_stack_checks"] = time.perf_counter() - t0
    log(f"phase 10: kernel launches on its path {json.dumps(launches)}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: training and the molecular and recommender stacks
# ---------------------------------------------------------------------------

def batch_on(x: np.ndarray, y: np.ndarray, device) -> tuple:
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def train_lm_phase(cfg=None, steps: int = TRAIN_STEPS, seq: int = TRAIN_SEQ,
                   accum: int = TRAIN_ACCUM, device: str = "cuda",
                   seed: int = 0) -> dict:
    """(a) ``make_train_step`` on starcoder2-3b at full width (weights drawn
    on ``device`` from a seeded generator), fp32 moments as the reference's
    ``launch/steps.py::_adam_cfg`` gives this arch, ``accum`` microbatches
    of one sequence of ``seq`` tokens a step, from ``token_batch``.  Each
    step's loss is read to the host and timed (the device synced); the
    first loss must be within 1 of ln(vocab), the others finite.  Model
    FLOPs a step are 6 x parameters x tokens; the rate is taken over the
    steps after the first (which pays cuBLAS's and the allocator's
    warm-up), as a share of the card's bf16 dense peak."""
    from repro_torch.configs import starcoder2_3b
    from repro_torch.data.tokens import token_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import count_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import init_train_state, make_train_step
    from repro_torch.utils import host
    cfg = cfg or starcoder2_3b.full()
    dev = torch.device(device)
    t0 = time.perf_counter()
    ocfg = opt.AdamWConfig(state_bits=32)
    state = init_train_state(tfm.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg, device=dev), ocfg)
    sync(dev)
    n = count_params(state.params)
    rec = {"arch": cfg.name, "params": n, "dtype": str(cfg.dtype),
           "remat": cfg.remat, "seq": seq, "microbatches": accum,
           "global_batch": accum, "init_s": time.perf_counter() - t0}
    check(n == cfg.param_count(), f"{cfg.name}: {n} parameters")
    step = make_train_step(lambda p, b: tfm.lm_loss(p, b[0], b[1], cfg),
                           ocfg, grad_accum=accum)
    losses, ms = [], []
    for s in range(steps):
        batch = batch_on(*token_batch(s, accum, seq, cfg.vocab), dev)
        sync(dev)
        t = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(host(metrics["loss"])))
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    check(all(np.isfinite(losses)), f"{cfg.name}: a loss is not finite: "
                                    f"{losses}")
    check(abs(losses[0] - float(np.log(cfg.vocab))) < 1.0,
          f"{cfg.name}: the first loss {losses[0]} is far from ln(vocab)")
    check(int(host(state.opt_state.step)) == steps, "optimizer steps")
    tokens = accum * seq
    step_s = float(np.mean(ms[1:] if steps > 1 else ms)) / 1e3
    flops = 6.0 * n * tokens
    rec.update(losses=losses, step_ms=ms, tokens_per_step=tokens,
               tokens_per_s=tokens / step_s, model_flops_per_step=flops,
               model_flops_per_s=flops / step_s,
               bf16_peak_share=flops / step_s / PEAK_BF16_FLOPS,
               peak_used=PEAK_NAME)
    if dev.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        check(rec["max_memory_allocated"] < TRAIN_MEM_LIMIT,
              f"{cfg.name}: peak memory {rec['max_memory_allocated']} B")
        held = {"state": state}
        del state

        def one_step():
            held["state"], _ = step(held["state"], batch)
        rec["step_trace"] = device_profile(one_step, iters=1, top=6)
    return rec


def train_parity_phase(base=None, layers: int = PARITY_LAYERS,
                       batch: int = 2, seq: int = TRAIN_PARITY_SEQ,
                       device: str = "cuda", seed: int = 0) -> dict:
    """(a) starcoder2-3b at full width cut to ``layers`` layers in fp32,
    one train step on ``device`` against the CPU from the same weights
    (drawn on ``device``, copied): the loss, every gradient and every
    updated parameter within ``FP32_TOL``."""
    from repro_torch.configs import starcoder2_3b
    from repro_torch.data.tokens import token_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import value_and_grad
    cfg = dataclasses.replace(base or starcoder2_3b.full(), n_layers=layers,
                              dtype=torch.float32)
    dev = torch.device(device)
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(seed),
                             cfg, device=dev)
    host_params = tree_map(lambda t: t.cpu(), params)
    x, y = token_batch(0, batch, seq, cfg.vocab)
    ocfg = opt.AdamWConfig(state_bits=32)

    def train_step(p, b):
        loss, grads = value_and_grad(
            lambda q, bb: tfm.lm_loss(q, bb[0], bb[1], cfg), p, b)
        newp, _, info = opt.apply_updates(p, grads, opt.init_state(p, ocfg),
                                          ocfg)
        return loss, grads, newp, info

    got = train_step(params, batch_on(x, y, dev))
    want = train_step(host_params, batch_on(x, y, "cpu"))
    err = tensors_within(got[0], want[0], FP32_TOL, "train parity loss")
    grad_err = param_err = 0.0
    for i, (g, w) in enumerate(zip(tree_leaves(got[1]),
                                   tree_leaves(want[1]))):
        grad_err = max(grad_err, tensors_within(
            g, w, FP32_TOL, f"train parity gradient, leaf {i}"))
    for i, (g, w) in enumerate(zip(tree_leaves(got[2]),
                                   tree_leaves(want[2]))):
        param_err = max(param_err, tensors_within(
            g, w, FP32_TOL, f"train parity updated param, leaf {i}"))
    err = max(err, tensors_within(got[3]["gnorm"], want[3]["gnorm"],
                                  FP32_TOL, "train parity gnorm"))
    return {"layers": layers, "d_model": cfg.d_model, "batch": batch,
            "seq": seq, "loss": float(want[0]), "max_abs_err": err,
            "grad_max_abs_err": grad_err, "param_max_abs_err": param_err}


def train_cli_phase(device: str = "cuda", preset=("--preset", "100m"),
                    steps: int = CLI_STEPS, fail: int = CLI_FAIL,
                    every: int = CLI_CKPT_EVERY) -> dict:
    """(b) ``launch/train.py``'s loop on ``device``: ``steps`` steps with
    checkpoints every ``every`` and a ``RuntimeError`` injected at step
    ``fail``, against the same run uninterrupted: one restart, final losses
    within 5e-2 (the reference's tolerance, ``tests/test_runtime.py``).
    Then a state with 8-bit moments after one step is saved and restored
    bit for bit."""
    import tempfile

    from repro_torch.data.tokens import token_batch
    from repro_torch.launch import train as cli
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import init_train_state, make_train_step
    rec = {"preset": list(preset), "steps": steps, "fail_at": fail,
           "ckpt_every": every}
    with tempfile.TemporaryDirectory() as tmp:
        def args(name, ckpt_every):
            return cli.parse_args([*preset, "--steps", str(steps),
                                   "--ckpt-every", str(ckpt_every),
                                   "--ckpt-dir", f"{tmp}/{name}",
                                   "--device", device])

        hurt = cli.train(args("hurt", every),
                         fail_at={fail: RuntimeError("injected failure")})
        clean = cli.train(args("clean", steps + 1))
        stats = hurt["stats"]
        # the loop resumes from the latest checkpoint published when the
        # failure comes: the async save of the one before may still run
        resumed = steps + fail - stats.steps_done
        check(stats.restarts == 1, f"restarts {stats.restarts}")
        check(resumed % every == 0 and 0 <= resumed < fail,
              f"steps done {stats.steps_done}")
        check(ckpt.latest_step(f"{tmp}/hurt") == steps, "last checkpoint")
        check(abs(hurt["loss"] - clean["loss"]) < 5e-2,
              f"final loss {hurt['loss']} against {clean['loss']} "
              f"uninterrupted")
        rec.update(config=hurt["config"].name, params=hurt["params"],
                   restarts=stats.restarts, steps_done=stats.steps_done,
                   resumed_from=resumed,
                   stragglers=stats.stragglers, loss=hurt["loss"],
                   loss_uninterrupted=clean["loss"],
                   seconds=hurt["seconds"],
                   seconds_uninterrupted=clean["seconds"],
                   step_ms_ema=stats.step_time_ema * 1e3)

        cfg = hurt["config"]
        ocfg = opt.AdamWConfig(state_bits=8)
        step = make_train_step(lambda p, b: tfm.lm_loss(p, b[0], b[1], cfg),
                               ocfg)
        x, y = token_batch(0, 8, 128, cfg.vocab)
        state, _ = step(init_train_state(hurt["state"].params, ocfg),
                        batch_on(x, y, device))
        t0 = time.perf_counter()
        path = ckpt.save(state, f"{tmp}/eight", step=1)
        rec["save_s"] = time.perf_counter() - t0
        rec["ckpt_bytes"] = sum(f.stat().st_size
                                for f in Path(path).iterdir())
        t0 = time.perf_counter()
        back = ckpt.restore(state, f"{tmp}/eight")
        rec["restore_s"] = time.perf_counter() - t0
        leaves = list(zip(tree_leaves(state), tree_leaves(back)))
        check(all(a.dtype == b.dtype and a.device == b.device
                  and torch.equal(a, b) for a, b in leaves),
              "the 8-bit checkpoint did not restore bit for bit")
        rec["eight_bit_leaves"] = len(leaves)
    return rec


def molecule_batch(n_types: int, device, seed: int = 0,
                   shape: tuple = MOLECULE, pad: int = MOLECULE_PAD):
    """``shape`` = (atoms, bonds, molecules): random directed bonds inside
    each molecule (no self-loops), positions N(0, 1.5²) per axis, atom
    types below ``n_types``, padded to multiples of ``pad`` as the
    reference's cell pads them (``launch/steps.py::gnn_cell``); DimeNet's
    triplets from the bonds, up to 8 per padded edge."""
    from repro_torch.models.gnn.graphdata import build_triplets, pad_graph
    from repro_torch.utils import round_up
    n, e, G = shape
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e) + g * n for g in range(G)])
    dst = (src % n + rng.integers(1, n, src.shape[0])) % n \
        + np.repeat(np.arange(G), e) * n
    pos = (rng.standard_normal((n * G, 3)) * 1.5).astype(np.float32)
    feat = rng.integers(0, n_types, n * G).astype(np.int32)
    gid = np.repeat(np.arange(G), n).astype(np.int32)
    gb = pad_graph(feat, src, dst, positions=pos, graph_id=gid,
                   node_pad=pad, edge_pad=pad, device=device)
    tri = build_triplets(src, dst, round_up(gb.n_edges * 8, pad))
    targets = rng.standard_normal(G).astype(np.float32)
    return gb, tri, targets


def energy_forces(mod, params, gb, cfg):
    """(per-graph energies, -dE/dpositions) by autograd."""
    pos = gb.positions.detach().requires_grad_()
    e = mod.forward(params, dataclasses.replace(gb, positions=pos), cfg)
    (g,) = torch.autograd.grad(e.sum(), pos)
    return e.detach(), -g


def molecular_phase(configs=None, shape: tuple = MOLECULE,
                    pad: int = MOLECULE_PAD, steps: int = GNN_STEPS,
                    device: str = "cuda", seed: int = 0) -> dict:
    """(c) DimeNet, NequIP and MACE at full width on ``shape``'s molecule
    batch: forward pass, energy loss and gradient on ``device`` equal to
    the CPU's (weights drawn on the CPU from a seed); ``steps`` trainer
    steps (AdamW, fp32 moments, as the reference's ``gnn_cell``), timed;
    NequIP's forces against the CPU's; for NequIP and MACE a rotation of
    every position leaves the energies unchanged and rotates the forces."""
    from repro_torch.configs import get_arch
    from repro_torch.models.common import count_params, tree_leaves, tree_map
    from repro_torch.models.gnn import dimenet, mace, nequip
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import (
        init_train_state, make_train_step, value_and_grad,
    )
    from repro_torch.utils import host
    configs = configs or {a: get_arch(a).full()
                          for a in ("dimenet", "nequip", "mace")}
    mods = {"dimenet": dimenet, "nequip": nequip, "mace": mace}
    dev = torch.device(device)
    q, r = np.linalg.qr(np.random.default_rng(seed + 1).standard_normal(
        (3, 3)))
    rot = q * np.sign(np.diag(r))
    rot = torch.from_numpy((rot if np.linalg.det(rot) > 0 else -rot
                            ).astype(np.float32))
    out = {}
    for arch, base in configs.items():
        mod = mods[arch]
        cfg = dataclasses.replace(base, n_graphs=shape[2])
        hgb, tri, targets = molecule_batch(cfg.n_types, "cpu", seed, shape,
                                           pad)
        gb = molecule_batch(cfg.n_types, dev, seed, shape, pad)[0]

        def batch(g, d):
            b = {"graph": g, "targets": torch.from_numpy(targets).to(d)}
            if arch == "dimenet":
                b["triplets"] = tuple(torch.from_numpy(t).to(d) for t in tri)
            return b

        if arch == "dimenet":
            def loss_fn(p, b):
                return mod.energy_loss(p, b["graph"], cfg, b["triplets"],
                                       b["targets"])

            def fwd(p, b):
                return mod.forward(p, b["graph"], cfg, b["triplets"])
        else:
            def loss_fn(p, b):
                return mod.energy_loss(p, b["graph"], cfg, b["targets"])

            def fwd(p, b):
                return mod.forward(p, b["graph"], cfg)
        params = mod.init_params(torch.Generator().manual_seed(seed), cfg,
                                 device="cpu")
        on_dev = tree_map(lambda t: t.to(dev), params)
        bd, bh = batch(gb, dev), batch(hgb, "cpu")
        with torch.no_grad():
            err = tensors_within(fwd(on_dev, bd), fwd(params, bh), FP32_TOL,
                                 f"{arch} forward, card against CPU")
        loss, grads = value_and_grad(loss_fn, on_dev, bd)
        want_loss, want = value_and_grad(loss_fn, params, bh)
        err = max(err, tensors_within(loss, want_loss, FP32_TOL,
                                      f"{arch} loss"))
        grad_err = 0.0
        for i, (g, w) in enumerate(zip(tree_leaves(grads),
                                       tree_leaves(want))):
            grad_err = max(grad_err, tensors_within(
                g, w, FP32_TOL, f"{arch} gradient, leaf {i}"))
        rec = {"params": count_params(params), "nodes": gb.n_nodes,
               "edges": gb.n_edges, "graphs": cfg.n_graphs,
               "loss": float(want_loss), "max_abs_err": err,
               "grad_max_abs_err": grad_err}
        if arch == "dimenet":
            rec["triplets"] = [int(tri[2].sum()), int(tri[2].shape[0])]
        if arch != "dimenet":
            e, f = energy_forces(mod, on_dev, gb, cfg)
            e2, f2 = energy_forces(mod, on_dev, dataclasses.replace(
                gb, positions=gb.positions @ rot.to(dev).T), cfg)
            rec["rotation_energy_err"] = tensors_within(
                e2, e, FP32_TOL, f"{arch} energy under a rotation")
            rec["rotation_force_err"] = tensors_within(
                f2, f @ rot.to(dev).T, FP32_TOL,
                f"{arch} forces under a rotation")
        if arch == "nequip":
            rec["forces_err"] = tensors_within(
                mod.forces(on_dev, gb, cfg), mod.forces(params, hgb, cfg),
                FP32_TOL, "nequip forces, card against CPU")
        ocfg = opt.AdamWConfig()
        step = make_train_step(loss_fn, ocfg)
        state = init_train_state(on_dev, ocfg)
        losses, ms = [], []
        for _ in range(steps):
            sync(dev)
            t = time.perf_counter()
            state, metrics = step(state, bd)
            losses.append(float(host(metrics["loss"])))
            sync(dev)
            ms.append((time.perf_counter() - t) * 1e3)
        check(all(np.isfinite(losses)), f"{arch}: a loss is not finite")
        rec.update(train_losses=losses, train_step_ms=ms)
        if dev.type == "cuda":
            def forward():
                with torch.no_grad():
                    return fwd(on_dev, bd)
            rec["forward_ms"] = cuda_ms(forward, 5)
            held = {"state": state}

            def one_step():
                held["state"], _ = step(held["state"], bd)
            rec["step_trace"] = device_profile(one_step, iters=2, top=4)
        out[arch] = rec
    return out


def mind_batch(cfg, B: int, rng, device):
    """Histories of ``cfg.hist_len`` items with ragged lengths (1 to
    hist_len valid positions), and targets."""
    hist = rng.integers(0, cfg.n_items, (B, cfg.hist_len)).astype(np.int32)
    lens = rng.integers(1, cfg.hist_len + 1, B)
    mask = np.arange(cfg.hist_len)[None, :] < lens[:, None]
    target = rng.integers(0, cfg.n_items, B).astype(np.int32)
    return {"hist": torch.from_numpy(hist).to(device),
            "hist_mask": torch.from_numpy(mask).to(device),
            "target": torch.from_numpy(target).to(device)}


def mind_phase(cfg=None, batch: int = MIND_BATCH, steps: int = MIND_STEPS,
               serve: tuple = MIND_SERVE, parity_batch: int = 256,
               device: str = "cuda", seed: int = 0) -> dict:
    """(d) MIND at full width, weights drawn on ``device`` from a seeded
    generator and copied to the CPU: ``train_loss`` and its gradient at
    ``parity_batch``, ``score_candidates`` at ``serve`` (users x
    candidates) and ``retrieval_scores`` of one user against every item,
    card equal to CPU; then ``steps`` trainer steps at ``batch`` (the
    [batch, batch] in-batch logits), timed, with the peak memory."""
    from repro_torch.configs import mind as mind_configs
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.recsys import mind
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import (
        init_train_state, make_train_step, value_and_grad,
    )
    from repro_torch.utils import host
    cfg = cfg or mind_configs.full()
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    params = mind.init_params(torch.Generator(device=dev).manual_seed(seed),
                              cfg, device=dev)
    host_params = tree_map(lambda t: t.cpu(), params)

    def loss_fn(p, b):
        return mind.train_loss(p, b, cfg)

    small = mind_batch(cfg, parity_batch, rng, "cpu")
    loss, grads = value_and_grad(loss_fn, params, tree_map(
        lambda t: t.to(dev), small))
    want_loss, want = value_and_grad(loss_fn, host_params, small)
    err = tensors_within(loss, want_loss, FP32_TOL, "MIND loss")
    grad_err = 0.0
    for i, (g, w) in enumerate(zip(tree_leaves(grads), tree_leaves(want))):
        grad_err = max(grad_err, tensors_within(
            g, w, FP32_TOL, f"MIND gradient, leaf {i}"))
    users, n_cand = serve
    s = mind_batch(cfg, users, rng, "cpu")
    cand = torch.from_numpy(rng.integers(0, cfg.n_items, (users, n_cand)
                                         ).astype(np.int32))
    with torch.no_grad():
        got = mind.score_candidates(params, s["hist"].to(dev),
                                    s["hist_mask"].to(dev), cand.to(dev), cfg)
        serve_err = tensors_within(got, mind.score_candidates(
            host_params, s["hist"], s["hist_mask"], cand, cfg), FP32_TOL,
            "MIND score_candidates")
        ids = torch.arange(cfg.n_items, dtype=torch.int32)
        got = mind.retrieval_scores(params, s["hist"][:1].to(dev),
                                    s["hist_mask"][:1].to(dev), cfg,
                                    ids.to(dev))
        retrieval_err = tensors_within(got, mind.retrieval_scores(
            host_params, s["hist"][:1], s["hist_mask"][:1], cfg, ids),
            FP32_TOL, "MIND retrieval_scores")
    rec = {"n_items": cfg.n_items, "embed_dim": cfg.embed_dim,
           "parity_batch": parity_batch, "loss": float(want_loss),
           "max_abs_err": err, "grad_max_abs_err": grad_err,
           "serve": [users, n_cand], "serve_max_abs_err": serve_err,
           "retrieval_candidates": cfg.n_items,
           "retrieval_max_abs_err": retrieval_err}
    del grads, want
    if dev.type == "cuda":
        rec["serve_ms"] = cuda_ms(lambda: mind.score_candidates(
            params, s["hist"].to(dev), s["hist_mask"].to(dev), cand.to(dev),
            cfg), 5)
        rec["retrieval_ms"] = cuda_ms(lambda: mind.retrieval_scores(
            params, s["hist"][:1].to(dev), s["hist_mask"][:1].to(dev), cfg,
            ids.to(dev)), 5)
        torch.cuda.reset_peak_memory_stats()
    ocfg = opt.AdamWConfig()
    step = make_train_step(loss_fn, ocfg)
    state = init_train_state(params, ocfg)
    del params
    losses, ms = [], []
    for _ in range(steps):
        b = mind_batch(cfg, batch, rng, dev)
        sync(dev)
        t = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(host(metrics["loss"])))
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    check(all(np.isfinite(losses)), f"MIND: a loss is not finite: {losses}")
    rec.update(train_batch=batch, train_losses=losses, train_step_ms=ms,
               logits_bytes=4 * batch * batch)
    if dev.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        check(rec["max_memory_allocated"] < TRAIN_MEM_LIMIT,
              f"MIND: peak memory {rec['max_memory_allocated']} B")
    return rec


def run_training(ops, only, seconds: dict) -> dict:
    """Phase 11 with every kernel count zeroed just before it and read just
    after: the reference trains through ``chunked_attention`` and segment
    sums, and no kernel has a backward, so the path launches none."""
    out = {}
    reset_launches(ops)
    phases = (("train", "lm", train_lm_phase,
               "11a: starcoder2-3b full width trained"),
              ("train", "lm_parity", train_parity_phase,
               "11a: card == CPU, one step at 2 layers in fp32"),
              ("train", "cli", train_cli_phase,
               "11b: launch/train.py recovered"),
              ("molecular", "molecular", molecular_phase,
               "11c: DimeNet, NequIP, MACE full width"),
              ("recsys", "mind", mind_phase, "11d: MIND full width"))
    for part, key, fn, what in phases:
        if part not in only:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[f"train_{key}"] = time.perf_counter() - t0
        log(f"phase {what}; " + json.dumps(out[key]))
    launches = {fn: getattr(ops, fn).launches for fn in
                ("block_spmm", "segment_multi_agg", "flash_attention")}
    check(not any(launches.values()),
          f"phase 11's path launched a kernel: {launches}")
    log(f"phase 11: kernel launches on its path {json.dumps(launches)}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 12

def multidevice_sizes(full: bool = True) -> dict:
    """Phase 12's shapes: the card's, or smoke sizes for the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import preset_100m
    if full:
        qwen = get_arch("qwen2-moe-a2.7b").full()
        return {"moe": qwen.moe, "d_model": qwen.d_model,
                "moe_tokens": MD_MOE_TOKENS, "pna": get_arch("pna").full(),
                "pna_graph": PNA_GRAPH, "cp": MD_CP, "cp_chunk": 512,
                "decode_len": MD_DECODE_LEN, "lm": preset_100m(),
                "dp_batch": MD_DP_BATCH, "mind": get_arch("mind").full(),
                "mind_batch": MIND_BATCH, "timed": True}
    qwen = get_arch("qwen2-moe-a2.7b").smoke()
    return {"moe": qwen.moe, "d_model": qwen.d_model, "moe_tokens": (2, 16),
            "pna": get_arch("pna").smoke(), "pna_graph": (48, 160),
            "cp": (2, 8, 2, 64, 16), "cp_chunk": 16, "decode_len": (40, 64),
            "lm": get_arch("starcoder2-3b").smoke(), "dp_batch": (4, 16),
            "mind": get_arch("mind").smoke(), "mind_batch": 64,
            "timed": False}


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| in fp64 (the norm at least 1e-30)."""
    g, w = got.detach().double(), want.detach().double().to(got.device)
    return float(torch.linalg.vector_norm(g - w)
                 / max(float(torch.linalg.vector_norm(w)), 1e-30))


def bf16_within(got, want, what: str) -> float:
    err = rel_err(got, want)
    check(err <= BF16_REL, f"{what}: relative error {err:.3e} above "
                           f"{BF16_REL:.3e}")
    return err


def _on(mesh, *tensors) -> None:
    for t in tensors:
        check(t.device == mesh.device,
              f"rank {mesh.rank}: a result on {t.device}, not {mesh.device}")


def _leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of a dict tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    return [prefix[:-1]]


def _routing(x2d, w, cfg):
    """Top-k expert sets and fp32 logits as the MoE layer routes rows."""
    from repro_torch.models.moe import _mask_padded
    logits = _mask_padded((x2d @ w).to(torch.float32), cfg)
    idx = torch.topk(torch.softmax(logits, -1), cfg.top_k, -1).indices
    return torch.sort(idx, -1).values, logits


def md_moe(mesh, sz, dev) -> dict:
    """12a: the expert-parallel layer against ``moe_apply`` where nothing
    drops (each rank in turn holds the single-process twin), then at the
    config's capacity factor: dropped share, times, collectives."""
    import torch.distributed as dist

    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding as S
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.models.moe_sharded import (
        _local_dispatch, expert_spec, local_capacity,
    )
    base, D = sz["moe"], sz["d_model"]
    Bl, Sq = sz["moe_tokens"]
    dp, mp = mesh.shape["data"], mesh.shape["model"]
    gen = torch.Generator(device=dev).manual_seed(1)
    full = moe_init(gen, D, base, dtype=torch.bfloat16, device=dev)
    x = torch.randn((Bl * dp, Sq, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    ct = torch.randn(x.shape, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    wspec, xspec = expert_spec(("data",), "model"), ("data", None, None)
    specs = {k: (wspec if k in ("wi", "wg", "wo") else
                 tree_map(lambda _: (), v)) for k, v in full.items()}
    no_drop = base.n_experts / base.top_k
    rec = {"experts": base.n_experts, "top_k": base.top_k,
           "d_ff_expert": base.d_ff_expert, "d_model": D,
           "tokens_per_data_rank": Bl * Sq, "no_drop_capacity": no_drop}

    def sharded(cf, grads=True):
        cfg = dataclasses.replace(base, capacity_factor=cf, mesh=mesh)
        p = {k: (S.local_block(v, specs[k], mesh) if k in ("wi", "wg", "wo")
                 else v) for k, v in full.items()}
        p = tree_map(lambda a: a.detach().clone().requires_grad_(grads), p)
        xl = S.local_block(x, xspec, mesh).detach().clone().requires_grad_(
            grads)
        out, aux = moe_apply(p, xl, cfg)
        if not grads:
            return out, aux, p, xl, None
        loss = torch.sum(out.float() * S.local_block(ct, xspec, mesh).float()
                         ) / S.n_replicas(xspec, mesh)
        gs = torch.autograd.grad(loss, tree_leaves(p) + [xl])
        gs = [S.sum_over_replicas(g, sp, mesh) for g, sp in
              zip(gs, S.spec_leaves(specs) + [xspec])]
        return out, aux, p, xl, gs

    out, aux, p, xl, gs = sharded(no_drop)
    _on(mesh, out, aux, *gs)
    # the tokens whose experts differ between the layer's per-peer router
    # GEMMs and the twin's whole-batch one, on this rank's data block
    T_l, T_loc = Bl * Sq, Bl * Sq // mp
    d_idx = C.axis_index("data", mesh)
    with torch.no_grad():
        x_all = x.reshape(-1, D)
        twin_sets, twin_logits = _routing(x_all, full["router"]["w"], base)
        mine = x_all[d_idx * T_l:(d_idx + 1) * T_l]
        peer_sets = torch.cat([_routing(mine[m * T_loc:(m + 1) * T_loc],
                                        full["router"]["w"], base)[0]
                               for m in range(mp)])
        twin_mine = twin_sets[d_idx * T_l:(d_idx + 1) * T_l]
        parted = torch.nonzero((peer_sets != twin_mine).any(-1))[:, 0]
        top = torch.topk(twin_logits[d_idx * T_l:(d_idx + 1) * T_l],
                         base.top_k + 1, -1).values
        gaps = (top[:, -2] - top[:, -1])[parted]
    check(bool((gaps < MOE_NEAR_TIE).all()),
          f"12a: tokens routed apart from the twin away from a tie: "
          f"{gaps.tolist()}")
    rec["routing_partings"] = int(parted.numel())
    errs = {}
    for turn in range(mesh.size):
        if turn == mesh.rank:
            twin_cfg = dataclasses.replace(base, capacity_factor=no_drop)
            fp = tree_map(lambda a: a.detach().clone().requires_grad_(),
                          full)
            fx = x.detach().clone().requires_grad_()
            t_out, _ = moe_apply(fp, fx, twin_cfg)
            t_gs = torch.autograd.grad(torch.sum(t_out.float() * ct.float()),
                                       tree_leaves(fp) + [fx])
            keep = torch.ones(T_l, dtype=torch.bool, device=dev)
            keep[parted] = False
            want = S.local_block(t_out, xspec, mesh).reshape(T_l, D)
            errs["out"] = bf16_within(out.reshape(T_l, D)[keep], want[keep],
                                      "12a output, sharded == moe_apply")
            names = [f"grad {k}" for k in _leaf_names(full)] + ["grad x"]
            for name, g, w, sp in zip(names, gs, t_gs,
                                      S.spec_leaves(specs) + [xspec]):
                errs[name] = bf16_within(g, S.local_block(w, sp, mesh),
                                         f"12a {name}, sharded == moe_apply")
            del fp, fx, t_out, t_gs, want
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    rec["no_drop_rel_err"] = {k: max(v, 0.0) for k, v in errs.items()}
    del out, aux, p, xl, gs

    # the config's capacity factor: dropped share, times, collectives
    cf = base.capacity_factor
    with torch.no_grad():
        xt = S.local_block(x, xspec, mesh).reshape(T_l, D)
        m_idx = C.axis_index("model", mesh)
        C_loc = local_capacity(T_loc, base)
        _, meta = _local_dispatch(xt[m_idx * T_loc:(m_idx + 1) * T_loc],
                                  full["router"]["w"], base, C_loc)
        keep = meta[2]
        dropped = C.psum(torch.stack([(~keep).sum(), keep.new_tensor(
            keep.numel(), dtype=torch.int64)]), ("data", "model"), mesh)
    rec["capacity_factor"] = cf
    rec["c_loc"] = C_loc
    rec["dropped_share"] = float(dropped[0]) / float(dropped[1])
    mesh.reset_counts()
    with torch.no_grad():
        sharded(cf, grads=False)
    rec["forward_collectives"] = {k: dict(v) for k, v in mesh.counts.items()}
    mesh.reset_counts()
    sharded(cf)
    rec["forward_backward_collectives"] = {
        k: dict(v) for k, v in mesh.counts.items()}
    if sz["timed"]:
        def fwd():
            with torch.no_grad():
                sharded(cf, grads=False)
        # one warm-up call, then the median of 3
        rec["forward_ms"] = float(np.median(
            _timed_steps(mesh, fwd, 4, dev)[1:])) * 1e3
        rec["forward_backward_ms"] = float(np.median(
            _timed_steps(mesh, lambda: sharded(cf), 4, dev)[1:])) * 1e3
    return rec


def md_pna(mesh, sz, dev) -> dict:
    """12b: PNA dst-partitioned over every rank == the single-process run
    on the same device."""
    from repro_torch.graphops.distributed import partition_edges_by_dst
    from repro_torch.launch import sharding as S
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.gnn import pna
    from repro_torch.models.gnn.graphdata import GraphBatch
    cfg = sz["pna"]
    gb = pna_graph(cfg, *sz["pna_graph"], dev)
    N, axes = gb.n_nodes, ("data", "model")
    check(N % mesh.size == 0, f"12b: {N} nodes do not split over the ranks")
    perm, emask, _ = partition_edges_by_dst(
        gb.edge_src.cpu().numpy(), gb.edge_dst.cpu().numpy(), N, mesh.size)
    perm_t = torch.from_numpy(perm).to(dev)
    emask_t = torch.from_numpy(emask).to(dev) & gb.edge_mask[perm_t]
    nspec, espec = (axes, None), (axes,)
    lb = lambda t, sp: S.local_block(t, sp, mesh)  # noqa: E731
    local = GraphBatch(
        node_feat=lb(gb.node_feat, nspec),
        edge_src=lb(gb.edge_src[perm_t], espec),
        edge_dst=lb(gb.edge_dst[perm_t], espec),
        edge_mask=lb(emask_t, espec), node_mask=lb(gb.node_mask, espec),
        graph_id=lb(gb.graph_id, espec), labels=lb(gb.labels, espec))
    params = pna.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    params = tree_map(lambda t: t.to(dev).requires_grad_(), params)
    scfg = dataclasses.replace(cfg, mesh=mesh, shard_axes=axes)
    out = pna.forward(params, local, scfg)
    loss = pna.loss_fn(params, local, scfg)
    gs = torch.autograd.grad(loss / mesh.size, tree_leaves(params))
    gs = [S.sum_over_replicas(g, (), mesh) for g in gs]
    _on(mesh, out, loss, *gs)
    want_out = pna.forward(params, gb, cfg)
    want_loss = pna.loss_fn(params, gb, cfg)
    want = torch.autograd.grad(want_loss, tree_leaves(params))
    err = tensors_within(out, lb(want_out, nspec), FP32_TOL,
                         "12b PNA forward, sharded == single")
    err = max(err, tensors_within(loss, want_loss, FP32_TOL, "12b PNA loss"))
    grad_err = max(tensors_within(g, w, PNA_GRAD_TOL, f"12b PNA grad {i}")
                   for i, (g, w) in enumerate(zip(gs, want)))
    return {"nodes": N, "edges": int(gb.edge_mask.sum()),
            "edges_per_rank": int(local.edge_src.numel()),
            "loss": float(loss.detach()), "max_abs_err": err,
            "grad_max_abs_err": grad_err}


def md_attention(mesh, sz, dev) -> dict:
    """12c: context-parallel attention == ``chunked_attention`` on this
    rank's batch row, forward and backward; then ``combine_partials`` of
    split-KV decode partials == ``decode_attention``."""
    from repro_torch.launch import sharding as S
    from repro_torch.models import attention as attn
    B, Hq, Hkv, Sq, Dh = sz["cp"]
    chunk = sz["cp_chunk"]
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    q, ct = (torch.randn((B, Hq, Sq, Dh), generator=gen, device=dev,
                         dtype=bf) for _ in range(2))
    k, v = (torch.randn((B, Hkv, Sq, Dh), generator=gen, device=dev,
                        dtype=bf) for _ in range(2))
    spec = ("data", None, "model", None)
    ql, kl, vl = (S.local_block(t, spec, mesh).detach().clone()
                  .requires_grad_() for t in (q, k, v))
    o = attn.context_parallel_attention(ql, kl, vl, mesh, causal=True,
                                        chunk=chunk)
    gs = torch.autograd.grad(
        torch.sum(o.float() * S.local_block(ct, spec, mesh).float()),
        [ql, kl, vl])
    _on(mesh, o, *gs)
    row = ("data", None, None, None)
    tq, tk, tv = (S.local_block(t, row, mesh).detach().clone()
                  .requires_grad_() for t in (q, k, v))
    want = attn.chunked_attention(tq, tk, tv, causal=True, chunk=chunk)
    t_gs = torch.autograd.grad(
        torch.sum(want.float() * S.local_block(ct, row, mesh).float()),
        [tq, tk, tv])
    seq = (None, None, "model", None)
    errs = {"out": bf16_within(o, S.local_block(want, seq, mesh),
                               "12c output, context-parallel == chunked")}
    for n, g, w in zip("qkv", gs, t_gs):
        errs[f"grad {n}"] = bf16_within(g, S.local_block(w, seq, mesh),
                                        f"12c grad {n}")
    lens = torch.tensor(sz["decode_len"], device=dev)
    dq = torch.randn((B, Hq, Dh), generator=gen, device=dev, dtype=bf)
    valid = torch.arange(Sq, device=dev)[None, :] < lens[:, None]
    kv = (None, None, "model", None)
    parts = attn.decode_attention_partial(
        dq, S.local_block(k, kv, mesh), S.local_block(v, kv, mesh),
        S.local_block(valid, (None, "model"), mesh))
    got = attn.combine_partials(*parts, "model", mesh)
    _on(mesh, got)
    errs["decode"] = bf16_within(got, attn.decode_attention(dq, k, v, lens),
                                 "12c combine_partials == decode_attention")
    return {"shape": list(sz["cp"]), "chunk": chunk,
            "decode_len": list(sz["decode_len"]), "rel_err": errs}


def md_dp_step(mesh, sz, dev) -> dict:
    """12d: the group's compressed step == the one-process step over as
    many shards, parameters, moments, loss and this rank's error
    feedback."""
    from repro_torch.data.tokens import token_batch
    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding as S
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import (
        init_train_state, make_compressed_dp_step,
    )
    cfg, (B, Sq) = sz["lm"], sz["dp_batch"]
    n = mesh.shape["data"]
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=MD_STEPS)

    def loss_fn(p, b):
        return tfm.lm_loss(p, b[0], b[1], cfg)

    def params():
        return tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)

    def batch(s):
        x, y = token_batch(s, B, Sq, cfg.vocab)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    state = init_train_state(params(), ocfg, compressed_dp=True)
    step = make_compressed_dp_step(loss_fn, ocfg, mesh=mesh)
    twin = init_train_state(params(), ocfg, compressed_dp=True, n_shards=n)
    twin_step = make_compressed_dp_step(loss_fn, ocfg, n_shards=n)
    losses, twin_losses = [], []
    for s in range(MD_STEPS):
        x, y = batch(s)
        state, m = step(state, tuple(S.local_block(t, ("data", None), mesh)
                                     for t in (x, y)))
        losses.append(float(m["loss"]))
        twin, m = twin_step(twin, (x, y))
        twin_losses.append(float(m["loss"]))
    _on(mesh, *tree_leaves(state.params))
    i = C.axis_index("data", mesh)
    pairs = {"params": (tree_leaves(state.params), tree_leaves(twin.params)),
             "moments": (tree_leaves(state.opt_state),
                         tree_leaves(twin.opt_state)),
             "ef": (tree_leaves(state.ef), [e[i] for e in tree_leaves(
                 twin.ef)])}
    rec = {"steps": MD_STEPS, "params": sum(t.numel() for t in pairs[
        "params"][0]), "losses": losses, "twin_losses": twin_losses}
    for name, (got, want) in pairs.items():
        rec[f"{name}_bitwise"] = all(torch.equal(a, b)
                                     for a, b in zip(got, want))
        rec[f"{name}_max_abs_diff"] = max(
            float((a.double() - b.double()).abs().max()) for a, b in
            zip(got, want))
        for j, (a, b) in enumerate(zip(got, want)):
            tensors_within(a, b, FP32_TOL, f"12d {name} leaf {j}")
    rec["loss_max_abs_diff"] = max(abs(a - b) for a, b in
                                   zip(losses, twin_losses))
    return rec


def md_mind(mesh, sz, dev) -> dict:
    """12e: MIND's loss and gradients with the in-batch logits' rows over
    the data ranks == rank 0's single-process run at the same batch."""
    import torch.distributed as dist

    from repro_torch.launch import sharding as S
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.recsys import mind
    cfg, B = sz["mind"], sz["mind_batch"]
    params = mind.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, device=dev)
    for t in tree_leaves(params):
        t.requires_grad_()
    batch = mind_batch(cfg, B, np.random.default_rng(3), dev)
    local = {k: S.local_block(v, ("data",) + (None,) * (v.dim() - 1), mesh)
             for k, v in batch.items()}
    scfg = dataclasses.replace(cfg, logits_pspec=("data", None))
    loss = mind.train_loss(params, local, scfg, mesh)
    gs = torch.autograd.grad(loss / mesh.size, tree_leaves(params))
    gs = [S.sum_over_replicas(g, (), mesh) for g in gs]
    _on(mesh, loss, *gs)
    rec = {"batch": B, "rows_per_rank": B // mesh.shape["data"],
           "logits_bytes_per_rank": 4 * B * (B // mesh.shape["data"]),
           "loss": float(loss.detach())}
    if dev.type == "cuda":
        rec["sharded_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    dist.barrier()
    if mesh.rank == 0:
        want_loss = mind.train_loss(params, batch, cfg)
        want = torch.autograd.grad(want_loss, tree_leaves(params))
        rec["max_abs_err"] = tensors_within(loss, want_loss, FP32_TOL,
                                            "12e MIND loss")
        rec["grad_max_abs_err"] = max(
            tensors_within(g, w, FP32_TOL, f"12e MIND grad {i}")
            for i, (g, w) in enumerate(zip(gs, want)))
    dist.barrier()
    return rec


def multidevice_ranks(rank, world_size, init_method, device, full):
    """Phase 12's rank program: 12a-c on a 2 x 2 mesh, 12d-e on 4 x 1 over
    the same ranks.  Every check raises; rank 0 returns the records."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_rank_mesh
    sz = multidevice_sizes(full)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_rank_mesh(world_size, rank, init_method, MD_MESH,
                          backend="gloo", devices=dev)
    dp_mesh = make_rank_mesh(world_size, rank, init_method, MD_DP_MESH,
                             backend="gloo", devices=dev)
    out = {"rank": rank, "device": str(mesh.device), "seconds": {},
           "peak_bytes": {}, "collectives": {}}
    for name, fn, m in (("12a_moe", md_moe, mesh), ("12b_pna", md_pna, mesh),
                        ("12c_attention", md_attention, mesh),
                        ("12d_dp_step", md_dp_step, dp_mesh),
                        ("12e_mind", md_mind, dp_mesh)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        m.reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        out[name] = fn(m, sz, dev)
        sync(dev)
        dist.barrier()
        out["seconds"][name] = time.perf_counter() - t0
        out["collectives"][name] = {k: dict(v) for k, v in m.counts.items()}
        if dev.type == "cuda":
            out["peak_bytes"][name] = torch.cuda.max_memory_allocated(dev)
        gc.collect()
    out["kernel_launches"] = {fn: getattr(ops, fn).launches for fn in
                              ("block_spmm", "segment_multi_agg",
                               "flash_attention")}
    check(not any(out["kernel_launches"].values()),
          f"rank {rank}: phase 12 launched a kernel")
    return out


def multidevice_phase(device: str = "cuda:0", full: bool = True) -> dict:
    """Phase 12: ``MD_RANKS`` ranks on ``device`` (one card, or the CPU),
    backend gloo named explicitly; the records of every rank."""
    from repro_torch.launch.spawn import spawn
    ranks = spawn(multidevice_ranks, MD_RANKS, device, full,
                  timeout=MD_TIMEOUT)
    rec = {k: v for k, v in ranks[0].items() if k.startswith("12")}
    rec["backend"] = "gloo"
    rec["devices"] = [r["device"] for r in ranks]
    rec["seconds"] = ranks[0]["seconds"]
    rec["collectives_rank0"] = ranks[0]["collectives"]
    rec["peak_bytes_per_rank"] = [r["peak_bytes"] for r in ranks]
    return rec


# ------------------------------------------------------------- phase 13

def cell_sizes(full: bool = True) -> dict:
    """Phase 13's config and shapes: the card's, or smoke sizes for the
    CPU."""
    from repro_torch.configs import get_arch
    spec = get_arch(CELL_ARCH)
    if full:
        return {"base": spec.full(), "layers": CELL_LAYERS,
                "train": CELL_TRAIN, "parity": CELL_PARITY,
                "decode": CELL_DECODE, "timed": True}
    return {"base": spec.smoke(), "layers": 2, "train": (4, 16),
            "parity": (4, 16), "decode": (4, 32), "timed": False}


def phase13_cell(kind: str, mesh, sz: dict, dtype, parity: bool):
    """The cell ``build_cell`` makes for ``kind`` with the phase's
    override.  ``parity``: a train cell drops nothing and has no aux loss.
    Its capacity factor is the allocated experts over top-k, so every
    expert has a slot for every token on each model peer and in the twin:
    an untrained model's router sends most tokens to a few experts, so a
    smaller capacity drops, and the peers (each by its own capacity, the
    reference's sharded layer) and the twin drop different tokens.  The
    expert-parallel layer's aux loss is the mean of its peers', not the
    twin's."""
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch.steps import lm_cell
    cfg = dataclasses.replace(sz["base"], n_layers=sz["layers"], dtype=dtype)
    if parity and kind == "train":
        mp = mesh.shape["model"]
        e_alloc = -(-cfg.moe.n_experts // mp) * mp
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=e_alloc / cfg.moe.top_k + 1e-3,
            router_aux_weight=0.0))
    B, S = sz["parity" if parity and kind == "train" else kind]
    shape_name = "train_4k" if kind == "train" else "decode_32k"
    return lm_cell(CELL_ARCH, LMShape(kind, S, B), shape_name, mesh, cfg)


def _in_turns(mesh, make):
    """``make()`` on one rank at a time (each draws whole weights), every
    rank's cached blocks released first."""
    import torch.distributed as dist
    gc.collect()
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    out = None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            out = make()
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def _leaf_errs(got, want, what: str) -> dict:
    """Each leaf's largest difference over the twin's largest magnitude
    there (``scaled``) and its relative Frobenius error (``rel``);
    integer leaves must be equal."""
    from repro_torch.launch.steps import tree_paths
    want = dict(tree_paths(want))
    out = {}
    for path, g in tree_paths(got):
        w = want[path]
        g = g.to(w.device)
        check(g.shape == w.shape, f"{what} {path}: shape {tuple(g.shape)} "
                                  f"!= {tuple(w.shape)}")
        if not g.is_floating_point():
            check(torch.equal(g, w), f"{what} {path}: differs")
            continue
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g.double() - w.double()).abs().max()) / max(scale, 1e-30)
        out[path] = {"scaled": err, "rel": rel_err(g, w)}
    return out


def _group_worst(errs: dict, key: str) -> dict:
    """The worst ``key`` error of each group of leaves (parameters, the
    two moments, each metric or output)."""
    worst = {}
    for path, e in errs.items():
        group = ("params" if ".params" in path else "m" if ".m" in path
                 else "v" if ".v" in path else path.split("'")[-2]
                 if "'" in path else path)
        worst[group] = max(worst.get(group, 0.0), e[key])
    return worst


def _first_routings(log, L: int) -> list:
    """The first ``L`` routings of a run (its forward's layers, before
    remat's recomputes): sorted top-k sets and fp32 logits."""
    return [(torch.sort(idx, -1).values, logits) for idx, logits in log[:L]]


def _partings(mine, twin, S: int, K: int) -> tuple:
    """Tokens whose top-k experts differ between the sharded run's routing
    (every token, gathered) and the twin's, layer by layer, and the twin's
    gap between its K-th and (K+1)-th logits at each parting no earlier
    one explains.  A parting changes its token's output, and causal
    attention carries that to every later position of its sequence in the
    next layer: a parting at (b, s) is explained by one at (b, s' <= s)
    in an earlier layer."""
    first, parted, gaps = {}, 0, []
    for sets, (t_sets, t_logits) in zip(mine, twin):
        diff = torch.nonzero((sets != t_sets).any(-1))[:, 0]
        top = torch.topk(t_logits[diff], K + 1, -1).values
        gap = (top[:, -2] - top[:, -1]).tolist()
        parted += int(diff.numel())
        new = {}
        for tok, g in zip(diff.tolist(), gap):
            b, pos = divmod(tok, S)
            if pos >= first.get(b, S):
                continue
            gaps.append(g)
            new[b] = min(new.get(b, S), pos)
        for b, pos in new.items():
            first[b] = min(first.get(b, S), pos)
    return parted, gaps


def _against_twin(mesh, cell, got, seed: int, dev, what: str,
                  routing=None) -> dict:
    """Each rank in turn runs the single-process twin on the whole inputs
    and holds its blocks of the result to ``got``.  ``routing``: the
    sharded MoE step's routing of every token ([B * S, K] sets a layer,
    and S); a token routed apart from the twin must sit at a near tie of
    the twin's logits, or downstream of one (:func:`_partings`), and where
    any token parted each leaf is held to BF16_REL relative error instead
    of CELL_TOL of its scale."""
    from repro_torch.launch.sharding import local_block
    from repro_torch.launch.steps import global_inputs, map_tree
    from repro_torch.models import moe

    got = map_tree(lambda t: t.detach().cpu(), got)   # room for the twin

    def one():
        moe.routing_log = [] if routing is not None else None
        out = cell.twin(*global_inputs(cell, mesh, seed, dev))
        twin_log, moe.routing_log = moe.routing_log, None
        want = map_tree(lambda t, sp: local_block(t, sp, mesh), out,
                        cell.out_specs)
        errs = _leaf_errs(got, want, f"{what} rank {mesh.rank}")
        del out, want
        parted, gaps = 0, []
        if routing is not None:
            mine, S = routing
            parted, gaps = _partings(mine, _first_routings(twin_log,
                                                           len(mine)),
                                     S, cell.cfg.moe.top_k)
        return errs, parted, gaps
    errs, total, gaps = _in_turns(mesh, one)
    check(all(g < MOE_NEAR_TIE for g in gaps),
          f"{what} rank {mesh.rank}: tokens routed apart from the twin away "
          f"from a near tie: gaps {gaps}")
    key, tol = ("rel", BF16_REL) if total else ("scaled", CELL_TOL)
    for path, e in errs.items():
        check(e[key] <= tol, f"{what} rank {mesh.rank} {path}: {key} error "
                             f"{e[key]:.3e} above {tol:.3e} ({total} "
                             f"tokens routed apart)")
    return {"routing_partings": total, "near_tie_gaps": gaps,
            "held_to": f"{key} <= {tol:.3e}",
            "scaled": _group_worst(errs, "scaled"),
            "rel": _group_worst(errs, "rel")}


def _timed_steps(mesh, step, n: int, dev) -> list:
    """Seconds of ``n`` calls of ``step()``, each between barriers with
    the card synced: the slowest rank's time (the first call holds the
    first use of its GEMMs)."""
    import torch.distributed as dist
    ts = []
    for _ in range(n):
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        step()
        sync(dev)
        dist.barrier()
        ts.append(time.perf_counter() - t0)
    return ts


def cell_train(mesh, sz, dev) -> dict:
    """13a: one fp32 step of the train cell against the twin (loss,
    gradient norm, every updated parameter and moment block), then the
    bf16 cell's step timed."""
    from repro_torch.launch.sharding import gather_full
    from repro_torch.launch.steps import rank_inputs
    from repro_torch.models import moe
    cell = phase13_cell("train", mesh, sz, torch.float32, parity=True)
    B, S = sz["parity"]
    c = cell.cfg
    rec = {"arch": CELL_ARCH, "layers": c.n_layers, "d_model": c.d_model,
           "experts": c.moe.n_experts, "experts_alloc": c.moe.e_alloc,
           "top_k": c.moe.top_k, "vocab": c.vocab, "parity_batch": [B, S],
           "timed_batch": list(sz["train"]),
           "parity_capacity_factor": c.moe.capacity_factor,
           "act_pspec": list(c.act_pspec),
           "cp": c.cp_mesh is not None, "seq_sharded": c.moe.seq_sharded}
    args = _in_turns(mesh, lambda: rank_inputs(cell, mesh, CELL_SEED, dev))
    mesh.reset_counts()
    moe.routing_log = []
    t0 = time.perf_counter()
    state, metrics = cell.fn(*args)
    sync(dev)
    rec["fp32_step_s"] = time.perf_counter() - t0
    mine, moe.routing_log = _first_routings(moe.routing_log,
                                            c.n_layers), None
    # every token's experts, [B, S, K] from each rank's [B/dp, S/mp, K]
    Bl, Sl = B // mesh.shape["data"], S // mesh.shape["model"]
    everyone = [gather_full(sets.reshape(Bl, Sl, -1), ("data", "model",
                                                        None), mesh
                            ).reshape(B * S, -1) for sets, _ in mine]
    rec["fp32_collectives"] = {k: dict(v) for k, v in mesh.counts.items()}
    _on(mesh, metrics["loss"], metrics["gnorm"])
    rec["loss"] = float(metrics["loss"])
    rec["gnorm"] = float(metrics["gnorm"])
    del args
    t0 = time.perf_counter()
    out, state, metrics = (state, metrics), None, None
    rec["parity"] = _against_twin(mesh, cell, out, CELL_SEED, dev,
                                  "13a fp32 step", (everyone, S))
    rec["twin_turns_s"] = time.perf_counter() - t0
    del out
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    cell16 = phase13_cell("train", mesh, sz, torch.bfloat16, parity=False)
    args = _in_turns(mesh, lambda: rank_inputs(cell16, mesh, CELL_SEED, dev))
    box = {"state": args[0]}

    def step():
        box["state"], box["metrics"] = cell16.fn(box["state"], args[1])
    n = CELL_TIMED if sz["timed"] else 1
    mesh.reset_counts()
    ts = _timed_steps(mesh, step, n, dev)
    loss = float(box["metrics"]["loss"])
    check(np.isfinite(loss), f"13a bf16 loss {loss}")
    rec["bf16_step_ms"] = [t * 1e3 for t in ts]
    rec["bf16_step_ms_last"] = ts[-1] * 1e3
    rec["bf16_loss"] = loss
    rec["bf16_collectives_per_step"] = {
        k: {f: v[f] // n for f in v} for k, v in mesh.counts.items()}
    return rec


def cell_decode(mesh, sz, dev) -> dict:
    """13b: one fp32 decode step of the decode cell, timed (its first
    call), against the twin (logits, the cache blocks)."""
    from repro_torch.launch.steps import rank_inputs
    cell = phase13_cell("decode", mesh, sz, torch.float32, parity=False)
    B, S = sz["decode"]
    rec = {"global_batch": B, "cache_len": S,
           "dispatch_pspec": list(cell.cfg.moe.dispatch_pspec),
           "note": cell.note}
    args = _in_turns(mesh, lambda: rank_inputs(cell, mesh, CELL_SEED, dev))
    mesh.reset_counts()
    box = {}

    def step():
        box["out"] = cell.fn(*args)
    rec["step_ms"] = [t * 1e3 for t in _timed_steps(mesh, step, 1, dev)]
    logits, cache = box.pop("out")
    rec["collectives"] = {k: dict(v) for k, v in mesh.counts.items()}
    _on(mesh, logits, cache["k"])
    out, logits, cache = (logits, cache), None, None
    rec["parity"] = _against_twin(mesh, cell, out, CELL_SEED, dev,
                                  "13b decode step")
    return rec


def cells_ranks(rank, world_size, init_method, device, full):
    """Phase 13's rank program on a 2 x 2 mesh; every check raises; each
    rank returns its record."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_rank_mesh
    sz = cell_sizes(full)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_rank_mesh(world_size, rank, init_method, CELL_MESH,
                          backend="gloo", devices=dev)
    out = {"rank": rank, "device": str(mesh.device), "seconds": {},
           "peak_bytes": {}}
    for name, fn in (("13a_train", cell_train), ("13b_decode", cell_decode)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        t0 = time.perf_counter()
        out[name] = fn(mesh, sz, dev)
        sync(dev)
        dist.barrier()
        out["seconds"][name] = time.perf_counter() - t0
        if dev.type == "cuda":
            out["peak_bytes"][name] = torch.cuda.max_memory_allocated(dev)
        gc.collect()
    out["kernel_launches"] = {fn: getattr(ops, fn).launches for fn in
                              ("block_spmm", "segment_multi_agg",
                               "flash_attention")}
    check(not any(out["kernel_launches"].values()),
          f"rank {rank}: phase 13 launched a kernel")
    return out


def cell_bound(full: bool = True) -> dict:
    """The dry run's count of 13a's bf16 cell on a meta 2 x 2 mesh (rank
    0): the step's bound at the H100's data-sheet peaks."""
    from repro_torch.launch.mesh import make_meta_mesh
    from repro_torch.roofline.analysis import analyze_cell
    sz = cell_sizes(full)
    mesh = make_meta_mesh(CELL_MESH, ("data", "model"), rank=0)
    cell = phase13_cell("train", mesh, sz, torch.bfloat16, parity=False)
    rep = analyze_cell(cell, mesh, arch=CELL_ARCH, shape="train_4k")
    return {"bound_ms": rep.step_time_bound_s * 1e3,
            "compute_ms": rep.compute_s * 1e3,
            "memory_ms": rep.memory_s * 1e3,
            "collective_ms": rep.collective_s * 1e3,
            "dominant": rep.dominant,
            "flops_per_rank": rep.hlo_flops / mesh.size,
            "bytes_per_rank": rep.hlo_bytes / mesh.size,
            "peak_bytes_per_rank": rep.peak_memory_bytes,
            "model_flops": rep.model_flops}


def cells_phase(device: str = "cuda:0", full: bool = True) -> dict:
    """Phase 13: four ranks on ``device`` (one card, or the CPU), gloo
    named explicitly; rank 0's records, every rank's seconds and peaks,
    and the dry run's bound of the timed step."""
    from repro_torch.launch.spawn import spawn
    ranks = spawn(cells_ranks, MD_RANKS, device, full, timeout=CELL_TIMEOUT)
    rec = {k: v for k, v in ranks[0].items() if k.startswith("13")}
    rec["backend"] = "gloo"
    rec["devices"] = [r["device"] for r in ranks]
    rec["seconds"] = ranks[0]["seconds"]
    rec["peak_bytes_per_rank"] = [r["peak_bytes"] for r in ranks]
    for name in ("13a_train", "13b_decode"):
        rec[name]["parity_by_rank"] = [r[name]["parity"] for r in ranks]
    rec["13a_train"]["dryrun_bound"] = cell_bound(full)
    return rec


# ---------------------------------------------------------------------------

def run_cells(seconds: dict) -> dict:
    """Phase 13 on the card, after the parent's cached memory is freed."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = cells_phase()
    seconds["cells"] = time.perf_counter() - t0
    for name in ("13a_train", "13b_decode"):
        log(f"phase {name}: " + json.dumps(rec[name]))
    a = rec["13a_train"]
    log(f"phase 13a: bf16 step {a['bf16_step_ms_last']:.1f} ms (the last "
        f"of {len(a['bf16_step_ms'])}) beside the dry run's bound "
        f"{a['dryrun_bound']['bound_ms']:.3f} ms "
        f"({a['dryrun_bound']['dominant']}) for the same cell on the same "
        f"2 x 2 mesh")
    log("phase 13: 4 ranks, backend gloo named explicitly, devices "
        f"{rec['devices']}; seconds {json.dumps(rec['seconds'])}; "
        f"peak bytes per rank {json.dumps(rec['peak_bytes_per_rank'])}; "
        f"nvidia-smi: {nvidia_smi()}.  These are host-staged gloo times of "
        "four ranks on one card, not NVLink")
    return rec


def run_multidevice(seconds: dict) -> dict:
    """Phase 12 on the card, after the parent's cached memory is freed."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = multidevice_phase()
    seconds["multidevice"] = time.perf_counter() - t0
    for name in ("12a_moe", "12b_pna", "12c_attention", "12d_dp_step",
                 "12e_mind"):
        log(f"phase {name}: " + json.dumps(rec[name]))
    log("phase 12: 4 ranks, backend gloo named explicitly, devices "
        f"{rec['devices']}; seconds {json.dumps(rec['seconds'])}; "
        f"collectives of rank 0 {json.dumps(rec['collectives_rank0'])}; "
        f"peak bytes per rank {json.dumps(rec['peak_bytes_per_rank'])}; "
        f"nvidia-smi: {nvidia_smi()}.  These are host-staged gloo times of "
        "four ranks on one card, not NVLink")
    return rec


def log_checks(what: str, rec: dict, launches: int) -> None:
    """What phase 3 or 4 checked: the reads compared, the views checked
    after the writes, the writes' targets; and its ``block_spmm``
    launches."""
    log(f"{what}: block_spmm launches {launches}; checked "
        + json.dumps(rec["checks"]))


def run_sharded(ops, seconds: dict) -> dict:
    """Phase 9 with its counts zeroed just before it and read after."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    t0 = time.perf_counter()
    shard = sharded_phase(SHARD_SCALE)
    seconds["sharded"] = time.perf_counter() - t0
    shard["launches"] = ops.block_spmm.launches
    shard["seconds"] = seconds["sharded"]
    shard["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log("phase 9: sharded SNB (shard_devices = ['cuda:0'] * "
        f"{SHARDS}, named explicitly) == unsharded session; "
        + json.dumps(shard))
    return shard


def probe(only: list, seconds: dict) -> int:
    """``--only=snb,finbench,sharded,pna,llm,train,molecular,recsys,
    multidevice,cells``: the named phases alone, for a short call on the
    card; prints no result line."""
    from repro_torch.kernels import ops
    if "snb" in only:
        reset_launches(ops)
        t0 = time.perf_counter()
        snb = snb_phase()
        seconds["snb"] = time.perf_counter() - t0
        log_checks("phase 3: SNB", snb, ops.block_spmm.launches)
    if "finbench" in only:
        reset_launches(ops)
        t0 = time.perf_counter()
        fin = finbench_phase()
        seconds["finbench"] = time.perf_counter() - t0
        log_checks("phase 4: FinBench session K == session S", fin,
                   ops.block_spmm.launches)
    if "sharded" in only:
        run_sharded(ops, seconds)
    if "pna" in only or "llm" in only:
        run_side_stacks(ops, only, seconds)
    if {"train", "molecular", "recsys"} & set(only):
        run_training(ops, only, seconds)
    if "multidevice" in only:
        run_multidevice(seconds)
    if "cells" in only:
        run_cells(seconds)
    log("seconds " + json.dumps(seconds))
    return 0


def main() -> int:
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--only=")]
    only = only[0] if only else []
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, ops, ref
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    t0 = time.perf_counter()
    build.build_all()
    seconds["build"] = time.perf_counter() - t0
    for name in build.sources():
        rec = build.build_log[name]
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           rec["ptxas"])]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             rec["ptxas"])]
        log(f"phase 1: built {name} in {rec['seconds']:.1f} s; ptxas over "
            f"{len(regs)} instantiations: at most {max(regs, default=0)} "
            f"registers, {max(spills, default=0)} bytes of spill stores")
    log(f"phase 1: all sources built in {seconds['build']:.1f} s")
    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")

    if only:
        return probe(only, seconds)

    t0 = time.perf_counter()
    rec = spmm_checks(ops, ref)
    seconds["kernel_checks"] = time.perf_counter() - t0

    reset_launches(ops)
    ops.spmm_slow_slabs("cuda").zero_()
    t0 = time.perf_counter()
    snb = snb_phase()
    seconds["snb"] = time.perf_counter() - t0
    snb_launches = ops.block_spmm.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fin = finbench_phase()
    seconds["finbench"] = time.perf_counter() - t0
    launches = ops.block_spmm.launches
    spmm_routes = dict(ops.block_spmm.launches_by_route)
    slow_slabs = int(ops.spmm_slow_slabs("cuda"))
    check(launches > 0, "the main path never launched block_spmm")
    check(spmm_routes["tc"] == launches,
          f"the main path's block_spmm left the u8 route: {spmm_routes}")
    log_checks("phase 3: SNB", snb, snb_launches)
    log_checks("phase 4: FinBench session K == session S", fin,
               launches - snb_launches)
    log(f"phase 4: max_memory_allocated {fin['max_memory_allocated']} B")
    slab_maps = ops.spmm_slab_map.launches
    check(0 < slab_maps <= launches,
          f"the main path built {slab_maps} slab maps for {launches} "
          f"block_spmm launches")
    log(f"phases 3-4: block_spmm routes {json.dumps(spmm_routes)}; "
        f"slab maps built {slab_maps}; u8 slabs on the CUDA cores "
        f"{slow_slabs}; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")

    t0 = time.perf_counter()
    agg = segment_phase(ops, ref)
    seconds["segment_agg"] = time.perf_counter() - t0
    check(agg["launches"] > 0,
          "the main path never launched segment_multi_agg")
    t0 = time.perf_counter()
    attn = attention_phase(ops, ref)
    seconds["attention"] = time.perf_counter() - t0
    check(attn["launches"] > 0, "the main path never launched flash_attention")

    gc.collect()                     # phase 4's sessions and their caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    snb_serve = serve_snb()
    seconds["serve_snb"] = time.perf_counter() - t0
    log("phase 7a: SNB serve == sequential twin; " + json.dumps(snb_serve))
    t1 = time.perf_counter()
    fin_serve = serve_finbench(ops)
    seconds["serve_finbench"] = time.perf_counter() - t1
    routes = fin_serve["launches_by_route"]
    check(fin_serve["launches"] > 0, "FinBench serving never launched "
                                     "block_spmm")
    check(routes["tc"] == fin_serve["launches"],
          f"FinBench serving's block_spmm left the u8 route: {routes}")
    log(f"phase 7b: FinBench serve through block_spmm == segment twin; "
        f"u8 slabs on the CUDA cores {fin_serve['slow_slabs']}; "
        + json.dumps(fin_serve))
    t1 = time.perf_counter()
    online = online_phase()
    seconds["online_selection"] = time.perf_counter() - t1
    log("phase 7c: online selection == views-off engine every round; "
        + json.dumps(online))
    log(f"phase 7: max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    seconds["serve"] = time.perf_counter() - t0      # the three above

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gnn = gnn_phase(ops, ref)
    seconds["gnn"] = time.perf_counter() - t0
    gnn_routes = gnn.pop("launches_by_route")
    check(gnn["launches"] > 0, "the GNN phase never launched block_spmm")
    check(gnn_routes["fp32"] == gnn["launches"],
          f"SAGE's block_spmm left the fp32 route: {gnn_routes}")
    log("phase 8: view-fed GNN on SNB " + json.dumps(
        {k: v for k, v in gnn.items() if not k.startswith("kernel")}))
    log("phase 8: block_spmm fp32 at KNOWS2's shape "
        + json.dumps(gnn["kernel_knows2"]))
    log("phase 8: block_spmm fp32 at ROOT_POST's shape "
        + json.dumps(gnn["kernel"]))
    log(f"phase 8: max_memory_allocated {torch.cuda.max_memory_allocated()} B")

    gc.collect()                     # phase 8's sessions and their caches
    torch.cuda.empty_cache()
    shard = run_sharded(ops, seconds)
    check(shard["launches"] == 0, "the sharded path launched block_spmm: "
                                  "its hops are segment hops")

    gc.collect()                     # phase 9's sessions and their caches
    torch.cuda.empty_cache()
    side = run_side_stacks(ops, ("pna", "llm"), seconds, agg.pop("pna_x10"))
    run_training(ops, ("train", "molecular", "recsys"), seconds)
    run_multidevice(seconds)
    run_cells(seconds)
    log("seconds " + json.dumps(seconds))
    by_phase = {"snb": snb_launches, "finbench": launches - snb_launches,
                "serve": fin_serve["launches"], "gnn": gnn["launches"]}
    spmm_routes = {k: v + routes[k] + gnn_routes[k]
                   for k, v in spmm_routes.items()}

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [{
        "name": "block_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_spmm.cu",
        "replaces": "src/repro/kernels/block_spmm.py:46",
        "launches": sum(by_phase.values()), "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"], "checked": True,
        "ms_finbench_like": rec["sparse"]["ms"],
        "map_ms": rec["sparse"]["map_ms"], "slab_maps": slab_maps,
        "launches_by_route": spmm_routes, "launches_by_phase": by_phase,
        "slow_slabs": slow_slabs + fin_serve["slow_slabs"],
        "ms_by_rows": {k: v["ms"] for k, v in rec["by_rows"].items()},
        "fp32_at_root_post": gnn["kernel"],
        "fp32_at_knows2": gnn["kernel_knows2"],
    }, {
        "name": "segment_multi_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_agg.cu",
        "replaces": "src/repro/kernels/segment_agg.py:44",
        **{k: agg[k] for k in keys}, "checked": True,
        "per_call_ms": agg["per_call_ms"],
        "pna_path_ms": side["pna"]["aggregate_snb_x10"]["pna_path_ms"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        **{k: attn[k] for k in keys}, "checked": True,
        "launches_by_route": attn["launches_by_route"],
        "fp32_route": attn["fp32"],
        "chunked_prefill_ms": side["llm"]["prefill_attention"]["ms"][
            "chunked"],
    }]
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
