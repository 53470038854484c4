#!/usr/bin/env python3
"""Drive the PyTorch port of GraVF-M on one NVIDIA card, and check it.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --kernels  # phases 1-4, 7-9, 12 and platform
    python3 chip_smoke.py --seed 3   # the service phases' roots and the
                                     # LM's weights and prompts (default 0)
    python3 chip_smoke.py --lm       # device, platform and lm_serve only
    python3 chip_smoke.py --train    # device, platform and train only
    python3 chip_smoke.py --shard    # device, platform and lm_shard only
    python3 chip_smoke.py --tenancy  # device, platform, build, host and
                                     # tenancy only
    python3 chip_smoke.py --examples # device, platform, build and
                                     # examples only

Phases, in order; any failure exits non-zero:
  1. device : the card's name, the device count, nvidia-smi's name and
              power limit. Without CUDA the script exits 2 at once.
     platform: the H100 profile's constants measured again (perfmodel.H100):
              the SM count, the SM clock nvidia-smi reports (clocks.max.sm,
              with clocks.sm sampled while the card streams), total
              memory, the median rate of a streaming read of 4 GiB
              (torch.sum, CUDA events) and the random-access granularity
              (that rate over the random int32 gathers a second of a 4 GiB
              table); each beside its constant, failing outside 0.5-2x.
  2. build  : nvcc builds every kernel of src/repro_torch/kernels/csrc;
              one line per entry: registers, spills, static shared memory
              (-Xptxas -v) and the dynamic shared memory of its launch.
  3. host   : graph500's R-MAT at scale 20 (edge factor 16, weighted,
              symmetrized), greedy 4-way partition, the engines' layouts.
  4. sweep  : the segment-combine kernel against its plain PyTorch version
              on the card: {add, min, max} x {float32, int32} over the
              shapes of tests/test_kernels.py, a layout with a window of
              ~530 tiles (cut into many work items) and the full-width
              layout, at B = 1, 3, 8 and 17 (below, at and above the 8
              queries a block folds together). Exact for min, max and
              int32 add; float32 add at rtol = atol = 1e-5, and at the
              full width (hub rows of 64k terms of both signs) within
              1e-5 of each row's sum of |value|.
  5. main   : the engine's entry points on the card (BFS run and an 8-root
              run_batch, WCC, PageRank 30, SSSP), with the kernel's launch
              count set to 0 just before and read just after; BFS checked
              by graph500's rules, every run against the port's
              backend="ref" engine on the same graph.
  6. profile: torch.profiler over one BFS, one WCC and one PageRank run:
              the busiest operators and the device's idle share.
     projection: each algorithm's cycles per edge fitted again from
              phase 6's device-busy time (perfmodel.h100_algo) beside the
              H100_ALGOS constant (0.5-2x); then for BFS run, the 8-root
              run_batch, WCC and PageRank (phase 5's walls) the measured
              TEPS, L_PE, L_mem and T_sys of perfmodel.limits on the H100
              profile at n_nodes=1, and the efficiency TEPS / T_sys.
  7. timing : CUDA-event times of the kernel at the main path's shapes,
              beside its plain version, one scatter_reduce_ call on the
              same data (the yardstick; the port never calls it on its
              kernel path) and the bytes bound at 3.35 TB/s and at the
              platform phase's measured stream rate; each row with its
              launches on phase 5's path and launches x (ms - bound_ms),
              the time they lose against the bound.
  8. shard host : build_shard_data on the same graph (4 shards): the
              stacked CSC lanes and the combined exchange's lanes.
  9. shard sweep: the stacked kernel (K2) against its plain version, as
              in phase 4, over small stacks (an empty shard, windows that
              own no tile, hub rows, a window cut into many work items)
              and the two full-width stacks, at phase 4's batch sizes.
 10. shard  : ShardEngine(mesh=LocalMesh(4, cuda)) for the five exchanges
              (allgather, ring, frontier, unicast, combined): BFS run, the
              8-root run_batch and SSSP in both schedules (overlap=False
              and True), WCC and PageRank 30 in the synchronous one, K2's
              launch count set to 0 just before and read just after, each
              run's launches = supersteps x its combines; unicast and
              combined PageRank must refuse overlap=True (ValueError);
              each run against the backend="ref" shard engine on the same
              exchange and against phase 5's one-device engine, BFS by
              graph500's rules; the wire words of each exchange (frontier
              beside allgather) and the average degree.
 11. shard profile: phase 6 for each exchange, and one overlapped
              combined BFS; the projection of each exchange's synchronous
              BFS, WCC and PageRank runs (phase 10's walls) on one card.
 18. shard stepper (runs after 11): make_stepper(8) for BFS over the
              combined and frontier exchanges and the overlapped combined
              schedule: 12 roots through 8 lanes, lanes admitted
              mid-flight, one parked and restored; run once to warm up,
              then with K2's count from 0: launches = supersteps x
              combines, traces flat, every lane equal to its solo run.
 12. shard timing: K2 at the two full-width stacks, as in phase 7, with
              the launches of phase 10's path and of phase 18's.
 13. service: GraphQueryService(max_batch=8) on the card over the same
              graph (published to its store, warmed for bfs and sssp);
              64 BFS and 8 SSSP roots drawn from --seed, K1's launch count
              set to 0 just before and read just after; every answer
              against phase 5's engine (states, supersteps, messages,
              comm), every BFS tree by graph500's rules, plan_traces flat
              after warm; qps and latency percentiles from
              stats_snapshot(), peak device memory.
 14. continuous: scheduling="continuous", slots=8, on the same engines
              (one plan cache): the 64 BFS roots, then a burst of 8
              priority-1 deadline queries that parks lanes; every answer
              against the engine, parks and restores above 0, plan_traces
              flat.
 15. spill : the store spills the graph (its engines offload to pinned
              host copies); a query dispatched while spilled still runs
              K1 on the card; the next query refaults (upload); the
              answers before, while and after are identical.
 16. gravf : Engine(mode="gravf") BFS from one root against phase 5's
              gravfm run; unicast over filtered-broadcast wire words
              beside the average degree; peak device memory.
 17. service profile: torch.profiler over one bucketed batch of 8 BFS and
              8 BFS through the continuous service: wall, device busy
              time, idle share, busiest kernels.
 19. shard service: the shard class exchange="combined" (four shards of
              the card) over phase 13's plan cache and requests: bucketed,
              continuous with phase 14's burst (parks and restores above
              0), bucketed with overlap toggled per request, then a spill
              with a dispatch while spilled (still K2 on the card) and the
              refault; K2's count from 0 before each; every answer against
              phase 5's engine, plan_traces flat after warm-up.
 20. shard service profile: torch.profiler over one bucketed batch of 8
              BFS through the shard class.
     tenancy: the multi-tenant, observed service at full size, in the
              shape of examples/multi_tenant.py (after the service
              projection):
              GraphQueryService(num_shards=4, max_batch=16, slots=16,
              continuous, backend="kernel", roofline_platform=H100) over
              three R-MAT graphs (tenant-a phase 3's, tenants b and c from
              seeds 1 and 2 at TENANCY_SCALE, built in a process of their
              own from the script's start) under a memory budget of 2.5
              partitions, weights 2 / 1 / 1, tenant-c capped at 50 qps,
              burst 5; the watchdog's thread throughout, tracing on. Two
              rounds of 16 BFS roots a tenant (--seed) and 8 priority-1
              SSSP roots for tenant-a, round 1 under torch.profiler; K1's
              count from 0 before and read after (> 0). Every BFS by
              graph500's rules, SSSP against backend="ref"; an eviction,
              a spill and a refault at least; tenant-c's sheds those of a
              replay of its token bucket over the clocks the registry
              read; every series the metrics twins assert present in the
              exposition; a retired span for every answered query; the
              watchdog's stall rule silent at the end (other alerts
              printed). Lines: answers, slot shares, sheds, the store's
              counters and refault upload ms, qps and p50/p99 a tenant,
              alerts, the idle share.
     examples: each example twin's main() (examples/torch_*.py), after
              tenancy: quickstart, graph_analytics,
              query_service and multi_tenant on the card and on the CPU
              with equal answers (multi_tenant: the queries both served;
              its rate-capped tenant's admissions replayed through its
              token bucket on each), K1's launches counted on the card;
              serve_lm on the card, every greedy token a near-argmax of
              the CPU's full forward; train_lm EXAMPLE_TRAIN_STEPS steps
              on the card, its first loss within TRAIN_EXAMPLE_ATOL of
              the CPU's forward from the same params and batch.
     service projection: one bucketed batch of 8 BFS through the
              one-device class and through the shard class, each with
              roofline_platform=perfmodel.H100 and with the default
              PAPER_PLATFORM: each class's gravfm_roofline_efficiency and
              projected TEPS; the H100 ones must be above 0.
     dryrun : repro_torch.launch.dryrun's graph cell (R-MAT scale 26,
              256 shards, WCC) for the five exchanges on the meta device:
              argument and created bytes per shard, collective bytes,
              words, teps_bound; the card's peak allocation must not move.
     lm_dryrun: repro_torch.launch.dryrun's LM cells on the (16, 16)
              mesh (a fake 256-rank group, meta tensors): qwen3-4b
              train_4k, deepseek-moe-16b and xlstm-350m decode_32k, each
              through the CLI in a process that sees no card; each cell's
              compute, memory and collective terms, bound, peak estimate
              and fit; the card's peak allocation must not move.
     lm_serve: the LM substrate's serving path (repro_torch.serve over
              repro_torch.models, no hand-written kernel). (a) Every
              config, reduced, on the card and on the CPU from the same
              bf16 weights (init_params, a CPU generator seeded by
              --seed): the decoder-only ones (dense, MoE, MLA, RG-LRU,
              xLSTM) through prefill, one decode and greedy_generate, the
              MoE ones with the share of the router's (token, expert)
              choices equal to the CPU's; seamless-m4t-medium through
              encode, fill_cross_cache and greedy decode; prefill and
              decode logits within tests/test_models.py's tolerance (atol
              0.75, rtol 0.1, top-1 >= 0.5), every greedy token within it
              of the top logit of the CPU's re-scoring, the card's tensors
              on cuda. (b) qwen3-4b at full width and depth (36 layers,
              4,022,468,096 bf16 params drawn on the card): batch 8,
              512-token prompts from --seed, max_len 576, prefill and 64
              greedy decode steps; the reference's prefill/decode
              consistency (decode at T against lm_forward at T) at its
              tolerance with the params in float32, and in bf16 top-1
              agreement and each path's distance to float32 logged;
              every logit finite, every token a near-argmax of the full
              forward's re-scoring, greedy_generate's tokens equal to the
              timed loop's; prefill wall and tokens/s against the FLOP
              bound at 989 TFLOP/s (bf16 dense, data sheet), decode
              ms/step (median of 64, CUDA events) and tokens/s against
              the bytes bound (weights + the whole KV cache the step
              reads) at the platform phase's stream rate, peak memory;
              the ported roofline() of the prefill and of a decode step
              (repro_torch.launch.roofline at the data sheet's rates and
              at the measured stream rate) beside the measured seconds.
              (c) One qwen3-4b prefill and decode step under
              torch.profiler. (d) deepseek-moe-16b at full width and
              depth (28 layers, 64 routed experts top-6 + 2 shared,
              16,879,568,896 bf16 params), as (b): the (token, expert)
              pairs its capacity dropped at prefill, counted from the
              router's choices; prefill against two FLOP bounds (the
              routed top-6 work, and the 64 x capacity buffers the
              reference computes); decode against every expert's weights
              + the KV; the consistency check in float32 over 4 of the 28
              layers (printed as a cut), bf16 decode at T against the
              bf16 forward held to MOE_BF16_*; a profile of each step.
              (e) The same at full width for recurrentgemma-9b (38
              layers), xlstm-350m (24) and deepseek-v2-236b (4 of 60
              layers, a cut; float32 check over 1), and seamless-m4t-
              medium (12 + 12 layers: 512 random frames encoded, the
              cross cache filled, 64 greedy steps from a start token; its
              check is teacher-forced decode against encdec_forward in
              float32); each model freed before the next.
     train  : the LM substrate's training path (repro_torch.train over
              repro_torch.models, no hand-written kernel). (a) Every
              config, reduced, one float32 train step on the card and on
              the CPU from the same params (--seed) and SyntheticTokens
              batch, grad_cast_bf16 as the identity on both: loss, grad
              norm and every gradient at the CPU tests' tolerance. (b)
              qwen3-4b at full width and depth (36 layers, 4,022,468,096
              bf16 params from --seed, remat on), batch 8 x 512
              SyntheticTokens, AdamW: a warm-up step, then TRAIN_STEPS
              timed steps (host wall ending in synchronize), each step's
              loss and grad norm finite, the last loss at most
              TRAIN_LOSS_RATIO of the first, the params moved; median step
              time, tokens/s, the share of the FLOP bound (4 x a
              full-logits prefill at 989 TFLOP/s) and the ported
              roofline() of the step beside it, peak memory; one step
              under torch.profiler; then microbatch=2 against the unsplit
              step from the same state (loss, grad norm). (c) At 2 of the
              36 layers (the disk's free space read first): the state
              after one step saved under build/ and restored onto the
              card bit for bit; a Trainer killed at step 2 resumes from
              its step-0 checkpoint and reaches the end. Each part's wall
              is logged.
     lm_shard: the LM substrate's sharding (repro_torch.sharding, the
              mesh= path, no hand-written kernel) on a world-1 NCCL
              process group and a (1, 1) ("data", "model") DeviceMesh,
              params DTensors placed by param_sharding_rules. (a) qwen3-4b
              training at full width and depth as the train phase's (b),
              SHARD_TRAIN_STEPS steps through make_train_step(mesh) and
              as many through mesh=None from the same --seed params and
              batches: the losses and grad norms equal, each run's step
              time, peak memory, and one profiled step of each (launches,
              idle share). (b) deepseek-moe-16b at full width and depth,
              batch 8, 512 + 64 tokens, through make_serve_fns(mesh) (the
              expert-parallel MoE branch) and mesh=None: the mesh's
              prefill logits and each decode step's (fed mesh=None's
              greedy tokens) against mesh=None's, held to LM_FAMILY_BF16,
              the mesh's argmax equal to mesh=None's greedy token at every
              position; decode ms/step of each, one decode step of each
              profiled. (b') deepseek-v2-236b (MLA, 4 of its 60 layers)
              and seamless-m4t-medium (encode, the cross cache, decode)
              served on the mesh and with mesh=None from the same params,
              the mesh's steps fed mesh=None's greedy tokens: every logit
              bit-equal. (c) The graph engine on launch/mesh.py's
              graph mesh (a ProcessGroupMesh over the NCCL group, one
              shard): one BFS per exchange through ShardEngine, equal to
              Engine's exactly, K2's count from 0 before and read after
              (the "lm_shard_graph" path; with one shard the ring folds
              without it). (d) Ranks that share the card:
              4 processes, NCCL and gloo, each collective DTensor needs
              on CUDA tensors, each result checked; what each backend
              served is logged, then the functional all-gather that
              DTensor's redistributes call and a DTensor all-gather on a
              (2, 2) mesh of the four; a process that crashes is logged
              with its exit code. No backend serves them all on one card
              (PERF.md §7), so no (2, 2) run follows.
Then one JSON line with both kernels' numbers (each with its launches
on every path, "paths"), the nvidia-smi line, and the result line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SCALE, EDGE_FACTOR, GRAPH_SEED, PARTS = 20, 16, 7, 4
TILE_E, TILE_R = 512, 256
BATCH = 8
TIMING_ITERS = 50
GRAPH_ID = f"rmat{SCALE}"
SERVICE_BFS, SERVICE_SSSP, SERVICE_BURST = 64, 8, 8
# The tenancy phase: tenants b and c are R-MAT graphs of this scale
# (tenant-a is the smoke's); cut to 19, then 18, only if the script's time
# limit forces it. Per round, 16 BFS roots a tenant and 8 priority-1 SSSP
# roots for tenant-a; a memory budget of 2.5 partitions; tenant-c's
# token bucket (rate_qps, burst).
TENANCY_SCALE = 20
TENANCY_BFS, TENANCY_SSSP, TENANCY_ROUNDS = 16, 8, 2
TENANCY_BUDGET = 2.5
TENANCY_RATE = (50.0, 5)
TENANT_GRAPHS_TIMEOUT = 600   # seconds to wait for tenants b and c
# The examples phase: the graph twins run on the card and on the CPU;
# train_lm's steps on the card, and its first loss's distance to the
# CPU's (tests/_train_reference.py's BF16_ATOL, the reduced configs').
EXAMPLE_GRAPHS = ("torch_quickstart", "torch_graph_analytics",
                  "torch_query_service", "torch_multi_tenant")
EXAMPLE_TRAIN_STEPS = 5
TRAIN_EXAMPLE_ATOL = 0.05
# Unlabelled series the port's metrics twins assert on a service
# (tests/test_torch_metrics.py), and the watchdog's gauge.
TENANCY_SERIES = ("gravfm_queries_completed_total",
                  "gravfm_trace_events_total", "gravfm_trace_dropped_total",
                  "gravfm_store_publishes_total",
                  "gravfm_store_resident_bytes",
                  "gravfm_store_evictions_total",
                  "gravfm_store_spills_total", "gravfm_store_faults_total",
                  "gravfm_tenant_shed_total", "gravfm_alerts_active")
TIMING_ROUNDS = 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
STREAM_BYTES = 4 << 30      # the platform phase's buffers: 80x the L2
GATHERS = 1 << 26           # random int32 gathers a timed call makes
PROFILE_RATIO = (0.5, 2.0)  # a measured constant against perfmodel.H100
PAGERANK_RTOL, PAGERANK_ATOL = 1e-4, 1e-9
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores (data sheet)
LM_ARCH = "qwen3-4b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
LM_MAX_LEN = LM_PROMPT + LM_NEW
# tests/test_models.py's prefill/decode tolerance for bf16 logits
LM_RTOL, LM_ATOL, LM_TOP1 = 0.1, 0.75, 0.5
LM_SMALL = (2, 12, 8)       # the reduced configs: batch, prompt, new tokens
LM_START_TOKEN = 1          # the enc-dec decoder's first token
# Reduced configs whose bf16 logits, card against CPU, may leave the
# tolerance: xlstm-350m's 16 layers of exponentially gated recurrence
# carry the two devices' last-bit differences past it, and mostly those
# of ops other than the bf16 products (1.07 % of its prefill logits and
# 5.27 % of one decode step's outside, max |diff| 2.5625, top-1 1.0; the
# same with cuBLAS's reduced-precision bf16 reduction off, 0.78 % /
# 5.08 % with every bf16 product in float32: lm_precision_probe.py,
# PERF.md). Each is checked whole in float32, and its bf16 logits held
# to 1.5x the larger share.
LM_SMALL_F32 = ("xlstm-350m",)
LM_SMALL_BF16_OUTSIDE = 0.08
# qwen3-4b's bf16 logits at T against a float32 run, at full width: the
# share outside the tolerance above, the mean and the max |diff|, each
# 1.5x the largest reading in PERF.md (4.95 %, 0.791, 5.25); and
# bf16 decode no farther from float32 than 1.5x the bf16 forward is.
LM_BF16_OUTSIDE, LM_BF16_MEAN, LM_BF16_MAX = 0.075, 1.2, 8.0
LM_BF16_DECODE_RATIO = 1.5
# deepseek-moe-16b at full width and depth; its float32 consistency check
# runs over the first 4 of its 28 layers (a float32 copy of all 28 is
# 67.5 GB, beside the 33.8 GB bf16 one)
LM_MOE_ARCH = "deepseek-moe-16b"
LM_MOE_CHECK_REPEATS = 4
# bf16 decode at T against the bf16 forward at T (for the enc-dec,
# teacher-forced decode against encdec_forward, every position) of each
# full-width family: the share outside the tolerance above, the mean and
# the max |diff|, each 1.5x its first reading (PERF.md, PR 18: 0 /
# 0.0441 / 0.590; 2.93e-6 / 0.169 / 2.0; 5.43 % / 0.735 / 4.98; 0 /
# 0.0236 / 0.352; 0.143 % / 0.289 / 2.25), and top-1 >= LM_TOP1
LM_FAMILY_BF16 = {
    "deepseek-moe-16b": (0.0, 0.066, 0.885),
    "recurrentgemma-9b": (4.4e-6, 0.254, 3.0),
    "xlstm-350m": (0.0815, 1.104, 7.47),
    "deepseek-v2-236b": (0.0, 0.0354, 0.528),
    "seamless-m4t-medium": (0.00215, 0.434, 3.375),
}
# float32 consistency: the share of logits that may lie outside the
# tolerance. The reference's conv buffer is bf16 in every model dtype, so
# xlstm-350m's decode reads bf16-rounded conv inputs that its forward
# reads in float32; at full width that puts 0.0507 % of its logits
# outside (max |diff| 1.79, top-1 1.0), and none with a float32 buffer
# (max 0.004: lm_precision_probe.py, PERF.md). Held to 1.5x that share.
LM_F32_OUTSIDE = {"xlstm-350m": 0.00076}
# each other family at full width: (arch, repeats served or None for all,
# repeats of the float32 check or None for all). deepseek-v2-236b is cut
# to 4 of its 60 layers (479 GB in bf16 whole), its float32 check to 1.
LM_FAMILIES = (("recurrentgemma-9b", None, None), ("xlstm-350m", None, None),
               ("deepseek-v2-236b", 4, 1))
# the prompt of a profiled prefill where it is not LM_PROMPT: xlstm-350m's
# eager time loop launches ~1,000 kernels a token (532,764 at 512 tokens,
# 13.1 s under the profiler), so its profile takes one 64-step chunk
LM_PROFILE_PROMPT = {"xlstm-350m": 64}
# the share of decode's first-layer cache entries more than one bf16 ulp
# from the forward's (the same bf16 inputs on both paths)
LM_CACHE_OUTSIDE = 0.01
# the train phase: qwen3-4b at full width and depth (remat on, as the full
# configs set it), bf16 params from --seed, AdamW from zero moments on
# SyntheticTokens batches; one warm-up step, then TRAIN_STEPS timed ones
TRAIN_ARCH = "qwen3-4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
# lr 5e-5 from step 1 (step 0 warms up at lr 0): with a peak of 1e-3 or
# 3e-4 the loss halved after the first update, then rose again (PERF.md,
# the training cell)
TRAIN_OPT = dict(lr_peak=5e-5, warmup_steps=1, total_steps=1000)
# the last timed step's loss over the first's: at most 1.5x the ratio
# read on the card (PERF.md: 0.534, 419.2 -> 224.0)
TRAIN_LOSS_RATIO = 0.8
TRAIN_SMALL = (4, 16)       # the reduced configs' batch and sequence
# the reduced configs' float32 step, card against CPU, at the CPU tests'
# tolerance (tests/_train_reference.py): rtol = atol = 1e-4, xlstm-350m's
# atol 1.5e-3 (its recurrence amplifies float32 rounding: 7.9e-4 card
# against CPU, 8.4e-4 against the JAX package); both sides with
# grad_cast_bf16 as the identity (its bf16 rounding turns last-bit
# differences into bf16-ulp ones: ROADMAP §3)
TRAIN_F32 = dict(rtol=1e-4, atol=1e-4)
TRAIN_F32_LOOSE = {"xlstm-350m": dict(rtol=1e-4, atol=1.5e-3)}
# microbatch=2 against the unsplit step from the same state: the loss
# within the reference's bf16 tolerance (tests/test_train.py:97-103), the
# grad norm within 1 % (the split accumulates in float32, the unsplit
# step's gradients are bf16)
TRAIN_MB, TRAIN_MB_LOSS_ATOL, TRAIN_MB_GNORM_RTOL = 2, 0.05, 0.01
# the checkpoint round trip on the card: the first TRAIN_CKPT_REPEATS of
# the 36 layers at full width (the whole state is 48 GB)
TRAIN_CKPT_REPEATS = 2
# the lm_shard phase: a world-1 NCCL group and a (1, 1) mesh
SHARD_MESH = ((1, 1), ("data", "model"))
# the mixers served on it beside deepseek-moe-16b, each held bit-equal to
# mesh=None: (arch, repeats served or None for all)
SHARD_FAMILIES = (("deepseek-v2-236b", 4), ("seamless-m4t-medium", None))
# the lm_dryrun phase: cells of repro_torch.launch.dryrun on the (16, 16)
# mesh (a fake 256-rank group, meta tensors), each through the CLI in a
# process of its own that sees no card
DRYRUN_CELLS = (("qwen3-4b", "train_4k"), ("deepseek-moe-16b", "decode_32k"),
                ("xlstm-350m", "decode_32k"))
DRYRUN_TIMEOUT = 300         # seconds a cell's process may take
SHARD_TRAIN_STEPS = 3
SHARD_GRAPH_SCALE = 16       # the graph mesh's R-MAT (one shard)
SHARD_PROBE_RANKS = 4
SHARD_PROBE_TIMEOUT = 90     # seconds a probe process may take
KERNEL = {
    "name": "segment_combine",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/segment_combine.cu",
    "replaces": "src/repro/kernels/edge_gather.py:99",
}
KERNEL2 = {
    "name": "segment_combine_windows",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/segment_combine.cu",
    "replaces": "src/repro/kernels/edge_gather.py:136",
}
EXCHANGES = ("allgather", "ring", "frontier", "unicast", "combined")
SCHEDULES = (False, True)   # overlap=False, overlap=True
STEPPER_ROOTS = 12
# Small stacks for K2's sweep: (edges of each shard, segments, tile_e,
# tile_r): an empty shard, windows that own no tile, hub rows.
# The last stack and the last shape put ~17,000 lanes of 32 in one window:
# ~530 tiles, so the window is cut into many work items.
SWEEP_STACKS = [((300, 0, 45, 1), 130, 32, 16),
                ((0, 500, 30, 2000), 2000, 64, 32),
                ((4096, 700, 0, 64), 64, 256, 256),
                ((20000, 0, 3000, 64), 300, 32, 256)]
SWEEP_SHAPES = [(0, 16, 32, 16), (1, 1, 32, 16), (500, 64, 64, 32),
                (500, 2000, 64, 32), (777, 130, 128, 64),
                (2048, 64, 256, 256), (20000, 300, 32, 256)]
# Batch sizes of the sweeps: one query, a batch below QB (the queries a
# block folds together, at most 8), the main path's batch, and one that
# leaves a ragged last chunk.
SWEEP_BATCHES = (1, 3, BATCH, 17)
COMBINERS = ("add", "min", "max")
# The main path's key combines: (combiner, dtype name, who calls it).
TIMED = [("min", "int32", "BFS/WCC key, SSSP carry"),
         ("min", "float32", "SSSP key"),
         ("add", "float32", "PageRank")]
# The shard path's K2 combines: the allgather exchange's receiver folds
# (as K1's) and the combined exchange's source folds, which add the
# send_act max to each superstep.
TIMED_STACKED = {"csc": TIMED,
                 "combined": TIMED + [("max", "int32", "send_act")]}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi(fields: str, units: bool = True) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader" + ("" if units else ",nounits")],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


def against(tag: str, measured: float, constant: float) -> float:
    """Log a measured constant beside perfmodel's; raise outside
    PROFILE_RATIO (a wrong unit or another card, not drift)."""
    ratio = measured / constant
    log("platform", constant=tag, measured=measured, perfmodel=constant,
        ratio=round(ratio, 4))
    lo, hi = PROFILE_RATIO
    if not lo <= ratio <= hi:
        raise AssertionError(f"{tag}: measured {measured} is {ratio:.3f}x "
                             f"perfmodel's {constant}")
    return ratio


def phase_platform(torch) -> float:
    """Measure the H100 profile's constants again and hold each against
    perfmodel.H100; returns the measured stream rate (bytes/s)."""
    from repro_torch.core import perfmodel
    H = perfmodel.H100
    props = torch.cuda.get_device_properties(0)
    x = torch.ones(STREAM_BYTES // 4, dtype=torch.float32, device="cuda")
    read_ms = event_ms(torch, lambda: x.sum(), 10)
    # the clocks while the card streams: ~0.3 s of reads queued first
    for _ in range(200):
        x.sum()
    clocks = nvidia_smi("clocks.sm,clocks.max.sm,clocks.mem,clocks.max.mem",
                        units=False).split(", ")
    torch.cuda.synchronize()
    y = torch.empty_like(x)
    copy_ms = event_ms(torch, lambda: y.copy_(x), 10)
    del x, y
    table = torch.arange(STREAM_BYTES // 4, dtype=torch.int32,
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, table.numel(), (GATHERS,), generator=gen,
                        device="cuda")
    if not torch.equal(table.index_select(0, idx), idx.to(torch.int32)):
        raise AssertionError("the gather read wrong values")
    gather_ms = event_ms(torch, lambda: table.index_select(0, idx), 10)
    del table, idx
    torch.cuda.empty_cache()
    bw = STREAM_BYTES / (read_ms / 1e3)
    gathers_per_s = GATHERS / (gather_ms / 1e3)
    sm, sm_max, mem, mem_max = (float(c) for c in clocks)
    log("platform", stream_bytes=STREAM_BYTES, read_ms=read_ms,
        read_bytes_per_s=bw, copy_ms=copy_ms,
        copy_bytes_per_s=2 * STREAM_BYTES / (copy_ms / 1e3),
        gathers=GATHERS, gather_ms=gather_ms, gathers_per_s=gathers_per_s,
        clocks_sm_mhz=sm, clocks_max_sm_mhz=sm_max, clocks_mem_mhz=mem,
        clocks_max_mem_mhz=mem_max, sms=props.multi_processor_count,
        total_memory=props.total_memory)
    against("n_pe_max (SMs)", props.multi_processor_count, H.n_pe_max)
    against("f_clk (clocks.max.sm, Hz)", sm_max * 1e6, H.f_clk)
    against("bw_mem (stream read, B/s)", bw, H.bw_mem)
    against("m_memword (bw_mem / gathers a second, B)",
            bw / gathers_per_s, H.m_memword)
    against("m_board (total_memory, B)", props.total_memory, H.m_board)
    return bw


def event_ms(torch, fn, iters: int, warmup: int = 3,
             rounds: int = TIMING_ROUNDS) -> float:
    """Milliseconds of one ``fn``: the median over ``rounds`` of the mean
    over ``iters`` launches (CUDA events), so one stalled round does not
    move the number."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return float(np.median(means))


def bound_ms(layout, batch: int, rate: float = HBM_BYTES_PER_S) -> float:
    """Least time for the combine: the bytes it must move (rel and
    tile_start read once, vals once per query, the output written once
    per query) over the card's memory rate. One fold per lane per query
    at float32's 67 TFLOP/s is three orders of magnitude less."""
    lanes = layout.rel.numel()
    nbytes = 4 * (lanes + layout.tile_start.numel()
                  + batch * (lanes + layout.num_segments))
    return nbytes / rate * 1e3


def bound_ms_stacked(layout, batch: int,
                     rate: float = HBM_BYTES_PER_S) -> float:
    """K2's least time: ``bound_ms`` over the lanes the shards own (the
    tiles a shorter shard is padded with are never read)."""
    lanes = int(layout.tile_start[:, -1].sum()) * layout.tile_e
    rows = layout.rel.shape[0] * layout.num_segments
    nbytes = 4 * (lanes + layout.tile_start.numel() + batch * (lanes + rows))
    return nbytes / rate * 1e3


def lane_values(torch, layout, combiner, dtype, batch, gen):
    """Random (batch, *rel.shape) values with the identity in padding
    lanes."""
    from repro_torch.kernels.ref import identity_for
    shape = (batch,) + tuple(layout.rel.shape)
    device = layout.rel.device
    if dtype == torch.float32:
        vals = torch.randn(shape, generator=gen, device=device)
    else:
        vals = torch.randint(-1000, 1000, shape, generator=gen,
                             device=device, dtype=torch.int32)
    return torch.where(layout.rel == layout.tile_r,
                       identity_for(combiner, dtype), vals)


def plain(layout, vals, combiner):
    from repro_torch.kernels.edge_gather import segment_combine_plain
    return segment_combine_plain(layout.window_id, layout.rel, vals,
                                 combiner=combiner, tile_e=layout.tile_e,
                                 tile_r=layout.tile_r,
                                 num_segments=layout.num_segments)


def plain_stacked(layout, vals, combiner):
    from repro_torch.kernels.edge_gather import segment_combine_windows_plain
    return segment_combine_windows_plain(
        layout.tile_start, layout.rel, vals, combiner=combiner,
        tile_e=layout.tile_e, tile_r=layout.tile_r,
        num_segments=layout.num_segments)


def compare(torch, got, want, combiner, mass=None) -> float:
    """Max |kernel - plain| (0 where both hold the same value, infinities
    included); raises beyond the tolerance. float32 add: rtol = atol =
    1e-5, or, where ``mass`` (the rows' sums of |value|) is given,
    1e-5 * mass + 1e-5: two orders of summing tens of thousands of terms
    of both signs differ by the rounding of the terms, not of the sum."""
    if combiner == "add" and got.dtype == torch.float32:
        if mass is None:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        elif not bool(((got - want).abs() <= 1e-5 * mass + 1e-5).all()):
            raise AssertionError("float32 add beyond 1e-5 of the rows' "
                                 "absolute mass")
    elif not torch.equal(got, want):
        raise AssertionError(f"{combiner}/{got.dtype}: "
                             f"{int((got != want).sum())} rows differ")
    if not got.numel():
        return 0.0
    diff = (got.double() - want.double()).abs()
    return float(torch.where(got == want, 0.0, diff).max())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

ENTRY_DTYPE = {"f": "float32", "i": "int32"}


def entry_label(mangled: str) -> str:
    """``segment_combine_kernel<T, OP, QB>``'s template arguments, from its
    mangled name, as "int32 min QB=8"; other names as they are."""
    m = re.search(r"kernelI([fi])Li(\d)ELi(\d+)E", mangled)
    if not m:
        return mangled
    return (f"{ENTRY_DTYPE[m.group(1)]} {COMBINERS[int(m.group(2))]} "
            f"QB={m.group(3)}")


def phase_build() -> None:
    """Build every kernel; one line per entry with its registers, spills,
    static shared memory and the dynamic shared memory a launch at
    tile_r = TILE_R gives it (its QB x tile_r accumulators)."""
    from repro_torch.kernels import _build, edge_gather
    t0 = time.perf_counter()
    libs = _build.build_all()
    smem = edge_gather._kernel()[1]
    for name in libs:
        entry, spills = "?", "?"
        for line in _build.log_of(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spills = line.strip()
            elif "Used" in line and "registers" in line:
                label = entry_label(entry)
                regs = re.search(r"Used (\d+) registers", line).group(1)
                static = re.search(r"(\d+) bytes smem", line)
                qb = re.search(r"QB=(\d+)", label)
                log("build", library=name, entry=repr(label), registers=regs,
                    static_smem_bytes=static.group(1) if static else 0,
                    dynamic_smem_bytes=(smem(int(qb.group(1)), TILE_R)
                                        if qb else "-"),
                    spills=repr(spills))
    log("build", libraries=len(libs),
        seconds=round(time.perf_counter() - t0, 3))


def phase_host():
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    t0 = time.perf_counter()
    g = G.rmat(SCALE, EDGE_FACTOR, seed=GRAPH_SEED,
               weighted=True).symmetrized()
    t1 = time.perf_counter()
    pg = PT.partition_graph(g, PARTS, method="greedy")
    t2 = time.perf_counter()
    log("host", graph=f"rmat{SCALE}-ef{EDGE_FACTOR}-sym",
        vertices=g.num_vertices, edges=g.num_edges, parts=PARTS,
        v_max=pg.v_max, e_in_max=pg.e_in_max,
        graph_s=round(t1 - t0, 3), partition_s=round(t2 - t1, 3))
    return g, pg


def phase_sweep(torch, full_layout, device) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.layout import build_layout
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    layouts = []
    for n_edges, n_seg, tile_e, tile_r in SWEEP_SHAPES:
        seg = np.sort(rng.integers(0, n_seg, size=n_edges))
        layouts.append(build_layout(seg, n_seg, tile_e=tile_e,
                                    tile_r=tile_r).to(device))
    layouts.append(full_layout)
    max_err, checks = 0.0, 0
    for layout in layouts:
        for combiner in COMBINERS:
            for dtype in (torch.float32, torch.int32):
                for batch in SWEEP_BATCHES:
                    vals = lane_values(torch, layout, combiner, dtype,
                                       batch, gen)
                    if batch == 1:
                        vals = vals[0]
                    got = ops.segment_combine_layout(vals, layout, combiner)
                    torch.cuda.synchronize()
                    want = plain(layout, vals, combiner)
                    mass = None
                    if layout is full_layout and combiner == "add":
                        mass = plain(layout, vals.abs(), "add")
                    torch.cuda.synchronize()
                    max_err = max(max_err, compare(torch, got, want,
                                                   combiner, mass))
                    checks += 1
    log("sweep", checks=checks, max_abs_err=max_err,
        full_width_lanes=full_layout.rel.numel(),
        full_width_windows=full_layout.tile_start.numel() - 1)
    return max_err


def validate_bfs(torch, g, parent, root: int, supersteps: int,
                 messages: int, device) -> int:
    """graph500's BFS checks, on the card: the root is its own parent;
    unreached vertices have parent -1; every other parent edge is an edge
    of the graph; the parent pointers form a tree rooted at ``root``
    (pointer jumping reaches the root), so parent level = level - 1;
    every edge joins vertices whose levels differ by at most one, or two
    unreached ones. Also: supersteps = depth + 1 and messages = edges out
    of reached vertices. Returns the depth."""
    V = g.num_vertices
    par = torch.as_tensor(parent, device=device, dtype=torch.int64)
    src = torch.as_tensor(g.src, device=device, dtype=torch.int64)
    dst = torch.as_tensor(g.dst, device=device, dtype=torch.int64)
    if int(par[root]) != root:
        raise AssertionError("root is not its own parent")
    if bool(((par < -1) | (par >= V)).any()):
        raise AssertionError("parent out of range")
    reached = par >= 0
    ids = torch.arange(V, device=device)
    child = reached & (ids != root)
    keys = torch.sort(src * V + dst).values
    want = par[child] * V + ids[child]
    pos = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
    if not bool((keys[pos] == want).all()):
        raise AssertionError("a parent edge is not an edge of the graph")
    anc = torch.where(reached, par, ids)
    depth = child.to(torch.int64)
    for _ in range(max(1, V.bit_length()) + 1):
        depth = depth + depth[anc]
        anc = anc[anc]
    if not bool((anc[reached] == root).all()):
        raise AssertionError("parent pointers do not form a tree at root")
    if not bool((depth[par[child]] == depth[child] - 1).all()):
        raise AssertionError("parent level != level - 1")
    if not bool((reached[src] == reached[dst]).all()):
        raise AssertionError("an edge leaves the reached component")
    both = reached[src]
    if not bool(((depth[src] - depth[dst]).abs()[both] <= 1).all()):
        raise AssertionError("an edge spans more than one level")
    level_max = int(depth[reached].max())
    if supersteps != level_max + 1:
        raise AssertionError(f"supersteps {supersteps} != depth "
                             f"{level_max} + 1")
    if messages != int(both.sum()):
        raise AssertionError("messages != edges out of reached vertices")
    return level_max


def dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def combines_of(kernel, exchange: str = "allgather", overlap: bool = False):
    """The (combiner, dtype) of each kernel launch a superstep makes: the
    key, `got` unless the kernel derives it from the identity, and the
    carry (allgather, frontier and the one-device engine); the combined
    exchange also folds send_act (int32 max) at the source, except an
    overlapped schedule whose kernel derives `got` from the identity.
    The ring and unicast fold with the oracle and launch none."""
    if exchange in ("ring", "unicast"):
        return []
    calls = [(kernel.combiner, dtype_name(kernel.msg_dtype))]
    if exchange == "combined" and not overlap:
        calls.append(("max", "int32"))
    elif not kernel.got_from_identity:
        calls.append(("max", "int32"))
    if kernel.carry_dtype is not None:
        calls.append(("min", dtype_name(kernel.carry_dtype)))
    return calls


def row_launches(runs):
    """Launches a timing row stands for on the main path: ``runs`` holds
    (combines, batch, supersteps) of each run; a row is (combiner, dtype,
    batch), a run's batch is 1 for `run` and 8 for `run_batch`."""
    counts = {}
    for calls, batch, steps in runs:
        for combiner, dname in calls:
            key = (combiner, dname, min(batch, BATCH))
            counts[key] = counts.get(key, 0) + steps
    return counts


def same_result(got, want, name: str) -> None:
    if (got.supersteps, got.messages, got.comm) != (
            want.supersteps, want.messages, want.comm):
        raise AssertionError(
            f"{name}: kernel engine supersteps/messages/comm "
            f"{got.supersteps}/{got.messages}/{got.comm} != ref "
            f"{want.supersteps}/{want.messages}/{want.comm}")
    for k in want.state:
        if name == "pagerank" and k == "score":
            np.testing.assert_allclose(got.state[k], want.state[k],
                                       rtol=PAGERANK_RTOL,
                                       atol=PAGERANK_ATOL)
        elif not np.array_equal(got.state[k], want.state[k]):
            raise AssertionError(f"{name}: state[{k!r}] differs from ref")


def phase_main(torch, g, pg, kernel_engine, ref_engine, roots):
    """Run the main path through the kernel engine with the launch count
    from 0; check each run; return the launch count of the whole path,
    the runs, the launches of each timing row (``row_launches``) and
    each run's (algorithm, entry, messages, wall seconds)."""
    from repro_torch.kernels import edge_gather
    runs = [
        ("bfs", "run", {"root": int(roots[0])}),
        ("bfs", "run_batch", {"root": roots}),
        ("wcc", "run", {}),
        ("pagerank", "run", {}),
        ("sssp", "run", {"root": int(roots[0])}),
    ]
    results, counted, walls = [], [], []
    kernel_engine("bfs").run(root=int(roots[0]))  # warm-up, untimed
    torch.cuda.synchronize()
    edge_gather.launches = 0
    for name, entry, kwargs in runs:
        eng = kernel_engine(name)
        calls = combines_of(eng.kernel)
        before = edge_gather.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = getattr(eng, entry)(**kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = edge_gather.launches - before
        outs = out if isinstance(out, list) else [out]
        steps = max(r.supersteps for r in outs)
        messages = sum(r.messages for r in outs)
        log("main", algorithm=name, entry=entry, queries=len(outs),
            supersteps=steps, messages=messages,
            wire_words=sum(r.comm["wire_words"] for r in outs),
            wall_s=round(wall, 6), teps=round(messages / wall),
            launches=launched,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        if launched != steps * len(calls):
            raise AssertionError(f"{name} {entry}: {launched} launches for "
                                 f"{steps} supersteps x {calls}")
        results.append((name, entry, kwargs, outs))
        counted.append((calls, len(outs), steps))
        walls.append((name, entry, messages, wall))
    total = edge_gather.launches
    log("main", launches_total=total)
    rows = row_launches(counted)

    for name, entry, kwargs, outs in results:
        want = getattr(ref_engine(name), entry)(**kwargs)
        want = want if isinstance(want, list) else [want]
        for got, ref in zip(outs, want):
            same_result(got, ref, name)
        if name == "bfs":
            for r, res in zip(np.atleast_1d(kwargs["root"]), outs):
                depth = validate_bfs(torch, g, res.state["parent"], int(r),
                                     res.supersteps, res.messages,
                                     kernel_engine(name).device)
                log("check", algorithm="bfs", entry=entry, root=int(r),
                    graph500="ok", depth=depth)
        log("check", algorithm=name, entry=entry, versus_ref="ok")
    return total, results, rows, walls


def with_launches(rec, rows) -> dict:
    """A timing row with its launches on the main path and the time they
    lose against the bound, launches x (ms - bound_ms)."""
    n = None if rows is None else rows.get(
        (rec["combiner"], rec["dtype"], rec["batch"]), 0)
    rec["launches"] = n
    rec["loss_ms"] = None if n is None else n * (rec["ms"] - rec["bound_ms"])
    return rec


def phase_timing(torch, layout, device, rate: float, rows=None):
    """Kernel, plain-version and scatter_reduce_ times at the main path's
    full-width layout, for the main path's key combines, with each row's
    launches on the main path (``rows``, from phase 5) and its bound at
    the measured stream ``rate`` too."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import REDUCE, identity_for
    gen = torch.Generator(device=device).manual_seed(1)
    row_of = (layout.window_id.to(torch.int64).repeat_interleave(
        layout.tile_e) * layout.tile_r + layout.rel)
    row_of = torch.where(layout.rel < layout.tile_r, row_of,
                         layout.num_segments).clamp(max=layout.num_segments)
    dtypes = {"float32": torch.float32, "int32": torch.int32}
    records = []
    for combiner, dname, used_by in TIMED:
        dtype = dtypes[dname]
        for batch in (1, BATCH):
            vals = lane_values(torch, layout, combiner, dtype, batch, gen)
            index = row_of.expand(vals.shape)
            out = torch.full((batch, layout.num_segments + 1),
                             identity_for(combiner, dtype), dtype=dtype,
                             device=device)
            ms = event_ms(torch, lambda: ops.segment_combine_layout(
                vals, layout, combiner), TIMING_ITERS)
            plain_ms = event_ms(torch, lambda: plain(layout, vals, combiner),
                                10)
            library_ms = event_ms(torch, lambda: out.scatter_reduce_(
                1, index, vals, REDUCE[combiner], include_self=True),
                TIMING_ITERS)
            rec = {"combiner": combiner, "dtype": dname, "batch": batch,
                   "used_by": used_by, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms(layout, batch),
                   "library_ms": library_ms}
            rec["bound_share"] = rec["bound_ms"] / ms
            rec["bound_ms_measured"] = bound_ms(layout, batch, rate)
            rec["bound_share_measured"] = rec["bound_ms_measured"] / ms
            with_launches(rec, rows)
            log("timing", **{k: v for k, v in rec.items() if k != "used_by"})
            records.append(rec)
            del vals, index, out
    return records


def window_spread(tag: str, tile_start) -> None:
    """Tiles a (shard, window) owns, over a layout's windows: the spread
    the work list's cut is chosen from."""
    tiles = np.diff(tile_start.cpu().numpy().reshape(-1, tile_start.shape[-1]),
                    axis=1).ravel()
    p50, p90, p99 = np.percentile(tiles, [50, 90, 99])
    log("layout", layout=tag, windows=tiles.size, tiles=int(tiles.sum()),
        empty=int((tiles == 0).sum()), p50=p50, p90=p90, p99=p99,
        max=int(tiles.max()))


def drive(torch, device, rate: float, full: bool = True, seed: int = 0,
          graph_proc=None):
    """Phases 3-20 and the service projection (``full=False``: only the
    host, sweep and timing phases); ``rate`` is the platform phase's
    measured stream rate. Returns the kernels' records for the JSON
    line."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.engine import Engine

    g, pg = phase_host()

    kernel_engines, ref_engines = {}, {}

    def engine(cache, backend):
        def get(name):
            if name not in cache:
                t0 = time.perf_counter()
                cache[name] = Engine(ALG.ALGORITHMS[name](), pg,
                                     backend=backend, tile_e=TILE_E,
                                     tile_r=TILE_R, device=device)
                log("host", engine=name, backend=backend,
                    build_s=round(time.perf_counter() - t0, 3),
                    device_nbytes=cache[name].device_nbytes)
            return cache[name]
        return get

    kernel_engine = engine(kernel_engines, "kernel")
    ref_engine = engine(ref_engines, "ref")
    layout = kernel_engine("bfs")._data.layout
    window_spread("engine", layout.tile_start)

    max_err = phase_sweep(torch, layout, device)

    deg = g.out_degrees()
    rng = np.random.default_rng(GRAPH_SEED)
    roots = rng.choice(np.flatnonzero(deg > 0), size=BATCH, replace=False)
    launches, engine_runs, rows = None, [], None
    if full:
        launches, engine_runs, rows, walls = phase_main(
            torch, g, pg, kernel_engine, ref_engine, roots)
        fitted_cpe(phase_profile(torch, kernel_engine, int(roots[0])))
        project(g, walls)
    records = phase_timing(torch, layout, device, rate, rows)
    # the service phases hold their answers against the bfs and sssp
    # engines; the rest go now
    for name in set(kernel_engines) - {"bfs", "sssp"}:
        del kernel_engines[name]
    ref_engines.clear()
    del layout
    gc.collect()  # an engine and its superstep program form a cycle
    head = records[0]  # int32 min at B=1: the BFS/WCC key combine
    k1 = {**KERNEL, "launches": launches, "max_abs_err": max_err,
          "ms": head["ms"], "plain_ms": head["plain_ms"],
          "bound_ms": head["bound_ms"], "bound_by": "bytes",
          "library_ms": head["library_ms"], "variants": records}
    k2 = drive_shard(torch, device, g, pg, roots, engine_runs, rate, full)
    if full:
        # K1's launches on each path, each counted from 0 (``launches``
        # stays the main path's), and the service paths' by timing row
        paths, rows, paths2, rows2 = drive_service(
            torch, device, g, pg, kernel_engine, seed)
        k1["paths"] = {"main": launches, **paths}
        for rec in records:
            rec["service_launches"] = rows.get(
                (rec["combiner"], rec["dtype"], rec["batch"]), 0)
        k2["paths"].update(paths2)
        k1["paths"]["tenancy"] = phase_tenancy(torch, device, g, pg, seed,
                                               graph_proc)
        for rec in k2["variants"]:
            rec["service_launches"] = rows2.get(rec["stack"], {}).get(
                (rec["combiner"], rec["dtype"], rec["batch"]), 0)
    kernel_engines.clear()
    gc.collect()
    return [k1, k2]


def drive_shard(torch, device, g, pg, roots, engine_runs, rate, full=True):
    """Phases 8-12 and 18. Returns K2's record for the JSON line."""
    from repro_torch.core.engine_shardmap import build_shard_data
    t0 = time.perf_counter()
    data = build_shard_data(pg, tile_e=TILE_E, tile_r=TILE_R)
    meta = data[1]
    log("shard_host", build_shard_data_s=round(time.perf_counter() - t0, 3),
        n_tiles=meta.n_tiles, n_windows=meta.n_windows,
        comb_max=meta.comb_max, comb_tiles=meta.comb_tiles,
        comb_windows=meta.comb_windows, e_pair_max=meta.e_pair_max)
    engine = shard_engines(torch, device, pg, data)
    stacks = {"csc": engine("allgather", "bfs", "kernel")._data.csc,
              "combined": engine("combined", "bfs", "kernel")._data.comb}
    for name, stack in stacks.items():
        window_spread(name, stack.tile_start)
    max_err = phase_sweep_stacked(torch, stacks, device)
    launches, rows, paths = None, None, {}
    if full:
        launches, rows, walls = phase_shard(torch, device, g, engine, roots,
                                            engine_runs)
        for exchange in EXCHANGES:
            phase_profile(torch,
                          lambda name: engine(exchange, name, "kernel"),
                          int(roots[0]), exchange=exchange)
            project(g, [w[1:] for w in walls if w[0] == exchange],
                    exchange=exchange)
        eng = engine("combined", "bfs", "kernel")
        profiled(torch, lambda: eng.run(root=int(roots[0]), overlap=True),
                 exchange="combined", overlap=True, algorithm="bfs")
        rng = np.random.default_rng(GRAPH_SEED + 1)
        stepper_roots = rng.choice(np.flatnonzero(g.out_degrees() > 0),
                                   size=STEPPER_ROOTS, replace=False)
        stepped, stepper_rows = phase_shard_stepper(torch, engine,
                                                    stepper_roots)
        paths = {"shard": launches, "shard_stepper": stepped}
    records = phase_timing_stacked(torch, stacks, device, rate, rows)
    for rec in records:
        rec["stepper_launches"] = None if not paths else stepper_rows[
            rec["stack"]].get((rec["combiner"], rec["dtype"], rec["batch"]),
                              0)
    head = records[0]  # CSC int32 min at B=1: allgather's BFS/WCC key
    return {**KERNEL2, "launches": launches, "max_abs_err": max_err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"], "paths": paths,
            "variants": records}


def shard_engines(torch, device, pg, data):
    """engine(exchange, algorithm, backend): a ShardEngine on all four
    shards of the card, over the one host build ``data``; the last one
    built of each (exchange, backend) is kept."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.engine_shardmap import ShardEngine
    from repro_torch.core.mesh import LocalMesh
    mesh = LocalMesh(PARTS, device)
    kept = {}

    def engine(exchange, name, backend):
        key = (exchange, backend)
        if key in kept and kept[key].kernel.name == name:
            return kept[key]
        if kept.pop(key, None) is not None:
            gc.collect()  # an engine and its superstep program form a cycle
        t0 = time.perf_counter()
        eng = ShardEngine(ALG.ALGORITHMS[name](), pg, mesh=mesh,
                          exchange=exchange, backend=backend, tile_e=TILE_E,
                          tile_r=TILE_R, shard_data=data)
        log("shard_host", exchange=exchange, engine=name, backend=backend,
            build_s=round(time.perf_counter() - t0, 3),
            device_nbytes=eng.device_nbytes)
        kept[key] = eng
        return eng
    return engine


def phase_sweep_stacked(torch, full_stacks, device) -> float:
    """K2 against its plain version on the card; phase 4's tolerances."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.layout import (build_layout, stack_layouts,
                                            stacked_layout)
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(2)
    stacks = []
    for sizes, n_seg, tile_e, tile_r in SWEEP_STACKS:
        st, _, _ = stack_layouts([build_layout(
            np.sort(rng.integers(0, n_seg + 1, size=n)), n_seg,
            tile_e=tile_e, tile_r=tile_r) for n in sizes])
        stacks.append(stacked_layout(
            torch.as_tensor(st["tile_start"], device=device),
            torch.as_tensor(st["rel"], device=device), tile_e, tile_r,
            n_seg))
    stacks += list(full_stacks.values())
    max_err, checks = 0.0, 0
    for layout in stacks:
        full = any(layout is f for f in full_stacks.values())
        for combiner in COMBINERS:
            for dtype in (torch.float32, torch.int32):
                for batch in SWEEP_BATCHES:
                    vals = lane_values(torch, layout, combiner, dtype,
                                       batch, gen)
                    if batch == 1:
                        vals = vals[0]
                    got = ops.segment_combine_stacked(vals, layout, combiner)
                    torch.cuda.synchronize()
                    want = plain_stacked(layout, vals, combiner)
                    mass = None
                    if full and combiner == "add":
                        mass = plain_stacked(layout, vals.abs(), "add")
                    torch.cuda.synchronize()
                    max_err = max(max_err, compare(torch, got, want,
                                                   combiner, mass))
                    checks += 1
                    del vals, got, want, mass
    log("shard_sweep", checks=checks, max_abs_err=max_err,
        **{f"{k}_lanes": tuple(v.rel.shape) for k, v in full_stacks.items()},
        **{f"{k}_windows": v.tile_start.shape[1] - 1
           for k, v in full_stacks.items()})
    return max_err


def same_as_engine(got, want, name: str) -> None:
    """A shard-engine run against the one-device engine's: states,
    supersteps and messages (a per-query state leaf is held once per shard
    by the shard engine)."""
    if (got.supersteps, got.messages) != (want.supersteps, want.messages):
        raise AssertionError(f"{name}: shard engine supersteps/messages "
                             f"{got.supersteps}/{got.messages} != engine "
                             f"{want.supersteps}/{want.messages}")
    for k, v in want.state.items():
        v = np.broadcast_to(v, got.state[k].shape)
        if name == "pagerank" and k == "score":
            np.testing.assert_allclose(got.state[k], v, rtol=PAGERANK_RTOL,
                                       atol=PAGERANK_ATOL)
        elif not np.array_equal(got.state[k], v):
            raise AssertionError(f"{name}: state[{k!r}] differs from the "
                                 "one-device engine")


def phase_shard(torch, device, g, engine, roots, engine_runs) -> int:
    """The shard path: every exchange's runs through the kernel shard
    engine in both schedules (BFS run and run_batch and SSSP overlapped,
    WCC and PageRank synchronous only; unicast/combined PageRank must
    refuse overlap=True), with K2's launch count from 0; then each run
    against the backend="ref" shard engine and the one-device engine, BFS
    by graph500's rules. Returns the launch count of the whole path and
    the launches of each stack's timing rows (``row_launches``) and each
    synchronous run's (exchange, algorithm, entry, messages, wall s)."""
    from repro_torch.kernels import edge_gather
    for exchange in EXCHANGES:  # warm-up, untimed
        for overlap in (False, True):
            engine(exchange, "bfs", "kernel").run(root=int(roots[0]),
                                                  overlap=overlap)
    torch.cuda.synchronize()
    edge_gather.windows_launches = 0
    results, words, walls = [], {}, []
    # Launches of each stack's timing rows: allgather and frontier fold
    # over the CSC stack, the combined exchange over the combined stack.
    counted = {"csc": [], "combined": []}
    for exchange in EXCHANGES:
        for name, entry, kwargs, _ in engine_runs:
            eng = engine(exchange, name, "kernel")
            for overlap in SCHEDULES:
                if overlap and name in ("wcc", "pagerank"):
                    continue
                before = edge_gather.windows_launches
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = getattr(eng, entry)(overlap=overlap, **kwargs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = edge_gather.windows_launches - before
                outs = out if isinstance(out, list) else [out]
                steps = max(r.supersteps for r in outs)
                messages = sum(r.messages for r in outs)
                wire = outs[0].comm["wire_words"]
                words[exchange, overlap, name, entry] = wire
                log("shard", exchange=exchange, overlap=overlap,
                    algorithm=name, entry=entry, queries=len(outs),
                    supersteps=steps, messages=messages, wire_words=wire,
                    wall_s=round(wall, 6), teps=round(messages / wall),
                    launches=launched,
                    max_memory_allocated=torch.cuda.max_memory_allocated())
                calls = combines_of(eng.kernel, exchange, overlap)
                if launched != steps * len(calls):
                    raise AssertionError(
                        f"{exchange} overlap={overlap} {name} {entry}: "
                        f"{launched} launches for {steps} supersteps x "
                        f"{calls}")
                results.append((exchange, overlap, name, entry, kwargs,
                                outs))
                if not overlap:
                    walls.append((exchange, name, entry, messages, wall))
                stack = {"allgather": "csc", "frontier": "csc",
                         "combined": "combined"}.get(exchange)
                if stack:
                    counted[stack].append((calls, len(outs), steps))
            if name == "pagerank" and exchange in ("unicast", "combined"):
                try:
                    eng.run(overlap=True)
                except ValueError:
                    log("check", exchange=exchange, algorithm=name,
                        overlap=True, refused="ValueError")
                else:
                    raise AssertionError(f"{exchange} PageRank ran "
                                         "overlap=True")
    total = edge_gather.windows_launches
    log("shard", launches_total=total)
    rows = {k: row_launches(v) for k, v in counted.items()}

    avg_degree = g.num_edges / g.num_vertices
    for name, entry, _, _ in engine_runs:
        sync = {x: words[x, False, name, entry] for x in EXCHANGES}
        log("shard", algorithm=name, entry=entry,
            **{f"wire_words_{x}": w for x, w in sync.items()},
            frontier_over_allgather=sync["frontier"] / sync["allgather"],
            unicast_over_combined=sync["unicast"] / sync["combined"],
            average_degree=avg_degree)
        for x in EXCHANGES:
            if (x, True, name, entry) in words and \
                    words[x, True, name, entry] != sync[x]:
                raise AssertionError(f"{x} {name} {entry}: overlapped "
                                     "words differ from the synchronous")

    by_run = {(name, entry): outs for name, entry, _, outs in engine_runs}
    ref_runs = {}
    for exchange, overlap, name, entry, kwargs, outs in results:
        if (exchange, name, entry) not in ref_runs:
            want = getattr(engine(exchange, name, "ref"), entry)(**kwargs)
            ref_runs[exchange, name, entry] = (
                want if isinstance(want, list) else [want])
        for got, ref, one in zip(outs, ref_runs[exchange, name, entry],
                                 by_run[name, entry]):
            same_result(got, ref, name)
            same_as_engine(got, one, name)
        if name == "bfs":
            for r, res in zip(np.atleast_1d(kwargs["root"]), outs):
                validate_bfs(torch, g, res.state["parent"], int(r),
                             res.supersteps, res.messages, device)
        log("check", exchange=exchange, overlap=overlap, algorithm=name,
            entry=entry, versus_ref="ok", versus_engine="ok",
            graph500="ok" if name == "bfs" else "-")
    return total, rows, walls


def phase_shard_stepper(torch, engine, roots):
    """The shard lane stepper: ``make_stepper(8)`` over BFS for the
    combined and frontier exchanges and the overlapped combined schedule.
    The 8 lanes start together, lane 0 is parked after two supersteps and
    its slot refilled, retired lanes are refilled from a queue, and the
    parked lane is restored into the first slot free once the queue is
    empty. The whole schedule runs once to warm up, then again with K2's
    launch count from 0: the launches must equal the supersteps times the
    exchange's combines, no program may run anew, and every lane must
    equal a solo run of its root. Returns the launches and the stacks'
    timing-row launches."""
    from repro_torch.core.stepper import LaneMeta, LaneTable
    from repro_torch.kernels import edge_gather
    cap = 10_000

    def schedule(st):
        table = LaneTable(st, BATCH, ("root",))
        queue = [int(r) for r in roots]
        first, queue = queue[:BATCH], queue[BATCH:]
        table.admit({s: LaneMeta(payload=r, qkw={"root": r})
                     for s, r in enumerate(first)})
        done, parked, steps = {}, None, 0
        while table.in_flight() or parked is not None:
            if steps == 2 and parked is None and not done:
                parked = table.checkpoint(0)
                r = queue.pop(0)
                table.admit({0: LaneMeta(payload=r, qkw={"root": r})})
            table.step(table.alive_mask(cap))
            steps += 1
            finished = table.done_slots(cap)
            if finished:
                host = table.fetch()
                for slot in finished:
                    r = table.release(slot).payload
                    done[r] = st.eng.lane_result(host, slot)
            for slot in table.free_slots():
                if queue:
                    r = queue.pop(0)
                    table.admit({slot: LaneMeta(payload=r,
                                                qkw={"root": r})})
                elif parked is not None:
                    table.restore(slot, parked)
                    parked = None
        return done, steps

    total, counted = 0, {"csc": [], "combined": []}
    for exchange, overlap in (("combined", False), ("frontier", False),
                              ("combined", True)):
        eng = engine(exchange, "bfs", "kernel")
        st = eng.make_stepper(BATCH, overlap=overlap)
        schedule(st)     # warm-up, untimed
        traces = eng.traces
        torch.cuda.synchronize()
        edge_gather.windows_launches = 0
        t0 = time.perf_counter()
        done, steps = schedule(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = edge_gather.windows_launches
        calls = combines_of(eng.kernel, exchange, overlap)
        log("shard_stepper", exchange=exchange, overlap=overlap,
            width=BATCH, lanes=len(done), supersteps=steps,
            wall_s=round(wall, 6), launches=launched, parks=1,
            restores=1, traces_after_warm=eng.traces - traces)
        if launched != steps * len(calls):
            raise AssertionError(f"stepper {exchange}: {launched} launches "
                                 f"for {steps} supersteps x {calls}")
        if eng.traces != traces:
            raise AssertionError(f"stepper {exchange}: traced anew")
        if sorted(done) != sorted(int(r) for r in roots):
            raise AssertionError(f"stepper {exchange}: lanes lost")
        for r, res in done.items():
            same_result(res, eng.run(root=r, overlap=overlap), "bfs")
        log("check", shard_stepper=exchange, overlap=overlap,
            versus_solo="ok", traces="flat",
            launches="= supersteps x combines")
        total += launched
        counted["csc" if exchange == "frontier" else "combined"].append(
            (calls, BATCH, steps))
    return total, {k: row_launches(v) for k, v in counted.items()}


def phase_timing_stacked(torch, stacks, device, rate: float, rows=None):
    """K2's kernel, plain-version and scatter_reduce_ times at the two
    full-width stacks, for the shard path's combines, with each row's
    launches on the shard path (``rows[stack]``, from phase 10) and its
    bound at the measured stream ``rate`` too."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import REDUCE, identity_for
    gen = torch.Generator(device=device).manual_seed(3)
    dtypes = {"float32": torch.float32, "int32": torch.int32}
    records = []
    for stack, layout in stacks.items():
        n_tiles = layout.rel.shape[1] // layout.tile_e
        tile = torch.arange(n_tiles, dtype=torch.int32, device=device)
        window = torch.searchsorted(
            layout.tile_start[:, 1:].contiguous(),
            tile.expand(layout.rel.shape[0], -1).contiguous(),
            right=True).repeat_interleave(layout.tile_e, dim=1)
        row_of = torch.where(
            (layout.rel < layout.tile_r)
            & (window < layout.tile_start.shape[1] - 1),
            window * layout.tile_r + layout.rel, layout.num_segments)
        row_of = row_of.clamp(max=layout.num_segments)
        del window
        for combiner, dname, used_by in TIMED_STACKED[stack]:
            dtype = dtypes[dname]
            for batch in (1, BATCH):
                vals = lane_values(torch, layout, combiner, dtype, batch,
                                   gen)
                index = row_of.expand(vals.shape)
                out = torch.full(vals.shape[:-1] + (layout.num_segments + 1,),
                                 identity_for(combiner, dtype), dtype=dtype,
                                 device=device)
                ms = event_ms(torch, lambda: ops.segment_combine_stacked(
                    vals, layout, combiner), TIMING_ITERS)
                plain_ms = event_ms(torch, lambda: plain_stacked(
                    layout, vals, combiner), 10)
                library_ms = event_ms(torch, lambda: out.scatter_reduce_(
                    2, index, vals, REDUCE[combiner], include_self=True),
                    TIMING_ITERS)
                rec = {"stack": stack, "combiner": combiner, "dtype": dname,
                       "batch": batch, "used_by": used_by, "ms": ms,
                       "plain_ms": plain_ms,
                       "bound_ms": bound_ms_stacked(layout, batch),
                       "library_ms": library_ms}
                rec["bound_share"] = rec["bound_ms"] / ms
                rec["bound_ms_measured"] = bound_ms_stacked(layout, batch,
                                                            rate)
                rec["bound_share_measured"] = rec["bound_ms_measured"] / ms
                with_launches(rec, None if rows is None else rows[stack])
                log("shard_timing",
                    **{k: v for k, v in rec.items() if k != "used_by"})
                records.append(rec)
                del vals, index, out
    return records


def service_answers(torch, svc, asked, counter="launches", **fields):
    """Submit ``asked`` ((kernel, root, priority, deadline_ms, polls[,
    overlap]) tuples) through ``svc`` and ``flush`` at the end, with the
    kernel's launch count (``edge_gather.<counter>``: K1's ``launches``,
    K2's ``windows_launches``) from 0 just before and read just after.
    The requests up to one with ``polls`` > 0 arrive together (a
    request's latency runs from its arrival, so later ones do not start
    their clocks while earlier batches run); ``poll`` then runs ``polls``
    times before the next ones arrive. Logs the service's
    stats_snapshot() numbers; returns the answers, the launches and the
    snapshot."""
    from repro_torch.kernels import edge_gather
    from repro_torch.service import QueryRequest
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setattr(edge_gather, counter, 0)
    t0 = time.perf_counter()
    futs, arrived = [], []
    for n, (kernel, root, priority, deadline_ms, polls, *ov) in enumerate(
            asked):
        arrived.append(QueryRequest(GRAPH_ID, kernel, {"root": int(root)},
                                    priority=priority,
                                    deadline_ms=deadline_ms,
                                    overlap=bool(ov and ov[0])))
        if polls or n == len(asked) - 1:
            futs += [svc.submit(req) for req in arrived]
            arrived = []
            for _ in range(polls):
                svc.poll()
    svc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = getattr(edge_gather, counter)
    answers = [f.result(timeout=0) for f in futs]
    snap = svc.stats_snapshot()
    log("service", **fields, queries=len(answers), wall_s=round(wall, 6),
        qps=snap["qps"], qps_busy=snap["qps_busy"], teps=snap["teps"],
        latency_p50_ms=snap["latency_p50_ms"],
        latency_p99_ms=snap["latency_p99_ms"],
        batches=snap["batches_dispatched"],
        preemptions=snap["preemptions"], lane_restores=snap["lane_restores"],
        park_restore_ms=snap["park_restore_ms"], launches=launches,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    if launches == 0:
        raise AssertionError(f"{fields}: the service path launched no "
                             f"kernel ({counter})")
    return answers, launches, snap


def drive_service(torch, device, g, pg, engine, seed: int):
    """Phases 13-17 and 19-20 over ``engine(name)``, phase 5's kernel
    engines (the reference answers). Returns K1's launches on each
    service path and those of all of them by timing row
    (``row_launches``), then the same of K2 on the shard class's paths."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.engine import Engine
    from repro_torch.kernels import edge_gather
    from repro_torch.service import GraphQueryService, PlanKey, ServiceStats
    rng = np.random.default_rng(seed)
    reached = np.flatnonzero(g.out_degrees() > 0)
    bfs_roots = rng.choice(reached, size=SERVICE_BFS, replace=False)
    sssp_roots = rng.choice(reached, size=SERVICE_SSSP, replace=False)
    burst_roots = rng.choice(reached, size=SERVICE_BURST, replace=False)
    want = {}

    def reference(name, root):
        if (name, root) not in want:
            want[name, root] = engine(name).run(root=int(root))
        return want[name, root]

    # set-up: publish, engines, warm (traces); each measured service is
    # a fresh front end with its own stats over this plan cache
    t0 = time.perf_counter()
    setup = GraphQueryService(max_batch=BATCH, device=device)
    version = setup.publish(GRAPH_ID, g)
    t1 = time.perf_counter()
    for name in ("bfs", "sssp"):
        setup.warm(GRAPH_ID, name)
    warm_cont = GraphQueryService(scheduling="continuous", slots=BATCH,
                                  plan_cache=setup.plans, stats=ServiceStats())
    warm_cont.warm(GRAPH_ID, "bfs")
    traces = setup.plans.sync_trace_counters()
    log("service", publish_s=round(t1 - t0, 3),
        warm_s=round(time.perf_counter() - t1, 3), plan_traces=traces,
        engines=len(setup.plans._engines),
        device_nbytes=sum(e.device_nbytes
                          for e in setup.plans._engines.values()))

    def front(**kw):
        return GraphQueryService(plan_cache=setup.plans,
                                 stats=ServiceStats(), result_cache_size=0,
                                 **kw)

    # 13. bucketed
    asked = ([("bfs", r, 0, 60_000, 0) for r in bfs_roots]
             + [("sssp", r, 0, 60_000, 0) for r in sssp_roots])
    answers, bucketed, snap = service_answers(
        torch, front(max_batch=BATCH), asked, scheduling="bucketed")
    if snap["plan_traces"] != traces:
        raise AssertionError(f"bucketed: plan_traces {traces} -> "
                             f"{snap['plan_traces']}")
    for (name, root, *_), res in zip(asked, answers):
        same_result(res, reference(name, root), name)
        if name == "bfs":
            validate_bfs(torch, g, res.state["parent"], int(root),
                         res.supersteps, res.messages, device)
    # the batches are the submissions in order, BATCH at a time (one
    # class each): a batch launches K1 its depth x its kernel's combines
    counted = []
    for i in range(0, len(asked), BATCH):
        calls = combines_of(engine(asked[i][0]).kernel)
        counted.append((calls, BATCH,
                        max(r.supersteps for r in answers[i:i + BATCH])))
    if bucketed != sum(len(c) * s for c, _, s in counted):
        raise AssertionError(f"bucketed: {bucketed} K1 launches for "
                             f"batches {counted}")
    log("check", service="bucketed", versus_engine="ok",
        graph500=f"ok x{SERVICE_BFS}", plan_traces="flat",
        launches="= batches' supersteps x combines")

    # 14. continuous, with a burst of priority-1 deadline queries that
    # parks lanes: the 64 roots queued, three supersteps pumped, then the
    # burst (README "Preemptible lanes")
    asked = [("bfs", r, 0, 60_000, 0) for r in bfs_roots]
    asked[-1] = asked[-1][:4] + (3,)
    asked += [("bfs", r, 1, 25, 0) for r in burst_roots]
    answers, continuous, snap = service_answers(
        torch, front(scheduling="continuous", slots=BATCH), asked,
        scheduling="continuous")
    if snap["preemptions"] < 1 or snap["lane_restores"] < 1:
        raise AssertionError(f"continuous: {snap['preemptions']} parks, "
                             f"{snap['lane_restores']} restores")
    if snap["plan_traces"] != traces:
        raise AssertionError(f"continuous: plan_traces {traces} -> "
                             f"{snap['plan_traces']}")
    for (name, root, *_), res in zip(asked, answers):
        same_result(res, reference(name, root), name)
    log("check", service="continuous", versus_engine="ok",
        answers=len(answers), parks=snap["preemptions"],
        restores=snap["lane_restores"], plan_traces="flat")

    # 15. spill and refault through the store
    svc = front(max_batch=BATCH)
    root = int(bfs_roots[0])
    engines = list(setup.plans._engines.values())
    before = svc.query(GRAPH_ID, "bfs", root=root, deadline_ms=60_000)
    t0 = time.perf_counter()
    if not svc.store.evict(GRAPH_ID):
        raise AssertionError("the store refused to spill the graph")
    spill_s = time.perf_counter() - t0
    spilled_bytes = svc.store.snapshot()["spilled_bytes"]
    if any(e.device_resident for e in engines):
        raise AssertionError("a spilled graph's engine is still resident")
    plan = svc.plans.get_plan(PlanKey(GRAPH_ID, "bfs", "gravfm", PARTS, 1,
                                      version=version))
    edge_gather.launches = 0
    during = plan.execute(root=np.int32(root))[0]
    offloaded = edge_gather.launches
    if offloaded != during.supersteps:
        raise AssertionError(f"offloaded dispatch: {offloaded} K1 launches "
                             f"for {during.supersteps} supersteps")
    after = svc.query(GRAPH_ID, "bfs", root=root, deadline_ms=60_000)
    if not all(e.device_resident for e in engines):
        raise AssertionError("the refault left an engine offloaded")
    for res in (during, after):
        same_result(res, before, "bfs")
    snap = svc.stats_snapshot()
    if snap["plan_traces"] != traces:
        raise AssertionError("spill/refault traced anew")
    log("spill", spill_s=round(spill_s, 6),
        spilled_bytes=spilled_bytes,
        offloaded_launches=offloaded,
        refault_upload_ms=snap["store_refault_upload_ms"],
        faults=snap["store_faults"], resident="False->True",
        versus_resident="ok")

    # 16. mode="gravf", against phase 5's gravfm run
    root = int(bfs_roots[1])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gravf = Engine(ALG.bfs(), pg, mode="gravf", device=device)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gravf.run(root=root)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fm = reference("bfs", root)
    if (res.supersteps, res.messages) != (fm.supersteps, fm.messages):
        raise AssertionError("gravf supersteps/messages differ from gravfm")
    for k in fm.state:
        if not np.array_equal(res.state[k], fm.state[k]):
            raise AssertionError(f"gravf state[{k!r}] differs from gravfm")
    log("gravf", root=root, supersteps=res.supersteps,
        messages=res.messages, build_s=round(build_s, 3),
        wall_s=round(wall, 6), device_nbytes=gravf.device_nbytes,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        unicast_words=res.comm["unicast_words"],
        bcast_filtered_words=res.comm["bcast_filtered_words"],
        unicast_over_filtered=(res.comm["unicast_words"]
                               / res.comm["bcast_filtered_words"]),
        average_degree=g.num_edges / g.num_vertices, versus_gravfm="ok")
    del gravf

    # 17. where a service batch's time goes
    batch = [("bfs", r, 0, 60_000, 0) for r in bfs_roots[:BATCH]]
    for scheduling, kw in (("bucketed", {"max_batch": BATCH}),
                           ("continuous", {"scheduling": "continuous",
                                           "slots": BATCH})):
        svc = front(**kw)
        profiled(torch, lambda: service_answers(
            torch, svc, batch, scheduling=scheduling, profiled=True),
            service=scheduling, queries=BATCH)
    # a continuous step launches K1 once (BFS), at the slot width
    counted += [(combines_of(engine("bfs").kernel), BATCH, continuous),
                (combines_of(engine("bfs").kernel), 1, offloaded)]
    paths2, rows2 = drive_shard_service(
        torch, g, setup, front, reference, version,
        (bfs_roots, sssp_roots, burst_roots))
    phase_service_projection(torch, front, bfs_roots)
    return ({"service_bucketed": bucketed, "service_continuous": continuous,
             "offloaded": offloaded}, row_launches(counted), paths2, rows2)


def drive_shard_service(torch, g, setup, front, reference, version, roots):
    """Phases 19-20: the service's shard class ``exchange="combined"``
    (four shards of the card, ``LocalMesh``) over phase 13's plan cache,
    on phase 13's requests: bucketed, continuous with the burst that
    parks lanes, bucketed with ``overlap`` toggled per request, then a
    spill and refault with a dispatch while spilled; K2's launch count
    from 0 before each and read after; every answer against phase 5's
    engine (``reference``), plan_traces flat after warm-up. Returns K2's
    launches on each path, and those of all of them by combined-stack
    timing row."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.kernels import edge_gather
    from repro_torch.service import PlanKey
    bfs_roots, sssp_roots, burst_roots = roots
    exchange = "combined"
    t0 = time.perf_counter()
    warm = front(max_batch=BATCH, exchange=exchange)
    for name in ("bfs", "sssp"):
        for overlap in SCHEDULES:
            warm.warm(GRAPH_ID, name, overlap=overlap)
    front(scheduling="continuous", slots=BATCH,
          exchange=exchange).warm(GRAPH_ID, "bfs")
    traces = setup.plans.sync_trace_counters()
    shard = [e for e in setup.plans._engines.values()
             if getattr(e, "exchange", "") == exchange]
    log("shard_service", exchange=exchange,
        warm_s=round(time.perf_counter() - t0, 3), plan_traces=traces,
        engines=len(shard),
        device_nbytes=sum(e.device_nbytes for e in shard))

    def batches(asked, answers):
        """(combines, batch, supersteps) of each bucketed batch: a class
        (kernel, schedule) dispatches its requests in arrival order,
        BATCH at a time, at a power-of-two batch size."""
        classes = {}
        for (name, _, _, _, _, *ov), res in zip(asked, answers):
            classes.setdefault((name, bool(ov and ov[0])), []).append(res)
        out = []
        for (name, overlap), got in classes.items():
            calls = combines_of(ALG.ALGORITHMS[name](), exchange, overlap)
            for i in range(0, len(got), BATCH):
                chunk = got[i:i + BATCH]
                out.append((calls, len(chunk),
                            max(r.supersteps for r in chunk)))
        return out

    def check(tag, asked, answers, snap):
        if snap["plan_traces"] != traces:
            raise AssertionError(f"shard {tag}: plan_traces {traces} -> "
                                 f"{snap['plan_traces']}")
        for (name, root, *_), res in zip(asked, answers):
            if res.comm["exchange"] != exchange:
                raise AssertionError(f"shard {tag}: answered by "
                                     f"{res.comm}")
            same_as_engine(res, reference(name, root), name)
        log("check", shard_service=tag, answers=len(answers),
            versus_engine="ok", plan_traces="flat")

    # 19a. bucketed
    asked = ([("bfs", r, 0, 60_000, 0) for r in bfs_roots]
             + [("sssp", r, 0, 60_000, 0) for r in sssp_roots])
    answers, bucketed, snap = service_answers(
        torch, front(max_batch=BATCH, exchange=exchange), asked,
        counter="windows_launches", shard_scheduling="bucketed")
    check("bucketed", asked, answers, snap)
    counted = batches(asked, answers)
    if bucketed != sum(len(c) * st for c, _, st in counted):
        raise AssertionError(f"shard bucketed: {bucketed} K2 launches for "
                             f"batches {counted}")

    # 19b. continuous, with the burst of priority-1 deadline queries
    asked = [("bfs", r, 0, 60_000, 0) for r in bfs_roots]
    asked[-1] = asked[-1][:4] + (3,)
    asked += [("bfs", r, 1, 25, 0) for r in burst_roots]
    answers, continuous, snap = service_answers(
        torch, front(scheduling="continuous", slots=BATCH,
                     exchange=exchange), asked,
        counter="windows_launches", shard_scheduling="continuous")
    if snap["preemptions"] < 1 or snap["lane_restores"] < 1:
        raise AssertionError(f"shard continuous: {snap['preemptions']} "
                             f"parks, {snap['lane_restores']} restores")
    check("continuous", asked, answers, snap)
    # a continuous step folds every lane at the slot width
    calls = combines_of(ALG.bfs(), exchange)
    counted.append((calls, BATCH, continuous // len(calls)))

    # 19c. bucketed, every other request on the overlapped schedule
    asked = [("bfs", r, 0, 60_000, 0, i % 2 == 1)
             for i, r in enumerate(bfs_roots)]
    asked += [("sssp", r, 0, 60_000, 0, i % 2 == 1)
              for i, r in enumerate(sssp_roots)]
    answers, toggled, snap = service_answers(
        torch, front(max_batch=BATCH, exchange=exchange), asked,
        counter="windows_launches", shard_scheduling="bucketed",
        overlap="toggled")
    check("overlap-toggled", asked, answers, snap)
    toggled_batches = batches(asked, answers)
    if toggled != sum(len(c) * st for c, _, st in toggled_batches):
        raise AssertionError(f"shard overlap-toggled: {toggled} K2 "
                             f"launches for batches {toggled_batches}")
    counted += toggled_batches

    # 19d. spill and refault through the store
    svc = front(max_batch=BATCH, exchange=exchange)
    root = int(bfs_roots[0])
    before = svc.query(GRAPH_ID, "bfs", root=root, deadline_ms=60_000)
    t0 = time.perf_counter()
    if not svc.store.evict(GRAPH_ID):
        raise AssertionError("the store refused to spill the graph")
    spill_s = time.perf_counter() - t0
    spilled_bytes = svc.store.snapshot()["spilled_bytes"]
    if any(e.device_resident for e in shard):
        raise AssertionError("a spilled graph's shard engine is resident")
    plan = svc.plans.get_plan(PlanKey(GRAPH_ID, "bfs", "gravfm", PARTS, 1,
                                      version=version, exchange=exchange))
    edge_gather.windows_launches = 0
    during = plan.execute(root=np.int32(root))[0]
    offloaded = edge_gather.windows_launches
    calls = combines_of(plan.engine.kernel, exchange)
    if offloaded != during.supersteps * len(calls):
        raise AssertionError(f"offloaded shard dispatch: {offloaded} K2 "
                             f"launches for {during.supersteps} supersteps "
                             f"x {calls}")
    after = svc.query(GRAPH_ID, "bfs", root=root, deadline_ms=60_000)
    if not all(e.device_resident for e in shard):
        raise AssertionError("the refault left a shard engine offloaded")
    for res in (during, after):
        same_result(res, before, "bfs")
    same_as_engine(before, reference("bfs", root), "bfs")
    snap = svc.stats_snapshot()
    if snap["plan_traces"] != traces:
        raise AssertionError("shard spill/refault traced anew")
    log("shard_spill", spill_s=round(spill_s, 6),
        spilled_bytes=spilled_bytes,
        offloaded_launches=offloaded,
        refault_upload_ms=snap["store_refault_upload_ms"],
        faults=snap["store_faults"], resident="False->True",
        versus_resident="ok")
    counted.append((calls, 1, during.supersteps))

    # 20. where a shard service batch's time goes
    batch = [("bfs", r, 0, 60_000, 0) for r in bfs_roots[:BATCH]]
    svc = front(max_batch=BATCH, exchange=exchange)
    profiled(torch, lambda: service_answers(
        torch, svc, batch, counter="windows_launches",
        shard_scheduling="bucketed", profiled=True),
        service="bucketed", exchange=exchange, queries=BATCH)
    return ({"shard_service_bucketed": bucketed,
             "shard_service_continuous": continuous,
             "shard_service_overlap_toggled": toggled,
             "shard_offloaded": offloaded},
            {"combined": row_launches(counted)})


def phase_service_projection(torch, front, roots) -> None:
    """One bucketed batch of BATCH BFS through the one-device class and
    the shard class (``exchange="combined"``), each served once with
    ``roofline_platform=perfmodel.H100`` and once with the default
    PAPER_PLATFORM: each class's gravfm_roofline_teps,
    gravfm_roofline_projected_teps and gravfm_roofline_efficiency
    gauges. Against the card the efficiency must be above 0."""
    from repro_torch.core import perfmodel
    asked = [("bfs", r, 0, 60_000, 0) for r in roots[:BATCH]]
    gauges = ("gravfm_roofline_teps", "gravfm_roofline_projected_teps",
              "gravfm_roofline_efficiency")
    for exchange, counter in ((None, "launches"),
                              ("combined", "windows_launches")):
        for platform in (perfmodel.H100, perfmodel.PAPER_PLATFORM):
            kw = {"exchange": exchange} if exchange else {}
            svc = front(max_batch=BATCH, roofline_platform=platform, **kw)
            service_answers(torch, svc, asked, counter=counter,
                            projection=repr(platform.name),
                            exchange=exchange)
            snap = svc.metrics_snapshot()
            by_class = {}
            for name in gauges:
                for series in snap[name]["series"]:
                    by_class.setdefault(series["labels"]["class"], {})[
                        name] = series["value"]
            for ck, vals in by_class.items():
                log("projection", service="bucketed", exchange=exchange,
                    platform=repr(platform.name), class_key=ck,
                    teps=vals[gauges[0]], projected_teps=vals[gauges[1]],
                    efficiency=vals[gauges[2]])
                if platform is perfmodel.H100 and not vals[gauges[2]] > 0:
                    raise AssertionError(f"{ck}: no roofline efficiency "
                                         "against the H100 profile")


_TENANT_GRAPHS = r"""
import sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from repro_torch.core import graph as G
out, scale, ef = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
for c, seed in (("b", 1), ("c", 2)):
    t0 = time.perf_counter()
    g = G.rmat(scale, ef, seed=seed, weighted=True).symmetrized()
    np.savez(f"{out}/tenant-{c}.npz", n=g.num_vertices, src=g.src,
             dst=g.dst, w=g.weights)
    print(f"tenant-{c} {time.perf_counter() - t0:.3f}", flush=True)
"""


def start_tenant_graphs():
    """Build the tenancy phase's tenants b and c (R-MAT TENANCY_SCALE,
    seeds 1 and 2) in a process of their own, which sees no card, while
    the earlier phases run; ``tenant_graphs`` collects them. The caller
    kills the process if it is still running at the end."""
    out = ROOT / "build" / "tenancy"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", _TENANT_GRAPHS, str(ROOT / "src"), str(out),
         str(TENANCY_SCALE), str(EDGE_FACTOR)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def tenant_graphs(proc) -> tuple:
    """Wait for ``start_tenant_graphs``' process; return tenants b and c's
    graphs and the seconds the main process waited for them."""
    from repro_torch.core import graph as G
    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=TENANT_GRAPHS_TIMEOUT)
    waited = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the tenant graphs' build failed: {out[-2000:]}")
    log("tenancy", built=repr(out.strip()), waited_s=round(waited, 3))
    graphs = {}
    for c in ("b", "c"):
        path = ROOT / "build" / "tenancy" / f"tenant-{c}.npz"
        with np.load(path) as z:
            graphs[f"tenant-{c}"] = G.Graph(int(z["n"]), z["src"], z["dst"],
                                            z["w"])
        path.unlink()
    return graphs, waited


def tenancy_series(names, tenants) -> list:
    """The exposition's series the port's metrics twins
    (tests/test_torch_metrics.py) assert present on a service, for these
    tenants: (name, label) pairs, label None for an unlabelled series."""
    want = [(n, None) for n in TENANCY_SERIES]
    want += [("gravfm_tenant_completed_total", f'tenant="{t}"')
             for t in tenants]
    # on one card (perfmodel.H100) the projection has no interface or
    # network term: L_PE, L_mem and T_sys
    want += [("gravfm_model_limit_teps", f'term="{t}"')
             for t in ("L_PE", "L_mem", "T_sys")]
    want += [("gravfm_roofline_efficiency", None)]
    return [(n, lb) for n, lb in want
            if not any(k.split("{")[0] == n and (lb is None or lb in k)
                       for k in names)]


def phase_tenancy(torch, device, g, pg, seed: int, graph_proc) -> int:
    """The multi-tenant, observed service at full size, in the shape of
    examples/multi_tenant.py: three R-MAT graphs (tenant-a the smoke's,
    tenants b and c from seeds 1 and 2 at TENANCY_SCALE) under a memory
    budget of TENANCY_BUDGET partitions, weights 2 / 1 / 1, tenant-c
    capped by a token bucket, the watchdog's thread, the query trace and
    the exposition; ``graph_proc`` is ``start_tenant_graphs``' process.
    Two rounds, each tenant in turn: 16 BFS roots from ``seed`` (deadline
    60 s), and for tenant-a 8 SSSP roots at priority 1 three polls later;
    round 1 under torch.profiler. Raises on any failure; returns K1's
    launches over both rounds."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import perfmodel
    from repro_torch.core.engine import Engine
    from repro_torch.kernels import edge_gather
    from repro_torch.service import (AdmissionError, GraphQueryService,
                                     QueryRequest)
    from repro_torch.service.stats import percentile
    others, waited = tenant_graphs(graph_proc)
    graphs = {"tenant-a": g, **others}
    budget = TENANCY_BUDGET * pg.device_nbytes
    svc = GraphQueryService(device=device, num_shards=PARTS, max_batch=16,
                            slots=16, scheduling="continuous",
                            backend="kernel",
                            roofline_platform=perfmodel.H100,
                            memory_budget=budget)
    t1 = time.perf_counter()
    for gid, gg in graphs.items():
        svc.add_graph(gid, gg)
    publish_s = time.perf_counter() - t1
    svc.set_tenant("tenant-a", weight=2.0)
    svc.set_tenant("tenant-b", weight=1.0)
    rate, burst = TENANCY_RATE
    log("tenancy", graphs=len(graphs), scale_a=SCALE,
        scale_bc=TENANCY_SCALE,
        edges={k: v.num_edges for k, v in graphs.items()},
        waited_s=round(waited, 3), publish_s=round(publish_s, 3),
        partition_bytes=pg.device_nbytes, budget_bytes=budget,
        weights="2/1/1", tenant_c=f"rate_qps={rate} burst={burst}")

    rng = np.random.default_rng(seed)
    roots = {gid: [rng.choice(np.flatnonzero(gg.out_degrees() > 0),
                              size=TENANCY_BFS, replace=False)
                   for _ in range(TENANCY_ROUNDS)]
             for gid, gg in graphs.items()}
    sssp = [rng.choice(np.flatnonzero(g.out_degrees() > 0),
                       size=TENANCY_SSSP, replace=False)
            for _ in range(TENANCY_ROUNDS)]
    asked = []     # (tenant, kernel, root, request, future)

    def one_round(r: int) -> None:
        for gid in graphs:
            for x in roots[gid][r]:
                req = QueryRequest(gid, "bfs", {"root": int(x)}, tenant=gid,
                                   deadline_ms=60_000)
                asked.append((gid, "bfs", int(x), req, svc.submit(req)))
            if gid == "tenant-a":
                for _ in range(3):
                    svc.poll()
                for x in sssp[r]:
                    req = QueryRequest(gid, "sssp", {"root": int(x)},
                                       tenant=gid, priority=1,
                                       deadline_ms=60_000)
                    asked.append((gid, "sssp", int(x), req,
                                  svc.submit(req)))
            svc.flush()

    # every tenant-c admission is held to a replay of its bucket
    with admissions_replayed("tenancy") as admissions:
        svc.set_tenant("tenant-c", weight=1.0, rate_qps=rate, burst=burst)
        svc.start_watchdog()
        try:
            torch.cuda.synchronize()
            edge_gather.launches = 0
            t0 = time.perf_counter()
            one_round(0)
            torch.cuda.synchronize()
            round0_s = time.perf_counter() - t0
            _, busy = profiled(torch, lambda: one_round(1),
                               tenancy="round 1")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = edge_gather.launches
            evaluations = svc.watchdog.evaluations
            active = svc.watchdog.active_alerts()
        finally:
            svc.stop_watchdog()
    snap = svc.stats_snapshot()

    # answers: every BFS by graph500's rules, SSSP against the oracle
    answered, shed, ref = [], {}, {}
    for gid, kernel, root, req, fut in asked:
        exc = fut.exception(timeout=0)
        if exc is not None:
            if not isinstance(exc, AdmissionError):
                raise exc
            shed[gid] = shed.get(gid, 0) + 1
            continue
        res = fut.result(timeout=0)
        answered.append((gid, kernel, req, res))
        if kernel == "bfs":
            validate_bfs(torch, graphs[gid], res.state["parent"], root,
                         res.supersteps, res.messages, device)
        else:
            if "sssp" not in ref:
                ref["sssp"] = Engine(ALG.sssp(), pg, backend="ref",
                                     device=device)
            same_result(res, ref["sssp"].run(root=root), "sssp")
    del ref
    log("tenancy", answers=len(answered),
        bfs_checked=sum(k == "bfs" for _, k, _, _ in answered),
        sssp_versus_ref=sum(k == "sssp" for _, k, _, _ in answered),
        shed=shed, launches=launches)
    if launches == 0:
        raise AssertionError("tenancy: the service launched no K1")

    # the sheds are tenant-c's refused admissions, and nothing else
    refused = sum(not ok for name, _, ok in admissions
                  if name == "tenant-c")
    if shed.get("tenant-c", 0) != refused or set(shed) - {"tenant-c"}:
        raise AssertionError(f"tenancy: sheds {shed} against the bucket's "
                             f"{refused}")

    # the store: spills to the host tier and refaults
    if (snap["store_evictions"] < 1 or snap["store_spills"] < 1
            or snap["store_faults"] < 1):
        raise AssertionError("tenancy: no eviction, spill or refault: "
                             + str({k: v for k, v in snap.items()
                                    if k.startswith("store_")}))
    log("tenancy", evictions=snap["store_evictions"],
        spills=snap["store_spills"], refaults=snap["store_faults"],
        discards=snap["store_discards"],
        overcommits=snap["store_budget_overcommits"],
        resident_graphs=snap["store_resident_graphs"],
        store_refault_upload_ms=snap["store_refault_upload_ms"],
        preemptions=snap["preemptions"], lane_restores=snap["lane_restores"])

    # each tenant's slot share: its queries' lane-supersteps over all
    # lanes stepped, from the trace's superstep events
    tenant_of = {req.qid: gid for gid, _, req, _ in answered}
    lanes = {gid: 0 for gid in graphs}
    events = svc.trace.snapshot()
    for e in events:
        if e.kind == "superstep":
            for qid in e.attrs["lanes"].values():
                if qid in tenant_of:
                    lanes[tenant_of[qid]] += 1
    total = max(1, sum(lanes.values()))
    # each tenant's latency, submit to retire, from its queries' spans
    spans = svc.trace.spans()
    for gid, t in snap["tenants"].items():
        ms = [1e3 * (sp.retired_s - sp.submitted_s)
              for sp in (spans.get(req.qid) for tg, _, req, _ in answered
                         if tg == gid)
              if sp is not None and sp.retired_s is not None]
        log("tenancy", tenant=gid, completed=t["completed"], shed=t["shed"],
            qps=t["completed"] / wall, slot_share=lanes.get(gid, 0) / total,
            latency_p50_ms=percentile(ms, 50), latency_p99_ms=percentile(
                ms, 99))

    # one trace per answered query, retired or (a root a round repeats)
    # served from the result cache
    missing = [req.qid for _, _, req, _ in answered
               if req.qid not in spans
               or spans[req.qid].outcome not in ("retired", "cache_hit")]
    if missing or svc.trace.dropped:
        raise AssertionError(f"tenancy: {len(missing)} answered queries "
                             f"without a retired or cache-hit span, "
                             f"{svc.trace.dropped} events dropped")

    # the exposition, scraped at the end
    text = svc.metrics_text()
    names = [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
             if ln and not ln.startswith("#")]
    absent = tenancy_series(names, graphs)
    if absent:
        raise AssertionError(f"tenancy: series absent: {absent}")

    # the watchdog: every alert printed, the stall rule silent at the end
    for e in events:
        if e.kind == "alert":
            log("tenancy", alert=e.attrs["rule"], state=e.attrs["state"],
                subject=e.klass, kind=e.attrs["alert_kind"])
    stalled = [a for a in active if a.rule == "stall"]
    log("tenancy", watchdog_evaluations=evaluations,
        active_alerts=[(a.rule, a.subject) for a in active],
        series=len(names), spans=len(spans), trace_events=len(events),
        round0_s=round(round0_s, 3), wall_s=round(wall, 3),
        round1_device_busy_s=round(busy, 6), qps=snap["qps"],
        latency_p50_ms=snap["latency_p50_ms"],
        latency_p99_ms=snap["latency_p99_ms"])
    if stalled or evaluations < 1:
        raise AssertionError(f"tenancy: watchdog {evaluations} evaluations, "
                             f"stall active at the end: {stalled}")
    return launches


def example(name: str):
    """An example twin (examples/<name>.py) loaded as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def admissions_replayed(tag: str):
    """Inside the block, every rate-capped tenant's admissions are
    recorded (the clock each was taken at, and the answer); on leaving,
    they are replayed through a fresh TokenBucket per tenant, and the
    block fails unless the registry decided as its bucket allows. Yields
    the list of admissions, ``(tenant, clock, admitted)``."""
    from repro_torch.store import TenantRegistry, TokenBucket
    configured, seen = {}, []
    configure, admit = TenantRegistry.configure, TenantRegistry.admit

    def configure_(self, name, *, now=None, **kw):
        now = time.perf_counter() if now is None else now
        if kw.get("rate_qps") is not None:
            configured[name] = (kw["rate_qps"], kw.get("burst"), now)
        return configure(self, name, now=now, **kw)

    def admit_(self, name, now=None):
        now = time.perf_counter() if now is None else now
        ok = admit(self, name, now=now)
        seen.append((name, now, ok))
        return ok
    TenantRegistry.configure, TenantRegistry.admit = configure_, admit_
    try:
        yield seen
    finally:
        TenantRegistry.configure, TenantRegistry.admit = configure, admit
    buckets = {n: TokenBucket(r, b, now=t)
               for n, (r, b, t) in configured.items()}
    for n, now, ok in seen:
        if n in buckets and buckets[n].try_take(now=now) != ok:
            raise AssertionError(f"{tag}: {n}'s admissions differ from "
                                 "its token bucket's")


def same_answers(name: str, got: dict, want: dict) -> None:
    """A graph example's answers on the card against its CPU run. The
    multi-tenant one sheds by the clock: there, the queries both runs
    served must agree, and everything else but the rounds."""
    if name == "torch_multi_tenant":
        got, want = dict(got), dict(want)
        a, b = got.pop("answers"), want.pop("answers")
        rounds = [(g, w) for g, w in zip(got.pop("rounds"),
                                         want.pop("rounds"))
                  if g[1] != "tenant-c"]
        both = set(a) & set(b)
        tenants = [(got["tenants"].pop("tenant-c"),
                    want["tenants"].pop("tenant-c"))]
        if (any(g != w for g, w in rounds) or not both
                or any(a[k] != b[k] for k in both)
                or {k for k in a if k[1] != "tenant-c"}
                != {k for k in b if k[1] != "tenant-c"}):
            raise AssertionError(f"{name}: the card's answers differ")
        log("examples", example=name, tenant_c_card_cpu=tenants,
            both_served=len(both))
    if got != want:
        raise AssertionError(f"{name}: the card's answers {got} differ "
                             f"from the CPU's {want}")


def phase_examples(torch) -> int:
    """Each example twin's main() in this process. The graph twins run on
    the card and on the CPU and must give the same answers; serve_lm's
    greedy tokens on the card must be near-argmaxes of the CPU's full
    forward over them; train_lm trains EXAMPLE_TRAIN_STEPS steps on the
    card, its first loss within TRAIN_EXAMPLE_ATOL of the CPU's forward
    on the same params and batch. Returns K1's launches on the card."""
    import shutil

    from repro_torch import configs
    from repro_torch.kernels import edge_gather
    from repro_torch.models import lm as LM
    from repro_torch.train import loop as TL
    launches = 0
    for name in EXAMPLE_GRAPHS:
        mod = example(name)
        t0 = time.perf_counter()
        with admissions_replayed(f"{name} cpu"):
            want = mod.main(device="cpu")
        cpu_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        edge_gather.launches = 0
        t0 = time.perf_counter()
        with admissions_replayed(f"{name} card"):
            got = mod.main(device="cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        n = edge_gather.launches
        same_answers(name, got, want)
        log("examples", example=name, cpu_s=round(cpu_s, 3),
            card_s=round(card_s, 3), launches=n, answers="equal to the CPU's")
        if n == 0:
            raise AssertionError(f"{name}: no K1 launch on the card")
        launches += n

    mod = example("torch_serve_lm")
    t0 = time.perf_counter()
    out = mod.main(device="cuda")
    card_s = time.perf_counter() - t0
    for arch, (prompts, gen) in out.items():
        cfg = configs.get(arch, reduced=True)
        seq = torch.from_numpy(np.concatenate([prompts, gen[:, :-1]], 1))
        with torch.inference_mode():
            logits = LM.lm_forward(mod.params_for(cfg), seq, cfg)
        near_argmax(torch, f"example_serve_{arch}",
                    logits[:, prompts.shape[1] - 1:].float(),
                    torch.from_numpy(gen).long())
    log("examples", example="torch_serve_lm", card_s=round(card_s, 3),
        archs=list(out))

    mod = example("torch_train_lm")
    ckpt = ROOT / "build" / "examples_train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    out = mod.main(argv, device="cuda")
    card_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    _, cfg, dc, oc, tc = mod.setup(argv, device="cpu")
    t0 = time.perf_counter()
    cpu = TL.Trainer(cfg, dc, oc, dataclasses.replace(tc, ckpt_dir=None),
                     device="cpu")
    params, _ = cpu._init_state()
    with torch.no_grad():
        first = float(TL.make_loss(cfg)(params, TL.batch_on(
            cpu._make_batch(0), torch.device("cpu"))))
    cpu_s = time.perf_counter() - t0
    del params, cpu
    (step0, card), *_ = out["losses"]
    log("examples", example="torch_train_lm", steps=EXAMPLE_TRAIN_STEPS,
        n_params=out["n_params"], losses=[(s, round(l, 6))
                                          for s, l in out["losses"]],
        first_loss_card=card, first_loss_cpu=first,
        gap=abs(card - first), atol=TRAIN_EXAMPLE_ATOL,
        card_s=round(card_s, 3), cpu_forward_s=round(cpu_s, 3))
    if (step0 != 0 or out["final_step"] != EXAMPLE_TRAIN_STEPS - 1
            or not all(np.isfinite(l) for _, l in out["losses"])
            or abs(card - first) > TRAIN_EXAMPLE_ATOL):
        raise AssertionError("torch_train_lm: the card's first loss "
                             f"{card} against the CPU's {first}")
    return launches


def phase_dryrun(torch) -> None:
    """The graph dry-run cell for the five exchanges on the meta device;
    the card's peak allocation must not move across it."""
    from repro_torch.launch import dryrun
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for exchange in EXCHANGES:
        cell = dryrun.run_graph_cell(exchange, algo="wcc")
        mem, coll = cell["memory"], cell["collectives"]
        log("dryrun", exchange=exchange, shards=cell["meta"]["P"],
            shape=cell["shape"],
            argument_bytes_per_shard=mem["argument_bytes"],
            temp_bytes_per_shard=mem["temp_bytes"],
            wire_bytes_per_shard=coll["total_wire_bytes"],
            collectives=json.dumps({k: v for k, v in coll.items()
                                    if k != "total_wire_bytes"},
                                   separators=(",", ":")),
            words_per_superstep=cell["words_per_superstep"]["total"],
            teps_bound=cell["teps_bound"],
            bottleneck=cell["roofline"]["bottleneck"],
            L_if="not_bounded", L_net="not_bounded",
            host_s=round(cell["host_s"], 3))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log("dryrun", memory_allocated_before=before, max_memory_allocated=peak)
    if peak != before:
        raise AssertionError(f"the dry-run allocated on the card: peak "
                             f"{peak} against {before}")


def phase_lm_dryrun(torch) -> None:
    """repro_torch.launch.dryrun's LM cells (DRYRUN_CELLS) on the (16, 16)
    mesh, each through the CLI in a process that sees no card
    (CUDA_VISIBLE_DEVICES empty: the cells run on meta tensors); each
    cell's three terms, bound and fit logged; the card's peak allocation
    must not move across the phase."""
    import os
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = ROOT / "build" / "lm_dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
             "--arch", arch, "--shape", shape, "--mesh", "single",
             "--out", str(out)], capture_output=True, text=True,
            timeout=DRYRUN_TIMEOUT, env=env, cwd=str(ROOT))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"dry-run cell {arch} {shape} exited "
                                 f"{proc.returncode}: {proc.stdout[-800:]}"
                                 f"{proc.stderr[-1500:]}")
        cell = json.loads((out / f"{arch}__{shape}__pod_16x16.json")
                          .read_text())
        rf, mem = cell["roofline"], cell["memory"]
        log("lm_dryrun", arch=arch, shape=shape, mesh=cell["mesh"],
            status=cell["status"], t_compute_s=rf["t_compute_s"],
            t_memory_s=rf["t_memory_s"],
            t_collective_s=rf["t_collective_s"], bound_by=rf["bound_by"],
            roofline_step_s=rf["roofline_step_s"],
            mfu_bound=rf["mfu_bound"], fits_hbm=cell["fits_hbm"],
            argument_bytes=mem["argument_bytes"],
            peak_estimate_bytes=mem["peak_estimate_bytes"],
            wire_bytes=cell["collectives"]["total_wire_bytes"],
            host_s=cell["host_s"], wall_s=round(wall, 3))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log("lm_dryrun", memory_allocated_before=before,
        max_memory_allocated=peak)
    if peak != before:
        raise AssertionError(f"the LM dry-run allocated on the card: peak "
                             f"{peak} against {before}")


def lm_diff(tag: str, got, want, **fields) -> dict:
    """Log how far float32 logits ``got`` lie from ``want`` (same shape,
    any devices): max and mean |diff|, the share outside
    tests/test_models.py's tolerance, top-1 agreement. Raises if a logit
    of ``got`` is not finite."""
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    diff = np.abs(got - want)
    out = {"max_abs_diff": float(diff.max()),
           "mean_abs_diff": float(diff.mean()),
           "outside_tol": float((diff > LM_ATOL + LM_RTOL
                                 * np.abs(want)).mean()),
           "top1": float((got.argmax(-1) == want.argmax(-1)).mean())}
    log("lm_serve", check=tag, **fields, **out)
    if not np.isfinite(got).all():
        raise AssertionError(f"{tag}: logits not finite")
    return out


def lm_agree(tag: str, got, want, outside: float = 0.0, **fields) -> float:
    """``lm_diff``, held to tests/test_models.py's bf16 tolerance (atol
    0.75, rtol 0.1; at most an ``outside`` share of the logits beyond it)
    and top-1 agreement >= 0.5. Returns the max |diff|."""
    out = lm_diff(tag, got, want, **fields)
    if out["outside_tol"] > outside:
        raise AssertionError(f"{tag}: {out['outside_tol']:.4%} of the "
                             f"logits outside atol {LM_ATOL}, rtol {LM_RTOL}")
    if out["top1"] < LM_TOP1:
        raise AssertionError(f"{tag}: top-1 agreement {out['top1']}")
    return out["max_abs_diff"]


def near_argmax(torch, tag: str, logits, chosen) -> None:
    """Each ``chosen`` token (B, n) must be within the tolerance of the
    top logit of ``logits`` (B, n, V), the positions that chose it."""
    picked = logits.gather(-1, chosen[..., None])[..., 0]
    top = logits.max(dim=-1).values
    slack = top - picked
    ok = slack <= LM_ATOL + LM_RTOL * top.abs()
    same = float((logits.argmax(-1) == chosen).float().mean())
    log("lm_serve", check=tag, tokens=chosen.numel(), argmax_share=same,
        max_slack=float(slack.max()))
    if not bool(ok.all()):
        raise AssertionError(f"{tag}: {int((~ok).sum())} tokens are not "
                             "a near-argmax of the re-scoring")


def lm_prompt(cfg, batch: int, length: int, seed: int):
    """Prompt tokens (B, length) and, for a VLM, a stub prefix (B, Sp, D)
    float32, from ``seed``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (batch, length))
    prefix = None
    if cfg.family == "vlm":
        prefix = rng.standard_normal(
            (batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return tokens, prefix


@contextlib.contextmanager
def routed(moe):
    """Record the experts (T, k) the router chooses in every MoE layer run
    inside the block: ``moe.route`` wrapped, restored after. The package
    counts nothing; this is the script's own view of its choices."""
    seen = []
    route = moe.route

    def record(x2, router, **kw):
        gates, idx = route(x2, router, **kw)
        seen.append(idx)
        return gates, idx
    moe.route = record
    try:
        yield seen
    finally:
        moe.route = route


def dropped_pairs(torch, idx, capacity: int, n_routed: int, rows: int):
    """The (token, expert) pairs of one MoE layer that capacity drops:
    each expert keeps its first ``capacity`` choosers in token order (the
    reference's stable sort). Returns (all dropped pairs, those of the
    last position of each of the ``rows`` sequences)."""
    T = idx.shape[0]
    chosen = torch.zeros(T, n_routed, dtype=torch.int32, device=idx.device)
    chosen.scatter_(1, idx, 1)
    drop = chosen.bool() & (chosen.cumsum(0) > capacity)
    last = drop.view(rows, T // rows, n_routed)[:, -1]
    return int(drop.sum()), int(last.sum())


def phase_lm_reduced(torch, seed: int) -> None:
    """(a) Every reduced config on the card against the CPU from the same
    bf16 weights: the decoder-only ones through the serving path, the
    MoE ones with their router's choices compared, then the enc-dec."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    from repro_torch.serve import engine as S
    B, T, new = LM_SMALL
    archs = configs.DENSE_IDS + configs.MOE_IDS + configs.RECURRENT_IDS
    for arch, dtype in [(a, "bf16") for a in archs] + [
            (a, "f32") for a in LM_SMALL_F32]:
        cfg = configs.get(arch, reduced=True)
        cpu = L.init_params(LM.lm_spec(cfg),
                            generator=torch.Generator().manual_seed(seed))
        if dtype == "f32":
            cpu = L.tree_map(lambda t: t.float(), cpu)
        # in bf16, LM_SMALL_F32's logits may lie outside the tolerance up
        # to the LM_SMALL_BF16_OUTSIDE share; their float32 run is held
        # to it whole, greedy tokens included
        outside = LM_SMALL_BF16_OUTSIDE if (
            arch in LM_SMALL_F32 and dtype == "bf16") else 0.0
        tokens, prefix = lm_prompt(cfg, B, T + 1, seed)
        start = T + (0 if prefix is None else cfg.prefix_len)
        runs, choices = {}, {}
        for dev in ("cpu", "cuda"):
            params = L.tree_map(lambda t: t.to(dev), cpu)
            pre = None if prefix is None else torch.from_numpy(prefix).to(
                dev, torch.bfloat16)
            prefill, decode, init_cache = S.make_serve_fns(
                cfg, batch=B, max_len=start + new + 1, device=dev)
            with routed(MOE) as seen:
                logits, pcache = prefill(params, tokens[:, :T], pre)
            choices[dev] = [idx.cpu() for idx in seen]
            cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
            step, cache = decode(params, cache, tokens[:, T:], start)
            gen = S.greedy_generate(cfg, params, tokens[:, :T], num_new=new,
                                    prefix=pre, device=dev)
            runs[dev] = (logits, step, gen, cache)
        logits, step, gen, cache = runs["cuda"]
        on = {logits.device.type, step.device.type}
        L.tree_map(lambda t: on.add(t.device.type), cache)
        if on != {"cuda"}:
            raise AssertionError(f"{arch}: tensors on {on}")
        lm_agree("reduced_prefill", logits, runs["cpu"][0], outside,
                 arch=arch, dtype=dtype)
        lm_agree("reduced_decode", step, runs["cpu"][1], outside, arch=arch,
                 dtype=dtype)
        if outside:
            continue
        if choices["cuda"]:
            same = torch.stack([(a == b).all(-1).float().mean() for a, b
                                in zip(choices["cuda"], choices["cpu"])])
            pairs = [torch.eq(a.sort(-1).values, b.sort(-1).values).float()
                     .mean() for a, b in zip(choices["cuda"], choices["cpu"])]
            log("lm_serve", arch=arch, check="reduced_routing",
                moe_layers=len(choices["cuda"]),
                choices_equal_cpu=float(torch.stack(pairs).mean()),
                rows_with_other_topk=float(1 - same.mean()))
        # the card's greedy tokens, re-scored by the CPU's full forward
        seq = torch.from_numpy(np.concatenate([tokens[:, :T], gen[:, :-1]],
                                              axis=1))
        pre = None if prefix is None else torch.from_numpy(prefix).to(
            torch.bfloat16)
        with torch.inference_mode():
            full = LM.lm_forward(cpu, seq, cfg, prefix_embeds=pre)
        near_argmax(torch, "reduced_greedy", full[:, start - 1:],
                    torch.from_numpy(gen).long())
        log("lm_serve", arch=arch, greedy_agree_with_cpu=float(
            (gen == runs["cpu"][2]).mean()))
    phase_lm_reduced_encdec(torch, seed)


def encdec_greedy(torch, cfg, params, frames, new: int, max_len: int,
                  tokens=None):
    """Serve seamless-style: encode ``frames``, fill the cross cache, then
    ``new`` decode steps from LM_START_TOKEN, greedy (or teacher-forced
    on ``tokens`` (B, new) when given). Returns (the tokens fed, the
    greedy tokens (B, new), the logits (B, new, V))."""
    from repro_torch.models import encdec as ED
    B, dev = frames.shape[0], frames.device
    with torch.inference_mode():
        enc = ED.encode(params, frames, cfg)
        cache = ED.init_encdec_cache(cfg, cfg.n_dec, B, max_len,
                                     frames.shape[1], device=dev)
        ED.fill_cross_cache(params, enc, cache, cfg)
        tok = torch.full((B, 1), LM_START_TOKEN, dtype=torch.long,
                         device=dev)
        pos = torch.zeros(1, dtype=torch.long, device=dev)
        fed, out, logits = [], [], []
        for i in range(new):
            fed.append(tok)
            lg, cache = ED.encdec_decode_step(params, cache, tok, pos, cfg)
            logits.append(lg)
            out.append(lg[:, -1].argmax(-1, keepdim=True))
            tok = out[-1] if tokens is None else tokens[:, i:i + 1]
            pos += 1
    return torch.cat(fed, 1), torch.cat(out, 1), torch.cat(logits, 1)


def phase_lm_reduced_encdec(torch, seed: int) -> None:
    """(a) for seamless-m4t-medium reduced: greedy decode on the card and
    the CPU from the same bf16 weights and frames; the card's logits
    against the CPU's teacher-forced on the card's tokens, and every
    greedy token a near-argmax of the CPU's ``encdec_forward``."""
    from repro_torch import configs
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    B, T, new = LM_SMALL
    for arch in configs.ENCDEC_IDS:
        cfg = configs.get(arch, reduced=True)
        cpu = L.init_params(ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec),
                            generator=torch.Generator().manual_seed(seed))
        frames = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        params = L.tree_map(lambda t: t.to("cuda"), cpu)
        fed, gen, logits = encdec_greedy(torch, cfg, params,
                                         frames.to("cuda"), new, new)
        if {fed.device.type, logits.device.type} != {"cuda"}:
            raise AssertionError(f"{arch}: tensors off the card")
        _, cpu_gen, cpu_logits = encdec_greedy(
            torch, cfg, cpu, frames, new, new, tokens=gen.cpu())
        lm_agree("reduced_encdec_decode", logits, cpu_logits, arch=arch)
        with torch.inference_mode():
            full = ED.encdec_forward(cpu, frames, fed.cpu(), cfg)
        near_argmax(torch, "reduced_encdec_greedy", full, gen.cpu())
        log("lm_serve", arch=arch, greedy_agree_with_cpu=float(
            (gen.cpu() == cpu_gen).float().mean()))


def bf16_limits(consistency: dict, forward: dict, decode: dict) -> None:
    """Hold the full-size bf16 run (``lm_diff`` results: decode against
    the bf16 forward, the bf16 forward and bf16 decode against the
    float32 forward) to the LM_BF16_* limits and top-1 >= LM_TOP1."""
    faults = []
    for tag, d in (("decode vs forward", consistency),
                   ("forward vs float32", forward),
                   ("decode vs float32", decode)):
        if d["top1"] < LM_TOP1:
            faults.append(f"{tag}: top-1 {d['top1']} < {LM_TOP1}")
        for key, limit in (("outside_tol", LM_BF16_OUTSIDE),
                           ("mean_abs_diff", LM_BF16_MEAN),
                           ("max_abs_diff", LM_BF16_MAX)):
            if d[key] > limit:
                faults.append(f"{tag}: {key} {d[key]} > {limit}")
    for key in ("outside_tol", "mean_abs_diff"):
        if decode[key] > LM_BF16_DECODE_RATIO * forward[key]:
            faults.append(f"decode vs float32: {key} {decode[key]} > "
                          f"{LM_BF16_DECODE_RATIO} x the forward's "
                          f"{forward[key]}")
    if faults:
        raise AssertionError("full-size bf16 logits: " + "; ".join(faults))


def cache_written(cache, want, start: int) -> None:
    """The k/v entries decode wrote into the first layer's cache, from
    position ``start`` on, against the same positions of ``want``, a
    forward's caches over the same tokens. The first layer sees the same
    bf16 embeddings on both paths, so its entries agree to one bf16 ulp
    but where a GEMM's accumulation order tips the rounding: at most
    LM_CACHE_OUTSIDE of them may not."""
    for name in ("k", "v"):
        got = cache["stage"]["0"][name][0, :, start:].float()
        ref = want["stage"]["0"][name][0, :, start:].float()
        if got.shape != ref.shape:
            raise AssertionError(f"cache {name}: {tuple(got.shape)} "
                                 f"against {tuple(ref.shape)}")
        diff = (got - ref).abs()
        outside = float((diff > 2 ** -7 * ref.abs() + 1e-6).float().mean())
        log("lm_serve", check="full_cache_written", tensor=name, layer=0,
            positions=got.shape[1], max_abs_diff=float(diff.max()),
            outside_ulp=outside)
        if outside > LM_CACHE_OUTSIDE:
            raise AssertionError(f"cache {name}: {outside:.4%} of decode's "
                                 "entries beyond one bf16 ulp of the "
                                 "forward's")


def lm_flops_prefill(cfg, params, batch: int, seq: int,
                     every_position: bool = False) -> int:
    """The multiply-adds (x2) a last-only prefill of a global-attention
    model needs: every matmul weight (``w*``) of the blocks once per
    token, causal attention (QK^T and PV over the s + 1 visible positions
    of each query), one logits row per sequence (every position's with
    ``every_position``, as training computes them). The code also
    computes the masked blocks and the kv padding of its blockwise
    attention; those are not counted."""
    def weights(tree):
        return sum(weights(v) if isinstance(v, dict) else
                   (v.numel() if k.startswith("w") else 0)
                   for k, v in tree.items())
    matmul = weights(params["stage"]) + weights(params.get("tail", {}))
    visible = seq * (seq + 1) // 2
    attn = 4 * batch * cfg.n_heads * cfg.head_dim * visible * cfg.n_layers
    rows = batch * (seq if every_position else 1)
    return (2 * matmul * batch * seq + attn
            + 2 * rows * cfg.d_model * cfg.vocab_padded)


def log_roofline(phase: str, cfg, kind: str, flops: float, measured_s: float,
                 tokens: int, cache_bytes: float = 0.0, **fields) -> None:
    """The ported roofline (repro_torch.launch.roofline) of one card's
    step beside its measured seconds: ``flops`` this run's shapes need,
    the analytic fused HBM bytes, no collective (one card); at the data
    sheet's rates and at the measured stream rate."""
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import active_param_count
    from repro_torch.models import lm as LM
    active = active_param_count(cfg)
    ana = RL.analytic_hbm_bytes(
        n_params=LM.num_params(cfg), n_params_active=active, tokens=tokens,
        d_model=cfg.d_model, n_layers=cfg.n_layers, vocab=cfg.vocab_padded,
        n_dev=1, dp=1, tp=1, kind=kind, cache_bytes_per_dev=cache_bytes)
    for hw in (RL.H100, RL.H100_STREAM):
        rf = RL.roofline({"flops": flops}, {}, n_devices=1, tokens=tokens,
                         n_params_active=active, kind=kind,
                         analytic_bytes=ana, hw=hw)
        log(phase, arch=cfg.name, roofline=kind, hardware=repr(hw.name),
            t_compute_s=rf["t_compute_s"], t_memory_s=rf["t_memory_s"],
            bound_by=rf["bound_by"], roofline_step_s=rf["roofline_step_s"],
            measured_s=measured_s,
            roofline_share=rf["roofline_step_s"] / measured_s,
            mfu_bound=rf["mfu_bound"], **fields)


def phase_lm_full(torch, seed: int, rate: float) -> None:
    """(b) qwen3-4b at full width and depth, and (c) its profile."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine as S
    cfg = configs.get(LM_ARCH)
    B, T, new, max_len = LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = L.init_params(LM.lm_spec(cfg), generator=gen)
    torch.cuda.synchronize()
    leaves = []
    L.tree_map(lambda t: leaves.append(t), params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log("lm_serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv}", d_ff=cfg.d_ff, vocab=cfg.vocab,
        params=sum(t.numel() for t in leaves), weight_bytes=weight_bytes,
        dtype=str(leaves[0].dtype), init_s=round(time.perf_counter() - t0, 3),
        batch=B, prompt=T, new_tokens=new, max_len=max_len,
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    tokens, _ = lm_prompt(cfg, B, T, seed)
    prefill, decode, init_cache = S.make_serve_fns(cfg, batch=B,
                                                   max_len=max_len,
                                                   device="cuda")
    # warm-up at the same shapes (library handles, the allocator's pools)
    logits, pcache = prefill(params, tokens)
    cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
    decode(params, cache, logits[:, -1].argmax(-1, keepdim=True), T)
    del logits, pcache, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    logits, pcache = prefill(params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
    del pcache
    tok = logits[:, -1].argmax(-1, keepdim=True)
    toks, steps = [tok], []
    finite = torch.isfinite(logits).all()
    pos = torch.full((1,), T, dtype=torch.long, device="cuda")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(new + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(new):
        step, cache = decode(params, cache, tok, pos)
        events[i + 1].record()
        if i == 0:
            first = step
        finite &= torch.isfinite(step).all()
        tok = step[:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        pos += 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(new)]
    peak = torch.cuda.max_memory_allocated()
    out = torch.cat(toks, dim=1)                       # (B, new + 1)
    if not bool(finite):
        raise AssertionError("a logit of the full-size run is not finite")

    # the reference's consistency check at T: decode of token T against
    # the full forward over the prompt and token T. Its tolerance was set
    # on the reduced configs; at full width bf16 rounding alone puts ~4 %
    # of the logits outside it, the bf16 forward against its own float32
    # run as much as decode against the forward (PERF.md, Findings). So
    # the check runs at the reference's tolerance with the params in
    # float32 (the KV cache stays bf16), and the timed bf16 run is held
    # to the LM_BF16_* limits: its distances to the float32 forward, and
    # decode's no larger than the bf16 forward's.
    seq = torch.cat([torch.as_tensor(tokens, device="cuda"), out], dim=1)
    p32 = L.tree_map(lambda t: t.float(), params)
    prefill32, decode32, init32 = S.make_serve_fns(cfg, batch=B,
                                                   max_len=T + 1,
                                                   device="cuda")
    _, pcache = prefill32(p32, tokens)
    cache32 = S.place_prefill_cache(cfg, pcache, init32(), T)
    step32, _ = decode32(p32, cache32, out[:, :1], T)
    with torch.inference_mode():
        full32 = LM.lm_forward(p32, seq[:, :T + 1], cfg, last_only=True)
    del p32, pcache, cache32
    lm_agree("full_consistency_f32", step32[:, -1], full32[:, -1],
             arch=cfg.name, position=T)
    with torch.inference_mode():
        full_t = LM.lm_forward(params, seq[:, :T + 1], cfg, last_only=True)
    bf16 = lm_diff("full_consistency_bf16", first[:, -1], full_t[:, -1],
                   arch=cfg.name, position=T)
    fwd = lm_diff("full_forward_bf16_vs_f32", full_t[:, -1], full32[:, -1],
                  arch=cfg.name, position=T)
    dec = lm_diff("full_decode_bf16_vs_f32", first[:, -1], full32[:, -1],
                  arch=cfg.name, position=T)
    del full_t, full32, step32
    bf16_limits(bf16, fwd, dec)
    # every token a near-argmax of one forward over prompt + generated,
    # and the entries decode wrote into the cache that forward's
    with torch.inference_mode():
        full, fcache = LM.lm_forward(params, seq[:, :-1], cfg,
                                     return_cache=True)
    near_argmax(torch, "full_greedy", full[:, T - 1:], out)
    cache_written(cache, fcache, T)
    del full, fcache
    gen_t0 = time.perf_counter()
    again = S.greedy_generate(cfg, params, tokens, num_new=new + 1,
                              max_len=max_len, device="cuda")
    generate_s = time.perf_counter() - gen_t0
    if not np.array_equal(again, out.to(torch.int32).cpu().numpy()):
        raise AssertionError("greedy_generate's tokens differ from the "
                             "timed loop's")

    kv = cache["stage"]["0"]["k"]
    kv_bytes = 2 * kv.numel() * kv.element_size()   # k and v, whole Smax
    decode_bound_ms = (weight_bytes + kv_bytes) / rate * 1e3
    flops = lm_flops_prefill(cfg, params, B, T)
    prefill_bound_s = flops / BF16_FLOPS_PER_S
    med = float(np.median(step_ms))
    log("lm_serve", arch=cfg.name, prefill_s=round(prefill_s, 6),
        prefill_tokens_per_s=B * T / prefill_s, prefill_flops=flops,
        prefill_flop_bound_s=prefill_bound_s,
        prefill_bound_share=prefill_bound_s / prefill_s,
        flop_rate="989e12 bf16 dense (H100 SXM data sheet)")
    log("lm_serve", arch=cfg.name, decode_steps=new,
        decode_ms_median=med, decode_ms_min=min(step_ms),
        decode_ms_max=max(step_ms), decode_tokens_per_s=B / (med / 1e3),
        decode_wall_s=round(decode_s, 6),
        decode_bytes=weight_bytes + kv_bytes, kv_bytes_read=kv_bytes,
        decode_bound_ms=decode_bound_ms, stream_bytes_per_s=rate,
        decode_bound_share=decode_bound_ms / med,
        decode_bound_ms_3_35=(weight_bytes + kv_bytes) / HBM_BYTES_PER_S
        * 1e3, generate_s=round(generate_s, 6),
        generate_tokens_per_s=B * (new + 1) / generate_s)
    log("lm_serve", arch=cfg.name, memory_allocated_before=before,
        max_memory_allocated=peak, serving_peak_bytes=peak - before,
        weight_bytes=weight_bytes, cache_bytes=kv_bytes)
    log_roofline("lm_serve", cfg, "prefill", flops, prefill_s, B * T)
    # a decode step: the prefill of one token, and its attention over the
    # T positions before it
    step_flops = (lm_flops_prefill(cfg, params, B, 1) + 4 * B * cfg.n_heads
                  * cfg.head_dim * T * cfg.n_layers)
    log_roofline("lm_serve", cfg, "decode", step_flops, med / 1e3, B,
                 cache_bytes=kv_bytes)

    # (c) one prefill and one decode step (rewriting the last position)
    # under the profiler
    profiled(torch, lambda: prefill(params, tokens), host_ops=10,
             lm=cfg.name, step="prefill")
    _, busy = profiled(torch, lambda: decode(params, cache, tok,
                                             max_len - 1),
                       host_ops=10, lm=cfg.name, step="decode")
    log("lm_serve", arch=cfg.name, decode_busy_ms=busy * 1e3,
        layers=cfg.n_layers)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()


def moe_flops_prefill(cfg, params, batch: int, seq: int, slots: int) -> int:
    """``lm_flops_prefill`` for a MoE model whose routed experts compute
    ``slots`` (token, expert) rows a layer: attention, router, shared
    experts and logits as there, the routed experts' three matmuls once
    per slot."""
    def weights(tree):
        return sum(weights(v) if isinstance(v, dict) else
                   (v.numel() if k == "router" or (
                       k.startswith("w") and not k.startswith("we_"))
                    else 0)
                   for k, v in tree.items())
    visible = seq * (seq + 1) // 2
    attn = 4 * batch * cfg.n_heads * cfg.head_dim * visible * cfg.n_layers
    experts = 2 * 3 * cfg.d_model * cfg.moe.d_ff_expert * slots * cfg.n_layers
    return (2 * weights(params["stage"]) * batch * seq + attn + experts
            + 2 * batch * cfg.d_model * cfg.vocab_padded)


def tree_bytes(L, tree):
    """(elements, bytes) of a tree of tensors."""
    leaves = []
    L.tree_map(leaves.append, tree)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def cut_depth(L, cfg, params, repeats: int, dtype=None):
    """The model of the first ``repeats`` stage repeats (the tail kept),
    its params views or, with ``dtype``, copies in that dtype."""
    cast = (lambda t: t.to(dtype)) if dtype is not None else (lambda t: t)
    p = {k: L.tree_map(lambda t: cast(t[:repeats]), v) if k == "stage"
         else L.tree_map(cast, v) for k, v in params.items()}
    return dataclasses.replace(cfg, repeats=repeats), p


def moe_drops(torch, cfg, seen, n_tokens: int, rows: int) -> dict:
    """Dropped (token, expert) pairs over the MoE layers whose choices
    ``seen`` holds, at the capacity ``_moe_capacity`` gives
    ``n_tokens``."""
    from repro_torch.models import lm as LM
    cap = LM._moe_capacity(cfg, n_tokens)
    per = [dropped_pairs(torch, idx, cap, cfg.moe.n_routed, rows)
           for idx in seen]
    return {"capacity": cap, "moe_layers": len(per),
            "routed_pairs": n_tokens * cfg.moe.topk * len(per),
            "dropped_pairs": sum(d for d, _ in per),
            "dropped_max_layer": max(d for d, _ in per),
            "dropped_at_last_position": sum(d for _, d in per)}


def consistency_f32(torch, cfg, params, tokens, tok, check_repeats) -> None:
    """The reference's prefill/decode consistency at its tolerance, in
    float32 (the caches stay bf16) over the first ``check_repeats``
    repeats: decode of ``tok`` at T from the prefill cache against
    ``lm_forward`` over the prompt and ``tok``, at T."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    from repro_torch.serve import engine as S
    B, T = tokens.shape
    c32, p32 = cut_depth(L, cfg, params, check_repeats, torch.float32)
    prefill, decode, init_cache = S.make_serve_fns(c32, batch=B,
                                                   max_len=T + 1,
                                                   device="cuda")
    _, pcache = prefill(p32, tokens)
    cache = S.place_prefill_cache(c32, pcache, init_cache(), T)
    del pcache
    step, _ = decode(p32, cache, tok, T)
    del cache
    seq = torch.cat([torch.as_tensor(tokens, device="cuda"), tok], dim=1)
    with torch.inference_mode(), routed(MOE) as seen:
        full = LM.lm_forward(p32, seq, c32, last_only=True)
    drops = moe_drops(torch, c32, seen, B * (T + 1), B) if seen else {}
    del p32
    lm_agree("family_consistency_f32", step[:, -1], full[:, -1],
             LM_F32_OUTSIDE.get(cfg.name, 0.0), arch=cfg.name, position=T,
             layers=c32.n_layers, of_layers=cfg.n_layers, **drops)


def family_bf16_limits(arch: str, d: dict) -> None:
    """Hold a full-width bf16 decode against its bf16 forward (``lm_diff``)
    to ``arch``'s LM_FAMILY_BF16 limits and top-1 >= LM_TOP1."""
    outside, mean, most = LM_FAMILY_BF16[arch]
    faults = [f"{key} {d[key]} > {limit}" for key, limit in (
        ("outside_tol", outside), ("mean_abs_diff", mean),
        ("max_abs_diff", most)) if d[key] > limit]
    if d["top1"] < LM_TOP1:
        faults.append(f"top-1 {d['top1']} < {LM_TOP1}")
    if faults:
        raise AssertionError(f"{arch}: bf16 decode vs forward: "
                             + "; ".join(faults))


def phase_lm_family(torch, arch: str, seed: int, rate: float, *,
                    repeats=None, check_repeats=None) -> None:
    """(d)/(e) One decoder-only config at full width (and depth, unless
    ``repeats`` cuts it): bf16 params from --seed on the card, batch 8,
    512-token prompts, prefill then LM_NEW greedy decode steps; the
    float32 consistency check over ``check_repeats`` repeats (all by
    default); bf16 decode at T against the bf16 forward, held to the
    LM_FAMILY_BF16 limits; walls, bounds, memory, a profile of each step.
    A MoE config also logs the pairs its capacity dropped at prefill and
    the two FLOP bounds."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    from repro_torch.serve import engine as S
    cfg = configs.get(arch)
    of_layers = cfg.n_layers
    if repeats is not None:
        cfg = dataclasses.replace(cfg, repeats=repeats)
    B, T, new, max_len = LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = L.init_params(LM.lm_spec(cfg), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params, weight_bytes = tree_bytes(L, params)
    log("lm_serve", arch=arch, layers=cfg.n_layers, of_layers=of_layers,
        cut=("full depth" if cfg.n_layers == of_layers else
             f"depth {cfg.n_layers} of {of_layers} layers"),
        d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv}",
        d_ff=cfg.d_ff, vocab=cfg.vocab, params=n_params,
        weight_bytes=weight_bytes, init_s=round(time.perf_counter() - t0, 3),
        batch=B, prompt=T, new_tokens=new, max_len=max_len)
    tokens, _ = lm_prompt(cfg, B, T, seed)
    prefill, decode, init_cache = S.make_serve_fns(cfg, batch=B,
                                                   max_len=max_len,
                                                   device="cuda")
    # warm-up at the same shapes, the router's choices recorded
    with routed(MOE) as seen:
        logits, pcache = prefill(params, tokens)
    if seen:
        log("lm_serve", arch=arch, check="prefill_capacity",
            **moe_drops(torch, cfg, seen, B * T, B))
    cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
    decode(params, cache, logits[:, -1].argmax(-1, keepdim=True), T)
    del logits, pcache, cache, seen
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    logits, pcache = prefill(params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
    del pcache
    tok = logits[:, -1].argmax(-1, keepdim=True)
    toks = [tok]
    finite = torch.isfinite(logits).all()
    pos = torch.full((1,), T, dtype=torch.long, device="cuda")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(new + 1)]
    events[0].record()
    for i in range(new):
        step, cache = decode(params, cache, tok, pos)
        events[i + 1].record()
        if i == 0:
            first = step
        finite &= torch.isfinite(step).all()
        tok = step[:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        pos += 1
    torch.cuda.synchronize()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(new)]
    peak = torch.cuda.max_memory_allocated()
    if not bool(finite):
        raise AssertionError(f"{arch}: a logit is not finite")
    out = torch.cat(toks, dim=1)
    if not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: a greedy token outside the vocab")
    _, cache_bytes = tree_bytes(L, cache)

    consistency_f32(torch, cfg, params, tokens, out[:, :1],
                    check_repeats or cfg.repeats)
    seq = torch.cat([torch.as_tensor(tokens, device="cuda"), out[:, :1]], 1)
    with torch.inference_mode():
        full_t = LM.lm_forward(params, seq, cfg, last_only=True)
    family_bf16_limits(arch, lm_diff(
        "family_consistency_bf16", first[:, -1], full_t[:, -1], arch=arch,
        position=T, layers=cfg.n_layers))
    del full_t

    med = float(np.median(step_ms))
    decode_bound_ms = (weight_bytes + cache_bytes) / rate * 1e3
    log("lm_serve", arch=arch, prefill_s=round(prefill_s, 6),
        prefill_tokens_per_s=B * T / prefill_s)
    if cfg.moe is not None:
        for work, slots in (("routed_topk", B * T * cfg.moe.topk),
                            ("capacity_buffers", cfg.moe.n_routed
                             * LM._moe_capacity(cfg, B * T))):
            flops = moe_flops_prefill(cfg, params, B, T, slots)
            bound_s = flops / BF16_FLOPS_PER_S
            log("lm_serve", arch=arch, flop_bound=work,
                expert_slots_per_layer=slots, prefill_flops=flops,
                prefill_flop_bound_s=bound_s,
                prefill_bound_share=bound_s / prefill_s,
                flop_rate="989e12 bf16 dense (H100 SXM data sheet)")
    log("lm_serve", arch=arch, decode_steps=new, decode_ms_median=med,
        decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
        decode_tokens_per_s=B / (med / 1e3),
        decode_bytes=weight_bytes + cache_bytes, cache_bytes=cache_bytes,
        decode_bound_ms=decode_bound_ms, stream_bytes_per_s=rate,
        decode_bound_share=decode_bound_ms / med)
    log("lm_serve", arch=arch, memory_allocated_before=before,
        max_memory_allocated=peak, serving_peak_bytes=peak - before,
        weight_bytes=weight_bytes)
    short = LM_PROFILE_PROMPT.get(arch, T)
    profiled(torch, lambda: prefill(params, tokens[:, :short]), host_ops=5,
             lm=arch, step="prefill", prompt=short)
    profiled(torch, lambda: decode(params, cache, tok, max_len - 1),
             host_ops=5, lm=arch, step="decode")
    del params, cache, logits, first, step
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_encdec(torch, seed: int, rate: float) -> None:
    """(e) seamless-m4t-medium at full width and depth (12 + 12 layers):
    encode LM_PROMPT random frames, fill_cross_cache, then LM_NEW
    greedy decode steps from LM_START_TOKEN; the reference's enc-dec
    consistency (teacher-forced decode against encdec_forward, every
    position) in float32, and in bf16 held to the LM_FAMILY_BF16 limits;
    walls, memory, a profile of each."""
    from repro_torch import configs
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    arch = configs.ENCDEC_IDS[0]
    cfg = configs.get(arch)
    B, T, new = LM_BATCH, LM_PROMPT, LM_NEW
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = L.init_params(ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec),
                           generator=torch.Generator(
                               device="cuda").manual_seed(seed))
    n_params, weight_bytes = tree_bytes(L, params)
    frames = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)).to("cuda", torch.bfloat16)
    log("lm_serve", arch=arch, layers=f"{cfg.n_enc}+{cfg.n_dec}",
        cut="full depth", d_model=cfg.d_model, heads=cfg.n_heads,
        d_ff=cfg.d_ff, vocab=cfg.vocab, vocab_padded=cfg.vocab_padded,
        params=n_params, weight_bytes=weight_bytes, batch=B, frames=T,
        new_tokens=new)
    encdec_greedy(torch, cfg, params, frames, 2, new)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        enc = ED.encode(params, frames, cfg)
        cache = ED.init_encdec_cache(cfg, cfg.n_dec, B, new, T, device="cuda")
        ED.fill_cross_cache(params, enc, cache, cfg)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = torch.full((B, 1), LM_START_TOKEN, dtype=torch.long,
                         device="cuda")
        pos = torch.zeros(1, dtype=torch.long, device="cuda")
        fed, steps = [], []
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(new + 1)]
        events[0].record()
        for i in range(new):
            fed.append(tok)
            lg, cache = ED.encdec_decode_step(params, cache, tok, pos, cfg)
            events[i + 1].record()
            steps.append(lg)
            tok = lg[:, -1].argmax(-1, keepdim=True)
            pos += 1
        torch.cuda.synchronize()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(new)]
    peak = torch.cuda.max_memory_allocated()
    logits, fed = torch.cat(steps, 1), torch.cat(fed, 1)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: a logit is not finite")
    _, cache_bytes = tree_bytes(L, cache)

    # the reference's enc-dec check in float32: decode teacher-forced on
    # the same tokens from position 0 against encdec_forward
    p32 = L.tree_map(lambda t: t.float(), params)
    f32 = frames.float()
    _, _, dec32 = encdec_greedy(torch, cfg, p32, f32, new, new,
                                tokens=fed[:, 1:])
    with torch.inference_mode():
        full32 = ED.encdec_forward(p32, f32, fed, cfg)
    del p32
    lm_agree("encdec_consistency_f32", dec32, full32, arch=arch,
             positions=new, layers=f"{cfg.n_enc}+{cfg.n_dec}")
    del dec32, full32
    with torch.inference_mode():
        full_t = ED.encdec_forward(params, frames, fed, cfg)
    family_bf16_limits(arch, lm_diff("encdec_consistency_bf16", logits,
                                     full_t, arch=arch, positions=new))
    del full_t

    med = float(np.median(step_ms))
    decode_bound_ms = (weight_bytes + cache_bytes) / rate * 1e3
    log("lm_serve", arch=arch, prefill="encode + fill_cross_cache",
        prefill_s=round(prefill_s, 6), frames_per_s=B * T / prefill_s)
    log("lm_serve", arch=arch, decode_steps=new, decode_ms_median=med,
        decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
        decode_tokens_per_s=B / (med / 1e3),
        decode_bytes=weight_bytes + cache_bytes, cache_bytes=cache_bytes,
        decode_bound_ms=decode_bound_ms,
        decode_bound_share=decode_bound_ms / med)
    log("lm_serve", arch=arch, memory_allocated_before=before,
        max_memory_allocated=peak, serving_peak_bytes=peak - before,
        weight_bytes=weight_bytes)

    def encode_fill():
        with torch.inference_mode():
            ED.fill_cross_cache(params, ED.encode(params, frames, cfg),
                                cache, cfg)

    def one_step():
        with torch.inference_mode():
            ED.encdec_decode_step(params, cache, tok, new - 1, cfg)
    profiled(torch, encode_fill, host_ops=5, lm=arch, step="prefill")
    profiled(torch, one_step, host_ops=5, lm=arch, step="decode")
    del params, cache, logits, frames, enc
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_serve(torch, seed: int, rate: float) -> None:
    """The lm_serve phase: (a) every reduced config; qwen3-4b's (b) and
    (c); (d) deepseek-moe-16b at full width and depth; (e) each other
    family at full width. Each part's wall is logged."""
    parts = [("reduced", lambda: phase_lm_reduced(torch, seed)),
             (LM_ARCH, lambda: phase_lm_full(torch, seed, rate)),
             (LM_MOE_ARCH, lambda: phase_lm_family(
                 torch, LM_MOE_ARCH, seed, rate,
                 check_repeats=LM_MOE_CHECK_REPEATS))]
    parts += [(arch, lambda a=arch, r=repeats, c=check: phase_lm_family(
        torch, a, seed, rate, repeats=r, check_repeats=c))
        for arch, repeats, check in LM_FAMILIES]
    parts.append(("seamless-m4t-medium",
                  lambda: phase_lm_encdec(torch, seed, rate)))
    for name, run in parts:
        t0 = time.perf_counter()
        run()
        log("lm_serve", part=name, wall_s=round(time.perf_counter() - t0, 3))


@contextlib.contextmanager
def exact_float32(L, MOE):
    """``grad_cast_bf16`` as the identity inside the block (the layers
    module and the MoE module, which imports it by name): a float32 step
    then rounds no cotangent to bf16, as the CPU parity tests run it."""
    saved = L.grad_cast_bf16, MOE.grad_cast_bf16
    L.grad_cast_bf16 = MOE.grad_cast_bf16 = lambda x: x
    try:
        yield
    finally:
        L.grad_cast_bf16, MOE.grad_cast_bf16 = saved


def train_batch(cfg, batch: int, seq: int, seed: int, step: int = 0):
    """SyntheticTokens' batch ``step`` for ``cfg`` (the data of --seed) and
    the family's stub embeddings, float32, drawn from --seed."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    b = SyntheticTokens(DataConfig(vocab=cfg.vocab, global_batch=batch,
                                   seq_len=seq, seed=seed)).batch(step)
    rng = np.random.default_rng([seed, step])
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (batch, cfg.prefix_len, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((batch, seq, cfg.d_model),
                                          dtype=np.float32)
    return b


def phase_train_reduced(torch, seed: int) -> None:
    """(a) One float32 train step of every reduced config on the card
    against the port's CPU step from the same params and batch: the loss,
    the grad norm and every gradient at the CPU tests' tolerance."""
    from repro_torch import configs
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import clip_by_global_norm
    B, S = TRAIN_SMALL
    with exact_float32(L, MOE):
        for arch in configs.ARCH_IDS:
            cfg = configs.get(arch, reduced=True)
            spec = (ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
                    if cfg.family == "encdec" else LM.lm_spec(cfg))
            cpu = L.tree_map(lambda t: t.float(), L.init_params(
                spec, generator=torch.Generator().manual_seed(seed)))
            batch = train_batch(cfg, B, S, seed)
            runs = {}
            for dev in ("cpu", "cuda"):
                params = L.tree_map(lambda t: t.to(dev), cpu)
                loss, grads = TL.value_and_grad(
                    TL.make_loss(cfg), params, TL.batch_on(batch, dev))
                _, gnorm = clip_by_global_norm(
                    L.tree_map(lambda g: g.clone(), grads), 1.0)
                runs[dev] = (loss, gnorm, grads)
            tol = TRAIN_F32_LOOSE.get(arch, TRAIN_F32)
            (loss, gnorm, grads), (l0, n0, g0) = runs["cuda"], runs["cpu"]
            on = {loss.device.type, gnorm.device.type}
            worst = 0.0
            for got, want in zip(L.leaves(grads), L.leaves(g0)):
                on.add(got.device.type)
                got, want = got.cpu().numpy(), want.numpy()
                worst = max(worst, float(np.abs(got - want).max()))
                np.testing.assert_allclose(got, want, **tol,
                                           err_msg=f"{arch} gradient")
            if on != {"cuda"}:
                raise AssertionError(f"{arch}: tensors on {on}")
            for name, a, b in (("loss", loss, l0), ("grad_norm", gnorm, n0)):
                np.testing.assert_allclose(float(a), float(b), **tol,
                                           err_msg=f"{arch} {name}")
            log("train", arch=arch, check="reduced_f32_card_vs_cpu",
                loss=float(loss), loss_cpu=float(l0),
                grad_norm=float(gnorm), grad_norm_cpu=float(n0),
                grad_max_abs_diff=worst, leaves=len(L.leaves(grads)), **tol)


def lm_flops_train(cfg, params, batch: int, seq: int) -> tuple:
    """A remat training step's multiply-adds (x2), from a prefill with
    every position's logits: (the model's, 3 x: the forward and the
    backward at twice the forward; the hardware's, 4 x: those and the
    forward that remat recomputes)."""
    fwd = lm_flops_prefill(cfg, params, batch, seq, every_position=True)
    return 3 * fwd, 4 * fwd


def phase_train_full(torch, seed: int) -> None:
    """(b) qwen3-4b at full width and depth: TRAIN_STEPS timed AdamW steps
    after a warm-up, one of them profiled, and microbatch=2 against the
    unsplit step."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             clip_by_global_norm)
    cfg = configs.get(TRAIN_ARCH)
    if not cfg.remat:
        raise AssertionError("the full config trains with remat")
    B, S = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = L.init_params(LM.lm_spec(cfg), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    state = adamw_init(params)
    torch.cuda.synchronize()
    n_params, param_bytes = tree_bytes(L, params)
    _, moment_bytes = tree_bytes(L, {"m": state.m, "v": state.v})
    oc = AdamWConfig(**TRAIN_OPT)
    step_fn = TL.make_train_step(cfg, oc)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, global_batch=B,
                                      seq_len=S, seed=seed))
    # matrix entries (|w| ~ 0.01-0.02, a bf16 ulp ~1e-4) move by ~lr a
    # step; a norm's 1.0 (ulp 2^-7) does not move at this lr
    def watched(p):
        return (p["stage"]["0"]["mlp"]["w_down"][0, :8],
                p["stage"]["0"]["attn"]["wq"][0, :8])
    watch = [t.clone() for t in watched(params)]
    log("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        params=n_params, param_bytes=param_bytes, moment_bytes=moment_bytes,
        dtype=str(params["embed"].dtype), remat=cfg.remat,
        init_s=round(time.perf_counter() - t0, 3), batch=B, seq=S,
        tokens_per_step=B * S, opt=json.dumps(TRAIN_OPT))

    t0 = time.perf_counter()
    params, state, m = step_fn(params, state, data.batch(0), 0)
    torch.cuda.synchronize()
    log("train", arch=cfg.name, warmup_step_s=round(time.perf_counter() - t0,
                                                     6),
        loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    torch.cuda.reset_peak_memory_stats()
    walls, losses, norms = [], [float(m["loss"])], [float(m["grad_norm"])]
    for step in range(1, TRAIN_STEPS + 1):
        batch = data.batch(step)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, step)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        log("train", arch=cfg.name, step=step, step_s=round(walls[-1], 6),
            loss=losses[-1], grad_norm=norms[-1])
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"loss or grad norm not finite: {losses} "
                             f"{norms}")
    if not losses[-1] <= TRAIN_LOSS_RATIO * losses[0]:
        raise AssertionError(f"the loss did not fall to {TRAIN_LOSS_RATIO}"
                             f" of the first: {losses}")
    for now, was in zip(watched(params), watch):
        if torch.equal(now, was):
            raise AssertionError("the params did not move")
    med = float(np.median(walls))
    model_flops, hw_flops = lm_flops_train(cfg, params, B, S)
    model_s, hw_s = (model_flops / BF16_FLOPS_PER_S,
                     hw_flops / BF16_FLOPS_PER_S)
    log("train", arch=cfg.name, steps=TRAIN_STEPS, step_s_median=med,
        step_s_min=min(walls), step_s_max=max(walls),
        tokens_per_s=B * S / med, model_step_flops=model_flops,
        model_flop_bound_s=model_s, model_flop_share=model_s / med,
        remat_step_flops=hw_flops, remat_flop_bound_s=hw_s,
        remat_flop_share=hw_s / med,
        flop_rate="989e12 bf16 dense (H100 SXM data sheet)",
        loss_first=losses[0], loss_last=losses[-1],
        loss_ratio=losses[-1] / losses[0])
    log_roofline("train", cfg, "train", hw_flops, med, B * S)
    log("train", arch=cfg.name, memory_allocated_before=before,
        max_memory_allocated=peak, training_peak_bytes=peak - before,
        state_bytes=param_bytes + moment_bytes,
        total_memory=torch.cuda.get_device_properties(0).total_memory)

    # (b') one step under the profiler
    step = TRAIN_STEPS + 1
    batch = data.batch(step)
    (params, state, m), busy = profiled(
        torch, lambda: step_fn(params, state, batch, step), host_ops=10,
        train=cfg.name, step="train")
    log("train", arch=cfg.name, profiled_step_busy_s=busy,
        loss=float(m["loss"]))

    # (b'') microbatch=2 against the unsplit step, from the same state
    step += 1
    batch = data.batch(step)
    loss, grads = TL.value_and_grad(TL.make_loss(cfg), params,
                                    TL.batch_on(batch, "cuda"))
    _, gnorm = clip_by_global_norm(grads, oc.clip_norm)
    loss, gnorm = float(loss), float(gnorm)
    del grads
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, m = TL.make_train_step(cfg, oc, microbatch=TRAIN_MB)(
        params, state, batch, step)
    torch.cuda.synchronize()
    mb_s = time.perf_counter() - t0
    mb_loss, mb_norm = float(m["loss"]), float(m["grad_norm"])
    log("train", arch=cfg.name, check="microbatch", microbatch=TRAIN_MB,
        step_s=round(mb_s, 6), loss=mb_loss, loss_unsplit=loss,
        grad_norm=mb_norm, grad_norm_unsplit=gnorm,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    if abs(mb_loss - loss) > TRAIN_MB_LOSS_ATOL:
        raise AssertionError(f"microbatch loss {mb_loss} against {loss}")
    if abs(mb_norm - gnorm) > TRAIN_MB_GNORM_RTOL * gnorm:
        raise AssertionError(f"microbatch grad norm {mb_norm} against "
                             f"{gnorm}")
    del params, state, m
    gc.collect()
    torch.cuda.empty_cache()


def _bits(torch, t):
    """A tensor's raw bits, as an integer tensor of its width."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def phase_train_checkpoint(torch, seed: int) -> None:
    """(c) The checkpoint round trip on the card at a depth cut: save the
    state after one step, restore it onto the card and compare bit for
    bit; then a Trainer killed at step 2 resumes from its step-0
    checkpoint and reaches the end. Written under the git-ignored
    build/."""
    import shutil
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              repeats=TRAIN_CKPT_REPEATS)
    oc = AdamWConfig(**TRAIN_OPT)
    params = L.init_params(LM.lm_spec(cfg), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    state = adamw_init(params)
    params, state, _ = TL.make_train_step(cfg, oc)(
        params, state, train_batch(cfg, 2, 128, seed), 0)
    tree = {"params": params, "opt": state}
    _, nbytes = tree_bytes(L, {"params": params, "m": state.m, "v": state.v})
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    log("train", check="checkpoint", layers=cfg.n_layers, state_bytes=nbytes,
        disk_free_bytes=free, path=str(root.relative_to(ROOT)))
    if free < 4 * nbytes:
        raise AssertionError(f"{free} B free, the checkpoints need "
                             f"{4 * nbytes}")
    t0 = time.perf_counter()
    CKPT.save(str(root / "explicit"), 1, tree, extra={"arch": cfg.name})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, meta = CKPT.restore_latest(str(root / "explicit"), tree,
                                    device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    pairs = list(zip(L.leaves(got["params"]) + L.leaves(got["opt"].m)
                     + L.leaves(got["opt"].v) + [got["opt"].count],
                     L.leaves(params) + L.leaves(state.m)
                     + L.leaves(state.v) + [state.count]))
    for a, b in pairs:
        if (a.device.type != "cuda" or a.dtype != b.dtype
                or not torch.equal(_bits(torch, a), _bits(torch, b))):
            raise AssertionError("a restored leaf differs from the saved")
    log("train", check="checkpoint_round_trip", leaves=len(pairs),
        step=meta["step"], save_s=round(save_s, 3),
        restore_s=round(restore_s, 3), bit_equal=True)
    del got, tree, params, state, pairs
    shutil.rmtree(root / "explicit")

    tc = TL.TrainConfig(steps=3, ckpt_every=2, ckpt_dir=str(root / "trainer"),
                        log_every=1, seed=seed)
    args = (cfg, DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=128,
                            seed=seed), oc, tc)
    try:
        TL.Trainer(*args, device="cuda").run(fail_at_step=2)
    except RuntimeError as e:          # the injected crash, nothing else
        if "injected failure at step 2" not in str(e):
            raise
    else:
        raise AssertionError("the injected failure did not happen")
    out = TL.Trainer(*args, device="cuda").run()
    steps = [s for s, _ in out["losses"]]
    kept = sorted(d.name for d in (root / "trainer").iterdir()
                  if d.name.startswith("step_"))
    log("train", check="kill_and_resume", resumed_steps=steps,
        losses=[round(l, 6) for _, l in out["losses"]], kept=kept,
        final_step=out["final_step"])
    if (steps != [1, 2] or out["final_step"] != 2
            or not np.isfinite([l for _, l in out["losses"]]).all()
            or kept != ["step_00000000", "step_00000002"]):
        raise AssertionError("the resumed trainer did not run steps 1-2 "
                             "from the step-0 checkpoint")
    del out
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(torch, seed: int) -> None:
    """The train phase: (a) every reduced config's float32 step, card
    against CPU; (b) qwen3-4b at full width and depth; (c) checkpoints on
    the card. Each part's wall is logged."""
    for name, run in (("reduced", phase_train_reduced),
                      (TRAIN_ARCH, phase_train_full),
                      ("checkpoint", phase_train_checkpoint)):
        t0 = time.perf_counter()
        run(torch, seed)
        log("train", part=name, wall_s=round(time.perf_counter() - t0, 3))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_lm_shard(torch, seed: int, rate: float) -> int:
    """The lm_shard phase (a)-(d). Returns K2's launches on its graph
    path."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", SHARD_MESH[0],
                                mesh_dim_names=SHARD_MESH[1])
        log("lm_shard", backend=dist.get_backend(),
            world=dist.get_world_size(), mesh=repr(SHARD_MESH))
        k2 = None
        parts = [("train", shard_train), ("serve", shard_serve)]
        parts += [(arch, lambda t, m, sd, r, a=arch, n=n: shard_serve_exact(
            t, m, sd, a, n)) for arch, n in SHARD_FAMILIES]
        for name, run in parts + [("graph", shard_graph)]:
            t0 = time.perf_counter()
            got = run(torch, mesh, seed, rate)
            if name == "graph":
                k2 = got
            log("lm_shard", part=name, wall_s=round(time.perf_counter() - t0,
                                                    3))
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    shard_probe()
    log("lm_shard", part="probe", wall_s=round(time.perf_counter() - t0, 3))
    return k2


def shard_specs(SH, L, mesh, params, spec):
    return SH.param_sharding_rules(mesh, params, L.axes_tree(spec))


def shard_train(torch, mesh, seed: int, rate: float) -> None:
    """(a) qwen3-4b training, mesh=None then the mesh, from the same
    params and batches."""
    from repro_torch import configs
    from repro_torch import sharding as SH
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    cfg = configs.get(TRAIN_ARCH)
    spec = LM.lm_spec(cfg)
    oc = AdamWConfig(**TRAIN_OPT)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab,
                                      global_batch=TRAIN_BATCH,
                                      seq_len=TRAIN_SEQ, seed=seed))
    runs = {}
    for name, on in (("none", None), ("mesh", mesh)):
        params = L.init_params(spec, generator=torch.Generator(
            device="cuda").manual_seed(seed))
        if on is not None:
            params = SH.place_tree(on, params,
                                   shard_specs(SH, L, on, params, spec))
            if not all(SH.is_dtensor(t) for t in L.leaves(params)):
                raise AssertionError("a param is not a DTensor")
        state = adamw_init(params)
        step_fn = TL.make_train_step(cfg, oc, on)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses, norms = [], [], []
        for step in range(SHARD_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, data.batch(step), step)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated()
        step = SHARD_TRAIN_STEPS
        batch = data.batch(step)
        res, busy = profiled(torch, lambda: step_fn(params, state, batch,
                                                    step),
                             host_ops=8, lm_shard=cfg.name, step="train",
                             mesh=name)
        runs[name] = (losses, norms)
        log("lm_shard", arch=cfg.name, train_mesh=name, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, losses=json.dumps(losses),
            grad_norms=json.dumps(norms),
            step_s=json.dumps([round(w, 6) for w in walls]),
            step_s_after_first=float(np.median(walls[1:])),
            max_memory_allocated=peak, profiled_busy_s=busy)
        del params, state, m, res
        gc.collect()
        torch.cuda.empty_cache()
    (l0, n0), (l1, n1) = runs["none"], runs["mesh"]
    log("lm_shard", arch=cfg.name, check="train_mesh_vs_none",
        loss_equal=l0 == l1, grad_norm_equal=n0 == n1,
        max_loss_diff=max(abs(a - b) for a, b in zip(l0, l1)),
        max_grad_norm_rel=max(abs(a - b) / b for a, b in zip(n1, n0)))
    if l0 != l1 or n0 != n1:
        raise AssertionError(f"mesh losses {l1} / norms {n1} against "
                             f"mesh=None's {l0} / {n0}")


def shard_serve(torch, mesh, seed: int, rate: float) -> None:
    """(b) deepseek-moe-16b serving, mesh=None then the mesh (teacher-
    forced with mesh=None's greedy tokens), from the same params."""
    from repro_torch import configs
    from repro_torch import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine as S
    arch = LM_MOE_ARCH
    cfg = configs.get(arch)
    spec = LM.lm_spec(cfg)
    B, T, new, max_len = LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN
    params = L.init_params(spec, generator=torch.Generator(
        device="cuda").manual_seed(seed))
    # the same storage: on one rank every block is the whole tensor
    placed = SH.place_tree(mesh, params, shard_specs(SH, L, mesh, params,
                                                     spec))
    tokens, _ = lm_prompt(cfg, B, T, seed)
    out = {}
    for name, on, p in (("none", None, params), ("mesh", mesh, placed)):
        prefill, decode, init_cache = S.make_serve_fns(
            cfg, on, batch=B, max_len=max_len, device="cuda")
        logits, pcache = prefill(p, tokens)          # warm-up
        cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
        decode(p, cache, S.greedy_token(logits), T)
        del logits, pcache, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, pcache = prefill(p, tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
        del pcache
        steps = [logits[:, -1]]
        toks = out["none"]["tokens"] if name == "mesh" else [
            S.greedy_token(logits)]
        pos = torch.full((1,), T, dtype=torch.long, device="cuda")
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(new + 1)]
        events[0].record()
        for i in range(new):
            step, cache = decode(p, cache, toks[i], pos)
            events[i + 1].record()
            steps.append(step[:, -1])
            if name == "none":
                toks.append(S.greedy_token(step))
            pos += 1
        torch.cuda.synchronize()
        step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(new)]
        steps = [t.full_tensor() if SH.is_dtensor(t) else t for t in steps]
        out[name] = {"tokens": toks, "logits": torch.stack(steps, 1)}
        log("lm_shard", arch=arch, serve_mesh=name, batch=B, prompt=T,
            new_tokens=new, prefill_s=round(prefill_s, 6),
            decode_ms_median=float(np.median(step_ms)),
            decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        profiled(torch, lambda: decode(p, cache, toks[0], max_len - 1),
                 host_ops=5, lm_shard=arch, step="decode", mesh=name)
        del logits, cache, step
        gc.collect()
    want, got = out["none"]["logits"], out["mesh"]["logits"]
    family_bf16_limits(arch, lm_diff("shard_serve_mesh_vs_none", got, want,
                                     arch=arch, positions=new + 1))
    chosen = torch.cat(out["none"]["tokens"], 1)            # (B, new + 1)
    near_argmax(torch, "shard_serve_tokens", got, chosen)
    same = float((got.argmax(-1) == chosen).float().mean())
    log("lm_shard", arch=arch, check="greedy_mesh_vs_none",
        equal_share=same, logits_equal=bool(torch.equal(got, want)))
    if same != 1.0:
        raise AssertionError(f"the mesh's greedy tokens differ from "
                             f"mesh=None's at {1 - same:.2%} of positions")
    del params, placed, out, want, got
    gc.collect()
    torch.cuda.empty_cache()


def shard_serve_exact(torch, mesh, seed: int, arch: str,
                      repeats=None) -> None:
    """(b') ``arch`` (its first ``repeats`` repeats where given) served
    on the mesh and with mesh=None from the same bf16 params: prefill and
    LM_NEW decode steps (the enc-dec: encode, the cross cache, decode
    from LM_START_TOKEN), the mesh's steps fed mesh=None's greedy tokens.
    Every logit must be bit-equal, so the greedy tokens too."""
    from repro_torch import configs
    from repro_torch import sharding as SH
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine as S
    cfg = configs.get(arch)
    if repeats is not None:
        cfg = dataclasses.replace(cfg, repeats=repeats)
    encdec = cfg.family == "encdec"
    spec = ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec) if encdec \
        else LM.lm_spec(cfg)
    B, T, new, max_len = LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN
    params = L.init_params(spec, generator=torch.Generator(
        device="cuda").manual_seed(seed))
    placed = SH.place_tree(mesh, params, shard_specs(SH, L, mesh, params,
                                                     spec))
    if encdec:
        frames = torch.from_numpy(np.random.default_rng(seed)
                                  .standard_normal((B, T, cfg.d_model))
                                  .astype(np.float32)).to("cuda",
                                                          torch.bfloat16)
    else:
        tokens, _ = lm_prompt(cfg, B, T, seed)
    out = {}
    for name, on, p in (("none", None, params), ("mesh", mesh, placed)):
        toks = out["none"]["tokens"] if name == "mesh" else None
        t0 = time.perf_counter()
        with torch.no_grad():
            if encdec:
                enc = ED.encode(p, frames, cfg, on)
                args = (cfg, cfg.n_dec, B, new, T)
                cache = ED.init_encdec_cache(*args, device="cuda")
                if on is not None:
                    cache = SH.place_tree(on, cache, SH.param_sharding_rules(
                        on, cache, ED.encdec_cache_axes(*args)))
                cache = ED.fill_cross_cache(p, enc, cache, cfg)
                tok = torch.full((B, 1), LM_START_TOKEN, dtype=torch.long,
                                 device="cuda")
                steps, fed = [], [tok]
                for i in range(new):
                    lg, cache = ED.encdec_decode_step(
                        p, cache, fed[i], torch.tensor([i], device="cuda"),
                        cfg, on)
                    steps.append(lg[:, -1])
                    if toks is None:
                        fed.append(lg[:, -1].argmax(-1, keepdim=True))
                    else:
                        fed.append(toks[i + 1])
            else:
                prefill, decode, init_cache = S.make_serve_fns(
                    cfg, on, batch=B, max_len=max_len, device="cuda")
                logits, pcache = prefill(p, tokens)
                cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
                del pcache
                steps = [logits[:, -1]]
                fed = [S.greedy_token(logits)] if toks is None else toks
                for i in range(new):
                    lg, cache = decode(p, cache, fed[i],
                                       torch.tensor([T + i], device="cuda"))
                    steps.append(lg[:, -1])
                    if toks is None:
                        fed.append(S.greedy_token(lg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = [t.full_tensor() if SH.is_dtensor(t) else t for t in steps]
        out[name] = {"tokens": toks if toks is not None else fed,
                     "logits": torch.stack(steps, 1)}
        log("lm_shard", arch=arch, serve_mesh=name,
            layers=(f"{cfg.n_enc}+{cfg.n_dec}" if encdec
                    else cfg.n_layers), batch=B, prompt=T, new_tokens=new,
            wall_s=round(wall, 6),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        del cache
        gc.collect()
    want, got = out["none"]["logits"], out["mesh"]["logits"]
    fed = torch.cat(out["none"]["tokens"], 1)
    chosen = fed[:, 1:] if encdec else fed
    same = float((got.argmax(-1) == chosen[:, :got.shape[1]])
                 .float().mean())
    equal = bool(torch.equal(got, want))
    log("lm_shard", arch=arch, check="serve_mesh_vs_none_exact",
        logits_equal=equal, greedy_equal_share=same,
        max_abs_diff=float((got.float() - want.float()).abs().max()),
        positions=got.shape[1])
    if not equal or same != 1.0:
        raise AssertionError(f"{arch}: the mesh's logits are not mesh="
                             f"None's (greedy equal at {same:.2%})")
    del params, placed, out, want, got
    gc.collect()
    torch.cuda.empty_cache()


def shard_graph(torch, mesh, seed: int, rate: float) -> int:
    """(c) ShardEngine on launch/mesh.py's graph mesh over the NCCL
    group, one BFS per exchange, against Engine. Returns K2's launches."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.engine import Engine
    from repro_torch.core.engine_shardmap import ShardEngine
    from repro_torch.core.mesh import ProcessGroupMesh
    from repro_torch.kernels import edge_gather
    from repro_torch.launch.mesh import make_graph_mesh
    gmesh = make_graph_mesh()
    if not isinstance(gmesh, ProcessGroupMesh) or gmesh.num_shards != 1:
        raise AssertionError(f"graph mesh {gmesh!r}")
    g = G.rmat(SHARD_GRAPH_SCALE, EDGE_FACTOR, seed=GRAPH_SEED,
               weighted=True).symmetrized()
    pg = PT.partition_graph(g, 1, method="greedy")
    root = int(np.flatnonzero(g.out_degrees() > 0)[0])
    want = Engine(ALG.bfs(), pg, tile_e=TILE_E, tile_r=TILE_R,
                  device="cuda").run(root=root)
    total = 0
    for exchange in EXCHANGES:
        eng = ShardEngine(ALG.bfs(), pg, mesh=gmesh, exchange=exchange,
                          tile_e=TILE_E, tile_r=TILE_R)
        edge_gather.windows_launches = 0
        got = eng.run(root=root)
        launched = edge_gather.windows_launches
        total += launched
        same_as_engine(got, want, f"lm_shard graph {exchange}")
        log("lm_shard", graph=f"rmat{SHARD_GRAPH_SCALE}", exchange=exchange,
            supersteps=got.supersteps, k2_launches=launched,
            comm=json.dumps(got.comm))
        del eng
        gc.collect()
    if total == 0:
        raise AssertionError("K2 was not launched on the graph mesh")
    return total


_PROBE = r"""
import json, sys, datetime
import torch, torch.distributed as dist
rank, backend, init = int(sys.argv[1]), sys.argv[2], sys.argv[3]
P = int(sys.argv[4])
def say(**kw):
    print("PROBE " + json.dumps(kw), flush=True)
torch.cuda.set_device(0)
try:
    dist.init_process_group(backend, init_method=init, world_size=P,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=30))
except Exception as e:
    say(init=f"{type(e).__name__}: {str(e)[:240]}")
    sys.exit(0)
x = torch.arange(2 * P, device="cuda", dtype=torch.float32) + 100 * rank
every = torch.stack([torch.arange(2 * P, device="cuda",
                                  dtype=torch.float32) + 100 * r
                     for r in range(P)])
def all_reduce():
    y = x.clone(); dist.all_reduce(y); return y, every.sum(0)
def all_gather_into_tensor():
    y = x.new_empty(P * 2 * P); dist.all_gather_into_tensor(y, x)
    return y, every.reshape(-1)
def reduce_scatter_tensor():
    y = x.new_empty(2); dist.reduce_scatter_tensor(y, x)
    return y, every.sum(0)[2 * rank:2 * rank + 2]
def all_to_all_single():
    y = torch.empty_like(x); dist.all_to_all_single(y, x)
    return y, every[:, 2 * rank:2 * rank + 2].reshape(-1)
def functional_all_gather():
    from torch.distributed import _functional_collectives as fc
    y = fc.all_gather_tensor(x, 0, dist.group.WORLD)
    return fc.wait_tensor(y), every.reshape(-1)
def dtensor_mesh_all_gather():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = init_device_mesh("cuda", (2, P // 2),
                            mesh_dim_names=("data", "model"))
    d = distribute_tensor(every, mesh, [Shard(0), Shard(1)],
                          src_data_rank=None)
    return d.full_tensor(), every
for fn in (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
           all_to_all_single, functional_all_gather,
           dtensor_mesh_all_gather):
    try:
        got, want = fn()
        torch.cuda.synchronize()
        say(**{fn.__name__: "ok" if torch.equal(got, want)
               else "wrong values"})
    except Exception as e:
        say(**{fn.__name__: f"{type(e).__name__}: {str(e)[:160]}"})
dist.destroy_process_group()
"""
# what DTensor's redistributes need of a backend
SHARD_PROBE_NEEDED = ("all_reduce", "all_gather_into_tensor",
                      "reduce_scatter_tensor", "functional_all_gather",
                      "dtensor_mesh_all_gather")


def shard_probe() -> dict:
    """(d) Whether SHARD_PROBE_RANKS processes that share the card can run
    what DTensor needs, per backend: each process's verdict on each
    collective (checked values), its error, or its exit code where it
    crashed. Returns {backend: whether every rank served every one}."""
    served = {}
    for backend in ("nccl", "gloo"):
        init = f"tcp://localhost:{free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-c", _PROBE, str(r), backend, init,
             str(SHARD_PROBE_RANKS)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for r in range(SHARD_PROBE_RANKS)]
        verdicts = []
        for p in procs:
            try:
                stdout, _ = p.communicate(timeout=SHARD_PROBE_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, _ = p.communicate()
            seen = {}
            for ln in stdout.splitlines():
                if ln.startswith("PROBE "):
                    seen.update(json.loads(ln[6:]))
            if p.returncode != 0:
                seen["exit"] = p.returncode
            verdicts.append(seen)
        served[backend] = all(d.get(c) == "ok" for d in verdicts
                              for c in SHARD_PROBE_NEEDED)
        log("lm_shard", probe=backend, ranks=SHARD_PROBE_RANKS,
            rank0=json.dumps(verdicts[0]),
            same_on_every_rank=all(d == verdicts[0] for d in verdicts),
            serves_dtensor=served[backend])
    return served


def profiled(torch, fn, host_ops: int = 0, **label):
    """Run ``fn`` once under torch.profiler and log its wall time, the
    device's busy time and idle share over that wall, its launches and
    the busiest kernels by self device time (and, with ``host_ops``, that
    many operators by self host time). Returns ``fn``'s result and the
    busy seconds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (the kernels and copies themselves): the
    # operators' own device totals would count each kernel twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in kernels) / 1e6
    log("profile", **label, wall_s=round(wall, 6),
        device_busy_s=round(busy, 6), idle_share=round(1 - busy / wall, 4),
        device_launches=sum(e.count for e in kernels))
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log("profile", **label, kernel=repr(e.key[:100]), calls=e.count,
            self_device_ms=round(dev_us(e) / 1e3, 4))
    if host_ops:
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU]
        log("profile", **label, host_ops=sum(e.count for e in ops),
            host_self_ms=round(sum(e.self_cpu_time_total for e in ops)
                               / 1e3, 4))
        for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:host_ops]:
            log("profile", **label, op=repr(e.key[:60]), calls=e.count,
                self_host_ms=round(e.self_cpu_time_total / 1e3, 4))
    return res, busy


def phase_profile(torch, kernel_engine, root: int, **label) -> dict:
    """Where a superstep's device time goes: one BFS, one WCC and one
    PageRank run through ``profiled``. Returns each algorithm's (edges
    traversed, device-busy seconds)."""
    busy = {}
    for name, kwargs in (("bfs", {"root": root}), ("wcc", {}),
                         ("pagerank", {})):
        eng = kernel_engine(name)
        res, busy_s = profiled(torch, lambda: eng.run(**kwargs), **label,
                               algorithm=name)
        busy[name] = (res.messages, busy_s)
    return busy


def fitted_cpe(busy) -> None:
    """Each algorithm's cycles per edge fitted again from phase 6's
    device-busy time (``perfmodel.h100_algo``), held against the
    H100_ALGOS constant."""
    from repro_torch.core import perfmodel
    for name, (edges, busy_s) in busy.items():
        algo = perfmodel.H100_ALGOS[name]
        fit = perfmodel.h100_algo(name, busy_s=busy_s, edges=edges,
                                  m_vertex=algo.m_vertex)
        log("projection", algorithm=name, edges=edges, busy_s=busy_s,
            busy_s_per_edge=busy_s / edges)
        against(f"{name} cpe (SM cycles per edge)", fit.cpe, algo.cpe)


def project(g, runs, **label) -> None:
    """Measured TEPS of each run ((algorithm, entry, messages, wall s))
    beside perfmodel.limits on the H100 profile at n_nodes=1 (one card),
    and the efficiency TEPS / T_sys (the paper's measured over
    projected)."""
    from repro_torch.core import perfmodel
    wl = perfmodel.Workload(g.num_vertices, g.num_edges)
    for name, entry, messages, wall in runs:
        if name not in perfmodel.H100_ALGOS:
            continue
        lim = perfmodel.limits(perfmodel.H100, perfmodel.H100_ALGOS[name],
                               wl, n_nodes=1)
        teps = messages / wall
        log("projection", **label, algorithm=name, entry=entry,
            teps=teps, L_PE=lim["L_PE"], L_mem=lim["L_mem"],
            T_sys=lim["T_sys"], bottleneck=lim["bottleneck"],
            efficiency=teps / lim["T_sys"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails here outside a checkout)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", kind=repr(kind), count=torch.cuda.device_count(),
        nvidia_smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda)
    rate = phase_platform(torch)
    args = sys.argv[1:]
    seed = int(args[args.index("--seed") + 1]) if "--seed" in args else 0
    if "--lm" in args:
        phase_lm_serve(torch, seed, rate)
        return 0
    if "--train" in args:
        phase_train(torch, seed)
        return 0
    if "--shard" in args:
        phase_lm_shard(torch, seed, rate)
        return 0
    phase_build()
    if "--examples" in args:
        phase_examples(torch)
        return 0
    full = "--kernels" not in args
    graph_proc = (start_tenant_graphs()
               if full or "--tenancy" in args else None)
    try:
        if "--tenancy" in args:
            g, pg = phase_host()
            phase_tenancy(torch, torch.device("cuda"), g, pg, seed,
                          graph_proc)
            return 0
        records = drive(torch, torch.device("cuda"), rate, full, seed,
                        graph_proc)
    finally:
        if graph_proc is not None and graph_proc.poll() is None:
            graph_proc.kill()
            graph_proc.wait()
    if full:
        records[0]["paths"]["examples"] = phase_examples(torch)
        phase_dryrun(torch)
        phase_lm_dryrun(torch)
        phase_lm_serve(torch, seed, rate)
        phase_train(torch, seed)
        shard_k2 = phase_lm_shard(torch, seed, rate)
        records[1]["paths"]["lm_shard_graph"] = shard_k2
    print(json.dumps({"kernels": records}), flush=True)
    if not full:
        return 0
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
