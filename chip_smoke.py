#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

It builds the four CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (fused_step K1, cnn_trunk K2, conv2s K3, decode_attn K4) and logs
each kernel's registers, shared memory and spills; holds each against its
plain PyTorch version on the card at its path's shapes (and K1 against K2
bit for bit on the input K1 assembles, at 1024 and 128 lanes, where K1 and
K2 are also timed); and drives the paths that run them, counting the
launches each makes:

- the SimNet simulator: teacher-forced exactness, then a pack of
  C3-predicted workloads, its params loaded from a ``PredictorArtifact``
  the port writes, through ``SimNetEngine.simulate_many`` (K1 on the ring
  layout, K2 on the roll layout), whose chunks run as cached CUDA graph
  programs: each route's graph totals held to an eager pass bit for bit,
  graph and eager speed side by side, the builds, two engines of one kind
  with different weights through one graph, and profiles of eager steps
  beside graph replays;
- the public kernel API ``kernels.ops.conv2s`` (K3), chained over the C3
  trunk, whose result must equal the fused trunk kernel K2's bit for bit
  (K3 is also timed at each of the three C3 layers); K4 at gemma3-4b's
  decode shape (both windows, cache lengths 1, 1500 and 2112) and at each
  LM family's, in bf16 and f32, each call held to its plain version and
  timed beside it and beside SDPA, with its launch plan (splits, stages,
  shared memory) checked against the kernel's own count;
- LM decode serving: gemma3-4b at full width (random weights from a
  seed), 8 requests x 2048 prompt tokens prefilled, then 64 greedy steps
  through ``DecodeEngine`` with ``use_kernel=True`` (K4 in every layer;
  each step a replay of a CUDA graph), beside the eager steps, and the
  decode path's exactness (graph vs eager, kernel vs plain, CUDA vs CPU);
- every other predictor kind (fc2, fc3, c1, rb7, lstm2, tx6) at full
  width through an artifact and the engine's chunk graph, each held to
  its eager pass bit for bit and to the CPU (the lstm through cuDNN, held
  to its step-by-step cells);
- the training path: a teacher-forced dataset built on the card from the
  pack's DES traces (bit for bit the CPU's), c3 trained there for two
  epochs (its first steps' losses held to the CPU's), its prediction
  errors, and the trained artifact simulated through K1 and plain;
- the serving tier: the pack through ``SimNet(artifact, use_kernel=True,
  background=True)`` → ``SimServe`` → the engine's chunk graph → K1, its
  totals the engine's own bit for bit (K1's launches counted across the
  served call), two resident models of one kind on one graph (its weight
  slots refilled at each turn), ``SimServeHTTP`` with client threads
  posting wire arrays, and ``python -m repro_torch`` as child processes:
  ``simulate --use-kernel``, ``serve --jobs``, a 2-replica ``fleet`` and
  ``chaos --quick``, each held to the in-process totals; then a one-shot
  ``simulate`` timed at chunk 256, 512 and 1024;
- the other LM families at full width in bf16, one at a time (phase
  [12]): mixtral-8x7b (cut to 16 of 32 layers; its SWA ring cache and MoE
  dispatch), qwen2-vl-72b (cut to 20 of 80; M-RoPE, stub image patches),
  recurrentgemma-2b, whisper-large-v3 (1500 stub frames) and rwkv6-1.6b
  whole, each served as gemma3-4b is (K4 in every attention layer through
  the step graph, counted and read from the profiler, graph = eager
  tokens, every K4 call of the first step held to its plain version, the
  first step's logits on both paths), then each non-dense family at
  reduced width in f32 on the card and the CPU (kernel = plain = CPU);
- LM training (phase [13]): every family at reduced width in f32, 3 Adam
  steps at accum_steps 2 on the card and the CPU from the same masters
  (losses, grad norms and params held), a reduced run checkpointed and
  resumed on the card (the restored state bit for bit), tinyllama-1.1b
  trained at full width for 20 steps of ``launch.train.train`` (bf16 on
  f32 masters, remat, 2 microbatches of 4 x 2048 tokens: ms a step,
  tokens/s, peak memory, model FLOPs and their share of the bf16 peak,
  a profile of 3 more steps), and its trained masters, cast to serving
  storage, decoded through ``DecodeEngine`` with K4 (every K4 call of the
  first step held to its plain version at tinyllama's decode shape, and
  the step's logits to the plain path);
- the lane mesh (phase [14]): the [5] pack through ``SimNet(artifact,
  mesh=make_host_mesh(), use_kernel=True)`` on a one-rank mesh (totals
  and K1 launches equal [5]'s, the program keyed by the mesh's
  fingerprint, a cache miss beside the unsharded program, its speed
  beside the unsharded engine's in turns), then two ranks on the one card
  (this process the controller, a follower started with the spawn method
  on a gloo file-store group, K1 on each rank's half of the lanes; the
  totals equal one rank's on the same lanes, and teacher-forced one rank's
  on all of them), and ``examples/quickstart_torch.py --device cuda`` as a
  child process (its DES CPIs held to the DES run on the host);
- sharded LM training (phase [15]): tinyllama-1.1b at [13]'s full width
  through ``launch.train.train(model_axis=1)`` (one rank: plain tensors)
  beside the same step on a one-rank mesh's DTensors, bit for bit; then
  two ranks on the one card (a spawned follower, a (data 1, model 2)
  mesh: params, Adam state and activations split by the rule table, gloo
  for the all-reduces, the all-gathers and reduce-scatters through the
  ranks' device buffers by CUDA IPC), held to the one-rank run and,
  at reduced width in f32, to one rank within 1e-5, with each collective
  kind's bytes a step counted; the two-rank params, checkpointed and
  restored unsharded, decode through ``DecodeEngine`` with K4 to the same
  tokens as the params gathered in memory;
- sharded LM decode (phase [16]): two ranks on the one card, a (data 1,
  model 2) mesh, every KV cache split along its sequence (``kvseq``):
  gemma3-4b at [7]'s full width through a sharded prefill and
  ``DecodeEngine(mesh=)`` with K4 on each rank's shard (its launches a
  step a rank, the prefill's and first step's tokens held to [7]'s, the
  first step's logits to [8]'s kernel path; one step profiled, its
  collectives counted), [8]'s reduced f32 model on two ranks against one,
  and ``decode_long`` (batch 1, a seeded cache of 32,768 positions, rank
  0's outside every local layer's window) against one rank's unsharded K4
  decode. Phase [3b] holds K4's shard mode (an offset, the log-sum-exp
  beside an f32 output, an empty shard) against its plain version and
  the two shards merged against the unsharded K4.
- the dry run and the roofline (phase [17]): (a) a child process traces
  four cells of ``python -m repro_torch.launch.dryrun`` at the reference's
  world (a ``"fake"`` process group of 256 or 512 ranks, fake tensors on
  the card's device type): tinyllama-1.1b × train_4k, gemma3-4b ×
  decode_32k, mixtral-8x7b × long_500k on the multi-pod mesh and
  simnet-c3 × simulate_64k, every status ok and the SimNet cell with no
  collective; (b) ``runtime.opcount`` on the card: one SimNet c3 step at
  [5]'s shape and one gemma3-4b decode step at [7]'s, each run with its
  kernel (K1, K4: launched once) and plain, the counts equal (a region
  counts the same formula whichever runs inside it, so K4's bytes are
  also held against an independent count: the plain attention at [7]'s
  shape on a full cache, counted op by op with no region, moves K and V
  three times, 2.9-3.2 times the region's bytes, at equal FLOPs); each
  step's bound (``runtime.roofline`` on the H100's figures, the f32 peak
  for SimNet, the bf16 one for gemma) over [5]'s and [7]'s measured ms a
  step is its roofline share, at most 1.05. A decode cell is traced as
  rank 0 and as the last rank and recorded as the slower (gemma3-4b's:
  the last); recurrentgemma-2b × train_4k at one layer counts DTensor's
  ``Shard → Shard`` as all-to-alls;
- every LM family sharded (phase [18]): two ranks on the one card, a
  (data 1, model 2) mesh, DTensor's ``Shard → Shard`` run as an
  all-to-all through the ranks' device buffers beside the all-gathers
  and reduce-scatters: (a) recurrentgemma-2b at full width through a
  sharded prefill of [12]'s prompts and ``DecodeEngine(mesh=)`` with K4's
  shard mode on its attention layers (its launches a step a rank, the
  prefill's and first step's tokens held to [12]'s, the prefill's and a
  step's collectives counted; the same model in f32, its sharded first
  step's logits held to one card's); (b) every non-dense family at
  reduced width in f32, one sharded train step and a sharded prefill and
  decode each held to one rank on the card (every all-to-all through the
  peer buffers; rwkv6's run some); (c) rwkv6-1.6b trained at full width,
  cut to 2 of 24 layers, on one card for 3 steps of 4 x 1024 tokens (its
  wkv loop's backward at O(T)), and one layer's step counted by
  ``runtime.opcount``.

``python3 chip_smoke.py --only 18`` (or ``17``, ``17,18``) runs the
named phases alone after the builds ([18] after [12]'s recurrentgemma-2b
run, for its tokens) and prints no result line.

Any failed check raises, so the exit code is non-zero. Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.

The last two lines of standard output are one JSON object per kernel
measured (``{"kernels": [...]}``) and the verdict
(``{"ok": true, "device": {...}}``).
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
L, Q = 1024, 64  # main path's lanes and context length (the c3 default)
RTOL = ATOL = 1e-4  # kernel vs plain on the card: sums run in another order
PRED_RTOL = 1e-3  # kernel vs plain engine totals: an argmax near-tie may flip
# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TF_BENCHES = (("mlb_mixed", 12000), ("sim_loop", 8000), ("mlb_stream", 8000))
PRED_BENCHES = ("mlb_stream", "mlb_compute", "mlb_branchy", "mlb_mixed",
                "sim_chase", "sim_loop", "sim_branchy_hard", "sim_phased")
PRED_LANES, PRED_STEPS = 128, 256  # per workload: 8 x 128 = 1024 live lanes
OTHER_KINDS = ("fc2", "fc3", "c1", "rb7", "lstm2", "tx6")  # c3 is the main path's
KIND_LANES, KIND_CPU_LANES = 16, 2  # phase [9]: lanes a workload, on the card / held to the CPU
LSTM_RTOL = 2e-5  # cuDNN's fused LSTM vs the step-by-step cells (f32, other sum order)
# phase [10]: the dataset takes the pack's lane split (128 lanes of 256
# steps a workload: 8 x 256 eager steps, where the reference's default of
# 8 lanes would take 8 x 4096); c3 trains at the reference's defaults
TRAIN_EPOCHS, TRAIN_BATCH, TRAIN_LR = 2, 512, 1e-3
# the card's first steps against the CPU's: f32 sums in another order
# (cuBLAS vs the CPU's GEMMs) move a loss by ~1e-7 relative; Adam's
# division by sqrt(v) lets that grow step by step, so only the first 20
# steps are held, at 1e-4
TRAIN_CMP_STEPS, TRAIN_RTOL = 20, 1e-4
# phase [11]: the serving tier. HTTP clients; the CLI children's pack
# (two DES traces, 16 lanes: 256 steps, one chunk); fleet replicas; the
# one-shot simulate's lanes (16 lanes of a 32768-instruction workload:
# 2048 steps, so each chunk cap below is the chunk it runs)
HTTP_CLIENTS = 4
CLI_BENCHES, CLI_N, CLI_LANES = ("sim_loop", "mlb_mixed"), 4096, 16
FLEET_REPLICAS = 2
# the chaos drill's watchdog (its CLI default is 10 s): a dispatch that
# builds a CUDA graph must finish inside it, and builds took up to ~10 s
# on the card when its host was busy, while the injected hang it must
# catch lasts 600 s
CHAOS_WATCHDOG_S = 30
ONESHOT_LANES, CHUNK_CAPS = 16, (256, 512, 1024)
# phase [14]: the lane mesh. Rounds of (unsharded, mesh, mesh, unsharded)
# timed runs of the [5] pack; the bound of every wait of the two-rank
# group and of the quickstart child
MESH_TURNS, MESH_TIMEOUT_S = 2, 300
LM_ARCH = "gemma3-4b"
LM_BATCH, LM_PROMPT, LM_STEPS = 8, 2048, 64  # requests, prompt tokens, decode steps
LM_CACHE = 2112  # prompt + steps
LM_PROFILE_STEPS = 8
# K4 vs plain, (rtol, atol): both compute in f32 and differ in summation
# order only. f32: 1e-5. bf16: the outputs are rounded to bf16 (8
# significant bits), and another sum order can move a value across a
# rounding boundary, one bf16 step = at most 2**-7 of the value; atol 1e-4
# covers values near zero (typical outputs here are ~0.03)
DECODE_TOL = {"bfloat16": (2 ** -7, 1e-4), "float32": (1e-5, 1e-5)}
# K4's shard mode against its plain version (rtol = atol): f32 outputs
# and log-sum-exps, sums in another order; in bf16 P is also split into
# bf16 hi + lo (an error under 2**-16 of P, times |v| ~ 4 here)
SHARD_K4_TOL = {"bfloat16": 1e-4, "float32": 1e-5}
# (window, cache_len) of the shard-mode cases at LM_CACHE over two shards:
# a local layer whose window [1076, 2100) leaves rank 0 nothing, one across
# the boundary, a global layer, and a cache not yet past rank 1's offset
SHARD_K4_CASES = ((1024, 2100), (1024, 1500), (0, 2112), (0, 1000))
EXACT_LAYERS, EXACT_PROMPT, EXACT_STEPS, EXACT_BATCH = 6, 48, 16, 4
EXACT_TOL = 1e-4  # f32 logits, CUDA vs CPU
# Full width in bf16, kernel vs plain path, first-step logits, relative to
# max |logit|. The plain path rounds q.k and the probabilities to bf16 (8
# significant bits) where the kernel keeps f32, and the difference passes
# through every layer: 1.4% of max |logit| measured on the H100 for
# gemma3-4b's 34 layers, 1.1-3.1% for the families of phase [12] (PERF.md);
# 5% leaves room for other weights and prompts. The sharp test of
# the kernel path is the f32 one at reduced depth (EXACT_TOL).
FULL_TOL = 0.05
# phase [12]: the other LM families at full width, bf16, LM_BATCH requests
# and LM_STEPS greedy steps. (arch, layers kept or None for all, prompt
# tokens). Depth is cut only where one card's 80 GB forces it: weights,
# KV cache and prefill activations (the plain attention's f32 logits over
# 2048 x 2048 positions are 4-9 GB a layer while they live), with room to
# spare: mixtral 16 of 32 layers (~2.9 GB a layer in bf16), qwen2-vl 20 of
# 80 (~1.76 GB a layer, plus ~5 GB of embedding tables). whisper takes
# 1500 stub frames and a 64-token decoder prompt.
FAMILY_RUNS = (("mixtral-8x7b", 16, 2048), ("qwen2-vl-72b", 20, 2048),
               ("recurrentgemma-2b", None, 2048), ("whisper-large-v3", None, 64),
               ("rwkv6-1.6b", None, 2048))
VLM_PATCHES = 256  # qwen2-vl: stub image patches in the leading positions
# the eager steps each family's graph stream is held to (and timed over):
# LM_STEPS cut to 16 for the script's time
FAMILY_EAGER_STEPS = 16
# phase [12]'s exactness, reduced f32 on the card and the CPU: phi3.5-moe
# (mixtral's code without the SWA ring) besides the five; 32-token prompts
# (EXACT_BATCH x 32 tokens: two MoE groups of 64) and 16 steps wrap
# mixtral's ring of 32 and the hybrid's prompt-sized one
FAMILY_EXACT_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b",
                      "recurrentgemma-2b", "whisper-large-v3", "rwkv6-1.6b")
FAMILY_EXACT_PROMPT = 32
# phase [13]: LM training. (a) every family at reduced width in f32 (one
# arch a family, gemma3-4b for its local/global layers: 6 layers), 3 Adam
# steps at accum_steps 2 on (2, 16) batches, the card against the CPU:
# losses within 1e-5 and grad norms within 1e-4 relative (f32 sums in
# another order: ~1e-7 a pass, growing through Adam's sqrt(v)); params
# within 2 x lr (a first Adam step moves a near-zero gradient's param by
# ~lr whichever sign its last bit gives it)
TRAIN_EXACT_ARCHS = (("tinyllama-1.1b", {}), ("gemma3-4b", {"n_layers": 6}), ("mixtral-8x7b", {}),
                     ("qwen2-vl-72b", {}), ("recurrentgemma-2b", {}),
                     ("whisper-large-v3", {}), ("rwkv6-1.6b", {}))
TRAIN_EXACT_STEPS, TRAIN_EXACT_ACCUM, TRAIN_EXACT_BATCH, TRAIN_EXACT_SEQ = 3, 2, 2, 16
TRAIN_EXACT_LR, TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-3, 1e-5, 1e-4
# (c) tinyllama-1.1b at full width: bf16 compute on f32 masters, remat,
# the config's accum_steps 2, through launch.train.train; lr 3e-4 with
# train()'s schedule (warmup steps // 10 = 2, cosine to 20); 3 more steps
# profiled; (d) the trained model decodes 8 greedy steps with K4, its
# first step held to the plain path as phase [12]'s are
LM_TRAIN_ARCH = "tinyllama-1.1b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_LR = 8, 2048, 20, 3e-4
LM_TRAIN_PROFILE_STEPS, LM_TRAIN_DECODE_PROMPT, LM_TRAIN_DECODE_STEPS = 3, 64, 8
PEAK_BF16_FLOPS = 989.4e12  # H100 SXM dense bf16 (NVIDIA data sheet)
# phase [15]: sharded LM training, [13](c)'s configuration (tinyllama-1.1b
# at full width, batch 8 x 2048, accum_steps 2, lr 3e-4, seed 0) for
# SHARD_STEPS steps with train()'s schedule for that many steps: (a)
# train(model_axis=1) beside the step on a one-rank mesh's DTensors, bit
# for bit; (b) two ranks on
# the one card, mesh (data 1, model 2): the first loss within 1e-3
# relative of (a)'s and each grad norm within 1e-2 (bf16 partial sums are
# added in another order), and reduced f32 on the two ranks against one
# rank within 1e-5 over 3 steps; (c) (b)'s params checkpointed, restored
# on one rank and decoded SHARD_DECODE_STEPS greedy steps with K4
SHARD_STEPS, SHARD_REDUCED_STEPS, SHARD_DECODE_STEPS, SHARD_TIMEOUT_S = 5, 3, 16, 300
SHARD_LOSS_RTOL, SHARD_NORM_RTOL, SHARD_REDUCED_RTOL = 1e-3, 1e-2, 1e-5
# phase [16]: sharded LM decode, two ranks on the card, mesh (data 1, model
# 2). (a) [7]'s configuration (gemma3-4b, 8 x 2048-token prompts, 2112
# positions, SHARD_LM_STEPS greedy steps with K4) through a sharded prefill and
# DecodeEngine(mesh=): K4 once a layer and step a rank, the prefill's and
# the first step's tokens equal [7]'s, first-step logits within FULL_TOL;
# (b) [8]'s reduced f32 model, two ranks = one over EXACT_STEPS (tokens
# equal, logits within EXACT_TOL); (c) decode_long: batch 1, a seeded
# cache of SHARD_LONG_SEQ positions (half a rank) at SHARD_LONG_POS, no
# prefill (the plain prefill's logits would take over 30 GB a layer at
# 32k), SHARD_LONG_STEPS steps (16 cut to 8 for the script's time);
# first-step logits within FULL_TOL of one
# rank's unsharded K4 decode
SHARD_LONG_SEQ, SHARD_LONG_POS, SHARD_LONG_STEPS = 32768, 32000, 8
# (a)'s greedy steps: [7]'s 64 cut to 8 for the script's time (each eager
# step ~0.65-0.95 s, host-bound); the follower's wait at the rendezvous covers
# [15], which runs after the follower starts
SHARD_LM_STEPS, SHARD_DECODE_TIMEOUT_S = 8, 900
# phase [17]: the dry run and the roofline. (a) the cells a child process
# traces (arch, shape, multi-pod), within DRYRUN_TIMEOUT_S; (b) a step's
# roofline share, its counted bound over its measured time, is at most
# SHARE_MAX (above 1 the count or the clock is wrong)
# (arch, shape, multi-pod, overrides): the hybrid's train step at one layer
# (an RG-LRU block, its 10 heads gathered over 16 ranks); a decode cell is
# traced as rank 0 and as the last rank, and recorded as the slower
# (gemma3-4b's windowed layers: the last)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", False, None), ("gemma3-4b", "decode_32k", False, None),
                ("mixtral-8x7b", "long_500k", True, None), ("simnet-c3", "simulate_64k", False, None),
                ("recurrentgemma-2b", "train_4k", False, {"n_layers": 1}))
DRYRUN_TIMEOUT_S, SHARE_MAX = 300, 1.05
# phase [18]: every LM family sharded on the card, two ranks sharing it on a
# (data 1, model 2) mesh (gloo; the all-gathers, reduce-scatters and the
# all-to-alls of DTensor's Shard -> Shard through the ranks' device
# buffers). (a) recurrentgemma-2b at full width, bf16: [12]'s LM_BATCH x
# 2048-token prompts through a sharded prefill (the RG-LRU's all-to-alls),
# then SHARD_HYBRID_STEPS greedy steps of DecodeEngine(mesh=) with K4's
# shard mode on its attention layers; the prefill's and the first step's
# tokens equal [12]'s; in f32, the first step's logits held to one card's.
# (b) FAMILY_EXACT_ARCHS at reduced width in f32, each held to
# one rank on the card: one sharded train step at accum_steps 2 (loss
# TRAIN_LOSS_RTOL, grad norm TRAIN_NORM_RTOL relative) and
# SHARD_FAMILY_STEPS sharded decode steps from FAMILY_EXACT_PROMPT-token
# prompts (tokens equal, logits within SHARD_FAMILY_LOGIT_TOL). (c)
# rwkv6-1.6b trained at full width on one card through launch.train.train
# (bf16 on f32 masters, remat, accum_steps 2): RWKV_TRAIN_STEPS steps of
# RWKV_TRAIN_BATCH x RWKV_TRAIN_SEQ tokens at RWKV_TRAIN_LR, cut to
# RWKV_TRAIN_LAYERS of 24 layers for the script's time (the wkv loop is
# host-bound: ~100 s a step at 24 layers on the H100; lr 1e-3 made the
# full-width loss jump from 11.5 to 22.3 in one step); one layer's step at
# RWKV_COUNT_SEQ counted by runtime.opcount (the counter runs in Python
# for each op: ~600k ops at seq 1024)
SHARD_HYBRID_ARCH, SHARD_HYBRID_STEPS, SHARD_FAMILY_STEPS = "recurrentgemma-2b", 16, 8
# (a)'s first-step logits are held to one card in f32 at full width
# (SHARD_HYBRID_F32_PROMPT-token prompts, within SHARD_HYBRID_F32_TOL x max
# |logit|); in bf16 the two ranks' rounded partial sums move them 5.97% of
# max |logit| from [12]'s (an H100 80GB HBM3 at 700 W; [12]'s own kernel
# and plain paths differ by 3.0%), past FULL_TOL, so that is printed
SHARD_HYBRID_F32_PROMPT, SHARD_HYBRID_F32_TOL = 256, 1e-3
SHARD_FAMILY_LOGIT_TOL = {"hybrid": 1e-4}  # else 1e-5 (the RG-LRU scan sums in another order)
SHARD_FAMILY_TIMEOUT_S = 600
RWKV_TRAIN_ARCH, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS = "rwkv6-1.6b", 4, 1024, 3
RWKV_TRAIN_LAYERS, RWKV_TRAIN_LR, RWKV_COUNT_SEQ = 2, 1e-4, 256
# device kernels of a train step by name: (kind, regex), first match wins
TRAIN_KERNEL_KINDS = (("GEMM (cuBLAS)", r"gemm|xmma|nvjet|cutlass"), ("softmax", r"softmax"),
                      ("mask (where)", r"where"), ("cast f32 -> bf16", r"bfloat16_copy"),
                      ("other copies and casts", r"copy"),
                      ("index / gather / scatter", r"index|gather|scatter"),
                      ("reductions", r"reduce"))


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    log(f"  ok: {what}")


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. A spin
    kernel queued first keeps the card busy while the host enqueues the
    calls, so the host's launch cost does not show up as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_ops):
    """Least time (ms) the card could take: bytes over the memory rate vs
    f32 operations over the f32 peak, whichever is larger (every kernel
    here computes in f32 outside the tensor cores)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k4_times(torch, k4, q, k, v, cache_len, window):
    """K4 (``k4``: `ops.decode_attn` or the kernel it wraps) at one shape:
    kernel, plain and SDPA ms, the bound from the live positions' bytes and
    their number. SDPA, with a boolean mask of the live positions, is timed
    as a yardstick only."""
    import torch.nn.functional as Fn

    from repro_torch.kernels import ref

    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    hi = min(int(cache_len), S)
    lo = max(hi - window, 0) if window > 0 else 0
    pos = torch.arange(S, device=q.device)
    mask = ((pos < hi) & (pos >= lo)).reshape(1, 1, 1, S)
    q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    clamped = torch.clamp(cache_len, max=S)
    n_bytes = 2 * q.nbytes + 2 * B * (hi - lo) * KV * hd * k.element_size() + 4
    b_ms, b_by = bound(n_bytes, 4 * B * H * (hi - lo) * hd)
    return dict(
        ms=time_ms(torch, lambda: k4(q, k, v, cache_len, window=window)),
        plain_ms=time_ms(torch, lambda: ref.decode_attn_ref(q, k, v, clamped, window=window).to(q.dtype)),
        library_ms=time_ms(torch, lambda: Fn.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                                          enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, live=hi - lo)


def trunk_ops(n_lanes, seq, chans):
    """Multiply-adds x 2 of the three k2s2 layers (unpadded channels)."""
    ops, rows = 0, seq
    for c_in, c_out in zip(chans[:-1], chans[1:]):
        rows //= 2
        ops += 2 * n_lanes * rows * 2 * c_in * c_out
    return ops


def populated_state(torch, sim, dev, lanes=L, steps=300):
    """A ring state of ``lanes`` lanes after ``steps`` teacher-forced steps
    of random instructions (long latencies, so the queues fill and
    overflow)."""
    import numpy as np

    from repro_torch.core import features as F

    rng = np.random.default_rng(SEED)
    cfg = sim.SimConfig(ctx_len=Q)
    state = sim.init_state(lanes, cfg, dev)
    for _ in range(steps):
        is_store = rng.random(lanes) < 0.3
        feat = (rng.random((lanes, F.STATIC_END)) * (rng.random((lanes, F.STATIC_END)) < 0.3)).astype(np.float32)
        feat[:, 7] = is_store
        cur = {
            "feat": torch.from_numpy(feat).to(dev),
            "addr": torch.from_numpy(rng.integers(0, 20, (lanes, F.N_ADDR_KEYS)).astype(np.int32)).to(dev),
            "is_store": torch.from_numpy(is_store).to(dev),
        }
        lats = np.stack([rng.integers(0, 3, lanes), rng.integers(1, 48, lanes), rng.integers(1, 64, lanes)], 1)
        state = sim.sim_step(state, cur, torch.from_numpy(lats.astype(np.float32)).to(dev), cfg)
    return state, cur


def compare(torch, name, out, want):
    err = (out - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    nonzero = float((want != 0).float().mean())
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(rtol={RTOL}, atol={ATOL}); plain output mean |y|={float(want.abs().mean()):.4f}, "
        f"nonzero share={nonzero:.3f}")
    check(bool(torch.isfinite(out).all()) and out.shape == want.shape, f"{name} finite, shape {tuple(out.shape)}")
    check(nonzero > 0.1, f"{name} output is not degenerate (ReLU leaves {nonzero:.3f} nonzero)")
    check(torch.allclose(out, want, rtol=RTOL, atol=ATOL), f"{name} matches its plain version")
    return max_abs


def kernel_phase(torch, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import simulator as sim
    from repro_torch.core.predictor import PredictorConfig, init_predictor
    from repro_torch.kernels import ops, ref

    log(f"[3] kernels vs plain versions (L={L}, Q={Q}, c3 default widths)")
    pcfg = PredictorConfig()
    params = init_predictor(torch.Generator().manual_seed(SEED), pcfg, dev)
    conv = [params[f"conv{i}"] for i in range(3)]
    layers = [(p["w"], p["b"]) for p in conv]
    state, cur = populated_state(torch, sim, dev)
    S = pcfg.seq_padded
    log(f"  populated ring state: head={int(state.head)}, "
        f"valid share={float(state.valid.float().mean()):.3f}, overflow={int(state.overflow.sum())}")
    x = torch.nn.functional.pad(sim.model_input(state, cur["feat"], cur["addr"], sim.SimConfig()),
                                (0, 0, 0, S - (Q + 1)))

    def chain():  # one PyTorch call chain computing the same trunk (yardstick only)
        h = x
        for w, b in layers:
            n, c = h.shape[1] // 2, 2 * h.shape[2]
            h = torch.relu(torch.matmul(h.reshape(-1, n, c), w) + b)
        return h

    chans = [x.shape[2]] + [w.shape[1] for w, _ in layers]
    wbytes = sum(w.nbytes + b.nbytes for w, b in layers)
    rows = []

    # K1: fused ring-state assembly + trunk
    def k1():
        return ops.fused_step(conv, state, cur["feat"], cur["addr"], seq_padded=S)

    def p1():
        return ref.fused_step_ref(layers, state, cur["feat"], cur["addr"], seq_padded=S)

    out = k1()
    torch.cuda.synchronize()
    err1 = compare(torch, "fused_step", out, p1())
    in_bytes = sum(t.nbytes for t in (state.feat, state.addr, state.resid, state.exec_lat,
                                       state.store_lat, state.valid, state.head,
                                       cur["feat"], cur["addr"]))
    b_ms, b_by = bound(in_bytes + wbytes + out.nbytes, trunk_ops(L, S, chans))
    rows.append(dict(name="fused_step", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_step.cu",
                     replaces="src/repro/kernels/fused_step.py:139",
                     max_abs_err=err1, ms=time_ms(torch, k1), plain_ms=time_ms(torch, p1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, chain)))

    # K2: trunk on the assembled input
    def k2():
        return ops.cnn_trunk(conv, x)

    def p2():
        return ref.cnn_trunk_ref(layers, x)

    out = k2()
    torch.cuda.synchronize()
    err2 = compare(torch, "cnn_trunk", out, p2())
    b_ms, b_by = bound(x.nbytes + wbytes + out.nbytes, trunk_ops(L, S, chans))
    rows.append(dict(name="cnn_trunk", route="cuda",
                     source="src/repro_torch/kernels/csrc/cnn_trunk.cu",
                     replaces="src/repro/kernels/cnn_trunk.py:55",
                     max_abs_err=err2, ms=time_ms(torch, k2), plain_ms=time_ms(torch, p2),
                     bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, chain)))
    # both keep each output's sum in one thread, k ascending with fmaf
    check(torch.equal(k1(), out), "fused_step equals cnn_trunk on its assembled input bit for bit")
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"matmul chain {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound")

    # one workload's lanes: the tiles at a tenth of the main path's size
    lanes = PRED_LANES
    st, cr = populated_state(torch, sim, dev, lanes=lanes)
    xs = torch.nn.functional.pad(sim.model_input(st, cr["feat"], cr["addr"], sim.SimConfig()),
                                 (0, 0, 0, S - (Q + 1)))
    small = {"fused_step": lambda: ops.fused_step(conv, st, cr["feat"], cr["addr"], seq_padded=S),
             "cnn_trunk": lambda: ops.cnn_trunk(conv, xs)}
    check(torch.equal(small["fused_step"](), small["cnn_trunk"]()),
          f"fused_step equals cnn_trunk bit for bit at L={lanes}")
    for name, fn in small.items():
        ms = time_ms(torch, fn)
        b_ms, b_by = bound(0, trunk_ops(lanes, S, chans))
        log(f"  {name} at L={lanes}: kernel {ms:.4f} ms, operations bound {b_ms:.4f} ms, "
            f"{100 * b_ms / ms:.1f}% of it")
    return pcfg, params, rows, x


def conv_decode_kernel_phase(torch, dev, params, x):
    """K3 at each of the three C3 layers' shapes and K4 at the LM decode
    path's shape, each against its plain version; the library call beside
    each is timed only. K3's row in the JSON line is the first layer's."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.breakdown import K4_SHAPES

    rows = []
    h = x  # each layer's input is the layer before's output
    for i in range(3):
        lp = params[f"conv{i}"]
        B, N, C = h.shape
        co = lp["w"].shape[1]
        log(f"[3b] conv2s at C3 layer {i + 1}'s shape {tuple(h.shape)} -> {co} channels")

        def k3(lp=lp, h=h):
            return ops.conv2s(lp, h)

        def p3(lp=lp, h=h):
            return ref.conv2s_ref(h, lp["w"], lp["b"])

        def lib3(lp=lp, h2=h.reshape(B, N // 2, 2 * C)):  # matmul + bias + ReLU (yardstick only)
            return torch.relu(torch.matmul(h2, lp["w"]) + lp["b"])

        out = k3()
        torch.cuda.synchronize()
        err = compare(torch, f"conv2s layer {i + 1}", out, p3())
        b_ms, b_by = bound(h.nbytes + lp["w"].nbytes + lp["b"].nbytes + out.nbytes,
                           2 * B * (N // 2) * 2 * C * co)
        r = dict(name="conv2s", route="cuda", source="src/repro_torch/kernels/csrc/conv2s.cu",
                 replaces="src/repro/kernels/conv2s.py:37", max_abs_err=err,
                 ms=time_ms(torch, k3), plain_ms=time_ms(torch, p3), bound_ms=b_ms,
                 bound_by=b_by, library_ms=time_ms(torch, lib3))
        log(f"  conv2s layer {i + 1} {tuple(h.shape)} -> {co}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, matmul + bias + ReLU {r['library_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / r['ms']:.1f}% of the bound, "
            f"{r['library_ms'] / r['ms']:.2f}x the matmul's speed")
        if i == 0:
            rows.append(r)
        h = out

    cfg = get_config(LM_ARCH)
    H, KV, hd, S, Bq = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, LM_CACHE, LM_BATCH
    log(f"[3b] decode_attn at {LM_ARCH}'s decode shape: q ({Bq}, {H}, {hd}), k/v "
        f"({Bq}, {S}, {KV}, {hd}); windows {cfg.local_window} and 0")
    rng = np.random.default_rng(SEED)
    base = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
            for shape in ((Bq, H, hd), (Bq, S, KV, hd), (Bq, S, KV, hd))]
    errs = {}
    for dtype, (rtol, atol) in DECODE_TOL.items():
        q, k, v = (t.to(getattr(torch, dtype)) for t in base)
        errs[dtype] = 0.0
        for window in (cfg.local_window, 0):
            for cache_len in (S, 1, 1500):
                cl = torch.tensor(cache_len, dtype=torch.int32, device=dev)
                got = ops.decode_attn(q, k, v, cl, window=window)
                torch.cuda.synchronize()
                want = ref.decode_attn_ref(q, k, v, torch.clamp(cl, max=S), window=window).to(q.dtype)
                e = float((got.float() - want.float()).abs().max())
                errs[dtype] = max(errs[dtype], e)
                what = f"decode_attn {dtype} window={window} cache_len={cache_len}"
                check(bool(torch.isfinite(got).all()) and got.shape == q.shape and got.dtype == q.dtype,
                      f"{what}: finite, shape {tuple(got.shape)}, max_abs_err={e:.3e}")
                check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
                      f"{what} matches its plain version (rtol={rtol}, atol={atol})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[3b] decode_attn at each family's decode shape, bf16 and f32 ({smi}): kernel, plain and "
        "SDPA ms; each call held to its plain version at DECODE_TOL")
    timed = {}
    for what, B, S_, H_, KV_, hd_, n, window in K4_SHAPES:
        rng = np.random.default_rng(SEED + H_ + hd_)
        fam = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
               for shape in ((B, H_, hd_), (B, S_, KV_, hd_), (B, S_, KV_, hd_))]
        cl = torch.tensor(n, dtype=torch.int32, device=dev)
        for dtype, (rtol, atol) in DECODE_TOL.items():
            q, k, v = (t.to(getattr(torch, dtype)) for t in fam)
            got = ops.decode_attn(q, k, v, cl, window=window)
            want = ref.decode_attn_ref(q, k, v, torch.clamp(cl, max=S_), window=window).to(q.dtype)
            e = float((got.float() - want.float()).abs().max())
            check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
                  f"decode_attn {what} {dtype} matches its plain version (max_abs_err={e:.3e})")
            t = timed[what, dtype] = k4_times(torch, ops.decode_attn, q, k, v, cl, window)
            plan = ops.decode_plan(B, S_, H_, KV_, hd_, q.element_size(), sms)
            log(f"  decode_attn {what} {dtype}: q {tuple(q.shape)}, k/v {tuple(k.shape)}, {t['live']} "
                f"live; plan {plan.splits} splits, {plan.blocks} blocks, {plan.stages} stages of "
                f"{plan.tile}, {plan.smem_bytes} B smem: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of the bound, "
                f"{t['library_ms'] / t['ms']:.2f}x SDPA's speed")
    glob, loc = timed["gemma3-4b global", "bfloat16"], timed["gemma3-4b local", "bfloat16"]
    n_local = sum(1 for i in range(cfg.n_layers) if cfg.layer_window(i))
    step_ms = n_local * loc["ms"] + (cfg.n_layers - n_local) * glob["ms"]
    step_bound = n_local * loc["bound_ms"] + (cfg.n_layers - n_local) * glob["bound_ms"]
    log(f"  per {LM_ARCH} decode step ({n_local} local + {cfg.n_layers - n_local} global layers): "
        f"kernel {step_ms:.4f} ms vs bound {step_bound:.4f} ms; max_abs_err bf16 "
        f"{errs['bfloat16']:.3e}, f32 {errs['float32']:.3e}")
    shard = k4_shard_phase(torch, dev, cfg, base)
    rows.append(dict(name="decode_attn", route="cuda",
                     source="src/repro_torch/kernels/csrc/decode_attn.cu",
                     replaces="src/repro/kernels/decode_attn.py:78", max_abs_err=errs["bfloat16"],
                     **{key: glob[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                     shard=shard))
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound")
    return rows


def k4_shard_phase(torch, dev, cfg, base):
    """K4's shard mode at gemma3-4b's decode shape cut into two kvseq
    shards of LM_CACHE / 2 positions (what each of [16]'s two ranks
    holds): each shard at its offset returns (out, lse) in f32, held to
    its plain version at SHARD_K4_TOL; a shard with no live position
    gives 0 and -inf exactly; the two merged by log-sum-exp equal the
    unsharded K4 at DECODE_TOL. Then each shard timed (bf16) beside its
    plain version, the bound from the shard's live K/V bytes. Returns the
    K4 row's ``shard`` entry."""
    from repro_torch.kernels import ops, ref
    from repro_torch.nn.attention import merge_rows

    S, half = LM_CACHE, LM_CACHE // 2
    log(f"[3b] decode_attn shard mode: {LM_ARCH}'s decode shape over two kvseq shards of {half} "
        f"positions (offsets 0 and {half}), bf16 and f32; (window, cache_len) in {SHARD_K4_CASES}")
    empty = 0
    for dtype, (rtol, atol) in DECODE_TOL.items():
        q, k, v = (t.to(getattr(torch, dtype)) for t in base)
        parts = [(lo, k[:, lo:lo + half].contiguous(), v[:, lo:lo + half].contiguous())
                 for lo in (0, half)]
        tol = SHARD_K4_TOL[dtype]
        for window, cache_len in SHARD_K4_CASES:
            cl = torch.tensor(cache_len, dtype=torch.int32, device=dev)
            outs, lses = [], []
            for lo, ks, vs in parts:
                out, lse = ops.decode_attn(q, ks, vs, cl, window=window, offset=lo, return_lse=True)
                torch.cuda.synchronize()
                w_out, w_lse = ref.decode_attn_ref(q, ks, vs, cl, window=window, offset=lo,
                                                   return_lse=True)
                what = f"decode_attn shard mode {dtype} window={window} cache_len={cache_len} offset={lo}"
                live = min(cache_len, lo + half) - max(cache_len - window if window else 0, lo)
                if live <= 0:
                    empty += 1
                    check(bool((out == 0).all()) and bool(torch.isneginf(lse).all()),
                          f"{what}: no live position, out 0 and lse -inf exactly")
                e = float((out - w_out).abs().max())
                check(out.dtype == torch.float32 and torch.allclose(out, w_out, rtol=tol, atol=tol)
                      and torch.allclose(lse, w_lse, rtol=tol, atol=tol),
                      f"{what}: out and lse (f32) match the plain version at {tol} (max_abs_err {e:.3e})")
                outs.append(out)
                lses.append(lse)
            merged = merge_rows(torch.stack(outs), torch.stack(lses)).to(q.dtype)
            whole = ops.decode_attn(q, k, v, cl, window=window)
            e = float((merged.float() - whole.float()).abs().max())
            check(torch.allclose(merged.float(), whole.float(), rtol=rtol, atol=atol),
                  f"decode_attn {dtype} window={window} cache_len={cache_len}: the two shards merged = "
                  f"the unsharded K4 (rtol={rtol}, atol={atol}; max_abs_err {e:.3e})")
    check(empty > 0, f"{empty} shard calls with no live position held")
    q, k, v = (t.to(torch.bfloat16) for t in base)
    out = {}
    for what, window, lo in (("global", 0, half), ("local", cfg.local_window, half)):
        ks, vs = k[:, lo:lo + half].contiguous(), v[:, lo:lo + half].contiguous()
        cl = torch.tensor(S, dtype=torch.int32, device=dev)
        live = min(S, lo + half) - max(S - window if window else 0, lo)
        B, H, hd = q.shape
        n_bytes = q.nbytes + 2 * B * live * ks.shape[2] * hd * 2 + 4 * B * H * hd + 4 * B * H + 4
        b_ms, b_by = bound(n_bytes, 4 * B * H * live * hd)
        t = out[what] = dict(
            ms=time_ms(torch, lambda: ops.decode_attn(q, ks, vs, cl, window=window, offset=lo,
                                                      return_lse=True)),
            plain_ms=time_ms(torch, lambda: ref.decode_attn_ref(q, ks, vs, cl, window=window, offset=lo,
                                                                return_lse=True)),
            bound_ms=b_ms, bound_by=b_by, live=live)
        log(f"  decode_attn shard mode, {what} layer, rank 1's shard [{lo}, {lo + half}) at cache_len {S}, "
            f"bf16: {live} live; kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / t['ms']:.1f}% of the bound")
    return out


def make_traces(names_and_sizes):
    from repro_torch.core.features import trace_arrays
    from repro_torch.des.o3 import O3Config, O3Simulator
    from repro_torch.des.workloads import get_benchmark

    sim = O3Simulator(O3Config())
    traces = [sim.run(get_benchmark(n, size)) for n, size in names_and_sizes]
    return traces, [trace_arrays(t) for t in traces]


def teacher_forced_phase(torch, dev):
    """Teacher-forced totals on the card are exact."""
    import numpy as np

    from repro_torch.core.simulator import SimConfig
    from repro_torch.serving.simnet_engine import SimNetEngine

    log("[4] teacher-forced exactness on the card")
    t0 = time.perf_counter()
    traces, arrays = make_traces(TF_BENCHES)
    log(f"  DES traces {[t.n for t in traces]} made in {time.perf_counter() - t0:.1f} s")
    # lane totals are integer-valued f32 summed with atomics: exact while a
    # workload stays below 2**24 cycles, which these traces do
    check(all(t.total_cycles < 2**24 for t in traces), "every trace below 2**24 cycles")
    eng = SimNetEngine(device=dev)
    one = eng.simulate_many(arrays, n_lanes=1)
    check(list(one["workload_cycles"]) == [float(t.total_cycles) for t in traces],
          f"n_lanes=1 totals equal trace.total_cycles {[t.total_cycles for t in traces]}")
    packed = eng.simulate_many(arrays, n_lanes=8, chunk=512)
    alone = [eng.simulate_many([a], n_lanes=8, chunk=512)["workload_cycles"][0] for a in arrays]
    check(np.array_equal(packed["workload_cycles"], np.asarray(alone)),
          f"packed run equals per-workload runs {packed['workload_cycles'].tolist()}")
    roll = SimNetEngine(sim_cfg=SimConfig(layout="roll"), device=dev).simulate_many(
        arrays, n_lanes=8, chunk=512)
    check(np.array_equal(packed["workload_cycles"], roll["workload_cycles"])
          and np.array_equal(packed["workload_overflow"], roll["workload_overflow"]),
          "ring equals roll")
    cpu = SimNetEngine(device="cpu").simulate_many(arrays, n_lanes=8, chunk=512)
    check(np.array_equal(packed["workload_cycles"], cpu["workload_cycles"])
          and np.array_equal(packed["workload_overflow"], cpu["workload_overflow"]),
          "CUDA totals equal the CPU totals bit for bit")


def predicted_phase(torch, dev, pcfg, params):
    """The main path: a C3-predicted pack through the engine's cached
    graph programs, its params loaded from a predictor artifact on disk."""
    import numpy as np

    from repro_torch.checkpoint import PredictorArtifact
    from repro_torch.core.simulator import SimConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.simnet_engine import SimNetEngine

    log(f"[5] predicted main path: {len(PRED_BENCHES)} workloads x {PRED_LANES} lanes "
        f"x {PRED_STEPS} steps, c3 at full width, through the cached graph programs")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        PredictorArtifact(params, pcfg, SimConfig(ctx_len=pcfg.ctx_len),
                          metadata={"seed": SEED}).save(tmp)
        art = PredictorArtifact.load(tmp, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(tensors(art.params), tensors(params)))
    check(same and art.pcfg == pcfg and art.sim_cfg == SimConfig(ctx_len=pcfg.ctx_len),
          "params and configs loaded from a PredictorArtifact written by the port, bit for bit")
    t0 = time.perf_counter()
    traces, arrays = make_traces([(n, PRED_LANES * PRED_STEPS) for n in PRED_BENCHES])
    log(f"  DES traces made in {time.perf_counter() - t0:.1f} s")
    launches, routes = {}, {}

    def run(name, sim_cfg, use_kernel, timeit, predicted=True):
        eng = (SimNetEngine(art.params, art.pcfg, sim_cfg, use_kernel=use_kernel, device=dev)
               if predicted else SimNetEngine(sim_cfg=sim_cfg, device=dev))
        ops.reset_launches()
        res = eng.simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS, timeit=timeit)
        counts = dict(ops.launches)
        log(f"  {name} (layout={sim_cfg.layout} use_kernel={use_kernel}): "
            f"throughput_ips={res['throughput_ips']:.1f} seconds={res['seconds']:.4f} "
            f"first_call_seconds={res['first_call_seconds']:.3f} n_steps={res['n_steps']} "
            f"n_lanes={res['n_lanes']} cache={res['cache']} launches={counts}")
        check(np.isfinite(res["workload_cycles"]).all()
              and res["workload_cycles"].shape == (len(PRED_BENCHES),), "totals finite, one per workload")
        routes[name] = (eng, res)
        return res, counts

    ring, counts = run("ring+fused_step", art.sim_cfg, True, True)
    passes = 2  # timeit streams the pack twice
    check(counts["fused_step"] == passes * ring["n_steps"] and counts["cnn_trunk"] == 0,
          f"fused_step launched once per step ({counts['fused_step']} = {passes} x {ring['n_steps']})")
    launches["fused_step"] = counts["fused_step"]
    roll, counts = run("roll+cnn_trunk", SimConfig(layout="roll"), True, False)
    check(counts["cnn_trunk"] == roll["n_steps"] > 0 and counts["fused_step"] == 0,
          f"cnn_trunk launched once per step on the roll path ({counts['cnn_trunk']})")
    launches["cnn_trunk"] = counts["cnn_trunk"]
    plain, counts = run("plain", art.sim_cfg, False, False)
    check(sum(counts.values()) == 0, "use_kernel=False launches no kernel")
    run("teacher-forced", SimConfig(), False, True, predicted=False)
    for name, res in (("ring+fused_step", ring), ("roll+cnn_trunk", roll)):
        rel = np.abs(res["workload_cycles"] - plain["workload_cycles"]) / plain["workload_cycles"]
        log(f"  {name}: cycles {res['workload_cycles'].tolist()}")
        log(f"  plain torch:     cycles {plain['workload_cycles'].tolist()}")
        check(rel.max() < PRED_RTOL, f"{name} within {PRED_RTOL} of plain (max rel diff {rel.max():.3e})")
    return routes, launches, traces, arrays


def eager_pass(torch, eng, arrays, n_lanes, chunk):
    """``simulate_many(timeit=True)`` of ``eng`` without its program: the
    pack staged on the card, then two passes of `_run_chunk`, eagerly.
    Returns the numbers the engine reports, and the totals."""
    import numpy as np

    from repro_torch.core.simulator import (init_state, pack_workloads, packed_tensors,
                                            pad_packed_lanes, workload_totals)
    from repro_torch.serving.compile_cache import lane_bucket

    t_start = time.perf_counter()
    packed = pack_workloads(arrays, n_lanes, eng.sim_cfg, pad_to=chunk)
    packed = pad_packed_lanes(packed, lane_bucket(packed.n_lanes))
    dev = eng.device
    staged = [packed_tensors(packed, dev, lo, lo + chunk) for lo in range(0, packed.n_steps, chunk)]
    rw = torch.from_numpy(packed.retire_width).to(dev)
    lc = torch.from_numpy(packed.lane_ctx).to(dev)

    def one_pass():
        t0 = time.perf_counter()
        state = init_state(packed.n_lanes, eng.sim_cfg, dev)
        for xs in staged:
            state = eng._run_chunk(state, xs, rw, lc)
        _, cycles, overflow = workload_totals(state, packed)
        cycles, overflow = cycles.cpu(), overflow.cpu()
        return time.perf_counter() - t0, cycles, overflow

    one_pass()
    first = time.perf_counter() - t_start
    dt, cycles, overflow = one_pass()
    return dict(throughput_ips=int(packed.n_instructions.sum()) / dt, seconds=dt,
                first_call_seconds=first, workload_cycles=cycles.numpy().astype(np.float64),
                workload_overflow=overflow.numpy())


def graph_nodes(prog):
    """Node count of a program's CUDA graph (`cuGraphGetNodes` of libcuda)."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(prog.graph.graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUDA error {err}")
    return n.value


def build_log(prog):
    g = prog.graph
    return (f"capture {g.capture_seconds:.3f} s, instantiate {g.instantiate_seconds:.3f} s, "
            f"{graph_nodes(prog)} graph nodes, launches a replay {g.launches}")


def program_phase(torch, dev, routes, arrays, pcfg):
    """The resident programs: each route's graph totals against an eager
    `_run_chunk` pass bit for bit, graph and eager speed side by side, the
    build at chunk 256 and at chunk 1024, the weight-slot binding of two
    engines of one kind, and the cache's per-key counters."""
    import numpy as np

    from repro_torch.core.predictor import init_predictor
    from repro_torch.serving.compile_cache import global_cache
    from repro_torch.serving.simnet_engine import SimNetEngine

    log("[5c] resident programs: graph vs eager, builds, weight slots, cache")
    eager = {}
    for name, (eng, first) in routes.items():
        g = eng.simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS, timeit=True)
        e = eager[name] = eager_pass(torch, eng, arrays, PRED_LANES, PRED_STEPS)
        check(all(np.array_equal(r["workload_cycles"], e["workload_cycles"])
                  and np.array_equal(r["workload_overflow"], e["workload_overflow"]) for r in (first, g)),
              f"{name}: graph totals equal the eager _run_chunk pass bit for bit")
        prog = eng.executable(first["n_lanes"], PRED_STEPS)
        log(f"  {name}: throughput_ips graph {g['throughput_ips']:.1f} vs eager "
            f"{e['throughput_ips']:.1f} ({g['throughput_ips'] / e['throughput_ips']:.2f}x); "
            f"seconds {g['seconds']:.4f} vs {e['seconds']:.4f} ({1e3 * g['seconds'] / first['n_steps']:.4f} "
            f"vs {1e3 * e['seconds'] / first['n_steps']:.4f} ms a step); first_call_seconds graph "
            f"{first['first_call_seconds']:.3f} cold, {g['first_call_seconds']:.3f} warm, eager "
            f"{e['first_call_seconds']:.3f}; build at chunk {PRED_STEPS}: {build_log(prog)}")

    # chunk 1024 on a smaller lane count: 16 lanes a workload, 2048 steps
    lanes, chunk = 16, 1024
    ring = routes["ring+fused_step"][0]
    eng = SimNetEngine(ring.params, pcfg, ring.sim_cfg, use_kernel=True, device=dev)
    g = eng.simulate_many(arrays, n_lanes=lanes, chunk=chunk, timeit=True)
    e = eager_pass(torch, eng, arrays, lanes, chunk)
    check(np.array_equal(g["workload_cycles"], e["workload_cycles"]),
          f"ring+fused_step at {g['n_lanes']} lanes, chunk {chunk}: graph equals eager bit for bit")
    log(f"  ring+fused_step at {g['n_lanes']} lanes x {g['n_steps']} steps, chunk {chunk}: "
        f"throughput_ips graph {g['throughput_ips']:.1f} vs eager {e['throughput_ips']:.1f}; "
        f"first_call_seconds graph {g['first_call_seconds']:.3f} (cache {g['cache']}), eager "
        f"{e['first_call_seconds']:.3f}; build: {build_log(eng.executable(g['n_lanes'], chunk))}")

    # two engines of one kind, other weights, one cache: the weight slots
    other = init_predictor(torch.Generator().manual_seed(SEED + 1), pcfg, dev)
    b = SimNetEngine(other, pcfg, ring.sim_cfg, use_kernel=True, device=dev)
    rb = b.simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS)
    ra = ring.simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS)
    eb = eager_pass(torch, b, arrays, PRED_LANES, PRED_STEPS)
    check(rb["cache"]["hits"] == 1 and rb["cache"]["misses"] == 0,
          f"a second engine of the kind hits the first one's graph ({rb['cache']})")
    check(np.array_equal(rb["workload_cycles"], eb["workload_cycles"])
          and np.array_equal(ra["workload_cycles"], eager["ring+fused_step"]["workload_cycles"])
          and not np.array_equal(ra["workload_cycles"], rb["workload_cycles"]),
          "two engines with different weights through one graph: each equals its own eager totals")

    stats = global_cache(dev).stats()
    log(f"  program cache of {dev}: hits {stats['hits']}, misses {stats['misses']}, "
        f"build seconds {stats['compile_seconds']:.3f}, {stats['n_executables']} programs")
    for key, st in stats["executables"].items():
        log(f"    {key}: 1 miss, {st['hits']} hits, build {st['compile_seconds']:.3f} s")
    return eager


def conv2s_path_phase(torch, params, x):
    """K3's path: the public kernel API, ``ops.conv2s``, chained over the
    C3 trunk's three layers as a caller of the API would."""
    from repro_torch.kernels import ops, ref

    log("[5b] conv2s through the public kernel API: the C3 trunk as three ops.conv2s calls")
    layers = [params[f"conv{i}"] for i in range(3)]
    ops.reset_launches()
    h = x
    for lp in layers:
        h = ops.conv2s(lp, h)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    check(counts["conv2s"] == 3 and sum(counts.values()) == 3,
          f"conv2s launched once per layer ({counts})")
    compare(torch, "conv2s chain vs plain trunk", h,
            ref.cnn_trunk_ref([(lp["w"], lp["b"]) for lp in layers], x))
    # both keep each output's sum in one thread, k ascending with fmaf
    check(torch.equal(h, ops.cnn_trunk(layers, x)),
          f"conv2s chain equals cnn_trunk bit for bit at L={x.shape[0]}")
    return counts["conv2s"]


def device_rows(prof):
    """(device ms, calls, name) of each device-side event kind (kernels,
    copies): a CPU op's device time repeats its kernels' and would count
    them twice."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def profiled(torch, fn, steps):
    """Profile one call of ``fn`` (which runs ``steps`` steps on the card):
    wall, device busy time, device operations and the span between CUDA
    events around the call, whose part not busy is the gaps between device
    operations. None if the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    if not rows:
        return None
    busy = sum(r[0] for r in rows)  # one stream: device events do not overlap
    span = start.elapsed_time(end)
    return dict(rows=rows, wall=wall_ms, busy=busy, span=span, steps=steps,
                ops=sum(r[1] for r in rows) / steps)


def log_profile(what, p, top=6):
    if p is None:
        log(f"  {what}: the profiler reported no device time (not measured)")
        return
    n = p["steps"]
    log(f"  {what} (profiler on): wall {p['wall']:.2f} ms ({p['wall'] / n:.4f} ms/step), device busy "
        f"{p['busy']:.2f} ms ({p['busy'] / n:.4f} ms/step, {100 * p['busy'] / p['wall']:.1f}% of wall), "
        f"{p['ops']:.1f} device operations per step; event span {p['span']:.2f} ms, gaps "
        f"{(p['span'] - p['busy']) / n * 1e3:.1f} us/step ({1e3 * (p['span'] - p['busy']) / (p['ops'] * n):.2f} "
        f"us an operation)")
    for t, count, key in sorted(p["rows"], reverse=True)[:top]:
        log(f"    {key[:100]}: {t:.3f} ms in {count} calls ({100 * t / p['busy']:.1f}% of device time)")


def profile_phase(torch, dev, eng, arrays, steps=32, replays=4):
    """Where the main path's time goes: a profiled window of eager steps
    (`_run_chunk`) beside one of graph replays of the same chunk."""
    from repro_torch.core.simulator import init_state, pack_workloads, packed_tensors, pad_packed_lanes
    from repro_torch.serving.compile_cache import lane_bucket

    small = [{k: v[: PRED_LANES * steps] for k, v in a.items()} for a in arrays]
    packed = pack_workloads(small, PRED_LANES, eng.sim_cfg, pad_to=steps)
    packed = pad_packed_lanes(packed, lane_bucket(packed.n_lanes))
    xs = packed_tensors(packed, dev, 0, steps)
    rw = torch.from_numpy(packed.retire_width).to(dev)
    lc = torch.from_numpy(packed.lane_ctx).to(dev)
    log(f"[6] profile of ring+fused_step, {packed.n_lanes} lanes: {steps} eager steps, then "
        f"{replays} replays of a {steps}-step chunk graph")

    def eager():
        eng._run_chunk(init_state(packed.n_lanes, eng.sim_cfg, dev), xs, rw, lc)

    eager()  # warm
    log_profile("eager steps", profiled(torch, eager, steps))
    prog = eng.executable(packed.n_lanes, steps)

    def graph():
        prog.run(eng.params, [xs] * replays, rw, lc, lambda state: None)

    graph()  # warm
    log_profile("graph replays", profiled(torch, graph, steps * replays))


def tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for t in tree:
            yield from tensors(t)
    else:
        yield tree


def lm_phase(torch, dev):
    """The LM decode main path at full width: prefill, re-home, then greedy
    decoding through DecodeEngine with the flash-decode kernel in every
    layer; then a profiled window of decode steps."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import rehome_state
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import DecodeEngine, copy_state, lm_decoder

    cfg = get_config(LM_ARCH)
    n_local = sum(1 for i in range(cfg.n_layers) if cfg.layer_window(i))
    log(f"[7] LM decode main path: {LM_ARCH} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, head_dim {cfg.head_dim}, "
        f"vocab {cfg.vocab}; {n_local} local layers of window {cfg.local_window}, "
        f"{cfg.n_layers - n_local} global), {cfg.dtype}")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    leaves = list(tensors(params))
    log(f"  random weights (torch.Generator seed {SEED}) in {time.perf_counter() - t0:.1f} s: "
        f"{sum(t.numel() for t in leaves) / 1e9:.3f} B parameters, "
        f"{sum(t.nbytes for t in leaves) / 1e9:.2f} GB on the card")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    tokens = torch.from_numpy(prompts.astype(np.int32)).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits, state = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(logits.shape == (LM_BATCH, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"prefill logits finite, shape {tuple(logits.shape)}")
    check(tuple(state["k"].shape) == (cfg.n_layers, LM_BATCH, LM_PROMPT, cfg.n_kv_heads, cfg.head_dim),
          f"prefill KV cache {tuple(state['k'].shape)}")
    log(f"  prefill {LM_BATCH} x {LM_PROMPT} tokens: {prefill_s:.3f} s "
        f"({LM_BATCH * LM_PROMPT / prefill_s:.0f} tokens/s), peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    full = rehome_state(cfg, state, LM_CACHE)
    del state
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    engine = DecodeEngine(lm_decoder(model, use_kernel=True), params)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    stream, final, tps = engine.generate(full, first, LM_STEPS)
    counts = dict(ops.launches)
    want = cfg.n_layers * LM_STEPS * 2
    check(counts["decode_attn"] == want and sum(counts.values()) == want,
          f"decode_attn launched once per layer and step, warm-up and timed pass: {counts} "
          f"({cfg.n_layers} x {LM_STEPS} x 2 = {want})")
    check(tuple(stream.shape) == (LM_STEPS, LM_BATCH) and stream.dtype == torch.int32
          and bool(((stream >= 0) & (stream < cfg.vocab)).all()), "generated tokens in the vocabulary")
    check(int(final["pos"]) == LM_PROMPT + LM_STEPS, f"final position {int(final['pos'])}")
    del final
    graph = engine.step_graph(full, first)
    log(f"  decode {LM_STEPS} steps x {LM_BATCH} requests (timed pass of generate, graph replays): "
        f"{tps:.1f} tokens/s, {1e3 * LM_BATCH / tps:.3f} ms per decode step, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; step graph: {build_log(graph)}")
    log(f"  first request's tokens: {stream[:16, 0].tolist()} ...")

    def eager_steps(n, st):
        return eager_stream(torch, model, params, st, first, n, use_kernel=True)[0]

    eager_steps(2, copy_state(full))  # warm
    st = copy_state(full)  # copied outside the timed pass, as generate's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_toks = eager_steps(LM_STEPS, st)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    del st
    agree = float((eager_toks == stream).float().mean())
    log(f"  eager decode, same {LM_STEPS} steps: {LM_STEPS * LM_BATCH / eager_s:.1f} tokens/s, "
        f"{1e3 * eager_s / LM_STEPS:.3f} ms per decode step; graph "
        f"{eager_s * tps / (LM_STEPS * LM_BATCH):.2f}x faster; greedy tokens equal to the graph's: "
        f"{100 * agree:.2f}%")

    def k4_share(p):
        if p is not None:
            k4 = [r for r in p["rows"] if "decode_attn_kernel" in r[2]]
            per_step = sum(r[1] for r in k4) / LM_PROFILE_STEPS
            log(f"    decode_attn {sum(r[0] for r in k4):.3f} ms "
                f"({100 * sum(r[0] for r in k4) / p['busy']:.1f}% of device time), {per_step:.1f} "
                "K4 device kernels a step")
            check(per_step == cfg.n_layers, f"one K4 device kernel a layer and step ({cfg.n_layers})")

    st = copy_state(full)
    p = profiled(torch, lambda: eager_steps(LM_PROFILE_STEPS, st), LM_PROFILE_STEPS)
    del st
    log_profile(f"profile of {LM_PROFILE_STEPS} eager decode steps", p, top=8)
    k4_share(p)
    with graph.lock:
        graph.load(full, first)
        p = profiled(torch, lambda: graph.decode(LM_PROFILE_STEPS), LM_PROFILE_STEPS)
    log_profile(f"profile of {LM_PROFILE_STEPS} decode-step graph replays", p, top=8)
    k4_share(p)
    return dict(model=model, params=params, full=full, first=first, stream=stream,
                launches=counts["decode_attn"], ms_step=1e3 * LM_BATCH / tps)


def eager_stream(torch, model, params, state, first, n_steps, use_kernel):
    """Greedy decoding step by step, without a graph, from ``state`` (its
    caches are written in place): (tokens (n, B), logits (n, B, V))."""
    tok, toks, lgs = first, [], []
    with torch.no_grad():
        for _ in range(n_steps):
            lg, state = model.decode_step(params, state, tok, use_kernel=use_kernel)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            toks.append(tok)
            lgs.append(lg)
    return torch.stack(toks), torch.stack(lgs)


def decode_exactness_phase(torch, dev, lm):
    """The decode path's exactness: at reduced depth in f32, the kernel and
    plain paths and the CUDA and CPU runs agree; at full width in bf16,
    teacher-forced, the kernel and plain paths' logits agree."""
    import numpy as np

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import rehome_state
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import DecodeEngine, copy_state, lm_decoder

    cfg = reduced(get_config(LM_ARCH), n_layers=EXACT_LAYERS, dtype="float32")
    windows = [cfg.layer_window(i) for i in range(cfg.n_layers)]
    log(f"[8] decode exactness, {LM_ARCH} reduced to {cfg.n_layers} layers (windows {windows}), "
        f"f32, {EXACT_BATCH} x {EXACT_PROMPT}-token prompts, {EXACT_STEPS} greedy steps")
    model = build_model(cfg)
    prompts = np.random.default_rng(SEED + 1).integers(0, cfg.vocab, (EXACT_BATCH, EXACT_PROMPT))
    runs = {}
    with torch.no_grad():
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            # a CPU generator draws the same weights for both devices
            params = model.init(torch.Generator().manual_seed(SEED), device=device)
            tokens = torch.from_numpy(prompts.astype(np.int32)).to(device)
            for use_kernel in (True, False):
                logits, st = model.prefill(params, {"tokens": tokens})
                full = rehome_state(cfg, st, EXACT_PROMPT + EXACT_STEPS)
                first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                toks, lgs = eager_stream(torch, model, params, copy_state(full), first, EXACT_STEPS,
                                         use_kernel)
                gen, _, _ = DecodeEngine(lm_decoder(model, use_kernel=use_kernel), params).generate(
                    full, first, EXACT_STEPS)
                check(torch.equal(gen, toks), f"{where} use_kernel={use_kernel}: DecodeEngine's greedy "
                      f"stream ({'graph replays' if where == 'card' else 'eager'}) equals the eager "
                      "steps' token for token")
                runs[(where, use_kernel)] = (toks.cpu(), lgs.cpu())
    (tk, lk), (tp, lp) = runs[("card", True)], runs[("card", False)]
    check(torch.equal(tk, tp), f"CUDA: greedy tokens of the kernel path equal the plain path's "
          f"(max |logit diff| {float((lk - lp).abs().max()):.3e})")
    for use_kernel in (True, False):
        (tc, lc), (tg, lg) = runs[("cpu", use_kernel)], runs[("card", use_kernel)]
        d = float((lc - lg).abs().max())
        check(torch.equal(tc, tg) and torch.allclose(lg, lc, rtol=EXACT_TOL, atol=EXACT_TOL),
              f"use_kernel={use_kernel}: CUDA tokens equal the CPU's, logits within {EXACT_TOL} "
              f"(max |diff| {d:.3e})")

    model, params, full, stream = lm["model"], lm["params"], lm["full"], lm["stream"]
    log(f"[8] full width, {model.cfg.dtype}, teacher-forced: the kernel path's greedy stream "
        f"of [7] into both paths, {LM_STEPS} steps")
    sk, sp, tok = copy_state(full), copy_state(full), lm["first"]
    agree, diffs = [], []
    with torch.no_grad():
        for i in range(LM_STEPS):
            a, sk = model.decode_step(params, sk, tok, use_kernel=True)
            b, sp = model.decode_step(params, sp, tok, use_kernel=False)
            if i == 0:
                first_k, first_p = a.float(), b.float()
            agree.append((torch.argmax(a, -1) == torch.argmax(b, -1)).float().mean())
            diffs.append((a.float() - b.float()).abs().max())
            tok = stream[i]
    agree = torch.stack(agree).cpu()
    diffs = torch.stack(diffs).cpu()
    scale = float(first_p.abs().max())
    d0 = float((first_k - first_p).abs().max())
    log(f"  first step: max |logit| {scale:.3f}, max |kernel - plain| {d0:.4f}; over {LM_STEPS} "
        f"steps max |diff| {float(diffs.max()):.4f}, mean of per-step max {float(diffs.mean()):.4f}")
    log(f"  greedy-token agreement, kernel vs plain: {100 * float(agree.mean()):.2f}% of "
        f"{LM_STEPS * LM_BATCH} (step, request) pairs (printed, not asserted: a bf16 near-tie may flip)")
    check(d0 <= FULL_TOL * scale, f"first-step logits of the kernel and plain paths within "
          f"{FULL_TOL} x max |logit| = {FULL_TOL * scale:.4f}")
    return first_k.cpu()


def n_attention_layers(cfg):
    """Layers whose decode runs K4: every layer of the attention families
    (whisper: its decoder's self-attention), the hybrid's attention layers,
    none of rwkv's."""
    return sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))


def family_batch(torch, cfg, device, n, prompt, seed):
    """Prompts from a numpy seed; whisper's stub frames and qwen2-vl's stub
    image patches from a CPU generator (the same inputs on every device)."""
    import numpy as np

    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (n, prompt)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((n, cfg.enc_seq, cfg.d_model), generator=g).to(device)
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.randn((n, min(VLM_PATCHES, prompt // 2), cfg.frontend_dim),
                                       generator=g).to(device)
    return batch


def family_phase(torch, dev, arch, layers, prompt):
    """One LM family's serving path at full width in bf16: random weights
    from a seed, prefill of LM_BATCH prompts, re-homing as serve_lm.py
    does, then LM_STEPS greedy steps through DecodeEngine's step graph
    with K4 in every attention layer; beside it the same steps eager, the
    first step's logits on the kernel and plain paths, and a profiled
    window of replays. Returns the family's numbers."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import DecodeEngine, copy_state, lm_decoder

    whole = get_config(arch)
    cfg = whole if layers is None else dataclasses.replace(whole, n_layers=layers)
    n_attn = n_attention_layers(cfg)
    cut = ("no cut (every layer)" if layers is None else
           f"CUT: {layers} of {whole.n_layers} layers, what one card's 80 GB holds with the "
           "prefill's activations")
    enc = f", encoder {cfg.n_enc_layers} layers over {cfg.enc_seq} stub frames" if cfg.is_encdec else ""
    log(f"[12] {arch} at full width ({cfg.family}: d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} KV, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}{enc}), "
        f"{cfg.dtype}; {cut}; {n_attn} attention layers run K4")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    leaves = list(tensors(params))
    log(f"  random weights (torch.Generator seed {SEED}) in {time.perf_counter() - t0:.1f} s: "
        f"{sum(t.numel() for t in leaves) / 1e9:.3f} B parameters, "
        f"{sum(t.nbytes for t in leaves) / 1e9:.2f} GB on the card")
    batch = family_batch(torch, cfg, dev, LM_BATCH, prompt, SEED)
    extra = "".join(f", {k} {tuple(v.shape)}" for k, v in batch.items() if k != "tokens")
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    vocab = cfg.padded_vocab if cfg.is_encdec else cfg.vocab
    check(tuple(logits.shape) == (LM_BATCH, 1, vocab) and bool(torch.isfinite(logits).all()),
          f"prefill logits finite, shape {tuple(logits.shape)}")
    prefill_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  prefill {LM_BATCH} x {prompt} tokens{extra}: {prefill_s:.3f} s "
        f"({LM_BATCH * prompt / prefill_s:.0f} tokens/s), peak memory {prefill_peak:.2f} GB")
    dropped = None
    if cfg.family == "moe":
        with torch.no_grad():
            _, aux = model.forward(params, batch, logits_mode="last")
        dropped = float(aux["moe_dropped"])
        log(f"  routed (token, choice) pairs of the prefill dropped at capacity factor "
            f"{cfg.capacity_factor} (groups of {cfg.moe_group_size} tokens): {100 * dropped:.3f}% "
            f"(a forward pass over the same prompts); load-balancing loss {float(aux['moe_loss']):.4f}")
        del aux
    full = model.rehome_state(state, prompt + LM_STEPS)
    del state
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    del logits
    engine = DecodeEngine(lm_decoder(model, use_kernel=True), params)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    stream, final, tps = engine.generate(full, first, LM_STEPS)
    counts = dict(ops.launches)
    want = n_attn * LM_STEPS * 2
    check(counts["decode_attn"] == want and sum(counts.values()) == want,
          f"decode_attn launched once per attention layer and step, warm-up and timed pass: "
          f"{counts} ({n_attn} x {LM_STEPS} x 2 = {want})")
    check(tuple(stream.shape) == (LM_STEPS, LM_BATCH) and stream.dtype == torch.int32
          and bool(((stream >= 0) & (stream < cfg.vocab)).all()), "generated tokens in the vocabulary")
    check(int(final["pos"]) == prompt + LM_STEPS, f"final position {int(final['pos'])}")
    del final
    decode_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    graph = engine.step_graph(full, first)
    nodes = graph_nodes(graph)
    log(f"  decode {LM_STEPS} steps x {LM_BATCH} requests (timed pass of generate, graph replays): "
        f"{tps:.1f} tokens/s, {1e3 * LM_BATCH / tps:.3f} ms per decode step, peak memory "
        f"{decode_peak:.2f} GB; step graph: {build_log(graph)}")
    log(f"  first request's tokens: {stream[:16, 0].tolist()} ...")
    eager_stream(torch, model, params, copy_state(full), first, 2, use_kernel=True)  # warm
    st = copy_state(full)  # copied outside the timed pass, as generate's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = FAMILY_EAGER_STEPS
    eager_toks, _ = eager_stream(torch, model, params, st, first, n, use_kernel=True)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    del st
    log(f"  eager decode, the first {n} steps: {n * LM_BATCH / eager_s:.1f} tokens/s, "
        f"{1e3 * eager_s / n:.3f} ms per decode step; graph "
        f"{eager_s * tps / (n * LM_BATCH):.2f}x faster")
    check(torch.equal(eager_toks, stream[:n]), f"greedy tokens of the step graph equal the eager steps' "
          f"({n} x {LM_BATCH})")
    k4_timed, logits0, plain0 = first_step_gates(torch, model, params, full, first, copy_state)
    with graph.lock:
        graph.load(full, first)
        p = profiled(torch, lambda: graph.decode(LM_PROFILE_STEPS), LM_PROFILE_STEPS)
    log_profile(f"profile of {LM_PROFILE_STEPS} decode-step graph replays", p, top=6)
    check(p is not None, "the profiler saw the replays' device time")
    k4_rows = [r for r in p["rows"] if "decode_attn_kernel" in r[2]]
    k4_ms = sum(r[0] for r in k4_rows)
    k4_per_step = sum(r[1] for r in k4_rows) / LM_PROFILE_STEPS
    log(f"    decode_attn {k4_ms:.3f} ms ({100 * k4_ms / p['busy']:.1f}% of device time), "
        f"{k4_per_step:.1f} K4 device kernels a step")
    check(k4_per_step == n_attn, f"the profiler counts {k4_per_step:.1f} K4 device kernels a step, one "
          f"per attention layer ({n_attn})")
    out = dict(arch=arch, layers=cfg.n_layers, prefill_s=prefill_s, tps=tps,
               step_ms=1e3 * LM_BATCH / tps, eager_ms=1e3 * eager_s / n, nodes=nodes,
               build_s=graph.graph.capture_seconds + graph.graph.instantiate_seconds,
               busy=p["busy"] / p["wall"], ops=p["ops"], k4_share=k4_ms / p["busy"],
               k4=counts["decode_attn"], peak=max(prefill_peak, decode_peak), dropped=dropped,
               k4_timed=k4_timed, first=first.cpu().tolist(), stream0=stream[0].cpu().tolist(),
               logits0=logits0, plain0=plain0)
    del engine, graph, full, params, leaves, batch, p
    torch.cuda.empty_cache()
    return out


def first_step_gates(torch, model, params, full, first, copy_state):
    """The first decode step at full width, K4 path against plain path
    (returns K4's times at the step's first shape, and the K4 path's and
    the plain path's logits over the live vocabulary on the CPU).
    (1) Every K4 call of the step against the kernel's plain version on
    the same inputs (the family's real decode shapes), at DECODE_TOL.
    (2) The step's logits over the live vocabulary within FULL_TOL x max
    |logit|. For MoE the plain
    step takes the K4 step's routing (each layer's top-k choice): the two
    paths round the attention output to bf16 at other points, a router
    near-tie can then flip, and a flipped choice moves the token to
    another expert and every later token of its group to another capacity
    slot, a jump no tolerance bounds; the unpinned difference and the
    flipped choices are printed."""
    from repro_torch.kernels import ops, ref
    from repro_torch.nn import moe as moe_lib

    rtol, atol = DECODE_TOL[model.cfg.dtype]
    real_k4, real_top_k = ops.decode_attn, moe_lib._top_k
    seen, picks, timed = [], {"k4": [], "plain": []}, {}

    def held_k4(q, k, v, cache_len, *, window=0):
        out = real_k4(q, k, v, cache_len, window=window)
        key = (tuple(q.shape), tuple(k.shape), window)
        if key not in timed:  # K4 alone at this shape, CUDA events over 20 launches; SDPA beside it
            timed[key] = k4_times(torch, real_k4, q, k, v, cache_len, window)
        want = ref.decode_attn_ref(q, k, v, torch.clamp(cache_len, max=k.shape[1]),
                                   window=window).to(q.dtype)
        seen.append((tuple(q.shape), tuple(k.shape), window,
                     float((out.float() - want.float()).abs().max()),
                     bool(torch.allclose(out.float(), want.float(), rtol=rtol, atol=atol))))
        return out

    def recorder(path):
        def top_k(x, k):
            vals, idx = real_top_k(x, k)
            picks[path].append(idx)
            return vals, idx
        return top_k

    def replay(x, k):  # the K4 step's choice, with this step's own router logits
        idx = next(k4_picks)
        return x.gather(-1, idx), idx

    k4_picks = iter(picks["k4"])
    try:
        with torch.no_grad():
            ops.decode_attn, moe_lib._top_k = held_k4, recorder("k4")
            a, _ = model.decode_step(params, copy_state(full), first, use_kernel=True)
            ops.decode_attn, moe_lib._top_k = real_k4, recorder("plain")
            free, _ = model.decode_step(params, copy_state(full), first, use_kernel=False)
            moe_lib._top_k = replay
            b, _ = model.decode_step(params, copy_state(full), first, use_kernel=False)
    finally:
        ops.decode_attn, moe_lib._top_k = real_k4, real_top_k
    if seen:
        errs = [e for *_, e, _ in seen]
        shapes = sorted({(qs, ks, w) for qs, ks, w, *_ in seen})
        check(all(ok for *_, ok in seen), f"each of the first step's {len(seen)} K4 calls matches its "
              f"plain version on the same inputs (rtol={rtol}, atol={atol}): max_abs_err "
              f"{max(errs):.3e}; q, k/v, window: {shapes}")
        for (qs, ks, w), t in timed.items():
            log(f"  decode_attn at q {qs}, k/v {ks}, window {w} ({t['live']} live positions): kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of the "
                "bound")
    # the live vocabulary: whisper's padded rows carry -1e9 on both paths
    a, b, free = (t[:, :model.cfg.vocab].float() for t in (a, b, free))
    scale = float(b.abs().max())
    d0 = float((a - b).abs().max())
    if picks["k4"]:
        flipped = sum(int((p.sort(-1).values != q.sort(-1).values).any(-1).sum())
                      for p, q in zip(picks["k4"], picks["plain"]))
        total = sum(p.shape[0] * p.shape[1] for p in picks["k4"])
        log(f"  MoE routing: the plain step's own routing picks other experts for {flipped} of "
            f"{total} (token, layer) pairs than the K4 step's; unpinned, its logits differ by max "
            f"|diff| {float((a - free).abs().max()):.4f}")
    check(d0 <= FULL_TOL * scale, f"first-step logits, K4 path vs plain path"
          f"{' (routing pinned to the K4 step)' if picks['k4'] else ''}: max |diff| {d0:.4f} within "
          f"{FULL_TOL} x max |logit| = {FULL_TOL * scale:.4f}")
    return next(iter(timed.values()), None), a.cpu(), b.cpu()


def families_exactness_phase(torch, dev):
    """Every non-dense family at reduced width in f32, as phase [8]: the
    step graph (card) and eager steps (CPU) give the eager stream; kernel
    = plain on the card; card = CPU, tokens equal and logits within
    EXACT_TOL."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import DecodeEngine, copy_state, lm_decoder

    for arch in FAMILY_EXACT_ARCHS:
        cfg = reduced(get_config(arch), dtype="float32")
        model = build_model(cfg)
        seq = FAMILY_EXACT_PROMPT + EXACT_STEPS
        log(f"[12] exactness, {arch} reduced ({cfg.n_layers} layers, d_model {cfg.d_model}), f32, "
            f"{EXACT_BATCH} x {FAMILY_EXACT_PROMPT}-token prompts, {EXACT_STEPS} greedy steps")
        runs = {}
        with torch.no_grad():
            for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
                # a CPU generator draws the same weights for both devices
                params = model.init(torch.Generator().manual_seed(SEED), device=device)
                batch = family_batch(torch, cfg, device, EXACT_BATCH, FAMILY_EXACT_PROMPT, SEED + 1)
                for use_kernel in (True, False):
                    logits, st = model.prefill(params, batch)
                    full = model.rehome_state(st, seq)
                    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                    toks, lgs = eager_stream(torch, model, params, copy_state(full), first,
                                             EXACT_STEPS, use_kernel)
                    gen, _, _ = DecodeEngine(lm_decoder(model, use_kernel=use_kernel), params).generate(
                        full, first, EXACT_STEPS)
                    check(torch.equal(gen, toks), f"{where} use_kernel={use_kernel}: DecodeEngine's "
                          f"greedy stream ({'graph replays' if where == 'card' else 'eager'}) equals "
                          "the eager steps'")
                    runs[(where, use_kernel)] = (toks.cpu(), lgs.cpu())
        (tk, lk), (tp, lp) = runs[("card", True)], runs[("card", False)]
        check(torch.equal(tk, tp), f"CUDA: greedy tokens of the kernel path equal the plain path's "
              f"(max |logit diff| {float((lk - lp).abs().max()):.3e})")
        for use_kernel in (True, False):
            (tc, lc), (tg, lg) = runs[("cpu", use_kernel)], runs[("card", use_kernel)]
            d = float((lc - lg).abs().max())
            check(torch.equal(tc, tg) and torch.allclose(lg, lc, rtol=EXACT_TOL, atol=EXACT_TOL),
                  f"use_kernel={use_kernel}: CUDA tokens equal the CPU's, logits within {EXACT_TOL} "
                  f"(max |diff| {d:.3e})")


def families_phase(torch, dev):
    """Phase [12]: each other LM family at full width on the card, one at
    a time (each freed before the next loads), then their exactness at
    reduced width. Returns each family's numbers by arch."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                 check=True, capture_output=True, text=True).stdout.strip()
    results = [family_phase(torch, dev, arch, layers, prompt) for arch, layers, prompt in FAMILY_RUNS]
    log(f"[12] summary ({smi}): arch | layers | prefill s | graph tokens/s | graph ms/step | eager "
        "ms/step | build s | graph nodes | device busy | device ops/step | K4 share | K4 launches | "
        "K4 ms / bound ms / SDPA ms | peak GB | dropped")
    for r in results:
        dropped = "-" if r["dropped"] is None else f"{100 * r['dropped']:.3f}%"
        t = r["k4_timed"]
        k4 = "-" if t is None else f"{t['ms']:.4f} / {t['bound_ms']:.4f} / {t['library_ms']:.4f}"
        log(f"  {r['arch']} | {r['layers']} | {r['prefill_s']:.3f} | {r['tps']:.1f} | {r['step_ms']:.3f} | "
            f"{r['eager_ms']:.3f} | {r['build_s']:.3f} | {r['nodes']} | {100 * r['busy']:.1f}% | "
            f"{r['ops']:.1f} | {100 * r['k4_share']:.1f}% | {r['k4']} | {k4} | {r['peak']:.2f} | {dropped}")
    families_exactness_phase(torch, dev)
    return {r["arch"]: r for r in results}
    return sum(r["k4"] for r in results)


def train_exactness(torch, dev):
    """Phase [13](a): each family at reduced width in f32, the same masters
    (drawn by a CPU generator) and batches on the card and the CPU, 3
    train steps at accum_steps 2: losses, grad norms and the final params
    held card against CPU."""
    import numpy as np

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import extras_for
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamConfig, adam_init
    from repro_torch.training.train_loop import make_train_step

    for arch, over in TRAIN_EXACT_ARCHS:
        cfg = reduced(get_config(arch), dtype="float32", **over)
        model = build_model(cfg)
        step = make_train_step(model, AdamConfig(lr=TRAIN_EXACT_LR), accum_steps=TRAIN_EXACT_ACCUM)
        rng = np.random.default_rng(SEED)
        batches = []
        for _ in range(TRAIN_EXACT_STEPS):
            b = {"tokens": rng.integers(0, cfg.vocab, (TRAIN_EXACT_BATCH, TRAIN_EXACT_SEQ)).astype(np.int32),
                 "loss_mask": np.ones((TRAIN_EXACT_BATCH, TRAIN_EXACT_SEQ), np.float32)}
            b.update({k: f(TRAIN_EXACT_BATCH, TRAIN_EXACT_SEQ) for k, f in extras_for(cfg).items()})
            batches.append(b)
        runs = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            params = model.init(torch.Generator().manual_seed(SEED), device=device, masters=True)
            opt = adam_init(params)
            hist = []
            t0 = time.perf_counter()
            for b in batches:
                params, opt, m = step(params, opt, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            runs[where] = (np.array(hist), params, time.perf_counter() - t0)
        (hc, pc, tc), (hh, ph, th) = runs["card"], runs["cpu"]
        loss_rel = float(np.max(np.abs(hc[:, 0] - hh[:, 0]) / np.abs(hh[:, 0])))
        norm_rel = float(np.max(np.abs(hc[:, 1] - hh[:, 1]) / np.abs(hh[:, 1])))
        p_diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(tensors(pc), tensors(ph)))
        log(f"[13] (a) {arch} reduced ({cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}), "
            f"f32: losses {hc[:, 0].round(5).tolist()}, grad norms {hc[:, 1].round(4).tolist()}; "
            f"card {tc:.2f} s, CPU {th:.2f} s for {TRAIN_EXACT_STEPS} steps")
        check(np.isfinite(hc).all() and loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_NORM_RTOL
              and p_diff <= 2 * TRAIN_EXACT_LR,
              f"{arch}: card = CPU over {TRAIN_EXACT_STEPS} steps at accum_steps {TRAIN_EXACT_ACCUM}: "
              f"losses max rel diff {loss_rel:.2e} (<= {TRAIN_LOSS_RTOL}), grad norms {norm_rel:.2e} "
              f"(<= {TRAIN_NORM_RTOL}), params max |diff| {p_diff:.2e} (<= 2 x lr)")


def train_resume(torch, dev):
    """Phase [13](b): reduced tinyllama trains 2 steps on the card and
    checkpoints; the checkpoint restores bit for bit, and a fresh train()
    resumes from it for 2 more steps."""
    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch.train import restore_state, train
    from repro_torch.models.registry import build_model

    model = build_model(get_reduced_config(LM_TRAIN_ARCH))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        kw = dict(reduced=True, batch=4, seq=64, ckpt_dir=tmp, device=dev, log_every=0)
        first = train(LM_TRAIN_ARCH, steps=2, **kw)
        params, opt, step = restore_state(CheckpointManager(tmp), model, dev, first["params"])
        pairs = list(zip(tensors(params), tensors(first["params"]))) + list(zip(
            tensors({k: opt[k] for k in ("m", "v")}), tensors({k: first["opt"][k] for k in ("m", "v")})))
        same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b) for a, b in pairs)
        check(step == 2 and same and torch.equal(opt["step"], first["opt"]["step"]),
              f"[13] (b) {LM_TRAIN_ARCH} reduced on the card: the checkpoint of step 2 restores "
              f"{len(pairs)} master and Adam tensors and the step bit for bit")
        second = train(LM_TRAIN_ARCH, steps=4, **kw)
    check(len(second["losses"]) == 2 and np.isfinite(second["losses"]).all()
          and int(second["opt"]["step"]) == 4,
          f"a fresh train() resumed at step 2 and ran 2 more: losses {np.round(second['losses'], 4).tolist()} "
          f"(first run {np.round(first['losses'], 4).tolist()})")


def train_kernel_kinds(rows):
    """Device ms of a profile's kernels by `TRAIN_KERNEL_KINDS`, the rest
    as elementwise."""
    out = {}
    for t, _, key in rows:
        kind = next((k for k, rx in TRAIN_KERNEL_KINDS if re.search(rx, key, re.I)), "elementwise, other")
        out[kind] = out.get(kind, 0.0) + t
    return out


def lm_train_phase(torch, dev, smi):
    """Phase [13]: LM training. (a) card = CPU for every family at reduced
    width, (b) resume on the card, (c) tinyllama-1.1b at full width for
    LM_TRAIN_STEPS steps of launch.train.train, timed and profiled, (d) its
    trained masters served through DecodeEngine with K4, the first step
    held to the plain path."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenLoader
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import DecodeEngine, copy_state, lm_decoder
    from repro_torch.training import losses, optimizer
    from repro_torch.training.train_loop import make_train_step

    t_phase = time.perf_counter()
    train_exactness(torch, dev)
    train_resume(torch, dev)

    cfg = get_config(LM_TRAIN_ARCH)
    B, S, L = LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.n_layers
    tokens = B * S
    log(f"[13] (c) {LM_TRAIN_ARCH} at full width ({L} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads / {cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab}), {cfg.dtype} on f32 masters, "
        f"remat {cfg.remat}, accum_steps {cfg.accum_steps}: {LM_TRAIN_STEPS} steps of launch.train.train "
        f"at batch {B} x seq {S} ({tokens} tokens a step), lr {LM_TRAIN_LR}, synthetic corpus ({smi})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = train(LM_TRAIN_ARCH, reduced=False, steps=LM_TRAIN_STEPS, batch=B, seq=S, lr=LM_TRAIN_LR,
                device=dev, log_every=5)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses_c = np.array(res["losses"])
    norms = np.array([m["grad_norm"] for m in res["metrics"]])
    step_s = np.array(res["monitor"].history)
    n_params = sum(t.numel() for t in tensors(res["params"]))
    ms = 1e3 * float(np.median(step_s[2:]))
    attn = 6 * L * B * cfg.n_heads * cfg.head_dim * S * S
    flops = 6 * n_params * tokens + attn
    log(f"  {LM_TRAIN_STEPS} steps in {wall:.1f} s (init included); step ms: first {1e3 * step_s[0]:.1f}, "
        f"second {1e3 * step_s[1]:.1f}, median of the rest {ms:.1f} (min {1e3 * step_s[2:].min():.1f}, max "
        f"{1e3 * step_s[2:].max():.1f}); {tokens / ms * 1e3:.0f} tokens/s; peak memory {peak:.2f} GB ({smi})")
    log(f"  model FLOPs a step {flops:.4e} = 6 x N x tokens + 6 x L x B x H x hd x S^2 (causal QK and PV, "
        f"forward and backward) = 6 x {n_params} x {tokens} + 6 x {L} x {B} x {cfg.n_heads} x "
        f"{cfg.head_dim} x {S}^2; {flops / ms * 1e-9:.1f} TFLOP/s = "
        f"{100 * flops / (ms * 1e-3) / PEAK_BF16_FLOPS:.2f}% of the {PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s "
        f"bf16 dense peak ({smi})")
    log(f"  losses: first {losses_c[:3].round(4).tolist()}, last {losses_c[-5:].round(4).tolist()}; "
        f"grad norms: first {norms[:3].round(3).tolist()}, last {norms[-3:].round(3).tolist()}")
    check(len(losses_c) == LM_TRAIN_STEPS and np.isfinite(losses_c).all()
          and losses_c[-5:].mean() < losses_c[0],
          f"{LM_TRAIN_STEPS} losses finite, the last 5's mean {losses_c[-5:].mean():.4f} below the first "
          f"{losses_c[0]:.4f}")
    check(np.isfinite(norms).all() and (norms > 0).all(), "grad_norm finite and above 0 on every step")

    # where a step's time goes: LM_TRAIN_PROFILE_STEPS more steps profiled
    model = build_model(cfg)
    step_fn = make_train_step(model, optimizer.AdamConfig(
        lr=LM_TRAIN_LR, warmup_steps=max(LM_TRAIN_STEPS // 10, 1), decay_steps=LM_TRAIN_STEPS),
        accum_steps=cfg.accum_steps)
    loader = TokenLoader(cfg.vocab, B, S)
    try:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(loader).items()}
    finally:
        loader.close()
    state = {"params": res.pop("params"), "opt": res.pop("opt")}

    def steps():
        for _ in range(LM_TRAIN_PROFILE_STEPS):
            state["params"], state["opt"], _ = step_fn(state["params"], state["opt"], batch)

    p = profiled(torch, steps, LM_TRAIN_PROFILE_STEPS)
    log_profile(f"profile of {LM_TRAIN_PROFILE_STEPS} train steps", p, top=10)
    if p is not None:
        for kind, t in sorted(train_kernel_kinds(p["rows"]).items(), key=lambda kv: -kv[1]):
            log(f"    by kind: {kind}: {t / LM_TRAIN_PROFILE_STEPS:.2f} ms a step "
                f"({100 * t / p['busy']:.1f}% of device time)")
    # the CE (forward and backward, one microbatch's logits) and Adam over
    # the whole tree, alone
    mb = B // cfg.accum_steps
    logits = torch.randn((mb, S, cfg.vocab), device=dev, dtype=torch.bfloat16, requires_grad=True)

    def ce():
        losses.next_token_ce(logits, batch["tokens"][:mb], batch["loss_mask"][:mb]).backward()

    ce_ms = time_ms(torch, ce, iters=5, warmup=1)
    del logits
    acfg = optimizer.AdamConfig(lr=LM_TRAIN_LR)

    def adam():
        optimizer.adam_update(state["params"], state["opt"], state["params"], acfg)

    adam_ms = time_ms(torch, adam, iters=3, warmup=1)
    pa = profiled(torch, adam, 1)
    adam_kernels = "not measured" if pa is None else f"{pa['ops']:.0f}"
    n_leaves = sum(1 for _ in tensors(state["params"]))
    wide = [t for t in tensors(state["params"]) if t.ndim >= 2]
    cast_ms = time_ms(torch, lambda: [t.to(torch.bfloat16) for t in wide], iters=3, warmup=1)
    log(f"  alone: next_token_ce forward + backward on ({mb}, {S}, {cfg.vocab}) bf16 logits "
        f"{ce_ms:.2f} ms (x {cfg.accum_steps} microbatches a step); adam_update over {n_leaves} leaves "
        f"({n_params} f32 params) {adam_ms:.2f} ms in {adam_kernels} device kernels; one f32 -> bf16 "
        f"cast of the {len(wide)} matrices {cast_ms:.2f} ms ({smi})")

    # (d) the trained masters as serving storage, decoded with K4
    storage = model.to_storage(state.pop("params"))
    del state, batch
    torch.cuda.empty_cache()
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, LM_TRAIN_DECODE_PROMPT)).astype(np.int32)).to(dev)
    with torch.no_grad():
        logits, st = model.prefill(storage, {"tokens": prompts})
    full = model.rehome_state(st, LM_TRAIN_DECODE_PROMPT + LM_TRAIN_DECODE_STEPS)
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    del logits
    # the first step's K4 calls at tinyllama's decode shape (a group of 8)
    # against the plain version, and its logits against the plain path
    first_step_gates(torch, model, storage, full, first, copy_state)
    ops.reset_launches()
    gen, _, tps = DecodeEngine(lm_decoder(model, use_kernel=True), storage).generate(
        full, first, LM_TRAIN_DECODE_STEPS)
    counts = dict(ops.launches)
    want = L * LM_TRAIN_DECODE_STEPS * 2
    check(storage["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
          and counts.get("decode_attn") == want and sum(counts.values()) == want
          and tuple(gen.shape) == (LM_TRAIN_DECODE_STEPS, B)
          and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          f"(d) the trained masters as bf16 storage decode {LM_TRAIN_DECODE_STEPS} greedy steps through "
          f"DecodeEngine with K4 ({counts}; {L} x {LM_TRAIN_DECODE_STEPS} x 2 = {want}), tokens in the "
          f"vocabulary, {tps:.1f} tokens/s; first request {gen[:, 0].tolist()}")
    log(f"[13] LM training phase: {time.perf_counter() - t_phase:.1f} s")
    return counts["decode_attn"], float(losses_c[0])


def kinds_phase(torch, dev, arrays):
    """Every other predictor kind at full width (its default config, ctx
    64), weights from a seed through a predictor artifact, on the pack's
    8 workloads x KIND_LANES lanes x PRED_STEPS steps in one chunk: the
    chunk graph against the eager pass, and a reduced pack on the card
    against the CPU."""
    import numpy as np

    from repro_torch.checkpoint import PredictorArtifact
    from repro_torch.core import simulator as sim
    from repro_torch.core.predictor import (PredictorConfig, inference_mflops, init_predictor,
                                            lstm_cells, lstm_stack)
    from repro_torch.kernels import ops
    from repro_torch.serving.simnet_engine import SimNetEngine

    pack = [{k: v[: KIND_LANES * PRED_STEPS] for k, v in a.items()} for a in arrays]
    small = [{k: v[: KIND_CPU_LANES * PRED_STEPS] for k, v in a.items()} for a in arrays]
    log(f"[9] predictor kinds at full width: {len(pack)} workloads x {KIND_LANES} lanes x "
        f"{PRED_STEPS} steps, chunk {PRED_STEPS}, plain PyTorch (the kernels serve c1/c3's "
        f"use_kernel only; the lstm runs through cuDNN {torch.backends.cudnn.version()})")
    for kind in OTHER_KINDS:
        pcfg = PredictorConfig(kind=kind)
        params = init_predictor(torch.Generator().manual_seed(SEED), pcfg, dev)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            PredictorArtifact(params, pcfg, sim.SimConfig(ctx_len=pcfg.ctx_len)).save(tmp)
            art = PredictorArtifact.load(tmp, device=dev)
            on_cpu = PredictorArtifact.load(tmp, device="cpu")
        check(art.pcfg == pcfg and all(torch.equal(a, b) for a, b in
                                       zip(tensors(art.params), tensors(params))),
              f"{kind}: params through a PredictorArtifact bit for bit")
        eng = SimNetEngine(art.params, art.pcfg, art.sim_cfg, device=dev)
        ops.reset_launches()
        g = eng.simulate_many(pack, n_lanes=KIND_LANES, chunk=PRED_STEPS, timeit=True)
        check(sum(ops.launches.values()) == 0, f"{kind}: no hand-written kernel launched")
        check(np.isfinite(g["workload_cycles"]).all(), f"{kind}: totals finite")
        e = eager_pass(torch, eng, pack, KIND_LANES, PRED_STEPS)
        check(np.array_equal(g["workload_cycles"], e["workload_cycles"])
              and np.array_equal(g["workload_overflow"], e["workload_overflow"]),
              f"{kind}: graph totals equal the eager pass bit for bit")
        card = eng.simulate_many(small, n_lanes=KIND_CPU_LANES, chunk=PRED_STEPS)
        cpu = SimNetEngine(on_cpu.params, pcfg, on_cpu.sim_cfg, device="cpu").simulate_many(
            small, n_lanes=KIND_CPU_LANES, chunk=PRED_STEPS)
        rel = np.abs(card["workload_cycles"] - cpu["workload_cycles"]) / cpu["workload_cycles"]
        check(rel.max() < PRED_RTOL, f"{kind}: reduced pack ({card['n_lanes']} lanes) on the card "
              f"within {PRED_RTOL} of the CPU (max rel diff {rel.max():.3e})")
        log(f"  {kind}: {inference_mflops(pcfg):.3f} MFLOPs an inference; throughput_ips graph "
            f"{g['throughput_ips']:.1f} vs eager {e['throughput_ips']:.1f} "
            f"({g['throughput_ips'] / e['throughput_ips']:.2f}x); first_call_seconds "
            f"{g['first_call_seconds']:.3f} (eager {e['first_call_seconds']:.3f}); build: "
            f"{build_log(eng.executable(g['n_lanes'], PRED_STEPS))}")
        log(f"    cycles {g['workload_cycles'].tolist()}")
        if kind == "lstm2":
            state, cur = populated_state(torch, sim, dev, lanes=g["n_lanes"])
            x = sim.model_input(state, cur["feat"], cur["addr"], sim.SimConfig(ctx_len=pcfg.ctx_len))
            with torch.no_grad():
                fused, cells = lstm_stack(art.params, x, pcfg), lstm_cells(art.params, x, pcfg)
                err = float((fused - cells).abs().max())
                check(torch.allclose(fused, cells, rtol=LSTM_RTOL, atol=LSTM_RTOL),
                      f"lstm2: cuDNN's fused LSTM equals the step-by-step cells at B={x.shape[0]} "
                      f"(max_abs_err {err:.3e}, rtol=atol={LSTM_RTOL})")
                log(f"  lstm2 trunk at B={x.shape[0]}, N={x.shape[1]}: cuDNN "
                    f"{time_ms(torch, lambda: lstm_stack(art.params, x, pcfg)):.4f} ms vs step-by-step "
                    f"cells {time_ms(torch, lambda: lstm_cells(art.params, x, pcfg), iters=5):.4f} ms")


def training_phase(torch, dev, traces, arrays):
    """The training path on the card: the teacher-forced dataset of the
    pack's traces, c3 trained for TRAIN_EPOCHS epochs, its prediction
    errors, and the trained artifact simulated through K1 and plain."""
    import numpy as np

    from repro_torch.checkpoint import PredictorArtifact
    from repro_torch.core.dataset import build_dataset, teacher_forced_samples
    from repro_torch.core.predictor import PredictorConfig
    from repro_torch.core.session import prediction_errors, train_loop
    from repro_torch.core.simulator import SimConfig
    from repro_torch.serving.simnet_engine import SimNetEngine

    cfg = SimConfig(ctx_len=Q)
    log(f"[10] training on the card: dataset of {len(traces)} DES traces x {traces[0].n} "
        f"instructions at ctx {Q} ({PRED_LANES} lanes a trace), then c3 for {TRAIN_EPOCHS} epochs "
        f"at batch {TRAIN_BATCH}, lr {TRAIN_LR}")
    t0 = time.perf_counter()
    data = build_dataset(traces, cfg, n_lanes=PRED_LANES, seed=SEED, device=dev)
    n = {k: len(v) for k, v in data.items() if k.endswith("_x")}
    log(f"  build_dataset: {time.perf_counter() - t0:.2f} s; {n} samples after dedup of "
        f"{len(traces) * traces[0].n}; X {data['train_x'].dtype} "
        f"{sum(v.nbytes for v in data.values()) / 1e9:.2f} GB on the host")
    card = teacher_forced_samples(traces[0], cfg, n_lanes=PRED_LANES, device=dev)
    cpu = teacher_forced_samples(traces[0], cfg, n_lanes=PRED_LANES, device="cpu")
    check(all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(card, cpu)),
          f"{traces[0].name}: X ({card[0].dtype}, {card[0].shape}) and Y built on the card equal "
          "the CPU's bit for bit")

    pcfg = PredictorConfig()
    params, hist = train_loop(data, pcfg, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                              seed=SEED, device=dev)
    steps = len(data["train_x"]) // TRAIN_BATCH
    for ep, secs in enumerate(hist["step_seconds"]):
        log(f"  epoch {ep}: {steps} steps in {secs:.3f} s, {1e3 * secs / steps:.3f} ms a train step, "
            f"{steps * TRAIN_BATCH / secs:.0f} samples/s; train loss {hist['train_loss'][ep]:.4f}, "
            f"val loss {hist['val_loss'][ep]:.4f}")
    losses = np.asarray(hist["step_loss"])
    log(f"  step losses: first {losses[:5].round(4).tolist()}, last {losses[-5:].round(4).tolist()}")
    check(np.isfinite(losses).all() and len(losses) == TRAIN_EPOCHS * steps
          and losses[-steps:].mean() < losses[:steps].mean(), "losses finite, and the second epoch's "
          "below the first's")
    _, cpu_hist = train_loop(data, pcfg, epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
                             device="cpu")
    want = np.asarray(cpu_hist["step_loss"][:TRAIN_CMP_STEPS])
    rel = np.abs(losses[:TRAIN_CMP_STEPS] - want) / np.abs(want)
    log(f"  CPU train_loop, the same weights and batches: {1e3 * cpu_hist['step_seconds'][0] / steps:.3f} "
        f"ms a step; first {TRAIN_CMP_STEPS} step losses, max rel diff {rel.max():.3e}; over the "
        f"epoch {float((np.abs(losses[:steps] - cpu_hist['step_loss']) / np.abs(cpu_hist['step_loss'])).max()):.3e}")
    check(rel.max() < TRAIN_RTOL, f"the first {TRAIN_CMP_STEPS} step losses on the card within "
          f"{TRAIN_RTOL} of the CPU's")
    errs = prediction_errors(params, pcfg, data["test_x"], data["test_y"])
    log(f"  prediction_errors on {len(data['test_x'])} test samples: {errs}")

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        PredictorArtifact(params, pcfg, cfg, metadata={"history": {k: hist[k] for k in
                                                                   ("train_loss", "val_loss")}}).save(tmp)
        art = PredictorArtifact.load(tmp, device=dev)
    res = {}
    for use_kernel in (True, False):
        eng = SimNetEngine(art.params, art.pcfg, art.sim_cfg, use_kernel=use_kernel, device=dev)
        check(eng.fused == use_kernel, f"use_kernel={use_kernel}: {'ring + K1' if use_kernel else 'plain'}")
        res[use_kernel] = eng.simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS)
    k1, plain = res[True]["workload_cycles"], res[False]["workload_cycles"]
    rel = np.abs(k1 - plain) / plain
    check(np.isfinite(k1).all() and rel.max() < PRED_RTOL,
          f"trained artifact: ring + K1 totals within {PRED_RTOL} of plain (max rel diff {rel.max():.3e})")
    log(f"  CPI of the trained c3 (ring + K1) against the DES, {PRED_LANES} lanes a workload "
        "(reported, not a gate):")
    for tr, c, total in zip(traces, res[True]["workload_cpi"], k1):
        log(f"    {tr.name}: predicted {c:.4f} ({total:.0f} cycles) vs DES {tr.cpi:.4f} "
            f"({tr.total_cycles} cycles), {100 * (c - tr.cpi) / tr.cpi:+.1f}%")


def start_cli(args):
    """``python -m repro_torch ARGS`` started as a child process on the
    card, in a session of its own (a fleet's replicas are its children: a
    timeout kills the whole group), its output into files, so a child that
    runs beside others never waits on a full pipe. Returns (process, start
    time, its stdout and stderr files)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, err = (tempfile.TemporaryFile("w+", dir=ROOT / "build") for _ in range(2))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch", *map(str, args)], env=env,
                            stdout=out, stderr=err, text=True, start_new_session=True)
    return proc, time.perf_counter(), out, err


def finish_cli(started, timeout):
    """Waits for a `start_cli` child. Returns (exit code, parsed JSON of its
    standard output or None, seconds, stderr tail)."""
    import os
    import signal

    proc, t0, out_f, err_f = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise RuntimeError(f"python -m repro_torch {' '.join(map(str, proc.args[3:]))} ran past "
                           f"{timeout} s")
    secs = time.perf_counter() - t0
    out_f.seek(0)
    err_f.seek(0)
    out, err = out_f.read(), err_f.read()
    out_f.close()
    err_f.close()
    try:
        doc = json.loads(out)
    except json.JSONDecodeError:
        doc = None
    return proc.returncode, doc, secs, err[-3000:]


def run_cli(args, timeout):
    """`start_cli`, then `finish_cli`."""
    return finish_cli(start_cli(args), timeout)


def stop_cli(started):
    """Kills a `start_cli` child's session if it still runs."""
    import os
    import signal

    if started is not None and started[0].poll() is None:
        os.killpg(started[0].pid, signal.SIGKILL)
        started[0].wait()


def pcts(samples):
    import numpy as np

    return f"p50 {np.percentile(samples, 50):.1f} ms, p99 {np.percentile(samples, 99):.1f} ms"


def hist_pcts(snap):
    """p50/p99 of a telemetry histogram snapshot (bucket-edge estimates)."""
    return f"p50 {snap['p50']:.1f} ms, p99 {snap['p99']:.1f} ms (n={snap['count']})"


def serving_phase(torch, dev, pcfg, params, arrays):
    """The serving tier on the card: the `SimNet` session through its
    `SimServe` (K1 on the served path), two resident models of one kind on
    one graph, the HTTP tier, the CLI's ``simulate`` and ``serve --jobs``,
    a 2-replica fleet and the chaos drill as child processes, and a
    one-shot ``simulate`` at three chunk sizes."""
    import threading

    import numpy as np

    from repro_torch.checkpoint import PredictorArtifact
    from repro_torch.core import api
    from repro_torch.core.predictor import init_predictor
    from repro_torch.core.session import SimNet
    from repro_torch.core.simulator import SimConfig, max_packed_steps
    from repro_torch.kernels import ops
    from repro_torch.serving.compile_cache import CompileCache, chunk_bucket
    from repro_torch.serving.http import SimServeHTTP, http_request, wait_job
    from repro_torch.serving.service import SimServe
    from repro_torch.serving.simnet_engine import SimNetEngine

    log(f"[11] serving tier on the card: {len(arrays)} workloads x {PRED_LANES} lanes x "
        f"{PRED_STEPS} steps, c3 at full width through an artifact (seed {SEED}), ring, f32")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        art_dir = Path(tmp) / "c3"
        PredictorArtifact(params, pcfg, SimConfig(ctx_len=pcfg.ctx_len), {"seed": SEED}).save(art_dir)
        art = PredictorArtifact.load(art_dir, device=dev)
        lanes = [PRED_LANES] * len(arrays)
        chunk = chunk_bucket(max_packed_steps(arrays, lanes), 1024)  # what the service picks
        direct = SimNetEngine(art.params, art.pcfg, art.sim_cfg, use_kernel=True, device=dev
                              ).simulate_many(arrays, n_lanes=PRED_LANES, chunk=chunk)

        # -- the session through its service's drain loop, a cold cache
        sn = SimNet(art, use_kernel=True, background=True, cache=CompileCache(), device=dev)
        sn.service.max_wait_ms = 50.0  # a window that every submit of the call makes
        ops.reset_launches()
        with sn:
            res = sn.simulate_many(arrays, n_lanes=PRED_LANES)
            st = sn.stats()
        served = dict(ops.launches)
        got = np.asarray([w.total_cycles for w in res])
        log(f"  SimNet(background=True).simulate_many: throughput_ips={res.throughput_ips:.1f} "
            f"seconds={res.seconds:.4f} first_call_seconds={res.first_call_seconds:.3f} "
            f"cache={res.cache}; launches {served}")
        log(f"  service: jobs_per_batch={st['jobs_per_batch']:.1f} batches={st['batches']} "
            f"queue_wait_ms {hist_pcts(st['telemetry']['queue_wait_ms'])}, service_ms "
            f"{hist_pcts(st['telemetry']['service_ms'])}")
        log(f"  engine direct (chunk {chunk}): throughput_ips={direct['throughput_ips']:.1f} "
            f"seconds={direct['seconds']:.4f}")
        check(np.array_equal(got, direct["workload_cycles"]),
              "served totals equal the engine's direct simulate_many bit for bit")
        check(served["fused_step"] == direct["n_steps"] > 0 and served["cnn_trunk"] == 0
              and st["loop_errors"] == 0,
              f"the served path launched K1 once a step ({served['fused_step']} fused_step launches)")

        # -- two resident models of one kind alternate on one chunk graph
        other = init_predictor(torch.Generator().manual_seed(SEED + 1), pcfg, dev)
        two = SimServe(use_kernel=True, device=dev)
        two.register("a", art)
        two.register("b", params=other, pcfg=pcfg, sim_cfg=art.sim_cfg)
        engines = {"a": SimNetEngine(art.params, pcfg, art.sim_cfg, use_kernel=True, device=dev),
                   "b": SimNetEngine(other, pcfg, art.sim_cfg, use_kernel=True, device=dev)}
        order, handles = [], []
        for i in range(3):  # each round: one job a model, drained a then b
            handles.append({m: two.submit(arrays[i], m, n_lanes=PRED_LANES) for m in "ab"})
            order += [r.model_id for r in two.drain()]
        prog = two.registry.get("a").executable(PRED_LANES, chunk)
        refills = prog.refills
        log(f"  two residents of one kind, {len(order)} batches {order}: weight-slot refills of "
            f"their one chunk graph {refills} (the first binding included)")
        check(order == ["a", "b"] * 3 and refills == len(order)
              and prog is two.registry.get("b").executable(PRED_LANES, chunk),
              "two models of one kind share one graph, which refills its weight slots at every turn")
        same = all(h.result().total_cycles == float(engines[m].simulate_many(
            [arrays[i]], n_lanes=PRED_LANES, chunk=chunk)["workload_cycles"][0])
            for i, hs in enumerate(handles) for m, h in hs.items())
        check(same, "each of their jobs equals its own engine's direct total")

        # -- the HTTP tier: wire arrays from client threads. Each job rides
        # a batch of its own (max_batch_lanes = its lanes), in-process as
        # over the wire, so both run the same programs at the same shapes
        def http_service():
            serve = SimServe(max_batch_lanes=PRED_LANES, use_kernel=True, device=dev)
            serve.register("c3", art)
            return serve

        inproc = http_service()
        hs = [inproc.submit(a, "c3", n_lanes=PRED_LANES) for a in arrays]
        inproc.drain()
        want = [h.result().total_cycles for h in hs]
        t0 = time.perf_counter()
        wires = [{k: np.asarray(v).tolist() for k, v in a.items()} for a in arrays]
        log(f"  wire arrays of {len(wires)} workloads made in {time.perf_counter() - t0:.2f} s")
        wired, lat, errors = {}, {}, []
        serve = http_service()
        with SimServeHTTP(serve) as front:
            def client(c):
                try:
                    for i in range(c, len(wires), HTTP_CLIENTS):
                        t = time.perf_counter()
                        code, body = http_request(f"{front.url}/v1/jobs", "POST", {
                            "trace": wires[i], "model": "c3", "lanes": PRED_LANES, "id": f"w{i}"},
                            timeout=300)
                        if code != 202:
                            raise RuntimeError(f"POST w{i}: {code} {body}")
                        done = wait_job(front.url, body["job_id"], timeout=300)
                        lat[i] = (time.perf_counter() - t) * 1e3
                        wired[i] = done
                except Exception as e:  # noqa: BLE001 - raised below, on the main thread
                    errors.append(e)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            _, hst = http_request(f"{front.url}/v1/stats")
        serve.stop()
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"HTTP clients failed: {errors}")
        log(f"  HTTP: {len(wires)} requests from {HTTP_CLIENTS} client threads in {wall:.2f} s = "
            f"{len(wires) / wall:.2f} requests/s; request latency (post to result) "
            f"{pcts(list(lat.values()))}; service_ms {hist_pcts(hst['telemetry']['service_ms'])}, "
            f"jobs_per_batch {hst['jobs_per_batch']:.1f}")
        check(all(wired[i]["status"] == "done" for i in range(len(wires)))
              and [wired[i]["result"]["total_cycles"] for i in range(len(wires))] == want,
              "wire totals equal the in-process submits' bit for bit")
        log(f"  (a job alone in a {PRED_LANES}-lane batch vs all {len(arrays)} in one "
            f"{direct['n_lanes']}-lane batch: equal totals for {sum(a == b for a, b in zip(want, got))} "
            f"of {len(want)} workloads; not a gate)")

        # -- the CLI as child processes. The chaos drill (its own tiny
        # models) and the 2-replica fleet run beside simulate --use-kernel
        # and serve --jobs, whose times they share the card with
        chaos = fleet = None
        try:
            chaos = start_cli(["chaos", "--quick", "--batch-timeout-s", CHAOS_WATCHDOG_S])
            tr_dir = Path(tmp) / "traces"
            cli_traces = api.generate_traces(CLI_BENCHES, CLI_N, cache_dir=str(tr_dir))
            want = SimNet(art, use_kernel=True, device=dev).simulate_many(cli_traces, n_lanes=CLI_LANES)
            rc, out, secs, err = run_cli(
                ["simulate", "--artifact", art_dir, "--use-kernel", "--bench", *CLI_BENCHES,
                 "-n", CLI_N, "--lanes", CLI_LANES, "--cache-dir", tr_dir], timeout=300)
            check(rc == 0 and out is not None, f"python -m repro_torch simulate --use-kernel exits 0 "
                  f"in {secs:.1f} s {err if rc else ''}")
            log(f"  CLI simulate: throughput_ips={out['result']['throughput_ips']:.1f} "
                f"first_call_seconds={out['result']['first_call_seconds']:.3f} cache {out['result']['cache']}")
            check([w["total_cycles"] for w in out["result"]["workloads"]] == [w.total_cycles for w in want],
                  f"CLI simulate totals equal in-process {[w.total_cycles for w in want]}")
            jobs = [{"id": f"{m}-{b}", "bench": b, "n": CLI_N, "lanes": CLI_LANES,
                     **({"model": "c3"} if m == "c3" else {})} for m in ("c3", "tf") for b in CLI_BENCHES]
            jobs_file = Path(tmp) / "jobs.json"
            jobs_file.write_text(json.dumps({"models": {"c3": str(art_dir)}, "jobs": jobs}))
            fleet = start_cli(["fleet", "--replicas", FLEET_REPLICAS, "--jobs", jobs_file,
                               "--cache-dir", tr_dir])
            sync = SimServe(device=dev)
            sync.register("c3", art_dir)
            names = dict(zip(CLI_BENCHES, cli_traces))
            hs = [sync.submit(names[j["bench"]], j.get("model"), n_lanes=CLI_LANES, name=j["id"])
                  for j in jobs]
            sync.drain()
            want = [(j["id"], h.result().total_cycles) for j, h in zip(jobs, hs)]
            rc, out, secs, err = run_cli(["serve", "--jobs", jobs_file, "--cache-dir", tr_dir], timeout=300)
            check(rc == 0 and out is not None, f"python -m repro_torch serve --jobs exits 0 in "
                  f"{secs:.1f} s {err if rc else ''}")
            check([(j["id"], j["result"]["total_cycles"]) for j in out["jobs"]] == want,
                  f"CLI serve --jobs totals equal in-process {want}")
            log(f"  CLI serve --jobs: {out['stats']['batches']} batches, cache "
                f"{ {k: out['stats']['cache'][k] for k in ('hits', 'misses', 'compile_seconds')} }")

            # -- the 2-replica fleet on the one card, and the chaos drill
            rc, out, secs, err = finish_cli(fleet, timeout=600)
            check(rc == 0 and out is not None, f"python -m repro_torch fleet --replicas {FLEET_REPLICAS} "
                  f"exits 0 in {secs:.1f} s {err if rc else ''}")
            log(f"  fleet: healthz {out['healthz']['status']}, {out['healthz']['healthy_replicas']} healthy "
                f"replicas, jobs on {[j['replica'] for j in out['jobs']]}, router "
                f"{ {k: out['stats']['router'][k] for k in ('jobs_routed', 'failovers', 'ejections')} }")
            check([(j["id"], j["result"]["total_cycles"]) for j in out["jobs"]] == want,
                  "fleet totals equal the synchronous run's")
            rc, out, secs, err = finish_cli(chaos, timeout=600)
            single = (out or {}).get("single", {})
            log(f"  chaos --quick: exit {rc} in {secs:.1f} s; checks {single.get('checks')}; counters "
                f"{single.get('counters')}")
            check(rc == 0 and out["ok"] and all(single["checks"].values()),
                  f"python -m repro_torch chaos --quick passes every check {err if rc else ''}")
        finally:
            stop_cli(chaos)
            stop_cli(fleet)

    # -- a one-shot simulate (cold cache) at three chunk caps
    firsts = {}
    for c in CHUNK_CAPS:
        one = SimNet(art, use_kernel=True, cache=CompileCache(), device=dev)
        r = one.simulate(arrays[0], n_lanes=ONESHOT_LANES, chunk=c)
        warm = one.simulate(arrays[0], n_lanes=ONESHOT_LANES, chunk=c)
        firsts[c] = r.total_cycles
        log(f"  one-shot simulate, {ONESHOT_LANES} lanes x {len(arrays[0]['feat']) // ONESHOT_LANES} "
            f"steps, chunk {c}: first_call_seconds {r.first_call_seconds:.3f} (build "
            f"{r.cache['compile_seconds']:.3f} s), throughput_ips {r.throughput_ips:.1f}; warm call "
            f"{warm.first_call_seconds:.3f} s, throughput_ips {warm.throughput_ips:.1f}")
    check(len(set(firsts.values())) == 1, f"the same totals at every chunk {firsts}")

def cuda_flags(torch):
    """Full f32 GEMMs and reductions, in every process of the script."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def mesh_follower(rank, world, init, queue):
    """Phase [14](b)'s second rank, started with the spawn method: joins the
    gloo group, follows the controller on cuda:0 (K1 on its half of the
    lanes), then reports the requests it served and its K1 launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.simnet_engine import run_follower

    cuda_flags(torch)
    served = run_follower(rank, world, init, device_type="cuda", device="cuda:0",
                          timeout_s=MESH_TIMEOUT_S)
    queue.put({"served": served, "launches": dict(ops.launches)})


def mesh_phase(torch, dev, pcfg, params, arrays, ring, k1_launches):
    """The lane mesh on the card: (a) the [5] pack through `SimNet(art,
    mesh=make_host_mesh(), use_kernel=True)` on a one-rank mesh, against
    [5]'s totals and K1 launches and beside the unsharded engine in turns;
    (b) two ranks on the one card (this process the controller, one
    follower process), each running K1 on its half of the lanes, held to
    one rank on the same lanes; (c)
    ``examples/quickstart_torch.py`` as a child process."""
    import multiprocessing
    import os
    import statistics
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from repro_torch.checkpoint import PredictorArtifact
    from repro_torch.core import api
    from repro_torch.core.session import SimNet
    from repro_torch.core.simulator import SimConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.compile_cache import global_cache, mesh_fingerprint
    from repro_torch.serving.simnet_engine import SimNetEngine

    t_phase = time.perf_counter()
    log(f"[14] the lane mesh: {len(arrays)} workloads x {PRED_LANES} lanes x {PRED_STEPS} steps, "
        "c3 at full width, ring, f32, use_kernel=True")
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=ROOT / "build")
    # (b)'s follower starts now: it reaches the card while (a) runs, then
    # waits at the rendezvous of the two-rank group
    init = f"file://{work.name}/store"
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    follower = mp.Process(target=mesh_follower, args=(1, 2, init, queue), daemon=True)
    follower.start()
    quickstart = None
    try:
        art_dir = Path(work.name) / "c3"
        PredictorArtifact(params, pcfg, SimConfig(ctx_len=pcfg.ctx_len), {"seed": SEED}).save(art_dir)
        art = PredictorArtifact.load(art_dir, device=dev)

        # -- (a) a one-rank mesh: make_host_mesh starts its own group
        mesh = make_host_mesh()
        check(dist.get_world_size() == 1 and tuple(mesh.mesh.shape) == (1, 1),
              f"make_host_mesh() on cuda: a one-rank (data, model) mesh ({dist.get_backend()})")
        cache = global_cache(dev)
        before = cache.stats()["n_executables"]
        ops.reset_launches()
        with SimNet(art, mesh=mesh, use_kernel=True, chunk=PRED_STEPS, device=dev) as sn:
            res = sn.simulate_many(arrays, n_lanes=PRED_LANES, timeit=True)
            key = sn.engine.executable_key(PRED_LANES * len(arrays), PRED_STEPS)
        counts = dict(ops.launches)
        got = np.asarray([w.total_cycles for w in res])
        log(f"  SimNet(mesh=make_host_mesh()): throughput_ips={res.throughput_ips:.1f} "
            f"seconds={res.seconds:.4f} first_call_seconds={res.first_call_seconds:.3f} "
            f"cache={res.cache} launches={counts}")
        log(f"  [5] unsharded: throughput_ips={ring['throughput_ips']:.1f} "
            f"first_call_seconds={ring['first_call_seconds']:.3f}")
        check(np.array_equal(got, ring["workload_cycles"]),
              "one-rank mesh totals equal [5]'s unsharded totals bit for bit")
        check(counts["fused_step"] == k1_launches and counts["cnn_trunk"] == 0,
              f"K1 launched {counts['fused_step']} times on the mesh path, as in [5] ({k1_launches})")
        check(key.mesh == mesh_fingerprint(mesh) and key.mesh is not None,
              f"the program key's mesh is the mesh's fingerprint {key.mesh}")
        check(res.cache["misses"] == 1 and cache.stats()["n_executables"] == before + 1,
              "the mesh is a cache miss beside [5]'s unsharded program of the same shape")
        # the added cost of the mesh path: the same pack, unsharded and
        # one-rank mesh engines in turns (warm programs)
        engines = {"unsharded": SimNetEngine(art.params, pcfg, art.sim_cfg, use_kernel=True, device=dev),
                   "mesh": SimNetEngine(art.params, pcfg, art.sim_cfg, mesh=mesh, use_kernel=True,
                                        device=dev)}
        ips = {name: [] for name in engines}
        for name in ("unsharded", "mesh", "mesh", "unsharded") * MESH_TURNS:
            r = engines[name].simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS, timeit=True)
            check(np.array_equal(r["workload_cycles"], ring["workload_cycles"]), f"{name} totals equal [5]'s")
            ips[name].append(r["throughput_ips"])
        med = {name: statistics.median(v) for name, v in ips.items()}
        log(f"  in turns ({2 * MESH_TURNS} runs each): throughput_ips median unsharded "
            f"{med['unsharded']:.1f}, one-rank mesh {med['mesh']:.1f} "
            f"({100 * (med['mesh'] / med['unsharded'] - 1):+.2f}%); runs {ips}")
        dist.destroy_process_group()

        # -- (c) starts beside (b): quickstart_torch.py on the card
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        quickstart = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"), "--device", "cuda"],
            cwd=work.name, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t_quick = time.perf_counter()

        # -- (b) two ranks on the one card, K1 on each
        t0 = time.perf_counter()
        dist.init_process_group("gloo", init_method=init, rank=0, world_size=2,
                                timeout=timedelta(seconds=MESH_TIMEOUT_S))
        mesh2 = make_host_mesh()
        log(f"  two-rank group and mesh {tuple(mesh2.mesh.shape)} up in "
            f"{time.perf_counter() - t0:.1f} s (the follower started with the phase)")
        weight_bytes = sum(t.numel() * t.element_size() for t in tensors(art.params))
        eng = SimNetEngine(art.params, pcfg, art.sim_cfg, mesh=mesh2, use_kernel=True, device=dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        two = eng.simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS, timeit=True)
        wall = time.perf_counter() - t0
        mine = dict(ops.launches)
        tf = {"two ranks": SimNetEngine(sim_cfg=art.sim_cfg, mesh=mesh2, device=dev),
              "one rank": SimNetEngine(sim_cfg=art.sim_cfg, device=dev)}
        tf = {k: e.simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS) for k, e in tf.items()}
        eng.close()
        theirs = queue.get(timeout=MESH_TIMEOUT_S)
        follower.join(60)
        dist.destroy_process_group()
        log(f"  two ranks on {dev}: wall {wall:.3f} s, throughput_ips={two['throughput_ips']:.1f} "
            f"first_call_seconds={two['first_call_seconds']:.3f} (no speed claimed: two contexts "
            f"share one card); weights sent a request {weight_bytes} bytes")
        log(f"  K1 launches: rank 0 {mine['fused_step']}, rank 1 {theirs['launches']['fused_step']} "
            f"({theirs['served']} requests served)")
        check(mine["fused_step"] == theirs["launches"]["fused_step"] == k1_launches
              and follower.exitcode == 0 and theirs["served"] == 2,
              "each rank launched K1 once a step of each pass on its half of the lanes")
        check(np.array_equal(tf["two ranks"]["workload_cycles"], tf["one rank"]["workload_cycles"])
              and np.array_equal(tf["two ranks"]["workload_overflow"], tf["one rank"]["workload_overflow"]),
              "teacher-forced: two ranks' totals equal one rank's bit for bit")
        # cuBLAS picks its f32 GEMM algorithm (split-K) by the row count, so
        # the FC head of 512 lanes need not give the bits of 1024 lanes'
        # rows: each rank's totals are held to one rank on the same lanes
        halves = [SimNetEngine(art.params, pcfg, art.sim_cfg, use_kernel=True, device=dev).simulate_many(
            part, n_lanes=PRED_LANES, chunk=PRED_STEPS) for part in (arrays[:4], arrays[4:])]
        check(len(arrays) == 8 and np.array_equal(
            two["workload_cycles"], np.concatenate([h["workload_cycles"] for h in halves])),
            f"two ranks' totals equal one rank's on each rank's {4 * PRED_LANES} lanes (workloads 0-3, 4-7) "
            "bit for bit")
        rel = np.abs(two["workload_cycles"] - got) / got
        log(f"  two ranks vs the one-rank mesh's 1024 lanes: {two['workload_cycles'].tolist()} vs "
            f"{got.tolist()}, max rel diff {rel.max():.3e}")
        check(rel.max() < PRED_RTOL, f"two ranks within {PRED_RTOL} of the one-rank mesh")

        # -- (c) its output, and its DES CPIs against the DES on this host
        out, err = quickstart.communicate(timeout=MESH_TIMEOUT_S)
        log(f"  examples/quickstart_torch.py --device cuda: exit {quickstart.returncode} in "
            f"{time.perf_counter() - t_quick:.1f} s")
        for line in out.splitlines():
            log(f"    | {line}")
        check(quickstart.returncode == 0, f"quickstart_torch.py ran on the card ({err[-2000:]})")
        want = [f"{t.name}: {t.n} instructions, CPI {t.cpi:.3f}"
                for t in api.generate_traces(["mlb_mixed", "mlb_branchy"], 20000)]
        held = api.generate_traces(["sim_loop"], 10000)[0]
        sim_cpi = re.search(r"DES CPI ([\d.]+) vs SimNet CPI ([\d.]+)", out)
        check(all(w in out for w in want) and sim_cpi is not None
              and sim_cpi.group(1) == f"{held.cpi:.3f}" and np.isfinite(float(sim_cpi.group(2))),
              "quickstart's DES CPIs equal the DES run on the host")
    finally:
        if quickstart is not None and quickstart.poll() is None:
            quickstart.kill()
            quickstart.communicate()
        if follower.is_alive():
            follower.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        work.cleanup()
    log(f"[14] lane mesh phase: {time.perf_counter() - t_phase:.1f} s")


def shard_reduced_losses(torch, dev, mesh):
    """[15](b)'s reduced f32 run: tinyllama-1.1b at reduced width, masters
    from a CPU generator, SHARD_REDUCED_STEPS Adam steps at accum_steps 2;
    on ``mesh`` (DTensors placed by the train rules) or, with None,
    unsharded. Returns the losses."""
    import numpy as np

    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import sharding as sh
    from repro_torch.training.optimizer import AdamConfig, adam_init, adam_state_specs
    from repro_torch.training.train_loop import make_train_step

    cfg = get_reduced_config(LM_TRAIN_ARCH, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), device=dev, masters=True)
    opt = adam_init(params)
    kw = {}
    if mesh is not None:
        rules, specs = sh.rules_for(cfg, "train"), model.param_specs()
        params = sh.shard_tree(params, specs, rules, mesh)
        opt = sh.shard_tree(opt, adam_state_specs(specs), rules, mesh)
        kw = dict(constrain=sh.make_constrain(mesh, rules), layer_specs=model.layer_specs(),
                  grad_shardings=sh.spec_tree_to_shardings(specs, rules, mesh))
    step = make_train_step(model, AdamConfig(lr=TRAIN_EXACT_LR), accum_steps=2, **kw)
    rng = np.random.default_rng(SEED)
    losses = []
    for _ in range(SHARD_REDUCED_STEPS):
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)).to(dev)}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses


def shard_rank(torch, rank, init, ckpt_dir):
    """One rank of [15](b), run by this process (rank 0) and the follower:
    joins the two-rank group (`launch.mesh.init_ranks`), trains the
    reduced f32 model on a (1, 2) mesh, then tinyllama-1.1b at full width
    through ``train(model_axis=2)`` with its collectives counted, saves
    the final params (rank 0 writes) and gathers them. Returns its
    numbers, and the gathered params on rank 0."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import train
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import full_tree

    backend = mesh_mod.init_ranks(rank, 2, init, "cuda", timeout_s=SHARD_TIMEOUT_S)
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        reduced_losses = shard_reduced_losses(
            torch, dev, mesh_mod.make_mesh((1, 2), ("data", "model"), "cuda"))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh_mod.EXCHANGED.clear()
        t0 = time.perf_counter()
        with mesh_mod.CollectiveCounter() as counter:
            res = train(LM_TRAIN_ARCH, reduced=False, steps=SHARD_STEPS, batch=LM_TRAIN_BATCH,
                        seq=LM_TRAIN_SEQ, lr=LM_TRAIN_LR, model_axis=2, device=dev, log_every=1)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        exchanged = dict(mesh_mod.EXCHANGED)
        t0 = time.perf_counter()
        CheckpointManager(ckpt_dir).save(SHARD_STEPS, {"params": res["params"]})
        save_s = time.perf_counter() - t0
        # the serving storage (bf16 matrices) of the shards, gathered
        t0 = time.perf_counter()
        full = full_tree(build_model(get_config(LM_TRAIN_ARCH)).to_storage(res["params"]))
        gather_s = time.perf_counter() - t0
        out = {"rank": rank, "backend": backend, "mesh": res["mesh"], "losses": res["losses"],
               "norms": [m["grad_norm"] for m in res["metrics"]],
               "step_s": list(res["monitor"].history),
               "wall": wall, "peak": peak, "calls": dict(counter.calls), "bytes": dict(counter.bytes),
               "exchanged": exchanged, "reduced": reduced_losses, "save_s": save_s, "gather_s": gather_s}
        if rank == 0:
            out["full"] = full
        dist.barrier()
    finally:
        mesh_mod.close_peer_buffers()
        dist.destroy_process_group()
    return out


def shard_follower(rank, init, ckpt_dir, queue):
    """Phase [15](b)'s second rank, started with the spawn method."""
    import torch

    cuda_flags(torch)
    try:
        queue.put(shard_rank(torch, rank, init, ckpt_dir))
    except BaseException as e:  # the controller reports it and fails
        queue.put({"rank": rank, "error": repr(e)})
        raise


def sharded_train_phase(torch, dev, smi, first_loss_13c):
    """Phase [15]: sharded LM training on the card. (a) train(model_axis=1)
    on a one-rank mesh beside the unsharded step, in turns; (b) two ranks
    on the one card; (c) (b)'s params restored on one rank and decoded
    with K4. See the SHARD_* constants."""
    import multiprocessing
    import statistics

    import numpy as np
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenLoader
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import extras_for, train
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import sharding as sh
    from repro_torch.serving.engine import DecodeEngine, lm_decoder
    from repro_torch.training.optimizer import AdamConfig, adam_init, adam_state_specs
    from repro_torch.training.train_loop import make_train_step

    t_phase = time.perf_counter()
    cfg = get_config(LM_TRAIN_ARCH)
    model = build_model(cfg)
    B, S, L = LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.n_layers
    log(f"[15] sharded LM training: {LM_TRAIN_ARCH} at full width ({L} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, vocab {cfg.vocab}), {cfg.dtype} on f32 masters, "
        f"remat, accum_steps {cfg.accum_steps}, {B} x {S} tokens a step, lr {LM_TRAIN_LR}, seed {SEED}, "
        f"{SHARD_STEPS} steps ({smi})")
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=ROOT / "build")
    init = f"file://{work.name}/store"
    ckpt = Path(work.name) / "ckpt"
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    # (b)'s follower starts now: it reaches the card while (a) runs, then
    # waits at the rendezvous of the two-rank group
    follower = mp.Process(target=shard_follower, args=(1, init, str(ckpt), queue), daemon=True)
    follower.start()
    try:
        # -- (a) train(model_axis=1) (one rank: plain tensors, the unsharded
        # step) beside the same step on DTensors of a one-rank mesh, in turns
        acfg = AdamConfig(lr=LM_TRAIN_LR, warmup_steps=max(SHARD_STEPS // 10, 1),
                          decay_steps=SHARD_STEPS)
        mesh1 = mesh_mod.make_host_mesh()
        rules, specs = sh.rules_for(cfg, "train"), model.param_specs()

        def mesh_step():
            """make_train_step on mesh1's DTensors, fed as train() feeds its step."""
            params = model.init(torch.Generator(dev).manual_seed(0), device=dev, masters=True)
            params = sh.shard_tree(params, specs, rules, mesh1)
            opt = adam_init(params)
            opt["step"] = sh.place_owned(opt["step"], *sh.spec_tree_to_shardings(
                adam_state_specs(specs), rules, mesh1)["step"])
            step = make_train_step(model, acfg, constrain=sh.make_constrain(mesh1, rules),
                                   accum_steps=cfg.accum_steps,
                                   grad_shardings=sh.spec_tree_to_shardings(specs, rules, mesh1),
                                   layer_specs=model.layer_specs())
            loader = TokenLoader(cfg.vocab, B, S, extras=extras_for(cfg))
            hist, times = [], []
            try:
                for _ in range(SHARD_STEPS):
                    b = next(loader)
                    t0 = time.perf_counter()
                    params, opt, m = step(params, opt, {k: torch.from_numpy(v).to(dev)
                                                        for k, v in b.items()})
                    hist.append({k: float(v) for k, v in m.items()})
                    times.append(time.perf_counter() - t0)
            finally:
                loader.close()
            return hist, times

        runs = {}
        for turn in ("train(model_axis=1)", "one-rank mesh"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            if turn == "one-rank mesh":
                hist, times = mesh_step()
            else:
                res = train(LM_TRAIN_ARCH, reduced=False, steps=SHARD_STEPS, batch=B, seq=S,
                            lr=LM_TRAIN_LR, model_axis=1, device=dev, log_every=0)
                check(res["mesh"] == (1, 1) and not any(
                    isinstance(t, DTensor) for t in tensors(res["params"])),
                      "(a) train(model_axis=1) runs at mesh (1, 1) on plain tensors")
                hist, times = res["metrics"], list(res["monitor"].history)
                del res
            runs[turn] = (np.array([h["loss"] for h in hist]), np.array([h["grad_norm"] for h in hist]),
                          1e3 * statistics.median(times[2:]),
                          torch.cuda.max_memory_allocated(dev) / 1e9)
            log(f"  (a) {turn}: losses {runs[turn][0].tolist()}, grad norms {runs[turn][1].round(4).tolist()}; "
                f"step ms {np.round(1e3 * np.array(times), 1).tolist()}: "
                f"{runs[turn][2]:.1f} ms a step (median after the first 2), "
                f"{B * S / runs[turn][2] * 1e3:.0f} tokens/s, peak {runs[turn][3]:.2f} GB ({smi})")
        (lu, nu, msu, _), (lm, nm, msm, peak_a) = runs["train(model_axis=1)"], runs["one-rank mesh"]
        check(np.array_equal(lu, lm) and np.array_equal(nu, nm) and lm[0] == first_loss_13c,
              f"(a) train(model_axis=1) = the step on a one-rank mesh's DTensors bit for bit over "
              f"{SHARD_STEPS} steps (losses and grad norms), its first loss = [13](c)'s {first_loss_13c}")
        # what DTensor's dispatch adds on the host: one profiled step each
        params = model.init(torch.Generator(dev).manual_seed(0), device=dev, masters=True)
        opt = adam_init(params)
        loader = TokenLoader(cfg.vocab, B, S, extras=extras_for(cfg))
        try:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(loader).items()}
        finally:
            loader.close()
        steps = {
            "unsharded": (make_train_step(model, acfg, accum_steps=cfg.accum_steps), params, opt),
            "one-rank mesh": (make_train_step(
                model, acfg, constrain=sh.make_constrain(mesh1, rules), accum_steps=cfg.accum_steps,
                grad_shardings=sh.spec_tree_to_shardings(specs, rules, mesh1),
                layer_specs=model.layer_specs()),
                sh.shard_tree(params, specs, rules, mesh1),
                sh.shard_tree(opt, adam_state_specs(specs), rules, mesh1))}
        for name, (fn, p, o) in steps.items():
            prof = profiled(torch, lambda: fn(p, o, batch), 1)
            if prof is None:
                log(f"  (a) {name}: the profiler reported no device time (host gaps not measured)")
            else:
                log(f"  (a) {name}, one profiled step: wall {prof['wall']:.1f} ms, device busy "
                    f"{prof['busy']:.1f} ms ({100 * prof['busy'] / prof['wall']:.1f}%), host gaps "
                    f"{prof['span'] - prof['busy']:.1f} ms, {prof['ops']:.0f} device operations")
        del steps, params, opt, batch, fn, p, o
        loader = TokenLoader(cfg.vocab, B, S)
        try:
            t0 = time.perf_counter()
            loader._make_batch(0)
            log(f"  (a) one batch of the token loader (its thread beside each step of train()): "
                f"{1e3 * (time.perf_counter() - t0):.1f} ms of host time")
        finally:
            loader.close()
        torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()

        # -- (b) two ranks on the one card: this process rank 0
        reduced_one = shard_reduced_losses(torch, dev, None)
        mine = shard_rank(torch, 0, init, str(ckpt))
        theirs = None
        deadline = time.perf_counter() + SHARD_TIMEOUT_S
        while theirs is None and time.perf_counter() < deadline:
            try:
                theirs = queue.get(timeout=5)
            except Exception:  # queue.Empty: the follower may have died
                if not follower.is_alive():
                    break
        check(theirs is not None, f"the follower reported (exit code {follower.exitcode})")
        follower.join(120)
        check("error" not in theirs and follower.exitcode == 0,
              f"the follower ran its rank to the end ({theirs.get('error', 'exit 0')})")
        full = mine.pop("full")
        lb, nb = np.array(mine["losses"]), np.array(mine["norms"])
        ms_b = 1e3 * statistics.median(mine["step_s"][2:])
        log(f"  (b) two ranks on {dev}, mesh {mine['mesh']}, backend {mine['backend']}: losses "
            f"{lb.tolist()}, grad norms {nb.round(4).tolist()}; step ms "
            f"{np.round(1e3 * np.array(mine['step_s']), 1).tolist()}: {ms_b:.1f} ms a step (median after the "
            f"first 2; rank 1 {1e3 * statistics.median(theirs['step_s'][2:]):.1f}), "
            f"{B * S / ms_b * 1e3:.0f} tokens/s; wall {mine['wall']:.1f} s; peak memory a rank "
            f"{mine['peak'] / 1e9:.2f} / {theirs['peak'] / 1e9:.2f} GB (one rank: {peak_a:.2f}); no speed "
            f"claimed: both ranks share one card's SMs ({smi})")
        for r in (mine, theirs):
            per_step = {k: (r["calls"][k] / SHARD_STEPS, r["bytes"][k] / SHARD_STEPS) for k in r["calls"]}
            log(f"  (b) rank {r['rank']} collectives a step (calls, bytes handed in): "
                + ", ".join(f"{k} {c:.0f} x, {b / 1e9:.3f} GB" for k, (c, b) in sorted(per_step.items()))
                + f"; total {sum(r['bytes'].values()) / SHARD_STEPS / 1e9:.3f} GB a step; through the "
                f"ranks' device buffers {({k: f'{v / SHARD_STEPS / 1e9:.3f} GB a step' for k, v in r['exchanged'].items()})}")
        log(f"  (b) checkpoint of the f32 params (gathered, rank 0 writes): {mine['save_s']:.1f} s; "
            f"their bf16 storage gathered in memory: {mine['gather_s']:.1f} s")
        check(mine["losses"] == theirs["losses"] and mine["mesh"] == (1, 2),
              "(b) both ranks return the same losses on the (1, 2) mesh")
        rel0 = abs(lb[0] - lm[0]) / abs(lm[0])
        reln = float(np.max(np.abs(nb - nm) / np.abs(nm)))
        check(rel0 <= SHARD_LOSS_RTOL and reln <= SHARD_NORM_RTOL and np.isfinite(lb).all()
              and lb[-1] < lb[0],
              f"(b) first loss within {SHARD_LOSS_RTOL} of (a)'s ({rel0:.2e}), every grad norm within "
              f"{SHARD_NORM_RTOL} ({reln:.2e}), losses finite and falling")
        relr = float(np.max(np.abs(np.array(mine["reduced"]) - reduced_one) / np.abs(reduced_one)))
        check(mine["reduced"] == theirs["reduced"] and relr <= SHARD_REDUCED_RTOL,
              f"(b) reduced f32 on two ranks = one rank over {SHARD_REDUCED_STEPS} steps: "
              f"{np.round(mine['reduced'], 6).tolist()} vs {np.round(reduced_one, 6).tolist()} "
              f"(max rel diff {relr:.2e} <= {SHARD_REDUCED_RTOL})")

        # -- (c) the checkpoint restored on one rank, decoded with K4, and
        # the params gathered in memory decoded the same way
        state, step = CheckpointManager(ckpt).restore()
        prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (B, LM_TRAIN_DECODE_PROMPT)).astype(np.int32)).to(dev)
        tokens, counts = {}, {}
        for name, params in (("restored", model.params_from_numpy(state["params"], dev)),
                             ("gathered", full)):
            with torch.no_grad():
                logits, st = model.prefill(params, {"tokens": prompts})
            first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            ops.reset_launches()
            tokens[name], _, tps = DecodeEngine(lm_decoder(model, use_kernel=True), params).generate(
                model.rehome_state(st, LM_TRAIN_DECODE_PROMPT + SHARD_DECODE_STEPS), first,
                SHARD_DECODE_STEPS)
            counts[name] = dict(ops.launches)
            log(f"  (c) {name} params: {SHARD_DECODE_STEPS} greedy steps at {tps:.1f} tokens/s, "
                f"K4 launches {counts[name]}")
            del params, logits, st
        want = L * SHARD_DECODE_STEPS * 2
        check(step == SHARD_STEPS and counts["restored"].get("decode_attn") == want
              and sum(counts["restored"].values()) == want
              and torch.equal(tokens["restored"], tokens["gathered"]),
              f"(c) (b)'s checkpoint (step {step}) restored unsharded decodes through DecodeEngine with "
              f"K4 in every layer ({L} x {SHARD_DECODE_STEPS} a pass, warm-up and timed: {want}) to the "
              f"tokens of (b)'s params gathered in memory; first request {tokens['restored'][:, 0].tolist()}")
    finally:
        if follower is not None and follower.is_alive():
            follower.kill()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        work.cleanup()
    log(f"[15] sharded LM training phase: {time.perf_counter() - t_phase:.1f} s")
    return counts["restored"]["decode_attn"]


def recording(torch, decoder, logits):
    """``decoder`` whose every step also keeps its logits (gathered from a
    mesh, in f32)."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    def step(params, state, token, constrain=None):
        lg, state = decoder.step(params, state, token, constrain=constrain)
        logits.append((lg.full_tensor() if isinstance(lg, DTensor) else lg).float())
        return lg, state

    return dataclasses.replace(decoder, step=step)


def host_profile(torch, fn):
    """One call of ``fn`` under the profiler: wall ms, device busy ms, and
    the host ops with the most self CPU time (name, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return dict(wall=wall, busy=sum(r[0] for r in rows) if rows else None,
                host=[(e.key, e.self_cpu_time_total / 1e3, e.count) for e in host],
                host_ms=sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3)


def sharded_decode_rank(torch, rank, init):
    """One rank of phase [16], run by this process (rank 0) and the
    follower: joins the two-rank group, then (a) gemma3-4b at full width:
    sharded prefill, its first step's logits, one step's collectives, then
    DecodeEngine(mesh=) with K4; (b) the reduced f32 model through the
    engine, each step's logits kept; (c) decode_long from a seeded cache.
    Rank 0 also runs (b) and (c) unsharded on the card (plain tensors).
    Returns its numbers as plain data, and rank 0's tensors for the
    gates."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.specs import decode_state_axes
    from repro_torch.models.lm import place_state
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import sharding as sh
    from repro_torch.serving.engine import EAGER_WARMUP_STEPS, DecodeEngine, copy_state, lm_decoder

    backend = mesh_mod.init_ranks(rank, 2, init, "cuda", timeout_s=SHARD_DECODE_TIMEOUT_S)
    dev = torch.device("cuda", torch.cuda.current_device())
    out, keep = {"rank": rank, "backend": backend}, {}
    try:
        mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), "cuda")
        cfg = get_config(LM_ARCH)
        model = build_model(cfg)
        full_params = model.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
        rules = sh.rules_for(cfg, "decode")
        constrain = sh.make_constrain(mesh, rules)
        params = sh.shard_tree(full_params, model.param_specs(), rules, mesh)
        if rank != 0:  # rank 0 keeps the whole model for (c)'s unsharded run
            del full_params
        tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = model.prefill(params, {"tokens": tokens}, constrain=constrain)
            torch.cuda.synchronize()
            out["prefill_s"] = time.perf_counter() - t0
            out["prefill_peak"] = torch.cuda.max_memory_allocated(dev)
            full = model.rehome_state(state, LM_CACHE)
            del state
            first = sh.argmax_last(logits[:, -1])
            del logits
            lg, _ = model.decode_step(params, copy_state(full), first, constrain=constrain,
                                      use_kernel=True)
            keep["logits0"] = lg.full_tensor().float().cpu()
            with mesh_mod.CollectiveCounter() as counter:
                model.decode_step(params, copy_state(full), first, constrain=constrain,
                                  use_kernel=True)
            out["calls"], out["bytes"] = dict(counter.calls), dict(counter.bytes)
            # one step profiled on rank 0 (rank 1 runs it plain, as its peer)
            st = copy_state(full)

            def step():
                model.decode_step(params, st, first, constrain=constrain, use_kernel=True)

            if rank == 0:
                out["profile"] = host_profile(torch, step)
            else:
                step()
            del st
        engine = DecodeEngine(lm_decoder(model, use_kernel=True), params, mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        stream, final, tps = engine.generate(full, first, SHARD_LM_STEPS)
        out["a"] = dict(mode=engine.mode, why=engine.mode_reason, tps=tps,
                        k4=ops.launches["decode_attn"], launches=dict(ops.launches),
                        steps=SHARD_LM_STEPS + min(SHARD_LM_STEPS, EAGER_WARMUP_STEPS),
                        peak=torch.cuda.max_memory_allocated(dev), pos=int(sh.local(final["pos"])),
                        first=first.cpu().tolist(), stream=stream.cpu().tolist(),
                        placed=str(tuple(full["k"].placements)),
                        local_k=tuple(full["k"].to_local().shape))
        del full, final, engine, stream

        # (b) reduced f32, two ranks against one
        rcfg = reduced(cfg, n_layers=EXACT_LAYERS, dtype="float32")
        rmodel = build_model(rcfg)
        rplain = rmodel.init(torch.Generator().manual_seed(SEED), device=dev)
        rrules = sh.rules_for(rcfg, "decode")
        rparams = sh.shard_tree(rplain, rmodel.param_specs(), rrules, mesh)
        batch = {"tokens": torch.from_numpy(np.random.default_rng(SEED + 1).integers(
            0, rcfg.vocab, (EXACT_BATCH, EXACT_PROMPT)).astype(np.int32)).to(dev)}
        lgs = []
        with torch.no_grad():
            logits, st = rmodel.prefill(rparams, batch, constrain=sh.make_constrain(mesh, rrules))
            rfull = rmodel.rehome_state(st, EXACT_PROMPT + EXACT_STEPS)
            rfirst = sh.argmax_last(logits[:, -1])
        rengine = DecodeEngine(recording(torch, lm_decoder(rmodel, use_kernel=True), lgs), rparams,
                               mesh=mesh)
        rtoks, _, _ = rengine.generate(rfull, rfirst, EXACT_STEPS)
        out["b"] = dict(first=rfirst.cpu().tolist(), tokens=rtoks.cpu().tolist())
        if rank == 0:
            keep["b_logits"] = torch.stack(lgs[-EXACT_STEPS:]).cpu()
            with torch.no_grad():
                logits, st = rmodel.prefill(rplain, batch)
                one_first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                toks, one_lgs = eager_stream(torch, rmodel, rplain,
                                             rmodel.rehome_state(st, EXACT_PROMPT + EXACT_STEPS),
                                             one_first, EXACT_STEPS, use_kernel=True)
            keep["b_one"] = (one_first.cpu().tolist(), toks.cpu().tolist(), one_lgs.float().cpu())
        del rplain, rparams, rfull, rengine, lgs

        # (c) decode_long: batch 1, a seeded cache, no prefill
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        shape = (cfg.n_layers, 1, SHARD_LONG_SEQ, cfg.n_kv_heads, cfg.head_dim)
        cache = {"k": torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16),
                 "v": torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16),
                 "pos": torch.tensor(SHARD_LONG_POS, dtype=torch.int32, device=dev)}
        tok = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
            0, cfg.vocab, (1,)).astype(np.int32)).to(dev)
        lrules = sh.rules_for(cfg, "decode_long")
        lconstrain = sh.make_constrain(mesh, lrules)
        placed = place_state(cache, decode_state_axes(cfg), lconstrain)
        with torch.no_grad():
            lg, _ = model.decode_step(params, copy_state(placed), tok, constrain=lconstrain,
                                      use_kernel=True)
        keep["c_logits0"] = lg.full_tensor().float().cpu()
        lengine = DecodeEngine(lm_decoder(model, use_kernel=True), params, mesh=mesh,
                               rules_mode="decode_long")
        ops.reset_launches()
        ltoks, _, ltps = lengine.generate(placed, tok, SHARD_LONG_STEPS)
        out["c"] = dict(tps=ltps, k4=ops.launches["decode_attn"], tokens=ltoks.cpu().tolist(),
                        steps=SHARD_LONG_STEPS + min(SHARD_LONG_STEPS, EAGER_WARMUP_STEPS),
                        placed=str(tuple(placed["k"].placements)),
                        offset=sh.shard_offsets(placed["k"], 2)[0])
        del placed, lengine
        if rank == 0:
            with torch.no_grad():
                lg, _ = model.decode_step(full_params, copy_state(cache), tok, use_kernel=True)
                keep["c_one_logits0"] = lg.float().cpu()
            one, _, one_tps = DecodeEngine(lm_decoder(model, use_kernel=True), full_params).generate(
                cache, tok, SHARD_LONG_STEPS)
            keep["c_one"] = (one.cpu().tolist(), one_tps)
        dist.barrier()
    finally:
        mesh_mod.close_peer_buffers()
        dist.destroy_process_group()
    return out, keep


def sharded_decode_follower(rank, init, queue):
    """Phase [16]'s second rank, started with the spawn method."""
    import torch

    cuda_flags(torch)
    try:
        queue.put(sharded_decode_rank(torch, rank, init)[0])
    except BaseException as e:  # the controller reports it and fails
        queue.put({"rank": rank, "error": repr(e)})
        raise


def start_follower(target):
    """The second rank of a two-rank phase (``target(rank, init, queue)``:
    [16]'s, [18]'s), started with the spawn method ahead of its phase so
    that it has reached the card by then; it waits at the group's
    rendezvous (its file store) meanwhile. Returns what `join_follower`
    takes."""
    import multiprocessing

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=ROOT / "build")
    init = f"file://{work.name}/store"
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    follower = mp.Process(target=target, args=(1, init, queue), daemon=True)
    follower.start()
    return follower, queue, init, work


def join_follower(started, mine, timeout_s):
    """Runs ``mine(init)`` (rank 0's part) and waits for the follower's
    report; fails if it reported an error or did not exit 0. Returns
    (what ``mine`` returned, the follower's report)."""
    follower, queue, init, work = started
    try:
        ours = mine(init)
        theirs = None
        deadline = time.perf_counter() + timeout_s
        while theirs is None and time.perf_counter() < deadline:
            try:
                theirs = queue.get(timeout=5)
            except Exception:  # queue.Empty: the follower may have died
                if not follower.is_alive():
                    break
        check(theirs is not None, f"the follower reported (exit code {follower.exitcode})")
        follower.join(120)
        check("error" not in theirs and follower.exitcode == 0,
              f"the follower ran its rank to the end ({theirs.get('error', 'exit 0')})")
    finally:
        if follower.is_alive():
            follower.kill()
        work.cleanup()
    return ours, theirs


def sharded_decode_phase(torch, dev, smi, want, started):
    """Phase [16]: sharded LM decode, two ranks on the one card on a (data
    1, model 2) mesh (see the SHARD_LONG_* constants and the module
    docstring). ``want``: [7]'s first tokens and first decode step's
    tokens, [8]'s first-step logits of [7]'s kernel path (CPU);
    ``started``: `start_follower`'s. Returns (a)'s K4 launches a
    rank."""
    import numpy as np

    t_phase = time.perf_counter()
    log(f"[16] sharded LM decode: {LM_ARCH}, two ranks on {dev}, mesh (data 1, model 2), the KV "
        f"caches split along their sequence (kvseq -> model) ({smi})")
    (mine, keep), theirs = join_follower(started, lambda init: sharded_decode_rank(torch, 0, init),
                                         SHARD_DECODE_TIMEOUT_S)
    from repro_torch.configs.registry import get_config

    cfg = get_config(LM_ARCH)
    L = cfg.n_layers
    a, ta = mine["a"], theirs["a"]
    ms = 1e3 * LM_BATCH / a["tps"]
    log(f"  (a) {LM_ARCH} at full width, backend {mine['backend']}, engine mode {a['mode']} "
        f"({a['why']}); caches {a['placed']}, local k {a['local_k']}: prefill {LM_BATCH} x {LM_PROMPT} "
        f"tokens {mine['prefill_s']:.3f} s (rank 1 {theirs['prefill_s']:.3f} s), peak "
        f"{mine['prefill_peak'] / 1e9:.2f} / {theirs['prefill_peak'] / 1e9:.2f} GB; decode {SHARD_LM_STEPS} steps "
        f"x {LM_BATCH}: {a['tps']:.1f} tokens/s, {ms:.3f} ms a step (rank 1 {ta['tps']:.1f} tokens/s), "
        f"peak {a['peak'] / 1e9:.2f} / {ta['peak'] / 1e9:.2f} GB a rank; no speed claimed: both ranks "
        f"share one card ({smi})")
    p = mine["profile"]
    log(f"  (a) one step profiled on rank 0: wall {p['wall']:.1f} ms, device busy "
        + (f"{p['busy']:.1f} ms" if p["busy"] is not None else "not measured (no device rows)")
        + f", host ops' self CPU {p['host_ms']:.1f} ms; most: "
        + ", ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in p["host"]))
    for r in (mine, theirs):
        log(f"  (a) rank {r['rank']} collectives a step (calls, bytes handed in): "
            + ", ".join(f"{k} {c} x, {r['bytes'][k] / 1e6:.3f} MB" for k, c in sorted(r["calls"].items()))
            + f"; total {sum(r['bytes'].values()) / 1e6:.3f} MB")
    for r in (a, ta):
        check(r["k4"] == L * r["steps"] and sum(r["launches"].values()) == r["k4"],
              f"(a) K4 on each rank's kvseq shard, once a layer and step: {r['k4']} launches = {L} x "
              f"{r['steps']} (warm-up {r['steps'] - SHARD_LM_STEPS} + {SHARD_LM_STEPS})")
    check(a["stream"] == ta["stream"] and a["pos"] == LM_PROMPT + SHARD_LM_STEPS
          and a["mode"] == "eager",
          f"(a) both ranks return the same tokens; final position {a['pos']}")
    check(a["first"] == want["first"] and a["stream"][0] == want["stream0"],
          f"(a) the sharded prefill's greedy tokens and the first decode step's equal [7]'s: "
          f"{a['stream'][0]}")
    scale = float(want["logits0"].abs().max())
    d0 = float((keep["logits0"] - want["logits0"]).abs().max())
    check(d0 <= FULL_TOL * scale, f"(a) first-step logits within {FULL_TOL} x max |logit| = "
          f"{FULL_TOL * scale:.4f} of [7]'s kernel path (max |diff| {d0:.4f})")
    agree = float(np.mean(np.array(a["stream"]) == np.array(want["stream"][:SHARD_LM_STEPS])))
    log(f"  (a) greedy tokens equal to [7]'s over {SHARD_LM_STEPS} steps: {100 * agree:.2f}% (printed, not "
        "gated: a bf16 near-tie may flip)")

    b = mine["b"]
    one_first, one_toks, one_lgs = keep["b_one"]
    db = float((keep["b_logits"] - one_lgs).abs().max())
    check(b["first"] == one_first and b["tokens"] == one_toks and theirs["b"] == b
          and db <= EXACT_TOL,
          f"(b) reduced f32 ({EXACT_LAYERS} layers): two ranks' tokens = one rank's over "
          f"{EXACT_STEPS} steps, logits within {EXACT_TOL} (max |diff| {db:.3e})")

    c, tc = mine["c"], theirs["c"]
    one_toks, one_tps = keep["c_one"]
    scale = float(keep["c_one_logits0"].abs().max())
    dc = float((keep["c_logits0"] - keep["c_one_logits0"]).abs().max())
    log(f"  (c) decode_long: batch 1, {SHARD_LONG_SEQ} positions (rank 1's from {tc['offset']}), pos "
        f"{SHARD_LONG_POS}, caches {c['placed']}: {c['tps']:.2f} tokens/s, one rank unsharded (graph) "
        f"{one_tps:.2f}; tokens equal to one rank's: "
        f"{100 * float(np.mean(np.array(c['tokens']) == np.array(one_toks))):.2f}%")
    for r in (c, tc):
        check(r["k4"] == L * r["steps"], f"(c) K4 on each rank's shard (rank 0's holds no position of "
              f"a local layer's window), {r['k4']} launches = {L} x {r['steps']}")
    check(c["tokens"] == tc["tokens"] and dc <= FULL_TOL * scale,
          f"(c) both ranks' tokens equal; first-step logits within {FULL_TOL} x max |logit| = "
          f"{FULL_TOL * scale:.4f} of one rank's unsharded K4 decode (max |diff| {dc:.4f})")
    log(f"[16] sharded LM decode phase: {time.perf_counter() - t_phase:.1f} s")
    return a["k4"]


def family_train_batch(torch, cfg, device, seed):
    """A (EXACT_BATCH, FAMILY_EXACT_PROMPT) train batch from a numpy seed:
    tokens, a loss mask and the family's extra inputs (frames, patches,
    M-RoPE positions), the same on every device."""
    import numpy as np

    from repro_torch.launch.train import extras_for

    rng = np.random.default_rng(seed)
    B, T = EXACT_BATCH, FAMILY_EXACT_PROMPT
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "loss_mask": (rng.random((B, T)) < 0.8).astype(np.float32)}
    batch.update({k: np.asarray(f(B, T)) for k, f in extras_for(cfg).items()})
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def family_train_step(torch, dev, cfg, mesh):
    """One train step of ``cfg`` at accum_steps 2 from masters drawn by a CPU
    generator: on ``mesh`` (DTensors placed by the train rules) or, with
    None, unsharded. Returns its loss and grad norm."""
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import sharding as sh
    from repro_torch.training.optimizer import AdamConfig, adam_init, adam_state_specs
    from repro_torch.training.train_loop import make_train_step

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), device=dev, masters=True)
    opt, kw = adam_init(params), {}
    if mesh is not None:
        rules, specs = sh.rules_for(cfg, "train"), model.param_specs()
        params = sh.shard_tree(params, specs, rules, mesh)
        opt = sh.shard_tree(opt, adam_state_specs(specs), rules, mesh)
        kw = dict(constrain=sh.make_constrain(mesh, rules), layer_specs=model.layer_specs(),
                  grad_shardings=sh.spec_tree_to_shardings(specs, rules, mesh))
    step = make_train_step(model, AdamConfig(lr=TRAIN_EXACT_LR), accum_steps=2, **kw)
    _, _, m = step(params, opt, family_train_batch(torch, cfg, dev, SEED + 3))
    return {k: float(m[k]) for k in ("loss", "grad_norm")}


def family_sharded_run(torch, dev, arch, mesh, rank):
    """[18](b) of one family on this rank: reduced f32, a sharded train step
    and a sharded prefill (their collectives and exchanged bytes counted),
    then SHARD_FAMILY_STEPS steps of DecodeEngine(mesh=); rank 0 also runs
    both unsharded on the card. Returns (numbers, rank 0's tensors)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import opcount
    from repro_torch.runtime import sharding as sh
    from repro_torch.serving.engine import DecodeEngine, lm_decoder

    rcfg = reduced(get_config(arch), dtype="float32")
    rmodel = build_model(rcfg)
    rplain = rmodel.init(torch.Generator().manual_seed(SEED), device=dev)
    rrules = sh.rules_for(rcfg, "decode")
    rparams = sh.shard_tree(rplain, rmodel.param_specs(), rrules, mesh)
    batch = family_batch(torch, rcfg, dev, EXACT_BATCH, FAMILY_EXACT_PROMPT, SEED + 1)
    seq = FAMILY_EXACT_PROMPT + SHARD_FAMILY_STEPS
    lgs, keep = [], {}
    mesh_mod.EXCHANGED.clear()
    # the train step's and the prefill's collectives, as CollectiveCounter
    # and as the dry run's counter (runtime.opcount) see them
    with mesh_mod.CollectiveCounter() as counter, opcount.OpCounter() as counted:
        res = {"train": family_train_step(torch, dev, rcfg, mesh)}
        with torch.no_grad():
            logits, st = rmodel.prefill(rparams, batch, constrain=sh.make_constrain(mesh, rrules))
    res["coll"] = (dict(counter.calls), dict(mesh_mod.EXCHANGED),
                   dict(counted.result()["collectives"]["count_by_op"]))
    with torch.no_grad():
        rfirst = sh.argmax_last(logits[:, -1])
        rengine = DecodeEngine(recording(torch, lm_decoder(rmodel, use_kernel=True), lgs), rparams,
                               mesh=mesh)
        rtoks, _, _ = rengine.generate(rmodel.rehome_state(st, seq), rfirst, SHARD_FAMILY_STEPS)
    res.update(first=rfirst.cpu().tolist(), tokens=rtoks.cpu().tolist(),
               placed=sorted({str(tuple(t.placements)) for t in tensors(rparams)
                              if hasattr(t, "placements")}))
    if rank == 0:
        keep = {"logits": torch.stack(lgs[-SHARD_FAMILY_STEPS:]).cpu(),
                "one_train": family_train_step(torch, dev, rcfg, None)}
        with torch.no_grad():
            logits, st = rmodel.prefill(rplain, batch)
            one_first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            toks, one_lgs = eager_stream(torch, rmodel, rplain, rmodel.rehome_state(st, seq),
                                         one_first, SHARD_FAMILY_STEPS, use_kernel=True)
        keep["one"] = (one_first.cpu().tolist(), toks.cpu().tolist(), one_lgs.float().cpu())
    return res, keep


def sharded_families_rank(torch, rank, init):
    """One rank of phase [18], run by this process (rank 0) and the
    follower: joins the two-rank group, then (b) each FAMILY_EXACT_ARCHS
    family at reduced width in f32 (`family_sharded_run`; one that raises
    is recorded, and fails its gate once every family has run), then (a)
    recurrentgemma-2b at full width: a sharded prefill (its collectives
    and exchanged bytes counted), its first step's logits, one step's
    collectives, then DecodeEngine(mesh=) with K4; then the same model in
    f32, a sharded prefill and first step beside one card's (rank 0).
    Returns its numbers as plain data, and rank 0's tensors for the
    gates."""
    import dataclasses
    import traceback

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import sharding as sh
    from repro_torch.serving.engine import EAGER_WARMUP_STEPS, DecodeEngine, copy_state, lm_decoder

    backend = mesh_mod.init_ranks(rank, 2, init, "cuda", timeout_s=SHARD_FAMILY_TIMEOUT_S)
    dev = torch.device("cuda", torch.cuda.current_device())
    out, keep = {"rank": rank, "backend": backend, "b": {}}, {}
    try:
        mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), "cuda")
        # (b) every family at reduced width in f32, two ranks against one
        for arch in FAMILY_EXACT_ARCHS:
            try:
                out["b"][arch], keep[arch] = family_sharded_run(torch, dev, arch, mesh, rank)
            except Exception as e:  # both ranks raise alike; its gate fails after the others ran
                out["b"][arch] = {"error": f"{type(e).__name__}: {e}"}
                if rank == 0:
                    log(f"  (b) {arch} raised:\n{traceback.format_exc()[-3000:]}")

        # (a) the hybrid at full width
        cfg = get_config(SHARD_HYBRID_ARCH)
        model = build_model(cfg)
        rules = sh.rules_for(cfg, "decode")
        constrain = sh.make_constrain(mesh, rules)
        params = sh.shard_tree(model.init(torch.Generator(device=dev).manual_seed(SEED), device=dev),
                               model.param_specs(), rules, mesh)
        batch = family_batch(torch, cfg, dev, LM_BATCH, LM_PROMPT, SEED)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh_mod.EXCHANGED.clear()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mesh_mod.CollectiveCounter() as counter:
                logits, state = model.prefill(params, batch, constrain=constrain)
            torch.cuda.synchronize()
            out["prefill_s"] = time.perf_counter() - t0
            out["prefill_peak"] = torch.cuda.max_memory_allocated(dev)
            out["prefill_coll"] = (dict(counter.calls), dict(counter.bytes), dict(mesh_mod.EXCHANGED))
            full = model.rehome_state(state, LM_PROMPT + LM_STEPS)
            del state, batch
            first = sh.argmax_last(logits[:, -1])
            del logits
            lg, _ = model.decode_step(params, copy_state(full), first, constrain=constrain,
                                      use_kernel=True)
            keep["logits0"] = lg.full_tensor()[:, :cfg.vocab].float().cpu()
            mesh_mod.EXCHANGED.clear()
            with mesh_mod.CollectiveCounter() as counter:
                model.decode_step(params, copy_state(full), first, constrain=constrain,
                                  use_kernel=True)
            out["step_coll"] = (dict(counter.calls), dict(counter.bytes), dict(mesh_mod.EXCHANGED))
        engine = DecodeEngine(lm_decoder(model, use_kernel=True), params, mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        stream, final, tps = engine.generate(full, first, SHARD_HYBRID_STEPS)
        out["a"] = dict(mode=engine.mode, tps=tps, k4=ops.launches["decode_attn"],
                        launches=dict(ops.launches),
                        steps=SHARD_HYBRID_STEPS + min(SHARD_HYBRID_STEPS, EAGER_WARMUP_STEPS),
                        peak=torch.cuda.max_memory_allocated(dev), pos=int(sh.local(final["pos"])),
                        first=first.cpu().tolist(), stream=stream.cpu().tolist(),
                        placed=sorted({str(tuple(t.placements)) for t in tensors(full)
                                       if hasattr(t, "placements")}))
        del full, final, engine, stream, params
        torch.cuda.empty_cache()

        # (a) in f32 at full width: the sharded prefill and first step
        # against one card (rank 0), at a shorter prompt
        fcfg = dataclasses.replace(cfg, dtype="float32")
        fmodel = build_model(fcfg)
        frules = sh.rules_for(fcfg, "decode")
        fplain = fmodel.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
        fparams = sh.shard_tree(fplain, fmodel.param_specs(), frules, mesh)
        if rank != 0:
            del fplain
        fbatch = family_batch(torch, fcfg, dev, LM_BATCH, SHARD_HYBRID_F32_PROMPT, SEED)
        seq = SHARD_HYBRID_F32_PROMPT + 1
        with torch.no_grad():
            logits, st = fmodel.prefill(fparams, fbatch, constrain=sh.make_constrain(mesh, frules))
            ffirst = sh.argmax_last(logits[:, -1])
            lg, _ = fmodel.decode_step(fparams, fmodel.rehome_state(st, seq), ffirst,
                                       constrain=sh.make_constrain(mesh, frules), use_kernel=True)
            out["f32"] = {"first": ffirst.cpu().tolist(), "step": sh.argmax_last(lg).cpu().tolist()}
            keep["f32_logits"] = lg.full_tensor()[:, :cfg.vocab].float().cpu()
            del fparams, logits, st, lg
            if rank == 0:
                logits, st = fmodel.prefill(fplain, fbatch)
                one_first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                lg, _ = fmodel.decode_step(fplain, fmodel.rehome_state(st, seq), one_first,
                                           use_kernel=True)
                keep["f32_one"] = (one_first.cpu().tolist(), lg[:, :cfg.vocab].float().cpu())
                del fplain, logits, st, lg
        dist.barrier()
    finally:
        mesh_mod.close_peer_buffers()
        dist.destroy_process_group()
    return out, keep


def sharded_families_follower(rank, init, queue):
    """Phase [18]'s second rank, started with the spawn method."""
    import torch

    cuda_flags(torch)
    try:
        queue.put(sharded_families_rank(torch, rank, init)[0])
    except BaseException as e:  # the controller reports it and fails
        queue.put({"rank": rank, "error": repr(e)})
        raise


def train_step_count(torch, device, arch, layers, batch, seq):
    """`runtime.opcount`'s count (FLOPs, bytes) of one train step of ``arch``
    at full width cut to ``layers`` layers (each layer is the same work)
    on a (``batch``, ``seq``) batch, at the config's accum_steps: the step
    ``launch.train.train`` runs (f32 masters, remat, Adam). On a card the
    ops run on real tensors; on the CPU on fake ones (shapes only), so the
    count of a full-width step costs no memory."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch._tree import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import specs as specs_lib
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import opcount
    from repro_torch.training.optimizer import AdamConfig, adam_init
    from repro_torch.training.train_loop import make_train_step

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = build_model(cfg)
    step = make_train_step(model, AdamConfig(), accum_steps=cfg.accum_steps)
    shapes, _ = specs_lib.param_shapes_and_specs(model, masters=True)
    fake = FakeTensorMode(allow_non_fake_inputs=True) if torch.device(device).type == "cpu" else None
    with fake or contextlib.nullcontext():
        params = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), shapes)
        tokens = torch.zeros((batch, seq), dtype=torch.int32, device=device)
        b = {"tokens": tokens, "loss_mask": torch.ones((batch, seq), device=device)}
    res = opcount.analyze(step, params, adam_init(params), b, fake_mode=fake)
    return {"flops": res["flops"], "bytes": res["bytes_accessed"], "ops": res["n_ops"],
            "seconds": res["trace_seconds"]}


def rwkv_train_phase(torch, dev, smi):
    """[18](c): rwkv6-1.6b trained at full width, RWKV_TRAIN_LAYERS deep, on
    the card for RWKV_TRAIN_STEPS steps of launch.train.train, and one
    layer's step counted by runtime.opcount."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import train

    CUT_ARCH = f"{RWKV_TRAIN_ARCH}-cut"
    cfg = get_config(RWKV_TRAIN_ARCH)
    B, S = RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ
    log(f"[18] (c) {RWKV_TRAIN_ARCH} at full width (d_model {cfg.d_model}, {cfg.n_heads} wkv heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), CUT to {RWKV_TRAIN_LAYERS} of "
        f"{cfg.n_layers} layers, {cfg.dtype} on f32 masters, remat {cfg.remat}, accum_steps "
        f"{cfg.accum_steps}: {RWKV_TRAIN_STEPS} steps of launch.train.train at batch {B} x seq {S}, "
        f"lr {RWKV_TRAIN_LR} ({smi})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    registry.ARCHS[CUT_ARCH] = dataclasses.replace(cfg, n_layers=RWKV_TRAIN_LAYERS)
    try:
        t0 = time.perf_counter()
        res = train(CUT_ARCH, reduced=False, steps=RWKV_TRAIN_STEPS, batch=B, seq=S,
                    lr=RWKV_TRAIN_LR, device=dev, log_every=1)
    finally:
        registry.ARCHS.pop(CUT_ARCH)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses_c = np.array(res["losses"])
    norms = np.array([m["grad_norm"] for m in res["metrics"]])
    step_s = np.array(res["monitor"].history)
    del res
    torch.cuda.empty_cache()
    ms = 1e3 * float(np.mean(step_s[1:]))
    log(f"  {RWKV_TRAIN_STEPS} steps in {wall:.1f} s (init included); step ms: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in step_s)}; after the first {ms:.1f} ms a step, "
        f"{B * S / ms * 1e3:.0f} tokens/s; peak memory {peak:.2f} GB ({smi})")
    log(f"  losses {losses_c.round(4).tolist()}; grad norms {norms.round(4).tolist()}")
    check(np.isfinite(losses_c).all() and np.isfinite(norms).all() and losses_c[-1] < losses_c[0],
          f"(c) every loss and grad norm finite, the losses falling: {losses_c[0]:.4f} -> "
          f"{losses_c[-1]:.4f}")
    count = train_step_count(torch, dev, RWKV_TRAIN_ARCH, 1, B, RWKV_COUNT_SEQ)
    log(f"  (c) runtime.opcount of one layer's train step at {B} x {RWKV_COUNT_SEQ} (the same step at "
        f"n_layers 1, on the card): {count['bytes']:.6e} bytes, {count['flops']:.6e} FLOPs, "
        f"{count['ops']} ops, counted in {count['seconds']:.1f} s")


def sharded_families_phase(torch, dev, smi, want, started):
    """Phase [18]: every LM family sharded on the card (see the
    SHARD_HYBRID_* / RWKV_TRAIN_* constants and the module docstring).
    ``want``: [12]'s recurrentgemma-2b numbers (its first tokens, first
    decode step's tokens and K4-path first-step logits); ``started``:
    `start_follower`'s. (c) runs first, while the follower waits at the
    rendezvous. Returns (a)'s K4 launches a rank."""
    import numpy as np

    from repro_torch.configs.registry import get_config

    t_phase = time.perf_counter()
    rwkv_train_phase(torch, dev, smi)
    t_c = time.perf_counter() - t_phase
    log(f"[18] every LM family sharded: two ranks on {dev}, mesh (data 1, model 2), the all-to-alls "
        f"of DTensor's Shard -> Shard through the ranks' device buffers ({smi})")
    (mine, keep), theirs = join_follower(started, lambda init: sharded_families_rank(torch, 0, init),
                                         SHARD_FAMILY_TIMEOUT_S)
    a2a = {}
    for arch in FAMILY_EXACT_ARCHS:
        for r in (mine, theirs):
            check("error" not in r["b"][arch], f"(b) {arch} rank {r['rank']} ran to the end "
                  f"({r['b'][arch].get('error', 'no error')})")
            calls, moved, counted = r["b"][arch]["coll"]
            n, n_single = calls.get("shard_dim_alltoall", 0), calls.get("all_to_all_single", 0)
            a2a[arch, r["rank"]] = n + n_single
            check((n > 0) == (moved.get("shard_dim_alltoall", 0) > 0)
                  and (n_single > 0) == (moved.get("all_to_all_single", 0) > 0)
                  and counted.get("all-to-all", 0) == n + n_single,
                  f"(b) {arch} rank {r['rank']}, train step and prefill: every all-to-all through the "
                  f"peer buffers: _dtensor.shard_dim_alltoall {n} calls, "
                  f"{moved.get('shard_dim_alltoall', 0) / 1e3:.3f} kB; all_to_all_single {n_single} "
                  f"calls; runtime.opcount counts {counted.get('all-to-all', 0)} \"all-to-all\"; "
                  f"collectives {dict(sorted(calls.items()))}")
    check(all(a2a[RWKV_TRAIN_ARCH, r] > 0 for r in (0, 1)),
          f"(b) {RWKV_TRAIN_ARCH}'s Shard -> Shard redistributes ran as all-to-alls through the peer "
          f"buffers on both ranks ({a2a[RWKV_TRAIN_ARCH, 0]} a rank); all-to-alls by arch and rank: "
          f"{ {f'{a} {r}': n for (a, r), n in a2a.items()} }")
    for arch in FAMILY_EXACT_ARCHS:
        b, tb, k = mine["b"][arch], theirs["b"][arch], keep[arch]
        fam = get_config(arch).family
        tol = SHARD_FAMILY_LOGIT_TOL.get(fam, 1e-5)
        one, two = k["one_train"], b["train"]
        dl = abs(two["loss"] - one["loss"]) / abs(one["loss"])
        dn = abs(two["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
        check(b["train"] == tb["train"] and dl <= TRAIN_LOSS_RTOL and dn <= TRAIN_NORM_RTOL,
              f"(b) {arch} ({fam}) reduced f32, one train step at accum_steps 2: two ranks' loss "
              f"{two['loss']:.6f} and grad norm {two['grad_norm']:.6f} = one rank's within "
              f"{TRAIN_LOSS_RTOL} ({dl:.2e}) and {TRAIN_NORM_RTOL} ({dn:.2e}) relative")
        one_first, one_toks, one_lgs = k["one"]
        d = float((k["logits"] - one_lgs).abs().max())
        check(b["first"] == one_first and b["tokens"] == one_toks and tb["tokens"] == b["tokens"]
              and bool(torch.allclose(k["logits"], one_lgs, rtol=tol, atol=tol)),
              f"(b) {arch}: sharded prefill and {SHARD_FAMILY_STEPS} steps of DecodeEngine(mesh=) give "
              f"one rank's tokens, logits within {tol} (max |diff| {d:.3e}); params placed "
              f"{b['placed']}")
    cfg = get_config(SHARD_HYBRID_ARCH)
    n_attn = n_attention_layers(cfg)
    a, ta = mine["a"], theirs["a"]
    ms = 1e3 * LM_BATCH / a["tps"]
    log(f"  (a) {SHARD_HYBRID_ARCH} at full width ({cfg.n_layers} layers, {n_attn} attention), backend "
        f"{mine['backend']}, engine mode {a['mode']}; state placements {a['placed']}: prefill {LM_BATCH} "
        f"x {LM_PROMPT} tokens {mine['prefill_s']:.3f} s (rank 1 {theirs['prefill_s']:.3f} s), peak "
        f"{mine['prefill_peak'] / 1e9:.2f} / {theirs['prefill_peak'] / 1e9:.2f} GB; decode "
        f"{SHARD_HYBRID_STEPS} steps x {LM_BATCH}: {a['tps']:.1f} tokens/s, {ms:.3f} ms a step (rank 1 "
        f"{1e3 * LM_BATCH / ta['tps']:.3f} ms), peak {a['peak'] / 1e9:.2f} / {ta['peak'] / 1e9:.2f} GB a "
        f"rank; no speed claimed: both ranks share one card ({smi})")
    for r in (mine, theirs):
        for what in ("prefill", "step"):
            calls, sent, moved = r[f"{what}_coll"]
            log(f"  (a) rank {r['rank']} {what} collectives (calls, bytes handed in): "
                + ", ".join(f"{k} {c} x, {sent[k] / 1e6:.3f} MB" for k, c in sorted(calls.items()))
                + "; through the peer buffers: "
                + (", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in sorted(moved.items())) or "none"))
    for r in (a, ta):
        check(r["k4"] == n_attn * r["steps"] and sum(r["launches"].values()) == r["k4"],
              f"(a) K4's shard mode on each rank's kvseq shard, once an attention layer and step: "
              f"{r['k4']} launches = {n_attn} x {r['steps']} (warm-up {r['steps'] - SHARD_HYBRID_STEPS} + "
              f"{SHARD_HYBRID_STEPS})")
    check(a["stream"] == ta["stream"] and a["pos"] == LM_PROMPT + SHARD_HYBRID_STEPS
          and a["mode"] == "eager", f"(a) both ranks return the same tokens; final position {a['pos']}")
    check(a["first"] == want["first"] and a["stream"][0] == want["stream0"],
          f"(a) the sharded prefill's greedy tokens and the first decode step's equal [12]'s: "
          f"{a['stream'][0]}")
    scale = float(want["logits0"].abs().max())
    d0 = float((keep["logits0"] - want["logits0"]).abs().max())
    d_plain = float((keep["logits0"] - want["plain0"]).abs().max())
    d_paths = float((want["plain0"] - want["logits0"]).abs().max())
    log(f"  (a) bf16 first-step logits, max |diff|: sharded vs [12]'s kernel path {d0:.4f} "
        f"({100 * d0 / scale:.2f}% of max |logit| {scale:.4f}), vs its plain path {d_plain:.4f}; [12]'s "
        f"two paths {d_paths:.4f} (printed, not gated: bf16 rounding of the ranks' partial sums, "
        f"held in f32 below)")
    one_first, one_lg = keep["f32_one"]
    scale = float(one_lg.abs().max())
    d32 = float((keep["f32_logits"] - one_lg).abs().max())
    check(mine["f32"]["first"] == one_first and theirs["f32"] == mine["f32"]
          and mine["f32"]["step"] == torch.argmax(one_lg, dim=-1).tolist()
          and d32 <= SHARD_HYBRID_F32_TOL * scale,
          f"(a) in f32 at full width ({LM_BATCH} x {SHARD_HYBRID_F32_PROMPT}-token prompts): the sharded "
          f"prefill's and first step's tokens = one card's, the step's logits within "
          f"{SHARD_HYBRID_F32_TOL} x max |logit| = {SHARD_HYBRID_F32_TOL * scale:.2e} (max |diff| "
          f"{d32:.3e}, {d32 / scale:.2e} of max |logit|)")

    log(f"[18] every LM family sharded: {time.perf_counter() - t_phase:.1f} s ((c) {t_c:.1f} s)")
    return a["k4"]


def counted_pair(torch, what, kernel, run):
    """[17](b): ``run(use_kernel)`` under `runtime.opcount.OpCounter`, with
    the kernel and plain: the kernel launched once, the counts equal.
    Returns the kernel run's record."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import opcount

    got = {}
    for uk in (True, False):
        before = ops.launches[kernel]
        with torch.no_grad():
            got[uk] = opcount.analyze(run, uk)
        torch.cuda.synchronize()
        got[uk]["launched"] = ops.launches[kernel] - before
        del got[uk]["out"]
    check(got[True]["launched"] > 0 and got[False]["launched"] == 0,
          f"{what}: {kernel} launched {got[True]['launched']} times with the kernel, 0 plain")
    for k in ("flops", "bytes_accessed", "collectives", "dot_flops_by_shape", "op_histogram",
              "regions"):
        check(got[True][k] == got[False][k], f"{what}: {k} equal with {kernel} and plain "
              f"({got[True][k] if k in ('flops', 'bytes_accessed', 'regions') else '...'})")
    return got[True]


def count_simnet_step(torch, dev, pcfg, params):
    """[17](b): one c3 step at [5]'s shape (L lanes, context Q, f32 state)
    through `run_chunk`, with K1 and plain."""
    from repro_torch.core import simulator as sim
    from repro_torch.serving.simnet_engine import chunk_specs, run_chunk

    cfg = sim.SimConfig(ctx_len=Q)
    xs = {k: (torch.ones if k == "active" else torch.zeros)(shape, dtype=dt, device=dev)
          for k, (shape, dt) in chunk_specs(L, 1).items()}
    rw = torch.full((L,), cfg.retire_width, dtype=torch.int32, device=dev)
    lc = torch.full((L,), cfg.ctx_len, dtype=torch.int32, device=dev)
    states = {uk: sim.init_state(L, cfg, dev) for uk in (True, False)}  # made outside the count
    return counted_pair(torch, f"SimNet c3 step, {L} lanes", "fused_step", lambda uk: run_chunk(
        pcfg, cfg, uk, params, states[uk], xs, rw, lc))


def count_decode_step(torch, lm):
    """[17](b): one gemma3-4b decode step at [7]'s shape (a copy of its
    re-homed state: K4 reads the live positions), with K4 and plain."""
    from repro_torch.serving.engine import copy_state

    model, params, full, first = lm["model"], lm["params"], lm["full"], lm["first"]
    k4_bytes_check(torch, first.device, model.cfg)
    states = {uk: copy_state(full) for uk in (True, False)}  # copied outside the count
    return counted_pair(torch, f"{LM_ARCH} decode step, {LM_BATCH} requests", "decode_attn",
                        lambda uk: model.decode_step(params, states[uk], first, use_kernel=uk))


K4_OPS_RATIO = (2.9, 3.2)  # [17](b): the plain attention's bytes op by op over K4's region's


def k4_bytes_check(torch, dev, cfg):
    """[17](b): K4's region bytes against the plain attention counted op by
    op (no region) on a full cache of [7]'s shape, no window: the plain
    path reads and writes K and V in the einsums' contiguous copies and
    reads them again in the GEMMs, three times to the region's once."""
    from repro_torch.nn import attention as attn
    from repro_torch.runtime import opcount

    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(LM_BATCH, cfg.n_heads, cfg.head_dim, device=dev, generator=g,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(LM_BATCH, LM_CACHE, cfg.n_kv_heads, cfg.head_dim, device=dev,
                        generator=g, dtype=torch.bfloat16) for _ in range(2))
    n = torch.tensor(LM_CACHE, dtype=torch.int32, device=dev)
    with torch.no_grad():
        plain = opcount.analyze(attn._plain_attention, q, k, v, n, dtype=torch.bfloat16, window=0)
        region = opcount.analyze(attn.decode_attention, q, attn.KVCache(k, v), n, use_kernel=True)
    ratio = plain["bytes_accessed"] / region["bytes_accessed"]
    check(plain["flops"] == region["flops"] and K4_OPS_RATIO[0] <= ratio <= K4_OPS_RATIO[1],
          f"K4's region on a full cache ({LM_BATCH} x {LM_CACHE} positions, no window): "
          f"{region['bytes_accessed']:.6e} bytes, {region['flops']:.6e} FLOPs; the plain attention "
          f"op by op {plain['bytes_accessed']:.6e} bytes ({ratio:.4f}x, within {K4_OPS_RATIO}), "
          f"{plain['flops']:.6e} FLOPs")


def _cell_tag(overrides):
    return "".join(f"__{k}{v}" for k, v in (overrides or {}).items())


def start_dryrun():
    """[17](a)'s child process, started ahead of its phase so that its
    trace (CPU work) runs beside the phases before it. Returns what
    `dryrun_phase` takes."""
    (ROOT / "build").mkdir(exist_ok=True)
    out = tempfile.TemporaryDirectory(dir=ROOT / "build")
    calls = [f"run_cell({a!r}, {s!r}, {mp}, Path({out.name!r}), overrides={ov!r}, "
             f"tag={_cell_tag(ov)!r})" for a, s, mp, ov in DRYRUN_CELLS]
    code = ("import sys; from pathlib import Path; from repro_torch.launch.dryrun import run_cell; "
            f"sys.exit(any(str(r['status']).startswith('FAIL') for r in [{', '.join(calls)}]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(Path(out.name) / name, "w+") for name in ("stdout", "stderr")]  # no pipe to fill
    child = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=logs[0], stderr=logs[1],
                             text=True, cwd=str(ROOT))
    return child, out, logs, time.perf_counter()


def dryrun_phase(started):
    """[17](a): the dry run of DRYRUN_CELLS in one child process
    (`start_dryrun`'s)."""
    log("[17] the dry run and the roofline on H100 figures")
    child, work, logs, t0 = started
    try:
        child.wait(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
    stdout, stderr = (f.seek(0) or f.read() for f in logs)
    for f in logs:
        f.close()
    with work as out:
        for line in stdout.splitlines():
            log(f"  | {line}")
        check(child.returncode == 0, f"dry-run child exit code 0 ({time.perf_counter() - t0:.1f} s since "
              f"it started; stderr tail: {stderr[-1500:] if child.returncode else ''})")
        for arch, shape, mp, ov in DRYRUN_CELLS:
            rec = json.loads((Path(out) / f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
                                            f"{_cell_tag(ov)}.json").read_text())
            r, c = rec["roofline"], rec["collectives"]
            check(rec["status"] == "ok", f"{arch} × {shape} × {rec['mesh']} ({rec['n_devices']} ranks"
                  f"{', ' + str(ov) if ov else ''}): traced in {rec['compile_seconds']:.1f} s; rank "
                  f"{rec.get('rank', 0)}'s {r['flops_per_device']:.4e} "
                  f"FLOPs, {r['bytes_per_device']:.4e} bytes, {c['total_count']:.0f} collectives "
                  f"({c['total_bytes']:.4e} wire bytes); compute {r['compute_s']:.4e} s, memory "
                  f"{r['memory_s']:.4e} s, collective {r['collective_s']:.4e} s, dominant "
                  f"{r['dominant']}; peak live {rec['memory_analysis']['peak_live_bytes_est']:.4e} B")
            if arch.startswith("simnet"):
                check(c["total_count"] == 0 and c["total_bytes"] == 0,
                      f"{arch}: no collective at {rec['n_devices']} ranks (the lanes never talk)")
            elif shape.startswith("decode"):
                bounds = {k: v["roofline"]["bound_s"] for k, v in rec["ranks"].items()}
                check(set(rec["ranks"]) == {"0", str(rec["n_devices"] - 1)}
                      and rec["rank"] == rec["n_devices"] - 1,
                      f"{arch} × {shape}: traced as rank 0 and the last rank, the record the last's "
                      f"(its windowed layers' live positions; bound s by rank {bounds})")



def roofline_share(what, rec, peak, measured_ms, smi):
    """[17](b): a step's bound from its counts over its measured time."""
    from repro_torch.runtime.roofline import roofline

    terms = roofline(rec["flops"], rec["bytes_accessed"], rec["collectives"]["total_bytes"],
                     peak_flops=peak)
    share = terms.bound_s * 1e3 / measured_ms
    check(share <= SHARE_MAX, f"{what}: bound {terms.bound_s * 1e3:.4f} ms (compute "
          f"{terms.compute_s * 1e3:.4f}, memory {terms.memory_s * 1e3:.4f}; {terms.dominant}) over "
          f"{measured_ms:.4f} ms a step measured: roofline share {100 * share:.2f}% ({smi})")
    return share


def ptxas_entries(log):
    """Per kernel entry in nvcc's -Xptxas -v output: registers, static shared
    memory, stack frame and spills (stores, loads) in bytes."""
    entries = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"\d+([a-z_0-9]+_kernel)", name)
            if short:  # the kernel's name, then its mangled template arguments
                tail = name[short.end(1):]
                name = short.group(1) + (tail[: tail.find("EE") + 2] if tail.startswith("I") else "")
            entries.append({"fn": name})
        elif entries:
            e = entries[-1]
            if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line):
                e["stack"], e["spills"] = int(m.group(1)), (int(m.group(2)), int(m.group(3)))
            if m := re.search(r"Used (\d+) registers", line):
                e["regs"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                e["smem"] = int(m.group(1))
    return entries


def only_phases(torch, dev, smi, only, t_start):
    """``--only 17,18``: the named phases alone (after the builds), to
    check one on the card; [18] takes [12]'s recurrentgemma-2b run first,
    for the one-card tokens it is held to. Prints no result line."""
    if "18" in only:
        started = start_follower(sharded_families_follower)
        want = family_phase(torch, dev, SHARD_HYBRID_ARCH, None, LM_PROMPT)
        sharded_families_phase(torch, dev, smi, want, started)
    if "17" in only:
        dryrun_phase(start_dryrun())
    log(f"chip_smoke.py --only {','.join(only)} wall time {time.perf_counter() - t_start:.1f} s ({smi})")


def main():
    t_start = time.perf_counter()
    only = sys.argv[2].split(",") if sys.argv[1:2] == ["--only"] else []
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit("chip_smoke.py must run from the root of a checkout (src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    cuda_flags(torch)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    log(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}), device: {kind}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    log(smi)

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.breakdown import K4_SHAPES

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        for e in ptxas_entries(b.log):
            log(f"  {name}: {e['fn']}: {e.get('regs')} registers, {e.get('smem', 0)} bytes static "
                f"smem, {e.get('stack')} bytes stack, spill stores/loads {e.get('spills')}")
    props = torch.cuda.get_device_properties(0)
    for name, arg in (("fused_step", ()), ("cnn_trunk", (50,))):
        fn = getattr(ctypes.CDLL(str(built[name].path)), f"{name}_smem_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int] * len(arg), ctypes.c_int
        smem = fn(*arg)
        log(f"  {name}: {smem} bytes of dynamic shared memory a block, "
            f"{props.multi_processor_count} persistent blocks at most")
    plan = getattr(ctypes.CDLL(str(built["conv2s"].path)), "conv2s_plan")
    plan.argtypes, plan.restype = [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int
    max_smem = getattr(props, "shared_memory_per_block_optin", 0) or 232_448
    for shape in ((L, 72, 50, 64), (L, 36, 64, 128), (L, 18, 128, 128)):
        v = (ctypes.c_int * 7)()
        if plan(*shape, props.multi_processor_count, max_smem, v) != 0:
            raise RuntimeError(f"conv2s has no plan for {shape}")
        log(f"  conv2s {shape[:3]} -> {shape[3]}: {v[5]} bytes of dynamic shared memory a block "
            f"(of {max_smem}), {v[1]} blocks of {v[2]} tiles of <= {v[4]} rows, {v[3]} slots a "
            f"warp group, W padded to {v[0]} columns, "
            f"{('loaded', 'resident by bulk copies', 'streamed')[v[6]]}")

    k4_smem = getattr(ctypes.CDLL(str(built["decode_attn"].path)), "decode_attn_smem_bytes")
    k4_smem.argtypes, k4_smem.restype = [ctypes.c_int] * 4, ctypes.c_int
    for what, B, S, H, KV, hd, _, _ in K4_SHAPES:
        for eb in (2, 4):
            p = ops.decode_plan(B, S, H, KV, hd, eb, props.multi_processor_count, max_smem)
            c_smem = k4_smem(hd, int(eb == 2), p.rt, p.stages)
            check(c_smem == p.smem_bytes, f"decode_attn {what} {('f32', 'bf16')[eb == 2]}: plan "
                  f"{p.splits} splits x {B * KV * p.row_groups} = {p.blocks} blocks of {p.threads} "
                  f"threads, {p.row_tiles} row tile(s), {p.stages} stages of {p.tile} positions, "
                  f"{p.smem_bytes} B of dynamic shared memory (the kernel's count: {c_smem}), "
                  f"{p.blocks_per_sm} blocks an SM")

    marks = [("[1]-[2] set-up and builds", time.perf_counter())]
    if only:
        return only_phases(torch, dev, smi, only, t_start)

    def mark(name):  # each phase's wall seconds, logged now and at the end
        marks.append((name, time.perf_counter()))
        log(f"[time] {name}: {marks[-1][1] - marks[-2][1]:.1f} s, {marks[-1][1] - t_start:.1f} s in all")

    pcfg, params, rows, x = kernel_phase(torch, dev)
    rows += conv_decode_kernel_phase(torch, dev, params, x)
    mark("[3] kernels")
    teacher_forced_phase(torch, dev)
    routes, launches, traces, arrays = predicted_phase(torch, dev, pcfg, params)
    ring = routes["ring+fused_step"][1]
    simnet_ms = 1e3 * ring["seconds"] / ring["n_steps"]  # [5]'s graph, a step
    mark("[4]-[5] teacher-forced and predicted packs")
    program_phase(torch, dev, routes, arrays, pcfg)
    launches["conv2s"] = conv2s_path_phase(torch, params, x)
    profile_phase(torch, dev, routes["ring+fused_step"][0], arrays)
    mark("[5b]-[6] programs, conv2s path, profile")
    del x, routes
    lm = lm_phase(torch, dev)
    launches["decode_attn"] = lm["launches"]
    want16 = {"first": lm["first"].cpu().tolist(), "stream0": lm["stream"][0].cpu().tolist(),
              "stream": lm["stream"].cpu().tolist(), "logits0": decode_exactness_phase(torch, dev, lm)}
    decode_count, decode_ms = count_decode_step(torch, lm), lm["ms_step"]  # for [17](b)
    mark("[7]-[8] gemma3-4b decode")
    del lm
    kinds_phase(torch, dev, arrays)
    mark("[9] predictor kinds")
    training_phase(torch, dev, traces, arrays)
    mark("[10] training")
    serving_phase(torch, dev, pcfg, params, arrays)
    mark("[11] serving")
    del traces
    want18 = families_phase(torch, dev)[SHARD_HYBRID_ARCH]  # [18](a)'s one-card tokens
    mark("[12] LM families")
    ops.reset_launches()
    k4_served, first_loss_13c = lm_train_phase(torch, dev, smi)
    log(f"[13] K4 launches serving the trained model: {k4_served}")
    mark("[13] LM training")
    mesh_phase(torch, dev, pcfg, params, arrays, ring, launches["fused_step"])
    mark("[14] lane mesh")
    started16 = start_follower(sharded_decode_follower)
    k4_sharded = sharded_train_phase(torch, dev, smi, first_loss_13c)
    log(f"[15] K4 launches decoding the two-rank model: {k4_sharded}")
    mark("[15] sharded LM training")
    started17 = start_dryrun()  # its child traces beside [16]
    k4_ranks = sharded_decode_phase(torch, dev, smi, want16, started16)
    log(f"[16] K4 launches a rank, (a): {k4_ranks}")
    k4_row = next(r for r in rows if r["name"] == "decode_attn")
    k4_row["shard"]["launches_a_rank"] = k4_ranks
    mark("[16] sharded LM decode")
    from repro_torch.runtime.roofline import PEAK_FLOPS, PEAK_FLOPS_F32

    started18 = start_follower(sharded_families_follower)  # waits through [17] and [18](c)
    dryrun_phase(started17)
    simnet_count = count_simnet_step(torch, dev, pcfg, params)
    roofline_share(f"SimNet c3 step at {L} lanes (f32 peak)", simnet_count, PEAK_FLOPS_F32,
                   simnet_ms, smi)
    roofline_share(f"{LM_ARCH} decode step at {LM_BATCH} requests (bf16 peak)", decode_count,
                   PEAK_FLOPS, decode_ms, smi)
    mark("[17] dry run and roofline")
    k4_hybrid = sharded_families_phase(torch, dev, smi, want18, started18)
    log(f"[18] K4 launches a rank, (a): {k4_hybrid}")
    k4_row["shard"]["hybrid_launches_a_rank"] = k4_hybrid
    mark("[18] every LM family sharded")
    log("phase wall seconds: " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks, marks[1:])))

    log(f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s ({smi})")

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ("shard",) if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
