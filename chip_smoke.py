#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's main paths — the ReCross sharded embedding server, and
DLRM forward and SGD training through the crossbar kernel with the
embedding-bag kernel as the naive datapath, at the full sizes of the
``dlrm-recross`` model; then int8-KV LM decode serving of ``chatglm3-6b``
FULL through the flash-decode attention kernel, LM training, the
moe, vlm and audio families (``granite-moe-3b-a800m`` FULL served through
the kernel), the recurrent ssm and hybrid families (``xlstm-125m`` and
``zamba2-7b`` FULL served, which launch none of the kernels), and the
distribution layer (the LM trained on a device mesh, the elastic
restart, GPipe pipelines; no kernel either), the multi-pod dry run and
the H100 roofline — and holds
every CUDA kernel of those paths against its plain PyTorch version on the
card.
Phases, in order; any failure propagates and the process exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: ``nvcc`` builds the kernels from ``src/repro_torch/kernels/csrc``;
3. kernel parity: the crossbar kernel against its plain version, flat and
   query-blocked, f32, bf16 and f16, dynamic switch on and off, q_block 1
   and 8, at small shapes; q_block 3 and 32 and a 64 KB bitmap (q_block 16,
   tile_rows 1024) at forced splits 1, 2 and 8 against the split version;
   integer-valued images at the serving shape, bit-identical to the plain
   and split versions, launch to launch and across the switch; at R=64,
   D=128, q=8 over a 100k-tile image, with kernel and plain times (CUDA
   events, median) and memory bounds; every row also carries the
   reference's MAC-only count (``reduction_flops``) as ``mac_flops``;
4. serving: ``ShardedEmbeddingServer(device="cuda")`` over 8 tables of
   932,019 rows (embed_dim 64 zero-padded to 128 columns, as the JAX
   DLRM kernel path pads), group_size 64, q_block 8, batch_size 256, one
   shard; histories from ``scale_trace``; ~4,096 queries through
   ``submit``/``flush``; sampled rows checked against a plain gather+sum
   on the card; the kernel's launches counted over this run;
   serving-async: the same tables and queries through a second server
   with 4 shards emulated on the card, ``flush_policy="owner-set"``
   (``owner_set_max=2``), the thread driver and two producer threads
   (even and odd positions); every drained row held against the serving
   phase's within ``TOL`` in the ``(local_seq, producer)`` merge order,
   sampled rows against gather+sum, one flush dispatched behind
   ``torch.cuda._sleep`` returning with its event pending; then
   integer-valued tables served under global, per-shard, deadline,
   owner-set and owner-set threaded with two producers, every drain
   bit-identical to gather+sum; serving-mesh: (a) the serving
   configuration through a world of 1 process on an NCCL data plane
   (``mesh=``), bit-identical to the serving phase's rows; (b) the
   serving-async configuration through 4 processes on the one card (this
   one rank 0, three spawned after the build) on a gloo data plane, each
   holding only its shard and running the crossbar kernel: rows against
   serving-async's within ``TOL`` and sampled against gather+sum,
   participant sizes 1, 2 and 4, queries/s, the combine's CUDA-event time
   a flush, combine and result bytes, then the integer-valued stream
   under the five setups, equal to the emulated card server's; the
   kernels line counts every rank's launches; serving-replan: the
   serving-async configuration with ``replan=`` (threshold 0.2, half-life 4, 64
   queries, 8 slack tiles) over 1,024 queries a table whose row ids
   rotate through a fixed permutation from half-way on; at least one
   patch must copy tiles, rows are held against the serving phase's and
   gather+sum, every patched and 4,096 sampled image slots against the
   host master image bit for bit, one dispatch plus its drift
   observation must return with its event pending; the patch's host
   gather, copy and scatter are timed beside a pinned copy of the same
   bytes; serving-tiers: the serving-replan configuration and stream
   with ``tiers=TierConfig(capacity_frac=0.25)``, a hot tier of a
   quarter of the uncapped image depth: queries must take both routes
   (the crossbar kernel and the host gather+sum over the master image),
   a barrier must fetch tiles and the depth stay at the capacity; rows
   are held against the serving phase's and gather+sum, fetched and
   sampled slots against the master image; the host flush's gather,
   sum and copy are timed; the integer-valued stream, drifted, under
   ``replan=`` and then under ``tiers=`` (half the uncapped depth) in
   the same five setups, each bit-identical to the port's CPU server
   with the same replans, patched tiles, host queries and fetched and
   evicted tiles (the tiered ones also to the uncapped server), plus a
   tiered run whose first two patch applies fail; chaos bits:
   ``tests/test_faults.py``'s threaded chaos replay (transient compile
   and device faults, a poisoned query, a hang past the watchdog) on the
   card, the hang raising ``FlushTimeout`` and a later drain returning
   every row, equal to the CPU server's rows, retries and quarantine;
   then a short hang that recovers with no timeout; analysis: the
   integer-valued and chaos runs go under ``RECROSS_VALIDATE=1``, the
   plans, patches and quiescent drains validated each counted (> 0 each);
   every FULL server (serving, serving-async, serving-mesh (a) and
   rank 0 of (b), serving-replan, serving-tiers) is validated with
   ``validate_server_state(quiesced=True)`` once its timed window has
   closed, its host seconds printed; the owner-set threaded
   two-producer integer-valued run goes under
   ``monitor_server(enforce=True)``, whose observed lock edges must run
   forward in the blessed order and lie in ``analyze_locks()``'s graph;
5. flat op: ``ops.crossbar_reduce`` on one table's compiled queries
   against ``reduce_dense_oracle`` on the card; then the quickstart,
   ``repro_torch.launch.quickstart.main(device="cuda")``, whose flat
   kernel launch is held against the dense oracle;
6. embedding-bag parity: the embedding-bag kernel against its plain
   version at small shapes (f32, bf16, f16, -1 padding) at the host
   rule's split and forced splits 1, 2 and 8 (against the split version),
   and at the main-path shape (932,019 x 128 table, 256 bags x 64): f32
   and bf16, forced splits, padding inside bags and out-of-range ids in
   every dtype, integer-valued tables bit-identical to the plain and
   split versions and a second launch at every split, int64 indices
   refused; forward and gradient; timed beside its bound, its plain
   version and ``F.embedding_bag`` at the main path (f32, bf16), an
   all-padding launch of the same grid, 4,096 bags, and a 65,024 x 4,096
   bf16 token-embedding gather of 2,048 single-id bags;
7. DLRM: ``dlrm-recross`` FULL (8 tables x 932,019 rows, embed_dim 64,
   bottom 512-256-64, top 1024-512-1) on the serving phase's layouts and
   tables, batch 256; at step 0 the naive datapath (``ops.embedding_bag``
   on the 128-wide tables), the ReCross one (``ops.crossbar_reduce`` on the
   images) and the dense path agree per table, the kernel path's logits
   equal the dense path's, and loss and every gradient equal autograd
   through the plain versions; then 20 SGD steps through
   ``launch.train_dlrm.train`` with finite losses;
   dlrm-dcnv2: MLPerf's DLRM-DCNv2 at ``configs.dlrm_dcnv2.one_card()``'s
   widths, bags and dense network (26 tables of 128 f32, rows capped at
   262,144, a 3-layer rank-512 cross network over 3,456 values), N(0, 1)
   tables: 8 requests of 64 samples through ``ShardedEmbeddingServer.serve``
   and ``dlrm_forward(..., "served")``, every logit within 1e-4 of the
   largest against ``recbench/dcnv2_reference.forward`` on the card
   (TF32 off); serve and the dense network timed on the host clock;
8. flash-decode parity: the kernel against its plain version at ten
   shapes, f32 and bf16, lengths 0, 1, S/3 + 7 and S (and 64, 65, 574 at
   the served shape, 15, 16, 31, 32 at lm-train's b 4, S 4,096; the
   lm-families shapes: granite-moe served (b 4, S 4,096, kvh 8, g 3, hd
   64, also 15, 16, 63, 64, 79, 80), musicgen (b 4, S 1,024, kvh 24, g 1,
   hd 64, also 15, 16, 31), grok-1 (kvh 8, g 6, hd 128) and command-r (g
   8) at b 2, S 1,024), each at forced split counts 1, 2, 7 and the host
   rule's; then timed (split kernel and merge together) at the served
   shape (b 8, S 4,096, length 574) and one ``decode_32k`` layer, beside
   its bound, one split, its plain version and SDPA;
9. LM: ``chatglm3-6b`` FULL decode with an int8 cache through the
   kernel: logits against the plain version and a bf16 cache, 16
   requests served, 28 launches a step, the kernel and SDPA at the served
   layer, a profiled window;
10. LM training: ``chatglm3-6b`` at its published widths cut to 4 of 28
   layers (bf16, AdamW), trained through ``launch.train.train``: 8 steps
   of 8 x 512 ``TokenBatcher`` tokens (steps 4-7 over 2 microbatches),
   then one step of 2 x 4,096 through ``chunked_self_attention``; checks:
   the smoke config's 3 steps on the card against the CPU, the chunked
   against the full attention at 4,096 tokens, the bf16 against the f32
   step-0 loss, a crash at step 6 restored from the step-4 checkpoint on
   disk and replayed bit for bit against an uninterrupted run (both with
   deterministic algorithms on; the timed steps run with them off, as
   ``launch.train`` does), and the restored weights served with an int8
   cache through the flash-decode kernel, their logits over 4 steps
   bit-equal to the in-memory weights' and within bf16 tolerance of the
   plain version's;
11. LM families: the smoke configs of ``granite-moe-3b-a800m``,
   ``grok-1-314b``, ``llama-3.2-vision-11b`` (cross-attention gates at
   0.5, seeded image embeddings), ``musicgen-medium``, ``minicpm-2b`` and
   ``command-r-35b`` in f32 on the card against the CPU within 1e-4
   (forward and ``lm_loss``, 3 decode steps over an int8 cache, one AdamW
   step; the moe layers' router top-k first, equal); ``granite-moe-3b-a800m``
   FULL (32 layers, 40 experts top-8, bf16) served through
   ``launch.serve.serve`` with an int8 cache of 4 slots x 4,096 (4
   requests of 16 + 16; logits over 4 steps within bf16 tolerance of the
   plain version's, 32 kernel launches a step, the kernel and SDPA at the
   served layer, one traced step); the same at 8 of 32 layers trained 4 AdamW
   steps of 8 x 512 tokens (steps 2-3 over 2 microbatches; aux loss,
   matmul FLOPs share, one traced step); ``llama-3.2-vision-11b`` at its
   widths and 5 of 40 layers (one superblock): one train step of 2 x 512
   and 8 decode steps with its bf16 cache; ``musicgen-medium`` FULL: 32
   decode steps at b 4 with an int8 cache of 1,024 (logits of every
   codebook within bf16 tolerance of the plain version's, 48 launches a
   step) and 2 train steps of 4 x 4 x 512;
12. LM recurrent: the smoke configs of ``xlstm-125m`` (sLSTM + mLSTM) and
   ``zamba2-7b`` (Mamba2 + the shared ring-window attention) in f32 on the
   card against the CPU within 1e-4 (forward and ``lm_loss`` at s 16,
   forward at the chunk thresholds: 256, the chunkwise mLSTM, and 4,096,
   the chunked windowed shared attention, there within ``REC_LONG_TOL``;
   3 decode steps; one AdamW step); decode against forward on the card at
   s 8 within 5e-4 / 5e-3; the zamba ring of 8 slots decoding 2·8+3 steps
   on the card and the CPU (finite, within 1e-4, its positions the last 8);
   ``xlstm-125m`` and ``zamba2-7b`` FULL served through
   ``launch.serve.serve`` (4 slots, ``max_seq`` 4,096 = zamba's ring, 4
   requests of 16 + 16; step p50/p99, tokens/s, TTFT, cache bytes, one
   traced step); ``xlstm-125m`` FULL and ``zamba2-7b`` at 7 of 81 layers
   (one superblock and a 1-layer tail) trained 4 AdamW steps of 8 x 512
   (steps 2-3 over 2 microbatches; matmul FLOPs share, peak memory, one
   traced step; the sLSTM's share of the xlstm step).  The phase launches
   none of the four kernels, and fails if it does;
13. LM mesh: the distribution layer (``dist.sharding``, ``launch.mesh``,
   ``launch.dryrun``'s specs, ``dist.pipeline_parallel``).  In a world of 1
   on NCCL, on ``make_host_mesh()``'s (1, 1) mesh: ``chatglm3-6b`` at its
   widths and 4 of 28 layers, parameters and AdamW state laid out by
   ``param_specs_for``/``opt_state_specs``, the batch by ``batch_specs``,
   3 AdamW steps of 8 x 512 inside ``activation_sharding_ctx`` against the
   same steps off the mesh, deterministic algorithms on in both: losses,
   grad norms and every weight bit-equal (on one rank DTensor runs the
   same local ops and its collectives are identities), and the steps
   must have moved weights; step p50 and one traced step's host operators
   on and off the mesh; ``granite-moe-3b-a800m`` at 8 of 32 layers, one
   AdamW step with ``moe_impl="shardmap"`` on the mesh against
   ``"gspmd"``, ``moe_groups=1`` off it, held the same way; the chatglm
   cut again, one step of 2 x 4,096 tokens (``chunked_self_attention`` on
   the scores' shards), and the ``xlstm-125m`` and ``zamba2-7b`` smoke
   configs (float32, 4 x 16; the scans on each rank's batch slice), one
   step each, held the same way; ``launch.elastic_restart.main`` (mesh A =
   mesh B = (1, 1), deterministic, its checkpoint under ``build/``, deleted
   after); ``pipelined_apply`` at one stage.  Then 4 gloo ranks on the one card (this process rank 0,
   three spawned): ``pipelined_apply`` at the reference example's S 4 x M 8
   x microbatch 16 x D 64 x 3 layers a stage, against the sequential
   product within 1e-6 (f32, TF32 off).  DTensor's collectives are not run
   over gloo on the card (its first all-gather of a CUDA tensor killed
   every rank, PERF.md §7); the sharded forward and restart on (2, 2) are
   proved in the CPU gloo worlds of the tests.  Each process group is
   destroyed before the next is made.  The phase launches none of the
   four kernels, and fails if it does;
14. dryrun: ``python -m repro_torch.launch.dryrun`` in a subprocess (ended
   at ``DRYRUN_TIMEOUT_S``) for ``chatglm3-6b`` ``decode_32k`` and
   ``dlrm-recross`` ``train_rec`` on ``pod16x16`` (a fake world of 256
   ranks, meta tensors: the card's torch runs the dry run; nothing runs
   on the card), each record printed, then ``python -m
   repro_torch.launch.report``'s roofline table; a non-zero exit fails;
15. roofline: ``RooflineReport`` with ``DEFAULT_H100`` at one chip for the
   measured lm-train step (``train_cost(remat=False)``) and the served
   decode step (``decode_cost`` with an int8 cache): each term, the
   dominant one, the measured p50 over ``bound_time_s``; and the smoke's
   own ``train_flop`` beside ``train_cost``'s FLOPs for every trained
   config.

The kernels are built in parallel (one ``nvcc`` per source).  It then
prints the host seconds of each phase, one ``{"kernels": [...]}`` line
(the flash-decode entry also carries its two served layers' time, bound
and SDPA time under ``served_layers``), the ``nvidia-smi`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.  It imports nothing of ``jax`` or ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

# the card's constants have one source: the port's H100 cost model (outside
# a checkout of the repository this import fails and the smoke exits non-zero)
from repro_torch.core.energy import DEFAULT_H100  # noqa: E402

H100_BYTES_PER_S = DEFAULT_H100.hbm_bandwidth
PEAK_FLOPS = {"float32": DEFAULT_H100.peak_flops_f32,   # CUDA cores, no tensor cores
              "bfloat16": DEFAULT_H100.peak_flops,      # dense tensor-core rate
              "float16": DEFAULT_H100.peak_flops}
# max abs error of a crossbar output against its plain version: f32 sums
# in another order; one rounding of a 16-bit output (an ulp is at most
# 0.125 below 256 in size, in bf16 below 32)
TOL = {"float32": 1e-4, "bfloat16": 0.15, "float16": 0.15}
XB_SPLITS = (1, 2, 8)                  # forced crossbar splits held against the split version
EB_SPLITS = (1, 2, 8)                  # forced embedding-bag splits held against the split version
EB_LARGE = 4_096                       # bags of the batched embedding-bag shape
ONEHOT = (65_024, 4_096, 2_048)        # chatglm3-6b vocabulary and width, bags of one id
SERVED_TILES = 132_129                 # the serving image's tiles (8 tables, group_size 64)

NUM_TABLES = 8                         # dlrm-recross FULL
ROWS = 932_019
EMBED_DIM = 64
PADDED_DIM = 128
GROUP_SIZE = 64
Q_BLOCK = 8
BATCH_SIZE = 256
HISTORY = 100_000
STREAM_PER_TABLE = 512                 # 8 x 512 = 4,096 served queries
REPLAN_PER_TABLE = 1_024               # serving-replan: 8 x 1,024 queries, the first 512 the same
DRIFT_SEED = 7                         # serving-replan: the hot-set rotation's permutation
# serving-replan: launch/serve_sharded.py's --drift defaults
REPLAN = {"threshold": 0.2, "half_life": 4.0, "min_queries": 64, "slack_tiles": 8}
BITS_EQ1_BATCH = 512                   # replan bits: Eq. 1 promotes at 4 shards
TIER_FRAC = 0.25                       # serving-tiers: launch/serve_sharded.py's --capacity-frac example
TIER_BITS_FRAC = 0.5                   # tier bits: the integer-valued tables' hot tier
CHAOS_ROWS = 160                       # chaos bits: tests/test_faults.py's tables
SAMPLE_SLOTS = 4_096                   # serving-replan: unpatched image slots held to the master
SAMPLE_ROWS = 256
ASYNC_SHARDS = 4                       # serving-async: shards emulated on the one card
BITS_ROWS = 4_096                      # serving-async: integer-valued tables
BITS_QUERIES = 1_024
BUSY_CYCLES = 200_000_000              # torch.cuda._sleep before one dispatch, ~0.1 s
# serving-mesh (b): 4 ranks on the one card; NCCL puts at most one rank on
# a card, and gloo takes CUDA tensors in every collective of the combine
# (its point-to-point result send goes through host memory)
MESH_BACKEND = "gloo"
MESH_COMBINE = "psum_scatter"
MESH_SERVERS = 1 + 5                   # the FULL run, then the five bits setups
MESH_TIMEOUT_S = 300.0
PLAN_BUDGET_S = 180.0
MAX_BAG = 64                           # dlrm-recross FULL
TRAIN_STEPS = 20
LR = 1e-2
# dlrm-dcnv2: one_card()'s widths, bags and dense network; rows capped so
# that its plan builds in seconds (the benchmark's cell serves the whole cut)
DCNV2_MAX_ROWS = 262_144
DCNV2_HISTORY = 2_048                  # bags a table for the plan
DCNV2_REQUESTS = 8                     # scored requests of DCNV2_BATCH samples
DCNV2_BATCH = 64
DCNV2_REL_TOL = 1e-4                   # tests/test_torch_dlrm_dcnv2.py's REL_TOL
DEVICE = "cuda"

LM_ARCH = "chatglm3-6b"                # FULL: 28 layers, d 4096, 32 q / 2 kv heads
LM_SLOTS = 8
LM_MAX_SEQ = 4096
LM_REQUESTS = 16
LM_PROMPT = 32
LM_NEW = 32
LM_PLAIN_STEPS = 4                     # kernel vs plain version, logits
LM_QUANT_STEPS = 8                     # int8 vs bf16 cache, logits
LM_QUANT_TOL = 0.05                    # tests/test_models_numerics.py:141
LM_PROFILE_STEPS = 4                   # decode steps traced with torch.profiler
DECODE_32K = (128, 32_768, 2, 16, 128)  # one decode_32k layer: b, S, kvh, g, hd
DA_TOL = {"m": 1e-5, "l": 1e-4, "out": 1e-4}  # tests/test_decode_kernel.py
DA_SPLITS = (1, 2, 7, None)            # forced split counts, then the host rule
LM_SERVED_LEN = 574                    # the cache length LM serving ends at
# lm-train: chatglm3-6b at its published widths, 4 of 28 layers (at 28
# the AdamW state alone, 6.24 B x 12 B, would nearly fill the 80 GB card)
LM_TRAIN_LAYERS = 4
LM_TRAIN_BATCH = (8, 512)              # steps 0-7: batch x tokens
LM_TRAIN_LONG = (2, 4_096)             # step 8: crosses CHUNKED_ATTN_THRESHOLD
LM_TRAIN_STEPS = 8
LM_TRAIN_MB_FROM = 4                   # steps 4-7 accumulate over 2 microbatches
LM_TRAIN_LR = 3e-4
LM_TRAIN_SAVE_EVERY = 4
LM_TRAIN_CRASH_AT = 6                  # injected failure: restore step 4, replay 4-7
LM_TRAIN_CPU_STEPS = 3                 # the smoke config on the card against the CPU
LM_TRAIN_LOSS_RTOL = 0.02              # bf16 against f32 step-0 loss
LM_TRAIN_SERVE = (4, 4_096, 4, 16, 16)  # slots, max_seq, requests, prompt, new
STEP_TOL = {"atol": 1e-4, "rtol": 1e-4}  # tests/test_torch_lm_decode.py
# lm-families: the moe, vlm and audio families and the two remaining dense configs
FAM_ARCHS = ("granite-moe-3b-a800m", "grok-1-314b", "llama-3.2-vision-11b",
             "musicgen-medium", "minicpm-2b", "command-r-35b")
FAM_GATE = 0.5                          # vlm cross-attention gates (zero at init)
FAM_CPU_DECODE_STEPS = 3
MOE_ARCH = "granite-moe-3b-a800m"       # FULL: 32 layers, d 1,536, 40 experts top-8
MOE_SERVE = (4, 4_096, 4, 16, 16)       # slots, max_seq, requests, prompt, new
MOE_TRAIN_LAYERS = 8                    # of 32
MOE_TRAIN_BATCH = (8, 512)
MOE_TRAIN_STEPS = 4
MOE_TRAIN_MB_FROM = 2                   # steps 2-3 over 2 microbatches
VLM_ARCH = "llama-3.2-vision-11b"       # d 4,096, 1,601 image tokens
VLM_LAYERS = 5                          # of 40: one superblock of 4 self + 1 cross
VLM_TRAIN_BATCH = (2, 512)
VLM_DECODE = (2, 64, 8)                 # slots, max_seq, steps (bf16 cache)
AUDIO_ARCH = "musicgen-medium"          # FULL: 48 layers, d 1,536, 4 codebooks
AUDIO_DECODE = (4, 1_024, 32)           # slots, max_seq, steps (int8 cache)
AUDIO_TRAIN_BATCH = (4, 512)            # x 4 codebooks
AUDIO_TRAIN_STEPS = 2
BF16_TOL = {"atol": 0.15, "rtol": 1e-2}  # tests/test_kernels.py:34
# lm-recurrent: the ssm (xlstm) and hybrid (zamba2) families
REC_ARCHS = ("xlstm-125m", "zamba2-7b")
REC_LONG = {"xlstm-125m": 256, "zamba2-7b": 4_096}  # the chunk thresholds: chunked mLSTM,
                                                  # chunked windowed shared attention
# zamba at 4,096 tokens: the SSD chunk form's float32 error against the
# exact recurrence is ~1.7e-5 a Mamba2 layer on either side, and the
# summation orders differ (tests/test_torch_lm_recurrent.py)
REC_LONG_TOL = {"atol": 1e-3, "rtol": 1e-4}
REC_CPU_DECODE_STEPS = 3
REC_DECODE_TOL = {"atol": 5e-4, "rtol": 5e-3}   # tests/test_archs_smoke.py:113
REC_DECODE_S = 8                        # decode against forward, on the card
REC_RING_W = 8                          # tests/test_serve.py:31: 2·8+3 steps past the ring
REC_SERVE = (4, 4_096, 4, 16, 16)       # slots, max_seq (the ring's W), requests, prompt, new
REC_TRAIN_BATCH = (8, 512)
REC_TRAIN_STEPS = 4
REC_TRAIN_MB_FROM = 2                   # steps 2-3 over 2 microbatches
ZAMBA_TRAIN_LAYERS = 7                  # of 81: one superblock of 6 and a 1-layer tail

# lm-mesh: the distribution layer on the card
MESH_LM_STEPS = 3                       # AdamW steps of chatglm3-6b at LM_TRAIN_LAYERS on (1, 1)
MESH_LM_BATCH = (8, 512)
MESH_LM_LR = 3e-4
# S, M, microbatch, D, layers a stage: examples/pipeline_parallel.py:19
MESH_REC_BATCH = (4, 16)                # the recurrent smoke configs' step on (1, 1)
MESH_PIPE = (4, 8, 16, 64, 3)
MESH_PIPE_ATOL = 1e-6                   # float32, TF32 off
MESH_WORLD = 4                          # gloo ranks on the one card
MESH_GLOO_TIMEOUT_S = 120.0             # a rank that never joins or answers fails the phase
# dryrun: cells of python -m repro_torch.launch.dryrun on the 256-rank fake
# world (arch, shape; None: the DLRM cell), each subprocess's time limit
DRYRUN_CELLS = (("chatglm3-6b", "decode_32k"), ("dlrm-recross", None))
DRYRUN_TIMEOUT_S = 120.0


def log(*parts) -> None:
    print(*parts, flush=True)


def ptxas_summary(build_log: str) -> list[str]:
    """One line a kernel instance from ``nvcc -Xptxas=-v``: its (mangled)
    name with the registers, spill stores and spill loads ptxas reported."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers; {spill}")
            name, spill = None, ""
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of a callable.  Before each timed call a
    1 GiB buffer is zeroed: it evicts the 50 MB L2 (the serving path
    finds its tiles cold) and keeps the card busy for ~0.3 ms while the
    host enqueues the call, so the events time the device work, not the
    host's launch overhead (the plain versions launch several kernels)."""

    def __init__(self, torch):
        self.torch = torch
        self.scrub = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=DEVICE)

    def ms(self, fn, reps: int = 15) -> float:
        torch = self.torch
        fn()  # warm-up
        times = []
        for _ in range(reps):
            self.scrub.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def work_of(torch, image, tile_ids, bitmaps):
    """Least bytes and operations of one crossbar reduction on these inputs:
    each distinct referenced tile read once, tile ids and bitmaps read once,
    the output written once; one multiply-add per active bitmap entry and
    column."""
    esize = image.element_size()
    tile_bytes = image.shape[1] * image.shape[2] * esize
    valid = tile_ids[tile_ids >= 0]
    q_block = bitmaps.shape[2] if bitmaps.ndim == 4 else 1
    out_bytes = tile_ids.shape[0] * q_block * image.shape[2] * esize
    nbytes = (
        int(torch.unique(valid).numel()) * tile_bytes
        + tile_ids.numel() * 4 + bitmaps.numel() * esize + out_bytes
    )
    flops = 2 * int((bitmaps != 0).sum().item()) * image.shape[2]
    return nbytes, flops, int(valid.numel()) * tile_bytes


def bound(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def validate_full(server, tag: str) -> float:
    """``validate_server_state(quiesced=True)`` on a drained FULL server,
    after its timed window has closed; returns the host seconds."""
    from repro_torch.analysis.invariants import validate_server_state

    t0 = time.perf_counter()
    validate_server_state(server, quiesced=True)
    sec = time.perf_counter() - t0
    log(f"analysis: {tag} FULL server validated in {sec:.4f} s")
    return sec


@contextlib.contextmanager
def validated(counts: dict):
    """``RECROSS_VALIDATE=1`` around untimed correctness runs, restored
    after; counts in ``counts`` each validated plan (a fresh one, or a
    patch's applied plan), patch and quiescent drain.  The plan a
    server's validation checks counts with its drain."""
    import threading

    from repro_torch.analysis import invariants

    lock, inside = threading.Lock(), threading.local()
    plan_fn, patch_fn = invariants.validate_plan, invariants.validate_patch
    state_fn = invariants.validate_server_state

    def count(key):
        with lock:
            counts[key] += 1

    def plan(p):
        if not getattr(inside, "state", False):
            count("plans")
        return plan_fn(p)

    def patch(p, pt):
        count("patches")
        return patch_fn(p, pt)

    def state(server, *, quiesced=False):
        count("drains")
        inside.state = True
        try:
            return state_fn(server, quiesced=quiesced)
        finally:
            inside.state = False

    prev = os.environ.get("RECROSS_VALIDATE")
    os.environ["RECROSS_VALIDATE"] = "1"
    try:
        with mock.patch.object(invariants, "validate_plan", plan), \
                mock.patch.object(invariants, "validate_patch", patch), \
                mock.patch.object(invariants, "validate_server_state", state):
            yield counts
    finally:
        if prev is None:
            del os.environ["RECROSS_VALIDATE"]
        else:
            os.environ["RECROSS_VALIDATE"] = prev


def crossbar_as_embedding_bag(torch, image, tile_ids, bitmaps):
    """The one PyTorch call that computes a crossbar reduction:
    ``F.embedding_bag(mode="sum", per_sample_weights=bitmaps)`` over the
    flattened ``(tiles·rows, d)`` image, one bag a (block, lane) of every
    slot's ``tile_id·tile_rows + r`` (padding slots read row 0 at weight
    0).  Returns the call (its indices and weights made here, outside any
    timed window) and its first result."""
    import torch.nn.functional as F

    T, R, D = image.shape
    flat = image.reshape(T * R, D)
    ids = tile_ids.long().clamp_min(0)
    rows = ids[..., None] * R + torch.arange(R, device=image.device)      # (nb, S, R)
    w = bitmaps * (tile_ids >= 0).to(bitmaps.dtype)[(...,) + (None,) * (bitmaps.ndim - 2)]
    if bitmaps.ndim == 4:                                                 # (nb, S, q, R)
        nb, S, q, _ = bitmaps.shape
        idx = rows[:, None].expand(nb, q, S, R).reshape(nb * q, S * R).contiguous()
        w = w.permute(0, 2, 1, 3).reshape(nb * q, S * R).contiguous()
    else:
        idx, w = rows.reshape(rows.shape[0], -1), w.reshape(w.shape[0], -1).contiguous()

    def call():
        return F.embedding_bag(idx, flat, mode="sum", per_sample_weights=w)

    return call, call()


def parity(torch, timer, name, image, tile_ids, bitmaps, *, dynamic_switch=True,
           timed=True, n_split=None, exact=False, library=False) -> dict:
    """Kernel vs plain version on the card; raises past the tolerance.

    A forced ``n_split`` holds the kernel against the split version
    (``crossbar_reduce_split_ref``), which adds the splits' partials in the
    kernel's order.  ``exact`` (integer-valued images) asks for the same
    bits as the plain version, as a second launch and as the other side of
    the dynamic switch.  ``library`` also times ``F.embedding_bag`` on the
    same inputs (:func:`crossbar_as_embedding_bag`), held to the plain
    version within the same tolerance.  ``mac_flops`` is the reference's
    count (``reduction_flops``: MAC tiles only) beside ``flops``, the
    nonzero products the bound is taken on."""
    from repro_torch.core.reduction import reduction_flops
    from repro_torch.kernels import ref
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda

    if n_split is None:
        plain = ref.crossbar_reduce_blocked_ref if bitmaps.ndim == 4 else ref.crossbar_reduce_ref
    else:
        def plain(image, tile_ids, bitmaps):
            return ref.crossbar_reduce_split_ref(image, tile_ids, bitmaps, n_split)

    def kernel(switch=dynamic_switch):
        return crossbar_reduce_cuda(image, tile_ids, bitmaps, dynamic_switch=switch,
                                    n_split=n_split)

    out = kernel()
    torch.cuda.synchronize()
    want = plain(image, tile_ids, bitmaps)
    dtype = str(image.dtype).removeprefix("torch.")
    err = float((out.float() - want.float()).abs().max().item()) if out.numel() else 0.0
    if not (out.shape == want.shape and out.dtype == image.dtype and err <= TOL[dtype]):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: shape "
            f"{tuple(out.shape)} vs {tuple(want.shape)}, max_abs_err {err} "
            f"> {TOL[dtype]}"
        )
    if exact and not (torch.equal(out, want) and torch.equal(out, kernel())
                      and torch.equal(out, kernel(not dynamic_switch))):
        raise AssertionError(f"{name}: an integer-valued case is not bit-identical "
                             f"(plain, second launch, switch flipped)")
    nbytes, flops, slot_bytes = work_of(torch, image, tile_ids, bitmaps)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    row = {"case": name, "dtype": dtype, "switch": dynamic_switch,
           "n_split": n_split, "exact": exact,
           "shape": [list(image.shape), list(bitmaps.shape)],
           "max_abs_err": err, "tol": TOL[dtype], "bytes": nbytes,
           "slot_bytes": slot_bytes, "flops": flops,
           "mac_flops": reduction_flops(bitmaps, image.shape[2], dynamic_switch),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if timed:
        row["ms"] = timer.ms(lambda: crossbar_reduce_cuda(
            image, tile_ids, bitmaps, dynamic_switch=dynamic_switch))
        row["plain_ms"] = timer.ms(lambda: plain(image, tile_ids, bitmaps), reps=10)
        row["GB_per_s"] = nbytes / row["ms"] / 1e6
    if library:
        call, lib_out = crossbar_as_embedding_bag(torch, image, tile_ids, bitmaps)
        row["library_err"] = float((lib_out.float() - want.reshape(lib_out.shape).float())
                                   .abs().max().item())
        if row["library_err"] > TOL[dtype]:
            raise AssertionError(f"{name}: F.embedding_bag disagrees with the plain version: "
                                 f"{row['library_err']}")
        row["library_ms"] = timer.ms(call)
        del call, lib_out
    log("parity", json.dumps(row))
    return row


def synthetic_case(torch, gen, T, R, D, nb, S, q_block, dtype, density=0.04,
                   integer=False):
    """Random image, schedules with padding slots, READ-path slots (one
    active entry) and empty slots; ``q_block=None`` gives flat bitmaps.
    ``integer`` draws the image from -8..8, so every f32 partial sum is exact."""
    if integer:
        image = torch.randint(-8, 9, (T, R, D), generator=gen, device=DEVICE).to(dtype)
    else:
        image = torch.randn((T, R, D), generator=gen, device=DEVICE).to(dtype)
    ids = torch.randint(0, T, (nb, S), generator=gen, device=DEVICE, dtype=torch.int32)
    ids[:, S - max(1, S // 8):] = -1
    lanes = (nb, S, R) if q_block is None else (nb, S, q_block, R)
    bm = (torch.rand(lanes, generator=gen, device=DEVICE) < density).to(dtype)
    bm[ids < 0] = 0
    flat = bm.reshape(nb, S, -1)
    flat[:, 0] = 0
    flat[:, 0, 5] = 1       # READ path: exactly one active entry
    flat[:, 1] = 0          # activated but empty
    return image, ids, bm


def phase_parity(torch, timer) -> None:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for q in (None, 1, 8):
            for sw in (True, False):
                name = f"small/{'flat' if q is None else f'q{q}'}"
                case = synthetic_case(torch, gen, 512, 64, 256, 48, 24, q, dtype)
                parity(torch, timer, name, *case, dynamic_switch=sw, timed=False)
        # the reference's whole contract: q_block outside 1..16 and not a
        # power of two, a 64 KB bitmap (q 16 x 1024 rows), at forced splits
        for q, R in ((3, 64), (32, 64), (16, 1024)):
            case = synthetic_case(torch, gen, 512, R, 128, 16, 48, q, dtype)
            for n_split in XB_SPLITS:
                for sw in (True, False):
                    parity(torch, timer, f"contract/q{q}-r{R}", *case,
                           dynamic_switch=sw, timed=False, n_split=n_split)
    # an integer-valued image at the serving shape: the same bits as the
    # plain version, launch to launch, switch on and off, at every split
    for q in (8, 3, 32):
        case = synthetic_case(torch, gen, SERVED_TILES, 64, 128, 16, 48, q, torch.float32,
                              integer=True)
        for n_split in (None, *XB_SPLITS):
            for sw in (True, False):
                parity(torch, timer, f"exact/q{q}", *case, dynamic_switch=sw,
                       timed=False, n_split=n_split, exact=True)
        del case
    for dtype in (torch.float32, torch.bfloat16):
        # the main-path shape: R=64, D=128, q=8 over a 100k-tile image
        case = synthetic_case(torch, gen, 100_000, 64, 128, 64, 128, 8, dtype)
        for sw in (True, False):
            parity(torch, timer, "100k/q8", *case, dynamic_switch=sw)
        case = synthetic_case(torch, gen, 100_000, 64, 128, 256, 32, None, dtype)
        parity(torch, timer, "100k/flat", *case)
        del case
    torch.cuda.empty_cache()


def phase_serving(torch, np, timer):
    from repro_torch.convert import tables_from_numpy
    from repro_torch.core import (
        build_cooccurrence, compile_queries, concat_compiled_queries,
        correlation_aware_grouping, offset_compiled_queries,
        reduce_dense_oracle, shard_block_queries,
    )
    from repro_torch.data import scale_trace
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import ShardedEmbeddingServer

    # probe one table's plan build; cut the table count (never a width)
    # if all eight would not fit the plan budget
    t0 = time.perf_counter()
    trace0 = scale_trace(ROWS, HISTORY + REPLAN_PER_TABLE, 32.0, seed=0)
    correlation_aware_grouping(build_cooccurrence(trace0[:HISTORY], ROWS), GROUP_SIZE)
    per_table_s = time.perf_counter() - t0
    num_tables = NUM_TABLES
    if per_table_s * NUM_TABLES > PLAN_BUDGET_S:
        num_tables = max(1, int(PLAN_BUDGET_S // per_table_s))
        log(f"serving: CUT num_tables {NUM_TABLES} -> {num_tables} "
            f"(one table's plan took {per_table_s:.1f} s)")
    log(f"serving: one-table plan probe {per_table_s:.2f} s")

    rng = np.random.default_rng(1234)
    names = [f"t{t}" for t in range(num_tables)]
    host_tables, histories, streams, long_streams = {}, {}, {}, {}
    for t, name in enumerate(names):
        table = np.zeros((ROWS, PADDED_DIM), dtype=np.float32)
        table[:, :EMBED_DIM] = rng.standard_normal((ROWS, EMBED_DIM), dtype=np.float32)
        host_tables[name] = table
        trace = trace0 if t == 0 else scale_trace(
            ROWS, HISTORY + REPLAN_PER_TABLE, 32.0, seed=t)
        # the trace's queries are drawn in order, so its first
        # HISTORY + 512 are those of a trace of that length
        histories[name], long_streams[name] = trace[:HISTORY], trace[HISTORY:]
        streams[name] = long_streams[name][:STREAM_PER_TABLE]
    del trace0
    tables = tables_from_numpy(host_tables, DEVICE)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = ShardedEmbeddingServer(
        tables, histories, num_shards=1, q_block=Q_BLOCK, group_size=GROUP_SIZE,
        batch_size=BATCH_SIZE, device=DEVICE,
    )
    plan_s = time.perf_counter() - t0
    image_bytes = server.shard_images.numel() * server.shard_images.element_size()
    log(f"serving: plan build {plan_s:.2f} s for {num_tables} tables x {ROWS} rows, "
        f"image {tuple(server.shard_images.shape)} = {image_bytes} B on the card")

    order = [(names[i % num_tables], streams[names[i % num_tables]][i // num_tables])
             for i in range(num_tables * STREAM_PER_TABLE)]
    served = {n: [] for n in names}
    results = {n: [] for n in names}
    crossbar_reduce_cuda.launches = 0
    t0 = time.perf_counter()
    for name, q in order:
        served[name].append(q)
        for n, rows_out in server.submit(name, q).items():
            results[n].append(rows_out)
    for n, rows_out in server.flush().items():
        results[n].append(rows_out)
    wall = time.perf_counter() - t0
    launches = crossbar_reduce_cuda.launches
    validate_s = validate_full(server, "serving")
    server.close()
    rep = server.report()["serve"]
    if launches <= 0:
        raise AssertionError("serving ran no crossbar kernel launch")

    out = {n: torch.cat(results[n]) for n in names}
    for n in names:
        if out[n].shape != (len(served[n]), PADDED_DIM) or not torch.isfinite(out[n]).all():
            raise AssertionError(f"table {n}: bad output {tuple(out[n].shape)}")
    pick = np.random.default_rng(7).choice(len(order), size=SAMPLE_ROWS, replace=False)
    seen = {n: 0 for n in names}
    index = []
    for name, _ in order:
        index.append((name, seen[name]))
        seen[name] += 1
    err = 0.0
    for i in pick.tolist():
        name, k = index[i]
        want = reduce_dense_oracle(tables[name], [served[name][k]])[0]
        err = max(err, float((out[name][k] - want).abs().max().item()))
    if err > TOL["float32"]:
        raise AssertionError(f"served rows disagree with gather+sum: {err}")

    flushes = rep["batches"]
    stats = {
        "tables": num_tables, "rows": ROWS, "dim": PADDED_DIM,
        "plan_build_s": plan_s, "image_bytes": image_bytes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "queries": rep["queries"], "flushes": flushes, "wall_s": wall,
        "queries_per_s": rep["queries"] / wall,
        "flush_p50_ms": float(np.percentile(server.stats.flush_wall, 50)) * 1e3,
        "flush_p99_ms": float(np.percentile(server.stats.flush_wall, 99)) * 1e3,
        "host_compile_s": rep["host_compile_s"],
        "kernel_launches": launches, "launches_per_flush": launches / flushes,
        "max_shard_width": rep["max_shard_width"],
        "sampled_rows": SAMPLE_ROWS, "sample_max_abs_err": err, "validate_s": validate_s,
    }
    log("serving", json.dumps(stats))

    # one real flush, replayed kernel-by-kernel as the server launches it
    # (chunk 0 of combine_chunks=2), for the kernel's main-path time
    batch = order[:BATCH_SIZE]
    cqs = []
    for name in names:
        qs = [q for n, q in batch if n == name]
        i = server.names.index(name)
        cqs.append(offset_compiled_queries(
            compile_queries(server.layouts[i], qs, replica_block=Q_BLOCK, device="cpu"),
            server.plan.tables[i].tile_offset))
    fused, _ = concat_compiled_queries(cqs, Q_BLOCK)
    sbq = shard_block_queries(fused, server.plan, Q_BLOCK, device=DEVICE)
    half = -(-sbq.num_blocks // 2)
    real = parity(torch, timer, "serving-flush/q8", server.shard_images[0],
                  sbq.tile_ids[0, :half].contiguous(), sbq.bitmaps[0, :half].contiguous(),
                  library=True)
    return stats, real, server, tables, streams, histories, {
        "order": order, "out": out, "long_streams": long_streams}


def _submit_from_producers(server, slices) -> None:
    """Submits each producer's ``[(table, query), ...]`` from its own
    thread, all released together; re-raises the first failure."""
    import threading

    gate = threading.Barrier(len(slices) + 1, timeout=600)
    errors = []

    def run(label):
        try:
            gate.wait()
            for name, q in slices[label]:
                server.submit(name, q, producer=label)
        except Exception as e:  # re-raised on the caller's thread below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(label,), name=label, daemon=True)
               for label in slices]
    for t in threads:
        t.start()
    gate.wait()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError(f"producer {t.name} did not finish")
    if errors:
        raise errors[0]


def phase_serving_async(torch, np, tables, histories, streams, served) -> dict:
    """The async engine at dlrm-recross FULL width: 4 shards emulated on
    the card, owner-set homes of at most 2 owners, the thread driver, two
    producers submitting the even and odd positions of the serving
    phase's stream; rows held against the serving phase's (the shard
    combine reorders sums) and sampled against gather+sum."""
    from repro_torch.core import reduce_dense_oracle
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import ShardedEmbeddingServer

    names = sorted(tables)
    order, rows_global = served["order"], served["out"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = ShardedEmbeddingServer(
        tables, histories, num_shards=ASYNC_SHARDS, q_block=Q_BLOCK,
        group_size=GROUP_SIZE, batch_size=BATCH_SIZE, flush_policy="owner-set",
        owner_set_max=2, threaded=True, max_in_flight=2, device=DEVICE,
    )
    plan_s = time.perf_counter() - t0
    image = server.shard_images
    image_bytes = image.numel() * image.element_size()
    log(f"serving-async: plan build {plan_s:.2f} s for {len(names)} tables x {ROWS} rows, "
        f"{ASYNC_SHARDS} shards, image {tuple(image.shape)} = {image_bytes} B on the card")

    # whether each flush's kernels were still running when its dispatch
    # returned (busy_stream_dispatch below holds the no-wait property
    # itself; here the count also depends on the threads' timing)
    dispatched = {"flushes": 0, "pending": 0}
    dispatch = server._compile_and_dispatch

    def counted(entries, participants):
        entry = dispatch(entries, participants)
        dispatched["flushes"] += 1
        dispatched["pending"] += int(entry.event is not None and not entry.event.query())
        return entry

    server._compile_and_dispatch = counted
    # where the stream routes (a peek: route() consumes no state)
    routed = {"single": 0, "owner_set": 0, "pool": 0}
    for name, q in order:
        home = server.scheduler.route(name, q)[0]
        routed["pool" if home == -1 else "owner_set" if isinstance(home, tuple)
               else "single"] += 1
    labels = ("p0", "p1")
    for label in labels:
        server.register_producer(label)
    slices = {label: [order[i] for i in range(p, len(order), 2)]
              for p, label in enumerate(labels)}
    crossbar_reduce_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        _submit_from_producers(server, slices)
        out = server.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = crossbar_reduce_cuda.launches
        validate_s = validate_full(server, "serving-async")
        # read before busy_stream_dispatch adds a compile outside the wall
        rep = server.report()
        busy = busy_stream_dispatch(torch, server, dispatch, order, rows_global)
    finally:
        server.close()
        # the counting wrapper closes a cycle through the server; break it
        # so the server's 4.6 GB image is freed when this phase returns
        del server._compile_and_dispatch
    if launches <= 0:
        raise AssertionError("serving-async ran no crossbar kernel launch")

    # the merge order (local_seq, pid) implies, as positions in each
    # table's serving-phase rows
    merged = merge_positions(order, names)
    err = 0.0
    for n in names:
        got = out.get(n)
        if got is None or got.shape != (len(merged[n]), PADDED_DIM) or not torch.isfinite(got).all():
            raise AssertionError(f"serving-async table {n}: bad output "
                                 f"{None if got is None else tuple(got.shape)}")
        want = rows_global[n][torch.tensor(merged[n], device=DEVICE)]
        err = max(err, float((got - want).abs().max().item()))
    if err > TOL["float32"]:
        raise AssertionError(f"serving-async rows disagree with the global phase's: {err}")
    pick = np.random.default_rng(11).choice(len(order), size=SAMPLE_ROWS, replace=False)
    flat = [(n, j) for n in names for j in range(len(merged[n]))]
    oracle_err = 0.0
    for i in pick.tolist():
        n, j = flat[i]
        # the k-th query of a table in the serving phase is streams[n][k]
        want = reduce_dense_oracle(tables[n], [streams[n][merged[n][j]]])[0]
        oracle_err = max(oracle_err, float((out[n][j] - want).abs().max().item()))
    if oracle_err > TOL["float32"]:
        raise AssertionError(f"serving-async rows disagree with gather+sum: {oracle_err}")

    s = rep["serve"]
    pct = {k: {p: s[k][p] for p in ("p50", "p99")}
           for k in ("submit_latency_s", "e2e_latency_s", "flush_latency_s")}
    stats = {
        "tables": len(names), "rows": ROWS, "dim": PADDED_DIM, "shards": ASYNC_SHARDS,
        "policy": "owner-set", "owner_set_max": 2, "threaded": True, "producers": 2,
        "plan_build_s": plan_s, "image_shape": list(image.shape), "image_bytes": image_bytes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "queries": s["queries"], "wall_s": wall, "queries_per_s": s["queries"] / wall,
        **pct,
        "host_compile_s": s["host_compile_s"], "hidden_compile_s": s["hidden_compile_s"],
        "overlap_fraction": s["overlap_fraction"], "in_flight_peak": s["in_flight_peak"],
        "batches": s["batches"], "shard_flushes": s["shard_flushes"],
        "participant_sizes": s["participant_sizes"], "combine_bytes": s["combine_bytes"],
        "deadline_flushes": s["deadline_flushes"], "barrier_flushes": s["barrier_flushes"],
        "kernel_launches": launches, "routed_queries": routed,
        "dispatches": dispatched["flushes"], "pending_at_dispatch_return": dispatched["pending"],
        "busy_stream_dispatch": busy,
        "max_abs_err_vs_global": err, "sampled_rows": SAMPLE_ROWS,
        "sample_max_abs_err": oracle_err, "faults": s["faults"], "validate_s": validate_s,
    }
    log("serving-async", json.dumps(stats))
    return stats, out


def _mesh_worker(rank, init_method, results) -> None:
    """A worker rank of ``phase_serving_mesh`` (b): joins the 4-rank world on
    the one card and runs ``serve_worker`` once per mesh server of the
    phase, counting its crossbar launches in each; reports them, or its
    traceback, to the parent.  The kernels are already built."""
    import traceback

    sys.path.insert(0, str(SRC))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.dist.mesh import init_shard_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve.sharded import serve_worker

    mesh = None
    try:
        _build.load_crossbar()
        mesh = init_shard_mesh(ASYNC_SHARDS, rank=rank, world_size=ASYNC_SHARDS,
                               device=DEVICE, backend=MESH_BACKEND,
                               init_method=init_method, timeout_s=MESH_TIMEOUT_S)
        launches = []
        for _ in range(MESH_SERVERS):
            crossbar_reduce_cuda.launches = 0
            served = serve_worker(mesh)
            launches.append({"launches": crossbar_reduce_cuda.launches, **served})
        results.put((rank, launches, None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if mesh is not None:
            mesh.close()


def _serve_in_order(torch, server, order, names) -> dict:
    """``order`` through ``submit`` and one ``flush``; ``{table: rows}``."""
    parts = {n: [] for n in names}
    for name, q in order:
        for n, rows in server.submit(name, q).items():
            parts[n].append(rows)
    for n, rows in server.flush().items():
        parts[n].append(rows)
    return {n: torch.cat(parts[n]) for n in names}


def phase_serving_mesh(torch, np, tables, histories, streams, served, async_stats,
                       async_rows) -> dict:
    """The sharded server with one process per shard (``mesh=``).

    (a) A world of 1 on an NCCL data plane, in this process: dlrm-recross
    FULL, 1 shard, ``global``; its rows must equal the serving phase's bit
    for bit (the NCCL init, the control plane and the single-participant
    branch on the card).

    (b) A world of 4 ranks on the one card (NCCL puts at most one rank on
    a card) with a gloo data plane: this process is rank 0 and spawns
    ranks 1-3 once the kernels are built.  The serving-async
    configuration (FULL, 4 shards, owner-set homes of at most 2 owners,
    the thread driver, two producers, the first 4,096 queries): rows
    against serving-async's within ``TOL`` (the collectives sum in another
    order) and sampled against gather+sum; participant sizes 1, 2 and 4;
    queries/s, the combine's CUDA-event time per flush, combine and
    result bytes.  Then the integer-valued bits stream under the five
    setups, each drain bit-identical to the emulated card server's and
    to gather+sum.  Each rank holds only its own shard of the image."""
    import multiprocessing as mp
    import tempfile

    from repro_torch.dist.mesh import init_shard_mesh
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import ShardedEmbeddingServer

    names = sorted(tables)
    order = served["order"]
    kw = {"q_block": Q_BLOCK, "group_size": GROUP_SIZE, "batch_size": BATCH_SIZE,
          "device": DEVICE}
    stats = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # ---- (a) world 1, NCCL ----
        mesh = init_shard_mesh(1, rank=0, world_size=1, device=DEVICE, backend="nccl",
                               init_method=f"file://{tmp}/world1",
                               timeout_s=MESH_TIMEOUT_S)
        try:
            t0 = time.perf_counter()
            server = ShardedEmbeddingServer(tables, histories, num_shards=1, mesh=mesh, **kw)
            plan_s = time.perf_counter() - t0
            crossbar_reduce_cuda.launches = 0
            t0 = time.perf_counter()
            out = _serve_in_order(torch, server, order, names)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches_a = crossbar_reduce_cuda.launches
            validate_a = validate_full(server, "serving-mesh (a)")
            server.close()
            rep = server.report()
        finally:
            mesh.close()
        del server
        for n in names:
            if not torch.equal(out[n], served["out"][n]):
                bad = float((out[n] - served["out"][n]).abs().max().item())
                raise AssertionError(f"serving-mesh (a): table {n} is not bit-identical to "
                                     f"the serving phase's (max_abs_err {bad})")
        s = rep["serve"]
        if rep["mode"] != "shard_map" or set(s["participant_sizes"]) != {"1"} or launches_a <= 0:
            raise AssertionError(f"serving-mesh (a): mode {rep['mode']}, participant sizes "
                                 f"{s['participant_sizes']}, {launches_a} launches")
        stats["a"] = {"world": 1, "backend": "nccl", "plan_build_s": plan_s,
                      "queries": s["queries"], "wall_s": wall,
                      "queries_per_s": s["queries"] / wall, "kernel_launches": launches_a,
                      "combine_bytes": s["combine_bytes"],
                      "result_bytes": rep["mesh"]["result_bytes"], "bit_identical": True,
                      "validate_s": validate_a}
        log("serving-mesh (a)", json.dumps(stats["a"]))
        del out
        torch.cuda.empty_cache()

        # ---- (b) world 4 on the one card, gloo ----
        init = f"file://{tmp}/world4"
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        workers = [ctx.Process(target=_mesh_worker, args=(r, init, results), daemon=True)
                   for r in range(1, ASYNC_SHARDS)]
        for w in workers:
            w.start()
        try:
            stats["b"] = _mesh_world4(torch, np, tables, histories, streams, order,
                                      async_stats, async_rows, init, results)
            for w in workers:
                w.join(timeout=120)
        finally:
            for w in workers:
                if w.is_alive():
                    w.kill()
                    w.join()
        failed = [w.exitcode for w in workers if w.exitcode != 0]
        if failed:
            raise AssertionError(f"serving-mesh (b): worker exit codes {failed}")
    stats["kernel_launches"] = stats["a"]["kernel_launches"] + stats["b"]["kernel_launches"]
    return stats


def _mesh_world4(torch, np, tables, histories, streams, order, async_stats, async_rows,
                 init, results) -> dict:
    """Rank 0 of ``phase_serving_mesh`` (b)."""
    import queue as queue_mod

    from repro_torch.core import reduce_dense_oracle
    from repro_torch.dist.mesh import init_shard_mesh
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import ShardedEmbeddingServer

    names = sorted(tables)
    mesh = init_shard_mesh(ASYNC_SHARDS, rank=0, world_size=ASYNC_SHARDS, device=DEVICE,
                           backend=MESH_BACKEND, init_method=init, timeout_s=MESH_TIMEOUT_S)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server = ShardedEmbeddingServer(
            tables, histories, num_shards=ASYNC_SHARDS, mesh=mesh, combine=MESH_COMBINE,
            q_block=Q_BLOCK, group_size=GROUP_SIZE, batch_size=BATCH_SIZE,
            flush_policy="owner-set", owner_set_max=2, threaded=True, max_in_flight=2,
            device=DEVICE,
        )
        setup_s = time.perf_counter() - t0
        image = server.shard_images
        labels = ("p0", "p1")
        for label in labels:
            server.register_producer(label)
        slices = {label: [order[i] for i in range(p, len(order), 2)]
                  for p, label in enumerate(labels)}
        mesh.combine_events.clear()
        mesh.record_combine = True
        crossbar_reduce_cuda.launches = 0
        t0 = time.perf_counter()
        try:
            _submit_from_producers(server, slices)
            out = server.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches0 = crossbar_reduce_cuda.launches
            validate_b = validate_full(server, "serving-mesh (b) rank 0")
        finally:
            server.close()
        mesh.record_combine = False
        combine_ms = mesh.combine_ms()
        rep = server.report()
        image_shape, image_bytes = list(image.shape), image.numel() * image.element_size()
        del server, image
        torch.cuda.empty_cache()
        merged = merge_positions(order, names)
        err = oracle_err = 0.0
        for n in names:
            got = out.get(n)
            if got is None or got.shape != (len(merged[n]), PADDED_DIM) or not torch.isfinite(got).all():
                raise AssertionError(f"serving-mesh (b) table {n}: bad output "
                                     f"{None if got is None else tuple(got.shape)}")
            err = max(err, float((got - async_rows[n]).abs().max().item()))
        if err > TOL["float32"]:
            raise AssertionError(f"serving-mesh (b) rows disagree with serving-async's: {err}")
        pick = np.random.default_rng(13).choice(len(order), size=SAMPLE_ROWS, replace=False)
        flat = [(n, j) for n in names for j in range(len(merged[n]))]
        for i in pick.tolist():
            n, j = flat[i]
            want = reduce_dense_oracle(tables[n], [streams[n][merged[n][j]]])[0]
            oracle_err = max(oracle_err, float((out[n][j] - want).abs().max().item()))
        if oracle_err > TOL["float32"]:
            raise AssertionError(f"serving-mesh (b) rows disagree with gather+sum: {oracle_err}")
        s = rep["serve"]
        sizes = {int(k) for k in s["participant_sizes"]}
        if not {1, 2, ASYNC_SHARDS} <= sizes:
            raise AssertionError(f"serving-mesh (b): participant sizes {sizes}, need 1, 2 "
                                 f"and {ASYNC_SHARDS}")
        if rep["mode"] != "shard_map":
            raise AssertionError(f"serving-mesh (b): mode {rep['mode']}")
        del out

        bits = _mesh_bits(torch, np, mesh)
    finally:
        mesh.close()
    per_rank = {0: [launches0] + bits.pop("rank0_launches")}
    for _ in range(ASYNC_SHARDS - 1):
        try:
            rank, counts, error = results.get(timeout=120)
        except queue_mod.Empty:
            raise AssertionError("serving-mesh (b): a worker sent no result") from None
        if error is not None:
            raise AssertionError(f"serving-mesh (b): rank {rank} failed:\n{error}")
        per_rank[rank] = [c["launches"] for c in counts]
    # the FULL run's launches of every rank (the bits runs are not the main path)
    launches = sum(counts[0] for counts in per_rank.values())
    if min(counts[0] for counts in per_rank.values()) <= 0:
        raise AssertionError(f"serving-mesh (b): a rank launched no kernel: {per_rank}")
    pct = {k: {p: s[k][p] for p in ("p50", "p99")}
           for k in ("submit_latency_s", "e2e_latency_s", "flush_latency_s")}
    stats = {
        "world": ASYNC_SHARDS, "backend": MESH_BACKEND, "combine": MESH_COMBINE,
        "tables": len(names), "rows": ROWS, "dim": PADDED_DIM, "policy": "owner-set",
        "owner_set_max": 2, "threaded": True, "producers": 2,
        "setup_s": setup_s, "image_shape": image_shape, "image_bytes_per_rank": image_bytes,
        "max_memory_allocated_rank0": torch.cuda.max_memory_allocated(),
        "queries": s["queries"], "wall_s": wall, "queries_per_s": s["queries"] / wall,
        "serving_async_queries_per_s": async_stats["queries_per_s"], **pct,
        "batches": s["batches"], "participant_sizes": s["participant_sizes"],
        "shard_flushes": s["shard_flushes"],
        "combines_timed": len(combine_ms),
        "combine_ms_p50": statistics.median(combine_ms) if combine_ms else None,
        "combine_ms_mean": statistics.fmean(combine_ms) if combine_ms else None,
        "combine_ms_max": max(combine_ms) if combine_ms else None,
        "combine_bytes": s["combine_bytes"], "result_bytes": rep["mesh"]["result_bytes"],
        "subgroups": rep["dispatch_cache"]["mesh_subset"],
        "kernel_launches": launches, "launches_per_rank": per_rank,
        "max_abs_err_vs_serving_async": err, "sampled_rows": SAMPLE_ROWS,
        "sample_max_abs_err": oracle_err, "bits": bits, "validate_s": validate_b,
    }
    log("serving-mesh (b)", json.dumps(stats))
    return stats


def _mesh_bits(torch, np, mesh) -> dict:
    """The integer-valued bits stream through a mesh server under the five
    setups, each drain bit-identical to the emulated card server's and to
    gather+sum; rank 0's launches of each run."""
    from repro_torch.convert import tables_from_numpy
    from repro_torch.core import reduce_dense_oracle
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import ShardedEmbeddingServer

    names, host, histories, stream = bits_inputs(np)
    tables = tables_from_numpy(host, DEVICE)
    per_table = {n: [q for t, q in stream if t == n] for n in names}
    oracle = {n: reduce_dense_oracle(tables[n], per_table[n]) for n in names}
    slices = bits_slices(stream, names)
    runs, launches = {}, []
    for label, policy, threaded in BITS_SETUPS:
        got = {}
        for meshed in (True, False):
            server = ShardedEmbeddingServer(
                tables, histories, num_shards=ASYNC_SHARDS, q_block=4,
                group_size=GROUP_SIZE, batch_size=32, flush_policy=policy,
                threaded=threaded, device=DEVICE, mesh=mesh if meshed else None,
                combine=MESH_COMBINE)
            crossbar_reduce_cuda.launches = 0
            got[meshed] = serve_bits(torch, server, names, stream, slices, threaded,
                                     _submit_from_producers)
            if meshed:
                launches.append(crossbar_reduce_cuda.launches)
                runs[label] = {"flushes": server.stats.batches,
                               "participant_sizes": server.stats.summary()["participant_sizes"],
                               "result_bytes": server.stats.result_bytes}
        for n in names:
            if not (torch.equal(got[True][n], got[False][n])
                    and torch.equal(got[True][n], oracle[n])):
                raise AssertionError(f"serving-mesh bits: {label} table {n} is not "
                                     f"bit-identical to the emulated server and gather+sum")
    return {"rows": BITS_ROWS, "queries": len(stream), "runs": runs,
            "bit_identical": True, "rank0_launches": launches}


def busy_stream_dispatch(torch, server, dispatch, order, rows_global, *,
                         observe=False) -> dict:
    """One flush dispatched while the server's stream is still busy with
    ``BUSY_CYCLES`` of ``torch.cuda._sleep``: the dispatch (host compile,
    the pinned copy of the schedule, the kernels) and, with ``observe``,
    the drift observation that follows it must return while the stream
    still runs, its event pending; its rows must equal the global
    phase's.  A host wait anywhere in the dispatch fails this."""
    batch = order[:BATCH_SIZE]
    entries = [(name, i, list(q)) for i, (name, q) in enumerate(batch)]
    with torch.cuda.stream(server._stream):
        torch.cuda._sleep(BUSY_CYCLES)
        t0 = time.perf_counter()
        entry = dispatch(entries, None)
        if observe:
            server._observe_and_stage(entry.host_acts, entry.n_queries)
        returned_ms = (time.perf_counter() - t0) * 1e3
        pending = not entry.event.query()
        entry.event.synchronize()
        done_ms = (time.perf_counter() - t0) * 1e3
    if not pending:
        raise AssertionError(f"a dispatch onto a busy stream waited for it "
                             f"(returned after {returned_ms:.1f} ms)")
    err = 0.0
    for name, out in zip(entry.served, entry.outs):
        # the batch holds each table's first queries of the serving phase
        err = max(err, float((out - rows_global[name][: out.shape[0]]).abs().max().item()))
    if err > TOL["float32"]:
        raise AssertionError(f"busy-stream dispatch rows disagree: {err}")
    return {"busy_cycles": BUSY_CYCLES, "observed": observe, "returned_ms": returned_ms,
            "event_pending_at_return": pending, "done_ms": done_ms, "max_abs_err": err}


def merge_positions(order, names, producers=2) -> dict:
    """For a stream submitted round-robin by ``producers`` threads and
    drained whole: per table, the table's stream positions in the drain's
    ``(local_seq, producer)`` merge order."""
    local, keyed, seen = {}, {n: [] for n in names}, {n: 0 for n in names}
    for i, (name, _) in enumerate(order):
        pid = i % producers
        seq = local.get((pid, name), 0)
        local[(pid, name)] = seq + 1
        keyed[name].append((seq, pid, seen[name]))
        seen[name] += 1
    return {n: [k for _, _, k in sorted(keyed[n])] for n in names}


def drift_stream(np, order, rows, seed):
    """``order`` with every row id of its second half rotated through one
    fixed permutation — ``launch/serve_sharded.py --drift``'s hot-set
    rotation, which the plan never saw."""
    perm = np.random.default_rng(seed).permutation(rows)
    cut = len(order) // 2
    return order[:cut] + [(name, perm[np.asarray(q, dtype=np.int64)])
                          for name, q in order[cut:]]


def check_image_slots(torch, np, server, written, gen, tag="serving-replan") -> dict:
    """Every addressed slot a patch wrote, and ``SAMPLE_SLOTS`` other
    addressed slots, must hold their tile of the host master image bit
    for bit (compared on the card)."""
    plan, images = server.plan, server.shard_images
    cap = images.shape[1]
    shard, tile = np.nonzero(plan.local_tile_of >= 0)
    # raises if an allocated slot falls off the image
    key = np.ravel_multi_index((shard, plan.local_tile_of[shard, tile]), (images.shape[0], cap))
    by_key = np.argsort(key)
    key, tile = key[by_key], tile[by_key]
    written = np.unique(np.asarray(sorted(written), dtype=np.int64))
    patched = written[np.isin(written, key)]
    rest = np.setdiff1d(key, patched)
    sample = gen.choice(rest, size=min(SAMPLE_SLOTS, rest.size), replace=False)
    check = np.concatenate([patched, sample])
    for c0 in range(0, check.size, 2_048):
        ks = check[c0:c0 + 2_048]
        t = tile[np.searchsorted(key, ks)]
        got = images[torch.from_numpy(ks // cap).to(DEVICE), torch.from_numpy(ks % cap).to(DEVICE)]
        want = torch.from_numpy(server._fused[t]).to(device=DEVICE, dtype=images.dtype)
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: an image slot differs from its master tile")
    return {"patched_slots_checked": int(patched.size), "sampled_slots_checked": int(sample.size)}


def phase_serving_replan(torch, np, timer, tables, histories, served, async_stats) -> dict:
    """Online replanning at dlrm-recross FULL width: the serving-async
    configuration with ``replan=`` the launcher's ``--drift`` defaults,
    over 1,024 queries a table whose row ids rotate through a fixed
    permutation from half-way on.  At least one patch must copy tiles;
    drained rows are held against the serving phase's and gather+sum, the
    patched and sampled image slots against the host master image; one
    dispatch plus its drift observation must return before a busy stream
    finishes.  Times the patch's host gather, copy and scatter, and a
    plain pinned copy of the same bytes."""
    from repro_torch.core import reduce_dense_oracle
    from repro_torch.kernels import sharded as sharded_mod
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import ReplanConfig, ShardedEmbeddingServer
    from repro_torch.serve import drift as drift_mod
    from repro_torch.serve import sharded as server_mod

    names = sorted(tables)
    n_tab = len(names)
    long_streams = served["long_streams"]
    order = drift_stream(np, [(names[i % n_tab], long_streams[names[i % n_tab]][i // n_tab])
                              for i in range(n_tab * REPLAN_PER_TABLE)], ROWS, DRIFT_SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = ShardedEmbeddingServer(
        tables, histories, num_shards=ASYNC_SHARDS, q_block=Q_BLOCK,
        group_size=GROUP_SIZE, batch_size=BATCH_SIZE, flush_policy="owner-set",
        owner_set_max=2, threaded=True, max_in_flight=2, device=DEVICE,
        replan=ReplanConfig(**REPLAN),
    )
    plan_s = time.perf_counter() - t0
    image_shape = list(server.shard_images.shape)
    log(f"serving-replan: plan build {plan_s:.2f} s, image {tuple(image_shape)}, "
        f"host master {server._fused.nbytes} B")

    # the patch's host gather (host clock) and its device steps (CUDA
    # events on the server's stream), through the functions
    # patch_shard_images calls
    timing = {"gather_s": [], "apply_s": [], "resize": [], "copy": [], "scatter": [],
              "plan_apply_s": [], "rebuild_s": [], "digest_s": [], "loads_s": [],
              "stage_s": []}
    written = set()

    def host_timed(key, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            timing[key].append(time.perf_counter() - t)
            return out
        return run

    stage = sharded_mod.stage_patch_tiles

    def timed_stage(writes, *args, **kw):
        t = time.perf_counter()
        out = stage(writes, *args, **kw)
        timing["gather_s"].append(time.perf_counter() - t)
        written.update(s * 10**9 + slot for s, slot, _ in writes)
        return out

    def device_timed(key, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            timing[key].append((start, end))
            return out
        return run

    apply = server._apply_staged_patch

    def timed_apply():
        if server._staged is None:
            return apply()
        t = time.perf_counter()
        apply()
        timing["apply_s"].append(time.perf_counter() - t)

    observe = server._observe_and_stage
    obs_s = []

    def timed_observe(host_acts, n_queries):
        t = time.perf_counter()
        observe(host_acts, n_queries)
        obs_s.append(time.perf_counter() - t)

    server._apply_staged_patch = timed_apply
    server._observe_and_stage = timed_observe
    # the observation's parts: the digest, the loads on a miss and the
    # drift statistic with any patch computation; the apply's plan swap
    # (rebases too) and the scheduler's rebuild
    server._maybe_stage = host_timed("stage_s", server._maybe_stage)
    server.scheduler.rebuild = host_timed("rebuild_s", server.scheduler.rebuild)
    labels = ("p0", "p1")
    for label in labels:
        server.register_producer(label)
    slices = {label: [order[i] for i in range(p, len(order), 2)]
              for p, label in enumerate(labels)}
    crossbar_reduce_cuda.launches = 0
    patched_fns = (
        mock.patch.object(sharded_mod, "stage_patch_tiles", timed_stage),
        mock.patch.object(sharded_mod, "resize_shard_images",
                          device_timed("resize", sharded_mod.resize_shard_images)),
        mock.patch.object(sharded_mod, "upload_patch_tiles",
                          device_timed("copy", sharded_mod.upload_patch_tiles)),
        mock.patch.object(sharded_mod, "scatter_patch_tiles",
                          device_timed("scatter", sharded_mod.scatter_patch_tiles)),
        mock.patch.object(server_mod, "apply_plan_patch",
                          host_timed("plan_apply_s", server_mod.apply_plan_patch)),
        mock.patch.object(drift_mod, "activation_group_loads",
                          host_timed("loads_s", drift_mod.activation_group_loads)),
        mock.patch.object(drift_mod.LoadObservationCache, "_key", staticmethod(
            host_timed("digest_s", drift_mod.LoadObservationCache._key))),
    )
    t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            for patched in patched_fns:
                stack.enter_context(patched)
            _submit_from_producers(server, slices)
            out = server.drain()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = crossbar_reduce_cuda.launches
        validate_s = validate_full(server, "serving-replan")
        rep = server.report()
        obs = list(obs_s)
        written = {(k // 10**9) * server.shard_images.shape[1] + k % 10**9 for k in written}
        slots = check_image_slots(torch, np, server, written, np.random.default_rng(13))
        busy = busy_stream_dispatch(torch, server, server._compile_and_dispatch, order,
                                    served["out"], observe=True)
    finally:
        server.close()
        # the wrappers close cycles through the server; break them so its
        # image is freed when this phase returns
        del server._apply_staged_patch, server._observe_and_stage, server._maybe_stage
        del server.scheduler.rebuild
    s = rep["serve"]
    if launches <= 0:
        raise AssertionError("serving-replan ran no crossbar kernel launch")
    if s["replans"] < 1 or s["patched_tiles"] <= 0:
        raise AssertionError(f"serving-replan applied no patch that copies tiles: "
                             f"{s['replans']} replans, {s['patched_tiles']} tiles")
    if s["barrier_flushes"] < 1:
        raise AssertionError("serving-replan passed no barrier")

    # rows: in place (the drift-free first half equals the serving
    # phase's rows) and sampled against gather+sum
    merged = merge_positions(order, names)
    per_table = {n: [q for t, q in order if t == n] for n in names}
    rows_global = served["out"]
    err_global = 0.0
    for n in names:
        got = out.get(n)
        if got is None or got.shape != (len(merged[n]), PADDED_DIM) or not torch.isfinite(got).all():
            raise AssertionError(f"serving-replan table {n}: bad output "
                                 f"{None if got is None else tuple(got.shape)}")
        pos = [j for j, k in enumerate(merged[n]) if k < STREAM_PER_TABLE]
        want = rows_global[n][torch.tensor([merged[n][j] for j in pos], device=DEVICE)]
        err_global = max(err_global, float((got[torch.tensor(pos, device=DEVICE)] - want)
                                           .abs().max().item()))
    if err_global > TOL["float32"]:
        raise AssertionError(f"serving-replan rows disagree with the global phase's: {err_global}")
    pick = np.random.default_rng(17).choice(len(order), size=SAMPLE_ROWS, replace=False)
    flat = [(n, j) for n in names for j in range(len(merged[n]))]
    oracle_err = 0.0
    for i in pick.tolist():
        n, j = flat[i]
        want = reduce_dense_oracle(tables[n], [per_table[n][merged[n][j]]])[0]
        oracle_err = max(oracle_err, float((out[n][j] - want).abs().max().item()))
    if oracle_err > TOL["float32"]:
        raise AssertionError(f"serving-replan rows disagree with gather+sum: {oracle_err}")

    def total_ms(key):
        return sum(a.elapsed_time(b) for a, b in timing[key])

    tile_bytes = server._tile_bytes
    moved = s["patched_tiles"] * tile_bytes
    pinned = torch.empty(moved, dtype=torch.uint8, pin_memory=True)
    copy_ms = timer.ms(lambda: pinned.to(DEVICE, non_blocking=True))
    obs_arr = np.asarray(obs)
    flush_p50 = s["flush_latency_s"]["p50"]
    pct = {k: {p: s[k][p] for p in ("p50", "p99")}
           for k in ("submit_latency_s", "e2e_latency_s", "flush_latency_s")}
    stats = {
        "tables": n_tab, "rows": ROWS, "dim": PADDED_DIM, "shards": ASYNC_SHARDS,
        "policy": "owner-set", "owner_set_max": 2, "threaded": True, "producers": 2,
        "replan": REPLAN, "queries_per_table": REPLAN_PER_TABLE, "drift_from": len(order) // 2,
        "plan_build_s": plan_s, "image_shape_at_build": image_shape,
        "image_shape_after": list(server.shard_images.shape),
        "host_master_bytes": int(server._fused.nbytes),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "queries": s["queries"], "wall_s": wall, "queries_per_s": s["queries"] / wall,
        "async_queries_per_s": async_stats["queries_per_s"], **pct,
        "async_submit_latency_s": async_stats["submit_latency_s"],
        "async_e2e_latency_s": async_stats["e2e_latency_s"],
        "batches": s["batches"], "barrier_flushes": s["barrier_flushes"],
        "deadline_flushes": s["deadline_flushes"], "host_compile_s": s["host_compile_s"],
        "replans": s["replans"], "rebases": s["rebases"], "patched_tiles": s["patched_tiles"],
        "promoted_groups": s["promoted_groups"], "demoted_groups": s["demoted_groups"],
        "patches_with_writes": len(timing["gather_s"]),
        "patch_apply_s": timing["apply_s"], "patch_gather_s": timing["gather_s"],
        "patch_resize_ms": total_ms("resize"), "patch_copy_ms": total_ms("copy"),
        "patch_scatter_ms": total_ms("scatter"),
        "patch_bytes": moved, "pinned_copy_same_bytes_ms": copy_ms,
        "plan_apply_s": timing["plan_apply_s"], "scheduler_rebuild_s": timing["rebuild_s"],
        "observations": int(obs_arr.size), "observe_s_total": float(obs_arr.sum()),
        "observe_ms_mean": float(obs_arr.mean()) * 1e3,
        "observe_ms_p50": float(np.percentile(obs_arr, 50)) * 1e3,
        "observe_ms_p99": float(np.percentile(obs_arr, 99)) * 1e3,
        "observe_share_of_flush_p50": float(np.percentile(obs_arr, 50)) / flush_p50
        if flush_p50 else None,
        "observe_share_of_host_compile": float(obs_arr.sum()) / s["host_compile_s"],
        "observe_digest_s": sum(timing["digest_s"]), "observe_loads_s": sum(timing["loads_s"]),
        "observe_stage_s": sum(timing["stage_s"]),
        "load_obs_hits": s["tiers"]["load_obs_hits"],
        "load_obs_misses": s["tiers"]["load_obs_misses"],
        "drift_after": rep["replan"]["drift"], "slack_slots": rep["replan"]["slack_slots"],
        "kernel_launches": launches, **slots, "busy_stream_dispatch": busy,
        "max_abs_err_vs_global": err_global, "sampled_rows": SAMPLE_ROWS,
        "sample_max_abs_err": oracle_err, "faults": s["faults"], "validate_s": validate_s,
    }
    log("serving-replan", json.dumps(stats))
    return stats


def phase_serving_tiers(torch, np, tables, histories, served, replan_stats) -> dict:
    """Tiered hot/cold storage at dlrm-recross FULL width: the
    serving-replan configuration and rotated stream with
    ``tiers=TierConfig(capacity_frac=0.25)``.  Fails unless queries take
    both routes, a barrier fetches tiles and the image depth equals the
    capacity after every patch; drained rows are held against the
    serving phase's and gather+sum, the fetched and sampled resident
    slots against the host master image.  Times the host flush: the
    gather from the master image, the float32 sums, the copy to the card
    (CUDA events) and the host loads it feeds the tracker."""
    from repro_torch.core import reduce_dense_oracle
    from repro_torch.kernels import sharded as sharded_mod
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import ReplanConfig, ShardedEmbeddingServer, TierConfig
    from repro_torch.serve import sharded as server_mod

    names = sorted(tables)
    n_tab = len(names)
    long_streams = served["long_streams"]
    order = drift_stream(np, [(names[i % n_tab], long_streams[names[i % n_tab]][i // n_tab])
                              for i in range(n_tab * REPLAN_PER_TABLE)], ROWS, DRIFT_SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = ShardedEmbeddingServer(
        tables, histories, num_shards=ASYNC_SHARDS, q_block=Q_BLOCK,
        group_size=GROUP_SIZE, batch_size=BATCH_SIZE, flush_policy="owner-set",
        owner_set_max=2, threaded=True, max_in_flight=2, device=DEVICE,
        replan=ReplanConfig(**REPLAN), tiers=TierConfig(capacity_frac=TIER_FRAC),
    )
    plan_s = time.perf_counter() - t0
    cap = server._capacity_tiles
    image = server.shard_images
    image_bytes = image.numel() * image.element_size()
    if image.shape[1] != cap:
        raise AssertionError(f"serving-tiers: image depth {image.shape[1]} at build, "
                             f"capacity {cap}")
    routed_hot = sum(server._residency.is_resident(n, np.asarray(q, dtype=np.int64))
                     for n, q in order[: len(order) // 2])
    log(f"serving-tiers: plan build {plan_s:.2f} s, capacity {cap} tiles a shard, image "
        f"{tuple(image.shape)} = {image_bytes} B, host master {server._fused.nbytes} B, "
        f"{routed_hot} of the first {len(order) // 2} queries resident at build")

    # the host flush's parts (host clock; the copy by CUDA events on the
    # server's stream), the patches' writes and the depth after each apply
    timing = {"cold_rows_s": [], "gather_s": [], "sum_s": [], "copy": [], "loads_s": [],
              "apply_s": [], "patch_gather_s": []}
    written, depths, flush_sizes, forced = set(), [], [], [0]

    def host_timed(key, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            timing[key].append(time.perf_counter() - t)
            return out
        return run

    def device_timed(key, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            timing[key].append((start, end))
            return out
        return run

    stage = sharded_mod.stage_patch_tiles

    def recorded_stage(writes, *args, **kw):
        written.update(s * 10**9 + slot for s, slot, _ in writes)
        t = time.perf_counter()
        out = stage(writes, *args, **kw)
        timing["patch_gather_s"].append(time.perf_counter() - t)
        return out

    apply = server._apply_staged_patch

    def checked_apply():
        if server._staged is None:
            return apply()
        t = time.perf_counter()
        apply()
        timing["apply_s"].append(time.perf_counter() - t)
        depths.append(int(server.shard_images.shape[1]))

    cold_rows = host_timed("cold_rows_s", server._cold_rows)

    def sized_cold_rows(entries):
        flush_sizes.append(len(entries))
        return cold_rows(entries)

    flush_host = server._flush_host_queue

    def counted_flush_host(**kw):
        # the barrier's forced drain of a non-empty queue
        forced[0] += int(kw.get("forced", False) and len(server._host_queue) > 0)
        return flush_host(**kw)

    server._apply_staged_patch = checked_apply
    server._cold_rows = sized_cold_rows
    server._flush_host_queue = counted_flush_host
    residency = server._residency
    residency.host_group_loads = host_timed("loads_s", residency.host_group_loads)
    labels = ("p0", "p1")
    for label in labels:
        server.register_producer(label)
    slices = {label: [order[i] for i in range(p, len(order), 2)]
              for p, label in enumerate(labels)}
    crossbar_reduce_cuda.launches = 0
    patched_fns = (
        mock.patch.object(sharded_mod, "stage_patch_tiles", recorded_stage),
        mock.patch.object(server_mod, "gather_cold_rows",
                          host_timed("gather_s", server_mod.gather_cold_rows)),
        mock.patch.object(server_mod, "sum_cold_rows",
                          host_timed("sum_s", server_mod.sum_cold_rows)),
        mock.patch.object(server_mod, "_to_device",
                          device_timed("copy", server_mod._to_device)),
    )
    t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            for fn in patched_fns:
                stack.enter_context(fn)
            _submit_from_producers(server, slices)
            out = server.drain()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = crossbar_reduce_cuda.launches
        validate_s = validate_full(server, "serving-tiers")
        rep = server.report()
        written = {(k // 10**9) * server.shard_images.shape[1] + k % 10**9 for k in written}
        slots = check_image_slots(torch, np, server, written, np.random.default_rng(19),
                                  tag="serving-tiers")
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.close()
        # the wrappers close cycles through the server; break them so its
        # image is freed when this phase returns
        del server._apply_staged_patch, server._cold_rows, server._flush_host_queue
        del residency.host_group_loads
    s, ts = rep["serve"], rep["serve"]["tiers"]
    if launches <= 0:
        raise AssertionError("serving-tiers ran no crossbar kernel launch")
    if ts["hot_queries"] <= 0 or ts["host_queries"] <= 0:
        raise AssertionError(f"serving-tiers: {ts['hot_queries']} hot and "
                             f"{ts['host_queries']} host queries; both routes must serve")
    if ts["fetched_tiles"] <= 0:
        raise AssertionError(f"serving-tiers: no barrier fetched a tile: {ts}, "
                             f"{s['replans']} replans, {s['rebases']} rebases")
    if (any(d != cap for d in depths) or server.shard_images.shape[1] != cap
            or int(server.plan.local_num_tiles.max()) > cap):
        raise AssertionError(f"serving-tiers: image depths {sorted(set(depths))} after "
                             f"patches, capacity {cap}")

    merged = merge_positions(order, names)
    per_table = {n: [q for t, q in order if t == n] for n in names}
    rows_global = served["out"]
    err_global = 0.0
    for n in names:
        got = out.get(n)
        if got is None or got.shape != (len(merged[n]), PADDED_DIM) or not torch.isfinite(got).all():
            raise AssertionError(f"serving-tiers table {n}: bad output "
                                 f"{None if got is None else tuple(got.shape)}")
        pos = [j for j, k in enumerate(merged[n]) if k < STREAM_PER_TABLE]
        want = rows_global[n][torch.tensor([merged[n][j] for j in pos], device=DEVICE)]
        err_global = max(err_global, float((got[torch.tensor(pos, device=DEVICE)] - want)
                                           .abs().max().item()))
    if err_global > TOL["float32"]:
        raise AssertionError(f"serving-tiers rows disagree with the global phase's: {err_global}")
    pick = np.random.default_rng(23).choice(len(order), size=SAMPLE_ROWS, replace=False)
    flat = [(n, j) for n in names for j in range(len(merged[n]))]
    oracle_err = 0.0
    for i in pick.tolist():
        n, j = flat[i]
        want = reduce_dense_oracle(tables[n], [per_table[n][merged[n][j]]])[0]
        oracle_err = max(oracle_err, float((out[n][j] - want).abs().max().item()))
    if oracle_err > TOL["float32"]:
        raise AssertionError(f"serving-tiers rows disagree with gather+sum: {oracle_err}")

    def ms(key):
        return [t * 1e3 for t in timing[key]]

    copy_ms = [a.elapsed_time(b) for a, b in timing["copy"]]
    cold_ms = np.asarray(ms("cold_rows_s"))
    tile_bytes = server._tile_bytes
    pct = {k: {p: s[k][p] for p in ("p50", "p99")}
           for k in ("submit_latency_s", "e2e_latency_s", "flush_latency_s")}
    stats = {
        "tables": n_tab, "rows": ROWS, "dim": PADDED_DIM, "shards": ASYNC_SHARDS,
        "policy": "owner-set", "owner_set_max": 2, "threaded": True, "producers": 2,
        "replan": REPLAN, "capacity_frac": TIER_FRAC, "capacity_tiles": cap,
        "queries_per_table": REPLAN_PER_TABLE, "drift_from": len(order) // 2,
        "plan_build_s": plan_s, "image_shape": list(image.shape), "image_bytes": image_bytes,
        "serving_replan_image_shape": replan_stats["image_shape_at_build"],
        "host_master_bytes": int(server._fused.nbytes), "max_memory_allocated": peak,
        "resident_at_build_first_half": int(routed_hot),
        "queries": ts["hot_queries"] + ts["host_queries"], "wall_s": wall,
        "queries_per_s": (ts["hot_queries"] + ts["host_queries"]) / wall,
        "replan_queries_per_s": replan_stats["queries_per_s"], **pct,
        "replan_e2e_latency_s": replan_stats["e2e_latency_s"],
        "hot_tier_hit_rate": ts["hot_tier_hit_rate"], "hot_queries": ts["hot_queries"],
        "host_queries": ts["host_queries"], "host_flushes": ts["host_flushes"],
        "host_deadline_flushes": ts["host_deadline_flushes"],
        "host_barrier_flushes": forced[0],
        "host_batch_flushes": ts["host_flushes"] - ts["host_deadline_flushes"] - forced[0],
        "host_flush_queries_mean": float(np.mean(flush_sizes)) if flush_sizes else 0.0,
        "fetched_tiles": ts["fetched_tiles"], "fetched_bytes": ts["paging_bytes"],
        "evicted_tiles": ts["evicted_tiles"], "evicted_bytes": ts["evicted_tiles"] * tile_bytes,
        "cold_groups_after": rep["tiers"]["cold_groups"],
        "resident_groups_after": rep["tiers"]["resident_groups"],
        "replans": s["replans"], "rebases": s["rebases"], "patched_tiles": s["patched_tiles"],
        "barrier_flushes": s["barrier_flushes"], "batches": s["batches"],
        "deadline_flushes": s["deadline_flushes"], "host_compile_s": s["host_compile_s"],
        "depths_after_patches": sorted(set(depths)),
        "patch_apply_s": timing["apply_s"], "patch_gather_s": timing["patch_gather_s"],
        "host_rows_ms_p50": float(np.percentile(cold_ms, 50)) if cold_ms.size else 0.0,
        "host_rows_ms_p99": float(np.percentile(cold_ms, 99)) if cold_ms.size else 0.0,
        "host_rows_s_total": float(cold_ms.sum()) / 1e3,
        "host_gather_s_total": sum(timing["gather_s"]),
        "host_sum_s_total": sum(timing["sum_s"]),
        "host_copy_ms_total": sum(copy_ms), "host_copies": len(copy_ms),
        "host_loads_s_total": sum(timing["loads_s"]),
        "kernel_launches": launches, **slots,
        "max_abs_err_vs_global": err_global, "sampled_rows": SAMPLE_ROWS,
        "sample_max_abs_err": oracle_err, "faults": s["faults"], "validate_s": validate_s,
    }
    log("serving-tiers", json.dumps(stats))
    return stats


def _submit_in_turns(server, slices) -> None:
    """Each producer's ``[(table, query), ...]`` from its own thread, the
    threads taking strict turns one query at a time: the hand-off order,
    and with it every replan decision, is the same in every run."""
    import threading

    # round robin over the producers that still have queries
    left = {label: len(v) for label, v in slices.items()}
    schedule = []
    while any(left.values()):
        for label in slices:
            if left[label]:
                schedule.append(label)
                left[label] -= 1
    turn = {"i": 0}
    cond = threading.Condition()
    errors = []

    def run(label):
        try:
            for name, q in slices[label]:
                with cond:
                    while turn["i"] < len(schedule) and schedule[turn["i"]] != label:
                        cond.wait(timeout=60)
                    server.submit(name, q, producer=label)
                    turn["i"] += 1
                    cond.notify_all()
        except Exception as e:  # re-raised on the caller's thread below
            errors.append(e)
            with cond:
                turn["i"] = len(schedule)
                cond.notify_all()

    threads = [threading.Thread(target=run, args=(label,), daemon=True) for label in slices]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a producer did not finish")
    if errors:
        raise errors[0]


BITS_SETUPS = (("global", "global", False), ("per-shard", "per-shard", False),
               ("deadline", "deadline", False), ("owner-set", "owner-set", False),
               ("owner-set/threaded/2p", "owner-set", True))


def serve_bits(torch, server, names, stream, slices, threaded, submit) -> dict:
    """One stream through ``server``: inline submits and the final
    flush, or ``slices`` submitted by ``submit`` from producer threads
    and one drain.  Returns ``{table: rows}``; closes the server."""
    try:
        if threaded:
            for p in slices:
                server.register_producer(p)
            submit(server, slices)
            return server.drain()
        parts = {n: [] for n in names}
        for t, q in stream:
            for n, rows in server.submit(t, q).items():
                parts[n].append(rows)
        for n, rows in server.flush().items():
            parts[n].append(rows)
        return {n: torch.cat(parts[n]) for n in names}
    finally:
        server.close()


def bits_inputs(np):
    """The integer-valued bits stream: two 4,096 x 128 tables, their
    histories and 1,024 queries, ``a`` twice as often as ``b``."""
    from repro_torch.data import zipf_queries

    rng = np.random.default_rng(99)
    names = ("a", "b")
    host = {n: rng.integers(-8, 9, size=(BITS_ROWS, PADDED_DIM)).astype(np.float32)
            for n in names}
    histories = {n: zipf_queries(BITS_ROWS, 2048, 12.0, seed=10 + i) for i, n in enumerate(names)}
    base = [("a" if i % 3 else "b", q)
            for i, q in enumerate(zipf_queries(BITS_ROWS, BITS_QUERIES, 12.0, seed=20))]
    return names, host, histories, base


def bits_slices(stream, names) -> dict:
    """The k-th query of a table goes to producer k % 2: the ``(local_seq,
    pid)`` merge then restores each table's submission order."""
    slices, count = {"p0": [], "p1": []}, {n: 0 for n in names}
    for t, q in stream:
        slices[f"p{count[t] % 2}"].append((t, q))
        count[t] += 1
    return slices


def check_lock_monitor(graph, tag: str) -> dict:
    """The monitored run's acquisition edges must all run forward in the
    blessed order and be edges the static pass over ``repro_torch/serve``
    knows; returns both edge sets."""
    from repro_torch.analysis import analyze_locks

    static = sorted({(e.held, e.acquired) for e in analyze_locks().edges})
    observed = sorted(graph.edge_set())
    out = {"observed_edges": observed, "static_edges": static,
           "blessed_violations": graph.check_blessed()}
    log(f"analysis: lock monitor on {tag}", json.dumps(out))
    if out["blessed_violations"] or not observed or not set(observed) <= set(static):
        raise AssertionError(f"lock monitor on {tag}: {out['blessed_violations']}, observed "
                             f"edges outside the static graph "
                             f"{sorted(set(observed) - set(static))}")
    return out


def phase_async_bits(torch, np) -> dict:
    """Integer-valued tables on the card: one seeded stream served under
    global, per-shard, deadline and owner-set inline, and owner-set on the
    thread driver from two producers; every drain must hold the same bits
    as the others and as gather+sum.  Then the stream with its second
    half's row ids rotated (``drift_stream``) under ``replan=`` in the same
    five setups (the two producers taking strict turns): each must equal
    the port's CPU server on the same configuration bit for bit, with the
    same replans and patched tiles, and at least one patch that copies
    tiles.  Then the rotated stream under ``tiers=`` (a hot tier of half
    the uncapped depth) in the same five setups: each must equal the
    uncapped server's rows, gather+sum and the CPU tiered server, with
    the same host queries and fetched and evicted tiles; and once more
    (owner-set inline) with the first two patch applies failing at the
    injector's patch seam."""
    from repro_torch.analysis import monitor_server
    from repro_torch.convert import tables_from_numpy
    from repro_torch.core import reduce_dense_oracle
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import (
        FaultPlan, ReplanConfig, RetryPolicy, ShardedEmbeddingServer, TierConfig,
    )

    names, host, histories, base = bits_inputs(np)
    tables, cpu_tables = tables_from_numpy(host, DEVICE), tables_from_numpy(host, "cpu")
    tier_keys = ("hot_queries", "host_queries", "host_flushes", "fetched_tiles",
                 "evicted_tiles")
    runs, uncapped = {}, {}
    launches = 0
    monitor = None
    patch_fault = ("owner-set/patch-fault", "owner-set", False)
    for mode in ("plain", "replan", "tiers"):
        stream = drift_stream(np, base, BITS_ROWS, DRIFT_SEED) if mode != "plain" else base
        per_table = {n: [q for t, q in stream if t == n] for n in names}
        oracle = {n: reduce_dense_oracle(tables[n], per_table[n]) for n in names}
        slices = bits_slices(stream, names)
        submit = _submit_in_turns if mode != "plain" else _submit_from_producers
        setups = BITS_SETUPS + ((patch_fault,) if mode == "tiers" else ())
        for label, policy, threaded in setups:
            def build(device, table_set):
                kw = {"num_shards": ASYNC_SHARDS, "q_block": 4, "group_size": GROUP_SIZE,
                      "batch_size": 32}
                if mode != "plain":
                    kw.update(batch_size_for_eq1=BITS_EQ1_BATCH, replan=ReplanConfig(**REPLAN))
                if mode == "tiers":
                    kw["tiers"] = TierConfig(capacity_frac=TIER_BITS_FRAC)
                if label == patch_fault[0]:
                    kw.update(faults=FaultPlan([], seed=0).add("patch", tick=0, times=2),
                              retry=RetryPolicy(patch_retries=2))
                return ShardedEmbeddingServer(table_set, histories, flush_policy=policy,
                                              threaded=threaded, device=device, **kw)

            server = build(DEVICE, tables)
            # the two-producer thread-driver run takes the card's threads
            # under the lock monitor, raising on a backwards acquisition
            graph = monitor_server(server, enforce=True) if threaded and mode == "plain" else None
            crossbar_reduce_cuda.launches = 0
            out = serve_bits(torch, server, names, stream, slices, threaded, submit)
            launches += crossbar_reduce_cuda.launches
            tag = label if mode == "plain" else f"{label}/{mode}"
            if graph is not None:
                monitor = check_lock_monitor(graph, tag)
            for n in names:
                if not torch.equal(out[n], oracle[n]):
                    bad = float((out[n] - oracle[n]).abs().max().item())
                    raise AssertionError(f"async bits: {tag} table {n} is not bit-identical "
                                         f"to gather+sum (max_abs_err {bad})")
            st = server.stats.summary()
            runs[tag] = {"flushes": st["batches"]}
            if mode == "plain":
                continue
            if mode == "replan":
                uncapped[label] = out
            elif label in uncapped:
                for n in names:
                    if not torch.equal(out[n], uncapped[label][n]):
                        raise AssertionError(f"tier bits: {tag} table {n} differs from the "
                                             f"uncapped server's")
            cpu = build("cpu", cpu_tables)
            cpu_out = serve_bits(torch, cpu, names, stream, slices, threaded, submit)
            ct = cpu.stats.summary()
            counts = {k: st[k] for k in ("replans", "rebases", "patched_tiles")}
            want = {k: ct[k] for k in counts}
            if mode == "tiers":
                counts.update({k: st["tiers"][k] for k in tier_keys},
                              patch_failures=st["faults"]["patch_failures"])
                want.update({k: ct["tiers"][k] for k in tier_keys},
                            patch_failures=ct["faults"]["patch_failures"])
            if counts != want:
                raise AssertionError(f"{mode} bits: {tag} counted unlike the CPU server: "
                                     f"{counts} against {want}")
            if mode == "replan" and st["patched_tiles"] <= 0:
                raise AssertionError(f"replan bits: {tag} applied no patch that copies tiles")
            if mode == "tiers":
                ts = st["tiers"]
                if min(ts["hot_queries"], ts["host_queries"], ts["fetched_tiles"]) <= 0:
                    raise AssertionError(f"tier bits: {tag} needs hot and host queries and a "
                                         f"fetch: {ts}")
                if server.shard_images.shape[1] != server._capacity_tiles:
                    raise AssertionError(f"tier bits: {tag} image depth left its capacity")
                if label == patch_fault[0] and st["faults"]["patch_failures"] != 2:
                    raise AssertionError(f"tier bits: {tag} saw "
                                         f"{st['faults']['patch_failures']} patch failures, not 2")
            for n in names:
                if not torch.equal(out[n].cpu(), cpu_out[n]):
                    raise AssertionError(f"{mode} bits: {tag} table {n} differs from the "
                                         f"CPU server's")
            if not torch.equal(server.shard_images.cpu(), cpu.shard_images):
                raise AssertionError(f"{mode} bits: {tag} image differs from the CPU server's")
            runs[tag].update(counts, capacity=int(server.shard_images.shape[1]))
    stats = {"rows": BITS_ROWS, "queries": len(base), "shards": ASYNC_SHARDS,
             "tier_capacity_frac": TIER_BITS_FRAC, "runs": runs,
             "kernel_launches": launches, "bit_identical": True, "lock_monitor": monitor}
    log("serving-async-bits", json.dumps(stats))
    return stats


def phase_chaos_bits(torch, np) -> dict:
    """``tests/test_faults.py:466``'s threaded chaos replay on the card:
    two transient compile faults, a device fault, a poisoned query
    ``("a", 5)`` and a flush hung past the 0.2 s watchdog.  The hang must
    raise ``FlushTimeout`` (the card requeues it; only a CPU server
    degrades it) and a later drain must return every row; the rows must
    equal gather+sum minus exactly the offender and the CPU server's
    rows, with the CPU server's retries and quarantined keys.  Then the
    same replay with a 0.05 s hang, which must recover with no timeout."""
    from repro_torch.convert import tables_from_numpy
    from repro_torch.core import reduce_dense_oracle
    from repro_torch.data import zipf_queries
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import FaultPlan, FlushTimeout, RetryPolicy, ShardedEmbeddingServer

    host = {n: np.random.default_rng(seed).integers(-8, 9, size=(CHAOS_ROWS, PADDED_DIM))
            .astype(np.float32) for n, seed in (("a", 11), ("b", 12))}
    histories = {"a": zipf_queries(CHAOS_ROWS, 48, 5.0, seed=13),
                 "b": zipf_queries(CHAOS_ROWS, 48, 5.0, seed=14)}
    streams = {"a": zipf_queries(CHAOS_ROWS, 20, 5.0, seed=15),
               "b": zipf_queries(CHAOS_ROWS, 12, 5.0, seed=16)}
    replay = [("a", q) for q in streams["a"]] + [("b", q) for q in streams["b"]]
    offender = ("a", 5)

    def run(device, hang_s):
        plan = (FaultPlan([], seed=3).add("compile", tick=0, times=2).add("device", tick=2)
                .add("poison", table=offender[0], seq=offender[1])
                .add("hang", tick=4, hang_s=hang_s))
        server = ShardedEmbeddingServer(
            tables_from_numpy(host, device), histories, num_shards=2, q_block=4,
            group_size=16, batch_size=4, flush_policy="per-shard", threaded=True,
            retry=RetryPolicy(max_retries=3, watchdog_s=0.2 if hang_s > 1 else 5.0,
                              backoff_base=1e-4, backoff_max=1e-3),
            faults=plan, device=device)
        raised = {"submit": 0, "drain": 0}
        try:
            for name, q in replay:
                while True:
                    try:
                        # a threaded submit raises a stashed driver error
                        # before it takes the query: submit it again
                        server.submit(name, q)
                        break
                    except FlushTimeout:
                        raised["submit"] += 1
            while True:
                try:
                    out = server.drain()
                    break
                except FlushTimeout:
                    raised["drain"] += 1
        finally:
            server.close()
        return server, out, raised

    stats = {}
    for hang_s in (999.0, 0.05):
        crossbar_reduce_cuda.launches = 0
        card, out, raised = run(DEVICE, hang_s)
        launches = crossbar_reduce_cuda.launches
        cpu, cpu_out, cpu_raised = run("cpu", hang_s)
        led, cled = card.stats.ledger, cpu.stats.ledger
        tag = f"chaos bits (hang {hang_s} s)"
        for n in host:
            keep = [q for i, q in enumerate(streams[n]) if (n, i) != offender]
            want = reduce_dense_oracle(tables_from_numpy({n: host[n]}, DEVICE)[n], keep)
            if not torch.equal(out[n], want) or not torch.equal(out[n].cpu(), cpu_out[n]):
                raise AssertionError(f"{tag}: table {n} differs from gather+sum minus the "
                                     f"offender or from the CPU server")
        if led.quarantined_keys() != [offender] or cled.quarantined_keys() != [offender]:
            raise AssertionError(f"{tag}: quarantined {led.quarantined_keys()}, CPU "
                                 f"{cled.quarantined_keys()}")
        if led.retries != cled.retries or led.retries <= 0:
            raise AssertionError(f"{tag}: {led.retries} retries, CPU {cled.retries}")
        timeouts = raised["submit"] + raised["drain"]
        if hang_s > 1:
            if timeouts < 1 or led.timed_out_flushes < 1 or led.degraded_flushes != 0:
                raise AssertionError(f"{tag}: the hang raised {timeouts} times, "
                                     f"{led.timed_out_flushes} timed out, "
                                     f"{led.degraded_flushes} degraded")
            if cpu_raised != {"submit": 0, "drain": 0} or cled.degraded_flushes < 1:
                raise AssertionError(f"{tag}: the CPU server did not degrade the hang")
        elif timeouts or led.timed_out_flushes or cled.timed_out_flushes:
            raise AssertionError(f"{tag}: a short hang timed out")
        stats[f"hang_{hang_s}"] = {
            "flush_timeouts_raised": raised, "timed_out_flushes": led.timed_out_flushes,
            "requeues": card.scheduler.requeues, "retries": led.retries,
            "cpu_retries": cled.retries, "bisections": led.bisections,
            "quarantined": [list(k) for k in led.quarantined_keys()],
            "cpu_degraded_flushes": cled.degraded_flushes,
            "injected": card.report()["faults"]["injected"], "kernel_launches": launches,
        }
    log("chaos-bits", json.dumps(stats))
    return stats


def phase_flat(torch, timer, server, tables, streams) -> dict:
    from repro_torch.core import compile_queries, reduce_dense_oracle
    from repro_torch.kernels import ops
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda

    name = server.names[0]
    layout = server.layouts[0]
    table = tables[name]
    host = table.cpu().numpy()
    image = torch.from_numpy(
        layout.build_image(host).reshape(layout.num_tiles, layout.tile_rows, PADDED_DIM)
    ).to(DEVICE)
    queries = streams[name][:BATCH_SIZE]
    cq = compile_queries(layout, queries, device=DEVICE)
    crossbar_reduce_cuda.launches = 0
    out = ops.crossbar_reduce(image, cq.tile_ids, cq.bitmaps)
    torch.cuda.synchronize()
    launches = crossbar_reduce_cuda.launches
    want = reduce_dense_oracle(table, queries)
    err = float((out - want).abs().max().item())
    if launches <= 0 or err > TOL["float32"] or out.shape != want.shape:
        raise AssertionError(f"flat op: launches {launches}, max_abs_err {err}")
    log(f"flat: ops.crossbar_reduce {tuple(out.shape)} vs reduce_dense_oracle "
        f"max_abs_err {err}, launches {launches}")
    row = parity(torch, timer, "flat-op/q1", image, cq.tile_ids, cq.bitmaps, library=True)
    return {"launches": launches, "row": row, "oracle_err": err}


def eb_work(torch, table, idx):
    """Least bytes and operations of one embedding bag on these inputs:
    each distinct valid row read once, the indices read once, the output
    written once; one add per valid lookup and column."""
    esize = table.element_size()
    dim = table.shape[1]
    valid = idx[idx >= 0].clamp_max(table.shape[0] - 1)
    nbytes = (int(torch.unique(valid).numel()) * dim * esize
              + idx.numel() * idx.element_size() + idx.shape[0] * dim * esize)
    return nbytes, int(valid.numel()) * dim


def eb_parity(torch, timer, name, table, idx, *, timed=False, n_split=None,
              exact=False) -> dict:
    """Embedding-bag kernel vs its plain version on the card; raises past
    the tolerance.  A forced ``n_split`` holds the kernel against the split
    version (``embedding_bag_split_ref``), which adds the splits' partials
    in the kernel's order.  ``exact`` (integer-valued tables) asks for the
    same bits as the plain version, the split version at the launch's
    split and a second launch.  Timed cases add ``F.embedding_bag`` as the
    library call (a yardstick the port never calls)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_cuda, embedding_bag_device_plan,
    )

    def kernel():
        return embedding_bag_cuda(table, idx, n_split=n_split)

    plan = embedding_bag_device_plan(table, idx, n_split)
    out = kernel()
    torch.cuda.synchronize()
    if n_split is None:
        want = ref.embedding_bag_ref(table, idx)
    else:
        want = ref.embedding_bag_split_ref(table, idx, n_split)
    dtype = str(table.dtype).removeprefix("torch.")
    err = float((out.float() - want.float()).abs().max().item()) if out.numel() else 0.0
    if not (out.shape == want.shape and out.dtype == table.dtype and err <= TOL[dtype]):
        raise AssertionError(
            f"{name}: embedding-bag kernel disagrees with its plain version: "
            f"shape {tuple(out.shape)} vs {tuple(want.shape)}, max_abs_err {err} "
            f"> {TOL[dtype]}"
        )
    if exact and not (torch.equal(out, ref.embedding_bag_ref(table, idx))
                      and torch.equal(out, ref.embedding_bag_split_ref(table, idx, plan.n_split))
                      and torch.equal(out, kernel())):
        raise AssertionError(f"{name}: an integer-valued case is not bit-identical "
                             f"(plain, split version, second launch)")
    nbytes, flops = eb_work(torch, table, idx)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    row = {"case": name, "dtype": dtype, "shape": [list(table.shape), list(idx.shape)],
           "n_split": plan.n_split, "forced": n_split is not None, "exact": exact,
           "grid": list(plan.grid), "block": plan.block,
           "max_abs_err": err, "tol": TOL[dtype], "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if timed:
        lib_idx = idx.clamp_min(0).long()
        weights = (idx >= 0).to(table.dtype)

        def library():
            return torch.nn.functional.embedding_bag(
                lib_idx, table, mode="sum", per_sample_weights=weights)

        lib_err = float((library().float() - want.float()).abs().max().item())
        row["ms"] = timer.ms(kernel)
        row["plain_ms"] = timer.ms(lambda: ref.embedding_bag_ref(table, idx), reps=10)
        row["library_ms"] = timer.ms(library)
        row["library_max_abs_err"] = lib_err
        row["GB_per_s"] = nbytes / row["ms"] / 1e6
        row["share_of_bound"] = bound_ms / row["ms"]
    log("eb-parity", json.dumps(row))
    return row


def random_bags(torch, gen, rows, batch, bag, mean_len):
    """(batch, bag) int32 row ids on the card, each bag ``1 + Poisson(mean_len
    - 1)`` ids long (at most ``bag``) and -1 padded after."""
    ids = torch.randint(0, rows, (batch, bag), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    lens = (1 + torch.poisson(torch.full((batch,), mean_len - 1.0, device=DEVICE),
                              generator=gen)).clamp_max(bag)
    pos = torch.arange(bag, device=DEVICE)[None, :]
    return torch.where(pos < lens[:, None], ids, torch.full_like(ids, -1))


def phase_embedding_bag(torch, timer) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    # tests/test_kernels.py's shapes (rows, D, B, K), last column padding,
    # at the rule's split and forced splits against the split version
    for rows, dim, batch, bag in [(64, 128, 4, 8), (100, 128, 2, 5),
                                  (257, 256, 8, 16), (16, 512, 1, 3)]:
        for dtype in dtypes:
            table = torch.randn((rows, dim), generator=gen, device=DEVICE).to(dtype)
            idx = torch.randint(0, rows, (batch, bag), generator=gen, device=DEVICE,
                                dtype=torch.int32)
            idx[:, -1] = -1
            for n_split in (None, *EB_SPLITS):
                eb_parity(torch, timer, "small", table, idx, n_split=n_split)
    # the main-path shape: one dlrm-recross table at the kernel's 128 columns
    table = torch.randn((ROWS, PADDED_DIM), generator=gen, device=DEVICE)
    idx = random_bags(torch, gen, ROWS, BATCH_SIZE, MAX_BAG, 32.0)
    row = eb_parity(torch, timer, "main-path", table, idx, timed=True)
    timed = [row, eb_parity(torch, timer, "main-path/bf16", table.bfloat16(), idx,
                            timed=True)]
    for n_split in EB_SPLITS:
        eb_parity(torch, timer, "main-path/split", table, idx, n_split=n_split)
    # padding inside bags, an out-of-range id clamped to the last row
    holes = torch.where(torch.rand(idx.shape, generator=gen, device=DEVICE) < 0.25,
                        torch.full_like(idx, -1), idx)
    holes[:, 0] = ROWS + 7
    for dtype in dtypes:
        eb_parity(torch, timer, "main-path/holes", table.to(dtype), holes)
    # integer-valued tables (|sums| <= 192, exact in every dtype): the same
    # bits as the plain and split versions and a second launch, at every split
    ints = torch.randint(-3, 4, (ROWS, PADDED_DIM), generator=gen, device=DEVICE)
    for dtype in dtypes:
        for n_split in (None, *EB_SPLITS):
            eb_parity(torch, timer, "exact/main-path", ints.to(dtype), idx,
                      n_split=n_split, exact=True)
    del ints
    try:
        embedding_bag_cuda(table, idx.long())
    except TypeError:
        pass
    else:
        raise AssertionError("embedding_bag_cuda took int64 indices on the card")
    # the launch's fixed cost: the same grid with every id padding
    timed.append(eb_parity(torch, timer, "main-path/all-padding", table,
                           torch.full_like(idx, -1), timed=True))
    # a batched serving shape, where bandwidth and not latency is the limit
    big = random_bags(torch, gen, ROWS, EB_LARGE, MAX_BAG, 32.0)
    timed.append(eb_parity(torch, timer, "large", table, big, timed=True))
    del big
    # gradient: the op's index_add_ backward vs autograd through the plain
    # version (both f32 atomics, in different orders)
    g = torch.randn((BATCH_SIZE, PADDED_DIM), generator=gen, device=DEVICE)
    leaf = table.requires_grad_(True)
    (d_op,) = torch.autograd.grad(ops.embedding_bag(leaf, idx), leaf, g)
    (d_ref,) = torch.autograd.grad(ref.embedding_bag_ref(leaf, idx), leaf, g)
    grad_err = float((d_op - d_ref).abs().max().item())
    if grad_err > TOL["float32"]:
        raise AssertionError(f"embedding-bag gradient disagrees: {grad_err}")
    log(f"eb-grad: main-path d_table max_abs_err {grad_err}")
    row["grad_max_abs_err"] = grad_err
    del table, leaf, d_op, d_ref, g
    torch.cuda.empty_cache()
    # token-embedding gather: chatglm3-6b's vocabulary and width in bf16,
    # bags of one id (the reference's second role for this kernel)
    vocab, width, tokens = ONEHOT
    table = torch.randn((vocab, width), generator=gen, device=DEVICE).bfloat16()
    idx = torch.randint(0, vocab, (tokens, 1), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    timed.append(eb_parity(torch, timer, "onehot-wide", table, idx, timed=True))
    del table, idx
    torch.cuda.empty_cache()
    for r in timed:
        log(f"eb-timed: {r['case']} {r['dtype']} kernel {r['ms']:.5f} ms, bound "
            f"{r['bound_ms']:.5f} ({r['share_of_bound']:.1%}), plain {r['plain_ms']:.5f}, "
            f"F.embedding_bag {r['library_ms']:.5f}, n_split {r['n_split']}")
    return row


def phase_dlrm(torch, np, timer, server, tables, histories) -> dict:
    """DLRM forward and SGD training at dlrm-recross FULL width on the
    serving phase's layouts and tables (no second plan build)."""
    from repro_torch.configs.dlrm_recross import FULL
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.launch import train_dlrm as tl
    from repro_torch.models.dlrm import build_images, dlrm_forward, init_dlrm

    cfg = dataclasses.replace(FULL, num_tables=len(server.names))
    if cfg.num_tables != FULL.num_tables:
        log(f"dlrm: CUT num_tables {FULL.num_tables} -> {cfg.num_tables} (serving's cut)")
    names = [f"t{t}" for t in range(cfg.num_tables)]
    if sorted(names) != server.names or cfg.rows_per_table != ROWS:
        raise AssertionError(f"serving tables {server.names} are not DLRM's {names}")
    if cfg.embed_dim != EMBED_DIM or cfg.max_bag != MAX_BAG:
        raise AssertionError("serving's tables are not dlrm-recross FULL width")
    kcfg = dataclasses.replace(cfg, embedding_path="kernel")
    dcfg = dataclasses.replace(cfg, embedding_path="dense")
    torch.cuda.reset_peak_memory_stats()

    # serving's 128-wide tables are zero past column 64: the naive path's
    # padded tables; their first 64 columns are DLRM's logical tables.
    # Serving is done with them, so they are scaled in place from N(0, 1)
    # to init_dlrm's N(0, 0.01²): N(0, 1) rows summed over ~32 lookups give
    # interaction logits in the thousands, which SGD at lr 1e-2 blows up.
    t0 = time.perf_counter()
    params = init_dlrm(torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE)
    for n in names:
        tables[n].mul_(0.01)
    params["tables"] = {n: tables[n][:, :EMBED_DIM].contiguous() for n in names}
    layouts = {n: dataclasses.replace(server.layouts[server.names.index(n)], dim=EMBED_DIM)
               for n in names}
    images = build_images(params, cfg, layouts)
    tr = tl.trainable_set(params, images)
    images = tr["images"]
    setup_s = time.perf_counter() - t0
    image_bytes = sum(v.numel() * v.element_size() for v in images.values())
    log(f"dlrm: images {image_bytes} B for {cfg.num_tables} tables built in {setup_s:.2f} s")

    rng = np.random.default_rng(0)
    batches = {}

    def batch_fn(step):
        if step not in batches:
            lo = step * BATCH_SIZE
            qs = {n: [q[:MAX_BAG] for q in histories[n][lo:lo + BATCH_SIZE]] for n in names}
            dense = rng.normal(size=(BATCH_SIZE, cfg.dense_features)).astype(np.float32)
            batches[step] = (qs, dense, tl.ctr_labels(qs, dense))
        return batches[step]

    crossbar_reduce_cuda.launches = 0
    embedding_bag_cuda.launches = 0
    qs, dense_np, labels_np = batch_fn(0)
    dense = torch.from_numpy(dense_np).to(DEVICE)
    labels = torch.from_numpy(labels_np).to(DEVICE)
    sparse = tl.compile_sparse(layouts, qs, device=DEVICE)
    idx = {n: torch.from_numpy(tl.bag_indices(qs[n], MAX_BAG)).to(DEVICE) for n in names}

    # a. naive (embedding-bag kernel on the padded table) == ReCross
    # (crossbar kernel on the image) == the dense path, per table
    errs = {"naive_vs_dense": 0.0, "recross_vs_dense": 0.0, "naive_vs_recross": 0.0}
    with torch.no_grad():
        for n in names:
            naive = ops.embedding_bag(tables[n], idx[n])[:, :EMBED_DIM]
            recross = ops.crossbar_reduce(images[n], *sparse[n])[:, :EMBED_DIM]
            take = params["tables"][n][idx[n].long().clamp(0, ROWS - 1)]
            dense_e = (take * (idx[n] >= 0)[..., None]).sum(dim=1)
            for key, a, b in (("naive_vs_dense", naive, dense_e),
                              ("recross_vs_dense", recross, dense_e),
                              ("naive_vs_recross", naive, recross)):
                errs[key] = max(errs[key], float((a - b).abs().max().item()))
        # b. logits of the kernel path == the dense path
        p = {"tables": params["tables"], "bottom": tr["bottom"], "top": tr["top"]}
        logits_k = dlrm_forward(p, kcfg, dense, sparse, images=images)
        logits_d = dlrm_forward(p, dcfg, dense, idx)
        errs["logits_kernel_vs_dense"] = float((logits_k - logits_d).abs().max().item())
    # c. loss and every gradient: kernels vs autograd through the plain versions
    leaves = tl.leaves(tr)
    loss_k, _ = tl.loss_and_logits(tr, kcfg, dense, sparse, labels)
    grads_k = torch.autograd.grad(loss_k, leaves)

    def plain_crossbar(image, tile_ids, bitmaps, dynamic_switch=True):
        return ref.crossbar_reduce_ref(image, tile_ids, bitmaps)

    with mock.patch.object(ops, "crossbar_reduce", plain_crossbar):
        loss_p, _ = tl.loss_and_logits(tr, kcfg, dense, sparse, labels)
        grads_p = torch.autograd.grad(loss_p, leaves)
    errs["loss"] = abs(loss_k.item() - loss_p.item())
    errs["grads"] = max(float((a - b).abs().max().item()) for a, b in zip(grads_k, grads_p))
    del grads_k, grads_p, loss_k, loss_p
    torch.cuda.synchronize()
    log("dlrm-checks", json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= TOL["float32"]}
    if bad:
        raise AssertionError(f"dlrm step-0 checks past {TOL['float32']}: {bad}")

    launches0 = crossbar_reduce_cuda.launches
    stats = tl.train(kcfg, layouts, tr, batch_fn, TRAIN_STEPS, lr=LR, device=DEVICE,
                     log_every=5)
    torch.cuda.synchronize()
    crossbar_launches = crossbar_reduce_cuda.launches
    eb_launches = embedding_bag_cuda.launches
    if not all(np.isfinite(stats.losses)):
        raise AssertionError(f"non-finite DLRM loss: {stats.losses}")
    if crossbar_launches <= 0 or eb_launches <= 0:
        raise AssertionError(f"dlrm ran crossbar {crossbar_launches} and embedding-bag "
                             f"{eb_launches} kernel launches")

    # the same batch: the naive datapath over 8 tables vs ReCross over 8 images
    with torch.no_grad():
        eb_ms = timer.ms(lambda: [embedding_bag_cuda(tables[n], idx[n]) for n in names])
        xb_ms = timer.ms(lambda: [crossbar_reduce_cuda(images[n].detach(), *sparse[n])
                                  for n in names])
    step_ms = np.asarray(stats.step_s) * 1e3
    out = {
        "tables": cfg.num_tables, "rows": cfg.rows_per_table, "embed_dim": cfg.embed_dim,
        "bottom_mlp": list(cfg.bottom_mlp), "top_mlp": list(cfg.top_mlp),
        "batch": BATCH_SIZE, "max_bag": MAX_BAG, "steps": TRAIN_STEPS, "lr": LR,
        "max_tiles_step0": {n: int(sparse[n][0].shape[1]) for n in names},
        "setup_s": setup_s, "checks": errs,
        "loss_first": stats.losses[0], "loss_last": stats.losses[-1],
        "step_p50_ms": float(np.percentile(step_ms, 50)),
        "step_p99_ms": float(np.percentile(step_ms, 99)),
        "host_compile_s": float(np.sum(stats.compile_s)),
        "host_compile_p50_ms": float(np.percentile(stats.compile_s, 50)) * 1e3,
        "crossbar_launches": crossbar_launches,
        "crossbar_launches_per_step_fwd": (crossbar_launches - launches0) / TRAIN_STEPS,
        "embedding_bag_launches": eb_launches,
        "image_bytes": image_bytes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "naive_8_tables_ms": eb_ms, "recross_8_images_ms": xb_ms,
    }
    log("dlrm", json.dumps(out))
    return out


def _dcnv2_bags(np, rng, rows, bag, n):
    """``n`` bags of ``min(bag, rows)`` distinct sorted ids."""
    return [np.sort(rng.choice(rows, size=min(bag, rows), replace=False)) for _ in range(n)]


def phase_dcnv2(torch, np) -> dict:
    """MLPerf's DLRM-DCNv2 scored on the card: ``server.serve(request)``
    then ``dlrm_forward(..., "served")`` at ``one_card()``'s widths, its
    rows capped at ``DCNV2_MAX_ROWS``, against the plain reference."""
    sys.path.insert(0, str(ROOT))
    from recbench import dcnv2_reference
    from repro_torch.configs import dlrm_dcnv2
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.models.dlrm import dlrm_forward, init_dlrm
    from repro_torch.serve import ShardedEmbeddingServer

    one = dlrm_dcnv2.one_card()
    cfg = dataclasses.replace(one, embedding_path="served",
                              table_rows=tuple(min(r, DCNV2_MAX_ROWS) for r in one.table_rows))
    names = [f"t{t}" for t in range(cfg.num_tables)]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_dlrm(gen, cfg, device=DEVICE)
    # N(0, 1) tables, as the benchmark's: the cross layers' products of
    # N(0, 0.01²) rows would leave the logits to the bottom MLP
    params["tables"] = {n: torch.randn(t.shape, generator=gen, device=DEVICE)
                        for n, t in params["tables"].items()}
    rng = np.random.default_rng(0)
    histories = {n: _dcnv2_bags(np, rng, cfg.rows_of(t), cfg.bag_sizes[t], DCNV2_HISTORY)
                 for t, n in enumerate(names)}
    t0 = time.perf_counter()
    server = ShardedEmbeddingServer(params["tables"], histories, num_shards=1,
                                    q_block=Q_BLOCK, group_size=cfg.group_size,
                                    batch_size=BATCH_SIZE, combine_chunks=2,
                                    dynamic_switch=True, device=DEVICE)
    plan_s = time.perf_counter() - t0

    launches0 = crossbar_reduce_cuda.launches
    serve_ms, dense_ms, rel, top = [], [], 0.0, 0.0
    for _ in range(DCNV2_REQUESTS):
        request = {n: _dcnv2_bags(np, rng, cfg.rows_of(t), cfg.bag_sizes[t], DCNV2_BATCH)
                   for t, n in enumerate(names)}
        dense = torch.from_numpy(
            rng.standard_normal((DCNV2_BATCH, cfg.dense_features), dtype=np.float32)).to(DEVICE)
        t0 = time.perf_counter()
        pooled = server.serve(request)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            got = dlrm_forward(params, cfg, dense, pooled)
        torch.cuda.synchronize()
        serve_ms.append((t1 - t0) * 1e3)
        dense_ms.append((time.perf_counter() - t1) * 1e3)
        want = dcnv2_reference.forward(params, dense, request)
        if got.shape != (DCNV2_BATCH,) or not torch.isfinite(got).all():
            raise AssertionError(f"dcnv2: bad logits {tuple(got.shape)}")
        scale = float(want.double().abs().max())
        top = max(top, scale)
        rel = max(rel, float((got.double() - want.double()).abs().max()) / scale)
    launches = crossbar_reduce_cuda.launches - launches0
    server.close()
    out = {
        "tables": cfg.num_tables, "rows": sum(cfg.table_rows), "embed_dim": cfg.embed_dim,
        "cross_width": cfg.top_in, "low_rank": cfg.dcn_low_rank_dim,
        "requests": DCNV2_REQUESTS, "samples": DCNV2_BATCH, "plan_build_s": plan_s,
        "largest_logit": top, "rel_err": rel, "rel_tol": DCNV2_REL_TOL,
        "serve_p50_ms": float(np.median(serve_ms)), "dense_p50_ms": float(np.median(dense_ms)),
        "kernel_launches": launches,
    }
    log("dcnv2", json.dumps(out))
    if not rel <= DCNV2_REL_TOL or top <= 1.0:
        raise AssertionError(f"dcnv2: logits {rel} of the largest {top} from the reference")
    if launches <= 0:
        raise AssertionError("dcnv2 ran no crossbar kernel launch")
    return out


def da_case(torch, gen, b, S, kvh, g, hd, dtype):
    """Random decode-attention inputs on the card: int8 K/V entries with
    per-(position, head) scales, as the cache holds them; q and scales in
    ``dtype``."""
    q = (4 * torch.randn((b, kvh, g, hd), generator=gen, device=DEVICE)).to(dtype)
    k_q = torch.randint(-127, 128, (b, S, kvh, hd), generator=gen, device=DEVICE,
                        dtype=torch.int8)
    v_q = torch.randint(-127, 128, (b, S, kvh, hd), generator=gen, device=DEVICE,
                        dtype=torch.int8)
    k_s = ((torch.rand((b, S, kvh), generator=gen, device=DEVICE) + 0.5) / 127).to(dtype)
    v_s = ((torch.rand((b, S, kvh), generator=gen, device=DEVICE) + 0.5) / 127).to(dtype)
    return q, k_q, k_s, v_q, v_s


def da_work(q, k_q, k_s, v_q, v_s, length):
    """Least bytes and operations of one decode-attention call at this
    length: the int8 rows and scales of the positions the result depends
    on (all S at length 0, where every weight is 1) read once, q read
    once, out, m and l written once; 4·g·hd flop a position and row."""
    b, S, kvh, hd = k_q.shape
    g = q.shape[2]
    n = S if length <= 0 else min(length, S)
    nbytes = (2 * b * n * kvh * (hd + k_s.element_size()) + q.numel() * q.element_size()
              + 4 * b * kvh * g * (hd + 2) + 4)
    return nbytes, 4 * b * kvh * g * n * hd


def da_errs(got, want) -> dict:
    """``DA_TOL``'s three errors of ``(out, m, l)`` against ``want``, in
    f64: m absolute; l and out / l relative to 1 + |want|."""
    out, m, l = (x.double() for x in got)
    out_r, m_r, l_r = (x.double() for x in want)
    o, o_r = out / l[..., None], out_r / l_r[..., None]
    return {"m": float((m - m_r).abs().max().item()),
            "l": float(((l - l_r).abs() / (1 + l_r.abs())).max().item()),
            "out": float(((o - o_r).abs() / (1 + o_r.abs())).max().item())}


def da_parity(torch, name, inputs, length, n_split=None, ref_dtype=None) -> dict:
    """Decode-attention kernel vs its plain version on the card; raises
    past the JAX kernel test's tolerances.  ``n_split`` forces the
    kernel's S splits (``None``: the wrapper's host rule); ``ref_dtype``
    evaluates the plain version in another precision than f32."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import fused_decode_attention_cuda

    ln = torch.tensor(length, dtype=torch.int32, device=DEVICE)
    S = inputs[1].shape[1]
    out, m, l = fused_decode_attention_cuda(*inputs, ln, block_s=512 if S % 512 == 0 else S,
                                            n_split=n_split)
    torch.cuda.synchronize()
    out_r, m_r, l_r = ref.fused_decode_attention_ref(*inputs, ln, dtype=ref_dtype or torch.float32)
    errs = da_errs((out, m, l), (out_r, m_r, l_r))
    row = {"case": name, "shape": list(inputs[1].shape), "g": inputs[0].shape[2],
           "dtype": str(inputs[0].dtype).removeprefix("torch."), "length": length,
           "n_split": n_split, "ref_dtype": str(out_r.dtype).removeprefix("torch."),
           "max_abs_err": float((out / l[..., None] - out_r / l_r[..., None]).abs().max().item()),
           "errs": errs}
    bad = {k: v for k, v in errs.items() if not v <= DA_TOL[k]}
    if bad or out.shape != out_r.shape:
        raise AssertionError(f"{name}: decode-attention kernel disagrees with its plain "
                             f"version past {DA_TOL}: {row}")
    return row


def da_sdpa(torch, q, k_q, k_s, v_q, v_s, length):
    """``F.scaled_dot_product_attention`` over a bf16 copy of the
    dequantized cache's first ``length`` positions (GQA as a batch): the
    library yardstick, which the port never calls.  Returns the callable
    and the bytes it reads."""
    n = k_q.shape[1] if length <= 0 else min(length, k_q.shape[1])
    kb = (k_q[:, :n].float() * k_s[:, :n].float()[..., None]).to(torch.bfloat16)
    vb = (v_q[:, :n].float() * v_s[:, :n].float()[..., None]).to(torch.bfloat16)
    kb, vb = kb.transpose(1, 2).contiguous(), vb.transpose(1, 2).contiguous()
    qb = q.to(torch.bfloat16)

    def library():  # (b, kvh, g, hd) queries over (b, kvh, n, hd) keys
        return torch.nn.functional.scaled_dot_product_attention(qb, kb, vb)

    return library, 2 * kb.numel() * kb.element_size()


def da_library(torch, timer, row, inputs, length) -> None:
    """Adds SDPA's time on the kernel's inputs to ``row`` (:func:`da_sdpa`),
    with the bytes it reads and its distance from the kernel's output."""
    from repro_torch.kernels.decode_attention import fused_decode_attention_cuda

    lib_fn, row["library_bytes"] = da_sdpa(torch, *inputs, length)
    ln = torch.tensor(length, dtype=torch.int32, device=DEVICE)
    out, _, l = fused_decode_attention_cuda(*inputs, ln)
    row["library_max_abs_err"] = float((lib_fn().float() - out / l[..., None]).abs().max().item())
    row["library_ms"] = timer.ms(lib_fn)


def da_device_us(torch, timer, fn, reps: int = 10) -> dict:
    """Median device time (µs) of each kernel ``fn`` launches, from
    ``torch.profiler``, each call after the timer's L2 scrub; with two
    kernels, also the span from the first's start to the second's end."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.scrub.zero_()
            fn()
        torch.cuda.synchronize()
    ours = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "decode_attention" in e.name), key=lambda e: e.time_range.start)
    if not ours:
        return {"note": "not measured (no CUDA events in the trace)"}
    per = len(ours) // reps
    out = {}
    for e in ours:
        key = "merge_kernel" if "merge" in e.name else "split_kernel"
        out.setdefault(key, []).append(e.time_range.elapsed_us())
    out = {k: statistics.median(v) for k, v in out.items()}
    if per == 2:
        out["span"] = statistics.median(ours[i + 1].time_range.end - ours[i].time_range.start
                                        for i in range(0, len(ours) - 1, 2))
    return out


def da_timed(torch, timer, name, inputs, length) -> dict:
    """Parity, then the kernel's time (split kernel and merge together)
    beside its bound, its plain version and SDPA, with the split count
    the host rule gave and the device kernels a call launches.  Parity
    here is against the plain version in f64: at ``decode_32k`` the f32
    plain version's own rounding of ``m`` comes near ``DA_TOL``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import decode_attention as kda

    row = da_parity(torch, name, inputs, length, ref_dtype=torch.float64)
    torch.cuda.empty_cache()
    b, S, kvh, _ = inputs[1].shape
    ln = torch.tensor(length, dtype=torch.int32, device=DEVICE)
    n_split = kda.choose_n_split(b, kvh, S, torch.cuda.get_device_properties(0).multi_processor_count)
    nbytes, flops = da_work(*inputs, length)
    # the products' inputs are bf16 (q, scales) and int8, on the tensor
    # cores: the work is bound by bytes; the f32 CUDA-core floor of PR 13's
    # kernel is reported beside it
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    row.update(n_split=n_split, kernels_per_call=kda.kernels_per_call(n_split),
               bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
               f32_ops_ms=flops / PEAK_FLOPS["float32"] * 1e3)
    row["ms"] = timer.ms(lambda: kda.fused_decode_attention_cuda(*inputs, ln))
    row["ms_one_split"] = timer.ms(lambda: kda.fused_decode_attention_cuda(*inputs, ln, n_split=1))
    row["device_us"] = da_device_us(torch, timer, lambda: kda.fused_decode_attention_cuda(*inputs, ln))
    row["plain_ms"] = timer.ms(lambda: ref.fused_decode_attention_ref(*inputs, ln), reps=5)
    da_library(torch, timer, row, inputs, length)
    row["GB_per_s"] = nbytes / row["ms"] / 1e6
    log(f"da-{name}", json.dumps(row))
    return row


def phase_decode_kernel(torch, timer) -> dict:
    """The flash-decode kernel against its plain version at every forced
    split count and the host rule's, then timed at one decode_32k layer
    and at the served shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    shapes = [(1, 256, 1, 1, 128), (2, 1024, 2, 4, 128), (2, 512, 4, 2, 64),
              (1, 512, 2, 8, 256), (LM_SLOTS, LM_MAX_SEQ, 2, 16, 128),
              (*LM_TRAIN_SERVE[:2], 2, 16, 128),
              # lm-families: granite-moe served, musicgen, grok-1, command-r
              (*MOE_SERVE[:2], 8, 3, 64), (*AUDIO_DECODE[:2], 24, 1, 64),
              (2, 1024, 8, 6, 128), (2, 1024, 8, 8, 128)]
    worst, cases = 0.0, 0
    for b, S, kvh, g, hd in shapes:
        lengths = [0, 1, S // 3 + 7, S]
        if (b, S) == (LM_SLOTS, LM_MAX_SEQ):   # the lengths LM serving reaches
            lengths += [64, 65, LM_SERVED_LEN]
        if (b, S, hd) == (*LM_TRAIN_SERVE[:2], 128):   # those lm-train's serving reaches
            lengths += [15, 16, 31, 32]
        if (b, S, kvh) == (*MOE_SERVE[:2], 8):  # granite-moe's: prompts, then decode
            lengths += [15, 16, 63, 64, 79, 80]
        if (b, S, kvh) == (*AUDIO_DECODE[:2], 24):   # musicgen's 32 steps
            lengths += [15, 16, 31]
        for dtype in (torch.float32, torch.bfloat16):
            inputs = da_case(torch, gen, b, S, kvh, g, hd, dtype)
            for length in lengths:
                for n_split in DA_SPLITS:
                    row = da_parity(torch, f"{b}x{S}x{kvh}x{g}x{hd}", inputs, length, n_split)
                    worst = max(worst, row["max_abs_err"])
                    cases += 1
        log("da-parity", json.dumps(row))
    log(f"da-parity: {cases} cases ({len(shapes)} shapes x 2 dtypes x 4-10 lengths x "
        f"n_split {DA_SPLITS}) passed, max_abs_err (out/l) {worst}")

    # the served shape at the length serving ends at, bf16 (the cache's)
    inputs = da_case(torch, gen, LM_SLOTS, LM_MAX_SEQ, 2, 16, 128, torch.bfloat16)
    served = da_timed(torch, timer, "served-shape", inputs, LM_SERVED_LEN)
    # one decode_32k layer, full length, bf16 q and scales
    b, S, kvh, g, hd = DECODE_32K
    inputs = da_case(torch, gen, b, S, kvh, g, hd, torch.bfloat16)
    row = da_timed(torch, timer, "decode_32k", inputs, S)
    row["served_shape"] = {k: served[k] for k in (
        "n_split", "kernels_per_call", "ms", "ms_one_split", "device_us", "bound_ms",
        "GB_per_s", "plain_ms", "library_ms")}
    del inputs
    torch.cuda.empty_cache()
    return row


def plain_decode_attention(q, k_q, k_s, v_q, v_s, length, *, block_s=512):
    """The flash-decode wrapper's signature over its plain version: patched
    in for ``fused_decode_attention_cuda`` to run a model without the
    kernel."""
    from repro_torch.kernels import ref

    return ref.fused_decode_attention_ref(q, k_q, k_s, v_q, v_s, length)


def lm_logits(torch, np, params, cfg, cache, tokens) -> list:
    """float32 logits of successive decode steps over ``tokens``."""
    from repro_torch.serve.decode import decode_step

    out = []
    for t in range(tokens.shape[0]):
        logits, _ = decode_step(params, cfg, torch.from_numpy(tokens[t]).to(DEVICE), cache)
        out.append(logits[:, -1, :cfg.vocab_size].float())
    return out


def profiled(torch, fn, steps) -> dict:
    """``fn()`` ``steps`` times under ``torch.profiler``: device time summed
    over the CUDA kernels, the wall of the window (synchronized), the
    host's top-level operator calls and the kernels that took the most
    device time.  The profiler slows the host, so the idle share read
    here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host_ops = sum(1 for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU and e.cpu_parent is None)
    by_name = {}  # summed over the kernels whose names share their first 60 characters
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    out = {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
           "host_ops_per_step": host_ops / steps,
           "kernels_per_step": len(kernels) / steps}
    if kernels:
        out.update(device_busy_ms_per_step=busy_us / steps / 1e3,
                   device_idle_share=1.0 - busy_us / wall_us,
                   top_kernels_ms_per_step={
                       k: v / steps / 1e3
                       for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]})
    else:
        out["device_busy_ms_per_step"] = "not measured (no CUDA events in the trace)"
    return out


def profile_decode(torch, params, cfg, cache, steps) -> dict:
    """``steps`` decode steps of every slot under ``torch.profiler``."""
    from repro_torch.serve.decode import decode_step

    tokens = torch.ones((cache["k"].shape[1], 1), dtype=torch.int32, device=DEVICE)
    return profiled(torch, lambda: decode_step(params, cfg, tokens, cache), steps)


def phase_lm(torch, np, timer) -> dict:
    """chatglm3-6b FULL decode with an int8 cache through the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.launch import serve as ls
    from repro_torch.models.layers import count_params, tree_leaves
    from repro_torch.serve.kvcache import cache_bytes, init_cache

    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    t0 = time.perf_counter()
    params, cache = ls.build(cfg, LM_SLOTS, LM_MAX_SEQ, kv_int8=True, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    log(f"lm: {cfg.name} FULL {count_params(params)} parameters, {weight_bytes} B, "
        f"drawn in {init_s:.2f} s")

    # checks on fresh caches: kernel vs plain version (4 steps), int8 vs
    # bf16 cache (8 steps); step 0 has length 0 (the -1e30 sentinel path)
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(LM_QUANT_STEPS, LM_SLOTS, 1)).astype(np.int32)
    with torch.no_grad():
        kernel = lm_logits(torch, np, params, cfg, init_cache(
            cfg, LM_SLOTS, LM_MAX_SEQ, quant=True, device=DEVICE), tokens)

        with mock.patch.object(kda, "fused_decode_attention_cuda", plain_decode_attention):
            plain_logits = lm_logits(torch, np, params, cfg, init_cache(
                cfg, LM_SLOTS, LM_MAX_SEQ, quant=True, device=DEVICE),
                tokens[:LM_PLAIN_STEPS])
        bf16 = lm_logits(torch, np, params, cfg, init_cache(
            cfg, LM_SLOTS, LM_MAX_SEQ, quant=False, device=DEVICE), tokens)
    kernel_vs_plain = max(float((a - b).abs().max().item())
                          for a, b in zip(kernel, plain_logits))
    scale = max(float(x.abs().max().item()) for x in bf16)
    int8_vs_bf16 = max(float((a - b).abs().max().item()) for a, b in zip(kernel, bf16))
    finite = all(bool(torch.isfinite(x).all()) for x in kernel + bf16)
    checks = {"kernel_vs_plain_max_abs": kernel_vs_plain, "kernel_vs_plain_tol": TOL["bfloat16"],
              "int8_vs_bf16_max_abs": int8_vs_bf16, "bf16_logit_scale": scale,
              "int8_vs_bf16_tol": LM_QUANT_TOL * max(scale, 1.0), "finite": finite}
    log("lm-checks", json.dumps(checks))
    if not (finite and kernel_vs_plain <= TOL["bfloat16"]
            and int8_vs_bf16 < LM_QUANT_TOL * max(scale, 1.0)):
        raise AssertionError(f"lm checks failed: {checks}")
    del kernel, plain_logits, bf16

    # serving through launch.serve's functions, launches counted over it
    requests = ls.make_requests(cfg, LM_REQUESTS, LM_PROMPT, LM_NEW)
    kda.fused_decode_attention_cuda.launches = 0
    with torch.no_grad():
        report = ls.serve(params, cfg, cache, requests)
    launches = kda.fused_decode_attention_cuda.launches
    step_ms = report.pop("step_ms")
    lengths_ok = all(len(r.generated) == LM_NEW for r in requests)
    if not (report["completed"] == LM_REQUESTS and lengths_ok
            and launches == cfg.num_layers * report["steps"]):
        raise AssertionError(f"lm serving: {report}, launches {launches}")

    # the kernel at the served shape and the cache length serving ended at
    length = int(cache["len"].item())
    layer = (cache["k"][0], cache["k_scale"][0], cache["v"][0], cache["v_scale"][0])
    qg = torch.randn((LM_SLOTS, cfg.kv_heads, cfg.q_per_kv, cfg.resolved_head_dim),
                     generator=gen, device=DEVICE).to(torch.bfloat16)
    served = da_parity(torch, "served-layer", (qg, layer[0], layer[1], layer[2], layer[3]),
                       length)
    ln = torch.tensor(length, dtype=torch.int32, device=DEVICE)
    served["ms"] = timer.ms(lambda: kda.fused_decode_attention_cuda(
        qg, layer[0], layer[1], layer[2], layer[3], ln))
    served["n_split"] = kda.choose_n_split(
        LM_SLOTS, cfg.kv_heads, LM_MAX_SEQ, torch.cuda.get_device_properties(0).multi_processor_count)
    served["kernels_per_call"] = kda.kernels_per_call(served["n_split"])
    nbytes, flops = da_work(qg, *layer, length)
    served["bound_ms"], served["bound_by"] = bound(nbytes, flops, "bfloat16")
    da_library(torch, timer, served, (qg, *layer), length)
    log("da-served", json.dumps(served))
    with torch.no_grad():
        prof = profile_decode(torch, params, cfg, cache, LM_PROFILE_STEPS)
    log("lm-profile", json.dumps(prof))

    stats = dict(report)
    stats.update(
        arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, slots=LM_SLOTS,
        max_seq=LM_MAX_SEQ, prompt=LM_PROMPT, new=LM_NEW, init_s=init_s,
        weight_bytes=weight_bytes, cache_bytes=cache_bytes(cache),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        kernel_launches=launches, launches_per_step=launches / report["steps"],
        final_len=length, step_mean_ms=float(np.mean(step_ms)),
        step_first_ms=step_ms[0], checks=checks,
        served_kernel_ms=served["ms"], served_kernel_bound_ms=served["bound_ms"],
        served_library_ms=served["library_ms"],
        profile=prof,
    )
    log("lm", json.dumps(stats))
    return stats


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms(True)`` for the block (it needs
    ``CUBLAS_WORKSPACE_CONFIG``, set before the first cuBLAS call); every
    output is written in full, so uninitialized memory is not filled."""
    import torch.utils.deterministic as td

    fill = td.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    td.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        td.fill_uninitialized_memory = fill


def within(torch, got, want, atol, rtol) -> tuple[bool, float]:
    """``|got - want| <= atol + rtol·|want|`` everywhere, and the largest
    absolute error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def lm_train_card_vs_cpu(torch) -> dict:
    """The smoke config in f32: the same ``init_lm`` parameters (drawn on
    the CPU) and ``TokenBatcher`` batches, ``LM_TRAIN_CPU_STEPS`` AdamW
    steps through ``launch.train.train`` on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.launch import train as lt
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.optimizer import AdamW, make_schedule
    from repro_torch.train.tree import flatten_with_names

    cfg = get_config(LM_ARCH, smoke=True)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    finals, losses = {}, {}
    for device in (DEVICE, "cpu"):
        opt = AdamW(schedule=make_schedule("cosine", 3e-3, 10))
        state = init_train_state(tree_map(lambda t: t.to(device), params), opt)
        state, rep = lt.train(cfg, opt, TokenBatcher(cfg.vocab_size, 8, 64, seed=0),
                              LM_TRAIN_CPU_STEPS, device=device, state=state,
                              log=lambda *_: None)
        finals[device] = dict(flatten_with_names(state.params))
        losses[device] = [r["loss"] for r in rep["steps"]]
    worst, ok = 0.0, True
    for name, t in finals[DEVICE].items():
        good, err = within(torch, t.cpu(), finals["cpu"][name], **STEP_TOL)
        ok, worst = ok and good, max(worst, err)
    out = {"steps": LM_TRAIN_CPU_STEPS, "max_abs_err": worst, "tol": STEP_TOL,
           "loss_card": losses[DEVICE], "loss_cpu": losses["cpu"]}
    if not ok:
        raise AssertionError(f"lm-train: card and CPU disagree at the smoke config: {out}")
    return out


def phase_lm_train(torch, np) -> dict:
    """chatglm3-6b at its published widths and ``LM_TRAIN_LAYERS`` layers,
    trained on the card; see the module docstring, phase 10."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.launch import serve as ls
    from repro_torch.launch import train as lt
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import (apply_norm, cast_floats, count_params, tree_leaves,
                                           tree_map)
    from repro_torch.models.transformer import CHUNKED_ATTN_THRESHOLD, init_lm, lm_loss
    from repro_torch.serve.kvcache import init_cache
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import run_with_restarts
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW, make_schedule
    from repro_torch.train.tree import flatten_with_names

    cpu_check = lm_train_card_vs_cpu(torch)
    log("lm-train card-vs-cpu", json.dumps(cpu_check))

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_TRAIN_LAYERS)
    t0 = time.perf_counter()
    params0 = init_lm(torch.Generator(device=DEVICE).manual_seed(4), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_copy = tree_map(torch.clone, params0)
    n_params = count_params(params0)
    embed_numel = params0["embed"].numel()
    opt = AdamW(schedule=make_schedule("cosine", LM_TRAIN_LR, LM_TRAIN_STEPS))
    data = TokenBatcher(cfg.vocab_size, *LM_TRAIN_BATCH, seed=0)

    # bf16 against f32: the step-0 loss of the same parameters
    tokens, labels = (torch.from_numpy(a).to(DEVICE) for a in data.batch(0))
    with torch.no_grad():
        loss_bf16 = float(lm_loss(params0, cfg, tokens, labels))
        p32 = cast_floats(params0, torch.float32)
        loss_f32 = float(lm_loss(p32, dataclasses.replace(cfg, dtype="float32"),
                                 tokens, labels))
    del p32
    torch.cuda.empty_cache()
    loss_check = {"loss_bf16": loss_bf16, "loss_f32": loss_f32,
                  "rel": abs(loss_bf16 - loss_f32) / abs(loss_f32), "rtol": LM_TRAIN_LOSS_RTOL}
    log("lm-train bf16-vs-f32", json.dumps(loss_check))
    if not loss_check["rel"] <= LM_TRAIN_LOSS_RTOL:
        raise AssertionError(f"lm-train: bf16 and f32 losses disagree: {loss_check}")

    # chunked against full attention, one layer at full width, forward only
    layer0 = {k: v[0] for k, v in params0["layers"]["attn"].items()}
    x = torch.randn((1, CHUNKED_ATTN_THRESHOLD, cfg.d_model), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(5)).to(cfg.torch_dtype)
    x = apply_norm({"scale": params0["layers"]["norm_attn"]["scale"][0]}, x, cfg.norm)
    kw = dict(num_heads=cfg.num_heads, kv_heads=cfg.kv_heads, head_dim=cfg.resolved_head_dim,
              rope_theta=cfg.rope_theta, rope_partial=cfg.rope_2d)
    with torch.no_grad():
        ok, err = within(torch, attn.chunked_self_attention(layer0, x, **kw),
                         attn.self_attention(layer0, x, **kw), **BF16_TOL)
    chunk_check = {"seq": CHUNKED_ATTN_THRESHOLD, "max_abs_err": err, "tol": BF16_TOL}
    log("lm-train chunked-vs-full", json.dumps(chunk_check))
    if not ok:
        raise AssertionError(f"lm-train: chunked and full attention disagree: {chunk_check}")
    del layer0, x
    torch.cuda.empty_cache()

    # training through the launcher as a user runs it (deterministic
    # algorithms off): steps 0-3, then 4-7 over 2 microbatches
    quiet = lambda *_: None
    state, r1 = lt.train(cfg, opt, data, LM_TRAIN_MB_FROM, device=DEVICE,
                         state=init_train_state(params0, opt), log=quiet)
    state, r2 = lt.train(cfg, opt, data, LM_TRAIN_STEPS, device=DEVICE, state=state,
                         start=LM_TRAIN_MB_FROM, microbatches=2, log=quiet)
    del params0
    state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    # one step at 2 x 4,096 tokens: every block runs chunked_self_attention
    chunked_calls = []
    real_chunked = attn.chunked_self_attention

    def counted_chunked(*a, **kw):
        chunked_calls.append(1)
        return real_chunked(*a, **kw)

    long_data = TokenBatcher(cfg.vocab_size, *LM_TRAIN_LONG, seed=1)
    with mock.patch.object(attn, "chunked_self_attention", counted_chunked):
        state, r3 = lt.train(cfg, opt, long_data, LM_TRAIN_STEPS + 1, device=DEVICE,
                             state=state, start=LM_TRAIN_STEPS, log=quiet)
    peak = torch.cuda.max_memory_allocated()
    # one more step of 8 x 512 tokens in one batch, traced
    held = [state]
    del state
    tk, lb = (torch.from_numpy(a).to(DEVICE) for a in data.batch(LM_TRAIN_STEPS + 1))
    traced_fn = make_train_step(cfg, opt)
    profile = profiled(torch, lambda: held.__setitem__(
        0, traced_fn(held[0], {"tokens": tk, "labels": lb})[0]), 1)
    log("lm-train profile", json.dumps(profile))
    steps = r1["steps"] + r2["steps"] + r3["steps"]
    for r in steps:
        log("lm-train step", json.dumps(r))
    moved = any(not torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_names(held[0].params), flatten_with_names(init_copy)))
    finite = all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps)
    del held, tk, lb
    torch.cuda.empty_cache()
    short_ms = np.asarray([r["ms"] for r in steps[:LM_TRAIN_STEPS]])
    # the FLOPs of the step's products: 6 per matmul parameter and token
    # (the embedding is a gather; an untied head is a product), and the
    # attention's score and value products, 4 forward and 8 backward
    # b·h·s²·hd a layer (the full s x s scores are computed, then masked)
    b, s = LM_TRAIN_BATCH
    matmul_params = n_params - (0 if cfg.tie_embeddings else embed_numel)
    step_flop = (6 * matmul_params * b * s
                 + 12 * cfg.num_layers * b * cfg.num_heads * s * s * cfg.resolved_head_dim)
    train = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": n_params, "init_s": init_s, "train_state_bytes": state_bytes,
        "batch": LM_TRAIN_BATCH, "long_batch": LM_TRAIN_LONG,
        "step_p50_ms": float(np.percentile(short_ms, 50)),
        "step_p99_ms": float(np.percentile(short_ms, 99)),
        "tokens_per_s": float(LM_TRAIN_BATCH[0] * LM_TRAIN_BATCH[1] * LM_TRAIN_STEPS
                              / (short_ms.sum() / 1e3)),
        "long_step_ms": steps[-1]["ms"],
        "long_tokens_per_s": LM_TRAIN_LONG[0] * LM_TRAIN_LONG[1] / (steps[-1]["ms"] / 1e3),
        "matmul_params": matmul_params, "tflop_per_step": step_flop / 1e12,
        "chunked_calls": len(chunked_calls), "max_memory_allocated": peak,
        "finite": finite, "moved": moved, "profile_step": LM_TRAIN_STEPS + 1,
        "profile": profile,
    }
    train["share_of_bf16_peak_at_p50"] = (step_flop / (train["step_p50_ms"] / 1e3)
                                          / PEAK_FLOPS["bfloat16"])
    if not (finite and moved and len(chunked_calls) == cfg.num_layers):
        raise AssertionError(f"lm-train: {train}")

    # the same 8 steps again under deterministic algorithms: the bits the
    # replay below is held to, and the mode's cost on the step
    with deterministic(torch):
        ref_state, d1 = lt.train(cfg, opt, data, LM_TRAIN_MB_FROM, device=DEVICE,
                                 state=init_train_state(init_copy, opt), log=quiet)
        ref_state, d2 = lt.train(cfg, opt, data, LM_TRAIN_STEPS, device=DEVICE,
                                 state=ref_state, start=LM_TRAIN_MB_FROM, microbatches=2,
                                 log=quiet)
    clean = ref_state.params
    del ref_state
    torch.cuda.empty_cache()
    det_ms = np.asarray([r["ms"] for r in d1["steps"] + d2["steps"]])
    train["deterministic_step_p50_ms"] = float(np.percentile(det_ms, 50))
    train["deterministic_step_p99_ms"] = float(np.percentile(det_ms, 99))
    log("lm-train run", json.dumps(train))

    # crash at step 6, restore step 4 from disk, replay: bit-equal to the
    # uninterrupted run above
    ckpt_dir = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free = shutil.disk_usage(ckpt_dir).free
    if free < 2 * state_bytes:
        raise AssertionError(f"lm-train: {free} B free under {ckpt_dir}, the checkpoints "
                             f"need {2 * state_bytes} B")
    step_fns = {1: make_train_step(cfg, opt), 2: make_train_step(cfg, opt, microbatches=2)}
    crashed, saves, restores = [], [], []

    def step_fn(step, st):
        if step == LM_TRAIN_CRASH_AT and not crashed:
            crashed.append(step)
            raise RuntimeError("injected failure")
        tk, lb = (torch.from_numpy(a).to(DEVICE) for a in data.batch(step))
        return step_fns[2 if step >= LM_TRAIN_MB_FROM else 1](
            st, {"tokens": tk, "labels": lb})[0]

    def save_fn(step, st):
        t0 = time.perf_counter()
        handle = ckpt.save_async(str(ckpt_dir), step, st)
        t1 = time.perf_counter()
        handle.wait()
        saves.append({"step": step, "snapshot_s": t1 - t0, "write_s": time.perf_counter() - t1})

    like = None

    def restore_fn():
        latest = ckpt.latest_step(str(ckpt_dir))
        t0 = time.perf_counter()
        st = ckpt.restore(str(ckpt_dir), latest, like, device=DEVICE)
        torch.cuda.synchronize()
        restores.append({"step": latest, "restore_s": time.perf_counter() - t0})
        return latest, st

    start = init_train_state(init_copy, opt)
    like = tree_map(lambda t: torch.empty_like(t, device="meta"), start)
    with deterministic(torch):
        final, rstats = run_with_restarts(step_fn, start, LM_TRAIN_STEPS, save_fn=save_fn,
                                          restore_fn=restore_fn,
                                          save_every=LM_TRAIN_SAVE_EVERY)
    del start, init_copy
    mismatched = [n for (n, a), (_, b) in zip(flatten_with_names(final.params),
                                              flatten_with_names(clean)) if not torch.equal(a, b)]
    replay = {"restarts": rstats["restarts"], "replayed_steps": rstats["replayed_steps"],
              "saves": saves, "restores": restores, "checkpoint_bytes": sum(
                  f.stat().st_size for f in (ckpt_dir / f"step_{LM_TRAIN_STEPS:09d}").iterdir()),
              "train_state_bytes": state_bytes, "disk_free": free,
              "mismatched_leaves": mismatched, "deterministic": True}
    log("lm-train replay", json.dumps(replay))
    if mismatched or rstats["restarts"] != 1 or [r["step"] for r in restores] != [4]:
        raise AssertionError(f"lm-train: the replay differs from the uninterrupted run: {replay}")
    in_memory = final.params
    del final, clean
    torch.cuda.empty_cache()

    # the restored weights served through the flash-decode kernel
    t0 = time.perf_counter()
    restored = ckpt.restore(str(ckpt_dir), LM_TRAIN_STEPS, like, device=DEVICE).params
    torch.cuda.synchronize()
    restore_final_s = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir)
    slots, max_seq, n_req, prompt, new = LM_TRAIN_SERVE
    tokens = np.random.default_rng(6).integers(
        1, cfg.vocab_size, size=(LM_PLAIN_STEPS, slots, 1)).astype(np.int32)

    def steps_of(p):
        return lm_logits(torch, np, p, cfg, init_cache(cfg, slots, max_seq, quant=True,
                                                       device=DEVICE), tokens)

    with torch.no_grad():
        logits = [steps_of(p) for p in (restored, in_memory)]
        with mock.patch.object(kda, "fused_decode_attention_cuda", plain_decode_attention):
            plain_logits = steps_of(restored)
    logits_equal = all(bool(torch.equal(a, b)) for a, b in zip(*logits))
    kernel_vs_plain = max(float((a - b).abs().max().item())
                          for a, b in zip(logits[0], plain_logits))
    del in_memory, logits, plain_logits
    requests = ls.make_requests(cfg, n_req, prompt, new)
    cache = init_cache(cfg, slots, max_seq, quant=True, device=DEVICE)
    kda.fused_decode_attention_cuda.launches = 0
    with torch.no_grad():
        report = ls.serve(restored, cfg, cache, requests)
    launches = kda.fused_decode_attention_cuda.launches
    report.pop("step_ms")
    serve = {"restore_s": restore_final_s, "logit_steps": LM_PLAIN_STEPS,
             "logits_bit_equal": logits_equal, "kernel_vs_plain_max_abs": kernel_vs_plain,
             "kernel_vs_plain_tol": TOL["bfloat16"], "kernel_launches": launches,
             "layers": cfg.num_layers, **report}
    log("lm-train serve", json.dumps(serve))
    if not (logits_equal and kernel_vs_plain <= TOL["bfloat16"]
            and report["completed"] == n_req
            and all(len(r.generated) == new for r in requests)
            and launches == cfg.num_layers * report["steps"]):
        raise AssertionError(f"lm-train serving of the restored weights: {serve}")
    del restored, cache
    torch.cuda.empty_cache()
    stats = {"card_vs_cpu": cpu_check, "bf16_vs_f32": loss_check,
             "chunked_vs_full": chunk_check, "train": train, "replay": replay,
             "serve": serve, "kernel_launches": launches}
    log("lm-train", json.dumps({k: v for k, v in stats.items() if k != "replay"}))
    return stats


def fam_inputs(np, cfg, b, s, seed):
    """Seeded tokens and labels ``(b, s)`` (audio ``(b, K, s)``) and, for a
    vlm config, image embeddings N(0, 0.1²) ``(b, num_image_tokens,
    d_model)`` in float32 (``tests/test_archs_smoke.py:29-32``)."""
    rng = np.random.default_rng(seed)
    lead = (b, cfg.num_codebooks) if cfg.family == "audio" else (b,)
    toks = rng.integers(0, cfg.vocab_size, size=(*lead, s + 1)).astype(np.int32)
    enc = None
    if cfg.family == "vlm":
        enc = (rng.normal(size=(b, cfg.num_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return toks[..., :-1], toks[..., 1:], enc


def open_gates(params, gate=FAM_GATE):
    """Every vlm cross-attention gate (zero at init) set to ``gate``, in
    place: a closed gate would hide the cross path from every check."""
    if "cross" in params["layers"]:
        params["layers"]["cross"]["xattn"]["gate"].fill_(gate)
    return params


def record_topk(torch):
    """A stand-in for ``transformer.apply_moe`` that records each call's
    router top-k expert ids (as the layer computes them) and then runs the
    layer; returns it with the list it appends to."""
    from repro_torch.models import moe

    picked = []

    def wrapped(p, x, cfg_moe, act="swiglu", **kw):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"]
        picked.append(torch.topk(torch.softmax(logits, dim=-1), cfg_moe.top_k,
                                 dim=-1).indices.cpu().numpy())
        return moe.apply_moe(p, x, cfg_moe, act, **kw)

    return wrapped, picked


def fam_run(torch, np, arch, device) -> dict:
    """The smoke config of ``arch`` in f32 on ``device``: forward (the moe
    router's top-k recorded) and ``lm_loss``, ``FAM_CPU_DECODE_STEPS``
    decode steps (int8 cache, the flash-decode kernel on the card; a vlm
    cache is never int8) and one AdamW train step, from parameters drawn
    on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_map
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW, make_schedule
    from repro_torch.train.tree import flatten_with_names

    cfg = get_config(arch, smoke=True)
    params = open_gates(tf.init_lm(torch.Generator().manual_seed(0), cfg))
    params = tree_map(lambda t: t.to(device), params)
    tokens, labels, enc = fam_inputs(np, cfg, 2, 16, seed=1)
    tk, lb = torch.from_numpy(tokens).to(device), torch.from_numpy(labels).to(device)
    ec = None if enc is None else torch.from_numpy(enc).to(device)
    out = {}
    wrapped, picked = record_topk(torch)
    with torch.no_grad(), mock.patch.object(tf, "apply_moe", wrapped):
        logits, aux = tf.forward(params, cfg, tk, enc=ec)
        out["forward"] = logits.float().cpu()
        out["aux"] = aux.float().cpu()
        out["loss"] = tf.lm_loss(params, cfg, tk, lb, enc=ec).float().cpu()
    out["topk"] = picked
    steps = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(FAM_CPU_DECODE_STEPS, *tokens.shape[:-1], 1)).astype(np.int32)
    cache = init_cache(cfg, 2, 16, quant=True, device=device)
    with torch.no_grad():
        out["decode"] = [decode_step(params, cfg, torch.from_numpy(t).to(device), cache,
                                     enc=ec)[0].float().cpu() for t in steps]
    opt = AdamW(schedule=make_schedule(cfg.schedule, 3e-3, 10))
    batch = {"tokens": tk, "labels": lb}
    if ec is not None:
        batch["enc"] = ec
    state, metrics = make_train_step(cfg, opt, has_enc=ec is not None)(
        init_train_state(params, opt), batch)
    out["train_loss"] = metrics["loss"].cpu()
    out["params"] = {n: t.cpu() for n, t in flatten_with_names(state.params)}
    return out


def fam_card_vs_cpu(torch, np) -> dict:
    """``fam_run`` of each new arch on the card and on the CPU, held within
    ``STEP_TOL``; the moe layers must pick the same experts first."""
    rows = {}
    for arch in FAM_ARCHS:
        card, cpu = fam_run(torch, np, arch, DEVICE), fam_run(torch, np, arch, "cpu")
        same_topk = (len(card["topk"]) == len(cpu["topk"])
                     and all(np.array_equal(a, b) for a, b in zip(card["topk"], cpu["topk"])))
        worst, ok = 0.0, same_topk
        pairs = [(card[k], cpu[k]) for k in ("forward", "aux", "loss", "train_loss")]
        pairs += list(zip(card["decode"], cpu["decode"]))
        pairs += [(card["params"][n], cpu["params"][n]) for n in cpu["params"]]
        for got, want in pairs:
            good, err = within(torch, got, want, **STEP_TOL)
            ok, worst = ok and good, max(worst, err)
        rows[arch] = {"moe_layers_checked": len(cpu["topk"]), "same_topk": same_topk,
                      "max_abs_err": worst, "loss_card": float(card["loss"]),
                      "loss_cpu": float(cpu["loss"]), "ok": ok}
        if not ok:
            raise AssertionError(f"lm-families: card and CPU disagree at {arch}'s smoke "
                                 f"config: {rows[arch]}")
    return {"archs": rows, "tol": STEP_TOL, "decode_steps": FAM_CPU_DECODE_STEPS}


def kernel_vs_plain_logits(torch, params, cfg, slots, max_seq, tokens) -> float:
    """Decode logits (every codebook's for audio) over ``tokens`` from fresh
    int8 caches, through the kernel and through its plain version: the
    largest difference."""
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    def run():
        cache = init_cache(cfg, slots, max_seq, quant=True, device=DEVICE)
        return [decode_step(params, cfg, torch.from_numpy(t).to(DEVICE), cache)[0]
                [..., :cfg.vocab_size].float() for t in tokens]

    with torch.no_grad():
        kernel = run()
        with mock.patch.object(kda, "fused_decode_attention_cuda", plain_decode_attention):
            plain = run()
    if not all(bool(torch.isfinite(x).all()) for x in kernel):
        raise AssertionError(f"lm-families: non-finite {cfg.name} logits")
    return max(float((a - b).abs().max().item()) for a, b in zip(kernel, plain))


def train_flop(cfg, tokens: int, seq: int) -> int:
    """The matmul FLOPs of one train step: 6 per active non-embedding
    matmul parameter and token (forward 2, backward 4), plus the
    products whose size grows with the sequence, also forward + backward.

    - attention families: the attention projections, the router, the
      top-k experts' products, an untied head; the score and value
      products, 12·b·h·s²·hd a layer;
    - ssm (xlstm): per mLSTM layer its four d×d projections and the gates'
      d×2H; per sLSTM layer ``w_in`` (4d²), ``wo`` (d²) and the recurrent
      ``w_rec`` (4·d·hd, applied each step); an untied head; from
      ``MLSTM_CHUNK_THRESHOLD`` tokens on the chunkwise mLSTM's products,
      6·(2·c·d + 2·d·hd) a token and mLSTM layer (c = 256: q·kᵀ and the
      scores' value product over the whole chunk, q·C and the k·vᵀ state
      update);
    - hybrid (zamba2): per Mamba2 layer ``w_in`` (d·(2·di + 2·N + H)) and
      ``w_out`` (di·d), and the SSD chunk's products, 6·(c·N + c·di +
      2·di·N) a token and layer (c = 128: C·Bᵀ, the scores' product with
      x over the whole chunk, the carried state's read and its update);
      the shared attention's projections and its score and value products
      at each of its n_super applications; an untied head.
    """
    from repro_torch.models.moe import moe_flops_per_token
    from repro_torch.models.transformer import MLSTM_CHUNK_THRESHOLD, num_slstm, zamba_layout

    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    b = tokens // seq
    head = 0 if cfg.tie_embeddings else d * cfg.padded_vocab
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.kv_heads)
    scores = 12 * b * cfg.num_heads * seq * seq * hd      # one attention layer
    if cfg.family == "ssm":
        n_s = num_slstm(cfg)
        n_m, H = L - n_s, cfg.num_heads
        params = n_m * (4 * d * d + 2 * H * d) + n_s * (5 * d * d + 4 * d * (d // H))
        chunk = 256
        intra = (6 * n_m * (2 * chunk * d + 2 * d * (d // H)) * tokens
                 if seq >= MLSTM_CHUNK_THRESHOLD else 0)
        return 6 * (params + head) * tokens + intra
    if cfg.family == "hybrid":
        n_super = zamba_layout(cfg)[0]
        di, N, c = 2 * d, cfg.ssm_state, 128
        H = di // 64
        params = L * (d * (2 * di + 2 * N + H) + di * d) + n_super * attn
        ssd = 6 * L * (c * N + c * di + 2 * di * N) * tokens
        return 6 * (params + head) * tokens + ssd + n_super * scores
    ffn = (cfg.moe.num_experts * d + moe_flops_per_token(d, cfg.d_ff, cfg.moe, cfg.act) // 2
           if cfg.moe else 3 * d * cfg.d_ff)
    per_token = L * (attn + ffn) + head
    return 6 * per_token * tokens + L * scores


def fam_moe_serve(torch, np, timer) -> dict:
    """granite-moe-3b-a800m FULL served through ``launch.serve.serve`` with
    an int8 cache: logits against the plain version, launches, the kernel
    at the served layer, one traced step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.launch import serve as ls
    from repro_torch.models.layers import count_params, tree_leaves

    cfg = get_config(MOE_ARCH)
    slots, max_seq, n_req, prompt, new = MOE_SERVE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cache = ls.build(cfg, slots, max_seq, kv_int8=True, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(8).integers(
        1, cfg.vocab_size, size=(LM_PLAIN_STEPS, slots, 1)).astype(np.int32)
    kernel_vs_plain = kernel_vs_plain_logits(torch, params, cfg, slots, max_seq, tokens)
    requests = ls.make_requests(cfg, n_req, prompt, new)
    kda.fused_decode_attention_cuda.launches = 0
    with torch.no_grad():
        report = ls.serve(params, cfg, cache, requests)
    launches = kda.fused_decode_attention_cuda.launches
    report.pop("step_ms")
    length = int(cache["len"].item())
    layer = (cache["k"][0], cache["k_scale"][0], cache["v"][0], cache["v_scale"][0])
    qg = torch.randn((slots, cfg.kv_heads, cfg.q_per_kv, cfg.resolved_head_dim),
                     generator=torch.Generator(device=DEVICE).manual_seed(9),
                     device=DEVICE).to(torch.bfloat16)
    served = da_parity(torch, "moe-served-layer", (qg, *layer), length)
    ln = torch.tensor(length, dtype=torch.int32, device=DEVICE)
    served["ms"] = timer.ms(lambda: kda.fused_decode_attention_cuda(qg, *layer, ln))
    served["bound_ms"], served["bound_by"] = bound(*da_work(qg, *layer, length), "bfloat16")
    da_library(torch, timer, served, (qg, *layer), length)
    with torch.no_grad():
        prof = profile_decode(torch, params, cfg, cache, 1)
    prof["host_ops_per_layer"] = prof["host_ops_per_step"] / cfg.num_layers
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": count_params(params),
           "weight_bytes": sum(x.numel() * x.element_size() for x in tree_leaves(params)),
           "init_s": init_s, "slots": slots, "max_seq": max_seq, "requests": n_req,
           "prompt": prompt, "new": new, "kernel_vs_plain_max_abs": kernel_vs_plain,
           "kernel_vs_plain_tol": TOL["bfloat16"], "kernel_launches": launches,
           "launches_per_step": launches / report["steps"], "final_len": length,
           "served_layer": served, "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "profile": prof, **report}
    if not (kernel_vs_plain <= TOL["bfloat16"] and report["completed"] == n_req
            and all(len(r.generated) == new for r in requests)
            and launches == cfg.num_layers * report["steps"]):
        raise AssertionError(f"lm-families: granite-moe serving: {out}")
    del params, cache
    torch.cuda.empty_cache()
    return out


def fam_moe_train(torch, np) -> dict:
    """granite-moe-3b-a800m at its widths and ``MOE_TRAIN_LAYERS`` layers:
    AdamW steps of ``MOE_TRAIN_BATCH`` ``TokenBatcher`` tokens through
    ``launch.train.train``, the later ones over 2 microbatches; one traced
    step."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.launch import train as lt
    from repro_torch.models.layers import count_params, tree_leaves
    from repro_torch.models.transformer import forward, init_lm
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW, make_schedule

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator(device=DEVICE).manual_seed(10), cfg)
    n_params = count_params(params)
    opt = AdamW(schedule=make_schedule(cfg.schedule, LM_TRAIN_LR, MOE_TRAIN_STEPS))
    b, s = MOE_TRAIN_BATCH
    data = TokenBatcher(cfg.vocab_size, b, s, seed=0)
    quiet = lambda *_: None
    state, r1 = lt.train(cfg, opt, data, MOE_TRAIN_MB_FROM, device=DEVICE,
                         state=init_train_state(params, opt), log=quiet)
    state, r2 = lt.train(cfg, opt, data, MOE_TRAIN_STEPS, device=DEVICE, state=state,
                         start=MOE_TRAIN_MB_FROM, microbatches=2, log=quiet)
    del params
    state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    peak = torch.cuda.max_memory_allocated()
    tk, lb = (torch.from_numpy(a).to(DEVICE) for a in data.batch(MOE_TRAIN_STEPS))
    with torch.no_grad():
        _, aux = forward(state.params, cfg, tk)
    held = [state]
    del state
    step_fn = make_train_step(cfg, opt)
    prof = profiled(torch, lambda: held.__setitem__(
        0, step_fn(held[0], {"tokens": tk, "labels": lb})[0]), 1)
    prof["host_ops_per_layer"] = prof["host_ops_per_step"] / cfg.num_layers
    steps = r1["steps"] + r2["steps"]
    ms = np.asarray([r["ms"] for r in steps])
    flop = train_flop(cfg, b * s, s)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "train_state_bytes": state_bytes, "batch": MOE_TRAIN_BATCH,
           "microbatches_from": MOE_TRAIN_MB_FROM,
           "losses": [r["loss"] for r in steps], "aux_loss": float(aux),
           "step_ms": ms.tolist(), "step_p50_ms": float(np.percentile(ms, 50)),
           "step_p99_ms": float(np.percentile(ms, 99)),
           "tokens_per_s": float(b * s * len(steps) / (ms.sum() / 1e3)),
           "tflop_per_step": flop / 1e12, "max_memory_allocated": peak, "profile": prof}
    out["share_of_bf16_peak_at_p50"] = flop / (out["step_p50_ms"] / 1e3) / PEAK_FLOPS["bfloat16"]
    finite = all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps)
    if not (finite and np.isfinite(out["aux_loss"]) and out["aux_loss"] > 0):
        raise AssertionError(f"lm-families: granite-moe training: {out}")
    del held, tk, lb
    torch.cuda.empty_cache()
    return out


def fam_vlm(torch, np) -> dict:
    """llama-3.2-vision-11b at its widths and ``VLM_LAYERS`` layers (one
    superblock), gates at ``FAM_GATE``, a seeded ``enc``: one train step
    and decode steps with its bf16 cache."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.models.layers import count_params
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW, make_schedule

    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = open_gates(init_lm(torch.Generator(device=DEVICE).manual_seed(11), cfg))
    n_params = count_params(params)
    b, s = VLM_TRAIN_BATCH
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    enc = (torch.randn((b, cfg.num_image_tokens, cfg.d_model), generator=gen, device=DEVICE)
           * 0.1).to(cfg.torch_dtype)
    tk, lb = (torch.from_numpy(a).to(DEVICE)
              for a in TokenBatcher(cfg.vocab_size, b, s, seed=0).batch(0))
    opt = AdamW(schedule=make_schedule(cfg.schedule, LM_TRAIN_LR, 1))
    step_fn = make_train_step(cfg, opt, has_enc=True)
    t0 = time.perf_counter()
    state, metrics = step_fn(init_train_state(params, opt),
                             {"tokens": tk, "labels": lb, "enc": enc})
    loss = float(metrics["loss"])
    train_ms = (time.perf_counter() - t0) * 1e3
    train_peak = torch.cuda.max_memory_allocated()
    params = state.params
    del state
    torch.cuda.empty_cache()
    slots, max_seq, n_steps = VLM_DECODE
    cache = init_cache(cfg, slots, max_seq, device=DEVICE)
    toks = np.random.default_rng(13).integers(1, cfg.vocab_size, size=(n_steps, slots, 1))
    step_ms, logits = [], None
    with torch.no_grad():
        for t in toks.astype(np.int32):
            t0 = time.perf_counter()
            logits, _ = decode_step(params, cfg, torch.from_numpy(t).to(DEVICE), cache,
                                    enc=enc[:slots])
            logits = logits.float()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "image_tokens": cfg.num_image_tokens, "train_batch": VLM_TRAIN_BATCH,
           "train_step_ms": train_ms, "train_loss": loss, "train_max_memory": train_peak,
           "decode": {"slots": slots, "max_seq": max_seq, "steps": n_steps,
                      "step_p50_ms": float(np.percentile(step_ms, 50)), "step_ms": step_ms},
           "final_len": int(cache["len"].item()),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if not (np.isfinite(loss) and bool(torch.isfinite(logits).all())
            and out["final_len"] == n_steps):
        raise AssertionError(f"lm-families: llama-vision: {out}")
    del params, cache, enc
    torch.cuda.empty_cache()
    return out


def fam_audio(torch, np) -> dict:
    """musicgen-medium FULL: decode steps at ``AUDIO_DECODE`` with an int8
    cache through the kernel (held against the plain version), then train
    steps of ``AUDIO_TRAIN_BATCH`` tokens over every codebook through
    ``launch.train.train``."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.launch import train as lt
    from repro_torch.models.layers import count_params
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.optimizer import AdamW, make_schedule

    cfg = get_config(AUDIO_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator(device=DEVICE).manual_seed(14), cfg)
    n_params = count_params(params)
    slots, max_seq, n_steps = AUDIO_DECODE
    toks = np.random.default_rng(15).integers(
        0, cfg.vocab_size, size=(n_steps, slots, cfg.num_codebooks, 1)).astype(np.int32)
    kernel_vs_plain = kernel_vs_plain_logits(torch, params, cfg, slots, max_seq, toks)
    cache = init_cache(cfg, slots, max_seq, quant=True, device=DEVICE)
    step_ms = []
    kda.fused_decode_attention_cuda.launches = 0
    with torch.no_grad():
        for t in toks:
            t0 = time.perf_counter()
            logits, _ = decode_step(params, cfg, torch.from_numpy(t).to(DEVICE), cache)
            nxt = logits[:, :, -1, :cfg.vocab_size].argmax(dim=-1).cpu()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kda.fused_decode_attention_cuda.launches
    b, s = AUDIO_TRAIN_BATCH
    opt = AdamW(schedule=make_schedule(cfg.schedule, LM_TRAIN_LR, AUDIO_TRAIN_STEPS))
    state, rep = lt.train(cfg, opt, TokenBatcher(cfg.vocab_size, b, s, seed=0),
                          AUDIO_TRAIN_STEPS, device=DEVICE,
                          state=init_train_state(params, opt), log=lambda *_: None)
    del params, state
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "codebooks": cfg.num_codebooks,
           "decode": {"slots": slots, "max_seq": max_seq, "steps": n_steps,
                      "step_p50_ms": float(np.percentile(step_ms, 50)),
                      "step_p99_ms": float(np.percentile(step_ms, 99)),
                      "next_shape": list(nxt.shape)},
           "kernel_vs_plain_max_abs": kernel_vs_plain, "kernel_vs_plain_tol": TOL["bfloat16"],
           "kernel_launches": launches,
           "train": {"batch": AUDIO_TRAIN_BATCH, "steps": [r["ms"] for r in rep["steps"]],
                     "losses": [r["loss"] for r in rep["steps"]]},
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if not (kernel_vs_plain <= TOL["bfloat16"] and launches == cfg.num_layers * n_steps
            and all(np.isfinite(r["loss"]) for r in rep["steps"])):
        raise AssertionError(f"lm-families: musicgen: {out}")
    torch.cuda.empty_cache()
    return out


def phase_lm_families(torch, np, timer) -> dict:
    """The moe, vlm and audio families and the two remaining dense
    configs; see the module docstring, phase 11."""
    t0 = time.perf_counter()
    stats = {"card_vs_cpu": fam_card_vs_cpu(torch, np)}
    log("lm-families card-vs-cpu", json.dumps(stats["card_vs_cpu"]))
    stats["moe_serve"] = fam_moe_serve(torch, np, timer)
    log("lm-families moe-serve", json.dumps(stats["moe_serve"]))
    stats["moe_train"] = fam_moe_train(torch, np)
    log("lm-families moe-train", json.dumps(stats["moe_train"]))
    stats["vlm"] = fam_vlm(torch, np)
    log("lm-families vlm", json.dumps(stats["vlm"]))
    stats["audio"] = fam_audio(torch, np)
    log("lm-families audio", json.dumps(stats["audio"]))
    stats["kernel_launches"] = (stats["moe_serve"]["kernel_launches"]
                                + stats["audio"]["kernel_launches"])
    stats["seconds"] = time.perf_counter() - t0
    log("lm-families", json.dumps({"kernel_launches": stats["kernel_launches"],
                                   "seconds": stats["seconds"]}))
    return stats


def rec_run(torch, np, arch, device) -> dict:
    """The smoke config of ``arch`` in f32 on ``device``, from parameters
    drawn on the CPU: ``forward`` and ``lm_loss`` at s 16, ``forward`` at
    the chunk threshold ``REC_LONG``, ``REC_CPU_DECODE_STEPS`` decode
    steps, one AdamW train step."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_map
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW, make_schedule
    from repro_torch.train.tree import flatten_with_names

    cfg = get_config(arch, smoke=True)
    params = tree_map(lambda t: t.to(device), tf.init_lm(torch.Generator().manual_seed(0), cfg))
    tokens, labels, _ = fam_inputs(np, cfg, 2, 16, seed=1)
    long_tokens, _, _ = fam_inputs(np, cfg, 1, REC_LONG[arch], seed=4)
    tk, lb = torch.from_numpy(tokens).to(device), torch.from_numpy(labels).to(device)
    out = {}
    with torch.no_grad():
        out["forward"] = tf.forward(params, cfg, tk)[0].float().cpu()
        out["loss"] = tf.lm_loss(params, cfg, tk, lb).float().cpu()
        out["long"] = tf.forward(params, cfg, torch.from_numpy(long_tokens).to(device))[0] \
            .float().cpu()
        steps = np.random.default_rng(2).integers(
            0, cfg.vocab_size, size=(REC_CPU_DECODE_STEPS, 2, 1)).astype(np.int32)
        cache = init_cache(cfg, 2, 16, device=device)
        out["decode"] = [decode_step(params, cfg, torch.from_numpy(t).to(device), cache)[0]
                         .float().cpu() for t in steps]
    opt = AdamW(schedule=make_schedule(cfg.schedule, 3e-3, 10))
    state, metrics = make_train_step(cfg, opt)(init_train_state(params, opt),
                                               {"tokens": tk, "labels": lb})
    out["train_loss"] = metrics["loss"].cpu()
    out["params"] = {n: t.cpu() for n, t in flatten_with_names(state.params)}
    return out


def rec_card_vs_cpu(torch, np) -> dict:
    """``rec_run`` of both smoke configs on the card and on the CPU, held
    within ``STEP_TOL`` (zamba's 4,096-token forward within
    ``REC_LONG_TOL``)."""
    rows = {}
    for arch in REC_ARCHS:
        card, cpu = rec_run(torch, np, arch, DEVICE), rec_run(torch, np, arch, "cpu")
        long_tol = REC_LONG_TOL if arch == "zamba2-7b" else STEP_TOL
        pairs = [(card[k], cpu[k]) for k in ("forward", "loss", "train_loss")]
        pairs += list(zip(card["decode"], cpu["decode"]))
        pairs += [(card["params"][n], cpu["params"][n]) for n in cpu["params"]]
        worst, ok = 0.0, True
        for got, want in pairs:
            good, err = within(torch, got, want, **STEP_TOL)
            ok, worst = ok and good, max(worst, err)
        long_ok, long_err = within(torch, card["long"], cpu["long"], **long_tol)
        ok = ok and long_ok
        rows[arch] = {"long_seq": REC_LONG[arch], "long_tol": long_tol,
                      "long_max_abs_err": long_err,
                      "max_abs_err": worst, "loss_card": float(card["loss"]),
                      "loss_cpu": float(cpu["loss"]), "ok": ok}
        if not ok:
            raise AssertionError(f"lm-recurrent: card and CPU disagree at {arch}'s smoke "
                                 f"config: {rows[arch]}")
    return {"archs": rows, "tol": STEP_TOL, "decode_steps": REC_CPU_DECODE_STEPS}


def rec_decode_vs_forward(torch, np) -> dict:
    """On the card, both smoke configs: ``forward`` over ``REC_DECODE_S``
    tokens against as many decode steps, within ``REC_DECODE_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    rows = {}
    for arch in REC_ARCHS:
        cfg = get_config(arch, smoke=True)
        params = tf.init_lm(torch.Generator(device=DEVICE).manual_seed(3), cfg)
        tokens = torch.from_numpy(fam_inputs(np, cfg, 2, REC_DECODE_S, seed=3)[0]).to(DEVICE)
        with torch.no_grad():
            full = tf.forward(params, cfg, tokens)[0]
            cache = init_cache(cfg, 2, 16, device=DEVICE)
            dec = torch.cat([decode_step(params, cfg, tokens[:, t:t + 1], cache)[0]
                             for t in range(REC_DECODE_S)], dim=1)
        ok, err = within(torch, dec, full, **REC_DECODE_TOL)
        rows[arch] = {"max_abs_err": err, "ok": ok}
        if not ok:
            raise AssertionError(f"lm-recurrent: {arch} decode against forward: {rows[arch]}")
    return {"archs": rows, "tol": REC_DECODE_TOL, "s": REC_DECODE_S}


def rec_ring(torch, np) -> dict:
    """The zamba smoke config with a ring of ``REC_RING_W`` slots decodes
    2·W+3 steps on the card and on the CPU: finite logits within
    ``STEP_TOL`` of the CPU's, the ring's positions the last W."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_map
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    cfg = get_config("zamba2-7b", smoke=True)
    params = tf.init_lm(torch.Generator().manual_seed(5), cfg)
    n = 2 * REC_RING_W + 3
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(n, 1, 1)).astype(np.int32)
    out = {}
    for device in (DEVICE, "cpu"):
        p = tree_map(lambda t: t.to(device), params)
        cache = init_cache(cfg, 1, 1 << 12, window=REC_RING_W, device=device)
        with torch.no_grad():
            out[device] = [decode_step(p, cfg, torch.from_numpy(t).to(device), cache)[0]
                           .float().cpu() for t in toks]
        out[device + "_pos"] = sorted(cache["shared"]["pos"][0, 0].cpu().tolist())
        out[device + "_len"] = (int(cache["len"]), int(cache["shared"]["len"]))
    worst, ok = 0.0, True
    for a, b in zip(out[DEVICE], out["cpu"]):
        good, err = within(torch, a, b, **STEP_TOL)
        ok, worst = ok and good and bool(torch.isfinite(a).all()), max(worst, err)
    row = {"window": REC_RING_W, "steps": n, "max_abs_err": worst, "tol": STEP_TOL,
           "len": out[DEVICE + "_len"], "positions": out[DEVICE + "_pos"]}
    if not (ok and out[DEVICE + "_pos"] == list(range(n - REC_RING_W, n))
            and out[DEVICE + "_len"] == (n, n)):
        raise AssertionError(f"lm-recurrent: the ring past its window: {row}")
    return row


def rec_serve(torch, np, arch, smi) -> dict:
    """``arch`` FULL served through ``launch.serve.serve`` at ``REC_SERVE``
    (4 requests of 16 + 16), then one traced decode step of every slot."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as ls
    from repro_torch.models.layers import count_params, tree_leaves
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import cache_bytes

    cfg = get_config(arch)
    slots, max_seq, n_req, prompt, new = REC_SERVE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cache = ls.build(cfg, slots, max_seq, kv_int8=False, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = ls.make_requests(cfg, n_req, prompt, new)
    with torch.no_grad():
        report = ls.serve(params, cfg, cache, requests)
    report.pop("step_ms")
    tokens = torch.ones((slots, 1), dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        logits = decode_step(params, cfg, tokens, cache)[0]
        prof = profiled(torch, lambda: decode_step(params, cfg, tokens, cache), 1)
    prof["host_ops_per_layer"] = prof["host_ops_per_step"] / cfg.num_layers
    out = {"card": smi, "arch": cfg.name, "layers": cfg.num_layers,
           "params": count_params(params),
           "weight_bytes": sum(x.numel() * x.element_size() for x in tree_leaves(params)),
           "init_s": init_s, "slots": slots, "max_seq": max_seq, "requests": n_req,
           "prompt": prompt, "new": new, "cache_bytes": cache_bytes(cache),
           "final_len": int(cache["len"].item()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "profile": prof,
           **report}
    if cfg.family == "hybrid":
        out["ring_bytes"] = cache_bytes(cache["shared"])
        out["mamba_state_bytes"] = cache_bytes(cache["mamba"]) + cache_bytes(cache["tail"])
    if not (report["completed"] == n_req and all(len(r.generated) == new for r in requests)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"lm-recurrent: {arch} serving: {out}")
    del params, cache
    torch.cuda.empty_cache()
    return out


def slstm_step_ms(torch, cfg, b, s) -> float:
    """CUDA-event time of one sLSTM layer's forward and backward at the
    training shape ``(b, s, d_model)`` (its ``s``-step sequential loop)."""
    from repro_torch.models import xlstm

    p = {k: v.requires_grad_(True) for k, v in xlstm.init_slstm(
        torch.Generator(device=DEVICE).manual_seed(16), cfg.d_model, cfg.num_heads,
        cfg.torch_dtype).items()}
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(device=DEVICE).manual_seed(17),
                    device=DEVICE).to(cfg.torch_dtype).requires_grad_(True)

    def run():
        y, _ = xlstm.slstm_scan(p, x, cfg.num_heads)
        y.float().sum().backward()

    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def rec_train(torch, np, arch, layers, smi) -> dict:
    """``arch`` at its widths and ``layers`` layers: ``REC_TRAIN_STEPS``
    AdamW steps of ``REC_TRAIN_BATCH`` ``TokenBatcher`` tokens through
    ``launch.train.train``, from ``REC_TRAIN_MB_FROM`` on over 2
    microbatches; one traced step."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.launch import train as lt
    from repro_torch.models.layers import count_params, tree_leaves
    from repro_torch.models.transformer import init_lm, num_slstm
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW, make_schedule

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator(device=DEVICE).manual_seed(18), cfg)
    n_params = count_params(params)
    opt = AdamW(schedule=make_schedule(cfg.schedule, LM_TRAIN_LR, REC_TRAIN_STEPS))
    b, s = REC_TRAIN_BATCH
    data = TokenBatcher(cfg.vocab_size, b, s, seed=0)
    quiet = lambda *_: None
    state, r1 = lt.train(cfg, opt, data, REC_TRAIN_MB_FROM, device=DEVICE,
                         state=init_train_state(params, opt), log=quiet)
    state, r2 = lt.train(cfg, opt, data, REC_TRAIN_STEPS, device=DEVICE, state=state,
                         start=REC_TRAIN_MB_FROM, microbatches=2, log=quiet)
    del params
    state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    peak = torch.cuda.max_memory_allocated()
    tk, lb = (torch.from_numpy(a).to(DEVICE) for a in data.batch(REC_TRAIN_STEPS))
    held = [state]
    del state
    step_fn = make_train_step(cfg, opt)
    prof = profiled(torch, lambda: held.__setitem__(
        0, step_fn(held[0], {"tokens": tk, "labels": lb})[0]), 1)
    prof["host_ops_per_layer"] = prof["host_ops_per_step"] / cfg.num_layers
    steps = r1["steps"] + r2["steps"]
    ms = np.asarray([r["ms"] for r in steps])
    flop = train_flop(cfg, b * s, s)
    out = {"card": smi, "arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "train_state_bytes": state_bytes, "batch": REC_TRAIN_BATCH,
           "microbatches_from": REC_TRAIN_MB_FROM,
           "losses": [r["loss"] for r in steps], "step_ms": ms.tolist(),
           "step_p50_ms": float(np.percentile(ms, 50)),
           "step_p99_ms": float(np.percentile(ms, 99)),
           "tokens_per_s": float(b * s * len(steps) / (ms.sum() / 1e3)),
           "tflop_per_step": flop / 1e12, "max_memory_allocated": peak, "profile": prof}
    out["share_of_bf16_peak_at_p50"] = flop / (out["step_p50_ms"] / 1e3) / PEAK_FLOPS["bfloat16"]
    if cfg.family == "ssm":
        out["slstm_layer_fwd_bwd_ms"] = slstm_step_ms(torch, cfg, b, s)
        out["slstm_share_of_p50"] = (num_slstm(cfg) * out["slstm_layer_fwd_bwd_ms"]
                                     / out["step_p50_ms"])
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps):
        raise AssertionError(f"lm-recurrent: {arch} training: {out}")
    del held, tk, lb
    torch.cuda.empty_cache()
    return out


def phase_lm_recurrent(torch, np, smi) -> dict:
    """The ssm (xlstm) and hybrid (zamba2) families; see the module
    docstring, phase 12.  Launches none of the four kernels."""
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.kernels.decode_attention import fused_decode_attention_cuda
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    wrappers = (crossbar_reduce_cuda, embedding_bag_cuda, fused_decode_attention_cuda)
    before = [w.launches for w in wrappers]
    t0 = time.perf_counter()
    stats = {"card_vs_cpu": rec_card_vs_cpu(torch, np)}
    log("lm-recurrent card-vs-cpu", json.dumps({"card": smi, **stats["card_vs_cpu"]}))
    stats["decode_vs_forward"] = rec_decode_vs_forward(torch, np)
    log("lm-recurrent decode-vs-forward", json.dumps({"card": smi,
                                                      **stats["decode_vs_forward"]}))
    stats["ring"] = rec_ring(torch, np)
    log("lm-recurrent ring", json.dumps({"card": smi, **stats["ring"]}))
    for arch in REC_ARCHS:
        key = arch.split("-")[0]
        stats[f"{key}_serve"] = rec_serve(torch, np, arch, smi)
        log(f"lm-recurrent {key}-serve", json.dumps(stats[f"{key}_serve"]))
    stats["xlstm_train"] = rec_train(torch, np, "xlstm-125m", 12, smi)
    log("lm-recurrent xlstm-train", json.dumps(stats["xlstm_train"]))
    stats["zamba2_train"] = rec_train(torch, np, "zamba2-7b", ZAMBA_TRAIN_LAYERS, smi)
    log("lm-recurrent zamba2-train", json.dumps(stats["zamba2_train"]))
    stats["kernel_launches"] = sum(w.launches - n for w, n in zip(wrappers, before))
    stats["seconds"] = time.perf_counter() - t0
    log("lm-recurrent", json.dumps({"card": smi, "kernel_launches": stats["kernel_launches"],
                                    "seconds": stats["seconds"]}))
    if stats["kernel_launches"]:
        raise AssertionError("lm-recurrent: the recurrent path launched a kernel of the "
                             "attention or embedding paths")
    return stats


def mesh_train(torch, np, cfg, state, batches, step_fn, mesh=None) -> dict:
    """``step_fn`` over ``batches`` (on ``mesh`` inside the activation
    context, the batch laid out by ``batch_specs``): the state, losses,
    grad norms and step times (synchronized)."""
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.dryrun import batch_specs

    rules = sh.LOGICAL_RULES_SINGLE_POD
    ctx = sh.activation_sharding_ctx(mesh, rules) if mesh is not None else \
        contextlib.nullcontext()
    losses, norms, ms = [], [], []
    with ctx:
        for tokens, labels in batches:
            t0 = time.perf_counter()
            batch = {"tokens": tokens, "labels": labels}
            if mesh is not None:
                batch = sh.distribute_tree(batch, batch_specs(batch, rules, mesh), mesh)
            state, m = step_fn(state, batch)
            # on the mesh both are replicated 0-d DTensors
            loss, norm = (m[k].to_local() if mesh is not None else m[k]
                          for k in ("loss", "grad_norm"))
            losses.append(float(loss))
            norms.append(float(norm))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"state": state, "losses": losses, "grad_norms": norms, "step_ms": ms,
            "step_p50_ms": float(np.percentile(ms, 50))}


def mesh_vs_plain(torch, np, cfg, opt, state0, batches, mesh, *, cfg_mesh=None,
                  traced=True) -> dict:
    """The same AdamW steps off the mesh and on ``mesh`` (the state laid out
    by ``param_specs_for`` and ``opt_state_specs``) in deterministic mode,
    one traced step of each.  Fails unless losses, grad norms and every
    weight are bit-equal and the steps moved weights off their start."""
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.dryrun import batch_specs
    from repro_torch.launch.elastic_restart import state_specs
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import flatten_with_names

    cfg_mesh = cfg_mesh or cfg
    out = {}
    with deterministic(torch):
        plain = mesh_train(torch, np, cfg, state0, batches, make_train_step(cfg, opt))
        if traced:
            step_fn = make_train_step(cfg, opt)
            held = [plain["state"]]
            tk, lb = batches[0]
            out["plain_profile"] = profiled(torch, lambda: step_fn(held[0], {
                "tokens": tk, "labels": lb}), 1)
            del held
        want = {n: t for n, t in flatten_with_names(plain.pop("state").params)}
        start = dict(flatten_with_names(state0.params))
        moved = sum(int((want[n] != start[n]).sum()) for n in want)
        del start
        on = sh.distribute_tree(state0, state_specs(state0, mesh), mesh)
        step_fn = make_train_step(cfg_mesh, opt)
        meshed = mesh_train(torch, np, cfg_mesh, on, batches, step_fn, mesh)
        if traced:
            held = [meshed["state"]]
            rules = sh.LOGICAL_RULES_SINGLE_POD
            tk, lb = batches[0]
            b = sh.distribute_tree({"tokens": tk, "labels": lb},
                                   batch_specs({"tokens": tk, "labels": lb}, rules, mesh), mesh)

            def one():
                with sh.activation_sharding_ctx(mesh, rules):
                    step_fn(held[0], b)
            out["mesh_profile"] = profiled(torch, one, 1)
            del held
        got = {n: t.full_tensor() for n, t in flatten_with_names(meshed.pop("state").params)}
    werr = max(float((got[n].float() - want[n].float()).abs().max()) for n in want)
    bit = (all(torch.equal(got[n], want[n]) for n in want)
           and meshed["losses"] == plain["losses"] and meshed["grad_norms"] == plain["grad_norms"])
    lerr = max(abs(a - b) / abs(b) for a, b in zip(meshed["losses"], plain["losses"]))
    nerr = max(abs(a - b) / abs(b) for a, b in zip(meshed["grad_norms"], plain["grad_norms"]))
    out.update({
        "steps": len(batches), "batch": list(batches[0][0].shape),
        "losses_mesh": meshed["losses"], "losses_plain": plain["losses"],
        "grad_norms_mesh": meshed["grad_norms"], "grad_norms_plain": plain["grad_norms"],
        "loss_max_rel_diff": lerr, "grad_norm_max_rel_diff": nerr,
        "weights_max_abs_diff": werr, "bit_equal": bit, "weights_moved": moved,
        "weights": sum(t.numel() for t in want.values()),
        "step_ms_mesh": meshed["step_ms"], "step_ms_plain": plain["step_ms"],
        "step_p50_ms_mesh": meshed["step_p50_ms"], "step_p50_ms_plain": plain["step_p50_ms"],
        "deterministic": True,
    })
    if not (bit and moved > 0):
        raise AssertionError(f"lm-mesh: the steps on the mesh and off it differ, or moved no "
                             f"weight: "
                             f"{ {k: v for k, v in out.items() if 'profile' not in k} }")
    return out


def lm_mesh_chatglm(torch, np, mesh) -> dict:
    """chatglm3-6b at its widths and ``LM_TRAIN_LAYERS`` layers:
    ``MESH_LM_STEPS`` AdamW steps of ``MESH_LM_BATCH`` on ``mesh`` against
    the same steps off it, deterministic algorithms on in both."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.optimizer import AdamW, make_schedule

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_TRAIN_LAYERS)
    opt = AdamW(schedule=make_schedule("cosine", MESH_LM_LR, MESH_LM_STEPS))
    state = init_train_state(init_lm(torch.Generator(device=DEVICE).manual_seed(6), cfg), opt)
    data = TokenBatcher(cfg.vocab_size, *MESH_LM_BATCH, seed=0)
    batches = [tuple(torch.from_numpy(a).to(DEVICE) for a in data.batch(i))
               for i in range(MESH_LM_STEPS)]
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           **mesh_vs_plain(torch, np, cfg, opt, state, batches, mesh)}
    del state
    torch.cuda.empty_cache()
    return out


def lm_mesh_granite(torch, np, mesh) -> dict:
    """granite-moe-3b-a800m at its widths and ``MOE_TRAIN_LAYERS`` layers:
    one AdamW step with ``moe_impl="shardmap"`` on ``mesh`` against
    ``moe_impl="gspmd"``, ``moe_groups=1`` off it (at one data shard the
    same dispatch: one group)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.optimizer import AdamW, make_schedule

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS,
                              moe_impl="gspmd", moe_groups=1)
    opt = AdamW(schedule=make_schedule(cfg.schedule, LM_TRAIN_LR, 1))
    state = init_train_state(init_lm(torch.Generator(device=DEVICE).manual_seed(10), cfg), opt)
    data = TokenBatcher(cfg.vocab_size, *MOE_TRAIN_BATCH, seed=0)
    batches = [tuple(torch.from_numpy(a).to(DEVICE) for a in data.batch(0))]
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           **mesh_vs_plain(torch, np, cfg, opt, state, batches, mesh,
                           cfg_mesh=dataclasses.replace(cfg, moe_impl="shardmap"),
                           traced=False)}
    del state
    torch.cuda.empty_cache()
    return out


def lm_mesh_chunked(torch, np, mesh) -> dict:
    """chatglm3-6b at its widths and ``LM_TRAIN_LAYERS`` layers: one AdamW
    step of ``LM_TRAIN_LONG`` (2 x 4,096 tokens: ``chunked_self_attention``
    on each rank's shard of the scores' layout) on ``mesh`` against off it."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.optimizer import AdamW, make_schedule

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_TRAIN_LAYERS)
    opt = AdamW(schedule=make_schedule("cosine", MESH_LM_LR, 1))
    state = init_train_state(init_lm(torch.Generator(device=DEVICE).manual_seed(7), cfg), opt)
    data = TokenBatcher(cfg.vocab_size, *LM_TRAIN_LONG, seed=1)
    batches = [tuple(torch.from_numpy(a).to(DEVICE) for a in data.batch(0))]
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           **mesh_vs_plain(torch, np, cfg, opt, state, batches, mesh, traced=False)}
    del state
    torch.cuda.empty_cache()
    return out


def lm_mesh_recurrent(torch, np, mesh, arch) -> dict:
    """``arch``'s smoke config (float32): one AdamW step of
    ``MESH_REC_BATCH`` on ``mesh`` (the scans on each rank's batch slice,
    ``batch_local``) against off it."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.optimizer import AdamW, make_schedule

    cfg = get_config(arch, smoke=True)
    opt = AdamW(schedule=make_schedule(cfg.schedule, LM_TRAIN_LR, 1))
    state = init_train_state(init_lm(torch.Generator(device=DEVICE).manual_seed(8), cfg), opt)
    data = TokenBatcher(cfg.vocab_size, *MESH_REC_BATCH, seed=2)
    batches = [tuple(torch.from_numpy(a).to(DEVICE) for a in data.batch(0))]
    return {"arch": cfg.name, "dtype": cfg.dtype,
            **mesh_vs_plain(torch, np, cfg, opt, state, batches, mesh, traced=False)}


def lm_mesh_pipeline(torch, np, mesh) -> dict:
    """``pipelined_apply`` at the reference example's shape over ``mesh``'s
    ``"stage"`` axis against the sequential product of every stage."""
    from repro_torch.dist.pipeline_parallel import bubble_fraction, pipelined_apply

    S = dict(zip(mesh.mesh_dim_names, mesh.shape))["stage"]
    _, M, MB, D, L = MESH_PIPE
    g = torch.Generator(device=DEVICE).manual_seed(0)
    w = torch.randn((S, L, D, D), device=DEVICE, generator=g) / D ** 0.5
    x = torch.randn((M, MB, D), device=DEVICE, generator=g)

    def body(w_stage, h):
        for wl in w_stage:
            h = torch.tanh(h @ wl)
        return h

    t0 = time.perf_counter()
    out = pipelined_apply(w, x, body, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = x
    for s in range(S):
        ref = torch.stack([body(w[s], ref[m]) for m in range(M)])
    err = float((out - ref).abs().max())
    res = {"stages": S, "microbatches": M, "microbatch": MB, "d": D, "layers_a_stage": L,
           "ticks": M + S - 1, "bubble": bubble_fraction(M, S), "max_abs_err": err,
           "atol": MESH_PIPE_ATOL, "wall_s": wall, "device": str(out.device)}
    if not (out.device.type == DEVICE and err <= MESH_PIPE_ATOL):
        raise AssertionError(f"lm-mesh: the pipeline disagrees with the sequential product: {res}")
    return res


def lm_mesh_gloo_case(torch, np) -> dict:
    """What every rank of the gloo world of ``MESH_WORLD`` ranks on the card
    runs: the pipeline at ``MESH_PIPE``'s S stages.  (DTensor's collectives
    do not run there: its first all-gather of a CUDA tensor over gloo
    killed every rank with SIGSEGV on torch 2.11, PERF.md §7; the sharded
    forward and the (2, 2) → (1, 2) restart are proved in the CPU gloo
    worlds of ``tests/test_torch_sharded_lm.py``.)"""
    from torch.distributed.device_mesh import init_device_mesh

    return lm_mesh_pipeline(torch, np, init_device_mesh(
        DEVICE, (MESH_PIPE[0],), mesh_dim_names=("stage",)))


def _lm_mesh_worker(rank, init_method, results) -> None:
    """A worker rank of ``phase_lm_mesh``'s gloo world on the one card:
    runs ``lm_mesh_gloo_case`` and reports its traceback, if any."""
    import traceback

    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=MESH_WORLD,
                                timeout=timedelta(seconds=MESH_GLOO_TIMEOUT_S))
        lm_mesh_gloo_case(torch, np)
        results.put((rank, None))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_lm_mesh(torch, np, smi) -> dict:
    """The distribution layer (``dist.sharding``, ``launch.mesh``, the
    mesh-sharded train step, the shard-local MoE, ``restore(shardings=)``,
    the elastic restart, ``pipeline_parallel``); see the module docstring,
    phase 13.  Launches none of the four kernels."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.kernels.decode_attention import fused_decode_attention_cuda
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.launch import elastic_restart
    from repro_torch.launch.mesh import make_host_mesh

    wrappers = (crossbar_reduce_cuda, embedding_bag_cuda, fused_decode_attention_cuda)
    before = [w.launches for w in wrappers]
    t0 = time.perf_counter()
    stats = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # ---- a world of 1 on NCCL: the (1, 1) mesh and one stage ----
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl1", rank=0,
                                world_size=1)
        try:
            mesh = make_host_mesh()
            stats["chatglm"] = lm_mesh_chatglm(torch, np, mesh)
            log("lm-mesh chatglm", json.dumps({"card": smi, **stats["chatglm"]}))
            stats["granite"] = lm_mesh_granite(torch, np, mesh)
            log("lm-mesh granite", json.dumps({"card": smi, **stats["granite"]}))
            stats["chunked"] = lm_mesh_chunked(torch, np, mesh)
            log("lm-mesh chunked", json.dumps({"card": smi, **stats["chunked"]}))
            for arch in REC_ARCHS:
                stats[arch] = lm_mesh_recurrent(torch, np, mesh, arch)
                log(f"lm-mesh {arch}", json.dumps({"card": smi, **stats[arch]}))
            with deterministic(torch):
                stats["elastic"] = elastic_restart.main(device=DEVICE,
                                                        ckpt_dir=f"{tmp}/elastic1")
            log("lm-mesh elastic", json.dumps({"card": smi, **stats["elastic"]}))
            stats["pipeline_s1"] = lm_mesh_pipeline(torch, np, init_device_mesh(
                DEVICE, (1,), mesh_dim_names=("stage",)))
            log("lm-mesh pipeline-s1", json.dumps(stats["pipeline_s1"]))
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        # ---- a world of MESH_WORLD gloo ranks on the one card ----
        t1 = time.perf_counter()
        init = f"file://{tmp}/gloo{MESH_WORLD}"
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        workers = [ctx.Process(target=_lm_mesh_worker, args=(r, init, results), daemon=True)
                   for r in range(1, MESH_WORLD)]
        for w in workers:
            w.start()
        try:
            dist.init_process_group("gloo", init_method=init, rank=0, world_size=MESH_WORLD,
                                    timeout=timedelta(seconds=MESH_GLOO_TIMEOUT_S))
            try:
                stats["gloo4"] = {"pipeline": lm_mesh_gloo_case(torch, np)}
            finally:
                dist.destroy_process_group()
            errors = []
            for _ in workers:
                try:
                    rank, err = results.get(timeout=120)
                except queue_mod.Empty:
                    errors.append("a worker reported nothing")
                    break
                if err is not None:
                    errors.append(f"rank {rank}: {err}")
            for w in workers:
                w.join(timeout=60)
        finally:
            for w in workers:
                if w.is_alive():
                    w.kill()
                    w.join()
        if errors or any(w.exitcode != 0 for w in workers):
            raise AssertionError(f"lm-mesh: gloo world: {errors}, exit codes "
                                 f"{[w.exitcode for w in workers]}")
        stats["gloo4"]["seconds"] = time.perf_counter() - t1
        log("lm-mesh gloo4", json.dumps({"card": smi, "world": MESH_WORLD, "backend": "gloo",
                                         **stats["gloo4"]}))
    stats["kernel_launches"] = sum(w.launches - n for w, n in zip(wrappers, before))
    stats["seconds"] = time.perf_counter() - t0
    log("lm-mesh", json.dumps({"card": smi, "kernel_launches": stats["kernel_launches"],
                               "seconds": stats["seconds"]}))
    if stats["kernel_launches"]:
        raise AssertionError("lm-mesh: the mesh path launched a kernel of the attention or "
                             "embedding paths")
    return stats


def phase_dryrun(smi) -> dict:
    """``python -m repro_torch.launch.dryrun`` for each of ``DRYRUN_CELLS``
    on ``pod16x16`` (a fake world of 256 ranks, meta tensors: the card's
    torch runs the dry run's DTensor program; nothing runs on the card),
    each in a subprocess ended at ``DRYRUN_TIMEOUT_S``, then
    ``python -m repro_torch.launch.report``'s roofline table of the
    records.  A non-zero exit or a record without the reference's keys
    fails the phase."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    keys = ("cell", "arch", "shape", "mesh", "chips", "memory_analysis", "roofline",
            "compile_seconds")
    t0 = time.perf_counter()
    stats = {"cells": []}

    def run(args):
        proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, text=True,
                              capture_output=True, timeout=DRYRUN_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"dryrun: {args} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-6000:]}")
        return proc.stdout

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        for arch, shape in DRYRUN_CELLS:
            t1 = time.perf_counter()
            run(["repro_torch.launch.dryrun", "--arch", arch, "--mesh", "single", "--force",
                 "--results-dir", out] + (["--shape", shape] if shape else []))
            stats["cells"].append({"arch": arch, "shape": shape,
                                   "seconds": time.perf_counter() - t1})
        records = [json.loads(p.read_text()) for p in sorted(Path(out).glob("*.json"))]
        for rec in records:
            log("dryrun", json.dumps(rec))
        table = run(["repro_torch.launch.report", "--dir", out])
    log("dryrun roofline table\n" + table.rstrip())
    stats["seconds"] = time.perf_counter() - t0
    log("dryrun", json.dumps({"card": smi, **stats}))
    if len(records) != len(DRYRUN_CELLS) or any(
            k not in rec for rec in records for k in keys) or any(
            rec["chips"] != 256 for rec in records):
        raise AssertionError(f"dryrun: records {records}")
    return stats


def phase_roofline(lm, lm_train, smi) -> dict:
    """``RooflineReport`` with ``DEFAULT_H100`` at one chip for the measured
    LM train step (chatglm3-6b at ``LM_TRAIN_LAYERS`` layers,
    ``LM_TRAIN_BATCH``, ``train_cost(remat=False)``: the smoke's steps do
    not recompute) and the served decode step (chatglm3-6b FULL,
    ``LM_SLOTS`` slots over ``LM_MAX_SEQ``, ``decode_cost`` with an int8
    cache, ``kv_dtype_bytes=1.125``): each term, the dominant one and the
    measured p50 over ``bound_time_s``; then ``train_flop`` (the smoke's
    own FLOP count, which its "share of peak" lines use) beside
    ``train_cost(remat=False).flops`` (3 x ``forward_flops``) for every
    config the smoke trains."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.analytic import decode_cost, train_cost
    from repro_torch.launch.roofline import RooflineReport

    def report(cfg, shape, cost, p50_ms):
        rep = RooflineReport(arch=cfg.name, shape=shape.name, mesh="single", chips=1,
                             hlo_flops=0.0, hlo_bytes=0.0, collective_bytes=0.0,
                             collective_breakdown={}, analytic_flops=cost.flops,
                             analytic_bytes=cost.hbm_bytes, gpu=DEFAULT_H100)
        row = {"arch": cfg.name, "layers": cfg.num_layers, "shape": dataclasses.asdict(shape),
               "flops": cost.flops, "hbm_bytes": cost.hbm_bytes, "notes": cost.notes,
               "compute_s": rep.compute_s, "memory_s": rep.memory_s,
               "collective_s": rep.collective_s, "dominant": rep.dominant,
               "bound_time_s": rep.bound_time_s, "measured_p50_s": p50_ms / 1e3,
               "p50_over_bound": p50_ms / 1e3 / rep.bound_time_s}
        log("roofline", json.dumps({"card": smi, **row}))
        return row

    chatglm = get_config(LM_ARCH)
    b, s = LM_TRAIN_BATCH
    train_cfg = dataclasses.replace(chatglm, num_layers=LM_TRAIN_LAYERS)
    train_shape = ShapeConfig("lm-train", s, b, "train")
    serve_shape = ShapeConfig("lm-serve", LM_MAX_SEQ, LM_SLOTS, "decode")
    out = {"train": report(train_cfg, train_shape, train_cost(train_cfg, train_shape,
                                                              remat=False),
                           lm_train["train"]["step_p50_ms"]),
           "decode": report(chatglm, serve_shape, decode_cost(chatglm, serve_shape,
                                                              kv_dtype_bytes=1.125),
                            lm["step_p50_ms"]),
           "train_flop": []}
    trained = ((train_cfg, LM_TRAIN_BATCH),
               (dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS),
                MOE_TRAIN_BATCH),
               (dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS),
                VLM_TRAIN_BATCH),
               (get_config(AUDIO_ARCH), AUDIO_TRAIN_BATCH),
               (get_config("xlstm-125m"), REC_TRAIN_BATCH),
               (dataclasses.replace(get_config("zamba2-7b"), num_layers=ZAMBA_TRAIN_LAYERS),
                REC_TRAIN_BATCH))
    for cfg, (b, s) in trained:
        ours = train_flop(cfg, b * s, s)
        analytic = train_cost(cfg, ShapeConfig("train", s, b, "train"), remat=False).flops
        row = {"arch": cfg.name, "layers": cfg.num_layers, "batch": [b, s],
               "train_flop": ours, "train_cost_flops": analytic,
               "train_flop_over_train_cost": ours / analytic}
        log("roofline train_flop", json.dumps(row))
        out["train_flop"].append(row)
    return out


def phase_quickstart(torch) -> dict:
    """``repro_torch.launch.quickstart.main`` on the card: the flat
    crossbar kernel over 32 queries, which ``main`` holds against the
    dense oracle at the quickstart's tolerance; its launches counted."""
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.launch import quickstart

    crossbar_reduce_cuda.launches = 0
    res = quickstart.main(device=DEVICE)
    torch.cuda.synchronize()
    launches = crossbar_reduce_cuda.launches
    out = res.pop("out")
    if (launches <= 0 or not out.is_cuda or not bool(torch.isfinite(out).all())
            or out.shape != (quickstart.KERNEL_QUERIES, quickstart.DIM)
            or not res["max_abs_err"] <= quickstart.ATOL):
        raise AssertionError(f"quickstart: {launches} launches, device {out.device}, "
                             f"shape {tuple(out.shape)}, max_abs_err {res['max_abs_err']}")
    stats = {**res, "atol": quickstart.ATOL, "launches": launches}
    log("quickstart", json.dumps(stats))
    return stats


def kernel_entry(name, source, replaces, launches, row) -> dict:
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        # None where no single PyTorch call computes the function
        "library_ms": row.get("library_ms"),
    }


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the repository")
    # lm-train's deterministic runs need it before the first cuBLAS call
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(SRC))
    import numpy as np

    # the timed phases run unvalidated; validated() turns the validators
    # on around the untimed correctness runs only
    os.environ["RECROSS_VALIDATE"] = "0"

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    from repro_torch.kernels import _build

    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:
        built = dict(zip(_build.LIBRARIES, pool.map(_build.build, _build.LIBRARIES)))
    _build.load_crossbar()
    _build.load_embedding_bag()
    _build.load_decode_attention()
    for name, (path, build_s, build_log) in built.items():
        log(f"build: {path.relative_to(ROOT)} in {build_s:.2f} s")
        for line in ptxas_summary(build_log):
            log(f"ptxas: {line}")

    # host seconds of each phase since the previous mark (build included)
    phase_s, last = {}, [t_start]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

    mark("build")
    timer = Timer(torch)
    phase_parity(torch, timer)
    mark("parity")
    serving, serving_row, server, tables, streams, histories, served = phase_serving(
        torch, np, timer)
    mark("serving")
    serving_async, async_rows = phase_serving_async(torch, np, tables, histories, streams,
                                                    served)
    torch.cuda.empty_cache()
    mark("serving-async")
    serving_mesh = phase_serving_mesh(torch, np, tables, histories, streams, served,
                                      serving_async, async_rows)
    del async_rows
    torch.cuda.empty_cache()
    mark("serving-mesh")
    serving_replan = phase_serving_replan(torch, np, timer, tables, histories, served,
                                          serving_async)
    torch.cuda.empty_cache()
    mark("serving-replan")
    serving_tiers = phase_serving_tiers(torch, np, tables, histories, served, serving_replan)
    del served
    torch.cuda.empty_cache()
    mark("serving-tiers")
    # the untimed correctness runs go under the validators
    counts = {"plans": 0, "patches": 0, "drains": 0}
    with validated(counts):
        bits = phase_async_bits(torch, np)
        phase_chaos_bits(torch, np)
    torch.cuda.empty_cache()
    mark("validated bits and chaos")
    full_s = {"serving": serving["validate_s"], "serving-async": serving_async["validate_s"],
              "serving-mesh (a)": serving_mesh["a"]["validate_s"],
              "serving-mesh (b) rank 0": serving_mesh["b"]["validate_s"],
              "serving-replan": serving_replan["validate_s"],
              "serving-tiers": serving_tiers["validate_s"]}
    analysis = {"validated_counts": counts,
                "validated_runs_s": phase_s["validated bits and chaos"],
                "full_validate_s": full_s, "lock_monitor": bits["lock_monitor"]}
    log("analysis", json.dumps(analysis))
    if min(counts["plans"], counts["patches"], counts["drains"]) <= 0:
        raise AssertionError(f"analysis: a validator never ran: {counts}")
    flat = phase_flat(torch, timer, server, tables, streams)
    mark("flat")
    quick = phase_quickstart(torch)
    mark("quickstart")
    eb_row = phase_embedding_bag(torch, timer)
    mark("embedding-bag")
    dlrm = phase_dlrm(torch, np, timer, server, tables, histories)
    mark("dlrm")
    dcnv2 = phase_dcnv2(torch, np)
    torch.cuda.empty_cache()
    mark("dcnv2")
    # the LM phases start from an empty card: their peak memory is their own
    del server, tables, streams, histories
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    da_row = phase_decode_kernel(torch, timer)
    mark("decode-kernel")
    torch.cuda.reset_peak_memory_stats()
    lm = phase_lm(torch, np, timer)
    mark("lm")
    del timer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm_train = phase_lm_train(torch, np)
    mark("lm-train")
    torch.cuda.empty_cache()
    timer = Timer(torch)
    lm_families = phase_lm_families(torch, np, timer)
    del timer
    mark("lm-families")
    torch.cuda.empty_cache()
    phase_lm_recurrent(torch, np, smi)
    mark("lm-recurrent")
    torch.cuda.empty_cache()
    phase_lm_mesh(torch, np, smi)
    mark("lm-mesh")
    phase_dryrun(smi)
    mark("dryrun")
    phase_roofline(lm, lm_train, smi)
    mark("roofline")

    crossbar_src = "src/repro_torch/kernels/csrc/crossbar_reduce.cu"
    kernels = [
        # launches over the serving, serving-async, serving-mesh (every
        # rank), serving-replan, serving-tiers and dcnv2 phases
        kernel_entry("crossbar_reduce_blocked", crossbar_src,
                     "src/repro/kernels/crossbar_reduce.py:103",
                     serving["kernel_launches"] + serving_async["kernel_launches"]
                     + serving_mesh["kernel_launches"]
                     + serving_replan["kernel_launches"] + serving_tiers["kernel_launches"]
                     + dcnv2["kernel_launches"],
                     serving_row),
        # launches over the flat-op, quickstart and DLRM phases
        kernel_entry("crossbar_reduce_flat", crossbar_src,
                     "src/repro/kernels/crossbar_reduce.py:54",
                     flat["launches"] + quick["launches"] + dlrm["crossbar_launches"],
                     flat["row"]),
        kernel_entry("embedding_bag", "src/repro_torch/kernels/csrc/embedding_bag.cu",
                     "src/repro/kernels/embedding_bag.py:57",
                     dlrm["embedding_bag_launches"], eb_row),
        kernel_entry("fused_decode_attention",
                     "src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:94",
                     lm["kernel_launches"] + lm_train["kernel_launches"]
                     + lm_families["kernel_launches"], da_row),
    ]
    # the flash-decode kernel at the two served layers, beside SDPA there
    moe_layer = lm_families["moe_serve"]["served_layer"]
    kernels[-1]["served_layers"] = [
        {"case": "da-served", "ms": lm["served_kernel_ms"],
         "bound_ms": lm["served_kernel_bound_ms"], "library_ms": lm["served_library_ms"]},
        {"case": "moe-served-layer", "ms": moe_layer["ms"],
         "bound_ms": moe_layer["bound_ms"], "library_ms": moe_layer["library_ms"]},
    ]
    log("phases", json.dumps(phase_s))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
