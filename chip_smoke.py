#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in this order, each printing one JSON line; any failure raises and
exits non-zero:
  device    — GPU name, count, torch/CUDA versions, power limit;
  build     — compile every kernel library from csrc/ with nvcc, all at once;
              then the flash, decode, linear-scan, aggregation and codec
              libraries' kernels: registers, spills and static shared memory
              (ptxas), dynamic shared memory, and the count of HGMMA (wgmma)
              instructions in the flash library's SASS, which must be > 0;
  analysis  — the port's static analysis (python -m repro_torch.analysis)
              over the checkout's port tree: 0 findings, and its seconds;
              per kernel what its CUDA pack resolved from the sources
              (__launch_bounds__ threads, static and dynamic shared memory,
              or "unresolved" where a figure depends on a template
              parameter) beside what nvcc built: every folded dynamic
              figure equal to the library's exported one and every folded
              static figure to ptxas's, static (ptxas)
              plus dynamic shared memory within the card's opt-in maximum a
              block, registers x launch-bounds threads within 65,536;
  agree     — the batched engine against the scalar engine on the card at a
              small config (PERFECT f32 and int8, LOSSY f32 and int8, long
              delays int8, and every churn action on LOSSY f32 one round at
              a time and int8 in windows of 3), and the card against the
              CPU: traffic counters and `active` exact, the live ids equal;
              weights within 1e-4 on the f32 wire; on the int8 wire
              within a bound for codes flipped by SGD float noise, and
              within 1e-4 once that noise is removed (float64 SGD); under
              churn, whose schedule amplifies that noise, the float64-SGD
              runs within 1e-4 and the float32 runs' gaps reported. Then
              the metric streams (telemetry on, float64 SGD) of PERFECT
              f32, LOSSY f32 and int8, and every churn action on int8 in
              windows of 3: the scalar engine, the batched engine one round
              at a time and in windows byte-identical on the card; against
              the port's scalar engine on the CPU the SGD-free columns
              exact, the norms within a relative 1e-5, the protocol trace
              (pid 1) event for event;
  main      — the PERFECT f32 path at full width: 100 agents train the
              paper's 785x500x100x10 MLP on 60,000 samples for 3 rounds
              through make_simulation(engine="vectorized"); the scalar engine
              is the reference (counters exact, round-0 weights within 1e-3);
  main_int8 — the same at full width on the LOSSY network and the int8 wire;
  main_window — the PERFECT f32 path at the same width in multi-round
              windows: 4 rounds, scan_rounds=2 (two windows, each one CUDA-
              graph replay; one capture). Bit for bit the same rounds run
              one at a time on the card (weights, evaluated accuracies,
              counters); the scalar engine's counters every round and its
              round-0 weights as in main; one graph, 2 dispatches, the
              kernel launches of the warm-up round and of each replay
              exactly; per window: wall time, capture apart from replay,
              host phases (fate_draw, control, batches), peak memory. Then,
              past the checked rounds, 4 more replays (the median and
              spread of a replayed window) and one under torch.profiler:
              the kernels it shows, by symbol, must be those the capture
              recorded;
  main_int8_window — the same for the int8 LOSSY path: 6 rounds,
              scan_rounds=3, eval_cadence=3;
  main_churn — the int8 LOSSY path at the same width under churn: 12
              rounds, scan_rounds=3, half the agents offline at round 3 and
              back at 7 (the paper's Fig. 3b outage, shortened), a crash at
              7, a leave and a join at 9. Event rounds replay on the scalar
              oracle; the spans between (rounds 0-2, 4-6, 8, 10-11) are
              re-snapshotted and run one window each, a graph captured
              anew in each span. Bit for bit the same schedule run one
              round at a time on the card; the scalar engine's counters and
              `active` every round, its live ids and round-0 weights as in
              main; 4 dispatches; the kernel launches of each span's
              warm-up round and replay exactly, and a profiled replay's
              kernels by symbol; peak memory no span more than 10% over the
              first. Reports each span's seconds a round, each event's
              boundary cost (device_to_scalar, the oracle round, snapshot
              with harvest, graph_capture), the baseline run without churn
              and the overhead per event;
  main_telemetry — telemetry at full width on the configs of
              main_int8_window (6 rounds, W=3, eval_cadence=3) and
              main_window (4 rounds, W=2): each run in windows with
              telemetry off and on, and one round at a time with it on.
              Weights and history bit for bit off against on, the same
              kernel launches and graph records; the windowed stream byte
              for byte the per-round stream (skipped rounds carrying the
              last evaluated accuracies); every row's totals the engine's
              counters and its channel columns their change; for int8 the
              first 2 rounds' SGD-free columns those of the scalar engine.
              Reports 5 replayed windows' seconds off and on, timed in
              turns (median, spread, phases), each run's peak memory, a
              profiled replay's kernels, copies and device seconds off and
              on, and the kernels by which they differ;
  baselines — the paper's baselines (repro_torch.fl run_centralized and
              run_gossip, batched on the card): (a) at agree's data, 5
              agents, 3 rounds, against the reference's per-agent bodies
              written here over the port's LocalTrainer and numpy's means:
              with float64 SGD the weights bit for bit, bytes_total the
              closed forms exactly every round, the float32 gap reported;
              (b) fig2, Fig. 2a's largest cell (50 agents on main's data,
              K=10, pi=2, rho=2, 40 rounds, 5 agents evaluated): IPLS on the
              batched engine in windows of 8 against centralized FedAvg on
              the same shards, both accuracy series, the final drop per
              mille (reported, not gated), seconds per round (the capture
              apart), peak memory; centralized must learn; (c) gossip at
              main's 100 agents and data (fanout 2, K=10, 3 rounds): seconds
              per round by phase (host draws, sgd, pull, eval), peak memory,
              bytes per agent per round beside main's. The port's examples
              (quickstart, churn_demo) run as processes on the card while
              (a) runs, and must exit 0;
  lm_agree  — the LMs (gemma3, internlm2, phi4-mini, minitron, granite-moe,
              deepseek-v2-lite, qwen2-vl, zamba2, whisper, rwkv6) at their
              reduced configs: the port on the card (attention and scan
              kernels) against the port on the CPU (plain versions), same
              weights from one seed, prompts of 16 and 100 tokens
              (gemma3-reduced's 8-slot rings wrap; zamba2-reduced's chunked
              scan pads 100 to 112; qwen2-vl's positions3 hold an image by
              Qwen2-VL's rule; whisper encodes as many frames as the prompt
              has tokens), 8 decode steps; each attention kernel launched
              once per attention layer and step, zamba2's shared attention
              once per application, whisper's flash once per encoder layer
              and twice per decoder layer (self, cross) and its decode
              twice per decoder layer and step; logits within one bfloat16
              ulp (+1e-5) in float32 weights, within 0.03 in bf16 (zamba2:
              0.1; whisper: 0.3);
  train_agree — the IPLS train step (repro_torch.core.sharded through
              launch.steps.build_train_step) on the card's smoke mesh (a
              one-process NCCL group), internlm2-reduced in float32: 3
              steps of SGD 0.5 with clip 1.0, then 3 of AdamW with
              accum_steps=2. Bit for bit the card's step without a mesh;
              each step against the same step on the CPU from the card's
              state before it, in float32 (loss, moments, AdamW params,
              step and eps within stated bounds) and in float64 (the SGD
              params and every grad norm: the card at most twice as far
              from it as the CPU's float32 step); checkpointed after step
              2 and restored into a fresh model, bit for bit the
              uninterrupted run; no kernel launched. Then one SGD step
              (0.5, clip 1.0) of each other family's reduced config in
              float32 (granite-moe, gemma3, zamba2, rwkv6, whisper with 64
              frames a clip) on the card, without a mesh and through
              build_train_step on the smoke mesh (bit for bit, but MoE,
              whose mesh path sizes capacity by the rank's tokens), against
              the same step on the CPU: the loss within 1e-5 of max(1,
              |loss|), params and grad norm no farther from the CPU's
              float64 step than twice its float32 step (+1e-7), step and
              eps exactly;
  train     — the LM training path at full width: internlm2-1.8b
              (1,889,110,016 bf16 parameters, nothing cut) through
              build_model, make_smoke_mesh and build_train_step with the
              default AdamW and IplsStepConfig() (eps on, clip 1.0), global
              batch 2 x 4,096 tokens from synth_tokens (train_4k's sequence,
              its batch of 256 cut to 2), 5 steps: build seconds, each
              step's seconds, the median of the steps after the first,
              tokens/s, model FLOP/s (6 x the active parameters x tokens)
              and its share of the 989 TFLOP/s bf16 peak, peak memory over
              the phase's base, losses, grad norms and eps (the
              recursion's values exactly, step 5 at the end, finite, the
              first layer's matrices changed, no kernel launched); then one
              step split by a syncing phase timer (forward, backward with
              the recompute, update with the collectives), one under
              torch.profiler (the shares of the named ranges: their
              forward and recompute kernels), and the plain pieces alone
              at a layer's shapes, forward and with backward (the
              training attention by kind, the chunked scans), with their
              share of a step;
  train_moe, train_gemma3, train_zamba2, train_whisper, train_rwkv —
              the same for each other family that trains on one card,
              3 steps each at 4,096 tokens: granite-moe-3b-a800m
              (3,298,793,472 parameters) at batch 2, gemma3-1b
              (999,826,048; vocab 262,144) at 2, zamba2-1.2b
              (1,104,937,856; Mamba2 through the chunked SSD scan, the
              shared blocks after each period) at 2, whisper-base
              (116,792,832; 2 x 4,096 frames drawn from the seed) at 2,
              and rwkv6-7b at batch 1 at full width on 13 of its 32 layers
              (3,379,679,232 parameters: the whole model's weights,
              gradients and AdamW moments, about 90 GB, exceed one card;
              the time mix through the plain chunked scan, chunks of 16);
  serve     — the LM main path at full width: internlm2-1.8b
              (1,889,110,016 parameters, bf16) through build_model and
              serve_lm.generate, batch 4, a 4,096-token prompt from the seed,
              256 greedy tokens, every decode step after the first one
              replay of a CUDA graph (254 replays, each recording 24
              flash-decode launches); exactly 24
              flash-attention and 24 x 255 flash-decode launches (counted
              through the replays); a second graph run and an eager run
              (graph=False) of the first EAGER_COMPARE_TOKENS tokens: the
              same tokens, every step's logits bit for bit; prefill and
              decode times (the capture apart), the eager decode's, peak
              memory over the phase's base, flash attention's share of the
              prefill's device time, finite logits; 8 eager decode steps
              and 8 replays of the step's graph under torch.profiler (device
              time, busy share, no host sync, 24 x 8 flash-decode kernels in
              the replays); decode at pos 4,096 against the last-token
              logits of a 4,097-token prefill, in bf16 and, for the served
              prompt and a second one, in float32 weights, end to end
              and block by block (each block's decode from its prefill
              input: float32 within 1e-4 of its output's scale, bf16 no
              worse than the bf16 prefill against the block run in
              float32; LAYER_TOL); no host sync in 8 decode steps;
  serve_rwkv — the RWKV6 path at full width: rwkv6-7b (7,534,546,944
              parameters, bf16) through build_model and serve_lm.generate,
              batch 4, a 4,096-token prompt from the seed, 128 greedy tokens;
              exactly 32 linear-scan launches (one per time-mix layer, in the
              prefill) and none of any other kernel; the same numbers and
              checks as serve, the 4,097-token prefill running the kernel's
              ragged last chunk;
  serve_moe — the MoE family at full width: granite-moe-3b-a800m
              (3,298,793,472 bf16 parameters, 882,872,832 active, nothing
              cut) through build_model and serve_lm.generate, batch 4, a
              4,096-token prompt, 128 greedy tokens; exactly 32 flash and
              32 x 127 decode launches (head_dim 64), none of any other
              kernel; serve's numbers, and the profiler's shares of the MoE
              layers' named ranges (dispatch and combine, expert GEMMs);
              no host sync (cudaStreamSynchronize, .item()) in 8 decode
              steps. Decode at pos 4,096 vs a 4,097-token prefill: the
              served config's gap reported (its capacity drops differ
              between 4 and 16,388 tokens, and its prefill of 4,097-token
              rows runs in one group, the served one in 32), and serve's
              checks on a copy whose capacity keeps every choice
              (capacity_factor = experts / top_k, same weights); the
              end-to-end limits in bf16 and float32 given way to the
              witness of WITNESS_FACTOR's note (the model's own gain);
  serve_mla — the same for deepseek-v2-lite-16b (15,706,484,224 bf16
              parameters, 2,451,432,960 active; MLA and 64 routed experts
              top-6 with 2 shared): batch 4, a 4,096-token prompt, 64
              tokens, no kernel launch; its decode-vs-prefill checks at
              batch 1 (its float32 copy is 63 GB), the bf16 end-to-end
              limit given way to the witness;
  serve_gemma3 — sliding windows at full width: gemma3-1b (999,826,048
              bf16 parameters, nothing cut; 22 local layers with a 512-key
              window and 512-slot ring caches, 4 global ones; head_dim 256,
              4 query heads on 1 kv head) through build_model and
              serve_lm.generate, batch 4, a 4,096-token prompt, 128 greedy
              tokens; exactly 26 flash (head_dim 256, 22 of them windowed)
              and 26 x 127 decode launches, counted apart by window and by
              cache (22 x 127 on the rings); serve's numbers and checks;
  serve_zamba2 — Mamba2 and shared blocks at full width: zamba2-1.2b
              (1,104,937,856 bf16 parameters, 1,440,500,608 active with the
              shared blocks counted per application; 38 Mamba2 blocks, the
              shared attention (32 heads of 64) and MLP applied after each
              of 6 periods) through build_model and serve_lm.generate,
              batch 4, a 4,096-token prompt, 128 greedy tokens; exactly 6
              flash and 6 x 127 decode launches; serve's numbers and checks
              and the profiler's shares of the Mamba2 ranges (in, ssd, out);
              the bf16 end-to-end limit given way to the witness;
  serve_whisper — the encoder-decoder at full width: whisper-base
              (116,792,832 bf16 parameters, 83,236,352 active, nothing cut)
              through build_model and serve_lm.generate, 16 clips of 1,500
              frames (30 s of audio) drawn from the seed, a 4-token decoder
              prompt, 128 greedy tokens; exactly 18 flash launches (6
              non-causal in the encoder, 6 causal, 6 cross-attention with 4
              query rows against 1,500 keys) and 12 x 127 decode launches
              (6 x 127 on the 132-slot self caches, 6 x 127 on the
              1,500-slot cross caches), counted apart by kind; serve's
              numbers and checks over the decoder blocks (the encoder's
              output shared by prefill and decode);
  serve_qwen2_vl — M-RoPE at full width on 16 of qwen2-vl-72b's 80 layers
              (16,534,380,544 bf16 parameters, 15,288,664,064 active: its
              float32 copy, 66.1 GB, is the most one card holds): batch 4,
              a 4,096-token prompt holding one 32 x 32-patch image by
              Qwen2-VL's positions3 rule, 128 greedy tokens; exactly 16
              flash (8 query heads a kv head) and 16 x 127 decode launches
              (group 8); serve's numbers and checks, decode vs prefill with
              positions3 extended by (P, P, P) (the position decode rotates
              the token at), the float32 checks at batch 1;
  serve_phi4_mini, serve_minitron — the dense family's larger archs at
              full width (nothing cut): phi4-mini-3.8b (3,836,021,760 bf16
              parameters) and minitron-4b (4,190,309,376), batch 4, a
              4,096-token prompt, 64 tokens, through the graph; exactly 32
              flash and 32 x 63 decode launches; serve's numbers, graph
              against eager bit for bit, and the bf16 decode-vs-prefill
              checks end to end (its limit given way to the witness) and
              block by block (no float32 copy: serve holds the same code);
  serve_steps — the step builders at full width on the card's smoke mesh
              (a one-process NCCL group, started and destroyed here):
              build_prefill_step, then build_decode_step(graph=True)
              greedily for 31 steps (30 replays), for internlm2-1.8b,
              granite-moe-3b-a800m, rwkv6-7b (batch 4, 4,096-token prompts)
              and whisper-base (16 clips of 1,500 frames, a 4-token prompt):
              the dense, rwkv6 and whisper logits bit for bit
              serve_lm.generate's on the same weights and prompt;
              granite-moe's (the MoE mesh path: one group, capacity from
              the rank's tokens) bit for bit its built step run eagerly,
              the gap to generate's grouped path reported; the sha256 of
              each arch's built prefill and step logits and tokens, for
              comparing two commits bit for bit (train's losses print
              exactly, as Python floats);
  long_gemma3, long_zamba2, long_rwkv — the registry's long_500k shape
              (batch 1, 524,288 cache slots) for gemma3-1b, zamba2-1.2b and
              rwkv6-7b at full width in bf16 through build_decode_step
              (graph=True; the long-context rules) on the smoke mesh:
              gemma3 after a real 524,280-token prefill (its seconds and
              peak), zamba2 and rwkv6 on caches drawn from the seed at a
              4,096-token prefill's per-leaf scale; 8 decode steps to pos
              524,287 (the first eager, then replays): decode_attention's
              launches the model's count x 8, the same steps run eagerly
              from a copy of the start cache bit for bit (logits and
              caches); replayed and eager ms a step; the decode kernel on
              the cell's own first full-length cache at pos 524,287 against
              its plain version (one bf16 ulp + 2e-5) and timed against its
              bound and SDPA; gemma3: decode at 524,280 against a
              524,281-token prefill (within 0.5), RoPE's cos and sin on the
              card at 524,287 and 4,096 against float64;
  roofline  — one line a measured cell (every train*, serve* decode step
              and long cell): its roofline on one H100 (repro_torch.roofline,
              counted on fake tensors by ``python -m repro_torch.roofline``
              on the host's CPU, started with the run) beside the measured
              step, and the roofline's share of it;
  kernel    — the f32 aggregation kernel against its plain PyTorch version,
              bit for bit, at the main path's shape (K=20, R=51, S=44361),
              ragged cases and the single-partition form; kernel (device
              time from CUDA-graph replay, and per wrapper call), plain and
              one-call yardstick times (CUDA events) beside the bound;
  kernel_q  — the int8 codec kernels (quantize, dequantize) and the quantized
              aggregation kernel against their plain versions, bit for bit
              (bit patterns: the sign of zero counts), at the int8 path's
              shapes, every lane width the kernel takes, S = 1, 16, 17, 1023,
              1025, 70001, R = 1 and inputs whose sums are signed zeros;
              times and bounds; for the quantized aggregation the lanes a
              thread owns and the time before this design (175.3 us; the
              time at every width: aggregate_variants.py);
  kernel_attn — the attention kernels against their plain versions at the
              serve shapes (flash B=4, H=16, KV=8, S=4096, D=128; decode at
              T=4352, pos 0, 255, 4095, 4351), at serve_moe's (flash B=4,
              H=24, KV=8, S=4096, D=64; decode at T=4352, the same pos) and
              ragged ones (flash S = 1, 100, 128, 129, 300, 4097, and q x 8
              to drive the online rescale; D = 16, 64, 128): float32 within
              2e-5; decode in bf16 within one bf16
              ulp (+2e-5), two calls bitwise equal, and a CUDA graph of one
              decode call replayed with pos 0, 255, 4095, 4351 written into
              its pos tensor bitwise equal to the eager call and within the
              same bound of the plain version (at both head sizes); flash
              in bf16, which rounds
              P to bf16 on the tensor cores, within 2**-7 * attn(q, k, |v|)
              + one bf16 ulp + 2e-5 of both the plain version and the plain
              tiled version (with, for each, the elements beyond two bf16
              ulps); times beside the bound (achieved TFLOP/s, share of the
              bound; decode: the split count and the other candidate's time)
              and scaled_dot_product_attention as the yardstick, at D = 128
              and D = 64; at gemma3's head_dim 256 (flash B=4, H=4, KV=1,
              S=4096, causal and with window 512, float32 and bf16, and
              windows of 1, 7, 65 and 130 keys on ragged S; decode at
              T=4224, pos 4223, and on a 512-slot ring at pos 4223
              (wrapped) and 300), the same checks, the flash and decode
              times at the served shapes (window 512 against SDPA with the
              same mask); whisper's and qwen2-vl's shapes: flash with query
              and key lengths apart (the served cross shape (16, 8, 8, Sq 4,
              Sk 1,500, 64), 1 query against 1,500 keys at D = 16, 300
              against 77 at D = 64, q x 8), the encoder's (16, 8, 8, 1500,
              64) non-causal and qwen2-vl's (4, 64, 8, 4096, 128) causal,
              a mask with Sq != Sk refused before a launch; decode at group
              1 (whisper: the 132-slot self cache, the 1,500-slot cross
              cache at pos 1,499 and past T) and group 8 (qwen2-vl:
              (4, 64, 8, 4224, 128)); the same checks, graph replays at the
              cross and qwen2-vl shapes, and times at every served shape
              against the bound and SDPA;
  tp_kernels — the kernel forms of a "model" mesh axis above 1 (tensor
              parallelism, which one card cannot run across ranks: the
              gloo tests hold the paths), at full width in bf16: flash-
              decode's partial form on serve's and phi4-mini's caches (4,
              16 | 24, 8, 4352, 128) at pos 4,351 split into 2, 4 and 16
              slices, and at pos 255 into 16 (15 of them empty), each
              slice against the plain partial (output within
              2e-5 of its scale, log-sum-exp within 2e-5; an empty slice 0
              and -inf exactly), the merge (ops.merge_partials, the
              context-parallel decode's) of the kernel's partials against
              the plain merge of the plain ones (within 2e-6 of the
              output's scale, float32) and, rounded to bf16,
              against one whole call (one bf16 ulp + 2e-5) and decode_ref;
              one slice's time at 16 beside its bound and SDPA over the
              same slice; flash's query offset at phi4-mini's sequence-
              parallel prefill (q (4, 24, 256, 128) against k, v (4, 8,
              4096, 128), causal, offsets r * 256 for r = 0, 7, 15): the
              rows bit for bit those of one full causal call (the same key
              tiles in the same order), and within the bf16 flash bound of
              the plain version on each offset's two 128-row query tiles;
              the r = 15
              call's time beside its bound (the operations over 989
              TFLOP/s) and SDPA with the same mask; gemma3-1b's forms at
              the same axis (its 4 heads do not divide 16): flash at a
              query offset over the 512-key window (q (4, 4, 256, 256)
              against k, v (4, 1, 4096, 256), r = 0, 7, 15: bit for bit
              the whole windowed call's rows, within the bf16 flash bound
              of the plain version; r = 15 timed beside its bound, which
              counts the pairs and keys the window keeps, and SDPA with
              the rows' mask) and flash-decode's partial form on the
              512-slot ring (4, 4, 1, 512, 256) cut into 16 slices of 32
              at pos 4,223, merged against the whole ring call and the
              plain merge; the launches are the forms' own counters over
              the phase (the moe_ep, mla_cp, ssm_tp, whisper_tp and
              tp_whole phases, which run after the train cells, are
              described with their constants);
              zamba2-1.2b's shared attention at the same axis: flash
              head-parallel at 2 of its 32 heads (4, 2, 2, 4096, 64) against
              the plain version, timed beside its bound and SDPA, and
              flash-decode's partial form on its (4, 32, 32, 4224, 64)
              cache cut into 16 slices of 264 at pos 4,223;
  kernel_scan — the linear-scan kernel against three plain versions (step
              oracle, chunked scan, the kernel's split order) at the serve
              shape (4, 4096, 64, 64) in float32 and bf16, T = 1, 17, 100,
              300 and 4,097, one head, an initial state, a nonzero bonus,
              strided inputs and log-decays over the model's whole clip
              range: within 3e-5 of the output's scale (bf16: one bf16 ulp
              more), two calls bitwise equal; times beside the bound (no
              PyTorch call computes the recurrence) and the time before this
              design (1.105 ms); the threads and warps a (batch, head) and
              the warps an SM holds (the other splits of the state, their
              occupancy and times: scan_variants.py).
Each main phase sets every kernel's launch count to 0 before it runs and
requires the counts its path must give. After each phase a memory line
gives the device memory it left allocated. Then the kernels line, the
run's seconds, the nvidia-smi line and, last, the result line. Imports nothing of JAX or of the
JAX package.
"""
from __future__ import annotations

import atexit
import collections
import dataclasses
import hashlib
import json
import math
import re
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

# the main path: the paper's MNIST setting at 100 agents
MAIN_DATA = dict(num_train=60000, num_test=10000, seed=0)
MAIN_CFG = dict(
    num_agents=100, num_partitions=10, pi=2, rho=2, rounds=3, local_iters=10,
    batch_size=128, eval_agents=10, engine="vectorized",
)
MAIN_SHAPE = (20, 51, 44361)  # its kernel shape (K_inst, R_cap, S)
# the int8 path at full width (LOSSY: delays of at most 2 ticks, one round
# late, so R_cap = (A-1)*2 remote rows; S padded to whole 1024-blocks)
MAIN_Q_SHAPE = (20, 198, 45056)
DELTA_PLANE = 100 * 10 * 45056  # values the int8 path quantizes per round
VALUE_PLANE = 20 * 45056  # values of one qdq_rows call (the instance plane)
# the card's rates (H100 SXM data sheet: HBM, float32 outside the tensor
# cores, bf16 tensor cores dense): repro_torch.roofline.HW, set in main()
HW = None
WEIGHT_TOL = 1e-4  # engine agreement: f32 GEMM sums in other orders
# full width, round 0: each holder applies eps = 0.51 to a sum of r = 51
# deltas, which amplifies the per-delta GEMM-order noise up to 26-fold
ROUND0_TOL = 1e-3
AGREE_CFG = dict(num_agents=5, num_partitions=8, pi=2, rho=2, rounds=3, local_iters=3)
# the multi-round windows of the main paths: two windows of one (W, evaluation
# pattern), so one capture and one replay of a graph that is already captured
MAIN_WINDOW = dict(rounds=4, scan_rounds=2, eval_cadence=1)
MAIN_Q_WINDOW = dict(rounds=6, scan_rounds=3, eval_cadence=3)
# every membership action at the agree config (tests/test_torch_churn.py).
# At that config the schedule amplifies SGD float noise chaotically: with
# agent 2 offline at round 1, the port's scalar engine alone moves by
# 3.4e-4 (301 weights over 1e-4) on the CPU when its SGD runs in float64
# instead of float32 (8.9e-8 over the same 8 rounds without churn), and on
# the int8 wire that noise flips codes, which feed back. So under churn the
# agree phase holds the weights of the float64-SGD runs, which remove that
# noise, to WEIGHT_TOL (bit for bit on the CPU), and reports the float32
# runs' gaps
CHURN_ALL_ACTIONS = {1: [(2, "offline")], 3: [(4, "leave"), (2, "online")], 4: [(5, "join")],
                     6: [(1, "crash")]}
# the churn path at full width: main_int8 for 12 rounds in windows of 3 under
# a short form of the paper's Fig. 3b outage (half the agents offline, then
# back) plus a crash, a leave and a join (agent 100 takes the shard agent 7's
# crash freed). Oracle rounds 3, 7 and 9; spans 0-2, 4-6, 8 and 10-11
MAIN_CHURN = dict(rounds=12, scan_rounds=3, churn={
    3: [(a, "offline") for a in range(50, 100)],
    7: [(a, "online") for a in range(50, 100)] + [(7, "crash")],
    9: [(13, "leave"), (100, "join")],
})
# the paper's baselines (phase baselines): Fig. 2a's largest cell
# (benchmarks/bench_convergence.py:28-36: 50 agents, 40 rounds, 5 agents
# evaluated) with IPLS in windows of bench_rounds.py's SCAN_W = 8 against
# centralized FedAvg on the same shards; and segmented gossip at the main
# path's width (MAIN_CFG's 100 agents and data), paper §4's traffic
# comparison against IPLS main
FIG2 = dict(num_agents=50, num_partitions=10, pi=2, rho=2, rounds=40, local_iters=10,
            batch_size=128, eval_agents=5, engine="vectorized", scan_rounds=8)
GOSSIP = dict(rounds=3, fanout=2, num_partitions=10, local_iters=10, batch_size=128)
# the port's examples, as a user starts them on the card
EXAMPLES = {
    "quickstart": ("--engine", "vectorized", "--scan-rounds", "5", "--wire-dtype", "int8"),
    "churn_demo": ("--engine", "vectorized", "--scan-rounds", "7"),
}
EXAMPLE_TIMEOUT_S = 300
# windows replayed after a window phase's checks, for the spread of a
# replayed window's time (with the one replay of the checked run), then one
# more under the profiler, whose kernels are counted by symbol
EXTRA_REPLAYS = 4
# main_telemetry: the configs of main_int8_window and main_window, each run
# with telemetry off and on; windows replayed after the checked rounds, per
# run, for the median and spread (then one more under the profiler); the
# int8 config's first rounds also on the scalar engine
TEL_REPLAYS = 5
TEL_SCALAR_ROUNDS = 2
# profiles of one replayed window, each held to the graph's record (up to
# twice as many while none has kept some of its warm-up), and the
# throwaway kernels each profile starts with
PROFILE_TRIES = 3
PROFILER_WARMUP = 32
# the serve phases' profiles of 8 decode-graph replays come later in the
# process, where a profile lost more of its first events: on an H100 the
# 32 spin kernels of serve, serve_rwkv, serve_moe and serve_mla kept 17, 14,
# 7 and 2 (every replay kernel kept), and serve_gemma3's lost all 32 in six
# profiles running; so these start with more of them (about 5 ms)
REPLAY_PROFILER_WARMUP = 512
# the CUDA kernels of the protocol paths' wrappers, by symbol
KERNEL_SYMBOLS = {
    "ipls_aggregate_batched": "ipls_aggregate_batched_kernel",
    "ipls_aggregate_batched_q": "ipls_aggregate_batched_q_kernel",
    "quantize": "quantize_kernel",
    "dequantize": "dequantize_kernel",
}
# the LM main path: internlm2-1.8b at full width, serving
SERVE = dict(arch="internlm2-1.8b", batch=4, prompt_len=4096, tokens=256, seed=0)
SERVE_PARAMS = 1_889_110_016
LM_AGREE_CASES = ((16, 32), (100, 128))  # (prompt length, cache_len)
LM_AGREE_STEPS = 8
# bf16 logits, card vs CPU: both sides run the port's own code, so only the
# order of float32 sums and the roundings to bf16 differ (measured at most
# 8.3e-3 on an H100, about one bf16 ulp at logits of 1-2). The MoE archs'
# routes are the same on both sides on these inputs (a route flipped between
# two gates within a bf16 rounding would move a logit by a whole expert's
# output): 0.0127 (granite-moe) and 0.0039 (deepseek) on an H100
LM_BF16_TOL = 0.03
# zamba2-reduced's Mamba2 blocks amplify their inputs about 400-fold (the
# first block: |x| 0.1 in, 38 out), so in bf16 the card's and the CPU's
# roundings part farther: 0.048 at P=16 (step 7) and 0.028 at P=100 on an
# H100, float32 within one bf16 ulp. Its bf16 bound is about twice the
# larger reading
LM_BF16_TOL_BY_ARCH = {"zamba2-1.2b": 0.1}
# whisper-reduced at the reference's init (std 1/sqrt(2) on every weight
# of its layers, the reference's fan-in over a two-layer stack) scores
# each query against the keys at a std of about 30, so its softmax is all
# but one-hot and a bf16 rounding can move the weight from one key to
# another: its bf16 logits lie up to 0.35 from its float32 ones on the CPU
# (|logit| < 0.65), and card and CPU 0.154 apart on an H100. A bound that
# holds those would pass a wrong kernel. Its bf16 leg therefore takes the
# same draw with every weight matrix of its layers scaled by
# sqrt(2 / d_model), std 1/sqrt(d_model) (``_unit_gain``): there bf16 lies
# 0.0063 from float32 on the CPU, under 1% of the logits' scale, and card
# and CPU 0.0078 apart at both prompt lengths on an H100 (2 bf16 ulps at
# |logit| 0.67), held to about twice that. Its float32 leg keeps the
# reference's init.
LM_BF16_UNIT_GAIN = ("whisper-base",)
LM_BF16_TOL_BY_ARCH["whisper-base"] = 0.016
# decode at pos 4,096 vs the last-token logits of a 4,097-token prefill
# (logits of std about 1.8). The two paths round differently: GEMMs of M = 4
# against M = 16,388 rows, two attention kernels summing in other orders.
# The reference's init (std 1/sqrt(24) on every weight) gives each layer a
# large gain, so 24 layers amplify those differences: in a float32 copy of
# the weights the two paths differed by 0.03125 on an H100 (2 bf16 ulps at
# |logit| 2-4; the same on a second prompt, so the bound is 3.2x the larger
# reading), and in bf16 each side's own roundings add more (0.297). A
# wrong cache slot, position or mask moves logits by their whole scale.
SERVE_DECODE_VS_PREFILL_BF16 = 0.5
SERVE_DECODE_VS_PREFILL_F32 = 0.1
# the LM training path (phase train): internlm2-1.8b at full width through
# build_train_step on the smoke mesh (one card), default_optimizer (AdamW,
# cosine warm-up), IplsStepConfig() (eps on, clip 1.0); train_4k's sequence
# of 4,096 with its global batch of 256 cut to 2 for one card. The other
# families' cells: TRAIN_CELLS.
TRAIN = dict(phase="train", arch="internlm2-1.8b", batch=2, seq_len=4096, steps=5, seed=0)
# phase train_agree: internlm2-reduced in float32, 3 steps of SGD 0.5 with
# clip 1.0, then 3 of AdamW with accum_steps=2, on the card's smoke mesh;
# then one SGD step of each other family's reduced config (whisper with 64
# frames a clip from the seed), card against CPU
TRAIN_AGREE = dict(batch=4, seq_len=64, steps=3, seed=0)
TRAIN_AGREE_FAMILIES = ("granite-moe-3b-a800m", "gemma3-1b", "zamba2-1.2b", "rwkv6-7b",
                        "whisper-base")
TRAIN_AGREE_ADAMW_LR = 1e-3
# A step on the CPU from the card's state before it (float32 products in
# other orders, TF32 off), in float32 and in float64. The reduced model's
# random init makes its attention nearly one-hot, which amplifies float32
# noise: on an H100 the CPU's own float32 SGD step lay 1.0e-4 (params) and
# 5.1e-3 (grad norm, relative) from the same step in float64, the card's
# 3.6e-5 and 1.0e-3, and card and CPU 6.7e-5 and 6.1e-3 apart. So both
# legs are held to the float64 step: the card's gap at most twice the CPU
# float32 step's, plus a floor of 1e-7 for gaps near 0. SGD params by their
# largest |d|. AdamW moves each parameter by about lr * sign(g), and a
# gradient near 0 may change sign between precisions, so its params by the
# L2 norm of the gap over that of the float64 step's update (a skipped step
# is 1, a negated one 2); its moments m and v each by their largest |d|
# over the largest |value| of their own leaf (a skipped update is far off:
# 1 for a first step from zeros). The script checks that a skipped or
# negated AdamW step fails these bounds. Directly: the loss within 1e-5 of
# max(1, |loss|) (measured 9.1e-8), step, eps and participation exactly.
TRAIN_AGREE_TOL = {"float64_ratio": 2.0, "float64_floor": 1e-7, "loss": 1e-5}
# the attention kernels against their plain versions
ATTN_F32_TOL = 2e-5  # as tests/test_kernels.py
# The bf16 flash kernel rounds P = exp(s - m) to bf16 before P V (tensor cores),
# each p within a relative 2**-8, so each output within 2**-8 * attn(q, k, |v|)
# of the float32 product: it is held to twice that, plus one bf16 ulp of the
# larger magnitude (the final roundings) and ATTN_F32_TOL (outputs near 0).
# Decode and the float32 flash path keep one bf16 ulp (+2e-5) and 2e-5.
# The plain tiled version rounds P too, but from float32 p that differ from
# the kernel's in their last bits (summation order, ex2.approx, the folded
# scale): where a bf16 rounding midpoint lies between the two, they round one
# bf16 ulp of p apart. Each is within 2**-8 * attn(q, k, |v|) of the float32
# product, so the two are within 2**-7 * attn(q, k, |v|): the same bound.
FLASH_BF16_P_ROUNDING = 2.0**-7
FLASH_SHAPE = (4, 16, 8, 4096, 128)  # B, H, KV, S, D of the serve prefill
# (shape, causal, q scale): S = 1, at and past one tile, ragged, past 32 tiles;
# q x 8 moves the running max across key tiles (alpha far from 1)
FLASH_D64_SHAPE = (4, 24, 8, 4096, 64)  # granite-moe's prefill (serve_moe)
FLASH_CASES = [(FLASH_SHAPE, True, 1.0), ((2, 16, 8, 100, 128), True, 1.0),
               ((1, 16, 8, 4097, 128), True, 1.0), ((2, 4, 2, 100, 16), True, 1.0),
               ((1, 6, 2, 300, 16), True, 1.0), ((1, 16, 8, 1, 128), True, 1.0),
               ((2, 16, 8, 128, 128), True, 1.0), ((2, 16, 8, 129, 128), False, 1.0),
               ((1, 16, 8, 4097, 128), True, 8.0), ((2, 8, 2, 300, 16), False, 8.0),
               (FLASH_D64_SHAPE, True, 1.0), ((1, 24, 8, 4097, 64), True, 8.0),
               ((2, 24, 8, 129, 64), False, 1.0), ((2, 24, 8, 1, 64), True, 1.0)]
# gemma3-1b's prefill (serve_gemma3): head_dim 256, MQA over 4 heads; its
# local layers' window
FLASH_D256_SHAPE = (4, 4, 1, 4096, 256)
FLASH_WINDOW = 512
# (shape, causal, q scale, window) at head_dim 256 and windows: the served
# shape causal and windowed, windows of 1, of no multiple of a tile and
# across tile edges on ragged S, q x 8 to move the running max
FLASH_WINDOW_CASES = [(FLASH_D256_SHAPE, True, 1.0, None), (FLASH_D256_SHAPE, True, 1.0, 512),
                      ((1, 4, 1, 4097, 256), True, 8.0, 512), ((2, 4, 1, 700, 256), True, 1.0, 1),
                      ((2, 4, 1, 700, 256), True, 1.0, 65), ((1, 4, 2, 700, 128), True, 8.0, 7),
                      ((1, 6, 2, 500, 64), True, 1.0, 130), ((2, 4, 1, 129, 256), False, 1.0, None)]
DECODE_SHAPE = (4, 16, 8, 4352, 128)  # B, H, KV, T, D of the serve decode
# gemma3-1b's decode (serve_gemma3): the global layers' full cache of
# 4,096 + 128 slots, and the local layers' 512-slot rings at the absolute pos
DECODE_D256_SHAPE = (4, 4, 1, 4224, 256)
DECODE_RING_SHAPE = (4, 4, 1, 512, 256)
DECODE_RING_POS = (4223, 300)  # wrapped, and not yet
DECODE_D64_SHAPE = (4, 24, 8, 4352, 64)  # granite-moe's decode (serve_moe)
DECODE_POS = (0, 255, 4095, 4351)
# tp_kernels: the kernels' forms for a "model" mesh axis above 1, at full
# width. Flash-decode's partial form on a cache split over the sequence (the
# context-parallel decode) into TP_SPLITS slices, the last the production
# model axis of 16: serve's cache and phi4-mini's (24 query heads, 8 kv);
# flash's query offset: phi4-mini's sequence-parallel prefill at 16 (each
# rank's 256 query rows of 4,096 against every key), at offsets r * 256
TP_DECODE_SHAPES = (DECODE_SHAPE, (4, 24, 8, 4352, 128))
TP_SPLITS = (2, 4, 16)
TP_FLASH_SHAPE = (4, 24, 8, 4096, 128)
TP_FLASH_M = 16
TP_FLASH_RANKS = (0, 7, 15)
TP_MERGE_TOL = 2e-6  # merged partials against the plain merge, of the output's scale
TP_EMPTY_POS = 255  # at 16 slices of 272 slots every slice but the first holds no valid key
# gemma3-1b on a model axis of 16, which its 4 heads do not divide: its local
# layers' sequence-parallel prefill (each rank's 256 query rows of 4,096 at
# their offset over the 512-key window: flash at a query offset with a
# window) and its local layers' context-parallel decode (the 512-slot ring
# cut into 16 slices of 32, at the wrapped pos 4,223)
TP_FLASH_WINDOW_SHAPE = (4, 4, 1, 4096, 256)
TP_FLASH_WINDOW = 512
TP_RING_SHAPE = DECODE_RING_SHAPE
TP_RING_POS = 4223
# zamba2-1.2b's shared attention on a model axis of 16: its head-parallel
# prefill (2 of its 32 heads a rank, the whole 4,096-token sequence) and its
# context-parallel decode (one rank's 264 of the serve decode's 4,224 slots)
TP_ZAMBA2_FLASH_SHAPE = (4, 2, 2, 4096, 64)
TP_ZAMBA2_DECODE_SHAPE = (4, 32, 32, 4224, 64)
# whisper-base's attention (serve_whisper): the encoder's self-attention
# (B, H, KV, S, D, non-causal), the decoder's causal self-attention over
# the 4-token prompt, its cross-attention (B, H, KV, Sq, Sk, D: the
# prompt's 4 rows against the 1,500 frames), and decode on the 132-slot
# self caches and the 1,500-slot cross caches; qwen2-vl-72b's
# (serve_qwen2_vl): flash with 8 query heads a kv head, decode at the
# largest group the kernel takes (MAX_GROUP 8)
FLASH_WHISPER_ENC_SHAPE = (16, 8, 8, 1500, 64)
FLASH_WHISPER_SELF_SHAPE = (16, 8, 8, 4, 64)
FLASH_WHISPER_CROSS_SHAPE = (16, 8, 8, 4, 1500, 64)
FLASH_QWEN2_VL_SHAPE = (4, 64, 8, 4096, 128)
# (shape, causal, q scale): the served shapes, one query row against 1,500
# keys, more queries than keys, q x 8 to move the running max
FLASH_CROSS_CASES = [(FLASH_WHISPER_CROSS_SHAPE, False, 1.0), ((1, 4, 4, 1, 1500, 16), False, 1.0),
                     ((1, 8, 2, 300, 77, 64), False, 1.0), ((1, 8, 2, 300, 77, 64), False, 8.0),
                     ((2, 8, 8, 4, 1500, 64), False, 8.0), (FLASH_WHISPER_ENC_SHAPE, False, 1.0),
                     (FLASH_QWEN2_VL_SHAPE, True, 1.0), (FLASH_WHISPER_SELF_SHAPE, True, 1.0),
                     (FLASH_WHISPER_SELF_SHAPE, True, 8.0)]
DECODE_WHISPER_SELF_SHAPE = (16, 8, 8, 132, 64)
DECODE_WHISPER_CROSS_SHAPE = (16, 8, 8, 1500, 64)
DECODE_QWEN2_VL_SHAPE = (4, 64, 8, 4224, 128)
# the MoE family at full width, serving: granite-moe-3b-a800m (GQA attention
# at head_dim 64 through both attention kernels, 40 experts top-8) and
# deepseek-v2-lite-16b (MLA and 64 routed experts top-6 + 2 shared, plain
# PyTorch: no kernel); (parameters, active parameters) as the reference counts them
SERVE_MOE = dict(arch="granite-moe-3b-a800m", batch=4, prompt_len=4096, tokens=128, seed=0)
SERVE_MOE_PARAMS = (3_298_793_472, 882_872_832)
SERVE_MLA = dict(arch="deepseek-v2-lite-16b", batch=4, prompt_len=4096, tokens=64, seed=0)
SERVE_MLA_PARAMS = (15_706_484_224, 2_451_432_960)
# deepseek's float32 copy is 63 GB: its float32 decode-vs-prefill checks run
# at batch 1
SERVE_MLA_CHECK_BATCH = 1
# sliding windows and Mamba2 at full width, serving: gemma3-1b (head_dim
# 256 through both attention kernels, 22 of its 26 layers windowed) and
# zamba2-1.2b (38 Mamba2 blocks in plain PyTorch, the shared attention at
# head_dim 64 through both kernels); (parameters, active parameters) as the
# reference counts them
SERVE_GEMMA3 = dict(arch="gemma3-1b", batch=4, prompt_len=4096, tokens=128, seed=0)
SERVE_GEMMA3_PARAMS = (999_826_048, 999_824_896)
SERVE_ZAMBA2 = dict(arch="zamba2-1.2b", batch=4, prompt_len=4096, tokens=128, seed=0)
SERVE_ZAMBA2_PARAMS = (1_104_937_856, 1_440_500_608)
# zamba2's Mamba2 blocks amplify their inputs several hundredfold (its
# reduced config's first block: |x| 0.1 in, 38 out), so the rounding
# differences of decode and prefill (the recurrent step against the chunked
# scan, whose state the prefill carries in bf16) grow through 38 of them:
# in bf16 its end-to-end limit follows WITNESS_FACTOR's rule (float32 stays
# within its bound: 0.031 on an H100)
SERVE_ZAMBA2_WITNESSED = ("bf16",)
# Decode vs prefill block by block (``_layerwise``), every served arch: each
# block's decode from its prefill input, against the cache a prefill of the
# first P positions filled, to its prefill output at position P, as a share
# of that output's largest |value|. In float32 weights within LAYER_TOL (a
# wrong cache slot, position, mask, state or expert moves it by its scale).
# In bf16 the decode's gap from the block run in float32 (its weights and
# input cast up) within LAYER_BF16_RATIO times the bf16 prefill's own gap
# from it plus LAYER_BF16_FLOOR (two bf16 ulps): decode rounds no worse than
# prefill.
LAYER_TOL = 1e-4
LAYER_BF16_RATIO = 2.0
LAYER_BF16_FLOOR = 2.0**-7
# An arch whose end-to-end decode-vs-prefill gap in a dtype exceeds its
# bound only through the model's own gain: the witness is the ``carried``
# chain of ``_layerwise``, prefill alone fed the first block's decode output
# at position P (a difference within the block's bound above). Where that
# chain's logits gap already reaches the bound, the end-to-end gap is held
# to WITNESS_FACTOR times it instead; else to the bound. On an H100
# granite's carried chain parted from prefill as its free decode chain did,
# block for block (float32: 3.2e-5 of the scale after the first block,
# 0.014, 0.15, 0.32, 0.49 after blocks 9, 17, 25, 33; 0.80 and 0.79 after
# block 57), and the end-to-end gaps were 0.73-1.03 times the carried
# chain's logits gaps (float32 6.66 / 6.47, 5.59 / 7.63; bf16 9.30 / 9.47).
WITNESS_FACTOR = 2.0
SERVE_MOE_WITNESSED = ("bf16", "float32")
SERVE_MLA_WITNESSED = ("bf16",)
# whisper-base at full width (nothing cut), serving: 16 clips of 30 s of
# audio (whisper's 1,500 encoder frames at 50 a second; the convolutional
# frontend is a stub, the frames drawn from the seed), a 4-token decoder
# prompt (the start-of-transcript sequence), 128 new tokens; (parameters,
# active parameters) as the reference counts them
SERVE_WHISPER = dict(arch="whisper-base", batch=16, prompt_len=4, enc_len=1500, tokens=128,
                     seed=0)
SERVE_WHISPER_PARAMS = (116_792_832, 83_236_352)
# qwen2-vl-72b at full width (d 8192, 64 query heads on 8 kv heads of 128,
# d_ff 29,568, vocab 152,064) on 16 of its 80 layers: 877,684,736 parameters
# a layer and 2,491,424,768 in the untied embedding and head make 33.1 GB of
# bf16 at 16 layers, whose float32 copy (the decode-vs-prefill checks) takes
# 66.1 GB of the card's 80 (20 layers would take 80.2 GB). Batch 4, a
# 4,096-token prompt holding one image by Qwen2-VL's M-RoPE rule (64 text
# tokens, a 32 x 32 patch grid at t = 64, h = 64 + row, w = 64 + column,
# then text from 96 on), 128 new tokens; the float32 checks at batch 1
SERVE_QWEN2_VL = dict(arch="qwen2-vl-72b", batch=4, prompt_len=4096, tokens=128, seed=0,
                      layers=16, image=(64, (32, 32)))
SERVE_QWEN2_VL_PARAMS = (16_534_380_544, 15_288_664_064)
SERVE_QWEN2_VL_CHECK_BATCH = 1
# the dense family's two larger archs at full width (nothing cut), serving:
# phi4-mini-3.8b and minitron-4b, 32 layers of GQA attention (24 query heads
# on 8 kv heads of 128) each, 8 GB of bf16 weights; batch 4, a 4,096-token
# prompt, 64 tokens. serve's checks but the float32 copy, which internlm2's
# serve holds on the same code: graph against eager bit for bit, the
# parameter counts, the bf16 decode-vs-prefill gap end to end and block by
# block. phi4-mini's 32 layers of the reference's high-gain init carried
# that gap to 0.660 on an H100, past SERVE_DECODE_VS_PREFILL_BF16 (internlm2's
# 24 layers: 0.445), so its bf16 end-to-end limit follows WITNESS_FACTOR's
# rule, as granite's and zamba2's do
SERVE_DENSE_LARGE_WITNESSED = ("bf16",)
SERVE_PHI4 = dict(arch="phi4-mini-3.8b", batch=4, prompt_len=4096, tokens=64, seed=0)
SERVE_PHI4_PARAMS = (3_836_021_760, 3_836_018_688)
SERVE_MINITRON = dict(arch="minitron-4b", batch=4, prompt_len=4096, tokens=64, seed=0)
SERVE_MINITRON_PARAMS = (4_190_309_376, 3_403_874_304)
# graph against eager in every serve phase: the first this many tokens
# (None: all of them). The eager loop costs 35-100 ms a step on an H100
# (host-bound), all of them about 60 s of the run, which then took about
# 900 s: the first 32 tokens (31 steps, 30 replays) keep every served arch
# within about 850 s
EAGER_COMPARE_TOKENS = 32
# the step builders at full width, one arch of each family (phase serve_steps)
SERVE_STEPS = (dict(arch="internlm2-1.8b", batch=4, prompt_len=4096, tokens=32, seed=0),
               dict(arch="granite-moe-3b-a800m", batch=4, prompt_len=4096, tokens=32, seed=0),
               dict(arch="rwkv6-7b", batch=4, prompt_len=4096, tokens=32, seed=0),
               dict(arch="whisper-base", batch=16, prompt_len=4, enc_len=1500, tokens=32,
                    seed=0))
# the profiler ranges of the MoE, MLA and Mamba2 layers and of the training
# attention and RWKV6 scan (models/layers.py ``_span``)
SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared", "mla",
         "mamba2.in", "mamba2.ssd", "mamba2.out", "sdpa", "rwkv6.chunked")
# host syncs a decode step must not have (a device value read on the host)
HOST_SYNCS = ("cudaStreamSynchronize", "aten::_local_scalar_dense")
# the RWKV6 path: rwkv6-7b at full width, serving
SERVE_RWKV = dict(arch="rwkv6-7b", batch=4, prompt_len=4096, tokens=128, seed=0)
SERVE_RWKV_PARAMS = 7_534_546_944
# the train cells beside `train` (phase_train), each at full width at
# train_4k's 4,096 tokens with its global batch of 256 cut to fit one card:
# granite-moe (3,298,793,472 bf16 parameters) at 2 (its peak at 2 stays under
# ~75 GB), gemma3-1b at 2 (vocab 262,144: the bf16 logits alone are 4.3 GB),
# zamba2-1.2b at 2, whisper-base at 2 (2 x 4,096 frames of d_model 512 drawn
# from the seed, bf16), rwkv6-7b at 1 and cut in depth: its 32 layers' bf16
# weights and gradients and float32 AdamW moments (about 90 GB) exceed one
# card, so the cell runs the first TRAIN_RWKV_LAYERS at full width, the most
# whose peak stays under ~72 GB. 3 steps each (the median of steps 2-3).
# train_mla: deepseek-v2-lite-16b (arXiv:2405.04434) at 2, with the
# reference's TRAIN_OVERRIDES (fsdp=True: on the one-card smoke mesh a layout,
# each stored "data" shard the whole leaf), cut in depth to its dense layer
# and TRAIN_MLA_MOE_LAYERS of its 26 MoE layers (15.7 B parameters in all: its
# bf16 weights alone would fill 31 GB, its AdamW moments 126 GB). Every cell
# builds its step with IplsStepConfig(**TRAIN_OVERRIDES.get(arch, {})).
TRAIN_RWKV_LAYERS = 13  # 69.6 GB at its peak on an H100; 14 layers 74.0 GB
TRAIN_MLA_MOE_LAYERS = 5
TRAIN_CELLS = (
    dict(phase="train_moe", arch="granite-moe-3b-a800m", batch=2, steps=3),
    dict(phase="train_gemma3", arch="gemma3-1b", batch=2, steps=3),
    dict(phase="train_zamba2", arch="zamba2-1.2b", batch=2, steps=3),
    dict(phase="train_whisper", arch="whisper-base", batch=2, steps=3),
    dict(phase="train_rwkv", arch="rwkv6-7b", batch=1, steps=3, layers=TRAIN_RWKV_LAYERS),
    dict(phase="train_mla", arch="deepseek-v2-lite-16b", batch=2, steps=3,
         layers=TRAIN_MLA_MOE_LAYERS),
)
# each cell's parameters (nothing cut but rwkv6's depth: its embedding, head
# and final norm, and 218,677,248 a layer)
TRAIN_PARAMS = {"internlm2-1.8b": SERVE_PARAMS, "granite-moe-3b-a800m": SERVE_MOE_PARAMS[0],
                "gemma3-1b": SERVE_GEMMA3_PARAMS[0], "zamba2-1.2b": SERVE_ZAMBA2_PARAMS[0],
                "whisper-base": SERVE_WHISPER_PARAMS[0],
                "rwkv6-7b": SERVE_RWKV_PARAMS - (32 - TRAIN_RWKV_LAYERS) * 218_677_248,
                # the dense layer and 5 MoE layers: 706,243,584 active
                "deepseek-v2-lite-16b": 3_424_678_912}
# train_agree's fsdp legs: fsdp=True against fsdp=False from one host copy of
# the state, one step each, on the smoke mesh (a gather over a world of one is
# the identity: bit for bit): every family's reduced config, and deepseek at
# full width on its dense layer and FSDP_AGREE_MOE_LAYERS MoE layer
FSDP_AGREE_ARCHS = ("internlm2-1.8b",) + TRAIN_AGREE_FAMILIES + ("deepseek-v2-lite-16b",)
FSDP_AGREE_MOE_LAYERS = 1
# phase moe_ep: one routed MoE layer at full width rank by rank at the
# production model axis (M = 16), each rank's float32 part from its weight
# slices (layers.moe_rank_partial), summed in rank order and cast, against the
# model-axis-1 mesh path on the same tokens (one data rank's 2 x 4,096, bf16,
# drawn from the seed): granite ffn-parallel (d_expert 512 = 16 x 32) and
# deepseek expert-parallel (4 of 64 experts a rank, its 2 shared experts'
# hidden dim 2,816 = 16 x 176 column- then row-parallel). The routing equal;
# each output within MOE_EP_ROW_ULPS bf16 ulps of its token row's largest
# magnitude plus 1e-5. Not of its own magnitude: each rank rounds its part of
# every expert output to bf16 (as the reference's shard_map does; ffn mode: a
# sixteenth of each output's hidden sum, so 16 roundings where the layer makes
# one), and a gate-weighted sum of K such terms that cancels to a small output
# keeps the terms' roundings. On an H100 (H100 80GB HBM3, 700 W) granite's ffn
# mode lay 2.0 row ulps from the layer (99.99% of its outputs within 1; 24%
# beyond one ulp of their own magnitude), deepseek's expert mode 1.0 (0.29%);
# 16 half-ulp roundings of a part bound the sum at 8 ulps of the part: the
# bound is 4, which a wrong slice or expert offset (an error of the output's
# own scale, 64 or more row ulps) exceeds by far. Both counts are printed.
MOE_EP_ROW_ULPS = 4.0
MOE_EP = (dict(arch="granite-moe-3b-a800m", mode="ffn"),
          dict(arch="deepseek-v2-lite-16b", mode="expert"))
MOE_EP_M = 16
MOE_EP_TOKENS = (2, 4096)
# phase mla_cp: deepseek-v2-lite-16b's MLA decode context-parallel at full
# width over the production model axis (M = 16, one of its 16 heads a rank):
# one layer's weights and a batch-4 latent cache of 4,224 slots (the serve
# decode's 4,096 + 128) drawn from the seed, the token at pos 4,223; each
# rank's float32 partial over its 264 slots for every head
# (layers.mla_partial), merged in rank order by log-sum-exp
# (decode_ops.merge_partials) and rounded to bf16 once, then its head's wuv
# and wo, the 16 parts summed in float32 and cast, against the one-card
# decode_mla, which rounds its probabilities and its latent output to bf16
# before wuv (the reference's form). Each output within MLA_CP_ROW_ULPS bf16
# ulps of its token row's largest |output| plus 1e-5, as moe_ep: the
# reference's bf16 probabilities (each within 2**-9 of its float32 value)
# and 16 rank parts, each rounded to bf16, where the layer rounds one
# product; a wrong slice, slot offset or head is off by the output's own
# scale.
MLA_CP_M = 16
MLA_CP_BATCH = 4
MLA_CP_SLOTS = 4224
MLA_CP_ROW_ULPS = 4.0
# phase ssm_tp: the recurrent blocks at full width over the production model
# axis (M = 16), rank by rank: rwkv6-7b's time mix (64 heads, 4 a rank: the
# scan kernel at (4, 4,096, 4, 64) on each rank's heads) and channel mix
# (d_ff 14,336, 896 a rank), zamba2-1.2b's Mamba2 layer (64 heads, 4 a
# rank) in a prefill and one decode step. Weights drawn from seed 0 as the
# models draw them (bf16), RWKV6's mu_*, u and w0 and Mamba2's A_log, D and
# dt_bias redrawn (the reference inits them to constants, which would hide
# a wrong column or head offset), one data rank's 4 x 4,096 tokens (bf16,
# unit scale). Each rank's part is the function the mesh path runs on it
# (ssm.rwkv6_time_heads / rwkv6_time_out, rwkv6_channel_part,
# mamba2_heads / mamba2_norm_out, decode_mamba2_heads), its collectives
# emulated in rank order: the norm's float32 squares summed, the
# row-parallel parts summed in float32 and cast once, the time mix's
# columns side by side. Each output within SSM_TP_ROW_ULPS bf16 ulps of its
# token row's largest |output| plus 1e-5 of the model-axis-1 layer, as
# moe_ep (16 rank parts each rounded to bf16 where the layer rounds one
# product); each rank's scan launch within SCAN_TOL of the scale (+ one bf16
# ulp) of the plain chunked scan on its inputs.
SSM_TP_M = 16
SSM_TP_TOKENS = (4, 4096)
SSM_TP_ROW_ULPS = 4.0
# the ranks' final states (float32) against the layer's, of the state's
# scale: a rank's r, k and v are bf16 products of its weight columns, which
# may round one bf16 ulp apart from the whole product's (on the CPU at 64
# tokens, 2e-4)
SSM_TP_STATE_TOL = 2.0 ** -8
# whisper_tp: whisper-base at full width over the production model axis, rank
# by rank: 16 clips of 1,500 frames and a 4-token prompt, a self cache of
# 144 slots (9 a rank: its slots split; 1,500 frames and 8 kv heads divide
# nothing, so ek and ev are whole), one decode step at pos 100 (the slots
# of ranks 12-15 hold no valid key). The encoder output, the prefill's and
# the decode step's logits within WHISPER_TP_ROW_ULPS bf16 ulps of each
# row's largest |value| (plus 1e-5): the rank parts' float32 sums of the
# MLP (d_ff 2,048 split) and the merge of the self-attention's partials
# round apart from the one-card products.
WHISPER_TP = dict(arch="whisper-base", M=16, batch=16, frames=1500, prompt=4, slots=144,
                  pos=100, seed=0)
WHISPER_TP_ROW_ULPS = 4.0
# phase tp_whole: a prompt and a cache that do not divide the production
# model axis, whole on every rank as the reference's specs leave them, rank
# by rank at full width (bf16, weights and inputs drawn from the seed):
# internlm2-1.8b at M = 16, batch 4, a 4,100-token prompt (16 x 256 + 4) and
# a 4,104-slot cache (neither divides 16; 8 kv heads do not): one attention
# layer (each rank's one query head through the flash kernel over every row
# against kv head r // 2, a strided slice of the whole k and v) and one MLP
# layer (512 of 8,192 ffn columns a rank), then one decode step at pos
# 4,100 (each rank's head through the decode kernel on kv head r // 2's
# slice of the whole cache); phi4-mini-3.8b at M = 12 (24 heads over 8 kv
# heads, 2 a rank): one decode layer on a whole 4,104-slot cache at pos
# 4,100, ranks 1, 4, 7 and 10 straddling two kv heads (one call a kv head).
# Every kernel call against its plain version (flash: the bf16 flash bound
# of flash_attention_ref; decode: one bf16 ulp + 2e-5); the rank parts, each rounded to bf16 by its
# output projection, summed in float32 in rank order and cast once, within
# TP_WHOLE_ROW_ULPS bf16 ulps of each row's largest |output| (plus 1e-5) of
# the model-axis-1 layer.
TP_WHOLE = dict(arch="internlm2-1.8b", M=16, batch=4, prompt=4100, slots=4104, seed=0)
TP_WHOLE_STRADDLE = dict(arch="phi4-mini-3.8b", M=12)
TP_WHOLE_ROW_ULPS = 2.0
# long_gemma3, long_zamba2: the long cache's slices over the 256 ranks of
# ("data", "model") on the production mesh (16, 16): each slice's partial
# at pos 524,287 (gemma3's 512-slot rings: 2 slots a slice), merged in
# rank order, against one whole-cache call, within LONG_CP_ROW_ULPS bf16
# ulps of each (batch, head) row's largest (plus 1e-5); the first, middle
# and last slices against the plain partial
LONG_CP_GROUP = 256
LONG_CP_ROW_ULPS = 4.0
# decode at pos 4,096 vs the last-token logits of a 4,097-token prefill. The
# recurrence's step is float32 on both paths (decode in PyTorch from the
# kernel's final state; the kernel's last, ragged chunk), so the gap comes
# from the GEMMs (4 rows against 16,388) and, in bf16, the activations'
# roundings, carried through 32 layers of the reference's high-gain init. On
# an H100: 0.03125 in float32 weights on two prompts (one bf16 ulp at
# |logit| 4-8; 54 of 262,144 logits over one ulp) and 0.125 in bf16; the
# bounds are about 3x those. A wrong state, token shift or decay moves the
# logits by their whole scale.
SERVE_RWKV_DECODE_VS_PREFILL_BF16 = 0.4
SERVE_RWKV_DECODE_VS_PREFILL_F32 = 0.1
# every serve phase in the order it runs (and the roofline of its decode
# step): (phase, spec, parameter counts, decode-vs-prefill bounds (bf16,
# float32), phase_serve's other arguments)
_SERVE_BOUNDS = (SERVE_DECODE_VS_PREFILL_BF16, SERVE_DECODE_VS_PREFILL_F32)
SERVE_PHASES = (
    ("serve", SERVE, SERVE_PARAMS, _SERVE_BOUNDS, {}),
    ("serve_rwkv", SERVE_RWKV, SERVE_RWKV_PARAMS,
     (SERVE_RWKV_DECODE_VS_PREFILL_BF16, SERVE_RWKV_DECODE_VS_PREFILL_F32), {}),
    ("serve_moe", SERVE_MOE, SERVE_MOE_PARAMS, _SERVE_BOUNDS,
     dict(witnessed=SERVE_MOE_WITNESSED)),
    ("serve_mla", SERVE_MLA, SERVE_MLA_PARAMS, _SERVE_BOUNDS,
     dict(check_batch=SERVE_MLA_CHECK_BATCH, witnessed=SERVE_MLA_WITNESSED)),
    ("serve_gemma3", SERVE_GEMMA3, SERVE_GEMMA3_PARAMS, _SERVE_BOUNDS, {}),
    ("serve_zamba2", SERVE_ZAMBA2, SERVE_ZAMBA2_PARAMS, _SERVE_BOUNDS,
     dict(witnessed=SERVE_ZAMBA2_WITNESSED)),
    ("serve_whisper", SERVE_WHISPER, SERVE_WHISPER_PARAMS, _SERVE_BOUNDS, {}),
    ("serve_qwen2_vl", SERVE_QWEN2_VL, SERVE_QWEN2_VL_PARAMS, _SERVE_BOUNDS,
     dict(check_batch=SERVE_QWEN2_VL_CHECK_BATCH)),
    ("serve_phi4_mini", SERVE_PHI4, SERVE_PHI4_PARAMS, _SERVE_BOUNDS,
     dict(witnessed=SERVE_DENSE_LARGE_WITNESSED, float32_checks=False)),
    ("serve_minitron", SERVE_MINITRON, SERVE_MINITRON_PARAMS, _SERVE_BOUNDS,
     dict(witnessed=SERVE_DENSE_LARGE_WITNESSED, float32_checks=False)),
)
# the long_500k cells (configs/registry.py SHAPES["long_500k"]: batch 1,
# 524,288 cache slots, the long-context rules), for the three archs that
# shape_applicable admits, at full width in bf16 through build_decode_step
# (graph=True) on the one-card smoke mesh: LONG_STEPS decode steps at
# positions LONG_PROMPT .. 524,287 (the first eager, then one replay each).
# gemma3's cache is a real prefill of LONG_PROMPT tokens (4 global caches
# of 524,288 slots, 22 rings of 512); zamba2's and rwkv6's are drawn from
# the seed at the scale of a LONG_SCALE_PROMPT-token prefill's caches
# (zamba2's 6 shared-attention caches filled for positions 0 .. 524,279):
# a 524k prefill through the plain SSD would hold float32 tensors of
# 4,096 chunks x 64 heads x 128 x 128 (17 GB each)
LONG_PROMPT = 524_280
LONG_STEPS = 8
LONG_SCALE_PROMPT = 4096
LONG_CELLS = (dict(phase="long_gemma3", arch="gemma3-1b", seed=0, fill="prefill"),
              dict(phase="long_zamba2", arch="zamba2-1.2b", seed=0, fill="seeded"),
              dict(phase="long_rwkv", arch="rwkv6-7b", seed=0, fill="seeded"))
LONG_TIMED_REPLAYS = 20
LONG_TIMED_EAGER = 3
# RoPE on the card at the longest position against float64 on the host
# (the same float32 angles): (head_dim, theta) of gemma3's global and local
# layers
LONG_ROPE = ((256, 1_000_000.0), (256, 10_000.0))
# the bf16 flash kernel at long_gemma3's prefill shape (B, H, KV, S, D:
# LONG_PROMPT queries and keys, causal in the 4 global layers and over the
# FLASH_WINDOW-key window in the 22 local layers), held against the plain
# version on query tiles of LONG_FLASH_ROWS (a CTA's rows, kTileRows in
# csrc/flash_attention.cu) at these starts: the first, one in the middle and
# the last (120 rows: 524,280 is no multiple of 128); the plain version of
# all rows would hold (B, H, S, S) float32 scores
LONG_FLASH_SHAPE = (1, 4, 1, LONG_PROMPT, 256)
LONG_FLASH_ROWS = 128
LONG_FLASH_TILES = (0, LONG_PROMPT // 2 // LONG_FLASH_ROWS * LONG_FLASH_ROWS,
                    (LONG_PROMPT - 1) // LONG_FLASH_ROWS * LONG_FLASH_ROWS)
# the linear-scan kernel against its plain versions: float32 sums in other
# orders, held against the output's scale max(1, max |want|). Measured 6.0e-6
# on an H100 (against the chunked scan; its own error against a float64
# result reaches 1e-5 of the scale at chunks of 64 on the CPU, the step
# form's 2e-7)
SCAN_TOL = 3e-5
SCAN_SHAPE = (4, 4096, 64, 64)  # B, T, H, K of the serve prefill
# device times of the previous designs (PERF.md's kernel table, H100 80GB HBM3, 700 W)
BEFORE_MS = {"rwkv6_scan": 1.105, "ipls_aggregate_batched_q": 0.1753}
LOG_DECAY_CLIP = (-8.0, 4.0)  # logw = -exp(clip(., -8, 4)) in the model


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, launches: int = 20, replays: int = 10) -> dict:
    """A call's time two ways: ``call_ms``, CUDA events around 50
    back-to-back calls (for a kernel, the wrapper's Python checks and ctypes
    call included, as the engine pays them), and ``ms``, the device's own
    time per call: ``launches`` calls captured into one CUDA graph and
    replayed, so no host work is on the clock. Inputs of a few MB stay in
    the 50 MB L2 cache across replays."""
    import torch
    from repro_torch.kernels import _build

    call_ms = _time_ms(fn, iters=50, warmup=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream before capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = _build.Graph()  # a kernel's wrapper may be captured only into a counting graph
    with graph.capture():
        for _ in range(launches):
            fn()
    ms = _time_ms(graph.replay, iters=replays, warmup=1) / launches
    return {"ms": ms, "call_ms": call_ms}


def _bound(moved_bytes: float, flops: float, flops_per_s: float = None) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the given rate (float32 by default), whichever is
    larger (``HW``, the H100's data sheet)."""
    bytes_ms = moved_bytes / HW.hbm_bw * 1e3
    ops_ms = flops / (flops_per_s or HW.f32_flops) * 1e3
    return {
        "bytes_moved": moved_bytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def _bits_equal(a, b) -> bool:
    """Bitwise equality (a -0 differs from a +0)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _digest(t) -> str:
    """The sha256 of a tensor's bytes (bf16 as its 16-bit patterns): two
    runs' tensors are bit for bit equal where their digests are."""
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _kernel_inputs(K, R, S, seed, zero_row=True):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, S), generator=g, device="cuda")
    d = torch.randn((K, R, S), generator=g, device="cuda")
    mask = torch.randint(0, 2, (K, R), generator=g, device="cuda").float()
    if zero_row:
        mask[K // 2] = 0.0  # a zero-contributor instance passes w through
    eps = torch.rand((K,), generator=g, device="cuda") * 0.9 + 0.1
    return w, d, mask, eps


def phase_kernel(ops, ref):
    """f32 aggregation kernel vs plain version, bitwise, at the main shape
    and ragged ones; the single-partition form (kernel table row 2)."""
    import torch

    cases = [MAIN_SHAPE, (3, 1, 70001), (3, 5, 70001), (1, 5, 4097), (7, 11, 1)]
    max_err = 0.0
    for i, (K, R, S) in enumerate(cases):
        w, d, mask, eps = _kernel_inputs(K, R, S, seed=i)
        got = ops.aggregate_batched(w, d, mask, eps)
        want = ref.ipls_aggregate_batched_ref(w, d, mask, eps)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        _require(_bits_equal(got, want), f"kernel != plain at {(K, R, S)}: max |d| {err}")
        _require(torch.equal(got[K // 2], w[K // 2]), f"zero mask row changed w at {(K, R, S)}")
    # the single-partition form (the reference's ipls_aggregate) is K=1
    w, d, mask, eps = _kernel_inputs(1, 5, 70001, seed=99, zero_row=False)
    got = ops.aggregate(w[0], d[0], mask[0], eps[0])
    want = ref.ipls_aggregate_batched_ref(w, d, mask, eps)[0]
    _require(_bits_equal(got, want), "aggregate (K=1) != plain")

    K, R, S = MAIN_SHAPE
    w, d, mask, eps = _kernel_inputs(K, R, S, seed=0)
    times = _device_ms(lambda: ops.aggregate_batched(w, d, mask, eps))
    plain_ms = _time_ms(lambda: ref.ipls_aggregate_batched_ref(w, d, mask, eps), iters=5)
    # yardstick: one PyTorch call for the same function (never used by the
    # port; it rounds differently: cuBLAS reduces R in its own order)
    coef = (-eps[:, None] * mask)[:, None]
    lib = _device_ms(lambda: torch.baddbmm(w[:, None], coef, d))
    f32 = w.element_size()
    res = {
        "phase": "kernel", "shape": [K, R, S], "cases": len(cases) + 1,
        "max_abs_err": max_err, "tolerance": 0.0, **times, "plain_ms": plain_ms,
        "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
        **_bound((d.numel() + 2 * w.numel() + mask.numel() + eps.numel()) * f32,
                 2 * d.numel() + 2 * w.numel()),
    }
    res["achieved_gb_s"] = res["bytes_moved"] / (res["ms"] * 1e-3) / 1e9
    # kernel table row 2: the single-partition form at (1, 51, 44361)
    w1, d1, m1, e1 = w[0], d[0], mask[0], eps[0]
    coef1 = -e1 * m1
    lib1 = _device_ms(lambda: torch.addmv(w1, d1.t(), coef1))  # w + d^T (-eps*mask)
    res["single"] = {
        "shape": [1, R, S],
        **_device_ms(lambda: ops.aggregate(w1, d1, m1, e1)),
        "plain_ms": _time_ms(
            lambda: ref.ipls_aggregate_batched_ref(w[:1], d[:1], mask[:1], eps[:1]), iters=5
        ),
        "library_ms": lib1["ms"], "library_call_ms": lib1["call_ms"],
        **_bound((d1.numel() + 2 * w1.numel() + m1.numel() + 1) * f32,
                 2 * d1.numel() + 2 * w1.numel()),
    }
    _emit(res)
    return res


def _codec_input(n: int, seed: int):
    """x and err of n values whose 1024-blocks cycle through the codec's
    edge cases: ordinary values, all-zero blocks, blocks below 2**-120
    (subnormals included), codes that clip at +-127, exact .5 ties."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda") * 0.01
    err = torch.randn(n, generator=g, device="cuda") * 1e-4
    nb = -(-n // 1024)
    pad = nb * 1024 - n
    xb = torch.nn.functional.pad(x, (0, pad)).view(nb, 1024)
    eb = torch.nn.functional.pad(err, (0, pad)).view(nb, 1024)
    kind = torch.arange(nb, device="cuda") % 5
    tiny = torch.randn((nb, 1024), generator=g, device="cuda") * 2.0**-135
    clip = (torch.rand((nb, 1024), generator=g, device="cuda") * 2 - 1) * 1.999
    clip[:, 0], clip[:, 1] = 1.999, -1.999
    ties = (torch.randint(-120, 120, (nb, 1024), generator=g, device="cuda") + 0.5) / 64
    ties[:, 0] = 1.5  # block absmax in [1, 2): scale 2**-6, (k + 0.5) / 64 are ties
    for k, vals in ((1, torch.zeros_like(tiny)), (2, tiny), (3, clip), (4, ties)):
        sel = kind == k
        xb[sel] = vals[sel]
        eb[sel] = 0.0
    flat = xb.reshape(-1)[:n].contiguous(), eb.reshape(-1)[:n].contiguous()
    return flat


def _agg_q_inputs(K, R, S, seed):
    """Codes over the full [-127, 127], power-of-two and zero scales, a
    zero-mask instance and an instance with own_mask = 0."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = -(-S // 1024)
    w = torch.randn((K, S), generator=g, device="cuda")
    own = torch.randn((K, S), generator=g, device="cuda")
    q = torch.randint(-127, 128, (K, R, S), generator=g, device="cuda").to(torch.int8)
    q.view(-1)[:2] = torch.tensor([-127, 127], dtype=torch.int8, device="cuda")[: q.numel()]
    scales = torch.exp2(torch.randint(-20, 2, (K, R, nb), generator=g, device="cuda").float())
    scales[torch.rand((K, R, nb), generator=g, device="cuda") < 0.2] = 0.0
    mask = torch.randint(0, 2, (K, R), generator=g, device="cuda").float()
    mask[K // 2] = 0.0
    own_mask = torch.ones(K, device="cuda")
    own_mask[0] = 0.0
    eps = torch.rand((K,), generator=g, device="cuda") * 0.9 + 0.1
    return w, own, q, scales, mask, own_mask, eps


def _agg_q_signed_zeros(K, R, S, seed):
    """Scales 0 but in the last instance, codes nine in ten negative, w +-0
    in most lanes: every sum is +-0 and its sign reaches out (see
    tests/test_torch_quantize.py ``_signed_zero_inputs``)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = -(-S // 1024)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    w = torch.where(rand(K, S) < 0.5, -0.0, 0.0)
    w[:, ::7] = torch.randn(w[:, ::7].shape, generator=g, device="cuda")
    own = -(rand(K, S) * 0.5 + 0.5)
    own[2] = torch.where(rand(S) < 0.5, -0.0, 0.0)
    q = torch.randint(-127, 1, (K, R, S), generator=g, device="cuda").to(torch.int8)
    q[rand(K, R, S) < 0.1] = 7
    scales = torch.zeros((K, R, nb), device="cuda")
    scales[-1] = torch.where(rand(R, nb) < 0.5, 0.0, 2.0**-7)
    mask = torch.zeros((K, R), device="cuda")
    mask[1, R // 2] = 1.0
    mask[2:] = torch.randint(0, 2, (K - 2, R), generator=g, device="cuda").float()
    own_mask = torch.tensor([0.0, 0.0] + [1.0] * (K - 3) + [0.0], device="cuda")
    eps = rand(K) * 0.9 + 0.1
    return w, own, q, scales, mask, own_mask, eps


def phase_kernel_q(qops, qref, ops, ref):
    """int8 codec and quantized aggregation kernels vs plain versions,
    bitwise; times at the int8 path's shapes."""
    import torch

    max_err = {"quantize": 0.0, "dequantize": 0.0, "ipls_aggregate_batched_q": 0.0}
    for i, n in enumerate([DELTA_PLANE, VALUE_PLANE, 1, 1025, 8193, 70001]):
        x, err = _codec_input(n, seed=100 + i)
        q, s, ne = qops.quantize(x, err)
        q_r, s_r, ne_r = qref.quantize(x, err)
        deq = qops.dequantize(q_r, s_r)
        deq_r = qref.dequantize(q_r, s_r)
        torch.cuda.synchronize()
        d_q = max((q.int() - q_r.int()).abs().max().item(), (s - s_r).abs().max().item(),
                  (ne - ne_r).abs().max().item())
        max_err["quantize"] = max(max_err["quantize"], d_q)
        max_err["dequantize"] = max(max_err["dequantize"], (deq - deq_r).abs().max().item())
        _require(_bits_equal(q, q_r) and _bits_equal(s, s_r) and _bits_equal(ne, ne_r),
                 f"quantize != plain at N={n}: max |d| {d_q}")
        _require(_bits_equal(deq, deq_r), f"dequantize != plain at N={n}")
        if n >= 8193:  # the edge cases really occur
            _require(bool((s == 0).any()) and int(q.abs().max()) == 127, f"edge cases at N={n}")
    # every width the wrapper picks (8 at the main shape, 16 and 4104, 4 at 45060, 1 where
    # S is odd), R = 1, signed zeros at each width
    agg_cases = [(_agg_q_inputs, shape) for shape in (
        MAIN_Q_SHAPE, (20, 99, 45056), (3, 5, 70001), (7, 11, 1), (5, 1, 16), (5, 1, 17),
        (5, 5, 1023), (5, 5, 1025), (5, 3, 4104), (5, 3, 45060))]
    agg_cases += [(_agg_q_signed_zeros, (4, R, S)) for R in (5, 8) for S in (45056, 45060, 45057)]
    n_zero = 0
    for i, (make, shape) in enumerate(agg_cases):
        args = make(*shape, seed=200 + i)
        got = ops.aggregate_batched_q(*args)
        want = ref.ipls_aggregate_batched_q_ref(*args)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        max_err["ipls_aggregate_batched_q"] = max(max_err["ipls_aggregate_batched_q"], e)
        _require(_bits_equal(got, want), f"aggregate_batched_q != plain at {shape}: {e}")
        if make is _agg_q_signed_zeros:
            n_zero += int((torch.signbit(want) & (want == 0)).sum())
    _require(n_zero > 0, "the signed-zero cases gave no -0")

    res = {"phase": "kernel_q", "max_abs_err": max_err, "tolerance": 0.0, "timings": {},
           "aggregate_q_cases": len(agg_cases), "aggregate_q_negative_zeros": n_zero}
    no_lib = "no single PyTorch call computes it"
    for n in (DELTA_PLANE, VALUE_PLANE):
        x, err = _codec_input(n, seed=7)
        q, s, _ = qref.quantize(x, err)
        nb = s.numel()
        res["timings"][f"quantize@{n}"] = {
            **_device_ms(lambda: qops.quantize(x, err)),
            "plain_ms": _time_ms(lambda: qref.quantize(x, err), iters=5),
            # block absmax with power-of-two scales and error feedback
            "library_ms": None, "library": no_lib,
            **_bound(n * (4 + 4 + 1 + 4) + nb * 4, 10 * n),
        }
        q2, s2 = q.view(nb, 1024), s[:, None]
        # yardstick: one broadcast multiply (int8 x float32 promotes)
        lib = _device_ms(lambda: torch.mul(q2, s2))
        res["timings"][f"dequantize@{n}"] = {
            **_device_ms(lambda: qops.dequantize(q, s)),
            "plain_ms": _time_ms(lambda: qref.dequantize(q, s), iters=5),
            "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
            **_bound(n * (1 + 4) + nb * 4, n),
        }
    for shape in (MAIN_Q_SHAPE, (20, 99, 45056)):
        K, R, S = shape
        args = _agg_q_inputs(K, R, S, seed=9)
        tm = {
            **_device_ms(lambda: ops.aggregate_batched_q(*args)),
            "lanes_per_thread": ops.choose_lanes(S, *args[:3]),
            "plain_ms": _time_ms(lambda: ref.ipls_aggregate_batched_q_ref(*args), iters=3),
            # dequantize fused into an ordered masked sum over int8 codes
            "library_ms": None, "library": no_lib,
            **_bound(K * R * S + K * R * (-(-S // 1024)) * 4 + 3 * K * S * 4 + K * R * 4 + 2 * K * 4,
                     3 * K * R * S + 2 * K * S),
        }
        tm["share_of_bound"] = tm["bound_ms"] / tm["ms"]
        if shape == MAIN_Q_SHAPE:
            tm["ms_before"] = BEFORE_MS["ipls_aggregate_batched_q"]
        res["timings"][f"aggregate_batched_q@{K}x{R}x{S}"] = tm
    _emit(res)
    return res


@contextmanager
def _float64_sgd(mlp_mnist):
    """Local SGD in float64, rounded to float32 once per round. Per-agent
    (scalar engine) and batched (batched engine) float32 products differ in
    their last bits, and on the int8 wire that noise flips a code now and
    then (one scale step, 2**-10 for weights near 0.1). Without it the two
    engines agree bit for bit on the CPU (tests/test_torch_int8.py), so the
    protocol and the kernels can be held to 1e-4 on the card too."""
    sgd = mlp_mnist.sgd_steps_flat_batched
    mlp_mnist.sgd_steps_flat_batched = (
        lambda W, X, Y, lr, iters, layout: sgd(W.double(), X.double(), Y, lr, iters, layout).float()
    )
    try:
        yield
    finally:
        mlp_mnist.sgd_steps_flat_batched = sgd


def _flip_bound(w_a, w_b, offsets, sizes, base):
    """Per-weight bound between two int8-wire runs whose local SGD differs by
    float noise. Every weight an agent reads is a wire image (code * scale of
    its partition's 1024-block) or a merge of a raw value with such images.
    The noise can move a value across a rounding boundary of the codec: one
    flipped code moves the image by one scale step of its block, or by at
    most two steps of the larger scale where the block's absmax crosses a
    power of two between the runs. A flipped delta code moves an aggregate
    by eps times one step of the delta's block, smaller still (deltas are a
    few percent of the values). So each weight is held to two scale steps of
    its block, 2 * 2**(E - 6) for the block absmax 2**E * m (the larger of
    the two runs'), plus ``base`` for the float32 noise itself."""
    bound = np.empty_like(w_a)
    amax = np.maximum(np.abs(w_a), np.abs(w_b))
    for off, s in zip(offsets, sizes):
        nb = -(-int(s) // 1024)
        blk = np.zeros((amax.shape[0], nb * 1024), np.float32)
        blk[:, :s] = amax[:, off : off + s]
        bmax = blk.reshape(amax.shape[0], nb, 1024).max(axis=2)
        step = np.exp2(np.floor(np.log2(np.maximum(bmax, 2.0**-120))) - 6)
        bound[:, off : off + s] = np.repeat(2 * step, 1024, axis=1)[:, :s] + base
    return bound


def _weights_check(w_ref, w, sim, base):
    """Max |difference|, how many weights differ by more than 1e-4, and
    whether the run passes: within ``base`` on the f32 wire; on the int8
    wire within the flip bound, with flips rare (at most 1e-3 of the
    weights beyond 1e-4)."""
    diff = np.abs(w_ref - w)
    n_over = int((diff > WEIGHT_TOL).sum())
    if sim.cfg.wire_dtype == "int8":
        ok = bool((diff <= _flip_bound(w_ref, w, sim._offsets, sim._sizes, base)).all())
        ok = ok and n_over <= 1e-3 * diff.size
    else:
        ok = float(diff.max()) <= base
    return {"max": float(diff.max()), "n_over_1e-4": n_over, "n": int(diff.size)}, ok


def _live_ids(sim_s):
    """The scalar engine's live agents, in its order (the batched engine's
    rows)."""
    return [a for a, ag in sim_s.agents.items() if ag.live]


def _agree_runs(fl, cfg, shards, x_te, y_te, scan_rounds=0):
    sim_s = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    sim_s.run()
    vcfg = dataclasses.replace(cfg, engine="vectorized", scan_rounds=scan_rounds)
    sim_v = fl.make_simulation(vcfg, shards, x_te, y_te, device="cuda")
    sim_v.run()
    sim_c = fl.make_simulation(vcfg, shards, x_te, y_te, device="cpu")
    sim_c.run()
    ids = sim_v.agent_ids()
    _require(ids == _live_ids(sim_s) == sim_c.agent_ids(),
             f"live ids: scalar {_live_ids(sim_s)}, card {ids}, cpu {sim_c.agent_ids()}")
    w_s = np.stack([sim_s.agents[a].load_model() for a in ids])
    return sim_s, sim_v, w_s, sim_v.agent_weights(), sim_c.agent_weights()


def phase_agree(mods):
    """Batched engine vs scalar engine on the card, and card vs CPU, on each
    network / wire combination of the two paths, and under churn (every
    membership action; one round at a time on the f32 wire, windows of 3 on
    int8). Counters and ``active`` exact every round, the live ids equal;
    weights within 1e-4 (f32 wire), within the flip bound (int8 wire), and
    within 1e-4 on the int8 wire and under churn once the SGD noise is
    removed (float64 SGD); the churn schedule amplifies that noise, so its
    float32 runs' weights are reported, not held."""
    fl, data, net = mods["fl"], mods["data"], mods["network"]
    x_tr, y_tr, x_te, y_te = data.synth_mnist(num_train=1500, num_test=300, seed=0)
    churn = dict(rounds=8, churn=CHURN_ALL_ACTIONS, conditions=net.LOSSY)
    cases = {
        "perfect_f32": ({}, 0),
        "perfect_int8": (dict(wire_dtype="int8"), 0),
        "lossy_f32": (dict(conditions=net.LOSSY), 0),
        "lossy_int8": (dict(conditions=net.LOSSY, wire_dtype="int8"), 0),
        "deep_int8": (dict(
            conditions=net.NetworkConditions(loss_prob=0.2, delay_prob=0.5, max_delay_rounds=6),
            wire_dtype="int8",
        ), 0),
        "churn_lossy_f32": (churn, 0),
        "churn_lossy_int8": (dict(churn, wire_dtype="int8"), 3),
    }
    out = {}
    for name, (extra, scan) in cases.items():
        cfg = fl.SimConfig(**dict(AGREE_CFG, **extra))
        shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
        sim_s, sim_v, w_s, w_v, w_c = _agree_runs(fl, cfg, shards, x_te, y_te, scan)
        for ms, mv in zip(sim_s.history, sim_v.history, strict=True):
            _require(ms["bytes_total"] == mv["bytes_total"], f"{name}: bytes_total {ms} vs {mv}")
            _require(ms["active"] == mv["active"], f"{name}: active {ms} vs {mv}")
            _require(abs(ms["acc_mean"] - mv["acc_mean"]) <= 5e-3, f"{name}: acc {ms} vs {mv}")
        ps = sim_s.net.pubsub
        _require(ps.messages_sent == sim_v.messages_sent, f"{name}: messages_sent differ")
        _require(ps.messages_dropped == sim_v.messages_dropped, f"{name}: messages_dropped differ")
        if cfg.conditions.loss_prob > 0:
            _require(sim_v.messages_dropped > 0, f"{name}: no message was dropped")
        vs_scalar, ok_s = _weights_check(w_s, w_v, sim_v, WEIGHT_TOL)
        vs_cpu, ok_c = _weights_check(w_c, w_v, sim_v, WEIGHT_TOL)
        res = {
            "bytes_total": sim_v.history[-1]["bytes_total"], "messages_sent": sim_v.messages_sent,
            "messages_dropped": sim_v.messages_dropped, "R_cap": sim_v.R_cap,
            "w_diff_vs_scalar": vs_scalar, "w_diff_vs_cpu": vs_cpu,
        }
        if cfg.churn:
            res.update(scan_rounds=scan, agent_ids=sim_v.agent_ids(),
                       active=[h["active"] for h in sim_v.history],
                       oracle_rounds=[h["round"] for h in sim_v._seed.history],
                       device_dispatches=sim_v.device_dispatches)
        if cfg.wire_dtype == "int8" or cfg.churn:
            with _float64_sgd(mods["mlp_mnist"]):
                _, sim_v, w_s, w_v, w_c = _agree_runs(fl, cfg, shards, x_te, y_te, scan)
            d_s, d_c = float(np.abs(w_s - w_v).max()), float(np.abs(w_c - w_v).max())
            res["float64_sgd"] = {"max_w_diff_vs_scalar": d_s, "max_w_diff_vs_cpu": d_c}
            _require(max(d_s, d_c) <= WEIGHT_TOL,
                     f"{name}, float64 SGD: weights differ: scalar {d_s}, cpu {d_c}; {res}")
        # under churn the float32 weights are reported, not held (see
        # CHURN_ALL_ACTIONS): the float64-SGD runs above hold them
        _require(ok_s and ok_c or bool(cfg.churn),
                 f"{name}: weights differ: scalar {vs_scalar}, cpu {vs_cpu}; {res}")
        out[name] = res
    streams = _agree_streams(mods, x_tr, y_tr, x_te, y_te)
    _emit({"phase": "agree", "rounds": AGREE_CFG["rounds"], "churn_rounds": churn["rounds"],
           "tolerance": WEIGHT_TOL, "cases": out,
           "streams": {"sgd": "float64", "norm_rtol_vs_cpu": NORM_RTOL, "cases": streams}})


def _reset_launches(kmods):
    for fn in kmods.values():
        fn.LAUNCHES = 0


@contextmanager
def _launches_by_shape(layers, by, build=None):
    """While active, the attention layers' kernel launches (the increments
    of each wrapper's own counter) are also tallied in ``by`` per kind of
    call: flash attention by its mask (causal, a window, non-causal, or
    cross: non-causal with fewer queries than keys), flash-decode by its
    cache's slots (a sliding window's ring holds the window's). A call
    under the capture of a ``build`` (``kernels/_build``) Graph is tallied
    per replay in the dict this yields (``_add_replays`` adds it to ``by``
    once the replays are known)."""
    flash, decode = layers.flash_ops, layers.decode_ops
    per_replay = collections.defaultdict(collections.Counter)

    def tallied(fn, name, key):
        def call(*args, **kw):
            import torch

            graph = (build._capturing[-1] if build is not None and build._capturing
                     and torch.cuda.is_current_stream_capturing() else None)
            n = fn.LAUNCHES if graph is None else graph.launches.get(fn, 0)
            out = fn(*args, **kw)
            if graph is None:
                by[name][key(*args, **kw)] += fn.LAUNCHES - n
            else:
                per_replay[name][key(*args, **kw)] += graph.launches.get(fn, 0) - n
            return out
        return call

    def flash_kind(q, k, v, causal=True, window=None):
        if window:
            return f"window {window}"
        if causal:
            return "causal"
        return "non-causal" if q.shape[2] == k.shape[2] else "cross"

    layers.flash_ops = types.SimpleNamespace(attention=tallied(
        flash.attention, "flash_attention", flash_kind))
    layers.decode_ops = types.SimpleNamespace(decode=tallied(
        decode.decode, "decode_attention", lambda q, k, *a, **kw: f"{k.shape[2]} slots"))
    try:
        yield per_replay
    finally:
        layers.flash_ops, layers.decode_ops = flash, decode


def _add_replays(by, per_replay, replays: int) -> None:
    """``by`` += ``per_replay`` (a graph's tally, by kind) x ``replays``."""
    for name, kinds in per_replay.items():
        for kind, n in kinds.items():
            by[name][kind] += n * replays


@contextmanager
def _masked_slots(masks):
    """While active, every quantized aggregation the batched engine calls
    appends its (K_inst, R_cap) slot mask to ``masks`` (the engine makes a
    new one each call; the caller reads them afterwards, so the probe adds
    no device work or synchronisation); the kernel runs as always."""
    import importlib

    vec = importlib.import_module("repro_torch.fl.vectorized")
    agg = vec.aggregate_batched_q

    def probe(w, own, q, scales, mask, own_mask, eps):
        masks.append(mask)
        return agg(w, own, q, scales, mask, own_mask, eps)

    vec.aggregate_batched_q = probe
    try:
        yield
    finally:
        vec.aggregate_batched_q = agg


def phase_main(mods, kmods, name, extra, shape, want):
    """A full-width path through the user's entry points: counts reset, the
    path run, every count read; the scalar engine on the same inputs is the
    reference (counters exact every round, round-0 weights bounded)."""
    import torch

    fl, data, telemetry = mods["fl"], mods["data"], mods["telemetry"]
    t0 = time.perf_counter()
    x_tr, y_tr, x_te, y_te = data.synth_mnist(**MAIN_DATA)
    cfg = fl.SimConfig(**MAIN_CFG, **extra)
    shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    setup_s = time.perf_counter() - t0
    got_shape = (sim.K_inst, sim.R_cap, sim.S)
    _require(got_shape == shape, f"{name}: kernel shape {got_shape} != {shape}")
    sim.timer = telemetry.PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kmods)
    round_s, w_round0, masked = [], None, []
    with _masked_slots(masked):
        for rnd in range(cfg.rounds):
            t0 = time.perf_counter()
            sim.run_round(rnd)
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            if rnd == 0:
                w_round0 = sim.agent_weights()
    launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
    peak = torch.cuda.max_memory_allocated()
    _require(launches == want, f"{name}: launches {launches}, expected {want}")
    accs = [h["acc_mean"] for h in sim.history]
    _require(all(math.isfinite(a) for a in accs), f"{name}: non-finite accuracy {accs}")
    w_v = sim.agent_weights()
    _require(bool(np.isfinite(w_v).all()), f"{name}: non-finite weights")

    # reference: the scalar engine (numpy protocol) on the same inputs.
    # Traffic must match every round. Weights are held to a bound after
    # round 0 only: at 100 agents the eps recursion starts at 1.0 while
    # r = 51, so later rounds overshoot and amplify float noise chaotically
    # (the reference package does the same); the final gap is reported.
    t0 = time.perf_counter()
    ref = fl.make_simulation(
        dataclasses.replace(cfg, engine="scalar"), shards, x_te, y_te, device="cuda"
    )
    r0 = {}
    for rnd in range(cfg.rounds):
        mr = ref.run_round(rnd)
        mv = sim.history[rnd]
        _require(mr["bytes_total"] == mv["bytes_total"], f"{name}: bytes_total {mr} vs {mv}")
        if rnd == 0:
            w_r = np.stack([ref.agents[a].load_model() for a in range(cfg.num_agents)])
            diff = np.abs(w_r - w_round0)
            if cfg.wire_dtype == "int8":
                # flipped codes (see _flip_bound), on top of the f32 bound
                tol = _flip_bound(w_r, w_round0, sim._offsets, sim._sizes, ROUND0_TOL)
                r0["tolerance"] = "2 code steps of the weight's block + 1e-3, per weight"
                r0["max_tolerance"] = float(tol.max())
            else:
                tol = ROUND0_TOL
                r0["tolerance"] = ROUND0_TOL
            r0.update(max_w_diff_vs_scalar_round0=float(diff.max()),
                      n_over_1e_4=int((diff > WEIGHT_TOL).sum()), n_weights=int(diff.size))
            _require(bool((diff <= tol).all()), f"{name}: round-0 weights differ by {diff.max()}")
    ps = ref.net.pubsub
    _require(ps.messages_sent == sim.messages_sent, f"{name}: messages_sent differ")
    _require(ps.messages_dropped == sim.messages_dropped, f"{name}: messages_dropped differ")
    scalar_s = time.perf_counter() - t0
    w_r = np.stack([ref.agents[a].load_model() for a in range(cfg.num_agents)])
    res = {
        "phase": name, "agents": cfg.num_agents, "params": sim.N, "rounds": cfg.rounds,
        "conditions": dataclasses.asdict(cfg.conditions), "wire_dtype": cfg.wire_dtype,
        "kernel_shape": list(got_shape), "launches": launches, "round_s": round_s,
        "phases_s": {k: v["total_s"] for k, v in sim.timer.summary().items()},
        "acc_mean": accs, "acc_mean_scalar": [h["acc_mean"] for h in ref.history],
        "bytes_total": sim.history[-1]["bytes_total"], "messages_sent": sim.messages_sent,
        "messages_dropped": sim.messages_dropped, "max_memory_allocated": peak,
        "data_s": data_s, "setup_s": setup_s, "scalar_engine_s": scalar_s, **r0,
        "max_abs_w_round0": float(np.abs(w_round0).max()),
        "max_abs_w_final": float(np.abs(w_v).max()),
        "max_w_diff_vs_scalar_final": float(np.abs(w_r - w_v).max()),
    }
    if masked:  # the int8 path: the share of the quantized aggregation's slots masked out
        res["masked_slot_share"] = [float((m == 0).float().mean()) for m in masked]
    _emit(res)
    return res


def _window_snapshot(sim):
    """The engine's cumulative counters and phase seconds, to difference
    around one window."""
    return {
        "counters": (sim.messages_sent, sim.messages_dropped, sim._bytes_total),
        "phases": {k: v["total_s"] for k, v in sim.timer.summary().items()},
    }


def _timed_window(sim, r0, W):
    """``sim.run_window(r0, W)``, synchronized: its wall time and the
    seconds of each phase it ran."""
    import torch

    before = _window_snapshot(sim)
    t0 = time.perf_counter()
    sim.run_window(r0, W)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = _window_snapshot(sim)
    return {
        "rounds": [r0, r0 + W - 1], "s": wall, "s_per_round": wall / W,
        "phases_s": _phase_delta(before["phases"], after["phases"]),
    }, after["counters"]


def _phase_delta(before, after):
    """The seconds each phase gained between two `_window_snapshot`s."""
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _kernel_events(fn, symbols):
    """Run ``fn`` under torch.profiler. Returns the device's kernel events
    by symbol (each of ``symbols``: name -> kernel symbol), the count of its
    kernel events (copy-engine transfers left out) and their summed seconds,
    and every device event by name (copies included) with their summed
    seconds. Late in a run a profile loses its first device events (2 to
    84 seen), so it starts with PROFILER_WARMUP throwaway spin
    kernels of about 10 us each, left out of the counts; ``warmup_seen``
    says how many of them it kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(PROFILER_WARMUP):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    warmup = [e for e in events if "spin_kernel" in e.name]
    events = [e for e in events if "spin_kernel" not in e.name]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    by_symbol = {k: sum(bool(re.search(rf"(?<!\w){sym}\b", e.name)) for e in kernels)
                 for k, sym in symbols.items()}
    return {
        "by_symbol": by_symbol, "kernels": len(kernels),
        "kernel_s": sum(e.time_range.end - e.time_range.start for e in kernels) / 1e6,
        "names": collections.Counter(e.name for e in events),
        "device_s": sum(e.time_range.end - e.time_range.start for e in events) / 1e6,
        "warmup_seen": len(warmup),
    }


def _device_state(sim):
    """Copies of what a replay of ``sim``'s one window graph writes: the
    state tensors and the graph's outputs."""
    (g,) = sim.graphs.values()
    out = {k: v.clone() for k, v in sim._state.items()}
    out["accs"] = g.accs.clone()
    if g.mets is not None:
        out["mets"] = g.mets.clone()
    return out


def _witnessed_profile(sim, run, kmods, name):
    """``run`` (one window of ``sim``: its inputs staged, then one replay of
    its one graph) under torch.profiler, with the protocol kernels held to
    the graph's record, and a second witness that the replay ran: from the
    state the replay started at, an unprofiled replay of the same graph on
    the same inputs must give the same state and outputs bit for bit, and
    so must PROFILE_TRIES - 1 more profiled replays (up to 2 * PROFILE_TRIES
    profiles in all, while none has kept some of its warm-up kernels, see
    `_kernel_events`). Every profile that kept some must show the record
    exactly. Returns the first profile, every profile's protocol kernel
    counts, event total and warm-up kernels kept, and the replays made
    beyond ``run``'s (the state is left as ``run`` left it)."""
    import torch

    (g,) = sim.graphs.values()
    start = {k: v.clone() for k, v in sim._state.items()}
    want = {k: g.graph.launches.get(kmods[k], 0) for k in KERNEL_SYMBOLS}

    def replay(profiled):
        for k, v in sim._state.items():
            v.copy_(start[k])
        prof = _kernel_events(g.graph.replay, KERNEL_SYMBOLS) if profiled else g.graph.replay()
        torch.cuda.synchronize()
        got = _device_state(sim)
        _require(got.keys() == after.keys() and all(_bits_equal(got[k], after[k]) for k in got),
                 f"{name}: a {'profiled' if profiled else 'plain'} replay of the same window "
                 "gave other bits")
        return prof

    first = _kernel_events(run, KERNEL_SYMBOLS)
    after = _device_state(sim)
    replay(profiled=False)
    profs = [first] + [replay(profiled=True) for _ in range(PROFILE_TRIES - 1)]
    while not any(p["warmup_seen"] for p in profs) and len(profs) < 2 * PROFILE_TRIES:
        profs.append(replay(profiled=True))
    readings = [{"by_symbol": p["by_symbol"], "events": sum(p["names"].values()),
                 "warmup_seen": p["warmup_seen"]} for p in profs]
    # a profile that kept none of its warm-up kernels may have lost some of
    # the replay's too: it decides nothing; every other one must show the
    # record exactly
    whole = [p for p in profs if p["warmup_seen"] > 0]
    _require(len(whole) > 0, f"{name}: every profile lost its warm-up kernels: {readings}")
    _require(all(p["by_symbol"] == want for p in whole),
             f"{name}: a profiled replay ran other kernels than its graph records: "
             f"{readings}, record {want}")
    return first, readings, len(profs)


def phase_window(mods, kmods, name, extra, window, shape, per_round):
    """A main path in multi-round windows at full width, through
    make_simulation and run_window: each window one CUDA-graph replay. The
    same rounds run one at a time (scan_rounds=0) on the same card and
    inputs are the reference for the bits: weights, every evaluated round's
    accuracies, every round's bytes and the message counters at every
    window's end, equal bit for bit. The scalar engine is the reference for
    the protocol: counters exact every round, the per-round path's round-0
    weights within the bounds of ``phase_main``. Kernel launches: the
    engine's warm-up round before its one capture, then each replay the
    launches its capture recorded, ``per_round`` each round; a profiled
    replay past the checked rounds must run those kernels on the card."""
    import torch

    fl, data, telemetry = mods["fl"], mods["data"], mods["telemetry"]
    x_tr, y_tr, x_te, y_te = data.synth_mnist(**MAIN_DATA)
    cfg = fl.SimConfig(**dict(MAIN_CFG, **window), **extra)
    shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
    R, W = cfg.rounds, cfg.scan_rounds

    # the same rounds one at a time, eagerly, on the same card and inputs
    eager = fl.make_simulation(dataclasses.replace(cfg, scan_rounds=0), shards, x_te, y_te,
                               device="cuda")
    eager_s, eager_counters, eager_accs = [], [], []
    for rnd in range(R):
        t0 = time.perf_counter()
        eager.run_round(rnd)
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
        eager_counters.append((eager.messages_sent, eager.messages_dropped, eager._bytes_total))
        eager_accs.append(eager._last_accs)
        if rnd == 0:
            w_round0 = eager.agent_weights()
    w_eager, hist_eager = eager.agent_weights(), list(eager.history)
    del eager
    torch.cuda.empty_cache()

    sim = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    got_shape = (sim.K_inst, sim.R_cap, sim.S)
    _require(got_shape == shape, f"{name}: kernel shape {got_shape} != {shape}")
    sim.timer = telemetry.PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kmods)
    windows, accs_bits_equal = [], True
    for r0 in range(0, R, W):
        win, counters = _timed_window(sim, r0, min(W, R - r0))
        last = win["rounds"][1]
        _require(counters == eager_counters[last],
                 f"{name}: counters {counters} after round {last}, "
                 f"one round at a time {eager_counters[last]}")
        if sim._do_eval(last):
            accs_bits_equal &= sim._last_accs.tobytes() == eager_accs[last].tobytes()
        windows.append(win)
    launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
    peak = torch.cuda.max_memory_allocated()
    _emit({"phase": name, "windows": windows, "launches": launches})  # before the checks

    # one graph, captured once, replayed once a window
    dispatches = sim.device_dispatches
    _require(dispatches == R // W, f"{name}: {dispatches} dispatches")
    _require(len(sim.graphs) == 1, f"{name}: {len(sim.graphs)} graphs captured")
    (graph,) = (g.graph for g in sim.graphs.values())
    _require(graph.replays == R // W, f"{name}: {graph.replays} replays")
    recorded = {k: graph.launches.get(fn, 0) for k, fn in kmods.items()}
    want_graph = {k: W * per_round.get(k, 0) for k in kmods}
    _require(recorded == want_graph, f"{name}: the graph records {recorded}, expected {want_graph}")
    want = {k: recorded[k] * graph.replays + per_round.get(k, 0) for k in kmods}
    _require(launches == want, f"{name}: launches {launches}, expected {want}")
    # bit for bit the rounds run one at a time
    w_v = sim.agent_weights()
    _require(w_v.tobytes() == w_eager.tobytes(),
             f"{name}: weights differ from the per-round path by {np.abs(w_v - w_eager).max()}")
    for mv, me in zip(sim.history, hist_eager, strict=True):
        _require(mv["bytes_total"] == me["bytes_total"], f"{name}: bytes {mv} vs {me}")
        if sim._do_eval(mv["round"]):
            _require(mv == me, f"{name}: round {mv['round']}: {mv} vs {me}")
    _require(accs_bits_equal, f"{name}: accuracies differ from the per-round path")
    accs = [h["acc_mean"] for h in sim.history]
    _require(all(math.isfinite(a) for a in accs), f"{name}: non-finite accuracy {accs}")
    _require(bool(np.isfinite(w_v).all()), f"{name}: non-finite weights")

    # the protocol: the scalar engine on the same inputs
    t0 = time.perf_counter()
    ref = fl.make_simulation(
        dataclasses.replace(cfg, engine="scalar"), shards, x_te, y_te, device="cuda"
    )
    r0_check = {}
    for rnd in range(R):
        mr = ref.run_round(rnd)
        _require(mr["bytes_total"] == sim.history[rnd]["bytes_total"],
                 f"{name}: bytes_total {mr} vs {sim.history[rnd]}")
        ps = ref.net.pubsub
        _require((ps.messages_sent, ps.messages_dropped) == eager_counters[rnd][:2],
                 f"{name}: round {rnd} messages {ps.messages_sent, ps.messages_dropped} "
                 f"vs {eager_counters[rnd][:2]}")
        if rnd == 0:
            w_r = np.stack([ref.agents[a].load_model() for a in range(cfg.num_agents)])
            diff = np.abs(w_r - w_round0)
            tol = (_flip_bound(w_r, w_round0, sim._offsets, sim._sizes, ROUND0_TOL)
                   if cfg.wire_dtype == "int8" else ROUND0_TOL)
            r0_check = {"max_w_diff_vs_scalar_round0": float(diff.max()),
                        "n_over_1e_4": int((diff > WEIGHT_TOL).sum())}
            _require(bool((diff <= tol).all()), f"{name}: round-0 weights differ by {diff.max()}")
    scalar_s = time.perf_counter() - t0
    phases = {k: v["total_s"] for k, v in sim.timer.summary().items()}

    # after the checks: more windows of the same key, each a replay, for
    # the spread of a replayed window; then one under the profiler, whose
    # kernels must be those the capture recorded
    replayed = [w["s"] for w in windows[1:]]
    for i in range(EXTRA_REPLAYS):
        replayed.append(_timed_window(sim, R + i * W, W)[0]["s"])
    prof, readings, witness_replays = _witnessed_profile(
        sim, lambda: sim.run_window(R + EXTRA_REPLAYS * W, W), kmods, name
    )
    kernel_s = prof["kernel_s"]
    _require(prof["kernels"] > 0, f"{name}: the profiler shows no kernel of the replay")
    _require(len(sim.graphs) == 1
             and graph.replays == R // W + EXTRA_REPLAYS + 1 + witness_replays,
             f"{name}: the timed windows were not all replays of one graph")
    res = {
        "phase": name, "agents": cfg.num_agents, "params": sim.N, "rounds": R,
        "scan_rounds": W, "eval_cadence": cfg.eval_cadence,
        "conditions": dataclasses.asdict(cfg.conditions), "wire_dtype": cfg.wire_dtype,
        "kernel_shape": list(got_shape), "launches": launches,
        "graph_launches_per_replay": recorded, "graphs": len(sim.graphs),
        "device_dispatches": dispatches, "extra_replays": EXTRA_REPLAYS + 1,
        "s_per_round": sum(w["s"] for w in windows) / R,
        "replayed_window_s": replayed,
        "replayed_window_s_median": float(np.median(replayed)),
        "s_per_round_replayed_median": float(np.median(replayed)) / W,
        "windows": windows, "phases_s": phases,
        "profiled_replay_kernels": {"by_symbol": prof["by_symbol"], "all": prof["kernels"],
                                    "kernel_s": kernel_s,
                                    "kernel_share_of_median_window": kernel_s / float(np.median(replayed)),
                                    "profiles": readings},
        "per_round_path_round_s": eager_s, "bitwise_equal_to_per_round_path": True,
        "acc_mean": accs, "bytes_total": sim.history[-1]["bytes_total"],
        "messages_sent": sim.messages_sent, "messages_dropped": sim.messages_dropped,
        "max_memory_allocated": peak, "scalar_engine_s": scalar_s, **r0_check,
        "round0_tolerance": ("2 code steps of the weight's block + 1e-3, per weight"
                             if cfg.wire_dtype == "int8" else ROUND0_TOL),
    }
    del sim, ref
    torch.cuda.empty_cache()
    _emit(res)
    return res


def phase_churn(mods, kmods, name, extra, window, shape, per_round):
    """The churn path at full width through make_simulation and run_window:
    ``main_int8`` under MAIN_CHURN's schedule, each membership-event round
    replayed on the embedded scalar oracle, each span between re-snapshotted
    and run in windows (one CUDA-graph replay each, captured anew in every
    span). References: the same schedule one round at a time on the card
    (bit for bit: weights, accuracies, counters every round); the scalar
    engine on the card (counters and ``active`` every round, the live ids,
    the per-round run's round-0 weights within the bound of ``phase_main``);
    the same config without churn, the baseline of the per-event overhead.
    Kernel launches: a warm-up round before each span's capture, then the
    replays; a profiled replay past the checked rounds must run the kernels
    its capture recorded. Reports each span's seconds a round, each event's
    boundary cost by phase, the peak device memory of each span."""
    import torch

    fl, data, telemetry = mods["fl"], mods["data"], mods["telemetry"]
    x_tr, y_tr, x_te, y_te = data.synth_mnist(**MAIN_DATA)
    cfg = fl.SimConfig(**dict(MAIN_CFG, **window), **extra)
    shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
    R, W = cfg.rounds, cfg.scan_rounds
    events = sorted(cfg.churn)

    # the same schedule one round at a time, on the same card and inputs
    t0 = time.perf_counter()
    eager = fl.make_simulation(dataclasses.replace(cfg, scan_rounds=0), shards, x_te, y_te,
                               device="cuda")
    eager_counters = []
    for rnd in range(R):
        eager.run_round(rnd)
        eager_counters.append((eager.messages_sent, eager.messages_dropped, eager._bytes_total))
        if rnd == 0:
            w_round0 = eager.agent_weights()
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    w_eager, hist_eager, ids_eager = eager.agent_weights(), list(eager.history), eager.agent_ids()
    del eager
    torch.cuda.empty_cache()

    sim = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    got_shape, n_params = (sim.K_inst, sim.R_cap, sim.S), sim.N
    _require(got_shape == shape, f"{name}: kernel shape {got_shape} != {shape}")
    sim.timer = telemetry.PhaseTimer()
    torch.cuda.synchronize()
    _reset_launches(kmods)
    # run() by hand, to time each span and each boundary apart
    spans, boundaries, rnd, t_run = [], [], 0, time.perf_counter()
    while rnd < R:
        if rnd in sim._replay_set:
            before = _window_snapshot(sim)["phases"]
            t0 = time.perf_counter()
            sim.run_round(rnd)
            torch.cuda.synchronize()
            boundaries.append({"round": rnd, "s": time.perf_counter() - t0,
                               "active_after": sim.history[-1]["active"],
                               "phases_s": _phase_delta(before, _window_snapshot(sim)["phases"])})
            rnd += 1
            continue
        hi = next((r for r in events if r > rnd), R)
        torch.cuda.reset_peak_memory_stats()
        before, wins = _window_snapshot(sim)["phases"], []
        for r0 in range(rnd, hi, W):
            win, counters = _timed_window(sim, r0, min(W, hi - r0))
            last = win["rounds"][1]
            _require(counters == eager_counters[last],
                     f"{name}: counters {counters} after round {last}, "
                     f"one round at a time {eager_counters[last]}")
            wins.append(win)
        phases = _phase_delta(before, _window_snapshot(sim)["phases"])
        span = {"rounds": [rnd, hi - 1], "agents": sim.A, "online": sim._n_act,
                "kernel_shape": [sim.K_inst, sim.R_cap, sim.S], "windows": wins,
                "s_per_round": sum(w["s"] for w in wins) / (hi - rnd),
                "snapshot_s": phases.get("snapshot", 0.0),
                "graph_capture_s": phases.get("graph_capture", 0.0),
                # the span-constant plane of harvested in-flight values
                "mail_bytes": 0 if sim._mail is None else sim._mail.nbytes,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "memory_allocated_end": torch.cuda.memory_allocated()}
        spans.append(span)
        rnd = hi
    churn_s = time.perf_counter() - t_run
    launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
    # each event's boundary cost: leaving the span and the oracle round,
    # then the next span's snapshot (harvest included) and graph capture
    for b, nxt in zip(boundaries, spans[1:]):
        b["cost_s"] = {"device_to_scalar": b["phases_s"].get("device_to_scalar", 0.0),
                       "oracle_round": b["phases_s"].get("oracle_round", 0.0),
                       "snapshot": nxt["snapshot_s"], "graph_capture": nxt["graph_capture_s"]}
    _emit({"phase": name, "spans": spans, "boundaries": boundaries, "launches": launches})

    # one window a span here, each a capture: a warm-up round, then its
    # replay; no oracle round launches a kernel
    dispatches = sim.device_dispatches
    _require(dispatches == len(spans), f"{name}: {dispatches} dispatches, {len(spans)} spans")
    _require([h["round"] for h in sim._seed.history] == events,
             f"{name}: the oracle ran rounds {[h['round'] for h in sim._seed.history]}")
    n_device_rounds = R - len(events)
    want = {k: per_round.get(k, 0) * (n_device_rounds + len(spans)) for k in kmods}
    _require(launches == want, f"{name}: launches {launches}, expected {want}")
    _require(all(launches[k] > 0 for k in per_round), f"{name}: a kernel never launched")
    # peak memory: the dropped graphs freed their pools
    peaks = [s["max_memory_allocated"] for s in spans]
    _require(max(peaks) <= 1.1 * peaks[0], f"{name}: peak memory grew across spans: {peaks}")
    # bit for bit the rounds run one at a time
    w_v = sim.agent_weights()
    _require(sim.agent_ids() == ids_eager, f"{name}: ids {sim.agent_ids()} vs {ids_eager}")
    _require(w_v.tobytes() == w_eager.tobytes(),
             f"{name}: weights differ from the per-round path by {np.abs(w_v - w_eager).max()}")
    _require(sim.history == hist_eager, f"{name}: history differs from the per-round path")
    accs = [h["acc_mean"] for h in sim.history]
    _require(all(math.isfinite(a) for a in accs), f"{name}: non-finite accuracy {accs}")
    _require(bool(np.isfinite(w_v).all()), f"{name}: non-finite weights")

    # the protocol: the scalar engine on the same inputs
    t0 = time.perf_counter()
    ref = fl.make_simulation(
        dataclasses.replace(cfg, engine="scalar"), shards, x_te, y_te, device="cuda"
    )
    r0_check = {}
    for rnd in range(R):
        mr = ref.run_round(rnd)
        mv = sim.history[rnd]
        _require((mr["bytes_total"], mr["active"]) == (mv["bytes_total"], mv["active"]),
                 f"{name}: round {rnd}: {mr} vs {mv}")
        ps = ref.net.pubsub
        _require((ps.messages_sent, ps.messages_dropped) == eager_counters[rnd][:2],
                 f"{name}: round {rnd} messages {ps.messages_sent, ps.messages_dropped} "
                 f"vs {eager_counters[rnd][:2]}")
        if rnd == 0:
            w_r = np.stack([ref.agents[a].load_model() for a in _live_ids(ref)])
            diff = np.abs(w_r - w_round0)
            tol = _flip_bound(w_r, w_round0, sim._offsets, sim._sizes, ROUND0_TOL)
            r0_check = {"max_w_diff_vs_scalar_round0": float(diff.max()),
                        "n_over_1e_4": int((diff > WEIGHT_TOL).sum())}
            _require(bool((diff <= tol).all()), f"{name}: round-0 weights differ by {diff.max()}")
    scalar_s = time.perf_counter() - t0
    _require(_live_ids(ref) == sim.agent_ids(), f"{name}: live ids differ from the scalar engine")
    w_r = np.stack([ref.agents[a].load_model() for a in _live_ids(ref)])
    del ref

    # after the checks: replays of the last span's graph (its key again),
    # timed, then one under the profiler, whose kernels must be those the
    # capture recorded
    (graph,) = (g.graph for g in sim.graphs.values())
    Wl = spans[-1]["windows"][-1]["rounds"][1] - spans[-1]["windows"][-1]["rounds"][0] + 1
    replayed = [_timed_window(sim, R + i * Wl, Wl)[0]["s"] for i in range(EXTRA_REPLAYS)]
    prof, readings, witness_replays = _witnessed_profile(
        sim, lambda: sim.run_window(R + EXTRA_REPLAYS * Wl, Wl), kmods, name
    )
    _require(prof["kernels"] > 0, f"{name}: the profiler shows no kernel of the replay")
    recorded = {k: graph.launches.get(fn, 0) for k, fn in kmods.items()}
    _require(recorded == {k: Wl * per_round.get(k, 0) for k in kmods},
             f"{name}: the graph records {recorded}")
    _require(len(sim.graphs) == 1 and graph.replays == EXTRA_REPLAYS + 2 + witness_replays,
             f"{name}: the timed windows were not all replays of one graph")
    del sim
    torch.cuda.empty_cache()

    # the baseline: the same config and W without churn
    base = fl.make_simulation(dataclasses.replace(cfg, churn=None), shards, x_te, y_te,
                              device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base.run()
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    _require(base.device_dispatches == -(-R // W), f"{name}: baseline dispatches")
    del base
    torch.cuda.empty_cache()

    res = {
        "phase": name, "agents": cfg.num_agents, "params": n_params, "rounds": R,
        "scan_rounds": W, "conditions": dataclasses.asdict(cfg.conditions),
        "wire_dtype": cfg.wire_dtype,
        "schedule": {r: {act: sum(e[1] == act for e in cfg.churn[r]) for _, act in cfg.churn[r]}
                     for r in events},
        "spans": spans, "boundaries": boundaries, "launches": launches,
        "graph_launches_per_replay": recorded, "device_dispatches": dispatches,
        "active": [h["active"] for h in hist_eager], "agent_ids_n": len(ids_eager),
        "churn_run_s": churn_s, "baseline_run_s": base_s,
        "overhead_s_per_event": (churn_s - base_s) / len(events),
        "replayed_window_rounds": Wl, "replayed_window_s": replayed,
        "replayed_window_s_median": float(np.median(replayed)),
        "profiled_replay_kernels": {"by_symbol": prof["by_symbol"], "all": prof["kernels"],
                                    "kernel_s": prof["kernel_s"], "profiles": readings},
        "per_round_path_s": eager_s, "bitwise_equal_to_per_round_path": True,
        "acc_mean": accs, "bytes_total": hist_eager[-1]["bytes_total"],
        "messages_sent": eager_counters[-1][0], "messages_dropped": eager_counters[-1][1],
        "scalar_engine_s": scalar_s, **r0_check,
        "round0_tolerance": "2 code steps of the weight's block + 1e-3, per weight",
        "max_w_diff_vs_scalar_final": float(np.abs(w_r - w_v).max()),
    }
    _emit(res)
    return res


# the telemetry stream's columns that do not depend on SGD (exact between
# engines and devices), and the norms' relative tolerance against the CPU
STREAM_SGD_FREE = ("round", "active", "drops_offline", "delay_hist", "contrib", "eps",
                   "bytes_total", "msgs_total", "drops_total")
NORMS = ("delta_normsq", "value_normsq")
NORM_RTOL = 1e-5


def _sgd_free(row):
    """A telemetry row's SGD-free columns (the traffic by channel too)."""
    return {k: v for k, v in row.items()
            if k in STREAM_SGD_FREE or k.startswith(("msgs_", "bytes_", "drops_"))}


def _rows(lines):
    return [json.loads(x) for x in lines]


def _stream_lines(sim):
    return sim.recorder.jsonl_lines()[1:]


def _carried(lines, evaluated):
    """The stream a windowed run with eval_cadence gives, from one that
    evaluated every round: a round outside ``evaluated`` carries the last
    evaluated round's accuracies (zeros before the first)."""
    out, last = [], None
    for row in _rows(lines):
        if row["round"] in evaluated:
            last = row
        else:
            acc = last or {"accs": [0.0] * len(row["accs"]), "acc_mean": 0.0, "acc_std": 0.0,
                           "acc_max": 0.0}
            for k in ("accs", "acc_mean", "acc_std", "acc_max"):
                row[k] = acc[k]
        out.append(json.dumps(row, separators=(",", ":")))
    return out


def _agree_streams(mods, x_tr, y_tr, x_te, y_te):
    """The metric streams at the agree config with float64 SGD (which
    removes the float noise by which per-agent and batched products
    differ): on the card, the scalar engine, the batched engine one round at
    a time and in windows give byte-identical JSONL; against the port's
    scalar engine on the CPU the SGD-free columns are exact and the norms
    within a relative NORM_RTOL; every scalar run is traced, and the card's
    protocol track (pid 1) equals the CPU's event for event."""
    fl, data, net = mods["fl"], mods["data"], mods["network"]
    churn = dict(rounds=8, churn=CHURN_ALL_ACTIONS, conditions=net.LOSSY)
    cases = {
        "perfect_f32": ({}, 2),
        "lossy_f32": (dict(conditions=net.LOSSY), 2),
        "lossy_int8": (dict(conditions=net.LOSSY, wire_dtype="int8"), 2),
        "churn_lossy_int8": (dict(churn, wire_dtype="int8"), 3),
    }
    out = {}
    for name, (extra, W) in cases.items():
        cfg = fl.SimConfig(**dict(AGREE_CFG, **extra), telemetry=True)
        shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
        runs = {}
        with _float64_sgd(mods["mlp_mnist"]):
            for key, engine, scan, device in (
                ("scalar", "scalar", 0, "cuda"), ("batched", "vectorized", 0, "cuda"),
                ("windowed", "vectorized", W, "cuda"), ("cpu", "scalar", 0, "cpu"),
            ):
                c = dataclasses.replace(cfg, engine=engine, scan_rounds=scan,
                                        trace=engine == "scalar")
                sim = fl.make_simulation(c, shards, x_te, y_te, device=device)
                sim.run()
                runs[key] = sim
        streams = {k: _stream_lines(s) for k, s in runs.items()}
        _require(len(streams["scalar"]) == cfg.rounds, f"agree streams {name}: rows")
        _require(streams["scalar"] == streams["batched"] == streams["windowed"],
                 f"agree streams {name}: the card's streams differ")
        card, cpu = _rows(streams["scalar"]), _rows(streams["cpu"])
        gaps = {k: 0.0 for k in NORMS}
        for r, c in zip(card, cpu, strict=True):
            _require(_sgd_free(r) == _sgd_free(c),
                     f"agree streams {name}: round {r['round']} SGD-free columns differ")
            for k in NORMS:
                gaps[k] = max(gaps[k], abs(r[k] - c[k]) / max(abs(c[k]), 1e-30))
        _require(max(gaps.values()) <= NORM_RTOL, f"agree streams {name}: norms {gaps}")
        track = {k: [e for e in runs[k].recorder.trace.events if e["pid"] == 1]
                 for k in ("scalar", "cpu")}
        _require(len(track["scalar"]) > 0 and track["scalar"] == track["cpu"],
                 f"agree streams {name}: the protocol traces differ")
        out[name] = {"rows": len(card), "scan_rounds": W, "bytes_identical": True,
                     "norm_rel_gap_vs_cpu": gaps, "protocol_events": len(track["scalar"]),
                     "oracle_rounds": [h["round"] for h in runs["windowed"]._seed.history]}
    return out


# device events that copy or set memory: copy-engine transfers, and the
# kernels CUDA runs for some memcpy nodes of a graph
_COPY_EVENTS = ("Memcpy", "Memset", "memcpy", "memset")


def _split_copies(names):
    """(compute kernels, copies) of a `_kernel_events` name counter."""
    copies = collections.Counter({k: n for k, n in names.items() if k.startswith(_COPY_EVENTS)})
    return names - copies, copies


def _telemetry_run(mods, kmods, cfg, shards, x_te, y_te, telemetry: bool):
    """One windowed run at full width with telemetry off or on, its counts
    set to 0 before and read after. Returns the run and what it gave: the
    launches and graph records, the device memory it took at its peak over
    what was allocated before it, its weights, history and stream."""
    import torch

    fl, tel = mods["fl"], mods["telemetry"]
    R, W = cfg.rounds, cfg.scan_rounds
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sim = fl.make_simulation(dataclasses.replace(cfg, telemetry=telemetry), shards, x_te, y_te,
                             device="cuda")
    if not telemetry:
        sim.timer = tel.PhaseTimer()  # the recorder's timer when on: both synchronize alike
    start = (sim.messages_sent, sim.messages_dropped, sim._bytes_total)
    _reset_launches(kmods)
    for r0 in range(0, R, W):
        sim.run_window(r0, min(W, R - r0))
    torch.cuda.synchronize()
    return sim, {
        "launches": {k: fn.LAUNCHES for k, fn in kmods.items()},
        "peak_memory": torch.cuda.max_memory_allocated() - base,
        "graph_launches": [{k: g.graph.launches.get(fn, 0) for k, fn in kmods.items()}
                           for g in sim.graphs.values()],
        "weights": sim.agent_weights(), "history": list(sim.history), "start": start,
        "stream": _stream_lines(sim) if telemetry else None,
    }


def _replays_in_turns(runs, kmods, name, R, W):
    """TEL_REPLAYS windows past the checked rounds for each of ``runs``
    (tag -> (simulation, timer); two runs may share a simulation), in turns
    (forward, then backward, ...), each window timed with its run's timer;
    then one witnessed profiled replay of each simulation
    (`_witnessed_profile`). Returns per run the windows' seconds and phases
    and its simulation's profile."""
    out = {tag: {"wins": []} for tag in runs}
    at = {id(sim): R for sim, _ in runs.values()}
    order = list(runs)
    for i in range(TEL_REPLAYS):
        for tag in (order if i % 2 == 0 else order[::-1]):
            sim, timer = runs[tag]
            sim.timer = timer
            out[tag]["wins"].append(_timed_window(sim, at[id(sim)], W)[0])
            at[id(sim)] += W
    profiles = {}
    for tag, (sim, _) in runs.items():
        if id(sim) not in profiles:
            prof, readings, extra = _witnessed_profile(
                sim, lambda: sim.run_window(at[id(sim)], W), kmods, f"{name} {tag}")
            (graph,) = (g.graph for g in sim.graphs.values())
            _require(graph.replays == at[id(sim)] // W + 1 + extra,
                     f"{name} {tag}: the timed windows were not all replays of one graph")
            profiles[id(sim)] = {"names": prof["names"], "device_s": prof["device_s"],
                                 "profiles": readings}
        out[tag].update(profiles[id(sim)])
    return out


def phase_telemetry(mods, kmods, configs):
    """Telemetry at full width, for each of ``configs`` (name, extra, window,
    per-round launches, scalar rounds): the windowed run with telemetry off,
    the same with it on, the same rounds one at a time with it on and, for
    ``scalar rounds``, the scalar engine with it on. Requires: weights and
    history bit for bit off against on, the same kernel launches and graph
    records; the windowed stream byte for byte the per-round stream (its
    skipped rounds carrying the last evaluated accuracies); every row's
    totals the engine's counters after its round and its channel columns
    their change; the scalar engine's first rows equal in every SGD-free
    column; a witnessed profiled replay of each run (`_witnessed_profile`).
    Reports TEL_REPLAYS replayed windows' seconds (median, spread) and
    phases, timed in turns on the same card, with telemetry off (timed twice:
    with NULL_TIMER, the engine's default, which syncs nowhere, and with a
    PhaseTimer, which syncs at each device phase's end as the recorder's
    timer does) and on; each run's peak device memory over what was
    allocated before it; the profiled replay's kernels, copies and device
    seconds, and by which kernels off and on differ."""
    import torch

    fl, data = mods["fl"], mods["data"]
    x_tr, y_tr, x_te, y_te = data.synth_mnist(**MAIN_DATA)
    out, launches = {}, dict.fromkeys(kmods, 0)
    for name, extra, window, per_round, n_scalar in configs:
        cfg = fl.SimConfig(**dict(MAIN_CFG, **window), **extra)
        shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
        R, W = cfg.rounds, cfg.scan_rounds
        sim_off, off = _telemetry_run(mods, kmods, cfg, shards, x_te, y_te, False)
        sim_on, on = _telemetry_run(mods, kmods, cfg, shards, x_te, y_te, True)
        evaluated = {r for r in range(R) if sim_on._do_eval(r)}
        runs = {"off_null": (sim_off, mods["telemetry"].NULL_TIMER),
                "off": (sim_off, sim_off.timer), "on": (sim_on, sim_on.timer)}
        timed = _replays_in_turns(runs, kmods, name, R, W)
        del sim_off, sim_on
        torch.cuda.empty_cache()
        for k in kmods:
            launches[k] += on["launches"][k]
        _require(on["weights"].tobytes() == off["weights"].tobytes(),
                 f"{name}: telemetry changed the weights by "
                 f"{np.abs(on['weights'] - off['weights']).max()}")
        _require(on["history"] == off["history"], f"{name}: telemetry changed the history")
        _require(on["launches"] == off["launches"],
                 f"{name}: launches on {on['launches']}, off {off['launches']}")
        _require(on["graph_launches"] == off["graph_launches"],
                 f"{name}: graph records on {on['graph_launches']}, off {off['graph_launches']}")
        want = {k: per_round.get(k, 0) * (R + 1) for k in kmods}  # a warm-up round + R
        _require(on["launches"] == want, f"{name}: launches {on['launches']}, expected {want}")

        # the same rounds one at a time, telemetry on: the stream's reference
        eager = fl.make_simulation(dataclasses.replace(cfg, scan_rounds=0, telemetry=True),
                                   shards, x_te, y_te, device="cuda")
        counters = []
        for rnd in range(R):
            eager.run_round(rnd)
            counters.append((eager.messages_sent, eager.messages_dropped, eager._bytes_total))
        per_round_lines = _stream_lines(eager)
        del eager
        torch.cuda.empty_cache()
        _require(on["stream"] == _carried(per_round_lines, evaluated),
                 f"{name}: the windowed stream differs from the per-round stream")
        rows, prev = _rows(on["stream"]), on["start"]
        for row, c in zip(rows, counters, strict=True):
            totals = (row["msgs_total"], row["drops_total"], row["bytes_total"])
            _require(totals == c, f"{name}: round {row['round']} totals {totals}, counters {c}")
            ch = {m: sum(row[f"{m}_{x}"] for x in mods["telemetry"].CHANNELS)
                  for m in ("msgs", "bytes", "drops")}
            got = (ch["msgs"], ch["drops"] + row["drops_offline"], ch["bytes"])
            _require(got == tuple(a - b for a, b in zip(c, prev)),
                     f"{name}: round {row['round']} channel sums {got}, counters {c} from {prev}")
            prev = c
        vs_scalar = None
        if n_scalar:
            t0 = time.perf_counter()
            ref = fl.make_simulation(dataclasses.replace(cfg, engine="scalar", telemetry=True),
                                     shards, x_te, y_te, device="cuda")
            for rnd in range(n_scalar):
                ref.run_round(rnd)
            for r, s in zip(rows[:n_scalar], _rows(_stream_lines(ref)), strict=True):
                _require(_sgd_free(r) == _sgd_free(s),
                         f"{name}: round {r['round']} differs from the scalar engine's row")
            vs_scalar = {"rounds": n_scalar, "sgd_free_columns_equal": True,
                         "scalar_s": time.perf_counter() - t0}
            del ref
            torch.cuda.empty_cache()

        (k_off, c_off), (k_on, c_on) = (_split_copies(timed[t]["names"]) for t in ("off", "on"))
        res = {
            "config": name, "rounds": R, "scan_rounds": W, "eval_cadence": cfg.eval_cadence,
            "wire_dtype": cfg.wire_dtype, "conditions": dataclasses.asdict(cfg.conditions),
            "bitwise_off_vs_on": True, "stream_equals_per_round": True,
            "launches": on["launches"], "graph_launches_per_replay": on["graph_launches"],
            "vs_scalar": vs_scalar,
        }
        for tag in ("off_null", "off", "on"):
            wins = timed[tag]["wins"]
            rep = [w["s"] for w in wins]
            res[tag] = {
                "replayed_window_s": rep, "median_s": float(np.median(rep)),
                "spread_s": float(max(rep) - min(rep)),
                "median_s_per_round": float(np.median(rep)) / W,
                "median_phases_s": {k: float(np.median([w["phases_s"].get(k, 0.0) for w in wins]))
                                    for k in sorted({k for w in wins for k in w["phases_s"]})},
            }
        for tag, m, kernels, copies in (("off", off, k_off, c_off), ("on", on, k_on, c_on)):
            res[tag].update({
                "peak_memory": m["peak_memory"],
                "profiled_replay_kernels": sum(kernels.values()),
                "profiled_replay_copies": dict(copies),
                "profiled_replay_device_s": timed[tag]["device_s"],
                "profiles": timed[tag]["profiles"],
            })
        res["on_minus_off"] = {
            "median_s_per_round": res["on"]["median_s_per_round"] - res["off"]["median_s_per_round"],
            # against the engine's default off path (NULL_TIMER: no phase
            # syncs), what a user pays for turning telemetry on
            "median_s_per_round_vs_off_null":
                res["on"]["median_s_per_round"] - res["off_null"]["median_s_per_round"],
            "median_phases_s_per_round": {
                k: (res["on"]["median_phases_s"].get(k, 0.0) - v) / W
                for k, v in res["off"]["median_phases_s"].items()},
            "profiled_replay_device_s_per_round":
                (timed["on"]["device_s"] - timed["off"]["device_s"]) / W,
            "peak_memory": on["peak_memory"] - off["peak_memory"],
            "kernels_added": dict(k_on - k_off), "kernels_removed": dict(k_off - k_on),
            "copies_added": dict(c_on - c_off), "copies_removed": dict(c_off - c_on),
        }
        out[name] = res
    _require(all(launches[k] > 0 for c in configs for k in c[3]), "a kernel never launched")
    res = {"phase": "main_telemetry", "configs": out, "launches": launches}
    _emit(res)
    return res


def _last_state(rounds):
    """A baseline's round generator run to its end: its history and its
    last state (weights or models) on the host."""
    hist, state = [], None
    for h, state in rounds:
        hist.append(h)
    return hist, state.cpu().numpy()


def _centralized_loop(part, trainer, mlp_mnist, shards, x_te, y_te, rounds, local_iters):
    """The reference's run_centralized body (src/repro/fl/centralized.py:
    28-47) as its per-agent loop: the port's LocalTrainer on the card,
    numpy's mean. Returns the final weights and the history."""
    w, _ = part.flatten_params(mlp_mnist.init_params(0))
    trainers = [trainer(a, x, y, 0.1, local_iters, 128, 0, device="cuda")
                for a, (x, y) in enumerate(shards)]
    hist = []
    for rnd in range(rounds):
        deltas = np.stack([t.train_delta(w.copy()) for t in trainers])
        w = w - deltas.mean(axis=0)
        hist.append({"acc_mean": trainers[0].evaluate(w, x_te, y_te),
                     "bytes_total": int((rnd + 1) * 2 * len(shards) * w.nbytes)})
    return w, hist


def _gossip_loop(part, trainer, mlp_mnist, shards, x_te, y_te, rounds, local_iters, fanout, K):
    """The reference's run_gossip body (src/repro/fl/gossip.py:34-72) as its
    per-agent loop, the same way. Returns the final (A, N) models and the
    history."""
    rng = np.random.default_rng(0)
    n = len(shards)
    w0, _ = part.flatten_params(mlp_mnist.init_params(0))
    spec = part.PartitionSpec.even(w0.size, K)
    models = [w0.copy() for _ in range(n)]
    trainers = [trainer(a, x, y, 0.1, local_iters, 128, 0, device="cuda")
                for a, (x, y) in enumerate(shards)]
    hist, total = [], 0
    for _ in range(rounds):
        for a in range(n):
            models[a] = models[a] - trainers[a].train_delta(models[a].copy())
        new_models = []
        for a in range(n):
            acc = models[a].copy()
            for lo, s in zip(spec.offsets(), spec.sizes):
                peers = rng.choice([p for p in range(n) if p != a], size=min(fanout, n - 1),
                                   replace=False)
                acc[lo : lo + s] = np.mean(
                    [models[p][lo : lo + s] for p in peers] + [models[a][lo : lo + s]], axis=0)
                total += int(models[a][lo : lo + s].nbytes * len(peers))
            new_models.append(acc)
        models = new_models
        accs = np.array([trainers[0].evaluate(m, x_te, y_te) for m in models])
        hist.append({"acc_mean": float(accs.mean()), "bytes_total": total})
    return np.stack(models), hist


def _baselines_agree(mods):
    """(a) The batched baselines on the card against the reference's
    per-agent bodies on the card, at `agree`'s data and 5 agents, 3 rounds:
    with float64 SGD (``_float64_sgd``) the weights bit for bit; every round
    ``bytes_total`` the closed form exactly; with float32 SGD the weights'
    gap reported."""
    import importlib

    import torch

    fl, data, mlp = mods["fl"], mods["data"], mods["mlp_mnist"]
    part = importlib.import_module("repro_torch.core.partition")
    x_tr, y_tr, x_te, y_te = data.synth_mnist(num_train=1500, num_test=300, seed=0)
    A, K, R, L = (AGREE_CFG[k] for k in ("num_agents", "num_partitions", "rounds", "local_iters"))
    shards = data.iid_split(x_tr, y_tr, A, seed=0)
    N = part.flatten_params(mlp.init_params(0))[0].size
    cases = {
        "centralized": (
            lambda: fl.centralized._centralized_rounds(shards, x_te, y_te, R, 0.1, L, 128, 0, "cuda"),
            lambda: _centralized_loop(part, fl.LocalTrainer, mlp, shards, x_te, y_te, R, L),
            [(r + 1) * 2 * A * 4 * N for r in range(R)]),
    }
    for fanout in (1, 2):
        cases[f"gossip_fanout{fanout}"] = (
            lambda f=fanout: fl.gossip._gossip_rounds(
                shards, x_te, y_te, R, f, K, 0.1, L, 128, 0, "cuda"),
            lambda f=fanout: _gossip_loop(part, fl.LocalTrainer, mlp, shards, x_te, y_te, R, L, f, K),
            [(r + 1) * A * min(fanout, A - 1) * 4 * N for r in range(R)])
    out = {}
    for name, (batched, loop, closed) in cases.items():
        res = {}
        for sgd in ("float64", "float32"):
            with _float64_sgd(mlp) if sgd == "float64" else nullcontext():
                hist, w = _last_state(batched())
                w_loop, hist_loop = loop()
            got = [h["bytes_total"] for h in hist]
            _require(got == closed == [h["bytes_total"] for h in hist_loop]
                     and all(type(b) is int for b in got),
                     f"baselines {name}: bytes_total {got}, closed form {closed}")
            accs = [h["acc_mean"] for h in hist]
            _require(all(math.isfinite(a) for a in accs), f"baselines {name}: accuracy {accs}")
            res[sgd] = {
                "max_abs_w_diff": float(np.abs(w - w_loop).max()),
                "bitwise": _bits_equal(torch.from_numpy(w), torch.from_numpy(w_loop.astype(np.float32))),
                "acc_mean": accs, "acc_mean_loop": [h["acc_mean"] for h in hist_loop],
            }
        _require(res["float64"]["bitwise"],
                 f"baselines {name}, float64 SGD: weights differ from the per-agent loop: {res}")
        out[name] = dict(res, bytes_total=closed)
    return out


def _fig2(mods, x_tr, y_tr, x_te, y_te):
    """(b) Fig. 2a's largest cell: IPLS on the batched engine in windows of
    8 against run_centralized on the same shards."""
    import gc

    import torch

    fl, data, telemetry = mods["fl"], mods["data"], mods["telemetry"]
    cfg = fl.SimConfig(**FIG2)
    shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    start_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    setup_s = time.perf_counter() - t0
    sim.timer = telemetry.PhaseTimer()
    windows = [_timed_window(sim, r0, min(cfg.scan_rounds, cfg.rounds - r0))[0]
               for r0 in range(0, cfg.rounds, cfg.scan_rounds)]
    ipls = {
        "setup_s": setup_s, "windows": windows, "graphs": len(sim.graphs),
        "device_dispatches": sim.device_dispatches,
        "capture_s": windows[0]["phases_s"].get("graph_capture"),
        "first_window_s_per_round_without_capture":
            (windows[0]["s"] - windows[0]["phases_s"].get("graph_capture", 0.0)) / cfg.scan_rounds,
        "replayed_s_per_round": [w["s_per_round"] for w in windows[1:]],
        "allocated_at_start": start_mem, "peak_memory": torch.cuda.max_memory_allocated(),
        "acc_mean": [h["acc_mean"] for h in sim.history],
    }
    _require(len(sim.history) == cfg.rounds and sim.device_dispatches == len(windows),
             f"fig2: {len(sim.history)} rounds in {sim.device_dispatches} dispatches")
    del sim
    gc.collect()
    torch.cuda.synchronize()
    start_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    round_s, hist = [], []
    t0 = time.perf_counter()
    for h, _ in fl.centralized._centralized_rounds(
            shards, x_te, y_te, cfg.rounds, cfg.lr, cfg.local_iters, cfg.batch_size, cfg.seed,
            "cuda"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        round_s.append(t1 - t0)
        hist.append(h)
        t0 = t1
    central = {"round_s": round_s, "median_s_per_round": float(np.median(round_s)),
               "allocated_at_start": start_mem, "peak_memory": torch.cuda.max_memory_allocated(),
               "acc_mean": [h["acc_mean"] for h in hist]}
    accs = ipls["acc_mean"] + central["acc_mean"]
    _require(all(math.isfinite(a) for a in accs), f"fig2: non-finite accuracy {accs}")
    acc_i, acc_c = ipls["acc_mean"][-1], central["acc_mean"][-1]
    _require(acc_c > central["acc_mean"][0], f"fig2: centralized did not learn {central}")
    return {
        "config": FIG2, "ipls": ipls, "centralized": central,
        # as bench_convergence.py:51 reckons it; recorded, not gated
        "final_drop_permille": (acc_c - acc_i) / max(acc_c, 1e-9) * 1000.0,
    }


def _gossip_full(mods, x_tr, y_tr, x_te, y_te, main):
    """(c) Segmented gossip at the main path's width: seconds per round by
    phase, peak memory, and bytes per agent per round beside IPLS main's
    (bench_scalability.py's reckoning: total bytes / agents / rounds)."""
    import gc

    import torch

    fl, data, telemetry = mods["fl"], mods["data"], mods["telemetry"]
    A, g = MAIN_CFG["num_agents"], GOSSIP
    shards = data.iid_split(x_tr, y_tr, A, seed=0)
    timer = telemetry.PhaseTimer()
    gc.collect()
    torch.cuda.synchronize()
    start_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rounds, hist, phases, models = [], [], {}, None
    t0 = time.perf_counter()
    for h, models in fl.gossip._gossip_rounds(
            shards, x_te, y_te, g["rounds"], g["fanout"], g["num_partitions"], 0.1,
            g["local_iters"], g["batch_size"], 0, "cuda", timer=timer):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        now = {k: v["total_s"] for k, v in timer.summary().items()}
        rounds.append({"s": t1 - t0, "phases_s": _phase_delta(phases, now)})
        hist.append(h)
        phases, t0 = now, t1
    peak = torch.cuda.max_memory_allocated()
    accs = [h["acc_mean"] for h in hist]
    _require(all(math.isfinite(a) for a in accs), f"gossip: non-finite accuracy {accs}")
    _require(bool(torch.isfinite(models).all()), "gossip: non-finite weights")
    per_agent = hist[-1]["bytes_total"] / A / g["rounds"]
    ipls = main["bytes_total"] / main["agents"] / main["rounds"]
    return {
        "config": dict(g, num_agents=A), "rounds": rounds, "allocated_at_start": start_mem,
        "peak_memory": peak,
        "acc_mean": accs, "acc_std": [h["acc_std"] for h in hist],
        "bytes_total": hist[-1]["bytes_total"], "bytes_per_agent_per_round": per_agent,
        "ipls_main_bytes_per_agent_per_round": ipls, "gossip_over_ipls": per_agent / ipls,
    }


def _start_examples():
    """The port's examples, each its own process on the card, all at once."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return {
        name: (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.examples.{name}", *args], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, args in EXAMPLES.items()
    }


def _finish_examples(procs):
    """Wait for the examples; each must exit 0. Returns their wall seconds
    and the lines of their summary."""
    out = {}
    for name, (t0, p) in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"chip_smoke: example {name} ran over {EXAMPLE_TIMEOUT_S} s")
        _require(p.returncode == 0, f"example {name} exited {p.returncode}: {stderr[-3000:]}")
        out[name] = {
            "args": list(EXAMPLES[name]), "s": time.perf_counter() - t0,
            "summary": [ln for ln in stdout.splitlines() if re.match(
                r"(accuracy drop|total bytes|device dispatches|scalar-oracle|partition)", ln)],
        }
    return out


def phase_baselines(mods, main):
    """The paper's baselines on the card: (a) agreement at `agree`'s config,
    (b) Fig. 2a's 50-agent cell in windows of 8 against centralized FedAvg,
    (c) segmented gossip at 100 agents against IPLS ``main``'s traffic; and
    both examples as subprocesses, run while (a) runs (not timed)."""
    t0 = time.perf_counter()
    procs = _start_examples()
    try:
        agree = _baselines_agree(mods)
        examples = _finish_examples(procs)
    finally:  # stop any example left running
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    x_tr, y_tr, x_te, y_te = mods["data"].synth_mnist(**MAIN_DATA)
    res = {
        "phase": "baselines", "agree": agree, "examples": examples,
        "fig2": _fig2(mods, x_tr, y_tr, x_te, y_te),
        "gossip": _gossip_full(mods, x_tr, y_tr, x_te, y_te, main),
    }
    res["seconds"] = time.perf_counter() - t0
    _emit(res)
    return res


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (a float32 tensor)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


def _gap(got, want, tol: float, ulp: bool):
    """(max |got - want|, passes): each element within ``tol`` plus, with
    ``ulp``, one bfloat16 ulp of the larger magnitude."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    bound = tol + (_bf16_ulp(torch.maximum(g.abs(), w.abs())) if ulp else 0.0)
    return d.max().item(), bool((d <= bound).all())


def _same_argmax(a, b) -> float:
    """The share of rows whose greedy token is the same in two logits."""
    return (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def _serve_run(model, prompt, steps, cache_len, extra=None):
    """The port's prefill (with ``extra`` inputs: whisper's frames, M-RoPE's
    positions3), then teacher-forced decode steps; every logits."""
    logits, cache = model.prefill({"tokens": prompt, "cache_len": cache_len, **(extra or {})})
    out = [logits.cpu()]
    for i, tok in enumerate(steps):
        logits, cache = model.decode_step(
            cache, {"token": tok, "pos": prompt.shape[1] + i}
        )
        out.append(logits.cpu())
    return out


def _count_kinds(cfg, kind: str) -> int:
    """Blocks of ``kind`` an LM's pass runs: a group's shared blocks once
    per application."""
    return sum(b.kind == kind for g in cfg.groups for b in (g.blocks + g.shared) * g.repeat)


def _image(n: int):
    """lm_agree's M-RoPE image in an n-token prompt: (text tokens before it,
    its patch grid), a 2 x 4 grid (3 x 6 from 40 tokens on) after n // 5
    tokens."""
    return n // 5, (2, 4) if n < 40 else (3, 6)


def _unit_gain(model) -> None:
    """Scale every weight matrix of an encoder-decoder's layers by
    sqrt(2 / d_model), in place (LM_BF16_UNIT_GAIN's note)."""
    import torch

    with torch.no_grad():
        for layer in list(model.enc) + list(model.dec):
            for p in layer.parameters():
                if p.dim() >= 2:
                    p.mul_((2 / model.cfg.d_model) ** 0.5)


def _expected_launches(kmods, model, n_steps: int):
    """Each kernel's launches in a prefill and ``n_steps`` decode steps of
    ``model`` (its ``kernel_launches``)."""
    calls = model.kernel_launches()
    want = dict.fromkeys(kmods, 0)
    want.update(calls["prefill"])
    for k, n in calls["decode_step"].items():
        want[k] += n * n_steps
    return want


def _with_next(extra, P):
    """``extra`` for a prefill of P + 1 tokens whose last is decoded at pos P:
    positions3 extended by (P, P, P), the position decode rotates it at."""
    import torch

    if "positions3" not in extra:
        return extra
    p3 = extra["positions3"]
    return dict(extra, positions3=torch.cat([p3, torch.full_like(p3[:, :, :1], P)], dim=2))


def _first_rows(extra, rows: int):
    """``extra`` for the first ``rows`` requests."""
    return {k: v[:, :rows] if k == "positions3" else v[:rows] for k, v in extra.items()}


def phase_lm_agree(lm, kmods):
    """The LMs at their reduced configs: card (kernels) against CPU (plain
    versions), same weights, float32 and bf16."""
    import copy

    import torch

    configs = lm["configs"]
    lm["device"].resolve_device("cuda")  # TF32 off: float32 products in full float32
    out, scale = {}, {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, reduced=True)
        base = configs.build_model(cfg, device="cpu", seed=0)
        want_launches = _expected_launches(kmods, base, LM_AGREE_STEPS)
        for dtype in (torch.float32, torch.bfloat16):
            cpu = copy.deepcopy(base).to(dtype)
            if dtype == torch.bfloat16 and arch in LM_BF16_UNIT_GAIN:
                _unit_gain(cpu)
            gpu = copy.deepcopy(cpu).to("cuda")
            for P, cache_len in LM_AGREE_CASES:
                rng = np.random.default_rng(P)
                prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, P), dtype=np.int32))
                steps = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32))
                         for _ in range(LM_AGREE_STEPS)]
                extra = lm["serve_lm"].request_inputs(cfg, 2, P, seed=P, image=_image(P))
                want = _serve_run(cpu, prompt, steps, cache_len, extra)
                tol = 1e-5 if dtype == torch.float32 else LM_BF16_TOL_BY_ARCH.get(arch,
                                                                                  LM_BF16_TOL)
                _reset_launches(kmods)
                got = _serve_run(gpu, prompt, steps, cache_len, extra)
                launched = {k: fn.LAUNCHES for k, fn in kmods.items()}
                _require(launched == want_launches, f"{arch}: launches {launched}")
                f32 = dtype == torch.float32
                worst = 0.0
                for i, (g, w) in enumerate(zip(got, want)):
                    d, ok = _gap(g, w, tol, ulp=f32)
                    _require(ok and bool(torch.isfinite(g.float()).all()),
                             f"lm_agree {arch} {dtype} P={P} step {i}: max |d| {d}")
                    worst = max(worst, d)
                key = f"{arch}/{str(dtype)[6:]}/P{P}"
                out[key] = worst
                scale[key] = max(w.float().abs().max().item() for w in want)
    _emit({"phase": "lm_agree", "steps": LM_AGREE_STEPS, "cases": list(LM_AGREE_CASES),
           "tolerance": {"float32": "one bf16 ulp + 1e-5", "bfloat16": LM_BF16_TOL,
                         "bfloat16_by_arch": LM_BF16_TOL_BY_ARCH},
           "bfloat16_unit_gain": list(LM_BF16_UNIT_GAIN),
           "max_abs_logit_diff": out, "max_abs_logit": scale})


def _host_state(tree, state):
    """A host copy of a train state (every tensor)."""
    return tree.tree_map(lambda t: t.detach().to("cpu", copy=True), state)


def _load_state(tree, state, host) -> None:
    """Write a host copy's values into a state's own tensors."""
    import torch

    with torch.no_grad():
        for dst, src in zip(tree.tree_leaves(state), tree.tree_leaves(host)):
            dst.copy_(src)


def _family_step_agree(tr, arch):
    """One SGD step (0.5, clip 1.0) of ``arch``'s reduced config in float32
    on the card, against the same step on the CPU from the same weights
    (drawn on the CPU from the seed) in float32 and in float64. The card's
    step runs without a mesh (``make_train_step``) and through
    ``build_train_step`` on the smoke mesh: the two bit for bit, but for
    MoE, whose mesh path sizes its capacity by the rank's tokens where the
    step without a mesh takes the grouped path. Returns the gaps: params
    (largest |d| over the leaves), loss and grad norm (relative), each of
    the card and of the CPU's float32 step against the float64 step, the
    loss card vs CPU, and step and eps equal."""
    import torch

    configs, sharded, steps, optim, tree = (tr[k] for k in
                                            ("configs", "sharded", "steps", "optim", "tree"))
    cfg = configs.get_config(arch, reduced=True)
    B, S = TRAIN_AGREE["batch"], TRAIN_AGREE["seq_len"]
    rng = np.random.default_rng(TRAIN_AGREE["seed"])
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)),
             "participation": torch.ones(B)}
    if hasattr(cfg, "enc_layers"):
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))
    scfg = sharded.IplsStepConfig(grad_clip=1.0)

    def step(device, dtype, on_mesh=False):
        model = configs.build_model(cfg, device="cpu", seed=TRAIN_AGREE["seed"]).to(dtype)
        model = model.to(device)
        opt = optim.sgd(0.5)
        if on_mesh:
            built = steps.build_train_step(
                model, tr["mesh"].make_smoke_mesh("cuda"),
                configs.ShapeSpec("train_agree", S, B, "train"), optimizer=opt, step_cfg=scfg)
            state, m = built.fn(built.init_state(model.params()), batch)
        else:
            fn = sharded.make_train_step(model.loss, opt, scfg, num_agents=1)
            state, m = fn(sharded.init_state(model.params(), opt), batch)
        return dict(tree.named_leaves(_host_state(tree, state))), {k: float(v)
                                                                   for k, v in m.items()}

    card, m_card = step("cuda", torch.float32)
    built, m_built = step("cuda", torch.float32, on_mesh=True)
    cpu, m_cpu = step("cpu", torch.float32)
    f64, m_64 = step("cpu", torch.float64)
    bitwise = all(_bits_equal(card[k], built[k]) for k in card) and m_card == m_built
    out = {"built_step_bitwise": bitwise, "loss": m_card["loss"],
           "exact": all(_bits_equal(card[k], cpu[k]) for k in (".step", ".eps"))}
    for who, st, m in (("card", card, m_card), ("cpu", cpu, m_cpu)):
        out[f"{who}_params"] = max(float((st[k].double() - f64[k]).abs().max())
                                   for k in f64 if k.startswith(".params"))
        for k in ("loss", "grad_norm"):
            out[f"{who}_{k}"] = abs(m[k] - m_64[k]) / max(1.0, abs(m_64[k]))
    out["loss_card_vs_cpu"] = abs(m_card["loss"] - m_cpu["loss"]) / max(1.0, abs(m_cpu["loss"]))
    return out


def _fsdp_step_agree(tr, arch):
    """One built step with fsdp=True against one with fsdp=False on the
    card's smoke mesh, each from the same host copy of the parameters (a
    gather over a world of one is the identity, and the update writes the
    stored slice in place of a LoadModel): the states and metrics bit for
    bit. The reduced config in float32 at TRAIN_AGREE's batch; deepseek at
    full width (bf16) on its dense layer and FSDP_AGREE_MOE_LAYERS MoE
    layer, at TRAIN's 2 x 4,096 tokens. Default optimizer (AdamW)."""
    import torch

    configs, sharded, steps, tree = (tr[k] for k in ("configs", "sharded", "steps", "tree"))
    full = arch == "deepseek-v2-lite-16b"
    if full:
        cfg = _train_config(configs, dict(arch=arch, layers=FSDP_AGREE_MOE_LAYERS))
        B, S = TRAIN["batch"], TRAIN["seq_len"]
    else:
        cfg = configs.get_config(arch, reduced=True)
        B, S = TRAIN_AGREE["batch"], TRAIN_AGREE["seq_len"]
    t0 = time.perf_counter()
    model = configs.build_model(cfg, device="cuda", seed=TRAIN_AGREE["seed"])
    if not full:
        model = model.float()
    rng = np.random.default_rng(TRAIN_AGREE["seed"])
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)),
             "participation": torch.ones(B)}
    if hasattr(cfg, "enc_layers"):
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)).to(model.dtype)
    host = _host_state(tree, model.params())
    mesh = tr["mesh"].make_smoke_mesh("cuda")
    runs = []
    for fsdp in (False, True):
        _load_state(tree, model.params(), host)
        built = steps.build_train_step(model, mesh, configs.ShapeSpec("fsdp_agree", S, B, "train"),
                                       step_cfg=sharded.IplsStepConfig(fsdp=fsdp))
        state, m = built.fn(built.init_state(model.params()), batch)
        runs.append(([t.detach().clone() for t in tree.tree_leaves(state)], m))
        del state, built
    (s0, m0), (s1, m1) = runs
    out = {"bitwise": all(_bits_equal(a, b) for a, b in zip(s0, s1))
           and all(_bits_equal(m0[k], m1[k]) for k in m0),
           "loss": float(m1["loss"]), "leaves": len(s0), "seconds": time.perf_counter() - t0}
    if full:
        out.update(params=sum(p.numel() for p in model.parameters()), batch=B, seq_len=S)
    del runs, s0, s1, model, host
    torch.cuda.empty_cache()
    return out


def phase_train_agree(tr, kmods):
    """The train step on the card's smoke mesh (internlm2-reduced, float32):
    bit for bit the card's step without a mesh; each step, from the card's
    state before it, as close to the same step on the CPU in float64 as the
    CPU's float32 step is (TRAIN_AGREE_TOL), by bounds that refuse a skipped
    or negated AdamW step; a run checkpointed after step 2 and restored into
    a fresh model bit for bit the uninterrupted one; no kernel launch."""
    import tempfile

    import torch

    configs, sharded, steps, optim, tree = (tr[k] for k in
                                            ("configs", "sharded", "steps", "optim", "tree"))
    t_phase = time.perf_counter()
    cfg = configs.get_config(TRAIN["arch"], reduced=True)
    B, S, n = TRAIN_AGREE["batch"], TRAIN_AGREE["seq_len"], TRAIN_AGREE["steps"]
    rng = np.random.default_rng(TRAIN_AGREE["seed"])
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)),
             "participation": torch.ones(B)}
    mesh = tr["mesh"].make_smoke_mesh("cuda")
    shape = configs.ShapeSpec("train_agree", S, B, "train")
    legs = (("sgd", lambda: optim.sgd(0.5), sharded.IplsStepConfig(grad_clip=1.0)),
            ("adamw", lambda: optim.adamw(TRAIN_AGREE_ADAMW_LR),
             sharded.IplsStepConfig(accum_steps=2)))
    launches0 = {k: fn.LAUNCHES for k, fn in kmods.items()}

    def fresh(device):
        return configs.build_model(cfg, device=device, seed=TRAIN_AGREE["seed"]).float()

    def step_fn(model, leg, device, on_mesh):
        _, make_opt, scfg = next(x for x in legs if x[0] == leg)
        opt = make_opt()
        if on_mesh:
            built = steps.build_train_step(model, mesh, shape, optimizer=opt, step_cfg=scfg)
            return built.fn, built.init_state(model.params())
        return (sharded.make_train_step(model.loss, opt, scfg, num_agents=1),
                sharded.init_state(model.params(), opt))

    def run(device, on_mesh):
        """Both legs on one model: per step (leg, state before, state after,
        metrics), host copies."""
        model, out = fresh(device), []
        for leg, _, _ in legs:
            fn, state = step_fn(model, leg, device, on_mesh)
            for _ in range(n):
                before = _host_state(tree, state)
                state, m = fn(state, batch)
                out.append((leg, before, _host_state(tree, state),
                            {k: v.detach().cpu() for k, v in m.items()}))
        return out

    mesh_run = run("cuda", on_mesh=True)
    no_mesh = run("cuda", on_mesh=False)
    bitwise = all(
        all(_bits_equal(a, b) for a, b in zip(tree.tree_leaves(x[2]), tree.tree_leaves(y[2])))
        and all(_bits_equal(x[3][k], y[3][k]) for k in x[3])
        for x, y in zip(mesh_run, no_mesh))

    # each step on the CPU from the card's state before it, in float32 and
    # in float64 (the yardstick of both float32 steps)
    f64_keys = ("params_sgd", "params_adamw", "moments", "grad_norm")
    gaps = {"params": {"sgd": 0.0, "adamw": 0.0}, "metrics": dict.fromkeys(mesh_run[0][3], 0.0),
            "vs_float64": {f"{who}_{k}": 0.0 for k in f64_keys for who in ("card", "cpu")},
            # the wrong AdamW steps the bounds must refuse (the least over steps)
            "adamw_wrong": {"params_skipped": 1.0,  # before - w64 = -update, exactly 1
                            "params_negated": np.inf, "moments_skipped": np.inf}}
    wrong = gaps["adamw_wrong"]

    def cpu_step(leg, before, dtype):
        model = fresh("cpu").to(dtype)
        fn, state = step_fn(model, leg, "cpu", on_mesh=False)
        _load_state(tree, state, before)
        return fn(state, batch)

    def most(d, key, value):
        d[key] = max(d[key], value)

    def leaf_rel(x, w):
        """Largest |x - w| over the largest |w| of the leaf (float64)."""
        d, scale = float((x.double() - w).abs().max()), float(w.abs().max())
        return d / scale if scale > 0 else (0.0 if d == 0 else np.inf)

    for leg, before, after, metrics in mesh_run:
        state, m = cpu_step(leg, before, torch.float32)
        s64, m64 = cpu_step(leg, before, torch.float64)
        card_t, p64 = dict(tree.named_leaves(after)), dict(tree.named_leaves(s64))
        was = dict(tree.named_leaves(before))
        sq = dict.fromkeys(("card", "cpu", "update", "negated"), 0.0)  # AdamW params, L2
        for name, g in tree.named_leaves(state):
            card, w = card_t[name], p64[name]
            d = float((g.float() - card.float()).abs().max())
            if name.startswith(".params"):
                most(gaps["params"], leg, d)
                if leg == "sgd":
                    most(gaps["vs_float64"], "cpu_params_sgd", float((g.double() - w).abs().max()))
                    most(gaps["vs_float64"], "card_params_sgd",
                         float((card.double() - w).abs().max()))
                else:
                    b = was[name].double()
                    sq["card"] += float((card.double() - w).square().sum())
                    sq["cpu"] += float((g.double() - w).square().sum())
                    sq["update"] += float((w - b).square().sum())
                    sq["negated"] += float((2 * b - card.double() - w).square().sum())
            elif name.startswith(".opt_state"):
                most(gaps["vs_float64"], "cpu_moments", leaf_rel(g, w))
                most(gaps["vs_float64"], "card_moments", leaf_rel(card, w))
                wrong["moments_skipped"] = min(wrong["moments_skipped"], leaf_rel(was[name], w))
            else:
                _require(d == 0.0, f"train_agree: {name} differs on the CPU")
        if leg == "adamw":
            upd = np.sqrt(sq["update"])
            _require(upd > 0, "train_agree: the float64 AdamW step moved nothing")
            for who in ("card", "cpu"):
                most(gaps["vs_float64"], f"{who}_params_adamw", np.sqrt(sq[who]) / upd)
            wrong["params_negated"] = min(wrong["params_negated"], np.sqrt(sq["negated"]) / upd)
        for k in m:
            most(gaps["metrics"], k, abs(float(m[k]) - float(metrics[k]))
                 / max(1.0, abs(float(metrics[k]))))
        gn = float(m64["grad_norm"])
        most(gaps["vs_float64"], "cpu_grad_norm", abs(float(m["grad_norm"]) - gn) / gn)
        most(gaps["vs_float64"], "card_grad_norm", abs(float(metrics["grad_norm"]) - gn) / gn)

    # checkpointed after 2 SGD steps, restored into a fresh model, one more
    with tempfile.TemporaryDirectory() as d:
        mgr = tr["checkpoint"].CheckpointManager(d)
        model = fresh("cuda")
        fn, state = step_fn(model, "sgd", "cuda", on_mesh=True)
        for _ in range(2):
            state, _ = fn(state, batch)
        mgr.save(state, step=2)
        model2 = fresh("cuda")
        fn2, state2 = step_fn(model2, "sgd", "cuda", on_mesh=True)
        restored, at = mgr.restore_latest(state2)
        _load_state(tree, state2, restored)
        state2, _ = fn2(state2, batch)
        ckpt_bitwise = at == 2 and all(
            _bits_equal(a, b) for a, b in zip(tree.tree_leaves(_host_state(tree, state2)),
                                               tree.tree_leaves(mesh_run[2][2])))
    families = {arch: _family_step_agree(tr, arch) for arch in TRAIN_AGREE_FAMILIES}
    fsdp = {arch: _fsdp_step_agree(tr, arch) for arch in FSDP_AGREE_ARCHS}
    launched = {k: fn.LAUNCHES - launches0[k] for k, fn in kmods.items()}
    tol, f64 = TRAIN_AGREE_TOL, gaps["vs_float64"]
    bound = {what: tol["float64_ratio"] * f64[f"cpu_{what}"] + tol["float64_floor"]
             for what in f64_keys}
    losses = {leg: [float(x[3]["loss"]) for x in mesh_run if x[0] == leg] for leg, _, _ in legs}
    _emit({"phase": "train_agree", "arch": cfg.name, "batch": B, "seq_len": S,
           "steps_per_leg": n, "legs": [x[0] for x in legs], "losses": losses,
           "bitwise_mesh_vs_no_mesh": bitwise, "checkpoint_restore_bitwise": ckpt_bitwise,
           "cpu_vs_card_max": gaps, "float64_bounds": bound, "tolerance": TRAIN_AGREE_TOL,
           "families": families, "fsdp_vs_no_fsdp": fsdp, "launches": launched,
           "phase_s": time.perf_counter() - t_phase})
    _require(bitwise, "train_agree: the mesh step differs from the step without a mesh")
    _require(all(f["bitwise"] and np.isfinite(f["loss"]) for f in fsdp.values()),
             f"train_agree: fsdp=True differs from fsdp=False {fsdp}")
    _require(ckpt_bitwise, "train_agree: the restored run differs from the uninterrupted one")
    _require(all(v == 0 for v in launched.values()), f"train_agree: kernels launched {launched}")
    for what in f64_keys:
        _require(f64[f"card_{what}"] <= bound[what],
                 f"train_agree: {what} against float64: {f64}, bounds {bound}")
    # the bounds refuse an AdamW step that was skipped or negated
    _require(min(wrong["params_skipped"], wrong["params_negated"]) > bound["params_adamw"]
             and wrong["moments_skipped"] > bound["moments"],
             f"train_agree: the bounds {bound} pass a wrong AdamW step {wrong}")
    _require(gaps["metrics"]["loss"] <= tol["loss"]
             and gaps["metrics"]["participation"] == gaps["metrics"]["eps"] == 0.0,
             f"train_agree: {gaps}")
    _require(all(np.isfinite(v).all() for v in losses.values()), "train_agree: loss not finite")
    for arch, f in families.items():  # each family's one step, by the same yardsticks
        moe = arch.startswith("granite")
        _require((f["built_step_bitwise"] or moe) and f["exact"] and np.isfinite(f["loss"])
                 and f["loss_card_vs_cpu"] <= tol["loss"]
                 and all(f[f"card_{k}"] <= tol["float64_ratio"] * f[f"cpu_{k}"]
                         + tol["float64_floor"] for k in ("params", "grad_norm")),
                 f"train_agree: {arch} {f}")


class _OneRank:
    """A (1, 1) mesh's names and shape: the model-axis-1 mesh path of the
    MoE layer (``activation_sharding``) without a process group."""
    mesh_dim_names, shape = ("data", "model"), (1, 1)


def _moe_slices(p, mode: str, r: int, M: int) -> dict:
    """Rank r's contiguous weight slices of a MoE layer's whole weights for
    a mode (``layers.moe_mode``), as a model built on the mesh holds them:
    "expert" its E / M experts, "ffn" every expert's hidden columns r; the
    router whole (gathered before routing); the shared experts' hidden dim
    split as the rules split "ffn"."""
    out = {"router": p["router"]}
    if mode == "expert":
        n = p["wg"].shape[0] // M
        out.update({k: p[k][r * n:(r + 1) * n].contiguous() for k in ("wg", "wu", "wd")})
    else:
        n = p["wg"].shape[2] // M
        out.update(wg=p["wg"][:, :, r * n:(r + 1) * n].contiguous(),
                   wu=p["wu"][:, :, r * n:(r + 1) * n].contiguous(),
                   wd=p["wd"][:, r * n:(r + 1) * n].contiguous())
    if "shared" in p:
        sh, n = p["shared"], p["shared"]["wu"].shape[1] // M
        out["shared"] = {"wg": sh["wg"][:, r * n:(r + 1) * n].contiguous(),
                         "wu": sh["wu"][:, r * n:(r + 1) * n].contiguous(),
                         "wd": sh["wd"][r * n:(r + 1) * n].contiguous()}
    return out


def _row_ulp_gap(got, want) -> dict:
    """bf16 outputs against the layer's: max |d|, |d| in bf16 ulps of each
    element's own magnitude and of its token row's largest |output| (plus
    1e-5), and the counts beyond one ulp of each."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    in_rows = d / (_bf16_ulp(w.abs().amax(dim=-1, keepdim=True)) + 1e-5)
    return {"max_abs_err": d.max().item(), "max_abs_output": w.abs().max().item(),
            "max_err_in_ulps": (d / (ulp + 1e-5)).max().item(),
            "beyond_one_ulp": int((d > ulp + 1e-5).sum()), "roundings": int((d > 1e-5).sum()),
            "elements": d.numel(), "max_err_in_row_ulps": in_rows.max().item(),
            "beyond_one_row_ulp": int((in_rows > 1).sum())}


def _rank_times(whole, parts) -> dict:
    """Times (CUDA events, 20 calls after 3) of the whole layer and of each
    rank's part: the median and the largest part, their ratio to the
    whole."""
    import statistics

    whole_ms = _time_ms(whole, iters=20, warmup=3)
    rank_ms = [_time_ms(part, iters=20, warmup=3) for part in parts]
    median = statistics.median(rank_ms)
    return {"whole_layer_ms": whole_ms, "median_rank_part_ms": median,
            "slowest_rank_part_ms": max(rank_ms), "rank_part_over_whole": median / whole_ms}


def phase_moe_ep(tr):
    """The routed MoE layer at full width over the production model axis
    (``MOE_EP``): its weights drawn from the seed as the model draws them
    (bf16), one data rank's 2 x 4,096 tokens (bf16, unit scale: a normed
    input); each of the 16 ranks' float32 parts from its slices
    (``layers.moe_rank_partial``, the function the mesh path runs on each
    rank, its collective outside), summed in rank order and cast, against
    the model-axis-1 mesh path (``apply_moe`` under a (1, 1) mesh context)
    on the same tokens: every rank's choices equal the layer's, each output
    within MOE_EP_ROW_ULPS bf16 ulps of its token row's largest magnitude
    plus 1e-5 (the elements beyond one ulp of their own magnitude, and those
    that differ at all, counted). Times (CUDA events): the whole layer, each
    rank's part (the median and the largest), their ratio."""
    import torch

    configs, layers = tr["configs"], tr["layers"]
    from repro_torch.core.sharded import DEFAULT_RULES
    from repro_torch.models.param_defs import init_values
    from repro_torch.models.sharding_hooks import activation_sharding

    t_phase = time.perf_counter()
    B, S = MOE_EP_TOKENS
    M = MOE_EP_M
    out = {"phase": "moe_ep", "model_axis": M, "tokens": [B, S], "cases": {}}
    for case in MOE_EP:
        cfg = configs.get_config(case["arch"])
        s = next(b.moe for g in cfg.groups for b in g.blocks if b.kind == "moe")
        mode = layers.moe_mode(s, dict(DEFAULT_RULES, **cfg.sharding_overrides), M)
        _require(mode == case["mode"], f"moe_ep: {case['arch']} takes {mode}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = init_values(layers.init_moe(s), gen, "cuda")
        x = torch.randn((B, S, s.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        T, C = B * S, layers.moe_capacity(s, B * S)
        ctx = activation_sharding(_OneRank(), {"batch": "data"})
        slices = [_moe_slices(p, mode, r, M) for r in range(M)]
        with torch.no_grad():
            with ctx:
                want = layers.apply_moe(p, s, x, with_lb=False)[0]
            _, _, want_i = layers.moe_route(p, s, x.reshape(1, T, s.d_model))
            total = torch.zeros((B, S, s.d_model), dtype=torch.float32, device="cuda")
            same_routing = True
            for r in range(M):
                part, _, top_i = layers.moe_rank_partial(slices[r], s, x, C, mode, r, M,
                                                         with_lb=False)
                same_routing &= torch.equal(top_i, want_i[0])
                total += part
            got = total.to(torch.bfloat16)

            def whole():
                with activation_sharding(_OneRank(), {"batch": "data"}):
                    layers.apply_moe(p, s, x, with_lb=False)

            times = _rank_times(whole, [
                lambda r=r: layers.moe_rank_partial(slices[r], s, x, C, mode, r, M, with_lb=False)
                for r in range(M)])
        out["cases"][case["arch"]] = {
            "mode": mode, "experts": s.num_experts, "top_k": s.top_k, "d_expert": s.d_expert,
            "shared_hidden": s.d_shared if s.num_shared else 0, "capacity": C,
            "routing_equal": bool(same_routing), **_row_ulp_gap(got, want), **times}
        del p, x, slices, want, total, got
        torch.cuda.empty_cache()
    out["tolerance"] = {"row_ulps": MOE_EP_ROW_ULPS, "of": "the token row's largest |output|",
                        "plus": 1e-5}
    out["phase_s"] = time.perf_counter() - t_phase
    _emit(out)
    for arch, c in out["cases"].items():
        _require(c["routing_equal"] and c["max_err_in_row_ulps"] <= MOE_EP_ROW_ULPS,
                 f"moe_ep: {arch}'s 16 rank parts against the layer: {c}")
    return out


def phase_mla_cp(tr):
    """deepseek-v2-lite-16b's MLA decode context-parallel at full width,
    rank by rank (``MLA_CP_*``; the function each rank runs,
    ``layers._decode_mla_cp``, with its collectives outside): the 16 rank
    parts summed against the one-card ``decode_mla`` on the same weights,
    cache and token, each output within MLA_CP_ROW_ULPS bf16 ulps of its
    token row's largest magnitude plus 1e-5 (the elements beyond one ulp of
    their own magnitude counted). Times (CUDA events): the whole layer's
    decode, a rank's part (its head's q, its slots' partial, the merge of
    the 16 partials, its head's wuv and wo; the median and the largest)."""
    import torch

    configs, layers = tr["configs"], tr["layers"]
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.models.param_defs import init_values

    t_phase = time.perf_counter()
    cfg = configs.get_config("deepseek-v2-lite-16b")
    s = next(b.mla for g in cfg.groups for b in g.blocks if b.kind == "mla")
    M, B, T = MLA_CP_M, MLA_CP_BATCH, MLA_CP_SLOTS
    H, Tl = s.n_heads, T // M
    Hl = H // M
    _require(H % M == 0 and T % M == 0, f"mla_cp: {H} heads, {T} slots over {M}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_values(layers.init_mla(s), gen, "cuda")
    x = torch.randn((B, 1, s.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    cache = {"latent": torch.randn((B, T, s.kv_lora), generator=gen, device="cuda"),
             "k_rope": torch.randn((B, T, s.qk_rope), generator=gen, device="cuda")}
    cache = {k: v.to(torch.bfloat16) for k, v in cache.items()}
    pos = torch.tensor(T - 1, dtype=torch.int32, device="cuda")
    heads = ("wq", "wuk", "wuv")

    def rank_slices(r):
        out = dict(p, wo=p["wo"][r * Hl:(r + 1) * Hl].contiguous())
        out.update({k: p[k][:, r * Hl:(r + 1) * Hl].contiguous() for k in heads})
        return out

    slices = [rank_slices(r) for r in range(M)]
    with torch.no_grad():
        whole = {k: v.clone() for k, v in cache.items()}
        want, _ = layers.decode_mla(p, s, x, whole, pos)
        # every rank's q over its head, gathered (here: concatenated in rank order)
        qs = [layers.mla_decode_inputs(slices[r], s, x, pos) for r in range(M)]
        q_lat = torch.cat([q[0] for q in qs], dim=2)
        q_rope = torch.cat([q[1] for q in qs], dim=2)
        latent_new, k_rope_new = qs[0][2], qs[0][3]
        for k, new in (("latent", latent_new), ("k_rope", k_rope_new)):
            cache[k][:, T - 1] = new[:, 0].to(cache[k].dtype)
            _require(torch.equal(cache[k], whole[k]), f"mla_cp: the token's {k} differs")
        parts = [layers.mla_partial(s, q_lat, q_rope, cache["latent"][:, r * Tl:(r + 1) * Tl],
                                    cache["k_rope"][:, r * Tl:(r + 1) * Tl], pos, r * Tl)
                 for r in range(M)]
        outs = torch.stack([o for o, _ in parts])
        lses = torch.stack([lse for _, lse in parts])
        merged = decode_ops.merge_partials(outs, lses, x.dtype)
        total = torch.zeros((B, 1, s.d_model), dtype=torch.float32, device="cuda")
        for r in range(M):
            total += layers.mla_heads_out(slices[r],
                                          merged[:, None, r * Hl:(r + 1) * Hl]).float()
        got = total.to(torch.bfloat16)

        def rank_part(r):
            ql, qr, _, _ = layers.mla_decode_inputs(slices[r], s, x, pos)
            layers.mla_partial(s, q_lat, q_rope, cache["latent"][:, r * Tl:(r + 1) * Tl],
                               cache["k_rope"][:, r * Tl:(r + 1) * Tl], pos, r * Tl)
            m = decode_ops.merge_partials(outs, lses, x.dtype)
            return layers.mla_heads_out(slices[r], m[:, None, r * Hl:(r + 1) * Hl])

        times = _rank_times(lambda: layers.decode_mla(p, s, x, whole, pos),
                            [lambda r=r: rank_part(r) for r in range(M)])
    out = {"phase": "mla_cp", "arch": "deepseek-v2-lite-16b", "model_axis": M,
           "batch": B, "slots": T, "slots_a_rank": Tl, "heads_a_rank": Hl, "pos": T - 1,
           "kv_lora": s.kv_lora, **_row_ulp_gap(got, want), **times,
           "tolerance": {"row_ulps": MLA_CP_ROW_ULPS,
                         "of": "the token row's largest |output|", "plus": 1e-5},
           "phase_s": time.perf_counter() - t_phase}
    _emit(out)
    _require(out["max_err_in_row_ulps"] <= MLA_CP_ROW_ULPS,
             f"mla_cp: the 16 rank parts against decode_mla: {out}")
    return out


def _redraw(p, names, gen, scale, shift=0.0):
    """Leaves ``names`` of ``p`` drawn anew (normal, ``scale``, ``shift``)."""
    import torch

    for k in names:
        p[k] = (torch.randn(p[k].shape, generator=gen, device="cuda") * scale
                + shift).to(p[k].dtype)


@contextmanager
def _recorded_scans(S, seen):
    """The scan wrapper's calls from ``ssm`` recorded into ``seen`` (its
    arguments and outputs), the wrapper itself (and its count) untouched."""
    ops = S.scan_ops

    def recorded(*args):
        res = ops.rwkv6_scan(*args)
        seen.append((args, res))
        return res

    S.scan_ops = types.SimpleNamespace(rwkv6_scan=recorded)
    try:
        yield
    finally:
        S.scan_ops = ops


def phase_ssm_tp(tr, sops, sref):
    """The recurrent blocks at full width over the production model axis,
    rank by rank (``SSM_TP_*``): rwkv6-7b's time and channel mix and
    zamba2-1.2b's Mamba2 layer (prefill and one decode step), the 16 rank
    parts combined as the collectives combine them (the norm's float32
    squares summed; the time mix's columns concatenated; the row-parallel
    parts, each rounded to bf16 by its product, summed in float32 in rank
    order and cast once, as the mesh path's float32 reduce-scatter and
    all-reduce do), against the
    model-axis-1 layer on the same weights and tokens. Each rank's scan
    launch held to the plain chunked scan; the scan kernel at the rank's
    shape timed beside its bound and the plain version. Times (CUDA
    events): the whole layer, each rank's part, their ratio. ``launches``:
    the scan wrapper's count over the rank parts (the layers' own launches
    apart)."""
    import torch

    S, configs = tr["ssm"], tr["configs"]
    from repro_torch.models.param_defs import init_values
    from repro_torch.models.sharding_hooks import TP

    t_phase = time.perf_counter()
    M, (B, T) = SSM_TP_M, SSM_TP_TOKENS
    bf16 = torch.bfloat16
    out = {"phase": "ssm_tp", "model_axis": M, "tokens": [B, T], "cases": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)

    # rwkv6-7b: the time mix, 4 of its 64 heads a rank
    cfg = configs.get_config("rwkv6-7b")
    tm, cm = cfg.groups[0].blocks
    s, D = tm.rwkv, cfg.d_model
    Dl, Hl = D // M, s.n_heads // M
    p = init_values(S.init_rwkv6_time(s), gen, "cuda")
    _redraw(p, [f"mu_{n}" for n in "rkvwg"], gen, 0.3, 0.5)
    _redraw(p, ["u", "w0"], gen, 0.5)
    x = torch.randn((B, T, D), generator=gen, device="cuda").to(bf16)
    xs = S._token_shift(x)

    def rank_params(r):
        cols = slice(r * Dl, (r + 1) * Dl)
        local = dict(p, **{k: p[k][:, cols].contiguous() for k in ("wr", "wk", "wv", "wg", "w2")},
                     wo=p["wo"][cols].contiguous())
        return S.rwkv6_rank_params(local, TP(None, M, r))

    ranks = [rank_params(r) for r in range(M)]
    with torch.no_grad():
        want, want_final, _ = S.apply_rwkv6_time(p, s, x)
        before = sops.rwkv6_scan.LAUNCHES
        parts, scan_worst, scan_ok, seen = [], [0.0, 0.0], True, []
        with _recorded_scans(S, seen):
            for pr in ranks:
                parts.append(S.rwkv6_time_heads(pr, s, x, xs))
                # this rank's launch against the plain chunked scan on its inputs
                (r_, k_, v_, logw, u, chunk, init), (y, st) = seen[-1]
                plain, plain_s = sref.rwkv6_chunked(r_, k_, v_, logw, u, chunk, init)
                d_abs, d_rel, ok = _scan_gap(y, st, plain, plain_s)
                scan_ok &= ok
                scan_worst = [max(scan_worst[0], d_abs), max(scan_worst[1], d_rel)]
                del plain, plain_s
        launches = sops.rwkv6_scan.LAUNCHES - before
        ss = sum(S.sum_squares(yg) for yg, _ in parts)  # float32, rank order
        got = torch.cat([S.rwkv6_time_out(pr, yg, ss, D) for pr, (yg, _) in zip(ranks, parts)],
                        dim=-1)
        finals = torch.cat([f for _, f in parts], dim=1)
        state_gap = ((finals - want_final).abs().max()
                     / want_final.abs().max().clamp_min(1.0)).item()
        times = _rank_times(lambda: S.apply_rwkv6_time(p, s, x),
                            [lambda pr=pr: S.rwkv6_time_out(pr, S.rwkv6_time_heads(pr, s, x, xs)[0],
                                                            ss, D) for pr in ranks])
        # the scan kernel at the rank's shape, rank 0's inputs
        heads, u = seen[0][0][:4], seen[0][0][4]
        del seen
        n = B * T * Hl * s.head_dim
        scan = {"shape": [B, T, Hl, s.head_dim],
                **_device_ms(lambda: sops.rwkv6_scan(*heads, u, 16), 5, 3),
                "plain_ms": _time_ms(lambda: sref.rwkv6_chunked(*heads, u, 16), iters=2,
                                     warmup=1),
                "plain": "ref.rwkv6_chunked, chunks of 16 (the CPU path)",
                "library_ms": None,
                "library": "none: no single PyTorch call computes the RWKV6 recurrence",
                **_bound(4 * n * 2 + n * 4 + Hl * s.head_dim * 4 + B * Hl * s.head_dim ** 2 * 4,
                         B * T * Hl * (5 * s.head_dim ** 2 + 5 * s.head_dim)),
                "launches": launches, "max_abs_err": scan_worst[0],
                "max_err_over_scale": scan_worst[1], "all_within_tolerance": scan_ok}
        scan["share_of_bound"] = scan["bound_ms"] / scan["ms"]
    out["cases"]["rwkv6_time"] = {"heads_a_rank": Hl, "columns_a_rank": Dl,
                                  **_row_ulp_gap(got, want), "state_over_scale": state_gap,
                                  **times}
    out["scan_kernel"] = scan
    del parts, got, want, want_final, finals, ranks, p, heads
    torch.cuda.empty_cache()

    # rwkv6-7b: the channel mix, 896 of its 14,336 columns a rank
    F_ = cm.rwkv_ffn
    Fl = F_ // M
    p = init_values(S.init_rwkv6_channel(cm.rwkv, F_), gen, "cuda")
    _redraw(p, ["mu_k", "mu_r"], gen, 0.3, 0.5)
    slices = [dict(p, wk=p["wk"][:, r * Fl:(r + 1) * Fl].contiguous(),
                   wv=p["wv"][r * Fl:(r + 1) * Fl].contiguous()) for r in range(M)]
    with torch.no_grad():
        want, _ = S.apply_rwkv6_channel(p, x)
        kv = torch.zeros((B, T, D), dtype=torch.float32, device="cuda")
        for pr in slices:  # apply_rwkv6_channel_tp's float32 reduce-scatter
            kv += S.rwkv6_channel_part(pr, x, xs).float()
        got = S.rwkv6_channel_gate(p, x, xs, kv.to(bf16))
        times = _rank_times(lambda: S.apply_rwkv6_channel(p, x),
                            [lambda pr=pr: S.rwkv6_channel_part(pr, x, xs) for pr in slices])
    out["cases"]["rwkv6_channel"] = {"columns_a_rank": Fl, **_row_ulp_gap(got, want), **times}
    del slices, p, kv, got, want, x, xs
    torch.cuda.empty_cache()

    # zamba2-1.2b: one Mamba2 layer, 4 of its 64 heads a rank, prefill and decode
    cfg = configs.get_config("zamba2-1.2b")
    s = cfg.groups[0].blocks[0].mamba
    di, P = s.d_inner, s.head_dim
    Hl = s.n_heads // M
    p = init_values(S.init_mamba2(s), gen, "cuda")
    _redraw(p, ["A_log", "D", "dt_bias"], gen, 0.5)
    x = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda").to(bf16)
    tok = torch.randn((B, 1, cfg.d_model), generator=gen, device="cuda").to(bf16)

    def cols(r):
        return slice(r * Hl * P, (r + 1) * Hl * P)

    with torch.no_grad():
        want, final, xBC_in = S.prefill_mamba2(p, s, x)
        gs = [S.mamba2_heads(p, s, x, r * Hl, Hl)[0] for r in range(M)]
        ss = sum(S.sum_squares(g) for g in gs)
        total = torch.zeros_like(want, dtype=torch.float32)
        for r, g in enumerate(gs):
            total += S.mamba2_norm_out(p["norm"]["scale"][cols(r)], p["w_out"][cols(r)], g, ss,
                                       di, bf16).float()
        got = total.to(bf16)
        prefill = _row_ulp_gap(got, want)
        times = _rank_times(lambda: S.prefill_mamba2(p, s, x), [
            lambda r=r: S.mamba2_norm_out(p["norm"]["scale"][cols(r)], p["w_out"][cols(r)],
                                          S.mamba2_heads(p, s, x, r * Hl, Hl)[0], ss, di, bf16)
            for r in range(M)])
        del gs, total, got, want
        # one decode step from the layer's caches: each rank its heads' state
        tail = S.mamba2_conv_tail(s, xBC_in)
        cache = {"conv": tail.clone(), "ssm": final.float()}
        want_d, _ = S.decode_mamba2(p, s, tok, cache, None)
        proj = tok @ p["w_in"]
        caches = [{"conv": tail.clone(), "ssm": final[:, r * Hl:(r + 1) * Hl].float()}
                  for r in range(M)]
        gs = [S.decode_mamba2_heads(p, s, proj, c, r * Hl, Hl) for r, c in enumerate(caches)]
        ss = sum(S.sum_squares(g) for g in gs)
        total = torch.zeros_like(want_d, dtype=torch.float32)
        for r, g in enumerate(gs):
            total += S.mamba2_norm_out(p["norm"]["scale"][cols(r)], p["w_out"][cols(r)], g, ss,
                                       di, bf16).float()
        decode = _row_ulp_gap(total.to(bf16), want_d)
        states = torch.cat([c["ssm"] for c in caches], dim=1)
        decode["state_over_scale"] = ((states - cache["ssm"]).abs().max()
                                      / cache["ssm"].abs().max().clamp_min(1.0)).item()
        decode["conv_history_equal"] = all(torch.equal(c["conv"], cache["conv"]) for c in caches)
    out["cases"]["mamba2_prefill"] = {"heads_a_rank": Hl, **prefill, **times}
    out["cases"]["mamba2_decode"] = {"heads_a_rank": Hl, **decode}
    out["tolerance"] = {"row_ulps": SSM_TP_ROW_ULPS, "of": "the token row's largest |output|",
                        "plus": 1e-5, "scan": f"{SCAN_TOL} of the scale (+ one bf16 ulp)",
                        "states": f"{SSM_TP_STATE_TOL} of the state's scale"}
    out["phase_s"] = time.perf_counter() - t_phase
    _emit(out)
    for name, c in out["cases"].items():
        _require(c["max_err_in_row_ulps"] <= SSM_TP_ROW_ULPS,
                 f"ssm_tp: {name}'s 16 rank parts against the layer: {c}")
    _require(out["cases"]["mamba2_decode"]["conv_history_equal"],
             "ssm_tp: a rank's convolution history differs from the layer's")
    for name in ("rwkv6_time", "mamba2_decode"):
        _require(out["cases"][name]["state_over_scale"] <= SSM_TP_STATE_TOL,
                 f"ssm_tp: {name}'s states of the ranks' heads against the layer's")
    _require(scan["all_within_tolerance"] and scan["launches"] == M,
             f"ssm_tp: the scan kernel on the ranks' heads: {scan}")
    return out


def _partial_vs_plain(dops, dref, q, k, v, pos, slot0, got):
    """A slice's kernel partial (``got``: out, lse) against the plain
    partial on its inputs: an empty slice 0 and -inf exactly, else (the
    output's gap over its scale, the lse's absolute gap)."""
    import torch

    po, plse = dref.decode_partial_ref(q, k, v, pos, slot0)
    o, lse = got
    if bool(torch.isneginf(plse).all()):
        _require(torch.equal(o, po) and bool(torch.isneginf(lse).all()),
                 "an empty slice is not 0 and -inf")
        return 0.0, 0.0
    return ((o - po).abs().max() / po.abs().max()).item(), (lse - plse).abs().max().item()


def phase_whisper_tp(tr, dops, dref, fops):
    """whisper-base at full width over the production model axis, rank by
    rank (``WHISPER_TP``), its weights drawn from the seed as
    ``build_model`` draws them (bf16), its layers' weight matrices scaled
    as ``lm_agree``'s bf16 leg scales them (``_unit_gain``: at the
    reference's init the softmax is all but one-hot and one bf16 rounding
    moves the logits by half their scale; without it the rank parts' sums
    put the prefill's logits 175 row ulps from the model's on an H100),
    against the model-axis-1 model on the same weights and inputs
    (``encode``, ``prefill``, ``decode_step``).

    At 16 ranks the layout of ``models/whisper.py``'s mesh path: 1,500
    frames and a 4-token prompt do not split (every rank runs every row),
    8 heads and the 51,865-row table do not divide (attention and logits
    whole on every rank), d_ff does (each rank's 128 columns and rows: its
    part ``layers.apply_mlp`` of its slices, the 16 parts summed in float32
    in rank order and cast once, as ``sharding_hooks.reduce_parts`` sums them); the
    self cache of 144 slots is split 9 a rank (each rank's slice written
    where it owns the token's slot, ``layers._owned_slot`` and
    ``_write_owned``, and its partial through the decode kernel's partial
    form, the 16 merged by ``merge_partials``), the 1,500 frames' ek, ev
    whole. Slots 4-143 of every layer's self cache hold values drawn from
    the seed (those past pos 100 hidden).

    Checks: each layer of the encoder, the prompt's prefill and the decode
    step, from the model's own input to it, within WHISPER_TP_ROW_ULPS bf16
    ulps of each row's largest (``blockwise``); the rank parts end to end
    (the encoder output, the prefill's and the decode step's logits)
    within WHISPER_TP_ROW_ULPS for each layer they cross (the parts' sums
    round apart from one product in every layer, and the roundings carry);
    the ranks' self-cache slices, whole again, the model's bit for bit;
    every rank's partial launch against the plain partial; the launches of
    each form; one rank's partial timed beside its bound and SDPA."""
    import torch

    configs, L = tr["configs"], tr["layers"]
    from repro_torch.models import whisper as W
    from repro_torch.models.sharding_hooks import TP

    t_phase = time.perf_counter()
    c = WHISPER_TP
    M, B, S_enc, P, T, p_dec = c["M"], c["batch"], c["frames"], c["prompt"], c["slots"], c["pos"]
    Tl = T // M
    cfg = configs.get_config(c["arch"])
    model = configs.build_model(cfg, device="cuda", seed=c["seed"])
    _unit_gain(model)
    layouts = (W.cache_layout(T, cfg.kv_heads, M), W.cache_layout(S_enc, cfg.kv_heads, M))
    _require(layouts == ("slots", "whole") and cfg.d_ff % M == 0 and cfg.n_heads % M
             and cfg.vocab % M, f"whisper_tp: the layout at {M} ranks is {layouts}")
    bf16 = model.dtype
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    frames = torch.randn((B, S_enc, cfg.d_model), generator=gen, device="cuda").to(bf16)
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=gen, device="cuda")
    token = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda")
    fill = [torch.randn((2, B, T - P, cfg.kv_heads, cfg.head_dim), generator=gen,
                        device="cuda").to(bf16) for _ in model.dec]
    pos = torch.tensor(p_dec, dtype=torch.int32, device="cuda")
    Fl = cfg.d_ff // M
    enc_spec, dec_spec, mlp = W._attn_spec(cfg, False), W._attn_spec(cfg, True), W._mlp_spec(cfg)

    def mlp_slices(p):
        return [{"wg": p["wg"][:, r * Fl:(r + 1) * Fl].contiguous(),
                 "wu": p["wu"][:, r * Fl:(r + 1) * Fl].contiguous(),
                 "wd": p["wd"][r * Fl:(r + 1) * Fl].contiguous()} for r in range(M)]

    enc_mlp = [mlp_slices(p["mlp"]) for p in model.enc]
    dec_mlp = [mlp_slices(p["mlp"]) for p in model.dec]

    def mlp_out(p, sl, h):
        """The model's MLP (``sl`` None) or the ranks' parts summed."""
        if sl is None:
            return L.apply_mlp(p["mlp"], mlp, h)
        total = torch.zeros(h.shape[:-1] + (cfg.d_model,), dtype=torch.float32, device="cuda")
        for pr in sl:
            total += L.apply_mlp(pr, mlp, h).float()
        return total.to(h.dtype)

    def enc_layer(p, sl, x):
        h = L.layer_norm(p["ln1"], x).to(bf16)
        x = x + L.prefill_attention_whole(p["attn"], enc_spec, h, None)[0]
        return x + mlp_out(p, sl, L.layer_norm(p["ln2"], x).to(bf16))

    def dec_layer(p, sl, x, enc):
        h = L.layer_norm(p["ln1"], x)
        y, k, v = L.prefill_attention_whole(p["self_attn"], dec_spec, h, None)
        x = x + y
        ek, ev = L.cross_kv(p["cross_attn"], dec_spec, enc)
        x = x + L.cross_attention(p["cross_attn"], dec_spec, L.layer_norm(p["ln2"], x), ek, ev)
        return x + mlp_out(p, sl, L.layer_norm(p["ln3"], x)), (k, v, ek, ev)

    worst = [0.0, 0.0]

    def step_layer(p, sl, x, ranks, ek, ev, enc_last):
        """The decode step's layer on the ranks' self-cache slices."""
        h = L.layer_norm(p["ln1"], x)
        ps = p["self_attn"]
        q, k_new, v_new = L._proj_qkv(ps, dec_spec, h)
        parts = []
        for r in range(M):
            slot, own = L._owned_slot(pos, Tl, TP(None, M, r), ring=False)
            L._write_owned(ranks["k"][r], slot, own, k_new)
            L._write_owned(ranks["v"][r], slot, own, v_new)
            kr, vr = ranks["k"][r].transpose(1, 2), ranks["v"][r].transpose(1, 2)
            parts.append(dops.decode(q[:, 0], kr, vr, pos, slot0=r * Tl, return_lse=True))
            d_o, d_l = _partial_vs_plain(dops, dref, q[:, 0], kr, vr, pos, r * Tl, parts[-1])
            worst[0], worst[1] = max(worst[0], d_o), max(worst[1], d_l)
        merged = dops.merge_partials(torch.stack([o for o, _ in parts]),
                                     torch.stack([lse for _, lse in parts]), q.dtype)
        x = x + L._out_proj(merged[:, None], ps["wo"])
        x = x + L.decode_cross_attention(p["cross_attn"], dec_spec, L.layer_norm(p["ln2"], x),
                                         ek, ev, enc_last)
        return x + mlp_out(p, sl, L.layer_norm(p["ln3"], x))

    def rank_slices(kv):
        """Each rank's 9 slots of a whole self cache (B, T, KV, hd) pair."""
        return {n: [t[:, r * Tl:(r + 1) * Tl].clone() for r in range(M)]
                for n, t in zip(("k", "v"), kv)}

    blockwise = collections.defaultdict(float)

    def block(name, got, want):
        blockwise[name] = max(blockwise[name], _row_ulp_gap(got, want)["max_err_in_row_ulps"])

    out = {"phase": "whisper_tp", "arch": cfg.name, "model_axis": M, "batch": B,
           "frames": S_enc, "prompt": P, "self_slots": T, "slots_a_rank": Tl, "pos": p_dec,
           "layouts": {"self_cache": layouts[0], "cross_cache": layouts[1],
                       "encoder_rows": "whole", "prompt_rows": "whole", "heads": "whole",
                       "ffn": f"{Fl} a rank", "vocab": "whole"}}
    with torch.no_grad():
        # the model-axis-1 model through its entry points
        want_enc = model.encode(frames)
        want_pre, cache = model.prefill({"tokens": tokens, "enc_embeds": frames,
                                         "cache_len": T})
        for e, f in zip(cache["dec"], fill):
            e["k"][:, P:], e["v"][:, P:] = f[0], f[1]
        blocks = [rank_slices((e["k"], e["v"])) for e in cache["dec"]]

        # the encoder: every layer from the model's input, and the parts' chain
        before = {"flash": fops.attention.LAUNCHES}
        x0 = frames + W._sinusoid_on(S_enc, cfg.d_model, frames.device, bf16)
        xw, xp = x0, x0
        for p, sl in zip(model.enc, enc_mlp):
            yw = enc_layer(p, None, xw)
            block("encoder_layer", enc_layer(p, sl, xw), yw)
            xw, xp = yw, enc_layer(p, sl, xp)
        enc_w, enc_p = L.layer_norm(model.enc_ln, xw), L.layer_norm(model.enc_ln, xp)
        # the prompt's prefill, every row on every rank; the cross keys whole
        x0 = L.embed(model.embed, tokens) + model.pos_dec[:P].to(torch.bfloat16)
        xw, xp, kept = x0, x0, []
        for p, sl in zip(model.dec, dec_mlp):
            yw, _ = dec_layer(p, None, xw, enc_w)
            block("prefill_decoder_layer", dec_layer(p, sl, xw, enc_w)[0], yw)
            xw, (xp, kv) = yw, dec_layer(p, sl, xp, enc_p)
            kept.append(kv)
        got_pre = model._logits(xp[:, -1:])
        # the model's chain is its entry points' arithmetic, bit for bit
        chain_is_model = torch.equal(enc_w, want_enc) and torch.equal(
            model._logits(xw[:, -1:]), want_pre)
        prefill_launches = {"flash_attention": fops.attention.LAUNCHES - before["flash"]}
        # the ranks' caches of their own prefill: the self slices and ek, ev
        parts_cache = []
        for (k, v, ek, ev), f in zip(kept, fill):
            kc = torch.cat([k, f[0]], dim=1)
            vc = torch.cat([v, f[1]], dim=1)
            parts_cache.append((rank_slices((kc, vc)), ek, ev))
        # one decode step at pos: each layer from the model's input (the
        # model's cache and the ranks' slices of it written alike), and the
        # parts' chain on their own caches
        dops.decode.PARTIAL_LAUNCHES = 0
        before["decode"] = dops.decode.LAUNCHES
        x0 = L.embed(model.embed, token) + model.pos_dec.index_select(
            0, pos.reshape(1).long()).to(torch.bfloat16)
        xw, xp = x0, x0
        for p, sl, e, ranks, (ranks_p, ek, ev) in zip(model.dec, dec_mlp, cache["dec"], blocks,
                                                       parts_cache):
            got = step_layer(p, sl, xw, ranks, e["ek"], e["ev"], cache["enc_last"])
            yw = model.dec_block_decode(p, xw, e, pos, cache["enc_last"])
            block("decode_layer", got, yw)
            xw, xp = yw, step_layer(p, sl, xp, ranks_p, ek, ev, cache["enc_last"])
        want_dec = model._logits(xw)
        got_dec = model._logits(xp)
        torch.cuda.synchronize()
        decode_launches = {"decode_attention_partial": dops.decode.PARTIAL_LAUNCHES,
                           "decode_attention": dops.decode.LAUNCHES - before["decode"]}
        same_cache = all(torch.equal(torch.cat(ranks[n], dim=1), e[n])
                         for ranks, e in zip(blocks, cache["dec"]) for n in ("k", "v"))
        # one rank's partial at the decode's shape, every slot valid: the last
        # of 16 slices of layer 0's cache at pos 143
        k0 = torch.cat(blocks[0]["k"], dim=1).transpose(1, 2)
        v0 = torch.cat(blocks[0]["v"], dim=1).transpose(1, 2)
        q0 = L._proj_qkv(model.dec[0]["self_attn"], dec_spec,
                         L.layer_norm(model.dec[0]["ln1"], x0))[0][:, 0]
        timing = _tp_partial_timing(dops, dref, q0, k0, v0, T - 1, M)
        timing["launches"] = decode_launches["decode_attention_partial"]
    layers_crossed = {"encoder_output": cfg.enc_layers,
                      "prefill_logits": cfg.enc_layers + cfg.dec_layers,
                      "decode_logits": cfg.enc_layers + 2 * cfg.dec_layers}
    end_to_end = {"encoder_output": _row_ulp_gap(enc_p, want_enc),
                  "prefill_logits": _row_ulp_gap(got_pre, want_pre),
                  "decode_logits": _row_ulp_gap(got_dec, want_dec)}
    out.update(blockwise=dict(blockwise), end_to_end=end_to_end, layers_crossed=layers_crossed,
               chain_is_the_model=chain_is_model, self_cache_slices_bitwise=same_cache,
               partial_vs_plain={"out_of_scale": worst[0], "lse_abs": worst[1]},
               launches_by_form={**prefill_launches, **decode_launches},
               decode_attention_partial=timing,
               tolerance={"blockwise_row_ulps": WHISPER_TP_ROW_ULPS,
                          "end_to_end_row_ulps": f"{WHISPER_TP_ROW_ULPS} a layer crossed",
                          "of": "each row's largest |value|", "plus": 1e-5,
                          "partial": f"{ATTN_F32_TOL} of the scale; lse {ATTN_F32_TOL}"},
               phase_s=time.perf_counter() - t_phase)
    _emit(out)
    for name, gap in blockwise.items():
        _require(gap <= WHISPER_TP_ROW_ULPS,
                 f"whisper_tp: a {name} of the 16 rank parts against the model's: {gap}")
    for name, ch in end_to_end.items():
        _require(ch["max_err_in_row_ulps"] <= WHISPER_TP_ROW_ULPS * layers_crossed[name],
                 f"whisper_tp: {name} of the 16 rank parts against the model: {ch}")
    _require(chain_is_model, "whisper_tp: the model's chain is not its encode and prefill")
    _require(same_cache, "whisper_tp: the ranks' self-cache slices differ from the model's")
    _require(worst[0] <= ATTN_F32_TOL and worst[1] <= ATTN_F32_TOL,
             f"whisper_tp: a rank's partial against the plain partial: {worst}")
    # three passes a layer (the model's, the parts from its input, the
    # parts' chain); the model's decode layer attends its whole self and
    # cross caches, the parts' layers their cross caches
    want_launches = {"flash_attention": 3 * (cfg.enc_layers + 2 * cfg.dec_layers),
                     "decode_attention_partial": 2 * M * cfg.dec_layers,
                     "decode_attention": 4 * cfg.dec_layers}
    _require(out["launches_by_form"] == want_launches,
             f"whisper_tp: launches {out['launches_by_form']}, expected {want_launches}")
    del model, cache, blocks, parts_cache, kept, enc_mlp, dec_mlp, frames, fill
    torch.cuda.empty_cache()
    return out


@contextmanager
def _recorded_attention(L, calls):
    """The attention kernels' wrappers, as ``layers`` calls them, recorded
    into ``calls`` ((kind, q, k, v, out) of every call), the wrappers
    themselves (and their counts) untouched."""
    fl, dl = L.flash_ops, L.decode_ops

    def flash(q, k, v, **kw):
        out = fl.attention(q, k, v, **kw)
        calls.append(("flash", q, k, v, out))
        return out

    def decode(q, k, v, pos, **kw):
        out = dl.decode(q, k, v, pos, **kw)
        calls.append(("decode", q, k, v, out))
        return out

    L.flash_ops = types.SimpleNamespace(attention=flash)
    L.decode_ops = types.SimpleNamespace(decode=decode, merge_partials=dl.merge_partials)
    try:
        yield
    finally:
        L.flash_ops, L.decode_ops = fl, dl


def _sum_parts(parts):
    """The ranks' bf16 parts summed in float32 in rank order, cast once."""
    import torch

    total = torch.zeros(parts[0].shape, dtype=torch.float32, device=parts[0].device)
    for y in parts:
        total += y.float()
    return total.to(parts[0].dtype)


def phase_tp_whole(tr, dops, dref, fops, fref):
    """A prompt and a cache that do not divide the production model axis,
    rank by rank at full width (``TP_WHOLE``, ``TP_WHOLE_STRADDLE``): the
    functions each rank of a mesh runs (``layers._prefill_attention_tp``,
    ``layers.apply_mlp`` on its ffn columns, ``layers.decode_attention_local``
    on its heads over the whole cache, ``layers._whole_cache_heads`` where
    they straddle kv heads), their collectives outside (the parts summed
    here), against the model-axis-1 layer on the same weights and inputs
    (``prefill_attention_whole``, ``apply_mlp``, ``decode_attention_local``).
    Checks: every rank's kernel calls against the plain versions; the rank
    parts summed within TP_WHOLE_ROW_ULPS row ulps of the layer; the k and v
    every rank computes, and the whole cache every rank writes, the layer's
    bit for bit; the launches of each form. Times: each layer and its rank
    parts (``_rank_times``), and one rank's flash and decode calls beside
    their bounds and SDPA."""
    import torch

    configs, L = tr["configs"], tr["layers"]
    from repro_torch.models.param_defs import init_values
    from repro_torch.models.sharding_hooks import TP, cache_layout

    t_phase = time.perf_counter()
    c = TP_WHOLE
    M, B, P, T = c["M"], c["batch"], c["prompt"], c["slots"]
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    pos = torch.tensor(P, dtype=torch.int32, device="cuda")
    positions = torch.arange(P, device="cuda")[None].expand(B, P)

    def layer_specs(arch):
        blocks = configs.get_config(arch).groups[0].blocks
        return (next(b.attn for b in blocks if b.kind == "attn"),
                next(b.mlp for b in blocks if b.kind == "mlp"))

    def heads_of(p, r, Hl):
        return dict(p, wq=p["wq"][:, r * Hl:(r + 1) * Hl].contiguous(),
                    wo=p["wo"][r * Hl:(r + 1) * Hl].contiguous())

    s, ms = layer_specs(c["arch"])
    Hl, Fl, n_rep = s.n_heads // M, ms.d_ff // M, s.n_heads // s.kv_heads
    _require(P % M and T % M and s.n_heads % M == 0 and s.kv_heads % M and ms.d_ff % M == 0
             and cache_layout(T, s.kv_heads, M) == "whole",
             f"tp_whole: {c['arch']} at {M} ranks does not take the whole layout")
    p = init_values(L.init_attention(s), gen, "cuda")
    pm = init_values(L.init_mlp(ms), gen, "cuda")
    x = torch.randn((B, P, s.d_model), generator=gen, device="cuda").to(bf16)
    tok = torch.randn((B, 1, s.d_model), generator=gen, device="cuda").to(bf16)
    ranks = [heads_of(p, r, Hl) for r in range(M)]
    ffn = [{"wg": pm["wg"][:, r * Fl:(r + 1) * Fl].contiguous(),
            "wu": pm["wu"][:, r * Fl:(r + 1) * Fl].contiguous(),
            "wd": pm["wd"][r * Fl:(r + 1) * Fl].contiguous()} for r in range(M)]
    out = {"phase": "tp_whole", "arch": c["arch"], "model_axis": M, "batch": B, "prompt": P,
           "slots": T, "pos": P, "layouts": {"prompt_rows": "whole", "cache": "whole",
                                            "heads": f"{Hl} a rank", "kv_heads": "whole",
                                            "ffn": f"{Fl} a rank"}}
    blockwise, launches, checks = {}, {}, {"flash": [], "decode": []}

    def check_calls(calls, what):
        """Every recorded kernel call against its plain version."""
        for kind, q, k, v, got in calls:
            if kind == "flash":
                res = _flash_bf16_check(got, q, k, v, True, fref, what, tiled=False)
                checks["flash"].append(max(r[1] for r in res.values()))
            else:
                want = dref.decode_ref(q, k, v, pos)
                checks["decode"].append(_attn_check(got, want, bf16, what))

    with torch.no_grad():
        # the prefill's attention layer: each rank's head over every row
        want, k, v = L.prefill_attention_whole(p, s, x, positions)
        calls = []
        n0 = fops.attention.LAUNCHES
        with _recorded_attention(L, calls):
            parts = [L._prefill_attention_tp(ranks[r], s, x, positions, TP(None, M, r))
                     for r in range(M)]
        launches["flash_attention_rank_head"] = fops.attention.LAUNCHES - n0
        kv_whole = all(torch.equal(kr, k) and torch.equal(vr, v) for _, kr, vr in parts)
        blockwise["attention_prefill"] = _row_ulp_gap(_sum_parts([y for y, _, _ in parts]), want)
        check_calls(calls, "tp_whole flash")
        flash_rank = _flash_times(fops, fref, *calls[0][1:4])
        attn_times = _rank_times(
            lambda: L.prefill_attention_whole(p, s, x, positions),
            [lambda r=r: L._prefill_attention_tp(ranks[r], s, x, positions, TP(None, M, r))
             for r in range(M)])
        del parts, calls
        # the MLP layer: each rank's ffn columns, then rows, of every row
        want_m = L.apply_mlp(pm, ms, x)
        blockwise["mlp"] = _row_ulp_gap(_sum_parts([L.apply_mlp(f, ms, x) for f in ffn]), want_m)
        mlp_times = _rank_times(lambda: L.apply_mlp(pm, ms, x),
                                [lambda f=f: L.apply_mlp(f, ms, x) for f in ffn])
        del want_m
        # one decode step at pos P on the whole cache of T slots, which every
        # rank holds and writes alike (the token's k and v of whole weights)
        kc = torch.zeros((B, T) + tuple(k.shape[2:]), dtype=bf16, device="cuda")
        vc = torch.zeros_like(kc)
        kc[:, :P], vc[:, :P] = k, v
        whole = {"k": kc.clone(), "v": vc.clone()}
        held = {"k": kc, "v": vc}
        want_d, _ = L.decode_attention_local(p, s, tok, whole, pos)
        calls = []
        n0 = dops.decode.LAUNCHES
        with _recorded_attention(L, calls):
            parts = [L.decode_attention_local(ranks[r], s, tok, held, pos, TP(None, M, r))[0]
                     for r in range(M)]
        launches["decode_attention_one_kv_head"] = dops.decode.LAUNCHES - n0
        same_cache = torch.equal(held["k"], whole["k"]) and torch.equal(held["v"], whole["v"])
        views = all(cl[2].untyped_storage().data_ptr() == kc.untyped_storage().data_ptr()
                    for cl in calls)
        blockwise["attention_decode"] = _row_ulp_gap(_sum_parts(parts), want_d)
        check_calls(calls, "tp_whole decode")
        decode_one = _decode_times(dops, dref, *calls[0][1:4], P)
        decode_times = _rank_times(
            lambda: L.decode_attention_local(p, s, tok, whole, pos),
            [lambda r=r: L.decode_attention_local(ranks[r], s, tok, held, pos, TP(None, M, r))
             for r in range(M)])
        del parts, calls, whole, held, kc, vc, k, v, want, x, p, pm, ranks, ffn
        torch.cuda.empty_cache()

        # phi4-mini-3.8b at M2: 2 query heads a rank over a whole cache
        c2 = TP_WHOLE_STRADDLE
        M2 = c2["M"]
        s2, _ = layer_specs(c2["arch"])
        Hl2, rep2 = s2.n_heads // M2, s2.n_heads // s2.kv_heads
        groups = [L.whole_cache_groups(r * Hl2, Hl2, rep2) for r in range(M2)]
        straddle = [r for r, g in enumerate(groups) if len(g) > 1]
        _require(s2.n_heads % M2 == 0 and s2.kv_heads % M2 and straddle,
                 f"tp_whole: {c2['arch']} at {M2} ranks straddles no kv heads")
        p2 = init_values(L.init_attention(s2), gen, "cuda")
        tok2 = torch.randn((B, 1, s2.d_model), generator=gen, device="cuda").to(bf16)
        kc = torch.zeros((B, T, s2.kv_heads, s2.head_dim), dtype=bf16, device="cuda")
        vc = torch.zeros_like(kc)
        kc[:, :P] = torch.randn((B, P, s2.kv_heads, s2.head_dim), generator=gen,
                                device="cuda").to(bf16)
        vc[:, :P] = torch.randn((B, P, s2.kv_heads, s2.head_dim), generator=gen,
                                device="cuda").to(bf16)
        whole = {"k": kc.clone(), "v": vc.clone()}
        held = {"k": kc, "v": vc}
        ranks2 = [heads_of(p2, r, Hl2) for r in range(M2)]
        want2, _ = L.decode_attention_local(p2, s2, tok2, whole, pos)
        calls = []
        n0 = dops.decode.LAUNCHES
        with _recorded_attention(L, calls):
            parts = [L.decode_attention_local(ranks2[r], s2, tok2, held, pos, TP(None, M2, r))[0]
                     for r in range(M2)]
        launches["decode_attention_straddle"] = dops.decode.LAUNCHES - n0
        same_cache &= torch.equal(held["k"], whole["k"]) and torch.equal(held["v"], whole["v"])
        views &= all(cl[2].untyped_storage().data_ptr() == kc.untyped_storage().data_ptr()
                     for cl in calls)
        blockwise["attention_decode_straddle"] = _row_ulp_gap(_sum_parts(parts), want2)
        check_calls(calls, "tp_whole straddled decode")
        # rank 1's two calls, one of them timed alone
        r1 = straddle[0]
        first = sum(len(groups[r]) for r in range(r1))
        decode_straddle = _decode_times(dops, dref, *calls[first][1:4], P)
        decode_straddle["rank_calls"] = len(groups[r1])
        decode_straddle["rank_ms"] = _device_ms(lambda: [
            dops.decode(*cl[1:4], pos) for cl in calls[first:first + len(groups[r1])]])["ms"]
        straddle_times = _rank_times(
            lambda: L.decode_attention_local(p2, s2, tok2, whole, pos),
            [lambda r=r: L.decode_attention_local(ranks2[r], s2, tok2, held, pos,
                                                  TP(None, M2, r)) for r in range(M2)])
        del parts, calls, whole, held, kc, vc, p2, ranks2
    torch.cuda.synchronize()
    want_launches = {"flash_attention_rank_head": M, "decode_attention_one_kv_head": M,
                     "decode_attention_straddle": sum(len(g) for g in groups)}
    out.update(
        straddle={"arch": c2["arch"], "model_axis": M2, "heads_a_rank": Hl2,
                  "straddling_ranks": straddle,
                  "calls": want_launches["decode_attention_straddle"]},
        blockwise=blockwise, launches_by_form=launches,
        kv_every_rank_computes_is_the_layers=kv_whole, whole_cache_written_alike=same_cache,
        decode_reads_strided_views_of_the_cache=views,
        calls_vs_plain={"flash_largest_share_of_bound": max(checks["flash"]),
                        "decode_largest_max_abs_err": max(checks["decode"])},
        times={"attention_prefill": attn_times, "mlp": mlp_times, "attention_decode": decode_times,
               "attention_decode_straddle": straddle_times},
        flash_attention_rank_head=flash_rank, decode_attention_one_kv_head=decode_one,
        decode_attention_straddle=decode_straddle,
        tolerance={"row_ulps": TP_WHOLE_ROW_ULPS, "of": "each row's largest |output|",
                   "plus": 1e-5, "flash": "the bf16 flash bound of the plain version",
                   "decode": "one bf16 ulp + 2e-5"},
        phase_s=time.perf_counter() - t_phase)
    _emit(out)
    for name, gap in blockwise.items():
        _require(gap["max_err_in_row_ulps"] <= TP_WHOLE_ROW_ULPS,
                 f"tp_whole: the {name} rank parts against the layer: {gap}")
    _require(kv_whole, "tp_whole: a rank's k and v differ from the layer's")
    _require(same_cache, "tp_whole: the whole cache the ranks write differs from the layer's")
    _require(views, "tp_whole: a decode call read a copy of the cache, not a view")
    _require(launches == want_launches,
             f"tp_whole: launches {launches}, expected {want_launches}")
    return out


def _plain_ms(fn, *args):
    """A plain piece of the training forward at one layer's shapes:
    ``fn(*args)`` alone (no grad, as the checkpointed forward runs it) and
    with its backward against a random output gradient (the recompute and
    the backward), ms (CUDA events). The floating-point args take the
    gradients."""
    import torch

    def out(y):
        return y[0] if isinstance(y, tuple) else y

    with torch.no_grad():
        fwd = _time_ms(lambda: fn(*args), iters=3, warmup=1)
    wrt = [a.requires_grad_(True) for a in args
           if isinstance(a, torch.Tensor) and a.is_floating_point()]
    dout = torch.randn_like(out(fn(*args)))

    def fwd_bwd():
        torch.autograd.grad(out(fn(*args)), wrt, dout)

    return fwd, _time_ms(fwd_bwd, iters=3, warmup=1)


def _train_pieces(tr, cfg, B, S):
    """The plain pieces that lead a cell's step, each timed alone at one
    layer's shapes in bf16 (``_plain_ms``) beside its count in a step: the
    training attention ``_sdpa`` by kind (causal, over a window, without a
    mask: whisper's encoder and cross-attention), Mamba2's ``ssd_chunked``
    and RWKV6's chunked scan. Each piece's seconds a step: count x (forward
    + forward with backward)."""
    import torch

    layers, ssm, sref = tr["layers"], tr["ssm"], tr["scan_ref"]
    g = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.float32

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", generator=g, dtype=dtype)

    counts, calls = collections.Counter(), {}  # name -> count; name -> (fn, args)

    def attention(name, H, KV, D, window=None, causal=True, n=1):
        counts[name] += n
        if name not in calls:
            mask = layers.causal_mask(S, S, window, device="cuda") if causal else None
            calls[name] = (lambda q, k, v: layers._sdpa(q, k, v, mask, H // KV),
                           (randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)))

    if hasattr(cfg, "enc_layers"):  # whisper: every attention at S positions
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        attention("sdpa non-causal", H, KV, D, causal=False, n=cfg.enc_layers + cfg.dec_layers)
        attention("sdpa causal", H, KV, D, n=cfg.dec_layers)
    for b in [] if hasattr(cfg, "enc_layers") else [
            b for grp in cfg.groups for b in (grp.blocks + grp.shared) * grp.repeat]:
        if b.kind == "attn":
            a = b.attn
            attention("sdpa causal" if a.window is None else f"sdpa window {a.window}",
                      a.n_heads, a.kv_heads, a.head_dim, a.window)
        elif b.kind == "mamba2":
            counts["ssd_chunked"] += 1
            if "ssd_chunked" not in calls:  # every Mamba2 block of a config has one spec
                m = b.mamba
                calls["ssd_chunked"] = (
                    lambda xh, dt, A, Bm, Cm, Q=m.chunk: ssm.ssd_chunked(xh, dt, A, Bm, Cm, Q),
                    (randn(B, S, m.n_heads, m.head_dim),
                     torch.nn.functional.softplus(randn(B, S, m.n_heads, dtype=f32)),
                     -torch.exp(0.5 * randn(m.n_heads, dtype=f32)),
                     randn(B, S, m.d_state), randn(B, S, m.d_state)))
        elif b.kind == "rwkv6_time":
            counts["rwkv6_chunked"] += 1
            if "rwkv6_chunked" not in calls:
                r = b.rwkv
                H, K = r.n_heads, r.head_dim
                calls["rwkv6_chunked"] = (
                    lambda rr, kk, vv, lw, u, Q=r.chunk: sref.rwkv6_chunked(rr, kk, vv, lw, u, Q),
                    (0.1 * randn(B, S, H, K), 0.1 * randn(B, S, H, K), randn(B, S, H, K),
                     -torch.exp(randn(B, S, H, K, dtype=f32).clamp(*LOG_DECAY_CLIP)),
                     0.1 * randn(H, K, dtype=f32)))
    out = {}
    for name, (fn, args) in calls.items():
        fwd, fb = _plain_ms(fn, *args)
        out[name] = {"count": counts[name], "forward_ms": fwd, "forward_backward_ms": fb,
                     "s_per_step": counts[name] * (fwd + fb) / 1e3}
        torch.cuda.empty_cache()
    return out


def _train_config(configs, cell):
    """A cell's config at full width; with ``layers``, its last group's
    period repeated that many times (a depth cut: rwkv6's one group,
    deepseek's MoE layers after its dense one)."""
    cfg = configs.get_config(cell["arch"])
    if "layers" in cell:
        last = dataclasses.replace(cfg.groups[-1], repeat=cell["layers"])
        cfg = dataclasses.replace(cfg, groups=tuple(cfg.groups[:-1]) + (last,))
    return cfg


def phase_train(tr, kmods, cell):
    """A train cell at full width through the user's entry points:
    build_model, make_smoke_mesh, build_train_step (default optimizer,
    IplsStepConfig(**TRAIN_OVERRIDES.get(arch, {})): deepseek's fsdp=True),
    cell["steps"] steps on synth_tokens (whisper: and
    frames drawn from the seed). Build seconds, seconds a step (host clock
    after a sync; the median of the steps after the first), tokens/s, model
    FLOP/s (6 x active parameters x tokens: the attention's and the chunked
    scans' own FLOPs left out) and MFU, peak memory over the phase's base,
    every loss (finite), grad norm and eps (the recursion's values), the
    state's step, the first layer's matrices changed; then one step split by
    a syncing PhaseTimer (forward, backward with the recompute, update with
    the collectives), one under torch.profiler (the named ranges' share:
    their forward and recompute kernels, since autograd runs the backward
    outside them), and the leading plain pieces timed alone
    (``_train_pieces``) with their share of a step. No kernel launched."""
    import statistics

    import torch

    configs, sharded, steps, tree = (tr[k] for k in ("configs", "sharded", "steps", "tree"))
    name, B, n = cell["phase"], cell["batch"], cell["steps"]
    S, seed = cell.get("seq_len", TRAIN["seq_len"]), cell.get("seed", TRAIN["seed"])
    cfg = _train_config(configs, cell)
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = configs.build_model(cfg, device="cuda", seed=seed)
    mesh = tr["mesh"].make_smoke_mesh("cuda")
    step_cfg = sharded.IplsStepConfig(**steps.TRAIN_OVERRIDES.get(cell["arch"], {}))
    built = steps.build_train_step(model, mesh, configs.ShapeSpec(f"{name}_4k_cut", S, B, "train"),
                                   step_cfg=step_cfg)
    state = built.init_state(model.params())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    _require(n_params == TRAIN_PARAMS[cell["arch"]], f"{name}: {n_params} parameters")
    n_active = model.num_active_params()
    batch = {"tokens": torch.from_numpy(tr["data"].synth_tokens(B, S, cfg.vocab, seed=seed)),
             "participation": torch.ones(B)}
    if hasattr(cfg, "enc_layers"):
        batch["enc_embeds"] = tr["serve_lm"].frame_embeds(cfg.d_model, B, S, seed)
    # the first layer of each per-layer list, to see the steps change it
    first = {k: v[0] for k, v in state.params.items() if isinstance(v, list)}
    watched = [(k, t.detach().clone()) for k, t in tree.named_leaves(first)]

    _reset_launches(kmods)
    step_s, losses, gnorms, epss = [], [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = built.fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        epss.append(float(m["eps"]))
    launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
    peak = torch.cuda.max_memory_allocated() - base
    step_after = int(state.step)
    now = dict(tree.named_leaves(first))
    unchanged = [k for k, t in watched if torch.equal(t, now[k])]
    unchanged_matrices = [k for k in unchanged if now[k].dim() >= 2]
    # the warm-up's first learning rates (1.5e-6, 3e-6, ...) move a bf16
    # weight only where its ulp is that small: a share of the elements
    changed = sum(int((t != now[k]).sum()) for k, t in watched) / sum(t.numel()
                                                                    for _, t in watched)
    del watched, now
    # eps <- alpha eps + (1 - alpha) / r in float32, one agent, all in (r = 1)
    want_eps, e = [], np.float32(1.0)
    for _ in range(n):
        e = np.float32(np.float32(0.5) * e + np.float32(0.5) / np.float32(1.0))
        want_eps.append(float(e))
    median = statistics.median(step_s[1:])
    model_flops = 6 * n_active * B * S

    # one more step with a syncing phase timer (the same pieces)
    timer = tr["telemetry"].PhaseTimer()
    timed = sharded.make_train_step(model.loss, built.optimizer, step_cfg,
                                    num_agents=1, update_shardings=built.update_shardings,
                                    mesh=mesh, timer=timer)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = timed(state, batch)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t
    split = {k: v["total_s"] for k, v in timer.summary().items()}
    # and one under torch.profiler
    _, prof = _profile(lambda: built.fn(state, batch))
    spans = {k: {"forward_and_recompute_ms": ms,
                 "share_of_device_time": _span_share(prof, [k])}
             for k, (ms, _) in prof["spans_ms"].items()}
    del state, built, model, timed, first
    torch.cuda.empty_cache()
    pieces = _train_pieces(tr, cfg, B, S)
    for v in pieces.values():
        v["share_of_step"] = v["s_per_step"] / median
    torch.cuda.empty_cache()
    out = {
        "phase": name, "arch": cfg.name, "params": n_params, "active_params": n_active,
        "layers_cut_to": cell.get("layers"), "layers": (sum(g.repeat for g in cfg.groups) if hasattr(cfg, "groups")
                                                    else cfg.n_layers),
        "fsdp": step_cfg.fsdp, "global_batch": B, "seq_len": S, "steps": n,
        "launches": launches, "build_s": build_s, "step_s": step_s,
        "step_s_median_after_first": median, "tokens_per_s": B * S / median,
        "model_flops_per_step": model_flops, "model_flops_per_s": model_flops / median,
        "mfu_of_bf16_peak": model_flops / median / HW.peak_flops,
        "peak_bytes_over_base": peak, "losses": losses, "grad_norms": gnorms, "eps": epss,
        "phase_split_step_s": timed_s, "phase_split_s": split,
        "profile_step": prof, "span_shares": spans, "plain_pieces": pieces,
        "step_after_steps": step_after, "first_layer_leaves_unchanged": unchanged,
        "first_layer_elements_changed": changed, "phase_s": time.perf_counter() - t_phase,
    }
    _emit(out)  # the numbers first, so that a failing check shows them
    _require(all(v == 0 for v in launches.values()), f"{name}: kernels launched {launches}")
    _require(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), f"{name}: not finite")
    _require(epss == want_eps, f"{name}: eps {epss}, the recursion gives {want_eps}")
    _require(step_after == n, f"{name}: step {step_after} after {n} steps")
    _require(not unchanged_matrices, f"{name}: matrices unchanged {unchanged_matrices}")
    return out


def _profile(fn):
    """fn's result, and the device time by kernel over that one call of
    ``fn`` (torch.profiler), the wall time and the device's busy share of
    it; None where the profiler shows no device time. Also the device time
    of the kernels launched inside each of the model's named ranges
    (``SPANS``; ms and calls) and the count of each host sync in
    ``HOST_SYNCS``. Read from the profiler's trace as its C++ exporter
    writes it (JSON), not from the profiler's Python events: a training
    step holds about 10^5 events, whose processing took 10-40 s. A kernel
    counts in a range when the runtime call that launched it (matched by
    correlation id) lies inside the range on the same thread: in a
    training step the forward's and the recompute's kernels (autograd runs
    the backward outside the model's ranges)."""
    import bisect
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    syncs = dict.fromkeys(HOST_SYNCS, 0)
    launched, ranges, device = {}, collections.defaultdict(list), []
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if name in syncs:
            syncs[name] += 1
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = (e["tid"], e["ts"])
        elif cat == "user_annotation" and name in SPANS:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], name))
    for r in ranges.values():
        r.sort()
    starts = {tid: [a for a, _, _ in r] for tid, r in ranges.items()}
    by_kernel, spans = {}, {name: [0.0, 0] for r in ranges.values() for _, _, name in r}
    for r in ranges.values():
        for _, _, name in r:
            spans[name][1] += 1
    for e in device:
        us, n = by_kernel.get(e["name"][:80], (0.0, 0))
        by_kernel[e["name"][:80]] = (us + e["dur"], n + 1)
        tid, ts = launched.get(e.get("args", {}).get("correlation"), (None, None))
        i = bisect.bisect_right(starts.get(tid, []), ts) - 1 if tid is not None else -1
        if i >= 0 and ts <= ranges[tid][i][1]:
            spans[ranges[tid][i][2]][0] += e["dur"] / 1e3
    total_us = sum(us for us, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return value, {
        "wall_s": wall, "device_s": total_us / 1e6 if total_us else None,
        "device_busy_share": total_us / 1e6 / wall if total_us else None,
        "top_kernels_ms": {k: [us / 1e3, n] for k, (us, n) in top},
        "spans_ms": spans, "host_syncs": syncs, "events": len(events),
    }


def _span_share(prof, names):
    """The share of a profile's device time in the kernels of the named
    ranges; None without device time."""
    if not prof["device_s"]:
        return None
    return sum(prof["spans_ms"].get(n, [0.0])[0] for n in names) / (prof["device_s"] * 1e3)


def _share(prof, tag: str):
    """The share of a profile's device time spent in kernels whose name
    holds ``tag`` (among its ten largest kinds); None without device time."""
    if not prof["device_s"]:
        return None
    ms = sum(t for k, (t, _) in prof["top_kernels_ms"].items() if tag in k)
    return ms / (prof["device_s"] * 1e3)


def _lossless(cfg):
    """The config with every MoE capacity at all of its choices
    (capacity_factor = num_experts / top_k): prefill and decode then drop
    nothing, so they route each token alike. whisper's (no MoE) as it is."""
    from repro_torch.models.whisper import WhisperConfig

    if isinstance(cfg, WhisperConfig):
        return cfg

    def block(b):
        if b.kind != "moe":
            return b
        return dataclasses.replace(b, moe=dataclasses.replace(
            b.moe, capacity_factor=b.moe.num_experts / b.moe.top_k))

    return dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, blocks=tuple(block(b) for b in g.blocks)) for g in cfg.groups))


def _decode_vs_prefill(model, seq, P, extra):
    """Decode of token P after a prefill of seq[:, :P], against the
    last-token logits of a prefill of seq (P + 1 tokens): max |d|, the
    share of rows with the same greedy token, and the logits more than one
    bf16 ulp apart. ``extra``: the inputs of the P + 1-token prefill
    besides its tokens (``_with_next``; the P-token prefill takes the
    first P of positions3)."""
    import torch

    head = {k: v[..., :P] if k == "positions3" else v for k, v in extra.items()}
    _, cache = model.prefill({"tokens": seq[:, :P], "cache_len": P + 1, **head})
    step, _ = model.decode_step(cache, {"token": seq[:, P:], "pos": P})
    del cache
    ref, _ = model.prefill({"tokens": seq, **extra})
    s, r = step.float(), ref.float()
    over = ((s - r).abs() > _bf16_ulp(torch.maximum(s.abs(), r.abs()))).sum().item()
    return (s - r).abs().max().item(), _same_argmax(step, ref), over


def _tree_cast(tree, dtype):
    """A copy of a nested dict of tensors, its floating leaves in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _tree_cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _blocks(model, tokens, P, extra):
    """A served model as a chain of blocks at positions 0..P: the
    embedding x (B, P + 1, d), each block as (params, has_cache, prefill,
    decode) with prefill(p, x, rows) -> (y, cache entry or None) over x's
    positions (``rows`` slices the batch of the model's other inputs) and
    decode(p, x, entry) -> y at position P, and the logits of the last
    hidden state. A TransformerLM's blocks in order (M-RoPE's positions3
    from ``extra``, (3, B, P + 1)); whisper's decoder layers over its
    encoder's output of ``extra``'s frames (the encoder is shared by
    prefill and decode)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.whisper import WhisperModel

    dev = model.device
    pos = torch.tensor(P, dtype=torch.int32, device=dev)
    if isinstance(model, WhisperModel):
        enc = model.encode(extra["enc_embeds"])
        last = torch.tensor(enc.shape[1] - 1, dtype=torch.int32, device=dev)
        x = model._embed_dec(tokens, model.pos_dec[:P + 1])

        def pre(p, h, rows):
            return model.dec_block_prefill(p, h, enc[rows].to(h.dtype), P + 1)

        def dec(p, h, c):
            return model.dec_block_decode(p, h, c, pos, last)

        return x, [(p, True, pre, dec) for p in model.dec], lambda h: model._logits(h).float()
    B = tokens.shape[0]
    ar = torch.arange(P + 1, device=dev)[None].expand(B, P + 1)
    p3 = extra.get("positions3")
    blocks = []
    for _, _, _, b, p in model._layers():
        def pre(p, h, rows, b=b):
            n = h.shape[1]
            ctx = {"positions": ar[rows, :n], "cache_len": P + 1}
            if p3 is not None:
                ctx["positions3"] = p3[:, rows, :n].to(dev)
            return T.apply_block_prefill(b, p, h, ctx)

        def dec(p, h, c, b=b):
            return T.apply_block_decode(b, p, h, c, pos)[0]

        blocks.append((p, T.block_cache_defs(b, 1, 1, model.dtype) is not None, pre, dec))
    return model._embed_in(tokens), blocks, lambda h: model._logits(
        T._norm_apply(model.cfg.final_norm, model.final_norm, h)).float()


def _layerwise(model, seq, P, carry: bool, extra=None):
    """Decode of token P against a prefill of seq (P + 1 tokens), block by
    block, chained as prefill and decode_step chain them (``_blocks``;
    ``extra``: the P + 1-token prefill's other inputs). A block with a
    cache takes it from a prefill of its input's first P positions
    (``cache_len`` P + 1); each gap is max |d| at position P over the
    largest |value| of the block's prefill output there:
      forced  -- the block's decode from its prefill input: its own arithmetic;
      free    -- the decode chain from the embedding (decode_step's);
      carried -- with ``carry``, the prefill chain fed, from the second
                 block on, the first block's decode output at P: that
                 difference taken on by prefill alone (the witness of
                 WITNESS_FACTOR's note);
    for a bf16 model, each block also run in float32 (its weights and input
    cast up, a row at a time) and the bf16 prefill's and forced decode's
    gaps from it (``err_prefill``, ``err_decode``); and the logits gaps
    (max |d|) of the free and carried chains."""
    import torch

    tokens = seq.to(model.device)
    B = tokens.shape[0]
    up = model.dtype != torch.float32
    keys = ("forced", "free") + (("carried",) if carry else ()) + (
        ("err_prefill", "err_decode") if up else ())
    out = {k: [] for k in keys}
    every = slice(None)

    with torch.no_grad():
        x, blocks, logits = _blocks(model, tokens, P, extra or {})
        x_free, x_car = x[:, P:], None
        for p, has_cache, pre, dec in blocks:
            c = pre(p, x[:, :P], every)[1] if has_cache else None
            forced_c = None if c is None else {k: v.clone() for k, v in c.items()}
            y = dec(p, x[:, P:], forced_c)
            x_free = dec(p, x_free, c)
            del c, forced_c
            if up:
                p32 = _tree_cast(p.as_dict(), torch.float32)
                ref32 = torch.cat([pre(p32, x[r:r + 1].float(), slice(r, r + 1))[0][:, P:]
                                   for r in range(B)])
                del p32
            x_out = pre(p, x, every)[0]
            if carry:
                x_car = (torch.cat([x_out[:, :P], y], dim=1) if x_car is None
                         else pre(p, x_car, every)[0])
            x = x_out
            want = x[:, P:].float()
            scale = want.abs().max().item()
            for key, got in (("forced", y), ("free", x_free)) + (
                    (("carried", x_car[:, P:]),) if carry else ()):
                out[key].append((got.float() - want).abs().max().item() / scale)
            if up:
                out["err_prefill"].append((want - ref32).abs().max().item() / scale)
                out["err_decode"].append((y.float() - ref32).abs().max().item() / scale)
        want = logits(x[:, P:])
        out["logits"] = {k: (logits(h) - want).abs().max().item()
                         for k, h in (("free", x_free),) + ((("carried", x_car[:, P:]),)
                                                            if carry else ())}
    return out


def _replay_profile(g, pos: int, n: int):
    """``n`` replays of a decode graph ``g`` (``launch.steps.DecodeGraph``)
    from ``pos`` under torch.profiler, after REPLAY_PROFILER_WARMUP spin
    kernels (left out of the counts; see ``_kernel_events``): the wall time, the
    device time and busy share of the replays, their host syncs
    (HOST_SYNCS), their kernels and flash-decode kernels. Retaken from
    ``pos`` (the graph's pos buffer reset) while a profile kept none of its
    spin kernels, up to 2 * PROFILE_TRIES (as ``_witnessed_profile``).
    Returns the last profile and the number taken."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    takes = []
    while len(takes) < 2 * PROFILE_TRIES and not (takes and takes[-1]["warmup_seen"]):
        g.pos.fill_(pos)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(REPLAY_PROFILER_WARMUP):
                torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                g.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        warm = sum("spin_kernel" in e.name for e in dev)
        dev = [e for e in dev if "spin_kernel" not in e.name]
        device_s = sum(e.time_range.end - e.time_range.start for e in dev) / 1e6
        takes.append({
            "replays": n, "wall_s": wall, "device_s": device_s,
            "device_busy_share": device_s / wall,
            "host_syncs": {k: sum(e.name == k for e in events if e.device_type != DeviceType.CUDA)
                           for k in HOST_SYNCS},
            "kernels": sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev),
            "decode_attn_kernels": sum("decode_attn" in e.name for e in dev),
            "warmup_seen": warm,
        })
    return takes[-1], len(takes)


def phase_serve(lm, kmods, name, spec, n_params_want, bounds, check_batch=None, witnessed=(),
                float32_checks=True):
    """An LM path at full width through the user's entry points:
    build_model, then serve_lm.generate (prefill, greedy decode, every
    decode step after the first one replay of a CUDA graph). Each kernel
    runs as often as the arch's layers say: flash attention once per
    attention layer, flash-decode once per attention layer and decode step
    (counted through the graph's replays), the linear scan once per
    time-mix layer (prefill only), the others never. The graph replays
    steps - 1 times and records one step's launches. A second graph run
    and an eager run (``graph=False``) of the first EAGER_COMPARE_TOKENS
    tokens (32; None: all) keep every step's logits: the same tokens, and
    every step's logits bit for bit. ``n_params_want``: the parameter
    count, or (count, active count). The peak memory is reported over the
    memory allocated when the phase starts (its ``base``). Decode against
    prefill: the served config's gap reported, then, on a copy whose MoE
    capacity keeps every choice (``_lossless``, the same weights; any other
    arch as it is), the end-to-end gap held to ``bounds`` (bf16, float32)
    and every block to LAYER_TOL / LAYER_BF16_RATIO (``_layerwise``), in
    bf16 and (but with ``float32_checks=False``) in a float32 copy; for the
    dtypes in ``witnessed`` the end-to-end limit is WITNESS_FACTOR's. ``check_batch``: the rows of the
    float32 checks (all by default; bf16 takes them all). Profiles: the
    prefill of P + 1 tokens, 8 eager decode steps (the ranges' shares) and
    8 replays of generate's step graph (device time, busy share, no host
    sync, flash-decode kernels the graph's record x 8). ``spec`` may cut
    the depth (``layers``: the first group's repeat), give whisper's frame
    count (``enc_len``) and an M-RoPE prompt's image (``image``: text
    tokens before it, its patch grid)."""
    import torch

    configs, serve_lm, steps_mod = lm["configs"], lm["serve_lm"], lm["steps"]
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg = configs.get_config(spec["arch"])
    depth = None
    if "layers" in spec:  # depth cut to fit one card; every width as published
        depth = {"layers": spec["layers"], "of": cfg.n_layers // len(cfg.groups[0].blocks)}
        cfg = dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0],
                                                                   repeat=spec["layers"]),))
    B, P, n_new = spec["batch"], spec["prompt_len"], spec["tokens"]
    t0 = time.perf_counter()
    model = configs.build_model(cfg, device="cuda", seed=spec["seed"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want_n, want_active = n_params_want if isinstance(n_params_want, tuple) else (n_params_want,
                                                                                 None)
    _require(n_params == model.num_params() == want_n, f"{name}: {n_params} parameters")
    _require(want_active is None or model.num_active_params() == want_active,
             f"{name}: {model.num_active_params()} active parameters")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt = serve_lm.prompt_tokens(cfg.vocab, B, P, spec["seed"])
    extra = serve_lm.request_inputs(cfg, B, P, spec["seed"], spec.get("enc_len"),
                                    spec.get("image"), device=model.device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kmods)
    by_shape = collections.defaultdict(collections.Counter)
    with _launches_by_shape(lm["layers"], by_shape, lm["build"]) as per_replay:
        res = serve_lm.generate(model, prompt, n_new, **extra)
    _add_replays(by_shape, per_replay, res["graph_replays"])
    launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
    peak = torch.cuda.max_memory_allocated() - base
    steps = n_new - 1
    want = _expected_launches(kmods, model, steps)
    _require(launches == want, f"{name}: launches {launches}, expected {want}")
    _require(all(sum(by_shape[k].values()) == launches[k] for k in by_shape),
             f"{name}: launches by shape {dict(by_shape)} do not add up to {launches}")
    # the graph: steps - 1 replays, each one step's kernel launches
    per_step = {k: n for k, n in model.kernel_launches()["decode_step"].items() if n}
    kernel_of = {fn: k for k, fn in kmods.items()}
    tally = {kernel_of[fn]: n for fn, n in res["graph_launches"].items()}
    counted = {k: n * res["graph_replays"] for k, n in tally.items()}
    _require(res["graph_replays"] == steps - 1,
             f"{name}: {res['graph_replays']} graph replays for {steps} decode steps")
    _require(tally == per_step, f"{name}: the graph records {tally}, a step launches {per_step}")
    _require(all(counted.get(k, 0) == n * (steps - 1) for k, n in per_step.items()),
             f"{name}: the replays counted {counted}")
    toks = res["tokens"]
    _require(tuple(toks.shape) == (B, n_new) and int(toks.min()) >= 0
             and int(toks.max()) < cfg.vocab, f"{name}: tokens out of range")
    for key in ("prefill_logits", "first_step_logits"):
        lg = res[key]
        _require(tuple(lg.shape) == (B, 1, cfg.vocab) and bool(torch.isfinite(lg.float()).all()),
                 f"{name}: {key} not finite or of the wrong shape")

    # the served decode at pos P against the last-token logits of a prefill
    # of P + 1 tokens (profiled): a MoE arch's capacity drops differ between
    # T = B and T = B (P + 1), so this gap is reported only
    full = torch.cat([prompt, toks[:, :1]], dim=1)
    extra_full = _with_next(extra, P)
    ref_bf16, prefill_prof = _profile(lambda: model.prefill({"tokens": full, **extra_full})[0])
    served = {"bf16": (res["first_step_logits"].float() - ref_bf16.float()).abs().max().item(),
              "same_argmax": _same_argmax(res["first_step_logits"], ref_bf16)}
    # device time of 8 steady decode steps (slots of the cache reused): eager
    # (the ranges' shares), then 8 replays of generate's step graph
    cache, tok = res.pop("cache"), toks[:, -1:].to(model.device)
    pos = torch.tensor(P + n_new - 8, dtype=torch.int32, device=model.device)

    def decode8():
        nonlocal cache
        for _ in range(8):
            _, cache = model.decode_step(cache, {"token": tok, "pos": pos})
            pos.add_(1)

    _, decode_prof = _profile(decode8)
    # generate's step graph (its greedy tail writes column pos - P + 1: one
    # past generate's last, at pos P + n_new - 1)
    scratch = torch.zeros((B, n_new + 1), dtype=torch.int32, device=model.device)
    graph = steps_mod.DecodeGraph(model, cache, tok, P + n_new - 9,
                                  after=serve_lm.greedy(scratch, P))
    graph.step()  # the eager warm-up step, then the capture
    replay_prof, replay_takes = _replay_profile(graph, P + n_new - 8, 8)
    replay_prof["profiles_taken"] = replay_takes
    replay_prof["graph_decode_attention_per_replay"] = graph.launches.get(kmods["decode_attention"],
                                                                          0)
    graph.close()
    del cache, graph, scratch, res["prefill_logits"], ref_bf16

    # graph against eager, every step's logits kept (n_cmp tokens)
    n_cmp = n_new if EAGER_COMPARE_TOKENS is None else min(n_new, EAGER_COMPARE_TOKENS)
    runs = {}
    for mode in ("graph", "eager"):
        r = serve_lm.generate(model, prompt, n_cmp, graph=mode == "graph", keep_logits=True,
                              **extra)
        del r["cache"]
        runs[mode] = r
    g, e = runs["graph"]["step_logits"], runs["eager"]["step_logits"]
    graph_vs_eager = {
        "steps_compared": n_cmp - 1,
        "same_tokens": bool(torch.equal(runs["graph"]["tokens"], runs["eager"]["tokens"])
                            and torch.equal(runs["graph"]["tokens"], toks[:, :n_cmp])),
        "logits_bitwise": _bits_equal(g, e) and _bits_equal(runs["graph"]["prefill_logits"],
                                                            runs["eager"]["prefill_logits"]),
        "max_abs": (g.float() - e.float()).abs().max().item(),
        "steps_differing": int(((g.float() - e.float()).abs().amax(dim=(1, 2, 3)) > 0).sum()),
        "graph_decode_ms_per_step": runs["graph"]["decode_s"] / (n_cmp - 1) * 1e3,
        "eager_decode_ms_per_step": runs["eager"]["decode_s"] / (n_cmp - 1) * 1e3,
        "graph_replays": runs["graph"]["graph_replays"],
    }
    del runs, g, e
    torch.cuda.empty_cache()

    rows = check_batch or B
    model.cfg = _lossless(cfg)

    def reading(m, seq, ext, dtype):
        d, same, over = _decode_vs_prefill(m, seq, P, ext)
        return {"max_abs": d, "same_argmax": same, "over_one_ulp": over,
                "layerwise": _layerwise(m, seq, P, carry=dtype in witnessed, extra=ext)}

    checks = {"bf16": [reading(model, full, extra_full, "bf16")]}
    torch.cuda.empty_cache()
    if float32_checks:
        m32 = model.float()  # in place: each bf16 weight is freed once converted
        del model
        # the served prompt with its first greedy token, and a second prompt
        # (P + 1 tokens, and frames, from the next seed): two readings of the
        # float32 gap
        second = serve_lm.prompt_tokens(cfg.vocab, B, P + 1, spec["seed"] + 1)
        extra_second = _with_next(serve_lm.request_inputs(
            cfg, B, P, spec["seed"] + 1, spec.get("enc_len"), spec.get("image"),
            device=m32.device), P)
        checks["float32"] = [reading(m32, seq[:rows], _first_rows(ext, rows), "float32")
                             for seq, ext in ((full, extra_full), (second, extra_second))]
        del m32
    else:
        del model
    torch.cuda.empty_cache()
    for dtype, bound in zip(("bf16", "float32"), bounds):
        for r in checks.get(dtype, ()):
            carried = r["layerwise"]["logits"].get("carried", 0.0)
            r["limit"] = WITNESS_FACTOR * carried if carried >= bound else bound
    out = {
        "phase": name, "arch": cfg.name, "params": n_params, "weight_bytes": weight_bytes,
        "active_params": want_active, "depth_cut": depth,
        "enc_len": extra["enc_embeds"].shape[1] if "enc_embeds" in extra else None,
        "image": spec.get("image"), "batch": B, "prompt_len": P, "new_tokens": n_new,
        "decode_steps": steps, "launches": launches,
        "launches_by_shape": {k: dict(v) for k, v in by_shape.items()}, "build_model_s": build_s,
        "prefill_s": res["prefill_s"], "prefill_tokens_per_s": B * P / res["prefill_s"],
        "decode_s": res["decode_s"], "decode_ms_per_step": res["decode_s"] / steps * 1e3,
        "decode_tokens_per_s": B * steps / res["decode_s"],
        "decode_graph": {"capture_s": res["capture_s"], "replays": res["graph_replays"],
                         "launches_per_replay": tally, "launches_counted": counted},
        "graph_vs_eager": graph_vs_eager,
        "memory_base": base, "max_memory_allocated_over_base": peak,
        "served_config_decode_vs_prefill": served,
        "decode_vs_prefill_of": "lossless copy", "check_batch": rows,
        "decode_vs_prefill_bounds": {"bf16": bounds[0], "float32_copy": bounds[1]},
        "witnessed": list(witnessed),
        "decode_vs_prefill": {"bf16": checks["bf16"], "float32_copy": checks.get("float32")},
        "layerwise_tolerance": {"float32_forced": LAYER_TOL, "bf16_ratio": LAYER_BF16_RATIO,
                                "bf16_floor": LAYER_BF16_FLOOR},
        "first_tokens": toks[0, :8].tolist(),
        "profile_prefill_4097": prefill_prof, "profile_decode_8_steps": decode_prof,
        "profile_decode_8_replays": replay_prof,
        "prefill_flash_attention_share": _share(prefill_prof, "flash_fwd"),
        "decode_attention_share": _share(decode_prof, "decode_attn"),
        "shares": {
            f"{which}_{part}": _span_share(prof, names)
            for which, prof in (("prefill", prefill_prof), ("decode", decode_prof))
            for part, names in (("moe_dispatch_combine", ("moe.route", "moe.dispatch",
                                                         "moe.combine")),
                                ("moe_expert_gemms", ("moe.experts",)),
                                ("moe_shared", ("moe.shared",)), ("mla", ("mla",)),
                                ("mamba2", ("mamba2.in", "mamba2.ssd", "mamba2.out")),
                                ("mamba2_ssd", ("mamba2.ssd",)))},
    }
    out["phase_s"] = time.perf_counter() - t_phase
    _emit(out)  # the numbers first, so that a failing check shows them
    _require(graph_vs_eager["same_tokens"] and graph_vs_eager["logits_bitwise"],
             f"{name}: the graph's decode differs from the eager loop's: {graph_vs_eager}")
    _require(graph_vs_eager["graph_replays"] == n_cmp - 2,
             f"{name}: {graph_vs_eager['graph_replays']} replays in the comparison run")
    for dtype, rs in checks.items():
        for r in rs:
            _require(r["max_abs"] <= r["limit"],
                     f"{name}: decode vs prefill ({dtype}) {r['max_abs']}, limit {r['limit']}")
            lw = r["layerwise"]
            if dtype == "float32":
                _require(max(lw["forced"]) <= LAYER_TOL,
                         f"{name}: a block's decode vs prefill (float32) {max(lw['forced'])}")
            else:
                worse = [i for i, (d, p) in enumerate(zip(lw["err_decode"], lw["err_prefill"]))
                         if d > LAYER_BF16_RATIO * p + LAYER_BF16_FLOOR]
                _require(not worse, f"{name}: blocks {worse} decode worse than prefill (bf16)")
    _require(all(n == 0 for n in decode_prof["host_syncs"].values()),
             f"{name}: host syncs in 8 decode steps {decode_prof['host_syncs']}")
    _require(all(n == 0 for n in replay_prof["host_syncs"].values()),
             f"{name}: host syncs in 8 replays {replay_prof['host_syncs']}")
    _require(replay_prof["graph_decode_attention_per_replay"] == per_step.get("decode_attention",
                                                                              0),
             f"{name}: the profiled graph records {replay_prof}")
    _require(replay_prof["warmup_seen"] > 0,
             f"{name}: every profile of 8 replays lost its warm-up kernels: {replay_prof}")
    _require(replay_prof["decode_attn_kernels"] == 8 * per_step.get("decode_attention", 0),
             f"{name}: 8 replays ran {replay_prof['decode_attn_kernels']} flash-decode kernels")
    return out


def _built_greedy(lm, model, mesh, prompt, n, extra, graph):
    """The built prefill (``build_prefill_step``) of ``prompt`` (B, P), then
    n - 1 greedy steps of the built decode step (``build_decode_step``,
    with or without ``graph``) on ``mesh``, each step's token its logits'
    argmax: the tokens (B, n) on the host, the prefill's logits, every
    step's logits (n - 1, B, 1, V), the prefill's seconds, the decode's ms
    a step and the graph's replays."""
    import torch

    configs, steps_mod = lm["configs"], lm["steps"]
    B, P = prompt.shape
    dev = model.device
    pre = steps_mod.build_prefill_step(model, mesh, configs.ShapeSpec("prefill", P, B, "prefill"))
    dec = steps_mod.build_decode_step(model, mesh,
                                      configs.ShapeSpec("decode", P + n, B, "decode"), graph=graph)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, cache = pre.fn({"tokens": prompt.to(dev), "cache_len": P + n, **extra})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = first[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
    toks, kept = [tok], []
    pos = torch.tensor(P, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for _ in range(n - 1):
        logits, cache = dec.fn(cache, {"token": tok, "pos": pos})
        kept.append(logits.clone())  # a graph's logits buffer is overwritten by the next call
        tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        toks.append(tok)
        pos += 1
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / (n - 1) * 1e3
    replays = dec.decode_graph.replays if graph else 0
    if graph:
        dec.decode_graph.close()
    del cache
    return {"tokens": torch.cat(toks, dim=1).cpu(), "prefill_logits": first,
            "step_logits": torch.stack(kept), "prefill_s": prefill_s, "decode_ms": decode_ms,
            "replays": replays}


def phase_serve_steps(lm, kmods, specs):
    """The step builders at full width, one arch of each family (dense,
    MoE, RWKV6, encoder-decoder), on the card's smoke mesh (a one-process
    NCCL group, started here and destroyed after): ``build_prefill_step``,
    then ``build_decode_step(graph=True)`` greedily for ``tokens`` - 1
    steps (each call after the first one replay of its graph), against
    ``serve_lm.generate`` (meshless, its own graph) on the same weights and
    prompt. dense, rwkv6, whisper: the prefill's and every step's logits
    bit for bit generate's. granite-moe, whose built steps take the MoE
    mesh path (one group, capacity from the rank's B S tokens, float32
    combine) where generate takes the grouped path: the same tokens and
    bits as its built decode step run eagerly (``graph=False``), and its
    gap to generate's reported. Reports the built prefill's seconds and the
    built decode's ms a step (replayed and eager, the host's argmax and
    copies between steps included) beside generate's, and each kernel's
    launches over the phase."""
    import torch

    configs, serve_lm = lm["configs"], lm["serve_lm"]
    t_phase = time.perf_counter()
    _reset_launches(kmods)
    mesh = lm["mesh"].make_smoke_mesh("cuda")
    archs = []
    try:
        for spec in specs:
            cfg = configs.get_config(spec["arch"])
            model = configs.build_model(cfg, device="cuda", seed=spec["seed"])
            B, P, n = spec["batch"], spec["prompt_len"], spec["tokens"]
            prompt = serve_lm.prompt_tokens(cfg.vocab, B, P, spec["seed"])
            extra = serve_lm.request_inputs(cfg, B, P, spec["seed"], spec.get("enc_len"),
                                            device=model.device)
            gen = serve_lm.generate(model, prompt, n, keep_logits=True, **extra)
            del gen["cache"]
            built = _built_greedy(lm, model, mesh, prompt, n, extra, graph=True)
            moe = any(b.kind == "moe" for g in getattr(cfg, "groups", ()) for b in g.blocks)
            r = {"arch": cfg.name, "batch": B, "prompt_len": P, "new_tokens": n,
                 "built_prefill_s": built["prefill_s"], "built_decode_ms_per_step":
                 built["decode_ms"], "built_graph_replays": built["replays"],
                 "generate_prefill_s": gen["prefill_s"],
                 "generate_decode_ms_per_step": gen["decode_s"] / (n - 1) * 1e3,
                 "gap_to_generate": (built["step_logits"].float()
                                     - gen["step_logits"].float()).abs().max().item(),
                 "same_tokens_as_generate": bool(torch.equal(built["tokens"], gen["tokens"])),
                 "sha256": {key: _digest(built[key])
                            for key in ("prefill_logits", "step_logits", "tokens")}}
            if moe:
                eager = _built_greedy(lm, model, mesh, prompt, n, extra, graph=False)
                r.update(against="the built decode step run eagerly",
                         built_eager_decode_ms_per_step=eager["decode_ms"],
                         same_tokens=bool(torch.equal(built["tokens"], eager["tokens"])),
                         logits_bitwise=_bits_equal(built["step_logits"], eager["step_logits"])
                         and _bits_equal(built["prefill_logits"], eager["prefill_logits"]))
                del eager
            else:
                r.update(against="generate",
                         same_tokens=r["same_tokens_as_generate"],
                         logits_bitwise=_bits_equal(built["step_logits"], gen["step_logits"])
                         and _bits_equal(built["prefill_logits"], gen["prefill_logits"]))
            archs.append(r)
            del model, gen, built
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    out = {"phase": "serve_steps", "archs": archs,
           "launches": {k: fn.LAUNCHES for k, fn in kmods.items()},
           "seconds": time.perf_counter() - t_phase}
    _emit(out)
    for r in archs:
        _require(r["same_tokens"] and r["logits_bitwise"] and r["built_graph_replays"]
                 == r["new_tokens"] - 2,
                 f"serve_steps: {r['arch']}'s built steps differ from {r['against']}: {r}")
    return out


def _seeded_long_cache(model, serve_lm, cfg, seed, T, P):
    """``init_cache(1, T)`` with every leaf drawn from ``seed`` at the
    scale (std) of the same leaf after a LONG_SCALE_PROMPT-token prefill:
    attention keys and values in slots 0 .. P - 1 (the rest zero, for the
    decode steps), Mamba2 states and convolution histories, RWKV6 states
    and last inputs. Returns the cache and the scales by leaf name."""
    import torch
    from repro_torch.tree import named_leaves

    prompt = serve_lm.prompt_tokens(cfg.vocab, 1, LONG_SCALE_PROMPT, seed)
    _, short = model.prefill({"tokens": prompt.to(model.device)})
    scale = {name: t.float().std().item() for name, t in named_leaves(short)}
    del short
    cache = model.init_cache(1, T)
    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, t in named_leaves(cache):
        x = t[:, :P] if name.endswith(("['k']", "['v']")) else t
        x.copy_(torch.randn(x.shape, generator=g, device="cuda").mul_(scale[name]))
    return cache, scale


def _rope_on_card(layers, T):
    """cos and sin of RoPE's float32 angles on the card at positions 4,096
    and T - 1, against float64 on the host of the same angles: the
    largest error of each, per (head_dim, theta) of LONG_ROPE."""
    import torch

    out = {}
    for hd, theta in LONG_ROPE:
        freqs = torch.from_numpy(layers.rope_freqs(hd, theta))
        for p in (4096, T - 1):
            ang = (torch.tensor([p], dtype=torch.int32)[..., None].float() * freqs).cuda()
            exact = ang.cpu().double()
            err = max((torch.cos(ang).cpu().double() - exact.cos()).abs().max().item(),
                      (torch.sin(ang).cpu().double() - exact.sin()).abs().max().item())
            out[f"hd{hd}_theta{theta:g}_pos{p}"] = {"max_angle": ang.max().item(),
                                                     "max_err": err}
    return out


def _first_long_attention(model, cache, T):
    """The cache entry (k, v: (1, T, KV, D)) and spec of the first attention
    block whose cache holds all T slots."""
    for gi, li, key, b, _ in model._layers():
        if b.kind == "attn":
            entry = cache[f"g{gi}"][li][key]
            if entry["k"].shape[1] == T:
                return entry, b.attn
    return None, None


def _first_ring_attention(model, cache):
    """The cache entry and spec of the first sliding-window attention block
    (its ring), or (None, None)."""
    for gi, li, key, b, _ in model._layers():
        if b.kind == "attn" and b.attn.window is not None:
            return cache[f"g{gi}"][li][key], b.attn
    return None, None


def _flash_long_check(fops, fref, window, seed, what):
    """The bf16 flash kernel at LONG_FLASH_SHAPE (causal; over ``window``
    keys if given) on seeded q, k, v laid out as the model passes them,
    held against the plain version (``flash_attention_ref``'s arithmetic
    and mask, ``fref.masked`` of the tile's rows) on the query tiles of
    LONG_FLASH_TILES, every key, by ``_flash_bf16_check``'s bound: 2**-7 *
    attn(q, k, |v|) + one bf16 ulp of the larger magnitude + 2e-5,
    elementwise. Returns the call's ms (CUDA events, one call) against the
    bound (``_flash_timing``'s: the pairs the mask keeps, q, k, v and o
    once) and, causal, one SDPA call on the same inputs (flash or
    memory-efficient backend; with the window SDPA would need an (S, S)
    mask, 275 GB: none); max |d| and the largest share of the error bound.
    The plain version of all S rows is not timed: its scores would be
    (B, H, S, S) float32."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, H, KV, S, D = LONG_FLASH_SHAPE
    q, k, v = _attn_inputs(B, H, KV, S, D, dtype=torch.bfloat16, seed=seed)

    def one_call_ms(fn):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        res = fn()
        t1.record()
        torch.cuda.synchronize()
        return res, t0.elapsed_time(t1)

    got, ms = one_call_ms(lambda: fops.attention(q, k, v, causal=True, window=window))
    _require(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
    w = min(window or S, S)
    pairs = w * (w + 1) / 2 + (S - w) * w
    out = {"shape": list(LONG_FLASH_SHAPE), "window": window, "ms": ms,
           **_bound((2 * B * H * S * D + 2 * B * KV * S * D) * 2, 4 * B * H * D * pairs,
                    HW.peak_flops),
           "library": None, "library_ms": None, "plain_ms": None,
           "tiles": list(LONG_FLASH_TILES), "max_abs_err": 0.0, "err_share_of_bound": 0.0}
    out["share_of_bound"] = out["bound_ms"] / ms
    rep = H // KV
    if window is None:
        kh, vh = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            _, out["library_ms"] = one_call_ms(
                lambda: F.scaled_dot_product_attention(q, kh, vh, is_causal=True))
        out["library"] = "scaled_dot_product_attention(is_causal=True), k and v repeated"
        del kh, vh
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    cols = torch.arange(S, device="cuda")
    for a in LONG_FLASH_TILES:
        rows = torch.arange(a, min(a + LONG_FLASH_ROWS, S), device="cuda")
        logits = torch.einsum("bhsd,bhtd->bhst", q[:, :, a:a + len(rows)].float(), kf) * (
            1.0 / math.sqrt(D))
        logits.masked_fill_(fref.masked(S, True, window, "cuda", rows=rows, cols=cols),
                            fref.NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        del logits
        want = torch.einsum("bhst,bhtd->bhsd", probs, vf).to(torch.bfloat16).float()
        attn_abs = torch.einsum("bhst,bhtd->bhsd", probs, vf.abs())
        del probs
        g = got[:, :, a:a + len(rows)].float()
        d = (g - want).abs()
        bound = FLASH_BF16_P_ROUNDING * attn_abs + _bf16_ulp(torch.maximum(g.abs(), want.abs()))
        share = (d / (bound + ATTN_F32_TOL)).max().item()
        _require(share <= 1.0, f"{what}: rows {a}.. kernel != plain version, max |d| "
                               f"{d.max().item()}, {share} of the bound")
        out["max_abs_err"] = max(out["max_abs_err"], d.max().item())
        out["err_share_of_bound"] = max(out["err_share_of_bound"], share)
        del want, attn_abs, g, d, bound
    del q, k, v, got, kf, vf
    torch.cuda.empty_cache()
    return out


def _long_cp_slices(dops, dref, q, k, v, p, G, what):
    """A long cache k, v (B, KV, T, D) cut into the G slices of the
    production mesh's ("data", "model") group: each slice's partial at pos
    ``p`` (the kernel's partial form), merged in rank order, against one
    whole-cache call (``_row_ulp_gap``: bf16 ulps of each (batch, head)
    row's largest, the elements beyond one ulp of their own magnitude
    counted); the first, middle and last slices against the plain partial;
    the last slice timed beside its bound and SDPA (``_tp_partial_timing``).
    ``launches``: the partial form's launches of the G slices."""
    import torch

    T = k.shape[2]
    Tl = T // G
    pos = torch.tensor(p, dtype=torch.int32, device="cuda")
    whole = dops.decode(q, k, v, pos)
    before = dops.decode.PARTIAL_LAUNCHES
    parts = [dops.decode(q, k[:, :, r * Tl:(r + 1) * Tl], v[:, :, r * Tl:(r + 1) * Tl], pos,
                         slot0=r * Tl, return_lse=True) for r in range(G)]
    launches = dops.decode.PARTIAL_LAUNCHES - before
    merged = dops.merge_partials(torch.stack([o for o, _ in parts]),
                                 torch.stack([lse for _, lse in parts]), q.dtype)
    torch.cuda.synchronize()
    plain = {}
    for r in (0, G // 2, G - 1):
        sl = slice(r * Tl, (r + 1) * Tl)
        plain[f"slice{r}"] = dict(zip(("out_of_scale", "lse_abs"), _partial_vs_plain(
            dops, dref, q, k[:, :, sl], v[:, :, sl], pos, r * Tl, parts[r])))
    del parts
    res = {"group": G, "slots_a_slice": Tl, "pos": p, "launches": launches,
           "merged_vs_whole_call": _row_ulp_gap(merged, whole), "plain_checks": plain,
           "timing": _tp_partial_timing(dops, dref, q, k, v, p, G)}
    _require(launches == G, f"{what}: {launches} partial launches for {G} slices")
    _require(res["merged_vs_whole_call"]["max_err_in_row_ulps"] <= LONG_CP_ROW_ULPS,
             f"{what}: the {G} slices merged against one call: {res['merged_vs_whole_call']}")
    for r, e in plain.items():
        _require(e["out_of_scale"] <= ATTN_F32_TOL and e["lse_abs"] <= ATTN_F32_TOL,
                 f"{what}: {r} against the plain partial: {e}")
    return res


def phase_long(lm, kmods, dops, dref, fops, fref, cell, roof):
    """A long_500k cell (``LONG_CELLS``) at full width, bf16, batch 1, on
    524,288 cache slots through the user's entry points: build_model,
    make_smoke_mesh (a one-process NCCL group, destroyed after),
    build_decode_step(SHAPES["long_500k"], graph=True), which takes the
    long-context rules (kv_seq over ("data", "model"), the identity on one
    card). gemma3: build_prefill_step of a LONG_PROMPT-token prompt (its
    seconds and peak; the flash kernel's launches the model's count a
    prefill), then the flash kernel at that prompt's shapes, causal and
    windowed (``_flash_long_check``); zamba2, rwkv6: ``_seeded_long_cache``.
    Then
    LONG_STEPS decode steps on the prompt's next tokens (the first eager,
    then one replay each): the decode kernel's launches the model's count a
    step x LONG_STEPS; the same steps run eagerly (graph=False) from a copy
    of the start cache give the same logits and caches bit for bit. Timed:
    LONG_TIMED_REPLAYS replays and LONG_TIMED_EAGER eager steps at pos
    524,287 (each rewrites that slot with the same token). The decode
    kernel on the cell's own first full-length cache at pos 524,287 against
    its plain version (one bf16 ulp + 2e-5), timed against its bound and
    SDPA. gemma3: decode at LONG_PROMPT against a prefill of LONG_PROMPT + 1
    tokens (SERVE_DECODE_VS_PREFILL_BF16), and RoPE's cos and sin on the
    card at the longest position. The roofline step time beside the
    replayed one."""
    import torch

    configs, serve_lm, steps_mod = lm["configs"], lm["serve_lm"], lm["steps"]
    from repro_torch.tree import named_leaves, tree_map

    name, seed = cell["phase"], cell["seed"]
    shape = configs.SHAPES["long_500k"]
    T, B, P = shape.seq_len, shape.global_batch, LONG_PROMPT
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(cell["arch"])
    _require(configs.shape_applicable(cell["arch"], "long_500k")[0], f"{name}: not applicable")
    model = configs.build_model(cfg, device="cuda", seed=seed)
    mesh = lm["mesh"].make_smoke_mesh("cuda")
    out = {"phase": name, "arch": cfg.name, "params": model.num_params(), "batch": B,
           "cache_slots": T, "fill": cell["fill"]}
    split, mark = {}, [t_phase]  # seconds of each part of the phase, since the last mark

    def lap(part):
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[part], mark[0] = now - mark[0], now
    try:
        dec = steps_mod.build_decode_step(model, mesh, shape, graph=True)
        eager = steps_mod.build_decode_step(model, mesh, shape, graph=False)
        out["rules_kv_seq"] = dec.rules["kv_seq"]
        _require(dec.rules["kv_seq"] == ("data", "model"), f"{name}: {dec.rules}")
        tokens = serve_lm.prompt_tokens(cfg.vocab, B, T, seed)
        if cell["fill"] == "prefill":
            pre = steps_mod.build_prefill_step(model, mesh,
                                               configs.ShapeSpec("long_prefill", P, B, "prefill"))
            prompt = tokens[:, :P].cuda()
            by_shape = collections.defaultdict(collections.Counter)
            _reset_launches(kmods)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _launches_by_shape(lm["layers"], by_shape):
                first, cache = pre.fn({"tokens": prompt, "cache_len": T})
            torch.cuda.synchronize()
            out["prefill_tokens"] = P
            out["prefill_s"] = time.perf_counter() - t0
            out["prefill_peak_bytes_over_base"] = torch.cuda.max_memory_allocated() - base
            # the main path's prefill: one flash launch an attention layer,
            # causal in the global layers and windowed in the local ones
            launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
            want = dict.fromkeys(kmods, 0)
            want.update(model.kernel_launches()["prefill"])
            windows = collections.Counter(
                "causal" if b.attn.window is None else f"window {b.attn.window}"
                for _, _, _, b, _ in model._layers() if b.kind == "attn")
            out.update(prefill_launches=launches, prefill_expected_launches=want,
                       prefill_flash_by_mask=dict(by_shape["flash_attention"]))
            _require(launches == want, f"{name}: prefill launches {launches}, expected {want}")
            _require(by_shape["flash_attention"] == windows,
                     f"{name}: prefill flash by mask {by_shape['flash_attention']}, "
                     f"expected {windows}")
            _require(bool(torch.isfinite(first.float()).all()), f"{name}: prefill not finite")
            del first, prompt
            lap("build_and_prefill")
            # the flash kernel at the prefill's own shapes (outside the count)
            out["flash_kernel"] = {
                kind: dict(_flash_long_check(fops, fref, window, seed, f"{name}: flash {kind}"),
                           launches=by_shape["flash_attention"][kind])
                for kind, window in (("causal", None), (f"window {FLASH_WINDOW}", FLASH_WINDOW))}
            lap("flash_kernel")
        else:
            cache, out["seeded_scales"] = _seeded_long_cache(model, serve_lm, cfg, seed, T, P)
            lap("build_and_fill")
        torch.cuda.empty_cache()
        out["cache_bytes"] = sum(t.numel() * t.element_size() for _, t in named_leaves(cache))
        start = tree_map(lambda t: t.clone(), cache)
        step_toks = [tokens[:, P + i:P + i + 1].cuda() for i in range(LONG_STEPS)]

        # the main path: LONG_STEPS steps of the built step, its graph
        _reset_launches(kmods)
        kept = []
        for i, tok in enumerate(step_toks):
            logits, cache = dec.fn(cache, {"token": tok, "pos": P + i})
            kept.append(logits.clone())  # the graph's buffer is overwritten by the next replay
        torch.cuda.synchronize()
        launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
        g = dec.decode_graph
        per_step = model.kernel_launches()["decode_step"]["decode_attention"]
        want = dict.fromkeys(kmods, 0)
        want["decode_attention"] = per_step * LONG_STEPS
        out.update(launches=launches, expected_launches=want, graph_replays=g.replays,
                   graph_launches_per_replay={fn.__name__: n for fn, n in g.launches.items()})
        _require(launches == want, f"{name}: launches {launches}, expected {want}")
        _require(g.replays == LONG_STEPS - 1, f"{name}: {g.replays} replays")
        graph_logits = torch.stack(kept)
        _require(bool(torch.isfinite(graph_logits.float()).all()), f"{name}: logits not finite")

        # the same steps eagerly from the start cache: bit for bit
        cache_e = start
        eager_logits = []
        for i, tok in enumerate(step_toks):
            logits, cache_e = eager.fn(cache_e, {"token": tok, "pos": P + i})
            eager_logits.append(logits)
        eager_logits = torch.stack(eager_logits)
        same_cache = all(torch.equal(a, b) for (_, a), (_, b)
                         in zip(named_leaves(cache), named_leaves(cache_e)))
        out["graph_vs_eager"] = {"steps": LONG_STEPS,
                                 "logits_bitwise": _bits_equal(graph_logits, eager_logits),
                                 "caches_bitwise": same_cache}
        _require(out["graph_vs_eager"]["logits_bitwise"] and same_cache,
                 f"{name}: graph != eager {out['graph_vs_eager']}")
        del start, cache_e
        torch.cuda.empty_cache()
        lap("steps_graph_and_eager")

        # timed: replays and eager steps at the last position
        last = {"token": step_toks[-1], "pos": T - 1}
        g.set_inputs(last["token"], last["pos"])
        g.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LONG_TIMED_REPLAYS):
            g.step()
        torch.cuda.synchronize()
        out["replayed_ms_per_step"] = (time.perf_counter() - t0) / LONG_TIMED_REPLAYS * 1e3
        t0 = time.perf_counter()
        for _ in range(LONG_TIMED_EAGER):
            eager.fn(cache, last)
        torch.cuda.synchronize()
        out["eager_ms_per_step"] = (time.perf_counter() - t0) / LONG_TIMED_EAGER * 1e3
        g.close()
        out["peak_bytes_over_base"] = torch.cuda.max_memory_allocated() - base
        lap("timed_steps")

        # the decode kernel on this cell's own long cache
        entry, spec = _first_long_attention(model, cache, T)
        if entry is not None:
            gq = torch.Generator(device="cuda").manual_seed(seed)
            q = torch.randn((B, spec.n_heads, spec.head_dim), generator=gq,
                            device="cuda").to(torch.bfloat16)
            k, v = entry["k"].transpose(1, 2), entry["v"].transpose(1, 2)
            pos = torch.tensor(T - 1, dtype=torch.int32, device="cuda")
            got = dops.decode(q, k, v, pos)
            torch.cuda.synchronize()
            err = _attn_check(got, dref.decode_ref(q, k, v, pos), torch.bfloat16,
                              f"{name}: decode kernel at {T} slots")
            out["decode_kernel"] = {"max_abs_err": err, **_decode_times(dops, dref, q, k, v,
                                                                        T - 1)}
            torch.cuda.empty_cache()
            lap("decode_kernel")
            # the same cache over the production mesh's 256-rank group, and a
            # sliding window's ring (2 slots a slice), at pos 524,287
            out["cp_slices"] = {"full": _long_cp_slices(dops, dref, q, k, v, T - 1,
                                                        LONG_CP_GROUP, f"{name}: cp slices")}
            ring, rspec = _first_ring_attention(model, cache)
            if ring is not None:
                qr = torch.randn((B, rspec.n_heads, rspec.head_dim), generator=gq,
                                 device="cuda").to(torch.bfloat16)
                out["cp_slices"]["ring"] = _long_cp_slices(
                    dops, dref, qr, ring["k"].transpose(1, 2), ring["v"].transpose(1, 2), T - 1,
                    LONG_CP_GROUP, f"{name}: cp ring slices")
            torch.cuda.empty_cache()
            lap("cp_slices")

        if cell["fill"] == "prefill":
            # decode at LONG_PROMPT against the last logits of a prefill of
            # LONG_PROMPT + 1 tokens
            del cache
            torch.cuda.empty_cache()
            pre1 = steps_mod.build_prefill_step(
                model, mesh, configs.ShapeSpec("long_prefill_next", P + 1, B, "prefill"))
            want_logits, c1 = pre1.fn({"tokens": tokens[:, :P + 1].cuda()})
            del c1
            d = (graph_logits[0].float() - want_logits.float()).abs().max().item()
            out["decode_vs_prefill"] = {"max_abs": d, "bound": SERVE_DECODE_VS_PREFILL_BF16,
                                        "same_argmax": _same_argmax(graph_logits[0],
                                                                    want_logits)}
            _require(d <= SERVE_DECODE_VS_PREFILL_BF16,
                     f"{name}: decode vs prefill {d} > {SERVE_DECODE_VS_PREFILL_BF16}")
            out["rope_on_card"] = _rope_on_card(lm["layers"], T)
            lap("decode_vs_prefill")
        roof_row = roof.get(name)
        out["roofline"] = _roofline_line(roof_row, out["replayed_ms_per_step"] * 1e-3)
    finally:
        torch.distributed.destroy_process_group()
    del model
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    out["split_s"] = split
    _emit(out)
    return out


def _roofline_line(row, measured_s):
    """A cell's roofline on one H100 (``repro_torch.roofline``, counted on
    fake tensors) beside its measured step: the roofline's step time, its
    terms and bottleneck, and its share of the measured time (roofline /
    measured: 1 at the roofline)."""
    return {"hw": row["hw"], "roofline_ms": row["step_time_s"] * 1e3,
            "compute_ms": row["compute_s"] * 1e3, "memory_ms": row["memory_s"] * 1e3,
            "collective_ms": row["collective_s"] * 1e3, "bottleneck": row["bottleneck"],
            "flops": row["hlo_flops"], "bytes": row["hlo_bytes"], "model_flops": row["model_flops"],
            "measured_ms": measured_s * 1e3, "roofline_share": row["step_time_s"] / measured_s}


class _Roofline:
    """The roofline counts of the measured cells: ``python -m
    repro_torch.roofline --cells -`` on the host's CPU (no card: fake
    tensors), started at the beginning of the run and read at its first
    ``get``; its output and errors go to temporary files."""

    def __init__(self, src: Path, cells: list):
        import os
        import tempfile

        self.out, self.err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen([sys.executable, "-m", "repro_torch.roofline", "--cells", "-"],
                                     stdin=subprocess.PIPE, stdout=self.out, stderr=self.err,
                                     text=True, env=env)
        self.proc.stdin.write(json.dumps(cells))
        self.proc.stdin.close()
        self.rows = None

    def get(self, cell: str) -> dict:
        if self.rows is None:
            rc = self.proc.wait(timeout=600)
            self.out.seek(0)
            self.err.seek(0)
            _require(rc == 0, f"roofline counts failed ({rc}):\n{self.err.read()[-4000:]}")
            self.rows = {r["cell"]: r for r in map(json.loads, self.out.read().splitlines())}
            self.out.close()
            self.err.close()
        return self.rows[cell]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _roofline_cells(configs, overrides):
    """The cells whose step time the run measures, as ``python -m
    repro_torch.roofline --cells`` takes them: every train cell (a step at
    its batch and 4,096 tokens, with its arch's fsdp override), every serve
    phase's decode step (its batch, its prompt plus new tokens of cache;
    whisper's 1,500 frames of cross cache) and the long_500k cells."""
    cells = [dict(cell=c["phase"], arch=c["arch"], kind="train", batch=c["batch"],
                  seq_len=c.get("seq_len", TRAIN["seq_len"]), layers=c.get("layers"),
                  fsdp=overrides.get(c["arch"], {}).get("fsdp", False))
             for c in (TRAIN,) + TRAIN_CELLS]
    cells += [dict(cell=name, arch=spec["arch"], kind="decode", batch=spec["batch"],
                   seq_len=spec["prompt_len"] + spec["tokens"], layers=spec.get("layers"),
                   enc_len=spec.get("enc_len"))
              for name, spec, *_ in SERVE_PHASES]
    long = configs.SHAPES["long_500k"]
    cells += [dict(cell=c["phase"], arch=c["arch"], kind="decode", batch=long.global_batch,
                   seq_len=long.seq_len) for c in LONG_CELLS]
    return cells


def _attn_inputs(B, H, KV, S, D, dtype, seed, qscale=1.0, Sk=None):
    """q (B, H, S, D) and k, v (B, KV, Sk, D) (Sk = S by default) as
    transposed views of (B, S, heads, D) tensors, as the model passes them;
    q scaled by ``qscale`` (large logits move the running max across key
    tiles)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn((B, n, h, D), generator=g, device="cuda").mul(qscale if i == 0 else 1.0)
        .to(dtype).transpose(1, 2)
        for i, (n, h) in enumerate(((S, H), (Sk or S, KV), (Sk or S, KV)))
    )


def _flash_dims(shape):
    """(B, H, KV, Sq, Sk, D) of a flash shape: (B, H, KV, S, D), or
    (B, H, KV, Sq, Sk, D) for query and key lengths apart."""
    if len(shape) == 5:
        B, H, KV, S, D = shape
        return B, H, KV, S, S, D
    return tuple(shape)


def _attn_check(got, want, dtype, what):
    import torch

    # bf16: one rounding apart, so within one bf16 ulp, plus the float32
    # tolerance for outputs near 0, where bf16 keeps float32's noise
    d, ok = _gap(got, want, ATTN_F32_TOL, ulp=dtype == torch.bfloat16)
    _require(ok, f"{what}: kernel != plain, max |d| {d}")
    return d


def _by_batch(fn, q, k, v, **kw):
    """A plain attention version run one batch row at a time (its float32
    scores of a row, not of the batch, at once: 4.3 GB at qwen2-vl's 64
    heads and 4,096 positions)."""
    import torch

    return torch.cat([fn(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw) for b in range(q.shape[0])])


def _flash_bf16_check(got, q, k, v, causal, fref, what, window=None, tiled=True):
    """The bf16 flash kernel against the plain version and (``tiled``) the
    plain tiled version: |got - want| <= 2**-7 * attn(q, k, |v|) + one bf16
    ulp of the larger magnitude + 2e-5, elementwise. Returns, for each, max
    |d|, the largest share of the bound, and the count of elements and the
    largest number of bf16 ulps by which |d| - 2e-5 exceeds two ulps (a
    tighter, ulp-only bound would fail there)."""
    import torch

    g = got.float()
    attn_abs = _by_batch(fref.flash_attention_ref, q.float(), k.float(), v.float().abs(),
                         causal=causal, window=window)
    out = {}
    versions = (("plain", fref.flash_attention_ref),
                ("tiled", fref.flash_attention_tiled_ref))[:2 if tiled else 1]
    for name, plain in versions:
        w = _by_batch(plain, q, k, v, causal=causal, window=window).float()
        ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
        d = (g - w).abs()
        share = (d / (FLASH_BF16_P_ROUNDING * attn_abs + ulp + ATTN_F32_TOL)).max().item()
        _require(share <= 1.0, f"{what}: kernel != {name} version, max |d| {d.max().item()}, "
                               f"{share} of the bound")
        ulps = (d - ATTN_F32_TOL).clamp_min(0) / ulp
        out[name] = (d.max().item(), share, int((ulps > 2).sum().item()), ulps.max().item())
        del w, ulp, d, ulps
    return out


def _decode_graph_check(dops, dref, shape):
    """A CUDA graph of one decode call at a serve shape (bf16), replayed
    with each of DECODE_POS written into its pos tensor in place: every
    replay bitwise equal to the eager call and within one bf16 ulp + 2e-5 of
    the plain version. Returns the largest max |d|."""
    import torch
    from repro_torch.kernels import _build

    q, k, v = _attn_inputs(*shape, dtype=torch.bfloat16, seed=7)
    q = q[:, :, 0]
    pos = torch.tensor(0, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream before capture
        dops.decode(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = _build.Graph()
    with graph.capture():
        out = dops.decode(q, k, v, pos)
    worst = 0.0
    for p in DECODE_POS:
        pos.fill_(p)
        graph.replay()
        eager = dops.decode(q, k, v, torch.tensor(p, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        what = f"decode graph replay {shape} pos={p}"
        _require(_bits_equal(out, eager), f"{what}: replay != eager call")
        worst = max(worst, _attn_check(out, dref.decode_ref(q, k, v, pos), torch.bfloat16, what))
    return worst


def phase_kernel_attn(fops, fref, dops, dref):
    """The attention kernels against their plain versions at the serve
    shapes and ragged ones; times, bounds and the SDPA yardstick."""
    import torch

    err = {"flash_attention": {}, "decode_attention": {}}
    # the cases of earlier slices (their seeds as they were), then head_dim
    # 256 and the windows, each group's worst reported apart
    groups = {"": [(c, i, None) for i, c in enumerate(FLASH_CASES)],
              "head_dim_256_and_windows_": [((shape, causal, qscale), 1000 + j, window)
                                            for j, (shape, causal, qscale, window)
                                            in enumerate(FLASH_WINDOW_CASES)],
              "whisper_and_qwen2_vl_": [(c, 2000 + j, None)
                                        for j, c in enumerate(FLASH_CROSS_CASES)]}
    for prefix, cases in groups.items():
        f32_worst = 0.0
        # max |d|, share of the bound, elements beyond two ulps (summed), most ulps
        bf16_worst = {"plain": (0.0, 0.0, 0, 0.0), "tiled": (0.0, 0.0, 0, 0.0)}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            for (shape, causal, qscale), seed, window in cases:
                B, H, KV, Sq, Sk, D = _flash_dims(shape)
                q, k, v = _attn_inputs(B, H, KV, Sq, D, dtype=dtype, seed=seed, qscale=qscale,
                                       Sk=Sk)
                got = fops.attention(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                what = f"flash {name} {shape} causal={causal} window={window} q x {qscale}"
                _require(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
                if dtype == torch.float32:
                    want = _by_batch(fref.flash_attention_ref, q, k, v, causal=causal,
                                     window=window)
                    f32_worst = max(f32_worst, _attn_check(got, want, dtype, what))
                    del want
                else:
                    for plain, (d, sh, n, u) in _flash_bf16_check(got, q, k, v, causal, fref,
                                                                  what, window).items():
                        d0, sh0, n0, u0 = bf16_worst[plain]
                        bf16_worst[plain] = (max(d0, d), max(sh0, sh), n0 + n, max(u0, u))
                del got, q, k, v
        err["flash_attention"][f"{prefix}float32"] = f32_worst
        for plain, key in (("plain", "bfloat16"), ("tiled", "bfloat16_vs_tiled")):
            d, sh, n, u = bf16_worst[plain]
            key = prefix + key
            err["flash_attention"].update({key: d, f"{key}_share_of_bound": sh,
                                           f"{key}_beyond_2_ulps": n, f"{key}_max_ulps": u})
    # a mask pairs query row i with key i: with Sq != Sk it raises, before a launch
    q, k, v = _attn_inputs(2, 8, 8, 4, 64, dtype=torch.bfloat16, seed=3, Sk=100)
    n = fops.attention.LAUNCHES
    for kw in ({"causal": True}, {"causal": True, "window": 8}):
        try:
            fops.attention(q, k, v, **kw)
        except ValueError:
            continue
        _require(False, f"flash with Sq != Sk and {kw} did not raise")
    _require(fops.attention.LAUNCHES == n, "flash launched on a refused call")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        worst = 0.0
        cases = [(DECODE_SHAPE, p) for p in DECODE_POS]
        cases += [((2, 16, 8, 1000, 128), 999), ((2, 16, 8, 1000, 128), 500),
                  ((2, 4, 2, 300, 16), 299), ((1, 24, 8, 700, 16), 5000)]
        cases += [(DECODE_D64_SHAPE, p) for p in DECODE_POS]
        cases += [((2, 6, 2, 1000, 64), 999), ((1, 24, 8, 700, 64), 5000)]
        n_before = len(cases)
        cases += [(DECODE_D256_SHAPE, DECODE_D256_SHAPE[3] - 1), (DECODE_D256_SHAPE, 0)]
        cases += [(DECODE_RING_SHAPE, p) for p in DECODE_RING_POS]
        cases += [((2, 8, 1, 300, 256), 299), ((1, 16, 2, 700, 256), 5000)]
        n_d256 = len(cases)
        # whisper's (group 1: the self cache, the ragged 1,500-slot cross
        # cache at its last key and at pos past T) and qwen2-vl's (group 8)
        cases += [(DECODE_WHISPER_SELF_SHAPE, 100), (DECODE_WHISPER_CROSS_SHAPE, 1499),
                  (DECODE_WHISPER_CROSS_SHAPE, 5000), (DECODE_QWEN2_VL_SHAPE, 4223),
                  (DECODE_QWEN2_VL_SHAPE, 0), ((1, 64, 8, 700, 128), 5000)]
        d256 = served = 0.0
        for i, ((B, H, KV, T, D), p) in enumerate(cases):
            q, k, v = _attn_inputs(B, H, KV, T, D, dtype=dtype, seed=100 + i)
            q = q[:, :, 0]
            pos = torch.tensor(p, dtype=torch.int32, device="cuda")
            got = dops.decode(q, k, v, pos)
            again = dops.decode(q, k, v, pos)
            want = dref.decode_ref(q, k, v, pos)
            torch.cuda.synchronize()
            what = f"decode {name} {(B, H, KV, T, D)} pos={p}"
            d = _attn_check(got, want, dtype, what)
            if i < n_before:
                worst = max(worst, d)
            elif i < n_d256:
                d256 = max(d256, d)
            else:
                served = max(served, d)
            _require(_bits_equal(got, again), f"{what}: two calls differ")
        err["decode_attention"][name] = worst
        err["decode_attention"][f"head_dim_256_{name}"] = d256
        err["decode_attention"][f"whisper_and_qwen2_vl_{name}"] = served
    err["decode_attention"]["graph_replay_bfloat16"] = max(
        _decode_graph_check(dops, dref, shape)
        for shape in (DECODE_SHAPE, DECODE_D64_SHAPE, DECODE_D256_SHAPE,
                      DECODE_WHISPER_CROSS_SHAPE, DECODE_QWEN2_VL_SHAPE))

    # times in bf16, the served dtype, at the serve shapes (D = 128: serve;
    # D = 64: serve_moe)
    timings = {}
    for key, shape, window, causal in (
            ("flash_attention", FLASH_SHAPE, None, True),
            ("flash_attention_d64", FLASH_D64_SHAPE, None, True),
            ("flash_attention_d256", FLASH_D256_SHAPE, None, True),
            ("flash_attention_d256_window", FLASH_D256_SHAPE, FLASH_WINDOW, True),
            ("flash_attention_whisper_encoder", FLASH_WHISPER_ENC_SHAPE, None, False),
            ("flash_attention_whisper_self", FLASH_WHISPER_SELF_SHAPE, None, True),
            ("flash_attention_whisper_cross", FLASH_WHISPER_CROSS_SHAPE, None, False),
            ("flash_attention_qwen2_vl", FLASH_QWEN2_VL_SHAPE, None, True)):
        timings[key] = _flash_timing(fops, fref, shape, window, causal)
    for key, shape, pos in (("decode_attention", DECODE_SHAPE, None),
                            ("decode_attention_d64", DECODE_D64_SHAPE, None),
                            ("decode_attention_d256", DECODE_D256_SHAPE, None),
                            ("decode_attention_d256_ring", DECODE_RING_SHAPE, DECODE_RING_POS[0]),
                            ("decode_attention_whisper_self", DECODE_WHISPER_SELF_SHAPE, None),
                            ("decode_attention_whisper_cross", DECODE_WHISPER_CROSS_SHAPE, None),
                            ("decode_attention_qwen2_vl", DECODE_QWEN2_VL_SHAPE, None)):
        timings[key] = _decode_timing(dops, dref, shape, pos)
    res = {"phase": "kernel_attn", "max_abs_err": err,
           "tolerance": {"float32": ATTN_F32_TOL, "bfloat16": "one bf16 ulp + 2e-5",
                         "flash_bfloat16": "2**-7 * attn(q, k, |v|) + one bf16 ulp + 2e-5"},
           "timings": timings}
    _emit(res)
    return res


def _tp_partial_case(dops, dref, q, k, v, p, M, what):
    """The decode kernel's partial form over M slices of a cache k, v (B,
    KV, T, D) at pos ``p`` (a ring's too: its global slot j is valid when
    j <= p, every slot once it has wrapped): each slice against the plain
    partial (an empty one 0 and -inf exactly), the merge of the kernel's
    partials against the plain merge of the plain ones and decode_ref, and,
    rounded to bf16, against one whole call. Returns the gaps."""
    import torch

    T = k.shape[2]
    pos = torch.tensor(p, dtype=torch.int32, device="cuda")
    whole = dops.decode(q, k, v, pos)
    ref32 = dref.decode_ref(q.float(), k.float(), v.float(), pos)
    Tl = T // M
    parts, plain = [], []
    for r in range(M):
        ks, vs = k[:, :, r * Tl:(r + 1) * Tl], v[:, :, r * Tl:(r + 1) * Tl]
        parts.append(dops.decode(q, ks, vs, pos, slot0=r * Tl, return_lse=True))
        plain.append(dref.decode_partial_ref(q, ks, vs, pos, r * Tl))
    torch.cuda.synchronize()
    worst_o = worst_l = 0.0
    for (o, lse), (po, plse) in zip(parts, plain):
        if bool(torch.isneginf(plse).all()):
            _require(torch.equal(o, po) and bool(torch.isneginf(lse).all()),
                     f"{what}: an empty slice is not 0 and -inf")
            continue
        worst_o = max(worst_o, ((o - po).abs().max() / po.abs().max()).item())
        worst_l = max(worst_l, (lse - plse).abs().max().item())
    merged = dops.merge_partials(torch.stack([o for o, _ in parts]),
                                 torch.stack([lse for _, lse in parts]), torch.float32)
    plain_merged = dref.merge_partials([o for o, _ in plain], [lse for _, lse in plain])
    m_gap = ((merged - plain_merged).abs().max() / plain_merged.abs().max()).item()
    r_gap = ((merged - ref32.float()).abs().max() / ref32.float().abs().max()).item()
    w_gap, ok = _gap(merged.to(torch.bfloat16).float(), whole.float(), ATTN_F32_TOL, ulp=True)
    _require(worst_o <= ATTN_F32_TOL and worst_l <= ATTN_F32_TOL,
             f"{what}: slice != plain, {worst_o}, {worst_l}")
    _require(m_gap <= TP_MERGE_TOL, f"{what}: merge {m_gap}")
    _require(r_gap <= ATTN_F32_TOL, f"{what}: vs decode_ref {r_gap}")
    _require(ok, f"{what}: merged, rounded, vs one call {w_gap}")
    return {"slice_out_of_scale": worst_o, "slice_lse_abs": worst_l,
            "merged_vs_plain_merge_of_scale": m_gap, "merged_vs_decode_ref_of_scale": r_gap,
            "merged_bf16_vs_whole_call": w_gap}


def _tp_partial_timing(dops, dref, q, k, v, p, M):
    """The last of M slices of a cache at pos ``p`` through the partial
    form: device and call times, the plain partial's, SDPA's over the same
    slots (no mask: every slot of the last slice is valid at the pos
    given) and the bound (the valid keys' bytes, the outputs in float32)."""
    import torch
    import torch.nn.functional as F

    B, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    pos = torch.tensor(p, dtype=torch.int32, device="cuda")
    Tl, r = T // M, M - 1
    ks, vs = k[:, :, r * Tl:], v[:, :, r * Tl:]
    n_keys = min(p - r * Tl, Tl - 1) + 1
    _require(n_keys == Tl, f"the last of {M} slices holds {n_keys} of {Tl} valid keys")
    lib = _device_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], ks, vs,
                                                              enable_gqa=True))
    dev = _device_ms(lambda: dops.decode(q, ks, vs, pos, slot0=r * Tl, return_lse=True))
    tm = {
        "shape": [B, H, KV, Tl, D], "slot0": r * Tl, "pos": p, "M": M, **dev,
        "plain_ms": _time_ms(lambda: dref.decode_partial_ref(q, ks, vs, pos, r * Tl), iters=5),
        "library": "scaled_dot_product_attention(enable_gqa=True) over the same slots",
        "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
        **_bound(2 * B * KV * n_keys * D * 2 + B * H * D * 2 + B * H * (D + 1) * 4,
                 4 * B * H * n_keys * D, HW.peak_flops),
    }
    tm["share_of_bound"] = tm["bound_ms"] / tm["ms"]
    return tm


def _tp_offset_case(fops, fref, q, k, v, r, Sl, window, what):
    """Flash at rank r's query offset (its Sl rows, a whole number of
    128-row tiles), causal or over a ``window``: bit for bit those rows of
    one whole call (the same key tiles in the same order), and each 128-row
    tile within the bf16 flash bound of the plain version."""
    import torch

    full = fops.attention(q, k, v, window=window)
    qr = q[:, :, r * Sl:(r + 1) * Sl]
    got = fops.attention(qr, k, v, window=window, q_offset=r * Sl)
    torch.cuda.synchronize()
    bitwise = _bits_equal(got, full[:, :, r * Sl:(r + 1) * Sl])
    _require(bitwise, f"{what} {r * Sl}: rows differ from the whole call's")
    del full
    checks = {}
    for t in range(Sl // 128):
        rows = slice(t * 128, (t + 1) * 128)
        checks[f"tile{t}"] = _flash_bf16_check_offset(got[:, :, rows], qr[:, :, rows], k, v, fref,
                                                      r * Sl + t * 128, f"{what} {r * Sl} tile {t}",
                                                      window=window)
    return {"bitwise_vs_full_call": bitwise, **checks}


def _tp_offset_timing(fops, fref, q, k, v, r, Sl, window=None):
    """Flash at rank r's query offset, causal or over a ``window``: device
    and call times, the plain version's, SDPA's with the rows' mask, and
    the bound: the pairs the mask keeps (operations over 989 TFLOP/s) and
    the bytes of q, o and the keys and values the rows reach."""
    import torch
    import torch.nn.functional as F

    B, H, _, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    qr = q[:, :, r * Sl:(r + 1) * Sl]
    i = torch.arange(Sl, device="cuda")[:, None] + r * Sl
    j = torch.arange(S, device="cuda")[None, :]
    mask = (j <= i) & (j > i - window) if window is not None else j <= i
    pairs = int(mask.sum().item())
    keys = int(mask.any(dim=0).sum().item())
    lib = _device_ms(lambda: F.scaled_dot_product_attention(qr, k, v, attn_mask=mask,
                                                              enable_gqa=True), 5, 3)
    dev = _device_ms(lambda: fops.attention(qr, k, v, window=window, q_offset=r * Sl), 5, 3)
    tm = {
        "shape": [B, H, KV, Sl, S, D], "q_offset": r * Sl, "window": window, **dev,
        "plain_ms": _time_ms(lambda: fref.flash_attention_ref(qr, k, v, causal=True, window=window,
                                                              q_offset=r * Sl), iters=2, warmup=1),
        "library": "scaled_dot_product_attention(attn_mask=the rows' mask, enable_gqa=True)",
        "library_ms": lib["ms"], "library_call_ms": lib["call_ms"], "pairs": pairs,
        "keys_reached": keys,
        **_bound((2 * B * H * Sl * D + 2 * B * KV * keys * D) * 2, 4 * B * H * D * pairs,
                 HW.peak_flops),
    }
    tm["share_of_bound"] = tm["bound_ms"] / tm["ms"]
    return tm


def phase_tp_kernels(fops, fref, dops, dref):
    """The decode kernel's partial form and the flash kernel's query offset
    at full width (see the module docstring): checks, times and bounds.
    ``launches``: the forms' own counters (``decode.PARTIAL_LAUNCHES``,
    ``attention.OFFSET_LAUNCHES``), set to 0 at the start and read at the
    end: the model-axis-1 path the other phases drive takes neither. By
    form: serve's and phi4-mini's (the partial slices, the causal offset)
    and gemma3-1b's (the ring's slices, the offset over a window)."""
    import torch

    t0 = time.perf_counter()
    err = {"decode_attention_partial": {}, "flash_attention_q_offset": {}}
    timings = {}
    by_form = {}
    dops.decode.PARTIAL_LAUNCHES = fops.attention.OFFSET_LAUNCHES = 0
    # (a) the partial form over each split of the cache
    for shape in TP_DECODE_SHAPES:
        B, H, KV, T, D = shape
        q, k, v = _attn_inputs(*shape, dtype=torch.bfloat16, seed=31 + H)
        q = q[:, :, 0]
        key = f"{H}x{KV}"
        for p, M in [(T - 1, M) for M in TP_SPLITS] + [(TP_EMPTY_POS, TP_SPLITS[-1])]:
            err["decode_attention_partial"][f"{key}_M{M}_pos{p}"] = _tp_partial_case(
                dops, dref, q, k, v, p, M, f"decode partial {key} M={M}")
        # one slice at the production model axis: the last rank's, every slot valid
        timings[f"decode_attention_partial_{key}"] = _tp_partial_timing(
            dops, dref, q, k, v, T - 1, TP_SPLITS[-1])
        del q, k, v
    by_form["decode_attention_partial"] = dops.decode.PARTIAL_LAUNCHES
    # (b) the query offset: the rows of one full causal call
    B, H, KV, S, D = TP_FLASH_SHAPE
    q, k, v = _attn_inputs(B, H, KV, S, D, dtype=torch.bfloat16, seed=41)
    Sl = S // TP_FLASH_M
    for r in TP_FLASH_RANKS:
        err["flash_attention_q_offset"][f"r{r}"] = _tp_offset_case(
            fops, fref, q, k, v, r, Sl, None, "flash q_offset")
    timings["flash_attention_q_offset"] = _tp_offset_timing(fops, fref, q, k, v,
                                                            TP_FLASH_RANKS[-1], Sl)
    del q, k, v
    by_form["flash_attention_q_offset"] = fops.attention.OFFSET_LAUNCHES
    # (c) gemma3-1b's local layers at M = 16: the offset over the window
    B, H, KV, S, D = TP_FLASH_WINDOW_SHAPE
    q, k, v = _attn_inputs(B, H, KV, S, D, dtype=torch.bfloat16, seed=43)
    Sl = S // TP_FLASH_M
    for r in TP_FLASH_RANKS:
        err["flash_attention_q_offset"][f"window{TP_FLASH_WINDOW}_r{r}"] = _tp_offset_case(
            fops, fref, q, k, v, r, Sl, TP_FLASH_WINDOW, "flash q_offset window")
    timings["flash_attention_q_offset_window"] = _tp_offset_timing(
        fops, fref, q, k, v, TP_FLASH_RANKS[-1], Sl, TP_FLASH_WINDOW)
    del q, k, v
    by_form["flash_attention_q_offset_window"] = (fops.attention.OFFSET_LAUNCHES
                                                  - by_form["flash_attention_q_offset"])
    # (d) gemma3-1b's ring cut into the axis's slices, wrapped
    M = TP_SPLITS[-1]
    q, k, v = _attn_inputs(*TP_RING_SHAPE, dtype=torch.bfloat16, seed=47)
    q = q[:, :, 0]
    err["decode_attention_partial"][f"ring{TP_RING_SHAPE[3]}_M{M}_pos{TP_RING_POS}"] = \
        _tp_partial_case(dops, dref, q, k, v, TP_RING_POS, M, f"decode partial ring M={M}")
    timings["decode_attention_partial_ring"] = _tp_partial_timing(dops, dref, q, k, v,
                                                                  TP_RING_POS, M)
    del q, k, v
    by_form["decode_attention_partial_ring"] = (dops.decode.PARTIAL_LAUNCHES
                                                - by_form["decode_attention_partial"])
    # (e) zamba2-1.2b's shared attention at M = 16: flash head-parallel at 2
    # of its 32 heads, and the partial form over one rank's 264 slots
    B, H, KV, S, D = TP_ZAMBA2_FLASH_SHAPE
    q, k, v = _attn_inputs(B, H, KV, S, D, dtype=torch.bfloat16, seed=53)
    before = fops.attention.LAUNCHES
    err["flash_attention_zamba2_head_parallel"] = _flash_bf16_check(
        fops.attention(q, k, v), q, k, v, True, fref, "flash zamba2 head-parallel")
    by_form["flash_attention_zamba2_head_parallel"] = fops.attention.LAUNCHES - before
    timings["flash_attention_zamba2_head_parallel"] = _flash_timing(fops, fref,
                                                                    TP_ZAMBA2_FLASH_SHAPE)
    del q, k, v
    before = dops.decode.PARTIAL_LAUNCHES
    q, k, v = _attn_inputs(*TP_ZAMBA2_DECODE_SHAPE, dtype=torch.bfloat16, seed=59)
    q = q[:, :, 0]
    T = TP_ZAMBA2_DECODE_SHAPE[3]
    err["decode_attention_partial"][f"zamba2_M{M}_pos{T - 1}"] = _tp_partial_case(
        dops, dref, q, k, v, T - 1, M, f"decode partial zamba2 M={M}")
    timings["decode_attention_partial_zamba2"] = _tp_partial_timing(dops, dref, q, k, v, T - 1, M)
    del q, k, v
    by_form["decode_attention_partial_zamba2"] = dops.decode.PARTIAL_LAUNCHES - before
    launches = {"decode_attention_partial": dops.decode.PARTIAL_LAUNCHES,
                "flash_attention_q_offset": fops.attention.OFFSET_LAUNCHES,
                "flash_attention_zamba2_head_parallel":
                    by_form["flash_attention_zamba2_head_parallel"]}
    res = {"phase": "tp_kernels", "max_abs_err": err, "timings": timings, "launches": launches,
           "launches_by_form": by_form,
           "tolerance": {"slice": "2e-5 of the output's scale; lse 2e-5",
                         "merge": f"{TP_MERGE_TOL} of the output's scale vs the plain merge",
                         "merged_bf16": "one bf16 ulp + 2e-5 of one whole call",
                         "flash_q_offset": "bit for bit the full call's rows; "
                                           "2**-7 * attn(q, k, |v|) + one bf16 ulp + 2e-5"},
           "seconds": time.perf_counter() - t0}
    _emit(res)
    _require(all(by_form.values()), f"tp_kernels: a form was never launched: {by_form}")
    return res


def _flash_bf16_check_offset(got, q, k, v, fref, q_offset, what, window=None):
    """The bf16 flash kernel's rows at ``q_offset`` (over a ``window``
    where there is one) against the plain version: |got - want| <= 2**-7 *
    attn(q, k, |v|) + one bf16 ulp + 2e-5. Returns (max |d|, the largest
    share of the bound)."""
    import torch

    g = got.float()
    w = fref.flash_attention_ref(q, k, v, causal=True, window=window, q_offset=q_offset).float()
    attn_abs = fref.flash_attention_ref(q.float(), k.float(), v.float().abs(), causal=True,
                                        window=window, q_offset=q_offset)
    ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    d = (g - w).abs()
    share = (d / (FLASH_BF16_P_ROUNDING * attn_abs + ulp + ATTN_F32_TOL)).max().item()
    _require(share <= 1.0, f"{what}: kernel != plain version, max |d| {d.max().item()}, "
                           f"{share} of the bound")
    return {"max_abs_err": d.max().item(), "share_of_bound": share}


def _flash_timing(fops, fref, shape, window=None, causal=True):
    """The bf16 flash kernel at a served shape ((B, H, KV, S, D), or (B, H,
    KV, Sq, Sk, D) for cross-attention): ``_flash_times`` on inputs drawn
    from a seed."""
    import torch

    B, H, KV, Sq, Sk, D = _flash_dims(shape)
    q, k, v = _attn_inputs(B, H, KV, Sq, D, dtype=torch.bfloat16, seed=0, Sk=Sk)
    return _flash_times(fops, fref, q, k, v, window, causal)


def _flash_times(fops, fref, q, k, v, window=None, causal=True):
    """The bf16 flash kernel on q (B, H, Sq, D) and k, v (B, KV, Sk, D),
    causal, over a sliding ``window`` or, with ``causal`` False, over every
    key: device and call times, the plain version's time, SDPA's (causal,
    with the window's boolean mask, or unmasked; GQA) and the bound, whose
    products count the (query, key) pairs the mask keeps and whose bytes
    are q, k, v and o once."""
    import torch
    import torch.nn.functional as F

    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    shape = (B, H, KV, Sq, D) if Sq == Sk else (B, H, KV, Sq, Sk, D)
    if not causal:
        pairs = Sq * Sk
        lib = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True), 5, 3)
        library = "scaled_dot_product_attention(enable_gqa=True)"
    elif window is None:
        pairs = Sq * (Sq + 1) / 2
        lib = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                  enable_gqa=True), 5, 3)
        library = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
    else:
        S = Sq
        w = min(window, S)
        pairs = w * (w + 1) / 2 + (S - w) * w
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        lib = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                  enable_gqa=True), 5, 3)
        library = "scaled_dot_product_attention(attn_mask=the window's (S, S) mask, enable_gqa=True)"
    flash = {
        "shape": list(shape), "causal": causal, "window": window,
        **_device_ms(lambda: fops.attention(q, k, v, causal=causal, window=window), 5, 3),
        "plain_ms": _time_ms(lambda: fref.flash_attention_ref(q, k, v, causal=causal,
                                                              window=window), iters=3, warmup=1),
        "library": library, "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
        **_bound((2 * B * H * Sq * D + 2 * B * KV * Sk * D) * 2, 4 * B * H * D * pairs,
                 HW.peak_flops),
    }
    flash["achieved_tflop_s"] = flash["flops"] / (flash["ms"] * 1e-3) / 1e12
    flash["share_of_bound"] = flash["bound_ms"] / flash["ms"]
    flash["ms_over_library_ms"] = flash["ms"] / flash["library_ms"]
    return flash


def _decode_timing(dops, dref, shape, p=None):
    """The bf16 decode kernel at a serve shape and pos ``p`` (T - 1 by
    default; past T on a sliding window's ring, where every slot counts):
    ``_decode_times`` on inputs drawn from a seed."""
    import torch

    q, k, v = _attn_inputs(*shape, dtype=torch.bfloat16, seed=1)
    return _decode_times(dops, dref, q[:, :, 0], k, v, shape[3] - 1 if p is None else p)


def _decode_times(dops, dref, q, k, v, p):
    """The bf16 decode kernel on q (B, H, D) and a cache k, v (B, KV, T, D)
    at pos ``p``: device and call times, the plain version's, SDPA's (key
    mask, GQA), the bound (the valid keys' bytes), and the other split
    count's time."""
    import torch
    import torch.nn.functional as F

    B, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    n_keys = min(p, T - 1) + 1
    pos = torch.tensor(p, dtype=torch.int32, device="cuda")
    mask = (torch.arange(T, device="cuda") <= p)[None, None, None, :]
    lib = _device_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                              enable_gqa=True))
    # the wrapper's n_splits for this card, and the other candidate (one CTA
    # an SM against two)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_splits = dops.choose_splits(B, KV, n_sm)
    alt = dops.choose_splits(B, KV, n_sm, ctas_per_sm=3 - dops.CTAS_PER_SM)
    decode = {
        "shape": [B, H, KV, T, D], "pos": p, **_device_ms(lambda: dops.decode(q, k, v, pos)),
        "plain_ms": _time_ms(lambda: dref.decode_ref(q, k, v, pos), iters=5),
        "library": "scaled_dot_product_attention(attn_mask=keys <= pos, enable_gqa=True)",
        "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
        **_bound((2 * B * KV * n_keys * D + 2 * B * H * D) * 2, 4 * B * H * n_keys * D,
                 HW.peak_flops),
        "n_splits": n_splits, "sm_count": n_sm, "other_n_splits": alt,
        "other_n_splits_ms": _device_ms(lambda: dops.decode(q, k, v, pos, n_splits=alt))["ms"],
    }
    decode["achieved_gb_s"] = decode["bytes_moved"] / (decode["ms"] * 1e-3) / 1e9
    decode["share_of_bound"] = decode["bound_ms"] / decode["ms"]
    decode["ms_over_library_ms"] = decode["ms"] / decode["library_ms"]
    return decode


def _scan_inputs(B, T, H, dtype, seed, state=False, strided=False):
    """r, k, v (B, T, H, 64) in ``dtype`` (with ``strided``, transposed views
    of (B, H, T, 64) tensors), log-decays over the model's whole clip range
    with both edges, a nonzero bonus u, and an initial state or None."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, H, T, 64) if strided else (B, T, H, 64)
    r, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))
    if strided:
        r, k, v = (a.transpose(1, 2) for a in (r, k, v))
    lo, hi = LOG_DECAY_CLIP
    logw = -torch.exp(torch.rand((B, T, H, 64), generator=g, device="cuda") * (hi - lo) + lo)
    logw.view(-1)[:2] = torch.tensor([-math.exp(hi), -math.exp(lo)], device="cuda")
    u = torch.randn((H, 64), generator=g, device="cuda") * 0.5
    s0 = torch.randn((B, H, 64, 64), generator=g, device="cuda") if state else None
    return r, k, v, logw, u, s0


def _scan_gap(got, got_s, want, want_s):
    """(max |d| of out, max |d| of out and state over their scales
    max(1, max |want|), passes): out within SCAN_TOL of its scale plus, in
    bf16, one bf16 ulp (one rounding of the float32 result); the state
    within SCAN_TOL of its scale."""
    import torch

    d = (got.float() - want).abs()
    scale, scale_s = max(1.0, want.abs().max().item()), max(1.0, want_s.abs().max().item())
    if got.dtype == torch.bfloat16:
        bound = SCAN_TOL * scale + _bf16_ulp(torch.maximum(got.float().abs(), want.abs()))
    else:
        bound = SCAN_TOL * scale
    d_s = (got_s - want_s).abs().max().item()
    ok = bool((d <= bound).all()) and d_s <= SCAN_TOL * scale_s
    return d.max().item(), max(d.max().item() / scale, d_s / scale_s), ok


def phase_kernel_scan(sops, sref):
    """The linear-scan kernel against both plain versions, the step oracle
    and the chunked scan (the CPU path), at the serve shape and ragged ones;
    times and the bound in bf16 at the serve shape."""
    import torch

    B, T, H, _ = SCAN_SHAPE
    cases = [  # (B, T, H, initial state, strided)
        (B, T, H, False, False), (2, 1, 4, True, False), (2, 100, 4, True, True),
        (1, 4097, 4, True, False), (2, 300, 1, False, False), (2, 17, 3, True, True),
    ]
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        worst_abs, worst_rel = 0.0, {"step": 0.0, "chunked": 0.0, "split": 0.0}
        for i, (b, t, h, state, strided) in enumerate(cases):
            r, k, v, logw, u, s0 = _scan_inputs(b, t, h, dtype, seed=10 + i, state=state,
                                                strided=strided)
            got, got_s = sops.rwkv6_scan(r, k, v, logw, u, 16, s0)
            again, again_s = sops.rwkv6_scan(r, k, v, logw, u, 16, s0)
            torch.cuda.synchronize()
            _require(_bits_equal(got, again) and _bits_equal(got_s, again_s),
                     f"rwkv6_scan {name} {(b, t, h)}: two calls differ")
            for plain, (want, want_s) in (
                ("step", sref.rwkv6_ref(r, k, v, logw, u, s0)),
                ("chunked", sref.rwkv6_chunked(r, k, v, logw, u, 16, s0)),
                ("split", sref.rwkv6_split_ref(r, k, v, logw, u, s0)),
            ):
                torch.cuda.synchronize()
                d_abs, d_rel, ok = _scan_gap(got, got_s, want, want_s)
                _require(ok, f"rwkv6_scan {name} {(b, t, h)} vs {plain}: max |d| {d_abs}, "
                             f"{d_rel} of the scale")
                worst_abs = max(worst_abs, d_abs)
                worst_rel[plain] = max(worst_rel[plain], d_rel)
            del got, got_s, want, want_s
        err[name] = {"max_abs": worst_abs, "max_over_scale": worst_rel}

    # times in bf16, the served dtype, at the serve shape
    bf16, size = torch.bfloat16, 2
    B, T, H, K = SCAN_SHAPE
    r, k, v, logw, u, _ = _scan_inputs(B, T, H, bf16, seed=0)
    n = B * T * H * K
    timing = {
        "shape": list(SCAN_SHAPE),
        **_device_ms(lambda: sops.rwkv6_scan(r, k, v, logw, u, 16), 5, 3),
        "plain_ms": _time_ms(lambda: sref.rwkv6_chunked(r, k, v, logw, u, 16), iters=2, warmup=1),
        "plain": "ref.rwkv6_chunked, chunks of 16 (the CPU path)",
        "ms_before": BEFORE_MS["rwkv6_scan"],
        "library_ms": None, "library": "none: no single PyTorch call computes the RWKV6 recurrence",
        # r, k, v and out in bf16, logw float32, u, the float32 final state;
        # per token and head 5*K*V flops of readout and update, plus the bonus
        **_bound(4 * n * size + n * 4 + H * K * 4 + B * H * K * K * 4,
                 B * T * H * (5 * K * K + 3 * K + 2 * K)),
    }
    timing["share_of_bound"] = timing["bound_ms"] / timing["ms"]
    # a block of THREADS per (batch, head), BLOCKS_PER_SM an SM (the kernel's launch bounds;
    # scan_variants.py reads the occupancy API)
    timing["threads_per_bh"] = sops.THREADS
    timing["warps_per_bh"] = sops.THREADS // 32
    timing["warps_per_sm"] = sops.BLOCKS_PER_SM * sops.THREADS // 32
    res = {"phase": "kernel_scan", "cases": len(cases) * 2, "max_err": err,
           "tolerance": {"float32": f"{SCAN_TOL} of the scale",
                         "bfloat16": f"{SCAN_TOL} of the scale + one bf16 ulp"},
           "timings": {"rwkv6_scan": timing}}
    _emit(res)
    return res


def _ptxas_kernels(so, rename):
    """Per kernel of a library, from its build log (ptxas -v): registers,
    stack, spills and static shared memory; ``rename`` turns a mangled name
    into a short one."""
    import re

    kernels, name = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = rename(m.group(1))
            kernels[name] = {}
        elif name and "bytes stack frame" in line:
            st, ss, sl = (int(x) for x in re.findall(r"(\d+) bytes", line)[:3])
            kernels[name].update(stack_bytes=st, spill_store_bytes=ss, spill_load_bytes=sl)
        elif name and "Used" in line and "registers" in line:
            kernels[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return kernels


def _flash_build_facts(fops, build):
    """The flash library as built: per kernel, ptxas's facts, its dynamic
    shared memory, and the HGMMA (wgmma) and HMMA (mma.sync) instructions in
    the library's SASS (cuobjdump)."""
    import re
    import shutil

    def rename(mangled):
        m = re.search(r"(flash_fwd\w*?)I(f?)Li(\d+)E(?:Lb([01])E)?", mangled)
        if not m:
            return mangled
        return (f"{m.group(1)}<{'float, ' if m.group(2) else ''}{m.group(3)}"
                f"{', window' if m.group(4) == '1' else ''}>")

    so = build.library_path(fops._SRC)
    kernels = _ptxas_kernels(so, rename)
    lib = fops.build()
    for dtype, keys in ((0, ("flash_fwd<float, {}>",)),
                        (1, ("flash_fwd_wgmma<{}>", "flash_fwd_wgmma<{}, window>"))):
        for d in fops.HEAD_DIMS:
            for key in keys:
                kernels.setdefault(key.format(d), {})["dynamic_smem_bytes"] = (
                    lib.flash_attention_smem_bytes(dtype, d))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return {"library": so.name, "kernels": kernels,
            "sass_hgmma": len(re.findall(r"\bHGMMA\b", sass)),
            "sass_hmma": len(re.findall(r"\bHMMA\b", sass))}


def _decode_build_facts(dops, build):
    """The decode library as built: per instantiation decode_attn<type, D,
    kG>, ptxas's facts and the ring's dynamic shared memory."""
    import re

    def rename(mangled):
        m = re.search(r"(decode_attn)I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", mangled)
        if not m:
            return mangled
        dtype = "float" if m.group(2) == "f" else "bf16"
        return f"{m.group(1)}<{dtype}, {m.group(3)}, {m.group(4)}>"

    so = build.library_path(dops._SRC)
    kernels = _ptxas_kernels(so, rename)
    ring = dops.build().decode_attention_smem_bytes()
    for facts in kernels.values():
        facts["dynamic_smem_bytes"] = ring
    return {"library": so.name, "kernels": kernels}


def _scan_agg_build_facts(sops, ops, qops, build):
    """The linear-scan, aggregation and codec libraries as built: per
    kernel, ptxas's facts."""
    import re

    def rename(mangled):
        m = re.search(r"(rwkv6_scan_kernel)I(f|13__nv_bfloat16)E", mangled)
        if m:
            return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}>"
        m = re.search(r"(ipls_aggregate_batched(?:_q)?_kernel)(?:ILi(\d+)E)?", mangled)
        if m:
            return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"((?:de)?quantize_kernel)", mangled)
        return m.group(1) if m else mangled

    return {lib: {"library": build.library_path(mod._SRC).name,
                  "kernels": _ptxas_kernels(build.library_path(mod._SRC), rename)}
            for lib, mod in (("linear_scan", sops), ("ipls_aggregate", ops), ("quantize", qops))}


def phase_analysis(root, built) -> dict:
    """The port's static analysis on the checkout (``root``): its findings
    over the port's tree, which must be none, and per kernel what the CUDA
    pack folded from the sources beside what ``nvcc`` built (``built``:
    library -> the build phase's facts). Requires every folded dynamic
    shared-memory figure to equal the library's exported one and every
    folded static figure ptxas's, static plus
    dynamic shared memory within the card's opt-in maximum a block, and
    registers x ``__launch_bounds__`` threads within the 65,536 registers
    of an SM. A folded figure that disagrees with nvcc is a bug in the
    analyzer's constant folder."""
    import torch
    from repro_torch.analysis import analyze_paths, default_paths
    from repro_torch.analysis.core import CudaContext, iter_source_files
    from repro_torch.analysis.rules_cuda import kernel_facts

    t0 = time.perf_counter()
    paths = default_paths(root)
    findings = analyze_paths(paths)
    seconds = time.perf_counter() - t0
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    kernels = {}
    for lib, facts in built.items():
        src = root / "src" / "repro_torch" / "kernels" / lib / "csrc" / f"{lib}.cu"
        for name, folded in kernel_facts(CudaContext(str(src), src.read_text())).items():
            threads = folded["launch_bounds_threads"]
            dyn = folded["dynamic_smem_bytes"]
            insts = {k: v for k, v in facts["kernels"].items()
                     if k.split("<")[0] == name and "registers" in v}
            _require(insts, f"analysis: {lib}'s build log has no kernel {name}")
            rows = {}
            for inst, b in insts.items():
                exported = b.get("dynamic_smem_bytes")
                for d in dyn:
                    _require(not isinstance(d, int) or exported is None or d == exported,
                             f"analysis: {inst}'s folded dynamic shared memory {d} != the "
                             f"library's {exported}")
                dyn_bytes = exported if exported is not None else (
                    max(dyn) if all(isinstance(d, int) for d in dyn) else None)
                if dyn_bytes is not None:
                    _require(b["static_smem_bytes"] + dyn_bytes <= optin,
                             f"analysis: {inst} needs {b['static_smem_bytes']} + {dyn_bytes} "
                             f"bytes of shared memory, the card allows {optin} a block")
                _require(isinstance(threads, int) and b["registers"] * threads <= 65536,
                         f"analysis: {inst}: {b['registers']} registers x {threads} threads")
                _require(folded["static_smem_bytes"] in ("unresolved", b["static_smem_bytes"]),
                         f"analysis: {inst}'s folded static shared memory "
                         f"{folded['static_smem_bytes']} != ptxas's {b['static_smem_bytes']}")
                rows[inst] = {
                    "registers": b["registers"], "registers_x_threads": b["registers"] * threads,
                    "static_smem_bytes": b["static_smem_bytes"], "dynamic_smem_bytes": exported,
                    "smem_checked_bytes": (None if dyn_bytes is None
                                           else b["static_smem_bytes"] + dyn_bytes),
                    "static_smem_agrees": (None if not isinstance(folded["static_smem_bytes"], int)
                                           else folded["static_smem_bytes"]
                                           == b["static_smem_bytes"]),
                }
            kernels[name] = {"library": lib, "folded": folded, "built": rows}
    res = {"phase": "analysis", "findings": len(findings), "seconds": seconds,
           "files": sum(1 for _ in iter_source_files(paths)), "smem_per_block_optin": optin,
           "kernels": kernels, "first_findings": [f.render() for f in findings[:5]]}
    _emit(res)
    _require(not findings, f"analysis: {len(findings)} finding(s) on the port's tree")
    return res


def _memory(after: str) -> None:
    """A line with the device memory still allocated after a phase (what the
    next phase's ``base`` holds)."""
    import torch

    torch.cuda.synchronize()
    _emit({"phase": "memory", "after": after, "allocated": torch.cuda.memory_allocated(),
           "reserved": torch.cuda.memory_reserved()})


def main() -> int:
    t_run = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    global HW
    from repro_torch import checkpoint, configs, data, device, fl, optim, serve_lm, telemetry, tree
    from repro_torch.roofline import HW
    from repro_torch.core import sharded
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ipls_aggregate import ops, ref
    from repro_torch.kernels.linear_scan import ops as sops
    from repro_torch.kernels.linear_scan import ref as sref
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.launch import mesh, steps
    from repro_torch.models import layers, mlp_mnist, ssm
    from repro_torch.p2p import network

    mods = {"data": data, "fl": fl, "telemetry": telemetry, "network": network,
            "mlp_mnist": mlp_mnist}
    kmods = {
        "ipls_aggregate_batched": ops.aggregate_batched,
        "ipls_aggregate_batched_q": ops.aggregate_batched_q,
        "quantize": qops.quantize,
        "dequantize": qops.dequantize,
        "flash_attention": fops.attention,
        "decode_attention": dops.decode,
        "rwkv6_scan": sops.rwkv6_scan,
    }
    lm = {"configs": configs, "device": device, "serve_lm": serve_lm, "layers": layers,
          "steps": steps, "build": _build, "mesh": mesh}
    tr = {"configs": configs, "sharded": sharded, "steps": steps, "mesh": mesh, "optim": optim,
          "checkpoint": checkpoint, "tree": tree, "data": data, "layers": layers,
          "telemetry": telemetry, "ssm": ssm, "scan_ref": sref, "serve_lm": serve_lm}
    roof = _Roofline(src, _roofline_cells(configs, steps.TRAIN_OVERRIDES))  # CPU, beside the phases
    atexit.register(roof.close)  # stopped however the run ends
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    meta = telemetry.host_metadata()
    _emit({"phase": "device", "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi, **meta})

    def timed_build(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    libs = {"ipls_aggregate": ops, "quantize": qops, "flash_attention": fops,
            "decode_attention": dops, "linear_scan": sops}
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:  # one nvcc per source, at once
        futs = {k: pool.submit(timed_build, mod) for k, mod in libs.items()}
        build_s = {k: f.result() for k, f in futs.items()}
    flash_built = _flash_build_facts(fops, _build)
    decode_built = _decode_build_facts(dops, _build)
    others_built = _scan_agg_build_facts(sops, ops, qops, _build)
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_library_s": build_s,
           "flash_attention": flash_built, "decode_attention": decode_built, **others_built})
    _require(flash_built["sass_hgmma"] > 0, "no HGMMA in the flash library's SASS")
    phase_analysis(src.parent, {"flash_attention": flash_built,
                                "decode_attention": decode_built, **others_built})

    # the engine phases first: the timing phases below leave cuBLAS
    # workspaces of their graph captures allocated, which would count in
    # the main paths' peak memory
    phase_agree(mods)
    _memory("agree")
    none = dict.fromkeys(kmods, 0)
    rounds = MAIN_CFG["rounds"]
    main_f32 = phase_main(mods, kmods, "main", {}, MAIN_SHAPE,
                          dict(none, ipls_aggregate_batched=rounds))
    _memory("main")
    # per round: quantize the delta plane once and qdq_rows twice (V before
    # the round, V_agg after aggregation), one quantized aggregation
    main_q = phase_main(
        mods, kmods, "main_int8", dict(wire_dtype="int8", conditions=network.LOSSY),
        MAIN_Q_SHAPE,
        dict(none, ipls_aggregate_batched_q=rounds, quantize=3 * rounds, dequantize=2 * rounds),
    )
    _memory("main_int8")
    main_w = phase_window(mods, kmods, "main_window", {}, MAIN_WINDOW, MAIN_SHAPE,
                          {"ipls_aggregate_batched": 1})
    _memory("main_window")
    main_qw = phase_window(
        mods, kmods, "main_int8_window", dict(wire_dtype="int8", conditions=network.LOSSY),
        MAIN_Q_WINDOW, MAIN_Q_SHAPE,
        {"ipls_aggregate_batched_q": 1, "quantize": 3, "dequantize": 2},
    )
    _memory("main_int8_window")
    main_churn = phase_churn(
        mods, kmods, "main_churn", dict(wire_dtype="int8", conditions=network.LOSSY),
        MAIN_CHURN, MAIN_Q_SHAPE,
        {"ipls_aggregate_batched_q": 1, "quantize": 3, "dequantize": 2},
    )
    _memory("main_churn")
    main_tel = phase_telemetry(mods, kmods, [
        ("main_int8", dict(wire_dtype="int8", conditions=network.LOSSY), MAIN_Q_WINDOW,
         {"ipls_aggregate_batched_q": 1, "quantize": 3, "dequantize": 2}, TEL_SCALAR_ROUNDS),
        ("main", {}, MAIN_WINDOW, {"ipls_aggregate_batched": 1}, 0),
    ])
    _memory("main_telemetry")
    phase_baselines(mods, main_f32)
    _memory("baselines")
    phase_lm_agree(lm, kmods)
    _memory("lm_agree")
    phase_train_agree(tr, kmods)
    _memory("train_agree")
    measured = {}  # each cell's measured step, seconds: beside its roofline
    for cell in (TRAIN,) + TRAIN_CELLS:
        measured[cell["phase"]] = phase_train(tr, kmods, cell)["step_s_median_after_first"]
        _memory(cell["phase"])
    phase_moe_ep(tr)
    _memory("moe_ep")
    phase_mla_cp(tr)
    _memory("mla_cp")
    ssm_tp = phase_ssm_tp(tr, sops, sref)
    _memory("ssm_tp")
    whisper_tp = phase_whisper_tp(tr, dops, dref, fops)
    _memory("whisper_tp")
    tp_whole = phase_tp_whole(tr, dops, dref, fops, fref)
    _memory("tp_whole")
    torch.distributed.destroy_process_group()  # the smoke mesh's one-process group
    served = {}
    for name, spec, n_params, bounds, kw in SERVE_PHASES:
        served[name] = phase_serve(lm, kmods, name, spec, n_params, bounds, **kw)
        _memory(name)
    measured.update((name, o["decode_ms_per_step"] * 1e-3) for name, o in served.items())
    phase_serve_steps(lm, kmods, SERVE_STEPS)
    _memory("serve_steps")
    longs = {}
    for cell in LONG_CELLS:
        longs[cell["phase"]] = phase_long(lm, kmods, dops, dref, fops, fref, cell, roof)
        measured[cell["phase"]] = longs[cell["phase"]]["replayed_ms_per_step"] * 1e-3
        _memory(cell["phase"])
    for cell, seconds in measured.items():  # each measured step beside its roofline
        _emit({"phase": "roofline", "cell": cell, **_roofline_line(roof.get(cell), seconds)})
    kern = phase_kernel(ops, ref)
    kern_q = phase_kernel_q(qops, qref, ops, ref)
    kern_attn = phase_kernel_attn(fops, fref, dops, dref)
    kern_tp = phase_tp_kernels(fops, fref, dops, dref)
    kern_scan = phase_kernel_scan(sops, sref)

    t = kern_q["timings"]
    agg_q = t["aggregate_batched_q@{}x{}x{}".format(*MAIN_Q_SHAPE)]
    rows = [
        ("ipls_aggregate_batched", "ipls_aggregate/csrc/ipls_aggregate.cu",
         "kernels/ipls_aggregate/ipls_aggregate.py:150", main_f32, kern["max_abs_err"], kern),
        ("ipls_aggregate_batched_q", "ipls_aggregate/csrc/ipls_aggregate.cu",
         "kernels/ipls_aggregate/ipls_aggregate.py:245", main_q,
         kern_q["max_abs_err"]["ipls_aggregate_batched_q"], agg_q),
        ("quantize", "quantize/csrc/quantize.cu", "kernels/quantize/quantize.py:62", main_q,
         kern_q["max_abs_err"]["quantize"], t[f"quantize@{DELTA_PLANE}"]),
        ("dequantize", "quantize/csrc/quantize.cu", "kernels/quantize/quantize.py:107", main_q,
         kern_q["max_abs_err"]["dequantize"], t[f"dequantize@{VALUE_PLANE}"]),
    ]
    fa = kern_attn["max_abs_err"]["flash_attention"]
    ta = kern_attn["timings"]

    def reading(key, name, phase, kind=None):
        """A kernel's reading at another served shape, beside its row: its
        launches on that serve phase's path (those of one ``kind`` of call
        where the path has several: flash by window, decode by cache slots),
        its times and bound."""
        tm, path = ta[key], served[phase]
        n = path["launches"][name] if kind is None else path["launches_by_shape"][name][kind]
        return {"launches": n, "path": path["phase"],
                **{k: tm[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "share_of_bound")}}

    # the other served shapes' readings: (the serve phase, the kind of call)
    shape_paths = {
        "flash_attention_d64": ("serve_moe", None),
        "flash_attention_d256": ("serve_gemma3", "causal"),
        "flash_attention_d256_window": ("serve_gemma3", f"window {FLASH_WINDOW}"),
        "flash_attention_whisper_encoder": ("serve_whisper", "non-causal"),
        "flash_attention_whisper_self": ("serve_whisper", "causal"),
        "flash_attention_whisper_cross": ("serve_whisper", "cross"),
        "flash_attention_qwen2_vl": ("serve_qwen2_vl", None),
        "decode_attention_d64": ("serve_moe", None),
        "decode_attention_d256": ("serve_gemma3", f"{DECODE_D256_SHAPE[3]} slots"),
        "decode_attention_d256_ring": ("serve_gemma3", f"{DECODE_RING_SHAPE[3]} slots"),
        "decode_attention_whisper_self": ("serve_whisper", f"{DECODE_WHISPER_SELF_SHAPE[3]} slots"),
        "decode_attention_whisper_cross": ("serve_whisper",
                                           f"{DECODE_WHISPER_CROSS_SHAPE[3]} slots"),
        "decode_attention_qwen2_vl": ("serve_qwen2_vl", None),
    }

    def other_shapes(key, name):
        """head_dim 64 (serve_moe's shapes), 256 (serve_gemma3's: flash
        causal and over the 512-key window, decode on the full cache and on
        a wrapped ring), whisper's (flash in the encoder, the decoder's
        self-attention and the cross-attention, decode on the self and the
        cross caches) and
        qwen2-vl's (8 query heads a kv head)."""
        return {k[len(key) + 1:]: reading(k, name, *shape_paths[k]) for k in ta
                if k.startswith(f"{key}_")}

    rows += [
        # flash: its bf16 cases (the served and timed dtype) against the plain version
        ("flash_attention", "flash_attention/csrc/flash_attention.cu",
         "kernels/flash_attention/flash_attention.py:74", served["serve"], fa["bfloat16"],
         ta["flash_attention"],
         {"max_abs_err_of": "bfloat16", "err_share_of_tolerance": fa["bfloat16_share_of_bound"],
          **other_shapes("flash_attention", "flash_attention"),
          # at the long_500k prefill's shapes (long_gemma3): launches by mask
          **{f"{name}_{kind}": {"path": name, **fk}
             for name, o in longs.items() for kind, fk in o.get("flash_kernel", {}).items()},
          # a rank's query head over a whole 4,100-row prompt (tp_whole)
          "tp_whole_rank_head": {
              "path": "tp_whole", "launches": tp_whole["launches_by_form"][
                  "flash_attention_rank_head"],
              "largest_share_of_bf16_bound":
                  tp_whole["calls_vs_plain"]["flash_largest_share_of_bound"],
              **tp_whole["flash_attention_rank_head"]}}),
        # decode: its float32 cases (the bf16 ones within one bf16 ulp)
        ("decode_attention", "decode_attention/csrc/decode_attention.cu",
         "kernels/decode_attention/decode_attention.py:67", served["serve"],
         kern_attn["max_abs_err"]["decode_attention"]["float32"],
         ta["decode_attention"],
         {"max_abs_err_of": "float32", "share_of_bound": ta["decode_attention"]["share_of_bound"],
          **other_shapes("decode_attention", "decode_attention"),
          # on the long_500k cells' own caches at pos 524,287
          **{name: {"launches": o["launches"]["decode_attention"], "path": name,
                    "max_abs_err": o["decode_kernel"]["max_abs_err"],
                    **{k: o["decode_kernel"][k] for k in ("shape", "ms", "call_ms", "plain_ms",
                                                          "bound_ms", "bound_by", "library_ms",
                                                          "share_of_bound")}}
             for name, o in longs.items() if "decode_kernel" in o},
          # a rank's query heads over one kv head's strided slice of a whole
          # 4,104-slot cache, and straddled heads (tp_whole)
          **{f"tp_whole_{form}": {
              "path": "tp_whole", "launches": tp_whole["launches_by_form"][
                  f"decode_attention_{form}"],
              "largest_max_abs_err": tp_whole["calls_vs_plain"]["decode_largest_max_abs_err"],
              **tp_whole[f"decode_attention_{form}"]} for form in ("one_kv_head", "straddle")}}),
    ]
    # the forms of a "model" axis above 1 (tp_kernels: their launches are that
    # phase's, as the model-axis-1 paths above take neither)
    tpe, tpt, tp_forms = kern_tp["max_abs_err"], kern_tp["timings"], kern_tp["launches_by_form"]
    rows += [
        ("decode_attention_partial", "decode_attention/csrc/decode_attention.cu",
         "kernels/decode_attention/decode_attention.py:67", kern_tp,
         max(e["merged_bf16_vs_whole_call"] for e in tpe["decode_attention_partial"].values()),
         tpt["decode_attention_partial_16x8"],
         {"max_abs_err_of": "the merged partials rounded to bf16 against one whole call",
          "share_of_bound": tpt["decode_attention_partial_16x8"]["share_of_bound"],
          "phi4_mini": tpt["decode_attention_partial_24x8"],
          "gemma3_ring": {"launches": tp_forms["decode_attention_partial_ring"],
                          **tpt["decode_attention_partial_ring"]},
          "zamba2": {"launches": tp_forms["decode_attention_partial_zamba2"],
                     **tpt["decode_attention_partial_zamba2"]},
          # whisper-base's self cache over 16 ranks (whisper_tp: every rank's
          # launch in its decode step), and the long caches over the 256 ranks
          # of ("data", "model") (long_gemma3, long_zamba2: each slice)
          "whisper_self": {"path": "whisper_tp",
                           "max_abs_err": whisper_tp["partial_vs_plain"]["out_of_scale"],
                           **whisper_tp["decode_attention_partial"]},
          **{f"{name}_{kind}": {"path": name, "launches": cp["launches"],
                                "max_err_in_row_ulps":
                                    cp["merged_vs_whole_call"]["max_err_in_row_ulps"],
                                **cp["timing"]}
             for name, o in longs.items() for kind, cp in o.get("cp_slices", {}).items()},
          "checks": tpe["decode_attention_partial"]}),
        ("flash_attention_q_offset", "flash_attention/csrc/flash_attention.cu",
         "kernels/flash_attention/flash_attention.py:74", kern_tp,
         max(t["max_abs_err"] for e in tpe["flash_attention_q_offset"].values()
             for k, t in e.items() if k.startswith("tile")),
         tpt["flash_attention_q_offset"],
         {"max_abs_err_of": "bfloat16 rows against the plain version",
          "share_of_bound": tpt["flash_attention_q_offset"]["share_of_bound"],
          "gemma3_window": {"launches": tp_forms["flash_attention_q_offset_window"],
                            **tpt["flash_attention_q_offset_window"]},
          "zamba2_head_parallel": {
              "launches": tp_forms["flash_attention_zamba2_head_parallel"],
              "max_abs_err": tpe["flash_attention_zamba2_head_parallel"]["plain"][0],
              **tpt["flash_attention_zamba2_head_parallel"]},
          "checks": tpe["flash_attention_q_offset"]}),
    ]
    rows.append(("rwkv6_scan", "linear_scan/csrc/linear_scan.cu",
                 "kernels/linear_scan/linear_scan.py:77", served["serve_rwkv"],
                 kern_scan["max_err"]["float32"]["max_abs"], kern_scan["timings"]["rwkv6_scan"],
                 # on a rank's 4 of 64 heads over the model axis of 16 (ssm_tp)
                 {"model_axis_rank": {"path": "ssm_tp", **ssm_tp["scan_kernel"]}}))
    _emit({"kernels": [{
        "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
        "replaces": f"src/repro/{replaces}", "path": path["phase"],
        "launches": path["launches"][name], "max_abs_err": err, "ms": tm["ms"],
        "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
        "window_launches": {w["phase"]: w["launches"].get(name, 0)
                            for w in (main_w, main_qw, main_churn, main_tel)},
        "launches_through_decode_graph_replays":
            path.get("decode_graph", {}).get("launches_counted", {}).get(name, 0),
        **dict(*extra),
    } for name, source, replaces, path, err, tm, *extra in rows]})
    _emit({"phase": "run", "seconds": time.perf_counter() - t_run})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
