#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON object on a line of its own:

1. ``device``     card name and power limit as ``nvidia-smi`` gives them,
                  torch / CUDA / nvcc versions;
2. ``build``      ``nvcc`` builds ``libconv2d_stream.so``,
                  ``libflash_attention.so``, ``libflash_attention_bwd.so``,
                  ``libfused_mlp.so``, ``libfused_mlp_bwd.so``,
                  ``libmamba2_ssd.so`` and ``libmamba2_ssd_bwd.so`` from
                  the sources in the checkout,
                  all at once (seconds taken);
3. ``kernel_check``  the hand-written streaming-conv kernel against its plain
                  PyTorch version on the card: integer dtypes bit-exact
                  (int32 wrap-around included), f32 within atol 1e-4 /
                  rtol 1e-2 and bf16 within atol 1e-2 / rtol 1e-2 (the sums
                  are taken in another order), over dtype × kernel size,
                  odd shapes, stride 1-3 × SAME/VALID/explicit pads × both
                  epilogues × batch {1, 5, 32} × rows_per_block {1, 2,
                  planner's}, strided weight slices, the Dense-as-1×1
                  form (Cin to 4096), Cin across the 8-channel chunks (17,
                  33, 136, 288) × Cout off the tiles (136, 6, 10), int32
                  wrap at the wide tiles, and every register tile × both
                  operand routes on the same inputs (f32: the same bits
                  under every plan); then timed by CUDA events at the main
                  path's shapes beside the plain version, the roofline
                  bound (int32 at the CUDA cores' integer rate) and, for
                  float shapes, ``F.conv2d`` (cuDNN, TF32 off) as
                  yardstick, with the planner's host time per shape;
4. ``main_path``  compile the model zoo and the partitioned / weight-streamed
                  showcases for KV260, run each on the card (the showcases
                  also five warm runs, timed, and the conv kernel's device
                  time per run), compare with
                  the port's own ``device="cpu"`` run (bit-exact: the data is
                  int32), and batched (``vmap``) against the per-sample loop, for int32
                  and for f32 data (bit-exact both);
5. ``serve``      ``ServeEngine`` answers 256 requests per zoo model (16 for
                  ``deep_cascade_224``) from the open-loop load generator;
                  every answer must equal the direct run;
6. ``frontends``  the ONNX goldens (``tests/golden/lenet5.onnx``,
                  ``resnet_tiny.onnx``) imported, compiled for KV260 and
                  ZU3EG and run on the card with their weights: bit-exact
                  with the NumPy NCHW oracles of ``tests/_onnx_fixture.py``
                  and with the port's ``device="cpu"`` run; every zoo model
                  through its model card, bit-exact with the builder
                  graph's run (``card_json("lenet5")`` must be
                  ``examples/lenet5.json``); an ONNX model at
                  ``deep_cascade_224``'s widths (int8 input 1×3×224×224,
                  (Conv 3×3 + bias, Relu) × 4 at 3→136→136→136→136,
                  MaxPool 8×8, seeded weights) imported from a file,
                  partitioned for KV260, bit-exact with its CPU run
                  (int32, wrapping), five warm calls timed;
7. ``cli``        ``python -m repro_torch``'s ``main`` in process: ``list``,
                  ``zoo --export``, ``compile resnet_tiny.onnx --run``,
                  ``compile deep_cascade_224 --emit --run --trace``, ``lint
                  --all`` and ``profile deep_cascade_224`` for both targets
                  (5 reps, ``--json chiprun_out/chip_smoke/profile.json``),
                  each exiting 0; the profile measured on the card, every
                  group above 0 ms, its provenance naming the card;
8. ``attn_check`` the hand-written flash-attention kernel against its plain
                  PyTorch version on the card, f32 (CUDA cores) within atol
                  = rtol = 2e-5 and bf16 (tensor cores) within 3e-2 (the
                  reference's tolerances), over the llama3.2-1b /
                  qwen2-0.5b prefill shapes (B 4, S 1024), D 128 (yi-9b),
                  GQA group 1 (olmoe, 16/16 heads of 128), granite-moe's
                  prefill (16/8 heads of 64), Jamba's (64/8 heads of 128,
                  GQA group 8), the seamless encoder (16/16 heads of 64,
                  not causal), causal and not, a query offset, ragged
                  lengths (100, 1000), D 40 and B 1 S 1, and what a rank
                  launches where only the query heads divide ``model`` =
                  16 (llama3.2-1b 2 on 1 kv head, nemotron-4-15b 3 on 1,
                  3 on 3 where a rank's heads straddle two kv heads); then
                  timed at the model and rank shapes beside the plain
                  version, the roofline bound and
                  ``F.scaled_dot_product_attention`` as yardstick;
8b. ``attn_bwd_check`` the hand-written attention backward kernel against
                  its plain version on the card, on (q, k, v, out, lse,
                  dout) with out and lse from the forward kernel: f32
                  (CUDA cores) within atol = rtol = 2e-4 (the reference's
                  streaming-backward tolerance) and bf16 (tensor cores)
                  within 2e-2·|plain| + 1e-2·max|plain|, causal and not, a
                  query offset, GQA groups 1/4/8, head dim 16-128, ragged
                  Sq / Sk, rows that see no key, llama3.2-1b's and
                  granite-moe's train shapes (B 4, 32/8 and 16/8 heads of
                  64, S 4096) and qwen2-0.5b's (14/2 heads, S 1024), a q
                  2 bytes off 16; each row naming the
                  planner's route (bf16: "wgmma" at heads of 64 and 128,
                  "mma" at 16, 40 and for the unaligned q); two runs the
                  same bits; the forward's lse against the plain
                  forward's; at llama3.2-1b's train shape planted faults
                  (a skipped key tile, a stale ring slot, ...) failing the
                  rule, and a call timed beside the plain version, the
                  bound, the design's floor and SDPA's backward as
                  yardstick, with each kernel's device ms and TFLOP/s,
                  there and at the rank shapes of ``attn_check`` (B 4, S
                  4096);
9. ``mlp_check``  the hand-written fused-MLP kernel against its plain
                  PyTorch version on the card, f32 (CUDA cores) within atol
                  = rtol = 5e-4 and bf16 (tensor cores, a cluster per row
                  tile) within 1e-2, gated and ungated, the four
                  activations, M 1-4096, every MLP width of the ten configs
                  (D 896-8192, F to 29568; one D past the limit must
                  raise), odd D and F, weights off 16-byte alignment; then
                  timed at llama3.2-1b's prefill and decode shapes beside
                  the plain version, the roofline bound and the dense MLP
                  (three cuBLAS matmuls) as yardstick;
9b. ``mlp_bwd_check`` the hand-written fused-MLP backward (three kernels:
                  the hidden's h, du and dg, the weight gradients, dx)
                  against its plain version on the card, f32 (CUDA cores)
                  and bf16 (tensor cores, h, du and dg as hi + lo: wgmma
                  fed by TMA, or mma.sync where TMA cannot read an
                  operand — each row names the planner's route), every
                  activation gated and ungated, ragged M, odd D and F, an
                  x 2 bytes off 16, and llama3.2-1b's train microbatch (M
                  16384, D 2048, F 8192); per element |err| ≤ tol·|plain|
                  + tol·(its row's scale), ``MLP_TOL``; two runs the same
                  bits; at the train shape in bf16 three planted faults
                  (``MLP_BWD_FAULTS``) must fail the
                  rule and the kernels keep within the hi + lo bound (each
                  of h, du, dg in bf16 alone must exceed it), and a call
                  is timed beside the plain version, the bound, the
                  design's floor (device ms per call and per kernel) and
                  autograd's backward of the dense MLP as yardstick;
10. ``mlp_probe`` where the bf16 fused MLP's time goes at llama3.2-1b's
                  prefill and decode shapes: the whole kernel timed beside
                  a timing build of the same source (``-DFUSED_MLP_PROBE``,
                  a library of its own that only this phase loads) with
                  its cluster exchange, its mma or its weight loads
                  switched off (those results are wrong and unchecked);
11. ``ssd_check`` the hand-written SSD kernel against its plain version on
                  the card, f32 (CUDA cores) within 1e-3 and bf16 (tensor
                  cores) within 1e-2 (final state 1e-3), chunks 1-1023, L
                  32-1024 with ragged tiles (37, 1023), B 1-4, P 7-64, N
                  8-128, x, b and c as strided column slices (x also off
                  16 bytes), the state carried across two calls (a random
                  initial state, a ragged split), Jamba's prefill (H 256,
                  P 64, N 128, L 1024, B 4); then timed at mamba2-1.3b's
                  and Jamba's prefill shapes, bf16 also under both tiles
                  of positions × heads a block the planner picks from (no
                  library call computes an SSD scan);
11b. ``ssd_bwd_check`` the hand-written SSD backward (two kernels: the
                  dS pass, then every tile in parallel) against its plain
                  version (autograd through ``ref.ssd_chunked``) on the
                  card, its tile states from the forward kernel (held to
                  the plain forward too), f32 and bf16, at
                  ``ssd_check``'s shapes (ragged L among them, from a
                  random initial state with a random cotangent of the
                  final state), x, b and c as strided slices, and
                  mamba2-1.3b's train microbatch (B 4, L 4096, H 64, P 64,
                  N 128); per element |err| ≤ rtol·|plain| + atol·(its
                  row's scale), (1e-4, 1e-4) in f32 and (1e-2, 1e-3) in
                  bf16; two runs the same bits; at the train shape in bf16
                  six faults planted in the kernels' gradients must fail
                  the rule, and a call is timed beside the plain version,
                  the bound and the design's floor (device ms per call
                  and per kernel), also under 2, 4, 8 and 16 heads a tile
                  block (no library call computes an SSD backward);
12. ``lm_serve``  the LM server at full width and depth: llama3.2-1b,
                  qwen2-0.5b, yi-9b and nemotron-4-15b (random bf16
                  weights from a seed, on the card; each engine freed
                  before the next) generate 32 tokens greedily for 4
                  prompts of 1024; prefill logits are held against the
                  same engine with ``attn_impl="blockwise"`` (yi-9b and
                  nemotron also in f32, on f32 weights of the same
                  seed); five prefills under the profiler split the
                  card's time between attention, matmuls and the rest,
                  beside their own wall time; llama3.2-1b and nemotron
                  also run one prefill and 8 decode steps with
                  ``mlp_impl="streamed"`` (the fused-MLP kernel, one
                  launch per layer and call — nemotron's ungated
                  squared-ReLU route — and one flash launch per layer of
                  the prefill), logits held against the dense engine,
                  and the prefill split the same way; then ``python -m
                  repro_torch.launch.serve --arch nemotron-4-15b`` in a
                  process of its own, on the card: exit 0, its stats;
13. ``ssm_serve`` mamba2-1.3b at full width and depth (random bf16 weights
                  from a seed) generates 32 tokens greedily for 4 prompts of
                  1024 (one SSD launch per layer of a prefill); one decode
                  step after a 1023-token prefill is held against a
                  1024-token prefill (the kernel's final state against the
                  recurrence), and at depth 2 the card's prefill logits
                  against the port's own CPU run on the same weights;
14. ``moe_serve`` granite-moe-1b-a400m and olmoe-1b-7b at full published
                  width and depth (random bf16 weights from a seed) generate
                  32 tokens greedily for 4 prompts of 1024, twice, the same
                  tokens (one flash launch per layer of a prefill); the
                  prefill split, peak memory and the share of (token,
                  choice) pairs each layer drops at the published capacity
                  factor; one decode step after a 1023-token prefill held
                  against a 1024-token prefill, drop-free (capacity factor
                  raised to E / k, so capacity = tokens); at depth 2 and
                  batch 2 the card's prefill logits against the port's own
                  CPU run, and the share of layer 0's routing choices the
                  two agree on, each flip named;
15. ``hybrid_serve`` Jamba's superblock (jamba-1.5-large-398b cut to one
                  superblock of 8 layers and d_ff 12288 — the published
                  shape holds ≈ 90 GB of bf16 weights — everything else
                  as published) serves as ``moe_serve`` does: one flash
                  and seven SSD launches a prefill, decode against
                  prefill drop-free, and the card against the CPU at a
                  width the CPU takes in seconds (d_model 1024, 8/1 heads
                  of 128, d_ff 2048; SSM heads of P 64 / N 128, 16 experts
                  top-2 and the 8-layer pattern kept);
16. ``encdec_serve`` seamless-m4t-medium at full width and depth: 4 × 1024
                  seeded stub frame embeddings → ``model_prefill`` (12
                  non-causal flash launches, the encoder's) → 31 greedy
                  ``model_decode`` steps against the self cache laid into
                  ``max_len`` by ``_expand_cache``, twice, the same tokens;
                  at depth 2 + 2 and batch 2 the card's prefill and four
                  decode steps against the port's own CPU run;
16a. ``vlm_serve`` qwen2-vl-72b's backbone at full width, 16 of its 80
                  layers (the 80 hold ≈ 143 GB of bf16 weights): seeded
                  (4, 1024, 8192) embeddings with (3, 4, 1024) M-RoPE
                  streams (text, a 28 × 28 image, text) through
                  ``steps.make_prefill_step`` (16 flash launches), then 32
                  ``make_decode_step`` steps, each fed a seeded (4, 1,
                  8192) embedding, twice, the same tokens; prefill logits
                  against ``attn_impl="blockwise"``; at depth 2, d_model
                  256 and batch 2 the card's prefill and four decode
                  steps against the port's own CPU run;
16b. ``int8_serve`` llama3.2-1b and nemotron-4-15b at full width and
                  depth served with
                  ``ServeEngine(int8_weights=True)`` (quantized once on the
                  card, dequantized to bf16 in each call), 4 × 1024-token
                  prompts + 32 greedy tokens: its quantization equals
                  ``quantize_params`` of the weights drawn again, leaf by
                  leaf, and for llama ``quantize_params`` on the
                  card gives the CPU's bits (q and scale) on one
                  superblock's leaves and the embedding; its prefill
                  logits and tokens equal those of a bf16 engine handed
                  ``dequantize_params`` of its weights, bit for bit; one
                  flash launch per layer of a prefill; weight bytes, its
                  prefill and decode beside a bf16 engine on the original
                  weights, the dequantize ms a call, peak memory, and the
                  greedy agreement with the bf16 weights (no limit); its
                  flash launches are read after the int8 engine's own
                  calls, before the bf16 engines run;
17. ``lm_train``  llama3.2-1b's train step at full width and depth
                  (random bf16 weights from a seed, ``attn_impl="cuda"``,
                  remat on): five AdamW steps on one repeated batch of the
                  ported data pipeline, train_4k's sequence of 4096 and 8
                  rows as 2 microbatches of 4 (the gradient accumulation
                  on the card); losses finite and the last below the
                  first; 64 forward and 32 backward attention launches a
                  step and no other kernel; the last step run twice from
                  one state (the same bits?); one step profiled into
                  attention forward / backward / cuBLAS / other and idle;
                  then at depth 2 and d_model 256 one step on the card
                  against the port's own CPU run, f32 and bf16;
18. ``moe_train`` granite-moe-1b-a400m's train step, as ``lm_train``'s (96
                  forward and 48 backward attention launches a step), with
                  the share of (token, choice) pairs each MoE layer drops;
                  the CPU of the card-against-CPU step replays the card's
                  routing choices (its gates from its own logits);
17b. ``lm_train_streamed`` ``lm_train`` with ``mlp_impl="streamed"``: also
                  64 fused-MLP launches (B3) and 32 calls of its backward
                  (B3′) a step;
19. ``ssm_train`` mamba2-1.3b's train step, as ``lm_train``'s, through the
                  SSD kernel saving its tile states (192 launches a step)
                  and its backward (96 calls, each launching the dS pass
                  and the tile kernel);
20. ``encdec_train`` seamless-m4t-medium's train step at full width and
                  depth, as ``lm_train``'s, on the reference's train
                  mapping (8 rows of 4096 stub frames and 1024 targets):
                  144 forward and 72 backward attention launches a step
                  (12 encoder, 12 decoder self- and 12 cross-attention
                  layers); the card against the CPU at depth 2 + 2
                  and d_model 256;
21. ``hybrid_train`` Jamba's superblock at a width cut (d_model 1024, 8/1
                  heads of 128, d_ff 2048; the published width's training
                  state does not fit one card), as ``lm_train``'s: 4 + 2
                  attention and 28 + 14 SSD launches a step, the drops per
                  layer, the card against the CPU at d_model 256 with
                  the card's routing replayed;
22. ``train_resilient`` qwen2-0.5b at full width (d_model 896, tied
                  151936-token embedding), 6 of its 24 layers, through
                  ``launch.train.train`` (batch 4 × 1024, 8 steps, a
                  checkpoint every 4, lr 1e-3, seed 3) twice under
                  ``build/train_resilient/``: clean, then crashed at step
                  6 and restarted from step 4 — the same losses bit for
                  bit; a third call for 10 steps on the crashed run's
                  directory runs only steps 8 and 9; the flash launches
                  are read after these three calls; the step-8
                  checkpoint (≈ 2.3 GB: bf16 params, f32 moments, int32
                  step) restored onto the card and the CPU equals an
                  uninterrupted hand-driven run's state bit for bit;
                  save (snapshot, write) and restore timed; free disk
                  checked first, the directory removed at the end.
23. ``mesh_train`` the same qwen2-0.5b run at full depth (24 layers;
                  its checkpoint ≈ 4.9 GB) through
                  ``launch.train.train`` on ``single_device_mesh()`` (a
                  1 × 1 ``data`` × ``model`` mesh: an NCCL world of one
                  on an in-memory store; params and AdamW state as
                  DTensors placed by the sharding rules), crashed at step 6
                  and restarted from step 4, then the same steps with
                  ``mesh=None`` in the same process: the losses bit for
                  bit; the ``mesh=None`` step-8 checkpoint restored onto
                  the mesh equals the mesh's step-8 checkpoint restored
                  onto the ``mesh=None`` path, bit for bit; step ms of both
                  paths, the split step's per-superblock gathers and
                  optimizer ms beside the plain optimizer's, warm steps of
                  both paths in turns from the restored states, save
                  (snapshot, write) and restore s, peak GB; the flash
                  launches are read after the mesh run.  Then the split
                  step (each rank on its shards of ``model``, the params
                  gathered along the data axes a superblock at a time)
                  at full width and depth, 4 × 1024 positions, two steps
                  on the 1 × 1 mesh beside ``mesh=None`` for llama3.2-1b
                  (the vocabulary-parallel CE at V 128256; streamed MLP),
                  granite-moe-1b-a400m, mamba2-1.3b and
                  seamless-m4t-medium: losses, params and moments bit for
                  bit; each path's flash / SSD / MLP launches, read right
                  after it; peak GB; a warm step of each in turns.  B2′
                  (8 / 2 heads of llama3.2-1b's train shape) and B3′
                  (M 4096, D 896, F 1216) at a ``model`` = 4 shard's
                  shapes against their plain versions; B4 (4 × 1024) and
                  B4′ (4 × 4096) on the 32 and 4 heads a rank of
                  ``model`` = 2 and 16 computes of mamba2-1.3b's 64,
                  against theirs.  With two or more
                  cards, a (2, 1) and a (1, 2) NCCL mesh of two spawned
                  ranks (torchrun) each run two steps held to the 1 × 1
                  mesh's on the same global batch at the bf16 train rule
                  (loss rtol 1e-2), and a (1, 2) run of mamba2-1.3b's
                  smoke config; with one card the lines say so.
24. ``mesh_serve`` llama3.2-1b at full width and depth (4 × 1024-token
                  prompts + 32 greedy) served by ``ServeEngine(mesh=
                  single_device_mesh())`` — the 1 × 1 NCCL mesh, every
                  collective of the ``model`` split called, each the
                  identity — and with ``mesh=None``, bf16 and int8
                  weights: logits and tokens bit for bit; 16 flash
                  launches a prefill on each mesh engine; prefill ms and
                  decode tokens/s of both in turns, the ms of one
                  call's gathers along the data axes (every superblock
                  in turn, then the leaves outside the blocks), the
                  gathered bytes' peak of a prefill and of a decode step
                  (at most one superblock plus the largest leaf outside
                  the blocks, none left alive), peak GB; B3 on
                  qwen2-0.5b's ``d_ff`` shard at ``model`` = 4 (1216
                  columns) against its plain version.
                  Then mamba2-1.3b at full width and depth the same way
                  (bf16; its mixer split by heads over a group of one):
                  prefill logits and tokens bit for bit, 48 SSD launches
                  a prefill, prefill ms and decode tokens/s in turns.
                  With two or more cards (1, 2) tensor-parallel serves of
                  two torchrun ranks (llama3.2-1b, and mamba2-1.3b's
                  smoke config) against one card (the LM logit rule;
                  token agreement); with one card the line says so;
25. ``dryrun``    lm_serve's llama3.2-1b prefill (4 × 1024) and
                  mesh_train's qwen2-0.5b step (4 × 1024) traced on a
                  world of one and run on the card's 1 × 1 mesh, each in a
                  process of its own: the predicted argument bytes must
                  equal the bytes the allocator was asked for before the
                  step (``requested_bytes``), with
                  ``torch.cuda.memory_allocated()``, its blocks, beside
                  them; the predicted peak beside both peaks and
                  ``bound_s`` beside the measured ms.  The phase fails if
                  a tie fails or it takes over 120 s (the production
                  meshes' modeled cells are the CPU tests');
26. ``examples``  the port's four examples, each ``main`` run in this
                  process with its default arguments (the card), its
                  printed lines to ``chiprun_out/chip_smoke/
                  example_<name>.log``: ``quickstart_torch`` (build →
                  compile → emit → run, bit-exact with the interpreter on
                  the CPU → save/load), ``serve_batched_torch`` (lenet5
                  behind ``ServeEngine``: a request, a burst of 32, 100
                  at 200 offered qps; achieved qps, p50, p99),
                  ``train_lm_torch`` (a 46.1M-param f32 llama, 300 steps
                  of 8 × 256, a crash at 150; median step ms, tokens/s,
                  first and last 10-loss means, the loss fall checked)
                  and ``elastic_resilience_torch`` (qwen2-0.5b's smoke
                  config crashed and restarted on a (2, 2) mesh and
                  re-meshed to (4, 1), four spawned gloo ranks on the
                  CPU, then restored onto the card's 1 × 1 mesh; each
                  phase's seconds).

The conv kernel's launch counters are zeroed just before phase 4 and read
just after phase 5, and again just before phase 6 and after phase 7 (the
``kernels`` line adds both counts); the attention and fused-MLP kernels'
just before and after phase 12, the SSD kernel's just before and after
phase 13; the attention kernel's again around each of phases 14-16 and
the SSD kernel's around phase 15, the attention kernel's around phase
16a and around each model of phase 16b, around each train phase
(17-23) the counts of every forward and backward kernel the path runs,
and around phase 24 the attention
kernel's (read after llama's mesh engines' calls) and the SSD kernel's
(zeroed before mamba2's mesh engine, read after its calls), each read
just after the path's steps, and around each example of phase 26 the
conv and attention kernels' (the ``kernels`` line adds the counts of
every path); the run
fails if a kernel was never launched on its path, or if a plain version
ever ran on a CUDA tensor there.  Then the ``nvidia-smi`` line, the
``{"kernels": [...]}`` summary (per kernel its headline numbers and a
compact row per timed shape; ``stdout_bytes`` counts what was printed
before it) and, last, ``{"ok": true, "device": {...}}``.  Any failed phase
exits non-zero; with no CUDA device the script exits 2 and prints no
result.

Each phase prints a compact line, with its ``seconds`` (wall time since
the previous phase line; ``build`` and ``dryrun`` time themselves); its
whole result (per-shape rows, the
``nvcc`` logs, the profiler's top kernels) goes to
``chiprun_out/chip_smoke/<phase>.json``.  ``--ptxas`` adds each kernel's
registers and spills to the ``build`` line (the conv, SSD and backward
kernels' are always there).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the card's data-sheet peaks and each kernel's work, one count shared with
# the kernels' meta branches and the dry-run
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BYTES_PER_S,
    TENSOR_CORE_BF16_OPS_PER_S,
    attention_bwd_work,
    attention_work,
    conv_work,
    mlp_bwd_mma_work,
    mlp_bwd_work,
    mlp_work,
    ssd_bwd_design_bytes,
    ssd_bwd_work,
    ssd_work,
    visible_pairs,
)
PHASES = ("device", "build", "kernel_check", "main_path", "serve",
          "frontends", "cli", "attn_check", "attn_bwd_check", "mlp_check",
          "mlp_bwd_check", "mlp_probe",
          "ssd_check", "ssd_bwd_check", "lm_serve", "ssm_serve",
          "moe_serve", "hybrid_serve", "encdec_serve", "vlm_serve",
          "int8_serve",
          "lm_train", "lm_train_streamed", "moe_train", "ssm_train",
          "encdec_train", "hybrid_train", "train_resilient", "mesh_train",
          "mesh_serve", "dryrun", "examples")

#: (name, batch, H, W, Cin, Cout, K, stride) — the main path's conv shapes
MAIN_SHAPES = (
    ("lenet5.conv0", 32, 32, 32, 1, 6, 5, 1),
    ("tiny_vgg_32.conv1", 32, 32, 32, 16, 16, 3, 1),
    ("resnet_mini_16.conv1", 32, 16, 16, 8, 16, 3, 2),
    ("deep_cascade_224.conv0", 1, 224, 224, 3, 136, 3, 1),
    ("deep_cascade_224.conv1", 1, 224, 224, 136, 136, 3, 1),
    ("fat_conv_16.conv0", 1, 16, 16, 288, 288, 3, 1),
    ("fat_cascade_16.conv", 1, 16, 16, 288, 48, 3, 1),
)
HEADLINE_SHAPE = "deep_cascade_224.conv1"


#: a hang fails the run inside the 1200 s a run may take (the full run
#: took 902 s on an H100 80GB HBM3 at 700 W, build included)
WATCHDOG_S = 1150


def _timed_out(signum, frame):
    print(f"chip_smoke: no result after {WATCHDOG_S} s — giving up",
          file=sys.stderr, flush=True)
    os._exit(3)


#: each phase's full result, one JSON file per phase; stdout carries a
#: compact line per phase (a captured stdout may keep only its tail)
DETAIL_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
#: keys left out of the compact lines (they stay in the detail files)
VERBOSE_KEYS = ("shapes", "top_kernels", "wall_ms_each",
                "logit_gaps_vs_dense", "decode_step_ms", "libraries",
                "outputs", "dropped_share_per_layer", "flips",
                "decode_gaps", "grad_rel_l2", "tokens_1x2", "tokens_1x1")
#: what a compact per-shape row of the ``kernels`` line keeps
SHAPE_KEYS = ("shape", "dtype", "ms", "device_ms", "plain_ms", "bound_ms",
              "library_ms")
_stdout_bytes = 0
#: when the last phase line was printed: a phase's ``seconds`` run from it
_phase_mark = time.perf_counter()


def emit(obj) -> None:
    global _stdout_bytes
    line = json.dumps(obj)
    print(line, flush=True)
    _stdout_bytes += len(line.encode()) + 1


def _compact(obj):
    if isinstance(obj, dict):
        return {k: _compact(v) for k, v in obj.items()
                if k not in VERBOSE_KEYS}
    if isinstance(obj, list):
        return [_compact(v) for v in obj]
    return obj


def phase_seconds() -> float:
    """Seconds since the last phase line, and the mark reset to now."""
    global _phase_mark
    now = time.perf_counter()
    seconds, _phase_mark = now - _phase_mark, now
    return seconds


def emit_phase(name: str, result) -> None:
    """``result`` in full to ``DETAIL_DIR/<name>.json``; on stdout one line
    ``{name: result without VERBOSE_KEYS, "detail": path}``.  Its
    ``seconds``, where the phase does not time itself (``build``: the
    ``nvcc`` runs; ``dryrun``: its ties), are the wall time since the
    last phase line."""
    seconds = phase_seconds()
    if "seconds" not in result:
        result = {**result, "seconds": seconds}
    os.makedirs(DETAIL_DIR, exist_ok=True)
    path = os.path.join(DETAIL_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    emit({name: _compact(result), "detail": os.path.relpath(path, ROOT)})


def shape_rows(shapes) -> list:
    """The per-shape rows of the ``kernels`` line, cut to ``SHAPE_KEYS``."""
    return [{k: s[k] for k in SHAPE_KEYS if k in s} for s in shapes]


def ptxas_report(log: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads}] from what
    ``nvcc -Xptxas -v`` printed, kernel names demangled where ``c++filt``
    is at hand and cut before their arguments."""
    import re
    import shutil

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n.replace("(anonymous namespace)::", "")
                r["kernel"] = n.removeprefix("void ").split("(")[0]
    return rows


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, *, warmup: int, reps: int) -> float:
    """Mean milliseconds per call by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_time(fn, *, reps: int, names) -> dict | None:
    """{name: [µs, launches]} the card spent inside the kernels whose
    names contain each of ``names`` (an event counts for the first that it
    contains) over ``reps`` calls of ``fn``, from ``torch.profiler``'s
    device trace; ``None`` where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except RuntimeError:      # no device tracing on this machine
        return None
    found = {k: [0.0, 0] for k in names}
    for ev in events:
        k = next((k for k in names if k in ev.key), None)
        if k is not None:
            found[k][0] += (getattr(ev, "self_device_time_total", 0.0)
                            or getattr(ev, "self_cuda_time_total", 0.0))
            found[k][1] += ev.count
    return found


def device_ms(fn, *, reps: int, kernel):
    """Milliseconds the card spends inside ``kernel`` (a name, or a tuple
    of names whose times add up) per call of ``fn``, which launches each
    kernel whose name contains one of them at most once, from
    ``torch.profiler``'s device trace: per distinct kernel the mean of the
    launches the trace recorded, summed.  In a long process the trace
    loses launches (2 of 5 of the fused MLP, 1 of 10 of attention, in a
    full run), so the sum over them divided by ``reps`` would read low.
    ``ms`` from :func:`time_ms` also holds the host's time to enqueue a
    call, which is what shows at small shapes.  ``None`` where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except RuntimeError:      # no device tracing on this machine
        return None
    per_launch = [(getattr(ev, "self_device_time_total", 0.0)
                   or getattr(ev, "self_cuda_time_total", 0.0)) / ev.count
                  for ev in events
                  if ev.count and any(k in ev.key for k in names)]
    total_us = sum(per_launch)
    return total_us / 1e3 if total_us else None


def device_ms_each(fn, *, reps: int, kernels) -> dict:
    """Per kernel of a call that launches each of ``kernels`` once: the
    mean device milliseconds of one launch, over the launches the trace
    recorded (``None`` for a kernel it did not record), and under
    ``"per_call"`` their sum — one call's device time."""
    found = _device_time(fn, reps=reps, names=kernels) or {}
    each = {k: (found[k][0] / found[k][1] / 1e3
                if k in found and found[k][1] else None) for k in kernels}
    each["per_call"] = (sum(each.values())
                        if all(v is not None for v in each.values())
                        else None)
    return each


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version on the card
# ---------------------------------------------------------------------------


def _rand(gen, shape, dtype, torch, *, big: bool = False):
    if dtype in (torch.float32, torch.bfloat16):
        return (torch.rand(shape, generator=gen) * 2 - 1).to(dtype).cuda()
    if big:  # products overflow int32 and must wrap
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).cuda()
    lo, hi = {torch.int8: (-128, 128), torch.uint8: (0, 256),
              torch.int16: (-3000, 3000), torch.int32: (-4, 5)}[dtype]
    return torch.randint(lo, hi, shape, generator=gen,
                         dtype=torch.int64).to(dtype).cuda()


def _compare(out, exp, dtype, torch, what: str) -> float:
    if out.shape != exp.shape or out.dtype != exp.dtype:
        raise AssertionError(
            f"{what}: kernel gave {tuple(out.shape)} {out.dtype}, plain "
            f"version {tuple(exp.shape)} {exp.dtype}")
    if dtype in (torch.float32, torch.bfloat16):
        atol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        err = (out - exp).abs()
        if not bool((err <= atol + 1e-2 * exp.abs()).all()):
            raise AssertionError(
                f"{what}: max |err| {float(err.max())} beyond atol {atol} "
                "rtol 1e-2")
        return float(err.max())
    if not torch.equal(out, exp):
        bad = int((out != exp).sum())
        raise AssertionError(f"{what}: {bad} integer outputs differ")
    return 0.0


#: the conv's ms at the headline shape before weights streamed through
#: shared memory (chip_smoke.py's run on an NVIDIA H100 80GB HBM3, 700.00
#: W): constants, not measured in this run, so they go only into the
#: phase's detail file as ``before_ms`` and never into the ``kernels`` line
CONV_BEFORE_MS = {("deep_cascade_224.conv1", "int32"): 2.222,
                  ("deep_cascade_224.conv1", "float32"): 2.062}
def _conv_plan(dse, *, h_out, w_out, c_in, c_out, k, stride, batch, tile,
               c_tile, w_tile, rows_step, streamed, band=None,
               stage_chunks=1, threads=None):
    """A hand-made plan of ``c_tile`` × ``w_tile`` × ``rows_step`` with a
    ``tile`` register tile (what the planner would build for it)."""
    tp, tc = tile
    threads = threads or rows_step * (w_tile // tp) * (c_tile // tc)
    band = band or rows_step
    return dse.ConvBlockPlan(
        "conv_rows", {"rows": band, "rows_step": rows_step,
                      "w_tile": w_tile, "c_tile": c_tile, "tile_pixels": tp,
                      "tile_channels": tc, "threads": threads,
                      "streamed": streamed, "stage_chunks": stage_chunks},
        dse.conv_smem_bytes(kh=k, kw=k, c_in=c_in, stride=stride,
                            rows_step=rows_step, w_tile=w_tile,
                            c_tile=c_tile, streamed=streamed,
                            stage_chunks=stage_chunks),
        (-(-w_out // w_tile) * -(-c_out // c_tile), -(-h_out // band),
         batch))


def plan_sweep(torch, gen) -> int:
    """Every register tile × its operand routes (resident for the small
    tiles, streamed) on the same inputs, held against the plain version;
    and in f32 every plan must give the same bits (the sum's order is
    fixed by the chunk)."""
    from repro_torch.core import dse
    from repro_torch.kernels import conv2d_stream as cs
    from repro_torch.kernels import ops

    n = 0
    for (b, h, w_, cin, cout, k, stride) in ((2, 12, 19, 17, 10, 3, 1),
                                             (1, 9, 16, 40, 24, 3, 2),
                                             (3, 7, 9, 5, 6, 5, 1)):
        pads = ops._conv_pads(h, w_, k, k, stride, "SAME")
        h_out = (h + sum(pads[0]) - k) // stride + 1
        w_out = (w_ + sum(pads[1]) - k) // stride + 1
        for dtype in (torch.int32, torch.float32, torch.int8):
            x = _rand(gen, (b, h, w_, cin), dtype, torch,
                      big=dtype == torch.int32)
            wt = _rand(gen, (k, k, cin, cout), dtype, torch,
                       big=dtype == torch.int32)
            exp = cs.conv2d_stream_plain(x, wt, stride, pads, "relu")
            first = None
            for tile in dse.CONV_TILES:
                tp, tc = tile
                for streamed in (False, True)[tp * tc >= 64:]:
                    # (rows a step, band, chunks a stage, threads): a
                    # resident block may carry threads that only load
                    for rows_step, band, chunks, threads in (
                            (1, 3, 1, None), (2, None, 1, None),
                            (1, 3, 4, None), (2, None, 1, 96)):
                        if (threads if streamed else chunks > 1):
                            continue    # the routes have no such plan
                        plan = _conv_plan(
                            dse, h_out=h_out, w_out=w_out, c_in=cin,
                            c_out=cout, k=k, stride=stride, batch=b,
                            tile=tile, c_tile=2 * tc, w_tile=2 * tp,
                            rows_step=rows_step, streamed=streamed,
                            band=band, stage_chunks=chunks, threads=threads)
                        got = cs.launch_plan(x, wt, stride, pads, "relu",
                                             plan)
                        torch.cuda.synchronize()
                        _compare(got, exp, dtype, torch,
                                 f"plan {plan.blocks} x{tuple(x.shape)} "
                                 f"w{tuple(wt.shape)} {dtype}")
                        n += 1
                        if first is None:
                            first = got
                        elif not torch.equal(got, first):
                            raise AssertionError(
                                f"plan {plan.blocks} {dtype}: not the bits "
                                "of the first plan")
    return n


def kernel_check(torch) -> dict:
    from repro_torch.core import dse
    from repro_torch.kernels import conv2d_stream as cs
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    n = 0
    worst = {"f32": 0.0, "bf16": 0.0}

    def check(x, w, *, stride=1, padding="SAME", epilogue=None, rows=None,
              what=""):
        nonlocal n
        _, h, ww, _ = x.shape
        kh, kw, _, _ = w.shape
        pads = ops._conv_pads(h, ww, kh, kw, stride, padding)
        out = ops.conv2d_stream(x, w, stride=stride, padding=padding,
                                epilogue=epilogue, rows_per_block=rows)
        exp = cs.conv2d_stream_plain(x, w, stride, pads, epilogue)
        torch.cuda.synchronize()
        err = _compare(out, exp, x.dtype, torch,
                       f"{what} x{tuple(x.shape)} w{tuple(w.shape)} "
                       f"{x.dtype} s{stride} {padding} {epilogue} rows={rows}")
        if x.dtype == torch.float32:
            worst["f32"] = max(worst["f32"], err)
        elif x.dtype == torch.bfloat16:
            worst["bf16"] = max(worst["bf16"], err)
        n += 1

    all_dtypes = (torch.int8, torch.uint8, torch.int16, torch.int32,
                  torch.float32, torch.bfloat16)
    for dtype in all_dtypes:                      # dtype x kernel size
        for k in (1, 3, 5):
            check(_rand(gen, (2, 12, 12, 4), dtype, torch),
                  _rand(gen, (k, k, 4, 8), dtype, torch), what="dtype-k")
    for h, w_ in ((8, 8), (16, 8), (9, 13), (32, 32)):   # odd shapes
        check(_rand(gen, (1, h, w_, 3), torch.int8, torch),
              _rand(gen, (3, 3, 3, 16), torch.int8, torch), what="shape")
    # int8 -> int32 accumulation beyond int16, and int32 wrap-around
    check(torch.full((1, 8, 8, 64), 127, dtype=torch.int8).cuda(),
          torch.full((3, 3, 64, 4), 127, dtype=torch.int8).cuda(),
          what="int8-acc")
    for epi in (None, "relu", "squared_relu"):
        check(_rand(gen, (2, 9, 11, 5), torch.int32, torch, big=True),
              _rand(gen, (3, 3, 5, 7), torch.int32, torch, big=True),
              epilogue=epi, what="int32-wrap")
    # stride x padding x kernel x epilogue x batch x rows_per_block
    paddings = ("SAME", "VALID", ((1, 2), (0, 3)))
    for dtype in (torch.int32, torch.float32):
        for batch in (1, 5, 32):
            for k in (1, 3, 5):
                x = _rand(gen, (batch, 13, 12, 3), dtype, torch)
                w = _rand(gen, (k, k, 3, 6), dtype, torch)
                for stride in (1, 2, 3):
                    for padding in paddings:
                        for epi in (None, "relu", "squared_relu"):
                            for rows in (1, 2, None):
                                check(x, w, stride=stride, padding=padding,
                                      epilogue=epi, rows=rows, what="sweep")
    # a Cout slice of a streamed weight is a strided view
    wfull = _rand(gen, (3, 3, 8, 24), torch.int32, torch)
    xs = _rand(gen, (1, 16, 16, 8), torch.int32, torch)
    for t in range(3):
        check(xs, wfull.narrow(3, t * 8, 8), epilogue="relu", what="w-slice")
    # Dense layers run as 1x1 convs over a (1, 1, M, K) frame
    for m, kdim, nout in ((32, 4096, 10), (512, 128, 256), (1, 1024, 120)):
        for dtype in (torch.int32, torch.float32):
            a = _rand(gen, (3, m, kdim), dtype, torch)
            wd = _rand(gen, (kdim, nout), dtype, torch)
            got = ops.mac_reduce("ac,cb->ab", [a, wd], [True, False])
            if dtype == torch.float32:
                exp = a @ wd
            else:
                exp = cs._int_product(a, wd)
            torch.cuda.synchronize()
            worst["f32"] = max(worst["f32"], _compare(
                got, exp, dtype, torch, f"dense {m}x{kdim}x{nout} {dtype}"))
            n += 1
    # Cin across the 8-channel chunks, Cout off the channel tiles, int32
    # wrap-around and the narrow types at the sizes that stream
    for cin in (17, 33, 136, 288):
        for cout in (136, 6, 10):
            for dtype in (torch.int32, torch.float32):
                check(_rand(gen, (2, 11, 13, cin), dtype, torch),
                      _rand(gen, (3, 3, cin, cout), dtype, torch),
                      epilogue="relu", what="chunks")
    for dtype in (torch.int8, torch.int16, torch.bfloat16):
        check(_rand(gen, (1, 9, 20, 136), dtype, torch),
              _rand(gen, (3, 3, 136, 10), dtype, torch), what="narrow-stream")
    for epi in (None, "squared_relu"):
        check(_rand(gen, (1, 16, 64, 136), torch.int32, torch, big=True),
              _rand(gen, (3, 3, 136, 136), torch.int32, torch, big=True),
              epilogue=epi, what="int32-wrap-wide")
    n += plan_sweep(torch, gen)

    # timing at the main path's shapes
    torch.backends.cudnn.allow_tf32 = False       # the yardstick stays f32
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.nn.functional as F

    shapes = []
    for name, b, h, w_, cin, cout, k, stride in MAIN_SHAPES:
        for dtype in (torch.int32, torch.float32):
            x = _rand(gen, (b, h, w_, cin), dtype, torch)
            w = _rand(gen, (k, k, cin, cout), dtype, torch)
            pads = ops._conv_pads(h, w_, k, k, stride, "SAME")
            big = cin >= 128
            (pt, pb), (pl, pr) = pads
            shape = dict(h_out=(h + pt + pb - k) // stride + 1,
                         w_out=(w_ + pl + pr - k) // stride + 1, c_in=cin,
                         c_out=cout, kh=k, kw=k, stride=stride, batch=b)
            plan = dse.plan_conv_rows(**shape)
            # the planner's host time on a shape's first call (the wrapper
            # keeps its plan per call signature after that)
            t0 = time.perf_counter()
            for _ in range(20):
                dse.plan_conv_rows.__wrapped__(**shape)
            plan_host_ms = (time.perf_counter() - t0) * 1e3 / 20
            run = lambda: ops.conv2d_stream(x, w, stride=stride,
                                            epilogue="relu")
            plain = lambda: cs.conv2d_stream_plain(x, w, stride, pads, "relu")
            out, exp = run(), plain()
            torch.cuda.synchronize()
            err = _compare(out, exp, dtype, torch, f"{name} {dtype}")
            n += 1
            if dtype == torch.float32:
                worst["f32"] = max(worst["f32"], err)
            ms = time_ms(run, warmup=3, reps=10 if big else 100)
            plain_ms = time_ms(plain, warmup=1, reps=2 if big else 20)
            dev_ms = device_ms(run, reps=5 if big else 20,
                               kernel="conv2d_stream_kernel")
            work = conv_work(x.numel() * x.element_size(),
                             w.numel() * w.element_size(),
                             out.numel() * out.element_size(), out.numel(),
                             k, cin, dtype.is_floating_point)
            n_bytes, macs = work.bytes, work.flops // 2
            library_ms = None
            if dtype == torch.float32:
                xn = x.permute(0, 3, 1, 2)        # NHWC storage, NCHW view
                wn = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                (pt, pb), (pl, pr) = pads

                def lib():
                    xin = xn
                    if pt != pb or pl != pr:
                        xin = F.pad(xn, (pl, pr, pt, pb))
                        pad = 0
                    else:
                        pad = (pt, pl)
                    return F.relu(F.conv2d(xin, wn, stride=stride,
                                           padding=pad))

                ref_out = lib().permute(0, 2, 3, 1)
                torch.cuda.synchronize()
                _compare(out, ref_out, dtype, torch, f"{name} vs F.conv2d")
                library_ms = time_ms(lib, warmup=3, reps=10 if big else 100)
            shapes.append({
                "shape": name, "dtype": str(dtype).replace("torch.", ""),
                "x": [b, h, w_, cin], "w": [k, k, cin, cout],
                "stride": stride, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms,
                "bound_ms": work.bound_ms(), "bound_by": work.bound_by(),
                "bytes": n_bytes, "macs": macs, "library_ms": library_ms,
                "max_abs_err": err,
                "before_ms": CONV_BEFORE_MS.get((name, str(dtype)[6:])),
                "plan": plan.blocks, "smem_fill_bytes": plan.smem_fill_bytes,
                "plan_host_ms": plan_host_ms,
            })
    return {"comparisons": n, "max_abs_err_f32": worst["f32"],
            "max_abs_err_bf16": worst["bf16"], "max_abs_err_int": 0,
            "shapes": shapes}


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

ZOO_MODELS = ("lenet5", "tiny_vgg_32", "edge_residual_32", "resnet_mini_16")
SHOWCASES = ("deep_cascade_224", "residual_block_224", "fat_cascade_16")


def _numpy_env(src, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    inputs = {k: rng.integers(-4, 5, size=src.values[k].shape,
                              dtype=np.int32) for k in src.graph_inputs}
    params = {n: rng.integers(-4, 5, size=v.shape, dtype=np.int32)
              for n, v in src.values.items() if v.is_constant}
    return inputs, params


def _check_output(name, out, src):
    import numpy as np

    want = tuple(src.values[src.graph_outputs[0]].shape)
    if tuple(out.shape)[-len(want):] != want:
        raise AssertionError(f"{name}: output shape {out.shape}, want {want}")
    if not np.isfinite(out.astype(np.float64)).all():
        raise AssertionError(f"{name}: non-finite output")


def main_path(torch) -> tuple[dict, dict]:
    import numpy as np

    import repro_torch
    from repro_torch.kernels import conv2d_stream as cs

    suite = repro_torch.suite()
    arts = {}
    rows = []
    for name in ZOO_MODELS + SHOWCASES:
        t0 = time.perf_counter()
        art = repro_torch.compile_graph(suite[name](), target="kv260")
        compile_s = time.perf_counter() - t0
        arts[name] = art
        src = art.source
        inputs, params = _numpy_env(src, seed=1)
        before = cs.launches
        t0 = time.perf_counter()
        got = art.run(inputs, params)                 # on the card
        run_ms = (time.perf_counter() - t0) * 1e3
        launched = cs.launches - before
        want = art.run(inputs, params, device="cpu")  # plain versions, host
        _check_output(name, got, src)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{name}: card run != device='cpu' run")
        row = {"model": name, "groups": len(art.design.groups),
               "compile_s": round(compile_s, 3), "first_run_ms": run_ms,
               "launches_per_run": launched, "equals_cpu": True}
        if name in SHOWCASES:   # a user's warm call, host clock, 5 runs
            t0 = time.perf_counter()
            for _ in range(5):
                art.run(inputs, params)
            row["warm_run_ms"] = (time.perf_counter() - t0) * 1e3 / 5
            # and the card's time in the conv kernel per call
            row["warm_conv_device_ms"] = device_ms(
                lambda: art.run(inputs, params), reps=3,
                kernel="conv2d_stream_kernel")
        if name in ZOO_MODELS:
            rng = np.random.default_rng(2)
            xb = {k: rng.integers(-4, 5, size=(32,) + tuple(v.shape),
                                  dtype=np.int32) for k, v in inputs.items()}
            before = cs.launches
            vm = art.run(xb, params, batch_mode="vmap")
            row["launches_per_batch32"] = cs.launches - before
            lp = art.run(xb, params, batch_mode="loop")
            if not np.array_equal(vm, lp):
                raise AssertionError(f"{name}: batched (vmap) != loop")
            if not np.array_equal(vm[:4], art.run(
                    {k: v[:4] for k, v in xb.items()}, params, device="cpu")):
                raise AssertionError(f"{name}: batched card run != cpu run")
            row["vmap_equals_loop"] = True
            # floats too: same kernel, same summation order whatever the
            # batch, so batched == loop bit for bit on the card
            rng = np.random.default_rng(4)
            xf = {k: rng.standard_normal((8,) + tuple(v.shape)).astype(
                np.float32) for k, v in inputs.items()}
            pf = {n: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                  for n, v in params.items()}
            fv = art.run(xf, pf, batch_mode="vmap")
            if fv.dtype != np.float32 or not np.isfinite(fv).all():
                raise AssertionError(f"{name}: float run not finite f32")
            if not np.array_equal(fv, art.run(xf, pf, batch_mode="loop")):
                raise AssertionError(f"{name}: float batched (vmap) != loop")
            row["float_vmap_equals_loop"] = True
        rows.append(row)
    return {"models": rows}, arts


def serve(torch, arts, models=ZOO_MODELS + ("deep_cascade_224",)) -> dict:
    import numpy as np

    from repro_torch.serve import ServeConfig, ServeEngine, run_load

    class Recording:
        """Engine proxy that keeps every future the load generator gets."""

        def __init__(self, engine):
            self._engine = engine
            self.futures = []

        def __getattr__(self, name):
            return getattr(self._engine, name)

        def submit(self, inputs):
            fut = self._engine.submit(inputs)
            self.futures.append(fut)
            return fut

    plan = [(m, 32, 256, 2000.0) for m in ZOO_MODELS]
    plan.append(("deep_cascade_224", 8, 16, 200.0))
    rows = []
    for name, max_batch, requests, qps in plan:
        if name not in models:
            continue
        art = arts[name]
        src = art.source
        _, params = _numpy_env(src, seed=1)
        rng = np.random.default_rng(3)
        pool = [{k: rng.integers(-4, 5, size=src.values[k].shape,
                                 dtype=np.int32) for k in src.graph_inputs}
                for _ in range(16)]
        direct = [art.run(x, params) for x in pool]
        cfg = ServeConfig(max_batch=max_batch, latency_budget_ms=5.0)
        with ServeEngine(art, cfg, params=params) as eng:
            rec = Recording(eng)
            report = run_load(rec, offered_qps=qps, requests=requests,
                              seed=0, inputs=pool)
            snap = eng.metrics()
        if len(rec.futures) != requests or report.rejected:
            raise AssertionError(f"{name}: {report.rejected} rejected")
        for i, fut in enumerate(rec.futures):
            if not np.array_equal(fut.result(), direct[i % len(pool)]):
                raise AssertionError(f"{name}: request {i} != direct run")
        stages = {}
        for row in snap["histograms"]["serve_stage_ms"]["values"]:
            if row["count"]:
                stages[row["labels"]["stage"]] = row["sum"] / row["count"]
        rows.append(dict(report.row(), model=name, max_batch=max_batch,
                         stage_mean_ms=stages, all_equal_direct=True))
    return {"engines": rows}


# ---------------------------------------------------------------------------
# phases 6 and 7: the imported and the command-line paths
# ---------------------------------------------------------------------------

#: the ONNX goldens: (file under tests/golden, NumPy NCHW oracle and its
#: weights in tests/_onnx_fixture.py, input shape, input seed)
ONNX_GOLDENS = (
    ("lenet5.onnx", "lenet5_numpy", "lenet5_weights", (1, 1, 32, 32), 7),
    ("resnet_tiny.onnx", "resnet_tiny_numpy", "resnet_tiny_weights",
     (1, 3, 16, 16), 17),
)
#: an ONNX model at ``deep_cascade_224``'s widths: int8 input, (Conv 3×3
#: SAME + int32 bias, Relu) × 4 over these channels, then MaxPool 8×8 /
#: 8.  The head is there because an NCHW output keeps the importer's
#: NHWC→NCHW bridge, and that transpose alone exceeds either target's
#: BRAM at 224²×136 (a ``PartitionError`` in both packages); 28²×136
#: fits, and each of its values reads 64 of the last conv's outputs
WIDE_ONNX_CHANNELS = (3, 136, 136, 136, 136)
WIDE_ONNX_SIZE = 224
WIDE_ONNX_POOL = 8
WIDE_ONNX_SEED = 0


def onnx_fixture():
    """``tests/_onnx_fixture.py`` (NumPy only): the goldens' NumPy NCHW
    oracles and the protobuf encoder, loaded by path — nothing else of
    ``tests/`` is imported."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "_onnx_fixture.py")
    spec = importlib.util.spec_from_file_location("_onnx_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wide_onnx_bytes(fx) -> bytes:
    """The full-width model as ONNX bytes, weights in [-4, 4] (int8) and
    biases in [-8, 8] (int32) from :data:`WIDE_ONNX_SEED`."""
    import numpy as np

    rng = np.random.default_rng(WIDE_ONNX_SEED)
    chans = WIDE_ONNX_CHANNELS
    nodes, inits, src = [], [], "input"
    conv_attrs = (fx.attr_ints("kernel_shape", [3, 3]),
                  fx.attr_ints("strides", [1, 1]),
                  fx.attr_ints("pads", [1, 1, 1, 1]))
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        inits += [
            fx.tensor(f"conv{i}_w", rng.integers(
                -4, 5, (cout, cin, 3, 3)).astype(np.int8)),
            fx.tensor(f"conv{i}_b", rng.integers(
                -8, 9, (cout,)).astype(np.int32)),
        ]
        nodes += [fx.node("Conv", [src, f"conv{i}_w", f"conv{i}_b"],
                          [f"c{i}"], f"conv{i}", conv_attrs),
                  fx.node("Relu", [f"c{i}"], [f"r{i}"], f"relu{i}")]
        src = f"r{i}"
    pool, n = WIDE_ONNX_POOL, WIDE_ONNX_SIZE
    nodes.append(fx.node("MaxPool", [src], ["pool"], "pool", (
        fx.attr_ints("kernel_shape", [pool, pool]),
        fx.attr_ints("strides", [pool, pool]))))
    return fx.model(fx.graph(
        "wide_cascade_224", nodes, inits,
        [fx.value_info("input", (1, chans[0], n, n), fx.INT8)],
        [fx.value_info("pool", (1, chans[-1], n // pool, n // pool),
                       fx.INT32)]))


def _same_bits(what: str, got, want) -> None:
    import numpy as np

    if got.dtype != want.dtype or got.shape != want.shape or \
            not np.array_equal(got, want):
        raise AssertionError(f"{what}: {got.dtype}{got.shape} differs from "
                             f"{want.dtype}{want.shape}")


def frontends(torch) -> dict:
    """(a) the ONNX goldens imported, compiled for both targets and run on
    the card against their NumPy oracles and the port's CPU run; (b) every
    zoo model through its model card against the builder graph; (c) an
    ONNX model at full width against the port's CPU run."""
    import tempfile

    import numpy as np

    import repro_torch
    from repro_torch.frontends import import_card, import_model, zoo
    from repro_torch.kernels import conv2d_stream as cs

    fx = onnx_fixture()
    goldens = []
    for fname, oracle, weights, shape, seed in ONNX_GOLDENS:
        m = import_model(os.path.join(ROOT, "tests", "golden", fname))
        x = np.random.default_rng(seed).integers(-4, 5, shape).astype(
            np.int32)
        xin = {m.dfg.graph_inputs[0]: x}
        want = getattr(fx, oracle)(x.astype(np.int64),
                                   getattr(fx, weights)(0))
        for target in ("kv260", "zu3eg"):
            art = repro_torch.compile_graph(m.dfg, target=target)
            before = cs.launches
            got = art.run(xin, m.params)                     # on the card
            launched = cs.launches - before
            _same_bits(f"{fname} @ {target}: card vs device='cpu'", got,
                       art.run(xin, m.params, device="cpu"))
            _same_bits(f"{fname} @ {target}: card vs NumPy oracle",
                       got.astype(np.int64), want)
            goldens.append({"model": fname, "target": target,
                            "groups": len(art.design.groups),
                            "launches_per_run": launched,
                            "equals_cpu": True, "equals_oracle": True})

    with open(os.path.join(ROOT, "examples", "lenet5.json")) as f:
        if zoo.card_json("lenet5") != f.read():
            raise AssertionError("card_json('lenet5') != examples/lenet5.json")
    cards = []
    for name in ZOO_MODELS:
        built = repro_torch.compile_graph(zoo.ZOO[name](), target="kv260")
        carded = repro_torch.compile_graph(
            import_card(zoo.card_json(name)).dfg, target="kv260")
        inputs, params = _numpy_env(built.source, seed=5)
        before = cs.launches
        got = carded.run(inputs, params)
        launched = cs.launches - before
        _check_output(f"{name} card", got, carded.source)
        _same_bits(f"{name}: card import vs builder graph", got,
                   built.run(inputs, params))
        cards.append({"model": name, "launches_per_run": launched,
                      "equals_builder": True})

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wide_cascade_224.onnx")
        with open(path, "wb") as f:
            f.write(wide_onnx_bytes(fx))
        m = import_model(path)
    t0 = time.perf_counter()
    art = repro_torch.compile_graph(m.dfg, target="kv260")
    compile_s = time.perf_counter() - t0
    if len(art.design.groups) < 2:
        raise AssertionError("the full-width ONNX model did not partition")
    n = WIDE_ONNX_SIZE
    xin = {m.dfg.graph_inputs[0]: np.random.default_rng(6).integers(
        -4, 5, (1, WIDE_ONNX_CHANNELS[0], n, n)).astype(np.int8)}
    before = cs.launches
    got = art.run(xin, m.params)
    launched = cs.launches - before
    n //= WIDE_ONNX_POOL
    if got.shape != (1, WIDE_ONNX_CHANNELS[-1], n, n):
        raise AssertionError(f"full-width ONNX model: shape {got.shape}")
    t0 = time.perf_counter()
    _same_bits("full-width ONNX model: card vs device='cpu'", got,
               art.run(xin, m.params, device="cpu"))
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(5):
        art.run(xin, m.params)
    warm_ms = (time.perf_counter() - t0) * 1e3 / 5
    wide = {"model": "wide_cascade_224.onnx", "target": "kv260",
            "groups": len(art.design.groups), "compile_s": compile_s,
            "launches_per_run": launched, "warm_run_ms": warm_ms,
            "cpu_run_s": cpu_s, "equals_cpu": True,
            "max_out": int(got.max())}
    return {"goldens": goldens, "cards": cards,
            "lenet5_card_equals_example": True, "full_width": wide}


def _cli_rows(commands, main, cs):
    """Run ``python -m repro_torch``'s ``main`` on each argv in process
    (so the conv kernel's counters see its launches), its output
    captured; fails on the first that does not exit 0."""
    import io

    rows = []
    for argv in commands:
        out, err = io.StringIO(), io.StringIO()
        before = cs.launches
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        rows.append({"argv": argv, "rc": rc,
                     "seconds": time.perf_counter() - t0,
                     "conv_launches": cs.launches - before,
                     "stdout": out.getvalue(), "stderr": err.getvalue()})
        if rc != 0:
            raise AssertionError(
                f"python -m repro_torch {' '.join(argv)} exited {rc}: "
                f"{err.getvalue()[-2000:]}")
    return rows


def cli(torch, smi: str, kind: str) -> dict:
    """``python -m repro_torch``'s commands, each exiting 0; the profile
    document of ``deep_cascade_224`` measured on the card and naming it."""
    import tempfile

    from repro_torch.__main__ import main as cli_main
    from repro_torch.kernels import conv2d_stream as cs

    os.makedirs(DETAIL_DIR, exist_ok=True)
    profile_path = os.path.join(DETAIL_DIR, "profile.json")
    with tempfile.TemporaryDirectory() as tmp:
        hls, trace = os.path.join(tmp, "hls"), os.path.join(tmp, "t.json")
        rows = _cli_rows([
            ["list"],
            ["zoo", "--export", os.path.join(tmp, "cards")],
            ["compile", os.path.join(ROOT, "tests", "golden",
                                     "resnet_tiny.onnx"), "--run"],
            ["compile", "deep_cascade_224", "--emit", hls, "--run",
             "--trace", trace],
            ["lint", "--all"],
            ["profile", "deep_cascade_224", "--target", "kv260", "--target",
             "zu3eg", "--reps", "5", "--json", profile_path],
        ], cli_main, cs)
        emitted = sorted(os.listdir(hls))
        with open(trace) as f:
            trace_events = len(json.load(f)["traceEvents"])
        cards = sorted(os.listdir(os.path.join(tmp, "cards")))
        for row in rows:      # paths of this run, as the detail file shows
            row["argv"] = [a.replace(tmp, "<tmp>").replace(ROOT + "/", "")
                           for a in row["argv"]]
    for row in rows[2:4]:
        if "ran OK" not in row["stdout"]:
            raise AssertionError(f"{row['argv']}: no 'ran OK'")
    if "host_schedule.cpp" not in emitted or not trace_events:
        raise AssertionError("compile --emit/--trace wrote nothing")
    if cards != [f"{m}.json" for m in sorted(ZOO_MODELS)]:
        raise AssertionError(f"zoo --export wrote {cards}")

    with open(profile_path) as f:
        doc = json.load(f)
    card = doc["provenance"].get("device") or {}
    if card.get("name") != kind or card.get("nvidia_smi") != smi:
        raise AssertionError(f"the profile's provenance names {card}, "
                             f"not {kind!r} / {smi!r}")
    measured = {}
    for prof in doc["profiles"]:
        if prof["device"] != "cuda":
            raise AssertionError(f"profile measured on {prof['device']}")
        if any(g["measured_ms"] <= 0 for g in prof["groups"]):
            raise AssertionError(f"{prof['target']}: a group measured 0 ms")
        measured[prof["target"]] = [
            {"group": g["group"], "measured_ms": g["measured_ms"],
             "modeled_ms": g["modeled_ms"], "ratio": g["ratio"]}
            for g in prof["groups"]]
    return {
        "commands": [{k: r[k] for k in ("argv", "rc", "seconds",
                                        "conv_launches")} for r in rows],
        "outputs": [{"stdout": r["stdout"], "stderr": r["stderr"]}
                    for r in rows],
        "emitted": emitted, "trace_events": trace_events,
        "profile": os.path.relpath(profile_path, ROOT),
        "profile_device": card, "measured_vs_modeled": measured,
        "env_copy": env_copy(torch, "deep_cascade_224"),
    }


def env_copy(torch, name: str) -> dict:
    """The host→card move of the env a profiled run binds (its inputs and
    weights, ``random_env`` drawn on the host): ``CompiledArtifact.run``
    makes it before the first group, so no group's ``measured_ms`` holds
    it.  Min of 5, host clock, the device synchronized on both sides."""
    import repro_torch
    from repro_torch.device import env_to_device, synchronize
    from repro_torch.passes import interp

    src = repro_torch.compile_graph(repro_torch.suite()[name](),
                                    target="kv260").source
    host = interp.random_env(src, seed=0, device="cpu")
    card = torch.device("cuda")
    times = []
    for _ in range(5):
        synchronize(card)
        t0 = time.perf_counter()
        env_to_device(host, card)
        synchronize(card)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"model": name, "entries": len(host),
            "bytes": sum(v.numel() * v.element_size() for v in host.values()),
            "ms": min(times)}


# ---------------------------------------------------------------------------
# phase 8: the flash-attention kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: (name, B, Hq, Hkv, Sq, Sk, D, causal, q_offset) — checked in f32 and bf16
ATTN_CASES = (
    ("llama3.2-1b.prefill", 4, 32, 8, 1024, 1024, 64, True, 0),
    ("qwen2-0.5b.prefill", 4, 14, 2, 1024, 1024, 64, True, 0),
    ("yi-9b.d128", 2, 32, 4, 1024, 1024, 128, True, 0),
    ("llama3.2-1b.noncausal", 4, 32, 8, 1024, 1024, 64, False, 0),
    ("offset.sq256.sk1024", 2, 32, 8, 256, 1024, 64, True, 768),
    ("ragged.s100", 3, 14, 2, 100, 100, 64, True, 0),
    ("ragged.s1000", 2, 14, 2, 1000, 1000, 64, True, 0),
    ("ragged.s1000.noncausal.d40", 1, 8, 2, 1000, 1000, 40, False, 0),
    ("b1.s1", 1, 32, 8, 1, 1, 64, True, 0),
    ("b1.s1.offset", 1, 32, 8, 1, 77, 128, True, 76),
    ("olmoe.group1.d128", 4, 16, 16, 1024, 1024, 128, True, 0),
    ("granite-moe.prefill", 4, 16, 8, 1024, 1024, 64, True, 0),
    ("jamba.prefill.g8.d128", 4, 64, 8, 1024, 1024, 128, True, 0),
    ("seamless.encoder", 4, 16, 16, 1024, 1024, 64, False, 0),
    # the train phases' shapes: seamless-m4t-medium's encoder, decoder and
    # cross attention (4 rows of 4096 frames and 1024 targets a
    # microbatch), and Jamba's width cut (8/1 heads of 128, 4096)
    ("seamless.encoder.train", 4, 16, 16, 4096, 4096, 64, False, 0),
    ("seamless.decoder.train", 4, 16, 16, 1024, 1024, 64, True, 0),
    ("seamless.cross", 4, 16, 16, 1024, 4096, 64, False, 0),
    ("jamba.train.cut", 4, 8, 1, 4096, 4096, 128, True, 0),
    # a rank's launch where only the query heads divide ``model`` = 16
    # (``layers.head_case``'s ``QUERY``): prefill_32k's 2 rows a rank,
    # the sequence cut to 4096; its query heads on the one kv head they
    # read (llama3.2-1b 2 of 32 on 8, nemotron-4-15b 3 of 48 on 8), or
    # one kv head a query head where they straddle two (6 on 3 at 2)
    ("llama3.2-1b.rank16", 2, 2, 1, 4096, 4096, 64, True, 0),
    ("nemotron-4-15b.rank16", 2, 3, 1, 4096, 4096, 128, True, 0),
    ("straddle.ratio1", 2, 3, 3, 4096, 4096, 64, True, 0),
)
#: timed shapes: the prefill attention of the served models, and a
#: rank's under the query-head split
ATTN_TIMED = ("llama3.2-1b.prefill", "qwen2-0.5b.prefill", "yi-9b.d128",
              "olmoe.group1.d128", "granite-moe.prefill",
              "jamba.prefill.g8.d128", "seamless.encoder",
              "llama3.2-1b.rank16", "nemotron-4-15b.rank16",
              "straddle.ratio1")
#: the CUDA-core kernel's ms at the timed shapes before the tensor-core
#: redesign (chip_smoke.py's run on an NVIDIA H100 80GB HBM3, 700.00 W):
#: constants, not measured in this run, so they go only into the phase's
#: detail file as ``before_ms`` and never into the ``kernels`` line
ATTN_BEFORE_MS = {
    ("llama3.2-1b.prefill", "float32"): 0.8852784156799316,
    ("llama3.2-1b.prefill", "bfloat16"): 0.9006143569946289,
    ("qwen2-0.5b.prefill", "float32"): 0.45830078125,
    ("qwen2-0.5b.prefill", "bfloat16"): 0.4666143894195557,
    ("yi-9b.d128", "float32"): 1.5549519538879395,
    ("yi-9b.d128", "bfloat16"): 1.5030223846435546,
}
ATTN_HEADLINE = ("llama3.2-1b.prefill", "bfloat16")
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
#: the kernels of ``flash_attention.cu``: the f32 and the bf16 route
ATTN_KERNELS = ("flash_attention_kernel", "flash_attention_mma_kernel")


def attn_check(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    shapes = []
    for name, b, hq, hkv, sq, sk, d, causal, q_offset in ATTN_CASES:
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            q = (torch.randn(b * hq, sq, d, generator=gen)
                 * d ** -0.5).to(dtype).cuda()
            k = torch.randn(b * hkv, sk, d, generator=gen).to(dtype).cuda()
            v = torch.randn(b * hkv, sk, d, generator=gen).to(dtype).cuda()
            kw = dict(heads_q=hq, heads_kv=hkv, causal=causal,
                      q_offset=q_offset)
            run = lambda: fa.flash_attention(q, k, v, **kw)
            plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
            out, exp = run(), plain()
            torch.cuda.synchronize()
            what = f"{name} {dt_name}"
            if out.shape != exp.shape or out.dtype != exp.dtype:
                raise AssertionError(f"{what}: {out.shape} {out.dtype} vs "
                                     f"{exp.shape} {exp.dtype}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{what}: non-finite output")
            tol = ATTN_TOL[dt_name]
            diff = (out.float() - exp.float()).abs()
            if not bool((diff <= tol + tol * exp.float().abs()).all()):
                raise AssertionError(
                    f"{what}: max |err| {float(diff.max())} beyond atol = "
                    f"rtol = {tol}")
            err = float(diff.max())
            worst[dt_name] = max(worst[dt_name], err)
            n += 1
            if name not in ATTN_TIMED:
                continue
            ms = time_ms(run, warmup=3, reps=20)
            plain_ms = time_ms(plain, warmup=1, reps=5)
            dev_ms = device_ms(run, reps=10, kernel=ATTN_KERNELS)
            work = attention_work(b, hq, hkv, sq, sk, d, causal, q_offset,
                                  dtype)
            # yardstick: one PyTorch call for the same function (Sq == Sk,
            # no offset, so its causal convention is the kernel's)
            q4 = q.view(b, hq, sq, d)
            k4, v4 = k.view(b, hkv, sk, d), v.view(b, hkv, sk, d)
            lib = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=1.0, enable_gqa=True)
            lib_err = float((lib().float() - out.float().view(b, hq, sq, d))
                            .abs().max())
            if lib_err > tol + tol * float(exp.float().abs().max()):
                raise AssertionError(f"{what}: SDPA differs by {lib_err}")
            library_ms = time_ms(lib, warmup=3, reps=20)
            shapes.append({
                "shape": name, "dtype": dt_name,
                "q": [b, hq, sq, d], "kv": [b, hkv, sk, d],
                "causal": causal, "q_offset": q_offset,
                "ms": ms, "before_ms": ATTN_BEFORE_MS.get((name, dt_name)),
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": work.bound_ms(), "bound_by": work.bound_by(),
                "bytes": work.bytes, "flops": work.flops,
                "library_ms": library_ms,
                "library_vs_kernel_max_abs": lib_err, "max_abs_err": err,
            })
    return {"comparisons": n, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "shapes": shapes}


# ---------------------------------------------------------------------------
# the attention backward kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: a case whose q lies one element into its buffer (bf16: 2 bytes off 16):
#: TMA cannot read it, so the planner sends it to the ``"mma"`` route
ATTN_BWD_UNALIGNED = ("unaligned.q", 2, 8, 2, 300, 300, 64, True, 0)
#: (name, B, Hq, Hkv, Sq, Sk, D, causal, q_offset) — checked in f32 and
#: bf16; the first is llama3.2-1b's train shape (train_4k's sequence).
#: bf16 plans ``"wgmma"`` at heads of 64 and 128, ``"mma"`` at 16 and 40
#: and for ``ATTN_BWD_UNALIGNED``
ATTN_BWD_CASES = (
    ("llama3.2-1b.train", 4, 32, 8, 4096, 4096, 64, True, 0),
    ("granite-moe.train", 4, 16, 8, 4096, 4096, 64, True, 0),
    ("causal.g4.d64", 2, 8, 2, 512, 512, 64, True, 0),
    ("noncausal.g4.d64", 2, 8, 2, 512, 512, 64, False, 0),
    ("offset.sq256.sk1024", 2, 8, 2, 256, 1024, 64, True, 768),
    ("g1.d128", 2, 4, 4, 512, 512, 128, True, 0),
    ("g8.d128", 1, 16, 2, 512, 512, 128, True, 0),
    ("ragged.s100", 3, 14, 2, 100, 100, 64, True, 0),
    ("ragged.sq1000.sk777.noncausal.d40", 1, 8, 2, 1000, 777, 40, False, 0),
    ("ragged.offset", 2, 8, 1, 77, 300, 64, True, 223),
    ("d16.s1", 1, 4, 2, 1, 1, 16, True, 0),
    ("no-visible-key.offset-3", 1, 4, 2, 64, 64, 64, True, -3),
    ("seamless.cross", 4, 16, 16, 1024, 4096, 64, False, 0),
    ("seamless.encoder.train", 4, 16, 16, 4096, 4096, 64, False, 0),
    ("seamless.decoder.train", 4, 16, 16, 1024, 1024, 64, True, 0),
    ("jamba.train.cut", 4, 8, 1, 4096, 4096, 128, True, 0),
    ("qwen2-0.5b.train", 4, 14, 2, 1024, 1024, 64, True, 0),
    ATTN_BWD_UNALIGNED,
    # a rank's train_4k microbatch (4 rows) where only the query heads
    # divide ``model`` = 16, as in ``ATTN_CASES``
    ("llama3.2-1b.train.rank16", 4, 2, 1, 4096, 4096, 64, True, 0),
    ("nemotron-4-15b.train.rank16", 4, 3, 1, 4096, 4096, 128, True, 0),
    ("straddle.ratio1.train", 4, 3, 3, 4096, 4096, 64, True, 0),
)
ATTN_BWD_HEADLINE = ("llama3.2-1b.train", "bfloat16")
#: the bf16 shapes timed beside the bound, the plain version and SDPA's
#: backward besides the headline: a rank's under the query-head split
ATTN_BWD_TIMED = ("llama3.2-1b.train.rank16", "nemotron-4-15b.train.rank16",
                  "straddle.ratio1.train")
#: f32: the reference's own tolerance for its streaming backward
#: (``tests/test_layers.py::TestStreamingBackward``, atol = rtol = 2e-4).
#: bf16, per row: |err| ≤ 2e-2·|plain| + 1e-2·max(rowmax, 1e-3·max), where
#: rowmax is the largest |plain| of the element's row (a query row for dq
#: and the forward's out, a key row for dk and dv) and max the tensor's.
#: Causal rows shrink about as 1/√position, so 1e-2 of the tensor's max
#: alone lets through, at S 4096, a kernel that skips the last key tile's
#: dv.  The tensor cores round P (for dV) and dS
#: (for dK and dQ) to bf16 where the plain version keeps f32; emulated on
#: the CPU at the train shape's S 4096, GQA 4, D 64
#: (``tests/test_torch_attention_bwd.py``) that needs ≤ 3.4e-3 of the
#: row's scale, planted faults ≥ 0.29.  The floor covers rows whose true
#: gradient is 0 up to rounding (causal row 0 sees one key: dq = 0).
#: The forward's lse against the plain forward's: atol 1e-3 + rtol 1e-4
#: in both dtypes; its out: ``ATTN_TOL`` and, in bf16, the row rule too.
ATTN_BWD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 1e-2)}
ATTN_BWD_ROW_FLOOR = 1e-3
ATTN_BWD_KERNELS = ("attn_bwd_",)
#: the backward's three kernels, one launch each a call, every route
ATTN_BWD_EACH = ("attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")


def _need(got, want, rtol: float, axes, floor: float) -> float:
    """A row rule's use: max over the elements of (|got − want| −
    rtol·|want|)⁺ over the element's scale, max(rowmax, floor·max) —
    rowmax the largest |want| over ``axes`` of its row, max the tensor's
    (``axes`` None: the tensor's max alone).  The rule holds iff it is ≤
    the rule's atol; a nonzero error against an all-zero scale is inf."""
    import torch

    w = want.float()
    beyond = ((got.float() - w).abs() - rtol * w.abs()).clamp(min=0)
    top = w.abs().max()
    scale = (w.abs().amax(axes, keepdim=True).clamp(min=floor * float(top))
             if axes else top)
    return float(torch.where(beyond > 0, beyond / scale, 0.0).max())


def _row_need(got, want, per_row: bool = True) -> float:
    """The attention backward's bf16 rule (``_need``): rtol 2e-2, rows
    along the last axis, or with ``per_row=False`` the tensor's max; it
    holds iff this is ≤ 1e-2."""
    return _need(got, want, ATTN_BWD_TOL["bfloat16"][0],
                 (-1,) if per_row else None, ATTN_BWD_ROW_FLOOR)


def _grad_close(got, want, dtype_name: str, what: str) -> float:
    """max |got − want| within ``ATTN_BWD_TOL`` (f32: atol = rtol; bf16:
    rtol plus atol as a share of the row's scale, ``_row_need``); raises
    beyond it."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite gradient")
    rtol, atol = ATTN_BWD_TOL[dtype_name]
    w = want.float()
    diff = (got.float() - w).abs()
    if dtype_name == "bfloat16":
        need = _row_need(got, want)
        if not need <= atol:
            raise AssertionError(f"{what}: needs {need} of the row's scale "
                                 f"beyond rtol {rtol}; the rule allows "
                                 f"{atol}")
    elif not bool((diff <= atol + rtol * w.abs()).all()):
        raise AssertionError(f"{what}: max |err| {float(diff.max())} beyond "
                             f"atol {atol} + rtol {rtol}")
    return float(diff.max())


def attn_bwd_check(torch) -> dict:
    """The backward kernel against ``flash_attention_bwd_plain`` on the
    same (q, k, v, out, lse, dout) — out and lse from the forward kernel —
    at every case in both dtypes; the forward kernel's lse against the
    plain forward's; two runs of the kernel giving the same bits; rows
    that see no key passing no gradient.  At the train shape, timed beside
    the plain version, the bound and SDPA's backward as yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    shapes = []
    for name, b, hq, hkv, sq, sk, d, causal, q_offset in ATTN_BWD_CASES:
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            what = f"{name} {dt_name}"
            q = (torch.randn(b * hq, sq, d, generator=gen)
                 * d ** -0.5).to(dtype).cuda()
            if name == ATTN_BWD_UNALIGNED[0]:   # one element into a buffer
                buf = torch.empty(q.numel() + 1, dtype=dtype, device="cuda")
                buf[1:].copy_(q.reshape(-1))
                q = buf[1:].view(q.shape)
            k = torch.randn(b * hkv, sk, d, generator=gen).to(dtype).cuda()
            v = torch.randn(b * hkv, sk, d, generator=gen).to(dtype).cuda()
            dout = torch.randn(b * hq, sq, d, generator=gen).to(dtype).cuda()
            kw = dict(heads_q=hq, heads_kv=hkv, causal=causal,
                      q_offset=q_offset)
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            out_plain, lse_plain = fa.flash_attention_plain(
                q, k, v, return_lse=True, **kw)
            lse_err = float((lse - lse_plain).abs().max())
            if not bool(((lse - lse_plain).abs()
                         <= 1e-3 + 1e-4 * lse_plain.abs()).all()):
                raise AssertionError(f"{what}: forward lse off by {lse_err}")
            out_err = _out_close(out, out_plain, dt_name, what)
            del out_plain, lse_plain
            bkw = dict(kw, scale=d ** -0.5)
            run = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                 **bkw)
            plain = lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, dout, **bkw)
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{what}: two runs differ in bits")
            err = max(_grad_close(g_, w_, dt_name, f"{what} {nm}")
                      for g_, w_, nm in zip(got, want, ("dq", "dk", "dv")))
            if q_offset < 0:        # rows 0 .. -q_offset-1 see no key
                hidden = -q_offset
                if bool(got[0][:, :hidden].any()) or bool(
                        out[:, :hidden].float().any()):
                    raise AssertionError(
                        f"{what}: a row that sees no key passed a gradient")
            worst[dt_name] = max(worst[dt_name], err)
            n += 1
            route = fa.bwd_plan(q, k, v, dout, heads_q=hq,
                                heads_kv=hkv).route
            if dt_name == "bfloat16" and route != (
                    "mma" if name == ATTN_BWD_UNALIGNED[0] or d % 64
                    else "wgmma"):
                raise AssertionError(f"{what}: planned {route}")
            row = {"shape": name, "dtype": dt_name, "route": route,
                   "q": [b, hq, sq, d], "kv": [b, hkv, sk, d],
                   "causal": causal, "q_offset": q_offset,
                   "max_abs_err": err, "lse_max_abs_err": lse_err,
                   "out_max_abs_err": out_err}
            if dt_name == "bfloat16":
                row["row_need"] = {nm: _row_need(g_, w_) for g_, w_, nm in
                                   zip(got, want, ("dq", "dk", "dv"))}
            if (name, dt_name) == ATTN_BWD_HEADLINE:
                row["planted_faults"] = _planted_faults(
                    fa, q, k, v, out, lse, dout, got, want, bkw)
            if (name, dt_name) == ATTN_BWD_HEADLINE or (
                    name in ATTN_BWD_TIMED and dt_name == "bfloat16"):
                row.update(_attn_bwd_times(torch, F, run, plain, q, k, v,
                                           out, lse, dout, got, b, hq, hkv,
                                           sq, sk, d, causal, q_offset))
            shapes.append(row)
            del q, k, v, dout, out, lse, got, again, want
    torch.cuda.empty_cache()
    return {"comparisons": n, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "shapes": shapes}


def _out_close(out, want, dtype_name: str, what: str) -> float:
    """The forward kernel's out against the plain forward's: ``attn_check``'s
    rule (``ATTN_TOL``) and, in bf16, the backward's row rule."""
    diff = (out.float() - want.float()).abs()
    tol = ATTN_TOL[dtype_name]
    if not bool((diff <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"{what}: forward out off by "
                             f"{float(diff.max())} beyond atol = rtol = {tol}")
    if dtype_name == "bfloat16":
        _grad_close(out, want, dtype_name, f"{what} forward out")
    return float(diff.max())


#: the dK/dV kernel's tiles on the headline's route ("wgmma"): keys a
#: block, query rows a ring slot — ``dse.ATTN_BWD_WG_TILES["dkdv"]``, which
#: a test holds equal
ATTN_BWD_KEY_TILE = 128
ATTN_BWD_Q_STEP = 64


def attn_bwd_q_stale(q, k, v, out, lse, dout, *, heads_q: int,
                     heads_kv: int, causal: bool, q_offset: int,
                     key_tile: int = ATTN_BWD_KEY_TILE,
                     q_step: int = ATTN_BWD_Q_STEP, **_) -> tuple:
    """The effect on (dk, dv), f32, of a stale ring slot in the dK/dV
    kernel: the last query tile of each key block's walk (the group's
    heads in turn, each over the query tiles of ``q_step`` rows that see
    the block) read from the slot before it — the previous tile's Q, dO,
    lse and delta taken for the last one, under the last one's positions.
    Layout as ``flash_attention_bwd``; ``q`` pre-scaled."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    bhq, sq, d = q.shape
    sk = k.shape[1]
    b, g = bhq // heads_q, heads_q // heads_kv
    qf = q.float().reshape(b, heads_kv, g, sq, d)
    dof = dout.float().reshape(b, heads_kv, g, sq, d)
    lsef = lse.float().reshape(b, heads_kv, g, sq)
    delta = (dof * out.float().reshape(b, heads_kv, g, sq, d)).sum(-1)
    kf = k.float().reshape(b, heads_kv, sk, d)
    vf = v.float().reshape(b, heads_kv, sk, d)
    n_qt = -(-sq // q_step)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)

    def contrib(data, at, k0, k1):
        """dk, dv of keys k0..k1 from the query tile ``data`` = (head,
        tile) at the positions of tile ``at`` (rows past either's end add
        nothing)."""
        (gd, td), (_, ta) = data, at
        r0 = ta * q_step
        n = min(sq - td * q_step, sq - r0, q_step)
        rows = slice(td * q_step, td * q_step + n)
        qc, doc = qf[:, :, gd, rows], dof[:, :, gd, rows]
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf[:, :, k0:k1])
        p = torch.exp(s - lsef[:, :, gd, rows, None])
        if causal:
            vis = fa.causal_mask(n, k1 - k0, r0 + q_offset - k0, q.device)
            p = torch.where(vis, p, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", doc, vf[:, :, k0:k1])
        ds = p * (dp - delta[:, :, gd, rows, None])
        return (torch.einsum("bhqk,bhqd->bhkd", ds, qc),
                torch.einsum("bhqk,bhqd->bhkd", p, doc))

    for k0 in range(0, sk, key_tile):
        k1 = min(sk, k0 + key_tile)
        qt0 = (max(0, k0 - q_offset) if causal else 0) // q_step
        walk = [(gi, t) for gi in range(g) for t in range(qt0, n_qt)]
        if len(walk) < 2:
            continue
        bad = contrib(walk[-2], walk[-1], k0, k1)
        good = contrib(walk[-1], walk[-1], k0, k1)
        dk[:, :, k0:k1] = bad[0] - good[0]
        dv[:, :, k0:k1] = bad[1] - good[1]
    return dk.reshape(k.shape), dv.reshape(v.shape)


def _planted_faults(fa, q, k, v, out, lse, dout, got, want, bkw) -> dict:
    """The bf16 rule against faults planted in the kernel's own gradients
    at one shape: each must fail it.  "last key tile skipped" takes the
    last key tile's share out of dq (its diagonal tile's, from the plain
    backward of that tile alone) and zeroes that tile's dk and dv rows;
    "dv 0, last quarter" zeroes dv of the last quarter of the keys; "dq
    ×1.3 past the first quarter" scales those query rows; "q_stale" adds
    to dk and dv the effect of a stale ring slot (:func:`attn_bwd_q_stale`).
    Beside each: the share of the scale it needs per row and per tensor,
    both against the rule's 1e-2."""
    t = ATTN_BWD_KEY_TILE
    sq, sk = q.shape[1], k.shape[1]
    dq, dk, dv = got
    tile = fa.flash_attention_bwd_plain(
        q[:, sq - t:], k[:, sk - t:], v[:, sk - t:], out[:, sq - t:],
        lse[:, sq - t:], dout[:, sq - t:],
        **dict(bkw, q_offset=bkw["q_offset"] + sq - sk))
    skipped_dq = dq.clone()
    skipped_dq[:, sq - t:] = (dq[:, sq - t:].float()
                              - tile[0].float()).to(dq.dtype)
    faults = {"last key tile skipped: dq": (skipped_dq, want[0]),
              "last key tile skipped: dk": (dk.clone(), want[1]),
              "last key tile skipped: dv": (dv.clone(), want[2]),
              "dv 0, last quarter of the keys": (dv.clone(), want[2]),
              "dq x1.3 past the first quarter": (dq.clone(), want[0])}
    faults["last key tile skipped: dk"][0][:, sk - t:] = 0
    faults["last key tile skipped: dv"][0][:, sk - t:] = 0
    faults["dv 0, last quarter of the keys"][0][:, sk - sk // 4:] = 0
    late = faults["dq x1.3 past the first quarter"][0][:, sq // 4:]
    late.copy_((late.float() * 1.3).to(late.dtype))
    stale = attn_bwd_q_stale(q, k, v, out, lse, dout, **bkw)
    for i, nm in ((1, "dk"), (2, "dv")):
        faults[f"q_stale: {nm}"] = (
            (got[i].float() + stale[i - 1]).to(got[i].dtype), want[i])
    rule = ATTN_BWD_TOL["bfloat16"][1]
    report = {}
    for name, (bad, good) in faults.items():
        per_row = _row_need(bad, good)
        report[name] = {"need_per_row": per_row,
                        "need_per_tensor": _row_need(bad, good, False),
                        "caught": per_row > rule}
        if per_row <= rule:
            raise AssertionError(f"the bf16 rule lets a planted fault pass: "
                                 f"{name} needs only {per_row}")
    return report


def _attn_bwd_times(torch, F, run, plain, q, k, v, out, lse, dout, got, b,
                    hq, hkv, sq, sk, d, causal, q_offset) -> dict:
    """ms of the kernel (CUDA events; device ms from the profiler, the
    three kernels summed, and each kernel's own with the TFLOP/s of its
    work: delta 2·D flops a query row, dK/dV four products of 2·D flops a
    visible (query, key) pair, dQ three), of the plain version and of
    SDPA's backward (flash backend, k and v expanded to the query heads,
    so it is the backward alone) at one shape; the bound: five products of
    2·D flops per visible pair at the bf16 tensor-core peak, or the bytes
    in and out at 3.35 TB/s; beside it the design's floor, its seven
    products at the peak (the dQ pass recomputes S and dP)."""
    ms = time_ms(run, warmup=1, reps=5)
    each = device_ms_each(run, reps=3, kernels=ATTN_BWD_EACH)
    plain_ms = time_ms(plain, warmup=1, reps=2)
    bound = attention_bwd_work(b, hq, hkv, sq, sk, d, causal, q_offset,
                               q.dtype)
    pairs = b * hq * visible_pairs(sq, sk, causal, q_offset)
    work = {"attn_bwd_delta": 2 * d * b * hq * sq,
            "attn_bwd_dkdv": 4 * 2 * d * pairs,
            "attn_bwd_dq": 3 * 2 * d * pairs}
    g = hq // hkv
    q4 = q.view(b, hq, sq, d).detach().requires_grad_(True)
    ke = k.view(b, hkv, sk, d).repeat_interleave(g, 1).requires_grad_(True)
    ve = v.view(b, hkv, sk, d).repeat_interleave(g, 1).requires_grad_(True)
    o4 = F.scaled_dot_product_attention(q4, ke, ve, is_causal=causal,
                                        scale=1.0)
    do4 = dout.view(b, hq, sq, d)
    lib = lambda: torch.autograd.grad(o4, (q4, ke, ve), do4,
                                      retain_graph=True)
    ldq, ldk, ldv = lib()
    lib_dk = ldk.float().view(b, hkv, g, sk, d).sum(2).view_as(got[1])
    lib_err = max(float((ldq.float().view_as(got[0]) * d ** -0.5
                         - got[0].float()).abs().max()),
                  float((lib_dk - got[1].float()).abs().max()))
    library_ms = time_ms(lib, warmup=1, reps=5)
    return {"ms": ms, "device_ms": each["per_call"],
            "device_ms_each": {k_: each[k_] for k_ in ATTN_BWD_EACH},
            "tflops_each": {k_: work[k_] / (each[k_] * 1e-3) / 1e12
                            if each[k_] else None for k_ in ATTN_BWD_EACH},
            "plain_ms": plain_ms,
            "bound_ms": bound.bound_ms(), "bound_by": bound.bound_by(),
            "bytes": bound.bytes, "flops": bound.flops,
            "design_floor_ms": 7 * 2 * d * pairs
            / TENSOR_CORE_BF16_OPS_PER_S * 1e3,
            "library_ms": library_ms,
            "library_vs_kernel_max_abs": lib_err}


# ---------------------------------------------------------------------------
# phase 9: the fused-MLP kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: (name, M, D, F, gated, act) — checked in f32 and bf16
MLP_CASES = (
    ("llama3.2-1b.prefill", 4096, 2048, 8192, True, "silu"),
    ("llama3.2-1b.decode", 4, 2048, 8192, True, "silu"),
    ("qwen2-0.5b.prefill", 4096, 896, 4864, True, "silu"),
    ("qwen2-0.5b.m100", 100, 896, 4864, True, "silu"),
    ("yi-9b.m1", 1, 4096, 11008, True, "silu"),
    ("d4096.m100.ungated", 100, 4096, 2048, False, "gelu"),
    ("d8192.limit", 4, 8192, 1024, True, "silu"),
    ("odd.d895.f999", 37, 895, 999, True, "gelu"),   # element-wise loads
    ("seamless.d1024.f4096.ungated", 64, 1024, 4096, False, "gelu"),
    ("nemotron.d6144.f24576.ungated", 4, 6144, 24576, False, "squared_relu"),
    ("qwen2-vl-72b.d8192.f29568.m4", 4, 8192, 29568, True, "silu"),
) + tuple(
    (f"{act}.{'gated' if gated else 'ungated'}.f1000", 100, 896, 1000,
     gated, act)
    for act in ("silu", "gelu", "relu", "squared_relu")
    for gated in (True, False))
#: timed shapes: the streamed MLP of llama3.2-1b at prefill and decode
MLP_TIMED = ("llama3.2-1b.prefill", "llama3.2-1b.decode")
#: the CUDA-core kernel's ms at the timed shapes before the tensor-core
#: redesign (chip_smoke.py's run on an NVIDIA H100 80GB HBM3, 700.00 W):
#: constants, not measured in this run, so they go only into the phase's
#: detail file as ``before_ms`` and never into the ``kernels`` line
MLP_BEFORE_MS = {
    ("llama3.2-1b.prefill", "float32"): 27.784515380859375,
    ("llama3.2-1b.prefill", "bfloat16"): 48.992367553710935,
    ("llama3.2-1b.decode", "float32"): 0.1472928047180176,
    ("llama3.2-1b.decode", "bfloat16"): 0.245961594581604,
}
MLP_HEADLINE = ("llama3.2-1b.prefill", "bfloat16")
#: f32: the reference's 5e-4 (tests/test_kernels.py:159); bf16: the
#: output is rounded to bf16 (one step is 2^-8 relative), 1e-2 allows it
MLP_TOL = {"float32": 5e-4, "bfloat16": 1e-2}
#: the kernels of ``fused_mlp.cu``: both routes and the summing pass
MLP_KERNELS = ("fused_mlp_kernel", "fused_mlp_mma_kernel",
               "sum_partials_kernel")


def _mlp_dense(torch, x, wg, wu, wd, act):
    """The yardstick: ``mlp_impl="dense"``'s three cuBLAS products plus
    the activation, in the input dtype — several calls, not one."""
    from repro_torch.kernels import ref

    up = x @ wu
    h = ref._act(act, x @ wg) * up if wg is not None else ref._act(act, up)
    return h @ wd


def mlp_check(torch) -> dict:
    from repro_torch.core import dse
    from repro_torch.kernels import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    shapes = []
    for name, m, d, f, gated, act in MLP_CASES:
        x32 = torch.randn(m, d, generator=gen)
        w32 = [torch.randn(d, f, generator=gen) * d ** -0.5 if gated
               else None,
               torch.randn(d, f, generator=gen) * d ** -0.5,
               torch.randn(f, d, generator=gen) * f ** -0.5]
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            x = x32.to(dtype).cuda()
            wg, wu, wd = (None if w is None else w.to(dtype).cuda()
                          for w in w32)
            run = lambda: fm.fused_mlp(x, wg, wu, wd, act=act)
            plain = lambda: fm.fused_mlp_plain(x, wg, wu, wd, act=act)
            out, exp = run(), plain()
            torch.cuda.synchronize()
            what = f"{name} {dt_name}"
            if out.shape != exp.shape or out.dtype != exp.dtype:
                raise AssertionError(f"{what}: {out.shape} {out.dtype} vs "
                                     f"{exp.shape} {exp.dtype}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{what}: non-finite output")
            tol = MLP_TOL[dt_name]
            diff = (out.float() - exp.float()).abs()
            if not bool((diff <= tol + tol * exp.float().abs()).all()):
                raise AssertionError(
                    f"{what}: max |err| {float(diff.max())} beyond atol = "
                    f"rtol = {tol}")
            err = float(diff.max())
            worst[dt_name] = max(worst[dt_name], err)
            n += 1
            if name not in MLP_TIMED:
                continue
            plan = dse.plan_mlp_blocks(m=m, d=d, f=f, dtype=dt_name)
            ms = time_ms(run, warmup=2, reps=10)
            plain_ms = time_ms(plain, warmup=1, reps=5)
            dev_ms = device_ms(run, reps=5, kernel=MLP_KERNELS)
            lib = lambda: _mlp_dense(torch, x, wg, wu, wd, act)
            lib_err = float((lib().float() - exp.float()).abs().max())
            library_ms = time_ms(lib, warmup=2, reps=10)
            work = mlp_work(m, d, f, gated, dtype)
            shapes.append({
                "shape": name, "dtype": dt_name, "m": m, "d": d, "f": f,
                "gated": gated, "act": act, "plan": plan.blocks,
                "ms": ms, "before_ms": MLP_BEFORE_MS[(name, dt_name)],
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": work.bound_ms(), "bound_by": work.bound_by(),
                "bytes": work.bytes, "flops": work.flops,
                "library_ms": library_ms,
                "library_is": "dense MLP: 3 cuBLAS matmuls + activation",
                "library_vs_plain_max_abs": lib_err, "max_abs_err": err,
            })
    # weights that are contiguous views one element into their storage:
    # pairs of elements are not aligned, the kernel loads them one by one
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        m, d, f = 5, 256, 320
        stores = [(torch.randn(d * f + 1, generator=gen) * 0.06).to(
            dtype).cuda() for _ in range(3)]
        wg, wu = stores[0][1:].view(d, f), stores[1][1:].view(d, f)
        wd = stores[2][1:].view(f, d)
        x = torch.randn(m, d, generator=gen).to(dtype).cuda()
        out = fm.fused_mlp(x, wg, wu, wd, act="relu")
        exp = fm.fused_mlp_plain(x, wg, wu, wd, act="relu")
        torch.cuda.synchronize()
        tol = MLP_TOL[dt_name]
        diff = (out.float() - exp.float()).abs()
        if not bool((diff <= tol + tol * exp.float().abs()).all()):
            raise AssertionError(f"offset views {dt_name}: max |err| "
                                 f"{float(diff.max())}")
        worst[dt_name] = max(worst[dt_name], float(diff.max()))
        n += 1
    # the register accumulator's limit: one D past it raises, never runs
    too_wide = torch.zeros(1, dse.MLP_MAX_D + 256).cuda()
    w_up = torch.zeros(dse.MLP_MAX_D + 256, 64).cuda()
    try:
        fm.fused_mlp(too_wide, None, w_up, w_up.T.contiguous())
    except ValueError:
        pass
    else:
        raise AssertionError("fused_mlp took a D past its limit")
    return {"comparisons": n, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "d_limit": dse.MLP_MAX_D,
            "shapes": shapes}


#: the bf16 fused MLP with parts switched off (probe bits of the timing
#: build ``-DFUSED_MLP_PROBE``: 1 the cluster exchange, 2 the mma, 4 the
#: weight loads); the results of such calls are wrong and not checked,
#: only timed
MLP_PROBES = (("probe_ms", 0), ("no_exchange_ms", 1), ("no_mma_ms", 2),
              ("no_loads_ms", 4), ("loads_only_ms", 3), ("mma_only_ms", 5),
              ("exchange_only_ms", 6))


def mlp_probe_library(build, fm):
    """``csrc/fused_mlp.cu`` built with ``-DFUSED_MLP_PROBE`` into a
    library of its own, loaded by :func:`mlp_probe` and nothing else: the
    package's library has no probe."""
    import ctypes

    def declare(lib):
        fm._declare(lib)
        lib.fused_mlp_set_probe.argtypes = [ctypes.c_int]
        lib.fused_mlp_set_probe.restype = None

    return build.CudaLibrary("fused_mlp_probe", declare,
                             source=fm.LIBRARY.source,
                             flags=("-DFUSED_MLP_PROBE",))


def mlp_probe(torch, probe_lib) -> dict:
    """Where the bf16 fused MLP's time goes at llama3.2-1b's prefill and
    decode shapes: ms of the package's kernel, and of the timing build
    with no bit set (its output must equal the package's bit for bit),
    beside ms with parts of it switched off."""
    from repro_torch.core import dse
    from repro_torch.kernels import fused_mlp as fm

    lib = probe_lib.load()
    gen = torch.Generator().manual_seed(0)
    d, f = 2048, 8192
    out = {}
    for name, m in (("llama3.2-1b.prefill", 4096), ("llama3.2-1b.decode", 4)):
        x = torch.randn(m, d, generator=gen).to(torch.bfloat16).cuda()
        wg, wu, wd = [(torch.randn(s, generator=gen) * s[0] ** -0.5).to(
            torch.bfloat16).cuda() for s in ((d, f), (d, f), (f, d))]
        blocks = dse.plan_mlp_blocks(m=m, d=d, f=f, dtype="bfloat16").blocks
        y = torch.empty_like(x)
        part = torch.empty((blocks["splits"], m, d), device="cuda") \
            if blocks["splits"] > 1 else None

        def launch():
            rc = lib.fused_mlp_launch(
                x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                y.data_ptr(), None if part is None else part.data_ptr(),
                1, m, d, f, fm.ACT_CODES["silu"], 1, blocks["rows"],
                blocks["cols"], blocks["cluster"], blocks["tiles_per_split"],
                blocks["splits"], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(
                    lib.fused_mlp_error_string(rc).decode())

        reps = 10 if m > 4 else 50
        row = {"ms": time_ms(lambda: fm.fused_mlp(x, wg, wu, wd, act="silu"),
                             warmup=2, reps=reps)}
        lib.fused_mlp_set_probe(0)
        launch()
        exp = fm.fused_mlp(x, wg, wu, wd, act="silu").float()
        diff = float((y.float() - exp).abs().max())
        tol = MLP_TOL["bfloat16"]
        if diff > tol + tol * float(exp.abs().max()):
            raise AssertionError(
                f"mlp_probe {name}: the timing build with no probe bit "
                f"differs from the package's kernel by {diff}")
        row["probe_vs_package_max_abs"] = diff
        for key, bits in MLP_PROBES:
            lib.fused_mlp_set_probe(bits)
            try:
                row[key] = time_ms(launch, warmup=2, reps=reps)
            finally:
                lib.fused_mlp_set_probe(0)
        out[name] = row
    return out


# ---------------------------------------------------------------------------
# phase 10b: the fused MLP's backward kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: (name, M, D, F, gated, act) — checked in f32 and bf16; the first is
#: llama3.2-1b's train microbatch with ``mlp_impl="streamed"`` (4 rows of
#: train_4k's 4096 positions)
MLP_BWD_CASES = (
    ("llama3.2-1b.train", 16384, 2048, 8192, True, "silu"),
    ("qwen2-0.5b.m1000", 1000, 896, 4864, True, "silu"),
    ("odd.d895.f999", 37, 895, 999, True, "gelu"),    # element-wise loads
    ("m1.ungated", 1, 256, 320, False, "relu"),
) + tuple(
    (f"{act}.{'gated' if gated else 'ungated'}.m100", 100, 256, 1000,
     gated, act)
    for act in ("silu", "gelu", "relu", "squared_relu")
    for gated in (True, False))
MLP_BWD_HEADLINE = ("llama3.2-1b.train", "bfloat16")
MLP_BWD_GRADS = ("dx", "dwg", "dwu", "dwd")
#: ``MLP_TOL``'s rule per element of each gradient against its row's
#: scale (``_need``, rows along the last axis: a token's dx, a hidden
#: column's dWd, a model column's dWu and dWg): |err| ≤ tol·|plain| +
#: tol·max(rowmax, 1e-3·max), f32 5e-4, bf16 1e-2
MLP_BWD_ROW_FLOOR = 1e-3
#: the f32 operands the bf16 kernels take as hi + lo
MLP_BWD_HILO = ("h", "du", "dg")
#: the share of the bf16 rule the kernels' worst gradient may need at the
#: headline.  Emulated on the CPU (``mlp_bwd_split``,
#: ``tests/test_torch_fused_mlp_bwd.py``) hi + lo needs ≤ 3e-4 of it, and
#: any one of h, du, dg rounded to bf16 alone 0.15 or more: a kernel that
#: dropped a lo part would meet the rule, but not this
MLP_BWD_HILO_SHARE = 0.02
#: the backward's three kernels (one launch each a call), both routes
MLP_BWD_KERNELS = ("mlp_bwd_hidden", "mlp_bwd_wgrad", "mlp_bwd_dx")
#: the faults the rule must catch: a wrong activation derivative (the
#: logistic sigmoid in its place), the last hidden tile of dWd read from
#: the tile before it (``f_shift``: by the hidden kernel's tile of F,
#: ``dse.MLP_BWD_HIDDEN_TILE``) and the last K chunk of the
#: weight-gradient walk read from the ring slot before it (``k_stale``:
#: the chunk before, ``dse.MLP_BWD_CHUNK_K`` rows of M, in A and B alike —
#: a stale mbarrier phase)
MLP_BWD_FAULTS = ("act_grad", "f_shift", "k_stale")
#: a bf16 case whose x lies one element off a 16-byte boundary: TMA cannot
#: read it, so the planner sends it to the ``"mma"`` route
MLP_BWD_UNALIGNED = ("unaligned.x.m100", 100, 256, 1000, True, "silu")


def mlp_bwd_split(x, wg, wu, wd, dy, *, act: str, hilo: bool = False,
                  bf16_alone=None, fault=None):
    """The backward kernels' formula in plain PyTorch, f32, over all of F
    at once: ``fused_mlp.mlp_bwd_hidden`` then ``mlp_bwd_sums``, the plain
    backward's own two steps → (dx, dWg or None, dWu, dWd) in f32.  With
    ``hilo`` each of ``MLP_BWD_HILO`` is rounded between the two where the
    bf16 kernels round it (hi + lo), and ``bf16_alone`` names one of them
    to round to bf16 alone instead; ``fault`` plants one of
    ``MLP_BWD_FAULTS``."""
    import torch

    from repro_torch.core import dse
    from repro_torch.kernels import fused_mlp as fm

    def rnd(name, t):
        if t is None:
            return None
        if name == bf16_alone:
            return _bf16_round(t, lo=False)
        return _bf16_round(t, lo=True) if hilo else t

    deriv = torch.sigmoid if fault == "act_grad" else None
    h, du, dg = fm.mlp_bwd_hidden(x, wg, wu, wd, dy, act=act, deriv=deriv)
    h, du, dg = rnd("h", h), rnd("du", du), rnd("dg", dg)
    if fault == "f_shift":
        k = dse.MLP_BWD_HIDDEN_TILE["bfloat16"][1]
        h[:, -k:] = h[:, -2 * k:-k].clone()
    if fault == "k_stale":
        k = dse.MLP_BWD_CHUNK_K["bfloat16"]

        def stale(t):
            if t is None:
                return None
            t = t.clone()
            t[-k:] = t[-2 * k:-k]
            return t

        dx = fm.mlp_bwd_sums(x, wg, wu, dy, h, du, dg)[0]
        _, dwg, dwu, dwd = fm.mlp_bwd_sums(stale(x), wg, wu, stale(dy),
                                           stale(h), stale(du), stale(dg))
        return dx, dwg, dwu, dwd
    return fm.mlp_bwd_sums(x, wg, wu, dy, h, du, dg)


def _mlp_bwd_need(got, want, dtype_name: str) -> float:
    """The MLP backward's rule (``_need``): ``MLP_TOL`` as rtol and atol,
    rows along the last axis; it holds iff this is ≤ the tolerance."""
    return _need(got, want, MLP_TOL[dtype_name], (-1,), MLP_BWD_ROW_FLOOR)


def _mlp_bwd_close(got, want, dtype_name: str, what: str) -> dict:
    """Each gradient within the rule: finite, of the plain version's shape
    and dtype → {"need": {name: need}, "max_abs_err"}; raises beyond it."""
    import torch

    tol = MLP_TOL[dtype_name]
    needs, worst = {}, 0.0
    for name, g, w in zip(MLP_BWD_GRADS, got, want):
        if w is None:
            if g is not None:
                raise AssertionError(f"{what} {name}: ungated, but given")
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} {name}: {tuple(g.shape)} {g.dtype}"
                                 f" vs {tuple(w.shape)} {w.dtype}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {name}: non-finite gradient")
        needs[name] = _mlp_bwd_need(g, w, dtype_name)
        if not needs[name] <= tol:
            raise AssertionError(f"{what} {name}: needs {needs[name]} of the "
                                 f"row's scale beyond rtol; the rule allows "
                                 f"{tol}")
        worst = max(worst, float((g.float() - w.float()).abs().max()))
    return {"need": needs, "max_abs_err": worst}


def _with_effect(got, effect, clean):
    """``got`` plus the difference a planted change makes to the
    formula (``effect`` less ``clean``), in ``got``'s dtypes."""
    return [None if g is None else (g.float() + (e - c)).to(g.dtype)
            for g, e, c in zip(got, effect, clean)]


def _mlp_bwd_faults(inputs, act, got, want) -> dict:
    """The rule against each fault of ``MLP_BWD_FAULTS`` planted in the
    kernels' own bf16 gradients (its effect on ``mlp_bwd_split`` added to
    them): each must fail it."""
    clean = mlp_bwd_split(*inputs, act=act, hilo=True)
    tol = MLP_TOL["bfloat16"]
    report = {}
    for fault in MLP_BWD_FAULTS:
        bad = _with_effect(got, mlp_bwd_split(*inputs, act=act, hilo=True,
                                              fault=fault), clean)
        needs = {n: _mlp_bwd_need(b, w, "bfloat16")
                 for n, b, w in zip(MLP_BWD_GRADS, bad, want)
                 if w is not None}
        worst = max(needs.values())
        report[fault] = {"need": needs, "caught": worst > tol}
        if not worst > tol:
            raise AssertionError(f"the MLP backward rule lets a planted "
                                 f"fault pass: {fault} needs only {worst}")
    return report


def _mlp_bwd_hilo_check(inputs, act, got, want, needs: dict) -> dict:
    """The bf16 kernels' hi + lo at one shape: their gradients need at most
    ``MLP_BWD_HILO_SHARE`` of the rule, and each of ``MLP_BWD_HILO``
    rounded to bf16 alone (a dropped lo part, planted as its effect on
    ``mlp_bwd_split``) needs more → {"share", "bound", "lo_dropped": {op:
    share}}; raises where either fails."""
    tol = MLP_TOL["bfloat16"]
    share = max(needs.values()) / tol
    if not share <= MLP_BWD_HILO_SHARE:
        raise AssertionError(f"the bf16 MLP backward needs {share} of the "
                             f"rule, beyond the {MLP_BWD_HILO_SHARE} its hi "
                             "+ lo operands allow")
    clean = mlp_bwd_split(*inputs, act=act, hilo=True)
    dropped = {}
    for op in MLP_BWD_HILO:
        if op == "dg" and inputs[1] is None:
            continue
        bad = _with_effect(got, mlp_bwd_split(*inputs, act=act, hilo=True,
                                              bf16_alone=op), clean)
        dropped[op] = max(_mlp_bwd_need(b, w, "bfloat16")
                          for b, w in zip(bad, want) if w is not None) / tol
        if not dropped[op] > MLP_BWD_HILO_SHARE:
            raise AssertionError(f"the MLP backward's hi + lo bound lets "
                                 f"{op} in bf16 alone pass: it needs only "
                                 f"{dropped[op]} of the rule")
    return {"share": share, "bound": MLP_BWD_HILO_SHARE,
            "lo_dropped": dropped}


def _mlp_bwd_times(torch, run, plain, inputs, got, act) -> dict:
    """ms of a call (CUDA events, warm L2; device ms from the profiler, the
    three kernels summed, and each kernel's own), of the plain version and
    of the library yardstick — autograd's backward of the dense MLP, three
    ``torch.matmul`` with g and u saved — at one shape; the bound:
    12·M·D·F operations (dh, dWd, dWu, dWg, dx's two products; ungated 8)
    at the bf16 tensor-core rate, or the bytes in and out at 3.35 TB/s;
    beside it the design's floor, the bound's operations plus the
    recompute of g and u (4·M·D·F; ungated 2)."""
    from repro_torch.kernels import ref

    x, wg, wu, wd, dy = inputs
    m, d = x.shape
    f = wu.shape[1]
    gated = wg is not None
    ms_ = time_ms(run, warmup=1, reps=5)
    each = device_ms_each(run, reps=3, kernels=MLP_BWD_KERNELS)
    plain_ms = time_ms(plain, warmup=1, reps=2)
    leaves = [t.detach().requires_grad_(True) for t in (x, wg, wu, wd)
              if t is not None]
    lx, *lw = leaves
    up = lx @ lw[-2]
    hid = ref._act(act, lx @ lw[0]) * up if gated else ref._act(act, up)
    out = hid @ lw[-1]
    lib = lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)
    lib_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(lib(), [g for g in got if g is not None]))
    library_ms = time_ms(lib, warmup=1, reps=5)
    bound = mlp_bwd_work(m, d, f, gated, x.dtype)
    recompute = 2 * m * d * f * (2 if gated else 1)
    work = mlp_bwd_mma_work(m, d, f, gated)
    return {"ms": ms_, "device_ms": each["per_call"],
            "device_ms_each": {k: each[k] for k in MLP_BWD_KERNELS},
            "mma_work": work,
            "tflops_each": {k: work[k] / (each[k] * 1e-3) / 1e12
                            if each[k] else None for k in MLP_BWD_KERNELS},
            "plain_ms": plain_ms, "bound_ms": bound.bound_ms(),
            "bound_by": bound.bound_by(),
            "bytes": bound.bytes, "flops": bound.flops,
            "design_floor_ms": (bound.flops + recompute)
            / TENSOR_CORE_BF16_OPS_PER_S * 1e3,
            "library_ms": library_ms,
            "library_is": "autograd's backward of the dense MLP (three "
                          "torch.matmul, g and u saved)",
            "library_vs_kernel_max_abs": lib_err}


def mlp_bwd_check(torch) -> dict:
    """The fused MLP's backward kernel against ``fused_mlp_bwd_plain`` on
    the same inputs at every case in both dtypes — every activation gated
    and ungated, ragged M, odd D and F, llama3.2-1b's train microbatch —
    and in bf16 at ``MLP_BWD_UNALIGNED``, two runs the same bits, each row
    naming the planner's route.  At the headline in bf16, faults planted
    in the kernels' gradients must fail the rule, the kernels must keep
    within the hi + lo bound, and a call is timed beside the plain
    version, the bound, the design's floor and the library yardstick."""
    from repro_torch.kernels import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    shapes = []
    for name, m, d, f, gated, act in MLP_BWD_CASES + (MLP_BWD_UNALIGNED,):
        x32 = torch.randn(m, d, generator=gen)
        w32 = [torch.randn(d, f, generator=gen) * d ** -0.5 if gated
               else None,
               torch.randn(d, f, generator=gen) * d ** -0.5,
               torch.randn(f, d, generator=gen) * f ** -0.5]
        dy32 = torch.randn(m, d, generator=gen)
        unaligned = name == MLP_BWD_UNALIGNED[0]
        for dt_name in ("bfloat16",) if unaligned else ("float32",
                                                         "bfloat16"):
            dtype = getattr(torch, dt_name)
            inputs = tuple(None if t is None else t.to(dtype).cuda()
                           for t in (x32, *w32, dy32))
            if unaligned:    # x one element into a buffer: 2 bytes off
                buf = torch.empty(m * d + 1, dtype=dtype, device="cuda")
                buf[1:].copy_(inputs[0].reshape(-1))
                inputs = (buf[1:].view(m, d),) + inputs[1:]
            what = f"{name} {dt_name}"
            run = lambda: fm.fused_mlp_bwd(*inputs, act=act)
            plain = lambda: fm.fused_mlp_bwd_plain(*inputs, act=act)
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            if not all(a is None or torch.equal(a, b)
                       for a, b in zip(got, again)):
                raise AssertionError(f"{what}: two runs differ in bits")
            row = {"shape": name, "dtype": dt_name, "m": m, "d": d, "f": f,
                   "gated": gated, "act": act,
                   "route": fm.bwd_plan(*inputs).route,
                   **_mlp_bwd_close(got, want, dt_name, what)}
            if unaligned and row["route"] != "mma":
                raise AssertionError(f"{what}: an unaligned x planned "
                                     f"{row['route']}")
            worst[dt_name] = max(worst[dt_name], row["max_abs_err"])
            n += 1
            if (name, dt_name) == MLP_BWD_HEADLINE:
                row["planted_faults"] = _mlp_bwd_faults(inputs, act, got,
                                                        want)
                row["hilo"] = _mlp_bwd_hilo_check(inputs, act, got, want,
                                                  row["need"])
                row.update(_mlp_bwd_times(torch, run, plain, inputs, got,
                                          act))
            shapes.append(row)
            del inputs, got, again, want
        torch.cuda.empty_cache()
    return {"comparisons": n, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 11: the SSD kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: (name, B, L, H, P, N, chunk) — checked in f32 and bf16 (x, b, c; dt and
#: a f32, as the model passes them)
SSD_CASES = (
    ("mamba2-1.3b.prefill", 4, 1024, 64, 64, 128, 64),
    ("mamba2-1.3b.prefill.b1", 1, 1024, 64, 64, 128, 64),
    ("chunk1.prime.l37", 1, 37, 8, 64, 128, 1),
    ("chunk8.l200", 4, 200, 8, 64, 128, 8),
    ("chunk33.l1023", 1, 1023, 8, 64, 128, 33),
    ("chunk64.l1024.b1", 1, 1024, 8, 64, 128, 64),
    ("chunk128.l512", 4, 512, 8, 64, 128, 128),
    ("smoke.p16.n16", 2, 64, 8, 16, 16, 8),
    ("test.p8.n8.h3", 3, 32, 3, 8, 8, 4),
    ("ragged.l1023.b4", 4, 1023, 8, 64, 128, 31),
    ("ragged.l37.p8.n8", 2, 37, 5, 8, 8, 37),
    ("odd.p7.n20.h5", 2, 100, 5, 7, 20, 4),
    ("jamba.prefill", 4, 1024, 256, 64, 128, 64),
    # Jamba's width cut in ``hybrid_train``: d_model 1024, so 32 heads of
    # P 64 over train_4k's 4096 positions
    ("jamba.train.cut", 4, 4096, 32, 64, 128, 64),
)
#: x, b and c as column slices of one (B, L, C) projection, as the model
#: hands them in: (name, B, L, H, P, N, column offset of x).  An odd
#: offset and an odd row length leave x and its strides off 16 bytes
SSD_SLICES = (("slices.aligned", 2, 300, 8, 64, 128, 0),
              ("slices.x.unaligned", 2, 300, 8, 64, 128, 1))
#: the SSD's ms at the headline before its tensor-core redesign (bf16)
#: and as first ported (f32; chip_smoke.py's runs on an NVIDIA H100 80GB
#: HBM3, 700.00 W): constants, so only the detail file's ``before_ms``,
#: never the ``kernels`` line
SSD_BEFORE_MS = {("mamba2-1.3b.prefill", "bfloat16"): 0.9302,
                 ("mamba2-1.3b.prefill", "float32"): 0.8774}
SSD_TIMED = ("mamba2-1.3b.prefill", "mamba2-1.3b.prefill.b1",
             "jamba.prefill")
SSD_HEADLINE = ("mamba2-1.3b.prefill", "bfloat16")
#: f32: the reference's 1e-3 (tests/test_kernels.py:212); bf16: y is
#: rounded to bf16 (2^-8 relative) from the same bf16 inputs, 1e-2
SSD_TOL = {"float32": 1e-3, "bfloat16": 1e-2}


def _ssd_inputs(torch, gen, b, l, h, p, n):
    """The reference test's distributions: dt = softplus(N(0, 1)), a =
    -exp(0.3 N(0, 1)), b and c 0.5 N(0, 1)."""
    x = torch.randn(b, l, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=gen))
    a = -torch.exp(torch.randn(h, generator=gen) * 0.3)
    bm = torch.randn(b, l, n, generator=gen) * 0.5
    cm = torch.randn(b, l, n, generator=gen) * 0.5
    return x, dt, a, bm, cm


def _close(out, exp, tol, what):
    import torch

    if out.shape != exp.shape or out.dtype != exp.dtype:
        raise AssertionError(f"{what}: {tuple(out.shape)} {out.dtype} vs "
                             f"{tuple(exp.shape)} {exp.dtype}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (out.float() - exp.float()).abs()
    if not bool((diff <= tol + tol * exp.float().abs()).all()):
        raise AssertionError(f"{what}: max |err| {float(diff.max())} beyond "
                             f"atol = rtol = {tol}")
    return float(diff.max())


def ssd_check(torch) -> dict:
    from repro_torch.core import dse
    from repro_torch.kernels import mamba2_ssd as ms

    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cmp = 0
    shapes = []
    for name, b, l, h, p, n, chunk in SSD_CASES:
        x32, dt, a, bm32, cm32 = _ssd_inputs(torch, gen, b, l, h, p, n)
        dt, a = dt.cuda(), a.cuda()
        s0 = torch.zeros(b, h, p, n).cuda()
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            x, bm, cm = (v.to(dtype).cuda() for v in (x32, bm32, cm32))
            run = lambda: ms.mamba2_ssd(x, dt, a, bm, cm, s0, chunk=chunk)
            plain = lambda: ms.mamba2_ssd_plain(x, dt, a, bm, cm, s0,
                                                chunk=chunk)
            (y, sf), (ye, se) = run(), plain()
            torch.cuda.synchronize()
            tol = SSD_TOL[dt_name]
            err = max(_close(y, ye, tol, f"{name} {dt_name} y"),
                      _close(sf, se, SSD_TOL["float32"],
                             f"{name} {dt_name} state"))
            n_cmp += 1
            if l % (2 * chunk) == 0 and l >= 2 * chunk:
                # the state carries across two calls as through one
                half = l // 2
                y1, s1 = ms.mamba2_ssd(x[:, :half], dt[:, :half], a,
                                       bm[:, :half], cm[:, :half], s0,
                                       chunk=chunk)
                y2, s2 = ms.mamba2_ssd(x[:, half:], dt[:, half:], a,
                                       bm[:, half:], cm[:, half:], s1,
                                       chunk=chunk)
                torch.cuda.synchronize()
                err = max(err, _close(torch.cat([y1, y2], 1), ye, tol,
                                      f"{name} {dt_name} carried y"),
                          _close(s2, se, SSD_TOL["float32"],
                                 f"{name} {dt_name} carried state"))
                n_cmp += 1
            worst[dt_name] = max(worst[dt_name], err)
            if name not in SSD_TIMED:
                continue
            ms_ = time_ms(run, warmup=2, reps=20)
            plain_ms = time_ms(plain, warmup=1, reps=5)
            dev_ms = device_ms(run, reps=10, kernel=("mamba2_ssd",))
            work = ssd_work(b, l, h, p, n, dtype)
            plan = dse.plan_ssd_blocks(batch=b, length=l, heads=h,
                                       head_dim=p, state_dim=n,
                                       dtype=dt_name)
            row = {
                "shape": name, "dtype": dt_name, "b": b, "l": l, "h": h,
                "p": p, "n": n, "chunk": chunk, "ms": ms_,
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": work.bound_ms(), "bound_by": work.bound_by(),
                "bytes": work.bytes, "flops": work.flops, "library_ms": None,
                "max_abs_err": err, "plan": plan.blocks,
                "before_ms": SSD_BEFORE_MS.get((name, dt_name)),
            }
            if dtype == torch.bfloat16:
                row["tiles"] = ssd_tile_times(torch, dse, ms, x, dt, a, bm,
                                              cm, s0, y, sf)
            shapes.append(row)
    n_cmp += ssd_slices_and_state(torch, gen, ms, worst)
    return {"comparisons": n_cmp, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "shapes": shapes}


def ssd_tile_times(torch, dse, ms, x, dt, a, bm, cm, s0, y, sf) -> list:
    """The bf16 headline under both tiles the planner picks from
    (``dse.SSD_MMA_NARROW`` and ``SSD_MMA_WIDE``), as hand-made plans:
    ms by CUDA events on the same inputs, each result within f32 rounding
    of the planner's."""
    b, l, h, p = x.shape
    rows = []
    for q, hb in dse.SSD_MMA_TILES:
        plan = dse.SsdBlockPlan(
            "mamba2_ssd", {"route": "mma", "block_l": q,
                           "heads_per_block": hb},
            dse.ssd_mma_smem_bytes(block_l=q, heads_per_block=hb),
            b * -(-h // hb))
        run = lambda: ms.launch_plan(x, dt, a, bm, cm, s0, plan)
        yt, st = run()
        torch.cuda.synchronize()
        _close(yt, y, SSD_TOL["bfloat16"], f"tile {q}x{hb} y")
        _close(st, sf, SSD_TOL["float32"], f"tile {q}x{hb} state")
        rows.append({"block_l": q, "heads_per_block": hb,
                     "smem_bytes": plan.smem_bytes,
                     "ms": time_ms(run, warmup=2, reps=20)})
    return rows


def ssd_slices_and_state(torch, gen, ms, worst) -> int:
    """x, b and c as strided column slices of one projection (x off 16
    bytes too), and a random initial state carried across two calls split
    at a ragged point, in both dtypes, against the plain version."""
    n_cmp = 0
    for name, b, l, h, p, n, off in SSD_SLICES:
        x32, dt, a, bm32, cm32 = _ssd_inputs(torch, gen, b, l, h, p, n)
        s0 = (torch.randn(b, h, p, n, generator=gen) * 0.5).cuda()
        dt, a = dt.cuda(), a.cuda()
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            width = off + h * p + 2 * n + off
            proj = torch.zeros(b, l, width, dtype=dtype, device="cuda")
            xs = proj[..., off:off + h * p]
            xs.copy_(x32.reshape(b, l, h * p).to(dtype))
            bs = proj[..., off + h * p:off + h * p + n]
            cs_ = proj[..., off + h * p + n:off + h * p + 2 * n]
            bs.copy_(bm32.to(dtype))
            cs_.copy_(cm32.to(dtype))
            xs = xs.reshape(b, l, h, p)
            tol = SSD_TOL[dt_name]
            ye, se = ms.mamba2_ssd_plain(xs.contiguous(), dt, a,
                                         bs.contiguous(), cs_.contiguous(),
                                         s0, chunk=l)
            y, sf = ms.mamba2_ssd(xs, dt, a, bs, cs_, s0, chunk=l)
            cut = 117          # two calls, split off any tile boundary
            y1, s1 = ms.mamba2_ssd(xs[:, :cut], dt[:, :cut], a, bs[:, :cut],
                                   cs_[:, :cut], s0, chunk=cut)
            y2, s2 = ms.mamba2_ssd(xs[:, cut:], dt[:, cut:], a, bs[:, cut:],
                                   cs_[:, cut:], s1, chunk=l - cut)
            torch.cuda.synchronize()
            worst[dt_name] = max(
                worst[dt_name],
                _close(y, ye, tol, f"{name} {dt_name} y"),
                _close(sf, se, SSD_TOL["float32"], f"{name} {dt_name} state"),
                _close(torch.cat([y1, y2], 1), ye, tol,
                       f"{name} {dt_name} carried y"),
                _close(s2, se, SSD_TOL["float32"],
                       f"{name} {dt_name} carried state"))
            n_cmp += 2
    return n_cmp


# ---------------------------------------------------------------------------
# phase 11b: the SSD backward kernel vs its plain version on the card
# ---------------------------------------------------------------------------

#: (name, B, L, H, P, N, chunk): ``ssd_check``'s cases (ragged L and
#: Jamba's train cut among them), one whose P and N are odd (every load
#: and store of the backward then takes its element path: no 16-, 8- or
#: 4-byte pieces) and mamba2-1.3b's train microbatch (train_4k's 4096
#: positions, 4 rows).  Every case but the mamba2 train shape runs from a
#: random initial state with a random cotangent of the final state; that
#: one as the model calls it (zeros, no cotangent)
SSD_BWD_CASES = SSD_CASES + (("odd.p5.n13.h3", 2, 70, 3, 5, 13, 7),
                             ("mamba2-1.3b.train", 4, 4096, 64, 64, 128,
                              64))
SSD_BWD_HEADLINE = ("mamba2-1.3b.train", "bfloat16")
SSD_BWD_GRADS = ("dx", "ddt", "da", "db", "dc", "d_init_state")
#: (rtol of |plain|, atol as a share of the row's scale): an element
#: holds iff |err| ≤ rtol·|plain| + atol·max(rowmax, 1e-3·max), rowmax
#: the largest |plain| of its row — a (batch row, head) for dx, ddt and
#: d_init_state, a batch row for db and dc (sums over the 64 heads), the
#: tensor for da (a sum over B·L positions).  Set before the first run
#: from the backward's sums emulated on the CPU (``ssd_bwd_walk``, f32
#: from the same inputs, at the train shape's L 4096, P 64, N 128):
#: ``tests/test_torch_ssd_bwd.py`` holds it to a tenth of the rule in
#: both dtypes and each planted fault to ≥ 30 times the bf16 atol.  The
#: bf16 rtol covers the one rounding of dx, db and dc to bf16 in either
#: version (one step is 2^-8 of the value)
SSD_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}
SSD_BWD_ROW_FLOOR = 1e-3
#: the share of the bf16 atol the kernels' worst gradient may need at the
#: headline.  Their rounding — each f32 operand of a tensor-core product
#: as bf16 hi + lo — emulates at about 5e-4 of it on the CPU, and any one
#: of those operands rounded to bf16 alone at 0.3 or more
#: (``ssd_bwd_split``, ``tests/test_torch_ssd_bwd.py``): a kernel that
#: dropped a lo part would meet the rule, but not this
SSD_BWD_HILO_SHARE = 0.05
#: the axes a row of each gradient spans (``None``: the whole tensor)
SSD_BWD_ROW_AXES = {"dx": (1, 3), "ddt": (1,), "da": None, "db": (1, 2),
                    "dc": (1, 2), "d_init_state": (2, 3)}
#: the backward's two kernels (one launch each a call), both dtypes
SSD_BWD_KERNELS = ("mamba2_ssd_bwd_pass", "mamba2_ssd_bwd_tile")
#: the plain version's chunk where its gradient at the case's chunk is NaN
#: (``exp`` of a masked difference above 88 overflows: ROADMAP §C)
SSD_BWD_FINITE_CHUNK = 16


def _ssd_need(got, want, name: str, dtype_name: str) -> float:
    """The SSD backward's rule (``_need``) for gradient ``name``: its
    rtol, rows over ``SSD_BWD_ROW_AXES``; it holds iff this is ≤ the
    rule's atol."""
    return _need(got, want, SSD_BWD_TOL[dtype_name][0],
                 SSD_BWD_ROW_AXES[name], SSD_BWD_ROW_FLOOR)


def _ssd_grads_close(got, want, dtype_name: str, what: str) -> dict:
    """Each of the six gradients within ``SSD_BWD_TOL``: finite, of the
    plain version's shape and dtype, and by the row rule → {name: need}
    and the largest |err|; raises beyond the rule."""
    import torch

    atol = SSD_BWD_TOL[dtype_name][1]
    needs, worst = {}, 0.0
    for name, g, w in zip(SSD_BWD_GRADS, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} {name}: {tuple(g.shape)} {g.dtype}"
                                 f" vs {tuple(w.shape)} {w.dtype}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {name}: non-finite gradient")
        needs[name] = _ssd_need(g, w, name, dtype_name)
        if not needs[name] <= atol:
            raise AssertionError(f"{what} {name}: needs {needs[name]} of the "
                                 f"row's scale beyond rtol; the rule allows "
                                 f"{atol}")
        worst = max(worst, float((g.float() - w.float()).abs().max()))
    return {"need": needs, "max_abs_err": worst}


def ssd_bwd_walk(x, dt, a, bm, cm, s0, dy, dsf=None, *, tile=32):
    """The backward's sums (``csrc/mamba2_ssd_bwd.cu``'s header states
    them) as one serial walk, in plain PyTorch, f32, vectorised over
    (batch row, head): the forward walk for the state entering each tile of
    ``tile`` positions, then the tiles last to first, each using the dS
    carried out of the tile after it, ``exp`` only where s ≤ t → (dx, ddt,
    da, db, dc, d_init_state) in f32.  The kernels compute the same sums
    in another order, :func:`ssd_bwd_split`'s."""
    import torch

    _, l, _, _ = x.shape
    xf, dyf, bf, cf = x.float(), dy.float(), bm.float(), cm.float()
    dtf, af = dt.float(), a.float()
    nt = -(-l // tile)
    states, st = [], s0.float()
    for k in range(nt):
        sl = slice(k * tile, min((k + 1) * tile, l))
        states.append(st)
        cum = torch.cumsum(dtf[:, sl] * af, 1)
        w = dtf[:, sl] * torch.exp(cum[:, -1:] - cum)
        st = st * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bqhp,bqn->bhpn", xf[:, sl] * w[..., None], bf[:, sl])
    ds = torch.zeros_like(st) if dsf is None else dsf.float()
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    for k in reversed(range(nt)):
        sl = slice(k * tile, min((k + 1) * tile, l))
        xq, gq, bq, cq, d = xf[:, sl], dyf[:, sl], bf[:, sl], cf[:, sl], \
            dtf[:, sl]
        q = d.shape[1]
        cum = torch.cumsum(d * af, 1)
        dec = torch.exp(cum[:, -1])
        tri = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                    device=x.device))[None, :, :, None]
        rel = cum[:, :, None, :] - cum[:, None, :, :]         # (B, t, s, H)
        e_ts = torch.where(tri, torch.exp(torch.where(tri, rel, 0.0)), 0.0)
        cb = torch.einsum("btn,bsn->bts", cq, bq)[..., None]
        m = torch.einsum("bthp,bshp->btsh", gq, xq)
        kk = cb * m * e_ts
        g_ts = cb * e_ts * d[:, None]
        gd_ts = m * e_ts * d[:, None]
        g = torch.exp(cum[:, -1:] - cum)
        w = d * g
        e = torch.exp(cum)
        sp = states[k]
        z = torch.einsum("bhpn,bsn->bshp", ds, bq)
        v = (xq * z).sum(-1)
        u = torch.einsum("bthp,bhpn->bthn", gq, sp)
        i_t = (cq[:, :, None, :] * u).sum(-1)
        dx[:, sl] = (torch.einsum("btsh,bthp->bshp", g_ts, gq)
                     + w[..., None] * z)
        dc[:, sl] = (torch.einsum("btsh,bsn->btn", gd_ts, bq)
                     + torch.einsum("bth,bthn->btn", e, u))
        db[:, sl] = (torch.einsum("btsh,btn->bsn", gd_ts, cq)
                     + torch.einsum("bsh,bshp,bhpn->bsn", w, xq, ds))
        carried = torch.einsum("bth,bthp,btn->bhpn", e, gq, cq)
        dcum = (kk * d[:, None]).sum(2) - d * kk.sum(1) + e * i_t - w * v
        dcum[:, -1] += dec * (ds * sp).sum((-1, -2)) + (w * v).sum(1)
        rc = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddt[:, sl] = kk.sum(1) + g * v + af * rc
        da += (d * rc).sum((0, 1))
        ds = carried + dec[..., None, None] * ds
    return dx, ddt, da, db, dc, ds


#: the f32 operands the bf16 kernels feed to the tensor cores as a bf16
#: high part plus a bf16 low part: the gated c·bᵀ (G, dx's intra term),
#: the gated dy·xᵀ summed over a block's heads (Gd, dc's and db's), the
#: saved state (S, u = dy·S), the pass's dS (dS, Z = b·dSᵀ and Y = x·dS)
#: and the pass's exp(cum)·dy (edy, the carried update)
SSD_BWD_HILO = ("G", "Gd", "S", "dS", "edy")


def _bf16_round(t, *, lo: bool):
    """``t`` rounded as an operand of a bf16 product: to bf16, and with
    ``lo`` plus its remainder rounded to bf16 again (hi + lo, about 16
    significant bits), back in f32."""
    import torch

    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float() if lo else hi


def ssd_bwd_split(x, dt, a, bm, cm, s0, dy, dsf=None, *, tile=32,
                  hilo=False, bf16_alone=None, fault=None, cut=None):
    """The two-kernel backward's formula in plain PyTorch (f32,
    ``csrc/mamba2_ssd_bwd.cu``'s header states the sums) → (dx, ddt, da,
    db, dc, d_init_state) in f32.  First the dS pass: dS_k, the cotangent
    of the state leaving tile k, for every tile, last to first (dS_{k−1} =
    exp(cum_last) dS_k + Σ_t exp(cum_t) dy_t ⊗ c_t); then every tile at
    once, each from its own saved state S_k and dS_k — nothing carries
    between them.  With ``hilo`` each operand of ``SSD_BWD_HILO`` is
    rounded where the bf16 kernels round it (hi + lo; Gd summed over a
    tile block's ``dse.SSD_BWD_HEADS_PER_BLOCK`` heads first), and
    ``bf16_alone`` names one of them
    to round to bf16 alone instead.  ``fault`` plants one of the faults
    the card's rule must catch: ``"carry_break"`` (the pass carries no dS
    into tile ``cut`` − 1), ``"no_decay"`` (it carries dS without
    exp(cum_last)), ``"db_no_state"`` (db without the state-update term),
    ``"ddt_no_cum"`` (ddt without the path through cum) or
    ``"pass_shift"`` (tile k reads dS_{k−1}, tile 0 the pass's final
    carry)."""
    import torch

    from repro_torch.core import dse

    bsz, l, h, p = x.shape
    q = tile
    nt = -(-l // q)
    pad = nt * q - l

    def rnd(name, t):
        if name == bf16_alone:
            return _bf16_round(t, lo=False)
        return _bf16_round(t, lo=True) if hilo else t

    def tiles(t):      # (B, L, ...) → (B, nt, q, ...), zeros past L
        t = t.float()
        t = torch.cat([t, t.new_zeros((bsz, pad, *t.shape[2:]))], 1)
        return t.reshape(bsz, nt, q, *t.shape[2:])

    xq, dyq, bq, cq, d = (tiles(v) for v in (x, dy, bm, cm, dt))
    af = a.float()
    cum = torch.cumsum(d * af, 2)                        # (B, nt, q, H)
    last = cum[:, :, -1]                                 # (B, nt, H)
    dec = torch.exp(last)
    e = torch.exp(cum)
    g = torch.exp(last[:, :, None] - cum)
    w = d * g
    # the forward's saved states, S_k entering tile k
    states, st = [], s0.float()
    for k in range(nt):
        states.append(st)
        st = dec[:, k, :, None, None] * st + torch.einsum(
            "bqhp,bqn->bhpn", xq[:, k] * w[:, k, ..., None], bq[:, k])
    sk = torch.stack(states, 1)                          # (B, nt, H, P, N)
    # the dS pass
    ds = torch.zeros_like(st) if dsf is None else dsf.float()
    buf = [None] * nt
    for k in reversed(range(nt)):
        buf[k] = ds
        edy = rnd("edy", e[:, k, ..., None] * dyq[:, k])
        ds = (ds if fault == "no_decay" else dec[:, k, :, None, None] * ds
              ) + torch.einsum("bthp,btn->bhpn", edy, cq[:, k])
        if fault == "carry_break" and k == cut:
            ds = torch.zeros_like(ds)
    d_init = ds
    if fault == "pass_shift":
        buf = [d_init] + buf[:-1]
    dsk = torch.stack(buf, 1)                            # (B, nt, H, P, N)
    # every tile at once
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    tri = tri[None, None, :, :, None]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nt, t, s, H)
    e_ts = torch.where(tri, torch.exp(torch.where(tri, rel, 0.0)), 0.0)
    cb = torch.einsum("bktn,bksn->bkts", cq, bq)[..., None]
    m = torch.einsum("bkthp,bkshp->bktsh", dyq, xq)
    kk = cb * m * e_ts
    g_ts = cb * e_ts * d[:, :, None]
    gd_ts = m * e_ts * d[:, :, None]
    s_op, ds_op = rnd("S", sk), rnd("dS", dsk)
    z = torch.einsum("bkhpn,bksn->bkshp", ds_op, bq)
    v = (xq * z).sum(-1)                                 # (B, nt, s, H)
    u = torch.einsum("bkthp,bkhpn->bkthn", dyq, s_op)
    i_t = (cq[:, :, :, None, :] * u).sum(-1)
    y = torch.einsum("bkshp,bkhpn->bkshn", xq, ds_op)
    dx = (torch.einsum("bktsh,bkthp->bkshp", rnd("G", g_ts), dyq)
          + w[..., None] * z)
    hb = dse.SSD_BWD_HEADS_PER_BLOCK if hilo or bf16_alone else h
    groups = -(-h // hb)
    gd = torch.cat([gd_ts, gd_ts.new_zeros((*gd_ts.shape[:4],
                                            groups * hb - h))], -1)
    gd = rnd("Gd", gd.reshape(*gd.shape[:4], groups, hb).sum(-1))
    dc = (torch.einsum("bktsg,bksn->bktn", gd, bq)
          + torch.einsum("bkth,bkthn->bktn", e, u))
    db = torch.einsum("bktsg,bktn->bksn", gd, cq)
    if fault != "db_no_state":
        db = db + torch.einsum("bksh,bkshn->bksn", w, y)
    dcum = (kk * d[:, :, None]).sum(3) - d * kk.sum(2) + e * i_t - w * v
    dcum[:, :, -1] += dec * (dsk * sk).sum((-1, -2)) + (w * v).sum(2)
    rc = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = kk.sum(2) + g * v
    if fault != "ddt_no_cum":
        ddt = ddt + af * rc
    da = (d * rc).sum((0, 1, 2))

    def untile(t):
        return t.reshape(bsz, nt * q, *t.shape[3:])[:, :l]

    return untile(dx), untile(ddt), da, untile(db), untile(dc), d_init


SSD_BWD_FAULTS = ("carry_break", "no_decay", "db_no_state", "ddt_no_cum",
                  "da_zero", "pass_shift")


def _ssd_planted_faults(inputs, got, want, dtype_name: str) -> dict:
    """The rule against faults planted in the kernel's own gradients
    ``got`` at one shape: each fault's effect, the difference between
    :func:`ssd_bwd_split` with and without it on the same ``inputs`` (x,
    dt, a, b, c, init state, dy, state cotangent), is added to ``got``
    (``da`` zero is set), and the result must fail the rule.
    "carry_break" cuts the carry at the middle tile boundary.  Beside
    each: per gradient the share of the row's scale it needs, and whether
    the rule caught it."""
    x = inputs[0]
    cut = -(-x.shape[1] // 32) // 2
    clean = ssd_bwd_split(*inputs)
    atol = SSD_BWD_TOL[dtype_name][1]
    report = {}
    for fault in SSD_BWD_FAULTS:
        if fault == "da_zero":
            bad = list(got)
            bad[2] = got[2] * 0
        else:
            planted = ssd_bwd_split(*inputs, fault=fault, cut=cut)
            bad = [(g.float() + (p_ - c)).to(g.dtype)
                   for g, p_, c in zip(got, planted, clean)]
        needs = {name: _ssd_need(b_, w, name, dtype_name)
                 for name, b_, w in zip(SSD_BWD_GRADS, bad, want)}
        worst = max(needs.values())
        report[fault] = {"need": needs, "caught": worst > atol}
        if not worst > atol:
            raise AssertionError(f"the SSD backward rule lets a planted "
                                 f"fault pass: {fault} needs only {worst}")
    return report


def _ssd_hilo_check(inputs, got, want, needs: dict) -> dict:
    """The bf16 kernels' hi + lo, at one shape: their gradients ``got``
    (whose needs of the rule against ``want`` are ``needs``) need at most
    ``SSD_BWD_HILO_SHARE`` of the bf16 atol, and each operand of
    ``SSD_BWD_HILO`` rounded to bf16 alone — its effect,
    :func:`ssd_bwd_split` with ``bf16_alone`` less with hi + lo for all,
    added to ``got`` — needs more → {"share", "bound", "lo_dropped": {op:
    share}}; raises where either fails."""
    atol = SSD_BWD_TOL["bfloat16"][1]
    share = max(needs.values()) / atol
    if not share <= SSD_BWD_HILO_SHARE:
        raise AssertionError(f"the bf16 SSD backward needs {share} of the "
                             f"rule, beyond the {SSD_BWD_HILO_SHARE} its "
                             f"hi + lo operands allow")
    clean = ssd_bwd_split(*inputs, hilo=True)
    dropped = {}
    for op in SSD_BWD_HILO:
        alone = ssd_bwd_split(*inputs, hilo=True, bf16_alone=op)
        dropped[op] = max(
            _ssd_need((g.float() + (a_ - c)).to(g.dtype), w, name,
                      "bfloat16")
            for name, g, a_, c, w in zip(SSD_BWD_GRADS, got, alone, clean,
                                         want)) / atol
        if not dropped[op] > SSD_BWD_HILO_SHARE:
            raise AssertionError(f"the SSD backward's hi + lo bound lets "
                                 f"{op} in bf16 alone pass: it needs only "
                                 f"{dropped[op]} of the rule")
    return {"share": share, "bound": SSD_BWD_HILO_SHARE,
            "lo_dropped": dropped}


def _ssd_bwd_inputs(torch, gen, dtype, b, l, h, p, n, *, model: bool):
    """``_ssd_inputs`` in ``dtype`` on the card, an initial state and the
    cotangents: dy in ``dtype``; the state 0.5 N(0, 1) and its cotangent
    N(0, 1), or (``model``) zeros and none, as the model calls it."""
    x, dt, a, bm, cm = _ssd_inputs(torch, gen, b, l, h, p, n)
    dy = torch.randn(b, l, h, p, generator=gen)
    if model:
        s0, dsf = torch.zeros(b, h, p, n), None
    else:
        s0 = torch.randn(b, h, p, n, generator=gen) * 0.5
        dsf = torch.randn(b, h, p, n, generator=gen).cuda()
    return (x.to(dtype).cuda(), dt.cuda(), a.cuda(), bm.to(dtype).cuda(),
            cm.to(dtype).cuda(), s0.cuda(), dy.to(dtype).cuda(), dsf)


def _ssd_bwd_one(torch, ms, inputs, chunk, dtype_name, what) -> tuple:
    """The forward (saving its tile states) against the plain forward, the
    backward twice (the same bits) against the plain backward (at
    ``SSD_BWD_FINITE_CHUNK`` where the case's chunk gives NaN) → (row,
    run, plain, got, want)."""
    x, dt, a, bm, cm, s0, dy, dsf = inputs
    y, sf, states = ms.mamba2_ssd(x, dt, a, bm, cm, s0, chunk=chunk,
                                  return_states=True)
    ye, se = ms.mamba2_ssd_plain(x, dt, a, bm, cm, s0, chunk=chunk)
    fwd_err = max(_close(y, ye, SSD_TOL[dtype_name], f"{what} y"),
                  _close(sf, se, SSD_TOL["float32"], f"{what} state"))
    del ye, se
    run = lambda: ms.mamba2_ssd_bwd(x, dt, a, bm, cm, s0, dy, dsf,
                                    chunk=chunk, states=states)
    got, again = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(g, h_) for g, h_ in zip(got, again)):
        raise AssertionError(f"{what}: two runs differ in bits")
    plain_chunk = chunk
    want = ms.mamba2_ssd_bwd_plain(x, dt, a, bm, cm, s0, dy, dsf,
                                   chunk=chunk)
    if not all(bool(torch.isfinite(w).all()) for w in want):
        plain_chunk = max(c for c in range(1, SSD_BWD_FINITE_CHUNK + 1)
                          if x.shape[1] % c == 0)
        want = ms.mamba2_ssd_bwd_plain(x, dt, a, bm, cm, s0, dy, dsf,
                                       chunk=plain_chunk)
    held = _ssd_grads_close(got, want, dtype_name, what)
    row = {"forward_max_abs_err": fwd_err, "plain_chunk": plain_chunk,
           "plain_nan_at_chunk": chunk if plain_chunk != chunk else None,
           **held}
    plain = lambda: ms.mamba2_ssd_bwd_plain(x, dt, a, bm, cm, s0, dy, dsf,
                                            chunk=plain_chunk)
    return row, run, plain, got, want


def ssd_bwd_check(torch) -> dict:
    """The SSD backward kernel against ``mamba2_ssd_bwd_plain`` on the same
    inputs — the tile states from the forward kernel, which is held to the
    plain forward too — at every case in both dtypes, x, b and c also as
    strided column slices; two runs the same bits.  At the train shape in
    bf16, faults planted in the kernels' gradients must fail the rule, the
    kernels must keep within the hi + lo bound (``_ssd_hilo_check``), and
    they are timed beside the plain version and the bound (no PyTorch
    call computes an SSD backward)."""
    from repro_torch.kernels import mamba2_ssd as ms

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cmp = 0
    shapes = []
    for name, b, l, h, p, n, chunk in SSD_BWD_CASES:
        model = name == SSD_BWD_HEADLINE[0]
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            what = f"{name} {dt_name}"
            inputs = _ssd_bwd_inputs(torch, gen, dtype, b, l, h, p, n,
                                     model=model)
            row, run, plain, got, want = _ssd_bwd_one(torch, ms, inputs,
                                                      chunk, dt_name, what)
            row.update(shape=name, dtype=dt_name, b=b, l=l, h=h, p=p, n=n,
                       chunk=chunk)
            worst[dt_name] = max(worst[dt_name], row["max_abs_err"])
            n_cmp += 1
            if (name, dt_name) == SSD_BWD_HEADLINE:
                row["planted_faults"] = _ssd_planted_faults(inputs, got,
                                                            want, dt_name)
                row["hilo"] = _ssd_hilo_check(inputs, got, want,
                                              row["need"])
                row.update(_ssd_bwd_times(torch, run, plain, inputs, got,
                                          b, l, h, p, n))
            shapes.append(row)
            del inputs, got, want, run, plain
    n_cmp += _ssd_bwd_slices(torch, gen, ms, worst, shapes)
    torch.cuda.empty_cache()
    return {"comparisons": n_cmp, "max_abs_err_f32": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"], "shapes": shapes}


def _ssd_bwd_slices(torch, gen, ms, worst, shapes) -> int:
    """x, b and c as strided column slices of one projection (x off 16
    bytes too), as ``models/mamba2.py`` hands them in, both dtypes."""
    n_cmp = 0
    for name, b, l, h, p, n, off in SSD_SLICES:
        for dt_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dt_name)
            x, dt, a, bm, cm, s0, dy, dsf = _ssd_bwd_inputs(
                torch, gen, dtype, b, l, h, p, n, model=False)
            width = off + h * p + 2 * n + off
            proj = torch.zeros(b, l, width, dtype=dtype, device="cuda")
            xs = proj[..., off:off + h * p]
            xs.copy_(x.reshape(b, l, h * p))
            bs = proj[..., off + h * p:off + h * p + n]
            cs_ = proj[..., off + h * p + n:off + h * p + 2 * n]
            bs.copy_(bm)
            cs_.copy_(cm)
            inputs = (xs.reshape(b, l, h, p), dt, a, bs, cs_, s0, dy, dsf)
            row, *_ = _ssd_bwd_one(torch, ms, inputs, l, dt_name,
                                   f"{name} {dt_name}")
            row.update(shape=name, dtype=dt_name, b=b, l=l, h=h, p=p, n=n)
            worst[dt_name] = max(worst[dt_name], row["max_abs_err"])
            shapes.append(row)
            n_cmp += 1
    return n_cmp


def _ssd_bwd_times(torch, run, plain, inputs, got, b, l, h, p, n) -> dict:
    """ms of a call (CUDA events, warm L2; device ms from the profiler, the
    two kernels summed, and each kernel's own) and of the plain version at
    one shape; the bound: the bytes the backward must move (x, dt, a, b,
    c, the initial state, dy and the state's cotangent read once; the six
    gradients written once) at 3.35 TB/s, or ``ssd_bwd_flops`` at the
    bf16 tensor-core rate; and beside it the design's floor, the bytes its
    two kernels move (``ssd_bwd_design_bytes``: the saved states, dS_k
    and the partials are its own cost) at 3.35 TB/s."""
    from repro_torch.core import dse

    ms_ = time_ms(run, warmup=1, reps=5)
    each = device_ms_each(run, reps=3, kernels=SSD_BWD_KERNELS)
    plain_ms = time_ms(plain, warmup=1, reps=2)
    bound = ssd_bwd_work(b, l, h, p, n, inputs[0].dtype,
                         state_grad=inputs[7] is not None)
    design = ssd_bwd_design_bytes(
        b, l, h, p, n, inputs[0].element_size(), tile=dse.SSD_BWD_BLOCK_L,
        heads_per_block=dse.SSD_BWD_HEADS_PER_BLOCK,
        state_grad=inputs[7] is not None)
    return {"ms": ms_, "device_ms": each["per_call"],
            "device_ms_each": {k: each[k] for k in SSD_BWD_KERNELS},
            "plain_ms": plain_ms, "bound_ms": bound.bound_ms(),
            "bound_by": bound.bound_by(),
            "bytes": bound.bytes, "flops": bound.flops,
            "design_bytes": design,
            "design_floor_ms": design / HBM_BYTES_PER_S * 1e3,
            "library_ms": None}


# ---------------------------------------------------------------------------
# phase 12: the LM server at full width
# ---------------------------------------------------------------------------

#: the dense models served at full width and depth; ``INT8_ARCHS``,
#: ``MESH_SERVE_ARCH`` and ``DRYRUN_TIES`` read the first
LM_MODELS = ("llama3.2-1b", "qwen2-0.5b", "yi-9b", "nemotron-4-15b")
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32
#: prefill logits, "cuda" vs "blockwise" attention, bf16 through every
#: layer: the two sum in another order, so a few bf16 outputs of
#: attention differ in the last bit and the difference grows layer by
#: layer — allowed: 2 % of the largest |logit| plus 0.02
LM_LOGIT_RTOL_OF_MAX, LM_LOGIT_ATOL = 0.02, 0.02
#: the models whose "cuda" and "blockwise" engines also run in f32, on
#: weights drawn in f32 from the same seed, held to the same rule: the
#: gap bf16 rounding leaves out
LM_F32_ARCHS = ("yi-9b", "nemotron-4-15b")


#: the dense models that also serve with ``mlp_impl="streamed"`` (the
#: fused-MLP kernel; nemotron-4-15b through its ungated squared-ReLU
#: route): one prefill and STREAMED_STEPS decode steps, logits held
#: against the ``"dense"`` engine by the rule above; the streamed
#: prefill's split over STREAMED_REPS prefills (nemotron's takes ≈ 2.3 s)
STREAMED_ARCHS, STREAMED_STEPS = ("llama3.2-1b", "nemotron-4-15b"), 8
STREAMED_REPS = 3
#: ``python -m repro_torch.launch.serve`` run once, as a user runs it:
#: its defaults (the card, 4 prompts of 64, 32 new tokens), in a process
#: of its own once ``lm_serve``'s engines are freed
SERVE_CLI_ARGS, SERVE_CLI_LIMIT_S = ("--arch", "nemotron-4-15b"), 300


#: substrings of cuBLAS' kernel names (``nvjet_*`` on Hopper with CUDA 12.8)
MATMUL_KERNELS = ("nvjet", "gemm", "xmma", "cutlass", "gemv")


def _prefill_breakdown(torch, prefill, *, reps: int = 5,
                       classes=(("attention", "flash_attention"),)
                       ) -> dict:
    """Where a warm prefill's time goes (``prefill``: a call that runs
    one): the card's time in each class of
    hand-written kernel (``classes``: (name, kernel-name piece) pairs), in
    matmuls and in everything else, and the wall time of the
    same ``reps`` prefills, all under the profiler; the gap between busy
    and wall time is the card's idle share (negative where the busy time
    exceeds the wall, which is then flagged, not hidden).  The wall of
    ``reps`` unprofiled prefills stands beside it, to show what the
    profiler adds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / reps
    walls = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    parts = {name: 0.0 for name, _ in classes}
    parts.update(matmul=0.0, other=0.0)
    kernels = []
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0.0)
              or getattr(ev, "self_cuda_time_total", 0.0))
        if not us:
            continue
        kernels.append((us / reps, ev.key))
        key = ev.key.lower()
        cls = next((name for name, piece in classes if piece in key), None)
        if cls is not None:
            parts[cls] += us
        elif any(t in key for t in MATMUL_KERNELS):
            parts["matmul"] += us
        else:
            parts["other"] += us
    out = {f"{k}_ms": v / 1e3 / reps for k, v in parts.items()}
    busy = sum(parts.values()) / 1e3 / reps
    wall_ms = sum(walls) / reps
    out.update({
        "reps": reps, "device_busy_ms": busy, "wall_ms": wall_ms,
        "wall_ms_each": walls, "unprofiled_wall_ms": unprofiled_ms,
        "idle_share": 1.0 - busy / wall_ms if busy else None,
        "busy_exceeds_wall": busy > wall_ms,
        "top_kernels": [[name[:80], us / 1e3]
                        for us, name in sorted(kernels, reverse=True)[:6]],
    })
    return out


def lm_serve(torch) -> dict:
    import numpy as np

    from repro_torch.configs.base import count_params
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import ServeEngine

    rows = []
    for arch in LM_MODELS:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                               dtype=np.int32)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, max_len=LM_PROMPT + LM_NEW, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params_gb = _tree_nbytes(eng.params) / 1e9

        before = fa.launches
        out, cold = eng.generate(prompts, max_new=LM_NEW)
        per_prefill = fa.launches - before
        if per_prefill != cfg.num_layers:
            raise AssertionError(
                f"{arch}: {per_prefill} flash launches in one prefill, want "
                f"{cfg.num_layers} (one per layer)")
        if out.shape != (LM_BATCH, LM_NEW) or out.min() < 0 or \
                out.max() >= cfg.vocab_size:
            raise AssertionError(f"{arch}: tokens {out.shape} out of range")
        out2, warm = eng.generate(prompts, max_new=LM_NEW)
        if not np.array_equal(out, out2):
            raise AssertionError(f"{arch}: greedy generate not repeatable")

        logits, _ = eng.prefill(prompts)
        blockwise = ServeEngine(cfg.with_(attn_impl="blockwise"),
                                max_len=LM_PROMPT + LM_NEW,
                                params=eng.params)
        ref_logits, _ = blockwise.prefill(prompts)
        torch.cuda.synchronize()
        # the head is (D, padded_vocab); the logits are cut to vocab_size
        if tuple(logits.shape) != (LM_BATCH, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits {tuple(logits.shape)} "
                                 "not finite of the expected shape")
        err = float((logits - ref_logits).abs().max())
        scale = float(ref_logits.abs().max())
        allowed = LM_LOGIT_RTOL_OF_MAX * scale + LM_LOGIT_ATOL
        same_first = float((logits.argmax(-1) == ref_logits.argmax(-1))
                           .float().mean())
        del blockwise, ref_logits
        breakdown = _prefill_breakdown(torch, lambda: eng.prefill(prompts))
        streamed = (_streamed_mlp(torch, eng, cfg, prompts)
                    if arch in STREAMED_ARCHS else None)
        rows.append({
            "arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "act": cfg.act, "gated_mlp": cfg.gated_mlp,
            "vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
            "params_b": count_params(cfg) / 1e9, "params_gb": params_gb,
            "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
            "init_s": init_s,
            "cold": dataclasses.asdict(cold), "warm": dataclasses.asdict(warm),
            "flash_launches_per_prefill": per_prefill,
            "logits_max_abs_vs_blockwise": err, "logits_max_abs": scale,
            "logits_allowed": allowed, "argmax_agreement": same_first,
            "prefill_breakdown": breakdown, "streamed_mlp": streamed,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        })
        del eng, logits
        torch.cuda.empty_cache()
        # after the bf16 engine is freed: nemotron's f32 weights are 62 GB
        rows[-1]["f32_vs_blockwise"] = (_f32_gap(torch, cfg, prompts)
                                        if arch in LM_F32_ARCHS else None)
        rows[-1]["seconds"] = time.perf_counter() - t_arch
        if err > allowed:
            raise AssertionError(
                f"{arch}: prefill logits cuda vs blockwise differ by {err} "
                f"(allowed {allowed}; in f32: "
                f"{rows[-1]['f32_vs_blockwise']})")
    return {"models": rows, "serve_cli": serve_cli()}


def _f32_gap(torch, cfg, prompts) -> dict:
    """``cfg``'s prefill logits in f32, "cuda" against "blockwise", on
    weights drawn in f32 from the engine's seed: the gap the two
    attentions leave when no layer rounds to bf16."""
    from repro_torch.launch.serve import ServeEngine

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f32 = cfg.with_(dtype="float32")
    eng = ServeEngine(f32, max_len=prompts.shape[1], seed=0)
    logits, _ = eng.prefill(prompts)
    ref, _ = ServeEngine(f32.with_(attn_impl="blockwise"),
                         max_len=prompts.shape[1],
                         params=eng.params).prefill(prompts)
    torch.cuda.synchronize()
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    out = {"max_abs": err, "max_logit": scale,
           "allowed": LM_LOGIT_RTOL_OF_MAX * scale + LM_LOGIT_ATOL,
           "argmax_agreement": float((logits.argmax(-1) == ref.argmax(-1))
                                     .float().mean()),
           "seconds": time.perf_counter() - t0}
    del eng, logits, ref
    torch.cuda.empty_cache()
    return out


def serve_cli() -> dict:
    """``python -m repro_torch.launch.serve`` + ``SERVE_CLI_ARGS`` in a
    process of its own, with no ``--device`` (the card): exit 0 and its
    stats line, the tokens it emitted."""
    t0 = time.perf_counter()
    proc = _python(None, cpu_only=False,
                   argv=["-m", "repro_torch.launch.serve", *SERVE_CLI_ARGS])
    what = "python -m repro_torch.launch.serve " + " ".join(SERVE_CLI_ARGS)
    out = _finish(proc, what, SERVE_CLI_LIMIT_S)
    lines = out.splitlines()
    stats = json.loads(lines[0])
    if set(stats) != {"prefill_s", "decode_s", "tokens_out",
                      "tokens_per_s"} or stats["tokens_out"] != 4 * 32:
        raise AssertionError(f"{what}: stats line {lines[0]!r}")
    return {"argv": list(SERVE_CLI_ARGS), "rc": proc.returncode,
            "stats": stats, "stdout": lines[1:],
            "seconds": time.perf_counter() - t0}


def _logit_gap(a, b, rtol_of_max, atol, what):
    """max |a - b| against ``rtol_of_max`` × max |b| + ``atol``; raises
    beyond it or on non-finite logits."""
    import torch

    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: logits {tuple(a.shape)} not finite "
                             f"of the shape {tuple(b.shape)}")
    err = float((a.float() - b.float()).abs().max())
    scale = float(b.float().abs().max())
    allowed = rtol_of_max * scale + atol
    if err > allowed:
        raise AssertionError(f"{what}: logits differ by {err} (allowed "
                             f"{allowed})")
    return {"max_abs": err, "max_logit": scale, "allowed": allowed}


def _prefill_ms(torch, eng, prompts, reps: int = 3) -> float:
    eng.prefill(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.prefill(prompts)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _streamed_mlp(torch, eng, cfg, prompts) -> dict:
    """``mlp_impl="streamed"`` on the engine's weights: one prefill and
    STREAMED_STEPS decode steps, fused-MLP launches counted per call,
    logits held against the ``"dense"`` engine step by step (both fed the
    dense engine's greedy tokens), the warm prefill's split and wall over
    STREAMED_REPS prefills (the dense one's is the row's), and the decode
    steps' times beside the dense ones."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.launch.serve import ServeEngine

    st = ServeEngine(cfg.with_(mlp_impl="streamed"),
                     max_len=LM_PROMPT + LM_NEW, params=eng.params)
    bsz, plen = prompts.shape
    gaps = []
    with torch.inference_mode():
        before, fa_before = fm.launches, fa.launches
        ls, cs_ = st.prefill(prompts)
        torch.cuda.synchronize()
        per_prefill = fm.launches - before
        flash_per_prefill = fa.launches - fa_before
        ld, cd = eng.prefill(prompts)
        gaps.append(_logit_gap(ls, ld, LM_LOGIT_RTOL_OF_MAX, LM_LOGIT_ATOL,
                               "streamed prefill"))
        cache_s = st._expand_cache(cs_, bsz, plen)
        cache_d = eng._expand_cache(cd, bsz, plen)
        tok = ld.argmax(-1).to(torch.int32)
        per_step, step_ms = [], {"streamed": [], "dense": []}
        for i in range(STREAMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = fm.launches
            ls, cache_s = st._decode_step(st.params, cache_s, tok, plen + i)
            torch.cuda.synchronize()
            per_step.append(fm.launches - before)
            t1 = time.perf_counter()
            ld, cache_d = eng._decode_step(eng.params, cache_d, tok, plen + i)
            torch.cuda.synchronize()
            step_ms["streamed"].append((t1 - t0) * 1e3)
            step_ms["dense"].append((time.perf_counter() - t1) * 1e3)
            gaps.append(_logit_gap(ls, ld, LM_LOGIT_RTOL_OF_MAX,
                                   LM_LOGIT_ATOL, f"streamed decode {i}"))
            tok = ld.argmax(-1).to(torch.int32)
    if per_prefill != cfg.num_layers or per_step != [cfg.num_layers] * \
            STREAMED_STEPS or flash_per_prefill != cfg.num_layers:
        raise AssertionError(
            f"streamed MLP: {per_prefill} fused-MLP and {flash_per_prefill} "
            f"flash launches per prefill, {per_step} fused-MLP per decode "
            f"step; want {cfg.num_layers} each")
    return {
        "fused_mlp_launches_per_prefill": per_prefill,
        "flash_launches_per_prefill": flash_per_prefill,
        "fused_mlp_launches_per_step": per_step,
        "max_logit_gap_vs_dense": max(g["max_abs"] for g in gaps),
        "logit_gaps_vs_dense": gaps,
        "prefill_breakdown": _prefill_breakdown(
            torch, lambda: st.prefill(prompts), reps=STREAMED_REPS,
            classes=(("attention", "flash_attention"), ("mlp", "fused_mlp"))),
        "decode_step_ms": step_ms,
    }


# ---------------------------------------------------------------------------
# phase 13: the Mamba-2 server at full width
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
#: one decode step after an (L-1)-token prefill against an L-token
#: prefill, bf16 through all 48 layers: the recurrent step and the scan
#: round in other places, and the gap grows layer by layer — allowed: 5 %
#: of the largest |logit| plus 0.05
SSM_DECODE_RTOL_OF_MAX, SSM_DECODE_ATOL = 0.05, 0.05
#: the card against the port's own CPU run, same weights, at full width
#: and this depth and batch (bf16 on both; the CPU's products sum in
#: another order): the rule of the dense models' blockwise check
SSM_CPU_LAYERS, SSM_CPU_BATCH = 2, 2


def ssm_serve(torch) -> dict:
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import mamba2_ssd as ms
    from repro_torch.launch.serve import ServeEngine

    cfg = get_config(SSM_ARCH)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           dtype=np.int32)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, max_len=LM_PROMPT + LM_NEW, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    before = ms.launches
    out, cold = eng.generate(prompts, max_new=LM_NEW)
    per_prefill = ms.launches - before
    if per_prefill != cfg.num_layers:
        raise AssertionError(
            f"{SSM_ARCH}: {per_prefill} SSD launches in one generate, want "
            f"{cfg.num_layers} (one per layer of the prefill)")
    if out.shape != (LM_BATCH, LM_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab_size:
        raise AssertionError(f"{SSM_ARCH}: tokens {out.shape} out of range")
    out2, warm = eng.generate(prompts, max_new=LM_NEW)
    if not np.array_equal(out, out2):
        raise AssertionError(f"{SSM_ARCH}: greedy generate not repeatable")

    # the kernel's final state against the recurrence: decode the last
    # prompt token after an (L-1)-token prefill (chunk 33, a ragged tile)
    with torch.inference_mode():
        full, _ = eng.prefill(prompts)
        short, caches = eng.prefill(prompts[:, :-1])
        cache = eng._expand_cache(caches, LM_BATCH, LM_PROMPT - 1)
        last = torch.as_tensor(prompts[:, -1], dtype=torch.int32,
                               device=eng.device)
        stepped, _ = eng._decode_step(eng.params, cache, last, LM_PROMPT - 1)
    torch.cuda.synchronize()
    if tuple(full.shape) != (LM_BATCH, cfg.vocab_size):
        raise AssertionError(f"{SSM_ARCH}: logits {tuple(full.shape)}")
    decode_gap = _logit_gap(stepped, full, SSM_DECODE_RTOL_OF_MAX,
                            SSM_DECODE_ATOL, f"{SSM_ARCH} decode vs prefill")
    decode_gap["argmax_agreement"] = float(
        (stepped.argmax(-1) == full.argmax(-1)).float().mean())

    breakdown = _prefill_breakdown(torch, lambda: eng.prefill(prompts),
                                   classes=(("ssd", "mamba2_ssd"),))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng, full, short, caches, cache, stepped
    torch.cuda.empty_cache()

    # full width, depth 2: the card against the port's own CPU run
    cfg2 = cfg.with_(num_layers=SSM_CPU_LAYERS)
    sub = prompts[:SSM_CPU_BATCH]
    card = ServeEngine(cfg2, max_len=LM_PROMPT, seed=1)
    card_logits, _ = card.prefill(sub)
    cpu_params = _tree_to(card.params, "cpu")
    t0 = time.perf_counter()
    host = ServeEngine(cfg2, device="cpu", max_len=LM_PROMPT,
                       params=cpu_params)
    cpu_logits, _ = host.prefill(sub)
    cpu_s = time.perf_counter() - t0
    cpu_gap = _logit_gap(card_logits.cpu(), cpu_logits, LM_LOGIT_RTOL_OF_MAX,
                         LM_LOGIT_ATOL, f"{SSM_ARCH} depth 2 card vs cpu")
    agree = card_logits.argmax(-1).cpu() == cpu_logits.argmax(-1)
    if not bool(agree.all()):
        raise AssertionError(f"{SSM_ARCH} depth 2: argmax differs between "
                             f"the card and the CPU ({agree.tolist()})")
    s = cfg.ssm
    return {
        "arch": SSM_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "ssm": {"heads": s.num_heads(cfg.d_model), "head_dim": s.head_dim,
                "state_dim": s.state_dim, "chunk": s.chunk},
        "vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
        "init_s": init_s, "cold": dataclasses.asdict(cold),
        "warm": dataclasses.asdict(warm),
        "ssd_launches_per_prefill": per_prefill,
        "decode_vs_prefill": decode_gap,
        "depth2_card_vs_cpu": dict(cpu_gap, batch=SSM_CPU_BATCH,
                                   cpu_seconds=cpu_s, argmax_agrees=True),
        "prefill_breakdown": breakdown, "peak_mem_gb": peak,
    }


# ---------------------------------------------------------------------------
# phases 14-16: the MoE, hybrid and encoder-decoder servers
# ---------------------------------------------------------------------------

MOE_ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")
#: the card against the port's own CPU run, at full width and this depth
#: and batch (the rule of the dense models' blockwise check, and argmax
#: equal)
MOE_CPU_LAYERS, MOE_CPU_BATCH = 2, 2
#: Jamba on one card: the published superblock holds ≈ 90 GB of bf16
#: weights (its 4 MoE layers × 16 experts × 3 × 8192 × 24576 alone ≈ 77
#: GB), more than the card's 80 GB, so one superblock (8 of 72 layers)
#: with d_ff cut to 12288 (≈ 24.6 B params, 49 GB); every other width,
#: the routing and the SSM shape as published
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_CUT = {"num_layers": 8, "d_ff": 12288}
#: the width of Jamba's card-against-CPU run, which the CPU takes in
#: seconds: the SSM heads (P 64, N 128), 16 experts top-2, GQA group 8 at
#: head dim 128 and the 8-layer pattern kept
HYBRID_CPU_WIDTH = {"d_model": 1024, "num_heads": 8, "num_kv_heads": 1,
                    "d_ff": 2048}
ENCDEC_ARCH = "seamless-m4t-medium"
#: the card against the port's CPU run: depth 2 + 2, batch 2, the
#: prefill and this many decode steps fed the card's tokens
ENCDEC_CPU_DEPTH = {"enc_layers": 2, "dec_layers": 2, "num_layers": 4}
ENCDEC_CPU_STEPS = 4


class _Calls:
    """While active, ``module.name`` is wrapped — not replaced: what it
    computes and counts is unchanged — and ``keep(args, kwargs, result)``
    of each call is appended to ``calls``."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep = module, name, keep
        self.calls = []

    def __enter__(self):
        self.real = real = getattr(self.module, self.name)

        def recording(*args, **kwargs):
            out = real(*args, **kwargs)
            self.calls.append(self.keep(args, kwargs, out))
            return out

        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def _routing():
    """Records ``(params, input, (gate_w, gate_i, pos, keep))`` of each
    ``moe.route`` call: one per MoE layer of a prefill or a decode
    step."""
    from repro_torch.models import moe

    return _Calls(moe, "route", lambda args, kwargs, out: (args[0], args[2],
                                                           out))


def _choices():
    """Records the choices ``(gate_i, pos, keep)`` of each ``moe.route``
    call, for :class:`_ReplayingChoices`."""
    from repro_torch.models import moe

    return _Calls(moe, "route", lambda args, kwargs, out: tuple(
        t.detach() for t in out[1:]))


class _ReplayingChoices:
    """While active, ``moe.route`` takes the recorded choices ``(gate_i,
    pos, keep)`` in turn (moved to the device of the call) and computes
    the gate weights from the live f32 logits, ``softmax(logits.gather(-1,
    gate_i))`` — the values ``route`` gives for those choices, with the
    router's gradient flowing as through ``route``.  A run then trains on
    the experts another run chose; only the discrete choices are
    replayed, never the gates (a recorded ``gate_w`` would be a constant,
    and the router's gradient 0)."""

    def __init__(self, choices):
        self.choices = choices

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.real, recorded = moe.route, iter(self.choices)

        def replay(p, cfg, xf):
            gi, pos, keep = (t.to(xf.device) for t in next(recorded))
            logits = xf.float() @ p["router"]
            return (torch.softmax(logits.gather(-1, gi), dim=-1), gi, pos,
                    keep)

        moe.route = replay
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self.real
        return False


def _for_decode_check(cfg):
    """``cfg`` for decode against prefill: the capacity factor raised to
    E / k, so that capacity = tokens and no choice can drop
    (``tests/test_models.py`` tests the cache contract drop-free for the
    same reason), and attention blocks 0, so that the (L-1)-token prefill
    passes the block gate (the blocks only gate the call, as the TPU
    wrapper's do; the kernel masks a ragged tile itself)."""
    m = cfg.moe
    return cfg.with_(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k), attn_block_q=0,
        attn_block_k=0)


def _serve_routed(torch, cfg, *, per_prefill: dict, classes) -> tuple:
    """``lm_serve``'s and ``ssm_serve``'s checks for a model with MoE
    layers: ``generate`` twice (the same tokens; ``per_prefill``: kernel
    name → (module, launches one prefill must add)), the prefill split,
    peak memory, the share of (token, choice) pairs each MoE layer drops
    at the published capacity, and one decode step after an (L-1)-token
    prefill against an L-token prefill, drop-free.  → (row, prompts)."""
    import numpy as np

    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import moe

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           dtype=np.int32)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, max_len=LM_PROMPT + LM_NEW, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()     # serving's peak, not init's

    before = {name: mod.launches for name, (mod, _) in per_prefill.items()}
    out, cold = eng.generate(prompts, max_new=LM_NEW)
    launched = {name: mod.launches - before[name]
                for name, (mod, _) in per_prefill.items()}
    if launched != {name: n for name, (_, n) in per_prefill.items()}:
        raise AssertionError(f"{cfg.name}: launches in one generate "
                             f"{launched}, want {per_prefill}")
    if out.shape != (LM_BATCH, LM_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {out.shape} out of range")
    out2, warm = eng.generate(prompts, max_new=LM_NEW)
    if not np.array_equal(out, out2):
        raise AssertionError(f"{cfg.name}: greedy generate not repeatable")

    with _routing() as routed:
        eng.prefill(prompts)
    dropped = [float((~out[3]).float().mean()) for *_, out in routed.calls]
    breakdown = _prefill_breakdown(torch, lambda: eng.prefill(prompts),
                                   classes=classes)
    peak = torch.cuda.max_memory_allocated() / 1e9

    free = ServeEngine(_for_decode_check(cfg), max_len=LM_PROMPT + LM_NEW,
                       params=eng.params)
    with torch.inference_mode(), _routing() as routed:
        full, _ = free.prefill(prompts)
        _, caches = free.prefill(prompts[:, :-1])
        cache = free._expand_cache(caches, LM_BATCH, LM_PROMPT - 1)
        last = torch.as_tensor(prompts[:, -1], dtype=torch.int32,
                               device=free.device)
        stepped, _ = free._decode_step(free.params, cache, last,
                                       LM_PROMPT - 1)
    torch.cuda.synchronize()
    n_dropped = sum(int((~out[3]).sum()) for *_, out in routed.calls)
    if n_dropped:
        raise AssertionError(f"{cfg.name}: {n_dropped} choices dropped at "
                             f"capacity factor {free.cfg.moe.capacity_factor}")
    decode_gap = _logit_gap(stepped, full, SSM_DECODE_RTOL_OF_MAX,
                            SSM_DECODE_ATOL, f"{cfg.name} decode vs prefill")
    decode_gap.update(
        argmax_agreement=float((stepped.argmax(-1) == full.argmax(-1))
                               .float().mean()),
        capacity_factor=free.cfg.moe.capacity_factor, dropped=n_dropped)
    m = cfg.moe
    row = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads],
        "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
        "experts": [m.num_experts, m.top_k], "vocab": cfg.vocab_size,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
        "init_s": init_s, "cold": dataclasses.asdict(cold),
        "warm": dataclasses.asdict(warm), "launches_per_prefill": launched,
        "capacity": {"factor": m.capacity_factor,
                     "slots": moe.expert_capacity(LM_BATCH * LM_PROMPT,
                                                  cfg)},
        "dropped_share": [min(dropped), sum(dropped) / len(dropped),
                          max(dropped)],
        "dropped_share_per_layer": dropped,
        "decode_vs_prefill": decode_gap,
        "prefill_breakdown": breakdown, "weights_gb": weights_gb,
        "peak_mem_gb": peak,
    }
    return row, prompts


def _card_vs_cpu(torch, cfg, prompts, rule) -> dict:
    """``cfg``'s prefill of ``prompts`` on the card and in the port's own
    CPU run, same weights.  The CPU routes the card's first MoE input
    once, then runs the model twice: replaying the card's routing, and
    routing by itself.

    * The replayed run (the card's choices; the gates from the CPU's own
      logits) differs from the card by summation order alone:
      its logits are held to ``rule`` (rtol of the largest |logit|,
      atol), argmax equal.
    * The card's first MoE input routed on the CPU: the share of (token,
      choice) pairs chosen alike, whether positions and drops agree, and
      each token chosen otherwise named with the CPU's logits of the two
      experts at the first slot that differs.
    * The free run shows how far the routing carries rounding: per MoE
      layer the share of pairs routed alike, and its logits' distance."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import moe

    card = ServeEngine(cfg, max_len=prompts.shape[1], seed=1)
    with _routing() as on_card:
        card_logits, _ = card.prefill(prompts)
    card_logits = card_logits.cpu()
    t0 = time.perf_counter()
    host = ServeEngine(cfg, device="cpu", max_len=prompts.shape[1],
                       params=_tree_to(card.params, "cpu"))
    with _ReplayingChoices([out[1:] for *_, out in on_card.calls]):
        replayed, _ = host.prefill(prompts)
    cpu_s = time.perf_counter() - t0
    gap = _logit_gap(card_logits, replayed, *rule,
                     f"{cfg.name} card vs cpu, the card's routing")
    agree = card_logits.argmax(-1) == replayed.argmax(-1)
    if not bool(agree.all()):
        raise AssertionError(f"{cfg.name}: argmax differs between the card "
                             f"and the CPU ({agree.tolist()})")

    p0, x0, (_, gi_card, pos_card, keep_card) = on_card.calls[0]
    p0, x0 = _tree_to(p0, "cpu"), x0.cpu()
    _, gi_cpu, pos_cpu, keep_cpu = moe.route(p0, cfg, x0)
    gi_card = gi_card.cpu()
    logits0 = x0.float() @ p0["router"]
    flips = []
    for tok in (gi_card != gi_cpu).any(-1).nonzero()[:, 0].tolist():
        j = int((gi_card[tok] != gi_cpu[tok]).nonzero()[0, 0])
        a, b = int(gi_card[tok, j]), int(gi_cpu[tok, j])
        flips.append([tok, j, a, b, float(logits0[tok, a]),
                      float(logits0[tok, b])])

    with _routing() as on_cpu:
        free, _ = host.prefill(prompts)
    per_layer = [float((a[2][1].cpu() == b[2][1]).float().mean())
                 for a, b in zip(on_card.calls, on_cpu.calls)]
    return dict(
        gap, layers=cfg.num_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
        batch=prompts.shape[0], cpu_seconds=cpu_s, argmax_agrees=True,
        first_moe_same_input={
            "choices_equal": float((gi_card == gi_cpu).float().mean()),
            "tokens_flipped": len(flips),
            "positions_equal": bool(torch.equal(pos_card.cpu(), pos_cpu)),
            "drops_equal": bool(torch.equal(keep_card.cpu(), keep_cpu))},
        flips=flips[:20],
        own_routing={
            "max_abs": float((card_logits - free).abs().max()),
            "argmax_agreement": float((card_logits.argmax(-1)
                                       == free.argmax(-1)).float().mean()),
            "choices_equal_per_moe_layer": per_layer})


def moe_serve(torch) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa

    rows = []
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        row, prompts = _serve_routed(
            torch, cfg, per_prefill={"flash_attention": (fa, cfg.num_layers)},
            classes=(("attention", "flash_attention"),))
        row["depth2_card_vs_cpu"] = _card_vs_cpu(
            torch, cfg.with_(num_layers=MOE_CPU_LAYERS),
            prompts[:MOE_CPU_BATCH], (LM_LOGIT_RTOL_OF_MAX, LM_LOGIT_ATOL))
        rows.append(row)
        torch.cuda.empty_cache()
    return {"models": rows}


def hybrid_serve(torch) -> dict:
    from repro_torch.configs.base import count_params
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ms
    from repro_torch.models import lm

    published = get_config(HYBRID_ARCH)
    cfg = published.with_(**HYBRID_CUT)
    n_sb = lm.num_superblocks(cfg)
    row, prompts = _serve_routed(
        torch, cfg, per_prefill={"flash_attention": (fa, n_sb),
                                 "mamba2_ssd": (ms, 7 * n_sb)},
        classes=(("attention", "flash_attention"), ("ssd", "mamba2_ssd")))
    s = cfg.ssm
    row.update(
        cut={k: [getattr(published, k), v] for k, v in HYBRID_CUT.items()},
        params_b=count_params(cfg) / 1e9,
        ssm={"heads": s.num_heads(cfg.d_model), "head_dim": s.head_dim,
             "state_dim": s.state_dim, "chunk": s.chunk},
        pattern=[f"{spec.mixer}+{spec.ffn}"
                 for spec in lm.superblock_pattern(cfg)])
    torch.cuda.empty_cache()
    # bf16 through 7 Mamba-2 layers: ssm_serve's rule (on an H100 this
    # check read 0.135 against the dense rule's 0.1075: the Mamba layers
    # carry rounding further, in the reference too — see
    # tests/test_torch_hybrid_serve.py)
    row["card_vs_cpu"] = _card_vs_cpu(
        torch, cfg.with_(**HYBRID_CPU_WIDTH), prompts[:MOE_CPU_BATCH],
        (SSM_DECODE_RTOL_OF_MAX, SSM_DECODE_ATOL))
    return row


def _encdec_generate(torch, eng, frames, new: int):
    """The server's greedy loop through the step functions: prefill (the
    first token), the self cache laid into ``max_len``, ``new - 1``
    decode steps → ((B, new) tokens, stats as ``ServeStats``' fields)."""
    import numpy as np

    from repro_torch.launch import steps as ST

    bsz = frames.shape[0]
    out = np.zeros((bsz, new), np.int32)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, caches = ST.model_prefill(eng.params, eng.cfg,
                                          {"frames": frames})
        cache = eng._expand_cache(caches, bsz, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = logits.argmax(-1).to(torch.int32)
        out[:, 0] = tok.cpu().numpy()
        for i in range(1, new):
            logits, cache = ST.model_decode(eng.params, eng.cfg, cache, tok,
                                            i)
            tok = logits.argmax(-1).to(torch.int32)
            out[:, i] = tok.cpu().numpy()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                 "tokens_out": bsz * new,
                 "tokens_per_s": bsz * new / max(t2 - t1, 1e-9)}


def encdec_serve(torch) -> dict:
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.device import to_tensor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import ServeEngine

    cfg = get_config(ENCDEC_ARCH)
    frames_np = np.random.default_rng(0).standard_normal(
        (LM_BATCH, LM_PROMPT, cfg.d_model), dtype=np.float32)
    t0 = time.perf_counter()
    # max_len = the frames: the cross K/V cache is then the memory whole
    eng = ServeEngine(cfg, max_len=LM_PROMPT, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()     # serving's peak, not init's
    frames = to_tensor(frames_np, eng.device)

    before = fa.launches
    with _Calls(fa, "flash_attention",
                lambda args, kw, out: kw["causal"]) as fl:
        out, cold = _encdec_generate(torch, eng, frames, LM_NEW)
    per_prefill = fa.launches - before
    if per_prefill != cfg.enc_layers or fl.calls != [False] * cfg.enc_layers:
        raise AssertionError(
            f"{ENCDEC_ARCH}: {per_prefill} flash launches (causal "
            f"{fl.calls}) in one generate, want {cfg.enc_layers} non-causal")
    if out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{ENCDEC_ARCH}: tokens out of range")
    out2, warm = _encdec_generate(torch, eng, frames, LM_NEW)
    if not np.array_equal(out, out2):
        raise AssertionError(f"{ENCDEC_ARCH}: greedy decode not repeatable")

    def prefill():
        with torch.inference_mode():
            return ST.model_prefill(eng.params, cfg, {"frames": frames})

    breakdown = _prefill_breakdown(torch, prefill)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    torch.cuda.empty_cache()

    # depth 2 + 2, batch 2: the card against the port's own CPU run
    cfg2 = cfg.with_(**ENCDEC_CPU_DEPTH)
    card = ServeEngine(cfg2, max_len=LM_PROMPT, seed=1)
    host = ServeEngine(cfg2, device="cpu", max_len=LM_PROMPT,
                       params=_tree_to(card.params, "cpu"))
    sub = frames_np[:MOE_CPU_BATCH]
    gaps, agree = [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        lc, cc = ST.model_prefill(card.params, cfg2,
                                  {"frames": to_tensor(sub, card.device)})
        lh, ch = ST.model_prefill(host.params, cfg2,
                                  {"frames": torch.from_numpy(sub)})
        cc = card._expand_cache(cc, MOE_CPU_BATCH, 1)
        ch = host._expand_cache(ch, MOE_CPU_BATCH, 1)
        for i in range(ENCDEC_CPU_STEPS + 1):
            what = f"{ENCDEC_ARCH} depth 2+2 card vs cpu, step {i}"
            gaps.append(_logit_gap(lc.cpu(), lh, LM_LOGIT_RTOL_OF_MAX,
                                   LM_LOGIT_ATOL, what))
            agree.append(float((lc.argmax(-1).cpu() == lh.argmax(-1))
                               .float().mean()))
            if i == ENCDEC_CPU_STEPS:
                break
            tok = lc.argmax(-1).to(torch.int32)
            lc, cc = ST.model_decode(card.params, cfg2, cc, tok, i + 1)
            lh, ch = ST.model_decode(host.params, cfg2, ch, tok.cpu(), i + 1)
    if agree[0] != 1.0:
        raise AssertionError(f"{ENCDEC_ARCH} depth 2+2: prefill argmax "
                             "differs between the card and the CPU")
    return {
        "arch": ENCDEC_ARCH, "layers": [cfg.enc_layers, cfg.dec_layers],
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
        "batch": LM_BATCH, "frames": LM_PROMPT, "new": LM_NEW,
        "init_s": init_s, "cold": cold, "warm": warm,
        "flash_launches_per_prefill": per_prefill, "causal": False,
        "depth2_card_vs_cpu": {
            "batch": MOE_CPU_BATCH, "steps": ENCDEC_CPU_STEPS,
            "cpu_and_card_seconds": time.perf_counter() - t0,
            "max_abs": max(g["max_abs"] for g in gaps),
            "allowed": min(g["allowed"] for g in gaps),
            "argmax_agreement": agree, "decode_gaps": gaps},
        "prefill_breakdown": breakdown, "weights_gb": weights_gb,
        "peak_mem_gb": peak,
    }


# ---------------------------------------------------------------------------
# phase 16a: the vision-language backbone on embeddings
# ---------------------------------------------------------------------------

VLM_ARCH = "qwen2-vl-72b"
#: full width, the first 16 of the published 80 layers: the 80 hold
#: ≈ 143 GB of bf16 weights, the card 80 GB; 16 and the (8192 × 152064)
#: head hold ≈ 31 GB
VLM_LAYERS = 16
#: each prompt's image: a grid of patches, one M-RoPE (t, h, w) each
VLM_GRID = (28, 28)
#: the card against the port's own CPU run: depth 2, d_model 256, the
#: published 64/8 heads of 128 (M-RoPE's sections 16/24/24 cover half a
#: head of 128), d_ff, vocabulary and qkv bias; batch 2, a prefill and
#: ENCDEC_CPU_STEPS decode steps
VLM_CPU_CUT = {"num_layers": 2, "d_model": 256, "head_dim": 128}


def mrope_streams(rng, batch: int, seq: int, grid=VLM_GRID):
    """(3, B, S) int32 M-RoPE positions of prompts laid out as Qwen2-VL
    lays them: text of a seeded length, one image of ``grid`` patches,
    text to the end.  Text takes the same position on the three axes; the
    image's patches (t, h, w) = (p, p + row, p + column) from the position
    p after the text before it; the text after it goes on from p +
    max(grid)."""
    import numpy as np

    gh, gw = grid
    n = gh * gw
    row, col = np.divmod(np.arange(n), gw)
    out = np.empty((3, batch, seq), np.int32)
    for b in range(batch):
        p = int(rng.integers(16, seq - n - 16))
        out[:, b, :p] = np.arange(p)
        out[0, b, p:p + n] = p
        out[1, b, p:p + n] = p + row
        out[2, b, p:p + n] = p + col
        out[:, b, p + n:] = p + max(gh, gw) + np.arange(seq - p - n)
    return out


def _vlm_generate(torch, eng, batch: dict, step_embeds):
    """A prefill of ``batch`` (embeddings and M-RoPE streams) through
    ``steps.make_prefill_step``, its caches laid into ``max_len``, then
    one decode step through ``make_decode_step`` for each (B, 1, D)
    embedding of ``step_embeds`` → ((B, 1 + steps) greedy tokens, stats
    as ``ServeStats``' fields, the prefill's logits)."""
    import numpy as np

    bsz, plen = batch["embeds"].shape[:2]
    steps = step_embeds.shape[0]
    out = np.zeros((bsz, 1 + steps), np.int32)
    t0 = time.perf_counter()
    with torch.inference_mode():
        first, caches = eng._prefill_step(eng.params, batch)
        cache = eng._expand_cache(caches, bsz, plen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out[:, 0] = first.argmax(-1).cpu().numpy()
        for i in range(steps):
            logits, cache = eng._decode_step(eng.params, cache,
                                             step_embeds[i], plen + i)
            out[:, 1 + i] = logits.argmax(-1).cpu().numpy()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                 "tokens_out": bsz * steps,
                 "tokens_per_s": bsz * steps / max(t2 - t1, 1e-9)}, first


def vlm_serve(torch) -> dict:
    import numpy as np

    from repro_torch.configs.base import count_params
    from repro_torch.configs.registry import get_config
    from repro_torch.device import to_tensor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import ServeEngine

    published = get_config(VLM_ARCH)
    cfg = published.with_(num_layers=VLM_LAYERS)
    rng = np.random.default_rng(0)
    embeds_np = rng.standard_normal((LM_BATCH, LM_PROMPT, cfg.d_model),
                                    dtype=np.float32)
    mrope_np = mrope_streams(rng, LM_BATCH, LM_PROMPT)
    steps_np = rng.standard_normal((LM_NEW, LM_BATCH, 1, cfg.d_model),
                                   dtype=np.float32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, max_len=LM_PROMPT + LM_NEW, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = _tree_nbytes(eng.params) / 1e9
    dev = eng.device
    batch = {"embeds": to_tensor(embeds_np, dev).to(cfg.param_dtype),
             "mrope_positions": to_tensor(mrope_np, dev)}
    step_embeds = to_tensor(steps_np, dev).to(cfg.param_dtype)

    before = fa.launches
    out, cold, logits = _vlm_generate(torch, eng, batch, step_embeds)
    per_prefill = fa.launches - before
    if per_prefill != cfg.num_layers:
        raise AssertionError(
            f"{VLM_ARCH}: {per_prefill} flash launches in a prefill and "
            f"{LM_NEW} decode steps, want {cfg.num_layers} (one per layer "
            "of the prefill)")
    if tuple(logits.shape) != (LM_BATCH, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{VLM_ARCH}: logits {tuple(logits.shape)} "
                             "not finite of the expected shape")
    if out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{VLM_ARCH}: tokens out of range")
    out2, warm, _ = _vlm_generate(torch, eng, batch, step_embeds)
    if not np.array_equal(out, out2):
        raise AssertionError(f"{VLM_ARCH}: greedy decode not repeatable")

    blockwise = ServeEngine(cfg.with_(attn_impl="blockwise"),
                            max_len=LM_PROMPT + LM_NEW, params=eng.params)
    with torch.inference_mode():
        ref, _ = blockwise._prefill_step(blockwise.params, batch)
    gap = _logit_gap(logits, ref, LM_LOGIT_RTOL_OF_MAX, LM_LOGIT_ATOL,
                     f"{VLM_ARCH} prefill cuda vs blockwise")
    gap["argmax_agreement"] = float((logits.argmax(-1) == ref.argmax(-1))
                                    .float().mean())
    del blockwise, ref

    def prefill():
        with torch.inference_mode():
            return eng._prefill_step(eng.params, batch)

    breakdown = _prefill_breakdown(torch, prefill)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng, batch, logits
    torch.cuda.empty_cache()

    # depth 2, d_model 256: the card against the port's own CPU run, on
    # embeddings of the cut's width and the first prompts' streams
    cfg2 = published.with_(**VLM_CPU_CUT)
    max_len = LM_PROMPT + ENCDEC_CPU_STEPS
    card = ServeEngine(cfg2, max_len=max_len, seed=1)
    host = ServeEngine(cfg2, device="cpu", max_len=max_len,
                       params=_tree_to(card.params, "cpu"))
    sub = {"embeds": torch.from_numpy(rng.standard_normal(
               (MOE_CPU_BATCH, LM_PROMPT, cfg2.d_model), dtype=np.float32)),
           "mrope_positions": torch.from_numpy(
               np.ascontiguousarray(mrope_np[:, :MOE_CPU_BATCH]))}
    steps_np = rng.standard_normal(
        (ENCDEC_CPU_STEPS, MOE_CPU_BATCH, 1, cfg2.d_model), dtype=np.float32)
    gaps, agree = [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        lc, cc = card._prefill_step(card.params,
                                    _tree_to(sub, card.device))
        lh, ch = host._prefill_step(host.params, sub)
        cc = card._expand_cache(cc, MOE_CPU_BATCH, LM_PROMPT)
        ch = host._expand_cache(ch, MOE_CPU_BATCH, LM_PROMPT)
        for i in range(ENCDEC_CPU_STEPS + 1):
            what = f"{VLM_ARCH} depth 2 card vs cpu, step {i}"
            gaps.append(_logit_gap(lc.cpu(), lh, LM_LOGIT_RTOL_OF_MAX,
                                   LM_LOGIT_ATOL, what))
            agree.append(float((lc.argmax(-1).cpu() == lh.argmax(-1))
                               .float().mean()))
            if i == ENCDEC_CPU_STEPS:
                break
            e = torch.from_numpy(steps_np[i])
            lc, cc = card._decode_step(card.params, cc,
                                       e.to(card.device), LM_PROMPT + i)
            lh, ch = host._decode_step(host.params, ch, e, LM_PROMPT + i)
    if agree[0] != 1.0:
        raise AssertionError(f"{VLM_ARCH} depth 2: prefill argmax differs "
                             "between the card and the CPU")
    return {
        "arch": VLM_ARCH, "layers": cfg.num_layers,
        "cut": {"num_layers": [published.num_layers, VLM_LAYERS]},
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
        "mrope_sections": list(cfg.mrope_sections),
        "vocab": cfg.vocab_size, "params_b": count_params(cfg) / 1e9,
        "published_params_b": count_params(published) / 1e9,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_NEW,
        "image_grid": list(VLM_GRID), "init_s": init_s,
        "cold": cold, "warm": warm,
        "flash_launches_per_prefill": per_prefill,
        "logits_vs_blockwise": gap,
        "depth2_card_vs_cpu": {
            "cut": VLM_CPU_CUT, "batch": MOE_CPU_BATCH,
            "steps": ENCDEC_CPU_STEPS,
            "cpu_and_card_seconds": time.perf_counter() - t0,
            "max_abs": max(g["max_abs"] for g in gaps),
            "allowed": min(g["allowed"] for g in gaps),
            "argmax_agreement": agree, "decode_gaps": gaps},
        "prefill_breakdown": breakdown, "weights_gb": weights_gb,
        "peak_mem_gb": peak,
    }


# ---------------------------------------------------------------------------
# phase 17: the dense LM's train step
# ---------------------------------------------------------------------------

#: llama3.2-1b at published width and depth, train_4k's sequence of 4096;
#: its global batch of 256 cut to 8 rows, taken as 2 microbatches of 4 so
#: that the gradient accumulation runs on the card
TRAIN_ARCH = "llama3.2-1b"
TRAIN_ROWS, TRAIN_ACCUM, TRAIN_STEPS = 8, 2, 5
#: AdamWConfig's default lr 3e-4 with one warmup step overshoots on this
#: random 1B model (losses 12.41, 10.59, 14.67, 16.66, 12.26 on an H100)
TRAIN_LR = 1e-4
#: the card against the port's own CPU run: the same seeded parameters
#: (through ``lm_params_from_numpy``) at depth 2 and d_model 256 (4/1
#: heads of the published 64, d_ff 1024, the published vocab), a batch of
#: 2 × 256 tokens as 2 microbatches, one step.  Rules, set before the
#: first run: f32 — loss rtol 1e-5, each gradient leaf's relative L2
#: error ≤ 1e-4, parameters after the step atol = rtol = 1e-4 (the CPU
#: tests' rule against the reference); bf16 — loss rtol 1e-2, relative L2
#: ≤ 5e-2 (each device rounds every bf16 product and sum on its own),
#: parameters atol = rtol = 3e-2 (the CPU tests' bf16 rule).  Two
#: exceptions, each held to a rule of its own and listed in the result:
#: an element whose gradient lies below ``ADAM_SLACK_BELOW`` in both runs
#: (``adam_first_step_slack``), and in bf16 a gradient leaf that bf16
#: rounding alone moves further than the rule can tell apart
#: (``BF16_GAP_RULE``)
TRAIN_CPU_CUT = {"num_layers": 2, "d_model": 256, "num_heads": 4,
                 "num_kv_heads": 1, "head_dim": 64, "d_ff": 1024}
TRAIN_CPU_ROWS, TRAIN_CPU_SEQ = 2, 256
TRAIN_CPU_RULE = {"float32": (1e-5, 1e-4, 1e-4),
                  "bfloat16": (1e-2, 5e-2, 3e-2)}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


#: the MoE and SSM train steps (granite-moe-1b-a400m, mamba2-1.3b) at
#: published width and depth, with ``lm_train``'s batch, steps and lr;
#: their card-against-CPU cuts: depth 2 and d_model 256 with the published
#: head, expert and state widths (granite: 16/8 heads of 64, d_ff 512, 32
#: experts top 8; mamba2: SSM heads of P 64, N 128, chunk 64)
MOE_TRAIN_ARCH, SSM_TRAIN_ARCH = "granite-moe-1b-a400m", "mamba2-1.3b"
MOE_TRAIN_CPU_CUT = {"num_layers": 2, "d_model": 256, "head_dim": 64}
SSM_TRAIN_CPU_CUT = {"num_layers": 2, "d_model": 256}
#: the profiled step's classes of hand-written kernel (B2, B2′, B4′, B4,
#: B3′, B3: the backward's name first where the forward's is a piece of
#: it)
TRAIN_CLASSES = (("attn_fwd", "flash_attention"), ("attn_bwd", "attn_bwd_"),
                 ("ssd_bwd", "mamba2_ssd_bwd"), ("ssd_fwd", "mamba2_ssd"),
                 ("mlp_bwd", "mlp_bwd_"), ("mlp_fwd", "fused_mlp"))
#: llama3.2-1b with the streamed MLP: ``lm_train``'s model, batch, steps
#: and lr, ``mlp_impl="streamed"`` (B3 forward, B3′ backward)
STREAMED_TRAIN_ARCH = TRAIN_ARCH
#: seamless-m4t-medium at published width and depth (12 + 12 layers,
#: d_model 1024, vocab 256206), the reference's train mapping
#: (``src/repro/launch/specs.py:43-49``): train_4k's 4096 stub frames a
#: row and a quarter as many targets, ``TRAIN_ROWS`` rows as
#: ``TRAIN_ACCUM`` microbatches; the card against the CPU at depth 2 + 2
#: (``ENCDEC_CPU_DEPTH``) and d_model 256 (16 heads of the published 64,
#: d_ff and vocab as published), 2 × 256 frames and 64 targets — the
#: other train phases' CPU cut; at the published d_model 1024 the check
#: took ≈ 100 s of the run's 1200
ENCDEC_TRAIN_ARCH = ENCDEC_ARCH
ENCDEC_DEC_FRAC = 4
ENCDEC_TRAIN_CPU_WIDTH = {"d_model": 256, "head_dim": 64}
#: Jamba's superblock, trained on one card only at a width cut: the
#: published one holds ≈ 44 B parameters, the serving cut ≈ 24.6 B (49 GB
#: of bf16 weights), and training adds f32 gradients, two f32 moments and
#: AdamW's second copy (≥ 16 B a parameter).  So ``HYBRID_CPU_WIDTH``
#: (d_model 1024, 8/1 heads of 128, d_ff 2048; ≈ 0.6 B parameters) with
#: the 8-layer pattern, 16 experts top-2, SSM heads of P 64 / N 128,
#: chunk 64 and the published vocab kept: its tokens/s is not Jamba's.
#: The card against the CPU at depth 8 and d_model 256 (2/1 heads of
#: 128, d_ff 512), the card's routing replayed
HYBRID_TRAIN_CUT = {"num_layers": 8, **HYBRID_CPU_WIDTH}
HYBRID_TRAIN_CPU_CUT = {"num_layers": 8, "d_model": 256, "num_heads": 2,
                        "num_kv_heads": 1, "d_ff": 512}


def _kernel_counts() -> dict:
    """Every kernel's launch count, by name."""
    from repro_torch.kernels import conv2d_stream as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import mamba2_ssd as ms

    return {"conv2d_stream": cs.launches, "flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches, "fused_mlp": fm.launches,
            "fused_mlp_bwd": fm.bwd_launches, "mamba2_ssd": ms.launches,
            "mamba2_ssd_bwd": ms.bwd_launches}


def _per_step(**layers) -> dict:
    """Launches a train step makes, from the layers that run each kernel
    pair: two forward launches a layer and microbatch (remat runs each
    forward twice) and one backward — ``attn``: B2, B2′; ``ssd``: B4, B4′;
    ``mlp``: B3, B3′."""
    names = {"attn": ("flash_attention", "flash_attention_bwd"),
             "ssd": ("mamba2_ssd", "mamba2_ssd_bwd"),
             "mlp": ("fused_mlp", "fused_mlp_bwd")}
    out = {}
    for kind, n in layers.items():
        fwd, bwd = names[kind]
        out[fwd] = 2 * n * TRAIN_ACCUM
        out[bwd] = n * TRAIN_ACCUM
    return out


def lm_train(torch) -> tuple:
    """llama3.2-1b's train step at full width and depth on the card: five
    AdamW steps on one repeated batch of the ported data pipeline — the
    main path, whose launches the caller reads just after.  Returns the
    result and ``rest``, for after that read: the last step again from
    its state (equal bits?), one step profiled, and the card against the
    CPU at a cut width."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(TRAIN_ARCH)
    return _train(torch, cfg, launches=_per_step(attn=cfg.num_layers),
                  classes=TRAIN_CLASSES[:2], cut=TRAIN_CPU_CUT)


def lm_train_streamed(torch) -> tuple:
    """``lm_train`` with ``mlp_impl="streamed"``: every layer's MLP through
    the fused-MLP kernel (twice a microbatch under remat) and its
    backward kernel."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(STREAMED_TRAIN_ARCH).with_(mlp_impl="streamed")
    n = cfg.num_layers
    return _train(torch, cfg, launches=_per_step(attn=n, mlp=n),
                  classes=TRAIN_CLASSES, cut=TRAIN_CPU_CUT)


def moe_train(torch) -> tuple:
    """granite-moe-1b-a400m's train step at full width and depth, as
    ``lm_train``'s; ``rest`` adds the share of (token, choice) pairs each
    MoE layer drops at the published capacity factor."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(MOE_TRAIN_ARCH)
    return _train(torch, cfg, launches=_per_step(attn=cfg.num_layers),
                  classes=TRAIN_CLASSES, cut=MOE_TRAIN_CPU_CUT)


def ssm_train(torch) -> tuple:
    """mamba2-1.3b's train step at full width and depth, as ``lm_train``'s,
    through the SSD kernel (saving its tile states) and its backward."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(SSM_TRAIN_ARCH)
    return _train(torch, cfg, launches=_per_step(ssd=cfg.num_layers),
                  classes=TRAIN_CLASSES, cut=SSM_TRAIN_CPU_CUT)


def encdec_train(torch) -> tuple:
    """seamless-m4t-medium's train step at full width and depth, as
    ``lm_train``'s, on the reference's train mapping: every encoder
    layer, every decoder self- and cross-attention through B2 (twice a
    microbatch under remat) and B2′."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(ENCDEC_TRAIN_ARCH)
    n = cfg.enc_layers + 2 * cfg.dec_layers
    cut = {**ENCDEC_CPU_DEPTH, **ENCDEC_TRAIN_CPU_WIDTH,
           "rows": TRAIN_CPU_ROWS, "frames": 256}
    return _train(torch, cfg, launches=_per_step(attn=n),
                  classes=TRAIN_CLASSES[:2], cut=cut)


def hybrid_train(torch) -> tuple:
    """Jamba's superblock at the width cut ``HYBRID_TRAIN_CUT`` (named in
    the result), as ``lm_train``'s: one attention layer through B2 / B2′,
    seven Mamba layers through B4 / B4′; ``rest`` adds the drops."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    cfg = get_config(HYBRID_ARCH).with_(**HYBRID_TRAIN_CUT)
    pat = lm.superblock_pattern(cfg)
    nsb = lm.num_superblocks(cfg)
    attn = nsb * sum(s.mixer == "attn" for s in pat)
    result, rest = _train(
        torch, cfg, launches=_per_step(attn=attn, ssd=cfg.num_layers - attn),
        classes=TRAIN_CLASSES, cut=HYBRID_TRAIN_CPU_CUT)
    result["cut"] = {**HYBRID_TRAIN_CUT,
                     "why": "the published superblock's training state "
                            "does not fit one card: tokens/s is not a "
                            "Jamba number"}
    return result, rest


def _train_batch(cfg, shape, seed: int, device) -> dict:
    """The train batch of ``cfg``'s family at ``shape``: the data
    pipeline's, or for the encoder–decoder the reference's train mapping —
    ``frames`` (B, S, D) seeded NumPy normals in ``param_dtype`` (as the
    pipeline makes stub embeddings) and ``tokens`` / ``labels`` (B, S / 4)
    of the pipeline's ``lm_batch``."""
    import numpy as np
    import torch

    from repro_torch.data import pipeline

    data = pipeline.DataConfig(seed=seed)
    if cfg.family != "encdec":
        return pipeline.batch_for_model(cfg, shape, data, 0, device=device)
    b, s = shape.global_batch, shape.seq_len
    toks = pipeline.lm_batch(dataclasses.replace(
        data, vocab_size=cfg.vocab_size, global_batch=b,
        seq_len=max(s // ENCDEC_DEC_FRAC, 16)), 0)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7, 0]))
    frames = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return {"frames": torch.from_numpy(frames).to(device).to(
                cfg.param_dtype),
            "tokens": torch.from_numpy(toks["tokens"].copy()).to(device),
            "labels": torch.from_numpy(toks["labels"].copy()).to(device)}


def _model_flops(cfg, params, batch) -> tuple:
    """(model FLOP of one step, the formula): 6·N·tokens with N the active
    parameters (``model_flops_per_token``); for the encoder–decoder 6 ×
    (encoder parameters × frames + decoder and head parameters ×
    targets), the embedding lookup not counted."""
    from repro_torch.configs.base import model_flops_per_token

    if cfg.family != "encdec":
        tokens = batch["labels"].numel()
        return (model_flops_per_token(cfg, training=True) * tokens,
                "6 · active parameters · tokens")
    size = lambda tree: sum(t.numel() for _, t in _flat(tree))
    frames = batch["frames"].shape[0] * batch["frames"].shape[1]
    targets = batch["labels"].numel()
    n_enc = size(params["encoder"])
    n_dec = size(params["decoder"]) + params["lm_head"].numel()
    return (6 * (n_enc * frames + n_dec * targets),
            "6 · (encoder parameters · frames + decoder and lm_head "
            "parameters · targets)")


def _train(torch, cfg, *, launches, classes, cut) -> tuple:
    """Five AdamW steps of ``cfg`` (full width and depth, random weights
    from a seed, remat on) on one repeated batch of ``_train_batch``,
    ``TRAIN_ROWS`` × train_4k's 4096 positions as ``TRAIN_ACCUM``
    microbatches: losses finite and falling, and per step exactly
    ``launches`` (kernel: count) and no launch of any other kernel.
    Returns the result and ``rest`` (the repeat, the profiled step, MoE
    drops, the card against the CPU at ``cut``), which the caller runs
    after reading the counts."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    torch.cuda.empty_cache()           # what the earlier phases left cached
    if (cfg.attn_impl, cfg.remat) != ("cuda", True):
        raise AssertionError(f"{cfg.name}: not the default train path")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_ROWS)
    t0 = time.perf_counter()
    batch = _train_batch(cfg, shape, 0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = steps.model_init(gen, cfg)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                total_steps=TRAIN_STEPS)
    state = adamw.init(params, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg, grad_accum=TRAIN_ACCUM)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for _, t in _flat(params)) / 1e9
    torch.cuda.reset_peak_memory_stats()

    start = _kernel_counts()
    losses, step_ms, per_step = [], [], None
    for _ in range(TRAIN_STEPS):
        c0 = _kernel_counts()
        before = (params, state)       # the last step's, for ``rest``
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if per_step is None:
            c1 = _kernel_counts()
            per_step = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        losses.append(float(m["loss"]))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: losses {losses}: not finite and "
                             "falling")
    if per_step != launches:
        raise AssertionError(f"{cfg.name}: launches a step {per_step}, want "
                             f"{launches} (remat: each layer's forward "
                             "twice; no other kernel)")
    end = _kernel_counts()
    if {k: end[k] - start[k] for k in end} != {
            k: TRAIN_STEPS * launches.get(k, 0) for k in end}:
        raise AssertionError(f"{cfg.name}: launches over the steps "
                             f"{end} from {start}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # positions a step: every token, or for the encoder-decoder every frame
    # and every target
    tokens = sum(batch[k].shape[0] * batch[k].shape[1]
                 for k in ("frames", "labels") if k in batch)
    warm_ms = sum(step_ms[1:]) / (len(step_ms) - 1)
    flops, formula = _model_flops(cfg, params, batch)
    result = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads],
        "mlp_impl": cfg.mlp_impl,
        "rows": TRAIN_ROWS, "seq": shape.seq_len, "grad_accum": TRAIN_ACCUM,
        "batch_shapes": {k: list(v.shape) for k, v in batch.items()},
        "steps": TRAIN_STEPS, "init_s": init_s, "weights_gb": weights_gb,
        "losses": losses, "step_ms": step_ms, "warm_step_ms": warm_ms,
        "tokens_per_s": tokens / (warm_ms / 1e3),
        "model_flop_share": flops / (warm_ms / 1e3)
        / TENSOR_CORE_BF16_OPS_PER_S,
        "model_flops_per_step": flops, "model_flop_formula": formula,
        "peak_mem_gb": peak_gb, "launches_per_step": per_step,
    }

    def rest() -> dict:
        nonlocal params, state, before, batch
        p2, s2, m2 = step(*before, batch)
        differ = [p for (p, a), (_, b) in zip(
            _flat({"params": params, "mu": state.mu, "nu": state.nu}),
            _flat({"params": p2, "mu": s2.mu, "nu": s2.nu}))
            if not torch.equal(a, b)]
        same_loss = bool(torch.equal(m["loss"], m2["loss"]))
        del p2, s2, before
        out = {}
        if cfg.moe is not None:
            out["dropped_share_per_layer"] = _train_drops(
                torch, cfg, params, batch)
            d = out["dropped_share_per_layer"]
            out["dropped_share"] = [min(d), sum(d) / len(d), max(d)]
        breakdown = _prefill_breakdown(
            torch, lambda: step(params, state, batch), reps=1,
            classes=classes)
        del params, state, batch
        torch.cuda.empty_cache()
        return {
            "step_repeats_bit_for_bit": same_loss and not differ,
            "leaves_that_differ": differ[:20], **out,
            "step_breakdown": breakdown,
            "card_vs_cpu": {dt: _train_card_vs_cpu(torch, cfg, dt, cut)
                            for dt in ("float32", "bfloat16")},
        }

    return result, rest


def _train_drops(torch, cfg, params, batch) -> list:
    """The share of (token, choice) pairs each MoE layer drops in one
    forward of the step's first microbatch."""
    from repro_torch.launch import steps
    from repro_torch.models import moe

    mb = steps._split_microbatches(batch, TRAIN_ACCUM)[0]
    with torch.no_grad(), _Calls(moe, "route", lambda a, k, out: float(
            (~out[3]).float().mean())) as rec:
        steps.model_loss(params, cfg, mb)
    return rec.calls


def _train_card_vs_cpu(torch, cfg, dtype: str, cut: dict) -> dict:
    """One train step of ``cfg`` cut to ``cut`` on the card and in the
    port's own CPU run, from the same NumPy parameters and batch: the loss,
    each gradient leaf's relative L2 error and the parameters after the
    step, held to ``TRAIN_CPU_RULE``.  With MoE layers the CPU replays the
    card's routing choices (``_ReplayingChoices``: the gates recomputed
    from its own logits, so the router's gradient flows on both)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cut = dict(cut)
    rows = cut.pop("rows", TRAIN_CPU_ROWS)
    seq = cut.pop("frames", TRAIN_CPU_SEQ)
    small = cfg.with_(dtype=dtype, **cut)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=rows)
    drawn = steps.model_init(torch.Generator().manual_seed(1),
                             small.with_(dtype="float32"))
    tree = adamw.tree_map(lambda t: t.numpy(), drawn)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    loss_rtol, l2_rule, p_tol = TRAIN_CPU_RULE[dtype]
    def grads(run_cfg, dev, routing, weights=tree):
        """(merged microbatch gradients on the CPU, the step's new
        parameters and metrics) of ``run_cfg`` on ``dev`` from
        ``weights`` under ``routing``."""
        params = lm.lm_params_from_numpy(weights, run_cfg, device=dev)
        batch = _train_batch(run_cfg, shape, 1, dev)
        with routing as rec:
            merged = {}
            for mb in steps._split_microbatches(batch, TRAIN_ACCUM):
                _, g = steps._value_and_grad(run_cfg, params, mb)
                for path, t in _flat(g):
                    merged[path] = merged.get(path, 0) + t.float().cpu()
            new_p, _, m = steps.make_train_step(
                run_cfg, opt_cfg, grad_accum=TRAIN_ACCUM)(
                    params, adamw.init(params, opt_cfg), batch)
        return rec, (float(m["loss"]), merged,
                     {p: t.float().cpu() for p, t in _flat(new_p)},
                     float(m["grad_norm"]), float(m["lr"]))

    moe = small.moe is not None
    rec, card = grads(small, "cuda",
                      _choices() if moe else contextlib.nullcontext())
    replay = (lambda: _ReplayingChoices(rec.calls)) if moe else \
        contextlib.nullcontext
    _, host = grads(small, "cpu", replay())
    (lc, gc, pc, nc, lr), (lh, gh, ph, nh, _) = card, host
    if not abs(lc - lh) <= loss_rtol * abs(lh):
        raise AssertionError(f"{dtype}: loss card {lc} vs cpu {lh}")
    rel = lambda got, want: float((got - want).norm()
                                  / max(float(want.norm()), 1e-30))
    l2 = {}
    for path, want in gh.items():
        got = gc[path]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{dtype}: gradient {path} not finite")
        l2[path] = rel(got, want)
    over = [p for p in l2 if l2[p] > l2_rule]
    far = {}
    if over and dtype == "bfloat16":
        # the truth both bf16 runs round away from: the CPU's f32 step on
        # the bf16 run's own (rounded) weights, the card's routing replayed
        rounded = adamw.tree_map(lambda t: t.float().numpy(),
                                 lm.lm_params_from_numpy(tree, small,
                                                         device="cpu"))
        _, (_, truth, *_) = grads(small.with_(dtype="float32"), "cpu",
                                  replay(), rounded)
        k, floor = BF16_GAP_RULE
        for p in over:
            gap = {"card": rel(gc[p], truth[p]), "cpu": rel(gh[p], truth[p])}
            far[p] = {**gap, "limit": k * gap["cpu"] + floor,
                      "card_vs_cpu": l2[p]}
    for p in over:
        f = far.get(p)
        if not (f and f["cpu"] > l2_rule / 2 and f["card"] <= f["limit"] < 1):
            raise AssertionError(f"{dtype}: gradient {p} relative L2 "
                                 f"{l2[p]} > {l2_rule}; against f32 {f}")
    p_err, held = 0.0, []
    clips = [min(1.0, opt_cfg.grad_clip / (n + 1e-9)) for n in (nc, nh)]
    for path, want in ph.items():
        diff = (pc[path] - want).abs()
        slack = adam_first_step_slack(gc[path] / TRAIN_ACCUM,
                                      gh[path] / TRAIN_ACCUM, lr=lr,
                                      clips=clips, eps=opt_cfg.eps)
        rule = p_tol + p_tol * want.abs()
        if not bool((diff <= rule + slack).all()):
            raise AssertionError(f"{dtype}: parameter {path} after the step "
                                 f"off by {float(diff.max())}")
        p_err = max(p_err, float(diff.max()))
        # the elements only the slack holds, with both runs' gradients
        held += [{"leaf": path, "diff": float(diff.flatten()[i]),
                  "grad_card": float(gc[path].flatten()[i]) / TRAIN_ACCUM,
                  "grad_cpu": float(gh[path].flatten()[i]) / TRAIN_ACCUM}
                 for i in torch.nonzero((diff > rule).flatten())[:, 0]]
    worst = max(l2, key=l2.get)
    return {"loss_card": lc, "loss_cpu": lh, "grad_rel_l2_max": l2[worst],
            "grad_rel_l2_worst_leaf": worst, "grad_rel_l2": l2,
            "param_max_abs_after_step": p_err,
            "params_held_by_adam_slack": held, "cut": cut,
            "routing_replayed": moe, "grads_held_against_f32": far,
            "rule": {"loss_rtol": loss_rtol, "grad_rel_l2": l2_rule,
                     "param_atol_rtol": p_tol,
                     "adam_slack_below": ADAM_SLACK_BELOW,
                     "bf16_gap_rule": BF16_GAP_RULE}}


#: a bf16 gradient leaf beyond the card-against-CPU rule may be held
#: against the truth both runs round away from — the CPU's f32 step on the
#: bf16 run's rounded weights — where bf16 rounding alone moves it more
#: than half the rule (two such runs then cannot be expected within the
#: rule of each other): the card's distance from that truth at most
#: ``k`` times the CPU's own plus ``floor``, the bf16 rule itself (a leaf
#: of 8 per-head elements scatters: the port's and the reference's
#: distances read 0.155 and 0.061 on one such leaf), each leaf against
#: itself, and that limit under 1 (a zero gradient reads 1).  Stacked
#: Mamba-2 layers need it: at the reference's init their gradients are
#: ill-conditioned — rounding only the weights to bf16, all arithmetic in
#: f32, moves mamba2's gradients 0.10 and Jamba's superblock's 0.18
#: (llama's 0.012) at 8 layers, and the bf16 gaps grow with depth, 0.025
#: / 0.056 / 0.135 at 2 / 4 / 8 Mamba layers (worst leaves,
#: ``scripts/bf16_conditioning.py``).  The hybrid's superblock cannot be
#: cut below 8
BF16_GAP_RULE = (2.0, 5e-2)
#: AdamW's first step moves an element by lr·u(c·g), u(v) = v/(|v|+eps);
#: where both runs' clipped gradients lie below this, within a few times
#: their f32 rounding on the cut (card and CPU lay 1.4e-7 to 6.3e-7 apart
#: at the elements PERF.md lists), the two steps may land anywhere in ±lr
#: of each other
ADAM_SLACK_BELOW = 1e-6


def adam_first_step_slack(g_a, g_b, *, lr: float, clips, eps: float):
    """How far AdamW's first step (zero moments: m̂ = c·g, v̂ = (c·g)²)
    may move an element apart in two runs whose gradients for it are
    ``g_a`` and ``g_b``, clipped by ``clips`` = (c_a, c_b): lr·|u(c_a·g_a)
    − u(c_b·g_b)| with u(v) = v / (|v| + eps) where both |c·g| lie below
    ``ADAM_SLACK_BELOW``, and 0 everywhere else."""
    va, vb = (c * g for g, c in zip((g_a, g_b), clips))
    tiny = (va.abs() < ADAM_SLACK_BELOW) & (vb.abs() < ADAM_SLACK_BELOW)
    step = lr * (va / (va.abs() + eps) - vb / (vb.abs() + eps)).abs()
    return step * tiny


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# int8-weight serving and crash-restart training
# ---------------------------------------------------------------------------

#: the int8 servers: ``lm_serve``'s first model and nemotron-4-15b, with
#: its batch, prompts and new tokens, ``ServeEngine(int8_weights=True)``
#: beside a bf16 engine on the same seeded weights; the card's
#: quantization against the CPU's on the first alone (at nemotron's size
#: the sample would copy gigabytes to the host)
INT8_ARCHS = (LM_MODELS[0], "nemotron-4-15b")
#: per-call dequantize timing: warm calls, each synchronised
INT8_DEQ_REPS = 5


def _tree_nbytes(tree) -> int:
    """Bytes of every tensor in a tree (a ``QTensor``: its q and scale)."""
    from repro_torch.tree import tree_flatten_with_path

    return sum(t.numel() * t.element_size()
               for _, t in tree_flatten_with_path(tree))


def qtensor_mismatches(a, b) -> list:
    """Paths where two quantized trees differ in any bit of ``q`` or
    ``scale`` (or of a leaf left unquantized), ``b`` moved to ``a``'s
    device."""
    from repro_torch.tree import tree_flatten_with_path

    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return ["structure"]
    import torch

    return [p for (p, x), (_, y) in zip(fa, fb)
            if x.dtype != y.dtype or not torch.equal(x, y.to(x.device))]


def quantized_mismatches(qtree, params, path: str = "") -> list:
    """The paths ``qtensor_mismatches(qtree, quantize_params(params))``
    names, each leaf of ``params`` quantized alone and dropped before the
    next: the whole quantized copy of nemotron-4-15b is another 15.6 GB."""
    from repro_torch.quant import quantize_params

    if isinstance(params, dict):
        if not isinstance(qtree, dict) or set(qtree) != set(params):
            return [f"{path} structure"]
        return [p for k in sorted(params)
                for p in quantized_mismatches(qtree[k], params[k],
                                              f"{path}[{k!r}]")]
    return [path + p for p in qtensor_mismatches(qtree,
                                                 quantize_params(params))]


def int8_serve(torch, read, arch: str, cpu_check: bool) -> dict:
    """``arch`` at full width and depth served with int8 weights: the int8
    engine against a bf16 engine handed the dequantized weights (bit for
    bit), its quantization against ``quantize_params`` of the same weights
    drawn again and, with ``cpu_check``, the card's quantization against
    the CPU's on the same tensors; and its bytes, times and greedy
    agreement beside a bf16 engine on the original weights, in this run.
    ``read()`` returns the path's launch count: it is called after the
    int8 engine's own calls, before the bf16 engines it is compared with
    run.  At most the int8 weights and one bf16 copy are held at a time."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.tree import tree_flatten_with_path, tree_map
    from repro_torch.quant import dequantize_params, quantize_params

    torch.cuda.empty_cache()
    t_arch = time.perf_counter()
    cfg = get_config(arch)
    max_len = LM_PROMPT + LM_NEW
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)

    # the int8 engine alone on the card: construction, memory, generate
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q8 = ServeEngine(cfg, max_len=max_len, seed=0, int8_weights=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    held_gb = (torch.cuda.memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    before = fa.launches
    logits8, _ = q8.prefill(prompts)
    per_prefill = fa.launches - before
    if per_prefill != cfg.num_layers:
        raise AssertionError(f"{arch} int8 prefill: {per_prefill} flash "
                             f"launches, want {cfg.num_layers} (one per "
                             "layer)")
    out8, cold8 = q8.generate(prompts, max_new=LM_NEW)
    out8b, warm8 = q8.generate(prompts, max_new=LM_NEW)
    if not np.array_equal(out8, out8b):
        raise AssertionError(f"{arch}: int8 greedy generate not repeatable")
    peak8_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    prefill8_ms = _prefill_ms(torch, q8, prompts)
    launches = read()                  # the int8 path's own: read after

    # the transient bf16 copy each call writes
    deq_ms = []
    for _ in range(INT8_DEQ_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = dequantize_params(q8.params, cfg.param_dtype)
        torch.cuda.synchronize()
        deq_ms.append((time.perf_counter() - t0) * 1e3)
        del d
    deq_ms = deq_ms[1:]

    # 1. a bf16 engine handed the dequantized weights: the same bits
    deq = ServeEngine(cfg, max_len=max_len,
                      params=dequantize_params(q8.params, cfg.param_dtype))
    logits_d, _ = deq.prefill(prompts)
    out_d, _ = deq.generate(prompts, max_new=LM_NEW)
    same_logits = bool(torch.equal(logits8, logits_d))
    if not same_logits or not np.array_equal(out8, out_d):
        raise AssertionError(
            f"{arch}: int8 engine vs bf16 engine on the dequantized "
            f"weights: logits equal {same_logits}, tokens equal "
            f"{np.array_equal(out8, out_d)}")
    if tuple(logits8.shape) != (LM_BATCH, cfg.vocab_size) or not bool(
            torch.isfinite(logits8).all()):
        raise AssertionError(f"{arch}: int8 logits not finite of the "
                             "expected shape")
    del deq, logits_d
    torch.cuda.empty_cache()

    # 2. the weights it quantized: the same generator, drawn again
    params = steps.model_init(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
    engine_vs_direct = quantized_mismatches(q8.params, params)
    card_vs_cpu = card_q = None
    if cpu_check:
        # 3. the card's quantization against the CPU's on the same
        # tensors: one superblock (each stacked leaf's first layer, its
        # layer axis kept) and the embedding
        sample = {"blocks": tree_map(lambda t: t[0:1], params["blocks"]),
                  "embed": params["embed"]}
        card_q = quantize_params(sample)
        card_vs_cpu = qtensor_mismatches(
            quantize_params(_tree_to(sample, "cpu")), card_q)
    if engine_vs_direct or card_vs_cpu:
        raise AssertionError(
            f"{arch} quantization bits: engine vs direct "
            f"{engine_vs_direct[:5]}, card vs CPU {(card_vs_cpu or [])[:5]}")

    # 4. beside the bf16 engine on the original weights, in this run
    fp = ServeEngine(cfg, max_len=max_len, params=params)
    logits_fp, _ = fp.prefill(prompts)
    out_fp, cold_fp = fp.generate(prompts, max_new=LM_NEW)
    _, warm_fp = fp.generate(prompts, max_new=LM_NEW)
    prefill_fp_ms = _prefill_ms(torch, fp, prompts)
    gap = float((logits8 - logits_fp).abs().max())
    result = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
        "init_s": init_s, "init_peak_gb": init_peak_gb,
        "weight_gb": {"int8_with_scales": _tree_nbytes(q8.params) / 1e9,
                      "bf16": _tree_nbytes(params) / 1e9},
        "int8_held_gb": held_gb, "int8_peak_gb": peak8_gb,
        "int8": {"cold": dataclasses.asdict(cold8),
                 "warm": dataclasses.asdict(warm8),
                 "prefill_ms": prefill8_ms},
        "bf16": {"cold": dataclasses.asdict(cold_fp),
                 "warm": dataclasses.asdict(warm_fp),
                 "prefill_ms": prefill_fp_ms},
        "dequantize_ms_per_call": sum(deq_ms) / len(deq_ms),
        "dequantize_ms_each": deq_ms,
        "flash_launches_per_prefill": per_prefill,
        "launches": {"flash_attention": launches},
        "engine_vs_direct_quantization": {
            "tensors": len(tree_flatten_with_path(q8.params)),
            "mismatches": engine_vs_direct},
        "card_vs_cpu_quantization": None if card_q is None else {
            "tensors": len(tree_flatten_with_path(card_q)),
            "mismatches": card_vs_cpu},
        "int8_equals_dequantized_bf16_engine": True,
        "greedy_agreement_vs_bf16_weights": float((out8 == out_fp).mean()),
        "first_token_agreement_vs_bf16_weights": float(
            (out8[:, 0] == out_fp[:, 0]).mean()),
        "logits_max_abs_vs_bf16_weights": gap,
        "logits_max_abs": float(logits_fp.abs().max()),
        "seconds": time.perf_counter() - t_arch,
    }
    del q8, fp, params, logits8, logits_fp
    torch.cuda.empty_cache()
    return result


#: crash-restart training: qwen2-0.5b at full width (d_model 896, tied
#: 151936-token embedding) — the model of the reference's restart tests —
#: through ``launch.train.train``, cut to ``RESILIENT_LAYERS`` of its 24
#: layers: its checks hold at any depth, and ``mesh_train`` runs the same
#: run at full depth (crash and restart bit for bit, the 4.9 GB
#: checkpoint saved, restored across the mesh and ``mesh=None``, timed)
RESILIENT_ARCH = "qwen2-0.5b"
RESILIENT_LAYERS = 6
RESILIENT_RUN = {"batch": 4, "seq": 1024, "steps": 8, "ckpt_every": 4,
                 "lr": 1e-3, "seed": 3}
RESILIENT_FAIL_AT = (6,)
#: the third run, on the crash run's directory: only the new steps run
RESILIENT_MORE_STEPS = 10
RESILIENT_DIR = os.path.join(ROOT, "build", "train_resilient")
#: checkpoints on disk at once (the crash run keeps steps 4, 8 and, after
#: the third run, 10; the timed save writes one more) and the room kept
#: beside them
RESILIENT_CKPTS_ON_DISK = 4
RESILIENT_DISK_MARGIN = 2e9


def need_free_disk(path: str, need_bytes: float) -> int:
    """Free bytes on the file system of ``path`` (made if missing);
    raises, naming both numbers, if fewer than ``need_bytes``."""
    import shutil

    os.makedirs(path, exist_ok=True)
    free = shutil.disk_usage(path).free
    if free < need_bytes:
        raise RuntimeError(
            f"{path}: {free / 1e9:.2f} GB free, the checkpoints need "
            f"{need_bytes / 1e9:.2f} GB")
    return free


def restart_replays(clean: list, crashed: list, *, fail_at: int,
                    restored_from: int) -> bool:
    """Whether a run that crashed before step ``fail_at`` and restarted
    from step ``restored_from`` logged the clean run's losses, bit for bit:
    the steps before the crash, then the replayed steps again, then the
    rest."""
    replayed = fail_at - restored_from
    return (crashed[:fail_at] == clean[:fail_at]
            and crashed[fail_at:fail_at + replayed]
            == clean[restored_from:fail_at]
            and crashed[fail_at + replayed:] == clean[fail_at:]
            and len(crashed) == len(clean) + replayed)


@contextlib.contextmanager
def config_cut(arch: str, **cut):
    """``arch``'s registered config cut by ``cut`` (``with_``) for the
    block: ``launch.train.train`` resolves its config by name, as
    ``examples/train_lm_torch.py`` has its own resolved."""
    import importlib

    from repro_torch.configs import registry

    mod = importlib.import_module(f"repro_torch.configs.{registry.ARCHS[arch]}")
    full = mod.CONFIG
    mod.CONFIG = full.with_(**cut)
    try:
        yield mod.CONFIG
    finally:
        mod.CONFIG = full


def train_resilient(torch, read) -> dict:
    """qwen2-0.5b at full width and ``RESILIENT_LAYERS`` layers trained
    through ``launch.train.train``: a clean run and a run crashed at step
    6 (restarted from its step-4 checkpoint) log the same losses bit for
    bit; a third call on the crashed run's directory runs only the new
    steps; the step-8 checkpoint restores onto the card and the CPU equal
    to an uninterrupted hand-driven run's state.  Timed: checkpoint save
    (snapshot, write) and restore.  ``read()`` returns the path's launch
    counts: it is called after the three ``train`` calls, before the
    hand-driven run."""
    with config_cut(RESILIENT_ARCH, num_layers=RESILIENT_LAYERS):
        return _restart_run(torch, read)


def _restart_run(torch, read) -> dict:
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_flatten_with_path as flatten

    torch.cuda.empty_cache()
    cfg = get_config(RESILIENT_ARCH)
    run = dict(RESILIENT_RUN)
    steps, every = run["steps"], run["ckpt_every"]
    fail_at = RESILIENT_FAIL_AT[0]
    hand = T.build_run(cfg=cfg, steps=steps, batch=run["batch"],
                       seq=run["seq"], ckpt_dir=None, lr=run["lr"],
                       seed=run["seed"])
    tmpl = hand.state_template()
    ckpt_bytes = _tree_nbytes(tmpl)
    shutil.rmtree(RESILIENT_DIR, ignore_errors=True)
    free = need_free_disk(RESILIENT_DIR, RESILIENT_CKPTS_ON_DISK * ckpt_bytes
                          + RESILIENT_DISK_MARGIN)
    clean_dir = os.path.join(RESILIENT_DIR, "clean")
    crash_dir = os.path.join(RESILIENT_DIR, "crash")
    common = dict(arch=RESILIENT_ARCH, smoke=False, log_every=0, **run)
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    t0 = time.perf_counter()
    clean = T.train(ckpt_dir=clean_dir, **common)
    walls["clean"] = time.perf_counter() - t0
    shutil.rmtree(clean_dir)
    t0 = time.perf_counter()
    crash = T.train(ckpt_dir=crash_dir, fail_at=RESILIENT_FAIL_AT, **common)
    walls["crash"] = time.perf_counter() - t0
    lc, lk = clean["losses"], crash["losses"]
    restored_from = fail_at - fail_at % every
    if clean["final_step"] != steps or crash["final_step"] != steps or \
            not restart_replays(lc, lk, fail_at=fail_at,
                                restored_from=restored_from):
        raise AssertionError(f"clean {clean['final_step']} {lc} against "
                             f"crashed {crash['final_step']} {lk}")
    if not all(math.isfinite(x) for x in lc):
        raise AssertionError(f"losses {lc} not finite")

    # the third call on the crash run's directory: only steps 8 and 9
    t0 = time.perf_counter()
    more = T.train(ckpt_dir=crash_dir,
                   **dict(common, steps=RESILIENT_MORE_STEPS))
    walls["more"] = time.perf_counter() - t0
    if more["final_step"] != RESILIENT_MORE_STEPS or \
            len(more["losses"]) != RESILIENT_MORE_STEPS - steps:
        raise AssertionError(f"resumed run: final step {more['final_step']}"
                             f", {len(more['losses'])} steps run")
    launches = read()                  # the three train calls': read after

    # the live state: the same run driven by hand, uninterrupted
    _, state = hand.fresh_state()
    hand_losses = []
    for i in range(steps):
        state, m = hand.run_step(i, state)
        hand_losses.append(float(m["loss"]))
    if hand_losses != lc:
        raise AssertionError(f"hand-driven losses {hand_losses} != {lc}")
    live = {"params": state[0], "opt": state[1]}
    live_flat = flatten(live)
    mgr = CheckpointManager(crash_dir)
    restores = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, extra = mgr.restore(steps, tmpl, device=dev)
        torch.cuda.synchronize()
        restores[dev] = time.perf_counter() - t0
        differ = qtensor_mismatches(tree, live)
        if differ or extra != {"step": steps}:
            raise AssertionError(f"step-{steps} checkpoint restored on {dev} "
                                 f"differs from the live state: {differ[:5]}")
        del tree
    moments = ("['opt'].mu", "['opt'].nu")
    kinds = {"params": sorted({str(t.dtype) for p, t in live_flat
                               if p.startswith("['params']")}),
             "moments": sorted({str(t.dtype) for p, t in live_flat
                                if p.startswith(moments)}),
             "step": [str(state[1].step.dtype), state[1].step.ndim]}
    if kinds != {"params": ["torch.bfloat16"], "moments": ["torch.float32"],
                 "step": ["torch.int32", 0]}:
        raise AssertionError(f"the state's dtypes {kinds}")

    # a save of the live state, timed as train's checkpoints are made
    timed_dir = os.path.join(RESILIENT_DIR, "timed")
    saver = CheckpointManager(timed_dir, keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saver.save_async(steps, live, extra={"step": steps})
    snapshot_s = time.perf_counter() - t0
    saver.wait()
    write_s = time.perf_counter() - t0 - snapshot_s
    shutil.rmtree(timed_dir)
    del live, live_flat, state, m
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shutil.rmtree(RESILIENT_DIR)
    gb = ckpt_bytes / 1e9
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, **run, "fail_at": list(RESILIENT_FAIL_AT),
        "losses_clean": lc, "losses_crash": lk, "losses_more": more["losses"],
        "crash_equals_clean_bit_for_bit": True,
        "restored_equals_live": ["cuda", "cpu"], "leaf_dtypes": kinds,
        "checkpoint_gb": gb, "checkpoint_leaves": len(flatten(tmpl)),
        "free_disk_gb": free / 1e9,
        "save_snapshot_s": snapshot_s, "save_write_s": write_s,
        "save_write_gb_per_s": gb / write_s,
        "snapshot_gb_per_s": gb / snapshot_s,
        "restore_s": restores,
        "restore_gb_per_s": {k: gb / v for k, v in restores.items()},
        "median_step_ms": {"clean": clean["median_step_s"] * 1e3,
                           "crash": crash["median_step_s"] * 1e3,
                           "more": more["median_step_s"] * 1e3},
        "tokens_per_s": run["batch"] * run["seq"] / clean["median_step_s"],
        "stragglers_flagged": {"clean": clean["straggler_flags"],
                               "crash": crash["straggler_flags"],
                               "more": more["straggler_flags"]},
        "run_wall_s": walls, "peak_mem_gb": peak_gb,
        "launches": launches,
    }


#: training on a device mesh: ``train_resilient``'s model and run on the
#: 1 × 1 mesh, then with ``mesh=None`` (two crashed runs; each keeps its
#: step-4 and step-8 checkpoints; the timed save writes one more)
MESH_TRAIN_DIR = os.path.join(ROOT, "build", "mesh_train")
MESH_TRAIN_CKPTS_ON_DISK = 5
#: the two-card runs ((2, 1) and (1, 2)): steps, and the bf16 train
#: rule's loss rtol
MESH_TRAIN_TWO_CARD_STEPS = 2
MESH_TRAIN_TWO_CARD_RTOL = TRAIN_CPU_RULE["bfloat16"][0]
#: the (1, 2) run of a smoke config (mamba2-1.3b's: its mixer on 4 of 8
#: heads a rank)
MESH_TRAIN_TWO_CARD_SMOKE = {"batch": 4, "seq": 32, "lr": 1e-3, "seed": 3}

#: what a rank of the two-card run executes (under torchrun): NCCL on the
#: cards, gloo on the CPU
_TWO_CARD_RANK = """
import json, os, sys
import torch, torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_host_mesh
if {device!r} == "cuda":
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
else:
    torch.set_num_threads(1)
dist.init_process_group("nccl" if {device!r} == "cuda" else "gloo")
out = T.train(mesh=make_host_mesh({shape!r}, ("data", "model")),
              ckpt_dir=None, device={device!r}, **{kw!r})
if dist.get_rank() == 0:
    with open({path!r}, "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
"""


class _RankView:
    """Rank ``rank``'s view of a ``data`` × ``model`` mesh of ``shape``,
    with no process behind it: the shape and coordinate that
    ``steps.batch_rows`` reads."""

    axis_names = ("data", "model")

    def __init__(self, shape: tuple, rank: int) -> None:
        self.shape = dict(zip(self.axis_names, shape))
        self._rank = rank

    def coordinate(self) -> dict:
        return dict(zip(self.axis_names, divmod(self._rank,
                                                self.shape["model"])))


def two_card_rows(batch: int, shape: tuple = (2, 1)) -> list:
    """The global batch of a two-rank run on a mesh of ``shape`` as the
    spans its ranks of distinct data index draw (``steps.batch_rows`` of
    each), the first data index's first."""
    from repro_torch.launch import steps as ST

    return [span for index in range(shape[0])
            for span in ST.batch_rows(_RankView(shape, index * shape[1]),
                                      batch)]


def two_card_run(torch, run: dict, *, shape: tuple = (2, 1),
                 arch: str = RESILIENT_ARCH, smoke: bool = False,
                 device: str = "cuda", out_dir: str = MESH_TRAIN_DIR) -> dict:
    """Two steps of ``arch`` on a mesh of ``shape`` — (2, 1): each rank
    half the rows; (1, 2): each rank every row on its half of the heads,
    ``d_ff``, experts and vocabulary — of two ranks spawned by torchrun
    (NCCL on two cards, gloo with ``device="cpu"``) against the same
    steps on the 1 × 1 mesh of ``device``, on the global batch the two
    ranks draw (the bf16 train rule on the losses)."""
    import json

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import single_device_mesh

    steps = MESH_TRAIN_TWO_CARD_STEPS
    name = "x".join(map(str, shape))
    kw = dict(arch=arch, smoke=smoke, log_every=0,
              **dict(run, steps=steps, ckpt_every=steps))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"two_card_{name}.json")
    script = os.path.join(out_dir, f"two_card_{name}_rank.py")
    with open(script, "w") as f:
        f.write(_TWO_CARD_RANK.format(src=os.path.join(ROOT, "src"), kw=kw,
                                      shape=tuple(shape), device=device,
                                      path=path))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2", script],
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"two-card {name} run failed ({r.returncode}): "
                           f"{r.stderr[-3000:]}")
    with open(path) as f:
        two = json.load(f)
    one = T.build_run(cfg=get_config(arch, smoke=smoke), steps=steps,
                      batch=run["batch"], seq=run["seq"], ckpt_dir=None,
                      lr=run["lr"], seed=run["seed"], device=device,
                      mesh=single_device_mesh(device))
    _, (params, opt_state) = one.fresh_state()
    losses = []
    for i in range(steps):
        batch = one.rows_at(i, two_card_rows(run["batch"], shape))
        params, opt_state, m = one.step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
    worst = max(abs(a - b) / abs(b) for a, b in zip(two["losses"], losses))
    if worst > MESH_TRAIN_TWO_CARD_RTOL:
        raise AssertionError(f"({shape[0]}, {shape[1]}) losses "
                             f"{two['losses']} against the 1 x 1 mesh's "
                             f"{losses}")
    return {f"losses_{name}": two["losses"], "losses_1x1": losses,
            "loss_rel_gap": worst, "rule_rtol": MESH_TRAIN_TWO_CARD_RTOL,
            f"median_step_ms_{name}": two["median_step_s"] * 1e3,
            "wall_s": wall}


#: the split train step at full width and depth on the 1 × 1 mesh beside
#: ``mesh=None``, in the same process: (arch, config overrides).
#: llama3.2-1b's vocabulary-parallel CE at V 128256 (with the streamed
#: MLP, so that B3 and B3′ run on the split path too), granite-moe's
#: experts and the router's partial gradient, mamba2-1.3b's mixer split
#: by heads (B4, B4′), seamless-m4t-medium's per-layer gathers
MESH_SPLIT_CONFIGS = (("llama3.2-1b", {"mlp_impl": "streamed"}),
                      ("granite-moe-1b-a400m", {}),
                      ("mamba2-1.3b", {}),
                      ("seamless-m4t-medium", {}))
#: rows, positions (the encoder–decoder's frames and targets each), steps
MESH_SPLIT_ROWS, MESH_SPLIT_SEQ, MESH_SPLIT_STEPS = 4, 1024, 2
#: B2′ and B3′ at one rank's shard of a ``model`` axis of 4: llama3.2-1b's
#: train shape (B, Hq, Hkv, S, D) with its 32 / 8 heads cut to 8 / 2, and
#: qwen2-0.5b's MLP (M, D, F) with ``d_ff`` 4864 cut to 1216
MESH_SPLIT_B2_SHARD = ("llama3.2-1b.train.tp4", 4, 8, 2, 4096, 64)
MESH_SPLIT_B3_SHARD = ("qwen2-0.5b.train.tp4", 4096, 896, 1216)


def _train_kernels() -> dict:
    """The modules of the kernels a train path launches, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import mamba2_ssd as ms

    return {"flash_attention": fa, "mamba2_ssd": ms, "fused_mlp": fm}


def _reset_path_counts() -> None:
    for mod in _train_kernels().values():
        mod.reset_counts()


def _read_path_counts(path: str, need: set) -> dict:
    """Each kernel's forward and backward launches since the last
    ``_reset_path_counts``; fails if a kernel named in ``need`` never
    launched, either way, or any plain version ran on a CUDA tensor."""
    out = {}
    for name, mod in _train_kernels().items():
        if mod.plain_cuda_calls or mod.bwd_plain_cuda_calls:
            raise AssertionError(f"{name}'s plain versions ran on a CUDA "
                                 f"tensor on the {path} path")
        if name in need and (mod.launches < 1 or mod.bwd_launches < 1):
            raise AssertionError(f"the {path} path launched {name} "
                                 f"{mod.launches} and its backward "
                                 f"{mod.bwd_launches} time(s)")
        out[name], out[name + "_bwd"] = mod.launches, mod.bwd_launches
    return out


def _split_batch(torch, cfg, step: int, rows: int, seq: int,
                 device: str) -> dict:
    """Step ``step``'s batch of ``rows`` × ``seq`` positions, drawn on
    ``device`` from one seed (frames for the encoder–decoder)."""
    gen = torch.Generator(device=device).manual_seed(1000 + step)
    shape = (rows, seq)
    b = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device=device, dtype=torch.int32),
         "labels": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device=device, dtype=torch.int32)}
    if cfg.family == "encdec":
        b["frames"] = torch.randn(shape + (cfg.d_model,), generator=gen,
                                  device=device).to(cfg.param_dtype)
    return b


def mesh_split_step(torch, arch: str, kw: dict, mesh, *,
                    smoke: bool = False, device: str = "cuda",
                    rows: int = MESH_SPLIT_ROWS,
                    seq: int = MESH_SPLIT_SEQ) -> dict:
    """``arch`` (at full width and depth unless ``smoke``):
    ``MESH_SPLIT_STEPS`` steps of the split train step on the 1 × 1 mesh,
    then of ``make_train_step`` with ``mesh=None``, from the same seeded
    params on the same batches — the losses and every leaf of the params
    and moments after them bit for bit; each path's kernel launches
    (counts zeroed before it, read right after it; on the card), peak GB,
    and a warm step of each in turns (none, mesh, mesh, none)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_flatten_with_path as flatten
    from repro_torch.tree import tree_map

    card = device == "cuda"
    cfg = get_config(arch, smoke=smoke).with_(**kw)
    need = {"flash_attention"} if cfg.family != "ssm" else set()
    if cfg.family == "ssm":
        need.add("mamba2_ssd")
    if cfg.mlp_impl == "streamed":
        need.add("fused_mlp")
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    params = ST.model_init(torch.Generator(device=device).manual_seed(0),
                           cfg)
    p_shard = shd.make_param_shardings(mesh, params, cfg)
    opt = adamw.init(params, opt_cfg)
    shardings = {"params": p_shard,
                 "opt": shd.make_opt_shardings(mesh, opt, p_shard)}
    state = {
        "mesh": (shd.distribute_tree(tree_map(torch.clone, params), p_shard),
                 shd.distribute_tree(adamw.init(params, opt_cfg),
                                     shardings["opt"])),
        "none": (params, opt)}
    del params, opt
    fns = {"mesh": ST.make_sharded_train_step(
               cfg, opt_cfg, mesh, global_batch=rows),
           "none": ST.make_train_step(cfg, opt_cfg)}
    batches = [_split_batch(torch, cfg, i, rows, seq, device)
               for i in range(MESH_SPLIT_STEPS)]
    losses, launches, peak_gb = {}, {}, {}
    for name in ("mesh", "none"):
        if card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset_path_counts()      # counts: zero before this path
        p, o = state.pop(name)      # the steps free what they replace
        losses[name] = []
        for b in batches:
            p, o, m = fns[name](p, o, b)
            losses[name].append(float(m["loss"]))
        if card:
            launches[name] = _read_path_counts(              # read after
                f"{arch} split-step {name}", need)
            peak_gb[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
        state[name] = (p, o)
    flat_m = flatten({"params": state["mesh"][0], "opt": state["mesh"][1]})
    flat_n = flatten({"params": state["none"][0], "opt": state["none"][1]})
    flat_s = flatten(shardings)
    differ = [p for (p, a), (q, b), (_, sh) in zip(flat_m, flat_n, flat_s)
              if p != q or not torch.equal(shd.whole(a, sh), b)]
    if losses["mesh"] != losses["none"] or differ or not all(
            math.isfinite(x) for x in losses["mesh"]):
        raise AssertionError(f"{arch}: the 1 x 1 split step against "
                             f"mesh=None: losses {losses}, leaves that "
                             f"differ {differ[:5]}")
    del flat_m, flat_n

    def once_ms(name):
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[name](*state[name], batches[0])
        if card:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    turns = {"none": [], "mesh": []}
    for name in ("none", "mesh", "mesh", "none"):
        turns[name].append(once_ms(name))
    del state, batches
    if card:
        torch.cuda.empty_cache()
    return {"arch": arch, "overrides": kw, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "rows": rows, "seq": seq,
            "steps": MESH_SPLIT_STEPS, "losses": losses["mesh"],
            "mesh_equals_none_bit_for_bit": True,
            "launches": launches, "peak_mem_gb": peak_gb,
            "step_ms_in_turns": turns}


def bwd_on_a_shard(torch) -> dict:
    """B2′ and B3′ as a rank of ``model`` = 4 calls them in training
    (``MESH_SPLIT_B2_SHARD``, ``MESH_SPLIT_B3_SHARD``), bf16, each against
    its plain version by the bf16 rules of ``attn_bwd_check`` and
    ``mlp_bwd_check``, each timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    name, b, hq, hkv, s, d = MESH_SPLIT_B2_SHARD
    bf = torch.bfloat16
    q = (torch.randn(b * hq, s, d, generator=gen) * d ** -0.5).to(bf).cuda()
    k, v = (torch.randn(b * hkv, s, d, generator=gen).to(bf).cuda()
            for _ in range(2))
    dout = torch.randn(b * hq, s, d, generator=gen).to(bf).cuda()
    kw = dict(heads_q=hq, heads_kv=hkv, causal=True, q_offset=0)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    bkw = dict(kw, scale=d ** -0.5)
    run = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,  # noqa
                                         **bkw)
    got = run()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **bkw)
    err = max(_grad_close(g_, w_, "bfloat16", f"{name} {nm}")
              for g_, w_, nm in zip(got, want, ("dq", "dk", "dv")))
    b2 = {"shape": name, "q": [b, hq, s, d], "kv": [b, hkv, s, d],
          "route": fa.bwd_plan(q, k, v, dout, heads_q=hq,
                               heads_kv=hkv).route,
          "max_abs_err": err,
          "row_need": {nm: _row_need(g_, w_) for g_, w_, nm in
                       zip(got, want, ("dq", "dk", "dv"))},
          "ms": time_ms(run, warmup=1, reps=5)}
    del q, k, v, dout, out, lse, got, want
    name, m, d, f = MESH_SPLIT_B3_SHARD
    inputs = (torch.randn(m, d, generator=gen).to(bf).cuda(),
              (torch.randn(d, f, generator=gen) * d ** -0.5).to(bf).cuda(),
              (torch.randn(d, f, generator=gen) * d ** -0.5).to(bf).cuda(),
              (torch.randn(f, d, generator=gen) * f ** -0.5).to(bf).cuda(),
              torch.randn(m, d, generator=gen).to(bf).cuda())
    run = lambda: fm.fused_mlp_bwd(*inputs, act="silu")  # noqa: E731
    got = run()
    want = fm.fused_mlp_bwd_plain(*inputs, act="silu")
    b3 = {"shape": name, "m": m, "d": d, "f_shard": f,
          "route": fm.bwd_plan(*inputs).route,
          **_mlp_bwd_close(got, want, "bfloat16", name),
          "ms": time_ms(run, warmup=1, reps=5)}
    del inputs, got, want
    torch.cuda.empty_cache()
    return {"b2_bwd": b2, "b3_bwd": b3}


#: B4 and B4′ as a rank of ``model`` = tp calls them on mamba2-1.3b's 64
#: heads: tp, and the (B, L, chunk) of the prefill and of the train
#: microbatch, as ``ssd_check``'s and ``ssd_bwd_check``'s rows have them
MESH_SPLIT_SSD_TP = (2, 16)
MESH_SPLIT_SSD_PREFILL = (LM_BATCH, LM_PROMPT, 64)
MESH_SPLIT_SSD_TRAIN = (4, 4096, 64)


def ssd_on_a_shard(torch) -> list:
    """B4 at mamba2-1.3b's prefill shape and B4′ at its train microbatch,
    each on the H/tp heads a rank of ``model`` = tp computes
    (``MESH_SPLIT_SSD_TP``), bf16, against their plain versions by the
    rules of ``ssd_check`` and ``ssd_bwd_check`` (B4′'s db and dc are the
    rank's sums over its own heads, which the split's backward then sums
    over the ranks), each timed beside its plain version and its bound."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import mamba2_ssd as ms

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(SSM_ARCH)
    s = cfg.ssm
    heads, p, n = s.num_heads(cfg.d_model), s.head_dim, s.state_dim
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    rows = []
    for tp in MESH_SPLIT_SSD_TP:
        h = heads // tp
        b, l, chunk = MESH_SPLIT_SSD_PREFILL
        x, dt, a, bm, cm = _ssd_inputs(torch, gen, b, l, h, p, n)
        x, bm, cm = (v.to(bf).cuda() for v in (x, bm, cm))
        dt, a = dt.cuda(), a.cuda()
        s0 = torch.zeros(b, h, p, n, device="cuda")
        run = lambda: ms.mamba2_ssd(x, dt, a, bm, cm, s0,  # noqa: E731
                                    chunk=chunk)
        plain = lambda: ms.mamba2_ssd_plain(x, dt, a, bm,  # noqa: E731
                                            cm, s0, chunk=chunk)
        (y, sf), (ye, se) = run(), plain()
        name = f"{SSM_ARCH}.prefill.tp{tp}"
        err = max(_close(y, ye, SSD_TOL["bfloat16"], f"{name} y"),
                  _close(sf, se, SSD_TOL["float32"], f"{name} state"))
        work = ssd_work(b, l, h, p, n, bf)
        fwd = {"shape": name, "b": b, "l": l, "h": h, "p": p, "n": n,
               "max_abs_err": err, "tol": SSD_TOL["bfloat16"],
               "ms": time_ms(run, warmup=2, reps=20),
               "plain_ms": time_ms(plain, warmup=1, reps=5),
               "bound_ms": work.bound_ms(), "bound_by": work.bound_by()}
        del x, dt, a, bm, cm, s0, y, sf, ye, se
        b, l, chunk = MESH_SPLIT_SSD_TRAIN
        name = f"{SSM_ARCH}.train.tp{tp}"
        inputs = _ssd_bwd_inputs(torch, gen, bf, b, l, h, p, n, model=True)
        row, run, plain, got, want = _ssd_bwd_one(torch, ms, inputs, chunk,
                                                  "bfloat16", name)
        bound = ssd_bwd_work(b, l, h, p, n, bf, state_grad=False)
        bwd = {"shape": name, "b": b, "l": l, "h": h, "p": p, "n": n, **row,
               "tol": SSD_BWD_TOL["bfloat16"],
               "ms": time_ms(run, warmup=1, reps=5),
               "plain_ms": time_ms(plain, warmup=1, reps=2),
               "bound_ms": bound.bound_ms(), "bound_by": bound.bound_by()}
        del inputs, got, want, run, plain
        rows.append({"tp": tp, "heads": h, "b4": fwd, "b4_bwd": bwd})
    torch.cuda.empty_cache()
    return rows


def _superblock_gathers_ms(torch, cfg, mesh, params, timed,
                           dequantize=None) -> dict:
    """A mesh step's gathers along the data axes (``tp.gather_data``),
    timed on DTensor ``params``: every superblock's leaves in turn (each
    freed before the next, as the step frees them) and the leaves outside
    the blocks; ``dequantize``: the dtype int8 leaves become right after
    their gather (the serve steps')."""
    from repro_torch.distributed import ctx, tp
    from repro_torch.launch import steps as ST
    from repro_torch.models import lm

    plan = ST.param_gather(mesh, params, dequantize)
    local = tp.to_local(params)
    nsb = lm.num_superblocks(cfg)
    layers = [lm._layer(local["blocks"], i) for i in range(nsb)]

    def superblocks():
        with ctx.gathering_params(plan):
            for layer in layers:
                tp.gather_data(layer, ("blocks",), layer=True)

    def outside():
        with ctx.gathering_params(plan):
            for name, t in local.items():
                if name != "blocks":
                    tp.gather_data(t, (name,))

    whole, rest = timed(superblocks), timed(outside)
    return {"superblocks": nsb, "all_superblocks_ms": whole,
            "per_superblock_ms": whole / nsb, "outside_blocks_ms": rest,
            "per_call_ms": whole + rest}


def mesh_train(torch, read) -> dict:
    """qwen2-0.5b trained through ``launch.train.train`` on the 1 × 1 mesh
    and with ``mesh=None`` (each crashed at step 6, restarted from step
    4): bit-equal losses, checkpoints restoring across bit for bit, the
    costs of the mesh layer (the per-superblock gathers, AdamW on
    DTensors, whole steps in turns).  Then the split step of
    ``MESH_SPLIT_CONFIGS`` at full width and depth beside ``mesh=None``
    (``mesh_split_step``: bits, launches, peaks, steps in turns), and B2′
    and B3′ at a ``model`` = 4 shard's shapes (``bwd_on_a_shard``).  With
    two cards or more also the (2, 1) and (1, 2) runs under torchrun.
    ``read()`` returns the qwen2 path's launch counts: it is called after
    the mesh run, before anything else runs; the launches returned add
    the split steps' mesh paths'."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_flatten_with_path as flatten

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(RESILIENT_ARCH)
    run = dict(RESILIENT_RUN)
    steps, fail_at = run["steps"], RESILIENT_FAIL_AT[0]
    mesh = single_device_mesh()
    try:
        hand = T.build_run(cfg=cfg, steps=steps, batch=run["batch"],
                           seq=run["seq"], ckpt_dir=None, lr=run["lr"],
                           seed=run["seed"], mesh=mesh)
        tmpl = hand.state_template()
        ckpt_bytes = _tree_nbytes(tmpl)
        shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
        free = need_free_disk(MESH_TRAIN_DIR, MESH_TRAIN_CKPTS_ON_DISK
                              * ckpt_bytes + RESILIENT_DISK_MARGIN)
        dirs = {k: os.path.join(MESH_TRAIN_DIR, k) for k in ("mesh", "none")}
        common = dict(arch=RESILIENT_ARCH, smoke=False, log_every=0,
                      fail_at=RESILIENT_FAIL_AT, **run)
        walls, out = {}, {}
        t0 = time.perf_counter()
        out["mesh"] = T.train(ckpt_dir=dirs["mesh"], mesh=mesh, **common)
        walls["mesh"] = time.perf_counter() - t0
        launches = read()              # the mesh run's: read after it
        t0 = time.perf_counter()
        out["none"] = T.train(ckpt_dir=dirs["none"], **common)
        walls["none"] = time.perf_counter() - t0
        lm, ln = out["mesh"]["losses"], out["none"]["losses"]
        restored_from = fail_at - fail_at % run["ckpt_every"]
        if lm != ln or out["mesh"]["final_step"] != steps or \
                lm[fail_at:2 * fail_at - restored_from] != \
                lm[restored_from:fail_at]:
            raise AssertionError(f"mesh losses {lm} against mesh=None {ln}")
        if not all(math.isfinite(x) for x in lm):
            raise AssertionError(f"losses {lm} not finite")

        # the step-8 checkpoints across: mesh=None's onto the mesh, the
        # mesh's onto the mesh=None path
        shardings = {"params": hand.p_shard, "opt": hand.o_shard}
        restore_s = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        onto_mesh, _ = CheckpointManager(dirs["none"]).restore(
            steps, tmpl, shardings=shardings)
        torch.cuda.synchronize()
        restore_s["none_onto_mesh"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        onto_none, _ = CheckpointManager(dirs["mesh"]).restore(steps, tmpl)
        torch.cuda.synchronize()
        restore_s["mesh_onto_none"] = time.perf_counter() - t0
        flat_mesh, flat_none = flatten(onto_mesh), flatten(onto_none)
        differ = [p for (p, a), (_, b), (_, sh) in zip(
                      flat_mesh, flat_none, flatten(shardings))
                  if type(a).__name__ != "DTensor" or a.dtype != b.dtype
                  or not torch.equal(shd.whole(a, sh), b)]
        if differ or [p for p, _ in flat_mesh] != [p for p, _ in flat_none]:
            raise AssertionError(f"checkpoints restored across differ: "
                                 f"{differ[:5]}")

        # the mesh layer's costs, on the restored state: gathering the
        # params, and AdamW on DTensors beside AdamW on plain tensors
        def timed(fn, reps=3):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / reps * 1e3

        p_mesh, o_mesh = onto_mesh["params"], onto_mesh["opt"]
        p_none, o_none = onto_none["params"], onto_none["opt"]
        gather_ms = _superblock_gathers_ms(torch, cfg, mesh, p_mesh, timed)
        opt_ms = {
            "dtensor": timed(lambda: adamw.apply(p_mesh, o_mesh.mu, o_mesh,
                                                 hand.opt_cfg)),
            "plain": timed(lambda: adamw.apply(p_none, o_none.mu, o_none,
                                               hand.opt_cfg))}
        # whole steps from the restored states, in turns (none, mesh,
        # mesh, none), on the step-8 batch
        plain_step = ST.make_train_step(cfg, hand.opt_cfg)
        batch = hand.batch_at(steps)
        turns = {"none": [], "mesh": []}
        for name in ("none", "mesh", "mesh", "none"):
            fn, state = (plain_step, (p_none, o_none)) if name == "none" \
                else (hand.step_fn, (p_mesh, o_mesh))
            turns[name].append(timed(lambda: fn(*state, batch)))
        del p_none, o_none, flat_none, onto_none, batch
        torch.cuda.empty_cache()

        # a save of the mesh state, timed as train's checkpoints are made
        saver = CheckpointManager(os.path.join(MESH_TRAIN_DIR, "timed"),
                                  keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save_async(steps, onto_mesh, extra={"step": steps},
                         shardings=shardings)
        snapshot_s = time.perf_counter() - t0
        saver.wait()
        write_s = time.perf_counter() - t0 - snapshot_s
        del onto_mesh, flat_mesh, p_mesh, o_mesh
        torch.cuda.empty_cache()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # the split step of four configs at full width and depth, each
        # path's launches read right after it (the main path's counts)
        split = [mesh_split_step(torch, arch, kw, mesh)
                 for arch, kw in MESH_SPLIT_CONFIGS]
        for row in split:
            for name, n in row["launches"]["mesh"].items():
                launches[name] = launches.get(name, 0) + n
        shard = bwd_on_a_shard(torch)
        ssd_shard = ssd_on_a_shard(torch)
        count = torch.cuda.device_count()
        two_card = {
            "x".join(map(str, shape)): two_card_run(torch, run, shape=shape)
            if count >= 2 else f"not run: this machine has {count} card"
            for shape in ((2, 1), (1, 2))}
        two_card[f"1x2.{SSM_ARCH}.smoke"] = two_card_run(
            torch, MESH_TRAIN_TWO_CARD_SMOKE, shape=(1, 2), arch=SSM_ARCH,
            smoke=True) if count >= 2 else \
            f"not run: this machine has {count} card"
    finally:
        shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    gb = ckpt_bytes / 1e9
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        **run, "fail_at": list(RESILIENT_FAIL_AT),
        "mesh": {"shape": dict(mesh.shape), "backend": "nccl",
                 "world_size": 1},
        "device_count": count,
        "losses_mesh": lm, "losses_none": ln,
        "mesh_equals_none_bit_for_bit": True,
        "checkpoints_restore_across_bit_for_bit": True,
        "median_step_ms": {"mesh": out["mesh"]["median_step_s"] * 1e3,
                           "none": out["none"]["median_step_s"] * 1e3},
        "tokens_per_s": {k: run["batch"] * run["seq"] / v["median_step_s"]
                         for k, v in out.items()},
        "step_ms_in_turns": turns,
        "superblock_gathers_ms": gather_ms, "adamw_ms": opt_ms,
        "checkpoint_gb": gb, "free_disk_gb": free / 1e9,
        "save_snapshot_s": snapshot_s, "save_write_s": write_s,
        "restore_s": restore_s,
        "stragglers_flagged": {k: v["straggler_flags"]
                               for k, v in out.items()},
        "run_wall_s": walls, "peak_mem_gb": peak_gb,
        "split_steps": split, "bwd_on_a_shard": shard,
        "ssd_on_a_shard": ssd_shard,
        "launches": launches, "two_card": two_card,
    }


# ---------------------------------------------------------------------------
# serving on a device mesh
# ---------------------------------------------------------------------------

#: the mesh server: ``lm_serve``'s first model, batch, prompts and new
#: tokens, on the 1 × 1 mesh beside ``mesh=None``, bf16 and int8 weights
MESH_SERVE_ARCH = LM_MODELS[0]
#: B3 on one rank's ``d_ff`` shard that is no multiple of its tiles:
#: qwen2-0.5b's 4864 at ``model`` = 4 (1216 columns), at a prefill's rows
MESH_SERVE_B3_SHARD = ("qwen2-0.5b", 4)
MESH_SERVE_DIR = os.path.join(ROOT, "build", "mesh_serve")

#: what a rank of the two-card serve executes (under torchrun): NCCL on
#: the cards, gloo on the CPU
_TWO_CARD_SERVE_RANK = """
import dataclasses, os, sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import ServeEngine
if {device!r} == "cuda":
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
else:
    torch.set_num_threads(1)
dist.init_process_group("nccl" if {device!r} == "cuda" else "gloo")
cfg = get_config({arch!r}, smoke={smoke!r}).with_(dtype={dtype!r})
prompts = np.random.default_rng(0).integers(
    0, cfg.vocab_size, ({batch}, {prompt}), dtype=np.int32)
eng = ServeEngine(cfg, device={device!r}, max_len={prompt} + {new}, seed=0,
                  mesh=make_host_mesh((1, 2), ("data", "model")))
logits, _ = eng.prefill(prompts)
eng.generate(prompts, max_new={new})
out, warm = eng.generate(prompts, max_new={new})
if dist.get_rank() == 0:
    torch.save({{"logits": logits.cpu(), "tokens": out,
                "warm": dataclasses.asdict(warm)}}, {path!r})
dist.destroy_process_group()
"""


def mesh_serve_two_card(torch, *, arch: str = MESH_SERVE_ARCH,
                        smoke: bool = False, device: str = "cuda",
                        dtype: str = "bfloat16", batch: int = LM_BATCH,
                        prompt: int = LM_PROMPT, new: int = LM_NEW,
                        out_dir: str = MESH_SERVE_DIR) -> dict:
    """``arch`` served on a (1, 2) tensor-parallel mesh of two ranks
    spawned by torchrun (NCCL on two cards, gloo with ``device="cpu"``)
    against one device's engine on the same seeded weights and prompts:
    the prefill logits at the LM rule, the greedy tokens compared."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import ServeEngine

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "two_card_serve.pt")
    script = os.path.join(out_dir, "two_card_serve_rank.py")
    with open(script, "w") as f:
        f.write(_TWO_CARD_SERVE_RANK.format(
            src=os.path.join(ROOT, "src"), arch=arch, smoke=smoke,
            device=device, dtype=dtype, batch=batch, prompt=prompt, new=new,
            path=path))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2", script],
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"two-card serve failed ({r.returncode}): "
                           f"{r.stderr[-3000:]}")
    two = torch.load(path, weights_only=False)
    cfg = get_config(arch, smoke=smoke).with_(dtype=dtype)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt), dtype=np.int32)
    one = ServeEngine(cfg, device=device, max_len=prompt + new, seed=0)
    logits, _ = one.prefill(prompts)
    out, _ = one.generate(prompts, max_new=new)
    gap = _logit_gap(two["logits"], logits.cpu(), LM_LOGIT_RTOL_OF_MAX,
                     LM_LOGIT_ATOL, "(1, 2) serve against one device")
    return {"tokens_1x2": two["tokens"].tolist(),
            "tokens_1x1": out.tolist(),
            "tokens_equal": bool(np.array_equal(two["tokens"], out)),
            "token_agreement": float((two["tokens"] == out).mean()),
            "logits_max_abs_gap": gap["max_abs"], "rule": gap,
            "warm_1x2": two["warm"], "wall_s": wall}


def b3_on_a_shard(torch) -> dict:
    """B3 as a rank of ``model`` = tp calls it on qwen2-0.5b: its
    ``d_ff``/tp columns (``MESH_SERVE_B3_SHARD``), the block the layer
    clamps to them, a prefill's rows, bf16, against its plain version."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import ops

    arch, tp = MESH_SERVE_B3_SHARD
    cfg = get_config(arch)
    m, d, f = LM_BATCH * LM_PROMPT, cfg.d_model, cfg.d_ff // tp
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(m, d, generator=gen).to(torch.bfloat16).cuda()
    wg, wu = (torch.randn(d, f, generator=gen).mul(d ** -0.5)
              .to(torch.bfloat16).cuda() for _ in range(2))
    wd = torch.randn(f, d, generator=gen).mul(f ** -0.5).to(
        torch.bfloat16).cuda()
    run = lambda: ops.fused_mlp(x, wg, wu, wd, act=cfg.act,      # noqa: E731
                                block_f=min(2048, f))
    out, exp = run(), fm.fused_mlp_plain(x, wg, wu, wd, act=cfg.act)
    tol = MLP_TOL["bfloat16"]
    diff = (out.float() - exp.float()).abs()
    if out.shape != exp.shape or not bool(torch.isfinite(out).all()) or \
            not bool((diff <= tol + tol * exp.float().abs()).all()):
        raise AssertionError(f"B3 on a {f}-column shard: max |err| "
                             f"{float(diff.max())} beyond {tol}")
    return {"arch": arch, "tp": tp, "m": m, "d": d, "f_shard": f,
            "block_f": min(2048, f), "max_abs_err": float(diff.max()),
            "tol": tol, "ms": time_ms(run, warmup=2, reps=10)}


def mesh_serve_ssm(torch, mesh, read) -> dict:
    """mamba2-1.3b at full width and depth served on the 1 × 1 mesh — the
    mixer split by heads, on one rank: its leaves taken as they are, B and
    C gathered, the norm's statistic and ``out_proj`` summed, each over a
    group of one — and with ``mesh=None`` on the same seeded weights and
    prompts, bf16: prefill logits and greedy tokens bit for bit; one SSD
    launch a layer of a prefill; prefill ms and decode tokens/s of both in
    turns.  The SSD counts are zeroed just before the mesh engine runs;
    ``read()`` returns its launches, called after its calls, before the
    ``mesh=None`` engine runs."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import mamba2_ssd as ms
    from repro_torch.launch.serve import ServeEngine

    cfg = get_config(SSM_ARCH)
    max_len = LM_PROMPT + LM_NEW
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    ms.reset_counts()                  # counts: zero before the mesh path
    meshed = ServeEngine(cfg, mesh=mesh, max_len=max_len, seed=0)
    logits_m, _ = meshed.prefill(prompts)
    per_prefill = ms.launches
    out_m, _ = meshed.generate(prompts, max_new=LM_NEW)
    launches = read()                  # the mesh path's: read after it
    if per_prefill != cfg.num_layers:
        raise AssertionError(f"{SSM_ARCH} mesh prefill: {per_prefill} SSD "
                             f"launches, want {cfg.num_layers}")
    plain = ServeEngine(cfg, max_len=max_len, seed=0)
    logits, _ = plain.prefill(prompts)
    out, _ = plain.generate(prompts, max_new=LM_NEW)
    if tuple(logits_m.shape) != (LM_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits_m).all()):
        raise AssertionError(f"{SSM_ARCH} mesh logits not finite of the "
                             "expected shape")
    if not torch.equal(logits_m, logits) or not np.array_equal(out_m, out):
        raise AssertionError(
            f"{SSM_ARCH}: the 1 x 1 mesh against mesh=None: logits equal "
            f"{torch.equal(logits_m, logits)}, tokens equal "
            f"{np.array_equal(out_m, out)}")
    turns = {"none": [], "mesh": []}
    for name in ("none", "mesh", "mesh", "none"):
        eng = plain if name == "none" else meshed
        _, st = eng.generate(prompts, max_new=LM_NEW)
        turns[name].append({
            "prefill_ms": _prefill_ms(torch, eng, prompts),
            "decode_tokens_per_s": st.tokens_per_s})
    del meshed, plain
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "ssm_heads": cfg.ssm.num_heads(
                cfg.d_model), "batch": LM_BATCH, "prompt": LM_PROMPT,
            "new": LM_NEW, "mesh_equals_none_bit_for_bit": True,
            "ssd_launches_per_prefill": per_prefill, "turns": turns,
            "launches": {"mamba2_ssd": launches}}


def _serve_gathered_bytes(torch, eng, prompts) -> dict:
    """The most bytes of gathered params (``tp.gathered_bytes``) alive at
    once in one prefill and in one decode step of mesh engine ``eng``,
    beside their bound — one superblock's leaves plus the largest leaf
    outside the blocks, each whole — and the live bytes after each call,
    which must be back at their value before it; raises if either
    fails."""
    from repro_torch.distributed import sharding as shd, tp
    from repro_torch.launch.steps import place_token
    from repro_torch.models import lm

    leaves = [(keys, t.numel() * t.element_size())
              for keys, t in shd._leaves_with_path(eng.params)]
    one = sum(n for keys, n in leaves if keys[0] == "blocks") \
        // lm.num_superblocks(eng.cfg)
    outside = max(n for keys, n in leaves if keys[0] != "blocks")
    out = {"superblock_bytes": one, "largest_outside_bytes": outside}
    with torch.inference_mode():
        for kind in ("prefill", "decode"):
            tp.reset_gathered()
            before = tp.gathered_bytes()["live"]
            if kind == "prefill":
                logits, caches = eng.prefill(prompts)
                cache = eng._expand_cache(caches, *prompts.shape)
                del caches
            else:
                token = logits.argmax(-1).to(torch.int32)
                eng._decode_step(eng.model_params(), cache,
                                 place_token(eng.mesh, token),
                                 prompts.shape[1])
            got = tp.gathered_bytes()
            peak, live = got["peak"] - before, got["live"] - before
            if live or not 0 < peak <= one + outside:
                raise AssertionError(
                    f"{kind}: gathered bytes' peak {peak} (bound "
                    f"{one + outside}), {live} left alive")
            out[kind] = {"peak_bytes": peak, "live_after_bytes": live}
    return out


def mesh_serve(torch, read, read_ssd) -> dict:
    """llama3.2-1b at full width and depth served on the 1 × 1 mesh (an
    NCCL world of one: every collective the identity, every local shard a
    whole leaf, the code a rank of a larger mesh runs) and with
    ``mesh=None``, bf16 and int8 weights: the same bits, and the costs of
    the mesh layer; then mamba2-1.3b the same way (``mesh_serve_ssm``).
    ``read()`` returns the llama mesh path's flash launches: it is called
    after the mesh engines' calls, before the ``mesh=None`` engines run;
    ``read_ssd()`` the mamba2 mesh path's SSD launches, likewise."""
    import numpy as np

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import tp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.serve import ServeEngine

    torch.cuda.empty_cache()
    shard = b3_on_a_shard(torch)
    cfg = get_config(MESH_SERVE_ARCH)
    max_len = LM_PROMPT + LM_NEW
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    mesh = single_device_mesh()
    try:
        # the mesh path: bf16, then int8 weights, each alone on the card
        meshed, per_prefill, peak_gb = {}, {}, {}
        for name, int8 in (("bf16", False), ("int8", True)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eng = ServeEngine(cfg, mesh=mesh, max_len=max_len, seed=0,
                              int8_weights=int8)
            before = fa.launches
            logits, _ = eng.prefill(prompts)
            per_prefill[name] = fa.launches - before
            out, _ = eng.generate(prompts, max_new=LM_NEW)
            peak_gb[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
            meshed[name] = (eng, logits, out)
        launches = read()              # the mesh path's: read after it
        for name, n in per_prefill.items():
            if n != cfg.num_layers:
                raise AssertionError(f"{name} mesh prefill: {n} flash "
                                     f"launches, want {cfg.num_layers}")

        # mesh=None on the same seeded weights: the same bits
        plain = {}
        for name, int8 in (("bf16", False), ("int8", True)):
            eng = ServeEngine(cfg, max_len=max_len, seed=0,
                              int8_weights=int8)
            logits, _ = eng.prefill(prompts)
            out, _ = eng.generate(prompts, max_new=LM_NEW)
            _, logits_m, out_m = meshed[name]
            if tuple(logits_m.shape) != (LM_BATCH, cfg.vocab_size) or \
                    not bool(torch.isfinite(logits_m).all()):
                raise AssertionError(f"{name} mesh logits not finite of "
                                     "the expected shape")
            if not torch.equal(logits_m, logits) or \
                    not np.array_equal(out_m, out):
                raise AssertionError(
                    f"{name}: the 1 x 1 mesh against mesh=None: logits "
                    f"equal {torch.equal(logits_m, logits)}, tokens equal "
                    f"{np.array_equal(out_m, out)}")
            plain[name] = eng

        # prefill and decode of both engines, in turns (none, mesh, mesh,
        # none), and the mesh layer's own costs: one call's gathers along
        # the data axes, and the gathered bytes a prefill and a decode
        # step hold at once
        turns = {w: {"none": [], "mesh": []} for w in meshed}
        for w in meshed:
            for name in ("none", "mesh", "mesh", "none"):
                eng = plain[w] if name == "none" else meshed[w][0]
                _, st = eng.generate(prompts, max_new=LM_NEW)
                turns[w][name].append({
                    "prefill_ms": _prefill_ms(torch, eng, prompts),
                    "decode_tokens_per_s": st.tokens_per_s})
        def timed(fn, reps=5):
            with torch.inference_mode():
                fn()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            return (time.perf_counter() - t) / reps * 1e3

        gather_ms, gathered = {}, {}
        for w, (eng, _, _) in meshed.items():
            gather_ms[w] = _superblock_gathers_ms(
                torch, cfg, mesh, eng.params, timed, cfg.param_dtype)
            gathered[w] = _serve_gathered_bytes(torch, eng, prompts)
        del meshed, plain
        torch.cuda.empty_cache()
        ssm = mesh_serve_ssm(torch, mesh, read_ssd)
        count = torch.cuda.device_count()
        two_card = {
            MESH_SERVE_ARCH: mesh_serve_two_card(torch),
            f"{SSM_ARCH}.smoke": mesh_serve_two_card(torch, arch=SSM_ARCH,
                                                     smoke=True)} \
            if count >= 2 else f"not run: this machine has {count} card"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {
        "card": nvidia_smi_line(),
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
        "mesh": {"shape": dict(mesh.shape), "backend": "nccl",
                 "world_size": 1},
        "device_count": count,
        "mesh_equals_none_bit_for_bit": {"bf16": True, "int8": True},
        "flash_launches_per_prefill": per_prefill,
        "turns": turns, "gather_ms_per_call": gather_ms,
        "gathered_bytes": gathered,
        "peak_mem_gb": peak_gb, "b3_on_a_shard": shard, "ssm": ssm,
        "launches": {"flash_attention": launches,
                     "mamba2_ssd": ssm["launches"]["mamba2_ssd"]},
        "two_card": two_card,
    }


# ---------------------------------------------------------------------------
# phase 25: the dry-run — the meta device's counts, and the card beside them
# ---------------------------------------------------------------------------

#: steps the card runs in other phases, traced on a world of one and run
#: on the card's 1 × 1 mesh: (name, arch, seq, batch, kind) — lm_serve's
#: prefill of 4 × 1024 and mesh_train's step of 4 × 1024
DRYRUN_TIES = (("llama3.2-1b.prefill", LM_MODELS[0], LM_PROMPT, LM_BATCH,
                "prefill"),
               ("qwen2-0.5b.mesh_train", RESILIENT_ARCH, RESILIENT_RUN["seq"],
                RESILIENT_RUN["batch"], "train"))
DRYRUN_LIMIT_S = 120
DRYRUN_TIMED_STEPS = 3


def dryrun_tie(name: str, device: str) -> dict:
    """One of ``DRYRUN_TIES`` through ``dryrun.build_step`` on a 1 × 1
    mesh.  ``"meta"``: its counts on a fake world of one (argument and
    peak bytes, and the roofline terms).  ``"cuda"``: the same step on
    the card — the allocator's requested bytes (``memory_stats()``'s
    ``requested_bytes``) and ``memory_allocated()`` (its blocks) with the
    mesh alone and with the arguments built, both peaks over the first
    call (the libraries' load and cuBLAS' workspace included), and the
    ms of warm calls.  Each in a process of its own (``python -c``): the
    two worlds cannot share one, and the card's count starts from
    nothing allocated."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.graph_analysis import count_step
    from repro_torch.launch.mesh import make_host_mesh, single_device_mesh

    _, arch, seq, batch, kind = next(t for t in DRYRUN_TIES if t[0] == name)
    cfg, shape = get_config(arch), ShapeConfig(name, seq, batch, kind)
    if device == "meta":
        D.fake_world(1)
        mesh = make_host_mesh((1, 1), ("data", "model"))
        step, args = D.build_step(cfg, shape, mesh)
        _, st = count_step(step, *args)
        terms = {"compute_s": st.compute_s(), "memory_s": st.memory_s(),
                 "collective_s": st.collective_s()}
        dist.destroy_process_group()
        return {"argument_bytes": st.argument_bytes,
                "unread_argument_bytes": st.unread_argument_bytes,
                "peak_bytes": st.peak_bytes, **terms, "bound_s": max(terms.values()),
                "dominant": max(terms, key=terms.get),
                "kernel_calls": st.kernel_calls}
    def held() -> dict:
        torch.cuda.synchronize()
        st = torch.cuda.memory_stats()
        return {"requested": st.get("requested_bytes.all.current", 0),
                "requested_peak": st.get("requested_bytes.all.peak", 0),
                "allocated": torch.cuda.memory_allocated(),
                "allocated_peak": torch.cuda.max_memory_allocated()}

    mesh = single_device_mesh()
    try:
        with_mesh = held()
        step, args = D.build_step(cfg, shape, mesh, device="cuda")
        before = held()
        torch.cuda.reset_peak_memory_stats()
        out = step(*args)
        peak = held()
        del out
        ms = []
        for _ in range(DRYRUN_TIMED_STEPS):
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            del out
    finally:
        dist.destroy_process_group()
    return {"with_mesh": with_mesh, "before": before, "first_call": peak,
            "step_ms": ms}


def _python(code: str | None, *, cpu_only: bool,
            argv=None) -> subprocess.Popen:
    """``python -c code`` (or ``python`` with ``argv``) from the
    checkout's root, its output piped."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    for k in ("REPRO_MESH_SHAPE", "REPRO_MESH_SHAPE_MULTI"):
        env.pop(k, None)
    if cpu_only:
        env["CUDA_VISIBLE_DEVICES"] = ""
    args = ["-c", code] if argv is None else list(argv)
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc: subprocess.Popen, what: str, timeout: float) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: no result after {timeout:.0f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}: {err[-1500:]}")
    return out


def dryrun(torch, smi: str) -> dict:
    """Each of ``DRYRUN_TIES`` traced on a world of one
    (``launch.dryrun.build_step`` under its ``StepCounter``, on the host's
    CPU) and run on the card: the predicted argument bytes — those the
    step reads, and those it does not (none, in these steps) — must
    equal the bytes the card's allocator was asked for before the step
    (``requested_bytes``, less the mesh's own), with
    ``torch.cuda.memory_allocated()`` (its blocks) beside them; the
    predicted peak against both peaks; ``bound_s`` against the measured
    ms.  (The production meshes' cells are the CPU's to count:
    ``tests/test_torch_dryrun.py`` runs the reference's smoke cells.)  The
    phase fails if a tie fails or the whole takes over
    ``DRYRUN_LIMIT_S``."""
    from torch.testing._internal.distributed import fake_pg  # noqa: F401

    from repro_torch.launch import roofline

    t0 = time.perf_counter()
    predicted = {
        name: _python("import chip_smoke, json\nprint(json.dumps("
                      f"chip_smoke.dryrun_tie({name!r}, 'meta')))",
                      cpu_only=True)
        for name, *_ in DRYRUN_TIES}
    ties = []
    for name, *_ in DRYRUN_TIES:
        pred = json.loads(_finish(predicted[name], f"dryrun {name} meta",
                                  DRYRUN_LIMIT_S).strip().splitlines()[-1])
        card = json.loads(_finish(
            _python("import chip_smoke, json\nprint(json.dumps("
                    f"chip_smoke.dryrun_tie({name!r}, 'cuda')))",
                    cpu_only=False), f"dryrun {name} cuda",
            DRYRUN_LIMIT_S).strip().splitlines()[-1])
        mesh_, before, first = card["with_mesh"], card["before"], \
            card["first_call"]
        requested = before["requested"] - mesh_["requested"]
        built = pred["argument_bytes"] + pred["unread_argument_bytes"]
        if built != requested:
            raise AssertionError(
                f"{name}: predicted argument bytes {pred['argument_bytes']}"
                f" read + {pred['unread_argument_bytes']} unread != "
                f"{requested} requested of the card's allocator "
                f"({before['requested']} less {mesh_['requested']} with "
                "the mesh alone)")
        ties.append({
            "name": name,
            "predicted_argument_bytes": pred["argument_bytes"],
            "predicted_unread_argument_bytes": pred["unread_argument_bytes"],
            "requested_bytes_by_arguments": requested,
            "memory_allocated_by_arguments":
                before["allocated"] - mesh_["allocated"],
            "predicted_peak_bytes": pred["peak_bytes"],
            "requested_bytes_peak": first["requested_peak"],
            "max_memory_allocated": first["allocated_peak"],
            "predicted_bound_ms": pred["bound_s"] * 1e3,
            "predicted_dominant": pred["dominant"],
            "step_ms": card["step_ms"],
            "kernel_calls": {k: v["launches"]
                             for k, v in pred["kernel_calls"].items()}})
    seconds = time.perf_counter() - t0
    if seconds > DRYRUN_LIMIT_S:
        raise AssertionError(f"the dryrun phase took {seconds:.0f} s, over "
                             f"{DRYRUN_LIMIT_S}")
    return {"card": smi, "modeled": roofline.MODELED,
            "fake_pg_imports": True, "ties": ties, "seconds": seconds}


# ---------------------------------------------------------------------------


#: the port's examples (``examples/*_torch.py``) in the order the
#: ``examples`` phase runs them, each with the kernels its path launches
#: on the card
EXAMPLES_DIR = os.path.join(ROOT, "examples")
EXAMPLES = (("quickstart_torch", ("conv2d_stream",)),
            ("serve_batched_torch", ("conv2d_stream",)),
            ("train_lm_torch", ("flash_attention", "flash_attention_bwd")),
            ("elastic_resilience_torch",
             ("flash_attention", "flash_attention_bwd")))


def example_numbers(name: str, res: dict) -> dict:
    """The key numbers of one example's run, from what its ``main`` put
    in ``out``."""
    if name == "quickstart_torch":
        import numpy as np

        return {"bit_exact": bool(np.array_equal(res["got"], res["want"])),
                "output_shape": list(res["got"].shape)}
    if name == "serve_batched_torch":
        rep = res["load"]
        return {"offered_qps": rep.offered_qps,
                "achieved_qps": rep.achieved_qps, "p50_ms": rep.p50_ms,
                "p99_ms": rep.p99_ms, "mean_batch": rep.mean_batch,
                "rejected": rep.rejected,
                "burst_batches": res["stats"]["batches"],
                "burst_max_batch": res["stats"]["max_batch_seen"]}
    if name == "train_lm_torch":
        step_s = res["median_step_s"]
        return {"median_step_ms": step_s * 1e3,
                "tokens_per_s": res["tokens_per_step"] / step_s,
                "first10_mean_loss": res["first"],
                "last10_mean_loss": res["last"],
                "final_step": res["final_step"],
                "steps_run": len(res["losses"]),
                "stragglers_flagged": len(res["straggler_flags"])}
    ranks = res["ranks"]
    return {"phase1_s": ranks[0]["seconds"][0],
            "phase2_s": ranks[0]["seconds"][1],
            "gloo_ranks_s": res["ranks_seconds"],
            "phase3_s": res["phase3_seconds"],
            "final_steps": [ranks[0]["phase1"]["final_step"],
                            ranks[0]["phase2"]["final_step"],
                            res["phase3"]["final_step"]],
            "phase3_losses": res["phase3"]["losses"],
            "watchdog_flagged": [s for s, _ in res["watchdog"].flagged]}


def examples(torch) -> dict:
    """Each of ``EXAMPLES``: its ``main`` in this process with its default
    arguments (the CUDA card), its printed lines to
    ``DETAIL_DIR/example_<name>.log``.  The conv and attention kernels'
    counts are zeroed just before each example and read just after: the
    run fails if an example does not return 0, if a kernel of its path
    never launched, or if a plain version ran on a CUDA tensor.  The
    gloo ranks of the elastic example's phases 1-2 are spawned processes
    on the CPU; its phase 3 trains on the card."""
    import importlib

    from repro_torch.kernels import conv2d_stream as cs
    from repro_torch.kernels import flash_attention as fa

    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    os.makedirs(DETAIL_DIR, exist_ok=True)
    rows = []
    totals = {"conv2d_stream": 0, "flash_attention": 0,
              "flash_attention_bwd": 0}
    for name, kernels in EXAMPLES:
        mod = importlib.import_module(name)
        log = os.path.join(DETAIL_DIR, f"example_{name}.log")
        res: dict = {}
        cs.reset_counts()          # counts: zero before this example
        fa.reset_counts()
        t0 = time.perf_counter()
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            rc = mod.main([], out=res)
        seconds = time.perf_counter() - t0
        counts = {"conv2d_stream": cs.launches,                # read after
                  "flash_attention": fa.launches,
                  "flash_attention_bwd": fa.bwd_launches}
        plain = (cs.plain_cuda_calls + fa.plain_cuda_calls
                 + fa.bwd_plain_cuda_calls)
        if rc != 0:
            raise AssertionError(f"the {name} example exited {rc}")
        if plain:
            raise AssertionError(f"a plain version ran {plain} time(s) on a "
                                 f"CUDA tensor in the {name} example")
        never = [k for k in kernels if counts[k] < 1]
        if never:
            raise AssertionError(f"the {name} example never launched "
                                 f"{never}")
        for k in kernels:
            totals[k] += counts[k]
        with open(log) as f:
            last = f.read().strip().splitlines()[-1]
        rows.append({"example": name, "rc": rc, "seconds": seconds,
                     "last_line": last,
                     "launches": {k: counts[k] for k in kernels},
                     **example_numbers(name, res)})
    return {"examples": rows, "launches": totals}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--ptxas", action="store_true",
                    help="ptxas' registers and spills of every kernel on "
                         "the build line (the conv, SSD and backward "
                         "kernels' are always there)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phase(s) {sorted(unknown)}")

    # a hang must fail the run inside its time limit, not outlast it
    signal.signal(signal.SIGALRM, _timed_out)
    signal.alarm(WATCHDOG_S)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs one CUDA device and takes no CPU path", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d_stream as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import mamba2_ssd as ms

    t_all = time.perf_counter()
    phase_seconds()                    # the device phase starts here
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    if "device" in phases:
        nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()
        emit({"device": {"nvidia_smi": smi, "kind": kind,
                         "count": torch.cuda.device_count(),
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda,
                         "nvcc": nvcc[-2:] if nvcc else None,
                         "seconds": phase_seconds()}})
    # always from the checkout's sources, whatever a build directory
    # holds: one nvcc per kernel, all started together
    libraries = (cs.LIBRARY, fa.LIBRARY, fa.BWD_LIBRARY, fm.LIBRARY,
                 fm.BWD_LIBRARY, ms.LIBRARY, ms.BWD_LIBRARY)
    probe_lib = mlp_probe_library(build, fm) if "mlp_probe" in phases \
        else None
    t0 = time.perf_counter()
    build.build_libraries(
        libraries + ((probe_lib,) if probe_lib is not None else ()),
        verbose=True)
    build_s = time.perf_counter() - t0
    for lib in libraries:
        lib.load()
    if "build" in phases:
        built = {"seconds": build_s,
                 "libraries": {
                     lib.name: {"seconds": lib.build_seconds,
                                "path": os.path.relpath(str(lib.path), ROOT),
                                "log": lib.build_log}
                     for lib in libraries},
                 "flags": list(build.NVCC_FLAGS)}
        # registers and spills: the redesigned kernels always, every
        # kernel with --ptxas
        built["ptxas"] = [r for lib in libraries
                          if args.ptxas or lib in (cs.LIBRARY, ms.LIBRARY,
                                                   fa.BWD_LIBRARY,
                                                   fm.BWD_LIBRARY,
                                                   ms.BWD_LIBRARY)
                          for r in ptxas_report(lib.build_log)]
        emit_phase("build", built)
    checked = None
    if "kernel_check" in phases:
        checked = kernel_check(torch)
        emit_phase("kernel_check", checked)

    cs.reset_counts()                  # counts: zero before the main path
    arts = None
    if "main_path" in phases or "serve" in phases:
        result, arts = main_path(torch)
        emit_phase("main_path", result)
    if "serve" in phases:
        emit_phase("serve", serve(torch, arts))
    def read_after(mod, name: str, path: str) -> int:
        """The counts of ``mod`` after ``path`` ran; fails if its kernel
        never launched there or its plain version ran on a CUDA tensor."""
        if mod.launches < 1:
            raise AssertionError(f"the {path} path never launched {name}")
        if mod.plain_cuda_calls:
            raise AssertionError(
                f"{name}'s plain version ran {mod.plain_cuda_calls} time(s) "
                f"on a CUDA tensor on the {path} path")
        return mod.launches

    launches = 0
    if arts is not None:
        launches = read_after(cs, "conv2d_stream", "main")     # read after
    cs.reset_counts()         # counts: zero before the imported and CLI paths
    if "frontends" in phases:
        emit_phase("frontends", frontends(torch))
    if "cli" in phases:
        emit_phase("cli", cli(torch, smi, kind))
    if "frontends" in phases or "cli" in phases:
        launches += read_after(cs, "conv2d_stream",               # after
                               "imported and command-line")

    attn = attn_bwd = mlp = mlp_bwd = ssd = ssd_bwd = None
    if "attn_check" in phases:
        attn = attn_check(torch)
        emit_phase("attn_check", attn)
    if "attn_bwd_check" in phases:
        attn_bwd = attn_bwd_check(torch)
        emit_phase("attn_bwd_check", attn_bwd)
    if "mlp_check" in phases:
        mlp = mlp_check(torch)
        emit_phase("mlp_check", mlp)
    if "mlp_bwd_check" in phases:
        mlp_bwd = mlp_bwd_check(torch)
        emit_phase("mlp_bwd_check", mlp_bwd)
    if "mlp_probe" in phases:
        emit_phase("mlp_probe", mlp_probe(torch, probe_lib))
    if "ssd_check" in phases:
        ssd = ssd_check(torch)
        emit_phase("ssd_check", ssd)
    if "ssd_bwd_check" in phases:
        ssd_bwd = ssd_bwd_check(torch)
        emit_phase("ssd_bwd_check", ssd_bwd)

    fa_launches = fm_launches = ms_launches = 0
    fa.reset_counts()                  # counts: zero before the LM path
    fm.reset_counts()
    if "lm_serve" in phases:
        emit_phase("lm_serve", lm_serve(torch))
        fa_launches += read_after(fa, "flash_attention", "LM")  # after
        fm_launches += read_after(fm, "fused_mlp", "LM")
    ms.reset_counts()                  # counts: zero before the SSM path
    if "ssm_serve" in phases:
        emit_phase("ssm_serve", ssm_serve(torch))
        ms_launches += read_after(ms, "mamba2_ssd", "SSM")      # after
    fa.reset_counts()                  # counts: zero before the MoE path
    if "moe_serve" in phases:
        emit_phase("moe_serve", moe_serve(torch))
        fa_launches += read_after(fa, "flash_attention", "MoE")  # after
    fa.reset_counts()                  # counts: zero before the hybrid path
    ms.reset_counts()
    if "hybrid_serve" in phases:
        emit_phase("hybrid_serve", hybrid_serve(torch))
        fa_launches += read_after(fa, "flash_attention", "hybrid")  # after
        ms_launches += read_after(ms, "mamba2_ssd", "hybrid")
    fa.reset_counts()                  # counts: zero before the encdec path
    if "encdec_serve" in phases:
        emit_phase("encdec_serve", encdec_serve(torch))
        fa_launches += read_after(fa, "flash_attention",        # after
                                  "encoder-decoder")
    fa.reset_counts()                  # counts: zero before the VLM path
    if "vlm_serve" in phases:
        emit_phase("vlm_serve", vlm_serve(torch))
        fa_launches += read_after(fa, "flash_attention",        # after
                                  "vision-language")
    if "int8_serve" in phases:
        int8 = []
        for i, arch in enumerate(INT8_ARCHS):
            fa.reset_counts()      # counts: zero before this int8 path
            int8.append(int8_serve(
                torch, read=lambda: read_after(                 # read after
                    fa, "flash_attention", "int8"),
                arch=arch, cpu_check=i == 0))
            fa_launches += int8[-1]["launches"]["flash_attention"]
        emit_phase("int8_serve", {"models": int8})
    def read_bwd(mod, name: str, path: str) -> int:
        """``read_after`` for a module's backward kernel."""
        if mod.bwd_launches < 1 or mod.bwd_plain_cuda_calls:
            raise AssertionError(
                f"the {path} path launched {name} {mod.bwd_launches} "
                f"time(s), its plain version ran {mod.bwd_plain_cuda_calls} "
                "time(s) on a CUDA tensor")
        return mod.bwd_launches

    # each train path, the kernel pairs it runs: (module, forward,
    # backward) and the running totals of both
    pairs = {"attn": (fa, "flash_attention", "flash_attention_bwd"),
             "ssd": (ms, "mamba2_ssd", "mamba2_ssd_bwd"),
             "mlp": (fm, "fused_mlp", "fused_mlp_bwd")}
    bwd_totals = {pair: 0 for pair in pairs}
    for name, train_fn, used in (
            ("lm_train", lm_train, ("attn",)),
            ("lm_train_streamed", lm_train_streamed, ("attn", "mlp")),
            ("moe_train", moe_train, ("attn",)),
            ("ssm_train", ssm_train, ("ssd",)),
            ("encdec_train", encdec_train, ("attn",)),
            ("hybrid_train", hybrid_train, ("attn", "ssd"))):
        fa.reset_counts()              # counts: zero before this train path
        ms.reset_counts()
        fm.reset_counts()
        if name not in phases:
            continue
        train, rest = train_fn(torch)
        for pair in used:                                      # read after
            mod, fwd, bwd = pairs[pair]
            n_fwd = read_after(mod, fwd, name)
            bwd_totals[pair] += read_bwd(mod, bwd, name)
            if pair == "attn":
                fa_launches += n_fwd
            elif pair == "ssd":
                ms_launches += n_fwd
            else:
                fm_launches += n_fwd
        train.update(rest())     # the repeat, profile and CPU check: after
        emit_phase(name, train)
    fa.reset_counts()                  # counts: zero before the restart path
    if "train_resilient" in phases:
        resilient = train_resilient(torch, read=lambda: {       # read after
            "flash_attention": read_after(fa, "flash_attention",
                                          "crash-restart train"),
            "flash_attention_bwd": read_bwd(fa, "flash_attention_bwd",
                                            "crash-restart train")})
        fa_launches += resilient["launches"]["flash_attention"]
        bwd_totals["attn"] += resilient["launches"]["flash_attention_bwd"]
        emit_phase("train_resilient", resilient)
    fa.reset_counts()                  # counts: zero before the mesh path
    if "mesh_train" in phases:
        meshed = mesh_train(torch, read=lambda: {               # read after
            "flash_attention": read_after(fa, "flash_attention",
                                          "mesh train"),
            "flash_attention_bwd": read_bwd(fa, "flash_attention_bwd",
                                            "mesh train")})
        fa_launches += meshed["launches"]["flash_attention"]
        bwd_totals["attn"] += meshed["launches"]["flash_attention_bwd"]
        ms_launches += meshed["launches"]["mamba2_ssd"]
        bwd_totals["ssd"] += meshed["launches"]["mamba2_ssd_bwd"]
        fm_launches += meshed["launches"]["fused_mlp"]
        bwd_totals["mlp"] += meshed["launches"]["fused_mlp_bwd"]
        emit_phase("mesh_train", meshed)
    fa.reset_counts()                  # counts: zero before the mesh server
    if "mesh_serve" in phases:
        served = mesh_serve(
            torch, read=lambda: read_after(                     # read after
                fa, "flash_attention", "mesh serve"),
            read_ssd=lambda: read_after(                        # read after
                ms, "mamba2_ssd", "SSM mesh serve"))
        fa_launches += served["launches"]["flash_attention"]
        ms_launches += served["launches"]["mamba2_ssd"]
        emit_phase("mesh_serve", served)
    if "dryrun" in phases:               # meta and subprocesses: no count
        emit_phase("dryrun", dryrun(torch, smi))
    if "examples" in phases:       # each example's counts zeroed and read
        ex = examples(torch)
        launches += ex["launches"]["conv2d_stream"]
        fa_launches += ex["launches"]["flash_attention"]
        bwd_totals["attn"] += ex["launches"]["flash_attention_bwd"]
        emit_phase("examples", ex)
    fb_launches, mb_launches = bwd_totals["attn"], bwd_totals["ssd"]

    if set(phases) != set(PHASES):
        emit({"partial": phases,
              "seconds": round(time.perf_counter() - t_all, 1),
              "stdout_bytes": _stdout_bytes})
        return 0
    head = next(s for s in checked["shapes"]
                if s["shape"] == HEADLINE_SHAPE and s["dtype"] == "int32")
    ahead = next(s for s in attn["shapes"]
                 if (s["shape"], s["dtype"]) == ATTN_HEADLINE)
    mhead = next(s for s in mlp["shapes"]
                 if (s["shape"], s["dtype"]) == MLP_HEADLINE)
    shead = next(s for s in ssd["shapes"]
                 if (s["shape"], s["dtype"]) == SSD_HEADLINE)
    bhead = next(s for s in attn_bwd["shapes"]
                 if (s["shape"], s["dtype"]) == ATTN_BWD_HEADLINE)
    sbhead = next(s for s in ssd_bwd["shapes"]
                  if (s["shape"], s["dtype"]) == SSD_BWD_HEADLINE)
    mbhead = next(s for s in mlp_bwd["shapes"]
                  if (s["shape"], s["dtype"]) == MLP_BWD_HEADLINE)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "conv2d_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d_stream.cu",
        "replaces": "src/repro/kernels/conv2d_stream.py:70",
        "launches": launches,
        "max_abs_err": max(checked["max_abs_err_f32"],
                           checked["max_abs_err_bf16"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": f"{HEADLINE_SHAPE} int32 (no library call computes an "
                    "int32 conv; float shapes carry library_ms below)",
        "comparisons": checked["comparisons"],
        "shapes": shape_rows(checked["shapes"]),
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": fa_launches,
        "max_abs_err": max(attn["max_abs_err_f32"], attn["max_abs_err_bf16"]),
        "ms": ahead["ms"], "plain_ms": ahead["plain_ms"],
        "bound_ms": ahead["bound_ms"], "bound_by": ahead["bound_by"],
        "library_ms": ahead["library_ms"],
        "timed_at": f"{ATTN_HEADLINE[0]} {ATTN_HEADLINE[1]} (library: "
                    "F.scaled_dot_product_attention, GQA, causal)",
        "comparisons": attn["comparisons"],
        "shapes": shape_rows(attn["shapes"]),
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:209",
        "launches": fb_launches,
        "max_abs_err": max(attn_bwd["max_abs_err_f32"],
                           attn_bwd["max_abs_err_bf16"]),
        "ms": bhead["ms"], "device_ms": bhead["device_ms"],
        "device_ms_each": bhead["device_ms_each"],
        "tflops_each": bhead["tflops_each"],
        "planner_route": bhead["route"],
        "plain_ms": bhead["plain_ms"],
        "bound_ms": bhead["bound_ms"], "bound_by": bhead["bound_by"],
        "library_ms": bhead["library_ms"],
        "timed_at": f"{ATTN_BWD_HEADLINE[0]} {ATTN_BWD_HEADLINE[1]}, per call "
                    "of the delta, dK/dV and dQ kernels (no TPU "
                    "kernel: the counterpart of the reference's XLA custom "
                    "VJP; library: F.scaled_dot_product_attention's "
                    "backward, flash backend, k/v expanded to the query "
                    "heads)",
        "comparisons": attn_bwd["comparisons"],
        "shapes": shape_rows([s for s in attn_bwd["shapes"] if "ms" in s]),
    }, {
        "name": "fused_mlp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:37",
        "launches": fm_launches,
        "max_abs_err": max(mlp["max_abs_err_f32"], mlp["max_abs_err_bf16"]),
        "ms": mhead["ms"], "plain_ms": mhead["plain_ms"],
        "bound_ms": mhead["bound_ms"], "bound_by": mhead["bound_by"],
        "library_ms": mhead["library_ms"],
        "timed_at": f"{MLP_HEADLINE[0]} {MLP_HEADLINE[1]} (library: "
                    "mlp_impl='dense', three cuBLAS matmuls + activation, "
                    "not one call)",
        "comparisons": mlp["comparisons"],
        "shapes": shape_rows(mlp["shapes"]),
    }, {
        "name": "mamba2_ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd.py:26",
        "launches": ms_launches,
        "max_abs_err": max(ssd["max_abs_err_f32"], ssd["max_abs_err_bf16"]),
        "ms": shead["ms"], "plain_ms": shead["plain_ms"],
        "bound_ms": shead["bound_ms"], "bound_by": shead["bound_by"],
        "library_ms": None,
        "timed_at": f"{SSD_HEADLINE[0]} {SSD_HEADLINE[1]} (no PyTorch call "
                    "computes an SSD scan)",
        "comparisons": ssd["comparisons"],
        "shapes": shape_rows(ssd["shapes"]),
    }, {
        "name": "mamba2_ssd_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba2_ssd_bwd.cu",
        "replaces": "src/repro/models/mamba2.py:107",
        "launches": mb_launches,
        "max_abs_err": max(ssd_bwd["max_abs_err_f32"],
                           ssd_bwd["max_abs_err_bf16"]),
        "ms": sbhead["ms"], "device_ms": sbhead["device_ms"],
        "device_ms_each": sbhead["device_ms_each"],
        "plain_ms": sbhead["plain_ms"],
        "bound_ms": sbhead["bound_ms"], "bound_by": sbhead["bound_by"],
        "library_ms": None,
        "timed_at": f"{SSD_BWD_HEADLINE[0]} {SSD_BWD_HEADLINE[1]}, per call "
                    "of the dS pass and the tile kernel (no TPU "
                    "kernel: the counterpart of XLA's autodiff of "
                    "ref.ssd_chunked; no PyTorch call computes an SSD "
                    "backward)",
        "comparisons": ssd_bwd["comparisons"],
        "shapes": shape_rows([s for s in ssd_bwd["shapes"] if "ms" in s]),
    }, {
        "name": "fused_mlp_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp_bwd.cu",
        "replaces": "src/repro/models/layers.py:531",
        "launches": bwd_totals["mlp"],
        "max_abs_err": max(mlp_bwd["max_abs_err_f32"],
                           mlp_bwd["max_abs_err_bf16"]),
        "ms": mbhead["ms"], "device_ms": mbhead["device_ms"],
        "device_ms_each": mbhead["device_ms_each"],
        "tflops_each": mbhead["tflops_each"],
        "planner_route": mbhead["route"],
        "plain_ms": mbhead["plain_ms"],
        "bound_ms": mbhead["bound_ms"], "bound_by": mbhead["bound_by"],
        "library_ms": mbhead["library_ms"],
        "timed_at": f"{MLP_BWD_HEADLINE[0]} {MLP_BWD_HEADLINE[1]}, per call "
                    "of the hidden, weight-gradient and dx kernels (no TPU "
                    "kernel: the counterpart of XLA's autodiff of the "
                    "reference's _mlp_streamed; library: autograd's "
                    "backward of the dense MLP, three torch.matmul, g and u "
                    "saved)",
        "comparisons": mlp_bwd["comparisons"],
        "shapes": shape_rows([s for s in mlp_bwd["shapes"] if "ms" in s]),
    }], "seconds": round(time.perf_counter() - t_all, 1),
        "stdout_bytes": _stdout_bytes})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
