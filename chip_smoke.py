#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tempo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   compile the CUDA kernels from tempo_tpu_torch/csrc with nvcc, and
             print what ptxas says of every kernel (registers, spills,
             shared memory); K5f and K5dkv may not spill at head dim 64,
             K5dq at 32, 64 or 128, any decode kernel, any bf16 K2 tile
             configuration, nor any K1 kernel; K5f's and K5dq's SASS must
             hold HGMMA (wgmma) at every head dim;
  2. kernels hold each kernel against its plain PyTorch version on the card
             at the shapes the main path gives it (discovered by running the
             tile batch and the granule once each), and time kernel, plain
             version and library calls (K2's lines name the tile
             configuration and split its launcher chose). K1a is also held
             bitwise to itself on a repeat and, for each sample, alone
             against in a batch, and counted under torch.profiler as one
             device kernel a call (or, where three profiler sessions list
             nothing, as one node of a CUDA graph captured around the
             call); K1a and K1b are checked at edge shapes
             (HW 1, 7x9, 3x1000; C 40 in 8 groups; B 1 and 8; bf16, fp32,
             an unaligned x), and the five [1,128,2048,512] calls are
             printed beside their byte bound;
  3. main    the flagship AutoencoderKL (27,289,893 parameters, bf16
             compute, weights from a seed): encode -> mode -> decode of an
             [8,64,64,1028] tile batch and GranuleCodec.reconstruct_raw of a
             [131,2048,1028] raw granule, with every launch counter set to 0
             just before and read just after; then its timings, and the tile
             and granule reconstructions against the same model run through
             the plain versions.
  then the GPT-2-small serving path (bf16, weights from a seed), K3 and K4,
  every fixed-shape decode call captured as a CUDA graph and replayed:
  3a. generate of 8 x (64 + 128) tokens over a 1024-slot cache, the K3
      counter set to 0 before and read after (12 x 127 launches: the first
      step's eager warm-up, then replays); bitwise equal to the eager loop
      (_generate_eager), both timed in the same run, the captured one also
      under torch.profiler;
  3b. PagedLMServer over live_paged_surface: 64 mixed requests (prompts
      32-512, 64-128 new tokens), 8 slots, k_decode 16, chunked prefill,
      on a roomy and a tight (preempting) pool, the K4 counter set to 0
      before and read after; greedy outputs equal across the two pools and
      to the same server run eagerly (whose K3/K4 calls phase 2' reads);
  2'. K3/K4 against their plain versions at every recorded call and at
      edge cases (positions 0, the split length L - 1, L, L + 1, the
      longest unsplit row 2L - 1 and past it, block and page edges, the
      cache's end), each call timed with its bound and
      library call; each row of a batch bitwise the same alone and inside
      the batch (K4: another pool, another page order);
  3d. exported serving: GPT-2-small's torch.export programs, written by
      export_lm in a background process started with the run (LM_EXPORTS:
      every LM artifact of 3d, 9 and 10 is exported so, the CPU work beside
      phases 1-3), loaded with device None; (i) decode_step, decode_rows,
      decode_k (K 16),
      decode_paged and decode_paged_k replayed against their eager calls
      at the capture's and another position and table, outputs and caches
      bitwise, 12 x K decode launches a replay, each replay timed by CUDA
      events; (ii) the 64 requests
      through cli/serve_lm.py's build_server and _serve_batch with a dict
      config, bucketed, continuous (8 slots, k_decode 16) and paged (65
      and 33 pages): tokens/s, dispatches, bursts, preemptions, the device
      busy share under torch.profiler over the first 4 requests and the
      decode kernels it lists against the launch count; the paged
      completions equal 3b's eager server's on both pools; (iii)
      _serve_http on 127.0.0.1, port 0: /healthz gives the meta, one POST
      /v1/completions equals batch mode;
  3c. one decode step's logits (dense and paged, bf16 and fp32) against
      the plain path.
  then the GPT-2-small training path (bf16, attn_impl "auto", weights from a
  seed), K5f, K5dkv and K5dq:
  4a. train steps on the bench_gpt batch ([8, 1025] tokens, AdamW lr 3e-4,
      wd 0.1, betas (0.9, 0.95), the decay mask): 3 warm, then 10 timed,
      the K5 counters set to 0 before and read after (12 x 10 each); step
      ms, tokens/s, MFU, peak memory, a profiled step; the loss falls;
  4b. Trainer.train for 30 steps on a TokenLoader (batch 8, block 1024)
      into a temporary directory: checkpoint and metrics.json written; one
      more step from the reloaded checkpoint equals one from the live
      state, bit for bit;
  2''. K5 against its plain versions at the path's shape and at edge
      cases (t 1, 63, 65, 129, 200, 640, 1000; hd 32, 128; GQA 12/4;
      non-causal; fp32), each kernel timed alone beside its bound, plain
      version and SDPA;
  4c. one train step's loss and gradients through K5 against the plain
      attention path (bf16 full size; fp32 with 2 layers at batch 2).
  then the flagship VAE training path (bf16, weights from a seed with the
  zero-init output convs re-drawn), K1a, K1b and K2 in the forward, their
  backward the plain recompute:
  5a. train steps on the bench_train batch ([64, 64, 64, 1028] fp32 from
      a seed, AdamW lr 1e-4, betas (0.9, 0.95), wd 0.05 after the
      global-norm clip): 3 warm, then 10 timed, the K1/K2 counters set to
      0 before and read after (launches a step equal to the calls of one
      training forward); step ms, patches/s, peak memory, a profiled step
      by kind of kernel and its busy share (also at batch 8); the loss
      falls; one loss and backward with remat equals the one without
      (peak memory of each);
  2'''. the K1 and K2 autograd Functions' backward at every shape the step
      records against autograd through the plain chain, same inputs;
  5b. Trainer.train for 30 steps at batch 8 over a TileLoader of
      make_tile_shards' flagship fp16 shards: a validation of 10 batches,
      checkpoint and metrics.json written; one more step from the reloaded
      checkpoint equals one from the live state, bit for bit (cuDNN
      deterministic for the two); samples/s and the loader's share;
  5c. one step's loss, pixel MSE and gradients through K1/K2 against the
      plain path, under the L2 loss (bf16 at batch 64; fp32 with two
      levels at batch 2), and under the flagship's L1 loss in bf16, its
      gradients held against the same step in fp32 (VAE_BF16_ACC).
  then the L2-supervised VAE training path (the flagship and the 512-512-4
  head, bf16, weights from a seed, zero-init output convs re-drawn), K1a,
  K1b (also at the head's [64,16,16,512], eps 1e-5, held in phase 2) and
  K2:
  6a. train steps at batch 64 on batches of a DeviceTileBuffer (2 slots
      over 4 fp16 shards of 32 flagship tiles with the four products' fp32
      fields at 5% NaN, a swap every 5): 3 warm, then 10 timed, the K1/K2
      counters set to 0 before and read after (launches a step equal to
      the calls of one training forward: 26/4/22); step ms, patches/s,
      peak memory, a profiled step by kind with its busy share, the
      gather's device time; every loss finite, the loss of a fixed batch
      falls over the 13 steps; GroupNormActFn's backward at the head's
      shape against autograd through the plain chain (2''');
  6b. 12 batches of the buffer on the card, swapping every 3, bit for bit
      those of the same buffer on the CPU (spectral and every product);
  6c. cli/train_vae_l2.py ``run`` with configs/demo/flagship_train_l2.yaml's
      values (FLAGSHIP_L2) for 10 steps, once with the device buffer and
      once with the TileLoader, the VAE warm-started from 5b's checkpoint:
      checkpoint, summary/l2_losses.png (drawn by train/png.py: the card's
      machine has no matplotlib), the figure and metrics.json written;
      samples/s and the loader's share of the host wall; one more step
      from the reloaded checkpoint equals the live state's bit for bit;
  6d. one L2 step against the plain path: bf16 at batch 64 under the L1
      loss (each product's loss, the loss and pixel MSE rel 1e-2, each
      head gradient rel L2 5e-2, the VAE's gradients by 5c's rule) and
      fp32 at batch 2 under the L2 loss (1e-4 each).
  then the VAE evaluation and analysis path (the flagship in bf16, the
  weights 5b and 6c trained), K1a, K1b and K2 forward:
  7a. cli/evaluate_reconstruction.run with configs/demo/flagship_eval.yaml's
      values (batch 16, 32 tiles) and pk_err over 5b's checkpoints (steps
      15 and 30) and an fp16 shard of 32 flagship tiles: the JSON and both
      figures written, every metric finite, each checkpoint's mse and
      pk_err within 1e-2 of the same sweep through the plain versions; the
      K1/K2 launches of a batch of 16;
  7b. load_params of 5b's and 6c's checkpoints (and the L2 one's vae.*
      into the base VAE): the posterior mean of 16 tiles bit for bit the
      live weights' (cuDNN deterministic) (a .msgpack full-state resume:
      14d);
  7c. one structured_granule [131, 2048, 1028] through encode_granules'
      encode_granule with decode_roundtrip: the device normalize within
      1e-4 of numpy's and no farther from float64 than numpy's (+1e-5);
      with the granule's own statistics, the latter; the latent within rel
      L2 5e-2 of the plain path; mse/mae/psnr finite and, reduced on the
      card in float64, within 1e-9 of numpy's; normalize ms on the card,
      encode and decode s, reconstruct_raw's and numpy's normalize's host
      wall; the K1/K2 launches of a granule's encode+decode;
  7d. fit_pca on 256 pixels drawn as extract_pca draws them from 7c's crop
      (explained variance within 1e-4 of numpy's eigh), the PCA-RGB figure
      of the granule and its reconstruction written by train/png.py;
  7e. probe_analysis' probe_granule over 2 structured granules [128, 512,
      1028] encoded by 6c's checkpoint, then a linear probe a product with
      flagship_probe.yaml's values: each best validation loss below its
      first epoch's, every R^2 finite;
  and K1a/K1b/K2 against their plain versions at every shape of 7a, 7c and
  7e.
  then the export and data-preparation path:
  8a. infer/export_codec.py's export_codec of the flagship codec with 5b's
      weights (bf16, tile 64x64, 1028 channels), on the card and on the
      CPU, each loaded with load_exported (device None) in a fresh process
      that imports no model code for it; encode and decode at batches 1,
      8 and 16 within rel L2 1e-3 of the eager model (bitwise printed);
      one exported encode+decode at batch 8 launches K1a/K1b/K2 as often
      as the eager one; export and load s, artifact bytes, encode and
      encode+decode ms at batch 8 by CUDA events and host wall beside the
      eager model's;
  8b. on 7c's granule [131, 2048, 1028] and its four products with fill
      values: compute_stats' float64 statistics on the card within rel
      1e-6 of numpy's; prepare_tiles' tile_granule on the card against its
      numpy path with one seeded Generator at prepare_tiles_with_l2.yaml's
      values (64 tiles of 64x64): tiles within 1e-4, L2 tiles bitwise, and
      the draws' positions and flags identical; each timed against numpy.
  then speculation and the online server, from exported GPT-2-small (bf16,
  3d's artifact) with a self-draft and a distinct draft of DistilGPT2's
  shape (6 layers, weights from SEED + 1), k_draft 4; K3 in the draft's
  captured steps, K4 in the paged pools:
  9a. serve_lm's continuous + draft and paged + draft (8 slots, 65 pages)
      over the first 32 of the 64 requests (64 until phase 13 came) and
      scheduler: speculative over the first 8, each
      beside the same scheduler target-only: tokens/s, accept_rate, rounds,
      target passes, K3/K4 launches, greedy agreement with target-only and
      the reference's top-two logit gap at each first difference (reported:
      bf16 near-ties);
  9b. the same in fp32 (the target and the distinct draft exported in
      fp32) over 8 greedy and 4 sampled requests of 32 new tokens: every
      greedy stream equal to target-only's but at a near-tie (a top-two gap
      within F32_TOL), each exception printed;
  9c. OnlineLMServer over the continuous pool, the paged pool (K4 counted)
      and the continuous pool with the distinct draft: 16 requests from 4
      threads at staggered times, each response bitwise the batch mode's;
      one request cancelled mid-flight, a flagged prefix of its stream;
      _serve_http with online: two concurrent POST /v1/completions equal
      batch mode.
  then the exported serving programs (GPT-2-small, bf16, max_seq 1024,
  page 128, decode_chunk 16), exported on the card and on the CPU:
  10. each program's export seconds, the directory's bytes beside the
      weights' (weights.pt <= 1.1x); a fresh process loads every loader
      with device None (first and second load s, memory_allocated across
      them <= 1.1x the weights' bytes), decodes greedily equal to generate
      and imports no tempo_tpu_torch.nn module; each of the 14 programs,
      from both artifacts, bitwise the live model's call at batches 1 and 8
      and two positions, outputs and caches; one captured decode_k replay
      (b=8, K=16), exported and live: CUDA-event ms, torch.profiler's
      kernels, the captured graph's nodes (the program's 2K fewer: it
      gathers bf16 embedding tables where the live step casts the gathered
      fp32 rows), cache addresses kept; the host ms of the eager calls a
      server makes a request (prefill, extend, extend_paged at 128 tokens,
      admit_paged), exported and live; serve_lm continuous and paged over
      the programs beside a live surface: tokens/s, greedy tokens equal,
      K3/K4 launches equal.
  then the diffusion path (configs/training/train_diffusion_latent.yaml's
  and train_flow_latent.yaml's values, the flagship VAE in bf16 from seeded
  weights saved as .pt and frozen, the CUNet [128, 192] in fp32 over its
  16x16x32 latent at batch 64), K1a, K1b and K2 at new shapes and in fp32:
  11a. cli/train_diffusion.run, latent VDM, over 4 fp16 shards of 16
      flagship tiles: 10 steps, a validation, a checkpoint, the panel of 8
      samples over 250 ancestral steps decoded by the VAE; every loss
      finite; one more step from the reloaded checkpoint bit for bit the
      live state's; the K1a/K1b/K2 launches of one step (counters set to 0
      before, read after) equal one VAE encode's plus one CUNet forward's;
      step ms and samples/s by CUDA events, the sampler's seconds, the
      device's busy share over one profiled step (null where the profile
      misses one of the step's counted K1a/K1b/K2 launches);
  11b. the same for latent SFM (euler), and its flow integrated with lm;
  11c. pixel-space VDM, 3 steps at batch 8 on the 64x64x1028 tiles (K2's
      conv_out 64x64x128 -> 1028 in fp32), its panel at 50 steps;
  11d. cli/sample_diffusion.run over 11a's run: 16 samples, 250 steps,
      DDIM (eta 0) and ancestral;
  11e. the CUNet forward (latent batch 64, pixel batch 8, and a volumetric
      dim=3 one, K1 on NDHWC; fp32) through the kernels against the plain
      path; each recorded K1a/K1b/K2 call (bf16 encode, fp32 CUNet) against
      its plain version, timed beside its bound, plain version and library
      calls, as phase 2 holds its own (hold_recorded); one VDM
      loss and its gradients with fixed draws, kernels against plain (the
      bf16 latents, the loss from the same latents, the whole).
  then the trainers' options and the JAX checkpoint bridge (the flagship in
  bf16; K1a, K1b and K2 in the forward):
  12a. cli/train_vae.run in a fresh process over 5 fp16 shards of 8
      flagship tiles at batch 8 for 6 steps, with metrics_jsonl,
      profile_steps [2, 4], async checkpoints every 2 steps, the EMA logged
      every step and a validation of 2 batches every 3: the K1a/K1b/K2
      counters set to 0 before the run and read after (each non-zero), and
      set to 0 where the profile window opens and read where it closes;
      the Chrome trace lists exactly the kernels counted in the window,
      (2 steps + 2 validation batches) x one training forward's; the JSONL
      records are the metrics.json history; ckpt_step=000002/4/6.pt, the
      last bit for bit the trainer's final model and AdamW state;
  12b. the in-place race at batch 64: a sync and an async checkpoint of
      one state, a train step run while the async one is written, 3
      rounds: the two files byte for byte equal, their tensors unlike the
      state after the step; save()'s blocking time sync and async (the
      first async save allocates the pinned buffers the later ones reuse),
      the time until the write is done, a step's time under the write and
      alone;
  12c. every flagship state-dict tensor, a bfloat16 leaf, a float, an int,
      a string, an empty dict and a chunked leaf packed as flax lays a
      checkpoint out (pack_flax), read back by interop/msgpack_reader.py
      bit for bit (the bfloat16 widened exactly): MB/s.
  then the GPT family's options at GPT-2-small's widths (bf16, weights from
  a seed), 13b-d after phase 10 (they read its artifacts), 13a and 13e at
  the end; K3, K4 and K5 on the new paths, each counter set to 0 just
  before a run and read just after:
  13a. MoE training at bench_gpt(n_experts=4)'s shape (4 experts, top-1,
      capacity factor 1.25, [8, 1025] tokens, AdamW 3e-4 / 0.1 / (0.9,
      0.95)): 3 warm, then 5 timed steps, K5f/K5dkv/K5dq 12 a step each;
      step ms, tokens/s, MFU on all and on the active parameters, peak
      memory, the mean moe_aux; the loss falls on the fixed batch; one
      step through K5 against the plain attention, and one top-2 step at 4
      layers, at 4c's tolerances: the bf16 loss, and in fp32 (2 layers,
      batch 2) the loss and every gradient; the bf16 gradients are
      reported beside the tokens whose expert the two paths chose
      differently (bf16 rounding flips routes; fp32 flips none);
  13b. MoE serving: generate of 8 x (64 + 128) tokens captured, K3 12 x
      127, bitwise the eager loop; PagedLMServer over live_paged_surface on
      16 of 3b's requests, K4 counted (no batch-independence gate: the
      capacity depends on the call's token count, JAX's semantics);
  13c. int8: quantize_lm_params of GPT-2-small, the weights' bytes against
      bf16; generate at 3a's shape captured (K3 counted, bitwise eager),
      ms/token beside 3a's bf16; the logits against the bf16 model on the
      dequantized weights; serve_lm paged over the int8 artifact (exported
      in the background with the others) beside the live int8 surface:
      tokens and K4 launches equal;
  13d. beam search: LMServer.beam_batch over 3d's bf16 artifact, 8 prompts
      x width 4 x 32 tokens, K3 counted; width 1 bitwise the greedy stream;
      equal to nn/beam.py beam_search on the live model; one beam_width
      request through _serve_batch and one through _serve_http's POST
      /generate equal to beam_batch of its prompt alone; the host
      scoring's share of the call;
  13e. cli/train_gpt.run at GPT-2-small's widths, 5 steps at batch 8 each:
      LoRA rank 8 over a seeded base checkpoint (the base file unchanged,
      the checkpoint only the adapters, merged_final.pt bitwise the base
      plus s a @ b, K5 counted); dropout 0.1 (finite losses, zero K5: the
      materialized attention; in eval the model is the dropout-0 model bit
      for bit); moments_dtype bfloat16 (exp_avg bf16, 2 bytes a parameter
      less optimizer state than fp32 moments, one step from the reloaded
      checkpoint bitwise the live state's).
  then the rest of the LM family and the connectomics toolkit (phase 14):
  14a. activation taps at GPT-2-small bf16, b 2 x 1024: cached_forward's
      names by kind (JAX's), K5 never launched, its logits bitwise the
      attn_impl "xla" forward's, the K5 forward's loss within 4c's bf16
      tolerance; a w = 1 patch of x_6 from another prompt reproduces its
      downstream captures, a w = 0 patch is bitwise no patch; one captured
      decode step over a 1024-slot cache, K3 x 12, bitwise the plain step;
  14b. untokenized training (in_size 1028, b 8 x 1024 features): one
      forward and backward, K5f/K5dkv/K5dq 12 each, loss and gradients
      against the plain attention path at 4c's tolerances; then the dict-
      embedder mode (x, cond, pos embedders, an x unembedder) at 4 layers;
  14c. a GPT-2-small state dict in the reference and in HF's layout (a
      stand-in .config): logits bitwise the source's, greedy generate from
      the HF import launches K3 and gives the source's tokens;
  14d. JAX-layout full states (written with pack_flax): GPT-2-small's
      masked AdamW after 3 steps, fp32 and bf16 first moments, and the
      flagship VAE's chain(clip, adamw) at batch 64, resumed through
      train_gpt.run / train_vae.run: parameters, moments and step counts
      bitwise the state written, the next step bitwise the live state's
      (K5 counted on the GPT's); write and read MB/s;
  14e. membrane_prob through the default CUNet (fp32) on a 1024 x 1024
      EM-like section, K1a/K1b/K2 counted, rel L2 1e-4 to the plain
      forward; get_seg on the card bitwise the CPU's, its seconds and
      fixpoint steps; vi, error_map, rescan_map; get_freer_device names
      the card.
  then data parallelism and ZeRO-3 (phase 15; two ranks share the one card
  over gloo, NCCL refusing two ranks on one device; FSDP2 needs NCCL's
  all-gather and reduce-scatter on CUDA, so it runs at world 1):
  15a. DDP over 2 rank processes: the flagship VAE (bf16, L2 loss) at a
      global batch of 64 (32 a rank) and the fp32 two-level VAE at 4, 3
      steps of the VAE recipe, every posterior draw a slice of one global
      draw, against this process's 3 steps on the same draws: loss and
      pixel MSE within STEP_BF16_TOL / STEP_F32_TOL, each first-step
      gradient too, the unused down and up convs bitwise; step ms, a gloo
      all-reduce of the gradient bytes beside it, K1a/K1b/K2 launches a
      rank a step;
  15b. FSDP2 at world 1 over NCCL against the unwrapped flagship (bf16,
      batch 64, cuDNN deterministic): parameters bitwise after each of 3
      steps (K2's packed-weight cache is off under FSDP2), peak memory;
  15c. the same for GPT-2-small at 8 x 1024, K5 launches counted;
  15d. train_vae.run (device buffer, partition replicate, then process)
      and train_vae_l2.run under the 2 rank processes at the flagship's
      widths, a global batch of 16, 5 steps: rank 1 writes nothing under
      the run's directory, training_info's n_devices is 2, the last
      checkpoint loads through load_params on one device bitwise both
      ranks' final weights.
Prints the card's name and power limit first, each phase's seconds, each
redesigned kernel's time against its time before the redesign
(KERNEL_PREV, K1_PREV), one {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no
result, when there is no CUDA device or the package is not beside it.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # CUDA-core fp32 rate
SEED = 0
SPIN_CYCLES = 2_000_000            # ~1 ms of device spin at ~1.98 GHz

# Tolerances, kernel vs plain from the same inputs on the card:
# - bf16 outputs: both sides compute in fp32 and round once to bf16, so an
#   element may land one bf16 ulp apart (<= 2^-7 relative); the sums inside
#   differ only in fp32 order.
BF16_TOL = {"atol": 5e-3, "rtol": 2.0 ** -7}
# - fp32 statistics: fp32 sums in another order over up to 262,144 terms.
STATS_TOL = {"atol": 1e-5, "rtol": 1e-4}
# - fp32 kernel paths (TF32 off on the plain side): K2 sums 9*C products in
#   another order.
F32_TOL = {"atol": 1e-4, "rtol": 1e-4}
# - whole model, bf16: ~30 layers each rounding activations to bf16, with
#   one-ulp flips between the two paths compounding: relative L2 error.
MODEL_BF16_REL_L2 = 5e-2
# - whole model, fp32, one tile: fp32 sum order only.
MODEL_F32_REL_L2 = 1e-4
# K3/K4, kernel vs plain, the JAX package's own decode tolerances
# (tests/test_pallas_decode.py:44):
# - fp32: the kernel's online softmax adds in another order (positions split
#   over warps and merged at the end) and scales q before the dot product.
DECODE_F32_TOL = {"atol": 2e-5, "rtol": 2e-5}
# - bf16 q and cache: both sides compute in fp32 and round the output to
#   bf16 once, so an element may land one bf16 ulp apart (2^-6 at |y| < 4).
DECODE_BF16_TOL = {"atol": 2e-2, "rtol": 2e-2}
# - GPT-2-small logits, bf16: 12 layers each rounding activations to bf16,
#   with one-ulp flips of the attention output compounding: relative L2.
LM_BF16_REL_L2 = 5e-2
# - GPT-2-small logits, fp32 model and caches: fp32 sum order only.
LM_F32_REL_L2 = 1e-4

# K5, kernel vs plain from the same inputs on the card:
# - O: both sides accumulate in fp32 and round once; the kernel rounds p to
#   bf16 for p.V (as flash kernels do), so an element may land one bf16 ulp
#   apart (2^-6 at |y| < 4); fp32: sum order only.
FLASH_O_TOL = {"bfloat16": {"atol": 2e-2, "rtol": 0.0},
               "float32": {"atol": 2e-5, "rtol": 2e-5}}
# - lse: fp32 in both, another order of the online softmax.
FLASH_LSE_ATOL = 1e-3
# - dq/dk/dv: relative L2; the kernel rounds p and ds to bf16 for the
#   second products. The denominator is floored at an RMS of 1e-3: at t = 1
#   the exact dq and dk are 0 (one key, ds = dO.v - dO.o = 0) and both sides
#   hold only rounding noise.
FLASH_GRAD_REL = {"bfloat16": 2e-2, "float32": 1e-4}
# - the whole train step, K5 against the plain attention: bf16 rounds
#   activations at every layer (loss rel 1e-2, each gradient rel L2 5e-2);
#   fp32 differs in sum order only (1e-4 each).
STEP_BF16_TOL = {"loss": 1e-2, "grad": 5e-2}
STEP_F32_TOL = {"loss": 1e-4, "grad": 1e-4}
# The training path, as tools/bench_toolkit.py bench_gpt measures the JAX
# package: GPT-2-small, batch 8 x 1024 tokens, AdamW lr 3e-4, wd 0.1.
TRAIN_BATCH, TRAIN_WARM, TRAIN_STEPS, TRAINER_STEPS = 8, 3, 10, 30
# The VAE training path, as bench.py bench_train measures the JAX package:
# the flagship (VAE_MODEL = {}: build_vae's defaults) at batch 64 of
# [64,64,1028] tiles, the optimizer of configs/training/
# train_vae_default.yaml (AdamW lr 1e-4, betas (0.9, 0.95), weight decay
# 0.05) after the VAE recipe's global-norm clip at 1.0; 3 warm steps, then
# 10 timed. The Trainer takes 30 steps at batch 8 over a TileLoader of 5
# shards of 8 flagship tiles in fp16 (336 MB), a buffer of 24. The fp32
# step check (5c) cuts the depth to two levels of three, at batch 2.
VAE_MODEL: dict = {}
VAE_F32_MODEL = {"chs": [512, 256]}
VAE_TRAIN_BATCH, VAE_TRAINER_BATCH, VAE_TRAINER_STEPS = 64, 8, 30
VAE_SHARDS, VAE_TILES_PER_SHARD, VAE_BUFFER = 5, 8, 24
# The K1/K2 Functions' backward against autograd through the plain chain
# from the same inputs: the same recompute (cuDNN deterministic), so the
# fp32 tolerance, relative L2, holds the saved-tensor plumbing.
FN_BWD_REL = 1e-4
# The VAE step against the plain path (5c). Under the L1 reconstruction
# loss of the flagship, d loss / d recon is sign(recon - x): any change of
# rounding in the forward flips it at the elements where recon and x
# nearly meet, a fraction f of them, and moves every gradient by ~2 sqrt(f)
# relative L2 whatever the kernels do: beyond STEP_F32_TOL in fp32 and
# beyond STEP_BF16_TOL in bf16 on the card (5c prints f). The
# per-gradient tolerances are therefore held with the flagship's widths
# under the smooth L2 loss, STEP_BF16_TOL and STEP_F32_TOL as for GPT; the
# flagship's L1 step in bf16 is held to STEP_BF16_TOL in its loss and
# pixel MSE, and each of its gradients against the same step in fp32 (the
# plain path, TF32 off, same weights, batch and noise): within
# STEP_BF16_TOL["grad"] of it, or no more than VAE_BF16_ACC times as far
# from it as the plain bf16 path's gradient is.
VAE_BF16_ACC = 1.25
# The L2-supervised VAE training path (phase 6), as configs/demo/
# flagship_train_l2.yaml trains it: the flagship VAE and the 512-512-4 head
# in bf16 at batch 64 (VAE_TRAIN_BATCH), the optimizer of 5a, batches from
# a DeviceTileBuffer of fp16 flagship shards with the four products' fp32
# fields at 5% NaN (make_tile_shards): 2 slots over 4 shards of 32 tiles
# (~270 MB each), a swap every 5 batches. 6b compares 12 batches of a
# buffer swapping every 3 (three swaps) with the CPU buffer's. 6c runs the
# CLI with FLAGSHIP_L2 (the yaml's values; the card's machine has no yaml)
# for 10 steps (20 until phase 9 came; PERF.md section 4), logging every 5
# and plotting every 10 so that the curves are drawn, and saving at the
# last step. 6d's fp32 check keeps the three
# levels (the head reads a latent 4x smaller than the tile, as the pooled
# targets are) at batch 2.
VAE_L2_HIDDEN = (512, 512)
VAE_L2_SHARDS, VAE_L2_TILES, VAE_L2_SLOTS, VAE_L2_SWAP = 4, 32, 2, 5
VAE_L2_EQ_SWAP, VAE_L2_EQ_BATCHES, VAE_L2_CLI_STEPS = 3, 12, 10
FLAGSHIP_L2 = {
    "seed": 42,
    "data": {"batch_size": 64, "loader": "device", "buffer_slots": 2,
             "swap_every": 60, "buffer_dtype": "float16",
             "loader_threads": 1, "val_num_workers": 1,
             "min_buffer_size": 16, "val_min_buffer_size": 8},
    "model": {"shape": [1028, 64, 64], "embed_dim": 32,
              "chs": [512, 256, 128], "mid_attn": True,
              "num_res_blocks": 1, "z_channels": 32, "double_z": True,
              "n_attention_heads": 4, "norm_groups": 8, "kl_weight": 1e-6,
              "nll_loss_type": "l1", "compute_dtype": "bfloat16"},
    "l2": {"components": ["NO2", "O3TOT", "HCHO", "CLDO4"],
           "weights": {"NO2": 0.1, "O3TOT": 0.1, "HCHO": 0.1, "CLDO4": 0.1},
           "mlp_hidden": [512, 512]},
    "optimizer": {"lr": 0.0001, "betas": [0.9, 0.95], "weight_decay": 0.05},
    "training": {"n_steps": 300, "save_every": 300, "val_every": 100000,
                 "log_every": 50, "plot_every": 100000},
}
# The analysis path (phase 7). 7a runs cli/evaluate_reconstruction.run with
# configs/demo/flagship_eval.yaml's values (batch 16, 32 validation tiles,
# mse, mae, psnr) and pk_err, over 5b's two checkpoints (steps 15 and 30)
# and one fp16 shard of 32 flagship tiles; each checkpoint's mse and pk_err
# within ANALYSIS_SWEEP_REL of the same sweep through the plain versions
# (bf16 through ~30 layers, as MODEL_BF16_REL_L2, on a mean of 32 tiles).
ANALYSIS_EVAL = {
    "output_dir": "eval_reconstruction", "seed": 42,
    "data": {"max_val_samples": 32},
    "model": {"training_config_path": "config.yaml"},
    "evaluation": {"batch_size": 16, "evaluate_all": True,
                   "metrics": ["mse", "mae", "psnr", "pk_err"]},
    "plotting": {"plot_metrics": True, "dpi": 150},
}
ANALYSIS_SWEEP_REL = 1e-2
# 7c: one structured granule at the full TEMPO shape (cropped to 128 x
# 2048), normalized with the per-channel statistics a stats file would
# hold for it. The device normalize within ANALYSIS_NORM_ATOL of numpy's
# (z in [-10, 10]; an ulp of the fp32 log over a channel's std), and no
# farther (max abs) from a float64 normalize than numpy's fp32 one is, plus
# ANALYSIS_NORM_F64_SLACK; with the granule's own statistics, the latter
# (numpy's fp32 sums over 268,288 pixels stray further); the metrics
# reduced on the card in float64 within ANALYSIS_METRICS_REL of numpy's
# float64 (another summation order over 270M elements).
ANALYSIS_GRANULE = (131, 2048, 1028)
ANALYSIS_NORM_ATOL, ANALYSIS_NORM_F64_SLACK = 1e-4, 1e-5
ANALYSIS_METRICS_REL = 1e-9
# 7d: configs/analysis/extract_pca_components.yaml's sampling (256 pixels,
# seed 42, 3 components); the explained variance within ANALYSIS_PCA_REL
# of numpy's eigen-decomposition of the samples' covariance (two float64
# factorizations).
ANALYSIS_PCA = {"pixels_per_file": 256, "seed": 42, "n_components": 3}
ANALYSIS_PCA_REL = 1e-4
# 7e: configs/demo/flagship_probe.yaml's values over 2 structured granules
# of 512 tracks (2048 cut to 512 for the phase's time, and 4 granules to 2
# for phase 9's; PERF.md section 4).
ANALYSIS_PROBE = {
    "seed": 42,
    "probe": {"n_pixels_per_file": 500, "test_split": 0.2, "max_epochs": 40,
              "learning_rate": 0.001, "weight_decay": 0.01,
              "batch_size": 256},
    "components": {
        "NO2": {"field": "vertical_column_troposphere", "scale": 1.0e15,
                "norm_type": "asinh"},
        "O3TOT": {"field": "column_amount_o3", "scale": 1.0,
                  "norm_type": "zscore"},
        "HCHO": {"field": "vertical_column", "scale": 1.0e16,
                 "norm_type": "asinh"},
        "CLDO4": {"field": "cloud_fraction", "scale": 1.0,
                  "norm_type": "logit"}},
    "visualization": {"n_examples": 100},
}
ANALYSIS_PROBE_GRANULES, ANALYSIS_PROBE_SHAPE = 2, (128, 512, 1028)
# The export and data-preparation path (phase 8). 8a exports the flagship
# codec with 5b's weights on the card and on the CPU, loads each in a fresh
# process and runs it at EXPORT_BATCHES against the eager model: the same
# ops on the same inputs, so bitwise is expected; EXPORT_REL_L2 leaves room
# for a cuDNN algorithm picked anew in another process.
EXPORT_BATCHES = (1, 8, 16)
EXPORT_REL_L2 = 1e-3
EXPORT_ROUNDS = 3
# 8a also exports a tiny codec (tests/test_torch_export_codec.py's config,
# in bf16) on the card and loads it on the CPU: the CPU kernels are the
# plain versions the CPU's eager model runs, so within EXPORT_CPU_ATOL of it.
EXPORT_TINY = dict(shape=[8, 16, 16], chs=[12, 8, 8], z_channels=4,
                   embed_dim=4, n_attention_heads=2, norm_groups=4,
                   compute_dtype="bfloat16")
EXPORT_TINY_TILE, EXPORT_TINY_BATCHES, EXPORT_CPU_ATOL = 16, (2, 5), 1e-6
# 8b: configs/data_preparation/prepare_tiles_with_l2.yaml's values, on 7c's
# granule [131, 2048, 1028] and its four products with 5% fill values. The
# device statistics within PREP_STATS_REL of numpy's float64 (the log in
# fp32 on each side); the device tiles within ANALYSIS_NORM_ATOL of
# numpy's (the device normalize's tolerance, 7c); positions, flags and L2
# tiles exact.
PREP_TILES = {
    "processing": {"band": "band_290_490_nm", "tile_size": [64, 64],
                   "tiles_per_file": 64, "n_spectral": 1028,
                   "min_radiance": 1.0, "clip_min": -10, "clip_max": 10},
    "l2": {"components": ["NO2", "O3TOT", "HCHO", "CLDO4"],
           "scales": {"NO2": 1.0e15, "O3TOT": 1.0, "HCHO": 1.0e16,
                      "CLDO4": 1.0},
           "norm_types": {"NO2": "asinh", "O3TOT": "zscore",
                          "HCHO": "asinh", "CLDO4": "logit"}},
}
PREP_STATS_REL = 1e-6
# The head's GroupNorm shape on the L2 path, held in phase 2 (batch 64 of
# 16x16 latents, 512 channels, bf16, eps 1e-5).
K1_HEAD = ((64, 16, 16, 512), 1e-5)
# Each redesigned kernel's time a call before its redesign, read by this
# script alone with a cold L2: K5f, K5dkv, K5dq at [8,1024,12,64] bf16
# causal (mma.sync with load-then-compute staging and a transposed second
# copy of a B operand); K3 and K4 at their average call on the LM path (one
# block per (row, kv head) walking the whole row).
KERNEL_PREV = {"K5f": 0.2148, "K5dkv": 0.4309, "K5dq": 0.2480,
               "K3": 0.01055, "K4": 0.0166,
               "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
# K1's times a main-path run before its redesign (partial sums, then a fold
# kernel; an elementwise grid-stride apply), read the same way.
K1_PREV = {"K1a": 1.490, "K1b": 0.038, "k1_whole_ms": 0.075}
# K1's edge shapes: HW 1, 7x9 and 3x1000; C 128 and 40 in 8 groups (5
# channels a group: not a whole 16-byte pack, the element path); B 1 and 8.
K1_EDGE = [(b, h, w, c) for b in (1, 8) for h, w in ((1, 1), (7, 9), (3, 1000))
           for c in (128, 40)]
# The LM serving path, as tools/bench_toolkit.py measures the JAX package:
# bench_decode(cache_len=1024) for generate, bench_workload for the server.
LM_BATCH, LM_PROMPT, LM_NEW, LM_CACHE = 8, 64, 128, 1024
LM_REQUESTS, LM_SLOTS, LM_K, LM_PAGE, LM_CHUNK = 64, 8, 16, 128, 128
# 65 pages hold every slot's whole window. bench_workload's 41 pages do not
# force a preemption with this mix (the roomy run's peak is 33 pages), so
# the tight run takes 33, the largest pool that preempts: for greedy
# requests without eos the schedule depends only on lengths and budgets.
LM_POOLS = {"roomy": 65, "tight": 33}
# Phase 9: speculation over GPT-2-small exported (3d's model: SPEC_TARGET
# overrides nothing) with a self-draft and a distinct draft of DistilGPT2's
# published shape (6 layers of GPT-2-small's widths; weights from SEED + 1),
# k_draft SPEC_K. 9a times the first SPEC_REQUESTS of the 64 requests
# (continuous and paged pools; all 64 until phase 13 took the time, 32
# until phase 15 did) and
# the first SPEC_BATCH1 (the batch-1 scheduler) in bf16; 9b holds SPEC_F32
# (greedy, sampled) requests cut to SPEC_F32_NEW new tokens in fp32; 9c
# serves ONLINE_REQS requests from ONLINE_THREADS threads and cancels an
# ONLINE_CANCEL_NEW-token request after ONLINE_CANCEL_AFTER rounds.
SPEC_TARGET: dict = {}
SPEC_DRAFT = {"n_layer": 6}
SPEC_K, SPEC_BATCH1, SPEC_F32, SPEC_F32_NEW = 4, 8, (4, 2), 32
SPEC_REQUESTS = 16
SPEC_ROUNDS = 10  # 9a's round breakdown: rounds timed each way
ONLINE_REQS, ONLINE_THREADS = 16, 4
ONLINE_CANCEL_NEW, ONLINE_CANCEL_AFTER = 256, 4
# The LM artifacts (infer/export_lm.py's torch.export programs), each
# exported once by a background process started with the run (its CPU work
# overlaps phases 1-3) and shared by 3d, 9 and 10: name -> (model overrides,
# weight seed, compute dtype, the device that traces, decode_chunk,
# page_size). The fp32 target serves only 9b's schedulers, which read no
# fused program; the drafts serve only dense draft calls.
LM_EXPORTS = {
    "target_bf16": (SPEC_TARGET, SEED, "bfloat16", "cuda", LM_K, LM_PAGE),
    "target_bf16_cpu": (SPEC_TARGET, SEED, "bfloat16", "cpu", LM_K,
                        LM_PAGE),
    "target_fp32": (SPEC_TARGET, SEED, "float32", "cuda", 0, LM_PAGE),
    "draft_bf16": (SPEC_DRAFT, SEED + 1, "bfloat16", "cuda", 0, 0),
    "draft_fp32": (SPEC_DRAFT, SEED + 1, "float32", "cuda", 0, 0),
    # 13c: the target's weights quantized (quantize_lm_params) and exported
    "target_int8": ({"quantize": "int8"}, SEED, "bfloat16", "cuda", LM_K,
                    LM_PAGE),
}
# Phase 10: each exported program against the live model's call at two
# batches and two positions; a fresh process's loads and greedy decode of
# PROGRAMS_NEW tokens after an [8, LM_PROMPT] prompt.
# Positions: caches prefilled to PROGRAMS_POS, rows PROGRAMS_POS // 30
# apart; a row cache of PROGRAMS_POS // 6.
PROGRAMS_BATCHES, PROGRAMS_NEW, PROGRAMS_POS = (1, 8), 32, 300
# 3d profiles each scheduler over the first requests of the mix (prompts
# 32-128), not all 64: the profiler's record of a whole run takes minutes
# (8 requests until phase 9 came, ~40 s of 3d; PERF.md section 4).
LM_PROFILED = 4
# Phase 11: the diffusion path with configs/training/
# train_diffusion_latent.yaml's values (DIFF_LATENT; the card's machine has
# no yaml) and train_flow_latent.yaml's (DIFF_FLOW, family sfm), and
# configs/analysis/sample_diffusion.yaml's (DIFF_SAMPLE): the flagship VAE
# (DIFF_VAE, bf16) from seeded weights saved as the port's .pt (the yamls
# name a JAX .msgpack, which phase 12c reads), frozen; the CUNet chs
# [128, 192], t_embedding_dim 128, over its 16x16x32 latent at batch 64;
# DIFF_SHARDS fp16 shards of DIFF_TILES flagship tiles (make_tile_shards)
# for train and validation. Cuts (PERF.md section 4): 10 steps of 100,000,
# the validation and the plots at step 10 and the log every 5 steps (the
# yamls: val_every 100, plot_every 50, log_every 10; the summary plots need
# two logged points); 11c, pixel space, 3 steps at batch 8 (logged each
# step) and its panel at 50 sampler steps of 250. DIFF_TIMED steps timed by
# CUDA events, one step profiled after a lead of an idle card inside the
# session (DIFF_PROFILE_LEADS_S).
DIFF_VAE = {"shape": [1028, 64, 64], "embed_dim": 32, "chs": [512, 256, 128],
            "mid_attn": True, "num_res_blocks": 1, "z_channels": 32,
            "double_z": True, "n_attention_heads": 4, "norm_groups": 8,
            "compute_dtype": "bfloat16"}
DIFF_LATENT = {
    "seed": 42,
    "data": {"batch_size": 64, "loader_threads": 2, "min_buffer_size": 500,
             "val_min_buffer_size": 100},
    "latent": {"vae_model": DIFF_VAE, "scale": 1.0},
    "score_model": {"chs": [128, 192], "norm_groups": 8,
                    "n_attention_heads": 4, "t_embedding_dim": 128,
                    "dropout_prob": 0.0},
    "diffusion": {"noise_schedule": "fixed_linear", "gamma_min": -13.3,
                  "gamma_max": 5.0, "antithetic_time_sampling": True,
                  "data_noise": 0.001},
    "optimizer": {"lr": 0.0001, "betas": [0.9, 0.95], "weight_decay": 0.05},
    "training": {"n_steps": 10, "save_every": 5000, "val_every": 10,
                 "log_every": 5, "plot_every": 10},
    "sampling": {"n_samples": 8, "n_steps": 250},
}
DIFF_FLOW = dict({k: v for k, v in DIFF_LATENT.items() if k != "diffusion"},
                 family="sfm", sampling={"n_samples": 8, "n_steps": 250,
                                         "method": "euler"})
DIFF_PIXEL = dict({k: v for k, v in DIFF_LATENT.items() if k != "latent"},
                  data=dict(DIFF_LATENT["data"], batch_size=8),
                  training={"n_steps": 3, "save_every": 5000, "val_every": 3,
                            "log_every": 1, "plot_every": 3},
                  sampling={"n_samples": 8, "n_steps": 50})
DIFF_SAMPLE = {"n_samples": 16, "n_steps": 250, "seed": 0}
DIFF_SHARDS, DIFF_TILES, DIFF_TIMED = 4, 16, 5
# After ~10 minutes of earlier phases, the profiler drops the records of the
# first device work of a session: a latent step's first ~27 kernels (its
# encode's) with the step started at once, its first ~16 with the step
# started 0.2 s into the session; a fresh process lists them all. A drift
# of the device's timestamps against the session's clock would do that. The
# step is profiled after each lead in turn until its profile lists every
# K1a/K1b/K2 launch that the counters gave a step; only such a profile
# gives a busy share.
DIFF_PROFILE_LEADS_S = (0.5, 2.0, 5.0)
# 11e's volumetric CUNet (dim=3, no mid attention): K1 on NDHWC, then the
# 3x3x3 conv, at DIFF_VOLUME_BATCH volumes of this shape.
DIFF_VOLUME_SHAPE, DIFF_VOLUME_BATCH = (8, 16, 16, 32), 4
DIFF_TILE = (64, 64, 1028)        # the flagship tile, as DIFF_VAE's shape
DIFF_LATENT_SHAPE = (16, 16, 32)  # its latent: 4x smaller, embed_dim 32
# 11e, one VDM loss and its gradients through the kernels against the plain
# path (fixed posterior noise, times and noises; the CUNet's zero-init convs
# re-drawn, 8 flagship tiles): the latents come from the bf16 encode, ~20
# layers each rounding activations to bf16, so they agree to
# MODEL_BF16_REL_L2; from the same latents the fp32 CUNet differs in sum
# order only (STEP_F32_TOL); the whole loss carries the latents'
# difference through an fp32 network and a smooth loss, STEP_BF16_TOL.
DIFF_LOSS_BATCH = 8
# Phase 12, the trainers' options and the JAX checkpoint bridge. 12a runs
# cli/train_vae.run with every option in a fresh child process (a fresh
# process's profiler lists every kernel: PERF.md section 6): the
# flagship (VAE_MODEL, bf16) at batch OPTS["batch"] over VAE_SHARDS fp16
# shards of VAE_TILES_PER_SHARD flagship tiles (5b's), OPTS["steps"] steps,
# metrics_jsonl, profile_steps OPTS["profile"] (the window holds steps 3
# and 4 and step 3's validation), async checkpoints every 2 steps, the EMA
# logged every step, a validation every 3 steps of OPTS["n_val"] batches
# (Trainer.n_val_batches; the CLI has no key for it). 12b takes a sync and
# an async checkpoint of 5a's state at batch VAE_TRAIN_BATCH, a train step
# running while the async one is written, OPTS["rounds"] times. 12c packs
# every flagship state-dict tensor, a bfloat16 leaf, scalars, an empty dict
# and a chunked leaf as flax lays them out and reads them back through
# interop/msgpack_reader.py.
OPTS = {"batch": 8, "steps": 6, "profile": [2, 4], "save_every": 2,
        "val_every": 3, "n_val": 2, "rounds": 3}
# Phase 13, the GPT family's options at GPT-2-small's widths (OPT_MODEL
# overrides TransformerConfig's GPT-2-small defaults: none on the card),
# bf16, weights from SEED. 13a: bench_gpt(n_experts=4)'s MoE training
# (MOE_MODEL: top-1, capacity factor 1.25; TRAIN_BATCH x 1025 tokens, AdamW
# 3e-4, wd 0.1, betas (0.9, 0.95)), MOE_WARM warm then MOE_STEPS timed
# steps, one step against the plain attention and one top-2 step at
# MOE_TOP2_LAYERS layers (4c's tolerances, moe_step_vs_plain). 13b: MoE generate at 3a's shape
# and PagedLMServer over the first OPT_REQUESTS of 3b's requests. 13c: int8
# at bench_decode(quantize=True)'s shape (3a's), its logits against the
# bf16 model on the dequantized weights (INT8_DEQ_REL_L2: bf16 rounding in
# another order at the tied head and the bias adds, as LM_BF16_REL_L2), and
# serve_lm paged over the int8 artifact ('target_int8') beside the live
# int8 surface. 13d: beam_batch over 3d's bf16 artifact, BEAM_BATCH
# prompts of LM_PROMPT tokens x width BEAM_WIDTH x BEAM_NEW tokens. 13e:
# train_gpt.run with LoRA (rank OPT_LORA_RANK over a seeded base), dropout
# OPT_DROPOUT and moments_dtype bfloat16, OPT_STEPS steps each at batch
# OPT_BATCH on a synthetic stream of OPT_STREAM tokens.
OPT_MODEL: dict = {}
MOE_MODEL = {"n_experts": 4, "expert_top_k": 1, "expert_capacity_factor": 1.25}
MOE_WARM, MOE_STEPS, MOE_TOP2_LAYERS = 3, 5, 4
INT8_DEQ_REL_L2 = 5e-2
OPT_REQUESTS = 16
BEAM_BATCH, BEAM_WIDTH, BEAM_NEW = 8, 4, 32
OPT_STEPS, OPT_BATCH, OPT_LORA_RANK, OPT_DROPOUT = 5, 8, 8, 0.1
OPT_STREAM = 200_000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ptxas_lines(build_log: str, smem_bytes, k2_config) -> list[str]:
    """One line per kernel from nvcc's -Xptxas -v output: its name (for the
    tempo::flash, tempo::gn_conv, decode and K1 (tempo::gn) kernels with
    their template arguments, else as mangled), registers, static shared memory, spill
    bytes, and for the bf16 flash kernels and K2's bf16 instantiations the
    dynamic shared memory a block asks for (``smem_bytes(pass, hd)``;
    ``k2_config(args)`` gives the configuration's name and bytes)."""

    passes = {"fwd_bf16": 0, "dkv_bf16": 1, "dq_bf16": 2}
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '_ZN5tempo(\S+)'", line)
        if m:
            name, dyn = m.group(1), ""
            f = re.search(r"^5flash\d+([a-z0-9_]+?)I(\S*?)EEv", name)
            g = re.search(r"^7gn_conv\d+([a-z0-9_]+?)(?:I(\S*?)EEv|E)", name)
            d = re.search(r"^\d+(decode_[a-z]+)(?:I(\S*?)EEv|E)", name)
            k1 = re.search(r"^\d+(gn_(?:stats|apply)_kernel)I(\S*?)EEv", name)
            if k1:
                args = re.findall(r"L[ib](\d+)E", k1.group(2))
                args.insert(0, "bf16" if "bfloat16" in k1.group(2) else "f32")
                name = f"tempo::gn {k1.group(1)}<{','.join(args)}>"
            elif d:
                targs = d.group(2) or ""
                args = re.findall(r"L[ib](\d+)E", targs)
                if targs:
                    args.insert(0, "bf16" if "bfloat16" in targs else "f32")
                name = f"tempo::decode {d.group(1)}" + (
                    f"<{','.join(args)}>" if args else "")
            elif f:
                args = re.findall(r"L[ib](\d+)E", f.group(2))
                name = f"tempo::flash {f.group(1)}<{','.join(args)}>"
                if f.group(1) in passes:
                    dyn = (f", {smem_bytes(passes[f.group(1)], int(args[0]))}"
                           f" bytes dynamic smem")
            elif g:
                args = re.findall(r"L[ib](\d+)E", g.group(2) or "")
                name = f"tempo::gn_conv {g.group(1)}"
                if args:
                    config, nbytes = k2_config(tuple(map(int, args)))
                    name += f"<{','.join(args)}> ({config})"
                    dyn = f", {nbytes} bytes dynamic smem"
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            used = line.split(":", 1)[1].strip()
            out.append(f"{name}: {used}; {spill}{dyn}")
            name = None
    return out


def sass_counts(library_path: str, kernels: tuple) -> dict:
    """{kernel: (HGMMA, HMMA)}: the warpgroup and warp tensor-core
    instructions in the SASS of each wgmma kernel whose mangled name holds
    one of ``kernels`` (``cuobjdump -sass`` of the built library)."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                          library_path], capture_output=True, text=True,
                         timeout=300)
    if out.returncode:
        fail(f"cuobjdump failed: {out.stderr.strip()[:500]}")
    counts = {}
    for fn in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        name = fn.split("\n", 1)[0]
        m = re.search(r"(%s)ILi(\d+)E" % "|".join(kernels), name)
        if m:
            counts[f"{m.group(1)}<{m.group(2)}>"] = (fn.count("HGMMA"),
                                                   fn.count("HMMA"))
    return counts


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call, with
    the 50 MB L2 flushed before each (the path's callers find it cold). The
    card is kept busy (~1 ms spin) until the call is enqueued, so the window
    holds the call's device time and not the host's launch latency."""
    import torch

    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def max_err(got, want, tol) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within atol + rtol*|want|)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch_all_finite(g)) and bool(
        (diff <= tol["atol"] + tol["rtol"] * w.abs()).all())
    return float(diff.max()), ok


def torch_all_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def rel_l2(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the plain versions of K1 and K2 (on the card)
    for the comparison; the port itself never does this."""
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv
    from tempo_tpu_torch.ops.norms import group_norm

    saved = (cuda_gn.fused_group_norm_act, cuda_gn_conv.gn_act_conv3x3)

    def gn_plain(x, scale, bias, num_groups, eps=1e-6, act="gelu"):
        return group_norm(x, num_groups, scale, bias, eps, act)

    def conv_plain(x, scale, bias, weight, conv_bias, num_groups, eps=1e-6,
                   act="gelu", packed=None):
        return cuda_gn_conv.gn_act_conv3x3_plain(
            x, scale, bias, weight, conv_bias, num_groups, eps, act)

    cuda_gn.fused_group_norm_act = gn_plain
    cuda_gn_conv.gn_act_conv3x3 = conv_plain
    try:
        yield
    finally:
        cuda_gn.fused_group_norm_act, cuda_gn_conv.gn_act_conv3x3 = saved


@contextlib.contextmanager
def recording(calls: dict, run: str):
    """Record the argument shapes and type of every kernel call the path
    makes, each tagged with the run (tile batch, granule, ...) that made
    it."""
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

    saved = (cuda_gn.gn_stats, cuda_gn.gn_apply, cuda_gn_conv.gn_act_conv3x3)

    def stats(x, num_groups, eps=1e-6):
        calls["K1a"].append(((tuple(x.shape), str(x.dtype)[6:], num_groups,
                              eps), run))
        return saved[0](x, num_groups, eps)

    def apply(x, st, scale, bias, act=None):
        calls["K1b"].append(((tuple(x.shape), str(x.dtype)[6:], act), run))
        return saved[1](x, st, scale, bias, act)

    def conv(x, scale, bias, weight, conv_bias, num_groups, eps=1e-6,
             act="gelu", packed=None):
        calls["K2"].append(((tuple(x.shape), str(x.dtype)[6:],
                             weight.shape[0], num_groups, eps, act), run))
        return saved[2](x, scale, bias, weight, conv_bias, num_groups, eps,
                        act, packed)

    cuda_gn.gn_stats, cuda_gn.gn_apply, cuda_gn_conv.gn_act_conv3x3 = (
        stats, apply, conv)
    try:
        yield
    finally:
        cuda_gn.gn_stats, cuda_gn.gn_apply, cuda_gn_conv.gn_act_conv3x3 = saved


@contextlib.contextmanager
def plain_decode():
    """Route the GPT through the plain versions of K3 and K4 (on the card)
    for the comparison; the port itself never does this."""
    from tempo_tpu_torch.ops import cuda_decode

    saved = (cuda_decode.decode_attention, cuda_decode.paged_decode_attention)
    cuda_decode.decode_attention = cuda_decode.decode_attention_plain
    cuda_decode.paged_decode_attention = cuda_decode.paged_decode_attention_plain
    try:
        yield
    finally:
        (cuda_decode.decode_attention,
         cuda_decode.paged_decode_attention) = saved


@contextlib.contextmanager
def recording_decode(calls: dict, run: str):
    """Record every K3/K4 call the LM path makes: argument shapes and types,
    and copies (on the device, no host sync) of its positions and table."""
    from tempo_tpu_torch.ops import cuda_decode

    saved = (cuda_decode.decode_attention, cuda_decode.paged_decode_attention)

    def dense(q, ck, cv, pos, block_k=256):
        key = (tuple(q.shape), tuple(ck.shape), q.dtype, ck.dtype)
        calls["K3"].append((key, run, pos.clone(), None))
        return saved[0](q, ck, cv, pos, block_k)

    def paged(q, pk, pv, table, pos):
        key = (tuple(q.shape), tuple(pk.shape), tuple(table.shape), q.dtype,
               pk.dtype)
        calls["K4"].append((key, run, pos.clone(), table.clone()))
        return saved[1](q, pk, pv, table, pos)

    cuda_decode.decode_attention = dense
    cuda_decode.paged_decode_attention = paged
    try:
        yield
    finally:
        (cuda_decode.decode_attention,
         cuda_decode.paged_decode_attention) = saved


def device_kernels(fn, sessions: int = 3) -> list:
    """The device kernels (and copies) one ``fn()`` runs, by torch.profiler.

    A profiler session that lists no device activity at all is repeated, up
    to ``sessions`` of them: on an H100 the first session of a process has
    once listed none around a call that launched its kernel. Where every
    session lists none, the call's nodes are read from a CUDA graph captured
    around it instead (``graph_nodes``); fails where that shows none
    either."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for session in range(1, sessions + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
        print(f"[kernels] torch.profiler session {session} of {sessions} "
              f"listed no device activity for one call", flush=True)
    names = graph_nodes(fn)
    print(f"[kernels] the call's nodes, read from a captured CUDA graph "
          f"instead: {len(names)}", flush=True)
    if not names:
        fail("neither torch.profiler nor a captured CUDA graph shows device "
             "work for one call")
    return names


def graph_nodes(fn) -> list:
    """The nodes of a CUDA graph captured around one ``fn()``, as the labels
    of the graph's DOT dump (a kernel node's label names its function).
    ``fn`` runs once on the capture's stream first, so that what it sets up
    for a stream is made outside the graph."""
    import tempfile

    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the dump
    with torch.cuda.graph(graph, stream=stream):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "graph.dot"
        graph.debug_dump(str(path))
        dot = path.read_text()
    del graph
    # node definitions start a line with their quoted name and "["; edges
    # start theirs with a name and "->"
    starts = list(re.finditer(r'^\s*"([^"]+)"\s*\[', dot, re.M))
    ends = [m.start() for m in starts[1:]] + [len(dot)]
    return [" ".join(dot[m.end():end].split())
            for m, end in zip(starts, ends)]


def decode_tol(dtype) -> dict:
    import torch

    return DECODE_F32_TOL if dtype == torch.float32 else DECODE_BF16_TOL


def decode_bytes(q, cache_elem: int, kv: int, live) -> int:
    """Bytes a decode-attention call must move: each row's live keys and
    values read once, q read once, the output written once."""
    hd = q.shape[-1]
    return (2 * sum(live) * kv * hd * cache_elem
            + 2 * q.numel() * q.element_size())


def lm_workload(vocab: int):
    """bench_workload's request mix (tools/bench_toolkit.py:573-582):
    prompts of 32 + 32 * (i % 16) tokens, budgets 64 + (i * 17) % 65, token
    ids from the same seeded stream (after its 8 init tokens)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    rng.integers(0, vocab, (1, 8), dtype=np.int32)
    lengths = [32 + 32 * (i % 16) for i in range(LM_REQUESTS)]
    budgets = [64 + (i * 17) % 65 for i in range(LM_REQUESTS)]
    return [{"tokens": rng.integers(0, vocab, (n,)).tolist(), "n_tokens": b}
            for n, b in zip(lengths, budgets)]


def lm_step_logits(model, dev, dtype, paged: bool):
    """A cache state (an [8, 512] prompt ingested through the plain path)
    and a function computing one decode step's logits from it. The step
    writes position pos before it reads, so the state stays the same across
    calls."""
    import numpy as np
    import torch

    from tempo_tpu_torch.nn.transformer import init_cache, init_paged_cache

    cfg = model.config
    rng = np.random.default_rng(SEED + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.in_size, (8, 512))).to(dev)
    with torch.no_grad():
        if paged:
            table = (1 + torch.randperm(64, device=dev)).reshape(8, 8).to(
                torch.int32)
            cache = tuple((pk, pv, table) for pk, pv, _ in init_paged_cache(
                cfg, 8, 65, LM_PAGE, dtype, LM_CACHE, dev))
            model(toks, cache=cache,
                  input_pos=torch.zeros(8, dtype=torch.int32, device=dev))
            pos = torch.tensor([512, 400, 300, 256, 255, 128, 127, 1],
                               dtype=torch.int32, device=dev)
        else:
            cache = init_cache(cfg, 8, dtype, LM_CACHE, dev)
            model(toks, cache=cache, input_pos=0)
            pos = torch.full((), 512, dtype=torch.int32, device=dev)

    def step():
        with torch.no_grad():
            return model(toks[:, -1:], cache=cache, input_pos=pos)[0].float()

    return step


def device_profile(fn, top: int = 8, cpu: bool = True):
    """Device kernel time of one ``fn()`` by torch.profiler, with the
    kernels that take most of it and the count of decode-attention kernels
    (K3/K4, ``decode_split``) it lists, inside CUDA graph replays too; None
    (and the reason printed) where the profiler gives no device time on
    this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    decode_kernels = 0
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                            else [])
    try:
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CPU:
                continue  # an operator: its kernels are listed themselves
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                per[e.key] = per.get(e.key, 0.0) + us / 1e3
                if "decode_split" in e.key:
                    decode_kernels += e.count
    except Exception as exc:  # measurement only: the run's checks stand
        print(f"[main] torch.profiler failed: {exc!r}", flush=True)
        return None
    if not per:
        print("[main] torch.profiler recorded no device time", flush=True)
        return None
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": sum(per.values()), "decode_kernels": decode_kernels,
            "top": [[k[:60], round(v, 3)] for k, v in ranked]}


def call_breakdown(fn, iters: int = 10) -> dict:
    """Device time of each tempo kernel in one ``fn()``, by torch.profiler
    over ``iters`` calls made as ``time_ms`` makes them (cold L2, the card
    busy until the call is enqueued), in us a call; {} where the profiler
    gives no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    per = {}
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                torch.cuda._sleep(SPIN_CYCLES)
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            name = re.search(r"tempo::(\w+)", e.key)
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if name and us > 0:
                per[name.group(1)] = us / iters
    except Exception as exc:  # measurement only: the run's checks stand
        print(f"[kernels] torch.profiler failed: {exc!r}", flush=True)
    return per


def decode_batch_independence(dev, gen, split: int) -> list:
    """K3 and K4: each row of a batch of 8 (positions around the split
    length, the cache's end, a short row) computed alone, then inside the
    batch; for K4 the batch reads a larger pool in which every page of the
    rows lies elsewhere (shuffled table) and the alone run the row's own.
    Returns (kernel, dtype, n, kv, rows bitwise equal, all equal) tuples."""
    import torch

    from tempo_tpu_torch.ops import cuda_decode

    pos = torch.tensor([5, 300, split - 1, LM_CACHE - 1, split, 700,
                        split + 1, 2], dtype=torch.int32, device=dev)
    out = []
    for dtype, n, kv in ((torch.bfloat16, 12, 12), (torch.float32, 12, 4)):
        q = torch.randn((8, 1, n, 64), generator=gen, device=dev).to(dtype)
        ck = torch.randn((8, LM_CACHE, kv, 64), generator=gen,
                         device=dev).to(dtype)
        cv = torch.randn((8, LM_CACHE, kv, 64), generator=gen,
                         device=dev).to(dtype)
        batch = cuda_decode.decode_attention(q, ck, cv, pos)
        same = [bool(torch.equal(batch[r:r + 1], cuda_decode.decode_attention(
            q[r:r + 1], ck[r:r + 1], cv[r:r + 1], pos[r:r + 1])))
            for r in range(8)]
        out.append(("K3", str(dtype), n, kv, same, all(same)))
        pages = LM_CACHE // LM_PAGE
        pk = ck.reshape(8 * pages, LM_PAGE, kv, 64)  # row r: pages r*8 ..
        pv = cv.reshape(8 * pages, LM_PAGE, kv, 64)
        own = torch.arange(8 * pages, device=dev, dtype=torch.int32).reshape(
            8, pages)
        where = 3 + torch.randperm(8 * pages, device=dev)  # pool of 8*8 + 5
        big_k = torch.randn((8 * pages + 5,) + pk.shape[1:], generator=gen,
                            device=dev).to(dtype)
        big_v = torch.randn(big_k.shape, generator=gen, device=dev).to(dtype)
        big_k[where], big_v[where] = pk, pv
        table = where.to(torch.int32)[own.long()]
        batch = cuda_decode.paged_decode_attention(q, big_k, big_v, table, pos)
        same = [bool(torch.equal(batch[r:r + 1],
                                 cuda_decode.paged_decode_attention(
                                     q[r:r + 1], pk, pv, own[r:r + 1],
                                     pos[r:r + 1])))
                for r in range(8)]
        out.append(("K4", str(dtype), n, kv, same, all(same)))
    return out


def lm_path(dev, gen, rows: dict, exports: "LMExports") -> dict:
    """The GPT-2-small serving path: (a) generate through K3, (b) the paged
    server through K4 on a roomy and a tight pool, both counted; K3/K4
    against their plain versions at every recorded call and at edge cases,
    each timed, and each row bitwise the same alone and inside a batch; (c)
    one-step logits against the plain path. Adds the K3 and K4 rows;
    returns the LM metrics."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tempo_tpu_torch.infer import export_lm
    from tempo_tpu_torch.infer.export_lm import live_paged_surface
    from tempo_tpu_torch.infer.paged import PagedLMServer
    from tempo_tpu_torch.nn.transformer import (Transformer,
                                                TransformerConfig,
                                                _generate_eager, generate,
                                                num_params)
    from tempo_tpu_torch.ops import cuda_decode

    split = cuda_decode.split_len()
    cfg = TransformerConfig(compute_dtype="bfloat16")
    model = Transformer(cfg, device=dev, seed=SEED)
    n_params = num_params(model)
    if n_params != 123_689_472:
        fail(f"GPT-2-small non-embedding parameter count {n_params}")
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.in_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)).to(dev)
    calls = {"K3": [], "K4": []}

    def run_generate(fn=generate):
        return fn(model, prompt, LM_NEW, temperature=0.0,
                  cache_dtype=torch.bfloat16, cache_len=LM_CACHE)

    seconds, t_part = {}, time.perf_counter()

    # ------------------------------- (a) generate, captured, counted
    cuda_decode.LAUNCHES["decode_attention"] = 0
    out = run_generate()
    torch.cuda.synchronize()
    k3 = cuda_decode.LAUNCHES["decode_attention"]
    print(f"[main] generate: K3 launches {k3} (want {cfg.n_layer} x "
          f"{LM_NEW - 1}: the first step's eager warm-up, then {LM_NEW - 2} "
          f"replays of the captured step)", flush=True)
    if k3 != cfg.n_layer * (LM_NEW - 1):
        fail(f"K3 launched {k3} times in generate, want "
             f"{cfg.n_layer * (LM_NEW - 1)}")
    rows["K3"]["launches"] = k3
    if (out.shape != (LM_BATCH, LM_PROMPT + LM_NEW)
            or not torch.equal(out[:, :LM_PROMPT], prompt.long())
            or int(out.min()) < 0 or int(out.max()) >= cfg.in_size):
        fail(f"generate output bad: {tuple(out.shape)}")
    # the eager loop makes the same K3 calls, one per step: recorded for 2'
    with recording_decode(calls, "generate"):
        out_eager = run_generate(_generate_eager)
    if not torch.equal(out, out_eager):
        fail("captured generate differs from the eager loop")
    out_again, dt = timed(run_generate)
    _, dt_eager = timed(lambda: run_generate(_generate_eager))
    gen_ms_tok = 1e3 * dt / LM_NEW
    gen_tok_s = LM_BATCH * LM_NEW / dt
    eager_ms_tok = 1e3 * dt_eager / LM_NEW
    print(f"[main] generate b={LM_BATCH} prompt {LM_PROMPT} +{LM_NEW} "
          f"cache {LM_CACHE} bf16, captured: {gen_ms_tok:.3f} ms/token, "
          f"{gen_tok_s:.1f} tokens/s; eager loop: {eager_ms_tok:.3f} "
          f"ms/token, {LM_BATCH * LM_NEW / dt_eager:.1f} tokens/s (host "
          f"wall of one run each after warm ones, incl. the capture); "
          f"bitwise equal: True; repeat equal: "
          f"{bool(torch.equal(out, out_again))}", flush=True)
    gen_profile = device_profile(run_generate)
    if gen_profile is not None:
        gen_profile["busy_share"] = gen_profile["device_ms"] / (1e3 * dt)
        print(f"[main] generate under torch.profiler: "
              f"{json.dumps(gen_profile)} (busy_share: device kernel time "
              f"over the unprofiled run's wall; decode_kernels: K3 kernels "
              f"listed, want {k3})", flush=True)
        if gen_profile["decode_kernels"] != k3:
            print("[main] the profiler does not list every K3 kernel of the "
                  "replays: the captured times above are CUDA-event and "
                  "host-clock times", flush=True)

    seconds["3a"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ------------------------ (b) paged server, captured, counted
    surface = live_paged_surface(model, max_seq=LM_CACHE,
                                 decode_chunk=LM_K, page_size=LM_PAGE,
                                 device=dev)
    eager_surface = export_lm._live_surface(
        model, LM_CACHE, LM_K, LM_PAGE, dev, captured=False).paged_dict()
    reqs = lm_workload(cfg.in_size)

    def server(pool, surf=surface):
        return PagedLMServer(surface=surf, n_slots=LM_SLOTS,
                             n_pages=LM_POOLS[pool], k_decode=LM_K,
                             prefill_chunk=LM_CHUNK, device=dev)

    cuda_decode.LAUNCHES["paged_decode_attention"] = 0
    served, servers = {}, {}
    for pool in LM_POOLS:
        servers[pool] = srv = server(pool)
        resp = srv.serve(reqs)
        served[pool] = (resp, dict(srv.last_stats))
    torch.cuda.synchronize()
    k4 = cuda_decode.LAUNCHES["paged_decode_attention"]
    print(f"[main] serve: K4 launches {k4}", flush=True)
    if k4 == 0:
        fail("K4 was not launched by the paged server")
    rows["K4"]["launches"] = k4
    roomy, tight = served["roomy"], served["tight"]
    for pool, (resp, st) in served.items():
        if len(resp) != LM_REQUESTS or any(
                r["n_generated"] != q["n_tokens"] for r, q in zip(resp, reqs)):
            fail(f"{pool} serve returned wrong token counts")
    if tight[1]["preemptions"] <= 0:
        fail(f"the tight pool ({LM_POOLS['tight']} pages) did not preempt")
    if [r["tokens"] for r in roomy[0]] != [r["tokens"] for r in tight[0]]:
        fail("greedy outputs differ between the roomy and the tight pool")
    # the eager server makes the same K4 calls: recorded for 2', and the
    # reference of the captured servers (here and in 3d)
    eager_tokens, eager_stats = {}, {}
    for pool in LM_POOLS:
        srv = server(pool, eager_surface)
        with recording_decode(calls, pool):
            resp = srv.serve(reqs)
        eager_tokens[pool] = [r["tokens"] for r in resp]
        eager_stats[pool] = dict(srv.last_stats)
        if eager_tokens[pool] != [r["tokens"] for r in served[pool][0]]:
            fail(f"{pool}: the captured paged server's greedy outputs differ "
                 f"from the eager server's")
        del srv
    serve_stats = {}
    for pool in LM_POOLS:
        srv = servers[pool]
        srv.serve(reqs)  # its graphs are captured: a warm run
        st = srv.last_stats
        serve_stats[pool] = {k: st[k] for k in (
            "tokens_per_sec", "seconds", "n_generated", "decode_steps",
            "decode_bursts", "prefills", "preemptions", "peak_pages",
            "n_pages")}
        serve_stats[pool]["first_run_s"] = served[pool][1]["seconds"]
        serve_stats[pool]["eager"] = {k: eager_stats[pool][k] for k in (
            "tokens_per_sec", "seconds")}
        print(f"[main] serve {pool} ({LM_POOLS[pool]} pages), captured: "
              f"{json.dumps(serve_stats[pool])} (warm run; first_run_s: the "
              f"counted run, captures included; eager: the recorded run; "
              f"the counted run: preemptions "
              f"{served[pool][1]['preemptions']}, peak_pages "
              f"{served[pool][1]['peak_pages']})", flush=True)
    del servers, surface, eager_surface
    seconds["3b"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    # the sampled stream draws the same bits on the CPU and on the card
    seeds = torch.arange(8, dtype=torch.int64) * 977
    spos = torch.arange(8, dtype=torch.int64) + 300
    u_cpu = export_lm.counter_uniform(seeds, spos, cfg.in_size)
    u_dev = export_lm.counter_uniform(seeds.to(dev), spos.to(dev),
                                      cfg.in_size).cpu()
    if not torch.equal(u_cpu, u_dev):
        fail("the counter-based uniforms differ between CPU and card")

    # --------------------------- K3/K4 at every recorded call, timed
    def grouped(kind):
        """{(key, positions): {run: calls}}, and one table per group."""
        out_, tables = {}, {}
        for key, run, pos, table in calls[kind]:
            p = tuple(int(v) for v in pos.reshape(-1).tolist())
            out_.setdefault((key, p), {}).setdefault(run, 0)
            out_[(key, p)][run] += 1
            if table is not None:
                tables.setdefault((key, p), table)
        return out_, tables

    checks_ok = True
    with torch.no_grad():
        r = rows["K3"]
        groups, _ = grouped("K3")
        inputs = {}
        for (key, pos), n in groups.items():
            (qs, cs, qdt, cdt) = key
            if key not in inputs:
                inputs[key] = (
                    torch.randn(qs, generator=gen, device=dev).to(qdt),
                    torch.randn(cs, generator=gen, device=dev).to(cdt),
                    torch.randn(cs, generator=gen, device=dev).to(cdt))
            q, ck, cv = inputs[key]
            b, s_len, kv = cs[0], cs[1], cs[2]
            p = torch.tensor(pos if len(pos) > 1 else pos[0],
                             dtype=torch.int32, device=dev)
            rows_pos = cuda_decode.pos_rows(p, b, dev)
            err, ok = max_err(cuda_decode.decode_attention(q, ck, cv, p),
                              cuda_decode.decode_attention_plain(q, ck, cv, p),
                              decode_tol(cdt))
            checks_ok &= ok
            live = [min(int(v), s_len - 1) + 1 for v in rows_pos.tolist()]
            bound = 1e3 * decode_bytes(q, ck.element_size(), kv, live) \
                / HBM_BYTES_PER_S
            mask = (torch.arange(s_len, device=dev)[None]
                    <= rows_pos[:, None])[:, None, None, :]
            qt, kt, vt = q.transpose(1, 2), ck.transpose(1, 2), \
                cv.transpose(1, 2)
            gqa = {"enable_gqa": True} if q.shape[2] != kv else {}
            if sum(n.values()) > r.get("breakdown_calls", 0):
                r["breakdown_calls"] = sum(n.values())
                r["breakdown_pos"] = list(pos)
                r["breakdown_us"] = call_breakdown(
                    lambda: cuda_decode.decode_attention(q, ck, cv, p))
                r["breakdown_us"]["whole call"] = 1e3 * time_ms(
                    lambda: cuda_decode.decode_attention(q, ck, cv, p))
            lm_add(r, n, err, ok,
                   time_ms(lambda: cuda_decode.decode_attention(q, ck, cv, p),
                           iters=3, warmup=1),
                   time_ms(lambda: cuda_decode.decode_attention_plain(
                       q, ck, cv, p), iters=3, warmup=1),
                   bound,
                   time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask, **gqa), iters=3,
                       warmup=1))
        r["shapes"] = [dict(q=list(k[0]), cache=list(k[1]), dtype=str(k[3]))
                       for k in inputs]

        r = rows["K4"]
        groups, tables = grouped("K4")
        inputs = {}
        for (key, pos), n in groups.items():
            (qs, ps, ts, qdt, pdt) = key
            if key not in inputs:
                pool_k = torch.randn(ps, generator=gen, device=dev).to(pdt)
                pool_v = torch.randn(ps, generator=gen, device=dev).to(pdt)
                inputs[key] = (torch.randn(qs, generator=gen,
                                           device=dev).to(qdt),
                               pool_k, pool_v)
            q, pk, pv = inputs[key]
            table = tables[(key, pos)]
            pg, kv, cap = ps[1], ps[2], ts[1] * ps[1]
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            err, ok = max_err(
                cuda_decode.paged_decode_attention(q, pk, pv, table, p),
                cuda_decode.paged_decode_attention_plain(q, pk, pv, table, p),
                decode_tol(pdt))
            checks_ok &= ok
            if sum(n.values()) > r.get("breakdown_calls", 0):
                r["breakdown_calls"] = sum(n.values())
                r["breakdown_pos"] = list(pos)
                r["breakdown_us"] = call_breakdown(
                    lambda: cuda_decode.paged_decode_attention(
                        q, pk, pv, table, p))
                r["breakdown_us"]["whole call"] = 1e3 * time_ms(
                    lambda: cuda_decode.paged_decode_attention(
                        q, pk, pv, table, p))
            live = [min(v, cap - 1) + 1 for v in pos]
            bound = 1e3 * (decode_bytes(q, pk.element_size(), kv, live)
                           + 4 * sum(-(-n_ // pg) for n_ in live)) \
                / HBM_BYTES_PER_S
            lm_add(r, n, err, ok,
                   time_ms(lambda: cuda_decode.paged_decode_attention(
                       q, pk, pv, table, p), iters=3, warmup=1),
                   time_ms(lambda: cuda_decode.paged_decode_attention_plain(
                       q, pk, pv, table, p), iters=3, warmup=1),
                   bound, None)
        r["shapes"] = [dict(q=list(k[0]), pool=list(k[1]), table=list(k[2]),
                            dtype=str(k[4])) for k in inputs]
        del inputs

        # edge cases: GQA n=12 kv=4, pos 0, split/block/page edges, S-1,
        # f32/bf16
        edges = []
        for dtype in (torch.float32, torch.bfloat16):
            for n, kv in ((12, 12), (12, 4)):
                q = torch.randn((4, 1, n, 64), generator=gen,
                                device=dev).to(dtype)
                ck = torch.randn((4, LM_CACHE, kv, 64), generator=gen,
                                 device=dev).to(dtype)
                cv = torch.randn((4, LM_CACHE, kv, 64), generator=gen,
                                 device=dev).to(dtype)
                for pos in ([0, 255, 256, LM_CACHE - 1],
                            [split - 1, split, split + 1, 2 * split],
                            [2 * split - 1, 2 * split + 1, 3 * split, 700],
                            0, LM_CACHE - 1):
                    p = torch.tensor(pos, dtype=torch.int32, device=dev)
                    err, ok = max_err(
                        cuda_decode.decode_attention(q, ck, cv, p),
                        cuda_decode.decode_attention_plain(q, ck, cv, p),
                        decode_tol(dtype))
                    edges.append(("K3", str(dtype), n, kv, pos, err, ok))
                pk = ck.reshape(-1, LM_PAGE, kv, 64)  # 32 pages
                pv = cv.reshape(-1, LM_PAGE, kv, 64)
                table = torch.randperm(pk.shape[0], device=dev)[:32].reshape(
                    4, 8).to(torch.int32)
                table[3, 2:] = 0  # dead logical pages on the trash page
                for pos in ([0, 127, 128, LM_CACHE - 1], [1023, 128, 127, 255],
                            [split - 1, split, split + 1, 2 * split + 1],
                            [2 * split - 1, 2 * split, 3 * split, 700]):
                    p = torch.tensor(pos, dtype=torch.int32, device=dev)
                    err, ok = max_err(
                        cuda_decode.paged_decode_attention(q, pk, pv, table,
                                                           p),
                        cuda_decode.paged_decode_attention_plain(
                            q, pk, pv, table, p), decode_tol(dtype))
                    edges.append(("K4", str(dtype), n, kv, pos, err, ok))
        torch.cuda.synchronize()
        for e in edges:
            checks_ok &= e[-1]
            print(f"[kernels] edge {e[0]} {e[1]} n={e[2]} kv={e[3]} "
                  f"pos={e[4]}: max_abs_err={e[5]:.3e} ok={e[6]}", flush=True)
        rows["K3"]["edge_checks"] = sum(e[0] == "K3" for e in edges)
        rows["K4"]["edge_checks"] = sum(e[0] == "K4" for e in edges)
        independent = decode_batch_independence(dev, gen, split)
    for e in independent:
        checks_ok &= e[-1]
        rows[e[0]]["batch_independent"] = (
            rows[e[0]].get("batch_independent", True) and e[-1])
        print(f"[kernels] {e[0]} {e[1]} n={e[2]} kv={e[3]}: each row alone "
              f"== inside the batch, bitwise: {e[4]}", flush=True)
    card = smi_line()
    for name in ("K3", "K4"):
        rr = rows[name]
        rr["split_len"] = split
        print(f"[kernels] {name}: {rr['calls']} calls, max_abs_err "
              f"{rr['max_abs_err']:.3e}, ms {rr['ms']:.3f} "
              f"(by run {json.dumps(rr['ms_by_run'])}), plain "
              f"{rr['plain_ms']:.3f}, bound {rr['bound_ms']:.4f}, library "
              f"{rr['library_ms']}; split length {split}", flush=True)
        print(f"[kernels] {name} at its most frequent call (positions "
              f"{rr['breakdown_pos']}, {rr['breakdown_calls']} calls), us: "
              f"{json.dumps(rr['breakdown_us'])} (the kernel's device time "
              f"by torch.profiler; the whole call by CUDA events, as the "
              f"row's ms)", flush=True)
        # on this text line only: the kernels line holds what this run read
        per_call = rr["ms"] / rr["calls"]
        print(f"[kernels] {name}: {per_call:.5f} ms at the average call on "
              f"{card}; before the redesign {KERNEL_PREV[name]:.5f} on "
              f"{KERNEL_PREV['card']}: x{KERNEL_PREV[name] / per_call:.2f}",
              flush=True)
    if not checks_ok:
        fail("K3/K4 disagree with their plain versions beyond tolerance, or "
             "a row's result depends on the rest of its batch")

    # ------------------------------- (c) logits against the plain path
    seconds["2'"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    exported = exported_serving(dev, model, reqs, eager_tokens, exports)
    t_part = time.perf_counter()

    errs = {}
    for dtype_name, m in (("bf16", model), ("f32", None)):
        if m is None:
            m = Transformer(TransformerConfig(compute_dtype="float32"),
                            device=dev, seed=SEED)
        dt_ = m.config.dtype
        for kind in ("dense", "paged"):
            step = lm_step_logits(m, dev, dt_, kind == "paged")
            got = step()
            with plain_decode():
                want = step()
            errs[f"{kind}_{dtype_name}"] = rel_l2(got, want)
    with plain_decode():
        out_plain = run_generate(_generate_eager)
    new_k, new_p = out[:, LM_PROMPT:], out_plain[:, LM_PROMPT:]
    agree = float((new_k == new_p).float().mean())
    first = [int(torch.nonzero(a != b_)[0]) if bool((a != b_).any())
             else LM_NEW for a, b_ in zip(new_k, new_p)]
    print(f"[main] one-step logits vs plain path, rel L2: "
          f"{json.dumps(errs)} (tol bf16 {LM_BF16_REL_L2}, f32 "
          f"{LM_F32_REL_L2}); greedy generate kernel vs plain: {agree:.3f} "
          f"of tokens equal, first divergence per row {first} (reported, "
          f"not asserted: bf16 argmax near-ties may flip)", flush=True)
    for k, v in errs.items():
        if not v <= (LM_BF16_REL_L2 if k.endswith("bf16") else LM_F32_REL_L2):
            fail(f"{k} logits disagree with the plain path: rel L2 {v}")
    seconds["3c"] = time.perf_counter() - t_part
    seconds["3d"] = exported["seconds"]
    print(f"[time] LM serving phases, s: {json.dumps(seconds)}", flush=True)
    return {"seconds": seconds, "n_params": n_params,
            "generate_ms_per_token": gen_ms_tok,
            "generate_tokens_per_s": gen_tok_s,
            "generate_eager_ms_per_token": eager_ms_tok,
            "generate_profile": gen_profile, "serve": serve_stats,
            "exported": exported,
            "logits_rel_l2": errs, "greedy_plain_agreement": agree,
            "greedy_plain_first_divergence": first}


def timed(fn):
    """(fn(), host seconds) with the card synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bitwise(a, b) -> bool:
    """Tensors, or nested tuples of them, equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and bool(torch.equal(a, b)))
    return len(a) == len(b) and all(bitwise(x, y) for x, y in zip(a, b))


def replay_checks(surface, eager, n_layer: int) -> list:
    """3d(i): each captured call of a loaded surface against the same call
    run eagerly (``eager``: the same programs, nothing captured), from the
    same caches and inputs: first at the capture's position (and table),
    then at another; the outputs and the caches afterwards compared bit
    for bit, and the K3/K4 launches of one more replay counted. Returns
    (call, bitwise, launches a replay, launches wanted) tuples."""
    import numpy as np
    import torch

    from tempo_tpu_torch.ops import cuda_decode

    dev = surface.device
    vocab = int(surface.meta["vocab_size"])
    rng = np.random.default_rng(SEED + 2)
    k = surface.k
    with torch.no_grad():
        _, base = eager.prefill(rng.integers(0, vocab, (LM_BATCH, 300)))
        table0 = (1 + torch.randperm(64, device=dev)).reshape(8, 8).to(
            torch.int32)
        table1 = torch.roll(table0, 1, dims=0)
        shape = (65, LM_PAGE) + tuple(base[0][0].shape[2:])
        pools = tuple((torch.zeros(shape, dtype=base[0][0].dtype, device=dev),
                       torch.zeros(shape, dtype=base[0][0].dtype, device=dev),
                       table0) for _ in range(n_layer))
        for r in range(LM_BATCH):
            eager.admit_paged(pools, tuple((ck[r:r + 1], cv[r:r + 1])
                                           for ck, cv in base), table0[r])
    rows_pos = np.arange(300, 300 - 10 * LM_BATCH, -10)

    def tok():
        return torch.from_numpy(rng.integers(0, vocab, (LM_BATCH, 1))).to(dev)

    calls = {
        "decode_step": (base, [lambda: 300, lambda: 301], 1,
                        "decode_attention"),
        "decode_rows": (base, [lambda: rows_pos, lambda: rows_pos + 1], 1,
                        "decode_attention"),
        "decode_k": (base, [lambda: 300, lambda: 300 + k], k,
                     "decode_attention"),
        "decode_paged": (pools, [lambda: rows_pos, lambda: rows_pos + 1], 1,
                         "paged_decode_attention"),
        "decode_paged_k": (pools, [lambda: rows_pos, lambda: rows_pos + k],
                           k, "paged_decode_attention"),
    }
    def copy(cache):
        """A copy of a cache; a paged one keeps one table for all layers."""
        if len(cache[0]) == 2:
            return tuple((ck.clone(), cv.clone()) for ck, cv in cache)
        tab = cache[0][2].clone()
        return tuple((pk.clone(), pv.clone(), tab) for pk, pv, _ in cache)

    out = []
    for name, (cache0, positions, steps, counter) in calls.items():
        cc, ce = copy(cache0), copy(cache0)
        paged = len(cc[0]) == 3
        same = True
        for i, pos in enumerate(positions):
            if paged and i == 1:  # another table, updated in place
                cc[0][2].copy_(table1)
                ce[0][2].copy_(table1)
            t, p = tok(), pos()
            got = getattr(surface, name)(t, cc, p)
            got = tuple(x.clone() for x in got[:-1])  # before any replay
            want = getattr(eager, name)(t, ce, p)[:-1]
            same &= bitwise(got, want) and bitwise(cc, ce)
        t, p = tok(), surface.tensor(positions[1](), torch.int32)
        cuda_decode.LAUNCHES[counter] = 0
        getattr(surface, name)(t, cc, p)
        torch.cuda.synchronize()
        launched = cuda_decode.LAUNCHES[counter]
        # the replay's device time by CUDA events (inputs already on the
        # device: two small copies and the graph)
        ms = time_ms(lambda: getattr(surface, name)(t, cc, p), iters=5,
                     warmup=1)
        out.append((name, same, launched, n_layer * steps, ms))
    return out


def exported_serving(dev, model, reqs, eager_tokens: dict,
                     exports: "LMExports") -> dict:
    """3d: GPT-2-small's programs (exported on the card by a background
    process, ``exports``) loaded with device None; (i) every captured call
    bitwise its eager call; (ii) the 64 requests through cli/serve_lm.py's
    functions with a dict config under each scheduler, the paged server's
    greedy completions equal to 3b's eager server's; (iii) one POST
    /v1/completions over loopback equal to batch mode. The loaded surface
    stays held for phases 9 and 10 (``HELD``). Returns the metrics."""
    import tempfile

    from tempo_tpu_torch.cli.serve_lm import _serve_batch, build_server
    from tempo_tpu_torch.infer import export_lm
    from tempo_tpu_torch.ops import cuda_decode

    result = {}
    t_phase = time.perf_counter()
    art, result["export_wait_s"] = timed(
        lambda: exports.path("target_bf16"))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        prefill, _, meta = export_lm.load_exported_lm(art)
        result["load_s"] = time.perf_counter() - t0
        surface = prefill.__self__
        HELD.append(surface)
        eager = surface.uncaptured()

        # ---------------------------------- (i) replay equals eager
        t_i = time.perf_counter()
        checks = replay_checks(surface, eager, model.config.n_layer)
        result["replay_checks_s"] = time.perf_counter() - t_i
        for name, same, n, want, ms in checks:
            where = "position and table" if "paged" in name else "position"
            print(f"[3d] {name}: captured == eager bitwise at the capture's "
                  f"and another {where} (outputs and caches): {same}; K3/K4 "
                  f"launches a replay {n} (want {want}); a replay "
                  f"{ms:.3f} ms of device time (CUDA events, cold L2, b=8, "
                  f"{want // model.config.n_layer} model steps)", flush=True)
            if not same:
                fail(f"3d: captured {name} differs from its eager call")
            if n != want:
                fail(f"3d: {name} launched {n} decode kernels a replay, "
                     f"want {want}")
        result["replay_bitwise"] = {c[0]: c[1] for c in checks}
        result["replay_ms"] = {c[0]: c[4] for c in checks}
        del eager

        # --------------------------- (ii) the CLI's batch mode, per scheduler
        req_path = tmp / "requests.jsonl"
        req_path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
        fused = {"slots": LM_SLOTS, "k_decode": LM_K,
                 "prefill_chunk": LM_CHUNK}
        configs = {
            "bucketed": {"scheduler": "bucketed", "prefill_chunk": LM_CHUNK},
            "continuous": {"scheduler": "continuous", **fused},
            "paged_roomy": {"scheduler": "paged", "n_pages":
                            LM_POOLS["roomy"], **fused},
            "paged_tight": {"scheduler": "paged", "n_pages":
                            LM_POOLS["tight"], **fused},
        }
        tokens, stats = {}, {}
        for name, extra in configs.items():
            t_run = time.perf_counter()
            cfg = {"artifacts": str(art), "requests": str(req_path), **extra}
            captures = surface.graphs.captures
            srv = build_server(cfg)
            # two requests first capture the server's graphs
            srv.serve_requests(reqs[:2], default_new_tokens=64)
            warm_captures = surface.graphs.captures - captures
            out_dir = tmp / name
            out_dir.mkdir()
            _serve_batch(srv, cfg, out_dir, 64)
            info = json.loads((out_dir / "serving_info.yaml").read_text())
            done = [json.loads(line) for line in
                    (out_dir / "completions.jsonl").read_text().splitlines()]
            if [r["n_generated"] for r in done] != [
                    q["n_tokens"] for q in reqs]:
                fail(f"3d {name}: wrong token counts")
            tokens[name] = [r["tokens"] for r in done]
            # the device busy share over a few requests, and the decode kernels
            # the profiler lists inside the replays
            few = reqs[:LM_PROFILED]
            _, t_few = timed(lambda: srv.serve_requests(few, 64))
            before = dict(cuda_decode.LAUNCHES)
            t_prof = time.perf_counter()
            prof = device_profile(lambda: srv.serve_requests(few, 64),
                                  cpu=False)
            t_prof = time.perf_counter() - t_prof
            launched = sum(cuda_decode.LAUNCHES[k] - before[k]
                           for k in before)
            st = info.get("scheduler_stats", {})
            stats[name] = {
                "tokens_per_sec": info["tokens_per_sec"],
                "elapsed_s": info["elapsed_s"],
                "decode_dispatches": st.get("decode_steps"),
                "bursts": st.get("decode_bursts"),
                "preemptions": st.get("preemptions"),
                "graphs_captured": surface.graphs.captures - captures,
                "graphs_captured_by_warmup": warm_captures,
                "busy_share": (None if prof is None else
                               prof["device_ms"] / (1e3 * t_few)),
                "decode_kernels_profiled": (None if prof is None else
                                            prof["decode_kernels"]),
                "decode_launches_profiled": launched,
            }
            print(f"[3d] serve_lm {name}: {json.dumps(stats[name])} "
                  f"(tokens_per_sec: host wall of _serve_batch over the 64 "
                  f"requests after a 2-request warm-up that captures the "
                  f"graphs; busy_share: device kernel time under "
                  f"torch.profiler over the unprofiled wall of the first "
                  f"{LM_PROFILED} requests; {time.perf_counter() - t_run:.1f}"
                  f" s, the profile {t_prof:.1f} s)", flush=True)
            if prof is not None and prof["decode_kernels"] != launched:
                print(f"[3d] {name}: the profiler lists "
                      f"{prof['decode_kernels']} decode kernels for "
                      f"{launched} launches: its busy share misses part of "
                      f"the replays; each replay's device time by CUDA "
                      f"events is in 3d(i)'s lines", flush=True)
            if name == "continuous":
                http = http_check(srv, cfg, tmp, reqs[:2])
            del srv
        for pool in LM_POOLS:
            if tokens[f"paged_{pool}"] != eager_tokens[pool]:
                fail(f"3d: the exported paged server ({pool}) differs from "
                     f"3b's eager server")
        ref = tokens["paged_roomy"]
        agree = {name: sum(a == b for a, b in zip(t, ref)) / len(ref)
                 for name, t in tokens.items()}
        print(f"[3d] greedy completions equal to 3b's eager paged server on "
              f"both pools: True; share of requests equal to the paged "
              f"server's, by scheduler (reported, not a gate: other batch "
              f"shapes may round bf16 otherwise): {json.dumps(agree)}",
              flush=True)
    result.update(serve=stats, agreement=agree, http=http,
                  seconds=time.perf_counter() - t_phase)
    print(f"[time] 3d: {result['seconds']:.1f} s", flush=True)
    return result


def http_check(srv, cfg: dict, tmp: Path, two: list) -> dict:
    """3d(iii): ``_serve_http`` on 127.0.0.1, port 0, in a thread; GET
    /healthz must give the artifact's meta, and one POST /v1/completions
    of two prompts (max_tokens 16, greedy) the batch mode's tokens."""
    import threading
    import urllib.request

    from tempo_tpu_torch.cli.serve_lm import _serve_batch, _serve_http

    reqs = [{"tokens": r["tokens"], "n_tokens": 16} for r in two]
    path = tmp / "two.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    batch_dir = tmp / "http_batch"
    batch_dir.mkdir()
    _serve_batch(srv, {**cfg, "requests": str(path)}, batch_dir, 64)
    want = [json.loads(line)["tokens"] for line in
            (batch_dir / "completions.jsonl").read_text().splitlines()]
    http_dir = tmp / "http"
    http_dir.mkdir()
    th = threading.Thread(target=_serve_http, args=(srv, {
        **cfg, "host": "127.0.0.1", "port": 0, "max_requests": 1},
        http_dir, 64), daemon=True)
    th.start()
    info = http_dir / "serving_info.yaml"
    for _ in range(600):
        if info.exists() and info.read_text().strip():
            break
        time.sleep(0.05)
    else:
        fail("3d: the HTTP server did not start")
    base = f"http://127.0.0.1:{json.loads(info.read_text())['port']}"
    with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    meta = json.loads((Path(cfg["artifacts"]) / "meta.json").read_text())
    if health.get("status") != "ok" or any(health.get(k) != v
                                           for k, v in meta.items()):
        fail("3d: /healthz does not give the artifact's meta")
    body = json.dumps({"prompt": [r["tokens"] for r in reqs],
                       "max_tokens": 16}).encode()
    post = urllib.request.Request(f"{base}/v1/completions", data=body,
                                  headers={"Content-Type":
                                           "application/json"})
    with urllib.request.urlopen(post, timeout=120) as r:
        got = json.loads(r.read())
    th.join(timeout=60)
    if th.is_alive():
        fail("3d: the HTTP server did not stop after its one request")
    tokens = [c["tokens"] for c in got["choices"]]
    print(f"[3d] HTTP on 127.0.0.1: /healthz gives the meta; POST "
          f"/v1/completions of 2 prompts x 16 tokens equals batch mode: "
          f"{tokens == want}; usage {json.dumps(got['usage'])}", flush=True)
    if tokens != want:
        fail("3d: /v1/completions differs from batch mode")
    return {"healthz_meta": True, "completions_equal_batch": True,
            "usage": got["usage"]}


def spec_configs(art: Path, draft, pool: str) -> dict:
    """serve_lm's dict config of one phase-9 scheduler over ``art``: with
    ``draft`` (a directory) the speculative form, without it the same
    scheduler target-only (per token; batch 1 for ``speculative``)."""
    base = {"artifacts": str(art), "prefill_chunk": LM_CHUNK}
    if pool == "speculative":
        return dict(base, **({"scheduler": "speculative",
                              "draft_artifacts": str(draft),
                              "k_draft": SPEC_K} if draft else
                             {"scheduler": "continuous", "slots": 1}))
    cfg = dict(base, scheduler=pool, slots=LM_SLOTS)
    if pool == "paged":
        cfg["n_pages"] = LM_POOLS["roomy"]
    if draft:
        cfg.update(draft_artifacts=str(draft), k_draft=SPEC_K)
    return cfg


def top2_gap(art: Path, prompt: list, prefix: list, dev) -> tuple:
    """(gap, top): the target's two largest logits' gap after ``prompt +
    prefix`` (one prefill of the exported target) and the largest: at a
    stream's first differing position, how near a tie the reference's
    draw was."""
    import torch

    from tempo_tpu_torch.infer import export_lm

    prefill, _, _ = export_lm.load_exported_lm(art, dev)
    with torch.no_grad():
        logits, _ = prefill([list(prompt) + list(prefix)])
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1]), float(top[0])


def agreement(got: list, want: list, reqs: list, art: Path, dev,
              gaps: dict) -> dict:
    """How far ``got``'s streams agree with the reference ``want``: the
    share equal, and for each that differs its first differing position
    with the reference's top-two logit gap there (and the top logit).
    ``gaps`` keeps the gaps computed, for the runs that share a
    reference."""
    diffs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            d = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w)))
            key = (str(art), tuple(reqs[i]["tokens"]), tuple(w[:d]))
            if key not in gaps:
                gaps[key] = top2_gap(art, reqs[i]["tokens"], w[:d], dev)
            gap, top = gaps[key]
            diffs.append({"request": i, "position": d, "gap": gap,
                          "top": top})
    return {"equal_share": (len(got) - len(diffs)) / len(got),
            "first_differences": diffs}


def spec_run(cfg: dict, reqs: list, dev, warm: list) -> dict:
    """build_server(cfg) on ``dev``, a warm-up over ``warm`` (cut to two
    rounds) that captures its graphs, then one counted run over ``reqs``:
    the responses, the
    scheduler's statistics, tokens/s by host wall, and the K3/K4 launches
    of the run."""
    import torch

    from tempo_tpu_torch.cli.serve_lm import build_server
    from tempo_tpu_torch.ops import cuda_decode

    srv = build_server(cfg, dev)
    srv.serve_requests([dict(r, n_tokens=2 * SPEC_K + 2) for r in warm],
                       default_new_tokens=64)
    torch.cuda.synchronize()
    for key in cuda_decode.LAUNCHES:
        cuda_decode.LAUNCHES[key] = 0
    resp, dt = timed(lambda: srv.serve_requests(reqs, default_new_tokens=64))
    launches = {"K3": cuda_decode.LAUNCHES["decode_attention"],
                "K4": cuda_decode.LAUNCHES["paged_decode_attention"]}
    n = sum(r["n_generated"] for r in resp)
    if [r["n_generated"] for r in resp] != [q["n_tokens"] for q in reqs]:
        fail(f"9: {cfg['scheduler']} returned wrong token counts")
    st = dict(srv.last_stats)
    return {"tokens": [r["tokens"] for r in resp], "resp": resp,
            "stats": {k: st.get(k) for k in (
                "accept_rate", "rounds", "target_passes", "drafted",
                "accepted", "decode_steps", "prefills", "preemptions")},
            "tokens_per_sec": n / dt, "seconds": dt, "launches": launches}


def round_breakdown(dev, art: Path, draft: Path, reqs: list) -> dict:
    """Where a speculative round of the continuous pool goes: a SpecLMEngine
    (8 slots full, k_draft SPEC_K) runs SPEC_ROUNDS rounds as served (host
    wall a round), then as many with each device call of the round timed
    alone (a sync before and after it): the draft's eager extend_rows, its
    k - 1 captured decode_rows, the target's eager verify; the rest (the
    draws, the host sync, the commit) by subtraction. Also the device busy
    share of the served rounds under torch.profiler."""
    import torch

    from tempo_tpu_torch.infer.serving import ContinuousLMServer, SpecLMEngine

    rounds = SPEC_ROUNDS
    srv = ContinuousLMServer(art, n_slots=LM_SLOTS, prefill_chunk=LM_CHUNK,
                             draft_dir=draft, k_draft=SPEC_K, device=dev)
    eng = SpecLMEngine(srv)
    for r in reqs[:LM_SLOTS]:
        eng.submit(dict(r, n_tokens=3 * (SPEC_K + 1) * rounds + 2))
    eng.step()  # admission, and the captures of the first round
    torch.cuda.synchronize()
    _, served = timed(lambda: [eng.step() for _ in range(rounds)])
    prof = device_profile(lambda: [eng.step() for _ in range(rounds)],
                          cpu=False)
    parts = {"draft_extend_eager": 0.0, "draft_steps_captured": 0.0,
             "target_verify_eager": 0.0}

    def alone(part, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[part] += time.perf_counter() - t0
            return out
        return call

    srv.d_extend_rows = alone("draft_extend_eager", srv.d_extend_rows)
    srv.d_decode_rows = alone("draft_steps_captured", srv.d_decode_rows)
    srv.t_extend_rows = alone("target_verify_eager", srv.t_extend_rows)
    _, split = timed(lambda: [eng.step() for _ in range(rounds)])
    ms = {k: 1e3 * v / rounds for k, v in parts.items()}
    ms["draws_sync_commit"] = 1e3 * split / rounds - sum(ms.values())
    return {"round_ms_served": 1e3 * served / rounds,
            "round_ms_split": 1e3 * split / rounds, "parts_ms": ms,
            "busy_share": (None if prof is None else
                           prof["device_ms"] / (1e3 * served)),
            "accept_rate": round(eng.accepted / eng.drafted, 4)}


def online_check(dev, art: Path, draft: Path, reqs: list, tmp: Path,
                 card: str) -> dict:
    """9c: OnlineLMServer over the continuous pool (fused, k LM_K), the
    paged pool (fused) and the continuous pool with ``draft``; ONLINE_REQS
    requests submitted from ONLINE_THREADS threads at staggered times, each
    response bitwise the same server's batch-mode one; one long request
    cancelled mid-flight on the speculative pool (a prefix of its
    batch-mode stream, flagged); cli/serve_lm.py's _serve_http with
    ``online`` answering two concurrent POST /v1/completions as batch mode
    does. Nothing here touches CUDA while an online server runs, but its
    scheduler thread. Returns the metrics."""
    import threading

    import torch

    from tempo_tpu_torch.cli.serve_lm import build_server
    from tempo_tpu_torch.ops import cuda_decode

    fused = {"slots": LM_SLOTS, "k_decode": LM_K, "prefill_chunk": LM_CHUNK}
    pools = {
        "continuous": {"scheduler": "continuous", **fused},
        "paged": {"scheduler": "paged", "n_pages": LM_POOLS["roomy"],
                  **fused},
        "continuous_draft": {"scheduler": "continuous", "slots": LM_SLOTS,
                             "prefill_chunk": LM_CHUNK,
                             "draft_artifacts": str(draft),
                             "k_draft": SPEC_K},
    }
    few = [dict(r, logprobs=True) if i % 4 == 3 else dict(r)
           for i, r in enumerate(reqs[:ONLINE_REQS])]
    long = {"tokens": reqs[0]["tokens"], "n_tokens": ONLINE_CANCEL_NEW}
    out = {}
    for name, extra in pools.items():
        cfg = {"artifacts": str(art), **extra}
        batch_reqs = few + ([long] if name == "continuous_draft" else [])
        srv = build_server(cfg, dev)
        srv.serve_requests(batch_reqs[:2])  # captures the graphs
        want = srv.serve_requests(batch_reqs)
        torch.cuda.synchronize()
        del srv
        for key in cuda_decode.LAUNCHES:
            cuda_decode.LAUNCHES[key] = 0
        online = build_server(dict(cfg, online=True), dev)
        got, cancel = [None] * len(few), {}
        t0 = time.perf_counter()
        try:
            if name == "continuous_draft":
                ticket = online.submit(long)

            def client(c):
                tickets = {}
                time.sleep(0.05 * c)  # staggered arrivals
                for i in range(c, len(few), ONLINE_THREADS):
                    tickets[i] = online.submit(few[i])
                    time.sleep(0.02)
                for i, t in tickets.items():
                    got[i] = online.result(t, timeout=300)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(ONLINE_THREADS)]
            for th in threads:
                th.start()
            if name == "continuous_draft":
                deadline = time.monotonic() + 120
                while online.stats()["rounds"] < ONLINE_CANCEL_AFTER:
                    if time.monotonic() > deadline:
                        fail("9c: the online speculative pool made no "
                             "rounds")
                    time.sleep(0.002)
                cancel["cancelled"] = online.cancel(ticket)
                cancel["resp"] = online.result(ticket, timeout=300)
            for th in threads:
                th.join(300)
            if name == "continuous":
                http = online_http(online, cfg, tmp, few[:2], want[:2])
            stats = online.stats()
        finally:
            online.close(300)
        wall = time.perf_counter() - t0
        launches = {"K3": cuda_decode.LAUNCHES["decode_attention"],
                    "K4": cuda_decode.LAUNCHES["paged_decode_attention"]}
        # tokens and logprobs (a response's slot depends on arrival)
        same = [g is not None and g["tokens"] == w["tokens"]
                and g.get("logprobs") == w.get("logprobs")
                for g, w in zip(got, want)]
        out[name] = {"bitwise_equal": all(same), "equal_share":
                     sum(same) / len(same), "wall_s": wall,
                     "launches": launches, "stats": stats}
        if name == "continuous_draft":
            r, ref = cancel["resp"], want[-1]["tokens"]
            out[name]["cancel"] = {
                "cancel_returned": cancel["cancelled"],
                "flagged": bool(r.get("cancelled")),
                "n_tokens": len(r["tokens"]), "of": len(ref),
                "prefix": r["tokens"] == ref[:len(r["tokens"])]}
        print(f"[9c] online {name}: {json.dumps(out[name])} on {card} "
              f"(responses compared whole, tokens and logprobs, with the "
              f"same server's batch mode; wall: the {len(few)} requests "
              f"from {ONLINE_THREADS} threads)", flush=True)
        if not all(same):
            fail(f"9c: online {name} responses differ from batch mode")
        if name == "paged" and launches["K4"] == 0:
            fail("9c: the online paged pool launched no K4")
    c = out["continuous_draft"]["cancel"]
    if not (c["cancel_returned"] and c["flagged"] and c["prefix"]
            and c["n_tokens"] < c["of"]):
        fail(f"9c: the mid-flight cancellation did not return a flagged "
             f"prefix: {c}")
    out["http"] = http
    return out


def online_http(online, cfg: dict, tmp: Path, two: list, want: list) -> dict:
    """9c: _serve_http with online over the running OnlineLMServer, two
    concurrent POST /v1/completions (one prompt each), each equal to the
    batch-mode response of its request."""
    import threading
    import urllib.request

    from tempo_tpu_torch.cli.serve_lm import _serve_http

    out_dir = tmp / "http_online"
    out_dir.mkdir()
    th = threading.Thread(target=_serve_http, args=(online, {
        **cfg, "host": "127.0.0.1", "port": 0, "max_requests": 2}, out_dir,
        64), kwargs={"online": True}, daemon=True)
    th.start()
    info = out_dir / "serving_info.yaml"
    deadline = time.monotonic() + 60
    while not (info.exists() and info.read_text().strip()):
        if time.monotonic() > deadline:
            fail("9c: the online HTTP server did not start")
        time.sleep(0.02)
    base = f"http://127.0.0.1:{json.loads(info.read_text())['port']}"
    got = [None, None]

    def post(i):
        body = json.dumps({"prompt": two[i]["tokens"],
                           "max_tokens": two[i]["n_tokens"]}).encode()
        req = urllib.request.Request(f"{base}/v1/completions", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got[i] = json.loads(r.read())["choices"][0]["tokens"]

    posts = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
    for p in posts:
        p.start()
    for p in posts:
        p.join(120)
    th.join(60)
    if th.is_alive():
        fail("9c: the online HTTP server did not stop after two requests")
    equal = got == [w["tokens"] for w in want]
    print(f"[9c] HTTP online on 127.0.0.1: two concurrent POST "
          f"/v1/completions equal batch mode: {equal}", flush=True)
    if not equal:
        fail("9c: online /v1/completions differ from batch mode")
    return {"completions_equal_batch": equal}


def speculative_path(dev, rows: dict, fused: dict, exports: "LMExports",
                     after_9a=lambda: None) -> dict:
    """Phase 9: speculation and the online server from exported
    GPT-2-small. 9a bf16: continuous + draft and paged + draft over the
    first SPEC_REQUESTS requests, the batch-1 speculative scheduler over
    the first SPEC_BATCH1, each with the self-draft and the distinct draft
    beside the same scheduler target-only: tokens/s, accept_rate, rounds,
    target passes, K3/K4 launches, greedy agreement with target-only
    (reported);
    9b fp32: the same with the target and the distinct draft in fp32 over
    SPEC_F32 requests, every greedy stream equal to target-only's but at a
    near-tie; 9c the online servers. ``fused`` is 3d's serve_lm
    statistics (k 16, the same run), printed beside. Adds the launches to
    the K3/K4 rows; returns the metrics."""
    import tempfile

    from tempo_tpu_torch.infer import export_lm
    from tempo_tpu_torch.nn.transformer import TransformerConfig

    t_phase = time.perf_counter()
    card = smi_line()

    reqs = lm_workload(TransformerConfig(**SPEC_TARGET).in_size)
    result, seconds = {"card": card}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        arts = {(model, dtype): exports.path(f"{model}_{short}")
                for model in ("target", "draft")
                for dtype, short in (("bfloat16", "bf16"),
                                     ("float32", "fp32"))}
        seconds["export_wait"] = time.perf_counter() - t0
        # loaded once for the phase: every server and prefill below shares
        # these surfaces (and their graphs) instead of loading them anew
        loaded = [export_lm.load_exported_lm(a, dev) for a in arts.values()]
        seconds["load"] = time.perf_counter() - t0 - seconds["export_wait"]
        launches, gaps = {}, {}

        # ------------------------------------------------ 9a, bf16, timed
        t0 = time.perf_counter()
        target = arts["target", "bfloat16"]
        drafts = {"self": target, "distinct": arts["draft", "bfloat16"]}
        runs = {}
        for pool in ("continuous", "paged", "speculative"):
            work = reqs[:SPEC_REQUESTS if pool != "speculative"
                        else SPEC_BATCH1]
            ref = spec_run(spec_configs(target, None, pool), work, dev,
                           work[:2])
            runs[pool, "none"] = ref
            launches[pool] = ref["launches"]
            for dname, ddir in drafts.items():
                run = spec_run(spec_configs(target, ddir, pool), work, dev,
                               work[:2])
                run["agreement"] = agreement(run["tokens"], ref["tokens"],
                                             work, target, dev, gaps)
                runs[pool, dname] = run
                launches[f"{pool}+{dname}"] = run["launches"]
                if run["launches"]["K3"] == 0:
                    fail(f"9a: {pool} with the {dname} draft launched no K3")
            for dname in ("none", "self", "distinct"):
                run = runs[pool, dname]
                line = {"tokens_per_sec": run["tokens_per_sec"],
                        "seconds": run["seconds"], **run["stats"],
                        "launches": run["launches"]}
                if dname != "none":
                    line["greedy_agreement"] = run["agreement"]
                print(f"[9a] {pool} draft={dname} bf16: {json.dumps(line)} "
                      f"on {card} (host wall of the counted run after a "
                      f"2-request warm-up; draft none: the same scheduler "
                      f"target-only, per token"
                      + (", batch 1" if pool == "speculative" else "")
                      + "; agreement reported, not a gate: bf16 verify "
                      "(t = k + 1) and decode (K3/K4, t = 1) may round a "
                      "near-tie apart)", flush=True)
        for dname, ddir in drafts.items():
            result[f"round_{dname}"] = br = round_breakdown(dev, target,
                                                           ddir, reqs)
            print(f"[9a] a round of continuous + the {dname} draft, 8 slots "
                  f"full: {json.dumps(br)} on {card} (host wall a round, "
                  f"served and with each device call timed alone between "
                  f"syncs; busy_share: device kernel time under "
                  f"torch.profiler over the served rounds' wall)",
                  flush=True)
        print(f"[9a] beside: 3d's fused servers (k {LM_K}, the same run): "
              f"{json.dumps({k: fused[k]['tokens_per_sec'] for k in fused})}"
              f" tokens/s", flush=True)
        result["bf16"] = {f"{p}+{d}": {
            "tokens_per_sec": r["tokens_per_sec"], "seconds": r["seconds"],
            **r["stats"], "launches": r["launches"],
            **({"agreement": r["agreement"]} if d != "none" else {})}
            for (p, d), r in runs.items()}
        del runs
        seconds["9a"] = time.perf_counter() - t0
        after_9a()  # what may run beside 9b and 9c: gates, not timings

        # ------------------------------------------------- 9b, fp32 gate
        t0 = time.perf_counter()
        n_greedy, n_sampled = SPEC_F32
        f32_reqs = ([dict(r, n_tokens=SPEC_F32_NEW)
                     for r in reqs[:n_greedy]]
                    + [dict(r, n_tokens=SPEC_F32_NEW, temperature=0.8,
                            top_k=50, seed=i)
                       for i, r in enumerate(
                           reqs[n_greedy:n_greedy + n_sampled])])
        target = arts["target", "float32"]
        drafts = {"self": target, "distinct": arts["draft", "float32"]}
        gate, f32 = True, {}
        for pool in ("continuous", "paged", "speculative"):
            ref = spec_run(spec_configs(target, None, pool), f32_reqs, dev,
                           f32_reqs[:2])
            for dname, ddir in drafts.items():
                run = spec_run(spec_configs(target, ddir, pool), f32_reqs,
                               dev, f32_reqs[:2])
                greedy = agreement(run["tokens"][:n_greedy],
                                   ref["tokens"][:n_greedy], f32_reqs,
                                   target, dev, gaps)
                sampled_equal = (run["tokens"][n_greedy:]
                                 == ref["tokens"][n_greedy:])
                ties = [d for d in greedy["first_differences"]
                        if d["gap"] <= F32_TOL["atol"]
                        + F32_TOL["rtol"] * abs(d["top"])]
                ok = len(ties) == len(greedy["first_differences"])
                gate &= ok
                f32[f"{pool}+{dname}"] = {
                    "greedy": greedy, "sampled_equal": sampled_equal,
                    "accept_rate": run["stats"]["accept_rate"],
                    "rounds": run["stats"]["rounds"], "ok": ok}
                print(f"[9b] {pool} draft={dname} fp32: greedy streams "
                      f"equal to target-only {greedy['equal_share']:.3f} "
                      f"(first differences, each with the reference's "
                      f"top-two gap: {json.dumps(greedy['first_differences'])}"
                      f"; allowed at a gap <= {F32_TOL}); sampled streams "
                      f"equal: {sampled_equal}; accept_rate "
                      f"{run['stats']['accept_rate']}; ok {ok}", flush=True)
        result["f32"] = f32
        seconds["9b"] = time.perf_counter() - t0
        if not gate:
            fail("9b: an fp32 speculative greedy stream differs from "
                 "target-only away from a near-tie")

        # ---------------------------------------------------- 9c, online
        t0 = time.perf_counter()
        result["online"] = online_check(dev, arts["target", "bfloat16"],
                                        arts["draft", "bfloat16"], reqs, tmp,
                                        card)
        launches["online_paged"] = result["online"]["paged"]["launches"]
        seconds["9c"] = time.perf_counter() - t0
        del loaded
    for name in ("K3", "K4"):
        rows[name]["launches_phase9"] = {k: v[name]
                                         for k, v in launches.items()}
    seconds["9"] = time.perf_counter() - t_phase
    result["seconds"] = seconds
    print(f"[9] K3/K4 launches by run: {json.dumps(launches)}; "
          f"[time] 9: {json.dumps(seconds)}", flush=True)
    return result


HELD: list = []  # loaded LM surfaces kept for later phases (export_lm
# shares a load of a directory only while something holds it)
EXPORT_TIMEOUT = 900  # s a background export may take, counted from its start


class LMExports:
    """The background processes that export LM_EXPORTS (``export_child``),
    one each, all started at once; ``path(name)`` waits for one and returns
    its directory (failing the run if it failed). A process still running
    when the run ends is killed."""

    def __init__(self, root: Path):
        self.root, self.procs, self.results = root, {}, {}
        self.t0 = time.perf_counter()
        for name, (shape, seed, dtype, where, chunk, page) in \
                LM_EXPORTS.items():
            spec = {"shape": shape, "seed": seed, "dtype": dtype,
                    "device": where, "decode_chunk": chunk,
                    "page_size": page, "max_seq": LM_CACHE,
                    "out": str(root / name),
                    "result": str(root / f"{name}.json")}
            (root / f"{name}_spec.json").write_text(json.dumps(spec))
            env = dict(os.environ, OMP_NUM_THREADS="1")
            if where == "cpu":
                env["CUDA_VISIBLE_DEVICES"] = ""  # traced without a card
            log = open(root / f"{name}.log", "w")
            self.procs[name] = (subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.export_child(sys.argv[1])",
                 str(root / f"{name}_spec.json")],
                cwd=Path(__file__).resolve().parent, stdout=log,
                stderr=subprocess.STDOUT, env=env), log)
        atexit.register(self.stop)

    def path(self, name: str) -> Path:
        if name not in self.results:
            proc, log = self.procs[name]
            left = EXPORT_TIMEOUT - (time.perf_counter() - self.t0)
            try:
                rc = proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                self.stop()
                fail(f"the export of {name} took over {EXPORT_TIMEOUT} s")
            log.close()
            if rc:
                tail = (self.root / f"{name}.log").read_text()[-6000:]
                fail(f"the export of {name} failed (rc {rc}):\n{tail}")
            res = json.loads((self.root / f"{name}.json").read_text())
            res["waited_until_s"] = time.perf_counter() - self.t0
            self.results[name] = res
            print(f"[export] {name} {json.dumps(LM_EXPORTS[name])}: "
                  f"{json.dumps(res)} (a background process since the "
                  f"run's start, beside the phases that ran meanwhile)",
                  flush=True)
        return self.root / name

    def stop(self) -> None:
        for proc, log in self.procs.values():
            stop_process(proc)
            log.close()


def stop_process(proc: subprocess.Popen) -> None:
    """Kill ``proc`` if it still runs (a failed run leaves none behind)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def export_child(spec_path: str) -> None:
    """One LM_EXPORTS entry, in a process of its own (LMExports): the model
    built from its seed on the device that traces (its weights quantized
    for a ``quantize`` entry), then export_lm; writes the seconds (build,
    export) to the spec's ``result``."""
    import dataclasses

    import torch

    torch.set_num_threads(1)
    from tempo_tpu_torch.infer.export_lm import export_lm
    from tempo_tpu_torch.nn.transformer import Transformer, TransformerConfig

    spec = json.loads(Path(spec_path).read_text())
    t0 = time.perf_counter()
    shape = dict(spec["shape"])
    quantize = shape.pop("quantize", "none")
    cfg = TransformerConfig(compute_dtype=spec["dtype"], **shape)
    model = Transformer(cfg, device=spec["device"], seed=spec["seed"])
    state = model.state_dict()
    if quantize == "int8":
        from tempo_tpu_torch.nn.quant import quantize_lm_params

        cfg = dataclasses.replace(cfg, quantize="int8")
        state = quantize_lm_params(state)
    t1 = time.perf_counter()
    export_lm(state, cfg, spec["out"], max_seq=spec["max_seq"],
              decode_chunk=spec["decode_chunk"],
              page_size=spec["page_size"])
    Path(spec["result"]).write_text(json.dumps({
        "traced_on": spec["device"], "build_s": t1 - t0,
        "export_s": time.perf_counter() - t1}))


def clone_cache(cache):
    """A copy of a cache; a paged one keeps one table for all layers."""
    if len(cache[0]) == 2:
        return tuple((ck.clone(), cv.clone()) for ck, cv in cache)
    tab = cache[0][2].clone()
    return tuple((pk.clone(), pv.clone(), tab) for pk, pv, _ in cache)


def program_bases(live, b: int) -> dict:
    """Phase 10's starting state at batch b, through the live surface: a
    dense cache prefilled to PROGRAMS_POS positions, a pool of the roomy
    page count holding the same rows through a shuffled table, and a
    batch-1 row cache of PROGRAMS_POS // 6 positions."""
    import numpy as np
    import torch

    dev = live.device
    vocab = int(live.meta["vocab_size"])
    rng = np.random.default_rng(SEED + 20 + b)
    mp = LM_CACHE // LM_PAGE
    n_pages = LM_POOLS["roomy"]
    with torch.no_grad():
        _, dense = live.prefill(rng.integers(0, vocab, (b, PROGRAMS_POS)))
        _, row = live.prefill(rng.integers(0, vocab,
                                           (1, PROGRAMS_POS // 6)))
        table = (1 + torch.randperm(n_pages - 1, device=dev))[:b * mp]
        table = table.reshape(b, mp).to(torch.int32)
        shape = (n_pages, LM_PAGE) + tuple(dense[0][0].shape[2:])
        paged = tuple((torch.zeros(shape, dtype=dense[0][0].dtype,
                                   device=dev),
                       torch.zeros(shape, dtype=dense[0][0].dtype,
                                   device=dev), table) for _ in dense)
        for r in range(b):
            live.admit_paged(paged, tuple((ck[r:r + 1], cv[r:r + 1])
                                          for ck, cv in dense), table[r])
    return {"dense": dense, "paged": paged, "row": row,
            "rows_pos": PROGRAMS_POS - PROGRAMS_POS // 30 * np.arange(b)}


def run_program(surface, name: str, i: int, b: int, base: dict):
    """One call of program ``name`` through ``surface`` (nothing captured)
    at batch b and the i-th (0 or 1) of two positions, from copies of the
    base caches: (outputs, the cache afterwards). Inputs depend on (name,
    i, b) alone, so two surfaces get the same ones."""
    import numpy as np

    rng = np.random.default_rng(SEED + 30 + 2 * b + i)
    vocab = int(surface.meta["vocab_size"])
    tok = rng.integers(0, vocab, (b, 1))
    block = rng.integers(0, vocab, (b, 5))
    if name == "prefill":
        return surface.prefill(rng.integers(0, vocab,
                                            (b, (7, PROGRAMS_POS)[i])))
    if name == "admit":
        return surface.admit(clone_cache(base["dense"]), base["row"],
                             (0, b - 1)[i])
    if name == "admit_paged":
        cache = clone_cache(base["paged"])
        return surface.admit_paged(cache, base["row"],
                                   cache[0][2][(0, b - 1)[i]])
    paged = "paged" in name
    cache = clone_cache(base["paged"] if paged else base["dense"])
    rows = paged or name in ("decode_rows", "extend_rows", "decode_k_rows",
                             "decode_k_sample")
    pos = (base["rows_pos"] if rows else PROGRAMS_POS) + i * LM_K
    call = getattr(surface, "extend" if name.startswith("extend") else name)
    args = (block if name.startswith("extend") else tok, cache, pos)
    if name.endswith("_sample"):
        args += (np.arange(b) * 7 + i, np.where(np.arange(b) % 2, 0.0, 0.8),
                 np.full(b, 50), np.full(b, 0.9))
    return call(*args)


class ProgramsChildren:
    """Phase 10's two processes (``programs_child``: a fresh process's
    loads and greedy decode of the card's artifact; ``programs_check_child``:
    the CPU's artifact held against the live model), started together
    once both artifacts exist; ``results()`` waits for them. Their loads
    are host work, so they run beside 9b and 9c (gates, not timings)."""

    def __init__(self, exports: LMExports, dev):
        import numpy as np

        from tempo_tpu_torch.nn.transformer import TransformerConfig

        self.tmp = tempfile.TemporaryDirectory()
        vocab = TransformerConfig(**SPEC_TARGET).in_size
        self.prompt = np.random.default_rng(SEED + 40).integers(
            0, vocab, (LM_BATCH, LM_PROMPT))
        self.procs = {}
        for child, name in (("programs_child", "target_bf16"),
                            ("programs_check_child", "target_bf16_cpu")):
            tmp = Path(self.tmp.name)
            spec = {"dir": str(exports.path(name)),
                    "prompt": self.prompt.tolist(), "new": PROGRAMS_NEW,
                    "device": dev.type, "out": str(tmp / f"{child}.json"),
                    # what the check reads of this script's settings
                    "settings": {k: globals()[k] for k in (
                        "SPEC_TARGET", "LM_CACHE", "LM_K", "LM_PAGE",
                        "LM_POOLS", "PROGRAMS_BATCHES", "PROGRAMS_POS")}}
            (tmp / f"{child}_spec.json").write_text(json.dumps(spec))
            log = open(tmp / f"{child}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 f"chip_smoke.{child}(sys.argv[1])",
                 str(tmp / f"{child}_spec.json")],
                cwd=Path(__file__).resolve().parent, stdout=log,
                stderr=subprocess.STDOUT)
            atexit.register(stop_process, proc)
            self.procs[child] = (proc, log, spec["out"])

    def results(self) -> dict:
        out = {}
        for child, (proc, log, path) in self.procs.items():
            try:
                rc = proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                stop_process(proc)
                fail(f"10: {child} took over 600 s")
            log.close()
            if rc:
                fail(f"10: {child} failed (rc {rc}):\n"
                     f"{Path(log.name).read_text()[-6000:]}")
            out[child] = json.loads(Path(path).read_text())
        self.tmp.cleanup()
        return out


def programs_bitwise(live, surface) -> dict:
    """{program: whether ``surface``'s call (nothing captured) equals
    ``live``'s bitwise, outputs and caches, at every batch of
    PROGRAMS_BATCHES and both positions}."""
    import torch

    from tempo_tpu_torch.infer import export_lm

    same = {}
    with torch.no_grad():
        for b in PROGRAMS_BATCHES:
            base = program_bases(live, b)
            for name in export_lm.program_names(live.meta):
                for i in (0, 1):
                    ok = bitwise(run_program(surface, name, i, b, base),
                                 run_program(live, name, i, b, base))
                    same[name] = same.get(name, True) and ok
            del base
    return same


def programs_check_child(spec_path: str) -> None:
    """Phase 10's check of one artifact in a process of its own: every
    program loaded on the card, each held bitwise against the live model's
    call (``programs_bitwise``). Writes the load seconds and the result to
    the spec's ``out``."""
    import torch

    from tempo_tpu_torch.infer import export_lm
    from tempo_tpu_torch.nn.transformer import Transformer, TransformerConfig

    spec = json.loads(Path(spec_path).read_text())
    globals().update(spec["settings"])
    dev = torch.device(spec["device"])
    model = Transformer(TransformerConfig(compute_dtype="bfloat16",
                                          **SPEC_TARGET), device=dev,
                        seed=SEED)
    live = export_lm._live_surface(model, LM_CACHE, LM_K, LM_PAGE, dev,
                                   captured=False)
    t0 = time.perf_counter()
    loaded = export_lm._load(spec["dir"], dev,
                             *export_lm.program_names(live.meta))
    load_s = time.perf_counter() - t0
    Path(spec["out"]).write_text(json.dumps({
        "load_all_s": load_s,
        "bitwise": programs_bitwise(live, loaded.uncaptured())}))


def programs_child(spec_path: str) -> None:
    """Phase 10's fresh process: every loader of one artifact directory
    with device None, timed, with torch.cuda.memory_allocated around it;
    the same loaders again (a second load shares the first's surface);
    then greedy_decode_exported. Writes the seconds, the bytes, the tokens
    and the tempo_tpu_torch.nn modules imported to the spec's ``out``."""
    import torch

    from tempo_tpu_torch.infer import export_lm as e

    spec = json.loads(Path(spec_path).read_text())
    d = spec["dir"]
    on_card = spec["device"] == "cuda"  # "cpu" only in a CPU rehearsal
    device = None if on_card else "cpu"
    if on_card:
        torch.zeros(1, device="cuda")  # the context, before the baseline
        torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated if on_card else (lambda: 0)
    loaders = (e.load_exported_lm, e.load_exported_continuous,
               e.load_exported_extend_rows, e.load_exported_decode_k,
               e.load_exported_decode_k_sample, e.load_exported_paged,
               e.load_exported_extend_paged, e.load_exported_paged_k,
               e.load_exported_speculative)
    before = allocated()
    t0 = time.perf_counter()
    held = [load(d, device) for load in loaders]
    first_s = time.perf_counter() - t0
    after = allocated()
    t0 = time.perf_counter()
    held += [load(d, device) for load in loaders]
    second_s = time.perf_counter() - t0
    t0 = time.perf_counter()  # the tokens come back to the host: synced
    tokens = e.greedy_decode_exported(d, spec["prompt"], spec["new"], device)
    decode_s = time.perf_counter() - t0
    Path(spec["out"]).write_text(json.dumps({
        "first_load_s": first_s, "second_load_s": second_s,
        "allocated_before": before, "allocated_after": after,
        "decode_s": decode_s, "tokens": tokens.tolist(),
        "nn_modules": sorted(m for m in sys.modules
                             if m.startswith("tempo_tpu_torch.nn"))}))
    del held


def live_artifacts(model, root: Path, dev):
    """A directory that cli/serve_lm.py's build_server takes for artifacts
    but that serves a live model: its meta.json, and the live surface put
    first in export_lm's table of loaded surfaces (which a load consults
    before reading the directory). Returns (directory, surface): the
    caller holds the surface for as long as the directory is used."""
    from tempo_tpu_torch.infer import export_lm

    surface = export_lm._live_surface(model, LM_CACHE, LM_K, LM_PAGE, dev)
    path = root / "live"
    path.mkdir()
    (path / "meta.json").write_text(json.dumps(surface.meta))
    export_lm._LOADED[(str(path.resolve()), str(dev))] = surface
    return path, surface


def replay_profile(surface, cache, tok, pos) -> dict:
    """One captured decode_k replay (captured first) of ``surface`` at
    ``cache``: its device ms by CUDA events and by torch.profiler, the
    device kernels the profiler lists in one replay, and whether the
    cache's tensors kept their addresses."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ptrs = [t.data_ptr() for layer in cache for t in layer]
    surface.decode_k(tok, cache, pos)
    torch.cuda.synchronize()
    ms = time_ms(lambda: surface.decode_k(tok, cache, pos), iters=5,
                 warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        surface.decode_k(tok, cache, pos)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    return {"ms": ms, "profiled_device_ms": sum(
        e.time_range.elapsed_us() for e in events) / 1e3,
        "kernels": len(kernels),
        "device_events": len(events),
        "addresses_kept": ptrs == [t.data_ptr() for layer in cache
                                   for t in layer]}


def programs_path(dev, rows: dict, exports: LMExports,
                  children: "ProgramsChildren") -> dict:
    """Phase 10: GPT-2-small's serving programs (bf16, max_seq LM_CACHE,
    page LM_PAGE, decode_chunk LM_K), exported on the card and on the CPU
    by background processes. (a) export seconds by program, the directory's
    bytes beside the weights'; (b) a fresh process's first and second load,
    its device memory across the loads and its greedy decode, which must
    import no model code and equal generate's; (c) each program, through
    both artifacts, bitwise the live model's call (the same bodies over
    nn/transformer.py) at PROGRAMS_BATCHES and two positions, outputs and
    caches, the CPU's artifact in a process of its own (b and that half of
    c run in ``children``, started after 9a's timed runs: loading is host
    work); (d) one captured decode_k replay (b=8, K=LM_K), exported and
    live: device ms, kernels, cache addresses; (e) serve_lm's continuous
    and paged schedulers over the programs beside the same over a live
    surface: tokens/s, the same greedy tokens and K3/K4 launches. Every
    gate is checked after all is printed."""
    import numpy as np
    import torch

    from tempo_tpu_torch.cli.serve_lm import _serve_batch, build_server
    from tempo_tpu_torch.infer import export_lm
    from tempo_tpu_torch.nn.transformer import (Transformer,
                                                TransformerConfig, generate)
    from tempo_tpu_torch.ops import cuda_decode

    card = smi_line()
    out, bad, seconds = {"card": card}, [], {}
    t_phase = time.perf_counter()
    arts = {"card": exports.path("target_bf16"),
            "cpu": exports.path("target_bf16_cpu")}
    seconds["export_wait"] = time.perf_counter() - t_phase

    # ----------------------------------------- (a) seconds and bytes
    for where, art in arts.items():
        meta = json.loads((art / "meta.json").read_text())
        files = {p.name: p.stat().st_size for p in art.iterdir()}
        weights = torch.load(art / "weights.pt", map_location="cpu",
                             weights_only=True)
        w_bytes = sum(w.numel() * w.element_size() for w in weights.values())
        del weights
        r = out[f"exported_on_{where}"] = {
            "programs": len(meta["programs"]),
            "export_s": meta["export_seconds"],
            "export_s_total": sum(meta["export_seconds"].values()),
            "process": exports.results[
                "target_bf16" if where == "card" else "target_bf16_cpu"],
            "weights_bytes": w_bytes, "weights_pt_bytes": files["weights.pt"],
            "programs_bytes": sum(v for k, v in files.items()
                                  if k.endswith(".pt2")),
            "dir_bytes": sum(files.values())}
        print(f"[10] exported on the {where}: {json.dumps(r)} (export_s: "
              f"each program's trace and save in its background process) "
              f"on {card}", flush=True)
        if len(meta["programs"]) != 14:
            bad.append(f"{where}: {len(meta['programs'])} programs, want 14")
        if not r["weights_pt_bytes"] <= 1.1 * w_bytes:
            bad.append(f"{where}: weights.pt {r['weights_pt_bytes']} bytes "
                       f"for {w_bytes} of weights")
    seconds["a"] = time.perf_counter() - t_phase

    # -------- (b), (c): the two processes started after 9a, and this
    # process's own check
    t0 = time.perf_counter()
    cfg = TransformerConfig(compute_dtype="bfloat16", **SPEC_TARGET)
    model = Transformer(cfg, device=dev, seed=SEED)
    want = generate(model, children.prompt, PROGRAMS_NEW, temperature=0.0,
                    cache_dtype=torch.bfloat16, cache_len=LM_CACHE).cpu()

    # (c) in this process: the card's artifact, every program loaded
    live = export_lm._live_surface(model, LM_CACHE, LM_K, LM_PAGE, dev,
                                   captured=False)
    tl = time.perf_counter()
    captured = export_lm._load(arts["card"], dev,
                               *export_lm.program_names(live.meta))
    out["exported_on_card"]["load_rest_s"] = time.perf_counter() - tl
    HELD.append(captured)
    same = {"card": programs_bitwise(live, captured.uncaptured())}

    results = children.results()
    res = results["programs_child"]
    w_bytes = out["exported_on_card"]["weights_bytes"]
    res["allocated_rise"] = res["allocated_after"] - res["allocated_before"]
    res["allocated_rise_over_weights"] = res["allocated_rise"] / w_bytes
    res["tokens_equal_generate"] = res.pop("tokens") == want.tolist()
    out["fresh_process"] = res
    print(f"[10] a fresh process: every loader of the card's artifact "
          f"(device None), then again, then greedy_decode_exported of "
          f"{PROGRAMS_NEW} tokens after [{LM_BATCH}, {LM_PROMPT}]: "
          f"{json.dumps(res)} (gates: no tempo_tpu_torch.nn module, memory "
          f"rise <= 1.1x the weights' {w_bytes} bytes, tokens equal "
          f"generate's; beside another process's check of the CPU's "
          f"artifact and this one's of the card's) on {card}", flush=True)
    if res["nn_modules"]:
        bad.append(f"loading imported {res['nn_modules']}")
    if not res["allocated_rise"] <= 1.1 * w_bytes:
        bad.append(f"loading took {res['allocated_rise']} bytes of device "
                   f"memory for {w_bytes} of weights")
    if not res["tokens_equal_generate"]:
        bad.append("the fresh process's greedy decode differs from "
                   "generate's")
    check = results["programs_check_child"]
    out["exported_on_cpu"]["load_all_s"] = check["load_all_s"]
    same["cpu"] = check["bitwise"]
    out["bitwise"] = same
    print(f"[10] each program (nothing captured) bitwise the live model's "
          f"call, outputs and caches, at batches {PROGRAMS_BATCHES} and two "
          f"positions each (the CPU's artifact checked in a process of its "
          f"own): {json.dumps(same)}", flush=True)
    for where, by_name in same.items():
        bad += [f"{name} exported on the {where}: not bitwise the live "
                f"call at every batch and position"
                for name, ok in by_name.items() if not ok]
    seconds["b_c"] = time.perf_counter() - t0

    # ----------------------- (d) one captured decode_k replay, b = 8
    t0 = time.perf_counter()
    base = program_bases(live, LM_BATCH)
    tok = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
        0, cfg.in_size, (LM_BATCH, 1))).to(dev)
    live_captured = export_lm._live_surface(model, LM_CACHE, LM_K, LM_PAGE,
                                            dev)
    pos = torch.tensor(PROGRAMS_POS, dtype=torch.int32, device=dev)
    replay = {}
    for name, s in (("exported", captured), ("live", live_captured)):
        cache = clone_cache(base["dense"])
        replay[name] = replay_profile(s, cache, tok, pos)
        eager = s.uncaptured()
        replay[name]["graph_nodes"] = len(graph_nodes(
            lambda: eager.decode_k(tok, cache, pos)))
        del cache
    del base
    replay["nodes_fewer_by"] = (replay["live"]["graph_nodes"]
                                - replay["exported"]["graph_nodes"])
    out["decode_k_replay"] = replay
    print(f"[10] one captured decode_k replay, b={LM_BATCH}, K={LM_K}, "
          f"exported (on the card) and live: {json.dumps(replay)} (ms: CUDA "
          f"events, cold L2; kernels: what torch.profiler lists of one "
          f"replay, which has varied by up to 36 between runs of one graph; "
          f"graph_nodes: the nodes of the graph the call captures, the "
          f"gate) on {card}", flush=True)
    for name, r in replay.items():
        if isinstance(r, dict) and not r["addresses_kept"]:
            bad.append(f"the {name} replay moved a cache tensor")
    if replay["nodes_fewer_by"] != 2 * LM_K:
        bad.append(f"the exported decode_k graph holds "
                   f"{replay['exported']['graph_nodes']} nodes, the live one "
                   f"{replay['live']['graph_nodes']}: want {2 * LM_K} fewer "
                   f"(the live step casts the fp32 wte and wpe rows it "
                   f"gathers; the program gathers bf16 tables)")
    seconds["d"] = time.perf_counter() - t0

    # ------ the eager calls of a request: host ms, exported and live
    t0 = time.perf_counter()
    base = program_bases(live, 1)
    rng = np.random.default_rng(SEED + 42)
    block = rng.integers(0, cfg.in_size, (1, LM_CHUNK))
    pages = base["paged"][0][2][0]
    calls = {
        "prefill": lambda s: s.prefill(block),
        "extend": lambda s: s.extend(block, dense, PROGRAMS_POS),
        "extend_paged": lambda s: s.extend(block, paged,
                                           base["rows_pos"][:1]),
        "admit_paged": lambda s: s.admit_paged(paged, base["row"], pages)}
    eager_ms = {}
    with torch.no_grad():
        dense, paged = base["dense"], base["paged"]
        for r in range(3):  # rounds alternate which surface goes first
            order = [("exported", captured.uncaptured()), ("live", live)]
            for src, s in order[::1 - 2 * (r % 2)]:
                for name, call in calls.items():
                    eager_ms.setdefault(name, {}).setdefault(
                        src, []).append(host_ms(lambda: call(s), iters=5))
    del base, dense, paged
    out["eager_host_ms"] = {n: {src: statistics.median(v)
                                for src, v in d.items()}
                            for n, d in eager_ms.items()}
    print(f"[10] the eager calls of a request at b=1, {LM_CHUNK} tokens, "
          f"host ms (median of 3 alternating rounds of host_ms's median "
          f"of 5): {json.dumps(out['eager_host_ms'])} on {card}", flush=True)
    seconds["eager"] = time.perf_counter() - t0

    # ------------- (e) serve_lm over the programs and over a live surface
    t0 = time.perf_counter()
    reqs = lm_workload(cfg.in_size)
    serve = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        live_dir, live_serving = live_artifacts(model, tmp, dev)
        req_path = tmp / "requests.jsonl"
        req_path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
        for sched, extra in (("continuous", {}),
                             ("paged", {"n_pages": LM_POOLS["roomy"]})):
            for src, art in (("programs", arts["card"]),
                             ("live", live_dir)):
                cfg_ = {"artifacts": str(art), "requests": str(req_path),
                        "scheduler": sched, "slots": LM_SLOTS,
                        "k_decode": LM_K, "prefill_chunk": LM_CHUNK, **extra}
                srv = build_server(cfg_)
                srv.serve_requests(reqs[:2], default_new_tokens=64)
                torch.cuda.synchronize()
                for key in cuda_decode.LAUNCHES:
                    cuda_decode.LAUNCHES[key] = 0
                run_dir = tmp / f"{sched}_{src}"
                run_dir.mkdir()
                _serve_batch(srv, cfg_, run_dir, 64)
                torch.cuda.synchronize()
                info = json.loads((run_dir / "serving_info.yaml").read_text())
                done = [json.loads(line) for line in (
                    run_dir / "completions.jsonl").read_text().splitlines()]
                serve[sched, src] = {
                    "tokens_per_sec": info["tokens_per_sec"],
                    "elapsed_s": info["elapsed_s"],
                    "K3": cuda_decode.LAUNCHES["decode_attention"],
                    "K4": cuda_decode.LAUNCHES["paged_decode_attention"],
                    "tokens": [r["tokens"] for r in done]}
                del srv
        del live_serving
    for sched in ("continuous", "paged"):
        p, lv = serve[sched, "programs"], serve[sched, "live"]
        line = {k: {s: serve[sched, s][k] for s in ("programs", "live")}
                for k in ("tokens_per_sec", "elapsed_s", "K3", "K4")}
        line["tokens_equal"] = p["tokens"] == lv["tokens"]
        out[f"serve_{sched}"] = line
        print(f"[10] serve_lm {sched} ({LM_SLOTS} slots, k {LM_K}), the 64 "
              f"requests over the programs and over a live surface: "
              f"{json.dumps(line)} (host wall of _serve_batch after a "
              f"2-request warm-up that captures the graphs) on {card}",
              flush=True)
        if not line["tokens_equal"]:
            bad.append(f"serve_lm {sched}: the programs' greedy tokens "
                       f"differ from the live surface's")
        if (p["K3"], p["K4"]) != (lv["K3"], lv["K4"]) or not (
                p["K3"] + p["K4"]):
            bad.append(f"serve_lm {sched}: K3/K4 launches "
                       f"{(p['K3'], p['K4'])} over the programs, "
                       f"{(lv['K3'], lv['K4'])} over the live surface")
    for name, key in (("K3", "continuous"), ("K4", "paged")):
        rows[name]["launches_phase10"] = serve[key, "programs"][name]
    seconds["e"] = time.perf_counter() - t0
    seconds["10"] = time.perf_counter() - t_phase
    out["seconds"] = seconds
    print(f"[time] 10: {json.dumps(seconds)}", flush=True)
    if bad:
        fail("10: " + "; ".join(bad))
    return out


def lm_row(name: str, replaces: str, library: str) -> dict:
    return {"name": name, "route": "cuda",
            "source": "tempo_tpu_torch/csrc/decode.cu", "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0,
            "tol": {"float32": DECODE_F32_TOL, "bfloat16": DECODE_BF16_TOL},
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
            "library_ms": None, "library": library, "calls": 0,
            "per": "the LM main-path runs (generate for K3; the roomy and "
                   "the tight serve for K4): sum over the kernel's calls "
                   "there, each the wrapper's whole call timed alone with a "
                   "cold L2",
            "ms_by_run": {}}


def lm_add(r: dict, n: dict, err: float, ok: bool, ms: float,
           plain_ms: float, bound_ms: float, lib_ms) -> None:
    """Add one recorded call group (``n``: its calls per run)."""
    total = sum(n.values())
    r["calls"] += total
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += total * ms
    r["plain_ms"] += total * plain_ms
    r["bound_ms"] += total * bound_ms
    for run, k in n.items():
        r["ms_by_run"][run] = r["ms_by_run"].get(run, 0.0) + k * ms
    if lib_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + total * lib_ms
    if not ok:
        print(f"[kernels] {r['name']} disagrees: max_abs_err {err}",
              flush=True)


def flash_row(name: str, replaces: str, library: str) -> dict:
    return {"name": name, "route": "cuda",
            "source": "tempo_tpu_torch/csrc/flash_attn.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "tol": {"o": FLASH_O_TOL, "lse_atol": FLASH_LSE_ATOL,
                    "grad_rel_l2": FLASH_GRAD_REL},
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": "operations", "library_ms": None, "library": library,
            "per": "the 10 timed train steps of 4a (12 calls a step at "
                   "[8,1024,12,64] bf16): calls x the time of one call alone "
                   "with a cold L2"}


def flash_inputs(gen, dev, b, t, n, hd, dtype, kv=None):
    """q, k, v as the model hands them to K5 (strided slices of one c_attn
    output, GQA's K/V repeated per group, kv-major) and a seeded dO."""
    import torch

    kv = kv or n
    qkv = torch.randn((b, t, (n + 2 * kv) * hd), generator=gen,
                      device=dev).to(dtype)
    q = qkv[..., :n * hd].reshape(b, t, n, hd)
    k = qkv[..., n * hd:(n + kv) * hd].reshape(b, t, kv, hd)
    v = qkv[..., (n + kv) * hd:].reshape(b, t, kv, hd)
    if kv < n:
        k = k.repeat_interleave(n // kv, dim=2)
        v = v.repeat_interleave(n // kv, dim=2)
    do = torch.randn((b, t, n, hd), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def floored_rel(got, want) -> float:
    g, w = got.float(), want.float()
    floor = 1e-3 * math.sqrt(w.numel())
    return float((g - w).norm() / max(float(w.norm()), floor))


def flash_check(q, k, v, do, causal=True) -> dict:
    """Each K5 kernel against its plain version on the same inputs (the
    backward passes fed the plain forward's lse and di)."""
    import torch

    from tempo_tpu_torch.ops import flash_attention as fa

    dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    di = fa.attention_di(o_p, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, di, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, di, causal)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, di, causal)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, di, causal)
    o_err, o_ok = max_err(o, o_p, FLASH_O_TOL[dt])
    lse_err = float((lse - lse_p).abs().max())
    rel = {"dq": floored_rel(dq, dq_p), "dk": floored_rel(dk, dk_p),
           "dv": floored_rel(dv, dv_p)}
    ok = (o_ok and lse_err <= FLASH_LSE_ATOL
          and all(torch_all_finite(x) for x in (dq, dk, dv))
          and max(rel.values()) <= FLASH_GRAD_REL[dt])
    return {"o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
            "grad_rel_l2": rel, "ok": ok,
            "max_abs_err": {"K5f": o_err,
                            "K5dkv": max(float((dk - dk_p).abs().max()),
                                         float((dv - dv_p).abs().max())),
                            "K5dq": float((dq - dq_p).abs().max())}}


def flash_work(b, t, n, hd, elem, causal=True) -> dict:
    """FLOPs and bytes each K5 pass must do and move at this shape: 2 FLOPs
    per multiply-add over the visible (query, key) pairs (t(t+1)/2 when
    causal); each input read once, each output written once."""
    pairs = b * n * (t * (t + 1) // 2 if causal else t * t)
    mat = 2 * pairs * hd                       # one [pairs x hd] product
    x = b * t * n * hd * elem                  # one [b, t, n, hd] tensor
    stats = b * n * t * 4                      # one fp32 [b, n, t] vector
    return {"K5f": (2 * mat, 4 * x + stats),          # s, p.v; q k v -> o lse
            "K5dkv": (4 * mat, 6 * x + 2 * stats),    # s, dp, dv, dk
            "K5dq": (3 * mat, 5 * x + 2 * stats)}     # s, dp, dq


# Kinds of device kernels in a train step, by substrings of their names
# (lower case; the first kind that matches takes a kernel).
LM_STEP_KINDS = {"k5": ("tempo::flash",),
                 "gemm": ("gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitk"),
                 "optimizer": ("multi_tensor_apply", "adam"),
                 "reduce": ("reduce_kernel", "softmax", "logsumexp"),
                 "layernorm": ("layer_norm",),
                 "embedding": ("embedding", "index", "scatter", "gather"),
                 "elementwise": ("elementwise",)}
# The VAE step: K1a, K1b and K2 in the forward; cuDNN's convolutions (the
# plain recompute of GN+act+conv in the backward and the strided convs:
# "fprop" forward, "dgrad" data gradient and the transposed conv's forward,
# "wgrad" weight gradient); cuBLAS for the 1x1 convs and attention.
# The port's K1a, K1b and K2 device kernels (K2's bf16 and fp32 paths), by
# name: a profile lists each launch as one record.
PROFILED_KERNELS = ("gn_stats_kernel", "gn_apply_kernel", "conv_bf16",
                    "conv_f32")
VAE_STEP_KINDS = {"K1a": ("gn_stats_kernel",),
                  "K1b": ("gn_apply_kernel",),
                  "K2": ("tempo::gn_conv", "conv_bf16", "reduce_splits",
                         "conv_f32"),
                  "conv_dgrad": ("dgrad",),
                  "conv_wgrad": ("wgrad",),
                  "elementwise": ("elementwise",),
                  "conv_fprop": ("fprop", "conv", "implicit"),
                  "gemm": ("gemm", "xmma", "cutlass", "nvjet", "cublas",
                           "splitk"),
                  "optimizer": ("multi_tensor_apply", "adam"),
                  "reduce": ("reduce_kernel", "softmax")}
# The L2 step profiled with its batch's gather (index_select over the
# pool) and, in a step that starts a swap, the shard's copy to the staging
# tensor on the buffer's side stream.
VAE_L2_STEP_KINDS = {"gather": ("indexselect", "gather_kernel",
                                "index_elementwise"),
                     "swap_copy": ("memcpy htod",), **VAE_STEP_KINDS}


def step_breakdown(fn, kinds: dict = LM_STEP_KINDS,
                   label: str = "train") -> dict:
    """Device kernel time of one ``fn()`` (a train step) by torch.profiler,
    summed by kind of kernel from the kernels' full names (user annotation
    ranges such as the optimizer's step are left out: their kernels are
    counted themselves), with the counts of device kernels, of the
    PROFILED_KERNELS records (``listed``) and of host operators, and the
    host operators of most self time; None where the profiler gives no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per, kernels, host_ops, host = {}, 0, 0, {}
        listed = dict.fromkeys(PROFILED_KERNELS, 0)
        for e in prof.key_averages():
            if getattr(e, "is_user_annotation", False) or "#" in e.key:
                continue
            if e.device_type == torch.autograd.DeviceType.CPU:
                host_ops += e.count
                host[e.key] = e.self_cpu_time_total / 1e3
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                per[e.key] = per.get(e.key, 0.0) + us / 1e3
                kernels += e.count
                for name in listed:
                    if name in e.key:
                        listed[name] += e.count
    except Exception as exc:  # measurement only: the run's checks stand
        print(f"[{label}] torch.profiler failed: {exc!r}", flush=True)
        return None
    if not per:
        print(f"[{label}] torch.profiler recorded no device time",
              flush=True)
        return None
    out = {k: 0.0 for k in kinds}
    out["other"] = 0.0
    for name, ms in per.items():
        low = name.lower()
        kind = next((k for k, keys in kinds.items()
                     if any(key in low for key in keys)), "other")
        out[kind] += ms
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:16]
    host_ranked = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": sum(per.values()),
            "by_kind_ms": {k: round(v, 3) for k, v in out.items()},
            "top": [[k[:100], round(v, 3)] for k, v in ranked],
            "device_kernels": kernels, "listed": listed,
            "host_ops": host_ops,
            "host_self_ms_top": [[k[:60], round(v, 3)]
                                 for k, v in host_ranked]}


def train_path(dev, gen, rows: dict) -> dict:
    """The GPT-2-small training path: (a) train steps through K5, counted
    and timed; (b) the Trainer with a checkpoint reloaded bit for bit;
    K5 against its plain versions, timed; (c) one step against the plain
    attention path. Adds the K5 rows; returns the training metrics."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from tempo_tpu_torch.data.tokens import TokenLoader, make_token_stream
    from tempo_tpu_torch.nn.transformer import (Transformer,
                                                TransformerConfig,
                                                estimate_mfu,
                                                make_gpt_optimizer,
                                                num_params)
    from tempo_tpu_torch.ops import flash_attention as fa
    from tempo_tpu_torch.ops.losses import lm_cross_entropy
    from tempo_tpu_torch.train.checkpoint import checkpoint_path
    from tempo_tpu_torch.train.state import create_train_state
    from tempo_tpu_torch.train.step import lm_loss_fn, make_train_step
    from tempo_tpu_torch.train.trainer import Trainer, to_device

    cfg = TransformerConfig(compute_dtype="bfloat16", attn_impl="auto")
    card = smi_line()

    def fresh(seed=SEED, config=cfg):
        model = Transformer(config, device=dev, seed=seed)
        tx = make_gpt_optimizer(model, weight_decay=0.1, learning_rate=3e-4,
                                betas=(0.9, 0.95))
        return model, tx, create_train_state(model, tx, SEED)

    # --------------------------------------------- (a) train steps, counted
    model, tx, state = fresh()
    n_params = num_params(model)
    step = make_train_step(lm_loss_fn(model), tx)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.in_size, (TRAIN_BATCH, cfg.block_size + 1))).to(dev)
    losses = []
    for _ in range(TRAIN_WARM):
        state, m = step(state, tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = dict(fa.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()
    want = cfg.n_layer * TRAIN_STEPS
    print(f"[train] K5 launches in the {TRAIN_STEPS} timed steps: "
          f"{launches} (want {want} each)", flush=True)
    for name, key in (("K5f", "flash_fwd"), ("K5dkv", "flash_bwd_dkv"),
                      ("K5dq", "flash_bwd_dq")):
        rows[name]["launches"] = launches[key]
        if launches[key] != want:
            fail(f"{name} launched {launches[key]} times in the timed "
                 f"steps, want {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train loss not finite or not falling: {losses}")
    tok_s = TRAIN_BATCH * cfg.block_size / dt
    mfu = estimate_mfu(cfg, n_params, TRAIN_BATCH, dt,
                       PEAK_FLOPS["bfloat16"])
    profile = step_breakdown(lambda: step(state, tokens))
    print(f"[train] GPT-2-small bf16 batch {TRAIN_BATCH} x {cfg.block_size}:"
          f" train.step_ms {1e3 * dt:.2f}, train.tokens_per_s {tok_s:.1f}, "
          f"train.mfu {mfu:.4f} (against 989e12 bf16 dense, on {card}), "
          f"train.peak_device_gb {peak_gb:.2f}; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {len(losses)} steps", flush=True)
    print(f"[train] one step under torch.profiler: {json.dumps(profile)}",
          flush=True)
    del model, tx, state, step

    # ------------------------------------ (b) the Trainer and its checkpoint
    stream = make_token_stream(cfg.in_size, 200_000, seed=SEED)
    loader = iter(TokenLoader(stream, TRAIN_BATCH, cfg.block_size,
                              seed=SEED + 1))
    val = TokenLoader(stream, TRAIN_BATCH, cfg.block_size, seed=SEED + 2)
    model, tx, state = fresh()
    with tempfile.TemporaryDirectory() as out:
        trainer = Trainer(lm_loss_fn(model), tx, state, out, save_every=30,
                          val_every=30, log_every=10,
                          plot_every=TRAINER_STEPS + 1, device=dev,
                          verbose=False)
        stats = trainer.train(loader, lambda: iter(val), TRAINER_STEPS)
        ckpt = checkpoint_path(Path(out) / "checkpoints", TRAINER_STEPS)
        if not ckpt.exists() or not (Path(out) / "metrics.json").exists():
            fail(f"the trainer did not write {ckpt.name} and metrics.json")
        history = json.loads((Path(out) / "metrics.json").read_text())
        _, tx2, state2 = fresh(seed=SEED + 99)
        trainer2 = Trainer(lm_loss_fn(state2.model), tx2, state2, out,
                           device=dev, verbose=False)
        trainer2.load_checkpoint(ckpt)
    batch = to_device(next(loader), dev)
    live, _ = trainer.train_step(trainer.state, batch)
    again, _ = trainer2.train_step(trainer2.state, batch)
    same = all(torch.equal(a, b) for a, b in zip(
        live.model.parameters(), again.model.parameters()))
    same &= all(torch.equal(live.ema[k], again.ema[k]) for k in live.ema)
    print(f"[train] Trainer {TRAINER_STEPS} steps: "
          f"{stats['samples_per_sec']:.2f} samples/s (host wall, "
          f"incl. a validation of 10 batches and a checkpoint); train "
          f"history {history['train']}, val {history['val']}; one more step "
          f"from the reloaded checkpoint equals the live state's bit for "
          f"bit: {same}", flush=True)
    if not same:
        fail("a step from the reloaded checkpoint differs from the live "
             "state's")
    trainer_stats = {"samples_per_sec": stats["samples_per_sec"],
                     "train": history["train"], "val": history["val"]}
    del trainer, trainer2, live, again, model, state, state2

    # ---------------------------------- K5 against its plain versions, timed
    b, t, n, hd = TRAIN_BATCH, cfg.block_size, cfg.n_head, cfg.head_dim
    q, k, v, do = flash_inputs(gen, dev, b, t, n, hd, torch.bfloat16)
    path = flash_check(q, k, v, do)
    print(f"[kernels] K5 at the path's shape [{b},{t},{n},{hd}] bf16 "
          f"(strided c_attn slices): {json.dumps(path)}", flush=True)
    checks_ok = path["ok"]
    edges = []
    for name, (eb, et, en, ehd, edt, ekv, causal) in {
            "t1": (2, 1, 4, 64, torch.bfloat16, None, True),
            "t63": (2, 63, 4, 64, torch.bfloat16, None, True),
            "t65": (2, 65, 4, 64, torch.bfloat16, None, True),
            "t129": (2, 129, 4, 64, torch.bfloat16, None, True),
            "t200": (2, 200, 4, 64, torch.bfloat16, None, True),
            "t640": (2, 640, 4, 64, torch.bfloat16, None, True),
            "t1000": (2, 1000, 4, 64, torch.bfloat16, None, True),
            "hd32": (2, 1000, 4, 32, torch.bfloat16, None, True),
            "hd32_t129": (2, 129, 4, 32, torch.bfloat16, None, True),
            "hd128": (2, 640, 4, 128, torch.bfloat16, None, True),
            "hd128_t1000": (2, 1000, 4, 128, torch.bfloat16, None, True),
            "gqa12/4": (2, 1024, 12, 64, torch.bfloat16, 4, True),
            "noncausal_t129": (2, 129, 4, 64, torch.bfloat16, None, False),
            "noncausal_t200": (2, 200, 4, 64, torch.bfloat16, None, False),
            "f32_t1000": (2, 1000, 4, 64, torch.float32, None, True),
            "f32_hd128": (2, 300, 2, 128, torch.float32, None, True),
            "f32_hd32_t63": (2, 63, 2, 32, torch.float32, None, True)}.items():
        res = flash_check(*flash_inputs(gen, dev, eb, et, en, ehd, edt, ekv),
                          causal=causal)
        edges.append((name, res))
        checks_ok &= res["ok"]
        print(f"[kernels] K5 edge {name}: o {res['o_max_abs_err']:.3e}, lse "
              f"{res['lse_max_abs_err']:.3e}, rel L2 "
              f"{json.dumps(res['grad_rel_l2'])} ok={res['ok']}", flush=True)
    if not checks_ok:
        fail("K5 disagrees with its plain versions beyond tolerance")

    o, lse = fa.flash_fwd(q, k, v)
    di = fa.attention_di(o, do)
    per_call = {
        "K5f": (lambda: fa.flash_fwd(q, k, v),
                lambda: fa.flash_fwd_plain(q, k, v)),
        "K5dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di),
                  lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, di)),
        "K5dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, di),
                 lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, di))}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_t = do.transpose(1, 2)
    lib = {"fwd": time_ms(lambda: F.scaled_dot_product_attention(
               qt.detach(), kt.detach(), vt.detach(), is_causal=True)),
           "bwd": time_ms(lambda: torch.autograd.grad(
               out_sdpa, (qt, kt, vt), do_t, retain_graph=True))}

    def sdpa_fwd_bwd():
        out_ = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(out_, (qt, kt, vt), do_t)

    def k5_fwd_bwd():
        q_, k_, v_ = (x.detach().requires_grad_() for x in (q, k, v))
        out_ = fa.flash_attention(q_, k_, v_)
        torch.autograd.grad(out_, (q_, k_, v_), do)

    lib["fwd_bwd"] = time_ms(sdpa_fwd_bwd)
    k5_whole = time_ms(k5_fwd_bwd)
    work = flash_work(b, t, n, hd, 2)
    for name, (kernel, plain) in per_call.items():
        r = rows[name]
        flops, nbytes = work[name]
        bound = 1e3 * max(flops / PEAK_FLOPS["bfloat16"],
                          nbytes / HBM_BYTES_PER_S)
        r["bound_by"] = ("operations" if flops / PEAK_FLOPS["bfloat16"]
                         >= nbytes / HBM_BYTES_PER_S else "bytes")
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        calls = r["launches"]
        r.update(ms=calls * ms, plain_ms=calls * plain_ms,
                 bound_ms=calls * bound, per_call_ms=ms,
                 per_call_plain_ms=plain_ms, per_call_bound_ms=bound,
                 gflop_per_call=flops / 1e9, tflops=flops / ms / 1e9,
                 max_abs_err=max([path["max_abs_err"][name]]
                                 + [e[1]["max_abs_err"][name]
                                    for e in edges]),
                 edge_checks=len(edges))
    rows["K5f"]["library_ms"] = rows["K5f"]["launches"] * lib["fwd"]
    rows["K5dkv"]["library_ms"] = rows["K5dkv"]["launches"] * lib["bwd"]
    for name in ("K5f", "K5dkv", "K5dq"):
        # on this text line only: the kernels line holds what this run read
        print(f"[kernels] {name}: {rows[name]['per_call_ms']:.4f} ms a call "
              f"on {card}; before the redesign {KERNEL_PREV[name]:.4f} on "
              f"{KERNEL_PREV['card']}: x"
              f"{KERNEL_PREV[name] / rows[name]['per_call_ms']:.2f}",
              flush=True)
    for name in ("K5f", "K5dkv", "K5dq"):
        rows[name]["sdpa_per_call_ms"] = lib
        rows[name]["k5_fwd_bwd_per_call_ms"] = k5_whole
        rr = rows[name]
        print(f"[kernels] {name}: {rr['per_call_ms']:.4f} ms a call "
              f"({rr['tflops']:.1f} TFLOP/s), bound "
              f"{rr['per_call_bound_ms']:.4f} ({rr['bound_by']}), plain "
              f"{rr['per_call_plain_ms']:.4f}; x {rr['launches']} calls: "
              f"{rr['ms']:.3f} ms; SDPA {json.dumps(lib)}, K5 fwd+bwd "
              f"{k5_whole:.4f} (on {card})", flush=True)
    del q, k, v, do, o, lse, di, qt, kt, vt, out_sdpa, do_t

    # --------------------------- (c) one step against the plain attention
    def loss_and_grads(config, batch_tokens, seed=SEED):
        model = Transformer(config, device=dev, seed=seed)
        loss = lm_cross_entropy(model(batch_tokens[:, :-1]),
                                batch_tokens[:, 1:])
        loss.backward()
        grads = {k_: p.grad for k_, p in model.named_parameters()}
        return float(loss.detach()), grads

    step_errs = {}
    for label, config, batch_tokens, tol in (
            ("bf16", cfg, tokens, STEP_BF16_TOL),
            ("f32_2layer_b2", dataclasses.replace(
                cfg, compute_dtype="float32", n_layer=2), tokens[:2],
             STEP_F32_TOL)):
        loss_k, grads_k = loss_and_grads(config, batch_tokens)
        loss_p, grads_p = loss_and_grads(
            dataclasses.replace(config, attn_impl="xla"), batch_tokens)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        grad_rel = max(rel_l2(grads_k[k_], grads_p[k_]) for k_ in grads_p)
        step_errs[label] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                            "loss_rel": loss_rel, "max_grad_rel_l2": grad_rel}
        if not (loss_rel <= tol["loss"] and grad_rel <= tol["grad"]):
            fail(f"the {label} train step through K5 disagrees with the "
                 f"plain path: {step_errs[label]} (tol {tol})")
        del grads_k, grads_p
    print(f"[train] one step, K5 vs the plain attention path: "
          f"{json.dumps(step_errs)} (tol bf16 {STEP_BF16_TOL}, f32 "
          f"{STEP_F32_TOL})", flush=True)
    return {"card": card, "step_ms": 1e3 * dt, "tokens_per_s": tok_s,
            "mfu": mfu, "mfu_peak_flops": PEAK_FLOPS["bfloat16"],
            "peak_device_gb": peak_gb, "n_params": n_params,
            "losses": losses, "profile": profile, "trainer": trainer_stats,
            "step_vs_plain": step_errs,
            "k5_edges": {e[0]: e[1]["ok"] for e in edges}}


def vae_train_path(dev, rows: dict, keep: Path, live: dict) -> dict:
    """The flagship VAE training path: (a) train steps at batch 64 through
    K1a, K1b and K2, counted, timed and profiled, and one step with remat;
    (2''') the K1/K2 Functions' backward at every shape the step records;
    (b) the Trainer over a TileLoader, a checkpoint reloaded bit for bit
    (the last copied to ``keep``/vae.pt, where phase 6 warm-starts from
    it; both, at steps 15 and 30, to ``keep``/vae_run/checkpoints, which
    phase 7 sweeps; ``live``["vae"] the trained weights at step 30); (c)
    one step against the plain path. Adds each kernel's launches a train
    step to its row; returns the metrics."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tempo_tpu_torch.data.loader import TileLoader
    from tempo_tpu_torch.data.synthetic import make_tile_shards
    from tempo_tpu_torch.models.vae import build_vae
    from tempo_tpu_torch.nn.blocks import Conv2d
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv
    from tempo_tpu_torch.train.checkpoint import checkpoint_path
    from tempo_tpu_torch.train.state import (create_train_state,
                                             make_optimizer)
    from tempo_tpu_torch.train.step import make_train_step, vae_loss_fn
    from tempo_tpu_torch.train.trainer import Trainer, to_device

    card = smi_line()
    seconds = {}
    counters = {"K1a": (cuda_gn.LAUNCHES, "gn_stats"),
                "K1b": (cuda_gn.LAUNCHES, "gn_apply"),
                "K2": (cuda_gn_conv.LAUNCHES, "gn_act_conv3x3")}

    def fresh(model_cfg=VAE_MODEL, dtype=None, remat=False, seed=SEED):
        model, _ = build_vae(dict(model_cfg, remat=remat),
                             compute_dtype=dtype, device=dev, seed=seed)
        nudge_zero_init(model, torch.Generator(device=dev).manual_seed(seed))
        tx = make_optimizer(lr=1e-4, betas=(0.9, 0.95), weight_decay=0.05)
        return model, tx, create_train_state(model, tx, SEED)

    def noise():
        """The posterior's draws: the same on both sides of a check."""
        return torch.Generator(device=dev).manual_seed(SEED + 1)

    def loss_and_grads(model, x):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, metrics = model.get_loss(x, noise())
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        grads = {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return ({k: float(v) for k, v in metrics.items()}, grads, peak)

    def compare(a, b):
        """Loss and pixel MSE relative errors, and the largest gradient
        relative L2 (the attention key biases, whose exact gradient is 0,
        are reported by norm: both sides hold rounding)."""
        (ma, ga, _), (mb, gb, _) = a, b
        zero = [k for k in gb if k.endswith("attn1.k.bias")]
        return {"loss_a": ma["loss"], "loss_b": mb["loss"],
                "loss_rel": abs(ma["loss"] - mb["loss"]) / abs(mb["loss"]),
                "pixel_mse_rel": abs(ma["pixel_mse"] - mb["pixel_mse"])
                / abs(mb["pixel_mse"]),
                "max_grad_rel_l2": max(rel_l2(ga[k], gb[k]) for k in gb
                                       if k not in zero),
                "grads_bitwise": all(torch.equal(ga[k], gb[k]) for k in gb),
                "key_bias_grad_norms": [float(gb[k].norm()) for k in zero]}

    # ------------------------------------------ (a) train steps, counted
    t_phase = time.perf_counter()
    model, tx, state = fresh()
    c, h, w = model.config.shape
    host = np.random.default_rng(SEED).standard_normal(
        (VAE_TRAIN_BATCH, h, w, c), dtype=np.float32)
    batch = torch.from_numpy(host).to(dev)
    del host
    # the kernels' calls in one training forward, with their shapes (2''')
    calls = {"K1a": [], "K1b": [], "K2": []}
    with recording(calls, "train"):
        loss, _ = model.get_loss(batch, noise())
    del loss
    per_forward = {k: len(v) for k, v in calls.items()}
    step = make_train_step(vae_loss_fn(model), tx)
    losses = []
    for _ in range(TRAIN_WARM):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    for table, key in counters.values():
        table[key] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: table[key] / TRAIN_STEPS
                for k, (table, key) in counters.items()}
    losses = torch.stack(losses).tolist()
    print(f"[vae_train] launches a train step: {launches} (calls in one "
          f"training forward {per_forward}; the backward is the plain "
          f"recompute)", flush=True)
    for name, n in launches.items():
        rows[name]["train_launches_per_step"] = n
        if n == 0 or n != per_forward[name]:
            fail(f"{name}: {n} launches a train step, {per_forward[name]} "
                 f"calls in a training forward")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"VAE train loss not finite or not falling: {losses}")
    patches_s = VAE_TRAIN_BATCH / dt
    profile = step_breakdown(lambda: step(state, batch), VAE_STEP_KINDS,
                             "vae_train")
    busy = None if profile is None else profile["device_ms"] / (1e3 * dt)
    # the same step at the Trainer's batch (5b): how much of it is host
    small = batch[:VAE_TRAINER_BATCH]
    step(state, small)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARM):
        step(state, small)
    torch.cuda.synchronize()
    dt_small = (time.perf_counter() - t0) / TRAIN_WARM
    profile_small = step_breakdown(lambda: step(state, small),
                                   VAE_STEP_KINDS, "vae_train")
    busy_small = (None if profile_small is None
                  else profile_small["device_ms"] / (1e3 * dt_small))
    # the 3x3 weights K2 took in the steps, repacked after each update
    convs = [m for m in model.modules()
             if isinstance(m, Conv2d) and m._packed is not None]
    pack_ms = time_ms(lambda: [cuda_gn_conv.pack_conv3x3_weight(
        m.weight, torch.bfloat16) for m in convs], iters=5)
    print(f"[vae_train] flagship bf16 batch {VAE_TRAIN_BATCH} x "
          f"[{h},{w},{c}]: vae_train.step_ms {1e3 * dt:.2f}, "
          f"vae_train.patches_per_s {patches_s:.1f}, "
          f"vae_train.peak_device_gb {peak_gb:.2f} (on {card}); loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g} over {len(losses)} steps",
          flush=True)
    print(f"[vae_train] one step under torch.profiler: {json.dumps(profile)}"
          f"; device busy share {busy}; the {len(convs)} 3x3 weights "
          f"repacked for K2 each step (AdamW bumps their version): "
          f"{pack_ms:.3f} ms", flush=True)
    print(f"[vae_train] at batch {VAE_TRAINER_BATCH}: step "
          f"{1e3 * dt_small:.2f} ms, device busy share {busy_small}; "
          f"{json.dumps(profile_small)}", flush=True)
    # one step with remat: the same loss and gradients, its peak memory
    plain_run = loss_and_grads(model, batch)
    remat_model, _, _ = fresh(remat=True)
    remat_model.load_state_dict(model.state_dict())
    remat_run = loss_and_grads(remat_model, batch)
    remat = dict(compare(remat_run, plain_run), peak_gb=remat_run[2],
                 peak_gb_without=plain_run[2])
    del remat_model, plain_run, remat_run
    print(f"[vae_train] remat=True vs False, one loss and backward: "
          f"{json.dumps(remat)} (tol {STEP_BF16_TOL})", flush=True)
    if not (remat["loss_rel"] <= STEP_BF16_TOL["loss"]
            and remat["max_grad_rel_l2"] <= STEP_BF16_TOL["grad"]):
        fail("the step with remat disagrees with the step without")
    seconds["5a"] = time.perf_counter() - t_phase

    # ------------- (2''') the Functions' backward at every recorded shape
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    groups, eps = model.config.norm_groups, model.config.norm_eps
    del model, tx, state, step
    torch.cuda.empty_cache()

    fn_bwd = {}
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for shape, _, act in sorted({k for k, _ in calls["K1b"]}, key=str):
            fn_bwd[f"K1 {list(shape)} {act}"] = check_k1_bwd(
                gen, shape, groups, eps, act)
        for shape, _, f, grp, ep, act in sorted(
                {k for k, _ in calls["K2"]}, key=str):
            b, hh, ww, cc = shape
            bound = (9 * cc) ** -0.5
            weight = (2 * torch.rand((f, cc, 3, 3), generator=gen,
                                     device=dev) - 1) * bound
            packed = cuda_gn_conv.pack_conv3x3_weight(weight, torch.bfloat16)
            fn_bwd[f"K2 {list(shape)}->{f} {act}"] = check_bwd(
                gen,
                lambda x, s_, b_, w_, cb: cuda_gn_conv.gn_act_conv3x3(
                    x, s_, b_, w_, cb, grp, ep, act, packed),
                lambda x, s_, b_, w_, cb: cuda_gn_conv.gn_act_conv3x3_plain(
                    x, s_, b_, w_, cb, grp, ep, act),
                [randn(gen, *shape, dtype=torch.bfloat16),
                 1 + randn(gen, cc, scale=0.1), randn(gen, cc, scale=0.1),
                 weight, randn(gen, f, scale=0.01)], (b, hh, ww, f),
                "GnActConv3x3FnBackward")
    finally:
        torch.backends.cudnn.deterministic = saved_det
    for key, r in fn_bwd.items():
        print(f"[kernels] Function backward {key}: {json.dumps(r)}",
              flush=True)
    if not all(r["fn"] and r["rel_l2"] <= FN_BWD_REL
               for r in fn_bwd.values()):
        fail(f"a K1/K2 Function's backward disagrees with autograd through "
             f"the plain chain beyond rel L2 {FN_BWD_REL}, or the wrapper "
             f"did not go through the Function")
    seconds["2'''"] = time.perf_counter() - t_phase

    # ---------------------- (b) the Trainer over a TileLoader, a checkpoint
    t_phase = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        shards = make_tile_shards(
            Path(tmp) / "tiles", n_files=VAE_SHARDS,
            tiles_per_file=VAE_TILES_PER_SHARD, tile=h, n_spectral=c,
            seed=SEED, dtype=np.float16)
        loader = TileLoader(shards, batch_size=VAE_TRAINER_BATCH,
                            min_buffer_size=VAE_BUFFER, seed=SEED)
        val = TileLoader(shards, batch_size=VAE_TRAINER_BATCH,
                         min_buffer_size=VAE_BUFFER, seed=SEED + 1,
                         num_threads=1)
        try:
            timed = Timed(loader)
            model, tx, state = fresh()
            out = Path(tmp) / "run"
            trainer = Trainer(vae_loss_fn(model), tx, state, out,
                              save_every=VAE_TRAINER_STEPS // 2,
                              val_every=VAE_TRAINER_STEPS, log_every=10,
                              plot_every=VAE_TRAINER_STEPS + 1, device=dev,
                              verbose=False)
            stats = trainer.train(timed, lambda: iter(val),
                                  VAE_TRAINER_STEPS)
            ckpt = checkpoint_path(out / "checkpoints", VAE_TRAINER_STEPS)
            if not ckpt.exists() or not (out / "metrics.json").exists():
                fail(f"the VAE trainer did not write {ckpt.name} and "
                     f"metrics.json")
            history = json.loads((out / "metrics.json").read_text())
            shutil.copy(ckpt, keep / "vae.pt")
            shutil.copytree(out / "checkpoints",
                            keep / "vae_run" / "checkpoints")
            live["vae"] = {k: v.detach().clone() for k, v in
                           trainer.state.model.state_dict().items()}
            _, tx2, state2 = fresh(seed=SEED + 99)
            trainer2 = Trainer(vae_loss_fn(state2.model), tx2, state2, out,
                               device=dev, verbose=False)
            trainer2.load_checkpoint(ckpt)
            batch8 = to_device(next(loader), dev)
        finally:
            loader.close()
            val.close()
    # cuDNN's weight gradients may sum with atomics: deterministic
    # algorithms for the two steps compared bit for bit
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        live, _ = trainer.train_step(trainer.state, batch8)
        again, _ = trainer2.train_step(trainer2.state, batch8)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    same = all(torch.equal(a, b) for a, b in zip(
        live.model.parameters(), again.model.parameters()))
    same &= all(torch.equal(live.ema[k], again.ema[k]) for k in live.ema)
    wait_share = timed.wait_s / stats["elapsed_s"]
    print(f"[vae_train] Trainer {VAE_TRAINER_STEPS} steps at batch "
          f"{VAE_TRAINER_BATCH} over a TileLoader ({VAE_SHARDS} fp16 shards "
          f"of {VAE_TILES_PER_SHARD}, buffer {VAE_BUFFER}): "
          f"{stats['samples_per_sec']:.2f} samples/s (host wall, incl. a "
          f"validation of 10 batches and a checkpoint); the loader's share "
          f"of the host wall (waiting on next()) {wait_share:.4f}; train "
          f"history {history['train']}, val {history['val']}; one more "
          f"step from the reloaded checkpoint equals the live state's bit "
          f"for bit: {same}", flush=True)
    if not same:
        fail("a VAE step from the reloaded checkpoint differs from the live "
             "state's")
    trainer_stats = {"samples_per_sec": stats["samples_per_sec"],
                     "loader_wait_share": wait_share,
                     "train": history["train"], "val": history["val"]}
    del trainer, trainer2, live, again, model, state, state2, batch8
    torch.cuda.empty_cache()
    seconds["5b"] = time.perf_counter() - t_phase

    # ------------------------------- (c) one step against the plain path
    t_phase = time.perf_counter()

    def accuracy(kernel_run, plain_run, ref_run):
        """Each gradient's relative L2 to the fp32 step, kernel and plain
        bf16 paths; those beyond VAE_BF16_ACC's rule."""
        gk, gp, gt = kernel_run[1], plain_run[1], ref_run[1]
        rel = {k: (rel_l2(gk[k], gt[k]), rel_l2(gp[k], gt[k])) for k in gt
               if not k.endswith("attn1.k.bias")}
        bad = [k for k, (rk, rp) in rel.items()
               if rk > max(STEP_BF16_TOL["grad"], VAE_BF16_ACC * rp)]
        worst = sorted(rel, key=lambda k: -rel[k][0])[:6]
        return {"kernel_vs_fp32_max": max(r[0] for r in rel.values()),
                "plain_vs_fp32_max": max(r[1] for r in rel.values()),
                "kernel_farther_than_plain": sum(r[0] > r[1]
                                                 for r in rel.values()),
                "grads": len(rel), "beyond_rule": bad,
                "worst": {k: [round(v, 5) for v in rel[k]] for k in worst},
                "loss_fp32": ref_run[0]["loss"],
                "pixel_mse_fp32": ref_run[0]["pixel_mse"]}

    def sign_flips(model, x):
        """The share of elements where sign(recon - x) differs between
        the kernels and the plain path (the L1 loss's gradient there)."""
        with torch.no_grad():
            rk, _ = model(x, generator=noise())
            with plain_kernels():
                rp, _ = model(x, generator=noise())
            return float(((rk.float() - x).sign()
                          != (rp.float() - x).sign()).float().mean())

    l2 = {"nll_loss_type": "l2"}
    step_errs = {}
    for label, model_cfg, dtype, n, tol in (
            ("bf16_l2", dict(VAE_MODEL, **l2), None, VAE_TRAIN_BATCH,
             STEP_BF16_TOL),
            ("f32_l2_2level_b2", dict(VAE_F32_MODEL, **l2), "float32", 2,
             STEP_F32_TOL),
            ("bf16_l1", VAE_MODEL, None, VAE_TRAIN_BATCH, STEP_BF16_TOL)):
        model, _, _ = fresh(model_cfg, dtype)
        kernel_run = loss_and_grads(model, batch[:n])
        with plain_kernels():
            plain_run = loss_and_grads(model, batch[:n])
        err = dict(compare(kernel_run, plain_run), peak_gb=kernel_run[2],
                   peak_gb_plain=plain_run[2])
        ok = (err["loss_rel"] <= tol["loss"]
              and err["pixel_mse_rel"] <= tol["loss"])
        if model.config.nll_loss_type == "l1":
            err["sign_flip_share"] = sign_flips(model, batch[:n])
            ref, _, _ = fresh(model_cfg, "float32")
            ref.load_state_dict(model.state_dict())
            del model
            with plain_kernels():
                ref_run = loss_and_grads(ref, batch[:n])
            del ref
            err["fp32_reference"] = accuracy(kernel_run, plain_run, ref_run)
            ok &= not err["fp32_reference"]["beyond_rule"]
            del ref_run
        else:
            del model
            ok &= err["max_grad_rel_l2"] <= tol["grad"]
        step_errs[label] = err
        del kernel_run, plain_run
        torch.cuda.empty_cache()
        if not ok:
            fail(f"the {label} VAE train step through K1/K2 disagrees with "
                 f"the plain path: {err} (tol {tol}; the L1 step's gradients "
                 f"against fp32 by VAE_BF16_ACC {VAE_BF16_ACC})")
    print(f"[vae_train] one step, K1/K2 vs the plain path: "
          f"{json.dumps(step_errs)} (tol bf16 {STEP_BF16_TOL}, f32 "
          f"{STEP_F32_TOL}; the L1 step's gradients within "
          f"{STEP_BF16_TOL['grad']} of the fp32 step or {VAE_BF16_ACC}x the "
          f"plain bf16 path's distance to it)", flush=True)
    seconds["5c"] = time.perf_counter() - t_phase
    print(f"[time] VAE training phases, s: {json.dumps(seconds)}",
          flush=True)
    return {"card": card, "batch": VAE_TRAIN_BATCH, "step_ms": 1e3 * dt,
            "patches_per_s": patches_s, "peak_device_gb": peak_gb,
            "launches_per_step": launches, "losses": losses,
            "profile": profile, "device_busy_share": busy,
            "small_batch": {"step_ms": 1e3 * dt_small,
                            "device_busy_share": busy_small,
                            "profile": profile_small},
            "pack_ms": pack_ms, "remat": remat, "function_bwd": fn_bwd,
            "trainer": trainer_stats, "step_vs_plain": step_errs,
            "seconds": seconds}


def bits(t):
    """A tensor's bits as integers (NaN-aware bitwise comparison)."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def vae_l2_path(dev, rows: dict, warm_ckpt: Path, keep: Path,
                live_weights: dict) -> dict:
    """The L2-supervised VAE training path: (6a) train steps at batch 64
    on a DeviceTileBuffer's batches through K1a, K1b and K2, counted,
    timed and profiled; (2''') GroupNormActFn's backward at the head's
    shapes; (6b) the buffer's batches against the CPU buffer's, bit for
    bit; (6c) the train_vae_l2 CLI from a dict, once a loader, its VAE
    warm-started from ``warm_ckpt``, and its checkpoint reloaded bit for
    bit (copied to ``keep``/l2, and its weights to
    ``live_weights``["l2"], for phase 7); (6d) one step against the plain
    path. Adds each kernel's launches an L2 step to its row; returns the
    metrics."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tempo_tpu_torch.cli import train_vae_l2
    from tempo_tpu_torch.data.device_buffer import DeviceTileBuffer
    from tempo_tpu_torch.data.synthetic import make_tile_shards
    from tempo_tpu_torch.models.vae_l2 import L2_PRODUCTS, build_vae_l2
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv
    from tempo_tpu_torch.train.checkpoint import checkpoint_path
    from tempo_tpu_torch.train.state import (create_train_state,
                                             make_optimizer)
    from tempo_tpu_torch.train.step import make_train_step, vae_l2_loss_fn
    from tempo_tpu_torch.train.trainer import Trainer

    card = smi_line()
    seconds = {}
    products = list(L2_PRODUCTS)
    counters = {"K1a": (cuda_gn.LAUNCHES, "gn_stats"),
                "K1b": (cuda_gn.LAUNCHES, "gn_apply"),
                "K2": (cuda_gn_conv.LAUNCHES, "gn_act_conv3x3")}
    batch_n = VAE_TRAIN_BATCH

    def fresh(model_cfg=VAE_MODEL, dtype=None, seed=SEED):
        model, _ = build_vae_l2(model_cfg, VAE_L2_HIDDEN, compute_dtype=dtype,
                                device=dev, seed=seed)
        nudge_zero_init(model, torch.Generator(device=dev).manual_seed(seed))
        tx = make_optimizer(lr=1e-4, betas=(0.9, 0.95), weight_decay=0.05)
        return model, tx, create_train_state(model, tx, SEED)

    def noise():
        """The posterior's two draws: the same on both sides of a check."""
        return torch.Generator(device=dev).manual_seed(SEED + 1)

    def loss_and_grads(model, batch):
        model.zero_grad(set_to_none=True)
        loss, metrics = model.compute_loss(batch, noise())
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return {k: float(v.detach()) for k, v in metrics.items()}, grads

    def buffer(shards, swap_every, device, seed=SEED):
        return DeviceTileBuffer(shards, batch_size=batch_n,
                                slots=VAE_L2_SLOTS, swap_every=swap_every,
                                seed=seed, dtype="float16", device=device,
                                l2_products=products)

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    try:
        # --------------------- (a) train steps on the buffer, counted
        t_phase = time.perf_counter()
        c, h, w = FLAGSHIP_L2["model"]["shape"]
        shards = make_tile_shards(
            tmp / "tiles" / "train", n_files=VAE_L2_SHARDS,
            tiles_per_file=VAE_L2_TILES, tile=h, n_spectral=c,
            l2_products=products, seed=SEED, dtype=np.float16)
        model, tx, state = fresh()
        buf = buffer(shards, VAE_L2_SWAP, dev)
        try:
            fixed = next(buf)
            calls = {"K1a": [], "K1b": [], "K2": []}
            with recording(calls, "l2_train"):
                loss, _ = model.compute_loss(fixed, noise())
            del loss
            per_forward = {k: len(v) for k, v in calls.items()}
            with torch.no_grad():
                before = float(model.compute_loss(fixed, noise())[0])
            step = make_train_step(vae_l2_loss_fn(model), tx)
            history = []
            for _ in range(TRAIN_WARM):
                state, m = step(state, next(buf))
                history.append(m)
            torch.cuda.synchronize()
            for table, key in counters.values():
                table[key] = 0
            torch.cuda.reset_peak_memory_stats()
            resident_gb = torch.cuda.memory_allocated() / 1e9
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                state, m = step(state, next(buf))
                history.append(m)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / TRAIN_STEPS
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            launches = {k: table[key] / TRAIN_STEPS
                        for k, (table, key) in counters.items()}
            with torch.no_grad():
                after = float(model.compute_loss(fixed, noise())[0])
            history = [{k: float(v) for k, v in m.items()} for m in history]
            profile = step_breakdown(lambda: step(state, next(buf)),
                                     VAE_L2_STEP_KINDS, "vae_l2")
            busy = None if profile is None else profile["device_ms"] / (
                1e3 * dt)
            buf.swap_every = 10 ** 9  # the gather alone in the window
            gather_ms = time_ms(lambda: next(buf))
        finally:
            buf.close()
        gather_bytes = 2 * sum(v.numel() * v.element_size()
                               for v in fixed.values())
        gather_bound = 1e3 * gather_bytes / HBM_BYTES_PER_S
        print(f"[vae_l2] launches an L2 train step: {launches} (calls in "
              f"one training forward {per_forward}; the base VAE step's "
              f"24/2/22 and the head's two GroupNorms, each one K1a and one "
              f"K1b)", flush=True)
        for name, n in launches.items():
            rows[name]["l2_train_launches_per_step"] = n
            if n == 0 or n != per_forward[name]:
                fail(f"{name}: {n} launches an L2 train step, "
                     f"{per_forward[name]} calls in its forward")
        keys = ["loss"] + [f"{p}_loss" for p in products]
        finite = all(math.isfinite(m[k]) for m in history for k in keys)
        print(f"[vae_l2] flagship + head bf16, batch {batch_n} from the "
              f"DeviceTileBuffer ({VAE_L2_SLOTS} slots of "
              f"{VAE_L2_SHARDS} fp16 shards x {VAE_L2_TILES}, a swap every "
              f"{VAE_L2_SWAP}): vae_l2.step_ms {1e3 * dt:.2f}, "
              f"vae_l2.patches_per_s {batch_n / dt:.1f}, "
              f"vae_l2.peak_device_gb {peak_gb:.2f} ({resident_gb:.2f} "
              f"resident before the steps: the pool, the model, the "
              f"optimizer and what earlier phases hold; on {card}); the fixed "
              f"batch's loss {before:.6g} -> {after:.6g} over "
              f"{len(history)} steps; per step "
              f"{[{k: round(m[k], 5) for k in keys} for m in history]}",
              flush=True)
        print(f"[vae_l2] one step (with its gather) under torch.profiler: "
              f"{json.dumps(profile)}; device busy share {busy}; the "
              f"gather {gather_ms:.4f} ms a batch of device time, byte "
              f"bound {gather_bound:.4f} ms", flush=True)
        if not finite or not after < before:
            fail(f"the L2 train loss or a product's loss is not finite, or "
                 f"the fixed batch's loss did not fall: {before} -> {after}")
        seconds["6a"] = time.perf_counter() - t_phase

        # ---------------- (2''') GroupNormActFn's backward at the head
        t_phase = time.perf_counter()
        del model, tx, state, step
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        head = sorted({k for k, _ in calls["K1a"] if k[3] == K1_HEAD[1]},
                      key=str)
        fn_bwd = {}
        saved_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for shape, _, groups, eps in head:
                fn_bwd[f"K1 {list(shape)} gelu eps {eps}"] = check_k1_bwd(
                    gen, shape, groups, eps, "gelu")
        finally:
            torch.backends.cudnn.deterministic = saved_det
        for key, r in fn_bwd.items():
            print(f"[kernels] Function backward (L2 head) {key}: "
                  f"{json.dumps(r)}", flush=True)
        if not head or not all(r["fn"] and r["rel_l2"] <= FN_BWD_REL
                               for r in fn_bwd.values()):
            fail(f"GroupNormActFn's backward at the head's shapes {head} "
                 f"disagrees with autograd through the plain chain beyond "
                 f"rel L2 {FN_BWD_REL}")
        seconds["2'''"] = time.perf_counter() - t_phase

        # --------------------- (b) the buffer against the CPU buffer
        t_phase = time.perf_counter()
        on_dev = buffer(shards, VAE_L2_EQ_SWAP, dev, SEED + 3)
        on_cpu = buffer(shards, VAE_L2_EQ_SWAP, "cpu", SEED + 3)
        try:
            same = []
            for _ in range(VAE_L2_EQ_BATCHES):
                a, b = next(on_dev), next(on_cpu)
                same.append(sorted(a) == sorted(b) and all(
                    a[k].dtype == b[k].dtype
                    and torch.equal(bits(a[k].cpu()), bits(b[k]))
                    for k in b))
        finally:
            on_dev.close()
            on_cpu.close()
        print(f"[vae_l2] buffer on the card vs on the CPU, same seed, "
              f"{VAE_L2_EQ_BATCHES} batches across "
              f"{VAE_L2_EQ_BATCHES // VAE_L2_EQ_SWAP - 1} swaps (spectral "
              f"and every product, bit for bit): {same}", flush=True)
        if not all(same):
            fail(f"the device buffer's batches differ from the CPU "
                 f"buffer's: {same}")
        seconds["6b"] = time.perf_counter() - t_phase

        # ------------------------ (c) the CLI, once a loader, resumed
        t_phase = time.perf_counter()
        cli = {}
        live = None
        real = train_vae_l2.make_train_loader
        for loader in ("device", "host"):
            cfg = copy.deepcopy(FLAGSHIP_L2)
            cfg["output_dir"] = str(tmp / f"run_{loader}")
            cfg["data"].update(data_dir=str(tmp / "tiles"), loader=loader)
            cfg["model"]["init_from_vae_checkpoint"] = str(warm_ckpt)
            cfg["training"].update(n_steps=VAE_L2_CLI_STEPS,
                                   save_every=VAE_L2_CLI_STEPS,
                                   log_every=5, plot_every=10)
            timed = []

            def timed_loader(*args, **kwargs):
                timed.append(Timed(real(*args, **kwargs)))
                return timed[-1]

            train_vae_l2.make_train_loader = timed_loader
            try:
                trainer, stats = train_vae_l2.run(cfg, device=dev)
            finally:
                train_vae_l2.make_train_loader = real
            out = Path(cfg["output_dir"])
            ckpt = checkpoint_path(out / "checkpoints", VAE_L2_CLI_STEPS)
            written = {name: p.exists() for name, p in (
                ("checkpoint", ckpt),
                ("l2_losses.png", out / "summary" / "l2_losses.png"),
                ("figure", out / "figures" /
                 f"reconstructions_step_{VAE_L2_CLI_STEPS:06d}.png"),
                ("metrics.json", out / "metrics.json"),
                ("training_info.yaml", out / "training_info.yaml"))}
            last = json.loads((out / "metrics.json").read_text())["train"][-1]
            cli[loader] = {"samples_per_sec": stats["samples_per_sec"],
                           "loader_wait_share":
                               timed[0].wait_s / stats["elapsed_s"],
                           "elapsed_s": stats["elapsed_s"],
                           "written": written, "last": last}
            print(f"[vae_l2] train_vae_l2.run, loader {loader}, "
                  f"{VAE_L2_CLI_STEPS} steps at batch {batch_n}, warm-started "
                  f"from 5b's checkpoint: {json.dumps(cli[loader])}",
                  flush=True)
            if not all(written.values()):
                fail(f"train_vae_l2 ({loader} loader) did not write "
                     f"{[k for k, v in written.items() if not v]}")
            if loader == "device":
                live, live_ckpt = trainer, ckpt
            del trainer
        model2, _, _ = fresh(seed=SEED + 99)
        state2 = create_train_state(model2, live.tx, SEED)
        weights = FLAGSHIP_L2["l2"]["weights"]
        again = Trainer(vae_l2_loss_fn(model2, weights), live.tx, state2,
                        tmp / "resume", device=dev, verbose=False)
        again.load_checkpoint(live_ckpt)
        (keep / "l2").mkdir()
        shutil.copy(live_ckpt, keep / "l2" / live_ckpt.name)
        live_weights["l2"] = {k: v.detach().clone() for k, v in
                              live.state.model.state_dict().items()}
        saved = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            s1, _ = live.train_step(live.state, fixed)
            s2, _ = again.train_step(again.state, fixed)
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = saved
        resumed = all(torch.equal(a, b) for a, b in zip(
            s1.model.parameters(), s2.model.parameters()))
        resumed &= all(torch.equal(s1.ema[k], s2.ema[k]) for k in s1.ema)
        print(f"[vae_l2] one more step from the CLI's reloaded checkpoint "
              f"equals the live state's bit for bit: {resumed}", flush=True)
        if not resumed:
            fail("an L2 step from the reloaded checkpoint differs from the "
                 "live state's")
        del live, again, s1, s2, model2, state2
        torch.cuda.empty_cache()
        seconds["6c"] = time.perf_counter() - t_phase

        # ------------------------ (d) one step against the plain path
        t_phase = time.perf_counter()

        def compare(kernel_run, plain_run):
            (mk, gk), (mp, gp) = kernel_run, plain_run
            rel = {k: abs(mk[k] - mp[k]) / abs(mp[k]) for k in mp
                   if k in ("loss", "pixel_mse") or k.endswith("_loss")
                   and k[:-5] in products}
            head = {k: rel_l2(gk[k], gp[k]) for k in gp
                    if k.startswith("l2_head.")}
            body = {k: rel_l2(gk[k], gp[k]) for k in gp
                    if k.startswith("vae.") and not k.endswith("k.bias")}
            return {"rel": rel, "max_head_grad_rel_l2": max(head.values()),
                    "max_vae_grad_rel_l2": max(body.values())}

        step_errs = {}
        for label, model_cfg, dtype, n, tol in (
                ("bf16_l1", VAE_MODEL, None, batch_n, STEP_BF16_TOL),
                ("f32_l2_b2", dict(VAE_MODEL, nll_loss_type="l2"),
                 "float32", 2, STEP_F32_TOL)):
            model, _, _ = fresh(model_cfg, dtype)
            batch = {k: v[:n] for k, v in fixed.items()}
            kernel_run = loss_and_grads(model, batch)
            with plain_kernels():
                plain_run = loss_and_grads(model, batch)
            err = compare(kernel_run, plain_run)
            ok = (max(err["rel"].values()) <= tol["loss"]
                  and err["max_head_grad_rel_l2"] <= tol["grad"])
            if dtype is None:
                # the VAE's gradients under L1, against the fp32 step
                # (5c's rule, VAE_BF16_ACC)
                ref, _, _ = fresh(model_cfg, "float32")
                ref.load_state_dict(model.state_dict())
                del model
                with plain_kernels():
                    ref_run = loss_and_grads(ref, batch)
                del ref
                gk, gp, gt = kernel_run[1], plain_run[1], ref_run[1]
                acc = {k: (rel_l2(gk[k], gt[k]), rel_l2(gp[k], gt[k]))
                       for k in gt if k.startswith("vae.")
                       and not k.endswith("attn1.k.bias")}
                beyond = [k for k, (rk, rp) in acc.items()
                          if rk > max(tol["grad"], VAE_BF16_ACC * rp)]
                err["vae_grads_vs_fp32"] = {
                    "kernel_max": max(r[0] for r in acc.values()),
                    "plain_max": max(r[1] for r in acc.values()),
                    "beyond_rule": beyond}
                ok &= not beyond
                del ref_run
            else:
                del model
                ok &= err["max_vae_grad_rel_l2"] <= tol["grad"]
            step_errs[label] = err
            del kernel_run, plain_run
            torch.cuda.empty_cache()
            if not ok:
                fail(f"the {label} L2 step through K1/K2 disagrees with the "
                     f"plain path: {err} (tol {tol}; the L1 step's VAE "
                     f"gradients against fp32 by VAE_BF16_ACC "
                     f"{VAE_BF16_ACC})")
        print(f"[vae_l2] one step, K1/K2 vs the plain path: "
              f"{json.dumps(step_errs)} (each product's loss, the loss and "
              f"pixel MSE within {STEP_BF16_TOL['loss']} bf16 / "
              f"{STEP_F32_TOL['loss']} fp32; head gradients within "
              f"{STEP_BF16_TOL['grad']} / {STEP_F32_TOL['grad']})",
              flush=True)
        seconds["6d"] = time.perf_counter() - t_phase
    finally:
        tmp_dir.cleanup()
    print(f"[time] L2 training phases, s: {json.dumps(seconds)}", flush=True)
    return {"card": card, "batch": batch_n, "step_ms": 1e3 * dt,
            "patches_per_s": batch_n / dt, "peak_device_gb": peak_gb,
            "resident_gb": resident_gb,
            "launches_per_step": launches, "fixed_batch_loss":
                [before, after], "history": history, "profile": profile,
            "device_busy_share": busy, "gather_ms": gather_ms,
            "gather_bound_ms": gather_bound, "function_bwd": fn_bwd,
            "buffer_bitwise": same, "cli": cli, "resume_bitwise": resumed,
            "step_vs_plain": step_errs, "seconds": seconds}


def dtype_tol(dtype) -> dict:
    import torch

    return BF16_TOL if dtype == torch.bfloat16 else F32_TOL


def k2_config(x, f: int) -> tuple:
    """K2's (configuration, split) for a call: the bf16 kernel's tiles, or
    its one fp32 path."""
    import torch

    from tempo_tpu_torch.ops import cuda_gn_conv

    if x.dtype == torch.bfloat16:
        return cuda_gn_conv.choose_config(*x.shape, f)
    return "conv_f32", 1


def count_calls(recorded: list, runs: tuple = ()) -> dict:
    """``recording``'s (key, run) list as {key: {run: calls}}, with each of
    ``runs`` present."""
    out = {}
    for key, run in recorded:
        n = out.setdefault(key, dict.fromkeys(runs, 0))
        n[run] = n.get(run, 0) + 1
    return out


def hold_recorded(dev, gen, counted: dict, add) -> bool:
    """K1a, K1b and K2 against their plain versions at every (shape, type)
    of ``counted`` ({kernel: count_calls(...)}), random inputs on the card,
    each call timed alone (cold L2) beside its bound (bytes, or operations
    at the card's peak for the type), its plain version and its library
    call. Tolerances: K1a STATS_TOL; K1b and K2 BF16_TOL or F32_TOL by
    type.

    - K1a: also bitwise the same on a repeat and for each sample alone;
      beside it a device copy of half of x (as many bytes moved).
    - K1b: from given statistics, and whole (K1a + K1b); the library
      GroupNorm computes the statistics too, so compare it with
      ``k1_whole_ms``.
    - K2: the whole wrapper (K1a, then K2) against the plain chain; ``ms``
      times the K2 launch alone from given statistics, beside the plain
      version of that step and cuDNN's conv of the activated input
      (``library_conv_ms``); the library chain F.group_norm + act +
      F.conv2d computes the statistics too, so compare it with
      ``whole_ms``.

    Each shape goes to ``add(kernel, shape_info, calls_by_run, err, ok, ms,
    plain_ms, bound_ms, bound_by, library_ms, extra)``; returns whether
    every check held."""
    import torch
    import torch.nn.functional as F

    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv
    from tempo_tpu_torch.ops.norms import ACTIVATIONS

    def act_fn(act):
        return ACTIVATIONS[act] if act else (lambda t: t)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def affine(c):
        return 1 + randn(gen, c, scale=0.1), randn(gen, c, scale=0.1)

    ok_all = True
    with torch.inference_mode():
        for (shape, dt, groups, eps), n in counted["K1a"].items():
            b, c = shape[0], shape[-1]
            x = randn(gen, *shape, dtype=getattr(torch, dt))
            got = cuda_gn.gn_stats(x, groups, eps)
            err, ok = max_err(got, cuda_gn.gn_stats_plain(x, groups, eps),
                              STATS_TOL)
            repeat = torch.equal(got, cuda_gn.gn_stats(x, groups, eps))
            alone = all(torch.equal(got[i:i + 1], cuda_gn.gn_stats(
                x[i:i + 1], groups, eps)) for i in range(b))
            ok = ok and repeat and alone
            half = x.view(-1)[: x.numel() // 2]
            dst = torch.empty_like(half)
            xg = x.view(b, -1, groups, c // groups)
            nbytes = x.numel() * x.element_size() + got.numel() * 4
            add("K1a", {"x": list(shape), "dtype": dt,
                        "split": cuda_gn.choose_stats_split(
                            x.numel() // (b * c), c, x.dtype)}, n, err, ok,
                time_ms(lambda: cuda_gn.gn_stats(x, groups, eps)),
                time_ms(lambda: cuda_gn.gn_stats_plain(x, groups, eps)),
                1e3 * nbytes / HBM_BYTES_PER_S, "bytes",
                time_ms(lambda: torch.var_mean(xg, dim=(1, 3),
                                               correction=0)),
                {"bitwise_repeat": repeat, "bitwise_alone": alone,
                 "copy_ms": time_ms(lambda: dst.copy_(half))})
            ok_all &= ok
            del x, xg, half, dst
        for (shape, dt, act), n in counted["K1b"].items():
            c = shape[-1]
            x = randn(gen, *shape, dtype=getattr(torch, dt))
            scale, bias = affine(c)
            st = cuda_gn.gn_stats_plain(x, 8, 1e-6)
            want = cuda_gn.gn_apply_plain(x, st, scale, bias, act)
            err, ok = max_err(cuda_gn.gn_apply(x, st, scale, bias, act), want,
                              dtype_tol(x.dtype))
            whole_err, whole_ok = max_err(
                cuda_gn.fused_group_norm_act(x, scale, bias, 8, 1e-6, act),
                want, dtype_tol(x.dtype))
            ok = ok and whole_ok
            sb, bb = scale.to(x.dtype), bias.to(x.dtype)
            nbytes = (2 * x.numel() * x.element_size() + st.numel() * 4
                      + 2 * c * 4)
            add("K1b", {"x": list(shape), "dtype": dt, "act": act}, n,
                max(err, whole_err), ok,
                time_ms(lambda: cuda_gn.gn_apply(x, st, scale, bias, act)),
                time_ms(lambda: cuda_gn.gn_apply_plain(x, st, scale, bias,
                                                       act)),
                1e3 * nbytes / HBM_BYTES_PER_S, "bytes",
                time_ms(lambda: act_fn(act)(F.group_norm(
                    nchw(x), 8, sb, bb, 1e-6))),
                {"k1_whole_ms": time_ms(
                    lambda: cuda_gn.fused_group_norm_act(x, scale, bias, 8,
                                                         1e-6, act))})
            ok_all &= ok
            del x, want
        for (shape, dt, f, groups, eps, act), n in counted["K2"].items():
            b, h, w, c = shape
            x = randn(gen, *shape, dtype=getattr(torch, dt))
            scale, bias = affine(c)
            weight = torch.empty((f, c, 3, 3), device=dev).uniform_(
                -(9 * c) ** -0.5, (9 * c) ** -0.5, generator=gen)
            cb = randn(gen, f, scale=0.01)
            packed = cuda_gn_conv.pack_conv3x3_weight(weight, x.dtype)
            err, ok = max_err(
                cuda_gn_conv.gn_act_conv3x3(x, scale, bias, weight, cb,
                                            groups, eps, act, packed),
                cuda_gn_conv.gn_act_conv3x3_plain(x, scale, bias, weight, cb,
                                                  groups, eps, act),
                dtype_tol(x.dtype))
            st = cuda_gn.gn_stats(x, groups, eps)
            flops = 2 * b * h * w * 9 * c * f
            nbytes = ((x.numel() + packed.numel() + b * h * w * f)
                      * x.element_size() + st.numel() * 4)
            t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
            sb, bb = scale.to(x.dtype), bias.to(x.dtype)
            wt, cbt = weight.to(x.dtype), cb.to(x.dtype)
            activated = nchw(cuda_gn.gn_apply_plain(x, st, scale, bias, act))
            ms = time_ms(lambda: cuda_gn_conv.conv3x3_from_stats(
                x, st, scale, bias, weight, cb, act, packed))
            config, split = k2_config(x, f)
            add("K2", {"x": list(shape), "dtype": dt, "f": f, "act": act,
                       "config": config, "split": split}, n, err, ok, ms,
                time_ms(lambda: cuda_gn_conv.conv3x3_from_stats_plain(
                    x, st, scale, bias, weight, cb, act)),
                1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes",
                time_ms(lambda: F.conv2d(act_fn(act)(F.group_norm(
                    nchw(x), groups, sb, bb, eps)), wt, cbt, padding=1)),
                {"whole_ms": time_ms(lambda: cuda_gn_conv.gn_act_conv3x3(
                    x, scale, bias, weight, cb, groups, eps, act, packed)),
                 "library_conv_ms": time_ms(lambda: F.conv2d(
                     activated, wt, cbt, padding=1)),
                 "gflop": flops / 1e9, "tflops": flops / ms / 1e9})
            ok_all &= ok
            del x, activated
    return ok_all


def hold_kernels(dev, gen, calls: dict) -> list:
    """K1a, K1b and K2 against their plain versions at every distinct shape
    and type in ``calls`` (phase 2's tolerances, random inputs on the
    card)."""
    import torch

    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

    out = []
    with torch.inference_mode():
        for shape, dt, groups, eps in sorted({k for k, _ in calls["K1a"]},
                                             key=str):
            x = randn(gen, *shape, dtype=getattr(torch, dt))
            err, ok = max_err(cuda_gn.gn_stats(x, groups, eps),
                              cuda_gn.gn_stats_plain(x, groups, eps),
                              STATS_TOL)
            out.append({"kernel": "K1a", "x": list(shape), "dtype": dt,
                        "eps": eps,
                        "max_abs_err": err, "ok": ok})
        for shape, dt, act in sorted({k for k, _ in calls["K1b"]}, key=str):
            x = randn(gen, *shape, dtype=getattr(torch, dt))
            c = shape[-1]
            scale, bias = 1 + randn(gen, c, scale=0.1), randn(gen, c,
                                                              scale=0.1)
            st = cuda_gn.gn_stats_plain(x, 8, 1e-6)
            err, ok = max_err(cuda_gn.gn_apply(x, st, scale, bias, act),
                              cuda_gn.gn_apply_plain(x, st, scale, bias, act),
                              dtype_tol(x.dtype))
            out.append({"kernel": "K1b", "x": list(shape), "dtype": dt,
                        "act": act,
                        "max_abs_err": err, "ok": ok})
        for shape, dt, f, groups, eps, act in sorted(
                {k for k, _ in calls["K2"]}, key=str):
            c = shape[-1]
            x = randn(gen, *shape, dtype=getattr(torch, dt))
            scale, bias = 1 + randn(gen, c, scale=0.1), randn(gen, c,
                                                              scale=0.1)
            weight = torch.empty((f, c, 3, 3), device=dev).uniform_(
                -(9 * c) ** -0.5, (9 * c) ** -0.5, generator=gen)
            cb = randn(gen, f, scale=0.01)
            packed = cuda_gn_conv.pack_conv3x3_weight(weight, x.dtype)
            err, ok = max_err(
                cuda_gn_conv.gn_act_conv3x3(x, scale, bias, weight, cb,
                                            groups, eps, act, packed),
                cuda_gn_conv.gn_act_conv3x3_plain(x, scale, bias, weight, cb,
                                                  groups, eps, act),
                dtype_tol(x.dtype))
            out.append({"kernel": "K2", "x": list(shape), "dtype": dt,
                        "f": f, "config": k2_config(x, f),
                        "max_abs_err": err, "ok": ok})
            del x
    return out


def analysis_path(dev, rows: dict, keep: Path, live: dict) -> dict:
    """The VAE evaluation and analysis path on the flagship (phase 7):
    (a) cli/evaluate_reconstruction.run over 5b's two checkpoints and a
    shard of 32 flagship tiles, against the same sweep through the plain
    versions; (b) load_params of 5b's and 6c's checkpoints against the live
    weights, bit for bit; (c) one structured
    granule [131, 2048, 1028] through encode_granules' per-granule
    function: the device normalize against numpy's and float64, the latent
    against the plain path, the metrics on the card against numpy's; (d)
    PCA-RGB of that granule and its reconstruction from pixels drawn as
    extract_pca draws them; (e) probe_analysis' per-granule function over
    2 structured granules [128, 512, 1028] encoded by 6c's checkpoint, and
    a linear probe a product. K1a, K1b and K2 held against their plain
    versions at every shape the sweep and the granules give them; their
    launches in a sweep batch and in a granule's encode+decode added to
    their rows."""
    import numpy as np
    import torch

    from tempo_tpu_torch.analysis.pca import fit_pca
    from tempo_tpu_torch.cli import (analyze_reconstruction, encode_granules,
                                     evaluate_reconstruction, extract_pca,
                                     probe_analysis)
    from tempo_tpu_torch.data.normalize import normalize_radiance
    from tempo_tpu_torch.data.synthetic import (make_tile_shards,
                                                structured_granule,
                                                with_fill_values)
    from tempo_tpu_torch.infer.granule_codec import GranuleCodec
    from tempo_tpu_torch.infer.sweep import (batch_metrics, compute_metrics,
                                             evaluate_checkpoints)
    from tempo_tpu_torch.analysis.spectrum import pk_op
    from tempo_tpu_torch.models.vae import VAEConfig, build_vae
    from tempo_tpu_torch.models.vae_l2 import build_vae_l2
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv
    from tempo_tpu_torch.train.checkpoint import list_checkpoints, load_params
    from tempo_tpu_torch.train.png import PNG_SIGNATURE
    from tempo_tpu_torch.utils.config import save_json_yaml

    card = smi_line()
    seconds = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    counters = {"K1a": (cuda_gn.LAUNCHES, "gn_stats"),
                "K1b": (cuda_gn.LAUNCHES, "gn_apply"),
                "K2": (cuda_gn_conv.LAUNCHES, "gn_act_conv3x3")}
    calls = {"K1a": [], "K1b": [], "K2": []}

    def zero():
        torch.cuda.synchronize()
        for table, key in counters.values():
            table[key] = 0

    def launched():
        torch.cuda.synchronize()
        return {k: table[key] for k, (table, key) in counters.items()}

    def is_png(path: Path) -> bool:
        return path.exists() and path.read_bytes()[:8] == PNG_SIGNATURE

    # ---------------------------------------------- (a) the sweep, the CLI
    t_phase = time.perf_counter()
    exp_dir = keep / "vae_run"
    save_json_yaml({"model": VAE_MODEL}, exp_dir / "config.yaml")
    vcfg = VAEConfig.from_dict(VAE_MODEL)
    val_dir = make_tile_shards(keep / "val", n_files=1,
                               tiles_per_file=ANALYSIS_EVAL["data"][
                                   "max_val_samples"], tile=vcfg.input_size,
                               n_spectral=vcfg.in_channels, seed=SEED + 7,
                               dtype=np.float16)
    cfg = dict(ANALYSIS_EVAL, exp_dir=str(exp_dir),
               data=dict(ANALYSIS_EVAL["data"], val_dir=str(val_dir)))
    ckpts = list_checkpoints(exp_dir / "checkpoints")
    evaluation = cfg["evaluation"]
    n_val, batch = cfg["data"]["max_val_samples"], evaluation["batch_size"]
    n_batches = len(ckpts) * -(-n_val // batch)
    zero()
    t0 = time.perf_counter()
    results = evaluate_reconstruction.run(cfg, device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = {k: n / n_batches for k, n in launched().items()}
    out = exp_dir / cfg["output_dir"]
    written = {name: p.exists() if name.endswith(".json") else is_png(p)
               for name, p in (
                   ("reconstruction_metrics.json",
                    out / "results" / "reconstruction_metrics.json"),
                   ("metrics_vs_step.png",
                    out / "figures" / "metrics_vs_step.png"),
                   ("best_metrics_summary.png",
                    out / "figures" / "best_metrics_summary.png"))}
    # the same sweep through the plain versions, and the shapes of a batch
    model, _ = build_vae(VAE_MODEL, device=dev, seed=SEED)
    tiles = evaluate_reconstruction.load_val_tiles(val_dir, n_val)
    with plain_kernels():
        plain = evaluate_checkpoints(model, exp_dir / "checkpoints", tiles,
                                     batch, evaluation["metrics"],
                                     verbose=False)
    with torch.inference_mode(), recording(calls, "sweep"):
        batch_metrics(model, torch.from_numpy(tiles[:batch]).to(dev),
                      torch.Generator(device=dev).manual_seed(0),
                      pk_op(vcfg.input_size, 2, dev))
    sweep_rel = [{k: abs(r[k] - p[k]) / abs(p[k]) for k in ("mse", "pk_err")}
                 for r, p in zip(results, plain)]
    finite = all(math.isfinite(r[k]) for r in results
                 for k in evaluation["metrics"])
    print(f"[analysis] 7a evaluate_reconstruction.run, {len(ckpts)} "
          f"checkpoints of 5b x {n_val} flagship tiles at batch {batch}: "
          f"{sweep_s:.2f} s host wall ({len(ckpts) * n_val / sweep_s:.1f} "
          f"patches/s, loads and figures included) on {card}; results "
          f"{json.dumps(results)}; vs the plain path, rel "
          f"{json.dumps(sweep_rel)} (tol {ANALYSIS_SWEEP_REL}); written "
          f"{written}; launches a sweep batch {sweep_launches}", flush=True)
    if not all(written.values()) or not finite or len(results) != 2:
        fail(f"the sweep did not write its files or its metrics are not "
             f"finite: {written} {results}")
    if not all(v <= ANALYSIS_SWEEP_REL for r in sweep_rel for v in r.values()):
        fail("the sweep's mse or pk_err disagrees with the plain path's")
    seconds["7a"] = time.perf_counter() - t_phase

    # ------------------------------------------------------ (b) the loader
    t_phase = time.perf_counter()
    x = torch.from_numpy(tiles[:batch]).to(dev)
    l2_ckpt = next((keep / "l2").glob("ckpt_step=*.pt"))

    def posterior_mean(m):
        with torch.inference_mode():
            return m.encode(x).mean

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        loaded = load_params(ckpts[-1], model)
        got = posterior_mean(loaded)
        twin, _ = build_vae(VAE_MODEL, device=dev, seed=SEED + 1)
        twin.load_state_dict(live["vae"])
        same_vae = torch.equal(got, posterior_mean(twin))
        l2_model, _ = build_vae_l2(FLAGSHIP_L2["model"], VAE_L2_HIDDEN,
                                   device=dev, seed=SEED + 2)
        load_params(l2_ckpt, l2_model)
        l2_twin, _ = build_vae_l2(FLAGSHIP_L2["model"], VAE_L2_HIDDEN,
                                  device=dev, seed=SEED + 3)
        l2_twin.load_state_dict(live["l2"])
        same_l2 = torch.equal(posterior_mean(l2_model.vae),
                              posterior_mean(l2_twin.vae))
        nested, _ = build_vae(VAE_MODEL, device=dev, seed=SEED + 4)
        load_params(l2_ckpt, nested)  # the L2 checkpoint's vae.*
        same_nested = torch.equal(posterior_mean(nested),
                                  posterior_mean(l2_twin.vae))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    print(f"[analysis] 7b load_params, posterior mean of {batch} tiles bit "
          f"for bit the live weights': 5b's checkpoint {same_vae}, 6c's L2 "
          f"checkpoint {same_l2}, its vae.* into the base VAE "
          f"{same_nested} (a .msgpack full-state resume: phase 14d)",
          flush=True)
    if not (same_vae and same_l2 and same_nested):
        fail("load_params did not give the live weights")
    del twin, l2_model, l2_twin, x, loaded
    seconds["7b"] = time.perf_counter() - t_phase

    # -------------------- (c) a granule through encode_granules, normalize
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rad, fields = structured_granule(np.random.default_rng(SEED),
                                     *ANALYSIS_GRANULE)
    make_s = time.perf_counter() - t0
    live["granule"] = (rad, fields)  # phase 8b prepares it

    def f64_normalize(raw64, spectra):
        """The normalize in float64 on the card; the granule's own
        statistics when ``spectra`` is None."""
        log64 = torch.clamp(raw64, min=1.0).log_()
        if spectra is None:
            std64, mean64 = torch.std_mean(log64, dim=(0, 1), correction=0)
        else:
            mean64, std64 = (torch.as_tensor(a, device=dev).double()
                             for a in spectra)
        return log64.sub_(mean64).div_(std64 + 1e-8).clamp_(-10, 10)

    def distances(z_dev, z_host, spectra):
        """Max abs distances: device to numpy, and each to float64."""
        z_host = torch.from_numpy(z_host).to(dev)
        z64 = f64_normalize(raw_dev.double(), spectra)
        return {"max_abs_vs_numpy": float((z_dev - z_host).abs().max()),
                "numpy_vs_f64": float((z_host.double() - z64).abs().max()),
                "device_vs_f64": float((z_dev.double() - z64).abs().max())}

    with torch.inference_mode():
        raw_dev = torch.from_numpy(rad).to(dev)
        # the statistics a stats file holds for this granule (as
        # encode_granules reads them from data.tiles_path)
        log64 = torch.clamp(raw_dev.double(), min=1.0).log_()
        std64, mean64 = torch.std_mean(log64, dim=(0, 1), correction=0)
        spectra = (mean64.float().cpu().numpy(), std64.float().cpu().numpy())
        del log64
        t0 = time.perf_counter()
        z_np = normalize_radiance(rad, *spectra)
        numpy_s = time.perf_counter() - t0
        normalize_ms = time_ms(lambda: normalize_radiance(raw_dev, *spectra),
                               iters=5, warmup=1)
        norm = distances(normalize_radiance(raw_dev, *spectra), z_np,
                         spectra)
        del z_np
        # with the granule's own statistics (encode_granules without
        # data.tiles_path): numpy sums each channel's 268,288 fp32 values
        # one row after another (an outer-axis reduction), so its z is
        # held to float64, the device's no farther from it
        t0 = time.perf_counter()
        z_np = normalize_radiance(rad)
        numpy_own_s = time.perf_counter() - t0
        norm_own = distances(normalize_radiance(raw_dev), z_np, None)
        del z_np, raw_dev
        codec = GranuleCodec(model, *spectra, multiple=vcfg.input_size,
                             seed=42, device=dev)  # 5b's step-30 VAE
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gt = codec.normalize_tensor(rad)
        torch.cuda.synchronize()
        normalize_wall_s = time.perf_counter() - t0
        h, w = gt.shape[:2]
    norm_ok = (norm["max_abs_vs_numpy"] <= ANALYSIS_NORM_ATOL
               and norm["device_vs_f64"]
               <= norm["numpy_vs_f64"] + ANALYSIS_NORM_F64_SLACK
               and norm_own["device_vs_f64"]
               <= norm_own["numpy_vs_f64"] + ANALYSIS_NORM_F64_SLACK)
    zero()
    latent, entry = encode_granules.encode_granule(codec, rad, True)
    granule_launches = launched()
    with torch.inference_mode(), recording(calls, "granule"):
        latent_t = codec.encode(gt)
        recon = codec.decode_tensor(latent_t)
    with torch.inference_mode(), plain_kernels():
        lat_plain = codec.encode(gt)
    lat_rel = rel_l2(latent_t, lat_plain)
    gt_host, recon_host = gt.cpu().numpy(), recon.float().cpu().numpy()
    t0 = time.perf_counter()
    host_metrics = compute_metrics(gt_host, recon_host, ["mse", "mae",
                                                         "psnr"])
    host_metrics_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        dev_metrics = compute_metrics(gt, recon, ["mse", "mae", "psnr"])
    dev_metrics_s = time.perf_counter() - t0
    metrics_rel = max(abs(dev_metrics[k] - host_metrics[k])
                      / abs(host_metrics[k]) for k in host_metrics)
    t0 = time.perf_counter()
    codec.reconstruct_raw(rad, sample_posterior=False)
    torch.cuda.synchronize()
    raw_wall_s = time.perf_counter() - t0
    del lat_plain, latent_t
    granule = dict(entry, make_s=make_s, numpy_normalize_s=numpy_s,
                   numpy_normalize_own_stats_s=numpy_own_s,
                   normalize_ms=normalize_ms,
                   normalize_tensor_wall_s=normalize_wall_s,
                   reconstruct_raw_s=raw_wall_s, normalize=norm,
                   normalize_own_stats=norm_own,
                   latent_rel_l2_vs_plain=lat_rel,
                   host_metrics=host_metrics, host_metrics_s=host_metrics_s,
                   device_metrics_s=dev_metrics_s,
                   device_vs_host_metrics_rel=metrics_rel,
                   launches=granule_launches)
    print(f"[analysis] 7c a structured granule {list(ANALYSIS_GRANULE)} "
          f"(made in {make_s:.1f} s on the host) through encode_granule "
          f"with decode_roundtrip, the VAE of 5b's last checkpoint: "
          f"{json.dumps(granule)} (normalize: {ANALYSIS_NORM_ATOL} of "
          f"numpy and no farther from float64 + {ANALYSIS_NORM_F64_SLACK}; "
          f"latent rel L2 {MODEL_BF16_REL_L2}; metrics on the card vs "
          f"numpy rel {ANALYSIS_METRICS_REL}) on {card}", flush=True)
    if not norm_ok:
        fail(f"the device normalize breaks its rule: {norm} {norm_own}")
    f = vcfg.spatial_factor
    if not (lat_rel <= MODEL_BF16_REL_L2 and latent.shape == (
            h // f, w // f, vcfg.embed_dim) and np_all_finite(latent)):
        fail(f"the granule's latent disagrees with the plain path or is "
             f"not finite: rel L2 {lat_rel}, shape {latent.shape}")
    if not (all(math.isfinite(entry[k]) for k in ("mse", "mae", "psnr"))
            and metrics_rel <= ANALYSIS_METRICS_REL):
        fail(f"the granule's metrics are not finite or not numpy's: "
             f"{entry} {host_metrics}")
    seconds["7c"] = time.perf_counter() - t_phase

    # --------------------------------------------------------- (d) PCA-RGB
    t_phase = time.perf_counter()
    samples = extract_pca.sample_pixels(
        gt, ANALYSIS_PCA["pixels_per_file"],
        np.random.default_rng(ANALYSIS_PCA["seed"]))
    fit = fit_pca(samples, ANALYSIS_PCA["n_components"])
    evals = np.linalg.eigvalsh(np.cov(samples.astype(np.float64),
                                      rowvar=False))[::-1][:3]
    pca_rel = float(np.max(np.abs(fit.explained_variance - evals) / evals))
    t0 = time.perf_counter()
    figure = analyze_reconstruction.reconstruction_figure(
        keep / "pca", "granule", gt_host, recon_host, "pca_rgb", fit)
    figure_s = time.perf_counter() - t0
    print(f"[analysis] 7d PCA of {samples.shape[0]} pixels drawn as "
          f"extract_pca draws them: explained variance "
          f"{fit.explained_variance.tolist()} (ratio "
          f"{fit.explained_variance_ratio.tolist()}), vs numpy's eigh rel "
          f"{pca_rel:.3e} (tol {ANALYSIS_PCA_REL}); PCA-RGB figure of the "
          f"granule and its reconstruction {figure.name}: {figure_s:.2f} s, "
          f"a PNG {is_png(figure)}", flush=True)
    if not (pca_rel <= ANALYSIS_PCA_REL and is_png(figure)):
        fail("the PCA disagrees with numpy's eigen-decomposition, or the "
             "PCA-RGB figure was not written")
    del gt, recon, gt_host, recon_host, rad, codec
    torch.cuda.empty_cache()
    seconds["7d"] = time.perf_counter() - t_phase

    # ----------------------------------------------------------- (e) probes
    t_phase = time.perf_counter()
    probe_cfg = ANALYSIS_PROBE
    components = probe_cfg["components"]
    base, base_cfg = build_vae(VAE_MODEL, device=dev, seed=SEED + 5)
    load_params(l2_ckpt, base)
    codec = GranuleCodec(base, multiple=base_cfg.input_size,
                         seed=probe_cfg["seed"], device=dev)
    rng = np.random.default_rng(probe_cfg["seed"])
    make = np.random.default_rng(SEED + 11)
    all_latents = {c: [] for c in components}
    all_targets = {c: [] for c in components}
    raw_samples = {c: None for c in components}
    make_s = encode_s = 0.0
    for i in range(ANALYSIS_PROBE_GRANULES):
        t0 = time.perf_counter()
        rad, fields = structured_granule(make, *ANALYSIS_PROBE_SHAPE)
        # as the L2 files read back: 5% fill values -> NaN, over the scale
        fields = {c: np.where(with_fill_values(make, fields[c], 0.05)
                              < -1e29, np.nan, fields[c])
                  / np.float32(components[c]["scale"]) for c in components}
        make_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if i == 0:
                stack.enter_context(recording(calls, "probe_granule"))
            data = probe_analysis.probe_granule(
                codec, rad, fields, components, base_cfg.spatial_factor,
                probe_cfg["probe"]["n_pixels_per_file"], rng)
        encode_s += time.perf_counter() - t0
        for c, d in data.items():
            all_latents[c].append(d["latents"])
            all_targets[c].append(d["targets"])
            if raw_samples[c] is None:
                raw_samples[c] = d["raw"]
    out = keep / "probes"
    for sub in ("figures", "results", "models", "data_stats"):
        (out / sub).mkdir(parents=True)
    t0 = time.perf_counter()
    probe_analysis.save_data_stat_figures(out / "data_stats", components,
                                          all_targets, all_latents,
                                          raw_samples)
    probes = probe_analysis.fit_probes(out, probe_cfg, all_latents,
                                       all_targets, probe_cfg["seed"], dev)
    probes_s = time.perf_counter() - t0
    curves = {c: np.load(out / "results" / f"training_curves_{c}.npz")[
        "val_losses"] for c in components}
    learned = {c: bool(v.min() < v[0]) for c, v in curves.items()}
    r2 = {c: probes[c]["r2_score"] for c in components if c in probes}
    print(f"[analysis] 7e probe_granule over {ANALYSIS_PROBE_GRANULES} "
          f"structured granules {list(ANALYSIS_PROBE_SHAPE)} encoded by 6c's "
          f"checkpoint ({make_s:.1f} s to make them on the host, "
          f"{encode_s:.2f} s to encode and sample), then a linear probe a "
          f"product ({probes_s:.2f} s, figures included): R^2 "
          f"{json.dumps(r2)}; the best validation loss below the first "
          f"epoch's: {learned}; results {json.dumps(probes)}", flush=True)
    if not (len(r2) == len(components) and all(learned.values())
            and all(math.isfinite(v) for v in r2.values())):
        fail(f"a probe did not learn or its R^2 is not finite: {r2} "
             f"{learned}")
    del base, codec
    seconds["7e"] = time.perf_counter() - t_phase

    # ------------- K1a, K1b, K2 against plain at the path's shapes; rows
    t_phase = time.perf_counter()
    held = hold_kernels(dev, gen, calls)
    for r in held:
        print(f"[kernels] 7 {json.dumps(r)}", flush=True)
    if not held or not all(r["ok"] for r in held):
        fail("a kernel disagrees with its plain version at a shape of the "
             "analysis path")
    for name in counters:
        rows[name]["analysis_launches"] = {
            "sweep_batch16": sweep_launches[name],
            "granule_encode_decode": granule_launches[name]}
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]]
            + [r["max_abs_err"] for r in held if r["kernel"] == name])
        if not (sweep_launches[name] and granule_launches[name]):
            fail(f"{name} was not launched on the analysis path")
    seconds["7 kernels"] = time.perf_counter() - t_phase
    print(f"[time] analysis phases, s: {json.dumps(seconds)}", flush=True)
    return {"card": card, "sweep": {"results": results, "plain": plain,
                                    "rel_vs_plain": sweep_rel,
                                    "seconds": sweep_s,
                                    "patches_per_s": len(ckpts) * n_val
                                    / sweep_s,
                                    "launches_per_batch": sweep_launches},
            "loader_bitwise": {"vae": same_vae, "l2": same_l2,
                               "nested": same_nested},
            "granule": granule, "pca": {"explained_variance":
                                        fit.explained_variance.tolist(),
                                        "rel_vs_eigh": pca_rel},
            "probes": probes, "kernels_held": len(held),
            "seconds": seconds}


def host_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Median host wall of one call, ms, the card synchronised on both
    sides (the time a caller waits, dispatch included)."""
    for _ in range(warmup):
        fn()
    walls = []
    for _ in range(iters):
        walls.append(timed(fn)[1] * 1e3)
    return statistics.median(walls)


def launches_of(fn) -> dict:
    """K1a/K1b/K2 launches of one call of ``fn``."""
    import torch

    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

    counters = {"K1a": (cuda_gn.LAUNCHES, "gn_stats"),
                "K1b": (cuda_gn.LAUNCHES, "gn_apply"),
                "K2": (cuda_gn_conv.LAUNCHES, "gn_act_conv3x3")}
    torch.cuda.synchronize()
    for table, key in counters.values():
        table[key] = 0
    fn()
    torch.cuda.synchronize()
    return {k: table[key] for k, (table, key) in counters.items()}


def exported_child(spec_path: str) -> None:
    """Phase 8a's fresh process: load each artifact directory with
    load_exported (device None), note whether model code was imported, run
    encode at EXPORT_BATCHES; then build the eager model from the
    checkpoint and hold each artifact's encode and decode against it at
    every batch (the decode of the eager latent), count one encode+decode's
    launches at batch 8 and time it and the encode (CUDA events and host
    wall) beside the eager model's (under inference_mode, as the loaded
    functions run), in EXPORT_ROUNDS rotated rounds. Writes the result as
    JSON to the spec's ``out``."""
    import torch

    from tempo_tpu_torch.infer.export_codec import load_exported

    spec = json.loads(Path(spec_path).read_text())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    xs = {b: randn(gen, b, *spec["tile"]) for b in EXPORT_BATCHES}
    loaded, z_exp, result = {}, {}, {}
    for name, path in spec["artifacts"].items():
        (enc, dec, _), load_s = timed(lambda: load_exported(path))
        loaded[name] = (enc, dec)
        z_exp[name] = {b: enc(xs[b]) for b in EXPORT_BATCHES}
        result[name] = {"load_s": load_s}
    result["model_code_imported"] = sorted(
        m for m in sys.modules
        if m.startswith(("tempo_tpu_torch.models", "tempo_tpu_torch.nn"))
        or m.split(".")[0] in ("jax", "jaxlib", "flax", "tempo_tpu"))

    from tempo_tpu_torch.models.vae import build_vae
    from tempo_tpu_torch.train.checkpoint import load_params

    model, _ = build_vae(spec["model"], device=dev, seed=SEED + 12)
    load_params(spec["checkpoint"], model)
    model.eval()

    @torch.inference_mode()
    def eager_encode(x):
        return model.encode(x).mean

    @torch.inference_mode()
    def eager_decode(z):
        return model.decode(z)

    z_eager = {b: eager_encode(xs[b]) for b in EXPORT_BATCHES}
    r_eager = {b: eager_decode(z_eager[b]) for b in EXPORT_BATCHES}
    fns = dict(loaded, eager=(eager_encode, eager_decode))
    result["eager"] = {}
    for name, (enc, dec) in loaded.items():
        per_batch = {}
        for b in EXPORT_BATCHES:
            rec = dec(z_eager[b])
            per_batch[b] = {
                "encode_rel_l2": rel_l2(z_exp[name][b], z_eager[b]),
                "decode_rel_l2": rel_l2(rec, r_eager[b]),
                "bitwise": bitwise((z_exp[name][b], rec),
                                   (z_eager[b], r_eager[b]))}
        result[name]["batches"] = per_batch
    # the times: EXPORT_ROUNDS rounds, each timing every program in a
    # rotated order (host-clock numbers drift within a process)
    names = list(fns)
    times = {name: {} for name in names}
    for r in range(EXPORT_ROUNDS):
        for name in names[r % len(names):] + names[:r % len(names)]:
            enc, dec = fns[name]
            for key, fn in (("encode", lambda: enc(xs[8])),
                            ("encode_decode", lambda: dec(enc(xs[8])))):
                times[name].setdefault(f"{key}_ms_b8", []).append(
                    time_ms(fn, iters=10, warmup=2))
                times[name].setdefault(f"{key}_host_ms_b8", []).append(
                    host_ms(fn, iters=10))
    for name, (enc, dec) in fns.items():
        result[name]["launches_b8"] = launches_of(lambda: dec(enc(xs[8])))
        for key, runs in times[name].items():
            result[name][key] = statistics.median(runs)
            result[name][f"{key}_rounds"] = runs
    Path(spec["out"]).write_text(json.dumps(result))


def exported_on_card_run_on_cpu(dev, keep: Path) -> dict:
    """8a's other direction: a tiny codec (EXPORT_TINY) exported on the
    card, loaded with load_exported(device="cpu") and held against the
    CPU's eager model of the same weights at EXPORT_TINY_BATCHES, within
    EXPORT_CPU_ATOL (max abs)."""
    import torch

    from tempo_tpu_torch.infer.export_codec import export_codec, load_exported
    from tempo_tpu_torch.models.vae import build_vae

    card_model, cfg = build_vae(EXPORT_TINY, device=dev, seed=SEED + 14)
    nudge_zero_init(card_model,
                    torch.Generator(device=dev).manual_seed(SEED + 14))
    cpu_model, _ = build_vae(EXPORT_TINY, device="cpu", seed=SEED + 14)
    cpu_model.load_state_dict(card_model.state_dict())
    path = export_codec(card_model.eval(), keep / "codec_tiny_cuda",
                        tile_hw=(EXPORT_TINY_TILE, EXPORT_TINY_TILE))
    encode, decode, _ = load_exported(path, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 15)
    out = {}
    for b in EXPORT_TINY_BATCHES:
        x = torch.randn((b, EXPORT_TINY_TILE, EXPORT_TINY_TILE,
                         cfg.in_channels), generator=gen)
        with torch.inference_mode():
            z_want = cpu_model.eval().encode(x).mean
            rec_want = cpu_model.decode(z_want)
        z, rec = encode(x), decode(z_want)
        out[b] = {"device": str(z.device),
                  "encode_max_abs": float((z - z_want).abs().max()),
                  "decode_max_abs": float((rec.float()
                                           - rec_want.float()).abs().max()),
                  "bitwise": bitwise((z, rec), (z_want, rec_want))}
    return out


def export_path(dev, rows: dict, keep: Path, ckpt: Path) -> dict:
    """Phase 8a: the flagship codec with ``ckpt``'s weights (5b's) exported
    by infer/export_codec.py on the card and on the CPU, each loaded and
    run in a fresh process (exported_child); the gates: no model code
    imported by the loads, every output within EXPORT_REL_L2 of the eager
    model at every batch, and one exported encode+decode at batch 8
    launching K1a/K1b/K2 as often as the eager one, and not zero times.
    K1a/K1b/K2 are held against their plain versions at every shape the
    eager codec gives them at EXPORT_BATCHES (the exported programs run
    the same ops at the same shapes), and a codec exported on the card
    runs on the CPU (exported_on_card_run_on_cpu). The launches go into
    the kernels' rows."""
    import torch

    from tempo_tpu_torch.infer.export_codec import export_codec
    from tempo_tpu_torch.models.vae import build_vae
    from tempo_tpu_torch.train.checkpoint import load_params

    card = smi_line()
    out = {"card": card}
    artifacts = {}
    for where in ("cuda", "cpu"):
        model, cfg = build_vae(VAE_MODEL, device=where, seed=SEED + 12)
        load_params(ckpt, model)
        model.eval()
        if where == "cuda":
            # the kernels at the shapes of 8a's batches, against plain
            calls = {"K1a": [], "K1b": [], "K2": []}
            gen = torch.Generator(device=dev).manual_seed(SEED + 13)
            with torch.inference_mode(), recording(calls, "export"):
                for b in EXPORT_BATCHES:
                    x = randn(gen, b, cfg.input_size, cfg.input_size,
                              cfg.in_channels)
                    model.decode(model.encode(x).mean)
            held = hold_kernels(dev, gen, calls)
            for r in held:
                print(f"[kernels] 8a {json.dumps(r)}", flush=True)
            if not held or not all(r["ok"] for r in held):
                fail("a kernel disagrees with its plain version at a shape "
                     "of the export path")
            for name in ("K1a", "K1b", "K2"):
                rows[name]["max_abs_err"] = max(
                    [rows[name]["max_abs_err"]]
                    + [r["max_abs_err"] for r in held if r["kernel"] == name])
            out["kernels_held"] = len(held)
        path = keep / f"codec_{where}"
        _, export_s = timed(lambda: export_codec(
            model, path, tile_hw=(cfg.input_size, cfg.input_size)))
        artifacts[f"exported_on_{where}"] = str(path)
        out[f"exported_on_{where}"] = {
            "export_s": export_s,
            "bytes": {p.name: p.stat().st_size for p in path.iterdir()}}
        del model
    spec = {"artifacts": artifacts, "checkpoint": str(ckpt),
            "model": VAE_MODEL, "seed": SEED + 13, "out": str(keep /
                                                             "child.json"),
            "tile": [cfg.input_size, cfg.input_size, cfg.in_channels]}
    (keep / "child_spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.exported_child(sys.argv[1])",
         str(keep / "child_spec.json")],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    out["child_s"] = time.perf_counter() - t0
    if child.returncode:
        fail(f"the exported codec's process failed:\n{child.stdout[-4000:]}"
             f"\n{child.stderr[-8000:]}")
    res = json.loads((keep / "child.json").read_text())
    for name in artifacts:
        out[name].update(res[name])
    out["eager"] = res["eager"]
    out["model_code_imported"] = res["model_code_imported"]
    print(f"[export] 8a the flagship codec (5b's weights, bf16, tile 64x64, "
          f"1028 channels) exported on the card and on the CPU, loaded with "
          f"device None in a fresh process: {json.dumps(out)} (gates: rel "
          f"L2 {EXPORT_REL_L2}, launches equal the eager model's, no model "
          f"code imported by the loads) on {card}", flush=True)
    eager_n = res["eager"]["launches_b8"]
    on_cpu = exported_on_card_run_on_cpu(dev, keep)
    out["exported_on_cuda_run_on_cpu"] = on_cpu
    print(f"[export] 8a a tiny codec ({json.dumps(EXPORT_TINY)}, tile "
          f"{EXPORT_TINY_TILE}) exported on the card, loaded on the CPU, "
          f"against the CPU's eager model: {json.dumps(on_cpu)} (gate: max "
          f"abs {EXPORT_CPU_ATOL})", flush=True)
    for b, r in on_cpu.items():
        if not (r["device"] == "cpu" and r["encode_max_abs"]
                <= EXPORT_CPU_ATOL and r["decode_max_abs"] <= EXPORT_CPU_ATOL):
            fail(f"the codec exported on the card and loaded on the CPU "
                 f"disagrees with the CPU's eager model at batch {b}: {r}")
    if res["model_code_imported"]:
        fail(f"loading the artifacts imported {res['model_code_imported']}")
    for name in artifacts:
        r = res[name]
        worst = max(max(v["encode_rel_l2"], v["decode_rel_l2"])
                    for v in r["batches"].values())
        if not worst <= EXPORT_REL_L2:
            fail(f"{name}: the exported codec is {worst} from the eager "
                 f"model (rel L2)")
        if r["launches_b8"] != eager_n or not all(eager_n.values()):
            fail(f"{name}: launches {r['launches_b8']}, eager {eager_n}")
    for k in eager_n:
        rows[k]["export_launches"] = {
            "exported_encode_decode_b8": res["exported_on_cuda"][
                "launches_b8"][k],
            "exported_on_cpu_encode_decode_b8": res["exported_on_cpu"][
                "launches_b8"][k]}
    return out


def data_prep_path(dev, rad, fields) -> dict:
    """Phase 8b on a granule [131, 2048, 1028] and its products: (i)
    cli/compute_stats.py's per-granule float64 statistics on the card
    against numpy's (count, sum, sumsq), written out here as the JAX CLI
    computes them; (ii) cli/prepare_tiles.py's per-granule work
    (``tile_granule``, what ``process_granule`` runs after reading the
    files) on a device tensor against its numpy path with the same seeded
    Generator, at PREP_TILES; (iii) the tile draws of both paths: positions
    and flags identical, tiles bitwise from the same normalized granule."""
    import numpy as np
    import torch

    from tempo_tpu_torch.cli.compute_stats import log_radiance_sums, spectra
    from tempo_tpu_torch.cli.prepare_tiles import tile_granule
    from tempo_tpu_torch.data.normalize import normalize_l2, normalize_radiance
    from tempo_tpu_torch.data.synthetic import with_fill_values
    from tempo_tpu_torch.data.tiles import extract_tiles_with_positions

    card = smi_line()
    params = PREP_TILES["processing"]
    l2 = PREP_TILES["l2"]
    out = {"card": card, "granule": list(rad.shape)}

    # (i) the statistics
    (n, s, sq), dev_s = timed(lambda: log_radiance_sums(
        torch.from_numpy(rad).to(dev), params["min_radiance"]))
    t0 = time.perf_counter()
    log_rad = np.log(np.clip(rad, params["min_radiance"], None)).astype(
        np.float64)
    flat = log_rad.reshape(-1, log_rad.shape[-1])
    count = flat.shape[0]
    total, total_sq = flat.sum(axis=0), (flat ** 2).sum(axis=0)
    numpy_s = time.perf_counter() - t0
    del log_rad, flat
    mean, std = spectra(n, s.cpu().numpy(), sq.cpu().numpy())
    mean_np, std_np = spectra(count, total, total_sq)
    stats_rel = max(float(np.max(np.abs(mean - mean_np) / np.abs(mean_np))),
                    float(np.max(np.abs(std - std_np) / np.abs(std_np))))
    out["stats"] = {"device_s": dev_s, "numpy_s": numpy_s,
                    "count_equal": n == count, "rel": stats_rel}

    # (ii) tile_granule on the card against its numpy path
    make = np.random.default_rng(SEED + 14)
    l2_fields = {c: np.where(with_fill_values(make, fields[c], 0.05) < -1e29,
                             np.nan, fields[c]) / np.float32(l2["scales"][c])
                 for c in l2["components"]}
    l2_stats = {c: normalize_l2(v[~np.isnan(v)], l2["norm_types"][c])[1]
                for c, v in l2_fields.items()}
    cfg = {"processing": params, "l2": l2}
    res_dev, dev_s = timed(lambda: tile_granule(
        torch.from_numpy(rad).to(dev), l2_fields, cfg, mean, std, l2_stats,
        np.random.default_rng(SEED)))
    t0 = time.perf_counter()
    res_np = tile_granule(rad, l2_fields, cfg, mean, std, l2_stats,
                          np.random.default_rng(SEED))
    numpy_s = time.perf_counter() - t0
    tiles_err = float(np.max(np.abs(res_dev["spectral"] -
                                    res_np["spectral"])))
    l2_same = {c: bool(np.array_equal(res_dev[f"l2_{c}"], res_np[f"l2_{c}"],
                                      equal_nan=True))
               for c in l2["components"]}
    out["tiles"] = {"device_s": dev_s, "numpy_s": numpy_s,
                    "shape": list(res_dev["spectral"].shape),
                    "max_abs_vs_numpy": tiles_err, "l2_bitwise": l2_same}
    del res_dev, res_np

    # (iii) the draws, on one normalized granule
    z = normalize_radiance(torch.from_numpy(rad).to(dev), mean, std,
                           params["min_radiance"], params["clip_min"],
                           params["clip_max"])
    t_dev, pos_dev = extract_tiles_with_positions(
        z, params["tile_size"], params["tiles_per_file"],
        np.random.default_rng(SEED + 15))
    t_np, pos_np = extract_tiles_with_positions(
        z.cpu().numpy(), params["tile_size"], params["tiles_per_file"],
        np.random.default_rng(SEED + 15))
    same_pos = [p.to_dict() for p in pos_dev] == [p.to_dict() for p in pos_np]
    same_tiles = bool(np.array_equal(t_dev.cpu().numpy(), t_np))
    out["draws"] = {"positions_equal": same_pos, "tiles_bitwise": same_tiles,
                    "rotations": sorted({p.rotation for p in pos_dev})}
    del z, t_dev, t_np
    print(f"[prep] 8b compute_stats' statistics and prepare_tiles' "
          f"tile_granule on a granule {list(rad.shape)} with its "
          f"{len(l2_fields)} products (prepare_tiles_with_l2.yaml's values: "
          f"{params['tiles_per_file']} tiles of {params['tile_size']}), the "
          f"card against numpy: {json.dumps(out)} (gates: statistics rel "
          f"{PREP_STATS_REL}, tiles {ANALYSIS_NORM_ATOL} abs, L2 tiles, "
          f"positions and flags exact) on {card}", flush=True)
    if not (out["stats"]["count_equal"] and stats_rel <= PREP_STATS_REL):
        fail(f"the device statistics are not numpy's: {out['stats']}")
    if not (tiles_err <= ANALYSIS_NORM_ATOL and all(l2_same.values())):
        fail(f"the device tiles are not numpy's: {out['tiles']}")
    if not (same_pos and same_tiles):
        fail(f"the device draws are not numpy's: {out['draws']}")
    return out


def kernel_counts() -> dict:
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

    return {"K1a": cuda_gn.LAUNCHES["gn_stats"],
            "K1b": cuda_gn.LAUNCHES["gn_apply"],
            "K2": cuda_gn_conv.LAUNCHES["gn_act_conv3x3"]}


def zero_kernel_counts() -> None:
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

    cuda_gn.LAUNCHES["gn_stats"] = cuda_gn.LAUNCHES["gn_apply"] = 0
    cuda_gn_conv.LAUNCHES["gn_act_conv3x3"] = 0


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (its weight gradients may sum with
    atomics), for steps compared bit for bit."""
    import torch

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def diffusion_cell(label: str, cfg: dict, dev, batch, codecs: list,
                   sampler_s: list, calls: dict, root: Path,
                   card: str) -> tuple:
    """One training cell of phase 11 through cli/train_diffusion.run: the
    files, every loss finite, the panel finite; one more step from the
    reloaded checkpoint bit for bit the live state's; the K1a/K1b/K2
    launches of one step (counters set to 0 before, read after) equal to
    those of one VAE encode plus one network forward alone (their calls
    recorded into ``calls`` by ``recording``, as run ``label``);
    DIFF_TIMED steps timed by CUDA events and one profiled, its busy share
    None where the profile misses a K1a/K1b/K2 launch of the step.
    Returns (its metrics, the Trainer)."""
    import numpy as np
    import torch

    from tempo_tpu_torch.cli import train_diffusion
    from tempo_tpu_torch.train.checkpoint import checkpoint_path
    from tempo_tpu_torch.train.state import (create_train_state,
                                             make_optimizer_from_config)
    from tempo_tpu_torch.train.step import diffusion_loss_fn, flow_loss_fn
    from tempo_tpu_torch.train.trainer import Trainer

    cfg = json.loads(json.dumps(cfg))
    out_dir = root / label
    cfg["output_dir"] = str(out_dir)
    n_codecs = len(codecs)
    (trainer, stats, info), run_s = timed(
        lambda: train_diffusion.run(cfg, device=dev))
    sample_s = sampler_s[-1]
    history = json.loads((out_dir / "metrics.json").read_text())
    losses = [m["loss"] for m in history["train"] + [
        {"loss": v["val_loss"]} for v in history["val"]]]
    samples = np.load(out_dir / "figures" / "samples_final.npy")
    n_steps = cfg["training"]["n_steps"]
    ckpt = checkpoint_path(out_dir / "checkpoints", n_steps)
    family = info["family"]
    want_files = [ckpt, out_dir / "figures" / "samples_final.png",
                  out_dir / "training_info.yaml", out_dir / "summary" /
                  "loss.png"] + ([out_dir / "figures" /
                                  f"reconstructions_step_{n_steps:06d}.png"]
                                 if family == "vdm" else [])
    missing = [str(f.name) for f in want_files if not f.exists()]
    if missing or not history["val"]:
        fail(f"diffusion {label}: missing {missing} or no validation")
    if not (losses and all(math.isfinite(v) for v in losses)):
        fail(f"diffusion {label}: a loss is not finite: {losses}")
    want_shape = (cfg["sampling"]["n_samples"], *DIFF_TILE)
    if samples.shape != want_shape or not np_all_finite(samples):
        fail(f"diffusion {label}: samples {samples.shape} not finite or not "
             f"{want_shape}")

    # one more step from the reloaded checkpoint, bit for bit
    encode_fn = codecs[-1][0] if len(codecs) > n_codecs else None
    model = trainer.state.model
    net = model.velocity_model if family == "sfm" else model.score_model
    loss_of = flow_loss_fn if family == "sfm" else diffusion_loss_fn
    model2, _ = train_diffusion._build_generative(cfg, info["model_shape"],
                                                  dev, SEED + 99)
    tx2 = make_optimizer_from_config(cfg["optimizer"], n_steps=n_steps)
    trainer2 = Trainer(loss_of(model2, encode_fn), tx2,
                       create_train_state(model2, tx2, SEED), root / "resume",
                       device=dev, verbose=False)
    trainer2.load_checkpoint(ckpt)
    with deterministic_cudnn():
        live, _ = trainer.train_step(trainer.state, batch)
        again, _ = trainer2.train_step(trainer2.state, batch)
    same = all(torch.equal(a, b) for a, b in zip(live.model.parameters(),
                                                 again.model.parameters()))
    same &= all(torch.equal(live.ema[k], again.ema[k]) for k in live.ema)
    del trainer2, model2, again
    if not same:
        fail(f"diffusion {label}: a step from the reloaded checkpoint "
             f"differs from the live state's")

    # launches: one encode and one network forward alone, then one step
    gen = torch.Generator(device=dev).manual_seed(SEED)
    alone = {}
    with torch.no_grad(), recording(calls, label):
        zero_kernel_counts()
        z = encode_fn(batch, gen) if encode_fn is not None else batch
        torch.cuda.synchronize()
        alone["encode"] = kernel_counts()
        t = torch.rand((z.shape[0],), generator=gen, device=dev)
        zero_kernel_counts()
        if family == "sfm":
            net(z, t=t, s_conditioning=torch.randn(
                z.shape, generator=gen, device=dev))
        else:
            net(z, t=t)
        torch.cuda.synchronize()
        alone["network"] = kernel_counts()
    zero_kernel_counts()
    trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    per_step = kernel_counts()
    if any(per_step[k] == 0 or per_step[k] != alone["encode"][k]
           + alone["network"][k] for k in per_step):
        fail(f"diffusion {label}: launches a step {per_step} are not one "
             f"encode's plus one forward's {alone}")

    # the step: CUDA events around DIFF_TIMED steps, and one profiled
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(DIFF_TIMED):
        state, metrics = trainer.train_step(trainer.state, batch)
    e1.record()
    torch.cuda.synchronize()
    step_ms = e0.elapsed_time(e1) / DIFF_TIMED
    if not math.isfinite(float(metrics["loss"])):
        fail(f"diffusion {label}: a timed step's loss is not finite")
    def lead_then_step(lead):
        time.sleep(lead)
        trainer.train_step(trainer.state, batch)

    leads = {}
    for lead in DIFF_PROFILE_LEADS_S:
        profile = step_breakdown(lambda: lead_then_step(lead),
                                 VAE_STEP_KINDS, f"diffusion {label}")
        listed = profile and profile["listed"]
        leads[lead] = listed and {
            "K1a": listed["gn_stats_kernel"],
            "K1b": listed["gn_apply_kernel"],
            "K2": listed["conv_bf16"] + listed["conv_f32"]}
        complete = leads[lead] == per_step
        if complete:
            break
    busy = profile["device_ms"] / step_ms if complete else None
    verdict = ("complete" if complete else "it misses device work, so the "
               "busy share is not given")
    print(f"[diffusion] {label}: K1a/K1b/K2 launches the profile lists after "
          f"each lead (s) {leads}, the step's {per_step}: {verdict}",
          flush=True)
    b = batch.shape[0]
    res = {"family": family, "batch": b, "model_shape": info["model_shape"],
           "n_params": info["n_params"], "step_ms": step_ms,
           "samples_per_s": 1e3 * b / step_ms, "device_busy_share": busy,
           "profile": profile, "profile_complete": complete,
           "profile_listed_by_lead_s": leads,
           "sampler_s": sample_s,
           "sampler": f"{cfg['sampling']['n_samples']} samples, "
                      f"{cfg['sampling']['n_steps']} steps, "
                      f"{cfg['sampling'].get('method', 'ancestral')}",
           "cli_s": run_s, "cli_samples_per_s": stats["samples_per_sec"],
           "launches_per_step": per_step, "launches_alone": alone,
           "train": history["train"], "val": history["val"],
           "resume_bitwise": same}
    print(f"[diffusion] {label}: step_ms {step_ms:.3f}, samples_per_s "
          f"{res['samples_per_s']:.1f} (batch {b}, CUDA events over "
          f"{DIFF_TIMED} steps), device busy share {busy}, sampler "
          f"{sample_s:.2f} s ({res['sampler']}), the CLI run {run_s:.1f} s "
          f"({stats['samples_per_sec']:.1f} samples/s host wall), launches "
          f"a step {per_step} = encode {alone['encode']} + network "
          f"{alone['network']}; train {history['train']}, val "
          f"{history['val']}; resumed step bitwise {same} (on {card})",
          flush=True)
    print(f"[diffusion] {label}: one step under torch.profiler: "
          f"{json.dumps(profile)}", flush=True)
    return res, trainer


def diffusion_vs_plain(dev, gen, vae, batch) -> dict:
    """11e: the CUNet forward (latent batch 64, pixel batch 8, and the
    volumetric one at DIFF_VOLUME_SHAPE; fp32, the zero-init convs
    re-drawn) through the kernels against the plain path, the network's
    output less its residual input to MODEL_F32_REL_L2, and K1a/K1b
    launched on the NDHWC volume; one VDM loss and its gradients with
    fixed draws, kernels against plain (DIFF_LOSS_BATCH tiles, the
    tolerances stated at DIFF_LOSS_BATCH)."""
    import torch

    from tempo_tpu_torch.models.diffusion import VDM
    from tempo_tpu_torch.nn.unet import CUNet

    score = DIFF_LATENT["score_model"]

    def cunet(shape):
        net = CUNet(shape=shape, chs=tuple(score["chs"]),
                    norm_groups=score["norm_groups"],
                    n_attention_heads=score["n_attention_heads"],
                    mid_attn=len(shape) == 3, dropout_prob=0.0,
                    t_conditioning=True,
                    t_embedding_dim=score["t_embedding_dim"], device=dev,
                    seed=SEED)
        nudge_zero_init(net, gen)
        return net

    forward, launches = {}, {}
    for label, shape, b in (("latent", DIFF_LATENT_SHAPE, 64),
                            ("pixel", DIFF_TILE, 8),
                            ("volume", DIFF_VOLUME_SHAPE, DIFF_VOLUME_BATCH)):
        net = cunet(shape)
        x = randn(gen, b, *shape)
        t = torch.rand((b,), generator=gen, device=dev)
        with torch.no_grad():
            zero_kernel_counts()
            got = net(x, t=t) - x
            torch.cuda.synchronize()
            launches[label] = kernel_counts()
            with plain_kernels():
                want = net(x, t=t) - x
        forward[label] = rel_l2(got, want)
        del net, x, got, want
    torch.cuda.empty_cache()

    vdm = VDM(cunet(DIFF_LATENT_SHAPE), seed=SEED)
    x = batch[:DIFF_LOSS_BATCH]
    zshape = (x.shape[0], *DIFF_LATENT_SHAPE)
    post_noise, noise, noise_0 = (randn(gen, *zshape) for _ in range(3))
    times = (torch.rand((), generator=gen, device=dev)
             + torch.arange(x.shape[0], device=dev)) / x.shape[0]

    def encode():
        with torch.no_grad():
            post = vae.encode(x)
            return post.mean + post.std * post_noise

    def loss_and_grads(z):
        vdm.zero_grad(set_to_none=True)
        loss, _ = vdm.get_loss(z, noise=noise, times=times, noise_0=noise_0)
        loss.backward()
        return loss.item(), {k: p.grad.clone()
                             for k, p in vdm.named_parameters()}

    def compare(a, b):
        (la, ga), (lb, gb) = a, b
        rels = {k: rel_l2(ga[k], gb[k]) for k in gb
                if not k.endswith("mid_attn1.k.bias")}
        worst = max(rels, key=rels.get)
        key_bias = max(float(ga[k].abs().max()) for k in ga
                       if k.endswith("mid_attn1.k.bias"))
        return {"loss": la, "loss_plain": lb, "loss_rel": abs(la - lb)
                / abs(lb), "max_grad_rel_l2": rels[worst],
                "worst": worst, "attn_k_bias_grad_max": key_bias}

    z = encode()
    kernel_run = loss_and_grads(z)
    with plain_kernels():
        z_plain = encode()
        same_z = loss_and_grads(z)
        whole_plain = loss_and_grads(z_plain)
    res = {"forward_rel_l2": forward, "forward_launches": launches,
           "latents_rel_l2": rel_l2(z, z_plain),
           "same_latents": compare(kernel_run, same_z),
           "whole": compare(kernel_run, whole_plain)}
    print(f"[diffusion] 11e vs plain: {json.dumps(res)} (tol: forward "
          f"{MODEL_F32_REL_L2}, latents {MODEL_BF16_REL_L2}, same latents "
          f"{STEP_F32_TOL}, whole {STEP_BF16_TOL})", flush=True)
    if not all(v <= MODEL_F32_REL_L2 for v in forward.values()):
        fail("the CUNet forward through the kernels disagrees with the "
             "plain path")
    if not (launches["volume"]["K1a"] and launches["volume"]["K1b"]
            and not launches["volume"]["K2"]):
        fail(f"the volumetric CUNet did not run K1 alone on NDHWC: "
             f"{launches['volume']}")
    if not res["latents_rel_l2"] <= MODEL_BF16_REL_L2:
        fail("the bf16 encode's latents disagree with the plain path")
    for key, tol in (("same_latents", STEP_F32_TOL),
                     ("whole", STEP_BF16_TOL)):
        r = res[key]
        if not (r["loss_rel"] <= tol["loss"]
                and r["max_grad_rel_l2"] <= tol["grad"]):
            fail(f"the VDM loss or gradients ({key}) disagree with the "
                 f"plain path")
    return res


def diffusion_path(dev, rows: dict) -> dict:
    """Phase 11, the diffusion path: (a) latent VDM and (b) latent SFM
    through cli/train_diffusion.run with the repo's configs' values, (c)
    pixel-space VDM, each a diffusion_cell; (d) cli/sample_diffusion.run
    over (a)'s run, DDIM (eta 0) and ancestral, and (b)'s flow integrated
    with 'lm'; (e) each recorded K1a/K1b/K2 call and the whole CUNet and
    VDM loss against the plain versions. Adds each kernel's launches a
    latent VDM step and its diffusion shapes to its row."""
    import numpy as np
    import torch

    from tempo_tpu_torch.cli import sample_diffusion, train_diffusion
    from tempo_tpu_torch.data.loader import TileLoader
    from tempo_tpu_torch.data.synthetic import make_tile_shards
    from tempo_tpu_torch.models.vae import build_vae
    from tempo_tpu_torch.train.trainer import to_device

    seconds, res, card = {}, {}, smi_line()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    codecs, sampler_s = [], []
    build, make = train_diffusion._build_codec, train_diffusion._make_sampler

    def build_codec(*args):
        codecs.append(build(*args))
        return codecs[-1]

    def make_sampler(*args, **kwargs):
        fn = make(*args, **kwargs)

        def timed_sampler(generator):
            samples, dt = timed(lambda: fn(generator))
            sampler_s.append(dt)
            return samples

        return timed_sampler

    train_diffusion._build_codec = build_codec
    train_diffusion._make_sampler = make_sampler
    sample_diffusion._build_codec = build_codec
    sample_diffusion._make_sampler = make_sampler
    try:
        t_phase = time.perf_counter()
        shards = make_tile_shards(root / "tiles", n_files=DIFF_SHARDS,
                                  tiles_per_file=DIFF_TILES,
                                  tile=DIFF_TILE[0],
                                  n_spectral=DIFF_TILE[2], seed=SEED,
                                  dtype=np.float16)
        vae, _ = build_vae(DIFF_VAE, device=dev, seed=SEED)
        nudge_zero_init(vae, torch.Generator(device=dev).manual_seed(SEED))
        torch.save({"model": vae.state_dict()}, root / "vae.pt")
        del vae
        loader = TileLoader(shards, batch_size=64, min_buffer_size=64,
                            seed=SEED)
        try:
            batch = to_device(next(loader), dev)
        finally:
            loader.close()
        data = {"train_dir": str(shards), "val_dir": str(shards)}
        seconds["setup"] = time.perf_counter() - t_phase

        # the kernels' calls of 11a's and 11c's steps, held in 11e (11b's
        # are 11a's)
        calls = {"K1a": [], "K1b": [], "K2": []}
        for label, cfg, b in (("11a_vdm", DIFF_LATENT, 64),
                              ("11b_sfm", DIFF_FLOW, 64),
                              ("11c_pixel", DIFF_PIXEL, 8)):
            t_phase = time.perf_counter()
            cfg = json.loads(json.dumps(cfg))
            cfg["data"].update(data)
            if "latent" in cfg:
                cfg["latent"]["vae_checkpoint"] = str(root / "vae.pt")
            res[label], trainer = diffusion_cell(
                label, cfg, dev, batch[:b], codecs, sampler_s,
                calls if label != "11b_sfm" else {
                    "K1a": [], "K1b": [], "K2": []}, root, card)
            if label == "11b_sfm":
                # the same flow integrated with Leimkuhler-Matthews
                n, steps = (DIFF_FLOW["sampling"][k]
                            for k in ("n_samples", "n_steps"))
                lm = make_sampler(trainer.state.model, "sfm",
                                  DIFF_LATENT_SHAPE, n, steps,
                                  decode_fn=codecs[-1][1], method="lm")
                samples = lm(torch.Generator(device=dev).manual_seed(SEED))
                res[label]["lm_sampler_s"] = sampler_s[-1]
                if not torch_all_finite(samples):
                    fail("diffusion 11b: the lm samples are not finite")
                print(f"[diffusion] 11b_sfm: the lm integrator, {n} samples "
                      f"over {steps} steps: {sampler_s[-1]:.2f} s",
                      flush=True)
            del trainer
            torch.cuda.empty_cache()
            seconds[label] = time.perf_counter() - t_phase

        # 11d: the sampling CLI over 11a's run, DDIM eta 0 and ancestral
        t_phase = time.perf_counter()
        res["11d_sample"] = {}
        for method in ("ddim", "ancestral"):
            cfg = dict(DIFF_SAMPLE, run_dir=str(root / "11a_vdm"),
                       output_dir=str(root / f"samples_{method}"),
                       method=method, eta=0.0)
            info, run_s = timed(lambda: sample_diffusion.run(cfg,
                                                             device=dev))
            samples = np.load(root / f"samples_{method}" / "samples.npy")
            ok = (samples.shape == (DIFF_SAMPLE["n_samples"], *DIFF_TILE)
                  and np_all_finite(samples)
                  and (root / f"samples_{method}" / "samples.png").exists()
                  and (root / f"samples_{method}" /
                       "sampling_info.yaml").exists())
            res["11d_sample"][method] = {"cli_s": run_s,
                                         "sampler_s": sampler_s[-1],
                                         "shape": list(samples.shape),
                                         "ok": ok, "info": info}
            print(f"[diffusion] 11d sample_diffusion {method}: "
                  f"{DIFF_SAMPLE['n_samples']} samples over "
                  f"{DIFF_SAMPLE['n_steps']} steps, sampler "
                  f"{sampler_s[-1]:.2f} s (incl. the decode), the CLI "
                  f"{run_s:.2f} s; ok {ok}", flush=True)
            if not ok:
                fail(f"sample_diffusion {method}: {samples.shape} not "
                     f"finite or files missing")
        seconds["11d"] = time.perf_counter() - t_phase

        # 11e: against the plain versions
        t_phase = time.perf_counter()
        vae = codecs[0][3]
        res["11e_vs_plain"] = diffusion_vs_plain(dev, gen, vae, batch)
        held = {"K1a": [], "K1b": [], "K2": []}

        def keep(name, info, n, err, ok, ms, plain_ms, bound_ms, bound_by,
                 library_ms, extra):
            held[name].append(dict(
                info, calls=n, max_abs_err=err, ok=ok, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **extra))

        held_ok = hold_recorded(
            dev, gen, {k: count_calls(v) for k, v in calls.items()}, keep)
        for name, shapes in held.items():
            for sh in shapes:
                print(f"[kernels] diffusion {name} {json.dumps(sh)}",
                      flush=True)
        if not held_ok:
            fail("on the diffusion path a kernel disagrees with its plain "
                 "version beyond tolerance")
        per_step = res["11a_vdm"]["launches_per_step"]
        for name in ("K1a", "K1b", "K2"):
            runs = {}
            for sh in held[name]:
                for run, n in sh["calls"].items():
                    r = runs.setdefault(f"{sh['dtype']} {run}", {"calls": 0})
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                "library_conv_ms", "k1_whole_ms",
                                "whole_ms"):
                        if key in sh:
                            r[key] = r.get(key, 0.0) + n * sh[key]
                    r["calls"] += n
            rows[name]["diffusion"] = {
                "launches_per_step": per_step[name],
                "per": "by type and run: one latent VDM train step at "
                       "batch 64 (11a_vdm: one bf16 VAE encode + one fp32 "
                       "CUNet forward) and one pixel-space forward at batch "
                       "8 (11c_pixel): sums over their calls, each timed "
                       "alone with a cold L2 (each shape on its [kernels] "
                       "diffusion line)",
                "by_run": runs}
        seconds["11e"] = time.perf_counter() - t_phase
    finally:
        train_diffusion._build_codec, train_diffusion._make_sampler = (
            build, make)
        sample_diffusion._build_codec = build
        sample_diffusion._make_sampler = make
        tmp.cleanup()
    res["seconds"] = seconds
    print(f"[diffusion] phase 11 seconds: {json.dumps(seconds)} (on "
          f"{card})", flush=True)
    return res


def options_child(spec_path: str) -> None:
    """Phase 12a's fresh process: cli/train_vae.run with every option
    (OPTS). The K1a/K1b/K2 counters are set to 0 before the run and read
    after it, and set to 0 where the profile window starts and read where
    it stops (wrapping Trainer._start_profile / _stop_profile); a sink
    stamps the host clock at every record. Then the trace's K1a/K1b/K2
    kernels, one training forward's launches at the run's batch, the
    JSONL records against metrics.json, and the last checkpoint against
    the trainer's final state, bit for bit. Writes the result as JSON to
    the spec's ``out``."""
    import torch

    from tempo_tpu_torch.cli import train_vae
    from tempo_tpu_torch.train.trainer import Trainer

    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["run"])
    window, stamps, clock = {}, [], {}
    start, stop = Trainer._start_profile, Trainer._stop_profile

    def counted_start(self):
        torch.cuda.synchronize()
        zero_kernel_counts()
        clock["opened"] = time.perf_counter()
        start(self)

    def counted_stop(self):
        torch.cuda.synchronize()
        window.update(kernel_counts())
        clock["closing"] = time.perf_counter()
        stop(self)  # stops the profiler and writes the trace
        clock["closed"] = time.perf_counter()

    sinks = train_vae._metric_sinks
    Trainer._start_profile, Trainer._stop_profile = counted_start, counted_stop
    Trainer.n_val_batches = OPTS["n_val"]
    train_vae._metric_sinks = lambda *a: sinks(*a) + [
        lambda step, metrics, kind: stamps.append(
            (step, kind, time.perf_counter()))]
    cfg = {"output_dir": str(out), "seed": SEED,
           "data": {"train_dir": spec["shards"], "val_dir": spec["shards"],
                    "batch_size": OPTS["batch"],
                    "min_buffer_size": VAE_BUFFER,
                    "val_min_buffer_size": OPTS["batch"]},
           "model": VAE_MODEL,
           "optimizer": {"lr": 1e-4, "betas": [0.9, 0.95],
                         "weight_decay": 0.05},
           "training": {"n_steps": OPTS["steps"],
                        "save_every": OPTS["save_every"],
                        "val_every": OPTS["val_every"], "log_every": 1,
                        "plot_every": 100, "metrics_jsonl": True,
                        "profile_steps": OPTS["profile"],
                        "checkpoint_format": "async"}}
    torch.cuda.synchronize()
    zero_kernel_counts()
    t0 = time.perf_counter()
    trainer, stats = train_vae.run(cfg, device=spec["device"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_counts()

    trace = out / "profile" / "trace_steps_{}-{}.json".format(
        *OPTS["profile"])
    listed = dict.fromkeys(("K1a", "K1b", "K2"), 0)
    names = {"K1a": ("gn_stats_kernel",), "K1b": ("gn_apply_kernel",),
             "K2": ("conv_bf16", "conv_f32")}
    for ev in json.loads(trace.read_text())["traceEvents"]:
        if ev.get("cat") == "kernel":
            for k, keys in names.items():
                listed[k] += any(key in ev.get("name", "") for key in keys)
    model = trainer.state.model
    x = torch.randn((OPTS["batch"], *model.config.shape[1:],
                     model.config.shape[0]), device=spec["device"])
    with torch.no_grad():
        per_forward = launches_of(lambda: model.get_loss(
            x, torch.Generator(device=spec["device"]).manual_seed(0)))

    hist = json.loads((out / "metrics.json").read_text())
    records = [json.loads(line) for line in
               (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    jsonl_is_history = all(
        [{k: v for k, v in r.items() if k != "kind"} for r in records
         if r["kind"] == kind] == hist[kind] for kind in ("train", "val"))
    ckpts = sorted(p.name for p in (out / "checkpoints").glob("*.pt"))
    raw = torch.load(out / "checkpoints" / ckpts[-1], map_location="cpu",
                     weights_only=True)
    live_opt = trainer.state.optimizer.state_dict()["state"]
    reload_bitwise = (
        raw["step"] == trainer.state.step
        and all(torch.equal(raw["model"][k], v.cpu())
                for k, v in model.state_dict().items())
        and all(torch.equal(raw["optimizer"]["state"][i][k], v.cpu())
                for i, st in live_opt.items() for k, v in st.items()))
    train_t = [t for _, kind, t in stamps if kind == "train"]
    Path(spec["out"]).write_text(json.dumps({
        "run_s": run_s, "samples_per_sec": stats["samples_per_sec"],
        "launches": launches, "window_launches": window,
        "trace_listed": listed, "per_forward": per_forward,
        "trace_bytes": trace.stat().st_size,
        "step_host_ms": [1e3 * (b - a) for a, b in zip(train_t,
                                                       train_t[1:])],
        "window_s": clock["closing"] - clock["opened"],
        "trace_stop_and_write_s": clock["closed"] - clock["closing"],
        "jsonl_records": [[r["step"], r["kind"]] for r in records],
        "jsonl_is_history": jsonl_is_history, "checkpoints": ckpts,
        "reload_bitwise": reload_bitwise}))


class Bf16(tuple):
    """A bfloat16 array for ``pack_flax``, as its uint16 bits (numpy on the
    card has no bfloat16)."""


def pack_flax(obj) -> bytes:
    """msgpack of ``obj`` as flax.serialization.msgpack_serialize lays a
    checkpoint out: dicts, lists, str, int, float, bool, None, bytes, and
    numpy arrays (and ``Bf16((shape, bits))``) as flax's ext 1, the nested
    (shape, dtype name, C-order bytes). The port only reads this format;
    this writer is phase 12c's, to make a file to read on the card."""
    import struct

    import numpy as np

    out = []

    def head(n, fix, fix_max, codes):
        if fix is not None and n <= fix_max:
            out.append(bytes([fix | n]))
            return
        for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                    (0xFF, 0xFFFF, 0xFFFFFFFF)):
            if code is not None and n <= limit:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return

    def ext(payload):
        head(len(payload), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(b"\x01")  # flax's ndarray code
        out.append(payload)

    def one(v):
        if v is None or isinstance(v, bool):
            out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[v])
        elif isinstance(v, int):
            out.append(bytes([v]) if 0 <= v < 128 else
                       b"\xcf" + struct.pack(">Q", v) if v >= 0 else
                       b"\xd3" + struct.pack(">q", v))
        elif isinstance(v, float):
            out.append(b"\xcb" + struct.pack(">d", v))
        elif isinstance(v, str):
            data = v.encode()
            head(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            out.append(data)
        elif isinstance(v, bytes):
            head(len(v), None, 0, (0xC4, 0xC5, 0xC6))
            out.append(v)
        elif isinstance(v, Bf16):
            ext(pack_flax([list(v[0]), "bfloat16", v[1].tobytes()]))
        elif isinstance(v, np.ndarray):
            ext(pack_flax([list(v.shape), v.dtype.name, v.tobytes("C")]))
        elif isinstance(v, list):
            head(len(v), 0x90, 15, (None, 0xDC, 0xDD))
            for item in v:
                one(item)
        elif isinstance(v, dict):
            head(len(v), 0x80, 15, (None, 0xDE, 0xDF))
            for k, item in v.items():
                one(k)
                one(item)
        else:
            raise TypeError(f"pack_flax: {type(v).__name__}")

    one(obj)
    return b"".join(out)


def options_path(dev, root: Path) -> dict:
    """Phase 12: (a) cli/train_vae.run with every option in a fresh
    process (options_child): the trace holds exactly the K1a/K1b/K2
    launches counted in the window, those of 2 train steps and one
    validation's OPTS["n_val"] forwards; the JSONL records are the
    metrics.json history; the checkpoints of steps 2, 4 and 6 are there
    and the last reloads bit for bit; (b) the in-place race at batch 64: a
    sync and an async checkpoint of one state, a train step run while the
    async one is written, the files' tensors equal bit for bit and unlike
    the state after the step, the blocking times; (c) the flagship state
    dict, a bfloat16 leaf, scalars, an empty dict and a chunked leaf packed
    as flax does, read back by interop/msgpack_reader.py bit for bit (the
    bfloat16 widened exactly), its MB/s."""
    import numpy as np
    import torch

    from tempo_tpu_torch.data.synthetic import make_tile_shards
    from tempo_tpu_torch.interop import msgpack_reader
    from tempo_tpu_torch.models.vae import VAEConfig, build_vae
    from tempo_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                                  save_checkpoint)
    from tempo_tpu_torch.train.state import (create_train_state,
                                             make_optimizer)
    from tempo_tpu_torch.train.step import make_train_step, vae_loss_fn

    card = smi_line()
    seconds, result = {}, {"card": card}

    # ------------------------------------ (a) the CLI with every option
    t_phase = time.perf_counter()
    c, h, w = VAEConfig.from_dict(VAE_MODEL).shape
    shards = make_tile_shards(root / "tiles", n_files=VAE_SHARDS,
                              tiles_per_file=VAE_TILES_PER_SHARD, tile=h,
                              n_spectral=c, seed=SEED, dtype=np.float16)
    spec = {"shards": str(shards), "run": str(root / "run"),
            "out": str(root / "child.json"), "device": str(dev)}
    (root / "spec.json").write_text(json.dumps(spec))
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.options_child(sys.argv[1])", str(root / "spec.json")],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    if child.returncode:
        fail(f"12a's train_vae process failed:\n{child.stdout[-4000:]}\n"
             f"{child.stderr[-8000:]}")
    a = json.loads((root / "child.json").read_text())
    window_steps = 2 + OPTS["n_val"]  # steps 3, 4 and step 3's validation
    expected = {k: window_steps * n for k, n in a["per_forward"].items()}
    want_ckpts = [f"ckpt_step={s:06d}.pt"
                  for s in range(2, OPTS["steps"] + 1, 2)]
    print(f"[options] 12a train_vae.run, the flagship bf16 at batch "
          f"{OPTS['batch']}, {OPTS['steps']} steps, metrics_jsonl, "
          f"profile_steps {OPTS['profile']}, async checkpoints, in a fresh "
          f"process: {json.dumps(a)}; expected in the window "
          f"{window_steps} x one forward's {a['per_forward']} = {expected} "
          f"on {card}", flush=True)
    if a["trace_listed"] != a["window_launches"] or \
            a["window_launches"] != expected:
        fail(f"12a's trace lists {a['trace_listed']} K1a/K1b/K2 kernels, "
             f"the window counted {a['window_launches']}, expected "
             f"{expected}")
    if not all(a["launches"].values()):
        fail(f"12a's run launched a kernel no time: {a['launches']}")
    if not (a["jsonl_is_history"] and a["reload_bitwise"]
            and a["checkpoints"] == want_ckpts):
        fail("12a: the JSONL records are not the metrics.json history, or "
             "the checkpoints are not there or do not reload bit for bit")
    result["cli"] = a
    seconds["12a"] = time.perf_counter() - t_phase

    # --------------------------------- (b) the in-place race at batch 64
    t_phase = time.perf_counter()
    model, _ = build_vae(VAE_MODEL, device=dev, seed=SEED)
    nudge_zero_init(model, torch.Generator(device=dev).manual_seed(SEED))
    tx = make_optimizer(lr=1e-4, betas=(0.9, 0.95), weight_decay=0.05)
    state = create_train_state(model, tx, SEED)
    state.ema = {}
    step = make_train_step(vae_loss_fn(model), tx)
    batch = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (VAE_TRAIN_BATCH, h, w, c), dtype=np.float32)).to(dev)

    def timed_step():
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    for _ in range(2):
        timed_step()
    saver = AsyncCheckpointer()
    rounds = []
    for r in range(OPTS["rounds"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sync_path = save_checkpoint(root / f"sync{r}", state)
        sync_s = time.perf_counter() - t
        t = time.perf_counter()
        async_path = saver.save(root / f"async{r}", state)
        block_s = time.perf_counter() - t
        step_under_write_ms = timed_step()
        saver.wait()
        done_s = time.perf_counter() - t
        rounds.append({"sync_save_s": sync_s, "async_save_block_s": block_s,
                       "async_write_done_s": done_s,
                       "step_under_write_ms": step_under_write_ms,
                       "step_ms": timed_step(),
                       "bytes": async_path.stat().st_size})
        if r:
            continue
        a_raw = torch.load(async_path, map_location="cpu", weights_only=True)
        s_raw = torch.load(sync_path, map_location="cpu", weights_only=True)
        after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        moments = state.optimizer.state_dict()["state"]
        same = (a_raw["step"] == s_raw["step"]
                and all(torch.equal(a_raw["model"][k], v)
                        for k, v in s_raw["model"].items())
                and all(torch.equal(a_raw["optimizer"]["state"][i][k], v)
                        for i, st in s_raw["optimizer"]["state"].items()
                        for k, v in st.items()))
        moved = (not all(torch.equal(s_raw["model"][k], v)
                         for k, v in after.items())
                 and not all(torch.equal(s_raw["optimizer"]["state"][i][k],
                                         v.cpu())
                             for i, st in moments.items()
                             for k, v in st.items() if k != "step"))
        result["race"] = {"files_bitwise": same,
                          "file_bytes_equal": (async_path.read_bytes()
                                               == sync_path.read_bytes()),
                          "post_step_state_differs": moved,
                          "tensors": len(s_raw["model"])}
        del a_raw, s_raw, after
    saver.close()
    # the first async save allocates the pinned buffers the others reuse
    med = {k: statistics.median(r[k] for r in rounds[1:])
           for k in rounds[0]}
    result["race"].update(rounds=rounds, median=med,
                          d2h_gb_per_s=med["bytes"] / med[
                              "async_save_block_s"] / 1e9)
    print(f"[options] 12b checkpoints of the flagship's state at batch "
          f"{VAE_TRAIN_BATCH} ({med['bytes'] / 1e6:.1f} MB), "
          f"{OPTS['rounds']} rounds: sync save {med['sync_save_s']:.3f} s, "
          f"async save() blocks {1e3 * med['async_save_block_s']:.1f} ms "
          f"(the first, allocating its pinned buffers, "
          f"{1e3 * rounds[0]['async_save_block_s']:.1f} ms) "
          f"({result['race']['d2h_gb_per_s']:.2f} GB/s to the host), its "
          f"write done {med['async_write_done_s']:.3f} s after, a step "
          f"under the write {med['step_under_write_ms']:.1f} ms vs "
          f"{med['step_ms']:.1f} ms alone (medians of the later rounds); "
          f"{json.dumps(result['race'])} on {card}", flush=True)
    if not (result["race"]["files_bitwise"]
            and result["race"]["file_bytes_equal"]
            and result["race"]["post_step_state_differs"]):
        fail(f"12b: the async checkpoint is not the sync one, or the step "
             f"under the write did not move the state: {result['race']}")
    seconds["12b"] = time.perf_counter() - t_phase

    # --------------------------------------- (c) the reader on the card
    t_phase = time.perf_counter()
    params = {k: v.detach().cpu().numpy() for k, v in
              model.state_dict().items()}
    del state, step, batch, model
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    bits = rng.integers(0, 1 << 16, (64, 33), dtype=np.uint16)
    flat = rng.standard_normal(3000).astype(np.float32)
    tree = {"step": 6, "params": params, "lr": 1e-4, "count": 7,
            "note": "ckpt_step=000006", "empty": {},
            "bf16": Bf16(((64, 33), bits)),
            "chunked": {"__msgpack_chunked_array__": True,
                        "shape": {"0": 3, "1": 1000},
                        "chunks": {"0": flat[:1700], "1": flat[1700:]}}}
    path = root / "ckpt_step=000006.msgpack"
    path.write_bytes(pack_flax(tree))
    t = time.perf_counter()
    got = msgpack_reader.read(path)
    read_s = time.perf_counter() - t
    widened = (bits.astype(np.uint32) << 16).view(np.float32)
    same = (got["params"].keys() == params.keys()
            and all(got["params"][k].dtype == v.dtype
                    and got["params"][k].shape == v.shape
                    and got["params"][k].tobytes() == v.tobytes()
                    for k, v in params.items())
            and got["bf16"].dtype == np.float32
            and got["bf16"].tobytes() == widened.tobytes()
            and got["chunked"].tobytes() == flat.reshape(3, 1000).tobytes()
            and (got["step"], got["lr"], got["count"], got["note"],
                 got["empty"]) == (6, 1e-4, 7, "ckpt_step=000006", {}))
    size = path.stat().st_size
    result["reader"] = {"bytes": size, "leaves": len(params) + 7,
                        "read_s": read_s, "mb_per_s": size / read_s / 1e6,
                        "bitwise": same}
    print(f"[options] 12c interop/msgpack_reader.py on a flax-layout file of "
          f"the flagship's {len(params)} state-dict tensors + a bfloat16 "
          f"leaf, scalars, an empty dict and a chunked leaf: "
          f"{json.dumps(result['reader'])} (the file just written: a warm "
          f"read) on {card}", flush=True)
    if not same:
        fail("12c: the reader's tree is not what was packed")
    seconds["12c"] = time.perf_counter() - t_phase
    result["seconds"] = seconds
    return result


class Timed:
    """A loader, with the host's wait on each batch summed."""

    def __init__(self, it):
        self.it, self.wait_s = it, 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        try:
            return next(self.it)
        finally:
            self.wait_s += time.perf_counter() - t

    def close(self) -> None:
        self.it.close()


def randn(gen, *shape, dtype=None, scale=1.0):
    """scale * N(0, 1) of ``shape`` on ``gen``'s device, then in
    ``dtype`` (fp32 when None)."""
    import torch

    t = scale * torch.randn(shape, generator=gen, device=gen.device)
    return t if dtype is None else t.to(dtype)


def check_bwd(gen, fn, plain, inputs, out_shape, name) -> dict:
    """An autograd Function's gradients against autograd through the plain
    chain from the same inputs and output gradient."""
    import torch

    inputs = [t.requires_grad_() for t in inputs]
    out = fn(*inputs)
    g = randn(gen, *out_shape, dtype=out.dtype)
    got = torch.autograd.grad(out, inputs, g)
    want = torch.autograd.grad(plain(*inputs), inputs, g)
    return {"fn": type(out.grad_fn).__name__ == name,
            "rel_l2": max(rel_l2(a, b) for a, b in zip(got, want)),
            "bitwise": all(torch.equal(a, b) for a, b in zip(got, want))}


def check_k1_bwd(gen, shape, groups, eps, act) -> dict:
    """check_bwd of GroupNormActFn (K1 forward, plain recompute backward)
    on a bf16 x of ``shape``."""
    import torch

    from tempo_tpu_torch.ops import cuda_gn
    from tempo_tpu_torch.ops.norms import group_norm

    cc = shape[-1]
    return check_bwd(
        gen,
        lambda x, s_, b_: cuda_gn.fused_group_norm_act(x, s_, b_, groups,
                                                       eps, act),
        lambda x, s_, b_: group_norm(x, groups, s_, b_, eps, act),
        [randn(gen, *shape, dtype=torch.bfloat16),
         1 + randn(gen, cc, scale=0.1), randn(gen, cc, scale=0.1)], shape,
        "GroupNormActFnBackward")


def nudge_zero_init(model, generator) -> None:
    """Random weights in place of the zero-initialized output convs, so the
    reconstruction depends on every layer."""
    import torch

    with torch.no_grad():
        for p in model.parameters():
            if p.ndim and not p.any():
                fan_in = math.prod(p.shape[1:]) if p.ndim > 1 else 512
                bound = 1.0 / math.sqrt(fan_in)
                p.uniform_(-bound, bound, generator=generator)


# ------------------------------------------------------------------------
# Phase 13: the GPT family's options (MoE, int8, beam search, LoRA,
# dropout, bf16 first moments) at GPT-2-small's widths.

def opt_config(**kw):
    """GPT-2-small (TransformerConfig's defaults, OPT_MODEL's overrides) in
    bf16 with the options ``kw``."""
    from tempo_tpu_torch.nn.transformer import TransformerConfig

    return TransformerConfig(**dict({"compute_dtype": "bfloat16"},
                                    **OPT_MODEL, **kw))


def count_decode(fn):
    """(fn(), K3 launches, K4 launches), the counters set to 0 just before
    and read just after (the card synchronised)."""
    import torch

    from tempo_tpu_torch.ops import cuda_decode

    for key in ("decode_attention", "paged_decode_attention"):
        cuda_decode.LAUNCHES[key] = 0
    out = fn()
    torch.cuda.synchronize()
    return (out, cuda_decode.LAUNCHES["decode_attention"],
            cuda_decode.LAUNCHES["paged_decode_attention"])


def count_flash(fn):
    """(fn(), {K5f, K5dkv, K5dq launches}), counted as count_decode."""
    import torch

    from tempo_tpu_torch.ops import flash_attention as fa

    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"K5f": fa.LAUNCHES["flash_fwd"],
                 "K5dkv": fa.LAUNCHES["flash_bwd_dkv"],
                 "K5dq": fa.LAUNCHES["flash_bwd_dq"]}


def opt_generate(model, prompt, tag: str) -> dict:
    """generate at 3a's shape, captured: K3 counted (n_layer x (LM_NEW - 1)),
    bitwise the eager loop, timed (host wall of a warm run)."""
    import torch

    from tempo_tpu_torch.nn.transformer import _generate_eager, generate

    def run(fn=generate):
        return fn(model, prompt, LM_NEW, temperature=0.0,
                  cache_dtype=torch.bfloat16, cache_len=LM_CACHE)

    out, k3, _ = count_decode(run)
    want = model.config.n_layer * (LM_NEW - 1)
    if k3 != want:
        fail(f"{tag}: K3 launched {k3} times in generate, want {want}")
    if not torch.equal(out, run(_generate_eager)):
        fail(f"{tag}: captured generate differs from the eager loop")
    _, dt = timed(run)
    return {"k3_launches": k3, "bitwise_eager": True,
            "ms_per_token": 1e3 * dt / LM_NEW,
            "tokens_per_s": LM_BATCH * LM_NEW / dt, "tokens": out}


def paged_serve(surface, reqs, dev):
    from tempo_tpu_torch.infer.paged import PagedLMServer

    srv = PagedLMServer(surface=surface, n_slots=LM_SLOTS,
                        n_pages=LM_POOLS["roomy"], k_decode=LM_K,
                        prefill_chunk=LM_CHUNK, device=dev)
    resp = srv.serve(reqs)
    return [r["tokens"] for r in resp], dict(srv.last_stats)


def serve_http_once(srv, cfg: dict, tmp: Path, payload: dict) -> dict:
    """One POST /generate of ``payload`` to ``_serve_http`` on 127.0.0.1,
    port 0, in a thread (max_requests 1); returns the response."""
    import threading
    import urllib.request

    from tempo_tpu_torch.cli.serve_lm import _serve_http

    tmp.mkdir()
    th = threading.Thread(target=_serve_http, args=(srv, {
        **cfg, "host": "127.0.0.1", "port": 0, "max_requests": 1}, tmp, 64),
        daemon=True)
    th.start()
    info = tmp / "serving_info.yaml"
    for _ in range(600):
        if info.exists() and info.read_text().strip():
            break
        time.sleep(0.05)
    else:
        fail("13d: the HTTP server did not start")
    base = f"http://127.0.0.1:{json.loads(info.read_text())['port']}"
    post = urllib.request.Request(f"{base}/generate",
                                  data=json.dumps(payload).encode(),
                                  headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(post, timeout=300) as r:
        got = json.loads(r.read())
    th.join(timeout=60)
    if th.is_alive():
        fail("13d: the HTTP server did not stop after its one request")
    return got


def options_serving_path(dev, rows: dict, lm: dict,
                         exports: "LMExports") -> dict:
    """13b MoE serving, 13c int8, 13d beam search (module docstring)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from tempo_tpu_torch.cli.serve_lm import _serve_batch, build_server
    from tempo_tpu_torch.infer.export_lm import live_paged_surface
    from tempo_tpu_torch.nn.beam import beam_search
    from tempo_tpu_torch.nn.quant import quantize_lm_params
    from tempo_tpu_torch.nn.transformer import Transformer, serving_copy

    card = smi_line()
    seconds, t_part = {}, time.perf_counter()
    dense_cfg = opt_config()
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, dense_cfg.in_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)).to(dev)
    reqs = lm_workload(dense_cfg.in_size)[:OPT_REQUESTS]
    out: dict = {"card": card}

    # ------------------------------------------------- 13b MoE serving
    moe = Transformer(opt_config(**MOE_MODEL), device=dev, seed=SEED)
    gen_moe = opt_generate(moe, prompt, "13b")
    gen_moe.pop("tokens")
    surface = live_paged_surface(moe, max_seq=LM_CACHE, decode_chunk=LM_K,
                                 page_size=LM_PAGE, device=dev)
    (toks, st), _, k4 = count_decode(lambda: paged_serve(surface, reqs, dev))
    if k4 == 0 or [len(t) for t in toks] != [r["n_tokens"] for r in reqs]:
        fail(f"13b: the MoE paged server launched K4 {k4} times or returned "
             f"wrong token counts")
    out["moe_serving"] = {
        "generate": gen_moe, "paged": {"k4_launches": k4, "requests":
                                       len(reqs), **{k: st[k] for k in (
                                           "tokens_per_sec", "seconds",
                                           "decode_steps", "preemptions")}},
        "batch_independence": "not gated: the expert capacity ceil(k n / E "
                              "cf) depends on the call's token count, so a "
                              "row's routing depends on its batch (JAX's "
                              "semantics)"}
    print(f"[13b] MoE (4 experts, top-1) serving on {card}: "
          f"{json.dumps(out['moe_serving'])}", flush=True)
    del moe, surface
    seconds["13b"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ------------------------------------------------------ 13c int8
    dense = Transformer(dense_cfg, device=dev, seed=SEED)
    qcfg = dataclasses.replace(dense_cfg, quantize="int8")
    qmodel = Transformer(qcfg, device="meta")
    qmodel.load_state_dict(quantize_lm_params(dense.state_dict()),
                           assign=True)

    def served_bytes(state, config):
        return sum(p.numel() * p.element_size()
                   for p in serving_copy(state, config).parameters())

    bytes_int8 = served_bytes(qmodel.state_dict(), qcfg)
    bytes_bf16 = served_bytes(dense.state_dict(), dense_cfg)
    gen_q = opt_generate(qmodel, prompt, "13c")
    q_tokens = gen_q.pop("tokens")
    # the bf16 model over the dequantized weights, each rounded to bf16 as
    # the int8 forward rounds it: the same weights, another order of
    # rounding only at the tied head (scale after the matmul) and the bias
    # adds
    deq = {}
    for name, value in qmodel.state_dict().items():
        if name.endswith("kernel_q"):
            prefix = name[:-len("kernel_q")]
            scale = qmodel.state_dict()[prefix + "scale"]
            deq[prefix + "weight"] = (value.to(torch.bfloat16)
                                      * scale.to(torch.bfloat16)[:, None]
                                      ).float()
        elif not name.endswith(".scale"):
            deq[name] = value
    deq_model = Transformer(dense_cfg, device="meta")
    deq_model.load_state_dict(deq, assign=True)
    with torch.no_grad():
        logits_q = qmodel(prompt)
        logits_d = deq_model(prompt)
    deq_rel = rel_l2(logits_q, logits_d)
    if not deq_rel <= INT8_DEQ_REL_L2:
        fail(f"13c: int8 logits vs the bf16 model on the dequantized "
             f"weights: rel L2 {deq_rel} > {INT8_DEQ_REL_L2}")
    del deq_model, deq, logits_q, logits_d
    # serve_lm paged over the int8 programs beside the live int8 surface
    art = exports.path("target_int8")
    meta = json.loads((art / "meta.json").read_text())
    if meta["quantize"] != "int8" or meta["n_experts"] != 0:
        fail(f"13c: the int8 artifact's meta says {meta['quantize']}, "
             f"{meta['n_experts']} experts")
    srv_cfg = {"artifacts": str(art), "scheduler": "paged",
               "slots": LM_SLOTS, "k_decode": LM_K,
               "n_pages": LM_POOLS["roomy"], "prefill_chunk": LM_CHUNK}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "reqs.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
        srv = build_server(srv_cfg, dev)
        _, _, k4_prog = count_decode(lambda: _serve_batch(
            srv, {**srv_cfg, "requests": str(path)}, Path(tmp), 64))
        prog_tokens = [json.loads(line)["tokens"] for line in
                       (Path(tmp) / "completions.jsonl").read_text()
                       .splitlines()]
        prog_info = json.loads((Path(tmp) / "serving_info.yaml").read_text())
    del srv
    live = live_paged_surface(qmodel, max_seq=LM_CACHE, decode_chunk=LM_K,
                              page_size=LM_PAGE, device=dev)
    (live_tokens, _), _, k4_live = count_decode(
        lambda: paged_serve(live, reqs, dev))
    if prog_tokens != live_tokens or k4_prog != k4_live or k4_prog == 0:
        fail(f"13c: serve_lm paged over the int8 programs differs from the "
             f"live int8 surface: tokens equal {prog_tokens == live_tokens}, "
             f"K4 {k4_prog} vs {k4_live}")
    out["int8"] = {
        "weight_bytes_int8": bytes_int8, "weight_bytes_bf16": bytes_bf16,
        "bytes_ratio": bytes_int8 / bytes_bf16, "generate": gen_q,
        "generate_bf16_ms_per_token_3a": lm["generate_ms_per_token"],
        "logits_vs_dequantized_bf16_rel_l2": deq_rel,
        "serve_lm_paged": {"k4_launches": k4_prog, "tokens_equal_live": True,
                           "tokens_per_sec": prog_info["tokens_per_sec"],
                           "requests": len(reqs)},
        "export_s": exports.results["target_int8"]["export_s"]}
    print(f"[13c] int8 on {card}: {json.dumps(out['int8'])}", flush=True)
    del qmodel, live, q_tokens
    seconds["13c"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # --------------------------------------------------- 13d beam search
    art = exports.path("target_bf16")
    srv_cfg = {"artifacts": str(art), "scheduler": "bucketed"}
    srv = build_server(srv_cfg, dev)
    prompts = np.random.default_rng(SEED + 13).integers(
        0, dense_cfg.in_size, (BEAM_BATCH, LM_PROMPT)).astype(np.int64)
    (beams, scores), k3, _ = count_decode(
        lambda: srv.beam_batch(prompts, BEAM_NEW, BEAM_WIDTH))
    # the first step's call captures its graph (an eager warm-up, then a
    # replay), each of the other BEAM_NEW - 2 steps replays it
    want = dense_cfg.n_layer * BEAM_NEW
    if k3 != want:
        fail(f"13d: K3 launched {k3} times in beam_batch, want {want}")
    _, dt = timed(lambda: srv.beam_batch(prompts, BEAM_NEW, BEAM_WIDTH))
    stats = dict(srv.beam_stats)
    one, _ = srv.beam_batch(prompts, BEAM_NEW, 1)
    greedy = srv.generate_batch(prompts, BEAM_NEW)
    if not np.array_equal(one[:, 0], greedy):
        fail("13d: beam width 1 differs from the greedy stream")
    seq, live_scores = beam_search(dense, prompts, BEAM_NEW, BEAM_WIDTH,
                                   cache_dtype=torch.bfloat16,
                                   cache_len=LM_CACHE)
    live_equal = bool(np.array_equal(seq[:, :, LM_PROMPT:].cpu().numpy(),
                                     beams))
    score_diff = float(np.abs(live_scores.cpu().numpy() - scores).max())
    if not live_equal:
        fail(f"13d: beam_batch over the artifact differs from nn/beam.py "
             f"on the live model (scores differ by {score_diff})")
    # one request decodes at batch 1: held to beam_batch of its prompt
    # alone (the matmuls of another batch may round otherwise)
    alone, _ = srv.beam_batch(prompts[:1], BEAM_NEW, BEAM_WIDTH)
    req = {"tokens": prompts[0].tolist(), "n_tokens": BEAM_NEW,
           "beam_width": BEAM_WIDTH}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "beam.jsonl"
        path.write_text(json.dumps(req) + "\n")
        _serve_batch(srv, {**srv_cfg, "requests": str(path)}, Path(tmp), 64)
        batch_resp = json.loads((Path(tmp) / "completions.jsonl")
                                .read_text().splitlines()[0])
        http_resp = serve_http_once(srv, srv_cfg, Path(tmp) / "http", req)
    if (batch_resp["beams"] != alone[0].tolist()
            or http_resp.get("beams") != batch_resp["beams"]
            or http_resp.get("tokens") != batch_resp["tokens"]):
        fail(f"13d: a beam_width request through serve_requests "
             f"({batch_resp['beams'] == alone[0].tolist()}) or _serve_http "
             f"({http_resp.get('beams') == batch_resp['beams']}) differs "
             f"from beam_batch")
    out["beam"] = {
        "batch": BEAM_BATCH, "width": BEAM_WIDTH, "new_tokens": BEAM_NEW,
        "k3_launches": k3, "ms_per_step": 1e3 * dt / BEAM_NEW,
        "tokens_per_s": BEAM_BATCH * BEAM_NEW / dt,
        "host_scoring_share": stats["host_scoring_s"] / stats["seconds"],
        "host_scoring_ms_per_step": 1e3 * stats["host_scoring_s"]
        / stats["steps"], "width1_equals_greedy": True,
        "equals_live_beam_search": live_equal,
        "live_score_max_abs_diff": score_diff,
        "serve_requests_and_http_equal": True}
    print(f"[13d] beam search over the bf16 artifact on {card}: "
          f"{json.dumps(out['beam'])}", flush=True)
    del srv, dense
    seconds["13d"] = time.perf_counter() - t_part
    rows["K3"]["launches_phase13"] = {
        "moe_generate": gen_moe["k3_launches"],
        "int8_generate": gen_q["k3_launches"], "beam_batch": k3}
    rows["K4"]["launches_phase13"] = {
        "moe_paged": out["moe_serving"]["paged"]["k4_launches"],
        "int8_programs": k4_prog, "int8_live": k4_live}
    out["seconds"] = seconds
    torch.cuda.empty_cache()
    return out


def moe_step_vs_plain(dev, cfg, tokens) -> dict:
    """One MoE train step's loss and gradients through K5 against the plain
    attention path, at 4c's tolerances: in bf16 at ``cfg``'s size the loss
    (STEP_BF16_TOL); in fp32 at 2 layers and batch 2 the loss and every
    gradient (STEP_F32_TOL). The bf16 gradients are reported beside the
    tokens whose top-1 expert the two paths chose differently: the router
    reads activations that K5 and the plain attention round differently in
    bf16, so some routes flip and move those tokens' gradients to another
    expert (a discrete change, not a rounding error); fp32 flips none."""
    import dataclasses

    from tempo_tpu_torch.nn.transformer import Transformer
    from tempo_tpu_torch.train.step import lm_loss_fn

    def loss_and_grads(config, batch):
        model = Transformer(config, device=dev, seed=SEED)
        routes = []
        hooks = [blk.moe.register_forward_hook(
            lambda mod, inp, out: routes.append(mod.router(
                inp[0].reshape(-1, inp[0].shape[-1]).float()).argmax(-1)))
            for blk in model.transformer["h"]]
        loss, _ = lm_loss_fn(model)(model, batch, None)
        loss.backward()
        for h in hooks:
            h.remove()
        return (float(loss.detach()), {k: p.grad for k, p in
                                       model.named_parameters()}, routes)

    res = {}
    for label, config, batch, tol in (
            ("bf16", cfg, tokens, STEP_BF16_TOL),
            ("f32_2layer_b2", dataclasses.replace(
                cfg, compute_dtype="float32", n_layer=2), tokens[:2],
             STEP_F32_TOL)):
        loss_k, grads_k, routes_k = loss_and_grads(config, batch)
        loss_p, grads_p, routes_p = loss_and_grads(
            dataclasses.replace(config, attn_impl="xla"), batch)
        r = res[label] = {
            "loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
            "max_grad_rel_l2": max(rel_l2(grads_k[k], grads_p[k])
                                   for k in grads_p),
            "route_flips_by_layer": [int((a != b).sum()) for a, b in
                                     zip(routes_k, routes_p)],
            "tokens_a_layer": int(batch[:, :-1].numel())}
        gated = r["loss_rel"] <= tol["loss"] and (
            label == "bf16" or r["max_grad_rel_l2"] <= tol["grad"])
        if not gated:
            fail(f"13a: an MoE step through K5 disagrees with the plain "
                 f"path ({label}): {r} (tol {tol})")
        del grads_k, grads_p
    return res


def gpt_run_config(out: Path, **extra) -> dict:
    """train_gpt's config at GPT-2-small's widths for 13e: OPT_STEPS steps
    at batch OPT_BATCH on a synthetic stream, one validation and one
    checkpoint at the end."""
    cfg = opt_config()
    model = {"n_layer": cfg.n_layer, "n_head": cfg.n_head,
             "n_embd": cfg.n_embd, "block_size": cfg.block_size,
             "in_size": cfg.in_size, "compute_dtype": "bfloat16"}
    model.update(extra.pop("model", {}))
    return dict({
        "output_dir": str(out), "seed": SEED,
        "data": {"synthetic": {"vocab_size": cfg.in_size,
                               "length": OPT_STREAM}, "batch_size": OPT_BATCH},
        "model": model,
        "optimizer": {"lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1},
        "training": {"n_steps": OPT_STEPS, "save_every": OPT_STEPS,
                     "val_every": OPT_STEPS, "log_every": 1,
                     "plot_every": 10 ** 6},
        "generation": {"n_tokens": 8}}, **extra)


def options_training_path(dev, rows: dict, root: Path) -> dict:
    """13a MoE training, 13e LoRA, dropout and bf16 moments through
    train_gpt.run (module docstring)."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from tempo_tpu_torch.cli import train_gpt
    from tempo_tpu_torch.nn.lora import lora_delta
    from tempo_tpu_torch.nn.transformer import (Transformer, estimate_mfu,
                                                make_gpt_optimizer,
                                                num_params)
    from tempo_tpu_torch.train.state import create_train_state
    from tempo_tpu_torch.train.step import lm_loss_fn, make_train_step
    from tempo_tpu_torch.train.trainer import Trainer, to_device

    card = smi_line()
    seconds, t_part = {}, time.perf_counter()
    out: dict = {"card": card}

    # ---------------------------------------------------- 13a MoE training
    cfg = opt_config(attn_impl="auto", **MOE_MODEL)
    model = Transformer(cfg, device=dev, seed=SEED)
    tx = make_gpt_optimizer(model, weight_decay=0.1, learning_rate=3e-4,
                            betas=(0.9, 0.95))
    state = create_train_state(model, tx, SEED)
    step = make_train_step(lm_loss_fn(model), tx)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.in_size, (TRAIN_BATCH, cfg.block_size + 1))).to(dev)
    losses, aux = [], []
    for _ in range(MOE_WARM):
        state, m = step(state, tokens)
        losses.append(m["loss"])
        aux.append(m["moe_aux"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def timed_steps():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(MOE_STEPS):
            state, m = step(state, tokens)
            losses.append(m["loss"])
            aux.append(m["moe_aux"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / MOE_STEPS

    dt, k5 = count_flash(timed_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = cfg.n_layer * MOE_STEPS
    if any(n != want for n in k5.values()):
        fail(f"13a: K5 launches in the {MOE_STEPS} timed MoE steps {k5}, "
             f"want {want} each")
    losses = torch.stack(losses).tolist()
    aux = torch.stack(aux).tolist()
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"13a: the MoE loss is not finite or not falling: {losses}")
    n_params = num_params(model)
    expert = sum(p.numel() for k, p in model.named_parameters()
                 if ".moe." in k and ".router." not in k)
    e = cfg.n_experts
    active = n_params - expert * (e - 1) // e
    tok_s = TRAIN_BATCH * cfg.block_size / dt
    del model, tx, state, step
    torch.cuda.empty_cache()
    vs_plain = moe_step_vs_plain(dev, cfg, tokens)
    top2 = moe_step_vs_plain(dev, dataclasses.replace(
        cfg, expert_top_k=2, n_layer=MOE_TOP2_LAYERS), tokens)
    out["moe_train"] = {
        "experts": e, "top_k": cfg.expert_top_k,
        "capacity_factor": cfg.expert_capacity_factor, "batch": TRAIN_BATCH,
        "step_ms": 1e3 * dt, "tokens_per_s": tok_s,
        "n_params": n_params, "n_params_active": active,
        "mfu": estimate_mfu(cfg, n_params, TRAIN_BATCH, dt,
                            PEAK_FLOPS["bfloat16"]),
        "mfu_active": estimate_mfu(cfg, active, TRAIN_BATCH, dt,
                                   PEAK_FLOPS["bfloat16"]),
        "peak_device_gb": peak_gb, "k5_launches": k5,
        "moe_aux_mean": sum(aux) / len(aux), "losses": losses,
        "step_vs_plain": vs_plain,
        f"top2_{MOE_TOP2_LAYERS}layer_step_vs_plain": top2}
    print(f"[13a] MoE GPT-2-small training on {card}: "
          f"{json.dumps(out['moe_train'])}", flush=True)
    seconds["13a"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    torch.cuda.empty_cache()

    # ------------------------------------------- 13e LoRA through train_gpt
    base = Transformer(opt_config(), device=dev, seed=SEED)
    base_path = root / "base.pt"
    torch.save({"model": {k: v.cpu() for k, v in base.state_dict().items()}},
               base_path)
    digest = hashlib.sha256(base_path.read_bytes()).hexdigest()
    lcfg = gpt_run_config(root / "lora", finetune={
        "lora_rank": OPT_LORA_RANK, "lora_scale": 1.0,
        "base_checkpoint": str(base_path)})
    (trainer, stats), k5 = count_flash(lambda: train_gpt.run(lcfg,
                                                             device=dev))
    want = base.config.n_layer * OPT_STEPS
    if k5["K5dkv"] != want or k5["K5dq"] != want or k5["K5f"] < want:
        fail(f"13e: K5 launches in the LoRA run {k5}, want {want} backward "
             f"each and at least {want} forward")
    if hashlib.sha256(base_path.read_bytes()).hexdigest() != digest:
        fail("13e: the LoRA base checkpoint changed")
    ckpts = root / "lora" / "checkpoints"
    adapters = torch.load(ckpts / f"ckpt_step={OPT_STEPS:06d}.pt",
                          weights_only=True)["model"]
    merged = torch.load(ckpts / "merged_final.pt", weights_only=True)["model"]
    if not adapters or not all(k.startswith("adapters.") for k in adapters):
        fail("13e: the LoRA checkpoint holds more than the adapters")
    moved = sum(int(torch.count_nonzero(v) > 0) for k, v in adapters.items()
                if k.endswith(".b"))
    exact = True
    for name, w in base.state_dict().items():
        key = "adapters." + name.replace(".", "/")
        if key + ".a" in adapters:
            w = w + lora_delta(name, adapters[key + ".a"].to(dev),
                               adapters[key + ".b"].to(dev), 1.0)
        exact &= bool(torch.equal(merged[name].to(dev), w))
    if not exact or moved == 0:
        fail(f"13e: merged_final is not the base plus s a @ b, or no "
             f"adapter moved ({moved})")
    n_adapter = sum(v.numel() for v in adapters.values())
    out["lora"] = {"rank": OPT_LORA_RANK, "steps": OPT_STEPS,
                   "adapter_params": n_adapter, "k5_launches": k5,
                   "base_unchanged": True, "adapters_moved": moved,
                   "merged_equals_base_plus_delta": True,
                   "samples_per_sec": stats["samples_per_sec"]}
    print(f"[13e] LoRA fine-tune through train_gpt.run on {card}: "
          f"{json.dumps(out['lora'])}", flush=True)
    del trainer, adapters, merged, base
    torch.cuda.empty_cache()

    # ------------------------------------------ 13e dropout through train_gpt
    dcfg = gpt_run_config(root / "dropout",
                          model={"dropout": OPT_DROPOUT})
    (trainer, stats), k5d = count_flash(lambda: train_gpt.run(dcfg,
                                                              device=dev))
    if any(k5d.values()):
        fail(f"13e: the dropout run launched K5 {k5d}: live attention "
             f"dropout takes the materialized path")
    history = json.loads((root / "dropout" / "metrics.json").read_text())
    d_losses = [m["loss"] for m in history["train"]]
    if not all(math.isfinite(x) for x in d_losses):
        fail(f"13e: the dropout run's loss is not finite: {d_losses}")
    trained = trainer.state.model
    plain = Transformer(dataclasses.replace(trained.config, dropout=0.0),
                        device="meta")
    plain.load_state_dict(trained.state_dict(), assign=True)
    with torch.no_grad():
        eval_equal = bool(torch.equal(trained(tokens[:2, :-1]),
                                      plain(tokens[:2, :-1])))
    if not eval_equal:
        fail("13e: the dropout model in eval differs from the dropout-0 "
             "model on the same weights")
    out["dropout"] = {"rate": OPT_DROPOUT, "steps": OPT_STEPS,
                      "k5_launches": k5d, "losses": d_losses,
                      "eval_equals_dropout0": True,
                      "samples_per_sec": stats["samples_per_sec"]}
    print(f"[13e] dropout through train_gpt.run on {card}: "
          f"{json.dumps(out['dropout'])}", flush=True)
    del trainer, trained, plain
    torch.cuda.empty_cache()

    # ----------------------------------- 13e bf16 moments through train_gpt
    mcfg = gpt_run_config(root / "mu", optimizer={
        "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1,
        "moments_dtype": "bfloat16"})
    trainer, stats = train_gpt.run(mcfg, device=dev)
    opt_states = list(trainer.state.optimizer.state.values())
    n = sum(p.numel() for p in trainer.state.model.parameters())
    if {s["exp_avg"].dtype for s in opt_states} != {torch.bfloat16}:
        fail("13e: moments_dtype bfloat16 did not store exp_avg in bf16")
    state_bytes = sum(s["exp_avg"].nbytes + s["exp_avg_sq"].nbytes
                      for s in opt_states)
    saved = 8 * n - state_bytes
    if saved != 2 * n:
        fail(f"13e: the optimizer state is {state_bytes} bytes for {n} "
             f"parameters: {saved} fewer than fp32 moments, want {2 * n}")
    ckpt = root / "mu" / "checkpoints" / f"ckpt_step={OPT_STEPS:06d}.pt"
    model2 = Transformer(trainer.state.model.config, device=dev,
                         seed=SEED + 99)
    tx2 = make_gpt_optimizer(model2, 0.1, 3e-4, (0.9, 0.95),
                             moments_dtype="bfloat16")
    trainer2 = Trainer(lm_loss_fn(model2), tx2,
                       create_train_state(model2, tx2, SEED), root / "mu2",
                       device=dev, verbose=False)
    trainer2.load_checkpoint(ckpt)
    batch = to_device(tokens.cpu().numpy(), dev)
    live, _ = trainer.train_step(trainer.state, batch)
    again, _ = trainer2.train_step(trainer2.state, batch)
    same = all(torch.equal(a, b) for a, b in zip(
        live.model.parameters(), again.model.parameters()))
    same &= all(torch.equal(a["exp_avg"], b["exp_avg"]) for a, b in zip(
        live.optimizer.state.values(), again.optimizer.state.values()))
    if not same:
        fail("13e: a step from the reloaded bf16-moment checkpoint differs "
             "from the live state's")
    out["moments_bf16"] = {"steps": OPT_STEPS, "n_params": n,
                           "optimizer_state_bytes": state_bytes,
                           "bytes_saved_vs_fp32_moments": saved,
                           "resume_bitwise": True,
                           "samples_per_sec": stats["samples_per_sec"]}
    print(f"[13e] bf16 first moments through train_gpt.run on {card}: "
          f"{json.dumps(out['moments_bf16'])}", flush=True)
    del trainer, trainer2, live, again, model2
    torch.cuda.empty_cache()
    seconds["13e"] = time.perf_counter() - t_part
    for name in ("K5f", "K5dkv", "K5dq"):
        rows[name]["launches_phase13"] = {
            "moe_timed_steps": out["moe_train"]["k5_launches"][name],
            "lora_run": out["lora"]["k5_launches"][name],
            "dropout_run": out["dropout"]["k5_launches"][name]}
    out["seconds"] = seconds
    return out


# ------------------------------------------------------------------------
# Phase 14: the rest of the LM family (taps, untokenized and embedder
# modes, the torch/HF import, the .msgpack full-state resume) and the
# connectomics toolkit.

TAPS_BATCH, TAPS_PATCH_LAYER = 2, 6
UNTOK = {"in_size": 1028, "batch": 8, "cond": 16, "dict_layers": 4}
RESUME = {"steps": 3, "gpt_batch": 8, "vae_batch": 64,
          "key": (SEED, 14), "stream": 20_000}
MEMBRANE = {"size": 1024, "cells": 600, "levels": 3, "rel_l2": 1e-4,
            "rescan_frac": 0.1}


def lm_taps_path(dev, rows: dict) -> dict:
    """14a: GPT-2-small in bf16 (weights from SEED), b 2 x t 1024:
    cached_forward's names by kind, K5 never launched, its logits bitwise
    the attn_impl='xla' forward's; the K5 forward's loss within 4c's bf16
    tolerance of it; a w = 1 patch of x_6 from another prompt reproduces
    that prompt's downstream captures and logits (bf16 rounding of
    x + (p - x) apart), a w = 0 patch is bitwise no patch; one captured
    decode step over a 1024-slot bf16 cache: K3 12 times, logits bitwise
    the uncaptured step's. Times and captured bytes printed."""
    import dataclasses

    import torch

    from tempo_tpu_torch.nn import transformer as pt
    from tempo_tpu_torch.ops.losses import lm_cross_entropy

    card = smi_line()
    cfg = pt.TransformerConfig(compute_dtype="bfloat16")
    model = pt.Transformer(cfg, device=dev, seed=SEED)
    plain = pt.Transformer(dataclasses.replace(cfg, attn_impl="xla"),
                           device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    g = torch.Generator().manual_seed(SEED + 14)
    b, t, n_layer = TAPS_BATCH, cfg.block_size, cfg.n_layer
    toks_a = torch.randint(0, cfg.in_size, (b, t), generator=g).to(dev)
    toks_b = torch.randint(0, cfg.in_size, (b, t), generator=g).to(dev)
    res = {"card": card}
    with torch.inference_mode():
        (logits, hid), k5 = count_flash(lambda: pt.cached_forward(model,
                                                                  toks_a))
        per_layer = ("q", "k", "v", "attn_um", "attn", "y_out",
                     "y_out_proj", "attn_res", "x_attn", "mlp_res")
        want = ({f"{k}^{i}" for k in per_layer
                 for i in range(1, n_layer + 1)}
                | {"tok_emb", "pos_emb", "x_0", "x_ln_f"}
                | {f"x_{i}" for i in range(1, n_layer + 1)})
        kinds = {}
        for name in hid:
            kinds[name.split("^")[0]] = kinds.get(name.split("^")[0], 0) + 1
        ref = plain(toks_a)
        fused, k5_fused = count_flash(lambda: model(toks_a))
        loss_c = float(lm_cross_entropy(logits[:, :-1], toks_a[:, 1:]))
        loss_k = float(lm_cross_entropy(fused[:, :-1], toks_a[:, 1:]))
        res["capture"] = {
            "names": len(hid), "by_kind": kinds, "k5_launches": k5,
            "bitwise_xla_forward": torch.equal(logits, ref),
            "k5_forward_launches": k5_fused,
            "k5_loss_rel": abs(loss_k - loss_c) / abs(loss_c),
            "k5_logits_rel_l2": rel_l2(fused, logits),
            "captured_bytes": sum(v.numel() * v.element_size()
                                  for v in hid.values())}
        if set(hid) != want or any(k5.values()):
            fail(f"14a: the capture's names are not JAX's, or K5 ran under "
                 f"capture: {sorted(set(hid) ^ want)[:8]} {k5}")
        if not res["capture"]["bitwise_xla_forward"]:
            fail("14a: the captured forward's logits are not the xla "
                 "forward's bit for bit")
        if (k5_fused["K5f"] != n_layer or res["capture"]["k5_loss_rel"]
                > STEP_BF16_TOL["loss"]):
            fail(f"14a: the K5 forward disagrees with the materialized one: "
                 f"{res['capture']}")
        del ref, fused

        # patching
        out_b, hid_b = pt.cached_forward(model, toks_b)
        name = f"x_{TAPS_PATCH_LAYER}"
        moved, hid_m = pt.cached_forward(
            model, toks_a, taps={name: (hid_b[name], 1.0)})
        down = [f"x_{i}" for i in range(TAPS_PATCH_LAYER + 1, n_layer + 1)]
        errs = {k: rel_l2(hid_m[k], hid_b[k]) for k in down + ["x_ln_f"]}
        errs["logits"] = rel_l2(moved, out_b)
        zero = model(toks_a, taps={name: (hid_b[name], 0.0)})
        res["patch"] = {"w1_rel_l2": errs,
                        "prompts_rel_l2": rel_l2(logits, out_b),
                        "w0_bitwise": torch.equal(zero, logits)}
        if (max(errs.values()) > STEP_BF16_TOL["loss"]
                or res["patch"]["prompts_rel_l2"] < 0.1
                or not res["patch"]["w0_bitwise"]):
            fail(f"14a: patching {name} does not transplant the other "
                 f"prompt, or w = 0 is not bitwise no patch: {res['patch']}")
        del hid_b, hid_m, moved, zero, out_b

        # one captured decode step
        cache = pt.init_cache(cfg, b, dtype=torch.bfloat16, cache_len=t,
                              device=dev)
        model(toks_a[:, :t - 1], cache=cache, input_pos=0)
        twin = tuple((k.clone(), v.clone()) for k, v in cache)
        step = toks_a[:, t - 1:]
        ((got, _), hid_d), k3, _ = count_decode(lambda: pt.cached_forward(
            model, step, cache=cache, input_pos=t - 1))
        want_d, _ = model(step, cache=twin, input_pos=t - 1)
        res["decode"] = {"k3_launches": k3, "names": len(hid_d),
                         "bitwise_plain_step": torch.equal(got, want_d)}
        if (k3 != n_layer or not res["decode"]["bitwise_plain_step"]
                or any(k.startswith("attn_um") for k in hid_d)):
            fail(f"14a: the captured decode step: {res['decode']}")
        res["ms"] = {
            "capture_forward": time_ms(
                lambda: pt.cached_forward(model, toks_a), iters=3, warmup=1),
            "xla_forward": time_ms(lambda: plain(toks_a), iters=3,
                                   warmup=1),
            "k5_forward": time_ms(lambda: model(toks_a), iters=3, warmup=1),
            "capture_decode_step": time_ms(lambda: pt.cached_forward(
                model, step, cache=cache, input_pos=t - 1), iters=5),
            "decode_step": time_ms(lambda: model(step, cache=twin,
                                                 input_pos=t - 1), iters=5)}
    rows["K3"]["launches_phase14"]["14a"] = k3
    print(f"[lm-rest] 14a taps at GPT-2-small bf16, b {b} x t {t}: "
          f"{json.dumps(res)}", flush=True)
    return res


def untokenized_path(dev, rows: dict) -> dict:
    """14b: untokenized training at GPT-2-small widths (in_size 1028, b 8 x
    1024 random features from SEED, the next step's features as the
    target): one forward and backward with K5f/K5dkv/K5dq 12 times each;
    loss and gradients against the plain attention path by 4c's
    tolerances (bf16 at full size; fp32 at 2 layers, b 2); step ms. Then
    the dict-embedder mode (x and cond linear embedders, a pos embedding,
    an x unembedder) at 4 layers under the same gates."""
    import dataclasses

    import torch
    from torch import nn

    from tempo_tpu_torch.nn import transformer as pt

    card = smi_line()
    g = torch.Generator().manual_seed(SEED + 15)
    b, c_in = UNTOK["batch"], UNTOK["in_size"]
    base = pt.TransformerConfig(in_size=c_in, tokenized=False,
                                compute_dtype="bfloat16")
    t = base.block_size
    feats = torch.randn((b, t + 1, c_in), generator=g).to(dev)
    cond = torch.randn((b, t, UNTOK["cond"]), generator=g).to(dev)

    def modules(config, dict_mode: bool):
        if not dict_mode:
            return {}
        gen = torch.Generator().manual_seed(SEED + 16)
        e = config.n_embd
        mods = {"x": nn.Linear(c_in, e), "cond": nn.Linear(UNTOK["cond"], e),
                "pos": nn.Embedding(config.block_size, e)}
        out = {"x": nn.Linear(e, c_in)}
        with torch.no_grad():
            for m in list(mods.values()) + list(out.values()):
                for p in m.parameters():
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        return {"embedders": mods, "unembedders": out}

    def loss_and_grads(config, rows_, dict_mode):
        model = pt.Transformer(config, device=dev, seed=SEED,
                               **modules(config, dict_mode))
        x = feats[:rows_]
        inp = ({"x": x[:, :-1], "cond": cond[:rows_]} if dict_mode
               else x[:, :-1])
        loss = (model(inp).float() - x[:, 1:]).square().mean()
        loss.backward()
        return float(loss.detach()), {k: p.grad for k, p in
                                      model.named_parameters()}, model

    res = {"card": card}
    for label, dict_mode, layers in (("untokenized", False, base.n_layer),
                                     ("dict_embedders", True,
                                      UNTOK["dict_layers"])):
        cfg = dataclasses.replace(base, n_layer=layers)
        r = res[label] = {}
        for sub, config, rows_, tol in (
                ("bf16", cfg, b, STEP_BF16_TOL),
                ("f32_2layer_b2", dataclasses.replace(
                    cfg, compute_dtype="float32", n_layer=2), 2,
                 STEP_F32_TOL)):
            (loss_k, grads_k, model), k5 = count_flash(
                lambda: loss_and_grads(config, rows_, dict_mode))
            loss_p, grads_p, _ = loss_and_grads(
                dataclasses.replace(config, attn_impl="xla"), rows_,
                dict_mode)
            r[sub] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                      "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                      "max_grad_rel_l2": max(rel_l2(grads_k[k], grads_p[k])
                                             for k in grads_p),
                      "k5_launches": k5}
            want = {k: config.n_layer for k in k5}
            if k5 != want or not (r[sub]["loss_rel"] <= tol["loss"]
                                  and r[sub]["max_grad_rel_l2"]
                                  <= tol["grad"]):
                fail(f"14b {label} {sub}: K5 launches {k5} (want {want}), or "
                     f"the step disagrees with the plain path: {r[sub]} "
                     f"(tol {tol})")
            if sub == "bf16":
                for k, n in k5.items():
                    rows[k]["launches_phase14"][f"14b_{label}"] = n
                x = feats[:rows_]
                inp = ({"x": x[:, :-1], "cond": cond[:rows_]} if dict_mode
                       else x[:, :-1])

                def fwd_bwd():
                    model.zero_grad(set_to_none=True)
                    (model(inp).float() - x[:, 1:]).square().mean(
                        ).backward()

                r[sub]["step_ms"] = 1e3 * statistics.median(
                    timed(fwd_bwd)[1] for _ in range(3))
            del grads_k, grads_p, model
    print(f"[lm-rest] 14b untokenized and dict-embedder training at "
          f"GPT-2-small widths, b {b} x t {t}: {json.dumps(res)} (tol bf16 "
          f"{STEP_BF16_TOL}, f32 {STEP_F32_TOL})", flush=True)
    return res


def gpt_import_path(dev, rows: dict) -> dict:
    """14c: a GPT-2-small state dict (fp32, weights from SEED) in the
    reference layout, and in HF's (Conv1D weights transposed, a tied
    lm_head, the attention-mask buffers) behind a stand-in ``.config``:
    the port model built from each gives the source's logits bit for bit,
    and greedy generate from the HF import launches K3 (12 x (new - 1))
    and gives the source's tokens."""
    import types

    import torch

    from tempo_tpu_torch.interop.gpt_ckpt import (
        from_hf_gpt2, state_dict_from_torch_transformer)
    from tempo_tpu_torch.nn import transformer as pt

    card = smi_line()
    cfg = pt.TransformerConfig()
    source = pt.Transformer(cfg, device=dev, seed=SEED)
    sd = {k: v.detach().cpu() for k, v in source.state_dict().items()}
    hf_sd = {k: (v.t().contiguous() if k.endswith((
        "attn.c_attn.weight", "attn.c_proj.weight", "mlp.c_fc.weight",
        "mlp.c_proj.weight")) else v) for k, v in sd.items()}
    hf_sd["lm_head.weight"] = sd["transformer.wte.weight"]
    for i in range(cfg.n_layer):
        hf_sd[f"transformer.h.{i}.attn.bias"] = torch.ones(1, 1, 8, 8)
    stand_in = types.SimpleNamespace(
        config=types.SimpleNamespace(vocab_size=cfg.in_size,
                                     n_positions=cfg.block_size,
                                     n_layer=cfg.n_layer, n_head=cfg.n_head,
                                     n_embd=cfg.n_embd),
        state_dict=lambda: hf_sd)

    def built(config, state_dict):
        model = pt.Transformer(config, device="meta")
        model.load_state_dict({k: v.to(dev) for k, v in state_dict.items()},
                              assign=True)
        return model

    t0 = time.perf_counter()
    ref_model = built(cfg, state_dict_from_torch_transformer(sd, cfg))
    hf_cfg, hf_import = from_hf_gpt2(stand_in)
    hf_model = built(hf_cfg, hf_import)
    import_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(SEED + 17)
    toks = torch.randint(0, cfg.in_size, (2, min(256, cfg.block_size)),
                         generator=g).to(dev)
    new = min(32, cfg.block_size // 2)
    prompt = toks[:, :new]
    with torch.inference_mode():
        want = source(toks)
        res = {"card": card, "import_s": import_s,
               "reference_bitwise": torch.equal(ref_model(toks), want),
               "hf_bitwise": torch.equal(hf_model(toks), want),
               "hf_config_is_source": hf_cfg == cfg}
        out, k3, _ = count_decode(lambda: pt.generate(
            hf_model, prompt, new, temperature=0.0))
        res["generate_k3"] = k3
        res["generate_is_source"] = torch.equal(
            out, pt.generate(source, prompt, new, temperature=0.0))
    rows["K3"]["launches_phase14"]["14c"] = k3
    print(f"[lm-rest] 14c GPT-2-small import: {json.dumps(res)}", flush=True)
    if not (res["reference_bitwise"] and res["hf_bitwise"]
            and res["hf_config_is_source"] and res["generate_is_source"]
            and k3 == cfg.n_layer * (new - 1)):
        fail(f"14c: an imported model is not its source: {res}")
    return res


# ---- the JAX package's checkpoint layout, written here without JAX: the
# inverse of interop/jax_params.py for the GPT and the VAE (test
# scaffolding; the port only reads this format)

def _t(a):
    return a.T


def _conv_hwio(w):  # OIHW -> HWIO
    return w.transpose(2, 3, 1, 0)


def _dense_io(w):  # [out, in, 1, 1] -> [in, out]
    return w[:, :, 0, 0].T


def _down_io(w):  # Conv2d [out, in, 2, 2] -> [(kh, kw, cin), cout]
    return _conv_hwio(w).reshape(-1, w.shape[0])


def _up_io(w):  # ConvTranspose2d [in, out, 2, 2] -> [cin, (di, dj, cout)]
    return w.transpose(0, 2, 3, 1).reshape(w.shape[0], -1)


def _put(tree: dict, path: list, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def gpt_jax_tree(sd: dict) -> dict:
    """The port GPT's state dict (numpy) as tempo_tpu's params tree."""
    tree = {}
    for name, w in sd.items():
        parts = name.split(".")
        if parts[0] == "transformer":
            parts = parts[1:]
        if parts[0] == "h":
            parts = [f"h_{parts[1]}"] + parts[2:]
        leaf, mod = parts[-1], parts[:-1]
        if mod[-1] in ("wte", "wpe"):
            _put(tree, mod, w)
        elif mod[-1].startswith("ln"):
            _put(tree, mod + ["scale" if leaf == "weight" else "bias"], w)
        else:
            _put(tree, mod + ["kernel" if leaf == "weight" else "bias"],
                 _t(w) if leaf == "weight" else w)
    return tree


_RES = {"net1.0": ("norm1", None), "net1.2": ("conv1", _conv_hwio),
        "net2.0": ("norm2", None), "net2.2": ("conv2", _conv_hwio),
        "net2.3": ("conv2", _conv_hwio), "skip_conv": ("skip", _dense_io)}


def _vae_leaf(path: list, leaf: str, w, kernel_map):
    if kernel_map is None:  # a norm
        return path + ["scale" if leaf == "weight" else "bias"], w
    if leaf == "weight":
        return path + ["kernel"], kernel_map(w)
    return path + ["bias"], w


def vae_jax_tree(sd: dict) -> dict:
    """The port AutoencoderKL's state dict (numpy) as tempo_tpu's params
    tree (the inverse of jax_params.state_dict_from_jax_params)."""
    tree = {}
    for name, w in sd.items():
        p = name.split(".")
        leaf = p[-1]
        if name == "logvar":
            _put(tree, ["logvar"], w)
            continue
        if p[0] in ("quant_conv", "post_quant_conv"):
            _put(tree, *_vae_leaf([p[0]], leaf, w, _dense_io))
            continue
        coder, rest = p[0], p[1:-1]
        if rest[0] in ("conv_in", "conv_out"):
            path, kmap = [coder, rest[0]], _conv_hwio
        elif rest[0] == "norm_out":
            path, kmap = [coder, "norm_out"], None
        elif rest[0] in ("downs", "ups"):
            lvl = [coder, ("down" if rest[0] == "downs" else "up") + rest[1]]
            if rest[2] in ("down", "up"):
                key = f"{rest[2]}_{'kernel' if leaf == 'weight' else 'bias'}"
                kmap = _down_io if rest[2] == "down" else _up_io
                _put(tree, lvl + [key], kmap(w) if leaf == "weight" else w)
                continue
            kind = "res" if rest[2] == "resnet_blocks" else "attn"
            path, sub = lvl + [f"{kind}{rest[3]}"], rest[4:]
            if kind == "res":
                mod, kmap = _RES[".".join(sub)]
            else:
                mod, kmap = sub[0], (None if sub[0] == "norm" else _dense_io)
            path = path + [mod]
        elif rest[0] in ("mid1", "mid2"):
            mod, kmap = _RES[".".join(rest[1:])]
            path = [coder, rest[0], mod]
        elif rest[0] == "mid_attn1":
            kmap = None if rest[1] == "norm" else _dense_io
            path = [coder, "mid_attn1", rest[1]]
        else:
            raise KeyError(f"no JAX layout for {name}")
        _put(tree, *_vae_leaf(path, leaf, w, kmap))
    return tree


def _contiguous(tree):
    import numpy as np

    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    if isinstance(tree, Bf16):
        return tree
    tree = np.asarray(tree)
    return tree if tree.flags.c_contiguous else tree.copy(order="C")


def jax_full_state(state, to_tree, layout: str, key, train_metrics,
                   val_metrics) -> dict:
    """The payload tempo_tpu's save_checkpoint writes for ``state`` (the
    port's TrainState): params and AdamW's mu/nu through ``to_tree`` (a
    bf16 mu as flax's bfloat16 leaves), ``count`` the update count, in
    optax's state layout for ``layout``: 'gpt' (masked adamw, constant
    lr) or 'vae' (chain(clip_by_global_norm, adamw), constant lr)."""
    import numpy as np
    import torch

    model, opt = state.model, state.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    mu, nu, counts = {}, {}, set()
    bf16 = any(st["exp_avg"].dtype == torch.bfloat16
               for st in opt.state.values())
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if not st:  # never stepped (no gradient): optax holds zeros
                st = {"step": state.step,
                      "exp_avg": torch.zeros_like(p, dtype=(
                          torch.bfloat16 if bf16 else torch.float32)),
                      "exp_avg_sq": torch.zeros_like(p)}
            counts.add(float(st["step"]))
            m = st["exp_avg"].detach().cpu()
            mu[names[id(p)]] = (m.view(torch.int16).numpy().view(np.uint16)
                                if m.dtype == torch.bfloat16 else m.numpy())
            nu[names[id(p)]] = st["exp_avg_sq"].detach().cpu().numpy()
    assert counts == {float(state.step)}, counts

    def wrap(tree):
        if isinstance(tree, dict):
            return {k: wrap(v) for k, v in tree.items()}
        return Bf16((tree.shape, tree))

    params = {k: v.detach().cpu().numpy() for k, v in
              model.named_parameters()}
    mu_tree = _contiguous(to_tree(mu))
    adam = {"count": np.asarray(state.step, np.int32),
            "mu": wrap(mu_tree) if bf16 else mu_tree,
            "nu": _contiguous(to_tree(nu))}
    opt_state = ({"0": adam, "1": {"inner_state": {}}, "2": {}}
                 if layout == "gpt" else
                 {"0": {}, "1": {"0": adam, "1": {}, "2": {}}})
    return {"step": int(state.step), "params": _contiguous(to_tree(params)),
            "opt_state": opt_state, "rng": np.asarray(key, np.uint32),
            "ema": {k: float(v) for k, v in (state.ema or {}).items()},
            "train_metrics": json.dumps(train_metrics),
            "val_metrics": json.dumps(val_metrics)}


def same_state(a, b) -> dict:
    """Parameters, moments and step counts of two TrainStates, bitwise."""
    import torch

    pa = dict(a.model.named_parameters())
    pb = dict(b.model.named_parameters())
    params = pa.keys() == pb.keys() and all(
        torch.equal(pa[k], pb[k]) for k in pa)
    moments, steps, unstepped = True, set(), 0
    for k in pa:
        sa, sb = a.optimizer.state[pa[k]], b.optimizer.state[pb[k]]
        if not sa or not sb:  # a parameter without a gradient: no state
            unstepped += 1    # on one side, zeros (optax's) on the other
            moments &= all(not s_[m].any() for s_ in (sa, sb) if s_
                           for m in ("exp_avg", "exp_avg_sq"))
            continue
        for m in ("exp_avg", "exp_avg_sq"):
            moments &= (sa[m].dtype == sb[m].dtype
                        and torch.equal(sa[m], sb[m].to(sa[m].device)))
        steps |= {float(sa["step"]), float(sb["step"])}
    return {"params": params, "moments": moments,
            "steps": sorted(steps), "state_step": [a.step, b.step],
            "unstepped_params": unstepped}


def resume_path(dev, rows: dict, root: Path) -> dict:
    """14d: full states in the JAX package's layout, written here with
    pack_flax: GPT-2-small's masked AdamW after 3 port steps (batch 8 x
    1024) with fp32 and with bf16 first moments, and the flagship VAE's
    chain(clip, adamw) after 3 steps at batch 64; each resumed through
    cli/train_gpt.run / cli/train_vae.run with training.resume_from (n_steps
    3: nothing more to train). Gates: parameters, moments and step counts
    bitwise the state written; the next step of the resumed state bitwise
    the live state's next step on the same batch (the live generator
    re-seeded by interop/optax_state.generator_seed of the written key, as
    the resume seeds it: the VAE's posterior draw). Write and read MB/s."""
    import numpy as np
    import torch

    from tempo_tpu_torch.cli import train_gpt, train_vae
    from tempo_tpu_torch.data.synthetic import make_tile_shards
    from tempo_tpu_torch.interop.jax_ckpt import read_jax_checkpoint
    from tempo_tpu_torch.interop.optax_state import generator_seed
    from tempo_tpu_torch.models.vae import VAEConfig, build_vae
    from tempo_tpu_torch.nn import transformer as pt
    from tempo_tpu_torch.train.schedules import lr_schedule
    from tempo_tpu_torch.train.state import (create_train_state,
                                             make_optimizer_from_config)
    from tempo_tpu_torch.train.step import (lm_loss_fn, make_train_step,
                                            vae_loss_fn)

    card = smi_line()
    res = {"card": card}
    steps = RESUME["steps"]
    history = ([{"step": s, "loss": 1.0 / s} for s in range(1, steps + 1)],
               [{"step": steps, "val_loss": 0.5}])

    def write(state, to_tree, layout, name):
        t0 = time.perf_counter()
        path = root / name / "checkpoints" / f"ckpt_step={steps:06d}.msgpack"
        path.parent.mkdir(parents=True)
        path.write_bytes(pack_flax(jax_full_state(
            state, to_tree, layout, RESUME["key"], *history)))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        read_jax_checkpoint(path)
        read_s = time.perf_counter() - t0
        size = path.stat().st_size
        return path, {"bytes": size, "write_mb_per_s": size / write_s / 1e6,
                      "read_mb_per_s": size / read_s / 1e6,
                      "read": "warm (the file just written)"}

    def check(label, live, trainer, step_live, batch):
        r = res[label]
        r["resumed"] = same_state(live, trainer.state)
        r["histories"] = (trainer.train_metrics == history[0]
                          and trainer.val_metrics == history[1])
        live.generator.manual_seed(generator_seed(RESUME["key"]))
        with deterministic_cudnn():
            step_live(live, batch)
            _, r["k5_launches"] = count_flash(
                lambda: trainer.train_step(trainer.state, batch))
        r["next_step"] = same_state(live, trainer.state)
        print(f"[lm-rest] 14d {label}: {json.dumps(r)} on {card}",
              flush=True)
        ok = all(r[k]["params"] and r[k]["moments"]
                 and r[k]["steps"] == [float(steps + (k == "next_step"))]
                 and r[k]["state_step"] == [steps + (k == "next_step")] * 2
                 for k in ("resumed", "next_step"))
        if not (ok and r["histories"]):
            fail(f"14d {label}: the resumed state is not the state written, "
                 f"or its next step is not the live state's: {r}")

    # ---------------- GPT-2-small, masked AdamW, fp32 and bf16 moments
    g = torch.Generator().manual_seed(SEED + 18)
    gpt_cfg = pt.TransformerConfig(compute_dtype="bfloat16")
    batches = [torch.randint(0, gpt_cfg.in_size, (RESUME["gpt_batch"],
                                                  gpt_cfg.block_size + 1),
                             generator=g).to(dev) for _ in range(steps + 1)]
    for label, mdt in (("gpt_fp32_moments", None),
                       ("gpt_bf16_moments", "bfloat16")):
        opt_cfg = {"lr": 3e-4, "weight_decay": 0.1}
        if mdt:
            opt_cfg["moments_dtype"] = mdt
        model = pt.Transformer(gpt_cfg, device=dev, seed=SEED)
        tx = pt.make_gpt_optimizer(model, 0.1, lr_schedule(opt_cfg, steps),
                                   (0.9, 0.95), moments_dtype=mdt)
        live = create_train_state(model, tx, SEED)
        live.ema = {}
        step = make_train_step(lm_loss_fn(model), tx)
        for bt in batches[:steps]:
            step(live, bt)
        path, res[label] = write(live, gpt_jax_tree, "gpt", label)
        run_cfg = {"output_dir": str(root / f"{label}_run"), "seed": SEED,
                   "data": {"synthetic": {"vocab_size": gpt_cfg.in_size,
                                          "length": RESUME["stream"]},
                            "batch_size": RESUME["gpt_batch"]},
                   "model": {"compute_dtype": "bfloat16",
                             "in_size": gpt_cfg.in_size},
                   "optimizer": opt_cfg,
                   "training": {"n_steps": steps, "save_every": 1000,
                                "val_every": 1000, "log_every": 1000,
                                "plot_every": 1000,
                                "resume_from": str(path)},
                   "generation": {"n_tokens": 0}}
        t0 = time.perf_counter()
        trainer, _ = train_gpt.run(run_cfg, device=dev)
        res[label]["run_s"] = time.perf_counter() - t0
        check(label, live, trainer, step, batches[steps])
        k5 = res[label]["k5_launches"]
        if k5 != {k: gpt_cfg.n_layer for k in k5}:
            fail(f"14d {label}: the resumed step's K5 launches {k5}")
        for k, n in k5.items():
            rows[k]["launches_phase14"][f"14d_{label}"] = n
        del live, trainer, model, step
        torch.cuda.empty_cache()

    # ------------------------ the flagship VAE, chain(clip, adamw), b 64
    opt_cfg = {"lr": 1e-4, "betas": [0.9, 0.95], "weight_decay": 0.05}
    model, _ = build_vae({}, device=dev, seed=SEED)
    nudge_zero_init(model, torch.Generator(device=dev).manual_seed(SEED))
    tx = make_optimizer_from_config(opt_cfg, n_steps=steps)
    live = create_train_state(model, tx, SEED)
    live.ema = {}
    step = make_train_step(vae_loss_fn(model), tx)
    c, h, w = VAEConfig().shape
    batch = torch.from_numpy(np.random.default_rng(SEED + 19).standard_normal(
        (RESUME["vae_batch"], h, w, c), dtype=np.float32)).to(dev)
    with deterministic_cudnn():
        for _ in range(steps):
            step(live, batch)
    path, res["vae"] = write(live, vae_jax_tree, "vae", "vae")
    tiles = make_tile_shards(root / "tiles", n_files=1, tiles_per_file=8,
                             tile=h, n_spectral=c, seed=SEED,
                             dtype=np.float16)
    run_cfg = {"output_dir": str(root / "vae_run"), "seed": SEED,
               "data": {"train_dir": str(tiles), "batch_size": 8,
                        "min_buffer_size": 8},
               "model": {}, "optimizer": opt_cfg,
               "training": {"n_steps": steps, "save_every": 1000,
                            "val_every": 1000, "log_every": 1000,
                            "plot_every": 1000, "resume_from": str(path)}}
    t0 = time.perf_counter()
    trainer, _ = train_vae.run(run_cfg, device=dev)
    res["vae"]["run_s"] = time.perf_counter() - t0
    check("vae", live, trainer, step, batch)
    return res


def em_image(size: int, seed: int, n_cells: int):
    """An EM-like uint8 section and its clean membrane map: Voronoi cells
    (dark interiors) with bright membranes on their borders, the section
    with noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, size, (n_cells, 2))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    best = np.full((size, size), np.inf, np.float32)
    second = np.full((size, size), np.inf, np.float32)
    for cy, cx in centers:
        d = np.hypot(yy - cy, xx - cx)
        second = np.minimum(second, np.maximum(best, d))
        best = np.minimum(best, d)
    memb = 210 * np.exp(-0.5 * ((second - best) / 1.5) ** 2)
    clean = np.clip(30 + memb, 0, 255).astype(np.uint8)
    noisy = np.clip(30 + memb + rng.normal(0, 12, (size, size)), 0, 255)
    return noisy.astype(np.uint8), clean


def connectomics_path(dev, rows: dict) -> dict:
    """14e: membrane inference through the CUNet at its default widths (chs
    48/96/192/384, norm groups 8, mid attention, 1 -> 1 channel, fp32,
    weights from SEED with the zero-init output convs re-drawn) on a
    1024 x 1024 EM-like section: K1a/K1b/K2 counted and the probabilities
    held against the plain forward at rel L2 1e-4; get_seg of the noisy
    section (standing for a trained net's membrane map) on the card bitwise
    get_seg on the CPU (seconds, fixpoint steps), more than half its cells
    found; vi against the clean map's segmentation, error_map of the two
    and rescan_map of the errors; get_freer_device names the card."""
    import numpy as np
    import torch

    from tempo_tpu_torch.analysis import connectomics as pc
    from tempo_tpu_torch.nn.unet import CUNet
    from tempo_tpu_torch.ops import morphology
    from tempo_tpu_torch.utils.devices import (device_memory_summary,
                                               get_freer_device)

    card = smi_line()
    size = MEMBRANE["size"]
    em, clean = em_image(size, SEED, MEMBRANE["cells"])
    net = CUNet(shape=(size, size, 1), out_channels=1, device=dev, seed=SEED)
    nudge_zero_init(net, torch.Generator(device=dev).manual_seed(SEED))
    net.eval()
    levels = MEMBRANE["levels"]
    pc.membrane_prob(net, em, levels=levels, return_dtype=np.float32)
    zero_kernel_counts()
    (prob, prob_s) = timed(lambda: pc.membrane_prob(
        net, em, levels=levels, return_dtype=np.float32))
    launches = kernel_counts()
    with plain_kernels():
        plain, plain_s = timed(lambda: pc.membrane_prob(
            net, em, levels=levels, return_dtype=np.float32))
    res = {"card": card, "membrane": {
        "launches": launches, "ms": 1e3 * prob_s, "plain_ms": 1e3 * plain_s,
        "rel_l2": rel_l2(torch.from_numpy(prob), torch.from_numpy(plain)),
        "prob_std": float(prob.std())}}
    for k, n in launches.items():
        rows[k]["launches_phase14"]["14e"] = n
    if not all(launches.values()) or not (
            res["membrane"]["rel_l2"] <= MEMBRANE["rel_l2"]):
        fail(f"14e: membrane inference launched a kernel no time or "
             f"disagrees with the plain forward: {res['membrane']}")
    # weights from a seed make no membrane map worth segmenting: the noisy
    # section (bright membranes) stands for a trained net's map, the clean
    # one for the slow scan's
    mb = em

    def seg_on(device):
        morphology.STEPS["fixpoint"] = 0
        out, s = timed(lambda: pc.get_seg(mb, device=device))
        return out, s, morphology.STEPS["fixpoint"]

    seg, seg_s, seg_steps = seg_on(dev)
    t0 = time.perf_counter()
    seg_cpu, _, cpu_steps = seg_on("cpu")
    cpu_s = time.perf_counter() - t0
    gt = pc.get_seg(clean, device=dev)
    total, split, merge, _, _ = pc.vi(seg, gt)
    (err, e_total, _, _), err_s = timed(lambda: pc.error_map(
        mb, clean, device=dev))
    # the error probability: the flagged segments, ranked inside and out
    # by how far the fast scan's pixel is from the slow scan's
    rescan = pc.rescan_map(
        0.5 * err / 255.0 + 0.5 * np.abs(em.astype(np.float32) - clean)
        / 255.0, MEMBRANE["rescan_frac"])
    res["segmentation"] = {
        "bitwise_cpu": bool(np.array_equal(seg, seg_cpu)),
        "seconds": seg_s, "cpu_seconds": cpu_s,
        "fixpoint_steps": seg_steps, "cpu_fixpoint_steps": cpu_steps,
        "cells": int(len(np.unique(seg)) - 1),
        "gt_cells": int(len(np.unique(gt)) - 1),
        "vi": [total, split, merge], "error_map_vi": e_total,
        "error_map_s": err_s, "error_pixels": int((err > 0).sum()),
        "rescan_share": float(rescan.mean()),
        "rescan_covers_errors": float(rescan[err > 0].mean())
        if err.any() else None}
    freer = get_freer_device()
    res["device"] = {"freer": str(freer),
                     "summary": device_memory_summary()}
    print(f"[connectomics] 14e membrane inference and segmentation of a "
          f"{size} x {size} section: {json.dumps(res)}", flush=True)
    if not (res["segmentation"]["bitwise_cpu"]
            and res["segmentation"]["cells"] > MEMBRANE["cells"] // 2
            and freer.type == "cuda"
            and res["device"]["summary"][freer.index]["name"]
            == torch.cuda.get_device_name(freer)):
        fail(f"14e: the card's segmentation is not the CPU's bit for bit, "
             f"or get_freer_device does not name the card: {res}")
    return res


# ------------------------------------------------------------------------
# Phase 15: data parallelism (DDP) and ZeRO-3 (FSDP2) on the one card.
# NCCL refuses two ranks on one device, so the two-rank runs share cuda:0
# over gloo, which all-reduces and broadcasts CUDA tensors; gloo has no
# all-gather or reduce-scatter for them, so FSDP2 runs at world 1 over
# NCCL. Two ranks on one card share its time: no number here is a scaling
# number. 15a: the flagship VAE (bf16, the smooth L2 loss as 5c's
# per-gradient rule) at a global batch of 64, 32 a rank, 3 steps of the
# VAE recipe, every posterior draw a slice of one global draw, against
# this process's 3 steps at 64 on the same draws (loss and pixel MSE
# STEP_BF16_TOL["loss"], each first-step gradient STEP_BF16_TOL["grad"]);
# the same in fp32 at two levels and batch 4 (STEP_F32_TOL); the unused
# down and up convs bitwise. 15b/15c: FSDP2 at world 1 against the
# unwrapped model, parameters bitwise after each of 3 steps (the flagship
# VAE bf16 at 64, cuDNN deterministic; GPT-2-small at 8 x 1024). 15d: the
# CLIs under 2 ranks at the flagship's widths, a global batch of 16:
# train_vae with the device buffer replicated, then partitioned by
# process, then train_vae_l2.
PAR = {"world": 2, "steps": 3, "vae_batch": 64, "f32_batch": 4,
       "cli_batch": 16, "cli_steps": 5, "tiles": (2, 8), "timeout": 600}
PAR_OPT = {"lr": 1e-4, "betas": [0.9, 0.95], "weight_decay": 0.05}
PAR_UNUSED = ("encoder.downs.2.down", "decoder.ups.2.up")
PAR_L2 = {"nll_loss_type": "l2"}
PAR_GPT: dict = {}  # TransformerConfig overrides of 15c (none: GPT-2-small)


def par_vae(dev, model_cfg: dict, dtype=None):
    """Phase 15's VAE: build_vae from SEED, the zero-initialized output
    convs nudged from SEED (the same weights in every process)."""
    import torch

    from tempo_tpu_torch.models.vae import build_vae

    model, _ = build_vae(model_cfg, compute_dtype=dtype, device=dev,
                         seed=SEED)
    nudge_zero_init(model, torch.Generator(device=dev).manual_seed(SEED))
    return model


def par_inputs(dev, model, n: int):
    """PAR["steps"] global batches of n tiles and their posterior draws,
    from SEED + 31 on the card (the same in every process)."""
    import torch

    cfg = model.config
    c, h, w = cfg.shape
    f = cfg.spatial_factor
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    batches = [torch.randn((n, h, w, c), generator=g, device=dev)
               for _ in range(PAR["steps"])]
    noises = [torch.randn((n, h // f, w // f, cfg.embed_dim), generator=g,
                          device=dev) for _ in range(PAR["steps"])]
    return batches, noises


@contextlib.contextmanager
def fed_posterior(noises, rows: slice):
    """The posterior samples take the given global draws in turn, each cut
    to ``rows`` (a rank's slice of the global batch)."""
    from tempo_tpu_torch.nn.distributions import DiagonalGaussian

    saved, it = DiagonalGaussian.sample, iter(noises)
    DiagonalGaussian.sample = (lambda self, generator=None: self.mean
                               + self.std * next(it)[rows].to(self.mean.dtype))
    try:
        yield
    finally:
        DiagonalGaussian.sample = saved


def par_steps(dev, state, step, batches, noises, rows: slice) -> dict:
    """The steps on ``rows`` of each global batch: every step's loss and
    pixel MSE, the first step's gradients (fp32, on the host), the K1a/
    K1b/K2 launches of the last step, and the last two steps' ms."""
    import torch

    out = {"loss": [], "pixel_mse": []}
    with fed_posterior(noises, rows):
        for i, x in enumerate(batches):
            if i == len(batches) - 1:
                torch.cuda.synchronize()
                zero_kernel_counts()
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, x[rows])
            if i == 0:
                out["grads"] = {
                    k: p.grad.detach().float().cpu()
                    for k, p in state.model.named_parameters()
                    if p.grad is not None}
            out["loss"].append(float(m["loss"]))
            out["pixel_mse"].append(float(m["pixel_mse"]))
    torch.cuda.synchronize()
    out["step_ms"] = 1e3 * (time.perf_counter() - t0) / (len(batches) - 1)
    out["launches_last_step"] = kernel_counts()
    out["unused"] = {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()
                     if k.startswith(PAR_UNUSED)}
    return out


def par_cli_config(kind: str, root: Path) -> dict:
    """A 15d run: train_vae (device buffer, ``kind`` 'replicate' or
    'process') or train_vae_l2 ('l2'), the flagship's widths, a global
    batch of PAR["cli_batch"], PAR["cli_steps"] steps, the last saved (the
    caller joins the 2 ranks' gloo group: NCCL refuses two ranks on one
    card)."""
    training = {"n_steps": PAR["cli_steps"], "save_every": PAR["cli_steps"],
                "val_every": 100000, "log_every": PAR["cli_steps"],
                "plot_every": PAR["cli_steps"]}
    data = {"batch_size": PAR["cli_batch"], "loader": "device",
            "buffer_slots": 2, "swap_every": 3, "buffer_dtype": "float16"}
    out = str(root / f"run_{kind}")
    if kind == "l2":
        return dict(FLAGSHIP_L2, output_dir=out,
                    data=dict(FLAGSHIP_L2["data"], **data,
                              data_dir=str(root / "tiles")),
                    training=training)
    return {"output_dir": out, "seed": SEED,
            "data": dict(data, train_dir=str(root / "tiles" / "train"),
                         partition=kind),
            "model": dict(VAE_MODEL), "optimizer": PAR_OPT,
            "training": training}


def parallel_child(spec_path: str, rank: int) -> None:
    """One rank of phase 15a and 15d, sharing cuda:0 with the other over
    gloo. 15a: the flagship (bf16) and the two-level fp32 VAE under DDP on
    this rank's half of each global batch (par_steps), a timed gloo
    all-reduce of the flagship's gradient bytes, the group left. 15d: each
    CLI run of the spec in a gloo group of its own, joined here (the CLI
    takes a live group as it is); rank 1 records every file it writes, renames or makes under the run's
    output directory. Writes its results to the spec's directory."""
    import datetime

    import torch
    import torch.distributed as dist

    from tempo_tpu_torch.cli import train_vae, train_vae_l2
    from tempo_tpu_torch.parallel.mesh import create_mesh, shard_state
    from tempo_tpu_torch.train.state import (create_train_state,
                                             make_optimizer_from_config)
    from tempo_tpu_torch.train.step import make_train_step, vae_loss_fn

    spec = json.loads(Path(spec_path).read_text())
    root, world = Path(spec["root"]), PAR["world"]
    dev = torch.device(spec["device"])
    if dev.type == "cuda":  # "cuda" alone: the process's current device
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    for label, model_cfg, dtype, n in (
            ("bf16", dict(VAE_MODEL, **PAR_L2), None, PAR["vae_batch"]),
            ("f32_2level", dict(VAE_F32_MODEL, **PAR_L2), "float32",
             PAR["f32_batch"])):
        model = par_vae(dev, model_cfg, dtype)
        if label == "bf16":
            n_grad = sum(p.numel() for p in model.parameters())
        batches, noises = par_inputs(dev, model, n)
        tx = make_optimizer_from_config(PAR_OPT, n_steps=PAR["steps"])
        state = shard_state(create_train_state(model, tx, SEED),
                            create_mesh(dev))
        rows = slice(rank * n // world, (rank + 1) * n // world)
        out = par_steps(dev, state, make_train_step(vae_loss_fn(model), tx),
                        batches, noises, rows)
        if rank == 0:
            torch.save({"grads": out["grads"], "unused": out["unused"]},
                       root / f"ddp_{label}.pt")
        res[label] = {k: out[k] for k in ("loss", "pixel_mse", "step_ms",
                                          "launches_last_step")}
        del model, state, batches, noises, out
        torch.cuda.empty_cache()
    buf = torch.ones(n_grad, device=dev)
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    res["allreduce_ms"] = 1e3 * (time.perf_counter() - t0) / 3
    res["allreduce_bytes"] = 4 * n_grad
    del buf
    dist.barrier()
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    written, current = [], {"out": None}

    def audit(event, args):
        out = current["out"]
        if out is None:
            return
        path = None
        if event == "open" and args[1] is not None and any(
                c in str(args[1]) for c in "wax+"):
            path = args[0]
        elif event in ("os.mkdir", "os.rename"):
            path = args[0]
        if path is not None and os.path.realpath(str(path)).startswith(out):
            written.append(f"{event} {path}")

    if rank != 0:
        sys.addaudithook(audit)
    res["cli"] = {}
    for kind in ("replicate", "process", "l2"):
        cfg = par_cli_config(kind, root)
        dist.init_process_group(
            "gloo", init_method=f"file://{root / f'store_{kind}'}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=120))
        current["out"] = os.path.realpath(cfg["output_dir"])
        written.clear()
        zero_kernel_counts()
        t0 = time.perf_counter()
        cli = train_vae_l2 if kind == "l2" else train_vae
        trainer, stats = cli.run(cfg, device=dev)
        torch.cuda.synchronize()
        current["out"] = None
        dist.destroy_process_group()
        torch.save(trainer.state.model.state_dict(),
                   root / f"cli_{kind}_rank{rank}.pt")
        res["cli"][kind] = {"launches": kernel_counts(), "step": trainer.step,
                            "run_s": time.perf_counter() - t0,
                            "samples_per_sec": stats["samples_per_sec"],
                            "written": list(written)}
        del trainer
        torch.cuda.empty_cache()
    (root / f"rank{rank}.json").write_text(json.dumps(res))


def fsdp_vs_unwrapped(dev, make, counted, label: str) -> dict:
    """``make()`` -> (model, tx, loss_fn, batches, posterior draws or
    None): PAR["steps"] steps of the unwrapped model, then of the same
    model under FSDP2 over this process's group of one (parallel/fsdp.py),
    the parameters held bitwise after each step; each run's peak memory,
    each step's ms (host wall to a sync; the first includes FSDP2's lazy
    set-up and first use) and ``counted(fn)``'s launches of its last
    step."""
    import torch

    from tempo_tpu_torch.parallel.fsdp import shard_state_fsdp
    from tempo_tpu_torch.parallel.mesh import create_mesh
    from tempo_tpu_torch.train.state import create_train_state
    from tempo_tpu_torch.train.step import make_train_step

    runs = {}
    for mode in ("unwrapped", "fsdp"):
        model, tx, loss_fn, batches, noises = make()
        state = create_train_state(model, tx, SEED)
        if mode == "fsdp":
            state = shard_state_fsdp(state, create_mesh(dev), tx)
        step = make_train_step(loss_fn, tx)
        after, launches, ms = [], {}, []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with (contextlib.nullcontext() if noises is None
              else fed_posterior(noises, slice(None))):
            for i, x in enumerate(batches):
                t0 = time.perf_counter()
                if i == len(batches) - 1:
                    launches = counted(lambda: step(state, x))
                else:
                    step(state, x)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                after.append({k: (p.to_local() if hasattr(p, "to_local")
                                  else p).detach().clone()
                              for k, p in model.named_parameters()})
        runs[mode] = {"after": after, "launches": launches, "ms": ms,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "sharded": sum(hasattr(p, "to_local")
                                     for p in model.parameters())}
        del model, state, step, batches, noises
        torch.cuda.empty_cache()
    a, b = runs["unwrapped"]["after"], runs["fsdp"]["after"]
    runs_launches = {mode: r["launches"] for mode, r in runs.items()}
    bitwise = [all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(a, b)]
    moved = [any(not torch.equal(a[i][k], a[i + 1][k]) for k in a[i])
             for i in range(len(a) - 1)]
    res = {"bitwise_after_each_step": bitwise, "weights_moved": moved,
           "n_params": len(a[0]), "sharded_params": runs["fsdp"]["sharded"]}
    for mode, r in runs.items():
        res[mode] = {"step_ms": r["ms"], "peak_gb": r["peak_gb"],
                     "launches_last_step": r["launches"]}
    del runs, a, b
    print(f"[parallel] 15{label}: {json.dumps(res)} on {smi_line()}",
          flush=True)
    launched = (runs_launches["fsdp"] == runs_launches["unwrapped"]
                and all(v > 0 for v in runs_launches["fsdp"].values()))
    if not (all(bitwise) and all(moved) and res["sharded_params"]
            and launched):
        fail(f"15{label}: FSDP2 at world 1 is not bitwise the unwrapped "
             f"model after every step (or nothing was sharded or moved, or "
             f"its step launched other kernel counts than the unwrapped "
             f"step's, or a kernel no time)")
    return res


def parallel_path(dev, rows: dict, root: Path) -> dict:
    """Phase 15 (see PAR): 15a and 15d in two rank processes started
    together (parallel_child), checked here against this process's
    one-device runs; then 15b and 15c here, FSDP2 over NCCL at world 1.
    Adds each kernel's phase-15 launches to its row."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tempo_tpu_torch.data.synthetic import make_tile_shards
    from tempo_tpu_torch.models.vae import VAEConfig, build_vae
    from tempo_tpu_torch.models.vae_l2 import build_vae_l2
    from tempo_tpu_torch.nn.transformer import (Transformer,
                                                TransformerConfig,
                                                make_gpt_optimizer)
    from tempo_tpu_torch.train.checkpoint import load_params
    from tempo_tpu_torch.train.state import (create_train_state,
                                             make_optimizer_from_config)
    from tempo_tpu_torch.train.step import (lm_loss_fn, make_train_step,
                                            vae_loss_fn)

    card = smi_line()
    seconds, result = {}, {"card": card,
                           "note": "two ranks on one card: no scaling"}
    for r in rows.values():
        r["launches_phase15"] = {}

    # -------------------- 15a's one-device runs, then the rank processes
    t_phase = time.perf_counter()
    ref = {}
    for label, model_cfg, dtype, n in (
            ("bf16", dict(VAE_MODEL, **PAR_L2), None, PAR["vae_batch"]),
            ("f32_2level", dict(VAE_F32_MODEL, **PAR_L2), "float32",
             PAR["f32_batch"])):
        model = par_vae(dev, model_cfg, dtype)
        batches, noises = par_inputs(dev, model, n)
        tx = make_optimizer_from_config(PAR_OPT, n_steps=PAR["steps"])
        state = create_train_state(model, tx, SEED)
        ref[label] = par_steps(dev, state, make_train_step(
            vae_loss_fn(model), tx), batches, noises, slice(None))
        del model, state, batches, noises
        torch.cuda.empty_cache()
    c, h, w = VAEConfig.from_dict(VAE_MODEL).shape
    n_files, per_file = PAR["tiles"]
    make_tile_shards(root / "tiles" / "train", n_files=n_files,
                     tiles_per_file=per_file, tile=h, n_spectral=c,
                     l2_products=FLAGSHIP_L2["l2"]["components"], seed=SEED,
                     dtype=np.float16)
    spec = root / "spec.json"
    spec.write_text(json.dumps({"root": str(root), "device": str(dev),
                                "store": str(root / "store_15a")}))
    logs = [open(root / f"rank{r}.log", "w") for r in range(PAR["world"])]
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.parallel_child(sys.argv[1], int(sys.argv[2]))",
         str(spec), str(r)], cwd=Path(__file__).resolve().parent,
        stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
        for r in range(PAR["world"])]
    try:
        deadline = time.perf_counter() + PAR["timeout"]
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            stop_process(p)
        for f in logs:
            f.close()
    if any(p.returncode for p in procs):
        tails = "\n".join((root / f"rank{r}.log").read_text()[-6000:]
                          for r in range(PAR["world"]))
        fail(f"a phase-15 rank failed or ran past {PAR['timeout']} s:\n"
             f"{tails}")
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(PAR["world"])]
    seconds["15a+d ranks"] = time.perf_counter() - t_phase

    # --------------------------------------------------------- 15a gates
    a = {}
    for label, tol in (("bf16", STEP_BF16_TOL), ("f32_2level", STEP_F32_TOL)):
        got = torch.load(root / f"ddp_{label}.pt", weights_only=True)
        want = ref[label]
        r0 = ranks[0][label]
        loss_rel = max(abs(g - w) / abs(w) for g, w in
                       zip(r0["loss"], want["loss"]))
        mse_rel = max(abs(g - w) / abs(w) for g, w in
                      zip(r0["pixel_mse"], want["pixel_mse"]))
        grad_rel = {k: rel_l2(got["grads"][k], g)
                    for k, g in want["grads"].items()
                    if not k.endswith("attn1.k.bias")}
        same_keys = set(got["grads"]) == set(want["grads"])
        unused = all(torch.equal(got["unused"][k], v)
                     for k, v in want["unused"].items())
        a[label] = {"loss_rel": loss_rel, "pixel_mse_rel": mse_rel,
                    "max_grad_rel_l2": max(grad_rel.values()),
                    "worst_grad": max(grad_rel, key=grad_rel.get),
                    "grads_compared": len(grad_rel),
                    "unused_convs_bitwise": unused,
                    "ranks_agree_on_metrics": ranks[0][label]["loss"]
                    == ranks[1][label]["loss"],
                    "step_ms_two_ranks_on_one_card":
                        [r[label]["step_ms"] for r in ranks],
                    "step_ms_one_process": want["step_ms"],
                    "launches_per_rank_per_step":
                        [r[label]["launches_last_step"] for r in ranks],
                    "launches_one_process_step":
                        want["launches_last_step"]}
        ok = (loss_rel <= tol["loss"] and mse_rel <= tol["loss"]
              and a[label]["max_grad_rel_l2"] <= tol["grad"] and same_keys
              and unused and a[label]["ranks_agree_on_metrics"]
              and all(all(r[label]["launches_last_step"].values())
                      for r in ranks))
        if not ok:
            fail(f"15a {label}: DDP over 2 ranks disagrees with one process "
                 f"(tol {tol}) or a rank launched a kernel no time: "
                 f"{json.dumps(a[label])}")
    bf16_ms = statistics.mean(a["bf16"]["step_ms_two_ranks_on_one_card"])
    a["allreduce"] = {"ms": [r["allreduce_ms"] for r in ranks],
                      "bytes": ranks[0]["allreduce_bytes"],
                      "share_of_bf16_step": statistics.mean(
                          r["allreduce_ms"] for r in ranks) / bf16_ms,
                      "what": "a gloo all-reduce of the flagship's fp32 "
                              "gradient bytes on cuda:0, timed alone (an "
                              "upper bound of the step's: DDP overlaps its "
                              "buckets with the backward)"}
    print(f"[parallel] 15a DDP, 2 ranks over gloo on one card (two ranks on "
          f"one card: no scaling), the flagship bf16 at {PAR['vae_batch']} "
          f"({PAR['vae_batch'] // PAR['world']} a rank) and the fp32 "
          f"two-level VAE at {PAR['f32_batch']}, "
          f"{PAR['steps']} steps against one process: {json.dumps(a)} on "
          f"{card}", flush=True)
    for name in ("K1a", "K1b", "K2"):
        rows[name]["launches_phase15"]["15a_per_rank_per_step"] = ranks[0][
            "bf16"]["launches_last_step"][name]
    result["15a"] = a

    # --------------------------------------------------------- 15d gates
    d = {}
    models = {"replicate": lambda: build_vae(VAE_MODEL, device=dev)[0],
              "process": lambda: build_vae(VAE_MODEL, device=dev)[0],
              "l2": lambda: build_vae_l2(FLAGSHIP_L2["model"],
                                         tuple(FLAGSHIP_L2["l2"][
                                             "mlp_hidden"]), device=dev)[0]}
    for kind, make in models.items():
        cfg = par_cli_config(kind, root)
        out = Path(cfg["output_dir"])
        info = json.loads((out / "training_info.yaml").read_text())
        ckpt = out / "checkpoints" / f"ckpt_step={PAR['cli_steps']:06d}.pt"
        model = make()
        load_params(ckpt, model)
        states = [torch.load(root / f"cli_{kind}_rank{r}.pt",
                             weights_only=True) for r in range(PAR["world"])]
        loaded = model.state_dict()
        bitwise = all(torch.equal(loaded[k], s[k].to(loaded[k].device))
                      for s in states for k in loaded)
        d[kind] = {"n_devices": info["n_devices"],
                   "rank1_writes": ranks[1]["cli"][kind]["written"],
                   "checkpoint_loads_bitwise_both_ranks": bitwise,
                   "launches_per_rank": [r["cli"][kind]["launches"]
                                         for r in ranks],
                   "run_s": [r["cli"][kind]["run_s"] for r in ranks],
                   "samples_per_sec": ranks[0]["cli"][kind][
                       "samples_per_sec"]}
        del model, states, loaded
        ok = (info["n_devices"] == 2 and not d[kind]["rank1_writes"]
              and bitwise and all(all(r["cli"][kind]["launches"].values())
                                  for r in ranks))
        if not ok:
            fail(f"15d {kind}: {json.dumps(d[kind])}")
        for name in ("K1a", "K1b", "K2"):
            rows[name]["launches_phase15"][f"15d_{kind}_rank0"] = ranks[0][
                "cli"][kind]["launches"][name]
    print(f"[parallel] 15d the CLIs under 2 gloo ranks on one card, the "
          f"flagship's widths, global batch {PAR['cli_batch']}, "
          f"{PAR['cli_steps']} steps: {json.dumps(d)} on {card}",
          flush=True)
    result["15d"] = d
    torch.cuda.empty_cache()

    # ----------------------------- 15b, 15c: FSDP2 at world 1 over NCCL
    t_phase = time.perf_counter()
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
        rank=0, world_size=1)
    try:
        def vae():
            model = par_vae(dev, VAE_MODEL)
            batches, noises = par_inputs(dev, model, PAR["vae_batch"])
            tx = make_optimizer_from_config(PAR_OPT, n_steps=PAR["steps"])
            return model, tx, vae_loss_fn(model), batches, noises

        def k12_counted(fn):
            torch.cuda.synchronize()
            zero_kernel_counts()
            fn()
            torch.cuda.synchronize()
            return kernel_counts()

        with deterministic_cudnn():
            result["15b"] = fsdp_vs_unwrapped(dev, vae, k12_counted, "b")
        for name in ("K1a", "K1b", "K2"):
            rows[name]["launches_phase15"]["15b_fsdp_step"] = result["15b"][
                "fsdp"]["launches_last_step"][name]
        seconds["15b"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()

        t_phase = time.perf_counter()
        gcfg = TransformerConfig(compute_dtype="bfloat16", attn_impl="auto",
                                 **PAR_GPT)
        tokens = [torch.from_numpy(np.random.default_rng(SEED + i).integers(
            0, gcfg.in_size, (TRAIN_BATCH, gcfg.block_size + 1))).to(dev)
            for i in range(PAR["steps"])]

        def gpt():
            model = Transformer(gcfg, device=dev, seed=SEED)
            tx = make_gpt_optimizer(model, weight_decay=0.1,
                                    learning_rate=3e-4, betas=(0.9, 0.95))
            return model, tx, lm_loss_fn(model), tokens, None

        result["15c"] = fsdp_vs_unwrapped(
            dev, gpt, lambda fn: count_flash(fn)[1], "c")
        for name in ("K5f", "K5dkv", "K5dq"):
            rows[name]["launches_phase15"]["15c_fsdp_step"] = result["15c"][
                "fsdp"]["launches_last_step"][name]
        seconds["15c"] = time.perf_counter() - t_phase
    finally:
        dist.destroy_process_group()
    result["seconds"] = seconds
    print(f"[time] phase 15, s: {json.dumps(seconds)}", flush=True)
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from tempo_tpu_torch.data.normalize import normalize_radiance
        from tempo_tpu_torch.infer.granule_codec import GranuleCodec
        from tempo_tpu_torch.models.vae import build_vae
        from tempo_tpu_torch.ops import (_build, cuda_decode, cuda_gn,
                                         cuda_gn_conv)
    except ImportError as e:
        fail(f"the tempo_tpu_torch package is not beside this script: {e}")

    print(smi_line(), flush=True)
    # the LM artifacts, exported by background processes while phases 1-3
    # run (3d, 9 and 10 wait for them)
    lm_root = tempfile.TemporaryDirectory()
    exports = LMExports(Path(lm_root.name))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ------------------------------------------------------------ 1. build
    seconds = {}
    t_phase = t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s (sources: "
          f"{[p.name for p in _build._sources()]})", flush=True)
    if _build.build_log:
        lib = _build.library()

        def k2_config(args):
            for name, (cid, *shape) in cuda_gn_conv.CONFIGS.items():
                if tuple(shape) == args:
                    return name, lib.tempo_gn_conv_smem_bytes(cid)
            fail(f"K2 instantiation {args} is not in cuda_gn_conv.CONFIGS")

        lines = ptxas_lines(_build.build_log, lib.tempo_flash_smem_bytes,
                            k2_config)
        for line in lines:
            print(f"[build] ptxas {line}", flush=True)
        path_k5 = [ln for ln in lines if ln.startswith(
            ("tempo::flash fwd_bf16<64", "tempo::flash dkv_bf16<64",
             "tempo::flash dq_bf16<"))]
        spilled = [ln for ln in path_k5 if "0 bytes spill stores, 0 bytes "
                   "spill loads" not in ln]
        if spilled or len(path_k5) != 5:
            fail(f"K5f or K5dkv spills at hd 64 or K5dq at hd 32, 64 or 128, "
                 f"or ptxas said nothing of them: {spilled or path_k5}")
        # The decode kernel at every cache type, head dim and group width.
        path_dec = [ln for ln in lines
                    if ln.startswith("tempo::decode decode_split<")]
        spilled = [ln for ln in path_dec if "0 bytes spill stores, 0 bytes "
                   "spill loads" not in ln]
        if spilled or len(path_dec) != 2 * len(cuda_decode.HEAD_DIMS) * 4:
            fail(f"a decode kernel spills, or ptxas said nothing of it: "
                 f"{spilled or path_dec}")
        # Every bf16 K2 configuration is one the path's launcher picks.
        path_k2 = [ln for ln in lines
                   if ln.startswith("tempo::gn_conv conv_bf16<")]
        spilled = [ln for ln in path_k2 if "0 bytes spill stores, 0 bytes "
                   "spill loads" not in ln]
        if spilled or len(path_k2) != len(cuda_gn_conv.CONFIGS):
            fail(f"a bf16 K2 configuration spills, or ptxas said nothing of "
                 f"one: {spilled or path_k2}")
        # K1a (bf16, fp32; packs or elements) and K1b (bf16, fp32; 16-byte
        # or one-element packs): eight instantiations, none may spill.
        path_k1 = [ln for ln in lines if ln.startswith("tempo::gn ")]
        spilled = [ln for ln in path_k1 if "0 bytes spill stores, 0 bytes "
                   "spill loads" not in ln]
        if spilled or len(path_k1) != 8:
            fail(f"a K1 kernel spills, or ptxas said nothing of it: "
                 f"{spilled or path_k1}")
    else:
        print("[build] the kernel library was loaded from build/kernels "
              "(built by an earlier run): no ptxas output in this run",
              flush=True)
    # K5f and K5dq run on wgmma: their SASS must hold HGMMA.
    sass = sass_counts(_build.library()._name, ("fwd_bf16", "dq_bf16"))
    print(f"[build] SASS (HGMMA, HMMA): {json.dumps(sass)}", flush=True)
    if len(sass) != 6 or not all(h > 0 for h, _ in sass.values()):
        fail(f"K5f or K5dq issues no wgmma at some head dim: {sass}")

    seconds["1"] = time.perf_counter() - t_phase

    # ------------------------------------ model and inputs of the main path
    t_phase = time.perf_counter()
    model, cfg = build_vae({}, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 27_289_893:
        fail(f"flagship parameter count {n_params} != 27,289,893")
    nudge_zero_init(model, gen)
    model.eval()
    tiles = torch.randn((8, 64, 64, 1028), generator=gen, device=dev)
    rng_raw = torch.Generator().manual_seed(SEED)
    raw = torch.exp(3.0 + 0.5 * torch.randn(
        (131, 2048, 1028), generator=rng_raw)).numpy()
    codec = GranuleCodec(model, seed=SEED, device=dev)

    def encode_decode():
        return model.decode(model.encode(tiles).mode())

    gt = codec.normalize(raw)                  # [128, 2048, 1028] on the host

    def granule_forward():
        return codec.reconstruct(gt, sample_posterior=False)

    # ------------------------------------------------------ 2. kernels
    # The shapes of both runs of the main path: the tile batch and the
    # granule (B=1, up to 128x2048 pixels) give the kernels different grids.
    calls = {"K1a": [], "K1b": [], "K2": []}
    with torch.inference_mode():
        with recording(calls, "tile"):
            encode_decode()
        with recording(calls, "granule"):
            granule_forward()
    torch.cuda.synchronize()
    print(f"[kernels] calls per main-path run: "
          f"{ {k: len(v) for k, v in calls.items()} }", flush=True)

    def affine(c):
        scale = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        bias = 0.1 * torch.randn(c, generator=gen, device=dev)
        return scale, bias

    rows = {}
    checks_ok = True

    def row(name, source, replaces, library, **extra):
        return rows.setdefault(name, dict({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "tol": BF16_TOL if name != "K1a" else STATS_TOL,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
            "library_ms": None, "library": library,
            "per": "one main-path run (an [8,64,64,1028] encode+decode and "
                   "a [128,2048,1028] granule reconstruct): sum over the "
                   "kernel's calls there, each timed alone with a cold L2",
            "ms_by_run": {"tile": 0.0, "granule": 0.0}, "shapes": []},
            **extra))

    def add(r, shape_info, n, err, ok, ms, plain_ms, bound_ms, bound_by,
            lib_ms, extra=None):
        """Add one shape's readings to row ``r``; ``n`` is its calls per
        run ({"tile": ., "granule": .}); ``extra`` holds more times, each
        summed into the row's key of the same name."""
        total = sum(n.values())
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += total * ms
        r["plain_ms"] += total * plain_ms
        r["bound_ms"] += total * bound_ms
        r["bound_by"] = bound_by
        for run, k in n.items():
            r["ms_by_run"][run] += k * ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + total * lib_ms
        for key, value in (extra or {}).items():
            if key in r:
                r[key] += total * value
        r["shapes"].append(dict(shape_info, calls=n, ok=ok, max_abs_err=err,
                                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                library_ms=lib_ms, **(extra or {})))

    # K1a, K1b and K2 at every (shape, type) of the path, and K1b at the
    # two shapes asked of K1 besides (hold_recorded says what each holds)
    row("K1a", "tempo_tpu_torch/csrc/gn.cu", "tempo_tpu/ops/pallas_gn.py:66",
        "torch.var_mean over the [B,HW,G,C/G] view", copy_ms=0.0)
    row("K1b", "tempo_tpu_torch/csrc/gn.cu", "tempo_tpu/ops/pallas_gn.py:105",
        "F.group_norm + activation: statistics and apply; compare with "
        "k1_whole_ms", k1_whole_ms=0.0)
    row("K2", "tempo_tpu_torch/csrc/gn_conv.cu",
        "tempo_tpu/ops/pallas_gn_conv.py:53",
        "F.group_norm + activation + F.conv2d (cuDNN); compare with "
        "whole_ms", whole_ms=0.0, library_conv_ms=0.0)
    counted = {k: count_calls(v, ("tile", "granule"))
               for k, v in calls.items()}
    for shape, act in (((8, 64, 64, 512), "gelu"), ((8, 16, 16, 128), None)):
        counted["K1b"].setdefault((shape, "bfloat16", act),
                                  {"tile": 0, "granule": 0})
    checks_ok &= hold_recorded(dev, gen, counted,
                               lambda name, *a: add(rows[name], *a))

    with torch.inference_mode():
        r = rows["K1a"]
        # The five granule calls at [1,128,2048,512] hold 76% of K1a's
        # bytes. Yardsticks beside them: the copy of the same bytes above,
        # torch.sum reading them, and a one-element kernel (what time_ms
        # reads for a call that does nothing).
        x = torch.randn((1, 128, 2048, 512), generator=gen,
                        device=dev).to(torch.bfloat16)
        one = torch.zeros(1, device=dev)
        r["sum_1x128x2048x512_ms"] = time_ms(
            lambda: x.sum(dtype=torch.float32))
        r["one_element_kernel_ms"] = time_ms(lambda: one.add_(1))
        del x
        for sh in r["shapes"]:
            if sh["x"] == [1, 128, 2048, 512]:
                print(f"[kernels] K1a [1,128,2048,512] x"
                      f"{sum(sh['calls'].values())}: {sh['ms']:.5f} ms a call"
                      f", byte bound {sh['bound_ms']:.5f} ms "
                      f"({sh['bound_ms'] / sh['ms']:.1%} of it); copy_ of "
                      f"half {sh['copy_ms']:.5f} ms "
                      f"({sh['bound_ms'] / sh['copy_ms']:.1%})"
                      f"; torch.sum {r['sum_1x128x2048x512_ms']:.5f} ms; a "
                      f"one-element kernel {r['one_element_kernel_ms']:.5f} "
                      f"ms", flush=True)
        # One device kernel a call, at the largest and a small path shape.
        for shape in ((1, 128, 2048, 512), (8, 16, 16, 128)):
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            cuda_gn.gn_stats(x, 8)
            names = device_kernels(lambda: cuda_gn.gn_stats(x, 8))
            print(f"[kernels] K1a {list(shape)}: device kernels in one call "
                  f"{names}", flush=True)
            checks_ok &= len(names) == 1 and "gn_stats_kernel" in names[0]
            del x

        # fp32 kernel paths at one shape each (the plain side without TF32).
        x = torch.randn((8, 16, 16, 128), generator=gen, device=dev)
        scale, bias = affine(128)
        weight = torch.empty((128, 128, 3, 3), device=dev).uniform_(
            -0.03, 0.03, generator=gen)
        cb = 0.01 * torch.randn(128, generator=gen, device=dev)
        for name, got, want in [
            ("K1 f32", cuda_gn.fused_group_norm_act(x, scale, bias, 8),
             cuda_gn.gn_apply_plain(x, cuda_gn.gn_stats_plain(x, 8), scale,
                                    bias, "gelu")),
            ("K2 f32", cuda_gn_conv.gn_act_conv3x3(x, scale, bias, weight,
                                                   cb, 8),
             cuda_gn_conv.gn_act_conv3x3_plain(x, scale, bias, weight, cb,
                                               8))]:
            err, ok = max_err(got, want, F32_TOL)
            print(f"[kernels] {name} [8,16,16,128]: max_abs_err={err:.3e} "
                  f"tol={F32_TOL} ok={ok}", flush=True)
            checks_ok &= ok

        # K1 at its edge shapes, bf16 and fp32, and from an unaligned x
        # (the element path at C 128): K1a to STATS_TOL, bitwise the same on
        # a repeat and for each sample alone; K1b with every activation to
        # BF16_TOL (F32_TOL in fp32).
        edge_ok = True
        for (b, h, w, c), dtype in [(e, d) for e in K1_EDGE for d in (
                torch.bfloat16, torch.float32)] + [((8, 7, 9, 128), None)]:
            x = torch.randn((b, h, w, c), generator=gen, device=dev) + 0.5
            if dtype is None:   # the same values one element off alignment
                dtype = torch.bfloat16
                x = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[
                    1:].view(x.shape).copy_(x)
            x = x.to(dtype)
            got = cuda_gn.gn_stats(x, 8)
            want = cuda_gn.gn_stats_plain(x, 8)
            err, ok = max_err(got, want, STATS_TOL)
            ok &= torch.equal(got, cuda_gn.gn_stats(x, 8))
            ok &= all(torch.equal(got[i:i + 1], cuda_gn.gn_stats(
                x[i:i + 1], 8)) for i in range(b))
            scale, bias = affine(c)
            tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
            for act in (None, "gelu", "relu", "silu"):
                a_err, a_ok = max_err(
                    cuda_gn.gn_apply(x, want, scale, bias, act),
                    cuda_gn.gn_apply_plain(x, want, scale, bias, act), tol)
                err, ok = max(err, a_err), ok and a_ok
            edge_ok &= ok
            print(f"[kernels] K1 edge {[b, h, w, c]} {str(dtype)[6:]}"
                  f"{' unaligned' if x.data_ptr() % 16 else ''}: "
                  f"max_abs_err={err:.3e} ok={ok}", flush=True)
        checks_ok &= edge_ok

        # K1 at the L2 head's shape (phase 6 runs it): K1a to STATS_TOL,
        # bitwise the same on a repeat and for each sample alone; K1b with
        # GELU to BF16_TOL; each timed beside its byte bound.
        shape, eps = K1_HEAD
        b, c = shape[0], shape[-1]
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        scale, bias = affine(c)
        got = cuda_gn.gn_stats(x, 8, eps)
        want = cuda_gn.gn_stats_plain(x, 8, eps)
        err, ok = max_err(got, want, STATS_TOL)
        repeat = torch.equal(got, cuda_gn.gn_stats(x, 8, eps))
        alone = all(torch.equal(got[i:i + 1], cuda_gn.gn_stats(
            x[i:i + 1], 8, eps)) for i in range(b))
        b_err, b_ok = max_err(cuda_gn.gn_apply(x, want, scale, bias, "gelu"),
                              cuda_gn.gn_apply_plain(x, want, scale, bias,
                                                     "gelu"), BF16_TOL)
        head = {
            "K1a": {"x": list(shape), "eps": eps,
                    "split": cuda_gn.choose_stats_split(
                        shape[1] * shape[2], c, x.dtype),
                    "max_abs_err": err, "ok": ok, "bitwise_repeat": repeat,
                    "bitwise_alone": alone,
                    "ms": time_ms(lambda: cuda_gn.gn_stats(x, 8, eps)),
                    "plain_ms": time_ms(
                        lambda: cuda_gn.gn_stats_plain(x, 8, eps)),
                    "bound_ms": 1e3 * (x.numel() * 2 + got.numel() * 4)
                    / HBM_BYTES_PER_S},
            "K1b": {"x": list(shape), "act": "gelu", "max_abs_err": b_err,
                    "ok": b_ok,
                    "ms": time_ms(lambda: cuda_gn.gn_apply(
                        x, want, scale, bias, "gelu")),
                    "plain_ms": time_ms(lambda: cuda_gn.gn_apply_plain(
                        x, want, scale, bias, "gelu")),
                    "bound_ms": 1e3 * (2 * x.numel() * 2 + got.numel() * 4
                                       + 2 * c * 4) / HBM_BYTES_PER_S}}
        for name, r in head.items():
            rows[name]["l2_head_shape"] = r
            print(f"[kernels] {name} L2 head shape {json.dumps(r)}",
                  flush=True)
        checks_ok &= ok and repeat and alone and b_ok
        del x
    torch.cuda.synchronize()
    for r in rows.values():
        for s in r["shapes"]:
            print(f"[kernels] {r['name']} {json.dumps(s)}", flush=True)
    card = smi_line()
    print(f"[kernels] K1a: {rows['K1a']['ms']:.4f} ms a run; a device copy "
          f"of half of each call's x (as many bytes moved) "
          f"{rows['K1a']['copy_ms']:.4f} ms a run; byte bound "
          f"{rows['K1a']['bound_ms']:.4f} ms", flush=True)
    for name, key in (("K1a", "ms"), ("K1b", "ms"), ("K1b", "k1_whole_ms")):
        prev = K1_PREV[name if key == "ms" else key]
        print(f"[kernels] {name if key == 'ms' else 'K1 whole'}: "
              f"{rows[name][key]:.4f} ms a run on {card}; before the "
              f"redesign {prev:.3f} on {KERNEL_PREV['card']}: "
              f"x{prev / rows[name][key]:.2f}", flush=True)
    if not checks_ok:
        fail("a kernel disagrees with its plain version beyond tolerance, "
             "or K1a is not one kernel, bitwise repeatable and the same "
             "for a sample alone")

    seconds["2"] = time.perf_counter() - t_phase

    # ---------------------------------------------------------- 3. main path
    t_phase = time.perf_counter()
    with torch.inference_mode():
        encode_decode()                        # warm: cuDNN plans, caches
        granule_forward()
        torch.cuda.synchronize()

        counters = {"K1a": (cuda_gn.LAUNCHES, "gn_stats"),
                    "K1b": (cuda_gn.LAUNCHES, "gn_apply"),
                    "K2": (cuda_gn_conv.LAUNCHES, "gn_act_conv3x3")}
        for table, key in counters.values():
            table[key] = 0
        post = model.encode(tiles)
        recon = model.decode(post.mode())
        gt, grecon = codec.reconstruct_raw(raw, sample_posterior=False)
        torch.cuda.synchronize()
        launches = {k: table[key] for k, (table, key) in counters.items()}
        print(f"[main] launches in the main-path run: {launches}", flush=True)
        for name, n in launches.items():
            rows[name]["launches"] = n
            if n == 0:
                fail(f"kernel {name} was not launched on the main path")
            if n != len(calls[name]):
                fail(f"kernel {name}: {n} launches, {len(calls[name])} "
                     f"calls recorded for phase 2")

        if recon.shape != tiles.shape or not torch_all_finite(recon):
            fail(f"tile reconstruction bad: {tuple(recon.shape)}")
        if post.mean.shape != (8, 16, 16, 32):
            fail(f"latent shape {tuple(post.mean.shape)}")
        if gt.shape != (128, 2048, 1028) or grecon.shape != gt.shape:
            fail(f"granule shapes {gt.shape} {grecon.shape}")
        if not (np_all_finite(grecon)):
            fail("granule reconstruction is not finite")

        t_encdec = time_ms(encode_decode, iters=5, warmup=1)
        t_enc = time_ms(lambda: model.encode(tiles), iters=5, warmup=1)
        t0 = time.perf_counter()
        codec.reconstruct_raw(raw, sample_posterior=False)
        t_granule = time.perf_counter() - t0
        t0 = time.perf_counter()
        normalize_radiance(raw)  # the host normalize the codec replaced
        t_numpy_normalize = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t_granule_fwd = time_ms(granule_forward, iters=3, warmup=0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"[main] tile batch 8: encode {t_enc:.2f} ms "
              f"({8e3 / t_enc:.1f} patches/s), encode+decode "
              f"{t_encdec:.2f} ms ({8e3 / t_encdec:.1f} patches/s)", flush=True)
        print(f"[main] granule [131,2048,1028]: reconstruct_raw "
              f"{t_granule * 1e3:.1f} ms host wall (incl. the copy to the "
              f"card and its normalize there; numpy's normalize of the "
              f"same array {t_numpy_normalize * 1e3:.1f} ms); "
              f"reconstruct of the normalized crop {t_granule_fwd:.1f} ms "
              f"device (incl. copies); peak device memory {peak_gb:.1f} GB",
              flush=True)

        with plain_kernels():
            recon_plain = model.decode(model.encode(tiles).mode())
            grecon_plain = granule_forward()
        err_bf16 = rel_l2(recon, recon_plain)
        err_granule = rel_l2(torch.from_numpy(grecon),
                             torch.from_numpy(grecon_plain))
        del grecon_plain
    model32, _ = build_vae({}, compute_dtype="float32", device=dev)
    model32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        one = tiles[:1]
        r32 = model32.reconstruct(one, sample_posterior=False)
        with plain_kernels():
            r32_plain = model32.reconstruct(one, sample_posterior=False)
        err_f32 = rel_l2(r32, r32_plain)
    print(f"[main] reconstruction vs plain path, rel L2: bf16 tile batch 8 "
          f"{err_bf16:.3e}, bf16 granule {err_granule:.3e} (tol "
          f"{MODEL_BF16_REL_L2} each); fp32 one tile {err_f32:.3e} (tol "
          f"{MODEL_F32_REL_L2})", flush=True)
    if not err_bf16 <= MODEL_BF16_REL_L2:
        fail("bf16 tile reconstruction disagrees with the plain path")
    if not err_granule <= MODEL_BF16_REL_L2:
        fail("bf16 granule reconstruction disagrees with the plain path")
    if not err_f32 <= MODEL_F32_REL_L2:
        fail("fp32 reconstruction disagrees with the plain path")

    seconds["3"] = time.perf_counter() - t_phase

    # ------------------------------------------------ the LM serving path
    t_phase = time.perf_counter()
    rows["K3"] = lm_row(
        "K3", "tempo_tpu/ops/pallas_decode.py:41",
        "F.scaled_dot_product_attention(q, K, V, attn_mask=[b,1,1,S] bool, "
        "enable_gqa when kv < n) over the transposed cache views")
    rows["K4"] = lm_row(
        "K4", "tempo_tpu/ops/pallas_decode.py:94",
        "none: no single PyTorch call reads K/V through a block table")
    lm = lm_path(dev, gen, rows, exports)
    seconds["lm_serving"] = time.perf_counter() - t_phase

    # -------------------------- 9. speculation and the online server
    t_phase = time.perf_counter()
    children = []
    spec = speculative_path(
        dev, rows, lm["exported"]["serve"], exports,
        after_9a=lambda: children.append(ProgramsChildren(exports, dev)))
    seconds["spec_online"] = time.perf_counter() - t_phase

    # ------------------------------- 10. the exported serving programs
    t_phase = time.perf_counter()
    programs = programs_path(dev, rows, exports, children[0])
    seconds["programs"] = time.perf_counter() - t_phase

    # --------------- 13b-d. MoE serving, int8 and beam search (phase 13)
    t_phase = time.perf_counter()
    options_serving = options_serving_path(dev, rows, lm, exports)
    seconds["model_options_serving"] = time.perf_counter() - t_phase
    HELD.clear()
    exports.stop()
    lm_root.cleanup()
    torch.cuda.empty_cache()

    # ---------------------------------------------- the GPT training path
    t_phase = time.perf_counter()
    lib = "F.scaled_dot_product_attention(is_causal=True) over [b,n,t,hd]"
    rows["K5f"] = flash_row(
        "K5f", "tempo_tpu/nn/transformer.py:151 -> "
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        f"{lib}, forward")
    rows["K5dkv"] = flash_row(
        "K5dkv", "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        f"{lib}, its backward (torch.autograd.grad on the saved graph): dQ, "
        f"dK and dV in one call; compare with K5dkv + K5dq")
    rows["K5dq"] = flash_row(
        "K5dq", "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "none alone: SDPA's backward computes dQ with dK and dV (see K5dkv)")
    train = train_path(dev, gen, rows)
    seconds["lm_train"] = time.perf_counter() - t_phase

    # ---------------------------------------------- the VAE training path
    t_phase = time.perf_counter()
    keep = tempfile.TemporaryDirectory()
    live = {}  # the trained weights of 5b and 6c, for phase 7's loader
    try:
        vae_train = vae_train_path(dev, rows, Path(keep.name), live)
        seconds["vae_train"] = time.perf_counter() - t_phase

        # ---------------------------------- the L2-supervised training path
        t_phase = time.perf_counter()
        vae_l2 = vae_l2_path(dev, rows, Path(keep.name) / "vae.pt",
                             Path(keep.name), live)
        seconds["vae_l2"] = time.perf_counter() - t_phase

        # ------------------------------------ 7. the VAE analysis path
        t_phase = time.perf_counter()
        analysis = analysis_path(dev, rows, Path(keep.name), live)
        seconds["analysis"] = time.perf_counter() - t_phase

        # ------------------ 8. the export and data-preparation path
        t_phase = time.perf_counter()
        export = export_path(dev, rows, Path(keep.name),
                             Path(keep.name) / "vae.pt")
        seconds["export"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        prep = data_prep_path(dev, *live.pop("granule"))
        seconds["prep"] = time.perf_counter() - t_phase
    finally:
        keep.cleanup()
    live.clear()
    torch.cuda.empty_cache()

    # --------------------------------------------- 11. the diffusion path
    t_phase = time.perf_counter()
    diffusion = diffusion_path(dev, rows)
    seconds["diffusion"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()

    # ---------- 12. the trainers' options and the JAX checkpoint bridge
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        options = options_path(dev, Path(tmp))
    seconds["options"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()

    # ------- 13a, 13e. MoE training, LoRA, dropout, bf16 moments (phase 13)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        options_training = options_training_path(dev, rows, Path(tmp))
    seconds["model_options_training"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()

    # ---- 14. taps, untokenized and embedder modes, the torch/HF import,
    # the .msgpack resume, and the connectomics toolkit
    for r in rows.values():
        r["launches_phase14"] = {}
    lm_rest = {}
    for key, fn in (("14a", lm_taps_path), ("14b", untokenized_path),
                    ("14c", gpt_import_path)):
        t_phase = time.perf_counter()
        lm_rest[key] = fn(dev, rows)
        seconds[key] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lm_rest["14d"] = resume_path(dev, rows, Path(tmp))
    seconds["14d"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    connectomics = connectomics_path(dev, rows)
    seconds["14e"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()

    # ------------- 15. data parallelism (DDP) and ZeRO-3 (FSDP2) on the card
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        parallel = parallel_path(dev, rows, Path(tmp))
    seconds["15"] = time.perf_counter() - t_phase
    print(f"[time] phases, s: {json.dumps(seconds)}", flush=True)

    for r in rows.values():
        r.pop("shapes", None)
    print(json.dumps({"kernels": list(rows.values()), "main": {
        "encode_ms_b8": t_enc, "encode_patches_per_s": 8e3 / t_enc,
        "encode_decode_ms_b8": t_encdec,
        "granule_reconstruct_raw_s": t_granule,
        "granule_reconstruct_ms": t_granule_fwd, "peak_device_gb": peak_gb,
        "recon_rel_l2_bf16": err_bf16, "recon_rel_l2_granule": err_granule,
        "recon_rel_l2_f32": err_f32, "lm": lm, "train": train,
        "vae_train": vae_train, "vae_l2": vae_l2, "analysis": analysis,
        "export": export, "prep": prep, "spec": spec, "programs": programs,
        "diffusion": diffusion, "options": options,
        "model_options": {"serving": options_serving,
                          "training": options_training},
        "lm_rest": lm_rest, "connectomics": connectomics,
        "parallel": parallel,
        "granule_numpy_normalize_s": t_numpy_normalize,
        "seconds": seconds}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def np_all_finite(a) -> bool:
    import numpy as np

    return bool(np.isfinite(a).all())


if __name__ == "__main__":
    sys.exit(main())
