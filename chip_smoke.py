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
  3d. exported serving: GPT-2-small written by export_lm and loaded with
      device None; (i) decode_step, decode_rows, decode_k (K 16),
      decode_paged and decode_paged_k replayed against their eager calls
      at the capture's and another position and table, outputs and caches
      bitwise, 12 x K decode launches a replay, each replay timed by CUDA
      events; (ii) the 64 requests
      through cli/serve_lm.py's build_server and _serve_batch with a dict
      config, bucketed, continuous (8 slots, k_decode 16) and paged (65
      and 33 pages): tokens/s, dispatches, bursts, preemptions, the device
      busy share under torch.profiler over the first 16 requests and the
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
      values (FLAGSHIP_L2) for 20 steps, once with the device buffer and
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
      live weights' (cuDNN deterministic); a .msgpack refused naming M11;
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
  7e. probe_analysis' probe_granule over 4 structured granules [128, 512,
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
Prints the card's name and power limit first, each phase's seconds, each
redesigned kernel's time against its time before the redesign
(KERNEL_PREV, K1_PREV), one {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no
result, when there is no CUDA device or the package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
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
# for 20 steps, logging every 5 and plotting every 10 so that the curves
# are drawn, and saving at the last step. 6d's fp32 check keeps the three
# levels (the head reads a latent 4x smaller than the tile, as the pooled
# targets are) at batch 2.
VAE_L2_HIDDEN = (512, 512)
VAE_L2_SHARDS, VAE_L2_TILES, VAE_L2_SLOTS, VAE_L2_SWAP = 4, 32, 2, 5
VAE_L2_EQ_SWAP, VAE_L2_EQ_BATCHES, VAE_L2_CLI_STEPS = 3, 12, 20
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
# 7e: configs/demo/flagship_probe.yaml's values over 4 structured granules
# of 512 tracks (2048 cut to 512 for the phase's time; PERF.md section 4).
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
ANALYSIS_PROBE_GRANULES, ANALYSIS_PROBE_SHAPE = 4, (128, 512, 1028)
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
# 3d profiles each scheduler over the first requests of the mix (prompts
# 32-256), not all 64: the profiler's record of a whole run takes minutes.
LM_PROFILED = 8


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
    """Record the argument shapes of every kernel call the path makes, each
    tagged with the run (tile batch or granule) that made it."""
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

    saved = (cuda_gn.gn_stats, cuda_gn.gn_apply, cuda_gn_conv.gn_act_conv3x3)

    def stats(x, num_groups, eps=1e-6):
        calls["K1a"].append(((tuple(x.shape), num_groups, eps), run))
        return saved[0](x, num_groups, eps)

    def apply(x, st, scale, bias, act=None):
        calls["K1b"].append(((tuple(x.shape), act), run))
        return saved[1](x, st, scale, bias, act)

    def conv(x, scale, bias, weight, conv_bias, num_groups, eps=1e-6,
             act="gelu", packed=None):
        calls["K2"].append(((tuple(x.shape), weight.shape[0], num_groups, eps,
                             act), run))
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


def lm_path(dev, gen, rows: dict) -> dict:
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
    exported = exported_serving(dev, model, reqs, eager_tokens)
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
    run eagerly (``eager``: the same model, nothing captured), from the
    same caches and inputs: first at the capture's position (and table),
    then at another; the outputs and the caches afterwards compared bit
    for bit, and the K3/K4 launches of one more replay counted. Returns
    (call, bitwise, launches a replay, launches wanted) tuples."""
    import numpy as np
    import torch

    from tempo_tpu_torch.ops import cuda_decode

    dev = surface.device
    vocab = surface.cfg.in_size
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


def exported_serving(dev, model, reqs, eager_tokens: dict) -> dict:
    """3d: GPT-2-small exported and loaded (device None: CUDA); (i) every
    captured call bitwise its eager call; (ii) the 64 requests through
    cli/serve_lm.py's functions with a dict config under each scheduler,
    the paged server's greedy completions equal to 3b's eager server's;
    (iii) one POST /v1/completions over loopback equal to batch mode.
    Returns the metrics."""
    import tempfile

    from tempo_tpu_torch.cli.serve_lm import _serve_batch, build_server
    from tempo_tpu_torch.infer import export_lm
    from tempo_tpu_torch.ops import cuda_decode

    result = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        art = export_lm.export_lm(model.state_dict(), model.config,
                                  tmp / "lm", max_seq=LM_CACHE,
                                  decode_chunk=LM_K, page_size=LM_PAGE)
        prefill, _, meta = export_lm.load_exported_lm(art)
        result["export_load_s"] = time.perf_counter() - t0
        surface = prefill.__self__
        eager = export_lm._Surface(surface.model, surface.meta,
                                   captured=False)

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
            # the device busy share over 8 requests, and the decode kernels
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
    counted themselves), with the counts of device kernels and host
    operators and the host operators of most self time; None where the
    profiler gives no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per, kernels, host_ops, host = {}, 0, 0, {}
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
            "device_kernels": kernels, "host_ops": host_ops,
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
        for shape, act in sorted({k for k, _ in calls["K1b"]}, key=str):
            fn_bwd[f"K1 {list(shape)} {act}"] = check_k1_bwd(
                gen, shape, groups, eps, act)
        for shape, f, grp, ep, act in sorted({k for k, _ in calls["K2"]},
                                             key=str):
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
        head = sorted({k for k, _ in calls["K1a"] if k[2] == K1_HEAD[1]},
                      key=str)
        fn_bwd = {}
        saved_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for shape, groups, eps in head:
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


def hold_kernels(dev, gen, calls: dict) -> list:
    """K1a, K1b and K2 against their plain versions at every distinct shape
    in ``calls`` (phase 2's tolerances, random inputs on the card)."""
    import torch

    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

    out = []
    with torch.inference_mode():
        for shape, groups, eps in sorted({k for k, _ in calls["K1a"]},
                                         key=str):
            x = randn(gen, *shape, dtype=torch.bfloat16)
            err, ok = max_err(cuda_gn.gn_stats(x, groups, eps),
                              cuda_gn.gn_stats_plain(x, groups, eps),
                              STATS_TOL)
            out.append({"kernel": "K1a", "x": list(shape), "eps": eps,
                        "max_abs_err": err, "ok": ok})
        for shape, act in sorted({k for k, _ in calls["K1b"]}, key=str):
            x = randn(gen, *shape, dtype=torch.bfloat16)
            c = shape[-1]
            scale, bias = 1 + randn(gen, c, scale=0.1), randn(gen, c,
                                                              scale=0.1)
            st = cuda_gn.gn_stats_plain(x, 8, 1e-6)
            err, ok = max_err(cuda_gn.gn_apply(x, st, scale, bias, act),
                              cuda_gn.gn_apply_plain(x, st, scale, bias, act),
                              BF16_TOL)
            out.append({"kernel": "K1b", "x": list(shape), "act": act,
                        "max_abs_err": err, "ok": ok})
        for shape, f, groups, eps, act in sorted(
                {k for k, _ in calls["K2"]}, key=str):
            c = shape[-1]
            x = randn(gen, *shape, dtype=torch.bfloat16)
            scale, bias = 1 + randn(gen, c, scale=0.1), randn(gen, c,
                                                              scale=0.1)
            weight = torch.empty((f, c, 3, 3), device=dev).uniform_(
                -(9 * c) ** -0.5, (9 * c) ** -0.5, generator=gen)
            cb = randn(gen, f, scale=0.01)
            packed = cuda_gn_conv.pack_conv3x3_weight(weight, torch.bfloat16)
            err, ok = max_err(
                cuda_gn_conv.gn_act_conv3x3(x, scale, bias, weight, cb,
                                            groups, eps, act, packed),
                cuda_gn_conv.gn_act_conv3x3_plain(x, scale, bias, weight, cb,
                                                  groups, eps, act),
                BF16_TOL)
            out.append({"kernel": "K2", "x": list(shape), "f": f,
                        "config": cuda_gn_conv.choose_config(*shape, f),
                        "max_abs_err": err, "ok": ok})
            del x
    return out


def analysis_path(dev, rows: dict, keep: Path, live: dict) -> dict:
    """The VAE evaluation and analysis path on the flagship (phase 7):
    (a) cli/evaluate_reconstruction.run over 5b's two checkpoints and a
    shard of 32 flagship tiles, against the same sweep through the plain
    versions; (b) load_params of 5b's and 6c's checkpoints against the live
    weights, bit for bit, and a .msgpack refused; (c) one structured
    granule [131, 2048, 1028] through encode_granules' per-granule
    function: the device normalize against numpy's and float64, the latent
    against the plain path, the metrics on the card against numpy's; (d)
    PCA-RGB of that granule and its reconstruction from pixels drawn as
    extract_pca draws them; (e) probe_analysis' per-granule function over
    4 structured granules [128, 512, 1028] encoded by 6c's checkpoint, and
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
        plain = evaluate_checkpoints(model, exp_dir, tiles, batch,
                                     evaluation["metrics"], verbose=False,
                                     pattern=evaluate_reconstruction
                                     .DEFAULT_PATTERN)
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
    (keep / "ckpt_step=000001.msgpack").write_bytes(b"")
    try:
        load_params(keep / "ckpt_step=000001.msgpack", twin)
        refused = "not refused"
    except NotImplementedError as e:
        refused = str(e)
    print(f"[analysis] 7b load_params, posterior mean of {batch} tiles bit "
          f"for bit the live weights': 5b's checkpoint {same_vae}, 6c's L2 "
          f"checkpoint {same_l2}, its vae.* into the base VAE "
          f"{same_nested}; a .msgpack: {refused}", flush=True)
    if not (same_vae and same_l2 and same_nested and "M11" in refused):
        fail("load_params did not give the live weights, or took a .msgpack")
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
        from tempo_tpu_torch.ops.norms import ACTIVATIONS
    except ImportError as e:
        fail(f"the tempo_tpu_torch package is not beside this script: {e}")

    print(smi_line(), flush=True)
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

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def act_fn(act):
        return ACTIVATIONS[act] if act else (lambda t: t)

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

    def count(lst):
        out = {}
        for key, run in lst:
            out.setdefault(key, {"tile": 0, "granule": 0})[run] += 1
        return out

    with torch.inference_mode():
        # K1a: statistics at every shape the path gives it; each is bitwise
        # the same on a repeat and, in a batch, for each sample alone.
        r = row("K1a", "tempo_tpu_torch/csrc/gn.cu",
                "tempo_tpu/ops/pallas_gn.py:66",
                "torch.var_mean over the [B,HW,G,C/G] view", copy_ms=0.0)
        for (shape, groups, eps), n in count(calls["K1a"]).items():
            b, c = shape[0], shape[-1]
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            got = cuda_gn.gn_stats(x, groups, eps)
            want = cuda_gn.gn_stats_plain(x, groups, eps)
            err, ok = max_err(got, want, STATS_TOL)
            repeat = torch.equal(got, cuda_gn.gn_stats(x, groups, eps))
            alone = all(torch.equal(got[i:i + 1], cuda_gn.gn_stats(
                x[i:i + 1], groups, eps)) for i in range(b))
            checks_ok &= ok and repeat and alone
            # A yardstick of the card's memory rate: a device-to-device
            # copy of half of x moves as many bytes as K1a reads.
            half = x.view(-1)[: x.numel() // 2]
            dst = torch.empty_like(half)
            extra = {"bitwise_repeat": repeat, "bitwise_alone": alone,
                     "copy_ms": time_ms(lambda: dst.copy_(half))}
            nbytes = x.numel() * 2 + got.numel() * 4
            xg = x.view(b, -1, groups, c // groups)
            add(r, {"x": list(shape),
                    "split": cuda_gn.choose_stats_split(
                        x.numel() // (b * c), c, x.dtype)}, n, err, ok,
                time_ms(lambda: cuda_gn.gn_stats(x, groups, eps)),
                time_ms(lambda: cuda_gn.gn_stats_plain(x, groups, eps)),
                1e3 * nbytes / HBM_BYTES_PER_S, "bytes",
                time_ms(lambda: torch.var_mean(xg, dim=(1, 3),
                                               correction=0)), extra)
            del x, xg, half, dst
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

        # K1b: apply from given statistics at the path's shapes and at the
        # two shapes asked of K1. The library GroupNorm computes the
        # statistics too, so it stands beside K1 whole (K1a + K1b).
        r = row("K1b", "tempo_tpu_torch/csrc/gn.cu",
                "tempo_tpu/ops/pallas_gn.py:105",
                "F.group_norm + activation: statistics and apply; compare "
                "with k1_whole_ms", k1_whole_ms=0.0)
        k1_shapes = count(calls["K1b"])
        for key in [((8, 64, 64, 512), "gelu"), ((8, 16, 16, 128), None)]:
            k1_shapes.setdefault(key, {"tile": 0, "granule": 0})
        for (shape, act), n in k1_shapes.items():
            c = shape[-1]
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            scale, bias = affine(c)
            st = cuda_gn.gn_stats_plain(x, 8, 1e-6)
            want = cuda_gn.gn_apply_plain(x, st, scale, bias, act)
            err, ok = max_err(cuda_gn.gn_apply(x, st, scale, bias, act), want,
                              BF16_TOL)
            whole_err, whole_ok = max_err(
                cuda_gn.fused_group_norm_act(x, scale, bias, 8, 1e-6, act),
                want, BF16_TOL)
            checks_ok &= ok and whole_ok
            sb, bb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
            nbytes = 2 * x.numel() * 2 + st.numel() * 4 + 2 * c * 4
            add(r, {"x": list(shape), "act": act}, n, max(err, whole_err),
                ok and whole_ok,
                time_ms(lambda: cuda_gn.gn_apply(x, st, scale, bias, act)),
                time_ms(lambda: cuda_gn.gn_apply_plain(x, st, scale, bias,
                                                       act)),
                1e3 * nbytes / HBM_BYTES_PER_S, "bytes",
                time_ms(lambda: act_fn(act)(torch.nn.functional.group_norm(
                    nchw(x), 8, sb, bb, 1e-6))),
                {"k1_whole_ms": time_ms(
                    lambda: cuda_gn.fused_group_norm_act(x, scale, bias, 8,
                                                         1e-6, act))})

        # K2 at every distinct shape of the path. The check holds the whole
        # wrapper (K1a statistics, then K2) against the plain chain; "ms"
        # times the K2 launch alone from precomputed statistics, beside the
        # plain version of that step and cuDNN's conv of the activated input.
        # The library chain computes the statistics too, so it stands beside
        # whole_ms (K1a + K2).
        r = row("K2", "tempo_tpu_torch/csrc/gn_conv.cu",
                "tempo_tpu/ops/pallas_gn_conv.py:53",
                "F.group_norm + activation + F.conv2d (cuDNN); compare with "
                "whole_ms", whole_ms=0.0, library_conv_ms=0.0)
        for (shape, f, groups, eps, act), n in count(calls["K2"]).items():
            b, h, w, c = shape
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            scale, bias = affine(c)
            weight = torch.empty((f, c, 3, 3), device=dev).uniform_(
                -(9 * c) ** -0.5, (9 * c) ** -0.5, generator=gen)
            cb = 0.01 * torch.randn(f, generator=gen, device=dev)
            packed = cuda_gn_conv.pack_conv3x3_weight(weight, torch.bfloat16)
            got = cuda_gn_conv.gn_act_conv3x3(x, scale, bias, weight, cb,
                                              groups, eps, act, packed)
            want = cuda_gn_conv.gn_act_conv3x3_plain(x, scale, bias, weight,
                                                     cb, groups, eps, act)
            err, ok = max_err(got, want, BF16_TOL)
            checks_ok &= ok
            del got, want
            st = cuda_gn.gn_stats(x, groups, eps)
            flops = 2 * b * h * w * 9 * c * f
            nbytes = ((x.numel() + packed.numel() + b * h * w * f) * 2
                      + st.numel() * 4)
            by = ("operations" if flops / PEAK_FLOPS["bfloat16"]
                  >= nbytes / HBM_BYTES_PER_S else "bytes")
            bound = 1e3 * max(flops / PEAK_FLOPS["bfloat16"],
                              nbytes / HBM_BYTES_PER_S)
            sb, bb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
            wb, cbb = weight.to(torch.bfloat16), cb.to(torch.bfloat16)
            activated = nchw(cuda_gn.gn_apply_plain(x, st, scale, bias, act))
            ms = time_ms(lambda: cuda_gn_conv.conv3x3_from_stats(
                x, st, scale, bias, weight, cb, act, packed))
            config, split = cuda_gn_conv.choose_config(b, h, w, c, f)
            add(r, {"x": list(shape), "f": f, "config": config,
                    "split": split}, n, err, ok, ms,
                time_ms(lambda: cuda_gn_conv.conv3x3_from_stats_plain(
                    x, st, scale, bias, weight, cb, act)),
                bound, by,
                time_ms(lambda: torch.nn.functional.conv2d(
                    act_fn(act)(torch.nn.functional.group_norm(
                        nchw(x), groups, sb, bb, eps)), wb, cbb, padding=1)),
                {"whole_ms": time_ms(lambda: cuda_gn_conv.gn_act_conv3x3(
                    x, scale, bias, weight, cb, groups, eps, act, packed)),
                 "library_conv_ms": time_ms(
                     lambda: torch.nn.functional.conv2d(activated, wb, cbb,
                                                        padding=1)),
                 "gflop": flops / 1e9, "tflops": flops / ms / 1e9})
            del x, activated

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
    lm = lm_path(dev, gen, rows)

    seconds["lm_serving"] = time.perf_counter() - t_phase

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
        "export": export, "prep": prep,
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
