#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mudg_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19] [--out DIR] [--profile]
    torchrun --nproc_per_node N chip_smoke.py --phases 16      (phase 16 over N cards)

Phases:
  1. device and build: the card's name and power limit, torch and CUDA
     versions, and the nvcc build of every kernel from csrc/, with ptxas's
     register and spill report (it fails if kernels 2, 9 or 10's wgmma
     kernels, fp32 kernels 5 and 6's tf32 wgmma kernels, kernel 12's five,
     kernel 13's forward and backward or kernel 11's five kernels spill,
     NO_SPILL);
  2. each kernel against its plain PyTorch version at every shape of an
     MDM512 and an MDM1024 UNet forward, plus one long flash-attention shape
     (random bf16 inputs, kernels 1-2's logits ~N(0, 9); max|diff| <= 3e-2 *
     max|ref| on the output less the residual input where the kernel adds
     one; kernel 5's logsumexp within 1e-2; a plain version with a planted
     fault must miss that bound: zeroed attention, half the keys, kernel 1
     with the softmax scale applied twice, kernel 2 with heads 0 and 1's key
     projections swapped (a mis-packed head order), kernel 3 with W1's value
     and gate halves swapped, kernel 4 with its taps reversed (t - 1 and t +
     1 swapped); kernel 2 also at a tail shape, rows
     % 128 == 64; kernel 4 also at a DC offset of 1e3 against
     its plain version in float64, where the one-pass variance must miss;
     kernel 4 reruns bit for bit), with the median CUDA-event time of the
     kernel, of its plain version and, for kernel 5, of torch's
     scaled_dot_product_attention, and the YARDSTICKS (library calls for part
     of a kernel's work, never on the port's path: kernels 2 and 3's products
     alone in cuBLAS, kernel 1's attention core alone in SDPA, kernel 4's
     product alone in cuBLAS), beside the least time the card could take for
     the same work (bytes or operations at its peaks); then the backward
     kernels 6, 9 and 10 against their plain backward versions at every
     training shape of a batch-1 micro-step at MDM512 and at MDM1024
     (kernel 6 at each spatial self-attention length, each after kernel 5's
     forward at that shape, kernel 9 at C = 320 and 512, kernel 10 at every
     FF site; peaked logits for kernels 6 and 9; each gradient
     within max|diff| <= 5e-2 * max|ref|; planted faults: kernel 6 with delta
     dropped and with half the keys, kernel 9 without the softmax
     Jacobian's row-sum term, kernel 10 without the g * pdf(g) term, each of
     which must miss it), kernel 6 beside the backward of torch's
     scaled_dot_product_attention under autograd (timed only), kernel 10
     beside its six products alone in cuBLAS and kernel 9 beside its five
     products per stage (yardsticks); kernels 6, 9 and 10 rerun bit for bit
     at every shape; kernels 5 and 6 in fp32 (kernel 5
     at MDM512 ds1 and ds2 and MDM1024 ds1, ds2 and ds4, kernel 6 at the
     MDM512 ds1 and ds2 training shapes; within 1e-5 * max|ref| and lse
     within 1e-5, each gradient within 1e-4 * max|ref|; the same planted
     faults and "1xTF32", the plain version on operands rounded once to
     TF32; bounds from three TF32 products per product at 495 TFLOP/s,
     with the FMA bound at 67 TFLOP/s beside them, SDPA in fp32 as the
     yardstick) and both dtypes at a tail shape, 3 x 576 x 3 heads (the
     last 128-row block half empty);
  3. one full-width MDM512 UNetConfig() forward at batch 2 (40x64 latent,
     re-randomized weights) on three paths: kernels bf16, plain bf16, plain
     fp32 (TF32 off, impl="plain"); the kernel path's relative L2 error against fp32 must
     stay within 1.5x the plain bf16 path's + 5e-3, and every kernel must
     have been launched at its MDM512 sites (10 / 11 / 33 / 20 / 0);
  4. the MDM512 main path: `sample_clip`, 25-step DDIM with 2-point CFG
     (guidance 7.5, rescale 0.7, eta 1.0, uniform_trailing) and a VAE
     decode of 16 frames at 320x512, bf16, seeded; the launch counts are
     reset just before it and read just after;
  5. phase 3 at MDM1024 (72x128 latent, the plain fp32 attention in chunks
     of the (batch, head) pairs), sites 10 / 11 / 33 / 20 / 5;
  6. the MDM1024 main path: `sample` at the `mdm1024` preset for one task,
     from seeded sparse RGB and depth videos (1, 16, 576, 1024, 3) and seeded
     token ids through the text and image towers, the resampler, the VAE
     encode, 25-step DDIM with 2-point CFG (as phase 4) and the decode, all
     five sub-models random, bf16; counts reset just before, read just after;
     then each stage of the clip outside the UNet timed alone (host clock);
  7. full-width MDM512 training: `MDMConfig()`, all five sub-models random
     (UNet and resampler fp32 masters, the frozen towers bf16), batch 1,
     accumulation 2, seeded (1, 16, 320, 512, 3) dense, sparse and depth
     videos, seeded token ids and a class label, bf16 compute, remat=True:
     one micro-step's trainable gradients with dropout off and the same
     draws on three paths (kernels bf16, plain bf16, plain fp32 with TF32
     off), the kernel path's relative L2 error against fp32 within 1.5x
     the plain bf16 path's + 5e-3; then a warm-up and three timed optimizer
     steps (host clock, synchronized) with finite loss and gradient norm,
     moved parameters, launches at exactly the training sites x
     micro-steps (counts reset just before, read just after), peak memory;
     then the step's layers each timed alone (VAE encode, towers, the
     loss's forward, a micro-step, the AdamW update);
  8. one stage-2 optimizer step at MDM1024 (`stage2_config()`, 576x1024,
     `temporal_frozen_mask` as the grad mask): the frozen temporal leaves move by weight decay
     alone, kernel 6 runs at L = 9216 inside the path, launches at the
     MDM1024 training sites x 2 micro-steps;
  9. kernel 13 (3DGS tile compositing) forward and backward against their
     plain versions (float64 inside) at four scenes: (a) the refine-gs
     default, 160x256 and a 200k-gaussian slab, (b) scripts/gsbench.py's
     1M-gaussian slab at 960x640 with trained-scene-like opacities, (c) the
     dense-occlusion scene of tests/test_tile_raster.py at 960x640, (d) (a)
     with 19 semantic classes (npay 23). Color, depth and T within 1e-4 *
     max|ref|; each per-gaussian gradient field (through the pair gather and
     the projection) within 2e-3 * max|ref| + 1e-8; planted faults (pairs
     composited back to front; the backward without its occlusion term)
     must miss those bounds; two backward runs bit for bit; kernel times
     (each call alone, and queued: 10 calls back to back) and plain times
     beside a bound from the (pair, pixel) evaluations this data needs
     and the contributing ones among them (FP32 operations at 67 TFLOP/s)
     and the bytes each direction moves (at 3.35 TB/s); per scene the tile
     count, the heaviest tile's pairs and the largest `last`; with
     --profile, one forward and backward at (b) under the profiler;
 10. the 3DGS refinement path: `apps/refine_gs.refine` on 500k seeded slab
     points (0.25 m splats) at capacity 1M, 24 views of a forward track at
     960x640 whose targets kernel 13 rendered from a seeded true set, 300
     steps with densify_every=100, the holdout renders with PSNR and the
     PLY export; loss falls, no pair dropped, some densify clones or splits,
     kernel 13 launched exactly steps + renders (forward) and steps
     (backward), counts reset just before, read just after; s/step, peak
     memory, each densify and each layer of a step timed alone;
 11. kernels 11 (GroupNorm, LayerNorm) and 12 (short-KV and packed
     attention) against their plain versions at every site shape that the
     switch path reaches in an MDM512 and an MDM1024 UNet forward (batch
     2), in an MDM512 training micro-step (batch 1), in the MDM1024 clip's
     resampler and in the VAE at a training encode chunk, and the packed
     kernel at the temporal attention's (B*H*W, 16, heads, 64), all bf16,
     plus GN, LN and short-KV in fp32; beyond every MuDG site, short-KV's
     "stream" shapes (Lk 256 and 1024 at head dim 64, Lk 77 at 128; K and
     V in chunks past 128 keys) in both dtypes and the packed kernel at
     PACKED_EXTRA (T = 1, 8, 64, head dim 128), checked and timed but not
     summed (max|diff| <= 3e-2 * max|ref| in
     bf16, 1e-5 * max|ref| in fp32; fp32 short-KV also against "1xTF32",
     with its bound from three TF32 products per product and the FMA bound
     beside it, and rerun SKV_RERUNS times bit for bit), GN in fp32 at a DC
     offset of 1e3 against the plain version run in float64; planted faults: GN with the one-pass variance (at the
     offset) and with the channel-to-group map shifted by one channel, LN
     without its mean subtraction, short-KV with the padded keys unmasked
     and with half the keys (with one key: the next head's value), packed
     with another sequence's keys; each
     autograd op's gradients against autograd of the plain math (within
     5e-2 * max|ref|); GN and LN rerun bit for bit; times beside the bound
     and torch's group_norm (channels-last), layer_norm and
     scaled_dot_product_attention (yardsticks only); for each GN and LN
     shape also its launch plan (the GN's cluster size and rows per CTA or
     its two passes; the LN's kernel, row or tile, and its lanes, tile and
     grid), its device time per call and per launch under torch.profiler
     and the wrapper's host time per call (kernel 12's cases too, with
     their launch plans), and per configuration their sums
     over one UNet forward's sites; the LN's two kernels side by side at
     every LN shape (each within the tolerance, device time per launch from
     CUDA graphs, beside the plan's pick) and the card's answers to the GN
     planner's cluster questions (the report's "kernel11_plans"); then the
     packed kernel's path, its public function at those three shapes,
     counts reset just before and read just after;
 12. the switch path, MUDG_FUSED_NORMS=1 and MUDG_SHORT_ATTN=1 set inside
     it and restored after: (a) phases 3 and 5's UNet forwards on it (the
     same gate against fp32 with the switches unset; launches at kernels
     1-5's sites and kernels 11-12's as the JAX predicates admit them,
     SWITCH_SITES; and an fp32 forward with impl="auto", where kernels 11
     and 12 and kernel 5 take fp32 and kernels 1-4 do not run, within 1e-4
     relative L2 of the fp32 plain forward, launches at SWITCH_SITES_F32,
     timed (median of 3, as phases 3 and 5's forwards)),
     (b) one MDM1024 `sample` clip as phase 6 with its s/clip beside phase
     6's, (c) one MDM512 training micro-step's gradients as phase 7's check,
     with kernel 11-12 launches at the training sites;
 13. the JAX package's six kernel opt-out switches (MUDG_FUSED_SPATIAL,
     MUDG_STREAM_SPATIAL, MUDG_FLASHBLOCK, MUDG_FUSED_FF,
     MUDG_FUSED_TEMPORAL, MUDG_FUSED_TCONV), inside phases 3 and 5's set-up:
     one bf16 UNet forward per configuration with each set to "0" alone and
     one with all six, set in-process and restored after; launches at
     SWITCHES_OFF, the phase-3/5 gate against fp32; each of these forwards
     timed (one call after the checked one), beside the kernel path's;
 14. the serving path (apps/serve.py, apps/render_infer.py) at UNet batch
     6, the 3-task batch with 2-point CFG: (a) phase 3 and phase 5's forward
     at batch 6, the same gate and sites, then one forward each under the
     profiler (the device's busy time against the wall time), and phase 5's
     at batch 9 (3-point CFG, --multiple_cond_cfg); (b) kernels 1-5 against
     their plain versions at every shape of the batch-6 forwards, bf16 and
     fp32 (the shapes a meta-device trace of the forwards gives, which must equal
     forward_keys; phase 2's tolerances and planted faults, each timed
     median of 3); (c) a warm server built as serve.main builds it
     (`presets.mdm512()`, init_mdm on the card from a generator seeded 0,
     bf16, HashTokenizer, 5 DDIM steps with guidance 7.5, rescale 0.7, eta
     1.0, uniform_trailing, fps 10) answering three requests through
     render_windows on seeded in-memory windows of 16 frames at 320x512:
     r1 2 windows (the carry), r2 another prompt and seed, r3 task_serial;
     each clip (3, 16, 320, 512, 3) finite in [-1, 1], launches exactly 10 x
     the MDM512 sites per sampler call (counts reset just before each
     request, read just after), window 2's sparse condition the carried
     color with frame 0 the GT; s/request, s/window, the UNet forward's
     share of a batched window (not measured for task_serial) and peak
     memory, beside the card's name and power
     limit; (d) the checkpoint path: the served UNet loaded from an fp16
     MuDG .ckpt (seeded random weights, written in memory) by
     train/checkpoint.py, cast and packed as the apps do, one batch-6
     forward against the plain bf16 and fp32 paths of the same weights
     (phase 3's gate and sites);
 15. the training app (apps/train_mdm.py) at stage 1, full MDM512 width
     (`MDMConfig(base_scale=0.7)`, 320x512, 16 frames), all weights random
     from a seed, HashTokenizer, batch 1, accumulation 2, remat dots_attn,
     EMA, over an in-memory BatchLoader (prefetch 2) of SeededClips, whose
     items have WaymoDataset.load_item's keys, shapes and dtypes: (a)
     `train` for 3 steps with validation every 2 steps over 2 batches, a
     10-step sample at step 3 (kept in memory) and SIGUSR1 sent at step 2:
     finite records in metrics.jsonl, the trainable leaves moved, the EMA
     apart from them, the parameters bit for bit as they were after the
     sample, step_2, trainstate_2 and final written (disk space checked
     first) and final loaded strictly by render's load_params, launches at
     the dots_attn sites x micro-steps plus the validation forwards and the
     sample's fp32 flash sites; s/step, peak memory, each artifact's size
     and write and read seconds; (b) --auto_resume from trainstate_2 alone:
     params, mu, nu, count and EMA bit for bit as kept in memory at step
     2, then step 3; (c) one micro-step (dropout off, the same draws)
     under remat=False and each of the nine policies, each within 1e-3
     relative L2 of full recompute's gradients (bit-equality printed),
     launches at policy_launches (kernels 5 and 2's forwards not replayed
     under dots_attn), ms (one micro-step, no warm-up) and peak memory
     per policy; (d) precompute's
     device part (`data/latents.encode_moments`) on 16 seeded frames at
     320x512 equal to encode_moments_video, the fp16 .npy round trip exact,
     then 1 app step in the moments form, s/step beside (a)'s. The work
     directory (_phase15 in the checkout) is deleted at the end;
 16. the multi-GPU paths (mudg_tpu_torch/parallel/, the sharded train step)
     over a real process group: NCCL, one rank on this card at
     tcp://localhost:<free port>, or the ranks torchrun started (WORLD_SIZE,
     one card each): (a) one MDM512 optimizer step (`MDMConfig()`, all
     five sub-models random, one seeded clip of 16 x 320x512 per data rank,
     accumulation 2, dots_attn (full recompute above one rank, so that the
     one-process step at the global batch fits a card), dropout off (each
     data rank draws its own masks), the same draws) through data
     parallelism with ZeRO-2 moments against the one-process step made
     first on the same card: loss and gradient norm
     within 1e-3 relative, mu within 2e-2 and nu 4e-2 relative L2, the
     parameters' update (after - before) within 0.25 relative L2 (bf16
     gradients; bit for bit is expected at one rank and printed, see
     PAR_METRIC_TOL); launches at exactly the
     training sites x micro-steps, counts reset just before the step and
     read just after; a planted fault, the gradients averaged over the
     microbatches twice (again in the all-reduce buckets), must miss these
     gates; (b) the same step with FSDP (FSDP2 over `data`); (c) one bf16
     UNet forward at batch 2 through the SP path (`seq` over every rank)
     and through the TP path (data x model, model 2 from two ranks on),
     each within phase 3's gate against the plain fp32 forward (TF32 off):
     relative L2 within 1.5x the plain bf16 path's + 5e-3 (their layouts
     differ, so bf16 rounds otherwise: bit equality with the plain bf16
     result is printed, not required); (d) a 4-step bf16 `sample` (pixels
     and token ids to the decoded clip) under SP against the one without,
     the same gate against the fp32 sample. s/step (the one-process step
     after a warm-up step), peak GiB, the gradient all-reduce's bucket
     count and seconds, forward ms (the second of two calls), sample s;
 17. int8 serving and the conditions app: (a) in the full-width MDM512
     UNet forward (batch 2, bf16, re-randomized weights) under --quantize
     int8, `linear_i8`, `conv_i8` and `temporal_conv311_i8` at every shape
     the forward gives them: each int32 accumulator equal to the float64
     product of the same int8 codes, each fp32 output within QUANT_ULPS fp32
     ulps of its float64 dequantization, and two planted faults that must
     miss that bound (the weight quantized per input channel with its
     scales on the output axis; a conv's activation scale per sample
     instead of over the batch); (b) that forward unquantized and under
     each of the four --quantize modes, each at >= 15 dB SNR against the
     unquantized bf16 one, launches at SITES with QUANT_SITES (the JAX
     dispatch's sites per mode), weight bytes (size_report), forward ms
     (median of 3) and peak memory above the weights, and a yardstick: one
     ds1 linear's product in `_int_mm` against bf16 `torch.matmul`, and its
     W8A8 layer against `F.linear` in bf16; (c) one 3-task
     window at batch 6 (5 DDIM steps) from a server built as `serve`
     builds it with --quantize int8-conv, then the same window from the
     `quantize` app's artifact, bit for bit (an fp16 MDM512 file and the
     artifact written under _phase17 in the checkout, deleted after); (d)
     `conditions --render_virtual --six_frame_depth` on a seeded synthetic
     scene at 1920x1280 (2M background points, three cars, two frames) on
     the card and on the CPU, the maps equal but at rounding ties, the app's
     seconds on each and one sparse frame's render time;
 18. the learned offline stages and eval on a seeded scene at the Waymo
     FRONT camera's 1280x1920 (three frames, 5% of each frame's pixels with
     a lidar depth; every weight random from a seed; fp32 with TF32 off;
     images kept in memory: the card's machine has no OpenCV; files under
     _phase18 in the checkout, deleted after): (c) the segment app with
     SegFormer-B3 from an HF-named pytorch_model.bin, each frame's fp32
     logits within 1e-4 relative L2 of the same module in float64, the
     class ids float64's but where its top-2 margin is below 1e-3 x
     max|logit|; (b) the densify app (DepthLab, two full-width SD2 UNets and
     the SD VAE, from a 7 GB checkpoint directory in load_depthlab_dir's
     layout with the diffusers VAE names) on the first frame at its
     defaults but for the steps (5 DDIM steps, not 50, at strength 0.8: one
     write pass, 4 read passes),
     finite outputs, the sky of (c)'s maps at 100 m, launches at kernel 5's
     10 write-pass sites, then densify_scene again from the same directory
     bit for bit; s/frame, each pass's ms, peak GiB; (a) the write pass and
     one read pass (160x240 latent) on four paths, kernels fp32 within 1e-4
     relative L2 of plain fp32, kernels bf16 within 1.5x the plain bf16
     path's error + 5e-3, launches at DEPTHLAB_SITES; kernel 5 in fp32 and
     bf16 at L = 38400 and 9600 against its plain version (phase 2's
     bounds, faults and SDPA yardstick); the read pass's self-attentions
     alone, plain and in SDPA; (d) the eval app's three tasks over 16 pairs
     at 576x1024 (LPIPS from a seeded lpips-layout file) on the card and on
     the CPU, the PSNR, depth and mIoU rows equal, each pair's SSIM and
     LPIPS within 1e-5 relative of float64, ms per frame;
 19. the host ETL and the options that no MuDG config sets (files under
     _phase19 in the checkout, deleted after), from a seeded tfrecord that
     this script's own protobuf encoder writes at Waymo's published sensor
     sizes (five cameras, FRONT, FRONT_LEFT and FRONT_RIGHT at 1920x1280,
     SIDE_LEFT and SIDE_RIGHT at 1920x886, each a real JPEG of a smooth
     seeded image; the TOP lidar's 64x2650 range image with its per-pixel
     pose image; four short lidars at 200x600; 30 labelled boxes, 10 of them
     moving), 6 frames where a segment has about 198: (a) `preprocess` on
     the card and on the CPU, scenario.pt arrays within 1e-12 relative,
     every npz array within one fp32 ulp, the JPEGs byte for byte, seconds
     split into reading and decoding, ray math, npz and JPEG writes; (b)
     `build_clouds` with all five cameras on the card and on the CPU from
     the card's scene, the background, object and per-frame clouds as
     sorted rows within 1e-6 relative, except the rows that points at
     pixel rounding ties or box faces may move (counted), seconds split
     into npz reads, JPEG decodes, projection and colour, segmentation,
     voxel downsampling and PLY writes; (c) `voxel_downsample` alone on a
     seeded 198-frame background (about 20M points, a 200 m track, 75 m
     range) at 0.1 m, the card's rows equal to the CPU's, ms on the card and
     s on the CPU; (d) the UNet options at full UNetConfig() width in the
     two UNets JAX takes them in (relative position, causal and joint task
     attention at batch 3, one clip a task, at the MDM512 latent; the
     cross-context temporal path at batch 2 at the MDM1024 latent, after it
     raises JAX's ValueError at the MDM512 one), kernels bf16, plain bf16
     and plain fp32 (TF32 off): phase 3's error rule, launches at
     OPTION_SITES, ms a forward; (e) masked DDIM and DPM-Solver++, DDIM's
     stochastic_encode and the full 1000-step ddpm_sample (v; eps and x0
     with clip_denoised) at the MDM512 latent with a seeded closed-form
     model_fn and the same draws, the card within 1e-5 relative of the CPU.
It prints the kernel table as one JSON line: "ms", "ms_queued" (calls queued
back to back, so the host's per-call cost hides behind the device's work),
"plain_ms", "bound_ms", "library_ms", "library_ms_queued" (the library call
queued the same way) and the YARDSTICKS (alone and "_queued") are one
UNet forward's worth of a forward kernel at each of the two
configurations, summed, and one batch-1 training micro-step's backward
at each configuration, summed, for a backward kernel (phase 2's per-call
medians or bounds times the sites; kernel 5 at the training lengths has
sites 0 there: checked and timed, not summed; phase 18's DepthLab shapes
join the row's "shapes" and its max_abs_err, not its sums, unless phase 2
did not run), and kernel 13's per-call times at scene (b); kernels 11 and 12 one UNet forward's worth at both
configurations (the packed kernel one call at each temporal shape);
"launches" is the count from the main paths (phases 4, 6, 7, 8, 10, the
packed path of phase 11, phase 12's fp32 forwards, clip and micro-step,
phase 13's forwards, phase 14's requests, phase 15's app runs and
policy micro-steps, phase 16's data-parallel and FSDP steps, phase 17's
served int8 windows, phase 18's segment, densify and eval runs and phase
19's option UNet forwards). Then the
card's name and power limit, and as its last line {"ok": true, "device":
{...}}. Any failed check raises and the
exit code is not 0. Without CUDA it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Callable, NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 3e-2          # max|diff| <= TOL * max|ref| (tests/test_attention.py:262,307)
BWD_TOL = 5e-2      # each gradient, the JAX gradient tests' (tests/test_attention.py:274-280)
LSE_TOL = 1e-2      # kernel 5's logsumexp, absolute, natural-log units
F32_LSE_TOL = 1e-5  # the same in fp32
F32_BWD_TOL = 1e-4  # kernel 6 in fp32: each gradient within 1e-4 * max|ref| (fp32 sums
                    # over L = 2560 keys in another order; its planted faults miss by O(1))
SEED = 0
# Phase 2 scales kernels 1 and 2's Wq and Wk by this, so the logits are
# ~N(0, 9) instead of ~N(0, 1): a peaked softmax whose output is O(1). With
# near-uniform weights over L = 9216 keys the attention term is ~0.02 and
# hides under one bf16 ulp of the residual it is added to. Kernel 5 adds no
# residual and keeps ~N(0, 1) logits, so its bf16-rounded q (scale and
# log2(e) folded in, as on the TPU) keeps its lse within LSE_TOL.
SHARPEN = math.sqrt(3.0)
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FLOPS = 989e12   # bf16 tensor cores
PEAK_FP32 = 67e12     # FP32 outside the tensor cores
PEAK_TF32 = 495e12    # TF32 tensor cores
# fp32 flash attention (kernels 5 and 6 in fp32) and fp32 short-KV (kernel
# 12) form each product from three TF32 products (3xTF32): their bound is
# TF32_PASSES x their operations at PEAK_TF32, with the FMA bound
# (PEAK_FP32) beside it
TF32_PASSES = 3
PEAK_BYTES = 3.35e12  # HBM3
# Mangled names of kernel instantiations that must not spill (phase 1 fails
# otherwise): kernel 2's q|k|v GEMM with its attention epilogue
# (wgmma_gemm_kernel<WG_TATTN, ..>), kernel 10's GEGLU backward tile
# (<WG_GEGLU_BWD, ..>) and the weight-gradient GEMM (kernels 9 and 10),
# kernel 9's attention-backward tile (<WG_TATTN_BWD, ..>) and fp32-output
# GEMM (<WG_F32, ..>), fp32 kernels 5 and 6's three tf32 wgmma kernels,
# kernel 12's (bf16 whole and streamed, fp32 whole and chunked, packed),
# kernel 13's forward and backward at every payload
# width, and kernel 11's five kernels (the GroupNorm's cluster kernel and
# two passes, the latter by their thread-count parameter, and the
# LayerNorm's row and tile kernels) at every instantiation; each is a
# regular expression searched in the name
NO_SPILL = ("wgmma_gemm_kernelILi3E", "wgmma_gemm_kernelILi4E", "wgmma_gemm_kernelILi5E",
            "wgmma_gemm_kernelILi6E", "wgmma_wgrad_kernel", "flash_fwd_tf32_kernel",
            "flash_bwd_dq_tf32_kernel", "flash_bwd_dkv_tf32_kernel", "short_kv_tf32_kernel",
            "short_kv_tf32_chunk_kernel", "short_kv_tma_kernel", "short_kv_stream_kernel",
            "packed_kernel", "composite_fwd", "composite_bwd", "gn_cluster_kernel",
            r"gn_(stats|apply)_kernelI\w*?Li(256|512)E", "ln_row_kernel", "ln_tile_kernel")
# Kernel sites of one UNet forward (batch 2, 16 frames) per configuration;
# inference launches no backward kernel and no 3DGS kernel, and kernels 11
# and 12 only with their switches set (phase 12)
NO_BWD = {"flash_attention_bwd": 0, "temporal_attn_bwd": 0, "geglu_ff_bwd": 0,
          "tile_composite": 0, "tile_composite_bwd": 0, "group_norm": 0, "layer_norm": 0,
          "short_kv_attention": 0, "packed_short_attention": 0}
SITES = {
    "mdm512": {"spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33, "gn_silu_tconv": 20,
               "flash_attention": 0, **NO_BWD},
    "mdm1024": {"spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33, "gn_silu_tconv": 20,
                "flash_attention": 5, **NO_BWD},
}
LATENT = {"mdm512": (40, 64), "mdm1024": (72, 128)}
# Kernel sites of one training micro-step (batch 1, 16 frames) under the JAX
# training dispatch (tests/test_torch_train.py holds them against the JAX
# predicates): kernel 5/6 at the spatial self-attention with L >= 512,
# kernels 2/9 where `bwd_eligible` holds (C <= 512: ds1 and init_attn),
# kernels 3/10 where `ff_bwd_eligible` and the FF kernel's m % 256 hold (the
# MDM512 middle block, m = 640, does not). Each backward kernel runs once per
# site; under remat the forward kernels run again in the backward except at
# init_attn, which is not checkpointed.
TRAIN_SITES = {"mdm512": {"flash_attention": 10, "temporal_attn": 6, "geglu_ff": 31},
               "mdm1024": {"flash_attention": 15, "temporal_attn": 6, "geglu_ff": 33}}
INIT_ATTN_SITES = {"temporal_attn": 1, "geglu_ff": 1}
# The forward kernels (of kernels 5, 2 and 3) that each remat policy's
# backward replay launches again, as the JAX gradient's jaxpr keeps them
# (tests/test_torch_remat.py counts both): a policy keeping attn_o and
# attn_lse / attn_h1 keeps kernels 5 and 2's outputs, one keeping blk_ff
# kernel 3's (its output is the block's), except_ff keeps everything but the
# GEGLU inners, dots keeps only products without batch dimensions.
REPLAYED = {"full": ("flash_attention", "temporal_attn", "geglu_ff"),
            "dots": ("flash_attention", "temporal_attn", "geglu_ff"),
            "dots_small": ("flash_attention", "temporal_attn"),
            "dots_ln": ("flash_attention", "temporal_attn"),
            "dots_attn": (),
            "except_ff": (),
            "dots_gn": ("flash_attention", "temporal_attn"),
            "convs": ("flash_attention", "temporal_attn"),
            "names": ("flash_attention", "temporal_attn")}
TRAIN_FRAMES = 16   # batch 1 x 16 frames
# Kernels 11 and 12 run only under MUDG_FUSED_NORMS=1 / MUDG_SHORT_ATTN=1
# (phase 12); the packed short attention has no model path (phase 11 drives
# its public function)
SWITCH_KERNELS = ("group_norm", "layer_norm", "short_kv_attention", "packed_short_attention")
OFF = dict.fromkeys(SWITCH_KERNELS, 0)
# Their sites with both switches set, held against the JAX predicates on the
# meta device by tests/test_torch_norms_short.py: one UNet forward (batch 2,
# 16 frames) per configuration; the MDM1024 clip outside its UNet forwards
# (the resampler's latents; the VAE's and towers' shapes do not fit); one
# MDM512 training micro-step's forward and its remat recompute.
SWITCH_SITES = {
    "mdm512": {"group_norm": 87, "layer_norm": 56, "short_kv_attention": 10},
    "mdm1024": {"group_norm": 42, "layer_norm": 56, "short_kv_attention": 20},
}
# An fp32 UNet forward with impl="auto" (batch 2) reaches kernels 11 and 12
# and kernel 5 in fp32 at every spatial self-attention with L >= 512 (the
# Pallas flash kernel takes any dtype; kernels 1-4 take bf16 only, so those
# sites reach `attend`): fewer GN sites (the fp32 budget admits up to
# 1,048,576 elements per sample), more LN sites (the LNs that kernels 1-3
# fuse in bf16). tests/test_torch_norms_short.py and
# tests/test_torch_switches.py hold these against the JAX predicates and a
# trace of the JAX UNet.
SWITCH_SITES_F32 = {
    "mdm512": {"group_norm": 86, "layer_norm": 99, "short_kv_attention": 10,
               "flash_attention": 10},
    "mdm1024": {"group_norm": 28, "layer_norm": 99, "short_kv_attention": 20,
                "flash_attention": 15},
}
# The JAX package's six kernel opt-out switches (phase 13): each set to "0"
# alone, then all six, in one bf16 UNet forward (batch 2); the sites that
# differ from SITES, held against a trace of the JAX UNet by
# tests/test_torch_switches.py. MDM512's spatial sites all take the
# whole-block tier, so its stream and flash-block switches change nothing;
# MDM1024's ds2 sites leave the stream tier for the flash-block one.
OPT_OUT = ("MUDG_FUSED_SPATIAL", "MUDG_STREAM_SPATIAL", "MUDG_FLASHBLOCK", "MUDG_FUSED_FF",
           "MUDG_FUSED_TEMPORAL", "MUDG_FUSED_TCONV")
SWITCHES_OFF = {
    "mdm512": {"MUDG_FUSED_SPATIAL": {"spatial_attn": 0, "flash_attention": 10},
               "MUDG_STREAM_SPATIAL": {}, "MUDG_FLASHBLOCK": {},
               "MUDG_FUSED_FF": {"geglu_ff": 0}, "MUDG_FUSED_TEMPORAL": {"temporal_attn": 0},
               "MUDG_FUSED_TCONV": {"gn_silu_tconv": 0},
               "all": {"spatial_attn": 0, "temporal_attn": 0, "geglu_ff": 0,
                       "gn_silu_tconv": 0, "flash_attention": 10}},
    "mdm1024": {"MUDG_FUSED_SPATIAL": {"spatial_attn": 0, "flash_attention": 15},
                "MUDG_STREAM_SPATIAL": {},
                "MUDG_FLASHBLOCK": {"spatial_attn": 5, "flash_attention": 10},
                "MUDG_FUSED_FF": {"geglu_ff": 0}, "MUDG_FUSED_TEMPORAL": {"temporal_attn": 0},
                "MUDG_FUSED_TCONV": {"gn_silu_tconv": 0},
                "all": {"spatial_attn": 0, "temporal_attn": 0, "geglu_ff": 0,
                        "gn_silu_tconv": 0, "flash_attention": 15}},
}
F32_PATH_TOL = 1e-4   # the fp32 switch forward's relative L2 against the fp32 plain one
# Phase 19 (d): the UNet options that no MuDG config sets, in as few UNets as
# JAX takes them together (relative position beside the cross-context path
# fails in JAX: its blocks pass no temporal_length), at full UNetConfig()
# width. The joint task attention's UNet runs at one clip a task; the
# cross-context one at the MDM1024 latent, as JAX refuses it at MDM512's
# (its ds8 rows, 5 x 8 = 40, are not a multiple of T = 16). Their kernel
# sites per bf16 forward, held against a trace of the JAX UNet by
# tests/test_torch_options.py: kernel 2 at none (relative position and
# the cross-context blocks keep it off); at batch 3 the middle block's two
# FFs (rows 3 x 16 x 5 x 8 = 1920, not a multiple of 256) leave kernel 3.
OPTION_UNETS = {"relpos_causal_joint": dict(use_relative_position=True,
                                            use_causal_attention=True,
                                            domain_cross_attention=True, num_tasks=3),
                "context": dict(temporal_selfatt_only=False)}
OPTION_BATCH = {"relpos_causal_joint": 3, "context": 2}
OPTION_LATENT = {"relpos_causal_joint": "mdm512", "context": "mdm1024"}
OPTION_SITES = {"relpos_causal_joint": {**SITES["mdm512"], "temporal_attn": 0, "geglu_ff": 31},
                "context": {**SITES["mdm1024"], "temporal_attn": 0}}
# Phase 17: the --quantize modes of render and serve, and the MDM512 kernel
# sites of one bf16 UNet forward (batch 2) under each that differ from
# SITES, held against a trace of the JAX UNet with its tree quantized by the
# JAX app by tests/test_torch_switches.py
QUANTIZE_MODES = ("int8", "int8-conv", "int8-conv-wide", "int8-weights")
_INT8_OFF = {"spatial_attn": 0, "temporal_attn": 0, "geglu_ff": 0, "gn_silu_tconv": 0,
             "flash_attention": 10}
QUANT_SITES = {"int8": _INT8_OFF, "int8-conv": {}, "int8-conv-wide": {"geglu_ff": 21},
               "int8-weights": _INT8_OFF}
SWITCH_CLIP_EXTRA = {"group_norm": 0, "layer_norm": 9, "short_kv_attention": 0}
SWITCH_TRAIN = {"fwd": {"group_norm": 117, "layer_norm": 85, "short_kv_attention": 10},
                "bwd": {"group_norm": 86, "layer_norm": 76, "short_kv_attention": 10}}
# Every distinct shape at those sites in one UNet forward at each
# configuration (batch 2; "sites" per forward), and (sites 0: checked and
# timed, not in the row's sums) those that only the VAE at a training encode
# chunk, the MDM512 training micro-step (batch 1), the MDM1024 clip's
# resampler, the fp32 forwards ("-f32", in fp32), DepthLab's write and read
# passes at a 1280x1920 frame in bf16 and fp32 and SegFormer-B3 on that frame
# in fp32 reach (tests/test_torch_depthlab.py holds the last three against
# the JAX predicates): phase 11 checks and times each
GN_SHAPES = {
    "mdm512": {(2, 16, 5, 8, 1280): 29, (32, 10, 16, 1280): 11, (32, 10, 16, 1920): 1,
               (32, 10, 16, 2560): 2, (32, 10, 16, 640): 1, (32, 20, 32, 1280): 1,
               (32, 20, 32, 1920): 1, (32, 20, 32, 320): 1, (32, 20, 32, 640): 11,
               (32, 20, 32, 960): 1, (32, 40, 64, 320): 13, (32, 5, 8, 1280): 12,
               (32, 5, 8, 2560): 3},
    "mdm1024": {(32, 18, 32, 1280): 11, (32, 18, 32, 1920): 1, (32, 18, 32, 2560): 2,
                (32, 18, 32, 640): 1, (32, 36, 64, 320): 1, (32, 36, 64, 640): 11,
                (32, 9, 16, 1280): 12, (32, 9, 16, 2560): 3},
    "vae": {(16, 40, 64, 512): 0},
    "train": dict.fromkeys(((1, 16, 5, 8, 1280), (16, 10, 16, 1280), (16, 10, 16, 1920),
                            (16, 10, 16, 2560), (16, 10, 16, 640), (16, 20, 32, 1280),
                            (16, 20, 32, 1920), (16, 20, 32, 320), (16, 20, 32, 640),
                            (16, 20, 32, 960), (16, 40, 64, 320), (16, 5, 8, 1280),
                            (16, 5, 8, 2560)), 0),
    "mdm512-f32": dict.fromkeys(((2, 16, 5, 8, 1280), (32, 10, 16, 1280), (32, 10, 16, 1920),
                                 (32, 10, 16, 2560), (32, 10, 16, 640), (32, 20, 32, 1280),
                                 (32, 20, 32, 320), (32, 20, 32, 640), (32, 20, 32, 960),
                                 (32, 40, 64, 320), (32, 5, 8, 1280), (32, 5, 8, 2560)), 0),
    "mdm1024-f32": dict.fromkeys(((32, 18, 32, 1280), (32, 18, 32, 640), (32, 36, 64, 320),
                                  (32, 9, 16, 1280), (32, 9, 16, 2560)), 0),
    "depthlab": dict.fromkeys(((1, 20, 30, 1280), (1, 20, 30, 2560), (1, 40, 60, 640)), 0),
    "depthlab-f32": {(1, 20, 30, 1280): 0},
}
LN_SHAPES = {
    "mdm512": {(1280, 16, 640): 5, (32, 160, 1280): 15, (32, 2560, 320): 5, (32, 40, 1280): 3,
               (32, 640, 640): 10, (320, 16, 1280): 15, (80, 16, 1280): 3},
    "mdm1024": {(1152, 16, 1280): 15, (288, 16, 1280): 3, (32, 144, 1280): 3,
                (32, 2304, 640): 10, (32, 576, 1280): 15, (32, 9216, 320): 5,
                (4608, 16, 640): 5},
    "train": dict.fromkeys(((1, 256, 1024), (16, 160, 1280), (16, 2560, 320), (16, 40, 1280),
                            (16, 640, 640), (160, 16, 1280), (40, 16, 1280), (640, 16, 640)),
                           0),
    "clip": {(2, 256, 1024): 0},
    "mdm512-f32": dict.fromkeys(((1280, 16, 640), (32, 160, 1280), (32, 2560, 320),
                                 (32, 40, 1280), (32, 640, 640), (320, 16, 1280),
                                 (5120, 16, 320), (5120, 16, 512), (80, 16, 1280)), 0),
    "mdm1024-f32": dict.fromkeys(((1152, 16, 1280), (18432, 16, 320), (18432, 16, 512),
                                  (288, 16, 1280), (32, 144, 1280), (32, 2304, 640),
                                  (32, 576, 1280), (32, 9216, 320), (4608, 16, 640)), 0),
    "depthlab": dict.fromkeys(((1, 38400, 320), (1, 9600, 640), (1, 2400, 1280),
                               (1, 600, 1280)), 0),
    "depthlab-f32": dict.fromkeys(((1, 38400, 320), (1, 9600, 640), (1, 2400, 1280),
                                   (1, 600, 1280)), 0),
    "segformer-f32": dict.fromkeys(((1, 153600, 64), (1, 2400, 64), (1, 38400, 128),
                                    (1, 2400, 128), (1, 9600, 320), (1, 2400, 320),
                                    (1, 2400, 512)), 0),
}
# Beside GN_SHAPES, the GroupNorms gn_plan also plans (n, rows, C, itemsize,
# silu): kernel 4's clips at MDM512 and MDM1024 ds1, and the largest samples
# group_norm_fits admits (1,048,576 elements in fp32, 1,572,864 in bf16)
GN_LARGEST = ((2, 16 * 40 * 64, 320, 2, True), (2, 16 * 72 * 128, 320, 2, True),
              (2, 32 * 32, 1024, 4, False), (2, 48 * 32, 1024, 2, False))
# (q shape, k shape) of the text (77 keys) and image (16 keys) attends
SKV_SHAPES = {
    "mdm512": {((32, 2560, 5, 64), (32, 16, 5, 64)): 5, ((32, 2560, 5, 64), (32, 77, 5, 64)): 5},
    "mdm1024": {((32, 2304, 10, 64), (32, 16, 10, 64)): 5,
                ((32, 2304, 10, 64), (32, 77, 10, 64)): 5,
                ((32, 9216, 5, 64), (32, 16, 5, 64)): 5, ((32, 9216, 5, 64), (32, 77, 5, 64)): 5},
    "train": {((16, 2560, 5, 64), (16, 16, 5, 64)): 0, ((16, 2560, 5, 64), (16, 77, 5, 64)): 0},
    "mdm512-f32": {((32, 2560, 5, 64), (32, 16, 5, 64)): 0,
                   ((32, 2560, 5, 64), (32, 77, 5, 64)): 0},
    "mdm1024-f32": {((32, 2304, 10, 64), (32, 16, 10, 64)): 0,
                    ((32, 2304, 10, 64), (32, 77, 10, 64)): 0,
                    ((32, 9216, 5, 64), (32, 16, 5, 64)): 0,
                    ((32, 9216, 5, 64), (32, 77, 5, 64)): 0},
    # DepthLab's cross-attention to its one context token
    "depthlab": {((1, 38400, 5, 64), (1, 1, 5, 64)): 0},
    "depthlab-f32": {((1, 38400, 5, 64), (1, 1, 5, 64)): 0},
    # no MuDG site: the rest of what the predicate admits, K/V past 128 keys
    # (streamed in 64-key chunks) and head dim 128, at the MDM512 ds1 queries
    "stream": {((32, 2560, 5, 64), (32, 256, 5, 64)): 0,
               ((32, 2560, 5, 64), (32, 1024, 5, 64)): 0,
               ((32, 2560, 5, 128), (32, 77, 5, 128)): 0},
    "stream-f32": {((32, 2560, 5, 64), (32, 256, 5, 64)): 0,
                   ((32, 2560, 5, 64), (32, 1024, 5, 64)): 0,
                   ((32, 2560, 5, 128), (32, 77, 5, 128)): 0},
}
# the temporal attention's (B*H*W, 16, heads, 64) at C = 320, 640, 1280 of MDM512
PACKED_SHAPES = ((5120, 16, 5, 64), (1280, 16, 10, 64), (320, 16, 20, 64))
# the rest packed_short_attention_eligible admits, checked and timed but not
# summed: T = 1 and 8 (several sequences a 16-row tile), T = 64, head dim 128
PACKED_EXTRA = ((16384, 1, 8, 64), (2048, 8, 8, 64), (256, 64, 8, 64), (1024, 16, 5, 128))
F32_TOL = 1e-5   # fp32 forward: max|diff| <= 1e-5 * max|ref|
SKV_RERUNS = 30  # fp32 short-KV's reruns, each compared bit for bit with the first call
DC_OFFSET = 1e3


def switch_site_shapes(key):
    """The shapes phase 11 checks for a kernel-11/12 site kind, as
    tests/test_torch_norms_short.py records them: (shape, dtype) for the
    norms, (q shape, k shape, dtype) for short-KV."""
    table = {"group_norm": GN_SHAPES, "layer_norm": LN_SHAPES,
             "short_kv_attention": SKV_SHAPES}[key]
    out = set()
    for cfg, shapes in table.items():
        dtype = "torch.float32" if cfg.endswith("-f32") else "torch.bfloat16"
        out |= {(*(shape if key == "short_kv_attention" else (shape,)), dtype)
                for shape in shapes}
    return out


KERNEL_ROWS = {
    "spatial_attn": ("mudg_tpu_torch/csrc/spatial_attn.cu",
                     "mudg_tpu/kernels/spatial_attn.py:163,365,550"),
    "temporal_attn": ("mudg_tpu_torch/csrc/temporal_attn.cu",
                      "mudg_tpu/kernels/temporal_attn.py:205"),
    "geglu_ff": ("mudg_tpu_torch/csrc/geglu_ff.cu", "mudg_tpu/kernels/mlp.py:235"),
    "gn_silu_tconv": ("mudg_tpu_torch/csrc/tconv.cu", "mudg_tpu/kernels/tconv.py:128"),
    "flash_attention": ("mudg_tpu_torch/csrc/flash_attn.cu",
                        "mudg_tpu/kernels/flash_attention.py:132,159"),
    "flash_attention_bwd": ("mudg_tpu_torch/csrc/flash_attn_bwd.cu",
                            "mudg_tpu/kernels/flash_attention.py:396,412,315,331"),
    "temporal_attn_bwd": ("mudg_tpu_torch/csrc/temporal_attn_bwd.cu",
                          "mudg_tpu/kernels/temporal_attn.py:406"),
    "geglu_ff_bwd": ("mudg_tpu_torch/csrc/mlp_bwd.cu", "mudg_tpu/kernels/mlp.py:438"),
    "tile_composite": ("mudg_tpu_torch/csrc/tile_raster.cu", "mudg_tpu/gs/tile_raster.py:535"),
    "tile_composite_bwd": ("mudg_tpu_torch/csrc/tile_raster.cu",
                           "mudg_tpu/gs/tile_raster.py:709"),
    "group_norm": ("mudg_tpu_torch/csrc/norms.cu", "mudg_tpu/kernels/norms.py:87"),
    "layer_norm": ("mudg_tpu_torch/csrc/norms.cu", "mudg_tpu/kernels/norms.py:172"),
    "short_kv_attention": ("mudg_tpu_torch/csrc/short_kv.cu,mudg_tpu_torch/csrc/short_kv_f32.cu",
                           "mudg_tpu/kernels/short_attention.py:214"),
    "packed_short_attention": ("mudg_tpu_torch/csrc/short_attn.cu",
                               "mudg_tpu/kernels/short_attention.py:81"),
}


# Phase 2's yardsticks for part of a kernel's work, each a library call on
# the same inputs, never on the port's path: a kernel's products alone in
# cuBLAS ("cublas_gemm_ms": kernel 3's x by W1 and h by W2, without the LN,
# the GEGLU or the biases; kernel 2's xn by Wqkv^T and o by Wo^T of both
# stages, without the LN, the attention or the residual; kernel 10's six:
# x by W1's value and gate halves, dy by W2, [du | dg] by W1, dy^T h and
# [du | dg]^T x, on random xn, o, h and [du | dg] made outside the timed
# window; kernel 9's five per stage, both stages: xn by Wqkv'^T, dy by Wo,
# dqkv^T xn, dy^T o and dqkv by Wqkv', on random xn, o and dqkv), kernel
# 1's attention core alone in SDPA (on the q, k and v of its LN and
# projections, made outside the timed window) and kernel 4's
# product alone in cuBLAS (F.linear of the (M, 3C) tap concatenation by
# wcat, the concatenation made outside the timed window). Each is timed
# alone (the key) and queued (the key + "_queued").
YARDSTICKS = ("cublas_gemm_ms", "sdpa_core_ms", "cublas_tap_gemm_ms")


def policy_launches(cfg, policy, micro_steps=1):
    """Every kernel's launches in `micro_steps` training micro-steps under
    the remat `policy` (False: none): each forward kernel once per site, and
    again in the backward's replay at every checkpointed site (all but
    init_attn's) of the kernels the policy replays (REPLAYED); each backward
    kernel once per site."""
    sites = TRAIN_SITES[cfg]
    replayed = REPLAYED[policy] if policy else ()
    fwd = {k: v + (v - INIT_ATTN_SITES.get(k, 0)) * (k in replayed) for k, v in sites.items()}
    counts = {"spatial_attn": 0, "gn_silu_tconv": 0, **fwd,
              **{k + "_bwd": v for k, v in sites.items()},
              "tile_composite": 0, "tile_composite_bwd": 0, **OFF}
    return {k: micro_steps * v for k, v in counts.items()}


def train_launches(cfg, micro_steps):
    """Every kernel's launches in `micro_steps` training micro-steps with
    full recompute (remat=True)."""
    return policy_launches(cfg, "full", micro_steps)


def log(msg):
    print(msg, flush=True)


SWITCH_VARS = ("MUDG_FUSED_NORMS", "MUDG_SHORT_ATTN")


@contextlib.contextmanager
def environ(values):
    """The environment variables of `values` set (a string) or unset (None)
    inside the block, restored after it."""
    saved = {v: os.environ.get(v) for v in values}
    for v, val in values.items():
        if val is None:
            os.environ.pop(v, None)
        else:
            os.environ[v] = val
    try:
        yield
    finally:
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val


def switches(on=True):
    """MUDG_FUSED_NORMS and MUDG_SHORT_ATTN set to "1" (on) or unset (off)
    inside the block, restored after it."""
    return environ(dict.fromkeys(SWITCH_VARS, "1" if on else None))


def opt_out_cases(cfg):
    """(name, the switches set to "0", the expected launches of one bf16 UNet
    forward) for each opt-out switch alone and for all six (phase 13)."""
    for name, delta in SWITCHES_OFF[cfg].items():
        off = OPT_OUT if name == "all" else (name,)
        yield name, dict.fromkeys(off, "0"), {**SITES[cfg], **delta}


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    ev = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in ev)
    return ts[len(ts) // 2]


def cuda_ms_queued(torch, fn, iters=10):
    """Mean CUDA-event time of fn() in ms over `iters` calls queued back to
    back between two events, as calls are queued on a model's path: the
    host's per-call cost (checks, tensor maps, the launch) hides behind the
    device's work where the device takes longer. cuda_ms brackets each call
    alone, so for a short kernel it also counts the host's cost."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(flops, nbytes, peak=PEAK_FLOPS):
    """(ms, "bytes" | "operations"): the least time the card could take for
    `flops` operations at `peak` (bf16 by default) and `nbytes` bytes moved;
    at PEAK_TF32 each operation is TF32_PASSES tf32 operations (3xTF32)."""
    passes = TF32_PASSES if peak == PEAK_TF32 else 1
    t_ops, t_bytes = passes * flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# Work of one call: (FLOPs, bytes), each input read once and each output
# written once (bf16 activations and weights, fp32 norms and biases).
def work_spatial(b, l, c):
    return (8 * b * l * c * c + 4 * b * l * l * c,
            2 * 2 * b * l * c + 2 * 4 * c * c + 4 * 3 * c)


def work_temporal(n, t, c):
    m = n * t
    return (2 * (8 * m * c * c + 4 * m * t * c),
            2 * 2 * m * c + 2 * (2 * 4 * c * c + 4 * 3 * c))


def work_ff(m, c, block):
    inner = 4 * c
    return (6 * m * c * inner,
            2 * 2 * m * c + 2 * 3 * c * inner + 4 * (2 * inner + c + (2 * c if block else 0)))


def work_tconv(b, t, h, w, c):
    m = b * t * h * w
    return 6 * m * c * c, 2 * 2 * m * c + 2 * 3 * c * c + 4 * 3 * c


def work_flash(b, l, h, d, itemsize=2):
    return 4 * b * h * l * l * d, 4 * itemsize * b * l * h * d + 4 * b * h * l


# The backward functions: their inputs include the fp32 parameters (read once)
# and their outputs the fp32 weight gradients (written once).
def work_flash_bwd(b, l, h, d, itemsize=2):
    """Five L x L x d products per (batch, head); q, k, v, o, dO in, dq, dk,
    dv out (bf16 or fp32), lse in (fp32). Kernel 6's two-kernel design forms
    S and dP twice: seven products, FLASH_BWD_DESIGN times the function's."""
    return 10 * b * h * l * l * d, itemsize * 8 * b * l * h * d + 4 * b * h * l


FLASH_BWD_DESIGN = 7 / 5


def work_temporal_bwd(rows, c):
    """Both stages: per stage 11 C x C products per row (q|k|v, dO, dW q|k|v,
    dWo, dLN(x)) and 6 per row and head over 16 keys; tokens, h1, dy in and
    dx out (bf16); two stages' 4C^2 + 3C parameters in and gradients out."""
    return (4 * rows * c * (11 * c + 96),
            2 * 4 * rows * c + 2 * 2 * 4 * (4 * c * c + 3 * c))


def work_ff_bwd(m, c):
    """8 M x C x inner multiply-adds (u, g, dh, dx, dW2, dW1); x, dy in, dx out
    (bf16); W1, b1, W2 in and their and b2's gradients out (fp32)."""
    inner = 4 * c
    return 16 * m * c * inner, 2 * 3 * m * c + 4 * (6 * c * inner + 4 * inner + c)


def randomize_(torch, module, gen):
    """Re-randomize EVERY parameter (the zero-initialised output projections
    would otherwise hide kernel errors): matrices N(0, 1/fan_in), norm
    scales 1 + 0.1 N(0, 1), biases and other vectors 0.1 N(0, 1)."""
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            r = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
            if p.ndim >= 2:
                r *= 1.0 / math.sqrt(p[0].numel())
            elif name.endswith("weight"):
                r = 1.0 + 0.1 * r
            else:
                r *= 0.1
            p.copy_(r)
    return module


def phase_build(torch, _build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    build_log = _build.BUILD_DIR / "build.log"
    spilled = []
    if build_log.exists():   # each kernel's registers and spills, by its (mangled) name
        fn = ""
        for line in build_log.read_text().splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if "registers" in line or (spill and spill.group(1, 2) != ("0", "0")):
                log(f"  ptxas: {fn}: {line.strip()}")
            if spill and spill.group(1, 2) != ("0", "0") and any(re.search(k, fn)
                                                                  for k in NO_SPILL):
                spilled.append(fn)
    if spilled:
        raise AssertionError(f"ptxas spilled in {spilled}")
    return card


class Case(NamedTuple):
    """One kernel shape of a UNet forward. `base` is the residual input the
    kernel adds to its output (None where it adds none): the check holds
    output - base, so the part the kernel computes is not hidden under the
    rounding of the residual. `faults` are plain versions with a planted
    fault (name -> fn); the check must see each of them."""
    name: str
    config: str
    label: str
    sites: int
    work: tuple
    kernel: Callable
    plain: Callable
    library: Callable | None
    base: object
    faults: dict
    grads: bool = False   # kernel and plain return tuples of gradients
    tol: float = TOL      # forward check: max|diff| <= tol * max|ref|
    peak: float = PEAK_FLOPS   # the operations' rate in the bound
    grad_tol: float = BWD_TOL  # backward check: each gradient within grad_tol * max|ref|
    lse_tol: float = LSE_TOL   # kernel 5's logsumexp, absolute
    reruns: int = 0       # reruns that must give the first call's bits
    # library calls for part of the kernel's work (timed only, alone and queued):
    # JSON key -> fn; see YARDSTICKS
    yardsticks: dict = {}
    note: str = ""        # printed with the case (kernel 11: the launch plan)


def sharpen_(attn):
    import torch

    with torch.no_grad():
        attn.to_q.weight.mul_(SHARPEN)
        attn.to_k.weight.mul_(SHARPEN)
    return attn


def zero_v(attn):
    """A copy of `attn` whose value projection is zero: its attention term is
    0, as from a kernel that writes no attention."""
    import torch

    z = copy.deepcopy(attn)
    with torch.no_grad():
        z.to_v.weight.zero_()
    return z


def swap_geglu_halves(ff):
    """A copy of FeedForward `ff` whose W1 and b1 have their value and gate
    halves swapped, as from kernel 3 reading the gate where the value lies:
    g * gelu(u) in place of u * gelu(g)."""
    import torch

    z = copy.deepcopy(ff)
    proj = z.net["0"].proj
    inner = proj.weight.shape[0] // 2
    with torch.no_grad():
        for p in (proj.weight, proj.bias):
            p.copy_(torch.cat([p[inner:], p[:inner]]))
    return z


def swap_k_heads(attn):
    """A copy of `attn` whose key projections of heads 0 and 1 are swapped,
    as from kernel 2 reading a packing with k_0 and k_1 in each other's
    place."""
    import torch

    z = copy.deepcopy(attn)
    with torch.no_grad():
        w = attn.to_k.weight
        z.to_k.weight.copy_(torch.cat([w[64:128], w[:64], w[128:]]))
    return z


def scale_twice(attn):
    """A copy of `attn` whose logits take the softmax scale d^-0.5 twice, as
    from a core that applies kernel 5's 0.125 * log2(e) to a q whose Wq
    already carries it."""
    import torch

    z = copy.deepcopy(attn)
    with torch.no_grad():
        z.to_q.weight.mul_(64 ** -0.5)
    return z


def taps_reversed(conv):
    """A copy of the (3, 1, 1) conv with its taps in reverse order (t - 1 and
    t + 1 swapped), as from a kernel that reads the frames the wrong way."""
    import torch

    z = copy.deepcopy(conv)
    with torch.no_grad():
        z.weight.copy_(conv.weight.flip(2))
    return z


def one_pass_gn_silu_tconv(x, norm, conv):
    """Kernel 4's plain version with the GroupNorm's one-pass variance
    E[x^2] - E[x]^2 in fp32 (the Pallas GroupNorm's, norms.py:62-68), which
    cancels under a DC offset."""
    from mudg_tpu_torch.kernels import norms as N
    from mudg_tpu_torch.nn import functional as F

    h = N.plain_group_norm(x, norm.weight, norm.bias, 32, 1e-5, one_pass=True)
    return F.temporal_conv311(conv, F.silu(h))


def f64_gn_silu_tconv(K, x, norm, conv):
    """Kernel 4's plain version in float64 (weights and x promoted)."""
    import torch

    n64, c64 = copy.deepcopy(norm).double(), copy.deepcopy(conv).double()
    return K.tconv.plain_gn_silu_tconv(x.double(), n64, c64).to(torch.float32)


def dc_video(torch, gen, shape, dev, offset=DC_OFFSET):
    """A bf16 video at a DC offset whose groups vary little: offset + 4 s,
    s in {-1, 0, 1} with P(s = +-1) = 1/128 each (4 is bf16's spacing at
    1e3), a within-group variance of 0.25. In fp32 the one-pass variance
    E[x^2] - E[x]^2 rounds its two ~1e6 terms by ~0.06 each, so it is off by
    far more than the 3e-2 check allows (or negative); the centered form is
    exact here."""
    u = torch.rand(shape, generator=gen, device=dev)
    s = (u < 1 / 128).float() - (u > 1 - 1 / 128).float()
    return (offset + 4.0 * s).to(torch.bfloat16)


def attention_qkv(x, norm, attn, heads):
    """q, k, v (B, H, L, 64) of kernel 1's LN and projections in plain
    PyTorch, for the SDPA yardstick of its attention core."""
    from mudg_tpu_torch.nn import functional as F

    h = F.layer_norm(norm, x)
    b, l, _ = x.shape
    return [F.linear(m, h).reshape(b, l, heads, 64).transpose(1, 2).contiguous()
            for m in (attn.to_q, attn.to_k, attn.to_v)]


def tap_concat(torch, x, norm):
    """[h_{t-1} | h_t | h_{t+1}] (M, 3C) of h = silu(GN(x)) in bf16, zero at
    the t edges: kernel 4's GEMM operand, for its cuBLAS yardstick."""
    from mudg_tpu_torch.nn import functional as F

    h = F.silu(F.group_norm(norm, x))
    z = torch.zeros_like(h[:, :1])
    cat = torch.cat([torch.cat([z, h[:, :-1]], 1), h, torch.cat([h[:, 1:], z], 1)], -1)
    return cat.reshape(-1, 3 * x.shape[-1])


def half_keys_self_attention(x, norm, attn, heads):
    """Kernel 1's function with each query attending to the first half of the
    frame's keys only, as from a kernel that walks half its K/V tiles."""
    from mudg_tpu_torch.nn import attention as A
    from mudg_tpu_torch.nn import functional as F

    h = F.layer_norm(norm, x)
    q, k, v = (A._split_heads(F.linear(m, h), heads) for m in (attn.to_q, attn.to_k, attn.to_v))
    half = x.shape[1] // 2
    o = A.plain_attend(q, k[:, :half], v[:, :half])
    return F.linear(attn.to_out["0"], A._merge_heads(o)) + x


def forward_shapes(cfg, batch=2, latent=None):
    """The kernel shapes of one UNet forward (16 frames a clip) at `cfg` and
    `batch`, as kernel_cases makes its cases: "spatial" (label, frames, L,
    C), "temporal" (label, sequences, C, sites), "ff" (rows, C, block form,
    sites), "tconv" the clip shape, "flash" (label, frames, L, heads, sites,
    fp32). At batch 2 also the shapes no forward reaches (sites 0): kernel
    2's tail (rows % 128 == 64, MDM512) and kernel 5's long shape (MDM1024).
    `latent` maps a configuration to its (h, w) (default LATENT)."""
    h, w = (latent or LATENT)[cfg]
    tok = [h * w, h * w // 4, h * w // 16, h * w // 64]     # ds1, ds2, ds4, ds8
    nf = 16 * batch   # frames
    extra = batch == 2
    temporal = [("ds1", batch * tok[0], 320, 5), ("init_attn", batch * tok[0], 512, 1),
                ("ds2", batch * tok[1], 640, 5)]
    if cfg == "mdm512" and extra:
        temporal.append(("tail", 2 * tok[0] + 4, 320, 0))
    # kernel 5: in bf16 the ds4 self-attention (C=1280, 20 heads, L=576) of
    # MDM1024 and one long shape that streams 72 K/V tiles per query tile; in
    # fp32 (an fp32 forward, sites 0: checked and timed, not in the row's bf16
    # sums) every spatial self-attention at L >= 512
    flash = {"mdm512": [("f32 ds1", nf, tok[0], 5, 0, True), ("f32 ds2", nf, tok[1], 10, 0, True)],
             "mdm1024": [("ds4", nf, tok[2], 20, 5, False)]
             + ([("long", 2, tok[0], 5, 0, False)] if extra else [])
             + [("f32 ds1", nf, tok[0], 5, 0, True), ("f32 ds2", nf, tok[1], 10, 0, True),
                ("f32 ds4", nf, tok[2], 20, 0, True)]}[cfg]
    return {"spatial": [("ds1", nf, tok[0], 320), ("ds2", nf, tok[1], 640)],
            "temporal": temporal,
            "ff": [(nf * tok[0], 320, True, 10), (nf * tok[0], 512, True, 1),
                   (nf * tok[1], 640, False, 10), (nf * tok[2], 1280, False, 10),
                   (nf * tok[3], 1280, False, 2)],
            "tconv": (batch, 16, h, w, 320), "flash": flash}


def forward_keys(cfg, batch=2, latent=None):
    """forward_shapes' kernel calls of a forward as traced_kernel_keys gives
    them: (kernel, its first argument's shape, fp32), the FF kernel's key
    "geglu_ff_block" for the block form; without the shapes no forward
    reaches."""
    fs = forward_shapes(cfg, batch, latent)
    keys = {("spatial_attn", (b, l, c), False) for _, b, l, c in fs["spatial"]}
    keys |= {("temporal_attn", (n, 16, c), False) for label, n, c, _ in fs["temporal"]
             if label != "tail"}
    keys |= {("geglu_ff" + ("_block" if block else ""), (m, c), False)
             for m, c, block, _ in fs["ff"]}
    keys.add(("gn_silu_tconv", fs["tconv"], False))
    keys |= {("flash_attention", (b, l, heads, 64), f32)
             for label, b, l, heads, _, f32 in fs["flash"] if label != "long"}
    return keys


def kernel_cases(torch, K, nn_att, configs, dev="cuda", latent=None, batch=2):
    """Yield a Case for every kernel shape of forward_shapes at each
    configuration and `batch`; inputs are made when the case is reached. At
    batch 2 kernel 4 is also checked at a DC offset (MDM512)."""
    from torch import nn

    F = torch.nn.functional
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # kernel 3's cuBLAS yardstick takes its h from a generator of its own, so
    # every case's inputs stay as they were without it
    gemm_gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rand(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def mods(*ms):
        return [randomize_(torch, m.to(dev, bf), gen) for m in ms]

    def norm_attention(c):
        norm, attn = mods(nn.LayerNorm(c), nn_att.CrossAttention(c, heads=c // 64, dim_head=64))
        return norm, sharpen_(attn)

    for cfg in configs:
        fs = forward_shapes(cfg, batch, latent)
        for label, nf, l, c in fs["spatial"]:
            heads = c // 64
            norm, attn = norm_attention(c)
            pk = K.spatial_attn.pack_stage(norm, attn, heads)
            x = rand(nf, l, c)
            qkv = attention_qkv(x, norm, attn, heads)
            yield Case("spatial_attn", cfg, f"{label} {nf}x{l}x{c}", 5, work_spatial(nf, l, c),
                       lambda: K.spatial_attn.fused_self_attention(x, norm, attn, heads, pk),
                       lambda: K.spatial_attn.plain_self_attention(x, norm, attn, heads), None,
                       x, {"zero attention": lambda: K.spatial_attn.plain_self_attention(
                               x, norm, zero_v(attn), heads),
                           "half the keys": lambda: half_keys_self_attention(
                               x, norm, attn, heads),
                           "softmax scale twice": lambda: K.spatial_attn.plain_self_attention(
                               x, norm, scale_twice(attn), heads)},
                       yardsticks={"sdpa_core_ms": lambda: F.scaled_dot_product_attention(
                           *qkv)})
        # kernel 2 at its sites and, at batch 2 at MDM512, at a tail shape
        # whose rows % 128 == 64 (the last 128-row block half empty; sites 0:
        # checked and timed, not summed)
        for label, n_seq, c, sites in fs["temporal"]:
            heads = c // 64
            (n1, a1), (n2, a2) = norm_attention(c), norm_attention(c)
            pk = (K.temporal_attn.pack_stage(n1, a1, heads), K.temporal_attn.pack_stage(n2, a2, heads))
            x = rand(n_seq, 16, c)
            xo = torch.randn((2, n_seq * 16, c), generator=gemm_gen, device=dev).to(bf)
            yield Case("temporal_attn", cfg, f"{label} {n_seq * 16}x{c}", sites,
                       work_temporal(n_seq, 16, c),
                       lambda: K.temporal_attn.fused_double_self_attn(x, (n1, a1), (n2, a2), heads, pk),
                       lambda: K.temporal_attn.plain_double_self_attn(x, (n1, a1), (n2, a2), heads),
                       None, x,
                       {"zero attention": lambda: K.temporal_attn.plain_double_self_attn(
                           x, (n1, zero_v(a1)), (n2, zero_v(a2)), heads),
                        "mis-packed heads": lambda: K.temporal_attn.plain_double_self_attn(
                           x, (n1, swap_k_heads(a1)), (n2, swap_k_heads(a2)), heads)},
                       yardsticks={"cublas_gemm_ms": lambda: [
                           F.linear(xo[i], w) for i, w in ((0, pk[0].wqkv), (1, pk[0].wo),
                                                           (0, pk[1].wqkv), (1, pk[1].wo))]})
        for m, c, block, sites in fs["ff"]:
            norm, ff = mods(nn.LayerNorm(c), nn_att.FeedForward(c))
            pk = K.mlp.pack_ff(ff, norm)
            x = rand(m, c)
            w1, _, w2, _ = K.mlp.ff_params(ff)
            hy = torch.randn((m, w2.shape[1]), generator=gemm_gen, device=dev).to(bf)
            swapped = swap_geglu_halves(ff)
            if block:
                fk = lambda: K.mlp.fused_geglu_ff_block(x, norm, ff, pk)   # noqa: E731
                fp = lambda: K.mlp.plain_geglu_ff_block(x, norm, ff)       # noqa: E731
                ff_fault = lambda: K.mlp.plain_geglu_ff_block(x, norm, swapped)   # noqa: E731
            else:
                fk = lambda: K.mlp.fused_geglu_ff(x, ff, pk)               # noqa: E731
                fp = lambda: K.mlp.plain_geglu_ff(x, ff)                   # noqa: E731
                ff_fault = lambda: K.mlp.plain_geglu_ff(x, swapped)        # noqa: E731
            yield Case("geglu_ff", cfg, f"{'block' if block else 'bare'} {m}x{c}", sites,
                       work_ff(m, c, block), fk, fp, None, x if block else None,
                       {"gate and value swapped": ff_fault},
                       yardsticks={"cublas_gemm_ms": lambda: (F.linear(x, w1),
                                                              F.linear(hy, w2))})
        # kernel 4 at ds1 (reruns bit for bit); at batch 2 at MDM512 also at a
        # DC offset of 1e3 against its plain version in float64 (sites 0:
        # checked and timed, not summed), where the one-pass variance must miss
        norm, conv = mods(nn.GroupNorm(32, 320), nn.Conv3d(320, 320, (3, 1, 1)))
        pk = K.tconv.pack_tconv(conv, norm)
        shape = fs["tconv"]
        dc = (None, dc_video(torch, gen, shape, dev)) if cfg == "mdm512" and batch == 2 else (None,)
        for xdc in dc:
            x = rand(*shape) if xdc is None else xdc
            cat, wcat = tap_concat(torch, x, norm), pk.wcat
            label = f"ds1 {'x'.join(map(str, shape))}"
            if xdc is None:
                plain = lambda: K.tconv.plain_gn_silu_tconv(x, norm, conv)   # noqa: E731
                faults = {"taps reversed": lambda: K.tconv.plain_gn_silu_tconv(
                    x, norm, taps_reversed(conv))}
            else:
                plain = lambda: f64_gn_silu_tconv(K, x, norm, conv)   # noqa: E731
                faults = {"one-pass variance": lambda: one_pass_gn_silu_tconv(x, norm, conv)}
                label += f" offset {DC_OFFSET:g}"
            yield Case("gn_silu_tconv", cfg, label, 20 if xdc is None else 0,
                       work_tconv(*shape),
                       lambda: K.tconv.fused_gn_silu_tconv(x, norm, conv, pk), plain, None,
                       None, faults, reruns=1,
                       yardsticks={"cublas_tap_gemm_ms": lambda: F.linear(cat, wcat)})
        for label, b, l, heads, sites, is_f32 in fs["flash"]:
            qkv = rand(b, l, 3, heads, 64, dtype=f32 if is_f32 else bf)
            yield flash_case(torch, K, nn_att, cfg, label, sites, qkv)


def tf32_rounded(torch, x):
    """x rounded once to TF32 (to nearest, ties away from zero, as
    cvt.rna.tf32.f32), in fp32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def flash_case(torch, K, nn_att, cfg, label, sites, qkv):
    """Kernel 5 on the strided q, k, v views of one (B, L, 3, H, 64) tensor;
    the planted fault attends to half the keys. fp32 is held to F32_TOL and
    F32_LSE_TOL, with its bound from three TF32 products per product
    (PEAK_TF32), and must see one more fault: "1xTF32", the plain attention
    on operands rounded once to TF32."""
    q, k, v = qkv.unbind(2)
    b, l, heads, _ = q.shape
    f32 = q.dtype == torch.float32
    faults = {"half the keys": lambda: nn_att.plain_attend(
        q, k[:, :l // 2], v[:, :l // 2], with_lse=True)}
    if f32:
        faults["1xTF32"] = lambda: nn_att.plain_attend(
            *(tf32_rounded(torch, t) for t in (q, k, v)), with_lse=True)
    return Case("flash_attention", cfg, f"{label} {b}x{l}x{heads}x64", sites,
                work_flash(b, l, heads, 64, q.element_size()),
                lambda: K.flash_attention.flash_attention(q, k, v),
                lambda: K.flash_attention.plain_flash_attention(q, k, v),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
                None, faults,
                tol=F32_TOL if f32 else TOL, peak=PEAK_TF32 if f32 else PEAK_FLOPS,
                lse_tol=F32_LSE_TOL if f32 else LSE_TOL)


def sdpa_backward(torch, q, k, v, do):
    """The backward of torch's scaled_dot_product_attention under autograd
    on the same inputs, as a timed yardstick (its forward runs once, at the
    first call)."""
    state = {}

    def run():
        if not state:
            with torch.enable_grad():
                ts = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
                state["out"] = torch.nn.functional.scaled_dot_product_attention(*ts)
            state["ts"] = ts
        return torch.autograd.grad(state["out"], state["ts"], do.transpose(1, 2),
                                   retain_graph=True)
    return run


def half_keys_flash_bwd(torch, K, q, k, v, o, lse, do):
    """Kernel 6's function walking the first half of the K/V tiles only,
    with the second half's dk and dv left zero."""
    half = q.shape[1] // 2
    dq, dk, dv = K.flash_attention.plain_flash_attention_bwd(q, k[:, :half], v[:, :half], o,
                                                           lse, do)
    pad = (0, 0, 0, 0, 0, q.shape[1] - half)
    return dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)


def grad_cases(torch, K, nn_att, dev="cuda", latent=None):
    """Yield a Case for every backward-kernel shape of a training micro-step
    (batch 1, 16 frames): kernel 6 at the MDM512 and MDM1024 training
    lengths, each after kernel 5 at the same shape, and kernels 9 and 10
    at every MDM512 and MDM1024 training site, with fp32 parameters (the
    training masters) and bf16 activations.
    `latent` maps a configuration to its (h, w) (default LATENT)."""
    from torch import nn

    latent = latent or LATENT
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    # kernel 10's cuBLAS yardstick takes its h and [du | dg] from a generator
    # of its own, so every case's inputs stay as they were without it
    gemm_gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    FA, TA, M = K.flash_attention, K.temporal_attn, K.mlp

    def rand(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def mods(*ms):
        return [randomize_(torch, m.to(dev), gen) for m in ms]

    def flat(out):
        dx, *rest = out
        return (dx, *[g for gs in rest for g in (gs if isinstance(gs, tuple) else (gs,))])

    # kernels 5 and 6 at each training length (batch 1 x 16 frames), in
    # bf16 and, at MDM512 ds1 and ds2, in fp32; and a tail shape whose L %
    # 128 = 64 (the last 128-row block half empty) with B*H = 9 pairs of
    # blocks, in bf16 and in fp32
    flash = [(cfg, label, TRAIN_FRAMES, latent[base][0] * latent[base][1] // 4 ** i,
              5 * 2 ** i, 5 if cfg == base else 0, dtype)
             for cfg, base, labels, dtype in (
                 ("mdm512", "mdm512", ("ds1", "ds2"), bf),
                 ("mdm1024", "mdm1024", ("ds1", "ds2", "ds4"), bf),
                 ("mdm512-f32", "mdm512", ("ds1", "ds2"), torch.float32))
             for i, label in enumerate(labels)]
    flash += [("tail", "L%128=64", 3, 576, 3, 0, bf),
              ("tail-f32", "L%128=64", 3, 576, 3, 0, torch.float32)]
    for cfg, label, b, l, heads, sites, dtype in flash:
        qkv = rand(b, l, 3, heads, 64, dtype=dtype)
        # kernel 5 at the shape (~N(0, 1) logits, as in its forward cases);
        # sites 0: checked and timed, not in the sums
        yield flash_case(torch, K, nn_att, cfg, f"train {label}", 0, qkv)
        q0, k0, v = qkv.unbind(2)
        q, k = q0 * SHARPEN, k0 * SHARPEN   # peaked logits
        o, lse = FA.plain_flash_attention(q, k, v)
        do = rand(b, l, heads, 64, dtype=dtype)
        zero = torch.zeros_like(lse)
        f32 = dtype == torch.float32
        faults = {"delta dropped": lambda: FA.plain_flash_attention_bwd(
                      q, k, v, o, lse, do, delta=zero),
                  "half the keys": lambda: half_keys_flash_bwd(torch, K, q, k, v, o, lse, do)}
        if f32:
            faults["1xTF32"] = lambda: FA.plain_flash_attention_bwd(
                *(tf32_rounded(torch, t) for t in (q, k, v)), o, lse, tf32_rounded(torch, do))
        yield Case("flash_attention_bwd", cfg, f"{label} {b}x{l}x{heads}x64", sites,
                   work_flash_bwd(b, l, heads, 64, q.element_size()),
                   lambda: FA.flash_attention_bwd(q, k, v, o, lse, do),
                   lambda: FA.plain_flash_attention_bwd(q, k, v, o, lse, do),
                   sdpa_backward(torch, q, k, v, do), None, faults,
                   grads=True, peak=PEAK_TF32 if f32 else PEAK_FLOPS,
                   grad_tol=F32_BWD_TOL if f32 else BWD_TOL, reruns=1)

    for cfg in ("mdm512", "mdm1024"):
        h, w = latent[cfg]
        n_seq = h * w
        for c, sites, label in ((320, 5, "ds1"), (512, 1, "init_attn")):
            heads = c // 64
            n1, a1, n2, a2 = mods(nn.LayerNorm(c), nn_att.CrossAttention(c, heads=heads),
                                  nn.LayerNorm(c), nn_att.CrossAttention(c, heads=heads))
            sharpen_(a1), sharpen_(a2)
            p1, p2 = TA.stage_params(n1, a1), TA.stage_params(n2, a2)
            x = rand(n_seq, 16, c)
            h1 = TA.plain_stage(x, p1, heads)
            dy = rand(n_seq, 16, c)

            def faulty(x=x, h1=h1, dy=dy, p1=p1, p2=p2, heads=heads):
                dh1, g2 = TA.plain_temporal_stage_bwd(h1, dy, p2, heads, drop_rowsum=True)
                dx, g1 = TA.plain_temporal_stage_bwd(x, dh1, p1, heads, drop_rowsum=True)
                return flat((dx, g1, g2))

            yield Case("temporal_attn_bwd", cfg, f"{label} {n_seq * 16}x{c}", sites,
                       work_temporal_bwd(n_seq * 16, c),
                       lambda: flat(TA.double_self_attn_bwd(x, h1, dy, p1, p2, heads)),
                       lambda: flat(_plain_double_bwd(TA, x, h1, dy, p1, p2, heads)),
                       None, None, {"row-sum term dropped": faulty}, grads=True, reruns=1,
                       yardsticks={"cublas_gemm_ms": temporal_bwd_products(
                           torch, x, dy, (p1, p2), gemm_gen)})

        # (rows, C, sites): ds1, init_attn, ds2, ds4 and, at MDM1024 only,
        # the middle block (MDM512's has 640 rows, not a multiple of 256)
        tok = [16 * h * w // 4 ** i for i in range(4)]
        shapes = [(tok[0], 320, 10), (tok[0], 512, 1), (tok[1], 640, 10), (tok[2], 1280, 10)]
        if cfg == "mdm1024":
            shapes.append((tok[3], 1280, 2))
        for m, c, sites in shapes:
            (ff,) = mods(nn_att.FeedForward(c))
            w1, b1, w2, _ = M.ff_params(ff)
            x, dy = rand(m, c), rand(m, c)
            yield Case("geglu_ff_bwd", cfg, f"{m}x{c}", sites, work_ff_bwd(m, c),
                       lambda: M.geglu_ff_bwd(x, dy, w1, b1, w2),
                       lambda: M.plain_geglu_ff_bwd(x, dy, w1, b1, w2), None, None,
                       {"g pdf(g) term dropped": lambda: M.plain_geglu_ff_bwd(
                           x, dy, w1, b1, w2, drop_pdf_term=True)}, grads=True, reruns=1,
                       yardsticks={"cublas_gemm_ms": ff_bwd_products(torch, x, dy, w1, w2,
                                                                     gemm_gen)})


def ff_bwd_products(torch, x, dy, w1, w2, gen):
    """Kernel 10's six products alone in cuBLAS on its inputs and random h
    and [du | dg] (made here, outside the timed call): x by W1's value and
    gate halves, dy by W2, [du | dg] by W1, dy^T h, [du | dg]^T x, all
    bf16."""
    inner = w2.shape[1]
    w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    h, dudg = (torch.randn((x.shape[0], n), generator=gen, device=x.device).to(torch.bfloat16)
               for n in (inner, 2 * inner))
    F = torch.nn.functional
    return lambda: (F.linear(x, w1b[:inner]), F.linear(x, w1b[inner:]), dy @ w2b, dudg @ w1b,
                    dy.T @ h, dudg.T @ x)


def temporal_bwd_products(torch, x, dy, stages, gen):
    """Kernel 9's five products per stage alone in cuBLAS, for both stages,
    on its dy and weights and random xn, o and dqkv (made here, outside the
    timed call): xn by Wqkv'^T, dy by Wo, dqkv^T xn, dy^T o, dqkv by Wqkv',
    all bf16."""
    rows, c = x.shape[0] * x.shape[1], x.shape[2]
    bf = torch.bfloat16
    dyb = dy.reshape(rows, c)
    mats = []
    for ln_w, ln_b, wq, wk, wv, wo, bo in stages:
        wqkv = torch.cat([wq, wk, wv]).to(bf)
        xn, o, dqkv = (torch.randn((rows, n), generator=gen, device=x.device).to(bf)
                       for n in (c, c, 3 * c))
        mats.append((wqkv, wo.to(bf), xn, o, dqkv))
    F = torch.nn.functional
    return lambda: [(F.linear(xn, wqkv), dyb @ wo, dqkv.T @ xn, dyb.T @ o, dqkv @ wqkv)
                    for wqkv, wo, xn, o, dqkv in mats]


def _plain_double_bwd(TA, x, h1, dy, p1, p2, heads):
    dh1, g2 = TA.plain_temporal_stage_bwd(h1, dy, p2, heads)
    dx, g1 = TA.plain_temporal_stage_bwd(x, dh1, p1, heads)
    return dx, g1, g2


def work_norm(numel, c, itemsize):
    """A norm's bytes: x read and y written once, w and b (fp32) read once;
    its ~10 fp32 operations per element take no tensor-core time (0)."""
    return 0, 2 * numel * itemsize + 2 * 4 * c


def work_short(b, lq, lk, h, d, itemsize=2):
    """Attention of lq queries over lk keys per (batch, head): the 2 lq x lk x d
    products; q and o, k and v read or written once."""
    return 4 * b * h * lq * lk * d, itemsize * (2 * b * lq * h * d + 2 * b * lk * h * d)


def op_grads(torch, fn, inputs, dy):
    """Gradients of fn(*inputs) for the upstream dy, to every input."""
    ins = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = fn(*ins)
        return torch.autograd.grad(out, ins, dy)


def norm_short_cases(torch, N, SA, dev="cuda", gn=None, ln=None, skv=None, packed=None,
                     offset_shape=(32, 20, 32, 640), packed_extra=None):
    """Yield a Case for kernel 11 (GroupNorm, LayerNorm) and kernel 12
    (short-KV, packed) at every site shape of the switch path (GN_SHAPES,
    LN_SHAPES, SKV_SHAPES: config -> {shape: sites per UNet forward}), in
    bf16, or in fp32 for a config named "<cfg>-f32" (within F32_TOL), and
    the packed kernel at PACKED_SHAPES (one site each) and PACKED_EXTRA
    (none); GN in fp32 at a DC offset of 1e3 at
    `offset_shape` against the plain version run in float64; then each
    autograd op's gradients against autograd of its plain math at its first
    shape. Norm inputs carry per-channel means and scales (a group's
    statistics then depend on which channels it holds) and a row offset of 3
    (a LayerNorm that skips the mean shows)."""
    gn, ln = gn or GN_SHAPES, ln or LN_SHAPES
    skv, packed = skv or SKV_SHAPES, packed or PACKED_SHAPES
    packed_extra = PACKED_EXTRA if packed_extra is None else packed_extra
    bf, f4 = torch.bfloat16, torch.float32
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f4)

    def dtype_of(cfg):
        return f4 if cfg.endswith("-f32") else bf

    def checks(dtype):   # (tolerance, rate of the operations in the bound)
        return dict(tol=TOL, peak=PEAK_FLOPS) if dtype == bf else dict(tol=F32_TOL,
                                                                          peak=PEAK_FP32)

    def named(cfg, shape):
        return f"{cfg} {'x'.join(map(str, shape))}"

    def norm_input(shape, dtype, offset=0.0):
        c = shape[-1]
        x = randn(*shape) * (0.5 + randn(c).abs()) + 3.0 * randn(c) + 3.0 + offset
        return x.to(dtype), 1.0 + 0.1 * randn(c), 0.1 * randn(c)

    def gn_case(cfg, shape, sites, dtype, eps, offset=0.0):
        x, w, b = norm_input(shape, dtype, offset)
        xc = x.movedim(-1, 1)   # (N, C, ...) with channels-last strides
        plain = lambda: N.plain_group_norm(x, w, b, 32, eps)   # noqa: E731
        faults = {"groups shifted by one channel": lambda: N.plain_group_norm(
            x, w, b, 32, eps, shift_groups=1)}
        label = named(cfg, shape)
        if offset:
            plain = lambda: N.plain_group_norm(x.double(), w.double(), b.double(), 32,  # noqa
                                               eps).float()
            faults = {"one-pass variance": lambda: N.plain_group_norm(x, w, b, 32, eps,
                                                                        one_pass=True)}
            label += f" offset {offset:g}"
        return Case("group_norm", cfg, label, sites, work_norm(x.numel(), shape[-1],
                                                                x.element_size()),
                    lambda: N.fused_group_norm(x, w, b, 32, eps), plain,
                    lambda: F.group_norm(xc, 32, w.to(dtype), b.to(dtype), eps), None, faults,
                    tol=checks(dtype)["tol"], reruns=1, note=N.plan_text("group_norm", x))

    def ln_case(cfg, shape, sites, dtype):
        x, w, b = norm_input(shape, dtype)
        return Case("layer_norm", cfg, named(cfg, shape), sites,
                    work_norm(x.numel(), shape[-1], x.element_size()),
                    lambda: N.fused_layer_norm(x, w, b, 1e-5),
                    lambda: N.plain_layer_norm(x, w, b, 1e-5),
                    lambda: F.layer_norm(x, (shape[-1],), w.to(dtype), b.to(dtype), 1e-5),
                    None, {"mean not subtracted": lambda: N.plain_layer_norm(
                        x, w, b, 1e-5, center=False)}, tol=checks(dtype)["tol"], reruns=1,
                    note=N.plan_text("layer_norm", x))

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2))

    def skv_inputs(qs, ks, dtype):
        q = randn(*qs).to(dtype)
        k, v = randn(ks[0], ks[1], 2, *ks[2:]).to(dtype).unbind(2)   # strided, as a k|v buffer
        return q, k, v

    def skv_case(cfg, qs, ks, sites, dtype):
        """fp32 short-KV (3xTF32 wgmma) is bound at PEAK_TF32 (the FMA bound
        printed beside it), must see the "1xTF32" fault too (the plain
        version on operands rounded once to TF32) and reruns bit for bit,
        SKV_RERUNS times: a race in its q ring once changed one row of one
        tile in about one call in twelve at Lk = 16."""
        q, k, v = skv_inputs(qs, ks, dtype)
        lk = ks[1]
        pad = (0, 0, 0, 0, 0, -lk % 64)
        faults = {}
        if lk % 64:   # the zero keys that fill the last 64-key box
            faults["padded keys unmasked"] = lambda: SA.plain_short_attention(
                q, F.pad(k, pad), F.pad(v, pad))
        if lk > 1:
            faults["half the keys"] = lambda: SA.plain_short_attention(
                q, k[:, :lk // 2], v[:, :lk // 2])
        else:   # one key (DepthLab's context token): each head reads the next head's value
            faults["another head's value"] = lambda: SA.plain_short_attention(
                q, k, v.roll(1, dims=2))
        f32 = dtype == f4
        if f32:
            faults["1xTF32"] = lambda: SA.plain_short_attention(
                *(tf32_rounded(torch, t) for t in (q, k, v)))
        return Case("short_kv_attention", cfg, f"{cfg} q {'x'.join(map(str, qs))} Lk {lk}",
                    sites, work_short(qs[0], qs[1], lk, qs[2], qs[3], q.element_size()),
                    lambda: SA.short_kv_attention(q, k, v),
                    lambda: SA.plain_short_attention(q, k, v), lambda: sdpa(q, k, v), None,
                    faults, tol=checks(dtype)["tol"], peak=PEAK_TF32 if f32 else PEAK_FLOPS,
                    reruns=SKV_RERUNS if f32 else 0, note=SA.plan_text(q, k))

    def packed_inputs(shape):
        b, t, h, d = shape
        return randn(b, t, 3, h, d).to(bf).unbind(2)   # strided, as a q|k|v projection

    for cfg, shapes in gn.items():
        for shape, sites in shapes.items():
            yield gn_case(cfg, shape, sites, dtype_of(cfg), 1e-6 if cfg == "vae" else 1e-5)
    yield gn_case("fp32", offset_shape, 0, f4, 1e-5, offset=DC_OFFSET)
    for cfg, shapes in ln.items():
        for shape, sites in shapes.items():
            yield ln_case(cfg, shape, sites, dtype_of(cfg))
    for cfg, shapes in skv.items():
        for (qs, ks), sites in shapes.items():
            yield skv_case(cfg, qs, ks, sites, dtype_of(cfg))
    for shape, sites in [*((s, 1) for s in packed), *((s, 0) for s in packed_extra)]:
        q, k, v = packed_inputs(shape)
        b, t, h, d = shape
        flat = [z.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous() for z in (q, k, v)]
        yield Case("packed_short_attention", "temporal" if sites else "extra",
                   "x".join(map(str, shape)), sites,
                   work_short(b, t, t, h, d),
                   lambda: SA.packed_short_attention(q, k, v),
                   lambda: SA.plain_short_attention(q, k, v),
                   lambda: F.scaled_dot_product_attention(*flat), None,
                   {"another sequence's keys": lambda: SA.plain_short_attention(
                       q, k.roll(1, 0), v.roll(1, 0))}, note=SA.plan_text(q))

    # gradients through each autograd op (backward: the plain math), bf16, at
    # the first shape of each table
    gshape = next(iter(next(iter(gn.values()))))
    x, w, b = norm_input(gshape, bf)
    dy = randn(*gshape).to(bf)
    yield Case("group_norm", "grad", f"op {'x'.join(map(str, gshape))}", 0,
               work_norm(2 * x.numel(), gshape[-1], 2),
               lambda: op_grads(torch, lambda *a: N.group_norm_op(*a, 32, 1e-5), (x, w, b), dy),
               lambda: op_grads(torch, lambda *a: N.plain_group_norm(*a, 32, 1e-5), (x, w, b),
                                dy), None, None, {}, grads=True)
    lshape = next(iter(next(iter(ln.values()))))
    xl, wl, bl = norm_input(lshape, bf)
    dyl = randn(*lshape).to(bf)
    yield Case("layer_norm", "grad", f"op {'x'.join(map(str, lshape))}", 0,
               work_norm(2 * xl.numel(), lshape[-1], 2),
               lambda: op_grads(torch, lambda *a: N.layer_norm_op(*a, 1e-5), (xl, wl, bl), dyl),
               lambda: op_grads(torch, lambda *a: N.plain_layer_norm(*a, 1e-5), (xl, wl, bl),
                                dyl), None, None, {}, grads=True)
    qs, ks = next(iter(next(iter(skv.values()))))
    qa, ka, va = skv_inputs(qs, ks, bf)
    dya = randn(*qs).to(bf)
    yield Case("short_kv_attention", "grad", f"op q {'x'.join(map(str, qs))} Lk {ks[1]}", 0,
               work_short(qs[0], qs[1], ks[1], qs[2], qs[3]),
               lambda: op_grads(torch, SA.short_kv_attention_op, (qa, ka, va), dya),
               lambda: op_grads(torch, SA.plain_short_attention, (qa, ka, va), dya),
               None, None, {}, grads=True)
    pb, pt, ph, pd = packed[-1]
    qp, kp, vp = packed_inputs(packed[-1])
    dyp = randn(*packed[-1]).to(bf)
    yield Case("packed_short_attention", "grad", f"op {pb}x{pt}x{ph}x{pd}", 0,
               work_short(pb, pt, pt, ph, pd),
               lambda: op_grads(torch, SA.packed_short_attention_op, (qp, kp, vp), dyp),
               lambda: op_grads(torch, SA.plain_short_attention, (qp, kp, vp), dyp),
               None, None, {}, grads=True)


def reruns_bit_for_bit(torch, case):
    """A case with `reruns` gives the same bits on each rerun: no atomics (the
    GroupNorm, alone and in kernel 4, merges its partial statistics in a
    fixed order; kernel 4's GEMM sums K in one order; kernel 6 writes every
    gradient element from one block; kernels 9 and 10 add their split
    partials and column sums in a fixed order; fp32 short-KV writes each
    output row from one warpgroup)."""
    if not case.reruns:
        return True
    a = case.kernel()
    a = a if isinstance(a, tuple) else (a,)
    same = True
    for _ in range(case.reruns):
        b = case.kernel()
        b = b if isinstance(b, tuple) else (b,)
        same &= all(torch.equal(x, y) for x, y in zip(a, b))
    if not same:
        log(f"  {case.name} {case.label}: a rerun differs")
    return same


# what phase 11 sums per configuration over one UNet forward's kernel-11
# sites: per call alone, queued, device (profiler), the wrapper's host time,
# the bound, the plain version and the library call (alone and queued)
NORM_SUMS = ("ms", "ms_queued", "norm_device_ms", "host_ms", "bound_ms", "plain_ms",
             "library_ms", "library_ms_queued")


def phase_norm_short(torch, K, N, SA, profile=False):
    """Kernels 11 and 12 against their plain versions (phase 11), GN reruns
    bit for bit, then the packed kernel's path: its public function at the
    temporal-attention shapes, counts reset just before and read just
    after."""
    rows = run_cases(torch, norm_short_cases(torch, N, SA),
                     check=lambda case: reruns_bit_for_bit(torch, case), profile=profile)
    plans = {"ln_kernels": ln_kernels_side_by_side(torch, N),
             "gn_clusters": gn_cluster_answers(N)}
    for name in ("group_norm", "layer_norm"):
        for cfg in ("mdm512", "mdm1024"):
            shapes = [s for s in rows[name]["shapes"] if s["config"] == cfg]
            sums = {k: sum(s["sites"] * (s.get(k) or 0.0) for s in shapes)
                    for k in NORM_SUMS}
            log(f"  {name} {cfg}, one UNet forward's {sum(s['sites'] for s in shapes)} sites: "
                + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    inputs = [torch.randn((b, t, 3, h, d), generator=gen, device="cuda").bfloat16().unbind(2)
              for b, t, h, d in PACKED_SHAPES]
    K.reset_launch_counts()
    outs = [SA.packed_short_attention(q, k, v) for q, k, v in inputs]
    torch.cuda.synchronize()
    counts = K.launch_counts()
    expect = {**{k: 0 for k in counts}, "packed_short_attention": len(PACKED_SHAPES)}
    log(f"  packed path: {[tuple(o.shape) for o in outs]}, launches {counts}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    for o, (q, _, _) in zip(outs, inputs):
        if o.shape != q.shape or not bool(torch.isfinite(o).all().item()):
            raise AssertionError(f"packed output {tuple(o.shape)} not finite or misshapen")
    return rows, counts, plans


def graph_ms(torch, fns, calls=20, reps=7):
    """Device time per call in ms of each fn (name -> fn): a CUDA graph of
    `calls` calls of it, the graphs replayed in turns (forward, then
    backward order) `reps` times, the least replay of each; the host's
    per-call cost stays out of a graph."""
    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(calls):
                fn()
    best = dict.fromkeys(graphs, float("inf"))
    for _ in range(reps):
        for name in list(graphs) + list(graphs)[::-1]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graphs[name].replay()
            b.record()
            b.synchronize()
            best[name] = min(best[name], a.elapsed_time(b) / calls)
    return best


def ln_kernels_side_by_side(torch, N, ln=None):
    """The LayerNorm's two kernels (`mudg_layer_norm_w`'s kernel 0, the row
    kernel, and 1, the tile kernel) at every LN_SHAPES shape: each within
    the kernel-11 tolerance of the plain version, and its device time per
    launch (graph_ms) beside the plan's pick (`csrc/norms.cu:ln_plan`'s
    switch rests on these times). Raises if either is out of tolerance."""
    from mudg_tpu_torch.kernels import _build

    lib = _build.load()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    out, bad = [], []
    for cfg, shapes in (ln or LN_SHAPES).items():
        f32 = cfg.endswith("-f32")
        for shape in shapes:
            c, rows = shape[-1], math.prod(shape[:-1])
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 3).to(
                torch.float32 if f32 else torch.bfloat16)
            w = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
            b = 0.1 * torch.randn(c, generator=gen, device="cuda")
            ref = N.plain_layer_norm(x, w, b, 1e-5).float()
            tol = (F32_TOL if f32 else TOL) * ref.abs().max().item()
            ys = {}

            def launch(kernel, y):
                def fn():
                    _build.check(lib.mudg_layer_norm_w(
                        x.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(), 0, rows, c,
                        int(f32), kernel, 1e-5, _build.stream(x.device)), "mudg_layer_norm_w")
                return fn

            fns = {}
            for name, kernel in (("row", 0), ("tile", 1)):
                ys[name] = torch.empty_like(x)
                fns[name] = launch(kernel, ys[name])
                fns[name]()
            errs = {k: (y.float() - ref).abs().max().item() for k, y in ys.items()}
            ms = graph_ms(torch, fns)
            pick = "tile" if N.ln_plan_card(rows, c, x.element_size())[0] else "row"
            label = f"{cfg} {'x'.join(map(str, shape))}"
            ok = all(e <= tol for e in errs.values())
            if not ok:
                bad.append(label)
            log(f"  layer_norm kernels {label:26s} row {1e3 * ms['row']:8.2f} us, tile "
                f"{1e3 * ms['tile']:8.2f} us, plan: {pick}; max|diff| row {errs['row']:.3e}, "
                f"tile {errs['tile']:.3e} <= {tol:.3e}: {'ok' if ok else 'FAIL'}")
            out.append({"config": cfg, "shape": list(shape), "row_ms": ms["row"],
                        "tile_ms": ms["tile"], "plan": pick, "max_abs_err": errs})
    if bad:
        raise AssertionError(f"LayerNorm kernels out of tolerance at {bad}")
    return out


def gn_cluster_answers(N, gn=None):
    """The card's answer to every question gn_plan asks at the GN_SHAPES
    shapes and GN_LARGEST: [cluster, c, smem, itemsize, silu, the clusters
    the card holds at once (cudaOccupancyMaxActiveClusters)], as
    tests/data/h100_gn_clusters.json records them for the CPU tests."""
    seen = {}

    def ask(*key):
        if key not in seen:
            seen[key] = N._card_clusters(*key)
        return seen[key]

    for cfg, shapes in (gn or GN_SHAPES).items():
        for shape in shapes:
            N.gn_plan(shape[0], math.prod(shape[1:-1]), shape[-1],
                      4 if cfg.endswith("-f32") else 2, 32, False, active=ask)
    for n, rows, c, itemsize, silu in GN_LARGEST:
        N.gn_plan(n, rows, c, itemsize, 32, silu, active=ask)
    log(f"  gn_plan asked the card {len(seen)} questions")
    return [[*k, v] for k, v in sorted(seen.items())]


class Check(NamedTuple):
    ok: bool
    err: float           # max|diff| of the kernel's part against the plain version's
    scale: float         # max|plain version's part|
    lse_err: float | None
    faults: dict         # planted fault -> its max|diff| against the plain version
    tol: float = TOL     # the check is err <= tol * scale
    abs_err: float = 0.0   # max|diff| over every output


def compare_grads(torch, case):
    """A backward kernel against its plain version: each gradient within
    max|diff| <= case.grad_tol (BWD_TOL, or F32_BWD_TOL in fp32) * max|its
    ref|. err is the largest such ratio (scale 1), a planted fault's the
    largest ratio over its gradients; each fault must pass the tolerance on
    some gradient."""
    got = case.kernel()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ref = case.plain()

    def ratios(out):
        diffs = [(o.float() - r.float()).abs().max().item() for o, r in zip(out, ref)]
        return [d / max(r.float().abs().max().item(), 1e-30) for d, r in zip(diffs, ref)], diffs

    rel, diffs = ratios(got)
    tol = case.grad_tol
    ok = all(bool(torch.isfinite(g).all().item()) for g in got) and max(rel) <= tol
    del got
    faults = {}
    for name, fn in case.faults.items():
        faults[name] = max(ratios(fn())[0])
        ok &= faults[name] > tol
    return Check(ok, max(rel), 1.0, None, faults, tol, max(diffs))


def compare(torch, case):
    """The kernel against its plain version on one case: max|diff| <= tol *
    max|ref| on output - base, kernel 5's lse within case.lse_tol, and every
    planted fault beyond tol * max|ref| (else the check could not see it)."""
    if case.grads:
        return compare_grads(torch, case)

    def part(out):
        o = (out[0] if isinstance(out, tuple) else out).float()
        return o - case.base.float() if case.base is not None else o

    got = case.kernel()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ref = case.plain()
    go, ro = part(got), part(ref)
    err = (go - ro).abs().max().item()
    scale = ro.abs().max().item()
    ok = bool(torch.isfinite(go).all().item()) and err <= case.tol * scale
    lse_err = None
    if isinstance(got, tuple):
        lse_err = (got[1] - ref[1]).abs().max().item()
        ok &= lse_err <= case.lse_tol
    del got, go
    faults = {}
    for name, fn in case.faults.items():
        # a fault whose output is not finite counts as missing the bound (the
        # kernel's own check requires finite values), recorded as float32's
        # largest value so that the JSON stays finite
        faults[name] = (part(fn()) - ro).abs().nan_to_num(
            torch.finfo(torch.float32).max).max().item()
        ok &= faults[name] > case.tol * scale
    return Check(ok, err, scale, lse_err, faults, case.tol, err)


def phase_kernels(torch, K, nn_att, configs, profile=False):
    """Each kernel vs its plain version at every shape of `configs`, then
    each backward kernel at every training shape; kernels 4, 6, 9 and 10 rerun
    bit for bit."""
    import itertools

    return run_cases(torch, itertools.chain(kernel_cases(torch, K, nn_att, configs),
                                            grad_cases(torch, K, nn_att)),
                     check=lambda case: reruns_bit_for_bit(torch, case), profile=profile)


def run_cases(torch, cases, check=None, profile=False, iters=10):
    """Check and time each case (`check(case)` runs after its comparison;
    forward kernels and their plain versions the median of `iters` calls);
    returns the kernel table's rows, each shape's sites-weighted times
    summed per kernel. With `profile`, the kernels of NORM_PROFILED also
    get their device time per call under the profiler, all of it and
    kernel 11's part ("device_ms", "norm_device_ms"); kernel 11 and 12's
    forward cases always get both and the host time of the Python wrapper
    alone ("host_ms"). Raises if any case failed."""
    rows = {}
    for case in cases:
        chk = compare(torch, case)
        if check is not None:
            chk = chk._replace(ok=chk.ok and check(case))
        fk, fp, flib = case.kernel, case.plain, case.library
        reps = dict(iters=3, warmup=1) if case.grads else dict(iters=iters, warmup=min(2, iters))
        dev = {}
        norm = case.name in SWITCH_KERNELS and not case.grads
        if norm or (profile and case.name in NORM_PROFILED):
            dev = device_ms_per_call(torch, fk)
        if norm:
            dev["host_ms"] = host_ms_per_call(torch, fk)
        # the plain version (up to 1 s a call) is timed at most 3 times after one warm-up
        ms, pms = cuda_ms(torch, fk, **reps), cuda_ms(torch, fp, iters=min(3, reps["iters"]),
                                                      warmup=1)
        lms = cuda_ms(torch, flib, **reps) if flib is not None else None
        yms = {k: cuda_ms(torch, fn) for k, fn in case.yardsticks.items()}
        yms.update({k + "_queued": cuda_ms_queued(torch, fn) for k, fn in case.yardsticks.items()})
        qms = cuda_ms_queued(torch, fk, iters) if not case.grads else None
        lqms = cuda_ms_queued(torch, flib, iters) if flib is not None and not case.grads else None
        flops, nbytes = case.work
        bms, by = bound(flops, nbytes, case.peak)
        extra_bound = {}
        if case.name == "flash_attention_bwd":   # the two-kernel design's own bound
            extra_bound["design_bound_ms"] = bound(flops * FLASH_BWD_DESIGN, nbytes,
                                                   case.peak)[0]
        if case.peak == PEAK_TF32:   # the same work on the FMA units
            extra_bound["fma_bound_ms"] = bound(flops, nbytes, PEAK_FP32)[0]
        extra = (f", lse max|diff| {chk.lse_err:.3e} <= {case.lse_tol}"
                 if chk.lse_err is not None else "")
        extra += "".join(f", {n} {e:.3e}" for n, e in chk.faults.items())
        what = ("max|diff|/max|ref| over the gradients" if case.grads else
                f"max|diff|{' - x' if case.base is not None else ''}")
        log(f"  {case.name:19s} {case.config:7s} {case.label:26s} "
            f"{what} {chk.err:.4e} <= {chk.tol} * "
            f"{chk.scale:.3e}{extra}: {'ok' if chk.ok else 'FAIL'}   kernel {ms:.3f} ms"
            + (f" (queued {qms:.3f} ms)" if qms is not None else "")
            + f"   plain {pms:.3f} ms"
            + (f"   library {lms:.3f} ms" if lms is not None else "")
            + (f" (queued {lqms:.3f} ms)" if lqms is not None else "")
            + "".join(f"   {k} {v:.3f}" for k, v in yms.items())
            + f"   bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of it)"
            + (f"   FMA bound {extra_bound['fma_bound_ms']:.4f} ms"
               if "fma_bound_ms" in extra_bound else "")
            + "".join(f"   {k} {v:.4f}" for k, v in dev.items())
            + (f"   plan {case.note}" if case.note else ""))
        r = rows.setdefault(case.name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "library_ms": None, "ok": True,
                                        "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], chk.abs_err)
        r["ms"] += case.sites * ms
        r["plain_ms"] += case.sites * pms
        r["bound_ms"] += case.sites * bms
        if lms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + case.sites * lms
        for k, v in yms.items():
            r[k] = r.get(k, 0.0) + case.sites * v
        if qms is not None:
            r["ms_queued"] = r.get("ms_queued", 0.0) + case.sites * qms
        if lqms is not None:
            r["library_ms_queued"] = r.get("library_ms_queued", 0.0) + case.sites * lqms
        for k, v in dev.items():
            r[k] = r.get(k, 0.0) + case.sites * v
        r["ok"] &= chk.ok
        r["shapes"].append({"config": case.config, "shape": case.label, "sites": case.sites,
                            "max_abs_err": chk.abs_err, "err": chk.err, "tol": chk.tol,
                            "max_abs_ref": chk.scale,
                            "residual_free": case.base is not None, "lse_err": chk.lse_err,
                            "fault_errs": chk.faults, "ms": ms, "ms_queued": qms,
                            "plain_ms": pms,
                            "library_ms": lms, "library_ms_queued": lqms, **yms,
                            "bound_ms": bms,
                            "bound_by": by,
                            "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **extra_bound,
                            **dev, "plan": case.note})
        del case, fk, fp, flib
        torch.cuda.empty_cache()
    for r in rows.values():   # what bounds most of the row's forward-weighted bound
        top = max(r["shapes"], key=lambda s: (s["sites"] * s["bound_ms"], s["bound_ms"]))
        r["bound_by"] = top["bound_by"]
    bad = [n for n, r in rows.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows


def build_unet(torch, U, gen, dtype):
    with torch.device("meta"):
        unet = U.UNet3D(U.UNetConfig())
    unet.to_empty(device="cuda")
    randomize_(torch, unet, gen)
    return unet.to(dtype).eval()


def unet_inputs(torch, gen, dtype, cfg, batch=2):
    h, w = LATENT[cfg]

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * scale).to(dtype)
    x = rnd(batch, 16, h, w, 12)
    t = torch.full((batch,), 700, device="cuda")
    ctx = rnd(batch, 77 + 16 * 16, 1024)
    lab = torch.zeros(batch, dtype=torch.int64, device="cuda")
    fs = torch.full((batch,), 10, dtype=torch.int64, device="cuda")
    return x, t, ctx, lab, fs


def phase_unet(torch, K, U, cfg, paths=("kernels",), batch=2):
    """One full-width UNet forward at `batch` on the plain fp32 path (TF32
    off, switches unset), the plain bf16 path and each kernel path of
    `paths`: "kernels" (phases 3 and 5), "switches", with
    MUDG_FUSED_NORMS=1 and MUDG_SHORT_ATTN=1 (phase 12a), and "off", the
    six opt-out switches (phase 13, `phase_opt_out`). Each kernel path's
    relative L2 error against fp32 within 1.5x the plain bf16 path's + 5e-3,
    launches at exactly its sites. With "switches", first an fp32 forward
    on it (impl="auto": kernels 11 and 12 and kernel 5 in fp32) within
    F32_PATH_TOL relative L2 of the fp32 plain one, launches at
    SWITCH_SITES_F32. Each path's forward is timed (median of 3; above batch
    2 the plain path's checked call and the kernel paths' median of 2 after
    the checked call). Returns the UNet (bf16, packed), the report
    and, with "off", phase 13's summed launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    unet = build_unet(torch, U, gen, torch.float32)
    n_params = sum(p.numel() for p in unet.parameters())
    x, t, ctx, lab, fs = unet_inputs(torch, gen, torch.float32, cfg, batch)
    report = {"params": n_params, "batch": batch}
    with torch.no_grad():
        ref = unet(x, t, ctx, c_label=lab, fs=fs, impl="plain")
        if "switches" in paths:
            with switches():
                K.reset_launch_counts()
                f32 = unet(x, t, ctx, c_label=lab, fs=fs, impl="auto")
                counts = K.launch_counts()
                ms_32 = cuda_ms(torch, lambda: unet(x, t, ctx, c_label=lab, fs=fs, impl="auto"),
                                iters=3, warmup=1)
            e32 = ((f32 - ref).norm() / ref.norm()).item()
            expect = {**dict.fromkeys(counts, 0), **SWITCH_SITES_F32[cfg]}
            log(f"  fp32 switch path: rel L2 vs fp32 plain {e32:.4e} (bound {F32_PATH_TOL}), "
                f"forward fp32 {ms_32:.1f} ms, kernel 5 at {counts['flash_attention']} sites, "
                f"launches {counts}")
            if not bool(torch.isfinite(f32).all().item()) or e32 > F32_PATH_TOL:
                raise AssertionError(f"fp32 switch-path error {e32:.4e} exceeds {F32_PATH_TOL}")
            if counts != expect:
                raise AssertionError(f"launch counts {counts} != {expect}")
            report.update({"rel_l2_switches_f32": e32, "ms_switches_f32": ms_32,
                           "launches_switches_f32": counts})
            del f32
        unet.to(torch.bfloat16)
        K.prepare_kernels(unet)
        xb, cb = x.bfloat16(), ctx.bfloat16()
        del x, ctx

        def run(impl):
            return unet(xb, t, cb, c_label=lab, fs=fs, impl=impl)

        if batch == 2:
            plain = run("plain")
            ms_p = cuda_ms(torch, lambda: run("plain"), iters=3, warmup=1)
        else:   # above batch 2 the checked call is the timed one
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            plain = run("plain")
            ev[1].record()
            torch.cuda.synchronize()
            ms_p = ev[0].elapsed_time(ev[1])

    def rel(a):
        return ((a.float() - ref).norm() / ref.norm()).item()

    e_p = rel(plain)
    err_bound = 1.5 * e_p + 5e-3
    del plain
    log(f"  UNet {n_params:,} params, batch {batch}; plain bf16 {ms_p:.1f} ms, rel L2 vs fp32 "
        f"{e_p:.4e}")
    report.update({"rel_l2_plain_bf16": e_p, "ms_plain": ms_p})
    if "off" in paths:
        report["switches_off"], launches = phase_opt_out(torch, K, cfg, run, rel, err_bound)
    for path in (p for p in paths if p != "off"):
        expect = SITES[cfg] if path == "kernels" else {**SITES[cfg], **SWITCH_SITES[cfg]}
        with switches(path == "switches"), torch.no_grad():
            K.reset_launch_counts()
            kern = run("auto")
            counts = K.launch_counts()
            ms_k = cuda_ms(torch, lambda: run("auto"),
                           **(dict(iters=3, warmup=1) if batch == 2 else dict(iters=2, warmup=0)))
        e_k = rel(kern)
        log(f"  {path} path: out {tuple(kern.shape)}, rel L2 vs fp32 {e_k:.4e} (bound "
            f"{err_bound:.4e}), forward bf16 {ms_k:.1f} ms")
        log(f"  launches per forward: {counts} (expected {expect})")
        if not bool(torch.isfinite(kern).all().item()):
            raise AssertionError(f"{path}-path UNet output is not finite")
        if e_k > err_bound:
            raise AssertionError(f"{path}-path error {e_k:.4e} exceeds {err_bound:.4e}")
        if counts != expect:
            raise AssertionError(f"launch counts {counts} != {expect}")
        del kern
        suffix = "" if path == "kernels" else "_switches"
        report.update({"rel_l2_kernels" + suffix: e_k, "ms_kernels" + suffix: ms_k})
    del ref
    return unet, report, (launches if "off" in paths else None)


def phase_opt_out(torch, K, cfg, run, rel, err_bound):
    """Phase 13: one bf16 UNet forward with each of the JAX package's six
    kernel opt-out switches set to "0" in-process, then with all six, each
    restored after: launches at SWITCHES_OFF (counts reset just before each
    forward, read just after), relative L2 error against fp32 within the
    phase-3/5 gate; every forward timed (one call after the checked one;
    the median of 3 until PR 19), so the kernel path stands beside each path
    JAX falls back to. Returns the report and the summed launches."""
    report, total = {}, {}
    for name, env, expect in opt_out_cases(cfg):
        with environ(env), torch.no_grad():
            K.reset_launch_counts()
            out = run("auto")
            counts = K.launch_counts()
            ms = cuda_ms(torch, lambda: run("auto"), iters=1, warmup=0)
        expect = {**dict.fromkeys(counts, 0), **expect}
        err = rel(out)
        ok = bool(torch.isfinite(out).all().item()) and err <= err_bound and counts == expect
        log(f"  {name}=0: rel L2 vs fp32 {err:.4e} (bound {err_bound:.4e}), launches "
            f"{ {k: v for k, v in counts.items() if v} }, forward bf16 {ms:.1f} ms: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}=0: error {err:.4e} (bound {err_bound:.4e}), "
                                 f"launches {counts} != {expect}")
        report[name] = {"rel_l2": err, "launches": counts, "ms": ms}
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del out
    return report, total


CATEGORIES = (("port kernels", ("mudg::",)),
              ("conv (cuDNN)", ("fprop", "conv", "implicit")),
              ("gemm (cuBLAS)", ("gemm", "nvjet", "cutlass")),
              ("softmax", ("softmax",)),
              ("reductions", ("reduce",)),
              ("elementwise / copy", ("elementwise", "copy", "cat", "index")))


# Kernels whose device time phases 2 and 11 take under the profiler with
# --profile: kernel 11 alone, and the kernels that run its code (the LN of
# kernels 1, 2, 3 and 9, kernel 4's GN passes); NORM_KERNEL matches kernel
# 11's device kernels by name
NORM_PROFILED = ("group_norm", "layer_norm", "spatial_attn", "temporal_attn", "geglu_ff",
                 "gn_silu_tconv", "temporal_attn_bwd")
NORM_KERNEL = re.compile(r"mudg::(gn|ln)_\w+")


CALL_RANGE = "mudg_profiled_call_"   # the profiler range of each call device_ms_per_call times
CALL_GAP_S = 0.002   # host seconds between two such ranges


def per_call_device_ms(spans, kernels):
    """Device time per call from a profile: `spans` the calls' ranges
    ((start, end) in us, each call waited for inside its own, CALL_GAP_S
    between two), `kernels` the device kernels ((name, start, duration in
    us)). A kernel belongs to the call whose range is nearest its start, so
    the profiler's placing of device events against the host's clock may be
    off by up to half the gap. The profiler can drop a call's kernels: only
    the calls that hold the most common count of kernels (the larger on a
    tie) are kept ("calls_held"). "device_ms", every kernel;
    "norm_device_ms", kernel 11's (NORM_KERNEL), with "norm_launch_ms" per
    launch of those and "norm_launches" per call. Raises where no call
    holds a kernel."""
    per_call = [[] for _ in spans]
    for k in kernels:
        per_call[min(range(len(spans)),
                     key=lambda i: max(spans[i][0] - k[1], k[1] - spans[i][1], 0.0))].append(k)
    counts = [len(ks) for ks in per_call]
    common = max(set(counts), key=lambda n: (counts.count(n), n), default=0)
    if common == 0:
        raise RuntimeError("per_call_device_ms: the profile holds no device kernel of any call")
    held = [ks for ks in per_call if len(ks) == common]
    total = sum(d for ks in held for _, _, d in ks) / 1e3
    norm = [d for ks in held for name, _, d in ks if NORM_KERNEL.search(name)]
    return {"device_ms": total / len(held), "norm_device_ms": sum(norm) / 1e3 / len(held),
            "norm_launch_ms": sum(norm) / 1e3 / len(norm) if norm else 0.0,
            "norm_launches": len(norm) / len(held), "calls_held": len(held)}


def device_ms_per_call(torch, fn, calls=5):
    """per_call_device_ms of `calls` calls of fn under torch.profiler (after
    one call outside it), each in a range of its own (CALL_RANGE), waited
    for inside it, CALL_GAP_S apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            with record_function(f"{CALL_RANGE}{i}"):
                fn()
                torch.cuda.synchronize()
            time.sleep(CALL_GAP_S)
    spans, kernels = [], []
    for e in prof.events():
        if e.name.startswith(CALL_RANGE):
            if e.device_type == DeviceType.CPU:
                spans.append((e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            kernels.append((e.name, e.time_range.start, e.time_range.elapsed_us()))
    return per_call_device_ms(sorted(spans), kernels)


def host_ms_per_call(torch, fn, calls=20):
    """Host time per call of fn, its launches enqueued and not waited for
    (the Python wrapper alone: the queue holds the calls' device work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return t


def profile_call(torch, fn, label):
    """torch.profiler over one call of fn (after one unprofiled call): device
    time by kernel and by kind, and the device's busy time against the
    call's wall time (both under the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: CPU-side ops also carry their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kinds = {}
    for e in events:
        kind = next((k for k, keys in CATEGORIES
                     if any(s in e.key.lower() or s in e.key for s in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    log(f"  profile {label}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"wall (idle {100 * (1 - busy_ms / wall_ms):.1f}%, under the profiler)")
    log("    by kind: " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                    sorted(kinds.items(), key=lambda kv: -kv[1])))
    norms = {}
    for e in events:
        m = NORM_KERNEL.search(e.key)
        if m:
            n = norms.setdefault(m.group(0), [0, 0.0])
            n[0] += e.count
            n[1] += e.self_device_time_total / 1e3
    log("    kernel 11's device kernels: " + (", ".join(
        f"{k} {v[1]:.3f} ms / {v[0]}x" for k, v in sorted(norms.items())) or "none"))
    top = [{"name": e.key[:100], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
           for e in events[:40]]
    for r in top[:12]:
        log(f"    {r['device_ms']:8.2f} ms  {r['calls']:5d}x  {r['name']}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "kinds": kinds, "top": top,
            "norm_kernels": {k: {"calls": v[0], "device_ms": v[1]} for k, v in norms.items()}}


def save_profile(result, name, out_dir):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{name}.json"), "w") as f:
            json.dump(result, f, indent=1)


def phase_profile(torch, unet, cfg, out_dir):
    """One UNet forward per path under the profiler."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x, t, ctx, lab, fs = unet_inputs(torch, gen, torch.bfloat16, cfg)
    result = {}
    for impl in ("auto", "plain"):
        with torch.no_grad():
            result[impl] = profile_call(
                torch, lambda: unet(x, t, ctx, c_label=lab, fs=fs, impl=impl),
                f"{cfg} impl={impl}")
    save_profile(result, cfg, out_dir)
    return result


def host_s(torch, fn):
    """Host-clock seconds of one synchronized call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def check_clip(torch, out, shape, counts, expect):
    if tuple(out.shape) != shape:
        raise AssertionError(f"clip shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all().item()):
        raise AssertionError("clip is not finite")
    if out.min().item() < -1.0 or out.max().item() > 1.0:
        raise AssertionError("clip outside [-1, 1]")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")


def warm_up(torch, unet, gen, cfg):
    """One UNet call at the clip's batch and latent size."""
    with torch.no_grad():
        x, t, ctx, lab, fs = unet_inputs(torch, gen, torch.bfloat16, cfg)
        unet(x, t, ctx, c_label=lab, fs=fs)
    torch.cuda.synchronize()


def phase_clip(torch, K, U, mdm_mod, unet):
    cfg = mdm_mod.MDMConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    if unet is None:
        unet = build_unet(torch, U, gen, torch.bfloat16)
        K.prepare_kernels(unet)
    with torch.device("meta"):
        mdm = mdm_mod.MDM(cfg)
    mdm.unet = unet
    mdm.vae.to_empty(device="cuda")
    randomize_(torch, mdm.vae, gen).to(torch.bfloat16).eval()

    bf = torch.bfloat16
    h, w = LATENT["mdm512"]
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    c_concat = (torch.randn((1, 16, h, w, 8), generator=gen, device="cuda") * 0.5).to(bf)
    ctx_c = torch.randn((1, 77 + 256, 1024), generator=gen, device="cuda").to(bf)
    ctx_u = torch.randn((1, 77 + 256, 1024), generator=gen, device="cuda").to(bf)
    label = torch.zeros(1, dtype=torch.int64, device="cuda")
    warm_up(torch, unet, gen, "mdm512")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = mdm_mod.sample_clip(mdm, c_concat, ctx_c, ctx_u, label,
                              generator=torch.Generator(device="cuda").manual_seed(SEED + 3),
                              num_steps=25, guidance_scale=7.5, guidance_rescale=0.7,
                              eta=1.0, timestep_spacing="uniform_trailing", decode_chunk=16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    expect = {k: 25 * v for k, v in SITES["mdm512"].items()}
    log(f"  clip {tuple(out.shape)} {out.dtype}: {secs:.3f} s/clip, "
        f"range [{out.min().item():.3f}, {out.max().item():.3f}], std {out.std().item():.4f}")
    log(f"  launches in the clip: {counts} (expected {expect})")
    check_clip(torch, out, (1, 16, h * f, w * f, 3), counts, expect)
    return counts, {"s_per_clip": secs, "std": out.std().item()}


def switch_clip_launches():
    """Every kernel's launches in one MDM1024 clip with both switches set:
    25 UNet forwards' sites of kernels 1-5 and 11-12 and the resampler's."""
    per = {**SITES["mdm1024"], **SWITCH_SITES["mdm1024"]}
    return {k: 25 * v + SWITCH_CLIP_EXTRA.get(k, 0) for k, v in per.items()}


def phase_sample(torch, K, U, mdm_mod, presets, unet, paths=("kernels",)):
    """`sample` at the mdm1024 preset: pixels and token ids to the clip, once
    per path of `paths`: "kernels" (phase 6) and "switches" (phase 12b,
    MUDG_FUSED_NORMS=1 and MUDG_SHORT_ATTN=1), each with its counts reset
    just before and read just after; then, after the "kernels" clip, each
    stage outside the UNet timed alone."""
    from mudg_tpu_torch.nn import vae as V

    cfg = presets.mdm1024()
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    if unet is None:
        unet = build_unet(torch, U, gen, bf)
        K.prepare_kernels(unet)
    with torch.device("meta"):
        mdm = mdm_mod.MDM(cfg)
    mdm.unet = unet
    for name in ("vae", "image_proj", "clip_text", "clip_image"):
        sub = getattr(mdm, name)
        sub.to_empty(device="cuda")
        randomize_(torch, sub, gen).to(bf).eval()
    n_params = {name: sum(p.numel() for p in getattr(mdm, name).parameters())
                for name in ("unet", "vae", "image_proj", "clip_text", "clip_image")}
    log(f"  parameters: {n_params}")

    # (1, 16, 576, 1024, 3): the latent size times the VAE's downsampling
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    shape = (1, cfg.unet.temporal_length, LATENT["mdm1024"][0] * f, LATENT["mdm1024"][1] * f, 3)

    def video():
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1).to(bf)

    sparse_frames, sparse_depth = video(), video()
    vocab = cfg.clip_text.vocab_size
    tokens = torch.randint(0, vocab, (1, 77), generator=gen, device="cuda")
    null_tokens = torch.randint(0, vocab, (77,), generator=gen, device="cuda")
    label = torch.zeros(1, dtype=torch.int64, device="cuda")
    launches, report = {}, {"params": n_params}
    for path in paths:
        with switches(path == "switches"):
            warm_up(torch, unet, gen, "mdm1024")
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            out = mdm_mod.sample(
                mdm, generator=torch.Generator(device="cuda").manual_seed(SEED + 6),
                sparse_frames=sparse_frames, sparse_depth=sparse_depth, tokens=tokens,
                null_tokens=null_tokens, class_label=label, num_steps=25, guidance_scale=7.5,
                guidance_rescale=0.7, eta=1.0, timestep_spacing="uniform_trailing", dtype=bf)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = K.launch_counts()
        expect = ({k: 25 * v for k, v in SITES["mdm1024"].items()} if path == "kernels"
                  else switch_clip_launches())
        log(f"  {path} clip {tuple(out.shape)} {out.dtype}: {secs:.3f} s/clip, "
            f"range [{out.min().item():.3f}, {out.max().item():.3f}], "
            f"std {out.std().item():.4f}, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        log(f"  launches in the clip: {counts} (expected {expect})")
        check_clip(torch, out, shape, counts, expect)
        launches[path] = counts
        suffix = "" if path == "kernels" else "_switches"
        report.update({"s_per_clip" + suffix: secs, "std" + suffix: out.std().item()})
        del out
    if "kernels" not in paths:
        return launches, report

    # the clip's stages outside the UNet, each timed alone after the clip
    img = sparse_frames[:, 0]
    z = torch.randn((1, shape[1], *LATENT["mdm1024"], cfg.unet.out_channels), generator=gen,
                    device="cuda").to(bf)
    stages = {
        "encode_text x2": host_s(torch, lambda: (mdm_mod.encode_text(mdm, tokens),
                                                 mdm_mod.encode_text(mdm, null_tokens[None]))),
        "embed_image (image + null)": host_s(
            torch, lambda: mdm_mod.embed_image(mdm, torch.cat([img, torch.zeros_like(img)]))),
        "encode_conditions": host_s(
            torch, lambda: mdm_mod.encode_conditions(mdm, sparse_frames, sparse_depth)),
        "decode": host_s(torch, lambda: V.decode_video(mdm.vae, z, chunk=cfg.vae_chunk)),
    }
    log("  stages alone: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    report["stages_s"] = stages
    return launches, report


def build_mdm(torch, mdm_mod, cfg, gen, dev="cuda"):
    """An MDM with all five sub-models random: the trainable UNet and
    resampler as fp32 masters, the frozen VAE and CLIP towers in bf16."""
    with torch.device("meta"):
        mdm = mdm_mod.MDM(cfg)
    for name in ("unet", "image_proj", "vae", "clip_text", "clip_image"):
        sub = getattr(mdm, name)
        sub.to_empty(device=dev)
        randomize_(torch, sub, gen)
        if name not in ("unet", "image_proj"):
            sub.to(torch.bfloat16)
    return mdm


def train_batch(torch, cfg, gen, hw, accum, dev="cuda", b=1):
    """A pixel-form batch with a leading microbatch axis: seeded dense,
    sparse and depth videos (accum, b, T, H, W, 3) in [-1, 1], token ids and
    a class label."""
    shape = (accum, b, cfg.unet.temporal_length, *hw, 3)

    def video():
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    return {"dense_frames": video(), "sparse_frames": video(), "sparse_depth": video(),
            "tokens": torch.randint(0, cfg.clip_text.vocab_size, (accum, b, 77), generator=gen,
                                    device=dev),
            "class_label": torch.zeros((accum, b), dtype=torch.int64, device=dev)}


def grad_check(torch, K, mdm_mod, mdm, batch, null_emb, gen, paths=("kernels",)):
    """One micro-step's trainable gradients, dropout off, from the same
    draws on the plain fp32 path (TF32 off), the plain bf16 path and each
    kernel path of `paths` (impl "train", bf16): "kernels", and "switches"
    with MUDG_FUSED_NORMS=1 and MUDG_SHORT_ATTN=1. Returns (the plain bf16
    path's relative L2 error against fp32, {path: (its error, its launch
    counts)})."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mdm.cfg
    mb = {k: v[0] for k, v in batch.items()}
    draws = mdm_mod.draw_training_noise(cfg, mdm_mod.training_shapes(cfg, mb), gen)
    params = [p for k in ("unet", "image_proj") for p in getattr(mdm, k).parameters()]

    def flat_grads(impl, dtype):
        for p in params:
            p.grad = None
        with torch.enable_grad():
            loss, _ = mdm_mod.training_loss(mdm, mb, draws, null_emb=null_emb, impl=impl,
                                            remat=True, compute_dtype=dtype)
            loss.backward()
        g = torch.cat([p.grad.reshape(-1) for p in params])
        for p in params:
            p.grad = None
        return g

    ref = flat_grads("plain", torch.float32)
    ref_norm = ref.norm()
    e_p = ((flat_grads("plain", torch.bfloat16) - ref).norm() / ref_norm).item()
    out = {}
    for path in paths:
        with switches(path == "switches"):
            K.reset_launch_counts()
            e_k = ((flat_grads("train", torch.bfloat16) - ref).norm() / ref_norm).item()
            out[path] = e_k, K.launch_counts()
    return e_p, out


def switch_train_launches():
    """Every kernel's launches in one MDM512 training micro-step with both
    switches set."""
    counts = train_launches("mdm512", 1)
    for k in SWITCH_TRAIN["fwd"]:
        counts[k] = SWITCH_TRAIN["fwd"][k] + SWITCH_TRAIN["bwd"][k]
    return counts


def leaf_samples(params):
    """The first 64 elements of every leaf, copied, to see which moved."""
    return {n: p.detach().reshape(-1)[:64].clone() for n, p in params.items()}


def train_layers(torch, mdm_mod, step_mod, mdm, state, tc, mb, null_emb, gen):
    """One micro-batch's layers, each timed alone after the timed steps (host
    clock, synchronized): the frozen conditioning (the stacked VAE encode of
    the three videos, the text tower, the image tower and the resampler),
    `training_loss`'s forward alone, one micro-step (forward, remat
    recompute and backward) and the AdamW update of every trainable leaf.
    Returns (seconds by layer, the micro-step as a callable)."""
    from mudg_tpu_torch.nn import vae as V

    cfg = mdm.cfg
    bf = torch.bfloat16
    draws = mdm_mod.draw_training_noise(cfg, mdm_mod.training_shapes(cfg, mb), gen)
    videos = torch.cat([mb["dense_frames"], mb["sparse_frames"], mb["sparse_depth"]]).to(bf)

    def loss():
        return mdm_mod.training_loss(mdm, mb, draws, null_emb=null_emb, generator=gen)[0]

    def micro():
        for p in state.params.values():
            p.grad = None
        with torch.enable_grad():
            loss().backward()

    layers = {
        "VAE encode (3 videos)": host_s(torch, lambda: V.encode_moments_video(
            mdm.vae, videos, chunk=cfg.train_encode_chunk)),
        "text tower": host_s(torch, lambda: mdm_mod.encode_text(mdm, mb["tokens"])),
        "image tower + resampler": host_s(torch, lambda: mdm_mod.embed_image(
            mdm, mb["sparse_frames"][:, 0].to(bf))),
        "training_loss forward": host_s(torch, loss),
        "micro-step (forward + backward)": host_s(torch, micro),
    }
    grads = {n: p.grad for n, p in state.params.items()}
    opt = step_mod.AdamW(tc)
    layers["AdamW update"] = host_s(
        torch, lambda: opt.update(state, grads, step_mod.global_norm(grads.values())))
    for p in state.params.values():
        p.grad = None
    return layers, micro


def phase_train(torch, K, mdm_mod, step_mod, profile=False, out_dir=None,
                paths=("kernels",), steps=True):
    """Full-width MDM512 training: a gradient check on each kernel path of
    `paths` ("kernels", phase 7; "switches", phase 12c), then, with `steps`,
    a warm-up and three timed optimizer steps at batch 1, accumulation 2,
    remat, and the step's layers timed alone (with `profile`, one
    micro-step under the profiler)."""
    cfg = mdm_mod.MDMConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    mdm = build_mdm(torch, mdm_mod, cfg, gen)
    n_params = {k: sum(p.numel() for p in getattr(mdm, k).parameters())
                for k in ("unet", "image_proj", "vae", "clip_text", "clip_image")}
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    hw = tuple(n * f for n in LATENT["mdm512"])
    tc = step_mod.TrainConfig()
    batch = train_batch(torch, cfg, gen, hw, tc.accum_steps)
    null_tokens = torch.randint(0, cfg.clip_text.vocab_size, (77,), generator=gen, device="cuda")
    for k in step_mod.FROZEN:
        getattr(mdm, k).requires_grad_(False)
    null_emb = mdm_mod.encode_text(mdm, null_tokens[None])
    log(f"  parameters: {n_params}, batch {tuple(batch['dense_frames'].shape)}")

    e_p, checked = grad_check(torch, K, mdm_mod, mdm, batch, null_emb, gen, paths)
    err_bound = 1.5 * e_p + 5e-3
    report = {"params": n_params, "rel_l2_grad_plain_bf16": e_p}
    launches = {}
    for path, (e_k, counts) in checked.items():
        expect = train_launches("mdm512", 1) if path == "kernels" else switch_train_launches()
        log(f"  one micro-step's UNet + resampler gradients, rel L2 vs fp32: {path} "
            f"{e_k:.4e}, plain bf16 {e_p:.4e}, bound {err_bound:.4e}")
        log(f"  launches in it: {counts} (expected {expect})")
        if not e_k <= err_bound:
            raise AssertionError(f"{path}-path gradient error {e_k:.4e} exceeds {err_bound:.4e}")
        if counts != expect:
            raise AssertionError(f"launch counts {counts} != {expect}")
        report["rel_l2_grad_" + path] = e_k
        launches[path] = counts
    torch.cuda.empty_cache()
    if not steps:
        return mdm, launches, report

    state = step_mod.init_train_state(mdm, tc)
    step = step_mod.make_train_step(mdm, tc, null_tokens, remat=True)
    torch.cuda.reset_peak_memory_stats()
    before = leaf_samples(state.params)
    state, m0 = step(state, batch, gen)   # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(3):
        state, m = step(state, batch, gen)
        metrics.append(m)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / 3
    counts = K.launch_counts()
    expect = train_launches("mdm512", 3 * tc.accum_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in [m0, *metrics]]
    norms = [float(m["grad_norm"]) for m in [m0, *metrics]]
    after = leaf_samples(state.params)
    still = [n for n in before if torch.equal(before[n], after[n])]
    log(f"  steps: {secs:.3f} s/step (host clock, 3 steps after a warm-up), peak memory "
        f"{peak:.1f} GiB; loss {losses}, grad norm {norms}")
    log(f"  launches in the 3 steps: {counts} (expected {expect})")
    launches["steps"] = counts
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError("loss or gradient norm not finite")
    if still:
        raise AssertionError(f"{len(still)} parameter leaves did not move, e.g. {still[:3]}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    layers, micro = train_layers(torch, mdm_mod, step_mod, mdm, state, tc,
                                 {k: v[0] for k, v in batch.items()}, null_emb, gen)
    log("  layers alone: " + ", ".join(f"{k} {v:.3f} s" for k, v in layers.items()))
    report.update({"s_per_step": secs, "peak_gib": peak, "loss": losses, "grad_norm": norms,
                   "layers_s": layers})
    if profile:
        report["profile"] = profile_call(torch, micro, "MDM512 training micro-step")
        save_profile(report["profile"], "train_mdm512", out_dir)
    del state, step, micro
    torch.cuda.empty_cache()
    return mdm, launches, report


def phase_train_stage2(torch, K, mdm_mod, step_mod, mdm):
    """One stage-2 optimizer step at MDM1024 (576x1024) with the temporal
    transformers frozen: they move by weight decay alone."""
    cfg = mdm_mod.stage2_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    if mdm is None:
        mdm = build_mdm(torch, mdm_mod, cfg, gen)
    else:   # the same five sub-models under the stage-2 configuration
        subs = {k: getattr(mdm, k) for k in ("unet", "image_proj", "vae", "clip_text",
                                              "clip_image")}
        with torch.device("meta"):
            mdm = mdm_mod.MDM(cfg)
        for k, sub in subs.items():
            setattr(mdm, k, sub)
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    hw = tuple(n * f for n in LATENT["mdm1024"])
    tc = step_mod.TrainConfig()
    batch = train_batch(torch, cfg, gen, hw, tc.accum_steps)
    null_tokens = torch.randint(0, cfg.clip_text.vocab_size, (77,), generator=gen, device="cuda")
    mask = {"unet." + n: v for n, v in step_mod.temporal_frozen_mask(mdm.unet).items()}
    frozen = [n for n, v in mask.items() if not v]
    state = step_mod.init_train_state(mdm, tc)
    step = step_mod.make_train_step(mdm, tc, null_tokens, grad_mask=mask, remat=True)
    decayed = {n: state.params[n].detach().clone() for n in frozen}
    with torch.no_grad():   # what AdamW does to a leaf whose gradient is 0
        for n, p in decayed.items():
            p.sub_(tc.learning_rate * (tc.weight_decay * p))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    expect = train_launches("mdm1024", tc.accum_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    wrong = [n for n in frozen if not torch.equal(state.params[n], decayed[n])]
    log(f"  batch {tuple(batch['dense_frames'].shape)}: {secs:.3f} s for the step (no warm-up), "
        f"peak memory {peak:.1f} GiB, loss {loss:.5f}, grad norm {gnorm:.5f}")
    log(f"  {len(frozen)} frozen temporal leaves, {len(wrong)} moved by more than weight decay")
    log(f"  launches in the step: {counts} (expected {expect})")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError("loss or gradient norm not finite")
    if not frozen or wrong:
        raise AssertionError(f"frozen leaves moved by more than weight decay: {wrong[:3]}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    return counts, {"s_per_step_cold": secs, "peak_gib": peak, "loss": loss, "grad_norm": gnorm,
                    "frozen_leaves": len(frozen)}



# ---------------------------------------------------------------------------
# The training app (phase 15)
# ---------------------------------------------------------------------------

# Phase 15 runs `apps/train_mdm.train` at stage 1 (MDMConfig(base_scale=0.7),
# 320x512, 16 frames), batch 1, accumulation 2, over an in-memory BatchLoader
# of SeededClips: (a) APP_STEPS steps with validation every 2 steps over 2
# batches, a sample at the last step and SIGUSR1 at step 2; (b)
# --auto_resume from trainstate_2 alone to the last step;
# (c) one micro-step under remat=False and each policy; (d) precompute's
# device part and LATENT_STEPS steps in the moments form.
APP_CLIP = (16, 320, 512)   # frames, height, width
APP_STEPS = 3               # 4 until PR 19; cut to fit the time limit
APP_ITEMS = 8               # more than an epoch of 3 steps at batch 1 x accumulation 2
APP_VAL = 2                 # validation batches
APP_POLICY = "dots_attn"
SAMPLE_STEPS = 10           # the app's logged sample (the JAX ImageLogger's)
REMAT_POLICIES = (False, *REPLAYED)   # remat=False and the nine policies
POLICY_REL = 1e-3           # each policy's gradients against full recompute's, relative L2
LATENT_BATCH = 16           # frames a precompute call encodes
LATENT_STEPS = 1            # (d)'s app steps in the moments form (2 until PR 19)
APP_FLAGS = ("--stage", "1", "--batch_size", "1", "--accum", "2", "--remat", APP_POLICY,
             "--use_ema", "--log_every", "1", "--ckpt_every", "100000", "--full_ckpt_every",
             "0")


class SeededClips:
    """An in-memory stand-in for WaymoDataset: `n` items with exactly the
    keys, shapes and dtypes of its `load_item` (pixels uniform in [-1, 1]
    from a generator seeded per item), or with `moments` (T, h, w, 2z) of
    its `load_item_latents` (the given moments rolled by the item's index)
    and frame-0 pixels. Tasks cycle color, semantic, depth."""

    TASKS = ("color", "semantic", "depth")

    def __init__(self, n, clip=APP_CLIP, seed=SEED, moments=None, frames=None):
        self.n, self.clip, self.seed = n, clip, seed
        self.moments, self.frames = moments, frames

    def __len__(self):
        return self.n

    def load_item(self, index):
        import numpy as np

        from mudg_tpu_torch.data import waymo as W

        rng = np.random.default_rng(self.seed + index)
        t, h, w = self.clip
        task = self.TASKS[index % len(self.TASKS)]
        item = {"caption": W.DEFAULT_CAPTION, "fps": 10, "class_label": W.CLASS_LABELS[task]}
        if self.moments is not None:
            m = self.moments
            item.update({k: np.roll(m, index + j, axis=0).astype(np.float32) for j, k in
                         enumerate(("dense_moments", "sparse_moments", "depth_moments"))})
            item["sparse_frame0"] = self.frames[index % len(self.frames)].astype(np.float32)
            return item
        for k in ("dense_frames", "sparse_frames", "sparse_depth"):
            item[k] = rng.uniform(-1, 1, (t, h, w, 3)).astype(np.float32)
        return item


def app_args(app, out, size, *extra):
    """The app's arguments: APP_FLAGS, `size` (device, and preset and clip
    flags where phase_train_app is given them) and `extra`."""
    return app.parser().parse_args(["--items", "in-memory", "--out", out, *APP_FLAGS, *size,
                                    *extra])


def app_launches(policy, steps, accum=2, val_forwards=0, sample_forwards=0):
    """Every kernel's launches in an app run: `steps` x `accum` micro-steps
    under `policy`, `val_forwards` no-grad training forwards (each kernel
    once per site) and `sample_forwards` fp32 UNet forwards (impl="auto":
    kernel 5 in fp32 at its sites, no other kernel)."""
    counts = policy_launches("mdm512", policy, steps * accum)
    for k, v in TRAIN_SITES["mdm512"].items():
        counts[k] += val_forwards * v
    counts["flash_attention"] += sample_forwards * SWITCH_SITES_F32["mdm512"]["flash_attention"]
    return counts


def check_launches(what, counts, expect):
    if counts != expect:
        bad = {k: (counts.get(k), v) for k, v in expect.items() if counts.get(k) != v}
        raise AssertionError(f"{what}: launch counts differ from the expected (got, want): {bad}")


def state_to_host(state):
    """A host copy of a TrainState's tensors and counters."""
    def host(d):
        return None if d is None else {n: t.detach().to("cpu", copy=True) for n, t in d.items()}
    return {"params": host(state.params), "mu": host(state.mu), "nu": host(state.nu),
            "ema": host(state.ema), "count": state.count, "step": state.step}


def same_state(torch, state, kept):
    """The names of the TrainState parts that differ from `kept` bit for bit."""
    bad = [k for k in ("count", "step") if getattr(state, k) != kept[k]]
    for key in ("params", "mu", "nu", "ema"):
        mine = getattr(state, key)
        if (mine is None) != (kept[key] is None):
            bad.append(key)
        elif mine is not None and not all(torch.equal(mine[n].cpu(), kept[key][n])
                                          for n in kept[key]):
            bad.append(key)
    return bad


def artifact_bytes(torch, mdm_mod, cfg, use_ema):
    """(step_N / final bytes, trainstate_N bytes) from the parameter counts:
    fp32 values."""
    with torch.device("meta"):
        mdm = mdm_mod.MDM(cfg)
    n_all = sum(p.numel() for p in mdm.parameters())
    n_train = sum(p.numel() for k in ("unet", "image_proj") for p in getattr(mdm, k).parameters())
    return 4 * n_all, 4 * n_train * (4 if use_ema else 3)


POLICY_RUNS = 1   # one timed micro-step per policy, the first (2, with a warm-up, until PR 19)


def policy_micro_step(torch, K, mdm_mod, mdm, mb, draws, null_emb, policy):
    """One micro-step's trainable gradients (dropout off) under `policy`,
    run POLICY_RUNS times: (the last run's flat gradients, its launches, the
    median ms of the runs after the first, or of the one run, peak GiB of all
    above what was allocated before them)."""
    params = [p for k in ("unet", "image_proj") for p in getattr(mdm, k).parameters()]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for run in range(POLICY_RUNS):
        for p in params:
            p.grad = None
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = mdm_mod.training_loss(mdm, mb, draws, null_emb=null_emb, impl="train",
                                            remat=policy)
            loss.backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
    g = torch.cat([p.grad.reshape(-1) for p in params])
    for p in params:
        p.grad = None
    timed = times[1:] or times
    ms = sorted(timed)[len(timed) // 2]
    return g, counts, ms, (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_train_app(torch, K, mdm_mod, card, dev="cuda", clip=APP_CLIP, preset=None):
    """Phase 15 (a)-(d), the report and the launches of each run; `dev`,
    `clip` (frames, height, width) and `preset` let the CPU tests run its
    host side small."""
    import shutil
    import signal

    import numpy as np

    from mudg_tpu_torch.apps import render_infer as ri_app
    from mudg_tpu_torch.apps import train_mdm as app
    from mudg_tpu_torch.conditioning.tokenizer import HashTokenizer
    from mudg_tpu_torch.data import latents as L
    from mudg_tpu_torch.data import waymo as W
    from mudg_tpu_torch.nn import vae as V

    work = os.path.join(ROOT, "_phase15")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    report, launches = {"card": card}, {}
    tok = HashTokenizer()
    t, h, w = clip
    size = ["--device", dev]
    if clip != APP_CLIP:
        size += ["--video_length", str(t), "--height", str(h), "--width", str(w)]
    if preset:
        size += ["--preset", preset]
    cfg, _, _ = app.recipe(app_args(app, work, size))
    step_bytes, state_bytes = artifact_bytes(torch, mdm_mod, cfg, True)
    # step_2, trainstate_2 and final of (a), the finals of (b) and (d)
    need = 4 * step_bytes + state_bytes
    free = shutil.disk_usage(work).free
    log(f"  artifacts: step_N/final {step_bytes / 1e9:.2f} GB, trainstate_N "
        f"{state_bytes / 1e9:.2f} GB; {need / 1e9:.1f} GB needed, {free / 1e9:.1f} GB free")
    if free < need:
        raise AssertionError(f"phase 15 needs {need / 1e9:.1f} GB of disk for its "
                             f"checkpoints, {free / 1e9:.1f} GB are free: "
                             f"{(need - free) / 1e9:.1f} GB short")
    try:
        # (a) the app loop
        out_a = os.path.join(work, "a")
        args = app_args(app, out_a, size, "--max_steps", str(APP_STEPS), "--seed",
                        str(SEED + 15), "--val_every", "2", "--sample_every", str(APP_STEPS))
        loader = W.BatchLoader(SeededClips(APP_ITEMS, clip), 1, accum_steps=2, tokenizer=tok,
                               seed=SEED, prefetch=2)
        val_loader = W.BatchLoader(SeededClips(APP_VAL, clip, seed=SEED + 100), 1,
                                   accum_steps=1, tokenizer=tok, shuffle=False)
        seen = {}

        def on_step(step_i, state, metrics):
            if step_i == 0:
                seen["before"] = leaf_samples(state.params)
            if step_i == 2:
                torch.cuda.synchronize()
                seen["kept"] = state_to_host(state)
                os.kill(os.getpid(), signal.SIGUSR1)
            if step_i == APP_STEPS:   # before the sample hook
                seen["state"] = state
                seen["params"] = {n: p.detach().clone() for n, p in state.params.items()}

        def sink(step_i, video):
            st = seen["state"]
            seen["sample"] = (step_i, video, all(torch.equal(p, seen["params"][n])
                                                 for n, p in st.params.items()))
            del seen["params"]

        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = app.train(args, loader, val_loader, tokenizer=tok, on_step=on_step,
                        sample_sink=sink)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        val_forwards = (APP_STEPS // 2) * APP_VAL
        check_launches("(a) the app loop", counts, app_launches(
            APP_POLICY, APP_STEPS, val_forwards=val_forwards, sample_forwards=SAMPLE_STEPS))
        launches["train_app"] = counts
        recs = [json.loads(line) for line in open(os.path.join(out_a, "metrics.jsonl"))]
        steps = [r for r in recs if "loss" in r]
        vals = [r for r in recs if "val_loss" in r]
        if ([r["step"] for r in steps] != list(range(1, APP_STEPS + 1))
                or [r["step"] for r in vals] != list(range(2, APP_STEPS + 1, 2))):
            raise AssertionError(f"(a) metrics.jsonl records: {recs}")
        bad = [r for r in recs if not all(math.isfinite(v) for v in r.values())]
        if bad:
            raise AssertionError(f"(a) records not finite: {bad}")
        state = res["state"]
        after = leaf_samples(state.params)
        still = [n for n in seen["before"] if torch.equal(seen["before"][n], after[n])]
        if still:
            raise AssertionError(f"(a) {len(still)} trainable leaves did not move, e.g. {still[:3]}")
        ema = leaf_samples(state.ema)
        if all(torch.equal(ema[n], after[n]) for n in after):
            raise AssertionError("(a) the EMA equals the parameters")
        step_i, video, restored = seen["sample"]
        if not restored:
            raise AssertionError("(a) the sample hook left the parameters changed")
        if video.shape != (*clip, 3) or not np.isfinite(video).all():
            raise AssertionError(f"(a) sample {video.shape} misshapen or not finite")
        files = sorted(os.listdir(out_a))
        if files != ["final", "metrics.jsonl", "step_2", "trainstate_2"]:
            raise AssertionError(f"(a) files written: {files}")
        arts = res["artifacts"]
        t0 = time.perf_counter()
        loaded = ri_app.load_params(argparse.Namespace(ckpt=os.path.join(out_a, "final")), cfg,
                                    dev)
        torch.cuda.synchronize()
        arts["final"]["read_s"] = time.perf_counter() - t0
        del loaded
        sps = [r["sec_per_step"] for r in steps]
        log(f"  (a) {APP_STEPS} steps in {run_s:.1f} s; s/step {sps} (step 1 cold; step 3 "
            f"holds step 2's validation, checkpoints and this script's host copy of the "
            f"state), peak {peak:.1f} GiB; val "
            f"{[round(r['val_loss'], 5) for r in vals]}; sample at step {step_i} "
            f"{video.shape}, parameters restored bit for bit; final loads strictly into "
            f"render's model ({arts['final']['read_s']:.1f} s)")
        report["a"] = {"s_per_step": sps, "run_s": run_s, "peak_gib": peak, "records": recs,
                       "artifacts": arts, "launches": counts}

        # (b) resume from trainstate_2 alone
        out_b = os.path.join(work, "b")
        os.makedirs(out_b)
        try:
            os.link(os.path.join(out_a, "trainstate_2"), os.path.join(out_b, "trainstate_2"))
        except OSError:
            shutil.copy(os.path.join(out_a, "trainstate_2"), out_b)
        for f in ("step_2", "final"):
            os.remove(os.path.join(out_a, f))
        del res, state, seen["state"]
        torch.cuda.empty_cache()
        resumed = {}

        def on_resume(step_i, state, metrics):
            if metrics is None:
                torch.cuda.synchronize()
                resumed["t"] = time.perf_counter() - t0
                resumed["bad"] = same_state(torch, state, seen["kept"])

        args_b = app_args(app, out_b, size, "--max_steps", str(APP_STEPS), "--seed",
                          str(SEED + 15), "--auto_resume")
        loader = W.BatchLoader(SeededClips(APP_ITEMS, clip), 1, accum_steps=2, tokenizer=tok,
                               seed=SEED, prefetch=2)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = app.train(args_b, loader, tokenizer=tok, on_step=on_resume)
        counts = K.launch_counts()
        if resumed["bad"]:
            raise AssertionError(f"(b) restored state differs from step 2's in {resumed['bad']}")
        check_launches("(b) resume", counts, app_launches(APP_POLICY, APP_STEPS - 2))
        launches["train_app_resume"] = counts
        recs_b = [json.loads(line) for line in open(os.path.join(out_b, "metrics.jsonl"))]
        if [r["step"] for r in recs_b] != list(range(3, APP_STEPS + 1)):
            raise AssertionError(f"(b) records {recs_b}")
        log(f"  (b) --auto_resume: trainstate_2 restored bit for bit (params, mu, nu, count, "
            f"EMA) in {resumed['t']:.1f} s with the model's set-up, then steps 3-{APP_STEPS}, "
            f"s/step {[r['sec_per_step'] for r in recs_b]}")
        report["b"] = {"restore_s": resumed["t"], "records": recs_b}
        mdm = res["mdm"]
        del res, seen["kept"]
        shutil.rmtree(out_a)
        torch.cuda.empty_cache()

        # (c) every remat policy, one micro-step, dropout off, the same draws
        gen = torch.Generator(device=dev).manual_seed(SEED + 16)
        item = SeededClips(1, clip, seed=SEED + 16).load_item(0)
        mb = app.to_device(W.BatchLoader(None, 1, tokenizer=tok).collate([item]), dev)
        draws = mdm_mod.draw_training_noise(mdm.cfg, mdm_mod.training_shapes(mdm.cfg, mb), gen)
        null_emb = mdm_mod.encode_text(mdm, torch.as_tensor(tok([""]), device=dev).long())
        ref, policies, total = None, {}, {}
        for policy in ("full",) + tuple(p for p in REMAT_POLICIES if p != "full"):
            g, counts, ms, peak = policy_micro_step(torch, K, mdm_mod, mdm, mb, draws, null_emb,
                                                    policy)
            check_launches(f"(c) {policy}", counts, policy_launches("mdm512", policy))
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            if ref is None:
                ref, ref_norm = g, g.norm()
            rel = ((g - ref).norm() / ref_norm).item()
            equal = bool(torch.equal(g, ref))
            replay = {k: counts[k] - v for k, v in TRAIN_SITES["mdm512"].items()}
            log(f"  (c) remat={policy!s:10} {ms:8.1f} ms/micro-step ("
                + (f"median of {POLICY_RUNS - 1} after a warm-up" if POLICY_RUNS > 1 else
                   "one, no warm-up") + f"), peak {peak:5.1f} GiB above the model's, "
                f"rel L2 vs full {rel:.2e} (bit-equal {equal}), forwards replayed {replay}")
            if not rel <= POLICY_REL:
                raise AssertionError(f"(c) {policy}: gradients {rel:.3e} from full recompute's")
            policies[str(policy)] = {"ms": ms, "peak_gib": peak, "rel_l2": rel,
                                     "bit_equal": equal, "replayed": replay}
            del g
        launches["remat_policies"] = total
        report["c"] = policies
        del ref, mdm
        torch.cuda.empty_cache()

        # (d) precompute's device part, then the app in the moments form
        with torch.device("meta"):
            vae = V.AutoencoderKL(cfg.vae)
        vae.to_empty(device=dev)
        randomize_(torch, vae, torch.Generator(device=dev).manual_seed(SEED + 17))
        pgen = torch.Generator(device=dev).manual_seed(SEED + 18)
        px = torch.rand((LATENT_BATCH, h, w, 3), generator=pgen, device=dev) * 2 - 1
        L.encode_moments(vae, px)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = L.encode_moments(vae, px)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            want = V.encode_moments_video(vae, px.to(torch.bfloat16)[None], chunk=0)[0]
        if not torch.equal(m, want.to(torch.float16)):
            raise AssertionError("(d) encode_moments differs from encode_moments_video")
        host = m.cpu().numpy()
        path = os.path.join(work, "m.npy")
        np.save(path, host)
        if not np.array_equal(np.load(path), host) or np.load(path).dtype != np.float16:
            raise AssertionError("(d) the fp16 .npy round trip is not exact")
        del vae
        torch.cuda.empty_cache()
        out_d = os.path.join(work, "d")
        args_d = app_args(app, out_d, size, "--max_steps", str(LATENT_STEPS), "--seed",
                          str(SEED + 19),
                          "--latents")
        clips = SeededClips(APP_ITEMS, clip, moments=host[:t], frames=px.cpu().numpy())
        loader = W.BatchLoader(clips, 1, accum_steps=2, tokenizer=tok, seed=SEED, prefetch=2)
        K.reset_launch_counts()
        res = app.train(args_d, loader, tokenizer=tok)
        counts = K.launch_counts()
        check_launches("(d) moments form", counts, app_launches(APP_POLICY, LATENT_STEPS))
        launches["train_app_latents"] = counts
        recs_d = [json.loads(line) for line in open(os.path.join(out_d, "metrics.jsonl"))]
        if not all(math.isfinite(r["loss"]) for r in recs_d):
            raise AssertionError(f"(d) records {recs_d}")
        log(f"  (d) {LATENT_BATCH} frames at {h}x{w} encoded in {enc_ms:.1f} ms, equal to "
            f"encode_moments_video, fp16 .npy round trip exact; moments form s/step "
            f"{[r['sec_per_step'] for r in recs_d]} (pixels, (a): {sps})")
        report["d"] = {"encode_ms": enc_ms, "records": recs_d,
                       "artifacts": res["artifacts"]}
        del res
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    art = report["a"]["artifacts"]
    log("  checkpoint I/O: " + ", ".join(
        f"{k} {v['bytes'] / 1e9:.2f} GB written in {v['write_s']:.1f} s"
        + (f", read in {v['read_s']:.1f} s" if "read_s" in v else "") for k, v in art.items())
        + f"; trainstate_2 restored in {report['b']['restore_s']:.1f} s ({card})")
    return launches, report


# ---------------------------------------------------------------------------
# 3DGS: kernel 13 (phase 9) and the refinement path (phase 10)
# ---------------------------------------------------------------------------

GS_FWD_TOL = 1e-4     # color, depth, T (and extras): max|diff| <= 1e-4 * max|ref|
GS_BWD_TOL = 2e-3     # each per-gaussian gradient field: <= 2e-3 * max|ref| + 1e-8,
GS_BWD_ATOL = 1e-8    # the JAX tile test's tolerance (tests/test_tile_raster.py:94-96)
GSBENCH_K = ((560.0, 0.0, 480.0), (0.0, 560.0, 320.0), (0.0, 0.0, 1.0))
GS_FIELDS = ("means", "log_scales", "quats", "opacity", "colors")


class GsCase(NamedTuple):
    """One scene for kernel 13: gaussians, camera, image size, optional
    (N, E) semantic logits; `sites` weights its times in the JSON row."""
    label: str
    sites: int
    g: object
    K: object
    w2c: object
    width: int
    height: int
    logits: object = None


def slab_gaussians(torch, G, n, seed, dev, mixed=True):
    """scripts/gsbench.py's urban slab: n points uniform over x in [-60, 60],
    y in [-12, 12], z in [3, 200] m, random colors, init scale 0.25 m,
    opacity 0.5 or, `mixed` (GSBENCH_MIXED), trained-scene-like logits
    ~N(-2, 1.5)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.tensor([-60.0, -12.0, 3.0], device=dev)
    hi = torch.tensor([60.0, 12.0, 200.0], device=dev)
    xyz = lo + torch.rand((n, 3), generator=gen, device=dev) * (hi - lo)
    rgb = torch.rand((n, 3), generator=gen, device=dev)
    g = G.init_from_points(xyz, rgb, init_scale=0.25, opacity=0.5)
    if mixed:
        g = g._replace(opacity=torch.randn(n, generator=gen, device=dev) * 1.5 - 2.0)
    return g


def dense_gaussians(torch, G, n, seed, dev):
    """tests/test_tile_raster.py's dense-occlusion scene (spread 0.8 m around
    z = 10 m, opacity logit 3.0, sigmoid ~0.95), n gaussians."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.randn((n, 3), generator=gen, device=dev) * 0.8 + torch.tensor([0, 0, 10.0],
                                                                               device=dev)
    xyz[:, 2].clamp_(2.0, 25.0)
    g = G.init_from_points(xyz, torch.rand((n, 3), generator=gen, device=dev), opacity=0.35)
    return g._replace(opacity=torch.full((n,), 3.0, device=dev))


def anisotropic(torch, g, seed):
    """g with trained-scene-like anisotropy: per-axis log-scales jittered by
    N(0, 0.3) and random rotations. With isotropic splats the gradient to the
    quaternions is rounding noise, which no relative bound can hold."""
    gen = torch.Generator(device=g.means.device).manual_seed(seed)
    return g._replace(
        log_scales=g.log_scales + 0.3 * torch.randn(g.log_scales.shape, generator=gen,
                                                    device=g.means.device),
        quats=torch.randn(g.quats.shape, generator=gen, device=g.means.device))


def scaled_k(torch, k, sx, sy, dev):
    k = torch.tensor(k, device=dev)
    k[0] *= sx
    k[1] *= sy
    return k


def gs_cases(torch, G, dev="cuda", n_scale=1.0, res_scale=1):
    """Kernel 13's phase-9 scenes: (a) the refine-gs default, 160x256 and a
    200k-gaussian slab; (b) scripts/gsbench.py's 1M-gaussian slab at 960x640
    with its K; (c) the dense-occlusion scene at 960x640 (K scaled 10x from
    the test's 96x64) with 6000 gaussians, so that tiles saturate; (d) (a)
    with 19 semantic classes (npay 23). `n_scale` and `res_scale` shrink the
    gaussian counts and the images (the CPU rehearsal). Every scene's splats
    are made anisotropic (`anisotropic`)."""
    w2c = torch.eye(4, device=dev)
    n = lambda c: max(int(c * n_scale), 64)   # noqa: E731
    big = (960 // res_scale, 640 // res_scale)
    small = (256 // res_scale, 160 // res_scale)
    ka = scaled_k(torch, GSBENCH_K, small[0] / 960, small[1] / 640, dev)
    kb = scaled_k(torch, GSBENCH_K, 1 / res_scale, 1 / res_scale, dev)
    kc = scaled_k(torch, ((600.0, 0, 480.0), (0, 600.0, 320.0), (0, 0, 1.0)), 1 / res_scale,
                  1 / res_scale, dev)
    ga = anisotropic(torch, slab_gaussians(torch, G, n(200_000), SEED + 20, dev), SEED + 25)
    yield GsCase("(a) refine-gs 256x160, 200k", 0, ga, ka, w2c, *small)
    yield GsCase("(b) gsbench 960x640, 1M", 1, anisotropic(
        torch, slab_gaussians(torch, G, n(1_000_000), SEED + 21, dev), SEED + 26), kb, w2c, *big)
    yield GsCase("(c) dense occlusion 960x640", 0, anisotropic(
        torch, dense_gaussians(torch, G, n(6000), SEED + 22, dev), SEED + 27), kc, w2c, *big)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    yield GsCase("(d) (a) + 19 classes", 0, ga, ka, w2c, *small,
                 torch.randn((ga.n, 19), generator=gen, device=dev) * 2.0)


def timed_once(torch, fn):
    """(fn(), the CUDA-event ms of that one call), the ms None off the card."""
    if not torch.cuda.is_available():
        return fn(), None
    box = []
    ms = cuda_ms(torch, lambda: box.append(fn()), iters=1, warmup=0)
    return box[0], ms


def gs_check(torch, KT, G, TT, case):
    """Kernel 13 forward and backward against the plain versions on one scene.
    Forward: color, depth, T and the extras each within GS_FWD_TOL *
    max|ref|. Backward: a seeded upstream gradient of the composited tiles
    through kernel 13's backward (per pair) and the pair gather and
    projection (torch autograd) to each gaussian field, within GS_BWD_TOL *
    max|ref| + GS_BWD_ATOL. Planted faults in the plain versions, pairs
    composited back to front and the backward without the (suffix + tail) /
    (1 - alpha) occlusion term, must miss those bounds. Two backward runs
    must agree bit for bit. Returns a report and what the timings need."""
    from mudg_tpu_torch.gs.rasterize import T_MIN, _tile_grid

    tw, _ = _tile_grid(case.width, case.height)
    leaves = {k: getattr(case.g, k).detach().clone().requires_grad_() for k in GS_FIELDS}
    if case.logits is not None:
        leaves["logits"] = case.logits.detach().clone().requires_grad_()
    with torch.enable_grad():
        g = case.g._replace(**{k: leaves[k] for k in GS_FIELDS})
        extras = torch.softmax(leaves["logits"], -1) if case.logits is not None else None
        proj = G.project_gaussians(g, case.K, case.w2c, width=case.width, height=case.height)
        feats, bounds, _ = TT.build_pairs(proj, G.view_colors(g, case.w2c), width=case.width,
                                             height=case.height, extras=extras)
    fd = feats.detach().contiguous()
    npay = fd.shape[1] - 6
    out_k, last = KT.tile_composite(fd, bounds, tw, npay)
    gen = torch.Generator(device=fd.device).manual_seed(SEED + 24)
    gout = torch.randn(out_k.shape, generator=gen, device=fd.device)
    d_k = KT.tile_composite_bwd(fd, bounds, out_k, last, gout, tw, npay)
    # the planted faults first: they warm up the plain versions' launches,
    # which then run once more, timed, for the comparison
    bad_out = KT.plain_tile_composite(fd, bounds, tw, npay, reverse=True)[0]
    bad_d = KT.plain_tile_composite_bwd(fd, bounds, gout, tw, npay, drop_occlusion=True)
    stats = {}
    (out_p, _), plain_ms = timed_once(torch, lambda: KT.plain_tile_composite(
        fd, bounds, tw, npay, stats=stats))
    d_p, plain_bwd_ms = timed_once(torch, lambda: KT.plain_tile_composite_bwd(
        fd, bounds, gout, tw, npay))

    def per_gaussian(d):
        return torch.autograd.grad(feats, list(leaves.values()), d, retain_graph=True)

    def fwd_ratio(out):
        groups = {"color": slice(0, 3), "depth": slice(3, 4), "T": slice(npay, npay + 1)}
        if npay > 4:
            groups["extras"] = slice(4, npay)
        return max((out[:, s] - out_p[:, s]).abs().max().item()
                   / max(out_p[:, s].abs().max().item(), 1e-30) for s in groups.values())

    gp = per_gaussian(d_p)

    def bwd_ratios(grads):
        return {n: (a - b).abs().max().item() / (GS_BWD_TOL * b.abs().max().item() + GS_BWD_ATOL)
                for n, a, b in zip(leaves, grads, gp)}

    def bwd_ratio(grads):
        return max(bwd_ratios(grads).values())

    gk = per_gaussian(d_k)
    fwd_err, bwd_err = fwd_ratio(out_k), bwd_ratio(gk)
    faults = {"back to front": fwd_ratio(bad_out) / GS_FWD_TOL,
              "occlusion term dropped": bwd_ratio(per_gaussian(bad_d))}
    again = KT.tile_composite_bwd(fd, bounds, out_k, last, gout, tw, npay)
    bitwise = torch.equal(again, d_k) and all(
        torch.equal(a, b) for a, b in zip(per_gaussian(again), gk))
    finite = bool(torch.isfinite(out_k).all()) and all(bool(torch.isfinite(x).all()) for x in gk)
    ok = (finite and bitwise and fwd_err <= GS_FWD_TOL and bwd_err <= 1.0
          and all(v > 1.0 for v in faults.values()))
    # the work this run's data needs: per pixel, the pairs up to saturation
    # (the whole tile's list where a pixel never saturates) in the forward,
    # the pairs up to its last contributor in the backward. Each evaluation
    # costs ~14 FP32 operations (offset, conic quadratic, exp, alpha and its
    # tests); a contributing one adds 4 + 2 * npay in the forward (weight,
    # payload sums, T) and 32 + 4 * npay in the backward (the T and occlusion
    # updates, the 6 + npay gradient terms and their sum over the tile's
    # pixels). Bytes: the forward reads the pair table and bounds and writes
    # out and last; the backward reads the pair table, bounds, out's T plane,
    # last and gout and writes the gradient table.
    counts = (bounds[1:] - bounds[:-1]).long()
    t_final = out_k[:, npay]
    evals_f = torch.where(t_final <= T_MIN, last.long(), counts[:, None]).sum().item()
    evals_b = last.long().sum().item()
    contrib = stats["contributions"]
    plane = out_k.shape[0] * out_k.shape[2] * 4
    tbl, bnd = fd.numel() * 4, bounds.numel() * 4
    work_f = (14 * evals_f + (4 + 2 * npay) * contrib, tbl + bnd + out_k.numel() * 4 + plane)
    work_b = (14 * evals_b + (32 + 4 * npay) * contrib,
              2 * tbl + bnd + plane + plane + gout.numel() * 4)
    return {"ok": ok, "fwd_err": fwd_err, "bwd_err": bwd_err, "faults": faults,
            "bwd_fields": bwd_ratios(gk),
            "bitwise": bitwise, "pairs": fd.shape[0], "npay": npay,
            "max_abs_err": max((out_k - out_p).abs().max().item(),
                               max((a - b).abs().max().item() for a, b in zip(gk, gp))),
            "evals_fwd": evals_f, "evals_bwd": evals_b, "contributions": contrib,
            "work_fwd": work_f, "work_bwd": work_b, "plain_ms": plain_ms,
            "plain_bwd_ms": plain_bwd_ms,
            "timing": (fd, bounds, out_k, last, gout, tw, npay)}


def gs_bound(work):
    """(ms, by): FP32 operations at the card's data-sheet rate or bytes at
    its memory rate, the larger."""
    return bound(*work, peak=PEAK_FP32)


def phase_gs_kernels(torch, KT, G, TT, profile=False, out_dir=None):
    """Phase 9: kernel 13 forward and backward at shapes (a)-(d); with
    `profile`, one forward and one backward at (b) under the profiler (the
    kernels beside the wrappers' tile-order sorts)."""
    rows = {}
    for case in gs_cases(torch, G):
        r = gs_check(torch, KT, G, TT, case)
        fd, bounds, out_k, last, gout, tw, npay = r.pop("timing")
        fwd = lambda: KT.tile_composite(fd, bounds, tw, npay)   # noqa: E731
        bwd = lambda: KT.tile_composite_bwd(fd, bounds, out_k, last, gout, tw, npay)   # noqa: E731
        ms, bms = cuda_ms(torch, fwd), cuda_ms(torch, bwd)
        queued = {"tile_composite": cuda_ms_queued(torch, fwd),
                  "tile_composite_bwd": cuda_ms_queued(torch, bwd)}
        counts = bounds[1:] - bounds[:-1]
        sched = {"tiles": counts.numel(), "max_tile_pairs": int(counts.max()),
                 "max_last": int(last.max())}
        log(f"  {case.label}: {sched['tiles']} tiles, pairs per tile mean "
            f"{counts.float().mean().item():.1f}, max {sched['max_tile_pairs']}; largest "
            f"last {sched['max_last']}")
        if profile and case.sites:
            prof = profile_call(torch, lambda: KT.tile_composite_bwd(
                fd, bounds, *KT.tile_composite(fd, bounds, tw, npay), gout, tw, npay),
                f"kernel 13 forward + backward, {case.label}")
            save_profile(prof, "kernel13", out_dir)
        for name, t_k, t_p, work, err in (
                ("tile_composite", ms, r["plain_ms"], r["work_fwd"], r["fwd_err"]),
                ("tile_composite_bwd", bms, r["plain_bwd_ms"], r["work_bwd"], r["bwd_err"])):
            b_ms, by = gs_bound(work)
            log(f"  {name:18s} {case.label:30s} {r['pairs']:>9,} pairs npay {npay:2d}: "
                f"{'ok' if r['ok'] else 'FAIL'} err {err:.3e} "
                f"({'of max|ref|, bound ' + str(GS_FWD_TOL) if name == 'tile_composite' else 'of the bound'})"
                f"   kernel {t_k:.3f} ms (queued {queued[name]:.3f})   plain {t_p:.1f} ms   bound "
                f"{b_ms:.4f} ms ({by}, {100 * b_ms / t_k:.1f}% of it)")
            row = rows.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "ms_queued": 0.0,
                                         "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
                                         "ok": True, "bound_by": by, "shapes": []})
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
            row["ms"] += case.sites * t_k
            row["ms_queued"] += case.sites * queued[name]
            row["plain_ms"] += case.sites * t_p
            row["bound_ms"] += case.sites * b_ms
            if case.sites:
                row["bound_by"] = by
            row["ok"] &= r["ok"]
            row["shapes"].append({"shape": case.label, "sites": case.sites, "pairs": r["pairs"],
                                  "npay": npay, "err": err, "faults": r["faults"],
                                  "bitwise": r["bitwise"], "ms": t_k,
                                  "ms_queued": queued[name], "plain_ms": t_p,
                                  **sched,
                                  "bound_ms": b_ms, "bound_by": by,
                                  "evals": r["evals_fwd" if name == "tile_composite"
                                             else "evals_bwd"],
                                  "contributions": r["contributions"]})
        log(f"    gradient errors (ratio to the bound) by field: "
            + ", ".join(f"{k} {v:.2e}" for k, v in r["bwd_fields"].items()))
        log(f"    faults (ratio to the bound): {r['faults']}, backward bit for bit: "
            f"{r['bitwise']}, (pair, pixel) evaluations fwd {r['evals_fwd']:,} "
            f"bwd {r['evals_bwd']:,}, contributing {r['contributions']:,}")
        del case, r, fd, bounds, out_k, last, gout
        torch.cuda.empty_cache()
    bad = [n for n, r in rows.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel 13 disagrees with its plain version: {bad}")
    return rows


def forward_track(torch, n, dev, step=0.5):
    """n world-to-camera matrices on a straight track along +z, one every
    `step` m, looking down the slab."""
    out = []
    for i in range(n):
        w2c = torch.eye(4, device=dev)
        w2c[2, 3] = -step * i
        out.append(w2c)
    return out


def phase_gs_refine(torch, K, G, GT, TT, app, gs_io):
    """Phase 10: `refine` at a real scene size. 500k seeded points in the
    gsbench slab (a "true" slab set's means + N(0, 0.1 m), grey, at the
    gsbench splats' 0.25 m) at capacity 1M, 24 views on a forward track at
    960x640 with targets rendered by the kernel path from the true set, 300
    steps with densify_every=100, the 3 holdout renders with PSNR and the
    PLY export. A densify must clone or split, so that the slot-reuse path
    runs at size."""
    import tempfile

    dev = "cuda"
    width, height, n_views, steps = 960, 640, 24, 300
    sync = torch.cuda.synchronize
    kc = torch.tensor(GSBENCH_K, device=dev)
    true_g = slab_gaussians(torch, G, 500_000, SEED + 30, dev)
    track = forward_track(torch, n_views, dev)
    with torch.no_grad():
        targets = [TT.rasterize_tiles(true_g, kc, w2c, width=width, height=height).color
                   for w2c in track]
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    pts = true_g.means + 0.1 * torch.randn(true_g.means.shape, generator=gen, device=dev)
    g0 = G.init_from_points(pts, torch.full_like(pts, 0.5), capacity=1_000_000,
                            init_scale=0.25)
    views = [{"K": kc, "w2c": w2c, "rgb": rgb} for w2c, rgb in zip(track, targets)]
    train = [v for i, v in enumerate(views) if i % 8]
    hold = [v for i, v in enumerate(views) if i % 8 == 0]
    # exact pair buffers, as `refine-gs` runs with its default --max_pairs 0
    cfg = GT.GSConfig(densify_every=100, max_pairs=None)

    ends, dropped, densify_s, grown = [], [], [], []
    densify = GT.densify_and_prune

    def timed_densify(state, c):
        t0 = time.perf_counter()
        g = state.gaussians
        n_before = int(g.active.sum())
        n_pruned = int((g.active & (torch.sigmoid(g.opacity) < c.prune_opacity_thresh)).sum())
        r = densify(state, c)
        # clones and splits each fill one free slot
        grown.append((n_pruned, int(r.gaussians.active.sum()) - (n_before - n_pruned)))
        densify_s.append((t0, time.perf_counter()))
        return r

    def on_step(i, state, metrics):
        sync()
        ends.append(time.perf_counter())
        dropped.append(metrics["n_dropped"])

    sync()
    torch.cuda.reset_peak_memory_stats()
    GT.densify_and_prune = timed_densify
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        r = app.refine(g0, train, hold, cfg, width=width, height=height, steps=steps,
                       on_step=on_step)
    finally:
        GT.densify_and_prune = densify
    sync()
    total_s = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    state, hist = r["state"], r["history"]
    steady = [b - a for a, b in zip(ends[9:], ends[10:])]
    # the densifies inside the timed gaps (after steps 100 and 200; the last
    # one runs after the final step)
    inside = [b - a for a, b in densify_s if ends[9] <= a and b <= ends[-1]]
    densify_s = [b - a for a, b in densify_s]
    s_step = (sum(steady) - sum(inside)) / len(steady)
    n_active = int(state.gaussians.active.sum())
    with tempfile.TemporaryDirectory() as d:
        n_ply = gs_io.save_gaussians_ply(os.path.join(d, "gaussians.ply"), state.gaussians)
        n_back = gs_io.load_gaussians_ply(os.path.join(d, "gaussians.ply")).n
    losses = [h["loss"] for h in hist]
    expect = {"tile_composite": steps + len(hold), "tile_composite_bwd": steps}
    log(f"  {n_views} views ({len(train)} train, {len(hold)} holdout) at {width}x{height}, "
        f"{steps} steps: {total_s:.1f} s in refine, {s_step:.4f} s/step (steps 11-{steps}, host "
        f"clock, synchronized, densify excluded), peak memory {peak:.2f} GiB")
    log(f"  loss {losses[0]:.5f} -> {losses[-1]:.5f} ({len(losses)} logged); active "
        f"{int(g0.active.sum()):,} -> {n_active:,}; densify {['%.3f' % x for x in densify_s]} s "
        f"(pruned, cloned + split: {grown}); "
        f"holdout PSNR {['%.3f' % p for p in r['psnrs']]} dB; PLY {n_ply:,} splats")
    gs_launches = {k: counts[k] for k in expect}
    log(f"  launches in refine: {gs_launches} (expected {expect})")

    layers = gs_layers(torch, G, GT, TT, state, cfg, train[0], width, height)
    log("  layers alone: " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in layers.items()))
    report = {"s_per_step": s_step, "refine_s": total_s, "peak_gib": peak, "loss": losses,
              "n_active": n_active, "densify_s": densify_s, "densify_pruned_grown": grown,
              "psnr": r["psnrs"],
              "layers_s": layers, "n_dropped": sum(dropped)}
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if sum(dropped) or r["dropped_renders"]:
        raise AssertionError(f"pairs dropped: {sum(dropped)}, {r['dropped_renders']}")
    if not any(n > 0 for _, n in grown):
        raise AssertionError(f"no densify cloned or split a splat: {grown}")
    if gs_launches != expect:
        raise AssertionError(f"launch counts {gs_launches} != {expect}")
    if n_ply != n_active or n_back != n_active or not all(map(math.isfinite, r["psnrs"])):
        raise AssertionError(f"PLY {n_ply}/{n_back} splats for {n_active} active, "
                             f"PSNR {r['psnrs']}")
    return counts, report


def gs_layers(torch, G, GT, TT, state, cfg, view, width, height):
    """One refinement step's layers, each timed alone (host clock,
    synchronized): the projection, the pair build with its sort, kernel 13's
    forward, the loss on the composited image, the whole backward of a step
    and the Adam update."""
    from mudg_tpu_torch.gs.rasterize import _tile_grid
    from mudg_tpu_torch.kernels import tile_raster as KT

    tw, th = _tile_grid(width, height)
    g, kc, w2c, rgb = state.gaussians, view["K"], view["w2c"], view["rgb"]
    params = GT._train_params(state)
    proj = G.project_gaussians(g, kc, w2c, width=width, height=height)
    colors = G.view_colors(g, w2c)
    feats, bounds, _ = TT.build_pairs(proj, colors, width=width, height=height)
    fd = feats.contiguous()
    out = KT.tile_composite(fd, bounds, tw, 4)[0]
    img = TT.raster_out(out, 0, tw, th, width, height, (0.0, 0.0, 0.0), 0).color
    raster = GT.pick_raster(cfg, width, height)
    floats = {k: v.detach().requires_grad_() for k, v in params.items()}
    holder = {}

    def forward():
        with torch.enable_grad():
            holder["loss"] = GT.gs_loss(cfg, raster, floats, g.active, g.group, kc, w2c, rgb)[0]

    def backward():
        holder["grads"] = dict(zip(floats, torch.autograd.grad(holder["loss"],
                                                                list(floats.values()))))

    layers = {"projection": host_s(torch, lambda: G.project_gaussians(
                  g, kc, w2c, width=width, height=height)),
              "pair build + sort": host_s(torch, lambda: TT.build_pairs(
                  proj, colors, width=width, height=height)),
              "kernel 13 forward": host_s(torch, lambda: KT.tile_composite(fd, bounds, tw, 4)),
              "loss (L1 + SSIM)": host_s(torch, lambda: GT.photometric_loss(img, rgb, cfg)),
              "forward of a step": host_s(torch, forward),
              "backward of a step": host_s(torch, backward)}
    layers["Adam"] = host_s(torch, lambda: GT.adam_update(cfg, state.opt_state, holder["grads"],
                                                          params))
    return layers


# Phase 14, the serving path: apps/serve.py's warm server (built by
# render_infer.build_server from serve's flags, as serve.main builds it; no
# checkpoint: init_mdm on the card from a generator seeded 0, bf16,
# HashTokenizer) answering SERVE_REQUESTS through render_windows on seeded
# in-memory windows. The 3-task batch with 2-point CFG is UNet batch
# SERVE_BATCH.
SERVE_BATCH = 6
# 3 tasks x 3 CFG variants (--multiple_cond_cfg): phase 14 (a) also runs the
# MDM1024 forward at this batch, the largest a served request makes
MULTI_COND_BATCH = 9
SERVE_STEPS = 5    # the app defaults to 50; cut to fit the time limit (25, then 10 in PR 18)
SERVE_FLAGS = ("--preset", "mdm512", "--steps", str(SERVE_STEPS), "--cfg_scale", "7.5",
               "--guidance_rescale", "0.7", "--eta", "1.0", "--timestep_spacing",
               "uniform_trailing", "--fps", "10", "--dtype", "bf16")
SERVE_CLIP = (16, 320, 512)   # frames, height, width
# (name, prompt, seed, windows, task_serial)
SERVE_REQUESTS = (("r1", "A photo a of driving scene.", 123, 2, False),
                  ("r2", "A rainy night in the city, wet asphalt.", 7, 1, False),
                  ("r3", "A photo a of driving scene.", 11, 1, True))
# The kernel wrappers a UNet forward calls, (key, module of K, function)
TRACED = (("spatial_attn", "spatial_attn", "fused_self_attention"),
          ("temporal_attn", "temporal_attn", "fused_double_self_attn"),
          ("geglu_ff_block", "mlp", "fused_geglu_ff_block"),
          ("geglu_ff", "mlp", "fused_geglu_ff"),
          ("gn_silu_tconv", "tconv", "fused_gn_silu_tconv"),
          ("flash_attention", "flash_attention", "flash_attention"))


def traced_kernel_keys(torch, K, U, cfg, batch):
    """The kernel wrappers' calls of one full-width UNet forward at `cfg` and
    `batch` (16 frames a clip, impl="auto"), in bf16 and in fp32, traced on
    the meta device: {(key, the first argument's shape (the FF's as rows x
    C), fp32)}, as forward_keys gives them."""
    seen = set()
    saved = []
    for key, mod, fn in TRACED:
        m = getattr(K, mod)
        orig = getattr(m, fn)
        saved.append((m, fn, orig))

        def wrapped(x, *a, _orig=orig, _key=key, **kw):
            # the FF kernel flattens its tokens to rows
            shape = ((x.numel() // x.shape[-1], x.shape[-1]) if _key.startswith("geglu_ff")
                     else tuple(x.shape))
            seen.add((_key, shape, x.dtype == torch.float32))
            return _orig(x, *a, **kw)

        setattr(m, fn, wrapped)
    try:
        h, w = LATENT[cfg]
        with torch.device("meta"), torch.no_grad():
            unet = U.UNet3D(U.UNetConfig())
            for dtype in (torch.bfloat16, torch.float32):
                unet.to(dtype)
                x = torch.empty(batch, 16, h, w, 12, dtype=dtype)
                ctx = torch.empty(batch, 77 + 16 * 16, 1024, dtype=dtype)
                t = torch.zeros(batch, dtype=torch.int64)
                unet(x, t, ctx, c_label=t)
    finally:
        for m, fn, orig in saved:
            setattr(m, fn, orig)
    return seen


def serve_windows(n, seed, clip=SERVE_CLIP):
    """`n` seeded in-memory condition windows for render_windows: sparse
    color and depth videos and a GT frame 0 uniform in [-1, 1], the task
    labels color / depth / semantic."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t, h, w = clip
    return [{"sparse_frames": rng.uniform(-1, 1, (t, h, w, 3)).astype(np.float32),
             "frame0": rng.uniform(-1, 1, (h, w, 3)).astype(np.float32),
             "sparse_depth": rng.uniform(-1, 1, (t, h, w, 3)).astype(np.float32),
             "class_labels": np.array([0, 500, 1], np.int32)} for _ in range(n)]


def check_carry(windows, used, outs, video_length):
    """The autoregressive carry: window 0's sparse color condition is its
    own; from window 1 on, frames 1 .. video_length//2 - 1 are the previous
    window's generated color frames video_length//2 + 1 .., frame 0 the
    window's GT frame 0, the second half the window's own. Raises where not,
    bit for bit."""
    import numpy as np

    half = video_length // 2
    if not np.array_equal(used[0], windows[0]["sparse_frames"]):
        raise AssertionError("window 0: the sparse condition is not the window's own")
    for i in range(1, len(used)):
        parts = {"frame 0 is the GT": np.array_equal(used[i][0], windows[i]["frame0"]),
                 "frames 1..half-1 carried": np.array_equal(used[i][1:half],
                                                            outs[i - 1][0, half + 1:]),
                 "second half the window's own": np.array_equal(
                     used[i][half:], windows[i]["sparse_frames"][half:])}
        bad = [k for k, ok in parts.items() if not ok]
        if bad:
            raise AssertionError(f"window {i}: carry check failed: {bad}")


def serve_launches(sites, steps, windows, task_serial):
    """Every kernel's launches in a request: one UNet forward per step of
    one sampler call per window, or per task and window with task_serial."""
    calls = windows * (3 if task_serial else 1)
    return {k: calls * steps * v for k, v in sites.items()}


def check_ckpt_load(torch, K, ri_mod, ckpt_mod, unet, x, t, ctx, lab, fs):
    """Phase 14 (d), the checkpoint path into a served UNet: seeded random
    weights, stored as fp16 leaves in a MuDG .ckpt (written in memory), read
    by train/checkpoint.load_mudg_checkpoint, loaded strictly into `unet`
    (the served MDM's) and cast and packed by prepare_serving_params; then
    one forward (inputs in fp32) on the kernel path against the plain bf16
    path and the plain fp32 path of the same weights, phase 3's gate.
    Returns (report, the kernel path's launches)."""
    import io

    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    with torch.device("meta"):
        ref = type(unet)(unet.cfg)
    ref.to_empty(device=dev)
    randomize_(torch, ref, gen)
    buf = io.BytesIO()
    prefix = ckpt_mod.PREFIXES["unet"]
    torch.save({"state_dict": {prefix + k: v.half().cpu() for k, v in ref.state_dict().items()}},
               buf)
    t0 = time.perf_counter()
    trees = ckpt_mod.load_mudg_checkpoint(buf)
    read_s = time.perf_counter() - t0
    del buf
    ref.load_state_dict(trees["unet"], strict=True)   # fp32 of the stored fp16 values
    unet.load_state_dict(trees["unet"], strict=True)
    del trees
    ri_mod.prepare_serving_params(unet, "none", torch.bfloat16)
    with torch.no_grad():
        r32 = ref(x, t, ctx, c_label=lab, fs=fs, impl="plain").float()
        del ref
        xb, cb = x.bfloat16(), ctx.bfloat16()
        plain = unet(xb, t, cb, c_label=lab, fs=fs, impl="plain").float()
        K.reset_launch_counts()
        kern = unet(xb, t, cb, c_label=lab, fs=fs, impl="auto").float()
        counts = K.launch_counts()

    def rel(a):
        return ((a - r32).norm() / r32.norm()).item()

    e_p, e_k = rel(plain), rel(kern)
    bound_ = 1.5 * e_p + 5e-3
    log(f"  checkpoint path: the UNet's fp16 .ckpt read in {read_s:.3f} s; kernel path rel L2 "
        f"vs fp32 {e_k:.4e} (plain bf16 {e_p:.4e}, bound {bound_:.4e}), launches {counts}")
    if not bool(torch.isfinite(kern).all().item()) or e_k > bound_:
        raise AssertionError(f"checkpoint path: kernel-path error {e_k:.4e} exceeds {bound_:.4e}")
    return {"read_s": read_s, "rel_l2_plain_bf16": e_p, "rel_l2_kernels": e_k}, counts


def phase_serve(torch, K, U, nn_att, serve_mod, ri_mod, ckpt_mod, card):
    """Phase 14: (a) one UNet forward at batch SERVE_BATCH per configuration
    (phase_unet), then one more under the profiler (the device's busy share
    of its wall time), and at MDM1024 one at MULTI_COND_BATCH; (b) kernels
    1-5 against their plain versions at every shape of the SERVE_BATCH
    forwards (a meta-device trace, which must equal forward_keys); (c) the
    warm server answering SERVE_REQUESTS, each checked (shape, finite, in
    [-1, 1], launches, the carry) with counts reset just before and read
    just after; (d) check_ckpt_load on the served UNet at batch
    SERVE_BATCH, launches at the MDM512 sites. Returns the launches summed
    over the requests, the batch-6 kernel rows and the report."""
    import numpy as np

    report, fwd_ms = {}, {}
    for cfg, batch in (("mdm512", SERVE_BATCH), ("mdm1024", SERVE_BATCH),
                       ("mdm1024", MULTI_COND_BATCH)):
        unet, r, _ = phase_unet(torch, K, U, cfg, ("kernels",), batch=batch)
        report[f"unet_{cfg}_batch{batch}"] = r
        if batch == SERVE_BATCH:
            x, t, ctx, lab, fs = unet_inputs(torch, torch.Generator(device="cuda").manual_seed(
                SEED + 30), torch.bfloat16, cfg, batch)
            r["profile"] = profile_call(torch, lambda: unet(x, t, ctx, c_label=lab, fs=fs),
                                        f"{cfg} batch {batch} impl=auto")
            fwd_ms[cfg] = r["ms_kernels"]
            del x, ctx
        del unet
        torch.cuda.empty_cache()
    for cfg in ("mdm512", "mdm1024"):
        traced = traced_kernel_keys(torch, K, U, cfg, SERVE_BATCH)
        expect = forward_keys(cfg, SERVE_BATCH)
        if traced != expect:
            raise AssertionError(f"{cfg} batch {SERVE_BATCH}: traced kernel calls "
                                 f"{sorted(traced - expect)} have no case, cases "
                                 f"{sorted(expect - traced)} are not traced")
    log(f"  batch {SERVE_BATCH}: the traced kernel calls equal the cases' shapes")
    rows = run_cases(torch, kernel_cases(torch, K, nn_att, ("mdm512", "mdm1024"),
                                         batch=SERVE_BATCH), iters=3)
    torch.cuda.empty_cache()

    os.environ["HF_HUB_OFFLINE"] = "1"   # the tokenizer's cache lookup stays local
    t0 = time.perf_counter()
    args = serve_mod.parser().parse_args(["--spool", "unused", *SERVE_FLAGS])
    mdm, sample_fn, tokenizer = ri_mod.build_server(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  server: {type(tokenizer).__name__}, MDM {next(mdm.parameters()).dtype}, "
        f"built in {build_s:.3f} s")
    frames, hh, ww = SERVE_CLIP
    total, requests = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, prompt, seed, n_windows, task_serial in SERVE_REQUESTS:
        windows = serve_windows(n_windows, seed)
        tokens = torch.as_tensor(tokenizer([prompt] * 3), device="cuda").long()
        null_tokens = torch.as_tensor(tokenizer([""])[0], device="cuda").long()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        used, outs, secs = [], [], []
        K.reset_launch_counts()
        t0 = t_win = time.perf_counter()
        for _, sparse, out in ri_mod.render_windows(
                mdm, sample_fn, windows, tokens=tokens, null_tokens=null_tokens,
                video_length=frames, generator=gen, task_serial=task_serial):
            secs.append(time.perf_counter() - t_win)
            used.append(sparse)
            outs.append(out)
            t_win = time.perf_counter()
        s_req = time.perf_counter() - t0
        counts = K.launch_counts()
        expect = serve_launches(SITES["mdm512"], SERVE_STEPS, n_windows, task_serial)
        for out in outs:
            if out.shape != (3, frames, hh, ww, 3) or not np.isfinite(out).all():
                raise AssertionError(f"{name}: output {out.shape} not finite or misshapen")
            if out.min() < -1.0 or out.max() > 1.0:
                raise AssertionError(f"{name}: output outside [-1, 1]")
        if counts != expect:
            raise AssertionError(f"{name}: launch counts {counts} != {expect}")
        check_carry(windows, used, outs, frames)
        # a task_serial window's batch-2 forwards are not timed inside it, and
        # one timed alone is host-bound: its share is not measured
        fwd = None if task_serial else fwd_ms["mdm512"]
        calls = 3 if task_serial else 1
        share = ([calls * SERVE_STEPS * fwd / 1e3 / s for s in secs] if fwd else None)
        log(f"  {name} ({n_windows} window{'s' if n_windows > 1 else ''}, "
            f"{'task_serial, batch 2' if task_serial else f'batch {SERVE_BATCH}'}): "
            f"{s_req:.3f} s/request, s/window {[round(s, 3) for s in secs]}, UNet forward's "
            f"share {[round(x, 3) for x in share] if share else 'not measured'}, "
            f"std {float(np.std(outs[-1])):.4f}, carry ok, launches {counts}")
        requests[name] = {"s_per_request": s_req, "s_per_window": secs, "unet_share": share,
                          "windows": n_windows, "task_serial": task_serial,
                          "std": float(np.std(outs[-1]))}
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {card}: UNet forward bf16 at batch {SERVE_BATCH} {fwd_ms['mdm512']:.1f} ms "
        f"(MDM512), {fwd_ms['mdm1024']:.1f} ms (MDM1024); peak memory of the requests "
        f"{peak:.2f} GiB")
    report["server"] = {"build_s": build_s, "tokenizer": type(tokenizer).__name__,
                        "requests": requests, "peak_gib": peak,
                        f"forward_ms_batch{SERVE_BATCH}": fwd_ms}
    x, t, ctx, lab, fs = unet_inputs(torch, torch.Generator(device="cuda").manual_seed(SEED + 32),
                                     torch.float32, "mdm512", SERVE_BATCH)
    report["ckpt"], counts = check_ckpt_load(torch, K, ri_mod, ckpt_mod, mdm.unet, x, t, ctx,
                                             lab, fs)
    if counts != SITES["mdm512"]:
        raise AssertionError(f"checkpoint path: launch counts {counts} != {SITES['mdm512']}")
    del mdm, x, ctx
    torch.cuda.empty_cache()
    return total, rows, report


# ---------------------------------------------------------------------------
# Phase 16: the multi-GPU paths over a real process group
# ---------------------------------------------------------------------------

PAR_POLICY = "dots_attn"   # the app's default remat policy (full recompute above one rank)
PAR_SAMPLE_STEPS = 4
# gates of phase 16 against the one-process result. Data parallelism at one
# rank runs the same graph and is expected bit for bit; FSDP2's hooks change
# the order in which autograd sums a gradient (emb feeds every block), which
# moves bf16 gradients by their rounding (mu ~4e-3 relative L2 on the CPU
# rehearsal), and the sign of a gradient that is rounding noise (a conv bias
# before a GroupNorm) sets AdamW's first update of its element. Loss and
# gradient norm relative, mu relative L2 (nu twice it), the parameters'
# update (after - before) relative L2:
PAR_METRIC_TOL = 1e-3
PAR_MOMENT_TOL = 2e-2
PAR_UPDATE_TOL = 0.25


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def init_group(torch, dev="cuda"):
    """The process group of phase 16: torchrun's when it launched the script
    (WORLD_SIZE above 1; set up in main), else a group of one on this card
    (NCCL; gloo on the CPU) at tcp://localhost:<free port>. Returns True
    when it formed one here (to destroy after)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    cuda = torch.device(dev).type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device())
                            if cuda else None)
    return True


def log0(msg):
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        log(msg)


def rel_l2(torch, pairs) -> float:
    """Relative L2 error over (got, ref) tensor pairs, one pair at a time
    (ref moved to got's device)."""
    num = den = 0.0
    for got, ref in pairs:
        ref = ref.to(got.device)
        num += float(((got.float() - ref.float()) ** 2).sum())
        den += float((ref.float() ** 2).sum())
    return math.sqrt(num / max(den, 1e-30))


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def no_tf32(torch):
    """TF32 off for products and convolutions inside the block (phase 3's
    fp32 reference), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def par_gate(torch, what, table, name, y, ref32, plain=None, world=1):
    """A bf16 path's result y against the fp32 plain result: its relative
    L2 error kept in table[name]. With `plain` (the plain bf16 path's (y,
    error)), phase 3's gate: within 1.5x the plain error + 5e-3, else
    raise; bit equality with the plain bf16 result is kept beside it.
    Returns (y, its error)."""
    e = float(torch.linalg.vector_norm(y - ref32) / torch.linalg.vector_norm(ref32))
    row = table[name]
    row["rel_l2_vs_f32"] = e
    if plain is None:
        return y, e
    bound = 1.5 * plain[1] + 5e-3
    row["bit_equal"] = bool(torch.equal(y, plain[0]))
    row["max_abs_diff_plain_bf16"] = float((y - plain[0]).abs().max())
    t, unit = ("ms", "ms") if "ms" in row else ("s", "s")
    log0(f"  {what}, {name} path at {world} rank(s): relative L2 against fp32 {e:.4e} "
         f"(plain bf16 {plain[1]:.4e}, bound {bound:.4e}), bit for bit the plain bf16's: "
         f"{row['bit_equal']}; {row[t]:.3f} {unit} (plain bf16 {table['plain'][t]:.3f} {unit})")
    if not e <= bound:
        raise AssertionError(f"{what}: the {name} path misses its gate")
    return y, e


def par_step(torch, K, step_mod, mdm, tc, state, batch, draws, null_tokens, dev, remat):
    """One optimizer step of `state` timed alone (host clock, synchronized):
    (state, metrics, seconds, the launch counts of the step)."""
    step = step_mod.make_train_step(mdm, tc, null_tokens, remat=remat)
    sync(torch, dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.enable_grad():
        state, m = step(state, batch, torch.Generator(device=dev).manual_seed(SEED + 17), draws)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    return state, {k: float(v) for k, v in m.items()}, secs, K.launch_counts()


def par_compare(torch, what, state, m, ref, init, world):
    """The step's state (gathered whole) and metrics against the one-process
    `ref`; raises where a gate is missed. Returns the errors."""
    lay = state.layout
    whole = {k: {n: lay.full(k, n, t) for n, t in getattr(state, k).items()}
             for k in ("params", "mu", "nu")}
    err = {k: abs(m[k] - ref["metrics"][k]) / abs(ref["metrics"][k])
           for k in ("loss", "grad_norm")}
    err["mu"] = rel_l2(torch, ((whole["mu"][n], ref["mu"][n]) for n in ref["mu"]))
    err["nu"] = rel_l2(torch, ((whole["nu"][n], ref["nu"][n]) for n in ref["nu"]))
    err["update"] = rel_l2(torch, ((whole["params"][n] - init[n].to(whole["params"][n].device),
                                    ref["params"][n] - init[n]) for n in init))
    bits = all(torch.equal(whole[k][n], ref[k][n].to(whole[k][n].device))
               for k in ("params", "mu", "nu") for n in ref[k])
    log0(f"  {what}: loss {m['loss']:.6f} (one process {ref['metrics']['loss']:.6f}), grad "
         f"norm {m['grad_norm']:.6f} ({ref['metrics']['grad_norm']:.6f}); relative errors "
         f"{ {k: f'{v:.3e}' for k, v in err.items()} }; bit for bit: {bits}")
    ok = (err["loss"] <= PAR_METRIC_TOL and err["grad_norm"] <= PAR_METRIC_TOL
          and err["mu"] <= PAR_MOMENT_TOL and err["nu"] <= 2 * PAR_MOMENT_TOL
          and err["update"] <= PAR_UPDATE_TOL)
    return ok, {**err, "bit_equal": bits, "world": world}


def phase_parallel(torch, K, mdm_mod, step_mod, dev="cuda", preset=None, hw=None):
    """Phase 16: the distributed code paths over a real process group (NCCL
    on the card; one rank unless torchrun launched more): (a) one MDM512
    optimizer step (MDMConfig(), a clip per data rank, accumulation 2,
    dots_attn, seeded batch and draws) through data parallelism with ZeRO-2
    moments against the one-process step (loss, gradient norm, mu, nu, the
    parameters' update), launches at the training sites x micro-steps;
    the same with a planted fault (the gradients averaged twice: once over
    the microbatches, again in the all-reduce buckets), which must miss;
    (b) the step with FSDP; (c) one UNet forward at batch 2 through the SP
    path and through the TP path (data x model), each against the plain
    forward; (d) a 4-step `sample` under SP against the one without. ms
    per step, peak GiB, the gradient all-reduce's buckets and time."""
    import torch.distributed as dist

    from mudg_tpu_torch.models import presets
    from mudg_tpu_torch.nn import unet3d as U
    from mudg_tpu_torch.parallel import mesh as PM
    from mudg_tpu_torch.parallel import sp as SP
    from mudg_tpu_torch.parallel import tp as TP

    made = init_group(torch, dev)
    world = dist.get_world_size()
    cuda = torch.device(dev).type == "cuda"
    report, launches = {"world": world}, {}
    try:
        cfg = presets.get(preset) if preset else mdm_mod.MDMConfig()
        # dropout off: each data rank draws its own masks, which one process
        # at the global batch does not draw
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dropout=0.0))
        f = 2 ** (len(cfg.vae.ch_mult) - 1)
        hw = hw or tuple(n * f for n in LATENT["mdm512"])
        gen = torch.Generator(device=dev).manual_seed(SEED + 16)
        mdm = build_mdm(torch, mdm_mod, cfg, gen, dev)
        tc = step_mod.TrainConfig()
        remat = PAR_POLICY if world == 1 else True
        batch = train_batch(torch, cfg, gen, hw, tc.accum_steps, dev, b=world)
        null_tokens = torch.randint(0, cfg.clip_text.vocab_size, (77,), generator=gen, device=dev)
        mb = {k: v[0] for k, v in batch.items()}
        draws = [mdm_mod.draw_training_noise(cfg, mdm_mod.training_shapes(cfg, mb), gen)
                 for _ in range(tc.accum_steps)]
        params = step_mod.trainable_params(mdm)
        # above one rank the one-process step runs at the global batch: its
        # result and the start wait on the host to leave the card its memory
        keep = dev if world == 1 else "cpu"
        init = {n: p.detach().to(keep, copy=True) for n, p in params.items()}

        def restore():
            with torch.no_grad():
                for n, p in step_mod.trainable_params(mdm).items():
                    PM.local_tensor(p).copy_(init[n])

        # the one-process step (each rank makes it alone at the global batch),
        # after a warm-up step from the same start
        for warm in (True, False):
            restore()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            state = step_mod.init_train_state(mdm, tc)
            state, m, secs, _ = par_step(torch, K, step_mod, mdm, tc, state, batch, draws,
                                         null_tokens, dev, remat)
            if warm:
                del state
        ref = {"metrics": m}
        for k in ("params", "mu", "nu"):
            ref[k] = {n: t.detach().to(keep, copy=True) for n, t in getattr(state, k).items()}
        del state
        report["one_process"] = {"s_per_step": secs, "metrics": m,
                                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30
                                 if cuda else None}
        log0(f"  one process: {secs:.3f} s/step, loss {m['loss']:.6f}, grad norm "
             f"{m['grad_norm']:.6f}")
        expect = policy_launches("mdm512", remat if remat is not True else "full",
                                 tc.accum_steps)

        def distributed(what, fault=False, **layout):
            restore()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            mesh = PM.Mesh([world], ("data",))
            st = step_mod.place_train_state(mdm, tc, mesh, **layout)
            st.layout.buckets.timed = True
            local = PM.shard_batch(batch, mesh, "data", dim=1)
            buckets = PM.Buckets.all_reduce
            if fault:   # the gradients averaged twice
                PM.Buckets.all_reduce = (lambda self, t, g, divide=1.0:
                                         buckets(self, t, g, tc.accum_steps * divide))
            try:
                st, mm, sec, counts = par_step(torch, K, step_mod, mdm, tc, st, local, draws,
                                               null_tokens, dev, remat)
            finally:
                PM.Buckets.all_reduce = buckets
            ok, err = par_compare(torch, what, st, mm, ref, init, world)
            rep = {"s_per_step": sec, "metrics": mm, "errors": err,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
                   "allreduce_s": st.layout.buckets.seconds,
                   "allreduce_buckets": st.layout.buckets.last_buckets,
                   "zero_leaves": len(st.layout.zero), "fsdp_leaves": len(st.layout.fsdp_dims)}
            log0(f"  {what}: {sec:.3f} s/step, peak {rep['peak_gib']} GiB, gradient all-reduce "
                 f"{rep['allreduce_buckets']} buckets in "
                 f"{[round(v * 1e3, 3) for v in rep['allreduce_s']]} ms")
            return ok, rep, counts

        ok, report["dp_zero2"], counts = distributed("(a) data parallel, ZeRO-2")
        check_launches("(a) data parallel", counts, expect)
        launches["parallel_dp"] = counts
        if not ok:
            raise AssertionError("(a) the data-parallel step differs from the one-process step")
        bad, report["dp_fault"], _ = distributed("(a) planted fault, gradients averaged twice",
                                                 fault=True)
        if bad:
            raise AssertionError("(a) the planted fault passed the data-parallel gates")
        ok, report["fsdp"], counts = distributed("(b) FSDP", fsdp=True)
        check_launches("(b) FSDP", counts, expect)
        launches["parallel_fsdp"] = counts
        if not ok:
            raise AssertionError("(b) the FSDP step differs from the one-process step")
        del mdm, params, init, ref
        if cuda:
            torch.cuda.empty_cache()

        # (c) the UNet forward through SP and TP against the plain paths
        with torch.device("meta"):
            unet = U.UNet3D(cfg.unet)
        unet.to_empty(device=dev)
        randomize_(torch, unet, gen)
        unet.eval()
        hh, ww = hw[0] // f, hw[1] // f
        x = torch.randn((2, cfg.unet.temporal_length, hh, ww, cfg.unet.in_channels),
                        generator=gen, device=dev)
        t = torch.full((2,), 700, device=dev)
        ctx = torch.randn((2, cfg.unet.text_context_len + cfg.unet.temporal_length
                           * cfg.unet.image_tokens_per_frame, cfg.unet.context_dim),
                          generator=gen, device=dev)
        lab = torch.zeros(2, dtype=torch.int64, device=dev)
        sp = SP.make_seq_sharding(PM.Mesh([world], ("seq",)))
        n_tp = min(2, world)
        grid = PM.Mesh([world // n_tp, n_tp], ("data", "model"))
        fwd = {}

        def forward(name, dtype=torch.bfloat16, **kw):
            # the second of two calls timed (the first warms the path's
            # kernels and communicators)
            for _ in range(2):
                sync(torch, dev)
                t0 = time.perf_counter()
                y = unet(x.to(dtype), t, ctx.to(dtype), c_label=lab, impl="plain", **kw).float()
                sync(torch, dev)
            fwd[name] = {"ms": (time.perf_counter() - t0) * 1e3}
            return y

        with no_tf32(torch):
            ref32 = forward("plain_f32", torch.float32)
        unet.to(torch.bfloat16)
        plain = par_gate(torch, "(c) UNet forward", fwd, "plain", forward("plain"), ref32)
        for name, run in (("sp", lambda: forward("sp", sp=sp)),
                          ("tp", lambda: (TP.shard_unet_tp(unet, grid, "model"),
                                          forward("tp"))[1])):
            par_gate(torch, "(c) UNet forward", fwd, name, run(), ref32, plain, world)
        report["forward"] = fwd
        del unet, x, ctx, ref32
        if cuda:
            torch.cuda.empty_cache()

        # (d) a 4-step sample under SP against the one without, both in bf16,
        # against fp32's
        mdm = build_mdm(torch, mdm_mod, cfg, gen, dev).float().eval()
        video = torch.rand((1, cfg.unet.temporal_length, *hw, 3), generator=gen,
                           device=dev) * 2 - 1
        depth = torch.rand(video.shape, generator=gen, device=dev) * 2 - 1
        tokens = torch.randint(0, cfg.clip_text.vocab_size, (1, 77), generator=gen, device=dev)
        clips = {}

        def sample(name, dtype=torch.bfloat16, **kw):
            sync(torch, dev)
            t0 = time.perf_counter()
            out = mdm_mod.sample(
                mdm, generator=torch.Generator(device=dev).manual_seed(SEED + 18),
                sparse_frames=video.to(dtype), sparse_depth=depth.to(dtype), tokens=tokens,
                null_tokens=null_tokens, class_label=torch.zeros(1, dtype=torch.int64,
                                                                 device=dev),
                num_steps=PAR_SAMPLE_STEPS, dtype=dtype, impl="plain", **kw)
            sync(torch, dev)
            clips[name] = {"s": time.perf_counter() - t0}
            if not torch.isfinite(out).all():
                raise AssertionError(f"(d) the {name} sample is not finite")
            return out

        with no_tf32(torch):
            ref32 = sample("plain_f32", torch.float32)
        mdm.to(torch.bfloat16)
        plain = par_gate(torch, f"(d) {PAR_SAMPLE_STEPS}-step sample", clips, "plain",
                         sample("plain"), ref32)
        par_gate(torch, f"(d) {PAR_SAMPLE_STEPS}-step sample", clips, "sp", sample("sp", sp=sp),
                 ref32, plain, world)
        report["sample"] = clips
    finally:
        if made:
            dist.destroy_process_group()
    return launches, report


# ---------------------------------------------------------------------------
# Phase 17: int8 serving (quant.py, render/serve --quantize, the quantize
# app) and the conditions app
# ---------------------------------------------------------------------------

QUANT_SNR_DB = 15.0   # int8 against full precision in bf16, tests/test_quant.py:229-231
PEAK_INT8 = 1979e12   # int8 tensor cores, dense (the data sheet above)
YARD_LINEAR = (2 * 16 * 2560, 320, 2560)   # MDM512 ds1's FF projection at batch 2: M, K, N
QUANT_ULPS = 8        # an int8 op's fp32 output against its float64 dequantization
QUANT_OPS = ("linear_i8", "conv_i8", "temporal_conv311_i8")
COND_HW = (1280, 1920)          # the Waymo FRONT camera, height x width
COND_POINTS = 2_000_000         # the background cloud
COND_OBJECTS = (3, 20_000)      # objects, points each
COND_LIDAR = 150_000            # points of each frame's lidar cloud
COND_FRAMES = 2
COND_MATCH, COND_TIE = 0.999, 1e-4   # tests/test_torch_conditions.py's tolerance


def snr_db(torch, ref, y):
    """10 log10(sum ref^2 / sum (ref - y)^2), tests/test_quant.py's measure."""
    ref, y = ref.double(), y.double()
    return 10 * math.log10(float((ref * ref).sum()) / max(float(((ref - y) ** 2).sum()), 1e-300))


def record_int8_sites(torch, Q, fn):
    """Run fn() with each int8 op of `Q` recording its first call per (op,
    input shape, weight shape, arguments): [(op, layer, input, kwargs)]."""
    sites, seen, saved = [], set(), {}
    for op in QUANT_OPS:
        saved[op] = orig = getattr(Q, op)

        def wrapped(m, x, *, _op=op, _orig=orig, **kw):
            key = (_op, tuple(x.shape), tuple(Q.weight_shape(m)), repr(sorted(kw.items())))
            if key not in seen:
                seen.add(key)
                sites.append((_op, m, x.detach().clone(), kw))
            return _orig(m, x, **kw)

        setattr(Q, op, wrapped)
    try:
        out = fn()
    finally:
        for op, orig in saved.items():
            setattr(Q, op, orig)
    return sites, out


def ref_codes(torch, x, per_row):
    """The JAX package's dynamic activation quantization (quant.py:250-268),
    written here apart from the port's: (int8 codes, fp32 scale), the
    absmax per row (last axis) or over the whole tensor."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True) if per_row else xf.abs().amax()
    scale = torch.maximum(amax, torch.tensor(1e-12, device=x.device)) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def _f64_conv(torch, x_i8, w_i8, stride, pads):
    """The exact int8 convolution in float64: x (N, H, W, C) channels-last,
    w (O, C, kh, kw); pads ((top, bottom), (left, right))."""
    import torch.nn.functional as F

    (t, b), (l, r) = pads
    xc = F.pad(x_i8.double().permute(0, 3, 1, 2), (l, r, t, b))
    return F.conv2d(xc, w_i8.double(), stride=stride).permute(0, 2, 3, 1)


def _conv_pads(Q, m, x, kw):
    k = Q.weight_shape(m)[2:]
    s = kw.get("stride", 1)
    p = kw.get("padding", "SAME")
    return ([Q.same_pads(x.shape[1 + i], k[i], s) for i in range(2)] if p == "SAME"
            else [tuple(v) for v in p])


def _excess(torch, y, ref, terms):
    """max over elements of |y - ref| / (QUANT_ULPS * 2^-24 * terms): <= 1
    is fp32 rounding of the float64 dequantization."""
    bound = QUANT_ULPS * 2.0 ** -24 * terms + 1e-30
    return float(((y.double() - ref).abs() / bound).max())


def check_int8_site(torch, Q, op, m, x, kw, w_master):
    """One int8 op at one recorded site: its int32 accumulator equal to the
    float64 product of the same int8 codes (`ref_codes`; exact: |sums| <
    2^53); its fp32 output (the op on x in fp32, the same codes) within fp32
    rounding of the float64 dequantization; and the planted faults, each of which must miss
    that bound: "scale on input axis" (the weight quantized per input
    channel, its scales applied on the output axis; square weights) and, for
    a conv over more than one sample, "per-sample scale" (each sample's own
    activation absmax). Returns {"acc_equal", "excess", "faults": {name:
    excess}}."""
    import torch.nn.functional as F

    scale = m.scale.double()
    bias = 0.0 if m.bias is None else m.bias.double()
    babs = 0.0 if m.bias is None else m.bias.double().abs()
    faults = {}
    w = (m.weight_i8.flatten(1) if op == "linear_i8" else m.weight_i8)
    square = w.shape[0] == w.shape[1]
    if op == "linear_i8":
        acc, _ = Q.linear_acc(m, x)
        x_i8, xs = ref_codes(torch, x, True)

        def prod(codes, wc):
            return (codes.reshape(-1, codes.shape[-1]).double() @ wc.double().t()).reshape(
                *codes.shape[:-1], wc.shape[0])

        exact = prod(x_i8, w)
        y = Q.linear_i8(m, x.float())
        ref = exact * (xs.double() * scale) + bias
        terms = (exact * (xs.double() * scale)).abs() + babs
        if square:
            wa, sa = Q.quantize_weight(w_master.flatten(1), axis=1)
            faults["scale on input axis"] = _excess(
                torch, prod(x_i8, wa) * (xs.double() * sa.double()) + bias, ref, terms)
    elif op == "conv_i8":
        acc, _ = Q.conv_acc(m, x, **kw)
        x_i8, xs = ref_codes(torch, x, False)
        pads = _conv_pads(Q, m, x, kw)
        stride = kw.get("stride", 1)
        exact = _f64_conv(torch, x_i8, w, stride, pads)
        y = Q.conv_i8(m, x.float(), **kw)
        ref = exact * (xs.double() * scale) + bias
        terms = (exact * (xs.double() * scale)).abs() + babs
        if x.shape[0] > 1:
            per = []
            for n in range(x.shape[0]):
                xn, sn = ref_codes(torch, x[n:n + 1], False)
                per.append(_f64_conv(torch, xn, w, stride, pads) * (sn.double() * scale) + bias)
            faults["per-sample scale"] = _excess(torch, torch.cat(per), ref, terms)
    else:
        accs, _ = Q.temporal_accs(m, x)
        x_i8, xs = ref_codes(torch, x, True)
        s = xs.double() * scale

        def taps(wc, codes=x_i8):
            def tap(xi, t):
                return (xi.reshape(-1, xi.shape[-1]).double() @ wc[:, :, t, 0, 0].double().t()
                        ).reshape(*xi.shape[:-1], wc.shape[0])
            return tap(codes[:, :-1], 0), tap(codes, 1), tap(codes[:, 1:], 2)

        def combine(t3, sc):
            parts = (t3[1] * sc, F.pad(t3[0] * sc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)),
                     F.pad(t3[2] * sc[:, 1:], (0, 0, 0, 0, 0, 0, 0, 1)))
            return parts[0] + parts[1] + parts[2] + bias, sum(p.abs() for p in parts) + babs

        exact3 = taps(w)
        acc, exact = torch.cat([a.reshape(-1) for a in accs]), torch.cat(
            [e.reshape(-1) for e in exact3])
        y = Q.temporal_conv311_i8(m, x.float())
        ref, terms = combine(exact3, s)
        if square:
            wa, sa = Q.quantize_weight(w_master, axis=1)
            faults["scale on input axis"] = _excess(
                torch, combine(taps(wa), xs.double() * sa.double())[0], ref, terms)
    return {"acc_equal": bool(torch.equal(acc.double(), exact)),
            "excess": _excess(torch, y, ref, terms), "faults": faults}


def check_int8_sites(torch, Q, sites, masters):
    """check_int8_site at every recorded site (`masters`: layer -> its fp32
    weight before quantization); raises where an accumulator differs, an
    output leaves fp32 rounding or a planted fault passes, or a fault or op
    was never tried. Returns per op the sites, the largest excess and the
    faults' smallest excess."""
    out, tried = {}, set()
    for op, m, x, kw in sites:
        r = check_int8_site(torch, Q, op, m, x, kw, masters[m])
        label = f"{op} {tuple(x.shape)} w{tuple(Q.weight_shape(m))}"
        if not r["acc_equal"]:
            raise AssertionError(f"{label}: the int32 accumulator differs from float64")
        if r["excess"] > 1.0:
            raise AssertionError(f"{label}: output {r['excess']:.2f}x the fp32 rounding bound")
        for name, e in r["faults"].items():
            tried.add(name)
            if e <= 1.0:
                raise AssertionError(f"{label}: planted fault {name!r} passed ({e:.2f})")
        o = out.setdefault(op, {"sites": 0, "max_excess": 0.0, "fault_min_excess": {}})
        o["sites"] += 1
        o["max_excess"] = max(o["max_excess"], r["excess"])
        for name, e in r["faults"].items():
            o["fault_min_excess"][name] = min(o["fault_min_excess"].get(name, math.inf), e)
    missing = {"scale on input axis", "per-sample scale"} - tried
    if missing or set(out) != set(QUANT_OPS):
        raise AssertionError(f"int8 checks: ops {sorted(out)}, faults never tried {missing}")
    return out


def int_mm_yardstick(torch, Q, card):
    """One ds1 linear of the MDM512 forward at batch 2 (YARD_LINEAR): the
    product alone, `int_mm` of int8 codes against torch.matmul in bf16, and
    the whole layer, `linear_i8` (quantize, product, dequantize) against
    F.linear in bf16; median CUDA-event ms beside each product's bound."""
    import torch.nn.functional as F

    m, k, n = YARD_LINEAR
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    lin = torch.nn.Linear(k, n, device="cuda")
    w16, b16 = lin.weight.detach().bfloat16(), lin.bias.detach().bfloat16()
    Q.quantize_module(lin, min_size=0)
    a8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    r = {"shape": [m, k, n],
         "int_mm_ms": cuda_ms(torch, lambda: Q.int_mm(a8, lin.weight_i8)),
         "bf16_matmul_ms": cuda_ms(torch, lambda: torch.matmul(x, w16.t())),
         "linear_i8_ms": cuda_ms(torch, lambda: Q.linear_i8(lin, x)),
         "linear_bf16_ms": cuda_ms(torch, lambda: F.linear(x, w16, b16)),
         "int_mm_bound_ms": bound(2 * m * k * n, m * k + k * n + 4 * m * n, PEAK_INT8)[0],
         "bf16_bound_ms": bound(2 * m * k * n, 2 * (m * k + k * n + m * n))[0]}
    log(f"  yardstick, one ds1 linear {m}x{k} @ {k}x{n}: _int_mm {r['int_mm_ms']:.3f} ms "
        f"(bound {r['int_mm_bound_ms']:.3f}) against bf16 matmul {r['bf16_matmul_ms']:.3f} "
        f"(bound {r['bf16_bound_ms']:.3f}); the W8A8 layer {r['linear_i8_ms']:.3f} ms against "
        f"F.linear bf16 {r['linear_bf16_ms']:.3f} ({card})")
    return r


def quant_unet(torch, K, Q, ri_mod, U, master, mode, cfg=None, dev="cuda", min_size=None):
    """A UNet of `master`'s fp32 weights, quantized as `render --quantize
    mode` does ('none': float), cast to bf16, its float kernel sites packed."""
    with torch.device("meta"):
        unet = U.UNet3D(cfg or U.UNetConfig())
    unet.to_empty(device=dev)
    unet.load_state_dict(master)
    if mode != "none":
        Q.quantize_module(unet, min_size=min_size, **ri_mod.quantize_options(mode))
    unet.to(torch.bfloat16).eval()
    K.prepare_kernels(unet)
    return unet


def phase_quant_forwards(torch, K, Q, ri_mod, U, card, cfg=None, latent=None, dev="cuda",
                         min_size=None):
    """Phase 17 (a) and (b): one full-width MDM512 UNet forward at batch 2
    (re-randomized weights, bf16, 16 frames) unquantized and under each
    --quantize mode; each mode's output at >= QUANT_SNR_DB against the
    unquantized one, launches at SITES with QUANT_SITES; weight bytes
    (size_report), forward time (median of 3) and the forward's peak memory
    above the resident weights. The int8 mode's forward records every int8
    op site, checked by check_int8_sites. `cfg`, `latent` and `min_size`
    let the CPU tests run it small (no timing, no launch check)."""
    on_card = dev == "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    with torch.device("meta"):
        ref_unet = U.UNet3D(cfg or U.UNetConfig())
    ref_unet.to_empty(device=dev)
    randomize_(torch, ref_unet, gen)
    master = {k: v.detach().clone() for k, v in ref_unet.state_dict().items()}
    del ref_unet
    h, w = latent or LATENT["mdm512"]
    b, t = 2, 16 if cfg is None else 4
    c_in = (cfg or U.UNetConfig()).in_channels
    ctx_dim = (cfg or U.UNetConfig()).context_dim
    tokens = 77 + t * (cfg or U.UNetConfig()).image_tokens_per_frame
    x = torch.randn(b, t, h, w, c_in, generator=gen, device=dev).bfloat16()
    ctx = torch.randn(b, tokens, ctx_dim, generator=gen, device=dev).bfloat16()
    ts = torch.full((b,), 700, device=dev)
    lab = torch.zeros(b, dtype=torch.int64, device=dev)
    report, ref, sites = {"card": card}, None, None
    for mode in ("none", *QUANTIZE_MODES):
        unet = quant_unet(torch, K, Q, ri_mod, U, master, mode, cfg, dev, min_size)
        size = Q.size_report(unet)

        def fwd():
            return unet(x, ts, ctx, c_label=lab)

        with torch.no_grad():
            base = torch.cuda.memory_allocated() if on_card else 0
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            if mode == "int8":
                sites, y = record_int8_sites(torch, Q, fwd)
            else:
                y = fwd()
            counts = K.launch_counts()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if on_card else None
            ms = cuda_ms(torch, fwd, iters=3, warmup=1) if on_card else None
        r = {"int8_bytes": size["int8_bytes"], "other_bytes": size["other_bytes"], "ms": ms,
             "peak_forward_gib": peak}
        if mode == "none":
            ref = y.float()
        else:
            r["snr_db"] = snr_db(torch, ref, y.float())
            if not bool(torch.isfinite(y).all()) or r["snr_db"] < QUANT_SNR_DB:
                raise AssertionError(f"--quantize {mode}: SNR {r['snr_db']:.2f} dB against "
                                     f"bf16 is below {QUANT_SNR_DB} dB")
        if on_card:
            expect = {**SITES["mdm512"], **QUANT_SITES.get(mode, {})}
            if counts != expect:
                raise AssertionError(f"--quantize {mode}: launches {counts} != {expect}")
        r["launches"] = counts
        report[mode] = r
        log(f"  --quantize {mode}: weights {size['int8_bytes'] / 2**20:.0f} MiB int8 + "
            f"{size['other_bytes'] / 2**20:.0f} MiB fp, forward "
            f"{'not timed' if ms is None else f'{ms:.1f} ms'}, peak above the weights "
            f"{'not measured' if peak is None else f'{peak:.2f} GiB'}"
            + (f", SNR vs bf16 {r['snr_db']:.2f} dB" if mode != "none" else "")
            + f" ({card})")
        if mode == "int8":
            masters = {m: master[n + (".weight")] for n, m in unet.named_modules()
                       if Q.is_w8a8(m)}
            report["int8_sites"] = check_int8_sites(torch, Q, sites, masters)
            log(f"  int8 ops at every quantized shape of the forward: "
                f"{ {op: v['sites'] for op, v in report['int8_sites'].items()} } sites, "
                f"accumulators equal to float64, outputs within {QUANT_ULPS} fp32 ulps, "
                f"planted faults missed: "
                f"{ {op: v['fault_min_excess'] for op, v in report['int8_sites'].items()} }")
            del sites
        del unet, y
        if on_card:
            torch.cuda.empty_cache()
    return report


def _serve_window(torch, K, ri_mod, serve_mod, flags, window, seed, clip=SERVE_CLIP):
    """One 3-task window through a server built as `serve` builds it: the
    clip (3, T, H, W, 3), its seconds and launches."""
    import numpy as np

    args = serve_mod.parser().parse_args(["--spool", "unused", *SERVE_FLAGS, *flags])
    mdm, sample_fn, tokenizer = ri_mod.build_server(args)
    dev = next(mdm.parameters()).device
    tokens = torch.as_tensor(tokenizer(["A photo a of driving scene."] * 3), device=dev).long()
    null_tokens = torch.as_tensor(tokenizer([""])[0], device=dev).long()
    gen = torch.Generator(device=dev).manual_seed(seed)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    (_, _, out), = ri_mod.render_windows(mdm, sample_fn, window, tokens=tokens,
                                        null_tokens=null_tokens, video_length=clip[0],
                                        generator=gen)
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    del mdm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if out.shape != (3, *clip, 3) or not np.isfinite(out).all() or np.abs(out).max() > 1:
        raise AssertionError(f"served int8 window: output {out.shape} misshapen, not finite "
                             "or outside [-1, 1]")
    return out, secs, counts


def phase_quant_serve(torch, K, mdm_mod, ri_mod, serve_mod, qa_mod, card, dev="cuda",
                      preset="mdm512", small=None):
    """Phase 17 (c): an MDM512 (init_mdm seeded 0, its parameters stored
    fp16 in a torch file) served through `serve`'s build with --quantize
    int8-conv answering one seeded window at batch 6 (launches at SERVE_STEPS x the
    int8-conv sites); then the same window from the `quantize` app's
    artifact of that file (--which conv), bit for bit. The files live in
    _phase17 in the checkout and are deleted. Returns the launches of both
    windows and the report. `dev`, `preset` and `small` (frames, height,
    width, steps, min_size) let the CPU tests run it small (no launch
    check)."""
    import shutil

    import numpy as np

    from mudg_tpu_torch.models import presets
    from mudg_tpu_torch.train import checkpoint as C

    work = os.path.join(ROOT, "_phase17")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    saved_env = os.environ.get("MUDG_ALLOW_HASH_TOKENIZER")
    os.environ["MUDG_ALLOW_HASH_TOKENIZER"] = "1"   # random weights, no BPE table
    try:
        mdm = mdm_mod.init_mdm(presets.get(preset), torch.Generator(device=dev).manual_seed(0))
        params = {n for n, _ in mdm.named_parameters()}
        sd = {k: (v.half() if k in params else v) for k, v in mdm.state_dict().items()}
        # the fp16 source, then the artifact: the int8 UNet layers, the rest fp32
        need = sum(v.numel() * 6 for v in sd.values())
        free = shutil.disk_usage(work).free
        if free < need:
            raise AssertionError(f"phase 17 needs {need / 1e9:.1f} GB of disk, "
                                 f"{free / 1e9:.1f} GB are free")
        src, art = os.path.join(work, "mdm_fp16.pt"), os.path.join(work, "mdm_int8.pt")
        C.save(src, sd)
        del mdm, sd
        clip, size, min_size = SERVE_CLIP, [], []
        if small:
            frames, hh, ww, steps, min_q = small
            clip, min_size = (frames, hh, ww), ["--min_size", str(min_q)]
            size = ["--video_length", str(frames), "--height", str(hh), "--width", str(ww),
                    "--steps", str(steps), "--quantize_min_size", str(min_q)]
        size += ["--preset", preset, "--device", dev]
        window = serve_windows(1, SEED + 17, clip)
        out_q, s_q, c_q = _serve_window(torch, K, ri_mod, serve_mod,
                                        ["--ckpt", src, "--quantize", "int8-conv", *size],
                                        window, SEED + 17, clip)
        t0 = time.perf_counter()
        if qa_mod.main(["--ckpt", src, "--out", art, "--preset", preset, "--which", "conv",
                        "--device", dev, *min_size]) != 0:
            raise AssertionError("the quantize app failed")
        quantize_s = time.perf_counter() - t0
        art_gb = os.path.getsize(art) / 1e9
        out_a, s_a, c_a = _serve_window(torch, K, ri_mod, serve_mod, ["--ckpt", art, *size],
                                        window, SEED + 17, clip)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("MUDG_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["MUDG_ALLOW_HASH_TOKENIZER"] = saved_env
    expect = serve_launches({**SITES["mdm512"], **QUANT_SITES["int8-conv"]}, SERVE_STEPS, 1,
                            False)
    for what, counts in (("--quantize int8-conv", c_q), ("artifact", c_a)):
        if dev == "cuda" and counts != expect:
            raise AssertionError(f"served window ({what}): launches {counts} != {expect}")
    if not np.array_equal(out_q, out_a):
        raise AssertionError("the artifact's window differs from --quantize int8-conv's: max "
                             f"|diff| {np.abs(out_q - out_a).max():.3e}")
    log(f"  served window at batch {SERVE_BATCH}, --quantize int8-conv: {s_q:.3f} s/window; "
        f"quantize app {quantize_s:.1f} s, artifact {art_gb:.2f} GB; the artifact's window "
        f"{s_a:.3f} s, bit for bit ({card})")
    return ({"mdm512_serve_int8_conv": c_q, "mdm512_serve_int8_artifact": c_a},
            {"s_per_window": s_q, "s_per_window_artifact": s_a, "quantize_s": quantize_s,
             "artifact_gb": art_gb, "card": card})


def _rotation_y(angle):
    import numpy as np

    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def conditions_scene(root, hw=COND_HW, n_points=COND_POINTS, objects=COND_OBJECTS,
                     lidar=COND_LIDAR, frames=COND_FRAMES, seed=SEED + 17):
    """A seeded synthetic processed scene for the conditions app: a FRONT
    camera of `hw` with Waymo-like intrinsics moving forward and turning, a
    background cloud of `n_points` (a road plane and building walls), moving
    objects (cars of `objects[1]` points) and per-frame lidar clouds.
    Returns its directory."""
    import pickle

    import numpy as np

    from mudg_tpu_torch.render import pointcloud as PC

    rng = np.random.default_rng(seed)
    h, w = hw
    f = 2000.0 * w / 1920
    K = np.array([[f, 0, w / 2 + 0.3], [0, f, h / 2 - 0.2], [0, 0, 1]])
    c2ws = []
    for i in range(frames):
        c2w = np.eye(4)
        c2w[:3, :3] = _rotation_y(0.02 * i)
        c2w[:3, 3] = [0.1 * i, 0.0, 1.5 * i]
        c2ws.append(c2w)
    scenario = {"observers": {
        "camera_FRONT": {"class_name": "Camera", "n_frames": frames,
                         "data": {"hw": [(h, w)] * frames, "intr": [K] * frames, "c2w": c2ws}},
        "lidar_TOP": {"n_frames": frames}}}
    os.makedirs(os.path.join(root, "objects"), exist_ok=True)
    with open(os.path.join(root, "scenario.pt"), "wb") as fh:
        pickle.dump(scenario, fh)
    n_road = n_points // 2
    road = np.stack([rng.uniform(-20, 20, n_road), np.full(n_road, 1.6) + rng.normal(0, .02, n_road),
                     rng.uniform(2, 80, n_road)], 1)
    n_wall = n_points - n_road
    side = rng.choice([-12.0, 12.0], n_wall)
    wall = np.stack([side + rng.normal(0, .1, n_wall), rng.uniform(-8, 1.6, n_wall),
                     rng.uniform(2, 80, n_wall)], 1)
    xyz = np.concatenate([road, wall]).astype(np.float32)
    rgb = (rng.random((n_points, 3)) * 255).astype(np.uint8)
    PC.store_ply(os.path.join(root, "objects", "background.ply"), xyz, rgb)
    info = []
    for k in range(objects[0]):
        tfs = []
        for i in range(frames):
            tf = np.eye(4)
            tf[:3, :3] = _rotation_y(0.1 * k)
            tf[:3, 3] = [-4.0 + 4.0 * k, 0.8, 10.0 + 6.0 * k + 0.8 * i]
            tfs.append(tf)
        info.append({"id": f"car{k}", "visibility": np.ones(frames, np.int64),
                     "transform_obj": tfs,
                     "point_cloud": {"points": (rng.normal(0, 1, (objects[1], 3))
                                                * [0.9, 0.6, 2.0]).astype(np.float32),
                                     "colors": rng.random((objects[1], 3)).astype(np.float32)}})
    with open(os.path.join(root, "objects_info.pkl"), "wb") as fh:
        pickle.dump(info, fh)
    os.makedirs(os.path.join(root, "lidar_clouds"), exist_ok=True)
    for i in range(frames):
        sel = rng.choice(n_points, lidar, replace=False)
        PC.store_ply(os.path.join(root, "lidar_clouds", f"{i:08d}.ply"), xyz[sel], rgb[sel])
    return root


COND_OUTPUTS = ("sparse", "depth", "virtual_sparse", "virtual_depth", "six_frames_depth",
                "six_frames_sparse")


def run_conditions(mc_mod, media, scene, dev):
    """`conditions --render_virtual --six_frame_depth` on `dev`, its images
    kept in memory (the savers' inputs: the card's machine has no OpenCV)
    and its .npy maps read back; the outputs are removed after. Returns
    ({output name: array}, seconds)."""
    import shutil

    import numpy as np

    maps, save = {}, media.save_image

    def keep(path, img):
        maps[os.path.relpath(path, scene)] = np.array(img)

    media.save_image = keep
    try:
        t0 = time.perf_counter()
        if mc_mod.main(["--scene", scene, "--render_virtual", "--six_frame_depth",
                        "--device", dev]) != 0:
            raise AssertionError(f"conditions on {dev} failed")
        secs = time.perf_counter() - t0
    finally:
        media.save_image = save
    for out in COND_OUTPUTS:
        for d, _, fs in os.walk(os.path.join(scene, out)):
            for fname in fs:
                if fname.endswith(".npy"):
                    p = os.path.join(d, fname)
                    maps[os.path.relpath(p, scene)] = np.load(p)
        shutil.rmtree(os.path.join(scene, out), ignore_errors=True)
    return maps, secs


def tie_pixels(torch, SP, xyz, K, w2c, hw, point_size):
    """The pixels a rounding tie of a point's u or v (within COND_TIE of a
    half-integer) could move: each such point's footprint, widened by one."""
    import numpy as np

    u, v, z = (a.numpy() for a in SP.project_points(
        torch.as_tensor(xyz, dtype=torch.float32), torch.as_tensor(K, dtype=torch.float32),
        torch.as_tensor(w2c, dtype=torch.float32)))
    near = np.zeros(hw, bool)
    tie = ((np.abs(u - np.floor(u) - 0.5) < COND_TIE) | (np.abs(v - np.floor(v) - 0.5) < COND_TIE)
           ) & (z > SP.ZNEAR)
    r = max(int(round(point_size)), 1) // 2 + 1
    for uu, vv in zip(np.round(u[tie]).astype(int), np.round(v[tie]).astype(int)):
        near[max(vv - r, 0):vv + r + 1, max(uu - r, 0):uu + r + 1] = True
    return near


def compare_conditions(torch, SP, PC, scene, card_maps, cpu_maps):
    """The card's maps against the CPU's: the same outputs; each equal at
    >= COND_MATCH of its pixels, every differing pixel near a rounding tie
    of the frame's clouds (at its pose). Returns the count of differing
    pixels."""
    import pickle

    import numpy as np

    if sorted(card_maps) != sorted(cpu_maps) or not card_maps:
        raise AssertionError("the card's and the CPU's conditions outputs differ in name")
    with open(os.path.join(scene, "scenario.pt"), "rb") as fh:
        cam = pickle.load(fh)["observers"]["camera_FRONT"]["data"]
    with open(os.path.join(scene, "objects_info.pkl"), "rb") as fh:
        info = pickle.load(fh)
    vis = PC.object_visibility_table(info)
    clouds = [PC.fetch_ply(os.path.join(scene, "objects", "background.ply"))[0]]
    for d, _, fs in os.walk(os.path.join(scene, "lidar_clouds")):
        clouds += [PC.fetch_ply(os.path.join(d, f))[0] for f in fs]
    n_diff = 0
    for name, a in card_maps.items():
        b = cpu_maps[name]
        diff = a != b
        if diff.ndim == 3:
            diff = diff.any(-1)
        if not diff.any():
            continue
        n_diff += int(diff.sum())
        if diff.mean() > 1 - COND_MATCH:
            raise AssertionError(f"{name}: {diff.mean():.2%} of the pixels differ")
        parts = os.path.splitext(os.path.basename(name))[0].split("_")
        frame = int(parts[0])
        K, c2w = np.asarray(cam["intr"][frame]), np.asarray(cam["c2w"][frame], np.float32)
        if len(parts) > 1 and parts[1].isdigit():   # a virtual pose
            c2w = SP.virtual_poses(c2w)[int(parts[1])]
        xyz = np.concatenate([*clouds, PC.merge_objects_at_frame(info, vis, frame)[0]])
        near = tie_pixels(torch, SP, xyz, K, SP.pose_inverse(c2w, "cpu").numpy(), diff.shape,
                          4.0)
        if not (diff & ~near).any():
            continue
        raise AssertionError(f"{name}: {int((diff & ~near).sum())} differing pixels are no "
                             "rounding tie")
    return n_diff


def phase_conditions(torch, card, dev="cuda", **scene_kw):
    """Phase 17 (d): `conditions --render_virtual --six_frame_depth` on a
    seeded synthetic scene at the Waymo FRONT camera's 1920x1280 (about 2M
    background points, three cars, per-frame lidar clouds; two frames: 2
    real, 4 virtual and 2 six-frame depth renders), on `dev` and on the
    CPU; the maps compared (compare_conditions); the app's seconds on each,
    and one sparse frame's render time on `dev` alone (median of 3)."""
    import pickle
    import tempfile

    import numpy as np

    from mudg_tpu_torch.apps import make_conditions as mc_mod
    from mudg_tpu_torch.render import pointcloud as PC
    from mudg_tpu_torch.render import splat as SP
    from mudg_tpu_torch.utils import media

    with tempfile.TemporaryDirectory(dir=ROOT if dev == "cuda" else None) as d:
        scene = conditions_scene(d, **scene_kw)
        card_maps, card_s = run_conditions(mc_mod, media, scene, dev)
        cpu_maps, cpu_s = run_conditions(mc_mod, media, scene, "cpu")
        n_diff = compare_conditions(torch, SP, PC, scene, card_maps, cpu_maps)
        bg, rgb, _ = PC.fetch_ply(os.path.join(scene, "objects", "background.ply"))
        with open(os.path.join(scene, "objects_info.pkl"), "rb") as fh:
            info = pickle.load(fh)
        oxyz, orgb = PC.merge_objects_at_frame(info, PC.object_visibility_table(info), 0)
        with open(os.path.join(scene, "scenario.pt"), "rb") as fh:
            cam = pickle.load(fh)["observers"]["camera_FRONT"]["data"]
        h, w = cam["hw"][0]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        args = (f32(bg), f32(rgb), f32(oxyz), f32(orgb), f32(cam["intr"][0]),
                np.asarray(cam["c2w"][0], np.float32))
        frame_ms = (cuda_ms(torch, lambda: SP.render_sparse_frame(*args, height=h, width=w),
                            iters=3, warmup=1) if dev == "cuda" else None)
    maps = sum(1 for k in card_maps if k.endswith(".npy"))
    depth = [float((v > 0).mean()) for k, v in card_maps.items() if k.endswith(".npy")]
    log(f"  conditions at {w}x{h}, {len(bg):,} background points: {len(card_maps)} outputs "
        f"({maps} depth maps, hit fraction {min(depth):.3f}-{max(depth):.3f}); app "
        f"{card_s:.2f} s on {dev}, {cpu_s:.2f} s on the CPU; the maps equal but for "
        f"{n_diff} pixels at rounding ties; one sparse frame "
        f"{'not timed' if frame_ms is None else f'{frame_ms:.2f} ms'} on the card ({card})")
    return {"app_s": card_s, "app_s_cpu": cpu_s, "frame_ms": frame_ms, "outputs": len(card_maps),
            "pixels_at_ties": n_diff, "points": len(bg), "card": card}


# ---------------------------------------------------------------------------
# Phase 18: the learned offline stages (segment, densify) and eval
# ---------------------------------------------------------------------------

OFFLINE_HW = (1280, 1920)    # the Waymo FRONT camera, height x width
# densify's defaults are 50 steps at strength 0.8 (40 denoising UNet calls);
# (b) runs 5 steps (4 calls, each pass the same shapes) to fit the time limit
DL_STEPS, DL_STRENGTH = 5, 0.8   # 10 in PR 18
DL_LIDAR = 0.05              # share of the frame's pixels with a lidar depth
SEG_FRAMES = 3
SEG_TOL = 1e-4               # fp32 logits against float64, relative L2
SEG_MARGIN = 1e-3            # ids may differ where float64's top-2 margin < this x max|logit|
EVAL_PAIRS = 16
EVAL_HW = (576, 1024)        # the MDM1024 output
EVAL_TOL = 1e-5              # SSIM and LPIPS against float64, relative
# Kernel sites of DepthLab's reference write pass and one denoising read pass
# (batch 1, a 160x240 latent), held against a trace of the JAX UNet by
# tests/test_torch_depthlab.py: kernel 5 at the write pass's self-attention
# with L = 38400 and 9600 (L = 2400 and 600 fail L % 64; the read pass's
# keys are twice its queries), kernel 3 in bf16 at the FF blocks with C =
# 320 (rows % 256 rejects the wider ones)
DEPTHLAB_SITES = {"f32": {"write": {"flash_attention": 10}, "read": {}},
                  "bf16": {"write": {"flash_attention": 10, "geglu_ff": 5},
                           "read": {"geglu_ff": 5}}}
# kernel 5's (L, heads) in the write pass, five sites each
DL_FLASH = ((38400, 5), (9600, 10))
DL_FLASH_SITES = 5
# the read pass's self-attention, plain in fp32 (keys = queries + the bank's
# entry): (Lq, heads, sites)
DL_READ_ATTN = ((38400, 5, 5), (9600, 10, 5), (2400, 20, 5), (600, 20, 1))


def _diffusers_vae_key(key: str, num_levels: int) -> str:
    """A CompVis (nn/vae.py) VAE key under diffusers' AutoencoderKL name, the
    inverse of `models/depthlab._rename_diffusers_vae_key`."""
    k = key.replace("norm_out", "conv_norm_out")
    k = k.replace("mid.block_1", "mid_block.resnets.0").replace("mid.block_2", "mid_block.resnets.1")
    k = k.replace("mid.attn_1", "mid_block.attentions.0")
    if ".attentions.0." in k:
        k = k.replace(".norm.", ".group_norm.").replace(".proj_out.", ".to_out.0.")
        k = k.replace(".q.", ".to_q.").replace(".k.", ".to_k.").replace(".v.", ".to_v.")
    k = k.replace(".nin_shortcut.", ".conv_shortcut.")
    if ".down." in k:
        k = k.replace(".down.", ".down_blocks.").replace(".block.", ".resnets.")
        k = k.replace(".downsample.conv.", ".downsamplers.0.conv.")
    if ".up." in k:
        parts = k.split(".")
        i = parts.index("up")
        parts[i], parts[i + 1] = "up_blocks", str(num_levels - 1 - int(parts[i + 1]))
        k = ".".join(parts).replace(".block.", ".resnets.")
        k = k.replace(".upsample.conv.", ".upsamplers.0.conv.")
    return k


def write_depthlab_dir(torch, DL, V, root, cfg, gen, dev):
    """A seeded DepthLab checkpoint directory as load_depthlab_dir reads it:
    denoising_unet.pth, reference_unet.pth, mapping_layer.pth (the Linear
    inside `proj`) and vae/diffusion_pytorch_model.bin (diffusers names).
    Returns (the bytes written, each module's parameter sums in float64,
    which the load must give back)."""
    import shutil

    with torch.device("meta"):
        model, vae = DL.DepthLab(cfg), V.AutoencoderKL(cfg.vae)
    need = 4 * sum(p.numel() for m in (model, vae) for p in m.parameters())
    free = shutil.disk_usage(root).free
    if free < 2 * need:
        raise AssertionError(f"phase 18 needs {2 * need / 1e9:.1f} GB of disk, "
                             f"{free / 1e9:.1f} GB are free")
    for m in (model, vae):
        m.to_empty(device=dev)
        randomize_(torch, m, gen)

    def host(sd, prefix=""):
        return {prefix + k: v.detach().cpu() for k, v in sd.items()}

    os.makedirs(os.path.join(root, "vae"), exist_ok=True)
    for name in ("denoising_unet", "reference_unet"):
        torch.save(host(getattr(model, name).state_dict()), os.path.join(root, f"{name}.pth"))
    torch.save(host(model.mapping_layer.state_dict(), "proj."),
               os.path.join(root, "mapping_layer.pth"))
    levels = len(cfg.vae.ch_mult)
    diff = {}
    for k, v in host(vae.state_dict()).items():
        new = _diffusers_vae_key(k, levels)
        if ".attentions.0.to_" in new and new.endswith("weight") and v.ndim == 4:
            v = v.reshape(v.shape[:2])   # diffusers' attention projections are Linear
        diff[new] = v
    torch.save(diff, os.path.join(root, "vae", "diffusion_pytorch_model.bin"))
    sums = {n: [p.double().sum().item() for p in m.parameters()]
            for n, m in (("model", model), ("vae", vae))}
    del model, vae
    return need, sums


@contextlib.contextmanager
def in_memory_media(media, images):
    """media.imread answers from `images` (path -> BGR uint8, the card's
    machine has no OpenCV) and media.save_image keeps what it is given;
    yields that dict of saved images (path -> RGB uint8)."""
    saved = {}
    imread, save = media.imread, media.save_image
    media.imread = lambda path: images[os.path.abspath(path)]
    media.save_image = lambda path, img: saved.__setitem__(os.path.abspath(path), img.copy())
    try:
        yield saved
    finally:
        media.imread, media.save_image = imread, save


@contextlib.contextmanager
def patched(mod, name, value):
    """mod.name set to `value` inside the block (unless value is None)."""
    orig = getattr(mod, name)
    if value is not None:
        setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def offline_scene(root, hw, frames, gen_np):
    """A scene directory with `frames` FRONT frames: each image's path
    exists (an empty file) and its seeded RGB is returned in memory (path ->
    BGR, as OpenCV reads it); each frame's sparse lidar depth (DL_LIDAR of
    the pixels, 2-80 m) is an .npy file. Returns the images."""
    import numpy as np

    cam = "camera_FRONT"
    img_dir = os.path.join(root, "images", cam)
    dep_dir = os.path.join(root, "six_frames_depth", cam)
    os.makedirs(img_dir)
    os.makedirs(dep_dir)
    images = {}
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(frames):
        path = os.path.join(img_dir, f"{i:08d}.jpg")
        open(path, "wb").close()
        # a smooth gradient and seeded noise, so that the classes differ over the frame
        base = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 200
        rgb = np.clip(base + gen_np.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
        images[os.path.abspath(path)] = np.ascontiguousarray(rgb[:, :, ::-1])
        depth = np.where(gen_np.uniform(size=hw) < DL_LIDAR, gen_np.uniform(2, 80, hw), 0.0)
        np.save(os.path.join(dep_dir, f"{i:08d}.npy"), depth.astype(np.float32))
    return images


def phase_segment(torch, K, seg_app, SEG, S, media, root, images, gen, dev="cuda", cfg=None):
    """Phase 18 (c): SegFormer (B3 unless `cfg`) with seeded weights saved
    HF-named as pytorch_model.bin, run by the segment app on the scene's
    frames (counts reset just before, read just after); each frame's fp32
    logits against the same module in float64 (relative L2 <= SEG_TOL) and
    the app's class ids equal float64's but where its top-2 margin is below
    SEG_MARGIN x max|logit|. Returns (launches, report)."""
    import numpy as np

    with torch.device("meta"):
        seg = S.SegFormer(cfg or S.SegFormerConfig())
    seg.to_empty(device=dev)
    randomize_(torch, seg, gen)
    bn = seg.decode_head.batch_norm
    d = bn.running_mean.shape[0]
    bn.running_mean.copy_(0.1 * torch.randn(d, generator=gen, device=dev))
    bn.running_var.copy_(1.0 + 0.1 * torch.randn(d, generator=gen, device=dev).abs())
    bn.num_batches_tracked.zero_()
    ckpt = os.path.join(root, "segformer")
    os.makedirs(ckpt)
    torch.save({k: v.cpu() for k, v in seg.state_dict().items()},
               os.path.join(ckpt, "pytorch_model.bin"))
    del seg
    scene = os.path.join(root, "scene")
    small = None if cfg is None else functools.partial(SEG.load_segformer_predictor, cfg=cfg)
    with in_memory_media(media, images) as saved, patched(SEG, "load_segformer_predictor", small):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        if seg_app.main(["--scene", scene, "--model_path", ckpt, "--device", dev]) != 0:
            raise AssertionError("the segment app failed")
        sync(torch, dev)
        app_s = time.perf_counter() - t0
        counts = K.launch_counts()
    frames = sorted(images)
    pfm_dir = os.path.join(scene, "semantic", "camera_FRONT", "seg")
    ids = [SEG.read_pfm(os.path.join(pfm_dir, f"{i:08d}.pfm"))[0] for i in range(len(frames))]
    palettes = [k for k in saved if "semantic_dense" in k]
    pred = SEG.load_segformer_predictor(ckpt, device=dev, cfg=cfg)
    if pred is None:
        raise AssertionError(f"no SegFormer weights under {ckpt}")
    m32 = pred.model
    m64 = copy.deepcopy(m32).double()
    errs, flips, frame_ms = [], [], []
    for path, got in zip(frames, ids):
        img = torch.as_tensor(images[path][:, :, ::-1].astype(np.float32) / 255.0, device=dev)
        l32 = S.logits_full(m32, img)
        l64 = S.logits_full(m64, img.double())
        errs.append(((l32.double() - l64).norm() / l64.norm()).item())
        top2 = l64.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) >= SEG_MARGIN * l64.abs().max()
        ref_ids = l64.argmax(-1).cpu().numpy()
        wrong = (got.astype(np.int64) != ref_ids) & clear.cpu().numpy()
        flips.append(int((got.astype(np.int64) != ref_ids).sum()))
        if wrong.any():
            raise AssertionError(f"segment: {int(wrong.sum())} ids differ from float64's where "
                                 f"its margin is clear")
        if dev == "cuda":
            frame_ms.append(cuda_ms(torch, lambda: pred(images[path][:, :, ::-1]), iters=3,
                                    warmup=1))
    if max(errs) > SEG_TOL:
        raise AssertionError(f"segment: fp32 logits {max(errs):.3e} from float64 (> {SEG_TOL})")
    check_launches("segment", counts, dict.fromkeys(counts, 0))
    n = len(frames)
    log(f"  (c) segment: {n} frames at {images[frames[0]].shape[1]}x"
        f"{images[frames[0]].shape[0]}, app {app_s:.2f} s ({1e3 * app_s / n:.1f} ms/frame), "
        f"predictor {frame_ms} ms/frame; fp32 logits vs float64 rel L2 max {max(errs):.3e} "
        f"(bound {SEG_TOL}), ids off float64's at {flips} pixels (all at margins "
        f"< {SEG_MARGIN} x max|logit|), {len(palettes)} palettes")
    return counts, {"app_s": app_s, "ms_per_frame_app": 1e3 * app_s / n,
                    "ms_per_frame": frame_ms, "rel_l2_f64": errs, "ids_off_f64": flips}


class UNetTimer:
    """CUDA events around every UNet2DConditionModel forward while active,
    by pass (ref_mode "write" or "read")."""

    def __init__(self, torch, U):
        self.torch, self.U, self.events = torch, U, {"write": [], "read": []}

    def __enter__(self):
        torch, orig, events = self.torch, self.U.UNet2DConditionModel.forward, self.events
        self.orig = orig

        def forward(unet, *a, **k):
            a0, b0 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a0.record()
            out = orig(unet, *a, **k)
            b0.record()
            events["write" if k.get("ref_mode") == "write" else "read"].append((a0, b0))
            return out

        self.U.UNet2DConditionModel.forward = forward
        return self

    def __exit__(self, *exc):
        self.U.UNet2DConditionModel.forward = self.orig

    def ms(self):
        self.torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}


def dense_outputs(scene):
    import numpy as np

    out = {}
    for sub in ("dense", "aligned", "processed"):
        d = os.path.join(scene, f"six_frames_depth_{sub}", "camera_FRONT")
        for f in sorted(os.listdir(d)):
            out[f"{sub}/{f}"] = np.load(os.path.join(d, f))
    return out


def phase_densify(torch, K, dl_app, DL, U, V, SEG, media, root, images, gen, dev="cuda",
                  cfg=None, steps=DL_STEPS):
    """Phase 18 (b): a seeded DepthLab checkpoint directory
    (write_depthlab_dir), then the densify app on the scene's first frame
    with it (fp32, `steps` DDIM steps at strength 0.8; counts reset just
    before, read just after: kernel 5 at DEPTHLAB_SITES' write sites), the
    outputs finite and the sky (class 10 of the segment app's maps) at 100 m;
    then `densify_scene` again with a predictor of the same directory, every
    output bit for bit. Returns (the loaded DepthLab and VAE, launches,
    report)."""
    import numpy as np

    small = None if cfg is None else functools.partial(DL.load_depthlab_dir, cfg=cfg)
    cfg = cfg or DL.DepthLabConfig()
    ckpt = os.path.join(root, "depthlab")
    os.makedirs(ckpt)
    t0 = time.perf_counter()
    nbytes, sums = write_depthlab_dir(torch, DL, V, ckpt, cfg, gen, dev)
    write_s = time.perf_counter() - t0
    if dev == "cuda":
        torch.cuda.empty_cache()
    scene = os.path.join(root, "scene")
    argv = ["--scene", scene, "--cameras", "camera_FRONT", "--depthlab_dir", ckpt,
            "--steps", str(steps), "--strength", str(DL_STRENGTH), "--limit_frames", "1",
            "--device", dev]
    with in_memory_media(media, images), patched(DL, "load_depthlab_dir", small):
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        timer = UNetTimer(torch, U) if dev == "cuda" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with timer:
            dl_app.main(argv)
        sync(torch, dev)
        app_s = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else None
        first = dense_outputs(scene)
        if dev == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model, _, vae = DL.load_depthlab_dir(ckpt, cfg=cfg, device=dev)
        load_s = time.perf_counter() - t0
        loaded = {"model": [p.double().sum().item() for p in model.parameters()],
                  "vae": [p.double().sum().item() for p in vae.parameters()]}
        if loaded != sums:
            raise AssertionError("load_depthlab_dir did not give back the written weights")
        pred = DL.DepthLabPredictor(model, cfg, vae, steps=steps, strength=DL_STRENGTH)
        dl_app.densify_scene(scene, cameras=("camera_FRONT",), predictor=pred, limit_frames=1)
        again = dense_outputs(scene)
    n_run = max(1, min(steps, int(round(steps * DL_STRENGTH))))
    expect = {**dict.fromkeys(counts, 0), **DEPTHLAB_SITES["f32"]["write"]}
    if dev == "cuda":
        check_launches("densify", counts, expect)
    if sorted(first) != ["aligned/00000000.npy", "dense/00000000.npy",
                         "processed/00000000.npy"]:
        raise AssertionError(f"densify wrote {sorted(first)}")
    for k, v in first.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"densify: {k} is not finite")
        if not np.array_equal(v, again[k]):
            raise AssertionError(f"densify: the rerun's {k} differs: max|diff| "
                                 f"{np.abs(v - again[k]).max():.3e}")
    sem, _ = SEG.read_pfm(os.path.join(scene, "semantic", "camera_FRONT", "seg", "00000000.pfm"))
    proc = first["processed/00000000.npy"]
    sky = sem.astype(np.int32) == 10
    if not ((proc[sky] == 100.0).all() and (proc >= 0).all() and (proc <= 100).all()):
        raise AssertionError("densify: the processed map is not sky-filled and clamped")
    ms = timer.ms() if dev == "cuda" else {"write": [], "read": []}
    if dev == "cuda" and (len(ms["write"]), len(ms["read"])) != (1, n_run):
        raise AssertionError(f"densify ran {len(ms['write'])} write and {len(ms['read'])} read "
                             f"passes, not 1 and {n_run}")
    write_ms = ms["write"][0] if ms["write"] else None
    read_ms = float(np.median(ms["read"])) if ms["read"] else None
    unet_s = (sum(ms["write"]) + sum(ms["read"])) / 1e3
    log(f"  (b) densify: one {images[sorted(images)[0]].shape[1]}x"
        f"{images[sorted(images)[0]].shape[0]} frame, {steps} steps at strength {DL_STRENGTH} "
        f"({n_run} UNet calls): {app_s:.1f} s/frame with the load (UNets {unet_s:.1f} s: write "
        f"pass {write_ms} ms, read pass median {read_ms} ms), peak {peak} GiB; checkpoint "
        f"{nbytes / 1e9:.2f} GB written in {write_s:.1f} s, loaded in {load_s:.1f} s; kernel 5 "
        f"x{counts.get('flash_attention')}; rerun bit for bit; sky pixels {int(sky.sum())}")
    return model, vae, counts, {
        "s_per_frame": app_s, "unet_s": unet_s, "write_pass_ms": write_ms,
        "read_pass_ms": read_ms, "read_pass_ms_all": ms["read"], "peak_gib": peak,
        "ckpt_gb": nbytes / 1e9, "ckpt_write_s": write_s, "ckpt_load_s": load_s,
        "steps": steps, "unet_calls": n_run, "sky_pixels": int(sky.sum())}


def phase_depthlab_forwards(torch, K, DL, model, gen, dev="cuda", latent=None):
    """Phase 18 (a): the reference write pass and one read-pass denoising
    forward (batch 1, t = 700) of `model` (fp32, TF32 off) on four paths:
    kernels fp32 and plain fp32, then, cast to bf16, plain bf16 and kernels
    bf16. The fp32 kernel path within F32_PATH_TOL relative L2 of the plain
    one (the write pass's output and bank, the read pass's output), the bf16
    kernel path within 1.5x the plain bf16 path's error against fp32 plus
    5e-3; launches per pass at DEPTHLAB_SITES. Each pass of the checked call
    timed by CUDA events (one call; the first bf16 one includes kernel 3's
    first use when no earlier phase ran it). Returns the report."""
    h, w = latent or (OFFLINE_HW[0] // 8, OFFLINE_HW[1] // 8)
    f4 = torch.float32

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev, dtype=f4)

    z_rgb, x = rnd(1, h, w, 4), rnd(1, h, w, 4)
    z_dep = rnd(1, h, w, 4)
    mask = (torch.rand(1, h, w, 1, generator=gen, device=dev) < 0.3).to(f4).expand(1, h, w, 4)
    ctx = rnd(1, 1, model.cfg.unet.cross_attention_dim)
    t0_, t = (torch.zeros(1, dtype=torch.int64, device=dev),
              torch.full((1,), 700, dtype=torch.int64, device=dev))

    def passes(impl, dtype):
        """Both passes on one path: (write output + bank, read output,
        launches and CUDA-event ms of each pass, None off the card)."""
        counts, ms = {}, {}
        bank = None
        for mode in ("write", "read"):
            K.reset_launch_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if dev == "cuda" else None
            if ev:
                ev[0].record()
            if mode == "write":
                out_w, bank = model.reference_unet(z_rgb.to(dtype), t0_, ctx.to(dtype),
                                                   ref_mode="write", impl=impl)
            else:
                out_r = model.denoising_unet(torch.cat([x, z_dep, mask], -1).to(dtype), t,
                                             ctx.to(dtype), ref_mode="read", ref_bank=bank,
                                             impl=impl)
            if ev:
                ev[1].record()
            sync(torch, dev)
            ms[mode] = ev[0].elapsed_time(ev[1]) if ev else None
            counts[mode] = {k: v for k, v in K.launch_counts().items() if v}
        return [out_w, *bank], out_r, counts, ms

    report, results = {}, {}
    for impl in ("auto", "plain"):
        w_out, r_out, report[f"launches_{impl}_f32"], report[f"ms_{impl}_f32"] = passes(impl, f4)
        results[impl] = (w_out, r_out)
    (kw, kr), (pw, pr) = results["auto"], results["plain"]
    e32 = max(rel_l2(torch, zip(kw, pw)), rel_l2(torch, [(kr, pr)]))
    del results["auto"], kw, kr
    expect = {"auto": DEPTHLAB_SITES["f32"], "plain": {"write": {}, "read": {}}}
    model.to(torch.bfloat16)
    from mudg_tpu_torch.kernels import prepare_kernels

    prepare_kernels(model)
    errs = {}
    for impl in ("plain", "auto"):
        w_out, r_out, report[f"launches_{impl}_bf16"], report[f"ms_{impl}_bf16"] = passes(
            impl, torch.bfloat16)
        errs[impl] = max(rel_l2(torch, zip(w_out, pw)), rel_l2(torch, [(r_out, pr)]))
        expect[f"{impl}_bf16"] = DEPTHLAB_SITES["bf16"] if impl == "auto" else {"write": {},
                                                                                 "read": {}}
        del w_out, r_out
    bound = 1.5 * errs["plain"] + 5e-3
    report.update({"rel_l2_kernels_f32": e32, "rel_l2_plain_bf16": errs["plain"],
                   "rel_l2_kernels_bf16": errs["auto"], "bf16_bound": bound})
    log(f"  (a) DepthLab UNets at a {h}x{w} latent: fp32 kernels vs plain rel L2 {e32:.3e} "
        f"(bound {F32_PATH_TOL}); bf16 kernels {errs['auto']:.3e} vs fp32 (bound {bound:.3e}, "
        f"plain bf16 {errs['plain']:.3e}); write/read ms: kernels fp32 {report['ms_auto_f32']}, "
        f"plain fp32 {report['ms_plain_f32']}, kernels bf16 {report['ms_auto_bf16']}, plain bf16 "
        f"{report['ms_plain_bf16']}")
    if e32 > F32_PATH_TOL:
        raise AssertionError(f"DepthLab fp32 kernel path {e32:.3e} from plain > {F32_PATH_TOL}")
    if errs["auto"] > bound:
        raise AssertionError(f"DepthLab bf16 kernel path {errs['auto']:.3e} > {bound:.3e}")
    for key, want in (("launches_auto_f32", expect["auto"]),
                      ("launches_plain_f32", expect["plain"]),
                      ("launches_auto_bf16", expect["auto_bf16"]),
                      ("launches_plain_bf16", expect["plain_bf16"])):
        if dev == "cuda" and report[key] != want:
            raise AssertionError(f"DepthLab {key}: {report[key]} != {want}")
    return report


def read_pass_attention(torch, nn_att, gen, dev="cuda"):
    """The read pass's self-attentions alone (DL_READ_ATTN, random fp32 q
    and k, v with twice the keys, TF32 off): per shape the plain path's and
    fp32 SDPA's CUDA-event time (median of 3) and their sums over one read
    pass's sites."""
    out, total, total_sdpa = [], 0.0, 0.0
    for lq, heads, sites in DL_READ_ATTN:
        q = torch.randn((1, lq, heads, 64), generator=gen, device=dev)
        k, v = torch.randn((2, 1, 2 * lq, heads, 64), generator=gen, device=dev).unbind(0)
        ms = cuda_ms(torch, lambda: nn_att.plain_attend(q, k, v), iters=3, warmup=1)
        sdpa = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), iters=3, warmup=1)
        total, total_sdpa = total + sites * ms, total_sdpa + sites * sdpa
        out.append({"lq": lq, "lk": 2 * lq, "heads": heads, "sites": sites, "plain_ms": ms,
                    "sdpa_ms": sdpa})
        del q, k, v
    log(f"  read pass's self-attention alone (plain fp32): {total:.1f} ms a pass ({out}); "
        f"fp32 SDPA on the same shapes {total_sdpa:.1f} ms")
    return {"shapes": out, "plain_ms_per_pass": total, "sdpa_ms_per_pass": total_sdpa}


def depthlab_flash_cases(torch, K, nn_att, dev="cuda"):
    """Kernel 5 at the write pass's two lengths, fp32 and bf16 (flash_case:
    phase 2's bounds, faults and SDPA yardstick), DL_FLASH_SITES sites each."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    for dtype in (torch.float32, torch.bfloat16):
        for l, heads in DL_FLASH:
            qkv = torch.randn((1, l, 3, heads, 64), generator=gen, device=dev).to(dtype)
            yield flash_case(torch, K, nn_att, "depthlab" + ("-f32" if dtype == torch.float32
                                                            else ""),
                             "write", DL_FLASH_SITES, qkv)


def lpips_state_dict(torch, gen):
    """A seeded LPIPS state dict in the `lpips` package's layout
    (net.sliceK.N.*, linK.model.1.weight)."""
    from mudg_tpu_torch.utils import lpips as LP

    sd, c_in = {}, 3
    for i, ((c_out, k, _, _), idx) in enumerate(zip(LP._CONVS, LP._CONV_IDX)):
        sd[f"net.slice{i + 1}.{idx}.weight"] = (
            torch.randn((c_out, c_in, k, k), generator=gen) / math.sqrt(c_in * k * k))
        sd[f"net.slice{i + 1}.{idx}.bias"] = 0.1 * torch.randn(c_out, generator=gen)
        sd[f"lin{i}.model.1.weight"] = torch.rand((1, c_out, 1, 1), generator=gen)
        c_in = c_out
    return sd


def phase_eval(torch, K, ev_app, media, root, gen_np, dev="cuda", hw=EVAL_HW, pairs=EVAL_PAIRS):
    """Phase 18 (d): the eval app's three tasks over `pairs` seeded pairs at
    `hw` (color with LPIPS from a seeded lpips-layout file, semantic
    palettes, metric depth .npy), on `dev` and on the CPU: the PSNR, depth
    and mIoU rows equal; each pair's SSIM and LPIPS on `dev` within EVAL_TOL
    relative of a float64 run; ms per frame per task. Returns (launches,
    report)."""
    import numpy as np

    from mudg_tpu_torch.gs import train as GT
    from mudg_tpu_torch.utils import lpips as LP
    from mudg_tpu_torch.utils import metrics as MET

    lp_path = os.path.join(root, "lpips.pth")
    torch.save(lpips_state_dict(torch, torch.Generator().manual_seed(SEED + 34)), lp_path)
    d = {k: os.path.join(root, "eval", k) for k in ("color", "semantic", "depth", "gt_depth")}
    for p in d.values():
        os.makedirs(p)
    images, pngs = {}, []
    h, w = hw
    for i in range(pairs):
        gt = gen_np.integers(0, 256, (h, w, 3)).astype(np.uint8)
        re = np.clip(gt.astype(np.int64) + gen_np.integers(-40, 40, gt.shape), 0,
                     255).astype(np.uint8)
        ids_gt = np.repeat(np.repeat(gen_np.integers(0, 19, (h // 16, w // 16)), 16, 0), 16, 1)
        ids_re = np.where(gen_np.uniform(size=(h, w)) < 0.2, gen_np.integers(0, 19, (h, w)),
                          ids_gt)
        for task, name, rgb in (("color", "gt", gt), ("color", "re", re),
                                ("semantic", "gt", media.encode_semantic(ids_gt)),
                                ("semantic", "re", media.encode_semantic(ids_re))):
            path = os.path.abspath(os.path.join(d[task], f"{task}_{name}_{i}.png"))
            open(path, "wb").close()
            images[path] = np.ascontiguousarray(np.asarray(rgb, np.uint8)[:, :, ::-1])
            pngs.append(path)
        dep = np.where(gen_np.uniform(size=hw) < 0.8, gen_np.uniform(1, 80, hw), 0)
        np.save(os.path.join(d["gt_depth"], f"{i:08d}.npy"), dep.astype(np.float32))
        np.save(os.path.join(d["depth"], f"depth_re_{i}.npy"),
                (dep * gen_np.uniform(0.7, 1.4, hw)).astype(np.float32))
    argv = {"color": ["--dir", d["color"], "--lpips", lp_path],
            "semantic": ["--dir", d["semantic"], "--task", "semantic"],
            "depth": ["--dir", d["depth"], "--task", "depth", "--gt_depth", d["gt_depth"]]}
    out, ms, counts = {}, {}, {}
    with in_memory_media(media, images):
        for task, args in argv.items():
            for where in (dev, "cpu"):
                extra = args if (where == dev or task != "color") else args[:2]
                rows = os.path.join(root, f"{task}_{where}.jsonl")
                K.reset_launch_counts()
                t0 = time.perf_counter()
                summary = ev_app.main([*extra, "--out", rows, "--device", where])
                sync(torch, dev)
                if where == dev:
                    ms[task] = 1e3 * (time.perf_counter() - t0) / pairs
                    counts[task] = K.launch_counts()
                with open(rows) as f:
                    out[task, where] = (summary, [json.loads(line) for line in f])
                if dev == "cpu":
                    break
    exact = {"color": ("psnr",), "semantic": ("miou", "pixel_acc", "n_classes_present"),
             "depth": ("abs_rel", "rmse", "delta1", "n_valid")}
    for task, keys in exact.items():
        got, ref = out[task, dev], out[task, "cpu"]
        for g, r in zip(got[1], ref[1]):
            if any(g[k] != r[k] for k in keys):
                raise AssertionError(f"eval {task}: {g} differs from the CPU's {r}")
        if any(got[0][f"{k}_mean"] != ref[0][f"{k}_mean"] for k in keys if k != "n_valid"
               and k != "n_classes_present"):
            raise AssertionError(f"eval {task}: summary {got[0]} != the CPU's {ref[0]}")
    lp = LP.load_lpips(lp_path, device=dev)
    lp64 = copy.deepcopy(lp).double()
    win64 = GT.gaussian_window(device=dev).double()
    s_err, l_err = [], []
    for i in range(pairs):
        a, b = (images[os.path.abspath(os.path.join(d["color"], f"color_{n}_{i}.png"))]
                .astype(np.float32) / 255.0 for n in ("re", "gt"))
        a64, b64 = (torch.as_tensor(np.ascontiguousarray(x[:, :, ::-1]), device=dev).double()
                    for x in (a, b))
        s32 = MET.ssim(a[:, :, ::-1], b[:, :, ::-1], device=dev)
        s64 = GT.ssim(a64, b64, window=win64).item()
        s_err.append(abs(s32 - s64) / abs(s64))
        l32 = LP.lpips(lp, (a64[None] * 2 - 1).float(), (b64[None] * 2 - 1).float())[0].item()
        l64 = LP.lpips(lp64, a64[None] * 2 - 1, b64[None] * 2 - 1)[0].item()
        l_err.append(abs(l32 - l64) / abs(l64))
    summ = {task: out[task, dev][0] for task in argv}
    log(f"  (d) eval: {pairs} pairs at {w}x{h}: ms/frame {ms}; summaries {summ}; PSNR, depth "
        f"and mIoU rows equal the CPU's; SSIM and LPIPS vs float64 rel max {max(s_err):.3e}, "
        f"{max(l_err):.3e} (bound {EVAL_TOL})")
    if max(s_err) > EVAL_TOL or max(l_err) > EVAL_TOL:
        raise AssertionError(f"eval: SSIM {max(s_err):.3e} / LPIPS {max(l_err):.3e} from float64")
    for task, c in counts.items():
        check_launches(f"eval {task}", c, dict.fromkeys(c, 0))
    return counts, {"ms_per_frame": ms, "summaries": summ, "ssim_rel_f64": max(s_err),
                    "lpips_rel_f64": max(l_err)}


def phase_offline(torch, K, nn_att, card, dev="cuda", small=None):
    """Phase 18: (c) segment, (b) densify, (a) the DepthLab UNet forwards and
    kernel 5 at their lengths, (d) eval, in that order (densify reads
    segment's sky, (a) reuses densify's model), TF32 off, in _phase18 in the
    checkout (deleted after). `small` (dict: hw, depthlab, segformer,
    steps, eval_hw, pairs) lets the CPU tests rehearse it. Returns
    (launches, kernel rows, report)."""
    import shutil

    import numpy as np

    from mudg_tpu_torch.apps import densify_depth as dl_app
    from mudg_tpu_torch.apps import eval_nvs as ev_app
    from mudg_tpu_torch.apps import segment as seg_app
    from mudg_tpu_torch.data import segmentation as SEG
    from mudg_tpu_torch.models import depthlab as DL
    from mudg_tpu_torch.models import sd_unet2d as U
    from mudg_tpu_torch.models import segformer as S
    from mudg_tpu_torch.nn import vae as V
    from mudg_tpu_torch.utils import media

    t_start = time.perf_counter()
    small = small or {}
    hw = small.get("hw", OFFLINE_HW)
    root = os.path.join(ROOT, "_phase18")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    gen_np = np.random.default_rng(SEED + 18)
    report, launches, rows = {"card": card}, {}, {}
    try:
        with no_tf32(torch), torch.no_grad():
            images = offline_scene(os.path.join(root, "scene"), hw, SEG_FRAMES, gen_np)
            launches["segment"], report["segment"] = phase_segment(
                torch, K, seg_app, SEG, S, media, root, images, gen, dev, small.get("segformer"))
            model, vae, launches["densify"], report["densify"] = phase_densify(
                torch, K, dl_app, DL, U, V, SEG, media, root, images, gen, dev,
                small.get("depthlab"), small.get("steps", DL_STEPS))
            del vae
            report["unets"] = phase_depthlab_forwards(torch, K, DL, model, gen, dev,
                                                      (hw[0] // 8, hw[1] // 8))
            del model
            if dev == "cuda":
                torch.cuda.empty_cache()
                rows = run_cases(torch, depthlab_flash_cases(torch, K, nn_att), iters=3)
                report["read_attention"] = read_pass_attention(torch, nn_att, gen)
            launches["eval"], report["eval"] = phase_eval(
                torch, K, ev_app, media, root, gen_np, dev, small.get("eval_hw", EVAL_HW),
                small.get("pairs", EVAL_PAIRS))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["kernel5"] = rows.get("flash_attention", {}).get("shapes", [])
    report["seconds"] = time.perf_counter() - t_start
    return {"densify": launches["densify"], "segment": launches["segment"],
            **{f"eval_{k}": v for k, v in launches["eval"].items()}}, rows, report


# ---------------------------------------------------------------------------
# Phase 19: the host ETL (preprocess, build_clouds, voxel downsampling) and
# the UNet and sampler options that no MuDG config sets
# ---------------------------------------------------------------------------

# A Waymo segment has about 198 frames; phase 19 runs ETL_FRAMES of them (a cut
# in depth, to fit the time limit), at the published sensor sizes.
ETL_FRAMES = 6
# (CameraName, name, width, height, yaw of its optical axis in the vehicle)
WAYMO_CAMS = ((1, "FRONT", 1920, 1280, 0.0), (2, "FRONT_LEFT", 1920, 1280, 0.8),
              (3, "FRONT_RIGHT", 1920, 1280, -0.8), (4, "SIDE_LEFT", 1920, 886, 1.6),
              (5, "SIDE_RIGHT", 1920, 886, -1.6))
TOP_HW = (64, 2650)          # the TOP lidar's range image
SHORT_HW = (200, 600)        # each of the four short lidars'
# (LaserName, x, y, z, yaw) of the short lidars on the vehicle
SHORT_LIDARS = ((2, 4.0, 0.0, 0.6, 0.0), (3, 2.0, 1.0, 0.9, 1.57),
                (4, 2.0, -1.0, 0.9, -1.57), (5, -1.0, 0.0, 0.9, 3.14))
ETL_BOXES = (30, 10)         # labelled boxes, of which moving
ETL_REL = 1e-12              # scenario.pt arrays, card against CPU, relative
CLOUD_REL = 1e-6             # build_clouds' rows, card against CPU, relative
VOXEL_FRAMES, VOXEL_PER_FRAME = 198, 101_000   # (c): a segment's background, ~20M points
VOXEL_TRACK, VOXEL_RANGE, VOXEL_SIZE = 200.0, 75.0, 0.1
SAMPLER_REL = 1e-5           # (e): the card against the CPU, relative
SAMPLER_STEPS = 25
TIE_REL = 1e-9               # a projected coordinate this close to an integer is a tie
FACE_ABS = 1e-5              # a box coordinate this close to a face (m) is at the face


def _pb_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _pb_key(field, wire):
    return _pb_varint(field << 3 | wire)


def _pb_int(field, v):
    return _pb_key(field, 0) + _pb_varint(int(v))


def _pb_double(field, v):
    import struct

    return _pb_key(field, 1) + struct.pack("<d", float(v))


def _pb_bytes(field, b: bytes):
    return _pb_key(field, 2) + _pb_varint(len(b)) + b


def _pb_doubles(field, vals):
    import numpy as np

    return _pb_bytes(field, np.asarray(vals, "<f8").tobytes())


def _pb_matrix(arr) -> bytes:
    """A MatrixFloat: data=1 (packed float), shape=2 {dims=1 (packed int32)}."""
    import numpy as np

    dims = b"".join(_pb_varint(d) for d in arr.shape)
    return (_pb_bytes(1, np.ascontiguousarray(arr, "<f4").tobytes())
            + _pb_bytes(2, _pb_bytes(1, dims)))


def _pose4(x, y, z, yaw, roll=0.0, pitch=0.0):
    import numpy as np

    cr, sr, cp, sp, cy, sy = (np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch),
                              np.cos(yaw), np.sin(yaw))
    m = np.eye(4)
    m[:3, :3] = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                 [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                 [-sp, cp * sr, cp * cr]]
    m[:3, 3] = x, y, z
    return m


def _smooth_image(rng, h, w):
    """A smooth seeded RGB image (a few low-frequency waves a channel)."""
    import numpy as np

    y = np.linspace(0, 2 * np.pi, h)[:, None]
    x = np.linspace(0, 2 * np.pi, w)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):   # 127 + 70 sin(a x + b y + p) + 40 cos(q x - a y), as a rank-4 product
        a, b, p, q = rng.uniform(0.5, 4.0, 4)
        rows = np.concatenate([70 * np.cos(b * y), 70 * np.sin(b * y), 40 * np.cos(a * y),
                               40 * np.sin(a * y)], 1).astype(np.float32)
        cols = np.concatenate([np.sin(a * x + p), np.cos(a * x + p), np.cos(q * x),
                               np.sin(q * x)], 0).astype(np.float32)
        img[..., c] = 127 + rows @ cols
    return np.clip(img, 0, 255).astype(np.uint8)


def _lidar_rays(h, w, incl, yaw):
    """(H, W, 3) sensor-frame unit directions as the Waymo range image lays
    them out (column 0 at azimuth pi less the yaw)."""
    import numpy as np

    az = ((np.arange(w)[::-1] + 0.5) / w * 2 - 1) * np.pi - yaw
    return np.stack([np.cos(az)[None] * np.cos(incl)[:, None],
                     np.sin(az)[None] * np.cos(incl)[:, None],
                     np.broadcast_to(np.sin(incl)[:, None], (h, w))], -1)


def _ground_ranges(rng, dirs, height, wall):
    """Ranges of rays from a sensor `height` m above flat ground; rays that
    meet no ground within 80 m end on a wall `wall` m (+ noise) away; 3% no
    return (-1)."""
    import numpy as np

    down = -dirs[..., 2]
    with np.errstate(divide="ignore"):
        r = np.where(down > 0.02, height / np.maximum(down, 1e-9), np.inf)
    r = np.where(r < 80.0, r, wall + 5.0 * np.sin(3 * np.arctan2(dirs[..., 1], dirs[..., 0])))
    r = r + rng.normal(0, 0.02, r.shape)
    r[rng.random(r.shape) < 0.03] = -1.0
    return r.astype(np.float32)


def waymo_segment(path, frames=ETL_FRAMES, seed=SEED + 19, cams=WAYMO_CAMS, top=TOP_HW,
                  short=SHORT_HW, boxes=ETL_BOXES):
    """A tfrecord of `frames` Waymo Frames, valid on the wire, at the given
    sensor sizes: the cameras (a real JPEG of a smooth seeded image each),
    the TOP lidar (explicit beam inclinations, a per-pixel pose image for
    the rolling shutter, 2% of its pixels without a pose), the four short
    lidars (min/max inclinations) and `boxes` = (labelled, moving) boxes on
    the ground around an ego vehicle driving at 10 m/s. Written by this
    script's own protobuf encoder. Returns the record sizes."""
    import struct

    import cv2
    import numpy as np
    import zlib

    rng = np.random.default_rng(seed)
    origin = np.array([1200.5, -3400.25, 12.0])
    yaw0 = 0.3
    n_box, n_moving = boxes
    kinds = [(1, 4.5, 2.0, 1.6)] * 22 + [(2, 0.8, 0.8, 1.8)] * 6 + [(3, 0.3, 0.3, 2.5)] * 2
    box_start, box_heading, box_speed = [], [], []
    for k in range(n_box):
        fwd = 8.0 + 2.5 * k if k < n_moving else rng.uniform(-30, 40)
        side = (-1) ** k * (3.5 + 3.5 * (k % 3)) if k < n_moving else rng.uniform(-25, 25)
        d = np.array([np.cos(yaw0), np.sin(yaw0)])
        n_ = np.array([-np.sin(yaw0), np.cos(yaw0)])
        box_start.append(origin[:2] + fwd * d + side * n_)
        box_heading.append(yaw0 + (0.0 if k < n_moving else rng.uniform(-np.pi, np.pi)))
        box_speed.append(6.0 + 0.4 * k if k < n_moving else 0.0)
    top_incl = np.linspace(-0.307, 0.042, top[0])
    top_ext = _pose4(1.43, 0.0, 2.18, 0.0148)
    records = []
    for i in range(frames):
        yaw = yaw0 + 0.002 * i
        pos = origin + np.array([np.cos(yaw0), np.sin(yaw0), 0.0]) * 1.0 * i
        v2w = _pose4(*pos, yaw)
        ts = 1_600_000_000_000_000 + i * 100_000
        ctx = _pb_bytes(1, b"segment-phase19-synthetic")
        images = b""
        for name, _, w, h, cyaw in cams:
            f = 2055.0 * w / 1920
            ext = _pose4(1.5 * np.cos(cyaw), 1.5 * np.sin(cyaw), 2.0, cyaw)
            ctx += _pb_bytes(2, _pb_int(1, name)
                             + _pb_doubles(2, [f, f, w / 2, h / 2, 0, 0, 0, 0, 0])
                             + _pb_bytes(3, _pb_doubles(1, ext.reshape(-1)))
                             + _pb_int(4, w) + _pb_int(5, h) + _pb_int(6, 2))
            ok, jpg = cv2.imencode(".jpg", _smooth_image(rng, h, w)[..., ::-1],
                                   [cv2.IMWRITE_JPEG_QUALITY, 95])
            if not ok:
                raise AssertionError("cv2 did not encode a JPEG")
            cam_pose = _pose4(*(pos + 0.02 * np.array([np.cos(yaw), np.sin(yaw), 0])), yaw)
            images += _pb_bytes(4, _pb_int(1, name) + _pb_bytes(2, jpg.tobytes())
                                + _pb_bytes(3, _pb_doubles(1, cam_pose.reshape(-1)))
                                + _pb_double(5, ts / 1e6 + 0.02) + _pb_double(6, 0.005)
                                + _pb_double(7, ts / 1e6 + 0.015) + _pb_double(8, ts / 1e6 + 0.025))
        ctx += _pb_bytes(3, _pb_int(1, 1) + _pb_doubles(2, top_incl)
                         + _pb_bytes(5, _pb_doubles(1, top_ext.reshape(-1))))
        hh, ww = top
        ri = np.zeros((hh, ww, 4), np.float32)
        ri[..., 0] = _ground_ranges(rng, _lidar_rays(hh, ww, top_incl[::-1], 0.0148), 2.18, 45.0)
        ri[..., 1] = rng.random((hh, ww))
        dt = ((np.arange(ww) + 0.5) / ww - 0.5) * 0.1
        pose = np.empty((hh, ww, 6), np.float32)
        pose[..., 0], pose[..., 1] = 0.001, 0.002
        pose[..., 2] = yaw + 0.02 * dt
        for a in range(2):
            pose[..., 3 + a] = pos[a] + 10.0 * dt * (np.cos(yaw) if a == 0 else np.sin(yaw))
        pose[..., 5] = pos[2]
        pose[rng.random((hh, ww)) < 0.02] = 0.0
        top_ri = (_pb_bytes(2, zlib.compress(_pb_matrix(ri), 1))
                  + _pb_bytes(4, zlib.compress(_pb_matrix(pose), 1)))
        lasers = _pb_bytes(5, _pb_int(1, 1) + _pb_bytes(2, top_ri))
        for name, x, y, z, lyaw in SHORT_LIDARS:
            ext = _pose4(x, y, z, lyaw)
            ctx += _pb_bytes(3, _pb_int(1, name) + _pb_double(3, -1.2) + _pb_double(4, 0.5)
                             + _pb_bytes(5, _pb_doubles(1, ext.reshape(-1))))
            sh, sw = short
            incl = np.linspace(0.5, -1.2, sh)
            rs = np.zeros((sh, sw, 4), np.float32)
            rs[..., 0] = _ground_ranges(rng, _lidar_rays(sh, sw, incl, lyaw), z, 12.0)
            lasers += _pb_bytes(5, _pb_int(1, name)
                                + _pb_bytes(2, _pb_bytes(2, zlib.compress(_pb_matrix(rs), 1))))
        labels = b""
        w2v = np.linalg.inv(v2w)
        for k in range(n_box):
            typ, length, width, height = kinds[k % len(kinds)]
            head = box_heading[k]
            c = np.append(box_start[k] + 0.1 * i * box_speed[k] * np.array([np.cos(head),
                                                                             np.sin(head)]),
                          origin[2] + height / 2 - 0.1)   # 10 cm into the ground
            cv = w2v @ np.append(c, 1.0)
            vs = w2v[:3, :3] @ (box_speed[k] * np.array([np.cos(head), np.sin(head), 0.0]))
            box = (_pb_double(1, cv[0]) + _pb_double(2, cv[1]) + _pb_double(3, cv[2])
                   + _pb_double(4, width) + _pb_double(5, length) + _pb_double(6, height)
                   + _pb_double(7, head - yaw))
            labels += _pb_bytes(6, _pb_bytes(1, box) + _pb_bytes(2, _pb_double(1, vs[0])
                                                                  + _pb_double(2, vs[1]))
                                + _pb_int(3, typ) + _pb_bytes(4, f"obj-{k:02d}".encode()))
        records.append(_pb_bytes(1, ctx) + _pb_int(2, ts)
                       + _pb_bytes(3, _pb_doubles(1, v2w.reshape(-1))) + images + lasers + labels)
    with open(path, "wb") as fh:
        for rec in records:
            fh.write(struct.pack("<Q", len(rec)) + b"\0" * 4 + rec + b"\0" * 4)
    return [len(r) for r in records]


def _walk_equal(a, b, path, rel=ETL_REL):
    """scenario.pt trees equal: keys, types, shapes and dtypes; floats within
    `rel` of the array's max."""
    import numpy as np

    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys differ: {set(a) ^ set(b)}")
        for k in a:
            _walk_equal(a[k], b[k], f"{path}/{k}", rel)
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        for i, (u, v) in enumerate(zip(a, b)):
            _walk_equal(u, v, f"{path}[{i}]", rel)
    elif isinstance(a, np.ndarray):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{path}: {a.shape} {a.dtype} != {b.shape} {b.dtype}")
        if a.dtype.kind == "f":
            if np.abs(a - b).max(initial=0) > rel * max(np.abs(a).max(initial=0), 1e-300):
                raise AssertionError(f"{path}: differs beyond {rel} relative")
        elif not (a == b).all():
            raise AssertionError(f"{path}: differs")
    elif isinstance(a, float):
        if abs(a - b) > rel * abs(a):
            raise AssertionError(f"{path}: {a} != {b}")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")


def compare_etl_outputs(card, cpu):
    """(a): the card's processed scene against the CPU's: scenario.pt within
    ETL_REL, every npz array within one fp32 ulp, every JPEG byte for byte,
    the same files. Returns (files, largest npz difference in ulps)."""
    import pickle

    import numpy as np

    files = sorted(os.path.relpath(os.path.join(d, f), card)
                   for d, _, fs in os.walk(card) for f in fs)
    other = sorted(os.path.relpath(os.path.join(d, f), cpu)
                   for d, _, fs in os.walk(cpu) for f in fs)
    if files != other:
        raise AssertionError("the card's and the CPU's preprocess wrote other files")
    ulps = 0.0
    for rel in files:
        p, q = os.path.join(card, rel), os.path.join(cpu, rel)
        if rel.endswith(".pt"):
            with open(p, "rb") as f, open(q, "rb") as g:
                _walk_equal(pickle.load(f), pickle.load(g), rel)
        elif rel.endswith(".npz"):
            with np.load(p) as a, np.load(q) as b:
                if a.files != b.files:
                    raise AssertionError(f"{rel}: arrays differ")
                for k in a.files:
                    u, v = a[k], b[k]
                    if u.shape != v.shape or u.dtype != v.dtype:
                        raise AssertionError(f"{rel}/{k}: shape or dtype differs")
                    d = np.abs(u.astype(np.float64) - v) / np.spacing(np.abs(u)).astype(np.float64)
                    ulps = max(ulps, float(d.max(initial=0)))
        else:
            with open(p, "rb") as f, open(q, "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"{rel}: bytes differ")
    if ulps > 1.0:
        raise AssertionError(f"npz arrays differ by {ulps} fp32 ulps")
    return len(files), ulps


def cloud_outputs(scene):
    """build_clouds' clouds: {name: (N, 6) float64 rows of xyz | rgb}; the
    objects' from objects_info.pkl, the rest from their PLYs."""
    import pickle

    import numpy as np

    from mudg_tpu_torch.render import pointcloud as PC

    out = {}
    with open(os.path.join(scene, "objects_info.pkl"), "rb") as f:
        for o in pickle.load(f):
            pc = o["point_cloud"]
            out["object " + o["id"]] = np.concatenate([pc["points"], pc["colors"]], 1)
    for d in ("objects", "lidar_clouds"):
        for fname in sorted(os.listdir(os.path.join(scene, d))):
            xyz, rgb, _ = PC.fetch_ply(os.path.join(scene, d, fname))
            out[f"{d}/{fname}"] = np.concatenate([xyz, rgb], 1)
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def _sorted_rows(a):
    import numpy as np

    return a[np.lexsort(a.T[::-1])]


def compare_clouds(card, cpu, allowed):
    """Each cloud's rows, sorted, within CLOUD_REL of the CPU's; the rows
    that are not are counted, and more than `allowed` (the points at
    rounding ties or box faces, each of which may move one row or two voxel
    centroids) fails. Returns (clouds, points, differing rows)."""
    import numpy as np

    if sorted(card) != sorted(cpu):
        raise AssertionError("the card's and the CPU's build_clouds wrote other clouds")
    n_diff = n_points = 0
    for k in card:
        a, b = _sorted_rows(card[k]), _sorted_rows(cpu[k])
        n_points += len(a)
        if a.shape != b.shape:
            n_diff += abs(len(a) - len(b)) + min(len(a), len(b))
            continue
        scale = max(np.abs(b).max(initial=0), 1e-30)
        n_diff += int((np.abs(a - b) > CLOUD_REL * scale).any(1).sum())
    if n_diff > allowed:
        raise AssertionError(f"build_clouds: {n_diff} rows differ, {allowed} allowed by the "
                             "points at rounding ties or box faces")
    return len(card), n_points, n_diff


def tie_and_face_points(torch, scene, cameras):
    """Points of the TOP lidar clouds whose projection into a camera lies
    within TIE_REL of an integer pixel coordinate or of the frame's edge,
    or whose box coordinate lies within FACE_ABS of a moving box's face:
    where the card and the CPU may round apart. Counted on the CPU in
    float64, over every frame."""
    import pickle

    import numpy as np

    from mudg_tpu_torch.apps import build_clouds as BC
    from mudg_tpu_torch.data.waymo_etl import lidar_frame_to_world
    from mudg_tpu_torch.render import lidar as L

    with open(os.path.join(scene, "scenario.pt"), "rb") as f:
        sc = pickle.load(f)
    obs = sc["observers"]
    lidar = obs["lidar_TOP"]
    objs = [o for o in BC.flatten_objects(sc) if L.is_object_moving(
        o["transform_obj"][o["visibility"] > 0][:, :3, 3])]
    n = 0
    for i in range(lidar["n_frames"]):
        with np.load(os.path.join(scene, "lidars", "lidar_TOP", f"{i:08d}.npz")) as z:
            o, d = lidar_frame_to_world(torch.as_tensor(z["rays_o"].reshape(-1, 3)),
                                        torch.as_tensor(z["rays_d"].reshape(-1, 3)),
                                        lidar["data"]["l2w"][i])
            xyz, _ = L.rays_to_points(o, d, torch.as_tensor(z["ranges"].reshape(-1)))
        x = xyz.double().numpy()
        near = np.zeros(len(x), bool)
        for name in cameras:
            cam = obs[name]["data"]
            K = cam["intr"][i]
            w2c = np.linalg.inv(cam["c2w"][i])
            p = x @ w2c[:3, :3].T + w2c[:3, 3]
            with np.errstate(divide="ignore", invalid="ignore"):
                for uv, lim in ((K[0, 0] * p[:, 0] / p[:, 2] + K[0, 2], cam["hw"][i][1]),
                                (K[1, 1] * p[:, 1] / p[:, 2] + K[1, 2], cam["hw"][i][0])):
                    frac = np.abs(uv - np.round(uv))
                    near |= (frac <= TIE_REL * np.maximum(np.abs(uv), 1)) | (
                        np.abs(uv - lim) <= TIE_REL * lim)
            near |= np.abs(p[:, 2] - 0.1) <= TIE_REL
        for ob in objs:
            if not ob["visibility"][i]:
                continue
            w2b = np.linalg.inv(ob["transform_obj"][i])
            b = x @ w2b[:3, :3].T + w2b[:3, 3]
            near |= (np.abs(np.abs(b) - ob["bbox"][i] / 2) <= FACE_ABS).any(1) & (
                np.abs(b) <= ob["bbox"][i] / 2 + FACE_ABS).all(1)
        n += int(near.sum())
    return n


def voxel_cloud(torch, seed, frames=VOXEL_FRAMES, per_frame=VOXEL_PER_FRAME):
    """A seeded segment's background on the CPU: `frames` scans along a
    VOXEL_TRACK m straight track, each `per_frame` points within
    VOXEL_RANGE m, denser near the sensor (r = 2 + 73 u^2), 80% on the
    ground and 20% on walls up to 8 m; RGB in [0, 1]."""
    gen = torch.Generator().manual_seed(seed)
    n = frames * per_frame
    cx = (torch.arange(frames, dtype=torch.float32) * (VOXEL_TRACK / frames)).repeat_interleave(
        per_frame)
    th = torch.rand(n, generator=gen) * (2 * math.pi)
    r = 2.0 + (VOXEL_RANGE - 2.0) * torch.rand(n, generator=gen) ** 2
    z = torch.randn(n, generator=gen) * 0.05
    wall = torch.rand(n, generator=gen) < 0.2
    z = torch.where(wall, torch.rand(n, generator=gen) * 8.0, z)
    xyz = torch.stack([cx + r * torch.cos(th), r * torch.sin(th), z], 1)
    return xyz, torch.rand(n, 3, generator=gen)


class SeededDraws:
    """draws[i]: the i-th of a sequence of standard normal tensors, the
    same on every device: one seeded normal tensor drawn on the CPU, its
    flattened values rolled by 7919 i (each step's draw another
    arrangement of it; no draw made anew per step)."""

    def __init__(self, torch, shape, seed):
        self.shape = shape
        self.base = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).reshape(-1)

    def __getitem__(self, i):
        return self.base.roll(7919 * i).reshape(self.shape)


def closed_form_model(torch, shape, seed):
    """A seeded denoiser with only exactly rounded operations (products,
    sums, a division), so that the card and the CPU agree bit for bit:
    out = a x / (1 + |x|) + b t / 1000."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(shape[1:], generator=gen) * 0.5
    b = float(torch.randn((), generator=gen))
    cache = {}

    def fn(x, t):
        aa = cache.setdefault(x.device, a.to(x.device))
        return aa * x / (1.0 + x.abs()) + b * t.float().reshape(-1, *(1,) * (x.ndim - 1)) / 1000.0

    return fn


def run_samplers(torch, dev, shape, steps=SAMPLER_STEPS, seed=SEED + 19):
    """(e) on `dev`: masked DDIM (eta 1) and DPM-Solver++ at `steps`,
    stochastic_encode at every DDIM index and the full ancestral
    ddpm_sample in v (no clipping), eps and x0 (clip_denoised), each from
    the same seeded inputs and draws. Returns ({name: output on the
    CPU}, {name: seconds})."""
    from mudg_tpu_torch.core import schedules as TS
    from mudg_tpu_torch.diffusion import ddim as TDDIM
    from mudg_tpu_torch.diffusion import dpm as TDPM

    gen = torch.Generator().manual_seed(seed)
    mask = (torch.rand(shape, generator=gen) > 0.5).float().to(dev)
    x0 = torch.randn(shape, generator=gen).to(dev)
    x_T = torch.randn(shape, generator=gen).to(dev)
    fn = closed_form_model(torch, shape, seed + 1)
    sched = TS.DiffusionSchedule.create()
    out, secs = {}, {}

    def timed(name, f):
        t0 = time.perf_counter()
        r = f()
        out[name] = r.cpu()
        secs[name] = time.perf_counter() - t0

    dc = TDDIM.make_ddim_constants(sched, steps, device=dev)
    timed("ddim_masked", lambda: TDDIM.ddim_sample(
        fn, None, shape, dc, x_T=x_T, mask=mask, x0=x0, sched=sched, device=dev,
        draws={"noise": SeededDraws(torch, shape, seed + 2),
               "noise_q": SeededDraws(torch, shape, seed + 3)}))
    timed("dpm_masked", lambda: TDPM.dpmpp_sample(
        fn, None, shape, TDPM.make_dpmpp_constants(sched, steps, device=dev), x_T=x_T,
        mask=mask, x0=x0, sched=sched, device=dev,
        draws={"noise_q": SeededDraws(torch, shape, seed + 4)}))
    timed("stochastic_encode", lambda: torch.stack([
        TDDIM.stochastic_encode(x0, i, dc, x_T) for i in range(steps)]))
    for k, (param, clip) in enumerate((("v", False), ("eps", True), ("x0", True))):
        s = TS.DiffusionSchedule.create(parameterization="v" if param == "x0" else param)
        timed(f"ddpm_{param}", lambda: TDDIM.ddpm_sample(
            fn, None, shape, s, parameterization=param, clip_denoised=clip, device=dev,
            x_T=x_T, draws={"noise": SeededDraws(torch, shape, seed + 5 + k)}))
    return out, secs


def option_unet(torch, K, U, name, gen, cfg_kw=None):
    """phase 19 (d)'s UNet `name` at full UNetConfig() width (or `cfg_kw`),
    fp32, every parameter re-randomized."""
    cfg = U.UNetConfig(**{**(cfg_kw or {}), **OPTION_UNETS[name]})
    with torch.device("meta"):
        unet = U.UNet3D(cfg)
    unet.to_empty(device=gen.device)
    return randomize_(torch, unet, gen).eval(), cfg


def phase_option_forwards(torch, K, U, card, dev="cuda", cfg_kw=None, latents=None, frames=16):
    """(d): each option UNet at its batch and latent, fp32 plain (TF32 off),
    bf16 plain and bf16 on the kernels; the kernel path within 1.5x the
    plain bf16 path's relative L2 against fp32 + 5e-3, its launches at
    OPTION_SITES (counts reset just before, read just after); each bf16
    forward timed (kernels median of 3; plain the checked call). The
    cross-context UNet must first raise JAX's ValueError at the MDM512
    latent. Returns (launches by path, report)."""
    launches, report = {}, {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    for name in OPTION_UNETS:
        unet, cfg = option_unet(torch, K, U, name, gen, cfg_kw)
        b = OPTION_BATCH[name]
        h, w = (latents or LATENT)[OPTION_LATENT[name]]
        x = torch.randn(b, frames, h, w, cfg.in_channels, generator=gen, device=dev)
        ctx = torch.randn(b, 77 + frames * 16, cfg.context_dim, generator=gen, device=dev)
        t = torch.tensor([700, 300, 50][:b], device=dev)
        lab = torch.tensor([0, 500, 1000][:b], device=dev)
        with torch.no_grad():
            if name == "context":
                h5, w5 = (latents or LATENT)["mdm512"]
                try:
                    unet(torch.randn(b, frames, h5, w5, cfg.in_channels, generator=gen,
                                     device=dev), t, ctx, c_label=lab)
                except ValueError as e:
                    if "reference repeat semantics" not in str(e):
                        raise
                else:
                    raise AssertionError("the cross-context UNet ran at the MDM512 latent")
            with no_tf32(torch):
                ref = unet(x, t, ctx, c_label=lab, impl="plain")
            unet.to(torch.bfloat16)
            K.prepare_kernels(unet)
            xb, cb = x.bfloat16(), ctx.bfloat16()
            t0 = time.perf_counter()
            plain = unet(xb, t, cb, c_label=lab, impl="plain")
            sync(torch, dev)
            ms_plain = 1e3 * (time.perf_counter() - t0)
            K.reset_launch_counts()
            kern = unet(xb, t, cb, c_label=lab)
            counts = K.launch_counts()
            ms_k = (cuda_ms(torch, lambda: unet(xb, t, cb, c_label=lab), iters=3, warmup=0)
                    if dev == "cuda" else None)
        e_p = rel_l2(torch, [(plain, ref)])
        e_k = rel_l2(torch, [(kern, ref)])
        bound_ = 1.5 * e_p + 5e-3
        log(f"  {name} (batch {b}, {h}x{w}): rel L2 vs fp32 kernels {e_k:.4e} (bound "
            f"{bound_:.4e}), plain bf16 {e_p:.4e}; forward bf16 kernels "
            f"{'-' if ms_k is None else f'{ms_k:.1f}'} ms, plain {ms_plain:.1f} ms ({card}); "
            f"launches {counts}")
        if not bool(torch.isfinite(kern).all()) or e_k > bound_:
            raise AssertionError(f"{name}: kernel-path error {e_k:.4e} exceeds {bound_:.4e}")
        check_launches(f"options {name}", counts, {**dict.fromkeys(counts, 0),
                                                   **OPTION_SITES[name]})
        launches[f"options_{name}"] = counts
        report[name] = {"batch": b, "latent": [h, w], "rel_l2_kernels": e_k,
                        "rel_l2_plain_bf16": e_p, "ms_kernels": ms_k, "ms_plain": ms_plain}
        del unet, ref, plain, kern, x, ctx, xb, cb
        if dev == "cuda":
            torch.cuda.empty_cache()
    return launches, report


def phase_etl(torch, K, U, card, dev="cuda", small=None):
    """Phase 19 in the checkout's _phase19 (deleted after): (a) preprocess
    on `dev` and on the CPU from a seeded tfrecord of ETL_FRAMES frames at
    Waymo's sensor sizes (`waymo_segment`), compared by compare_etl_outputs;
    (b) build_clouds with all five cameras on `dev` and on the CPU from the
    card's processed scene, compared by compare_clouds; (c) voxel_downsample
    alone on a seeded 198-frame background (`voxel_cloud`, about 20M
    points, voxel 0.1) on `dev` and on the CPU, equal rows; (d)
    phase_option_forwards; (e) run_samplers at the MDM512 latent on `dev`
    and on the CPU, within SAMPLER_REL. Each app's seconds split into its
    stages. `small` (dict: frames, cams, top, short, boxes, voxel, unet,
    latents, frames_unet, shape) lets the CPU tests rehearse it. Returns
    (launches, report)."""
    import functools
    import shutil

    import numpy as np

    from mudg_tpu_torch.apps import build_clouds as BC
    from mudg_tpu_torch.apps import preprocess as PP
    from mudg_tpu_torch.data import waymo_etl as ETL
    from mudg_tpu_torch.utils import native as NT

    small = small or {}
    t_start = time.perf_counter()
    root = os.path.join(ROOT, "_phase19")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "records"))
    cams = small.get("cams", WAYMO_CAMS)
    report = {"card": card, "frames": small.get("frames", ETL_FRAMES)}
    try:
        t0 = time.perf_counter()
        sizes = waymo_segment(os.path.join(root, "records", "seg.tfrecord"),
                              report["frames"], cams=cams, top=small.get("top", TOP_HW),
                              short=small.get("short", SHORT_HW),
                              boxes=small.get("boxes", ETL_BOXES))
        report["records_mb"] = sum(sizes) / 2**20
        report["records_s"] = time.perf_counter() - t0
        # (a) preprocess, through its app, on the card and on the CPU
        runs = (("card", dev), ("cpu", "cpu"))
        split = {}
        for label, where in runs:
            tm = split[label] = {}
            t0 = time.perf_counter()
            with patched(ETL, "process_sequence",
                         functools.partial(ETL.process_sequence, timings=tm)):
                if PP.main(["--root", os.path.join(root, "records"), "--out_root",
                            os.path.join(root, f"out_{label}"), "-j", "1",
                            "--device", where]) != 0:
                    raise AssertionError(f"preprocess on {where} failed")
            tm["total"] = time.perf_counter() - t0
        n_files, ulps = compare_etl_outputs(os.path.join(root, "out_card", "seg"),
                                            os.path.join(root, "out_cpu", "seg"))
        report["preprocess"] = {"s": split, "files": n_files, "npz_ulps": ulps}
        log(f"  (a) preprocess, {report['frames']} frames ({report['records_mb']:.1f} MB of "
            f"records): {dev} {split['card']['total']:.2f} s ({_fmt_split(split['card'])}), "
            f"CPU {split['cpu']['total']:.2f} s ({_fmt_split(split['cpu'])}); {n_files} files "
            f"equal, npz within {ulps:.0f} fp32 ulp ({card})")
        # (b) build_clouds on the card's processed scene, card then CPU
        scene = os.path.join(root, "out_card", "seg")
        cam_names = tuple("camera_" + c[1] for c in cams)
        clouds, bsplit = {}, {}
        for label, where in runs:
            tm = bsplit[label] = {}
            t0 = time.perf_counter()
            with patched(BC, "build_scene_clouds",
                         functools.partial(BC.build_scene_clouds, timings=tm)):
                BC.main(["--scene", scene, "--cameras", *cam_names, "--device", where])
            tm["total"] = time.perf_counter() - t0
            clouds[label] = cloud_outputs(scene)
            for d in ("objects", "lidar_clouds"):
                shutil.rmtree(os.path.join(scene, d))
            os.remove(os.path.join(scene, "objects_info.pkl"))
        allowed = 0
        if sorted(clouds["card"]) != sorted(clouds["cpu"]) or any(
                not np.array_equal(_sorted_rows(a), _sorted_rows(clouds["cpu"][k]))
                for k, a in clouds["card"].items()):
            allowed = 2 * tie_and_face_points(torch, scene, cam_names)
        n_clouds, n_points, n_diff = compare_clouds(clouds["card"], clouds["cpu"], allowed)
        report["build_clouds"] = {
            "s": bsplit, "clouds": n_clouds, "points": n_points, "rows_differing": n_diff,
            "allowed": allowed, "background_points": len(clouds["card"]["objects/background.ply"]),
            "moving_objects": sum(k.startswith("object ") for k in clouds["card"])}
        log(f"  (b) build_clouds ({len(cams)} cameras): {dev} {bsplit['card']['total']:.2f} s "
            f"({_fmt_split(bsplit['card'])}), CPU {bsplit['cpu']['total']:.2f} s "
            f"({_fmt_split(bsplit['cpu'])}); {n_clouds} clouds, {n_points:,} rows, {n_diff} "
            f"differing ({allowed} allowed by ties and faces); background "
            f"{report['build_clouds']['background_points']:,} points, "
            f"{report['build_clouds']['moving_objects']} moving objects ({card})")
        # (c) voxel downsampling alone at a segment's size
        vf, vp = small.get("voxel", (VOXEL_FRAMES, VOXEL_PER_FRAME))
        xyz, rgb = voxel_cloud(torch, SEED + 19, vf, vp)
        xd, rd = xyz.to(dev), rgb.to(dev)
        ms = (cuda_ms(torch, lambda: NT.voxel_downsample(xd, rd, VOXEL_SIZE), iters=3, warmup=1)
              if dev == "cuda" else None)
        a_xyz, a_rgb = NT.voxel_downsample(xd, rd, VOXEL_SIZE)
        del xd, rd
        t0 = time.perf_counter()
        c_xyz, c_rgb = NT.voxel_downsample(xyz, rgb, VOXEL_SIZE)
        cpu_s = time.perf_counter() - t0
        if not (torch.equal(a_xyz.cpu(), c_xyz) and torch.equal(a_rgb.cpu(), c_rgb)):
            raise AssertionError("voxel_downsample: the card's rows differ from the CPU's")
        report["voxel"] = {"points": len(xyz), "voxels": len(c_xyz), "ms": ms, "cpu_s": cpu_s}
        log(f"  (c) voxel_downsample of {len(xyz):,} points at {VOXEL_SIZE} m: {len(c_xyz):,} "
            f"voxels, equal rows; {'-' if ms is None else f'{ms:.1f}'} ms on {dev}, "
            f"{cpu_s:.2f} s on the CPU ({card})")
        del xyz, rgb, a_xyz, a_rgb, c_xyz, c_rgb
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # (d) the option UNets
    launches, report["options"] = phase_option_forwards(
        torch, K, U, card, dev, small.get("unet"), small.get("latents"),
        small.get("frames_unet", 16))
    # (e) the samplers, the card against the CPU
    h, w = LATENT["mdm512"]
    shape = small.get("shape", (2, 16, h, w, 4))
    got, secs = run_samplers(torch, dev, shape)
    ref, secs_cpu = run_samplers(torch, "cpu", shape)
    errs = {k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
            for k in ref}
    bad = {k: e for k, e in errs.items() if not (e <= SAMPLER_REL) or
           not bool(torch.isfinite(got[k]).all())}
    report["samplers"] = {"shape": list(shape), "rel_err": errs, "s": secs, "s_cpu": secs_cpu}
    log(f"  (e) samplers at {tuple(shape)}: max relative difference card vs CPU "
        f"{max(errs.values()):.2e} (bound {SAMPLER_REL}); s on {dev} "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) + "; on the CPU "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs_cpu.items()))
    if bad:
        raise AssertionError(f"samplers: the card differs from the CPU beyond {SAMPLER_REL}: {bad}")
    report["seconds"] = time.perf_counter() - t_start
    return launches, report


def _fmt_split(tm):
    return ", ".join(f"{k} {v:.2f}" for k, v in tm.items() if k != "total")



def kernel_line(kernels, rows, launches):
    """The kernel table printed as one JSON line: per kernel its route, source,
    the TPU kernel it replaces, its launches on the main paths (`launches`:
    path -> counts) and phase 2/9/11's numbers (`rows`: name -> row of
    run_cases). YARDSTICKS are library calls for part of a kernel's work,
    timed alone and queued (null for the other kernels); "ms_queued" the
    forward kernels' time with their calls queued back to back
    (cuda_ms_queued), "library_ms_queued" the library call's, queued the
    same way."""
    line = {"kernels": []}
    for name in kernels:
        r = rows.get(name, {})
        line["kernels"].append({
            "name": name, "route": "cuda", "source": KERNEL_ROWS[name][0],
            "replaces": KERNEL_ROWS[name][1],
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            **{k: r.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "ms_queued", "library_ms", "library_ms_queued",
                                     *YARDSTICKS, *(y + "_queued" for y in YARDSTICKS))},
            "shapes": r.get("shapes", [])})
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19")
    ap.add_argument("--out", default=None, help="directory for a JSON report")
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3 and 5, profile one UNet forward per path; in "
                         "phase 2, the device time of kernels 1-4 and 9 and of kernel 11's "
                         "part in them; in phase 7, one training micro-step; in phase 9, "
                         "kernel 13 at (b)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    # no autograd graph outside the training phases' own enable_grad blocks
    torch.set_grad_enabled(False)
    sys.path.insert(0, ROOT)
    try:
        import mudg_tpu_torch.kernels as K
        from mudg_tpu_torch.kernels import _build
        from mudg_tpu_torch.models import mdm as mdm_mod
        from mudg_tpu_torch.models import presets
        from mudg_tpu_torch.nn import attention as nn_att
        from mudg_tpu_torch.nn import unet3d as U
        from mudg_tpu_torch.train import step as step_mod
        from mudg_tpu_torch.apps import refine_gs as gs_app
        from mudg_tpu_torch.apps import render_infer as ri_app
        from mudg_tpu_torch.apps import serve as serve_app
        from mudg_tpu_torch.train import checkpoint as ckpt_mod
        from mudg_tpu_torch.gs import gaussians as gs_g
        from mudg_tpu_torch.gs import io as gs_io
        from mudg_tpu_torch.gs import tile_raster as gs_tr
        from mudg_tpu_torch.gs import train as gs_train
        from mudg_tpu_torch.kernels import tile_raster as gs_k
        from mudg_tpu_torch.kernels import norms as norm_k
        from mudg_tpu_torch.kernels import short_attention as short_k
        from mudg_tpu_torch import quant as quant_mod
        from mudg_tpu_torch.apps import quantize_ckpt as qa_app
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 2

    report = {}
    t_all = time.perf_counter()
    multi = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if multi:   # torchrun: one card per rank, local rank 0 builds the kernels
        from mudg_tpu_torch.parallel import mesh as par_mesh

        par_mesh.init_distributed("cuda")
    for v in SWITCH_VARS + OPT_OUT:   # set only inside phases 12 and 13
        os.environ.pop(v, None)

    def timed(n, title, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        log(f"phase {n} ({title}): {time.perf_counter() - t0:.1f} s")
        return r

    card = timed(1, "device, build", phase_build, torch, _build)
    rows = {}
    if 2 in phases:
        rows = timed(2, "kernels vs plain", phase_kernels, torch, K, nn_att,
                     ("mdm512", "mdm1024"), args.profile)
    launches = {}
    sw = 12 in phases   # phase 12 runs the switch path inside phases 3, 5, 6 and 7's set-up
    off = 13 in phases   # phase 13 runs inside phases 3 and 5's set-up

    def paths(n):
        return ((("kernels",) if n in phases else ()) + (("switches",) if sw else ())
                + (("off",) if off and n in (3, 5) else ()))

    if 11 in phases:
        rows11, launches["packed_temporal"], report["kernel11_plans"] = timed(
            11, "kernels 11 and 12 vs plain", phase_norm_short, torch, K, norm_k, short_k,
            args.profile)
        rows.update(rows11)
    unet = None
    tag = (" + 12a" if sw else "") + (" + 13" if off else "")

    if 3 in phases or sw or off:
        unet, report["unet_mdm512"], launches_off = timed(
            "3" + tag, "MDM512 UNet forward", phase_unet, torch, K, U, "mdm512", paths(3))
        if launches_off is not None:
            launches["mdm512_switches_off"] = launches_off
        if sw:
            launches["mdm512_f32_forward"] = report["unet_mdm512"]["launches_switches_f32"]
        if args.profile and 3 in phases:
            report["profile_mdm512"] = phase_profile(torch, unet, "mdm512", args.out)
    if 4 in phases:
        launches["mdm512_clip"], report["clip_mdm512"] = timed(
            4, "MDM512 25-step clip + decode", phase_clip, torch, K, U, mdm_mod, unet)
    del unet
    torch.cuda.empty_cache()
    unet = None
    if 5 in phases or sw or off:
        unet, report["unet_mdm1024"], launches_off = timed(
            "5" + tag, "MDM1024 UNet forward", phase_unet, torch, K, U, "mdm1024", paths(5))
        if launches_off is not None:
            launches["mdm1024_switches_off"] = launches_off
        if sw:
            launches["mdm1024_f32_forward"] = report["unet_mdm1024"]["launches_switches_f32"]
        if args.profile and 5 in phases:
            report["profile_mdm1024"] = phase_profile(torch, unet, "mdm1024", args.out)
    if 6 in phases or sw:
        clips, report["sample_mdm1024"] = timed(
            "6" + (" + 12b" if sw else ""), "MDM1024 sample", phase_sample, torch, K, U,
            mdm_mod, presets, unet, paths(6))
        for path, name in (("kernels", "mdm1024_sample"), ("switches", "mdm1024_sample_switches")):
            if path in clips:
                launches[name] = clips[path]
    del unet
    torch.cuda.empty_cache()
    mdm = None
    if 7 in phases or sw:
        mdm, trained, report["train_mdm512"] = timed(
            "7" + (" + 12c" if sw else ""), "MDM512 training", phase_train, torch, K, mdm_mod,
            step_mod, args.profile, args.out, paths(7), 7 in phases)
        if "steps" in trained:
            launches["mdm512_train"] = trained["steps"]
        if "switches" in trained:
            launches["mdm512_micro_step_switches"] = trained["switches"]
    if 8 in phases:
        launches["mdm1024_train"], report["train_mdm1024"] = timed(
            8, "MDM1024 stage-2 step", phase_train_stage2, torch, K, mdm_mod, step_mod, mdm)
    del mdm
    torch.cuda.empty_cache()
    if 16 in phases:
        phase16, report["parallel"] = timed(16, "multi-GPU paths", phase_parallel, torch, K,
                                            mdm_mod, step_mod)
        launches.update(phase16)
        torch.cuda.empty_cache()
    if 15 in phases:
        phase15, report["train_app"] = timed(15, "training app", phase_train_app, torch, K,
                                             mdm_mod, card)
        launches.update(phase15)
    if 14 in phases:
        launches["mdm512_serve"], rows14, report["serve"] = timed(
            14, "serving path", phase_serve, torch, K, U, nn_att, serve_app, ri_app, ckpt_mod,
            card)
        report["serve"]["kernels_batch6"] = rows14
    if 17 in phases:
        t17 = time.perf_counter()
        report["quant_forwards"] = phase_quant_forwards(torch, K, quant_mod, ri_app, U, card)
        report["int_mm_yardstick"] = int_mm_yardstick(torch, quant_mod, card)
        torch.cuda.empty_cache()
        served, report["quant_serve"] = phase_quant_serve(torch, K, mdm_mod, ri_app, serve_app,
                                                          qa_app, card)
        launches.update(served)
        report["conditions"] = phase_conditions(torch, card)
        log(f"phase 17 (int8 serving, conditions): {time.perf_counter() - t17:.1f} s")
    if 18 in phases:
        torch.cuda.empty_cache()
        phase18, rows18, report["offline"] = timed(18, "segment, densify, eval", phase_offline,
                                                   torch, K, nn_att, card)
        launches.update(phase18)
        for name, r in rows18.items():   # DepthLab's kernel-5 shapes join phase 2's row
            if name in rows:
                rows[name]["shapes"] += r["shapes"]
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], r["max_abs_err"])
            else:
                rows[name] = r
    if 19 in phases:
        torch.cuda.empty_cache()
        phase19, report["etl_options"] = timed(19, "host ETL, UNet and sampler options",
                                               phase_etl, torch, K, U, card)
        launches.update(phase19)
    if 9 in phases:
        rows.update(timed(9, "kernel 13 vs plain", phase_gs_kernels, torch, gs_k, gs_g, gs_tr,
                          args.profile, args.out))
    if 10 in phases:
        launches["gs_refine"], report["gs_refine"] = timed(
            10, "3DGS refinement", phase_gs_refine, torch, K, gs_g, gs_train, gs_tr, gs_app,
            gs_io)
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    for mod in list(sys.modules):
        if mod.split(".")[0] in ("jax", "jaxlib", "mudg_tpu"):
            raise AssertionError(f"{mod} was imported")

    if multi:
        import torch.distributed as dist

        dist.destroy_process_group()
        if int(os.environ.get("RANK", "0")) > 0:
            return 0
    table = kernel_line(K.KERNELS, rows, launches)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "table": table, **report}, f, indent=1)
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
