"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero
without the final `ok` line):
  1. device      - require CUDA; print nvidia-smi's name and power limit.
  2. build       - compile gcd_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
                   process per source; the ptxas report (registers, spills,
                   stack, and any note that it serialised a kernel's wgmma
                   products) of the wgmma kernels K1, K3, K6 and K7, of K2's
                   narrow, resident and streamed mma.sync kernels and of
                   K4's and K5's channels-last kernels.
  3. conditioner - load_engine(configs/infer_kubric.yaml): random bf16
                   weights (std 0.02 on every leaf, seeded), ViT-H/14 tower;
                   one conditioner pass on a random 14-frame 384x256 batch;
                   checks the shapes of c and uc.
  4. kernels     - records every GroupNorm shape of that conditioner pass,
                   one CFG-doubled UNet evaluation and one 14-frame decode,
                   and every K7 site of the UNet evaluation (forward hooks),
                   then holds each CUDA kernel against its plain PyTorch
                   version at every main-path shape, bf16, relative
                   L2 <= 1e-2 (each output): K1 flash attention, K6 its
                   backward, K2 temporal attention, K3 fused GEGLU MLP, K4
                   GroupNorm, K5 group statistics, K7 GroupNorm -> SiLU ->
                   3x3 conv (its 14 UNet shapes at N = 28, and at N = 56,
                   the served batch; K1, K2 and K3 likewise at B*T = 28
                   and 56, K1 also at D = 128 and K2 also at D = 16, 80
                   and 128 at ds2's width, and with two row tiles at T = 25
                   and 32 (one clip with CFG, B*T = 50 / 64) at the four
                   levels' widths, plus a ragged S at ds1 and D = 16 at
                   ds2, T = 25; K2's general family at T = 33, 64 and 100
                   (one clip with CFG) at the four levels' widths, a ragged
                   S at ds1, T = 64, the `num_heads: 8` UNet's D = 40 at
                   ds1 and 160 at ds4 (T = 14), the VAE's one-head D =
                   512 at (2 T, 1536) for T = 25 and 32, and at ds1 the
                   resident kernel's largest T, 128, and one head of 1024
                   at T = 33 (streamed); each general case labelled
                   `resident` or `streamed`; K4 / K5 also at the served
                   batch's GroupNorm sites, the conditioner's and the
                   UNet's N doubled); K4 / K5
                   also on channels-first copies of those shapes; K1, K2,
                   K3, K7 and K4 / K5 also at the shapes and GroupNorm
                   sites of a B*T = 14 UNet evaluation (a plain step of
                   guidance_interval: every channels-last K4 site there
                   must take the split route); every
                   kernel bit-identical on a second call (none uses
                   atomics). CUDA-event and
                   host enqueue times beside the bound (achieved TFLOP/s and
                   share of the bound) and the one-call library equivalent
                   (K5's: torch.var_mean over the grouped view); K1's, K2's,
                   K3's, K4's, K5's, K6's and K7's cases, and their library
                   calls, also by torch.profiler device time; each K4 / K5
                   case names the K4 variant its site takes (one pass or
                   split: K5, then the apply pass).
  5. ab          - the flagship UNet evaluation, the decode and the
                   conditioner with every kernel on vs off (relative
                   L2 <= 2e-2); one flagship UNet evaluation of a T = 25
                   clip with CFG (B*T = 50), and one of a T = 64 clip (B*T
                   = 128, K2's general family), each with K2 on vs K2
                   plain (2e-2, K2's launches one a temporal block, none
                   when plain, each one's device ms and device ms by
                   kernel); the UNet's and the decode's wall
                   times and torch.profiler device time by kernel, with
                   the GroupNorm kernels on vs off and with K7 on vs off.
  6. slice       - two requests through DiffusionEngine.sample_video:
                   random 14-frame 384x256 clips and camera moves, 25
                   Euler-EDM steps with per-frame CFG up to 1.5, one 14-frame
                   decode; checks the frames and each kernel's launch count
                   (K5's from phase 4's GroupNorm sites by uses_split_path:
                   `split_calls`);
                   then the first request timed with K7 on and off,
                   frames within 2e-2.
  served         - the same engine behind SamplerServer(max_batch=2) and the
                   HTTP handler of gcd_tpu_torch.serve on 127.0.0.1: four
                   concurrent POST /sample requests built with
                   construct_batch from random clips and four camera moves
                   answered in two batches of two clips (B*T = 56 in the
                   UNet), GET /healthz, then request 0 again alone (a padded
                   batch) with its seed, within 2e-2 of its batched frames;
                   checks the frames and the launch counts of the two
                   batches (from phase 4's site counts); wall time per
                   batch, served frames/s, peak memory; then one batch timed
                   with K7 on and off, frames within 2e-2.
  samplers       - the sgm sampling family on the same engine, the sampler
                   (and denoiser) swapped in memory: (a) EDMSampler with
                   churn on part of the ladder, Heun, Euler-ancestral,
                   DPM++ 2S, DPM++ 2M and LMS (order 4) at 25 steps with
                   the config's guider; (b) IdentityGuider, VanillaCFG and
                   DiscreteDenoiser over the DDPM ladder with each of the
                   EDM, eps, v and dumb scalings, 3 steps. Each clip: frames
                   finite in [0, 1], its UNet evaluations (a forward hook)
                   those of the sampler's host plan (25, or 49 for Heun and
                   DPM++ 2S; 28 rows each, 14 under IdentityGuider), each
                   kernel's launches the conditioner's and decode's plus
                   phase 4's per-evaluation counts at those rows, the same
                   seed twice bit-identical (DPM++ 2S: once; its artifact
                   runs it again); wall s (both runs), profiled
                   device ms of the IdentityGuider and VanillaCFG repeats. DPM++ 2S ancestral is also exported
                   at full width (the conditioner, its guided evaluation
                   and the decode) and run through load_sampler on the
                   same batch and generator seed (the latent noise, then
                   the per-step noise): frames finite in [0, 1] within 2e-2
                   of the eager clip's (bit-identical or not, logged), each
                   kernel's launches the eager clip's; export, load and
                   clip seconds beside the eager clip's, the artifact's MB.
                   (c) one batch of two requests through SamplerServer with
                   Euler-ancestral (56 rows), launches counted. (d)
                   validation_metrics with seeded random LPIPS weights:
                   val/psnr, val/ssim, val/lpips finite, LPIPS(x, x) = 0,
                   the card's LPIPS on two frames within 1e-4 of the CPU's
                   (fp32, TF32 off in both networks), ms of the clip's 28
                   VGG passes. (e) InceptionV3 (seeded random weights) on
                   the clip's 14 frames resized to 299: (14, 2048), within
                   1e-4 of the CPU's on two frames, ms.
  first_stage    - the first-stage family, after the samplers phase: the
                   flagship engine with its VideoDecoder in time_mode "all"
                   (built in memory from configs/infer_kubric.yaml; a
                   VideoAttnBlock at mid_attn_1) through sample_video, one
                   random 14-frame 384x256 clip decoded at decoding_t 14:
                   frames finite in [0, 1], each kernel's launches phase 6's
                   model plus two K2 and two K3 a VideoAttnBlock, every
                   kernel but K6 launched; the clip's latents decoded with
                   every kernel on vs off (2e-2), and by the conv-only
                   decoder on the same weights, timed in turns and by device
                   time. K2 at the decoder's (14, 1536, 512), one head, and
                   at D = 256 (14, 24576, 256), beside the UNet's four
                   levels at B*T = 28, and K3 at M = 21504, C = 512, I =
                   2048, against their plain versions (1e-2), bit-identical
                   on a second call, with CUDA-event, device, plain,
                   library (SDPA for K2) and bound times. SD v1's kl-f8
                   AutoencoderKL (CompVis v1-inference.yaml) round-tripping
                   the clip (posterior noise from a generator), on vs off
                   (2e-2). One generator step (adaptive weight from the
                   gradients at the decoder's conv_out) and one
                   discriminator step of GeneralLPIPSWithDiscriminator (ndf
                   64, 3 layers, seeded random LPIPS weights) on 4 frames
                   through the kl-f8 decoder, forward and backward: finite
                   losses and gradients, the running statistics moved. The
                   four quantizers at vqgan_imagenet_f16_16384 widths
                   (16384 codes of 256) on the clip's f16 latents, forward
                   and backward in training mode: finite, indices in range,
                   the VectorQuantizer's first 512 indices equal to the
                   CPU's, the EMA codebook moved. The phase's seconds.
  conditioning   - the text towers and the other embedders, after the
                   first-stage phase: (a) each text embedder at its
                   published width with seeded random bf16 weights on 28
                   rows x 77 tokens: CLIP ViT-L/14 (FrozenCLIPEmbedder, 768
                   x 12, QuickGELU), OpenCLIP ViT-H-14
                   (FrozenOpenCLIPEmbedder, 1024 x 24, penultimate),
                   ViT-bigG-14 (FrozenOpenCLIPEmbedder2, 1280 x 32,
                   legacy false, pooled too), T5 v1.1 XXL (FrozenT5Embedder,
                   4096 / 10240 / 24 layers / 64 heads) and ByT5-base
                   (FrozenByT5Embedder) from strings: shapes, finite, ms,
                   peak memory, and relative L2 against the same weights in
                   fp32 on the card within TEXT_TOL. (b) GaussianEncoder and
                   LowScaleEncoder on the conditioner's kl-f8 encoder, a
                   14-frame 256 x 384 clip: each K4 / K5 launch against the
                   model. (c) configs/infer_kubric.yaml built in code with
                   (a)'s ViT-H-14 text embedder in place of the CLIP image
                   embedder (crossattn (28, 77, 1024)): one request through
                   sample_video, 25 Euler-EDM steps with CFG: frames finite
                   in [0, 1], each kernel's launches phase 6's per clip (the
                   77-key cross-attention launches none), frames with every
                   kernel on vs off within 2e-2, its seconds beside phase
                   6's; then the same request with the `num_heads: 8` UNet
                   in the flagship's place, 25 steps: frames finite in [0,
                   1], launches the text clip's but no K1. (d) three
                   VideoUNets at svd_gcd's widths on B*T = 28, 32 x 48
                   latents and (a)'s context: A (scale-shift
                   norm, resblock up / down, conv projections, no per-frame
                   temporal context, fixed blends, a 3 x 3 x 3 time kernel),
                   B (no temporal cross-attention, resampling without
                   convs, ff_in) and heads8 (`num_heads: 8`: heads of 40,
                   80 and 160, K2's general family at 40 and 160, no K1
                   launch), and svd_gcd's ds1 SpatialVideoTransformer
                   without self-attention (a block option the VideoUNet
                   does not pass on): one evaluation each,
                   kernels on vs off within 2e-2, launches against the
                   model of its modules (unet_launch_model), device ms by
                   kernel; every K1 / K2 / K3 / K4 / K5 / K7 case at a shape
                   or flag phase 4 does not hold against its plain version
                   (1e-2), bit-identical on a second call. The phase's
                   seconds.
  export         - the exported sampler (engine/export.py): each gcd:: op's
                   fake implementation against its kernel on the card
                   (opcheck's fake-tensor test, K4 / K5 on channels-last
                   and channels_last_3d); export_sampler on a fresh engine
                   (phase 6's seeded weights) and phase 6's first request,
                   to bytes and back through load_sampler; the artifact on
                   that request with its generator's noise: frames finite
                   in [0, 1] within 2e-2 of phase 6's (bit-identical or
                   not, logged), each kernel's launches a clip phase 6's;
                   export and load seconds, the artifact's MB, clip wall
                   seconds beside phase 6's, one step program's device ms
                   and wall s beside the eager step's. Then the served
                   artifact: the same engine exported for the served batch
                   (two of the served requests' arrays) to a file, booted
                   as gcd_tpu_torch.serve --artifact boots it (serve.py
                   load_artifact) behind the HTTP handler, the served
                   phase's four requests with their seeds: frames within
                   2e-2 of the eager server's (bit-identical or not,
                   logged), each kernel's launches the eager server's;
                   served frames/s beside the eager server's, export and
                   load seconds.
  7. train       - load_trainer(configs/train_kubric_max90.yaml): random
                   bf16 weights, fp32 masters and Adam; a seeded batch of 2
                   clips of 14 frames at 384x256 (B*T = 28). One step's loss
                   and UNet gradient with every kernel on vs off (kernel
                   launches 0 when off: the rematerialised blocks' recompute
                   on the autograd thread takes the caller's switches), and
                   timed with K7 on vs off; then
                   five Adam steps, each with a finite loss, a finite
                   gradient on every trainable parameter (zero only where the
                   graph does not reach, or at a blend factor where that
                   step's fp32 sums show bf16 rounding made the zero:
                   BlendWitness), updated masters and weights, the
                   frozen VAE and CLIP bit-identical, and each kernel's
                   launches equal to the step's site count (forward, remat
                   recompute, backward); ms per step, frames/s, peak memory
                   and a torch.profiler breakdown of one step.
  8. entry       - the training entry (gcd_tpu_torch.train) fed by the
                   Kubric-4D pipeline, after phase 7's trainer is freed: a
                   synthetic root in a temporary directory (1 scene, 16
                   frames, 16 views x 576 x 384 points a frame, the
                   converter's size) on a disk checked to hold two
                   checkpoints; the host splat's ms a 420x280 render and
                   the seconds of one example; then train.main on
                   configs/train_kubric_max90.yaml for 3 steps (checkpoint
                   and image log at step 3) and a --resume to step 4.
                   Checks every loss finite, the CSV's steps 1-5, step_3,
                   the resumed trainer's masters and optimizer state equal
                   to the saved ones bit for bit, the image log's frames
                   and PNG, and every step's launches equal to phase 7's;
                   prints the loader's wait against the step, entry
                   frames/s beside phase 7's, the checkpoint's size and
                   save / restore seconds and peak memory.
  eval           - the inference and evaluation entries, on phase 8's run
                   directory before it is removed (its trainer freed):
                   gcd_tpu_torch.test.main on configs/infer_kubric.yaml
                   with phase 8's checkpoints/step_3 (whose run config
                   names the synthetic root), scene 0, 2 generated
                   controls, 2 samples each, 14 frames at 384x256, 25
                   steps: both controls in the summary, PSNR, SSIM and
                   their visible / occluded variants finite, the first
                   example's reprojection covering a share of pixels
                   strictly between 0 and 1, per-frame arrays (2, 14), the
                   frames finite in [0, 1], each kernel's launches per
                   clip phase 6's; the split of an example (data render,
                   seconds a sample, metrics). Then
                   gcd_tpu_torch.infer.main on an .npz of 14 seeded random
                   frames and a PNG, 2 samples each, camera move (30, 15,
                   0): every output file, the frames, diversity_std > 0,
                   the launches. Then one random request of the flagship
                   with guidance_interval (0.3, 100): its launches from
                   phase 4's per-evaluation counts at B*T = 28 (guided
                   steps) and 14 (plain steps), its frames within 2e-2 of
                   the same request with every kernel off, and its time
                   against full CFG (wall time in turns, and device time).
                   The test entry's default galleries (rich1, rich2, rich3,
                   rich5, rich6: galleries.py) of both examples: each
                   layout's .npz of 17 canvases of its grid and its .png.
  9. pardom      - the ParallelDomain configs, after phase 8's run is freed:
                   a synthetic root in a temporary directory (1 scene of
                   the dataset's 50 frames, 19 views x 640 x 480 points a
                   frame, the converter's size; 640 x 480 ego PNGs whose
                   rows use all five filters; the loss's person and vehicle
                   colours in the ontology) on a disk checked to hold it and
                   a checkpoint; the host work alone (a frame file's load,
                   the f16 -> f32 casts, the class colours, a 420x280
                   render, the resize, a PNG decode, one example) and the
                   share of the first target's pixels in class colours
                   (must be > 0); load_trainer on the training config
                   (the same parameters and rate as the entry's); train.main on
                   configs/train_pardom_semantic.yaml for 3 steps and its
                   end-of-run checkpoint: every loss finite, the CSV's
                   steps 1-3, every step's launches equal to phase 7's, the
                   loader's wait against the step and entry frames/s beside
                   phase 7's; then load_engine(configs/infer_pardom.yaml)
                   (the base conditioner: a 768-wide vector, no camera
                   embedder) and one 25-step clip with CFG up to 1.5 from
                   the first example's ego frames: frames finite in [0, 1]
                   of shape (14, 256, 384, 3), each kernel's launches equal
                   to phase 6's per clip; load_model_bundle on
                   pretrained/pardom_gradual_semantic.yaml builds the same
                   weights. One depth frame written into the root (1-80 m)
                   and visualised: every colour a row of the plasma table,
                   nearer brighter, the processed frame in [-1, 1].
 10. options     - the training options, after phase 9 frees its run:
                   (a) load_trainer(configs/train_kubric_max90.yaml) with
                   ft_strategy time_lora, EMA, a LambdaLinearScheduler
                   warming up over 2 updates and 2 accumulated micro-steps;
                   the first micro-step's loss and adapter gradient with
                   every kernel on vs off (2e-2 / 5e-2, phase 7's bounds,
                   launches phase 7's when on, none when off); 4 micro-steps
                   on a B*T = 28 batch: the adapters move on micro-steps 2
                   and 4 only, the module adapters equal their masters, the
                   applied rate equals the schedule's formula, the base UNet
                   stays bit for bit, the EMA of three base tensors equals
                   the formula recomputed in plain torch bit for bit, each
                   micro-step's launches phase 7's; ms per micro-step beside
                   phase 7's step, one more micro-step's device time,
                   peak memory. (b) the everything strategy
                   for 2 steps without EMA, then with it: each EMA update's
                   CUDA-event ms, its device ms, the shadow's bytes, the
                   peak with and without it, two updates from one state
                   bit-identical.
                   (c) gcd_tpu_torch.train.main with (a)'s options on a
                   synthetic root of small clouds inside an NCCL group of
                   one (--coordinator 127.0.0.1:<free port>): 4 micro-steps,
                   checkpoints at 3 (mid-accumulation) and 4; a resume from
                   step 3 and the same run without a group both equal to it
                   bit for bit (losses and the whole trainer state); every
                   all-reduce's CUDA-event ms; then load_model_bundle
                   (configs/infer_kubric.yaml, support_ema) on step_4 with
                   0 missing keys samples one clip with the adapters merged,
                   its launches phase 6's per clip.
 11. mesh        - the fsdp and tensor axes (parallel/mesh.py, tensor.py):
                   (a) load_trainer on the flagship in an NCCL group of one,
                   its UNet placed as on 4 cards (fully_shard over a
                   one-card mesh: fp32 sharded masters, bf16 gathers); 3
                   steps on phase 7's batch and generator: each loss within
                   2e-2 of phase 7's step, the first step's UNet gradient
                   within 5e-2 of phase 7's, every step's launches phase
                   7's; ms a step beside phase 7's, peak memory, and the
                   placement summaries (computed, not run) at fsdp 4,
                   fsdp 2 x tensor 2, tensor 2 and tensor 4 with the state
                   bytes a card holds. (b) K1 forward, K6 and K2 with
                   heads / TP heads at every level whose heads divide by
                   TP, and K3 with inner / TP columns at every level, for
                   TP = 2 and 4, at B*T = 28's token counts: within 1e-2
                   of their plain versions, bit-identical on a second call.
                   (c) with 4 cards or more: the entry in four processes
                   (NCCL) at fsdp 4 against four data-parallel processes
                   (the batch of 4 clips one card cannot hold), and at
                   fsdp 2 x tensor 2 against one process, on a synthetic
                   root of small clouds: losses within 2e-2, peak memory
                   per card, NCCL's device ms in a profiled step; on one
                   card it prints that it did not run.
 12. sharded     - sharded sampling (engine/serving.py, parallel/frames.py):
                   (a) make_sharded_sampler in an NCCL group of one on
                   phase 6's first request (its batch and its generator's
                   noise): frames bit-identical to phase 6's, each kernel's
                   launches phase 6's per clip, the clip's wall s beside
                   phase 6's; then the mesh server (engine/server.py's
                   SamplerServer over the sharded sampler, the batches
                   broadcast) in that group behind the HTTP handler, on the
                   served phase's requests and seeds: frames bit-identical
                   to the served phase's, launches equal; and every
                   rank-local shape of the served meshes (one card, data 2,
                   data 2 x fsdp 2, fsdp 2 x tensor 2: UNet rows,
                   conditioner frames, decode chunks) among the shapes
                   phase 4 and the (b) phases hold. (b) the kernels at the shapes a rank of a
                   4-rank mesh sees at one clip (V = 2 video blocks x F = 2
                   frame blocks; the 2-rank mesh's B*T = 14 is phase 4's
                   plain step): K1, K3, K7 and the per-frame K4 / K5 sites
                   at 7 rows, K2 on 14 frames at 768 / 192 / 48 / 12
                   positions, within 1e-2 of their plain versions and
                   bit-identical on a second call; each time_stack
                   GroupNorm site cut into F position blocks, their K5 sums
                   added against K5 on the whole (within 1e-5 of the sums of
                   |x| and x^2) and each block normalised with them (K4's
                   split-path apply) within 1e-2 of the plain GroupNorm of
                   the whole; the two re-layouts, the all-to-all played by
                   hand on the card, equal to their models and bit-identical
                   on the round trip. (c) with 4 cards or more: the infer
                   entry on one .npz clip, 5 samples, in one process and at
                   --mesh_data 2, --mesh_data 2 --mesh_fsdp 2 and --mesh_fsdp
                   2 --mesh_tensor 2 (NCCL, one process a card): every
                   sample's frames within 2e-2 of one card's; clip wall s
                   (clips 2-3), UNet and NCCL device ms of one evaluation
                   and NCCL device ms of one clip on process 0 (profiled),
                   peak memory a card; then python -m gcd_tpu_torch.serve
                   in one process and in four at data 2 x fsdp 2 and
                   fsdp 2 x tensor 2 (the weights sharded over fsdp): the
                   served requests at once, each within 2e-2 of the one
                   process's, every process exiting 0 after SIGINT to
                   process 0; served frames/s, each batch's wall s, peak
                   memory a card, process 0's decode split against whole
                   and the NCCL device ms of a profiled batch; then option
                   UNet A (conditioning (d)) in four processes: its
                   evaluation under the sampler's frame groups (2 video
                   blocks x 2 frame blocks: the 3 x 3 x 3 time kernel's
                   convs take the neighbouring bands' edge rows) and cut
                   over a tensor axis of 4 (its 1 x 1 conv projections and scale-shift
                   embedding replicated, its attention cut by heads), each within
                   2e-2 of its whole evaluation on the same card
                   (option_cards); on one card it prints that they did not
                   run.
Then the kernel JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --mesh-cards

runs phase 2 and the mesh phase's and the sharded phase's (c) alone (a
machine of four cards); `--sampling-cards` runs phase 2 and the sharded
phase's (c) alone (the infer entry's runs, the served runs and option
UNet A's); `--option-cards` runs phase 2 and option UNet A's four-card
runs alone.
"""

from __future__ import annotations

import csv
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "infer_kubric.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "train_kubric_max90.yaml")
CLIPS = 2         # inference requests in phase 6
TRAIN_B = 2       # clips per training batch (configs/base/data_kubric.yaml batch_size)
TRAIN_STEPS = 5
T, H, W = 14, 256, 384
HL, WL = H // 8, W // 8
BT = 2 * T  # CFG-doubled
SEED = 0
G = 32
KERNEL_TOL = 1e-2  # relative L2, the bf16 kernel gate of bench.py:211
AB_TOL = 2e-2      # relative L2, whole module, kernels on vs off
TRAIN_LOSS_TOL = 2e-2  # relative, one training step's loss, kernels on vs off
TRAIN_GRAD_TOL = 5e-2  # relative L2, that step's UNet gradient, kernels on vs off
UC_KEYS = ("cond_frames", "cond_frames_without_noise")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core and
# fp32 FLOP/s. `bound_ms` is the larger of bytes / HBM and operations / peak.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# (tokens per frame, channels) at the UNet's four attention resolutions, and
# how many transformer blocks each has per evaluation: ds1/ds2/ds4 have 2 in
# the input path and 3 in the output path, the middle block 1.
# Substrings of each port kernel's device function names, for the profile.
PROFILE_TAGS = {"flash": ("flash_attention_kernel",),
                "flash_bwd": ("flash_bwd_rows_kernel", "flash_bwd_dkdv_kernel"),
                "tattn": ("temporal_attention_kernel", "temporal_attention_wide_kernel",
                          "temporal_attention_resident_kernel",
                          "temporal_attention_general_kernel"),
                "fused_mlp": ("geglu_up_kernel", "geglu_down_kernel"),
                "fused_gn_and_gn_stats": ("group_norm", "group_stats"),
                "fused_gn_conv": ("gn_silu_conv3x3_kernel", "splitk_sum_kernel")}
LEVELS = [("ds1", 1536, 320, 5), ("ds2", 384, 640, 5), ("ds4", 96, 1280, 5),
          ("mid", 24, 1280, 1)]
# Frame counts past one 16-row tile that K2 is held at (two row tiles):
# SVD-XT's 25 and the kernel's largest, 32; the first also drives one
# flagship UNet evaluation (phase 5).
TALL_FRAMES = (25, 32)
# Frame counts past 32 that K2's general family is held at (phase 4), the
# second also in one flagship UNet evaluation (phase 5); the most frames its
# resident kernel takes (phase 4, ds1), and the head size whose unit at 33
# frames only its streamed kernel takes (phase 4, one head at ds1's S).
GENERAL_FRAMES = (33, 64, 100)
LONG_FRAMES = 64
RESIDENT_FRAMES = 128
STREAMED_HEAD = 1024
SOURCES = {
    "flash": ("gcd_tpu_torch/csrc/flash_attention.cu",
              "gcd_tpu/ops/flash_attention.py:55"),
    "flash_bwd": ("gcd_tpu_torch/csrc/flash_attention_bwd.cu",
                  "gcd_tpu/ops/flash_attention.py:226"),
    "tattn": ("gcd_tpu_torch/csrc/temporal_attention.cu",
              "gcd_tpu/ops/temporal_attention.py:47"),
    "fused_mlp": ("gcd_tpu_torch/csrc/fused_mlp.cu",
                  "gcd_tpu/ops/fused_mlp.py:108"),
    "fused_gn": ("gcd_tpu_torch/csrc/fused_norm.cu",
                 "gcd_tpu/ops/fused_norm.py:34"),
    "gn_stats": ("gcd_tpu_torch/csrc/fused_norm.cu",
                 "gcd_tpu/ops/fused_norm.py:94"),
    "fused_gn_conv": ("gcd_tpu_torch/csrc/fused_gn_conv.cu",
                      "gcd_tpu/ops/fused_gn_conv.py:42"),
}
# Kernels whose phase-4 cases are also timed by device time (torch.profiler).
DEVICE_TIMED = ("flash", "flash_bwd", "tattn", "fused_mlp", "fused_gn", "gn_stats",
                "fused_gn_conv")
# Entry functions whose ptxas lines the build logs: the wgmma kernels (K1,
# K3, K6, K7), K2's narrow, resident and streamed mma.sync kernels and K4's
# and K5's channels-last kernels.
PTXAS_ENTRIES = ("flash_attention_kernel", "flash_bwd_rows_kernel", "flash_bwd_dkdv_kernel",
                 "geglu_up_kernel", "geglu_down_kernel", "gn_silu_conv3x3_kernel",
                 "temporal_attention_kernel", "temporal_attention_resident_kernel",
                 "temporal_attention_general_kernel",
                 "group_norm_cl_onepass_kernel",
                 "group_norm_cl_table_kernel", "group_stats_cl_kernel")
# Phase 8, the training entry on a synthetic Kubric-4D root: one scene of the
# fewest frames model_frames 14 samples from, 16 views of the converter's
# 576 x 384 points each (3,538,944 points a frame); 3 steps with a checkpoint
# and an image log at step 3, then a resume to step 4.
ENTRY_FRAMES, ENTRY_VIEWS, ENTRY_POINTS = 16, 16, 576 * 384
ENTRY_STEPS, ENTRY_RESUME_STEPS = 3, 4
ENTRY_DATASET_SIZE = 16
# Phase 9, the ParallelDomain configs: one scene of the dataset's 50 frames,
# 19 views of the converter's 640 x 480 points each (5,836,800 points a
# frame), 640 x 480 ego PNGs filtered with all five row filters, ids 1-14 in
# the loss's class colours, class ids by 3 m cell; 3 steps of
# train_pardom_semantic.yaml (one loader epoch), then one clip of
# infer_pardom.yaml.
PD_TRAIN_CONFIG = os.path.join(REPO, "configs", "train_pardom_semantic.yaml")
PD_INFER_CONFIG = os.path.join(REPO, "configs", "infer_pardom.yaml")
PD_BUNDLE_CONFIG = os.path.join(REPO, "pretrained", "pardom_gradual_semantic.yaml")
PD_FRAMES, PD_VIEWS, PD_POINTS, PD_FRAME_HW = 50, 19, 640 * 480, (480, 640)
PD_STEPS = 3
PD_DATASET_SIZE = PD_STEPS * TRAIN_B
PD_SEGM_CELL = 3.0
# The eval phase: the test entry on 2 generated controls of scene 0, 2
# samples each; the infer entry on an .npz clip and a PNG, 2 samples each,
# with a camera move of (azimuth, elevation, radius); a guidance_interval
# request, CFG only at sigma in [0.3, 100].
EVAL_CONTROLS, EVAL_SAMPLES = 2, 2
EVAL_MOVE = (30.0, 15.0, 0.0)
EVAL_INTERVAL = (0.3, 100.0)
# The options phase: time_lora, EMA, a LambdaLinearScheduler warming up over
# 2 updates and 2 accumulated micro-steps, on the flagship training config;
# 4 micro-steps through the trainer, 2 EMA steps of the everything strategy,
# then the entry in an NCCL group of one (checkpoint at micro-step 3, in the
# middle of an accumulation) on a synthetic root of small clouds.
OPTIONS_SCHEDULE = dict(warm_up_steps=[2], cycle_lengths=[10000], f_start=[0.1], f_max=[1.0],
                        f_min=[1.0])
OPTIONS_OVERRIDES = [
    "model.params.ft_strategy=time_lora", "model.params.use_ema=true",
    "model.params.scheduler_config={target: sgm.lr_scheduler.LambdaLinearScheduler, "
    "params: " + json.dumps(OPTIONS_SCHEDULE).replace('"', "") + "}",
    "lightning.trainer.accumulate_grad_batches=2"]
OPTIONS_STEPS, OPTIONS_ACCUMULATE, OPTIONS_CKPT_STEP = 4, 2, 3
OPTIONS_EMA_STEPS = 2
OPTIONS_VIEWS, OPTIONS_POINTS = 4, 20000
# The mesh phase: (a) the fsdp path in an NCCL group of one, its placement
# computed for MESH_RULE_FSDP cards, MESH_STEPS steps of phase 7's; (b) the
# kernels at the shapes a rank of MESH_TP tensor ranks sees; (c) with four
# cards or more, entry runs at fsdp 4 and fsdp 2 x tensor 2 (MESH_RUN_STEPS
# steps, the third profiled on process 0).
MESH_RULE_FSDP = 4
MESH_STEPS = 3
MESH_TP = (2, 4)
MESH_CARDS = 4
MESH_RUN_STEPS = 4
# The entry in a child process, its results on one JSON line.
MESH_CHILD = ("import json, sys, torch; from gcd_tpu_torch import train; "
              "out = train.main(sys.argv[1:]); "
              "print('MESH_RESULT ' + json.dumps({'losses': out['losses'], "
              "'step_seconds': out['step_seconds'], "
              "'peak_mem_bytes': torch.cuda.max_memory_allocated()}), flush=True)")
# The sharded-sampling phase: (a) make_sharded_sampler in an NCCL group of
# one on phase 6's first request; (b) the kernels at the shapes a rank of a
# SHARD_RANKS-rank mesh sees at one clip (V = 2 video blocks of SHARD_F
# frame blocks); (c) with four cards or more, the infer entry at each of
# SHARD_MESHES against one card, SHARD_SAMPLES clips a run: clip 1 warms,
# clips 2-3 are timed, clip 4 is profiled whole and the SHARD_EVAL-th UNet
# evaluation of clip 5 alone.
SHARD_RANKS, SHARD_F = 4, 2
SHARD_MESHES = {"data2": ["--mesh_data", "2"],
                "data2_fsdp2": ["--mesh_data", "2", "--mesh_fsdp", "2"],
                "fsdp2_tensor2": ["--mesh_fsdp", "2", "--mesh_tensor", "2"]}
SHARD_SAMPLES, SHARD_TIMED, SHARD_PROFILED_CLIP, SHARD_EVAL = 5, (1, 2), 4, 10
SHARD_CHILD = "import sys, chip_smoke; chip_smoke.sharded_entry_child(sys.argv[1:])"
SERVE_BATCH = 2   # clips per served batch
SERVE_REQUESTS = 4
SERVE_TOL = 2e-2  # relative L2, a request served alone vs in its batch
SERVE_STAGGER_S = 0.5  # between the served requests' POSTs: the same batches every run
# (azimuth, elevation, radius) of the served requests' camera moves.
SERVE_MOVES = [(30.0, 10.0, 0.0), (-20.0, 5.0, 0.0), (60.0, -10.0, 0.0), (0.0, 25.0, 0.0)]


_T0 = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line: the phase, the seconds since the script started, the
    fields."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - _T0, 1), **fields}),
          flush=True)


def rel_l2(a, b) -> float:
    """Relative L2 error; of a tuple of outputs, the largest."""
    if isinstance(a, tuple):
        return max(rel_l2(x, y) for x, y in zip(a, b))
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def max_abs(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, iters: int = 10):
    """(CUDA-event ms per call, host ms per call to enqueue it). Where the
    host takes longer than the device, the event time is the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host / iters


def wall_s(fn, reps: int = 3):
    """(last result, median seconds) of `reps` synchronized calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def device_profile(fn, warm: bool = True):
    """(Counter of device ms by kernel name, total device ms) over one call
    of fn under torch.profiler, after one unprofiled call when `warm`;
    (None, None) if it recorded no device time. Only device activity is
    recorded: the host ops' events would cost more to gather than a whole
    clip's kernels."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = Counter()
    for ev in prof.key_averages():
        # A user annotation (the optimizer's record_function span) has a
        # device range too; its kernels are counted on their own.
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            by_name[ev.key] += ev.self_device_time_total / 1e3
    total = sum(by_name.values())
    return (by_name, total) if total > 0 else (None, None)


def device_ms(fn, iters: int = 10, tries: int = 3):
    """Device ms per call of fn (every kernel it launches) under
    torch.profiler: unlike the CUDA-event time, independent of how fast the
    host enqueues. A pass in which the profiler records no device time at
    all is taken again, up to `tries` passes; None if none recorded any."""
    for _ in range(tries):
        _, total = device_profile(lambda: [fn() for _ in range(iters)])
        if total is not None:
            return total / iters
    return None


def bound(nbytes: float, flops: float, peak: float):
    """(ms, what bounds it) for the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bf16_half_ulp(v: torch.Tensor) -> torch.Tensor:
    """Half a bf16 ulp of each value (0 at 0): the most that rounding v to
    bf16 moves it."""
    half = torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 9)
    return torch.where(v == 0, torch.zeros_like(v), half)


class BlendWitness:
    """What made a blend factor's gradient exactly zero at a training step.

    A blend (AlphaBlender: alpha * x_spatial + (1 - alpha) * x_temporal, in
    bf16 as the reference's) gives its alpha, per frame, the bf16 sum
    bf16(sum g * x_spatial) - bf16(sum g * x_temporal); the products g * x
    and the two sums are each rounded to bf16 by autograd. Hooks on every
    blender: its first call in a step is the forward, whose output and alpha
    get gradient hooks; its second is the rematerialised recompute in the
    backward, whose inputs are the tensors the blend's backward multiplies.
    When alpha's gradient arrives, the two sums and their difference are
    taken again in fp32 at every frame, with the slack the roundings
    have: half a bf16 ulp of each sum, plus 2^-8 of sum |g| (|x_s| + |x_t|)
    over the values where the branches differ (their products round
    differently; elsewhere they are the same bf16 product). The factor's
    gradient is its frames' readings summed. Its zero is explained by
    rounding when every frame's fp32 difference lies within that slack (the
    frame's true value is below what the roundings resolve), every frame's
    reading lies within that slack (plus half a bf16 ulp of the reading,
    the subtraction's own rounding) of its fp32 difference, and the readings
    sum to zero: frames that read zero, or frames that read small values
    which cancel. Nothing here synchronises inside the step."""

    def __init__(self, model):
        from gcd_tpu_torch.models.layers import AlphaBlender

        self.calls, self.held, self.frames = Counter(), {}, {}
        self.handles = []
        for name, mod in model.named_modules():
            if isinstance(mod, AlphaBlender):
                self.handles.append(mod.register_forward_pre_hook(
                    lambda m, inputs, name=name: self._pre(name, inputs)))
                self.handles.append(mod.register_forward_hook(
                    lambda m, inputs, out, name=name: self._post(name, inputs, out)))

    def reset(self):
        self.calls.clear()
        self.held.clear()
        self.frames.clear()

    def remove(self):
        for h in self.handles:
            h.remove()

    def _pre(self, name, inputs):
        self.calls[name] += 1
        if self.calls[name] == 2:
            self.held[name] = inputs[:2]

    def _post(self, name, inputs, out):
        alpha = inputs[2]
        if self.calls[name] == 1 and out.requires_grad and alpha.requires_grad:
            out.register_hook(lambda g: self.held.__setitem__(name + ".g", g))
            alpha.register_hook(lambda ga: self._sums(name, ga))

    @torch.no_grad()
    def _sums(self, name, ga):
        # The blend's backward has run, so the recompute has given its inputs
        # (g, from the output's hook, may have come before the recompute).
        g, held = self.held.pop(name + ".g", None), self.held.pop(name, None)
        if g is None or held is None:  # explain() says so
            return
        xs, xt = (x.float() for x in held)
        gf = g.float()
        a = (gf * xs).sum_to_size(ga.shape)
        b = (gf * xt).sum_to_size(ga.shape)
        differ = xs != xt
        self.frames[name] = {
            "grad": ga, "diff": (gf * (xs - xt)).sum_to_size(ga.shape),
            "slack": bf16_half_ulp(a) + bf16_half_ulp(b) + 2.0 ** -8 * (
                gf.abs() * (xs.abs() + xt.abs()) * differ).sum_to_size(ga.shape),
            "differ": differ.sum()}

    def explain(self, name: str) -> dict:
        """The evidence for blender `name` (a module name) at this step."""
        if self.calls[name] != 2 or name not in self.frames:
            return {"explained": False, "calls": self.calls[name]}
        fr = self.frames[name]
        grad, diff, slack = fr["grad"].float(), fr["diff"], fr["slack"]
        value = torch.where(diff == 0, torch.zeros_like(diff), diff.abs() / slack)
        err = (grad - diff).abs()
        err = torch.where(err == 0, torch.zeros_like(err), err / (slack + bf16_half_ulp(grad)))
        cancel = float(grad.sum().to(torch.bfloat16)) == 0.0
        nonzero = (grad != 0).flatten().nonzero().flatten().tolist()
        return {"explained": bool((value <= 1).all()) and bool((err <= 1).all()) and cancel,
                "zero_frames": grad.numel() - len(nonzero), "frames": grad.numel(),
                "max_diff_over_slack": float(value.max()),
                "max_reading_err_over_slack": float(err.max()),
                "max_abs_diff": float(diff.abs().max()),
                # Frames that read nonzero: (reading, fp32 difference, slack).
                "nonzero_frames": [[float(grad.flatten()[i]), float(diff.flatten()[i]),
                                    float(slack.flatten()[i])] for i in nonzero],
                "values_where_branches_differ": int(fr["differ"])}


def random_batch(gen: torch.Generator, clips: int = 1, target: bool = False) -> dict:
    """A JAX-layout batch of `clips` videos: random 14-frame clips in
    [-1, 1], their noised copies, random camera moves, and with `target`
    the frames to learn ("jpg")."""
    n = clips * T

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    frames = rand(n, H, W, 3) * 2.0 - 1.0
    batch = {"cond_frames": frames + 0.02 * torch.randn(frames.shape, generator=gen,
                                                        device="cuda"),
             "cond_frames_without_noise": frames,
             "cond_aug": torch.full((n,), 0.02, device="cuda"),
             "fps_id": torch.full((n,), 5.0, device="cuda"),
             "motion_bucket_id": torch.full((n,), 127.0, device="cuda"),
             "scaled_relative_angles": (rand(n, 3) * 2.0 - 1.0) * 0.5,
             "image_only_indicator": torch.zeros(clips, T, device="cuda")}
    if target:
        batch["jpg"] = rand(n, H, W, 3) * 2.0 - 1.0
    return batch


def memory_layout(x: torch.Tensor) -> str:
    if x.is_contiguous():
        return "contiguous"
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    if fmt is not None and x.is_contiguous(memory_format=fmt):
        return "channels_last"
    return f"strides {x.stride()}"  # the (B, C, T, H, W) view of a (B, T, C, H, W) video


def site_tensor(shape, layout: str) -> torch.Tensor:
    """A meta tensor of a recorded GroupNorm site's shape and memory layout
    (`memory_layout`'s names; other strides are the (B, C, T, H, W) view of
    a contiguous (B, T, C, H, W) video)."""
    if layout == "contiguous":
        return torch.empty(shape, device="meta")
    if layout == "channels_last":
        return torch.empty(shape[0], *shape[2:], shape[1], device="meta").movedim(-1, 1)
    b, c, t, h, w = shape
    return torch.empty(b, t, c, h, w, device="meta").transpose(1, 2)


def split_calls(sites: Counter) -> int:
    """K5's launches from K4 over recorded GroupNorm calls, `sites` mapping
    (shape, memory layout, eps, silu) to calls: the calls whose shape and
    layout take K4's split path (uses_split_path); the others run K4 in one
    pass."""
    from gcd_tpu_torch.ops.fused_norm import uses_split_path

    return sum(n for (shape, layout, *_), n in sites.items()
               if uses_split_path(site_tensor(shape, layout), G))


@contextmanager
def record_groupnorms(engine, counter: Counter):
    """Count every GroupNorm32 call by (shape, memory layout, eps, silu)."""
    from gcd_tpu_torch.models.layers import GroupNorm32

    def hook(mod, inputs, _):
        if mod.num_groups != G:
            raise RuntimeError(f"GroupNorm32 with {mod.num_groups} groups, not {G}")
        x = inputs[0]
        counter[(tuple(x.shape), memory_layout(x), mod.eps, mod.silu)] += 1

    handles = [m.register_forward_hook(hook) for m in engine.modules()
               if isinstance(m, GroupNorm32)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextmanager
def record_gn_conv_sites(engine, counter: Counter):
    """Count every K7 call of the 2D ResBlocks by (N, C, H, W, F): each of
    the block's fused chains (ResBlock.fused_convs), the in_layers chain on
    x, the out_layers chain on (N, F, H, W) at the output's plane."""
    from gcd_tpu_torch.models.resblock import ResBlock
    from gcd_tpu_torch.ops import kernel_enabled
    from gcd_tpu_torch.ops.fused_gn_conv import supported

    def hook(mod, inputs, out):
        x = inputs[0]
        if x.dim() != 4 or not kernel_enabled("fused_gn_conv"):
            return
        for conv in mod.fused_convs():
            # in_layers' conv on x, out_layers' on the block's output plane.
            n, ch, h, w = x.shape if conv is mod.in_layers[2] else (
                out.shape[0], conv.in_channels, *out.shape[2:])
            if supported(torch.empty(n, ch, h, w, device="meta"), conv.weight, G):
                counter[(n, ch, h, w, conv.out_channels)] += 1

    handles = [m.register_forward_hook(hook) for m in engine.modules()
               if isinstance(m, ResBlock) and m.fused_convs()]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def gn_conv_modules(unet) -> int:
    """The K7 sites of one UNet evaluation: two per 2D ResBlock."""
    from gcd_tpu_torch.models.resblock import ResBlock

    return sum(len(m.fused_convs()) for m in unet.modules() if isinstance(m, ResBlock))


def gn_conv_label(site) -> str:
    n, c, h, w, f = site
    return f"({n},{c},{h},{w}) -> F={f}"


def site_label(site) -> str:
    shape, layout, eps, silu = site
    return f"{shape} {layout} eps={eps} silu={silu}"


def count_modules(module, cls) -> int:
    return sum(isinstance(m, cls) for m in module.modules())


def flash_label(level: str, b: int, s: int, heads: int) -> str:
    return f"{level} ({b},{s},{heads}x64)"


def mlp_label(level: str, m: int, c: int, inner: int) -> str:
    return f"{level} M={m} C={c} I={inner}"


def tattn_label(level: str, bt: int, s: int, c: int, t: int = T) -> str:
    return f"{level} ({bt},{s},{c}) T={t}"


def grouped_var_mean(x: torch.Tensor):
    """The library call for K5: torch.var_mean over each (sample, group) of
    x's own memory layout (channels-last, contiguous, or the (B, C, T, H, W)
    view of a (B, T, C, H, W) buffer), without a copy."""
    n, c = x.shape[:2]
    last = x.movedim(1, -1)
    if last.is_contiguous():
        return torch.var_mean(last.reshape(n, -1, G, c // G), dim=(1, 3))
    if x.is_contiguous():
        return torch.var_mean(x.reshape(n, G, -1), dim=-1)
    t = x.transpose(1, 2)  # (B, T, C, H, W), contiguous
    return torch.var_mean(t.reshape(n, t.shape[1], G, -1), dim=(1, 3))


def sdpa_backward(q, k, v, g, heads: int):
    """The library call for K6: torch.autograd.grad through PyTorch's fused
    attention on pre-transposed (B, H, S, D) inputs, its forward run once
    beforehand (timed only)."""
    b, s, c = q.shape
    qkv = [z.reshape(b, s, heads, c // heads).transpose(1, 2).contiguous().requires_grad_()
           for z in (q, k, v)]
    out = F.scaled_dot_product_attention(*qkv)
    gh = g.reshape(b, s, heads, c // heads).transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, qkv, gh, retain_graph=True)


def attention_mlp_cases(gen: torch.Generator, steps: int):
    """(kernel, label, launches per clip -- per training step for K6 --,
    kernel call, plain call, library call or None, bytes, operations, peak)
    for K1, K6, K2 and K3."""
    from gcd_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                   flash_attention_bwd_plain, flash_attention_plain,
                                   geglu_mlp, geglu_mlp_plain, temporal_attention,
                                   temporal_attention_plain)
    from gcd_tpu_torch.ops.temporal_attention import kernel_family

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    for name, s, c, blocks in LEVELS:
        heads = c // 64
        q, k, v = randn(BT, s, c), randn(BT, s, c), randn(BT, s, c)
        qkv_bytes = 4 * BT * s * c * 2
        sh = [z.reshape(BT, s, heads, 64).transpose(1, 2).contiguous() for z in (q, k, v)]
        yield ("flash", f"{name} ({BT},{s},{heads}x64)", blocks * steps,
               lambda q=q, k=k, v=v, h=heads: flash_attention(q, k, v, h),
               lambda q=q, k=k, v=v, h=heads: flash_attention_plain(q, k, v, h),
               lambda sh=sh: F.scaled_dot_product_attention(*sh),
               qkv_bytes, 4 * BT * s * s * c, BF16_FLOPS)
        # The served batch's shape (two clips, B*T = 56): 0 launches per clip.
        bs = SERVE_BATCH * BT
        q2, k2, v2 = randn(bs, s, c), randn(bs, s, c), randn(bs, s, c)
        sh2 = [z.reshape(bs, s, heads, 64).transpose(1, 2).contiguous() for z in (q2, k2, v2)]
        yield ("flash", flash_label(name, bs, s, heads), 0,
               lambda q=q2, k=k2, v=v2, h=heads: flash_attention(q, k, v, h),
               lambda q=q2, k=k2, v=v2, h=heads: flash_attention_plain(q, k, v, h),
               lambda sh=sh2: F.scaled_dot_product_attention(*sh),
               2 * qkv_bytes, 4 * bs * s * s * c, BF16_FLOPS)
        # The plain steps' shape (guidance_interval: the conditional half
        # alone, B*T = 14): 0 launches per clip.
        q1, k1, v1 = q[T:], k[T:], v[T:]
        sh1 = [z[T:] for z in sh]
        yield ("flash", flash_label(name, T, s, heads), 0,
               lambda q=q1, k=k1, v=v1, h=heads: flash_attention(q, k, v, h),
               lambda q=q1, k=k1, v=v1, h=heads: flash_attention_plain(q, k, v, h),
               lambda sh=sh1: F.scaled_dot_product_attention(*sh),
               qkv_bytes // 2, 4 * T * s * s * c, BF16_FLOPS)
        # The training shapes: B*T = 28 (2 clips of 14 frames), one K6 per
        # spatial transformer block per step. Five S x S x D products per
        # head; q, k, v, dO read and dQ, dK, dV written once.
        do = randn(BT, s, c)
        yield ("flash_bwd", f"{name} ({BT},{s},{heads}x64)", blocks,
               lambda q=q, k=k, v=v, do=do, h=heads: flash_attention_bwd(q, k, v, do, h),
               lambda q=q, k=k, v=v, do=do, h=heads: flash_attention_bwd_plain(q, k, v, do, h),
               sdpa_backward(q, k, v, do, heads), 7 * BT * s * c * 2,
               10 * BT * s * s * c, BF16_FLOPS)
        if name == "ds2":
            # K1 at D = 128 (not on the UNet's path; 0 launches per clip).
            h2 = c // 128
            sh3 = [z.reshape(BT, s, h2, 128).transpose(1, 2).contiguous() for z in (q, k, v)]
            yield ("flash", f"{name} ({BT},{s},{h2}x128)", 0,
                   lambda q=q, k=k, v=v, h=h2: flash_attention(q, k, v, h),
                   lambda q=q, k=k, v=v, h=h2: flash_attention_plain(q, k, v, h),
                   lambda sh=sh3: F.scaled_dot_product_attention(*sh),
                   qkv_bytes, 4 * BT * s * s * c, BF16_FLOPS)
        # K2 at one clip's shape, and at the plain steps' and the served
        # batch's (0 launches per clip); the library call is SDPA on the
        # frame-major relayout.
        for bt, (qt, kt, vt), launches in ((BT, (q, k, v), blocks * steps),
                                            (T, (q1, k1, v1), 0), (bs, (q2, k2, v2), 0)):
            th = [z.reshape(bt // T, T, s, heads, 64).permute(0, 2, 3, 1, 4)
                  .reshape(bt // T * s, heads, T, 64).contiguous() for z in (qt, kt, vt)]
            yield ("tattn", tattn_label(name, bt, s, c), launches,
                   lambda q=qt, k=kt, v=vt, h=heads: temporal_attention(q, k, v, T, h),
                   lambda q=qt, k=kt, v=vt, h=heads: temporal_attention_plain(q, k, v, T, h),
                   lambda th=th: F.scaled_dot_product_attention(*th),
                   qkv_bytes * bt // BT, 4 * bt * s * T * c, BF16_FLOPS)
        # K2 with two row tiles (not on the 14-frame clip's path; 0 launches
        # per clip): one clip with CFG at T = 25 and 32, the level's width;
        # at ds1 also a ragged S (no multiple of 8), at ds2 also D = 16. Then
        # its general family, likewise: one clip with CFG past 32 frames
        # (GENERAL_FRAMES); at ds1 a ragged S at T = LONG_FRAMES, the
        # `num_heads: 8` UNet's D = 40 at T = 14 and the VAE's one-head D =
        # 512 at T = 25 and 32, and the two kernels' boundary: T =
        # RESIDENT_FRAMES (resident) and one head of STREAMED_HEAD at T = 33
        # (streamed); at ds4 its D = 160. Each general case is labelled
        # with its kernel.
        extra = []  # (frames, positions, heads, channels, note)
        for tt in TALL_FRAMES:
            extra.append((tt, s, heads, c, ""))
            if name == "ds1" and tt == TALL_FRAMES[0]:
                extra.append((tt, s - 5, heads, c, " ragged S"))
            if name == "ds2" and tt == TALL_FRAMES[0]:
                extra.append((tt, s, c // 16, c, f" {c // 16}x16"))
        extra += [(tt, s, heads, c, "") for tt in GENERAL_FRAMES]
        if name == "ds1":
            extra += [(LONG_FRAMES, s - 5, heads, c, " ragged S"),
                      (T, s, c // 40, c, f" {c // 40}x40")]
            extra += [(tt, s, 1, 512, " 1x512") for tt in TALL_FRAMES]
            extra += [(RESIDENT_FRAMES, s, heads, c, ""),
                      (GENERAL_FRAMES[0], s, 1, STREAMED_HEAD, f" 1x{STREAMED_HEAD}")]
        if name == "ds4":
            extra.append((T, s, c // 160, c, f" {c // 160}x160"))
        for tt, st, hd, cc, note in extra:
            family = kernel_family(tt, cc // hd)
            bt2 = 2 * tt
            qt, kt, vt = randn(bt2, st, cc), randn(bt2, st, cc), randn(bt2, st, cc)
            th = [z.reshape(2, tt, st, hd, cc // hd).permute(0, 2, 3, 1, 4)
                  .reshape(2 * st, hd, tt, cc // hd).contiguous() for z in (qt, kt, vt)]
            yield ("tattn", tattn_label(name, bt2, st, cc, tt) + note
                   + ("" if family == "narrow" else f" {family}"), 0,
                   lambda q=qt, k=kt, v=vt, t=tt, h=hd: temporal_attention(q, k, v, t, h),
                   lambda q=qt, k=kt, v=vt, t=tt, h=hd:
                   temporal_attention_plain(q, k, v, t, h),
                   lambda th=th: F.scaled_dot_product_attention(*th),
                   4 * bt2 * st * cc * 2, 4 * bt2 * st * tt * cc, BF16_FLOPS)
        if name == "ds2":
            # K2 at the other box layouts it takes (not on the UNet's path; 0
            # launches per clip): D = 16 (several heads a box), 80 (a partial
            # second box) and 128 (two boxes).
            for d in (16, 80, 128):
                hd = c // d
                th = [z.reshape(BT // T, T, s, hd, d).permute(0, 2, 3, 1, 4)
                      .reshape(BT // T * s, hd, T, d).contiguous() for z in (q, k, v)]
                yield ("tattn", f"{tattn_label(name, BT, s, c)} {hd}x{d}", 0,
                       lambda q=q, k=k, v=v, h=hd: temporal_attention(q, k, v, T, h),
                       lambda q=q, k=k, v=v, h=hd: temporal_attention_plain(q, k, v, T, h),
                       lambda th=th: F.scaled_dot_product_attention(*th),
                       qkv_bytes, 4 * BT * s * T * c, BF16_FLOPS)
        inner = 4 * c
        w1, b1 = randn(2 * inner, c, std=c ** -0.5), randn(2 * inner, std=0.1)
        w2, b2 = randn(c, inner, std=inner ** -0.5), randn(c, std=0.1)
        # One clip's shape, and the plain steps' and the served batch's (two
        # clips): 0 launches per clip.
        for m, launches in ((BT * s, 3 * blocks * steps), (T * s, 0),
                            (SERVE_BATCH * BT * s, 0)):
            x = randn(m, c)
            yield ("fused_mlp", mlp_label(name, m, c, inner), launches,
                   lambda a=(x, w1, b1, w2, b2): geglu_mlp(*a),
                   lambda a=(x, w1, b1, w2, b2): geglu_mlp_plain(*a), None,
                   2 * (2 * m * c + 3 * inner * c + 2 * inner + c), 6 * m * c * inner,
                   BF16_FLOPS)


def groupnorm_cases(gen: torch.Generator, sites: Counter, variants: dict):
    """K4 and K5 cases at every recorded GroupNorm site: `sites` maps
    (shape, memory layout, eps, silu) to launches per clip. `variants` gets
    each site label's K4 variant ("one-pass", or "split": K5, then the apply
    pass, both inside K4's call)."""
    from gcd_tpu_torch.ops import group_norm, group_norm_plain, group_stats, group_stats_plain
    from gcd_tpu_torch.ops.fused_norm import uses_split_path

    for site, per_clip in sorted(sites.items()):
        shape, layout, eps, silu = site
        c = shape[1]
        if layout == "contiguous":
            x = torch.randn(*shape, generator=gen, device="cuda")
        elif layout == "channels_last":
            x = torch.randn(shape[0], *shape[2:], c, generator=gen, device="cuda")
            x = x.movedim(-1, 1)
        else:  # the (B, C, T, H, W) view of a (B, T, C, H, W) buffer
            b, _, t, h, w = shape
            x = torch.randn(b, t, c, h, w, generator=gen, device="cuda").transpose(1, 2)
        if memory_layout(x) != layout:
            raise RuntimeError(f"made {memory_layout(x)} for a {layout} site")
        x = (x * 2.0 + 0.5).to(torch.bfloat16)
        wt = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        bs = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        n = x.numel()
        label = site_label(site)
        split = uses_split_path(x, G)
        variants[label] = "split" if split else "one-pass"
        yield ("fused_gn", label, per_clip,
               lambda x=x, wt=wt, bs=bs, e=eps, s=silu: group_norm(x, wt, bs, G, e, s),
               lambda x=x, wt=wt, bs=bs, e=eps, s=silu: group_norm_plain(x, wt, bs, G, e, s),
               lambda x=x, wt=wt, bs=bs, e=eps: F.group_norm(x, G, wt, bs, e),
               4 * n + 4 * c, n * (12 if silu else 8), FP32_FLOPS)
        yield ("gn_stats", label, per_clip if split else 0,
               lambda x=x: group_stats(x, G), lambda x=x: group_stats_plain(x, G),
               lambda x=x: grouped_var_mean(x),
               2 * n + 16 * shape[0] * G, 2 * n, FP32_FLOPS)


def gn_conv_cases(gen: torch.Generator, sites: Counter):
    """K7 cases at every recorded site: `sites` maps (N, C, H, W, F) to
    launches per clip. The library call is one cuDNN conv (channels-last)
    on the already-normalised input: the conv alone, nearly all the FLOPs."""
    from gcd_tpu_torch.ops import gn_silu_conv3x3, gn_silu_conv3x3_plain, group_norm_plain

    for (n, c, h, w, f), per_clip in sorted(sites.items()):
        def randn(*shape, std=1.0, mean=0.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * std + mean).to(
                torch.bfloat16)

        x = randn(n, h, w, c, std=2.0, mean=0.5).permute(0, 3, 1, 2)
        gw, gb = randn(c, std=0.1, mean=1.0), randn(c, std=0.1)
        wt = randn(f, c, 3, 3, std=(9 * c) ** -0.5).contiguous(memory_format=torch.channels_last)
        b = randn(f, std=0.1)
        normed = group_norm_plain(x, gw, gb, G, 1e-5, True).contiguous(
            memory_format=torch.channels_last)
        yield ("fused_gn_conv", gn_conv_label((n, c, h, w, f)), per_clip,
               lambda a=(x, gw, gb, wt, b): gn_silu_conv3x3(*a, G, 1e-5, True),
               lambda a=(x, gw, gb, wt, b): gn_silu_conv3x3_plain(*a, G, 1e-5, True),
               lambda y=normed, wt=wt, b=b: F.conv2d(y, wt, b, padding=1),
               2 * (x.numel() + wt.numel() + n * f * h * w + 2 * c + f),
               2 * n * h * w * 9 * c * f, BF16_FLOPS)


def serve(smi: str):
    """Phases 3-6 and the served phase. Returns (per-kernel statistics of
    phase 4, launches over phase 6's requests, the served phase's launches,
    the launch model: each kernel's launches per clip and per UNet
    evaluation at B*T = 28 and 14, what the sharded phase needs of phase
    6)."""
    from gcd_tpu_torch.engine.build import load_engine
    from gcd_tpu_torch.models.attention import BasicTransformerBlock
    from gcd_tpu_torch.models.embedders import VideoPredictionEmbedderWithEncoder
    from gcd_tpu_torch.models.layers import FeedForward, GroupNorm32
    from gcd_tpu_torch.models.video_attention import VideoTransformerBlock
    from gcd_tpu_torch.ops import KERNELS, kernel_flags

    # Phase 3: the conditioner at full width.
    t0 = time.perf_counter()
    engine = load_engine(CONFIG)
    log("engine", seconds=time.perf_counter() - t0,
        params=sum(p.numel() for p in engine.parameters()))
    unet = engine.model.diffusion_model
    steps = engine.sampler.num_steps
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    batch = random_batch(gen)
    gn_calls = {"cond": Counter(), "unet": Counter(), "decode": Counter()}
    gn_conv_calls = Counter()
    with torch.no_grad():
        with record_groupnorms(engine, gn_calls["cond"]):
            c, uc = engine.get_unconditional_conditioning(batch, UC_KEYS)
        _, cond_s = wall_s(lambda: engine.get_unconditional_conditioning(batch, UC_KEYS))
    want = {"crossattn": (T, 1, 1024), "vector": (T, 896), "concat": (T, HL, WL, 4)}
    got = {"c": {k: tuple(v.shape) for k, v in c.items()},
           "uc": {k: tuple(v.shape) for k, v in uc.items()}}
    log("conditioner", seconds=cond_s, shapes=got, card=smi)
    if got["c"] != want or got["uc"] != want:
        raise RuntimeError(f"conditioner shapes {got}, expected {want} for c and uc")
    if not all(torch.isfinite(v).all() for v in (*c.values(), *uc.values())):
        raise RuntimeError("conditioner output not finite")
    if uc["crossattn"].any() or uc["concat"].any() or not torch.equal(uc["vector"], c["vector"]):
        raise RuntimeError("uc must zero the image embeddings and keep the vector")

    # Phase 4: record the UNet's and the decoder's GroupNorm sites, then every
    # kernel against its plain version at the main-path shapes.
    cond = {k: torch.cat([uc[k], c[k]]) for k in c}
    cond["concat"] = cond["concat"].permute(0, 3, 1, 2)
    # Latents channels-last, as DiffusionEngine.sample_latents makes them.
    x = torch.randn(BT, HL, WL, 4, generator=gen, device="cuda").permute(0, 3, 1, 2)
    sigma = torch.full((BT,), 1.0, device="cuda")
    ioi = torch.zeros(2, T, device="cuda")
    z = torch.randn(T, HL, WL, 4, generator=gen, device="cuda").permute(0, 3, 1, 2)

    def network(xin, c_noise, cc):
        return engine.network_fn(xin, c_noise, cc, T, ioi)

    def denoise():
        return engine.denoiser(network, x, sigma, cond)

    # A plain step of guidance_interval: the conditional half alone (B*T = 14).
    cond14 = {k: v[T:] for k, v in cond.items()}

    def denoise14():
        return engine.denoiser(lambda xin, c_noise, cc: engine.network_fn(
            xin, c_noise, cc, T, ioi[1:]), x[T:], sigma[T:], cond14)

    def decode():
        return engine.decode_first_stage(z, T)

    with torch.no_grad():
        with record_groupnorms(engine, gn_calls["unet"]), \
                record_gn_conv_sites(engine, gn_conv_calls):
            denoise()
        with record_groupnorms(engine, gn_calls["decode"]):
            decode()
        gn_unet14, gn_conv_calls14 = Counter(), Counter()
        with record_groupnorms(engine, gn_unet14), \
                record_gn_conv_sites(engine, gn_conv_calls14):
            denoise14()
    cond_encoders = [m.encoder.encoder for m in engine.conditioner.embedders
                     if isinstance(m, VideoPredictionEmbedderWithEncoder)]
    # K7 takes the GroupNorm of 44 chains of the UNet: those GroupNorm32
    # modules are not called.
    k7_sites = gn_conv_modules(unet)
    gn_modules = {"cond": sum(count_modules(e, GroupNorm32) for e in cond_encoders),
                  "unet": count_modules(unet, GroupNorm32) - k7_sites,
                  "decode": count_modules(engine.first_stage_model.decoder, GroupNorm32)}
    gn_per_pass = {stage: sum(calls.values()) for stage, calls in gn_calls.items()}
    if (gn_per_pass != gn_modules or sum(gn_conv_calls.values()) != k7_sites
            or sum(gn_unet14.values()) != gn_modules["unet"]
            or sum(gn_conv_calls14.values()) != k7_sites):
        raise RuntimeError(f"GroupNorm calls per pass {gn_per_pass} != modules {gn_modules}, "
                           f"or K7 calls {sum(gn_conv_calls.values())} != sites {k7_sites} "
                           f"(B*T = 14: {sum(gn_unet14.values())}, "
                           f"{sum(gn_conv_calls14.values())})")
    per_clip = {"cond": 1, "unet": steps, "decode": 1}
    gn_sites = Counter()
    for stage, calls in gn_calls.items():
        for key, n in calls.items():
            gn_sites[key] += per_clip[stage] * n
    log("groupnorm_sites", per_pass=gn_per_pass, distinct_shapes=len(gn_sites),
        gn_conv_per_pass=k7_sites, gn_conv_shapes=len(gn_conv_calls))
    gn_conv_sites = Counter({site: steps * n for site, n in gn_conv_calls.items()})
    for site in gn_conv_calls14:  # the plain steps' shapes: 0 launches per clip
        gn_conv_sites[site] += 0
    # The served batch's shapes (B*T = 56 in the UNet): 0 launches per clip,
    # `served_k7` launches per served batch.
    served_k7 = {}
    for (n, *rest), calls in gn_conv_calls.items():
        site = (n * SERVE_BATCH, *rest)
        gn_conv_sites[site] += 0
        served_k7[gn_conv_label(site)] = steps * calls
    # K1's served shapes (B*T = 56): its launches per served batch.
    served_k1 = {flash_label(name, SERVE_BATCH * BT, s, c // 64): steps * blocks
                 for name, s, c, blocks in LEVELS}
    # K3's served shapes: three feed-forwards per transformer block.
    served_k3 = {mlp_label(name, SERVE_BATCH * BT * s, c, 4 * c): 3 * steps * blocks
                 for name, s, c, blocks in LEVELS}
    # K2's served shapes: one temporal attention per time_stack block, as
    # many as the spatial ones.
    served_k2 = {tattn_label(name, SERVE_BATCH * BT, s, c): steps * blocks
                 for name, s, c, blocks in LEVELS}
    served_sites = {"fused_gn_conv": served_k7, "flash": served_k1, "fused_mlp": served_k3,
                    "tattn": served_k2}
    # The path's tensors are channels-last; K4 / K5 also take channels-first
    # ones (contiguous, and the time_stack view of a contiguous video), which
    # are held against the plain versions at the same shapes, 0 launches per
    # clip.
    gn_checked = Counter(gn_sites)
    for shape, _, eps, silu in list(gn_sites):
        gn_checked[(shape, "contiguous", eps, silu)] += 0
        if len(shape) == 5:
            b, c5, t, h, w = shape
            view = torch.empty(b, t, c5, h, w, device="meta").transpose(1, 2)
            gn_checked[(shape, memory_layout(view), eps, silu)] += 0
    for site in gn_unet14:  # the plain steps' sites: 0 launches per clip
        gn_checked[site] += 0
    # The served batch's sites (the conditioner's and the UNet's N doubled):
    # 0 launches per clip.
    for stage in ("cond", "unet"):
        for (shape, *rest) in gn_calls[stage]:
            gn_checked[((shape[0] * SERVE_BATCH, *shape[1:]), *rest)] += 0

    gen = torch.Generator("cuda").manual_seed(SEED)
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": None, "t_bytes": 0.0, "t_ops": 0.0, "per_clip": 0}
             for name in KERNELS}
    gn_ms = {}  # site label -> (K4 ms, plain ms, K4 device ms) per call
    gn_variants = {}  # site label -> K4 variant
    gn_by_variant = {v: Counter() for v in ("one-pass", "split")}  # per clip
    served_ms = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                        "device_ms": 0.0, "plain_device_ms": 0.0, "library_device_ms": 0.0}
                 for name in served_sites}
    cases = itertools.chain(attention_mlp_cases(gen, steps),
                            groupnorm_cases(gen, gn_checked, gn_variants),
                            gn_conv_cases(gen, gn_conv_sites))
    for name, label, n_clip, run, plain, library, nbytes, flops, peak in cases:
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        err, err_abs = rel_l2(out, ref), max_abs(out, ref)
        (ms, host_ms), (plain_ms, plain_host_ms) = cuda_ms(run), cuda_ms(plain)
        lib_ms, lib_host_ms = cuda_ms(library) if library is not None else (None, None)
        b_ms, b_by = bound(nbytes, flops, peak)
        # Also by device time, theirs, their plain version's and their
        # library call's: at the small shapes the host's enqueue can outlast
        # the device.
        dev = {}
        if name in DEVICE_TIMED:
            dev = {"device_ms": device_ms(run), "plain_device_ms": device_ms(plain),
                   "library_device_ms": None if library is None else device_ms(library)}
        extra = {"variant": gn_variants[label]} if name in ("fused_gn", "gn_stats") else {}
        log("kernel", kernel=name, shape=label, **extra, per_clip=n_clip, rel_l2=err,
            max_abs_err=err_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **dev,
            bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
            achieved_tflops=flops / ms / 1e9, host_ms=host_ms, plain_host_ms=plain_host_ms,
            library_host_ms=lib_host_ms, card=smi)
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"{name} {label}: relative L2 {err} > {KERNEL_TOL}")
        if rel_l2(run(), out) != 0.0:
            raise RuntimeError(f"{name} {label}: two calls differ (no atomics: must not)")
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err_abs)
        st["ms"] += n_clip * ms
        st["plain_ms"] += n_clip * plain_ms
        st["bound_ms"] += n_clip * b_ms
        st["t_bytes"] += n_clip * nbytes / HBM_BPS
        st["t_ops"] += n_clip * flops / peak
        st["per_clip"] += n_clip
        if lib_ms is not None:
            st["library_ms"] = (st["library_ms"] or 0.0) + n_clip * lib_ms
        for key, t in dev.items():
            if n_clip:  # a shape off the clip's path adds nothing to its sums
                st[key] = None if t is None or st.get(key, 0.0) is None else (
                    st.get(key, 0.0) + n_clip * t)
        if name == "fused_gn" and n_clip:
            gn_ms[label] = (ms, plain_ms, dev["device_ms"])
            gn_by_variant[extra["variant"]].update(
                {"calls": n_clip, "ms": n_clip * ms, "bound_ms": n_clip * b_ms,
                 "device_ms": n_clip * (dev["device_ms"] or 0.0),
                 "library_ms": n_clip * (lib_ms or 0.0)})
        if label in served_sites.get(name, ()):
            for key, t in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", b_ms), *dev.items()):
                served_ms[name][key] += served_sites[name][label] * (t or 0.0)
        del out, ref, run, plain, library
    torch.cuda.empty_cache()
    by_stage = {stage: {"k4_ms": sum(n * gn_ms[site_label(k)][0] for k, n in calls.items()),
                        "plain_ms": sum(n * gn_ms[site_label(k)][1] for k, n in calls.items()),
                        "k4_device_ms": sum(n * (gn_ms[site_label(k)][2] or 0.0)
                                            for k, n in calls.items())}
                for stage, calls in gn_calls.items()}
    log("groupnorm_per_pass", **by_stage, card=smi)
    # K4 per clip by variant (the split sites' K5 runs inside K4's call).
    log("groupnorm_per_variant", **{v: dict(c) for v, c in gn_by_variant.items()}, card=smi)
    # At B*T = 14 no sample count reaches K4's one-pass minimum: every
    # channels-last site takes the split route.
    variants14 = {site_label(k): gn_variants[site_label(k)] for k in gn_unet14}
    log("groupnorm_variants_bt14", sites=variants14, card=smi)
    one_pass14 = [site_label(k) for k in gn_unet14
                  if k[1] == "channels_last" and gn_variants[site_label(k)] != "split"]
    if one_pass14:
        raise RuntimeError(f"K4 at B*T = 14 takes one pass at {one_pass14}")
    for name, sites in served_sites.items():
        log("kernel_served", kernel=name, per_batch=served_ms[name],
            launches_per_batch=sum(sites.values()), card=smi)

    # Phase 5: the modules with the kernels on vs off, and timed.
    all_off = dict.fromkeys(KERNELS, False)
    gn_off = {"fused_gn": False, "gn_stats": False}
    k7_off = {"fused_gn_conv": False}
    with torch.no_grad():
        den_on, unet_s_on = wall_s(denoise)
        raw_on = network(x, torch.zeros(BT, device="cuda"), cond)
        dec_on, dec_s_on = wall_s(decode)
        cat_on = engine.apply_conditioner(batch)["concat"]
        with kernel_flags(**gn_off):
            _, unet_s_gn_off = wall_s(denoise)
            _, dec_s_gn_off = wall_s(decode)
        with kernel_flags(**k7_off):
            den_k7_off, unet_s_k7_off = wall_s(denoise)
        with kernel_flags(**all_off):
            den_off, unet_s_off = wall_s(denoise)
            raw_off = network(x, torch.zeros(BT, device="cuda"), cond)
            dec_off = decode()
            cat_off = engine.apply_conditioner(batch)["concat"]
    ab = {"denoiser_rel_l2": rel_l2(den_on, den_off), "unet_rel_l2": rel_l2(raw_on, raw_off),
          "decode_rel_l2": rel_l2(dec_on, dec_off), "concat_rel_l2": rel_l2(cat_on, cat_off),
          "denoiser_k7_off_rel_l2": rel_l2(den_on, den_k7_off)}
    log("ab", **ab, tol=AB_TOL, unet_out_std=float(raw_off.float().std()),
        unet_s={"on": unet_s_on, "gn_off": unet_s_gn_off, "k7_off": unet_s_k7_off,
                "all_off": unet_s_off},
        decode_s={"on": dec_s_on, "gn_off": dec_s_gn_off}, card=smi)
    if not all(v <= AB_TOL for v in ab.values()):
        raise RuntimeError(f"kernels on vs off: {ab} > {AB_TOL}")
    del den_on, den_off, den_k7_off, raw_on, raw_off, dec_on, dec_off

    # One flagship UNet evaluation of a T = 25 clip with CFG (B*T = 50; the
    # conditioning rows of phase 4's batch, cycled): K2 with two row tiles
    # against K2 forced to its plain version; then of a T = LONG_FRAMES
    # clip (B*T = 128), K2's general family (its resident kernel) against
    # the same, and its device ms by kernel.
    k2 = KERNELS["tattn"]
    for tl in (TALL_FRAMES[0], LONG_FRAMES):
        rows_l = torch.arange(2 * tl, device="cuda") % BT
        cond_l = {k: v[rows_l] for k, v in cond.items()}
        x_l = torch.randn(2 * tl, HL, WL, 4, generator=gen, device="cuda").permute(0, 3, 1, 2)
        noise_l, ioi_l = torch.zeros(2 * tl, device="cuda"), torch.zeros(2, tl, device="cuda")

        def unet_long(x_l=x_l, noise_l=noise_l, cond_l=cond_l, tl=tl, ioi_l=ioi_l):
            return engine.network_fn(x_l, noise_l, cond_l, tl, ioi_l)

        with torch.no_grad():
            k2.launches = 0
            on_l = unet_long()
            k2_on, k2.launches = k2.launches, 0
            with kernel_flags(tattn=False):
                off_l = unet_long()
                k2_off = k2.launches
                off_ms = device_ms(unet_long, iters=3)
            on_ms = device_ms(unet_long, iters=3)
            by_name, _ = device_profile(unet_long, warm=False)
        k2.launches = 0
        err_l = rel_l2(on_l, off_l)
        log(f"unet_t{tl}", rows=2 * tl, frames=tl, rel_l2=err_l, tol=AB_TOL,
            k2_launches=k2_on, k2_plain_launches=k2_off,
            device_ms={"k2": on_ms, "k2_plain": off_ms},
            kernels_ms=None if by_name is None else {
                name: sum(v for k, v in by_name.items() if any(t in k for t in tags))
                for name, tags in PROFILE_TAGS.items()},
            out_std=float(on_l.float().std()), card=smi)
        if not (err_l <= AB_TOL and torch.isfinite(on_l).all()) or k2_off \
                or k2_on != count_modules(unet, VideoTransformerBlock):
            raise RuntimeError(f"UNet at T = {tl}: K2 on vs plain {err_l} (tol {AB_TOL}), "
                               f"K2 launches {k2_on} on, {k2_off} plain")
        del on_l, off_l, x_l, cond_l
    torch.cuda.empty_cache()

    # Device time by kernel over one UNet evaluation and one decode, GroupNorm
    # kernels on and off, K7 on and off; the idle share is against the
    # unprofiled wall time.
    walls = {"unet": unet_s_on, "unet_gn_off": unet_s_gn_off, "unet_k7_off": unet_s_k7_off,
             "decode": dec_s_on, "decode_gn_off": dec_s_gn_off}
    for what, wall in walls.items():
        flags = gn_off if what.endswith("gn_off") else k7_off if what.endswith("k7_off") else {}
        with torch.no_grad(), kernel_flags(**flags):
            by_name, total = device_profile(denoise if what.startswith("unet") else decode)
        if total is None:
            log("profile", what=what, device_ms="not measured", card=smi)
            continue
        log("profile", what=what, device_ms=total, wall_ms=1e3 * wall,
            idle_share=1.0 - total / (1e3 * wall),
            groupnorm_kernels_ms=sum(ms for k, ms in by_name.items()
                                     if "group_norm" in k or "group_stats" in k),
            gn_conv_kernel_ms=sum(ms for k, ms in by_name.items()
                                  if any(t in k for t in PROFILE_TAGS["fused_gn_conv"])),
            kernels_ms={name: sum(v for k, v in by_name.items() if any(t in k for t in tags))
                        for name, tags in PROFILE_TAGS.items()},
            top=[[k[:90], ms] for k, ms in by_name.most_common(10)], card=smi)

    # Phase 6: requests through the engine's entry point. K4 launches once per
    # GroupNorm call, K5 once per call on K4's split path (split_calls over
    # the pass's recorded sites) and once per K7. A served batch may double
    # the conditioner's and the UNet's N; the rule must then split the same
    # calls, which is checked here.
    split = {stage: split_calls(calls) for stage, calls in gn_calls.items()}
    doubled = {stage: split_calls(Counter({((shape[0] * SERVE_BATCH, *shape[1:]), *rest): n
                                           for (shape, *rest), n in gn_calls[stage].items()}))
               for stage in ("cond", "unet")}
    log("groupnorm_variants", split_calls=split, split_calls_served_n=doubled,
        one_pass_calls={stage: gn_per_pass[stage] - n for stage, n in split.items()})
    if any(doubled[stage] != split[stage] for stage in doubled):
        raise RuntimeError(f"K4's split rule changes with the served batch: {doubled} vs {split}")

    def gn_launches(passes: dict) -> dict:
        return {"fused_gn": sum(n * gn_modules[stage] for stage, n in passes.items()),
                "gn_stats": sum(n * split[stage] for stage, n in passes.items())
                + passes["unet"] * k7_sites}

    expected = {"flash": count_modules(unet, BasicTransformerBlock) * steps,
                "flash_bwd": 0,
                "tattn": count_modules(unet, VideoTransformerBlock) * steps,
                "fused_mlp": count_modules(unet, FeedForward) * steps,
                **gn_launches(per_clip),
                "fused_gn_conv": steps * k7_sites}
    # A served batch: one conditioner pass and one UNet pass for its clips,
    # and one decode per clip (decoding_t = T).
    per_batch = dict(expected, **gn_launches(dict(per_clip, decode=SERVE_BATCH)))
    # One UNet evaluation, guided (B*T = 28) or plain (14): K5 follows K4's
    # split rule at each N, the others launch once per site at either.
    per_eval = {n: {"flash": count_modules(unet, BasicTransformerBlock), "flash_bwd": 0,
                    "tattn": count_modules(unet, VideoTransformerBlock),
                    "fused_mlp": count_modules(unet, FeedForward),
                    "fused_gn": gn_modules["unet"], "gn_stats": calls + k7_sites,
                    "fused_gn_conv": k7_sites}
                for n, calls in ((BT, split["unet"]), (T, split_calls(gn_unet14)))}
    # The conditioner's and the decode's launches, once a clip.
    outside = {name: n - steps * per_eval[BT][name] for name, n in expected.items()}
    launch_model = {"per_clip": expected, "per_eval": per_eval, "outside_unet": outside}
    clip_s, first_frames = [], None
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNELS.values():
        fn.launches = 0
    for request in range(CLIPS):
        gen = torch.Generator("cuda").manual_seed(SEED + 10 + request)
        batch = random_batch(gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = engine.sample_video(batch, generator=gen, decoding_t=T)["sampled_video"]
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
        if tuple(frames.shape) != (T, H, W, 3):
            raise RuntimeError(f"frames shape {tuple(frames.shape)}")
        if not (torch.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1):
            raise RuntimeError("frames not finite in [0, 1]")
        if first_frames is None:
            first_frames = frames.cpu()
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    log("slice", clip_seconds=clip_s, frames_per_s=T / statistics.mean(clip_s[1:]),
        peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches,
        expected_per_clip=expected, frames_std=float(frames.std()), card=smi)
    for name, n in launches.items():
        if n != CLIPS * expected[name] or (expected[name] == 0 and name != "flash_bwd"):
            raise RuntimeError(f"{name}: {n} launches over {CLIPS} clips, expected "
                               f"{CLIPS} x {expected[name]}")

    # What K7 costs the clip: the first request again with K7 on and off,
    # the same batch and draws.
    k7_s, k7_frames = {"on": [], "off": []}, {}
    for which in ("on", "off"):
        gen = torch.Generator("cuda").manual_seed(SEED + 10)
        batch = random_batch(gen)
        with kernel_flags(fused_gn_conv=which == "on"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k7_frames[which] = engine.sample_video(batch, generator=gen,
                                                   decoding_t=T)["sampled_video"]
            torch.cuda.synchronize()
            k7_s[which].append(time.perf_counter() - t0)
    k7_rel = rel_l2(k7_frames["on"], k7_frames["off"])
    log("slice_k7_ab", clip_seconds=k7_s,
        on_over_off=statistics.mean(k7_s["on"]) / statistics.mean(k7_s["off"]),
        frames_rel_l2=k7_rel, tol=AB_TOL, card=smi)
    if not k7_rel <= AB_TOL:
        raise RuntimeError(f"clip frames, K7 on vs off: relative L2 {k7_rel} > {AB_TOL}")
    log("launch_model", **launch_model)
    # For the sharded phase: the first request's frames, the clips' wall
    # times, the launches a clip, and the UNet's GroupNorm and K7 sites.
    phase6 = {"frames": first_frames, "clip_s": clip_s, "expected": expected,
              "gn_unet": gn_calls["unet"], "gn_conv": gn_conv_calls,
              "held_gn": set(gn_checked), "held_k7": set(gn_conv_sites)}
    served_run = served(engine, smi, per_batch)
    samplers_launches = samplers_phase(engine, smi, launch_model, per_batch)
    return stats, launches, served_run, launch_model, phase6, samplers_launches


# The first-stage phase: the flagship engine with its VideoDecoder in
# time_mode "all" (VideoAttnBlock at mid_attn_1: K2 twice at one head of
# 512, K3 twice at C = 512, I = 2048 a decode chunk); K2 at the decoder's
# mid shape and at D = 256 (an attn_resolutions level of width 256 at
# 128 x 192 positions); SD v1's kl-f8 first stage (CompVis
# v1-inference.yaml first_stage_config); the LPIPS + PatchGAN loss at ndf 64,
# 3 layers on FS_LOSS_FRAMES frames; the quantizers at taming-transformers'
# vqgan_imagenet_f16_16384 widths on a clip's f16 latents.
FS_TIME_MODE = "all"
KL_F8 = {"embed_dim": 4, "ddconfig": {
    "double_z": True, "z_channels": 4, "resolution": 256, "in_channels": 3, "out_ch": 3,
    "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2, "attn_resolutions": [],
    "dropout": 0.0}}
FS_LOSS_FRAMES = 4
VQ_N_EMBED, VQ_DIM = 16384, 256
VQ_CPU_ROWS = 512  # latents whose indices the CPU recomputes


def seeded_weights_(module: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """load_engine's random weights (N(0, 0.02), seeded) on every parameter."""
    from gcd_tpu_torch.engine.build import RANDOM_STD

    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, RANDOM_STD, generator=gen)
    return module


def first_stage_phase(smi: str, launch_model: dict) -> dict:
    """The first-stage family on the card (module docstring). Returns the
    launches of the clip through the time_mode "all" engine."""
    import copy

    from gcd_tpu_torch.engine.build import engine_from_config
    from gcd_tpu_torch.models.discriminator import (GeneralLPIPSWithDiscriminator,
                                                    adaptive_weight_from_grads)
    from gcd_tpu_torch.models.layers import GroupNorm32
    from gcd_tpu_torch.models.lpips import LPIPS
    from gcd_tpu_torch.models.vae import VideoAttnBlock, VideoDecoder
    from gcd_tpu_torch.ops import (KERNELS, geglu_mlp, geglu_mlp_plain, kernel_flags,
                                   temporal_attention, temporal_attention_plain)
    from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

    phase_t0 = time.perf_counter()
    all_off = dict.fromkeys(KERNELS, False)
    cfg = copy.deepcopy(load_config(CONFIG)["model"])
    dec_cfg = cfg["params"]["first_stage_config"]["params"]["decoder_config"]
    dec_cfg["params"]["time_mode"] = FS_TIME_MODE
    t0 = time.perf_counter()
    engine = engine_from_config(cfg)
    build_s = time.perf_counter() - t0
    decoder = engine.first_stage_model.decoder
    attn_blocks = count_modules(decoder, VideoAttnBlock)
    with torch.device("meta"):
        conv_only = VideoDecoder(**{k: v for k, v in dec_cfg["params"].items()
                                    if k != "time_mode"})
    # Launches a clip: phase 6's model, plus two K2 and two K3 a
    # VideoAttnBlock (one decode chunk of T frames); its GroupNorm is
    # mid_attn_1's as in the conv-only decoder, whose count must be equal.
    expected = dict(launch_model["per_clip"])
    expected["tattn"] += 2 * attn_blocks
    expected["fused_mlp"] += 2 * attn_blocks
    if count_modules(decoder, GroupNorm32) != count_modules(conv_only, GroupNorm32):
        raise RuntimeError("first_stage: the all decoder's GroupNorms differ from conv-only's")

    # The main path: one clip through sample_video, counts from 0.
    gen = torch.Generator("cuda").manual_seed(SEED + 90)
    batch = random_batch(gen)
    for fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.sample_video(batch, generator=gen, decoding_t=T, return_latents=True)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    check_frames("first_stage clip", out["sampled_video"].cpu(), (T, H, W, 3))
    log("first_stage_clip", time_mode=FS_TIME_MODE, video_attn_blocks=attn_blocks,
        clip_s=clip_s, engine_build_s=build_s, launches=launches, expected=expected, card=smi)
    missing = [name for name in KERNELS if name != "flash_bwd" and launches[name] == 0]
    if launches != expected or missing:
        raise RuntimeError(f"first_stage clip: launches {launches}, expected {expected}")

    # The decode on the clip's latents: kernels on against all off, and
    # against the conv-only decoder on the same weights (its keys are a
    # subset), timed in turns and by device time.
    z = out["sampled_z"].permute(0, 3, 1, 2)
    conv_only = conv_only.to(torch.bfloat16).to_empty(device="cuda").eval()
    if conv_only.load_state_dict(decoder.state_dict(), strict=False).missing_keys:
        raise RuntimeError("first_stage: the conv-only decoder's keys are not the all one's")

    def decode_all():
        return engine.decode_first_stage(z, T)

    def decode_conv_only():
        return conv_only((z / engine.scale_factor).to(torch.bfloat16), T)

    with torch.no_grad():
        dec_on = decode_all()
        with kernel_flags(**all_off):
            dec_off = decode_all()
        walls = {"all": [], "conv_only": []}
        for which in ("all", "conv_only", "conv_only", "all"):
            walls[which].append(wall_s(decode_all if which == "all" else decode_conv_only,
                                       reps=2)[1])
        dev = {which: device_profile(fn)[1] for which, fn in (("all", decode_all),
                                                              ("conv_only", decode_conv_only))}
    dec_rel = rel_l2(dec_on, dec_off)
    log("first_stage_decode", frames_rel_l2_on_off=dec_rel, tol=AB_TOL,
        wall_s={k: statistics.mean(v) for k, v in walls.items()},
        device_ms={k: ("not measured" if v is None else v) for k, v in dev.items()}, card=smi)
    if not dec_rel <= AB_TOL:
        raise RuntimeError(f"first_stage decode on vs off: {dec_rel} > {AB_TOL}")
    del out, dec_on, dec_off, conv_only, engine, decoder
    gc.collect()
    torch.cuda.empty_cache()

    # K2 at the decoder's shapes (and the UNet's at B*T = 28, for the same
    # error beside them) and K3 at C = 512; not counted as launches.
    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    cases = []
    tattn_shapes = [("vae mid", T, HL * WL, 512, 1), ("vae D=256", T, 16 * HL * WL, 256, 1)]
    tattn_shapes += [(name, BT, s, c, c // 64) for name, s, c, _ in LEVELS]
    for label, bt, s, c, heads in tattn_shapes:
        q, k, v = randn(bt, s, c), randn(bt, s, c), randn(bt, s, c)
        d = c // heads
        th = [z.reshape(bt // T, T, s, heads, d).permute(0, 2, 3, 1, 4)
              .reshape(bt // T * s, heads, T, d).contiguous() for z in (q, k, v)]
        cases.append(("tattn", f"{label} ({bt},{s},{heads}x{d})",
                      lambda q=q, k=k, v=v, h=heads: temporal_attention(q, k, v, T, h),
                      lambda q=q, k=k, v=v, h=heads: temporal_attention_plain(q, k, v, T, h),
                      lambda th=th: F.scaled_dot_product_attention(*th),
                      4 * bt * s * c * 2, 4 * bt * s * T * c))
    m, c, inner = T * HL * WL, 512, 2048
    x = randn(m, c)
    w1, b1 = randn(2 * inner, c, std=c ** -0.5), randn(2 * inner, std=0.1)
    w2, b2 = randn(c, inner, std=inner ** -0.5), randn(c, std=0.1)
    cases.append(("fused_mlp", mlp_label("vae mid", m, c, inner),
                  lambda a=(x, w1, b1, w2, b2): geglu_mlp(*a),
                  lambda a=(x, w1, b1, w2, b2): geglu_mlp_plain(*a), None,
                  2 * (2 * m * c + 3 * inner * c + 2 * inner + c), 6 * m * c * inner))
    for fn in KERNELS.values():
        fn.launches = 0
    kernel_rows = {}
    for name, label, run, plain, library, nbytes, flops in cases:
        got = run()
        torch.cuda.synchronize()
        ref = plain()
        err, err_abs = rel_l2(got, ref), max_abs(got, ref)
        ms, host_ms = cuda_ms(run)
        plain_ms = cuda_ms(plain)[0]
        lib_ms = None if library is None else cuda_ms(library)[0]
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        row = {"rel_l2": err, "max_abs_err": err_abs, "ms": ms, "host_ms": host_ms,
               "device_ms": device_ms(run), "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_device_ms": None if library is None else device_ms(library),
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
        kernel_rows[label] = row
        log("first_stage_kernel", kernel=name, shape=label, **row, card=smi)
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"first_stage {name} {label}: relative L2 {err} > {KERNEL_TOL}")
        if not torch.equal(run(), got):
            raise RuntimeError(f"first_stage {name} {label}: two calls differ")
        del got, ref
    del cases, x, w1, w2
    torch.cuda.empty_cache()

    # SD v1's kl-f8 autoencoder: a clip's frames round-tripped (the
    # posterior sampled from the generator), kernels on against all off.
    kl_gen = torch.Generator("cuda").manual_seed(SEED + 91)
    with torch.device("meta"):
        kl = instantiate_from_config({"target": "sgm.models.autoencoder.AutoencoderKL",
                                      "params": copy.deepcopy(KL_F8)})
    kl = seeded_weights_(kl.to(torch.bfloat16).to_empty(device="cuda").eval(), kl_gen)
    frames = batch["cond_frames_without_noise"].permute(0, 3, 1, 2).to(torch.bfloat16)
    noise = torch.randn(T, 4, HL, WL, generator=kl_gen, device="cuda")

    def round_trip():
        return kl.decode(kl.encode(frames, noise))

    for fn in KERNELS.values():
        fn.launches = 0
    with torch.no_grad():
        rec_on, kl_s = wall_s(round_trip, reps=2)
        kl_launches = {name: fn.launches // 2 for name, fn in KERNELS.items()}
        with kernel_flags(**all_off):
            rec_off = round_trip()
    kl_rel = rel_l2(rec_on, rec_off)
    log("first_stage_kl_f8", frames=T, wall_s=kl_s, launches=kl_launches,
        rec_rel_l2_on_off=kl_rel, tol=AB_TOL, card=smi)
    if (tuple(rec_on.shape) != (T, 3, H, W) or not kl_rel <= AB_TOL
            or not torch.isfinite(rec_on).all()):
        raise RuntimeError(f"kl-f8 round trip on vs off: {kl_rel} > {AB_TOL}")
    del rec_on, rec_off

    # One generator step and one discriminator step of the LPIPS + PatchGAN
    # loss (ndf 64, 3 layers; seeded random LPIPS weights), forward and
    # backward through the kl-f8 decoder.
    torch.manual_seed(SEED + 92)
    loss_fn = GeneralLPIPSWithDiscriminator(disc_start=0, disc_num_layers=3,
                                            regularization_weights={"kl_loss": 1e-6}).cuda()
    with torch.device("meta"):
        lpips = LPIPS()
    lp_sd = {}  # He-scaled VGG16, positive lins, as the samplers phase's
    for key, p in lpips.state_dict().items():
        t = torch.empty(p.shape, device="cuda")
        lp_sd[key] = (t.uniform_(0.05, 1.0, generator=kl_gen) if key.startswith("lin")
                      else t.normal_(0.0, (2.0 / p[0].numel()) ** 0.5 if p.dim() == 4
                                     else 0.05, generator=kl_gen))
    x = frames[:FS_LOSS_FRAMES].float()
    last = kl.decoder.conv_out.weight
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        zl = kl.encode(frames[:FS_LOSS_FRAMES], noise[:FS_LOSS_FRAMES])
    rec = kl.decode(zl, FS_LOSS_FRAMES).float()
    rec_loss = (x - rec).abs() + torch.func.functional_call(lpips, lp_sd,
                                                             (x, rec)).reshape(-1, 1, 1, 1)
    nll, _ = loss_fn.get_nll_loss(rec_loss)
    g = -loss_fn.discriminator(rec).mean()
    d_weight = adaptive_weight_from_grads(torch.autograd.grad(nll, last, retain_graph=True),
                                          torch.autograd.grad(g, last, retain_graph=True))
    loss_fn.train()
    gen_loss, gen_log = loss_fn(x, rec, optimizer_idx=0, global_step=1, d_weight=d_weight,
                                regularization_log={"kl_loss": torch.ones((), device="cuda")},
                                lpips_params=lp_sd)
    gen_loss.backward()
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    dec_grads = [p.grad for p in kl.decoder.parameters()]
    stats0 = loss_fn.discriminator.main[3].running_var.clone()
    loss_fn.discriminator.zero_grad()
    t0 = time.perf_counter()
    disc_loss, disc_log = loss_fn(x, rec.detach(), optimizer_idx=1, global_step=1,
                                  lpips_params=lp_sd)
    disc_loss.backward()
    torch.cuda.synchronize()
    disc_s = time.perf_counter() - t0
    disc_grads = [p.grad for p in loss_fn.discriminator.parameters()]
    log("first_stage_gan_loss", frames=FS_LOSS_FRAMES, generator_step_s=gen_s,
        discriminator_step_s=disc_s, d_weight=float(d_weight),
        generator_log={k: float(v) for k, v in gen_log.items()},
        discriminator_log={k: float(v) for k, v in disc_log.items()}, card=smi)
    finite = all(torch.isfinite(t).all() for t in (gen_loss, disc_loss, d_weight))
    grads_ok = (all(gr is not None and torch.isfinite(gr).all() for gr in dec_grads + disc_grads)
                and any(gr.abs().max() > 0 for gr in disc_grads))
    if not finite or not grads_ok or torch.equal(stats0,
                                                 loss_fn.discriminator.main[3].running_var):
        raise RuntimeError("first_stage GAN loss: non-finite loss or gradient, or the "
                           "discriminator step left its running statistics")
    del kl, loss_fn, rec, rec_loss, dec_grads, disc_grads, lp_sd, frames
    torch.cuda.empty_cache()

    # The quantizers at vqgan_imagenet_f16_16384 widths on a clip's f16
    # latents (T x 16 x 24 x 256).
    vq_gen = torch.Generator("cuda").manual_seed(SEED + 94)
    zq_in = torch.randn(T, H // 16, W // 16, VQ_DIM, generator=vq_gen, device="cuda")
    quantizers = {
        "VectorQuantizer": {"n_e": VQ_N_EMBED, "e_dim": VQ_DIM, "beta": 0.25},
        "VectorQuantizerWithInputProjection": {"input_dim": VQ_DIM, "n_codes": VQ_N_EMBED,
                                               "codebook_dim": VQ_DIM, "output_dim": VQ_DIM},
        "GumbelQuantizer": {"num_hiddens": VQ_DIM, "embedding_dim": VQ_DIM,
                            "n_embed": VQ_N_EMBED},
        "EMAVectorQuantizer": {"n_embed": VQ_N_EMBED, "embedding_dim": VQ_DIM, "beta": 0.25}}
    for qname, params in quantizers.items():
        torch.manual_seed(SEED + 95)
        quant = instantiate_from_config({
            "target": f"sgm.modules.autoencoding.regularizers.quantize.{qname}",
            "params": params}).cuda().train()
        zin = zq_in.clone().requires_grad_(True)
        kwargs = {"generator": vq_gen} if qname == "GumbelQuantizer" else {}
        ema0 = quant.embedding.weight.clone() if qname == "EMAVectorQuantizer" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z_q, info = quant(zin, **kwargs)
        (z_q.sum() + info["loss/vq"]).backward()
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        idx = next(info[k] for k in ("min_encoding_indices", "indices", "encoding_indices")
                   if k in info).reshape(-1)
        cpu_share = None
        if qname == "VectorQuantizer":
            rows = zq_in.reshape(-1, VQ_DIM)[:VQ_CPU_ROWS].cpu()
            book = quant.embedding.weight.detach().cpu()
            cpu_idx = ((rows ** 2).sum(1, keepdim=True) + (book ** 2).sum(1)[None]
                       - 2.0 * rows @ book.t()).argmin(1)
            cpu_share = float((cpu_idx == idx[:VQ_CPU_ROWS].cpu()).float().mean())
        log("first_stage_quantizer", quantizer=qname, shape=list(zin.shape), seconds=q_s,
            loss=float(info["loss/vq"].detach()), distinct_codes=int(idx.unique().numel()),
            indices_equal_to_cpu=cpu_share, card=smi)
        ok = (torch.isfinite(z_q).all() and torch.isfinite(zin.grad).all()
              and 0 <= int(idx.min()) and int(idx.max()) < VQ_N_EMBED
              and math.isfinite(float(info["loss/vq"].detach())))
        if ema0 is not None:
            ok = ok and not torch.equal(ema0, quant.embedding.weight) and bool(
                torch.isfinite(quant.embedding.weight).all())
        if not ok or (cpu_share is not None and cpu_share < 0.999):
            raise RuntimeError(f"first_stage {qname}: non-finite or out-of-range output, "
                               f"indices equal to the CPU's on {cpu_share}")
        del quant, zin, z_q, info
    torch.cuda.empty_cache()
    log("first_stage_done", phase_seconds=time.perf_counter() - phase_t0, card=smi)
    return launches


# The conditioning phase: the text towers at their published widths on
# COND_ROWS rows of COND_TOKENS tokens (seeded random bf16 weights, held
# against the same weights in fp32 on the card within TEXT_TOL), the
# stochastic embedders on the kl-f8 encoder, a text-conditioned clip (the
# flagship with ViT-H-14's text tower in place of its image tower), two
# VideoUNets at svd_gcd's widths with the architecture options GCD's
# configs leave off (OPTION_UNETS), and one block without self-attention
# (OPTION_BLOCK).
COND_ROWS, COND_TOKENS = BT, 77
# (label, embedder, params): CLIP ViT-L/14 (768 x 12, quick GELU),
# OpenCLIP ViT-H-14 (1024 x 24) and ViT-bigG-14 (1280 x 32), T5 v1.1 XXL
# (4096 / 10240 / 24 layers / 64 heads), ByT5-base from strings.
TEXT_EMBEDDERS = [
    ("ViT-L/14", "FrozenCLIPEmbedder", {"version": "openai/clip-vit-large-patch14"}),
    ("ViT-H-14", "FrozenOpenCLIPEmbedder", {"arch": "ViT-H-14", "layer": "penultimate"}),
    ("ViT-bigG-14", "FrozenOpenCLIPEmbedder2", {"arch": "ViT-bigG-14", "layer": "penultimate",
                                                "legacy": False, "always_return_pooled": True}),
    ("t5-v1_1-xxl", "FrozenT5Embedder", {"version": "google/t5-v1_1-xxl"}),
    ("byt5-base", "FrozenByT5Embedder", {"version": "google/byt5-base"}),
]
# Relative L2 of a tower in bf16 against the same (bf16-rounded) weights in
# fp32, each output. Written before the first run: a bf16 residual stream
# rounds each of up to 32 blocks' sums at 2^-9; 5e-2 leaves room for 32
# such roundings adding in quadrature with a margin for the softmax and
# norm inputs.
TEXT_TOL = 5e-2
OPTION_UNETS = {
    "A": {"use_scale_shift_norm": True, "resblock_updown": True,
          "use_linear_in_transformer": False, "use_spatial_context": False,
          "merge_strategy": "fixed", "video_kernel_size": 3},
    "B": {"disable_temporal_crossattention": True, "conv_resample": False,
          "extra_ff_mix_layer": True},
    # num_heads in place of num_head_channels: SD 1.x's heads of 40, 80 and
    # 160 (K2's general family at 40 and 160; K1's route: none of them).
    "heads8": {"num_heads": 8, "num_head_channels": -1},
}
# A block option the JAX VideoUNet does not pass on, run on one
# SpatialVideoTransformer at svd_gcd's ds1 width (option_block).
OPTION_BLOCK = {"disable_self_attn": True}
CLIP_BOS, CLIP_EOT, T5_EOS, T5_VOCAB = 49406, 49407, 1, 32100


def text_tokens(gen: torch.Generator, name: str):
    """COND_ROWS inputs of COND_TOKENS tokens for an embedder: CLIP's (bos,
    random word ids, eot, zero padding: the eot is each row's largest id),
    T5's (random ids, eos, padding), strings for ByT5."""
    lengths = torch.randint(8, COND_TOKENS - 1, (COND_ROWS,), generator=gen,
                            device="cuda").tolist()
    if name == "FrozenByT5Embedder":
        words = ["red", "ball", "rolls", "left", "camera", "orbits", "slowly", "around",
                 "the", "scene", "a", "cube", "falls", "onto", "floor", "blue"]
        idx = torch.randint(0, len(words), (COND_ROWS, 12), generator=gen,
                            device="cuda").tolist()
        return [" ".join(words[i] for i in row)[:n] for row, n in zip(idx, lengths)]
    clip = name != "FrozenT5Embedder"
    ids = torch.randint(1 if clip else 2, CLIP_BOS if clip else T5_VOCAB,
                        (COND_ROWS, COND_TOKENS), generator=gen, device="cuda")
    pos = torch.arange(COND_TOKENS, device="cuda")[None]
    end = torch.tensor(lengths, device="cuda")[:, None]
    ids = torch.where(pos < end, ids, torch.zeros_like(ids))
    ids = torch.where(pos == end, torch.full_like(ids, CLIP_EOT if clip else T5_EOS), ids)
    if clip:
        ids[:, 0] = CLIP_BOS
    return ids


def text_embedder_runs(smi: str, gen: torch.Generator) -> dict:
    """(a): each text embedder at its published width. Returns the ViT-H-14
    context (COND_ROWS, COND_TOKENS, 1024) for (d)."""
    import copy

    from gcd_tpu_torch.utils.config import instantiate_from_config

    context = None
    for label, name, params in TEXT_EMBEDDERS:
        with torch.device("meta"):
            emb = instantiate_from_config({"target": f"sgm.modules.encoders.modules.{name}",
                                           "params": params})
        emb = seeded_weights_(emb.to(torch.bfloat16).to_empty(device="cuda").eval(), gen)
        text = text_tokens(gen, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = emb(text)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            ms, host_ms = cuda_ms(lambda: emb(text), iters=3)
            ref = copy.deepcopy(emb).float()(text)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        errs = [rel_l2(o, r) for o, r in zip(outs, refs)]
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        params_n = sum(p.numel() for p in emb.parameters())
        log("conditioning_text", embedder=label, target=name, params=params_n,
            shapes=[list(o.shape) for o in outs], dtypes=[str(o.dtype) for o in outs],
            finite=finite, ms=ms, host_ms=host_ms, peak_mem_bytes=peak,
            rel_l2_vs_fp32=errs, tol=TEXT_TOL, card=smi)
        if not finite or not max(errs) <= TEXT_TOL or outs[0].shape[:2] != (COND_ROWS,
                                                                           COND_TOKENS):
            raise RuntimeError(f"conditioning {label}: finite {finite}, shapes "
                               f"{[tuple(o.shape) for o in outs]}, bf16 vs fp32 {errs}")
        if label == "ViT-H-14":
            context = out
        del emb, out, ref, outs, refs
        torch.cuda.empty_cache()
    return context


def stochastic_embedder_runs(smi: str, gen: torch.Generator, cfg: dict) -> None:
    """(b): GaussianEncoder and LowScaleEncoder on the conditioner's kl-f8
    encoder, a clip's frames; each K4 / K5 launch against the model (one K4
    a GroupNorm call, K5 for those on K4's split path)."""
    from gcd_tpu_torch.models.layers import GroupNorm32
    from gcd_tpu_torch.ops import KERNELS
    from gcd_tpu_torch.utils.config import instantiate_from_config

    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    dd = next(e for e in emb_models if e["target"].endswith("VideoPredictionEmbedderWithEncoder")
              )["params"]["encoder_config"]["params"]["ddconfig"]
    frames = torch.rand(T, H, W, 3, generator=gen, device="cuda") * 2.0 - 1.0
    for name, params in (("GaussianEncoder", {"ddconfig": dd}),
                         ("LowScaleEncoder", {"model_config": {"params": {
                             "embed_dim": 4, "ddconfig": dd}}})):
        with torch.device("meta"):
            emb = instantiate_from_config({"target": f"sgm.modules.encoders.modules.{name}",
                                           "params": params})
        emb = seeded_weights_(emb.to(torch.bfloat16).to_empty(device="cuda").eval(), gen)
        sites = Counter()
        for fn in KERNELS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), record_groupnorms(emb, sites):
            out = emb(frames, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in KERNELS.items()}
        encoder = emb if name == "GaussianEncoder" else emb.model.encoder
        expected = dict.fromkeys(KERNELS, 0)
        expected["fused_gn"] = count_modules(encoder, GroupNorm32)
        expected["gn_stats"] = split_calls(sites)
        z = out[0] if isinstance(out, tuple) else out
        log("conditioning_stochastic", embedder=name, shape=list(z.shape), seconds=seconds,
            launches=launches, expected=expected, finite=bool(torch.isfinite(z).all()),
            card=smi)
        if launches != expected or not torch.isfinite(z).all():
            raise RuntimeError(f"conditioning {name}: launches {launches}, expected {expected}")
        del emb, out, z
    torch.cuda.empty_cache()


@contextmanager
def record_attention_mlp_sites(module, sites: dict):
    """Record the K1 (self-attention at a kernel head dim), K2 and K3 calls
    of a module: sites[kernel][(rows, tokens, channels, heads)] or, for K3,
    [(M, C, inner)] += 1."""
    from gcd_tpu_torch.models.attention import CrossAttention, TemporalSelfAttention
    from gcd_tpu_torch.models.layers import FeedForward
    from gcd_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    def hook(mod, args, kwargs):
        x = args[0]
        if isinstance(mod, FeedForward):
            c = x.shape[-1]
            sites["fused_mlp"][(x.numel() // c, c, mod.net[2].in_features)] += 1
        elif isinstance(mod, TemporalSelfAttention):
            sites["tattn"][(x.shape[0], x.shape[1], mod.heads * mod.dim_head, mod.heads)] += 1
        elif (len(args) < 2 or args[1] is None) and kwargs.get("context") is None \
                and mod.dim_head in KERNEL_HEAD_DIMS:
            sites["flash"][(x.shape[0], x.shape[1], mod.heads * mod.dim_head, mod.heads)] += 1

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in module.modules()
               if isinstance(m, (CrossAttention, TemporalSelfAttention, FeedForward))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def unet_launch_model(unet, gn_sites: Counter) -> dict:
    """One evaluation's launches of a VideoUNet from its modules: K1 a
    spatial block whose attn1 attends to itself at a head size K1 takes
    (others take ops/basic.dot_product_attention), K2 a temporal block's
    attention over the frames (attn1, and attn2 where it has no context),
    K3 a feed-forward, K7 a fused GroupNorm -> SiLU -> 3x3 chain, K4 every
    other GroupNorm, K5 those of K4's split path (`gn_sites`, the recorded
    calls) and one a K7."""
    from gcd_tpu_torch.models.attention import BasicTransformerBlock, TemporalSelfAttention
    from gcd_tpu_torch.models.layers import FeedForward, GroupNorm32
    from gcd_tpu_torch.models.video_attention import VideoTransformerBlock
    from gcd_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    k7 = gn_conv_modules(unet)
    temporal = sum(isinstance(getattr(m, a, None), TemporalSelfAttention)
                   for m in unet.modules() if isinstance(m, VideoTransformerBlock)
                   for a in ("attn1", "attn2"))
    return {"flash": sum(not m.disable_self_attn and m.attn1.dim_head in KERNEL_HEAD_DIMS
                         for m in unet.modules() if isinstance(m, BasicTransformerBlock)),
            "flash_bwd": 0, "tattn": temporal, "fused_mlp": count_modules(unet, FeedForward),
            "fused_gn": count_modules(unet, GroupNorm32) - k7,
            "gn_stats": split_calls(gn_sites) + k7, "fused_gn_conv": k7}


def phase4_shapes() -> dict:
    """The K1, K2 and K3 shapes phase 4 holds (attention_mlp_cases) at the
    clip's T."""
    rows = (BT, T, SERVE_BATCH * BT)
    return {"flash": {(b, s, c, c // 64) for b in rows for _, s, c, _ in LEVELS}
            | {(BT, 384, 640, 5)},
            "tattn": {(b, s, c, c // 64) for b in rows for _, s, c, _ in LEVELS}
            | {(BT, 1536, 320, 8), (BT, 96, 1280, 8)},
            "fused_mlp": {(b * s, c, 4 * c) for b in rows for _, s, c, _ in LEVELS}}


def new_site_cases(gen: torch.Generator, sites: dict):
    """Cases (attention_mlp_cases' form, 0 launches a clip) for the K1, K2
    and K3 sites that phase 4 does not hold."""
    from gcd_tpu_torch.ops import (flash_attention, flash_attention_plain, geglu_mlp,
                                   geglu_mlp_plain, temporal_attention, temporal_attention_plain)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    held = phase4_shapes()
    for name in ("flash", "tattn"):
        for b, s, c, heads in sorted(set(sites[name]) - held[name]):
            q, k, v = randn(b, s, c), randn(b, s, c), randn(b, s, c)
            fn, plain = ((flash_attention, flash_attention_plain) if name == "flash"
                         else (lambda *a: temporal_attention(*a[:3], T, a[3]),
                               lambda *a: temporal_attention_plain(*a[:3], T, a[3])))
            ops = 4 * b * s * (s if name == "flash" else T) * c
            yield (name, f"({b},{s},{c}) heads={heads}", 0,
                   lambda a=(q, k, v, heads), f=fn: f(*a),
                   lambda a=(q, k, v, heads), f=plain: f(*a), None,
                   4 * b * s * c * 2, ops, BF16_FLOPS)
    for m, c, inner in sorted(set(sites["fused_mlp"]) - held["fused_mlp"]):
        x = randn(m, c)
        w = (randn(2 * inner, c, std=c ** -0.5), randn(2 * inner, std=0.1),
             randn(c, inner, std=inner ** -0.5), randn(c, std=0.1))
        yield ("fused_mlp", mlp_label("option", m, c, inner), 0,
               lambda a=(x, *w): geglu_mlp(*a), lambda a=(x, *w): geglu_mlp_plain(*a), None,
               2 * (2 * m * c + 3 * inner * c + 2 * inner + c), 6 * m * c * inner, BF16_FLOPS)


def option_block(base: dict):
    """svd_gcd's ds1 SpatialVideoTransformer with OPTION_BLOCK."""
    from gcd_tpu_torch.models.video_attention import SpatialVideoTransformer

    ch, d_head = base["model_channels"], base["num_head_channels"]
    depth = base["transformer_depth"]
    return SpatialVideoTransformer(
        ch, ch // d_head, d_head, depth if isinstance(depth, int) else depth[0],
        base["context_dim"], ff_in=base["extra_ff_mix_layer"],
        merge_strategy=base["merge_strategy"], use_spatial_context=base["use_spatial_context"],
        use_linear=base["use_linear_in_transformer"], **OPTION_BLOCK)


def option_unet_runs(smi: str, gen: torch.Generator, cfg: dict, context: torch.Tensor,
                     phase6: dict) -> dict:
    """(d): one evaluation of each OPTION_UNETS network at svd_gcd's widths
    on B*T = 28 rows of 32 x 48 latents and (a)'s 77-token context, and of
    option_block on the ds1 tokens: kernels on vs off within AB_TOL,
    launches against unet_launch_model, device ms by kernel; then every
    kernel case at a shape or flag phase 4 does not hold against its plain
    version (KERNEL_TOL), bit-identical on a second call. Returns {network:
    launches}."""
    from gcd_tpu_torch.models.unet import VideoUNet
    from gcd_tpu_torch.ops import KERNELS, kernel_flags

    base = cfg["params"]["network_config"]["params"]
    y_dim = base["adm_in_channels"] + base.get("aux_emb_dim", 0)
    x = torch.randn(BT, HL, WL, base["in_channels"], generator=gen,
                    device="cuda").permute(0, 3, 1, 2).to(torch.bfloat16)
    sigma_noise = torch.randn(BT, generator=gen, device="cuda")
    y = torch.randn(BT, y_dim, generator=gen, device="cuda").to(torch.bfloat16)
    ioi = torch.zeros(BT // T, T, device="cuda")
    tokens = torch.randn(BT, base["model_channels"], HL, WL, generator=gen,
                         device="cuda").to(torch.bfloat16)
    all_off = dict.fromkeys(KERNELS, False)
    runs, new_gn, new_k7 = {}, Counter(), Counter()
    attn_sites = {k: Counter() for k in ("flash", "tattn", "fused_mlp")}
    networks = [(label, options, lambda o=options: VideoUNet(**{**base, **o}),
                 lambda net: net(x, sigma_noise, context, y, num_video_frames=T,
                                 image_only_indicator=ioi))
                for label, options in OPTION_UNETS.items()]
    networks.append(("block", OPTION_BLOCK, lambda: option_block(base),
                     lambda net: net(tokens, context, T, ioi)))
    for label, options, build, call in networks:
        with torch.device("meta"):
            unet = build()
        unet = seeded_weights_(unet.to(torch.bfloat16).to_empty(device="cuda").eval(), gen)

        def evaluate(unet=unet, call=call):
            return call(unet)

        gn_sites, k7_sites = Counter(), Counter()
        with torch.no_grad():
            evaluate()  # warm
            for fn in KERNELS.values():
                fn.launches = 0
            torch.cuda.synchronize()
            with record_groupnorms(unet, gn_sites), record_gn_conv_sites(unet, k7_sites), \
                    record_attention_mlp_sites(unet, attn_sites):
                on = evaluate()
            torch.cuda.synchronize()
            launches = {n: fn.launches for n, fn in KERNELS.items()}
            with kernel_flags(**all_off):
                off = evaluate()
            by_name, total = device_profile(evaluate)
            _, wall = wall_s(evaluate, reps=2)
        expected = unet_launch_model(unet, gn_sites)
        err = rel_l2(on, off)
        kernels_ms = None if by_name is None else {
            name: sum(v for k, v in by_name.items() if any(t in k for t in tags))
            for name, tags in PROFILE_TAGS.items()}
        log("conditioning_option_unet", unet=label, options=options,
            params=sum(p.numel() for p in unet.parameters()), launches=launches,
            expected=expected, rel_l2_on_off=err, tol=AB_TOL, wall_s=wall,
            device_ms="not measured" if total is None else total, kernels_ms=kernels_ms,
            card=smi)
        if launches != expected or not err <= AB_TOL or not torch.isfinite(on).all():
            raise RuntimeError(f"option UNet {label}: launches {launches}, expected "
                               f"{expected}, on vs off {err}")
        runs[label] = launches
        for site, n in gn_sites.items():
            if site not in phase6["held_gn"]:
                new_gn[site] += 0
        for site in k7_sites:
            if site not in phase6["held_k7"]:
                new_k7[site] += 0
        del unet, on, off
        torch.cuda.empty_cache()

    variants = {}
    cases = list(itertools.chain(new_site_cases(gen, attn_sites),
                                 groupnorm_cases(gen, new_gn, variants),
                                 gn_conv_cases(gen, new_k7)))
    for name, label, _, run, plain, library, nbytes, flops, peak in cases:
        got = run()
        torch.cuda.synchronize()
        ref = plain()
        err, err_abs = rel_l2(got, ref), max_abs(got, ref)
        ms, host_ms = cuda_ms(run)
        b_ms, b_by = bound(nbytes, flops, peak)
        log("conditioning_kernel", kernel=name, shape=label,
            variant=variants.get(label), rel_l2=err, max_abs_err=err_abs, ms=ms,
            host_ms=host_ms, device_ms=device_ms(run), plain_ms=cuda_ms(plain)[0],
            library_ms=None if library is None else cuda_ms(library)[0], bound_ms=b_ms,
            bound_by=b_by, card=smi)
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"conditioning {name} {label}: relative L2 {err} > {KERNEL_TOL}")
        if rel_l2(run(), got) != 0.0:
            raise RuntimeError(f"conditioning {name} {label}: two calls differ")
        del got, ref
    log("conditioning_kernel_cases", cases=len(cases), card=smi)
    return runs


def conditioning_phase(smi: str, launch_model: dict, phase6: dict) -> tuple:
    """The conditioning phase (module docstring): (a) the text towers, (b)
    the stochastic embedders, (c) a text-conditioned clip through
    sample_video, (d) the option UNets and block. Returns (the clip's
    launches, the option networks' launches summed)."""
    import copy

    from gcd_tpu_torch.engine.build import engine_from_config
    from gcd_tpu_torch.ops import KERNELS, kernel_flags
    from gcd_tpu_torch.utils.config import load_config

    phase_t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SEED + 100)
    context = text_embedder_runs(smi, gen)
    cfg = copy.deepcopy(load_config(CONFIG)["model"])
    stochastic_embedder_runs(smi, gen, cfg)

    # (c) The flagship with ViT-H-14's text tower in place of its CLIP
    # image embedder: a (B*T, 77, 1024) crossattn, one request of 25
    # Euler-EDM steps with CFG, kernels on and all off.
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    emb_models[0] = {"input_key": "txt", "is_trainable": False,
                     "target": "sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder",
                     "params": {"arch": "ViT-H-14", "layer": "penultimate"}}
    t0 = time.perf_counter()
    engine = engine_from_config(cfg)
    build_s = time.perf_counter() - t0
    frames, clip_s = {}, {}
    for which in ("on", "off"):
        cgen = torch.Generator("cuda").manual_seed(SEED + 101)
        batch = random_batch(cgen)
        batch["txt"] = text_tokens(cgen, "FrozenOpenCLIPEmbedder")[:T]
        for fn in KERNELS.values():
            fn.launches = 0
        with kernel_flags(**(dict.fromkeys(KERNELS, False) if which == "off" else {})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.sample_video(batch, generator=cgen, decoding_t=T)
            torch.cuda.synchronize()
        clip_s[which] = time.perf_counter() - t0
        frames[which] = out["sampled_video"]
        if which == "on":
            launches = {name: fn.launches for name, fn in KERNELS.items()}
            with torch.no_grad():
                c, _ = engine.get_unconditional_conditioning(batch, UC_KEYS)
    expected = launch_model["per_clip"]
    check_frames("text clip", frames["on"].cpu().numpy(), (T, H, W, 3))
    clip_rel = rel_l2(frames["on"], frames["off"])
    log("conditioning_text_clip", crossattn=list(c["crossattn"].shape), clip_s=clip_s,
        phase6_clip_s=phase6["clip_s"], engine_build_s=build_s, launches=launches,
        expected=expected, frames_rel_l2_on_off=clip_rel, tol=AB_TOL, card=smi)
    if (tuple(c["crossattn"].shape) != (T, COND_TOKENS, 1024) or launches != expected
            or not clip_rel <= AB_TOL):
        raise RuntimeError(f"text clip: crossattn {tuple(c['crossattn'].shape)}, launches "
                           f"{launches} (expected {expected}), on vs off {clip_rel}")

    # The `num_heads: 8` VideoUNet (OPTION_UNETS["heads8"], seeded) in place
    # of the flagship's: one 25-step clip of the same request. Its launches
    # are the text clip's but K1's: its heads of 40 / 80 / 160 take plain
    # attention, K2 its general family at 40 and 160.
    from gcd_tpu_torch.models.unet import VideoUNet

    with torch.device("meta"):
        heads8 = VideoUNet(**{**cfg["params"]["network_config"]["params"],
                              **OPTION_UNETS["heads8"]})
    engine.model.diffusion_model = seeded_weights_(
        heads8.to(torch.bfloat16).to_empty(device="cuda").eval(), gen)
    cgen = torch.Generator("cuda").manual_seed(SEED + 101)
    batch = random_batch(cgen)
    batch["txt"] = text_tokens(cgen, "FrozenOpenCLIPEmbedder")[:T]
    for fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.sample_video(batch, generator=cgen, decoding_t=T)
    torch.cuda.synchronize()
    heads8_s = time.perf_counter() - t0
    heads8_launches = {name: fn.launches for name, fn in KERNELS.items()}
    heads8_expected = dict(expected, flash=0)
    check_frames("heads8 clip", out["sampled_video"].cpu().numpy(), (T, H, W, 3))
    log("conditioning_heads8_clip", clip_s=heads8_s, text_clip_s=clip_s["on"],
        launches=heads8_launches, expected=heads8_expected,
        frames_std=float(out["sampled_video"].float().std()), card=smi)
    if heads8_launches != heads8_expected:
        raise RuntimeError(f"heads8 clip: launches {heads8_launches}, expected "
                           f"{heads8_expected}")
    del engine, out, frames, c, heads8
    gc.collect()
    torch.cuda.empty_cache()

    options = option_unet_runs(smi, gen, cfg, context, phase6)
    del context
    torch.cuda.empty_cache()
    log("conditioning_done", phase_seconds=time.perf_counter() - phase_t0, card=smi)
    return launches, {name: sum(run[name] for run in options.values()) for name in KERNELS}


def op_cases(gen: torch.Generator):
    """(op, main-path arguments) of each gcd:: op on the card: K1 / K6 / K2
    at ds1 (B*T = 28), K3 at ds1, K4 at the per-frame site (channels-last)
    and the time_stack view (channels_last_3d), K5 there, K4's apply from
    sums, K7 at ds1."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    cl, cl3 = torch.channels_last, torch.channels_last_3d
    q, k, v, do = (randn(BT, 1536, 320) for _ in range(4))
    x4 = randn(BT, 320, 32, 48).contiguous(memory_format=cl)
    x5 = randn(2, 320, T, 32, 48).contiguous(memory_format=cl3)
    wt, bs = 1.0 + 0.1 * randn(320), 0.1 * randn(320)
    sums = torch.rand(2, BT, G, generator=gen, device="cuda") * torch.tensor(
        [1.0, 4.0], device="cuda")[:, None, None] * 480
    ops = torch.ops.gcd
    return [
        (ops.flash_attention.default, (q, k, v, 5, None)),
        (ops.flash_attention_bwd.default, (q, k, v, do, 5, None)),
        (ops.temporal_attention.default, (q, k, v, T, 5, None)),
        (ops.geglu_mlp.default, (randn(BT * 1536, 320), randn(2560, 320) * 0.05, randn(2560),
                                 randn(320, 1280) * 0.03, randn(320))),
        (ops.group_norm.default, (x4, wt, bs, G, 1e-5, True, True)),
        (ops.group_norm.default, (x5, wt, bs, G, 1e-6, False, True)),
        (ops.group_stats.default, (x5, G)),
        (ops.group_norm_from_sums.default, (x4, wt, bs, G, 1e-5, True, sums[0], sums[1], 480)),
        (ops.gn_silu_conv3x3.default, (x4, wt, bs, randn(320, 320, 3, 3).contiguous(
            memory_format=cl) * 0.02, randn(320), G, 1e-5, True, True)),
    ]


def export_phase(smi: str, phase6: dict, served_run: dict) -> tuple:
    """The exported sampler (engine/export.py) at full width: each gcd:: op's
    fake implementation against its kernel's output on the card
    (torch.library.opcheck's fake-tensor test); then export_sampler on a
    fresh load_engine (phase 6's seeded weights) and phase 6's first
    request, to bytes and back through load_sampler, and the artifact run on
    that request with its generator's noise: the frames finite in [0, 1],
    within 2e-2 of phase 6's (bit-identical or not, logged), each kernel's
    launches a clip phase 6's; export, load and clip seconds beside phase
    6's, the artifact's MB, and one step program's device ms beside the
    eager step's; then `served_artifact` on the same engine. Returns the
    launches over the artifact's first clip and over the served
    artifact's requests."""
    from gcd_tpu_torch.engine.build import load_engine
    from gcd_tpu_torch.engine.export import export_sampler, initial_latents, load_sampler
    from gcd_tpu_torch.ops import KERNELS

    phase_t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SEED + 80)
    for op, args in op_cases(gen):
        torch.library.opcheck(op, args, test_utils="test_faketensor")
        out = op(*args)
        log("export_fake", op=str(op), strides=[list(o.stride()) for o in (
            out if isinstance(out, tuple) else (out,))], card=smi)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = load_engine(CONFIG)
    engine_s = time.perf_counter() - t0
    params = engine.state_dict()
    weight_bytes = sum(p.numel() * p.element_size() for p in engine.parameters())
    gen = torch.Generator("cuda").manual_seed(SEED + 10)
    batch = random_batch(gen)
    t0 = time.perf_counter()
    blob = export_sampler(engine, params, batch, decoding_t=T)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample = load_sampler(blob)
    load_s = time.perf_counter() - t0
    log("export_artifact", export_seconds=export_s, load_seconds=load_s,
        artifact_mb=len(blob) / 1e6, weights_mb=weight_bytes / 1e6, engine_seconds=engine_s,
        programs=sorted(sample.programs), card=smi)
    if len(blob) >= weight_bytes:
        raise RuntimeError(f"artifact of {len(blob)} bytes holds the weights ({weight_bytes})")

    clip_s, launches, frames = [], None, None
    for rep in range(CLIPS):
        for fn in KERNELS.values():
            fn.launches = 0
        gen = torch.Generator("cuda").manual_seed(SEED + 10)
        batch = random_batch(gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(params, batch, generator=gen)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
        if rep == 0:
            launches = {name: fn.launches for name, fn in KERNELS.items()}
            frames = out["sampled_video"].cpu()
    check_frames("export", frames, (T, H, W, 3))
    same = torch.equal(frames, phase6["frames"])
    err = rel_l2(frames, phase6["frames"])

    # One step program against the eager step on the same inputs.
    programs, header = sample.programs, sample.header
    weights = programs["step"].weights(params)
    cond = programs["cond"](programs["cond"].weights(params), *[batch[k] for k in header["keys"]])
    n = len(header["cond_keys"])
    x = initial_latents(engine.latent_noise(batch["cond_frames"], gen), header["init_scale"])
    ladder = torch.tensor(header["sigmas"], device="cuda")
    ioi = batch["image_only_indicator"]
    c, uc = dict(zip(header["cond_keys"], cond[:n])), dict(zip(header["cond_keys"], cond[n:2 * n]))

    def exported_step():
        return programs["step"](weights, x, ladder[0], ladder[1], ioi, *cond[:2 * n])

    def eager_step():
        evaluate = engine.sampler.evaluator(engine.sampling_denoiser(ioi), c, uc)
        return engine.sampler.step(evaluate, x, ladder[0], ladder[1], True)

    with torch.no_grad():
        step_same = torch.equal(exported_step(), eager_step())
        step_ms = {"exported": device_ms(exported_step, iters=3),
                   "eager": device_ms(eager_step, iters=3)}
        step_wall = {"exported": wall_s(exported_step)[1], "eager": wall_s(eager_step)[1]}
    log("export", bit_identical_to_phase6=same, rel_l2=err, tol=AB_TOL, launches=launches,
        expected_per_clip=phase6["expected"], clip_seconds=clip_s,
        phase6_clip_seconds=phase6["clip_s"], step_device_ms=step_ms, step_wall_s=step_wall,
        step_bit_identical=step_same, phase_seconds=time.perf_counter() - phase_t0, card=smi)
    del sample, programs, weights, cond, x
    gc.collect()
    torch.cuda.empty_cache()
    if not err <= AB_TOL or launches != phase6["expected"]:
        raise RuntimeError(f"export: frames relative L2 {err} (tol {AB_TOL}), launches "
                           f"{launches}, expected {phase6['expected']}")
    artifact_launches = served_artifact(engine, params, smi, served_run)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, artifact_launches


def served_artifact(engine, params: dict, smi: str, served_run: dict) -> dict:
    """The export phase's served part: the engine exported for the served
    batch (SERVE_BATCH of the served requests' arrays) to a file, booted as
    gcd_tpu_torch.serve --artifact boots it (serve.py load_artifact), and
    the served phase's four requests with their seeds through the HTTP
    handler: frames within SERVE_TOL of the eager server's (bit-identical
    or not, logged), each kernel's launches the eager server's. Returns the
    launches over the four requests."""
    from gcd_tpu_torch.engine.export import export_sampler
    from gcd_tpu_torch.engine.server import _concat_requests
    from gcd_tpu_torch.serve import load_artifact

    t_phase = time.perf_counter()
    requests = served_run["requests"]
    pair = _concat_requests([{k: v for k, v in r.items() if k != "seed"}
                             for r in requests[:SERVE_BATCH]], SERVE_BATCH)
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
             for k, v in pair.items()}
    work = tempfile.mkdtemp(prefix="gcd_artifact_")
    try:
        path = os.path.join(work, "served.gcdexp")
        t0 = time.perf_counter()
        blob = export_sampler(engine, params, batch, decoding_t=T)
        export_s = time.perf_counter() - t0
        with open(path, "wb") as f:
            f.write(blob)
        t0 = time.perf_counter()
        fn, check = load_artifact(path, params, SERVE_BATCH, T, (H, W))
        load_s = time.perf_counter() - t0
        run = serve_requests(fn, requests, check)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    errs = [rel_l2(torch.from_numpy(g), torch.from_numpy(w))
            for g, w in zip(run["frames"], served_run["frames"])]
    same = all(np.array_equal(g, w) for g, w in zip(run["frames"], served_run["frames"]))
    log("served_artifact", bit_identical_to_served=same, rel_l2=errs, tol=SERVE_TOL,
        launches=run["launches"], served_launches=served_run["launches"],
        served_frames_per_s=SERVE_REQUESTS * T / run["wall_s"],
        eager_served_frames_per_s=served_run["frames_per_s"], export_seconds=export_s,
        load_seconds=load_s, artifact_mb=len(blob) / 1e6, counts=run["counts"],
        peak_mem_bytes=run["peak_mem_bytes"], seconds=time.perf_counter() - t_phase, card=smi)
    for f in run["frames"]:
        check_frames("served artifact", torch.from_numpy(f), (T, H, W, 3))
    if not all(e <= SERVE_TOL for e in errs) or run["launches"] != served_run["launches"] \
            or run["counts"] != (SERVE_REQUESTS // SERVE_BATCH, SERVE_REQUESTS):
        raise RuntimeError(f"served artifact: frames {errs} (tol {SERVE_TOL}), launches "
                           f"{run['launches']} against {served_run['launches']}, counts "
                           f"{run['counts']}")
    return run["launches"]


def post_npz(url: str, arrays: dict, timeout: float = 600.0) -> dict:
    """POST an .npz to `url`; the answer's arrays. A non-200 answer raises."""
    import io
    import urllib.request

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise RuntimeError(f"POST {url}: HTTP {resp.status}")
        out = np.load(io.BytesIO(resp.read()))
        return {k: out[k] for k in out.files}


def serve_requests(fn, requests: list, check=None, mesh_device=None) -> dict:
    """`requests` (POST bodies) sent concurrently, SERVE_STAGGER_S apart, to
    the HTTP handler of gcd_tpu_torch.serve over SamplerServer(fn,
    max_batch=SERVE_BATCH) on 127.0.0.1; then GET /healthz. The stagger
    makes them arrive in order, so every run forms the same batches (a
    request's frames depend on its batch-mates in the last bits). Returns
    the answers' frames, the wall seconds of the requests, the kernels'
    launches over them, the peak memory, the health report and the
    server's counters."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    from gcd_tpu_torch.engine.server import SamplerServer
    from gcd_tpu_torch.ops import KERNELS
    from gcd_tpu_torch.serve import make_handler

    srv = SamplerServer(fn, T, max_batch=SERVE_BATCH, max_wait_ms=2000.0, check=check,
                        mesh_device=mesh_device).start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv, T))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for kernel in KERNELS.values():
            kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        def post(i):
            time.sleep(i * SERVE_STAGGER_S)
            return post_npz(f"{url}/sample", requests[i])

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            outs = list(pool.map(post, range(len(requests))))
        wall = time.perf_counter() - t0
        launches = {name: kernel.launches for name, kernel in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    return {"frames": [o["sampled_video"] for o in outs], "wall_s": wall, "launches": launches,
            "peak_mem_bytes": peak, "healthz": health,
            "counts": (srv.batches_run, srv.requests_served)}


def served_requests(engine) -> list:
    """The served phase's four requests: random clips and SERVE_MOVES'
    camera moves through construct_batch, each with its seed."""
    from gcd_tpu_torch.engine.bundle import ModelBundle, camera_metadata, construct_batch
    from gcd_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    bundle = ModelBundle(engine=engine, train_config=None, test_config=cfg, model_name="random",
                         **camera_metadata(None, cfg))
    rng = np.random.default_rng(SEED + 30)
    requests = []
    for i, (az, el, radius) in enumerate(SERVE_MOVES[:SERVE_REQUESTS]):
        clip = construct_batch(rng.uniform(size=(T, H, W, 3)).astype(np.float32), az, el,
                               radius, T, 5, 127, 0.02, False, bundle, rng=rng)
        clip.pop("num_video_frames")
        requests.append(dict(clip, seed=np.int64(SEED + 40 + i)))
    return requests


def served(engine, smi: str, per_batch: dict) -> dict:
    """The served phase: four concurrent HTTP requests through
    SamplerServer(max_batch=2) on the engine of phases 3-6, then request 0
    alone, then one batch timed with K7 on and off. Returns the requests,
    their frames, the launches of the two batches and the served frames/s.
    `per_batch` is the expected launches per served batch (one UNet pass
    of 25 evaluations)."""
    from gcd_tpu_torch.engine.server import _concat_requests, make_engine_sample_fn
    from gcd_tpu_torch.ops import KERNELS, _native, kernel_flags

    sample_fn = make_engine_sample_fn(engine, SERVE_BATCH, T, decoding_t=T)
    batch_s = []

    def timed(batch, seeds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample_fn(batch, seeds)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    timed(engine.example_batch((H, W), T, SERVE_BATCH), [0] * SERVE_BATCH)  # warm-up
    warm_s = time.perf_counter() - t0
    batch_s.clear()
    requests = served_requests(engine)
    run = serve_requests(timed, requests)
    wall, launches, peak, health, counts = (run["wall_s"], run["launches"],
                                            run["peak_mem_bytes"], run["healthz"], run["counts"])
    frames = run["frames"]
    lone = serve_requests(timed, requests[:1])["frames"][0]
    batches = SERVE_REQUESTS // SERVE_BATCH
    expected = {name: batches * n for name, n in per_batch.items()}
    lone_err = float(np.linalg.norm(lone - frames[0]) / np.linalg.norm(frames[0]))

    # What the default costs end to end: the first batch again, straight
    # through make_engine_sample_fn, with K7 on and off.
    with kernel_flags(fused_gn_conv=False):
        sample_fn_k7_off = make_engine_sample_fn(engine, SERVE_BATCH, T, decoding_t=T)
    pair = _concat_requests([{k: v for k, v in r.items() if k != "seed"}
                             for r in requests[:SERVE_BATCH]], SERVE_BATCH)
    pair_seeds = [int(r["seed"]) for r in requests[:SERVE_BATCH]]
    k7_s = {"on": [], "off": []}
    k7_frames = {}
    for which in ("on", "off"):
        fn = sample_fn if which == "on" else sample_fn_k7_off
        KERNELS["fused_gn_conv"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k7_frames[which] = fn(pair, pair_seeds)["sampled_video"]
        torch.cuda.synchronize()
        k7_s[which].append(time.perf_counter() - t0)
        if (KERNELS["fused_gn_conv"].launches == 0) != (which == "off"):
            raise RuntimeError(f"K7 {which}: {KERNELS['fused_gn_conv'].launches} launches")
    k7_err = rel_l2(k7_frames["on"], k7_frames["off"])
    log("served_k7_ab", batch_seconds=k7_s, on_over_off=statistics.mean(k7_s["on"])
        / statistics.mean(k7_s["off"]), frames_rel_l2=k7_err, tol=SERVE_TOL, card=smi)
    if not k7_err <= SERVE_TOL:
        raise RuntimeError(f"served batch, K7 on vs off: {k7_err} > {SERVE_TOL}")
    log("served", batch_seconds=batch_s[:batches], lone_batch_seconds=batch_s[batches:],
        warmup_seconds=warm_s, requests_wall_s=wall,
        served_frames_per_s=SERVE_REQUESTS * T / wall, peak_mem_bytes=peak,
        # Device memory the kernels' per-stream scratch (K3's h, K5's
        # tickets and partials) holds after the served batches.
        stream_scratch_bytes=sum(b.numel() * b.element_size()
                                 for b in _native._scratch.values()),
        batch_frames=SERVE_BATCH * T, unet_batch=2 * SERVE_BATCH * T,
        batches_run=counts[0], requests_served=counts[1], healthz=health,
        lone_rel_l2=lone_err, tol=SERVE_TOL, launches=launches, expected=expected,
        frames_std=[float(f.std()) for f in frames], card=smi)
    for f in frames:
        if f.shape != (T, H, W, 3) or not (np.isfinite(f).all() and f.min() >= 0
                                            and f.max() <= 1):
            raise RuntimeError(f"served frames {f.shape} not finite in [0, 1]")
    if counts != (batches, SERVE_REQUESTS) or not health.get("ok"):
        raise RuntimeError(f"batches_run, requests_served {counts}, healthz {health}")
    if not lone_err <= SERVE_TOL:
        raise RuntimeError(f"request 0 alone vs batched: {lone_err} > {SERVE_TOL}")
    if launches != expected:
        raise RuntimeError(f"served launches {launches}, expected {expected}")
    return {"requests": requests, "frames": frames, "launches": launches,
            "frames_per_s": SERVE_REQUESTS * T / wall, "batch_s": batch_s[:batches]}


# The samplers phase: the sgm sampling family on phase 6's engine. (a) each
# sampler of SAMPLER_RUNS at the config's 25 steps with its
# LinearPredictionGuider; (b) the guiders and DiscreteDenoiser's scalings at
# PLAIN_STEPS steps; (c) one served batch of Euler-ancestral; (d) LPIPS in
# validation_metrics; (e) InceptionV3's features of a clip.
SAMPLING = "sgm.modules.diffusionmodules.sampling."
# (name, extra sampler params); EDMSampler churns the steps of sigma in
# [0.5, 50] of the 700 ... 0.002 ladder.
SAMPLER_RUNS = [("EDMSampler", {"s_churn": 5.0, "s_tmin": 0.5, "s_tmax": 50.0}),
                ("HeunEDMSampler", {}), ("EulerAncestralSampler", {}),
                ("DPMPP2SAncestralSampler", {}), ("DPMPP2MSampler", {}),
                ("LinearMultistepSampler", {"order": 4})]
PLAIN_STEPS = 3
# The sampler (a) also exports and runs as an artifact: two evaluations a
# step, the Euler-only last step and per-step noise from the generator.
EXPORTED_SAMPLER = "DPMPP2SAncestralSampler"
DDPM_LADDER = {"target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"}
SCALINGS = ("EDMScaling", "EpsScaling", "VScaling", "DumbScaling")
METRIC_TOL = 1e-4  # relative, the card's fp32 (TF32 off) LPIPS / features against the CPU's
# The runs whose repeat is profiled (device ms): the profiler slows a
# 25-step clip several-fold (≈ 14 s), so none of (a), and (b)'s 14-row and
# 28-row guiders.
PROFILED_RUNS = ("IdentityGuider", "VanillaCFG")


def samplers_phase(engine, smi: str, launch_model: dict, per_batch: dict) -> dict:
    """The samplers phase on phase 6's engine (its sampler and denoiser
    swapped in memory, restored after): every clip's frames finite in
    [0, 1] of (T, H, W, 3), its UNet evaluations (a forward hook on the
    UNet) those of the sampler's host plan, 25 or 49 in (a), each of 28 rows
    (CFG) or 14 (IdentityGuider), each kernel's launches the conditioner's
    and the decode's plus those of each evaluation at its rows (phase 4's
    per-evaluation counts), and the same seed twice bit-identical; wall s
    a clip, and profiled device ms of PROFILED_RUNS' repeats. Returns the
    kernels' launches over the phase's counted runs."""
    import copy

    from gcd_tpu_torch.engine.export import export_sampler, load_sampler
    from gcd_tpu_torch.engine.server import make_engine_sample_fn
    from gcd_tpu_torch.models.inception import InceptionV3
    from gcd_tpu_torch.models.lpips import LPIPS
    from gcd_tpu_torch.ops import KERNELS
    from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

    phase_t0 = time.perf_counter()
    base = load_config(CONFIG)["model"]["params"]["sampler_config"]
    sampler0, denoiser0 = engine.sampler, engine.denoiser
    per_eval, outside = launch_model["per_eval"], launch_model["outside_unet"]
    total = Counter()
    rows = []
    hook = engine.model.diffusion_model.register_forward_pre_hook(
        lambda module, args: rows.append(int(args[0].shape[0])))

    def counted(fn):
        for kernel in KERNELS.values():
            kernel.launches = 0
        rows.clear()
        out = fn()
        launches = {name: kernel.launches for name, kernel in KERNELS.items()}
        total.update(launches)
        return out, launches, list(rows)

    def expected(evals: list, outside_launches: dict) -> dict:
        # 56 rows (a served pair) launch as 28 do: phase 6 checks that K4's
        # split rule splits the same calls at the doubled N.
        return {name: outside_launches[name] + sum(per_eval[BT if n > T else T][name]
                                                   for n in evals)
                for name in KERNELS}

    def clip(label: str, sampler_cfg: dict, steps: int, seed: int, denoiser_cfg=None,
             want_evals=None, repeat: bool = True) -> tuple:
        # Returns the first clip's frames, launches and seconds.
        engine.sampler = instantiate_from_config(copy.deepcopy(sampler_cfg))
        engine.denoiser = (instantiate_from_config(denoiser_cfg) if denoiser_cfg
                           else denoiser0)
        plan = engine.sampler.guided_evaluations(steps)
        doubled = type(engine.sampler.guider).__name__ != "IdentityGuider"
        want_rows = [2 * T if g and doubled else T for step in plan for g in step]
        frames, secs, device = [], [], None
        for rep in range(2 if repeat else 1):
            gen = torch.Generator("cuda").manual_seed(seed)
            batch = random_batch(gen)

            def run():
                return engine.sample_video(batch, generator=gen, num_steps=steps,
                                           decoding_t=T)["sampled_video"]

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rep == 0:
                out, launches, got_rows = counted(run)
            elif label in PROFILED_RUNS:  # the repeat under the profiler: device ms
                box = {}
                _, device = device_profile(lambda: box.setdefault("out", run()), warm=False)
                out = box["out"]
            else:
                out = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            frames.append(out)
        want = expected(got_rows, outside)
        same = torch.equal(frames[0], frames[1]) if repeat else None
        log("samplers", run=label, sampler=type(engine.sampler).__name__,
            guider=type(engine.sampler.guider).__name__,
            denoiser=type(engine.denoiser).__name__, steps=steps, evaluations=len(got_rows),
            rows=sorted(Counter(got_rows).items()), clip_seconds=secs,
            device_ms=device, launches=launches,
            expected=want, bit_identical=same, frames_std=float(frames[0].std()), card=smi)
        check_frames(f"samplers {label}", frames[0].cpu().numpy(), (T, H, W, 3))
        if got_rows != want_rows or (want_evals is not None and len(got_rows) != want_evals):
            raise RuntimeError(f"samplers {label}: evaluations of {got_rows} rows, the plan's "
                               f"{want_rows} (expected {want_evals})")
        if launches != want or same is False:
            raise RuntimeError(f"samplers {label}: launches {launches}, expected {want}; "
                               f"bit-identical repeat {same}")
        return frames[0], launches, secs[0]

    def exported(label: str, seed: int, eager: tuple) -> None:
        # The engine's sampler exported at full width and run on the eager
        # clip's batch and generator seed (export_phase's pattern).
        frames0, launches0, secs0 = eager
        gen = torch.Generator("cuda").manual_seed(seed)
        batch = random_batch(gen)
        params = engine.state_dict()
        t0 = time.perf_counter()
        blob = export_sampler(engine, params, batch, decoding_t=T)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sample = load_sampler(blob)
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches, _ = counted(lambda: sample(params, batch, generator=gen)["sampled_video"])
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
        same, err = torch.equal(out, frames0), rel_l2(out, frames0)
        log("samplers_exported", run=label, programs=sorted(sample.programs),
            step_noise=sample.header["sampler"]["step_noise"], export_seconds=export_s,
            load_seconds=load_s, artifact_mb=len(blob) / 1e6, clip_seconds=clip_s,
            eager_clip_seconds=secs0, bit_identical_to_eager=same, rel_l2=err, tol=AB_TOL,
            launches=launches, eager_launches=launches0, card=smi)
        check_frames(f"samplers exported {label}", out.cpu().numpy(), (T, H, W, 3))
        if not err <= AB_TOL or launches != launches0:
            raise RuntimeError(f"samplers exported {label}: frames {err} (tol {AB_TOL}), "
                               f"launches {launches} against the eager clip's {launches0}")
        del sample, blob, out
        gc.collect()
        torch.cuda.empty_cache()

    try:
        # (a) The six samplers at the config's steps; DPM++ 2S ancestral
        # also exported and run (its repeat is the artifact's run).
        steps = base["params"]["num_steps"]
        for i, (name, extra) in enumerate(SAMPLER_RUNS):
            cfg = copy.deepcopy(base)
            cfg["target"] = SAMPLING + name
            cfg["params"].update(extra)
            second = name in ("HeunEDMSampler", "DPMPP2SAncestralSampler")
            eager = clip(name, cfg, steps, SEED + 50 + i,
                         want_evals=2 * steps - 1 if second else steps,
                         repeat=name != EXPORTED_SAMPLER)
            if name == EXPORTED_SAMPLER:
                exported(name, SEED + 50 + i, eager)
            if name == "EDMSampler":
                churned = sum(p["bump"] > 0 for p in engine.sampler.plan(engine.sampler.sigmas()))
                if not 0 < churned < steps:
                    raise RuntimeError(f"EDMSampler churned {churned} of {steps} steps")
        # (b) The guiders, then DiscreteDenoiser over the DDPM ladder with
        # each scaling (the sampler over that ladder too).
        identity = copy.deepcopy(base)
        identity["params"].pop("guider_config")
        vanilla = copy.deepcopy(base)
        vanilla["params"]["guider_config"] = {
            "target": "sgm.modules.diffusionmodules.guiders.VanillaCFG", "params": {"scale": 1.5}}
        clip("IdentityGuider", identity, PLAIN_STEPS, SEED + 60, want_evals=PLAIN_STEPS)
        clip("VanillaCFG", vanilla, PLAIN_STEPS, SEED + 61, want_evals=PLAIN_STEPS)
        ddpm = copy.deepcopy(base)
        ddpm["params"]["discretization_config"] = DDPM_LADDER
        for i, scaling in enumerate(SCALINGS):
            clip(f"DiscreteDenoiser_{scaling}", ddpm, PLAIN_STEPS, SEED + 62 + i, {
                "target": "sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser",
                "params": {"num_idx": 1000, "discretization_config": DDPM_LADDER,
                           "scaling_config": {
                               "target": "sgm.modules.diffusionmodules.denoiser_scaling."
                               + scaling}}}, want_evals=PLAIN_STEPS)
        engine.denoiser = denoiser0

        # (c) One served batch of two requests, Euler-ancestral.
        ancestral = copy.deepcopy(base)
        ancestral["target"] = SAMPLING + "EulerAncestralSampler"
        engine.sampler = instantiate_from_config(ancestral)
        fn = make_engine_sample_fn(engine, SERVE_BATCH, T, decoding_t=T)
        rows.clear()
        run = serve_requests(fn, served_requests(engine)[:SERVE_BATCH])
        total.update(run["launches"])
        want = expected(list(rows), {k: per_batch[k] - steps * per_eval[BT][k] for k in KERNELS})
        log("samplers_served", sampler="EulerAncestralSampler", requests_wall_s=run["wall_s"],
            evaluations=len(rows), rows=sorted(Counter(rows).items()),
            launches=run["launches"], expected=want, counts=run["counts"], card=smi)
        for f in run["frames"]:
            check_frames("samplers served", f, (T, H, W, 3))
        if (run["launches"] != want or rows != [2 * SERVE_BATCH * T] * steps
                or run["counts"] != (1, SERVE_BATCH)):
            raise RuntimeError(f"samplers served: launches {run['launches']}, expected {want}, "
                               f"rows {rows}, counts {run['counts']}")
    finally:
        hook.remove()
        engine.sampler, engine.denoiser = sampler0, denoiser0

    # (d) LPIPS in validation_metrics, seeded random weights (He-scaled
    # VGG16, positive lins).
    gen = torch.Generator("cuda").manual_seed(SEED + 70)
    lpips = LPIPS().cuda().eval()
    inception = InceptionV3(normalize_input=True).cuda().eval()
    with torch.no_grad():
        for net in (lpips, inception):
            for key, p in net.named_parameters():
                if key.startswith("lin"):
                    p.uniform_(0.05, 1.0, generator=gen)
                elif p.dim() == 4:
                    p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5, generator=gen)
                elif key.endswith("bn.weight"):
                    p.normal_(1.0, 0.1, generator=gen)
                else:
                    p.normal_(0.0, 0.05, generator=gen)
            for key, b in net.named_buffers():
                if key.endswith("running_var"):
                    b.uniform_(0.5, 2.0, generator=gen)
                elif key.endswith("running_mean"):
                    b.normal_(0.0, 0.1, generator=gen)
    batch = random_batch(gen, target=True)
    t0 = time.perf_counter()
    metrics = engine.validation_metrics(batch, generator=gen, decoding_t=T, lpips=lpips)
    metrics_s = time.perf_counter() - t0
    # The clip's frames and its targets, in [-1, 1], NCHW.
    a = batch["cond_frames_without_noise"].permute(0, 3, 1, 2)
    b = batch["jpg"].permute(0, 3, 1, 2)
    lpips_cpu = copy.deepcopy(lpips).cpu()
    with torch.no_grad():
        same = lpips(a, a)
        d_card = lpips(a[:2], b[:2])
        d_cpu = lpips_cpu(a[:2].cpu(), b[:2].cpu())
        lpips_ms, lpips_host_ms = cuda_ms(lambda: lpips(a, b), iters=3)
    lpips_err = float((d_card.cpu() - d_cpu).abs().max() / d_cpu.abs().max())
    flops = vgg_flops(H, W) * 2 * T
    log("samplers_lpips", metrics=metrics, metrics_seconds=metrics_s,
        lpips_x_x=same.tolist(), card_vs_cpu_rel=lpips_err, tol=METRIC_TOL,
        clip_vgg_passes=2 * T, ms=lpips_ms, host_ms=lpips_host_ms, gflop=flops / 1e9,
        tflops=flops / lpips_ms / 1e9, bound_ms=1e3 * flops / FP32_FLOPS, card=smi)
    if not all(math.isfinite(v) for v in metrics.values()) or "val/lpips" not in metrics:
        raise RuntimeError(f"validation metrics {metrics}")
    if same.abs().max() != 0 or not lpips_err <= METRIC_TOL:
        raise RuntimeError(f"LPIPS(x, x) = {same.tolist()}; card vs CPU {lpips_err}")

    # (e) InceptionV3 on the clip's 14 frames in [0, 1], resized to 299.
    frames = (a + 1.0) / 2.0
    inception_cpu = copy.deepcopy(inception).cpu()
    with torch.no_grad():
        feats = inception(frames)
        feats_cpu = inception_cpu(frames[:2].cpu())
        inc_ms, inc_host_ms = cuda_ms(lambda: inception(frames), iters=3)
    inc_err = rel_l2(feats[:2].cpu(), feats_cpu)
    log("samplers_inception", shape=list(feats.shape), card_vs_cpu_rel_l2=inc_err,
        tol=METRIC_TOL, ms=inc_ms, host_ms=inc_host_ms, feature_std=float(feats.std()),
        phase_seconds=time.perf_counter() - phase_t0, card=smi)
    if tuple(feats.shape) != (T, 2048) or not torch.isfinite(feats).all() \
            or not inc_err <= METRIC_TOL:
        raise RuntimeError(f"InceptionV3 features {tuple(feats.shape)}, card vs CPU {inc_err}")
    del lpips, inception, lpips_cpu, inception_cpu
    return dict(total)


def vgg_flops(h: int, w: int) -> float:
    """Multiply-adds x 2 of LPIPS's VGG16 trunk (13 3x3 convs) on one
    h x w image."""
    from gcd_tpu_torch.models.lpips import VGG_CONV_IDX, VGG_STAGES

    flops, cin = 0.0, 3
    for stage, conv_ids in enumerate(VGG_CONV_IDX):
        for _ in conv_ids:
            flops += 2.0 * 9 * cin * VGG_STAGES[stage] * h * w
            cin = VGG_STAGES[stage]
        h, w = h // 2, w // 2
    return flops


def train(smi: str) -> dict:
    """Phase 7. Returns the launches over the Adam steps."""
    from gcd_tpu_torch.engine.trainer import load_trainer
    from gcd_tpu_torch.models.attention import BasicTransformerBlock
    from gcd_tpu_torch.models.embedders import VideoPredictionEmbedderWithEncoder
    from gcd_tpu_torch.models.layers import FeedForward, GroupNorm32
    from gcd_tpu_torch.models.resblock import VideoResBlock
    from gcd_tpu_torch.models.video_attention import (SpatialVideoTransformer,
                                                      VideoTransformerBlock)
    from gcd_tpu_torch.ops import KERNELS, kernel_flags

    t0 = time.perf_counter()
    trainer = load_trainer(TRAIN_CONFIG)
    engine = trainer.engine
    unet = engine.model.diffusion_model
    named = dict(engine.named_parameters())
    trainable = [n for n, p in named.items() if p.requires_grad]  # trainer.trainable's order
    unet_names = [n for n in trainable if n.startswith("model.diffusion_model.")]
    log("train_setup", seconds=time.perf_counter() - t0,
        params=sum(p.numel() for p in named.values()),
        trainable_params=sum(named[n].numel() for n in trainable),
        unet_params=sum(named[n].numel() for n in unet_names),
        optimizer=type(trainer.optimizer).__name__, lr=trainer.optimizer.defaults["lr"],
        use_checkpoint=unet.use_checkpoint, card=smi)
    if not unet.use_checkpoint or not unet_names:
        raise RuntimeError("the training config must remat the UNet and train it")
    gen = torch.Generator("cuda").manual_seed(SEED + 20)
    batch = random_batch(gen, TRAIN_B, target=True)
    bt = TRAIN_B * T

    # Launches per step: the rematerialised blocks run forward twice (the
    # forward, then the recompute in the backward); K6 once per spatial
    # block; the first stage encodes the batch without grad in chunks, the
    # conditioner's frame encoder once. K7 takes 44 of the UNet's GroupNorms
    # (all in rematerialised blocks), in the forward and the recompute.
    blocks = count_modules(unet, BasicTransformerBlock)
    k7_sites = gn_conv_modules(unet)
    remat_gn = sum(count_modules(m, GroupNorm32) for m in unet.modules()
                   if isinstance(m, (VideoResBlock, SpatialVideoTransformer)))
    chunks = -(-bt // (engine.en_and_decode_n_samples_a_time or bt))
    cond_gn = sum(count_modules(m.encoder.encoder, GroupNorm32)
                  for m in engine.conditioner.embedders
                  if isinstance(m, VideoPredictionEmbedderWithEncoder))
    expected = {"flash": 2 * blocks, "flash_bwd": blocks,
                "tattn": 2 * count_modules(unet, VideoTransformerBlock),
                "fused_mlp": 2 * count_modules(unet, FeedForward),
                "fused_gn": remat_gn + count_modules(unet, GroupNorm32) + cond_gn
                + chunks * count_modules(engine.first_stage_model.encoder, GroupNorm32)
                - 2 * k7_sites,
                "fused_gn_conv": 2 * k7_sites}

    def reset():
        for fn in KERNELS.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in KERNELS.items()}

    def loss_and_unet_grads(seed: int):
        for p in trainer.trainable:
            p.grad = None
        loss = engine.loss(batch, 0, torch.Generator("cuda").manual_seed(seed)).mean()
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), [named[n].grad for n in unet_names]

    # One step's loss and UNet gradient, all kernels on vs off, forward and
    # backward; the same draws on both sides.
    gn_sites = Counter()
    reset()
    with record_groupnorms(engine, gn_sites):
        loss_on, grads_on = loss_and_unet_grads(SEED + 21)
    launches_on = counts()
    gn_total = sum(gn_sites.values())
    expected["gn_stats"] = split_calls(gn_sites) + 2 * k7_sites
    reset()
    with kernel_flags(**dict.fromkeys(KERNELS, False)):
        loss_off, grads_off = loss_and_unet_grads(SEED + 21)
    launches_off = counts()
    num = den = 0.0
    for a, b in zip(grads_on, grads_off):
        if b is not None:
            a = torch.zeros_like(b) if a is None else a
            num += float((a.float() - b.float()).square().sum())
            den += float(b.float().square().sum())
    ab = {"loss_on": loss_on, "loss_off": loss_off,
          "loss_rel": abs(loss_on - loss_off) / abs(loss_off),
          "unet_grad_rel_l2": (num / den) ** 0.5, "unet_grad_norm_off": den ** 0.5}
    log("train_ab", **ab, loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL,
        launches_on=launches_on, launches_off=launches_off, expected_per_step=expected,
        groupnorm_calls=gn_total, card=smi)
    del grads_on, grads_off
    if not (ab["loss_rel"] <= TRAIN_LOSS_TOL and ab["unet_grad_rel_l2"] <= TRAIN_GRAD_TOL):
        raise RuntimeError(f"training step, kernels on vs off: {ab}")
    if any(launches_off.values()):
        raise RuntimeError(f"kernels launched with every switch off: {launches_off}")
    if launches_on != expected or gn_total != expected["fused_gn"]:
        raise RuntimeError(f"launches {launches_on} (GroupNorm calls {gn_total}), "
                           f"expected {expected}")

    # What K7 costs the step: its loss and gradient with K7 on and off
    # (on, off, off, on), everything else on.
    k7_s = {"on": [], "off": []}
    for which in ("on", "off", "off", "on"):
        with kernel_flags(fused_gn_conv=which == "on"):
            t0 = time.perf_counter()
            loss_and_unet_grads(SEED + 21)
            k7_s[which].append(time.perf_counter() - t0)
    log("train_k7_ab", loss_and_backward_seconds=k7_s,
        on_over_off=statistics.mean(k7_s["on"]) / statistics.mean(k7_s["off"]), card=smi)

    # Adam steps. A gradient may be exactly zero only where the graph does not
    # reach: the cross-attentions over one context token never read their
    # queries, so their to_q / to_k and the norm2 before them get none. The
    # one other zero allowed at a step is a blend factor's
    # (time_mixer.mix_factor), and only with that step's evidence that bf16
    # rounding made it: every frame's fp32 value is within its rounding
    # slack, every reading is within that slack of the fp32 value, and the
    # readings sum to zero (BlendWitness).
    unreached = {n for n in unet_names if n.endswith(
        ("attn2.to_q.weight", "attn2.to_k.weight", "norm2.weight", "norm2.bias"))}
    witness = BlendWitness(engine)
    frozen = {n: p.detach().clone() for n, p in named.items() if not p.requires_grad}
    total = Counter()
    step_s = []
    losses, grad0 = [], None  # for the mesh phase: its steps' losses, step 0's UNet gradient
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        masters = [m.clone() for m in trainer.masters]
        weights = [p.detach().clone() for p in trainer.trainable]
        reset()
        witness.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches = counts()
        total.update(launches)
        loss = float(metrics["loss"])
        grads = {n: named[n].grad for n in trainable}
        if not (math.isfinite(loss) and all(g is not None and bool(torch.isfinite(g).all())
                                             for g in grads.values())):
            raise RuntimeError(f"step {step}: loss {loss} or a gradient not finite / missing")
        losses.append(loss)
        if step == 0:
            grad0 = [grads[n].detach().to("cpu", copy=True) for n in unet_names]
        zero = {n for n, g in grads.items() if not g.any()}
        unet_norm = math.sqrt(sum(float(grads[n].float().square().sum()) for n in unet_names))
        moved = [bool((m != m0).any()) for m, m0 in zip(trainer.masters, masters)]
        changed = {prefix: sum(int((p != w).sum()) for n, p, w in
                               zip(trainable, trainer.trainable, weights) if n.startswith(prefix))
                   for prefix in ("model.diffusion_model.", "conditioner.")}
        same_frozen = all(torch.equal(named[n], w) for n, w in frozen.items())
        blend_zero = {n for n in zero - unreached if n.endswith("time_mixer.mix_factor")}
        evidence = {n: witness.explain(n[:-len(".mix_factor")]) for n in sorted(blend_zero)}
        log("train_step", step=step, seconds=step_s[-1], loss=loss,
            grad_norm=float(metrics["grad_norm"]), unet_grad_norm=unet_norm,
            zero_grad_params=sorted(zero)[:4], n_zero_grad=len(zero),
            zero_reached=sorted(zero - unreached), blend_zero_evidence=evidence,
            masters_moved=sum(moved), weights_changed=changed, launches=launches, card=smi)
        explained = {n for n, e in evidence.items() if e["explained"]}
        if zero - unreached - explained or not unet_norm > 0:
            raise RuntimeError(f"step {step}: zero gradients at "
                               f"{sorted(zero - unreached - explained)[:8]}, not explained")
        if not all(mv for mv, p in zip(moved, trainer.trainable) if p.grad.any()):
            raise RuntimeError(f"step {step}: a master with a gradient did not move")
        if not all(changed.values()):
            raise RuntimeError(f"step {step}: trainable weights unchanged: {changed}")
        if not same_frozen:
            raise RuntimeError(f"step {step}: a frozen (VAE / CLIP) weight changed")
        if launches != expected:
            raise RuntimeError(f"step {step}: launches {launches}, expected {expected}")
        del masters, weights, grads
    witness.remove()
    ms = 1e3 * statistics.median(step_s[2:])
    peak = torch.cuda.max_memory_allocated()
    log("train", ms_per_step=ms, frames_per_s=bt / (ms / 1e3), step_seconds=step_s,
        peak_mem_bytes=peak, batch_frames=bt, card=smi)

    by_name, total_ms = device_profile(lambda: trainer.train_step(batch, gen), warm=False)
    if total_ms is None:
        log("train_profile", device_ms="not measured", card=smi)
    else:
        log("train_profile", device_ms=total_ms, wall_ms=ms, idle_share=1.0 - total_ms / ms,
            kernels_ms={name: sum(v for k, v in by_name.items() if any(t in k for t in tags))
                        for name, tags in PROFILE_TAGS.items()},
            top=[[k[:90], v] for k, v in by_name.most_common(15)], card=smi)
    params = sum(p.numel() for p in named.values())
    trainable_params = sum(named[n].numel() for n in trainable)
    return dict(total), {"expected": expected, "frames_per_s": bt / (ms / 1e3), "ms": ms,
                         "losses": losses, "grad0": dict(zip(unet_names, grad0)),
                         "checkpoint_bytes": checkpoint_bytes(params, trainable_params),
                         "peak_mem_bytes": peak, "device_ms": total_ms or "not measured"}


def checkpoint_bytes(params: int, trainable_params: int) -> int:
    """A training checkpoint's size: the bf16 module weights, then the fp32
    masters and Adam's two fp32 moments of the trainable ones."""
    return 2 * params + 3 * 4 * trainable_params


def per_step_launch_misses(per_step, expected: dict) -> list:
    """[(step index, launches)] for the steps whose kernel launches are not
    `expected`."""
    return [(i, launches) for i, launches in enumerate(per_step) if launches != expected]


def bits(t: torch.Tensor) -> torch.Tensor:
    """A floating tensor's bits as integers (-0.0 is not 0.0, NaN is itself)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def state_mismatches(a, b, path: str = "") -> list:
    """Where two nested dicts / lists / tensors differ: tensors by bits (b
    moved to a's device), other values by ==."""
    if isinstance(a, dict) and isinstance(b, dict):
        if list(a) != list(b):
            return [f"{path}: keys differ"]
        return [m for k in a for m in state_mismatches(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: lengths differ"]
        return [m for i, (x, y) in enumerate(zip(a, b))
                for m in state_mismatches(x, y, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(bits(a), bits(b.to(a.device))))
        return [] if same else [path]
    return [] if a == b else [path]


def cpu_state(state):
    """A copy of a nested state on the host."""
    if isinstance(state, dict):
        return {k: cpu_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(cpu_state(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return state


def csv_steps(path: str) -> list:
    with open(path, newline="") as f:
        return [int(row["step"]) for row in csv.DictReader(f)]


def check_image_log(prefix: str) -> dict:
    """The image log's files at `prefix`: its frames finite in [0, 1], its
    strip an 8-bit RGB PNG that decodes; raises on a miss."""
    from gcd_tpu_torch.data.png import read_png

    npz, png = f"{prefix}_sample.npz", f"{prefix}_strip.png"
    for fp in (npz, png):
        if not os.path.isfile(fp):
            raise RuntimeError(f"image log {fp} is missing")
    with np.load(npz) as z:
        frames = z["frames"]
    if not (np.isfinite(frames).all() and frames.min() >= 0.0 and frames.max() <= 1.0):
        raise RuntimeError(f"{npz}: frames not finite in [0, 1]")
    try:
        strip = read_png(png)
    except ValueError as e:
        raise RuntimeError(f"{png}: {e}") from e
    if strip.shape[-1] != 3:
        raise RuntimeError(f"{png}: {strip.shape[-1]} channels, not RGB")
    return {"frames_shape": list(frames.shape), "strip_hw": list(strip.shape[:2])}


def entry_phase(smi: str, phase7: dict, work: str):
    """Phase 8, in the directory `work`. Returns the kernel launches over the
    entry's two runs and the run directory, which stays for the eval phase."""
    import gcd_tpu_torch.train as train_entry
    from gcd_tpu_torch.data.fake import make_kubric_root
    from gcd_tpu_torch.data.kubric import KubricSynthViewModule, load_point_cloud_file
    from gcd_tpu_torch.data import geometry
    from gcd_tpu_torch.data.common import load_json
    from gcd_tpu_torch.ops import KERNELS
    from gcd_tpu_torch.utils.config import apply_dotlist, load_config

    def counts():
        return {name: fn.launches for name, fn in KERNELS.items()}

    root, logs = os.path.join(work, "kubric"), os.path.join(work, "logs")
    overrides = [f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl",
                 "data.params.train_videos=1", "data.params.val_videos=0",
                 f"data.params.avail_frames={ENTRY_FRAMES}",
                 f"data.params.mock_dset_size={ENTRY_DATASET_SIZE}",
                 "model.params.ckpt_path=null",
                 f"lightning.modelcheckpoint.params.every_n_train_steps={ENTRY_STEPS}",
                 f"lightning.callbacks.image_logger.params.batch_frequency={ENTRY_STEPS}"]
    # Two checkpoints (steps 3 and 4) and the root must fit on this disk.
    root_bytes = ENTRY_FRAMES * ENTRY_VIEWS * ENTRY_POINTS * 3 * 4
    need = 2 * phase7["checkpoint_bytes"] + root_bytes
    free = shutil.disk_usage(work).free
    log("entry_disk", path=work, free_bytes=free, need_bytes=need,
        checkpoint_bytes_estimate=phase7["checkpoint_bytes"])
    if free < need:
        raise RuntimeError(f"{work}: {free} bytes free, the entry phase needs {need}")
    t0 = time.perf_counter()
    make_kubric_root(root, n_frames=ENTRY_FRAMES, n_views=ENTRY_VIEWS,
                     n_points=ENTRY_POINTS, seed=SEED)
    root_s = time.perf_counter() - t0

    # The host renderer alone: one frame's cloud at the config's 420x280,
    # then one whole example (28 renders, load, resize).
    config = apply_dotlist(load_config(TRAIN_CONFIG), overrides)
    dataset = KubricSynthViewModule(**config["data"]["params"]).train_dataset
    xyz, rgb, _ = load_point_cloud_file(os.path.join(root, "pcl", "scn00000",
                                                     "pcl_rgb_segm_00000.pt"))
    xyz = xyz.reshape(-1, 3).astype(np.float32)
    rgb = rgb.reshape(-1, 3).astype(np.float32) / 255.0
    intrinsics = dataset._used_intrinsics(geometry.get_kubric_camera_matrices(load_json(
        os.path.join(root, "data", "scn00000", "scn00000_p0_v4.json")))[0][0])
    _, _, extrinsics, _, _ = dataset.sample_trajectories(np.random.default_rng(SEED))
    render_s = []
    for _ in range(6):
        t0 = time.perf_counter()
        img = geometry.render_point_cloud(xyz, rgb, intrinsics, extrinsics[0],
                                          dataset.render_height, dataset.render_width)
        render_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    example = dataset[0]
    example_s = time.perf_counter() - t0
    log("entry_render", cpu_count=os.cpu_count(), points=int(xyz.shape[0]),
        render_hw=[dataset.render_height, dataset.render_width],
        render_ms=1e3 * statistics.median(render_s[1:]), render_ms_all=render_s,
        example_seconds=example_s, renders_per_example=2 * dataset.model_frames,
        root_seconds=root_s, root_bytes=root_bytes,
        image_mean=float(img.mean()), jpg_shape=list(example["jpg"].shape), card=smi)
    del xyz, rgb, example

    # Run 1: three steps, the checkpoint and the image log at step 3.
    for fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run1 = train_entry.main(["-b", TRAIN_CONFIG, "-l", logs, "--seed", str(SEED),
                             "--max_steps", str(ENTRY_STEPS), *overrides])
    run1_s = time.perf_counter() - t0
    peak1 = torch.cuda.max_memory_allocated()
    trainer = run1.pop("trainer")
    saved = cpu_state(trainer.state_dict())
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # Run 2: resume from step 3 to step 4; the restored state first.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_entry.setup(["--resume", run1["logdir"], "--seed", str(SEED),
                             "--max_steps", str(ENTRY_RESUME_STEPS)])
    setup2_s = time.perf_counter() - t0
    restore_misses = state_mismatches(run.trainer.state_dict(), saved)
    del saved
    run2 = train_entry.fit(run)
    run2_s = time.perf_counter() - t0
    peak2 = torch.cuda.max_memory_allocated()
    launches = counts()
    run2.pop("trainer")
    del run
    gc.collect()
    torch.cuda.empty_cache()

    expected = phase7["expected"]
    steps = run1["steps"] + run2["steps"]
    losses = run1["losses"] + run2["losses"]
    waits = run1["loader_wait_seconds"] + run2["loader_wait_seconds"]
    step_s = run1["step_seconds"] + run2["step_seconds"]
    misses = per_step_launch_misses(run1["launches"] + run2["launches"], expected)
    ckpts = sorted(os.listdir(os.path.join(run1["logdir"], "checkpoints")))
    rows = csv_steps(os.path.join(run1["logdir"], "metrics.csv"))
    images = [check_image_log(im["prefix"]) for im in run1["image_logs"]]
    # Steady steps: not the first of a run, whose batch the loader makes
    # in the caller's thread before its workers start.
    steady = [i for i in range(len(steps)) if i not in (0, len(run1["steps"]))]
    loop_s = statistics.median(waits[i] + step_s[i] for i in steady)
    saves = run1["saves"] + run2["saves"]
    result = {
        "steps": steps, "losses": losses, "loader_wait_seconds": waits,
        "step_seconds": step_s, "steady_loader_wait_s": statistics.median(
            waits[i] for i in steady),
        "steady_step_s": statistics.median(step_s[i] for i in steady),
        "entry_frames_per_s": TRAIN_B * T / loop_s,
        "entry_step_only_frames_per_s": TRAIN_B * T / statistics.median(
            step_s[i] for i in steady),
        "phase7_frames_per_s": phase7["frames_per_s"], "phase7_ms_per_step": phase7["ms"],
        "checkpoints": ckpts, "csv_steps": rows,
        "saves": saves, "checkpoint_gb": [sv["bytes"] / 1e9 for sv in saves],
        "restore_seconds": run2["restore_seconds"], "resume_setup_seconds": setup2_s,
        "start_step_after_resume": run2["start_step"], "final_step": run2["global_step"],
        "restore_mismatches": restore_misses[:8], "image_logs": run1["image_logs"],
        "image_files": images, "launch_misses": misses[:2], "launches": launches,
        "expected_per_step": expected, "run_seconds": [run1_s, run2_s],
        "peak_mem_bytes": max(peak1, peak2), "cpu_count": os.cpu_count(), "card": smi}
    log("entry", **result)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"entry: a loss is not finite: {losses}")
    if steps != list(range(1, ENTRY_RESUME_STEPS + 1)) or rows != steps:
        raise RuntimeError(f"entry: steps {steps}, CSV rows {rows}")
    if f"step_{ENTRY_STEPS}" not in ckpts or run2["start_step"] != ENTRY_STEPS \
            or run2["global_step"] != ENTRY_RESUME_STEPS:
        raise RuntimeError(f"entry: checkpoints {ckpts}, resumed at {run2['start_step']} "
                           f"to {run2['global_step']}")
    if restore_misses:
        raise RuntimeError(f"entry: the restored state differs at {restore_misses[:8]}")
    if len(images) != 1:
        raise RuntimeError(f"entry: {len(images)} image logs, expected 1")
    if misses or not all(launches.values()):
        raise RuntimeError(f"entry: launches {misses[:2]} (all: {launches}), expected "
                           f"{expected} a step")
    return launches, run1["logdir"]


@contextmanager
def recorded_samples(eval_utils):
    """The sampled frames (host float32) of every sample the entries draw
    while inside: eval_utils.make_sampler wrapped to record them."""
    frames, make = [], eval_utils.make_sampler

    def recording(*args, **kwargs):
        sample = make(*args, **kwargs)

        def wrapped(batch, seed):
            out = sample(batch, seed)
            frames.append(out["sampled_video"])
            return out

        return wrapped

    eval_utils.make_sampler = recording
    try:
        yield frames
    finally:
        eval_utils.make_sampler = make


def check_frames(what: str, frames, shape) -> None:
    if tuple(frames.shape) != shape or not (np.isfinite(frames).all() and frames.min() >= 0.0
                                            and frames.max() <= 1.0):
        raise RuntimeError(f"{what}: frames {tuple(frames.shape)} not finite in [0, 1] of "
                           f"shape {shape}")


# The test entry's default galleries at EVAL_SAMPLES samples: layout suffix ->
# (rows, columns) of panels.
GALLERY_GRID = {"gal": (2, 2), "io": (1, 2), "err": (2, 3), "div": (2, 2), "proj": (2, 2)}


def check_galleries(smi: str, out: str, tags: list, seconds: list) -> None:
    """The test entry's default galleries of each example `tag` in `out`:
    each layout's `.npz` of T + 3 uint8 canvases of its grid of (H + 40,
    W) panels, and its `.png` strip."""
    from gcd_tpu_torch.data.png import read_png
    from gcd_tpu_torch.galleries import BAND

    shapes = {}
    for tag in tags:
        for suffix, (rows, cols) in GALLERY_GRID.items():
            with np.load(os.path.join(out, f"{tag}_{suffix}.npz")) as z:
                frames = z["frames"]
            want = (T + 3, rows * (H + BAND), cols * W, 3)
            png = read_png(os.path.join(out, f"{tag}_{suffix}.png"))
            shapes[f"{tag}_{suffix}"] = list(frames.shape)
            if frames.shape != want or frames.dtype != np.uint8 or png.shape[0] != want[1] \
                    or not frames.any():
                raise RuntimeError(f"eval galleries: {tag}_{suffix} {frames.shape} "
                                   f"{frames.dtype}, png {png.shape}; expected {want} uint8")
    log("eval_galleries", shapes=shapes, seconds_an_example=seconds, card=smi)


def eval_phase(smi: str, launch_model: dict, logdir: str, work: str) -> dict:
    """The eval phase, on phase 8's run directory: the test entry on its
    step_3 checkpoint, the infer entry on an .npz clip and a PNG, and a
    guidance_interval request against the kernels-off one. Returns the
    kernel launches over the three."""
    import gcd_tpu_torch.infer as infer_entry
    import gcd_tpu_torch.test as test_entry
    import gcd_tpu_torch.eval_utils as eval_utils
    from gcd_tpu_torch.data.png import write_png
    from gcd_tpu_torch.engine.bundle import load_model_bundle
    from gcd_tpu_torch.ops import KERNELS, kernel_flags

    def reset():
        for fn in KERNELS.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in KERNELS.items()}

    per_clip = launch_model["per_clip"]
    total = Counter()

    # 1. The test entry: full width, 2 generated controls of scene 0, 2
    # samples each, on the run's step_3 (its config names the root).
    out = os.path.join(work, "eval_test")
    reset()
    t0 = time.perf_counter()
    with recorded_samples(eval_utils) as frames:
        [res] = test_entry.main([
            "--config_path", CONFIG, "--model_path",
            os.path.join(logdir, "checkpoints", f"step_{ENTRY_STEPS}"), "--input", "0",
            "--generate_controls", "--samples_per_scene", str(EVAL_CONTROLS),
            "--num_samples", str(EVAL_SAMPLES), "--num_frames", str(T), "--frame_width", str(W),
            "--frame_height", str(H), "--output", out, "--seed", str(SEED)])
    test_s = time.perf_counter() - t0
    launches = counts()
    total.update(launches)
    clips = EVAL_CONTROLS * EVAL_SAMPLES
    examples = res["examples"]
    tags = [f"0_sample_{i:02d}" for i in range(EVAL_CONTROLS)]
    shapes = {}
    for tag in tags:
        with open(os.path.join(res["output"], f"{tag}_metrics.json")) as f:
            table = json.load(f)
        shapes[tag] = {k: list(np.shape(v)) for k, v in table.items() if k.startswith("frame_")
                       and not k.startswith("frame_diversity")}
    keys = ("psnr", "ssim", "psnr_visible", "psnr_occluded", "ssim_visible", "ssim_occluded")
    log("eval_test", seconds=test_s, summary=res["summary"], failed=res["failed"],
        examples=[{k: ex.get(k) for k in (*keys, "diversity_std", "visible_share", "control",
                                          "seconds")} for ex in examples],
        per_frame_shapes=shapes, launches=launches, expected_per_clip=per_clip, clips=clips,
        card=smi)
    if res["failed"] or len(examples) != EVAL_CONTROLS or len(
            {json.dumps(ex["control"], sort_keys=True) for ex in examples}) != EVAL_CONTROLS:
        raise RuntimeError(f"eval test: {len(examples)} examples, failed {res['failed']}; "
                           f"expected {EVAL_CONTROLS} distinct controls")
    for where in (res["summary"], *examples):
        if not all(isinstance(where.get(k), float) and math.isfinite(where[k]) for k in keys):
            raise RuntimeError(f"eval test: metrics {[where.get(k) for k in keys]} of {keys}")
    if not 0.0 < examples[0]["visible_share"] < 1.0:
        raise RuntimeError(f"eval test: the reprojection covers {examples[0]['visible_share']}")
    if any(shape != [EVAL_SAMPLES, T] for sh in shapes.values() for shape in sh.values()) \
            or not all(len(sh) == 6 for sh in shapes.values()):
        raise RuntimeError(f"eval test: per-frame arrays {shapes}, expected ({EVAL_SAMPLES}, {T})")
    if len(frames) != clips:
        raise RuntimeError(f"eval test: {len(frames)} clips sampled, expected {clips}")
    for f in frames:
        check_frames("eval test", f, (T, H, W, 3))
    if launches != {k: clips * n for k, n in per_clip.items()}:
        raise RuntimeError(f"eval test: launches {launches}, expected {clips} x {per_clip}")
    check_galleries(smi, res["output"], tags, [ex["seconds"]["galleries"] for ex in examples])
    del frames
    gc.collect()
    torch.cuda.empty_cache()

    # 2. The infer entry: an .npz clip of 14 seeded random frames and a PNG.
    inputs, out = os.path.join(work, "eval_inputs"), os.path.join(work, "eval_infer")
    os.makedirs(inputs)
    rng = np.random.default_rng(SEED + 50)
    np.savez(os.path.join(inputs, "clip.npz"),
             frames=rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))
    write_png(os.path.join(inputs, "still.png"), rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    az, el, radius = EVAL_MOVE
    reset()
    t0 = time.perf_counter()
    with recorded_samples(eval_utils) as frames:
        result = infer_entry.main([
            "--config_path", CONFIG, "--input", inputs, "--num_samples", str(EVAL_SAMPLES),
            "--azimuth", str(az), "--elevation", str(el), "--radius", str(radius),
            "--num_frames", str(T), "--input_frames", str(T), "--frame_width", str(W),
            "--frame_height", str(H), "--output", out, "--seed", str(SEED)])
    infer_s = time.perf_counter() - t0
    launches = counts()
    total.update(launches)
    clips = 2 * EVAL_SAMPLES
    want = sorted([f"{base}_{kind}.{ext}" for base in ("clip", "still")
                   for kind in ("in", "ioside", *(f"out{s}" for s in range(EVAL_SAMPLES)))
                   for ext in ("npz", "png")]
                  + ["clip_metrics.json", "still_metrics.json", "summary.json"])
    written = sorted(os.listdir(out))
    diversity = [ex["diversity_std"] for ex in result["examples"]]
    log("eval_infer", seconds=infer_s, summary=result["summary"], diversity_std=diversity,
        sample_seconds=[ex["sample_seconds"] for ex in result["examples"]], files=len(written),
        launches=launches, card=smi)
    if written != want:
        raise RuntimeError(f"eval infer: wrote {written}, expected {want}")
    if len(frames) != clips:
        raise RuntimeError(f"eval infer: {len(frames)} clips sampled, expected {clips}")
    for f in frames:
        check_frames("eval infer", f, (T, H, W, 3))
    for base in ("clip", "still"):
        with np.load(os.path.join(out, f"{base}_ioside.npz")) as z:
            if z["frames"].shape != (T, H, 2 * W, 3):
                raise RuntimeError(f"eval infer: {base}_ioside {z['frames'].shape}")
    if not all(d > 0.0 for d in diversity):
        raise RuntimeError(f"eval infer: diversity_std {diversity}, two seeds must differ")
    if launches != {k: clips * n for k, n in per_clip.items()}:
        raise RuntimeError(f"eval infer: launches {launches}, expected {clips} x {per_clip}")
    del frames
    gc.collect()
    torch.cuda.empty_cache()

    # 3. guidance_interval on the flagship: one random request, its launches
    # from phase 4's per-evaluation counts at B*T = 28 and 14, its frames
    # against the same request with every kernel off, and its wall and
    # device time against full CFG.
    bundle = load_model_bundle(CONFIG, num_frames=T, guidance_interval=EVAL_INTERVAL)
    engine, sampler = bundle.engine, bundle.engine.sampler
    guided = sampler.guided_steps()
    n_guided, n_plain = sum(guided), len(guided) - sum(guided)
    per_eval, outside = launch_model["per_eval"], launch_model["outside_unet"]
    expected = {k: outside[k] + n_guided * per_eval[BT][k] + n_plain * per_eval[T][k]
                for k in per_clip}
    gen = torch.Generator("cuda").manual_seed(SEED + 60)
    batch = random_batch(gen)
    noise = torch.randn(T, HL, WL, 4, generator=gen, device="cuda")

    def request():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = engine.sample_video(batch, noise=noise, decoding_t=T)["sampled_video"]
        torch.cuda.synchronize()
        return frames, time.perf_counter() - t0

    reset()
    frames_on, first_s = request()
    launches = counts()
    total.update(launches)
    with kernel_flags(**dict.fromkeys(KERNELS, False)):
        reset()
        frames_off, off_s = request()
        off_launches = counts()
    interval_rel = rel_l2(frames_on, frames_off)
    # Wall time in turns, then each request's device time (torch.profiler):
    # the wall time of an evaluation is the host's where it outlasts the
    # device's.
    seconds, device = {"interval": [], "full_cfg": []}, {}
    for which in ("interval", "full_cfg", "full_cfg", "interval"):
        sampler.guidance_interval = EVAL_INTERVAL if which == "interval" else None
        seconds[which].append(request()[1])
    for which in seconds:
        sampler.guidance_interval = EVAL_INTERVAL if which == "interval" else None
        device[which] = device_profile(lambda: request()[0], warm=False)[1]
    sampler.guidance_interval = EVAL_INTERVAL
    ratio = statistics.median(seconds["interval"]) / statistics.median(seconds["full_cfg"])
    device_ratio = (device["interval"] / device["full_cfg"]
                    if None not in device.values() else "not measured")
    sigmas = sampler.sigmas()[:-1]
    log("eval_guidance_interval", interval=EVAL_INTERVAL, guided_steps=n_guided,
        plain_steps=n_plain, guided_sigma_range=[float(max(sigmas[guided])),
                                                 float(min(sigmas[guided]))],
        launches=launches, expected=expected, off_launches=off_launches,
        frames_rel_l2=interval_rel, tol=AB_TOL, first_seconds=first_s, off_seconds=off_s,
        clip_seconds=seconds, interval_over_full=ratio, device_ms=device,
        device_interval_over_full=device_ratio, card=smi)
    check_frames("guidance interval", frames_on.float().cpu().numpy(), (T, H, W, 3))
    if n_guided == 0 or n_plain == 0:
        raise RuntimeError(f"guidance interval {EVAL_INTERVAL}: {n_guided} guided and "
                           f"{n_plain} plain steps; both must run")
    if launches != expected or any(off_launches.values()):
        raise RuntimeError(f"guidance interval: launches {launches}, expected {expected}; "
                           f"kernels off {off_launches}")
    if not interval_rel <= AB_TOL:
        raise RuntimeError(f"guidance interval, kernels on vs off: {interval_rel} > {AB_TOL}")
    del bundle, engine, sampler, batch, noise, frames_on, frames_off
    gc.collect()
    torch.cuda.empty_cache()
    return dict(total)


def class_pixel_share(jpg: np.ndarray) -> float:
    """The share of (..., 3) target pixels in [-1, 1] within the loss's 0.02
    (mean absolute) of a person or vehicle colour: the pixels its class
    term weighs."""
    from gcd_tpu_torch.diffusion.loss import PERSON_RGB, VEHICLE_RGB

    ref = np.asarray(PERSON_RGB + VEHICLE_RGB, np.float32) / 127.5 - 1.0
    near = np.zeros(jpg.shape[:-1], dtype=bool)
    for colour in ref:  # one class at a time: a full-size clip is 4 M pixels
        near |= np.abs(jpg - colour).mean(axis=-1) < 0.02
    return float(near.mean())


def pardom_depth(smi: str, scene: str) -> None:
    """One depth frame in the PD root (the dataset's layout:
    depth/<camera>/<time>.npz of metres, 1-80 m, written here: the
    synthetic root has none), read and visualised as the PD pipeline reads
    a modality (data/common.py): before the resize every pixel's colour is
    a row of the plasma table, nearer is brighter; after it the frame is
    (1, H, W, 3) in [-1, 1]."""
    from gcd_tpu_torch.data.common import (get_pardom_camera_dn, load_pardom_frame,
                                           load_pardom_video_vis_frames,
                                           visualize_pardom_frame)
    from gcd_tpu_torch.utils.draw import colormap

    camera = get_pardom_camera_dn("ego", 1)
    rows = np.linspace(1.0, 80.0, PD_FRAME_HW[0], dtype=np.float32)
    depth = np.broadcast_to(rows[:, None], PD_FRAME_HW) + np.random.default_rng(
        SEED + 60).uniform(0.0, 0.5, PD_FRAME_HW).astype(np.float32)
    os.makedirs(os.path.join(scene, "depth", camera), exist_ok=True)
    np.savez(os.path.join(scene, "depth", camera, f"{5:018d}.npz"), data=depth)
    t0 = time.perf_counter()
    vis = visualize_pardom_frame(load_pardom_frame(scene, "depth", camera, 0), "depth", camera,
                                 None)
    vis_s = time.perf_counter() - t0
    table = colormap("plasma", np.arange(256)).astype(np.float32)
    colours = np.unique(vis.reshape(-1, 3), axis=0)
    in_table = bool((colours[:, None] == table[None]).all(-1).any(-1).all())
    frames = load_pardom_video_vis_frames(scene, "depth", "ego", 1, None, [0], False, W, H)
    log("pardom_depth", vis_shape=list(vis.shape), in_plasma_table=in_table,
        near_luminance=float(vis[0].mean()), far_luminance=float(vis[-1].mean()),
        frames_shape=list(frames.shape), seconds=vis_s, card=smi)
    if vis.shape != PD_FRAME_HW + (3,) or not in_table or not vis[0].mean() > vis[-1].mean() \
            or frames.shape != (1, H, W, 3) or not (np.abs(frames) <= 1.0).all():
        raise RuntimeError(f"pardom depth: {vis.shape}, in the plasma table {in_table}, "
                           f"frames {frames.shape}")


def pardom_phase(smi: str, phase6: dict, phase7: dict) -> dict:
    """Phase 9. Returns the kernel launches over its training run and its
    clip."""
    import gcd_tpu_torch.train as train_entry
    from gcd_tpu_torch.data import geometry
    from gcd_tpu_torch.data.common import load_json, process_image
    from gcd_tpu_torch.data.fake import class_ontology_items, make_pardom_root
    from gcd_tpu_torch.data.loader import batch_to_device, collate_fn
    from gcd_tpu_torch.data.pardom import ParallelDomainSynthViewModule, load_pd_point_cloud_file
    from gcd_tpu_torch.data.png import read_png
    from gcd_tpu_torch.engine.build import load_engine
    from gcd_tpu_torch.engine.bundle import load_model_bundle
    from gcd_tpu_torch.engine.trainer import load_trainer
    from gcd_tpu_torch.ops import KERNELS
    from gcd_tpu_torch.utils.config import apply_dotlist, load_config

    def reset():
        for fn in KERNELS.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in KERNELS.items()}

    work = tempfile.mkdtemp(prefix="gcd_pardom_")
    try:
        root, logs = os.path.join(work, "pardom"), os.path.join(work, "logs")
        overrides = [f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl",
                     f"data.params.split_json={root}/data/pardom_datasplit.json",
                     f"data.params.mock_dset_size={PD_DATASET_SIZE}",
                     "model.params.ckpt_path=null"]
        # The root and the end-of-run checkpoint must fit on this disk.
        root_bytes = PD_FRAMES * PD_VIEWS * PD_POINTS * (3 * 2 + 3 + 1 + 1)
        need = phase7["checkpoint_bytes"] + root_bytes + PD_FRAMES * 3 * PD_POINTS
        free = shutil.disk_usage(work).free
        log("pardom_disk", path=work, free_bytes=free, need_bytes=need)
        if free < need:
            raise RuntimeError(f"{work}: {free} bytes free, the ParallelDomain phase needs {need}")
        t0 = time.perf_counter()
        make_pardom_root(root, n_frames=PD_FRAMES, n_points=PD_POINTS, seed=SEED,
                         frame_hw=PD_FRAME_HW, ontology_items=class_ontology_items(),
                         segm_cell=PD_SEGM_CELL)
        root_s = time.perf_counter() - t0

        # The host work alone: a frame file's load, the casts, the class
        # colours, the render at 420x280 and the resize; a PNG decode; one
        # whole example (14 PNGs, 14 clouds, 14 renders).
        config = apply_dotlist(load_config(PD_TRAIN_CONFIG), overrides)
        dataset = ParallelDomainSynthViewModule(**config["data"]["params"]).train_dataset
        scene = os.path.join(root, "data", "scene_000000")
        _, intr, extr = geometry.get_pardom_camera_matrices(load_json(os.path.join(
            scene, "calibration", "calib.json")))
        _, extr_dst, _, intr_dst, *_ = dataset.sample_trajectories(
            np.random.default_rng(SEED), extr, intr)
        split = {k: [] for k in ("load", "cast", "colour", "render", "resize", "png_decode")}
        png_fp = os.path.join(scene, "rgb", "yaw-0", f"{5:018d}.png")
        for _ in range(6):
            t0 = time.perf_counter()
            xyz, rgb, segm, _ = load_pd_point_cloud_file(os.path.join(
                root, "pcl", "scene_000000", "pcl_rgb_segm_000005.pt"))
            t1 = time.perf_counter()
            xyz = xyz.reshape(-1, 3).astype(np.float32)
            xyz = np.where(np.isfinite(xyz).all(axis=-1)[:, None], xyz, 0.0)
            t2 = time.perf_counter()
            colours = dataset._point_colors(1, rgb, segm).reshape(-1, 3)
            t3 = time.perf_counter()
            img = geometry.render_point_cloud(xyz, colours, dataset._used_intrinsics(intr_dst[0]),
                                              extr_dst[0], dataset.render_height,
                                              dataset.render_width, mode="pardom",
                                              blur_kernel=21)
            t4 = time.perf_counter()
            process_image(img, False, dataset.frame_width, dataset.frame_height)
            t5 = time.perf_counter()
            frame = read_png(png_fp)
            t6 = time.perf_counter()
            for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t6 - t5)):
                split[key].append(1e3 * dt)
        del xyz, rgb, segm, colours
        t0 = time.perf_counter()
        example = dataset[0]
        example_s = time.perf_counter() - t0
        share = class_pixel_share(example["jpg"])
        host = {"render_ms": statistics.median(split["render"][1:]),
                "png_decode_ms": statistics.median(split["png_decode"][1:]),
                "example_seconds": example_s, "class_pixel_share": share,
                "split_ms": {k: statistics.median(v[1:]) for k, v in split.items()},
                "first_call_ms": {k: v[0] for k, v in split.items()},
                "points": PD_POINTS * PD_VIEWS, "png_hw": list(frame.shape),
                "render_hw": [dataset.render_height, dataset.render_width],
                "renders_per_example": dataset.model_frames, "root_seconds": root_s,
                "root_bytes": root_bytes, "jpg_shape": list(example["jpg"].shape),
                "cpu_count": os.cpu_count(), "card": smi}
        log("pardom_host", **host)
        if tuple(frame.shape) != PD_FRAME_HW + (3,) or example["jpg"].shape != (T, H, W, 3):
            raise RuntimeError(f"pardom: PNG {frame.shape}, example {example['jpg'].shape}")
        if not share > 0.0:
            raise RuntimeError("pardom: no target pixel in a person or vehicle colour")
        pardom_depth(smi, scene)

        # load_trainer builds the training config on the card; the entry,
        # which builds its own, must train the same parameters.
        t0 = time.perf_counter()
        trainer = load_trainer(PD_TRAIN_CONFIG)
        built = {"seconds": time.perf_counter() - t0, "lr": trainer.optimizer.defaults["lr"],
                 "trainable": len(trainer.trainable_names),
                 "trainable_params": sum(m.numel() for m in trainer.masters)}
        trainable_names = list(trainer.trainable_names)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # train_pardom_semantic.yaml through the entry, to its end-of-run
        # checkpoint.
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = train_entry.main(["-b", PD_TRAIN_CONFIG, "-l", logs, "--seed", str(SEED),
                                "--max_steps", str(PD_STEPS), *overrides])
        run_s = time.perf_counter() - t0
        train_launches = counts()
        peak = torch.cuda.max_memory_allocated()
        entry_trainer = run.pop("trainer")
        same_trainable = (entry_trainer.trainable_names == trainable_names
                          and entry_trainer.optimizer.defaults["lr"] == built["lr"])
        del entry_trainer
        gc.collect()
        torch.cuda.empty_cache()
        expected = phase7["expected"]
        misses = per_step_launch_misses(run["launches"], expected)
        rows = csv_steps(os.path.join(run["logdir"], "metrics.csv"))
        ckpts = sorted(os.listdir(os.path.join(run["logdir"], "checkpoints")))
        steady = range(1, len(run["steps"]))  # not the first, made in the caller's thread
        wait = statistics.median(run["loader_wait_seconds"][i] for i in steady)
        step = statistics.median(run["step_seconds"][i] for i in steady)
        result = {
            "steps": run["steps"], "losses": run["losses"],
            "loader_wait_seconds": run["loader_wait_seconds"],
            "step_seconds": run["step_seconds"], "steady_loader_wait_s": wait,
            "steady_step_s": step, "entry_frames_per_s": TRAIN_B * T / (wait + step),
            "phase7_frames_per_s": phase7["frames_per_s"], "phase7_ms_per_step": phase7["ms"],
            "csv_steps": rows, "checkpoints": ckpts, "saves": run["saves"],
            "launch_misses": misses[:2], "launches": train_launches,
            "expected_per_step": expected, "run_seconds": run_s, "peak_mem_bytes": peak,
            "load_trainer": built, "entry_trains_the_same_parameters": same_trainable,
            "card": smi}
        log("pardom_train", **result)
        if not all(math.isfinite(x) for x in run["losses"]):
            raise RuntimeError(f"pardom: a loss is not finite: {run['losses']}")
        if run["steps"] != list(range(1, PD_STEPS + 1)) or rows != run["steps"]:
            raise RuntimeError(f"pardom: steps {run['steps']}, CSV rows {rows}")
        if ckpts != [f"step_{PD_STEPS}"] or [sv["step"] for sv in run["saves"]] != [PD_STEPS]:
            raise RuntimeError(f"pardom: checkpoints {ckpts}, saves {run['saves']}")
        if misses:
            raise RuntimeError(f"pardom: launches {misses[:2]}, expected {expected} a step")
        if not same_trainable:
            raise RuntimeError(f"pardom: load_trainer {built} does not train what the "
                               "entry's trainer trains")
        del run

        # One clip of infer_pardom.yaml from the first example's ego frames;
        # the released-config bundle builds the same network.
        t0 = time.perf_counter()
        engine = load_engine(PD_INFER_CONFIG)
        build_s = time.perf_counter() - t0
        bundle = load_model_bundle(PD_BUNDLE_CONFIG)
        same = all(torch.equal(a, b) for a, b in zip(engine.parameters(),
                                                       bundle.engine.parameters()))
        bundle_meta = {"camera_control": bundle.camera_control, "move_time": bundle.move_time,
                       "model_name": bundle.model_name, "same_weights": same}
        del bundle
        gc.collect()
        torch.cuda.empty_cache()
        keys = ("cond_frames", "cond_frames_without_noise", "cond_aug", "fps_id",
                "motion_bucket_id", "image_only_indicator", "jpg")
        batch = batch_to_device(collate_fn([{k: example[k] for k in keys}]), "cuda")
        with torch.no_grad():
            c, _ = engine.get_unconditional_conditioning(batch, UC_KEYS)
        vector = tuple(c["vector"].shape)
        gen = torch.Generator("cuda").manual_seed(SEED + 30)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = engine.sample_video(batch, generator=gen, decoding_t=T)["sampled_video"]
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
        clip_launches = counts()
        per_clip = {name: n // CLIPS for name, n in phase6.items()}
        clip = {"clip_seconds": clip_s, "engine_seconds": build_s, "vector_shape": vector,
                "frames_shape": list(frames.shape), "frames_std": float(frames.std()),
                "steps": engine.sampler.num_steps,
                "max_scale": float(engine.sampler.guider.scale.max()), "launches": clip_launches,
                "expected": per_clip, "bundle": bundle_meta, "card": smi}
        log("pardom_clip", **clip)
        if tuple(frames.shape) != (T, H, W, 3):
            raise RuntimeError(f"pardom clip: frames shape {tuple(frames.shape)}")
        if not (torch.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1):
            raise RuntimeError("pardom clip: frames not finite in [0, 1]")
        if vector != (T, 768) or clip["steps"] != 25 or clip["max_scale"] != 1.5:
            raise RuntimeError(f"pardom clip: vector {vector}, {clip['steps']} steps, CFG up "
                               f"to {clip['max_scale']}")
        if clip_launches != per_clip:
            raise RuntimeError(f"pardom clip: launches {clip_launches}, expected {per_clip}")
        if not same or bundle_meta["camera_control"] != "none" or bundle_meta["move_time"] != 13:
            raise RuntimeError(f"pardom bundle: {bundle_meta}")
        del engine, frames, c, batch
        gc.collect()
        torch.cuda.empty_cache()
        launches = {name: train_launches[name] + clip_launches[name] for name in KERNELS}
        if not all(launches.values()):
            raise RuntimeError(f"pardom: a kernel never launched: {launches}")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)

def lambda_linear(n: int) -> float:
    """OPTIONS_SCHEDULE's LambdaLinearScheduler factor at update n (one
    cycle), the reference's formula."""
    c = OPTIONS_SCHEDULE
    warm, length = c["warm_up_steps"][0], c["cycle_lengths"][0]
    if n < warm:
        return (c["f_max"][0] - c["f_start"][0]) / warm * n + c["f_start"][0]
    return c["f_min"][0] + (c["f_max"][0] - c["f_min"][0]) * (length - n) / length


def ema_weight(n: int, decay: float) -> float:
    """1 - decay of the EMA's n-th update (counted from 1), in float32."""
    return float(np.float32(1.0) - min(np.float32(decay),
                                       np.float32(1 + n) / np.float32(10 + n)))


def options_phase(smi: str, phase6: dict, phase7: dict) -> dict:
    """The options phase. Returns the kernel launches over its trainer's
    micro-steps, its entry runs and its clip."""
    import gcd_tpu_torch.engine.trainer as trainer_mod
    import gcd_tpu_torch.train as train_entry
    from gcd_tpu_torch.data.fake import make_kubric_root
    from gcd_tpu_torch.engine.bundle import load_model_bundle
    from gcd_tpu_torch.engine.ema import ema_update
    from gcd_tpu_torch.engine.trainer import load_trainer
    from gcd_tpu_torch.models.lora import is_adapter
    from gcd_tpu_torch.ops import KERNELS, kernel_flags
    from gcd_tpu_torch.parallel import distributed

    unet_prefix = "model.diffusion_model."
    total = Counter()

    def reset():
        for fn in KERNELS.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in KERNELS.items()}

    # (a) time_lora, EMA, the schedule and accumulation through the trainer.
    t0 = time.perf_counter()
    trainer = load_trainer(TRAIN_CONFIG, overrides=OPTIONS_OVERRIDES)
    setup_s = time.perf_counter() - t0
    engine = trainer.engine
    named = dict(engine.named_parameters())
    adapters = [n for n in trainer.trainable_names if is_adapter(n)]
    base_names = [n for n in named if n.startswith(unet_prefix) and not is_adapter(n)]
    base = {n: named[n].detach().to("cpu", copy=True) for n in base_names}
    gen = torch.Generator("cuda").manual_seed(SEED + 40)
    batch = random_batch(gen, TRAIN_B, target=True)

    def loss_and_adapter_grads(seed: int):
        for p in trainer.trainable:
            p.grad = None
        loss = engine.loss(batch, 0, torch.Generator("cuda").manual_seed(seed)).mean()
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), [named[n].grad for n in adapters]

    reset()
    loss_on, grads_on = loss_and_adapter_grads(SEED + 41)
    launches_on = counts()
    reset()
    with kernel_flags(**dict.fromkeys(KERNELS, False)):
        loss_off, grads_off = loss_and_adapter_grads(SEED + 41)
    launches_off = counts()
    num = den = 0.0
    for a, b in zip(grads_on, grads_off):
        if b is not None:
            a = torch.zeros_like(b) if a is None else a
            num += float((a.float() - b.float()).square().sum())
            den += float(b.float().square().sum())
    ab = {"loss_on": loss_on, "loss_off": loss_off,
          "loss_rel": abs(loss_on - loss_off) / abs(loss_off),
          "adapter_grad_rel_l2": (num / den) ** 0.5, "adapter_grad_norm_off": den ** 0.5}
    del grads_on, grads_off
    for p in trainer.trainable:
        p.grad = None

    # Plain-torch EMA of three base tensors beside the trainer's.
    probe = [base_names[0], base_names[len(base_names) // 2], base_names[-1]]
    plain_ema = {n: named[n].detach().float().clone() for n in probe}
    lr0 = trainer.learning_rate
    master = dict(zip(trainer.trainable_names, trainer.masters))
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(OPTIONS_STEPS):
        before = {n: master[n].clone() for n in adapters}
        applied_lr = trainer.optimizer.param_groups[0]["lr"]
        updates = trainer.updates
        gen.manual_seed(SEED + 50 + i)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts()
        total.update(launches)
        for n in probe:
            p = plain_ema[n]
            plain_ema[n] = p - ema_weight(i + 1, engine.ema_decay_rate) * (
                p - named[n].detach().float())
        moved = sum(int(not torch.equal(master[n], before[n])) for n in adapters)
        steps.append({
            "micro_step": i + 1, "seconds": seconds, "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "adapters_moved": moved,
            "applied_lr": applied_lr, "formula_lr": lr0 * lambda_linear(updates),
            "updates_before": updates, "launches": launches,
            "weights_are_masters": all(torch.equal(named[n], master[n].to(named[n].dtype))
                                       for n in adapters)})
    peak_a = torch.cuda.max_memory_allocated()
    same_base = all(torch.equal(named[n].detach().cpu(), w) for n, w in base.items())
    ema_bits = {n: torch.equal(trainer.ema.params[n], plain_ema[n]) for n in probe}
    ema_updates = trainer.ema.num_updates
    micro_ms = 1e3 * statistics.median(st["seconds"] for st in steps[1:])
    # A fifth micro-step (no update) under torch.profiler: its device time.
    gen.manual_seed(SEED + 50 + OPTIONS_STEPS)
    _, micro_device_ms = device_profile(lambda: trainer.train_step(batch, gen), warm=False)
    result_a = {"setup_seconds": setup_s, "adapters": len(adapters),
                "adapter_params": sum(named[n].numel() for n in adapters),
                "trainable": len(trainer.trainable_names), "ab": ab,
                "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
                "launches_on": launches_on, "launches_off": launches_off,
                "expected_per_step": phase7["expected"], "steps": steps,
                "ms_per_micro_step": micro_ms, "phase7_ms_per_step": phase7["ms"],
                "micro_step_device_ms": micro_device_ms if micro_device_ms is not None
                else "not measured", "phase7_device_ms": phase7["device_ms"],
                "peak_mem_bytes": peak_a, "phase7_peak_mem_bytes": phase7["peak_mem_bytes"],
                "base_unchanged": same_base, "ema_num_updates": ema_updates,
                "ema_equals_plain_formula": ema_bits, "card": smi}
    log("options_trainer", **result_a)
    del trainer, engine, named, base, master, plain_ema, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not (ab["loss_rel"] <= TRAIN_LOSS_TOL and ab["adapter_grad_rel_l2"] <= TRAIN_GRAD_TOL):
        raise RuntimeError(f"options: the time_lora step, kernels on vs off: {ab}")
    if any(launches_off.values()) or launches_on != phase7["expected"]:
        raise RuntimeError(f"options: launches {launches_on} (off: {launches_off}), expected "
                           f"{phase7['expected']}")
    for st in steps:
        update = st["micro_step"] % OPTIONS_ACCUMULATE == 0
        if not math.isfinite(st["loss"]) or st["launches"] != phase7["expected"]:
            raise RuntimeError(f"options: micro-step {st}")
        if bool(st["adapters_moved"]) != update or not st["weights_are_masters"]:
            raise RuntimeError(f"options: adapters moved {st['adapters_moved']} at micro-step "
                               f"{st['micro_step']}")
        if st["applied_lr"] != st["formula_lr"]:
            raise RuntimeError(f"options: lr {st['applied_lr']}, formula {st['formula_lr']}")
    if not same_base or not all(ema_bits.values()) or result_a["ema_num_updates"] != \
            OPTIONS_STEPS:
        raise RuntimeError(f"options: base unchanged {same_base}, EMA {ema_bits}")

    # (b) EMA at full width: the everything strategy, 2 steps, each EMA
    # update timed by CUDA events.
    ema_ms = []

    def timed_ema(state, sources):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = ema_update(state, sources)
        end.record()
        end.synchronize()
        ema_ms.append(start.elapsed_time(end))
        return out

    batch = random_batch(torch.Generator("cuda").manual_seed(SEED + 60), TRAIN_B, target=True)
    gen = torch.Generator("cuda")
    peaks, step_s = {}, {}
    trainer_mod.ema_update = timed_ema
    try:
        for ema_on in (False, True):  # the peak without the shadow, then with it
            trainer = load_trainer(TRAIN_CONFIG, overrides=[f"model.params.use_ema={ema_on}"])
            torch.cuda.reset_peak_memory_stats()
            step_s[ema_on] = []
            for i in range(OPTIONS_EMA_STEPS):
                gen.manual_seed(SEED + 61 + i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(batch, gen)
                torch.cuda.synchronize()
                step_s[ema_on].append(time.perf_counter() - t0)
            peaks[ema_on] = torch.cuda.max_memory_allocated()
            if not ema_on:
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        trainer_mod.ema_update = ema_update
    state, sources = trainer.ema, trainer.ema_sources
    shadow_bytes = sum(s.numel() * s.element_size() for s in state.params.values())
    # Two runs of one update from the same state, bit for bit.
    saved = [s.clone() for s in state.params.values()]
    runs = []
    for _ in range(2):
        for s, s0 in zip(state.params.values(), saved):
            s.copy_(s0)
        state.num_updates = OPTIONS_EMA_STEPS
        ema_update(state, sources)
        runs.append([s.clone() for s in state.params.values()])
    same_runs = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs, saved
    _, ema_device_ms = device_profile(lambda: ema_update(state, sources), warm=False)
    result_b = {"ema_ms": ema_ms, "ema_device_ms": ema_device_ms
                if ema_device_ms is not None else "not measured",
                "ema_tensors": len(state.params), "chunks": len(state.chunks),
                "shadow_bytes": shadow_bytes, "step_seconds": step_s[True],
                "step_seconds_without_ema": step_s[False], "peak_mem_bytes": peaks[True],
                "peak_mem_bytes_without_ema": peaks[False],
                "added_peak_bytes": peaks[True] - peaks[False],
                "two_runs_bit_identical": same_runs, "card": smi}
    log("options_ema", **result_b)
    del trainer, state, sources, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not same_runs or len(ema_ms) != OPTIONS_EMA_STEPS:
        raise RuntimeError(f"options: EMA updates {ema_ms}, two runs identical {same_runs}")

    # (c) The entry in an NCCL group of one: 4 micro-steps (checkpoints at 3,
    # in the middle of an accumulation, and 4); a resume from step 3 to 4;
    # the same 4 micro-steps without a group; then the bundle samples one
    # clip from the checkpoint with the adapters merged.
    work = tempfile.mkdtemp(prefix="gcd_options_")
    reduce_ms = []
    all_reduce_mean = distributed.all_reduce_mean

    def timed_reduce(t, group=None):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = all_reduce_mean(t, group)
        end.record()
        end.synchronize()
        reduce_ms.append([t.numel(), start.elapsed_time(end)])
        return out

    def free_port() -> int:
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    try:
        root = os.path.join(work, "kubric")
        make_kubric_root(root, n_frames=ENTRY_FRAMES, n_views=OPTIONS_VIEWS,
                         n_points=OPTIONS_POINTS, seed=SEED)
        args = ["-b", TRAIN_CONFIG, "--seed", str(SEED), "--no_date", "-n", "options",
                f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl",
                "data.params.train_videos=1", "data.params.val_videos=0",
                f"data.params.avail_frames={ENTRY_FRAMES}",
                f"data.params.mock_dset_size={TRAIN_B}", "data.params.shuffle=false",
                "model.params.ckpt_path=null",
                "lightning.callbacks.image_logger.params.disabled=true", *OPTIONS_OVERRIDES]

        def group():
            return ["--coordinator", f"127.0.0.1:{free_port()}", "--num_processes", "1",
                    "--process_id", "0"]

        def entry(argv):
            run = train_entry.main(argv)
            trainer = run.pop("trainer")
            run["state"] = cpu_state(trainer.state_dict())
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            return run

        reset()
        distributed.all_reduce_mean = timed_reduce
        t0 = time.perf_counter()
        try:
            grouped = entry([*args, "-l", os.path.join(work, "group"), "--max_steps",
                             str(OPTIONS_STEPS), *group(),
                             f"lightning.modelcheckpoint.params.every_n_train_steps="
                             f"{OPTIONS_CKPT_STEP}"])
        finally:
            distributed.all_reduce_mean = all_reduce_mean
        grouped_s = time.perf_counter() - t0
        entry_launches = counts()
        group_dir = grouped["logdir"]
        ckpt_dir = os.path.join(group_dir, "checkpoints")
        ckpts = sorted(os.listdir(ckpt_dir))
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{OPTIONS_STEPS}"))
        t0 = time.perf_counter()
        resumed = entry(["--resume", group_dir, "--seed", str(SEED), "--max_steps",
                         str(OPTIONS_STEPS), *group()])
        resumed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = entry([*args, "-l", os.path.join(work, "plain"), "--max_steps",
                       str(OPTIONS_STEPS)])
        plain_s = time.perf_counter() - t0
        shutil.rmtree(plain["logdir"], ignore_errors=True)
        resume_misses = state_mismatches(resumed["state"], grouped["state"])
        group_misses = state_mismatches(plain["state"], grouped["state"])

        # The bundle on the resumed run's step_4: EMA shadow, adapters merged.
        reset()
        t0 = time.perf_counter()
        bundle = load_model_bundle(CONFIG, os.path.join(ckpt_dir, f"step_{OPTIONS_STEPS}"),
                                   support_ema=True)
        bundle_s = time.perf_counter() - t0
        missing = list(bundle.engine.missing_keys)
        clip_batch = random_batch(torch.Generator("cuda").manual_seed(SEED + 70), 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = bundle.engine.sample_video(
            clip_batch, generator=torch.Generator("cuda").manual_seed(SEED + 71),
            decoding_t=T)["sampled_video"]
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
        clip_launches = counts()
        per_clip = {name: n // CLIPS for name, n in phase6.items()}
        finite = bool(torch.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1)
        del bundle, frames, clip_batch
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    grads = [ms for n, ms in reduce_ms if n > 1]
    result_c = {"losses": grouped["losses"], "plain_losses": plain["losses"],
                "resumed_losses": resumed["losses"], "steps": grouped["steps"],
                "resumed_from": resumed["start_step"], "checkpoints": ckpts,
                "saves": grouped["saves"] + resumed["saves"],
                "resume_mismatches": resume_misses[:8], "group_mismatches": group_misses[:8],
                "all_reduce_calls": reduce_ms,
                "gradient_all_reduce_ms": grads,
                "gradient_all_reduce_ms_a_step": sum(grads) / len(grouped["steps"]),
                "run_seconds": {"group": grouped_s, "resume": resumed_s, "plain": plain_s},
                "entry_launches": entry_launches,
                "expected_per_step": phase7["expected"],
                "launch_misses": per_step_launch_misses(grouped["launches"],
                                                         phase7["expected"])[:2],
                "bundle_missing_keys": len(missing), "bundle_seconds": bundle_s,
                "clip_seconds": clip_s, "clip_launches": clip_launches,
                "expected_per_clip": per_clip, "clip_frames_finite": finite, "card": smi}
    log("options_entry", **result_c)
    if grouped["steps"] != list(range(1, OPTIONS_STEPS + 1)) or resumed["start_step"] != \
            OPTIONS_CKPT_STEP or f"step_{OPTIONS_CKPT_STEP}" not in ckpts:
        raise RuntimeError(f"options entry: steps {grouped['steps']}, checkpoints {ckpts}, "
                           f"resumed at {resumed['start_step']}")
    if resume_misses or resumed["losses"] != grouped["losses"][OPTIONS_CKPT_STEP:]:
        raise RuntimeError(f"options entry: the resume differs at {resume_misses[:8]}")
    if group_misses or plain["losses"] != grouped["losses"]:
        raise RuntimeError(f"options entry: the run without a group differs at "
                           f"{group_misses[:8]}")
    if not grads or result_c["launch_misses"]:
        raise RuntimeError(f"options entry: all-reduces {reduce_ms}, launches "
                           f"{result_c['launch_misses']}")
    if missing or not finite or clip_launches != per_clip:
        raise RuntimeError(f"options bundle: {len(missing)} missing keys, frames finite "
                           f"{finite}, launches {clip_launches}, expected {per_clip}")
    total.update(entry_launches)
    total.update(clip_launches)
    return dict(total)


def tp_cases(gen: torch.Generator, tensor: int):
    """(kernel, label, kernel call, plain call, bytes, operations) of K1, K6,
    K2 and K3 at the shapes a rank of `tensor` tensor ranks sees at
    B*T = 28: heads / tensor heads where the level's heads divide (the
    layers the port cuts), inner / tensor GEGLU columns."""
    from gcd_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                   flash_attention_bwd_plain, flash_attention_plain,
                                   geglu_mlp, geglu_mlp_plain, temporal_attention,
                                   temporal_attention_plain)
    from gcd_tpu_torch.parallel.mesh import ff_cut

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    for name, s, c, _ in LEVELS:
        heads = c // 64
        if heads % tensor == 0:
            h, cl = heads // tensor, c // tensor
            q, k, v, do = (randn(BT, s, cl) for _ in range(4))
            yield ("flash", f"{name} ({BT},{s},{h}x64) TP={tensor}",
                   lambda q=q, k=k, v=v, h=h: flash_attention(q, k, v, h),
                   lambda q=q, k=k, v=v, h=h: flash_attention_plain(q, k, v, h),
                   4 * BT * s * cl * 2, 4 * BT * s * s * cl)
            yield ("flash_bwd", f"{name} ({BT},{s},{h}x64) TP={tensor}",
                   lambda q=q, k=k, v=v, do=do, h=h: flash_attention_bwd(q, k, v, do, h),
                   lambda q=q, k=k, v=v, do=do, h=h: flash_attention_bwd_plain(q, k, v, do, h),
                   7 * BT * s * cl * 2, 10 * BT * s * s * cl)
            yield ("tattn", f"{tattn_label(name, BT, s, cl)} TP={tensor}",
                   lambda q=q, k=k, v=v, h=h: temporal_attention(q, k, v, T, h),
                   lambda q=q, k=k, v=v, h=h: temporal_attention_plain(q, k, v, T, h),
                   4 * BT * s * cl * 2, 4 * BT * s * T * cl)
        inner = 4 * c
        if ff_cut(inner, tensor):
            il, m = inner // tensor, BT * s
            x = randn(m, c)
            w1, b1 = randn(2 * il, c, std=c ** -0.5), randn(2 * il, std=0.1)
            w2, b2 = randn(c, il, std=inner ** -0.5), torch.zeros(c, device="cuda",
                                                                  dtype=torch.bfloat16)
            yield ("fused_mlp", f"{mlp_label(name, m, c, il)} TP={tensor}",
                   lambda a=(x, w1, b1, w2, b2): geglu_mlp(*a),
                   lambda a=(x, w1, b1, w2, b2): geglu_mlp_plain(*a),
                   2 * (2 * m * c + 3 * il * c + 2 * il + c), 6 * m * c * il)


def mesh_phase(smi: str, phase7: dict) -> dict:
    """The mesh phase's (a) and (b), and (c) or the line saying why it did
    not run. Returns the kernel launches over (a)'s steps."""
    import socket

    from gcd_tpu_torch.engine.trainer import load_trainer
    from gcd_tpu_torch.ops import KERNELS
    from gcd_tpu_torch.parallel import distributed
    from gcd_tpu_torch.parallel.mesh import create_mesh, placement_summary, unet_placements
    from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

    def reset():
        for fn in KERNELS.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in KERNELS.items()}

    # Placement summaries of the flagship UNet (computed on the meta device).
    network = load_config(TRAIN_CONFIG)["model"]["params"]["network_config"]
    with torch.device("meta"):
        unet = instantiate_from_config(network)
    summaries = {f"fsdp{f}_tensor{t}": placement_summary(unet, unet_placements(unet, f, t), f, t)
                 for f, t in ((MESH_RULE_FSDP, 1), (2, 2), (1, 2), (1, 4))}
    log("mesh_placement", **summaries, card=smi)
    del unet

    # (a) fsdp in an NCCL group of one.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, torch.device("cuda"))
    total = Counter()
    try:
        mesh = create_mesh(1, 1, 1, "cuda")
        t0 = time.perf_counter()
        trainer = load_trainer(TRAIN_CONFIG, mesh=mesh, rule=(MESH_RULE_FSDP, 1))
        setup_s = time.perf_counter() - t0
        from torch.distributed.tensor import DTensor

        sharded = sum(isinstance(p, DTensor) for p in trainer.trainable)
        gen = torch.Generator("cuda").manual_seed(SEED + 20)  # phase 7's batch and draws
        batch = random_batch(gen, TRAIN_B, target=True)
        steps, step_s = [], []
        torch.cuda.reset_peak_memory_stats()
        grad_rel = None
        for step in range(MESH_STEPS):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch, gen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            launches = counts()
            total.update(launches)
            loss = float(metrics["loss"])
            if step == 0:  # the UNet's gradient against phase 7's first step's
                num = den = 0.0
                for name, g in zip(trainer.trainable_names, trainer._grads):
                    if name in phase7["grad0"]:
                        ref = phase7["grad0"][name].to("cuda").float()
                        num += float((g.float() - ref).square().sum())
                        den += float(ref.square().sum())
                grad_rel = (num / den) ** 0.5
            steps.append({"loss": loss, "phase7_loss": phase7["losses"][step],
                          "loss_rel": abs(loss - phase7["losses"][step]) /
                          abs(phase7["losses"][step]), "grad_norm": float(metrics["grad_norm"]),
                          "seconds": step_s[-1], "launches": launches})
        peak = torch.cuda.max_memory_allocated()
        result = {"setup_seconds": setup_s, "rule_fsdp": MESH_RULE_FSDP,
                  "sharded_trainable_tensors": sharded,
                  "replicated_trainable_tensors": len(trainer.trainable) - sharded,
                  "steps": steps, "unet_grad_rel_l2": grad_rel,
                  "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
                  "ms_per_step": 1e3 * statistics.median(step_s[1:]),
                  "phase7_ms_per_step": phase7["ms"], "peak_mem_bytes": peak,
                  "phase7_peak_mem_bytes": phase7["peak_mem_bytes"],
                  "predicted_state_bytes_per_card": summaries[
                      f"fsdp{MESH_RULE_FSDP}_tensor1"]["state_bytes_per_card"],
                  "expected_per_step": phase7["expected"], "card": smi}
        log("mesh_fsdp", **result)
        del trainer, batch, metrics
    finally:
        distributed.shutdown()
        gc.collect()
        torch.cuda.empty_cache()
    if not sharded or any(st["launches"] != phase7["expected"] for st in steps):
        raise RuntimeError(f"mesh (a): {sharded} sharded tensors, launches "
                           f"{[st['launches'] for st in steps]}, expected {phase7['expected']}")
    if not (grad_rel <= TRAIN_GRAD_TOL and all(math.isfinite(st["loss"]) and
                                               st["loss_rel"] <= TRAIN_LOSS_TOL
                                               for st in steps)):
        raise RuntimeError(f"mesh (a): losses {steps}, UNet gradient {grad_rel}")

    # (b) the kernels at the tensor ranks' shapes.
    gen = torch.Generator("cuda").manual_seed(SEED + 80)
    for tensor in MESH_TP:
        for name, label, run, plain, nbytes, flops in tp_cases(gen, tensor):
            out = run()
            torch.cuda.synchronize()
            ref = plain()
            err = rel_l2(out, ref)
            same = rel_l2(run(), out) == 0.0
            (ms, _), (plain_ms, _) = cuda_ms(run), cuda_ms(plain)
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
            log("mesh_kernel", kernel=name, shape=label, rel_l2=err, max_abs_err=max_abs(out, ref),
                bit_identical=same, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                card=smi)
            if not (err <= KERNEL_TOL and same):
                raise RuntimeError(f"mesh (b) {name} {label}: relative L2 {err}, second call "
                                   f"identical {same}")
            del out, ref, run, plain
    torch.cuda.empty_cache()

    # (c) the multi-card runs.
    if torch.cuda.device_count() >= MESH_CARDS:
        mesh_cards(smi)
    else:
        log("mesh_cards", ran=False, reason=f"{torch.cuda.device_count()} card(s); the "
            f"four-process runs need {MESH_CARDS} (python3 chip_smoke.py --mesh-cards on a "
            "machine of four)", card=smi)
    return dict(total)


def nccl_ms(trace_path: str) -> dict:
    """Device ms by NCCL kernel name in a chrome trace of torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = Counter()
    for ev in events:
        if ev.get("cat") == "kernel" and "nccl" in ev.get("name", "").lower():
            out[ev["name"].split("(")[0][:60]] += ev.get("dur", 0.0) / 1e3
    return dict(out)


def mesh_cards(smi: str) -> None:
    """(c): the entry in four NCCL processes, one a card, at fsdp 4 (a batch
    of 4 clips, against four data-parallel processes) and at fsdp 2 x
    tensor 2 (2 clips, against one process), on a root of small clouds."""
    import socket

    from gcd_tpu_torch import train as train_entry
    from gcd_tpu_torch.data.fake import make_kubric_root

    work = tempfile.mkdtemp(prefix="gcd_mesh_")
    try:
        root = os.path.join(work, "kubric")
        make_kubric_root(root, n_frames=ENTRY_FRAMES, n_views=OPTIONS_VIEWS,
                         n_points=OPTIONS_POINTS, seed=SEED)

        def args(name, clips):
            return ["-b", TRAIN_CONFIG, "--seed", str(SEED), "--no_date", "-n", name,
                    "-l", os.path.join(work, "logs"), "--max_steps", str(MESH_RUN_STEPS),
                    "--profile_steps", "1", f"data.params.dset_root={root}/data",
                    f"data.params.pcl_root={root}/pcl", "data.params.train_videos=1",
                    "data.params.val_videos=0", f"data.params.avail_frames={ENTRY_FRAMES}",
                    f"data.params.batch_size={clips}",
                    f"data.params.mock_dset_size={clips * MESH_RUN_STEPS}",
                    "data.params.shuffle=false", "model.params.ckpt_path=null",
                    "lightning.callbacks.image_logger.params.disabled=true"]

        def run(name, clips, nproc, *mesh):
            logdir = os.path.join(work, "logs", name)
            t0 = time.perf_counter()
            if nproc == 1:
                out = train_entry.main(args(name, clips))
                res = [{"losses": out["losses"], "step_seconds": out["step_seconds"],
                        "peak_mem_bytes": torch.cuda.max_memory_allocated()}]
                del out
                gc.collect()
                torch.cuda.empty_cache()
            else:
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                procs = [subprocess.Popen(
                    [sys.executable, "-c", MESH_CHILD, *args(name, clips), "--coordinator",
                     f"127.0.0.1:{port}", "--num_processes", str(nproc), "--process_id",
                     str(pid), *mesh], cwd=REPO, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True) for pid in range(nproc)]
                try:
                    outs = [p.communicate(timeout=900)[0] for p in procs]
                finally:
                    for p in procs:
                        p.kill()
                for p, o in zip(procs, outs):
                    if p.returncode != 0:
                        raise RuntimeError(f"mesh (c) {name}: exit {p.returncode}: {o[-3000:]}")
                res = [json.loads(o.split("MESH_RESULT ", 1)[1].splitlines()[0]) for o in outs]
            trace = os.path.join(logdir, "profile", "trace.json")
            result = {"run": name, "processes": nproc, "clips": clips, "mesh": list(mesh),
                      "losses": res[0]["losses"], "step_seconds": res[0]["step_seconds"],
                      "peak_mem_bytes_per_card": [r["peak_mem_bytes"] for r in res],
                      "nccl_ms_profiled_step": nccl_ms(trace) if os.path.exists(trace) else
                      "not measured", "seconds": time.perf_counter() - t0, "card": smi}
            shutil.rmtree(logdir, ignore_errors=True)  # a checkpoint of ~23 GB
            log("mesh_run", **result)
            return result

        pairs = [(run("one", TRAIN_B, 1), run("f2t2", TRAIN_B, 4, "--mesh_fsdp", "2",
                                                "--mesh_tensor", "2")),
                 (run("dp4", 4, 4), run("f4", 4, 4, "--mesh_fsdp", "4"))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for ref, got in pairs:
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
        log("mesh_cards", ran=True, run=got["run"], against=ref["run"], loss_rel=rel,
            loss_tol=TRAIN_LOSS_TOL, card=smi)
        if len(rel) != MESH_RUN_STEPS or not all(r <= TRAIN_LOSS_TOL for r in rel):
            raise RuntimeError(f"mesh (c) {got['run']} against {ref['run']}: {rel}")


def shard_cases(gen: torch.Generator, gn_unet: Counter, gn_conv: Counter):
    """(kernel, label, kernel call, plain call, bytes, operations, peak) at
    the shapes a rank of SHARD_RANKS ranks sees at one clip: K1, K3, K7 and
    the per-frame K4 / K5 sites at T / SHARD_F rows (phase 4's sites with
    that N), K2 on all T frames of one video at 1 / SHARD_F of each level's
    positions."""
    from gcd_tpu_torch.ops import (flash_attention, flash_attention_plain, geglu_mlp,
                                   geglu_mlp_plain, temporal_attention, temporal_attention_plain)

    rows = T // SHARD_F

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    for name, s, c, _ in LEVELS:
        heads = c // 64
        q, k, v = (randn(rows, s, c) for _ in range(3))
        yield ("flash", flash_label(name, rows, s, heads),
               lambda q=q, k=k, v=v, h=heads: flash_attention(q, k, v, h),
               lambda q=q, k=k, v=v, h=heads: flash_attention_plain(q, k, v, h),
               4 * rows * s * c * 2, 4 * rows * s * s * c, BF16_FLOPS)
        inner, m = 4 * c, rows * s
        x = randn(m, c)
        w1, b1 = randn(2 * inner, c, std=c ** -0.5), randn(2 * inner, std=0.1)
        w2, b2 = randn(c, inner, std=inner ** -0.5), randn(c, std=0.1)
        yield ("fused_mlp", mlp_label(name, m, c, inner),
               lambda a=(x, w1, b1, w2, b2): geglu_mlp(*a),
               lambda a=(x, w1, b1, w2, b2): geglu_mlp_plain(*a),
               2 * (2 * m * c + 3 * inner * c + 2 * inner + c), 6 * m * c * inner, BF16_FLOPS)
        sp = s // SHARD_F
        q, k, v = (randn(T, sp, c) for _ in range(3))
        yield ("tattn", tattn_label(name, T, sp, c),
               lambda q=q, k=k, v=v, h=heads: temporal_attention(q, k, v, T, h),
               lambda q=q, k=k, v=v, h=heads: temporal_attention_plain(q, k, v, T, h),
               4 * T * sp * c * 2, 4 * T * sp * T * c, BF16_FLOPS)
    k7 = Counter({(rows, *site[1:]): 0 for site in gn_conv})
    for name, label, _, run, plain, _, nbytes, flops, peak in gn_conv_cases(gen, k7):
        yield name, label, run, plain, nbytes, flops, peak
    frame_sites = Counter({((rows, *shape[1:]), *rest): 0
                           for (shape, *rest) in gn_unet if len(shape) == 4})
    for name, label, _, run, plain, _, nbytes, flops, peak in groupnorm_cases(gen, frame_sites,
                                                                             {}):
        yield name, label, run, plain, nbytes, flops, peak


def time_stack_cases(gen: torch.Generator, gn_unet: Counter):
    """The time_stack GroupNorm sites (phase 4's 5D sites) as a rank of
    SHARD_F frame ranks holds them, one video: each of the SHARD_F position
    blocks' K5 sums added, against K5 on the whole video; each block
    normalised with the summed statistics (K4's split-path apply), against
    the plain GroupNorm of the whole video. Yields (label, whole, blocks,
    weight, bias, eps, silu)."""
    for (shape, layout, eps, silu) in sorted({(sh, *rest) for (sh, *rest) in gn_unet
                                              if len(sh) == 5}):
        _, c, t, h, w = shape
        x = torch.randn(1, t, h, w, c, generator=gen, device="cuda").permute(0, 4, 1, 2, 3)
        x = (x * 2.0 + 0.5).to(torch.bfloat16)  # channels_last_3d, one video
        hb = h // SHARD_F
        blocks = [x[:, :, :, j * hb:(j + 1) * hb].contiguous(
            memory_format=torch.channels_last_3d) for j in range(SHARD_F)]
        wt = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        bs = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        yield (f"(1,{c},{t},{hb},{w}) x {SHARD_F} blocks {layout} eps={eps} silu={silu}", x,
               blocks, wt, bs, eps, silu)


def held_shapes() -> set:
    """(what, rows a call, tensor ranks, frame blocks) of the shapes the
    kernel phases hold against the plain versions: phase 4's UNet
    evaluations at B*T = 14 (the plain step), 28 and 56 (the served batch:
    K1-K3 and K7 cases, K4 / K5 at its GroupNorm sites), its conditioner
    pass at T and 2T frames (K4 / K5 at the served batch's sites) and its
    decode of T frames; the mesh phase's (b) at B*T = 28 with heads and
    inner columns / TP; the sharded phase's (b) at T / SHARD_F rows with K2
    on all T frames of 1 / SHARD_F of the positions."""
    held = {("unet", n, 1, 1) for n in (T, BT, SERVE_BATCH * BT)}
    held |= {("unet", BT, tp, 1) for tp in MESH_TP}
    held.add(("unet", T // SHARD_F, 1, SHARD_F))
    held |= {("conditioner", n, 1, 1) for n in (T, SERVE_BATCH * T)}
    held.add(("decode", T, 1, 1))
    return held


def served_mesh_shapes(data: int, fsdp: int, tensor: int, clips: int = SERVE_BATCH,
                       decoding_t: int = T) -> set:
    """The kernels' rank-local shapes, as held_shapes names them, when a
    served batch of `clips` clips runs on a data x fsdp x tensor mesh: each
    rank's UNet rows by the row rule (parallel/frames.py sample_rows on the
    CFG-doubled videos and the flagship's planes), its conditioner's frames
    and its decode chunks (engine/serving.py)."""
    from gcd_tpu_torch.engine.serving import block_items, unet_planes
    from gcd_tpu_torch.parallel.frames import sample_rows

    ranks = data * fsdp
    planes = unet_planes(HL, WL, len(LEVELS) - 1)
    out = set()
    for coord in range(ranks):
        plan = sample_rows(ranks, 2 * clips, T, coord, planes)
        rows = (plan.video_stop - plan.video_start) * (plan.frame_stop - plan.frame_start)
        out.add(("unet", rows, tensor, plan.frame_blocks if plan.frame_split else 1))
        videos = clips if ranks == 1 or clips == 1 else len(block_items(clips, ranks, coord))
        out.add(("conditioner", videos * T, 1, 1))
        out.add(("decode", decoding_t, 1, 1))  # chunk by chunk, on every rank
    return out


# The served meshes: an NCCL group of one (the sharded phase's (a)) and the
# four-card meshes of the infer entry's sharded runs (SHARD_MESHES).
SERVED_MESHES = {"one": (1, 1, 1), "data2": (2, 1, 1), "data2_fsdp2": (2, 2, 1),
                 "fsdp2_tensor2": (1, 2, 2)}


def served_mesh(smi: str, engine, served_run: dict) -> dict:
    """Sharded (a)'s mesh server, inside a process group of one: the
    engine's sharded sampler behind SamplerServer, which broadcasts each
    batch to the group (engine/server.py), and the HTTP handler, on the
    served phase's requests and seeds: frames bit-identical to the served
    phase's, launches equal; and every rank-local shape of SERVED_MESHES
    among held_shapes. Returns the launches over the requests."""
    from gcd_tpu_torch.engine.server import batch_check, make_engine_sample_fn, sample_keys
    from gcd_tpu_torch.parallel.mesh import create_mesh

    t0 = time.perf_counter()
    fn = make_engine_sample_fn(engine, SERVE_BATCH, T, decoding_t=T,
                               mesh=create_mesh(1, 1, 1, "cuda"))
    run = serve_requests(fn, served_run["requests"],
                         batch_check(sample_keys(engine), SERVE_BATCH, T, (H, W)),
                         mesh_device=torch.device("cuda", torch.cuda.current_device()))
    mesh_same = [np.array_equal(g, w) for g, w in zip(run["frames"], served_run["frames"])]
    shapes = {name: sorted(served_mesh_shapes(*mesh)) for name, mesh in SERVED_MESHES.items()}
    unheld = sorted({sh for v in shapes.values() for sh in v} - held_shapes())
    log("sharded_mesh_server", bit_identical_to_served=mesh_same, launches=run["launches"],
        served_launches=served_run["launches"], counts=run["counts"],
        served_frames_per_s=SERVE_REQUESTS * T / run["wall_s"],
        eager_served_frames_per_s=served_run["frames_per_s"],
        seconds=time.perf_counter() - t0, rank_local_shapes=shapes, unheld=unheld, card=smi)
    if not all(mesh_same) or run["launches"] != served_run["launches"] or unheld \
            or run["counts"] != (SERVE_REQUESTS // SERVE_BATCH, SERVE_REQUESTS):
        raise RuntimeError(f"sharded (a) mesh server: bit-identical {mesh_same}, launches "
                           f"{run['launches']} against {served_run['launches']}, counts "
                           f"{run['counts']}, shapes not held {unheld}")
    return run["launches"]


def sharded_phase(smi: str, phase6: dict, served_run: dict) -> tuple:
    """The sharded-sampling phase's (a) and (b), and (c) or the line saying
    why it did not run. Returns the kernel launches over (a)'s clip and
    over its mesh server's requests."""
    import socket

    from gcd_tpu_torch.engine.build import load_engine
    from gcd_tpu_torch.engine.serving import make_sharded_sampler
    from gcd_tpu_torch.ops import KERNELS, group_norm_plain, group_stats
    from gcd_tpu_torch.ops.fused_norm import group_norm_from_sums
    from gcd_tpu_torch.parallel import distributed
    from gcd_tpu_torch.parallel.frames import (pack_frames, pack_rows, position_block,
                                               unpack_frames, unpack_rows)
    from gcd_tpu_torch.parallel.mesh import create_mesh

    phase_t0 = time.perf_counter()
    # (a) make_sharded_sampler in an NCCL group of one, on phase 6's first
    # request: its batch and its generator's noise.
    t0 = time.perf_counter()
    engine = load_engine(CONFIG)
    load_s = time.perf_counter() - t0
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, torch.device("cuda"))
    clip_s, launches, same = [], None, False
    try:
        sample = make_sharded_sampler(engine, create_mesh(1, 1, 1, "cuda"), decoding_t=T)
        for rep in range(2):
            for fn in KERNELS.values():
                fn.launches = 0
            gen = torch.Generator("cuda").manual_seed(SEED + 10)
            batch = random_batch(gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = sample(batch, gen)["sampled_video"]
            torch.cuda.synchronize()
            clip_s.append(time.perf_counter() - t0)
            if rep == 0:
                launches = {name: fn.launches for name, fn in KERNELS.items()}
                same = torch.equal(frames.cpu(), phase6["frames"])
        mesh_launches = served_mesh(smi, engine, served_run)
    finally:
        distributed.shutdown()
    log("sharded_one_card", bit_identical_to_phase6=same, launches=launches,
        expected_per_clip=phase6["expected"], clip_seconds=clip_s,
        phase6_clip_seconds=phase6["clip_s"], engine_seconds=load_s, card=smi)
    del engine, sample, frames, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not same or launches != phase6["expected"]:
        raise RuntimeError(f"sharded (a): bit-identical {same}, launches {launches}, "
                           f"expected {phase6['expected']}")

    # (b) the kernels at a rank's shapes. P = 2 (V = 2, F = 1) runs the UNet
    # at B*T = 14, held in phase 4 (its "plain step" cases).
    log("sharded_kernel", ranks=2, shapes="B*T = 14: phase 4's plain-step cases", card=smi)
    gen = torch.Generator("cuda").manual_seed(SEED + 90)
    for name, label, run, plain, nbytes, flops, peak in shard_cases(gen, phase6["gn_unet"],
                                                                    phase6["gn_conv"]):
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        err = rel_l2(out, ref)
        same = rel_l2(run(), out) == 0.0
        (ms, _), (plain_ms, _) = cuda_ms(run), cuda_ms(plain)
        b_ms, b_by = bound(nbytes, flops, peak)
        log("sharded_kernel", ranks=SHARD_RANKS, kernel=name, shape=label, rel_l2=err,
            max_abs_err=max_abs(out, ref), bit_identical=same, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, card=smi)
        if not (err <= KERNEL_TOL and same):
            raise RuntimeError(f"sharded (b) {name} {label}: relative L2 {err}, second call "
                               f"identical {same}")
        del out, ref, run, plain
    for label, x, blocks, wt, bs, eps, silu in time_stack_cases(gen, phase6["gn_unet"]):
        s1, s2 = group_stats(x, G)
        parts = [group_stats(blk, G) for blk in blocks]
        p1, p2 = sum(p[0] for p in parts), sum(p[1] for p in parts)
        xf = x.float().reshape(1, G, -1)  # x is channels_last_3d: this copies
        scale1, scale2 = xf.abs().sum(-1), (xf * xf).sum(-1)
        sums_err = max(float(((p1 - s1).abs() / scale1).max()),
                       float(((p2 - s2).abs() / scale2).max()))
        count = x[0].numel() // G
        whole = group_norm_plain(x, wt, bs, G, eps, silu)
        hb = blocks[0].shape[3]
        errs, same = [], True
        for j, blk in enumerate(blocks):
            def run(blk=blk):
                return group_norm_from_sums(blk, wt, bs, G, eps, silu, p1, p2, count)
            out = run()
            errs.append(rel_l2(out, whole[:, :, :, j * hb:(j + 1) * hb]))
            same = same and rel_l2(run(), out) == 0.0
        (ms, _) = cuda_ms(lambda: [group_stats(blk, G) for blk in blocks])
        log("sharded_time_stack_groupnorm", shape=label, sums_rel_err=sums_err,
            rel_l2=max(errs), bit_identical=same, k5_blocks_ms=ms, card=smi)
        if not (sums_err <= 1e-5 and max(errs) <= KERNEL_TOL and same):
            raise RuntimeError(f"sharded (b) time_stack GroupNorm {label}: sums {sums_err}, "
                               f"relative L2 {errs}, second call identical {same}")
    # The two re-layouts, the all-to-all played by hand among SHARD_F
    # ranks' packs on the card: channels-last ds1 activations of 7 rows a
    # rank, and ds1 tokens.
    for what, whole in (("image (14,320,32,48) channels_last",
                         torch.randn(T, 32, 48, 320, generator=gen, device="cuda").to(
                             torch.bfloat16).permute(0, 3, 1, 2)),
                        ("tokens (14,1536,320)", torch.randn(T, 1536, 320, generator=gen,
                                                             device="cuda").to(torch.bfloat16))):
        rows = T // SHARD_F
        frames = [whole[i * rows:(i + 1) * rows] for i in range(SHARD_F)]
        packs = [pack_frames(f, T, SHARD_F) for f in frames]
        recv = [torch.stack([p[j] for p in packs]) for j in range(SHARD_F)]
        got = [unpack_rows(r, f, T, SHARD_F) for r, f in zip(recv, frames)]
        model = all(torch.equal(g, position_block(whole, SHARD_F, j)) for j, g in enumerate(got))
        packs = [pack_rows(g, T, SHARD_F) for g in got]
        back = [unpack_frames(torch.stack([p[j] for p in packs]), got[j], SHARD_F, (32, 48))
                for j in range(SHARD_F)]
        round_trip = all(torch.equal(b, f) for b, f in zip(back, frames))
        log("sharded_relayout", tensor=what, matches_model=model, round_trip_bit_identical=
            round_trip, card=smi)
        if not (model and round_trip):
            raise RuntimeError(f"sharded (b) re-layout of {what}: model {model}, round trip "
                               f"{round_trip}")
    torch.cuda.empty_cache()
    log("sharded_phase", one_card_seconds=time.perf_counter() - phase_t0, card=smi)

    # (c) across cards.
    if torch.cuda.device_count() >= MESH_CARDS:
        sharded_cards(smi)
        served_cards(smi)
        option_cards(smi)
    else:
        for what in ("sharded_cards", "served_cards", "option_cards"):
            log(what, ran=False, reason=f"{torch.cuda.device_count()} card(s); the "
                f"four-process runs need {MESH_CARDS} (python3 chip_smoke.py --sampling-cards "
                "on a machine of four)", card=smi)
    return launches, mesh_launches


def sharded_entry_child(argv) -> None:
    """One process of (c): the infer entry with `argv`, its clips wrapped to
    profile clip SHARD_PROFILED_CLIP whole and the SHARD_EVAL-th UNet
    evaluation of the clip after it; prints its results on one line."""
    from torch.profiler import ProfilerActivity, profile

    from gcd_tpu_torch import eval_utils, infer
    from gcd_tpu_torch.engine.engine import DiffusionEngine

    state = {"clip": 0, "eval": 0, "clip_ms": None, "eval_ms": None}

    def split_ms(prof):
        by = Counter()
        for ev in prof.key_averages():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(ev, "is_user_annotation", False)):
                by["nccl" if "nccl" in ev.key.lower() else "other"] += \
                    ev.self_device_time_total / 1e3
        return dict(by)

    make = eval_utils.make_sampler

    def making(*args, **kwargs):
        sample = make(*args, **kwargs)

        def wrapped(batch, seed):
            state["clip"] += 1
            state["eval"] = 0
            if state["clip"] != SHARD_PROFILED_CLIP:
                return sample(batch, seed)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = sample(batch, seed)
                torch.cuda.synchronize()
            state["clip_ms"] = split_ms(prof)
            return out

        return wrapped

    denoise = DiffusionEngine.denoise

    def profiled_denoise(self, *args, **kwargs):
        state["eval"] += 1
        if state["clip"] != SHARD_PROFILED_CLIP + 1 or state["eval"] != SHARD_EVAL:
            return denoise(self, *args, **kwargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = denoise(self, *args, **kwargs)
            torch.cuda.synchronize()
        state["eval_ms"] = split_ms(prof)
        return out

    eval_utils.make_sampler = making
    DiffusionEngine.denoise = profiled_denoise
    result = infer.main(argv)
    print("SHARD_RESULT " + json.dumps({
        "sample_seconds": None if result is None else result["examples"][0]["sample_seconds"],
        "clip_device_ms": state["clip_ms"], "eval_device_ms": state["eval_ms"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}), flush=True)


def sharded_cards(smi: str) -> None:
    """(c): the infer entry on one .npz clip of 14 seeded random frames,
    SHARD_SAMPLES samples, in one process and at each of SHARD_MESHES (four
    processes, or two at data 2; NCCL, one a card): every sample's frames
    within AB_TOL of the one-card run's from the same noise."""
    import socket

    work = tempfile.mkdtemp(prefix="gcd_shard_")
    try:
        clip = os.path.join(work, "clip.npz")
        rng = np.random.default_rng(SEED)
        np.savez(clip, frames=rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))

        def run(name, mesh):
            nproc = 1
            for _, n in zip(mesh[::2], mesh[1::2]):
                nproc *= int(n)
            out = os.path.join(work, name)
            args = ["--config_path", CONFIG, "--input", clip, "--output", out,
                    "--num_samples", str(SHARD_SAMPLES), "--seed", str(SEED), *mesh]
            group = []
            if nproc > 1:
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                group = ["--coordinator", f"127.0.0.1:{port}", "--num_processes", str(nproc)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", SHARD_CHILD, *args, *group,
                 *(["--process_id", str(pid)] if group else [])], cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for pid in range(nproc)]
            try:
                outs = [p.communicate(timeout=900)[0] for p in procs]
            finally:
                for p in procs:
                    p.kill()
            for p, o in zip(procs, outs):
                if p.returncode != 0:
                    raise RuntimeError(f"sharded (c) {name}: exit {p.returncode}: {o[-3000:]}")
            res = [json.loads(o.split("SHARD_RESULT ", 1)[1].splitlines()[0]) for o in outs]
            rule = [ln for ln in outs[0].splitlines() if ln.startswith("Sampling over")]
            frames = []
            for s in range(SHARD_SAMPLES):
                with np.load(os.path.join(out, f"clip_out{s}.npz")) as z:
                    frames.append(torch.from_numpy(z["frames"].astype(np.float32) / 255.0))
            samples_s = res[0]["sample_seconds"]
            clip_ms, eval_ms = res[0]["clip_device_ms"], res[0]["eval_device_ms"]
            result = {"run": name, "processes": nproc, "mesh": mesh, "row_rule": rule,
                      "clip_seconds": [samples_s[i] for i in SHARD_TIMED],
                      "all_sample_seconds": samples_s,
                      "unet_device_ms_an_evaluation": None if eval_ms is None else
                      eval_ms.get("other", 0.0),
                      "nccl_device_ms_an_evaluation": None if eval_ms is None else
                      eval_ms.get("nccl", 0.0),
                      "nccl_device_ms_a_clip": None if clip_ms is None else
                      clip_ms.get("nccl", 0.0),
                      "clip_device_ms": None if clip_ms is None else sum(clip_ms.values()),
                      "peak_mem_bytes_per_card": [r["peak_mem_bytes"] for r in res],
                      "seconds": time.perf_counter() - t0, "card": smi}
            log("sharded_run", **result)
            return frames

        ref = run("one", [])
        for name, mesh in SHARD_MESHES.items():
            got = run(name, mesh)
            rel = [rel_l2(g, r) for g, r in zip(got, ref)]
            log("sharded_cards", ran=True, run=name, against="one", frames_rel_l2=rel,
                tol=AB_TOL, card=smi)
            if not all(r <= AB_TOL for r in rel):
                raise RuntimeError(f"sharded (c) {name} against one card: {rel} > {AB_TOL}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The served runs across cards (sharded (c)): python -m gcd_tpu_torch.serve in
# one process, then in four at each of SERVE_CARD_MESHES; the served
# requests twice, the second round's one batch profiled on every process.
SERVE_CARD_MESHES = {"data2_fsdp2": ["--mesh_data", "2", "--mesh_fsdp", "2"],
                     "fsdp2_tensor2": ["--mesh_fsdp", "2", "--mesh_tensor", "2"]}
SERVE_CHILD = "import sys, chip_smoke; chip_smoke.served_entry_child(sys.argv[1:])"
# Calls of a served process's sample_fn: the warm-up, round one's two
# batches, then the profiled batch.
SERVE_PROFILED_CALL = 4


def served_entry_child(argv) -> None:
    """One process of the served runs across cards: gcd_tpu_torch.serve with
    `argv`, its sample_fn timed a call and its SERVE_PROFILED_CALL-th call
    profiled (NCCL against other device ms), and on that call its split
    decode timed by CUDA events beside the whole decode of the same latents
    (process 0); prints its results on one line after the stop."""
    from torch.profiler import ProfilerActivity, profile

    from gcd_tpu_torch import serve
    from gcd_tpu_torch.engine import server, serving
    from gcd_tpu_torch.parallel import distributed

    state = {"calls": 0, "call_s": [], "batch_device_ms": None, "decode_ms": None}

    def events(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    split_decode = serving.split_decode

    def timed_split_decode(engine, mesh, decoding_t):
        decode = split_decode(engine, mesh, decoding_t)

        def wrapped(z):
            if state["calls"] != SERVE_PROFILED_CALL:
                return decode(z)
            out, split_ms = events(lambda: decode(z))
            whole_ms = None
            if distributed.is_main():
                _, whole_ms = events(lambda: engine.decode_first_stage(
                    z, decoding_t or engine.en_and_decode_n_samples_a_time))
            state["decode_ms"] = {"split": split_ms, "whole": whole_ms}
            return out

        return wrapped

    make = server.make_engine_sample_fn

    def making(*args, **kwargs):
        fn = make(*args, **kwargs)

        def wrapped(batch, seeds):
            state["calls"] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if state["calls"] != SERVE_PROFILED_CALL:
                out = fn(batch, seeds)
            else:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = fn(batch, seeds)
                    torch.cuda.synchronize()
                by = Counter()
                for ev in prof.key_averages():
                    if ev.device_type == torch.autograd.DeviceType.CUDA:
                        by["nccl" if "nccl" in ev.key.lower() else "other"] += \
                            ev.self_device_time_total / 1e3
                state["batch_device_ms"] = dict(by)
            torch.cuda.synchronize()
            state["call_s"].append(time.perf_counter() - t0)
            return out

        return wrapped

    serving.split_decode = timed_split_decode
    server.make_engine_sample_fn = making
    serve.main(argv)
    print("SERVE_RESULT " + json.dumps({**state,
                                        "peak_mem_bytes": torch.cuda.max_memory_allocated()}),
          flush=True)


def served_cards(smi: str) -> None:
    """Sharded (c), served: python -m gcd_tpu_torch.serve (the flagship's
    seeded random weights, max_batch SERVE_BATCH, decoding_t T) in one
    process, then in four processes (NCCL, one a card) at each of
    SERVE_CARD_MESHES; the served phase's four requests at once, then two
    more (one batch, profiled), then SIGINT to process 0. Gates: every
    request's frames within SERVE_TOL of the one-process server's, every
    process exits 0 after the stop. Logs served frames/s, the wall s of
    each sample_fn call, peak memory a card, process 0's decode split
    against whole (CUDA-event ms) and each process's NCCL device ms in the
    profiled batch."""
    import signal
    import socket
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    requests = served_requests(None)

    def run(name, mesh):
        nproc = 1
        for _, n in zip(mesh[::2], mesh[1::2]):
            nproc *= int(n)
        http = free_port()
        args = ["--config_path", CONFIG, "--max_batch", str(SERVE_BATCH), "--decoding_t",
                str(T), "--port", str(http), "--max_wait_ms", "2000", *mesh]
        group = (["--coordinator", f"127.0.0.1:{free_port()}", "--num_processes", str(nproc)]
                 if nproc > 1 else [])
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", SERVE_CHILD, *args, *group,
                                   *(["--process_id", str(pid)] if group else [])], cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for pid in range(nproc)]
        try:
            url = f"http://127.0.0.1:{http}"
            while True:
                try:
                    with urllib.request.urlopen(f"{url}/healthz", timeout=5):
                        break
                except OSError:
                    if any(p.poll() is not None for p in procs) or \
                            time.perf_counter() - t0 > 900:
                        raise RuntimeError(f"served (c) {name}: the server did not start")
                    time.sleep(1.0)
            up_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            with ThreadPoolExecutor(len(requests)) as pool:
                outs = list(pool.map(lambda r: post_npz(f"{url}/sample", r), requests))
            wall = time.perf_counter() - t1
            with ThreadPoolExecutor(SERVE_BATCH) as pool:
                list(pool.map(lambda r: post_npz(f"{url}/sample", r), requests[:SERVE_BATCH]))
            procs[0].send_signal(signal.SIGINT)
            logs = [p.communicate(timeout=300)[0] for p in procs]
        except Exception as e:
            for p in procs:
                p.kill()
            tails = [p.communicate()[0][-2000:] for p in procs]
            raise RuntimeError(f"served (c) {name}: {e}; the processes' output: {tails}") from e
        finally:
            for p in procs:
                p.kill()
        for p, o in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"served (c) {name}: exit {p.returncode}: {o[-3000:]}")
        res = [json.loads(o.split("SERVE_RESULT ", 1)[1].splitlines()[0]) for o in logs]
        log("served_run", run=name, processes=nproc, mesh=mesh, startup_seconds=up_s,
            requests_wall_s=wall, served_frames_per_s=SERVE_REQUESTS * T / wall,
            sample_fn_seconds=res[0]["call_s"],
            batch_device_ms=[r["batch_device_ms"] for r in res],
            decode_ms_process0=res[0]["decode_ms"],
            peak_mem_bytes_per_card=[r["peak_mem_bytes"] for r in res],
            row_rule=[ln for ln in logs[0].splitlines() if ln.startswith("Sampling over")],
            exit_codes=[p.returncode for p in procs], seconds=time.perf_counter() - t0,
            card=smi)
        return [o["sampled_video"] for o in outs]

    ref = run("one", [])
    for name, mesh in SERVE_CARD_MESHES.items():
        got = run(name, mesh)
        rel = [rel_l2(torch.from_numpy(g), torch.from_numpy(r)) for g, r in zip(got, ref)]
        log("served_cards", ran=True, run=name, against="one", frames_rel_l2=rel,
            tol=SERVE_TOL, card=smi)
        if not all(r <= SERVE_TOL for r in rel):
            raise RuntimeError(f"served (c) {name} against one card: {rel} > {SERVE_TOL}")


# Option UNet A across cards: its 3 x 3 x 3 time kernel under the
# sampler's frame groups and its layers under the tensor cut.
OPTION_CARDS_CHILD = "import sys, chip_smoke; chip_smoke.option_cards_child(sys.argv[1:])"


def option_cards_child(argv) -> None:
    """One process of option_cards: card `rank` of an NCCL group of
    MESH_CARDS. Option UNet A (OPTION_UNETS["A"]: the 3 x 3 x 3 time
    kernel, scale-shift norm, resblock up / down, 1 x 1 conv projections,
    fixed blends, no per-frame temporal context) at svd_gcd's widths on
    seeded weights and one CFG-doubled 14-frame batch of 32 x 48 latents:
    (i) whole on this card; (ii) under the sampler's frame groups
    (sample_rows: V = 2 video blocks of F = 2 frame blocks, every plane in
    row bands, each time_stack conv taking its neighbours' edge rows), the
    rows all-gathered; (iii) cut over a tensor axis of MESH_CARDS
    (unet_placements, cut_unet). Prints one OPTION_RESULT line: (ii) and
    (iii) against (i), and what was cut."""
    import torch.distributed as dist

    from gcd_tpu_torch.models.unet import VideoUNet
    from gcd_tpu_torch.parallel.frames import FrameGroup, frame_sharding, sample_rows
    from gcd_tpu_torch.parallel.mesh import create_mesh, unet_placements
    from gcd_tpu_torch.parallel.tensor import cut_unet
    from gcd_tpu_torch.utils.config import load_config

    rank, size, port = (int(a) for a in argv)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=size,
                            rank=rank, device_id=torch.device("cuda", rank))
    base = load_config(CONFIG)["model"]["params"]["network_config"]["params"]
    gen = torch.Generator("cuda").manual_seed(SEED + 40)
    with torch.device("meta"):
        unet = VideoUNet(**{**base, **OPTION_UNETS["A"]})
    unet = seeded_weights_(unet.to(torch.bfloat16).to_empty(device="cuda").eval(), gen)
    y_dim = base["adm_in_channels"] + base.get("aux_emb_dim", 0)
    x = torch.randn(BT, HL, WL, base["in_channels"], generator=gen,
                    device="cuda").permute(0, 3, 1, 2).to(torch.bfloat16)
    sigma = torch.randn(BT, generator=gen, device="cuda")
    context = torch.randn(BT, 1, base["context_dim"], generator=gen,
                          device="cuda").to(torch.bfloat16)
    y = torch.randn(BT, y_dim, generator=gen, device="cuda").to(torch.bfloat16)
    ioi = torch.zeros(BT // T, T, device="cuda")

    def call(rows=slice(None), videos=slice(None)):
        return unet(x[rows], sigma[rows], context[rows], y[rows], num_video_frames=T,
                    image_only_indicator=ioi[videos])

    with torch.no_grad():
        whole = call()
        # (ii) the frame groups of sample_rows over the world, each made by
        # every process in the same order.
        planes = [HL * WL // 4 ** i for i in range(len(base["channel_mult"]))]
        plan = sample_rows(size, BT // T, T, rank, planes)
        groups = [dist.new_group(list(range(v * plan.frame_blocks,
                                            (v + 1) * plan.frame_blocks)))
                  for v in range(plan.blocks)]
        fg = FrameGroup(groups[plan.video_block], plan.frame_blocks, plan.frame_block, T)
        with frame_sharding(fg):
            mine = call(slice(plan.video_start * T, plan.video_stop * T),
                        slice(plan.video_start, plan.video_stop)).contiguous()
        parts = [torch.empty_like(mine) for _ in range(size)]
        dist.all_gather(parts, mine)
        per = plan.frame_stop - plan.frame_start
        framed = torch.stack(parts).reshape(plan.blocks, plan.frame_blocks, -1, per,
                                            *mine.shape[1:]).transpose(1, 2)
        framed = framed.reshape(BT, *mine.shape[1:])
        # (iii) the tensor cut.
        mesh = create_mesh(1, 1, size)
        placements = unet_placements(unet, 1, size)
        cut = cut_unet(unet, placements, mesh.coords["tensor"], size, mesh.tensor_group)
        tensor_out = call()
    result = {"rank": rank, "frame_blocks": plan.frame_blocks, "video_blocks": plan.blocks,
              "replicated": plan.replicated,
              "frame_group_rel_l2": rel_l2(framed, whole),
              "frame_group_bit_identical": bool(torch.equal(framed, whole)),
              "tensor_rel_l2": rel_l2(tensor_out, whole),
              "cut_layers": len(cut), "cut_params": sum(p.tensor_dim is not None
                                                        for p in placements.values()),
              "finite": bool(torch.isfinite(whole).all() and torch.isfinite(framed).all()
                             and torch.isfinite(tensor_out).all())}
    print("OPTION_RESULT " + json.dumps(result), flush=True)
    dist.destroy_process_group()


def option_cards(smi: str) -> None:
    """(c) of option UNet A across MESH_CARDS cards (option_cards_child):
    the frame-group evaluation and the tensor-cut one within AB_TOL of the
    whole one on every rank, the frame groups not replicated, the cut
    reaching some layers."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", OPTION_CARDS_CHILD, str(rank),
                               str(MESH_CARDS), str(port)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(MESH_CARDS)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"option cards: exit {p.returncode}: {o[-3000:]}")
    res = [json.loads(o.split("OPTION_RESULT ", 1)[1].splitlines()[0]) for o in outs]
    log("option_cards", ran=True, unet="A", options=OPTION_UNETS["A"], ranks=res, tol=AB_TOL,
        seconds=time.perf_counter() - t0, card=smi)
    bad = [r for r in res if not (r["finite"] and r["frame_group_rel_l2"] <= AB_TOL
                                  and r["tensor_rel_l2"] <= AB_TOL and not r["replicated"]
                                  and r["cut_layers"] > 0)]
    if bad:
        raise RuntimeError(f"option UNet A across cards: {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    sys.path.insert(0, REPO)
    from gcd_tpu_torch.ops import KERNELS, _native

    t0 = time.perf_counter()
    _, ptxas = _native.build()
    _native.library()
    # nvcc -Xptxas -v's registers, shared memory, spills and stack of the
    # PTXAS_ENTRIES kernels (mangled names), and its notes that it serialised
    # a kernel's wgmma products (C751x); empty when the build was cached.
    entry, ptxas_lines = "", {}
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif any(k in entry for k in PTXAS_ENTRIES) and ("Used" in line
                                                          or "stack frame" in line):
            ptxas_lines.setdefault(entry, []).append(line.split(": ", 1)[-1].strip())
        if "Potential Performance Loss" in line and line.count("'") >= 2:
            where = line.rsplit("'", 2)[-2]
            if any(k in where for k in PTXAS_ENTRIES):
                note = line.split(": ", 1)[-1].split(" in the function")[0].strip()
                ptxas_lines.setdefault(where, []).append(note)
    log("build", seconds=time.perf_counter() - t0, ptxas=ptxas_lines)
    if "--mesh-cards" in sys.argv[1:]:
        if torch.cuda.device_count() < MESH_CARDS:
            print(f"chip_smoke --mesh-cards: needs {MESH_CARDS} cards", file=sys.stderr)
            return 1
        mesh_cards(smi)
        sharded_cards(smi)
        served_cards(smi)
        option_cards(smi)
        return 0
    if "--sampling-cards" in sys.argv[1:]:
        if torch.cuda.device_count() < MESH_CARDS:
            print(f"chip_smoke --sampling-cards: needs {MESH_CARDS} cards", file=sys.stderr)
            return 1
        sharded_cards(smi)
        served_cards(smi)
        option_cards(smi)
        return 0
    if "--option-cards" in sys.argv[1:]:
        if torch.cuda.device_count() < MESH_CARDS:
            print(f"chip_smoke --option-cards: needs {MESH_CARDS} cards", file=sys.stderr)
            return 1
        option_cards(smi)
        return 0

    stats, launches, served_run, launch_model, phase6_clip, samplers_launches = serve(smi)
    served_launches = served_run["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    first_stage_launches = first_stage_phase(smi, launch_model)
    gc.collect()
    torch.cuda.empty_cache()
    cond_launches, option_launches = conditioning_phase(smi, launch_model, phase6_clip)
    gc.collect()
    torch.cuda.empty_cache()
    export_launches, artifact_launches = export_phase(smi, phase6_clip, served_run)
    train_launches, phase7 = train(smi)
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="gcd_entry_")
    try:
        entry_launches, logdir = entry_phase(smi, phase7, work)
        gc.collect()
        torch.cuda.empty_cache()
        eval_launches = eval_phase(smi, launch_model, logdir, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    pardom_launches = pardom_phase(smi, launches, phase7)
    gc.collect()
    torch.cuda.empty_cache()
    options_launches = options_phase(smi, launches, phase7)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches = mesh_phase(smi, phase7)
    gc.collect()
    torch.cuda.empty_cache()
    sharded_launches, served_mesh_launches = sharded_phase(smi, phase6_clip, served_run)

    # `launches`: the sample_video requests for K1-K5 and K7, the Adam steps
    # for K6 (which only training runs); `served_launches`: the served phase's
    # two batches; `train_launches`: the Adam steps for all.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": train_launches[name] if name == "flash_bwd" else launches[name],
         "served_launches": served_launches[name], "export_launches": export_launches[name],
         "served_artifact_launches": artifact_launches[name],
         "served_mesh_launches": served_mesh_launches[name],
         "train_launches": train_launches[name],
         "entry_launches": entry_launches[name], "eval_launches": eval_launches.get(name, 0),
         "pardom_launches": pardom_launches[name],
         "options_launches": options_launches.get(name, 0),
         "mesh_launches": mesh_launches.get(name, 0),
         "sharded_launches": sharded_launches.get(name, 0),
         "samplers_launches": samplers_launches.get(name, 0),
         "first_stage_launches": first_stage_launches[name],
         "conditioning_launches": cond_launches[name],
         "option_unet_launches": option_launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"], "bound_ms": stats[name]["bound_ms"],
         "bound_by": "bytes" if stats[name]["t_bytes"] >= stats[name]["t_ops"]
         else "operations",
         "library_ms": stats[name]["library_ms"],
         **{k: stats[name][k] for k in ("device_ms", "plain_device_ms", "library_device_ms")
            if k in stats[name]}}
        for name in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
