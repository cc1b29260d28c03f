"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which raises on failure (nothing catches it, so the script
exits non-zero):

1. The card (nvidia-smi name and power limit), torch and CUDA versions.
2. Build every CUDA kernel from ``tinysplat_torch/csrc`` (nvcc, sm_90a).
3. Hold K1 (``composite_fwd``) against its plain PyTorch version on small
   synthetic cases: mixed scenes at tile widths 16, 48 (an image 100 px
   tall) and 64, heavy occlusion that saturates T, a tile deeper than two
   batches, mostly empty tiles, and a tile whose 16x16 sub-tiles end at
   very different depths.
4. Serve frames at full width: the bench scene (262,144 splats, SH degree
   3, 1066x1600) written as a JAX-layout ``.npz`` checkpoint, loaded with
   ``load_model`` and rendered along an orbit through ``render``. The launch
   counts show the frames went through K1; the frames are checked, and K1
   is held against its plain version and timed at the frames' own shapes,
   where the work counters give its bound.
5. Hold K2 (``composite_bwd``) and K3 (``segsum``) against their plain
   versions on phase 3's cases, with a numpy-drawn cotangent: per-entry rows
   and the per-splat rows of all four ``grad_reduce`` strategies; two K2
   launches must give the same bytes, and K3 must equal its plain version
   bit for bit, twice (here and in phases 6 and 7).
6. Train at full width: the bench scene, GT frames rendered from it at 4
   orbit cameras, training from dimmed opacities and perturbed colours. 10
   steps with ``grad_reduce="scatter"`` (K1 and K2 launch once per step; the
   loss falls), then 3 with ``"mxu"`` (K3 once per step; its gradients equal
   the scatter path's). K2 and K3 are held against their plain versions and
   timed at step 0's shapes, where the compositing work counters are printed
   (``composite_counts``: pairs walked, inside the splats' boxes and kept,
   (entry, warp) pairs with a kept pixel, entries per tile and per
   sub-tile) and give K2's instruction bound; the entry -> splat reduction
   layer is timed under "mxu" (the sort, the bounds and K3) and "scatter";
   the step is broken down into layers.
7. The trainer at full width (``train_loop.Trainer``, ``"mxu"``): phase 6's
   start and views, densify every 4 steps up to step 8, an opacity reset and
   a checkpoint at step 8, the NaN guard every 4. tau_means is set so that
   60% of the live splats pass it at the first densify; the first pass fills
   the 524,288 slots partly, the second overflows them, grows capacity to
   1,048,576 and is redone. 12 steps (K1, K2, K3 once each per step); K1,
   K2 and K3 held against their plain versions at the last step's state,
   camera and budgets (the grown capacity, tiles up to 8192 deep), with the
   counters, and K1, K2 and K3 timed there; then a
   fresh trainer from the step-8 checkpoint replays steps 9-12 and must
   equal the first run to 1e-5 x column max; 4 steps with pose_opt and
   app_opt; evaluate() on a held-out orbit view; a 3-step torch.profiler
   window (top ops, share of the window with a kernel running); the median
   step time.
8. The probes P1 (``probes.bitcast``) and P2 (``probes.op_costs``) through
   their entry points: every P1 variant exact against the numpy ground
   truth and equal to its plain version, every P2 row within its stated
   tolerance of its plain version, with times and bounds.
9. The dataset path at full width: a COLMAP capture of the bench scene
   written with the port's writers (one PINHOLE camera at 1066x1600, the
   8 orbit views' ground truth rendered by K1 and saved as PNG, 131,072 of
   the scene's means with their DC colours as ``points3D.bin``, each
   image's observations of the points that project inside it), read by
   ``train_cli.build_scene``; ``DepthEstimator`` with ``sparse_interp``
   twice (fills the cache, then reads it); a ``Trainer`` ("mxu",
   ``regularize_depth``) initialised from the SfM points in 262,144 slots
   runs 12 steps under ``run_async`` while a ``Viewer`` on port 0 serves
   full-width frames to a websocket client (launch counts: one K1 per step
   and per frame, one K2 and K3 per step; the loss over all views falls);
   K1 bit-equal to its plain version at the last served camera, K2 and K3
   (bit for bit, twice) at the last step; ``export_cli`` writes PLY and
   .splat from the step-12 checkpoint, and the ``import_ply`` state renders
   the trainer's frame to 2e-4. Prints load, depth (cold and cached), step,
   frame latency, export times, file sizes and peak memory.
10. Density regularization + MCMC, then meshes: the bench scene in 524,288
   slots with its own opacities, perturbed colours and 5% of the live
   splats at opacity logit -7; 12 ``Trainer`` steps with
   ``densify_strategy="mcmc"`` (refine passes at 4 and 8) and
   ``regularize_density`` from step 2 (100,000 probe samples; refreshes at
   2, 5 and 9). The density-start prune removes every splat below opacity
   0.5, the dimmed ones too, so 5% of the live ones are dimmed again
   before step 4. Checks: 12 launches each of K1, K2, K3; relocated > 0 at
   the first pass; three refreshes; the objective (L1 + DSSIM over the 4
   views) falls from the state the first pass starts from; K1 bit-equal,
   K2 within 1e-5 x column max and K3 bit-equal, twice, at step 12 with
   the depth cotangent the density term feeds; ``density_fwd`` and
   ``density_bwd`` once each a step from step 2, and at step 12 the term
   through them held against its plain torch ops on the same last probe,
   splats and rendered depth (float64 the reference, ``density_cuda``'s
   bounds), density mode and SDF mode with the camera's gradient, and
   their device times there (rows of the kernels' line). Then ``export_cli
   --filetype OBJ`` from the step-12 checkpoint, marching cubes at 128^3
   and Poisson at the default depth (a 256^3 grid): each mesh non-empty,
   faces in range, unit normals where a vertex has one, vertices in the
   live means' box padded by 10%. Prints each refresh's sampling and KNN
   times against the KNN's bounds, the KNN's addmm and top-k for one
   chunk, each pass's relocated / grown / live, loss_density per step,
   the median step, peak memory and each mesh stage's time.
   ``--mesh-256`` also exports at the CLI's default ``--resolution 256``.
11. Multi-device training on ``torch.distributed``: the bench scene at
   1600x1024 (1066 cut to a multiple of 64, so that 2 and 4 bands of whole
   16-px tile rows divide it) on a (2, 2) mesh of 4 ranks started by
   ``parallel.local.run``. The ranks share the one card, so they run gloo
   with the collectives staged through pinned host memory; the times are
   time-sliced, not scaling figures. Interleaved bands of 32 tile-row
   groups; 2 cameras a step. Each rank renders 4 orbit frames through
   ``make_sharded_render`` (held to the one-device ``render`` to 2e-5);
   then ``MeshTrainer`` trains 8 steps from phase 6's start in 262,144
   slots, densify at step 4 (every live splat cloned: the capacity grows
   to 786,432 and re-shards) and a sharded checkpoint at step 8, which
   this process restores alone (bit-equal). A 1-rank world (NCCL, mesh
   (1, 1), batch 2) trains the same 8 steps, held to the 4 ranks at the
   1-vs-N bar of the JAX suite. On rank 0's band at the last step K1 (bit
   for bit), K2 (1e-5 x column max, twice the same bytes) and K3 (bit for
   bit) are held against their plain versions. Prints step ms per rank,
   each collective's seconds (parameter gather, attribute gather,
   reduce-scatter, SSIM halo, psum, and the host staging inside them) and
   the phase's seconds.

12. Diffusion-guided novel views: a diffusers directory with the published
   Stable Diffusion v1.5 unet/ and vae/ configs and seeded random weights
   (~0.94B parameters, float16 safetensors, deleted at the end) loads through
   ``TinysplatDiffusionPipeline.from_pretrained`` onto the card, and a
   ``Trainer`` with ``regularize_diffusion`` trains 12 steps from phase 6's
   start (262,144 splats, 4 views at 1066x1600, "mxu"): refreshes at steps 2,
   4 and 8 render 2 novel views each at 512x512 (K1), refine them (VAE
   encode, 5 DDIM steps at CFG batch 2 of 8 at strength 0.6, VAE decode) and
   train on them; step 10 removes them. Then one refresh with the tiny
   pipeline (no directory: latent 16, 128x128, the feature-volume path).
   Checks: K1 = 12 steps + one render per synthetic view, K2 = K3 = 12;
   cameras per step; frames finite in [0, 1]; finite losses; no cached frame
   of a removed camera; K1 bit-equal to its plain version on a 512x512
   refresh render; the full-width UNet (batch 1) and VAE decode on the card
   against copies on the host CPU (TF32 off); the tiny pipeline on the card
   against the CPU with the same weights and draws. Prints the directory's
   write and load seconds, each refresh's seconds and CUDA-event ms per
   stage (VAE encode, UNet per DDIM step, VAE decode) beside each stage's
   FLOP and bound, refresh steps beside plain steps, and peak memory.

13. The quality tools (``tinysplat_torch/scripts``) through their ``main``,
   each with the launch counters from 0 (K1 and K2 once per training step
   and per render; K3 0: the tools keep Config's ``grad_reduce`` "scatter"),
   at their published widths and cut in depth only (``QB_ARGS`` and the rest):
   (a) ``quality_bench``, 36 GT views of the 91,000-splat scene at 1600x1056
   (each must drop nothing at max_per_tile 8192), 32 train / 4 eval, 16,000
   uniform init points in 131,072 slots, 1000 steps with a held-out eval
   every 250 (the PSNR must rise) and at half scale; K1 on GT view 0 against
   its plain version on the card (bit for bit) and on CPU copies; (b)
   ``train_diffusion_prior``, 96 GT views at 128x128 (max_per_tile 16384,
   nothing dropped, K1 on view 0 as in (a)), 100 VAE and 200 denoiser steps
   at batch 8 (each loss must fall), the native checkpoint reloaded equal;
   (c) ``diffusion_ab`` with that prior, 6 + 6 views at 128x128, 4000 init
   points in 32,768 slots, 160 steps per arm, one refresh at step 40 (K1
   once per synthetic view); (d) ``quality_real`` on a copy of the in-repo
   8-view real-photo capture (240x180, OPENCV distortion, sparse_interp
   depth), 300 steps, the fixture unchanged; (e) ``train_1m_probe``, 20 steps
   at 1,000,000 live splats, 1600x1056, 8 cameras, GT with nothing dropped.
   Prints each tool's JSON numbers, seconds and peak device memory.

14. The profiling, sweep and scaling tools (``tinysplat_torch/scripts``)
   through their ``main`` at their defaults, each with the launch counters
   from 0 and its launches checked against its count of gradients: (a)
   ``profile_bench``, the bench scene at 16-px tiles and its own budgets
   (``max_per_tile`` 2048): its drop counters are printed, its top-ops table
   must name K1's and K2's ``__global__`` functions and its kernel-busy share
   lie in (0, 1]; (b) ``profile_train_step``: its top 15 rows, busy share
   and device ms a step; (c) ``sweep_bench`` with JAX's three configs and
   ``mxu:8:128:64``, then with ``--diag``: no line may hold an ``error`` or
   claim ``tiles_per_block`` was read, and the mxu config must launch K3;
   (d) ``scaling_bench``, 8 ranks on the card at 512x512 and 4 cameras,
   each rank's launches counted too; its line printed beside the band
   counts of ``SCALING_r03.json`` (a CPU run of the JAX package, for
   context: no assertion, and no time compared); (e) ``scaling_model`` at
   its widths (217,000 splats at 1600x1024), every band probed to drop
   nothing. Cuts: none (``SM_ARGS`` keeps --iters 20). Prints each tool's
   seconds and peak device memory and the phase's seconds.

15. The headline bench (``tinysplat_torch/scripts/bench.py``) through its
   ``main`` at its defaults (the bench scene, 262,144 splats at 1066x1600,
   5 warm-up + 30 timed gradients, then 1 + 15 train steps), once with
   ``--grad-reduce scatter`` and once with ``mxu``, each with the launch
   counters from 0: K1 = K2 = 51 a run, K3 51 under "mxu" and 0 under
   "scatter". Each run must print its headline and final JSON lines last,
   with the keys of ``BENCH_r05.json``'s record (a TPU v5e run of the JAX
   package: its numbers are printed for context only), finite positive
   numbers, no entry dropped by the timed gradient or the first train step,
   the same device memory in use after the timed gradients as before them,
   and a peak after them within the allocator's slack of the first
   gradient's (``LARGE_BLOCK_SLACK``). Then ``python -m
   tinysplat_torch.scripts.bench --headline-only`` runs as a process of its
   own and must print a headline. Prints each run's lines, seconds and
   device memory.

16. Tile heights other than 16 px (the JAX package's ``tile_size``) on the
   bench scene (262,144 splats, SH degree 3, 1066x1600, a multiple of
   neither 8 nor 32: the bottom tiles are ragged), with binning budgets
   sized from one binning to hold every entry (the intersections and the
   deepest tile printed; nothing may drop): (a) one frame through
   ``render`` at phase 4's camera at 8x8, 32x32 and 32x64 tiles (K1 = 3
   launches), each printed against phase 4's 16x64 frame (render's 3-sigma
   radius boxes make the frames differ where a splat's alpha support
   passes its box: which pixels past the box it reaches depends on the
   tile edges), and with the splats' radii widened to hold their whole
   alpha support, held to the 16x64 frame at FRAME_TOL (bit-equal
   expected); K1 bit-equal to its plain version at each frame's shapes; (b)
   ``train_loop.Trainer`` from phase 6's start and views, 6 steps at 32x32
   tiles under "mxu" (K1 = K2 = K3 = 6) and 6 at 8x8 under "scatter" (K1 =
   K2 = 6, K3 = 0): nothing dropped, the objective over the views falls;
   (c) K2 (within 1e-5 x column max, twice the same bytes) and K3 (bit for
   bit, twice) against their plain versions at step 0's shapes at 8x8,
   32x32 and 32x64 tiles; (d) the exact launch counts above; (e) K1's and
   K2's device times at each shape beside their bounds from the work
   counters and their 16x64 times from phases 4 and 6.

17. The splat-input kernels S1 (``splat_fwd``) and S2 (``splat_bwd``,
   ``tinysplat_torch/ops/splat_inputs_cuda.py``) on the bench scene (its
   524,288 slots at 1066x1600) and in phase 7's grown 1,048,576 slots (the
   slots past the scene dead): (a) S1 against its plain version at active
   degrees 0 and 3, antialiased off and on, both ``viewdirs_mode``s (each
   float output within ``FWD_TOL`` x its column max, printed with whether it
   is bit-equal; radii and tile counts equal but at rounding boundaries,
   counted; valid equal); (b) S2 against its plain version and against
   autograd through the plain forward, with a numpy-drawn cotangent and
   ``pose_opt``'s camera gradients (``BWD_TOL`` x column max), and twice the
   same bytes; (c) S1's and S2's device times beside their bounds and their
   plain versions' times, S2's with the camera gradient too, and S2's
   registers, local (spill) bytes, shared memory and resident blocks an SM
   at every SH degree, as the CUDA runtime reports them; (d) the ``splat_inputs`` layer, a frame and a bare
   "scatter" step through the kernels and the plain way (``splat_inputs``'
   Function swapped for the plain forward under autograd), in turns
   kernels, plain, plain, kernels; the launches of the first turn counted
   (and none of S1 and S2 in the plain turns), then the step's layers.
   Every earlier phase runs S1 and S2 too: each counted window expects one
   S1 per K1 launch and one S2 per K2 launch.

18. The binning kernels B1-B4 (``bin_count``, ``bin_emit``, ``radix_hist``,
   ``radix_scatter``, ``tinysplat_torch/ops/binning_cuda.py``) on the bench
   scene (524,288 slots, 1066x1600): (a) every stage against its plain
   version on the card, fed the plain version's output of the stage before,
   and the whole ``DenseBins`` against ``bin_splats_dense_plain``, bit for
   bit with the counters equal, at 16x64 tiles with the bench budgets, in
   phase 7's grown 1,048,576 slots, at 8x8 and 32x32 (budgets that hold
   every entry) and with the entries cut at half, the spans at a third and
   ``max_per_tile`` 128; (b) two runs of the kernels the same bytes; (c)
   ``tile_inputs`` under ``torch.cuda.set_sync_debug_mode("error")`` (must
   raise nothing), and whether a whole frame does (printed with the first
   op that syncs); (d) B1-B4's device times beside their byte bounds, their
   plain versions' and ``torch.sort(stable=True)``'s on the same tile ids
   (B3 / B4's library yardstick), the radix sort and the whole binning; (e)
   the ``tile_inputs`` layer, a frame and a bare "scatter" step through the
   kernels and the plain way (``bin_splats_dense_plain`` swapped into
   ``tile_inputs``), in turns kernels, plain, plain, kernels, the launches
   counted. Every earlier counted window expects B1 and B2 once per
   binning (once per K1 launch, plus scaling_bench's direct binnings) and
   B3 and B4 once per digit pass: two a binning at every full-size grid,
   one at 128x128 and 240x180 (``check_launches``).

19. SSIM's kernels L1 (``ssim_fwd``) and L2 (``ssim_bwd``,
   ``tinysplat_torch/ops/ssim_cuda.py``) at 1066x1600: (a) against their
   plain versions on phase 6's trained frame and its ground truth, and on a
   uniform image and a noisy copy (the map's absolute gap, the partials'
   and both images' gradients over their max, under the mean's broadcast
   upstream gradient and a random one; within ``ssim_cuda.TOL`` on the
   uniform pair; on the frame, L2 within it and L1's map and L1 -> L2's
   gradients no further from the float64 plain version than
   ``SSIM_FRAME_RATIO`` x the float32 plain version), twice the same
   bytes; (b) the
   loss's ``ssim(...).backward()`` under
   ``torch.cuda.set_sync_debug_mode("error")``, one L1 and one L2; (c)
   their device times beside their byte bounds, the plain versions' and the
   port's earlier cuDNN chain's (``cudnn_ssim``, the library yardstick; the
   port never calls it). Every earlier counted window expects one L1 and
   one L2 a training step and one more L1 an eval view
   (``check_launches``).

20. The compositing backward's "scatter" reduction ``scatter_rows``
   (``csrc/scatter_rows.cu``) at phase 6's step-0 rows and at the entries
   of the benchmark's ``splats-262k`` and ``splats-1m`` configurations
   (their seed-0 cloud at their first training view, their budgets' pad
   slots kept, K2's rows): one launch a call, each splat's row within the
   float32 rounding of its adds of a float64 ``index_add_``, the sentinel
   row 0; its device time (the zeroed output and the kernel) beside its
   byte bound, the plain version's (``scatter_rows_plain``) and one
   ``index_add_``'s (the library yardstick the port used before). Its
   launches in the main path are those of the counted windows
   (``check_launches``: one a "scatter" backward, none under "mxu").

Phase 9 ends with the ``evaluate`` CLI on its step-12 checkpoint (every
second view), whose per-view PSNR must equal ``Trainer.evaluate``'s to
1e-3 dB.

The line before the last is the kernels' JSON record (K1-K3's, S1's,
S2's, B1-B4's, L1's, L2's and ``scatter_rows``' launches sum the counted
windows of phases 6, 10, 11, 12, 13, 14, 15, 16, 17 and 18,
``launches_by_phase``; phase 11's sum the four ranks' training windows and
phase 14's include scaling_bench's nine ranks; ``scatter_rows``' numbers
are its 1M layout's); the last line is ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from tinysplat_torch.ops import _build
from tinysplat_torch.utils.device import gpu_name_and_limit

HERE = os.path.dirname(os.path.abspath(__file__))

N_SPLATS = 1 << 18
HEIGHT, WIDTH = 1066, 1600
FRAMES, WARMUP = 8, 2
TRAIN_VIEWS, SCATTER_STEPS, MXU_STEPS = 4, 10, 3
# Binning budgets of the bench scene at 64x16 tiles, with headroom and no
# dropped entries (the JAX package's bench.py sizes them the same way).
RENDER_KW = dict(tile_x=64, dup_capacity=760_000, span_capacity=786_432,
                 max_per_tile=4096)
# K1 and its plain version round the same float32 ops in the same order, so
# they should agree bit for bit; 1e-5 (relative above 1: the depth channel)
# bounds what a different exp() in another CUDA build could move.
KERNEL_TOL = 1e-5
MATCH_SHARE = 0.9999  # n_contrib / last_contrib equal at >= this share of pixels
# H100 SXM published peaks (data sheet; full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# FP32 operations K1 spends on every (entry, pixel) pair it evaluates:
# dx, dy (2), sigma (9), exp (1), opacity * exp (1), min (1) and the sigma
# and alpha tests (2). Contributing pairs cost 12 more; not counted, so the
# bound stays a lower bound. K1's bound is this FLOP count at the FP32 peak.
FLOP_PER_PAIR = 16
# K2's bound counts issue slots (one FP32 instruction per lane; 128 a clock
# on each of the 132 SMs at 1980 MHz), priced by the op-cost probe P2's
# readings on this card: an evaluated (entry, pixel) pair rebuilds K1's
# alpha, 15 slots and an expf of ~11; a pair the alpha test keeps costs ~51
# more (one reciprocal of ~10, the T and S updates, ten gradient terms).
# Both bounds count only the pairs a kernel needs to evaluate: those of its
# walk (K1: each pixel to its stop; K2: each pixel's own live prefix) whose
# pixel lies in the splat's alpha-support box, the box the kernels cull by.
# The counts come from rasterize_cuda.composite_counts (plain torch). K1's
# recount with the same slots is printed beside its FLOP bound.
SLOTS_PER_S = 128 * 132 * 1.98e9
SLOTS_PER_WALKED_PAIR = 26
SLOTS_PER_KEPT_PAIR = 51
# K2 vs its plain version, and the per-splat reductions: the masks are K1's
# bit for bit, only the order of the pixel sums and K2's fused multiply-adds
# in the gradient terms differ. Two K2 launches give the same bytes.
BWD_TOL = 1e-5
# Phase 7: 12 trainer steps, a densify every 4 (the camera count) up to step
# 8. A resumed run equals the original to this share of each column's max:
# "mxu" sums deterministically, but a few autograd reductions use atomics.
TRAINER_STEPS, TRAINER_VIEWS_PER_DENSIFY = 12, TRAIN_VIEWS
RESUME_TOL = 1e-5
# Binning budgets for the densified scene (up to ~2.3x the bench scene's
# splats and intersections), so that nothing is dropped; the trainer's
# retune keeps them (it shrinks only below a quarter in use).
TRAINER_KW = dict(tile_x=64, dup_capacity=2_000_000, span_capacity=2_000_000,
                  max_per_tile=8192)
# Phase 9: a COLMAP capture of the bench scene (8 PINHOLE views at full
# width, half the scene's means as SfM points), trained from those points in
# N_SPLATS slots with depth regularization, beside the live viewer. An
# imported PLY renders the trainer's frame to this tolerance.
DATASET_VIEWS, DATASET_POINTS, DATASET_STEPS = 8, N_SPLATS // 2, 12
EXPORT_TOL = 2e-4
EVAL_TOL_DB = 1e-3  # the evaluate CLI's per-view PSNR vs Trainer.evaluate's
# Phase 10: the bench scene trained with SuGaR density regularization (steps
# 2-12, 100,000 probe samples) and MCMC densify (refine passes at steps 4
# and 8, every 4 views), then meshed both ways from the step-12 checkpoint.
# The probe refreshes at step 2 (the window start) and on step % 4 == 1.
MESH_STEPS, MESH_DIM_SHARE, MESH_SAMPLES, MESH_RESOLUTION = 12, 0.05, 100_000, 128
# The KNN's operations per (point, slot) pair: p.m (3 multiplies, 3 adds),
# the -2 and the + ||m||^2 of an addmm.
KNN_FLOP_PER_PAIR = 8
# Phase 11: a (2, 2) mesh of 4 ranks on the card, 1600x1024 (1066 cut to a
# multiple of 64), 2 cameras a step, interleaved bands; 8 MeshTrainer steps
# with a densify at step 4 that clones every live splat (tau_means 0, no
# split) into no free slots: 262,144 -> 786,432 slots, re-sharded.
SHARD_HEIGHT, SHARD_MESH, SHARD_STEPS, SHARD_FRAMES = 1024, (2, 2), 8, 4
SHARD_TOL = 2e-5  # sharded vs one-device frames (the JAX suite's tolerance)
# The JAX suite's 1-vs-N bar (tests/test_parallel.py:104-125).
LRS = {"means": 0.00016, "scales": 0.005, "quats": 0.001, "opacities": 0.05,
       "colors_dc": 0.0025}

# Phase 12: the diffusion-guided trainer. The published Stable Diffusion v1.5
# unet/config.json and vae/config.json values (written as literals; the
# weights are drawn from a seed), 12 steps from phase 6's start with
# refreshes at 2 (the window start), 4 and 8 (every 4) and the window's end
# at 10. The SD modules on the card are held to copies on the host CPU at
# SD_CARD_TOL x max: ~70 float32 convolution and matmul layers, summed in
# other orders by cuDNN's and the CPU's algorithms, read ~4e-6 on an H100,
# so the bar leaves a 25x margin; the same forwards with TF32 on are printed
# beside it as the control the bar must catch. The tiny pipeline is held at
# TINY_CARD_TOL (the CPU parity tests' pipeline bar).
SD15_UNET = dict(sample_size=64, in_channels=4, out_channels=4,
                 block_out_channels=[320, 640, 1280, 1280], layers_per_block=2,
                 attention_head_dim=8, cross_attention_dim=768, norm_num_groups=32,
                 norm_eps=1e-5, flip_sin_to_cos=True, freq_shift=0, act_fn="silu",
                 down_block_types=["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
                 up_block_types=["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3)
SD15_VAE = dict(sample_size=512, in_channels=3, out_channels=3,
                block_out_channels=[128, 256, 512, 512], layers_per_block=2, latent_channels=4,
                norm_num_groups=32, act_fn="silu", scaling_factor=0.18215,
                down_block_types=["DownEncoderBlock2D"] * 4,
                up_block_types=["UpDecoderBlock2D"] * 4)
DIFF_STEPS, DIFF_WINDOW, DIFF_INTERVAL, DIFF_REFRESHES = 12, (2, 10), 4, (2, 4, 8)
SD_CARD_TOL, TINY_CARD_TOL = 1e-4, 1e-4
# Phase 13: the quality tools (tinysplat_torch/scripts) at their published
# widths, cut in depth only: quality_bench --iters 7000 -> 1000 (densify_end
# 666, one densify pass at step 600); train_diffusion_prior's VAE / denoiser
# steps 1500 / 4000 -> 100 / 200; diffusion_ab --iters 2500 -> 160 with the
# guidance from step 40 (the window [40, 133) holds exactly one refresh);
# quality_real --iters 4000 -> 300 on the in-repo 8-view capture; the 1M
# probe --steps 100 -> 20.
QB_ARGS = ["--iters", "1000", "--eval-every", "250", "--eval-scales", "0.5"]
PRIOR_ARGS = ["--vae-steps", "100", "--unet-steps", "200"]
AB_ARGS = ["--iters", "160", "--diffusion-start", "40"]
REAL_ARGS = ["--holdout", "4", "--iters", "300", "--eval-every", "100"]
PROBE_ARGS = ["--steps", "20"]
# Phase 14: the profiling, sweep and scaling tools at their defaults (no cut:
# scaling_model keeps --iters 20). The sweep adds one "mxu" config at 64-px
# tiles to JAX's three, so that it reaches K3. The tables must name K1's
# and K2's __global__ functions.
SWEEP_CONFIGS = ["sorted:8:128", "segment:8:128", "scatter:8:128", "mxu:8:128:64"]
SM_ARGS = ["--iters", "20"]
K1_NAME, K2_NAME = "composite_fwd_kernel", "composite_bwd_kernel"
# Phase 15: the headline bench at its defaults, no cut. No gradient is kept
# from one iteration to the next: the memory in use after the timed
# gradients must equal that before them, and the peak after them may exceed
# the first gradient's only by the allocator's slack. A cached block of the
# large pool is split only when more than LARGE_BLOCK_SLACK would be left
# over, so each large block handed out may exceed its request by that much.
BENCH_RUNS = (("scatter", []), ("mxu", ["--grad-reduce", "mxu"]))
BENCH_TRAIN_KEYS = {"train_step_ms", "train_steps_per_s", "rays_per_s"}  # the final line's own
LARGE_BLOCK_SLACK = 1 << 20
# Phase 16: tile heights other than 16 px. Frames at (tile_size, tile_x)
# (tile_x 0: square tiles, as the JAX 'tiled' backend cuts them); the
# trainer's runs at (tile_size, grad_reduce), square tiles, from phase 6's
# start. Budgets hold every entry with TILE_HEADROOM to spare. Frames whose
# splats' boxes hold their whole alpha support agree with the 16x64 frame
# to FRAME_TOL (bit for bit expected: the same float ops per pixel).
TILE_SHAPES = ((8, 0), (32, 0), (32, 64))
TILE_TRAIN, TILE_STEPS = ((32, "mxu"), (8, "scatter")), 6
TILE_HEADROOM, FRAME_TOL = 1.25, 1e-6
# Phase 17: the splat-input kernels S1 and S2 on the bench scene and at the
# trainer's grown capacity (phase 7: 1,048,576 slots; the slots past the
# scene dead). S1 is held to its plain version at active degrees 0 and 3,
# with antialiased off and on, in both viewdirs modes (splat_inputs_cuda.
# FWD_TOL); S2 to its plain version and to autograd through the plain forward
# (BWD_TOL). FLOP per splat of S1 and S2 at SH degree 3, counted from the
# code and rounded up: they give the operations bound beside the bytes bound.
SPLAT_CAPACITY = 4 * N_SPLATS
SPLAT_COMBOS = [(deg, aa, mode) for deg in (0, 3) for aa in (False, True)
                for mode in ("reference", "position")]
SPLAT_FWD_FLOP, SPLAT_BWD_FLOP = 500, 1500
SPLAT_REPS = 5  # layer calls, frames and steps a way in phase 17 (d)
SSIM_REPS = 50  # timed launches of L1 and L2 in phase 19 (c)
SCATTER_REPS = 50  # timed calls of scatter_rows at each layout of phase 20
# Phase 19's bar on a rendered frame, where float32 itself is 2.9e-4 off
# the exact map (ssim_cuda.TOL): L1's map and L1 -> L2's gradients no further
# from the float64 plain version than this many times the float32 plain
# version is.
SSIM_FRAME_RATIO = 2.0
# B3 / B4's digit passes a binning at every full-size tile grid here (256 to
# 65,535 tiles: ceil(log2(tiles + 1)) of 9-16 bits); checked in phase 18.
RADIX_PASSES = 2


def compare_kernel(torch, rc, args, label):
    """K1 vs its plain version on the same inputs; raises past tolerance.

    Returns (max abs error of rows c0..c3 and T_final, kernel output)."""
    got = rc.composite_fwd(*args)
    ref = rc.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    diff = (got[:, 0:5] - ref[:, 0:5]).abs()
    max_err = float(diff.max()) if diff.numel() else 0.0
    scaled = float((diff / ref[:, 0:5].abs().clamp(min=1.0)).max()) if diff.numel() else 0.0
    share = float((got[:, 5:7] == ref[:, 5:7]).float().mean()) if diff.numel() else 1.0
    walked = int(torch.minimum(got[:, 5] + 1, args[3][:, None].float()).sum())
    print(f"  {label}: tiles {got.shape[0]}, max entries/tile {int(args[3].max())}, "
          f"max|K1-plain| {max_err:.3e} (scaled {scaled:.3e}, tol {KERNEL_TOL:g}), "
          f"n_contrib/last_contrib equal {share:.6f} (need >= {MATCH_SHARE}), "
          f"pairs walked {walked}", flush=True)
    if not (scaled <= KERNEL_TOL and share >= MATCH_SHARE):
        raise AssertionError(f"K1 disagrees with its plain version on {label}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K1 wrote non-finite values on {label}")
    return max_err, got


def draw_splats(rng, n, lo, hi, conic=None, opacity=(0.05, 1.0), depth=(0.5, 5.0)):
    """n random screen-space splats (numpy): xys, depths, covariances, colours,
    opacities, valid."""
    xys = rng.uniform(lo, hi, size=(n, 2)).astype(np.float32)
    depths = rng.uniform(*depth, size=(n,)).astype(np.float32)
    if conic is None:
        L = rng.normal(size=(n, 2, 2)).astype(np.float32) * 2.0
        cov = L @ np.swapaxes(L, 1, 2) + np.eye(2, dtype=np.float32)
    else:
        cov = np.tile(np.linalg.inv(np.asarray(conic, np.float32)), (n, 1, 1))
    colors = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    opac = rng.uniform(*opacity, size=(n,)).astype(np.float32)
    return xys, depths, cov, colors, opac, rng.uniform(size=(n,)) > 0.05


def splat_case(torch, rc, label, parts, height, width, tile_x, **caps):
    """(label, K1's inputs) for the union of the splat sets ``parts``."""
    xys, depths, cov, colors, opac, valid = (np.concatenate(x) for x in zip(*parts))
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], axis=1)
    radii = np.ceil(3.5 * np.sqrt(np.linalg.eigvalsh(cov).max(axis=1)))

    def cuda(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    f32 = torch.float32
    return label, rc.tile_inputs(
        cuda(xys, f32), cuda(depths, f32), cuda(radii, torch.int32), cuda(conics, f32),
        cuda(colors, f32), cuda(opac, f32), cuda(valid, torch.bool), height, width,
        tile_x=tile_x, **caps)


def synthetic_case(torch, rc, label, n, height, width, tile_x, seed, xy_lo=None,
                   xy_hi=None, conic=None, opacity=(0.05, 1.0), **caps):
    """K1's inputs for n random screen-space splats (numpy draws)."""
    lo = xy_lo if xy_lo is not None else (-6.0, -6.0)
    hi = xy_hi if xy_hi is not None else (width + 6.0, height + 6.0)
    parts = [draw_splats(np.random.default_rng(seed), n, lo, hi, conic, opacity)]
    return splat_case(torch, rc, label, parts, height, width, tile_x, **caps)


def uneven_subtiles_case(torch, rc, tile_x, seed):
    """One 16 x tile_x tile under 1,500 faint wide splats, with 160 opaque
    ones in front of its first 16 x 16 sub-tile only: that sub-tile's live
    prefix ends within ~100 entries, the others' run past 1,000."""
    rng = np.random.default_rng(seed)
    faint = draw_splats(rng, 1500, (0, 0), (tile_x, 16), conic=[[0.0025, 0], [0, 0.0025]],
                        opacity=(0.004, 0.008), depth=(1.0, 5.0))
    front = draw_splats(rng, 160, (0, 0), (16, 16), conic=[[0.0625, 0], [0, 0.0625]],
                        opacity=(0.95, 1.0), depth=(0.1, 0.5))
    return splat_case(torch, rc, f"sub-tiles end apart tile_x={tile_x}", [faint, front], 16,
                      tile_x, tile_x, max_per_tile=4096)


def where_the_time_goes(torch, frame_ms, layers):
    """Each layer of a frame timed on its own (CUDA events, median of 5),
    beside the frame: what the layers leave over is host time between them."""
    from tinysplat_torch.probes import timed_ms

    total = 0.0
    for name, fn in layers.items():
        ms = timed_ms(fn, 5)
        total += ms
        print(f"  layer {name}: {ms:.3f} ms", flush=True)
    print(f"  layers sum {total:.3f} ms of a {frame_ms:.3f} ms frame", flush=True)


def column_err(torch, got, ref):
    """(max abs error, max error / the column's max |ref|) of (R, 10) rows."""
    if got.numel() == 0:
        return 0.0, 0.0
    diff = (got - ref).abs()
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    return float(diff.max()), float((diff / scale).max())


def plain_reduce(rc, rows, entry_rank, n, strategy):
    """The per-splat rows of ``strategy`` with the plain versions in place
    of K3 and ``scatter_rows`` (the other strategies are plain torch ops)."""
    if strategy == "scatter":
        return rc.scatter_rows_plain(rows, entry_rank, n)[:n]
    if strategy != "mxu":
        return rc.reduce_entry_grads(rows, entry_rank, n, strategy)
    return rc.segsum_plain(rows, *rc.segsum_inputs(entry_rank, n))


def same_bytes(torch, a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def compare_k3(torch, rc, rows, perm, bounds, label):
    """K3 twice and its plain version on the same inputs; raises unless all
    three are the same bytes."""
    got = rc.segsum(rows, perm, bounds)
    again = rc.segsum(rows, perm, bounds)
    ref = rc.segsum_plain(rows, perm, bounds)
    torch.cuda.synchronize()
    if not (same_bytes(torch, got, ref) and same_bytes(torch, got, again)):
        raise AssertionError(f"K3 is not bit-equal to its plain version, twice, on {label}")


def k3_bound(rc, bounds):
    """(bound ms, by, (S summed rows, M splats, longest run, dead splats))
    of K3 at these bounds: each summed row read once with its perm entry,
    each bound once, each output row written once; one add per summed
    float."""
    runs = bounds[1:] - bounds[:-1]
    summed, m = int(bounds[-1] - bounds[0]), runs.shape[0]
    bound, by = kernel_bound(summed * (rc.TABLE_COLS * 4 + 4) + nbytes(bounds),
                             m * rc.TABLE_COLS * 4, summed * rc.TABLE_COLS)
    return bound, by, (summed, m, int(runs.max()), int((runs == 0).sum()))


def time_k3(rc, rows, perm, bounds, label, reps):
    """K3's device time (median of ``reps``) beside its bound; printed."""
    from tinysplat_torch.probes import timed_ms

    ms = timed_ms(lambda: rc.segsum(rows, perm, bounds), reps, device_only=True)
    bound, by, (summed, m, longest, dead) = k3_bound(rc, bounds)
    print(f"  K3 at {label}: median {ms:.4f} ms over {reps} launches; bound {bound:.4f} ms "
          f"by {by} ({bound / ms:.1%} of it; S {summed} rows into M {m} splats, longest run "
          f"{longest}, dead splats {dead})", flush=True)
    return ms, bound, by


def compare_backward(torch, rc, ti, out, gout, label):
    """K2 vs its plain version on one case, raising past BWD_TOL, and K3 vs
    its plain version bit for bit.

    Returns (K2 max abs error, K2 rows)."""
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    rows = rc.composite_bwd(*args, out, gout, ti.tile_x, ti.tile_h)
    again = rc.composite_bwd(*args, out, gout, ti.tile_x, ti.tile_h)
    ref = rc.composite_bwd_plain(*args, out, gout, ti.tile_x, ti.tile_h)
    torch.cuda.synchronize()
    if not torch.equal(rows.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"two K2 launches on {label} gave different bytes")
    k2_err, k2_scaled = column_err(torch, rows, ref)
    n = ti.table.shape[0] - 1
    compare_k3(torch, rc, rows, *rc.segsum_inputs(ti.entry_rank, n), label)
    reduced = {}
    for strategy in rc.GRAD_REDUCE:
        reduced[strategy] = column_err(
            torch, rc.reduce_entry_grads(rows, ti.entry_rank, n, strategy),
            plain_reduce(rc, ref, ti.entry_rank, n, strategy))[1]
    live = int((ref.abs().amax(dim=1) > 0).sum())
    print(f"  {label}: {live} live entry rows; K2 twice: same bytes; max|K2-plain| "
          f"{k2_err:.3e} (scaled {k2_scaled:.3e}); K3 twice: bit-equal to plain; "
          f"per-splat rows, scaled error by strategy "
          f"{ {k: float(f'{v:.3e}') for k, v in reduced.items()} } (tol {BWD_TOL:g})",
          flush=True)
    if not torch.isfinite(rows).all():
        raise AssertionError(f"K2 wrote non-finite values on {label}")
    if max([k2_scaled, *reduced.values()]) > BWD_TOL:
        raise AssertionError(f"K2/K3 disagree with their plain versions on {label}")
    return k2_err, rows


def random_cotangent(torch, out, seed):
    """A numpy-drawn cotangent of K1's output rows 0-4 (the rows the
    backward reads)."""
    gout = torch.zeros_like(out)
    draw = np.random.default_rng(seed).normal(size=tuple(out[:, 0:5].shape))
    gout[:, 0:5] = torch.as_tensor(draw, dtype=torch.float32, device=out.device)
    return gout


def kernel_bound(in_bytes, out_bytes, ops, ops_per_s=FP32_FLOPS_PER_S):
    """(bound ms, 'bytes' or 'operations') on the H100's published peaks:
    FP32 FLOP by default, issue slots with ops_per_s=SLOTS_PER_S."""
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def k2_slots(counts):
    """K2's issue slots at one frame's counters (see SLOTS_PER_WALKED_PAIR)."""
    pairs = counts["pairs"]
    return pairs["k2_box"] * SLOTS_PER_WALKED_PAIR + pairs["kept"] * SLOTS_PER_KEPT_PAIR


def print_counts(rc, ti, out, label):
    """The compositing work counters of one frame (``composite_counts``:
    plain torch over K1's output and the backward's keep masks), printed."""
    c = rc.composite_counts(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx,
                            ti.sy, out, ti.tile_x, ti.tile_h)
    pairs = c["pairs"]

    def stats(d):
        return f"mean {d['mean']:.1f} p99 {d['p99']:.1f} max {d['max']:.0f}"

    warps = c["warps"]
    print(f"  counters at {label}: (entry, pixel) pairs K1 walks {pairs['k1']} ("
          f"{pairs['k1_box']} inside the splats' boxes); K2 own-pixel prefix "
          f"{pairs['k2_pixel']} ({pairs['k2_box']} inside the boxes), 16x16 sub-tile prefix "
          f"{pairs['k2_sub']}; kept by the alpha test {pairs['kept']} "
          f"({pairs['kept'] / max(pairs['k2_pixel'], 1):.4f} of the own-pixel walk)",
          flush=True)
    print(f"  (entry, 8x4 warp) pairs with a kept pixel: {warps['kept']} of {warps['walked']} "
          f"walked ({warps['kept'] / max(warps['walked'], 1):.4f})", flush=True)
    print(f"  entries walked per tile: K1 {stats(c['tile_entries']['k1'])}, K2 "
          f"{stats(c['tile_entries']['k2'])}; per 16x16 sub-tile: K1 "
          f"{stats(c['sub_entries']['k1'])}, K2 {stats(c['sub_entries']['k2'])}", flush=True)
    return c


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def backward_inputs(torch, rc, train, cam, gt, deg, cfg, budgets=RENDER_KW, depth_loss=None):
    """K1's inputs and output at a training state, and the training loss's
    own cotangent of K1's output (what K2 receives in that step);
    ``depth_loss(depth)`` adds a term on the rendered depth (H, W)."""
    from tinysplat_torch.ops.ssim import ssim
    from tinysplat_torch.render import splat_inputs

    height, width = gt.shape[:2]
    bg = torch.zeros(3, device=gt.device)
    with torch.no_grad():
        s = splat_inputs(train.params, train.alive, cam, height, width, deg, bg)
        ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                            s.opacities, s.valid, height, width, **budgets)
        out = rc.composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx,
                               ti.sy, ti.tile_x, ti.tile_h)
    out_g = out.clone().requires_grad_()
    img, _ = rc.untile(out_g, s.bg4, ti.tiles_x, ti.tiles_y, ti.tile_x, height, width,
                       ti.tile_h)
    rgb = torch.clamp(img[..., :3], max=1.0)
    loss = ((1.0 - cfg.lambda_dssim) * (rgb - gt).abs().mean()
            + cfg.lambda_dssim * (1.0 - ssim(rgb, gt)))
    if depth_loss is not None:
        loss = loss + depth_loss(img[..., 3])
    (gout,) = torch.autograd.grad(loss, out_g)
    return ti, out, gout


def param_grads(torch, tt, state, cam, gt, step, cfg):
    """Gradients of every parameter field and of the screen-xy probe for one
    loss evaluation at ``state`` (nothing is updated)."""
    probe = torch.zeros((state.capacity, 2), device="cuda", requires_grad=True)
    for _, t in state.params.fields():
        t.grad = None
    loss, _ = tt.compute_losses(state.params, probe, state, cam, gt, None,
                                torch.zeros(3, device="cuda"), step, cfg, HEIGHT, WIDTH)
    loss.backward()
    grads = {name: t.grad.clone() for name, t in state.params.fields()}
    grads["xys"] = probe.grad.clone()
    return grads


def train_steps(torch, step_fn, state, opt, views, gts, first, count):
    """Run ``count`` train steps from step ``first``; per step the metrics,
    the CUDA-event ms, the host ms and whether every gradient is finite."""
    log = []
    for step in range(first, first + count):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = step_fn(state, opt, views[step % len(views)], gts[step % len(gts)], None, step)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        finite = all(bool(torch.isfinite(t.grad).all()) for _, t in out.state.params.fields())
        log.append((out.metrics, start.elapsed_time(end), host_ms, finite))
        state = out.state
    return state, log


def check_steps(torch, log, label):
    """Losses and gradients finite, nothing dropped by binning."""
    for i, (metrics, _, _, finite) in enumerate(log):
        if not (finite and bool(torch.isfinite(metrics["loss"]))):
            raise AssertionError(f"{label} step {i}: non-finite loss or gradient")
        if metrics["n_dup_dropped"] or metrics["n_tile_dropped"]:
            raise AssertionError(f"{label} step {i}: binning dropped entries")


def train_layers(torch, rc, tt, state, opt, cam, gt, cfg, step_ms):
    """Each layer of a training step timed on its own (CUDA events, median
    of 5), beside the step: the forward layers, the loss, the whole backward
    and, within it, K2 and the reduction (the rest of the backward is
    autograd through the permutation, projection, SH and the loss), then
    Adam. Runs Adam 5 more times on the state."""
    from tinysplat_torch.ops.ssim import ssim
    from tinysplat_torch.probes import timed_ms
    from tinysplat_torch.render import splat_inputs

    bg = torch.zeros(3, device="cuda")
    deg = int(state.active_sh_degree)

    def forward():
        probe = torch.zeros((state.capacity, 2), device="cuda", requires_grad=True)
        s = splat_inputs(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg,
                         xys_probe=probe)
        ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                            s.opacities, s.valid, HEIGHT, WIDTH, **RENDER_KW)
        out = rc.composite_tiles(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx,
                                 ti.sy, ti.tile_x, cfg.grad_reduce)
        img, _ = rc.untile(out, s.bg4, ti.tiles_x, ti.tiles_y, ti.tile_x, HEIGHT, WIDTH)
        return s, ti, out, torch.clamp(img[..., :3], max=1.0)

    def loss_of(rgb):
        return ((1.0 - cfg.lambda_dssim) * (rgb - gt).abs().mean()
                + cfg.lambda_dssim * (1.0 - ssim(rgb, gt)))

    s, ti, out, rgb = forward()
    args = (ti.table.detach(), ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    (gout,) = torch.autograd.grad(loss_of(rgb), out)
    rows = rc.composite_bwd(*args, out.detach(), gout, ti.tile_x)
    n = ti.table.shape[0] - 1
    layers = {
        "forward: splat_inputs (projection, SH, opacities)": lambda: splat_inputs(
            state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg),
        "forward: tile_inputs (binning, table)": lambda: rc.tile_inputs(
            s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4, s.opacities,
            s.valid, HEIGHT, WIDTH, **RENDER_KW),
        "forward: composite_fwd (K1)": lambda: rc.composite_fwd(*args, ti.tile_x),
        "forward: untile": lambda: rc.untile(out, s.bg4, ti.tiles_x, ti.tiles_y, ti.tile_x,
                                             HEIGHT, WIDTH),
        "loss (L1 + SSIM), forward": lambda: loss_of(rgb),
        "backward: composite_bwd (K2)": lambda: rc.composite_bwd(
            *args, out.detach(), gout, ti.tile_x),
        f"backward: reduction ({cfg.grad_reduce})": lambda: rc.reduce_entry_grads(
            rows, ti.entry_rank, n, cfg.grad_reduce),
    }
    times = {name: timed_ms(fn, 5) for name, fn in layers.items()}
    backward = []
    for _ in range(5):
        loss = loss_of(forward()[3])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss.backward()
        end.record()
        end.synchronize()
        backward.append(start.elapsed_time(end))
    times["backward, all"] = statistics.median(backward)
    times["backward: the rest of autograd (all - K2 - reduction)"] = (
        times["backward, all"] - times["backward: composite_bwd (K2)"]
        - times[f"backward: reduction ({cfg.grad_reduce})"])
    times["Adam step"] = timed_ms(opt.step, 5)
    for name, ms in times.items():
        print(f"  layer {name}: {ms:.3f} ms", flush=True)
    total = sum(ms for name, ms in times.items()
                if name.startswith(("forward:", "loss", "Adam")) or name == "backward, all")
    print(f"  layers sum {total:.3f} ms of a {step_ms:.3f} ms step", flush=True)


def reduction_layers(rc, rows, entry_rank, n):
    """The entry -> splat reduction layer at one step's rows, "mxu" (the
    sort, the bounds and K3) and "scatter" (``scatter_rows``): device time
    (``device_only``) and host-paced time, median of 20 each, and the sort
    and bounds alone."""
    from tinysplat_torch.probes import timed_ms

    for strategy in ("mxu", "scatter"):
        def fn():
            return rc.reduce_entry_grads(rows, entry_rank, n, strategy)
        fn()  # builds and warms the kernels
        print(f"  reduction layer ({strategy}): device "
              f"{timed_ms(fn, 20, device_only=True):.4f} ms, host-paced "
              f"{timed_ms(fn, 20):.4f} ms", flush=True)
    sort_ms = timed_ms(lambda: rc.segsum_inputs(entry_rank, n), 20, device_only=True)
    print(f"  of which the sort and bounds (segsum_inputs): device {sort_ms:.4f} ms", flush=True)


def write_bench_checkpoint(path, seed=0, n=N_SPLATS):
    """The bench scene as a JAX-layout checkpoint: model/* arrays of the
    compact live-splat snapshot (what save_checkpoint writes)."""
    from tinysplat_torch.data.synthetic import random_gaussian_cloud
    from tinysplat_torch.utils.color import RGB2SH

    means, log_scales, quats, colors, opac = random_gaussian_cloud(
        n, seed=seed, scale_range=(0.002, 0.01))
    rest = np.random.default_rng(seed + 1).normal(size=(n, 15, 3)) * 0.05
    np.savez(path, **{
        "model/means": means,
        "model/colors_dc": RGB2SH(colors).astype(np.float32),
        "model/colors_rest": rest.astype(np.float32),
        "model/scales": log_scales,
        "model/quats": quats,
        "model/opacities": opac,
        "model/active_sh_degree": np.asarray(3, np.int32),
    })


def calibrated_tau(torch, tt, state, views, gts, cfg, passing=0.6):
    """The tau_means that ``passing`` of the live splats pass at a densify
    after one step per view, estimated from the start state's screen-space
    gradients at every view (grad_avg = sum / steps / 2 * max(W, H))."""
    start = dataclasses.replace(state, active_sh_degree=torch.tensor(
        1, dtype=torch.int32, device="cuda"))
    accum = torch.zeros(state.capacity, device="cuda")
    for i, (cam, gt) in enumerate(zip(views, gts)):
        accum += torch.linalg.norm(param_grads(torch, tt, start, cam, gt, i + 1, cfg)["xys"],
                                   dim=-1)
    grad_avg = accum / len(views) / 2.0 * max(WIDTH, HEIGHT)
    return float(torch.quantile(grad_avg[state.alive], 1.0 - passing))


def trainer_phase(torch, rc, tt, Config, views, gts, serve_state, deg, bg):
    """Phase 7: ``Trainer`` at full width; see the module docstring."""
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.io.checkpoint import load_checkpoint, load_model, save_checkpoint
    from tinysplat_torch.probes import timed_ms
    from tinysplat_torch.render import render
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    cams = orbit_cameras(TRAIN_VIEWS, width=WIDTH, height=HEIGHT)
    for cam, gt in zip(cams, gts):
        cam._image = gt.cpu().numpy()
    scene = Scene(cams)
    held_out = orbit_cameras(2 * TRAIN_VIEWS, width=WIDTH, height=HEIGHT)[1]
    with torch.no_grad():  # between training views 0 and 1
        held_out._image = render(serve_state.params, serve_state.alive,
                                 held_out.params("cuda"), HEIGHT, WIDTH, deg, bg,
                                 **RENDER_KW)[0].cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench_scene.npz")
        write_bench_checkpoint(ckpt)
        start = load_model(ckpt, device="cuda")
        noise = np.random.default_rng(7).normal(0.0, 0.1, size=tuple(start.params.colors_dc.shape))
        with torch.no_grad():  # phase 6's start: dimmed opacities, perturbed colours
            live = start.alive[:, None]
            start.params.opacities[:] = torch.where(live, -1.0, start.params.opacities)
            start.params.colors_dc += torch.where(
                live, torch.as_tensor(noise, dtype=torch.float32, device="cuda"), 0.0)
        base = Config(background="black", warmup_grad=0, grad_reduce="mxu", **TRAINER_KW)
        tt.init_opt_state(base, start)
        tau = calibrated_tau(torch, tt, start, views, gts, base)
        cfg = dataclasses.replace(
            base, tau_means=tau, warmup_densify=TRAINER_VIEWS_PER_DENSIFY,
            densify_end=2 * TRAINER_VIEWS_PER_DENSIFY, interval_opacity_reset=8,
            nan_guard_interval=4, save_checkpoints=True, checkpoint_interval=8,
            checkpoint_dir=os.path.join(tmp, "ckpt"), max_iter=TRAINER_STEPS)
        print(f"phase 7: Trainer, {TRAINER_STEPS} steps, {N_SPLATS} splats in "
              f"{start.capacity} slots, {HEIGHT}x{WIDTH}, {TRAIN_VIEWS} views, grad_reduce "
              f"mxu; tau_means {tau:.4e} (60% of the live splats pass it at the start)",
              flush=True)
        tr = Trainer(cfg, scene, start)
        kernels = counted_kernels()
        for k in kernels:
            _build.launches[k] = 0
        step_s, losses, drops = [], [], []
        for s in range(1, TRAINER_STEPS + 1):
            t0 = time.perf_counter()
            tr.run(s)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if s == cfg.checkpoint_interval:  # the budgets the checkpoint was taken with
                cfg_at_ckpt = tr.cfg
            m = tr.last_metrics
            losses.append(float(m["loss"]))
            drops.append((int(m["n_dup_dropped"]), int(m["n_tile_dropped"])))
        launches = {k: _build.launches[k] for k in kernels}
        print(f"  launches in the {TRAINER_STEPS} steps: {launches}; losses "
              f"{[round(x, 5) for x in losses]}; entries dropped by binning (total, tile) "
              f"{drops}; host s per step {[round(x, 3) for x in step_s]}", flush=True)
        check_launches(launches, {"composite_fwd": TRAINER_STEPS, "composite_bwd": TRAINER_STEPS,
                                  "segsum": TRAINER_STEPS}, f"phase 7 ({TRAINER_STEPS} steps)")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite trainer losses {losses}")
        for h in tr.densify_history:
            print(f"  densify at step {h['step']}: cloned {h['cloned']} split {h['split']} "
                  f"pruned {h['pruned']} dropped {h['dropped']} live {h['num_live']}; capacity "
                  f"{h['capacity_before']} -> {h['capacity_after']} (overflow {h['overflow']}); "
                  f"{h['seconds']:.3f} s", flush=True)
        grown = [h for h in tr.densify_history if h["overflow"] > 0]
        if not grown or tr.state.capacity != 2 * N_SPLATS * 2:
            raise AssertionError(f"no densify overflow grew capacity to {4 * N_SPLATS}: "
                                 f"{tr.densify_history}")
        if not all(torch.isfinite(t).all() for _, t in tr.state.params.fields()):
            raise AssertionError("the trainer's parameters are not finite")
        print(f"  retuned budgets: dup_capacity {tr.cfg.dup_capacity}, max_per_tile "
              f"{tr.cfg.max_per_tile}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

        # K1, K2 and K3 against their plain versions at the trainer's own
        # shapes: the state, camera, GT and budgets of the last step.
        camera = scene.get_random_camera(tr.step - 1)
        budgets = {k: getattr(tr.cfg, k) for k in TRAINER_KW}
        ti, out, gout = backward_inputs(
            torch, rc, tr.state, camera.params("cuda"), tr._device_image(camera, WIDTH, HEIGHT),
            int(tr.state.active_sh_degree), tr.cfg, budgets)
        label = f"trainer step {tr.step}, {int(tr.state.num_live())} live in {tr.state.capacity}"
        fargs = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x)
        compare_kernel(torch, rc, fargs, label)
        rows = compare_backward(torch, rc, ti, out, gout, label)[1]
        time_k3(rc, rows, *rc.segsum_inputs(ti.entry_rank, ti.table.shape[0] - 1),
                "the trainer's last step", 10)
        counts = print_counts(rc, ti, out, label)
        bargs = fargs[:6] + (out, gout, ti.tile_x)
        k1_ms = timed_ms(lambda: rc.composite_fwd(*fargs), 10, device_only=True)
        k2_ms = timed_ms(lambda: rc.composite_bwd(*bargs), 10, device_only=True)
        k1_bound, k1_by = kernel_bound(nbytes(*fargs[:6]), nbytes(out),
                                       counts["pairs"]["k1_box"] * FLOP_PER_PAIR)
        k2_bound, k2_by = kernel_bound(nbytes(*fargs[:6], out[:, 4:7], gout[:, 0:5]),
                                       nbytes(rows), k2_slots(counts), SLOTS_PER_S)
        scratch = rc.subtiles_per_tile(ti.tile_x) * nbytes(rows)
        print(f"  K1 at the trainer's last step: median {k1_ms:.4f} ms over 10 launches, bound "
              f"{k1_bound:.4f} ms by {k1_by} (FLOP); K2: median {k2_ms:.4f} ms, bound "
              f"{k2_bound:.4f} ms by {k2_by} (issue slots); K2's sub-tile scratch "
              f"{scratch / 1e6:.1f} MB", flush=True)

        # Resume: a fresh trainer from the step-8 checkpoint replays 9-12.
        (path,) = [os.path.join(cfg.checkpoint_dir, f) for f in os.listdir(cfg.checkpoint_dir)]
        t0 = time.perf_counter()
        st, opt, step, rng = load_checkpoint(path, cfg_at_ckpt, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        resumed = Trainer(dataclasses.replace(cfg_at_ckpt, save_checkpoints=False), scene, st,
                          opt, step, rng)
        resumed.run(TRAINER_STEPS)
        pairs = [(name, t, getattr(resumed.state.params, name))
                 for name, t in tr.state.params.fields()]
        pairs.append(("means_grad_accum", tr.state.means_grad_accum,
                      resumed.state.means_grad_accum))
        errs = {name: column_err(torch, b.detach().reshape(b.shape[0], -1),
                                 a.detach().reshape(a.shape[0], -1))[1]
                for name, a, b in pairs}
        same_alive = bool(torch.equal(tr.state.alive, resumed.state.alive))
        print(f"  checkpoint {os.path.getsize(path) / 2**20:.1f} MiB at step {step} "
              f"(capacity {st.capacity}), loaded in {load_s:.3f} s; replayed steps 9-"
              f"{TRAINER_STEPS}: alive equal {same_alive}, scaled error by field "
              f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol {RESUME_TOL:g})",
              flush=True)
        if not same_alive or max(errs.values()) > RESUME_TOL:
            raise AssertionError("the resumed run differs from the original")
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "timed.npz"), tr.state, tr.opt_state, tr.step,
                        tr.generator.get_state())
        print(f"  save_checkpoint at step {tr.step} (capacity {tr.state.capacity}): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

    # pose_opt + app_opt: 4 steps from the first run's state.
    pose_cfg = dataclasses.replace(tr.cfg, pose_opt=True, app_opt=True, save_checkpoints=False)
    posed = Trainer(pose_cfg, scene, tr.state, tr.opt_state, tr.step)
    grads = []
    for _ in range(4):
        posed.train_step()
        g = posed.last_metrics
        grads.append((float(g["pose_grad"].abs().max()), float(g["app_grad"].abs().max()),
                      bool(torch.isfinite(g["pose_grad"]).all() and
                           torch.isfinite(g["app_grad"]).all())))
    moved = (float(posed.pose_deltas.abs().sum()), float(posed.app_params.abs().sum()))
    print(f"  pose_opt + app_opt, 4 steps: max |pose_grad|, |app_grad|, finite per step "
          f"{grads}; sum |pose deltas| {moved[0]:.4e}, sum |app params| {moved[1]:.4e}",
          flush=True)
    if not all(p > 0 and a > 0 and ok for p, a, ok in grads) or min(moved) <= 0:
        raise AssertionError("pose / appearance gradients did not reach their tables")

    posed.eval_cameras = [held_out]
    ev = posed.evaluate()
    print(f"  evaluate() on a held-out orbit view: {ev}", flush=True)
    if not (np.isfinite(ev["eval_psnr"]) and 0.0 <= ev["eval_ssim"] <= 1.0):
        raise AssertionError(f"bad held-out evaluation {ev}")

    # A 3-step profile window, then the median step time (the resumed trainer).
    resumed.cfg = dataclasses.replace(resumed.cfg, profile_steps=3,
                                      profile_start=resumed.step)
    with tempfile.TemporaryDirectory() as tmp:
        resumed.cfg = dataclasses.replace(resumed.cfg, profile_dir=tmp)
        resumed.run(resumed.step + 4)
    if resumed.profile_summary is None:
        raise AssertionError("the profile window did not close")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"  Trainer step: median {statistics.median(times):.3f} ms over 5 steps "
          f"({[round(t, 3) for t in times]}), {int(resumed.state.num_live())} live splats in "
          f"{resumed.state.capacity} slots", flush=True)


def probes_phase(torch):
    """Phase 8: P1 and P2 through their entry points; their JSON entries."""
    from tinysplat_torch.probes import bitcast, op_costs

    print("phase 8: probes P1 (bitcast) and P2 (op_costs)", flush=True)
    _build.launches["probe_bitcast"] = 0
    r1 = bitcast.run("cuda")
    l1 = _build.launches["probe_bitcast"]
    _build.launches["probe_op_costs"] = 0
    r2 = op_costs.run("cuda")
    l2 = _build.launches["probe_op_costs"]
    print(f"  launches: P1 {l1}, P2 {l2}", flush=True)
    if set(r1) != set(bitcast.VARIANTS) or set(r2) != set(op_costs.OPS):
        raise AssertionError("a probe variant or row gave no result")
    bad1 = [v for v, r in r1.items()
            if not (r["exact"] and r["equal_plain"] and r["table_equal_plain"])]
    bad2 = [op for op, r in r2.items() if not r["ok"]]
    if bad1 or bad2:
        raise AssertionError(f"probe mismatches: P1 {bad1}, P2 {bad2}")
    a, wide = r1["A"], max(k for k in r2["fma"] if isinstance(k, int))
    fma = r2["fma"][wide]
    return ({"name": "probe_bitcast", "route": "cuda",
             "source": "tinysplat_torch/csrc/probe_bitcast.cu",
             "replaces": "scripts/probe_bf16_bitcast.py:46", "launches": l1,
             "max_abs_err": max(r["max_abs_err"] for r in r1.values()), "ms": a["ms"],
             "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"], "bound_by": "bytes",
             "library_ms": a["library_ms"]},
            {"name": "probe_op_costs", "route": "cuda",
             "source": "tinysplat_torch/csrc/probe_op_costs.cu",
             "replaces": "scripts/probe_vpu_costs.py:28", "launches": l2,
             "max_abs_err": max(r["max_abs_err"] for r in r2.values()), "ms": fma["ms"],
             "plain_ms": fma["plain_ms"], "bound_ms": fma["bound_ms"],
             "bound_by": "operations", "library_ms": None})


def counted_kernels():
    """The entry points whose launches the script zeroes and compares, by
    their keys in ``_build.launches``: K1-K3, the splat-input kernels S1 and
    S2, the binning kernels B1-B4, SSIM's L1 and L2, the "scatter"
    reduction ``scatter_rows`` and SuGaR's density term's two."""
    return ("composite_fwd", "composite_bwd", "segsum", "splat_fwd", "splat_bwd", "bin_count",
            "bin_emit", "radix_hist", "radix_scatter", "ssim_fwd", "ssim_bwd", "scatter_rows",
            "density_fwd", "density_bwd")


def check_launches(got, want, label):
    """Raise unless each kernel's launch count is the expected one. Unless
    ``want`` names them, S1 and S2 are expected as often as K1 and K2: every
    render runs ``splat_inputs`` (S1) once before K1, and every backward
    through K1 continues through S2 once. B1 and B2 run once a binning:
    once a K1 launch (every render's ``tile_inputs`` bins once), or
    ``want["bins"]`` times where a window also bins outside a render; B3 and
    B4 once per digit pass of each binning: ``RADIX_PASSES`` (every
    full-size tile grid here) a binning, or ``want["radix"]`` in all where a
    window's grids differ. L1 and L2 run once each a training step (its
    SSIM loss and that loss's backward): once a K2 launch, or
    ``want["ssim"]`` times where a window's backwards are not all training
    steps; L1 runs once more for each of ``want["evals"]`` eval views (an
    SSIM with no backward). ``scatter_rows`` runs once a backward that K3
    does not reduce: a window's backwards go through "scatter" or "mxu"
    (K3), so K2's launches less K3's, unless ``want`` names it (a window
    that runs "sorted" or "segment" too). The density term's two run only
    where ``want`` names them; a count that leaves them out (a rank of
    ``scaling_bench``) is not held to them."""
    want = dict(want)
    bins = want.pop("bins", want["composite_fwd"])
    radix = want.pop("radix", RADIX_PASSES * bins)
    steps = want.pop("ssim", want["composite_bwd"])
    evals = want.pop("evals", 0)
    want = {"splat_fwd": want["composite_fwd"], "splat_bwd": want["composite_bwd"],
            "bin_count": bins, "bin_emit": bins, "radix_hist": radix, "radix_scatter": radix,
            "ssim_fwd": steps + evals, "ssim_bwd": steps,
            "scatter_rows": want["composite_bwd"] - want["segsum"],
            **{k: 0 for k in ("density_fwd", "density_bwd") if k in got}, **want}
    if got != want:
        raise AssertionError(f"{label}: expected launches {want}, counted {got}")


def rotmat_to_qvec(rot):
    """(w, x, y, z) unit quaternion of a rotation matrix (COLMAP's qvec)."""
    r = np.asarray(rot, np.float64)
    w = np.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    x = np.copysign(np.sqrt(max(0.0, 1.0 + r[0, 0] - r[1, 1] - r[2, 2])) / 2, r[2, 1] - r[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1.0 - r[0, 0] + r[1, 1] - r[2, 2])) / 2, r[0, 2] - r[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1.0 - r[0, 0] - r[1, 1] + r[2, 2])) / 2, r[1, 0] - r[0, 1])
    q = np.asarray([w, x, y, z])
    return q / np.linalg.norm(q)


def write_colmap_capture(torch, root, state, deg, bg, views, n_points, device="cuda"):
    """A COLMAP capture of ``state`` under ``root`` with the port's writers:
    one PINHOLE camera, the ground truth of each orbit view in ``views``
    rendered (K1) and saved as PNG, ``points3D.bin`` with ``n_points`` of
    the live means (every second one) and their DC colours, and each
    image's 2-D observations of the points that project inside it (as
    ``depthest/sparse.py`` projects). Returns the observation counts."""
    from PIL import Image

    from tinysplat_torch.data import colmap
    from tinysplat_torch.render import render
    from tinysplat_torch.utils.color import SH2RGB

    height, width = views[0].height, views[0].width
    sparse, images = os.path.join(root, "sparse", "0"), os.path.join(root, "images")
    os.makedirs(sparse)
    os.makedirs(images)
    alive = state.alive.cpu().numpy()
    pick = np.arange(0, int(alive.sum()), 2)[:n_points]
    xyz = state.params.means.detach().cpu().numpy()[alive][pick].astype(np.float64)
    rgb = np.clip(SH2RGB(state.params.colors_dc.detach().cpu().numpy()[alive][pick]), 0, 1)
    ids = np.arange(1, len(pick) + 1, dtype=np.int64)
    fx, fy = views[0].f_x, views[0].f_y
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", width, height,
                                   np.asarray([fx, fy, width / 2, height / 2]))}
    recs, counts = {}, []
    for i, view in enumerate(views):
        with torch.no_grad():
            img = render(state.params, state.alive, view.params(device), height, width, deg,
                         bg, **RENDER_KW)[0]
        name = f"view_{i:02d}.png"
        Image.fromarray((img.cpu().numpy() * 255.0 + 0.5).astype(np.uint8)).save(
            os.path.join(images, name))
        rot = view.view_matrix[:3, :3].astype(np.float64)
        tvec = view.view_matrix[:3, 3].astype(np.float64)
        cam_xyz = xyz @ rot.T + tvec
        z = cam_xyz[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cam_xyz[:, 0] / z * fx + width / 2
            v = cam_xyz[:, 1] / z * fy + height / 2
        col, row = np.round(u), np.round(v)
        keep = (z > 0) & (col >= 0) & (col < width) & (row >= 0) & (row < height)
        counts.append(int(keep.sum()))
        recs[i + 1] = colmap.ColmapImage(i + 1, rotmat_to_qvec(rot), tvec, 1, name,
                                         np.stack([u, v], axis=1)[keep], ids[keep])
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(recs, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_binary(colmap.ColmapPoints(
        ids=ids, xyz=xyz, rgb=np.round(rgb * 255).astype(np.uint8),
        error=np.full(len(ids), 0.5)), os.path.join(sparse, "points3D.bin"))
    return counts


async def viewer_client(port, trainer, steps, poses, frames):
    """A websocket client of the live viewer: asks for a frame at the next
    pose as soon as the last one arrives, as long as training runs; appends
    (latency s, step at the request, base64 JPEG) per frame."""
    import asyncio

    import websockets

    async with websockets.connect(f"ws://127.0.0.1:{port}", max_size=None) as ws:
        kind = "cameraInfo"
        while trainer.step < steps:
            pos, quat = poses[len(frames) % len(poses)]
            step = trainer.step
            t0 = time.perf_counter()
            await ws.send(json.dumps({"type": kind, "position": pos, "quat": quat,
                                      "aspectRatio": WIDTH / HEIGHT}))
            reply = json.loads(await asyncio.wait_for(ws.recv(), 300))
            frames.append((time.perf_counter() - t0, step, reply["image"]))
            kind = "renderRequest"


def objective(torch, tt, trainer, cams):
    """The training loss (L1 + DSSIM + the depth term at step 1's gates,
    where a camera has an estimated depth) of ``trainer``'s state, averaged
    over ``cams`` at full resolution."""
    st, cfg = trainer.state, trainer.cfg
    bg = torch.zeros(3, device=trainer.device)
    losses = []
    with torch.no_grad():
        for cam in cams:
            gt = trainer._device_image(cam, cam.width, cam.height)
            depth = (None if cam.estimated_depth is None else
                     torch.as_tensor(cam.estimated_depth, device=trainer.device))
            loss, _ = tt.compute_losses(st.params, None, st, cam.params(trainer.device), gt,
                                        depth, bg, 1, cfg, cam.height, cam.width)
            losses.append(float(loss))
    return statistics.mean(losses)


def decode_jpeg(b64):
    """A served frame as an HxWx3 uint8 array."""
    import base64
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def dataset_phase(torch, rc, tt, Config, state, deg, bg, device="cuda", height=HEIGHT,
                  width=WIDTH, views=DATASET_VIEWS, n_points=DATASET_POINTS,
                  capacity=N_SPLATS, steps=DATASET_STEPS, budgets=TRAINER_KW):
    """Phase 9: the dataset path at full width; see the module docstring."""
    import asyncio
    import copy

    from tinysplat_torch import export_cli, train_cli
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.depthest import DepthEstimator
    from tinysplat_torch.io.export import import_ply
    from tinysplat_torch.render import render, splat_inputs
    from tinysplat_torch.train_loop import Trainer
    from tinysplat_torch.viewer import Viewer

    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    print(f"phase 9: a COLMAP capture ({views} views, {height}x{width}, {n_points} SfM "
          f"points), depth-regularized training from the points in {capacity} slots, "
          f"{steps} steps under run_async beside the live viewer, export", flush=True)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        obs = write_colmap_capture(torch, root, state, deg, bg,
                                   orbit_cameras(views, width=width, height=height),
                                   n_points, device)
        print(f"  capture written in {time.perf_counter() - t0:.3f} s; observations per "
              f"image {obs}", flush=True)
        cfg = Config(dataset_dir=root, colmap_path=os.path.join(root, "sparse", "0"),
                     images_path=os.path.join(root, "images"),
                     depths_path=os.path.join(root, "depths"), regularize_depth=True,
                     depth_model="sparse_interp", grad_reduce="mxu", background="black",
                     capacity=capacity, max_iter=steps, save_checkpoints=True,
                     checkpoint_interval=steps, checkpoint_dir=os.path.join(root, "ckpt"),
                     **budgets)
        t0 = time.perf_counter()
        scene, pcd, cfg = train_cli.build_scene(cfg, device)
        load_s = time.perf_counter() - t0
        cams = scene.cameras
        if (len(cams) != views or (cams[0].height, cams[0].width) != (height, width)
                or len(pcd.xyz) != n_points):
            raise AssertionError(f"build_scene: {len(cams)} cameras of "
                                 f"{cams[0].height}x{cams[0].width}, {len(pcd.xyz)} points")
        depth_s = []
        for _ in range(2):  # the first fills the cache, the second reads it
            t0 = time.perf_counter()
            est = DepthEstimator(scene, pcd=pcd, depths_path=cfg.depths_path,
                                 model_name=cfg.depth_model)
            depth_s.append((time.perf_counter() - t0) / views)
        if est.backend is not None or len(os.listdir(cfg.depths_path)) != views:
            raise AssertionError("the second DepthEstimator did not read the cache")
        dmaps = np.stack([c.estimated_depth for c in cams])
        if dmaps.shape != (views, height, width) or not np.isfinite(dmaps).all():
            raise AssertionError(f"bad depth maps {dmaps.shape}")
        print(f"  build_scene (COLMAP read, PNG handles) {load_s:.3f} s; depth "
              f"(sparse_interp + scale fit) {depth_s[0]:.3f} s a camera cold, "
              f"{depth_s[1]:.4f} s cached; depth range {float(dmaps.min()):.3f}-"
              f"{float(dmaps.max()):.3f} (orbit radius 3.0)", flush=True)

        start = tt.init_from_pcd(pcd.xyz, pcd.colors, sh_degree=cfg.sh_degree,
                                 capacity=cfg.capacity, seed=cfg.seed, device=device)
        trainer = Trainer(cfg, scene, start)
        scene.render_fn = lambda camera, dims=None: trainer.render_camera(camera, dims)
        psnr_before = trainer.evaluate(cams)["eval_psnr"]
        loss_before = objective(torch, tt, trainer, cams)
        poses = []
        for cam in orbit_cameras(2 * views, width=width, height=height)[1::2]:
            rot = cam.view_matrix[:3, :3]
            poses.append((cam.position.tolist(), rotmat_to_qvec(rot).tolist()))
        viewer = Viewer(scene, "127.0.0.1", 0)
        frames, step_s, losses = [], [], []

        async def train():
            for s in range(1, steps + 1):
                t0 = time.perf_counter()
                await trainer.run_async(s)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                m = trainer.last_metrics
                losses.append((float(m["loss"]), float(m["loss_depth"])))

        async def serve_and_train():
            server = asyncio.create_task(viewer.run())
            while viewer.server is None:
                if server.done():
                    server.result()
                await asyncio.sleep(0.01)
            port = viewer.server.sockets[0].getsockname()[1]
            await asyncio.gather(train(), viewer_client(port, trainer, steps, poses, frames))
            viewer.stop()
            await server
            viewer._queue_task.cancel()
            return port

        kernels = counted_kernels()
        for k in kernels:
            _build.launches[k] = 0
        port = asyncio.run(serve_and_train())
        launches = {k: _build.launches[k] for k in kernels}
        check_launches(launches, {"composite_fwd": steps + len(frames), "composite_bwd": steps,
                                  "segsum": steps}, "phase 9 (steps and frames)")
        psnr_after = trainer.evaluate(cams)["eval_psnr"]
        loss_after = objective(torch, tt, trainer, cams)
        during = [f for f in frames if f[1] < steps]
        print(f"  viewer on port {port} (bound to 0): {len(frames)} frames, {len(during)} "
              f"asked for while training ran, at steps {[f[1] for f in frames]}; frame latency "
              f"the client saw (s) {[round(f[0], 4) for f in frames]}, median "
              f"{statistics.median(f[0] for f in frames):.4f} s; launches {launches}",
              flush=True)
        if len(during) < 2:
            raise AssertionError("the viewer served fewer than two frames during training")
        shape = decode_jpeg(frames[-1][2]).shape
        if shape != (height, width, 3):
            raise AssertionError(f"served frame of shape {shape}")
        print(f"  steps under run_async beside the viewer: host s "
              f"{[round(x, 4) for x in step_s]}, median {statistics.median(step_s):.4f} s; "
              f"(loss, loss_depth) per step {[(round(a, 5), round(b, 5)) for a, b in losses]}; "
              f"the loss over all {views} views {loss_before:.5f} -> {loss_after:.5f}, their "
              f"PSNR {psnr_before:.3f} -> {psnr_after:.3f} dB", flush=True)
        if not np.isfinite(losses).all() or not loss_after < loss_before:
            raise AssertionError("the loss over the views did not fall")

        # K1 bit for bit at the last served frame's camera; K2 within BWD_TOL
        # and K3 bit for bit, twice, at the last step's camera.
        camera = copy.copy(cams[0])
        camera.update_view_matrix(*(np.asarray(x, np.float32)
                                    for x in poses[(len(frames) - 1) % len(poses)]))
        cam_p = camera.params(device)
        tb = {k: getattr(trainer.cfg, k) for k in budgets}
        st, active = trainer.state, int(trainer.state.active_sh_degree)
        with torch.no_grad():
            s = splat_inputs(st.params, st.alive, cam_p, height, width, active, bg)
            ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                                s.opacities, s.valid, height, width, **tb)
        fargs = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x)
        got, ref = rc.composite_fwd(*fargs), rc.composite_fwd_plain(*fargs)
        torch.cuda.synchronize()
        if not same_bytes(torch, got, ref):
            raise AssertionError("K1 is not bit-equal to its plain version at the served "
                                 "frame's camera")
        last = scene.get_random_camera(trainer.step - 1)
        ti2, out2, gout2 = backward_inputs(torch, rc, st, last.params(device),
                                           trainer._device_image(last, width, height),
                                           active, trainer.cfg, tb)
        compare_backward(torch, rc, ti2, out2, gout2, f"dataset step {trainer.step}")
        print(f"  K1 at the served camera: bit-equal to its plain version ({int(ti.counts.sum())} "
              f"entries); K3 twice: bit-equal at the last step", flush=True)

        # Export through the CLI from the step-12 checkpoint, import the PLY.
        (ckpt,) = [os.path.join(cfg.checkpoint_dir, f) for f in os.listdir(cfg.checkpoint_dir)]
        sizes, export_s = {}, {}
        for filetype in ("PLY", "SPLAT"):
            out_path = os.path.join(root, f"model.{filetype.lower()}")
            t0 = time.perf_counter()
            export_cli.main(["--filetype", filetype, "--device", device, ckpt, out_path])
            export_s[filetype] = time.perf_counter() - t0
            sizes[filetype] = os.path.getsize(out_path)
        live = int(trainer.state.num_live())
        t0 = time.perf_counter()
        imported = import_ply(os.path.join(root, "model.ply"), device=device)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        if sizes["SPLAT"] != 32 * live or int(imported.num_live()) != live:
            raise AssertionError(f"export sizes {sizes} for {live} live splats")
        with torch.no_grad():
            rgb_tr, _ = trainer.render_camera(camera)
            rgb_im, _ = render(imported.params, imported.alive, cam_p, height, width, active,
                               torch.zeros(3, device=device), **tb)
        export_err = float((rgb_tr - rgb_im).abs().max())
        print(f"  export_cli from the step-{steps} checkpoint ({os.path.getsize(ckpt) / 2**20:.1f}"
              f" MiB): PLY {export_s['PLY']:.3f} s, {sizes['PLY']} bytes; .splat "
              f"{export_s['SPLAT']:.3f} s, {sizes['SPLAT']} bytes ({live} live); import_ply "
              f"{import_s:.3f} s; its render vs the trainer's at the served camera: max abs "
              f"diff {export_err:.3e} (tol {EXPORT_TOL:g})", flush=True)
        if export_err > EXPORT_TOL:
            raise AssertionError("the imported PLY renders another frame")

        # The evaluate CLI on the step-12 checkpoint, every second view,
        # against Trainer.evaluate of the same state on the same cameras.
        from tinysplat_torch.scripts import evaluate

        t0 = time.perf_counter()
        ev = evaluate.main([ckpt, "--dataset-dir", root, "--holdout", "2"])
        eval_s = time.perf_counter() - t0
        held = cams[::2]
        want = [trainer.evaluate([c])["eval_psnr"] for c in held]
        deltas = [abs(v["psnr"] - w) for v, w in zip(ev["per_view"], want)]
        print(f"  evaluate CLI ({eval_s:.3f} s, {ev['views']} views at {width}x{height}): PSNR "
              f"{[v['psnr'] for v in ev['per_view']]}, SSIM {[v['ssim'] for v in ev['per_view']]}; "
              f"Trainer.evaluate {[round(w, 4) for w in want]}; max |delta| "
              f"{max(deltas):.2e} dB (tol {EVAL_TOL_DB:g})", flush=True)
        if ([v["name"] for v in ev["per_view"]] != [c.name for c in held]
                or max(deltas) > EVAL_TOL_DB):
            raise AssertionError("the evaluate CLI disagrees with Trainer.evaluate")
    print(f"  phase 9: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)


def read_obj(path):
    """(vertices, 0-based faces, normals) of an OBJ that export_mesh_obj wrote."""
    rows = {"v ": [], "vn": [], "f ": []}
    with open(path) as fh:
        for line in fh:
            if line[:2] in rows:
                rows[line[:2]].append(line[2:].replace("//", " "))

    def table(key, dtype, width):
        return np.array(" ".join(rows[key]).split(), dtype=dtype).reshape(-1, width)

    return table("v ", np.float64, 3), table("f ", np.int64, 6)[:, ::2] - 1, table(
        "vn", np.float64, 3)


def face_normal_sums(verts, faces):
    """Per vertex, the sum of its faces' (area-weighted) normals, float64."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    acc = np.zeros_like(verts, dtype=np.float64)
    for i in range(3):
        np.add.at(acc, faces[:, i], fn)
    return np.linalg.norm(acc, axis=1)


def check_mesh(verts, faces, normals, lo, hi, label):
    """Raise unless the mesh is non-empty, its faces index its vertices, the
    normal of every vertex with a defined normal is of unit length, and its
    vertices lie in the box of the live means padded by 10%. A vertex has
    no normal when no face uses it (Poisson's support trim can leave some)
    or its faces have no area (marching tetrahedra at a corner value equal
    to the iso level); vertex_normals gives those 0 or less than unit
    length, as the JAX package's does. Returns the counts of both kinds."""
    if len(verts) == 0 or len(faces) == 0:
        raise AssertionError(f"{label}: empty mesh")
    if faces.min() < 0 or faces.max() >= len(verts):
        raise AssertionError(f"{label}: faces index past the vertices")
    used = np.zeros(len(verts), bool)
    used[faces.ravel()] = True
    defined = used & (face_normal_sums(verts, faces) > 1e-9)
    norm_err = float(np.abs(np.linalg.norm(normals[defined], axis=1) - 1.0).max())
    if norm_err > 1e-4:
        raise AssertionError(f"{label}: normals off unit length by {norm_err:.2e}")
    pad = 0.1 * (hi - lo)
    if not ((verts >= lo - pad) & (verts <= hi + pad)).all():
        raise AssertionError(f"{label}: vertices outside the live means' box + 10%")
    return int((~used).sum()), int((used & ~defined).sum())


def knn_bounds(points, slots, live, k=16):
    """The KNN of ``points`` query points against ``slots`` means (``live``
    of them live): (bound ms, by) of the function (inputs read once, the
    (points, k) int64 indices written once; KNN_FLOP_PER_PAIR per live
    pair at the FP32 peak), and the ms of writing and reading the (points,
    slots) float32 block once, which the matmul + top-k route does."""
    bound, by = kernel_bound(points * 12 + slots * 13, points * k * 8,
                             points * live * KNN_FLOP_PER_PAIR)
    return bound, by, points * slots * 4 * 2 / HBM_BYTES_PER_S * 1e3


def density_kernel_gaps(torch, probe, params, depth, cam, height, width, use_sdf,
                        camera_grad=False):
    """SuGaR's density term on the card through its kernels (one launch of
    each), against its plain torch ops (``takes_kernels`` refused) in
    float32 and in float64 on the same inputs: {"loss" or a leaf's name:
    (kernels' gap, plain float32's gap)} to float64, the loss relative, a
    gradient over its largest |entry|. Raises unless ``density_cuda``'s
    bounds hold. ``camera_grad``: the camera's tensors carry a gradient
    (``pose_opt``) and are compared too."""
    from tinysplat_torch.ops import density_cuda
    from tinysplat_torch.regularizers.density import density_loss

    splats = ("means", "quats", "scales", "opacities")
    cams = ("viewmat", "projmat", "cx_off", "cy_off") if camera_grad else ()

    def term(dtype, plain):
        leaves = {k: getattr(params, k).detach().to(dtype).requires_grad_() for k in splats}
        leaves["depth"] = depth.detach().to(dtype).requires_grad_()
        c = dataclasses.replace(cam, **{f.name: getattr(cam, f.name).detach().to(dtype)
                                        for f in dataclasses.fields(cam)})
        for k in cams:
            leaves[k] = getattr(c, k).clone().requires_grad_()
        c = dataclasses.replace(c, **{k: leaves[k] for k in cams})
        p = dataclasses.replace(params, **{k: leaves[k] for k in splats})
        orig = density_cuda.takes_kernels
        if plain:
            density_cuda.takes_kernels = lambda *a: False
        try:
            loss = density_loss(probe._replace(points=probe.points.to(dtype)), p,
                                leaves["depth"], c, height, width, use_sdf=use_sdf)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        finally:
            density_cuda.takes_kernels = orig
        return loss.detach().double(), {k: (torch.zeros_like(v) if g is None else g).double()
                                        for (k, v), g in zip(leaves.items(), grads)}

    before = (_build.launches["density_fwd"], _build.launches["density_bwd"])
    got = term(torch.float32, False)
    after = (_build.launches["density_fwd"], _build.launches["density_bwd"])
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        raise AssertionError(f"the density term launched {before} -> {after}, not one each")
    plain, ref = term(torch.float32, True), term(torch.float64, True)
    gaps = {"loss": tuple(float(abs(x[0] - ref[0]) / abs(ref[0])) for x in (got, plain))}
    for k, r in ref[1].items():
        top = max(float(r.abs().max()), 1e-30)
        gaps[k] = tuple(float((x[1][k] - r).abs().max()) / top for x in (got, plain))
    if not density_cuda.within_tol(gaps):
        raise AssertionError(f"the density kernels past their bounds: {gaps}")
    return gaps


def mesh_objective(torch, tt, state, cfg, cams, device):
    """The image loss (L1 + DSSIM) of ``state`` over ``cams`` at full
    resolution over black, averaged."""
    plain = dataclasses.replace(cfg, regularize_density=False, densify_strategy="default")
    bg = torch.zeros(3, device=device)
    losses = []
    with torch.no_grad():
        for cam in cams:
            gt = torch.as_tensor(cam.get_original_image(), device=device)
            loss, _ = tt.compute_losses(state.params, None, state, cam.params(device), gt, None,
                                        bg, 1, plain, cam.height, cam.width)
            losses.append(float(loss))
    return statistics.mean(losses)


def sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def mesh_phase(torch, rc, tt, Config, gts, device="cuda", height=HEIGHT, width=WIDTH,
               n=N_SPLATS, samples=MESH_SAMPLES, resolution=MESH_RESOLUTION, poisson_depth=9,
               budgets=TRAINER_KW, mesh_256=False):
    """Phase 10: density regularization + MCMC on the bench scene, then the
    mesh both ways (and at the CLI's default --resolution 256 with
    ``mesh_256``); see the module docstring. Returns the launches of the
    counted kernels in its 12 steps and the density kernels' rows (device ms
    at the last probe, the largest gap to float64) for the kernels' line."""
    from tinysplat_torch import export_cli
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.io.checkpoint import load_model, save_checkpoint
    from tinysplat_torch.regularizers.density import density_loss
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    phase_t0 = time.perf_counter()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cams = orbit_cameras(len(gts), width=width, height=height)
    for cam, gt in zip(cams, gts):
        cam._image = gt.cpu().numpy()
    scene = Scene(cams)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench_scene.npz")
        write_bench_checkpoint(ckpt, n=n)
        start = load_model(ckpt, device=device)
        rng = np.random.default_rng(7)
        noise = rng.normal(0.0, 0.1, size=tuple(start.params.colors_dc.shape))

        def dim(state):
            """MESH_DIM_SHARE of the live splats to opacity logit -7 (numpy draw)."""
            live = np.nonzero(state.alive.cpu().numpy())[0]
            picked = rng.choice(live, int(MESH_DIM_SHARE * len(live)), replace=False)
            with torch.no_grad():
                state.params.opacities[torch.as_tensor(picked, device=device)] = -7.0
            return len(picked)

        with torch.no_grad():  # the bench scene's own opacities, perturbed colours
            start.params.colors_dc += torch.where(
                start.alive[:, None], torch.as_tensor(noise, dtype=torch.float32, device=device),
                0.0)
        dimmed = [dim(start)]
        cfg = Config(background="black", warmup_grad=0, grad_reduce="mxu",
                     densify_strategy="mcmc", warmup_densify=4, densify_end=8,
                     interval_densify=4, regularize_density=True, regularize_density_start=2,
                     regularize_density_end=MESH_STEPS + 1, density_samples=samples,
                     max_iter=MESH_STEPS, save_checkpoints=True, checkpoint_interval=MESH_STEPS,
                     checkpoint_dir=os.path.join(tmp, "ckpt"), **budgets)
        print(f"phase 10: SuGaR density regularization (steps 2-{MESH_STEPS}, {samples} probe "
              f"samples) + MCMC densify, {int(start.num_live())} splats in {start.capacity} "
              f"slots, {height}x{width}, {len(cams)} views, grad_reduce mxu; then OBJ meshes "
              f"(marching_cubes at {resolution}, poisson at depth {poisson_depth})", flush=True)
        tr = Trainer(cfg, scene, start)
        objective = {"start": mesh_objective(torch, tt, tr.state, cfg, cams, device)}
        ref_path = os.path.join(tmp, "before_refine.npz")
        kernels = counted_kernels()
        for k in kernels:
            _build.launches[k] = 0
        step_s, loss_density = [], []
        for s in range(1, MESH_STEPS + 1):
            if s == cfg.warmup_densify:
                # The density-start prune (step 2) removed every splat below
                # opacity 0.5, the start's dimmed ones with them: dim 5% of
                # the live ones again, so the first refine pass relocates.
                dimmed.append(dim(tr.state))
                save_checkpoint(ref_path, tr.state)  # the objective's reference
            t0 = time.perf_counter()
            tr.run(s)
            sync(torch, device)
            step_s.append(time.perf_counter() - t0)
            loss_density.append(float(tr.last_metrics.get("loss_density", float("nan"))))
        launches = {k: _build.launches[k] for k in kernels}
        if cuda:  # the density term once a step from its window's start (steps count from 1)
            terms = MESH_STEPS - cfg.regularize_density_start + 1
            check_launches(launches, {"composite_fwd": MESH_STEPS, "composite_bwd": MESH_STEPS,
                                      "segsum": MESH_STEPS, "density_fwd": terms,
                                      "density_bwd": terms}, f"phase 10 ({MESH_STEPS} steps)")
        objective["before the first refine"] = mesh_objective(
            torch, tt, load_model(ref_path, device=device), cfg, cams, device)
        objective["end"] = mesh_objective(torch, tt, tr.state, cfg, cams, device)
        print(f"  launches in the {MESH_STEPS} steps: {launches}; dimmed to logit -7: "
              f"{dimmed[0]} at the start, {dimmed[1]} before step {cfg.warmup_densify}; "
              f"loss_density per step {[round(x, 5) for x in loss_density]}", flush=True)
        for h in tr.densify_history:
            print(f"  MCMC refine at step {h['step']}: relocated {h['relocated']}, grown "
                  f"{h['grown']}, live {h['num_live']} in {h['capacity_after']} slots; "
                  f"{h['seconds']:.4f} s", flush=True)
        first = tr.densify_history[0] if tr.densify_history else {}
        if (len(tr.densify_history) != 2 or first["relocated"] <= 0
                or tr.state.capacity != start.capacity
                or any(h["num_live"] > start.capacity for h in tr.densify_history)):
            raise AssertionError(f"phase 10 refine passes: {tr.densify_history}")
        for p in tr.probe_history:
            bound, by, block_ms = knn_bounds(p["samples"], tr.state.capacity, p["live"])
            print(f"  probe refresh at step {p['step']}: {p['samples']} samples of {p['live']} "
                  f"live splats; sampling {p['sample_s'] * 1e3:.3f} ms, KNN "
                  f"{p['knn_s'] * 1e3:.3f} ms against a bound of {bound:.4f} ms by {by} "
                  f"({p['samples']} x {p['live']} pairs x {KNN_FLOP_PER_PAIR} FLOP) and "
                  f"{block_ms:.3f} ms to write and read the ({p['samples']}, "
                  f"{tr.state.capacity}) distance block once", flush=True)
        if [p["step"] for p in tr.probe_history] != [2, 5, 9]:
            raise AssertionError(f"probe refreshes at {[p['step'] for p in tr.probe_history]}")
        if cuda:  # the KNN's two torch layers, one chunk of the last probe alone
            from tinysplat_torch.probes import timed_ms
            from tinysplat_torch.regularizers.density import KNN_BLOCK_ELEMS

            rows = max(1, KNN_BLOCK_ELEMS // tr.state.capacity)
            means = tr.state.params.means.detach()
            pts = tr.density_probe.points[:rows]
            m_sq = torch.where(tr.state.alive, (means * means).sum(-1), torch.inf)[None]
            block = torch.addmm(m_sq, pts, means.T, alpha=-2.0)
            mm_ms = timed_ms(lambda: torch.addmm(m_sq, pts, means.T, alpha=-2.0), 10,
                             device_only=True)
            topk_ms = timed_ms(lambda: torch.topk(block, 17, dim=1, largest=False), 10,
                               device_only=True)
            chunks = -(-samples // rows)
            print(f"  KNN layers, one {rows}-row chunk of the last probe (device time, median "
                  f"of 10): addmm {mm_ms:.4f} ms, top-17 {topk_ms:.4f} ms; x {chunks} chunks "
                  f"= {(mm_ms + topk_ms) * chunks:.1f} ms a refresh", flush=True)
        print(f"  objective (L1 + DSSIM over the {len(cams)} views): "
              f"{ {k: round(v, 6) for k, v in objective.items()} }; host s per step "
              f"{[round(x, 4) for x in step_s]}, median {statistics.median(step_s):.4f} s"
              + (f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                 if cuda else ""), flush=True)
        if not (np.isfinite(list(objective.values())).all()
                and objective["end"] < objective["before the first refine"]):
            raise AssertionError(f"the objective did not fall: {objective}")
        if not np.isfinite(loss_density[1:]).all():
            raise AssertionError(f"loss_density {loss_density}")

        # K1 bit for bit, K2 to BWD_TOL and K3 bit for bit, twice, at the
        # last step, with the cotangent the density term adds to the depth.
        st, probe = tr.state, tr.density_probe
        last = scene.get_random_camera(tr.step - 1)
        cam_p = last.params(device)
        params = dataclasses.replace(st.params, **{k: t.detach() for k, t in st.params.fields()})

        rendered = {}

        def dens(depth):
            rendered["depth"] = depth.detach()
            return cfg.lambda_density * density_loss(probe, params, depth, cam_p, height, width)

        tb = {k: getattr(tr.cfg, k) for k in budgets}
        ti, out, gout = backward_inputs(torch, rc, st, cam_p, tr._device_image(
            last, width, height), int(st.active_sh_degree), tr.cfg, tb, depth_loss=dens)
        fargs = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x)
        got, ref = rc.composite_fwd(*fargs), rc.composite_fwd_plain(*fargs)
        sync(torch, device)
        if not same_bytes(torch, got, ref):
            raise AssertionError("K1 is not bit-equal to its plain version at step 12")
        depth_cot = float(gout[:, 3].abs().max())
        if not depth_cot > 0:
            raise AssertionError("the density term fed no depth cotangent")
        compare_backward(torch, rc, ti, out, gout, f"density + mcmc step {tr.step}")
        print(f"  K1 bit-equal to its plain version at step {tr.step} "
              f"({int(ti.counts.sum())} entries); the density term's depth cotangent, max "
              f"|d loss / d depth row| {depth_cot:.3e}", flush=True)
        density_rows = {}
        if cuda:
            from tinysplat_torch.ops import density_cuda
            from tinysplat_torch.probes import timed_ms

            largest = 0.0
            for use_sdf in (False, True):
                gaps = density_kernel_gaps(torch, probe, params, rendered["depth"], cam_p,
                                           height, width, use_sdf, camera_grad=use_sdf)
                largest = max([largest] + [a for a, _ in gaps.values()])
                label = "SDF mode, the camera's gradient too" if use_sdf else "density mode"
                shown = {k: f"{a:.3g} ({b:.3g})" for k, (a, b) in gaps.items()}
                print(f"  the density kernels at step {tr.step}, {label}: gaps to the float64 "
                      f"plain version, kernels (plain float32): {shown}", flush=True)
            t = density_cuda.term_inputs(probe, params, rendered["depth"], cam_p, height, width,
                                         False)
            _, denom = density_cuda.density_fwd(t)
            g = torch.ones((), device=device)
            density_rows = {name: {"ms": timed_ms(fn, 20, device_only=True), "max_gap": largest}
                            for name, fn in (
                                ("density_fwd", lambda: density_cuda.density_fwd(t)),
                                ("density_bwd", lambda: density_cuda.density_bwd(g, denom, t)))}
            print(f"  the density kernels at step {tr.step}, {probe.knn_idx.shape[0]} points x "
                  f"{probe.knn_idx.shape[1]} over {st.capacity} slots (device ms, median of 20): "
                  f"{ {k: round(v['ms'], 4) for k, v in density_rows.items()} }", flush=True)

        # The mesh, through the CLI, from the step-12 checkpoint.
        (ck12,) = [os.path.join(cfg.checkpoint_dir, f) for f in os.listdir(cfg.checkpoint_dir)]
        means = st.params.means.detach()[st.alive].cpu().numpy()
        lo, hi = means.min(axis=0), means.max(axis=0)
        runs = [("marching_cubes", ["--resolution", str(resolution)]),
                ("poisson", ["--poisson-depth", str(poisson_depth)])]
        if mesh_256:
            runs.append(("marching_cubes", []))
        for alg, flags in runs:
            out_path = os.path.join(tmp, f"{alg}.obj")
            _build.launches["composite_fwd"] = 0
            t0 = time.perf_counter()
            summary = export_cli.main(["--filetype", "OBJ", "--device", device,
                                       "--mesh-extraction-algorithm", alg, *flags, ck12,
                                       out_path])
            total = time.perf_counter() - t0
            verts, faces, normals = read_obj(out_path)
            if (len(verts), len(faces)) != (summary["vertices"], summary["faces"]):
                raise AssertionError(f"{alg}: the OBJ holds another mesh than the summary")
            unused, flat = check_mesh(verts, faces, normals, lo, hi, alg)
            label = f"{alg} {' '.join(flags) or '(default --resolution 256)'}"
            extra = ""
            if alg == "marching_cubes":
                res = int(flags[1]) if flags else 256
                bound, by, block_ms = knn_bounds(res ** 3, st.capacity, int(st.num_live()))
                extra = (f"; grid KNN bound {bound:.3f} ms by {by}, the ({res ** 3}, "
                         f"{st.capacity}) block once {block_ms:.1f} ms")
            print(f"  export_cli OBJ {label}: {total:.3f} s ({os.path.getsize(out_path)} bytes); "
                  f"stages (s) { {k: round(v, 4) for k, v in summary['seconds'].items()} }; "
                  f"{len(verts)} vertices, {len(faces)} faces ({unused} vertices in no face, {flat} "
                  f"whose faces have no area); "
                  f"K1 launches {_build.launches['composite_fwd']}{extra}", flush=True)
    print(f"  phase 10: {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return launches, density_rows


def shard_start(torch, device):
    """Phase 6's start (the bench scene, opacity logits -1, colours + N(0,
    0.1)) in exactly its 262,144 slots, so the first densify overflows."""
    from tinysplat_torch.io.checkpoint import load_model

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench_scene.npz")
        write_bench_checkpoint(ckpt)
        state = load_model(ckpt, capacity=N_SPLATS, device=device)
    noise = np.random.default_rng(7).normal(0.0, 0.1, size=tuple(state.params.colors_dc.shape))
    with torch.no_grad():
        live = state.alive[:, None]
        state.params.opacities[:] = torch.where(live, -1.0, state.params.opacities)
        state.params.colors_dc += torch.where(
            live, torch.as_tensor(noise, dtype=torch.float32, device=device), 0.0)
    return state


def shard_cfg(Config, ckpt_dir):
    return Config(background="black", warmup_grad=0, grad_reduce="mxu", tau_means=0.0,
                  densify_scale_thresh=1e9, warmup_densify=TRAIN_VIEWS,
                  densify_end=TRAIN_VIEWS, interval_opacity_reset=0, save_checkpoints=True,
                  checkpoint_interval=SHARD_STEPS, checkpoint_dir=ckpt_dir,
                  max_iter=SHARD_STEPS, **TRAINER_KW)


def shard_rank(mesh_shape, batch, ckpt_dir, scene, frame_cams):
    """One rank of phase 11 (run by ``parallel.local.run``): the sharded
    frames, then ``MeshTrainer``; on rank 0 of a mesh with bands, K1-K3 vs
    their plain versions on its band at the last step."""
    import torch

    from tinysplat_torch.config import Config
    from tinysplat_torch.io.checkpoint import load_model
    from tinysplat_torch.ops import rasterize_cuda as rc
    from tinysplat_torch.parallel import MeshTrainer, collectives, make_mesh, rank_device
    from tinysplat_torch.parallel.sharding import gather_state, shard_state
    from tinysplat_torch.parallel.train_step import make_sharded_render
    from tinysplat_torch.render import splat_inputs

    dev = rank_device()
    mesh = make_mesh(*mesh_shape)
    kernels = counted_kernels()
    out = {"rank": mesh.rank}
    height = SHARD_HEIGHT
    if frame_cams:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "bench_scene.npz")
            write_bench_checkpoint(ckpt)
            serve, _ = shard_state(mesh, load_model(ckpt, device=dev))
        fn = make_sharded_render(Config(**TRAINER_KW), height, WIDTH, mesh)
        bg = torch.zeros(3, device=dev)
        for k in kernels:
            _build.launches[k] = 0
        frames, frame_ms = [], []
        for cam in frame_cams:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rgb, depth, alpha = fn(serve.params, serve.alive, serve.active_sh_degree,
                                   cam.params(dev), bg)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            frames.append(tuple(x.cpu().numpy() for x in (rgb, depth, alpha)))
        out.update(frame_launches=_build.launches["composite_fwd"], frame_ms=frame_ms,
                   frames=frames if mesh.rank == 0 else None)
        del serve
    tr = MeshTrainer(shard_cfg(Config, ckpt_dir), scene, shard_start(torch, dev), mesh=mesh)
    # The 1-rank reference world takes the 4-rank mesh's cameras a step
    # (one per data group there); the step is built at the first step.
    tr.batch = batch
    for k in kernels:
        _build.launches[k] = 0
    collectives.timings = {}
    step_ms, metrics = [], []
    for s in range(1, SHARD_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(s)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in tr.last_metrics.items()})
    out.update(step_ms=step_ms, metrics=metrics, collectives=collectives.timings,
               launches={k: _build.launches[k] for k in kernels},
               history=tr.densify_history, capacity=tr._global_capacity(),
               shard={name: t.detach().cpu().numpy() for name, t in tr.state.params.fields()},
               alive=tr.state.alive.cpu().numpy(),
               accum=tr.state.means_grad_accum.cpu().numpy(),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    collectives.timings = None
    if mesh.size > 1:
        full, _ = gather_state(mesh, tr.state, tr.opt_state)  # collective
        if mesh.rank == 0:
            cam = scene.get_random_camera((tr.step - 1) * batch)  # data group 0's first
            cfg = tr.cfg
            with torch.no_grad():
                s = splat_inputs(full.params, full.alive, cam.params(dev), height, WIDTH,
                                 full.active_sh_degree, torch.zeros(3, device=dev))
                ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics,
                                    s.colors4, s.opacities, s.valid, height // mesh.tile,
                                    WIDTH, tile_x=cfg.tile_x, dup_capacity=cfg.dup_capacity,
                                    span_capacity=cfg.span_capacity,
                                    max_per_tile=cfg.max_per_tile, row_stride=mesh.tile,
                                    row_offset=0)
            label = f"rank 0's band (tile rows 0, {mesh.tile}, ...) at step {tr.step}"
            fargs = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy,
                     ti.tile_x)
            k1_err, k1_out = compare_kernel(torch, rc, fargs, label)
            k2_err, _ = compare_backward(torch, rc, ti, k1_out,
                                         random_cotangent(torch, k1_out, 11), label)
            out.update(k1_err=k1_err, k2_err=k2_err)
    return out


def shard_phase(torch, Config):
    """Phase 11: see the module docstring. Returns the K1-K3, S1, S2 launches of
    the 4 ranks' training windows."""
    import chip_smoke  # the ranks import this file by its module name, not as __main__
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.io.checkpoint import load_model, restore_checkpoint_sharded
    from tinysplat_torch.parallel import local
    from tinysplat_torch.render import render
    from tinysplat_torch.scene import Scene

    phase_t0 = time.perf_counter()
    height, n_ranks = SHARD_HEIGHT, SHARD_MESH[0] * SHARD_MESH[1]
    print(f"phase 11: {SHARD_MESH} mesh of {n_ranks} ranks on one card (gloo, host-staged "
          f"collectives), {N_SPLATS} splats, {height}x{WIDTH}, interleaved bands, "
          f"{SHARD_MESH[0]} cameras a step; {gpu_name_and_limit()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench_scene.npz")
        write_bench_checkpoint(ckpt)
        serve = load_model(ckpt, device="cuda")
    bg = torch.zeros(3, device="cuda")
    deg = serve.active_sh_degree
    views = orbit_cameras(TRAIN_VIEWS, width=WIDTH, height=height)
    frame_cams = orbit_cameras(SHARD_FRAMES, width=WIDTH, height=height)
    with torch.no_grad():
        for cam in views:
            cam._image = render(serve.params, serve.alive, cam.params("cuda"), height, WIDTH,
                                deg, bg, **TRAINER_KW)[0].cpu().numpy()
        refs = [tuple(x.cpu().numpy() for x in (r[0], r[1]["depth"], r[1]["alpha"]))
                for r in (render(serve.params, serve.alive, c.params("cuda"), height, WIDTH,
                                 deg, bg, **TRAINER_KW) for c in frame_cams)]
    del serve
    scene = Scene(views)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = local.run(chip_smoke.shard_rank, n_ranks, args=(SHARD_MESH, SHARD_MESH[0],
                                                      os.path.join(tmp, "mesh"), scene,
                                                      frame_cams), timeout=600)
        mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (one,) = local.run(chip_smoke.shard_rank, 1, args=((1, 1), SHARD_MESH[0],
                                                 os.path.join(tmp, "one"), scene, None),
                           timeout=300)
        one_s = time.perf_counter() - t0
        (ckpt_dir,) = [os.path.join(tmp, "mesh", f) for f in os.listdir(os.path.join(tmp,
                                                                                   "mesh"))]
        t0 = time.perf_counter()
        restored, opt, step, _ = restore_checkpoint_sharded(ckpt_dir, Config(), device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0

    # The sharded frames against the one-device render.
    errs, bit_equal = [], True
    for got, ref in zip(ranks[0]["frames"], refs):
        errs.append(max(float(np.abs(g - r).max()) for g, r in zip(got, ref)))
        bit_equal &= all(np.array_equal(g, r) for g, r in zip(got, ref))
    print(f"  sharded render, {SHARD_FRAMES} frames: max |sharded - one-device| by frame "
          f"{[float(f'{e:.3e}') for e in errs]} (tol {SHARD_TOL:g}); bit-equal {bit_equal}; "
          f"K1 launches per rank {[r['frame_launches'] for r in ranks]}; frame ms per rank "
          f"{[[round(x, 1) for x in r['frame_ms']] for r in ranks]}", flush=True)
    if max(errs) > SHARD_TOL or any(r["frame_launches"] != SHARD_FRAMES for r in ranks):
        raise AssertionError("the sharded frames differ from the one-device render")

    # The 4-rank MeshTrainer against the 1-rank world (NCCL), 1-vs-N bar.
    launches = [r["launches"] for r in ranks]
    grown = [(h["step"], h["cloned"], h["capacity_before"], h["capacity_after"])
             for h in ranks[0]["history"]]
    print(f"  MeshTrainer, {SHARD_STEPS} steps: K1/K2/K3 launches per rank {launches}; "
          f"densify (step, cloned, capacity before, after) {grown}; peak GiB per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]}", flush=True)
    for i, got in enumerate(launches):
        check_launches(got, {"composite_fwd": SHARD_STEPS, "composite_bwd": SHARD_STEPS,
                             "segsum": SHARD_STEPS}, f"phase 11 rank {i}")
    if ranks[0]["capacity"] != 3 * N_SPLATS or one["capacity"] != 3 * N_SPLATS:
        raise AssertionError("the densify at step 4 did not grow the capacity to 786,432")
    for r in ranks:
        print(f"  rank {r['rank']}: step ms {[round(x, 1) for x in r['step_ms']]}; "
              f"collective s over the {SHARD_STEPS} steps "
              f"{ {k: round(v, 3) for k, v in sorted(r['collectives'].items())} }", flush=True)
    print(f"  1-rank world (NCCL): step ms {[round(x, 1) for x in one['step_ms']]}; collective "
          f"s { {k: round(v, 4) for k, v in sorted(one['collectives'].items())} }; "
          f"the 4 ranks share one card, so their times are time-sliced, not scaling figures",
          flush=True)
    print(f"  losses, 4 ranks {[round(m['loss'], 6) for m in ranks[0]['metrics']]}; 1 rank "
          f"{[round(m['loss'], 6) for m in one['metrics']]}", flush=True)
    for i, (m4, m1) in enumerate(zip(ranks[0]["metrics"], one["metrics"])):
        for k in ("loss", "psnr", "loss_l1", "loss_ssim", "num_live", "n_intersections"):
            if not np.isclose(m4[k], m1[k], rtol=2e-4, atol=2e-5):
                raise AssertionError(f"step {i + 1} {k}: 4 ranks {m4[k]} vs 1 rank {m1[k]}")
    alive = np.concatenate([r["alive"] for r in ranks])
    if not np.array_equal(alive, one["alive"]):
        raise AssertionError("the 4 ranks' alive mask differs from the 1-rank world's")
    live = one["alive"]
    report, bar = {}, True
    for name, lr in LRS.items():
        a = one["shard"][name][live]
        b = np.concatenate([r["shard"][name] for r in ranks])[live]
        close = float(np.isclose(a, b, rtol=3e-4, atol=3e-5).mean())
        worst = float(np.abs(a - b).max()) / lr
        report[name] = (round(close, 6), round(worst, 4))
        bar &= close > 0.99 and worst < 2.5
    accum = np.concatenate([r["accum"] for r in ranks])
    accum_ok = bool(np.allclose(accum[live], one["accum"][live], rtol=5e-3, atol=1e-4))
    print(f"  1-vs-N after {SHARD_STEPS} steps, per field (share within rtol 3e-4 atol 3e-5, "
          f"max diff / lr): {report}; accumulators within rtol 5e-3 atol 1e-4 {accum_ok}",
          flush=True)
    if not (bar and accum_ok):
        raise AssertionError("the 4 ranks miss the 1-vs-N bar against the 1-rank world")

    # The step-8 sharded checkpoint, restored whole by this one process.
    same = step == SHARD_STEPS and opt.count == SHARD_STEPS and all(
        np.array_equal(t.detach().cpu().numpy(),
                       np.concatenate([r["shard"][name] for r in ranks]))
        for name, t in restored.params.fields())
    print(f"  step-{step} sharded checkpoint restored in one process: {restore_s:.3f} s, "
          f"capacity {restored.capacity}, equal to the 4 ranks' state {same}", flush=True)
    if not same:
        raise AssertionError("the restored sharded checkpoint differs from the ranks' state")
    print(f"  K1 / K2 on rank 0's band: max abs err {ranks[0]['k1_err']:.3e} / "
          f"{ranks[0]['k2_err']:.3e}; 4-rank world {mesh_s:.1f} s, 1-rank world "
          f"{one_s:.1f} s; phase {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return {k: sum(r[k] for r in launches) for k in launches[0]}


def sd15_state_dict(torch, model, seed):
    """Random weights for every tensor of ``model`` (built on the meta
    device), drawn on the card from a seeded generator and stored as
    float16: kernels normal with std 1 / sqrt(fan_in), norm scales 1,
    biases 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if v.dim() >= 2:
            w = torch.randn(tuple(v.shape), generator=g, device="cuda") / float(
                np.sqrt(v[0].numel()))
        elif k.endswith("weight") and "norm" in k:
            w = torch.ones(tuple(v.shape), device="cuda")
        else:
            w = torch.zeros(tuple(v.shape), device="cuda")
        sd[k] = w.half().cpu()
    return sd


def write_sd15_dir(torch, root, seed=0):
    """A diffusers directory with the published SD v1.5 unet/ and vae/
    configs and seeded random float16 weights; returns its parameter count."""
    from tinysplat_torch.diffusion.port import write_safetensors
    from tinysplat_torch.diffusion.sd_unet import UNet2DConditionModel
    from tinysplat_torch.diffusion.sd_vae import SDAutoencoderKL

    count = 0
    for i, (sub, cls, cfg) in enumerate((("unet", UNet2DConditionModel, SD15_UNET),
                                         ("vae", SDAutoencoderKL, SD15_VAE))):
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg, f)
        with torch.device("meta"):
            model = cls(cfg)
        sd = sd15_state_dict(torch, model, seed + i)
        count += sum(v.numel() for v in sd.values())
        write_safetensors(os.path.join(root, sub, "diffusion_pytorch_model.safetensors"), sd,
                          "F16")
    return count


def host_copy(torch, module):
    """An SD module (``sd_unet`` / ``sd_vae``) with the same weights on the
    host CPU, built from its config (not a copy of the object: the stage
    timer wraps the card's module's methods)."""
    with torch.device("meta"):
        copy = type(module)(module.config)
    copy.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()}, assign=True)
    return copy.eval()


class StageTimer:
    """CUDA-event times of the pipeline's stages: wraps the bound methods
    ``vae.encode``, ``unet.forward`` and ``vae.decode`` of a pipeline."""

    def __init__(self, torch, pipe):
        self.torch, self.events = torch, {}
        for name, obj, attr in (("vae encode", pipe.vae, "encode"),
                                ("unet", pipe.unet, "forward"),
                                ("vae decode", pipe.vae, "decode")):
            self.events[name] = []
            setattr(obj, attr, self._timed(getattr(obj, attr), name))

    def _timed(self, fn, name):
        def run(*args, **kw):
            start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[name].append((start, end))
            return out
        return run

    def take(self):
        """{stage: [ms, ...]} since the last take."""
        self.torch.cuda.synchronize()
        out = {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}
        for v in self.events.values():
            v.clear()
        return out


def stage_bounds(torch, pipe, size):
    """Per stage at the refresh's shapes: (FLOP of its matmuls and
    convolutions, counted by torch's FlopCounterMode from the shapes;
    bytes of its weights, inputs and outputs once; the bound in ms and what
    bounds it). The UNet runs at the CFG batch of 2."""
    from torch.utils.flop_counter import FlopCounterMode

    lc, s8 = pipe.vae.latent_channels, size // 8
    ctx = pipe.unet.cross_attention_dim
    img = torch.zeros((1, 3, size, size), device="cuda")
    lat = torch.zeros((1, lc, s8, s8), device="cuda")
    lat2 = torch.zeros((2, pipe.unet.in_channels, s8, s8), device="cuda")
    prompt = torch.zeros((2, 2, ctx), device="cuda")
    stages = {
        "vae encode": (pipe.vae, lambda: pipe.vae.encode(img, eps=lat), (img, lat)),
        "unet": (pipe.unet, lambda: pipe.unet(lat2, torch.ones(1, device="cuda"), prompt),
                 (lat2, prompt)),
        "vae decode": (pipe.vae, lambda: pipe.vae.decode(lat), (lat,)),
    }
    out = {}
    for name, (module, fn, inputs) in stages.items():
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            result = fn()
        flop = fc.get_total_flops()
        moved = nbytes(*module.parameters()) + nbytes(*inputs) + nbytes(result)
        out[name] = (flop, moved) + kernel_bound(moved, 0, flop)
    return out


def diffusion_phase(torch, rc, tt, Config, gts):
    """Phase 12: the diffusion-guided trainer at full width; see the module
    docstring. Returns the launches of K1, K2 and K3 in its counted window."""
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.diffusion.pipeline import TinysplatDiffusionPipeline
    from tinysplat_torch.io.checkpoint import load_model
    from tinysplat_torch.regularizers.diffusion_guidance import FALLBACK_SEED, DiffusionGuidance
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer
    from tinysplat_torch.utils.device import full_f32

    phase_t0 = time.perf_counter()
    card = gpu_name_and_limit()
    torch.cuda.reset_peak_memory_stats()
    cams = orbit_cameras(len(gts), width=WIDTH, height=HEIGHT)
    for cam, gt in zip(cams, gts):
        cam._image = gt.cpu().numpy()
    scene = Scene(cams)
    print(f"phase 12: diffusion-guided training ({card}): the SD v1.5 topology from a "
          f"diffusers directory, {DIFF_STEPS} steps, {N_SPLATS} splats, {HEIGHT}x{WIDTH}, "
          f"{len(cams)} views, refreshes at {DIFF_REFRESHES}, window end "
          f"{DIFF_WINDOW[1]}; then one refresh with the tiny pipeline", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "sd15")
        t0 = time.perf_counter()
        n_params = write_sd15_dir(torch, model_dir)
        write_s = time.perf_counter() - t0
        size_gb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(model_dir)
                      for f in fs) / 1e9
        ckpt = os.path.join(tmp, "bench_scene.npz")
        write_bench_checkpoint(ckpt)
        start = load_model(ckpt, device="cuda")
        noise = np.random.default_rng(7).normal(0.0, 0.1, size=tuple(start.params.colors_dc.shape))
        with torch.no_grad():  # phase 6's start: dimmed opacities, perturbed colours
            live = start.alive[:, None]
            start.params.opacities[:] = torch.where(live, -1.0, start.params.opacities)
            start.params.colors_dc += torch.where(
                live, torch.as_tensor(noise, dtype=torch.float32, device="cuda"), 0.0)
        cfg = Config(background="black", warmup_grad=0, grad_reduce="mxu",
                     regularize_diffusion=True, diffusion_model_dir=model_dir,
                     regularize_diffusion_start=DIFF_WINDOW[0],
                     regularize_diffusion_end=DIFF_WINDOW[1], interval_diffusion=DIFF_INTERVAL,
                     lambda_diffusion=0.5, diffusion_inference_steps=8, diffusion_strength=0.6,
                     max_iter=DIFF_STEPS, **TRAINER_KW)
        tr = Trainer(cfg, scene, start)
        # The trainer builds the guidance at the window's first step; its
        # load (from_pretrained) and each refresh are timed by wrapping the
        # class's methods for the 12 steps, and the load is taken out of the
        # first refresh's seconds.
        load_log, refresh_log, timers = [], [], []
        ensure, refresh = DiffusionGuidance._ensure_pipeline, DiffusionGuidance.refresh

        def timed_ensure(self):
            if self.pipeline is not None:
                return ensure(self)
            t0 = time.perf_counter()
            ensure(self)
            torch.cuda.synchronize()
            load_log.append(time.perf_counter() - t0)
            timers.append(StageTimer(torch, self.pipeline))

        def timed_refresh(self, trainer, real):
            loaded = len(load_log)
            t0 = time.perf_counter()
            out = refresh(self, trainer, real)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0 - sum(load_log[loaded:])
            refresh_log.append((trainer.step, secs, timers[-1].take()))
            return out

        kernels = counted_kernels()
        for k in kernels:
            _build.launches[k] = 0
        step_s, losses, n_cams = [], [], []
        DiffusionGuidance._ensure_pipeline, DiffusionGuidance.refresh = (timed_ensure,
                                                                         timed_refresh)
        try:
            for s in range(1, DIFF_STEPS + 1):
                t0 = time.perf_counter()
                tr.run(s)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(tr.last_metrics["loss"]))
                n_cams.append(len(tr.scene.cameras))
        finally:
            DiffusionGuidance._ensure_pipeline, DiffusionGuidance.refresh = ensure, refresh
        guidance = tr._diffusion_guidance
        pipe = guidance.pipeline
        print(f"  SD v1.5 directory: {n_params} parameters, {size_gb:.3f} GB as float16 "
              f"safetensors, written in {write_s:.2f} s; from_pretrained onto the card "
              f"(float32) at step {DIFF_WINDOW[0]}, by the trainer: {load_log} s; feature "
              f"conditioning "
              f"{'on' if pipe.feature_encoder is not None else 'off (4-channel UNet)'}; "
              f"frames {guidance.size}x{guidance.size}", flush=True)
        if len(load_log) != 1 or pipe.unet.conv_in.weight.device.type != "cuda":
            raise AssertionError(f"the trainer loaded the pipeline {len(load_log)} times")
        synth = list(guidance.cameras)

        # (b) one refresh with the tiny pipeline (diffusion_model_dir empty),
        # on the same trainer and scene: the feature-volume path.
        tiny_cfg = dataclasses.replace(cfg, diffusion_model_dir="")
        tiny = DiffusionGuidance(tiny_cfg, rng_seed=1, device=tr.device)
        captured = []
        refine = tiny.refine

        def capture(*args):
            captured.append(args)
            return refine(*args)

        tiny.refine = capture
        t0 = time.perf_counter()
        tiny_cams = tiny.refresh(tr, tr.scene.cameras)
        torch.cuda.synchronize()
        tiny_s = time.perf_counter() - t0
        launches = {k: _build.launches[k] for k in kernels}
        n_refresh_views = sum(1 for _ in refresh_log) * 2
        # The tiny refresh renders 16 tiles of 16x64 at 128x128: one digit pass.
        want = {"composite_fwd": DIFF_STEPS + n_refresh_views + len(tiny_cams),
                "composite_bwd": DIFF_STEPS, "segsum": DIFF_STEPS,
                "radix": RADIX_PASSES * (DIFF_STEPS + n_refresh_views) + len(tiny_cams)}
        print(f"  launches in the {DIFF_STEPS} steps and the tiny refresh: {launches} "
              f"(K1: {DIFF_STEPS} steps + {n_refresh_views} SD refresh renders + "
              f"{len(tiny_cams)} tiny refresh renders); cameras per step {n_cams}; losses "
              f"{[round(x, 5) for x in losses]}", flush=True)
        check_launches(launches, want, "phase 12")
        if [r[0] for r in refresh_log] != list(DIFF_REFRESHES):
            raise AssertionError(f"refreshes at steps {[r[0] for r in refresh_log]}")
        in_window = [DIFF_WINDOW[0] <= s < DIFF_WINDOW[1] for s in range(1, DIFF_STEPS + 1)]
        if n_cams != [len(cams) + 2 if w else len(cams) for w in in_window]:
            raise AssertionError(f"synthetic cameras per step {n_cams}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite losses {losses}")
        for c in synth + tiny_cams:
            f = c.get_original_image()
            if not (np.isfinite(f).all() and f.min() >= 0.0 and f.max() <= 1.0):
                raise AssertionError(f"frame of {c.name} not finite in [0, 1]")
        stale = {k[0] for k in tr._image_cache} - {c.name for c in tr.scene.cameras}
        if stale:
            raise AssertionError(f"cached frames of removed cameras {stale}")

        bounds = stage_bounds(torch, pipe, guidance.size)
        for step, secs, stages in refresh_log:
            parts = "; ".join(
                f"{k} {len(v)} x median {statistics.median(v):.3f} ms" for k, v in
                stages.items())
            print(f"  refresh at step {step}: {secs:.3f} s for 2 views ({card}); {parts}",
                  flush=True)
        for name, (flop, moved, bound, by) in bounds.items():
            print(f"  {name}: {flop / 1e12:.4f} TFLOP (matmuls and convolutions, from the "
                  f"shapes), {moved / 1e9:.3f} GB of weights and inputs / outputs; bound "
                  f"{bound:.3f} ms by {by} at the float32 peak", flush=True)
        refresh_steps = list(DIFF_REFRESHES)
        plain = [step_s[s - 1] for s in range(2, DIFF_STEPS + 1) if s not in refresh_steps]
        print(f"  host s per step {[round(x, 4) for x in step_s]}: refresh steps "
              f"{[round(step_s[s - 1], 4) for s in refresh_steps]}, median of the others "
              f"{statistics.median(plain):.4f} s; the tiny refresh (latent 16, 128x128, 2 "
              f"views) {tiny_s:.3f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

        # K1 against its plain version on one 512 x 512 refresh render.
        cam = synth[0]
        ti, _, _ = backward_inputs(torch, rc, tr.state, cam.params("cuda"), torch.as_tensor(
            cam.get_original_image(), device="cuda"), int(tr.state.active_sh_degree), tr.cfg,
            {k: getattr(tr.cfg, k) for k in TRAINER_KW})
        compare_kernel(torch, rc, (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx,
                                   ti.sy, ti.tile_x), f"refresh render of {cam.name}, "
                                                      f"{guidance.size}x{guidance.size}")

        # (a) the full-width UNet (batch 1, one timestep) and one VAE decode,
        # the card's modules against copies on the host CPU.
        rng = np.random.default_rng(12)
        s8 = guidance.size // 8
        lat = torch.as_tensor(rng.normal(size=(1, 4, s8, s8)), dtype=torch.float32)
        ctx = torch.as_tensor(rng.normal(size=(1, 2, pipe.unet.cross_attention_dim)),
                              dtype=torch.float32)
        t_step = torch.tensor([601.0])
        unet, vae = pipe.unet, pipe.vae.model
        with torch.no_grad(), full_f32():
            got_u = unet(lat.cuda(), t_step.cuda(), ctx.cuda()).cpu()
            got_d = vae.decode(lat.cuda()).cpu()
            t0 = time.perf_counter()
            ref_u = host_copy(torch, unet)(lat, t_step, ctx)
            ref_d = host_copy(torch, vae).decode(lat)
            host_s = time.perf_counter() - t0
        # The control: the same two forwards on the card with TF32 on.
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.no_grad():
                tf32_u = unet(lat.cuda(), t_step.cuda(), ctx.cuda()).cpu()
                tf32_d = vae.decode(lat.cuda()).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        errs, tf32_errs = ({name: float((g - r).abs().max()) / float(r.abs().max())
                            for name, g, r in (("unet", u, ref_u), ("vae decode", d, ref_d))}
                           for u, d in ((got_u, got_d), (tf32_u, tf32_d)))
        print(f"  full width on the card vs the host CPU (same weights, TF32 off): max |diff| / "
              f"max |CPU| {errs} (tol {SD_CARD_TOL:g}); the host's two forwards "
              f"{host_s:.1f} s; control, the card with TF32 on: {tf32_errs} (over the tol: "
              f"{ {k: v > SD_CARD_TOL for k, v in tf32_errs.items()} })", flush=True)
        if not all(torch.isfinite(x).all() for x in (got_u, got_d)) or max(
                errs.values()) > SD_CARD_TOL:
            raise AssertionError(f"the SD modules on the card disagree with the CPU: {errs}")

    # (b) the whole tiny pipeline on the card against the CPU, the same
    # weights (drawn on the host from the fallback's seed) and injected draws.
    init, cam_tg, cam_in, input_imgs, _ = captured[0]
    cpu_pipe = TinysplatDiffusionPipeline.tiny(
        generator=torch.Generator().manual_seed(FALLBACK_SEED), device="cpu")
    lc, s8 = cpu_pipe.vae.latent_channels, tiny.size // 8
    eps = torch.as_tensor(rng.normal(size=(1, lc, s8, s8)), dtype=torch.float32)
    noise = torch.as_tensor(rng.normal(size=(1, lc, s8, s8)), dtype=torch.float32)
    kw = dict(num_inference_steps=cfg.diffusion_inference_steps,
              strength=cfg.diffusion_strength)
    got = tiny.pipeline(init, cam_tg, cam_in, input_imgs, eps=eps.cuda(), noise=noise.cuda(),
                        **kw).cpu()

    def host(x):
        return dataclasses.replace(x, **{f.name: getattr(x, f.name).cpu()
                                         for f in dataclasses.fields(x)})

    ref = cpu_pipe(init.cpu(), host(cam_tg), host(cam_in), input_imgs.cpu(), eps=eps,
                   noise=noise, **kw)
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"  tiny pipeline ({tiny.size}x{tiny.size}, feature conditioning on) on the card "
          f"vs the CPU: max |diff| / max |CPU| {err:.3e} (tol {TINY_CARD_TOL:g})", flush=True)
    if not torch.isfinite(got).all() or err > TINY_CARD_TOL:
        raise AssertionError("the tiny pipeline on the card disagrees with the CPU")
    print(f"  phase 12: {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return launches


def gt_frame_k1(torch, rc, state, cam, height, width, deg, budgets, label):
    """K1 on one GT frame's tile inputs (the tool's budgets) against its
    plain version on the card and on CPU copies of the same inputs."""
    from tinysplat_torch.render import splat_inputs

    with torch.no_grad():
        s = splat_inputs(state.params, state.alive, cam.params("cuda"), height, width, deg,
                         torch.zeros(3, device="cuda"))
        ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                            s.opacities, s.valid, height, width, tile_x=16, **budgets)
    if ti.bins.dup_overflow or ti.bins.tile_overflow:
        raise AssertionError(f"{label}: the GT frame dropped entries")
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x)
    got = rc.composite_fwd(*args)
    card = rc.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = rc.composite_fwd_plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    host_s = time.perf_counter() - t0
    got_h = got.cpu()
    err = float((got_h[:, 0:5] - host[:, 0:5]).abs().max())
    scaled = float(((got_h[:, 0:5] - host[:, 0:5]).abs()
                    / host[:, 0:5].abs().clamp(min=1.0)).max())
    card_equal, host_equal = same_bytes(torch, got, card), same_bytes(torch, got_h, host)
    print(f"  {label}: K1 on the GT frame ({int(ti.counts.sum())} entries, deepest tile "
          f"{int(ti.counts.max())} of max_per_tile {budgets['max_per_tile']}): bit-equal to the "
          f"plain version on the card {card_equal}, on CPU copies {host_equal} (max |diff| "
          f"{err:.3e}, scaled {scaled:.3e}, tol {KERNEL_TOL:g}; the CPU walk {host_s:.1f} s)",
          flush=True)
    if not card_equal or scaled > KERNEL_TOL:
        raise AssertionError(f"{label}: K1 disagrees with its plain version on a GT frame")


def falls(xs, k=10):
    """The mean of the last k values is below that of the first k."""
    return statistics.mean(xs[-k:]) < statistics.mean(xs[:k])


def run_counted(torch, total, phase, label, fn, want):
    """``fn()`` with K1-K3's launch counters from 0; checks them against
    ``want(result)``, adds them to ``total`` and prints the seconds and the
    peak device memory."""
    kernels = counted_kernels()
    for k in kernels:
        _build.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: _build.launches[k] for k in kernels}
    check_launches(launches, want(out), f"{phase} {label}")
    for name, n in launches.items():
        total[name] += n
    print(f"  {label}: {secs:.1f} s, launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return out


def quality_phase(torch, rc):
    """Phase 13: the quality tools on the card; see the module docstring.
    Returns K1-K3's launches over the tools' runs."""
    import shutil

    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.diffusion.pipeline import TinysplatDiffusionPipeline
    from tinysplat_torch.scripts import (
        diffusion_ab, quality_bench, quality_real, train_1m_probe, train_diffusion_prior)

    phase_t0 = time.perf_counter()
    total = dict.fromkeys(counted_kernels(), 0)
    card = gpu_name_and_limit()
    print(f"phase 13: the quality tools on the card ({card})", flush=True)

    def run(label, fn, want):
        return run_counted(torch, total, "phase 13", label, fn, want)

    def one_pass(want):  # grids under 256 tiles: one digit pass a binning
        return dict(want, radix=want["composite_fwd"])

    saved_tmp = tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp  # quality_bench's checkpoint lands here
        try:
            # (a) the synthetic quality bench at its published shape.
            qb = run("(a) quality_bench", lambda: quality_bench.main(
                QB_ARGS + ["--out", os.path.join(tmp, "quality.json")]),
                # K1: 36 GT views, the steps, 4 eval views at each eval and the
                # last, the train-camera check, GT and model at half scale.
                lambda o: {"composite_fwd": 36 + o["iters"] + 4 * (len(o["eval_history"]) + 1)
                           + 1 + 2 * 4, "composite_bwd": o["iters"], "segsum": 0,
                           "evals": 4 * (len(o["eval_history"]) + 1)})
            hist = qb["eval_history"]
            print(f"  (a) held-out PSNR {qb['value']} dB, SSIM {qb['eval_ssim']}, half scale "
                  f"{qb.get('multiscale_psnr')}; eval history {hist}; steps/s "
                  f"{qb['steps_per_s']}; train minutes {qb['train_minutes']}; "
                  f"{qb['num_splats']} live of {qb['capacity']}; "
                  f"minutes to 27 dB {qb['minutes_to_27dB']}", flush=True)
            if not (hist[-1]["step"] == 1000 and hist[0]["step"] == 250
                    and hist[-1]["psnr"] > hist[0]["psnr"] and np.isfinite(qb["value"])):
                raise AssertionError("quality_bench: held-out PSNR did not rise")
            scene = quality_bench.make_gt_scene()
            gt = quality_bench.make_gt_state(*scene, 3, "cuda")
            cam = orbit_cameras(36, width=1600, height=1056, radius=3.2, fov=0.9)[0]
            gt_frame_k1(torch, rc, gt, cam, 1056, 1600, 3, dict(
                dup_capacity=quality_bench.GT_DUP_CAPACITY, max_per_tile=8192,
                span_capacity=quality_bench.GT_SPAN_CAPACITY), "(a) GT view 0")
            del gt

            # (b) the prior at its default shapes.
            prior_dir = os.path.join(tmp, "prior")
            ph = {}
            run("(b) train_diffusion_prior", lambda: train_diffusion_prior.main(
                PRIOR_ARGS + ["--out-dir", prior_dir], history=ph),
                # 128x128: 64 tiles of 16 px
                lambda o: one_pass({"composite_fwd": 96, "composite_bwd": 0, "segsum": 0}))
            vl, dl = ph["vae_loss"], ph["denoiser_loss"]
            print(f"  (b) GT dropped {sum(ph['gt_dropped'])} over {len(ph['gt_dropped'])} views "
                  f"at 128x128 ({ph['render_s']:.2f} s); VAE {len(vl)} steps, "
                  f"{ph['vae_s'] / len(vl) * 1e3:.2f} ms a step, loss {vl[0]:.5f} -> "
                  f"{statistics.mean(vl[-10:]):.5f} (last 10); denoiser {len(dl)} steps, "
                  f"{ph['denoiser_s'] / len(dl) * 1e3:.2f} ms a step, eps-mse {dl[0]:.4f} -> "
                  f"{statistics.mean(dl[-10:]):.4f} (last 10)", flush=True)
            if any(ph["gt_dropped"]) or not (falls(vl) and falls(dl)):
                raise AssertionError("train_diffusion_prior: dropped GT entries or no fall")
            loaded = TinysplatDiffusionPipeline.load_native(prior_dir, device="cuda")
            for part, mod in ph["pipeline"].parts().items():
                ref = mod.state_dict()
                for key, val in loaded.parts()[part].state_dict().items():
                    if not torch.equal(val, ref[key]):
                        raise AssertionError(f"the prior reloads another {part}.{key}")
            print("  (b) load_native of the written prior: every tensor equal", flush=True)
            s40 = quality_bench.make_gt_scene(n_clusters=40, per_cluster=400)
            n40 = len(s40[0])
            gt = quality_bench.make_gt_state(*s40, 1, "cuda")
            cam = orbit_cameras(96, width=128, height=128, radius=3.2, fov=0.9)[0]
            gt_frame_k1(torch, rc, gt, cam, 128, 128, 1, dict(
                dup_capacity=24 * n40, max_per_tile=16384, span_capacity=10 * n40),
                "(b) GT view 0")
            del gt

            # (c) the A/B with (b)'s prior.
            ah = {}
            ab = run("(c) diffusion_ab", lambda: diffusion_ab.main(
                AB_ARGS + ["--prior-dir", prior_dir, "--out", os.path.join(tmp, "ab.json")],
                # K1: GT, each arm's steps and evals, refresh renders
                history=ah), lambda o: one_pass({
                    "composite_fwd": 12 + 2 * (o["iters"] + o["eval_views"])
                    + len(ah["guided"]._diffusion_guidance.cameras),
                    "composite_bwd": 2 * o["iters"], "segsum": 0,
                    "evals": 2 * o["eval_views"]}))
            synth = ah["guided"]._diffusion_guidance.cameras
            print(f"  (c) plain {ab['plain']}, guided {ab['guided']}: delta {ab['value']} dB; "
                  f"{len(synth)} synthetic views at {synth[0].width}x{synth[0].height} in the "
                  f"one refresh; GT dropped {sum(ah['gt_dropped'])}", flush=True)
            if (not (np.isfinite(ab["plain"]["eval_psnr"]) and np.isfinite(ab["guided"]["eval_psnr"]))
                    or any(ah["gt_dropped"]) or ah["plain"]._diffusion_guidance is not None):
                raise AssertionError("diffusion_ab: a non-finite arm or dropped GT entries")

            # (d) the real-capture bench on a copy of the in-repo capture.
            fixture = os.path.join(HERE, "tests", "fixtures", "real_colmap")
            before = sorted((os.path.relpath(os.path.join(d, f), fixture),
                             os.path.getsize(os.path.join(d, f)))
                            for d, _, files in os.walk(fixture) for f in files)
            scene_dir = os.path.join(tmp, "real_scene")
            shutil.copytree(fixture, scene_dir)
            qr = run("(d) quality_real", lambda: quality_real.main(
                REAL_ARGS + ["--scene-dir", scene_dir, "--out", os.path.join(tmp, "real.json")]),
                lambda o: one_pass({  # 240x180: 48 tiles of 16x64
                    "composite_fwd": o["iters"] + 2 * (len(o["eval_history"]) + 1),
                    "composite_bwd": o["iters"], "segsum": 0,
                    "evals": 2 * (len(o["eval_history"]) + 1)}))
            after = sorted((os.path.relpath(os.path.join(d, f), fixture),
                            os.path.getsize(os.path.join(d, f)))
                           for d, _, files in os.walk(fixture) for f in files)
            print(f"  (d) {qr['views']} real views at {qr['resolution']}: held-out PSNR "
                  f"{qr['value']} dB, SSIM {qr['eval_ssim']}; eval history "
                  f"{qr['eval_history']}; steps/s {qr['steps_per_s']}; {qr['num_splats']} live; "
                  f"depth maps {len(os.listdir(os.path.join(scene_dir, 'depths')))}", flush=True)
            if not np.isfinite(qr["value"]) or after != before:
                raise AssertionError("quality_real: non-finite, or the fixture changed")

            # (e) the Trainer at 1M live splats.
            eh = {}
            pr = run("(e) train_1m_probe", lambda: train_1m_probe.main(
                PROBE_ARGS + ["--out", os.path.join(tmp, "probe.json")], history=eh),
                lambda o: {"composite_fwd": 8 + 2 + o["steps"], "composite_bwd": o["steps"],
                           "segsum": 0, "evals": 2})
            print(f"  (e) {pr['n_splats']} live splats at {pr['resolution']}: {pr['value']} "
                  f"steps/s; PSNR {pr['psnr_start']} -> {pr['psnr_end']}; losses "
                  f"{[round(x, 5) for x in eh['losses']]}; intersections "
                  f"{pr['n_intersections']}, dropped {pr['dup_dropped']} + {pr['tile_dropped']}; "
                  f"tuned budgets {pr['tuned_budgets']}; GT dropped {pr['gt_dropped']}",
                  flush=True)
            if pr["gt_dropped"] or not np.isfinite(eh["losses"]).all():
                raise AssertionError("train_1m_probe: GT entries dropped or a non-finite loss")
        finally:
            tempfile.tempdir = saved_tmp
    print(f"  phase 13: launches {total}; {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return total


def sweep_launches(lines, label, grads, k3):
    """K1-K3 of a sweep of ``grads`` gradients a config, ``k3`` of them
    through K3 and ``grads`` through ``scatter_rows`` for each "scatter"
    config; raises first on a line with an error or one that claims ``tpb``
    was read."""
    for line in lines:
        if "error" in line or line.get("tiles_per_block_read") is not False:
            raise AssertionError(f"{label}: {line}")
    scatter = sum(line["config"].split(":")[0] == "scatter" for line in lines)
    return {"composite_fwd": grads * len(lines), "composite_bwd": grads * len(lines),
            "segsum": k3, "ssim": 0, "scatter_rows": grads * scatter}


def scaling_model_launches(o):
    """K1-K3 of ``scaling_model.main`` at ``SM_ARGS``: the plain and the
    (1, 1) sharded step (one warm-up + --iters each), the full-frame probe,
    and per band count t the drop probe and gradient (2 warm-up + max(iters
    // 2, 8)) of each offset, the band's sharded step and its plain band
    gradient (2 warm-up + --iters)."""
    from tinysplat_torch.scripts import scaling_model

    from tinysplat_torch.ops.binning_cuda import radix_passes

    it, (H, W) = int(SM_ARGS[SM_ARGS.index("--iters") + 1]), o["resolution"]
    bands = [t for t in scaling_model.BANDS if (H // 16) % t == 0]
    k2 = 2 * (1 + it) + sum(t * (2 + max(it // 2, 8)) + (1 + it) + (2 + it) for t in bands)
    # Digit passes: render's 16x16 tiles (the probes and gradients), the
    # steps' 16x64 (Config's tile_x), each at its band's height.
    p16 = lambda h: radix_passes((W // 16) * (h // 16))  # noqa: E731
    p64 = lambda h: radix_passes(-(-W // 64) * (h // 16))  # noqa: E731
    radix = 2 * (1 + it) * p64(H) + p16(H) + sum(
        t * (3 + max(it // 2, 8)) * p16(H // t) + (1 + it) * p64(H // t) + (2 + it) * p16(H // t)
        for t in bands)
    # SSIM: the steps alone (plain, (1, 1) sharded, each band's sharded).
    return {"composite_fwd": k2 + 1 + sum(bands), "composite_bwd": k2, "segsum": 0,
            "radix": radix, "ssim": (2 + len(bands)) * (1 + it)}


def tools_phase(torch):
    """Phase 14: the profiling, sweep and scaling tools on the card; see the
    module docstring. Returns K1-K3's launches over the tools' runs, the
    ranks of scaling_bench included."""
    from tinysplat_torch.scripts import (
        profile_bench, profile_train_step, scaling_bench, scaling_model, sweep_bench)

    phase_t0 = time.perf_counter()
    total = dict.fromkeys(counted_kernels(), 0)
    print(f"phase 14: the profiling, sweep and scaling tools on the card "
          f"({gpu_name_and_limit()})", flush=True)

    def run(label, fn, want):
        return run_counted(torch, total, "phase 14", label, fn, want)

    def fwd_bwd(n, k3=0):
        return {"composite_fwd": n, "composite_bwd": n, "segsum": k3}

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the bench scene's render gradient (no loss): warm-up + 3 under
        # the profiler.
        pb = run("(a) profile_bench", lambda: profile_bench.main(
            ["--logdir", os.path.join(tmp, "pb")]), lambda o: dict(fwd_bwd(4), ssim=0))
        ops = [op for op, _, _ in pb["rows"]]
        share = pb["kernel_busy_share"]
        print(f"  (a) binning at profile_bench's budgets: {pb['binning']}; kernel-busy share "
              f"{share}; {pb['line']} total {pb['total_ms_per_iter']:.4f} ms an iteration",
              flush=True)
        if not (any(K1_NAME in op for op in ops) and any(K2_NAME in op for op in ops)):
            raise AssertionError(f"profile_bench's table does not name K1 and K2: {ops}")
        if share is None or not 0.0 < share <= 1.0:
            raise AssertionError(f"profile_bench's kernel-busy share {share}")

        # (b) the bare train step: warm-up + 3 under the profiler.
        ts = run("(b) profile_train_step", lambda: profile_train_step.main(
            ["--logdir", os.path.join(tmp, "ts")]), lambda o: fwd_bwd(4))
        print(f"  (b) the step: {ts['line']} total {ts['total_ms_per_iter']:.4f} ms a step, "
              f"kernel-busy share {ts['kernel_busy_share']}; top 15 (op, ms a step, count): "
              f"{[(op[:70], round(ms, 4), n) for op, ms, n in ts['rows'][:15]]}", flush=True)
        if not (ts["kernel_busy_share"] and np.isfinite(ts["loss"])):
            raise AssertionError("profile_train_step: no device trace or a non-finite loss")

        # (c) JAX's three configs + "mxu" at 64-px tiles; each config runs
        # 1 + warmup 3 + iters 12 gradients (K3 only under "mxu"), then one
        # gradient each with --diag.
        sweep = run("(c) sweep_bench", lambda: sweep_bench.main(["--configs", *SWEEP_CONFIGS]),
                    lambda o: sweep_launches(o, "sweep_bench", 16, 16))
        diag = run("(c) sweep_bench --diag", lambda: sweep_bench.main(
            ["--configs", *SWEEP_CONFIGS, "--diag"]),
            lambda o: sweep_launches(o, "sweep_bench --diag", 1, 1))
        for line, d in zip(sweep, diag):
            print(f"  (c) {line['config']}: {line['ms_per_iter']} ms an iteration, "
                  f"{line['msplats_s']} Msplats/s; binning {d['diag']}", flush=True)

        # (d) band spread + 8 ranks sharing the card vs a 1-rank world.
        hist = {}
        # Part 1 bins only (two bands of 16x16 tiles a camera and band), and
        # its steps run in the ranks (16x64 tiles, a band of 1 / N_TILE of
        # the image on the mesh's ranks, the whole image in the 1-rank world).
        from tinysplat_torch.ops.binning_cuda import radix_passes

        def sb_part1(o):
            (h, w), cams = o["resolution"], len(hist["band_counts"])
            bins = cams * scaling_bench.N_TILE * 2
            return dict(fwd_bwd(0), bins=bins, radix=bins * radix_passes(
                (w // 16) * (h // scaling_bench.N_TILE // 16)))

        sb = run("(d) scaling_bench", lambda: scaling_bench.main(
            ["--out", os.path.join(tmp, "scaling.json")], history=hist), sb_part1)
        ranks = hist["ranks"] + hist["ranks_1"]
        (sb_h, sb_w), steps = sb["resolution"], 1 + scaling_bench.STEP_ITERS
        for r in ranks:
            band = sb_h // (scaling_bench.N_TILE if r in hist["ranks"] else 1)
            check_launches(r["launches"], dict(fwd_bwd(steps), radix=steps * radix_passes(
                -(-sb_w // 64) * (band // 16))),
                f"phase 14 (d) rank {r['rank']} of {len(hist['ranks'])}")
            for name, n in r["launches"].items():
                total[name] += n
        with open(os.path.join(HERE, "SCALING_r03.json")) as f:
            ref = json.load(f)
        keys = [k for k in ref if k.startswith("band_")]
        print(f"  (d) {json.dumps(sb)}", flush=True)
        print(f"  (d) band counts here {[sb[k] for k in keys]} beside SCALING_r03.json's (a CPU "
              f"run of older JAX code, for context) {[ref[k] for k in keys]} ({keys}); per "
              f"camera (contiguous, interleaved) {hist['band_counts']}; step ms by rank "
              f"{[round(r['ms'], 1) for r in hist['ranks']]}, 1-rank world "
              f"{round(hist['ranks_1'][0]['ms'], 1)}", flush=True)

        # (e) the scaling model at its widths.
        hist = {}
        sm = run("(e) scaling_model", lambda: scaling_model.main(
            SM_ARGS + ["--out", os.path.join(tmp, "model.json")], history=hist),
            scaling_model_launches)
        if any(d for per_off in hist["drops"].values() for d in per_off):
            raise AssertionError(f"scaling_model: a band dropped entries {hist['drops']}")
        offsets = {t: len(d) for t, d in hist["drops"].items()}
        print(f"  (e) {sm['n_splats']} splats, {sm['intersections_full_frame']} intersections "
              f"at {sm['resolution']}; no band dropped an entry (offsets by t {offsets}); "
              f"measured_on_chip {json.dumps(sm['measured_on_chip'])}", flush=True)
        print(f"  (e) link {sm['link']}; value {sm['value']}; predicted "
              f"{json.dumps(sm['predicted'])}", flush=True)
    print(f"  phase 14: launches {total}; {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return total


def bench_lines(out, keys, label):
    """The headline and final JSON lines that end a bench run's ``out``,
    checked against ``keys``; raises unless they are its last two lines."""
    lines = out.strip().splitlines()
    headline, final = (json.loads(s) for s in lines[-2:])
    if set(final) != keys or set(headline) != keys - BENCH_TRAIN_KEYS:
        raise AssertionError(f"{label}: the bench's lines carry other keys: {lines[-2:]}")
    if any(headline[k] != final[k] for k in headline):
        raise AssertionError(f"{label}: the final line does not repeat the headline")
    nums = [final[k] for k in ("value", "vs_baseline", *sorted(BENCH_TRAIN_KEYS))]
    if not all(np.isfinite(x) and x > 0 for x in nums):
        raise AssertionError(f"{label}: a number is not finite and positive: {final}")
    return headline, final


def bench_phase(torch):
    """Phase 15: the headline bench on the card; see the module docstring.
    Returns K1-K3's launches over the bench's in-process runs."""
    import contextlib
    import io

    from tinysplat_torch.scripts import bench

    phase_t0 = time.perf_counter()
    total = dict.fromkeys(counted_kernels(), 0)
    print(f"phase 15: the headline bench on the card ({gpu_name_and_limit()})", flush=True)
    with open(os.path.join(HERE, "BENCH_r05.json")) as f:
        tpu = json.load(f)["parsed"]
    keys = set(tpu)
    iters = bench.arg_parser().get_default("iters")
    steps = 1 + max(iters // 2, 5)  # the train steps, each with its SSIM loss
    per_run = bench.WARMUP + iters + steps  # render gradients + train steps
    for label, argv in BENCH_RUNS:
        hist, buf = {}, io.StringIO()

        def run_bench():
            with contextlib.redirect_stdout(buf):
                return bench.main(argv, history=hist)

        record = run_counted(torch, total, "phase 15", f"(a) bench {label}", run_bench,
                             lambda o: {"composite_fwd": per_run, "composite_bwd": per_run,
                                        "segsum": per_run if label == "mxu" else 0,
                                        "ssim": steps})
        for line in buf.getvalue().strip().splitlines():
            print(f"    | {line}", flush=True)
        _, final = bench_lines(buf.getvalue(), keys, f"phase 15 {label}")
        if final != record:
            raise AssertionError(f"phase 15 {label}: main returned another record")
        mem = hist["memory"]
        slack = mem["large_blocks"] * LARGE_BLOCK_SLACK
        dropped = {k: v for k, v in {**hist["binning"], **hist["train_binning"]}.items()
                   if "dropped" in k}
        print(f"  (a) {label}: {final['value']} Msplats/s, train step {final['train_step_ms']} "
              f"ms, {final['rays_per_s']} rays/s; dropped {dropped}; device memory {mem} "
              f"(peak growth {mem['run_peak'] - mem['first_peak']} bytes, slack {slack})",
              flush=True)
        if any(dropped.values()):
            raise AssertionError(f"phase 15 {label}: the bench dropped entries {dropped}")
        if (mem["rest_after"] != mem["rest_before"]
                or mem["run_peak"] > mem["first_peak"] + slack):
            raise AssertionError(f"phase 15 {label}: device memory grew over the gradients")
    print(f"  (a) for context only, BENCH_r05.json (the JAX package on a TPU v5e): "
          f"{tpu['value']} Msplats/s, train step {tpu['train_step_ms']} ms", flush=True)

    # (b) the CLI alone, in a process of its own.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tinysplat_torch.scripts.bench",
                           "--headline-only"], cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 15: the bench CLI failed (exit {proc.returncode}): "
                             f"{proc.stderr[-2000:]}")
    headline = json.loads(lines[-1])
    if set(headline) != keys - BENCH_TRAIN_KEYS or not headline["value"] > 0:
        raise AssertionError(f"phase 15: the CLI's headline is {lines[-1]}")
    print(f"  (b) python -m tinysplat_torch.scripts.bench --headline-only: "
          f"{time.perf_counter() - t0:.1f} s; {lines}", flush=True)
    print(f"  phase 15: launches {total}; {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return total


def full_budgets(rc, s, radii, tile_size, tile_x):
    """Binning budgets of (tile_size, tile_x) tiles of a full-width frame
    that hold every entry of the projected splats ``s`` (with ``radii``)
    with TILE_HEADROOM to spare, from one binning at caps that drop
    nothing: (budgets, intersections, the deepest tile's entries)."""
    tx = tile_x or tile_size
    n = s.xys.shape[0]
    bins = rc.bin_splats_dense(s.xys, s.proj.depths, radii, s.valid, -(-WIDTH // tx),
                               -(-HEIGHT // tile_size), tile_size, dup_capacity=32 * n,
                               span_capacity=32 * n, max_per_tile=1 << 20,
                               conics=s.proj.conics, opacities=s.opacities, tile_size_x=tx)
    if bins.dup_overflow or bins.tile_overflow:
        raise AssertionError(f"{tile_size}x{tx} tiles: the sizing caps dropped entries")
    total, deepest = int(bins.total_intersections), int(bins.counts.max())
    dup = -(-int(total * TILE_HEADROOM) // 1024) * 1024
    return (dict(dup_capacity=dup, span_capacity=dup,
                 max_per_tile=-(-int(deepest * TILE_HEADROOM) // 128) * 128), total, deepest)


def k1_at(torch, rc, ti, label):
    """K1 against its plain version at ``ti`` (bit for bit), timed, with
    its counters and bound: (K1 output, {ms, plain_ms, bound_ms, bound_by,
    pairs})."""
    from tinysplat_torch.probes import timed_ms

    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x,
            ti.tile_h)
    out = rc.composite_fwd(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    ref = rc.composite_fwd_plain(*args)
    end.record()
    end.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"K1 is not bit-equal to its plain version at {label}: max "
                             f"diff {float((out - ref).abs().max()):.3e}")
    ms = timed_ms(lambda: rc.composite_fwd(*args), 20, device_only=True)
    pairs = print_counts(rc, ti, out, label)["pairs"]["k1_box"]
    bound, by = kernel_bound(nbytes(*args[:6]), nbytes(out), pairs * FLOP_PER_PAIR)
    return out, dict(ms=ms, plain_ms=start.elapsed_time(end), bound_ms=bound, bound_by=by,
                     pairs=pairs)


def tile_heights_phase(torch, rc, tt, Config, state, deg, bg, cam, frame16, views, gts,
                       ms16):
    """Phase 16: tile heights other than 16 px; see the module docstring.
    ``frame16``: phase 4's (rgb, alpha) at ``cam`` (16 x 64 tiles);
    ``ms16``: K1's and K2's ms there and at phase 6's step 0. Returns K1-K3's
    launches in the counted windows."""
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.probes import timed_ms
    from tinysplat_torch.render import render, splat_inputs
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    phase_t0 = time.perf_counter()
    kernels = counted_kernels()
    total = dict.fromkeys(kernels, 0)
    print(f"phase 16: tile heights, {N_SPLATS} splats, {HEIGHT}x{WIDTH} "
          f"({gpu_name_and_limit()})", flush=True)
    with torch.no_grad():
        s = splat_inputs(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg)
    budgets = {}
    for ts, tx in TILE_SHAPES:
        budgets[ts, tx], inter, deepest = full_budgets(rc, s, s.proj.radii, ts, tx)
        print(f"  {ts}x{tx or ts} tiles: {inter} intersections, the deepest tile {deepest}; "
              f"budgets {budgets[ts, tx]}", flush=True)

    # (a) One frame through render() at each tile shape, counted.
    for k in kernels:
        _build.launches[k] = 0
    with torch.no_grad():
        frames = {shape: render(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg,
                                tile_size=shape[0], tile_x=shape[1], **budgets[shape])
                  for shape in TILE_SHAPES}
    got = {k: _build.launches[k] for k in kernels}
    want = {"composite_fwd": len(TILE_SHAPES), "composite_bwd": 0, "segsum": 0}
    check_launches(got, want, "phase 16 (a) frames")
    total = {k: total[k] + got[k] for k in total}
    rgb16, alpha16 = frame16
    for (ts, tx), (rgb, ex) in frames.items():
        diag = ex["binning"]
        if diag["dup_dropped"] or diag["tile_dropped"]:
            raise AssertionError(f"{ts}x{tx or ts} frame dropped entries: {diag}")
        if rgb.shape != (HEIGHT, WIDTH, 3) or not torch.isfinite(rgb).all():
            raise AssertionError(f"{ts}x{tx or ts} frame: bad rgb {tuple(rgb.shape)}")
        diff = torch.maximum((rgb - rgb16).abs().amax(dim=-1), (ex["alpha"] - alpha16).abs())
        print(f"  (a) {ts}x{tx or ts} frame through render(): {diag['intersections']} "
              f"intersections, none dropped; against the 16x64 frame max |diff| "
              f"{float(diff.max()):.3e} at {int((diff > FRAME_TOL).sum())} of {diff.numel()} "
              f"pixels past {FRAME_TOL:g}", flush=True)
    # The cause of any difference: render() bins each splat into the tiles
    # its 3-sigma radius box touches, and alpha stays >= 1/255 out to 3.33
    # sigma, so the tile edges decide which pixels past the box a splat
    # reaches. With radii that hold the whole alpha support, every pixel
    # composites the same splats in the same depth order at every tile
    # shape: the frames must agree (bit for bit, expected).
    wide = torch.where(s.proj.radii > 0, torch.ceil(s.proj.radii * 3.5 / 3.0).int() + 1,
                       s.proj.radii)
    full = {}
    for ts, tx in ((16, 64),) + TILE_SHAPES:
        b = full_budgets(rc, s, wide, ts, tx)[0]
        full[ts, tx] = rc.rasterize_cuda(s.xys, s.proj.depths, wide, s.proj.conics, s.colors4,
                                         s.opacities, s.valid, HEIGHT, WIDTH, s.bg4,
                                         tile_size=ts, tile_x=tx, **b)
    for shape in TILE_SHAPES:
        err = max(float((full[shape][0] - full[16, 64][0]).abs().max()),
                  float((full[shape][1] - full[16, 64][1]).abs().max()))
        print(f"  (a) radii over the whole alpha support, {shape[0]}x{shape[1] or shape[0]} "
              f"against 16x64: max |diff| {err:.3e} (tol {FRAME_TOL:g})", flush=True)
        if err > FRAME_TOL:
            raise AssertionError(f"phase 16: {shape} tiles composite other splats than 16x64")

    # K1 at each frame's shapes: bit-equal to its plain version, timed.
    k1 = {}
    for ts, tx in TILE_SHAPES:
        ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                            s.opacities, s.valid, HEIGHT, WIDTH, tile_x=tx or ts, tile_h=ts,
                            **budgets[ts, tx])
        out, k1[ts, tx] = k1_at(torch, rc, ti, f"the {ts}x{tx or ts} frame")
        img, alpha = rc.untile(out, s.bg4, ti.tiles_x, ti.tiles_y, ti.tile_x, HEIGHT, WIDTH,
                               ti.tile_h)
        rgb, ex = frames[ts, tx]
        if not (torch.equal(torch.minimum(img[..., :3], img.new_ones(())), rgb)
                and torch.equal(alpha, ex["alpha"])):
            raise AssertionError(f"phase 16: the {ts}x{tx} frame is not K1's output")

    # (b) Trainer runs at 32 px ("mxu") and 8 px ("scatter") from phase 6's
    # start (in its 262,144 slots, as phase 11 starts).
    cams = orbit_cameras(TRAIN_VIEWS, width=WIDTH, height=HEIGHT)
    for c, gt in zip(cams, gts):
        c._image = gt.cpu().numpy()
    scene = Scene(cams)
    for ts, reduce in TILE_TRAIN:
        start = shard_start(torch, "cuda")
        b = {}
        for v in views:  # budgets that hold every view's entries at the start
            with torch.no_grad():
                sv = splat_inputs(start.params, start.alive, v, HEIGHT, WIDTH, 1, bg)
            for key, val in full_budgets(rc, sv, sv.proj.radii, ts, 0)[0].items():
                b[key] = max(b.get(key, 0), val)
        cfg = Config(background="black", warmup_grad=0, grad_reduce=reduce, tile_size=ts,
                     tile_x=0, max_iter=TILE_STEPS, **b)
        tr = Trainer(cfg, scene, start)
        before = objective(torch, tt, tr, cams)
        for k in kernels:
            _build.launches[k] = 0
        losses, drops = [], []
        for step in range(1, TILE_STEPS + 1):
            tr.run(step)
            m = tr.last_metrics
            losses.append(float(m["loss"]))
            drops.append(int(m["n_dup_dropped"]) + int(m["n_tile_dropped"]))
        torch.cuda.synchronize()
        got = {k: _build.launches[k] for k in kernels}
        total = {k: total[k] + got[k] for k in total}
        after = objective(torch, tt, tr, cams)
        print(f"  (b) Trainer at {ts}x{ts} tiles, {reduce}, budgets {b}: launches {got}; "
              f"losses {[round(x, 5) for x in losses]}; dropped {drops}; the objective over "
              f"the {len(cams)} views {before:.5f} -> {after:.5f}", flush=True)
        check_launches(got, {"composite_fwd": TILE_STEPS, "composite_bwd": TILE_STEPS,
                             "segsum": TILE_STEPS if reduce == "mxu" else 0},
                       f"phase 16 (b) {ts} px")
        if any(drops) or not all(np.isfinite(losses)) or not after < before:
            raise AssertionError(f"phase 16 (b) {ts} px: drops, a non-finite loss or no fall")

    # (c) K2 (and K3, under every reduction) against the plain versions at
    # step 0's shapes of each tile shape; (e) K2 timed beside its bound.
    start = shard_start(torch, "cuda")
    base = Config(background="black", warmup_grad=0)
    with torch.no_grad():
        sv = splat_inputs(start.params, start.alive, views[0], HEIGHT, WIDTH, 1, bg)
    k2 = {}
    for ts, tx in TILE_SHAPES:
        b = full_budgets(rc, sv, sv.proj.radii, ts, tx)[0]
        ti, out, gout = backward_inputs(torch, rc, start, views[0], gts[0], 1, base,
                                        dict(b, tile_x=tx or ts, tile_h=ts))
        label = f"step 0 at {ts}x{tx or ts} tiles"
        err, rows = compare_backward(torch, rc, ti, out, gout, label)
        bargs = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, out, gout,
                 ti.tile_x, ti.tile_h)
        ms = timed_ms(lambda: rc.composite_bwd(*bargs), 20, device_only=True)
        plain_ms = timed_ms(lambda: rc.composite_bwd_plain(*bargs), 1, device_only=True)
        counts = print_counts(rc, ti, out, label)
        bound, by = kernel_bound(nbytes(*bargs[:6], out[:, 4:7], gout[:, 0:5]), nbytes(rows),
                                 k2_slots(counts), SLOTS_PER_S)
        subs = rc.subtiles_per_tile(ti.tile_x, ti.tile_h)
        k2[ts, tx] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, err=err,
                          subs=subs)
    # (e) the times beside their bounds and the 16-px times.
    for ts, tx in TILE_SHAPES:
        a, c = k1[ts, tx], k2[ts, tx]
        print(f"  (e) {ts}x{tx or ts} tiles ({c['subs']} sub-tile blocks a tile): K1 "
              f"{a['ms']:.4f} ms (16x64: {ms16['k1']:.4f}), bound {a['bound_ms']:.4f} ms by "
              f"{a['bound_by']} ({a['bound_ms'] / a['ms']:.1%}), plain {a['plain_ms']:.1f} ms; "
              f"K2 {c['ms']:.4f} ms (16x64: {ms16['k2']:.4f}), bound {c['bound_ms']:.4f} ms "
              f"by {c['bound_by']} ({c['bound_ms'] / c['ms']:.1%}), plain {c['plain_ms']:.1f} "
              f"ms, max|K2-plain| {c['err']:.3e}", flush=True)
    print(f"  phase 16: launches {total}; {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return total


def pad_params(torch, params, alive, capacity):
    """``params`` and ``alive`` padded with dead slots (the port's sentinels:
    identity quats, scales -10, opacity logits -20, zeros) to ``capacity``."""
    from tinysplat_torch.models.gaussians import GaussianParams

    extra = capacity - params.means.shape[0]
    fill = {"scales": -10.0, "opacities": -20.0}
    fields = {}
    for name, t in params.fields():
        pad = t.new_full((extra,) + tuple(t.shape[1:]), fill.get(name, 0.0))
        if name == "quats":
            pad[:, 0] = 1.0
        fields[name] = torch.cat([t.detach(), pad])
    return GaussianParams(**fields), torch.cat([alive, alive.new_zeros(extra)])


def splat_phase(torch, rc, tt, state, cam, train, opt, views, gts, cfg):
    """Phase 17: see the module docstring. Returns S1's and S2's rows of the
    kernels' JSON line (without launches) and the launches of (d)'s counted
    run through the kernels."""
    from tinysplat_torch.ops import splat_inputs_cuda as si
    from tinysplat_torch.probes import timed_ms
    from tinysplat_torch.render import render, splat_inputs

    render_mod = sys.modules["tinysplat_torch.render"]  # the attribute is the function
    phase_t0 = time.perf_counter()
    print(f"phase 17: the splat-input kernels S1 and S2 ({gpu_name_and_limit()}), "
          f"{N_SPLATS} splats in {state.capacity} slots at {HEIGHT}x{WIDTH}, and in "
          f"{SPLAT_CAPACITY} slots", flush=True)
    big, big_alive = pad_params(torch, state.params, state.alive, SPLAT_CAPACITY)
    full = cam.projmat @ cam.viewmat
    bg = torch.zeros(3, device="cuda")

    def fwd_args(params, alive):
        return (params.means, params.scales, params.quats, params.colors_dc,
                params.colors_rest, params.opacities, alive, cam.viewmat, full, cam.cam_pos,
                cam.fx, cam.fy, cam.cx_off, cam.cy_off)

    # (a) S1 against its plain version.
    s1_err = None
    cases = [(state.params, state.alive, *c) for c in SPLAT_COMBOS]
    cases.append((big, big_alive, 3, False, "reference"))
    for params, alive, deg, aa, mode in cases:
        layout = si.SplatLayout(WIDTH, HEIGHT, 16, mode, aa)
        with torch.no_grad():
            got = si.splat_fwd(*fwd_args(params, alive), deg, layout)
            ref = si.splat_fwd_plain(*fwd_args(params, alive), deg, layout)
        torch.cuda.synchronize()
        rep = si.forward_mismatch(got, ref, layout.tile_size)
        floats = "; ".join(
            f"{k} {rep[k]['max_abs']:.3e} ({rep[k]['scaled']:.2e} of max"
            f"{', bit-equal' if rep[k]['bit_equal'] else ''})" for k in si.FLOAT_OUTPUTS)
        print(f"  (a) S1 vs plain, {params.means.shape[0]} slots, degree {deg}, antialiased "
              f"{aa}, {mode}: {floats}; radii differ at {rep['radii']['differ']} splats "
              f"({rep['radii']['off_boundary']} off a ceil boundary), tile counts at "
              f"{rep['num_tiles_hit']['differ']} ({rep['num_tiles_hit']['off_boundary']} off "
              f"a boundary); valid equal {rep['valid_equal']}", flush=True)
        if not rep["ok"]:
            raise AssertionError(f"phase 17: S1 disagrees with its plain version: {rep}")
        if params is state.params and (deg, aa, mode) == (3, False, "reference"):
            s1_err = max(rep[k]["max_abs"] for k in si.FLOAT_OUTPUTS)

    # (b) S2 against its plain version and autograd, with pose_opt's camera
    # gradients, twice the same bytes.
    rng = np.random.default_rng(17)
    s2_err = None
    for params, alive, aa, mode in ((state.params, state.alive, False, "reference"),
                                    (state.params, state.alive, True, "position"),
                                    (big, big_alive, False, "reference")):
        n = params.means.shape[0]
        layout = si.SplatLayout(WIDTH, HEIGHT, 16, mode, aa)
        cot = [torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
               for shape in ((n, 2), (n,), (n, 3), (n, 4), (n,))]
        ins = [t.detach() for t in fwd_args(params, alive)]
        bargs = (*ins[:6], *ins[7:12], 3, layout, *cot, True)
        got, again = si.splat_bwd(*bargs), si.splat_bwd(*bargs)
        ref = si.splat_bwd_plain(*bargs)
        leaves = [t.clone().requires_grad_() for t in ins[:6] + ins[7:10]]
        out = si.splat_fwd_plain(*leaves[:6], alive, *leaves[6:], *ins[10:14], 3, layout)
        loss = sum((getattr(out, k) * c).sum() for k, c in zip(si.FLOAT_OUTPUTS, cot))
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g_pos = g[8] if g[8] is not None else torch.zeros(3, device="cuda")
        auto = (*g[:6], torch.cat([g[6][:3].reshape(-1), g[7].reshape(-1), g_pos]))
        torch.cuda.synchronize()
        same = all(same_bytes(torch, a, b) for a, b in zip(got, again))
        rep_p, rep_a = si.backward_mismatch(got, ref), si.backward_mismatch(got, auto)
        fmt = lambda r: {k: float(f"{v[1]:.2e}") for k, v in r.items() if k != "ok"}
        print(f"  (b) S2, {n} slots, antialiased {aa}, {mode}: twice the same bytes {same}; "
              f"vs plain, over the column max {fmt(rep_p)}; vs autograd {fmt(rep_a)}",
              flush=True)
        if not (same and rep_p["ok"] and rep_a["ok"]):
            raise AssertionError(f"phase 17: S2 disagrees (same bytes {same}): plain {rep_p}, "
                                 f"autograd {rep_a}")
        if s2_err is None:
            s2_err = max(v[0] for k, v in rep_p.items() if k != "ok")
        del leaves, out, g

    # (c) device times at the main path's shapes against their bounds.
    layout = si.SplatLayout(WIDTH, HEIGHT, 16)
    deg = state.active_sh_degree
    args = fwd_args(state.params, state.alive)
    with torch.no_grad():
        s1_ms = timed_ms(lambda: si.splat_fwd(*args, deg, layout), 20, device_only=True)
        s1_plain = timed_ms(lambda: si.splat_fwd_plain(*args, deg, layout), 5, device_only=True)
    ins, n = [t.detach() for t in args], state.capacity
    cot = [torch.ones(shape, device="cuda") for shape in ((n, 2), (n,), (n, 3), (n, 4), (n,))]
    bargs = (*ins[:6], *ins[7:12], deg, layout, *cot)
    s2_ms = timed_ms(lambda: si.splat_bwd(*bargs, False), 20, device_only=True)
    s2_cam_ms = timed_ms(lambda: si.splat_bwd(*bargs, True), 20, device_only=True)
    s2_plain = timed_ms(lambda: si.splat_bwd_plain(*bargs, False), 3, device_only=True)
    kb = state.params.colors_rest.shape[1] + 1
    for k in (1, 4, 9, 16, 25):
        occ = si.bwd_occupancy(k)
        print(f"  (c) splat_bwd at {k} SH bases: {occ['registers']} registers and "
              f"{occ['local_bytes']} local (spill) bytes a thread, {occ['smem_bytes']} B of "
              f"shared memory a block of {occ['threads']}, {occ['blocks_per_sm']} blocks "
              f"resident an SM", flush=True)
        if k == kb:
            s2_occ = occ
    rows = {}
    for name, ms, plain, nbytes_, flop, extra in (
            ("splat_fwd", s1_ms, s1_plain, si.layer_bytes(n, kb)[0], SPLAT_FWD_FLOP, ""),
            ("splat_bwd", s2_ms, s2_plain, si.layer_bytes(n, kb)[1], SPLAT_BWD_FLOP,
             f"; with pose_opt's camera gradient {s2_cam_ms:.4f} ms")):
        bytes_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
        ops_ms = n * flop / FP32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        print(f"  (c) {name}: {ms:.4f} ms (median of 20, device time){extra}; plain version "
              f"{plain:.3f} ms; bound {bound:.4f} ms by "
              f"{'bytes' if bytes_ms >= ops_ms else 'operations'} ({nbytes_} bytes -> "
              f"{bytes_ms:.4f} ms; {n} slots x {flop} FLOP -> {ops_ms:.4f} ms), "
              f"{bound / ms:.1%} of it", flush=True)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    rows["splat_fwd"]["max_abs_err"], rows["splat_bwd"]["max_abs_err"] = s1_err, s2_err
    rows["splat_bwd"].update(cam_ms=s2_cam_ms, registers=s2_occ["registers"],
                             spill_bytes=s2_occ["local_bytes"],
                             smem_bytes=s2_occ["smem_bytes"],
                             blocks_per_sm=s2_occ["blocks_per_sm"])

    # (d) the layer, a frame and a bare step, through the kernels and the
    # plain way (splat_inputs' Function swapped for the plain forward under
    # autograd), in turns: kernels, plain, plain, kernels.
    kernels = counted_kernels()
    step_fn = tt.make_train_step(cfg, HEIGHT, WIDTH)

    def one_way(label, step):
        layer = timed_ms(lambda: splat_inputs(state.params, state.alive, cam, HEIGHT, WIDTH,
                                              deg, bg), SPLAT_REPS)
        frames = []
        for _ in range(SPLAT_REPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            with torch.no_grad():
                render(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg, **RENDER_KW)
            end.record()
            end.synchronize()
            frames.append(start.elapsed_time(end))
        nonlocal train
        train, log = train_steps(torch, step_fn, train, opt, views, gts, step, SPLAT_REPS)
        check_steps(torch, log, f"phase 17 {label}")
        step_ms = statistics.median(ms for _, ms, _, _ in log)
        print(f"  (d) {label}: splat_inputs layer {layer:.3f} ms, frame median "
              f"{statistics.median(frames):.3f} ms, bare step median {step_ms:.3f} ms "
              f"(CUDA events, {SPLAT_REPS} each)", flush=True)
        return step_ms

    fused = render_mod.fused_splat_inputs
    launches, step_ms = None, {}
    for i, way in enumerate(("kernels", "plain", "plain", "kernels")):
        render_mod.fused_splat_inputs = fused if way == "kernels" else si.splat_fwd_plain
        for k in kernels:
            _build.launches[k] = 0
        try:
            step_ms.setdefault(way, []).append(one_way(f"{way} ({i + 1} of 4)", 100 + 10 * i))
        finally:
            render_mod.fused_splat_inputs = fused
        got = {k: _build.launches[k] for k in kernels}
        want = {"composite_fwd": 2 * SPLAT_REPS, "composite_bwd": SPLAT_REPS, "segsum": 0,
                "splat_fwd": 3 * SPLAT_REPS if way == "kernels" else 0,
                "splat_bwd": SPLAT_REPS if way == "kernels" else 0}
        check_launches(got, want, f"phase 17 (d) {way}")
        if launches is None:
            launches = got
    train_layers(torch, rc, tt, train, opt, views[0], gts[0], cfg,
                 statistics.median(step_ms["kernels"]))
    print(f"  phase 17: launches {launches}; {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return rows, launches



def cudnn_ssim(torch, x, y, window):
    """The port's SSIM before L1 and L2, kept here as their library
    yardstick (the port never calls it): one cuDNN blur of the stacked
    channels x, y, x*x, y*y, x*y in full float32, the map by torch ops, the
    backward by autograd (the blur's by transposed convolutions). (N, H, W,
    C) in, (N, H', W', C) out; ``window`` a (11,) tensor on the card."""
    from tinysplat_torch.ops import ssim_cuda as sc

    xc, yc = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    stacked = torch.cat([xc, yc, xc * xc, yc * yc, xc * yc], dim=1)
    mu_x, mu_y, e_xx, e_yy, e_xy = sc._Blur.apply(stacked, window).chunk(5, dim=1)
    s_xx, s_yy, s_xy = e_xx - mu_x * mu_x, e_yy - mu_y * mu_y, e_xy - mu_x * mu_y
    c1, c2 = 0.01**2, 0.03**2
    cs = (2 * s_xy + c2) / (s_xx + s_yy + c2)
    smap = ((2 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)) * cs
    return smap.permute(0, 2, 3, 1)


def ssim_phase(torch, img, gt):
    """Phase 19: see the module docstring. ``img`` and ``gt`` are a trained
    frame and its ground truth, (HEIGHT, WIDTH, 3) on the card. Returns L1's
    and L2's rows of the kernels' JSON line (without launches)."""
    from tinysplat_torch.ops import ssim_cuda as sc
    from tinysplat_torch.ops.ssim import ssim
    from tinysplat_torch.probes import timed_ms

    phase_t0 = time.perf_counter()
    print(f"phase 19: SSIM's kernels L1 and L2 ({gpu_name_and_limit()}) at {HEIGHT}x{WIDTH}",
          flush=True)
    window = sc.gaussian_window(11, 1.5)
    c1, c2 = 0.01**2, 0.03**2
    rng = np.random.default_rng(19)
    u = torch.from_numpy(rng.uniform(0, 1, (1, HEIGHT, WIDTH, 3)).astype(np.float32)).cuda()
    noisy = (u + 0.1 * torch.from_numpy(
        rng.normal(size=tuple(u.shape)).astype(np.float32)).cuda()).clamp(0, 1)
    pairs = {"frame vs GT": (img[None].contiguous(), gt[None].contiguous()),
             "uniform vs noisy": (u, noisy)}
    shape = (1, HEIGHT - 10, WIDTH - 10, 3)
    g_rand = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    g_mean = torch.full((), 1.0 / np.prod(shape), device="cuda").expand(shape)

    # (a) L1 and L2 against their plain versions and the float64 plain
    # version, twice the same bytes.
    def gap(a, b, absolute=False):
        d = float((a.double() - b.double()).abs().max())
        return d if absolute else d / float(b.abs().max())

    errs = {}
    for label, (x, y) in pairs.items():
        smap, parts = sc.ssim_fwd(x, y, window, c1, c2, 4)
        again = sc.ssim_fwd(x, y, window, c1, c2, 4)
        ref_map, ref_parts = sc.ssim_fwd_plain(x, y, window, c1, c2, 4)
        map64, parts64 = sc.ssim_fwd_plain(x.double(), y.double(), window, c1, c2, 4)
        same = same_bytes(torch, smap, again[0]) and same_bytes(torch, parts, again[1])
        e = {"map": (gap(smap, ref_map, True), gap(smap, map64, True), gap(ref_map, map64, True))}
        for k in range(4):
            e[f"partial {k}"] = (gap(parts[k], ref_parts[k]), gap(parts[k], parts64[k]),
                                 gap(ref_parts[k], parts64[k]))
        for g_label, g in (("mean", g_mean), ("random", g_rand)):
            for mu, me, other, who in ((sc.MU_X, x, y, "img1"), (sc.MU_Y, y, x, "img2")):
                args = (g, ref_parts[mu], ref_parts[sc.E_XX], ref_parts[sc.E_XY], me, other,
                        window)
                got, twice = sc.ssim_bwd(*args), sc.ssim_bwd(*args)
                chained = sc.ssim_bwd(g, parts[mu], parts[sc.E_XX], parts[sc.E_XY], me, other,
                                      window)
                ref = sc.ssim_bwd_plain(*args)
                ref64 = sc.ssim_bwd_plain(g.double(), parts64[mu], parts64[sc.E_XX],
                                          parts64[sc.E_XY], me.double(), other.double(), window)
                plain_chain = sc.ssim_bwd_plain(g, ref_parts[mu], ref_parts[sc.E_XX],
                                                ref_parts[sc.E_XY], me, other, window)
                e[f"L2 {g_label} {who}"] = (gap(got, ref),)
                e[f"L1->L2 {g_label} {who}"] = (gap(chained, ref), gap(chained, ref64),
                                                gap(plain_chain, ref64))
                same = same and same_bytes(torch, got, twice)
        torch.cuda.synchronize()
        errs[label] = e
        over = int(((smap - ref_map).abs() > sc.TOL).sum())
        print(f"  (a) {label}: twice the same bytes {same}; map past {sc.TOL:g} at {over} of "
              f"{smap.numel()} positions, mean gap {float((smap - ref_map).mean()):.3e}; "
              f"(vs plain, vs float64 plain, plain vs float64; the map absolute, the rest "
              f"over the max): { {k: tuple(float(f'{v:.2e}') for v in t) for k, t in e.items()} }",
              flush=True)
        if not same:
            raise AssertionError(f"phase 19: L1 or L2 gave other bytes twice ({label})")
    bad = [k for k, t in errs["uniform vs noisy"].items()
           if not k.startswith("partial") and t[0] > sc.TOL]
    bad += [k for k, t in errs["frame vs GT"].items()
            if (k == "map" or k.startswith("L1->L2")) and t[1] > SSIM_FRAME_RATIO * t[2]]
    bad += [k for k, t in errs["frame vs GT"].items() if k.startswith("L2 ") and t[0] > sc.TOL]
    if bad:
        raise AssertionError(f"phase 19: L1 / L2 off their plain versions at {bad}: {errs}")

    # (b) the loss's SSIM forward and backward: no host sync, one L1 and one L2.
    x = img[None].clone().requires_grad_()
    fwd, bwd = _build.launches["ssim_fwd"], _build.launches["ssim_bwd"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ssim(x[0], gt).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = (_build.launches["ssim_fwd"] - fwd, _build.launches["ssim_bwd"] - bwd)
    print(f"  (b) ssim(frame, GT).backward(): no host sync; launches L1, L2 {launched}",
          flush=True)
    if launched != (1, 1):
        raise AssertionError(f"phase 19: expected one L1 and one L2, got {launched}")

    # (c) times at the frame's shapes (device time, median of SSIM_REPS).
    x, y = pairs["frame vs GT"]
    _, parts = sc.ssim_fwd(x, y, window, c1, c2, 3)
    # The step's upstream gradient is a whole map (the mean's backward writes it).
    bargs = (g_mean.contiguous(), parts[sc.MU_X], parts[sc.E_XX], parts[sc.E_XY], x, y, window)
    l1_ms = timed_ms(lambda: sc.ssim_fwd(x, y, window, c1, c2, 3), SSIM_REPS, device_only=True)
    l1_eval_ms = timed_ms(lambda: sc.ssim_fwd(x, y, window, c1, c2), SSIM_REPS,
                          device_only=True)
    l2_ms = timed_ms(lambda: sc.ssim_bwd(*bargs), SSIM_REPS, device_only=True)
    plain_fwd = timed_ms(lambda: sc.ssim_fwd_plain(x, y, window, c1, c2, 3), 5,
                         device_only=True)
    plain_bwd = timed_ms(lambda: sc.ssim_bwd_plain(*bargs), 5, device_only=True)
    win_t = torch.as_tensor(window, device="cuda")
    xl = x.clone().requires_grad_()

    def lib_fwd():
        return cudnn_ssim(torch, xl, y, win_t).mean()

    def lib_both():
        lib_fwd().backward()

    def port_both():
        ssim(xl[0], y[0]).backward()

    lib_fwd_ms = timed_ms(lib_fwd, 5, device_only=True)
    lib_both_ms = timed_ms(lib_both, 5, device_only=True)
    port_both_ms = timed_ms(port_both, 5, device_only=True)
    b1, b2 = sc.layer_bytes(1, HEIGHT, WIDTH, 3)
    frame_errs = errs["frame vs GT"]
    rows = {"ssim_fwd": {"max_abs_err": frame_errs["map"][0], "ms": l1_ms,
                         "plain_ms": plain_fwd, "bound_ms": 1e3 * b1 / HBM_BYTES_PER_S,
                         "bound_by": "bytes", "library_ms": lib_fwd_ms},
            "ssim_bwd": {"max_abs_err": max(t[0] for k, t in frame_errs.items()
                                            if k.startswith("L2 ")), "ms": l2_ms,
                         "plain_ms": plain_bwd, "bound_ms": 1e3 * b2 / HBM_BYTES_PER_S,
                         "bound_by": "bytes", "library_ms": lib_both_ms - lib_fwd_ms}}
    for name, r in rows.items():
        print(f"  (c) {name}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by bytes "
              f"({r['bound_ms'] / r['ms']:.1%}), plain {r['plain_ms']:.4f} ms, cuDNN chain "
              f"{r['library_ms']:.4f} ms", flush=True)
    print(f"  (c) L1 map only (eval) {l1_eval_ms:.4f} ms; ssim(frame, GT) forward and backward "
          f"{port_both_ms:.4f} ms, the cuDNN chain's {lib_both_ms:.4f} ms; "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    return rows


def bench_layout(torch, rc, config):
    """A benchmark configuration's entries (``splatbench/configs/<config>
    .json``): its seed-0 cloud at its first training view through
    ``tile_inputs`` with the configuration's tiles and budgets (every pad
    slot of the budget kept), and K2's rows for a numpy-drawn cotangent.
    Returns (rows, entry_rank, n)."""
    from splatbench import inputs
    from tinysplat_torch.cameras import Camera
    from tinysplat_torch.models.gaussians import GaussianParams
    from tinysplat_torch.render import splat_inputs

    bench = os.path.join(HERE, "splatbench")
    with open(os.path.join(bench, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "traffic", "train-late.json")) as f:
        view = inputs.training_views(cfg, json.load(f))[0]
    cam = Camera(position=view.position, f_x=view.fx, f_y=view.fy, fov_x=view.fov_x,
                 fov_y=view.fov_y, view_matrix=view.view, width=view.width,
                 height=view.height, name=view.name).params(device="cuda")
    n, h, w, prog = cfg["n_splats"], cfg["height"], cfg["width"], cfg["program"]
    with torch.no_grad():
        s = splat_inputs(GaussianParams(**inputs.make_cloud(cfg, 0, "cuda")),
                         torch.ones(n, dtype=torch.bool, device="cuda"), cam, h, w,
                         torch.tensor(cfg["sh_degree"], dtype=torch.int32, device="cuda"),
                         torch.zeros(3, device="cuda"))
        ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                            s.opacities, s.valid, h, w, tile_x=prog["tile_x"],
                            tile_h=prog["tile_size"], dup_capacity=prog["dup_capacity"],
                            max_per_tile=prog["max_per_tile"],
                            span_capacity=prog["span_capacity"])
    if int(ti.bins.dup_overflow) or int(ti.bins.tile_overflow):
        raise AssertionError(f"phase 20: the {config} layout dropped entries")
    out = rc.composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy,
                           ti.tile_x, ti.tile_h)
    rows = rc.composite_bwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy,
                            out, random_cotangent(torch, out, 20), ti.tile_x, ti.tile_h)
    return rows, ti.entry_rank, n


def scatter_rows_holds(torch, rows, ids, n, got):
    """(max |got - exact| over its allowance, splats, live slots) of
    ``scatter_rows``' output against a float64 ``index_add_``: each splat's
    row may miss the exact sum by the float32 rounding of its k adds in any
    order, (k - 1) 2^-24 of the sum of the added |rows|, plus k smallest
    normals (the atomics flush subnormals to 0; one for a splat with no
    entry, whose row stays 0); the sentinel row must be 0."""
    live = (ids >= 0) & (ids < n)
    zero = torch.zeros((n + 1, rows.shape[1]), dtype=torch.float64, device=rows.device)
    ref = zero.index_add(0, ids[live], rows[live].double())
    mag = zero.index_add(0, ids[live], rows[live].double().abs())
    k = torch.bincount(ids[live], minlength=n + 1).double()[:, None]
    allowed = (k - 1).clamp(min=0) * 2.0**-24 * 1.001 * mag + k.clamp(min=1) * 2.0**-126
    ratio = float(((got.double() - ref).abs() / allowed).max())
    if bool((got[n] != 0).any()):
        ratio = float("inf")
    return ratio, int((k > 0).sum()), int(live.sum())


def scatter_phase(torch, rc, step_rows, step_ranks, step_n):
    """Phase 20: see the module docstring. ``step_rows`` etc.: phase 6's
    step-0 rows, entry ranks and splat count. Returns scatter_rows' row of
    the kernels' JSON line (the 1M layout's numbers)."""
    from tinysplat_torch.probes import timed_ms

    phase_t0 = time.perf_counter()
    print(f"phase 20: the reduction kernel scatter_rows ({gpu_name_and_limit()})", flush=True)
    layouts = {"bench step 0": (step_rows, step_ranks, step_n),
               "splats-262k": bench_layout(torch, rc, "splats-262k"),
               "splats-1m": bench_layout(torch, rc, "splats-1m")}
    rows_out = {}
    for label, (rows, ranks, n) in layouts.items():
        ids = ranks.long()
        sink = torch.where((ids < 0) | (ids >= n), n, ids)
        before = _build.launches["scatter_rows"]
        got = rc.scatter_rows(rows, ranks, n)
        torch.cuda.synchronize()
        ratio, splats, live = scatter_rows_holds(torch, rows, ids, n, got)
        if _build.launches["scatter_rows"] != before + 1 or not ratio <= 1.0:
            raise AssertionError(f"phase 20: scatter_rows at {label}: launches "
                                 f"{_build.launches['scatter_rows'] - before}, error over its "
                                 f"allowance {ratio}")
        plain_err = float((rc.scatter_rows_plain(rows, ranks, n) - got).abs().max())
        ms = timed_ms(lambda: rc.scatter_rows(rows, ranks, n), SCATTER_REPS, device_only=True)
        plain_ms = timed_ms(lambda: rc.scatter_rows_plain(rows, ranks, n), 5, device_only=True)
        zero = torch.zeros((n + 1, rc.TABLE_COLS), device="cuda")
        lib_ms = timed_ms(lambda: zero.index_add(0, sink, rows), 5, device_only=True)
        d = ranks.shape[0]
        nbytes = 4 * d + 4 * rc.TABLE_COLS * (live + n + 1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows_out[label] = {"max_abs_err": plain_err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms}
        print(f"  {label}: D {d} slots, E {live} live into {splats} of n {n} splats; "
              f"error over its allowance {ratio:.3f}, max |kernel - plain| {plain_err:.3e}; "
              f"scatter_rows {ms:.4f} ms (zeroed output and kernel, median of {SCATTER_REPS}), "
              f"bound {bound:.4f} ms by bytes ({nbytes} B, {bound / ms:.1%}); plain version "
              f"{plain_ms:.4f} ms; index_add_ {lib_ms:.4f} ms", flush=True)
    print(f"  phase 20: {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return rows_out["splats-1m"]


def plain_binning(xys, depths, radii, valid, tiles_x, tiles_y, tile_size=16, chunk=128,
                  dup_capacity=0, max_per_tile=0, span_capacity=0, conics=None,
                  opacities=None, row_stride=1, row_offset=0, tile_size_x=0):
    """``bin_splats_dense`` through its plain version on any device (phase
    18 (e) swaps it into ``tile_inputs`` for the plain way)."""
    from tinysplat_torch.ops import binning

    geom = binning.BinGeometry(tiles_x, tiles_y, tile_size, tile_size_x or tile_size,
                               row_stride, int(row_offset))
    caps = binning.budgets(xys.shape[0], tiles_x * tiles_y, chunk, dup_capacity, max_per_tile,
                           span_capacity)
    return binning.bin_splats_dense_plain(xys, depths, radii, valid, geom, caps, chunk, conics,
                                          opacities)


def bin_bytes(n, n_valid, n_emitting, entries, blocks, num_tiles):
    """Bytes B1-B4 must move at ``n`` depth ranks, ``n_valid`` of them valid
    splats and ``n_emitting`` of them with kept entries, and ``entries``
    kept entries (each input read once, each output written once), one
    digit pass of B3 and B4 (the first: B3 also writes full_counts; B4
    writes keys and values). B1 reads every rank's order and valid flag and
    only a valid splat's position, radius, conic and opacity; B2 reads every
    rank's row count and only an emitting rank's splat, entry count and
    scans."""
    splat = 8 + 4 + 12 + 4  # xys, radius, conic, opacity
    hist = 256 * blocks * 4
    return {"bin_count": n * (4 + 1 + 8) + n_valid * splat,
            "bin_emit": n * 4 + n_emitting * (4 + splat + 4 + 8 + 8) + entries * 8 + 8 + 12,
            "radix_hist": entries * 4 + hist + num_tiles * 4,
            "radix_scatter": entries * 8 + 2 * hist + entries * 8}


def binning_phase(torch, rc, tt, state, cam, train, opt, views, gts, cfg):
    """Phase 18: see the module docstring. Returns B1-B4's rows of the
    kernels' JSON line (without launches) and the launches of (e)'s counted
    run through the kernels."""
    from tinysplat_torch.ops import binning
    from tinysplat_torch.ops import binning_cuda as bc
    from tinysplat_torch.probes import timed_ms
    from tinysplat_torch.render import render, splat_inputs

    phase_t0 = time.perf_counter()
    print(f"phase 18: the binning kernels B1-B4 ({gpu_name_and_limit()}), {N_SPLATS} splats "
          f"in {state.capacity} slots at {HEIGHT}x{WIDTH}, and in {SPLAT_CAPACITY} slots",
          flush=True)
    deg = state.active_sh_degree
    bg = torch.zeros(3, device="cuda")
    big, big_alive = pad_params(torch, state.params, state.alive, SPLAT_CAPACITY)
    with torch.no_grad():
        s = splat_inputs(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg)
        s_big = splat_inputs(big, big_alive, cam, HEIGHT, WIDTH, deg, bg)

    def layer(sp, th, tx, **caps):
        tiles_x, tiles_y = -(-WIDTH // tx), -(-HEIGHT // th)
        geom = binning.BinGeometry(tiles_x, tiles_y, th, tx)
        budgets = binning.budgets(sp.xys.shape[0], tiles_x * tiles_y, 128, **caps)
        return (sp.xys, sp.proj.depths, sp.proj.radii, sp.valid, geom, budgets, 128,
                sp.proj.conics, sp.opacities)

    bench = {k: v for k, v in RENDER_KW.items() if k != "tile_x"}
    total16 = int(rc.bin_splats_dense(
        s.xys, s.proj.depths, s.proj.radii, s.valid, -(-WIDTH // 64), -(-HEIGHT // 16),
        conics=s.proj.conics, opacities=s.opacities, tile_size_x=64, **bench).num_entries)
    cases = {"16x64, bench budgets": layer(s, 16, 64, **bench),
             f"16x64, {SPLAT_CAPACITY} slots": layer(s_big, 16, 64, **bench)}
    for ts in (8, 32):
        caps = full_budgets(rc, s, s.proj.radii, ts, 0)[0]
        cases[f"{ts}x{ts}"] = layer(s, ts, ts, **caps)
    # Forced overflows at 16x64: the entry cut inside the entries, the span
    # cut inside the spans, and 128 entries a tile.
    cases["16x64, dup_capacity cut"] = layer(s, 16, 64, **dict(
        bench, dup_capacity=total16 // 2 // 128 * 128 + 128))
    cases["16x64, span_capacity cut"] = layer(s, 16, 64, **dict(bench, span_capacity=total16 // 3))
    cases["16x64, max_per_tile 128"] = layer(s, 16, 64, **dict(bench, max_per_tile=128))

    # (a) + (b): every stage and the whole layer bit for bit, twice the same bytes.
    for label, args in cases.items():
        rep = bc.stage_mismatch(*args)
        geom, caps = args[4], args[5]
        print(f"  (a) {label} ({geom.tiles_x}x{geom.tiles_y} tiles, "
              f"{bc.radix_passes(geom.tiles_x * geom.tiles_y)} digit passes, budgets "
              f"{caps._asdict()}): differing elements B1 {rep['bin_count']}, B2 "
              f"{rep['bin_emit']}, B3 {rep['radix_hist']}, B4 {rep['radix_scatter']}, sort vs "
              f"a stable sort {rep['sorted_vs_stable_sort']}, whole layer {rep['whole']}; (b) "
              f"twice the same bytes {rep['same_bytes']}; counters {rep['counters']}",
              flush=True)
        if rep["bin_count_first"]:
            print(f"      B1's first differing (rank, splat): {rep['bin_count_first']}",
                  flush=True)
        if not rep["ok"]:
            raise AssertionError(f"phase 18 {label}: the binning kernels disagree: {rep}")
        c = rep["counters"]
        if "cut" in label and not c["dup_overflow"]:
            raise AssertionError(f"phase 18 {label}: the cut dropped nothing: {c}")
        if "max_per_tile" in label and not c["tile_overflow"]:
            raise AssertionError(f"phase 18 {label}: no tile overflowed: {c}")

    # (c) tile_inputs (and, for the record, a whole frame) with no host sync.
    ti_args = (s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4, s.opacities,
               s.valid, HEIGHT, WIDTH)
    ref = rc.tile_inputs(*ti_args, **RENDER_KW)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ti = rc.tile_inputs(*ti_args, **RENDER_KW)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not all(torch.equal(a, b) for a, b in zip(ti.bins, ref.bins)):
        raise AssertionError("phase 18 (c): tile_inputs under the sync check binned otherwise")
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            render(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg, **RENDER_KW)
        frame_sync = "none"
    except RuntimeError as err:
        frame_sync = str(err).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"  (c) tile_inputs made no host sync (torch.cuda.set_sync_debug_mode('error')); a "
          f"whole frame through render(): first sync {frame_sync!r}", flush=True)

    # (d) device times at the bench frame's shapes against their bounds.
    xys, depths, radii, valid, geom, caps, _, conics, opac = cases["16x64, bench budgets"]
    n, num_tiles = xys.shape[0], geom.tiles_x * geom.tiles_y
    order = binning.depth_order(depths, valid).to(torch.int32)
    rows, ents = bc.bin_count(order, xys, radii, valid, geom, conics, opac)
    scans = (torch.cumsum(rows, 0), torch.cumsum(ents, 0))
    emit_args = (order, xys, radii, valid, geom, caps, rows, ents, *scans, conics, opac)
    keys, vals, counters = bc.bin_emit(*emit_args)
    m, blocks = int(counters[0]), bc.sort_blocks(caps.dup_capacity)
    full = torch.zeros(num_tiles, dtype=torch.int32, device="cuda")
    hist = bc.radix_hist(keys, counters, 0, blocks, full)
    incl = torch.cumsum(hist, 0, dtype=torch.int32)
    outs = [torch.empty_like(keys) for _ in range(2)]

    ms = {
        "bin_count": timed_ms(lambda: bc.bin_count(order, xys, radii, valid, geom, conics, opac),
                              20, device_only=True),
        "bin_emit": timed_ms(lambda: bc.bin_emit(*emit_args), 20, device_only=True),
        "radix_hist": timed_ms(lambda: bc.radix_hist(keys, counters, 0, blocks, full), 20,
                               device_only=True),
        "radix_scatter": timed_ms(lambda: bc.radix_scatter(keys, vals, hist, incl, counters, 0,
                                                           *outs), 20, device_only=True)}
    plain = {
        "bin_count": timed_ms(lambda: bc.bin_count_plain(order, xys, radii, valid, geom, conics,
                                                         opac), 3, device_only=True),
        "bin_emit": timed_ms(lambda: bc.bin_emit_plain(*emit_args[:6], conics, opac), 3,
                             device_only=True),
        "radix_hist": timed_ms(lambda: bc.radix_hist_plain(keys, counters, 0, blocks), 3,
                               device_only=True),
        "radix_scatter": timed_ms(lambda: bc.radix_scatter_plain(
            keys, vals, hist, incl, counters, 0, *outs), 3, device_only=True)}
    # B3 + B4's function in one library call: a stable sort of the tile ids.
    lib_sort = timed_ms(lambda: torch.sort(keys[:m], stable=True), 20, device_only=True)
    sort_all = timed_ms(lambda: bc.sort_by_tile(keys.clone(), vals.clone(), counters, num_tiles,
                                                torch.zeros_like(full), outs[1]), 20,
                        device_only=True)
    layer_ms = timed_ms(lambda: rc.bin_splats_dense(
        xys, depths, radii, valid, geom.tiles_x, geom.tiles_y, conics=conics, opacities=opac,
        tile_size_x=64, **bench), 20, device_only=True)
    spans = int(rows.long().sum())
    first_span, first_entry = scans[0] - rows, scans[1] - ents
    emitting = int(((rows > 0) & (first_span < caps.span_capacity)
                    & (first_entry < caps.dup_capacity)).sum())
    nbytes_ = bin_bytes(n, int(valid.sum()), emitting, m, blocks, num_tiles)
    # FP32 work of B1 / B2: ~30 operations a valid (B1) or emitting (B2)
    # splat (the rectangle, the ellipse's log and square roots) and ~40 a
    # span (two band maxima).
    kept_spans = min(spans, caps.span_capacity)
    ops = {"bin_count": 30 * int(valid.sum()) + 40 * spans,
           "bin_emit": 30 * emitting + 40 * kept_spans}
    rows_out = {}
    for name in ("bin_count", "bin_emit", "radix_hist", "radix_scatter"):
        bytes_ms = nbytes_[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = ops.get(name, 0) / FP32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        lib = lib_sort if name in ("radix_hist", "radix_scatter") else None
        print(f"  (d) {name}: {ms[name]:.4f} ms (median of 20, device time); plain version "
              f"{plain[name]:.3f} ms; bound {bound:.4f} ms by {by} ({nbytes_[name]} bytes -> "
              f"{bytes_ms:.4f} ms; {ops.get(name, 0)} FP32 operations -> {ops_ms:.5f} ms), "
              f"{bound / ms[name]:.1%} of it" + (f"; torch.sort(stable=True) of the "
                                                  f"{m} tile ids {lib:.4f} ms" if lib else ""),
              flush=True)
        rows_out[name] = {"ms": ms[name], "plain_ms": plain[name], "bound_ms": bound,
                          "bound_by": by, "library_ms": lib, "max_abs_err": 0.0}
    print(f"  (d) {n} slots ({int(valid.sum())} valid, {emitting} emitting), {spans} spans, "
          f"{m} entries, {num_tiles} tiles: the radix sort "
          f"({bc.radix_passes(num_tiles)} passes of B3 + scan + B4) {sort_all:.4f} ms; the "
          f"whole binning (depth sort, B1, scans, B2, the radix sort, tile starts) "
          f"{layer_ms:.4f} ms (device time)", flush=True)

    # (e) the layer, a frame and a bare "scatter" step through the kernels and
    # the plain way (bin_splats_dense_plain swapped into tile_inputs), in turns.
    kernels = counted_kernels()
    step_fn = tt.make_train_step(cfg, HEIGHT, WIDTH)

    def one_way(label, step):
        layer_t = timed_ms(lambda: rc.tile_inputs(*ti_args, **RENDER_KW), SPLAT_REPS)
        frames = []
        for _ in range(SPLAT_REPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            with torch.no_grad():
                render(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg, **RENDER_KW)
            end.record()
            end.synchronize()
            frames.append(start.elapsed_time(end))
        nonlocal train
        train, log = train_steps(torch, step_fn, train, opt, views, gts, step, SPLAT_REPS)
        check_steps(torch, log, f"phase 18 {label}")
        step_ms = statistics.median(m for _, m, _, _ in log)
        print(f"  (e) {label}: tile_inputs layer {layer_t:.3f} ms, frame median "
              f"{statistics.median(frames):.3f} ms, bare step median {step_ms:.3f} ms "
              f"(CUDA events, {SPLAT_REPS} each)", flush=True)

    kernel_binning = rc.bin_splats_dense
    launches = None
    for i, way in enumerate(("kernels", "plain", "plain", "kernels")):
        rc.bin_splats_dense = kernel_binning if way == "kernels" else plain_binning
        for k in kernels:
            _build.launches[k] = 0
        try:
            one_way(f"{way} ({i + 1} of 4)", 200 + 10 * i)
        finally:
            rc.bin_splats_dense = kernel_binning
        got = {k: _build.launches[k] for k in kernels}
        bins = 3 * SPLAT_REPS if way == "kernels" else 0  # layer calls, frames, steps
        check_launches(got, {"composite_fwd": 2 * SPLAT_REPS, "composite_bwd": SPLAT_REPS,
                             "segsum": 0, "splat_fwd": 2 * SPLAT_REPS, "bins": bins},
                       f"phase 18 (e) {way}")
        if launches is None:
            launches = got
    print(f"  phase 18: launches {launches}; {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return rows_out, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.io.checkpoint import load_model
    from tinysplat_torch.ops import rasterize_cuda as rc
    from tinysplat_torch.probes import timed_ms
    from tinysplat_torch.render import render, splat_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ---------------------------------------------------------
    print(gpu_name_and_limit(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    host = {}
    for mod in ("PIL", "cv2", "websockets", "scipy", "matplotlib"):
        try:
            host[mod] = getattr(__import__(mod), "__version__", "?")
        except ImportError:
            host[mod] = None
    print(f"host packages (None: missing): {host}", flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {sorted(libs)}", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name} ptxas: {line.strip()}", flush=True)

    # -- 3. K1 vs plain on small synthetic cases -------------------------------
    print("phase 3: K1 vs plain, synthetic cases", flush=True)
    cases = [
        synthetic_case(torch, rc, "mixed tile_x=16", 3000, 96, 256, 16, seed=1),
        synthetic_case(torch, rc, "mixed tile_x=64", 3000, 96, 256, 64, seed=1),
        synthetic_case(torch, rc, "heavy occlusion tile_x=64", 4000, 64, 128, 64, seed=2,
                       conic=[[0.02, 0.0], [0.0, 0.02]], opacity=(0.9, 1.0)),
        synthetic_case(torch, rc, "deep tile tile_x=32", 3000, 32, 64, 32, seed=3,
                       xy_lo=(0.0, 0.0), xy_hi=(32.0, 16.0),
                       conic=[[0.001, 0.0], [0.0, 0.001]], opacity=(0.004, 0.008),
                       max_per_tile=4096),
        synthetic_case(torch, rc, "mostly empty tile_x=64", 40, 128, 1024, 64, seed=4,
                       conic=[[2.0, 0.0], [0.0, 2.0]]),
        uneven_subtiles_case(torch, rc, 64, seed=5),
        synthetic_case(torch, rc, "mixed tile_x=48, height 100", 3000, 100, 256, 48, seed=6),
    ]
    for label, ti in cases:
        args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x)
        compare_kernel(torch, rc, args, label)
    deep = cases[3][1]
    if int(deep.counts.max()) <= 2 * rc.SUB_THREADS:
        raise AssertionError("the deep-tile case must exceed two K1 batches of entries")
    _, uneven = cases[5]
    sub_live = rc.subtile_live(rc.composite_fwd(*uneven[:6], uneven.tile_x), uneven.counts,
                               uneven.tile_x)[0]
    print(f"  sub-tile live prefixes of the uneven tile: {sub_live.tolist()}", flush=True)
    if not int(sub_live[0]) * 4 < int(sub_live[1:].min()):
        raise AssertionError("the uneven case's sub-tiles must end at different depths")

    # -- 4. serving at full width ----------------------------------------------
    print(f"phase 4: serve {FRAMES} frames, {N_SPLATS} splats, {HEIGHT}x{WIDTH}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench_scene.npz")
        write_bench_checkpoint(ckpt)
        t0 = time.perf_counter()
        state = load_model(ckpt, device="cuda")
        torch.cuda.synchronize()
        print(f"  load_model: {time.perf_counter() - t0:.3f} s, capacity {state.capacity}, "
              f"active SH degree {int(state.active_sh_degree)}", flush=True)
    deg = state.active_sh_degree
    bg = torch.zeros(3, device="cuda")
    cams = [c.params(device="cuda") for c in orbit_cameras(FRAMES, width=WIDTH, height=HEIGHT)]

    def frame(cam):
        with torch.no_grad():
            return render(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg, **RENDER_KW)

    for cam in cams[:WARMUP]:
        frame(cam)
    torch.cuda.synchronize()

    for k in counted_kernels():
        _build.launches[k] = 0
    frame_ms, host_ms, results = [], [], []
    for cam in cams:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        rgb, extras = frame(cam)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        frame_ms.append(start.elapsed_time(end))
        results.append((rgb, extras))
    frame_launches = {k: _build.launches[k] for k in counted_kernels()}
    print(f"  launches during the {FRAMES} frames: {frame_launches}", flush=True)
    check_launches(frame_launches, {"composite_fwd": FRAMES, "composite_bwd": 0, "segsum": 0},
                   "phase 4 frames")

    depth_medians = []
    for i, (rgb, ex) in enumerate(results):
        diag = ex["binning"]
        if diag["dup_dropped"] or diag["tile_dropped"]:
            raise AssertionError(f"frame {i} dropped entries: {diag}")
        alpha, depth = ex["alpha"], ex["depth"]
        if rgb.shape != (HEIGHT, WIDTH, 3) or not torch.isfinite(rgb).all():
            raise AssertionError(f"frame {i}: bad rgb {tuple(rgb.shape)}")
        if float(rgb.min()) < 0.0 or float(rgb.max()) > 1.0:
            raise AssertionError(f"frame {i}: rgb outside [0, 1]")
        coverage = float((alpha > 0.01).float().mean())
        opaque = alpha > 0.9
        if coverage <= 0.0 or not bool(opaque.any()):
            raise AssertionError(f"frame {i}: nothing rendered")
        depth_medians.append(float((depth[opaque] / alpha[opaque]).median()))
    print(f"  alpha coverage frame 0: {float((results[0][1]['alpha'] > 0.01).float().mean()):.4f}; "
          f"median depth at opaque pixels per frame: "
          f"{[round(d, 4) for d in depth_medians]} (orbit radius 3.0)", flush=True)
    if not all(abs(d - 3.0) < 1.0 for d in depth_medians):
        raise AssertionError("depth at opaque pixels is not near the orbit radius")

    # K1 at the main path's shapes: frame 0's inputs, against the plain
    # version (launches here are outside the counted window).
    s = splat_inputs(state.params, state.alive, cams[0], HEIGHT, WIDTH, deg, bg)
    ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                        s.opacities, s.valid, HEIGHT, WIDTH, **RENDER_KW)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x)
    max_err, out = compare_kernel(torch, rc, args, "bench frame 0")
    plain_out = rc.composite_fwd_plain(*args)
    img_p, alpha_p = rc.untile(plain_out, s.bg4, ti.tiles_x, ti.tiles_y, ti.tile_x,
                               HEIGHT, WIDTH)
    rgb0, ex0 = results[0]
    frame_err = max(float((rgb0 - img_p[..., :3].clamp(max=1.0)).abs().max()),
                    float((ex0["alpha"] - alpha_p).abs().max()))
    print(f"  frame 0 through render() vs the plain version: max abs diff {frame_err:.3e}",
          flush=True)
    if frame_err > KERNEL_TOL:
        raise AssertionError("the served frame disagrees with the plain version")

    k1_ms = timed_ms(lambda: rc.composite_fwd(*args), 20, device_only=True)
    plain_ms = timed_ms(lambda: rc.composite_fwd_plain(*args), 3, device_only=True)
    pairs = print_counts(rc, ti, out, "bench frame 0")["pairs"]["k1_box"]
    tile_pairs = int(ti.counts.long().sum()) * 16 * ti.tile_x
    in_bytes = sum(x.numel() * x.element_size() for x in args[:6])
    out_bytes = out.numel() * out.element_size()
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = pairs * FLOP_PER_PAIR / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    k1_slot_ms = pairs * SLOTS_PER_WALKED_PAIR / SLOTS_PER_S * 1e3
    intersections = [int(ex["binning"]["intersections"]) for _, ex in results]
    med_frame = statistics.median(frame_ms)
    print(f"  frame: median {med_frame:.3f} ms (CUDA events), host median "
          f"{statistics.median(host_ms):.3f} ms, {1e3 / med_frame:.2f} frames/s; "
          f"intersections per frame {intersections}", flush=True)
    print(f"  K1 at frame 0: median {k1_ms:.4f} ms over 20 launches; plain version "
          f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"(bytes {in_bytes + out_bytes} -> {bytes_ms:.4f} ms, {pairs} pairs in boxes x "
          f"{FLOP_PER_PAIR} FLOP -> {ops_ms:.4f} ms; all entries x pixels {tile_pairs}); "
          f"instruction recount {k1_slot_ms:.4f} ms ({SLOTS_PER_WALKED_PAIR} slots a pair)",
          flush=True)
    binning_ms = timed_ms(lambda: rc.bin_splats_dense(
        s.xys, s.proj.depths, s.proj.radii, s.valid, ti.tiles_x, ti.tiles_y,
        conics=s.proj.conics, opacities=s.opacities, tile_size_x=ti.tile_x,
        **{k: v for k, v in RENDER_KW.items() if k != "tile_x"}), 5)
    print(f"  binning alone (bin_splats_dense): {binning_ms:.3f} ms", flush=True)
    where_the_time_goes(torch, med_frame, {
        "splat_inputs (projection, SH, opacities)": lambda: splat_inputs(
            state.params, state.alive, cams[0], HEIGHT, WIDTH, deg, bg),
        "tile_inputs (binning, table, tile origins)": lambda: rc.tile_inputs(
            s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4, s.opacities,
            s.valid, HEIGHT, WIDTH, **RENDER_KW),
        "composite_fwd (K1)": lambda: rc.composite_fwd(*args),
        "untile": lambda: rc.untile(out, s.bg4, ti.tiles_x, ti.tiles_y, ti.tile_x,
                                    HEIGHT, WIDTH),
    })


    # -- 5. K2 and K3 vs plain on the synthetic cases ---------------------------
    print("phase 5: K2 and K3 vs plain, synthetic cases", flush=True)
    for i, (label, ti) in enumerate(cases):
        out_c = rc.composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx,
                                 ti.sy, ti.tile_x)
        compare_backward(torch, rc, ti, out_c, random_cotangent(torch, out_c, 100 + i), label)

    # -- 6. training at full width ----------------------------------------------
    import tinysplat_torch as tt
    from tinysplat_torch.config import Config

    print(f"phase 6: train {SCATTER_STEPS} + {MXU_STEPS} steps, {N_SPLATS} splats, "
          f"{HEIGHT}x{WIDTH}, {TRAIN_VIEWS} views", flush=True)
    views = [c.params(device="cuda")
             for c in orbit_cameras(TRAIN_VIEWS, width=WIDTH, height=HEIGHT)]
    with torch.no_grad():  # GT: the unperturbed scene of phase 4 over black
        gts = [render(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg, **RENDER_KW)[0]
               for cam in views]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench_scene.npz")
        write_bench_checkpoint(ckpt)
        train = load_model(ckpt, device="cuda")
    noise = np.random.default_rng(7).normal(0.0, 0.1, size=tuple(train.params.colors_dc.shape))
    with torch.no_grad():  # dimmed opacities, perturbed colours
        live = train.alive[:, None]
        train.params.opacities[:] = torch.where(live, -1.0, train.params.opacities)
        train.params.colors_dc += torch.where(
            live, torch.as_tensor(noise, dtype=torch.float32, device="cuda"), 0.0)
    cfg = Config(background="black", warmup_grad=0, grad_reduce="scatter", **RENDER_KW)
    opt = tt.init_opt_state(cfg, train)
    step0_deg = min(cfg.sh_degree, 1)
    ti0, out0, gout0 = backward_inputs(torch, rc, train, views[0], gts[0], step0_deg, cfg)

    step_fn = tt.make_train_step(cfg, HEIGHT, WIDTH)
    kernels = counted_kernels()
    for k in kernels:
        _build.launches[k] = 0
    train, log = train_steps(torch, step_fn, train, opt, views, gts, 0, SCATTER_STEPS)
    train_launches = {k: _build.launches[k] for k in kernels}
    losses = [float(m["loss"]) for m, _, _, _ in log]
    print(f"  scatter steps: launches {train_launches}; losses "
          f"{[round(x, 5) for x in losses]}; psnr {[round(float(m['psnr']), 3) for m, *_ in log]}",
          flush=True)
    check_steps(torch, log, "scatter")
    check_launches(train_launches, {"composite_fwd": SCATTER_STEPS,
                                    "composite_bwd": SCATTER_STEPS, "segsum": 0},
                   f"phase 6 ({SCATTER_STEPS} scatter steps)")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    accum = train.means_grad_accum[train.alive]
    print(f"  accumulator: {int((accum > 0).sum())} of {int(train.alive.sum())} live slots > 0, "
          f"max {float(accum.max()):.4e}", flush=True)
    if not bool((accum > 0).any()):
        raise AssertionError("the densify accumulator stayed zero")

    # "mxu" vs "scatter" gradients from one state, then steps through K3.
    mxu_cfg = dataclasses.replace(cfg, grad_reduce="mxu")
    g_scatter = param_grads(torch, tt, train, views[0], gts[0], SCATTER_STEPS, cfg)
    g_mxu = param_grads(torch, tt, train, views[0], gts[0], SCATTER_STEPS, mxu_cfg)
    grad_err = {name: column_err(torch, g_mxu[name].reshape(-1, g.shape[-1]),
                                 g.reshape(-1, g.shape[-1]))[1]
                for name, g in g_scatter.items()}
    print(f"  mxu vs scatter gradients, scaled error by field "
          f"{ {k: float(f'{v:.3e}') for k, v in grad_err.items()} } (tol {BWD_TOL:g})",
          flush=True)
    if max(grad_err.values()) > BWD_TOL:
        raise AssertionError("the mxu path's gradients differ from the scatter path's")
    for k in kernels:
        _build.launches[k] = 0
    train, mxu_log = train_steps(torch, tt.make_train_step(mxu_cfg, HEIGHT, WIDTH), train, opt,
                                 views, gts, SCATTER_STEPS, MXU_STEPS)
    mxu_launches = {k: _build.launches[k] for k in kernels}
    print(f"  mxu steps: launches {mxu_launches}; losses "
          f"{[round(float(m['loss']), 5) for m, *_ in mxu_log]}", flush=True)
    check_steps(torch, mxu_log, "mxu")
    check_launches(mxu_launches, {"composite_fwd": MXU_STEPS, "composite_bwd": MXU_STEPS,
                                  "segsum": MXU_STEPS}, f"phase 6 ({MXU_STEPS} mxu steps)")

    # K2 and K3 at step 0's shapes: against the plain versions, timed.
    k2_err, rows0 = compare_backward(torch, rc, ti0, out0, gout0, "train step 0")
    bargs = (ti0.table, ti0.entry_rank, ti0.tile_starts, ti0.counts, ti0.sx, ti0.sy, out0,
             gout0, ti0.tile_x)
    k2_ms = timed_ms(lambda: rc.composite_bwd(*bargs), 20, device_only=True)
    k2_plain_ms = timed_ms(lambda: rc.composite_bwd_plain(*bargs), 3, device_only=True)
    live_t = torch.minimum(out0[:, 6].amax(dim=1).long(), ti0.counts.long())
    counts0 = print_counts(rc, ti0, out0, "bench step 0")
    k2_pairs = counts0["pairs"]["k2_box"]
    k2_in = nbytes(*bargs[:6], out0[:, 4:7], gout0[:, 0:5])
    k2_flop_bound = kernel_bound(k2_in, nbytes(rows0), k2_pairs * FLOP_PER_PAIR)[0]
    k2_bound, k2_by = kernel_bound(k2_in, nbytes(rows0), k2_slots(counts0), SLOTS_PER_S)
    n0 = ti0.table.shape[0] - 1
    perm0, bounds0 = rc.segsum_inputs(ti0.entry_rank, n0)
    k3_ms, k3_bound_ms, k3_by = time_k3(rc, rows0, perm0, bounds0, "step 0", 20)
    k3_plain_ms = timed_ms(lambda: rc.segsum_plain(rows0, perm0, bounds0), 3,
                           device_only=True)
    # K3's function in one library call: index_add_ of the unsorted rows.
    ids0 = ti0.entry_rank.long()
    ids0 = torch.where((ids0 < 0) | (ids0 >= n0), n0, ids0)
    zero = torch.zeros((n0 + 1, rc.TABLE_COLS), device="cuda")
    k3_lib_ms = timed_ms(lambda: torch.index_add(zero, 0, ids0, rows0), 20, device_only=True)
    print(f"  K2 at step 0: median {k2_ms:.4f} ms over 20 launches; plain version "
          f"{k2_plain_ms:.2f} ms; instruction bound {k2_bound:.4f} ms by {k2_by} "
          f"({k2_pairs} own-prefix pairs in boxes x {SLOTS_PER_WALKED_PAIR} + "
          f"{counts0['pairs']['kept']} kept x {SLOTS_PER_KEPT_PAIR} slots; "
          f"{k2_in + nbytes(rows0)} bytes); FLOP bound {k2_flop_bound:.4f} ms (the same pairs "
          f"x {FLOP_PER_PAIR}); {ti0.tiles_x * ti0.tiles_y} tiles, live prefix max "
          f"{int(live_t.max())} mean {float(live_t.float().mean()):.1f}", flush=True)
    print(f"  K3 at step 0: plain version {k3_plain_ms:.2f} ms; index_add_ on the unsorted "
          f"rows {k3_lib_ms:.4f} ms", flush=True)
    reduction_layers(rc, rows0, ti0.entry_rank, n0)

    # Where a step's time goes (layers timed alone, CUDA events, median of 5).
    step_ms = statistics.median([ms for _, ms, _, _ in log[1:]])
    host_ms = statistics.median([h for _, _, h, _ in log[1:]])
    print(f"  step: median {step_ms:.3f} ms (CUDA events, steps 1-{SCATTER_STEPS - 1}), host "
          f"median {host_ms:.3f} ms", flush=True)
    train_layers(torch, rc, tt, train, opt, views[0], gts[0], cfg, step_ms)

    # -- 7. the trainer at full width ----------------------------------------------
    trainer_phase(torch, rc, tt, Config, views, gts, state, deg, bg)

    # -- 8. the probes P1 and P2 -------------------------------------------------------
    p1, p2 = probes_phase(torch)

    # -- 9. the dataset path: COLMAP, depth, viewer, export ----------------------------
    dataset_phase(torch, rc, tt, Config, state, deg, bg)

    # -- 10. density regularization + MCMC, then the mesh ---------------------------------
    mesh_launches, density_rows = mesh_phase(torch, rc, tt, Config, gts,
                                             mesh_256="--mesh-256" in sys.argv[1:])

    # -- 11. multi-device training on torch.distributed ---------------------------------
    shard_launches = shard_phase(torch, Config)

    # -- 12. diffusion-guided novel views -------------------------------------------------
    diffusion_launches = diffusion_phase(torch, rc, tt, Config, gts)

    # -- 13. the quality tools ------------------------------------------------------------
    quality_launches = quality_phase(torch, rc)

    # -- 14. the profiling, sweep and scaling tools ------------------------------------------
    tools_launches = tools_phase(torch)

    # -- 15. the headline bench -------------------------------------------------------------
    bench_launches = bench_phase(torch)

    # -- 16. tile heights other than 16 px ------------------------------------------------------
    tile_launches = tile_heights_phase(torch, rc, tt, Config, state, deg, bg, cams[0],
                                       (rgb0, ex0["alpha"]), views, gts,
                                       {"k1": k1_ms, "k2": k2_ms})

    # -- 17. the splat-input kernels S1 and S2 ------------------------------------------------
    splat_rows, splat_launches = splat_phase(torch, rc, tt, state, cams[0], train, opt, views,
                                             gts, cfg)

    # -- 18. the binning kernels B1-B4 ------------------------------------------------------------
    bin_rows, bin_launches = binning_phase(torch, rc, tt, state, cams[0], train, opt, views, gts,
                                           cfg)
    # -- 19. SSIM's kernels L1 and L2 -------------------------------------------------------------
    with torch.no_grad():
        frame = render(train.params, train.alive, views[0], HEIGHT, WIDTH,
                       train.active_sh_degree, bg, **RENDER_KW)[0]
    ssim_rows = ssim_phase(torch, frame, gts[0])
    # -- 20. the reduction kernel scatter_rows ------------------------------------------------
    scatter_row = scatter_phase(torch, rc, rows0, ti0.entry_rank, n0)
    by_phase = {name: {"6": train_launches[name] if name != "segsum" else
                       mxu_launches["segsum"], "10": mesh_launches[name],
                       "11": shard_launches[name], "12": diffusion_launches[name],
                       "13": quality_launches[name], "14": tools_launches[name],
                       "15": bench_launches[name], "16": tile_launches[name],
                       "17": splat_launches[name], "18": bin_launches[name]}
                for name in mesh_launches}

    record = {"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "tinysplat_torch/csrc/composite_fwd.cu",
        "replaces": "tinysplat_tpu/ops/rasterize_pallas.py:781",
        "launches": sum(by_phase["composite_fwd"].values()),
        "launches_by_phase": by_phase["composite_fwd"],
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "tinysplat_torch/csrc/composite_bwd.cu",
        "replaces": "tinysplat_tpu/ops/rasterize_pallas.py:900",
        "launches": sum(by_phase["composite_bwd"].values()),
        "launches_by_phase": by_phase["composite_bwd"],
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "segsum",
        "route": "cuda",
        "source": "tinysplat_torch/csrc/segsum.cu",
        "replaces": "tinysplat_tpu/ops/rasterize_pallas.py:264",
        "launches": sum(by_phase["segsum"].values()),
        "launches_by_phase": by_phase["segsum"],
        "max_abs_err": 0.0,  # held bit for bit (compare_k3)
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound_ms,
        "bound_by": k3_by,
        "library_ms": k3_lib_ms,
    }, p1, p2] + [{
        "name": name,
        "route": "cuda",
        "source": f"tinysplat_torch/csrc/{name}.cu",
        "replaces": "tinysplat_tpu/render.py:139",
        "launches": sum(by_phase[name].values()),
        "launches_by_phase": by_phase[name],
        **splat_rows[name],
        "library_ms": None,
    } for name in ("splat_fwd", "splat_bwd")] + [{
        "name": name,
        "route": "cuda",
        "source": "tinysplat_torch/csrc/binning.cu",
        "replaces": f"tinysplat_tpu/ops/binning.py:{line}",
        "launches": sum(by_phase[name].values()),
        "launches_by_phase": by_phase[name],
        **bin_rows[name],
    } for name, line in (("bin_count", 236), ("bin_emit", 316), ("radix_hist", 395),
                         ("radix_scatter", 395))] + [{
        "name": name,
        "route": "cuda",
        "source": "tinysplat_torch/csrc/ssim.cu",
        "replaces": "tinysplat_tpu/ops/ssim.py:55",
        "launches": sum(by_phase[name].values()),
        "launches_by_phase": by_phase[name],
        **ssim_rows[name],
    } for name in ("ssim_fwd", "ssim_bwd")] + [{
        "name": "scatter_rows",
        "route": "cuda",
        "source": "tinysplat_torch/csrc/scatter_rows.cu",
        "replaces": "tinysplat_tpu/ops/rasterize_pallas.py:125",
        "launches": sum(by_phase["scatter_rows"].values()),
        "launches_by_phase": by_phase["scatter_rows"],
        **scatter_row,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "tinysplat_torch/csrc/density.cu",
        "replaces": "tinysplat_tpu/regularizers/density.py:246",
        "launches": sum(by_phase[name].values()),
        "launches_by_phase": by_phase[name],
        **density_rows[name],
    } for name in ("density_fwd", "density_bwd")]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
