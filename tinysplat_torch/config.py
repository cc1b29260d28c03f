"""Typed training configuration: a copy of ``tinysplat_tpu.config.Config``.

Same field names and defaults as the JAX package's dataclass, so a config
written for one package reads the same in the other, plus the port's own
``mcmc_refine_every``, whose default keeps the JAX package's behaviour.
``tiles_per_block``, which only the JAX package's TPU path reads, is kept
for that parity; the mesh and multi-process fields drive
``parallel.MeshTrainer`` and ``train_cli``'s process group; the port's
render path reads ``rasterizer``, ``tile_size``, ``tile_x``, the binning
budgets, ``antialiased`` and ``viewdirs_mode``, its train step
(``train.make_train_step``) the learning rates, loss weights, regularizer
windows, ``grad_reduce``, ``sh_degree`` / ``sh_increment_interval``,
``warmup_grad``, ``background`` and ``pose_opt`` / ``app_opt``, and its
trainer (``train_loop.Trainer``, ``train_cli``) the densify, compaction,
checkpoint, NaN-guard, coarse-to-fine, evaluation and profiling fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    # Global (reference train.py:164-173)
    device: str = "tpu"
    train: bool = False
    viewer: bool = True
    load_checkpoint: Optional[str] = None
    save_checkpoints: bool = False
    checkpoint_dir: str = "checkpoints"
    sh_degree: int = 3
    max_iter: int = 10_000
    sh_increment_interval: int = 500
    checkpoint_interval: int = 10_000

    # Viewer (train.py:176-178)
    viewer_ip: str = "127.0.0.1"
    viewer_port: int = 8765

    # Dataset (train.py:181-184)
    dataset_dir: str = "datasets/train"
    colmap_path: str = "colmap/sparse/0"
    images_path: str = "images"

    # Learning rates (train.py:187-193)
    lr_means: float = 0.00016
    # Exponential means-LR decay to lr_means_final over lr_means_decay_steps
    # (3DGS position_lr schedule; the reference leaves update_learning_rate
    # as a no-op TODO, model_gaussian.py:122-124). 0 = constant LR.
    lr_means_final: float = 0.0
    lr_means_decay_steps: int = 0
    lr_colors_dc: float = 0.0025
    lr_colors_rest: float = 0.000125
    lr_scales: float = 0.005
    lr_quats: float = 0.001
    lr_opacities: float = 0.05

    # Regularization weights (train.py:197-202)
    lambda_dssim: float = 0.2
    lambda_depth: float = 0.2
    lambda_smooth: float = 0.2
    lambda_opacity: float = 0.2
    lambda_density: float = 0.2

    # Diffusion-guided novel-view regularization — wired, unlike the
    # reference's dead diffusion module (the reference framework's README.md:14).
    # lambda is the synthetic/real view ratio (regularizers/
    # diffusion_guidance.py); single-device Trainer only.
    regularize_diffusion: bool = False
    lambda_diffusion: float = 0.1
    interval_diffusion: int = 500
    regularize_diffusion_start: int = 2000
    regularize_diffusion_end: int = 15_000
    diffusion_model_dir: str = ""  # diffusers checkpoint dir ('' = tiny)
    diffusion_inference_steps: int = 8
    diffusion_strength: float = 0.6

    # Densification (train.py:205-214)
    warmup_densify: int = 600
    warmup_grad: int = 500
    interval_densify: int = 100
    interval_opacity_reset: int = 3000
    densify_end: int = 30_000
    epsilon_alpha: float = 0.005
    tau_means: float = 0.0002
    densify_scale_thresh: float = 0.01
    phi: float = 1.6
    max_gaussians: int = 1_000_000  # reference hard cap model_gaussian.py:145-147

    # Semantic segmentation (train.py:217-219)
    semantic_path: str = "semantic"
    semantic_model: str = "facebook/mask2former-swin-large-ade-semantic"

    # Depth estimation (train.py:222-224)
    depths_path: str = "depths"
    depth_model: str = "zoe"

    # Depth regularization (train.py:227-230)
    regularize_depth: bool = False
    regularize_depth_start: int = 1
    regularize_depth_end: int = 15_000

    # Opacity entropy regularization (train.py:233-236)
    regularize_opacity: bool = False
    regularize_opacity_start: int = 7000
    regularize_opacity_end: int = 9000

    # SuGaR density regularization (train.py:239-243)
    regularize_density: bool = False
    regularize_sdf: bool = False
    regularize_density_start: int = 9000
    regularize_density_end: int = 15_000
    density_samples: int = 100_000  # probe sample points per refresh

    # --- Framework-specific (the JAX package's names and defaults) ----------
    # auto = rasterize_cuda (the hand-written kernel on CUDA tensors, its
    # plain version on CPU tensors; render.resolve_rasterizer); explicit
    # values: cuda | dense.
    rasterizer: str = "auto"
    capacity: Optional[int] = None  # splat array capacity (None: auto)
    # Random-init cloud size for datasets without SfM points (Blender /
    # nerfstudio transforms.json scenes).
    random_init_points: int = 50_000
    # Cap the longer image side at load time (0 = native). The reference
    # accepts max_image_dimension but never applies it (dataset.py:17);
    # here it actually rescales cameras + images.
    max_image_dimension: int = 0
    tile_size: int = 16
    # Static intersection budgets (0 = auto: 8*N total, 4096/tile). Shrink
    # dup_capacity toward ~1.25x the observed total_intersections to cut
    # binning cost proportionally (diagnostics report overflow counts).
    dup_capacity: int = 0
    max_per_tile: int = 0
    span_capacity: int = 0  # binning row-span budget (0 = auto)
    grad_reduce: str = "scatter"  # entry-grad reduction of the training path
    tiles_per_block: int = 8  # JAX package only: tiles per Pallas grid step
    # Tile WIDTH in px (0 = tile_size: square tiles; else a multiple of 16;
    # the height is tile_size); wider tiles mean fewer intersections.
    tile_x: int = 64
    # Multi-chip: round-robin tile ROWS over the mesh 'tile' axis
    # instead of contiguous bands (parallel.make_sharded_train_step).
    band_interleave: bool = True
    # Mip-Splatting opacity compensation (beyond-reference; the legacy
    # gsplat API has no antialiased mode). See
    # ops.splat_inputs_cuda.antialias_compensation.
    antialiased: bool = False
    # Densification strategy (beyond-reference): 'default' = the reference's
    # clone/split/prune heuristics (models/densify.py); 'mcmc' = 3DGS-MCMC
    # relocation + per-step covariance-shaped noise (models/densify_mcmc.py)
    # — fixed capacity, no growth recompiles.
    densify_strategy: str = "default"
    # Camera pose optimization (beyond-reference; its cameras are fixed
    # buffers): learnable per-camera SE(3) deltas, co-optimized with the
    # splats through the rendering gradient. See cameras.apply_pose_delta.
    pose_opt: bool = False
    lr_pose: float = 1e-4
    # Per-camera appearance/exposure optimization (beyond-reference): a
    # learnable affine color transform applied to the RENDERED image inside
    # the training loss only, absorbing per-view exposure/white-balance so
    # the splats don't have to (real captures with auto-exposure).
    app_opt: bool = False
    lr_app: float = 1e-3
    # Coarse-to-fine training (beyond-reference): start at c2f_start_scale
    # resolution and double stagewise to full by step c2f_end (0 = half of
    # max_iter). Stabilizes few-view optimization and makes early steps
    # cheap; one extra XLA compile per stage.
    coarse_to_fine: bool = False
    c2f_start_scale: float = 0.25
    c2f_end: int = 0
    # Periodic capacity compaction (beyond-reference memory management):
    # every compact_interval steps, repack live splats and shrink capacity
    # to the next power of two >= live * compact_margin (0 disables). One
    # recompile when it fires; reclaims HBM after heavy pruning.
    compact_interval: int = 0
    compact_margin: float = 2.0
    # In-loop profiling (the reference has none, SURVEY.md section 5): a
    # torch.profiler window of profile_steps steps starting at profile_start
    # (past warm-up), its top ops printed and its Chrome trace written to
    # <profile_dir>/<the run's start time>/trace.json, so runs do not
    # overwrite each other's (the default directory is the JAX Config's).
    profile_steps: int = 0
    profile_start: int = 20
    profile_dir: str = "/tmp/tinysplat_trace"
    mcmc_cap: int = 0  # target live-splat cap (0 = the capacity)
    # MCMC refine cadence (gsplat's refine_every): a pass on every step that
    # is a multiple of it inside [warmup_densify, densify_end]; 0 = the
    # densify interval (the camera count, as the reference overrides it).
    mcmc_refine_every: int = 0
    mcmc_min_opacity: float = 0.005  # below this, a splat is relocated
    mcmc_growth_factor: float = 1.05  # live-count growth per refine pass
    mcmc_noise_lr: float = 5e5  # noise scale x current means LR (gsplat)
    lambda_mcmc_opacity: float = 0.01  # L1 opacity sparsity regularizer
    lambda_mcmc_scale: float = 0.01  # L1 scale regularizer
    viewdirs_mode: str = "reference"  # see ops.splat_inputs_cuda.view_origin
    # Divergence guard: in-memory snapshot every k steps; non-finite loss
    # rolls training back to it with fresh RNG (0 disables).
    nan_guard_interval: int = 200
    mesh_tile: int = 1  # mesh axis size: image-tile (pixel) sharding
    mesh_splat: int = 1  # mesh axis size: splat sharding
    # Multi-process launch: every rank runs the same CLI. --distributed
    # alone reads the torchrun environment; the coordinator flags name the
    # process group's tcp:// address, its size and this rank.
    distributed: bool = False
    coordinator_address: Optional[str] = None  # host:port of process 0
    num_processes: int = 0  # world size with --coordinator-address
    process_id: int = -1  # this rank with --coordinator-address
    seed: int = 0
    synthetic: bool = False  # use a synthetic scene instead of COLMAP data
    log_interval: int = 0  # 0: per-epoch logging like the reference
    # Machine-readable metrics sink: epoch-mean CSV rows appended here
    # (process 0 only on multi-host runs; "" disables).
    metrics_file: Optional[str] = None
    # Overlap checkpoint fetch+write with training via a writer thread
    # (single-host .npz checkpoints; the multi-host sharded path stays
    # synchronous — its barriers must run on the main thread).
    async_checkpoint: bool = False
    # Warm the HBM image cache on a thread pool at run() start, hiding the
    # first epoch's per-step decode+upload behind the first compile.
    prefetch_images: bool = True
    # Training background: "random" per step (reference train.py:51 — keeps
    # the model from painting the backdrop), or a fixed "black"/"white"
    # (match Blender/NeRF-synthetic GT compositing). Held-out eval renders
    # on the fixed color, or black under "random".
    background: str = "random"
    eval_holdout: int = 0  # hold out every k-th camera for eval (0 = none)
    eval_interval: int = 0  # evaluate held-out PSNR/SSIM every k steps
