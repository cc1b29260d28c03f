"""The quality and scale tools of the port, one module per JAX-package
script of the same file name under ``scripts/``:

- ``evaluate``: held-out PSNR / SSIM of a checkpoint on a dataset;
- ``quality_bench``: train the structured synthetic scene from a uniform
  random cloud and report held-out PSNR, time-to-target and steps/s;
- ``make_real_fixture``: write a real-photo COLMAP capture (OPENCV
  distortion, textures from a photograph);
- ``quality_real``: train and evaluate such a capture through the COLMAP
  loader, undistortion and ``sparse_interp`` depth;
- ``train_diffusion_prior``: train the tiny novel-view diffusion prior on
  renders of the synthetic scene;
- ``diffusion_ab``: few-view training with and without the prior's
  guidance;
- ``train_1m_probe``: the ``Trainer`` at 1,000,000 live splats.

And the profiling, sweep and scaling tools:

- ``profile_bench``: the bench scene's render gradient under
  ``torch.profiler``: its binning counters, top ops and kernel-busy share;
- ``profile_train_step``: the same for the whole ``make_train_step``;
- ``sweep_bench``: render-gradient time (or ``--diag`` binning counters)
  per ``grad_reduce:tpb:chunk[:tile_x]`` config (``tpb`` is not read);
- ``scaling_bench``: per-band intersection spread and the sharded step's
  total work over local ranks against a one-rank world;
- ``scaling_model``: the per-device terms of a (data x tile) mesh measured
  on one card and the modelled rays/s efficiency of larger meshes.

And the headline benchmark, the port of the JAX package's root
``bench.py``:

- ``bench``: throughput of the bench scene's render gradient (forward and
  backward, Msplats/s) and the full train step's ms, steps/s and rays/s.

Each runs as ``python -m tinysplat_torch.scripts.<name>`` with the JAX
script's flags, defaults and JSON keys (the output paths and
``scaling_model``'s link figure are the port's own), and on the card
unless ``--device cpu`` is passed. ``main(argv)`` returns what it printed:
the JSON line's dict, the sweep's lines, or the profile's table.
"""
