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

Each runs as ``python -m tinysplat_torch.scripts.<name>`` with the JAX
script's flags, defaults and JSON keys, and on the card unless
``--device cpu`` is passed. ``main(argv)`` returns the JSON line's dict.
"""
