"""gsl_tpu_torch: the PyTorch + CUDA port of gsl_tpu, for NVIDIA Hopper.

Same layout as ``gsl_tpu``, PyTorch idiom inside:

- ``ops``       projection, spherical harmonics, the tile rasterizer, its
                StopThePop (per-pixel resort) variant and the 2DGS surfel
                rasterizer with their gradients (CUDA kernels under
                ``csrc/`` with plain PyTorch versions beside), SSIM,
                nearest neighbours.
- ``models``    Gaussian parameters and the alive mask, as tensors;
                initialization and capacity growth; the 2D (surfel) model.
- ``renderers`` ``TileRenderer`` (``stp_resort`` selects StopThePop) and
                ``SurfelRenderer``: camera -> image.
- ``training``  loss, per-property Adam, density control, ``Trainer`` and
                ``GS2DTrainer``; the fit and validate loops, their hooks
                and loggers.
- ``data``      cameras, the COLMAP reader, the COLMAP and Blender
                dataparsers, the cached dataset and its loader.
- ``utils``     PLY I/O, checkpoints, model loading, visualizers, JAX ->
                torch state.
- ``cli``       ``python -m gsl_tpu_torch.cli fit|validate|test`` over the
                presets in ``configs/``.
- ``viewer``    ``ViewerRenderer`` and camera paths.
- ``render``    ``python -m gsl_tpu_torch.render`` video frames.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Nothing here imports JAX or the ``gsl_tpu`` package.
"""

__version__ = "0.1.0"
