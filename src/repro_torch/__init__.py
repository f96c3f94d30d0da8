"""PyTorch/CUDA port of the SCT system (``repro``), module for module.

The JAX package ``repro`` is the reference; this package imports
neither it nor JAX. Entry points (``models.model.init_model``,
``serving.engine.ServingEngine``, ``launch.serve``) run on the CUDA
device unless the caller passes ``device="cpu"``. Hand-written CUDA
kernels live in ``csrc/`` and are built with ``nvcc`` at first use
(``kernels/build.py``); every kernel wrapper runs its plain PyTorch
version for CPU tensors only.
"""
