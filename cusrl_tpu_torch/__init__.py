"""PyTorch/CUDA port of ``cusrl_tpu``.

Same sub-package layout and module names as the JAX package, so every module
here has one counterpart there.  The port imports ``torch`` and numpy only;
its hand-written Hopper kernels live in ``csrc/`` and build with ``nvcc`` at
first use (``nn/kernels/build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise instead of falling back.
"""
