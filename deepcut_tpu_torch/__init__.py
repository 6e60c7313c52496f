"""deepcut_tpu_torch — the PyTorch / CUDA port of the DeeperCut pose stack.

It mirrors `deepcut_tpu`'s module tree (``ops/``, ``models/``, ``pose/``) so
that each counterpart sits at the same relative path, and is held against
that package by the ``tests/test_torch_*.py`` parity tests. It imports
``torch`` and never ``jax``; the jax-free modules of `deepcut_tpu`
(``constants``, ``proto.caffemodel``, ``pose.demo``'s drawing helpers) are
imported rather than copied.

- ``deepcut_tpu_torch.ops``    — conv/deconv/pool/norm/activations on NCHW
  tensors, and the hand-written CUDA decode kernel (``ops.cuda_decode``,
  source in ``csrc/``)
- ``deepcut_tpu_torch.models`` — the dilated ResNet part detector as an
  ``nn.Module``; the JAX-layout -> torch-layout weight converter
- ``deepcut_tpu_torch.pose``   — preprocess, ``PoseEstimator``, decode, demo

Importing the package builds nothing: the CUDA kernel is compiled with
``nvcc`` at its first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
