"""deepcut_tpu_torch — the PyTorch / CUDA port of the DeeperCut pose stack.

It mirrors `deepcut_tpu`'s module tree (``ops/``, ``models/``, ``pose/``,
``solver/``, ``parallel/``, ``tools/``) so that each counterpart sits at the
same relative path, and is held against that package by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and never
``jax``; the jax-free modules of `deepcut_tpu` (``constants``, ``proto``,
``data.pipeline``, ``pose.targets``, ``pose.evaluate``, ``pose.demo``'s
drawing helpers) are imported rather than copied.

- ``deepcut_tpu_torch.ops``      — conv/deconv/pool/norm/activations on NCHW
  tensors, the fork's losses, and the hand-written CUDA decode kernel
  (``ops.cuda_decode``, source in ``csrc/``)
- ``deepcut_tpu_torch.models``   — the dilated ResNet part detector as an
  ``nn.Module`` (serving and training forwards), the training objective,
  the JAX-layout <-> torch-layout weight converter
- ``deepcut_tpu_torch.pose``     — preprocess, ``PoseEstimator``, decode, demo;
  on-device training targets and augmentation
- ``deepcut_tpu_torch.solver``   — Caffe's update rules, ``PoseSolver``
- ``deepcut_tpu_torch.parallel`` — the one-device train and eval steps
- ``deepcut_tpu_torch.tools``    — the ``train`` command line

Importing the package builds nothing: the CUDA kernel is compiled with
``nvcc`` at its first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
