"""deepcut_tpu_torch — the PyTorch / CUDA port of the DeeperCut pose stack.

It mirrors `deepcut_tpu`'s module tree (``ops/``, ``models/``, ``pose/``,
``solver/``, ``parallel/``, ``tools/``) so that each counterpart sits at the
same relative path, and is held against that package by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and neither
``jax`` nor `deepcut_tpu`: what it needs of the JAX package's jax-free
modules it keeps as its own copies under the same names (``constants``,
``proto``, ``data``, ``pose.targets``, ``pose.aux_targets``,
``pose.augment``, the host half of ``pose.targets_device``, ``runtime``'s
C++ rasterizer), held against the originals by tests/test_torch_data.py.

- ``deepcut_tpu_torch.ops``      — conv/deconv/pool/norm/activations on NCHW
  tensors, the fork's losses, and the hand-written CUDA kernels, the decode
  (``ops.cuda_decode``) and the serving conv's epilogue
  (``ops.conv_epilogue``), sources in ``csrc/``
- ``deepcut_tpu_torch.models``   — the dilated ResNet part detector as an
  ``nn.Module`` (serving and training forwards), the training objective,
  the JAX-layout <-> torch-layout weight converter
- ``deepcut_tpu_torch.pose``     — preprocess, ``PoseEstimator``, decode, demo;
  on-device training targets and augmentation
- ``deepcut_tpu_torch.solver``   — Caffe's update rules, ``PoseSolver``
- ``deepcut_tpu_torch.parallel`` — the train and eval steps, on one device
  or data-parallel (one process per GPU, ``parallel.mesh``)
- ``deepcut_tpu_torch.tools``    — the command line (``train``, ``test``, ...)
- ``deepcut_tpu_torch.matlab_gateway``, ``matlab/`` — the matcaffe gateway
  and its MEX marshaller

- ``deepcut_tpu_torch.data``, ``proto``, ``runtime`` — the host input
  pipeline, the Caffe codecs and the C++ target rasterizer (own copies)

Importing the package builds nothing: each CUDA kernel is compiled with
``nvcc`` at its first launch on a CUDA tensor, the rasterizer with ``g++``
at its first use (`native.build`, into ``build/deepcut_tpu_torch/``).
"""

__version__ = "0.1.0"
