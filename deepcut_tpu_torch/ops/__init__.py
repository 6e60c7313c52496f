"""Op library on NCHW tensors (the counterparts of `deepcut_tpu.ops`).

Convolutions, deconvolution and pooling go to PyTorch / cuDNN, as the JAX
package left them to XLA outside any Pallas kernel. The hand-written CUDA
kernels are the fused pose decode (`cuda_decode`) and the serving conv's
epilogue (`conv_epilogue`: f32 bias, one bf16 rounding, residual, ReLU).
"""

from deepcut_tpu_torch.ops.conv import conv2d, deconv2d, conv_output_size, deconv_output_size
from deepcut_tpu_torch.ops.pool import max_pool2d, pool_output_size
from deepcut_tpu_torch.ops.norm import batch_norm_inference, bn_scale_affine
from deepcut_tpu_torch.ops.activations import relu, sigmoid
from deepcut_tpu_torch.ops.eltwise import crop_like
