"""PyTorch / CUDA port of contrastyou_tpu for one NVIDIA H100.

The JAX package ``contrastyou_tpu`` is the reference; this package mirrors its
module paths and never imports it or JAX. Activations on the kernel path are
NHWC bf16; the wide U-Net levels run on hand-written CUDA kernels
(``ops/csrc``), built with nvcc at first use.
"""
