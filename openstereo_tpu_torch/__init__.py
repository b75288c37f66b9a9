"""OpenStereo in PyTorch for NVIDIA Hopper.

A port of `openstereo_tpu` (JAX/flax, NHWC) to PyTorch (NCHW). The JAX
package is the reference: every module here names its JAX counterpart and
the layout transpose between them, and the tests hold the two against each
other. The TPU's Pallas kernels on the ported path are replaced by CUDA
kernels for sm_90a (`csrc/`), built with nvcc at first use.

This package imports neither JAX nor the JAX package.
"""

from .device import resolve_device  # noqa: F401
