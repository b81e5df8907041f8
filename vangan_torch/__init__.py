"""VAN-GAN on PyTorch and CUDA: the port of ``vangan_tpu`` to an NVIDIA H100.

This package serves the trained generators: ``python -m vangan_torch predict``
runs sliding-window segmentation of whole volumes with the ResU-Net ``gen_IS``
(or ``gen_SI``), its small-channel convolutions and every InstanceNorm on
hand-written CUDA kernels (``vangan_torch/ops/csrc``). Training is not ported
yet (ROADMAP.md). The package imports torch and never JAX.
"""

__version__ = "0.1.0"
