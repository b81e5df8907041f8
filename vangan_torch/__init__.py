"""VAN-GAN on PyTorch and CUDA: the port of ``vangan_tpu`` to an NVIDIA H100.

This package serves the trained generators: ``python -m vangan_torch predict``
runs sliding-window segmentation of whole volumes with the ResU-Net ``gen_IS``
(or ``gen_SI``), its small-channel convolutions and every InstanceNorm on
hand-written CUDA kernels (``vangan_torch/ops/csrc``). ``vangan.VanGan`` also
takes train steps (``distributed_train_step``, ``train``) and evaluates
(``distributed_test_step``), the backward on the kernels' backward passes; the
data feed, checkpoints and epoch loop are not ported yet (ROADMAP.md). The
package imports torch and never JAX.
"""

__version__ = "0.1.0"
