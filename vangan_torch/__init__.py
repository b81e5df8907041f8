"""VAN-GAN on PyTorch and CUDA: the port of ``vangan_tpu`` to an NVIDIA H100.

``python -m vangan_torch train`` trains the CycleGAN from the partitions of
``vangan_tpu``'s preprocessing: the data feed (``data.pipeline``), the epoch
loop (``training.loop.fit``), monitoring (``monitor``) and checkpoints of the
whole training state (``checkpoint``); ``predict`` runs sliding-window
segmentation of whole volumes with ``gen_IS`` (or ``gen_SI``), and
``sweep`` does so from every saved epoch. The generators are those of the
config's ``gen_i2s`` / ``gen_s2i``: the ResU-Net, the V-Net or the ResNet
generator (``models.factory``). The small-channel
convolutions, every InstanceNorm and the clDice skeleton run forward and
backward on hand-written CUDA kernels (``vangan_torch/ops/csrc``). The
package imports torch and never JAX.
"""

__version__ = "0.1.0"
