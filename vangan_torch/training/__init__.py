"""The CycleGAN step of the port (counterpart of ``vangan_tpu.training``)."""
