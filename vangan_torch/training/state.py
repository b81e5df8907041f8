"""The four networks of the VAN-GAN system, in the JAX package's order."""

NETWORKS = ("gen_IS", "gen_SI", "disc_I", "disc_S")
