"""The benchmark of ``vangan_torch`` on NVIDIA cards (see README.md)."""
