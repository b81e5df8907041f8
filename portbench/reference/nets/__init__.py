"""The reference networks, one file per kind, found by the kind's name
(``gen_i2s`` / ``gen_s2i`` of a configuration, ``patchgan`` for the
discriminators): ``spec(fields, role)`` gives the parameters, and
``forward(P, x, ctx, seg, train, noise_std)`` runs the network on a
(B, X, Y, Z, 1) float32 batch with the parameters ``P`` (name -> tensor)."""

import importlib


def kind(name: str):
    return importlib.import_module(f"portbench.reference.nets.{name}")
