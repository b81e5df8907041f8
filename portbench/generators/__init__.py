"""The general generators of the traffic mixes: ``traffic/<mix>.json`` names
one of them as its ``generator``."""
