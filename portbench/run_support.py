"""What the mixes share: the run's context, the program built from the seeded
weights, and the reference's float32 setting."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

import torch

from portbench import weights
from portbench.reference.step import NETWORKS, specs, state_specs


class Run:
    """One run: the cell's configuration fields and mix, the seed, the window
    length, whether to trace, the device, and the clock at the process's
    start. ``mark(name)`` closes a phase of the set-up: ``phases`` holds each
    phase's seconds, in order, summing to ``setup_s``."""

    def __init__(self, root: str, workload: str, fields: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device, t_start: float):
        self.root = root
        self.workload = workload
        self.fields = fields
        self.traffic = traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.phases: Dict[str, float] = {}
        self._last = t_start

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self._last
        self._last = now

    @property
    def steps_per_epoch(self) -> int:
        return self.fields.get("train_steps") or 1


def build_gan(h: Run, **overrides) -> Tuple[object, dict, Dict[str, Dict[str, torch.Tensor]]]:
    """(the program's ``VanGan`` of the cell's configuration with
    ``overrides``, seeded by the run's seed, holding the seeded weights and
    the networks' declared state; the configuration's fields; the weights it
    was given, parameters only). Each network loads strictly: a parameter or
    buffer that the reference's spec leaves out or misnames raises. Marks
    the set-up's phases "program imports", "weights", "networks" and
    "VanGan"."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.factory import build_discriminator, build_generator
    from vangan_torch.vangan import VanGan

    h.mark("program imports")
    fields = {**h.fields, **overrides, "seed": h.seed}
    cfg = VanGanConfig.from_dict(fields)
    init = weights.make(specs(fields), h.seed, h.device)
    state = weights.state(state_specs(fields), h.device)
    if h.device.type == "cuda":
        torch.cuda.synchronize()
    h.mark("weights")
    with torch.device("meta"):
        nets = {"gen_IS": build_generator(cfg.gen_i2s, cfg, role="i2s"),
                "gen_SI": build_generator(cfg.gen_s2i, cfg, role="s2i"),
                "disc_I": build_discriminator(cfg), "disc_S": build_discriminator(cfg)}
    for name in NETWORKS:
        nets[name] = nets[name].to_empty(device=h.device)
        nets[name].load_state_dict({**init[name], **state[name]}, strict=True)
    h.mark("networks")
    gan = VanGan(cfg, device=h.device, models=nets, steps_per_epoch=h.steps_per_epoch)
    h.mark("VanGan")
    return gan, fields, init


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convs in full float32 (TF32 off), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
