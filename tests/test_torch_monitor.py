"""Monitoring of the port: hand-written TensorBoard event files, the epoch
hooks of ``GanMonitor`` and the printed losses against the JAX package's,
the Pillow panels and the profiling hooks, on the CPU.

The event files are read back with ``tensorboard``'s own
``EventAccumulator`` (this machine has it; the card's does not, which is why
the port writes them by hand). σ(epoch) and the LR at each epoch's start
must equal ``vangan_tpu``'s ``GanMonitor`` (LR within float32 rounding:
optax computes the schedule in float32).
"""

import json
import os

import numpy as np
import pytest
import torch
from test_torch_checkpoint import one_torch_thread  # noqa: F401  (autouse fixture)

from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.monitor.gan_monitor import GanMonitor as JaxGanMonitor
from vangan_torch.config import VanGanConfig
from vangan_torch.monitor import GanMonitor, TBSummary
from vangan_torch.monitor import profiling
from vangan_torch.monitor.tb import crc32c, read_scalars
from vangan_torch.vangan import VanGan


def _accumulate(path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(str(path))
    ea.Reload()
    return ea


def test_crc32c_check_value():
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C catalogue's check value
    assert crc32c(b"") == 0


def test_event_files_parse_with_tensorboard(tmp_path):
    s = TBSummary(str(tmp_path))
    values = {"total_IS_loss": [3.25, 2.5, 1.125], "D_I_loss": [0.5, 0.25, 1e-8]}
    for epoch in range(3):
        for tag, v in values.items():
            s.scalar(tag, v[epoch], epoch=epoch, training=True)
            s.scalar(tag, -v[epoch], epoch=epoch, training=False)
    s.close()
    for split, sign in (("train", 1), ("validate", -1)):
        ea = _accumulate(tmp_path / split)
        assert sorted(ea.Tags()["scalars"]) == sorted(values)
        for tag, v in values.items():
            events = ea.Scalars(tag)
            assert [e.step for e in events] == [0, 1, 2]
            assert [e.value for e in events] == [float(np.float32(sign * x)) for x in v]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_read_scalars_reads_what_tensorboard_reads(tmp_path, writer):
    """The port's reader (what the card checks event files with) against
    EventAccumulator, on its own files and on tensorboardX's (the JAX
    package's ``TBSummary``)."""
    if writer == "port":
        s = TBSummary(str(tmp_path))
    else:
        from vangan_tpu.monitor.tb import TBSummary as JaxTBSummary

        s = JaxTBSummary(str(tmp_path))
    for epoch in range(3):
        s.scalar("elapse", 1.5 * epoch + 0.25, epoch=epoch)
        s.scalar("seg_loss", 4.0 - epoch, epoch=epoch, training=False)
    s.close()
    for split in ("train", "validate"):
        got = read_scalars(str(tmp_path / split))
        ea = _accumulate(tmp_path / split)
        assert got == {t: [(e.step, e.value) for e in ea.Scalars(t)]
                       for t in ea.Tags()["scalars"]}
    assert read_scalars(str(tmp_path / "train"))["elapse"][2] == (2, 3.25)


def test_read_scalars_refuses_a_corrupt_frame(tmp_path):
    s = TBSummary(str(tmp_path))
    s.scalar("a", 1.0, epoch=0)
    s.close()
    (name,) = os.listdir(tmp_path / "train")
    with open(tmp_path / "train" / name, "r+b") as f:
        f.seek(-6, os.SEEK_END)
        f.write(b"\xff")
    with pytest.raises(ValueError, match="CRC"):
        read_scalars(str(tmp_path / "train"))


def test_losses_prints_what_jax_prints(capsys):
    from vangan_tpu.monitor.tb import TBSummary as JaxTBSummary

    results = {"D_I_loss": [0.5, 0.25, 0.125], "total_IS_loss": [3.0, 2.0], "elapse": [1e-5]}
    TBSummary.losses(None, results)
    ours = capsys.readouterr().out
    JaxTBSummary.losses(None, results)
    assert ours == capsys.readouterr().out == (
        "D_I_loss: 0.2917  total_IS_loss: 2.5000  elapse: 0.0000\n")


@pytest.mark.parametrize("steps_per_epoch", [1, 7])
def test_sigma_and_lr_per_epoch_match_jax(tmp_path, capsys, steps_per_epoch):
    kw = dict(EPOCHS=10, layer_noise=0.1, INITIAL_LR=2e-4, output_dir=str(tmp_path))
    ours = GanMonitor(VanGanConfig(**kw), monitor_dir=str(tmp_path / "a"))
    theirs = JaxGanMonitor(JaxConfig(**kw), monitor_dir=str(tmp_path / "b"))
    for epoch in range(11):
        assert ours.noise_std(epoch) == theirs.noise_std(epoch)
        np.testing.assert_allclose(ours.current_lr(epoch, steps_per_epoch),
                                   theirs.current_lr(epoch, steps_per_epoch), rtol=1e-6,
                                   atol=1e-12)
        capsys.readouterr()
        sigma = ours.on_epoch_start(None, epoch, steps_per_epoch)
        printed = capsys.readouterr().out
        assert sigma == theirs.on_epoch_start(None, epoch, steps_per_epoch)
        assert printed == capsys.readouterr().out


class _Dataset:
    """Full validation volumes from a seed, as ``VanGanDataset`` yields them."""

    def __init__(self, shape=(20, 18, 17, 1)):
        self.shape = shape

    def _full(self, seed, seg):
        rng = np.random.default_rng(seed)
        while True:
            v = rng.normal(size=self.shape).astype(np.float32)
            yield (np.where(v > 1, 1.0, -1.0).astype(np.float32) if seg else v), 0

    def imaging_val_full(self):
        return self._full(1, False)

    def segmentation_val_full(self):
        return self._full(2, True)


def _tiny_cfg(tmp_path, **kw):
    d = dict(BATCH_SIZE=1, SUBVOL_PATCH_SIZE=(16, 16, 16), gen_filters=4, disc_filters=8,
             compute_dtype="float32", stitcher_batch=4, output_dir=str(tmp_path))
    d.update(kw)
    return VanGanConfig(**d)


def test_panels_and_the_3d_dump(tmp_path):
    cfg = _tiny_cfg(tmp_path, PERIOD_3D_CALLBACK=2)
    gan = VanGan(cfg, device="cpu")
    mon = GanMonitor(cfg, dataset=_Dataset(), imaging_val_data=["val/imgA.npy"],
                     segmentation_val_data=["val/segB.npy"], monitor_dir=str(tmp_path / "mon"))
    mon.on_epoch_end(gan, 4)
    assert sorted(os.listdir(tmp_path / "mon")) == ["5_genIS.png", "5_genSI.png"]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tiff")]
    # after epoch 160, on PERIOD_3D_CALLBACK: gen_SI's stitched volume
    mon.on_epoch_end(gan, 161)
    assert (tmp_path / "e162_segB.tiff").is_file()
    assert (tmp_path / "mon" / "162_genIS.png").is_file()


def test_save_model_writes_the_bundle(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    mon = GanMonitor(cfg, monitor_dir=str(tmp_path / "mon"))
    path = mon.save_model(VanGan(cfg, device="cpu"), epoch=6)
    assert path == os.path.join(str(tmp_path), "exports", "e7")
    with open(os.path.join(path, "manifest.json")) as f:
        assert sorted(json.load(f)["networks"]) == ["disc_I", "disc_S", "gen_IS", "gen_SI"]


def test_profiling_hooks_on_the_cpu(tmp_path):
    with profiling.trace(None):
        pass
    assert not os.listdir(tmp_path)
    with profiling.trace(str(tmp_path / "prof")):
        with torch.profiler.record_function("step"):
            torch.ones(4).sum()
    (trace,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step", "aten::sum"} <= names


def test_nan_debugging_is_autograd_anomaly_detection():
    was = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)
