"""The port's epoch loop (``vangan_torch.training.loop.fit``) against the JAX
package's, and ``python -m vangan_torch train`` end to end on the CPU.

Both ``fit`` functions drive recording stubs of the facade, the dataset, the
summary and the monitor; they must make the same calls in the same order:
the epochs, σ per epoch, the train and validate steps, the epochs that
save, and the summary scalars (``elapse`` by name only: it is wall time).
The CLI run trains tiny networks (generators f=4, discriminators f=8, 16^3
patches, clDice with 2 iterations) on tiny on-disk partitions, saves,
resumes, predicts after training and sweeps the saved epochs.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from test_torch_checkpoint import one_torch_thread  # noqa: F401  (autouse fixture)

from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.training import loop as jax_loop
from vangan_torch import cli
from vangan_torch.config import VanGanConfig
from vangan_torch.data.preprocess import read_tiff
from vangan_torch.training import loop
from vangan_torch.training.step import RESULT_KEYS


class _Checkpointer:
    def __init__(self, log):
        self.log = log

    def wait_until_finished(self):
        self.log.append(("wait",))


class _Gan:
    """Records the loop's calls; each step returns losses that count steps."""

    wasserstein, ncritic, icritic, updateGen = False, 5, 1, True  # the JAX train() reads these

    def __init__(self, log, as_tensor):
        self.__dict__.update(log=log, as_tensor=as_tensor, n=0,
                             checkpointer=_Checkpointer(log))

    def __setattr__(self, key, value):
        if key == "current_epoch":
            self.log.append(("current_epoch", value))
        object.__setattr__(self, key, value)

    def _losses(self):
        self.n += 1
        vals = {k: float(self.n + i) for i, k in enumerate(RESULT_KEYS)}
        return {k: torch.tensor(v) for k, v in vals.items()} if self.as_tensor else vals

    def distributed_train_step(self, x, y, noise_std, update_gen):
        self.log.append(("train_step", round(float(noise_std), 12), bool(update_gen)))
        return self._losses()

    def distributed_test_step(self, x, y):
        self.log.append(("test_step",))
        return self._losses()

    def save_checkpoint(self, epoch):
        self.log.append(("save", epoch))


class _Dataset:
    train_steps, val_steps = 3, 2

    def __init__(self, log):
        self.log = log

    def _batches(self, split):
        self.log.append((f"{split}_batches",))
        while True:
            yield np.zeros(1, np.float32), np.zeros(1, np.float32)

    def train_batches(self):
        return self._batches("train")

    def val_batches(self):
        return self._batches("val")


class _Summary:
    def __init__(self, log):
        self.log = log

    def scalar(self, name, value, epoch, training=True):
        self.log.append(("scalar", name, None if name == "elapse" else float(value), epoch,
                         training))

    def losses(self, results):
        self.log.append(("losses", {k: float(np.mean(v)) for k, v in results.items()}))


class _Monitor:
    def __init__(self, log, cfg):
        self.log, self.cfg = log, cfg

    def on_epoch_start(self, gan, epoch, steps_per_epoch):
        self.log.append(("on_epoch_start", epoch, steps_per_epoch))
        return self.cfg.noise_std_at_epoch(epoch)

    def on_epoch_end(self, gan, epoch):
        self.log.append(("on_epoch_end", epoch))


def _drive(fit, cfg, as_tensor, start_epoch, with_monitor):
    log = []
    monitor = _Monitor(log, cfg) if with_monitor else None
    fit(cfg, _Gan(log, as_tensor), _Dataset(log), _Summary(log), monitor,
        start_epoch=start_epoch)
    return log


@pytest.mark.parametrize("start_epoch", [0, 3])
@pytest.mark.parametrize("with_monitor", [True, False])
def test_fit_makes_the_jax_calls_in_order(start_epoch, with_monitor):
    kw = dict(EPOCHS=6, PERIOD_2D_CALLBACK=3, layer_noise=0.1)
    got = _drive(loop.fit, VanGanConfig(**kw), True, start_epoch, with_monitor)
    want = _drive(jax_loop.fit, JaxConfig(**kw), False, start_epoch, with_monitor)
    assert got == want
    saves = [e for (kind, *rest) in got if kind == "save" for e in rest]
    # epoch % 3 == 1, or the last epoch
    assert saves == [e for e in (1, 4, 5) if e >= start_epoch]
    assert got[-1] == ("wait",)


def test_fit_waits_for_the_checkpoint_when_a_step_raises():
    log = []

    class Failing(_Dataset):
        def train_batches(self):
            raise_after = iter([True, True, False])
            while next(raise_after):
                yield np.zeros(1), np.zeros(1)
            raise RuntimeError("feed died")

    with pytest.raises(RuntimeError, match="feed died"):
        loop.fit(VanGanConfig(EPOCHS=3), _Gan(log, True), Failing(log), _Summary(log))
    assert log[-1] == ("wait",)


# --- python -m vangan_torch train, end to end on the CPU ---


def _partitions(root):
    rng = np.random.default_rng(0)
    for dom, pid in (("img", "A"), ("seg", "B")):
        part = {}
        for split, n in (("training", 2), ("validation", 1), ("testing", 1)):
            d = root / "data" / f"{split}{pid}"
            d.mkdir(parents=True)
            paths = []
            for i in range(n):
                shape = (20, 18, 17, 1)
                v = (rng.normal(size=shape) if dom == "img" else
                     np.where(rng.uniform(size=shape) > 0.9, 1.0, -1.0)).astype(np.float32)
                np.save(d / f"{dom}{i}.npy", v)
                paths.append(str(d / f"{dom}{i}.npy"))
            part[split] = np.array(paths, dtype=object)
        with open(root / "data" / f"data{pid}_partition.pkl", "wb") as f:
            pickle.dump(part, f)


def _cfg(root, epochs):
    path = str(root / f"cfg{epochs}.yaml")
    VanGanConfig(BATCH_SIZE=1, EPOCHS=epochs, SUBVOL_PATCH_SIZE=(16, 16, 16), gen_filters=4,
                 disc_filters=8, cldice_iters=2, train_steps=2, val_steps=1,
                 PERIOD_2D_CALLBACK=2, compute_dtype="float32", stitcher_batch=4,
                 output_dir=str(root / "out")).to_yaml(path)
    return path


def test_train_cli_trains_saves_resumes_predicts_and_sweeps(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    _partitions(tmp_path)
    data, out = str(tmp_path / "data"), tmp_path / "out"
    cli.main(["train", "--config", _cfg(tmp_path, 2), "--data-dir", data, "--device", "cpu",
              "--predict-after"])
    ck = torch.load(out / "checkpoints" / "torch_e2.pt", weights_only=True)
    assert sorted(ck) == sorted(["gen_IS", "gen_SI", "disc_I", "disc_S", "train_state"])
    assert ck["train_state"]["step"] == 4 and set(ck["train_state"]["counts"].values()) == {4}
    assert sorted(ck["train_state"]["opt"]) == sorted(["gen_IS", "gen_SI", "disc_I", "disc_S"])
    assert os.listdir(out / "checkpoints") == ["torch_e2.pt"]  # epoch 1 only: 1 % 2 == 1, last
    for f in ("2_genIS.png", "2_genSI.png", "dataset_sample_XY.png", "Imaging_Test_Input.tiff"):
        assert (out / "GANMonitor" / f).is_file(), f
    assert (out / "Args_Settings.txt").is_file()
    for name in ("VANGAN_img0.tiff", "VANGAN_seg0.tiff"):
        vol = read_tiff(str(out / name))
        assert vol.shape == (17, 20, 18, 1) and np.isfinite(vol).all()
    for split, tags in (("train", set(RESULT_KEYS) | {"elapse"}), ("validate", set(RESULT_KEYS))):
        ea = EventAccumulator(str(out / "TB_Logs" / split))
        ea.Reload()
        assert set(ea.Tags()["scalars"]) == tags
        for tag in tags:
            events = ea.Scalars(tag)
            assert [e.step for e in events] == [0, 1] and all(np.isfinite(e.value)
                                                              for e in events)

    # resume at epoch 2 with EPOCHS 3: one more epoch, the counts go on from 4
    cli.main(["train", "--config", _cfg(tmp_path, 3), "--data-dir", data, "--device", "cpu",
              "--resume-epoch", "2"])
    ck3 = torch.load(out / "checkpoints" / "torch_e3.pt", weights_only=True)
    assert ck3["train_state"]["step"] == 6 and set(ck3["train_state"]["counts"].values()) == {6}

    # the sweep over the saved epochs, and predict from a saved epoch
    test_dir = tmp_path / "data" / "testingA"
    cli.main(["sweep", "--config", _cfg(tmp_path, 3), "--input", str(test_dir), "--start", "2",
              "--end", "3", "--step", "1", "--device", "cpu"])
    for e in (2, 3):
        assert (out / "Epoch_Sampling" / f"e{e}" / "VANGAN_img0.tiff").is_file()
    cli.main(["predict", "--config", _cfg(tmp_path, 3), "--input", str(test_dir), "--output",
              str(tmp_path / "pred"), "--epoch", "3", "--stride", "8", "8", "8",
              "--device", "cpu"])
    assert read_tiff(str(tmp_path / "pred" / "VANGAN_img0.tiff")).shape == (17, 20, 18, 1)
