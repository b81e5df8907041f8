"""The port's data feed (``vangan_torch.data.pipeline``) against the JAX
package's (``vangan_tpu.data.pipeline``).

Both draw their crops, rejections and augmentations from NumPy, so from one
seed their batches must be bit-identical (``np.array_equal``): the serial
stream and ``DATA_WORKERS`` 2, segmentation volumes sparse enough that the
rejection sampler re-crops, and the semi-supervised concat. The port hands
its batches over as torch tensors (pinned host memory for a CUDA device;
here, on ``device="cpu"``, pageable ones).
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.data import pipeline as jax_pipeline
from vangan_tpu.data.preprocess import DataPreprocessor as JaxPreprocessor
from vangan_torch.config import VanGanConfig
from vangan_torch.data import pipeline
from vangan_torch.data.preprocess import DataPreprocessor

SHAPE = (24, 22, 20, 1)


def _volumes(path, n, seg=False, seed=0, shape=SHAPE):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if seg:
            # one small blob of foreground in a corner: most 8^3 crops miss it,
            # so the rejection sampler re-crops
            v = -np.ones(shape, np.float32)
            v[:4, :4, :4] = 1.0
            v = np.where(rng.uniform(size=shape) > 0.999, 1.0, v).astype(np.float32)
        else:
            v = rng.normal(size=shape).astype(np.float32)
        np.save(path / f"v{i}.npy", v)
        out.append(str(path / f"v{i}.npy"))
    return out


def _configs(**kw):
    d = dict(N_DEVICES=1, BATCH_SIZE=2, SUBVOL_PATCH_SIZE=(8, 8, 8))
    d.update(kw)
    return VanGanConfig(**d), JaxConfig(**d)


@pytest.fixture
def parts(tmp_path):
    img = _volumes(tmp_path / "img", 3, seed=1)
    seg = _volumes(tmp_path / "seg", 3, seg=True, seed=2)
    return ({"training": img, "validation": img[:2]}, {"training": seg, "validation": seg[:2]})


def _pair(cfgs, parts, **kw):
    ours = pipeline.VanGanDataset(cfgs[0], *parts, seed=3, device="cpu", **kw)
    theirs = jax_pipeline.VanGanDataset(cfgs[1], *parts, seed=3, **kw)
    return ours, theirs


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("split", ["train", "val"])
def test_batches_bit_identical_to_jax(parts, workers, split):
    cfgs = _configs(DATA_WORKERS=workers, BATCH_SIZE=3)
    ours, theirs = _pair(cfgs, parts)
    try:
        got = _take(getattr(ours, f"{split}_batches")(prefetch=2), 4)
        want = _take(getattr(theirs, f"{split}_batches")(prefetch=2), 4)
    finally:
        ours.close()
        theirs.close()
    for (gi, gs), (wi, ws) in zip(got, want):
        assert isinstance(gi, torch.Tensor) and gi.dtype == torch.float32
        assert not gi.is_pinned()  # device="cpu": pageable host tensors
        assert gi.shape == (3, 8, 8, 8, 1)
        assert np.array_equal(gi.numpy(), wi) and np.array_equal(gs.numpy(), ws)
        assert (gs.numpy().reshape(3, -1).max(axis=1) >= cfgs[0].SEG_THRESH).all()


def test_rejection_sampler_recrops(parts):
    """The fixture's segmentation volumes make the sampler reject crops: the
    same stream with rejection off accepts some crops with no foreground."""
    cfg, _ = _configs(REJECTION_MAX_TRIES=0)
    ds = pipeline.VanGanDataset(cfg, *parts, seed=3, device="cpu")
    it = ds._batch_iter("training", 100)
    segs = [next(it)[1] for _ in range(6)]
    assert any((s.reshape(2, -1).max(axis=1) < cfg.SEG_THRESH).any() for s in segs)


def test_semi_supervised_batches_bit_identical(tmp_path, parts):
    paired = tmp_path / "paired"
    paired.mkdir()
    rng = np.random.default_rng(9)
    for p in parts[1]["training"]:
        np.save(paired / os.path.basename(p), rng.normal(size=SHAPE).astype(np.float32))
    cfgs = _configs()
    ours, theirs = _pair(cfgs, parts, semi_supervised_dir=str(paired))
    try:
        got = _take(ours.train_batches(prefetch=1), 3)
        want = _take(theirs.train_batches(prefetch=1), 3)
    finally:
        ours.close()
        theirs.close()
    for (gi, gs), (wi, ws) in zip(got, want):
        assert np.array_equal(gi.numpy(), wi) and np.array_equal(gs.numpy(), ws)
    assert np.array_equal(ours._paired_sample(), theirs._paired_sample())


def test_full_volume_validation_samplers_match(parts):
    cfgs = _configs()
    ours, theirs = _pair(cfgs, parts)
    for name in ("imaging_val_full", "segmentation_val_full"):
        for (gv, gi), (wv, wi) in zip(_take(getattr(ours, name)(), 4),
                                      _take(getattr(theirs, name)(), 4)):
            assert gi == wi and np.array_equal(gv, wv)


@pytest.mark.parametrize("n_img,n_seg,train_steps,val_steps", [
    (7, 5, None, None), (3, 8, None, None), (1, 1, None, None), (7, 5, 11, 4)])
def test_steps_per_epoch_rule(tmp_path, n_img, n_seg, train_steps, val_steps):
    img = [str(tmp_path / f"i{i}.npy") for i in range(n_img)]
    seg = [str(tmp_path / f"s{i}.npy") for i in range(n_seg)]
    cfgs = _configs(train_steps=train_steps, val_steps=val_steps)
    p = ({"training": img, "validation": img[:3]}, {"training": seg, "validation": seg[:2]})
    ours, theirs = _pair(cfgs, p)
    assert (ours.train_steps, ours.val_steps) == (theirs.train_steps, theirs.val_steps)


@pytest.mark.parametrize("workers", [1, 2])
def test_corrupt_volume_raises_pipeline_error(tmp_path, workers):
    cfg, _ = _configs(DATA_WORKERS=workers)
    img = _volumes(tmp_path / "img", 2, seed=7)
    seg = _volumes(tmp_path / "seg", 2, seg=True, seed=8)
    with open(img[0] if workers == 1 else seg[1], "wb") as f:
        f.write(b"\x93NUMPY garbage")
    ds = pipeline.VanGanDataset(cfg, {"training": img, "validation": img},
                                {"training": seg, "validation": seg}, seed=0, device="cpu")
    it = ds.train_batches(prefetch=1)
    with pytest.raises(pipeline.PipelineError):
        for _ in range(8):  # both volumes are drawn within two batches
            next(it)
    ds.close()


def test_close_with_full_queue_does_not_wedge(parts):
    cfg, _ = _configs()
    before = set(threading.enumerate())
    ds = pipeline.VanGanDataset(cfg, *parts, seed=0, device="cpu")
    it = ds.train_batches(prefetch=1)
    next(it)  # the producer refills and blocks on the bounded queue
    time.sleep(0.3)
    t0 = time.time()
    ds.close()
    assert time.time() - t0 < 5.0
    started = [t for t in threading.enumerate() if t not in before]
    for t in started:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in started)


def test_cuda_dataset_without_cuda_raises(parts):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg, _ = _configs()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pipeline.VanGanDataset(cfg, *parts)


@pytest.mark.parametrize("fn", ["random_crop", "random_spatial_augmentation",
                                "minmax_to_pm1_np"])
def test_helpers_match_jax(fn):
    vol = np.random.default_rng(4).normal(size=(2, 9, 10, 11, 1)).astype(np.float32)
    if fn == "minmax_to_pm1_np":
        assert np.array_equal(pipeline.minmax_to_pm1_np(vol), jax_pipeline.minmax_to_pm1_np(vol))
        return
    for seed in range(8):
        args = ((vol[0], (5, 6, 7, 1)) if fn == "random_crop" else (vol[0],))
        got = getattr(pipeline, fn)(*args, np.random.default_rng(seed))
        want = getattr(jax_pipeline, fn)(*args, np.random.default_rng(seed))
        assert np.array_equal(got, want)


def test_load_partition_reads_the_jax_manifest(tmp_path, parts):
    """The manifest ``vangan_tpu``'s preprocessing pickles loads unchanged."""
    jax_pre = JaxPreprocessor(partition_id="A", partition_filename="dataA_partition.pkl")
    jax_pre.partition = {"training": ["a.tiff", "b.tiff"], "validation": ["c.tiff"],
                         "testing": ["d.tiff"]}
    jax_pre.save_partition(str(tmp_path))
    ours = DataPreprocessor(partition_id="A")
    ours.load_partition(str(tmp_path / "dataA_partition.pkl"))
    with open(tmp_path / "dataA_partition.pkl", "rb") as f:
        want = pickle.load(f)
    assert sorted(ours.partition) == ["testing", "training", "validation"]
    for split, paths in want.items():
        assert list(ours.partition[split]) == list(paths)
    assert ours.partition["training"][0] == str(tmp_path / "trainA" / "a.npy")


def test_jax_config_loads_without_the_fields_the_port_does_not_read(tmp_path):
    """A JAX YAML with ``semi_supervised`` and ``IMAGE_THRESH`` (which nothing
    reads; ``--semi-supervised-dir`` chooses the mode) loads; the data fields
    the port reads come across."""
    JaxConfig(semi_supervised=True, IMAGE_THRESH=0.25, SEG_THRESH=0.7, PREFETCH_SIZE=2,
              DATA_WORKERS=3, REJECTION_MAX_TRIES=9, val_steps=4).to_yaml(tmp_path / "c.yaml")
    cfg = VanGanConfig.from_yaml(str(tmp_path / "c.yaml"))
    assert not hasattr(cfg, "semi_supervised") and not hasattr(cfg, "IMAGE_THRESH")
    assert (cfg.SEG_THRESH, cfg.PREFETCH_SIZE, cfg.DATA_WORKERS, cfg.REJECTION_MAX_TRIES,
            cfg.val_steps) == (0.7, 2, 3, 9, 4)


def test_preprocessing_is_not_ported(tmp_path):
    """Preprocessing runs: ``preprocess`` and ``process_new_data`` on an
    empty directory of raw TIFFs give empty partitions and write no volume
    (``test_torch_preprocess.py`` holds both against the JAX package). The
    test keeps the name it had while both methods raised, so that its record
    stays continuous."""
    os.makedirs(tmp_path / "raw")
    pre = DataPreprocessor(raw_path=str(tmp_path / "raw"), main_dir=str(tmp_path / "data"),
                           partition_id="A", partition_filename="dataA_partition.pkl", seed=0)
    pre.preprocess()
    assert sorted(os.listdir(tmp_path / "data")) == ["dataA_partition.pkl", "testA", "trainA",
                                                     "valA"]
    assert {k: len(v) for k, v in pre.partition.items()} == \
        {"training": 0, "validation": 0, "testing": 0}
    pre.process_new_data(str(tmp_path / "raw"), str(tmp_path / "new"))
    assert os.listdir(tmp_path / "new") == []


def test_plot_sample_dataset_writes_the_jax_file_names(tmp_path, parts):
    cfg, _ = _configs()
    ds = pipeline.VanGanDataset(cfg, *parts, seed=0, device="cpu")
    ds.plot_sample_dataset(str(tmp_path / "mon"))
    assert sorted(os.listdir(tmp_path / "mon")) == [
        "Imaging_Test_Input.tiff", "Segmentation_Test_Input.tiff",
        "dataset_sample_XY.png", "dataset_sample_YZ.png"]
