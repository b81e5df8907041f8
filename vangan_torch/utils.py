"""Host-side utility functions: the counterpart of ``vangan_tpu.utils`` (the
reference's utils.py items that are not in ``ops``).

The normalisations live in ``vangan_torch.ops.norms``. ``replace_nan`` and
``add_gauss_noise`` act on torch tensors; the rest on numpy arrays, with the
same numpy ``Generator`` draws as the JAX package, so a seed gives the same
crops in both. The module imports torch only inside the two tensor
functions, so a preprocessing worker that unpickles the ``rsom`` hook
(``preprocess_rsom_images``) starts without it.
"""

from __future__ import annotations

import pickle
from typing import TYPE_CHECKING, Sequence, Tuple

import numpy as np

from vangan_torch.ops.norms_np import min_max_norm_np, z_score_norm

if TYPE_CHECKING:
    import torch


def check_nan(arr: np.ndarray) -> bool:
    """True if any NaN present (utils.py:136-146)."""
    return bool(np.any(np.isnan(arr)))


def replace_nan(arr: torch.Tensor) -> torch.Tensor:
    """Replace NaNs with zeros (utils.py:149-159)."""
    import torch

    return torch.where(torch.isnan(arr), torch.zeros_like(arr), arr)


def add_gauss_noise(img: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Additive Gaussian noise clipped to [-1, 1] (utils.py:177-188), drawn
    from ``generator`` (on ``img``'s device) where JAX takes a PRNG key."""
    import torch

    noise = torch.randn(img.shape, generator=generator, dtype=img.dtype, device=img.device)
    return torch.clamp(img + rate * noise, -1.0, 1.0)


def load_volume(file: str, datatype: str = "uint8", normalise: bool = True) -> np.ndarray:
    """Load a TIFF volume as (pages, rows, cols), optionally min-max
    normalised (utils.py:204-221)."""
    from vangan_torch.data.preprocess import read_tiff

    vol = read_tiff(file)[..., 0].astype(datatype)
    if normalise:
        vol = min_max_norm_np(vol)
    return vol


def get_vacuum(arr: np.ndarray, dim: int = 3) -> np.ndarray:
    """Smallest subarray containing all non-zero voxels (utils.py:258-274)."""
    if dim == 2:
        x, y, _ = np.nonzero(arr)
        return arr[x.min() : x.max() + 1, y.min() : y.max() + 1]
    x, y, z, _ = np.nonzero(arr)
    return arr[x.min() : x.max() + 1, y.min() : y.max() + 1, z.min() : z.max() + 1]


def hist_equalization(img: np.ndarray) -> np.ndarray:
    """Histogram equalisation via the empirical CDF (utils.py:277-288)."""
    values, counts = np.unique(img.ravel(), return_counts=True)
    cdf = np.cumsum(counts).astype(np.float64)
    cdf /= cdf[-1]
    return np.interp(img, values, cdf)


def save_dict(di_: dict, filename_: str) -> None:
    """Pickle a dict (utils.py:291-302)."""
    with open(filename_, "wb") as f:
        pickle.dump(di_, f)


def load_dict(filename_: str) -> dict:
    """Unpickle a dict (utils.py:305-316) that this program wrote: unpickling
    runs code, so load only such files."""
    with open(filename_, "rb") as f:
        return pickle.load(f)


def get_sub_volume(
    image: np.ndarray, subvol: Sequence[int] = (64, 64, 512), n_samples: int = 1,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Random corner-sampled subvolume copy (utils.py:353-376)."""
    del n_samples
    rng = rng or np.random.default_rng()
    sx = rng.integers(0, image.shape[0] - subvol[0] + 1)
    sy = rng.integers(0, image.shape[1] - subvol[1] + 1)
    sz = rng.integers(0, image.shape[2] - subvol[2] + 1)
    return np.copy(image[sx : sx + subvol[0], sy : sy + subvol[1], sz : sz + subvol[2], :])


def preprocess_rsom_images(
    img: np.ndarray, lower_thresh: float = 0.05, upper_thresh: float = 99.95
) -> np.ndarray:
    """RSOM imaging-domain preprocessing (main.py:127-150): slice-wise z-score
    normalisation along z, then percentile clipping. The ``--preprocess rsom``
    hook of ``preprocess`` and ``predict``."""
    img = img.astype(np.float32)
    for z in range(img.shape[2]):
        img[..., z] = z_score_norm(img[..., z])
    lp = np.percentile(img, lower_thresh)
    up = np.percentile(img, upper_thresh)
    img[img < lp] = lp
    img[img > up] = up
    return img


def matched_crop(
    stack: np.ndarray,
    batch_size: int,
    img_size: Sequence[int],
    channels: int,
    axis: int,
    rng: np.random.Generator | None = None,
    rescale: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random matched crop of a stacked pair of image batches, split into two
    halves (loss_functions.py:136-160)."""
    rng = rng or np.random.default_rng()
    if axis == 1:
        shape = (batch_size, 2 * img_size[1], img_size[2], 1, channels)
        raxis, split_axis = 3, 1
    elif axis == 3:
        shape = (batch_size, 1, img_size[2], 2 * img_size[3], channels)
        raxis, split_axis = 1, 2
    else:
        raise ValueError("axis must be 1 or 3")
    starts = [rng.integers(0, stack.shape[i] - shape[i] + 1) for i in range(stack.ndim)]
    arr = stack[tuple(slice(s, s + d) for s, d in zip(starts, shape))]
    arr = np.squeeze(arr, axis=raxis)
    if rescale:
        arr = min_max_norm_np(arr)
    return tuple(np.split(arr, 2, axis=split_axis))
