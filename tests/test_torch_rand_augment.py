"""The port's RandAugment and random erasing (``csts_torch/data/rand_augment.py``,
numpy) against the JAX package's (``csts_tpu/data/rand_augment.py``, PIL).

Tolerance: none. Every op is PIL's integer or float arithmetic replayed in
numpy, so each output is equal to the uint8; so is a whole augmented train
batch where the crop does not resize (the two loaders' uint8 resizes differ
by a level, ``test_torch_data.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

import __graft_entry__ as graft
from csts_torch import presets
from csts_torch.data import loader as tloader
from csts_torch.data import rand_augment as tra
from csts_torch.data.synthetic import write_dataset
from csts_tpu.data import datasets as jds
from csts_tpu.data import rand_augment as jra

LEVELS = (0.0, 4.5, 10.0)
SHAPES = ((32, 48), (17, 23), (40, 40))


class _Sign:
    """The JAX op's rng argument: one uniform draw, the op's sign."""

    def __init__(self, value: float):
        self.value = value

    def uniform(self, *a, **k):
        return self.value


def _frames(rng, shape, low_contrast=False):
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    return (img // 4 + 60).astype(np.uint8) if low_contrast else img


@pytest.mark.parametrize("name", list(jra._OPS))
def test_op_equals_pil(name):
    """Each op at three levels, both signs, on frames of three shapes (one
    of low contrast, where AutoContrast and Equalize stretch)."""
    assert list(tra._OPS) == list(jra._OPS)  # the policy draws index this order
    rng = np.random.default_rng(list(jra._OPS).index(name))
    for shape in SHAPES:
        for low in (False, True):
            img = _frames(rng, shape, low)
            for level in LEVELS:
                for sign in (0.25, 0.75):
                    want = np.asarray(jra._OPS[name](Image.fromarray(img), level, _Sign(sign)))
                    got = tra._OPS[name](img, level, sign)
                    assert got.dtype == np.uint8, name
                    np.testing.assert_array_equal(got, want, err_msg=f"{name} {shape} {level}")


@pytest.mark.parametrize("policy", ["rand-m9-n2-mstd0.5", "rand-m7-n4", "rand-m10-n3-mstd1-inc1"])
def test_rand_augment_clip(policy):
    """The whole clip from one seed: the same draws, the same ops on every
    frame, the generator left in the same state."""
    assert tra.parse_policy(policy) == jra.parse_policy(policy)
    frames = np.random.default_rng(1).integers(0, 256, (8, 32, 48, 3), dtype=np.uint8)
    for seed in range(6):
        r_got, r_want = np.random.default_rng(seed), np.random.default_rng(seed)
        got = tra.rand_augment_clip(frames, policy, r_got)
        want = jra.rand_augment_clip(frames, policy, r_want)
        np.testing.assert_array_equal(got, want)
        assert r_got.uniform() == r_want.uniform()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_random_erasing_clip(dtype):
    frames = np.random.default_rng(2).integers(0, 256, (8, 32, 32, 3)).astype(dtype)
    for seed in range(8):
        for prob, count in ((0.25, 1), (1.0, 3)):
            got = tra.random_erasing_clip(frames, np.random.default_rng(seed), prob, max_count=count)
            want = jra.random_erasing_clip(frames, np.random.default_rng(seed), prob, max_count=count)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("aug")), "ego4d", num_clips=4,
                         res=(32, 48), seed=5)


def test_aug_train_batch_matches_jax(split, tmp_path):
    """One AUG train batch (RandAugment rand-m9-n2-mstd0.5, random erasing
    at RE_PROB 0.5) from the port's loader against the JAX package's dataset
    items under the same per-sample generators, keyed (seed, epoch,
    position) as both loaders key them: equal."""
    prefix, splits = split
    jcfg, tcfg = graft._small_cfg(4), presets.small_cfg(4)
    for c in (jcfg, tcfg):
        c.DATA.PATH_PREFIX, c.DATA.PATH_TO_DATA_DIR = prefix, splits
        c.DATA.DECODING_BACKEND = "npy"
        c.DATA.GAUSSIAN_KERNEL = 5
        c.DATA.TRAIN_JITTER_SCALES = [32, 32]
        c.AUG.ENABLE, c.AUG.AA_TYPE, c.AUG.RE_PROB = True, "rand-m9-n2-mstd0.5", 0.5
        c.DATA_LOADER.NUM_WORKERS = 0
        c.OUTPUT_DIR = str(tmp_path)
    with tloader.construct_loader(tcfg, "train") as loader:
        keys = next(iter(loader.batch_sampler))
        batch = next(iter(loader))
    jset = jds.build_dataset(tcfg.TRAIN.DATASET, jcfg, "train")
    want = [jset.__getitem__(i, rng=np.random.default_rng((tcfg.RNG_SEED, e, p)))
            for i, e, p in keys]
    assert batch["video"].dtype == torch.float32  # erasing keeps the float feed
    for key in ("video", "labels", "labels_hm", "audio"):
        np.testing.assert_array_equal(batch[key].numpy(), np.stack([w[key] for w in want]),
                                      err_msg=key)
