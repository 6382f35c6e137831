"""The port's eval metrics and test meter against the JAX package on the CPU.

Inputs are made from a seed with numpy and go through ``csts_tpu.eval.metrics``
/ ``csts_tpu.train.meters`` and their ports, in fp32 and in bf16. The bf16
inputs carry planted ties (a heatmap quantised to a few levels, and rescaled
bf16 heatmaps, which tie at 1.0), where the AUC depends on the order the
argsort gives tied pixels. Bars: counts exact; fp32 sums of per-frame ratios
in another order 1e-6 (per-batch sums of up to 64 ratios of O(1), float32);
whole-set metrics 1e-6 with the same threshold.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from csts_tpu.eval import metrics as jm
from csts_tpu.train import meters as jmeters
from csts_torch.eval import metrics as tm
from csts_torch.train import meters as tmeters

DATASETS = ["ego4d_av_gaze_forecast", "aria_av_gaze_forecast", "ego4d_av_gaze", "aria_av_gaze"]
TOL = 1e-6


def _preds(rng, b=3, t=4, h=16, w=16, ties=False):
    p = rng.random((b, t, h, w)).astype(np.float32)
    if ties:
        p = np.round(p * 6) / 6  # seven levels: every frame full of ties
    return p


def _labels(rng, b=3, t=4, h=16, w=16):
    hm = np.zeros((b, t, h, w), np.float32)
    for i in range(b):
        for j in range(t):
            y, x = rng.integers(2, h - 4), rng.integers(2, w - 4)
            hm[i, j, y : y + 3, x : x + 3] = rng.random((3, 3)) + 0.01
    labels = np.concatenate([rng.random((b, t, 2)), rng.integers(0, 2, (b, t, 1))],
                            axis=-1).astype(np.float32)
    labels[0, 0, 2] = 0  # at least one fixation frame
    return hm, labels


def _as(x, dtype):
    """numpy -> (jax array, torch tensor), both in ``dtype`` ("float32"/"bfloat16")."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dataset", DATASETS + ["egteagaze"])
def test_threshold_grid_and_fixation_index(dataset):
    assert tm.thresholds_for(dataset) == jm.thresholds_for(dataset)
    assert tm.fixation_index(dataset) == jm.fixation_index(dataset)
    # the grid as the bf16 compare sees it
    assert np.array_equal(
        torch.tensor(tm.thresholds_for(dataset), dtype=torch.float64).to(torch.bfloat16)
        .float().numpy(),
        np.asarray(jnp.asarray(jm.thresholds_for(dataset), jnp.bfloat16).astype(jnp.float32)))


def test_unknown_dataset_raises():
    with pytest.raises(NotImplementedError):
        tm.fixation_index("kinetics")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("five_d", [False, True])
def test_minmax_rescale(dtype, five_d):
    x = np.random.default_rng(1).standard_normal((2, 4, 8, 8)).astype(np.float32)
    if five_d:
        x = x[..., None]
    j, t = _as(x, dtype)
    got, want = tm.minmax_rescale(t), jm.minmax_rescale(j)
    assert got.dtype == t.dtype and got.shape == tuple(want.shape)
    # both round each op in the input's dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
def test_f1_counts_and_adaptive_f1(dtype, ties):
    rng = np.random.default_rng(2)
    hm, labels = _labels(rng)
    p = _preds(rng, ties=ties) * 0.05  # inside the threshold grids
    jp, tp_ = _as(p, dtype)
    for dataset in DATASETS:
        th = jm.thresholds_for(dataset)
        for got, want in zip(tm.f1_counts(tp_, torch.from_numpy(hm), th),
                             jm.f1_counts(jp, jnp.asarray(hm), th)):
            np.testing.assert_array_equal(_np(got), _np(want))
        got = tm.adaptive_f1(tp_, torch.from_numpy(hm), torch.from_numpy(labels), dataset)
        want = jm.adaptive_f1(jp, jnp.asarray(hm), jnp.asarray(labels), dataset)
        np.testing.assert_allclose(got[:3], want[:3], atol=TOL, rtol=0)
        assert got[3] == want[3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("size", [16, 64])
def test_auc_per_frame(dtype, ties, size):
    """Ties ranked in pixel order (a stable argsort), ranks in the preds' dtype:
    at 64x64 in bf16 the ranks above 256 round, as in the JAX package."""
    rng = np.random.default_rng(3)
    hm, _ = _labels(rng, h=size, w=size)
    hm[1, 2] = 0  # a frame with no positives: not valid
    p = _preds(rng, h=size, w=size, ties=ties)
    jp, tp_ = _as(p, dtype)
    auc, valid = tm.auc_per_frame(tp_, torch.from_numpy(hm))
    jauc, jvalid = jm.auc_per_frame(jp, jnp.asarray(hm))
    np.testing.assert_array_equal(_np(valid), _np(jvalid))
    np.testing.assert_allclose(_np(auc), _np(jauc), atol=TOL, rtol=0)
    assert valid[1, 2] == 0


def test_auc_ties_need_the_stable_order():
    """A frame of equal predictions: AUC follows the pixel order of the
    positives, which an unstable sort would not keep."""
    p = np.zeros((1, 1, 8, 8), np.float32)
    hm = np.zeros_like(p)
    hm[0, 0, 0, :4] = 1.0  # the first four pixels: the lowest ranks under a stable sort
    auc, _ = tm.auc_per_frame(torch.from_numpy(p), torch.from_numpy(hm))
    jauc, _ = jm.auc_per_frame(jnp.asarray(p), jnp.asarray(hm))
    assert float(auc[0, 0]) == pytest.approx(float(jauc[0, 0]), abs=TOL) == 0.0


def _rescaled_batches(dtype, n=3, seed=4):
    """Rescaled heatmaps as the tester gives them (bf16 ties at 1.0 and at 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        hm, labels = _labels(rng)
        raw = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
        jp, tp_ = _as(raw, dtype)
        out.append((jm.minmax_rescale(jp), tm.minmax_rescale(tp_), hm, labels))
    return out


def _close(got: dict, want: dict):
    assert got["threshold"] == want["threshold"]
    for k in ("f1", "recall", "precision", "auc"):
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_streaming_f1_and_merge(dtype, dataset):
    batches = _rescaled_batches(dtype)
    js, ts = jm.StreamingF1(dataset), tm.StreamingF1(dataset, "cpu")
    first, rest = tm.StreamingF1(dataset, "cpu"), tm.StreamingF1(dataset, "cpu")
    for i, (jp, tp_, hm, labels) in enumerate(batches):
        js.update(jp, hm, labels)
        ts.update(tp_, torch.from_numpy(hm), torch.from_numpy(labels))
        (first if i == 0 else rest).update(tp_, hm, labels)  # numpy labels too
    _close(ts.finalize(), js.finalize())
    first.merge_state(rest.state())
    _close(first.finalize(), ts.finalize())
    # the port's state folds into the JAX accumulator as well
    jfirst = jm.StreamingF1(dataset)
    jfirst.update(batches[0][0], batches[0][2], batches[0][3])
    jfirst.merge_state(rest.state())
    _close(jfirst.finalize(), js.finalize())


def _meter_run(meter_cls, dtype, num_views, batches, torch_side):
    meter = (meter_cls("ego4d_av_gaze_forecast", num_views=num_views, device="cpu")
             if torch_side else meter_cls("ego4d_av_gaze_forecast", num_views=num_views))
    for jp, tp_, hm, labels, idx in batches:
        if torch_side:
            meter.update_stats(tp_, torch.from_numpy(hm), torch.from_numpy(labels),
                               indices=torch.from_numpy(idx))
        else:
            meter.update_stats(np.asarray(jp.astype(jnp.float32)).astype(
                ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32), hm, labels,
                indices=idx)
    return meter.finalize_metrics()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_views", [1, 2])
def test_test_gaze_meter_views_and_repeats(dtype, num_views):
    """Three batches of three rows: the last batch repeats rows 0 and 1 (the
    JAX loader's wrap-pad), and at two views clip 4's second view never
    arrives (flushed on the one view it has at finalize)."""
    index = [np.array([0, 1, 2]), np.array([3, 4, 5]), np.array([6, 0, 1])]
    if num_views == 2:
        index = [np.array([0, 1, 2]), np.array([3, 4, 6]), np.array([7, 8, 0])]
    batches = [(*b[:4], i) for b, i in zip(_rescaled_batches(dtype, seed=5), index)]
    got = _meter_run(tmeters.TestGazeMeter, dtype, num_views, batches, True)
    want = _meter_run(jmeters.TestGazeMeter, dtype, num_views, batches, False)
    assert got["_type"] == want["_type"] == "test_final"
    assert set(want) <= set(got)
    _close(got, want)


def test_meter_drops_repeats_in_one_batch():
    batches = _rescaled_batches("float32", n=1, seed=6)
    jp, tp_, hm, labels = batches[0]
    rows = np.array([0, 1, 0])
    meter = tmeters.TestGazeMeter("ego4d_av_gaze_forecast", device="cpu")
    meter.update_stats(tp_, torch.from_numpy(hm), torch.from_numpy(labels), indices=rows)
    once = tm.StreamingF1("ego4d_av_gaze_forecast", "cpu")
    once.update(tp_[:2], hm[:2], labels[:2])
    _close(meter.finalize_metrics(), once.finalize())


def test_scalar_meter_and_timer():
    m, jmm = tmeters.ScalarMeter(3), jmeters.ScalarMeter(3)
    for v in (1.0, 5.0, 2.0, 7.0):
        m.add_value(v)
        jmm.add_value(v)
    assert m.get_win_median() == jmm.get_win_median() == 5.0
    assert m.get_global_avg() == jmm.get_global_avg() == 3.75
    t = tmeters.Timer()
    t.pause()
    s = t.seconds()
    assert s >= 0 and t.seconds() == s
