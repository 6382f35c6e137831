"""The flagship CSTS-B 16x4 at its published shape (256² video, a 256² audio
STFT, 8 frames, batch 1) through the port against ``csts_apply`` on the CPU
(slow lane).

Weights come from ``csts_init`` on the flagship config, go through the port's
``state_dict_from_jax`` and load with ``strict=True``. Bars, those of
``tests/test_golden_256.py``: fp32 logits atol 5e-4 / rtol 1e-4, the NCE
embeddings atol 2e-3 / rtol 1e-3; the port in bf16 (weights and activations,
the production eval) against the fp32 ``csts_apply`` logits: per-frame
softmax at T=2 max|Δ| < 0.02 and each frame's argmax within one pixel where
the reference decides it. ``csts_init``'s weights give near-flat heatmaps
(probabilities ~1/4096 that differ by ~1e-6), so on some frames two distant
pixels are closer than the bf16 error and the argmax may move anywhere: the
argmax is held on the frames whose top-2 reference probabilities are more
than twice the probabilities' max|Δ| apart (``csts_torch.tools.softmax_check``,
the rule of ``chip_smoke.py``'s eval phase), and at least one
frame must be decided.
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from csts_tpu.models import csts as jcsts
from csts_torch import presets
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.models import csts as tcsts
from csts_torch.tools import softmax_check
from csts_torch.train.losses import frame_softmax

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def flagship():
    jspec = jcsts.build_spec(graft._flagship_cfg())
    params = jcsts.csts_init(jax.random.PRNGKey(0), jspec)
    rng = np.random.default_rng(256)
    video = rng.standard_normal((1, 8, 256, 256, 3)).astype(np.float32)
    audio = rng.standard_normal((1, 8, 256, 256, 1)).astype(np.float32)
    logits, v_emb, a_emb = (np.asarray(x) for x in jcsts.csts_apply(
        params, jspec, video, audio, return_embed=True))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    del params
    model = tcsts.CSTS(tcsts.build_spec(presets.flagship_cfg()))
    model.load_state_dict(sd, strict=True)
    return model.eval(), video, audio, (logits, v_emb, a_emb)


def test_fp32_matches_csts_apply_256(flagship):
    model, video, audio, (logits, v_emb, a_emb) = flagship
    with torch.inference_mode():
        out, tv, ta = model(torch.from_numpy(video), torch.from_numpy(audio), return_embed=True)
    assert out.shape == logits.shape == (1, 8, 64, 64, 1)
    print(f"fp32 max|Δ| logits {np.abs(out.numpy() - logits).max():.3g}, video embed "
          f"{np.abs(tv.numpy() - v_emb).max():.3g}, audio embed {np.abs(ta.numpy() - a_emb).max():.3g}")
    np.testing.assert_allclose(out.numpy(), logits, atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(tv.numpy(), v_emb, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(ta.numpy(), a_emb, atol=2e-3, rtol=1e-3)


def test_bf16_softmax_within_bar_256(flagship):
    model, video, audio, (logits, _, _) = flagship
    cfg = presets.flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    model16 = tcsts.CSTS(tcsts.build_spec(cfg))
    model16.load_state_dict(model.state_dict(), strict=True)
    model16 = model16.to(torch.bfloat16).eval()
    with torch.inference_mode():
        out16 = model16(torch.from_numpy(video), torch.from_numpy(audio)).float().numpy()
    res = softmax_check(frame_softmax(torch.from_numpy(out16)),
                        frame_softmax(torch.from_numpy(logits)))
    print(f"bf16 per-frame softmax max|Δ| {res['softmax_max_abs_diff']:.3g}, argmax off by more "
          f"than 1 px on {res['argmax_off_on_decided']} of {res['decided_frames']} decided frames "
          f"({res['frames']} frames)")
    assert res["softmax_max_abs_diff"] < 0.02, res
    assert res["decided_frames"] > 0 and res["argmax_off_on_decided"] == 0, res
