"""Ten and twenty training steps of the port against ``make_train_step`` at
``small_cfg(2)`` on the CPU, fp32, kldiv + EgoNCE, drop-path 0.2 with the JAX
masks injected: the question whether EgoNCE's rise over the flagship's first
steps on one fixed batch (PERF.md) comes from the port or from the model.
Every step's loss, KL and EgoNCE terms, gradient norm and LR must track the
JAX package's (``test_torch_train.py`` holds the first two steps tighter).
Marked slow: the JAX side compiles its step first.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.models.csts import build_spec
from csts_torch.train import step as tstep
from csts_tpu.train import step as jstep
from test_torch_train import BATCH, _cfgs, _jax_drop_masks, _torch_batch, small_init  # noqa: F401

torch.set_num_threads(2)

STEPS = 10


@pytest.mark.slow
def test_ten_steps_track_make_train_step(small_init):  # noqa: F811
    """The same ten steps (one fixed batch, keys 100..109) through both
    packages: each stat within 1e-3 relative of JAX's at every step. The
    step-1 bars of ``test_torch_train.py`` are 1e-5; a fault in a loss, the
    optimizer or a kernel's gradient shows within a step or two far above
    1e-3, while two correct fp32 runs drift apart slowly through Adam's
    normalisation of near-zero gradients."""
    _track(small_init, STEPS)


@pytest.mark.slow
def test_twenty_steps_track_make_train_step(small_init):  # noqa: F811
    """Twenty steps (keys 100..119), the longer trajectory: the same 1e-3
    relative bar, or 1e-6 absolute. By step 12 EgoNCE has fallen to ~4e-5:
    it is -log of a softmax diagonal within 4e-5 of 1, where one fp32 ulp
    (6e-8) of the probability is 1.5e-3 of the loss, so there the bar is a
    few ulps of the probability, not a share of the loss."""
    _track(small_init, 2 * STEPS, abs_floor=1e-6)


def _track(small_init, steps: int, abs_floor: float = 0.0) -> None:  # noqa: F811
    jspec, params, batch = small_init
    jcfg, tcfg = _cfgs()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = [jax.random.PRNGKey(100 + i) for i in range(steps)]

    state, tx = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(0))
    jtrain = jstep.make_train_step(jcfg, jspec, tx, steps_per_epoch=10)
    want = []
    for key in keys:
        state, st, _ = jtrain(state, jbatch, key)
        want.append({k: float(v) for k, v in st.items()})

    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    tstate = tstep.create_train_state(tcfg, build_spec(tcfg), state_dict=sd, device="cpu")
    ttrain = tstep.make_train_step(tcfg, build_spec(tcfg), steps_per_epoch=10)
    tb = _torch_batch(batch)
    got = []
    for key in keys:
        st, _ = ttrain(tstate, tb, None, drop=_jax_drop_masks(jspec, key, BATCH))
        got.append({k: float(v) for k, v in st.items()})

    worst = {}
    for i, (w, g) in enumerate(zip(want, got)):
        for name, value in w.items():
            rel = abs(g[name] - value) / max(abs(value), 1e-12)
            worst[name] = max(worst.get(name, 0.0), rel)
            assert rel <= 1e-3 or abs(g[name] - value) <= abs_floor, (i, name, g[name], value)
    egonce = [w["egonce_loss"] for w in want]
    print(f"egonce over {steps} steps (JAX): {egonce}; port's worst relative gap per stat: "
          f"{worst}")
