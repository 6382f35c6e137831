"""The analytic operation counts of ``benchmark/counts.py``."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, traffic, weights
from benchmark.reference import arch, models
from benchmark.tests import support


def _load(name: str) -> dict:
    return support.load(f"{support.ROOT}/benchmark/configs/{name}.json")["set"]


def test_classifier_forward_is_twice_the_published_multiply_adds():
    # MViT-B 16x4 is published at 70.5 G multiply-adds a clip (Fan et al.,
    # 2021, Table 3); the count here adds the cls token's row and the head,
    # and the paper rounds to 0.1 G, so 1% holds both
    a = arch.mvit_arch(_load("mvit_b_16x4_k400"))
    assert counts.mvit_forward_flops(a) == pytest.approx(2 * 70.5e9, rel=0.01)


def test_counts_do_not_depend_on_the_kernels():
    from csts_torch.kernels import attention as ka

    a = arch.csts_arch(_load("csts_b_16x4"))
    on = (counts.csts_forward_flops(a), counts.csts_train_flops(a))
    with ka.disabled():
        off = (counts.csts_forward_flops(a), counts.csts_train_flops(a))
    assert on == off


def test_training_count_is_forward_plus_backward_without_recompute():
    a = arch.csts_arch(_load("csts_b_16x4"))
    fwd = counts.csts_forward_flops(a, embed=True)
    stems = 2 * 96 * 3 * 147 * 4 * 64 * 64 + 2 * 96 * 1 * 147 * 4 * 64 * 64
    assert counts.csts_train_flops(a) == fwd + 2 * fwd - stems
    assert fwd - counts.csts_forward_flops(a) == 2 * 2 * 768 * 256


@pytest.mark.parametrize("config", ["csts_b_16x4", "mvit_b_16x4_k400"])
def test_forward_count_matches_torch_flop_counter(config):
    # the reference forward at the reduced size under torch's own counter of
    # products and convolutions: the same operations, counted independently
    # (the spatial fusion's masked attention is dense in both)
    keys = support.small_config(config, {"DATA.NUM_FRAMES": 8, "MODEL.NUM_CLASSES": 11}
                                if config.startswith("mvit") else {}, fp32=True)["set"]
    gen = traffic.generator(5, "inputs")
    if config.startswith("csts"):
        a = arch.csts_arch(keys)
        P = weights.make(5, models.csts_params(a), "cpu")
        x = traffic.clips(1, a.frames, a.crop, a.freq_bins, a.window, gen, torch.float32)
        fn, want = (lambda: models.csts_forward(P, a, x["video"], x["audio"])), \
            counts.csts_forward_flops(a)
    else:
        a = arch.mvit_arch(keys)
        P = weights.make(5, models.mvit_params(a), "cpu")
        x = traffic.clips(1, a.frames, a.crop, 0, 0, gen, torch.float32, audio=False)
        fn, want = (lambda: models.mvit_forward(P, a, x["video"])), counts.mvit_forward_flops(a)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn()
    assert fc.get_total_flops() == want


def test_kernel_work_of_an_attention_launch():
    q = torch.zeros(2, 4, 64, 32, dtype=torch.bfloat16)
    k = v = torch.zeros(2, 4, 16, 32, dtype=torch.bfloat16)
    f, b = counts.kernel_work("K1", (q, k, v, 0.1, None, False))
    assert f == 4 * 2 * 4 * 64 * 16 * 32
    assert b == 2 * (2 * q.numel() + k.numel() + v.numel())  # q read, out written, k and v read
    fb, bb = counts.kernel_work("B8", (q, k, v, q, q, 0.1, None))
    assert fb == 2 * f and bb == 2 * (2 * (q.numel() + k.numel() + v.numel()) + 2 * q.numel()) \
        + 4 * 2 * 4 * 64
    assert counts.least_seconds(f, b) == max(f / counts.PEAK_FLOPS, b / counts.PEAK_BYTES)


def test_kernel_work_is_part_of_the_models_count():
    # every launch the forward makes of the port's kernels is counted, from
    # its arguments as the program passes them, and their products are a
    # part of the model's own count (on the CPU the wrappers run their plain
    # twins with the same arguments; K1's count sits in its CUDA launch,
    # ``_attention_fwd``, which the CPU's custom op does not reach)
    from csts_torch.models.csts import CSTS, build_spec

    from benchmark import program
    from benchmark.trace import KernelWork

    keys = support.small_config("csts_b_16x4", {}, fp32=True)["set"]
    a = arch.csts_arch(keys)
    model = CSTS(build_spec(program.program_cfg(keys)))
    model.load_state_dict(weights.make(5, models.csts_params(a), "cpu"), strict=True)
    x = traffic.clips(2, a.frames, a.crop, a.freq_bins, a.window, traffic.generator(5, "inputs"),
                      torch.float32)
    with torch.no_grad(), KernelWork(device="cpu") as kw:
        model.eval()(x["video"], x["audio"])
    assert {"K2", "K3", "B3", "B4", "B5"} <= set(kw.work)
    assert all(w[0] > 0 and w[2] > 0 and w[3] > 0 for w in kw.work.values())
    assert 0 < sum(w[1] for w in kw.work.values()) <= 2 * counts.csts_forward_flops(a)
