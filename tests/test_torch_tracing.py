"""The port's spans (``csts_torch/utils/tracing.py``) on the CPU, at the reduced
family members (crop 32, depth 4, width 16): off without a profiler (nothing
recorded, no ``record_function``, no CUDA event), the training step's and
the forwards' spans nested as the program runs them while a profiler records,
the same names in the profiler's own trace, results bit-identical with and
without a profiler, the store bounded, and no span inside a graph that
``torch.export`` traces or while a CUDA graph is being captured.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from csts_torch import presets
from csts_torch.config import get_cfg
from csts_torch.models.csts import CSTS, build_spec, init_params
from csts_torch.models.mvit_classifier import MViT, build_mvit_spec, init_mvit_params
from csts_torch.train import step as tstep
from csts_torch.utils import tracing

torch.set_num_threads(2)

BATCH = 2
STEP = "csts.train_step"
PHASES = ("csts.train_step.forward", "csts.train_step.backward", "csts.train_step.update")
STAGES = ("csts.model.encoders", "csts.model.fusion", "csts.model.decoder")


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def csts_batch(cfg, seed: int = 1) -> dict:
    """A training batch of the reduced CSTS: clips, audio and per-frame label maps."""
    g = torch.Generator().manual_seed(seed)
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    hm = torch.rand(BATCH, t, s // 4, s // 4, generator=g)
    return {"video": torch.randn(BATCH, t, s, s, 3, generator=g),
            "audio": torch.randn(BATCH, t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1,
                                 generator=g),
            "labels_hm": hm / hm.sum((2, 3), keepdim=True)}


def train_setup(seed: int = 0):
    """(the training state, its step, a batch) of ``presets.small_cfg``."""
    cfg = presets.small_cfg(BATCH)
    spec = build_spec(cfg)
    state = tstep.create_train_state(cfg, spec, torch.Generator().manual_seed(seed), device="cpu")
    return state, tstep.make_train_step(cfg, spec, 10), csts_batch(cfg)


def one_step(state, step, batch):
    return step(state, batch, torch.Generator().manual_seed(2))


def csts_eval():
    """(the reduced CSTS at eval, its eval step, a batch)."""
    cfg = presets.small_cfg(BATCH)
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(0))
    return model.eval(), tstep.make_eval_step(cfg, spec), csts_batch(cfg)


def mvit_eval():
    """(the reduced MViT classifier at eval, with the cls token, a batch of
    clips): ``tests/test_torch_classifier.py``'s small config."""
    cfg = get_cfg()
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 8
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.CLS_EMBED_ON = True
    cfg.MVIT.SEP_POS_EMBED = True
    cfg.MVIT.DEPTH = 4
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.DIM_MUL = [[1, 2.0], [2, 2.0], [3, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [2, 2.0], [3, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 8, 8]
    cfg.MODEL.MODEL_NAME = "MVIT"
    cfg.MODEL.NUM_CLASSES = 11
    model = MViT(build_mvit_spec(cfg))
    init_mvit_params(model, torch.Generator().manual_seed(0))
    video = torch.randn(BATCH, 8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    return model.eval(), video


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_no_profiler_no_record(monkeypatch):
    """Without a profiler a training step and an eval forward record nothing,
    and neither open a ``record_function`` nor make a CUDA event."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span did work without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    state, step, batch = train_setup()
    one_step(state, step, batch)
    model, eval_step, batch = csts_eval()
    eval_step(model, batch)
    assert tracing.records() == []
    assert tracing.span("x") is tracing.span("y")  # the shared, stateless off span


def test_step_records_its_phases_nested():
    state, step, batch = train_setup()
    with recording():
        one_step(state, step, batch)
    recs = by_name(tracing.records())
    (top,) = recs[STEP]
    assert top.parent is None
    prev_end = top.host_start_ns
    for name in PHASES:
        (phase,) = recs[name]
        assert phase.parent == top.id
        assert prev_end <= phase.host_start_ns <= phase.host_end_ns <= top.host_end_ns
        prev_end = phase.host_end_ns
    forward = recs[PHASES[0]][0]
    for name in STAGES:  # the model's spans inside the step's forward
        (stage,) = recs[name]
        assert stage.parent == forward.id
    assert all(r.device_ms is None for rs in recs.values() for r in rs)  # no card here


@pytest.mark.parametrize("loss,forwards,models", [("kldiv+egonce", 3, 4), ("kldiv", 2, 2)])
def test_micro_batches_sum_into_one_step(loss, forwards, models):
    """Two micro-batches: with EgoNCE the GradCache two-pass (pass A's
    forwards in one span, then pass B's one a micro-batch), without it one
    forward a micro-batch; a backward a micro-batch and the gradient sync's.
    ``models``: the model's forwards (two passes of two, or one)."""
    cfg = presets.small_cfg(BATCH)
    cfg.MODEL.LOSS_FUNC = loss
    spec = build_spec(cfg)
    state = tstep.create_train_state(cfg, spec, torch.Generator().manual_seed(0), device="cpu")
    step = tstep.make_train_step(cfg, spec, 10, accum_steps=2)
    with recording():
        one_step(state, step, csts_batch(cfg))
    recs = by_name(tracing.records())
    (top,) = recs[STEP]
    counts = {name: len(recs[name]) for name in PHASES}
    assert counts == {PHASES[0]: forwards, PHASES[1]: 3, PHASES[2]: 1}
    assert all(r.parent == top.id for name in PHASES for r in recs[name])
    assert all(len(recs[name]) == models for name in STAGES)


@pytest.mark.parametrize("model", ["csts", "mvit"])
def test_forward_records_its_stages(model):
    if model == "csts":
        net, eval_step, batch = csts_eval()
        with recording():
            eval_step(net, batch)
        expected = STAGES
    else:
        net, video = mvit_eval()
        with recording(), torch.inference_mode():
            net(video)
        expected = STAGES[:1]
    recs = by_name(tracing.records())
    assert sorted(recs) == sorted(expected)
    assert all(len(rs) == 1 and rs[0].parent is None for rs in recs.values())
    ends = [recs[n][0] for n in expected]
    for a, b in zip(ends, ends[1:]):
        assert a.host_end_ns <= b.host_start_ns


def test_spans_are_the_profilers_user_annotations():
    state, step, batch = train_setup()
    with recording() as prof:
        one_step(state, step, batch)
    annotations = {e.name for e in prof.events() if e.is_user_annotation}
    assert {STEP, *PHASES, *STAGES} <= annotations
    assert {r.name for r in tracing.records()} == {STEP, *PHASES, *STAGES}


def test_results_bit_identical_under_a_profiler():
    out = []
    for traced in (False, True):
        state, step, batch = train_setup()
        model, eval_step, eval_batch = csts_eval()
        with recording() if traced else contextlib.nullcontext():
            stats, _ = one_step(state, step, batch)
            heat = eval_step(model, eval_batch)
        out.append((stats, {n: p.detach().clone() for n, p in state.model.named_parameters()},
                    heat))
    (s0, p0, h0), (s1, p1, h1) = out
    assert len(tracing.records()) == 1 + len(PHASES) + 2 * len(STAGES)
    for k in ("loss", "kldiv_loss", "egonce_loss", "grad_norm"):
        assert torch.equal(s0[k], s1[k]), k
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert torch.equal(h0, h1)


def test_store_is_a_bounded_ring_read_without_clearing():
    with recording():
        for _ in range(tracing.RING + 10):
            with tracing.span("ring"):
                pass
    recs = tracing.records()
    assert len(recs) == tracing.RING
    ids = [r.id for r in recs]
    assert ids == sorted(ids) and ids[-1] - ids[0] == tracing.RING - 1
    assert tracing.records() == recs
    tracing.clear()
    assert tracing.records() == []


def test_no_span_while_a_cuda_graph_is_captured(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with recording():
        with tracing.span("captured"):
            pass
    assert tracing.records() == []


@pytest.mark.parametrize("strict", [False, True])
def test_export_under_a_profiler_keeps_spans_out(strict):
    """``torch.export`` of the CSTS forward while a profiler records (the
    serving export's route, and dynamo's): no profiler op in the graph, no
    record in the store."""
    model, _, batch = csts_eval()
    with recording(), torch.no_grad():
        program = torch.export.export(model, (batch["video"], batch["audio"]), strict=strict)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert tracing.records() == []
