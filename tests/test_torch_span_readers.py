"""The benchmark's readers of the port's spans (``benchmark/metrics/``
``step_forward_ms.train``, ``step_backward_ms.train``, ``step_update_ms.train``,
``encoder_ms.eval``, ``fusion_ms.eval``, ``decoder_ms.eval``, over
``benchmark/spans.py``) on the CPU: None on the other kind of cell, on an
empty store and on a program without spans; only the spans of the stretch
that traces the card alone are read, not those of the host-traced stretch
after it; on a store filled by steps and forwards under profilers, the
medians computed by hand from ``tracing.records()`` (on the CPU, with no
device times, None); on records with device times, the sums a step and the
medians; and ``BENCHMARK.json`` lists each reader for its cells alone.
"""

import os
import statistics
import sys

import pytest
import torch
from test_torch_tracing import csts_eval, one_step, recording, train_setup

import csts_torch.utils
from benchmark import harness, spans
from csts_torch.utils import tracing

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ("step_forward_ms.train", "step_backward_ms.train", "step_update_ms.train")
EVAL = ("encoder_ms.eval", "fusion_ms.eval", "decoder_ms.eval")
CELLS = {"step_forward_ms.train": ["csts_train_b16"], "step_backward_ms.train": ["csts_train_b16"],
         "step_update_ms.train": ["csts_train_b16"],
         "encoder_ms.eval": ["csts_eval_b32", "mvit_k400_eval_b32"],
         "fusion_ms.eval": ["csts_eval_b32"], "decoder_ms.eval": ["csts_eval_b32"]}
SPAN = {"step_forward_ms.train": "csts.train_step.forward",
        "step_backward_ms.train": "csts.train_step.backward",
        "step_update_ms.train": "csts.train_step.update",
        "encoder_ms.eval": "csts.model.encoders", "fusion_ms.eval": "csts.model.fusion",
        "decoder_ms.eval": "csts.model.decoder"}
TRAIN_CTX = {"train": True, "trace": {}, "traced_steps": 4}
EVAL_CTX = {"eval": True, "trace": {}}


def reader(name: str):
    path = harness.find(REPO, "metrics", name, ".py")
    return harness.load_module(path, "span_reader_" + name.replace(".", "_")).read


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


def own_ctx(name: str) -> dict:
    return dict(TRAIN_CTX if name in TRAIN else EVAL_CTX)


def other_ctx(name: str) -> dict:
    return dict(EVAL_CTX if name in TRAIN else TRAIN_CTX)


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_none_on_an_empty_store(name):
    assert reader(name)(own_ctx(name)) is None


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_none_on_the_other_cell(name, card_run):
    assert reader(name)(other_ctx(name)) is None
    assert reader(name)(own_ctx(name)) is not None


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_none_from_a_program_without_spans(name, card_run, monkeypatch):
    """A program without ``csts_torch.utils.tracing`` (as before the spans):
    the reader finds nothing to read and does not raise."""
    monkeypatch.delattr(csts_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "csts_torch.utils.tracing", None)
    assert reader(name)(own_ctx(name)) is None


@pytest.mark.parametrize("n", range(1, 13))
def test_first_calls_inverts_traced_calls(n):
    """``benchmark.trace.traced_calls`` makes n + max(1, n // 2) calls."""
    assert spans.first_calls(n + max(1, n // 2)) == n


@pytest.mark.parametrize("count", [0, 1, 5, 8, 11])
def test_first_calls_none_where_no_stretch_gives_the_count(count):
    assert spans.first_calls(count) is None


def test_cpu_steps_and_forwards_under_two_profilers():
    """The two stretches of ``traced_calls`` at n = 2 (two calls, then one
    under a second profiler) over CPU training steps and CSTS forwards: with
    no device times every reader reads None; with each record's host ms put
    in as its device ms, each reads the median over the first two calls,
    computed by hand from ``tracing.records()``."""
    state, step, batch = train_setup()
    model, eval_step, eval_batch = csts_eval()
    for n in (2, 1):
        with recording():
            for _ in range(n):
                one_step(state, step, batch)
        with recording(), torch.inference_mode():
            for _ in range(n):
                eval_step(model, eval_batch)
    train_ctx, eval_ctx = dict(TRAIN_CTX, traced_steps=2), dict(EVAL_CTX)
    for name in TRAIN + EVAL:
        assert reader(name)(train_ctx if name in TRAIN else eval_ctx) is None
    recs = tracing.records()
    for r in recs:
        r.device_ms = r.host_ms
    steps = [r.id for r in recs if r.name == "csts.train_step"]
    assert len(steps) == 3
    for name in TRAIN:
        sums = [sum(r.device_ms for r in recs if r.name == SPAN[name] and r.parent == s)
                for s in steps[:2]]
        assert reader(name)(train_ctx) == statistics.median(sums)
    for name in EVAL:
        top = [r.device_ms for r in recs if r.name == SPAN[name] and r.parent is None]
        assert len(top) == 3
        assert reader(name)(eval_ctx) == statistics.median(top[:2])


def record(i, name, parent, device_ms):
    return tracing.Record(i, name, parent, 0, 1_000_000, device_ms)


def device_records():
    """Hand-made records, as a card's run of ``traced_calls`` at n = 4 leaves
    them: four steps of the card-only stretch (the second with two forward
    and two backward spans, as micro-batches make them), then two of the
    host-traced stretch, slower; a forward outside any step; and six CSTS
    forwards, the last two host-traced."""
    step, fwd, bwd, upd = "csts.train_step", *(f"csts.train_step.{p}"
                                               for p in ("forward", "backward", "update"))
    recs, i = [], 0
    phases = [[(fwd, 10.0), (bwd, 15.0), (upd, 5.0)],
              [(fwd, 6.0), (bwd, 9.0), (fwd, 7.0), (bwd, 11.0), (upd, 4.0)],
              [(fwd, 20.0), (bwd, 25.0), (upd, 3.0)],
              [(fwd, 12.0), (bwd, 18.0), (upd, 6.0)],
              [(fwd, 90.0), (bwd, 95.0), (upd, 30.0)],
              [(fwd, 91.0), (bwd, 96.0), (upd, 31.0)]]
    for phs in phases:
        top = i
        recs.append(record(top, step, None, sum(ms for _, ms in phs)))
        for name, ms in phs:
            i += 1
            recs.append(record(i, name, top, ms))
        i += 1
    recs.append(record(i, fwd, None, 99.0))
    for times in [(8.0, 2.0, 5.0), (6.0, 1.0, 4.0), (7.0, 3.0, 6.0), (9.0, 2.5, 7.0),
                  (50.0, 40.0, 60.0), (51.0, 41.0, 61.0)]:
        for stage, ms in zip(("encoders", "fusion", "decoder"), times):
            i += 1
            recs.append(record(i, f"csts.model.{stage}", None, ms))
    return recs


@pytest.fixture
def card_run(monkeypatch):
    """``tracing.records()`` reads :func:`device_records`."""
    recs = device_records()
    monkeypatch.setattr(tracing, "records", lambda: list(recs))
    return recs


# the card-only stretch's, per step: forward 10, 13, 20, 12; backward 15, 20, 25, 18;
# update 5, 4, 3, 6; per call: encoders 8, 6, 7, 9; fusion 2, 1, 3, 2.5; decoder 5, 4, 6, 7
BY_HAND = {"step_forward_ms.train": 12.5, "step_backward_ms.train": 19.0,
           "step_update_ms.train": 4.5, "encoder_ms.eval": 7.5, "fusion_ms.eval": 2.25,
           "decoder_ms.eval": 5.5}


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_medians_of_device_times(name, card_run):
    assert reader(name)(own_ctx(name)) == pytest.approx(BY_HAND[name], rel=1e-12)


@pytest.mark.parametrize("name", EVAL)
def test_none_where_the_store_fits_no_stretch(name, card_run):
    """Five forwards: no stretch of ``traced_calls`` leaves five, so the
    reader cannot tell the card-only calls and reads nothing."""
    del card_run[-3:]
    assert reader(name)(own_ctx(name)) is None


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_manifest_lists_each_reader_for_its_cells(name):
    man = harness.manifest(REPO)
    (entry,) = [m for m in man["per_layer"] if m["name"] == name]
    assert entry["workloads"] == CELLS[name]
    assert entry["layer"] == "model step" and entry["source"] == "program_span"
    assert entry["moves"] == ("train_clips_per_s" if name in TRAIN else "eval_clips_per_s")
    for cell in [w["name"] for w in man["workloads"]]:
        listed = [m["name"] for m in harness.cell_metrics(man, cell, True)]
        assert (name in listed) == (cell in CELLS[name])
