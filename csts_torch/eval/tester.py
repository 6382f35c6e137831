"""Evaluation entry point: ``test(cfg)`` (``csts_tpu/eval/tester.py``; reference
``tools/test_avgaze_net.py:21-141``).

Loads the checkpoint (an npz TrainState, its EMA weights with TEST.USE_EMA,
a reference ``.pyth`` or a ``torch.save``d state dict; with none of those,
the orbax backend's latest step in OUTPUT_DIR),
streams the test split through the eval step (the model's eval forward and
the per-frame softmax; on CUDA the hand-written kernels, by ``block_route``),
accumulates the whole-test-set adaptive F1 and AUC, and emits the
``test_final`` JSON record. It runs on CUDA unless ``device`` names another
device, and raises with no CUDA and no device given.

With a process group each rank scores its stripes of the test batches (a
rank whose stripe of the short final batch is empty runs nothing for it),
then the ranks exchange their meters once: the views of a clip that
straddle two stripes are combined first, so such a clip is scored once on
all its views, as in one process (``TestGazeMeter.merge_ranks``); every rank
returns the whole split's record. Rank 0 writes the results npz, merged
over the ranks.
"""

from __future__ import annotations

import os
import pprint
from typing import Optional

import numpy as np
import torch

from csts_torch import resolve_device
from csts_torch.config import Config
from csts_torch.data import loader as loader_lib
from csts_torch.eval import metrics
from csts_torch.models.csts import CSTS, build_spec, init_params
from csts_torch.parallel import collectives, mesh
from csts_torch.train import step as step_lib
from csts_torch.train.meters import TestGazeMeter
from csts_torch.utils import checkpoint as cu
from csts_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)


def _collect_results(results: dict, preds: torch.Tensor, labels: torch.Tensor, indices) -> None:
    """Append one batch's per-row outputs (the rescaled heatmap's argmax as a
    normalised gaze point, the label's xy and gaze type, the dataset index),
    skipping rows whose index was seen before."""
    seen = set(int(i) for i in results["index"])
    fresh = []
    for i in indices.tolist():
        fresh.append(i not in seen)
        seen.add(i)
    if not any(fresh):
        return
    keep = torch.tensor([j for j, f in enumerate(fresh) if f], dtype=torch.long)
    preds = preds[keep.to(preds.device)]
    b, t, h, w = preds.shape
    flat_idx = preds.reshape(b, t, h * w).argmax(dim=-1).cpu().numpy()
    pred_xy = np.stack(
        [(flat_idx % w + 0.5) / w, (flat_idx // w + 0.5) / h], axis=-1
    ).astype(np.float32)
    labels = labels[keep.to(labels.device)].cpu().numpy()
    results["index"].extend(int(i) for i in indices[keep].tolist())
    results["pred_xy"].extend(pred_xy)
    results["label_xy"].extend(labels[:, :, :2].astype(np.float32))
    results["gaze_type"].extend(labels[:, :, 2].astype(np.int32))


def _merge_results(per_rank: list) -> dict:
    """The ranks' results (in rank order) as one, a dataset index kept once."""
    merged = {k: [] for k in per_rank[0]}
    seen = set()
    for res in per_rank:
        for row, i in enumerate(res["index"]):
            if int(i) in seen:
                continue
            seen.add(int(i))
            for k, v in res.items():
                merged[k].append(v[row])
    return merged


def _results_path(cfg: Config) -> Optional[str]:
    """TEST.SAVE_RESULTS_PATH under OUTPUT_DIR unless absolute, ending in .npz;
    its directory is made now, not after the loop."""
    if not cfg.TEST.SAVE_RESULTS_PATH:
        return None
    path = cfg.TEST.SAVE_RESULTS_PATH
    if not os.path.isabs(path):
        path = os.path.join(cfg.OUTPUT_DIR, path)
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path


def test(cfg: Config, device=None) -> dict:
    """Scores the test split; returns the ``test_final`` stats (f1, recall,
    precision, threshold, auc and the memory fields)."""
    device = resolve_device(device)
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Test with config:")
    logger.info(pprint.pformat(cfg.dump()))

    spec = build_spec(cfg)
    # the loader's workers stop when the loop ends, on success or error
    with loader_lib.construct_loader(cfg, "test", device) as test_loader:
        num_views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        if len(test_loader.dataset) % num_views:
            raise ValueError(f"{len(test_loader.dataset)} test rows do not divide into "
                             f"{num_views} views a clip")
        # TEST.SAVE_RESULTS_PATH: the compact per-row outputs (predicted gaze
        # point, label xy and gaze type, dataset index) as an .npz sorted by index
        results_path = _results_path(cfg)
        results = ({"index": [], "pred_xy": [], "label_xy": [], "gaze_type": []}
                   if results_path else None)

        # the loader's workers start first, while the model is built and loaded
        with loader_lib.DevicePrefetcher(iter(test_loader), device,
                                         depth=cfg.DATA_LOADER.PREFETCH_DEPTH) as prefetch:
            model = CSTS(spec)
            cu.load_test_checkpoint(cfg, model, init=lambda: init_params(
                model, torch.Generator().manual_seed(cfg.RNG_SEED)))
            if cfg.TRAIN.MIXED_PRECISION:
                model = model.to(torch.bfloat16)  # cast the weights once, not per op
            model = model.to(device).eval()
            if mesh.axis_size(mesh.MODEL_AXIS) > 1:  # tensor-parallel eval, as JAX's
                mesh.split_model(model)
            eval_step = step_lib.make_eval_step(cfg, spec)
            meter = TestGazeMeter(cfg.TEST.DATASET, num_views=num_views, device=device)

            meter.iter_tic()
            for cur_iter, batch in enumerate(prefetch):
                meter.data_toc()
                preds = metrics.minmax_rescale(eval_step(model, batch))
                meter.update_stats(preds, batch["labels_hm"], batch["labels"],
                                   indices=batch["index"])
                if results is not None:
                    _collect_results(results, preds, batch["labels"], batch["index"])
                meter.iter_toc()  # update_stats read the batch's sums back
                meter.log_iter_stats(cur_iter, cfg.LOG_PERIOD)
                meter.iter_tic()

    if results is not None:
        results = _merge_results(collectives.gather_objects(results))
        if collectives.is_master_proc():
            order = np.argsort(np.asarray(results["index"]))
            np.savez(results_path, **{k: np.asarray(v)[order] for k, v in results.items()})
            logger.info("Saved %d test results to %s", len(order), results_path)
    if collectives.world_size() > 1:
        meter.merge_ranks(collectives.gather_objects(meter.pending),
                          collectives.gather_objects(meter.stream.state()))
    stats = meter.finalize_metrics()
    logger.info("Testing finished: %s", stats)
    return stats
