"""TensorBoard writer (``csts_tpu/utils/tensorboard.py``; reference
``slowfast/visualization/tensorboard_vis.py:20-429``).

It writes through ``torch.utils.tensorboard.SummaryWriter`` when that
imports. Otherwise :meth:`TensorboardWriter.add_scalars` appends one JSON
record a call to ``scalars.jsonl`` in the log directory, and every figure
method returns at once.

The images (``add_ndim_array``) colour a [0, 1] array through matplotlib's
viridis, whose 256-entry table is held below (:data:`VIRIDIS`), looked up as
matplotlib's ``ListedColormap`` does; the port imports no matplotlib.
``plot_eval``'s figures come from ``eval/class_metrics.py``'s ``plot_*``,
which return None here (they need matplotlib), so no figure is written.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np

from csts_torch.utils.logging import get_logger

logger = get_logger(__name__)

# matplotlib's viridis (``matplotlib._cm_listed._viridis_data``): RGB rows for
# the 256 levels, as float64
VIRIDIS = np.array("""
0.267004 0.004874 0.329415 0.268510 0.009605 0.335427 0.269944 0.014625 0.341379
0.271305 0.019942 0.347269 0.272594 0.025563 0.353093 0.273809 0.031497 0.358853
0.274952 0.037752 0.364543 0.276022 0.044167 0.370164 0.277018 0.050344 0.375715
0.277941 0.056324 0.381191 0.278791 0.062145 0.386592 0.279566 0.067836 0.391917
0.280267 0.073417 0.397163 0.280894 0.078907 0.402329 0.281446 0.084320 0.407414
0.281924 0.089666 0.412415 0.282327 0.094955 0.417331 0.282656 0.100196 0.422160
0.282910 0.105393 0.426902 0.283091 0.110553 0.431554 0.283197 0.115680 0.436115
0.283229 0.120777 0.440584 0.283187 0.125848 0.444960 0.283072 0.130895 0.449241
0.282884 0.135920 0.453427 0.282623 0.140926 0.457517 0.282290 0.145912 0.461510
0.281887 0.150881 0.465405 0.281412 0.155834 0.469201 0.280868 0.160771 0.472899
0.280255 0.165693 0.476498 0.279574 0.170599 0.479997 0.278826 0.175490 0.483397
0.278012 0.180367 0.486697 0.277134 0.185228 0.489898 0.276194 0.190074 0.493001
0.275191 0.194905 0.496005 0.274128 0.199721 0.498911 0.273006 0.204520 0.501721
0.271828 0.209303 0.504434 0.270595 0.214069 0.507052 0.269308 0.218818 0.509577
0.267968 0.223549 0.512008 0.266580 0.228262 0.514349 0.265145 0.232956 0.516599
0.263663 0.237631 0.518762 0.262138 0.242286 0.520837 0.260571 0.246922 0.522828
0.258965 0.251537 0.524736 0.257322 0.256130 0.526563 0.255645 0.260703 0.528312
0.253935 0.265254 0.529983 0.252194 0.269783 0.531579 0.250425 0.274290 0.533103
0.248629 0.278775 0.534556 0.246811 0.283237 0.535941 0.244972 0.287675 0.537260
0.243113 0.292092 0.538516 0.241237 0.296485 0.539709 0.239346 0.300855 0.540844
0.237441 0.305202 0.541921 0.235526 0.309527 0.542944 0.233603 0.313828 0.543914
0.231674 0.318106 0.544834 0.229739 0.322361 0.545706 0.227802 0.326594 0.546532
0.225863 0.330805 0.547314 0.223925 0.334994 0.548053 0.221989 0.339161 0.548752
0.220057 0.343307 0.549413 0.218130 0.347432 0.550038 0.216210 0.351535 0.550627
0.214298 0.355619 0.551184 0.212395 0.359683 0.551710 0.210503 0.363727 0.552206
0.208623 0.367752 0.552675 0.206756 0.371758 0.553117 0.204903 0.375746 0.553533
0.203063 0.379716 0.553925 0.201239 0.383670 0.554294 0.199430 0.387607 0.554642
0.197636 0.391528 0.554969 0.195860 0.395433 0.555276 0.194100 0.399323 0.555565
0.192357 0.403199 0.555836 0.190631 0.407061 0.556089 0.188923 0.410910 0.556326
0.187231 0.414746 0.556547 0.185556 0.418570 0.556753 0.183898 0.422383 0.556944
0.182256 0.426184 0.557120 0.180629 0.429975 0.557282 0.179019 0.433756 0.557430
0.177423 0.437527 0.557565 0.175841 0.441290 0.557685 0.174274 0.445044 0.557792
0.172719 0.448791 0.557885 0.171176 0.452530 0.557965 0.169646 0.456262 0.558030
0.168126 0.459988 0.558082 0.166617 0.463708 0.558119 0.165117 0.467423 0.558141
0.163625 0.471133 0.558148 0.162142 0.474838 0.558140 0.160665 0.478540 0.558115
0.159194 0.482237 0.558073 0.157729 0.485932 0.558013 0.156270 0.489624 0.557936
0.154815 0.493313 0.557840 0.153364 0.497000 0.557724 0.151918 0.500685 0.557587
0.150476 0.504369 0.557430 0.149039 0.508051 0.557250 0.147607 0.511733 0.557049
0.146180 0.515413 0.556823 0.144759 0.519093 0.556572 0.143343 0.522773 0.556295
0.141935 0.526453 0.555991 0.140536 0.530132 0.555659 0.139147 0.533812 0.555298
0.137770 0.537492 0.554906 0.136408 0.541173 0.554483 0.135066 0.544853 0.554029
0.133743 0.548535 0.553541 0.132444 0.552216 0.553018 0.131172 0.555899 0.552459
0.129933 0.559582 0.551864 0.128729 0.563265 0.551229 0.127568 0.566949 0.550556
0.126453 0.570633 0.549841 0.125394 0.574318 0.549086 0.124395 0.578002 0.548287
0.123463 0.581687 0.547445 0.122606 0.585371 0.546557 0.121831 0.589055 0.545623
0.121148 0.592739 0.544641 0.120565 0.596422 0.543611 0.120092 0.600104 0.542530
0.119738 0.603785 0.541400 0.119512 0.607464 0.540218 0.119423 0.611141 0.538982
0.119483 0.614817 0.537692 0.119699 0.618490 0.536347 0.120081 0.622161 0.534946
0.120638 0.625828 0.533488 0.121380 0.629492 0.531973 0.122312 0.633153 0.530398
0.123444 0.636809 0.528763 0.124780 0.640461 0.527068 0.126326 0.644107 0.525311
0.128087 0.647749 0.523491 0.130067 0.651384 0.521608 0.132268 0.655014 0.519661
0.134692 0.658636 0.517649 0.137339 0.662252 0.515571 0.140210 0.665859 0.513427
0.143303 0.669459 0.511215 0.146616 0.673050 0.508936 0.150148 0.676631 0.506589
0.153894 0.680203 0.504172 0.157851 0.683765 0.501686 0.162016 0.687316 0.499129
0.166383 0.690856 0.496502 0.170948 0.694384 0.493803 0.175707 0.697900 0.491033
0.180653 0.701402 0.488189 0.185783 0.704891 0.485273 0.191090 0.708366 0.482284
0.196571 0.711827 0.479221 0.202219 0.715272 0.476084 0.208030 0.718701 0.472873
0.214000 0.722114 0.469588 0.220124 0.725509 0.466226 0.226397 0.728888 0.462789
0.232815 0.732247 0.459277 0.239374 0.735588 0.455688 0.246070 0.738910 0.452024
0.252899 0.742211 0.448284 0.259857 0.745492 0.444467 0.266941 0.748751 0.440573
0.274149 0.751988 0.436601 0.281477 0.755203 0.432552 0.288921 0.758394 0.428426
0.296479 0.761561 0.424223 0.304148 0.764704 0.419943 0.311925 0.767822 0.415586
0.319809 0.770914 0.411152 0.327796 0.773980 0.406640 0.335885 0.777018 0.402049
0.344074 0.780029 0.397381 0.352360 0.783011 0.392636 0.360741 0.785964 0.387814
0.369214 0.788888 0.382914 0.377779 0.791781 0.377939 0.386433 0.794644 0.372886
0.395174 0.797475 0.367757 0.404001 0.800275 0.362552 0.412913 0.803041 0.357269
0.421908 0.805774 0.351910 0.430983 0.808473 0.346476 0.440137 0.811138 0.340967
0.449368 0.813768 0.335384 0.458674 0.816363 0.329727 0.468053 0.818921 0.323998
0.477504 0.821444 0.318195 0.487026 0.823929 0.312321 0.496615 0.826376 0.306377
0.506271 0.828786 0.300362 0.515992 0.831158 0.294279 0.525776 0.833491 0.288127
0.535621 0.835785 0.281908 0.545524 0.838039 0.275626 0.555484 0.840254 0.269281
0.565498 0.842430 0.262877 0.575563 0.844566 0.256415 0.585678 0.846661 0.249897
0.595839 0.848717 0.243329 0.606045 0.850733 0.236712 0.616293 0.852709 0.230052
0.626579 0.854645 0.223353 0.636902 0.856542 0.216620 0.647257 0.858400 0.209861
0.657642 0.860219 0.203082 0.668054 0.861999 0.196293 0.678489 0.863742 0.189503
0.688944 0.865448 0.182725 0.699415 0.867117 0.175971 0.709898 0.868751 0.169257
0.720391 0.870350 0.162603 0.730889 0.871916 0.156029 0.741388 0.873449 0.149561
0.751884 0.874951 0.143228 0.762373 0.876424 0.137064 0.772852 0.877868 0.131109
0.783315 0.879285 0.125405 0.793760 0.880678 0.120005 0.804182 0.882046 0.114965
0.814576 0.883393 0.110347 0.824940 0.884720 0.106217 0.835270 0.886029 0.102646
0.845561 0.887322 0.099702 0.855810 0.888601 0.097452 0.866013 0.889868 0.095953
0.876168 0.891125 0.095250 0.886271 0.892374 0.095374 0.896320 0.893616 0.096335
0.906311 0.894855 0.098125 0.916242 0.896091 0.100717 0.926106 0.897330 0.104071
0.935904 0.898570 0.108131 0.945636 0.899815 0.112838 0.955300 0.901065 0.118128
0.964894 0.902323 0.123941 0.974417 0.903590 0.130215 0.983868 0.904867 0.136897
0.993248 0.906157 0.143936
""".split(), dtype=np.float64).reshape(256, 3)


def _load_json(path):
    if not path:
        return None
    with open(path) as f:
        return json.load(f)


def _normalize01(a: np.ndarray) -> np.ndarray:
    lo, hi = float(a.min()), float(a.max())
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


def _viridis(x: np.ndarray) -> np.ndarray:
    """matplotlib's ``ListedColormap.__call__`` of viridis on floats in
    [0, 1]: the level ``int(x · 256)`` in ``x``'s dtype, 1.0 on the last
    level, below 0 the first and past the end the last. Returns RGB
    (..., 3) float64."""
    xa = np.array(x, copy=True)
    xa *= 256
    xa[xa == 256] = 255
    np.clip(xa, -1, 256, out=xa)
    idx = np.clip(xa.astype(int), 0, 255)
    return VIRIDIS[idx]


def _heatmap(a: np.ndarray) -> np.ndarray:
    """2-D array -> its [0, 1]-normalised (3, H, W) viridis image, float32
    (tensorboard_vis.py:408-429)."""
    return _viridis(_normalize01(a)).transpose(2, 0, 1).astype(np.float32)


def _make_grid(tiles: np.ndarray, nrow: int, normalize: bool, heat_map: bool) -> np.ndarray:
    """(N, H, W) tiles -> a (3, ...) grid image with 1 px padding, ``nrow``
    tiles a row (torchvision's ``make_grid`` for this use)."""
    n, h, w = tiles.shape
    if normalize:
        tiles = _normalize01(tiles)
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((3, nrows * (h + 1) + 1, ncol * (w + 1) + 1), np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        img = _heatmap(tiles[i]) if heat_map else np.repeat(tiles[i][None], 3, 0)
        grid[:, r * (h + 1) + 1:r * (h + 1) + 1 + h,
             c * (w + 1) + 1:c * (w + 1) + 1 + w] = img
    return grid


class TensorboardWriter:
    """The run's scalars, and with a SummaryWriter its images and figures,
    under ``TENSORBOARD.LOG_DIR`` (default ``OUTPUT_DIR/runs-csts``)."""

    def __init__(self, cfg):
        log_dir = cfg.TENSORBOARD.LOG_DIR or os.path.join(cfg.OUTPUT_DIR, "runs-csts")
        self._writer = None
        self._jsonl = None
        self._cfg = cfg
        # class names and subsets (tensorboard_vis.py:25-88): the names json
        # may be {name: id} or [names]; a subset is a list of ids or
        # {parent: [child ids]}
        names = _load_json(cfg.TENSORBOARD.CLASS_NAMES_PATH)
        num_classes = cfg.MODEL.NUM_CLASSES
        if isinstance(names, dict):
            self.class_names = [str(i) for i in range(num_classes)]
            for name, idx in names.items():
                if 0 <= int(idx) < num_classes:
                    self.class_names[int(idx)] = name
        elif names:
            # a short list is padded with ids, so a subset cannot index past it
            self.class_names = list(names) + [str(i) for i in range(len(names), num_classes)]
        else:
            self.class_names = names
        self.cm_subset = self._flatten_subset(
            _load_json(cfg.TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH))
        self.hist_subset = self._flatten_subset(
            _load_json(cfg.TENSORBOARD.HISTOGRAM.SUBSET_PATH))
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
            logger.info("TensorBoard events at %s", log_dir)
        except Exception as e:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
            logger.info("tensorboard unavailable (%s); writing scalars.jsonl", e)

    @staticmethod
    def _flatten_subset(subset):
        """A {parent: [child ids]} subset -> the ordered union of its ids."""
        if isinstance(subset, dict):
            seen, flat = set(), []
            for children in subset.values():
                for i in children:
                    if int(i) not in seen:
                        seen.add(int(i))
                        flat.append(int(i))
            return flat
        return subset

    def add_scalars(self, data_dict: Dict[str, float], global_step: Optional[int] = None):
        """(tensorboard_vis.py:90-99)"""
        if self._writer is not None:
            for key, item in data_dict.items():
                self._writer.add_scalar(key, item, global_step)
        else:
            rec = {"step": global_step, "ts": time.time(),
                   **{k: float(v) for k, v in data_dict.items()}}
            self._jsonl.write(json.dumps(rec) + "\n")

    def plot_eval(self, preds, labels, global_step: Optional[int] = None):
        """Confusion matrices (whole and subset) and per-class top-k
        histograms (tensorboard_vis.py:101-169). ``preds``: (N, classes)
        scores or (N,) ids; ``labels``: (N,) ids. Returns at once without a
        SummaryWriter; with one, a figure that ``class_metrics`` cannot draw
        (None: no matplotlib) is not written."""
        if self._writer is None:
            return
        from csts_torch.eval.class_metrics import (
            confusion_matrix,
            plot_confusion_matrix,
            plot_topk_histogram,
        )

        cfg_tb = self._cfg.TENSORBOARD
        num_classes = self._cfg.MODEL.NUM_CLASSES
        if not (cfg_tb.CONFUSION_MATRIX.ENABLE or cfg_tb.HISTOGRAM.ENABLE):
            return
        cm = confusion_matrix(np.asarray(preds), np.asarray(labels), num_classes)
        names = self.class_names or [str(i) for i in range(num_classes)]
        if cfg_tb.CONFUSION_MATRIX.ENABLE:
            fig = plot_confusion_matrix(cm, class_names=names)
            if fig is not None:
                self._writer.add_figure("Confusion Matrix", fig, global_step)
            if self.cm_subset:
                ids = list(self.cm_subset)
                fig = plot_confusion_matrix(cm[np.ix_(ids, ids)],
                                            class_names=[names[i] for i in ids])
                if fig is not None:
                    self._writer.add_figure("Confusion Matrix Subset", fig, global_step)
        if cfg_tb.HISTOGRAM.ENABLE:
            k = cfg_tb.HISTOGRAM.TOPK
            for i in self.hist_subset or range(num_classes):
                fig = plot_topk_histogram(names[i], cm[i], k, names)
                if fig is not None:
                    self._writer.add_figure(f"Top {k} predictions by classes/{names[i]}",
                                            fig, global_step)

    def add_video(self, vid, tag: str = "Video Input", global_step=None, fps: int = 4):
        """(tensorboard_vis.py:171-182) ``vid``: (B, T, H, W, C) uint8 or
        [0, 1] float, channels-last (transposed here)."""
        if self._writer is None:
            return
        import torch

        v = torch.as_tensor(np.asarray(vid)).permute(0, 1, 4, 2, 3)
        self._writer.add_video(tag, v, global_step=global_step, fps=fps)

    def plot_weights_and_activations(
        self, arrays: Dict[str, np.ndarray], tag: str = "", normalize: bool = False,
        global_step=None, batch_idx: Optional[int] = None,
        indexing_dict: Optional[dict] = None, heat_map: bool = True,
    ):
        """Weights or activations as 2-D grids (tensorboard_vis.py:183-226);
        pairs with ``models.csts.extract_activations`` / ``get_weights``."""
        if self._writer is None:
            return
        for name, array in arrays.items():
            array = np.asarray(array)
            if indexing_dict is not None and name in indexing_dict:
                array = array[indexing_dict[name]]
            elif batch_idx is not None and array.ndim > 2:
                array = array[batch_idx]
            self.add_ndim_array(array, tag + name, normalize=normalize,
                                global_step=global_step, heat_map=heat_map)

    def add_ndim_array(self, array, name: str, nrow: Optional[int] = None,
                       normalize: bool = False, global_step=None, heat_map: bool = True):
        """An n-dim array -> a grid of 2-D heatmap tiles (tensorboard_vis.py:332-405)."""
        if self._writer is None or array is None or array.ndim == 0:
            return
        array = np.asarray(array, np.float32)
        if array.ndim == 1:
            if nrow is None:
                nrow = int(math.sqrt(array.shape[0])) or 1
            array = array[:(array.shape[0] // nrow) * nrow].reshape(-1, nrow)
        if array.ndim == 2:
            img = _heatmap(array) if heat_map else array[None]
            self._writer.add_image(name, img, global_step=global_step, dataformats="CHW")
            return
        tiles = array.reshape(-1, *array.shape[-2:])
        if nrow is None:
            nrow = max(int(math.sqrt(tiles.shape[0])), 1)
        grid = _make_grid(tiles, nrow, normalize=normalize, heat_map=heat_map)
        self._writer.add_image(name, grid, global_step=global_step, dataformats="CHW")

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
        elif self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        self.flush()
        if self._writer is not None:
            self._writer.close()
        elif self._jsonl is not None:
            self._jsonl.close()
