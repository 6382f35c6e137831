"""Checkpoints: the JAX package's npz TrainState archives, read and written,
and reference ``.pyth`` files for fine-tune init and evaluation
(``csts_tpu/utils/checkpoint.py``; reference ``slowfast/utils/checkpoint.py``
:36-143, :579-659).

An npz checkpoint holds one ``leaf_%05d`` array per leaf of the JAX
package's flattened TrainState, and a JSON sidecar (``<file>.json``) with
``epoch`` (the last completed epoch), ``num_leaves``, ``iter`` for a
mid-epoch save, and ``cfg``. With P the parameter leaves
(:func:`csts_torch.convert.to_jax.param_leaf_names` gives their names,
shapes and order), the leaves are, in order:

* P params (fp32, channels-last, the JAX tree's layout);
* the optimizer: for AdamW/Adam the update count (int32), the learning rate
  last set (fp32), Adam's count (int32), P first moments and P second
  moments; for SGD the count, the learning rate and P momentum traces;
* the step (int32);
* P EMA weights, only when SOLVER.EMA_DECAY > 0.

The moments convert with the params' own transposes; Adam's count is
``torch.optim.AdamW``'s per-parameter ``step``.

With a process group rank 0 writes the same archive whatever the sharding
(ZeRO-1's moments consolidated there, FSDP's shards gathered whole), the
other ranks wait at a barrier, and every rank reads a file after one. Under SOLVER.BF16_MOMENTS
the JAX package writes its bf16 first moments as raw 2-byte ``|V2`` leaves
(numpy has no bfloat16), which its own ``load_checkpoint`` cannot read back;
the port reads them, and writes bf16 leaves as fp32, which holds every bf16
value exactly and loads into either package.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from csts_torch.convert import from_torch, to_jax
from csts_torch.parallel import collectives
from csts_torch.utils.logging import get_logger

logger = get_logger(__name__)

CHECKPOINT_DIR = "checkpoints"
# checkpoint_epoch_{completed+1:05d}.npz, with _iter_{i:07d} for a mid-epoch
# save (i iterations of that epoch done): a lexical sort is recency order,
# ..._00005.npz < ..._00005_iter_0000012.npz < ..._00006.npz
_NAME_RE = re.compile(r"checkpoint_epoch_(\d+)(?:_iter_(\d+))?\.npz$")


def checkpoint_dir(output_dir: str) -> str:
    return os.path.join(output_dir, CHECKPOINT_DIR)


def checkpoint_path(output_dir: str, epoch: int, iter_idx: Optional[int] = None) -> str:
    name = f"checkpoint_epoch_{epoch + 1:05d}"
    if iter_idx is not None:
        name += f"_iter_{iter_idx:07d}"
    return os.path.join(checkpoint_dir(output_dir), name + ".npz")


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    d = checkpoint_dir(output_dir)
    if not os.path.isdir(d):
        return None
    names = [n for n in os.listdir(d) if _NAME_RE.search(n)]
    return os.path.join(d, sorted(names)[-1]) if names else None


def has_checkpoint(output_dir: str) -> bool:
    return get_last_checkpoint(output_dir) is not None


def checkpoint_meta(path: str) -> dict:
    """The JSON sidecar: epoch, num_leaves, the optional mid-epoch ``iter``, cfg."""
    with open(path + ".json") as f:
        return json.load(f)


# --- the TrainState layout ------------------------------------------------------


def _layout(model: nn.Module):
    """[(path, Leaf)] of the model's parameters in the JAX flatten order."""
    return to_jax.layout([n for n, _ in model.named_parameters()])


def _jax_leaves(named: Dict[str, torch.Tensor], lay) -> List[np.ndarray]:
    """Tensors by parameter name -> the JAX tree's leaves in flatten order
    (each permuted on its own device, then copied to the host)."""
    return [to_jax.to_jax_leaf(named[leaf.name], leaf.perm) for _, leaf in lay]


def state_leaves(state) -> Optional[List[np.ndarray]]:
    """The port's ``train.step.TrainState`` as the JAX TrainState's leaves.
    Every rank calls it (sharded state is gathered); the ranks other than
    0 get None."""
    opt = state.optimizer
    lay = _layout(state.model)
    params = {n: collectives.whole(p) for n, p in state.model.named_parameters()}
    ema = None if state.ema is None else {n: collectives.whole(t) for n, t in state.ema.items()}
    moments = opt.moments()
    if not collectives.is_master_proc():
        return None
    count, first, second = moments
    step = np.asarray(state.step, np.int32)
    leaves = _jax_leaves(params, lay)
    if opt.method == "sgd":
        leaves += [step, np.asarray(opt.lr, np.float32)] + _jax_leaves(first, lay)
    else:
        leaves += [step, np.asarray(opt.lr, np.float32), np.asarray(count, np.int32)]
        leaves += _jax_leaves(first, lay) + _jax_leaves(second, lay)
    leaves.append(step)
    if ema is not None:
        leaves += _jax_leaves(ema, lay)
    return leaves


def save_checkpoint(output_dir: str, state, epoch: int, cfg=None,
                    iter_idx: Optional[int] = None) -> str:
    """Writes ``state`` as the JAX package's npz TrainState and its sidecar
    (rank 0; every rank calls it and returns after the write); returns the
    path. ``epoch`` is the last completed epoch; ``iter_idx`` (mid-epoch
    saves only) the iterations of epoch ``epoch + 1`` done."""
    leaves = state_leaves(state)
    path = checkpoint_path(output_dir, epoch, iter_idx)
    if leaves is not None:
        os.makedirs(checkpoint_dir(output_dir), exist_ok=True)
        np.savez(path, **{f"leaf_{i:05d}": leaf for i, leaf in enumerate(leaves)})
        meta = {"epoch": epoch, "num_leaves": len(leaves)}
        if iter_idx is not None:
            meta["iter"] = iter_idx
        if cfg is not None:
            meta["cfg"] = cfg.dump()
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
        logger.info("Saved checkpoint to %s", path)
    collectives.barrier()
    return path


def _float_leaf(arr: np.ndarray) -> np.ndarray:
    """A leaf as fp32; a ``|V2`` leaf holds bf16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float32, copy=False)


def _check_shapes(path: str, lay, leaves, offset: int, named) -> None:
    from csts_torch.parallel import mesh

    for i, ((jpath, leaf), arr) in enumerate(zip(lay, leaves)):
        shape = mesh.whole_shape(named[leaf.name])
        want = tuple(shape[j] for j in leaf.perm) if leaf.perm else shape
        if tuple(arr.shape) != want:
            raise ValueError(f"{path} leaf {offset + i} ({jpath}): shape {arr.shape}, "
                             f"the model's {want}")


def _from_jax(lay, leaves, named) -> Dict[str, torch.Tensor]:
    """The JAX tree's leaves in flatten order -> fp32 tensors by parameter
    name, on each parameter's device (permuted back there)."""
    out = {}
    for (_, leaf), arr in zip(lay, leaves):
        t = torch.from_numpy(_float_leaf(arr)).to(named[leaf.name].device)
        out[leaf.name] = t.permute(*np.argsort(leaf.perm).tolist()) if leaf.perm else t
    return out


def _copy_into(named: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor]) -> None:
    """Whole values into tensors by name (into a DTensor, this rank's shard)."""
    with torch.no_grad():
        for name, t in named.items():
            t.copy_(collectives.shard_like(t, values[name]))


def _has_ema(n_leaves: int, n_params: int) -> bool:
    """Whether an archive of ``n_leaves`` carries the EMA's P leaves last:
    AdamW/Adam 4P+4 (3P+4 without), SGD 3P+3 (2P+3 without)."""
    return n_leaves in (4 * n_params + 4, 3 * n_params + 3)


def load_checkpoint(path: str, state) -> int:
    """Restores a TrainState archive into the port's ``state`` in place
    (weights, moments, counts, the learning rate, the step, the EMA);
    returns its epoch. The leaf count and every shape must match the state,
    as the JAX package asserts."""
    named = dict(state.model.named_parameters())
    lay = _layout(state.model)
    p = len(lay)
    opt = state.optimizer
    n_opt = (2 + p) if opt.method == "sgd" else (3 + 2 * p)
    want = p + n_opt + 1 + (p if state.ema is not None else 0)
    with np.load(path) as blob:
        leaves = [blob[k] for k in sorted(blob.files)]
    if len(leaves) != want:
        raise ValueError(f"{path} has {len(leaves)} leaves, the state expects {want}: "
                         "optimizer/model configuration mismatch")
    # where each param-shaped group starts: params, moments, EMA
    offsets = [0] + ([p + 2] if opt.method == "sgd" else [p + 3, 2 * p + 3])
    if state.ema is not None:
        offsets.append(p + n_opt + 1)
    for off in offsets:
        _check_shapes(path, lay, leaves[off:off + p], off, named)

    def group(off):
        return _from_jax(lay, leaves[off:off + p], named)

    _copy_into(named, group(0))
    opt.set_lr(float(leaves[p + 1]))
    if opt.method == "sgd":
        opt.load_moments(0, group(p + 2), {})
    else:
        opt.load_moments(int(leaves[p + 2]), group(p + 3), group(2 * p + 3))
    state.step = int(leaves[p + n_opt])
    if state.ema is not None:
        _copy_into(state.ema, group(p + n_opt + 1))
    return checkpoint_meta(path)["epoch"]


def load_params_npz(path: str, model: nn.Module, use_ema: bool = False) -> bool:
    """Loads a TrainState archive's params into ``model``, or its EMA
    weights with ``use_ema`` where it has them. Returns whether the EMA
    weights were loaded."""
    named = dict(model.named_parameters())
    lay = _layout(model)
    p = len(lay)
    with np.load(path) as blob:
        keys = sorted(blob.files)
        ema = use_ema and _has_ema(len(keys), p)
        leaves = [blob[k] for k in (keys[len(keys) - p:] if ema else keys[:p])]
    _check_shapes(path, lay, leaves, len(keys) - p if ema else 0, named)
    _copy_into(named, _from_jax(lay, leaves, named))
    return ema


# --- reference .pyth files ------------------------------------------------------


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a reference ``.pyth`` (its ``model_state``) or a
    ``torch.save``d dict of tensors, on the CPU, without a ``module.``
    prefix. Read with ``weights_only=True``: no pickled code runs."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob["model_state"] if "model_state" in blob else blob
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_torch_weights(path: str, model: nn.Module) -> Tuple[int, int]:
    """Fine-tune init from a ``.pyth``: the shape-matched partial merge with
    position embeddings interpolated (``convert/from_torch.py``)."""
    loaded, kept = from_torch.merge_partial(model, load_state_dict_file(path))
    logger.info("Loaded %d leaves from %s (%d kept initialization)", loaded, path, kept)
    return loaded, kept


def load_audio_branch(path: str, model: nn.Module) -> int:
    """Merges an audio-pretrained MViT (``blocks.*``, ``patch_embed.*``, its
    position embeddings) into the audio branch."""
    sd = from_torch.audio_branch_state_dict(load_state_dict_file(path))
    loaded, _ = from_torch.merge_partial(model, sd)
    logger.info("Audio branch: loaded %d leaves from %s", loaded, path)
    return loaded


# --- the load chains ------------------------------------------------------------


def load_train_checkpoint(cfg, state) -> Tuple[int, int]:
    """Auto-resume / fine-tune init (checkpoint.py:617-659), in place.
    Returns (start_epoch, start_iter): start_iter > 0 only when the newest
    file in OUTPUT_DIR is a mid-epoch save, whose epoch resumes there.

    * TRAIN.AUTO_RESUME and a checkpoint in OUTPUT_DIR: the newest.
    * An ``.npz`` TRAIN.CHECKPOINT_FILE_PATH: the whole state; the next
      epoch after it, or epoch 0 with TRAIN.CHECKPOINT_EPOCH_RESET.
    * A ``.pyth`` one: the weights (partial merge), then the audio branch
      from TRAIN.AUDIO_CHECKPOINT_FILE_PATH; the EMA restarts from them.

    With a process group every rank reads, after a barrier.
    """
    collectives.barrier()
    if cfg.TRAIN.AUTO_RESUME and has_checkpoint(cfg.OUTPUT_DIR):
        last = get_last_checkpoint(cfg.OUTPUT_DIR)
        logger.info("Auto-resuming from %s", last)
        epoch = load_checkpoint(last, state)
        return epoch + 1, checkpoint_meta(last).get("iter", 0)
    path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    if not path:
        return 0, 0
    if path.endswith(".npz"):
        epoch = load_checkpoint(path, state)
        return (0 if cfg.TRAIN.CHECKPOINT_EPOCH_RESET else epoch + 1), 0
    load_torch_weights(path, state.model)
    if cfg.TRAIN.AUDIO_CHECKPOINT_FILE_PATH:
        load_audio_branch(cfg.TRAIN.AUDIO_CHECKPOINT_FILE_PATH, state.model)
    if state.ema is not None:
        for name, p in state.model.named_parameters():
            state.ema[name].copy_(p.detach())
    return 0, 0


def resolve_test_checkpoint(cfg) -> Optional[str]:
    """TEST.CHECKPOINT_FILE_PATH, else the latest checkpoint in OUTPUT_DIR,
    else TRAIN.CHECKPOINT_FILE_PATH, else None (checkpoint.py:579-614)."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        return cfg.TEST.CHECKPOINT_FILE_PATH
    if has_checkpoint(cfg.OUTPUT_DIR):
        return get_last_checkpoint(cfg.OUTPUT_DIR)
    return cfg.TRAIN.CHECKPOINT_FILE_PATH or None


def load_test_checkpoint(cfg, model: nn.Module,
                         init: Optional[Callable[[], None]] = None) -> Optional[str]:
    """Loads the test chain's first source into ``model`` and returns its
    path; with no source it logs the random initialisation and returns None.

    An ``.npz`` gives its params, or with TEST.USE_EMA its EMA weights where
    it has them (a warning where it has none), whichever link of the chain
    it came from. A ``.pyth`` goes through fine-tune init's partial merge,
    after ``init`` (the caller's seeded initialisation) where it does not
    cover every parameter. A state dict carries no
    EMA weights: with TEST.USE_EMA its raw weights are scored, with a
    warning."""
    path = resolve_test_checkpoint(cfg)
    if path is None:
        logger.info("Testing with random initialization (no checkpoint found).")
        if init is not None:
            init()
        return None
    if path.endswith(".npz"):
        if load_params_npz(path, model, use_ema=cfg.TEST.USE_EMA):
            logger.info("Evaluating the EMA weights of %s.", path)
        elif cfg.TEST.USE_EMA:
            logger.warning("TEST.USE_EMA requested but %s has no EMA weights; "
                           "evaluating raw params.", path)
        logger.info("Loaded checkpoint %s", path)
        return path
    sd = load_state_dict_file(path)
    if init is not None and any(n not in sd or tuple(sd[n].shape) != tuple(p.shape)
                                for n, p in model.named_parameters()):
        init()  # what the file leaves out keeps a seeded initialisation
    loaded, kept = from_torch.merge_partial(model, sd)
    logger.info("Loaded checkpoint %s (%d leaves; %d kept initialization)", path, loaded, kept)
    if cfg.TEST.USE_EMA:
        logger.warning("TEST.USE_EMA requested but %s carries no EMA weights; "
                       "evaluating raw params.", path)
    return path
