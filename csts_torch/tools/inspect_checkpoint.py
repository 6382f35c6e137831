"""Inspect a checkpoint: leaves, shapes, sizes, metadata, without building a
model's weights (the JAX package's ``tools/inspect_checkpoint.py``, same
flags, same lines):

    python -m csts_torch.tools.inspect_checkpoint PATH [--cfg CFG.yaml] [--full]

* an npz TrainState or params archive (either package's trainer, or
  ``convert_checkpoint``): totals, the dtypes, the sidecar's epoch/iter; with
  ``--cfg`` the leading leaves are named by the model's parameter leaves
  (``convert/to_jax.param_leaf_names``, a model on the meta device) and the
  rest counted as optimizer/EMA state;
* a reference ``.pyth`` (read with ``weights_only=True``): the state dict's
  modules and shapes;
* a step directory of the port's orbax backend
  (``OUTPUT_DIR/checkpoints_orbax/<step>``, ``utils/orbax_ckpt.py``): the
  step, each key with its global shape and dtype, and the bytes each
  rank's file holds; any other directory (the JAX package's orbax format,
  which the port does not read) raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from collections import defaultdict

import numpy as np


def _human(n_bytes: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n_bytes < 1024 or unit == "GB":
            return f"{n_bytes:.1f}{unit}"
        n_bytes /= 1024
    return f"{n_bytes:.1f}GB"


def load_cfg(path: str):
    """A config from a YAML, its OUTPUT_DIR kept off the disk the YAML names."""
    from csts_torch.config import load_config

    return load_config(path, output_dir=tempfile.gettempdir())


def param_names(cfg_path: str):
    """[(path, shape)] of the model's parameter leaves in the JAX flatten order."""
    from csts_torch.convert.to_jax import param_leaf_names

    return param_leaf_names(load_cfg(cfg_path))


def inspect_npz(path: str, cfg_path=None, full=False):
    blob = np.load(path)
    keys = sorted(blob.files)
    sidecar = path + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
        line = f"sidecar: epoch={meta.get('epoch')}"
        if "iter" in meta:
            line += f" iter={meta['iter']}"
        if "cfg" in meta:
            m = meta["cfg"].get("MODEL", {})
            line += f"  cfg: MODEL_NAME={m.get('MODEL_NAME')} LOSS_FUNC={m.get('LOSS_FUNC')}"
        print(line)

    names = None
    if cfg_path:
        names = param_names(cfg_path)
        mismatched = [(n, s, blob[k].shape) for (n, s), k in zip(names, keys)
                      if tuple(blob[k].shape) != s]
        if len(keys) < len(names):
            print(f"WARNING: archive has {len(keys)} leaves but the cfg's model has "
                  f"{len(names)} params — wrong --cfg?")
            names = None
        elif mismatched:
            print(f"WARNING: {len(mismatched)} leaf shapes differ from the cfg's model, e.g.")
            for n, s, a in mismatched[:5]:
                print(f"  {n}: cfg {s} vs archive {a}")
            names = None

    total = count = 0
    by_dtype = defaultdict(int)
    by_module = defaultdict(lambda: [0, 0])  # name -> [elements, bytes]
    # without names params and optimizer/EMA leaves cannot be told apart
    n_params_leaves = len(names) if names else len(keys)
    unlabeled = "[all leaves — pass --cfg to split params vs optimizer state]"
    opt_bytes = opt_leaves = 0
    for i, k in enumerate(keys):
        arr = blob[k]
        total += arr.nbytes
        count += arr.size
        by_dtype[str(arr.dtype)] += arr.nbytes
        if names and i >= n_params_leaves:
            opt_leaves += 1
            opt_bytes += arr.nbytes
        else:
            mod = names[i][0].split("/")[0] if names else unlabeled
            by_module[mod][0] += arr.size
            by_module[mod][1] += arr.nbytes
        if full:
            label = names[i][0] if names and i < n_params_leaves else k
            print(f"  {label:60s} {str(arr.shape):20s} {str(arr.dtype):10s} {_human(arr.nbytes)}")

    print(f"{len(keys)} leaves, {count / 1e6:.2f}M elements, {_human(total)} total")
    for mod, (p, b) in sorted(by_module.items(), key=lambda kv: -kv[1][1]):
        print(f"  {mod:30s} {p / 1e6:9.2f}M params  {_human(b)}")
    if opt_leaves:
        print(f"  {'[optimizer/EMA state]':30s} {opt_leaves} leaves            {_human(opt_bytes)}")
    print("dtypes: " + ", ".join(f"{d}={_human(b)}" for d, b in sorted(by_dtype.items())))


def inspect_pyth(path: str, full=False):
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("model_state", blob) if isinstance(blob, dict) else blob
    extra = [k for k in blob if k != "model_state"] if isinstance(blob, dict) else []
    if extra:
        print(f"top-level keys: {extra} (epoch={blob.get('epoch')})")
    by_module = defaultdict(lambda: [0, 0])
    total = count = 0
    for name, t in state.items():
        n = t.numel()
        b = n * t.element_size()
        total += b
        count += n
        by_module[name.split(".")[0]][0] += n
        by_module[name.split(".")[0]][1] += b
        if full:
            print(f"  {name:60s} {str(tuple(t.shape)):20s} {_human(b)}")
    print(f"{len(state)} tensors, {count / 1e6:.2f}M elements, {_human(total)} total")
    for mod, (p, b) in sorted(by_module.items(), key=lambda kv: -kv[1][1]):
        print(f"  {mod:30s} {p / 1e6:9.2f}M params  {_human(b)}")


def inspect_orbax_step(path: str):
    """A step directory the port's orbax backend committed (DCP's format)."""
    from torch.distributed.checkpoint import FileSystemReader

    from csts_torch.utils import orbax_ckpt

    with open(os.path.join(path, orbax_ckpt.COMMIT)) as f:
        commit = json.load(f)
    md = FileSystemReader(path).read_metadata()
    print(f"step {commit['step']} ({commit['format']}, written by {commit['ranks']} rank(s))")
    total = 0
    by_group = defaultdict(int)
    for key, meta in sorted(md.state_dict_metadata.items()):  # every value a tensor
        n = int(np.prod(meta.size)) * meta.properties.dtype.itemsize
        total += n
        by_group[key.split(".")[0]] += n
        dtype = str(meta.properties.dtype).replace("torch.", "")
        print(f"  {key:70s} {str(tuple(meta.size)):20s} {dtype:10s} {_human(n)}")
    print(f"{len(md.state_dict_metadata)} keys, {_human(total)} total: "
          + ", ".join(f"{g} {_human(b)}" for g, b in sorted(by_group.items())))
    for name in sorted(n for n in os.listdir(path) if n.endswith(".distcp")):
        rank = name[2:].split("_")[0]
        print(f"  rank {rank}: {name} {_human(os.path.getsize(os.path.join(path, name)))}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("--cfg", default=None, help="YAML config: name npz leaves via the model spec")
    ap.add_argument("--full", action="store_true", help="print every leaf")
    args = ap.parse_args(argv)

    if os.path.isdir(args.path):
        from csts_torch.utils import orbax_ckpt

        if not os.path.isfile(os.path.join(args.path, orbax_ckpt.COMMIT)):
            raise NotImplementedError(
                f"{args.path} is not a step the port's orbax backend committed (no "
                f"{orbax_ckpt.COMMIT}): the JAX package's orbax format is not read by the "
                "port; give OUTPUT_DIR/checkpoints_orbax/<step>")
        inspect_orbax_step(args.path)
        return
    if args.path.endswith((".pyth", ".pkl", ".pt")):
        inspect_pyth(args.path, full=args.full)
    else:
        inspect_npz(args.path, cfg_path=args.cfg, full=args.full)


if __name__ == "__main__":
    main()
