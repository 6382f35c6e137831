"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
nor OpenCV, nor PyYAML at module level, and it never drops to the CPU
without being asked to."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import csts_torch
from csts_torch import presets
from csts_torch.models.csts import CSTS, build_spec
from csts_torch.serving import GazePredictor
from csts_torch.tools import ab_block, ab_flags, profile_forward

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.join(d, f)
    for d, _, files in os.walk(os.path.join(REPO, "csts_torch"))
    for f in files if f.endswith(".py")
) + [os.path.join(REPO, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "csts_tpu", "cv2")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def test_import_leaves_jax_and_csts_tpu_out():
    """A fresh interpreter (conftest imports jax here) imports every module of
    the port, and neither jax nor csts_tpu is loaded afterwards."""
    mods = [m.name for m in pkgutil.walk_packages(csts_torch.__path__, "csts_torch.")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('yaml',)!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15, mods


def _imports(path):
    """(module name, at top level?) for every import statement of a file."""
    tree = ast.parse(open(path).read(), path)
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    for name, _ in _imports(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"
        # the port reads YAML with its own reader (the card's machine has no PyYAML)
        assert root != "yaml", f"{path} imports yaml"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = presets.small_cfg(1)
    sd = CSTS(build_spec(cfg)).state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        GazePredictor(cfg, sd)
    with pytest.raises(RuntimeError, match="CUDA"):
        csts_torch.resolve_device()
    assert csts_torch.resolve_device("cpu").type == "cpu"
    # the tools too, unless given --device cpu (tests/test_torch_b9.py runs them so)
    for tool in (ab_block, ab_flags, profile_forward):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(["--small"])


def test_chip_smoke_refuses_without_cuda_and_alone(tmp_path):
    """No result line without a card, and none from a directory that holds
    the script and nothing else of the repo."""
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
