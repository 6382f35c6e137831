"""The port's YAML reader (``csts_torch/config/yaml_subset.py``) against
PyYAML's ``safe_load``, which the test environment has and the card's
machine does not: equal on the four shipped configs and on edge strings,
and an error with the line number on input outside the subset."""

from __future__ import annotations

import glob
import math
import os

import pytest
import yaml

from csts_torch.config import load_config
from csts_torch.config import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_shipped_configs_equal_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yaml_subset.load_file(path) == want


EDGES = {
    "trailing comment": "A:\n  B: 3   # a comment\n  C: x#y\n",
    "exponent without a dot": "LR: 1e-6\nEND: 1.0e-6\nNEG: -2.5\nDOT: .5\nBIG: 1_000\n",
    "quoted strings": "P: '/data/it''s'\nQ: \"a \\\"b\\\" # c\"\nR: '# not a comment'\n",
    "nested flow lists": "M: [[1, 2.0], [3, 2.0], [14, 2.0]]\nE: []\nS: [a, 'b c', True, ~]\n",
    "bools and nulls": "A: True\nB: false\nC: yes\nD: Off\nE: ~\nF: null\nG:\nH: none\n",
    "infinity and nan-free floats": "A: .inf\nB: -.Inf\nC: 0.0\nD: +1\nE: -0\n",
    "comment lines and blank lines": "# head\n\nA:\n  # inside\n  B:\n    C: 1\n\n  D: 2\n",
    "plain strings": "A: kldiv+egonce\nB: /data/x y\nC: 10.5.1\nD: a:b\n",
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_strings_equal_safe_load(name):
    assert yaml_subset.load(EDGES[name]) == yaml.safe_load(EDGES[name])


def test_nan_reads_as_nan():
    got = yaml_subset.load("A: .nan\n")["A"]
    assert math.isnan(got) and math.isnan(yaml.safe_load("A: .nan\n")["A"])


BAD = {
    "block sequence": ("A:\n  - 1\n  - 2\n", 2),
    "flow map": ("A: {b: 1}\n", 1),
    "anchor": ("A: &x 1\n", 1),
    "tag": ("A: !!str 1\n", 1),
    "literal block": ("A: |\n  text\n", 1),
    "hex int": ("A: 0x1F\n", 1),
    "octal int": ("A: 017\n", 1),
    "sexagesimal": ("A: 1:30\n", 1),
    "timestamp": ("A: 2001-12-14\n", 1),
    "duplicate key": ("A: 1\nB: 2\nA: 3\n", 3),
    "tab indentation": ("A:\n\tB: 1\n", 2),
    "flow list over lines": ("A: [1,\n  2]\n", 1),
    "unterminated quote": ("A: 'abc\n", 1),
    "bad indentation": ("A:\n    B: 1\n  C: 2\n", 3),
    "document marker": ("---\nA: 1\n", 1),
    "no colon": ("A: 1\nB\n", 2),
    "quoted key": ("'A': 1\n", 1),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_outside_the_subset_raises_with_the_line(name):
    text, line = BAD[name]
    with pytest.raises(yaml_subset.YamlSubsetError, match=f"^line {line}:"):
        yaml_subset.load(text)


def test_load_config_reads_the_flagship_yaml_without_pyyaml(tmp_path, monkeypatch):
    """``load_config`` goes through the reader; the string '1e-6' becomes the
    float the field holds, as with PyYAML before."""
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("no PyYAML here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg = load_config(os.path.join(REPO, "configs", "Ego4D", "CSTS_Ego4D_Gaze_Forecast.yaml"),
                      ["SOLVER.MAX_EPOCH", "2"], output_dir=str(tmp_path))
    assert cfg.SOLVER.COSINE_END_LR == 1e-6 and isinstance(cfg.SOLVER.COSINE_END_LR, float)
    assert cfg.MVIT.DIM_MUL == [[1, 2.0], [3, 2.0], [14, 2.0]]
    assert cfg.DATA.PATH_PREFIX == "/data/Ego4D/clips.gaze"
    assert cfg.TRAIN.CHECKPOINT_EPOCH_RESET is True and cfg.SOLVER.MAX_EPOCH == 2
