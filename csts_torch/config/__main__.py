"""Print the effective configuration as YAML (``csts_tpu/config/__main__.py``).

    python -m csts_torch.config                          # all defaults, every knob
    python -m csts_torch.config --cfg run.yaml K V ...   # a run's effective config
    python -m csts_torch.config --diff --cfg run.yaml    # only keys that differ from defaults

The YAML is written by the port's own writer (``yaml_subset.dump``; the
card's machine has no PyYAML), which ``load_config`` and PyYAML both read
back as the same values.
"""

import argparse
import json
import sys

from csts_torch.config import yaml_subset
from csts_torch.config.config import get_cfg, load_config, merge_from_dict, merge_from_list


def _to_plain(d):
    return json.loads(json.dumps(d))  # tuples -> lists


def _diff(default: dict, effective: dict) -> dict:
    out = {}
    for k, v in effective.items():
        dv = default.get(k)
        if isinstance(v, dict) and isinstance(dv, dict):
            sub = _diff(dv, v)
            if sub:
                out[k] = sub
        elif v != dv:
            out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", default=None, help="YAML run config to merge over defaults")
    ap.add_argument("opts", nargs="*", help="KEY VALUE override pairs (run_net's syntax)")
    ap.add_argument("--diff", action="store_true",
                    help="print only keys that differ from the code defaults "
                         "(before finalize: values it derives, like BASE_LR x "
                         "NUM_SHARDS, are not reported as overrides)")
    args = ap.parse_args(argv)
    if args.diff:
        cfg = get_cfg()
        if args.cfg:
            merge_from_dict(cfg, yaml_subset.load_file(args.cfg) or {})
        if args.opts:
            merge_from_list(cfg, args.opts)
        effective = _diff(_to_plain(get_cfg().dump()), _to_plain(cfg.dump()))
    elif args.cfg or args.opts:
        effective = _to_plain(load_config(args.cfg, opts=args.opts or None,
                                          output_dir=".").dump())
    else:
        effective = _to_plain(get_cfg().dump())
    sys.stdout.write(yaml_subset.dump(effective))
    return 0


if __name__ == "__main__":
    sys.exit(main())
