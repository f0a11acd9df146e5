"""YAML config files for argparse command lines: ``--config file.yaml``.
A copy of production_stack_tpu/yaml_args.py.

File entries are rewritten into synthetic argv PREPENDED to the real one,
so argparse's own type and choices validation applies to file values
exactly as to flags, and explicit flags win (later occurrences override
earlier ones in argparse). ``yaml`` is imported only when ``--config`` is
given: a machine without PyYAML parses every other command line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def parse_with_yaml_config(parser: argparse.ArgumentParser,
                           argv: Optional[list] = None):
    """Like ``parser.parse_args(argv)`` but honoring a ``--config`` flag.

    The parser must define ``--config``. Unknown keys, non-boolean values
    for store_true flags, unreadable files, and non-mapping documents all
    fail through ``parser.error`` (a usage message, exit 2)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pre, _ = parser.parse_known_args(argv)
    if not getattr(pre, "config", None):
        return parser.parse_args(argv)
    import yaml

    try:
        with open(pre.config) as f:
            loaded = yaml.safe_load(f) or {}
    except (OSError, yaml.YAMLError) as e:
        parser.error(f"--config {pre.config}: {e}")
    if not isinstance(loaded, dict):
        parser.error(f"--config {pre.config}: expected a mapping")
    actions = {a.dest: a for a in parser._actions
               if a.dest not in ("config", "help")}
    synthetic: list[str] = []
    for key, value in loaded.items():
        dest = str(key).replace("-", "_")
        action = actions.get(dest)
        if action is None:
            parser.error(f"--config {pre.config}: unknown option {key!r}")
        flag = action.option_strings[-1]
        if value is None:
            # an explicit null (`model:` with nothing after it) leaves the
            # default: str(None) would pass the string "None"
            continue
        if action.const is True:  # store_true flags: presence = True
            if not isinstance(value, bool):
                parser.error(f"--config {pre.config}: {key!r} expects a "
                             "boolean")
            if value:
                synthetic.append(flag)
        elif isinstance(value, dict):
            synthetic += [flag, json.dumps(value)]
        else:
            synthetic += [flag, str(value)]
    # file values first, flags last: later occurrences win in argparse
    return parser.parse_args(synthetic + argv)
