"""JSON-over-argparse config merging, a copy of codlad_tpu/cli/config.py
`parse_with_json`: `-load_json file.json` reparses the command line with the
JSON dict as defaults, so JSON keys override argparse defaults and explicit
flags override both."""

from __future__ import annotations

import argparse
import json


def parse_with_json(parser: argparse.ArgumentParser, argv=None):
    args = parser.parse_args(argv)
    if getattr(args, "load_json", None):
        with open(args.load_json) as f:
            overrides = json.load(f)
        parser.set_defaults(**overrides)
        args = parser.parse_args(argv)
    return args
