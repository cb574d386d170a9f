"""``python -m flinkml_tpu_torch.autotune`` — run the knob search, check or
rewrite the committed tuning table.

Modes:

- default (no flags): measure and PRINT the results as JSON, leaving
  the table untouched (a dry run);
- ``--commit``: measure and rewrite the table's entry for the current
  mesh (atomic; other meshes' entries are preserved);
- ``--check``: validate the table's schema without measuring anything —
  the CI gate (exit 1 on any problem).

The measurements run on the port's default device, ``cuda``; a run on a
host without a card fails. ``--quick`` shrinks every scenario to smoke
size; committed values should come from a full run on an otherwise-idle
card. ``--source`` defaults to this command and, on a card, its name and
power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def default_source() -> str:
    """This command, with the card's name and power limit when
    ``nvidia-smi`` reads them."""
    source = "python -m flinkml_tpu_torch.autotune"
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return source
    return f"{source} on {card[0]}" if card else source


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flinkml_tpu_torch.autotune",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--knobs", default=None,
        help="comma-separated knob subset (default: all)",
    )
    parser.add_argument("--quick", action="store_true",
                        help="smoke-size scenarios")
    parser.add_argument("--commit", action="store_true",
                        help="rewrite the tuning table")
    parser.add_argument("--table", default=None,
                        help="table path (default: the committed one)")
    parser.add_argument("--mesh", default=None,
                        help="override the mesh key to write under")
    parser.add_argument("--source", default=None,
                        help="provenance string recorded per knob (default: "
                             "this command and the card's nvidia-smi line)")
    parser.add_argument("--check", action="store_true",
                        help="validate the table schema and exit")
    args = parser.parse_args(argv)

    from flinkml_tpu_torch.autotune.table import load_table

    if args.check:
        table = load_table(args.table)
        problems = list(table.check())
        for p in problems:
            print(f"tuning-table problem: {p}", file=sys.stderr)
        if not problems:
            print(f"tuning table OK: {table.path} "
                  f"({len(table.meshes())} mesh entries)")
        return 1 if problems else 0

    from flinkml_tpu_torch.autotune.search import apply_results, search_knobs

    source = args.source or default_source()
    knobs = args.knobs.split(",") if args.knobs else None
    results = search_knobs(knobs, quick=args.quick, source=source)
    print(json.dumps(results, indent=2, sort_keys=True))
    if args.commit:
        table = load_table(args.table)
        apply_results(table, results, mesh=args.mesh, source=source)
        path = table.save(args.table)
        print(f"tuning table updated: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
