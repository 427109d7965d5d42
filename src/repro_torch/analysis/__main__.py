"""CLI for the invariant lint: ``python -m repro_torch.analysis [paths...]``.

With no arguments, lints the installed ``repro_torch`` warehouse sources (the
package directory itself).  Exits 0 when clean, 1 when any unsuppressed
finding remains, 2 on usage/parse errors.  This is the CI lint gate.
"""
from __future__ import annotations

import argparse
import os
import sys

from .lint import CODES, lint_paths


def _default_paths():
    import repro_torch

    # __path__ covers the package root whether or not it is a namespace package
    return [os.path.abspath(p) for p in repro_torch.__path__]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific invariant lint (REP001..REP007)",
    )
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint "
                         "(default: the repro_torch package)")
    ap.add_argument("--codes", action="store_true",
                    help="list checker codes and exit")
    args = ap.parse_args(argv)

    if args.codes:
        for code, desc in sorted(CODES.items()):
            print(f"{code}  {desc}")
        return 0

    paths = args.paths or _default_paths()
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2
    try:
        findings = lint_paths(paths)
    except SyntaxError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    for f in findings:
        print(f)
    n = len(findings)
    roots = ", ".join(paths)
    print(f"repro_torch.analysis: {n} finding(s) in {roots}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
