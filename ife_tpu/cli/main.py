"""`ife` — the single CLI entry point.

One subcommand per reference tool (SURVEY.md §2.2; the reference ships 22
built binaries under tools/, its only API surface). Flag names and defaults
follow the reference where sensible (ROI size 41^3 for bags —
MakeBag.cxx:144-169; GenerateROIs box 53x53x41 — GenerateROIs.cxx:52-76;
window level/width -500/1500 — ExtractWindow.cxx:36-40).

Run as `python -m ife_tpu <subcommand>` (or the `ife` console script).
"""
from __future__ import annotations

import argparse
import sys

from ife_tpu.cli import commands as C


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ife",
        description="dense 3D feature extraction on an accelerator "
        "(capabilities of orting/image-feature-extraction)",
    )
    sub = p.add_subparsers(dest="command", required=True, metavar="COMMAND")

    for name, (configure, run, help_) in C.REGISTRY.items():
        sp = sub.add_parser(name, help=help_, description=help_)
        configure(sp)
        sp.set_defaults(_run=run)

    args = p.parse_args(argv)
    from ife_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        return args._run(args) or 0
    except BrokenPipeError:
        return 0  # e.g. `ife image-browser ... | head`
    except Exception as e:  # context-rich stderr + failure exit, like the
        # reference tools' try/catch around Update() (MakeBag.cxx:408-439)
        print(f"ife {args.command}: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
