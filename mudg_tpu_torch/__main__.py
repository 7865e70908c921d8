"""Command-line entry: python -m mudg_tpu_torch <command> [args...]

Mirrors `python -m mudg_tpu`. Ported commands:
  refine-gs    3DGS scene refinement                (apps.refine_gs)
The JAX CLI's other commands (train, render, serve, conditions, eval,
preprocess, segment, densify, quantize, precompute-latents, bench and their
hyphenated aliases) exit with code 2 and "not ported yet".
"""
from __future__ import annotations

import sys

NOT_PORTED = ("train", "train-mdm", "render", "render-infer", "serve", "conditions",
              "make-conditions", "eval", "eval-nvs", "preprocess", "segment", "densify",
              "quantize", "precompute-latents", "bench")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "refine-gs":
        from .apps.refine_gs import main as run
    elif cmd in NOT_PORTED:
        print(f"{cmd!r} is not ported yet (see ROADMAP.md); run it with "
              f"python -m mudg_tpu {cmd}", file=sys.stderr)
        return 2
    else:
        print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
        return 2
    rc = run(rest)
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    raise SystemExit(main())
