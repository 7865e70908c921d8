"""Command-line entry: python -m mudg_tpu_torch <command> [args...]

Mirrors `python -m mudg_tpu`. Ported commands:
  render       multi-modal autoregressive inference (apps.render_infer)
  serve        warm-model request-spool daemon      (apps.serve)
  refine-gs    3DGS scene refinement                (apps.refine_gs)
  train        MDM training                         (apps.train_mdm)
  precompute-latents  VAE moment caches for train --latents
                                                    (apps.precompute_latents)
  quantize     checkpoint -> int8 torch file for serving (apps.quantize_ckpt)
  conditions   offline sparse RGB/depth generation  (apps.make_conditions)
  eval         PSNR/SSIM/LPIPS, depth and mIoU evaluation (apps.eval_nvs)
  segment      SegFormer semantic maps per frame    (apps.segment)
  densify      learned/classical depth densification (apps.densify_depth)
`render-infer` is an alias of `render`, `train-mdm` of `train`,
`make-conditions` of `conditions`, `eval-nvs` of `eval`. The JAX CLI's other
commands (preprocess, bench) exit with code 2 and "not ported yet".
"""
from __future__ import annotations

import sys

NOT_PORTED = ("preprocess", "bench")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    cmd = {"render-infer": "render", "train-mdm": "train",
           "make-conditions": "conditions", "eval-nvs": "eval"}.get(cmd, cmd)
    if cmd == "render":
        from .apps.render_infer import main as run
    elif cmd == "serve":
        from .apps.serve import main as run
    elif cmd == "refine-gs":
        from .apps.refine_gs import main as run
    elif cmd == "train":
        from .apps.train_mdm import main as run
    elif cmd == "precompute-latents":
        from .apps.precompute_latents import main as run
    elif cmd == "quantize":
        from .apps.quantize_ckpt import main as run
    elif cmd == "conditions":
        from .apps.make_conditions import main as run
    elif cmd == "eval":
        from .apps.eval_nvs import main as run
    elif cmd == "segment":
        from .apps.segment import main as run
    elif cmd == "densify":
        from .apps.densify_depth import main as run
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
