"""Offline checkpoint quantization (port of `mudg_tpu/apps/quantize_ckpt.py`):
a MuDG checkpoint -> a torch file whose UNet layers are int8 (`quant.py`
W8A8 or weight-only).

Quantize once, serve many: `render`/`serve --ckpt <out>` load the artifact
directly (its int8 layers restructured from its keys, the buffers loaded
intact), skipping the per-launch quantization pass, and the UNet on disk and
on the card is about a quarter of its fp32 size. The JAX app writes an
orbax directory; the port writes one `torch.save`d MDM state dict, as its
other checkpoints.

Usage:
    python -m mudg_tpu_torch quantize --ckpt mdm512.ckpt --out mdm512-int8.pt \
        [--mode int8|int8-weights] [--preset mdm512] [--device cpu]
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help="source checkpoint (a MuDG .ckpt or a torch.save'd MDM state dict)")
    p.add_argument("--out", required=True, help="output torch file")
    p.add_argument("--preset", default="mdm512")
    p.add_argument("--mode", default="int8", choices=("int8", "int8-weights"))
    p.add_argument("--min_size", type=int, default=None,
                   help="min weight elements to quantize (default quant.MIN_QUANT_SIZE)")
    p.add_argument("--conv_mode", default=None, choices=("int8", "int8-weights"),
                   help="override for conv layers; int8-weights keeps the artifact "
                        "as render/serve --seq_parallel would demote it")
    p.add_argument("--which", default="all", choices=("all", "conv"),
                   help="'conv' quantizes only spatial convs (the fused kernels "
                        "1-4 keep every other site)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    from .. import quant
    from ..models import presets
    from ..train import checkpoint as C
    from .render_infer import load_params

    mdm = load_params(args, presets.get(args.preset), args.device)
    mode = "w8a8" if args.mode == "int8" else "w8"
    conv_mode = (None if args.conv_mode is None
                 else "w8a8" if args.conv_mode == "int8" else "w8")
    quant.quantize_module(mdm.unet, mode=mode, min_size=args.min_size, conv_mode=conv_mode,
                          which=args.which)
    rep = quant.size_report(mdm.unet)
    C.save(args.out, mdm.state_dict())
    print(f"quantize: wrote {args.out} ({mode}; UNet "
          f"{rep['int8_bytes'] / 2**20:.0f} MiB int8 + "
          f"{rep['other_bytes'] / 2**20:.0f} MiB fp)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
