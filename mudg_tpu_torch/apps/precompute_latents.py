"""Precompute VAE posterior moments for every frame an item list touches
(port of `mudg_tpu/apps/precompute_latents.py`).

Usage:
    python -m mudg_tpu_torch precompute-latents --items items.txt \
        [--ckpt model.ckpt|mdm_state_dict] [--height 320 --width 512] \
        [--batch 16] [--device cpu]

Writes sibling .npy caches next to each source frame (data/latents.py
layout). Train with them via `train --latents`: the training step then
skips the frozen VAE encode. Re-run after changing resolution (caches are
resolution-keyed) or VAE weights (pass --force to overwrite).

The reference has no analog — it re-encodes every batch
(lvdm/models/ddpm3d.py:1077-1079); the Waymo loader is deterministic per
frame file (waymo_data.py:39-43), which is what makes caching exact.
`--ckpt` is a MuDG `.ckpt` or the port's own saved MDM state dict (a
`train` run's step_N or final), where the JAX app takes an orbax directory.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("precompute-latents")
    p.add_argument("--items", required=True, nargs="+",
                   help="item list file(s) (train + val)")
    p.add_argument("--ckpt", default=None,
                   help="MuDG .ckpt or a saved MDM state dict holding the VAE; "
                        "random init when omitted (tests only — WARNS)")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--preset", default=None,
                   choices=(None, "mdm512", "mdm1024", "tiny"))
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--force", action="store_true",
                   help="re-encode even if a cache file exists")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..data import latents as L
    from ..data.waymo import read_items
    from ..models import mdm as M
    from ..nn import vae as V

    if args.preset:
        from ..models import presets

        cfg = presets.get(args.preset)
    else:
        cfg = M.MDMConfig()
    dev = torch.device(args.device)
    if args.ckpt:
        with torch.device("meta"):
            vae = V.AutoencoderKL(cfg.vae)
        vae.to_empty(device=dev)
        if args.ckpt.endswith(".ckpt"):
            from ..train import checkpoint as C

            sd = C.load_mudg_checkpoint(args.ckpt)["vae"]
        else:
            full = torch.load(args.ckpt, map_location=dev, weights_only=True)
            sd = {k[len("vae."):]: v for k, v in full.items() if k.startswith("vae.")} or full
        vae.load_state_dict(sd, strict=True)
    else:
        print("WARNING: random-init VAE (no --ckpt) — test use only")
        vae = M.init_mdm(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev).vae

    items = []
    for path in args.items:
        items.extend(read_items(path))
    n = L.precompute(items, vae, (args.height, args.width),
                     batch=args.batch, skip_existing=not args.force)
    print(f"precompute-latents: {n} moment files written "
          f"({args.height}x{args.width})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
