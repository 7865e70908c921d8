"""Semantic segmentation CLI: SegFormer class-id maps for every camera frame.

Port of `mudg_tpu/apps/segment.py` (reference `data_process/pipeline_segment.py`,
main at :91-121): for each camera directory under <scene>/images/, run the
SegFormer-B3 predictor (`models/segformer.py`) on the card (`--device`,
default cuda) and write <out>/<cam>/seg/NNNNNNNN.pfm raw class-id maps plus
<scene>/semantic_dense/<cam>/NNNNNNNN.jpg cityscapes palette images.

    python -m mudg_tpu_torch segment --scene <dir> [--model_path ckpt] [--device cpu]

Weights are local only: pass --model_path (an HF checkpoint dir or a state
dict file) or set MUDG_SEGFORMER_PATH. Images are read and written with
OpenCV.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scene", required=True, help="processed scene dir")
    p.add_argument("--cameras", nargs="+", default=["camera_FRONT"])
    p.add_argument("--model_path", default=None,
                   help="local SegFormer-B3 checkpoint (dir or file); "
                        "falls back to MUDG_SEGFORMER_PATH / HF cache")
    p.add_argument("--out", default=None,
                   help="output root for seg/ pfm maps "
                        "(default <scene>/semantic)")
    p.add_argument("--no_palette", action="store_true",
                   help="skip writing semantic_dense/ palette jpgs")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    from ..data.segmentation import load_segformer_predictor, segment_frames

    predictor = load_segformer_predictor(args.model_path, device=args.device)
    if predictor is None:
        print("segment: no local SegFormer weights found (pass --model_path "
              "or set MUDG_SEGFORMER_PATH); nothing to do", file=sys.stderr)
        return 1

    out_root = args.out or os.path.join(args.scene, "semantic")
    palette_dir = None if args.no_palette else os.path.join(args.scene, "semantic_dense")
    total = 0
    for cam in args.cameras:
        image_dir = os.path.join(args.scene, "images", cam)
        if not os.path.isdir(image_dir):
            print(f"segment: {image_dir} missing, skipped", file=sys.stderr)
            continue
        n = segment_frames(image_dir, out_root, cam, predictor, palette_dir=palette_dir)
        print(f"segment: {cam}: {n} frames", flush=True)
        total += n
    return 0 if total else 1


if __name__ == "__main__":
    raise SystemExit(main())
