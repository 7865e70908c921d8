"""Novel-view quality evaluation over the three MDM output modalities.

Port of `mudg_tpu/apps/eval_nvs.py`: the `render` output layout
({task}_re_{i}.png vs {task}_gt_{i}.png), or any two directories of matching
PNG frames, scored per frame; prints one JSON summary.

  --task color (default)  PSNR + SSIM (+ LPIPS when --lpips/MUDG_LPIPS_PATH
                          provides AlexNet-LPIPS weights, utils/lpips.py)
  --task semantic         pixel accuracy + mIoU on palette-decoded class ids
  --task depth            abs_rel / rmse / delta1 on the metric-depth .npy
                          outputs vs --gt_depth/{frame:08d}.npy

    python -m mudg_tpu_torch eval --dir out/virtual_color [--device cpu]
    python -m mudg_tpu_torch eval --dir out/virtual_semantic --task semantic
    python -m mudg_tpu_torch eval --dir out/virtual_depth --task depth \\
        --gt_depth scene/six_frames_depth/camera_FRONT
    python -m mudg_tpu_torch eval --pred p/ --gt g/

SSIM and LPIPS run on the card (`--device`, default cuda); PSNR, the depth
metrics and mIoU on the host. PNGs are read with OpenCV; the depth task
reads .npy files only and needs OpenCV only to resize a GT of another size.
"""
from __future__ import annotations

import argparse
import json
import os
import re


def collect_pairs(args):
    pairs = []
    if args.dir:
        pat = re.compile(rf"{args.prefix}_re_(\d+)\.png$")
        for f in sorted(os.listdir(args.dir)):
            m = pat.match(f)
            if m:
                gt = os.path.join(args.dir, f"{args.prefix}_gt_{m.group(1)}.png")
                if os.path.exists(gt):
                    pairs.append((os.path.join(args.dir, f), gt))
    else:
        preds = sorted(f for f in os.listdir(args.pred) if f.endswith(".png"))
        for f in preds:
            gt = os.path.join(args.gt, f)
            if os.path.exists(gt):
                pairs.append((os.path.join(args.pred, f), gt))
    return pairs


def _rounded(d):
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in d.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dir", default=None,
                   help="render task dir with {prefix}_re/_gt pairs")
    p.add_argument("--prefix", default=None,
                   help="pair filename prefix (default: --task)")
    p.add_argument("--task", default="color", choices=("color", "depth", "semantic"))
    p.add_argument("--gt_depth", default=None,
                   help="dir of GT metric-depth {frame:08d}.npy (depth task)")
    p.add_argument("--pred", default=None)
    p.add_argument("--gt", default=None)
    p.add_argument("--out", default=None, help="write per-frame JSONL here")
    p.add_argument("--lpips", default=None,
                   help="AlexNet-LPIPS torch state dict (or set "
                        "MUDG_LPIPS_PATH); omitted/absent -> no lpips key")
    p.add_argument("--device", default="cuda",
                   help="torch device of SSIM and LPIPS (default cuda)")
    args = p.parse_args(argv)
    assert args.dir or (args.pred and args.gt)
    if args.prefix is None:
        args.prefix = args.task

    import numpy as np

    from ..utils import media, metrics

    rows = []
    if args.task == "depth":
        assert args.dir and args.gt_depth, "--task depth needs --dir + --gt_depth"
        pat = re.compile(r"depth_re_(\d+)\.npy$")
        for f in sorted(os.listdir(args.dir)):
            m = pat.match(f)
            if not m:
                continue
            gt_path = os.path.join(args.gt_depth, f"{int(m.group(1)):08d}.npy")
            if not os.path.exists(gt_path):
                continue
            pred = np.load(os.path.join(args.dir, f))
            gt = np.load(gt_path)
            if gt.shape != pred.shape:
                import cv2

                gt = cv2.resize(gt, pred.shape[::-1], interpolation=cv2.INTER_NEAREST)
            rows.append({"frame": f, **_rounded(metrics.depth_metrics(pred, gt))})
        assert rows, "no depth frame pairs found"
        keys = ("abs_rel", "rmse", "delta1")
    elif args.task == "semantic":
        pairs = collect_pairs(args)
        assert pairs, "no frame pairs found"
        for pred_path, gt_path in pairs:
            a = media.imread(pred_path)[:, :, ::-1]
            b = media.imread(gt_path)[:, :, ::-1]
            _, ia = media.decode_semantic(a.astype(np.float32))
            _, ib = media.decode_semantic(b.astype(np.float32))
            rows.append({"frame": os.path.basename(pred_path),
                         **_rounded(metrics.miou(ia, ib, 19))})
        keys = ("miou", "pixel_acc")
    else:
        pairs = collect_pairs(args)
        assert pairs, "no frame pairs found"
        import torch

        from ..utils import lpips as LP

        # LPIPS is weights-gated: without a local AlexNet-LPIPS state dict
        # the summary has no lpips key rather than an uncalibrated number
        lp_model = LP.load_lpips(args.lpips, device=args.device)
        for pred_path, gt_path in pairs:
            a = media.imread(pred_path).astype(np.float32) / 255.0
            b = media.imread(gt_path).astype(np.float32) / 255.0
            row = {
                "frame": os.path.basename(pred_path),
                "psnr": round(metrics.psnr(a, b, data_range=1.0), 4),
                "ssim": round(metrics.ssim(a[:, :, ::-1], b[:, :, ::-1], device=args.device), 4),
            }
            if lp_model is not None:
                # OpenCV reads BGR; LPIPS nets are RGB-calibrated, range [-1, 1]
                def rgb(x):
                    return torch.as_tensor((x[None, :, :, ::-1] * 2 - 1).copy(),
                                           device=args.device)

                with torch.no_grad():
                    row["lpips"] = round(float(LP.lpips(lp_model, rgb(a), rgb(b))[0]), 4)
            rows.append(row)
        keys = ("psnr", "ssim") + (("lpips",) if lp_model is not None else ())
    summary = {"task": args.task, "n_frames": len(rows)}
    for k in keys:
        vals = [r[k] for r in rows if r.get(k) is not None]
        summary[f"{k}_mean"] = round(float(np.mean(vals)), 4) if vals else None
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
