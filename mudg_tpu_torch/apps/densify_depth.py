"""Scene-level depth densification, the DepthLab stage.

Port of `mudg_tpu/apps/densify_depth.py` (reference
`data_process/depthlab_tools.py` __main__, :480-549): for every camera frame
of a processed scene, densify the sparse 6-frame lidar depth, lstsq-align it
to the lidar points, fill the sky from the SegFormer semantics, clamp to
[0, 100] m, and save Spectral visualizations at every stage:

    images/<cam>/NNNNNNNN.jpg            (input RGB)
    six_frames_depth/<cam>/NNNNNNNN.npy  (input sparse lidar depth)
    semantic/<cam>/seg/NNNNNNNN.pfm      (optional, sky class 10)
  ->
    six_frames_depth_dense/<cam>/NNNNNNNN.npy       raw prediction
    six_frames_depth_aligned/<cam>/NNNNNNNN.npy     lstsq metric alignment
    six_frames_depth_processed/<cam>/NNNNNNNN.npy   sky-filled + clamped
    six_frames_depth_vis/<cam>/NNNNNNNN{_sparse,,_aligned,_processed}.png

    python -m mudg_tpu_torch densify --scene <dir> [--depthlab_dir ckpt/] [--device cpu]

The densifier is DepthLab (`models/depthlab.py`) on the card (`--device`,
default cuda) when `--depthlab_dir` points at a local checkpoint directory,
else the classical fallback (`data/depth_tools.densify_classical`) on the
host. Images are read and written with OpenCV.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import depth_tools as DT
from ..utils import media


def _vis(depth: np.ndarray, max_depth: float = DT.MAX_DEPTH) -> np.ndarray:
    return media.visualize_depth(np.clip(depth, 0, max_depth), vmin=0, vmax=max_depth)


def densify_scene(scene: str, *, cameras=("camera_FRONT",), predictor=None,
                  limit_frames: int | None = None, use_semantic: bool = True):
    """Returns the number of frames processed."""
    done = 0
    for cam in cameras:
        cam_img = os.path.join(scene, "images", cam)
        cam_sparse = os.path.join(scene, "six_frames_depth", cam)
        if not os.path.isdir(cam_sparse):
            continue
        outs = {}
        for name in ("dense", "aligned", "processed", "vis"):
            outs[name] = os.path.join(scene, f"six_frames_depth_{name}", cam)
            os.makedirs(outs[name], exist_ok=True)

        frames = sorted(f for f in os.listdir(cam_sparse) if f.endswith(".npy"))
        if limit_frames:
            frames = frames[:limit_frames]
        for fname in frames:
            stem = fname[:-4]
            sparse = np.load(os.path.join(cam_sparse, fname))

            # sparse vis with holes blacked out (process_black,
            # depthlab_tools.py:90-112)
            vis_sp = _vis(sparse)
            vis_sp[sparse <= 0] = 0
            media.save_image(os.path.join(outs["vis"], stem + "_sparse.png"), vis_sp)

            image = None
            img_path = os.path.join(cam_img, stem + ".jpg")
            if os.path.exists(img_path):
                image = np.ascontiguousarray(media.imread(img_path)[:, :, ::-1])

            if predictor is not None:
                pred = predictor(sparse, image=image)
            else:
                pred = DT.densify_classical(sparse)
            np.save(os.path.join(outs["dense"], stem + ".npy"), pred.astype(np.float32))
            media.save_image(os.path.join(outs["vis"], stem + ".png"), _vis(pred))

            aligned, _ = DT.align_depth(pred, sparse)
            np.save(os.path.join(outs["aligned"], stem + ".npy"), aligned)
            media.save_image(os.path.join(outs["vis"], stem + "_aligned.png"), _vis(aligned))

            processed = aligned
            pfm = os.path.join(scene, "semantic", cam, "seg", stem + ".pfm")
            if use_semantic and os.path.exists(pfm):
                from ..data.segmentation import read_pfm

                sem, _ = read_pfm(pfm)
                processed = DT.fill_sky(processed, sem.astype(np.int32))
            processed = DT.clamp_metric(processed)
            np.save(os.path.join(outs["processed"], stem + ".npy"),
                    processed.astype(np.float32))
            media.save_image(os.path.join(outs["vis"], stem + "_processed.png"),
                             _vis(processed))
            done += 1
    return done


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scene", required=True)
    p.add_argument("--cameras", nargs="+",
                   default=["camera_FRONT", "camera_FRONT_LEFT", "camera_FRONT_RIGHT"])
    p.add_argument("--depthlab_dir", default=None,
                   help="DepthLab checkpoint dir (denoising_unet.pth, "
                        "reference_unet.pth, mapping_layer.pth, vae/); "
                        "classical fallback when omitted")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--strength", type=float, default=0.8)
    p.add_argument("--limit_frames", type=int, default=None)
    p.add_argument("--no_semantic", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device of DepthLab (default cuda)")
    args = p.parse_args(argv)

    predictor = None
    if args.depthlab_dir:
        from ..models.depthlab import DepthLabPredictor, load_depthlab_dir

        model, cfg, vae = load_depthlab_dir(args.depthlab_dir, device=args.device)
        if vae is None:
            raise SystemExit(f"no VAE found under {args.depthlab_dir}/vae")
        predictor = DepthLabPredictor(model, cfg, vae, steps=args.steps,
                                      strength=args.strength)

    n = densify_scene(args.scene, cameras=args.cameras, predictor=predictor,
                      limit_frames=args.limit_frames, use_semantic=not args.no_semantic)
    print(f"densified {n} frames")


if __name__ == "__main__":
    main()
