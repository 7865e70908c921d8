"""3DGS scene refinement app (port of `mudg_tpu/apps/refine_gs.py`).

The MuDG pipeline's third stage: seed Gaussians from the aggregated LiDAR
cloud, optimize them against generated dense RGB (+ depth, + semantics)
supervision, then render held-out and laterally shifted novel views.

Inputs:
  --scene          processed scene dir (objects/background.ply, scenario.pt)
  --supervision    render_infer output dir (virtual_color/ + virtual_depth/)
                   or any dir of color_re_{i}.png frames; the scene's dense
                   images when omitted
Outputs: metrics.json, gaussians.pkl, gaussians.ply (INRIA layout),
renders/ (holdout PNGs), with --render_virtual virtual_renders/ and mp4s.

Usage:
    python -m mudg_tpu_torch refine-gs --scene <dir> --out out/ [--steps 2000] [--device cuda]

`load_views` reads the files (OpenCV, imported lazily); `refine` trains and
renders on in-memory views and writes nothing, so it runs where OpenCV is
not installed.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def load_views(scene: str, supervision: str | None, cam: str, resolution,
               limit: int | None = None, semantic: bool = False):
    """Training views as numpy dicts: K, w2c, rgb target (+ optional depth,
    depth_mask and semantic class ids) and the frame index."""
    import cv2

    from ..utils import media

    with open(os.path.join(scene, "scenario.pt"), "rb") as f:
        data = pickle.load(f)
    camera = data["observers"][cam]
    n = camera["n_frames"]
    if limit:
        n = min(n, limit)
    h, w = resolution

    views = []
    for i in range(n):
        K = np.asarray(camera["data"]["intr"][i], np.float32).copy()
        c2w = np.asarray(camera["data"]["c2w"][i], np.float32)
        h0, w0 = (int(v) for v in camera["data"]["hw"][i])
        K[0] *= w / w0   # intrinsics at the working resolution
        K[1] *= h / h0

        img_path = None
        if supervision:
            for cand in (os.path.join(supervision, f"color_re_{i}.png"),
                         os.path.join(supervision, "virtual_color", f"color_re_{i}.png")):
                if os.path.exists(cand):
                    img_path = cand
                    break
        if img_path is None:
            img_path = os.path.join(scene, "images", cam, f"{i:08d}.jpg")
        if not os.path.exists(img_path):
            continue
        img = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        view = {"K": K, "w2c": np.linalg.inv(c2w).astype(np.float32),
                "rgb": img.astype(np.float32) / 255.0, "frame": i}
        dpath = os.path.join(supervision or "", "virtual_depth", f"depth_re_{i}.npy")
        if supervision and os.path.exists(dpath):
            d = cv2.resize(np.load(dpath), (w, h), interpolation=cv2.INTER_NEAREST)
            view["depth"] = d.astype(np.float32)
            view["depth_mask"] = (d > 0).astype(np.float32)
        if semantic:
            # generated semantics first, else the scene's SegFormer maps
            for cand in (os.path.join(supervision or "", "virtual_semantic",
                                      f"semantic_re_{i}.png"),
                         os.path.join(scene, "semantic_dense", cam, f"{i:08d}.jpg")):
                if os.path.exists(cand):
                    sem_img = cv2.cvtColor(cv2.imread(cand), cv2.COLOR_BGR2RGB)
                    sem_img = cv2.resize(sem_img, (w, h), interpolation=cv2.INTER_NEAREST)
                    view["sem_ids"] = media.decode_semantic(sem_img)[1].astype(np.int32)
                    break
        views.append(view)
    return views


def _device_view(v: dict, device):
    """A view (numpy arrays or tensors) as tensors on `device`; float arrays
    as float32."""
    import torch

    out = {}
    for k, a in v.items():
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        out[k] = a.to(device, torch.float32 if a.is_floating_point() else None)
    return out


def initial_cloud(scene: str, capacity: int, voxel: float, device):
    """The background cloud refine-gs starts from (numpy): objects/
    background.ply, voxel downsampled on `device` where it holds more than
    capacity // 2 points (the cells as JAX's native library picks them,
    rows sorted by cell), cut to `capacity`."""
    import torch

    from ..render import pointcloud as PC

    xyz, rgb, _ = PC.fetch_ply(os.path.join(scene, "objects", "background.ply"))
    if len(xyz) > capacity // 2:
        xyz, rgb = (a.cpu().numpy() for a in PC.voxel_downsample(
            torch.as_tensor(xyz, device=device), torch.as_tensor(rgb, device=device), voxel))
    n0 = min(len(xyz), capacity)
    return xyz[:n0], rgb[:n0]


def refine(g, train_views: list[dict], hold_views: list[dict], cfg, *, width: int,
           height: int, steps: int, render_views=None, shift: float = 2.0,
           on_step=None) -> dict:
    """Fit `g` to the training views, then render the holdout views (the
    first four training views when there are none) and, with `render_views`,
    the +-shift lateral virtual trajectory of each of those views. Views are
    dicts of numpy arrays (as `load_views` returns them, without "frame") or
    tensors. Returns
    {"state", "history", "holdout": [(image (H, W, 3) f32, semantic ids or
    None)], "psnrs", "sem_accs", "virtual": {"left": [...], "right": [...]}
    of uint8 images, "dropped_renders"}. `on_step` goes to `fit_scene`."""
    import torch

    from ..gs import gaussians as G
    from ..gs import train as GT
    from ..render.splat import virtual_poses
    from ..utils import metrics

    dev = g.means.device
    views_t = [_device_view(v, dev) for v in train_views]
    state, history = GT.fit_scene(g, views_t, cfg, width=width, height=height, steps=steps,
                                  log_every=max(steps // 20, 1), on_step=on_step)
    raster = GT.pick_raster(cfg, width, height)
    dropped = []

    def render(gg, K, w2c, what):
        with torch.no_grad():
            if gg.sem is not None:
                out = raster(gg, K, w2c, features=torch.softmax(gg.sem, -1))
            else:
                out = raster(gg, K, w2c)
        if out.n_dropped:
            dropped.append({"view": what, "n_dropped": int(out.n_dropped)})
            print(f"WARNING: {what}: {out.n_dropped} pairs over the rasterizer budget "
                  "were dropped; re-run with a larger --max_pairs for exact output",
                  flush=True)
        return out

    def view_gaussians(v):
        if "obj_T" in v:
            return G.apply_group_transforms(state.gaussians, v["obj_T"], v["obj_vis"])
        return state.gaussians

    holdout, psnrs, sem_accs = [], [], []
    for i, v in enumerate(hold_views or train_views[:4]):
        vt = _device_view(v, dev)
        out = render(view_gaussians(vt), vt["K"], vt["w2c"], f"holdout {i}")
        img = out.color.float().cpu().numpy()
        psnrs.append(metrics.psnr(img, vt["rgb"].cpu().numpy(), data_range=1.0))
        pred = None
        if out.features is not None and "sem_ids" in vt:
            pred = out.features.argmax(-1).cpu().numpy()
            covered = out.alpha.cpu().numpy() > 0.5
            if covered.any():
                sem_accs.append(float((pred[covered] == vt["sem_ids"].cpu().numpy()[covered])
                                      .mean()))
        holdout.append((img, pred))

    virtual = {"left": [], "right": []}
    for i, v in enumerate(render_views or []):
        vt = _device_view(v, dev)
        gv = view_gaussians(vt)   # one group transform per frame
        c2w = np.linalg.inv(vt["w2c"].cpu().numpy().astype(np.float64))
        for side, vpose in zip(virtual, virtual_poses(c2w, shift=shift, with_original=False)):
            w2c_v = torch.as_tensor(np.linalg.inv(vpose), dtype=torch.float32, device=dev)
            out = render(gv, vt["K"], w2c_v, f"virtual {side} {i}")
            virtual[side].append(
                (np.clip(out.color.float().cpu().numpy(), 0, 1) * 255).astype(np.uint8))
    return {"state": state, "history": history, "holdout": holdout, "psnrs": psnrs,
            "sem_accs": sem_accs, "virtual": virtual, "dropped_renders": dropped}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--supervision", default=None,
                   help="render_infer output dir with generated frames")
    p.add_argument("--camera", default="camera_FRONT")
    p.add_argument("--height", type=int, default=160)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--capacity", type=int, default=200_000)
    p.add_argument("--voxel", type=float, default=0.15)
    p.add_argument("--limit_frames", type=int, default=None)
    p.add_argument("--holdout_every", type=int, default=8)
    p.add_argument("--sh_degree", type=int, default=0, choices=(0, 1, 2, 3),
                   help="spherical-harmonics degree for view-dependent color "
                        "(0 = plain RGB; 3 = full 3DGS)")
    p.add_argument("--semantic", action="store_true",
                   help="train a per-gaussian semantic field against the generated "
                        "(or SegFormer) class maps and report holdout pixel accuracy")
    p.add_argument("--semantic_weight", type=float, default=0.5)
    p.add_argument("--appearance", action="store_true",
                   help="learn a per-training-view affine color transform absorbing "
                        "exposure drift; holdout renders use the raw scene colors")
    p.add_argument("--dynamic", action="store_true",
                   help="dynamic scene: per-object gaussian groups seeded from "
                        "objects_info.pkl canonical clouds, moved per frame by the "
                        "tracked box poses")
    p.add_argument("--init_gaussians", default=None,
                   help="warm-start from an INRIA-layout gaussians .ply instead of "
                        "the point cloud; incompatible with --dynamic")
    p.add_argument("--render_virtual", action="store_true",
                   help="after refinement, render the +/-shift lateral virtual "
                        "trajectories and write PNGs + mp4s")
    p.add_argument("--shift", type=float, default=2.0)
    p.add_argument("--max_pairs", type=int, default=0,
                   help="tile-rasterizer pair budget; 0 (default) sizes the pair "
                        "buffer exactly every render")
    p.add_argument("--raster_backend", default="auto", choices=("auto", "pallas", "xla"),
                   help="auto and pallas = the tile rasterizer (kernel 13 on the "
                        "card), xla = the capped sort+scan path")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    from ..gs import gaussians as G
    from ..gs import train as GT
    from ..gs.io import load_gaussians_ply, save_gaussians_ply
    from ..utils import media

    dev = torch.device(args.device)
    xyz, rgb = initial_cloud(args.scene, args.capacity, args.voxel, dev)
    n0 = len(xyz)
    grp = obj_info = None
    if args.dynamic:
        with open(os.path.join(args.scene, "objects_info.pkl"), "rb") as f:
            obj_info = pickle.load(f)
        obj_info = [o for o in obj_info if len(o["point_cloud"]["points"])]
        # objects get their slots first: a capacity-filling background must
        # never truncate the dynamic groups
        n_obj = sum(len(o["point_cloud"]["points"]) for o in obj_info)
        assert n_obj < args.capacity, \
            f"--capacity {args.capacity} cannot hold {n_obj} object points"
        if n0 > args.capacity - n_obj:
            n0 = args.capacity - n_obj
            print(f"dynamic: background trimmed to {n0} points to reserve {n_obj} object slots")
        xs, cs, gi = [xyz[:n0]], [rgb[:n0]], [np.zeros(n0, np.int32)]
        for j, o in enumerate(obj_info):
            pts = np.asarray(o["point_cloud"]["points"], np.float32)
            xs.append(pts)
            cs.append(np.asarray(o["point_cloud"]["colors"], np.float32))
            gi.append(np.full(len(pts), j + 1, np.int32))
        xyz, rgb, grp = np.concatenate(xs), np.concatenate(cs), np.concatenate(gi)
        n0 = len(xyz)
    if args.init_gaussians:
        assert not args.dynamic, "--init_gaussians + --dynamic unsupported"
        g0 = load_gaussians_ply(args.init_gaussians)
        n0 = min(g0.n, args.capacity)
        pad = args.capacity - n0

        def padded(x, fill=0.0):
            x = x[:n0]
            return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill)]).to(dev)

        g = G.Gaussians(means=padded(g0.means), log_scales=padded(g0.log_scales),
                        quats=padded(g0.quats), opacity=padded(g0.opacity, -6.0),
                        colors=padded(g0.colors),
                        active=torch.arange(args.capacity, device=dev) < n0,
                        sh=None if g0.sh is None else padded(g0.sh))
        print(f"warm start: {n0} splats from {args.init_gaussians}")
    else:
        g = G.init_from_points(torch.from_numpy(np.ascontiguousarray(xyz)).to(dev),
                               torch.from_numpy(np.ascontiguousarray(rgb)).to(dev),
                               capacity=args.capacity)
        if grp is not None:
            pad = np.zeros(args.capacity, np.int32)
            pad[:n0] = grp
            g = g._replace(group=torch.from_numpy(pad).to(dev))
            print(f"dynamic: {len(obj_info)} tracked objects as rigid groups")
    print(f"init: {n0} gaussians (capacity {args.capacity})")

    views = load_views(args.scene, args.supervision, args.camera, (args.height, args.width),
                       limit=args.limit_frames, semantic=args.semantic)
    assert views, "no training views found"
    if args.semantic:
        assert any("sem_ids" in v for v in views), \
            "--semantic: no semantic maps found (supervision dir or scene)"
    if args.dynamic:
        # per-frame canonical->world transform and visibility per rigid group
        # (row 0 = static background); untracked frames hide the object
        n_frames = max(v["frame"] for v in views) + 1
        n_groups = 1 + len(obj_info)
        T_tab = np.tile(np.eye(4, dtype=np.float32), (n_frames, n_groups, 1, 1))
        vis_tab = np.zeros((n_frames, n_groups), bool)
        vis_tab[:, 0] = True
        for j, o in enumerate(obj_info):
            for f_i in range(min(n_frames, len(o["transform_obj"]))):
                T_tab[f_i, j + 1] = np.asarray(o["transform_obj"][f_i], np.float32)
                vis_tab[f_i, j + 1] = bool(np.asarray(o["visibility"])[f_i])
        for v in views:
            v["obj_T"] = T_tab[v["frame"]]
            v["obj_vis"] = vis_tab[v["frame"]]
    for v in views:
        v.pop("frame")
    train_views = [v for i, v in enumerate(views) if i % args.holdout_every != 0]
    hold_views = [v for i, v in enumerate(views) if i % args.holdout_every == 0]
    if not train_views:
        train_views = views
    print(f"views: {len(train_views)} train / {len(hold_views)} holdout")
    if args.semantic:
        assert any("sem_ids" in v for v in train_views), \
            "--semantic: no semantic maps in the training split"

    cfg = GT.GSConfig(backend=args.raster_backend, sh_degree=args.sh_degree,
                      semantic_weight=args.semantic_weight if args.semantic else 0.0,
                      appearance=args.appearance, max_pairs=args.max_pairs or None)
    r = refine(g, train_views, hold_views, cfg, width=args.width, height=args.height,
               steps=args.steps, render_views=views if args.render_virtual else None,
               shift=args.shift)
    state = r["state"]

    os.makedirs(os.path.join(args.out, "renders"), exist_ok=True)
    for i, (img, pred) in enumerate(r["holdout"]):
        media.save_image(os.path.join(args.out, "renders", f"nv_{i:04d}.png"),
                         (np.clip(img, 0, 1) * 255).astype(np.uint8))
        if pred is not None:
            media.save_image(os.path.join(args.out, "renders", f"sem_{i:04d}.png"),
                             media.encode_semantic(pred).astype(np.uint8))
    if args.render_virtual:
        for side, frames in r["virtual"].items():
            for i, img in enumerate(frames):
                media.save_image(os.path.join(args.out, "virtual_renders", side,
                                              f"nv_{i:04d}.png"), img)
            media.save_video(os.path.join(args.out, f"virtual_{side}.mp4"), np.stack(frames),
                             fps=10)

    psnrs, sem_accs = r["psnrs"], r["sem_accs"]
    result = {
        "n_gaussians_active": int(state.gaussians.active.sum()),
        "holdout_psnr_mean": float(np.mean(psnrs)) if psnrs else None,
        "holdout_semantic_acc": float(np.mean(sem_accs)) if sem_accs else None,
        "dropped_renders": r["dropped_renders"],   # nonempty = budget exceeded
        "history": r["history"],
    }
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(result, f, indent=2)
    with open(os.path.join(args.out, "gaussians.pkl"), "wb") as f:
        pickle.dump({k: getattr(state.gaussians, k).detach().cpu().numpy()
                     for k in state.gaussians._fields
                     if getattr(state.gaussians, k) is not None}, f)
    n_ply = save_gaussians_ply(os.path.join(args.out, "gaussians.ply"), state.gaussians)
    print(f"wrote gaussians.ply ({n_ply} splats, INRIA 3DGS layout)")
    print(json.dumps({k: result[k] for k in ("n_gaussians_active", "holdout_psnr_mean")}))


if __name__ == "__main__":
    main()
