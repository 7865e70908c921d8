"""Precomputed VAE latents for training: a copy of `mudg_tpu/data/latents.py`.

The Waymo pipeline is deterministic per frame file (fixed resize +
center-crop, no augmentation, waymo_data.py:39-43), so the frozen encoder's
posterior moments (mean ++ logvar, the quant_conv output) can be computed
once per (file, load-kind) and reused for every step, epoch and task that
touches the frame. Sampling stays at train time (`training_loss` draws the
posterior sample from the moments), so the per-step latent noise law is the
one of on-the-fly encoding.

Cache layout: a sibling file per source frame —
    <frame>.<ext>            ->  <frame>.<ext>.z<H>x<W><kind>.npy
kind: 'b' rgb bilinear (dense targets), 'n' rgb nearest (sparse conditions),
      'd' depth .npy (clip [0,100] -> [-1,1]), 'm' normal .npy.
The moments are stored float16: (40, 64, 8) fp16 = 41 kB a frame at 320x512.

Producers: apps/precompute_latents.py (`precompute`, whose device part is
`encode_moments`). Consumers: WaymoDataset(latents=True) -> batches with
{dense,sparse,depth}_moments + sparse_frame0, consumed by
models.mdm.training_loss's moments form.
"""
from __future__ import annotations

import os

import numpy as np

from . import waymo as W


def latent_path(src: str, resolution, kind: str) -> str:
    """Sibling cache path for a source frame file. kind in {b, n, d, m}."""
    h, w = resolution
    return f"{src}.z{h}x{w}{kind}.npy"


def load_pixels(path: str, resolution, kind: str) -> np.ndarray:
    """Load ONE frame exactly as WaymoDataset.load_item does for its kind,
    returning (H, W, 3) float32 in [-1, 1] (normal kind may exceed)."""
    h, w = resolution
    if kind in ("b", "n"):
        img = W._imread_rgb(path, (w, h), nearest=(kind == "n")).astype(np.float32)
        img = W.resize_center_crop(img[None], resolution)[0]
        return (img / 255.0 - 0.5) * 2
    if kind == "d":
        d = W._load_depth_npy(path, (w, h)).astype(np.float32)
        d = W.resize_center_crop(d[None], resolution)[0]
        return (np.clip(d, 0, 100) / 100.0 - 0.5) * 2
    if kind == "m":
        n = np.load(path, allow_pickle=True)[0].astype(np.float32)
        return W.resize_center_crop(n[None], resolution)[0]
    raise ValueError(kind)


def collect_jobs(items: list[dict], resolution) -> list[tuple[str, str]]:
    """Unique (source path, kind) pairs covering every frame any task of any
    item can touch. Mirrors WaymoDataset.load_item's path construction."""
    jobs: dict[tuple[str, str], None] = {}

    def add(sample, base_key, kind, ext=None):
        if base_key not in sample:
            return
        base = sample[base_key]
        for fr in sample["frames"]:
            if ext is not None:
                fr = fr[:-4] + ext
            jobs.setdefault((os.path.join(base, fr), kind), None)

    for sample in items:
        add(sample, "dense_color_base", "b")
        add(sample, "dense_semantic_base", "b")
        add(sample, "dense_depth_base", "d", ext=".npy")
        add(sample, "dense_normal_base", "m", ext=".npy")
        add(sample, "sparse_color_base", "n")
        add(sample, "sparse_depth_base", "d", ext=".npy")
    return list(jobs.keys())


def encode_moments(vae, frames, dtype=None):
    """The device part of `precompute`: frames (N, H, W, 3) in [-1, 1] (a
    tensor on the VAE's device) -> their posterior moments (N, H/8, W/8, 2z)
    as float16, encoded in `dtype` (default bf16, the training encoder's
    dtype) by `nn/vae.encode_moments_video` in one call (chunk=0)."""
    import torch

    from ..nn import vae as V

    comp = torch.bfloat16 if dtype is None else dtype
    with torch.no_grad():
        m = V.encode_moments_video(vae, frames.to(comp)[None], chunk=0)[0]
    return m.to(torch.float16)


def precompute(items: list[dict], vae, resolution, batch: int = 16,
               skip_existing: bool = True, dtype=None, log=print) -> int:
    """Encode every job's frame to posterior moments and write the sibling
    .npy files (float16). Returns the number of files written. The tail
    batch is padded to `batch` frames, as the JAX package pads it."""
    import torch

    jobs = collect_jobs(items, resolution)
    if skip_existing:
        jobs = [(p, k) for p, k in jobs
                if not os.path.exists(latent_path(p, resolution, k))]
    if not jobs:
        return 0
    device = next(vae.parameters()).device
    written = 0
    for i in range(0, len(jobs), batch):
        chunk = jobs[i:i + batch]
        px = np.stack([load_pixels(p, resolution, k) for p, k in chunk])
        n = len(chunk)
        if n < batch:
            px = np.concatenate(
                [px, np.zeros((batch - n, *px.shape[1:]), px.dtype)])
        moments = encode_moments(vae, torch.from_numpy(px).to(device), dtype).cpu().numpy()
        for (p, k), m in zip(chunk, moments[:n]):
            np.save(latent_path(p, resolution, k), m)
        written += n
        if log and (i // batch) % 20 == 0:
            log(f"# latents {i + n}/{len(jobs)}")
    return written
