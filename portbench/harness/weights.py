"""Seeded weights: a state dict of the configuration's every weight, drawn
on the card from the run's seed in one normal draw per sub-model, in the
type the model is served in.

Every weight is random, the layers a trained checkpoint or the program's
initialiser would hold at zero included, so that no path of the model is
silent. Matrices and kernels are N(0, 1 / fan_in) (embedding tables, the
positional tables and the resampler's latents over their last axis), norm
scales 1 + 0.1 N(0, 1), biases and other vectors 0.1 N(0, 1).
"""
from __future__ import annotations

import math

from .traffic import sub_seed

SUBMODELS = ("unet", "vae", "image_proj", "clip_text", "clip_image")


def _law(name: str, shape) -> tuple[float, float]:
    """(scale, shift) of a weight's N(0, 1) draw."""
    last = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        if "embedding" in name or last == "latents":
            return shape[-1] ** -0.5, 0.0
        return math.prod(shape[1:]) ** -0.5, 0.0
    if last == "weight":
        return 0.1, 1.0
    if "embedding" in name:
        return shape[-1] ** -0.5, 0.0
    return 0.1, 0.0


def make(shapes: dict, seed: int, device, dtype=None) -> dict:
    """name -> tensor in `dtype` (bfloat16 by default) on `device`, for every
    name of `shapes`, the same on every call with the same seed."""
    import torch

    dtype = torch.bfloat16 if dtype is None else dtype
    out = {}
    for sub in SUBMODELS:
        names = [n for n in shapes if n.split(".", 1)[0] == sub]
        total = sum(math.prod(shapes[n]) for n in names)
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights." + sub))
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        for n in names:
            size = math.prod(shapes[n])
            scale, shift = _law(n, shapes[n])
            t = flat[off:off + size].view(shapes[n])
            t.mul_(scale)
            if shift:
                t.add_(shift)
            out[n] = t
            off += size
    return out
