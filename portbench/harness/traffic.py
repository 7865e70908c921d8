"""The general traffic generator: condition windows, token ids and the
per-purpose seeds, all drawn from the run's seed.

A served window is what `chip_smoke.py`'s `serve_windows` makes (copied
here, its draws moved onto the card): sparse color and depth videos and a
dense frame 0 uniform in [-1, 1] at the configuration's size, and the
mix's task labels. Token ids stand in for a prompt as the port's
`HashTokenizer` lays them out: start, `prompt_words` ids, end, zeros; the
null prompt is start, end, zeros.
"""
from __future__ import annotations

import hashlib

import numpy as np


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, traffic, sampler, ...) of the
    run's seed, so that each draws from its own stream."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def windows(cfg: dict, mix: dict, seed: int, device):
    """An endless stream of condition windows for `render_windows`, each a
    dict of host arrays: "sparse_frames" and "sparse_depth" (T, H, W, 3),
    "frame0" (H, W, 3), "class_labels" (tasks,)."""
    import torch

    t, h, w = cfg["video_length"], cfg["height"], cfg["width"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic"))
    labels = np.asarray(mix["class_labels"], np.int32)

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1).cpu().numpy()

    while True:
        yield {"sparse_frames": uniform(t, h, w, 3), "frame0": uniform(h, w, 3),
               "sparse_depth": uniform(t, h, w, 3), "class_labels": labels}


def tokens(cfg: dict, mix: dict, seed: int):
    """(token ids (tasks, context), null ids (context,)) as int64 arrays: one
    prompt of `prompt_words` ids, the same for every task, as `render` and
    `serve` send one prompt for the three tasks."""
    text = cfg["clip_text"]
    vocab, ctx = text["vocab_size"], text["context_length"]
    sot, eot = vocab - 2, vocab - 1
    rng = np.random.default_rng(sub_seed(seed, "tokens"))
    words = rng.integers(1, vocab - 2, mix["prompt_words"])
    ids = np.zeros(ctx, np.int64)
    ids[:len(words) + 2] = [sot, *words, eot]
    null = np.zeros(ctx, np.int64)
    null[:2] = [sot, eot]
    return np.stack([ids] * len(mix.get("class_labels", [0]))), null


def splice(window: dict, previous, video_length: int):
    """The condition a window is served with, by the autoregressive carry
    (virtual_pose_render.py:246-274): with a previous clip (tasks, T, H, W,
    3), the first half of the sparse color video is that clip's color
    second half, and frame 0 the window's dense frame 0."""
    sparse = window["sparse_frames"].copy()
    if previous is not None:
        half = video_length // 2
        sparse[:half] = previous[0, half:]
        sparse[0] = window["frame0"]
    return sparse
