"""Waymo multi-task training dataset, batch loader and item lists
(host-side, numpy): a copy of `mudg_tpu/data/waymo.py`, the port's own.

Rebuild of `lvdm/data/waymo_data.py` (Waymo dataset, :17-415):
  * item lists are dict-per-line files ("frames" + per-modality base dirs),
  * per-item task sampling p(color)=0.5, p(semantic)=0.25,
    p(depth|normal)=0.25 (get_label, :342-362),
  * dense targets load INTER_LINEAR, sparse conditions INTER_NEAREST, and
    sparse frame 0 is replaced by the dense *color* frame 0 (:100,164,237,311),
  * depth targets/conditions: .npy, clamp [0,100] -> [-1,1], replicated to 3
    channels (:300-303,328-330,390-391),
  * class labels color=0, semantic=1, depth=500, normal=1000,
  * resize + center-crop applied jointly to (dense, sparse) (:39-43,106-110),
  * every item also carries the sparse_depth condition (:409-410).

Outputs are channels-last (T, H, W, 3) float32 in [-1, 1]; with the same
items and seed, `WaymoDataset` and `BatchLoader` give the JAX package's
arrays in its order. OpenCV is imported by the readers only, so the loader
runs over in-memory datasets where OpenCV is absent.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

import numpy as np

DEFAULT_CAPTION = "A photo a of driving scene."  # sic — waymo_data.py:60
CLASS_LABELS = {"color": 0, "semantic": 1, "depth": 500, "normal": 1000}


def read_items(path: str) -> list[dict]:
    """Item lists are python-dict literals, one per line
    (data/create_data_infos.py:81-89)."""
    with open(path) as f:
        return [ast.literal_eval(line) for line in f if line.strip()]


def _imread_rgb(path: str, size_wh, nearest: bool) -> np.ndarray:
    import cv2

    data = np.fromfile(path, np.uint8)
    img = cv2.imdecode(data, cv2.IMREAD_ANYCOLOR)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.resize(img, size_wh, interpolation=interp)


def _load_depth_npy(path: str, size_wh) -> np.ndarray:
    import cv2

    d = np.load(path, allow_pickle=True)
    d = cv2.resize(d, size_wh, interpolation=cv2.INTER_LINEAR)
    return np.repeat(d[:, :, None], 3, axis=2)


def resize_center_crop(frames: np.ndarray, resolution) -> np.ndarray:
    """torchvision Resize(min_side) + CenterCrop equivalent on (T, H, W, C)."""
    th, tw = resolution
    t, h, w, c = frames.shape
    scale = min(th, tw) / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    if (nh, nw) != (h, w):
        import cv2

        frames = np.stack(
            [cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR) for f in frames]
        )
    top = max((nh - th) // 2, 0)
    left = max((nw - tw) // 2, 0)
    return frames[:, top : top + th, left : left + tw]


@dataclass
class WaymoDataset:
    """Multi-task sampler over preprocessed scene directories.

    latents=True serves precomputed VAE posterior moments (data/latents.py
    sibling .npy caches, built by `python -m mudg_tpu_torch precompute-latents`)
    instead of pixel stacks, removing the frozen VAE encode from the
    training step."""
    items_path: str
    video_length: int = 16
    resolution: tuple = (320, 512)
    train_labels: tuple = ("color", "semantic", "depth")
    seed: int = 0
    latents: bool = False
    items: list = field(init=False)

    def __post_init__(self):
        self.items = read_items(self.items_path)
        self._rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.items)

    def sample_task(self) -> str:
        """Task probabilities (waymo_data.py:342-362)."""
        labels = self.train_labels
        if len(labels) == 1:
            return labels[0]
        r = self._rng.random()
        if len(labels) == 2:
            return labels[0] if r > 0.5 else labels[1]
        if r < 0.25:
            return "normal" if "normal" in labels else "depth"
        if r < 0.50:
            return "semantic"
        return "color"

    # -- per-modality frame loading -----------------------------------------

    def _paths(self, sample, base_key, ext=None):
        base = sample[base_key]
        out = []
        for fr in sample["frames"]:
            if ext is not None:
                fr = fr[:-4] + ext
            out.append(os.path.join(base, fr))
        return out

    def _load_rgb_stack(self, paths, nearest):
        h, w = self.resolution
        return np.stack([_imread_rgb(p, (w, h), nearest) for p in paths])

    def load_item_latents(self, index: int, task: str | None = None) -> dict:
        """Precomputed-moments form of load_item: per-frame posterior moment
        .npy caches instead of pixels (same task sampling, same frame-0
        splice — the spliced sparse[0] IS the dense color frame 0, so its
        cached moment is reused directly), plus the spliced frame-0 pixels
        for the CLIP image branch."""
        from . import latents as L

        task = task or self.sample_task()
        sample = self.items[index % len(self.items)]
        res = self.resolution

        def zload(paths, kind):
            def one(p):
                lp = L.latent_path(p, res, kind)
                try:
                    return np.load(lp).astype(np.float32)
                except FileNotFoundError:
                    raise FileNotFoundError(
                        f"latent cache missing for kind={kind!r} at "
                        f"resolution {res[0]}x{res[1]}: {lp} — run "
                        f"`python -m mudg_tpu_torch precompute-latents` for this "
                        f"scene/resolution first (or train without --latents)"
                    ) from None
            return np.stack([one(p) for p in paths])

        dense_color_paths = self._paths(sample, "dense_color_base")
        if task == "color":
            dense_m = zload(dense_color_paths, "b")
        elif task == "semantic":
            dense_m = zload(self._paths(sample, "dense_semantic_base"), "b")
        elif task == "depth":
            dense_m = zload(
                self._paths(sample, "dense_depth_base", ext=".npy"), "d")
        elif task == "normal":
            dense_m = zload(
                self._paths(sample, "dense_normal_base", ext=".npy"), "m")
        else:
            raise ValueError(task)

        sparse_m = zload(self._paths(sample, "sparse_color_base"), "n")
        sparse_m[0] = np.load(
            L.latent_path(dense_color_paths[0], res, "b")).astype(np.float32)
        depth_m = zload(
            self._paths(sample, "sparse_depth_base", ext=".npy"), "d")

        return {
            "dense_moments": dense_m,
            "sparse_moments": sparse_m,
            "depth_moments": depth_m,
            "sparse_frame0": L.load_pixels(dense_color_paths[0], res, "b"),
            "caption": DEFAULT_CAPTION,
            "fps": 10,
            "class_label": CLASS_LABELS[task],
        }

    def load_item(self, index: int, task: str | None = None) -> dict:
        """One training example; mirrors _get_{color,semantic,depth,normal} +
        _get_sparse_depth."""
        if self.latents:
            return self.load_item_latents(index, task)
        task = task or self.sample_task()
        sample = self.items[index % len(self.items)]
        h, w = self.resolution

        sparse = self._load_rgb_stack(
            self._paths(sample, "sparse_color_base"), nearest=True
        ).astype(np.float32)
        color_dense = self._load_rgb_stack(
            self._paths(sample, "dense_color_base"), nearest=False
        ).astype(np.float32)

        if task == "color":
            dense = color_dense
        elif task == "semantic":
            dense = self._load_rgb_stack(
                self._paths(sample, "dense_semantic_base"), nearest=False
            ).astype(np.float32)
        elif task == "depth":
            dense = np.stack([
                _load_depth_npy(p, (w, h))
                for p in self._paths(sample, "dense_depth_base", ext=".npy")
            ]).astype(np.float32)
        elif task == "normal":
            dense = np.stack([
                np.load(p, allow_pickle=True)[0]
                for p in self._paths(sample, "dense_normal_base", ext=".npy")
            ]).astype(np.float32)
        else:
            raise ValueError(task)

        # sparse frame 0 <- dense COLOR frame 0 (all tasks)
        sparse[0] = color_dense[0]

        dense = resize_center_crop(dense, self.resolution)
        sparse = resize_center_crop(sparse, self.resolution)

        # normalization per modality
        if task == "depth":
            dense = (np.clip(dense, 0, 100) / 100.0 - 0.5) * 2
        elif task != "normal":  # normals already in [-1,1]
            dense = (dense / 255.0 - 0.5) * 2
        sparse = (sparse / 255.0 - 0.5) * 2

        sparse_depth = np.stack([
            _load_depth_npy(p, (w, h))
            for p in self._paths(sample, "sparse_depth_base", ext=".npy")
        ]).astype(np.float32)
        sparse_depth = resize_center_crop(sparse_depth, self.resolution)
        sparse_depth = (np.clip(sparse_depth, 0, 100) / 100.0 - 0.5) * 2

        return {
            "dense_frames": dense,
            "sparse_frames": sparse,
            "sparse_depth": sparse_depth,
            "caption": DEFAULT_CAPTION,
            "fps": 10,
            "class_label": CLASS_LABELS[task],
        }


def make_item_list(scene_dir: str, cameras=("camera_FRONT", "camera_FRONT_LEFT",
                                            "camera_FRONT_RIGHT"),
                   window: int = 16, stride: int = 1, val_every: int = 200):
    """Scan processed scenes into 16-frame sliding windows, dict-per-line
    (data/create_data_infos.py:14-91). Returns (train_items, val_items)."""
    train, val = [], []
    count = 0
    for cam in cameras:
        img_dir = os.path.join(scene_dir, "images", cam)
        if not os.path.isdir(img_dir):
            continue
        frames = sorted(f for f in os.listdir(img_dir) if f.endswith((".jpg", ".png")))
        for start in range(0, len(frames) - window + 1, stride):
            item = {
                "scene": scene_dir,
                "camera": cam,
                "frames": frames[start : start + window],
                "dense_color_base": img_dir,
                "sparse_color_base": os.path.join(scene_dir, "sparse", cam),
                "dense_semantic_base": os.path.join(scene_dir, "semantic_dense", cam),
                "dense_depth_base": os.path.join(scene_dir, "six_frames_depth", cam),
                "sparse_depth_base": os.path.join(scene_dir, "depth", cam),
            }
            (val if count % val_every == 0 else train).append(item)
            count += 1
    return train, val


def write_items(path: str, items: list[dict]):
    with open(path, "w") as f:
        for it in items:
            f.write(repr(it) + "\n")


class BatchLoader:
    """Host-side batch loader with background prefetch.

    Collates numpy items into batches shaped for the train step ((accum, B,
    ...) when accum > 1). With prefetch > 0 (default 2), item loading + jpeg
    decode run in a daemon thread feeding a bounded queue, so host IO
    overlaps device compute — the analog of the reference's
    num_workers dataloaders (config.yaml:129; SURVEY §7.3 host/device
    split). cv2/file IO release the GIL, so one thread suffices; exceptions
    re-raise at the consumer."""

    def __init__(self, dataset: WaymoDataset, batch_size: int, accum_steps: int = 1,
                 tokenizer=None, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.accum = accum_steps
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def _batches(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            self._rng.shuffle(order)
        n_per = self.batch_size * self.accum
        for i in range(0, len(order) - n_per + 1, n_per):
            idxs = order[i : i + n_per]
            items = [self.ds.load_item(int(j)) for j in idxs]
            batch = self.collate(items)
            if self.accum > 1:
                batch = {
                    k: v.reshape(self.accum, self.batch_size, *v.shape[1:])
                    for k, v in batch.items()
                }
            yield batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
                put(_END)
            except BaseException as e:  # propagate to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # unblock the worker if iteration was abandoned

    # pixel-batch and cached-latent-batch array keys (training_loss accepts
    # either form; see models/mdm.py batch-key docstring)
    _STACK_KEYS = ("dense_frames", "sparse_frames", "sparse_depth",
                   "dense_moments", "sparse_moments", "depth_moments",
                   "sparse_frame0")

    def collate(self, items: list[dict]) -> dict:
        out = {
            k: np.stack([it[k] for it in items])
            for k in self._STACK_KEYS if k in items[0]
        }
        out["class_label"] = np.asarray(
            [it["class_label"] for it in items], np.int32)
        out["fps"] = np.asarray([it["fps"] for it in items], np.int32)
        if self.tokenizer is not None:
            out["tokens"] = self.tokenizer([it["caption"] for it in items])
        return out


def make_virtual_item_list(scene_dir: str, cameras=("camera_FRONT",),
                           window: int = 16, virtual_index: int = 1,
                           stride: int | None = None):
    """Inference item list over VIRTUAL-pose conditions
    (virtual_render/generate_virtual_item.py:13-50): one item per valid
    center frame (window//2 margin on both sides), dense GT from images/
    with plain frame names, sparse RGB/depth from virtual_sparse/ and
    virtual_depth/ with the {frame}_{pose} suffixed names written by
    make_conditions --render_virtual.

    stride defaults to window//2 (the autoregressive advance used by
    render_infer) so consecutive items tile the sequence.
    """
    stride = stride or max(window // 2, 1)
    items = []
    for cam in cameras:
        img_dir = os.path.join(scene_dir, "images", cam)
        if not os.path.isdir(img_dir):
            continue
        frames = sorted(f for f in os.listdir(img_dir)
                        if f.endswith((".jpg", ".png")))
        for start in range(0, max(len(frames) - window + 1, 0), stride):
            win = frames[start : start + window]
            suffixed = [f"{fr[:-4]}_{virtual_index}{fr[-4:]}" for fr in win]
            items.append({
                "scene": scene_dir,
                "camera": cam,
                "virtual_index": virtual_index,
                "frames": win,
                "dense_color_base": img_dir,
                "dense_semantic_base": os.path.join(scene_dir, "semantic_dense", cam),
                "dense_depth_base": os.path.join(scene_dir, "six_frames_depth", cam),
                "sparse_color_base": os.path.join(scene_dir, "virtual_sparse", cam),
                "sparse_color_base_frames": suffixed,
                "sparse_depth_base": os.path.join(scene_dir, "virtual_depth", cam),
                "sparse_depth_base_frames": suffixed,
            })
    return items
