"""Semantic segmentation stage (SegFormer-B3 cityscapes).

Port of `mudg_tpu/data/segmentation.py` (reference
`data_process/pipeline_segment.py`, `tools/semantic_tools.py`):
  * the .pfm writer and reader the pipeline stores class ids in,
  * `segment_frames`: drives any `predictor(image) -> class_ids` over one
    camera directory and writes seg/<frame>.pfm + semantic_dense/<frame>.jpg,
  * `load_segformer_predictor`: the port's SegFormer-B3 on the card (or the
    CPU, where the caller asks for it) with weights from a local HF
    checkpoint. Weights are looked up locally only; nothing is downloaded.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils import media


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0):
    """Grayscale little-endian PFM (semantic_tools.read_semantic_pfm inverse)."""
    data = np.asarray(data, np.float32)
    assert data.ndim == 2
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        f.write(np.flipud(data).astype("<f4").tobytes())


def read_pfm(path: str):
    """PFM reader (semantic_tools.py:7-43). Returns (data, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode().rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        dims = f.readline().decode().split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().decode().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), endian + "f4")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


class SegFormerPredictor:
    """image (H, W, 3) uint8 RGB -> class ids (H, W) int32, through a loaded
    SegFormer on its device."""

    def __init__(self, model):
        self.model = model

    def __call__(self, image: np.ndarray) -> np.ndarray:
        import torch

        from ..models import segformer as S

        dev = next(self.model.parameters()).device
        img = torch.as_tensor(np.asarray(image, np.float32) / 255.0, device=dev)
        with torch.no_grad():
            return S.segment(self.model, img).cpu().numpy()


def load_segformer_predictor(model_path: str | None = None, device="cuda", cfg=None):
    """SegFormer predictor (B3 unless `cfg` says otherwise) with weights
    imported from a local HuggingFace checkpoint (a directory with
    model.safetensors / pytorch_model.bin, or a bare state-dict file), on
    `device` (the card unless the caller asks for the CPU). Returns None when
    no weights are found locally."""
    sd = _load_local_segformer_weights(model_path)
    if sd is None:
        return None
    import torch

    from ..models import segformer as S

    with torch.device("meta"):
        model = S.SegFormer(cfg or S.SegFormerConfig())
    model.to_empty(device=device)
    S.load_hf_state_dict(model, sd)
    return SegFormerPredictor(model.eval())


def _load_local_segformer_weights(model_path: str | None):
    """Local-only weight lookup: explicit path, MUDG_SEGFORMER_PATH, then
    the HF cache for the standard cityscapes-B3 repo where huggingface_hub
    is installed and the snapshot was ever fetched."""
    candidates = []
    if model_path:
        candidates.append(model_path)
    env = os.environ.get("MUDG_SEGFORMER_PATH")
    if env:
        candidates.append(env)
    try:  # a resolved HF cache snapshot, without any network access
        from huggingface_hub import snapshot_download

        candidates.append(snapshot_download(
            "nvidia/segformer-b3-finetuned-cityscapes-1024-1024",
            local_files_only=True))
    except Exception:
        pass

    for cand in candidates:
        try:
            if os.path.isdir(cand):
                for fname in ("model.safetensors", "pytorch_model.bin"):
                    f = os.path.join(cand, fname)
                    if os.path.exists(f):
                        return _read_weight_file(f)
            elif os.path.exists(cand):
                return _read_weight_file(cand)
        except Exception:
            continue
    return None


def _read_weight_file(path: str):
    """A safetensors or torch-pickle state dict as numpy arrays (the port's
    own readers)."""
    from ..train.checkpoint import load_torch_state_dict

    return load_torch_state_dict(path)


def segment_frames(image_dir: str, out_root: str, cam: str, predictor,
                   palette_dir: str | None = None):
    """pipeline_segment over one camera directory: writes
    seg/NNNNNNNN.pfm and optionally semantic_dense/NNNNNNNN.jpg. Images are
    read and written through `utils/media` (OpenCV)."""
    seg_dir = os.path.join(out_root, cam, "seg")
    os.makedirs(seg_dir, exist_ok=True)
    if palette_dir:
        os.makedirs(os.path.join(palette_dir, cam), exist_ok=True)

    frames = sorted(f for f in os.listdir(image_dir) if f.endswith((".jpg", ".png")))
    for i, fname in enumerate(frames):
        img = np.ascontiguousarray(media.imread(os.path.join(image_dir, fname))[:, :, ::-1])
        ids = predictor(img)
        write_pfm(os.path.join(seg_dir, f"{i:08d}.pfm"), ids.astype(np.float32))
        if palette_dir:
            media.save_image(os.path.join(palette_dir, cam, f"{i:08d}.jpg"),
                             media.encode_semantic(ids))
    return len(frames)
