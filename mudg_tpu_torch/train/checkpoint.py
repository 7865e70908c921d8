"""Checkpoint import: a MuDG / DynamiCrafter torch `.ckpt` -> one torch
state dict per sub-model of `models/mdm.MDM`.

The loading half of `mudg_tpu/train/checkpoint.py`, copied:
  * the three layouts the reference accepts: PL {'state_dict': ...},
    deepspeed {'module': {...}} with the 16-char '_forward_module.' prefix
    stripped, and a raw state dict (main/utils_train.py:145-166,
    virtual_render/virtual_pose_render.py:26-51);
  * the legacy key rename framestride_embed -> fps_embedding
    (virtual_pose_render.py:38-43);
  * the DynamiCrafter -> MuDG surgery: conv_in 8 -> 12 channels (channels
    4:8 duplicated, the whole kernel x0.5, main/utils_train.py:198-220) and
    class_embed cloned from time_embed (main/utils_train.py:172-195).
The JAX package then moves every leaf into its channels-last layout; the
port's modules hold the torch layouts, so the leaves stay as stored (fp16
and bf16 leaves become fp32). The zip reader is restricted: it rebuilds
tensors from their storages and calls no constructor of the pickle's own.
"""
from __future__ import annotations

import io
import pickle
import zipfile
from typing import Mapping

import numpy as np
import torch

_BUFFER_SKIP_SUFFIXES = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights",
    "scale_arr", "cond_ids", "logvar", "attn_mask",
)

# The sub-model prefixes of a full MuDG/LatentVisualDiffusion checkpoint
# (lvdm/models/ddpm3d.py:86,529-530,1037-1041).
PREFIXES = {
    "unet": "model.diffusion_model.",
    "vae": "first_stage_model.",
    "image_proj": "image_proj_model.",
    "clip_text": "cond_stage_model.",
    "clip_image": "embedder.",
}
# Where the towers' own modules sit inside their prefixes: the open_clip
# text model, and the visual tower of the image embedder's open_clip model
# (the sub-trees the JAX render app takes, render_infer.py:36-42)
TOWERS = {"clip_text": "model.", "clip_image": "model.visual."}
# The open_clip leaves a published checkpoint pickles with the towers but the
# towers never read: the text model's projection and logit scale, the visual
# tower's ln_post and projection (mudg_tpu/conditioning/clip.py:7,104, "no
# ln_post, no projection"). The JAX app loads them and leaves them unread;
# the port's towers have no such modules, so they are dropped by name here
# and every other key still loads strictly.
UNREAD = {"clip_text": ("text_projection", "logit_scale"),
          "clip_image": ("ln_post.weight", "ln_post.bias", "proj")}


def _load_torch_pickle(path: str) -> Mapping[str, np.ndarray]:
    """Read a torch checkpoint into numpy arrays.

    Torch >=1.6 .ckpt files are zip archives: `archive/data.pkl` holds the
    object graph with persistent ids pointing at raw little-endian tensor
    storages under `archive/data/`. We unpickle with a custom Unpickler that
    rebuilds tensors as numpy arrays. Falls back to torch.load for legacy
    formats.
    """
    _DTYPES = {
        "FloatStorage": np.float32, "HalfStorage": np.float16,
        "DoubleStorage": np.float64, "LongStorage": np.int64,
        "IntStorage": np.int32, "ShortStorage": np.int16,
        "CharStorage": np.int8, "ByteStorage": np.uint8,
        "BoolStorage": np.bool_, "BFloat16Storage": None,  # handled below
    }

    if not zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=False)

    zf = zipfile.ZipFile(path)
    names = zf.namelist()
    prefix = names[0].split("/")[0]

    storages: dict[str, np.ndarray] = {}

    def load_storage(storage_key, dtype_name):
        if storage_key in storages:
            return storages[storage_key]
        raw = zf.read(f"{prefix}/data/{storage_key}")
        if dtype_name == "BFloat16Storage":
            u16 = np.frombuffer(raw, dtype=np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=_DTYPES[dtype_name]).copy()
        storages[storage_key] = arr
        return arr

    class _TensorStub:
        def __init__(self, storage, dtype_name):
            self.storage = storage
            self.dtype_name = dtype_name

    class Unpickler(pickle.Unpickler):
        def persistent_load(self, pid):
            # pid = ('storage', StorageType, key, location, numel)
            assert pid[0] == "storage"
            storage_type, key = pid[1], pid[2]
            name = getattr(storage_type, "__name__", str(storage_type))
            if name == "UntypedStorage":
                name = "ByteStorage"
            return _TensorStub(load_storage(key, name), name)

        def find_class(self, module, name):
            if module.startswith("torch"):
                if name.endswith("Storage"):
                    return type(name, (), {"__name__": name})
                if name == "_rebuild_tensor_v2":
                    return _rebuild_tensor_v2
                if name == "_rebuild_parameter":
                    return lambda data, requires_grad, hooks: data
                if name in ("OrderedDict",):
                    from collections import OrderedDict
                    return OrderedDict
                return lambda *a, **k: None
            return super().find_class(module, name)

    def _rebuild_tensor_v2(storage, storage_offset, size, stride, *args):
        arr = storage.storage
        if not size:
            return arr[storage_offset : storage_offset + 1].reshape(())[()]
        # torch serializes tensors with their strides; a non-contiguous save
        # must be rebuilt with as_strided, not reshape, which would reorder
        # the elements whenever numel happens to match
        contig = []
        acc = 1
        for s in reversed(size):
            contig.append(acc)
            acc *= s
        contig = tuple(reversed(contig))
        if tuple(stride) == contig:
            n = int(np.prod(size))
            return arr[storage_offset : storage_offset + n].reshape(size)
        itemsize = arr.itemsize
        return np.lib.stride_tricks.as_strided(
            arr[storage_offset:], size, [s * itemsize for s in stride]
        ).copy()

    with zf.open(f"{prefix}/data.pkl") as f:
        obj = Unpickler(io.BytesIO(f.read())).load()
    return obj


def normalize_state_dict(raw) -> dict[str, np.ndarray]:
    """Unwrap PL/deepspeed layouts and apply legacy key renames
    (virtual_pose_render.py:26-51)."""
    if "state_dict" in raw:
        sd = dict(raw["state_dict"])
        # substring rename like the reference (virtual_pose_render.py:39-40):
        # the legacy key is prefixed (model.diffusion_model.framestride_...)
        if any("framestride_embed" in k for k in sd):
            sd = {
                k.replace("framestride_embed", "fps_embedding"): v
                for k, v in sd.items()
            }
    elif "module" in raw:
        sd = {k[16:]: v for k, v in raw["module"].items()}
    else:
        sd = dict(raw)
    return {
        k: (v if isinstance(v, np.ndarray) or np.isscalar(v) else np.asarray(v))
        for k, v in sd.items()
    }


def apply_surgery(sd: dict, *, expand_conv_in: bool = False,
                  add_class_embed: bool = False) -> dict:
    """DynamiCrafter->MuDG import-time weight surgery (torch layouts).

    conv_in 8->12: duplicate input channels 4:8 and halve the whole kernel
    (main/utils_train.py:200-204). class_embed <- time_embed clone
    (main/utils_train.py:174-182).
    """
    sd = dict(sd)
    key = "model.diffusion_model.input_blocks.0.0.weight"
    if expand_conv_in and key in sd and sd[key].shape[1] == 8:
        w = sd[key]
        sd[key] = np.concatenate([w, w[:, 4:8]], axis=1) * 0.5
    if add_class_embed and "model.diffusion_model.class_embed.0.weight" not in sd:
        for suffix in ("0.weight", "0.bias", "2.weight", "2.bias"):
            src = f"model.diffusion_model.time_embed.{suffix}"
            dst = f"model.diffusion_model.class_embed.{suffix}"
            if src in sd:
                sd[dst] = np.array(sd[src], copy=True)
    return sd


def sub_state_dict(sd: Mapping[str, np.ndarray], prefix: str) -> dict[str, torch.Tensor]:
    """The leaves under `prefix`, prefix stripped, the diffusion buffers
    (_BUFFER_SKIP_SUFFIXES) skipped; floating leaves as float32 tensors."""
    out = {}
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        sub = key[len(prefix):]
        if any(sub == s or sub.endswith("." + s) for s in _BUFFER_SKIP_SUFFIXES):
            continue
        val = np.asarray(val)
        if val.dtype.kind == "f":
            val = val.astype(np.float32)
        out[sub] = torch.from_numpy(np.ascontiguousarray(val))
    return out


def load_mudg_checkpoint(path: str, *, expand_conv_in=False,
                         add_class_embed=False) -> dict[str, dict[str, torch.Tensor]]:
    """A MuDG/DynamiCrafter .ckpt -> {sub-model: torch-layout state dict},
    keyed as `MDM`'s unet / vae / image_proj / clip_text / clip_image; each
    tower's state dict is its own module's (TOWERS), where the checkpoint
    nests it so, without the leaves it never reads (UNREAD)."""
    raw = _load_torch_pickle(path)
    sd = normalize_state_dict(raw)
    sd = apply_surgery(sd, expand_conv_in=expand_conv_in,
                       add_class_embed=add_class_embed)
    out = {}
    for name, pfx in PREFIXES.items():
        inner = pfx + TOWERS.get(name, "")
        nested = inner != pfx and any(k.startswith(inner) for k in sd)
        sub = sub_state_dict(sd, inner if nested else pfx)
        out[name] = {k: v for k, v in sub.items() if k not in UNREAD.get(name, ())}
    return out


def load_into(mdm, trees: Mapping[str, Mapping[str, torch.Tensor]]):
    """Load `load_mudg_checkpoint`'s state dicts into an MDM, each sub-model
    strictly: a missing or unexpected key raises and names the key."""
    for name, sd in trees.items():
        getattr(mdm, name).load_state_dict(sd, strict=True)
    return mdm


_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """Minimal safetensors reader (HF checkpoint format): 8-byte LE header
    length, JSON header mapping tensor name -> {dtype, shape, data_offsets},
    then one raw little-endian buffer. BF16 is widened to float32 (numpy has
    no bfloat16)."""
    import json
    import struct

    with open(path, "rb") as f:
        (hdr_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hdr_len))
        buf = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        s, e = meta["data_offsets"]
        raw = buf[s:e]
        if meta["dtype"] == "BF16":
            u16 = np.frombuffer(raw, dtype=np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=_SAFETENSORS_DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a flat torch state_dict from a .pth/.ckpt/.bin (torch pickle) or
    .safetensors file, normalized to numpy arrays."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return normalize_state_dict(_load_torch_pickle(path))
