"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each module holds a kernel's wrapper (and, for kernels 2, 3 and 5, its
backward kernel's wrapper and the autograd op that joins the two), the plain
PyTorch versions, the weight packing and a count of launches. A wrapper runs
the plain version for a CPU (or meta) tensor and launches its kernel for a
CUDA tensor, or raises; there is no fallback from a CUDA tensor to the plain
path. Sources and build: `mudg_tpu_torch/csrc/`, `kernels/_build.py` (nvcc
at first use).
"""
from __future__ import annotations

from . import flash_attention, mlp, spatial_attn, tconv, temporal_attn

# kernel name -> (module, its launch counter), in the order of the port's
# kernel table
KERNELS = {
    "spatial_attn": (spatial_attn, "launches"),
    "temporal_attn": (temporal_attn, "launches"),
    "geglu_ff": (mlp, "launches"),
    "gn_silu_tconv": (tconv, "launches"),
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_bwd": (flash_attention, "bwd_launches"),
    "temporal_attn_bwd": (temporal_attn, "bwd_launches"),
    "geglu_ff_bwd": (mlp, "bwd_launches"),
}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def prepare_kernels(model) -> None:
    """Pack every kernel site's weights of `model` once, after its weights
    are loaded (or changed) and it sits on its device in its dtype. The
    inference path reads these packs; the training ops pack their fp32
    parameters inside every call and never read them."""
    for m in model.modules():
        pack = getattr(m, "pack_kernel_weights", None)
        if pack is not None:
            pack()
