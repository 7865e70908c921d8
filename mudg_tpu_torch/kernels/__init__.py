"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each module holds one kernel's wrapper, its plain PyTorch version, its weight
packing and a `launches` count. A wrapper runs the plain version for a CPU
(or meta) tensor and launches its kernel for a CUDA tensor, or raises; there
is no fallback from a CUDA tensor to the plain path. Sources and build:
`mudg_tpu_torch/csrc/`, `kernels/_build.py` (nvcc at first use).
"""
from __future__ import annotations

from . import flash_attention, mlp, spatial_attn, tconv, temporal_attn

# kernel name -> module, in the order of the port's kernel table
KERNELS = {
    "spatial_attn": spatial_attn,
    "temporal_attn": temporal_attn,
    "geglu_ff": mlp,
    "gn_silu_tconv": tconv,
    "flash_attention": flash_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def prepare_kernels(model) -> None:
    """Pack every kernel site's weights of `model` once, after its weights
    are loaded (or changed) and it sits on its device in its dtype."""
    for m in model.modules():
        pack = getattr(m, "pack_kernel_weights", None)
        if pack is not None:
            pack()
