"""LPIPS perceptual distance (AlexNet backbone).

Port of `mudg_tpu/utils/lpips.py`, the canonical recipe (Zhang et al., CVPR
2018; the `lpips` package with net='alex'):

    d(a, b) = sum_l  mean_hw  w_l . ( f̂_l(a) - f̂_l(b) )^2

with f_l the AlexNet relu1..relu5 features, f̂ unit-normalized over channels
as x * rsqrt(sum(x^2) + 1e-10) (lpips.py:140-141), and w_l the non-negative
per-channel weights of the 1x1 heads. The tower's convolutions run in true
fp32 on the card (TF32 off).

`load_lpips` reads a user-provided torch state dict (MUDG_LPIPS_PATH or an
explicit path): the `lpips.LPIPS(net='alex')` layout (`net.sliceK.N.*`,
`linK.model.1.weight`) or a torchvision AlexNet (`features.N.*`) with or
without the heads; missing heads become uniform weights 1/C. It returns
None when nothing is available, and eval then reports no lpips.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch
from torch import nn

# torchvision AlexNet feature tower: (out_ch, kernel, stride, pad) per conv,
# with relu taps after each conv and 3x3/s2 maxpools after the first two
_CONVS = (
    (64, 11, 4, 2),    # features.0
    (192, 5, 1, 2),    # features.3
    (384, 3, 1, 1),    # features.6
    (256, 3, 1, 1),    # features.8
    (256, 3, 1, 1),    # features.10
)
_CONV_IDX = (0, 3, 6, 8, 10)
_POOL_AFTER = (True, True, False, False, False)

# lpips.ScalingLayer buffers (fixed in every released LPIPS checkpoint)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """The AlexNet tower (`features.N`, torch layouts) and one weight vector
    per tap (`lins.N`)."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.features = nn.ModuleDict()
        self.lins = nn.ParameterList()
        c_in = in_ch
        for i, (c_out, k, _, _) in enumerate(_CONVS):
            self.features[str(_CONV_IDX[i])] = nn.Conv2d(c_in, c_out, k)
            self.lins.append(nn.Parameter(torch.empty(c_out)))
            c_in = c_out

    def taps(self, x):
        """x (N, H, W, 3) in [-1, 1] -> the relu1..relu5 maps (N, h, w, C)."""
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        h = ((x - shift) / scale).permute(0, 3, 1, 2)
        out = []
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for i, (_, _, s, pad) in enumerate(_CONVS):
                conv = self.features[str(_CONV_IDX[i])]
                h = torch.relu(torch.nn.functional.conv2d(
                    h, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=s, padding=pad))
                out.append(h.permute(0, 2, 3, 1))
                if _POOL_AFTER[i]:
                    h = torch.nn.functional.max_pool2d(h, 3, 2)
        return out


def lpips(model: LPIPS, a, b):
    """LPIPS distance per batch element. a, b: (N, H, W, 3) RGB in [-1, 1]
    (the tower runs in the input dtype)."""
    total = 0.0
    for w, xa, xb in zip(model.lins, model.taps(a), model.taps(b)):
        na = xa * torch.rsqrt((xa * xa).sum(-1, keepdim=True) + 1e-10)
        nb = xb * torch.rsqrt((xb * xb).sum(-1, keepdim=True) + 1e-10)
        d = ((na - nb) ** 2 * w.to(a.dtype)).sum(-1)   # the 1x1 conv head
        total = total + d.mean(dim=(1, 2))
    return total


def from_state_dict(sd) -> dict[str, np.ndarray] | None:
    """An LPIPS or torchvision AlexNet state dict -> this module's state dict
    (numpy, fp32), or None when the tower is incomplete."""
    feats, lins = {}, {}
    for k, v in sd.items():
        m = re.match(r"(?:net\.slice\d+|features)\.(\d+)\.(weight|bias)$", k)
        if m:
            feats[f"features.{m.group(1)}.{m.group(2)}"] = np.asarray(v, np.float32)
            continue
        m = re.match(r"lin(\d)\.model\.1\.weight$", k)
        if m:
            lins[int(m.group(1))] = np.asarray(v, np.float32).reshape(-1)
    if {k.split(".")[1] for k in feats} != {str(i) for i in _CONV_IDX}:
        return None
    out = dict(feats)
    for i, (c_out, *_rest) in enumerate(_CONVS):
        w = lins.get(i)
        if w is None or w.shape != (c_out,):
            # torchvision-only dict: uncalibrated uniform heads
            w = np.full((c_out,), 1.0 / c_out, np.float32)
        out[f"lins.{i}"] = w
    return out


def load_lpips(path: str | None = None, device="cuda"):
    """Load LPIPS weights from a torch state dict (`path` or
    MUDG_LPIPS_PATH) onto `device`; None if unavailable."""
    path = path or os.environ.get("MUDG_LPIPS_PATH")
    if not path or not os.path.exists(path):
        return None
    from ..train.checkpoint import load_torch_state_dict

    sd = from_state_dict(load_torch_state_dict(path))
    if sd is None:
        return None
    model = LPIPS()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.to(device).eval()
