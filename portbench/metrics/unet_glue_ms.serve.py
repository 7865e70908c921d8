"""unet_glue_ms.serve (ms): per UNet forward, the device time of the
operations inside the program's `unet` span that are not the port's
kernels (`mudg::*`): PyTorch's GroupNorms, copies, adds, cuBLAS and cuDNN,
in the traced window (`harness/spans.py`)."""


def read(s):
    unet = (s.get("program_trace") or {}).get("unet")
    if s.get("kind") != "serve" or not unet or not unet["calls"]:
        return None
    return 1e3 * unet["glue_s"] / unet["calls"]
