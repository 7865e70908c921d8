"""unet_launches.serve (launches): device kernels launched per UNet
forward, from the profiler's trace."""


def read(s):
    tr = s.get("trace") or {}
    n = tr.get("ranges", {}).get("unet")
    if s.get("kind") != "serve" or not n or "unet" not in tr.get("kernels", {}):
        return None
    return tr["kernels"]["unet"] / n
