"""port_kernel_share.serve (%): the share of the traced window's device
time spent in the port's own kernels (device names `mudg::*`); the rest is
PyTorch's glue, cuBLAS and cuDNN."""


def read(s):
    tr = s.get("trace") or {}
    if s.get("kind") != "serve" or not tr.get("total_s"):
        return None
    return 100.0 * tr["port_s"] / tr["total_s"]
