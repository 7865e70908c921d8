"""port_kernel_share.train (%): the share of the traced steps' device time
spent in the port's own kernels (device names `mudg::*`)."""


def read(s):
    tr = s.get("trace") or {}
    if s.get("kind") != "train" or not tr.get("total_s"):
        return None
    return 100.0 * tr["port_s"] / tr["total_s"]
