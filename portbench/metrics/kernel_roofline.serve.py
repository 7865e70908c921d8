"""kernel_roofline.serve (%): the least time of the work of the port's
kernel launches in the traced window (launches counted by
`mudg_tpu_torch.kernels.launch_counts()`, each at the mean work of that
kernel's sites in one UNet forward: the larger of its FLOPs at 989 TFLOP/s
and its bytes at 3.35 TB/s), over the device time of the `mudg::` kernels."""

from portbench.harness import work


def read(s):
    tr = s.get("trace") or {}
    if s.get("kind") != "serve" or not tr.get("port_s") or not s.get("sites"):
        return None
    least = work.kernel_least_s(s["launches"], s["sites"])
    if not least:
        return None
    return 100.0 * least / tr["port_s"]
