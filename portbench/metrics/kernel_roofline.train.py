"""kernel_roofline.train (%): the least time of the work of the port's
kernel launches in the traced steps (forward kernels and backward kernels
5/6, 2/9, 3/10, counted by `launch_counts()`, each at the mean work of that
kernel's sites in one micro-step), over the device time of the `mudg::`
kernels."""

from portbench.harness import work


def read(s):
    tr = s.get("trace") or {}
    if s.get("kind") != "train" or not tr.get("port_s") or not s.get("train_sites"):
        return None
    least = work.kernel_least_s(s["launches"], s["train_sites"])
    if not least:
        return None
    return 100.0 * least / tr["port_s"]
