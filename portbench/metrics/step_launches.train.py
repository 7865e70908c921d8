"""step_launches.train (launches): device kernels launched per optimizer
step, from the profiler's trace of the traced step."""


def read(s):
    tr = s.get("trace") or {}
    if s.get("kind") != "train" or not tr.get("kernels"):
        return None
    return sum(tr["kernels"].values()) / s["traced"]
