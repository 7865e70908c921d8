"""host_ms.serve (ms): per served window, the wall time outside the
sampler calls (conditions stacked and uploaded, the clip copied to the
host, the carry), from the host clock around each call of the untraced
span."""


def read(s):
    if s.get("kind") != "serve" or s.get("sampler_s") is None:
        return None
    return 1e3 * (s["span_s"] - s["sampler_s"]) / s["windows"]
