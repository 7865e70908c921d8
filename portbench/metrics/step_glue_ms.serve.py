"""step_glue_ms.serve (ms): per denoising step, the device time of the
operations the sampler launched outside every model call (CFG combine,
guidance rescale, DDIM update, step noise)."""


def read(s):
    dev = (s.get("trace") or {}).get("device_s")
    if s.get("kind") != "serve" or not dev or "sampler" not in dev:
        return None
    return 1e3 * dev["sampler"] / s["forwards"]
