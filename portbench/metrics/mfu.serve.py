"""mfu.serve (%): the model FLOPs of a served window (every UNet forward,
both CLIP towers, the resampler, the VAE encode and decode, counted on the
plain reference from the configuration's shapes) over its wall time in the
untraced span, at 989 TFLOP/s."""

from portbench.harness import work


def read(s):
    if s.get("kind") != "serve" or not s.get("span_s") or not s.get("flops_per_window"):
        return None
    return 100.0 * s["flops_per_window"] * s["windows"] / (s["span_s"] * work.PEAK_FLOPS)
