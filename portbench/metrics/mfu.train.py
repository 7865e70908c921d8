"""mfu.train (%): the model FLOPs of an optimizer step (three times the
trainable forward plus the frozen forwards, remat's recompute not counted,
counted on the plain reference from the configuration's shapes) over its
wall time in the untraced span, at 989 TFLOP/s."""

from portbench.harness import work


def read(s):
    if s.get("kind") != "train" or not s.get("span_s") or not s.get("flops_per_step"):
        return None
    return 100.0 * s["flops_per_step"] * s["steps"] / (s["span_s"] * work.PEAK_FLOPS)
