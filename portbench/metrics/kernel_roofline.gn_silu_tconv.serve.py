"""kernel_roofline.gn_silu_tconv.serve (%): the share of its roofline that
kernel 4 (GroupNorm, SiLU and temporal conv of a ResBlock stage) reached in the traced window: the least time of its
calls' work (`harness/work.py`: each call at the mean work of its sites in
one UNet forward, the larger of its FLOPs at 989 TFLOP/s and its bytes at
3.35 TB/s) over the `mudg::` device time inside its `kernel.gn_silu_tconv`
spans, the program's own (`harness/spans.py`)."""

from portbench.harness import spans


def read(s):
    return spans.kernel_roofline(s, "gn_silu_tconv")
