"""kernel_roofline.geglu_ff.serve (%): the share of its roofline that
kernel 3 (LN and GEGLU feed-forward of a block) reached in the traced window: the least time of its
calls' work (`harness/work.py`: each call at the mean work of its sites in
one UNet forward, the larger of its FLOPs at 989 TFLOP/s and its bytes at
3.35 TB/s) over the `mudg::` device time inside its `kernel.geglu_ff`
spans, the program's own (`harness/spans.py`)."""

from portbench.harness import spans


def read(s):
    return spans.kernel_roofline(s, "geglu_ff")
