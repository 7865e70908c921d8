"""kernel_roofline.spatial_attn.serve (%): the share of its roofline that
kernel 1 (LN, self-attention and out-projection of a spatial block) reached in the traced window: the least time of its
calls' work (`harness/work.py`: each call at the mean work of its sites in
one UNet forward, the larger of its FLOPs at 989 TFLOP/s and its bytes at
3.35 TB/s) over the `mudg::` device time inside its `kernel.spatial_attn`
spans, the program's own (`harness/spans.py`)."""

from portbench.harness import spans


def read(s):
    return spans.kernel_roofline(s, "spatial_attn")
