"""kernel_roofline.flash_attention.serve (%): the share of its roofline that
kernel 5 (flash attention of the long spatial self-attentions) reached in the traced window: the least time of its
calls' work (`harness/work.py`: each call at the mean work of its sites in
one UNet forward, the larger of its FLOPs at 989 TFLOP/s and its bytes at
3.35 TB/s) over the `mudg::` device time inside its `kernel.flash_attention`
spans, the program's own (`harness/spans.py`)."""

from portbench.harness import spans


def read(s):
    return spans.kernel_roofline(s, "flash_attention")
