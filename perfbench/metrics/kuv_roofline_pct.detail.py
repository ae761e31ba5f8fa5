"""The UV detail kernel (csrc/uv_detail.cu): its function's least time by the bytes of work_detail.uv_detail_bytes over uv_detail_kernel's device time."""

from perfbench import work_detail


def read(ctx):
    return work_detail.uv_roofline_pct(ctx)
