"""The fused NGP composite (hash_field_kernel of
csrc/fused_cp_composite.cu) against its roof, in %: the field work the
traced views need over the kernel's summed device time."""

from benchmark import roof
from benchmark.trace import kernel_seconds

KERNELS = ("hash_field_kernel",)


def read(obs):
    if obs.get("kind") != "views" or not obs.get("trace"):
        return None
    secs = kernel_seconds(obs["trace"], KERNELS)
    if secs <= 0:
        return None
    flop, nbytes = obs["traced_work"]
    return roof.share_percent(flop, nbytes, secs)
