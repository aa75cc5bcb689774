"""``nn_roofline_pct``: the bound of the 1-NN work the traced calls' inputs
need (``harness.roofline.nn_bound_s``: valid pairs of the lanes that are
active, at the float32 peak or the memory rate) over the device time of
the kernels that compute it, matched by name below, in percent."""

from harness.roofline import nn_bound_s

KERNELS = ("nn_kernel",)  # icp_tpu_torch/csrc/nn.cu, K1 and K2


def read(run):
    trace = run.trace
    if trace is None or not trace.levels or not all(trace.levels):
        return None
    spent = sum(e - s for name, s, e in trace.device if any(k in name for k in KERNELS)) / 1e9
    if spent <= 0:
        return None
    bound = sum(nn_bound_s(call, trace.nn_per_lane) for call in trace.levels)
    return 100.0 * bound / spent
