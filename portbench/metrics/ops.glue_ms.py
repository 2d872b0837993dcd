"""Device ms per call of every operation that is not one of the port's own
kernels (a ``__global__`` of ``tpusort_torch/csrc``): PyTorch's
elementwise kernels, copies and fills between them (twiddles, the sample,
the strided feed, the counts chain, the sentinel check, any ``torch.sort``
fallback)."""

from portbench.trace import name_matcher


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    port = name_matcher(run.port_kernels)
    s = tr.device_s(lambda name: not port(name))
    return 0.0 if s is None else s * 1e3 / tr.calls
