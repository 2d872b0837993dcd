"""The job's bytes at the card's HBM peak over the summed device time of
the port's own kernels (every ``__global__`` of ``tpusort_torch/csrc``)
per call, in %.  The job's bytes are the entry's: each input key and
value read once and each output word written once, whatever implements
the sort, so the share cannot pass 100% when a pass or an operand goes."""

from portbench import peaks


def read(run):
    tr = run.trace
    peak = peaks.hbm_bytes_per_s(run.device_name)
    if tr is None or peak is None:
        return None
    ms = tr.kernel_ms(run.port_kernels)
    if ms is None:
        return None
    return 100.0 * (run.job_bytes / peak * 1e3) / ms
