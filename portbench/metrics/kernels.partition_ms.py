"""Device ms per call of the partition passes: K1, and K1b by its
template (``partition_raw_kernel``, ``csrc/partition.cu``), and K1c
(``partition_general_kernel``, ``csrc/partition_general.cu``)."""

KERNELS = ("partition_raw_kernel", "partition_general_kernel")


def read(run):
    return None if run.trace is None else run.trace.kernel_ms(KERNELS)
