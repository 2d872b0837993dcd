"""Device ms per call of the leaf and collapse kernels: K2
(``leaf_collapse_kernel``, ``csrc/bitonic.cu``), K3, K9 and K10
(``sort_tiles_kernel``, ``sort_tiles_valid_kernel``,
``csrc/sort_tiles.cu``) and K4 (``collapse_kernel``,
``collapse_offsets_kernel``, ``csrc/collapse.cu``)."""

KERNELS = ("leaf_collapse_kernel", "sort_tiles_kernel",
           "sort_tiles_valid_kernel", "collapse_kernel",
           "collapse_offsets_kernel")


def read(run):
    return None if run.trace is None else run.trace.kernel_ms(KERNELS)
