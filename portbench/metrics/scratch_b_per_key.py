"""The peak of ``torch.cuda.max_memory_allocated()`` over the window, less
what was allocated as it opened (the pool, the kept outputs), over the
keys of a call: the device memory a caller leaves free for one sort, its
output included."""


def read(run):
    w = run.window
    return None if w.scratch_bytes is None else w.scratch_bytes / w.n
