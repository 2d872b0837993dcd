"""Bytes a key that the program's 64-bit split and join copy: the split of
64-bit keys and values into 32-bit words and their join after the sort
(``tpusort_torch/dtypes.py``, run from ``api.py``), each copy's elements
read and written.  The delta of ``split_join_bytes`` in
``tpusort_torch.ops.msd.counters()`` over the traced stretch, over its
calls and the cell's n; a program without the counter reads nothing."""


def read(run):
    tr = run.trace
    if tr is None or "split_join_bytes" not in tr.counters:
        return None
    return tr.counters["split_join_bytes"] / tr.calls / run.window.n
