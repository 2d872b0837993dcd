"""The bytes K1's, K1b's and K2's merge bodies move, at the card's HBM
peak, over the device time of their launches, in %.

Bytes: the delta of ``merge_bytes`` in ``tpusort_torch.ops.msd.counters()``
over the traced stretch, which each merge launch adds where it is made: 8 B
(a 4-byte read and a 4-byte write) for each valid key it carries and each
operand word, key planes plus payload words.  A launch reads and writes at
least that much, so the share cannot pass 100%.  Time: the device time of
the launches whose ``MERGE`` template flag, the last argument of
``partition_raw_kernel<NK, IDX, SPL, E, MERGE>`` and
``leaf_collapse_kernel<NK, IDX, E, MERGE>``, is ``true`` in the trace's
demangled name.  A program without the counter, or a stretch in which no
merge launch ran, reads nothing."""

import re

from portbench import peaks

KERNELS = ("partition_raw_kernel", "leaf_collapse_kernel")
_ARGS = re.compile(r"(?<![A-Za-z_])(?:%s)<([^<>]*)>" % "|".join(KERNELS))


def _is_merge(name: str) -> bool:
    """Whether a trace name is a merge-body launch of K1, K1b or K2."""
    m = _ARGS.search(name)
    return m is not None and m.group(1).rsplit(",", 1)[-1].strip() == "true"


def read(run):
    tr = run.trace
    peak = peaks.hbm_bytes_per_s(run.device_name)
    if tr is None or peak is None or not tr.counters.get("merge_bytes"):
        return None
    s = tr.device_s(_is_merge)
    if s is None:
        return None
    return 100.0 * tr.counters["merge_bytes"] / peak / s
