"""Entry ``sort_pairs64``: the ``sort_pairs`` entry for 64-bit keys, with
one control more.

``high_word`` is the reference ordering the pairs by the keys' high 32
bits alone, the precision below the configuration's 64, and keeping
pairs whose high words tie in input order.  Uniform 64-bit keys almost
never tie, nor differ in the lowest bit alone, so ``low_bit`` and
``reversed_ties`` give the reference's answer on them; but about 2^21 of
2^27 such keys share their high word with another, and ``high_word``
leaves half of those pairs out of order.
"""

from __future__ import annotations

from typing import Dict, Mapping

from portbench import reference
from portbench.entries import sort

LIMITS = sort.LIMITS


def _as_pairs(cfg: Mapping) -> Dict:
    """The configuration as the ``sort`` entry reads a call of pairs."""
    return dict(cfg, entry="sort_pairs")


def pool_input(cfg, traffic, n, seed, index, device):
    return sort.pool_input(_as_pairs(cfg), traffic, n, seed, index, device)


def call(program, cfg, inp):
    return sort.call(program, _as_pairs(cfg), inp)


def job_bytes(cfg, n):
    return sort.job_bytes(_as_pairs(cfg), n)


def check(cfg, inp, out):
    return sort.check(_as_pairs(cfg), inp, out)


def _high_word(cfg, inp):
    keys = inp["keys"]
    return reference._sort_by(reference.order_key(keys) >> 32, keys,
                              inp["values"])


def controls(cfg: Mapping) -> Dict[str, object]:
    """The controls of ``sort_pairs``, and ``high_word``."""
    return dict(sort.controls(_as_pairs(cfg)), high_word=_high_word)
