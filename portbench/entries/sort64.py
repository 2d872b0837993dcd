"""Entry ``sort64``: the ``sort`` entry for 64-bit keys alone, with a
control of its own.

``high_word`` is the reference ordering the keys by their high 32 bits
alone, the precision below the configuration's 64, and keeping keys whose
high words tie in input order.  2^27 uniform 64-bit keys hold about 2^21
pairs that share their high word, and ``high_word`` leaves half of those
pairs out of order.  It is the entry's only control: uniform 64-bit keys
almost never tie, nor differ in the lowest bit alone, so ``sort``'s
``low_bit`` gives the reference's answer on them and guards nothing.
"""

from __future__ import annotations

from typing import Dict, Mapping

from portbench import reference
from portbench.entries import sort

LIMITS = sort.LIMITS


def _as_keys(cfg: Mapping) -> Dict:
    """The configuration as the ``sort`` entry reads a call of keys."""
    return dict(cfg, entry="sort")


def pool_input(cfg, traffic, n, seed, index, device):
    return sort.pool_input(_as_keys(cfg), traffic, n, seed, index, device)


def call(program, cfg, inp):
    return sort.call(program, _as_keys(cfg), inp)


def job_bytes(cfg, n):
    return sort.job_bytes(_as_keys(cfg), n)


def check(cfg, inp, out):
    return sort.check(_as_keys(cfg), inp, out)


def _high_word(cfg, inp):
    keys = inp["keys"]
    return reference._sort_by(reference.order_key(keys) >> 32, keys, None)


def controls(cfg: Mapping) -> Dict[str, object]:
    """``high_word``, which has to come out not correct."""
    return {"high_word": _high_word}
