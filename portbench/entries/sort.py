"""Entries ``sort`` and ``sort_pairs``: ``tpusort_torch.sort(keys)`` and
``tpusort_torch.sort_pairs(keys, values, stable=...)`` of 1-D keys.

A configuration gives ``key_dtype``, ``n`` and, for pairs,
``value_dtype``, ``values`` (``"enumerated"``: 0..n-1) and ``stable``.
A traffic mix gives ``keys``: one rule of :func:`portbench.datagen.make_keys`
or a list of them, taken in turn by the pool's inputs, each optionally
``"presorted": true``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from portbench import datagen, reference

# every comparison is exact: a sort's output is right or wrong bit for bit
LIMITS = {"key_mismatches": 0, "value_mismatches": 0}


def _pairs(cfg: Mapping) -> bool:
    return cfg["entry"] == "sort_pairs"


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=datagen.DTYPES[name]).element_size()


def pool_input(cfg: Mapping, traffic: Mapping, n: int, seed: int,
               index: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Pool input ``index`` of a run with ``seed``: the same arguments
    give the same tensors."""
    rules = traffic["keys"]
    rule = rules[index % len(rules)] if isinstance(rules, list) else rules
    gen = datagen.generator(device, seed, 0, index)
    keys = datagen.make_keys(rule, gen, n, datagen.DTYPES[cfg["key_dtype"]])
    if rule.get("presorted"):
        keys = reference.stable_sort(keys)
    inp = {"keys": keys}
    if _pairs(cfg):
        if cfg["values"] != "enumerated":
            raise ValueError(f"unknown values {cfg['values']!r}")
        inp["values"] = datagen.enumerated_values(
            n, datagen.DTYPES[cfg["value_dtype"]], device)
    return inp


def call(program, cfg: Mapping, inp: Mapping):
    """The public call the window times."""
    if _pairs(cfg):
        return program.sort_pairs(inp["keys"], inp["values"],
                                  stable=cfg["stable"])
    return program.sort(inp["keys"])


def job_bytes(cfg: Mapping, n: int) -> int:
    """Each key and value read once and written once."""
    per = _itemsize(cfg["key_dtype"])
    if _pairs(cfg):
        per += _itemsize(cfg["value_dtype"])
    return 2 * n * per


def check(cfg: Mapping, inp: Mapping, out) -> Dict[str, int]:
    """The numbers compared with :data:`LIMITS` for one output."""
    return reference.compare(out, inp["keys"], inp.get("values"),
                             stable=_pairs(cfg) and cfg["stable"])


def _low_bit(cfg, inp):
    return reference.control_low_bit(inp["keys"], inp.get("values"))


def _reversed_ties(cfg, inp):
    return reference.control_reversed_ties(inp["keys"], inp["values"])


def controls(cfg: Mapping) -> Dict[str, object]:
    """The controls that may stand in the program's place: each breaks a
    guarantee the configuration states and has to come out not correct."""
    out = {"low_bit": _low_bit}
    if _pairs(cfg) and cfg["stable"]:
        out["reversed_ties"] = _reversed_ties
    return out
