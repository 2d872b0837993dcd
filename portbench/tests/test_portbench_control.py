"""The comparison that decides ``correct`` fails what it must: each
control (the reference breaking a guarantee of the configuration) in the
program's place, and the program broken under the timed path.  Each run
is a whole run of the harness but for its look for a card."""

import time

import pytest
import torch

from conftest import make_root
from portbench import harness

CELLS = ["keys32.uniform", "pairs32.uniform", "keys32.entropy3",
         "pairs32.entropy3"]


def _run(root, cell, call=None, seed=2**31 + 5):
    return harness.run_cell(cell, seed, 0.02, False,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(), root=root,
                            call=call)


@pytest.fixture(scope="module")
def root_2p20(tmp_path_factory):
    # uniform keys tie in their 31 high bits only at a size where pairs of
    # keys meet in 2^31 values: 2^20 keys give about 2^8 such ties
    return make_root(tmp_path_factory.mktemp("pb"), 1 << 20)


@pytest.mark.parametrize("cell", CELLS)
def test_controls_come_out_not_correct(root_2p20, cell):
    c = harness.load_cell(cell, root_2p20)
    controls = c.entry.controls(c.cfg)
    assert ("reversed_ties" in controls) == cell.startswith("pairs")
    for name, fn in controls.items():
        res, checks = _run(root_2p20, cell,
                           call=lambda inp, fn=fn: fn(c.cfg, inp))
        assert res["correct"] is False, (name, checks)
        assert checks["key_mismatches"]["value"] > 0 or \
            checks["value_mismatches"]["value"] > 0


def _unchanged(inp):
    if "values" in inp:
        return inp["keys"].clone(), inp["values"].clone()
    return inp["keys"].clone()


def _program(c):
    import tpusort_torch

    return lambda inp: c.entry.call(tpusort_torch, c.cfg, inp)


def _half_left_out(c):
    prog = _program(c)

    def call(inp):
        half = inp["keys"].shape[0] // 2
        part = {k: v[:half] for k, v in inp.items()}
        out = prog(part)
        if isinstance(out, tuple):
            return (torch.cat([out[0], inp["keys"][half:]]),
                    torch.cat([out[1], inp["values"][half:]]))
        return torch.cat([out, inp["keys"][half:]])
    return call


def _one_answer_altered(c):
    prog = _program(c)

    def call(inp):
        out = prog(inp)
        last = out[-1] if isinstance(out, tuple) else out
        flipped = last.view(torch.int32).clone()
        flipped[flipped.shape[0] // 3] ^= 1
        flipped = flipped.view(last.dtype)
        return (out[0], flipped) if isinstance(out, tuple) else flipped
    return call


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct_and_each_fault_is_not(small_root,
                                                            cell):
    c = harness.load_cell(cell, small_root)
    res, checks = _run(small_root, cell)
    assert res["correct"] is True, checks
    faults = {"returns its input unchanged": lambda inp: _unchanged(inp),
              "half of the keys left out": _half_left_out(c),
              "one answer altered where it is produced":
                  _one_answer_altered(c)}
    for name, call in faults.items():
        res, checks = _run(small_root, cell, call=call)
        assert res["correct"] is False, (name, checks)


def test_a_call_that_raises_is_not_correct(small_root):
    def boom(inp):
        raise RuntimeError("a fault in the program")

    with pytest.raises(RuntimeError):
        _run(small_root, "keys32.uniform", call=boom)
