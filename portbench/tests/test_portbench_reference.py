"""The plain reference: its order, its stability and its comparisons."""

import pytest
import torch

from portbench import reference


def test_order_key_orders_floats_by_their_bits():
    x = torch.tensor([1.5, -0.0, 0.0, -2.0, float("inf"), float("-inf"),
                      3.0, -1e-30], dtype=torch.float32)
    got = reference.stable_sort(x)
    want = torch.tensor([float("-inf"), -2.0, -1e-30, -0.0, 0.0, 1.5, 3.0,
                         float("inf")])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    d = x.to(torch.float64)
    assert torch.equal(reference.stable_sort(d).view(torch.int64),
                       want.to(torch.float64).view(torch.int64))


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.uint64,
                                   torch.int64])
def test_integers_order_by_value(dtype):
    gen = torch.Generator().manual_seed(1)
    wide = torch.empty((), dtype=dtype).element_size() == 8
    bits = torch.randint(-2**31, 2**31, (2000 * (2 if wide else 1),),
                         dtype=torch.int32, generator=gen)
    keys = bits.view(dtype)
    got = reference.stable_sort(keys)
    as_int = [int(v) for v in keys.tolist()]
    assert [int(v) for v in got.tolist()] == sorted(as_int)


def test_pairs_are_stable_and_the_controls_break_their_guarantee():
    keys = torch.tensor([5, 3, 5, 3, 4, 2], dtype=torch.int32).view(torch.uint32)
    vals = torch.arange(6, dtype=torch.int32).view(torch.uint32)
    k, v = reference.stable_sort(keys, vals)
    assert k.view(torch.int32).tolist() == [2, 3, 3, 4, 5, 5]
    assert v.view(torch.int32).tolist() == [5, 1, 3, 4, 0, 2]
    assert reference.compare((k, v), keys, vals, stable=True) == \
        {"key_mismatches": 0, "value_mismatches": 0}
    rk, rv = reference.control_reversed_ties(keys, vals)
    assert reference.compare((rk, rv), keys, vals, stable=True) == \
        {"key_mismatches": 0, "value_mismatches": 4}
    lk, lv = reference.control_low_bit(keys, vals)
    assert reference.compare((lk, lv), keys, vals, stable=True)[
        "key_mismatches"] == 4


def test_unstable_pairs_accept_any_order_within_a_run_and_no_other():
    keys = torch.tensor([5, 3, 5, 3, 4], dtype=torch.int32).view(torch.uint32)
    vals = torch.arange(5, dtype=torch.int32).view(torch.uint32)
    k, v = reference.stable_sort(keys, vals)
    swapped = v.view(torch.int32).clone()
    swapped[[0, 1]] = swapped[[1, 0]]
    assert reference.compare((k, swapped.view(torch.uint32)), keys, vals,
                             stable=False)["value_mismatches"] == 0
    wrong = v.view(torch.int32).clone()
    wrong[[1, 2]] = wrong[[2, 1]]          # a value moved to another key
    assert reference.compare((k, wrong.view(torch.uint32)), keys, vals,
                             stable=False)["value_mismatches"] > 0


def test_mismatches_count_a_wrong_dtype_or_shape_as_all_wrong():
    want = torch.arange(10, dtype=torch.int32)
    assert reference.mismatches(want.to(torch.int64), want) == 10
    assert reference.mismatches(want[:5], want) == 10
    assert reference.mismatches(None, want) == 10
    assert reference.compare(None, want, want, stable=True) == \
        {"key_mismatches": 10, "value_mismatches": 10}
