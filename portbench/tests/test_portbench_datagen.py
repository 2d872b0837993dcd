"""The generators follow the rules of ``msb/tests/data_gen.h``."""

import pytest
import torch

from portbench import datagen

N = 1 << 16


def _bit_density(words: torch.Tensor) -> float:
    w = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = sum(int(((w >> b) & 1).sum()) for b in range(32))
    return bits / (32 * w.numel())


def test_level_zero_is_all_zeros():
    gen = datagen.generator(torch.device("cpu"), 1)
    assert not datagen.entropy_and_words(gen, N, 0).any()


@pytest.mark.parametrize("level", [1, 2, 3, 5])
def test_level_k_sets_two_to_the_minus_k_of_the_bits(level):
    gen = datagen.generator(torch.device("cpu"), 2**31 + level)
    density = _bit_density(datagen.entropy_and_words(gen, N, level))
    assert density == pytest.approx(2.0 ** -level, rel=0.05)


def test_uniform_sets_half_the_bits_in_every_position():
    gen = datagen.generator(torch.device("cpu"), 3)
    keys = datagen.make_keys({"rule": "uniform"}, gen, N, torch.uint32)
    assert keys.dtype == torch.uint32 and keys.shape == (N,)
    w = keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    for b in range(32):
        assert float(((w >> b) & 1).float().mean()) == pytest.approx(0.5, abs=0.02)
    wide = datagen.make_keys({"rule": "uniform"}, gen, N, torch.uint64)
    assert wide.dtype == torch.uint64 and wide.shape == (N,)


def test_enumerated_values_are_the_positions():
    v = datagen.enumerated_values(1000, torch.uint32, torch.device("cpu"))
    assert v.dtype == torch.uint32
    assert torch.equal(v.view(torch.int32), torch.arange(1000, dtype=torch.int32))
    v64 = datagen.enumerated_values(10, torch.int64, torch.device("cpu"))
    assert torch.equal(v64, torch.arange(10))


def test_the_same_seed_and_stream_give_the_same_keys():
    def make(seed, index):
        gen = datagen.generator(torch.device("cpu"), seed, 0, index)
        return datagen.make_keys({"rule": "entropy_and", "level": 3}, gen,
                                 4096, torch.uint32).view(torch.int32)

    assert torch.equal(make(2**40 + 5, 1), make(2**40 + 5, 1))
    assert not torch.equal(make(2**40 + 5, 1), make(2**40 + 5, 2))
    assert not torch.equal(make(2**40 + 5, 1), make(2**40 + 6, 1))


def test_zipf_keys_are_heavily_duplicated():
    gen = datagen.generator(torch.device("cpu"), 4)
    keys = datagen.make_keys({"rule": "zipf", "alpha": 1.1,
                              "universe": 1 << 10}, gen, N, torch.uint32)
    assert torch.unique(keys.view(torch.int32)).numel() <= 1 << 10
    with pytest.raises(ValueError):
        datagen.make_keys({"rule": "gauss"}, gen, 8, torch.uint32)
