"""The port's copy of the host planner (``tpusort_torch.planner``) returns
exactly what ``tpusort.planner`` returns: presorted predictions,
sortedness and radix-overflow predictions, on the same numpy samples and
the same plans (each package's own ``plan_msd``)."""

import numpy as np
import pytest

from tpusort import planner as jpl
from tpusort.ops.msd import plan_msd as j_plan
from tpusort_torch import planner as tpl
from tpusort_torch.configs import get_config
from tpusort_torch.ops.msd import plan_msd as t_plan
from tpusort_torch.utils.datagen import entropy_keys, random_keys, zipf_keys

M = tpl.SAMPLE_TARGET


def _samples(kind: str):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "uniform":
        return [random_keys(rng, M)]
    if kind == "constant":
        return [np.full(M, 12345, np.uint32)]
    if kind.startswith("entropy"):
        return [entropy_keys(rng, M, int(kind[-1]))]
    if kind.startswith("zipf"):
        return [zipf_keys(rng, M, alpha=float(kind[4:]), dtype=np.uint32)]
    if kind == "presorted":
        return [np.sort(random_keys(rng, M))]
    if kind == "descending":
        return [np.sort(random_keys(rng, M))[::-1].copy()]
    if kind == "nearly_sorted":
        x = np.sort(random_keys(rng, M))
        x[::37] = random_keys(rng, x[::37].size)
        return [x]
    if kind == "tiny":
        return [random_keys(rng, 100)]
    assert kind == "planes"
    hi = np.sort(rng.integers(0, 8, M).astype(np.uint32))
    return [hi, random_keys(rng, M)]


KINDS = ["uniform", "constant", "entropy2", "entropy3", "entropy4",
         "zipf1.1", "zipf1.2", "presorted", "descending", "nearly_sorted",
         "tiny", "planes"]


def test_constants_match():
    assert (tpl.PLANNER_MIN_N, tpl.SAMPLE_TARGET) == \
        (jpl.PLANNER_MIN_N, jpl.SAMPLE_TARGET) == (1 << 24, 1 << 16)
    assert (tpl._MASS_MARGIN, tpl._SORTEDNESS_LIMIT,
            tpl._MIN_SAMPLES_PER_BUCKET) == (
        jpl._MASS_MARGIN, jpl._SORTEDNESS_LIMIT, jpl._MIN_SAMPLES_PER_BUCKET)


@pytest.mark.parametrize("kind", KINDS)
def test_presorted_and_sortedness_match(kind):
    s = _samples(kind)
    assert tpl.predict_presorted(s) == jpl.predict_presorted(s)
    assert tpl.sortedness(s[0]) == jpl.sortedness(s[0])


@pytest.mark.parametrize("row", [(32, False), (32, True), (64, False)])
@pytest.mark.parametrize("log2n", [24, 26, 28])
@pytest.mark.parametrize("kind", KINDS)
def test_radix_overflow_prediction_matches(kind, log2n, row):
    """Under the ``"cuda"`` rows' plans and the CPU row's."""
    n = 1 << log2n
    s = _samples(kind)[0]
    for platform in ("cuda", "cpu"):
        kw = get_config(*row, platform).plan_kwargs()
        kw.pop("min_n")
        tp_, jp_ = t_plan(n, 0, 32, **kw), j_plan(n, 0, 32, **kw)
        assert tpl.predict_radix_overflow(s, tp_, n) == \
            jpl.predict_radix_overflow(s, jp_, n)


def test_predictions_on_known_inputs():
    """What the tier chain relies on: uniform keys keep the radix tier;
    constant, entropy-AND, Zipf and sorted keys skip it; a sorted sample
    is presorted and a reversed one is not."""
    kw = get_config(32, False, "cuda").plan_kwargs()
    kw.pop("min_n")
    n = 1 << 28
    plan = t_plan(n, 0, 32, **kw)
    assert not tpl.predict_radix_overflow(_samples("uniform")[0], plan, n)
    for kind in ("constant", "entropy4", "zipf1.1", "presorted",
                 "descending"):
        assert tpl.predict_radix_overflow(_samples(kind)[0], plan, n), kind
    assert tpl.predict_presorted(_samples("presorted"))
    assert not tpl.predict_presorted(_samples("descending"))
