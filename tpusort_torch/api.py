"""Public sort API of the PyTorch port.

Port of ``tpusort/api.py``: ``sort`` and its key-only and pair wrappers,
``argsort``, ``sort_planes`` and ``sort_pairs_lsb_in_value``, for 1-D
uint32/int32/float32 and uint64/int64/float64 keys with optional 32- or
64-bit payloads, over the whole key or a ``begin_bit``/``end_bit`` range,
on a CUDA device (the hand-written kernels) or on the CPU (their plain
PyTorch versions).  Outputs lie on the input's device.

Engines are looked up by name in a registry (``register_engine``,
``available_engines``), as in ``tpusort/api.py:53-134``: ``algorithm="auto"``
takes the config's ``default_algorithm``, and the radix names in
``_TIERED_ALGOS`` run the host tiering below; any other name calls that
engine once on the twiddled planes.  The registered radix and equi-depth
engines run their engine, then the exact sort where its flag is set.

64-bit keys and values are split into (hi, lo) int32 planes by copies on
the device (``dtypes.split64``) and joined back by a stack: the same words
the JAX package's numpy host boundary makes, without the round trip.

``sort`` and ``sort_planes`` (and ``argsort`` through it) run the JAX
API's host tiering (``tpusort/api.py:203-486``): a tier chain, radix ->
equi-depth -> exact (the equi-depth tier runs where ``SortConfig.skew_tier``
is True, or None on a CUDA tensor); and, for full-range sorts of at least
``planner.PLANNER_MIN_N`` keys, a strided sample of the twiddled keys that
the host planner reads to skip a doomed radix tier, or to return an input
that one device check finds already sorted.  Decisions are cached per
shape, dtype and config (``_TIER_CACHE``), so a steady workload dispatches
at once and the sample, queued before the sort, refreshes the cache while
the sort runs.  The engines only report overflow, as a flag on the device;
``ops/tiers.py`` owns the fallback: it reads each tier's flag on the host
before the next tier is tried, here and wherever else an engine runs.
JAX's in-graph ``lax.cond`` mode is not ported.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusort_torch import configs as _configs
from tpusort_torch import dtypes as _dtypes
from tpusort_torch import planner
from tpusort_torch.ops.equidepth import sort_twiddled_equidepth
from tpusort_torch.ops.msd import _plan_cached, count_route, sort_twiddled_msd
from tpusort_torch.ops.reference import sort_twiddled_reference
from tpusort_torch.ops.small import sort_twiddled_bitonic
from tpusort_torch.ops.tiers import first_clear
from tpusort_torch.utils.log import host_read, span, spanned

__all__ = [
    "sort",
    "argsort",
    "sort_keys",
    "sort_keys_descending",
    "sort_pairs",
    "sort_pairs_descending",
    "sort_pairs_lsb_in_value",
    "sort_planes",
    "unstable_sort_keys",
    "unstable_sort_pairs",
    "register_engine",
    "available_engines",
]


# ---------------------------------------------------------------------------
# Engine registry (port of tpusort/api.py:53-134)
# ---------------------------------------------------------------------------

# An engine sorts twiddled int32 plane(s) + int32 payload words ascending:
#   engine(planes, values, *, begin_bit, end_bit, total_bits[, config])
#     -> (sorted planes, sorted values)
Engine = Callable[..., Tuple[Tuple[torch.Tensor, ...],
                             Tuple[torch.Tensor, ...]]]

_ENGINES: Dict[str, Engine] = {}

# the engines that run the host tiering (radix -> equi-depth -> exact)
_TIERED_ALGOS = ("msd", "lsd", "msd_unstable")


def register_engine(name: str, fn: Engine) -> None:
    """Make ``fn`` callable as ``algorithm=name``."""
    _ENGINES[name] = fn


def available_engines() -> Tuple[str, ...]:
    return tuple(sorted(_ENGINES))


def _call_engine(engine: Engine, planes, values_tuple, **kw):
    """Call an engine, passing ``config=`` only if its signature takes it
    (engines written against the contract without it keep working)."""
    try:
        params = inspect.signature(engine).parameters
        takes_config = "config" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
    except (TypeError, ValueError):
        takes_config = False
    if not takes_config:
        kw.pop("config", None)
    return engine(planes, values_tuple, **kw)


def _resolve_engine(algorithm: str, config: _configs.SortConfig) -> Engine:
    if algorithm == "auto":
        algorithm = config.default_algorithm
        if algorithm not in _ENGINES:
            algorithm = "reference"
    if algorithm not in _ENGINES:
        raise ValueError(f"unknown algorithm {algorithm!r}; available: "
                         f"{available_engines()}")
    return _ENGINES[algorithm]


def _or_exact(engine: Callable, site: str, **fixed) -> Engine:
    """``engine``, then the exact sort where its overflow flag is set: a
    registered engine's (planes, values)."""
    def run(planes, values=(), *, begin_bit, end_bit, total_bits,
            config=None, **kw):
        bits = dict(begin_bit=begin_bit, end_bit=end_bit,
                    total_bits=total_bits)
        return first_clear(
            [lambda: engine(planes, values, config=config, **bits,
                            **{**fixed, **kw}),
             lambda: (*sort_twiddled_reference(planes, values, **bits),
                      None)], site)
    return run


_msd_engine = _or_exact(sort_twiddled_msd, "msd_flag")
_msd_unstable = _or_exact(sort_twiddled_msd, "msd_flag", stable=False)
# the exact sort; "xla" is JAX's name for the same one
register_engine("reference", sort_twiddled_reference)
register_engine("xla", sort_twiddled_reference)
register_engine("msd", _msd_engine)
register_engine("msd_unstable", _msd_unstable)
register_engine("msd_equidepth",
                _or_exact(sort_twiddled_equidepth, "equidepth_flag"))
# the MSD engine is stable, so it stands for CUB's stable LSD sort too
register_engine("lsd", _msd_engine)
# the single-tile path (K3), unstable; larger inputs go to the exact sort
register_engine("bitonic", sort_twiddled_bitonic)


def _normalize_values(values) -> Tuple[Tuple[torch.Tensor, ...], bool, bool]:
    """Returns (value_tuple, had_values, was_single)."""
    if values is None:
        return (), False, False
    if isinstance(values, (tuple, list)):
        return tuple(values), True, False
    return (values,), True, True


# ---------------------------------------------------------------------------
# Host tiering (port of tpusort/api.py:203-486)
# ---------------------------------------------------------------------------

# (kind, n, key dtype, value dtypes, descending, stable, begin_bit, end_bit,
# cfg) -> {"presorted": bool, "tier": "radix" | "equidepth"}.  As in JAX,
# the key does not see the distribution: alternating uniform and skewed
# inputs of one shape take the last call's tier (outputs stay exact).
_TIER_CACHE: Dict[tuple, dict] = {}


def _tier_chain(cfg, device: torch.device) -> Tuple[str, ...]:
    """The tiers in order.  The equi-depth tier runs where the config says
    ``skew_tier=True``, or leaves it None and the tensor is on a card (JAX
    gates it to the TPU alike)."""
    use_eq = cfg.skew_tier
    if use_eq is None:
        use_eq = device.type == "cuda"
    return ("radix", "equidepth", "exact") if use_eq else ("radix", "exact")


class _Sample:
    """The strided sample of twiddled plane 0, for the host planner.  On a
    card it is copied into pinned memory on the current stream, behind
    the twiddle and ahead of the sort, and an event marks its arrival, so
    reading it waits for nothing the sort queues."""

    def __init__(self, plane0: torch.Tensor, stride: int):
        s = plane0[::stride]
        self._event = None
        if s.is_cuda:
            self._host = torch.empty(s.shape, dtype=torch.int32,
                                     pin_memory=True)
            self._host.copy_(s, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = s.contiguous()

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().view(np.uint32)


def _lex_sorted(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: whether twiddled int32 planes are non-decreasing,
    lexicographically and unsigned."""
    lt = eq = None
    for p in planes:
        x = p ^ _dtypes.INT32_MIN
        a, b = x[:-1], x[1:]
        lt, eq = (a < b, a == b) if lt is None else \
            (lt | (eq & (a < b)), eq & (a == b))
    return (lt | eq).all()


def _skip_radix_tier(sample: np.ndarray, n: int, total_bits: int,
                     cfg) -> bool:
    """The host planner: whether the radix tier's static capacities look
    doomed on this sample, so the chain starts at the equi-depth tier.  A
    wrong guess costs time only: every tier's flag still guards the
    output."""
    kwargs = cfg.plan_kwargs()
    kwargs.pop("min_n")
    plan = _plan_cached(n, 0, total_bits, "raw",
                       tuple(sorted(kwargs.items())))
    if plan is None:
        return False
    return planner.predict_radix_overflow(sample, plan, n)


def _run_tier_chain(dispatch: Callable, cfg, device: torch.device,
                    skip_radix: bool = False,
                    first_sync: Optional[Callable] = None):
    """The tiers of :func:`_tier_chain` through ``ops.tiers.first_clear``
    (site ``tier_flag``).  ``dispatch(tier)`` -> (keys, values, overflow
    flag).  ``first_sync`` (the cache refresh) runs right after the first
    dispatch, before its flag is read, so the host planner works while
    the card sorts."""
    tiers = _tier_chain(cfg, device)
    if skip_radix and len(tiers) > 2:
        tiers = tiers[1:]
    return first_clear([functools.partial(dispatch, t) for t in tiers],
                       "tier_flag", first_sync=first_sync)


def _plan(decide: Callable, sample: "_Sample"):
    """The host planner's decision on the sample, read first."""
    with span("tpusort.plan"):
        with host_read("sample"):
            s = sample.get()
        return decide(s)


def _tiered_flow(ckey: tuple, classify, decide: Callable, cfg,
                 device: torch.device, dispatch: Callable,
                 identity: Callable):
    """The host tiering shared by ``sort`` and ``sort_planes`` (port of
    ``tpusort.api._tiered_flow``).  ``classify`` is None (too small, or a
    bit range: the chain runs with no host read but the flags) or
    (:class:`_Sample`, check), where check() is the full sortedness check;
    ``decide(sample)`` -> (presorted likely, first tier).  Cold, or when
    the cache says presorted, the sample is read before the sort, and a
    presorted input that passes the check comes back from ``identity()``.
    Warm, the cached tier runs at once and the sample refreshes the
    cache."""
    if classify is None:
        return _run_tier_chain(dispatch, cfg, device)
    sample, check = classify
    if len(_TIER_CACHE) > 256:
        _TIER_CACHE.clear()
    cached = _TIER_CACHE.get(ckey)
    if cached is None or cached["presorted"]:
        presorted, tier = _plan(decide, sample)
        if presorted:
            is_sorted = check()
            with host_read("presorted"):
                presorted = bool(is_sorted)
        if presorted:
            _TIER_CACHE[ckey] = {"presorted": True, "tier": tier}
            count_route("identity_routes")
            return identity()
        _TIER_CACHE[ckey] = {"presorted": False, "tier": tier}
        return _run_tier_chain(dispatch, cfg, device,
                               skip_radix=(tier == "equidepth"))
    tier = cached["tier"]

    def refresh():
        p, t = _plan(decide, sample)
        _TIER_CACHE[ckey] = {"presorted": p, "tier": t}

    return _run_tier_chain(dispatch, cfg, device,
                           skip_radix=(tier == "equidepth"),
                           first_sync=refresh)


def _sort_tiered(planes, traits, vt, *, kind: str, begin_bit: int,
                 end_bit: Optional[int], stable: bool, descending: bool,
                 device: torch.device, finish: Callable,
                 identity: Callable, algorithm: str = "auto"):
    """Check the bit range, pick the config and the engine, and sort
    twiddled planes: through the host tiering where ``algorithm`` (or the
    config's default, for "auto") is a radix engine, else by one call of
    the named engine (port of ``tpusort.api._sort_impl``).
    ``finish(sorted planes)`` makes the output keys; ``identity()`` gives
    (keys, values) for an input found sorted.  Returns (keys, list of
    values)."""
    eb = traits.bits if end_bit is None else end_bit
    if not 0 <= begin_bit < eb <= traits.bits:
        raise ValueError(
            f"invalid bit range [{begin_bit}, {eb}) for {traits.name}")
    n = planes[0].shape[0]
    words, spec = _dtypes.value_words(vt, n, device)
    cfg = _configs.get_config(traits.bits, bool(vt), device.type)
    bits = dict(begin_bit=begin_bit, end_bit=eb, total_bits=traits.bits)
    algo = cfg.default_algorithm if algorithm == "auto" else algorithm
    if algo not in _TIERED_ALGOS:
        if not stable and algorithm in ("auto", "msd", "lsd") and \
                "msd_unstable" in _ENGINES:
            algorithm = "msd_unstable"
        engine = _resolve_engine(algorithm, cfg)
        sp, sw = _call_engine(engine, tuple(planes), tuple(words),
                              config=cfg, **bits)
        return finish(tuple(sp)), _dtypes.join_values(sw, spec)
    stable = stable and algo != "msd_unstable"

    def dispatch(tier):
        """One tier: (keys, values, overflow flag, None where exact)."""
        with span("tpusort.tier." + tier):
            if tier == "radix":
                count_route("radix_tiers")
                sp, sw, ovf = sort_twiddled_msd(planes, words, config=cfg,
                                                stable=stable, **bits)
            elif tier == "equidepth":
                sp, sw, ovf = sort_twiddled_equidepth(
                    planes, words, config=cfg, stable=stable, **bits)
            else:
                (sp, sw), ovf = sort_twiddled_reference(planes, words,
                                                        **bits), None
            return finish(sp), _dtypes.join_values(sw, spec), ovf

    def decide(sample):
        tier = "radix"
        if "equidepth" in _tier_chain(cfg, device) and _skip_radix_tier(
                sample, n, traits.bits, cfg):
            tier = "equidepth"
        return planner.predict_presorted([sample]), tier

    classify = None
    if begin_bit == 0 and eb == traits.bits and n >= planner.PLANNER_MIN_N:
        classify = (_Sample(planes[0], max(1, n // planner.SAMPLE_TARGET)),
                    lambda: _lex_sorted(planes))
    ckey = (kind, n, traits.name, tuple(str(v.dtype) for v in vt),
            descending, stable, begin_bit, eb, cfg)
    return _tiered_flow(ckey, classify, decide, cfg, device, dispatch,
                        identity)


@spanned("tpusort.api.sort")
def sort(
    keys: torch.Tensor,
    values=None,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    algorithm: str = "auto",
    stable: bool = True,
):
    """Radix sort of a 1-D tensor of uint32/int32/float32 or
    uint64/int64/float64 keys, ascending or ``descending``, by the keys'
    bit patterns (NaN payloads, -0.0 and +0.0 keep their bits and sort by
    them), optionally carrying ``values``: one tensor or a tuple of
    tensors of the keys' length.  With ``begin_bit``/``end_bit`` only bits
    [begin_bit, end_bit) of the twiddled key order it (``descending``
    complements the bits first); the keys come back whole.  Stable by
    default (keys equal in those bits keep their input order, payloads
    too, ascending or descending); ``stable=False`` lets equal keys reorder
    their payloads.  Keys-only output does not depend on ``stable``.
    Returns the sorted keys, or ``(keys, values)`` when values are
    given: new tensors, also where the input was found already sorted.

    The call runs the host tiering (module docstring): radix, then, on an
    overflow flag, the equi-depth tier (on a card, or with
    ``skew_tier=True``), then the exact reference sort.  ``algorithm``
    names a registered engine (:func:`available_engines`); "auto" and the
    radix engines take the tiering, any other engine runs once, and an
    unknown name raises ValueError."""
    if not isinstance(keys, torch.Tensor):
        raise TypeError("keys must be a torch.Tensor")
    if keys.dim() != 1:
        raise NotImplementedError("tpusort_torch sorts 1-D tensors")
    vt, had, single = _normalize_values(values)
    planes, traits = _dtypes.twiddle_in(keys.contiguous(),
                                        descending=descending)
    out, sv = _sort_tiered(
        planes, traits, vt, kind="k", begin_bit=begin_bit, end_bit=end_bit,
        stable=stable, descending=descending, device=keys.device,
        finish=lambda sp: _dtypes.twiddle_out(sp, traits,
                                              descending=descending),
        identity=lambda: (keys.clone(), [v.clone() for v in vt]),
        algorithm=algorithm)
    if not had:
        return out
    return out, (sv[0] if single else tuple(sv))


@spanned("tpusort.api.sort_planes")
def sort_planes(
    planes,
    values=None,
    *,
    key_dtype: str = "uint64",
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    algorithm: str = "auto",
    stable: bool = True,
):
    """Sort keys given as 32-bit bit-pattern planes (plane 0 the most
    significant word): two planes for a 64-bit ``key_dtype``, one for a
    32-bit one.  ``key_dtype`` names the logical key type and selects the
    order-preserving twiddle.  Returns the sorted planes as uint32 tensors
    (and the values, if given), through the same host tiering as
    :func:`sort`."""
    traits = _dtypes.traits_for(getattr(torch, key_dtype, None))
    planes = tuple(planes)
    if len(planes) != traits.planes:
        raise ValueError(f"{traits.name} expects {traits.planes} 32-bit "
                         f"plane(s), got {len(planes)}")
    if any(p.element_size() != 4 or p.dim() != 1 or p.shape != planes[0].shape
           or p.device != planes[0].device for p in planes):
        raise ValueError("planes must be 1-D 32-bit tensors of one length "
                         "on one device")
    vt, had, single = _normalize_values(values)
    raw = tuple(p.contiguous().view(torch.int32) for p in planes)
    tw = _dtypes.twiddle_planes_in(raw, traits, descending=descending)

    def finish(sp):
        return tuple(p.view(torch.uint32) for p in _dtypes.twiddle_planes_out(
            sp, traits, descending=descending))

    out, sv = _sort_tiered(
        tw, traits, vt, kind="p", begin_bit=begin_bit, end_bit=end_bit,
        stable=stable, descending=descending, device=planes[0].device,
        finish=finish,
        identity=lambda: (tuple(p.clone().view(torch.uint32) for p in raw),
                          [v.clone() for v in vt]),
        algorithm=algorithm)
    if not had:
        return out
    return out, (sv[0] if single else tuple(sv))


@spanned("tpusort.api.argsort")
def argsort(
    keys: torch.Tensor,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    algorithm: str = "auto",
) -> torch.Tensor:
    """Indices (int64) that stably sort ``keys``.

    Full-range 32-bit keys sort the composite (twiddled key, index) planes
    keys-only (with ``algorithm`` "auto", "msd" or "lsd"): the index plane
    is both the stable tiebreak and the output.  Other keys (64-bit, or a
    ``begin_bit``/``end_bit`` range) and other engines take the stable
    pairs path with the index as payload."""
    if not isinstance(keys, torch.Tensor) or keys.dim() != 1:
        raise NotImplementedError("tpusort_torch sorts 1-D tensors")
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    traits = _dtypes.traits_for(keys.dtype)
    eb = traits.bits if end_bit is None else end_bit
    if begin_bit == 0 and eb == traits.bits == 32 and \
            algorithm in ("auto", "msd", "lsd"):
        (tw,), _ = _dtypes.twiddle_in(keys.contiguous(),
                                      descending=descending)
        _, perm = sort_planes((tw, idx), key_dtype="uint64", stable=False,
                              algorithm=algorithm)
    else:
        _, perm = sort(keys, idx, descending=descending, begin_bit=begin_bit,
                       end_bit=end_bit, algorithm=algorithm)
    return perm.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def sort_keys(keys, **kw):
    return sort(keys, **kw)


def sort_keys_descending(keys, **kw):
    return sort(keys, descending=True, **kw)


def sort_pairs(keys, values, **kw):
    return sort(keys, values, **kw)


def sort_pairs_descending(keys, values, **kw):
    return sort(keys, values, descending=True, **kw)


def unstable_sort_keys(keys, **kw):
    return sort(keys, stable=False, **kw)


def unstable_sort_pairs(keys, values, **kw):
    return sort(keys, values, stable=False, **kw)


@spanned("tpusort.api.sort_pairs_lsb_in_value")
def sort_pairs_lsb_in_value(keys: torch.Tensor, values: torch.Tensor,
                            num_lsb_bytes: int = 4, *,
                            descending: bool = False):
    """Unstable pair sort of 32-bit ``keys`` by the composite key (key,
    low ``num_lsb_bytes`` bytes of the 32-bit value), ascending or
    ``descending``.  The masked value bytes ride as the second key plane of
    the raw 2-plane path, and the whole value as the payload (port of
    ``tpusort.api.sort_pairs_lsb_in_value``).  Returns (keys, values)."""
    if not 1 <= num_lsb_bytes <= 4:
        raise ValueError("num_lsb_bytes must be in 1..4")
    if not isinstance(values, torch.Tensor) or values.element_size() != 4:
        raise ValueError("values must be a 32-bit dtype")
    if not isinstance(keys, torch.Tensor) or keys.dim() != 1:
        raise NotImplementedError("tpusort_torch sorts 1-D tensors")
    if _dtypes.traits_for(keys.dtype).planes != 1:
        raise NotImplementedError(
            "lsb-in-value needs a free plane slot: 32-bit key dtypes only")
    (plane,), traits = _dtypes.twiddle_in(keys.contiguous())
    (v,), _ = _dtypes.value_words((values,), keys.shape[0], keys.device)
    mask = (1 << (8 * num_lsb_bytes)) - 1
    comp = (plane, v & (mask - (1 << 32) if mask >= 1 << 31 else mask))
    if descending:
        comp = tuple(~p for p in comp)
    cfg = _configs.get_config(64, True, keys.device.type)
    sp, (sv,) = _msd_unstable(comp, (v,), begin_bit=0, end_bit=64,
                              total_bits=64, config=cfg)
    k_plane = ~sp[0] if descending else sp[0]
    return _dtypes.twiddle_out((k_plane,), traits), sv.view(values.dtype)
