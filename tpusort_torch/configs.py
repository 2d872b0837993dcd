"""Tuning configurations of the MSD engine, keyed by (key_bits, has_values,
platform).

PyTorch port of ``tpusort/configs.py``.  The platform is the device type of
the tensor being sorted (``"cuda"`` or ``"cpu"``).  Every field is consumed:
``SortConfig.plan_kwargs()`` feeds ``ops.msd.plan_msd`` directly, and the
skew-tier fields steer ``api``'s tier chain and ``ops.equidepth``.  The
TPU-only ``pass_batch`` and ``pairs_gather_apply`` are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["SortConfig", "get_config", "register_config"]


@dataclass(frozen=True)
class SortConfig:
    tile_elems: int = 1 << 14      # K: elements per tile (one CTA)
    radix: int = 32                # R: runs per tile (digit fan-out)
    s1: Optional[int] = None       # pass-1 padded run capacity (None = auto)
    leaf_max: Optional[int] = None # max final segment size (None = auto)
    min_n: int = 1 << 16           # below this the engine delegates
    small_n_threshold: int = 1 << 14  # single-tile path (K3) up to this n
    # the equi-depth skew tier in the host tier chain (radix -> equi-depth
    # -> exact); None = on for CUDA tensors
    skew_tier: Optional[bool] = None
    skew_sample_log2: Optional[int] = None  # splitter sample size (None = auto)
    default_algorithm: str = "msd" # the engine algorithm="auto" calls

    def plan_kwargs(self) -> dict:
        """The ``plan_msd`` keyword arguments this config pins."""
        kw = dict(k=self.tile_elems, r=self.radix, min_n=self.min_n)
        if self.s1 is not None:
            kw["s1"] = self.s1
        if self.leaf_max is not None:
            kw["leaf_max"] = self.leaf_max
        return kw


_REGISTRY: Dict[Tuple[int, bool, str], SortConfig] = {}


def register_config(key_bits: int, has_values: bool, platform: str,
                    cfg: SortConfig):
    _REGISTRY[(key_bits, has_values, platform)] = cfg


def get_config(key_bits: int, has_values: bool, platform: str) -> SortConfig:
    for key in (
        (key_bits, has_values, platform),
        (key_bits, has_values, "*"),
    ):
        if key in _REGISTRY:
            return _REGISTRY[key]
    return SortConfig()


# H100: K = 16384 keeps one tile (64 KB) and a leaf tile (a 12,288-key
# segment on K2's merge body; two packed and padded to 32,768 = 128 KB on
# its network) inside a CTA's 227 KB of shared memory.  The TPU rows' K = 65536 (256 KB per tile, 327,680-key leaf
# segments) cannot carry over.  s1 and leaf_max stay automatic: at 2^28
# this plans 3 passes, (K, S) = (16384, 768), (16384, 512), (16384, 512).
register_config(32, False, "cuda", SortConfig(tile_elems=1 << 14, radix=32,
                                              default_algorithm="msd"))
# Pairs and 64-bit keys: the kernels hold every key plane in shared memory
# (4 bytes a slot each) plus a 2-byte slot index when payloads ride, so the
# leaf must stay at 16,384 slots once a second plane appears (2 planes:
# 160 KB; 3 planes: 224 KB).  Stable 32-bit pairs sort the key plane
# with the value words under the (32, True) row, and argsort the
# (key, index) planes under (64, False).  At 2^28 each plans the same
# 3 passes as above with 12,288-key final segments.
_CUDA_MULTI = SortConfig(tile_elems=1 << 14, radix=32, leaf_max=1 << 14,
                         default_algorithm="msd")
for _bits, _hv in ((32, True), (64, False), (64, True)):
    register_config(_bits, _hv, "cuda", _CUDA_MULTI)
# CPU (tests): the JAX package's CPU geometry, so both packages plan alike
_CPU = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096,
                  small_n_threshold=2048)
for _bits in (32, 64):
    for _hv in (False, True):
        register_config(_bits, _hv, "cpu", _CPU)
