"""Foundation utilities (counterpart of `libstevi_tpu/core/utils.py`).

Reference parity: `utils/` — `Contiguity` Queen/Rook/Bishop neighborhoods
(`contiguity.h:26-143`), `PropagationDirection` four diagonal sweep traits
(`propagation_direction.h:27-90`), `IndexPairMap` (`indexers.h:25`), the
fixed-point type-promotion helpers (`types_manipulations.h:45-80`), and
`Random::NumbersCache` (`randomcache.h:41-108`, a pre-generated RNG cache
for reproducible draws).
"""

from __future__ import annotations

import enum

import torch


class Contiguity(enum.Enum):
    """Pixel neighborhood families (`contiguity.h:26`)."""

    QUEEN = 0   # 8-connected
    ROOK = 1    # 4-connected
    BISHOP = 2  # diagonal-connected

    @property
    def offsets(self):
        if self is Contiguity.ROOK:
            return ((-1, 0), (1, 0), (0, -1), (0, 1))
        if self is Contiguity.BISHOP:
            return ((-1, -1), (-1, 1), (1, -1), (1, 1))
        return ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                (1, -1), (1, 0), (1, 1))


class PropagationDirection(enum.Enum):
    """The four diagonal sweep directions used by PatchMatch
    (`propagation_direction.h:27-90`); values are (row, col) increments."""

    TOP_LEFT_TO_BOTTOM_RIGHT = (1, 1)
    TOP_RIGHT_TO_BOTTOM_LEFT = (1, -1)
    BOTTOM_LEFT_TO_TOP_RIGHT = (-1, 1)
    BOTTOM_RIGHT_TO_TOP_LEFT = (-1, -1)

    @property
    def increments(self):
        return self.value


class IndexPairMap(dict):
    """Symmetric pair-keyed map (`indexers.h:25`): (a, b) and (b, a) are the
    same key."""

    @staticmethod
    def _key(a, b):
        return (a, b) if a <= b else (b, a)

    def __setitem__(self, key, value):
        super().__setitem__(self._key(*key), value)

    def __getitem__(self, key):
        return super().__getitem__(self._key(*key))

    def __contains__(self, key):
        return super().__contains__(self._key(*key))


_EXTENDED = {
    torch.uint8: torch.int16, torch.int8: torch.int16,
    torch.uint16: torch.int32, torch.int16: torch.int32,
    torch.uint32: torch.int64, torch.int32: torch.int64,
}


def accumulation_extended_dtype(dtype: torch.dtype) -> torch.dtype:
    """Wider accumulation dtype for integer pipelines
    (`accumulation_extended_t`, `types_manipulations.h:45-60`); float32
    for every other type."""
    return _EXTENDED.get(dtype, torch.float32)


def equivalent_one_for_normalizing(dtype: torch.dtype) -> int:
    """The fixed-point representation of 1.0 for an integer dtype
    (`equivalentOneForNormalizing`, `types_manipulations.h:74-80`):
    2^(bits-2) so products stay in range."""
    return 1 << (torch.iinfo(dtype).bits - 2)


class NumbersCache:
    """Deterministic pre-generated random cache (`randomcache.h:41-108`):
    ``size`` integers in [minval, maxval) drawn once from a
    `torch.Generator` seeded by ``seed``, read back in sequence.

    The draws are torch's (a CPU Philox/Mersenne stream), not the JAX
    package's threefry ones: the same seed gives other values there, and
    the same values here on every device and run."""

    def __init__(self, size: int = 1 << 16, minval: int = 0,
                 maxval: int = 1 << 30, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        self._cache = torch.randint(minval, maxval, (size,), generator=gen,
                                    dtype=torch.int64)
        self._pos = 0

    def seed(self, s: int):
        self._pos = int(s) % self._cache.shape[0]

    def __call__(self) -> int:
        v = int(self._cache[self._pos])
        self._pos = (self._pos + 1) % self._cache.shape[0]
        return v
