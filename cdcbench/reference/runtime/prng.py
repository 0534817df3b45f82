# Frozen copy of the port's runtime/prng.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Named random streams, mirroring tpucdc/runtime/prng.py.

JAX folds a static purpose tag into one root key, so adding a consumer never
perturbs the streams that exist. The port derives a ``torch.Generator`` per
(tag, step) from one root seed the same way, through the same sha256 tag
hash. The numbers differ from ``jax.random``'s: the tests hand both packages
the same draws instead.
"""

from __future__ import annotations

import hashlib

import torch


def _tag_to_int(tag: str) -> int:
    # Stable 31-bit hash, independent of PYTHONHASHSEED.
    return int.from_bytes(hashlib.sha256(tag.encode()).digest()[:4],
                          "little") & 0x7FFFFFFF


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit generator seed derived from ``seed`` and ``data``."""
    text = ":".join(str(int(v)) for v in (seed, *data))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & (2 ** 63 - 1)


def generator(seed: int, *data: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded with ``fold_in(seed, *data)``."""
    return torch.Generator(device).manual_seed(fold_in(seed, *data))


class KeyChain:
    """Independent named generators from one root seed.

    >>> kc = KeyChain(0)
    >>> g1 = kc.key("noise", step=10)
    >>> g2 = kc.key("dropout", step=10)   # independent of g1
    """

    def __init__(self, root_seed: int, device="cpu"):
        self._root = int(root_seed)
        self._device = device

    def key(self, tag: str, step: int = 0) -> torch.Generator:
        return generator(self._root, _tag_to_int(tag), step,
                         device=self._device)

    def split(self, tag: str, num: int, step: int = 0
              ) -> list[torch.Generator]:
        return [generator(self._root, _tag_to_int(tag), step, i,
                          device=self._device) for i in range(num)]
