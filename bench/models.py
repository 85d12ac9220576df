"""The weights the benchmark makes for both sides, for any configuration.

The weights are inputs: made on the device from ``--seed``, one call of
``normal_`` into each leaf of the program's parameter tree (a stacked
leaf holds every layer of its kind), each leaf from a generator of its
own, so that one leaf can be made again alone (the training check's
parameter change, the reference's copy). Scales: normal / sqrt(fan in),
norms ones. A configuration's own module (``bench/configs/<config>.py``)
may give a ``fill(path, leaf, draw)`` for the leaves it sets otherwise
(fixed values, another scale); it returns None for the rest.
"""

from __future__ import annotations

import hashlib
import math

import torch


def tree_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) of a nested dict in sorted-key order; paths join keys with '/'."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return [(prefix, tree)]


_ONES = ("norm1/w", "norm2/w", "final_norm/w")


def _fan_in(path: str, shape: tuple) -> float:
    """The scale of a leaf's normal draw: 1 / sqrt(its fan in)."""
    if path in ("embed", "unembed"):
        d = shape[1] if path == "embed" else shape[0]
        return 1.0 / math.sqrt(d)
    if path.rsplit("/", 1)[-1] == "wo":  # (L, H, D, d)
        return 1.0 / math.sqrt(shape[1] * shape[2])
    return 1.0 / math.sqrt(shape[1])  # (L, fan in, ...)


class WeightMaker:
    """The benchmark's weights for a configuration and a seed; ``fill``
    is the configuration module's hook, if it has one."""

    def __init__(self, cfg: dict, seed: int, device, fill=None):
        self.cfg = cfg
        self.seed = int(seed)
        self.device = torch.device(device)
        self._fill = fill

    def _generator(self, path: str) -> torch.Generator:
        h = hashlib.sha256(f"{self.seed}:{path}".encode()).digest()
        return torch.Generator(device=self.device).manual_seed(int.from_bytes(h[:8], "little") >> 1)

    @torch.no_grad()
    def fill(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """Write leaf ``path``'s weights into ``leaf`` (in its dtype) and
        return it."""

        def draw(std: float) -> torch.Tensor:
            return leaf.normal_(0.0, std, generator=self._generator(path))

        if self._fill is not None:
            done = self._fill(path, leaf, draw)
            if done is not None:
                return done
        if path.endswith(_ONES):
            return leaf.fill_(1.0)
        return draw(_fan_in(path, tuple(leaf.shape)))

    def fill_tree(self, tree) -> dict:
        """Fill every leaf of a parameter tree; returns the tree."""
        for path, leaf in tree_paths(tree):
            self.fill(path, leaf)
        return tree

    def make(self, path: str, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """Leaf ``path`` made again, alone, in a fresh tensor."""
        return self.fill(path, torch.empty(shape, dtype=dtype, device=self.device))
