"""The noise the benchmark hands to the program and to the reference.

The program takes a noise source as an argument (``infer_batch(noise=)``,
``spec2wav(noise=)``): any object with ``normal``, ``uniform``,
``randint`` and ``bernoulli``.  :class:`DrawNoise` is the benchmark's own:
a seeded ``torch.Generator`` on the device, a count of its draws, and a
way to keep the next draws for the check (:meth:`keep_next`), which a hook
asks for where a checked step is about to draw.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

# (run seed, stream, index) -> a seed of the generator: distinct streams
# for distinct purposes, whatever the run seed (which may pass 2**32)
_MASK = (1 << 63) - 1


def derive_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed from the run's seed and ``parts``, by SplitMix64."""
    x = int(seed) & ((1 << 64) - 1)
    for p in parts:
        x = (x + 0x9E3779B97F4A7C15 * (int(p) + 1)) & ((1 << 64) - 1)
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        x = z ^ (z >> 31)
    return x & _MASK


class DrawNoise:
    """Draws from ``torch.Generator(device).manual_seed(seed)``; counts
    them; keeps a copy of a draw that :meth:`keep_next` asked for."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.count = 0
        self._keep = 0
        self.kept: List[Tuple[int, str, torch.Tensor]] = []

    def keep_next(self, n: int) -> None:
        """Keep copies of the next ``n`` draws (as (index, kind, tensor))."""
        self._keep = max(self._keep, n)

    def _out(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        if self._keep:
            self.kept.append((self.count, kind, x.clone()))
            self._keep -= 1
        self.count += 1
        return x

    def normal(self, shape: Sequence[int],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if out is not None:
            return self._out("normal", out.normal_(generator=self.generator))
        return self._out("normal", torch.randn(
            tuple(shape), generator=self.generator, device=self.device))

    def uniform(self, shape: Sequence[int],
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if out is not None:
            return self._out("uniform",
                             out.uniform_(generator=self.generator))
        return self._out("uniform", torch.rand(
            tuple(shape), generator=self.generator, device=self.device))

    def randint(self, shape: Sequence[int], low: int, high: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if out is not None:
            return self._out("randint", out.random_(
                low, high, generator=self.generator))
        return self._out("randint", torch.randint(
            low, high, tuple(shape), generator=self.generator,
            device=self.device))

    def bernoulli(self, p: float, shape: Sequence[int] = (),
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        u = self.uniform(shape)
        return torch.lt(u, p, out=out) if out is not None else u < p

    def take_kept(self) -> List[Tuple[int, str, torch.Tensor]]:
        kept, self.kept = self.kept, []
        return kept
