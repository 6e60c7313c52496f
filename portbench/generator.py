"""The traffic generator: one mix file of parameters -> a run's inputs.

The harness drives one client in a closed loop (each call starts when the
last one has returned); a mix that asks for another ``loop`` or more
``clients`` is refused. A mix (``traffic/<mix>.json``) states the item
size (``item_hw``, uint8 BGR images), the pool of distinct items a run
draws from (``pool``), the items per call (``batch``) and how calls take
them (``batches``):

- ``"drawn"``: every call takes ``batch`` distinct items, the pool walked
  in random permutations, so each item comes back once per ``pool / batch``
  calls;
- ``"fixed"``: the pool is ``pool / batch`` whole batches, and each call
  takes one of them, the batches walked in random permutations.

Every seed gets the same sizes and the same amount of work: the seed
changes the pixels and the order, nothing else.
"""

from __future__ import annotations

from typing import List

import numpy as np


def split_seed(seed: int, parts: int) -> List[int]:
    """`parts` independent 63-bit seeds from any whole number."""
    seq = np.random.SeedSequence(int(seed) % 2**63)
    return [int(s.generate_state(1, np.uint64)[0]) >> 1 for s in seq.spawn(parts)]


class Traffic:
    """The pool of items (host numpy, (pool, h, w, 3) uint8) and the items
    of call i (`items`), made from two seeds on `device`."""

    def __init__(self, mix: dict, pool_seed: int, order_seed: int, device):
        import torch

        if mix.get("loop", "closed") != "closed" or int(mix.get("clients", 1)) != 1:
            raise ValueError("traffic: the harness drives one closed-loop client only")
        h, w = (int(v) for v in mix["item_hw"])
        self.pool_size, self.batch = int(mix["pool"]), int(mix["batch"])
        self.mode = mix.get("batches", "drawn")
        if self.mode not in ("drawn", "fixed"):
            raise ValueError(f"traffic: unknown batches mode {self.mode!r}")
        if self.pool_size % self.batch:
            raise ValueError(f"traffic: pool {self.pool_size} is not a multiple of batch {self.batch}")
        gen = torch.Generator(device=device).manual_seed(pool_seed)
        self.pool = torch.randint(0, 256, (self.pool_size, h, w, 3), generator=gen,
                                  device=device, dtype=torch.uint8).cpu().numpy()
        self._rng = np.random.default_rng(order_seed)
        self._calls: List[np.ndarray] = []

    def _extend(self) -> None:
        b = self.batch
        if self.mode == "drawn":
            perm = self._rng.permutation(self.pool_size)
            self._calls.extend(perm[i:i + b] for i in range(0, self.pool_size, b))
        else:
            for k in self._rng.permutation(self.pool_size // b):
                self._calls.append(np.arange(k * b, (k + 1) * b))

    def items(self, i: int) -> np.ndarray:
        """The pool indices call i takes (the same for the same seed)."""
        while i >= len(self._calls):
            self._extend()
        return self._calls[i]
