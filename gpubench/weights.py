"""Seeds, and weights made on the device from a seed.

Every draw of a run derives its own 63-bit seed from ``--seed`` and a tag
(:func:`derive`), so the same ``--seed`` gives the same weights and
batches on every rank and in every process, and the reference can draw
them again after the window.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

#: (name, shape, kind, scale): kind ``normal`` draws N(0, scale²),
#: ``zeros`` and ``ones`` fill.
Spec = Tuple[str, Tuple[int, ...], str, float]


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from the run's ``--seed`` (any whole number) and
    integer or string tags."""
    words = [int(seed) % (1 << 64)]
    for t in tags:
        words.extend(t.encode() if isinstance(t, str) else [int(t)])
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def make(specs: Sequence[Spec], seed: int, device, tag: str = "weights"
         ) -> Dict[str, torch.Tensor]:
    """fp32 tensors for ``specs`` on ``device``: one draw of standard
    normals for every ``normal`` leaf from a ``torch.Generator`` on the
    device, split and scaled leaf by leaf (each leaf its own tensor, as a
    user's model holds them)."""
    normal = [s for s in specs if s[2] == "normal"]
    total = sum(int(np.prod(s[1])) for s in normal)
    gen = torch.Generator(device=device).manual_seed(derive(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    pieces: List[torch.Tensor] = list(
        flat.split([int(np.prod(s[1])) for s in normal]))
    draws = dict(zip((s[0] for s in normal), pieces))
    for name, shape, kind, scale in specs:
        if kind == "normal":
            out[name] = (draws[name] * scale).view(shape)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init kind {kind!r} for {name}")
    return out
