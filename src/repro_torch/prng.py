"""Per-lane threefry-2x32 keys in plain torch integer ops.

The JAX package samples every acting row from that row's own PRNG key, a
``[N, 2]`` array of uint32 words (``jax.random`` under ``vmap``), and the
vectorized rollout engine splits those lane keys every step.  That is what
makes lane ``i`` of a batched dispatch independent of the batch it is served
in (an N-replica serving tier equals one local dispatch, chunked serving
equals whole-batch serving).  This module reproduces those keys bit for bit:
threefry-2x32 is integer arithmetic, so it runs here on int64 tensors that
hold uint32 words (every sum masked with ``& 0xFFFFFFFF``), on the CPU or on
the card with the same bits.

The functions follow JAX 0.9's threefry with ``jax_threefry_partitionable``
on (its default): ``split`` and ``random_bits`` hash the counter pair
``(index >> 32, index & 0xFFFFFFFF)`` of each output element, ``fold_in``
hashes ``(0, data)``.  Each takes a batch of lane keys ``[..., 2]`` and acts
on every lane as ``jax.vmap`` of the scalar function would.  Integer outputs
(keys, bits, ``randint``) equal ``jax.random``'s bit for bit; the float draws
follow JAX's constructions (mantissa bits for ``uniform``, ``-log(-log u)``
for ``gumbel``, the argmax of gumbel + logits for ``categorical``, ``sqrt(2)
erfinv(u)`` for ``normal``), with torch's ``log`` and ``erfinv`` in place of
XLA's.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple, Union

import torch

__all__ = [
    "key",
    "split",
    "fold_in",
    "random_bits",
    "uniform",
    "gumbel",
    "categorical",
    "randint",
    "normal",
]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(torch.finfo(torch.float32).tiny)
# np.nextafter(-1.0, 0.0) in float32: the lower bound of JAX's normal draws.
_F32_ABOVE_MINUS_ONE = -1.0 + 2.0**-24

Shape = Union[int, Sequence[int]]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return torch.tensor(x, dtype=torch.float32).item()


def _u32(x: Any, device: Any = None) -> torch.Tensor:
    """Integers (tensor, array or int) as int64 holding uint32 words."""
    t = torch.as_tensor(x, device=device)
    if t.dtype != torch.int64:
        t = t.to(torch.int64)
    return t & MASK


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: Any, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``; all four broadcast together.

    Each op is a launch on the card, so the masks are as few as the
    arithmetic allows: ``x2`` is masked after every update, since its
    rotation must see 32 bits; ``x1`` only adds and feeds ``x2`` through
    the masked xor, so its low word stays right as it grows (under 2^37
    after 25 additions) and it is masked once at the end."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & MASK
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1 & MASK, x2


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _hash_counts(keys: torch.Tensor, shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both hash words of every counter ``0 .. prod(shape) - 1`` under every
    lane key: two tensors ``[*lanes, *shape]``."""
    keys = _u32(keys)
    lead = tuple(keys.shape[:-1])
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    hi, lo = (0, counts) if n <= MASK + 1 else (counts >> 32, counts & MASK)
    pad = (1,) * len(lead)
    k1 = keys[..., 0].reshape(lead + (1,))
    k2 = keys[..., 1].reshape(lead + (1,))
    if not isinstance(hi, int):
        hi = hi.reshape(pad + (n,))
    b1, b2 = threefry2x32(k1, k2, hi, lo.reshape(pad + (n,)))
    return b1.reshape(lead + shape), b2.reshape(lead + shape)


def key(seed: int, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``[seed >> 32, seed & 0xFFFFFFFF]``
    (a 32-bit seed, as JAX takes one by default, has a zero high word)."""
    seed = int(seed)
    hi = 0 if -(2**31) <= seed < 2**32 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of every lane key: ``[..., 2]`` ->
    ``[..., num, 2]``."""
    b1, b2 = _hash_counts(keys, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data: Any) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``keys [..., 2]`` and integer
    ``data`` broadcast together (``fold_in(k, torch.arange(n))`` derives n
    lane keys from one key)."""
    keys = _u32(keys)
    data = _u32(data, keys.device)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` of every lane key: uint32
    words in an int64 tensor ``[*lanes, *shape]``."""
    b1, b2 = _hash_counts(keys, _shape(shape))
    return b1 ^ b2


def uniform(
    keys: torch.Tensor, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform`` (float32): 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into [minval, maxval)."""
    bits = random_bits(keys, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # The bounds and their difference rounded to float32, as JAX takes them;
    # a float32 tensor times a Python float stays in float32.
    lo, hi = _f32(minval), _f32(maxval)
    return (floats * _f32(hi - lo) + lo).clamp_(min=lo)


def gumbel(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, the default "low" mode)."""
    return -torch.log(-torch.log(uniform(keys, shape, _F32_TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)``: one action per row
    of ``logits [..., A]`` from that row's key ``[..., 2]`` (int64)."""
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


def randint(keys: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 draws) of
    every lane key, as int64: 64 random bits folded into the span by JAX's
    modular construction, so the values equal JAX's bit for bit."""
    shape = _shape(shape)
    bits = random_bits(split(keys, 2), shape)  # [*lanes, 2, *shape]: both subkeys in one hash
    higher, lower = bits.unbind(dim=-len(shape) - 1)
    lo = max(min(int(minval), 2**31 - 1), -(2**31))
    hi = max(min(int(maxval), 2**31 - 1), -(2**31))
    span = 1 if hi <= lo else (hi - lo) & MASK
    if int(maxval) > 2**31 - 1 and hi > lo:
        span = (span + 1) & MASK
    if span == 0:  # the full 2^32 range: XLA's x % 0 is x, so the low word
        offset = lower
    else:  # uint32 products wrap, as in XLA
        multiplier = (((2**16 % span) ** 2) & MASK) % span
        offset = (((higher % span) * multiplier) & MASK) + lower % span
        offset = (offset & MASK) % span
    value = (lo + offset) & MASK
    return torch.where(value >= 2**31, value - 2**32, value)


def normal(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``sqrt(2) * erfinv(u)`` with ``u``
    uniform in (-1, 1)."""
    u = uniform(keys, shape, _F32_ABOVE_MINUS_ONE, 1.0)
    return torch.erfinv(u) * _f32(math.sqrt(2.0))
