"""Per-lane threefry-2x32 keys, as ``jax.random`` draws them.

The JAX package samples every acting row from that row's own PRNG key, a
``[N, 2]`` array of uint32 words (``jax.random`` under ``vmap``), and its
rollouts split those lane keys every step and derive every env reset from
them.  That is what makes lane ``i`` of a batched dispatch independent of
the batch it is served in (an N-replica serving tier equals one local
dispatch, a vectorized rollout equals per-env rollouts) and a restored
checkpoint resume on the same stream.  This module reproduces those keys
bit for bit, as int64 tensors that hold uint32 words.

The hash itself is ``repro_torch.kernels.threefry``: one launch of the
hand-written CUDA kernel for a CUDA tensor, the plain int64 op chain for a
CPU tensor, the same bits on both.  The functions follow JAX 0.9's threefry
with ``jax_threefry_partitionable`` on (its default): ``split`` and
``random_bits`` hash the counter pair ``(index >> 32, index & 0xFFFFFFFF)``
of each output element, ``fold_in`` hashes ``(0, data)``.  Each takes a
batch of lane keys ``[..., 2]`` and acts on every lane as ``jax.vmap`` of
the scalar function would; a single key ``[2]`` acts as ``jax.random`` on
one key.  Integer outputs (keys, bits, ``randint``) equal ``jax.random``'s
bit for bit; the float draws follow JAX's constructions (mantissa bits for
``uniform``, ``-log(-log u)`` for ``gumbel``, the argmax of gumbel + logits
for ``categorical``, ``sqrt(2) erfinv(u)`` for ``normal``), with torch's
``log`` and ``erfinv`` in place of XLA's.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple, Union

import torch

from repro_torch.kernels import threefry

__all__ = [
    "key",
    "split",
    "fold_in",
    "random_bits",
    "uniform",
    "gumbel",
    "categorical",
    "categorical_key",
    "randint",
    "normal",
]

MASK = threefry.MASK
_F32_TINY = float(torch.finfo(torch.float32).tiny)
# np.nextafter(-1.0, 0.0) in float32: the lower bound of JAX's normal draws.
_F32_ABOVE_MINUS_ONE = -1.0 + 2.0**-24

Shape = Union[int, Sequence[int]]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return torch.tensor(x, dtype=torch.float32).item()


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def key(seed: int, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``[seed >> 32, seed & 0xFFFFFFFF]``
    (a 32-bit seed, as JAX takes one by default, has a zero high word)."""
    seed = int(seed)
    hi = 0 if -(2**31) <= seed < 2**32 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of every lane key: ``[..., 2]`` ->
    ``[..., num, 2]``."""
    return threefry.hash_counts(keys, num, xor=False)


def fold_in(keys: torch.Tensor, data: Any) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``keys [..., 2]`` and integer
    ``data`` broadcast together (``fold_in(k, torch.arange(n))`` derives n
    lane keys from one key)."""
    return threefry.fold_in(keys, data)


def random_bits(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` of every lane key: uint32
    words in an int64 tensor ``[*lanes, *shape]``."""
    shape = _shape(shape)
    bits = threefry.hash_counts(keys, math.prod(shape), xor=True)
    return bits.reshape(tuple(bits.shape[:-1]) + shape)


def uniform(
    keys: torch.Tensor, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform`` (float32): 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into [minval, maxval)."""
    # JAX's float is the 23 mantissa bits under 1.0's exponent, minus 1:
    # exactly mantissa * 2^-23.  The bounds and their difference are rounded
    # to float32, as JAX takes them.  XLA contracts ``floats * span + lo``
    # into one fused multiply-add, a single rounding; in float64 the product
    # mantissa * (span * 2^-23) is exact (47 significant bits) and the sum
    # rounds once more to float32, which gives the same bits.
    lo, hi = _f32(minval), _f32(maxval)
    mantissa = random_bits(keys, shape) >> 9
    return (mantissa.double() * (_f32(hi - lo) * 2.0**-23) + lo).float().clamp_(min=lo)


def gumbel(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, the default "low" mode)."""
    return -torch.log(-torch.log(uniform(keys, shape, _F32_TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)``: one action per row
    of ``logits [..., A]`` from that row's key ``[..., 2]`` (int64)."""
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


def categorical_key(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` with one key ``[2]`` for all
    of ``logits [..., A]``: one gumbel draw of the logits' whole shape
    (the batch ``act`` of the reference's policies)."""
    g = gumbel(key, tuple(logits.shape))
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
