"""Primitives that make the port bit-identical to the JAX reference.

The reference runs on XLA, whose CPU code generator fixes three things
that plain torch ops do differently, and draws its randomness from
JAX's threefry stream.  Each function here reproduces one of them, on
the CPU and on the card alike (they only use elementwise torch ops):

* ``prng_key`` / ``fold_in`` / ``split`` / ``uniform``: threefry2x32,
  bit-identical to ``jax.random`` with ``jax_threefry_partitionable``
  (the default since jax 0.5).  A key is a pair of uint32 words, held
  as Python ints on the host or as 0-d int64 tensors on a device, where
  the engine derives each tick's keys from a tick held in a 0-d int32
  tensor without reading it back; the draws run on tensors, several of
  them in one pass (``uniforms``).
* ``xla_cumsum_f32``: XLA's f32 prefix sum, which scans sequentially
  inside blocks of 16 and then adds the running block totals.
* ``fma_f32``: one fused multiply-add rounded once, the form XLA's CPU
  backend contracts the ``exp_alpha`` EWMA ``(1 - g) * a + g * f`` into;
  DCTCP's ``alpha`` rounds unfused inside the reference's loop.
* ``red_recip``: the f32 reciprocal XLA multiplies by when it divides
  by the constant ``kmax - kmin``.

Integers live in int64 tensors holding uint32 values and are masked
back to 32 bits, so the arithmetic is exact on any device.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on counter words ``(x0, x1)``.

    Key and counter words are Python ints or int64 tensors of uint32
    values (broadcast together).  Returns the two output words.  ``x0``
    is masked only at the end: its low 32 bits never depend on its high
    ones, and it stays far below 2**63."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0 & _M32, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31)."""
    if not 0 <= seed < 1 << 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return (0, int(seed))


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for data in [0, 2**32).  ``key``
    is a pair of ints and ``data`` an int, or either is on a device: key
    words as 0-d int64 tensors, ``data`` as a 0-d integer tensor (the
    result is then a pair of 0-d int64 tensors)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    return threefry2x32(key[0], key[1], 0, data)


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` (partitionable threefry).  A key of
    0-d tensors gives subkeys of 0-d tensors, all from one threefry
    pass."""
    if not isinstance(key[0], torch.Tensor):
        return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]
    cnt = torch.arange(num, dtype=torch.int64, device=key[0].device)
    w0, w1 = threefry2x32(key[0], key[1], torch.zeros_like(cnt), cnt)
    return [(w0[i], w1[i]) for i in range(num)]


def random_bits(draws, device) -> list[torch.Tensor]:
    """32 random bits per element (int64 holding uint32) for each
    ``(key, shape)`` in ``draws``, with row-major counters as
    ``jax.random.bits`` draws them; all draws share one threefry pass.
    Keys are pairs of ints or of 0-d int64 tensors on ``device``."""
    sizes = [int(np.prod(shape)) for _, shape in draws]
    if max(sizes) >= 1 << 32:
        raise ValueError("random_bits supports fewer than 2**32 elements")
    cnt = torch.cat([torch.arange(n, dtype=torch.int64, device=device)
                     for n in sizes])
    if len(draws) == 1:
        (k0, k1), _ = draws[0]
    elif isinstance(draws[0][0][0], torch.Tensor):
        k0, k1 = (torch.cat([key[j].reshape(1).expand(n)
                             for (key, _), n in zip(draws, sizes)])
                  for j in (0, 1))
    else:
        k0, k1 = (torch.cat([torch.full((n,), key[j], dtype=torch.int64,
                                        device=device)
                             for (key, _), n in zip(draws, sizes)])
                  for j in (0, 1))
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    bits = (b0 ^ b1).split(sizes)
    return [b.reshape(shape) for b, (_, shape) in zip(bits, draws)]


def uniforms(draws, device) -> list[torch.Tensor]:
    """``jax.random.uniform(key, shape)`` in [0, 1), float32, for each
    ``(key, shape)`` in ``draws``."""
    return [(((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
             - 1.0) for b in random_bits(draws, device)]


def uniform(key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1), float32."""
    return uniforms([(key, shape)], device)[0]


def xla_cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last axis in XLA's order:
    sequential inside blocks of 16, then each block adds the (itself
    blocked) inclusive scan of the earlier block totals.  The last block
    is padded with zeros after its real entries, which leaves their sums
    unchanged."""
    n = x.shape[-1]
    nb = max((n + 15) // 16, 1)
    xp = torch.nn.functional.pad(x, (0, nb * 16 - n))
    xp = xp.reshape(*x.shape[:-1], nb, 16)
    cols = [xp[..., 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + xp[..., j])
    local = torch.stack(cols, dim=-1)                    # [..., nb, 16]
    if nb > 1:
        run = xla_cumsum_f32(local[..., :-1, 15])        # [..., nb - 1]
        local = torch.cat([local[..., :1, :],
                           local[..., 1:, :] + run[..., None]], dim=-2)
    return local.reshape(*x.shape[:-1], nb * 16)[..., :n]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` on f32 tensors, rounded once to f32.

    The product of two f32 values is exact in f64; the f64 sum is then
    rounded to odd (TwoSum gives its exact error), so the final cast to
    f32 rounds once, as a hardware fma does."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    bump = (err != 0) & even
    s = torch.where(bump, torch.nextafter(s, s + err), s)
    return s.float()


def f32(x) -> float:
    """A Python float holding exactly the f32 value of ``x`` — the
    constant XLA uses where the reference mixes a Python float into f32
    arithmetic (JAX's weak typing)."""
    return float(np.float32(x))


def red_recip(kmin: float, kmax: float) -> float:
    """The f32 reciprocal of ``max(kmax - kmin, 1e-9)``: XLA replaces
    the division by this constant with a multiply by its reciprocal,
    itself folded in f32."""
    d = np.float32(max(kmax - kmin, 1e-9))
    return float(np.float32(1.0) / d)
