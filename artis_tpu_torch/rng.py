"""Counter-derived random numbers.

The JAX package folds counters into threefry keys; here a key is a plain
tuple of integers, e.g. ``(pre_zseed, 1000 + nts, iteration, tag)``,
and each draw seeds a fresh ``torch.Generator`` from a hash of the tuple. A
timestep's numbers therefore depend only on its counters, never on a running
generator state, which is what makes checkpoint resume bit-exact.

``philox_uniform4`` and ``philox_uniform2d`` are the in-kernel generator of
the r-packet crossing kernel (Philox4x32-10 keyed by seed and lane, counter
= draw index; four float32 or two float64 uniforms a draw), written out in
integer tensor arithmetic so the plain version draws the same numbers as the
CUDA kernel.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def seed_of(key: tuple) -> int:
    """63-bit seed from a counter tuple."""
    h = 0x2545F4914F6CDD1D
    for v in key:
        h = _splitmix64(h ^ (int(v) & _MASK64))
    return h & ((1 << 63) - 1)


def fold_in(key: tuple, x: int) -> tuple:
    return tuple(key) + (int(x),)


def generator(key: tuple, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(key))
    return g


def uniform(key: tuple, tag: int, shape, dtype, device) -> torch.Tensor:
    """Uniform [0, 1) draws for counter tuple ``key + (tag,)``."""
    if isinstance(shape, int):
        shape = (shape,)
    g = generator(fold_in(key, tag), device)
    return torch.rand(shape, generator=g, dtype=dtype, device=device)


def isotropic(key: tuple, tag: int, n: int, dtype, device) -> torch.Tensor:
    """Isotropic unit vectors (reference: vectors.h:205-213)."""
    u = uniform(key, tag, (2, n), dtype, device)
    costheta = -1.0 + 2.0 * u[0]
    phi = u[1] * (2.0 * torch.pi)
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta**2, min=0.0))
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi), costheta], dim=-1)


# --- Philox4x32-10 (Salmon et al. 2011), the crossing kernel's generator ---
_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_U32 = 0xFFFFFFFF


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox rounds on int64 tensors that hold uint32 values. Products
    wrap in int64, but the low 64 bits of the bit pattern are the exact
    product, so masking recovers hi/lo."""
    for _ in range(10):
        p0 = c0 * _M0
        p1 = c2 * _M1
        hi0 = (p0 >> 32) & _U32
        lo0 = p0 & _U32
        hi1 = (p1 >> 32) & _U32
        lo1 = p1 & _U32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _U32
        k1 = (k1 + _W1) & _U32
    return c0, c1, c2, c3


def _philox_words(seed: int, lane: torch.Tensor, draw: int, sub: int):
    lane = lane.to(torch.int64) & _U32
    z = torch.zeros_like(lane)
    return philox4x32(lane, z + (draw & _U32), z + (sub & _U32), z,
                      seed & _U32, (seed >> 32) & _U32)


def philox_uniform4(seed: int, lane: torch.Tensor, draw: int, sub: int):
    """Four float32 uniforms in (0, 1) per lane for crossing ``draw`` and
    sub-stream ``sub``: 24 high bits scaled by 2^-24, floored at 1e-12 (the
    kernel's ``uniform4``)."""
    return [torch.clamp((o >> 8).to(torch.float32) * (1.0 / (1 << 24)), min=1e-12)
            for o in _philox_words(seed, lane, draw, sub)]


def philox_uniform2d(seed: int, lane: torch.Tensor, draw: int, sub: int):
    """Two float64 uniforms in (0, 1) per lane for crossing ``draw`` and
    sub-stream ``sub``: 53 bits from each pair of Philox words (the high 27
    bits of the first, the high 26 of the second) scaled by 2^-53, floored
    at 1e-300 as the JAX package floors its optical-depth draw (the
    kernel's ``uniform2d``)."""
    w = _philox_words(seed, lane, draw, sub)
    return [torch.clamp((((w[i] >> 5) << 26) | (w[i + 1] >> 6)).to(torch.float64)
                        * 2.0 ** -53, min=1e-300) for i in (0, 2)]
