"""Counter-based Philox4x32-10 random stream in plain PyTorch integer ops.

The pulse kernel (``csrc/philox.cuh``) draws its thermal noise from
Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC11), keyed by a 64-bit seed, with the counter (env index, substep, draw,
0). This module computes the same words on int64 tensors, on any device, so
that the plain integrator and the kernel see the same noise. The 32 x 32-bit
products are split into 16-bit halves: 0xD2511F53 * 0xFFFFFFFF does not fit
a signed 64-bit integer.

One Philox call gives four 32-bit words. They become four uniforms in [0, 1)
by the 23-bit mantissa rule (w & 0x7FFFFF) * 2^-23, then two exact
Box-Muller pairs with u1 = 1 - U in (0, 1] and the (cos, sin) of 2 pi u2
from one quadrant-folded polynomial evaluation, then four normals.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _mulhilo(a: int, b: Tensor) -> Tuple[Tensor, Tensor]:
    """(high, low) 32-bit words of the 64-bit product a * b, b in [0, 2^32)."""
    p_lo = (b & 0xFFFF) * a  # < 2^48
    p_hi = (b >> 16) * a  # < 2^48
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter, key: Tuple[int, int]):
    """Philox4x32 with 10 rounds.

    ``counter``: four int64 tensors of uint32 values (broadcast together);
    ``key``: two uint32 Python ints. Returns four int64 tensors of uint32
    words.
    """
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> Tuple[int, int]:
    """The Philox key (low word, high word) of a 64-bit seed."""
    seed &= _MASK64
    return seed & _MASK32, seed >> 32


def derive_seed(seed: int, counter: int) -> int:
    """A 64-bit seed for the ``counter``-th call from a base seed
    (SplitMix64 of seed + (counter + 1) * golden gamma). Host arithmetic
    only, so a step that uses it reads nothing from the device."""
    z = (seed + (counter + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


# Stream tags of the draws an env step keys from its state's (seed,
# counter) besides the pulse's thermal noise, which takes
# derive_seed(seed, counter) itself.
RESET_STREAM = 1  # auto-reset states
KICK_STREAM = 2  # the racetrack's thermal kicks


def step_generator(seed: int, counter: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on ``device`` for stream ``stream`` of step
    ``counter``, seeded with derive_seed(derive_seed(seed, counter), stream):
    a key of its own, never the pulse's. A step that draws from it reads and
    advances nothing of the state, so stepping one state twice draws the
    same numbers."""
    generator = torch.Generator(device=device)
    generator.manual_seed(derive_seed(derive_seed(seed, counter), stream))
    return generator


def uniform_from_bits(w: Tensor, dtype) -> Tensor:
    """Uniform in [0, 1) from 23 random mantissa bits (exact in float32)."""
    return (w & 0x7FFFFF).to(dtype) * (2.0**-23)


def cos_sin_2pi(u: Tensor) -> Tuple[Tensor, Tensor]:
    """Signed (cos, sin) of 2 pi u for u in [0, 1).

    Quadrant fold (2 pi u = (pi/2)(k + r), |r| <= 1/2, k = round(4u)) and
    the Cephes float32 minimax polynomials for cos and sin on |x| <= pi/4;
    the quadrant index supplies the signs. Same operations, in the same
    order, as the kernel's ``cos_sin_2pi``."""
    q = u * 4.0
    k = torch.floor(q + 0.5)
    x = (q - k) * (0.5 * math.pi)  # |x| <= pi/4
    z = x * x
    cp = ((2.443315711809948e-5 * z - 1.388731625493765e-3) * z
          + 4.166664568298827e-2) * (z * z) - 0.5 * z + 1.0
    sp = (((-1.9515295891e-4 * z + 8.3321608736e-3) * z
           - 1.6666654611e-1) * z) * x + x
    kb = k.to(torch.int32) & 3
    swap = (kb & 1) == 1
    c = torch.where(swap, sp, cp)
    s = torch.where(swap, cp, sp)
    c = torch.where((kb == 1) | (kb == 2), -c, c)
    s = torch.where((kb == 2) | (kb == 3), -s, s)
    return c, s


def normal_pair(w1: Tensor, w2: Tensor, dtype) -> Tuple[Tensor, Tensor]:
    """Two independent standard normals by exact Box-Muller from two words."""
    u1 = 1.0 - uniform_from_bits(w1, dtype)  # (0, 1]: safe for log
    u2 = uniform_from_bits(w2, dtype)
    r = torch.sqrt(-2.0 * torch.log(u1))
    c, s = cos_sin_2pi(u2)
    return r * c, r * s


def normals4(words, dtype) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Four standard normals from one Philox call's four words."""
    a0, a1 = normal_pair(words[0], words[1], dtype)
    b0, b1 = normal_pair(words[2], words[3], dtype)
    return a0, a1, b0, b1


def substep_normals(seed: int, env_index: Tensor, substeps: Tensor, draws: int, dtype) -> Tensor:
    """The thermal normals of envs ``env_index`` (B,) at ``substeps`` (C,):
    a (C, 4 * draws, B) tensor whose row 4 d + j is normal j of draw d."""
    key = seed_key(seed)
    c0 = env_index.to(torch.int64)[None, :]
    c1 = substeps.to(torch.int64)[:, None]
    c3 = torch.zeros_like(c0)
    out = []
    for d in range(draws):
        c2 = torch.full_like(c0, d)
        out.extend(normals4(philox4x32_10((c0, c1, c2, c3), key), dtype))
    return torch.stack(out, dim=1)
