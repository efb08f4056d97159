"""Random-number-generator adapters.

Where the JAX package takes a ``jax.random`` key, the port takes ``rng``:
an int (or numpy integer) seed, a ``torch.Generator``, or None.  These
helpers normalize whatever the user passed.

The CUDA kernels draw their own random numbers from a counter-based
generator seeded with two 32-bit words.  :func:`seed_words` draws those
words on the host from a CPU generator, so drawing a seed never waits for
the device.  A run of steps replayed as CUDA graphs draws all its steps'
words before the run into a table on the device, and each step hands its
kernels a row of it, a 2-word int64 tensor, which they read themselves.
"""

import numbers as _numbers

import numpy as _np
import torch

__all__ = ["as_generator", "seed_words", "device_generator", "RNG_DEFAULT",
           "is_numpy_rng"]

RNG_DEFAULT = _np.random.mtrand  # the reference's default rng of the host classes


def is_numpy_rng(rng) -> bool:
    """True for a numpy generator (``numpy.random``'s module, a
    ``RandomState`` or a ``Generator``): the host classes then draw on the
    host with the reference's semantics; an int, a ``torch.Generator`` or
    None draws through torch."""
    return hasattr(rng, "multinomial") and not isinstance(rng, torch.Generator)

# module-level default stream for rng=None: advancing it on every use makes
# repeated convenience calls draw FRESH samples (a fixed seed would silently
# return identical batches)
_default_gen = None


def _next_default_seed() -> int:
    global _default_gen
    if _default_gen is None:
        _default_gen = torch.Generator().manual_seed(0)
    return int(torch.randint(0, 2**63 - 1, (1,), generator=_default_gen))


def as_generator(rng) -> torch.Generator:
    """Return a CPU ``torch.Generator`` for ``rng`` (None | int | numpy
    integer | ``torch.Generator``).  A generator is returned as it is, so
    successive draws from it advance one stream; None advances the module
    default stream."""
    if isinstance(rng, torch.Generator):
        return rng
    if rng is None:
        return torch.Generator().manual_seed(_next_default_seed())
    if isinstance(rng, _numbers.Integral):
        return torch.Generator().manual_seed(int(rng))
    raise TypeError(
        "rng must be None, an int or a torch.Generator, got %r" % type(rng))


def seed_words(rng):
    """Two 32-bit seed words for a kernel launch, drawn on the host from
    :func:`as_generator` of ``rng`` (advancing it); a tuple of two words,
    or a 2-word integer tensor (a row of a run's seed table), is returned as
    it is."""
    if isinstance(rng, (tuple, torch.Tensor)):
        return rng
    gen = as_generator(rng)
    if gen.device.type != "cpu":
        raise ValueError("seed words are drawn from a CPU generator")
    w = torch.randint(0, 2**32, (2,), generator=gen, dtype=torch.int64)
    return int(w[0]), int(w[1])


def host_words(seed) -> tuple:
    """The two words of ``seed`` (a tuple, or a 2-word tensor, copied to the
    host) as ints."""
    return int(seed[0]), int(seed[1])


def device_generator(seed, device) -> torch.Generator:
    """A generator on ``device`` seeded from two 32-bit ``seed`` words (a
    tuple or a 2-word tensor): the plain (non-kernel) versions of the random
    kernels draw from it, the same for either form of the same words."""
    s0, s1 = (w & 0xFFFFFFFF for w in host_words(seed))
    # a CPU generator (mt19937) keeps only the low 32 bits of its seed:
    # fold the high word into them, so both words move the stream there too
    low = s1 ^ ((s0 * 0x9E3779B9) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed((s0 << 32 | low) & (2**63 - 1))
