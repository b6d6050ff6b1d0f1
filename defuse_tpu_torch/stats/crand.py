"""Exact replicas of the C and Perl RNG streams the reference pipelines.

``GlibcRand`` reproduces glibc's ``rand()`` (TYPE_3 additive feedback
generator) so that ``srand(11)`` covariance-marker sampling
(``tools/calccov.cpp:116-141``) is bit-identical to the reference binary.

``Drand48`` reproduces the POSIX drand48 LCG (Perl's ``rand`` on the
reference's platforms) for ``merge_cov_samples.pl``'s ``srand(11)``
sample picking.
"""

from __future__ import annotations


class GlibcRand:
    """glibc rand(): r[i] = r[i-3] + r[i-31] (mod 2^32), output >> 1."""

    def __init__(self, seed: int):
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = seed & 0xFFFFFFFF
        for i in range(1, 31):
            # Schrage's method as in glibc __initstate_r; equivalent to
            # (16807 * r[i-1]) % 2147483647 for positive values
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = r
        self._i = 34
        # discard the first 310 outputs (glibc warms the state)
        for _ in range(310):
            self._next_raw()

    def _next_raw(self) -> int:
        r = self._r
        val = (r[-3] + r[-31]) & 0xFFFFFFFF
        r.append(val)
        if len(r) > 1024:
            del r[:-34]
        return val

    def rand(self) -> int:
        return self._next_raw() >> 1


class Drand48:
    """POSIX drand48: X' = (0x5DEECE66D * X + 0xB) mod 2^48."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        # srand48 semantics: high 32 bits = seed, low 16 = 0x330E
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def drand(self) -> float:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x / float(1 << 48)
