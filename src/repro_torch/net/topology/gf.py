"""Galois field GF(p^k) arithmetic for Slim Fly MMS graph construction.

Elements of GF(p^k) are encoded as integers in [0, p^k): the base-p digits of
the integer are the coefficients of the residue polynomial (digit i = coeff of
x^i).  Pure-Python/NumPy host-side code — topology construction is setup, not
the hot loop.

Port of ``repro.net.topology.gf``.
"""
from __future__ import annotations

import numpy as np


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for f in range(2, int(n**0.5) + 1):
        if n % f == 0:
            return False
    return True


def factor_prime_power(q: int) -> tuple[int, int]:
    """Return (p, k) with q == p**k, p prime; raise if q is not a prime power."""
    for p in range(2, q + 1):
        if not _is_prime(p):
            continue
        k, m = 0, q
        while m % p == 0:
            m //= p
            k += 1
        if m == 1 and k >= 1:
            return p, k
    raise ValueError(f"{q} is not a prime power")


class GF:
    """GF(p^k) with precomputed add/mul tables (q is small: <= a few hundred)."""

    def __init__(self, q: int):
        self.q = q
        self.p, self.k = factor_prime_power(q)
        self._poly = self._find_irreducible()
        self.add_table, self.mul_table = self._build_tables()
        self.primitive = self._find_primitive()

    # --- polynomial helpers: polys are tuples of ints mod p, low degree first ---
    def _int_to_poly(self, e: int) -> list[int]:
        digits = []
        for _ in range(self.k):
            digits.append(e % self.p)
            e //= self.p
        return digits

    def _poly_to_int(self, poly: list[int]) -> int:
        v = 0
        for c in reversed(poly):
            v = v * self.p + (c % self.p)
        return v

    def _poly_mul_mod(self, a: list[int], b: list[int]) -> list[int]:
        p = self.p
        prod = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            if ai == 0:
                continue
            for j, bj in enumerate(b):
                prod[i + j] = (prod[i + j] + ai * bj) % p
        # reduce modulo the irreducible polynomial (monic, degree k)
        mod = self._poly
        for d in range(len(prod) - 1, self.k - 1, -1):
            c = prod[d]
            if c == 0:
                continue
            prod[d] = 0
            # subtract c * x^(d-k) * mod
            for i, mi in enumerate(mod[:-1]):  # mod[-1] == 1 (monic)
                prod[d - self.k + i] = (prod[d - self.k + i] - c * mi) % p
        return prod[: self.k] + [0] * max(0, self.k - len(prod))

    def _find_irreducible(self) -> list[int]:
        """Monic irreducible polynomial of degree k over GF(p) (brute force)."""
        p, k = self.p, self.k
        if k == 1:
            return [0, 1]  # x (unused — arithmetic is plain mod p)
        for const in range(p**k):
            coeffs = []
            e = const
            for _ in range(k):
                coeffs.append(e % p)
                e //= p
            poly = coeffs + [1]  # monic
            # irreducible over GF(p) iff no root in GF(p) works only for k<=3;
            # use full divisibility test: no monic factor of degree 1..k//2.
            if self._poly_is_irreducible(poly):
                return poly
        raise RuntimeError("no irreducible polynomial found")

    def _poly_is_irreducible(self, poly: list[int]) -> bool:
        p, k = self.p, self.k
        # try all monic polynomials of degree 1..k//2 as divisors
        for d in range(1, k // 2 + 1):
            for const in range(p**d):
                coeffs = []
                e = const
                for _ in range(d):
                    coeffs.append(e % p)
                    e //= p
                div = coeffs + [1]
                if self._poly_divides(div, poly):
                    return False
        return True

    @staticmethod
    def _poly_divmod(num: list[int], den: list[int], p: int) -> list[int]:
        num = list(num)
        dd = len(den) - 1
        inv = pow(den[-1], p - 2, p)
        for i in range(len(num) - 1, dd - 1, -1):
            c = (num[i] * inv) % p
            if c:
                for j, dj in enumerate(den):
                    num[i - dd + j] = (num[i - dd + j] - c * dj) % p
        return num[:dd] if dd > 0 else []

    def _poly_divides(self, div: list[int], poly: list[int]) -> bool:
        rem = self._poly_divmod(poly, div, self.p)
        return all(c == 0 for c in rem)

    def _build_tables(self) -> tuple[np.ndarray, np.ndarray]:
        q, p, k = self.q, self.p, self.k
        add = np.zeros((q, q), dtype=np.int64)
        mul = np.zeros((q, q), dtype=np.int64)
        polys = [self._int_to_poly(e) for e in range(q)]
        for a in range(q):
            pa = polys[a]
            for b in range(q):
                pb = polys[b]
                add[a, b] = self._poly_to_int([(x + y) % p for x, y in zip(pa, pb)])
                if k == 1:
                    mul[a, b] = (a * b) % p
                else:
                    mul[a, b] = self._poly_to_int(self._poly_mul_mod(pa, pb))
        return add, mul

    def _find_primitive(self) -> int:
        """Generator of the multiplicative group (order q-1)."""
        q = self.q
        for g in range(2, q):
            x, order = g, 1
            while x != 1:
                x = int(self.mul_table[x, g])
                order += 1
                if order > q:
                    break
            if order == q - 1:
                return g
        raise RuntimeError("no primitive element found")

    # --- public ops ---
    def add(self, a: int, b: int) -> int:
        return int(self.add_table[a, b])

    def neg(self, a: int) -> int:
        # find additive inverse via table row (q small)
        return int(np.where(self.add_table[a] == 0)[0][0])

    def sub(self, a: int, b: int) -> int:
        return self.add(a, self.neg(b))

    def mul(self, a: int, b: int) -> int:
        return int(self.mul_table[a, b])

    def pow(self, a: int, n: int) -> int:
        r = 1
        for _ in range(n):
            r = self.mul(r, a)
        return r
