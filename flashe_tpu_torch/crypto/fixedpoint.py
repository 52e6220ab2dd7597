"""Fixed-point encoding of floats for Paillier arithmetic (port of
flashe_tpu/crypto/fixedpoint.py: the same encodings and exponents).

Capability parity with the reference's stock secureprotol
(federatedml/secureprotol/fixedpoint.py, the python-paillier encoding):
floats map to integers `encoding * BASE^exponent` mod n, negatives wrap
into the top of the ring, addition aligns exponents, multiplication adds
them.  FLASHE itself never uses this — it quantizes instead
(SURVEY.md section 2.2) — but the hetero-FL Paillier path in the stock
framework does, so the codec is provided for completeness.
"""

from __future__ import annotations

import math
import sys

__all__ = ["FixedPointNumber"]


class FixedPointNumber:
    BASE = 16
    LOG2_BASE = math.log(BASE, 2)
    FLOAT_MANTISSA_BITS = sys.float_info.mant_dig

    # default ring for standalone (cipher-free) use
    Q = 293973345475167247070445277780365744413 ** 2

    def __init__(self, encoding: int, exponent: int, n: int = None,
                 max_int: int = None):
        self.n = self.Q if n is None else n
        self.max_int = (self.n // 3 - 1) if max_int is None else max_int
        self.encoding = encoding
        self.exponent = exponent

    # -- encode / decode ----------------------------------------------------

    @classmethod
    def encode(cls, scalar, n: int = None, max_int: int = None,
               precision: float = None, max_exponent: int = None
               ) -> "FixedPointNumber":
        if n is None:
            n = cls.Q
            max_int = n // 3 - 1
        if max_int is None:
            max_int = n // 3 - 1

        if precision is None:
            if isinstance(scalar, (int,)) or (
                hasattr(scalar, "dtype") and scalar.dtype.kind in "iu"
            ):
                exponent = 0
            else:
                # exact float representation: enough base-16 digits to
                # hold the full mantissa at this magnitude
                bin_flt_exponent = math.frexp(float(scalar))[1]
                bin_lsb_exponent = bin_flt_exponent - cls.FLOAT_MANTISSA_BITS
                exponent = math.floor(bin_lsb_exponent / cls.LOG2_BASE)
        else:
            exponent = math.floor(math.log(precision, cls.BASE))
        if max_exponent is not None:
            exponent = max(exponent, max_exponent)

        int_fixpoint = int(round(float(scalar) * pow(cls.BASE, -exponent)))
        if abs(int_fixpoint) > max_int:
            raise ValueError(
                f"scalar {scalar} out of range for n={n}")
        return cls(int_fixpoint % n, exponent, n, max_int)

    def decode(self) -> float:
        if self.encoding >= self.n:
            raise OverflowError("encoding out of ring")
        if self.encoding <= self.max_int:
            mantissa = self.encoding
        elif self.encoding >= self.n - self.max_int:
            mantissa = self.encoding - self.n
        else:
            raise OverflowError("overflow detected in decode")
        return mantissa * pow(self.BASE, self.exponent)

    # -- exponent management -------------------------------------------------

    def increase_exponent_to(self, new_exponent: int) -> "FixedPointNumber":
        if new_exponent < self.exponent:
            raise ValueError("cannot increase precision")
        factor = pow(self.BASE, new_exponent - self.exponent)
        # dividing by BASE^k in the ring = truncation toward the signed value
        if self.encoding <= self.max_int:
            enc = self.encoding // factor
        else:
            enc = self.n - ((self.n - self.encoding) // factor)
        return FixedPointNumber(enc % self.n, new_exponent, self.n,
                                self.max_int)

    def decrease_exponent_to(self, new_exponent: int) -> "FixedPointNumber":
        if new_exponent > self.exponent:
            raise ValueError("cannot decrease exponent upward")
        factor = pow(self.BASE, self.exponent - new_exponent)
        return FixedPointNumber((self.encoding * factor) % self.n,
                                new_exponent, self.n, self.max_int)

    def _aligned(self, other: "FixedPointNumber"):
        if self.exponent < other.exponent:
            return self, other.decrease_exponent_to(self.exponent)
        if self.exponent > other.exponent:
            return self.decrease_exponent_to(other.exponent), other
        return self, other

    # -- arithmetic ----------------------------------------------------------

    def _coerce(self, other):
        if isinstance(other, FixedPointNumber):
            return other
        return FixedPointNumber.encode(other, self.n, self.max_int)

    def __add__(self, other):
        other = self._coerce(other)
        a, b = self._aligned(other)
        return FixedPointNumber((a.encoding + b.encoding) % self.n,
                                a.exponent, self.n, self.max_int)

    __radd__ = __add__

    def __sub__(self, other):
        other = self._coerce(other)
        return self + (other * -1)

    def __rsub__(self, other):
        return self._coerce(other) - self

    def __mul__(self, other):
        other = self._coerce(other)
        return FixedPointNumber(
            (self.encoding * other.encoding) % self.n,
            self.exponent + other.exponent, self.n, self.max_int)

    __rmul__ = __mul__

    def __truediv__(self, other):
        scalar = other.decode() if isinstance(other, FixedPointNumber) \
            else float(other)
        return self * (1.0 / scalar)

    def __neg__(self):
        return self * -1

    # -- comparisons (by decoded value) ---------------------------------------

    def _val(self, other):
        return other.decode() if isinstance(other, FixedPointNumber) \
            else float(other)

    def __lt__(self, other):
        return self.decode() < self._val(other)

    def __gt__(self, other):
        return self.decode() > self._val(other)

    def __le__(self, other):
        return self.decode() <= self._val(other)

    def __ge__(self, other):
        return self.decode() >= self._val(other)

    def __eq__(self, other):
        return self.decode() == self._val(other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return (f"FixedPointNumber({self.decode()}, "
                f"exponent={self.exponent})")
