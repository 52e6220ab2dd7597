"""Re-encryption scheduling: trade security level against encrypt cost
(port of flashe_tpu/crypto/encrypt_mode.py).

Capability parity with the reference's stock
federatedml/secureprotol/encrypt_mode.py (EncryptModeCalculator), which
the hetero-FL Paillier paths use; FLASHE's pipeline re-masks every round
by construction and does not need it (SURVEY.md section 2.2).  Modes:

- strict: re-encrypt everything each call,
- fast: encrypt the first call only; later calls homomorphically add the
  plaintext difference to the previous ciphertexts,
- balance: 'fast', but re-encrypt fully with probability
  re_encrypted_rate each call,
- confusion_opt: reuse one cached encrypted-zero confusion per record,
- confusion_opt_balance: refresh those zeros with probability
  re_encrypted_rate.

Operates on DTables (flashe_tpu_torch/data/table.py) of scalars or numpy
arrays, like the reference operates on eggroll DTables.  On a table of a
storage node the maps and joins run in the node's egg processor, which
gets each function cloudpickled.  So the encrypt is a module-level
function bound to the encrypter alone with functools.partial, not the
JAX package's bound method and lambda over the calculator: those pickle
the calculator, whose previous tables hold live sockets, and a full
re-encrypt ('strict', 'balance') of a second round then fails.
"""

from __future__ import annotations

import functools
import random

__all__ = ["EncryptModeCalculator"]

_MODES = ("strict", "fast", "balance", "confusion_opt",
          "confusion_opt_balance")


class EncryptModeCalculator:
    def __init__(self, encrypter, mode: str = "strict",
                 re_encrypted_rate: float = 1.0, rng: random.Random = None):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}")
        self.encrypter = encrypter
        self.mode = mode
        self.re_encrypted_rate = re_encrypted_rate
        self._rng = rng or random.Random()
        self.prev_data = None
        self.prev_encrypted_data = None
        self.enc_zeros = None

    def should_re_encrypt(self) -> bool:
        return self._rng.random() <= self.re_encrypted_rate + 1e-12

    def encrypt(self, input_data):
        """input_data: DTable of scalars/arrays -> DTable of ciphertexts."""
        if self.mode in ("confusion_opt", "confusion_opt_balance"):
            refresh = (
                self.enc_zeros is None
                or self.enc_zeros.count() != input_data.count()
                or (self.mode == "confusion_opt_balance"
                    and self.should_re_encrypt())
            )
            if refresh:
                self.enc_zeros = input_data.mapValues(
                    functools.partial(_encrypt_zeros, self.encrypter))
            return input_data.join(self.enc_zeros, _add_zero)

        full = (
            self.prev_data is None
            or self.prev_data.count() != input_data.count()
            or self.mode == "strict"
            or (self.mode == "balance" and self.should_re_encrypt())
        )
        if full:
            new_data = input_data.mapValues(
                functools.partial(_encrypt_value, self.encrypter))
        else:
            diff = input_data.join(self.prev_data, _difference)
            new_data = diff.join(self.prev_encrypted_data, _add_difference)
        self.prev_data = input_data.mapValues(lambda v: v)
        self.prev_encrypted_data = new_data.mapValues(lambda v: v)
        return new_data


def _encrypt_value(encrypter, v):
    enc = encrypter.encrypt
    if hasattr(v, "__len__"):
        return [enc(float(x)) for x in v]
    return enc(float(v))


def _encrypt_zeros(encrypter, v):
    return _encrypt_value(
        encrypter, [0.0] * len(v) if hasattr(v, "__len__") else 0.0)


def _add_zero(obj, enc_zero):
    if isinstance(obj, (list, tuple)) or hasattr(obj, "__len__"):
        return [z + float(o) for o, z in zip(obj, enc_zero)]
    return enc_zero + float(obj)


def _difference(new_obj, old_obj):
    if hasattr(new_obj, "__len__"):
        return [float(a) - float(b) for a, b in zip(new_obj, old_obj)]
    return float(new_obj) - float(old_obj)


def _add_difference(diff, encrypted):
    if isinstance(diff, list):
        return [c + d for d, c in zip(diff, encrypted)]
    return encrypted + diff
