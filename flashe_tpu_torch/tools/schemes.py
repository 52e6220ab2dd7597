"""The schemes both harnesses measure, built in one place.

A `Cell` is one client's values through a cipher: `encrypt()`, the add of
`N_CLIENTS` ciphertexts (`add10(ct)`), `decrypt(agg)`, and `check(out)`,
which says whether the decrypt is what the clients sent.  The paper's
comparison (`tools/compare_schemes.py`) times one call of each after a
warm call; bench.py's table2 (`tools/bench.py`) the median of 3 calls and
a run of back-to-back calls.  `run_cell` drives the three calls through
the caller's timer.  The constants are the reference's, and both harnesses
take them from here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

__all__ = ["N_CLIENTS", "EB", "FACTOR", "M", "KEY_BITS", "BFV_T", "BFV_N",
           "CKKS_N", "CKKS_SCALE", "FLASHE_SEED", "Cell", "run_cell",
           "flashe_client", "flashe_cell", "paillier_cipher",
           "paillier_batch_cell", "paillier_cell", "bfv_cipher", "bfv_cell",
           "ckks_cipher", "ckks_cell"]

N_CLIENTS = 10
EB, FACTOR = 16, 4           # 16-bit elements + ceil(log2(11)) pad bits
M = EB + FACTOR              # 20-bit lanes
KEY_BITS = 2048              # Paillier key; lanes of KEY_BITS bits
BFV_T, BFV_N = 1964769281, 8192  # t = 1 mod 2 x 8192: the batch prime
BFV_NO_BATCH_N = 2048
CKKS_N, CKKS_SCALE = 8192, 2.0 ** 40
FLASHE_SEED = bytes(range(32))


@dataclass(frozen=True)
class Cell:
    encrypt: Callable[[], object]
    add10: Callable[[object], object]
    decrypt: Callable[[object], object]
    check: Callable[[object], bool]


def run_cell(cell: Cell, measure) -> tuple:
    """The cell's encrypt, add and decrypt in turn, each as
    measure(f) -> (f's result, *stats).  Returns ((encrypt's stats,
    add's, decrypt's), the ciphertext, the check of the decrypt)."""
    ct, *s_enc = measure(cell.encrypt)
    agg, *s_add = measure(lambda: cell.add10(ct))
    out, *s_dec = measure(lambda: cell.decrypt(agg))
    return (tuple(s_enc), tuple(s_add), tuple(s_dec)), ct, bool(
        cell.check(out))


# -- FLASHE -----------------------------------------------------------------

def flashe_client(idx: int, device) -> "FlasheCipher":
    """Client idx of the harnesses' 10-client FLASHE session (one seed,
    iteration 0)."""
    from flashe_tpu_torch.crypto.flashe import FlasheCipher

    c = FlasheCipher(M, device=device)
    c.idx = idx
    c.set_num_clients(N_CLIENTS)
    c.generate_prp_seed(assigned_seed=FLASHE_SEED)
    c.set_iter_index(0)
    return c


def flashe_cell(q: np.ndarray, device) -> Cell:
    """q: (N_CLIENTS, n) M-bit values, one row a client.  Client 0
    encrypts its row; the other clients' ciphertexts are made here, once;
    the add sums the ten through lane_add; client 0 decrypts; the check is
    the sum of the rows mod 2^M, lane for lane."""
    from flashe_tpu_torch.ops.lanes import as_u32, lane_add

    q = np.asarray(q, dtype=np.uint32)
    qt = torch.from_numpy(q.view(np.int32)).to(device)
    clients = [flashe_client(i, device) for i in range(N_CLIENTS)]
    others = [clients[i].encrypt(qt[i]) for i in range(1, N_CLIENTS)]
    want = q.astype(np.int64).sum(0) % (1 << M)

    def add10(ct):
        for other in others:
            ct = lane_add(ct, other, M)
        return ct

    return Cell(lambda: clients[0].encrypt(qt[0]), add10, clients[0].decrypt,
                lambda out: np.array_equal(as_u32(out).cpu().numpy(), want))


# -- Paillier ---------------------------------------------------------------

def paillier_cipher(device, key_bits: int = KEY_BITS, keypair=None):
    """A PaillierCipher on `device` with `keypair` (public, private), else
    a new key_bits key."""
    from flashe_tpu_torch.crypto.paillier import PaillierCipher

    pail = PaillierCipher(device=device)
    if keypair is None:
        pail.generate_key(key_bits)
    else:
        pail.set_public_key(keypair[0])
        pail.set_privacy_key(keypair[1])
    return pail


def _paillier(pail, ints, decode, want) -> Cell:
    return Cell(lambda: pail.encrypt(ints),
                lambda ct: pail.add_ciphertexts([ct] * N_CLIENTS),
                lambda agg: decode(pail.decrypt(agg)),
                lambda out: np.array_equal(out, want))


def paillier_batch_cell(pail, q0: np.ndarray) -> Cell:
    """q0: n EB-bit values, packed on the host (batch_lanes_np), (key
    bits) // M to a plaintext; the decrypt unpacks on the host; the check
    is 10 q0 mod 2^M."""
    from flashe_tpu_torch.ops.lanes import ints_to_lanes, lanes_to_ints
    from flashe_tpu_torch.ops.quantize import batch_lanes_np, unbatch_lanes_np

    q0 = np.asarray(q0, dtype=np.uint32)
    key_bits, n = pail.n.bit_length(), len(q0)
    ints = lanes_to_ints(batch_lanes_np(q0, key_bits, EB, FACTOR), key_bits)

    def decode(sums):
        lanes = ints_to_lanes(sums, key_bits).numpy().view(np.uint32)
        return unbatch_lanes_np(lanes, n, key_bits, EB, FACTOR).astype(
            np.int64)

    return _paillier(pail, ints, decode,
                     q0.astype(np.int64) * N_CLIENTS % (1 << M))


def paillier_cell(pail, q0: np.ndarray) -> Cell:
    """No batching: one value a ciphertext; the check is 10 q0 exactly."""
    q0 = np.asarray(q0, dtype=np.uint32)
    return _paillier(pail, q0.astype(object),
                     lambda sums: np.asarray([int(v) for v in sums],
                                             np.int64),
                     q0.astype(np.int64) * N_CLIENTS)


# -- BFV and CKKS -----------------------------------------------------------

def bfv_cipher(device, batching: bool = True):
    """The reference's BFV: t BFV_T, N BFV_N batched (BFV_NO_BATCH_N
    otherwise), seed 0, keys made."""
    from flashe_tpu_torch.crypto.bfv import BFVCipher

    bfv = BFVCipher(BFV_T, BFV_N if batching else BFV_NO_BATCH_N,
                    flagBatching=batching, seed=0, device=device)
    bfv.generate_keys()
    return bfv


def bfv_cell(bfv, q0: np.ndarray) -> Cell:
    """q0: n EB-bit values; the check is 10 q0 exactly (mod t, which 10 q0
    stays under)."""
    q0 = np.asarray(q0, dtype=np.uint32)
    want = q0.astype(np.int64) * N_CLIENTS
    return Cell(lambda: bfv.encrypt(q0),
                lambda ct: bfv.add_ciphertexts([ct] * N_CLIENTS),
                lambda agg: bfv.decrypt(agg, len(q0)),
                lambda out: np.array_equal(
                    out.cpu().numpy().astype(np.int64), want))


def ckks_cipher(device):
    """The reference's CKKS: N CKKS_N at scale CKKS_SCALE, seed 0, keys
    made."""
    from flashe_tpu_torch.crypto.ckks import CKKSCipher

    ck = CKKSCipher(CKKS_N, global_scale=CKKS_SCALE, seed=0, device=device)
    ck.generate_keys()
    return ck


def ckks_cell(ck, x0: np.ndarray, batch: bool = True) -> Cell:
    """x0: n float64 values, packed N/2 to a ciphertext (or one a
    ciphertext); the check: every slot within 1e-2 of 10 x0."""
    enc, dec = ((ck.encrypt, ck.decrypt) if batch
                else (ck.encrypt_no_batch, ck.decrypt_no_batch))
    return Cell(lambda: enc(x0),
                lambda ct: ck.add_ciphertexts([ct] * N_CLIENTS),
                lambda agg: dec(agg, len(x0)),
                lambda out: float(np.max(np.abs(
                    out.cpu().numpy() - x0 * N_CLIENTS))) < 1e-2)
