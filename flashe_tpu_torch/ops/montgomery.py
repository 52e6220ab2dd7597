"""Montgomery products on 32-bit limbs (port of
flashe_tpu/ops/pallas_modmath.py).

A residue is a (B, L) int32 tensor of uint32 little-endian limbs, and
R = 2^(32 L): the kernels never pad L, since a wider L would change R.
Three functions, each with a hand-written CUDA kernel in
flashe_tpu_torch/csrc/montgomery.cu and a plain torch version beside it:

    mont_mul(a, b, n, n_prime)             a*b*R^-1 mod n, one shared modulus
    mont_mul_vec(a, b, n_rows, npr_rows)   the same with a modulus per row
    mont_exp_rows(a, mod_idx, n_tab, npr_tab, r2_tab, one_tab, dig_tab)
                                           a^e mod n per row, whole fixed-
                                           window (w = 4) modexp in one launch

n' is -n^-1 mod 2^32 in every argument.  Operands must be below their
modulus; results are fully reduced, so kernel and plain version agree limb
for limb.  On a CPU tensor each function runs its plain version; on a CUDA
tensor it launches its kernel on that tensor's device (made current for the
launch) or raises, and adds one to `launches[name]` under a lock: the roles
of a federated round launch from threads of one process.

The plain versions view each 32-bit limb as two 16-bit digits and run the
JAX package's lazy CIOS (flashe_tpu/ops/modmath.py::mont_mul) exactly, in
int64, with the 16-bit n' (n' mod 2^16): R = 2^(16 * 2L) is the kernels'
R.  A digit product is below 2^32 and an accumulator below 2^27, so nothing
wraps.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from flashe_tpu_torch.ops import _build
from flashe_tpu_torch.ops.lanes import as_u32, to_i32

__all__ = ["WINDOW", "MAX_LIMBS", "layout", "launches", "mont_mul",
           "mont_mul_vec", "mont_exp_rows", "mont_mul_ref", "mont_mul_vec_ref",
           "mont_exp_rows_ref", "select_entry", "bind"]

WINDOW = 4  # exponent digit width of mont_exp_rows
MAX_LIMBS = 128  # 4096-bit moduli: 16 threads a row, 8 limbs a thread

launches = {"mont_mul": 0, "mont_mul_vec": 0, "mont_exp_rows": 0}
_count_lock = threading.Lock()  # roles launch from threads of one process

_DBITS = 16
_DMASK = (1 << _DBITS) - 1


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def _digits16(x: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 limbs -> (..., 2L) int64 16-bit digits."""
    u = as_u32(x)
    return torch.stack((u & _DMASK, u >> _DBITS), dim=-1).flatten(-2)


def _limbs32(d: torch.Tensor) -> torch.Tensor:
    """(..., 2L) int64 16-bit digits -> (..., L) int32 limbs."""
    d = d.unflatten(-1, (-1, 2))
    return to_i32(d[..., 0] | (d[..., 1] << _DBITS))


def _up(x: torch.Tensor, d: int) -> torch.Tensor:
    """Move every digit d places up; zeros come in at the bottom."""
    return F.pad(x, (d, 0))[..., :x.shape[-1]]


def _resolve_carries(s: torch.Tensor):
    """Digits s < 2 * 2^16 -> (digits < 2^16, carry out of the top digit).

    The carry recurrence c_{j+1} = g_j | (p_j & c_j), g = s >= 2^16,
    p = s == 2^16 - 1, resolved by a Kogge-Stone scan in log2 of the width.
    """
    g = (s > _DMASK).to(torch.int64)
    p = (s == _DMASK).to(torch.int64)
    d = 1
    while d < s.shape[-1]:
        g = g | (p & _up(g, d))
        p = p & _up(p, d)
        d <<= 1
    return (s + _up(g, 1)) & _DMASK, g[..., -1]


def _cios16(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor, npr):
    """a*b*R^-1 mod n on (B, D) int64 16-bit digits, R = 2^(16 D).

    n: (D,) or (B, D); npr: -n^-1 mod 2^16, an int or a (B,) tensor.
    The steps of flashe_tpu/ops/modmath.py::mont_mul, one for one."""
    B, D = a.shape
    t = a.new_zeros(B, D + 2)
    for i in range(D):
        p = a[:, i:i + 1] * b
        t[:, :D] += p & _DMASK
        t[:, 1:D + 1] += p >> _DBITS
        m = ((t[:, 0] & _DMASK) * npr) & _DMASK
        q = m[:, None] * n
        t[:, :D] += q & _DMASK
        t[:, 1:D + 1] += q >> _DBITS
        # shift one digit down; the retired digit's low 16 bits are zero
        carry0 = t[:, 0] >> _DBITS
        t = F.pad(t[:, 1:], (0, 1))
        t[:, 0] += carry0
    s = (t & _DMASK) + _up(t >> _DBITS, 1)
    tn, _ = _resolve_carries((s & _DMASK) + _up(s >> _DBITS, 1))
    # T < 2n may exceed R (digit D set): subtract n when that digit is set
    # or low >= n; low + (R - n) carries out of the top digit iff low >= n
    low = tn[:, :D]
    one0 = F.pad(torch.ones_like(low[:, :1]), (0, D - 1))
    sub, geq = _resolve_carries(low + (_DMASK - n) + one0)
    need = (tn[:, D] > 0) | (geq > 0)
    return torch.where(need[:, None], sub, low)


def select_entry(tbl: torch.Tensor, digit: torch.Tensor) -> torch.Tensor:
    """Row r of tbl[digit[r]] for every row, reading every entry of the
    (T, B, ...) table: no memory index and no branch depends on a digit."""
    entries = torch.arange(tbl.shape[0], device=tbl.device)
    hot = digit[None, :] == entries[:, None]
    hot = hot.to(tbl.dtype).reshape(hot.shape + (1,) * (tbl.dim() - 2))
    return (tbl * hot).sum(0, dtype=tbl.dtype)


def mont_mul_ref(a, b, n, n_prime: int) -> torch.Tensor:
    """Plain version of mont_mul: a, b (B, L) int32, n (L,) int32."""
    return _limbs32(_cios16(_digits16(a), _digits16(b), _digits16(n),
                            int(n_prime) & _DMASK))


def mont_mul_vec_ref(a, b, n_rows, npr_rows) -> torch.Tensor:
    """Plain version of mont_mul_vec: n_rows (B, L), npr_rows (B,) int32."""
    return _limbs32(_cios16(_digits16(a), _digits16(b), _digits16(n_rows),
                            as_u32(npr_rows) & _DMASK))


def mont_exp_rows_ref(a, mod_idx, n_tab, npr_tab, r2_tab, one_tab,
                      dig_tab) -> torch.Tensor:
    """Plain version of mont_exp_rows: into Montgomery form with r^2, the
    2^w table, w squarings and one table multiply per MSB-first digit (the
    entry picked by select_entry), then out by a product with 1."""
    idx = mod_idx.long()
    n = _digits16(n_tab)[idx]
    npr = (as_u32(npr_tab) & _DMASK)[idx]
    one = _digits16(one_tab)[idx]
    digits = dig_tab.long()[idx]  # (B, ndig)

    def mul(x, y):
        return _cios16(x, y, n, npr)

    base = mul(_digits16(a), _digits16(r2_tab)[idx])
    tbl = [one]
    for _ in range((1 << WINDOW) - 1):
        tbl.append(mul(tbl[-1], base))
    tbl = torch.stack(tbl)
    acc = one
    for s in range(digits.shape[1]):
        for _ in range(WINDOW):
            acc = mul(acc, acc)
        acc = mul(acc, select_entry(tbl, digits[:, s]))
    return _limbs32(mul(acc, F.pad(torch.ones_like(acc[:, :1]),
                                   (0, acc.shape[1] - 1))))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the three entry points on a library built
    from csrc/montgomery.cu."""
    i64, i32, u32 = ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    sigs = {
        "mont_mul": [_P, _P, _P, u32, _P, i64, i32, _P],
        "mont_mul_vec": [_P, _P, _P, _P, _P, i64, i32, _P],
        "mont_exp_rows": [_P, _P, _P, _P, _P, _P, _P, i32, i32, _P, i64, i32,
                          _P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    return bind(_build.load("montgomery"))


def layout(L: int):
    """(threads a row, limbs a thread) of the kernel instance that rows of
    L limbs launch, as the kernels' dispatch picks it.  Builds and loads
    the kernels' library, so it runs where nvcc does."""
    if not 1 <= L <= MAX_LIMBS:
        raise ValueError(f"L = {L} is outside 1 .. {MAX_LIMBS}")
    packed = _lib().mont_layout(int(L))  # int in, int out: ctypes' default
    return packed >> 16, packed & 0xFFFF


def _check(name: str, dev: torch.device, **tensors):
    for arg, (t, shape) in tensors.items():
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be a contiguous int32 "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _route(name: str, a: torch.Tensor) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version
    (a CPU tensor); any other device raises."""
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")
    if a.dim() != 2 or not 1 <= a.shape[1] <= MAX_LIMBS:
        raise ValueError(f"{name}: the kernel takes (B, L) limbs with "
                         f"1 <= L <= {MAX_LIMBS}, got {tuple(a.shape)}")
    return True


def _count(name: str):
    with _count_lock:
        launches[name] += 1


def _launch(name: str, out: torch.Tensor, *args):
    if out.shape[0] == 0:
        return out
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(_lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count(name)
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor,
             n_prime: int) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod n; a, b (B, L), n (L,), all int32.

    Replaces flashe_tpu/ops/pallas_modmath.py::_kernel."""
    if not _route("mont_mul", a):
        return mont_mul_ref(a, b, n, n_prime)
    B, L = a.shape
    _check("mont_mul", a.device, a=(a, (B, L)), b=(b, (B, L)), n=(n, (L,)))
    out = torch.empty_like(a)
    return _launch("mont_mul", out, a.data_ptr(), b.data_ptr(), n.data_ptr(),
                   int(n_prime) & 0xFFFFFFFF, out.data_ptr(), B, L)


def mont_mul_vec(a: torch.Tensor, b: torch.Tensor, n_rows: torch.Tensor,
                 npr_rows: torch.Tensor) -> torch.Tensor:
    """Montgomery product with row r reduced mod its own n_rows[r], with
    npr_rows[r] its n'.  Replaces pallas_modmath.py::_kernel_vec."""
    if not _route("mont_mul_vec", a):
        return mont_mul_vec_ref(a, b, n_rows, npr_rows)
    B, L = a.shape
    _check("mont_mul_vec", a.device, a=(a, (B, L)), b=(b, (B, L)),
           n_rows=(n_rows, (B, L)), npr_rows=(npr_rows, (B,)))
    out = torch.empty_like(a)
    return _launch("mont_mul_vec", out, a.data_ptr(), b.data_ptr(),
                   n_rows.data_ptr(), npr_rows.data_ptr(), out.data_ptr(), B,
                   L)


def mont_exp_rows(a: torch.Tensor, mod_idx: torch.Tensor, n_tab: torch.Tensor,
                  npr_tab: torch.Tensor, r2_tab: torch.Tensor,
                  one_tab: torch.Tensor, dig_tab: torch.Tensor
                  ) -> torch.Tensor:
    """a[r]^e mod n for every row, plain domain in and out, in one launch.

    Row r uses modulus k = mod_idx[r] of the (K, L) tables n_tab, r2_tab
    (R^2 mod n), one_tab (R mod n), of npr_tab (K,) (n') and of dig_tab
    (K, ndig): the exponent's MSB-first base-2^4 digits.  Constant time in
    the exponent.  Replaces pallas_modmath.py::_kernel_exp."""
    if not _route("mont_exp_rows", a):
        return mont_exp_rows_ref(a, mod_idx, n_tab, npr_tab, r2_tab, one_tab,
                                 dig_tab)
    B, L = a.shape
    K, ndig = dig_tab.shape
    _check("mont_exp_rows", a.device, a=(a, (B, L)), mod_idx=(mod_idx, (B,)),
           n_tab=(n_tab, (K, L)), npr_tab=(npr_tab, (K,)),
           r2_tab=(r2_tab, (K, L)), one_tab=(one_tab, (K, L)),
           dig_tab=(dig_tab, (K, ndig)))
    if B and not 0 <= int(mod_idx.min()) <= int(mod_idx.max()) < K:
        raise ValueError(f"mont_exp_rows: mod_idx must lie in [0, {K})")
    out = torch.empty_like(a)
    return _launch("mont_exp_rows", out, a.data_ptr(), mod_idx.data_ptr(),
                   n_tab.data_ptr(), npr_tab.data_ptr(), r2_tab.data_ptr(),
                   one_tab.data_ptr(), dig_tab.data_ptr(), ndig, K,
                   out.data_ptr(), B, L)
