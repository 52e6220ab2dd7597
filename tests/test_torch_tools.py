"""PyTorch port: the host side of the kernel measurements, on the CPU.

The bounds of flashe_tpu_torch/tools/roofline.py and chip_smoke.py, the
parsing of ptxas's messages in flashe_tpu_torch/ops/_build.py, and the
limb counts that the Montgomery layout query refuses before it builds.
"""

from __future__ import annotations

import pytest

import chip_smoke
from flashe_tpu_torch.ops import _build, montgomery
from flashe_tpu_torch.tools import roofline

CARD = roofline.Card("H100", "700.00 W", 1980.0, 132)


def test_mont_bounds():
    # one encrypt's products: 12,066 rows x 128 limbs, 4 L^2 IMAD a row
    assert roofline.mont_imads(12_066, 128) == 790_757_376
    ms, by = roofline.bound_ms(roofline.mont_imads(12_066, 128),
                               4 * 128 * (3 * 12_066 + 1), CARD)
    assert by == "operations"
    assert ms == pytest.approx(790_757_376 / (64 * 132 * 1.98e9) * 1e3)
    assert 0.047 < ms < 0.048
    # the decrypt: 24,132 rows x 64 limbs, 1,297 products a row of which
    # 1,024 are squarings
    imads = roofline.mont_imads(24_132, 64, 1297, 1024)
    assert imads == 24_132 * (273 * 4 * 64 * 64 + 1024 * (3 * 64 * 64 + 64))
    ms, by = roofline.bound_ms(imads, 0, CARD)
    assert by == "operations" and 24.6 < ms < 24.8
    # a copy is bound by bytes
    assert roofline.bound_ms(1, 3.35e9, CARD) == (pytest.approx(1.0),
                                                  "bytes")


@pytest.mark.parametrize("L", [1, 2, 64, 128])
def test_squaring_forms_each_cross_product_once(L):
    # L (L + 1) / 2 products a_i a_j (i <= j), L^2 products m n_j, each
    # two IMADs; a general product forms 2 L^2
    assert roofline.mont_imads(1, L, 1, 1) == 2 * (L * (L + 1) // 2 + L * L)
    assert roofline.mont_imads(1, L, 1) == 4 * L * L
    assert roofline.mont_imads(3, L, 5, 2) == 3 * (
        3 * 4 * L * L + 2 * roofline.mont_imads(1, L, 1, 1))


def test_ntt_bounds():
    # FemnistCNN's BFV upload: 148 polynomials x 6 primes x 8,192
    # coefficients, 13 stages of 4,096 butterflies and the twist
    products = roofline.ntt_modmuls(148, 6, 8192)
    assert products == 148 * 6 * (4096 * 13 + 8192)
    ms, by = roofline.bound_ms(roofline.MODMUL_INT_OPS * products,
                               2 * 4 * 148 * 6 * 8192, CARD)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 4 * 148 * 6 * 8192 / 3.35e12 * 1e3)
    assert roofline.ntt_modmuls(1, 1, 64) == 6 * 32 + 64


def test_pipes_are_not_added():
    # integer ops and shared-memory loads issue side by side: the bound is
    # the slower pipe's time, not the sum
    ops = CARD.int32_per_s * 1e-3  # 1 ms of integer work
    assert roofline.bound_ms(ops, 0, CARD) == (pytest.approx(1.0),
                                               "operations")
    assert roofline.bound_ms(ops, 0, CARD, lds=CARD.lds_per_s * 0.5e-3) \
        == (pytest.approx(1.0), "operations")
    assert roofline.bound_ms(0, 0, CARD, lds=CARD.lds_per_s * 2e-3) == (
        pytest.approx(2.0), "operations")
    assert CARD.lds_per_s == CARD.int32_per_s / 2


def test_mask_bound_is_its_table_loads():
    # 1,206,590 lanes of 20 bits: 2 x 201,099 AES-256 blocks, 224 table
    # loads a block at 32 a clock an SM
    ms, by = chip_smoke.mask_bound(1_206_590, CARD)
    assert by == "operations"
    loads_ms = 2 * 201_099 * 224 / (32 * 132 * 1.98e9) * 1e3
    assert ms == pytest.approx(loads_ms)
    int_ms = (2 * 201_099 * 348 + 6 * 1_206_590) / CARD.int32_per_s * 1e3
    assert int_ms < ms
    assert 0.0107 < ms < 0.0108


def test_mask_bound_of_the_other_modes():
    # one stream: half the AES of the double mask at the same count
    double, _ = chip_smoke.mask_bound(120_655, CARD)
    single, by = chip_smoke.mask_bound(120_655, CARD, streams=1)
    assert by == "operations" and single == pytest.approx(double / 2)
    assert single == pytest.approx(20_110 * 224 / CARD.lds_per_s * 1e3)
    # 120-bit limbs: a block a lane, so 201,099 lanes make the 402,198
    # blocks of the double mask at 1,206,590 lanes of 20 bits
    limbs, by = chip_smoke.mask_bound(201_099, CARD, m=120)
    assert by == "operations"
    assert limbs == pytest.approx(chip_smoke.mask_bound(1_206_590, CARD)[0])
    # the scatter: 8-byte locations and 32-byte sectors read and written
    ms, by = chip_smoke.mask_bound(120_655, CARD, streams=1, sectors=86_000)
    assert by == "bytes"
    assert ms == pytest.approx((8 * 120_655 + 64 * 86_000) / 3.35e12 * 1e3)
    assert roofline.lane_ops(2) == 6 and roofline.lane_ops(1) == 4


@pytest.mark.parametrize("m, want", [
    (20, (191, 193, 811_007, 811_009)), (32, (127, 129, 540_671, 540_673)),
    (1, (4095, 4097, 17_301_503, 17_301_505))])
def test_mask_grid_counts_straddle_a_span_and_a_pass(m, want):
    # a warp's span of 32 counter blocks and a pass of 132 x 1,024, in lanes
    counts = chip_smoke.grid_counts(m, 32, 135_168)
    assert counts[:len(chip_smoke.GRID_COUNTS)] == chip_smoke.GRID_COUNTS
    assert counts[len(chip_smoke.GRID_COUNTS):] == want
    assert any(c % (128 // m) for c in counts)


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN43_INTERNAL_x_mont_mul15mont_exp_kernelILi16ELi4EEEvPKjPKiS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN43_INTERNAL_x_mont_mul15mont_exp_kernelILi16ELi4EEEvPKjPKiS2_
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mont_mul_kernelILi4EEEvPKjS2_S2_jPjli' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115mont_mul_kernelILi4EEEvPKjS2_S2_jPjli
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 44 registers, used 0 barriers
"""


def test_ptxas_usage():
    assert _build.ptxas_usage(_PTXAS) == [("mont_exp_kernel<16,4>", 56, 8, 4),
                                          ("mont_mul_kernel<4>", 44, 0, 0)]


@pytest.mark.parametrize("mangled, want", [
    ("_ZN12_GLOBAL__N_119mont_mul_vec_kernelILi16ELi8EEEvPKjS2_S2_S2_Pjli",
     "mont_mul_vec_kernel<16,8>"),
    ("_ZN12_GLOBAL__N_118flashe_mask_kernelEPKjPjli", "flashe_mask_kernel"),
    ("_Z3foov", "_Z3foov")])
def test_kernel_names(mangled, want):
    assert _build._kernel_name(mangled) == want


_SASS = """\
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118flashe_mask_kernelEPKjPjlPKiS1_jjjimlj
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                                 /* 0x000e220000000800 */
        /*0010*/                   S2R R3, SR_TID.X ;                           /* 0x0000000000037919 */
        /*0d90*/                   LDS R36, [R36] ;                             /* 0x0000000024247984 */
        /*0fb0*/                   LDS.128 R16, [R6+0x10020] ;                  /* 0x0100200006107984 */
        /*10e0*/                   PRMT R26, R6.reuse, 0x7614, R26 ;            /* 0x00000001061a7824 */
        /*04d0*/              @!P1 LDG.E.CONSTANT R0, desc[UR6][R4.64+0xc] ;    /* 0x00000c0604009981 */
        /*0500*/               @P0 BRA 0x120 ;                                  /* 0x00000c0604009981 */
        /*0510*/              @UP0 UMOV UR4, 0x400 ;                            /* 0x00000c0604009981 */
\t\tFunction : _ZN12_GLOBAL__N_115mont_mul_kernelILi8ELi2EEEvPKjS2_S2_jPjli
        /*0000*/                   IMAD.WIDE.U32.X R4, R5, 0x4, R6 ;            /* 0x0000000405047825 */
"""


def test_count_sass():
    got = _build.count_sass(_SASS)
    assert got == {
        "flashe_mask_kernel": {"LDC": 1, "S2R": 1, "LDS": 2, "PRMT": 1,
                               "LDG": 1, "BRA": 1, "UMOV": 1},
        "mont_mul_kernel<8,2>": {"IMAD": 1}}
    assert _build.count_sass("") == {}


@pytest.mark.parametrize("L", [0, montgomery.MAX_LIMBS + 1])
def test_layout_refuses_limb_counts_before_building(L):
    with pytest.raises(ValueError):
        montgomery.layout(L)


_STUB_BUILD = r"""
import sys, time
from pathlib import Path
from flashe_tpu_torch.ops import _build

root = Path(sys.argv[1])
_build.build_dir = lambda: root


def stub_compile(src, lib, extra_flags=()):
    with open(root / "compiles", "a") as f:
        f.write(f"{src.name}\n")
    time.sleep(1.0)  # long enough for the other process to ask meanwhile
    lib.write_bytes(b"built")
    return "log"


_build.compile_so = stub_compile
_build.ctypes.CDLL = lambda path: path
print(_build.load("flashe_mask"))
"""


def test_build_is_one_compile_across_processes(tmp_path):
    """Two processes asking at once for a missing library: one compiles
    (a stub here: no nvcc on the CPU) under the build directory's flock,
    the other waits and loads the same file."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _STUB_BUILD,
                               str(tmp_path)], cwd=repo,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert (tmp_path / "compiles").read_text() == "flashe_mask.cu\n"
    assert outs[0] == outs[1] and outs[0].endswith(".so")
    lib = tmp_path / os.path.basename(outs[0])
    assert lib.read_bytes() == b"built"
    assert lib.with_suffix(".log").read_text() == "log"
