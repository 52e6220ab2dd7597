"""PyTorch port: the native layer (flashe_tpu_torch/native.py,
csrc/packing.cpp and csrc/fedbroker.cpp) on the CPU, which takes g++.

- The native packer is byte-equal to the port's numpy path and to the JAX
  package's `pack_lanes` for in-range lanes, at int_bits 1 to 120 and 0 to
  101 lanes; unpack gives the lanes back, as limbs above 32 bits.
- Lanes with bits at or above int_bits: the port's native packer still
  equals its numpy path (the repaired fault; see the test's docstring).
- ops/pack.py goes through the native packer; encode_locations gives the
  JAX package's bytes.
- The broker and the packer build under build/flashe_tpu_torch/, never
  under the JAX package's native/.
- FedBroker(native=True) spawns the binary and close() reaps it; it raises
  where the binary cannot be built or started, and "auto" then falls back
  to the Python broker.
- `python -m flashe_tpu_torch broker` runs the native broker, `broker
  --python` the Python one; SIGTERM ends either with no broker process
  left, and a native broker ends with its owner even when the owner is
  killed.
- A frame over the broker's 64 MB limit fails its sender, and the native
  broker drops a connection that announces one.
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from flashe_tpu import native as jnative
from flashe_tpu.ops import pack as jpack
from flashe_tpu.protocol import sparsify as jsparsify
from flashe_tpu_torch import native
from flashe_tpu_torch.fed import tcp
from flashe_tpu_torch.fed.consts import ARBITER
from flashe_tpu_torch.fed.tcp import FedBroker, TcpFederation
from flashe_tpu_torch.fed.transport import default_parties
from flashe_tpu_torch.fed.variables import HomoTransferVariables
from flashe_tpu_torch.ops import pack
from flashe_tpu_torch.ops._build import build_dir
from flashe_tpu_torch.protocol import sparsify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUTH = HomoTransferVariables.authorization()


@pytest.fixture(scope="module")
def packer():
    if not native.available():
        pytest.skip(f"no compiler for the packer: "
                    f"{native.last_error('packing')}")


@pytest.fixture(scope="module")
def broker_bin():
    path = native.broker_binary()
    if path is None:
        pytest.skip(f"no compiler for the broker: "
                    f"{native.last_error('fedbroker')}")
    return path


def _lanes(rng, n, int_bits, in_range=True):
    """n random elements of int_bits: (n,) uint32 or (n, L) limbs; with
    in_range False every limb is a full random 32-bit word."""
    nl = (int_bits + 31) // 32
    x = rng.integers(0, 1 << 32, size=(n, nl), dtype=np.uint64).astype(
        np.uint32)
    top = int_bits - 32 * (nl - 1)
    if in_range and top < 32:
        x[:, -1] &= np.uint32((1 << top) - 1)
    return x if nl > 1 else x.reshape(-1)


@pytest.mark.parametrize("n", [0, 1, 7, 101])
@pytest.mark.parametrize("int_bits", [1, 16, 20, 21, 27, 32, 64, 120])
def test_native_pack_equals_numpy_and_jax(packer, int_bits, n):
    x = _lanes(np.random.default_rng(int_bits * 1000 + n), n, int_bits)
    got = native.pack_lanes(x, int_bits)
    assert got == pack.pack_lanes_np(x, int_bits)
    assert got == jpack.pack_lanes(x, int_bits)
    assert len(got) == pack.packed_nbytes(n, int_bits)
    back = native.unpack_lanes(got, n, int_bits)
    assert back.dtype == np.uint32 and back.shape == x.shape
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(back, pack.unpack_lanes_np(got, n,
                                                             int_bits))
    # the port's int32 carrier is read as its bit patterns
    assert native.pack_lanes(x.view(np.int32), int_bits) == got


@pytest.mark.parametrize("int_bits", [16, 20, 21, 27])
def test_out_of_range_lanes_are_masked_as_numpy_masks_them(packer, int_bits):
    """Lanes with bits at or above int_bits: the port's native packer packs
    their low int_bits bits, as its numpy path does.  The JAX package's
    native fast path (native/packing.cpp:33) ORs each lane into its
    accumulator unmasked, so there the high bits land in the lanes packed
    before it and its bytes differ from its own numpy path's (where
    int_bits is no multiple of 8: otherwise the high bits never reach an
    output byte); the port's copy masks each lane first."""
    for n in (1, 3, 7, 101):
        x = _lanes(np.random.default_rng(n), n, int_bits, in_range=False)
        masked = x & np.uint32((1 << int_bits) - 1)
        got = native.pack_lanes(x, int_bits)
        assert got == pack.pack_lanes_np(x, int_bits)
        assert got == pack.pack_lanes_np(masked, int_bits)
        np.testing.assert_array_equal(native.unpack_lanes(got, n, int_bits),
                                      masked)
    if int_bits % 8 and jnative.available():
        x = _lanes(np.random.default_rng(101), 101, int_bits, in_range=False)
        assert jnative.pack_lanes(x, int_bits) != native.pack_lanes(
            x, int_bits)


def test_native_wrappers_refuse_what_numpy_cannot_read(packer):
    with pytest.raises(ValueError, match="limbs"):
        native.pack_lanes(np.zeros(5, np.uint32), 64)
    with pytest.raises(ValueError, match="bytes"):
        native.unpack_lanes(b"\x00" * 4, 2, 20)
    # leading bytes are skipped as numpy's unpack skips them
    data = pack.pack_lanes_np(np.arange(9, dtype=np.uint32), 20)
    np.testing.assert_array_equal(native.unpack_lanes(b"\xff" + data, 9, 20),
                                  np.arange(9))


def test_ops_pack_goes_through_native(packer):
    x = _lanes(np.random.default_rng(3), 333, 20)
    before = dict(native.calls)
    data = pack.pack_lanes(x, 20)
    np.testing.assert_array_equal(pack.unpack_lanes(data, 333, 20), x)
    assert native.calls == {"pack": before["pack"] + 1,
                            "unpack": before["unpack"] + 1}


@pytest.mark.parametrize("total", [37, 1_206_590])
def test_encode_locations_through_native_matches_jax(packer, total):
    rng = np.random.default_rng(total)
    locs = np.sort(rng.choice(total, size=min(total, 1000), replace=False))
    before = native.calls["pack"]
    got = sparsify.encode_locations(torch.from_numpy(locs), total)
    assert native.calls["pack"] == before + 1
    assert got == jsparsify.encode_locations(locs, total)
    np.testing.assert_array_equal(sparsify.decode_locations(got), locs)


def test_native_builds_in_the_ports_build_dir(broker_bin, packer):
    lib = native._packer()._name
    for path in (broker_bin, lib):
        assert os.path.dirname(path) == str(build_dir())
        assert not path.startswith(os.path.join(REPO, "native"))
    assert os.access(broker_bin, os.X_OK)
    assert os.path.basename(lib) == "libflashepack.so"


def test_native_broker_spawns_a_child_that_close_reaps(broker_bin):
    broker = FedBroker(native=True)
    assert broker.native and broker._proc.poll() is None
    assert broker._proc.args[0] == broker_bin
    parties = default_parties(n_hosts=1)
    g = TcpFederation(broker.address, "n", parties[0], parties, AUTH)
    a = TcpFederation(broker.address, "n", parties[2], parties, AUTH)
    HomoTransferVariables(g).guest_to_arbiter.remote(obj=7, role=ARBITER,
                                                     idx=0)
    assert HomoTransferVariables(a).guest_to_arbiter.get(idx=0,
                                                         timeout=10) == 7
    g.close()
    a.close()
    broker.close()
    assert broker._proc.returncode is not None
    broker.close()  # a second close is harmless


@pytest.mark.parametrize("failure", ["no build", "no start"])
def test_native_true_raises_where_the_binary_fails(monkeypatch, failure):
    monkeypatch.setattr(native, "broker_binary",
                        (lambda: None) if failure == "no build"
                        else (lambda: "/bin/true"))
    with pytest.raises(RuntimeError, match="native fedbroker unavailable"):
        FedBroker(native=True)
    broker = FedBroker()
    try:
        assert not broker.native and broker._proc is None
    finally:
        broker.close()


def _children(pid):
    """(pid, argv) of the live processes whose parent is pid."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append((int(d), argv))
    return out


def _running(pid) -> bool:
    """Whether pid is a live process (not gone and not a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _gone_within(pid, seconds) -> bool:
    deadline = time.monotonic() + seconds
    while _running(pid):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


@pytest.mark.parametrize("python", [False, True], ids=["native", "python"])
def test_broker_cli_and_sigterm(broker_bin, python):
    """`broker` runs the native broker and `broker --python` the Python
    one, each saying which; parties exchange through it; SIGTERM (what
    `cluster --run-local` sends) ends it with its native child reaped."""
    cmd = [sys.executable, "-m", "flashe_tpu_torch", "broker", "--host",
           "127.0.0.1", "--port", "0"] + (["--python"] if python else [])
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        word, port, kind = proc.stdout.readline().split()
        assert (word, kind) == ("PORT", "python" if python else "native")
        kids = [pid for pid, argv in _children(proc.pid)
                if argv[0] == broker_bin.encode()]
        assert len(kids) == (0 if python else 1)
        parties = default_parties(n_hosts=1)
        addr = ("127.0.0.1", int(port))
        g = TcpFederation(addr, "cli", parties[0], parties, AUTH)
        a = TcpFederation(addr, "cli", parties[2], parties, AUTH)
        HomoTransferVariables(g).guest_to_arbiter.remote(
            obj="via cli", role=ARBITER, idx=0)
        assert HomoTransferVariables(a).guest_to_arbiter.get(
            idx=0, timeout=10) == "via cli"
        g.close()
        a.close()
        proc.terminate()
        assert proc.wait(timeout=20) == 0
        assert not any(_running(pid) for pid in kids)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_native_broker_ends_with_a_killed_owner(broker_bin):
    """The owner of a FedBroker killed outright (no handler runs): its
    native child sees its standard input close and exits."""
    owner = subprocess.Popen(
        [sys.executable, "-c",
         "import time\n"
         "from flashe_tpu_torch.fed.tcp import FedBroker\n"
         "b = FedBroker(native=True)\n"
         "print(b._proc.pid, flush=True)\n"
         "time.sleep(120)\n"],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        child = int(owner.stdout.readline())
        assert _running(child)
    finally:
        owner.kill()
        owner.wait()
    assert _gone_within(child, 10)


def test_frame_over_the_limit_fails_the_sender(broker_bin):
    class Sock:
        def sendall(self, data):
            raise AssertionError("an oversized frame reached the socket")

    with pytest.raises(ValueError, match="exceeds"):
        tcp._send_frame(Sock(), b"\0" * (tcp._MAX_FRAME + 1),
                        threading.Lock())
    # the native broker drops a connection that announces one
    broker = FedBroker(native=True)
    try:
        with socket.create_connection(broker.address, timeout=10) as s:
            hello = tcp._envelope(tcp._REGISTER, "guest", 0)
            s.sendall(struct.pack("!Q", len(hello)) + hello)
            s.sendall(struct.pack("!Q", tcp._MAX_FRAME + 1) + b"\x01")
            try:
                closed = s.recv(1) == b""
            except ConnectionResetError:
                closed = True
            assert closed
    finally:
        broker.close()
