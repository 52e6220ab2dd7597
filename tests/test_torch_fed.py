"""PyTorch port: the federation (flashe_tpu_torch/fed) on the CPU.

The port's counterpart of tests/test_tcp_federation.py: round trip and 4 MB
fragmentation and buffering before registration on its native C++ broker
and on its Python one, authorization, transfer stats.  Then what ties the
port to the JAX package: its AUTH_TABLE is the JAX one key for key, and
port and JAX TCP parties exchange frames through either package's Python
broker and either package's native one, so the envelope and the framing
are the same byte for byte.  Last, the launch counters of the
kernel wrappers stay exact when 8 threads bump them at once.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from flashe_tpu import native as jnative
from flashe_tpu.fed import tcp as jtcp
from flashe_tpu.fed import variables as jvariables
from flashe_tpu.fed.transport import default_parties as jdefault_parties
from flashe_tpu_torch import native
from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.fed.consts import ARBITER, GUEST, HOST
from flashe_tpu_torch.fed.inmem import InMemBroker, InMemFederation
from flashe_tpu_torch.fed.tcp import FedBroker, TcpFederation
from flashe_tpu_torch.fed.transport import (
    FederationAuthorization, Party, TransferStat, default_parties)
from flashe_tpu_torch.fed.variables import AUTH_TABLE, HomoTransferVariables
from flashe_tpu_torch.ops import flashe_mask as fm
from flashe_tpu_torch.ops import montgomery as mg

AUTH = HomoTransferVariables.authorization()


def _run(*fns, timeout=60):
    threads = [threading.Thread(target=f, daemon=True) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()


def _broker(use_native):
    if use_native and native.broker_binary() is None:
        pytest.skip(f"no compiler for the native broker: "
                    f"{native.last_error('fedbroker')}")
    broker = FedBroker(native=use_native)
    assert broker.native == use_native
    assert (broker._proc is not None) == use_native
    return broker


@pytest.mark.parametrize("use_native", [False, True])
def test_tcp_roundtrip_and_fragmentation(use_native):
    broker = _broker(use_native)
    parties = default_parties(n_hosts=1)
    results = {}

    def guest():
        fed = TcpFederation(broker.address, "job", parties[0], parties, AUTH)
        trv = HomoTransferVariables(fed)
        big = np.arange(2_000_000, dtype=np.float64)  # ~16MB -> 4 fragments
        trv.guest_to_arbiter.remote(obj=big, role=ARBITER, idx=0,
                                    suffix=("big",))
        results["guest_got"] = trv.arbiter_to_guest.get(idx=0,
                                                        suffix=("ack",))
        fed.close()

    def host():
        fed = TcpFederation(broker.address, "job", parties[1], parties, AUTH)
        trv = HomoTransferVariables(fed)
        trv.host_to_arbiter.remote(obj={"hello": 1}, role=ARBITER, idx=0,
                                   suffix=("small",))
        fed.close()

    def arbiter():
        fed = TcpFederation(broker.address, "job", parties[2], parties, AUTH)
        trv = HomoTransferVariables(fed)
        big = trv.guest_to_arbiter.get(idx=0, suffix=("big",), timeout=60)
        small = trv.host_to_arbiter.get(idx=-1, suffix=("small",), timeout=60)
        results["big_sum"] = float(big.sum())
        results["small"] = small
        trv.arbiter_to_guest.remote(obj="ok", role=GUEST, idx=0,
                                    suffix=("ack",))
        fed.close()

    _run(guest, host, arbiter)
    broker.close()
    assert results["guest_got"] == "ok"
    assert results["small"] == [{"hello": 1}]
    assert results["big_sum"] == float(np.arange(2_000_000).sum())


@pytest.mark.parametrize("use_native", [False, True])
def test_tcp_buffered_before_registration(use_native):
    """Frames to a party that has not connected yet are held at the
    exchange and flushed when it registers."""
    broker = _broker(use_native)
    parties = default_parties(n_hosts=1)
    guest = TcpFederation(broker.address, "jobB", parties[0], parties, AUTH)
    trv_g = HomoTransferVariables(guest)
    payload = np.arange(1_500_000, dtype=np.float64)  # 12MB -> 3 fragments
    trv_g.guest_to_arbiter.remote(obj=payload, role=ARBITER, idx=0,
                                  suffix=("early",))
    trv_g.guest_to_arbiter.remote(obj="tail", role=ARBITER, idx=0,
                                  suffix=("late",))
    arb = TcpFederation(broker.address, "jobB", parties[2], parties, AUTH)
    trv_a = HomoTransferVariables(arb)
    got = trv_a.guest_to_arbiter.get(idx=0, suffix=("early",), timeout=30)
    assert np.array_equal(got, payload)
    assert trv_a.guest_to_arbiter.get(idx=0, suffix=("late",),
                                      timeout=30) == "tail"
    guest.close()
    arb.close()
    broker.close()


@pytest.mark.parametrize("transport", ["tcp", "inmem"])
def test_authorization_enforced(transport):
    parties = default_parties(n_hosts=1)
    broker = FedBroker() if transport == "tcp" else InMemBroker()
    fed = (TcpFederation(broker.address, "job2", parties[0], parties, AUTH)
           if transport == "tcp"
           else InMemFederation(broker, "job2", parties[0], parties, AUTH))
    trv = HomoTransferVariables(fed)
    try:
        # a guest may not send on an arbiter->host channel, nor read one
        with pytest.raises(PermissionError):
            trv.arbiter_to_host.remote(obj=1, role=HOST, idx=0)
        with pytest.raises(PermissionError):
            fed.get("arbiter_to_host", "t", parties[2], timeout=1)
        with pytest.raises(PermissionError, match="not authorized"):
            fed.remote(1, "no_such_variable", "t", parties[2])
    finally:
        if transport == "tcp":
            fed.close()
            broker.close()


def test_transfer_stats_count_wire_bytes():
    """TransferStat: per-variable message and wire-byte counters on both
    ends of a TCP transfer."""
    broker = FedBroker()
    parties = default_parties(n_hosts=1)
    guest = TcpFederation(broker.address, "jobS", parties[0], parties, AUTH)
    arb = TcpFederation(broker.address, "jobS", parties[2], parties, AUTH)
    trv_g = HomoTransferVariables(guest)
    trv_a = HomoTransferVariables(arb)

    payload = np.zeros(1_000_000)  # 8MB -> 2 fragments
    trv_g.guest_to_arbiter.remote(obj=payload, role=ARBITER, idx=0,
                                  suffix=("s",))
    trv_a.guest_to_arbiter.get(idx=0, suffix=("s",), timeout=30)

    gs = guest.stats.summary()["guest_to_arbiter"]
    assert gs["sent_msgs"] == 1
    assert gs["sent_bytes"] > payload.nbytes  # wire bytes >= payload
    ar = arb.stats.summary()["guest_to_arbiter"]
    assert ar["recv_msgs"] == 1
    assert ar["recv_bytes"] == gs["sent_bytes"]
    assert arb.stats.summary()["__total__"]["recv_msgs"] == 1
    guest.close()
    arb.close()
    broker.close()


def test_transfer_stat_summary_totals():
    st = TransferStat()
    st.count_send("a", 10)
    st.count_recv("b", 3)
    st.add_sent_bytes("a", 5)
    s = st.summary()
    assert s["a"] == {"sent_msgs": 1, "sent_bytes": 15, "recv_msgs": 0,
                      "recv_bytes": 0}
    assert s["__total__"] == {"sent_msgs": 1, "sent_bytes": 15,
                              "recv_msgs": 1, "recv_bytes": 3}


def test_inmem_timeout_and_scoped_namespaces():
    broker = InMemBroker()
    parties = default_parties(n_hosts=1)
    g = InMemFederation(broker, "job", parties[0], parties, AUTH)
    a = InMemFederation(broker, "job", parties[2], parties, AUTH)
    with pytest.raises(TimeoutError):
        a.get("guest_to_arbiter", "x", parties[0], timeout=0.05)
    g.scoped("fold1").remote("one", "guest_to_arbiter", "x", parties[2])
    g.remote("zero", "guest_to_arbiter", "x", parties[2])
    assert a.get("guest_to_arbiter", "x", parties[0], timeout=1) == "zero"
    assert a.scoped("fold1").get("guest_to_arbiter", "x", parties[0],
                                 timeout=1) == "one"
    g.remote("stale", "guest_to_arbiter", "y", parties[2])
    a.clean("guest_to_arbiter", parties[0])
    with pytest.raises(TimeoutError):
        a.get("guest_to_arbiter", "y", parties[0], timeout=0.05)


def test_auth_table_equals_the_jax_one():
    assert AUTH_TABLE == jvariables.AUTH_TABLE
    assert list(AUTH_TABLE) == list(jvariables.AUTH_TABLE)
    assert consts.ROLES == ("guest", "host", "arbiter")
    assert isinstance(AUTH, FederationAuthorization)
    assert ([(p.role, p.party_id) for p in default_parties(3)]
            == [(p.role, p.party_id) for p in jdefault_parties(3)])
    assert str(Party(HOST, 2)) == "host:2"


@pytest.mark.parametrize("broker_side",
                         ["jax", "port", "port_native", "jax_native"])
def test_port_and_jax_parties_share_a_broker(broker_side):
    """A port TcpFederation and a JAX one exchange objects both ways, through
    the JAX package's Python broker and through the port's, and through the
    port's native broker (csrc/fedbroker.cpp) and the JAX package's
    (native/fedbroker.cpp): the envelope, the framing and the fragment
    metadata are the same byte for byte."""
    if broker_side == "jax_native" and jnative.broker_binary() is None:
        pytest.skip("no compiler for the JAX package's native broker")
    broker = {"jax": lambda: jtcp.FedBroker(native=False),
              "port": lambda: FedBroker(native=False),
              "port_native": lambda: _broker(True),
              "jax_native": lambda: jtcp.FedBroker(native=True)}[
                  broker_side]()
    assert (broker._proc is not None) == broker_side.endswith("native")
    jparties = jdefault_parties(1)
    pparties = default_parties(1)
    port_guest = TcpFederation(broker.address, "wire", pparties[0], pparties,
                               AUTH)
    jax_arb = jtcp.TcpFederation(broker.address, "wire", jparties[2],
                                 jparties,
                                 jvariables.HomoTransferVariables.authorization())
    ptrv = HomoTransferVariables(port_guest)
    jtrv = jvariables.HomoTransferVariables(jax_arb)
    big = np.arange(600_000, dtype=np.float64)  # 4.8MB -> 2 fragments
    ptrv.guest_to_arbiter.remote(obj={"lanes": big, "n": 3}, role=ARBITER,
                                 idx=0, suffix=(0, "upload_model", 0))
    got = jtrv.guest_to_arbiter.get(idx=0, suffix=(0, "upload_model", 0),
                                    timeout=30)
    assert got["n"] == 3 and np.array_equal(got["lanes"], big)
    jtrv.arbiter_to_guest.remote(obj=("finish", 7), role="guest", idx=0,
                                 suffix=(0, "agg_model", 0))
    assert ptrv.arbiter_to_guest.get(idx=0, suffix=(0, "agg_model", 0),
                                     timeout=30) == ("finish", 7)
    # the wire bytes each side counts agree
    assert (port_guest.stats.summary()["guest_to_arbiter"]["sent_bytes"]
            == jax_arb.stats.summary()["guest_to_arbiter"]["recv_bytes"])
    port_guest.close()
    jax_arb.close()
    broker.close()


def test_envelope_matches_the_jax_one():
    from flashe_tpu_torch.fed import tcp as ptcp
    for op, role, pid, body in [(0, "guest", 0, b""),
                                (1, "arbiter", 0, b"\x00\x01"),
                                (1, "host", 2**31 - 1, b"x" * 9)]:
        frame = ptcp._envelope(op, role, pid, body)
        assert frame == jtcp._envelope(op, role, pid, body)
        assert ptcp._parse_envelope(frame) == jtcp._parse_envelope(frame)


def test_launch_counters_are_exact_under_8_threads(monkeypatch):
    """The roles of a federated round bump the kernel wrappers' launch
    counters from threads of one process: each count is taken under a
    lock, so none is lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    monkeypatch.setattr(fm, "launches", 0)
    monkeypatch.setattr(fm, "mode_launches", dict.fromkeys(fm.MODES, 0))
    monkeypatch.setattr(mg, "launches", dict.fromkeys(mg.launches, 0))
    n = 5000
    try:
        def bump():
            for i in range(n):
                fm._count(fm.MODES[i % 4])
                mg._count("mont_mul")
        _run(*[bump] * 8)
    finally:
        sys.setswitchinterval(old)
    assert fm.launches == 8 * n
    assert fm.mode_launches == dict.fromkeys(fm.MODES, 2 * n)
    assert mg.launches["mont_mul"] == 8 * n
