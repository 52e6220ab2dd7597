"""PyTorch port: the networked storage node (csrc/kvserver.cpp +
flashe_tpu_torch/data/remote_kv.py), as tests/test_remote_kv.py holds the
JAX package's, against both the native C++ server and the pure-python
fallback; plus:

- the wire protocol and the on-disk format shared with the JAX package's
  node (a JAX client on the port's node, a directory the JAX node wrote);
- the egg processor either server spawns is the port's module;
- two repairs of ADVICE.md (round 5) findings, which diverge from the JAX
  package: every op but EXEC times out on a node that never answers
  (`remote_kv.py:205`), and a PUT pipeline that fails to drain drops its
  connection, so that the next call does not read a stale PUT status
  (`remote_kv.py:363`).
"""

import socket
import struct
import threading

import pytest

from flashe_tpu.data.remote_kv import RemoteKVStore as JRemoteKVStore
from flashe_tpu.data.remote_kv import StorageNode as JStorageNode
from flashe_tpu_torch import native
from flashe_tpu_torch.data import remote_kv
from flashe_tpu_torch.data import table as table_mod
from flashe_tpu_torch.data.remote_kv import (RemoteKVStore, StorageNode,
                                             StorageNodeUnavailable)
from flashe_tpu_torch.ops._build import build_dir


def _need_native(use_native):
    if use_native and native.kvserver_binary() is None:
        pytest.skip(f"no compiler for the native kvserver: "
                    f"{native.last_error('kvserver')}")


@pytest.mark.parametrize("use_native", [False, True])
def test_remote_store_roundtrip(tmp_path, use_native):
    _need_native(use_native)
    node = StorageNode(str(tmp_path), native=use_native)
    assert node.native == use_native
    try:
        st = RemoteKVStore(node.address, "ns", "t1", nparts=4)
        assert st.nparts == 4
        st.put(0, b"a", b"1")
        st.put(3, b"b", b"x" * 100_000)  # large value
        st.put(0, b"c", b"")
        assert st.get(0, b"a") == b"1"
        assert st.get(3, b"b") == b"x" * 100_000
        assert st.get(0, b"c") == b""
        assert st.get(0, b"missing") is None
        assert st.count(0) == 2
        assert st.delete(0, b"a")
        assert not st.delete(0, b"a")
        assert st.get(0, b"a") is None
        items = dict(st.items(3))
        assert items == {b"b": b"x" * 100_000}
        st.flush()

        # a second client sees the same data (shared server state)
        st2 = RemoteKVStore(node.address, "ns", "t1", nparts=4)
        assert st2.get(3, b"b") == b"x" * 100_000
        # partition count pinned on disk: requesting a different count
        # on reopen keeps the original
        st3 = RemoteKVStore(node.address, "ns", "t1", nparts=9)
        assert st3.nparts == 4
        st.close(); st2.close(); st3.close()
    finally:
        node.shutdown()


@pytest.mark.parametrize("use_native", [False, True])
def test_remote_session_tables_survive_node_restart(tmp_path, use_native):
    _need_native(use_native)
    node = StorageNode(str(tmp_path), native=use_native)
    try:
        s = table_mod.init("job", storage_addr=node.address)
        t = s.table("weights", "fed", partition=3)
        t.put_all([(f"k{i}", {"v": i}) for i in range(50)])
        assert t.count() == 50
        assert t.get("k7") == {"v": 7}
        s.stop()
    finally:
        node.shutdown()

    # a NEW node over the same directory serves the persisted tables
    node2 = StorageNode(str(tmp_path), native=use_native)
    try:
        s2 = table_mod.init("job2", storage_addr=node2.address)
        t2 = s2.table("weights", "fed", partition=1)  # wrong count: pinned
        assert t2.count() == 50
        got = dict(t2.collect())
        assert got["k13"] == {"v": 13}
        s2.stop()
    finally:
        node2.shutdown()


def test_native_and_python_servers_share_format(tmp_path):
    """Data written through the python server is served by the native
    server (and vice versa) — one on-disk format."""
    _need_native(True)
    node = StorageNode(str(tmp_path), native=False)
    st = RemoteKVStore(node.address, "x", "t", nparts=2)
    st.put(1, b"k", b"v1")
    st.flush(); st.close()
    node.shutdown()

    node2 = StorageNode(str(tmp_path), native=True)
    try:
        st2 = RemoteKVStore(node2.address, "x", "t", nparts=2)
        assert st2.get(1, b"k") == b"v1"
        st2.put(0, b"k2", b"v2")
        st2.flush(); st2.close()
    finally:
        node2.shutdown()

    node3 = StorageNode(str(tmp_path), native=False)
    try:
        st3 = RemoteKVStore(node3.address, "x", "t", nparts=2)
        assert st3.get(0, b"k2") == b"v2"
        st3.close()
    finally:
        node3.shutdown()


def test_native_server_builds_in_the_ports_build_dir():
    _need_native(True)
    assert native.kvserver_binary() == str(build_dir() / "kvserver")


@pytest.mark.parametrize("use_native", [False, True])
def test_wire_and_disk_shared_with_the_jax_package(tmp_path, use_native):
    """The JAX client talks to the port's node, and the port's node serves
    a directory the JAX node wrote (the same protocol, the same files)."""
    _need_native(use_native)
    jnode = JStorageNode(str(tmp_path), native=False)
    try:
        js = JRemoteKVStore(jnode.address, "ns", "t", nparts=3)
        js.put(2, b"jax", b"wrote")
        js.flush(); js.close()
    finally:
        jnode.shutdown()
    node = StorageNode(str(tmp_path), native=use_native)
    try:
        st = RemoteKVStore(node.address, "ns", "t", nparts=1)
        assert st.nparts == 3 and st.get(2, b"jax") == b"wrote"
        st.close()
        js = JRemoteKVStore(node.address, "ns", "t")
        js.put(0, b"from", b"jax client")
        assert js.get(2, b"jax") == b"wrote"
        js.close()
        st = RemoteKVStore(node.address, "ns", "t")
        assert st.get(0, b"from") == b"jax client"
        st.close()
    finally:
        node.shutdown()


@pytest.mark.parametrize("use_native", [False, True])
def test_egg_processor_is_the_ports(tmp_path, use_native):
    """Either server spawns the port's egg (`-m flashe_tpu_torch.data.egg`,
    hardcoded in csrc/kvserver.cpp and remote_kv.EGG_MODULE), never the
    JAX package's."""
    _need_native(use_native)
    assert remote_kv.EGG_MODULE == "flashe_tpu_torch.data.egg"
    node = StorageNode(str(tmp_path), native=use_native)
    try:
        s = table_mod.init("egg", storage_addr=node.address)
        t = s.table("t", "ns", partition=2)
        t.put_all((i, i) for i in range(4))
        # the file the egg's `python -m` ran, read inside the egg
        ran = {v for _, v in t.mapPartitions(
            lambda it: __import__("sys").argv[0]).collect()}
        assert len(ran) == 1
        path = ran.pop().replace("\\", "/")
        assert path.endswith("/flashe_tpu_torch/data/egg.py"), path
        s.stop()
    finally:
        node.shutdown()


def test_silent_node_times_out(monkeypatch):
    """ADVICE.md, remote_kv.py:205: a node that accepts but never answers
    makes a KV op fail within OP_TIMEOUT_S a try (the JAX client waits for
    ever)."""
    monkeypatch.setattr(remote_kv, "OP_TIMEOUT_S", 0.2)
    monkeypatch.setattr(remote_kv, "_RETRY_BACKOFF", (0.01,))
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(8)  # connects complete in the backlog, nothing answers
    addr = f"127.0.0.1:{silent.getsockname()[1]}"
    raised = []

    def open_table():
        try:
            RemoteKVStore(addr, "ns", "t")
        except BaseException as e:
            raised.append(e)

    th = threading.Thread(target=open_table, daemon=True)
    th.start()
    th.join(20)
    silent.close()
    assert not th.is_alive(), "a KV op waited on a silent node for ever"
    assert len(raised) == 1
    assert isinstance(raised[0], StorageNodeUnavailable)


def test_failed_put_pipeline_drops_its_connection(tmp_path, monkeypatch):
    """ADVICE.md, remote_kv.py:363: when a drain meets a failed PUT status,
    the in-flight statuses behind it are not left on the connection for the
    next call to read as its own response."""
    node = StorageNode(str(tmp_path), native=False)
    try:
        st = RemoteKVStore(node.address, "ns", "t", nparts=1)
        st.put(0, b"key", b"value")
        pipe = st.pipeline()
        for i in range(3):
            pipe.put(0, b"p%d" % i, b"v")
        real = remote_kv._read_full
        frames = []

        def failing_first(sock, n):
            got = real(sock, n)
            if n == 9 and not frames:
                frames.append(got)
                return struct.pack("<BQ", 2, 0)  # the first PUT failed
            return got

        monkeypatch.setattr(remote_kv, "_read_full", failing_first)
        with pytest.raises(OSError, match="kv_put failed"):
            pipe.drain()
        monkeypatch.setattr(remote_kv, "_read_full", real)
        assert pipe._outstanding == 0
        assert st._sock is None
        assert st.get(0, b"key") == b"value"
        assert st.count(0) == 4
        st.close()
    finally:
        node.shutdown()
