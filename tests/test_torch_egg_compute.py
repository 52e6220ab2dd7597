"""PyTorch port: server-side DTable compute (the eggroll roll/egg
analogue; flashe_tpu_torch/data/{table,egg,remote_kv}.py over
csrc/kvserver.cpp), as tests/test_egg_compute.py holds the JAX package's.

The reference executes table ops inside the eggroll cluster, near the
data (arch/api/table/table.py:25-179 backed by remote execution;
processors colocated with the storage service).  These tests prove the
same here: map/reduce jobs sent to a storage node run in an egg
processor spawned by the *node* (different PID than the client), the
client never streams the source records (its wire-op counter shows no
ITER/GET during the job), shuffle output lands on the node that owns
each output partition, and a session can span two nodes.  Beside those:

- ADVICE.md (round 5), `remote_kv.py:153` with `kvserver.cpp:282`,
  repaired in the port: a job whose egg dies after it took the spec runs
  once, on either server, and fails (the JAX package runs it again).
"""

import operator
import os
import threading

import pytest

from flashe_tpu_torch.data import table as table_mod
from flashe_tpu_torch.data.remote_kv import (_EXEC, _GET, _ITER, StorageNode,
                                       StorageNodeUnavailable)


@pytest.fixture()
def py_node(tmp_path):
    node = StorageNode(str(tmp_path / "node0"), native=False)
    yield node
    node.close()


def _fill(t, n=50):
    t.put_all((i, i + 1) for i in range(n))
    return {i: i + 1 for i in range(n)}


def test_map_reduce_run_in_the_node_not_the_client(py_node):
    s = table_mod.init("egg_job", storage_addr=py_node.address)
    t = s.table("t_src", "ns", partition=4)
    _fill(t)
    store = s._stores[("ns", "t_src")]

    before = dict(store.op_counts)
    doubled = t.mapValues(lambda v: v * 2)
    total = t.reduce(lambda a, b: a + b)
    after = dict(store.op_counts)

    # the client issued EXECs but never pulled the records itself
    assert after.get(_EXEC, 0) >= before.get(_EXEC, 0) + 2
    assert after.get(_ITER, 0) == before.get(_ITER, 0)
    assert after.get(_GET, 0) == before.get(_GET, 0)

    # the job actually ran in another process (the egg, node-side)
    results = t._exec_fanout("reduce", lambda a, b: a + b, {})
    assert all(r["pid"] != os.getpid() for r in results)
    assert sum(r["records_in"] for r in results) == 50

    assert total == sum(range(1, 51))
    assert dict(doubled.collect()) == {i: 2 * (i + 1) for i in range(50)}
    s.stop()


def test_map_filter_flatmap_mappartitions_server_side(py_node):
    s = table_mod.init("egg_job2", storage_addr=py_node.address)
    t = s.table("t2", "ns", partition=3)
    _fill(t, 30)

    rekeyed = t.map(lambda k, v: (k + 100, v))
    assert dict(rekeyed.collect()) == {i + 100: i + 1 for i in range(30)}

    odd = t.filter(lambda k, v: v % 2 == 1)
    assert dict(odd.collect()) == {i: i + 1 for i in range(30) if (i + 1) % 2}

    fm = t.flatMap(lambda k, v: [(k, v), (k + 1000, -v)])
    assert fm.count() == 60

    per_part = t.mapPartitions(lambda it: sum(v for _, v in it))
    got = dict(per_part.collect())
    assert set(got) == {0, 1, 2}
    assert sum(got.values()) == sum(range(1, 31))
    s.stop()


def test_native_node_exec(tmp_path):
    from flashe_tpu_torch.native import kvserver_binary

    if kvserver_binary() is None:
        pytest.skip("no compiler for the native storage node")
    node = StorageNode(str(tmp_path / "nativenode"), native=True)
    assert node.native
    try:
        s = table_mod.init("egg_native", storage_addr=node.address)
        t = s.table("t", "ns", partition=2)
        _fill(t, 20)
        assert t.reduce(lambda a, b: a + b) == sum(range(1, 21))
        doubled = t.mapValues(lambda v: v * 2)
        assert dict(doubled.collect()) == {i: 2 * (i + 1) for i in range(20)}
        results = t._exec_fanout("reduce", lambda a, b: a + b, {})
        assert all(r["pid"] != os.getpid() for r in results)
        # the C++ node keeps a resident egg pool too: PIDs repeat
        again = t._exec_fanout("reduce", lambda a, b: a + b, {})
        assert {r["pid"] for r in results} & {r["pid"] for r in again}
        # co-partitioned binary op through the C++ node's EXEC too
        u = s.table("u", "ns", partition=2)
        u.put_all((i, -i) for i in range(10, 30))
        joined = t.join(u, lambda a, b: a + b)
        assert dict(joined.collect()) == {i: i + 1 - i
                                          for i in range(10, 20)}
        s.stop()
    finally:
        node.shutdown()


def test_two_node_session_partition_pinning_and_shuffle(tmp_path):
    n0 = StorageNode(str(tmp_path / "n0"), native=False)
    n1 = StorageNode(str(tmp_path / "n1"), native=False)
    try:
        s = table_mod.init("egg_2node",
                           storage_addr=f"{n0.address},{n1.address}")
        t = s.table("t", "ns", partition=4)
        expect = _fill(t, 100)
        t.flush()

        # partition p lives on node p % 2: both roots hold table data
        assert os.path.isdir(os.path.join(n0.root_dir, "ns", "t"))
        assert os.path.isdir(os.path.join(n1.root_dir, "ns", "t"))
        store = s._stores[("ns", "t")]
        groups = store.exec_groups(4)
        assert [parts for _, parts in groups] == [[0, 2], [1, 3]]

        # server-side ops across both nodes, including a re-keying map
        # whose shuffle crosses nodes
        assert t.reduce(lambda a, b: a + b) == sum(expect.values())
        shifted = t.map(lambda k, v: (k + 1, v))
        assert dict(shifted.collect()) == {k + 1: v for k, v in
                                           expect.items()}
        # each node's egg saw only its slice of the source
        results = t._exec_fanout("reduce", lambda a, b: a + b, {})
        assert len(results) == 2
        assert sum(r["records_in"] for r in results) == 100
        assert all(0 < r["records_in"] < 100 for r in results)
        s.stop()
    finally:
        n0.close()
        n1.close()


def test_dead_node_raises_typed_error(tmp_path):
    node = StorageNode(str(tmp_path / "dying"), native=False)
    s = table_mod.init("egg_dead", storage_addr=node.address)
    t = s.table("t", "ns", partition=2)
    _fill(t, 10)
    assert t.count() == 10
    node.close()  # node goes away for good
    with pytest.raises(StorageNodeUnavailable):
        t.count()
    with pytest.raises(StorageNodeUnavailable):
        list(t.collect())
    s.stop()


def test_two_concurrent_writers_keep_counts(py_node):
    # two client sessions (separate connections) hammer the same table;
    # the per-store lock in the node keeps the log/index consistent
    s1 = table_mod.init("w1", storage_addr=py_node.address)
    s2 = table_mod.init("w2", storage_addr=py_node.address)
    t1 = s1.table("shared", "ns", partition=2)
    t2 = s2.table("shared", "ns", partition=2)

    def write(t, base):
        for i in range(200):
            t.put(base + i, i)

    th1 = threading.Thread(target=write, args=(t1, 0))
    th2 = threading.Thread(target=write, args=(t2, 10_000))
    th1.start()
    th2.start()
    th1.join()
    th2.join()
    assert t1.count() == 400
    assert t1.get(10_199) == 199
    assert t2.get(199) == 199
    s1.stop()
    s2.stop()


def test_native_launch_falls_back_to_python(tmp_path, monkeypatch):
    # a broken native binary (bad handshake) must not kill the node:
    # the launcher falls back to the python server, per its contract
    import flashe_tpu_torch.native as native_mod

    monkeypatch.setattr(native_mod, "kvserver_binary",
                        lambda: "/bin/echo")
    node = StorageNode(str(tmp_path / "fallback"), native=True)
    try:
        assert not node.native
        s = table_mod.init("fb", storage_addr=node.address)
        t = s.table("t", "ns", partition=1)
        t.put("k", 42)
        assert t.get("k") == 42
        s.stop()
    finally:
        node.close()


def test_binary_ops_server_side(py_node):
    """Co-partitioned join/union/subtractByKey run in the egg, not the
    client (no ITER/GET from the client during the job)."""
    s = table_mod.init("egg_bin", storage_addr=py_node.address)
    a = s.table("bin_a", "ns", partition=4)
    b = s.table("bin_b", "ns", partition=4)
    a.put_all((i, i) for i in range(40))          # keys 0..39
    b.put_all((i, 100 + i) for i in range(20, 60))  # keys 20..59
    store = s._stores[("ns", "bin_a")]

    before = dict(store.op_counts)
    joined = a.join(b, lambda va, vb: va + vb)
    merged = a.union(b, lambda va, vb: va)  # a wins on collision
    only_a = a.subtractByKey(b)
    after = dict(store.op_counts)
    assert after.get(_ITER, 0) == before.get(_ITER, 0)
    assert after.get(_GET, 0) == before.get(_GET, 0)

    assert dict(joined.collect()) == {i: i + 100 + i
                                      for i in range(20, 40)}
    want_union = {i: i for i in range(40)}
    want_union.update({i: 100 + i for i in range(40, 60)})
    assert dict(merged.collect()) == want_union
    assert dict(only_a.collect()) == {i: i for i in range(20)}

    # mismatched partition counts fall back to the client-side path
    c = s.table("bin_c", "ns", partition=2)
    c.put_all((i, -1) for i in range(5))
    assert dict(a.join(c, lambda x, y: y).collect()) == {
        i: -1 for i in range(5)}
    s.stop()


def test_binary_ops_two_nodes(tmp_path):
    """Binary ops over a 2-node session: each egg joins only its local
    partition slice of both tables."""
    n0 = StorageNode(str(tmp_path / "b0"), native=False)
    n1 = StorageNode(str(tmp_path / "b1"), native=False)
    try:
        s = table_mod.init("egg_bin2",
                           storage_addr=f"{n0.address},{n1.address}")
        a = s.table("a", "ns", partition=4)
        b = s.table("b", "ns", partition=4)
        a.put_all((i, i) for i in range(50))
        b.put_all((i, 2 * i) for i in range(25, 75))
        got = a.join(b, lambda va, vb: (va, vb))
        assert dict(got.collect()) == {i: (i, 2 * i)
                                       for i in range(25, 50)}
        s.stop()
    finally:
        n0.close()
        n1.close()


def test_glom_and_sample_server_side(py_node):
    s = table_mod.init("egg_gs", storage_addr=py_node.address)
    t = s.table("gs", "ns", partition=3)
    _fill(t, 30)
    store = s._stores[("ns", "gs")]

    before = dict(store.op_counts)
    glommed = dict(t.glom().collect())
    sampled = dict(t.sample(0.5, seed=7).collect())
    after = dict(store.op_counts)
    assert after.get(_ITER, 0) == before.get(_ITER, 0)

    assert set(glommed) == {0, 1, 2}
    assert sorted(kv for part in glommed.values() for kv in part) == [
        (i, i + 1) for i in range(30)]
    # sampled subset of the source, deterministic for a fixed seed
    assert all(sampled[k] == k + 1 for k in sampled)
    assert 0 < len(sampled) < 30
    assert dict(t.sample(0.5, seed=7).collect()) == sampled
    s.stop()


def test_egg_pool_reuses_and_recovers(py_node):
    """The python node keeps resident egg workers (data/egg.py --loop):
    consecutive jobs reuse a processor PID instead of forking a fresh
    interpreter per EXEC, and a killed worker is respawned with the job
    retried transparently."""
    import signal

    s = table_mod.init("egg_pool", storage_addr=py_node.address)
    t = s.table("pool_t", "ns", partition=2)
    _fill(t, 20)

    pids1 = {r["pid"] for r in t._exec_fanout(
        "reduce", lambda a, b: a + b, {})}
    pids2 = {r["pid"] for r in t._exec_fanout(
        "reduce", lambda a, b: a + b, {})}
    assert pids1 and pids1 & pids2  # a worker was reused
    assert os.getpid() not in pids1

    # kill the resident workers (exact PIDs); the pool must respawn.  The
    # port retries a job only when its spec could not be written, so the
    # workers are waited for: a worker killed but not yet gone could take
    # the spec before it dies, and that job fails rather than run twice
    # (test_exec_not_replayed_after_the_job_started)
    pool = py_node._egg_pool
    assert pool is not None
    for p in pool._procs:
        if p is not None:
            os.kill(p.pid, signal.SIGKILL)
            p.wait()
    assert t.reduce(lambda a, b: a + b) == sum(range(1, 21))
    pids3 = {r["pid"] for r in t._exec_fanout(
        "reduce", lambda a, b: a + b, {})}
    assert pids3.isdisjoint(pids1)
    s.stop()


@pytest.mark.parametrize("use_native", [False, True])
def test_exec_not_replayed_after_the_job_started(tmp_path, use_native):
    """A worker that dies after it took the spec may have started the job
    (and written shuffle output): the node fails the EXEC and never runs
    the job a second time, with the native and the python server alike."""
    if use_native:
        from flashe_tpu_torch.native import kvserver_binary

        if kvserver_binary() is None:
            pytest.skip("no compiler for the native storage node")
    node = StorageNode(str(tmp_path / "node"), native=use_native)
    assert node.native == use_native
    marker = tmp_path / "started.txt"
    try:
        s = table_mod.init("egg_replay", storage_addr=node.address)
        t = s.table("t", "ns", partition=1)
        t.put(0, 1)
        # in the egg: note that the job started, then kill the worker
        with pytest.raises(OSError, match="EXEC failed"):
            t.mapValues(lambda v, m=str(marker): (
                os.write(os.open(m, os.O_WRONLY | os.O_CREAT | os.O_APPEND),
                         b"started\n"), os._exit(3)))
        assert marker.read_text().splitlines() == ["started"]
        # the pool respawns a worker for the next job
        assert t.reduce(operator.add) == 1
        s.stop()
    finally:
        node.shutdown()
