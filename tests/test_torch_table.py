"""PyTorch port: the session / DTable substrate and CSV ingestion
(flashe_tpu_torch/data/{table,codec,io,store}.py) against the JAX package's
(flashe_tpu/data/).

- The in-memory DTable's KV and functional ops, the registry and save_as,
  CSV ingestion into a session: tests/test_table_io.py on the port.
- The codec: the same record bytes and the same partition for a key in
  both packages, so a persistent table routes alike in either.
- upload_csv and DataStore.to_dtable give a table of the same Instances as
  the JAX package's, in memory and on a storage node.
"""

from __future__ import annotations

import numpy as np
import pytest

from flashe_tpu.data import codec as jcodec
from flashe_tpu.data import table as jtable
from flashe_tpu.data.io import upload_csv as jupload_csv
from flashe_tpu.data.store import DataStore as JDataStore
from flashe_tpu_torch.data import codec
from flashe_tpu_torch.data.io import Instance, read_dense_csv, upload_csv
from flashe_tpu_torch.data.remote_kv import StorageNode
from flashe_tpu_torch.data.store import DataStore
from flashe_tpu_torch.data.table import init


def test_table_kv_and_functional_ops():
    s = init("job1")
    t = s.parallelize([10, 20, 30, 40], partition=3)
    assert t.count() == 4
    assert sorted(v for _, v in t.collect()) == [10, 20, 30, 40]
    assert t.get(2) == 30

    doubled = t.mapValues(lambda v: v * 2)
    assert doubled.get(3) == 80
    assert doubled.reduce(lambda a, b: a + b) == 200

    remapped = t.map(lambda k, v: (k + 100, v + 1))
    assert remapped.get(101) == 21

    other = s.parallelize([(1, 5), (2, 7)], include_key=True)
    joined = t.join(other, lambda a, b: a + b)
    assert dict(joined.collect()) == {1: 25, 2: 37}

    assert dict(t.subtractByKey(other).collect()) == {0: 10, 3: 40}
    assert t.filter(lambda k, v: v > 25).count() == 2

    union = t.union(other, lambda v1, v2: v1 + v2)
    assert union.get(1) == 25 and union.get(0) == 10
    assert t.union(other).get(1) == 20  # the left value wins by default

    flat = other.flatMap(lambda k, v: [(k, v), (k + 10, v * 10)])
    assert flat.get(12) == 70

    parts = t.glom().collect()
    assert sum(len(items) for _, items in parts) == 4
    counted = t.mapPartitions(lambda it: sum(1 for _ in it))
    assert counted.reduce(lambda a, b: a + b) == 4


def test_table_registry_and_save_as():
    s = init("job2")
    t = s.parallelize([1, 2, 3])
    saved = t.save_as("train", "ns")
    assert s.table("train", "ns") is saved
    assert saved.count() == 3
    saved.destroy()
    assert s.table("train", "ns").count() == 0

    t2 = s.table("x", "ns", partition=4)
    t2.put_all((i, i * i) for i in range(100))
    assert t2.get_partitions() == 4
    assert t2.count() == 100
    assert t2.first() is not None
    assert len(t2.take(5)) == 5
    assert t2.sample(0.5, seed=0).count() < 100
    assert t2.put_if_absent(0, -1) == 0
    t2.delete(0)
    assert t2.get(0) is None


def test_csv_ingestion(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("y,f0,f1\n1,0.5,1.5\n0,2.5,3.5\n1,4.0,5.0\n")
    x, y = read_dense_csv(str(p))
    assert x.shape == (3, 2) and x.dtype == np.float32
    assert y.tolist() == [1, 0, 1]

    s = init("job3")
    table = upload_csv(s, str(p), "train", "ns")
    assert table.count() == 3
    inst = table.get(0)
    assert isinstance(inst, Instance)
    assert inst.label == 1 and inst.features.tolist() == [0.5, 1.5]

    x2, y2 = read_dense_csv(str(p), label_index=None)
    assert x2.shape == (3, 3) and y2 is None


@pytest.mark.parametrize("key", [0, 7, -3, 2**40, "k13", ("a", 1), b"raw",
                                 3.5, None])
def test_codec_matches_jax(key):
    kb = codec.enc(key)
    assert kb == jcodec.enc(key)
    assert codec.dec(kb) == key
    for nparts in (1, 2, 3, 7, 16):
        assert codec.part_of(kb, nparts) == jcodec.part_of(kb, nparts)


def _instances(table):
    return sorted((k, v.inst_id, v.features.tolist(), v.label)
                  for k, v in table.collect())


def test_upload_csv_and_to_dtable_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    rows = ["y,a,b,c"] + [f"{rng.randint(0, 3)},{rng.rand():.6f},"
                          f"{rng.rand():.6f},{rng.rand():.6f}"
                          for _ in range(12)]
    p = tmp_path / "d.csv"
    p.write_text("\n".join(rows) + "\n")
    port = upload_csv(init("u"), str(p), "t", "ns", partition=3)
    ref = jupload_csv(jtable.init("u"), str(p), "t", "ns", partition=3)
    assert _instances(port) == _instances(ref)

    root = str(tmp_path / "store")
    DataStore(root).upload_csv(str(p), "ns", "csv", partition=2)
    port = DataStore(root).to_dtable(init("d"), "ns", "csv")
    ref = JDataStore(root).to_dtable(jtable.init("d"), "ns", "csv")
    assert port.get_partitions() == 2
    assert _instances(port) == _instances(ref)


def test_to_dtable_on_a_storage_node(tmp_path):
    """A stored dataset materialized on the port's storage node reads back
    from a second session, and its features map server-side."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    y = np.array([1, 0, 1, 1], np.int32)
    store = DataStore(str(tmp_path / "store"))
    store.put("ns", "t", x, y, partition=2)
    node = StorageNode(str(tmp_path / "node"), native=False)
    try:
        s = init("n", storage_addr=node.address)
        table = store.to_dtable(s, "ns", "t")
        s.stop()
        s2 = init("n2", storage_addr=node.address)
        again = s2.table("t", "ns")
        assert again.get_partitions() == 2
        assert [again.get(i).label for i in range(4)] == y.tolist()
        sums = again.mapValues(lambda inst: float(inst.features.sum()))
        assert dict(sums.collect()) == {i: float(x[i].sum())
                                        for i in range(4)}
        assert table.count() == 4
        s2.stop()
    finally:
        node.shutdown()
