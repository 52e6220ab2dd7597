"""PyTorch port: the persistent partitioned KV store
(flashe_tpu_torch/data/kvstore.py over csrc/kvstore.cpp, built into
build/flashe_tpu_torch/) and the persistent Session / DTable on it, as
tests/test_kvstore.py holds the JAX package's; plus the one on-disk format
shared with the JAX package's store (native/kvstore.cpp)."""

import os

import numpy as np
import pytest

from flashe_tpu.data.kvstore import open_store as jopen_store
from flashe_tpu_torch import native
from flashe_tpu_torch.data import table as table_mod
from flashe_tpu_torch.data.kvstore import open_store
from flashe_tpu_torch.ops._build import build_dir


@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "python"])
def test_kv_roundtrip_and_reopen(tmp_path, force_python):
    d = str(tmp_path / "kv")
    st = open_store(d, nparts=3, force_python=force_python)
    if not force_python and not st.native:
        pytest.skip("no compiler for the native node")
    st.put(0, b"alpha", b"1" * 100)
    st.put(1, b"beta", b"")
    st.put(0, b"alpha", b"overwritten")  # last write wins
    st.put(2, b"gamma", bytes(range(256)))
    st.delete(1, b"beta")
    assert st.get(0, b"alpha") == b"overwritten"
    assert st.get(1, b"beta") is None
    assert st.count(0) == 1 and st.count(1) == 0 and st.count(2) == 1
    st.close()

    # reopen: log replay restores the exact state
    st2 = open_store(d, nparts=3, force_python=force_python)
    assert st2.get(0, b"alpha") == b"overwritten"
    assert st2.get(2, b"gamma") == bytes(range(256))
    assert st2.get(1, b"beta") is None
    assert dict(st2.items(0)) == {b"alpha": b"overwritten"}
    st2.close()


def test_native_and_python_formats_interoperate(tmp_path):
    d = str(tmp_path / "kv")
    nat = open_store(d, nparts=1)
    if not nat.native:
        pytest.skip("no compiler for the native node")
    nat.put(0, b"k1", b"v1")
    nat.put(0, b"k2", b"v2")
    nat.delete(0, b"k1")
    nat.close()
    # python reader sees the native writer's state
    py = open_store(d, nparts=1, force_python=True)
    assert dict(py.items(0)) == {b"k2": b"v2"}
    py.put(0, b"k3", b"v3")
    py.close()
    # and back
    nat2 = open_store(d, nparts=1)
    assert nat2.get(0, b"k3") == b"v3"
    assert nat2.get(0, b"k1") is None
    nat2.close()


def test_torn_tail_truncated(tmp_path):
    d = str(tmp_path / "kv")
    st = open_store(d, nparts=1, force_python=True)
    st.put(0, b"good", b"value")
    st.close()
    # simulate a crash mid-append: a record header without its bytes
    with open(str(tmp_path / "kv" / "p0.log"), "ab") as fh:
        fh.write((5).to_bytes(4, "little") + (99).to_bytes(4, "little")
                 + b"torn!")
    st2 = open_store(d, nparts=1)
    assert dict(st2.items(0)) == {b"good": b"value"}
    st2.put(0, b"after", b"crash")  # appends land on a clean boundary
    st2.close()
    st3 = open_store(d, nparts=1, force_python=True)
    assert st3.get(0, b"after") == b"crash"
    st3.close()


def test_persistent_session_tables(tmp_path):
    root = str(tmp_path / "tables")
    sess = table_mod.init("job1", storage_dir=root)
    t = sess.table("t1", "ns", partition=2)
    t.put_all([(i, {"w": np.arange(3) * i}) for i in range(10)])
    t.put("strkey", [1, 2, 3])
    assert t.count() == 11
    assert t.get(3)["w"].tolist() == [0, 3, 6]
    # functional surface works on the persistent table
    s = t.filter(lambda k, v: isinstance(k, int)).reduce(
        lambda a, b: {"w": a["w"] + b["w"]})
    assert s["w"].tolist() == [0, 45, 90]
    sess.stop()

    # a new session (fresh process semantics) sees the same data
    sess2 = table_mod.init("job2", storage_dir=root)
    t2 = sess2.table("t1", "ns", partition=2)
    assert t2.count() == 11
    assert t2.get("strkey") == [1, 2, 3]
    assert t2.delete(0) is not None
    assert t2.count() == 10
    sess2.stop()


def test_native_library_builds_in_the_ports_build_dir():
    """The port's library is its own csrc/kvstore.cpp, built under
    build/flashe_tpu_torch/, never into the JAX package's native/."""
    lib = native.build_lib("kvstore.cpp", "libflashekv.so")
    if lib is None:
        pytest.skip(f"no compiler: {native.last_error('kvstore')}")
    assert os.path.dirname(lib._name) == str(build_dir())
    assert os.path.basename(lib._name) == "libflashekv.so"


@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "python"])
def test_store_shared_with_the_jax_package(tmp_path, force_python):
    """A store either package writes, the other reads: one file format and
    one META partition pin."""
    d = str(tmp_path / "kv")
    ref = jopen_store(d, nparts=2)
    ref.put(0, b"jax", b"wrote")
    ref.put(1, b"gone", b"x")
    ref.delete(1, b"gone")
    ref.close()
    st = open_store(d, nparts=5, force_python=force_python)
    assert st.nparts == 2  # the on-disk pin wins
    assert dict(st.items(0)) == {b"jax": b"wrote"}
    assert st.get(1, b"gone") is None
    st.put(1, b"port", b"wrote too")
    st.close()
    back = jopen_store(d, nparts=2, force_python=True)
    assert back.get(1, b"port") == b"wrote too"
    assert back.get(0, b"jax") == b"wrote"
    back.close()
