"""In-memory partitioned KV tables — the storage/compute substrate (port
of flashe_tpu/data/table.py).

The reference stages every dataset and federation object in eggroll
DTables (LMDB-backed, C++ storage service; API at arch/api/table/table.py:
25-179, session at arch/api/session.py:32-87).  Model payloads here are
device tensors moved directly, so the table layer only needs to serve the
*dataflow* role: ingesting datasets, key-addressed staging, and the
functional ops components use (map/mapValues/reduce/join/...).  This is a
compact process-local implementation with the same surface; partitions
are real (hash-partitioned dicts) so partition-parallel semantics
(mapPartitions, glom) behave like the reference's.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["DTable", "Session", "init"]


def _hash_partition(key, n: int) -> int:
    return hash(key) % n


class DTable:
    """Hash-partitioned in-memory KV table with functional ops.

    Mirrors the reference DTable surface (arch/api/table/table.py:25-179):
    put/put_all/get/delete/count/collect/take/first plus
    map/mapValues/mapPartitions/reduce/join/filter/union/subtractByKey/
    flatMap/glom/sample, and save_as persistence into the session registry.
    """

    def __init__(self, session: "Session", name: str, namespace: str,
                 partitions: int = 1):
        self._session = session
        self._name = name
        self._namespace = namespace
        self._n = max(int(partitions), 1)
        self._parts: List[Dict[Any, Any]] = [dict() for _ in range(self._n)]

    # -- identity ---------------------------------------------------------

    def get_name(self) -> str:
        return self._name

    def get_namespace(self) -> str:
        return self._namespace

    def get_partitions(self) -> int:
        return self._n

    # -- KV ops -----------------------------------------------------------

    def put(self, k, v):
        self._parts[_hash_partition(k, self._n)][k] = v

    def put_all(self, kv_list: Iterable[Tuple[Any, Any]]):
        for k, v in kv_list:
            self.put(k, v)

    def put_if_absent(self, k, v):
        part = self._parts[_hash_partition(k, self._n)]
        if k not in part:
            part[k] = v
            return None
        return part[k]

    def get(self, k, default=None):
        return self._parts[_hash_partition(k, self._n)].get(k, default)

    def delete(self, k):
        return self._parts[_hash_partition(k, self._n)].pop(k, None)

    def destroy(self):
        self._parts = [dict() for _ in range(self._n)]
        self._session._drop(self._namespace, self._name)

    def count(self) -> int:
        return sum(len(p) for p in self._parts)

    def collect(self) -> List[Tuple[Any, Any]]:
        out = []
        for p in self._parts:
            out.extend(p.items())
        return out

    def take(self, n: int = 1, keys_only: bool = False):
        out = []
        for k, v in self.collect():
            out.append(k if keys_only else (k, v))
            if len(out) >= n:
                break
        return out

    def first(self, keys_only: bool = False):
        got = self.take(1, keys_only)
        return got[0] if got else None

    # -- functional ops ---------------------------------------------------

    def _derived(self, partitions: Optional[int] = None) -> "DTable":
        return self._session._anon_table(partitions or self._n)

    def map(self, func: Callable[[Any, Any], Tuple[Any, Any]]) -> "DTable":
        out = self._derived()
        for k, v in self.collect():
            nk, nv = func(k, v)
            out.put(nk, nv)
        return out

    def mapValues(self, func: Callable[[Any], Any]) -> "DTable":
        out = self._derived()
        for p_in, p_out in zip(self._parts, out._parts):
            for k, v in p_in.items():
                p_out[k] = func(v)
        return out

    def mapPartitions(self, func: Callable[[Iterable], Any]) -> "DTable":
        """func consumes one partition's (k, v) iterator; result keyed by
        partition index (the reference's mapPartitions contract)."""
        out = self._derived()
        for i, p in enumerate(self._parts):
            out.put(i, func(iter(p.items())))
        return out

    def reduce(self, func: Callable[[Any, Any], Any]):
        acc = None
        for _, v in self.collect():
            acc = v if acc is None else func(acc, v)
        return acc

    def join(self, other: "DTable",
             func: Callable[[Any, Any], Any]) -> "DTable":
        out = self._derived()
        for k, v in self.collect():
            ov = other.get(k, None)
            if ov is not None or any(k in p for p in other._parts):
                out.put(k, func(v, ov))
        return out

    def filter(self, func: Callable[[Any, Any], bool]) -> "DTable":
        out = self._derived()
        for k, v in self.collect():
            if func(k, v):
                out.put(k, v)
        return out

    def union(self, other: "DTable",
              func: Callable[[Any, Any], Any] = lambda v1, v2: v1,
              ) -> "DTable":
        out = self._derived()
        out.put_all(self.collect())
        for k, v in other.collect():
            mine = out.get(k, None)
            out.put(k, func(mine, v) if mine is not None else v)
        return out

    def subtractByKey(self, other: "DTable") -> "DTable":
        out = self._derived()
        for k, v in self.collect():
            if other.get(k, None) is None:
                out.put(k, v)
        return out

    def flatMap(self, func: Callable[[Any, Any], Iterable]) -> "DTable":
        out = self._derived()
        for k, v in self.collect():
            out.put_all(func(k, v))
        return out

    def glom(self) -> "DTable":
        out = self._derived()
        for i, p in enumerate(self._parts):
            out.put(i, list(p.items()))
        return out

    def sample(self, fraction: float, seed=None) -> "DTable":
        rng = random.Random(seed)
        out = self._derived()
        for k, v in self.collect():
            if rng.random() < fraction:
                out.put(k, v)
        return out

    def save_as(self, name: str, namespace: str,
                partition: Optional[int] = None) -> "DTable":
        out = self._session.table(name, namespace,
                                  partition or self._n)
        out.put_all(self.collect())
        return out


class PersistentDTable(DTable):
    """DTable whose KV state lives in the native storage node
    (csrc/kvstore.cpp via flashe_tpu_torch/data/kvstore.py) — the analogue
    of an eggroll LMDB-backed table in FATE standalone work mode.

    KV ops (put/get/delete/count/collect) hit the store directly.
    Functional ops run *server-side* when the store is a remote node
    (data/remote_kv.py): map/mapValues/mapPartitions/filter/flatMap/
    reduce ship the function to the node's egg processor (data/egg.py),
    which reads the source partitions near the data and shuffles map
    output straight to the owning nodes — the reference's eggroll
    roll/egg compute plane (arch/api/table/table.py:25-179 backed by
    remote execution in cluster mode).  glom/sample route through the
    same path; join/union/subtractByKey run server-side too when both
    tables are co-partitioned on the same node list (no shuffle needed
    — eggroll's equal-partitions join precondition).  Against an
    in-process store (or for non-co-partitioned binary ops) they
    inherit DTable's client-side path and materialize into in-memory
    derived tables.  Keys/values pickle on the way in;
    partition routing hashes the pickled key with crc32 so the layout
    is stable across processes (python's `hash` is per-process salted;
    flashe_tpu_torch/data/codec.py is the shared rule).
    """

    def __init__(self, session: "Session", name: str, namespace: str,
                 partitions: int, store):
        self._session = session
        self._name = name
        self._namespace = namespace
        self._n = max(int(partitions), 1)
        self._kv = store

    @staticmethod
    def _enc(obj) -> bytes:
        from flashe_tpu_torch.data.codec import enc

        return enc(obj)

    @staticmethod
    def _dec(b: bytes):
        from flashe_tpu_torch.data.codec import dec

        return dec(b)

    def _part_of(self, kb: bytes) -> int:
        from flashe_tpu_torch.data.codec import part_of

        return part_of(kb, self._n)

    def put(self, k, v):
        kb = self._enc(k)
        self._kv.put(self._part_of(kb), kb, self._enc(v))

    def put_if_absent(self, k, v):
        kb = self._enc(k)
        part = self._part_of(kb)
        cur = self._kv.get(part, kb)
        if cur is None:
            self._kv.put(part, kb, self._enc(v))
            return None
        return self._dec(cur)

    def get(self, k, default=None):
        kb = self._enc(k)
        got = self._kv.get(self._part_of(kb), kb)
        return default if got is None else self._dec(got)

    def delete(self, k):
        kb = self._enc(k)
        part = self._part_of(kb)
        cur = self._kv.get(part, kb)
        self._kv.delete(part, kb)
        return None if cur is None else self._dec(cur)

    def destroy(self):
        for i in range(self._n):
            for kb, _ in list(self._kv.items(i)):
                self._kv.delete(i, kb)
        self._session._drop(self._namespace, self._name)

    def count(self) -> int:
        return sum(self._kv.count(i) for i in range(self._n))

    def collect(self) -> List[Tuple[Any, Any]]:
        out = []
        for i in range(self._n):
            for kb, vb in self._kv.items(i):
                out.append((self._dec(kb), self._dec(vb)))
        return out

    @property
    def _parts(self) -> List[Dict[Any, Any]]:
        # read-only snapshot view for the inherited functional ops
        parts: List[Dict[Any, Any]] = [dict() for _ in range(self._n)]
        for i in range(self._n):
            for kb, vb in self._kv.items(i):
                parts[i][self._dec(kb)] = self._dec(vb)
        return parts

    def flush(self):
        self._kv.flush()

    # -- server-side compute (eggroll roll/egg analogue) -------------------

    def _remote(self) -> bool:
        return getattr(self._kv, "supports_exec", False)

    def _exec_fanout(self, kind: str, fn, extra: dict) -> List[dict]:
        """One EXEC per storage node (each over that node's partition
        slice), in parallel; returns the per-node result dicts."""
        import cloudpickle

        groups = self._kv.exec_groups(self._n)
        results: List[Optional[dict]] = [None] * len(groups)
        errors: List[BaseException] = []

        def run(i, conn, parts):
            spec = dict(src_ns=self._namespace, src_name=self._name,
                        src_nparts=self._n, parts=parts, kind=kind,
                        fn=fn, **extra)
            try:
                results[i] = conn.exec_call(cloudpickle.dumps(spec))
            except BaseException as e:  # surfaced below on the caller
                errors.append(e)

        if len(groups) == 1:
            run(0, *groups[0])
        else:
            import threading

            threads = [threading.Thread(target=run, args=(i, c, p))
                       for i, (c, p) in enumerate(groups)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        for r in results:
            if not r["ok"]:
                raise RuntimeError(
                    f"server-side {kind} failed in egg processor:\n"
                    f"{r.get('error', '')}")
        return results

    def _remote_map(self, fn, partitions: Optional[int] = None) -> "DTable":
        """Run a map-like job server-side into a fresh remote table.
        fn(part_idx, items_iter) yields output (k, v) records."""
        out = self._session._remote_anon_table(partitions or self._n)
        self._exec_fanout(
            "map_partitions", fn,
            dict(out_ns=out._namespace, out_name=out._name,
                 out_nparts=out._n, out_nodes=self._kv.addrs))
        return out

    def map(self, func):
        if not self._remote():
            return super().map(func)

        def fn(pi, it, func=func):
            for k, v in it:
                yield func(k, v)

        return self._remote_map(fn)

    def mapValues(self, func):
        if not self._remote():
            return super().mapValues(func)

        def fn(pi, it, func=func):
            for k, v in it:
                yield k, func(v)

        return self._remote_map(fn)

    def mapPartitions(self, func):
        if not self._remote():
            return super().mapPartitions(func)

        def fn(pi, it, func=func):
            yield pi, func(it)

        return self._remote_map(fn)

    def filter(self, func):
        if not self._remote():
            return super().filter(func)

        def fn(pi, it, func=func):
            for k, v in it:
                if func(k, v):
                    yield k, v

        return self._remote_map(fn)

    def flatMap(self, func):
        if not self._remote():
            return super().flatMap(func)

        def fn(pi, it, func=func):
            for k, v in it:
                for nk, nv in func(k, v):
                    yield nk, nv

        return self._remote_map(fn)

    def reduce(self, func):
        if not self._remote():
            return super().reduce(func)
        results = self._exec_fanout("reduce", func, {})
        acc = None
        seeded = False
        for r in results:
            if not r.get("seeded"):
                continue
            if not seeded:
                acc, seeded = r["value"], True
            else:
                acc = func(acc, r["value"])
        return acc

    # -- co-partitioned binary ops (join/union/subtractByKey) ----------

    def _co_remote(self, other) -> bool:
        """Both tables remote, same partition count, same node list —
        partition p of each is local to one node, so the binary op runs
        server-side with no shuffle (eggroll requires equal partitions
        for its join the same way)."""
        return (self._remote()
                and isinstance(other, PersistentDTable)
                and getattr(other._kv, "supports_exec", False)
                and other._n == self._n
                and list(getattr(other._kv, "addrs", []))
                == list(getattr(self._kv, "addrs", [])))

    def _remote_binary(self, op: str, fn, other) -> "DTable":
        out = self._session._remote_anon_table(self._n)
        self._exec_fanout(
            "binary", fn,
            dict(op=op, src2_ns=other._namespace,
                 src2_name=other._name, src2_nparts=other._n,
                 out_ns=out._namespace, out_name=out._name,
                 out_nparts=out._n, out_nodes=self._kv.addrs))
        return out

    def join(self, other, func):
        if not self._co_remote(other):
            return super().join(other, func)
        return self._remote_binary("join", func, other)

    def union(self, other, func=lambda v1, v2: v1):
        if not self._co_remote(other):
            return super().union(other, func)
        return self._remote_binary("union", func, other)

    def subtractByKey(self, other):
        if not self._co_remote(other):
            return super().subtractByKey(other)
        return self._remote_binary("subtract", None, other)

    def glom(self):
        if not self._remote():
            return super().glom()
        return self.mapPartitions(lambda it: list(it))

    def sample(self, fraction, seed=None):
        if not self._remote():
            return super().sample(fraction, seed)

        def fn(pi, it, fraction=fraction, seed=seed):
            import random

            # per-partition derived seed: each egg samples its own
            # slice deterministically (the client-side path draws one
            # rng sequence over collect order instead; both honor the
            # fraction, documented divergence in selection order)
            rng = random.Random(None if seed is None
                                else f"{seed}:{pi}")
            for k, v in it:
                if rng.random() < fraction:
                    yield k, v

        return self._remote_map(fn)


class Session:
    """Process-local analogue of `arch.api.session` (session.py:32-87):
    named-table registry + parallelize ingestion.  With `storage_dir`,
    named tables persist through the native C++ storage node
    (PersistentDTable) and survive restarts — FATE standalone work
    mode's local-LMDB behavior."""

    def __init__(self, job_id: str = "local",
                 storage_dir: Optional[str] = None,
                 storage_addr=None):
        self.job_id = job_id
        self.storage_dir = storage_dir
        # storage_addr: "host:port", "host:port,host:port" or a list —
        # several addresses make a multi-node session with partition p
        # pinned to node p % n_nodes (remote_kv.ShardedRemoteKV)
        if isinstance(storage_addr, str):
            self.storage_addrs = [a.strip() for a in storage_addr.split(",")
                                  if a.strip()]
        else:
            self.storage_addrs = list(storage_addr or [])
        self.storage_addr = (",".join(self.storage_addrs)
                             if self.storage_addrs else None)
        self._registry: Dict[Tuple[str, str], DTable] = {}
        self._stores: Dict[Tuple[str, str], Any] = {}
        self._anon = 0

    def table(self, name: str, namespace: str,
              partition: int = 1) -> DTable:
        key = (namespace, name)
        if key not in self._registry:
            if self.storage_addrs:
                # remote storage node(s) (data/remote_kv.py — the
                # eggroll storage-service split: tables live in another
                # process or on other machines; >1 address shards
                # partitions across nodes)
                from flashe_tpu_torch.data.remote_kv import (RemoteKVStore,
                                                       ShardedRemoteKV)

                store = self._stores.get(key)
                if store is None:
                    if len(self.storage_addrs) == 1:
                        store = RemoteKVStore(self.storage_addrs[0],
                                              namespace, name, partition)
                    else:
                        store = ShardedRemoteKV(self.storage_addrs,
                                                namespace, name, partition)
                    self._stores[key] = store
                self._registry[key] = PersistentDTable(
                    self, name, namespace, store.nparts, store)
            elif self.storage_dir is not None:
                import os

                from flashe_tpu_torch.data.kvstore import open_store

                d = os.path.join(self.storage_dir, namespace, name)
                os.makedirs(d, exist_ok=True)
                store = self._stores.get(key)
                if store is None:
                    store = open_store(d, partition)
                    self._stores[key] = store
                # the store pins its partition count on disk at creation
                # (kvstore.META); reopening must route with that count,
                # not whatever this run's caller passed
                self._registry[key] = PersistentDTable(
                    self, name, namespace, store.nparts, store)
            else:
                self._registry[key] = DTable(self, name, namespace,
                                             partition)
        return self._registry[key]

    def parallelize(self, data: Iterable, include_key: bool = False,
                    partition: int = 1) -> DTable:
        t = self._anon_table(partition)
        if include_key:
            t.put_all(data)
        else:
            t.put_all(enumerate(data))
        return t

    def _anon_table(self, partition: int) -> DTable:
        self._anon += 1
        return DTable(self, f"_anon_{self._anon}", self.job_id, partition)

    def _remote_anon_table(self, partition: int) -> DTable:
        """Anonymous *remote* table for server-side op output: derived
        tables of an egg-computed map live on the storage nodes, like
        every eggroll compute result.  The name carries a per-session
        random component — remote tables PERSIST on the node, so a
        deterministic `_anon_1` from a fresh session would merge its
        shuffle output into a previous session's leftover records."""
        import uuid as _uuid

        if not hasattr(self, "_anon_token"):
            self._anon_token = _uuid.uuid4().hex[:8]
        self._anon += 1
        return self.table(f"_anon_{self._anon_token}_{self._anon}",
                          self.job_id, partition)

    def _drop(self, namespace: str, name: str):
        self._registry.pop((namespace, name), None)

    def stop(self):
        self._registry.clear()
        for store in self._stores.values():
            store.close()
        self._stores.clear()


def init(job_id: str = "local",
         storage_dir: Optional[str] = None,
         storage_addr: Optional[str] = None) -> Session:
    """session.init analogue: returns a fresh process-local session.

    storage_dir enables persistent (native C++ node) tables in this
    process; storage_addr ("host:port") binds tables to a remote
    storage node instead (data/remote_kv.StorageNode)."""
    return Session(job_id, storage_dir=storage_dir,
                   storage_addr=storage_addr)
