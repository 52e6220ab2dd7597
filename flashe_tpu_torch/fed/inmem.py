"""In-process federation broker (port of flashe_tpu/fed/inmem.py).

Plays the role of the reference's standalone work mode
(arch/api/transfer/standalone.py:32-112: LMDB meta tables + polling) for
multi-role simulation in one process: each role runs in its own thread and
all parties share one InMemBroker.  Objects are passed by reference, CUDA
tensors included, so lanes stay on the card and simulation adds no
serialization cost; the TCP transport (fed/tcp.py) is the wire-faithful
path.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

from flashe_tpu_torch.fed.transport import Federation, Party
from flashe_tpu_torch.runtime.tracking import count

__all__ = ["InMemBroker", "InMemFederation"]

_Key = Tuple[str, str, Party, Party]


class InMemBroker:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._store: Dict[_Key, Any] = {}

    def put(self, key: _Key, obj: Any):
        with self._cond:
            self._store[key] = obj
            self._cond.notify_all()

    def get(self, key: _Key, timeout: float) -> Any:
        """The object put under `key`, waiting up to `timeout` seconds.
        Every put wakes every waiting get; each wake is counted as
        `wakeups` on the caller's open record ("fed.get"), so a get that
        waited for one put and was woken by nine others counts ten."""
        checks = 0

        def arrived():
            nonlocal checks
            checks += 1
            return key in self._store

        with self._cond:
            ok = self._cond.wait_for(arrived, timeout)
            obj = self._store.pop(key) if ok else None
        if checks > 1:
            count("wakeups", checks - 1)
        if not ok:
            raise TimeoutError(f"federation get timed out on {key}")
        return obj

    def clean(self, name: str, src: Party, dst: Party):
        with self._cond:
            for k in [k for k in self._store
                      if k[0] == name and k[2] == src and k[3] == dst]:
                del self._store[k]


class InMemFederation(Federation):
    def __init__(self, broker: InMemBroker, job_id, local, parties,
                 authorization=None):
        super().__init__(job_id, local, parties, authorization)
        self._broker = broker

    def _send(self, obj, name, tag, src, dst):
        self._broker.put((name, tag, src, dst), obj)

    def _recv(self, name, tag, src, dst, timeout):
        return self._broker.get((name, tag, src, dst), timeout)

    def _clean(self, name, src, dst):
        self._broker.clean(name, src, dst)
