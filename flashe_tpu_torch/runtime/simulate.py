"""In-process multi-role simulation (port of flashe_tpu/runtime/simulate.py).

Replaces the reference's TestSyncBase fixture
(federatedml/framework/test/homo/homo_test_sync_base.py:25-108, one OS
process per role over standalone eggroll) with one thread per role over the
in-memory broker.  Exceptions propagate to the caller with the failing
role attached; `timeout` bounds the whole run.

Every role's federation enforces runtime/permission.effective_authorization():
the static matrix of HomoTransferVariables.authorization() unless the
privilege store holds grants or revocations.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from flashe_tpu_torch.fed.inmem import InMemBroker, InMemFederation
from flashe_tpu_torch.fed.transport import default_parties
from flashe_tpu_torch.fed.variables import HomoTransferVariables
from flashe_tpu_torch.runtime.permission import effective_authorization
from flashe_tpu_torch.runtime.tracking import Tracker, set_tracker

__all__ = ["run_roles"]


def run_roles(n_hosts: int, guest_fn: Callable, host_fn: Callable,
              arbiter_fn: Callable, job_id: str = "sim",
              timeout: float = 900.0) -> Dict[str, object]:
    """Run guest/host/arbiter callables concurrently; return their results.

    guest_fn(trv), host_fn(trv, host_idx), arbiter_fn(trv); each thread
    gets its own HomoTransferVariables bound to its party and its own
    Tracker.  Raises RuntimeError naming the first role that failed, or
    TimeoutError if a role is still running `timeout` seconds after the
    start (its thread is a daemon and is left behind).
    """
    broker = InMemBroker()
    parties = default_parties(n_hosts)
    auth = effective_authorization()

    results: Dict[str, object] = {}
    errors: Dict[str, BaseException] = {}

    def _wrap(name, party, fn, *args):
        def run():
            set_tracker(Tracker(name))
            try:
                fed = InMemFederation(broker, job_id, party, parties, auth)
                trv = HomoTransferVariables(fed)
                results[name] = fn(trv, *args)
            except BaseException as e:  # noqa: BLE001 - surface to caller
                errors[name] = e
        return threading.Thread(target=run, name=name, daemon=True)

    threads = [
        _wrap("guest", parties[0], guest_fn),
        _wrap("arbiter", parties[-1], arbiter_fn),
    ]
    for h in range(n_hosts):
        threads.append(_wrap(f"host{h}", parties[1 + h], host_fn, h))

    deadline = time.monotonic() + timeout
    for t in threads:
        t.start()
    for t in threads:
        # poll so a crashed role surfaces immediately instead of leaving
        # the other roles blocked on gets that will never be answered
        while t.is_alive():
            t.join(timeout=0.05)
            if errors:
                name, err = next(iter(errors.items()))
                raise RuntimeError(f"role {name} failed: {err!r}") from err
            if time.monotonic() > deadline:
                raise TimeoutError(f"role thread {t.name} did not finish "
                                   f"within {timeout} s")
    if errors:
        name, err = next(iter(errors.items()))
        raise RuntimeError(f"role {name} failed: {err!r}") from err
    return results
