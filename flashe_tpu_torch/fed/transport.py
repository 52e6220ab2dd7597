"""Abstract federation transport with authorization and GC (port of
flashe_tpu/fed/transport.py, which needs no JAX; the port keeps its own
copy).

Message semantics follow the reference transfer layer
(arch/api/transfer/__init__.py:278-302, base_transfer_variable.py:96-140):
named, tag-addressed, authorized point-to-point object transfer.  A message
key is (variable_name, tag, src_party, dst_party); tags are built from the
job flow id plus per-call suffixes, so every logical transfer is unique and
consumed exactly once (the reference's Cleaner keep-latest-2 GC becomes
consume-on-get plus protocol-level resend).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.runtime.tracking import span

__all__ = ["Party", "Federation", "FederationAuthorization", "TransferStat",
           "default_parties"]


class TransferStat:
    """Per-variable transfer counters — the analogue of the reference
    proxy's live stream statistics (arch/networking/proxy
    model/StreamStat.java) plus fate_flow's per-transfer audit logs.
    Byte counts are wire bytes where the transport serializes (TCP
    federation); in-memory transports count messages only."""

    def __init__(self):
        self._rows: Dict[str, Dict[str, int]] = {}

    def _row(self, name: str) -> Dict[str, int]:
        return self._rows.setdefault(name, {
            "sent_msgs": 0, "sent_bytes": 0,
            "recv_msgs": 0, "recv_bytes": 0,
        })

    def count_send(self, name: str, nbytes: int = 0):
        row = self._row(name)
        row["sent_msgs"] += 1
        row["sent_bytes"] += nbytes

    def count_recv(self, name: str, nbytes: int = 0):
        row = self._row(name)
        row["recv_msgs"] += 1
        row["recv_bytes"] += nbytes

    def add_sent_bytes(self, name: str, nbytes: int):
        self._row(name)["sent_bytes"] += nbytes

    def add_recv_bytes(self, name: str, nbytes: int):
        self._row(name)["recv_bytes"] += nbytes

    def summary(self) -> Dict[str, Dict[str, int]]:
        total = {"sent_msgs": 0, "sent_bytes": 0,
                 "recv_msgs": 0, "recv_bytes": 0}
        for row in self._rows.values():
            for k in total:
                total[k] += row[k]
        out = dict(sorted(self._rows.items()))
        out["__total__"] = total
        return out


@dataclasses.dataclass(frozen=True, order=True)
class Party:
    """(role, party_id) — reference arch/api/transfer/__init__.py Party."""

    role: str
    party_id: int

    def __str__(self):
        return f"{self.role}:{self.party_id}"


class FederationAuthorization:
    """src/dst role matrix per variable name (reference
    transfer_variable/definition/transfer_conf.json + jzf_homo.json)."""

    def __init__(self, table: Dict[str, Dict[str, Sequence[str]]]):
        self._table = table

    def check(self, name: str, src_role: str, dst_role: str):
        if name not in self._table:
            raise PermissionError(f"variable {name} not authorized")
        ent = self._table[name]
        if src_role not in ent["src"] or dst_role not in ent["dst"]:
            raise PermissionError(
                f"{name}: {src_role}->{dst_role} not in authorization matrix "
                f"(allowed {ent['src']}->{ent['dst']})"
            )


class Federation:
    """Per-party handle; subclasses implement _send/_recv."""

    def __init__(self, job_id: str, local: Party, parties: Sequence[Party],
                 authorization: FederationAuthorization | None = None):
        self.job_id = job_id
        self.local = local
        self.parties = list(parties)
        self.auth = authorization
        self.stats = TransferStat()

    def roles_to_parties(self, roles: Sequence[str]) -> List[Party]:
        return [p for role in roles for p in self.parties if p.role == role]

    def scoped(self, sub_id: str) -> "Federation":
        """A view of this federation whose tags live under
        `{job_id}.{sub_id}` — an isolated message namespace over the same
        transport (the analogue of FATE running a sub-task under its own
        flow id, e.g. one cross-validation fold per
        federatedml/model_base.py:74-103 dispatch).  Transport state
        (broker connection, sockets) is shared; transfer stats are
        per-scope."""
        import copy

        sub = copy.copy(self)
        sub.job_id = f"{self.job_id}.{sub_id}"
        sub.stats = TransferStat()
        return sub

    def remote(self, obj: Any, name: str, tag: str, dst: Party):
        if self.auth is not None:
            self.auth.check(name, self.local.role, dst.role)
        self.stats.count_send(name)
        self._send(obj, name, f"{self.job_id}.{tag}", self.local, dst)

    def get(self, name: str, tag: str, src: Party, timeout: float = 600.0):
        if self.auth is not None:
            self.auth.check(name, src.role, self.local.role)
        with span("fed.get"):
            out = self._recv(name, f"{self.job_id}.{tag}", src, self.local,
                             timeout)
        self.stats.count_recv(name)
        return out

    def clean(self, name: str, src: Party):
        """Drop any undelivered messages for (name, src->local)."""
        self._clean(name, src, self.local)

    # -- transport hooks ---------------------------------------------------

    def _send(self, obj, name, tag, src: Party, dst: Party):
        raise NotImplementedError

    def _recv(self, name, tag, src: Party, dst: Party, timeout: float):
        raise NotImplementedError

    def _clean(self, name, src: Party, dst: Party):
        raise NotImplementedError


def default_parties(n_hosts: int) -> List[Party]:
    """guest(0) + hosts(1..n) + arbiter — canonical party layout."""
    return (
        [Party(consts.GUEST, 0)]
        + [Party(consts.HOST, i) for i in range(n_hosts)]
        + [Party(consts.ARBITER, 0)]
    )
