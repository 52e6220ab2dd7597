"""Privilege store — the fate_flow permission app backend (port of
flashe_tpu/runtime/permission.py, on the port's fed/transport and
fed/variables).

Reference: fate_flow/apps/permission_app.py:31-50 (grant/delete/query
privilege) backed by authentication_utils.PrivilegeAuth, whose grants
persist in a config file and gate cross-party requests.  Here the
privilege surface is the federation transport's authorization matrix
(fed/variables.py AUTH_TABLE enforced by fed/transport.py
FederationAuthorization.check): a grant opens a directed
(variable, src_role -> dst_role) channel, a revocation closes one —
including the built-in defaults.  The store is a JSON file so the
per-(role, party) task-executor subprocesses observe the same effective
matrix as the process that granted it.

The file is shared with the JAX package (FLASHE_PERMISSIONS_PATH, else
~/.flashe_tpu/permissions.json): the two packages' variables and roles are
the same names, so a revocation made with either one holds in both.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from flashe_tpu_torch.fed.transport import FederationAuthorization
from flashe_tpu_torch.fed.variables import AUTH_TABLE, HomoTransferVariables

__all__ = ["PrivilegeStore", "PairAuthorization", "default_privilege_store",
           "effective_authorization"]

Triple = Tuple[str, str, str]  # (variable, src_role, dst_role)


def _default_triples() -> List[Triple]:
    return [(name, s, d) for name, ent in AUTH_TABLE.items()
            for s in ent["src"] for d in ent["dst"]]


class PairAuthorization(FederationAuthorization):
    """Directed-pair authorization: exact (variable, src, dst) triples.

    Stricter than the base cross-product matrix — a revoked single pair
    of a broadcast variable stays revoked even when the variable keeps
    other destinations.
    """

    def __init__(self, triples: Sequence[Triple]):
        self._triples = set(triples)
        # keep the base-class table shape for introspection
        table: Dict[str, Dict[str, List[str]]] = {}
        for name, s, d in sorted(self._triples):
            ent = table.setdefault(name, {"src": [], "dst": []})
            if s not in ent["src"]:
                ent["src"].append(s)
            if d not in ent["dst"]:
                ent["dst"].append(d)
        super().__init__(table)

    def check(self, name: str, src_role: str, dst_role: str):
        if (name, src_role, dst_role) not in self._triples:
            raise PermissionError(
                f"{name}: {src_role}->{dst_role} not granted")


class PrivilegeStore:
    """Grant/revoke/query privileges layered over the built-in matrix.

    File format: {"grants": [[name, src, dst], ...],
                  "revocations": [[name, src, dst], ...]}
    Effective privileges = defaults + grants - revocations.  Reads always
    reload from disk (grants made by another process must be seen by
    executor subprocesses started later).
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get(
            "FLASHE_PERMISSIONS_PATH",
            os.path.join(os.path.expanduser("~"), ".flashe_tpu",
                         "permissions.json"))
        self._mu = threading.Lock()

    # ------------------------------------------------------------- storage

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return {"grants": [], "revocations": []}
        return {"grants": [tuple(t) for t in raw.get("grants", [])],
                "revocations": [tuple(t)
                                for t in raw.get("revocations", [])]}

    def _save(self, state: dict):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"grants": [list(t) for t in state["grants"]],
                       "revocations": [list(t)
                                       for t in state["revocations"]]}, f,
                      indent=1)
        os.replace(tmp, self.path)

    # ------------------------------------------------------------- actions

    def grant(self, name: str, src_role: str, dst_role: str) -> dict:
        """Open a directed channel (un-revokes a default)."""
        t = (str(name), str(src_role), str(dst_role))
        with self._mu:
            st = self._load()
            st["revocations"] = [r for r in st["revocations"] if r != t]
            if t not in st["grants"] and t not in _default_triples():
                st["grants"].append(t)
            self._save(st)
        return {"granted": list(t)}

    def revoke(self, name: str, src_role: str, dst_role: str) -> dict:
        """Close a directed channel (defaults are recorded as revoked)."""
        t = (str(name), str(src_role), str(dst_role))
        with self._mu:
            st = self._load()
            st["grants"] = [g for g in st["grants"] if g != t]
            if t in _default_triples() and t not in st["revocations"]:
                st["revocations"].append(t)
            self._save(st)
        return {"revoked": list(t)}

    def effective_triples(self) -> List[Triple]:
        st = self._load()
        eff = [t for t in _default_triples() if t not in st["revocations"]]
        eff += [g for g in st["grants"] if g not in eff]
        return eff

    def query(self, src_role: Optional[str] = None) -> List[dict]:
        """Effective privileges, optionally filtered by source role
        (reference query_privilege returns the per-src grant list)."""
        return [{"variable": n, "src_role": s, "dst_role": d}
                for n, s, d in sorted(self.effective_triples())
                if src_role is None or s == src_role]

    def authorization(self) -> PairAuthorization:
        return PairAuthorization(self.effective_triples())

    def has_overrides(self) -> bool:
        st = self._load()
        return bool(st["grants"] or st["revocations"])


def default_privilege_store() -> PrivilegeStore:
    return PrivilegeStore()


def effective_authorization() -> FederationAuthorization:
    """The matrix federation runtimes should enforce: the built-in
    AUTH_TABLE unless the privilege store holds overrides (keeps the
    zero-config path identical to the static matrix)."""
    store = default_privilege_store()
    if store.has_overrides():
        return store.authorization()
    return HomoTransferVariables.authorization()
