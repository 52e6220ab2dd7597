"""Typed transfer variables (port of flashe_tpu/fed/variables.py; reference
transfer_variable layer).

`Variable.remote/get` mirror base_transfer_variable.py:96-140: role+ordinal
addressing (idx=-1 broadcasts / gathers over all parties of a role), tags
assembled from dotted suffixes.  The variable set and its authorization
matrix reproduce transfer_variable/definition/jzf_homo.json plus the stock
homo variables the FLASHE pipeline uses (uuid/DH/loss/convergence).
"""

from __future__ import annotations

from typing import Sequence

from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.fed.transport import Federation, FederationAuthorization

__all__ = ["Variable", "HomoTransferVariables", "AUTH_TABLE"]


def _tag(suffix) -> str:
    if not isinstance(suffix, tuple):
        suffix = (suffix,)
    return ".".join(str(s) for s in suffix) if suffix else "default"


class Variable:
    def __init__(self, name: str, federation: Federation,
                 dst_roles: Sequence[str]):
        self.name = name
        self._fed = federation
        self._dst_roles = list(dst_roles)

    def roles_to_parties(self, roles):
        return self._fed.roles_to_parties(roles)

    def _resolve(self, role, idx):
        roles = self._dst_roles if role is None else [role]
        parties = self._fed.roles_to_parties(roles)
        if idx == -1:
            return parties
        return [parties[idx]]

    def remote(self, obj, role=None, idx=-1, suffix=tuple()):
        for dst in self._resolve(role, idx):
            if dst == self._fed.local:
                continue
            self._fed.remote(obj, self.name, _tag(suffix), dst)

    def get(self, idx=-1, suffix=tuple(), src_role=None, timeout=600.0):
        """idx=-1: gather a list over all source parties of the peer role.

        The source role is inferred from the variable name
        (`<src>_to_<dst>` channels) or passed explicitly.
        """
        if src_role is None:
            src_role = self._infer_src_role()
        parties = self._fed.roles_to_parties([src_role])
        if idx == -1:
            return [
                self._fed.get(self.name, _tag(suffix), p, timeout)
                for p in parties
            ]
        return self._fed.get(self.name, _tag(suffix), parties[idx], timeout)

    def _infer_src_role(self):
        ent = AUTH_TABLE.get(self.name)
        if ent is None or len(ent["src"]) != 1:
            raise ValueError(
                f"cannot infer source role for {self.name}; pass src_role"
            )
        return ent["src"][0]

    def clean(self):
        src = self._infer_src_role()
        for p in self._fed.roles_to_parties([src]):
            self._fed.clean(self.name, p)


# Authorization matrix: reference
# transfer_variable/definition/jzf_homo.json (generic directed channels) +
# transfer_conf.json entries for uuid/DH/loss/convergence.
AUTH_TABLE = {
    "arbiter_to_guest": {"src": [consts.ARBITER], "dst": [consts.GUEST]},
    "arbiter_to_host": {"src": [consts.ARBITER], "dst": [consts.HOST]},
    "guest_to_arbiter": {"src": [consts.GUEST], "dst": [consts.ARBITER]},
    "host_to_arbiter": {"src": [consts.HOST], "dst": [consts.ARBITER]},
    "guest_uuid": {"src": [consts.GUEST], "dst": [consts.ARBITER]},
    "host_uuid": {"src": [consts.HOST], "dst": [consts.ARBITER]},
    "uuid_conflict_flag": {
        "src": [consts.ARBITER], "dst": [consts.GUEST, consts.HOST]
    },
    "dh_pubkey": {
        "src": [consts.ARBITER], "dst": [consts.GUEST, consts.HOST]
    },
    "dh_ciphertext_guest": {"src": [consts.GUEST], "dst": [consts.ARBITER]},
    "dh_ciphertext_host": {"src": [consts.HOST], "dst": [consts.ARBITER]},
    "dh_ciphertext_bc": {
        "src": [consts.ARBITER], "dst": [consts.GUEST, consts.HOST]
    },
    "guest_loss": {"src": [consts.GUEST], "dst": [consts.ARBITER]},
    "host_loss": {"src": [consts.HOST], "dst": [consts.ARBITER]},
    "is_converge": {
        "src": [consts.ARBITER], "dst": [consts.GUEST, consts.HOST]
    },
}


class HomoTransferVariables:
    """The jzf_homo variable bundle
    (transfer_class/jzf_homo_transfer_variable.py)."""

    def __init__(self, federation: Federation):
        self.federation = federation
        for name, ent in AUTH_TABLE.items():
            setattr(self, name, Variable(name, federation, ent["dst"]))

    @staticmethod
    def authorization() -> FederationAuthorization:
        return FederationAuthorization(AUTH_TABLE)
