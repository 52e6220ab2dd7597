"""Conflict-checked uuid assignment (port of flashe_tpu/protocol/uuid_sync.py;
reference identify_uuid_sync.py:31-63)."""

from __future__ import annotations

import uuid as _uuid

from flashe_tpu_torch.fed import consts

__all__ = ["Arbiter", "Client"]


class Arbiter:
    def register_identify_uuid(self, guest_uuid_trv, host_uuid_trv,
                               conflict_flag_trv):
        self._conflict_flag = conflict_flag_trv
        self._guest_uuid = guest_uuid_trv
        self._host_uuid = host_uuid_trv
        return self

    def validate_uuid(self):
        ind = 0
        while True:
            uuids = [self._guest_uuid.get(idx=0, suffix=ind)]
            uuids += self._host_uuid.get(idx=-1, suffix=ind)
            if len(set(uuids)) == len(uuids):
                self._conflict_flag.remote(obj=True, role=None, idx=-1,
                                           suffix=ind)
                return set(uuids)
            self._conflict_flag.remote(obj=False, role=None, idx=-1,
                                       suffix=ind)
            ind += 1


class Client:
    def register_identify_uuid(self, uuid_transfer_variable,
                               conflict_flag_transfer_variable):
        self._uuid_trv = uuid_transfer_variable
        self._conflict_flag = conflict_flag_transfer_variable
        return self

    def generate_uuid(self):
        ind = 0
        while True:
            uid = str(_uuid.uuid1())
            self._uuid_trv.remote(obj=uid, role=consts.ARBITER, idx=0,
                                  suffix=ind)
            if self._conflict_flag.get(idx=0, suffix=ind):
                return uid
            ind += 1


Guest = Client
Host = Client
