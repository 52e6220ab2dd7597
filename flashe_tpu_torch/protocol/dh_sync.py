"""Diffie-Hellman exchange with arbiter relay and ordinal assignment (port of
flashe_tpu/protocol/dh_sync.py).

Reference framework/homo/sync/jzf_dh_keys_exchange_sync.py:28-73: the
arbiter broadcasts (p, g), gathers (uuid, g^r) from guest+hosts, assigns
each a stable ordinal index (which becomes FLASHE's mask stream index,
jzf_flashe.py:268-275), and rebroadcasts {uuid: (idx, g^r, role, comm_idx)}.
Each client then derives pairwise shared secrets g^{rr'}.
"""

from __future__ import annotations

from flashe_tpu_torch.crypto.dh import DiffieHellman
from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.protocol.scatter import Scatter

__all__ = ["Arbiter", "Client"]


class Arbiter:
    def register_dh_key_exchange(self, dh_pubkey_trv, dh_ciphertext_host_trv,
                                 dh_ciphertext_guest_trv, dh_ciphertext_bc_trv):
        self._pubkey_trv = dh_pubkey_trv
        self._scatter = Scatter(dh_ciphertext_host_trv, dh_ciphertext_guest_trv)
        self._bc_trv = dh_ciphertext_bc_trv
        self.idx_comm_dict = None
        self.comm_idx_dict = None
        return self

    def key_exchange(self):
        p, g = DiffieHellman.key_pair()
        self._pubkey_trv.remote(obj=(int(p), int(g)), role=None, idx=-1)

        pubkey, idx_comm, comm_idx = {}, {}, {}
        for cnt, tu in enumerate(self._scatter.get()):
            # tu = (uuid, g^r, role, comm_idx)
            pubkey[tu[0]] = (cnt,) + tu[1:]
            idx_comm[cnt] = tu[2:]
            comm_idx[tu[2:]] = cnt
        self.idx_comm_dict = idx_comm
        self.comm_idx_dict = comm_idx
        self._bc_trv.remote(obj=pubkey, role=None, idx=-1)
        return pubkey


class Client:
    def register_dh_key_exchange(self, dh_pubkey_trv, dh_ciphertext_trv,
                                 dh_ciphertext_bc_trv):
        self._pubkey_trv = dh_pubkey_trv
        self._ciphertext_trv = dh_ciphertext_trv
        self._bc_trv = dh_ciphertext_bc_trv
        return self

    def key_exchange(self, uuid: str):
        p, g = self._pubkey_trv.get(idx=0)
        r = DiffieHellman.generate_secret(p)
        gr = DiffieHellman.encrypt(g, r, p)
        self._ciphertext_trv.remote((uuid, gr), role=consts.ARBITER, idx=0)

        cipher_texts = self._bc_trv.get(idx=0)
        # {uuid: (idx, shared_secret, role, comm_idx)}
        return {
            uid: (tup[0], DiffieHellman.decrypt(tup[1], r, p)) + tup[2:]
            for uid, tup in cipher_texts.items()
        }


Guest = Client
Host = Client
