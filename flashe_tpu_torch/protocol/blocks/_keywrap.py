"""Shared session-setup plumbing for keyed cipher blocks (port of
flashe_tpu/protocol/blocks/_keywrap.py, on the port's AES-256-CTR,
crypto/aes_host.py).

Every keyed scheme follows the same choreography (reference
jzf_{flashe,paillier,bfv,ckks}_block.py): uuid sync -> DH exchange ->
guest generates key material -> AES-CTR-wraps the private part per host
under the pairwise DH secret -> arbiter relays wrapped blobs by comm idx
and counts clients -> broadcast num_clients.
"""

from __future__ import annotations

from flashe_tpu_torch.crypto.aes_host import AESCipher
from flashe_tpu_torch.fed import consts

__all__ = ["guest_wrap_for_hosts", "host_unwrap", "arbiter_relay",
           "broadcast_num_clients", "receive_num_clients"]


def guest_wrap_for_hosts(exchanged_keys: dict, secret_blob: bytes) -> dict:
    """{host_comm_idx: AES-CTR(secret under pairwise DH secret)}."""
    sharing = {}
    for _, tup in exchanged_keys.items():
        if tup[2] == "guest":
            continue
        aes = AESCipher()
        aes.generate_key(256, assigned_key=tup[1], mode="CTR")
        sharing[tup[3]] = aes.encrypt(secret_blob)
    return sharing


def host_unwrap(exchanged_keys: dict, guest_uuid: str,
                wrapped: bytes) -> bytes:
    secret = exchanged_keys[guest_uuid][1]
    aes = AESCipher()
    aes.generate_key(256, assigned_key=secret, mode="CTR")
    return aes.decrypt(wrapped)


def arbiter_relay(trv, suffix=("seed",)) -> int:
    """Forward guest's wrapped blobs to hosts; return client count."""
    sharing = trv.guest_to_arbiter.get(idx=0, suffix=suffix)
    cnt = 1
    for comm_idx, blob in sharing.items():
        cnt += 1
        trv.arbiter_to_host.remote(obj=blob, role=consts.HOST,
                                   idx=comm_idx, suffix=suffix)
    return cnt


def broadcast_num_clients(trv, client_cnt: int):
    trv.arbiter_to_guest.remote(obj=client_cnt, role=consts.GUEST, idx=0,
                                suffix=("num_clients",))
    trv.arbiter_to_host.remote(obj=client_cnt, role=consts.HOST, idx=-1,
                               suffix=("num_clients",))


def receive_num_clients(from_arbiter) -> int:
    return from_arbiter.get(idx=0, suffix=("num_clients",))
