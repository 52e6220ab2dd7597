"""Role names (port of flashe_tpu/fed/consts.py; reference
federatedml/util/consts.py:17-19)."""

GUEST = "guest"
HOST = "host"
ARBITER = "arbiter"

ROLES = (GUEST, HOST, ARBITER)
