"""Guest+hosts gather with role/ordinal tagging (port of
flashe_tpu/protocol/scatter.py).

Reference framework/homo/util/jzf_scatter.py:40-50 — the jzf variant
appends ("guest", 0) / ("host", host_id) so the arbiter can assign stable
ordinal indices during the DH exchange.  The gather order is fixed, the
guest first and then hosts 0, 1, ... in order, so the arbiter's ordinals
are guest 0 and host h -> 1 + h: they become the FLASHE mask stream indices
(protocol/dh_sync.py), and the telescoping sum depends on them.
"""

from __future__ import annotations

__all__ = ["Scatter"]


class Scatter:
    def __init__(self, host_variable, guest_variable):
        self._host = host_variable
        self._guest = guest_variable

    def get(self, suffix=tuple(), host_ids=None, tagged=True):
        guest_val = self._guest.get(idx=0, suffix=suffix)
        if tagged:
            yield tuple(guest_val) + ("guest", 0)
        else:
            yield guest_val
        if host_ids is None or host_ids == -1:
            n = len(self._host.roles_to_parties(["host"]))
            host_ids = list(range(n))
        for hid in host_ids:
            val = self._host.get(idx=hid, suffix=suffix)
            if tagged:
                yield tuple(val) + ("host", hid)
            else:
                yield val
