"""Loss gather + convergence broadcast (port of
flashe_tpu/protocol/loss_sync.py; reference loss_transfer_sync.py,
is_converge_sync.py)."""

from __future__ import annotations

from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.protocol.scatter import Scatter

__all__ = ["LossArbiter", "LossClient", "ConvergeArbiter", "ConvergeClient"]


class LossArbiter:
    def register_loss_transfer(self, host_loss_transfer, guest_loss_transfer):
        self._scatter = Scatter(host_loss_transfer, guest_loss_transfer)
        return self

    def get_losses(self, idx=None, suffix=tuple()):
        return list(
            self._scatter.get(host_ids=idx, suffix=suffix, tagged=False)
        )


class LossClient:
    def register_loss_transfer(self, loss_transfer):
        self._loss_trv = loss_transfer
        return self

    def send_loss(self, loss, suffix=tuple()):
        self._loss_trv.remote(obj=loss, role=consts.ARBITER, idx=0,
                              suffix=suffix)
        return loss


class ConvergeArbiter:
    def register_is_converge(self, is_converge_variable):
        self._trv = is_converge_variable
        return self

    def check_converge_status(self, converge_func, converge_args,
                              suffix=tuple()):
        is_converge = converge_func(*converge_args)
        self._trv.remote(is_converge, role=None, idx=-1, suffix=suffix)
        return is_converge


class ConvergeClient:
    def register_is_converge(self, is_converge_variable):
        self._trv = is_converge_variable
        return self

    def get_converge_status(self, suffix=tuple()):
        return self._trv.get(idx=0, suffix=suffix)
