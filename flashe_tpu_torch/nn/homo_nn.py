"""HomoNN component: federated NN training over secure aggregation (port of
flashe_tpu/nn/homo_nn.py).

Mirrors federatedml/nn/jzf_homo_nn/enter_point.py:
- HomoNNClient.fit (enter_point.py:158-200): local train for
  aggregate_every_n_epoch epochs -> aggregate_then_get -> install global
  weights -> loss sync -> convergence check,
- HomoNNArbiter.fit (enter_point.py:106-119): aggregate_and_broadcast +
  loss aggregation + convergence broadcast per iteration.  The reference
  deliberately disables early stopping (`and False`, enter_point.py:192);
  here it is a config flag (HomoNNParam.early_stop_enabled).

Every role runs on `device` (the card unless the caller asks for the
CPU): the client's model, optimizer state, codec and cipher block, the
arbiter's block.  A client's local training is a phase of its own ("local
train", runtime/tracking.py) beside the aggregator's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.nn.models import build_model, init_params
from flashe_tpu_torch.nn.trainer import LocalTrainer
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.protocol import aggregator
from flashe_tpu_torch.runtime.config import HomoNNParam
from flashe_tpu_torch.runtime.tracking import phase, set_round, span, tracker

__all__ = ["HomoNNClient", "HomoNNGuest", "HomoNNHost", "HomoNNArbiter"]


class HomoNNClient:
    role = "guest"

    def __init__(self, param: HomoNNParam, seed: int = 0, device="cuda"):
        param.check()
        self.param = param
        self.seed = seed
        self.device = resolve_device(device)
        self.trainer: Optional[LocalTrainer] = None
        self.codec: Optional[WeightsCodec] = None
        self.aggregate_iter = 0
        self.history = []

    def _build(self, input_example):
        model = build_model(self.param.model, device=self.device,
                            **self.param.model_kwargs)
        init_params(model, input_example, seed=0)  # same init on every client
        self.codec = WeightsCodec(model.params_to_flax(), device=self.device)
        self.trainer = LocalTrainer(
            model, optimizer=self.param.optimizer,
            learning_rate=self.param.learning_rate, seed=self.seed,
            label_pad_id=self.param.label_pad_id, device=self.device)

    def fit(self, transfer_variables, x: np.ndarray, y: np.ndarray,
            start_iter: int = 0):
        p = self.param
        if self.trainer is None:
            self._build(x[:1])
        agg = aggregator.with_role(
            self.role, transfer_variables, sparsity=p.sparsity,
            secure_aggregate=p.secure_aggregate,
            secure_aggregate_args=p.secure_aggregate_args.to_dict(),
            device=self.device)
        agg.set_codec(self.codec)

        degree = float(len(x))
        with span("flatten"):
            flat_before = self.codec.flatten(self.trainer.params)
        for it in range(start_iter, p.max_iter):
            set_round(it)
            with phase("local train"):
                train_loss = self.trainer.train(
                    x, y, epochs=p.aggregate_every_n_epoch,
                    batch_size=min(p.batch_size, len(x)))
            with span("flatten"):
                flat = self.codec.flatten(self.trainer.params)
            agg_flat = agg.aggregate_then_get(
                flat, iter_index=it, before=flat_before, degree=degree,
                suffix=(it,))
            if agg_flat is not None:
                with span("unflatten"):
                    weights = self.codec.unflatten(agg_flat)
                self.trainer.set_model_weights(weights)
                flat_before = agg_flat

            if agg_flat is None or agg.was_dropped:
                # dropped this round (missed the upload deadline): the
                # arbiter still shipped the survivors' aggregate (installed
                # above — required to keep quantizer statistics in sync),
                # but will not collect this client's loss; stay in
                # lockstep via the convergence broadcast and rejoin at the
                # next iteration
                agg.get_converge_status(suffix=(it, "conv"))
                tracker().callback_metric("dropped", it, 1.0)
                self.aggregate_iter = it + 1
                continue

            with span("evaluate"):
                loss, acc = self.trainer.evaluate(x, y)
            agg.send_loss(loss * degree, degree=degree, suffix=(it,))
            converged = agg.get_converge_status(suffix=(it, "conv"))
            tracker().callback_metric("train_loss", it, train_loss)
            tracker().callback_metric("eval_loss", it, loss)
            tracker().callback_metric("eval_acc", it, acc)
            self.history.append({"iter": it, "loss": loss, "acc": acc})
            self.aggregate_iter = it + 1
            if converged and p.early_stop_enabled:
                break
        return self.trainer

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.trainer.predict(x)

    def load_model(self, checkpoint_path: str, input_example: np.ndarray):
        """Restore weights + aggregate_iter from a checkpoint (reference
        load_model, enter_point.py:262-269); a subsequent fit(...,
        start_iter=self.aggregate_iter) resumes the federation loop."""
        from flashe_tpu_torch.runtime.checkpoint import load_checkpoint

        if self.trainer is None:
            self._build(input_example)
        state = load_checkpoint(checkpoint_path)
        self.trainer.set_model_weights(state["params"])
        self.aggregate_iter = state["aggregate_iter"]
        return self


class HomoNNGuest(HomoNNClient):
    role = "guest"


class HomoNNHost(HomoNNClient):
    role = "host"


class HomoNNArbiter:
    def __init__(self, param: HomoNNParam, device="cuda"):
        param.check()
        self.param = param
        self.device = resolve_device(device)
        self.loss_history = []

    def fit(self, transfer_variables, start_iter: int = 0):
        p = self.param
        agg = aggregator.with_role(
            "arbiter", transfer_variables, sparsity=p.sparsity,
            secure_aggregate=p.secure_aggregate,
            secure_aggregate_args=p.secure_aggregate_args.to_dict(),
            device=self.device)

        last_loss = None
        for it in range(start_iter, p.max_iter):
            agg.aggregate_and_broadcast(iter_index=it, suffix=(it,))
            mean_loss = agg.aggregate_loss(suffix=(it,))
            self.loss_history.append(mean_loss)
            tracker().callback_metric("mean_loss", it, mean_loss)

            if p.early_stop == "diff" and last_loss is not None:
                converged = abs(mean_loss - last_loss) < p.eps
            elif p.early_stop == "abs":
                converged = mean_loss < p.eps
            else:
                converged = False
            last_loss = mean_loss
            agg.send_converge_status(lambda c=converged: c, (),
                                     suffix=(it, "conv"))
            if converged and p.early_stop_enabled:
                break
        return self.loss_history
