"""Federated k-fold cross-validation for the HomoNN component (port of
flashe_tpu/nn/cross_validation.py; every fold's roles run on `device`).

The reference's ModelBase lifecycle dispatches fit / predict /
cross-validation (federatedml/model_base.py:74-103); its CV arm splits
each party's *local* data into k folds and runs the full federated fit
per fold, scoring on the held-out fold.  Here each fold runs under its
own federation scope (`Federation.scoped(f"cv{f}")` — an isolated tag
namespace, the analogue of FATE's per-fold flow id), so fold f+1's
session setup can never collide with fold f's in-flight tags.

Clients must agree on n_splits/shuffle/seed (they come from the shared
job conf), but each client shuffles only its own indices — no data or
index material crosses party boundaries beyond the normal aggregation
protocol.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from flashe_tpu_torch.runtime.config import HomoNNParam
from flashe_tpu_torch.runtime.tracking import tracker

__all__ = ["kfold_indices", "cv_fit_client", "cv_fit_arbiter"]


def kfold_indices(n: int, n_splits: int, shuffle: bool = True,
                  seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, test_idx) per fold; fold sizes differ by at most 1."""
    if n < n_splits:
        raise ValueError(f"cannot split {n} samples into {n_splits} folds")
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    folds, start = [], 0
    for s in sizes:
        test = idx[start : start + s]
        train = np.concatenate([idx[:start], idx[start + s :]])
        folds.append((train, test))
        start += s
    return folds


def cv_fit_client(client_cls, param: HomoNNParam, transfer_variables,
                  x: np.ndarray, y: np.ndarray, seed: int = 0,
                  device="cuda") -> dict:
    """Run the federated fit once per fold; return per-fold held-out
    metrics plus their mean (the client side of the CV dispatch)."""
    cv = param.cv
    folds = kfold_indices(len(x), cv.n_splits, cv.shuffle, cv.random_seed)
    fold_results = []
    for f, (tr, te) in enumerate(folds):
        trv = transfer_variables.__class__(
            transfer_variables.federation.scoped(f"cv{f}"))
        client = client_cls(param, seed=seed + f, device=device)
        client.fit(trv, x[tr], y[tr])
        loss, acc = client.trainer.evaluate(x[te], y[te])
        tracker().callback_metric("cv_fold_loss", f, loss)
        tracker().callback_metric("cv_fold_acc", f, acc)
        fold_results.append({"fold": f, "loss": float(loss),
                             "acc": float(acc),
                             "n_train": int(len(tr)),
                             "n_test": int(len(te))})
    return {
        "n_splits": cv.n_splits,
        "folds": fold_results,
        "mean_loss": float(np.mean([r["loss"] for r in fold_results])),
        "mean_acc": float(np.mean([r["acc"] for r in fold_results])),
    }


def cv_fit_arbiter(arbiter_cls, param: HomoNNParam,
                   transfer_variables, device="cuda") -> dict:
    """Arbiter side: one aggregation session per fold."""
    histories = []
    for f in range(param.cv.n_splits):
        trv = transfer_variables.__class__(
            transfer_variables.federation.scoped(f"cv{f}"))
        arbiter = arbiter_cls(param, device=device)
        histories.append(arbiter.fit(trv))
    return {"n_splits": param.cv.n_splits, "loss_histories": histories}
