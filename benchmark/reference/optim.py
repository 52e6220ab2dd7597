"""Adam as optax.adam(lr) computes it: moments from zero, bias corrections
1 - b^t taken in float32, update -lr mu_hat / (sqrt(nu_hat) + eps)."""

from __future__ import annotations

import torch

__all__ = ["Adam"]


class Adam:
    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        """Update `params` in place from `grads` (same keys)."""
        self.count += 1
        t = torch.tensor(float(self.count))
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** t
        for k, g in grads.items():
            mu, nu = self.mu[k], self.nu[k]
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / bc1.to(mu.device)) / (
                torch.sqrt(nu / bc2.to(nu.device)) + self.eps)
            params[k].add_(-self.lr * u)
