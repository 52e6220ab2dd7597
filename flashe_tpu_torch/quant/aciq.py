"""ACIQ analytical clipping (Banner et al., NeurIPS'19): the port's copy of
flashe_tpu/quant/aciq.py, which it may not import.

Mirrors federatedml/secureprotol/jzf_aciq.py: the optimal Gaussian clip
ratio table alpha*(bits) and the range-based sigma estimator
sigma = (max-min) * 0.5*0.35*(1+sqrt(pi*ln4)) / sqrt(2 ln size).
The table constants are from the ACIQ paper (public).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ACIQ"]

_ALPHA_GAUS = [
    None, None, 1.710635, 2.151593, 2.559136, 2.936201, 3.286914, 3.615114,
    3.924035, 4.216331, 4.494167, 4.759313, 5.013188, 5.257151, 5.491852,
    5.719160, 5.938345, 6.150141, 6.356593, 6.560495, 6.752936, 6.931921,
    7.106395, 7.350340, 7.482915, 7.691728, 7.668494, 7.583591, 7.583591,
    8.326501, 8.171210, 8.171210,
]

_GAUSSIAN_CONST = (0.5 * 0.35) * (1 + (np.pi * np.log(4)) ** 0.5)


class ACIQ:
    def __init__(self, num_bits: int):
        self.num_bits = num_bits

    def _alpha_opt(self) -> float:
        return _ALPHA_GAUS[31] if self.num_bits > 31 else _ALPHA_GAUS[self.num_bits]

    def get_alpha_gaus(self, vmin: float, vmax: float, size) -> float:
        """Range-based estimate (the non-secure arbiter-assisted path)."""
        sigma = ((vmax - vmin) * _GAUSSIAN_CONST) / ((2 * np.log(size)) ** 0.5)
        return self._alpha_opt() * sigma

    def get_alpha_gaus_direct(self, sigma: float) -> float:
        """Direct from a running std (the secure path)."""
        return self._alpha_opt() * sigma
