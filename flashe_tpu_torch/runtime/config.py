"""Job configuration (port of flashe_tpu/runtime/config.py; reference
param/jzf_homo_nn_param.py + the secure_aggregate_args surface of
examples/configs/*/train_job_conf.json).

Validation mirrors BaseParam.check (jzf_homo_nn_param.py:92-98): scheme
names, quantizer bit widths, masking modes and flow-control settings are
checked at construction so misconfiguration fails before any federation
traffic.

The classes and their dict forms are the JAX package's, value for value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["QuantizeConfig", "SecureAggregateArgs", "CVParam",
           "HomoNNParam"]

_SCHEMES = ("plain", "flashe", "paillier", "bfv", "ckks", "additive")
_MASKS = ("double", "single", "dynamic")
_MODES = ("parallel", "serial")


@dataclasses.dataclass
class QuantizeConfig:
    int_bits: int = 20
    batch: bool = False
    element_bits: int = 16
    padding: bool = True
    secure: bool = True

    def check(self):
        if self.element_bits < 2 or self.element_bits > 31:
            raise ValueError("element_bits must be in [2, 31]")
        if self.int_bits < self.element_bits:
            raise ValueError("int_bits must be >= element_bits")
        if not self.padding:
            raise ValueError(
                "only the padding+asymmetric quantizer is supported (the "
                "reference's non-padding paths are dead code, "
                "jzf_quantize.py:76-99)")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SecureAggregateArgs:
    quantize: Optional[QuantizeConfig] = None
    precompute_enable: bool = False
    precompute_num_params: Optional[int] = None
    mask: str = "double"
    mode: str = "parallel"
    num_partitions: int = 1
    wire_pack: bool = False
    # >1 (or "all"): flashe parties shard encrypt/decrypt over that many
    # local devices (parallel/party.LocalLaneMesh)
    local_lane_shards: Optional[Any] = None
    # scheme-specific knobs (paillier key size, BFV/CKKS ring params)
    key_length: int = 2048
    poly_modulus_degree: int = 8192

    def check(self):
        if self.mask not in _MASKS:
            raise ValueError(f"mask must be one of {_MASKS}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}")
        if self.num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        if self.local_lane_shards is not None:
            if self.local_lane_shards != "all" and (
                not isinstance(self.local_lane_shards, int)
                or self.local_lane_shards < 1
            ):
                raise ValueError(
                    "local_lane_shards must be a positive int or 'all'")
        if self.quantize is not None:
            self.quantize.check()

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "mode": self.mode,
            "num_partitions": self.num_partitions,
            "wire_pack": self.wire_pack,
            "mask": self.mask,
            "precompute": {
                "enable": self.precompute_enable,
                "num_params": self.precompute_num_params,
            },
            "key_length": self.key_length,
            "poly_modulus_degree": self.poly_modulus_degree,
        }
        if self.local_lane_shards is not None:
            d["local_lane_shards"] = self.local_lane_shards
        if self.quantize is not None:
            d["quantize"] = self.quantize.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SecureAggregateArgs":
        q = d.get("quantize")
        pre = d.get("precompute", {}) or {}
        return cls(
            quantize=QuantizeConfig(**q) if q else None,
            precompute_enable=pre.get("enable", False),
            precompute_num_params=pre.get("num_params"),
            mask=d.get("mask", "double"),
            mode=d.get("mode", "parallel"),
            num_partitions=d.get("num_partitions", 1),
            wire_pack=d.get("wire_pack", False),
            local_lane_shards=d.get("local_lane_shards"),
            key_length=d.get("key_length", 2048),
            poly_modulus_degree=d.get("poly_modulus_degree", 8192),
        )


@dataclasses.dataclass
class CVParam:
    """Cross-validation parameters (the reference ModelBase's
    cross-validation dispatch arm, federatedml/model_base.py:74-103,
    with FATE's CrossValidationParam surface)."""

    need_cv: bool = False
    n_splits: int = 5
    shuffle: bool = True
    random_seed: int = 0

    def check(self):
        if self.need_cv and self.n_splits < 2:
            raise ValueError("cv.n_splits must be >= 2")


@dataclasses.dataclass
class HomoNNParam:
    """The JZFHomoNN component parameter set (jzf_homo_nn_param.py:57-98)."""

    model: str = "mlp"  # registry name (replaces Keras nn_define JSON)
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    secure_aggregate: str = "flashe"
    secure_aggregate_args: SecureAggregateArgs = dataclasses.field(
        default_factory=SecureAggregateArgs)
    sparsity: float = 1.0
    optimizer: str = "adam"
    learning_rate: float = 5e-4
    loss: str = "categorical_crossentropy"
    max_iter: int = 10
    batch_size: int = 128
    aggregate_every_n_epoch: int = 1
    early_stop: str = "diff"
    eps: float = 1e-4
    early_stop_enabled: bool = False  # the reference hard-disables early
    # stopping with `and False` (enter_point.py:192); opt back in here
    label_pad_id: Optional[int] = None  # sequence workloads: mask loss
    # at padded positions (the nn_define's Embedding mask_zero: true)
    cv: CVParam = dataclasses.field(default_factory=CVParam)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["secure_aggregate_args"] = self.secure_aggregate_args.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HomoNNParam":
        d = dict(d)
        d["secure_aggregate_args"] = SecureAggregateArgs.from_dict(
            d.get("secure_aggregate_args", {}))
        cv = d.get("cv")
        if isinstance(cv, dict):
            d["cv"] = CVParam(**cv)
        return cls(**d)

    def check(self):
        if self.secure_aggregate not in _SCHEMES:
            raise ValueError(
                f"secure_aggregate must be one of {_SCHEMES}")
        if not (0.0 < self.sparsity <= 1.0):
            raise ValueError("sparsity must be in (0, 1]")
        if self.max_iter <= 0 or self.batch_size <= 0:
            raise ValueError("max_iter and batch_size must be positive")
        self.secure_aggregate_args.check()
        self.cv.check()
        if self.sparsity != 1.0:
            # sparsification composes with flashe (compact-counter masks),
            # plain, and paillier (encrypted-zero filler — the reference's
            # cnn_paillier_q16_b1_pad_s100 config); bfv/ckks pack many
            # elements per ciphertext slot so per-position densification
            # is meaningless, and quantizer batching would interleave
            # selected/unselected elements inside one lane
            if self.secure_aggregate in ("bfv", "ckks", "additive"):
                raise ValueError(
                    f"sparsity < 1.0 is not supported with "
                    f"secure_aggregate={self.secure_aggregate!r} (use "
                    f"flashe, plain, or paillier; slot-packed HE schemes "
                    f"cannot densify per-position sparse uploads)")
            q = self.secure_aggregate_args.quantize
            if q is not None and q.batch:
                raise ValueError(
                    "sparsity < 1.0 is incompatible with quantize.batch "
                    "(batched lanes interleave selected and unselected "
                    "elements; the reference sparse configs all use "
                    "batch=false, e.g. cnn_flashe_q16_b1_pad_no_pre_"
                    "s100_dyn)")
        if self.secure_aggregate in ("flashe", "plain") and (
            self.secure_aggregate != "plain"
            and self.secure_aggregate_args.quantize is None
        ):
            raise ValueError(f"{self.secure_aggregate} requires quantize args")
