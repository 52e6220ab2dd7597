"""The frozen yardsticks tied to the port's shapes and its own arithmetic:
the mask bound equals tools/roofline.py's at the published rates, the
models' lane counts are the port's, and a dense round launches the mask
kernel twice a client."""

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference import femnist_cnn, gru_lm
from flashe_tpu_torch.nn.keras_define import count_params_define
from flashe_tpu_torch.nn.models import build_model
from flashe_tpu_torch.tools import roofline as port_roofline
from flashe_tpu_torch.tools.shakespeare_experiment import gru_define

GRU = {"vocab": 83, "embed": 512, "hidden": 256, "seq_len": 80}


@pytest.mark.parametrize("count,m,streams", [
    (1206590, 20, 2), (654675, 20, 2), (120659, 20, 1), (4194304, 20, 2),
    (1000, 64, 2)])
def test_mask_bound_is_the_programs_at_published_rates(count, m, streams):
    card = port_roofline.Card("H100 SXM", "700 W", 1980.0, 132)
    ms, _ = port_roofline.mask_bound(count, card, m=m, streams=streams)
    assert roofline.mask_bound_s(count, m, streams) * 1e3 == \
        pytest.approx(ms, rel=1e-12)


def test_lanes_are_the_ports():
    fem = femnist_cnn.leaves({"num_classes": 62})
    assert sum(int(np.prod(s)) for s in fem.values()) == 1206590
    model = build_model("femnist_cnn", device="cpu")
    assert {k: tuple(v.shape) for k, v in model.params_to_flax().items()} \
        == fem
    gru = gru_lm.leaves(GRU)
    assert sum(int(np.prod(s)) for s in gru.values()) == 654675
    m = build_model("nn_define", device="cpu", nn_define=gru_define(512, 256))
    assert count_params_define(m, np.zeros((1, 80), np.int32)) == 654675
    assert {k: tuple(v.shape) for k, v in m.params_to_flax().items()} == gru


def test_model_flops():
    assert femnist_cnn.forward_flops({"num_classes": 62}) == 23998208
    assert gru_lm.forward_flops(GRU) == 97771520
    # a FEMNIST round: 10 clients x 128 rows, trained and evaluated
    assert roofline.train_round_flops(23998208, 1280, 1280) == \
        pytest.approx(122.9e9, rel=1e-3)


def test_a_dense_round_launches_the_mask_twice_a_client(tmp_path,
                                                        monkeypatch):
    """Every encrypt and every boundary-pair decrypt is one mask_apply, the
    call the card runs as one double launch."""
    from flashe_tpu_torch.crypto import flashe

    calls = []
    apply = flashe.mask_apply

    def counted(q, *a, **k):
        calls.append(q.shape[0])
        return apply(q, *a, **k)

    monkeypatch.setattr(flashe, "mask_apply", counted)
    from flashe_tpu_torch.protocol import aggregator
    from flashe_tpu_torch.runtime.simulate import run_roles
    from flashe_tpu_torch.nn.weights import WeightsCodec

    args = {"quantize": {"int_bits": 20, "batch": False, "element_bits": 16,
                         "padding": True, "secure": True},
            "mode": "parallel", "num_partitions": 1}
    w = {"a": torch.zeros(300), "b": torch.zeros(7)}
    n, rounds = 3, 2

    def client(trv, role):
        agg = aggregator.with_role(role, trv, secure_aggregate="flashe",
                                   secure_aggregate_args=args, device="cpu")
        agg.set_codec(WeightsCodec(w, device="cpu"))
        g = torch.zeros(307)
        for r in range(rounds):
            g = agg.aggregate_then_get(g + 0.01, iter_index=r, degree=1.0,
                                       suffix=(r,))

    def arbiter(trv):
        agg = aggregator.with_role("arbiter", trv, secure_aggregate="flashe",
                                   secure_aggregate_args=args, device="cpu")
        for r in range(rounds):
            agg.aggregate_and_broadcast(iter_index=r, suffix=(r,))

    run_roles(n - 1, lambda t: client(t, "guest"),
              lambda t, h: client(t, "host"), arbiter)
    assert len(calls) == 2 * n * rounds and set(calls) == {307}
