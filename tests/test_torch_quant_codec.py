"""PyTorch port: FemnistCNN, the weights codec, the lane packing and the
quantizer against the JAX package on the CPU.  Both packages get the same
uniforms (drawn with jax.random from the JAX client's own key) for the
stochastic rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.nn import models as jmodels
from flashe_tpu.nn.weights import WeightsCodec as JCodec
from flashe_tpu.ops import lanes as jlanes
from flashe_tpu.ops import quantize as jq
from flashe_tpu.quant import quantizer as jquant
from flashe_tpu_torch.nn.models import FemnistCNN
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops import quantize as pq
from flashe_tpu_torch.quant import quantizer as pquant

N_FEMNIST = 1_206_590


@pytest.fixture(scope="module")
def femnist():
    params = jmodels.init_params(jmodels.FemnistCNN(),
                                 jnp.zeros((4, 28, 28, 1)), seed=0)
    return params, jax.tree_util.tree_map(np.asarray, params)


def _named(tree):
    return {f"{layer}/{k}": v for layer, d in tree.items() for k, v in d.items()}


def test_femnist_params_roundtrip_flax(femnist):
    _, np_params = femnist
    model = FemnistCNN(device="cpu")
    model.params_from_flax(np_params)
    assert sum(p.numel() for p in model.parameters()) == N_FEMNIST
    back = model.params_to_flax()
    for name, want in _named(np_params).items():
        np.testing.assert_array_equal(back[name].numpy(), want)


def test_femnist_logits_match_flax(femnist):
    params, np_params = femnist
    x = np.random.default_rng(0).standard_normal((4, 28, 28, 1)).astype(
        np.float32)
    want = np.asarray(jmodels.FemnistCNN().apply({"params": params}, x))
    model = FemnistCNN(device="cpu").eval()
    model.params_from_flax(np_params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 62)
    # the convolutions and dense layers sum in another order than XLA's
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_codec_matches_jax(femnist):
    params, np_params = femnist
    jc = JCodec(params)
    model = FemnistCNN(device="cpu")
    model.params_from_flax(np_params)
    pc = WeightsCodec(model.params_to_flax(), device="cpu")
    assert pc.keys == jc.keys and pc.total == jc.total == N_FEMNIST
    assert pc.sizes == jc.sizes
    np.testing.assert_array_equal(pc.segment_ids.numpy(),
                                  np.asarray(jc.segment_ids))

    flat = pc.flatten(model.params_to_flax())
    jflat = np.asarray(jc.flatten(params))
    np.testing.assert_array_equal(flat.numpy(), jflat)

    rng = np.random.default_rng(3)
    new = rng.standard_normal(pc.total).astype(np.float32)
    got = pc.unflatten(torch.from_numpy(new))
    want = _named(jax.tree_util.tree_map(np.asarray, jc.unflatten(new)))
    assert list(got) == list(model.params_to_flax())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)

    per_layer = rng.standard_normal(pc.n_layers).astype(np.float32)
    np.testing.assert_array_equal(
        pc.spread(torch.from_numpy(per_layer)).numpy(),
        np.asarray(jc.spread(jnp.asarray(per_layer))))

    # The port sums each layer's slice, in another order than
    # jax.ops.segment_sum, which runs through the elements one by one in
    # float32 and drifts on long layers (3.2e-4 relative in the std of the
    # 1,179,648-element Dense_0 kernel here).  Both are held to float64: the
    # port within 1e-6, and never further from it than JAX is.
    mean, std = pc.layer_mean_std(torch.from_numpy(new))
    jmean, jstd = jc.layer_mean_std(jnp.asarray(new))
    layers = np.split(new.astype(np.float64), pc.offsets[1:-1])
    mean64 = np.array([x.mean() for x in layers])
    std64 = np.array([x.std() for x in layers])
    np.testing.assert_allclose(mean.numpy(), mean64, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(std.numpy(), std64, rtol=1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-7)
    assert np.all(np.abs(std.numpy() - std64)
                  <= np.abs(np.asarray(jstd) - std64) + 1e-7)


def test_quantize_flat_same_uniforms_is_bit_exact():
    rng = np.random.default_rng(5)
    n = 50_000
    x = (rng.standard_normal(n) * 2).astype(np.float32)
    alpha = np.repeat(rng.uniform(0.5, 4, 5).astype(np.float32), n // 5)
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, (n,), dtype=jnp.float32))
    want = np.asarray(jquant._quantize_flat(jnp.asarray(x), jnp.asarray(alpha),
                                            16, key))
    got = pquant._quantize_flat(torch.from_numpy(x), torch.from_numpy(alpha),
                                16, torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)

    want_asym = np.asarray(jq.quantize_asym(jnp.asarray(x), 1.5, 16, key))
    got_asym = pq.quantize_asym(torch.from_numpy(x), 1.5, 16,
                                torch.from_numpy(u))
    np.testing.assert_array_equal(got_asym.numpy().astype(np.uint32),
                                  want_asym)


def test_unquantize_matches_jax():
    rng = np.random.default_rng(6)
    n, clients = 10_000, 7
    q = rng.integers(0, clients * 65535, n).astype(np.uint32)
    alpha = np.repeat(rng.uniform(0.5, 4, 4).astype(np.float32), n // 4)
    want = np.asarray(jquant._unquantize_flat(jnp.asarray(q),
                                              jnp.asarray(alpha), 16, clients))
    qt = torch.from_numpy(q.view(np.int32))
    got = pquant._unquantize_flat(qt, torch.from_numpy(alpha), 16, clients)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        pq.unquantize_asym(qt, 1.25, 16, clients).numpy(),
        np.asarray(jq.unquantize_asym(jnp.asarray(q), 1.25, 16, clients)),
        rtol=1e-6, atol=1e-6)


def test_twos_complement_matches_jax():
    v = np.array([-5, -1, 0, 1, 7, (1 << 19) - 1, -(1 << 19)], np.int64)
    enc = pq.true_to_two(torch.from_numpy(v), 20)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jq.true_to_two(v, 20)))
    np.testing.assert_array_equal(pq.two_to_true(enc, 20).numpy(), v)


def test_quantizing_client_matches_jax():
    """compute_alphas -> normalize -> quantize -> unquantize -> unnormalize on
    a 3-layer template, over two rounds so the running stats feed back."""
    rng = np.random.default_rng(8)
    template = {"Dense_0/kernel": np.zeros((12, 5), np.float32),
                "Dense_0/bias": np.zeros((5,), np.float32),
                "Dense_1/kernel": np.zeros((5, 3), np.float32)}
    jtree = {"Dense_0": {"kernel": template["Dense_0/kernel"],
                         "bias": template["Dense_0/bias"]},
             "Dense_1": {"kernel": template["Dense_1/kernel"]}}
    pc = WeightsCodec({k: torch.from_numpy(v) for k, v in template.items()},
                      device="cpu")
    jc = JCodec(jtree)
    port = pquant.QuantizingClient(20, False, 16, True, True, seed=2, device="cpu")
    ref = jquant.QuantizingClient(20, False, 16, True, True, seed=2)
    for c, codec in ((port, pc), (ref, jc)):
        c.set_num_clients(3)
        c.set_codec(codec)
    for _ in range(2):
        flat = (rng.standard_normal(pc.total) * 0.3).astype(np.float32)
        _, k = jax.random.split(ref._key)
        u = np.array(jax.random.uniform(k, (pc.total,), dtype=jnp.float32))
        jnorm = ref.normalize(jnp.asarray(flat))
        norm = port.normalize(torch.from_numpy(flat))
        np.testing.assert_array_equal(norm.numpy(), np.asarray(jnorm))
        q = port.quantize(norm, uniforms=torch.from_numpy(u))
        jq_ = ref.quantize(jnorm)
        np.testing.assert_array_equal(q.numpy().astype(np.uint32),
                                      np.asarray(jq_))
        np.testing.assert_array_equal(port.alpha, ref.alpha)
        summed = q * 3  # stands in for a 3-client aggregate
        got = port.unnormalize(port.unquantize(summed) / 3)
        want = ref.unnormalize(ref.unquantize(jnp.asarray(
            np.asarray(summed).astype(np.uint32))) / 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(port.past_mean, ref.past_mean, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(port.past_std, ref.past_std, rtol=1e-5)
        # the layer sums differ in order, so the stats agree only to
        # rounding: start the next round from the same stats to keep its
        # normalize and quantize bit-exact
        port.past_mean = np.asarray(ref.past_mean).copy()
        port.past_std = np.asarray(ref.past_std).copy()


def test_quantized_zero_and_generator_draws():
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        u = float(jax.random.uniform(key, ()))
        assert pquant.quantized_zero(16, u) == jquant.quantized_zero(16, key)
    assert pquant.quantized_zero(16, 0.0) == 32767
    assert pquant.quantized_zero(16, 0.75) == 32768
    a = pquant.QuantizingClient(20, False, 16, True, True, seed=4, device="cpu")
    b = pquant.QuantizingClient(20, False, 16, True, True, seed=4, device="cpu")
    assert a.quantized_zero() == b.quantized_zero()
    assert torch.equal(torch.rand(8, generator=a.generator),
                       torch.rand(8, generator=b.generator))


# (int_bits, element_bits, factor): the production Paillier lane (bs 100,
# 63 limbs, fields straddling limbs), a short multi-limb lane, one limb
@pytest.mark.parametrize("int_bits,eb,factor", [(2000, 16, 4), (240, 16, 2),
                                                (20, 16, 4)])
@pytest.mark.parametrize("n", [1, 99, 100, 101, 12_345])
def test_batch_lanes_match_jax(int_bits, eb, factor, n):
    rng = np.random.default_rng(n + int_bits)
    q = rng.integers(0, 1 << (eb + factor), n).astype(np.uint32)
    q[:3] = [(1 << (eb + factor)) - 1, 0, 1][:n]
    got = pq.batch_lanes(torch.from_numpy(q.view(np.int32)), int_bits, eb,
                         factor)
    want = np.asarray(jq.batch_lanes(jnp.asarray(q), int_bits, eb, factor))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, jq.batch_lanes_np(q, int_bits, eb,
                                                          factor))
    back = pq.unbatch_lanes(got, n, int_bits, eb, factor)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), q)
    np.testing.assert_array_equal(
        back.numpy().view(np.uint32),
        np.asarray(jq.unbatch_lanes(jnp.asarray(want), n, int_bits, eb,
                                    factor)))


def test_unbatch_lanes_of_a_sum_matches_jax():
    """Summed lanes (what a decrypt returns) unpack to per-element sums;
    any bits of an unused top field are ignored."""
    int_bits, eb, factor, n = 2000, 16, 4, 12_345
    rng = np.random.default_rng(31)
    qs = [rng.integers(0, 1 << eb, n).astype(np.uint32) for _ in range(10)]
    ints = sum(jlanes.lanes_to_ints(jq.batch_lanes_np(q, int_bits, eb,
                                                      factor), int_bits)
               for q in qs)
    lanes = jlanes.ints_to_lanes(ints, int_bits)
    got = pq.unbatch_lanes(torch.from_numpy(lanes.view(np.int32)), n,
                           int_bits, eb, factor)
    want = np.asarray(jq.unbatch_lanes(jnp.asarray(lanes), n, int_bits, eb,
                                       factor))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, sum(q.astype(np.int64) for q in qs))


def test_quantizing_client_batch_matches_jax():
    """batch=True: quantize packs into 240-bit lanes, unquantize unpacks a
    3-client sum first; the same uniforms give the same lanes."""
    rng = np.random.default_rng(32)
    template = {"Dense_0/kernel": np.zeros((40, 5), np.float32),
                "Dense_0/bias": np.zeros((5,), np.float32)}
    jtree = {"Dense_0": {"kernel": template["Dense_0/kernel"],
                         "bias": template["Dense_0/bias"]}}
    pc = WeightsCodec({k: torch.from_numpy(v) for k, v in template.items()},
                      device="cpu")
    port = pquant.QuantizingClient(240, True, 16, True, True, seed=3, device="cpu")
    ref = jquant.QuantizingClient(240, True, 16, True, True, seed=3)
    for c, codec in ((port, pc), (ref, JCodec(jtree))):
        c.set_num_clients(3)
        c.set_codec(codec)
    flat = (rng.standard_normal(pc.total) * 0.3).astype(np.float32)
    _, k = jax.random.split(ref._key)
    u = np.array(jax.random.uniform(k, (pc.total,), dtype=jnp.float32))
    q = port.quantize(port.normalize(torch.from_numpy(flat)),
                      uniforms=torch.from_numpy(u))
    jq_ = np.asarray(ref.quantize(ref.normalize(jnp.asarray(flat))))
    assert tuple(q.shape) == jq_.shape == (-(-pc.total // 13), 8)
    np.testing.assert_array_equal(q.numpy().view(np.uint32), jq_)
    summed = (jq_.astype(np.uint64) * 3).astype(np.uint32)  # 3 equal clients
    got = port.unquantize(torch.from_numpy(summed.view(np.int32)))
    want = ref.unquantize(jnp.asarray(summed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
