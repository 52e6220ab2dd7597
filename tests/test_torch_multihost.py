"""PyTorch port: the multi-process paths (parallel/multihost.py,
parallel/mesh_party.py, the mesh conf of `cluster`) and the twins of
__graft_entry__.py's entry points (flashe_tpu_torch/graft.py), on the CPU
over gloo.

- launch_local of parallel/_multihost_child.py, 2 processes x 2 CPU
  devices on gloo: every child checks both rounds against the plain sum
  and prints its backend and devices, and its aggregates' digests equal
  the in-process grid's (parallel/sharded.encrypted_aggregate).
- launch_local of parallel/_mesh_party_child.py, 2 processes on gloo, 3
  rounds of the MLP on each process's default blobs: one model digest, the
  federated loss falling, and every round's loss within 1e-4 of
  plain_mesh_losses, the same rounds in float64 numpy written from the
  JAX package's decode with no mask and no collective, which a wrong
  degree factor, scale or sign in the port's decode would leave far
  behind.
- `cluster --run-local --cpu` of a 2-host mesh conf (MLP, 2 rounds, .npz
  shards of 128 and 128 samples, then of 96 and 160): both mesh-party
  processes exit 0, with one model digest where the degrees are equal,
  and their losses are the plain round's within 1e-4.
- graft.entry()'s logits equal __graft_entry__.entry()'s within 1e-5 on
  the JAX parameters carried across with params_from_flax;
  graft.dryrun_multichip(2) on the CPU twice runs its step and its
  survivor check.
Each spawned group has a timeout of its own.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
from flashe_tpu.quant.aciq import ACIQ as JACIQ
from flashe_tpu_torch import graft
from flashe_tpu_torch.nn.models import build_model, init_params
from flashe_tpu_torch.nn.trainer import LocalTrainer
from flashe_tpu_torch.ops import aes
from flashe_tpu_torch.parallel import multihost, sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "flashe_tpu_torch", "parallel",
                     "_multihost_child.py")
MESH_CHILD = os.path.join(REPO, "flashe_tpu_torch", "parallel",
                          "_mesh_party_child.py")
# the mesh party's losses against plain_mesh_losses: the stochastic
# rounding moves a weight by at most one step of its layer's clip range
# over 2^16 - 1, the loss by far less than this
MESH_LOSS_ATOL = 1e-4


def _digest(t):
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def blobs(process_id, samples):
    """run_mesh_training's default data for a process: 4 classes of 8
    features around fixed centres."""
    rng = np.random.RandomState(1000 + process_id)
    centers = np.random.RandomState(7).randn(4, 8) * 2.0
    y = rng.randint(0, 4, samples).astype(np.int32)
    x = (centers[y] + rng.randn(samples, 8) * 0.7).astype(np.float32)
    return x, y


def plain_mesh_losses(shards, rounds, learning_rate=0.05, element_bits=16):
    """The mesh party's rounds in float64 numpy, written from the JAX
    package's decode (protocol/aggregator.py, get_aggregated_model) and its
    ACIQ, with no mask and no collective, and the stochastic rounding's
    expected value in place of its draws.  Every client trains its MLP on
    its shard (SGD, batches of 32, its trainer seeded by its process id)
    and uploads degree x weights less its running layer means, clipped at
    ACIQ's alpha from its running layer stds and scaled to element_bits;
    each process unquantizes the sum with its own alpha, weights it by
    degree / total degree, adds its means back, takes the new running
    statistics, and divides by its degree.  The round's loss is the
    degree-weighted mean of each process's loss on its own shard."""
    trainers = []
    for pid, (x, _) in enumerate(shards):
        mdl = build_model("mlp", device="cpu")
        init_params(mdl, x[:1], seed=0)
        trainers.append(LocalTrainer(mdl, optimizer="sgd",
                                     learning_rate=learning_rate, seed=pid,
                                     device="cpu"))
    n = len(shards)
    degrees = [float(len(x)) for x, _ in shards]
    total = sum(degrees)
    half_range = ((1 << element_bits) - 1) / 2.0
    aciq = JACIQ(element_bits)

    def alpha(std):
        return aciq.get_alpha_gaus_direct(std) or 0.1

    keys = list(trainers[0].params)
    means = [dict.fromkeys(keys, 0.0) for _ in shards]
    stds = [dict.fromkeys(keys, 1.0) for _ in shards]
    losses = []
    for _ in range(rounds):
        ws = []
        for t, (x, y) in zip(trainers, shards):
            t.train(x, y.astype(np.int64), batch_size=min(32, len(x)))
            ws.append({k: v.double().numpy() for k, v in t.params.items()})
        qsum = {k: sum((np.clip(degrees[i] * ws[i][k] - means[i][k],
                                -alpha(stds[i][k]), alpha(stds[i][k]))
                        + alpha(stds[i][k])) * half_range / alpha(stds[i][k])
                       for i in range(n)) for k in keys}
        for p, t in enumerate(trainers):
            new = {}
            for k in keys:
                a = alpha(stds[p][k]) * n
                agg = qsum[k] * 2.0 * a / (2.0 * half_range * n) - a
                agg = agg * degrees[p] / total + means[p][k]
                means[p][k], stds[p][k] = float(agg.mean()), float(agg.std())
                new[k] = torch.from_numpy(agg / degrees[p]).float()
            t.set_model_weights(new)
        losses.append(sum(d * t.evaluate(x, y.astype(np.int64))[0]
                          for d, t, (x, y) in zip(degrees, trainers, shards))
                      / total)
    return losses


def test_launch_local_matches_the_in_process_grid():
    outs = multihost.launch_local(2, 2, CHILD, ["--elements", "1000"],
                                  timeout=120, device="cpu")
    rows = [re.search(r"^OK .*$", o, re.M).group(0) for o in outs]
    fields = [dict(kv.split("=", 1) for kv in r.split()[1:]
                   if "=" in kv and not kv.startswith("mesh")) for r in rows]
    for pid, f in enumerate(fields):
        assert f["process"] == str(pid)
        assert f["backend"] == "gloo" and f["devices"] == "cpu,cpu"
        assert f"process {pid}: backend gloo, devices ['cpu', 'cpu']" in \
            outs[pid]
    n = sharded.padded_lane_count(1000, 20, 2)
    q = np.random.RandomState(0).randint(0, 1 << 16, (2, n)).astype(
        np.uint32)
    rk = torch.from_numpy(aes.key_schedule(bytes(range(32))).astype(
        np.int32))
    mesh = sharded.make_mesh(2, 2, ["cpu"] * 4)
    q = torch.from_numpy(q.view(np.int32))
    want0 = _digest(sharded.encrypted_aggregate(mesh, rk, q, 0, 20, 2))
    want1 = _digest(sharded.encrypted_aggregate(mesh, rk, q, 1, 20, 2,
                                                survivors=(0,)))
    assert {f["digest0"] for f in fields} == {want0}
    assert {f["digest1"] for f in fields} == {want1}


def test_mesh_party_child_follows_the_plain_round():
    outs = multihost.launch_local(2, 1, MESH_CHILD,
                                  ["--rounds", "3", "--samples", "128"],
                                  timeout=150, device="cpu")
    results = [json.loads(next(line for line in out.splitlines()
                               if line.startswith("RESULT "))[7:])
               for out in outs]
    assert [r["process_id"] for r in results] == [0, 1]
    assert len({r["model_digest"] for r in results}) == 1
    losses = results[0]["loss_history"]
    assert results[1]["loss_history"] == losses
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    want = plain_mesh_losses([blobs(0, 128), blobs(1, 128)], 3)
    np.testing.assert_allclose(losses, want, rtol=0, atol=MESH_LOSS_ATOL)


@pytest.mark.parametrize("sizes", [(128, 128), (96, 160)])
def test_mesh_conf_run_local_on_the_cpu(tmp_path, sizes):
    rng = np.random.RandomState(5)
    shards = []
    hosts = []
    for i, n in enumerate(sizes):
        y = rng.randint(0, 4, n).astype(np.int32)
        x = (rng.randn(4, 8)[y] * 2.0 + rng.randn(n, 8)).astype(np.float32)
        shards.append((x, y))
        np.savez(tmp_path / f"shard{i}.npz", x=x, y=y)
        hosts.append({"host": f"10.0.0.{2 + i}",
                      "data": str(tmp_path / f"shard{i}.npz")})
    conf = {"mesh": {"hosts": hosts, "rounds": 2, "model": "mlp",
                     "learning_rate": 0.05}}
    path = tmp_path / "mesh.json"
    path.write_text(json.dumps(conf))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "flashe_tpu_torch", "cluster", "-c",
         str(path), "--run-local", "--cpu", "--timeout", "150"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "mesh_0": 0, "mesh_1": 0}
    # the two processes share the output, where their lines may run
    # together
    dec = json.JSONDecoder()
    results = [dec.raw_decode(res.stdout, m.start())[0]
               for m in re.finditer(r'\{"loss_history"', res.stdout)]
    assert sorted(r["process_id"] for r in results) == [0, 1]
    if sizes[0] == sizes[1]:
        # under unequal degrees each process keeps its own view (see
        # plain_mesh_losses), as in the JAX package
        assert len({r["model_digest"] for r in results}) == 1
    for r in results:
        assert r["device"] == "cpu" and r["backend"] == "gloo"
        assert r["mesh"] == {"clients": 2, "lanes": 1}
        assert len(r["loss_history"]) == 2
        assert np.all(np.isfinite(r["loss_history"]))
    assert results[0]["loss_history"] == results[1]["loss_history"]
    np.testing.assert_allclose(results[0]["loss_history"],
                               plain_mesh_losses(shards, 2), rtol=0,
                               atol=MESH_LOSS_ATOL)


def test_graft_entry_logits_match_jax():
    jfwd, (jparams, _) = jgraft.entry()
    fwd, (params, x) = graft.entry(device="cpu")
    assert tuple(x.shape) == (8, 28, 28, 1)
    assert sorted(params) == sorted(
        "/".join(k.key for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(jparams)[0])
    xs = np.random.RandomState(0).randn(8, 28, 28, 1).astype(np.float32)
    want = np.asarray(jax.jit(jfwd)(jparams, xs))
    got = fwd(jax.tree_util.tree_map(np.asarray, jparams),
              torch.from_numpy(xs))
    assert got.shape == (8, 62)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_graft_dryrun_multichip_on_two_cpus(capsys):
    graft.dryrun_multichip(2, devices=["cpu"] * 2)
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh={'clients': 2, 'lanes': 1}" in out
    assert "model=MLP" in out and "survivors_checked=True" in out
