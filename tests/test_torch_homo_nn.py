"""PyTorch port: federated training (flashe_tpu_torch/nn/homo_nn.py over
runtime/simulate.run_roles) and the `submit` command on the CPU.

- Plain aggregation (no quantizer), a guest and two hosts, full batch, 3
  iterations, the port's roles against the JAX package's HomoNN roles over
  its own run_roles, both from the JAX init (carried into the port's
  clients before fit): the loss per round agrees at rtol 1e-4 and the
  final params at atol 1e-5.
- The same MLP under BFV (m = 64), CKKS (N = 64) and the additive pads
  against the port's plain run: BFV equal, bit for bit, to plain with the
  same 16-bit quantizer; CKKS and additive within rtol 1e-6 of plain.
- examples/configs/mlp_flashe.json on the port: every client holds the
  same model after every aggregation, within one quantization step of the
  clients' mean local model.
- A host that sleeps past upload_timeout_s is dropped, installs the
  aggregate, and rejoins.
- `python -m flashe_tpu_torch submit -c mlp_flashe.json --cpu --json`, run
  in this process, prints max_iter losses under the JAX CLI's keys.
"""

from __future__ import annotations

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from flashe_tpu.nn.homo_nn import HomoNNArbiter as JArbiter
from flashe_tpu.nn.homo_nn import HomoNNGuest as JGuest
from flashe_tpu.nn.homo_nn import HomoNNHost as JHost
from flashe_tpu.runtime.config import HomoNNParam as JParam
from flashe_tpu.runtime.simulate import run_roles as jrun_roles
from flashe_tpu_torch.__main__ import main as cli_main
from flashe_tpu_torch.data import federated_dataset
from flashe_tpu_torch.nn import homo_nn
from flashe_tpu_torch.nn.homo_nn import HomoNNArbiter, HomoNNGuest, \
    HomoNNHost
from flashe_tpu_torch.runtime.config import HomoNNParam
from flashe_tpu_torch.runtime.simulate import run_roles
from flashe_tpu_torch.runtime.tracking import tracker

N_HOSTS = 2
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "configs", "mlp_flashe.json")
PLAIN = {"model": "mlp", "model_kwargs": {"features": [16, 10]},
         "secure_aggregate": "plain", "optimizer": "adam",
         "learning_rate": 5e-3, "max_iter": 3, "batch_size": 32}


def _config():
    with open(CONFIG) as f:
        return json.load(f)


def _port_roles(param, shards, init=None, hooks=None):
    """The port's guest, hosts and arbiter on the CPU.  init: flax params
    carried into every client before fit; hooks(client, name) may wrap a
    client's trainer."""

    def client(cls, trv, i, name, seed):
        c = cls(param, seed=seed, device="cpu")
        c._build(shards[i][0][:1])
        if init is not None:
            c.trainer.set_model_weights(init)
        if hooks is not None:
            hooks(c, name)
        c.fit(trv, *shards[i])
        return {"history": c.history, "params": c.trainer.params,
                "metrics": list(tracker().metrics)}

    return run_roles(
        N_HOSTS,
        lambda trv: client(HomoNNGuest, trv, 0, "guest", 0),
        lambda trv, h: client(HomoNNHost, trv, 1 + h, f"host{h}", 1 + h),
        lambda trv: HomoNNArbiter(param, device="cpu").fit(trv),
        timeout=120)


def test_plain_training_matches_the_jax_roles():
    shards = federated_dataset("mlp", N_HOSTS + 1, 32, seed=0)
    jparam = JParam.from_dict(PLAIN)

    def jclient(cls, trv, i, seed):
        c = cls(jparam, seed=seed)
        c.fit(trv, *shards[i])
        return c.trainer.params

    jres = jrun_roles(N_HOSTS, lambda trv: jclient(JGuest, trv, 0, 0),
                      lambda trv, h: jclient(JHost, trv, 1 + h, 1 + h),
                      lambda trv: JArbiter(jparam).fit(trv))
    # every JAX client starts from init_params(model, x[:1], seed=0)
    from flashe_tpu.nn.models import MLP, init_params

    init = jax.tree_util.tree_map(np.asarray, init_params(
        MLP(features=(16, 10)), shards[0][0][:1], seed=0))
    res = _port_roles(HomoNNParam.from_dict(PLAIN), shards, init=init)
    assert len(res["arbiter"]) == 3
    np.testing.assert_allclose(res["arbiter"], jres["arbiter"], rtol=1e-4)
    for layer, d in jres["guest"].items():
        for k, v in d.items():
            np.testing.assert_allclose(res["guest"]["params"][
                f"{layer}/{k}"].numpy(), np.asarray(v), rtol=0, atol=1e-5)
    for name in ("host0", "host1"):
        for k, v in res[name]["params"].items():
            assert torch.equal(v, res["guest"]["params"][k])


_Q16 = {"int_bits": 20, "batch": False, "element_bits": 16,
        "padding": True, "secure": True}


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "additive"])
def test_general_he_training_matches_plain(scheme, monkeypatch):
    """The MLP of test_plain_training_matches_the_jax_roles trained under
    each general-HE baseline at a small ring (BFV m = 64, CKKS N = 64),
    against the same port run under plain aggregation.  BFV quantizes as
    the quantized plain baseline does, with the same quantizer seeds, and
    decrypts the same sums: losses and models equal bit for bit.  CKKS and
    the additive pads aggregate floats: losses within rtol 1e-6 and
    parameters within 1e-6 of the float plain run."""
    shards = federated_dataset("mlp", N_HOSTS + 1, 32, seed=0)
    q = {"quantize": dict(_Q16)} if scheme == "bfv" else {}
    extra = {"ckks": {"poly_modulus_degree": 64}}.get(scheme, {})
    param = HomoNNParam.from_dict(dict(
        PLAIN, secure_aggregate=scheme,
        secure_aggregate_args=dict(q, **extra)))
    if scheme == "bfv":
        # BFV's ring degree is no field of SecureAggregateArgs (as in the
        # JAX dataclass): it goes into the dict that every role reads
        args = param.secure_aggregate_args
        to_dict = args.to_dict
        monkeypatch.setattr(args, "to_dict", lambda: dict(to_dict(), m=64))
    res = _port_roles(param, shards)
    ref = _port_roles(HomoNNParam.from_dict(
        dict(PLAIN, secure_aggregate_args=q)), shards)
    assert len(res["arbiter"]) == 3 and np.all(np.isfinite(res["arbiter"]))
    for name in ("guest", "host0", "host1"):
        for k, v in res[name]["params"].items():
            assert torch.equal(v, res["guest"]["params"][k])
    if scheme == "bfv":
        assert res["arbiter"] == ref["arbiter"]
        for k, v in res["guest"]["params"].items():
            assert torch.equal(v, ref["guest"]["params"][k])
        return
    np.testing.assert_allclose(res["arbiter"], ref["arbiter"], rtol=1e-6)
    for k, v in res["guest"]["params"].items():
        np.testing.assert_allclose(v.numpy(), ref["guest"]["params"][k],
                                   rtol=0, atol=1e-6)


def test_flashe_training_every_client_holds_the_aggregate(monkeypatch):
    cfg = _config()
    param = HomoNNParam.from_dict(cfg["param"])
    shards = federated_dataset(cfg["dataset"], cfg["n_clients"],
                               cfg["samples_per_client"], seed=0)
    recs, real = {}, homo_nn.aggregator.with_role

    def with_role(role, *args, **kw):
        agg = real(role, *args, **kw)
        if role == "arbiter":
            return agg
        rec = recs.setdefault(threading.current_thread().name, [])
        inner, quant = agg.aggregate_then_get, agg._block.quantizer

        def recorded(flat, iter_index, **kw2):
            past_mean = quant.past_mean.copy()
            out = inner(flat, iter_index, **kw2)
            rec.append(dict(flat=flat.clone(), past_mean=past_mean,
                            alpha=np.array(quant.alpha), new=out.clone(),
                            degree=kw2["degree"], codec=agg.codec))
            return out

        agg.aggregate_then_get = recorded
        return agg

    monkeypatch.setattr(homo_nn.aggregator, "with_role", with_role)
    res = _port_roles(param, shards)
    losses = res["arbiter"]
    assert len(losses) == param.max_iter and np.all(np.isfinite(losses))
    names = ["guest"] + [f"host{h}" for h in range(N_HOSTS)]
    for it in range(param.max_iter):
        rounds = [recs[n][it] for n in names]
        first = rounds[0]
        for r in rounds:
            assert torch.equal(r["new"], first["new"])
            assert np.array_equal(r["alpha"], first["alpha"])
        codec, d = first["codec"], first["degree"]
        mean = codec.spread(torch.from_numpy(first["past_mean"]))
        a = codec.spread(torch.from_numpy(first["alpha"]))
        # degree-scaled, normalized, clipped at alpha, averaged, decoded
        clipped = sum(torch.clamp(d * r["flat"] - mean, -a, a)
                      for r in rounds) / len(rounds)
        step = 2 * a / ((1 << 16) - 1)
        off = ((first["new"] - (mean + clipped) / d).abs() * d / step).max()
        assert float(off) <= 1.0, (it, float(off))
    for n in names[1:]:
        for k, v in res[n]["params"].items():
            assert torch.equal(v, res["guest"]["params"][k])


def test_slow_host_is_dropped_and_rejoins(monkeypatch):
    cfg = _config()
    param = HomoNNParam.from_dict(dict(cfg["param"], max_iter=3))
    # SecureAggregateArgs has no deadline field (as the JAX dataclass):
    # the deadline goes into the dict that every role reads
    args = param.secure_aggregate_args
    to_dict = args.to_dict
    monkeypatch.setattr(args, "to_dict",
                        lambda: dict(to_dict(), upload_timeout_s=2.0))
    shards = federated_dataset(cfg["dataset"], N_HOSTS + 1, 48, seed=0)
    slow, sleep_s = "host1", 3.0

    def hooks(client, name):
        # host 1 trains past the deadline in iteration 1; the others take
        # as long before iteration 2, so that its window opens late
        train, calls = client.trainer.train, []
        late = 2 if name == slow else 3

        def slow_train(*args, **kw):
            calls.append(1)
            if len(calls) == late:
                time.sleep(sleep_s)
            return train(*args, **kw)

        client.trainer.train = slow_train

    res = _port_roles(param, shards, hooks=hooks)
    assert len(res["arbiter"]) == 3 and np.all(np.isfinite(res["arbiter"]))
    assert [h["iter"] for h in res[slow]["history"]] == [0, 2]
    assert ("dropped", 1, 1.0) in res[slow]["metrics"]
    for name in ("guest", "host0"):
        assert [h["iter"] for h in res[name]["history"]] == [0, 1, 2]
        assert not any(m[0] == "dropped" for m in res[name]["metrics"])
    for name in ("host0", slow):
        for k, v in res[name]["params"].items():
            assert torch.equal(v, res["guest"]["params"][k])


def test_submit_cli_json(capsys):
    assert cli_main(["submit", "-c", CONFIG, "--cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"loss_per_round", "phases"}
    assert len(out["loss_per_round"]) == _config()["param"]["max_iter"]
    assert np.all(np.isfinite(out["loss_per_round"]))
    assert set(out["phases"]) == {
        "local train", "encoding", "encryption", "upload", "download",
        "decryption", "decoding"}
    for stat in out["phases"].values():
        assert set(stat) == {"total_s", "count"} and stat["count"] == 3


@pytest.mark.parametrize("flag", [
    ["mesh-party", "--num-processes", "1", "--process-id", "0",
     "--rounds", "1", "--samples", "32"],
    ["cluster", "-c", os.path.join(os.path.dirname(CONFIG), "..", "..",
                                   "deploy", "mesh_conf.yml"), "--plan"]])
def test_submit_unported_options_raise(flag, capsys):
    """The two commands that raised until multi-GPU was ported now run:
    `mesh-party` as a group of one process on the CPU (JSON with its
    digest and losses), and the mesh conf's plan (mesh-party commands with
    --cpu).  Without --cpu, mesh-party asks for the card."""
    from flashe_tpu_torch.parallel.multihost import free_port

    if flag[0] == "mesh-party":
        flag = flag + ["--coordinator", f"127.0.0.1:{free_port()}"]
    assert cli_main(flag + ["--cpu"]) == 0
    out = capsys.readouterr().out
    if flag[0] == "mesh-party":
        res = json.loads(out.strip().splitlines()[-1])
        assert res["device"] == "cpu" and res["backend"] == "gloo"
        assert np.all(np.isfinite(res["loss_history"]))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli_main(flag)
    else:
        cmds = [line for line in out.splitlines() if "mesh-party" in line]
        assert len(cmds) == 3
        assert all(c.endswith(" --cpu") for c in cmds)


@pytest.mark.parametrize("server", [[], ["--python"]], ids=["native",
                                                            "python"])
def test_storage_node_cli(tmp_path, server):
    """`storage-node` serves a directory: it prints which server runs and
    its address, a session bound to it keeps a table, and an interrupt
    stops the node (and its native server process) and flushes."""
    import signal
    import subprocess
    import sys

    from flashe_tpu_torch import native
    from flashe_tpu_torch.data.table import init

    if not server and native.kvserver_binary() is None:
        pytest.skip("no compiler for the native storage node")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "flashe_tpu_torch", "storage-node", "--dir",
         str(tmp_path / "node"), "--port", "0", "--cpu"] + server,
        cwd=repo, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        kind = "python" if server else "native"
        assert line.startswith(f"storage node ({kind}) serving "), line
        addr = line.split()[-1]
        s = init("cli", storage_addr=addr)
        t = s.table("t", "ns", partition=2)
        t.put_all((i, i * i) for i in range(10))
        assert t.reduce(lambda a, b: a + b) == 285
        s.stop()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:  # stop its native server too, then kill
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    from flashe_tpu_torch.data.kvstore import open_store

    st = open_store(str(tmp_path / "node" / "ns" / "t"), 2)
    assert sum(st.count(p) for p in range(2)) == 10
    st.close()
