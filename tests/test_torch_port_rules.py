"""PyTorch port: the rules every module of flashe_tpu_torch keeps.

- It imports nothing of the JAX package and no jax, and neither does
  chip_smoke.py, which runs on a machine without them, nor the task
  executor process that the job runner spawns, whose command names the
  port's executor.
- Its ACIQ and its job configuration are copies of the JAX package's,
  value for value.
- Its entry points run on the card unless the caller asks for the CPU: the
  ciphers (FLASHE, Paillier, BFV, CKKS, the random pads) and the RNS
  context, the codec and models, the quantizer, the session blocks, the
  federated round's roles (`with_role`, the role classes), the roles that
  run_roles runs, the trainer and the HomoNN roles, the Keras nn_define
  interpreter, the DSL job in process and across processes, the job runner
  and a task config with no "device", the job server (`JobServer`,
  `serve`), the cluster's party config and party (`build_party_cfg`,
  `run_party`, `party`), `cluster --run-local`, and the scheme-comparison
  harness (its CLI, `measure_scheme`, `measure_train_step`,
  `check_flashe_sum`), and the multi-device entry points (`make_mesh`,
  `encrypted_aggregate` on its mesh, `LocalLaneMesh`, `DeviceFanout`,
  `run_mesh_training`, `mesh-party`, `dryrun_multichip`), which default to
  every visible card.  The table data plane, `storage-node` and the
  Paillier float facade are host code that touches no card.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flashe_tpu.quant import aciq as jaciq
from flashe_tpu.runtime import config as jconfig
from flashe_tpu_torch.crypto.bfv import BFVCipher
from flashe_tpu_torch.crypto.ckks import CKKSCipher
from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.crypto.paillier import PaillierCipher, PaillierKeypair
from flashe_tpu_torch.crypto.random_pads import PadsCipher, RandomPads
from flashe_tpu_torch.nn import homo_nn
from flashe_tpu_torch.nn import models as pmodels
from flashe_tpu_torch.nn.keras_define import KerasDefineModel, from_nn_define
from flashe_tpu_torch.nn.models import FemnistCNN
from flashe_tpu_torch.nn.trainer import LocalTrainer
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops.modmath import MontCtx, PairMontCtx
from flashe_tpu_torch.ops.ntt import RnsContext
from flashe_tpu_torch.protocol import aggregator
from flashe_tpu_torch.protocol.blocks import additive as ablocks
from flashe_tpu_torch.protocol.blocks import bfv as bblocks
from flashe_tpu_torch.protocol.blocks import ckks as cblocks
from flashe_tpu_torch.protocol.blocks import flashe as fblocks
from flashe_tpu_torch.protocol.blocks import paillier as pblocks
from flashe_tpu_torch.protocol.blocks import plain as plblocks
from flashe_tpu_torch.protocol.blocks.flashe import choose_masking
from flashe_tpu_torch.__main__ import main as cli_main
from flashe_tpu_torch.runtime import cluster as pcluster
from flashe_tpu_torch.runtime import config as pconfig
from flashe_tpu_torch.runtime import job as pjob
from flashe_tpu_torch.runtime.config import HomoNNParam
from flashe_tpu_torch.runtime.dsl import run_dsl_job
from flashe_tpu_torch.runtime.server import JobServer
from flashe_tpu_torch.runtime.simulate import run_roles
from flashe_tpu_torch.runtime.task_executor import run_task
from flashe_tpu_torch.tools import compare_schemes, shakespeare_experiment
from flashe_tpu_torch import graft
from flashe_tpu_torch.parallel import mesh_party, sharded
from flashe_tpu_torch.parallel.fanout import DeviceFanout
from flashe_tpu_torch.parallel.party import LocalLaneMesh
from flashe_tpu_torch.quant import aciq as paciq
from flashe_tpu_torch.quant import quantizer as pquant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import flashe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(flashe_tpu_torch.__path__,
                                               "flashe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "flashe_tpu"
             or m.startswith("flashe_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "flashe_tpu_torch.quant.aciq" in out["modules"]
    assert "flashe_tpu_torch.ops.montgomery" in out["modules"]
    assert "flashe_tpu_torch.protocol.sparsify" in out["modules"]
    for name in ("fed.tcp", "fed.inmem", "fed.variables", "crypto.aes_host",
                 "crypto.dh", "protocol.payload", "protocol.dh_sync",
                 "protocol.blocks.plain", "runtime.simulate",
                 "runtime.config", "data", "nn.models", "nn.trainer",
                 "nn.homo_nn", "runtime.checkpoint", "__main__", "ops.ntt",
                 "crypto.bfv", "crypto.ckks", "crypto.random_pads",
                 "protocol.blocks.bfv", "protocol.blocks.ckks",
                 "protocol.blocks.additive", "runtime.job_manager",
                 "runtime.permission", "runtime.model_manager", "data.io",
                 "data.store", "nn.evaluation", "nn.cross_validation",
                 "nn.keras_define", "runtime.dsl", "runtime.task_executor",
                 "runtime.job", "runtime.board", "runtime.webboard",
                 "runtime.apps", "runtime.client", "runtime.server",
                 "runtime.cluster", "native", "data.codec", "data.kvstore",
                 "data.egg", "data.remote_kv", "data.table",
                 "crypto.fixedpoint", "crypto.encrypt_mode",
                 "tools.compare_schemes", "tools.roofline", "tools.bench",
                 "tools.timing", "tools.ceiling", "tools.schemes", "graft",
                 "parallel.sharded", "parallel.party", "parallel.fanout",
                 "parallel.multihost", "parallel.mesh_party",
                 "parallel._multihost_child", "parallel._mesh_party_child"):
        assert f"flashe_tpu_torch.{name}" in out["modules"]
    assert out["bad"] == []


def test_job_runner_spawns_the_ports_executor(tmp_path, monkeypatch):
    """The runner's child command names the port's task executor, from the
    repository root, and that command loads neither jax nor flashe_tpu."""
    assert pjob.EXECUTOR == "flashe_tpu_torch.runtime.task_executor"
    spawned = []
    real_popen = subprocess.Popen

    class Spawned(Exception):
        pass

    def popen(argv, **kw):
        if argv[0] != sys.executable:  # the native broker (or its g++)
            return real_popen(argv, **kw)
        spawned.append((argv, kw["cwd"]))
        raise Spawned

    with monkeypatch.context() as m, pytest.raises(Spawned):
        m.setattr(pjob.subprocess, "Popen", popen)
        pjob.submit_job(HomoNNParam(secure_aggregate="plain"),
                        [(np.zeros((2, 3), np.float32), np.zeros(2))] * 2,
                        registry=pjob.JobRegistry(str(tmp_path)),
                        device="cpu")
    (argv, cwd), = spawned
    assert argv[:4] == [sys.executable, "-m", pjob.EXECUTOR, "-c"]
    assert cwd == REPO
    assert not any("flashe_tpu." in a or a == "flashe_tpu" for a in argv)

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-X", "importtime"] + argv[1:3]
                         + ["--help"], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = [line.rsplit("|", 1)[-1].strip()
              for line in res.stderr.splitlines()
              if line.startswith("import time:")]
    assert "flashe_tpu_torch.nn.homo_nn" in loaded  # what the executor runs
    assert not [m for m in loaded if m.split(".")[0] in ("jax",
                                                         "flashe_tpu")]


def test_quantizer_uses_the_ports_aciq():
    assert pquant.ACIQ is paciq.ACIQ


def test_aciq_table_matches_jax_for_every_width():
    assert paciq._ALPHA_GAUS == jaciq._ALPHA_GAUS
    assert paciq._GAUSSIAN_CONST == jaciq._GAUSSIAN_CONST
    for bits in range(2, 41):
        assert paciq.ACIQ(bits)._alpha_opt() == jaciq.ACIQ(bits)._alpha_opt()


@pytest.mark.parametrize("cls", ["QuantizeConfig", "SecureAggregateArgs",
                                 "CVParam", "HomoNNParam"])
def test_config_fields_match_jax(cls):
    def default(f):
        v = (f.default if f.default is not dataclasses.MISSING
             else f.default_factory())
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    def fields(mod):
        return [(f.name, default(f))
                for f in dataclasses.fields(getattr(mod, cls))]

    assert fields(pconfig) == fields(jconfig)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "examples", "configs", "*.json"))),
    ids=os.path.basename)
def test_config_dict_forms_match_jax(path):
    with open(path) as f:
        d = json.load(f)["param"]
    port, ref = HomoNNParam.from_dict(d), jconfig.HomoNNParam.from_dict(d)
    assert port.to_dict() == ref.to_dict()
    assert (port.secure_aggregate_args.to_dict()
            == ref.secure_aggregate_args.to_dict())


@pytest.mark.parametrize("bits", [2, 8, 16, 31, 32])
def test_aciq_alphas_match_jax(bits):
    rng = np.random.default_rng(bits)
    port, ref = paciq.ACIQ(bits), jaciq.ACIQ(bits)
    for _ in range(20):
        lo, hi = sorted(rng.standard_normal(2) * 3)
        size = int(rng.integers(2, 10**7))
        sigma = float(rng.random() * 2)
        assert port.get_alpha_gaus(lo, hi, size) == ref.get_alpha_gaus(
            lo, hi, size)
        assert port.get_alpha_gaus_direct(sigma) == \
            ref.get_alpha_gaus_direct(sigma)


_ARGS = {"key_length": 128, "quantize": {
    "int_bits": 120, "batch": True, "element_bits": 16, "padding": True,
    "secure": True}}


_HE_ARGS = dict(_ARGS, m=64, poly_modulus_degree=64, quantize=dict(
    _ARGS["quantize"], int_bits=20, batch=False))


def _constructors():
    keypair = PaillierKeypair.generate_keypair(128)
    n = keypair[0].n
    template = {"w": torch.zeros(3, 2)}
    plain = HomoNNParam(secure_aggregate="plain")
    shards = [(np.zeros((2, 3), np.float32), np.zeros(2))] * 2
    dsl = {"components": {"dataio_0": {
        "module": "DataIO", "input": {"data": {"data": ["args.train_data"]}},
        "output": {"data": ["train"]}}}}
    conf = {"role": {"guest": [1], "host": [2], "arbiter": [3]}}
    return {
        "FlasheCipher": lambda: FlasheCipher(20),
        "PaillierCipher": lambda: PaillierCipher(),
        "FemnistCNN": lambda: FemnistCNN(),
        "WeightsCodec": lambda: WeightsCodec(template),
        "MontCtx": lambda: MontCtx(n),
        "PairMontCtx": lambda: PairMontCtx(n, n + 2),
        "QuantizingClient": lambda: pquant.QuantizingClient(
            20, False, 16, True, True),
        "Arbiter": lambda: pblocks.Arbiter(_ARGS),
        "Guest": lambda: pblocks.Guest(_ARGS),
        "Host": lambda: pblocks.Host(_ARGS),
        "make_session": lambda: pblocks.make_session(_ARGS, 2,
                                                     keypair=keypair),
        "choose_masking": lambda: choose_masking([[0]], 2),
        "flashe.Arbiter": lambda: fblocks.Arbiter(_ARGS),
        "flashe.Guest": lambda: fblocks.Guest(_ARGS),
        "flashe.Host": lambda: fblocks.Host(_ARGS),
        "plain.Arbiter": lambda: plblocks.Arbiter(_ARGS),
        "plain.Guest": lambda: plblocks.Guest(_ARGS),
        "plain.Host": lambda: plblocks.Host(_ARGS),
        "RnsContext": lambda: RnsContext(64, [7681, 10753]),
        "BFVCipher": lambda: BFVCipher(1032193, 64, flagBatching=True),
        "CKKSCipher": lambda: CKKSCipher(64),
        "PadsCipher": lambda: PadsCipher(),
        "RandomPads": lambda: RandomPads(7),
        "bfv.Arbiter": lambda: bblocks.Arbiter(_HE_ARGS),
        "bfv.Guest": lambda: bblocks.Guest(_HE_ARGS),
        "bfv.Host": lambda: bblocks.Host(_HE_ARGS),
        "ckks.Arbiter": lambda: cblocks.Arbiter(_HE_ARGS),
        "ckks.Guest": lambda: cblocks.Guest(_HE_ARGS),
        "ckks.Host": lambda: cblocks.Host(_HE_ARGS),
        "additive.Arbiter": lambda: ablocks.Arbiter({}),
        "additive.Guest": lambda: ablocks.Guest({}),
        "additive.Host": lambda: ablocks.Host({}),
        "aggregator.Arbiter": lambda: aggregator.Arbiter(),
        "aggregator.Guest": lambda: aggregator.Guest(),
        "aggregator.Host": lambda: aggregator.Host(),
        "with_role": lambda: aggregator.with_role("guest", None),
        "run_roles": lambda: run_roles(
            1, lambda trv: aggregator.with_role("guest", trv),
            lambda trv, h: aggregator.with_role("host", trv),
            lambda trv: aggregator.with_role("arbiter", trv), timeout=30),
        "MLP": lambda: pmodels.MLP(),
        "CifarResNet": lambda: pmodels.CifarResNet(),
        "CharLSTM": lambda: pmodels.CharLSTM(),
        "build_model": lambda: pmodels.build_model("cnn"),
        "LocalTrainer": lambda: LocalTrainer(pmodels.MLP(device="cpu")),
        "HomoNNGuest": lambda: homo_nn.HomoNNGuest(plain),
        "HomoNNHost": lambda: homo_nn.HomoNNHost(plain),
        "HomoNNArbiter": lambda: homo_nn.HomoNNArbiter(plain),
        "KerasDefineModel": lambda: KerasDefineModel(
            {"class_name": "Sequential", "config": {"layers": []}}),
        "submit_job": lambda: pjob.submit_job(plain, shards),
        "submit_dsl_job": lambda: pjob.submit_dsl_job(dsl, conf),
        "run_dsl_job": lambda: run_dsl_job(dsl, conf),
        "run_task": lambda: run_task({"role": "guest", "party_id": 0}),
        "JobServer": lambda: JobServer("127.0.0.1", 0),
        "build_party_cfg": lambda: pcluster.build_party_cfg(
            "arbiter", 0, ("127.0.0.1", 1), "j", param={}, n_hosts=1),
        "run_party": lambda: pcluster.run_party(
            {"role": "arbiter", "party_id": 0}),
        "serve": lambda: cli_main(["serve", "--port", "0"]),
        "party": lambda: cli_main([
            "party", "--broker", "127.0.0.1:1", "--role", "arbiter",
            "--job-id", "j", "-c", os.path.join(REPO, "examples", "configs",
                                                "mlp_flashe.json")]),
        "cluster": lambda: cli_main([
            "cluster", "-c", os.path.join(REPO, "deploy", "cluster_conf.yml"),
            "--run-local"]),
        "from_nn_define": lambda: from_nn_define(
            shakespeare_experiment.gru_define(8, 8)),
        "run_scheme": lambda: shakespeare_experiment.run_scheme(
            "plain", [], None, shakespeare_experiment.gru_define(8, 8), 1,
            0.01, 8, 0),
        "run_experiment": lambda: shakespeare_experiment.run_experiment(
            [], None, shakespeare_experiment.gru_define(8, 8)),
        "shakespeare_experiment": lambda: shakespeare_experiment.main([
            "--dataset", os.path.join(REPO, "no-such-dataset")]),
        "compare_schemes": lambda: compare_schemes.main([
            "--params", "8", "--train-s", "1.0", "--schemes", "plain"]),
        "measure_scheme": lambda: compare_schemes.measure_scheme(
            "plain", 8, np.random.RandomState(0)),
        "measure_train_step": lambda: compare_schemes.measure_train_step(1),
        "check_flashe_sum": lambda: compare_schemes.check_flashe_sum(8),
        "LocalLaneMesh": lambda: LocalLaneMesh(),
        "DeviceFanout": lambda: DeviceFanout(),
        "make_mesh": lambda: sharded.make_mesh(1, 1),
        "encrypted_aggregate": lambda: sharded.encrypted_aggregate(
            sharded.make_mesh(1, 1), torch.zeros(15, 16, dtype=torch.int32),
            torch.zeros(1, 192, dtype=torch.int32), 0, 20, 1),
        "run_mesh_training": lambda: mesh_party.run_mesh_training(
            "127.0.0.1:1", 1, 0),
        "mesh-party": lambda: cli_main([
            "mesh-party", "--coordinator", "127.0.0.1:1",
            "--num-processes", "1", "--process-id", "0"]),
        "dryrun_multichip": lambda: graft.dryrun_multichip(1),
        "graft.entry": lambda: graft.entry(),
    }


@pytest.mark.parametrize("name", [
    "FlasheCipher", "PaillierCipher", "FemnistCNN", "WeightsCodec",
    "MontCtx", "PairMontCtx", "QuantizingClient", "Arbiter", "Guest", "Host",
    "make_session", "choose_masking", "flashe.Arbiter", "flashe.Guest",
    "flashe.Host", "plain.Arbiter", "plain.Guest", "plain.Host",
    "RnsContext", "BFVCipher", "CKKSCipher", "PadsCipher", "RandomPads",
    "bfv.Arbiter", "bfv.Guest", "bfv.Host", "ckks.Arbiter", "ckks.Guest",
    "ckks.Host", "additive.Arbiter", "additive.Guest", "additive.Host",
    "aggregator.Arbiter", "aggregator.Guest", "aggregator.Host",
    "with_role", "run_roles", "MLP", "CifarResNet", "CharLSTM",
    "build_model", "LocalTrainer", "HomoNNGuest", "HomoNNHost",
    "HomoNNArbiter", "KerasDefineModel", "submit_job", "submit_dsl_job",
    "run_dsl_job", "run_task", "JobServer", "build_party_cfg", "run_party",
    "serve", "party", "cluster", "from_nn_define", "run_scheme",
    "run_experiment", "shakespeare_experiment", "compare_schemes",
    "measure_scheme",
    "measure_train_step", "check_flashe_sum", "LocalLaneMesh",
    "DeviceFanout", "make_mesh", "encrypted_aggregate", "run_mesh_training",
    "mesh-party", "dryrun_multichip", "graft.entry"])
def test_entry_points_default_to_the_card(name):
    """Called with no device, each entry point asks for the card: on a host
    without one it raises and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    make = _constructors()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
