"""SPMD federated training: one torch.distributed process a client (port of
flashe_tpu/parallel/mesh_party.py).

The intra-datacenter deployment (BASELINE config #5; SURVEY §2.5): when the
silos are one operator's machines, the federation runs as one program of
N processes: client i is process i, its devices are its lane shards, and
each round's encrypted aggregation is encrypt -> all_reduce -> decrypt
(parallel/multihost.py).  No broker and no serialization: the ciphertexts
move in one collective.

It complements the TCP federation (fed/tcp.py, runtime/cluster.py), which
mutually distrusting silos keep; the mesh party is for a trusted
consortium.  The PRP seed is therefore preshared configuration rather than
DH-wrapped.  Quantization follows the protocol's secure ACIQ: alpha comes
from the running statistics of the previous global model
(quant/quantizer.py), which every process computes alike, so the lane
scales agree without a message.  The degrees and the losses are
all-gathered and summed in process order, so that every process computes
the same model, bit for bit.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.parallel import multihost
from flashe_tpu_torch.parallel.sharded import padded_lane_count

__all__ = ["run_mesh_training"]


def _gather_sum(value: float) -> float:
    """The sum over processes of a float, added in process order."""
    vals = [None] * dist.get_world_size()
    dist.all_gather_object(vals, float(value))
    return float(sum(vals))


def run_mesh_training(coordinator: str, num_processes: int, process_id: int,
                      *, model: str = "mlp", model_kwargs: Optional[dict] = None,
                      rounds: int = 5, epochs_per_round: int = 1,
                      batch_size: int = 32, learning_rate: float = 0.05,
                      optimizer: str = "sgd", int_bits: int = 20,
                      element_bits: int = 16, data: Optional[str] = None,
                      samples: int = 256, prp_seed: bytes = bytes(range(32)),
                      seed: int = 0, verbose: bool = False, device="cuda",
                      backend: Optional[str] = None) -> dict:
    """Train a model federatedly across the processes; returns this
    process's view: {"loss_history", "model_digest", "rounds",
    "process_id", "mesh", "device", "backend", "launches"} (the last three
    are the port's: where it ran, and the mask kernel's launches by mode).

    data: an optional .npz with arrays x, y (this process's private shard);
    by default synthetic classification blobs by process id.  The process
    runs on `device` (the card by default, one lane shard) and joins the
    group with `backend` (init_multihost's default when None).  Every
    process returns the same model_digest.
    """
    device = resolve_device(device)
    backend = multihost.init_multihost(coordinator, num_processes,
                                       process_id, backend, device)
    from flashe_tpu_torch.nn.models import build_model, init_params
    from flashe_tpu_torch.nn.trainer import LocalTrainer
    from flashe_tpu_torch.nn.weights import WeightsCodec
    from flashe_tpu_torch.ops import aes, flashe_mask
    from flashe_tpu_torch.quant.quantizer import QuantizingClient

    try:
        mesh = multihost.make_multihost_mesh(devices=[device])
        n_clients = mesh.shape["clients"]
        n_shards = mesh.shape["lanes"]
        assert n_clients == num_processes

        # -- local data (private to this process) --------------------------
        if data:
            blob = np.load(data)
            x, y = blob["x"], blob["y"]
        else:
            rng = np.random.RandomState(1000 + process_id)
            num_classes = 4
            centers = np.random.RandomState(7).randn(num_classes, 8) * 2.0
            y = rng.randint(0, num_classes, samples).astype(np.int32)
            x = (centers[y] + rng.randn(samples, 8) * 0.7).astype(np.float32)
        y = y.astype(np.int64)

        # -- shared-init model + quantizer ---------------------------------
        mdl = build_model(model, device=device, **(model_kwargs or {}))
        params = init_params(mdl, x[:1], seed=0)  # the same on all
        codec = WeightsCodec(params, device=device)
        trainer = LocalTrainer(mdl, optimizer=optimizer,
                               learning_rate=learning_rate,
                               seed=seed + process_id, device=device)
        quant = QuantizingClient(int_bits, False, element_bits, True, True,
                                 seed=seed + process_id, device=device)
        quant.set_codec(codec)
        quant.set_num_clients(n_clients)

        n_lanes = padded_lane_count(codec.total, int_bits, n_shards)
        rk = torch.from_numpy(aes.key_schedule(prp_seed).astype(np.int32))

        degree = float(len(x))
        total_degree = _gather_sum(degree)

        losses = []
        for r in range(rounds):
            train_loss = trainer.train(x, y, epochs=epochs_per_round,
                                       batch_size=min(batch_size, len(x)))
            flat = codec.flatten(trainer.params) * degree

            # encode: normalize by running layer means, ACIQ clip,
            # stochastic rounding; the scales agree on every process
            quant.set_iter(r)
            q = quant.quantize(quant.normalize(flat))
            q_pad = torch.zeros(n_lanes, dtype=torch.int32, device=device)
            q_pad[: codec.total] = q

            out = multihost.multihost_encrypted_aggregate(
                mesh, rk, q_pad[None], r, int_bits, n_clients)
            full = out[: codec.total].to(device)

            # decode as protocol/aggregator's clients do: unquantize the
            # n-client sum, weight by degree, restore the layer means and
            # refresh the running statistics, then drop this client's
            # own degree factor
            agg = quant.unquantize(full)
            agg = agg * (degree / total_degree)
            agg = quant.unnormalize(agg)
            agg = agg / degree
            trainer.set_model_weights(codec.unflatten(agg))

            loss, _ = trainer.evaluate(x, y)
            mean_loss = _gather_sum(loss * degree) / total_degree
            losses.append(mean_loss)
            if verbose:
                print(f"[mesh-party {process_id}] round {r}: "
                      f"local_train={train_loss:.4f} fed_eval={mean_loss:.4f}",
                      flush=True)

        digest = hashlib.sha256(codec.flatten(
            trainer.params).cpu().numpy().tobytes()).hexdigest()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return {"loss_history": losses, "model_digest": digest,
            "rounds": rounds, "process_id": process_id,
            "mesh": dict(mesh.shape), "device": str(device),
            "backend": backend, "launches": dict(flashe_mask.mode_launches)}
