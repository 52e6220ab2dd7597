#!/usr/bin/env python3
"""Smoke test of the PyTorch port (flashe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases, each of which fails the run:
  1. build the CUDA kernels (csrc/flashe_mask.cu and csrc/montgomery.cu),
     one nvcc each, in parallel, for sm_90a;
  2. hold the mask kernel against its plain torch version on the card: a
     grid of int_bits (1 to 32) x lane counts x counter offsets, bit-exact:
     the lane counts of the training path's three models, counts on both
     sides of one warp's span and of one pass of the
     kernel's resident grid (both asked of the built library), counts that
     are no multiple of the lanes a block, offsets whose low counter word
     wraps and that are negative as int64; plus the FIPS-197 AES-256
     vector and golden lanes from the `cryptography` AES;
  3. hold the kernel's other modes against their plain versions on the
     card, bit-exact: one stream alone (the single mask's add and minus)
     at int_bits 1 to 32, and multi-limb lanes at int_bits 33 to 128 with
     both streams and with each alone, on the same grid of counts and
     counter offsets; the sparse decrypt's in-place scatter, with the minus
     stream alone and with both, at location sets that are empty, of one
     element, dense and random at 10% of 1,206,590 lanes;
  4. one FLASHE round of FemnistCNN at full width (1,206,590 lanes) with 10
     clients, int_bits 20, element_bits 16, the secure ACIQ quantizer and
     the double mask, through client_upload / arbiter_reduce /
     client_download; then the same round with client 9 dropped.  The
     decrypted lanes must equal the clients' summed quantized values mod
     2^20, the new global model must lie within one quantization step of
     the clients' mean, and the launch counter must show that every encrypt
     and decrypt went through the kernel;
  5. the sparsified rounds of FemnistCNN at full width with 10 clients and
     top-10% selection by layer (120,655 compact lanes a client), int_bits
     20: path S (examples/configs/cnn_flashe_s100_dyn.json, dynamic
     masking, which must choose the single mask; two iterations, so that
     the residual memory is used), path D (the same with mask "double";
     the second round drops client 9; every client's locations encoded
     and decoded by the native packer, csrc/packing.cpp, 10 packs and 10
     unpacks a round); and path B, the batched 120-bit round
     (examples/configs/cnn_flashe_q16_b6_pad.json: 201,099 lanes of six
     20-bit fields, 4 limbs each, precompute on) and its dropout round.
     Decrypted lanes must equal the survivors' (densified) quantized sums
     mod 2^m, the new model must lie within one quantization step of what
     the clients sent, and the launch counters must show the path's
     launches of each mode;
  6. hold the three Montgomery kernels against their plain versions,
     bit-exact: moduli of 32 to 4096 bits, at the limb counts L on each
     side of every boundary of the kernels' (threads a row, limbs a
     thread) dispatch, so that every kernel instance runs, and three with
     an all-ones top limb; batches of 0 to 2048 rows (row counts that are
     not a multiple of the rows a warp holds among them), operands 0, 1
     and n - 1; the fused modexp with 64-bit exponents, and with the full
     1024-bit CRT exponents of a 2048-bit key against python pow;
  7. one Paillier round of FemnistCNN at full width with 10 clients under
     that key (examples/configs/cnn_paillier_q16_b100_pad.json: int_bits
     2000, batch packing, element_bits 16): 12,066 ciphertexts a client,
     the arbiter's product, client 0's CRT decrypt and decode.  The
     ciphertexts must match the host's encrypt_scalar, the decrypted sums
     the clients' packed q exactly, the new model the clients' mean within
     one quantization step, and the launch counters the kernels' share of
     the path; then a 5-row decrypt, which takes the single-product route;
  8. the federated rounds, through the entry point a user calls
     (protocol/aggregator.py::with_role) with every role's session setup
     (uuid sync, the DH exchange through the arbiter, the AES-256-CTR wrap
     of the guest's PRP seed or Paillier key for each host):
     - in memory, guest + 9 hosts + arbiter, one thread each on the card,
       cnn_flashe_q16_b1_pad.json at full width over three rounds: all in;
       client 9 asleep past upload_timeout_s, dropped and sent the
       aggregate in its dropped frame; client 9 back.  Each round every
       client's decrypted lanes must equal the survivors' summed q mod
       2^20, every client must hold the same model, within one
       quantization step of the survivors' (clipped) mean, and the mask
       kernel must run 10 encrypts + 10 clients x 1 boundary pair; each
       round's time by phase is printed (host clock, a synchronize at each
       phase's ends);
     - in memory, the sparse round of cnn_flashe_s100_dyn.json, 10
       clients: the choice single, 10 single + 100 scatter launches, every
       client's decrypt equal to the densified sum, the same model;
     - in memory, cnn_paillier_q16_b100_pad.json with 3 clients at full
       width, the 2048-bit key generated by the guest: every client's
       decrypted sums equal to the packed sums, the Montgomery launches;
     - over TCP: the port's native FedBroker (csrc/fedbroker.cpp, which
       must be the one that runs) on 127.0.0.1 and the guest, one host and
       the arbiter as three child processes of this script (--tcp-role),
       one dense round with wire_pack; the same checks, one native pack
       at each client and two native unpacks at the arbiter, and the wire
       bytes from each party's TransferStat;
  9. timings with CUDA events over runs of launches (printed, not
     asserted), at the shapes the paths run: mont_mul at one encrypt's
     12,066 rows x 4096 bits (checked against its plain version there),
     mont_exp_rows at the decrypt's 24,132 rows x 2048 bits with the key's
     CRT exponents (sample rows checked against pow), mont_mul_vec at the
     5-row decrypt's 10 rows, the mask kernel at the round's lanes and at
     4,194,304 (a call over CUDA graphs of calls, which the host's launch
     rate does not hold back, and over runs of calls from the host); each
     beside its bound (flashe_tpu_torch/tools/roofline.py); the mask
     kernel's other modes at their paths' shapes (one stream at 120,655
     lanes, the scatter at 120,655 locations in 1,206,590 lanes, 120-bit
     limbs at 201,099 lanes), over CUDA graphs and over host calls; the
     sparse round by phase; then the Montgomery kernels again at 2,048
     rows;
 10. federated training (run between phases 8 and 9), as `python -m
     flashe_tpu_torch submit` runs it: HomoNNGuest, 9 HomoNNHosts and
     HomoNNArbiter, one thread each over run_roles, data from the port's
     federated_dataset, with torch's own TF32 settings:
     cnn_flashe_q16_b1_pad.json as it stands (FemnistCNN, 10 clients x 128
     samples, batch 128, Adam at lr 5e-4, 2 iterations), and
     resnet_flashe_q16_b1_pad.json and lstm_flashe_q16_b1_pad.json, also
     as they stand (2 iterations each).  Every loss_per_round entry must be
     finite, in every iteration every client's decrypted lanes must equal
     the clients' summed quantized uploads mod 2^int_bits, every client
     must hold the same model, bit for bit, after each aggregation, the
     mask kernel must run 10 encrypts + 10 clients x 1
     boundary pair of double launches an iteration (and no other kernel),
     and each client's parameters and optimizer state must lie on the card.
     Then one client alone on its 128 FEMNIST samples takes 20 full-batch
     Adam steps at lr 5e-4: the mean of its last 5 losses must lie below
     that of its first 5.  It prints the guest's phases an iteration (the
     first a warm-up, holding each thread's first cuDNN and cuBLAS calls;
     the second steady) and the local training rate (host clock, a
     synchronize at each phase's ends);
 11. the general-HE baselines (run after phase 10), whose rounds launch
     no kernel of csrc/: their ring is torch ops (ops/ntt.py).  ntt and
     intt on the card equal the same functions on the CPU, bit for bit, at
     N 64, 1,024 and 8,192 over k 1 (the slot prime t), 2 and 6 primes,
     batches up to 295; intt(ntt(a) ntt(b)) equals a python-int negacyclic
     convolution; CKKS's centred reconstruction equals python ints near
     +-2^62.  At full width, 10 clients: BFV (t 1964769281, m 8192,
     batching; 148 ciphertexts of q16 lanes a client), whose decrypted sum
     must equal the clients' summed q exactly, one upload decrypting to
     the same lanes on the card and on the CPU; CKKS (N 8192, scale 2^40;
     295 ciphertexts of floats a client), its decrypted sum within 1e-7 of
     the float64 sum; the additive pads, the arbiter's float32 sum within
     1e-3 of the plain sum.  Then federated training as in phase 10:
     cnn_bfv_q16_binf_pad.json and cnn_ckks.json as they stand but for
     max_iter 2, and cnn_flashe_q16_b1_pad.json with secure_aggregate
     "additive"; finite losses, every client the same model after each
     aggregation, BFV's decrypt equal to the summed q in every iteration
     (CKKS's and the additive sum within their tolerances of the sum of
     the uploads), and no mask or Montgomery launch.  It prints the
     guest's phases, the calls of the ring's device code an iteration,
     and their times at the round's shapes (CUDA events) beside their
     bounds, one JSON line of them, and the phase's peak device memory.
 12. the job runtime (run after phase 10, with submit's TF32 settings),
     each command a process of its own, every store in a temporary
     directory: (a) `python -m flashe_tpu_torch submit -c
     examples/configs/cnn_flashe_q16_b1_pad.json --processes
     --checkpoint-dir D --publish phase12 --json`, 11 party processes
     (guest, 9 hosts, arbiter) on the one card over the TCP broker, whose
     __job__ record must name the native one: every task `success` in
     the job registry, every client's parameters on the card, 2 double
     mask launches an iteration in each client process and no other
     launch, none at the arbiter, the 10 checkpoints equal bit for bit,
     loss_per_round finite and within 1e-3 relative of phase 10's
     in-process submit; each party's steady iteration by phase beside
     phase 10's, the processes' start-up seconds and peak device memory
     printed; (b) `predict --model phase12`, run beside (c):
     aggregate_iter 2 and scores within 1e-5 of the guest's checkpoint
     loaded in this process; (c)
     `submit-dsl --processes` of examples/dsl/train_job_conf.json made 1
     guest + 9 hosts with the FEMNIST CNN as a Keras nn_define (1,206,590
     parameters), max_iter 2, over DataIO tables that DataStore.put wrote
     from the port's federated_dataset: the same job checks, finite
     losses, every client's Evaluation.  The party processes write what
     is checked (device, launches, a digest of the final model, phases)
     into their outputs (runtime/task_executor.py).  (c)'s job too ran over
     the native broker, and no process of the port's fedbroker binary is
     left after the phase (/proc/*/cmdline).
 13. the job server and the cluster deployment (run after phase 12, over
     its stores and DataIO tables): (a) `python -m flashe_tpu_torch serve
     --port 0` a process of its own, FLASHE_MAX_CONCURRENT_JOB_RUN=1,
     started beside phase 12 (c);
     (b) phase 12 (c)'s DSL job submitted through FlasheClient (11 party
     processes on the card): phase 12's job checks, losses within 1e-6
     relative of phase 12 (c)'s, and the server's views of it (tracking's
     data_view and metric/all, the DAG, the logs, the HTML /board page and
     `board -j --server` name every task; metric_data holds the arbiter's
     losses, component/parameters each client's nn_define, job/config the
     submitted DSL and conf); each party's steady iteration printed beside
     phase 12 (c)'s; (c) the queue: a 3-party version (guest, one host,
     arbiter; max_iter 1) runs while a second waits (`queue --server`),
     the second is stopped (`stop --server`) and never starts, a third is
     queued and the server interrupted: the third ends canceled, never
     started, and the first success; (d) `cluster -c CONF.json
     --run-local`, a JSON conf of cnn_flashe_q16_b1_pad.json with
     n_clients 2 (broker, guest, host, arbiter, a process each on the
     card): every return code 0, 2 double launches a client an iteration,
     none at the arbiter, one model digest, losses within 1e-3 relative of
     the in-process submit of the same config.  The server's jobs and
     the cluster's broker must be the native broker (the job's summary,
     `cluster`'s line naming its broker), and no port fedbroker process is
     left after the phase.
 14. the scheme comparison (run after phase 11): `python -m
     flashe_tpu_torch.tools.compare_schemes --out F`, a process of its own
     on the card, at full width (1,206,590 parameters, 24 batches of 128 a
     round) with its six default rows: every row `correct` (for flashe and
     flashe+sparse the timed decrypt of ten clients' summed ciphertexts
     equal to their summed q mod 2^20), the wire MB a client exactly 9.653
     / 6.033 / 1.237 / 12.114 / 111.542 / 222.331, the platform the card
     (its nvidia-smi line), and each row's kernel launches: 13 double mask
     launches in each FLASHE row (4 timed, 9 the other clients' encrypts),
     mont_mul and mont_exp_rows in the Paillier row, none in the others.  It prints one `comparison` JSON
     line (the rows, the claims, the card's name and power limit);
 15. the table data plane (host code, no card): `python -m
     flashe_tpu_torch storage-node` on a temporary directory, which must
     run the native server (csrc/kvserver.cpp built with g++; a failed
     build fails the phase), a session bound to it, `upload_csv` of a
     dense CSV written from the seed, `DataStore.to_dtable` of the same
     CSV, both tables' Instances equal to the numpy arrays; mapValues and
     reduce through EXEC in the node's egg processor (the client issues no
     ITER or GET meanwhile), the features' sum within 1e-4 of numpy's and
     the labels' sum exact; the egg processes' command line names
     flashe_tpu_torch.data.egg; EncryptModeCalculator ("fast") with
     FloatPaillier (1024-bit key) over the features' table, two rounds,
     every decrypt within 1e-9 of the value it encrypts; the node stopped
     by an interrupt and its processes gone.  It prints which backend ran
     (server, local store, pickler);
 16. several devices on the one card (run after phase 15), at FemnistCNN's
     width: (a) parallel/sharded.encrypted_aggregate on a 10 x 2 grid of
     cuda:0 (a client a row, a lane shard a column, each shard's mask
     launch at its counter offset), all in and with client 9 dropped: the
     decrypt equal to the numpy sum mod 2^20 and, bit for bit, to the round
     of single-device FlasheCiphers, each cell's ciphertext its slice of
     the client's FlasheCipher.encrypt; 20 encrypts + 2 decrypt pairs a
     round; its ms; (b) FlasheCipher.set_local_devices(4, [cuda:0] x 4):
     the dense double and single masks of 10 clients and the path-S sparse
     decrypt (10 survivors, parallel/party.sparse_decrypt_fanout) bit for
     bit the unsharded cipher's; (c) set_local_devices(2, [cuda:0] x 2) on
     Paillier (the phase's 2048-bit key: 24 values encrypted and decrypted
     fanned, equal to the unfanned decrypt, python pow and the values;
     mont_mul and mont_exp_rows launches a chunk), BFV and CKKS (10 clients
     fanned, the sum decrypted exactly, or within 1e-7); (d)
     parallel/multihost.launch_local of parallel/_multihost_child.py, 4
     processes on cuda:0 over gloo and one over NCCL: both rounds equal to
     the plain sum in every process, digests equal to the in-process
     grid's; (e), started with (d)'s two groups, `cluster --run-local` of a
     4-host mesh conf (femnist_cnn, 2 rounds, a .npz shard of synthetic
     FEMNIST a host, the processes on cuda:0 over gloo): one model digest,
     finite losses that fall and lie within 1e-4 of the same rounds in
     float64 here without mask or collective (plain_mesh_losses); (f)
     graft.dryrun_multichip(8, [cuda:0] x 8): FemnistCNN, 4 clients x 2
     shards, the survivor check. Mask launches counted here and in the
     children (`launches_multi_gpu`).
17. the benchmark harness (run after phase 16), bench.py's nine modes as
     flashe_tpu_torch/tools/bench.py runs them at their defaults:
     `python -m flashe_tpu_torch.tools.bench --verbose` as a process (exit
     0, one JSON line with bench.py's metric, the guard held at 4,194,304
     lanes x 10 clients x int_bits 20, 5 samples, the card's nvidia-smi
     line, the mask launches its code makes), then in this process
     roundtrip1m (the limbs mode at 1,048,576 lanes, q given back exactly),
     precompute (11 single launches at 10,000,000 lanes), paillier (this
     run's 2048-bit key, 2,048 rows), model100m (the mask kernel at
     100,000,000 lanes, its decrypt 10 q mod 2^20), table2 (its first
     size, 16,384, no --full: every row correct, launches from each
     cell's calls), roofline
     (csrc/ceiling.cu's kernels checked against their plain chains), multihost
     (2 processes on cuda:0 over gloo, their launches) and party (cuda:0
     twice: shards 1 and 2, every row correct); each mode's metric name and
     its launches as deltas around it, against what its code makes; one
     `bench` JSON line of every mode's result; the mask kernel at the
     modes' shapes that no earlier phase runs, one launch over the whole
     vector held lane for lane against the plain version (run chunk by
     chunk at each chunk's counter block): model100m's encrypt and decrypt
     at 100,000,000 lanes, precompute's stream 10 at 10,000,000,
     roundtrip1m's encrypt at 1,048,576 x 2 limbs; the ceiling kernels
     against their plain versions at 8,388,608 elements and timed
     (`launches_bench` in the kernels' line).
18. the native layer (run after phase 17; host code): (a) the wire
     packer at the slice's shapes, from the seed: ten clients' path-S
     locations (120,655 of 21 bits each, a top-10% by layer of
     FemnistCNN's 1,206,590 lanes), one 20-bit upload of 1,206,590 lanes,
     one path-B upload (201,099 lanes x 4 limbs at 120 bits): the native
     packer's bytes equal the numpy path's, unpack gives the lanes back,
     both timed (median of 5, host clock); (b) `python -m flashe_tpu_torch
     broker --port 0` and `broker --python --port 0` as processes, each
     naming its broker; through each, the arbiter sends ten FemnistCNN
     aggregates (1,206,590 int32 lanes, 2 fragments) to ten receiving
     parties (threads of this process), the brokers in turns for 3 timed
     rounds after one warm-up each: every receiver's array equal, the
     median from the first remote to the last get; both brokers stopped
     with SIGTERM and exiting 0, and no port fedbroker process left.  One
     `native_layer` JSON line.
19. the Shakespeare workload (run after phase 18): (a) a seeded corpus in
     shakespeare_10's CSV format (header id,x1..x81; rows of an order-1
     Markov chain over tokens 1-82 with peaked transitions, zero-padded
     tails; nine {i}_a.csv shards and b.csv of 512 rows) written to a
     temporary directory and read back through data/shakespeare.py:
     (512, 80) int32, y = x shifted by one token; (b) the mask kernel
     against its plain version lane for lane at the GRU's 654,675 lanes
     (6 x 109,112 + 3: the last AES block holds 3 lanes), int_bits 20:
     encrypts at (idx, idx+1) for idx 0 and 8, the boundary decrypt at
     (9, 0) in iterations 0 and 2, and its time beside its bound; (c)
     tools/shakespeare_experiment.run_experiment, main's code path, with
     gru_define(512, 256) (count_params_define 654,675), 9 clients and
     the arbiter on the card, the first 256 rows of each shard (--limit
     256), batch 128, Adam lr 0.01, plain and flashe, 3 rounds x 2 reps
     (arm order alternating), eval limit 512, with submit's TF32
     settings: every loss finite, each arm's federated loss
     falling from round 0 to round 2 in every rep, flashe's within 1e-3
     relative of plain's round by round in the same rep, the mask kernel
     launched 9 encrypts + 9 boundary pairs a flashe round and never in
     the plain arm; it prints both arms' steady round seconds, the
     overhead's median and 95% CI, the local-training share of the
     guest's round and the largest gap, and one `shakespeare` JSON line.
20. the trainer's steps as CUDA graphs (run after phase 19), the GRU at
     the shakespeare_gru cell's widths (embed 512, hidden 256, batch 128 of
     256 rows a client): (a) two clients in threads replaying their steps
     and two running them eagerly, 3 rounds of train, install and
     evaluate under torch's deterministic algorithms: losses, parameters,
     Adam's mu, nu and counts equal bit for bit, each mode's first step
     eager and every later one a replay; under the default algorithms the
     embedding's backward sums in an order that varies from run to run,
     and the phase prints how far two eager clients end apart; one
     client's round of 2 steps timed replayed and eager; (b) the cell's
     FLASHE job on a seeded Markov corpus, 9 clients building their
     models in their threads and the arbiter through run_roles, 3 rounds,
     captures concurrent: every client's steps counted as in (a), its Adam
     count 6, the federated loss falling; (c) FemnistCNN: its training
     draws dropout and stays eager, its evaluation replays; (d) another
     thread builds clients' models on the card (their layers draw from the
     default generator, which a capture holds) while a client's steps are
     captured, and a FemnistCNN client trains eagerly in a third (its
     steps after the first take no lock); one `graphs` JSON line.
It prints the script's seconds at the end of each phase.
It prints ptxas's registers and spills of every kernel instance after the
build and, where the toolkit has cuobjdump, the mask kernel's instruction
counts; the kernels' JSON line and the card's name and power limit, then as
its last line {"ok": true, "device": {...}}.  Without a CUDA device it
exits non-zero and prints no result.

    python3 chip_smoke.py --times   # phases 1 and 9 only

times the mask kernel and the Montgomery kernels at their paths' shapes
beside their bounds and prints no result line: run in a copy of the tree
whose csrc/flashe_mask.cu or csrc/montgomery.cu is an older one (same C
entry points; an older flashe_mask_apply does not read the table pointer
that the wrapper passes last), it times that source in the same call as
this one.  The other modes are timed where the library has their entry
point, flashe_mask_apply_modes.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import functools
import hashlib
import io
import json
import math
import operator
import os
import pickle
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch

from flashe_tpu_torch.crypto.bfv import BFVCipher
from flashe_tpu_torch.crypto.ckks import CKKSCipher
from flashe_tpu_torch.crypto.flashe import FlasheCipher, merge_idx_runs
from flashe_tpu_torch.crypto.random_pads import PadsCipher
from flashe_tpu_torch.fed.tcp import _FRAGMENT, FedBroker, TcpFederation
from flashe_tpu_torch.fed.transport import default_parties
from flashe_tpu_torch.fed.variables import HomoTransferVariables
from flashe_tpu_torch.__main__ import main as cli_main
from flashe_tpu_torch.crypto.encrypt_mode import EncryptModeCalculator
from flashe_tpu_torch.crypto.paillier import (
    FloatPaillier, PaillierCipher, PaillierKeypair)
from flashe_tpu_torch.data import (federated_dataset, shakespeare,
                                   synthetic_dataset)
from flashe_tpu_torch.data.io import upload_csv
from flashe_tpu_torch.data.kvstore import open_store
from flashe_tpu_torch.data.remote_kv import _EXEC, _GET, _ITER
from flashe_tpu_torch.data.store import DataStore
from flashe_tpu_torch.data.table import init as table_session
from flashe_tpu_torch.nn.homo_nn import HomoNNArbiter, HomoNNGuest, HomoNNHost
from flashe_tpu_torch.nn.keras_define import KerasDefineModel
from flashe_tpu_torch.nn.models import FemnistCNN, build_model, init_params
from flashe_tpu_torch.nn.trainer import LocalTrainer
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops import _build, aes, lanes, masks, modmath, ntt
from flashe_tpu_torch.ops import flashe_mask as fm
from flashe_tpu_torch.ops import montgomery as mg
from flashe_tpu_torch.ops import pack as packops
from flashe_tpu_torch.ops import quantize as qops
from flashe_tpu_torch.protocol import aggregator
from flashe_tpu_torch.protocol.aggregator import (
    ClientBlock, arbiter_reduce, client_download, client_select,
    client_upload, client_upload_sparse)
from flashe_tpu_torch.protocol.blocks import paillier as pblocks
from flashe_tpu_torch.protocol.blocks.flashe import arbiter_masking
from flashe_tpu_torch.protocol.payload import ModelPayload
from flashe_tpu_torch.protocol.sparsify import Sparsifier, decode_locations
from flashe_tpu_torch.quant.aciq import ACIQ
from flashe_tpu_torch.quant.quantizer import QuantizingClient
from flashe_tpu_torch.runtime.checkpoint import load_checkpoint
from flashe_tpu_torch.runtime.config import HomoNNParam
from flashe_tpu_torch.runtime.client import FlasheClient
from flashe_tpu_torch.runtime.job_manager import JobRegistry
from flashe_tpu_torch.runtime.simulate import run_roles
from flashe_tpu_torch.runtime import tracking
from flashe_tpu_torch.runtime.tracking import (
    Tracker, set_tracker, span, tracker)
from flashe_tpu_torch.tools import bench, ceiling, roofline
from flashe_tpu_torch.tools import shakespeare_experiment as se
from flashe_tpu_torch.tools.bench import round_keys
from flashe_tpu_torch.tools.roofline import mask_bound
from flashe_tpu_torch.tools.timing import (
    event_ms, graph_ms, launch_counts, launches_since, run_ms, time_turns)
from flashe_tpu_torch import graft, native
from flashe_tpu_torch.parallel import multihost
from flashe_tpu_torch.parallel.sharded import (
    encrypt_shard, encrypted_aggregate, make_mesh, padded_lane_count)

INT_BITS, ELEMENT_BITS, N_CLIENTS = 20, 16, 10
ROOT = Path(__file__).resolve().parent
SEED = 0x0F1A5E
GRID_INT_BITS = (1, 8, 16, 20, 25, 31, 32)
# to these check_kernel_grid adds, for each int_bits, the lane counts one
# short of and one past a warp's span and one pass of the resident grid
# lanes; 175,066, 817,872 and 1,206,590 are the training path's models
# (CifarResNet, CharLSTM, FemnistCNN)
GRID_COUNTS = (1, 5, 7, 3000, 175_066, 817_872, 1_206_590, 4_194_304)
# the low counter word wraps at 2^32 - 2; -3 runs through 2^64 to 0
GRID_BASES = (0, 3, 96, 2**32 - 2, -3)
N_FEMNIST = 1_206_590
# --times also reads the mask kernel's fixed cost: at int_bits 20 one
# counter block, one 32-block span on each of 132 SMs, 1,024 blocks on each
MASK_SMALL_COUNTS = (6, 25_344, 811_008)
KERNEL_SOURCES = ("flashe_mask", "montgomery", "ceiling")
# the mask kernel's other modes: (add, minus) streams of their grids
SINGLE_STREAMS = ((2, None), (None, 7))
LIMB_INT_BITS = (33, 40, 63, 64, 65, 96, 120, 127, 128)
LIMB_STREAMS = ((2, 7), (2, None), (None, 7))
SCATTER_BASES = (0, 2**32 - 2)
# the sparse rounds: top-10% by layer keeps sum max(1, floor(0.1 size)) =
# 120,655 of FemnistCNN's 1,206,590 parameters a client
SPARSITY, N_COMPACT = 0.1, 120_655
# the batched 120-bit round (examples/configs/cnn_flashe_q16_b6_pad.json):
# factor ceil(log2 10) = 4, six fields of 20 bits a lane, precompute on
B_BITS, B_FACTOR, B_LANES, B_PARAMS = 120, 4, 201_099, 201_101

# the federated rounds: three dense rounds in memory, the second with
# client 9 asleep for FED_SLEEP_S past the arbiter's FED_TIMEOUT_S deadline;
# a 3-client Paillier round; the TCP round's upload packed at 20 bits
FED_ROUNDS, FED_TIMEOUT_S, FED_SLEEP_S = 3, 2.0, 3.0
FED_PAILLIER_CLIENTS = 3
TCP_PACKED_BYTES = 3_016_475  # ceil(1,206,590 x 20 / 8)

# phase 10, federated training: each configuration, run as it stands, with
# its model's parameter count; the single client's full-batch steps; the
# guest's phases printed
TRAIN_CONFIGS = (("cnn_flashe_q16_b1_pad.json", 1_206_590),
                 ("resnet_flashe_q16_b1_pad.json", 175_066),
                 ("lstm_flashe_q16_b1_pad.json", 817_872))
TRAIN_STEPS = 20
TRAIN_PHASES = ("local train", "encoding", "encryption", "upload",
                "download", "decryption", "decoding")
ARBITER_PHASES = ("collect", "aggregate", "dispatch")

# phase 12, the job runtime: phase 10's first configuration as one process
# a party (its in-process submit the reference, loss_per_round within
# RUNTIME_LOSS_RTOL), predict from the published guest model (scores
# within PREDICT_ATOL of the checkpoint in this process), and a 10-party
# DSL job of examples/dsl/train_job_conf.json with the FEMNIST CNN as a
# Keras nn_define; RUNTIME_TIMEOUT_S bounds each command
RUNTIME_CONFIG = TRAIN_CONFIGS[0][0]
RUNTIME_LOSS_RTOL, PREDICT_ATOL = 1e-3, 1e-5
RUNTIME_TIMEOUT_S = 420
# phase 13: the job server's run of phase 12 (c)'s job against that run
SERVER_LOSS_RTOL = 1e-6
FEMNIST_DEFINE = {"class_name": "Sequential", "config": {
    "name": "sequential", "layers": [
        {"class_name": "Reshape",
         "config": {"name": "reshape", "target_shape": [28, 28, 1]}},
        {"class_name": "Conv2D",
         "config": {"name": "conv2d", "filters": 32, "kernel_size": [3, 3],
                    "activation": "relu"}},
        {"class_name": "Conv2D",
         "config": {"name": "conv2d_1", "filters": 64,
                    "kernel_size": [3, 3], "activation": "relu"}},
        {"class_name": "MaxPooling2D",
         "config": {"name": "max_pooling2d", "pool_size": [2, 2]}},
        {"class_name": "Dropout", "config": {"name": "dropout",
                                             "rate": 0.25}},
        {"class_name": "Flatten", "config": {"name": "flatten"}},
        {"class_name": "Dense",
         "config": {"name": "dense", "units": 128, "activation": "relu"}},
        {"class_name": "Dropout", "config": {"name": "dropout_1",
                                             "rate": 0.5}},
        {"class_name": "Dense",
         "config": {"name": "dense_1", "units": 62,
                    "activation": "softmax"}}]}}

# phase 14: the comparison harness at its defaults, and the wire MB a client
# of each row (docs/COMPARISON.md, exact on every device); the FLASHE rows'
# double launches: the other 9 clients' encrypts, once, then (warm +
# timed) x (encrypt + decrypt pair)
COMPARISON_WIRE_MB = {"plain": 9.653, "flashe": 6.033, "flashe+sparse": 1.237,
                      "paillier+batch": 12.114, "bfv+batch": 111.542,
                      "ckks+batch": 222.331}
COMPARISON_FLASHE_DOUBLE = N_CLIENTS - 1 + 2 * 2
COMPARISON_TIMEOUT_S = 600
# phase 15: the table data plane: a CSV of TABLE_ROWS x TABLE_FEATURES
# floats and a label, partitioned 4 ways; the float facade's key
TABLE_ROWS, TABLE_FEATURES, TABLE_PARTS = 32, 4, 4
FACADE_KEY_BITS = 1024
FACADE_ATOL = 1e-9
EGG_EXIT_S = 30

# phase 11, the general-HE baselines: BFV at t and m of
# cnn_bfv_q16_binf_pad.json (protocol/blocks/bfv.py's defaults), CKKS at N
# 8192 and scale 2^40 (cnn_ckks.json); FemnistCNN's 1,206,590 values fill
# 148 BFV ciphertexts of 8,192 slots and 295 CKKS ones of 4,096
HE_T, HE_M = 1964769281, 8192
BFV_CTS, CKKS_CTS = 148, 295
# (N, k, batch) of the NTT's card-against-CPU check; k = 1 is the slot
# prime t, (8192, 6, 295) the CKKS round's shape
NTT_GRID = ((64, 1, 5), (64, 2, 5), (64, 6, 5), (1024, 1, 7), (1024, 2, 7),
            (1024, 6, 7), (8192, 1, BFV_CTS), (8192, 2, 16),
            (8192, 6, CKKS_CTS))
# a CKKS slot decrypts to noise / scale ~1e-9 of its value
CKKS_ATOL = 1e-7
# float32 rounding of 10 padded uploads: about 100 roundings of values up
# to ~2^5 (full width, the model plus 9 pads of N(0, 1)) or ~2^10 (in
# training, the model times its 128 samples' degree, and their sums)
ADDITIVE_ATOL, ADDITIVE_ATOL_TRAIN = 1e-3, 1e-2
HE_TRAIN = (("cnn_bfv_q16_binf_pad.json", None), ("cnn_ckks.json", None),
            ("cnn_flashe_q16_b1_pad.json", "additive"))
HE_TRAIN_ITERS = 2

# the Paillier configuration, examples/configs/cnn_paillier_q16_b100_pad.json
PAILLIER_ARGS = {"key_length": 2048, "quantize": {
    "int_bits": 2000, "batch": True, "element_bits": 16, "padding": True,
    "secure": True}}
PAILLIER_BITS, PACK_FACTOR = 2000, 4  # factor = ceil(log2 10)
N_CTS = 12_066  # ceil(1,206,590 / 100) lanes of 100 fields of 20 bits
# L = 1, 2, 8, 8, 9, 16, 17, 32, 33, 63, 64, 65, 100, 128: both sides of
# every boundary of the kernels' layouts, and L % K != 0 in every instance
# (check_layouts asserts both against the library's own dispatch)
MONT_BITS = (32, 64, 250, 256, 288, 512, 544, 1024, 1056, 2016, 2048, 2080,
             3200, 4096)
MONT_ROWS = (0, 1, 5, 8, 129, 2048)
# FIPS-197 appendix C.3: AES-256, key 00 01 .. 1f
FIPS_PT = "00112233445566778899aabbccddeeff"
FIPS_CT = "8ea2b7ca516745bfeafc49904b496089"
# AES-256 (same key) of 00112233 || 00000000 || 8899aabbccddeeff, from the
# `cryptography` package
FIPS_MINUS_CT = "5bf2e9d53f5fd5b83a8466572f031b11"
# The first 12 lanes (int_bits 20) of streams 2 and 3 at iter 3, seed
# bytes(range(32)), from reference_mask_stream_host (`cryptography` AES)
GOLDEN_IDX2 = [921773, 167529, 218725, 690049, 497544, 36004, 27829, 751813,
               601410, 862937, 426259, 294629]
GOLDEN_IDX3 = [933046, 898726, 2316, 835811, 119083, 613960, 48461, 141943,
               969073, 541320, 1044952, 823704]


def _words_lsb_first(hex_block: str):
    b = bytes.fromhex(hex_block)
    return [int.from_bytes(b[12 - 4 * k:16 - 4 * k], "big") for k in range(4)]


def _as_i64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def grid_counts(m, span, one_pass):
    """GRID_COUNTS and, at m bits a lane, the counts on both sides of a
    warp's span and of one pass of the grid (both in counter blocks)."""
    merge = masks.merge_size(m)
    return GRID_COUNTS + tuple(edge * merge + d for edge in (span, one_pass)
                               for d in (-1, 1))


def check_kernel_grid(dev):
    """Kernel against mask_apply_ref on the card; returns the max error."""
    rk = round_keys(dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    span, one_pass = fm.layout()
    print(f"mask kernel layout: a warp makes {span} counter blocks at a "
          f"time, one pass of the resident grid {one_pass}")
    max_err = 0
    for m in GRID_INT_BITS:
        n_ok = 0
        counts = grid_counts(m, span, one_pass)
        if all(c % masks.merge_size(m) == 0 for c in counts):
            raise AssertionError(f"no count of the grid ends inside a "
                                 f"counter block at int_bits={m}")
        for count in counts:
            q = lanes.to_i32(torch.randint(0, 1 << m, (count,), generator=gen,
                                           device=dev, dtype=torch.int64))
            for base in GRID_BASES:
                got = fm.mask_apply(q, rk, 3, 2, 7, m, base_block=base)
                want = fm.mask_apply_ref(q, rk, 3, 2, 7, m, base_block=base)
                err = int((lanes.as_u32(got) - lanes.as_u32(want)).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(f"kernel != plain at int_bits={m} "
                                         f"count={count} base_block={base}")
                n_ok += 1
        print(f"grid int_bits={m}: {n_ok} (count, base_block) cases "
              "bit-exact against the plain version")

    # FIPS-197 through the kernel: add = the FIPS plaintext block, minus =
    # the same block with stream index 0, q = 0, m = 32 -> word differences
    pt = bytes.fromhex(FIPS_PT)
    got = fm.mask_apply(torch.zeros(4, dtype=torch.int32, device=dev), rk,
                        int.from_bytes(pt[:4], "big"),
                        int.from_bytes(pt[4:8], "big"), 0, 32,
                        base_block=_as_i64(int.from_bytes(pt[8:], "big")))
    want = [(a - b) % (1 << 32) for a, b in zip(
        _words_lsb_first(FIPS_CT), _words_lsb_first(FIPS_MINUS_CT))]
    if lanes.as_u32(got).tolist() != want:
        raise AssertionError("kernel disagrees with the FIPS-197 vector")
    ct = aes.aes_encrypt_blocks(torch.tensor([list(pt)], device=dev),
                                aes.key_schedule(bytes(range(32))))
    if bytes(ct[0].tolist()).hex() != FIPS_CT:
        raise AssertionError("plain AES disagrees with the FIPS-197 vector")
    print("FIPS-197 AES-256 vector: kernel and plain version agree")

    # golden lanes of stream (iter 3, idx 2) and (iter 3, idx 3), m = 20
    for idx, golden in ((2, GOLDEN_IDX2), (3, GOLDEN_IDX3)):
        s = masks.prp_lane_stream(rk, 3, idx, 12, 20)
        if s.tolist() != golden:
            raise AssertionError(f"plain stream {idx} != golden lanes")
    enc = fm.encrypt(torch.zeros(12, dtype=torch.int32, device=dev), rk, 3,
                     2, 20)
    if enc.tolist() != [(a - b) % (1 << 20) for a, b in zip(GOLDEN_IDX2,
                                                            GOLDEN_IDX3)]:
        raise AssertionError("kernel encrypt of zeros != golden lanes")
    print("golden lanes (seed bytes(range(32)), iter 3, idx 2/3, m 20): ok")
    return max_err


def _rand_lanes(gen, dev, count, m):
    """count random lanes of m bits: (count,) int32, or (count, L) limbs."""
    nl = lanes.nlimbs_for(m)
    shape = (count,) if nl == 1 else (count, nl)
    q = lanes.to_i32(torch.randint(0, 1 << 32, shape, generator=gen,
                                   device=dev, dtype=torch.int64))
    return q & lanes.lane_mask(m).to(dev)


def check_modes_grid(dev):
    """The kernel's other modes against their plain versions on the card,
    bit-exact; returns the max error of each mode."""
    rk = round_keys(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    span, one_pass = fm.layout()
    err = {"single": 0, "limbs": 0, "scatter": 0}
    cases = ([("single", m, st) for m in GRID_INT_BITS
              for st in SINGLE_STREAMS]
             + [("limbs", m, st) for m in LIMB_INT_BITS
                for st in LIMB_STREAMS])
    for mode, m, (add, minus) in cases:
        t0, n_ok = time.perf_counter(), 0
        for count in grid_counts(m, span, one_pass):
            q = _rand_lanes(gen, dev, count, m)
            for base in GRID_BASES:
                what = (f"{mode} int_bits={m} add={add} minus={minus} "
                        f"count={count} base_block={base}")
                err[mode] = max(err[mode], _same(
                    "mask kernel", fm.mask_apply(q, rk, 3, add, minus, m,
                                                 base_block=base),
                    fm.mask_apply_ref(q, rk, 3, add, minus, m,
                                      base_block=base), what))
                n_ok += 1
            del q
        print(f"grid {mode} int_bits={m} streams (add {add}, minus {minus}): "
              f"{n_ok} (count, base_block) cases bit-exact against the plain "
              f"version ({time.perf_counter() - t0:.1f} s)")
    # the scatter into a full-width aggregate
    n = N_FEMNIST
    loc_sets = {
        "empty": torch.zeros(0, dtype=torch.int64, device=dev),
        "one element (the last)": torch.tensor([n - 1], device=dev),
        "dense": torch.arange(n, device=dev),
        "random 10%": torch.sort(torch.randperm(
            n, generator=gen, device=dev)[:n // 10]).values}
    for m in GRID_INT_BITS:
        t0, n_ok = time.perf_counter(), 0
        agg = _rand_lanes(gen, dev, n, m)
        for name, loc in loc_sets.items():
            for add in (None, 8):
                for base in SCATTER_BASES:
                    got = fm.mask_scatter(agg.clone(), loc, rk, 3, add, 7, m,
                                          base_block=base)
                    want = fm.mask_scatter_ref(agg.clone(), loc, rk, 3, add,
                                               7, m, base_block=base)
                    err["scatter"] = max(err["scatter"], _same(
                        "mask kernel", got, want, f"scatter int_bits={m} "
                        f"{name} add={add} base_block={base}"))
                    n_ok += 1
        print(f"grid scatter int_bits={m}: {n_ok} (locations {list(loc_sets)}"
              f", minus stream alone and both, base_block {SCATTER_BASES}) "
              f"cases bit-exact against the plain version "
              f"({time.perf_counter() - t0:.1f} s)")
    return err


def make_clients(dev, codec, n, int_bits=INT_BITS, batch=False,
                 mask="double"):
    """n client blocks; mask "dynamic" starts on the double mask, as the
    JAX package's blocks do, until the arbiter's choice arrives."""
    blocks = []
    for i in range(n):
        c = FlasheCipher(int_bits, mask="double" if mask == "dynamic"
                         else mask, device=dev)
        c.idx = i
        c.set_num_clients(n)
        c.generate_prp_seed(assigned_seed=SEED)
        q = QuantizingClient(int_bits, batch, ELEMENT_BITS, True, True,
                             seed=i, device=dev)
        q.set_num_clients(n)
        q.set_codec(codec)
        blocks.append(ClientBlock(c, q))
    return blocks


def client_flats(dev, codec, model, n):
    """The global model plus each client's own seeded perturbation."""
    g = codec.flatten(model.params_to_flax())
    gen = torch.Generator(dev).manual_seed(SEED)
    return [g + 0.01 * torch.randn(g.shape, generator=gen, device=dev)
            for _ in range(n)]


def reset_launches():
    """Set the mask kernel's launch counters to 0."""
    fm.launches = 0
    for k in fm.mode_launches:
        fm.mode_launches[k] = 0


def run_round(dev, model, survivors, it, int_bits=INT_BITS, batch=False):
    """One round: every client uploads, the arbiter sums the survivors'
    ciphertexts (the others missed the deadline), client 0 downloads.
    With batch (path B) the clients precompute as the configuration asks,
    which is a no-op.  Returns the kernel launches of the round by mode,
    its host time and what the checks need."""
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    blocks = make_clients(dev, codec, N_CLIENTS, int_bits, batch)
    flats = client_flats(dev, codec, model, N_CLIENTS)

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    if batch:
        for b in blocks:  # the precompute bootstrap of the configuration
            b.cipher.set_num_params(B_PARAMS)
            b.cipher.prepare_encrypt()
    ups = [client_upload(blocks[i], codec, flats[i], it)
           for i in range(N_CLIENTS)]
    agg = arbiter_reduce([ups[i].lanes for i in survivors], int_bits)
    idx_list = [j for i in survivors for j in ups[i].idx_list]
    new = client_download(blocks[0], agg, idx_list, codec.total,
                          sum(ups[i].degree for i in survivors))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(fm.mode_launches), seconds, dict(
        codec=codec, blocks=blocks, flats=flats, ups=ups, agg=agg,
        idx_list=idx_list, new=new)


def run_sparse_round(dev, codec, state, before, survivors, it, mask):
    """One sparsified round (paths S and D): every client selects its
    top-10% and sends the encoded locations, the arbiter broadcasts its
    masking choice, every client uploads its compacted ciphertexts and
    filler, the arbiter densifies and sums the survivors', client 0
    downloads.  The other clients would decode the same aggregate into the
    same model, so their layer statistics are copied from client 0's.
    Returns the launches by mode, the host seconds of each phase and what
    the checks need."""
    blocks, sparsifiers = state["blocks"], state["sparsifiers"]
    gen = torch.Generator(dev).manual_seed(SEED + 10 + it)
    flats = [before + 0.01 * torch.randn(before.shape, generator=gen,
                                         device=dev)
             for _ in range(N_CLIENTS)]
    quant0 = blocks[0].quantizer
    past_mean = quant0.past_mean.copy()
    secs = {}
    torch.cuda.synchronize()
    reset_launches()
    packer = dict(native.calls)
    t0 = time.perf_counter()
    sels = [client_select(b, sp, f, before)
            for b, sp, f in zip(blocks, sparsifiers, flats)]
    torch.cuda.synchronize()
    secs["select + encode x 10"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    masks = [decode_locations(s.encoded) for s in sels]
    secs["decode x 10"] = time.perf_counter() - t0
    packer = {k: v - packer[k] for k, v in native.calls.items()}
    t0 = time.perf_counter()
    broadcast = arbiter_masking(masks, codec.total, mask, device=dev)
    secs["masking choice"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ups = [client_upload_sparse(b, s, broadcast, it)
           for b, s in zip(blocks, sels)]
    torch.cuda.synchronize()
    secs["install + quantize + encrypt x 10"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    agg = arbiter_reduce([ups[i].lanes for i in survivors], INT_BITS,
                         masks=[masks[i] for i in survivors],
                         total=codec.total)
    torch.cuda.synchronize()
    secs["densify + sum"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx_list = [j for i in survivors for j in ups[i].idx_list]
    new = client_download(blocks[0], agg, idx_list, codec.total,
                          sum(ups[i].degree for i in survivors),
                          before=before)
    torch.cuda.synchronize()
    secs["decrypt + decode"] = time.perf_counter() - t0
    launches = dict(fm.mode_launches)
    for b in blocks[1:]:
        b.quantizer.past_mean = quant0.past_mean.copy()
        b.quantizer.past_std = quant0.past_std.copy()
    return launches, secs, dict(
        codec=codec, blocks=blocks, sels=sels, masks=masks,
        broadcast=broadcast, ups=ups, agg=agg, idx_list=idx_list, new=new,
        before=before, past_mean=past_mean, alpha=quant0.alpha.copy(),
        packer=packer)


def check_sparse_round(dev, survivors, it, r):
    """Decrypted lanes == the survivors' densified q, summed mod 2^20; the
    new model within one quantization step of what the clients sent:
    before + the layer means + the mean of the clipped normalized values
    at each client's locations (its filler, quantized 0, elsewhere)."""
    codec, blocks, ups = r["codec"], r["blocks"], r["ups"]
    rk = blocks[0].cipher._round_keys
    double = r["broadcast"]["choice"] == "double"
    total = codec.total
    want = torch.zeros(total, dtype=torch.int64, device=dev)
    sent = torch.zeros(total, dtype=torch.float32, device=dev)
    mean = codec.spread(torch.as_tensor(r["past_mean"], device=dev))
    alpha = codec.spread(torch.as_tensor(r["alpha"], device=dev))
    for i in survivors:
        loc = torch.as_tensor(r["masks"][i], device=dev)
        # client i's q, recovered with the plain version of its streams
        q = fm.mask_apply_ref(ups[i].lanes[:-1], rk, it,
                              i + 1 if double else None, i, INT_BITS)
        zero = lanes.as_u32(ups[i].lanes[-1:])
        # a value clipped at +alpha may round up to 2^16
        if int(q.min()) < 0 or int(q.max()) > 1 << ELEMENT_BITS or not (
                0 <= int(zero) < 1 << ELEMENT_BITS):
            raise AssertionError(f"client {i}: a recovered q is outside "
                                 "[0, 2^16]")
        dense = zero.repeat(total)
        dense[loc] = lanes.as_u32(q)
        want += dense
        x = r["sels"][i].result.values - mean[loc]
        sent[loc] += torch.maximum(torch.minimum(x, alpha[loc]), -alpha[loc])
    dec = blocks[0].cipher.decrypt(r["agg"], r["idx_list"])
    if not torch.equal(lanes.as_u32(dec), want % (1 << INT_BITS)):
        raise AssertionError("decrypted lanes != the survivors' densified q "
                             "summed mod 2^20")
    new = r["new"]
    if new.shape != (N_FEMNIST,) or not bool(torch.isfinite(new).all()):
        raise AssertionError("new global model is not finite or has the "
                             "wrong shape")
    expect = r["before"] + mean + sent / len(survivors)
    step = 2 * alpha / ((1 << ELEMENT_BITS) - 1)
    err = (new - expect).abs()
    if bool((err > step).any()):
        raise AssertionError(f"new model off what the clients sent by "
                             f"{float((err / step).max()):.3f} steps")
    return float((err / step).max())


def run_sparse_path(dev, model, name, mask, rounds):
    """A sparse path: `rounds` of (iteration, survivors) with the same
    clients, whose residual memory carries from round to round.  Checks
    each round and its launches: every client's encrypt is one launch (the
    single mask's add stream, or the double mask), the decrypt one scatter
    a survivor; every client's locations encoded and decoded by the
    native packer (csrc/packing.cpp).  Returns the first round's launches
    and the results."""
    if not native.available():
        raise AssertionError(f"path {name}: the native packer did not "
                             f"build: {native.last_error('packing')}")
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    state = {"blocks": make_clients(dev, codec, N_CLIENTS, mask=mask),
             "sparsifiers": [Sparsifier(codec, SPARSITY)
                             for _ in range(N_CLIENTS)]}
    before = codec.flatten(model.params_to_flax())
    out = []
    for it, survivors in rounds:
        launches, secs, r = run_sparse_round(dev, codec, state, before,
                                             survivors, it, mask)
        choice = r["broadcast"]["choice"]
        if mask == "dynamic" and choice != "single":
            raise AssertionError(f"path {name}: the dynamic choice is "
                                 f"{choice}, not single")
        counts = {len(s.result.locations) for s in r["sels"]}
        if counts != {N_COMPACT}:
            raise AssertionError(f"path {name}: compact counts {counts}, "
                                 f"expected {N_COMPACT}")
        enc_mode = "single" if choice == "single" else "double"
        want = dict.fromkeys(fm.MODES, 0)
        want[enc_mode] = N_CLIENTS
        want["scatter"] = len(survivors)
        if launches != want:
            raise AssertionError(f"path {name} iter {it}: launches "
                                 f"{launches}, expected {want}")
        packed = {"pack": N_CLIENTS, "unpack": N_CLIENTS}
        if r["packer"] != packed:
            raise AssertionError(f"path {name} iter {it}: native packer "
                                 f"calls {r['packer']}, expected {packed}")
        worst = check_sparse_round(dev, survivors, it, r)
        print(f"path {name} iter={it} survivors={len(survivors)}/{N_CLIENTS}"
              f": masking {mask!r} -> choice {choice!r}, {N_COMPACT} compact "
              f"lanes a client, kernel launches {sum(launches.values())} "
              f"({launches}), locations through the native packer "
              f"({r['packer']}), decrypted == densified sum(q) mod 2^{INT_BITS},"
              f" new model within {worst:.3f} steps of what the clients sent;"
              f" host time by phase (first run): " + ", ".join(
                  f"{k} {v * 1e3:.1f} ms" for k, v in secs.items()))
        out.append((launches, secs, r))
        before = r["new"]
    return out


def time_round_phases(dev, model, reps=7):
    """Median ms of each phase of the full FLASHE round over reps rounds
    after one warm-up round, host clock with a synchronize around each
    phase: the 10 clients' normalize + quantize, their encrypts, the
    arbiter's sum, client 0's decrypt, its unquantize + unnormalize."""
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    blocks = make_clients(dev, codec, N_CLIENTS)
    flats = client_flats(dev, codec, model, N_CLIENTS)
    acc = {}

    def timed(fn, key):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return out
        return call

    for b in blocks:
        b.encrypt = timed(b.encrypt, "encrypt")
    blocks[0].decrypt = timed(blocks[0].decrypt, "decrypt")
    samples = []
    for i in range(reps + 1):
        acc.update(encrypt=0.0, decrypt=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ups = [client_upload(b, codec, f, 100 + i)
               for b, f in zip(blocks, flats)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        agg = arbiter_reduce([u.lanes for u in ups], INT_BITS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        client_download(blocks[0], agg, [j for u in ups for j in u.idx_list],
                        codec.total, sum(u.degree for u in ups))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        samples.append({
            "normalize + quantize x 10": t1 - t0 - acc["encrypt"],
            "encrypt x 10": acc["encrypt"], "sum": t2 - t1,
            "decrypt": acc["decrypt"],
            "unquantize + unnormalize": t3 - t2 - acc["decrypt"]})
    return {k: statistics.median(s[k] for s in samples[1:]) * 1e3
            for k in samples[0]}


def check_round(dev, survivors, it, r, int_bits=INT_BITS, batch=False):
    """Decrypted lanes == sum(q) mod 2^m; new model within one step."""
    codec, blocks, ups = r["codec"], r["blocks"], r["ups"]
    rk = blocks[0].cipher._round_keys
    # each client's q, recovered with the plain version of its own masks
    qs = [fm.mask_apply_ref(ups[i].lanes, rk, it, i + 1, i, int_bits)
          for i in survivors]
    for q in qs:
        fields = (qops.unbatch_lanes(q, codec.total, int_bits, ELEMENT_BITS,
                                     blocks[0].quantizer.factor)
                  if batch else q)
        if int(fields.min()) < 0 or int(fields.max()) >= 1 << ELEMENT_BITS:
            raise AssertionError("a recovered q is outside [0, 2^16)")
    want = qs[0]
    for q in qs[1:]:
        want = lanes.lane_add(want, q, int_bits)
    dec = blocks[0].cipher.decrypt(r["agg"], r["idx_list"])
    if not torch.equal(dec, want):
        raise AssertionError(f"decrypted lanes != sum(q) mod 2^{int_bits}")
    new = r["new"]
    if new.shape != (N_FEMNIST,) or not bool(torch.isfinite(new).all()):
        raise AssertionError("new global model is not finite or has the "
                             "wrong shape")
    mean = sum(r["flats"][i] for i in survivors) / len(survivors)
    step = codec.spread(torch.as_tensor(
        2 * blocks[0].quantizer.alpha / ((1 << ELEMENT_BITS) - 1),
        device=dev))
    err = (new - mean).abs()
    if bool((err > step).any()):
        raise AssertionError(f"new model off the clients' mean by "
                             f"{float((err / step).max()):.3f} steps")
    return float((err / step).max())


def time_kernel(dev, count, reps=50, plain_reps=10):
    """ms a call of the mask kernel over CUDA graphs of calls (its time on
    the card), of its plain version, and of the kernel over runs of calls
    from the host (which the host's launch rate holds back once the kernel
    is shorter than a launch); the mean of two each."""
    rk = round_keys(dev)
    q = lanes.to_i32(torch.randint(0, 1 << 16, (count,), device=dev,
                                   dtype=torch.int64))

    def kern():
        return fm.mask_apply(q, rk, 0, 1, 2, INT_BITS)

    calls, plain = time_turns(
        kern, lambda: fm.mask_apply_ref(q, rk, 0, 1, 2, INT_BITS), reps,
        plain_reps)
    return (statistics.mean(graph_ms(kern, reps) for _ in range(2)), plain,
            calls)


def time_mask(dev, card, counts=(N_FEMNIST, 4_194_304)):
    """The mask kernel at the round's lanes and at 4,194,304, beside its
    bound and its plain version; returns {count: (ms, plain ms, ms over
    calls from the host)}."""
    times = {}
    for count in counts:
        times[count] = k, p, calls = time_kernel(dev, count)
        bound, by = mask_bound(count, card)
        print(f"{count} lanes, int_bits {INT_BITS}: mask kernel {k:.4f} ms a "
              f"call over CUDA graphs of calls, bound {bound:.4f} ms by {by}, "
              f"share {bound / k:.3f}; {calls:.4f} ms a call over runs of "
              f"calls from the host; plain torch {p:.4f} ms (CUDA events)")
    return times


def has_modes() -> bool:
    """Whether the built mask library has the other modes' entry point (an
    older csrc/flashe_mask.cu dropped into a copy of the tree has not)."""
    return hasattr(_build.load("flashe_mask"), "flashe_mask_apply_modes")


def time_mode(kern, plain, bound):
    """ms a call of kern() over CUDA graphs of 50 calls (the mean of two),
    over runs of host calls, and of plain(), beside the bound."""
    calls, plain_ms = time_turns(kern, plain, 50, 10)
    ms = statistics.mean(graph_ms(kern, 50) for _ in range(2))
    return dict(ms=ms, host_calls_ms=calls, plain_ms=plain_ms,
                bound=bound)


def time_modes(dev, card):
    """The mask kernel's other modes at their paths' shapes: one stream
    (path S's encrypt, 120,655 lanes), the scatter with one stream and
    with two (the decrypt of S and of D: 120,655 sorted random locations in
    1,206,590 lanes), and 120-bit limbs with both streams (path B's
    encrypt, 201,099 lanes).  Returns {mode: times}."""
    rk = round_keys(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    q = _rand_lanes(gen, dev, N_COMPACT, INT_BITS)
    agg = _rand_lanes(gen, dev, N_FEMNIST, INT_BITS)
    loc = torch.sort(torch.randperm(N_FEMNIST, generator=gen,
                                    device=dev)[:N_COMPACT]).values
    sectors = int(torch.unique(loc >> 3).numel())
    ql = _rand_lanes(gen, dev, B_LANES, B_BITS)
    out = {}
    out["single"] = time_mode(
        lambda: fm.mask_apply(q, rk, 0, 1, None, INT_BITS),
        lambda: fm.mask_apply_ref(q, rk, 0, 1, None, INT_BITS),
        mask_bound(N_COMPACT, card, streams=1))
    out["single"]["shape"] = (f"{N_COMPACT} lanes, int_bits {INT_BITS}, the "
                              "add stream (path S's encrypt)")
    for name, add, streams in (("scatter", None, 1), ("scatter double", 2, 2)):
        out[name] = time_mode(
            lambda: fm.mask_scatter(agg, loc, rk, 0, add, 1, INT_BITS),
            lambda: fm.mask_scatter_ref(agg, loc, rk, 0, add, 1, INT_BITS),
            mask_bound(N_COMPACT, card, streams=streams, sectors=sectors))
        out[name]["shape"] = (
            f"{N_COMPACT} sorted random locations in {N_FEMNIST} lanes "
            f"({sectors} 32-byte sectors), int_bits {INT_BITS}, "
            + ("the minus stream (path S's decrypt, a survivor)"
               if add is None else "both streams (path D's decrypt)"))
    out["limbs"] = time_mode(
        lambda: fm.mask_apply(ql, rk, 0, 1, 2, B_BITS),
        lambda: fm.mask_apply_ref(ql, rk, 0, 1, 2, B_BITS),
        mask_bound(B_LANES, card, m=B_BITS))
    out["limbs"]["shape"] = (f"{B_LANES} lanes x 4 limbs, int_bits {B_BITS},"
                             " both streams (path B's encrypt)")
    for name, t in out.items():
        b, by = t["bound"]
        print(f"mask kernel, mode {name}, {t['shape']}: {t['ms']:.4f} ms a "
              f"call over CUDA graphs of calls, bound {b:.4f} ms by {by}, "
              f"share {b / t['ms']:.3f}; {t['host_calls_ms']:.4f} ms a call "
              f"over runs of calls from the host; plain torch "
              f"{t['plain_ms']:.4f} ms (CUDA events)")
    return out


# ---------------------------------------------------------------------------
# the Montgomery kernels and the Paillier round
# ---------------------------------------------------------------------------

def _modulus(rng, bits, top_ones=False):
    n = rng.getrandbits(bits) | 1 | (1 << (bits - 1))
    if top_ones:  # the top 32-bit limb all ones
        n |= 0xFFFFFFFF << (bits - 32)
    return n


def _operands(rng, n, count):
    """count values below n, led by the edges 0, 1 and n - 1."""
    vals = [0, 1, n - 1] + [rng.randrange(n) for _ in range(count)]
    return vals[:count]


def _same(name, got, want, what):
    """Max |got - want| over uint32 limbs; raises unless they are equal."""
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name} != plain version at {what}")
    return 0 if got.numel() == 0 else int(
        (lanes.as_u32(got) - lanes.as_u32(want)).abs().max())


def _mont_label(bits, ones=False):
    L = -(-bits // 32)
    tpi, k = mg.layout(L)
    return (f"{bits}-bit{', top limb all ones' if ones else ''} (L {L}, "
            f"{tpi} threads x {k} limbs)")


def _mont_cases():
    # all-ones top limbs put n near R, where the CIOS result overflows R
    # most often; at 64 bits a row's registers also hold limbs above L
    return [(_mont_label(b), b, False) for b in MONT_BITS] + [
        (_mont_label(b, True), b, True) for b in (64, 2048, 4096)]


def check_layouts():
    """The grid's limb counts against the kernels' dispatch, as the library
    reports it: both sides of every boundary between two (threads a row,
    limbs a thread) instances, and in every instance an L that is not a
    multiple of its limbs a thread.  Returns the instances."""
    table = {L: mg.layout(L) for L in range(1, mg.MAX_LIMBS + 1)}
    grid = {-(-bits // 32) for bits in MONT_BITS}
    edges = [L for L in range(1, mg.MAX_LIMBS) if table[L] != table[L + 1]]
    missing = sorted({L for e in edges for L in (e, e + 1)} - grid)
    if missing:
        raise AssertionError(f"the grid misses L = {missing} at a boundary "
                             f"of the layouts {table}")
    for inst in set(table.values()):
        if not any(table[L] == inst and L % inst[1] for L in grid):
            raise AssertionError(f"no L of the grid runs a tail in {inst}")
    return sorted(set(table.values()))


def check_montgomery_grid(dev):
    """mont_mul and mont_mul_vec against their plain versions (and a python
    oracle at up to 8 rows); returns the max errors."""
    rng = random.Random(SEED)
    err = {"mont_mul": 0, "mont_mul_vec": 0}
    print(f"kernel layouts (threads a row, limbs a thread): "
          f"{check_layouts()}; the grid covers both sides of each boundary")
    for label, bits, ones in _mont_cases():
        t0 = time.perf_counter()
        n1, n2 = _modulus(rng, bits, ones), _modulus(rng, bits, ones)
        ctx, pair = modmath.MontCtx(n1, device=dev), modmath.PairMontCtx(
            n1, n2, device=dev)
        L, rinv = ctx.L, [pow(ctx.R, -1, m) for m in (n1, n2)]
        for B in MONT_ROWS:
            ai = _operands(rng, n1, B)
            bi = _operands(rng, n1, B)[::-1]
            a, b = (modmath.to_limbs(v, L).to(dev) for v in (ai, bi))
            got = mg.mont_mul(a, b, ctx.n_limbs, ctx.n_prime)
            what = f"{label}, {B} rows"
            err["mont_mul"] = max(err["mont_mul"], _same(
                "mont_mul", got, mg.mont_mul_ref(a, b, ctx.n_limbs,
                                                 ctx.n_prime), what))
            if B <= 8 and modmath.from_limbs(got) != [
                    x * y * rinv[0] % n1 for x, y in zip(ai, bi)]:
                raise AssertionError(f"mont_mul != a*b/R mod n at {what}")
            # per-row moduli: rows alternate between n1 and n2
            idx = torch.arange(B, device=dev) % 2
            mods = [(n1, n2)[k] for k in idx.tolist()]
            av = modmath.to_limbs([x % m for x, m in zip(ai, mods)], L).to(dev)
            bv = modmath.to_limbs([x % m for x, m in zip(bi, mods)], L).to(dev)
            nr, pr = pair.n_pat[idx], pair.npr_pat[idx]
            got = mg.mont_mul_vec(av, bv, nr, pr)
            err["mont_mul_vec"] = max(err["mont_mul_vec"], _same(
                "mont_mul_vec", got, mg.mont_mul_vec_ref(av, bv, nr, pr),
                what))
        print(f"{label}: mont_mul and mont_mul_vec bit-exact against their "
              f"plain versions at rows {MONT_ROWS} "
              f"({time.perf_counter() - t0:.1f} s)")
    return err


def check_exp_grid(dev, keypair):
    """mont_exp_rows against its plain version with 64-bit exponents, rows
    of two moduli mixed, one kernel launch at each row count; then the
    key's full CRT exponents against pow.  The plain version, whose time
    is its sequential products whatever the rows, runs once a modulus on
    the row counts' operands joined, and each launch is held against its
    rows of that."""
    rng = random.Random(SEED + 1)
    err = 0
    for label, bits, ones in _mont_cases():
        rows = MONT_ROWS if (bits, ones) == (2048, False) else (0, 1, 8, 129)
        t0 = time.perf_counter()
        mods = (_modulus(rng, bits, ones), _modulus(rng, bits))
        pair = modmath.PairMontCtx(*mods, device=dev)
        exps = (rng.getrandbits(64) | 1 << 63, rng.getrandbits(64))
        digits = torch.from_numpy(np.stack([
            modmath.exponent_digits(e, 64) for e in exps])).to(dev)
        tabs = (pair.n_pat, pair.npr_pat, pair.r2_pat, pair.one_pat, digits)
        cases = []
        for B in rows:
            idx = [rng.randrange(2) for _ in range(B)]
            ai = [v % mods[k] for v, k in zip(_operands(rng, mods[0], B),
                                               idx)]
            a = modmath.to_limbs(ai, pair.L).to(dev)
            mi = torch.tensor(idx, dtype=torch.int32, device=dev)
            cases.append((B, ai, idx, a, mi, mg.mont_exp_rows(a, mi, *tabs)))
        ref = mg.mont_exp_rows_ref(torch.cat([c[3] for c in cases]),
                                   torch.cat([c[4] for c in cases]), *tabs)
        lo = 0
        for B, ai, idx, _, _, got in cases:
            what = f"{label}, {B} rows"
            err = max(err, _same("mont_exp_rows", got, ref[lo:lo + B], what))
            lo += B
            if B <= 8 and modmath.from_limbs(got) != [
                    pow(x, exps[k], mods[k]) for x, k in zip(ai, idx)]:
                raise AssertionError(f"mont_exp_rows != pow at {what}")
        print(f"{label}: mont_exp_rows bit-exact against its plain version "
              f"at rows {rows}, 64-bit exponents "
              f"({time.perf_counter() - t0:.1f} s)")
    _, prv = keypair
    mods = (prv.psquare, prv.qsquare)
    pair = modmath.PairMontCtx(*mods, device=dev)
    nbits = max(prv.p.bit_length(), prv.q.bit_length())
    exps = (prv.p - 1, prv.q - 1)
    digits = torch.from_numpy(np.stack([
        modmath.exponent_digits(e, nbits) for e in exps])).to(dev)
    idx = [0, 1, 0, 1]
    ai = [rng.randrange(mods[k]) for k in idx]
    got = mg.mont_exp_rows(
        modmath.to_limbs(ai, pair.L).to(dev),
        torch.tensor(idx, dtype=torch.int32, device=dev), pair.n_pat,
        pair.npr_pat, pair.r2_pat, pair.one_pat, digits)
    if modmath.from_limbs(got) != [pow(x, exps[k], mods[k])
                                   for x, k in zip(ai, idx)]:
        raise AssertionError("mont_exp_rows != pow at the key's CRT "
                             "exponents")
    print(f"mont_exp_rows at the {nbits}-bit CRT exponents of the 2048-bit "
          "key (mod p^2 and q^2, 4 rows): equal to python pow")
    return err


def _instrument(block, rec):
    """Record the obfuscators a client draws, the lanes it encrypts and the
    encrypt's host time (the seams the tests use too)."""
    draw, encrypt = block.cipher._obfuscators, block.encrypt

    def obfuscators(count):
        rec["rs"] = draw(count)
        return rec["rs"]

    def timed_encrypt(q):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["q"] = q
        out = encrypt(q)
        rec["encrypt_s"] = time.perf_counter() - t0
        return out

    block.cipher._obfuscators = obfuscators
    block.encrypt = timed_encrypt


def run_paillier_round(dev, model, keypair):
    """10 x client_upload, the arbiter's product, client 0's download, all
    on the card.  Returns the launch counts of the run and what the checks
    and the timings need."""
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    clients, arbiter = pblocks.make_session(PAILLIER_ARGS, N_CLIENTS,
                                            device=dev, keypair=keypair)
    recs = [{} for _ in clients]
    for c, rec in zip(clients, recs):
        c.set_codec(codec)
        _instrument(c, rec)
    decrypt = clients[0].cipher.decrypt

    def recorded_decrypt(cts):
        recs[0]["sums"] = decrypt(cts)
        return recs[0]["sums"]

    clients[0].cipher.decrypt = recorded_decrypt
    flats = client_flats(dev, codec, model, N_CLIENTS)

    torch.cuda.synchronize()
    for k in mg.launches:
        mg.launches[k] = 0
    times = {"upload_s": []}
    ups = []
    for i in range(N_CLIENTS):
        t0 = time.perf_counter()
        ups.append(client_upload(clients[i], codec, flats[i], 0))
        torch.cuda.synchronize()
        times["upload_s"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    agg = arbiter_reduce([u.lanes for u in ups], block=arbiter)
    torch.cuda.synchronize()
    times["sum_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    new = client_download(clients[0], agg, None, codec.total,
                          float(N_CLIENTS))
    torch.cuda.synchronize()
    times["download_s"] = time.perf_counter() - t0
    return dict(mg.launches), dict(
        codec=codec, clients=clients, recs=recs, flats=flats, ups=ups,
        agg=agg, new=new, times=times)


def check_paillier_round(dev, keypair, launches, r):
    pub, prv = keypair
    codec, clients, recs, ups = r["codec"], r["clients"], r["recs"], r["ups"]
    packed, fields = [], []
    for i, (up, rec) in enumerate(zip(ups, recs)):
        if len(up.lanes) != N_CTS or len(rec["rs"]) != N_CTS:
            raise AssertionError(f"client {i}: {len(up.lanes)} ciphertexts, "
                                 f"expected {N_CTS}")
        packed.append(lanes.lanes_to_ints(rec["q"], PAILLIER_BITS))
        for j in (0, N_CTS // 2, N_CTS - 1):
            if up.lanes[j] != pub.encrypt_scalar(packed[-1][j], rec["rs"][j]):
                raise AssertionError(f"client {i} ciphertext {j} != "
                                     "encrypt_scalar(m, r)")
        fields.append(qops.unbatch_lanes(rec["q"], codec.total,
                                         PAILLIER_BITS, 16, PACK_FACTOR))
    if list(recs[0]["sums"]) != list(sum(packed)):
        raise AssertionError("decrypted sums != sum of the packed q")
    got = qops.unbatch_lanes(lanes.ints_to_lanes(
        recs[0]["sums"], PAILLIER_BITS).to(dev), codec.total, PAILLIER_BITS,
        16, PACK_FACTOR)
    if not torch.equal(got.long(), sum(f.long() for f in fields)):
        raise AssertionError("unpacked fields != per-element sum of q")
    new = r["new"]
    if new.shape != (N_FEMNIST,) or not bool(torch.isfinite(new).all()):
        raise AssertionError("new global model is not finite or has the "
                             "wrong shape")
    mean = sum(r["flats"]) / N_CLIENTS
    step = codec.spread(torch.as_tensor(
        2 * clients[0].quantizer.alpha / ((1 << ELEMENT_BITS) - 1),
        device=dev))
    worst = float(((new - mean).abs() / step).max())
    if worst > 1:
        raise AssertionError(f"new model off the clients' mean by {worst:.3f}"
                             " steps")
    # encrypt: into the domain, 15 table products, 4 squarings and one
    # multiply per digit of n, out; the sum: 10 in, 9 products, 1 out
    ndig = -(-pub.n.bit_length() // 4)
    per_encrypt = 1 + 15 + 5 * ndig + 1
    want = {"mont_mul": N_CLIENTS * per_encrypt + 2 * N_CLIENTS,
            "mont_mul_vec": 0, "mont_exp_rows": 1}
    if launches != want:
        raise AssertionError(f"Paillier round launches {launches}, "
                             f"expected {want}")
    return worst, per_encrypt


def check_small_decrypt(dev, keypair, r):
    """Decrypt the first 5 aggregate ciphertexts alone: the exp_pair route
    of single per-row-modulus products.  Returns its launch counts."""
    _, prv = keypair
    torch.cuda.synchronize()
    for k in mg.launches:
        mg.launches[k] = 0
    dec5 = r["clients"][0].cipher.decrypt(r["agg"][:5])
    torch.cuda.synchronize()
    launches = dict(mg.launches)
    ndig = -(-max(prv.p.bit_length(), prv.q.bit_length()) // 4)
    want = {"mont_mul": 0, "mont_mul_vec": 1 + 15 + 5 * ndig + 1,
            "mont_exp_rows": 0}
    if launches != want:
        raise AssertionError(f"5-row decrypt launches {launches}, "
                             f"expected {want}")
    if list(dec5) != list(r["recs"][0]["sums"][:5]):
        raise AssertionError("5-row decrypt != the full decrypt's first 5")
    return launches


def time_montgomery(dev, keypair):
    """Each Montgomery kernel against its plain version, and bench.py's
    paillier metric: modexp ciphertexts/s at batch 2048, exponent n."""
    rng = random.Random(SEED + 2)
    out = {}
    n = _modulus(rng, 4096)
    ctx = modmath.MontCtx(n, device=dev)
    a, b = (modmath.to_limbs([rng.randrange(n) for _ in range(2048)],
                             ctx.L).to(dev) for _ in range(2))
    out["mont_mul"] = time_turns(
        lambda: mg.mont_mul(a, b, ctx.n_limbs, ctx.n_prime),
        lambda: mg.mont_mul_ref(a, b, ctx.n_limbs, ctx.n_prime), 20, 3)
    _, prv = keypair
    pair = modmath.PairMontCtx(prv.psquare, prv.qsquare, device=dev)
    idx = torch.arange(2 * 2048, device=dev) // 2048
    mods = (prv.psquare, prv.qsquare)
    av, bv = (modmath.to_limbs([rng.randrange(mods[k]) for k in
                                idx.tolist()], pair.L).to(dev)
              for _ in range(2))
    nr, pr = pair.n_pat[idx], pair.npr_pat[idx]
    out["mont_mul_vec"] = time_turns(
        lambda: mg.mont_mul_vec(av, bv, nr, pr),
        lambda: mg.mont_mul_vec_ref(av, bv, nr, pr), 20, 3)
    digits = torch.from_numpy(np.stack([modmath.exponent_digits(
        rng.getrandbits(64), 64) for _ in range(2)])).to(dev)
    mi = idx.to(torch.int32)
    tabs = (pair.n_pat, pair.npr_pat, pair.r2_pat, pair.one_pat, digits)
    out["mont_exp_rows"] = time_turns(
        lambda: mg.mont_exp_rows(av, mi, *tabs),
        lambda: mg.mont_exp_rows_ref(av, mi, *tabs), 3, 1)
    for name, (k, p) in out.items():
        print(f"{name}: kernel {k:.4f} ms, plain torch {p:.4f} ms "
              f"(a call, over runs of back-to-back calls, CUDA events)")
    print("  shapes: mont_mul 2048 rows x 4096 bits; mont_mul_vec and "
          "mont_exp_rows 2 x 2048 rows x 2048 bits (p^2, q^2), "
          "mont_exp_rows with 64-bit exponents")
    # bench.py --mode paillier: mont_exp_window over 2048 rows mod n^2
    pub, _ = keypair
    ctx2 = modmath.MontCtx(pub.nsquare, device=dev)
    base = modmath.mont_from(ctx2, modmath.to_limbs(
        [rng.randint(1, 1 << 62) for _ in range(2048)], ctx2.L).to(dev))
    edig = modmath.exponent_digits(pub.n, pub.n.bit_length())
    ms = event_ms(lambda: modmath.mont_exp_window(ctx2, base, edig), 3)
    rate = 2048 / (statistics.median(ms) / 1e3)
    print(f"paillier2048 modexp (bench.py --mode paillier): 2048 rows, "
          f"exponent n, {statistics.median(ms):.2f} ms median of "
          f"{[round(v, 2) for v in ms]}: {rate:.1f} ciphertexts/s")
    return out, rate


def _turns_ms(fn, reps, runs=2):
    """ms a call of fn(): the mean of `runs` runs of `reps` calls."""
    fn()
    return statistics.mean(run_ms(fn, reps) for _ in range(runs))


def time_paths(dev, keypair, card):
    """Each Montgomery kernel at the shape its path gives it, beside its
    bound; the plain version at the same shape where it finishes in
    seconds."""
    pub, prv = keypair
    rng = random.Random(SEED + 3)
    out = {}
    # mont_mul: one encrypt's 12,066 products mod n^2
    ctx = modmath.MontCtx(pub.nsquare, device=dev)
    L = ctx.L
    a, b = (modmath.to_limbs([rng.randrange(pub.nsquare) for _ in
                              range(N_CTS)], L).to(dev) for _ in range(2))
    args = (a, b, ctx.n_limbs, ctx.n_prime)
    what = f"{N_CTS} rows x {32 * L} bits (mod n^2)"
    _same("mont_mul", mg.mont_mul(*args), mg.mont_mul_ref(*args), what)
    k, p = time_turns(lambda: mg.mont_mul(*args),
                      lambda: mg.mont_mul_ref(*args), 50, 1)
    out["mont_mul"] = dict(ms=k, plain_ms=p, shape=what, plain_shape=what,
                           bound=roofline.bound_ms(
                               roofline.mont_imads(N_CTS, L),
                               4 * L * (3 * N_CTS + 1), card))
    # mont_exp_rows: the decrypt's rows mod p^2 and q^2, CRT exponents
    pair = modmath.PairMontCtx(prv.psquare, prv.qsquare, device=dev)
    L = pair.L
    nbits = max(prv.p.bit_length(), prv.q.bit_length())
    exps, mods = (prv.p - 1, prv.q - 1), (prv.psquare, prv.qsquare)
    digits = torch.from_numpy(np.stack([
        modmath.exponent_digits(e, nbits) for e in exps])).to(dev)
    idx = [0] * N_CTS + [1] * N_CTS
    xs = [rng.randrange(mods[i]) for i in idx]
    x = modmath.to_limbs(xs, L).to(dev)
    mi = torch.tensor(idx, dtype=torch.int32, device=dev)
    tabs = (pair.n_pat, pair.npr_pat, pair.r2_pat, pair.one_pat, digits)
    got = modmath.from_limbs(mg.mont_exp_rows(x, mi, *tabs))
    rows = sorted(set(range(0, 2 * N_CTS, 997)) | {N_CTS - 1, N_CTS,
                                                  2 * N_CTS - 1})
    if any(got[r] != pow(xs[r], exps[idx[r]], mods[idx[r]]) for r in rows):
        raise AssertionError("mont_exp_rows != pow at the decrypt's shape")
    # into the domain, the table's 15, w squarings and one multiply a
    # digit, out
    squarings = mg.WINDOW * digits.shape[1]
    products = 1 + 15 + squarings + digits.shape[1] + 1
    what = (f"{2 * N_CTS} rows x {32 * L} bits (mod p^2, q^2), "
            f"{nbits}-bit exponents, {products} products a row, {squarings} "
            "of them squarings")
    out["mont_exp_rows"] = dict(
        ms=_turns_ms(lambda: mg.mont_exp_rows(x, mi, *tabs), 2), shape=what,
        bound=roofline.bound_ms(
            roofline.mont_imads(2 * N_CTS, L, products, squarings),
            4 * (2 * N_CTS * (2 * L + 1)), card))
    # mont_mul_vec: the 5-row decrypt's 10 rows, 5 mod p^2 and 5 mod q^2
    vi = torch.arange(10, device=dev) // 5
    av, bv = (modmath.to_limbs([rng.randrange(mods[i]) for i in
                                vi.tolist()], L).to(dev) for _ in range(2))
    vargs = (av, bv, pair.n_pat[vi], pair.npr_pat[vi])
    what = f"10 rows x {32 * L} bits (mod p^2, q^2)"
    _same("mont_mul_vec", mg.mont_mul_vec(*vargs), mg.mont_mul_vec_ref(
        *vargs), what)
    k, p = time_turns(lambda: mg.mont_mul_vec(*vargs),
                      lambda: mg.mont_mul_vec_ref(*vargs), 200, 5)
    out["mont_mul_vec"] = dict(ms=k, plain_ms=p, shape=what, plain_shape=what,
                               bound=roofline.bound_ms(
                                   roofline.mont_imads(10, L),
                                   4 * 10 * (4 * L + 1), card))
    for name, t in out.items():
        b, by = t["bound"]
        plain = (f", plain torch {t['plain_ms']:.4f} ms" if "plain_ms" in t
                 else "")
        print(f"{name} at {t['shape']}: kernel {t['ms']:.4f} ms{plain}; "
              f"bound {b:.4f} ms by {by}, share {b / t['ms']:.3f} (a call, "
              "over runs of back-to-back calls, CUDA events)")
    return out


# ---------------------------------------------------------------------------
# the federated rounds: roles over the in-memory broker and over TCP
# ---------------------------------------------------------------------------

def config_args(name):
    """(sparsity, secure_aggregate_args) of examples/configs/<name>."""
    with open(ROOT / "examples" / "configs" / name) as f:
        param = json.load(f)["param"]
    return param.get("sparsity", 1.0), dict(param["secure_aggregate_args"])


def record_client(agg, rec):
    """Record, round by round, a federated client's quantized lanes (with
    the layer means and alphas that made them) and its decrypted lanes:
    the seams the checks read, wrapped around its block's methods."""
    block = agg._block
    quantize, decrypt = block.quantize, block.decrypt

    def recorded_quantize(flat, uniforms=None):
        q = quantize(flat, uniforms=uniforms)
        rec.setdefault("q", []).append(q)
        rec.setdefault("past_mean", []).append(
            block.quantizer.past_mean.copy())
        rec.setdefault("alpha", []).append(np.array(block.quantizer.alpha))
        return q

    def recorded_decrypt(lanes, *args):
        out = decrypt(lanes, *args)
        rec.setdefault("dec", []).append(out)
        return out

    block.quantize, block.decrypt = recorded_quantize, recorded_decrypt


def record_sparse_client(agg, rec):
    """Record a sparse upload's compacted values and locations, its q and
    its quantized zero, and the decrypted lanes."""
    quant = agg._block.quantizer
    gather, qgather, zero = (quant.normalize_gather, quant.quantize_gather,
                             quant.quantized_zero)

    def recorded_gather(values, locations):
        rec.update(values=values, loc=locations,
                   past_mean=quant.past_mean.copy())
        return gather(values, locations)

    def recorded_qgather(values, locations, uniforms=None):
        rec["q"] = qgather(values, locations, uniforms=uniforms)
        rec["alpha"] = np.array(quant.alpha)
        return rec["q"]

    def recorded_zero(u=None):
        rec["zero"] = zero(u)
        return rec["zero"]

    quant.normalize_gather, quant.quantize_gather = (recorded_gather,
                                                    recorded_qgather)
    quant.quantized_zero = recorded_zero
    decrypt = agg._block.decrypt

    def recorded_decrypt(lanes, *args):
        rec["dec"] = decrypt(lanes, *args)
        return rec["dec"]

    agg._block.decrypt = recorded_decrypt


def phase_ms(before):
    """This thread's phases since `before` (a copy of its phase totals),
    in ms."""
    now = tracker().phase_totals
    return {k: (v - before.get(k, 0.0)) * 1e3 for k, v in now.items()
            if v > before.get(k, 0.0)}


def expected_model(codec, past_mean, alpha, sent):
    """What the round decodes to within a quantization step: the layer
    means plus the mean of the clients' normalized vectors, each clipped
    at its layer's alpha.  Returns (expected, step)."""
    mean = codec.spread(torch.as_tensor(past_mean, device=codec.device))
    a = codec.spread(torch.as_tensor(alpha, device=codec.device))
    clipped = sum(torch.maximum(torch.minimum(s - mean, a), -a) for s in sent)
    return mean + clipped / len(sent), 2 * a / ((1 << ELEMENT_BITS) - 1)


def steps_off(new, expect, step, what):
    worst = float(((new - expect).abs() / step).max())
    if new.shape != (N_FEMNIST,) or not bool(torch.isfinite(new).all()):
        raise AssertionError(f"{what}: the new model is not finite or has "
                             "the wrong shape")
    if worst > 1:
        raise AssertionError(f"{what}: the new model is off what the "
                             f"survivors sent by {worst:.3f} steps")
    return worst


def qsum(qs, int_bits=INT_BITS):
    """The summed quantized lanes mod 2^int_bits, as int64."""
    return sum(lanes.as_u32(q) for q in qs) % (1 << int_bits)


def run_fed_dense(dev, model):
    """The federated dense FLASHE round in memory: guest + 9 hosts +
    arbiter, one thread each on `dev`, through with_role, each with the
    full session setup (uuid, DH, seed wrap), over FED_ROUNDS rounds:
    round 1 with host 8 (client 9) asleep past upload_timeout_s, round 2
    with it back (the survivors sleep as long before round 2, standing in
    for local training, so that the arbiter's window opens after it has
    woken).  Every phase of a role synchronizes the card.  Returns the
    launches by mode and what the checks need."""
    _, args = config_args("cnn_flashe_q16_b1_pad.json")
    args["upload_timeout_s"] = FED_TIMEOUT_S
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    g0 = codec.flatten(model.params_to_flax())
    gen = torch.Generator(dev).manual_seed(SEED + 100)
    noise = [[0.01 * torch.randn(g0.shape, generator=gen, device=dev)
              for _ in range(N_CLIENTS)] for _ in range(FED_ROUNDS)]
    recs = [{"sent": [], "new": [], "dropped": [], "phases": [],
             "round_ms": []} for _ in range(N_CLIENTS)]
    slow = N_CLIENTS - 1

    def client(trv, i, role):
        set_tracker(Tracker(role, synchronize=torch.cuda.synchronize))
        agg = aggregator.with_role(role, trv, 1.0, "flashe", args,
                                   device=dev)
        rec = recs[i]
        rec["idx"] = agg._block.cipher.idx
        agg.set_codec(codec)
        record_client(agg, rec)
        flat = g0
        for r in range(FED_ROUNDS):
            if (r == 1 and i == slow) or (r == 2 and i != slow):
                time.sleep(FED_SLEEP_S)
            rec["sent"].append(flat + noise[r][i])
            before, t0 = dict(tracker().phase_totals), time.perf_counter()
            flat = agg.aggregate_then_get(rec["sent"][-1], iter_index=r,
                                          degree=1.0, suffix=(r,))
            torch.cuda.synchronize()
            rec["round_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["phases"].append(phase_ms(before))
            rec["new"].append(flat)
            rec["dropped"].append(agg.was_dropped)

    def arbiter(trv):
        set_tracker(Tracker("arbiter", synchronize=torch.cuda.synchronize))
        agg = aggregator.with_role("arbiter", trv, 1.0, "flashe", args,
                                   device=dev)
        out = []
        for r in range(FED_ROUNDS):
            before, t0 = dict(tracker().phase_totals), time.perf_counter()
            agg.aggregate_and_broadcast(iter_index=r, suffix=(r,))
            out.append({"dropped": list(agg.dropped_hosts),
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "phases": phase_ms(before)})
        return out

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = run_roles(N_CLIENTS - 1, lambda trv: client(trv, 0, "guest"),
                    lambda trv, h: client(trv, 1 + h, "host"), arbiter,
                    job_id="chip-smoke-fed", timeout=600)
    seconds = time.perf_counter() - t0
    return dict(fm.mode_launches), seconds, dict(
        codec=codec, recs=recs, arbiter=res["arbiter"])


def check_fed_dense(launches, r):
    codec, recs, arb = r["codec"], r["recs"], r["arbiter"]
    slow = N_CLIENTS - 1
    if [rec["idx"] for rec in recs] != list(range(N_CLIENTS)):
        raise AssertionError(f"ordinals {[rec['idx'] for rec in recs]}, "
                             "expected guest 0 and host h -> 1 + h")
    worst = []
    for rnd in range(FED_ROUNDS):
        dropped = arb[rnd]["dropped"]
        if dropped != ([slow - 1] if rnd == 1 else []):
            raise AssertionError(f"federated round {rnd}: the arbiter "
                                 f"dropped hosts {dropped}")
        survivors = [0] + [1 + h for h in range(N_CLIENTS - 1)
                           if h not in dropped]
        want = qsum([recs[i]["q"][rnd] for i in survivors])
        for i, rec in enumerate(recs):
            if rec["dropped"][rnd] != (rnd == 1 and i == slow):
                raise AssertionError(f"round {rnd}: client {i} was_dropped "
                                     f"{rec['dropped'][rnd]}")
            if not torch.equal(lanes.as_u32(rec["dec"][rnd]), want):
                raise AssertionError(f"round {rnd}: client {i}'s decrypted "
                                     "lanes != the survivors' summed q mod "
                                     f"2^{INT_BITS}")
            if not torch.equal(rec["new"][rnd], recs[0]["new"][rnd]):
                raise AssertionError(f"round {rnd}: client {i}'s new model "
                                     "differs from the guest's")
            if not (np.array_equal(rec["past_mean"][rnd],
                                   recs[0]["past_mean"][rnd])
                    and np.array_equal(rec["alpha"][rnd],
                                       recs[0]["alpha"][rnd])):
                raise AssertionError(f"round {rnd}: client {i}'s quantizer "
                                     "statistics are out of step")
        expect, step = expected_model(
            codec, recs[0]["past_mean"][rnd], recs[0]["alpha"][rnd],
            [recs[i]["sent"][rnd] for i in survivors])
        worst.append(steps_off(recs[0]["new"][rnd], expect, step,
                               f"federated round {rnd}"))
    # each round: 10 encrypts, and every client decrypts one boundary pair
    want = dict.fromkeys(fm.MODES, 0)
    want["double"] = FED_ROUNDS * (N_CLIENTS + N_CLIENTS * 1)
    if launches != want:
        raise AssertionError(f"federated rounds: launches {launches}, "
                             f"expected {want}")
    return worst


def run_fed_sparse(dev, model):
    """One federated sparse round in memory (cnn_flashe_s100_dyn.json:
    sparsity 0.1, dynamic masking), 10 clients, every one decrypting."""
    sparsity, args = config_args("cnn_flashe_s100_dyn.json")
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    before = codec.flatten(model.params_to_flax())
    gen = torch.Generator(dev).manual_seed(SEED + 200)
    flats = [before + 0.01 * torch.randn(before.shape, generator=gen,
                                         device=dev)
             for _ in range(N_CLIENTS)]
    recs = [{} for _ in range(N_CLIENTS)]

    def client(trv, i, role):
        set_tracker(Tracker(role, synchronize=torch.cuda.synchronize))
        agg = aggregator.with_role(role, trv, sparsity, "flashe", args,
                                   device=dev)
        agg.set_codec(codec)
        record_sparse_client(agg, recs[i])
        before_t, t0 = dict(tracker().phase_totals), time.perf_counter()
        recs[i]["new"] = agg.aggregate_then_get(flats[i], iter_index=0,
                                                before=before, degree=1.0,
                                                suffix=(0,))
        torch.cuda.synchronize()
        recs[i]["ms"] = (time.perf_counter() - t0) * 1e3
        recs[i]["phases"] = phase_ms(before_t)
        recs[i]["choice"] = agg._block.cipher.masking_scheme

    def arbiter(trv):
        agg = aggregator.with_role("arbiter", trv, sparsity, "flashe", args,
                                   device=dev)
        agg.aggregate_and_broadcast(iter_index=0, suffix=(0,))

    torch.cuda.synchronize()
    reset_launches()
    run_roles(N_CLIENTS - 1, lambda trv: client(trv, 0, "guest"),
              lambda trv, h: client(trv, 1 + h, "host"), arbiter,
              job_id="chip-smoke-sparse", timeout=600)
    launches = dict(fm.mode_launches)

    choices = {rec["choice"] for rec in recs}
    if choices != {"single"}:
        raise AssertionError(f"federated sparse round: choices {choices}, "
                             "expected single")
    want = dict.fromkeys(fm.MODES, 0)
    want.update(single=N_CLIENTS, scatter=N_CLIENTS * N_CLIENTS)
    if launches != want:
        raise AssertionError(f"federated sparse round: launches {launches},"
                             f" expected {want}")
    total = codec.total
    dense_q = torch.zeros(total, dtype=torch.int64, device=dev)
    sent = torch.zeros(total, dtype=torch.float32, device=dev)
    mean = codec.spread(torch.as_tensor(recs[0]["past_mean"], device=dev))
    alpha = codec.spread(torch.as_tensor(recs[0]["alpha"], device=dev))
    for rec in recs:
        if rec["loc"].shape[0] != N_COMPACT:
            raise AssertionError(f"{rec['loc'].shape[0]} compact lanes, "
                                 f"expected {N_COMPACT}")
        d = torch.full((total,), rec["zero"], dtype=torch.int64, device=dev)
        d[rec["loc"]] = lanes.as_u32(rec["q"])
        dense_q += d
        x = rec["values"] - mean[rec["loc"]]
        sent[rec["loc"]] += torch.maximum(torch.minimum(x, alpha[rec["loc"]]),
                                          -alpha[rec["loc"]])
    for i, rec in enumerate(recs):
        if not torch.equal(lanes.as_u32(rec["dec"]),
                           dense_q % (1 << INT_BITS)):
            raise AssertionError(f"federated sparse round: client {i}'s "
                                 "decrypted lanes != the densified q "
                                 f"summed mod 2^{INT_BITS}")
        if not torch.equal(rec["new"], recs[0]["new"]):
            raise AssertionError(f"federated sparse round: client {i}'s new "
                                 "model differs from the guest's")
    worst = steps_off(recs[0]["new"], before + mean + sent / N_CLIENTS,
                      2 * alpha / ((1 << ELEMENT_BITS) - 1),
                      "federated sparse round")
    return launches, worst, recs


def run_fed_paillier(dev, model, n_clients=FED_PAILLIER_CLIENTS):
    """One federated Paillier round in memory
    (cnn_paillier_q16_b100_pad.json) with n_clients at full width: the
    guest generates the 2048-bit key in the run and wraps (p, q) to the
    hosts; every client decrypts.  Returns the Montgomery launches and
    what the checks need."""
    _, args = config_args("cnn_paillier_q16_b100_pad.json")
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    flats = client_flats(dev, codec, model, n_clients)
    recs = [{} for _ in range(n_clients)]

    def client(trv, i, role):
        set_tracker(Tracker(role))
        agg = aggregator.with_role(role, trv, 1.0, "paillier", args,
                                   device=dev)
        rec = recs[i]
        rec["n"] = agg._block.cipher.get_n()
        agg.set_codec(codec)
        record_client(agg, rec)
        decrypt = agg._block.cipher.decrypt

        def recorded_sums(cts):
            rec["sums"] = decrypt(cts)
            return rec["sums"]

        agg._block.cipher.decrypt = recorded_sums
        t0 = time.perf_counter()
        rec["new"] = agg.aggregate_then_get(flats[i], iter_index=0,
                                            degree=1.0, suffix=(0,))
        torch.cuda.synchronize()
        rec["s"] = time.perf_counter() - t0
        rec["phases"] = phase_ms({})

    def arbiter(trv):
        agg = aggregator.with_role("arbiter", trv, 1.0, "paillier", args,
                                   device=dev)
        agg.aggregate_and_broadcast(iter_index=0, suffix=(0,))

    torch.cuda.synchronize()
    for k in mg.launches:
        mg.launches[k] = 0
    t0 = time.perf_counter()
    run_roles(n_clients - 1, lambda trv: client(trv, 0, "guest"),
              lambda trv, h: client(trv, 1 + h, "host"), arbiter,
              job_id="chip-smoke-paillier", timeout=900)
    seconds = time.perf_counter() - t0
    launches = dict(mg.launches)

    n, bits = recs[0]["n"], args["key_length"]
    if n.bit_length() != bits or {rec["n"] for rec in recs} != {n}:
        raise AssertionError(f"the clients do not share the guest's "
                             f"{bits}-bit key")
    packed = [lanes.lanes_to_ints(rec["q"][0], PAILLIER_BITS) for rec in recs]
    for i, rec in enumerate(recs):
        if list(rec["sums"]) != list(sum(packed)):
            raise AssertionError(f"federated Paillier round: client {i}'s "
                                 "decrypted sums != the sum of the packed q")
        if not torch.equal(rec["new"], recs[0]["new"]):
            raise AssertionError(f"federated Paillier round: client {i}'s "
                                 "new model differs from the guest's")
    expect, step = expected_model(codec, recs[0]["past_mean"][0],
                                  recs[0]["alpha"][0], flats)
    worst = steps_off(recs[0]["new"], expect, step, "federated Paillier round")
    ndig = -(-n.bit_length() // 4)
    per_encrypt = 1 + 15 + 5 * ndig + 1
    want = {"mont_mul": n_clients * per_encrypt + 2 * n_clients,
            "mont_mul_vec": 0, "mont_exp_rows": n_clients}
    if launches != want:
        raise AssertionError(f"federated Paillier round: launches "
                             f"{launches}, expected {want}")
    return launches, seconds, worst, recs


def tcp_child(role: str, broker: str, workdir: str) -> int:
    """One party of the TCP round, in its own process on cuda:0: its
    session setup and one dense round over the broker at `broker`
    (host:port), wire_pack on.  Writes what the parent checks to
    workdir/<role>.pt."""
    dev = torch.device("cuda", 0)
    host, port = broker.rsplit(":", 1)
    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    parties = default_parties(1)
    party = {"guest": parties[0], "host": parties[1],
             "arbiter": parties[2]}[role]
    fed = TcpFederation((host, int(port)), "chip-smoke-tcp", party, parties,
                        HomoTransferVariables.authorization())
    trv = HomoTransferVariables(fed)
    _, args = config_args("cnn_flashe_q16_b1_pad.json")
    args["wire_pack"] = True
    reset_launches()
    t0 = time.perf_counter()
    agg = aggregator.with_role(role, trv, 1.0, "flashe", args, device=dev)
    out = {"setup_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    if role == "arbiter":
        agg.aggregate_and_broadcast(iter_index=0, suffix=(0,))
    else:
        i = 0 if role == "guest" else 1
        codec = WeightsCodec(FemnistCNN(device=dev).params_to_flax(),
                             device=dev)
        agg.set_codec(codec)
        rec = {}
        record_client(agg, rec)
        new = agg.aggregate_then_get(inputs["flats"][i].to(dev), iter_index=0,
                                     degree=1.0, suffix=(0,))
        out.update(idx=agg._block.cipher.idx, q=rec["q"][0].cpu(),
                   dec=rec["dec"][0].cpu(), new=new.cpu(),
                   past_mean=rec["past_mean"][0], alpha=rec["alpha"][0])
    torch.cuda.synchronize()
    out.update(round_s=time.perf_counter() - t0,
               launches=dict(fm.mode_launches), stats=fed.stats.summary(),
               packer=dict(native.calls))
    torch.save(out, Path(workdir) / f"{role}.pt")
    fed.close()
    return 0


def run_tcp_round(dev, model):
    """The dense round across processes: the port's native FedBroker
    (csrc/fedbroker.cpp, a child of this process) on 127.0.0.1, then the
    guest, one host and the arbiter as three child processes (this script
    with --tcp-role), each on cuda:0 with the kernels already built; each
    client's upload packed and the arbiter's two unpacked by the native
    packer.  A child that fails, or the three running past 600 s, fails
    the run; every child is stopped."""
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    flats = client_flats(dev, codec, model, 2)
    broker = FedBroker("127.0.0.1", 0, native=True)
    if broker._proc is None:
        broker.close()
        raise AssertionError("TCP round: the FedBroker is not the native one")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tcp_")
    procs = []
    try:
        torch.save({"flats": [f.cpu() for f in flats]},
                   Path(workdir) / "inputs.pt")
        addr = f"{broker.address[0]}:{broker.address[1]}"
        t0 = time.perf_counter()
        for role in ("guest", "host", "arbiter"):
            procs.append((role, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--tcp-role", role, "--broker", addr, "--workdir", workdir],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        deadline = time.monotonic() + 600
        while any(p.poll() is None for _, p in procs):
            failed = [(r, p) for r, p in procs
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                what = (f"the {failed[0][0]} child exited {failed[0][1].returncode}"
                        if failed else "the children ran past 600 s")
                for _, p in procs:
                    p.kill()
                logs = {r: p.communicate()[0][-3000:] for r, p in procs}
                raise AssertionError(f"TCP round: {what}; output: {logs}")
            time.sleep(0.2)
        seconds = time.perf_counter() - t0
        for role, p in procs:
            if p.returncode != 0:
                raise AssertionError(f"TCP round: the {role} child exited "
                                     f"{p.returncode}: "
                                     f"{p.communicate()[0][-3000:]}")
        res = {role: torch.load(Path(workdir) / f"{role}.pt",
                                weights_only=False)
               for role, _ in procs}
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        broker.close()
        shutil.rmtree(workdir, ignore_errors=True)

    g, h = res["guest"], res["host"]
    if (g["idx"], h["idx"]) != (0, 1):
        raise AssertionError(f"TCP round: ordinals {g['idx']}, {h['idx']}")
    want = qsum([g["q"], h["q"]])
    for role in ("guest", "host"):
        if not torch.equal(lanes.as_u32(res[role]["dec"]), want):
            raise AssertionError(f"TCP round: the {role}'s decrypted lanes "
                                 f"!= the summed q mod 2^{INT_BITS}")
        double = dict.fromkeys(fm.MODES, 0)
        double["double"] = 2
        if res[role]["launches"] != double:
            raise AssertionError(f"TCP round: the {role} launched "
                                 f"{res[role]['launches']}, expected {double}")
    if any(res["arbiter"]["launches"].values()):
        raise AssertionError("TCP round: the arbiter launched a kernel")
    packer = {role: res[role]["packer"] for role in res}
    if packer != {"guest": {"pack": 1, "unpack": 0},
                  "host": {"pack": 1, "unpack": 0},
                  "arbiter": {"pack": 0, "unpack": 2}}:
        raise AssertionError(f"TCP round: native packer calls {packer}, "
                             "expected one pack at each client and two "
                             "unpacks at the arbiter")
    if not torch.equal(g["new"], h["new"]):
        raise AssertionError("TCP round: the two clients' new models differ")
    expect, step = expected_model(codec, g["past_mean"], g["alpha"], flats)
    worst = steps_off(g["new"].to(dev), expect, step, "TCP round")
    up = res["host"]["stats"]["host_to_arbiter"]["sent_bytes"]
    packed = ModelPayload(h["q"], N_FEMNIST, INT_BITS).pack().wire_bytes()
    if packed != TCP_PACKED_BYTES or not packed < up < packed + 65536:
        raise AssertionError(f"TCP round: the host sent {up} wire bytes to "
                             f"the arbiter, the packed upload {packed}")
    return seconds, worst, res, packed


def iteration_phases(log, start):
    """A Tracker's phase_log split into iterations, each from a `start`
    phase ("local train" at a client, "collect" at the arbiter) to the
    next: a list of {phase: ms}.  Phases before the first are dropped."""
    iters = []
    for name, secs in log:
        if name == start:
            iters.append({})
        if iters:
            iters[-1][name] = iters[-1].get(name, 0.0) + secs * 1e3
    return iters


def run_training(dev, name, cfg=None, record=record_client):
    """Phase 10: examples/configs/<name> as `python -m flashe_tpu_torch
    submit` runs it (HomoNNGuest, HomoNNHost x (n - 1) and HomoNNArbiter,
    one thread each over run_roles, data from the port's
    federated_dataset), on `dev`; `cfg`, where given, is that
    configuration's dict as phase 11 varies it.  Each client records its
    upload and its decrypted lanes every iteration (`record`, on the
    aggregator its fit makes) and its model after every aggregation; every
    party its phases an iteration (a synchronize of the card, every
    thread's work, at each phase's ends; local training is a phase of the
    client's fit).  Returns the mask kernel's launches by mode and the
    Montgomery kernels', and what the checks need."""
    if cfg is None:
        with open(ROOT / "examples" / "configs" / name) as f:
            cfg = json.load(f)
    param = HomoNNParam.from_dict(cfg["param"])
    n = cfg["n_clients"]
    shards = federated_dataset(cfg["dataset"], n, cfg["samples_per_client"],
                               seed=cfg.get("seed", 0))
    recs = [{"models": [], "phases": []} for _ in range(n)]
    arbiter_rec = {}
    local = threading.local()
    with_role = aggregator.with_role

    def recorded_with_role(role, *args, **kw):
        agg = with_role(role, *args, **kw)
        if role != "arbiter":
            record(agg, local.rec)
        return agg

    def client(cls, trv, i):
        rec = local.rec = recs[i]
        set_tracker(Tracker("guest" if i == 0 else f"host{i - 1}",
                            synchronize=torch.cuda.synchronize))
        c = cls(param, seed=i, device=dev)
        c._build(shards[i][0][:1])
        install = c.trainer.set_model_weights

        def recorded_install(params):
            install(params)
            rec["models"].append(c.codec.flatten(c.trainer.params))

        c.trainer.set_model_weights = recorded_install
        c.fit(trv, *shards[i])
        rec["phases"] = iteration_phases(tracker().phase_log, "local train")
        model, opt = c.trainer.model, c.trainer.optimizer
        rec["on_card"] = (
            all(t.is_cuda for t in model.parameters())
            and len(opt.state) == len(list(model.parameters()))
            and all(v.is_cuda for s in opt.state.values()
                    for v in s.values() if torch.is_tensor(v)))
        rec["n_params"] = c.codec.total

    def arbiter(trv):
        set_tracker(Tracker("arbiter", synchronize=torch.cuda.synchronize))
        losses = HomoNNArbiter(param, device=dev).fit(trv)
        arbiter_rec["phases"] = iteration_phases(tracker().phase_log,
                                                 "collect")
        return losses

    torch.cuda.synchronize()
    reset_launches()
    for k in mg.launches:
        mg.launches[k] = 0
    aggregator.with_role = recorded_with_role
    try:
        t0 = time.perf_counter()
        res = run_roles(n - 1, lambda trv: client(HomoNNGuest, trv, 0),
                        lambda trv, h: client(HomoNNHost, trv, 1 + h),
                        arbiter, job_id=f"chip-smoke-train-{name}-"
                        f"{param.secure_aggregate}",
                        timeout=600)
        seconds = time.perf_counter() - t0
    finally:
        aggregator.with_role = with_role
    return dict(fm.mode_launches), dict(mg.launches), seconds, dict(
        losses=res["arbiter"], recs=recs, arbiter=arbiter_rec, param=param,
        n=n, samples=cfg["samples_per_client"])


def check_training(name, launches, mont, r, n_params):
    """Finite losses; in every iteration every client's decrypted lanes
    equal to the clients' summed q mod 2^int_bits (no client is dropped);
    every client the same model bit for bit after each aggregation; 10
    encrypts + 10 clients x 1 boundary pair of double launches an
    iteration and nothing else; every client's parameters and optimizer
    state on the card."""
    iters, recs = r["param"].max_iter, r["recs"]
    int_bits = r["param"].secure_aggregate_args.quantize.int_bits
    losses = r["losses"]
    if len(losses) != iters or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: loss_per_round {losses}")
    for i, rec in enumerate(recs):
        if (len(rec["models"]) != iters or len(rec["q"]) != iters
                or len(rec["dec"]) != iters or rec["n_params"] != n_params):
            raise AssertionError(f"{name}: client {i} uploaded "
                                 f"{len(rec['q'])}, decrypted "
                                 f"{len(rec['dec'])} and installed "
                                 f"{len(rec['models'])} models of "
                                 f"{rec['n_params']} parameters")
        if not rec["on_card"]:
            raise AssertionError(f"{name}: client {i}'s parameters or "
                                 "optimizer state are not on the card")
    for it in range(iters):
        want = qsum([rec["q"][it] for rec in recs], int_bits)
        for i, rec in enumerate(recs):
            if not torch.equal(lanes.as_u32(rec["dec"][it]), want):
                raise AssertionError(f"{name}: iteration {it}: client {i}'s "
                                     "decrypted lanes != the clients' "
                                     f"summed q mod 2^{int_bits}")
            if not torch.equal(rec["models"][it], recs[0]["models"][it]):
                raise AssertionError(f"{name}: after aggregation {it}, "
                                     f"client {i}'s model differs from the "
                                     "guest's")
    want = dict.fromkeys(fm.MODES, 0)
    want["double"] = iters * 2 * r["n"]
    if launches != want or any(mont.values()):
        raise AssertionError(f"{name}: launches {launches} and {mont}, "
                             f"expected {want} and no Montgomery kernel")


def run_submit(name):
    """`python -m flashe_tpu_torch submit -c examples/configs/<name>
    --json` in this process, on the card: its JSON must hold the
    configuration's max_iter finite losses and the guest's phases, and the
    mask kernel must run 2 double launches a client an iteration (its
    encrypt and its decrypt's boundary pair) and nothing else.
    Returns the launches by kernel and mode, the seconds and the JSON."""
    with open(ROOT / "examples" / "configs" / name) as f:
        cfg = json.load(f)
    iters = cfg["param"]["max_iter"]
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    for k in mg.launches:
        mg.launches[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["submit", "-c", str(ROOT / "examples" / "configs" /
                                           name), "--json"])
    seconds = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = out["loss_per_round"]
    want = dict.fromkeys(fm.MODES, 0)
    want["double"] = iters * 2 * cfg["n_clients"]
    if (rc != 0 or len(losses) != iters or not np.all(np.isfinite(losses))
            or "encryption" not in out["phases"]):
        raise AssertionError(f"submit {name}: rc {rc}, output {out}")
    if dict(fm.mode_launches) != want or any(mg.launches.values()):
        raise AssertionError(f"submit {name}: launches {fm.mode_launches} "
                             f"and {mg.launches}, expected {want}")
    return {**fm.mode_launches, **mg.launches}, seconds, out


def run_single_client(dev, steps=TRAIN_STEPS):
    """One client alone: FemnistCNN on its 128 synthetic FEMNIST samples,
    `steps` full-batch Adam steps at lr 5e-4 through LocalTrainer.  Returns
    the losses and the host seconds of steps 2 to `steps` (a synchronize
    after each), the first holding cuDNN's set-up."""
    x, y = federated_dataset("femnist", 1, 128, seed=0)[0]
    model = FemnistCNN(device=dev)
    init_params(model, x[:1], seed=0)
    trainer = LocalTrainer(model, optimizer="adam", learning_rate=5e-4,
                           device=dev)
    losses, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train(x, y, batch_size=128))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"single client: losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"single client: the mean of the last 5 losses "
                             f"{last} is not below that of the first 5 "
                             f"{first}")
    return losses, sum(secs[1:])


@contextlib.contextmanager
def submit_tf32(tf32):
    """torch's own TF32 settings `tf32`, those `submit` runs with (this
    script turns TF32 off for the other phases); restores them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def print_guest_phases(r):
    """The guest's phases of each iteration of a run_training result."""
    for it, ph in enumerate(r["recs"][0]["phases"]):
        train_ms = ph.get("local train", float("nan"))
        print(f"  guest iteration {it} "
              f"({'warm-up' if it == 0 else 'steady'}) by phase "
              f"(ms, host clock, a "
              f"synchronize at each phase's ends): " + ", ".join(
                  f"{k} {ph.get(k, 0.0):.2f}" for k in TRAIN_PHASES)
              + f"; the guest's local training "
              f"{r['samples'] / train_ms * 1e3:,.0f} samples/s (its "
              f"phase shares the card and one GIL with "
              f"{r['n'] - 1} other clients)")


def run_training_phase(dev, tf32):
    """Phase 10 with torch's own TF32 settings, as `submit` runs.  Returns
    the launches of each configuration, and RUNTIME_CONFIG's in-process
    run (its run_training result and peak device memory, and submit's
    JSON), which phase 12 compares its processes with."""
    with submit_tf32(tf32):
        print(f"federated training: torch.backends.cudnn.allow_tf32="
              f"{torch.backends.cudnn.allow_tf32} (convolutions in TF32), "
              f"torch.backends.cuda.matmul.allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}: torch's defaults, "
              "as submit runs")
        out, in_process = {}, {}
        for name, n_params in TRAIN_CONFIGS:
            torch.cuda.reset_peak_memory_stats(dev)
            launches, mont, secs, r = run_training(dev, name)
            check_training(name, launches, mont, r, n_params)
            out[name] = {**launches, **mont}
            if name == RUNTIME_CONFIG:
                in_process["train"] = r
                in_process["peak_bytes"] = torch.cuda.max_memory_allocated(
                    dev)
            iters = r["param"].max_iter
            print(f"federated training {name} ({r['n']} clients x "
                  f"{r['samples']} samples, {r['param'].model} "
                  f"{n_params:,} parameters, {r['param'].optimizer} lr "
                  f"{r['param'].learning_rate}, {iters} iterations): "
                  f"{secs:.2f} s; "
                  f"loss_per_round {[round(v, 6) for v in r['losses']]}, "
                  f"every client's decrypt == the clients' summed q mod "
                  f"2^{r['param'].secure_aggregate_args.quantize.int_bits} "
                  f"in every iteration, "
                  f"every client the same model after each aggregation, "
                  f"launches {launches['double']} double (= {iters} x "
                  f"({r['n']} encrypts + {r['n']} clients x 1 pair)), "
                  f"parameters and Adam state on the card")
            print_guest_phases(r)
        out["submit"], secs, result = run_submit(TRAIN_CONFIGS[0][0])
        in_process["submit"] = result
        print(f"python -m flashe_tpu_torch submit -c examples/configs/"
              f"{TRAIN_CONFIGS[0][0]} --json, in this process: {secs:.2f} s, "
              f"loss_per_round {result['loss_per_round']}, launches "
              f"{out['submit']['double']} double")
        losses, secs = run_single_client(dev)
        print(f"single client, FemnistCNN, {TRAIN_STEPS} full-batch Adam "
              f"steps at lr 5e-4 on 128 samples: losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (mean of the first 5 "
              f"{np.mean(losses[:5]):.4f}, of the last 5 "
              f"{np.mean(losses[-5:]):.4f}); steps 2-{TRAIN_STEPS} "
              f"{secs / (TRAIN_STEPS - 1) * 1e3:.2f} ms a step, "
              f"{128 * (TRAIN_STEPS - 1) / secs:,.0f} samples/s")
        return out, in_process


# ---------------------------------------------------------------------------
# phase 11: the general-HE baselines (BFV, CKKS, the additive random pads)
# ---------------------------------------------------------------------------

def check_ntt_on_card(dev):
    """ntt and intt on the card against the same functions on the CPU, bit
    for bit, on NTT_GRID; intt(ntt(a) ntt(b)) against a python-int
    negacyclic convolution; CKKS's centred reconstruction (int64 products
    that wrap) against python ints near +-2^62.  Returns the cases run."""
    for N, k, B in NTT_GRID:
        primes = [HE_T] if k == 1 else ntt.find_ntt_primes(k, 30, 2 * N)
        card_ctx = ntt.RnsContext(N, primes, dev)
        cpu_ctx = ntt.RnsContext(N, primes, "cpu")
        gen = torch.Generator().manual_seed(N + k)
        x = torch.stack([torch.randint(0, p, (B, N), generator=gen)
                         for p in primes], dim=1).int()
        want = ntt.ntt(cpu_ctx, x)
        got = ntt.ntt(card_ctx, x.to(dev))
        back = ntt.intt(card_ctx, got)
        if not (torch.equal(got.cpu(), want) and torch.equal(
                back.cpu(), ntt.intt(cpu_ctx, want))
                and torch.equal(back.cpu(), x)):
            raise AssertionError(f"ntt / intt at N {N}, k {k}, batch {B}: "
                                 "the card differs from the CPU")
    N, rng = 64, random.Random(SEED)
    ctx = ntt.RnsContext(N, ntt.find_ntt_primes(2, 30, 2 * N), dev)
    a = [rng.randrange(-1000, 1000) for _ in range(N)]
    b = [rng.randrange(-1000, 1000) for _ in range(N)]
    conv = [0] * N
    for i in range(N):
        for j in range(N):
            conv[(i + j) % N] += (1 if i + j < N else -1) * a[i] * b[j]
    fa, fb = (ntt.ntt(ctx, ctx.from_signed(torch.tensor(v)))
              for v in (a, b))
    got = ntt.intt(ctx, ctx.mul(fa, fb)).cpu()
    if got.tolist() != [[c % p for c in conv] for p in ctx.primes]:
        raise AssertionError("intt(ntt(a) ntt(b)) on the card is not the "
                             "negacyclic convolution")
    c = CKKSCipher(N, device=dev)
    xs = [0, 1, -1, 2**62, -(2**62), 2**62 + 12345, -(2**62) - 6789,
          2**63 - 1, -(2**63) + 1]
    xs += [rng.randrange(-(2**62), 2**62) for _ in range(N - len(xs))]
    v = torch.tensor([[x % p for x in xs] for p in c.ctx.primes],
                     dtype=torch.int64).int()[None]
    if c._centred(v.to(dev))[0].tolist() != xs:
        raise AssertionError("CKKS's centred reconstruction on the card is "
                             "off the python ints")
    return len(NTT_GRID)


def _he_ciphers(make, guest, n):
    """The guest's cipher and n - 1 hosts' with its secret (and, for BFV,
    its public key), as the session setup leaves them."""
    hosts = [make().load_secret(guest.serialize_secret())
             for _ in range(n - 1)]
    if hasattr(guest, "public_parts"):
        for h in hosts:
            h.set_public_parts(guest.public_parts())
    return [guest] + hosts


def _median_ms(fn, reps=3):
    fn()
    return statistics.median(event_ms(fn, reps))


def run_bfv_full(dev, model):
    """cnn_bfv_q16_binf_pad.json's cipher at full width: 10 clients'
    quantized FemnistCNN lanes (q16 at int_bits 20, the secure ACIQ
    quantizer, seeds 0-9), BFV_CTS ciphertexts each; the arbiter's sum;
    a decrypt that must equal the clients' summed q mod t exactly; one
    upload decrypted on the card and on the CPU."""
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    flats = client_flats(dev, codec, model, N_CLIENTS)
    qs = []
    for i, f in enumerate(flats):
        quant = QuantizingClient(INT_BITS, False, ELEMENT_BITS, True, True,
                                 seed=i, device=dev)
        quant.set_num_clients(N_CLIENTS)
        quant.set_codec(codec)
        qs.append(quant.quantize(quant.normalize(f)))

    def make(seed=None, device=dev):
        return BFVCipher(HE_T, HE_M, flagBatching=True, seed=seed,
                         device=device)

    clients = _he_ciphers(make, make(SEED).generate_keys(), N_CLIENTS)
    arbiter = make()
    ups = [c.encrypt(q) for c, q in zip(clients, qs)]
    for u in ups:
        if (u.shape != (BFV_CTS, 2, clients[0].k, HE_M)
                or u.dtype != torch.int32):
            raise AssertionError(f"BFV upload {tuple(u.shape)} {u.dtype}")
    agg = arbiter.add_ciphertexts(ups)
    dec = clients[0].decrypt(agg, N_FEMNIST)
    want = sum(q.long() for q in qs) % HE_T
    if not torch.equal(dec.long(), want):
        raise AssertionError("BFV: the decrypted aggregate != the clients' "
                             "summed q mod t")
    cpu = make(device="cpu").load_secret(clients[0].serialize_secret())
    on_cpu = cpu.decrypt(ups[3].cpu(), N_FEMNIST)
    if not (torch.equal(on_cpu, clients[5].decrypt(ups[3], N_FEMNIST).cpu())
            and torch.equal(on_cpu, qs[3].cpu())):
        raise AssertionError("BFV: one upload decrypts differently on the "
                             "card and on the CPU, or not to its q")
    return dict(
        encrypt=_median_ms(lambda: clients[1].encrypt(qs[1])),
        sum=_median_ms(lambda: arbiter.add_ciphertexts(ups), 5),
        decrypt=_median_ms(lambda: clients[2].decrypt(agg, N_FEMNIST)),
        phase=clients[0]._phase(agg), cipher=clients[0], ups=ups)


def run_ckks_full(dev, model):
    """cnn_ckks.json's cipher at full width: 10 float vectors (the global
    model plus 0.01 N(0, 1), as the rounds make them), CKKS_CTS
    ciphertexts each; the arbiter's sum, decrypted within CKKS_ATOL of the
    float64 sum."""
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    flats = client_flats(dev, codec, model, N_CLIENTS)

    def make(seed=None):
        return CKKSCipher(HE_M, seed=seed, device=dev)

    clients = _he_ciphers(make, make(SEED).generate_keys(), N_CLIENTS)
    arbiter = make()
    ups = [c.encrypt(f) for c, f in zip(clients, flats)]
    if any(u.shape != (CKKS_CTS, 2, clients[0].k, HE_M) for u in ups):
        raise AssertionError(f"CKKS upload {tuple(ups[0].shape)}")
    agg = arbiter.add_ciphertexts(ups)
    dec = clients[0].decrypt(agg, N_FEMNIST)
    err = float((dec - sum(f.double() for f in flats)).abs().max())
    if not err <= CKKS_ATOL:
        raise AssertionError(f"CKKS: the decrypted sum is off the float64 "
                             f"sum by {err}")
    return dict(
        err=err,
        encrypt=_median_ms(lambda: clients[1].encrypt(flats[1])),
        sum=_median_ms(lambda: arbiter.add_ciphertexts(ups), 5),
        decrypt=_median_ms(lambda: clients[2].decrypt(agg, N_FEMNIST)),
        cipher=clients[0], agg=agg, ups=ups)


def run_additive_full(dev, model):
    """The additive random pads at full width: 10 clients with pairwise
    secrets, each float vector padded; the arbiter's float sum within
    ADDITIVE_ATOL of the float64 plain sum."""
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    flats = client_flats(dev, codec, model, N_CLIENTS)
    uuids = [f"client-{i}" for i in range(N_CLIENTS)]
    rng = random.Random(SEED)
    secret = {(a, b): rng.getrandbits(256)
              for i, a in enumerate(uuids) for b in uuids[i + 1:]}
    ciphers = []
    for me in uuids:
        c = PadsCipher(dev)
        c.set_self_uuid(me)
        c.set_exchanged_keys({
            other: (j, secret[tuple(sorted((me, other)))], "host", j)
            for j, other in enumerate(uuids) if other != me})
        ciphers.append(c)
    ups = [c.encrypt(f) for c, f in zip(ciphers, flats)]
    agg = arbiter_reduce(ups)
    err = float((agg.double() - sum(f.double() for f in flats)).abs().max())
    if not err <= ADDITIVE_ATOL:
        raise AssertionError(f"additive: the arbiter's sum is off the plain "
                             f"sum by {err}")
    return dict(err=err,
                encrypt=_median_ms(lambda: ciphers[1].encrypt(flats[1])),
                sum=_median_ms(lambda: arbiter_reduce(ups), 5))


def record_he_client(agg, rec):
    """Record, iteration by iteration, what a client's block quantizes
    (BFV's quantized lanes; the floats of CKKS and the additive pads) and
    what it decrypts."""
    block = agg._block
    quantize, decrypt = block.quantize, block.decrypt

    def recorded_quantize(flat, uniforms=None):
        q = quantize(flat, uniforms=uniforms)
        rec.setdefault("q", []).append(q)
        return q

    def recorded_decrypt(lanes, *args):
        out = decrypt(lanes, *args)
        rec.setdefault("dec", []).append(out)
        return out

    block.quantize, block.decrypt = recorded_quantize, recorded_decrypt


@contextlib.contextmanager
def count_ring_calls():
    """Count the calls of the ring's device code (the NTT, the ring
    product and sum, BFV's CRT rounding and CKKS's reconstruction) by name
    and shape: the shape of the residues each call works on."""
    counts, lock = collections.Counter(), threading.Lock()
    shapes = {
        "ntt": lambda ctx, x: x.shape,
        "intt": lambda ctx, x: x.shape,
        "mul": lambda ctx, a, b: torch.broadcast_shapes(a.shape, b.shape),
        "sum": lambda ctx, xs: (len(xs),) + tuple(xs[0].shape),
        "_round_crt": lambda cipher, v: v.shape,
        "_centred": lambda cipher, v: v.shape,
    }
    saved = [(obj, name, getattr(obj, name)) for obj, name in (
        (ntt, "ntt"), (ntt, "intt"), (ntt.RnsContext, "mul"),
        (ntt.RnsContext, "sum"), (BFVCipher, "_round_crt"),
        (CKKSCipher, "_centred"))]

    def counted(name, fn):
        def call(*args):
            with lock:
                counts[(name, tuple(shapes[name](*args)))] += 1
            return fn(*args)
        return call

    for obj, name, fn in saved:
        setattr(obj, name, counted(name, fn))
    try:
        yield counts
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def he_training_configs():
    """(label, configuration dict): cnn_bfv_q16_binf_pad.json and
    cnn_ckks.json as they stand but for max_iter 2, and the additive
    variant of cnn_flashe_q16_b1_pad.json."""
    out = []
    for name, scheme in HE_TRAIN:
        with open(ROOT / "examples" / "configs" / name) as f:
            cfg = json.load(f)
        cfg["param"]["max_iter"] = HE_TRAIN_ITERS
        if scheme:
            cfg["param"]["secure_aggregate"] = scheme
            name = f"{name} with secure_aggregate {scheme!r}"
        out.append((name, cfg))
    return out


def check_he_training(name, launches, mont, r):
    """Finite losses; every client the same model bit for bit after each
    aggregation, of N_FEMNIST parameters on the card; BFV's decrypt equal
    to the clients' summed q (mod t, which the sums of 10 16-bit values
    never reach); CKKS's within CKKS_ATOL (and float32's rounding) and the
    additive sum within ADDITIVE_ATOL_TRAIN of the sum of the uploads; no
    mask and no Montgomery launch."""
    iters, recs, scheme = (r["param"].max_iter, r["recs"],
                           r["param"].secure_aggregate)
    losses = r["losses"]
    if len(losses) != iters or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: loss_per_round {losses}")
    worst = 0.0
    for it in range(iters):
        sent = [rec["q"][it] for rec in recs]
        for i, rec in enumerate(recs):
            if (len(rec["models"]) != iters or rec["n_params"] != N_FEMNIST
                    or not rec["on_card"]):
                raise AssertionError(f"{name}: client {i} installed "
                                     f"{len(rec['models'])} models of "
                                     f"{rec['n_params']} parameters, on the "
                                     f"card: {rec['on_card']}")
            if not torch.equal(rec["models"][it], recs[0]["models"][it]):
                raise AssertionError(f"{name}: after aggregation {it}, "
                                     f"client {i}'s model differs from the "
                                     "guest's")
            dec = rec["dec"][it]
            if scheme == "bfv":
                if not torch.equal(dec.long(), sum(q.long() for q in sent)):
                    raise AssertionError(f"{name}: iteration {it}: client "
                                         f"{i}'s decrypt != the summed q")
                continue
            want = sum(q.double() for q in sent)
            err = (dec.double() - want).abs()
            tol = (CKKS_ATOL + want.abs() * 2.0**-23 if scheme == "ckks"
                   else ADDITIVE_ATOL_TRAIN)
            if bool((err > tol).any()):
                raise AssertionError(f"{name}: iteration {it}: client {i}'s "
                                     f"decrypt is off the sum of the "
                                     f"uploads by {float(err.max())}")
            worst = max(worst, float(err.max()))
    if any(launches.values()) or any(mont.values()):
        raise AssertionError(f"{name}: launches {launches} and {mont}, "
                             "expected no mask and no Montgomery kernel")
    return worst


def ring_bound(name, shape, card):
    """The bound of one call of the ring's device code at `shape`: its
    int32 residues read and its outputs written once (int32 residues, or
    the (B, N) int64 values of the CRT rounding and the reconstruction);
    MODMUL_INT_OPS integer operations a modular product: the NTT's
    butterflies and twist, one a product's element, three an element of
    the CRT rounding and the reconstruction (c_i, then the quotients or
    the products by q / p_i), one add an element of a sum."""
    n = math.prod(shape)
    mm = roofline.MODMUL_INT_OPS
    if name in ("ntt", "intt"):
        B, k, N = shape
        return roofline.bound_ms(mm * roofline.ntt_modmuls(B, k, N), 8 * n,
                                 card)
    if name == "mul":
        return roofline.bound_ms(mm * n, 12 * n, card)
    if name == "sum":  # shape: (uploads, *one upload)
        return roofline.bound_ms(n, 4 * (n + n // shape[0]), card)
    B, k, N = shape  # _round_crt and _centred: (B, k, N) in, (B, N) int64
    return roofline.bound_ms(3 * mm * n, 4 * n + 8 * B * N, card)


def time_ring(dev, card, bfv, ckks):
    """CUDA-event times of the ring's device code at the round's shapes,
    each beside its bound: ntt, intt and the ring product at BFV's and at
    CKKS's (ciphertexts, 6, HE_M), the 10-upload sum of each, BFV's CRT
    rounding and CKKS's reconstruction."""
    gen = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for r, B in ((bfv, BFV_CTS), (ckks, CKKS_CTS)):
        ctx = r["cipher"].ctx
        x, y = (torch.stack([torch.randint(0, p, (B, HE_M), generator=gen,
                                           device=dev) for p in ctx.primes],
                            dim=1).int() for _ in range(2))
        shape = tuple(x.shape)
        rows += [("ntt", shape, _median_ms(lambda: ntt.ntt(ctx, x), 5)),
                 ("intt", shape, _median_ms(lambda: ntt.intt(ctx, x), 5)),
                 ("mul", shape, _median_ms(lambda: ctx.mul(x, y), 5)),
                 ("sum", (len(r["ups"]),) + tuple(r["ups"][0].shape),
                  _median_ms(lambda: ctx.sum(r["ups"]), 5))]
    v = bfv["phase"]
    rows.append(("_round_crt", tuple(v.shape),
                 _median_ms(lambda: bfv["cipher"]._round_crt(v), 5)))
    c = ckks["cipher"]
    w = ntt.intt(c.ctx, c.ctx.add(ckks["agg"][:, 0],
                                  c.ctx.mul(ckks["agg"][:, 1], c.sk_ntt)))
    rows.append(("_centred", tuple(w.shape),
                 _median_ms(lambda: c._centred(w), 5)))
    return [dict(name=name, shape=shape, ms=ms,
                 **dict(zip(("bound_ms", "bound_by"),
                            ring_bound(name, shape, card))))
            for name, shape, ms in rows]


def run_he_phase(dev, model, card, tf32):
    """Phase 11: the NTT on the card against the CPU, BFV, CKKS and the
    additive pads at full width, then federated training under each, as
    `submit` runs it; the ring's device code timed.  Returns the rows of
    the printed device-code JSON."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cases = check_ntt_on_card(dev)
    print(f"NTT on the card: ntt and intt bit-exact with the CPU on "
          f"{cases} cases (N 64-8192, k 1 (t = {HE_T}), 2 and 6, batches "
          f"up to {CKKS_CTS}); intt(ntt(a) ntt(b)) == the python-int "
          f"negacyclic convolution at N 64; CKKS's reconstruction == python "
          f"ints near +-2^62")
    bfv = run_bfv_full(dev, model)
    print(f"BFV at full width (t {HE_T}, m {HE_M}, batching, q = "
          f"{bfv['cipher'].k} x 30-bit primes): {N_CLIENTS} clients x "
          f"{N_FEMNIST:,} q16 lanes, {BFV_CTS} ciphertexts, "
          f"{bfv['ups'][0].nbytes:,} B, each; "
          f"the decrypted sum == the clients' summed q mod t exactly; one "
          f"upload decrypts to its q on the card and on the CPU; one "
          f"client's encrypt {bfv['encrypt']:.2f} ms, the {N_CLIENTS}-upload "
          f"sum {bfv['sum']:.3f} ms, the decrypt {bfv['decrypt']:.2f} ms "
          f"(medians, CUDA events)")
    ckks = run_ckks_full(dev, model)
    print(f"CKKS at full width (N {HE_M}, scale 2^40): {N_CLIENTS} clients "
          f"x {N_FEMNIST:,} floats, {CKKS_CTS} ciphertexts each; the "
          f"decrypted sum within {ckks['err']:.3e} of the float64 sum "
          f"(limit {CKKS_ATOL}); one client's encrypt {ckks['encrypt']:.2f} "
          f"ms, the sum {ckks['sum']:.3f} ms, the decrypt "
          f"{ckks['decrypt']:.2f} ms")
    add = run_additive_full(dev, model)
    print(f"additive pads at full width: {N_CLIENTS} clients x "
          f"{N_FEMNIST:,} floats, 9 pads each; the arbiter's float32 sum "
          f"within {add['err']:.3e} of the plain float64 sum (limit "
          f"{ADDITIVE_ATOL}); one client's encrypt {add['encrypt']:.3f} ms, "
          f"the sum {add['sum']:.3f} ms")
    ring = time_ring(dev, card, bfv, ckks)
    del bfv, ckks, add
    with submit_tf32(tf32):
        for name, cfg in he_training_configs():
            with count_ring_calls() as calls:
                launches, mont, secs, r = run_training(
                    dev, name, cfg, record_he_client)
            worst = check_he_training(name, launches, mont, r)
            scheme = r["param"].secure_aggregate
            print(f"federated training {name} ({r['n']} clients x "
                  f"{r['samples']} samples, FemnistCNN {N_FEMNIST:,} "
                  f"parameters, {r['param'].max_iter} iterations): "
                  f"{secs:.2f} s; loss_per_round "
                  f"{[round(v, 6) for v in r['losses']]}; every client the "
                  f"same model after each aggregation; "
                  + ("every client's decrypt == the clients' summed q"
                     if scheme == "bfv" else
                     f"every client's decrypt within {worst:.3e} of the sum "
                     "of the uploads")
                  + "; no mask or Montgomery launch; ring calls an "
                  "iteration (all parties): " + ", ".join(
                      f"{n} {list(s)} x {c / r['param'].max_iter:g}"
                      for (n, s), c in sorted(calls.items())))
            print_guest_phases(r)
            for row in ring:
                key = (row["name"], tuple(row["shape"]))
                row.setdefault("calls_per_iteration", {})[scheme] = \
                    calls.get(key, 0) / r["param"].max_iter
    for row in ring:
        print(f"ring device code {row['name']} at {list(row['shape'])}: "
              f"{row['ms']:.4f} ms (median, CUDA events), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bound_ms'] / row['ms']:.2%}), calls an iteration "
              f"{row['calls_per_iteration']}; {card.name}, "
              f"{card.power_limit}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 11: {time.perf_counter() - t0:.2f} s (host clock); peak "
          f"device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return ring


# ---------------------------------------------------------------------------
# phase 12: the job runtime, one OS process a party
# ---------------------------------------------------------------------------

def runtime_env(root: Path) -> dict:
    """The environment of phase 12's commands: every store of the port
    under `root`, none in the home directory."""
    env = dict(os.environ)
    env.update(FLASHE_JOBS_DIR=str(root / "jobs"),
               FLASHE_DATA_DIR=str(root / "data"),
               FLASHE_TORCH_MODELS_DIR=str(root / "models"),
               FLASHE_PERMISSIONS_PATH=str(root / "permissions.json"))
    return env


def run_cli_text(argv, env):
    """`python -m flashe_tpu_torch <argv>`, a process of its own from the
    repository root, on the card; returns its output and its seconds.  A
    command that fails fails the phase, with the end of its errors."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "flashe_tpu_torch", *argv],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=RUNTIME_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"python -m flashe_tpu_torch {' '.join(argv)}:"
                             f" rc {res.returncode}\n{res.stderr[-6000:]}")
    return res.stdout, secs


def run_cli(argv, env):
    """run_cli_text's command; its last line of output as JSON, and its
    seconds."""
    out, secs = run_cli_text(argv, env)
    return json.loads(out.strip().splitlines()[-1]), secs


def stop_jobs(root: Path):
    """SIGTERM the recorded PIDs of every job still running under root
    (a command cut at its time limit leaves its party processes)."""
    reg = JobRegistry(str(root / "jobs"))
    for rec in reg.list_jobs():
        if rec["status"] == "running":
            reg.stop(rec["job_id"])


def read_job(root: Path, job: dict):
    """A job's record in the registry and each party's output, which this
    process unpickles without touching the card (numpy and Python
    only)."""
    rec = JobRegistry(str(root / "jobs")).query(job["job_id"])
    outs = {}
    for task in rec["tasks"]:
        with open(Path(job["workdir"]) / f"{task}.out", "rb") as f:
            outs[task] = pickle.load(f)
    return rec, outs


def client_tasks(n):
    return ["guest_0"] + [f"host_{h}" for h in range(n - 1)]


def check_native_broker(what, job):
    """A job's __job__ record (or its summary's "job") names the native
    broker."""
    if job.get("broker") != "native":
        raise AssertionError(f"{what}: the job ran over the "
                             f"{job.get('broker')!r} broker, not the native "
                             "one")


def port_brokers():
    """PIDs of the live processes that run the port's native broker
    binary (a zombie's command line is empty)."""
    binary = str(_build.build_dir() / "fedbroker").encode()
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                if f.read().split(b"\0")[0] == binary:
                    pids.append(int(d))
        except OSError:
            continue
    return pids


def check_no_brokers(what, grace=5.0):
    """No port fedbroker process outlives `what` (one that is exiting has
    `grace` seconds)."""
    deadline = time.monotonic() + grace
    while left := port_brokers():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: the port's fedbroker still runs "
                                 f"as PIDs {left}")
        time.sleep(0.1)


def check_job(what, rec, outs, n, iters):
    """Every task `success` in the registry; every client's parameters on
    the card, its process 2 double mask launches an iteration and no other
    launch, its final model the guest's bit for bit (model_sha256); no
    launch at the arbiter."""
    tasks = {t: v["status"] for t, v in rec["tasks"].items()}
    if (rec["status"] != "success"
            or sorted(tasks) != sorted(client_tasks(n) + ["arbiter_0"])
            or set(tasks.values()) != {"success"}):
        raise AssertionError(f"{what}: job {rec['status']}, tasks {tasks}")
    want = dict.fromkeys(fm.MODES, 0)
    want["double"] = 2 * iters
    arb = outs["arbiter_0"]
    if any(arb["mask_launches"].values()) or any(
            arb["mont_launches"].values()):
        raise AssertionError(f"{what}: the arbiter launched "
                             f"{arb['mask_launches']}, {arb['mont_launches']}")
    for task in client_tasks(n):
        out = outs[task]
        if not out["device"].startswith("cuda"):
            raise AssertionError(f"{what}: {task}'s parameters lay on "
                                 f"{out['device']}")
        if out["mask_launches"] != want or any(out["mont_launches"].values()):
            raise AssertionError(f"{what}: {task} launched "
                                 f"{out['mask_launches']} and "
                                 f"{out['mont_launches']}, expected {want}")
        if out["model_sha256"] != outs["guest_0"]["model_sha256"]:
            raise AssertionError(f"{what}: {task}'s final model differs from "
                                 "the guest's")


def steady(log, start, iters):
    """The last iteration of a phase_log, {phase: ms}."""
    ph = iteration_phases(log, start)
    if len(ph) != iters:
        raise AssertionError(f"{len(ph)} iterations in a phase log, "
                             f"expected {iters}")
    return ph[-1]


def run_runtime_processes(root, env, in_process):
    """(a) `submit --processes --checkpoint-dir --publish` of
    RUNTIME_CONFIG: the job's checks, the 10 clients' checkpoints equal bit
    for bit, loss_per_round within RUNTIME_LOSS_RTOL of phase 10's
    in-process submit of the same configuration."""
    path = ROOT / "examples" / "configs" / RUNTIME_CONFIG
    with open(path) as f:
        cfg = json.load(f)
    n, iters = cfg["n_clients"], cfg["param"]["max_iter"]
    ckpt_dir = root / "ckpt"
    out, secs = run_cli(["submit", "-c", str(path), "--processes",
                         "--checkpoint-dir", str(ckpt_dir), "--publish",
                         "phase12", "--json"], env)
    check_native_broker("submit --processes", out["job"])
    rec, outs = read_job(root, out["job"])
    check_job("submit --processes", rec, outs, n, iters)
    ckpts = [load_checkpoint(str(ckpt_dir / f"{t}.ckpt"))
             for t in client_tasks(n)]
    for t, c in zip(client_tasks(n), ckpts):
        if c["aggregate_iter"] != iters or any(
                not np.array_equal(v, ckpts[0]["params"][k])
                for k, v in c["params"].items()):
            raise AssertionError(f"submit --processes: {t}'s checkpoint "
                                 "differs from the guest's")
    losses = np.array(out["loss_per_round"])
    ref = np.array(in_process["submit"]["loss_per_round"])
    if (losses.shape != (iters,) or not np.all(np.isfinite(losses))
            or not np.allclose(losses, ref, rtol=RUNTIME_LOSS_RTOL, atol=0)):
        raise AssertionError(f"submit --processes: loss_per_round "
                             f"{losses.tolist()}, in process "
                             f"{ref.tolist()} (rtol {RUNTIME_LOSS_RTOL})")
    return dict(cfg=cfg, n=n, iters=iters, secs=secs, out=out, outs=outs,
                ckpt=ckpt_dir / "guest_0.ckpt")


def run_runtime_predict(dev, env, a):
    """(b) `predict --model phase12` (the guest's published model): its
    aggregate_iter, and its scores within PREDICT_ATOL of the guest's
    checkpoint loaded in this process."""
    cfg = a["cfg"]
    param = HomoNNParam.from_dict(cfg["param"])
    preds = a["ckpt"].parent / "preds.npy"
    out, secs = run_cli(["predict", "-c", str(ROOT / "examples" / "configs"
                                              / RUNTIME_CONFIG),
                         "--model", "phase12", "--out", str(preds)], env)
    x, _ = synthetic_dataset(cfg.get("dataset", param.model),
                             cfg.get("samples_per_client", 128),
                             seed=cfg.get("seed", 0))
    guest = HomoNNGuest(param, device=dev)
    guest.load_model(str(a["ckpt"]), x[:1])
    want = guest.predict(x)
    got = np.load(preds)
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    if (out["aggregate_iter"] != a["iters"] or out["n"] != len(x)
            or not err <= PREDICT_ATOL):
        raise AssertionError(f"predict: {out}, scores {got.shape} against "
                             f"{want.shape}, max |diff| {err}")
    return out, secs, err


def run_runtime_dsl(dev, root, env):
    """(c) `submit-dsl --processes` of examples/dsl/train_job_conf.json
    made 1 guest + 9 hosts, the FEMNIST CNN as a Keras nn_define, max_iter
    2, DataIO tables of federated_dataset("femnist", 10, 128, seed=0)
    written by DataStore.put: the job's checks, finite losses and every
    client's Evaluation."""
    with open(ROOT / "examples" / "dsl" / "train_job_conf.json") as f:
        conf = json.load(f)
    n, iters = N_CLIENTS, 2
    store = DataStore(str(root / "data"))
    tables = []
    for i, (x, y) in enumerate(federated_dataset("femnist", n, 128,
                                                 seed=0)):
        store.put("femnist", f"party_{i}", x, y)
        tables.append({"namespace": "femnist", "name": f"party_{i}"})
    model = KerasDefineModel(FEMNIST_DEFINE, device=dev)
    count = sum(v.numel() for v in init_params(model, x[:1]).values())
    if count != N_FEMNIST:
        raise AssertionError(f"the FEMNIST nn_define has {count} parameters")
    conf["role"]["host"] = [10000 + h for h in range(n - 1)]
    rp = conf["role_parameters"]
    rp["guest"]["args"]["data"]["train_data"] = tables[:1]
    rp["host"]["args"]["data"]["train_data"] = tables[1:]
    rp["host"]["dataio_0"] = {k: v[:1] * (n - 1)
                              for k, v in rp["host"]["dataio_0"].items()}
    conf["algorithm_parameters"]["homo_nn_0"].update(
        nn_define=FEMNIST_DEFINE, max_iter=iters)
    conf_path = root / "train_job_conf.json"
    conf_path.write_text(json.dumps(conf))
    out, secs = run_cli(["submit-dsl", "-d", str(
        ROOT / "examples" / "dsl" / "train_job_dsl.json"), "-c",
        str(conf_path), "--processes", "--json"], env)
    check_native_broker("submit-dsl --processes", out["job"])
    rec, outs = read_job(root, out["job"])
    check_job("submit-dsl --processes", rec, outs, n, iters)
    losses = outs["arbiter_0"]["homo_nn_0"]["loss_history"]
    if len(losses) != iters or not np.all(np.isfinite(losses)):
        raise AssertionError(f"submit-dsl: losses {losses}")
    for task in client_tasks(n):
        ev = outs[task].get("evaluation_0") or {}
        if not 0.0 <= ev.get("accuracy", -1.0) <= 1.0:
            raise AssertionError(f"submit-dsl: {task}'s Evaluation {ev}")
    return dict(n=n, iters=iters, secs=secs, out=out, outs=outs,
                losses=losses, conf=conf)


# ---------------------------------------------------------------------------
# phase 13: the job server and the cluster deployment
# ---------------------------------------------------------------------------

def start_server(root: Path, env):
    """`python -m flashe_tpu_torch serve --port 0`, a process on the card
    with FLASHE_MAX_CONCURRENT_JOB_RUN=1; returns it, the URL it printed
    and its seconds to that line (its output goes to root/serve.log)."""
    log = open(root / "serve.log", "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "flashe_tpu_torch", "serve", "--port", "0"],
        cwd=ROOT, env=dict(env, FLASHE_MAX_CONCURRENT_JOB_RUN="1"),
        stdout=log, stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 120
    while True:
        log.seek(0)
        line = log.readline()
        if "http://" in line:
            return proc, line.split("http://")[1].split()[0], \
                time.perf_counter() - t0
        if proc.poll() is not None or time.time() > deadline:
            log.seek(0)
            raise AssertionError(f"serve: rc {proc.poll()}, no address "
                                 f"printed:\n{log.read()[-4000:]}")
        time.sleep(0.2)


def stop_server(proc, timeout):
    """SIGINT the server (it cancels its waiting jobs, lets the running one
    end and exits 0); killed if it is still there after `timeout`."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        return proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dsl_conf(conf, n, iters):
    """A copy of phase 12 (c)'s job conf cut to the guest and n - 1 hosts,
    max_iter iters."""
    conf = json.loads(json.dumps(conf))
    conf["role"]["host"] = conf["role"]["host"][:n - 1]
    rp = conf["role_parameters"]["host"]
    rp["args"]["data"]["train_data"] = rp["args"]["data"]["train_data"][
        :n - 1]
    rp["dataio_0"] = {k: v[:n - 1] for k, v in rp["dataio_0"].items()}
    conf["algorithm_parameters"]["homo_nn_0"]["max_iter"] = iters
    return conf


def tasks_of(n):
    return set(client_tasks(n)) | {"arbiter_0"}


def run_server_job(client, root, env, url, dsl, c):
    """(b) phase 12 (c)'s job submitted over HTTP: the job's checks, its
    losses within SERVER_LOSS_RTOL of phase 12 (c)'s, and the server's
    views of it: tracking's data_view and metric/all, the DAG, the logs,
    the HTML board and `board --server` name every task; metric_data holds
    the arbiter's losses, component/parameters every client's nn_define,
    job/config the submitted DSL and conf."""
    n, iters = c["n"], c["iters"]
    t0 = time.perf_counter()
    job_id = client.submit_job(dsl, c["conf"],
                               timeout=RUNTIME_TIMEOUT_S)["job_id"]
    rec = client.wait_job(job_id, timeout=RUNTIME_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if rec["status"] != "success":
        raise AssertionError(f"serve: job {job_id} ended {rec['status']}: "
                             f"{rec.get('error')}")
    rec, outs = read_job(root, rec)
    check_job("serve", rec, outs, n, iters)
    losses = outs["arbiter_0"]["homo_nn_0"]["loss_history"]
    if not np.allclose(losses, c["losses"], rtol=SERVER_LOSS_RTOL, atol=0):
        raise AssertionError(f"serve: losses {losses}, phase 12 (c) "
                             f"{c['losses']} (rtol {SERVER_LOSS_RTOL})")
    tasks = tasks_of(n)
    result = client.job_result(job_id)["result"]
    check_native_broker("serve", result["job"])
    summary = result["arbiter_0"]["homo_nn_0"]["loss_history"]
    view = client._call("POST", "/v1/tracking/job/data_view",
                        {"job_id": job_id})
    metrics = client._call("POST", "/v1/tracking/component/metric/all",
                           {"job_id": job_id})
    loss = client._call("POST", "/v1/tracking/component/metric_data",
                        {"job_id": job_id, "component_name": "homo_nn_0",
                         "role": "arbiter", "metric_name": "loss"})
    params = [client._call("POST", "/v1/tracking/component/parameters",
                           {"job_id": job_id, "component_name": "homo_nn_0",
                            "role": role, "ordinal": k})
              for role, k in [("guest", 0)] + [("host", h)
                                                for h in range(n - 1)]]
    dag = client._call("POST", "/v1/pipeline/dag/dependency",
                       {"job_id": job_id})
    logs = client.job_log(job_id)
    config = client.job_config(job_id)
    page = urllib.request.urlopen(f"http://{url}/board/{job_id}",
                                  timeout=30).read().decode()
    text, board_s = run_cli_text(["board", "-j", job_id, "--server",
                                  f"http://{url}"], env)
    faults = []
    if summary != [float(v) for v in losses]:
        faults.append(f"job/result losses {summary}")
    if view.get("tasks") != dict.fromkeys(tasks, "success"):
        faults.append(f"data_view tasks {view.get('tasks')}")
    if set(metrics) != tasks or not all(metrics.values()):
        faults.append(f"metric/all names {sorted(metrics)}")
    if loss != {"arbiter_0": {"loss": [[i, v] for i, v in
                                       enumerate(summary)]}}:
        faults.append(f"metric_data {loss}")
    if any(p["parameters"].get("nn_define") != FEMNIST_DEFINE
           or p["parameters"].get("max_iter") != iters for p in params):
        faults.append("component/parameters without the nn_define")
    if dag.get("component_list") != ["dataio_0", "homo_nn_0",
                                     "evaluation_0"]:
        faults.append(f"dag {dag}")
    if set(logs) != tasks:
        faults.append(f"job/log names {sorted(logs)}")
    if config.get("dsl") != dsl or config.get("conf") != c["conf"]:
        faults.append("job/config is not the submitted DSL and conf")
    for name, body in (("/board page", page), ("board --server", text)):
        missing = [t for t in sorted(tasks) if t not in body]
        if missing or job_id not in body:
            faults.append(f"{name} lacks {missing or job_id}")
    if faults:
        raise AssertionError(f"serve: job {job_id}: " + "; ".join(faults))
    return dict(job_id=job_id, secs=secs, outs=outs, losses=losses, n=n,
                iters=iters, board_s=board_s, html_bytes=len(page))


def run_server_queue(client, proc, root, env, url, dsl, c):
    """(c) the queue at FLASHE_MAX_CONCURRENT_JOB_RUN=1: a 3-party job A
    (guest, one host, arbiter) of max_iter 1 runs while B waits (`queue
    --server` shows it); B is stopped while it waits; C is submitted and
    the server interrupted with C still queued.  After the server's exit
    (A's end) A must be success, B and C canceled and never started."""
    conf = dsl_conf(c["conf"], 2, 1)
    server = f"http://{url}"
    t0 = time.perf_counter()
    a = client.submit_job(dsl, conf, timeout=RUNTIME_TIMEOUT_S)["job_id"]
    deadline = time.time() + 60
    while client._call("GET", "/v1/schedule/queue")["running"] != [a]:
        if time.time() > deadline:
            raise AssertionError(f"queue: job {a} not running")
        time.sleep(0.1)
    b = client.submit_job(dsl, conf, timeout=RUNTIME_TIMEOUT_S)["job_id"]
    queue, queue_s = run_cli_text(["queue", "--server", server], env)
    queue = json.loads(queue)
    if queue != {"max_concurrent": 1, "running": [a], "waiting": [b]}:
        raise AssertionError(f"queue: {queue}, expected A {a} running and "
                             f"B {b} waiting")
    stopped, stop_s = run_cli(["stop", "-j", b, "--server", server], env)
    c_id = client.submit_job(dsl, conf, timeout=RUNTIME_TIMEOUT_S)["job_id"]
    queued = client._call("GET", "/v1/schedule/queue")
    if queued["running"] != [a] or c_id not in queued["waiting"]:
        raise AssertionError(f"queue before the server's stop: {queued}")
    rc = stop_server(proc, RUNTIME_TIMEOUT_S)
    secs = time.perf_counter() - t0
    reg = JobRegistry(str(root / "jobs"))
    recs = {k: reg.query(j) for k, j in (("A", a), ("B", b), ("C", c_id))}
    if rc != 0 or stopped["status"] != "canceled":
        raise AssertionError(f"serve exited rc {rc}; stop B said {stopped}")
    for k in ("B", "C"):
        if (recs[k]["status"] != "canceled" or recs[k]["tasks"]
                or "workdir" in recs[k]):
            raise AssertionError(f"queue: job {k} {recs[k]['job_id']} "
                                 f"{recs[k]['status']}, tasks "
                                 f"{recs[k]['tasks']}: it started")
    rec, outs = read_job(root, recs["A"])
    check_job("queue job A", rec, outs, 2, 1)
    with open(root / "jobs" / a / "result.json") as f:
        check_native_broker("queue job A", json.load(f)["job"])
    return dict(ids=(a, b, c_id), secs=secs, queue_s=queue_s,
                stop_s=stop_s, queue=queue, outs=outs)


def run_cluster(root, env):
    """(d) `cluster -c CONF.json --run-local`: the broker and the guest, one
    host and the arbiter of RUNTIME_CONFIG with n_clients 2, each a process
    on the card, against the in-process submit of the same config (this
    process, submit's TF32 settings): every return code 0, every party on
    the card, 2 double launches a client an iteration and none at the
    arbiter, one model at the two clients, losses within
    RUNTIME_LOSS_RTOL."""
    with open(ROOT / "examples" / "configs" / RUNTIME_CONFIG) as f:
        cfg = json.load(f)
    cfg["n_clients"], n, iters = 2, 2, cfg["param"]["max_iter"]
    job_path = root / "cluster_job.json"
    job_path.write_text(json.dumps(cfg))
    param = HomoNNParam.from_dict(cfg["param"])
    parties = {"guest": [], "host": [], "arbiter": [
        {"out": str(root / "cluster_arbiter_0.out")}]}
    for i, (x, y) in enumerate(federated_dataset(
            cfg.get("dataset", param.model), n,
            cfg.get("samples_per_client", 128), seed=cfg.get("seed", 0))):
        role, pid = ("guest", 0) if i == 0 else ("host", i - 1)
        np.savez(root / f"cluster_{role}_{pid}.npz", x=x, y=y)
        parties[role].append({"data": str(root / f"cluster_{role}_{pid}.npz"),
                              "out": str(root / f"cluster_{role}_{pid}.out")})
    conf_path = root / "cluster_conf.json"
    conf_path.write_text(json.dumps({
        "broker": {"host": "127.0.0.1", "port": 0},
        "job": {"id": "phase13", "config": job_path.name},
        "parties": parties, "python": sys.executable}))
    text, secs = run_cli_text(["cluster", "-c", str(conf_path),
                               "--run-local", "--timeout",
                               str(RUNTIME_TIMEOUT_S - 60)], env)
    lines = text.strip().splitlines()
    rcs = json.loads(lines[-1])
    if rcs != dict.fromkeys(tasks_of(n), 0):
        raise AssertionError(f"cluster --run-local: return codes {rcs}")
    if not any(ln.startswith("cluster: the broker (native)")
               for ln in lines):
        raise AssertionError("cluster --run-local: the broker was not the "
                             f"native one: {lines[:-1]}")
    outs = {}
    for task in tasks_of(n):
        with open(root / f"cluster_{task}.out", "rb") as f:
            outs[task] = pickle.load(f)
    rec = {"status": "success", "tasks": {t: {"status": "success"}
                                          for t in tasks_of(n)}}
    check_job("cluster --run-local", rec, outs, n, iters)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["submit", "-c", str(job_path), "--json"])
    submit_s = time.perf_counter() - t0
    ref = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = outs["arbiter_0"]["loss_history"]
    if rc != 0 or not np.allclose(losses, ref["loss_per_round"],
                                  rtol=RUNTIME_LOSS_RTOL, atol=0):
        raise AssertionError(f"cluster --run-local: losses {losses}, "
                             f"in-process submit {ref['loss_per_round']} "
                             f"(rtol {RUNTIME_LOSS_RTOL})")
    return dict(secs=secs, submit_s=submit_s, outs=outs, losses=losses,
                ref=ref["loss_per_round"], n=n, iters=iters)


def print_server_profile(b, c, smi):
    """The server job's steady iteration by phase at the guest and the
    arbiter, beside phase 12 (c)'s."""
    print(f"the steady iteration ({b['iters']} of {b['iters']}) of the DSL "
          f"job by party, ms, host clock, a synchronize of the party's own "
          f"work at each phase's ends, {smi}:")
    for task, start, names in (("guest_0", "local train", TRAIN_PHASES),
                               ("arbiter_0", "collect", ARBITER_PHASES)):
        rows = [(what, steady(r["outs"][task]["phase_log"], start,
                              r["iters"]))
                for what, r in (("serve", b), ("submit-dsl --processes", c))]
        print(f"  {task}: " + "; ".join(
            f"{what} {sum(ph.values()):.2f} (" + ", ".join(
                f"{k} {ph.get(k, 0.0):.2f}" for k in names) + ")"
            for what, ph in rows))


def run_server_phase(root, env, c, smi, server):
    """Phase 13, over phase 12's stores and DataIO tables (c: phase 12
    (c)'s job; server: start_server's, started beside it): (a)-(c) the job
    server, (d) the cluster.  Returns the mask kernel's double launches in
    the server's party processes and in the cluster's."""
    with open(ROOT / "examples" / "dsl" / "train_job_dsl.json") as f:
        dsl = json.load(f)
    proc, url, start_s = server
    try:
        client = FlasheClient(f"http://{url}")
        print(f"python -m flashe_tpu_torch serve --port 0 "
              f"(FLASHE_MAX_CONCURRENT_JOB_RUN=1, started beside phase 12 "
              f"(c)): {start_s:.2f} s to its address, http://{url}, "
              f"{client.version()}")
        b = run_server_job(client, root, env, url, dsl, c)
        print(f"the DSL job of phase 12 (c) submitted over HTTP "
              f"(FlasheClient.submit_job, wait_job): {b['secs']:.2f} s for "
              f"{b['n'] + 1} party processes; every task success, every "
              f"client on the card with 2 x {b['iters']} double launches, "
              f"none at the arbiter, one model digest; losses "
              f"{[round(float(v), 6) for v in b['losses']]} against phase 12 "
              f"(c)'s {[round(float(v), 6) for v in c['losses']]} (rtol "
              f"{SERVER_LOSS_RTOL}); tracking, DAG, logs, config and the "
              f"{b['html_bytes']:,}-byte /board page name every task; "
              f"board -j --server {b['board_s']:.2f} s")
        print_server_profile(b, c, smi)
        q = run_server_queue(client, proc, root, env, url, dsl, c)
        a_id, b_id, c_id = q["ids"]
        print(f"the queue: A {a_id} (guest, 1 host, arbiter, max_iter 1) "
              f"running, B {b_id} waiting ({q['queue']}; queue --server "
              f"{q['queue_s']:.2f} s), B stopped ({q['stop_s']:.2f} s), C "
              f"{c_id} queued, the server interrupted: A success (2 double "
              f"launches a client), B and C canceled and never started; "
              f"{q['secs']:.2f} s from A's submit to the server's exit")
    finally:
        stop_server(proc, 60)
    d = run_cluster(root, env)
    print(f"python -m flashe_tpu_torch cluster -c CONF.json --run-local "
          f"({RUNTIME_CONFIG}, n_clients 2: broker, guest, host, arbiter, "
          f"one process each): {d['secs']:.2f} s; every return code 0, every "
          f"party on the card, 2 x {d['iters']} double launches a client and "
          f"none at the arbiter, one model digest; losses "
          f"{[round(float(v), 6) for v in d['losses']]} against "
          f"{d['ref']} from the in-process submit of the same config "
          f"({d['submit_s']:.2f} s, rtol {RUNTIME_LOSS_RTOL})")
    return {"server": sum(o["mask_launches"]["double"]
                          for r in (b, q) for o in r["outs"].values()),
            "cluster": sum(o["mask_launches"]["double"]
                           for o in d["outs"].values())}


def print_runtime_profile(a, in_process, smi):
    """Each party's steady iteration by phase, in process (phase 10) and
    as processes (phase 12 (a))."""
    train = in_process["train"]
    print(f"the steady iteration ({a['iters']} of {a['iters']}) of "
          f"{RUNTIME_CONFIG} by party, ms, host clock, a synchronize at each "
          f"phase's ends (threads: of the whole card, every thread's work; "
          f"processes: of the party's own work), {smi}:")
    rows = [(t, train["recs"][i]["phases"][-1],
             steady(a["outs"][t]["phase_log"], "local train", a["iters"]),
             TRAIN_PHASES) for i, t in enumerate(client_tasks(a["n"]))]
    rows.append(("arbiter_0", train["arbiter"]["phases"][-1],
                  steady(a["outs"]["arbiter_0"]["phase_log"], "collect",
                         a["iters"]), ARBITER_PHASES))
    for task, threads, procs, names in rows:
        print(f"  {task}: threads {sum(threads.values()):.2f} ("
              + ", ".join(f"{k} {threads.get(k, 0.0):.2f}" for k in names)
              + f"); processes {sum(procs.values()):.2f} ("
              + ", ".join(f"{k} {procs.get(k, 0.0):.2f}" for k in names)
              + ")")


def run_runtime_phase(dev, in_process, smi):
    """Phase 12 (after phase 10, whose in-process run it is compared
    with): (a) the processes, (b) predict, (c) the DSL job.  Every store
    lies in a temporary directory that is removed after; a party process
    still running at the end is stopped by its exact PID.  Then phase 13
    over the same stores.  Returns the mask kernel's double launches in
    phase 12's party processes ("processes"), the server's ("server") and
    the cluster's ("cluster")."""
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_runtime_"))
    env = runtime_env(root)
    servers = []
    try:
        a = run_runtime_processes(root, env, in_process)
        print(f"python -m flashe_tpu_torch submit -c examples/configs/"
              f"{RUNTIME_CONFIG} --processes --checkpoint-dir D --publish "
              f"phase12 --json: {a['secs']:.2f} s for {a['n'] + 1} processes "
              f"(guest, {a['n'] - 1} hosts, arbiter) on one card over the "
              f"native TCP broker; every task success, every client on "
              f"{a['outs']['guest_0']['device']}, 2 x {a['iters']} double "
              f"launches at each client and none at the arbiter, the "
              f"{a['n']} checkpoints equal bit for bit; loss_per_round "
              f"{a['out']['loss_per_round']} against "
              f"{in_process['submit']['loss_per_round']} in process (rtol "
              f"{RUNTIME_LOSS_RTOL})")
        print_runtime_profile(a, in_process, smi)
        starts = sorted(o["startup_s"] for o in a["outs"].values())
        peaks = [o["peak_memory_bytes"] for o in a["outs"].values()]
        print(f"party processes' start-up (spawn to imports done and the "
              f"broker joined; the card's context comes in the first "
              f"iteration): {starts[0]:.2f} / "
              f"{statistics.median(starts):.2f} / {starts[-1]:.2f} s (min / "
              f"median / max); peak device memory allocated by torch: "
              f"{max(peaks) / 2**30:.3f} GiB in the largest party process, "
              f"{sum(peaks) / 2**30:.3f} GiB summed over "
              f"{len(peaks)}, {in_process['peak_bytes'] / 2**30:.3f} GiB "
              f"for phase 10's in-process run of the same configuration")
        # (b) and phase 13's server start run beside (c), whose party
        # processes spend most of its time starting
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            predicted = pool.submit(run_runtime_predict, dev, env, a)
            serving = pool.submit(start_server, root, env)
            try:
                c = run_runtime_dsl(dev, root, env)
            finally:
                try:
                    servers.append(serving.result())
                finally:
                    out, secs, err = predicted.result()
        print(f"python -m flashe_tpu_torch predict -c examples/configs/"
              f"{RUNTIME_CONFIG} --model phase12 (beside (c)): {secs:.2f} s, "
              f"aggregate_iter {out['aggregate_iter']}, {out['n']} samples "
              f"on {out['device']}, scores within {err:.2e} of the guest's "
              f"checkpoint loaded here (limit {PREDICT_ATOL})")
        acc = [round(c["outs"][t]["evaluation_0"]["accuracy"], 4)
               for t in client_tasks(c["n"])]
        print(f"python -m flashe_tpu_torch submit-dsl -d examples/dsl/"
              f"train_job_dsl.json -c (train_job_conf.json with 1 guest + "
              f"{c['n'] - 1} hosts, the FEMNIST CNN as a Keras nn_define "
              f"of {N_FEMNIST:,} parameters, max_iter {c['iters']}) "
              f"--processes: {c['secs']:.2f} s; every task success, every "
              f"client on the card with 2 x {c['iters']} double launches "
              f"and the guest's model bit for bit; losses "
              f"{[round(v, 6) for v in c['losses']]}; the clients' "
              f"Evaluation accuracy {acc}")
        launches = {"processes": sum(o["mask_launches"]["double"]
                                     for r in (a, c)
                                     for o in r["outs"].values())}
        check_no_brokers("phase 12")
        t0 = time.perf_counter()
        launches.update(run_server_phase(root, env, c, smi, servers[0]))
        check_no_brokers("phase 13")
        print(f"phase 13: {time.perf_counter() - t0:.2f} s (host clock); "
              "every job and the cluster over the native broker, no port "
              "fedbroker process left after phases 12 and 13")
        return launches
    finally:
        for proc, _, _ in servers:
            stop_server(proc, 60)
        stop_jobs(root)
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: the scheme-comparison harness
# ---------------------------------------------------------------------------

def run_comparison_phase(smi):
    """`python -m flashe_tpu_torch.tools.compare_schemes --out F` at its
    defaults, a process of its own on the card; its document checked and
    printed as one JSON line.  Returns the document and its seconds."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compare_") as d:
        out = Path(d) / "comparison.json"
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "flashe_tpu_torch.tools.compare_schemes",
             "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
            timeout=COMPARISON_TIMEOUT_S)
        secs = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"compare_schemes: rc {res.returncode}\n"
                                 f"{res.stderr[-6000:]}")
        doc = json.loads(out.read_text())
    cfg, rows = doc["config"], {r["scheme"]: r for r in doc["rows"]}
    if list(rows) != list(COMPARISON_WIRE_MB):
        raise AssertionError(f"compare_schemes rows {list(rows)}")
    wrong = [s for s, r in rows.items() if r["correct"] is not True]
    if wrong:
        raise AssertionError(f"compare_schemes: rows not correct: {wrong}")
    wire = {s: r["wire_mb_per_client"] for s, r in rows.items()}
    if wire != COMPARISON_WIRE_MB:
        raise AssertionError(f"compare_schemes wire MB {wire}, expected "
                             f"{COMPARISON_WIRE_MB}")
    if (cfg["platform"] != "cuda" or cfg["card"] != smi
            or cfg["params"] != N_FEMNIST):
        raise AssertionError(f"compare_schemes config {cfg}, card {smi}")
    want = {"plain": {}, "bfv+batch": {}, "ckks+batch": {},
            "flashe": {"mask double": COMPARISON_FLASHE_DOUBLE},
            "flashe+sparse": {"mask double": COMPARISON_FLASHE_DOUBLE}}
    for s, r in rows.items():
        got = r["launches"]
        if s == "paillier+batch":
            ok = (set(got) <= {"mont_mul", "mont_exp_rows"}
                  and got.get("mont_mul", 0) > 0
                  and got.get("mont_exp_rows", 0) > 0)
        else:
            ok = got == want[s]
        if not ok:
            raise AssertionError(f"compare_schemes {s}: launches {got}")
    print(json.dumps({"comparison": {
        "card": cfg["card"], "seconds": round(secs, 2),
        "train_s_per_round": cfg["train_s_per_round"], "rows": doc["rows"],
        "claims": doc["claims"]}}))
    return doc, secs


# ---------------------------------------------------------------------------
# phase 15: the table data plane (host code)
# ---------------------------------------------------------------------------

def write_table_csv(path: Path):
    """A dense CSV (label, then TABLE_FEATURES floats) from the seed; the
    float32 values it holds, and the labels."""
    rng = np.random.RandomState(SEED)
    x = rng.standard_normal((TABLE_ROWS, TABLE_FEATURES)).astype(np.float32)
    y = rng.randint(0, 10, TABLE_ROWS).astype(np.int32)
    with open(path, "w") as f:
        f.write(",".join(["y"] + [f"x{i}" for i in range(TABLE_FEATURES)])
                + "\n")
        for i in range(TABLE_ROWS):
            f.write(",".join([str(y[i])] + [repr(float(v)) for v in x[i]])
                    + "\n")
    return x, y


def check_instances(table, x, y, what):
    got = dict(table.collect())
    if sorted(got) != list(range(TABLE_ROWS)):
        raise AssertionError(f"{what}: keys {sorted(got)[:8]}...")
    for i, inst in got.items():
        if (inst.inst_id != i or inst.label != int(y[i])
                or not np.array_equal(inst.features, x[i])):
            raise AssertionError(f"{what}: row {i} is {inst}")


def start_storage_node(root: Path):
    """`python -m flashe_tpu_torch storage-node --dir root --port 0`; the
    process, the kind of server it printed and its address."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "flashe_tpu_torch", "storage-node", "--dir",
         str(root), "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE,
        text=True)
    line = proc.stdout.readline()
    if not line.startswith("storage node ("):
        proc.kill()
        proc.wait()
        raise AssertionError(f"storage-node printed {line!r}")
    return proc, line.split("(")[1].split(")")[0], line.split()[-1]


def egg_alive(pid: int) -> bool:
    """An egg processor still running as `pid` (a zombie's command line
    is empty)."""
    try:
        return b"flashe_tpu_torch.data.egg" in Path(
            f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return False


def run_data_plane_phase():
    """Phase 15; returns what it printed as a dict."""
    t0 = time.perf_counter()
    binary = native.kvserver_binary()
    lib = native.build_lib("kvstore.cpp", "libflashekv.so")
    if binary is None or lib is None:
        raise AssertionError(
            f"the native storage node did not build: kvserver "
            f"{native.last_error('kvserver')}, kvstore "
            f"{native.last_error('kvstore')}")
    import cloudpickle  # the tables ship their jobs with it

    pickler = f"cloudpickle {cloudpickle.__version__}"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tables_"))
    proc = None
    try:
        build_s = time.perf_counter() - t0
        proc, kind, addr = start_storage_node(root / "node")
        if kind != "native":
            raise AssertionError(f"storage-node ran the {kind} server")
        csv = root / "table.csv"
        x, y = write_table_csv(csv)
        sess = table_session("chip_smoke", storage_addr=addr)
        up = upload_csv(sess, str(csv), "uploaded", "chip",
                        partition=TABLE_PARTS)
        check_instances(up, x, y, "upload_csv")
        store = DataStore(str(root / "store"))
        store.upload_csv(str(csv), "chip", "stored", partition=TABLE_PARTS)
        table = store.to_dtable(sess, "chip", "stored")
        if table.get_partitions() != TABLE_PARTS:
            raise AssertionError(f"to_dtable: {table.get_partitions()} "
                                 f"partitions")
        check_instances(table, x, y, "to_dtable")

        # server-side compute: the client streams no record meanwhile
        def ops():
            total = collections.Counter()
            for st in sess._stores.values():
                total.update(st.op_counts)
            return total

        before = ops()
        t1 = time.perf_counter()
        feats = table.mapValues(operator.attrgetter("features"))
        fsum = feats.reduce(operator.add)
        lsum = table.mapValues(operator.attrgetter("label")).reduce(
            operator.add)
        pids = {r["pid"] for r in feats._exec_fanout("reduce", operator.add,
                                                     {})}
        exec_s = time.perf_counter() - t1
        after = ops()
        if (after[_ITER], after[_GET]) != (before[_ITER], before[_GET]) \
                or after[_EXEC] != before[_EXEC] + 5:
            raise AssertionError(f"EXEC ops: {before} -> {after}")
        ferr = float(np.max(np.abs(fsum - x.astype(np.float64).sum(0))))
        if ferr > 1e-4 or lsum != int(y.sum()):
            raise AssertionError(f"reduce: features off by {ferr}, labels "
                                 f"{lsum} against {int(y.sum())}")
        eggs = {pid: Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
                for pid in pids}
        for pid, argv in eggs.items():
            if b"flashe_tpu_torch.data.egg" not in argv:
                raise AssertionError(f"egg {pid} runs {argv}")

        # the float facade through the re-encryption schedule, server-side
        pub, priv = PaillierKeypair.generate_keypair(FACADE_KEY_BITS)
        cipher = FloatPaillier(pub, priv)
        calc = EncryptModeCalculator(cipher, mode="fast")
        t2 = time.perf_counter()
        worst = 0.0
        for rnd, scale in enumerate((1.0, 2.0)):
            vals = (feats if rnd == 0 else feats.mapValues(
                functools.partial(np.multiply, scale)))
            enc = calc.encrypt(vals)
            got = dict(enc.collect())
            for i in range(TABLE_ROWS):
                dec = np.array([cipher.decrypt(c) for c in got[i]])
                worst = max(worst, float(np.max(np.abs(
                    dec - scale * x[i].astype(np.float64)))))
        facade_s = time.perf_counter() - t2
        if worst > FACADE_ATOL:
            raise AssertionError(f"encrypt_mode decrypts off by {worst}")
        sess.stop()

        local = open_store(str(root / "local"), 2)
        local_native = local.native
        local.close()
        if not local_native:
            raise AssertionError("the local store did not load "
                                 "libflashekv.so")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"storage-node exited {rc}")
        # a resident egg exits at the EOF of its stdin when the node's
        # server exits, after its interpreter's shutdown (torch's among it)
        deadline = time.time() + EGG_EXIT_S
        while True:
            alive = [pid for pid in pids if egg_alive(pid)]
            if not alive:
                break
            if time.time() > deadline:
                raise AssertionError(f"egg processes {alive} outlived the "
                                     f"node by {EGG_EXIT_S} s")
            time.sleep(0.2)
        return {"server": kind, "local_store": "native", "pickler": pickler,
                "eggs": sorted(pids), "features_err": ferr,
                "facade_err": worst, "build_s": build_s, "exec_s": exec_s,
                "facade_s": facade_s, "secs": time.perf_counter() - t0}
    finally:
        if proc is not None and proc.poll() is None:
            # an interrupt stops the node's native server too (and with it
            # the eggs); a kill would leave them running
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 16: several devices, on one card
# ---------------------------------------------------------------------------

# (a) the grid round, its timed repetitions; (b) the party's lane shards;
# (c) the fan-out's shards and Paillier rows (two chunks of 12: each takes
# mont_exp_rows, which serves 8 rows or more); (d) the multi-process
# check's processes on gloo; (e) the mesh conf's hosts, rounds and samples
# a host; (f) the graft twin's devices (4 clients x 2 shards, FemnistCNN)
MESH_CLIENTS, MESH_SHARDS, MESH_ROUND_REPS = 10, 2, 5
PARTY_SHARDS = 4
FAN_SHARDS, FAN_ROWS = 2, 24
MULTIHOST_PROCS = 4
MESH_HOSTS, MESH_ROUNDS, MESH_SAMPLES = 4, 2, 128
# (e)'s losses against plain_mesh_losses: the stochastic rounding moves a
# weight by at most one step of its layer's clip range over 2^16 - 1, the
# loss by far less than this; a wrong degree factor, scale or sign in the
# decode moves it by far more
MESH_LOSS_ATOL = 1e-4
GRAFT_DEVICES = 8
# an encrypt's chain under a 2048-bit key: into the domain, 15 table
# products, 4 squarings and a product for each of n's 512 base-16 digits,
# out of the domain
PAILLIER_ENC_MULS = 1 + 15 + 5 * 512 + 1


def mode_delta(before):
    """The mask kernel's launches by mode since `before` (a copy)."""
    return {k: fm.mode_launches[k] - before[k] for k in fm.MODES}


def flashe_clients(dev, n, it, mask="double", shards=None):
    """n FlasheCiphers with ordinals 0..n-1 and the seed, at iteration
    it; with `shards`, each splits its lanes over that many copies of
    dev."""
    out = []
    for i in range(n):
        c = FlasheCipher(INT_BITS, mask=mask, device=dev)
        c.idx = i
        c.set_num_clients(n)
        c.generate_prp_seed(assigned_seed=SEED)
        c.set_iter_index(it)
        if shards:
            c.set_local_devices(shards, [dev] * shards)
        out.append(c)
    return out


def run_mesh_round(dev):
    """(a) encrypted_aggregate on a MESH_CLIENTS x MESH_SHARDS grid of dev
    at FemnistCNN's width, all in and then client 9 dropped: each decrypt
    equal to the numpy sum mod 2^20 and, bit for bit, to the round of
    single-device FlasheCiphers on the same q, and each cell's
    encrypt_shard bit for bit its slice of that client's
    FlasheCipher.encrypt; the launches of a round
    (an encrypt a cell, a decrypt pair a lane shard) and its ms, host clock
    to a synchronize, median of MESH_ROUND_REPS."""
    n = padded_lane_count(N_FEMNIST, INT_BITS, MESH_SHARDS)
    gen = torch.Generator(dev).manual_seed(SEED + 16)
    q = torch.randint(0, 1 << ELEMENT_BITS, (MESH_CLIENTS, n), generator=gen,
                      device=dev, dtype=torch.int32)
    q_host = q.cpu().numpy().astype(np.int64)
    mesh = make_mesh(MESH_CLIENTS, MESH_SHARDS,
                     [dev] * (MESH_CLIENTS * MESH_SHARDS))
    rk = flashe_clients(dev, 1, 0)[0]._round_keys
    rounds = []
    for it, survivors in ((0, None), (1, tuple(range(MESH_CLIENTS - 1)))):
        alive = list(range(MESH_CLIENTS) if survivors is None else survivors)
        torch.cuda.synchronize()
        before = dict(fm.mode_launches)
        got = encrypted_aggregate(mesh, rk, q, it, INT_BITS, MESH_CLIENTS,
                                  survivors)
        torch.cuda.synchronize()
        launches = mode_delta(before)
        pairs = len(merge_idx_runs(alive)[0])
        want = MESH_CLIENTS * MESH_SHARDS + MESH_SHARDS * pairs
        if launches != dict(dict.fromkeys(fm.MODES, 0), double=want):
            raise AssertionError(f"grid round {it}: launches {launches}, "
                                 f"expected {want} double")
        if not np.array_equal(got.cpu().numpy(),
                              q_host[alive].sum(0) % (1 << INT_BITS)):
            raise AssertionError(f"grid round {it}: decrypt != sum(q) mod "
                                 f"2^{INT_BITS}")
        ciphers = flashe_clients(dev, MESH_CLIENTS, it)
        cts = [ciphers[i].encrypt(q[i]) for i in range(MESH_CLIENTS)]
        # every cell's ciphertext is its slice of the client's
        # single-device one: the shard's counters start at its offset
        ns = n // MESH_SHARDS
        for i in range(MESH_CLIENTS):
            for s in range(MESH_SHARDS):
                part = slice(s * ns, (s + 1) * ns)
                if not torch.equal(encrypt_shard(rk, q[i, part], it, i, s,
                                                 INT_BITS), cts[i][part]):
                    raise AssertionError(
                        f"grid round {it}: client {i} shard {s}'s "
                        f"ciphertext differs from FlasheCipher.encrypt's")
        agg = arbiter_reduce([cts[i] for i in alive], INT_BITS)
        if not torch.equal(got, ciphers[0].decrypt(agg, alive)):
            raise AssertionError(f"grid round {it}: decrypt differs from "
                                 f"the single-device FlasheCipher round")
        ms = []
        for _ in range(MESH_ROUND_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encrypted_aggregate(mesh, rk, q, it, INT_BITS, MESH_CLIENTS,
                                survivors)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        rounds.append(dict(survivors=len(alive), launches=want,
                           ms=statistics.median(ms), samples=ms))
    return dict(lanes=n, rounds=rounds)


def run_sharded_party(dev):
    """(b) FlasheCipher.set_local_devices(PARTY_SHARDS, [dev] * 4): 10
    clients' dense double and single masks at FemnistCNN's width, and the
    path-S sparse decrypt (N_COMPACT locations a client, 10 survivors)
    through sparse_decrypt_fanout, each bit for bit the unsharded
    cipher's and every decrypt the (densified) sum of q; the sharded
    launches by mode."""
    gen = torch.Generator(dev).manual_seed(SEED + 17)
    q = torch.randint(0, 1 << ELEMENT_BITS, (N_CLIENTS, N_FEMNIST),
                      generator=gen, device=dev, dtype=torch.int32)
    want = q.long().sum(0) % (1 << INT_BITS)
    launched = dict.fromkeys(fm.MODES, 0)
    alive = list(range(N_CLIENTS))
    for mask in ("double", "single"):
        sharded = flashe_clients(dev, N_CLIENTS, 3, mask, PARTY_SHARDS)
        single = flashe_clients(dev, N_CLIENTS, 3, mask)
        cts = []
        for i in alive:
            before = dict(fm.mode_launches)
            ct = sharded[i].encrypt(q[i])
            for k, v in mode_delta(before).items():
                launched[k] += v
            if not torch.equal(ct, single[i].encrypt(q[i])):
                raise AssertionError(f"sharded {mask} encrypt of client {i} "
                                     f"differs from the unsharded one")
            cts.append(ct)
        agg = arbiter_reduce(cts, INT_BITS)
        before = dict(fm.mode_launches)
        dec = sharded[0].decrypt(agg, alive)
        for k, v in mode_delta(before).items():
            launched[k] += v
        if not (torch.equal(dec, single[0].decrypt(agg, alive))
                and torch.equal(dec.long(), want)):
            raise AssertionError(f"sharded {mask} decrypt differs from the "
                                 f"unsharded one or from sum(q)")
    # path S: each client single-masks its compact vector (counters from
    # 0); the arbiter scatters the uploads to their locations
    rng = np.random.RandomState(SEED + 18)
    locs = [np.sort(rng.choice(N_FEMNIST, N_COMPACT, replace=False))
            for _ in alive]
    compact = torch.randint(0, 1 << ELEMENT_BITS, (N_CLIENTS, N_COMPACT),
                            generator=gen, device=dev, dtype=torch.int32)
    clients = flashe_clients(dev, N_CLIENTS, 4, "single")
    dense = torch.zeros(N_FEMNIST, dtype=torch.int64, device=dev)
    plain = torch.zeros(N_FEMNIST, dtype=torch.int64, device=dev)
    for i in alive:
        loc = torch.from_numpy(locs[i]).to(dev)
        dense.index_add_(0, loc, lanes.as_u32(clients[i].encrypt(compact[i])))
        plain.index_add_(0, loc, compact[i].long())
    dense = lanes.to_i32(dense % (1 << INT_BITS))
    sharded = flashe_clients(dev, N_CLIENTS, 4, "single", PARTY_SHARDS)[0]
    single = flashe_clients(dev, N_CLIENTS, 4, "single")[0]
    for c in (sharded, single):
        c.set_masks(locs, N_FEMNIST)
    before = dict(fm.mode_launches)
    dec = sharded.decrypt(dense, alive)
    sparse = mode_delta(before)
    for k, v in sparse.items():
        launched[k] += v
    if sparse["scatter"] != N_CLIENTS:
        raise AssertionError(f"sparse fan-out launches {sparse}")
    if not (torch.equal(dec, single.decrypt(dense, alive))
            and torch.equal(dec.long(), plain % (1 << INT_BITS))):
        raise AssertionError("the sparse decrypt fanned out by client "
                             "differs from the unsharded one or the sum")
    return launched


def run_fanout_he(dev, keypair):
    """(c) DeviceFanout over [dev] * FAN_SHARDS: Paillier under the
    phase's 2048-bit key, FAN_ROWS values encrypted fanned, decrypted
    fanned and unfanned, equal to each other, to python pow and to the
    values; BFV and CKKS at full width, 10 clients encrypting fanned,
    the arbiter's sum, the guest's fanned decrypt exact (BFV, mod t) or
    within CKKS_ATOL of the float64 sum.  Returns the Montgomery launches
    a chunk."""
    pub, priv = keypair
    one, fan = PaillierCipher(device=dev), PaillierCipher(device=dev)
    for c in (one, fan):
        c.set_public_key(pub)
        c.set_privacy_key(priv)
    fan.set_local_devices(FAN_SHARDS, [dev] * FAN_SHARDS)
    rng = random.Random(SEED)
    vals = [rng.getrandbits(PAILLIER_BITS) for _ in range(FAN_ROWS)]
    for k in mg.launches:
        mg.launches[k] = 0
    cts = fan.encrypt(vals)
    enc = dict(mg.launches)
    got = fan.decrypt(cts)
    dec = {k: mg.launches[k] - enc[k] for k in mg.launches}
    total = dict(mg.launches)
    if not (list(got) == list(one.decrypt(cts)) == vals
            == [priv.decrypt_scalar(int(c)) for c in cts]):
        raise AssertionError("Paillier: the fanned decrypt differs from "
                             "the unfanned one, python pow or the values")
    if (enc != {"mont_mul": FAN_SHARDS * PAILLIER_ENC_MULS, "mont_mul_vec": 0,
                "mont_exp_rows": 0}
            or dec != {"mont_mul": 0, "mont_mul_vec": 0,
                       "mont_exp_rows": FAN_SHARDS}):
        raise AssertionError(f"Paillier fan-out launches: encrypt {enc}, "
                             f"decrypt {dec}")
    he = {}
    gen = torch.Generator(dev).manual_seed(SEED + 19)
    q = torch.randint(0, 1 << ELEMENT_BITS, (N_CLIENTS, N_FEMNIST),
                      generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn((N_CLIENTS, N_FEMNIST), generator=gen, device=dev,
                    dtype=torch.float32)
    for name, make, values in (
            ("BFV", lambda seed=None: BFVCipher(HE_T, HE_M, flagBatching=True,
                                                seed=seed, device=dev), q),
            ("CKKS", lambda seed=None: CKKSCipher(HE_M, seed=seed,
                                                  device=dev), x)):
        t0 = time.perf_counter()
        clients = _he_ciphers(make, make(SEED).generate_keys(), N_CLIENTS)
        for c in clients:
            c.set_local_devices(FAN_SHARDS, [dev] * FAN_SHARDS)
        ups = [c.encrypt(v) for c, v in zip(clients, values)]
        agg = make().add_ciphertexts(ups)
        got = clients[0].decrypt(agg, N_FEMNIST)
        torch.cuda.synchronize()
        if name == "BFV":
            err = int((got.long() - q.long().sum(0) % HE_T).abs().max())
        else:
            err = float((got - x.double().sum(0)).abs().max())
        if not (isinstance(ups[0], np.ndarray) and err <= (
                0 if name == "BFV" else CKKS_ATOL)):
            raise AssertionError(f"{name} fanned: {type(ups[0])}, decrypt "
                                 f"off the sum by {err}")
        he[name] = dict(err=err, cts=ups[0].shape[0],
                        secs=time.perf_counter() - t0)
    return dict(enc=enc, dec=dec, total=total, he=he)


def parse_ok(out: str) -> dict:
    """The multi-process child's OK line as a dict."""
    line = next(l for l in out.splitlines() if l.startswith("OK "))
    fields = dict(kv.split("=", 1) for kv in line.split()[1:]
                  if "=" in kv and not kv.startswith("mesh="))
    fields["launches"] = json.loads(fields["launches"])
    return fields


def run_multihost(dev, n_proc):
    """(d) launch_local of parallel/_multihost_child.py at FemnistCNN's
    width, n_proc processes on the card (gloo where they share it, NCCL for
    one): every process checks both rounds against the plain sum, all
    print the same digests, equal to the in-process grid's on the same q,
    each process launches 2 encrypts + 2 decrypt pairs."""
    child = str(ROOT / "flashe_tpu_torch" / "parallel" /
                "_multihost_child.py")
    devices, backend = multihost.placement(n_proc, 1, dev.type)
    t0 = time.perf_counter()
    outs = multihost.launch_local(n_proc, 1, child,
                                  ["--elements", str(N_FEMNIST)],
                                  timeout=300, device=dev.type)
    secs = time.perf_counter() - t0
    rows = [parse_ok(o) for o in outs]
    n = padded_lane_count(N_FEMNIST, INT_BITS, 1)
    q = np.random.RandomState(0).randint(0, 1 << 16, (n_proc, n))
    qt = torch.from_numpy(q.astype(np.int32)).to(dev)
    mesh = make_mesh(n_proc, 1, [dev] * n_proc)
    rk = round_keys(dev)
    survivors = tuple(range(n_proc - 1)) if n_proc > 1 else (0,)
    want = [hashlib.sha256(encrypted_aggregate(
        mesh, rk, qt, it, INT_BITS, n_proc, surv).cpu().numpy()
        .tobytes()).hexdigest()[:16]
        for it, surv in ((0, None), (1, survivors))]
    for pid, r in enumerate(rows):
        if (r["backend"] != backend or r["devices"] != devices[pid][0]
                or [r["digest0"], r["digest1"]] != want
                or r["launches"]["double"] != 4
                or sum(r["launches"].values()) != 4):
            raise AssertionError(f"multihost process {pid} of {n_proc}: "
                                 f"{r}, expected backend {backend}, "
                                 f"digests {want}, 4 double launches")
    return dict(processes=n_proc, backend=backend, secs=secs,
                first_round_s=[float(r["first_round_s"]) for r in rows],
                launches=sum(r["launches"]["double"] for r in rows))


def mesh_results(out: str) -> list:
    """The mesh-party processes' JSON results in a shared output, where
    their lines may run together."""
    dec = json.JSONDecoder()
    return [dec.raw_decode(out, m.start())[0]
            for m in re.finditer(r'\{"loss_history"', out)]


def plain_mesh_losses(dev, shards, rounds, learning_rate=0.05,
                      element_bits=16):
    """run_mesh_training's rounds on FemnistCNN in float64, with no mask
    and no collective, and the stochastic rounding's expected value in
    place of its draws (the JAX package's decode, protocol/aggregator.py's
    get_aggregated_model).  Every client trains its model on its shard
    (SGD, batches of 32, its trainer seeded by its process id) and uploads
    degree x weights less its running layer means, clipped at ACIQ's alpha
    from its running layer stds and scaled to element_bits; each process
    unquantizes the sum with its own alpha, weights it by degree / total
    degree, adds its means back, takes the new running statistics and
    divides by its degree.  Returns each round's degree-weighted mean of
    the processes' losses on their own shards."""
    trainers = []
    for pid, (x, _) in enumerate(shards):
        mdl = build_model("femnist_cnn", device=dev)
        init_params(mdl, x[:1], seed=0)
        trainers.append(LocalTrainer(mdl, optimizer="sgd",
                                     learning_rate=learning_rate, seed=pid,
                                     device=dev))
    n = len(shards)
    degrees = [float(len(x)) for x, _ in shards]
    total = sum(degrees)
    half_range = ((1 << element_bits) - 1) / 2.0
    aciq = ACIQ(element_bits)

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
            ws.append({k: v.double() for k, v in t.params.items()})
        qsum = {k: sum((torch.clamp(degrees[i] * ws[i][k] - means[i][k],
                                    -alpha(stds[i][k]), alpha(stds[i][k]))
                        + alpha(stds[i][k])) * half_range / alpha(stds[i][k])
                       for i in range(n)) for k in keys}
        for p, t in enumerate(trainers):
            new = {}
            for k in keys:
                a = alpha(stds[p][k]) * n
                agg = qsum[k] * 2.0 * a / (2.0 * half_range * n) - a
                agg = agg * degrees[p] / total + means[p][k]
                means[p][k] = float(agg.mean())
                stds[p][k] = float(agg.std(unbiased=False))
                new[k] = (agg / degrees[p]).float()
            t.set_model_weights(new)
        losses.append(sum(d * t.evaluate(x, y.astype(np.int64))[0]
                          for d, t, (x, y) in zip(degrees, trainers, shards))
                      / total)
    return losses


def run_mesh_party(dev, root: Path, env, tf32):
    """(e) `cluster --run-local` of a MESH_HOSTS-host mesh conf: FemnistCNN,
    MESH_ROUNDS rounds, each host a .npz shard of the port's synthetic
    FEMNIST data; every process on the card, the same model digest,
    finite losses that fall and lie within MESH_LOSS_ATOL of
    plain_mesh_losses on the same shards (run here under the processes'
    TF32 settings, torch's own `tf32`), 2 launches (an encrypt and a
    decrypt pair) a round."""
    hosts = []
    shards = federated_dataset("femnist", MESH_HOSTS, MESH_SAMPLES, seed=SEED)
    for i, (x, y) in enumerate(shards):
        path = root / f"mesh_shard{i}.npz"
        np.savez(path, x=x, y=y)
        hosts.append({"host": "127.0.0.1", "data": str(path)})
    conf = root / "mesh_conf.json"
    conf.write_text(json.dumps({"mesh": {
        "hosts": hosts, "rounds": MESH_ROUNDS, "model": "femnist_cnn"},
        "python": sys.executable}))
    out, secs = run_cli_text(["cluster", "-c", str(conf), "--run-local",
                              "--timeout", "300"]
                             + ["--cpu"] * (dev.type == "cpu"), env)
    rcs = json.loads(out.strip().splitlines()[-1])
    results = mesh_results(out)
    _, backend = multihost.placement(MESH_HOSTS, 1, dev.type)
    if (rcs != {f"mesh_{i}": 0 for i in range(MESH_HOSTS)}
            or sorted(r["process_id"] for r in results)
            != list(range(MESH_HOSTS))
            or len({r["model_digest"] for r in results}) != 1
            or any(not r["device"].startswith(dev.type)
                   or r["backend"] != backend
                   or len(r["loss_history"]) != MESH_ROUNDS
                   or not np.all(np.isfinite(r["loss_history"]))
                   or r["launches"]["double"] != 2 * MESH_ROUNDS
                   for r in results)):
        raise AssertionError(f"mesh conf --run-local: {rcs}, {results}")
    losses = results[0]["loss_history"]
    if any(r["loss_history"] != losses for r in results) or not (
            losses[-1] < losses[0]):
        raise AssertionError(f"mesh conf --run-local: losses "
                             f"{[r['loss_history'] for r in results]}, "
                             f"expected one history that falls")
    with submit_tf32(tf32):
        want = plain_mesh_losses(dev, shards, MESH_ROUNDS)
    err = max(abs(a - b) for a, b in zip(losses, want))
    if err > MESH_LOSS_ATOL:
        raise AssertionError(f"mesh conf --run-local: losses {losses}, the "
                             f"plain rounds' {want}")
    return dict(secs=secs, backend=backend, losses=losses, want=want,
                err=err, digest=results[0]["model_digest"][:16],
                launches=sum(r["launches"]["double"] for r in results))


def run_multi_gpu_phase(dev, keypair, tf32):
    """Phase 16; returns what the kernels' line and the summary need."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    for k in mg.launches:
        mg.launches[k] = 0
    t0 = time.perf_counter()
    grid = run_mesh_round(dev)
    for r in grid["rounds"]:
        print(f"phase 16 (a): encrypted_aggregate on a {MESH_CLIENTS} x "
              f"{MESH_SHARDS} grid of {dev}, {grid['lanes']} lanes, "
              f"survivors {r['survivors']}/{MESH_CLIENTS}: decrypt == sum(q) "
              f"mod 2^{INT_BITS} == the single-device FlasheCipher round, "
              f"bit for bit, every cell's ciphertext its slice of the "
              f"client's FlasheCipher.encrypt; launches {r['launches']} double a round "
              f"({MESH_CLIENTS * MESH_SHARDS} encrypts + {MESH_SHARDS} x "
              f"{(r['launches'] - MESH_CLIENTS * MESH_SHARDS) // MESH_SHARDS}"
              f" decrypt pairs); {r['ms']:.3f} ms a round (median of "
              f"{MESH_ROUND_REPS}, host clock to a synchronize; samples "
              f"{[round(v, 3) for v in r['samples']]})")
    party = run_sharded_party(dev)
    print(f"phase 16 (b): FlasheCipher.set_local_devices({PARTY_SHARDS}, "
          f"[{dev}] x {PARTY_SHARDS}): the dense double and single masks of "
          f"{N_CLIENTS} clients at {N_FEMNIST} lanes and the path-S sparse "
          f"decrypt ({N_CLIENTS} survivors x {N_COMPACT} locations, "
          f"sparse_decrypt_fanout) bit for bit the unsharded cipher's; the "
          f"sharded launches {party}")
    fan = run_fanout_he(dev, keypair)
    print(f"phase 16 (c): DeviceFanout over [{dev}] x {FAN_SHARDS}: "
          f"Paillier (2048-bit key) {FAN_ROWS} values encrypted and "
          f"decrypted fanned == unfanned == python pow; launches a chunk: "
          f"encrypt {fan['enc']['mont_mul'] // FAN_SHARDS} mont_mul, decrypt "
          f"{fan['dec']['mont_exp_rows'] // FAN_SHARDS} mont_exp_rows; "
          + "; ".join(f"{k} {v['cts']} ciphertexts a client, 10 clients "
                      f"fanned, decrypt off the sum by {v['err']:.3g} "
                      f"({v['secs']:.2f} s)" for k, v in fan["he"].items()))
    in_process = dict(fm.mode_launches)
    in_process_mont = dict(mg.launches)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_multi_gpu_"))
    try:
        # the process groups of (d) and (e) start together: each is mostly
        # its processes' start, on the host's cores
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            groups = [pool.submit(run_multihost, dev, n)
                      for n in (MULTIHOST_PROCS, 1)]
            party = pool.submit(run_mesh_party, dev, root, runtime_env(root),
                                tf32)
            hosts = [g.result() for g in groups]
            mesh = party.result()
        for r in hosts:
            print(f"phase 16 (d): launch_local of _multihost_child.py, "
                  f"{r['processes']} process(es) on {dev}, backend "
                  f"{r['backend']}, {N_FEMNIST} elements: both rounds == the "
                  f"plain sum in every process, digests == the in-process "
                  f"grid's; {r['launches']} double launches; first round "
                  f"{[round(v, 3) for v in r['first_round_s']]} s; "
                  f"{r['secs']:.2f} s with the processes' start, beside "
                  f"(e)'s and the other group's")
        print(f"phase 16 (e): cluster --run-local of a {MESH_HOSTS}-host mesh "
              f"conf (femnist_cnn, {MESH_ROUNDS} rounds, {MESH_SAMPLES} "
              f"samples a host, backend {mesh['backend']} on {dev}): one model"
              f" digest {mesh['digest']}, losses {mesh['losses']} falling, "
              f"within {mesh['err']:.2e} of the plain float64 rounds' "
              f"{mesh['want']} (limit {MESH_LOSS_ATOL:g}); {mesh['launches']} "
              f"double launches; {mesh['secs']:.2f} s, beside (d)'s groups")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    before = dict(fm.mode_launches)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft.dryrun_multichip(GRAFT_DEVICES, devices=[dev] * GRAFT_DEVICES)
    dry = mode_delta(before)
    if (not buf.getvalue().startswith(
            "dryrun_multichip ok: mesh={'clients': 4, 'lanes': 2} "
            "model=FemnistCNN params=1206590")
            or dry["double"] != 2 * (8 + 2)):
        raise AssertionError(f"dryrun_multichip: {buf.getvalue()!r}, "
                             f"launches {dry}")
    print(f"phase 16 (f): graft.dryrun_multichip({GRAFT_DEVICES}, [{dev}] x "
          f"{GRAFT_DEVICES}): {buf.getvalue().strip()}; launches {dry}")
    for k, v in dry.items():
        in_process[k] += v
    launches = dict(in_process)
    launches["double"] += (sum(r["launches"] for r in hosts)
                           + mesh["launches"])
    secs = time.perf_counter() - t_phase
    print(f"phase 16: {secs:.2f} s; mask launches by mode {launches} (in "
          f"this process {in_process}, in the children "
          f"{launches['double'] - in_process['double']} double); Montgomery "
          f"{in_process_mont}")
    return dict(mask=launches, mont=in_process_mont, secs=secs)


# ---------------------------------------------------------------------------
# phase 17: the benchmark harness (flashe_tpu_torch/tools/bench.py)
# ---------------------------------------------------------------------------

BENCH_TIMEOUT_S = 300
BENCH_REPS, BENCH_STATS = 20, 5  # the harness's defaults
BENCH_PARTY_DEVICES = 2  # the party mode over cuda:0 twice, as phase 16
BENCH_METRICS = {
    "flashe": "flashe_enc_agg_dec_elements_per_sec_per_chip",
    "roundtrip1m": "flashe64_roundtrip_elements_per_sec",
    "precompute": "flashe_online_round_seconds_10clients_10m",
    "paillier": "paillier2048_modexp_ciphertexts_per_sec",
    "model100m": "flashe_100m_full_round_elements_per_sec",
    "table2": "table2",
    "roofline": "roofline",
    "multihost": "flashe_multihost_round_elements_per_sec",
    "party": "party_shard_scaling",
}
# mont_mul launches of mont_exp_window under a 2048-bit key (15 table
# products, 4 squarings and a product for each of n's 512 digits), and of
# one add_ciphertexts of 10 uploads (10 into the domain, 9 products, 1 out)
MODEXP_MULS = 15 + 5 * 512
PAILLIER_ADD10_MULS = 10 + 9 + 1


# the mask kernel at the harness's shapes that no earlier phase runs, each
# a whole launch held lane for lane against the plain version: model100m's
# encrypt (client 9: streams 9 and 10) and decrypt (the boundary pair 10
# and 0) at 100,000,000 lanes, 16,666,667 counter blocks a stream;
# precompute's stream 10 (single mode, on zeros) at 10,000,000;
# roundtrip1m's encrypt (streams 0 and 1) at 1,048,576 lanes of 2 limbs
HARNESS_MASK_CASES = (
    ("model100m encrypt", 100_000_000, INT_BITS, 9, 10, False),
    ("model100m decrypt", 100_000_000, INT_BITS, N_CLIENTS, 0, False),
    ("precompute stream 10", 10_000_000, INT_BITS, N_CLIENTS, None, True),
    ("roundtrip1m encrypt", 1_048_576, 64, 0, 1, False),
)
# the plain version runs chunk by chunk (its AES holds 128 bytes of int64
# a counter block): 2^21 blocks a chunk, each at its own base_block
REF_CHUNK_BLOCKS = 1 << 21
# table2 in the script: its first size (the script's time, PERF.md section
# 4); `python -m flashe_tpu_torch.tools.bench --mode table2` runs all three
BENCH_TABLE_SIZES = (16384,)


def check_harness_masks(dev):
    """HARNESS_MASK_CASES: one launch of fm.mask_apply over the whole
    vector, against fm.mask_apply_ref over every chunk of it at the
    chunk's counter block.  Returns {case: (lanes, max abs error, the
    kernel's mode)}."""
    rk = round_keys(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 17)
    out = {}
    for what, n, m, add, minus, zeros in HARNESS_MASK_CASES:
        q = (torch.zeros(n, dtype=torch.int32, device=dev) if zeros
             else _rand_lanes(gen, dev, n, m))
        got = fm.mask_apply(q, rk, 0, add, minus, m)
        merge = masks.merge_size(m)
        step = REF_CHUNK_BLOCKS * merge
        err = 0
        for s in range(0, n, step):
            err = max(err, _same(
                "mask kernel", got[s:s + step],
                fm.mask_apply_ref(q[s:s + step], rk, 0, add, minus, m,
                                  base_block=s // merge),
                f"{what}, lanes {s} .. {min(s + step, n) - 1} of {n}"))
        mode = ("single" if minus is None else "limbs" if m > 32
                else "double")
        out[what] = (n, err, mode)
        del q, got
    torch.cuda.empty_cache()
    return out


def bench_cli_launches(reps=BENCH_REPS, stats=BENCH_STATS, c=N_CLIENTS):
    """The mask launches of `bench --verbose`: a warm round (c encrypts, a
    decrypt), stats samples of reps runs of c encrypts and of a decrypt,
    reps encrypts of one client, reps rounds on the host clock, and the
    CUDA graphs (a warm call and reps captured calls of each phase; a
    replay launches through no wrapper)."""
    return ((c + 1) * (1 + stats * reps) + reps + (c + 1) * reps
            + c * (1 + reps) + 1 + reps)


def run_bench_cli(smi):
    """`python -m flashe_tpu_torch.tools.bench --verbose`, a process of its
    own: exit 0, one JSON line with bench.py's metric, the guard held (the
    process exits non-zero otherwise), 5 samples, the card's line and the
    mask launches its code makes.  Returns the line and its seconds."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "flashe_tpu_torch.tools.bench", "--verbose"],
        cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench --verbose: rc {res.returncode}, "
                             f"{len(lines)} lines\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-6000:]}")
    out = json.loads(lines[0])
    d = out["detail"]
    want = {"mask double": bench_cli_launches()}
    if (out["metric"] != BENCH_METRICS["flashe"] or out["unit"] != "elements/s"
            or out["spread"]["n_samples"] != BENCH_STATS
            or d["card"] != smi or d["elements"] != 4_194_304
            or d["clients"] != N_CLIENTS or d["int_bits"] != INT_BITS
            or d["launches"] != want or not out["value"] > 0):
        raise AssertionError(f"bench --verbose: {out}, expected the card "
                             f"{smi!r} and launches {want}")
    return out, secs


def table2_launches(rows):
    """The kernel launches of run_table2's code, from each row's calls:
    a FLASHE encrypt or decrypt call is one double launch and each row
    encrypts 9 more clients once; a Paillier encrypt call is one
    mont_exp_window with a product into and out of the domain, an add
    PAILLIER_ADD10_MULS products, a decrypt one mont_exp_rows (every
    decrypt here has at least 8 ciphertexts); BFV and CKKS launch no
    kernel of csrc/."""
    want = collections.Counter()
    for r in rows:
        calls = r["calls"]
        if calls is None:
            continue
        if r["algorithm"] == "flashe":
            want["mask double"] += (calls["encrypt"] + N_CLIENTS - 1
                                    + calls["decrypt"])
        elif r["algorithm"].startswith("paillier"):
            if r["ciphertext_bytes"] // 512 < 8:
                raise AssertionError(f"table2 row {r}: fewer than 8 "
                                     "ciphertexts, a mont_mul_vec decrypt")
            want["mont_mul"] += (PAILLIER_ENC_MULS * calls["encrypt"]
                                 + PAILLIER_ADD10_MULS * calls["add10"])
            want["mont_exp_rows"] += calls["decrypt"]
    return dict(want)


def check_bench(name, out, got, want):
    """A mode's result: its metric, its correctness and the launches its
    code makes (`want`), `got` being the launches read around it."""
    if out["metric"] != BENCH_METRICS[name]:
        raise AssertionError(f"bench {name}: metric {out['metric']}")
    if got != want:
        raise AssertionError(f"bench {name}: launches {got}, its code makes "
                             f"{want}")


def time_ceiling(dev, card, n=8_388_608):
    """The ceiling kernels of the roofline mode at its shape: each against
    its plain torch version on the card over the whole vector, the max
    abs difference, ms a call of each (CUDA events, in turns), the bound
    (ceiling.per_element's integer instructions and loads an element)."""
    x = torch.arange(n, dtype=torch.int32, device=dev)
    counts = ceiling.per_element()
    out = {}
    for name, kern, plain in (
            ("int_chain", ceiling.int_chain, ceiling.int_chain_ref),
            ("lds_chain", ceiling.lds_chain, ceiling.lds_chain_ref)):
        err = int((kern(x).long() - plain(x).long()).abs().max())
        if err:
            raise AssertionError(f"{name}: the kernel differs from its plain "
                                 f"version by {err}")
        ms, plain_ms = time_turns(lambda: kern(x), lambda: plain(x), 20, 2)
        ints, lds = counts[name]
        out[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                         bound=roofline.bound_ms(n * ints, 8 * n, card,
                                                 lds=n * lds),
                         per_element=counts[name])
    return out


def run_bench_phase(dev, keypair, smi):
    """Phase 17: the harness's nine modes at their defaults (table2 without
    --full; party over cuda:0 twice), the headline as a process and the
    others in this process, each one's launches read as deltas around it.
    Returns {mode: (result, launches, seconds)}."""
    t_phase = time.perf_counter()
    runs = {}
    head, secs = run_bench_cli(smi)
    runs["flashe"] = (head, head["detail"]["launches"], secs)

    def mode(name, fn, *args, **kw):
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn(dev, *args, **kw)
        runs[name] = (out, launches_since(before),
                      time.perf_counter() - t0)
        return out

    out = mode("roundtrip1m", bench.run_roundtrip1m)
    check_bench("roundtrip1m", out, runs["roundtrip1m"][1],
                {"mask limbs": 2 + 2 * BENCH_REPS})
    out = mode("precompute", bench.run_precompute)
    check_bench("precompute", out, runs["precompute"][1],
                {"mask single": N_CLIENTS + 1})
    out = mode("paillier", bench.run_paillier, keypair=keypair)
    check_bench("paillier", out, runs["paillier"][1],
                {"mont_mul": 2 + 4 * MODEXP_MULS})
    out = mode("model100m", bench.run_model100m)
    check_bench("model100m", out, runs["model100m"][1],
                {"mask double": 2 * (N_CLIENTS + 1)})
    out = mode("table2", bench.run_table2, keypair=keypair,
               sizes=BENCH_TABLE_SIZES)
    wrong = [r["algorithm"] for r in out["rows"] if r["correct"] is not True]
    # flashe, paillier+batch, paillier with its extrapolated rows,
    # bfv+batch and ckks+batch at each size; no-batch bfv and ckks at one
    if wrong or len(out["rows"]) != 5 * len(BENCH_TABLE_SIZES) + 2:
        raise AssertionError(f"table2: rows not correct {wrong} of "
                             f"{[r['algorithm'] for r in out['rows']]}")
    check_bench("table2", out, runs["table2"][1],
                table2_launches(out["rows"]))
    out = mode("roofline", bench.run_roofline, keypair=keypair)
    check_bench("roofline", out, runs["roofline"][1], {
        "int_chain": 1 + BENCH_REPS, "lds_chain": 1 + BENCH_REPS,
        "mask double": 2 * (1 + 50) + 50 + 1 + N_CLIENTS,
        "mont_mul": 1 + 4 * MODEXP_MULS})
    out = mode("multihost", bench.run_multihost)
    d = out["detail"]
    # children: each process's shards encrypt and decrypt once a round,
    # 2 checked rounds and 3 timed ones
    check_bench("multihost", out, runs["multihost"][1], {})
    want = {"mask double": d["processes"] * 5 * 2 * d["devices_per_process"]}
    if d["launches"] != want or d["card"] != smi:
        raise AssertionError(f"multihost: {d}, expected launches {want}")
    runs["multihost"] = (out, d["launches"], runs["multihost"][2])
    out = mode("party", bench.run_party, devices=[dev] * BENCH_PARTY_DEVICES,
               keypair=keypair)
    wrong = [(k, r["shards"]) for k, rows in out["rows"].items() for r in rows
             if r["correct"] is not True]
    if wrong or out["detail"]["shard_counts"] != [1, 2]:
        raise AssertionError(f"party: rows not correct {wrong}, shard "
                             f"counts {out['detail']['shard_counts']}")
    rows = 256 * BENCH_PARTY_DEVICES
    check_bench("party", out, runs["party"][1], {
        # a FLASHE encrypt: one launch a shard, 4 calls a shard count
        "mask double": 4 * (1 + 2),
        # Paillier: the first encrypt, then 4 encrypts and 4 decrypts a
        # shard count, each fanned chunk one modexp and one mont_exp_rows
        "mont_mul": PAILLIER_ENC_MULS * (1 + 4 * (1 + 2)),
        "mont_exp_rows": 4 * (1 + 2)})
    if rows // 2 < 8:
        raise AssertionError("party: a fanned Paillier chunk under 8 rows")
    for name, (r, _, _) in runs.items():
        if r["detail"]["card"] != smi:
            raise AssertionError(f"bench {name}: card {r['detail']['card']}")
    secs = time.perf_counter() - t_phase
    return runs, secs


# ---------------------------------------------------------------------------
# phase 18: the native layer (csrc/packing.cpp, csrc/fedbroker.cpp), host code
# ---------------------------------------------------------------------------

NATIVE_REPS = 5  # the packers' times: the median of 5 calls
EXCHANGE_REPEATS = 3  # the brokers alternate, native first


def median_s(fn, reps=NATIVE_REPS):
    """fn's last result and the median seconds of `reps` calls (host
    clock)."""
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t0)
    return out, statistics.median(secs)


def native_pack_shapes(dev):
    """The wire's arrays on the slice's paths, from the seed: ten clients'
    path-S locations (each a top-10% by layer of FemnistCNN's 1,206,590
    lanes, 120,655 locations of 21 bits), one 20-bit upload of 1,206,590
    lanes and one path-B upload (201,099 lanes x 4 limbs at 120 bits).
    Returns {name: (the arrays, int_bits)}."""
    codec = WeightsCodec(FemnistCNN(device=dev).params_to_flax(), device=dev)
    gen = torch.Generator(dev).manual_seed(SEED + 18)
    locs = []
    for _ in range(N_CLIENTS):
        res = Sparsifier(codec, SPARSITY).sparsify(
            torch.randn(codec.total, generator=gen, device=dev))
        locs.append(res.locations.cpu().numpy().astype(np.uint32))
    if {len(v) for v in locs} != {N_COMPACT}:
        raise AssertionError(f"phase 18: location counts "
                             f"{sorted({len(v) for v in locs})}")
    rng = np.random.default_rng(SEED + 18)
    upload = rng.integers(0, 1 << INT_BITS, N_FEMNIST, dtype=np.uint32)
    limbs = rng.integers(0, 1 << 32, (B_LANES, lanes.nlimbs_for(B_BITS)),
                         dtype=np.uint32)
    limbs[:, -1] &= np.uint32((1 << (B_BITS - 96)) - 1)
    return {"path-S locations x 10": (locs, N_FEMNIST.bit_length()),
            "20-bit upload": ([upload], INT_BITS),
            "path-B upload": ([limbs], B_BITS)}


def run_native_packing(dev):
    """(a) Each shape packed and unpacked by the native packer and by the
    numpy path: the bytes equal, the unpacked arrays the inputs; the
    median of NATIVE_REPS calls of each."""
    rows = {}
    for name, (arrays, bits) in native_pack_shapes(dev).items():
        nat, nat_s = median_s(lambda: [native.pack_lanes(a, bits)
                                       for a in arrays])
        ref, np_s = median_s(lambda: [packops.pack_lanes_np(a, bits)
                                      for a in arrays])
        if nat != ref:
            raise AssertionError(f"phase 18: {name}: the native packer's "
                                 "bytes differ from the numpy path's")
        back, nat_un_s = median_s(lambda: [
            native.unpack_lanes(d, a.shape[0], bits)
            for d, a in zip(nat, arrays)])
        ref_back, np_un_s = median_s(lambda: [
            packops.unpack_lanes_np(d, a.shape[0], bits)
            for d, a in zip(nat, arrays)])
        for a, b, c in zip(arrays, back, ref_back):
            if not (np.array_equal(a, b) and np.array_equal(a, c)):
                raise AssertionError(f"phase 18: {name}: unpack does not "
                                     "give the lanes back")
        rows[name] = {"arrays": len(arrays), "lanes": int(arrays[0].shape[0]),
                      "int_bits": bits,
                      "bytes": sum(len(d) for d in nat),
                      "pack_native_ms": nat_s * 1e3,
                      "pack_numpy_ms": np_s * 1e3,
                      "unpack_native_ms": nat_un_s * 1e3,
                      "unpack_numpy_ms": np_un_s * 1e3}
    return rows


def start_broker_cli(python):
    """`python -m flashe_tpu_torch broker --port 0` (with --python: the
    Python broker), a process of its own."""
    return subprocess.Popen(
        [sys.executable, "-m", "flashe_tpu_torch", "broker", "--host",
         "127.0.0.1", "--port", "0"] + (["--python"] if python else []),
        cwd=ROOT, stdout=subprocess.PIPE, text=True)


def exchange_once(feds, parties, aggs, tag):
    """The arbiter (the last of feds) sends receiver i its aggregate
    aggs[i]; each receiver waits in get() from before the first remote.
    Every receiver's array must equal what was sent.  Returns the seconds
    from the first remote to the last get's return."""
    arb, receivers = feds[-1], feds[:-1]
    names = [f"arbiter_to_{p.role}" for p in parties[:-1]]
    ends, bad = [None] * len(receivers), []
    ready = threading.Barrier(len(receivers) + 1)

    def receive(i):
        ready.wait()
        got = receivers[i].get(names[i], tag, parties[-1], timeout=60)
        ends[i] = time.perf_counter()
        if not np.array_equal(got, aggs[i]):
            bad.append(i)

    threads = [threading.Thread(target=receive, args=(i,), daemon=True)
               for i in range(len(receivers))]
    for t in threads:
        t.start()
    ready.wait()
    t0 = time.perf_counter()
    for i, p in enumerate(parties[:-1]):
        arb.remote(aggs[i], names[i], tag, p)
    for t in threads:
        t.join(timeout=120)
    if any(t.is_alive() for t in threads) or bad or None in ends:
        raise AssertionError(f"phase 18: exchange {tag}: receivers {bad} got "
                             "another array, or a get did not return")
    return max(ends) - t0


def run_native_exchange(procs):
    """(b) Through `broker --port 0` and `broker --python --port 0`
    (procs: start_broker_cli's, by kind), the arbiter sends ten FemnistCNN
    aggregates (1,206,590 int32 lanes each, 2 fragments) to ten receiving
    parties (one thread each in this process), the brokers in turns for
    EXCHANGE_REPEATS rounds after one warm-up round each.  Each broker is
    stopped with SIGTERM and must exit 0."""
    feds = {}
    try:
        ports = {}
        for kind, proc in procs.items():
            line = proc.stdout.readline().split()
            if len(line) != 3 or line[0] != "PORT" or line[2] != kind:
                raise AssertionError(f"phase 18: broker {kind}: printed "
                                     f"{line}")
            ports[kind] = int(line[1])
        parties = default_parties(N_CLIENTS - 1)
        auth = HomoTransferVariables.authorization()
        for kind, port in ports.items():
            feds[kind] = [TcpFederation(("127.0.0.1", port),
                                        f"phase18-{kind}", p, parties, auth)
                          for p in parties]
        rng = np.random.default_rng(SEED + 19)
        aggs = [rng.integers(-2**31, 2**31, N_FEMNIST, dtype=np.int32)
                for _ in range(N_CLIENTS)]
        for kind in procs:  # one untimed round: the connections' warm-up
            exchange_once(feds[kind], parties, aggs, "warm-up")
        secs = {kind: [] for kind in procs}
        for rep in range(EXCHANGE_REPEATS):
            for kind in procs:
                secs[kind].append(exchange_once(feds[kind], parties, aggs,
                                                f"rep{rep}"))
        frames = -(-len(pickle.dumps(aggs[0], pickle.HIGHEST_PROTOCOL))
                   // _FRAGMENT)
    finally:
        for fl in feds.values():
            for fed in fl:
                fed.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        rcs = {kind: proc.wait(timeout=30) for kind, proc in procs.items()}
    if rcs != {"native": 0, "python": 0}:
        raise AssertionError(f"phase 18: the brokers exited {rcs}")
    return {"seconds": secs, "median_ms": {
        k: statistics.median(v) * 1e3 for k, v in secs.items()},
        "fragments_per_aggregate": frames}


def run_native_phase(dev, smi):
    """Phase 18: (a) the packers, (b) the two brokers; no port fedbroker
    process is left after it."""
    t0 = time.perf_counter()
    packing = run_native_packing(dev)
    for name, r in packing.items():
        print(f"phase 18 (a): {name} ({r['arrays']} x {r['lanes']:,} lanes "
              f"of {r['int_bits']} bits, {r['bytes']:,} bytes): native bytes "
              f"== numpy bytes, unpack gives the lanes back; pack native "
              f"{r['pack_native_ms']:.3f} ms, numpy {r['pack_numpy_ms']:.3f} "
              f"ms; unpack native {r['unpack_native_ms']:.3f} ms, numpy "
              f"{r['unpack_numpy_ms']:.3f} ms (median of {NATIVE_REPS}, host "
              f"clock, {smi})")
    exchange = run_native_exchange({"native": start_broker_cli(False),
                                    "python": start_broker_cli(True)})
    check_no_brokers("phase 18")
    secs = time.perf_counter() - t0
    print(f"phase 18 (b): the arbiter to {N_CLIENTS} receivers, one "
          f"FemnistCNN aggregate each ({N_FEMNIST:,} int32 lanes, "
          f"{exchange['fragments_per_aggregate']} fragments), first remote "
          f"to last get: native broker median "
          f"{exchange['median_ms']['native']:.2f} ms, python broker "
          f"{exchange['median_ms']['python']:.2f} ms (samples " + ", ".join(
              f"{k} {[round(v * 1e3, 2) for v in vs]}"
              for k, vs in exchange["seconds"].items())
          + f"; brokers in turns, host clock, {smi}); every receiver's "
          f"array equal; both brokers exited 0 on SIGTERM, no port "
          f"fedbroker process left; phase 18 {secs:.2f} s")
    return {"packing": packing, "exchange": exchange, "seconds": secs,
            "card": smi}


# ---------------------------------------------------------------------------
# phase 19: the Shakespeare workload
# ---------------------------------------------------------------------------

# the reference's GRU define at full width (Embedding 83 -> 512, GRU 256,
# Dense 83): 654,675 = 6 x 109,112 + 3 lanes of 20 bits, so the mask
# kernel's last AES block carries 3 lanes; 9 clients (guest + 8 hosts) and
# the arbiter, batch 128, Adam at lr 0.01, the eval limit 512 (the
# experiment's defaults); 3 rounds and 2 reps of plain and flashe, arm
# order alternating; a seeded corpus of 512 rows a file in shakespeare_10's
# CSV format, of which each client trains on the first 256 (the
# experiment's --limit; 2 batches a round: at 512 rows the phase took
# 86 s, past its 60 s budget)
N_GRU = 654_675
SHAKE_CLIENTS, SHAKE_ROWS, SHAKE_ROUNDS, SHAKE_REPS = 9, 512, 3, 2
SHAKE_LIMIT = 256
SHAKE_BATCH, SHAKE_LR, SHAKE_EVAL = 128, 0.01, 512
SHAKE_RTOL = 1e-3  # flashe's federated loss against plain's, same rep
# (iter, add, minus) at the GRU's lanes: client 0's and client 8's
# encrypts, the 9 clients' boundary decrypt in iterations 0 and 2
SHAKE_MASK_CASES = ((0, 0, 1), (0, 8, 9), (0, 9, 0), (2, 9, 0))


def check_gru_masks(dev):
    """(b) The mask kernel against its plain version at N_GRU lanes, int
    bits 20, for SHAKE_MASK_CASES; returns the max abs error."""
    rk = round_keys(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 19)
    q = _rand_lanes(gen, dev, N_GRU, INT_BITS)
    err = 0
    for it, add, minus in SHAKE_MASK_CASES:
        err = max(err, _same(
            "mask kernel", fm.mask_apply(q, rk, it, add, minus, INT_BITS),
            fm.mask_apply_ref(q, rk, it, add, minus, INT_BITS),
            f"{N_GRU} lanes, iter {it}, streams ({add}, {minus})"))
    return err


def check_corpus(shards, eval_xy):
    """(a) Every shard and the eval set read back as (rows, 80) int32 with
    y shifted from x by one token, and the corpus pads with 0."""
    pads = 0
    for i, (x, y) in enumerate(shards + [eval_xy]):
        rows = SHAKE_EVAL if i == len(shards) else SHAKE_ROWS
        if (x.shape != (rows, shakespeare.SEQ_LEN) or y.shape != x.shape
                or x.dtype != np.int32 or y.dtype != np.int32
                or not np.array_equal(y[:, :-1], x[:, 1:])
                or x.max() >= shakespeare.VOCAB or x.min() < 0):
            raise AssertionError(f"phase 19: shard {i} reads back as "
                                 f"{x.shape} {x.dtype}, or y is not x "
                                 "shifted by one token")
        pads += int((y == 0).sum())
    if not pads:
        raise AssertionError("phase 19: the corpus has no pad targets")
    return pads


def check_experiment(out):
    """(c) The experiment's results: the parameter count on the card,
    finite losses, each arm's federated loss falling in every rep, flashe
    within SHAKE_RTOL of plain round by round in the same rep, and the
    mask launches each arm's code makes (flashe: 9 encrypts + 9 boundary
    pairs a round, all double; plain: none).  Returns the largest relative
    gap."""
    cfg = out["config"]
    if cfg["params"] != N_GRU or cfg["device"] != "cuda:0":
        raise AssertionError(f"phase 19: {cfg['params']} parameters on "
                             f"{cfg['device']}")
    per_run = {"plain": {},
               "flashe": {"mask double": 2 * SHAKE_CLIENTS * SHAKE_ROUNDS}}
    for name, rec in out["schemes"].items():
        losses = [rec["train_loss"], rec["eval_loss"], rec["eval_acc"]]
        losses += rec["fed_loss_reps"]
        if (len(rec["fed_loss_reps"]) != SHAKE_REPS
                or any(len(v) != SHAKE_ROUNDS for v in losses)
                or not all(math.isfinite(v) for vs in losses for v in vs)):
            raise AssertionError(f"phase 19: {name}: a loss is missing or "
                                 f"not finite: {losses}")
        for fed in rec["fed_loss_reps"]:
            if not fed[-1] < fed[0]:
                raise AssertionError(f"phase 19: {name}: the federated loss "
                                     f"does not fall: {fed}")
        if rec["launches_reps"] != [per_run[name]] * SHAKE_REPS:
            raise AssertionError(f"phase 19: {name}: launches "
                                 f"{rec['launches_reps']}, expected "
                                 f"{per_run[name]} a run")
    gap = max(abs(f - p) / abs(p) for pr, fr in zip(
        out["schemes"]["plain"]["fed_loss_reps"],
        out["schemes"]["flashe"]["fed_loss_reps"]) for p, f in zip(pr, fr))
    if gap > SHAKE_RTOL:
        raise AssertionError(f"phase 19: flashe's federated loss lies "
                             f"{gap:.3e} (relative) from plain's")
    return gap


def run_shakespeare_phase(dev, card, smi, tf32):
    """Phase 19: (a) a seeded corpus in shakespeare_10's format through
    data/shakespeare.py, (b) the mask kernel at the GRU's 654,675 lanes,
    (c) tools/shakespeare_experiment.py's runs of plain and flashe with the
    full-width GRU, 9 clients, with submit's TF32 settings."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shakespeare_") as tmp:
        shakespeare.write_markov_corpus(tmp, SHAKE_CLIENTS, SHAKE_ROWS,
                                        seed=SEED)
        eval_xy = shakespeare.load_eval(tmp, SHAKE_EVAL)
        pads = check_corpus(shakespeare.load_clients(tmp, SHAKE_CLIENTS),
                            eval_xy)
        shards = shakespeare.load_clients(tmp, SHAKE_CLIENTS, SHAKE_LIMIT)
        print(f"phase 19 (a): a seeded Markov corpus, {SHAKE_CLIENTS} shards "
              f"and b.csv of {SHAKE_ROWS} rows, read back through "
              f"data/shakespeare.py as ({SHAKE_ROWS}, {shakespeare.SEQ_LEN}) "
              f"int32, y = x shifted by one; {pads:,} pad targets")

        mask_err = check_gru_masks(dev)
        k, plain, calls = time_kernel(dev, N_GRU)
        bound, by = mask_bound(N_GRU, card)
        print(f"phase 19 (b): the mask kernel at {N_GRU:,} lanes (6 x "
              f"{N_GRU // 6:,} + {N_GRU % 6}), int_bits {INT_BITS}: equal to "
              f"its plain version lane for lane (max abs error {mask_err}) "
              f"for (iter, add, minus) in {list(SHAKE_MASK_CASES)}; "
              f"{k:.4f} ms a call over CUDA graphs of calls, bound "
              f"{bound:.4f} ms by {by}, share {bound / k:.3f}; {calls:.4f} "
              f"ms over runs of host calls; plain torch {plain:.4f} ms "
              f"({smi})")

        define = se.gru_define(512, 256)
        reset_launches()
        before = launch_counts()
        with submit_tf32(tf32):
            out = se.run_experiment(
                shards, eval_xy, define, SHAKE_ROUNDS, ("plain", "flashe"),
                SHAKE_REPS, SHAKE_LR, SHAKE_BATCH, device=dev,
                corpus="a seeded Markov corpus in shakespeare_10's format")
        launched = launches_since(before)
        gap = check_experiment(out)
        want = {"mask double": SHAKE_REPS * 2 * SHAKE_CLIENTS * SHAKE_ROUNDS}
        if launched != want or fm.mode_launches["double"] != want[
                "mask double"]:
            raise AssertionError(f"phase 19: the experiment launched "
                                 f"{launched}, expected {want}")
        se.write_docs(out, os.path.join(tmp, "CONVERGENCE_TORCH.md"))
    pl, fl = out["schemes"]["plain"], out["schemes"]["flashe"]
    share = {name: statistics.mean(t / r for t, r in zip(
        rec["train_s"][1:], rec["round_s"][1:])) for name, rec in (
            ("plain", pl), ("flashe", fl))}
    secs = time.perf_counter() - t0
    summary = {
        "params": out["config"]["params"], "clients": SHAKE_CLIENTS,
        "rows_a_shard": SHAKE_LIMIT, "rounds": SHAKE_ROUNDS,
        "reps": SHAKE_REPS, "card": smi,
        "mean_round_s": {"plain": statistics.mean(pl["mean_round_s_reps"]),
                         "flashe": statistics.mean(fl["mean_round_s_reps"])},
        "round_s_reps": {"plain": pl["round_s_reps"],
                         "flashe": fl["round_s_reps"]},
        "local_train_share_rep0": share,
        "fed_loss_reps": {"plain": pl["fed_loss_reps"],
                          "flashe": fl["fed_loss_reps"]},
        "eval_loss_rep0": {"plain": pl["eval_loss"],
                           "flashe": fl["eval_loss"]},
        "max_rel_gap": gap,
        **{k: out[k] for k in ("flashe_overhead_pct", "flashe_overhead_ci",
                               "flashe_overhead_n_pairs",
                               "flashe_overhead_reps")},
        "launches": launched,
        "mask": {"lanes": N_GRU, "max_abs_err": mask_err, "ms": k,
                 "host_calls_ms": calls, "plain_ms": plain,
                 "bound_ms": bound, "bound_by": by},
        "seconds": secs}
    print(f"phase 19 (c): tools/shakespeare_experiment.run_experiment, GRU "
          f"(512, 256) with {N_GRU:,} parameters, {SHAKE_CLIENTS} clients + "
          f"arbiter on the card, {SHAKE_LIMIT} rows a client, batch "
          f"{SHAKE_BATCH}, Adam lr {SHAKE_LR}, "
          f"{SHAKE_ROUNDS} rounds x {SHAKE_REPS} reps of plain and flashe: "
          f"every loss finite, each arm's federated loss falling in every "
          f"rep (plain {pl['fed_loss_reps']}, flashe {fl['fed_loss_reps']}), "
          f"flashe within {gap:.3e} (relative, largest gap; limit "
          f"{SHAKE_RTOL}) of plain round by round; launches {launched} "
          f"(flashe: {SHAKE_CLIENTS} encrypts + {SHAKE_CLIENTS} boundary "
          f"pairs a round, plain none); steady round plain "
          f"{summary['mean_round_s']['plain']:.4f} s, flashe "
          f"{summary['mean_round_s']['flashe']:.4f} s (host clock to a "
          f"synchronize, rounds 1-{SHAKE_ROUNDS - 1}), overhead median "
          f"{out['flashe_overhead_pct']}% [{out['flashe_overhead_ci'][0]}%, "
          f"{out['flashe_overhead_ci'][1]}%] 95% CI over "
          f"{out['flashe_overhead_n_pairs']} round pairs (reps "
          f"{out['flashe_overhead_reps']}); local training "
          f"{share['plain']:.3f} / {share['flashe']:.3f} of the guest's "
          f"round; the port's precompute is a no-op, so the flashe arm "
          f"encrypts in the round ({smi}); phase 19 {secs:.2f} s")
    print(json.dumps({"shakespeare": summary}))
    return summary


# phase 20: the trainer's steps as CUDA graphs
# ---------------------------------------------------------------------------

# the GRU at the benchmark's shakespeare_gru cell's widths (embed 512,
# hidden 256, 83 tokens, sequence 80, batch 128 of 256 rows a client, Adam
# lr 0.01, pad label 0); its FLASHE job as the cell runs it, for 3 rounds
GRAPH_ROWS, GRAPH_BATCH, GRAPH_ROUNDS, GRAPH_CLIENTS = 256, 128, 3, 9
GRAPH_LR = 0.01
# a client's steps in 3 rounds of 2 training batches and 1 evaluation
# batch: each mode's first step eager, every later one a replay
GRAPH_COUNTS = {"train": (1, 5), "eval": (1, 2)}  # (eager, graph)


def _token_rows(seed, rows=GRAPH_ROWS):
    """(x, y) of `rows` seeded token rows, y the next token, pads (0)
    among them."""
    seq = np.random.default_rng(seed).integers(
        0, shakespeare.VOCAB, (rows, shakespeare.SEQ_LEN + 1)).astype(
            np.int32)
    return seq[:, :-1], seq[:, 1:]


def _step_counts(records):
    """{mode: (eager, graph)} of the steps counted on the records named
    "local train" (train) and "evaluate" (eval)."""
    out = {}
    for mode, name in (("train", "local train"), ("eval", "evaluate")):
        got = [r.counts or {} for r in records if r.name == name]
        out[mode] = (sum(c.get("eager_steps", 0) for c in got),
                     sum(c.get("graph_steps", 0) for c in got))
    return out


def _graph_trainer(dev, x, seed, eager):
    model = KerasDefineModel(se.gru_define(512, 256), device=dev)
    init_params(model, x[:1], seed=0)
    t = LocalTrainer(model, optimizer="adam", learning_rate=GRAPH_LR,
                     seed=seed, label_pad_id=0, device=dev)
    if eager:
        t._replayable = lambda drew: False
    return t


def _graph_rounds(t, x, y, w0, name):
    """GRAPH_ROUNDS rounds of train, install (half way back to w0) and
    evaluate in this thread, each phase inside its record; returns the
    losses, the final state and the step counts."""
    set_tracker(Tracker(name))
    losses = []
    for _ in range(GRAPH_ROUNDS):
        with span("local train"):
            loss = t.train(x, y, batch_size=GRAPH_BATCH)
        t.set_model_weights({k: v * 0.5 + w0[k] * 0.5
                             for k, v in t.params.items()})
        with span("evaluate"):
            losses.append((loss, t.evaluate(x, y)))
    state = t.optimizer.state
    tensors = {"params": t.params}
    for key in ("mu", "nu"):
        tensors[key] = t.model.flax_view(
            {n: state[p][key] for n, p in t.model.named_parameters()})
    return {"losses": losses, "tensors": tensors,
            "count": {s["count"] for s in state.values()},
            "steps": _step_counts(tracker().read())}


def _threads(fns):
    """Run each fn in a thread of its own; their results in order."""
    with concurrent.futures.ThreadPoolExecutor(len(fns)) as pool:
        return [f.result() for f in [pool.submit(fn) for fn in fns]]


def _differing(a, b) -> int:
    """How many parameters and moments of two _graph_rounds differ."""
    return sum(int((v != b["tensors"][kind][k]).sum())
               for kind, tree in a["tensors"].items()
               for k, v in tree.items())


def check_graphs_equal_eager(dev):
    """(a) Two clients in threads with graphs, two with eager steps, from
    the same weights and rows, under torch's deterministic algorithms:
    every loss, parameter and moment equal bit for bit after GRAPH_ROUNDS
    rounds; the graph clients' steps counted as GRAPH_COUNTS says.  Under
    the default algorithms an eager client against another (not asserted:
    a kernel of the GRU's backward sums in an order that varies from run
    to run).  Then one client's round of 2 steps timed, graph against
    eager."""
    rows = [_token_rows(SEED + 20 + i) for i in range(2)]
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for eager in (False, True):
                ts = [_graph_trainer(dev, x, 7 + i, eager)
                      for i, (x, _) in enumerate(rows)]
                w0 = ts[0].params
                runs[eager] = _threads([
                    functools.partial(_graph_rounds, t, x, y, w0,
                                      f"phase20_{eager}_{i}")
                    for i, (t, (x, y)) in enumerate(zip(ts, rows))])
    finally:
        torch.use_deterministic_algorithms(False)
    nondeterministic = sorted({str(w.message)[:120] for w in caught
                               if "deterministic" in str(w.message)})
    x, y = rows[0]
    free = [_graph_rounds(_graph_trainer(dev, x, 7, True), x, y, w0,
                          f"phase20_free_{i}") for i in range(2)]
    for i, (g, e) in enumerate(zip(runs[False], runs[True])):
        if g["losses"] != e["losses"] or not (
                g["count"] == e["count"] == {2 * GRAPH_ROUNDS}):
            raise AssertionError(f"phase 20 (a): client {i}: graph losses "
                                 f"{g['losses']} count {g['count']}, eager "
                                 f"{e['losses']} count {e['count']}")
        for kind, tree in g["tensors"].items():
            for k, v in tree.items():
                if not torch.equal(v, e["tensors"][kind][k]):
                    raise AssertionError(f"phase 20 (a): client {i}: {kind} "
                                         f"{k} differs, graph against eager")
        if g["steps"] != GRAPH_COUNTS or e["steps"] != {
                m: (a + b, 0) for m, (a, b) in GRAPH_COUNTS.items()}:
            raise AssertionError(f"phase 20 (a): client {i}: steps "
                                 f"{g['steps']} (graphs), {e['steps']} "
                                 "(eager)")
    times = {}
    for eager in (False, True):
        x, y = rows[0]
        t = _graph_trainer(dev, x, 7, eager)
        for _ in range(2):
            t.train(x, y, batch_size=GRAPH_BATCH)

        def one_round():
            t.train(x, y, batch_size=GRAPH_BATCH)
            torch.cuda.synchronize()

        times["eager" if eager else "graph"] = _median_ms(one_round, 5)
    return (runs[False][0]["losses"], times, _differing(*free),
            nondeterministic)


def _gru_param(rounds=GRAPH_ROUNDS):
    """The shakespeare_gru cell's HomoNNParam, `rounds` rounds."""
    return HomoNNParam.from_dict({
        "model": "nn_define",
        "model_kwargs": {"nn_define": se.gru_define(512, 256)},
        "secure_aggregate": "flashe",
        "secure_aggregate_args": {
            "quantize": {"int_bits": INT_BITS, "batch": False,
                         "element_bits": ELEMENT_BITS, "padding": True,
                         "secure": True},
            "precompute": {"enable": True}, "mode": "parallel",
            "num_partitions": 1},
        "optimizer": "adam", "learning_rate": GRAPH_LR,
        "max_iter": rounds, "batch_size": GRAPH_BATCH, "label_pad_id": 0})


def run_graph_job(dev):
    """(b) The shakespeare_gru cell's FLASHE job on a seeded Markov corpus
    (phase 19's), 9 clients and the arbiter through run_roles for
    GRAPH_ROUNDS rounds, each client building its model in its thread:
    every client's steps as GRAPH_COUNTS says, its Adam count 2 a round,
    finite falling losses."""
    param = _gru_param()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graphs_") as tmp:
        shakespeare.write_markov_corpus(tmp, GRAPH_CLIENTS, GRAPH_ROWS,
                                        seed=SEED + 20)
        shards = shakespeare.load_clients(tmp, GRAPH_CLIENTS, GRAPH_ROWS)
    clients = {}

    def client(cls, i, trv):
        c = clients[i] = cls(param, seed=i, device=dev)
        c.fit(trv, *shards[i])
        return [h["loss"] for h in c.history]

    t0 = time.perf_counter()
    results = run_roles(
        GRAPH_CLIENTS - 1, functools.partial(client, HomoNNGuest, 0),
        lambda trv, h: client(HomoNNHost, 1 + h, trv),
        HomoNNArbiter(param, device=dev).fit, timeout=600.0)
    secs = time.perf_counter() - t0
    found = tracking.latest()
    steps = {}
    for i in range(GRAPH_CLIENTS):
        name = "guest" if i == 0 else f"host{i - 1}"
        steps[name] = _step_counts(found[name].read())
        counts = {s["count"] for s in
                  clients[i].trainer.optimizer.state.values()}
        if steps[name] != GRAPH_COUNTS or counts != {2 * GRAPH_ROUNDS}:
            raise AssertionError(f"phase 20 (b): {name}: steps "
                                 f"{steps[name]}, Adam counts {counts}")
    fed = results["arbiter"]
    if not (all(math.isfinite(v) for v in fed) and fed[-1] < fed[0]):
        raise AssertionError(f"phase 20 (b): federated losses {fed}")
    return fed, steps, secs


def check_cnn_steps(dev):
    """(c) FemnistCNN: its training steps draw dropout and stay eager, its
    evaluation replays: 2 rounds of 2 steps and 1 evaluation batch."""
    set_tracker(Tracker("phase20_cnn"))
    model = FemnistCNN(device=dev)
    gen = np.random.default_rng(SEED + 21)
    x = gen.standard_normal((256, 28, 28, 1)).astype(np.float32)
    y = gen.integers(0, 62, 256).astype(np.int32)
    init_params(model, x[:1], seed=0)
    t = LocalTrainer(model, device=dev)
    for _ in range(2):
        with span("local train"):
            t.train(x, y, batch_size=128)
        with span("evaluate"):
            t.evaluate(x, y)
    steps = _step_counts(tracker().read())
    if steps != {"train": (4, 0), "eval": (1, 1)}:
        raise AssertionError(f"phase 20 (c): FemnistCNN's steps {steps}")
    return steps


def check_draws_beside_captures(dev):
    """(d) Another thread builds clients' models (their layers draw from
    the card's default generator, which a capture holds), and a third
    trains FemnistCNN, whose steps stay eager (dropout) and take no lock,
    while a client's steps are captured: none raises, and the eager
    client's steps after its first count as eager."""
    x, y = _token_rows(SEED + 22)
    t = _graph_trainer(dev, x, 3, False)
    param = _gru_param()
    done = threading.Event()
    gen = np.random.default_rng(SEED + 23)
    cx = gen.standard_normal((128, 28, 28, 1)).astype(np.float32)
    cy = gen.integers(0, 62, 128).astype(np.int32)
    cnn = LocalTrainer(FemnistCNN(device=dev), device=dev)
    init_params(cnn.model, cx[:1], seed=0)
    cnn.train(cx, cy, batch_size=128)  # its one warm-up, before the captures

    def draw():
        n = 0
        while not done.is_set():
            HomoNNHost(param, seed=n, device=dev)._build(x[:1])
            n += 1
        return n

    def eager():
        set_tracker(Tracker("phase20_eager"))
        while True:
            with span("local train"):
                loss = cnn.train(cx, cy, batch_size=128)
            if not math.isfinite(loss):
                raise AssertionError(f"phase 20 (d): FemnistCNN loss {loss}")
            if done.is_set():
                break
        return _step_counts(tracker().read())["train"]

    def train():
        try:
            set_tracker(Tracker("phase20_draws"))
            for _ in range(2):
                with span("local train"):
                    t.train(x, y, batch_size=GRAPH_BATCH)
                with span("evaluate"):
                    t.evaluate(x, y)
            return _step_counts(tracker().read())
        finally:
            done.set()

    draws, eager_steps, steps = _threads([draw, eager, train])
    if steps != {"train": (1, 3), "eval": (1, 1)}:
        raise AssertionError(f"phase 20 (d): steps {steps}")
    if eager_steps[1] or not eager_steps[0]:
        raise AssertionError(f"phase 20 (d): FemnistCNN's steps (eager, "
                             f"graph) {eager_steps}")
    return draws, eager_steps[0]


def run_graph_phase(dev, smi):
    """Phase 20: the trainer's steps as CUDA graphs at the GRU cell's
    widths: (a) replays equal to eager steps bit for bit, (b) the cell's
    job with 9 concurrent clients, (c) FemnistCNN's dropout kept eager,
    (d) the default generator drawn beside captures."""
    t0 = time.perf_counter()
    losses, times, free, warned = check_graphs_equal_eager(dev)
    print(f"phase 20 (a): the GRU (512, 256) trained {GRAPH_ROUNDS} rounds "
          f"of {GRAPH_ROWS // GRAPH_BATCH} steps of {GRAPH_BATCH} x "
          f"{shakespeare.SEQ_LEN}, installed and evaluated by 2 clients in "
          f"threads with CUDA graphs and by 2 with eager steps, under "
          f"torch's deterministic algorithms (warnings {warned}): losses, "
          f"parameters, Adam's mu and nu and counts equal bit for bit "
          f"(client 0: {losses}); steps {GRAPH_COUNTS} (eager, graph); "
          f"under the default algorithms two eager clients end {free:,} "
          f"values apart; a round of 2 steps alone {times['graph']:.2f} ms "
          f"replayed, {times['eager']:.2f} ms eager (median of 5, host "
          f"clock to a synchronize; {smi})")
    fed, steps, secs = run_graph_job(dev)
    print(f"phase 20 (b): the GRU's FLASHE job, {GRAPH_CLIENTS} clients "
          f"and the arbiter through run_roles, {GRAPH_ROUNDS} rounds in "
          f"{secs:.2f} s with the models' build: no capture error, every "
          f"client's steps (eager, graph) {steps['guest']}, federated "
          f"losses {fed}")
    cnn = check_cnn_steps(dev)
    draws, eager = check_draws_beside_captures(dev)
    secs = time.perf_counter() - t0
    print(f"phase 20 (c): FemnistCNN's steps (eager, graph) {cnn}: its "
          f"dropout keeps training eager; (d) {draws} GRU models built on "
          f"the card in one thread and {eager} eager FemnistCNN training "
          f"steps in another during a client's captures; phase 20 "
          f"{secs:.2f} s")
    return {"losses": losses, "round_ms": times, "job_fed_loss": fed,
            "eager_values_apart": free, "deterministic_warnings": warned,
            "job_steps": steps, "cnn_steps": cnn, "draws": draws,
            "eager_beside_captures": eager, "seconds": secs}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def print_mask_sass():
    """The mask kernel's instructions by opcode, each instance (streams,
    limbs, scatter), where cuobjdump is at hand.  The span loop's body is
    straight-line code, one or two AES-256 blocks a thread, so the table
    loads and the integer operations of an instance are, to within its
    prologue and the lane loop, those of one counter block."""
    sass = _build.sass_opcodes("flashe_mask") or {}
    names = sorted(k for k in sass if k.startswith("flashe_mask_kernel"))
    if not names:
        print("sass flashe_mask.cu: no cuobjdump, not counted")
        return
    for name in names:
        ops = sass[name]
        integer = sum(n for op, n in ops.items()
                      if op in roofline.INTEGER_OPCODES)
        print(f"sass flashe_mask.cu: {name}: {sum(ops.values())} "
              f"instructions, {ops['LDS']} LDS, {integer} integer ("
              + ", ".join(f"{op} {n}" for op, n in ops.most_common(12))
              + ")")


def build_kernels():
    """Every kernel source, one nvcc each, in parallel; prints ptxas's
    registers and spills of every kernel instance."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        list(ex.map(_build.load, KERNEL_SOURCES))
    print(f"kernel build ({len(KERNEL_SOURCES)} x nvcc in parallel, sm_90a) "
          f"and load: {time.perf_counter() - t0:.2f} s")
    for src in KERNEL_SOURCES:
        for kern, regs, st, ld in _build.ptxas_usage(_build.build_log(src)):
            print(f"ptxas {src}.cu: {kern}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B")
    print_mask_sass()


_T0 = time.perf_counter()


def stamp(label: str):
    """The script's seconds so far, after `label`."""
    print(f"[{time.perf_counter() - _T0:.1f} s] {label} done", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", action="store_true", help=(
        "build the kernels and time the mask kernel and the Montgomery "
        "kernels at their paths' shapes (phase 9) only, with no other phase "
        "and no result line; in a copy of the tree with another "
        "csrc/flashe_mask.cu or csrc/montgomery.cu, this times that source "
        "against the same bounds"))
    ap.add_argument("--tcp-role", choices=("guest", "host", "arbiter"),
                    help="run one party of the TCP round (started by the "
                    "script itself)")
    ap.add_argument("--broker", help="the TCP round's broker, host:port")
    ap.add_argument("--workdir", help="the TCP round's exchange directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs on "
              "the card only", file=sys.stderr)
        return 2
    if args.tcp_role:
        return tcp_child(args.tcp_role, args.broker, args.workdir)
    # torch's TF32 settings, which phase 10 trains with as submit does;
    # every other phase runs in full float32
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    card = roofline.card()
    print(f"bounds from: {card.describe()}")

    build_kernels()
    stamp("phase 1 (build)")
    if args.times:
        time_mask(dev, card, MASK_SMALL_COUNTS + (N_COMPACT, N_FEMNIST,
                                                  4_194_304))
        if has_modes():
            time_modes(dev, card)
        else:
            print("this flashe_mask.cu has no flashe_mask_apply_modes: its "
                  "other modes are not timed")
        time_paths(dev, PaillierKeypair.generate_keypair(2048), card)
        return 0

    max_err = check_kernel_grid(dev)
    mode_err = check_modes_grid(dev)
    stamp("phases 2-3 (the mask kernel's grids)")

    torch.manual_seed(SEED)
    model = FemnistCNN(device=dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != N_FEMNIST:
        raise AssertionError(f"FemnistCNN has {n_params} parameters")

    first, path_b = None, []
    for it, survivors in ((0, list(range(N_CLIENTS))),
                          (1, list(range(N_CLIENTS - 1)))):
        for bits, batch, mode in ((INT_BITS, False, "double"),
                                  (B_BITS, True, "limbs")):
            launches, secs, r = run_round(dev, model, survivors, it, bits,
                                          batch)
            # one launch per encrypt, one per decrypt boundary pair
            n = N_CLIENTS + len(merge_idx_runs(survivors)[0])
            want = dict.fromkeys(fm.MODES, 0)
            want[mode] = n
            if launches != want:
                raise AssertionError(f"round {it} int_bits {bits}: kernel "
                                     f"launches {launches}, expected {want}")
            worst = check_round(dev, survivors, it, r, bits, batch)
            print(f"{'path B, batched ' if batch else ''}round iter={it} "
                  f"survivors={len(survivors)}/{N_CLIENTS}: "
                  f"{r['agg'].shape[0]} lanes of {bits} bits, kernel "
                  f"launches {n} (= {N_CLIENTS} encrypts + {n - N_CLIENTS} "
                  f"decrypt, mode {mode}), decrypted == sum(q) mod "
                  f"2^{bits}, new model within {worst:.3f} steps of the "
                  f"clients' mean, first-run host time {secs * 1e3:.1f} ms")
            if batch:
                path_b.append(n)
            else:
                first = first or (n, r)

    # the sparse paths: S (dynamic masking, which chooses the single mask)
    # over five iterations, D (the double mask) with client 9 dropped in
    # its second round
    everyone, dropout = list(range(N_CLIENTS)), list(range(N_CLIENTS - 1))
    path_s = run_sparse_path(dev, model, "S", "dynamic",
                             [(it, everyone) for it in range(5)])
    path_d = run_sparse_path(dev, model, "D", "double",
                             [(0, everyone), (1, dropout)])
    phases = {k: statistics.median(secs[k] for _, secs, _ in path_s[1:]) * 1e3
              for k in path_s[0][1]}
    print("path S round by phase (medians of iterations 1-4, host clock, a "
          "synchronize after each phase): " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in phases.items())
          + f"; the round {sum(phases.values()):.1f} ms")
    stamp("phases 4-5 (the rounds)")

    # the full round's new global model runs: finite logits that agree
    # with the same model on the CPU
    main_launches, r = first
    new_params = r["codec"].unflatten(r["new"])
    cnn = FemnistCNN(device=dev).eval()
    cnn.params_from_flax(new_params)
    cpu = FemnistCNN(device="cpu").eval()
    cpu.params_from_flax({k: v.cpu() for k, v in new_params.items()})
    x = torch.randn(4, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits = cnn(x.to(dev))
        ref = cpu(x)
    if logits.shape != (4, 62) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("logits of the new model are not finite")
    dlog = float((logits.cpu() - ref).abs().max())
    if dlog > 1e-4:
        raise AssertionError(f"card logits differ from the CPU's by {dlog}")
    print(f"new global FemnistCNN forward: (4, 62) finite logits, "
          f"max |card - cpu| = {dlog:.2e}")
    # the layer statistics that set every client's clip thresholds: the
    # same bits on every call on the card, and within float32 rounding of
    # the same statistics in float64
    codec = r["codec"]
    stats = [codec.layer_mean_std(r["new"]) for _ in range(3)]
    for got in stats[1:]:
        if not all(torch.equal(a, b) for a, b in zip(got, stats[0])):
            raise AssertionError("layer_mean_std differs between two calls "
                                 "on the card")
    x = r["new"].double().cpu()
    ref = [(p.mean(), p.std(unbiased=False))
           for p in x.split(codec.sizes)]
    for k, (m, sd) in enumerate(ref):
        gm, gs = float(stats[0][0][k]), float(stats[0][1][k])
        if abs(gm - float(m)) > 1e-6 or abs(gs - float(sd)) > 1e-4 * float(sd):
            raise AssertionError(f"layer {k}: layer_mean_std on the card "
                                 f"({gm}, {gs}) is off the float64 "
                                 f"statistics ({float(m)}, {float(sd)})")
    print("layer_mean_std on the card: the same bits in 3 calls, within "
          "1e-6 (means) and rtol 1e-4 (stds) of the float64 statistics")

    # timings: the kernel against its plain version, the 10-ciphertext sum,
    # bench.py's metric n / (one encrypt + the sum + the decrypt), and the
    # whole round
    times = time_mask(dev, card, (N_FEMNIST, 4_194_304, N_COMPACT))
    mode_times = time_modes(dev, card)
    for count, (_, _, k) in list(times.items())[:2]:
        cts = [lanes.to_i32(torch.randint(0, 1 << 32, (count,), device=dev,
                                          dtype=torch.int64))
               for _ in range(N_CLIENTS)]
        arbiter_reduce(cts, INT_BITS)
        agg = statistics.median(event_ms(
            lambda: arbiter_reduce(cts, INT_BITS), 20))
        print(f"{count} lanes, int_bits {INT_BITS}: {N_CLIENTS}-ciphertext "
              f"sum {agg:.4f} ms (median of calls; CUDA events); enc + agg + "
              f"dec, the kernel as the host calls it, "
              f"{count / ((2 * k + agg) / 1e3):.1f} elements/s")
    round_ms = []
    for rep in range(5):
        _, secs, _ = run_round(dev, model, list(range(N_CLIENTS)), 2 + rep)
        round_ms.append(secs * 1e3)
    print(f"full round ({N_CLIENTS} x normalize+quantize+encrypt, sum, "
          f"decrypt+decode, {N_FEMNIST} lanes): median "
          f"{statistics.median(round_ms):.2f} ms, samples "
          f"{[round(v, 2) for v in round_ms]} (host clock to synchronize)")
    phases = time_round_phases(dev, model)
    print("full round by phase (medians of 7 rounds, host clock, a "
          "synchronize around each phase): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in phases.items()))
    stamp("phase 9 (the mask kernel's times)")

    # the Paillier path: its kernels on their grids, then the round
    t0 = time.perf_counter()
    keypair = PaillierKeypair.generate_keypair(2048)
    print(f"Paillier 2048-bit keypair generated in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    mont_err = check_montgomery_grid(dev)
    mont_err["mont_exp_rows"] = check_exp_grid(dev, keypair)

    pl_launches, r = run_paillier_round(dev, model, keypair)
    worst, per_encrypt = check_paillier_round(dev, keypair, pl_launches, r)
    t = r["times"]
    enc = [rec["encrypt_s"] for rec in r["recs"]]
    print(f"Paillier round, {N_CLIENTS} clients x {N_CTS} ciphertexts "
          f"(int_bits {PAILLIER_BITS}, 100 fields a lane), 2048-bit key: "
          f"decrypted sums == sum of packed q, unpacked fields == "
          f"per-element sum of q, new model within {worst:.3f} steps of the "
          f"clients' mean; launches {pl_launches} (= {N_CLIENTS} x "
          f"{per_encrypt} + {2 * N_CLIENTS} mont_mul, one mont_exp_rows)")
    print(f"Paillier round phases (host clock, first run): "
          f"normalize+quantize+pack {sum(t['upload_s']) - sum(enc):.3f} s, "
          f"encrypt {sum(enc):.3f} s (per client "
          f"{[round(v, 3) for v in enc]}), sum {t['sum_s']:.3f} s, "
          f"decrypt+decode {t['download_s']:.3f} s, total "
          f"{sum(t['upload_s']) + t['sum_s'] + t['download_s']:.3f} s")
    small_launches = check_small_decrypt(dev, keypair, r)
    print(f"5-row decrypt: launches {small_launches} (single per-row-modulus"
          f" products), equal to the full decrypt's first 5")
    stamp("phases 6-7 (Montgomery, the Paillier round)")

    # the federated rounds: the roles of protocol/aggregator.py over the
    # in-memory federation (one thread each) and over TCP (one process each)
    fed_launches, fed_s, r = run_fed_dense(dev, model)
    fed_worst = check_fed_dense(fed_launches, r)
    print(f"federated FLASHE rounds in memory (cnn_flashe_q16_b1_pad.json, "
          f"guest + {N_CLIENTS - 1} hosts + arbiter, one thread each, uuid + "
          f"DH + seed wrap): {FED_ROUNDS} rounds in {fed_s:.2f} s; client "
          f"{N_CLIENTS - 1} asleep past the {FED_TIMEOUT_S} s deadline in "
          f"round 1, dropped, notified with the aggregate, back in round 2; "
          f"every client decrypted == the survivors' sum(q) mod 2^{INT_BITS}"
          f" and holds the same model, within "
          f"{[round(w, 3) for w in fed_worst]} steps of the survivors' "
          f"mean; launches {fed_launches} (= {FED_ROUNDS} x ({N_CLIENTS} "
          f"encrypts + {N_CLIENTS} clients x 1 boundary pair))")
    for rnd in range(FED_ROUNDS):
        guest, arb = r["recs"][0], r["arbiter"][rnd]
        print(f"federated round {rnd} by phase (host clock, a synchronize "
              f"at each phase's ends; the core round above: "
              f"{statistics.median(round_ms):.2f} ms): guest "
              f"{guest['round_ms'][rnd]:.2f} ms (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in guest["phases"][rnd].items())
              + f"); arbiter {arb['ms']:.2f} ms (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in arb["phases"].items())
              + "); clients' rounds " + str(
                  [round(rec["round_ms"][rnd], 1) for rec in r["recs"]]))
    sparse_fed_launches, sparse_worst, recs = run_fed_sparse(dev, model)
    print(f"federated sparse round in memory (cnn_flashe_s100_dyn.json, 10 "
          f"clients): choice single at every client, launches "
          f"{sparse_fed_launches} (= 10 single + 10 clients x 10 scatters), "
          f"every client decrypted == the densified sum(q) mod 2^{INT_BITS}"
          f" and holds the same model, within {sparse_worst:.3f} steps of "
          f"what the clients sent; guest {recs[0]['ms']:.1f} ms ("
          + ", ".join(f"{k} {v:.2f}" for k, v in recs[0]["phases"].items())
          + ")")
    pl_fed_launches, pl_fed_s, pl_worst, recs = run_fed_paillier(dev, model)
    print(f"federated Paillier round in memory (cnn_paillier_q16_b100_pad."
          f"json, {FED_PAILLIER_CLIENTS} clients at full width, 2048-bit key "
          f"generated by the guest and wrapped to the hosts): "
          f"{pl_fed_s:.2f} s with the session setup; every client's "
          f"decrypted sums == the sum of the packed q, same model within "
          f"{pl_worst:.3f} steps of the mean; launches {pl_fed_launches}; "
          f"guest " + ", ".join(f"{k} {v / 1e3:.3f} s"
                                for k, v in recs[0]["phases"].items()))
    tcp_s, tcp_worst, tcp, packed = run_tcp_round(dev, model)
    print(f"TCP round across processes (the native FedBroker on 127.0.0.1, "
          f"guest, host and arbiter each a process on cuda:0, wire_pack "
          f"through the native packer): {tcp_s:.2f} s "
          f"for the three, round {tcp['guest']['round_s'] * 1e3:.1f} ms at "
          f"the guest after a {tcp['guest']['setup_s']:.2f} s session setup;"
          f" decrypted == sum(q) mod 2^{INT_BITS} at both clients, same "
          f"model within {tcp_worst:.3f} steps of the mean; launches 2 "
          f"double at each client, 0 at the arbiter; the upload packed "
          f"{packed} bytes; TransferStat wire bytes: " + ", ".join(
              f"{role} {name} {row['sent_bytes']}"
              for role in ("guest", "host", "arbiter")
              for name, row in tcp[role]["stats"].items()
              if name != "__total__" and row["sent_bytes"] > 100_000))
    stamp("phase 8 (the federated rounds)")

    # federated training: the HomoNN roles through run_roles, as submit
    train_launches, in_process = run_training_phase(dev, tf32)
    stamp("phase 10 (training)")
    # the job runtime: the same configuration one process a party, predict,
    # a DSL job; the parent's predict runs with submit's TF32 settings; then
    # the job server and the cluster over the same stores
    with submit_tf32(tf32):
        runtime_launches = run_runtime_phase(dev, in_process, smi)
    stamp("phases 12-13 (the job runtime, the server, the cluster)")
    # the general-HE baselines, at full width and in training
    he_rows = run_he_phase(dev, model, card, tf32)
    stamp("phase 11 (general HE)")
    # the scheme comparison, a process of its own on the card; then the
    # table data plane on the host
    comparison, compare_s = run_comparison_phase(smi)
    stamp("phase 14 (the comparison)")
    cmp_launches = collections.Counter()
    for row in comparison["rows"]:
        cmp_launches.update(row["launches"])
    print(f"phase 14: python -m flashe_tpu_torch.tools.compare_schemes "
          f"(six rows at {N_FEMNIST:,} parameters): {compare_s:.2f} s; every "
          f"row correct, the wire MB a client as docs/COMPARISON.md, "
          f"launches {dict(cmp_launches)}")
    tables = run_data_plane_phase()
    stamp("phase 15 (the data plane)")
    print(f"phase 15: the table data plane: storage-node ran the "
          f"{tables['server']} server (csrc/kvserver.cpp), the local store "
          f"{tables['local_store']} (csrc/kvstore.cpp), jobs shipped with "
          f"{tables['pickler']}; upload_csv and to_dtable of {TABLE_ROWS} x "
          f"{TABLE_FEATURES} equal to the CSV's arrays; mapValues + reduce "
          f"through EXEC in egg processes {tables['eggs']} (their command "
          f"names flashe_tpu_torch.data.egg), features' sum within "
          f"{tables['features_err']:.2e}; EncryptModeCalculator (fast, "
          f"FloatPaillier {FACADE_KEY_BITS}-bit) over two rounds, decrypts "
          f"within {tables['facade_err']:.2e}; the native build "
          f"{tables['build_s']:.2f} s, the EXECs {tables['exec_s']:.2f} s, "
          f"the facade {tables['facade_s']:.2f} s, the phase "
          f"{tables['secs']:.2f} s (host clock)")

    # several devices on the card: the grid round, the sharded party, the
    # fan-out, processes over torch.distributed, the mesh party, the graft
    # twin
    multi = run_multi_gpu_phase(dev, keypair, tf32)
    stamp("phase 16 (several devices)")

    # the benchmark harness: its nine modes at their defaults
    bench_runs, bench_s = run_bench_phase(dev, keypair, smi)
    bench_launches = collections.Counter()
    for name, (r, got, secs) in bench_runs.items():
        bench_launches.update(got)
        print(f"phase 17: bench --mode {name}: {r['metric']} = {r['value']} "
              f"{r['unit']} (vs_baseline {r['vs_baseline']}), {secs:.2f} s, "
              f"launches {got}")
    print(f"phase 17: {bench_s:.2f} s; launches {dict(bench_launches)}")
    print(json.dumps({"bench": {name: r for name, (r, _, _)
                                in bench_runs.items()}}))
    harness_masks = check_harness_masks(dev)
    bench_mask_err = collections.Counter()
    for what, (n, err, mode) in harness_masks.items():
        bench_mask_err[mode] = max(bench_mask_err[mode], err)
        print(f"phase 17: the mask kernel at {what}'s shape, {n:,} lanes in "
              f"one launch ({mode}): lane for lane the plain version's (max "
              f"abs error {err})")
    ceil = time_ceiling(dev, card)
    for name, t in ceil.items():
        print(f"ceiling {name}: {t['ms']:.4f} ms a call at 8,388,608 "
              f"elements (CUDA events), bound {t['bound'][0]:.4f} ms by "
              f"{t['bound'][1]} ({t['per_element']} integer instructions "
              f"and loads an element), plain torch {t['plain_ms']:.4f} ms, "
              f"max |kernel - plain| {t['err']}")
    stamp("phase 17 (the benchmark harness)")

    # the native layer: the wire packer and the two brokers
    native_layer = run_native_phase(dev, smi)
    print(json.dumps({"native_layer": native_layer}))
    stamp("phase 18 (the native layer)")

    # the Shakespeare workload: its loader, the mask kernel at the GRU's
    # lanes, the experiment's plain and flashe arms at full width
    shake = run_shakespeare_phase(dev, card, smi, tf32)
    stamp("phase 19 (the Shakespeare workload)")

    # the trainer's steps as CUDA graphs: replays against eager steps, the
    # GRU cell's job with concurrent captures, dropout kept eager
    print(json.dumps({"graphs": run_graph_phase(dev, smi)}))
    stamp("phase 20 (the trainer's CUDA graphs)")

    def trained(key):
        return sum(launches[key] for launches in train_launches.values())

    paths = time_paths(dev, keypair, card)
    mont_times, rate = time_montgomery(dev, keypair)
    stamp("phase 9 (the Montgomery kernels' times)")
    # the 2,048-row plain time stands in for mont_exp_rows', whose plain
    # version would take hours at the decrypt's shape
    paths["mont_exp_rows"].update(
        plain_ms=mont_times["mont_exp_rows"][1],
        ms_at_plain_shape=mont_times["mont_exp_rows"][0],
        plain_shape="2 x 2,048 rows x 2048 bits, 64-bit exponents")

    # launches_per_round: the FLASHE round (mask) and the Paillier round
    mont_rows = [
        ("mont_mul", "flashe_tpu/ops/pallas_modmath.py:78", pl_launches,
         pl_launches["mont_mul"]),
        ("mont_mul_vec", "flashe_tpu/ops/pallas_modmath.py:171",
         small_launches, pl_launches["mont_mul_vec"]),
        ("mont_exp_rows", "flashe_tpu/ops/pallas_modmath.py:317",
         pl_launches, pl_launches["mont_exp_rows"])]
    mbound, mby = mask_bound(N_FEMNIST, card)
    # the other modes of the mask kernel: launches of the path that runs
    # each (path S's first round, path D's, path B's), times at its shape
    mode_rows = [
        ("single", "single", path_s[0][0]["single"], "S",
         "flashe_tpu/crypto/flashe.py:316-324 (XLA single-mask encrypt)"),
        ("scatter", "scatter", path_s[0][0]["scatter"], "S",
         "flashe_tpu/crypto/flashe.py:411-424 (XLA sparse decrypt)"),
        ("scatter double", "scatter", path_d[0][0]["scatter"], "D",
         "flashe_tpu/crypto/flashe.py:411-424 (XLA sparse decrypt)"),
        ("limbs", "limbs", path_b[0], "B",
         "flashe_tpu/crypto/flashe.py:247-250, 316-324 (XLA streams at "
         "int_bits > 32)")]
    print(json.dumps({"he_device_code": [
        dict(row, shape=list(row["shape"])) for row in he_rows]}))
    print(json.dumps({"kernels": [{
        "name": "flashe_mask_apply",
        "route": "cuda",
        "source": "flashe_tpu_torch/csrc/flashe_mask.cu",
        "replaces": "flashe_tpu/ops/pallas_flashe.py:79",
        "launches": main_launches,
        "launches_per_round": main_launches,
        "launches_federated": fed_launches["double"],
        "launches_per_federated_round": fed_launches["double"] // FED_ROUNDS,
        "launches_training": trained("double"),
        "launches_processes": runtime_launches["processes"],
        "launches_server": runtime_launches["server"],
        "launches_cluster": runtime_launches["cluster"],
        "launches_comparison": cmp_launches["mask double"],
        "launches_multi_gpu": multi["mask"]["double"],
        "launches_bench": bench_launches["mask double"],
        "launches_shakespeare": shake["launches"]["mask double"],
        "max_abs_err": max_err,
        "max_abs_err_bench_shapes": bench_mask_err["double"],
        "max_abs_err_gru_shape": shake["mask"]["max_abs_err"],
        "gru_shape": f"{N_GRU} lanes, int_bits {INT_BITS}",
        "ms_gru_shape": shake["mask"]["ms"],
        "plain_ms_gru_shape": shake["mask"]["plain_ms"],
        "bound_ms_gru_shape": shake["mask"]["bound_ms"],
        "ms": times[N_FEMNIST][0],
        "host_calls_ms": times[N_FEMNIST][2],
        "plain_ms": times[N_FEMNIST][1],
        "shape": f"{N_FEMNIST} lanes, int_bits {INT_BITS}",
        "bound_ms": mbound,
        "bound_by": mby,
        "library_ms": None,
    }] + [{
        "name": f"flashe_mask_apply_modes ({name})",
        "route": "cuda",
        "source": "flashe_tpu_torch/csrc/flashe_mask.cu",
        "replaces": "flashe_tpu/ops/pallas_flashe.py:79",
        "stands_in_for": stands_in_for,
        "path": path,
        "launches": launched,
        "launches_per_round": launched,
        "launches_federated": sparse_fed_launches[err_key],
        "launches_training": trained(err_key),
        # phase 16's sparse decrypt is path S's: every scatter is single
        "launches_multi_gpu": (0 if name == "scatter double"
                               else multi["mask"][err_key]),
        "launches_bench": bench_launches[f"mask {err_key}"],
        "max_abs_err": mode_err[err_key],
        **({"max_abs_err_bench_shapes": bench_mask_err[err_key]}
           if err_key in bench_mask_err else {}),
        "ms": mode_times[name]["ms"],
        "host_calls_ms": mode_times[name]["host_calls_ms"],
        "plain_ms": mode_times[name]["plain_ms"],
        "shape": mode_times[name]["shape"],
        "bound_ms": mode_times[name]["bound"][0],
        "bound_by": mode_times[name]["bound"][1],
        "library_ms": None,
    } for name, err_key, launched, path, stands_in_for in mode_rows] + [{
        "name": name,
        "route": "cuda",
        "source": "flashe_tpu_torch/csrc/montgomery.cu",
        "replaces": replaces,
        "launches": path[name],
        "launches_per_round": per_round,
        "launches_federated": pl_fed_launches[name],
        "launches_training": trained(name),
        "launches_comparison": cmp_launches[name],
        "launches_multi_gpu": multi["mont"][name],
        "launches_bench": bench_launches[name],
        "max_abs_err": mont_err[name],
        "ms": paths[name]["ms"],
        "plain_ms": paths[name]["plain_ms"],
        "shape": paths[name]["shape"],
        "plain_shape": paths[name]["plain_shape"],
        **({"ms_at_plain_shape": paths[name]["ms_at_plain_shape"]}
           if "ms_at_plain_shape" in paths[name] else {}),
        "bound_ms": paths[name]["bound"][0],
        "bound_by": paths[name]["bound"][1],
        "library_ms": None,
    } for name, replaces, path, per_round in mont_rows] + [{
        "name": f"ceiling_{name}",
        "route": "cuda",
        "source": "flashe_tpu_torch/csrc/ceiling.cu",
        "replaces": replaces,
        "launches": bench_launches[name],
        "launches_bench": bench_launches[name],
        "max_abs_err": t["err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "shape": "8,388,608 int32 elements (the roofline mode's)",
        "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1],
        "library_ms": None,
    } for (name, t), replaces in zip(ceil.items(), (
        "bench.py:906-917 (the roofline mode's XLA integer chain; no "
        "Pallas kernel)",
        "bench.py:877-1012 (the roofline mode; the shared-memory ceiling "
        "of the mask kernel's bound, no TPU counterpart)"))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
