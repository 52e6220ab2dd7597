#!/usr/bin/env python3
"""Smoke test of the PyTorch port (flashe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases, each of which fails the run:
  1. build the CUDA mask kernel (csrc/flashe_mask.cu) with nvcc for sm_90a;
  2. hold the kernel against its plain torch version on the card: a grid of
     int_bits x lane counts x counter offsets, bit-exact, plus the FIPS-197
     AES-256 vector and golden lanes from the `cryptography` AES;
  3. one FLASHE round of FemnistCNN at full width (1,206,590 lanes) with 10
     clients, int_bits 20, element_bits 16, the secure ACIQ quantizer and
     the double mask, through client_upload / arbiter_reduce /
     client_download; then the same round with client 9 dropped.  The
     decrypted lanes must equal the clients' summed quantized values mod
     2^20, the new global model must lie within one quantization step of
     the clients' mean, and the launch counter must show that every encrypt
     and decrypt went through the kernel;
  4. timings with CUDA events (printed, not asserted).
It prints the kernels' JSON line and the card's name and power limit, then
as its last line {"ok": true, "device": {...}}.  Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from flashe_tpu_torch.crypto.flashe import FlasheCipher, merge_idx_runs
from flashe_tpu_torch.nn.models import FemnistCNN
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops import _build, aes, lanes, masks
from flashe_tpu_torch.ops import flashe_mask as fm
from flashe_tpu_torch.protocol.aggregator import (
    ClientBlock, arbiter_reduce, client_download, client_upload)
from flashe_tpu_torch.quant.quantizer import QuantizingClient

INT_BITS, ELEMENT_BITS, N_CLIENTS = 20, 16, 10
SEED = 0x0F1A5E
GRID_INT_BITS = (8, 16, 20, 25, 32)
GRID_COUNTS = (1, 5, 7, 3000, 1_206_590, 4_194_304)
GRID_BASES = (0, 3, 96)
N_FEMNIST = 1_206_590

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


def round_keys(dev):
    """Round keys of the seed bytes(range(32)), the FIPS-197 C.3 key."""
    return torch.from_numpy(aes.key_schedule(bytes(range(32))).astype(
        "int32")).to(dev)


def check_kernel_grid(dev):
    """Kernel against mask_apply_ref on the card; returns the max error."""
    rk = round_keys(dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    max_err = 0
    for m in GRID_INT_BITS:
        n_ok = 0
        for count in GRID_COUNTS:
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


def make_clients(dev, codec, n):
    blocks = []
    for i in range(n):
        c = FlasheCipher(INT_BITS, device=dev)
        c.idx = i
        c.set_num_clients(n)
        c.generate_prp_seed(assigned_seed=SEED)
        q = QuantizingClient(INT_BITS, False, ELEMENT_BITS, True, True,
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


def run_round(dev, model, survivors, it):
    """One round: every client uploads, the arbiter sums the survivors'
    ciphertexts (the others missed the deadline), client 0 downloads.
    Returns the kernel launches of the round, its host time and what the
    checks need."""
    codec = WeightsCodec(model.params_to_flax(), device=dev)
    blocks = make_clients(dev, codec, N_CLIENTS)
    flats = client_flats(dev, codec, model, N_CLIENTS)

    torch.cuda.synchronize()
    fm.launches = 0
    t0 = time.perf_counter()
    ups = [client_upload(blocks[i], codec, flats[i], it)
           for i in range(N_CLIENTS)]
    agg = arbiter_reduce([ups[i].lanes for i in survivors], INT_BITS)
    idx_list = [j for i in survivors for j in ups[i].idx_list]
    new = client_download(blocks[0], agg, idx_list, codec.total,
                          sum(ups[i].degree for i in survivors))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return fm.launches, seconds, dict(codec=codec, blocks=blocks, flats=flats,
                                      ups=ups, agg=agg, idx_list=idx_list,
                                      new=new)


def check_round(dev, survivors, it, r):
    """Decrypted lanes == sum(q) mod 2^20; new model within one step."""
    codec, blocks, ups = r["codec"], r["blocks"], r["ups"]
    rk = blocks[0].cipher._round_keys
    # each client's q, recovered with the plain version of its own masks
    qs = [fm.mask_apply_ref(ups[i].lanes, rk, it, i + 1, i, INT_BITS)
          for i in survivors]
    for q in qs:
        if int(q.min()) < 0 or int(q.max()) >= 1 << ELEMENT_BITS:
            raise AssertionError("a recovered q is outside [0, 2^16)")
    want = sum(lanes.as_u32(q) for q in qs) % (1 << INT_BITS)
    dec = blocks[0].cipher.decrypt(r["agg"], r["idx_list"])
    if not torch.equal(lanes.as_u32(dec), want):
        raise AssertionError("decrypted lanes != sum(q) mod 2^20")
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


def event_ms(fn, reps):
    """Per-call milliseconds of fn() with CUDA events, one pair per call."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def time_kernel(dev, count, reps=10):
    """Median ms of the kernel and of the plain version on the same
    inputs, run in turns plain, kernel, kernel, plain."""
    rk = round_keys(dev)
    q = lanes.to_i32(torch.randint(0, 1 << 16, (count,), device=dev,
                                   dtype=torch.int64))
    kern = lambda: fm.mask_apply(q, rk, 0, 1, 2, INT_BITS)  # noqa: E731
    plain = lambda: fm.mask_apply_ref(q, rk, 0, 1, 2, INT_BITS)  # noqa: E731
    for f in (kern, plain):
        f()
    samples = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        samples[name] += event_ms(kern if name == "kernel" else plain, reps)
    return (statistics.median(samples["kernel"]),
            statistics.median(samples["plain"]))


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs on "
              "the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load("flashe_mask")
    print(f"kernel build (nvcc, sm_90a) and load: "
          f"{time.perf_counter() - t0:.2f} s")

    max_err = check_kernel_grid(dev)

    torch.manual_seed(SEED)
    model = FemnistCNN(device=dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != N_FEMNIST:
        raise AssertionError(f"FemnistCNN has {n_params} parameters")

    first = None
    for it, survivors in ((0, list(range(N_CLIENTS))),
                          (1, list(range(N_CLIENTS - 1)))):
        n, secs, r = run_round(dev, model, survivors, it)
        # one launch per encrypt, one per decrypt boundary pair
        expect = N_CLIENTS + len(merge_idx_runs(survivors)[0])
        if n != expect:
            raise AssertionError(f"round {it}: {n} kernel launches, "
                                 f"expected {expect}")
        worst = check_round(dev, survivors, it, r)
        print(f"round iter={it} survivors={len(survivors)}/{N_CLIENTS}: "
              f"{r['codec'].total} lanes, kernel launches {n} (= {N_CLIENTS} "
              f"encrypts + {n - N_CLIENTS} decrypt), decrypted == sum(q) mod 2^{INT_BITS}, "
              f"new model within {worst:.3f} steps of the clients' mean, "
              f"first-run host time {secs * 1e3:.1f} ms")
        first = first or (n, r)

    # the full round's new global model runs: finite logits that agree
    # with the same model on the CPU
    main_launches, r = first
    new_params = r["codec"].unflatten(r["new"])
    cnn = FemnistCNN(device=dev).eval()
    cnn.params_from_flax(new_params)
    cpu = FemnistCNN().eval()
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

    # timings: the kernel against its plain version, the 10-ciphertext sum,
    # bench.py's metric n / (one encrypt + the sum + the decrypt), and the
    # whole round
    times = {}
    for count in (N_FEMNIST, 4_194_304):
        times[count] = k, p = time_kernel(dev, count)
        cts = [lanes.to_i32(torch.randint(0, 1 << 32, (count,), device=dev,
                                          dtype=torch.int64))
               for _ in range(N_CLIENTS)]
        arbiter_reduce(cts, INT_BITS)
        agg = statistics.median(event_ms(
            lambda: arbiter_reduce(cts, INT_BITS), 20))
        print(f"{count} lanes, int_bits {INT_BITS}: mask kernel {k:.4f} ms, "
              f"plain torch {p:.4f} ms, {N_CLIENTS}-ciphertext sum "
              f"{agg:.4f} ms (medians, CUDA events); enc + agg + dec "
              f"{count / ((2 * k + agg) / 1e3):.1f} elements/s")
    round_ms = []
    for rep in range(5):
        _, secs, _ = run_round(dev, model, list(range(N_CLIENTS)), 2 + rep)
        round_ms.append(secs * 1e3)
    print(f"full round ({N_CLIENTS} x normalize+quantize+encrypt, sum, "
          f"decrypt+decode, {N_FEMNIST} lanes): median "
          f"{statistics.median(round_ms):.2f} ms, samples "
          f"{[round(v, 2) for v in round_ms]} (host clock to synchronize)")

    print(json.dumps({"kernels": [{
        "name": "flashe_mask_apply",
        "route": "cuda",
        "source": "flashe_tpu_torch/csrc/flashe_mask.cu",
        "replaces": "flashe_tpu/ops/pallas_flashe.py:79",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": times[N_FEMNIST][0],
        "plain_ms": times[N_FEMNIST][1],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
