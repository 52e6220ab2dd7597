"""FLASHE session pieces without transport (port of
flashe_tpu/protocol/blocks/flashe.py): the configuration's arguments and
the masking decision of a sparsified round.

With sparsification the arbiter collects every client's locations, chooses
single or double masking by the cost of the sparse decrypt
(`choose_masking`, mask="dynamic") and broadcasts {"choice", "masks"}; each
client installs both in its cipher (`client_masking`).  Because
C = sum |m_i & m_{i+1}| over consecutive clients is below S = sum |m_i|,
double_cost = 4 S - 2 C always exceeds single_cost = 2 S: the dynamic
choice is always "single".  The JAX package broadcasts only under
mask="dynamic", so there a sparsified round with mask="double" installs no
locations and decrypts on the dense path; `arbiter_masking` broadcasts them
for every mask, so that the sparse double round decrypts.

The transport, the uuid and DH syncs and the seed wrap are not ported yet:
clients share a seed through FlasheCipher.generate_prp_seed.
"""

from __future__ import annotations

import torch

from flashe_tpu_torch.device import resolve_device

__all__ = ["choose_masking", "arbiter_masking",
           "client_masking"]


def _parse_args(args):
    q = args["quantize"]
    return {
        "int_bits": q["int_bits"],
        "batch": q["batch"],
        "element_bits": q["element_bits"],
        "padding": q.get("padding", True),
        "secure": q["secure"],
        "mask": args.get("mask", "double"),
        "precompute": args.get("precompute", {"enable": False}),
        # >1 (or "all"): the party shards encrypt/decrypt over that many
        # local devices (not ported yet)
        "local_lane_shards": args.get("local_lane_shards"),
    }


def choose_masking(masks, total: int, device="cuda") -> str:
    """The arbiter's single-or-double decision from the clients' location
    lists, in client order: a single-mask decrypt regenerates one stream a
    selected position (2 S), a double-mask one two, less the positions
    that consecutive clients share (4 S - 2 C).  The overlaps are counted
    with bool tensors on `device`."""
    device = resolve_device(device)
    single_cost = 2 * sum(len(m) for m in masks)
    double_cost = 2 * single_cost
    cancelled = torch.zeros((), dtype=torch.int64, device=device)
    prev = None
    for m in masks:
        hot = torch.zeros(total, dtype=torch.bool, device=device)
        hot[torch.as_tensor(m, dtype=torch.int64, device=device)] = True
        if prev is not None:
            cancelled += (prev & hot).sum()
        prev = hot
    double_cost -= 2 * int(cancelled)
    return "single" if single_cost <= double_cost else "double"


def arbiter_masking(masks, total: int, mask: str, device="cuda") -> dict:
    """What the arbiter broadcasts once it holds every client's locations:
    the masking to use (the cost decision under mask="dynamic", else the
    configured mask) and the locations."""
    choice = (choose_masking(masks, total, device) if mask == "dynamic"
              else mask)
    return {"choice": choice, "masks": masks}


def client_masking(cipher, broadcast: dict):
    """A client's application of the broadcast: its cipher's masking
    scheme and every client's locations (its total was set when the client
    selected)."""
    cipher.masking_scheme = broadcast["choice"]
    cipher.set_masks(broadcast["masks"], cipher.total)
