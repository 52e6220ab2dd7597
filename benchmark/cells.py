"""A cell as BENCHMARK.json names it, with the files that belong to it:
the configuration's file (`configs`), its traffic mix
(`traffic/<traffic>.json`), its limits (`limits/<cell>.json`) and the
metrics it reports (`metrics/<metric>.py`).  Nothing here names a cell,
a configuration or a metric: a new one is new files and new entries."""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Cell", "load_cell", "homo_param", "derive_seed"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json; raises KeyError for a name
    it does not list and OSError for a missing file."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(here, "limits", f"{name}.json")) as f:
        limits = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def homo_param(cell: Cell):
    """The program's HomoNNParam of the cell: the configuration's `param`
    with the traffic's `param` laid over it (a group key by key)."""
    from flashe_tpu_torch.runtime.config import HomoNNParam

    d = copy.deepcopy(cell.config["param"])
    for k, v in cell.traffic.get("param", {}).items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            d[k] = {**d[k], **v}
        else:
            d[k] = v
    return HomoNNParam.from_dict(d)


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed (tags name the use)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
