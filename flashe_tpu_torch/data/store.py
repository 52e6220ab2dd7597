"""On-disk dataset store: the fate_flow upload/download analogue (port of
flashe_tpu/data/store.py, numpy only).

The reference ingests CSVs once via `fate_flow_client -f upload`
(fate_flow/utils/upload.py) into persistent eggroll tables addressed by
(namespace, table_name), which training DSLs then reference; `download`
re-exports a table to CSV (fate_flow/utils/download.py).  Here the store
is a directory of npz shards + JSON metadata addressed the same way, and
job configs may reference a stored table instead of a synthetic dataset
(`"dataset": {"namespace": ..., "name": ...}`).

The store is shared with the JAX package: the same files (data.npz,
meta.json) under the same root (FLASHE_DATA_DIR, else ~/.flashe_tpu/data),
so a table either package uploads loads in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import List, Optional, Tuple

import numpy as np

from flashe_tpu_torch.data.io import Instance, read_dense_csv

__all__ = ["DataStore", "default_store"]


def _safe(part: str) -> str:
    if (not part or part in (".", "..")
            or any(c in part for c in ("/", "\\", "\0"))):
        raise ValueError(f"invalid table identifier {part!r}")
    return part


class DataStore:
    """Persistent (namespace, name)-addressed dataset storage."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(
            "FLASHE_DATA_DIR",
            os.path.join(os.path.expanduser("~"), ".flashe_tpu", "data"))

    def _dir(self, namespace: str, name: str) -> str:
        return os.path.join(self.root, _safe(namespace), _safe(name))

    # -- upload / download (CSV <-> stored table) --------------------------

    def upload_csv(self, path: str, namespace: str, name: str,
                   label_index: Optional[int] = 0, delimiter: str = ",",
                   has_header: bool = True, label_type: str = "int",
                   partition: int = 1) -> dict:
        x, y = read_dense_csv(path, label_index, delimiter, has_header,
                              label_type)
        return self.put(namespace, name, x, y, partition=partition,
                        source=os.path.abspath(path))

    def put(self, namespace: str, name: str, x: np.ndarray,
            y: Optional[np.ndarray] = None, partition: int = 1,
            source: str = "") -> dict:
        d = self._dir(namespace, name)
        os.makedirs(d, exist_ok=True)
        arrays = {"x": x} if y is None else {"x": x, "y": y}
        np.savez(os.path.join(d, "data.npz"), **arrays)
        meta = {
            "namespace": namespace,
            "name": name,
            "count": int(len(x)),
            "feature_shape": list(x.shape[1:]),
            "labeled": y is not None,
            "partition": int(partition),
            "source": source,
            "created": time.time(),
        }
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
        return meta

    def load(self, namespace: str, name: str
             ) -> Tuple[np.ndarray, Optional[np.ndarray], dict]:
        d = self._dir(namespace, name)
        meta_path = os.path.join(d, "meta.json")
        if not os.path.exists(meta_path):
            raise KeyError(f"no stored table {namespace}.{name} "
                           f"under {self.root}")
        with open(meta_path) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "data.npz")) as z:
            return z["x"], (z["y"] if meta["labeled"] else None), meta

    def download_csv(self, namespace: str, name: str, out_path: str,
                     delimiter: str = ",") -> dict:
        x, y, meta = self.load(namespace, name)
        flat = x.reshape(len(x), -1)
        with open(out_path, "w") as f:
            cols = [f"x{i}" for i in range(flat.shape[1])]
            if y is not None:
                cols = ["y"] + cols
            f.write(delimiter.join(cols) + "\n")
            for i in range(len(flat)):
                row = [repr(v) for v in flat[i].tolist()]
                if y is not None:
                    row = [str(y[i].item())] + row
                f.write(delimiter.join(row) + "\n")
        return meta

    # -- catalogue ----------------------------------------------------------

    def list_tables(self) -> List[dict]:
        out = []
        if not os.path.isdir(self.root):
            return out
        for ns in sorted(os.listdir(self.root)):
            nsd = os.path.join(self.root, ns)
            if not os.path.isdir(nsd):
                continue
            for name in sorted(os.listdir(nsd)):
                mp = os.path.join(nsd, name, "meta.json")
                if os.path.exists(mp):
                    with open(mp) as f:
                        out.append(json.load(f))
        return out

    def delete(self, namespace: str, name: str) -> bool:
        d = self._dir(namespace, name)
        if not os.path.isdir(d):
            return False
        shutil.rmtree(d)
        return True

    def to_dtable(self, session, namespace: str, name: str):
        """Materialize a stored table as a session DTable of Instances."""
        x, y, meta = self.load(namespace, name)
        table = session.table(name, namespace, meta.get("partition", 1))
        for i in range(len(x)):
            table.put(i, Instance(
                inst_id=i, features=x[i],
                label=None if y is None else y[i].item()))
        return table


def default_store() -> DataStore:
    return DataStore()
