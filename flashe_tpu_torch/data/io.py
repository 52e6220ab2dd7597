"""Dataset ingestion: CSV -> feature instances / arrays (port of
flashe_tpu/data/io.py, numpy only).

The reference ingests CSVs through fate_flow upload into eggroll tables
of Instance(features, label) records which the DataIO component
(federatedml/util/data_io.py, DenseFeatureReader) parses ahead of every
training DSL.  Here ingestion is a library call: dense CSV -> numpy
arrays or a DTable of Instances (data/table.py), feeding the same
partitioners the synthetic generators use (flashe_tpu_torch/data/__init__.py).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from flashe_tpu_torch.data.table import DTable, Session

__all__ = ["Instance", "read_dense_csv", "upload_csv"]


@dataclass
class Instance:
    """One sample record (reference: federatedml Instance of
    (features, label) built by DenseFeatureReader)."""
    inst_id: int
    features: np.ndarray
    label: Optional[float] = None


def read_dense_csv(path: str, label_index: Optional[int] = 0,
                   delimiter: str = ",", has_header: bool = True,
                   label_type: str = "int",
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Reads a dense-feature CSV into (x, y) arrays.

    label_index selects the label column (None = unlabeled data);
    remaining columns become float32 features in file order.  Mirrors the
    reference's dense DataIO semantics (data_io.py DenseFeatureReader:
    configurable label column/type, missing values not supported on the
    FLASHE workloads).
    """
    xs, ys = [], []
    with open(path, newline="") as f:
        rows = csv.reader(f, delimiter=delimiter)
        if has_header:
            next(rows, None)
        for row in rows:
            if not row:
                continue
            vals = list(row)
            if label_index is not None:
                y = vals.pop(label_index)
                ys.append(int(float(y)) if label_type == "int" else float(y))
            xs.append([float(v) for v in vals])
    x = np.asarray(xs, dtype=np.float32)
    if label_index is None:
        return x, None
    dtype = np.int32 if label_type == "int" else np.float32
    return x, np.asarray(ys, dtype=dtype)


def upload_csv(session: Session, path: str, name: str, namespace: str,
               label_index: Optional[int] = 0, delimiter: str = ",",
               has_header: bool = True, partition: int = 1) -> DTable:
    """fate_flow upload analogue: CSV -> session table of Instances."""
    x, y = read_dense_csv(path, label_index, delimiter, has_header)
    table = session.table(name, namespace, partition)
    for i in range(len(x)):
        table.put(i, Instance(inst_id=i, features=x[i],
                              label=None if y is None else y[i].item()))
    return table
