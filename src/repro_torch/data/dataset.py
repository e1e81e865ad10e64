"""Datasets: memmapped row-matrix stores (ERM).

A copy of ``repro.data.dataset`` (the token corpus of the LM zoo is not
ported yet): it reads and writes the same corpus files byte for byte.

The on-disk layout is deliberately flat binary (np.memmap) because the whole
point of the paper is the physical access pattern: CS/SS read contiguous
byte ranges (readahead + page-cache friendly), RS fancy-indexes scattered
rows. Each training host owns a contiguous shard [host_start, host_end) of
rows, so the samplers operate per-host and any host can recompute any other
host's schedule (fault tolerance / elastic restart).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusMeta:
    kind: str              # "tokens" | "rows" | "sparse_rows"
    rows: int              # sequences (LM) or data points (ERM)
    row_dim: int           # tokens per sequence / features per point (+1 label)
    dtype: str
    # sparse (CSR) extension.  Dense metadata stays byte-compatible BOTH
    # ways: to_json omits the extension keys for fmt="dense" (so pre-
    # extension readers sharing a corpus cache keep working), and
    # from_json drops unknown keys (so future extensions don't break us).
    fmt: str = "dense"     # "dense" | "csr"
    nnz: int = 0           # stored nonzeros (CSR only)
    max_row_nnz: int = 0   # densest row (CSR only; sizes kernel DMA windows)

    _EXTENSION_KEYS = ("fmt", "nnz", "max_row_nnz")

    @property
    def nbytes(self) -> int:
        """On-disk payload bytes — what the planner compares against device
        memory for streamed-vs-resident placement.  CSR: indices + values +
        indptr + labels; dense: the row matrix."""
        if self.fmt == "csr":
            return (self.nnz * (4 + 4)          # int32 indices + f32 values
                    + (self.rows + 1) * 8       # int64 indptr
                    + self.rows * 4)            # f32 labels
        return self.rows * self.row_dim * np.dtype(self.dtype).itemsize

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if self.fmt == "dense":
            for k in self._EXTENSION_KEYS:
                del d[k]
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "CorpusMeta":
        known = {f.name for f in dataclasses.fields(CorpusMeta)}
        return CorpusMeta(**{k: v for k, v in json.loads(s).items()
                             if k in known})


def _meta_path(path: Path) -> Path:
    return path.with_suffix(path.suffix + ".meta.json")


def write_corpus(path: Path, data: np.ndarray, kind: str) -> CorpusMeta:
    """Write a (rows, row_dim) array as a flat binary corpus + metadata."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    assert data.ndim == 2
    meta = CorpusMeta(kind, data.shape[0], data.shape[1], str(data.dtype))
    mm = np.memmap(path, dtype=data.dtype, mode="w+", shape=data.shape)
    mm[:] = data
    mm.flush()
    del mm
    _meta_path(path).write_text(meta.to_json())
    return meta


def open_corpus(path: Path) -> Tuple[np.memmap, CorpusMeta]:
    path = Path(path)
    meta = CorpusMeta.from_json(_meta_path(path).read_text())
    mm = np.memmap(path, dtype=np.dtype(meta.dtype), mode="r",
                   shape=(meta.rows, meta.row_dim))
    return mm, meta


def synth_erm_corpus(path: Path, *, rows: int, features: int,
                     seed: int = 0, separation: float = 2.0) -> CorpusMeta:
    """ERM corpus: rows = [x_0..x_{n-1}, y] float32, y in {-1, +1}."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=features) / np.sqrt(features)
    mm = np.memmap(path, dtype=np.float32, mode="w+",
                   shape=(rows, features + 1))
    chunk = max(1, min(rows, (1 << 24) // max(features + 1, 1)))
    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        X = rng.normal(size=(hi - lo, features)).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-separation * (X @ w_true)))
        y = np.where(rng.uniform(size=hi - lo) < p, 1.0, -1.0).astype(np.float32)
        mm[lo:hi, :features] = X
        mm[lo:hi, features] = y
    mm.flush()
    del mm
    meta = CorpusMeta("rows", rows, features + 1, "float32")
    _meta_path(path).write_text(meta.to_json())
    return meta


def host_shard(rows: int, host: int, num_hosts: int) -> Tuple[int, int]:
    """Contiguous row range owned by `host` (remainder spread to the front)."""
    base = rows // num_hosts
    extra = rows % num_hosts
    start = host * base + min(host, extra)
    size = base + (1 if host < extra else 0)
    return start, start + size
