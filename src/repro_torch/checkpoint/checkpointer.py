"""Checkpointing: async, atomic, keep-k — the port of
``repro.checkpoint.checkpointer``.

Layout (the reference's, file for file):
  <dir>/step_00001230/
      manifest.json          # step, leaf index (path -> file/shape/dtype), meta
      <flat-leaf-name>.npy   # one file per tree leaf
  <dir>/LATEST               # committed pointer, written last (atomicity)

A directory written by either package restores in the other: leaves are
numpy ``.npy`` files named by their ``.``-joined tree path (``w``,
``table``, ``table_mean``, ``snapshot``, ``snapshot_grad`` for a
``SolverState``).

Fault-tolerance properties:
  * A checkpoint is visible only after its manifest AND the LATEST pointer
    are atomically renamed into place — a crash mid-save never corrupts the
    restore path.
  * ``meta`` carries the data-pipeline sampler state so restarts replay the
    exact batch schedule.
  * Saves run on a background thread from a host snapshot taken
    synchronously (a copy: the engines update the SAG/SAGA table in place);
    training continues while bytes hit disk.

Restore places every leaf on one device.  The reference's ``shardings=``
(elastic restore onto another mesh) waits for multi-GPU (ROADMAP queue 1,
item 12).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..obs import CHECKPOINT, NULL_TRACER

_LEAF_SEP = "."


def atomic_write_text(path, text: str) -> Path:
    """Write ``text`` to ``path`` via tmp-file + ``os.replace``.

    A crash mid-write leaves either the old file or the new one, never a
    truncated hybrid — the property every resumable-state JSON (RunResult
    artifacts) needs to survive being the thing that crashed.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".tmp_{path.name}_{os.getpid()}"
    tmp.write_text(text)
    os.replace(tmp, path)
    return path


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """How :func:`repro_torch.core.experiment.execute` snapshots a run.

    ``directory`` receives the :class:`Checkpointer` layout (one
    ``step_<epochs_done>`` dir per snapshot plus the ``LATEST`` pointer);
    ``every`` checkpoints each time the CUMULATIVE epoch count divides by it
    (the final epoch of every ``execute`` call is always saved, so a
    completed segment is resumable regardless of alignment); ``keep`` is the
    GC depth; ``async_save`` overlaps the disk write with the next epoch
    (the epoch loop only ever waits for the PREVIOUS write).
    """
    directory: Path
    every: int = 1
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        # normalize so a str-built policy compares equal to a Path-built one
        object.__setattr__(self, "directory", Path(self.directory))

    def validate(self) -> None:
        if not str(self.directory):
            raise ValueError("checkpoint.directory must be a usable path")
        if self.every < 1:
            raise ValueError(
                f"checkpoint.every must be >= 1 epoch (got {self.every})")
        if self.keep < 1:
            raise ValueError(
                f"checkpoint.keep must retain >= 1 snapshot (got "
                f"{self.keep}) — keep=0 would GC the checkpoint a resume "
                f"needs")


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + [str(k)], v)
        elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            for i, v in enumerate(node):
                walk(path + [str(i)], v)
        elif hasattr(node, "_fields"):  # NamedTuple
            for k in node._fields:
                walk(path + [k], getattr(node, k))
        elif node is None:
            flat[_LEAF_SEP.join(path)] = None
        else:
            flat[_LEAF_SEP.join(path)] = node

    walk([], tree)
    return flat


def _unflatten_into(template, flat: Dict[str, Any]):
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + [str(k)], v) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(walk(path + [k], getattr(node, k))
                                for k in node._fields))
        if isinstance(node, (list, tuple)):
            vals = [walk(path + [str(i)], v) for i, v in enumerate(node)]
            return type(node)(vals) if isinstance(node, list) else tuple(vals)
        if node is None:
            return None
        return flat[_LEAF_SEP.join(path)]

    return walk([], template)


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf, owned by the snapshot (never a view of a
    buffer the next epoch updates in place).  ``.cpu()`` of a card tensor
    is already a new buffer; a CPU tensor is cloned."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.cpu() if t.is_cuda else t.clone()).numpy()
    return np.array(leaf)


class Checkpointer:
    def __init__(self, directory: Path, keep: int = 3, async_save: bool = True,
                 tracer=NULL_TRACER):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.tracer = tracer
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, meta: Optional[Dict] = None,
             block: bool = False):
        """Snapshot to host, then write on a background thread."""
        self.wait()  # one in-flight save at a time
        # the "snapshot" span is the ONLY synchronous cost the training loop
        # pays for an async save; serialize/commit run on the writer thread
        with self.tracer.span("snapshot", CHECKPOINT, step=step):
            host = {k: (_to_host(v) if v is not None else None)
                    for k, v in _flatten(tree).items()}
        meta = dict(meta or {})

        def _write():
            try:
                self._write_sync(step, host, meta)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _write_sync(self, step: int, host: Dict[str, Optional[np.ndarray]],
                    meta: Dict):
        name = f"step_{step:010d}"
        tmp = self.dir / f".tmp_{name}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        with self.tracer.span("serialize", CHECKPOINT, step=step):
            index = {}
            for key, arr in host.items():
                if arr is None:
                    index[key] = None
                    continue
                fname = re.sub(r"[^\w\.\-]", "_", key) + ".npy"
                np.save(tmp / fname, arr)
                index[key] = {"file": fname, "shape": list(arr.shape),
                              "dtype": str(arr.dtype)}
            manifest = {"step": step, "index": index, "meta": meta,
                        "time": time.time()}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
        with self.tracer.span("commit", CHECKPOINT, step=step):
            final = self.dir / name
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                      # atomic publish
            latest_tmp = self.dir / f".LATEST_{os.getpid()}"
            latest_tmp.write_text(name)
            latest_tmp.rename(self.dir / "LATEST")  # atomic pointer flip
            self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            m = re.match(r"step_(\d+)$", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def _is_complete(self, step: int) -> bool:
        """A step is restorable only if its manifest parses AND every leaf
        file it indexes is still on disk — a half-deleted dir (interrupted
        GC, partial copy, manual cleanup) must not be selected."""
        d = self.dir / f"step_{step:010d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, ValueError):
            return False
        return all(entry is None or (d / entry["file"]).exists()
                   for entry in manifest["index"].values())

    def latest_step(self) -> Optional[int]:
        """Newest restorable step: the ``LATEST`` pointer when its target is
        complete, else the newest step whose manifest AND leaf files all
        exist."""
        ptr = self.dir / "LATEST"
        if ptr.exists():
            m = re.match(r"step_(\d+)$", ptr.read_text().strip())
            if m and self._is_complete(int(m.group(1))):
                return int(m.group(1))
        for s in reversed(self.all_steps()):
            if self._is_complete(s):
                return s
        return None

    def read_meta(self, step: Optional[int] = None) -> Tuple[int, Dict]:
        """(step, meta) WITHOUT loading any leaf arrays — the cheap probe
        :func:`repro_torch.core.experiment.resume_from` validates a plan
        against before paying for the restore."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        return step, manifest["meta"]

    def restore(self, template, step: Optional[int] = None, shardings=None,
                device="cuda") -> Tuple[Any, Dict]:
        """Restore into the structure of ``template``, every leaf a tensor
        on ``device`` (the card unless the caller asks for the CPU)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=) — elastic restore onto a device mesh — "
                "is not in the port yet (ROADMAP queue 1, item 12: "
                "multi-GPU)")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {}
        for key, entry in manifest["index"].items():
            if entry is None:
                flat[key] = None
                continue
            flat[key] = torch.from_numpy(np.load(d / entry["file"])).to(device)
        tree = _unflatten_into(template, flat)
        return tree, manifest["meta"]
