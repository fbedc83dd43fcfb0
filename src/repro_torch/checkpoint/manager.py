"""Fault-tolerant checkpointing (counterpart of
``repro.checkpoint.manager``, with its on-disk layout).

  * atomic    — written to ``.tmp_step_N``, ``meta.json`` fsynced, then
                renamed to ``step_N``; a crash mid-save never corrupts the
                latest checkpoint
  * async     — the files are written on a background thread; ``save``
                blocks only while an earlier save is still in flight
  * checksummed — one ``.npy`` per leaf with its crc32 in ``meta.json``;
                restore skips corrupt or partial checkpoints and falls
                back to the previous one
  * keep-N    — bounded disk usage

Leaves are keyed as the JAX package keys them (dict keys, list indices,
``.field`` for a NamedTuple's fields, joined by "/"; ``lm.tree_items``),
so either package reads a checkpoint that the other wrote of the same
tree of float32 and integer leaves (a train state is one). The port
updates its state in place, so ``save`` copies every leaf to host memory
before it returns; only the file writing runs on the thread. numpy has
no bfloat16: a bf16 leaf is saved as its int16 view, its dtype recorded
in ``meta.json``. That is the port's own format: the JAX package saves
bf16 through ml_dtypes and restores with ``astype``, so bf16 leaves do
not cross between the packages.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.lm import tree_items, tree_rebuild


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of the leaf in host memory and its dtype's name."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype)[len("torch."):]


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))      # a writable copy, 0-d kept
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, *, blocking: bool = False,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()                      # one in-flight save at a time
        arrays = [(key, *_to_host(leaf)) for key, leaf in tree_items(tree)]
        meta = {"step": step, "time": time.time(), "extra": extra or {},
                "arrays": {}}

        def work():
            try:
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for key, arr, dtype in arrays:
                    fn = key.replace("/", "__") + ".npy"
                    path = os.path.join(tmp, fn)
                    np.save(path, arr)
                    with open(path, "rb") as f:
                        crc = zlib.crc32(f.read())
                    meta["arrays"][key] = {"file": fn, "crc": crc,
                                           "shape": list(arr.shape),
                                           "dtype": dtype}
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def _load_dir(self, step: int) -> Optional[Dict[str, torch.Tensor]]:
        d = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            arrays = {}
            for key, info in meta["arrays"].items():
                with open(os.path.join(d, info["file"]), "rb") as f:
                    raw = f.read()
                if zlib.crc32(raw) != info["crc"]:
                    raise IOError(f"crc mismatch for {key} at step {step}")
                arrays[key] = _from_host(np.load(io.BytesIO(raw)),
                                         info["dtype"])
            return arrays
        except Exception:
            return None

    def restore_latest(self, tree_like, *, shardings=None
                       ) -> Tuple[Optional[int], Any]:
        """Restore the newest intact checkpoint into a tree shaped like
        ``tree_like``, each leaf at its dtype and device; corrupt ones are
        skipped. Returns (step or None, tree)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore_latest(shardings=): sharded restore is not ported "
                "yet (ROADMAP queue 1 item 11)")
        for step in reversed(self.steps()):
            arrays = self._load_dir(step)
            if arrays is None:
                continue

            def leaf(key, like):
                if key not in arrays:
                    raise KeyError(f"checkpoint missing array {key!r}")
                return arrays[key].to(device=like.device, dtype=like.dtype)
            return step, tree_rebuild(tree_like, leaf)
        return None, tree_like
