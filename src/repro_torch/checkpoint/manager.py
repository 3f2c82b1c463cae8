"""Uncoordinated pod-local checkpointing (the paper's FT substrate), the
counterpart of ``repro.checkpoint.manager``.

Each pod owns a complete replica of the training state, so a pod
checkpoints *independently* of the others: its own timer cadence with a
pod-specific phase offset (uncoordinated, which avoids synchronized I/O
bursts, paper §2.2), asynchronous background writes, and checkpoint
*move-ahead* (paper §4.1): a pod about to idle can snapshot early so its
next timer checkpoint is absorbed into otherwise-wasted time.

Storage layout (atomic via tmp+rename), the reference's:
    root/pod_<i>/step_<n>/arrays.npz     flat {path: array}
    root/pod_<i>/step_<n>/meta.json      step, wall time, leaf manifest

Leaf keys are the reference's ``"/"``-joined paths (``"0/blocks/attn/wq"``,
``"1/count"``) over a nested dict/tuple state.  numpy has no bfloat16, so a
bfloat16 leaf is stored as its 16-bit pattern (``uint16``) and
``meta.json``'s ``"dtypes"`` names every leaf's dtype; a restore gives it
back bit for bit.  A checkpoint without ``"dtypes"`` (one the reference
wrote) restores through each array's own dtype.  The asynchronous writer
gets host copies taken before it starts, so the caller may go on training
(and may free or replace the state) while it writes.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
import time
import zlib
from typing import List, Optional

import numpy as np
import torch

from repro_torch._tree import items, path_key

__all__ = ["CheckpointConfig", "PodCheckpointManager"]


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a leaf (bfloat16 as its uint16 bit pattern)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def _flatten(tree) -> tuple:
    """``({key: host array}, {key: dtype name})`` in the reference's order."""
    flat, dtypes = {}, {}
    for path, leaf in items(tree):
        key = path_key(path)
        flat[key] = _host(leaf)
        dtypes[key] = _dtype_name(leaf)
    return flat, dtypes


def _leaf_from(arr: np.ndarray, dtype_name: Optional[str], example, key: str):
    if tuple(arr.shape) != tuple(example.shape):
        raise ValueError(f"checkpoint shape mismatch at {key}: "
                         f"{arr.shape} vs {tuple(example.shape)}")
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(example, torch.Tensor):
        return t.to(device=example.device, dtype=example.dtype)
    return t.numpy().astype(np.asarray(example).dtype)


def _unflatten_into(example, flat: dict, dtypes: dict, path=()):
    if isinstance(example, dict):
        return {k: _unflatten_into(example[k], flat, dtypes, path + (k,))
                for k in sorted(example)}
    if isinstance(example, (tuple, list)):
        return type(example)(_unflatten_into(v, flat, dtypes, path + (i,))
                             for i, v in enumerate(example))
    key = path_key(path)
    return _leaf_from(flat[key], dtypes.get(key), example, key)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    root: str
    interval_steps: int = 100
    keep: int = 2
    async_save: bool = True
    # uncoordinated phase offsets: pod i first checkpoints at
    # interval * (1 + jitter_frac * frac(crc32(i)))
    jitter_frac: float = 0.5
    # explicit phase: every pod first checkpoints at step
    # interval_steps - phase_offset_steps (jitter_frac is then ignored).
    # The adaptive controller's reconciliation uses 1, which puts the first
    # save exactly interval_steps * step_time of execution after the
    # renewal engine's age-0 start.
    phase_offset_steps: Optional[int] = None


class PodCheckpointManager:
    """One per pod.  Timer (step-count) cadence with a pod-specific offset.

    ``io_log`` records every write and read: ``{"op": "save" | "restore",
    "step", "bytes", "seconds"}`` (a save's seconds are its writer's: the
    npz write, the meta file, the rename and the GC; the host copy before
    it is ``"copy_seconds"``)."""

    def __init__(self, cfg: CheckpointConfig, pod_id: int):
        self.cfg = cfg
        self.pod_id = pod_id
        self.dir = pathlib.Path(cfg.root) / f"pod_{pod_id}"
        self.dir.mkdir(parents=True, exist_ok=True)
        # deterministic pod phase (Python's hash() is per-process salted)
        self._phase = (zlib.crc32(f"pod-{pod_id}".encode()) % 1000) / 1000.0
        self._offset = self._phase_offset()
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.saves = 0
        self.move_aheads = 0
        self.io_log: List[dict] = []

    def _phase_offset(self) -> int:
        if self.cfg.phase_offset_steps is not None:
            return int(self.cfg.phase_offset_steps)
        return int(self.cfg.interval_steps * self.cfg.jitter_frac * self._phase)

    def set_interval_steps(self, interval_steps: int) -> None:
        """Re-cadence a live manager (the adaptive controller's policy
        push).  Takes effect at the next ``due`` check: the anchor stays the
        latest saved step, so the next checkpoint fires ``interval_steps``
        after it under the new interval."""
        if interval_steps < 1:
            raise ValueError(f"interval_steps must be >= 1, got {interval_steps}")
        self.cfg = dataclasses.replace(self.cfg, interval_steps=int(interval_steps))
        self._offset = self._phase_offset()

    # --- cadence -----------------------------------------------------------

    def due(self, step: int) -> bool:
        last = self.latest_step()
        anchor = last if last is not None else -self._offset
        return step - anchor >= self.cfg.interval_steps

    def age_steps(self, step: int) -> int:
        last = self.latest_step()
        return step + self._offset if last is None else step - last

    # --- save/restore ------------------------------------------------------

    def save(self, step: int, state, *, move_ahead: bool = False) -> None:
        """Snapshot the state.  ``move_ahead`` marks a paper-§4.1 early
        checkpoint taken while entering a wait phase.  The host copy is
        taken here, before the writer starts."""
        self.wait()
        t0 = time.perf_counter()
        flat, dtypes = _flatten(state)
        copy_s = time.perf_counter() - t0

        def _write():
            t1 = time.perf_counter()
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "arrays.npz", **flat)
            (tmp / "meta.json").write_text(json.dumps({
                "step": step,
                "pod": self.pod_id,
                "time": time.time(),
                "move_ahead": move_ahead,
                "leaves": sorted(flat.keys()),
                "dtypes": dtypes,
            }))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()
            self.io_log.append({
                "op": "save", "step": step,
                "bytes": sum(a.nbytes for a in flat.values()),
                "copy_seconds": copy_s,
                "seconds": time.perf_counter() - t1})

        def _write_async():
            try:
                _write()
            except Exception as exc:          # re-raised by wait()
                self._error = exc

        self.saves += 1
        if move_ahead:
            self.move_aheads += 1
        if self.cfg.async_save:
            self._pending = threading.Thread(target=_write_async, daemon=True)
            self._pending.start()
        else:
            _write()

    def maybe_save(self, step: int, state) -> bool:
        if self.due(step):
            self.save(step, state)
            return True
        return False

    def wait(self) -> None:
        """Join the pending write; re-raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"pod {self.pod_id}: checkpoint write "
                               "failed") from err

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))
        return steps[-1] if steps else None

    def restore(self, example_state, step: Optional[int] = None):
        """Restore into the structure, dtypes and devices of
        ``example_state`` (shapes checked)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint for pod {self.pod_id}")
        t0 = time.perf_counter()
        ck = self.dir / f"step_{step}"
        meta = json.loads((ck / "meta.json").read_text())
        with np.load(ck / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        state = _unflatten_into(example_state, flat, meta.get("dtypes", {}))
        self.io_log.append({"op": "restore", "step": step,
                            "bytes": sum(a.nbytes for a in flat.values()),
                            "seconds": time.perf_counter() - t0})
        return step, state

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
