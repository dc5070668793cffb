"""Atomic, async-capable checkpointing (port of
``repro/checkpoint/checkpointer.py``; the archive is the reference's).

* atomic: write to ``step_K.tmp/`` then ``os.rename`` — a crash mid-write
  never corrupts the latest checkpoint.
* async: a writer thread drains a queue; the train loop hands over a
  host snapshot (taken before ``save`` returns, since training updates
  its tensors in place) and keeps stepping.
* device-agnostic: leaves are stored as whole host numpy arrays keyed by
  the reference's paths (``params/blocks/attn/wq``,
  ``opt/moments/.../m_q``, ``step``), stacked leaves stacked, so either
  package restores the other's archive.
* keep-last-k with a manifest for discovery.
* deterministic bytes: sorted members, fixed zip timestamps, bf16 stored
  as ``uint16`` with a ``"bfloat16"`` sidecar, and an injectable clock
  (``now=``) for the metadata — with a fixed clock the archive of a
  state is byte-identical to the reference's for the same state.
* sharded states: a state whose leaves are DTensors (a train state on a
  mesh of ranks) is gathered leaf by leaf to one writer rank, the
  mesh's first, each distinct shard sent once; the writer alone holds a
  whole leaf, one at a time, and writes the archive a one-process
  ``Checkpointer`` writes of the same state.  Every rank reads the
  archive back and keeps its shard under its template's placements, so a
  restore lands on any mesh, or on one process.  Given the ``mesh``, the
  ranks agree on ``latest_step``: the writer's, broadcast.
"""

from __future__ import annotations

import io
import json
import os
import queue
import shutil
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.models.params import get_path, leaf_items, tree_map

# zip entries need a DOS timestamp; pin the epoch so identical arrays
# produce identical bytes
_ZIP_EPOCH = (1980, 1, 1, 0, 0, 0)


def _savez_deterministic(path, arrays: dict) -> None:
    """``np.savez`` minus the wall clock: sorted members, fixed zip
    timestamps, no compression (np.load reads it like any npz)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for key in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(
                buf, np.ascontiguousarray(arrays[key]), allow_pickle=False)
            info = zipfile.ZipInfo(key + ".npy", date_time=_ZIP_EPOCH)
            info.external_attr = 0o644 << 16
            zf.writestr(info, buf.getvalue())


def _whole_on_writer(x):
    """A leaf whole on the writer rank (the first of its mesh), None on
    the others: a DTensor's distinct shards (those of the ranks at
    coordinate 0 along each mesh dimension that replicates it) sent to
    the writer and put in place; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    import itertools

    import torch.distributed as dist
    from repro_torch.sharding.rules import shard_index
    dm, local = x.device_mesh, x.to_local().detach().contiguous()
    split = [m for m, pl in enumerate(x.placements)
             if pl.is_shard() and dm.size(m) > 1]
    ranks = dm.mesh
    writer, me = int(ranks.flatten()[0]), dist.get_rank()
    coord = dm.get_coordinate()
    if me != writer:
        if all(coord[m] == 0 for m in range(dm.ndim) if m not in split):
            dist.send(local, dst=writer)
        return None
    if not split:
        return local
    whole = torch.empty(tuple(x.shape), dtype=local.dtype,
                        device=local.device)
    for c in itertools.product(*(range(dm.size(m)) if m in split else (0,)
                                 for m in range(dm.ndim))):
        idx = shard_index(tuple(x.shape), x.placements, tuple(dm.shape), c)
        r = int(ranks[c])
        if r == writer:
            whole[idx] = local
        else:
            part = torch.empty_like(local)
            dist.recv(part, src=r)
            whole[idx] = part
    return whole


def _snapshot(state) -> tuple[dict, dict] | None:
    """(arrays, dtypes sidecar): a host copy of every tensor, bf16 as its
    raw ``uint16`` bits; a sharded leaf gathered to the writer leaf by
    leaf (None on the other ranks)."""
    arrays, meta, elsewhere = {}, {}, False
    for path, t in leaf_items(state):
        key = "/".join(path)
        t = _whole_on_writer(t)
        if t is None:
            elsewhere = True
            continue
        src = t.detach()
        t = src.cpu()
        # a device leaf's host copy is the snapshot already; a host leaf
        # is copied (training updates it in place)
        own = (lambda a: a) if t.data_ptr() != src.data_ptr() else \
            (lambda a: a.copy())
        if t.dtype == torch.bfloat16:
            arrays[key] = own(t.view(torch.int16).numpy().view(np.uint16))
            meta[key] = "bfloat16"
        else:
            arrays[key] = own(t.numpy())
    return None if elsewhere else (arrays, meta)


def _rebuild(template, blob, meta):
    """A tree like ``template`` of the archive's tensors, each on its
    template's device and in its dtype; a DTensor template's leaf this
    rank's shard of the whole array under the template's placements."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import shard_index
    out = tree_map(lambda t: t, template)
    for path, t in leaf_items(template):
        key = "/".join(path)
        arr = blob[key]
        got = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            if meta.get(key) == "bfloat16" else torch.from_numpy(arr)
        # the writer's ascontiguousarray stores a 0-d leaf as shape (1,)
        got = got.reshape(t.shape)
        if isinstance(t, DTensor):
            dm = t.device_mesh
            idx = shard_index(tuple(t.shape), t.placements, tuple(dm.shape),
                              dm.get_coordinate())
            local = t.to_local()
            got = DTensor.from_local(
                got[idx].to(device=local.device, dtype=local.dtype)
                .contiguous(), dm, t.placements, run_check=False,
                shape=t.shape, stride=t.stride())
        else:
            got = got.to(device=t.device, dtype=t.dtype)
        get_path(out, path[:-1])[path[-1]] = got
    return out


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_writes: bool = False,
                 # advisory default — anything needing byte-identical
                 # checkpoints injects a fixed clock (tests do)
                 now=time.time,  # easeylint: allow[wall-clock]
                 mesh=None):
        """``mesh`` (a ``launch.mesh.Mesh`` of ranks spanning the process
        group): the ranks a sharded state's saves gather over, which
        agree on ``latest_step``."""
        self.mesh = mesh if mesh is not None and \
            mesh.device_mesh is not None else None
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.now = now
        self.async_writes = async_writes
        self._q: queue.Queue | None = None
        self._thread = None
        self._error: BaseException | None = None
        if async_writes:
            self._q = queue.Queue(maxsize=2)
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    # -- public API --
    def save(self, step: int, state) -> None:
        snap = _snapshot(state)   # host snapshot taken synchronously
        if snap is None:          # not the writer of a sharded state
            return
        if self.async_writes:
            self._raise_pending()
            self._q.put((step, snap))
        else:
            self._write(step, snap)

    def wait(self) -> None:
        if self.async_writes:
            self._q.join()
            self._raise_pending()

    def latest_step(self) -> int | None:
        """The newest complete checkpoint, counting every save this
        process made: an async write still in flight is waited for, so a
        restart right after a save restores it instead of racing its
        writer thread (and starting over from step 0).  On a mesh every
        rank calls it and gets the writer's step."""
        self.wait()
        step = None
        m = self.dir / "manifest.json"
        if self.mesh is None or self._writer():
            steps = json.loads(m.read_text()).get("steps", []) \
                if m.exists() else []
            step = max(steps) if steps else None
        if self.mesh is None:
            return step
        import torch.distributed as dist
        dm = self.mesh.device_mesh
        t = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                         device=dm.device_type)
        # from the writer (coordinate 0) along each mesh dimension, the
        # minor first: after the last, every rank of the mesh holds it
        for m in reversed(range(dm.ndim)):
            if dm.size(m) > 1:
                group = dm.get_group(m)
                dist.broadcast(t, src=dist.get_global_rank(group, 0),
                               group=group)
        return None if int(t) < 0 else int(t)

    def _writer(self) -> bool:
        import torch.distributed as dist
        return dist.get_rank() == int(self.mesh.device_mesh.mesh.flatten()[0])

    def restore(self, template, step: int | None = None):
        """Restore into the structure, dtypes and devices of ``template``
        (e.g. a freshly initialized state): returns (state, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "meta.json").read_text())["dtypes"]
        with np.load(d / "arrays.npz", allow_pickle=False) as blob:
            return _rebuild(template, blob, meta), step

    # -- internals --
    def _write(self, step: int, snap: tuple[dict, dict]):
        arrays, meta = snap
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        _savez_deterministic(tmp / "arrays.npz", arrays)
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "dtypes": meta, "time": self.now()},
            sort_keys=True))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._update_manifest(step)

    def _update_manifest(self, step: int):
        m = self.dir / "manifest.json"
        steps = []
        if m.exists():
            steps = json.loads(m.read_text()).get("steps", [])
        steps = sorted(set(steps + [step]))
        while len(steps) > self.keep:
            victim = steps.pop(0)
            vdir = self.dir / f"step_{victim}"
            if vdir.exists():
                shutil.rmtree(vdir)
        tmp = self.dir / "manifest.json.tmp"
        tmp.write_text(json.dumps({"steps": steps}))
        os.rename(tmp, m)

    def _drain(self):
        while True:
            step, snap = self._q.get()
            try:
                self._write(step, snap)
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e
