"""Checkpoints: directory handles + retention + state (de)serialisation.

Port of `ray_tpu/train/checkpoint.py`. `Checkpoint`, `pack_dir` /
`unpack_dir`, `CheckpointManager` and the atomic staging-and-rename
publication are copies; only the serialisation changed.

Parity: reference train/_checkpoint.py (directory-handle Checkpoint),
train/_internal/checkpoint_manager.py:80-108 (num_to_keep retention).

Two storage engines:
- "npz" (default): the pickled structure + a flat npz of leaves.
  Round-trips ARBITRARY nests of dicts, lists, tuples and NamedTuples
  over torch tensors, numpy arrays and Python values (a torch
  optimizer's `state_dict` included, int keys and tensor `step`) with
  no restore target needed. A tensor loads as a CPU tensor of its
  dtype, a numpy leaf as numpy, a Python value as itself.
- "orbax" (the name kept for the JAX package's users): the state goes
  through `torch.distributed.checkpoint` (`dcp.save`, `dcp.async_save`
  for async saves). `dcp.load` fills a target in place, so
  `load_pytree` needs one for this engine, as orbax does to rebuild
  custom treedefs.
Select via `engine=` or the RAY_TPU_CKPT_ENGINE env var.

Checkpoint DIRECTORIES move between hosts as tar bytes (`pack_dir` /
`unpack_dir`) through the object store — the trainer never assumes a
shared filesystem (reference ships files via storage_path upload,
train/_internal/storage.py:104; our transport is the object plane).
"""
from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import sys
import tarfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Checkpoint:
    """A handle to a checkpoint directory (contents are framework-free)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    # ------------------------------------------------------ pytree io
    @classmethod
    def from_state(cls, path: str, state: Any,
                   metadata: Optional[dict] = None) -> "Checkpoint":
        """Persist a nest of tensors, arrays and values to `path`
        and return the handle."""
        os.makedirs(path, exist_ok=True)
        save_pytree(state, os.path.join(path, "state"))
        if metadata is not None:
            with open(os.path.join(path, "metadata.json"), "w") as f:
                json.dump(metadata, f)
        return cls(path)

    def load_state(self) -> Any:
        return load_pytree(os.path.join(self.path, "state"))

    def metadata(self) -> dict:
        p = os.path.join(self.path, "metadata.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self):
        return f"Checkpoint({self.path})"


class _Leaf:
    """Where leaf `i` sat in a saved structure."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _tensor_type():
    """torch.Tensor, or None while this process has not imported torch:
    no leaf can be a tensor then, and a numpy-only save skips torch's
    import (seconds in a fresh worker)."""
    torch = sys.modules.get("torch")
    return None if torch is None else torch.Tensor


def _is_leaf(x) -> bool:
    tensor = _tensor_type()
    return (isinstance(x, (np.ndarray, np.generic))
            or (tensor is not None and isinstance(x, tensor)))


def _walk(tree: Any, is_leaf, fn) -> Any:
    """`tree` with `fn` applied to each leaf; dicts (their type and key
    order kept), lists, tuples and NamedTuples are walked, anything else
    stays as it is."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _walk(v, is_leaf, fn)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(v, is_leaf, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, is_leaf, fn) for v in tree)
    return tree


def _flatten(tree: Any, leaves: list) -> Any:
    """`tree` with each tensor or array moved to `leaves` and a `_Leaf`
    in its place."""
    def take(x):
        leaves.append(x)
        return _Leaf(len(leaves) - 1)
    return _walk(tree, _is_leaf, take)


def _unflatten(structure: Any, leaves: list) -> Any:
    return _walk(structure, lambda x: isinstance(x, _Leaf),
                 lambda x: leaves[x.i])


# torch dtypes that numpy holds natively; the others (bfloat16, the
# float8s, ...) ride as raw bytes
_NUMPY_NATIVE = ("bool", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "float32", "float64", "complex64", "complex128")


def _encode_leaf(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as an array npz can hold, and its tag: "np" for a numpy
    leaf, "torch" for a tensor of a dtype numpy holds, else
    "torch:<dtype>" for a tensor stored as raw bytes (the last axis its
    element's bytes). 0-d tensors can't be viewed as uint8 directly —
    they ride as (1,) with a `!0d` tag suffix."""
    tensor = _tensor_type()
    if tensor is None or not isinstance(leaf, tensor):
        a = np.asarray(leaf)
        if a.dtype.isbuiltin != 1:
            raise TypeError(f"numpy dtype {a.dtype} has no npz form: save "
                            f"it as a torch tensor")
        return a, "np"
    import torch
    t = leaf.detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if name in _NUMPY_NATIVE:
        return t.numpy(), "torch"
    tag = "torch:" + name
    if t.ndim == 0:
        t = t.reshape(1)
        tag += "!0d"
    raw = t.view(torch.uint8).reshape(tuple(t.shape) + (t.element_size(),))
    return raw.numpy(), tag


def _decode_leaf(a: np.ndarray, tag: str):
    if tag == "np":
        return a
    import torch
    a = np.require(a, requirements="C")     # keeps a 0-d array 0-d
    if tag == "torch":
        return torch.from_numpy(a)
    name = tag.removeprefix("torch:")
    scalar = name.endswith("!0d")
    if scalar:
        name = name[:-3]
    raw = torch.from_numpy(a)
    out = raw.reshape(raw.shape[:-1] + (-1,)).view(getattr(torch, name))
    out = out.reshape(raw.shape[:-1])
    return out.reshape(()) if scalar else out


def _engine(engine: Optional[str]) -> str:
    return engine or os.environ.get("RAY_TPU_CKPT_ENGINE", "npz")


class AsyncSave:
    """Handle of an in-flight `dcp.async_save` (engine "orbax"):
    `wait_until_finished()` blocks on its future and re-raises what the
    save raised."""

    def __init__(self, future):
        self._future = future

    def wait_until_finished(self) -> None:
        self._future.result()


# path -> in-flight AsyncSave (see save_pytree)
_ASYNC_CKPTRS: Dict[str, AsyncSave] = {}


def _publish_dir(staged: str, path: str) -> None:
    """Atomic checkpoint publication (r14): rename a fully-written
    staging dir into place so a reader never observes a torn state —
    a preemption during the WRITE leaves either the previous complete
    checkpoint or an orphaned ``*.rtpu_tmp*`` dir, never a partial
    ``path``. Same-directory renames are atomic on POSIX. When `path`
    already exists the swap itself is two renames, so a vanishingly
    narrow crash window can leave `path` absent with the previous
    state parked at ``*.rtpu_old*``; readers (CheckpointManager
    `latest`) treat a missing dir as unusable and fall back one
    generation — degraded, never corrupt. The next save sweeps the
    leftovers (see save_pytree)."""
    if os.path.exists(path):
        old = path + ".rtpu_old" + os.path.basename(staged)[-8:]
        if os.path.exists(old):
            shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
        os.rename(staged, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(staged, path)


def _sweep_stale_staging(path: str) -> None:
    """Remove ``*.rtpu_tmp*``/``*.rtpu_old*`` siblings a crashed
    earlier save left behind for this path (bounds the leak; the
    content at `path` itself is never touched)."""
    import glob as _glob
    for stale in (_glob.glob(path + ".rtpu_tmp*")
                  + _glob.glob(path + ".rtpu_old*")):
        shutil.rmtree(stale, ignore_errors=True)


def save_pytree(tree: Any, path: str, engine: Optional[str] = None,
                async_save: bool = False):
    """Persist a nest of tensors, arrays and values under `path` with
    the chosen engine.

    engine="npz" (default): structure pickle + npz leaves, any nest.
    engine="orbax": `torch.distributed.checkpoint`; with
    async_save=True returns an `AsyncSave` handle (call
    .wait_until_finished() or let the next save barrier), else None.
    """
    eng = _engine(engine)
    if eng not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint engine {eng!r}")
    if eng == "orbax":
        os.makedirs(path, exist_ok=True)
        import torch.distributed.checkpoint as dcp
        target = os.path.join(path, "dcp")
        # One in-flight save per path: re-saving a path first barriers
        # on the in-flight save, so rmtree can never tear a write that
        # is still running.
        prev = _ASYNC_CKPTRS.pop(path, None)
        if prev is not None:
            prev.wait_until_finished()
        if os.path.exists(target):
            shutil.rmtree(target)
        marker = os.path.join(path, "engine")
        if async_save:
            handle = AsyncSave(dcp.async_save({"state": tree},
                                              checkpoint_id=target))
            _ASYNC_CKPTRS[path] = handle
            # bound the registry: each entry holds a thread + tree refs;
            # fresh-dir-per-step loops would otherwise grow it forever
            while len(_ASYNC_CKPTRS) > 4:
                old_path = next(iter(_ASYNC_CKPTRS))
                _ASYNC_CKPTRS.pop(old_path).wait_until_finished()
            with open(marker, "w") as f:
                f.write(eng)
            return handle          # .wait_until_finished() before reading
        dcp.save({"state": tree}, checkpoint_id=target)
        with open(marker, "w") as f:
            f.write(eng)
        return None
    # npz engine: write everything into a staging dir, then one rename
    # publishes it — a preemption mid-save can never leave a torn
    # "latest" for restore to load (r14 elastic contract).
    import uuid
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    _sweep_stale_staging(path)
    staged = f"{path}.rtpu_tmp{uuid.uuid4().hex[:8]}"
    os.makedirs(staged)
    try:
        leaves: list = []
        structure = _flatten(tree, leaves)
        encoded, tags = [], []
        for leaf in leaves:
            e, t = _encode_leaf(leaf)
            encoded.append(e)
            tags.append(t)
        np.savez(os.path.join(staged, "leaves.npz"),
                 **{f"leaf_{i}": leaf for i, leaf in enumerate(encoded)})
        with open(os.path.join(staged, "structure.pkl"), "wb") as f:
            pickle.dump((structure, tags), f)
        # marker last: its presence certifies a complete staging dir
        with open(os.path.join(staged, "engine"), "w") as f:
            f.write(eng)
        _publish_dir(staged, path)
    except BaseException:
        shutil.rmtree(staged, ignore_errors=True)
        raise
    return None


def load_pytree(path: str, target: Any = None) -> Any:
    """Load what `save_pytree` saved. An npz-engine save needs no
    `target`. An orbax-engine save (`torch.distributed.checkpoint`) is
    loaded INTO `target`, a nest of the saved structure whose tensors
    take the saved values in place; it is returned."""
    inflight = _ASYNC_CKPTRS.pop(path, None)
    if inflight is not None:     # racing our own async save: barrier
        inflight.wait_until_finished()
    marker = os.path.join(path, "engine")
    eng = "npz"
    if os.path.exists(marker):
        with open(marker) as f:
            eng = f.read().strip()
    if eng == "orbax":
        if target is None:
            raise ValueError(
                f"{path} was saved by torch.distributed.checkpoint, which "
                f"loads into a target: pass target= (a nest of the saved "
                f"structure)")
        import torch.distributed.checkpoint as dcp
        state = {"state": target}
        dcp.load(state, checkpoint_id=os.path.join(path, "dcp"))
        return state["state"]
    with open(os.path.join(path, "structure.pkl"), "rb") as f:
        structure, tags = pickle.load(f)
    data = np.load(os.path.join(path, "leaves.npz"))
    leaves = [_decode_leaf(data[f"leaf_{i}"], t) for i, t in enumerate(tags)]
    return _unflatten(structure, leaves)


# -------------------------------------------------- dir <-> bytes
def pack_dir(path: str) -> bytes:
    """Tar a checkpoint directory into bytes (the cross-host transport:
    worker -> object store -> driver storage; no shared fs assumed)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        tar.add(path, arcname=".")
    return buf.getvalue()


def tar_array(data: bytes) -> np.ndarray:
    """A packed checkpoint as a uint8 array over the same memory, for a
    reply that nests it (`RayTrainWorker.next_result`'s tuple): the object
    plane sends an array out of band (a shm segment) wherever it sits in
    the value, where `bytes` go out of band only as the value itself, and
    a frame over `wire_max_frame_bytes` (1 GiB) kills the connection that
    carries it (ROADMAP queue 3, item 8). `unpack_dir` takes either."""
    return np.frombuffer(data, dtype=np.uint8)


class _BufferReader(io.RawIOBase):
    """A read-only file over a buffer, read where it lies: `io.BytesIO`
    copies any buffer but `bytes`, and a multi-GB copy holds the GIL for
    seconds, long enough for the head to miss its agents' heartbeats."""

    def __init__(self, data):
        self._mv = memoryview(data).cast("B")
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        n = max(0, min(len(b), len(self._mv) - self._pos))
        b[:n] = self._mv[self._pos:self._pos + n]
        self._pos += n
        return n

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        base = {io.SEEK_SET: 0, io.SEEK_CUR: self._pos,
                io.SEEK_END: len(self._mv)}[whence]
        self._pos = max(0, base + offset)
        return self._pos

    def tell(self) -> int:
        return self._pos


def unpack_dir(data, dest: str) -> str:
    """Untar `data` (the bytes of `pack_dir`, or `tar_array` of them)
    into `dest`."""
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(fileobj=_BufferReader(data), mode="r") as tar:
        try:
            tar.extractall(dest, filter="data")
        except TypeError:
            # filter= needs >=3.10.12/3.11.4; validate members manually
            # on older patch releases before falling back.
            root = os.path.realpath(dest)
            members = tar.getmembers()
            for m in members:
                target = os.path.realpath(os.path.join(dest, m.name))
                if not (target == root
                        or target.startswith(root + os.sep)):
                    raise RuntimeError(
                        f"unsafe path in checkpoint tar: {m.name!r}")
                if not (m.isreg() or m.isdir()):
                    # filter="data" parity: no links, FIFOs, devices
                    raise RuntimeError(
                        f"non-regular member in checkpoint tar: "
                        f"{m.name!r}")
                m.mode &= 0o777   # strip setuid/setgid/sticky
            tar.extractall(dest, members=members)
    return dest


class CheckpointManager:
    """Registers reported checkpoints, keeps the best/latest num_to_keep."""

    def __init__(self, root: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._registered: List[Tuple[float, int, str, Dict]] = []
        self._counter = 0
        # Recover managed entries already on disk (r15 head HA): the
        # registry used to be memory-only, so a restarted driver's
        # fresh manager saw an empty `latest` even with intact
        # checkpoints under the same root — the elastic resume path
        # across a head restart depends on rediscovering them (with
        # their persisted metrics, so step seeding works too).
        import glob as _glob
        import re as _re
        for path in sorted(_glob.glob(
                os.path.join(self.root, "checkpoint_*"))):
            m = _re.fullmatch(r"checkpoint_(\d+)",
                              os.path.basename(path))
            if m is None or not self._usable(path):
                continue
            idx = int(m.group(1))
            metrics = self._load_metrics(path)
            self._counter = max(self._counter, idx)
            self._registered.append(
                (self._score_at(metrics, idx), idx, path, metrics))

    _METRICS_FILE = ".rtpu_metrics.json"

    def _load_metrics(self, dest: str) -> Dict:
        try:
            with open(os.path.join(dest, self._METRICS_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict] = None) -> Checkpoint:
        """Move the checkpoint under management and apply retention.
        Only valid when `checkpoint.path` is on THIS host's filesystem;
        remote workers ship bytes via `register_bytes`."""
        metrics = metrics or {}
        self._counter += 1
        dest = os.path.join(self.root, f"checkpoint_{self._counter:06d}")
        if os.path.abspath(checkpoint.path) != dest:
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.move(checkpoint.path, dest)
        return self._register_dest(dest, metrics)

    def register_bytes(self, data,
                       metrics: Optional[Dict] = None) -> Checkpoint:
        """Unpack a worker-shipped checkpoint tarball (bytes, or their
        `tar_array`) under management (the no-shared-filesystem
        path)."""
        metrics = metrics or {}
        self._counter += 1
        dest = os.path.join(self.root, f"checkpoint_{self._counter:06d}")
        if os.path.exists(dest):
            shutil.rmtree(dest)
        # unpack into a staging dir, publish with one rename: a crash
        # mid-unpack must not leave a torn managed entry that `latest`
        # would hand to the next restore
        staged = dest + ".rtpu_tmp"
        if os.path.exists(staged):
            shutil.rmtree(staged)
        try:
            unpack_dir(data, staged)
            os.rename(staged, dest)
        except BaseException:
            shutil.rmtree(staged, ignore_errors=True)
            raise
        return self._register_dest(dest, metrics)

    def _register_dest(self, dest: str, metrics: Dict) -> Checkpoint:
        score = self._score(metrics)
        self._registered.append((score, self._counter, dest, metrics))
        try:
            # persist the registration metrics beside the data (small,
            # atomic) so a restarted driver's manager recovers scores
            # and step numbers, not just directories
            tmp = os.path.join(dest, self._METRICS_FILE + ".tmp")
            with open(tmp, "w") as f:
                json.dump({k: v for k, v in metrics.items()
                           if isinstance(v, (int, float, str, bool))
                           or v is None}, f)
            os.replace(tmp, os.path.join(dest, self._METRICS_FILE))
        except (OSError, TypeError, ValueError):
            pass
        self._apply_retention()
        return Checkpoint(dest)

    def _score(self, metrics: Dict) -> float:
        return self._score_at(metrics, self._counter)

    def _score_at(self, metrics: Dict, counter: int) -> float:
        if self.score_attribute and self.score_attribute in metrics:
            v = float(metrics[self.score_attribute])
            return v if self.score_order == "max" else -v
        return float(counter)  # fall back to recency

    def metrics_for(self, checkpoint: "Checkpoint") -> Dict:
        """Registration metrics of a managed checkpoint ({} when
        unknown) — survives driver restarts via the persisted
        per-entry metrics file."""
        path = os.path.abspath(checkpoint.path)
        for _, _, p, metrics in self._registered:
            if os.path.abspath(p) == path:
                return dict(metrics)
        return self._load_metrics(path)

    def _apply_retention(self) -> None:
        if self.num_to_keep is None:
            return
        while len(self._registered) > self.num_to_keep:
            self._registered.sort(key=lambda t: (t[0], t[1]))
            score, cnt, path, _ = self._registered.pop(0)
            if os.path.exists(path):
                shutil.rmtree(path, ignore_errors=True)

    @staticmethod
    def _usable(path: str) -> bool:
        """A restorable entry: its directory survived (crash/retention
        races) and is not a torn write. Entries registered through the
        staged-rename paths are complete by construction; this guards
        against external damage (deleted dirs, a pre-atomic save torn
        by preemption — a `state` dir without its `engine` marker,
        which save_pytree writes last)."""
        if not os.path.isdir(path):
            return False
        try:
            if not os.listdir(path):
                return False
        except OSError:
            return False
        state = os.path.join(path, "state")
        if os.path.isdir(state) and not os.path.exists(
                os.path.join(state, "engine")):
            return False                 # marker is written last
        return True

    @property
    def latest(self) -> Optional[Checkpoint]:
        """Newest USABLE checkpoint — unfinished/corrupt entries are
        skipped so a preemption mid-save can never feed restore a torn
        'latest'; falls back to the next-newest survivor."""
        for _, _, path, _ in sorted(self._registered,
                                    key=lambda t: -t[1]):
            if self._usable(path):
                return Checkpoint(path)
        return None

    @property
    def best(self) -> Optional[Checkpoint]:
        usable = [t for t in self._registered if self._usable(t[2])]
        if not usable:
            return None
        return Checkpoint(max(usable, key=lambda t: (t[0], t[1]))[2])

    def checkpoints(self) -> List[Checkpoint]:
        return [Checkpoint(p) for _, _, p, _ in
                sorted(self._registered, key=lambda t: t[1])
                if self._usable(p)]
