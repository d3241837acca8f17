"""Checkpoint manager on top of the plain file API: the port of
``repro.checkpoint.manager``.

``save()`` returns once the checkpoint bytes are *synchronously durable* in
the fast tier (when the FS is NVCache-backed, that is the NVMM log append),
while the cleanup thread drains to the blob tier in the background.  The
manifest write is the commit point: a crash mid-save restores the previous
step, never a torn state.

Trees are nested dicts of tensors.  A leaf's key is its path of dict keys
joined by ``/`` (``params/layers/attn/wq``, ``opt/step``), in sorted order:
the keys ``jax.tree_util.tree_flatten_with_path`` gives the JAX manager, so
a checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.checkpoint import codec


def flatten(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out += flatten(v, key + "/")
        else:
            out.append((key, v))
    return out


def unflatten(items):
    tree = {}
    for key, v in items:
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


class CheckpointManager:
    def __init__(self, fs, directory: str = "/ckpt", *, keep: int = 2,
                 encoding: int = codec.ENC_ZSTD):
        self.fs = fs
        self.dir = directory.rstrip("/")
        self.keep = keep
        self.encoding = encoding
        self._manifest_path = f"{self.dir}/MANIFEST.json"
        self._manifest_fd = None      # held open: close() would wait behind
        self._deferred_fds: list = []  # the whole FIFO log drain

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> dict:
        # finalize previous steps' files now (their background drain has had
        # a full checkpoint interval to complete — close() barely blocks)
        self.finalize()
        path = f"{self.dir}/step_{step:08d}.ckpt"
        w = codec.Writer(self.fs, path, encoding=self.encoding,
                         close_on_finish=False)
        for key, leaf in flatten(tree):
            w.put_leaf(key, leaf)
        info = w.finish()
        self._deferred_fds.append(w.fd)
        manifest = self._read_manifest()
        manifest["steps"] = sorted(set(manifest.get("steps", []) + [step]))
        manifest["latest"] = max(manifest["steps"])
        manifest["files"] = {**manifest.get("files", {}),
                             str(step): {"path": path, **info}}
        self._gc(manifest)
        # the manifest write commits the checkpoint (crash before it ->
        # previous step restores; the data file is garbage-collected)
        self._write_manifest(manifest)
        return {"step": step, **info}

    def finalize(self) -> None:
        """Close deferred checkpoint files (waits for their drain)."""
        for fd in self._deferred_fds:
            try:
                self.fs.close(fd)
            except Exception:
                pass
        self._deferred_fds.clear()

    def close(self) -> None:
        self.finalize()
        if self._manifest_fd is not None:
            try:
                self.fs.close(self._manifest_fd)
            except Exception:
                pass
            self._manifest_fd = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        m = self._read_manifest()
        return m.get("latest")

    def restore(self, tree_like, step: Optional[int] = None):
        """A dict shaped like ``tree_like`` of CPU tensors in their stored
        dtypes.  (The JAX manager's ``slice_rows`` for resharded restore
        comes with the port of elastic restore.)"""
        m = self._read_manifest()
        step = step if step is not None else m.get("latest")
        if step is None:
            raise FileNotFoundError("no checkpoint")
        path = m["files"][str(step)]["path"]
        r = codec.Reader(self.fs, path)
        leaves = [(key, r.read_leaf(key)) for key, _ in flatten(tree_like)]
        r.close()
        return unflatten(leaves)

    # ------------------------------------------------------------- internals
    def _mfd(self):
        if self._manifest_fd is None:
            self._manifest_fd = self.fs.open(self._manifest_path)
        return self._manifest_fd

    def _read_manifest(self) -> dict:
        try:
            fd = self._mfd()
            size = self.fs.size(fd)
            raw = self.fs.pread(fd, size, 0) if size else b""
            return json.loads(raw) if raw else {}
        except Exception:
            return {}

    def _write_manifest(self, manifest: dict) -> None:
        blob = json.dumps(manifest).encode()
        fd = self._mfd()
        # single pwrite -> one atomic committed group in NVCache
        self.fs.pwrite(fd, blob.ljust(max(self.fs.size(fd), len(blob)), b" "), 0)
        self.fs.fsync(fd)

    def _gc(self, manifest: dict) -> None:
        steps = manifest.get("steps", [])
        while len(steps) > self.keep:
            steps.pop(0)
        manifest["steps"] = steps
        manifest["files"] = {k: v for k, v in manifest.get("files", {}).items()
                             if int(k) in steps}
