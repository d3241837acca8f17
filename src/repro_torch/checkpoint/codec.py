"""Checkpoint codec: tensors <-> chunked byte records, in the byte format of
``repro.checkpoint.codec``, so that a file written by either package reads
in the other.

Layout (append-only stream, written through the plain file API so NVCache
can boost it transparently):

    [record 0][record 1]...[record N-1][index][footer]

Each record is one row-chunk of one leaf:  ``msgpack header || payload``.
Payload encodings: raw | zstd | int8 group-quantized (+f32 scales) | zlib.

Differences from the JAX package's codec, none of them in the bytes:
  * the headers and the index are msgpack, written and read by the small
    encoder below (maps with str keys, str, ints and lists: what the format
    uses), since ``msgpack`` is not a dependency of the port;
  * a bfloat16 leaf is carried as its raw 16-bit patterns under the dtype
    string ``"bfloat16"`` (numpy has no bfloat16 without ``ml_dtypes``);
  * ``Reader.read_leaf`` returns a CPU tensor.
``zstandard`` is optional exactly as there: without it, compressed writes
fall back to zlib, recorded per record.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch

try:
    import zstandard
except ImportError:                       # optional dependency (see docstring)
    zstandard = None

MAGIC = b"RPCKPT01"
_FOOT = struct.Struct("<QQI")       # index_off, index_len, index_crc

ENC_RAW, ENC_ZSTD, ENC_INT8, ENC_ZLIB = 0, 1, 2, 3
BF16 = "bfloat16"


# ------------------------------------------------------------------ msgpack

def packb(obj) -> bytes:
    """msgpack encoding of ``obj`` (int, str, list/tuple, dict), byte for
    byte what ``msgpack.packb`` writes for the same value."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(o, out: bytearray) -> None:
    if isinstance(o, int) and not isinstance(o, bool):
        _pack_int(o, out)
    elif isinstance(o, str):
        b = o.encode()
        n = len(b)
        if n < 32:
            out.append(0xa0 | n)
        elif n < 1 << 8:
            out += struct.pack(">BB", 0xd9, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xda, n)
        else:
            out += struct.pack(">BI", 0xdb, n)
        out += b
    elif isinstance(o, (list, tuple)):
        _pack_len(len(o), out, 0x90, 0xdc, 0xdd)
        for x in o:
            _pack(x, out)
    elif isinstance(o, dict):
        _pack_len(len(o), out, 0x80, 0xde, 0xdf)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(o).__name__}")


def _pack_len(n, out, fix, b16, b32):
    if n < 16:
        out.append(fix | n)
    elif n < 1 << 16:
        out += struct.pack(">BH", b16, n)
    else:
        out += struct.pack(">BI", b32, n)


def _pack_int(i, out):
    i = int(i)
    if 0 <= i < 0x80:
        out.append(i)
    elif i >= 0:
        for fmt, code, lim in (("B", 0xcc, 1 << 8), ("H", 0xcd, 1 << 16),
                               ("I", 0xce, 1 << 32), ("Q", 0xcf, 1 << 64)):
            if i < lim:
                out += struct.pack(">B" + fmt, code, i)
                return
        raise OverflowError(i)
    elif i >= -32:
        out += struct.pack(">b", i)
    else:
        for fmt, code, lim in (("b", 0xd0, 1 << 7), ("h", 0xd1, 1 << 15),
                               ("i", 0xd2, 1 << 31), ("q", 0xd3, 1 << 63)):
            if i >= -lim:
                out += struct.pack(">B" + fmt, code, i)
                return
        raise OverflowError(i)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def unpackb(data: bytes):
    """Inverse of :func:`packb` (arrays come back as lists, as
    ``msgpack.unpackb`` gives them)."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the msgpack object")
    return obj


def _unpack(b, i):
    c = b[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if 0xa0 <= c < 0xc0:
        n = c & 0x1f
        return bytes(b[i:i + n]).decode(), i + n
    if 0x90 <= c < 0xa0:
        return _unpack_list(b, i, c & 0x0f)
    if 0x80 <= c < 0x90:
        return _unpack_map(b, i, c & 0x0f)
    if c in _FIXED:
        fmt = _FIXED[c]
        return struct.unpack_from(fmt, b, i)[0], i + struct.calcsize(fmt)
    if c in (0xd9, 0xda, 0xdb):
        fmt = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[c]
        n = struct.unpack_from(fmt, b, i)[0]
        i += struct.calcsize(fmt)
        return bytes(b[i:i + n]).decode(), i + n
    if c in (0xdc, 0xdd):
        fmt = ">H" if c == 0xdc else ">I"
        return _unpack_list(b, i + struct.calcsize(fmt), struct.unpack_from(fmt, b, i)[0])
    if c in (0xde, 0xdf):
        fmt = ">H" if c == 0xde else ">I"
        return _unpack_map(b, i + struct.calcsize(fmt), struct.unpack_from(fmt, b, i)[0])
    raise ValueError(f"msgpack type byte 0x{c:02x} is outside the codec's subset")


def _unpack_list(b, i, n):
    out = []
    for _ in range(n):
        x, i = _unpack(b, i)
        out.append(x)
    return out, i


def _unpack_map(b, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(b, i)
        out[k], i = _unpack(b, i)
    return out, i


# ---------------------------------------------------------------- payloads

def _compress(raw: bytes, *, force_zlib: bool = False) -> tuple[bytes, bool]:
    """Compress with zstd when available (and not overridden), zlib otherwise.

    Returns ``(payload, used_zlib)``.
    """
    if not force_zlib and zstandard is not None:
        return zstandard.compress(raw, 3), False
    return zlib.compress(raw, 6), True


def _decompress(payload: bytes, used_zlib: bool) -> bytes:
    if used_zlib:
        return zlib.decompress(payload)
    if zstandard is None:
        raise ImportError(
            "checkpoint record is zstd-compressed but `zstandard` is not "
            "installed; install it or re-write the checkpoint")
    return zstandard.decompress(payload)


def _quant_np(x: np.ndarray, group: int = 256):
    flat = x.astype(np.float32).reshape(-1)
    pad = (-flat.size) % group
    if pad:
        flat = np.pad(flat, (0, pad))
    g = flat.reshape(-1, group)
    amax = np.abs(g).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(g / scale[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1), scale, pad


def _dequant_np(q: np.ndarray, scale: np.ndarray, pad: int, group: int = 256):
    g = q.reshape(-1, group).astype(np.float32) * scale[:, None]
    flat = g.reshape(-1)
    return flat[:flat.size - pad] if pad else flat


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """(array, dtype string): bfloat16 as its uint16 bit patterns."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        t = t.numpy()
    a = np.asarray(t)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dt: str) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy; keeps 0-d arrays 0-d
    if dt == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Writer:
    """Streams records through an FS (see repro_torch.storage.fsapi)."""

    def __init__(self, fs, path: str, *, encoding: int = ENC_ZSTD,
                 chunk_bytes: int = 4 << 20, close_on_finish: bool = True):
        self.fs = fs
        self.fd = fs.open(path)
        self.off = 0
        self.encoding = encoding
        self.chunk_bytes = chunk_bytes
        self.close_on_finish = close_on_finish
        self.index = []
        self._w(MAGIC)

    def _w(self, data: bytes):
        self.fs.pwrite(self.fd, data, self.off)
        self.off += len(data)

    def put_leaf(self, path: str, arr) -> None:
        """``arr``: a tensor (any device) or a numpy array."""
        a, dt = _to_numpy(arr)
        rows = max(1, a.shape[0]) if a.ndim else 1
        row_bytes = max(1, a.nbytes // rows)
        rows_per_chunk = max(1, self.chunk_bytes // row_bytes)
        if a.ndim == 0:
            chunks = [(0, 1, a.reshape(1))]
        else:
            chunks = [(s, min(s + rows_per_chunk, a.shape[0]),
                       a[s:min(s + rows_per_chunk, a.shape[0])])
                      for s in range(0, a.shape[0], rows_per_chunk)]
        for start, end, part in chunks:
            self._put_chunk(path, a, dt, start, end, part)

    def _put_chunk(self, path, a, dt, start, end, part):
        raw = np.ascontiguousarray(part)
        meta = {"p": path, "dt": dt, "gs": list(a.shape),
                "s": start, "e": end, "enc": self.encoding}
        # the JAX codec quantizes numpy float kinds only: bfloat16 (kind "V"
        # under ml_dtypes) is stored raw there, and so here
        if self.encoding == ENC_INT8 and raw.dtype.kind == "f" and dt != BF16 and raw.size >= 256:
            q, scale, pad = _quant_np(raw)
            payload, used_zlib = _compress(q.tobytes() + scale.tobytes())
            meta["pad"] = pad
            meta["nsc"] = scale.size
            if used_zlib:
                meta["zc"] = 1          # int8 payload compressed with zlib
        elif self.encoding in (ENC_ZSTD, ENC_ZLIB):
            # ENC_ZLIB is an explicit request for the portable codec — honour
            # it even when zstandard is installed
            payload, used_zlib = _compress(raw.tobytes(),
                                           force_zlib=self.encoding == ENC_ZLIB)
            meta["enc"] = ENC_ZLIB if used_zlib else ENC_ZSTD
        else:
            meta["enc"] = ENC_RAW
            payload = raw.tobytes()
        hdr = packb(meta)
        rec = struct.pack("<II", len(hdr), len(payload)) + hdr + payload
        self.index.append((path, int(start), int(end), self.off, len(rec)))
        self._w(rec)

    def finish(self) -> dict:
        idx = packb(self.index)
        idx_off = self.off
        self._w(idx)
        self._w(_FOOT.pack(idx_off, len(idx), zlib.crc32(idx)))
        size = self.off
        if self.close_on_finish:
            self.fs.close(self.fd)      # close() drains (paper semantics)
            self.fd = None
        return {"size": size, "index_off": idx_off}


class Reader:
    def __init__(self, fs, path: str):
        self.fs = fs
        self.fd = fs.open_ro(path) if hasattr(fs, "open_ro") else fs.open(path)
        size = fs.size(self.fd)
        foot = fs.pread(self.fd, _FOOT.size, size - _FOOT.size)
        idx_off, idx_len, crc = _FOOT.unpack(foot)
        idx = fs.pread(self.fd, idx_len, idx_off)
        if zlib.crc32(idx) != crc:
            raise IOError("checkpoint index corrupt")
        self.index = unpackb(idx)
        if fs.pread(self.fd, len(MAGIC), 0) != MAGIC:
            raise IOError(f"{path} is not a checkpoint (bad magic)")

    def leaf_paths(self):
        return sorted({e[0] for e in self.index})

    def read_leaf(self, path: str, *, rows: Optional[tuple] = None) -> torch.Tensor:
        """The leaf (or its rows ``[lo, hi)``) as a CPU tensor in its stored
        dtype."""
        entries = sorted((e for e in self.index if e[0] == path),
                         key=lambda e: e[1])
        if not entries:
            raise KeyError(path)
        parts, meta0 = [], None
        for _p, start, end, off, ln in entries:
            if rows is not None and (end <= rows[0] or start >= rows[1]):
                continue
            rec = self.fs.pread(self.fd, ln, off)
            hlen, plen = struct.unpack("<II", rec[:8])
            meta = unpackb(rec[8:8 + hlen])
            payload = rec[8 + hlen:8 + hlen + plen]
            arr = self._decode(meta, payload, start, end)
            if rows is not None:
                lo = max(rows[0], start) - start
                hi = min(rows[1], end) - start
                arr = arr[lo:hi]
            parts.append(arr)
            meta0 = meta
        gs = meta0["gs"]
        out = np.concatenate(parts, axis=0) if gs else parts[0].reshape(())
        if rows is None and gs:
            out = out.reshape(gs)
        return _to_tensor(out, meta0["dt"])

    def _decode(self, meta, payload, start, end):
        """Numpy rows of one record; bfloat16 as uint16 bit patterns."""
        bf16 = meta["dt"] == BF16
        dt = np.dtype(np.uint16) if bf16 else np.dtype(meta["dt"])
        shape = [end - start] + meta["gs"][1:] if meta["gs"] else [1]
        if meta["enc"] == ENC_INT8:
            blob = _decompress(payload, bool(meta.get("zc")))
            n = int(np.prod(shape))
            pad = meta["pad"]
            q = np.frombuffer(blob[:n + pad], np.int8)
            scale = np.frombuffer(blob[n + pad:], np.float32)
            return _dequant_np(q, scale, pad).astype(dt).reshape(shape)
        if meta["enc"] in (ENC_ZSTD, ENC_ZLIB):
            blob = _decompress(payload, meta["enc"] == ENC_ZLIB)
            return np.frombuffer(blob, dt).reshape(shape)
        return np.frombuffer(payload, dt).reshape(shape)

    def close(self):
        self.fs.close(self.fd)
