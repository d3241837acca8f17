"""The port's checkpoint codec and manager against the JAX package's: the
msgpack subset writes the bytes ``msgpack.packb`` writes, both packages
write the same checkpoint file for the same train state, and a checkpoint
written by either restores in the other, bit for bit for float32, int32
and bfloat16 leaves (int8-encoded leaves decode to the same values in
both).  The file bytes are moved between the two packages' NVCache FS
objects.  Covers the raw, zlib, zstd and int8 encodings and bfloat16
moments (``moment_dtype="bfloat16"``).  No tolerance: every comparison is
exact."""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.registry import get_smoke as jax_smoke
from repro.core import NVCache as JNVCache
from repro.core import Policy as JPolicy
from repro.models import lm as jlm
from repro.optim.adamw import AdamW as JAdamW
from repro.storage.fsapi import NVCacheFS as JNVCacheFS
from repro.storage.tiers import DRAM as JDRAM
from repro.storage.tiers import Tier as JTier
from repro_torch.checkpoint import codec
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.convert import params_from_numpy
from repro_torch.core import NVCache, Policy
from repro_torch.storage.fsapi import NVCacheFS
from repro_torch.storage.tiers import DRAM, Tier

POL = dict(entry_size=16384, log_entries=8192, page_size=4096,
           read_cache_pages=64, batch_min=8, batch_max=512, verify_crc=False)
ENCODINGS = [codec.ENC_RAW, codec.ENC_ZLIB, codec.ENC_ZSTD, codec.ENC_INT8]

MSGPACK_VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    "", "a", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 70000, "é/ü",
    [], list(range(15)), list(range(16)), list(range(70000)), (1, "two", [3]),
    {}, {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {"p": "params/layers/attn/wq", "dt": "bfloat16", "gs": [2, 64, 64], "s": 0, "e": 2,
     "enc": 2, "pad": 0, "nsc": 32, "zc": 1},
    [("opt/step", 0, 1, 8, 61), ("params/embed", 0, 256, 2**33, 65573)],
]


@pytest.mark.parametrize("value", MSGPACK_VALUES, ids=range(len(MSGPACK_VALUES)))
def test_msgpack_subset_matches_msgpack(value):
    packed = codec.packb(value)
    assert packed == msgpack.packb(value)
    want = msgpack.unpackb(packed)
    assert codec.unpackb(packed) == want
    for other in (1.5, None, True, b"raw"):
        with pytest.raises(TypeError):
            codec.packb(other)


def test_msgpack_refuses_outside_the_subset():
    for other in (1.5, None, True, b"raw"):
        with pytest.raises(ValueError, match="subset"):
            codec.unpackb(msgpack.packb(other))
    with pytest.raises(ValueError, match="trailing"):
        codec.unpackb(msgpack.packb(1) + b"\x00")


def _jax_state(moment_dtype):
    params = jlm.init_lm(jax_smoke("llama3.2-1b"), jax.random.PRNGKey(0))
    opt = JAdamW(moment_dtype=moment_dtype)
    state = {"params": params, "opt": opt.init(params)}
    rng = np.random.default_rng(1)
    # moments and step made non-zero, so that every leaf carries information
    state["opt"] = {"m": jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                                            a.dtype), state["opt"]["m"]),
                    "v": jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), a.dtype),
                                      state["opt"]["v"]),
                    "step": jnp.int32(17)}
    return jax.tree.map(np.asarray, state)


def _fs_pair():
    nv, jnv = NVCache(Policy(**POL), Tier(DRAM)), JNVCache(JPolicy(**POL), JTier(JDRAM))
    return nv, NVCacheFS(nv), jnv, JNVCacheFS(jnv)


def _files(fs, step):
    paths = ["/ckpt/MANIFEST.json", f"/ckpt/step_{step:08d}.ckpt"]
    out = {}
    for p in paths:
        fd = fs.open(p)
        out[p] = fs.pread(fd, fs.size(fd), 0)
        fs.close(fd)
    return out


def _put_files(fs, files):
    for p, blob in files.items():
        fd = fs.open(p)
        fs.pwrite(fd, blob, 0)
        fs.close(fd)


def _bits(t):
    """A leaf as comparable numpy bits: bfloat16 through its 16-bit pattern."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_both_packages_write_the_same_file(encoding, moment_dtype):
    state = _jax_state(moment_dtype)
    nv, fs, jnv, jfs = _fs_pair()
    JManager(jfs, encoding=encoding).save(17, state)
    CheckpointManager(fs, encoding=encoding).save(17, params_from_numpy(state, "cpu"))
    assert _files(fs, 17) == _files(jfs, 17)
    nv.shutdown()
    jnv.shutdown()


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(encoding, moment_dtype):
    state = _jax_state(moment_dtype)
    nv, fs, jnv, jfs = _fs_pair()
    jmgr = JManager(jfs, encoding=encoding)
    jmgr.save(17, state)
    jback = jmgr.restore(state)
    _put_files(fs, _files(jfs, 17))
    mgr = CheckpointManager(fs, encoding=encoding)
    assert mgr.latest_step() == 17
    like = params_from_numpy(state, "cpu")
    got = mgr.restore(like)
    for (key, a), (_, like_leaf), b, orig in zip(flatten(got), flatten(like),
                                                 jax.tree.leaves(jback), jax.tree.leaves(state)):
        assert a.dtype == like_leaf.dtype and tuple(a.shape) == np.shape(orig), key
        np.testing.assert_array_equal(_bits(a), _bits(b))       # what JAX restores
        if encoding != codec.ENC_INT8 or a.dtype != torch.float32 or a.numel() < 256:
            np.testing.assert_array_equal(_bits(a), _bits(orig))   # lossless leaves
    nv.shutdown()
    jnv.shutdown()


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_port_checkpoint_restores_in_jax(encoding, moment_dtype):
    state = _jax_state(moment_dtype)
    tstate = params_from_numpy(state, "cpu")
    nv, fs, jnv, jfs = _fs_pair()
    mgr = CheckpointManager(fs, encoding=encoding)
    mgr.save(17, tstate)
    back = mgr.restore(tstate)
    _put_files(jfs, _files(fs, 17))
    jmgr = JManager(jfs, encoding=encoding)
    assert jmgr.latest_step() == 17
    got = jmgr.restore(state)
    for a, (key, b), orig in zip(jax.tree.leaves(got), flatten(back), jax.tree.leaves(state)):
        assert np.asarray(a).dtype == np.asarray(orig).dtype, key
        np.testing.assert_array_equal(_bits(a), _bits(b))
        if encoding != codec.ENC_INT8 or np.asarray(orig).dtype != np.float32 or orig.size < 256:
            np.testing.assert_array_equal(_bits(a), _bits(orig))
    nv.shutdown()
    jnv.shutdown()


def test_zstd_record_without_zstandard_fails_loudly(monkeypatch):
    """A zstd record needs the package to read, as in the JAX codec; a
    write without it falls back to zlib and records so."""
    nv, fs, jnv, _ = _fs_pair()
    monkeypatch.setattr(codec, "zstandard", None)
    w = codec.Writer(fs, "/z.ckpt", encoding=codec.ENC_ZSTD)
    w.put_leaf("x", torch.arange(300, dtype=torch.float32))
    w.finish()
    r = codec.Reader(fs, "/z.ckpt")
    assert torch.equal(r.read_leaf("x"), torch.arange(300, dtype=torch.float32))
    (_p, _s, _e, off, ln), = r.index
    rec = fs.pread(r.fd, ln, off)
    hlen = int.from_bytes(rec[:4], "little")
    assert codec.unpackb(rec[8:8 + hlen])["enc"] == codec.ENC_ZLIB
    with pytest.raises(ImportError, match="zstandard"):
        codec._decompress(b"", used_zlib=False)
    nv.shutdown()
    jnv.shutdown()


def test_resharded_restore_reads_rows():
    nv, fs, jnv, _ = _fs_pair()
    x = torch.arange(4000 * 8, dtype=torch.float32).reshape(4000, 8)
    w = codec.Writer(fs, "/rows.ckpt", chunk_bytes=4096)
    w.put_leaf("x", x)
    w.finish()
    r = codec.Reader(fs, "/rows.ckpt")
    assert torch.equal(r.read_leaf("x", rows=(100, 1900)), x[100:1900])
    assert r.leaf_paths() == ["x"]
    nv.shutdown()
    jnv.shutdown()
