"""FIO-style random-write engines shared by Figs. 4-7: psync 4 KiB buffers,
fsync=1 semantics (synchronous durability on every stack), per-interval
instantaneous throughput + running average latency + cumulative bytes.
``concurrent_random_write`` is the numjobs=N variant used by the sharded-log
scaling experiment.

Per-op commit latency is recorded into a :class:`repro.obs.metrics`
histogram (per-thread cells, so N writers never contend on it) and every
result carries a ``lat`` snapshot with p50/p95/p99 — fio's
``clat percentiles``, not just the running average."""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.obs.metrics import Histogram


def random_write(fs, *, total_mib: float, file_mib: float, bs: int = 4096,
                 interval_s: float = 0.05, path="/fio.dat", seed=11,
                 read_fraction: float = 0.0):
    fd = fs.open(path)
    rng = np.random.default_rng(seed)
    n_ops = int(total_mib * (1 << 20)) // bs
    n_slots = max(1, int(file_mib * (1 << 20)) // bs)
    buf = b"x" * bs
    samples = []
    hist = Histogram("fio.clat_us")
    t_start = time.perf_counter()
    t_mark, ops_mark = t_start, 0
    lat_sum = 0.0
    done_reads = 0
    for i in range(n_ops):
        off = int(rng.integers(0, n_slots)) * bs
        t0 = time.perf_counter()
        if read_fraction and rng.random() < read_fraction:
            fs.pread(fd, bs, off)
            done_reads += 1
        else:
            fs.pwrite(fd, buf, off)
            fs.fsync(fd)
        dt = time.perf_counter() - t0
        hist.record_ns(int(dt * 1e9))
        lat_sum += dt
        now = time.perf_counter()
        if now - t_mark >= interval_s:
            samples.append({
                "t": now - t_start,
                "inst_mib_s": (i + 1 - ops_mark) * bs / (now - t_mark) / (1 << 20),
                "avg_lat_us": 1e6 * lat_sum / (i + 1),
                "cum_mib": (i + 1) * bs / (1 << 20),
            })
            t_mark, ops_mark = now, i + 1
    total = time.perf_counter() - t_start
    return {
        "seconds": total,
        "mib_per_s": n_ops * bs / total / (1 << 20),
        "avg_lat_us": 1e6 * lat_sum / max(1, n_ops),
        "lat": hist.snapshot(),
        "samples": samples,
        "writes": n_ops - done_reads,
        "reads": done_reads,
    }


def _concurrent_write(fs, *, threads: int, total_mib: float, bs: int,
                      interval_s: float, path_tmpl: str, make_offsets):
    """Shared N-writer engine (fio numjobs=N), synchronous durability on
    every op.  ``make_offsets(t)`` returns the per-thread ``i -> offset``
    access pattern.  The returned ``mib_per_s`` is *committed-write*
    throughput: a pwrite only returns once its group is durable, so bytes
    written per wall second == bytes committed per second."""
    n_ops = int(total_mib * (1 << 20)) // bs
    per_thread = max(1, n_ops // threads)
    buf = b"x" * bs
    done = [0] * threads
    lat = [0.0] * threads
    hist = Histogram("fio.clat_us")      # per-thread cells: no contention
    finished = threading.Event()

    def worker(t):
        fd = fs.open(path_tmpl.format(t=t))
        offset = make_offsets(t)
        for i in range(per_thread):
            off = offset(i)
            t0 = time.perf_counter()
            fs.pwrite(fd, buf, off)
            fs.fsync(fd)
            dt = time.perf_counter() - t0
            hist.record_ns(int(dt * 1e9))
            lat[t] += dt
            done[t] = i + 1

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    samples = []
    t_start = time.perf_counter()
    for t in ts:
        t.start()

    def sampler():
        mark_ops, mark_t = 0, t_start
        while not finished.wait(interval_s):
            now = time.perf_counter()
            ops = sum(done)
            samples.append({
                "t": now - t_start,
                "inst_mib_s": (ops - mark_ops) * bs / (now - mark_t) / (1 << 20),
                "cum_mib": ops * bs / (1 << 20),
            })
            mark_ops, mark_t = ops, now

    s = threading.Thread(target=sampler, daemon=True)
    s.start()
    for t in ts:
        t.join()
    finished.set()
    s.join(timeout=5)
    total = time.perf_counter() - t_start
    ops = sum(done)
    return {
        "seconds": total,
        "mib_per_s": ops * bs / total / (1 << 20),
        "avg_lat_us": 1e6 * sum(lat) / max(1, ops),
        "lat": hist.snapshot(),
        "samples": samples,
        "writes": ops,
        "bytes": ops * bs,
        "threads": threads,
    }


def concurrent_seq_write(fs, *, threads: int = 4, total_mib: float,
                         bs: int = 1024, interval_s: float = 0.05,
                         path_tmpl: str = "/seq{t}.dat"):
    """Sequential ``bs``-byte writes, one file per thread — the
    small-sequential workload where drain-side page/extent coalescing pays
    (many log entries per backend page, long contiguous runs per batch)."""
    return _concurrent_write(fs, threads=threads, total_mib=total_mib, bs=bs,
                             interval_s=interval_s, path_tmpl=path_tmpl,
                             make_offsets=lambda t: lambda i: i * bs)


def concurrent_random_write(fs, *, threads: int = 4, total_mib: float,
                            file_mib: float, bs: int = 4096,
                            interval_s: float = 0.05,
                            path_tmpl: str = "/fio{t}.dat", seed: int = 11):
    """Random ``bs``-aligned writes over ``file_mib``/threads slots per
    thread, one file per thread."""
    n_slots = max(1, int(file_mib * (1 << 20)) // bs // threads)

    def make_offsets(t):
        rng = np.random.default_rng(seed + t)
        return lambda i: int(rng.integers(0, n_slots)) * bs

    return _concurrent_write(fs, threads=threads, total_mib=total_mib, bs=bs,
                             interval_s=interval_s, path_tmpl=path_tmpl,
                             make_offsets=make_offsets)
