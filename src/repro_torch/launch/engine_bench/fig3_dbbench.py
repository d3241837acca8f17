"""Fig. 3 — db_bench-style workloads over kvlite on the seven stacks,
plus the journal-mode legacy workloads (PR 5).

Write-heavy: fillseq / fillrandom / overwrite (synchronous mode — every put
durable).  Read-heavy: readrandom / readseq.  The paper's claims checked:
NVCache+SSD >= 1.9x over the other large-storage stacks (DM-WriteCache,
SSD) on write-heavy loads; read-heavy roughly tied across stacks.

``run_journal_workload`` drives the §IV application protocols through
:mod:`repro.storage.legacy`: SQLite rollback-journal transactions (journal
fsync + db fsync + unlink per txn), SQLite WAL transactions (WAL append +
periodic checkpoint/ftruncate), and RocksDB-style sync puts (WAL fsync per
put, MANIFEST rename + WAL unlink per flush) — metadata-heavy commit paths
the durable namespace makes crash-safe over NVCache.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.launch.engine_bench.backends import ALL_STACKS, make_stack
from repro_torch.storage.kvlite import KVLite
from repro_torch.storage.legacy import RocksLite, SQLiteRollbackDB, SQLiteWALDB

VALUE = 4096
KEY = 16


def _keys(n, *, shuffle, seed=7):
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    return [f"k{i:014d}".encode() for i in idx]


def run_workload(stack_name: str, workload: str, n_ops: int):
    st = make_stack(stack_name, log_mib=max(64, n_ops * VALUE * 1.5 / 1e6))
    val = b"v" * VALUE
    try:
        db = KVLite(st.fs, sync=True)
        t0 = time.perf_counter()
        if workload == "fillseq":
            for k in _keys(n_ops, shuffle=False):
                db.put(k, val)
        elif workload == "fillrandom":
            for k in _keys(n_ops, shuffle=True):
                db.put(k, val)
        elif workload == "overwrite":
            base = _keys(max(16, n_ops // 4), shuffle=False)
            for k in base:
                db.put(k, val)
            rng = np.random.default_rng(3)
            t0 = time.perf_counter()
            for i in rng.integers(0, len(base), n_ops):
                db.put(base[i], val)
        elif workload in ("readrandom", "readseq"):
            keys = _keys(n_ops, shuffle=False)
            for k in keys:
                db.put(k, val)
            if st.nv is not None:
                st.nv.flush()
            t0 = time.perf_counter()
            for k in (_keys(n_ops, shuffle=True) if workload == "readrandom" else keys):
                assert db.get(k) is not None
        dt = time.perf_counter() - t0
        return {"stack": stack_name, "workload": workload, "ops": n_ops,
                "seconds": dt, "ops_per_s": n_ops / dt,
                "mib_per_s": n_ops * VALUE / dt / (1 << 20)}
    finally:
        st.close()


JOURNAL_MODELS = ["sqlite-rj", "sqlite-wal", "rocksdb"]


def run_journal_workload(stack_name: str, model: str, n_txn: int):
    """One journal-mode legacy workload on one stack; returns txn/s."""
    st = make_stack(stack_name, log_mib=max(64, n_txn * 0.05))
    try:
        if model == "sqlite-rj":
            db = SQLiteRollbackDB(st.fs, page_size=4096, npages=32)
            t0 = time.perf_counter()
            for t in range(1, n_txn + 1):
                db.commit(t)
            db.close()
        elif model == "sqlite-wal":
            db = SQLiteWALDB(st.fs, page_size=4096, npages=32)
            t0 = time.perf_counter()
            for t in range(1, n_txn + 1):
                db.commit(t)
                if t % 16 == 0:
                    db.checkpoint()
            db.close()
        elif model == "rocksdb":
            db = RocksLite(st.fs)
            val = b"v" * 4096
            t0 = time.perf_counter()
            for i in range(1, n_txn + 1):
                db.put(f"k{i % 97:08d}".encode(), val)
                if i % 64 == 0:
                    db.flush()
            db.close()
        else:
            raise KeyError(model)
        dt = time.perf_counter() - t0
        row = {"stack": stack_name, "model": model, "txns": n_txn,
               "seconds": dt, "txn_per_s": n_txn / dt}
        if st.nv is not None:
            s = st.nv.stats()
            row["meta_ops"] = s["meta_ops"]
            row["log_full_scans"] = s["log_full_scans"]
        return row
    finally:
        st.close()


def run_journal(n_txn: int = 300, stacks=("nvcache+ssd", "ssd"),
                models=None):
    rows = []
    for model in (models or JOURNAL_MODELS):
        for s in stacks:
            rows.append(run_journal_workload(s, model, n_txn))
            r = rows[-1]
            print(f"fig3-journal/{model}/{s},{1e6 * r['seconds'] / n_txn:.1f}us,"
                  f"{r['txn_per_s']:.0f}txn/s", flush=True)
    return rows


def run(n_ops: int = 2000, stacks=None, workloads=None):
    rows = []
    for wl in (workloads or ["fillseq", "fillrandom", "readrandom"]):
        for s in (stacks or ALL_STACKS):
            rows.append(run_workload(s, wl, n_ops))
            r = rows[-1]
            print(f"fig3/{wl}/{s},{1e6 * r['seconds'] / n_ops:.1f},"
                  f"{r['mib_per_s']:.1f}MiB/s", flush=True)
    return rows


if __name__ == "__main__":
    run()
