"""The paper's figure benchmarks on the port (``repro_torch.launch.
engine_bench``) count what the originals (``benchmarks/``) count.

One ``run_all --quick`` of each side runs in a subprocess of its own, both
at once, each into the test's temporary directory.  Their JSON trees have
the same leaves, and every op, byte and scan count among them is equal:
the leaves named in ``COUNTS``.  Timings, and the ratios and counts that
follow the drain threads' timing, differ from run to run and are not
compared; neither is any timed ratio (the >= 1.5x rebalance, the legacy
speedups), which six test workers sharing the CPU would make flaky.

``COUNTS`` is every leaf name whose every leaf agreed across 30
``--quick`` runs (15 of each side) made at once in groups of up to 12
processes, some beside one busy process per core, less the policy
settings, labels and timings.  ``backend_page_writes``,
``backend_pwrites``, ``nvmm_pwbs``, ``nvmm_fences``, ``cleanup_batches``,
``drain_extents`` and the route counters varied in some figure there.

Also: ``run_all``'s ``--out`` defaults to ``build/engine_bench.json``,
never a tracked file, and ``run kern`` refuses with its reason.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from repro_torch.launch.engine_bench import run, run_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = frozenset((
    "backend_bytes", "backend_page_reads", "backend_preads", "byte_reduction_x", "bytes",
    "coalesce_span_batches", "commit_spans", "committed_bytes", "create", "dirty_misses",
    "drain_span_merges", "entries_inspected_per_miss", "files", "flight_records",
    "flushed_bytes", "flushed_per_committed_byte", "ftruncate", "log_full_scans",
    "mode_migrations", "nvmm_psyncs", "nvmm_stored_bytes",
    "page_writes_per_committed_byte_entry_at_a_time", "paged_frame_writes",
    "paged_writebacks", "pages", "persisted_bytes", "persisted_bytes_per_committed_byte_log",
    "persisted_bytes_per_committed_byte_paged", "persisted_per_committed_byte",
    "read_op_reduction_x", "read_ops_per_byte", "read_ops_per_byte_readahead1",
    "readahead_hit_rate", "readahead_loads", "readahead_pages", "reads", "rename",
    "replay_entries", "txns", "uniform_migrations", "unlink", "writes", "writes_per_page"))


def leaves(tree, path=""):
    """{path: value} of every leaf of a JSON tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, f"{path}[{i}]").items()}
    return {path: tree}


def _name(path):
    return re.sub(r"\[\d+\]$", "", path.rsplit("/", 1)[-1])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(original, twin): one ``run_all --quick`` each, run at once."""
    out = tmp_path_factory.mktemp("engine_bench")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    cmds = {"original": [sys.executable, os.path.join(REPO, "benchmarks", "run_all.py")],
            "twin": [sys.executable, "-m", "repro_torch.launch.engine_bench.run_all"]}
    procs = {side: subprocess.Popen(cmd + ["--quick", "--out", str(out / f"{side}.json")],
                                    cwd=out, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for side, cmd in cmds.items()}
    trees = {}
    for side, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        assert f"wrote {out / side}.json" in stdout
        trees[side] = json.loads((out / f"{side}.json").read_text())
    return trees["original"], trees["twin"]


def test_the_twin_counts_what_the_original_counts(both):
    original, twin = (leaves(t) for t in both)
    assert set(twin) == set(original)
    counted = sorted(k for k in original if _name(k) in COUNTS)
    assert {_name(k) for k in counted} == COUNTS
    assert len(counted) >= 130 and sum(1 for k in counted if original[k]) >= 80
    differ = {k: (original[k], twin[k]) for k in counted if twin[k] != original[k]}
    assert not differ, differ
    assert twin["/meta/quick"] is True and twin["/meta/git_sha"] == original["/meta/git_sha"]


def test_the_twin_s_counts_are_sane(both):
    """The figures' own verdicts that are counts: no full log scan, the
    readahead ramp reads fewer ops a byte, the legacy stores ran every
    transaction."""
    _, twin = both
    flat = leaves(twin)
    assert all(v == 0 for k, v in flat.items() if _name(k) == "log_full_scans")
    assert twin["cold_read"]["read_op_reduction_x"] > 1
    assert all(row["txns"] == 60 for row in twin["legacy"]["detail"])


def test_run_all_writes_under_build_by_default(both, tmp_path, monkeypatch, capsys):
    """``main`` with no ``--out`` (the run itself replaced by the result
    above) writes ``build/engine_bench.json`` under the working directory
    and nowhere else."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["run_all"])
    monkeypatch.setattr(run_all, "run", lambda quick: both[1])
    run_all.main()
    assert sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*")) == [
        "build", "build/engine_bench.json"]
    assert json.loads((tmp_path / "build" / "engine_bench.json").read_text()) == both[1]
    assert "wrote build/engine_bench.json" in capsys.readouterr().out


def test_run_refuses_kern_with_its_reason(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run", "fig4", "kern"])
    with pytest.raises(SystemExit) as e:
        run.main()
    assert e.value.code == run.KERN_REFUSED and "bench_attention" in e.value.code
