"""The paper's figure benchmarks on the port's NVCache engine: twins of
``benchmarks/{backends,fio_like,fig3_dbbench,...,fig_obs,run_all,run}.py``.

    PYTHONPATH=src python -m repro_torch.launch.engine_bench.run_all --quick
    PYTHONPATH=src python -m repro_torch.launch.engine_bench.run fig3 fig4

Each module is its original under one rewrite, and nothing more:
``repro.`` -> ``repro_torch.`` and ``benchmarks`` -> this package in
imports, the ``sys.path.insert`` lines dropped; ``run_all`` finds the repo
root (for the git sha) from this package's depth and writes
``build/engine_bench.json`` unless ``--out`` says otherwise; ``run`` maps
``ckpt`` and ``roofline`` to ``repro_torch.launch.ckpt_bench`` and
``repro_torch.launch.roofline`` and refuses ``kern``.  Docstrings are the
originals' (their ``BENCH_*.json`` and ``benchmarks/`` paths name the JAX
package's side).  The engine is pure Python: these run on the host, and no
number they print is a device number.
"""
