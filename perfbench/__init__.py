"""The benchmark of openwakeword_tpu_torch: ``perfbench/run.py`` runs one
cell of ``BENCHMARK.json`` (see its docstring)."""
