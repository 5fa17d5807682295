"""The benchmark of posetpu_torch: ``python3 -m benchmark.run`` (README.md)."""
