"""The benchmark of `xrslam_tpu_torch` on one H100: the cells of the
repository's `BENCHMARK.json`, each a configuration (`configs/`) under
a traffic mix (`traffic/`), per-layer readers (`metrics/`), and the
plain reference that decides whether a run was correct
(`reference.py`, `check.py`).

    python3 -m vio_bench.run --workload euroc.stream1 --seed 7 --seconds 51 --trace 0

Its tests run on the CPU with `python -m pytest vio_bench/tests`; the
one that needs a card (marked `gpu`) runs there with the same command.
"""
