"""The port's benchmark: one cell of BENCHMARK.json run once by
``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``.

Everything a cell needs is found by name under this folder:
``workloads/<cell>.json`` (its configuration, traffic mix, chips and
limits), ``configs/<config>.json`` (the port's flags at published
widths), ``traffic/<mix>.json`` (parameters of a generator in
``traffic/<generator>.py``), ``reference/<model>.py`` (the plain
reference, its initial weights and its FLOP count) and
``metrics/<metric>.py`` (one reader per per-layer metric)."""
