"""The port's benchmark: cells of BENCHMARK.json run against ``repro_torch``.

Run one cell with ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (see README.md).
Nothing in this package imports JAX, the JAX package or ``benchmarks/``.
"""
