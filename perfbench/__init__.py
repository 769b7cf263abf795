"""The benchmark of ``ragraph_tpu_torch`` (see ``BENCHMARK.json`` and
``PERF.md``): ``python3 -m perfbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``."""
