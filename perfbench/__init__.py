"""The port's benchmark: ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``perfbench/harness.py``)."""
