"""The port's benchmark: ``python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (see README.md)."""
