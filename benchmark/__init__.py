"""The benchmark of flashe_tpu_torch, the PyTorch and CUDA port: federated
rounds timed end to end on one card, their layers read from the program's
phases and counters and from the profiler, and their outputs held against
the plain reference in `benchmark/reference`.  `python3 benchmark/run.py
--workload CELL --seed N --seconds S --trace 0|1`; the cells are
BENCHMARK.json's."""
