"""The benchmark of `lavie_tpu_torch`, the PyTorch and CUDA port of LaVie,
on NVIDIA H100 cards: `python3 port_bench/run.py --workload <cell> ...`
(run.py). Reads its cells, configurations, traffic and metrics from
BENCHMARK.json and the files beside this one."""
