"""The benchmark of jmodt_torch, the PyTorch and CUDA port: one run of one
cell of BENCHMARK.json a process (`python3 -m perfbench`)."""
