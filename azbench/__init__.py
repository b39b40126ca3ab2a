"""The benchmark of ``custom_alphazero_tpu_torch`` (the PyTorch/CUDA port).

Run one cell once from the checkout's root:

    python3 -m azbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``azbench/harness.py`` for how a cell's files are found, and PERF.md for
the cells, metrics and limits. Nothing here imports JAX or the JAX package.
"""
