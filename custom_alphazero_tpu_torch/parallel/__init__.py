"""Multi-rank runs: the process group, the (data, model) mesh, the
sharded phases and a local launcher."""
