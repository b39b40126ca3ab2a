"""PyTorch / CUDA port of custom_alphazero_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module layout. The package ``__init__`` imports
nothing; import the submodules you need.
"""
