"""The benchmark's plain reference: Connect-4 rules, the policy-value net,
its SGD step, the PUCT search with root noise and the ring's bit-plane
decoding, written from the published semantics in plain PyTorch and NumPy.

Nothing here imports the program under test (``custom_alphazero_tpu_torch``)
or the JAX package, and nothing takes a weight, table or state the program
made: weights come from the checkpoint file itself, read by
``msgpack_reader``.
"""
