"""PyTorch/CUDA port of flashe_tpu: one FLASHE secure-aggregation round.

The package mirrors ``flashe_tpu``'s module paths and imports no JAX; the
JAX package stays the reference that the tests hold this one against.
"""
