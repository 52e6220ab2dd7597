"""PyTorch/CUDA port of flashe_tpu: FLASHE secure aggregation and the
federated training around it (the model zoo, the local trainer, the HomoNN
roles), on the card.

    python -m flashe_tpu_torch submit -c examples/configs/cnn_flashe_q16_b1_pad.json

The package mirrors ``flashe_tpu``'s module paths and imports no JAX; the
JAX package stays the reference that the tests hold this one against.
"""
