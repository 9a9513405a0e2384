"""The port's example drivers: counterparts of the JAX package's
`examples/*.py` (the profilers, the synthetic quality loops) and of
`examples/train_mscnn.sh`, run with `python3 -m
mscnn_torch.examples.<name>`; the profilers need a card."""
