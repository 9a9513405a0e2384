"""Profiling probes of the port: counterparts of the JAX package's
`examples/profile_*.py` scripts, run with `python3 -m
mscnn_torch.examples.<name>` on a machine with a card."""
