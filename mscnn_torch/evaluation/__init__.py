"""PyTorch port of the matching `mscnn_tpu` subpackage."""
