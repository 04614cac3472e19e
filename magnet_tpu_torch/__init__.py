"""PyTorch / CUDA port of magnet_tpu (H100).  See README.md, "PyTorch / H100 port"."""
