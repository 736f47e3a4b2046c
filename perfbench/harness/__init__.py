"""The benchmark harness of the PyTorch/CUDA port (see perfbench/README.md)."""
