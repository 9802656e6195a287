"""PyTorch/CUDA port of the Kernelet reproduction (see README.md)."""
