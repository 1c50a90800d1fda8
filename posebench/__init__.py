"""The benchmark of the PyTorch and CUDA port (``posebench/README.md``)."""
