"""Plain PyTorch operations: the semantics and the kernels' twins."""
