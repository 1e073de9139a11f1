"""Compute kernels: geometry helpers, the XLA scatter/gather backend and the
one-hot contraction backend, and the registry that selects between them."""
