"""Array kernels in plain JAX: blocked Cholesky, double-double."""
