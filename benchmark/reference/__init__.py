"""The plain fp32 reference of the benchmark: imports neither JAX, nor the
JAX package, nor the program under test."""
