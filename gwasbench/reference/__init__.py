"""The plain reference of the benchmark: NumPy and SciPy only. It imports
nothing of the program, nor jax, nor hail_tpu."""
