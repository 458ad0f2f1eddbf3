"""Device operations of the port. Nothing is imported eagerly: each method
imports the ops module it runs, and the CUDA kernels build at first use."""
