"""Device stages of the port: the wide-aux BWT, the wide coder's lane
schedule and kernels, and the CUDA kernel loader."""
