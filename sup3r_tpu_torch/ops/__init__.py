"""Device ops of the port: the reflect-conv block and the hand-written
CUDA kernels that replace the JAX package's Pallas kernels."""
