"""Ops of the port: the reflect-conv block and the hand-written CUDA
kernels that replace the JAX package's Pallas kernels, plus the array
math the forward pass shares with the data plane (wind rotation,
coarsening, level interpolation, solar position, the device output
pack)."""
