"""Hand-written Hopper kernels, one package per TPU kernel they replace."""
