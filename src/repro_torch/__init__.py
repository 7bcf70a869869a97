"""repro_torch — Split Annotations (Mozart) in PyTorch, with CUDA kernels
written by hand for Hopper.  The counterpart of the JAX package ``repro``;
it imports torch, numpy and the standard library only."""
