"""Microbenchmarks of single kernels at the shapes the JAX package's
`tools/microbench/` times them."""
