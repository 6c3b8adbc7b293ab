"""Hand-written Hopper kernels (K1 pdist in CUDA C++, K2 GMM step in
Triton), their plain PyTorch versions (``ref``) and the dispatching
wrappers (``ops``)."""
