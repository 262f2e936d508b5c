"""Device operators: the hand-written CUDA kernels and the fused
segmented reductions around them."""
