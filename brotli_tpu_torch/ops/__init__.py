"""Device half: the segment optimal-parse DP and its CUDA kernels."""
