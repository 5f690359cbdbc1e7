"""Message math and the CUDA kernels with their plain versions."""
