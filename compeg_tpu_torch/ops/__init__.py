"""Device ops of compeg_tpu_torch: hand-written CUDA kernels with their plain
PyTorch twins (entropy, idct, fused) and the kernel build (_build)."""
