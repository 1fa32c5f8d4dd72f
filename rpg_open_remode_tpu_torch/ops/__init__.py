"""Per-pixel seed operations, the matcher and the denoiser, with the CUDA kernel wrappers."""
