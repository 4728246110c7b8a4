"""The benchmark's reference: ``frozen/``, the port's plain PyTorch path
frozen as it was when the benchmark was made. It imports nothing of
coslam_torch."""
