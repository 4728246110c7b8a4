"""geometry (PyTorch port; see the same-named package of coslam_tpu)."""
