"""Port of espnet_slurp_tpu/train/."""
