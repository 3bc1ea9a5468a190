"""Port of espnet_slurp_tpu/ops/."""
