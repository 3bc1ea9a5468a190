"""Port of espnet_slurp_tpu/tasks/."""
