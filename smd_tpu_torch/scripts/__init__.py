"""Dataset scripts of the port, run as ``python -m
smd_tpu_torch.scripts.<name>``: ``transform_encoded_data`` and
``generate_compressed_transform``."""
