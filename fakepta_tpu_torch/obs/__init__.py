"""obs layer of the PyTorch port (mirrors fakepta_tpu.obs)."""
