"""utils layer of the PyTorch port (mirrors fakepta_tpu.utils)."""
