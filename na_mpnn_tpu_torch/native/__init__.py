"""Host C++ of the port (``na_parse.cc``, the structure tokenizer); built on
first use by ``na_mpnn_tpu_torch.data.native_loader``."""
