"""Language models of the torch port: the attention families (dense, vlm,
audio) and RWKV-6, with their serving entry points."""
