"""Hand-written CUDA kernels of the torch port, each beside its plain
PyTorch version (``ref.py``), its binding (``kernel.py``) and its public ops
(``ops.py``)."""
