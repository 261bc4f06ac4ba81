"""Plain PyTorch references of the benchmark's model families, float32 with
TF32 off. They import nothing of the program and take only the weights and
inputs the benchmark made."""
