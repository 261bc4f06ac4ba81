"""Language models of the torch port: every architecture family (dense, MoE,
the Jamba hybrid with Mamba mixers, RWKV-6, vlm and audio), with their
serving entry points."""
