"""Language models of the torch port: the attention-only decoder families
(dense, vlm, audio) with their serving entry points."""
