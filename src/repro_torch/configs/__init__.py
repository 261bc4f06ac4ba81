"""Workflow configurations of the torch port (the paper's Sect. 5 workflow)."""
