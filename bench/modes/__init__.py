"""Timed loops, one module per ``mode`` of a cell file."""
