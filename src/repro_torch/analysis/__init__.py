"""Roofline analysis of the port (port of ``repro/analysis/``): model
FLOPs, a step's measured dot FLOPs and least bytes, and the three
roofline terms on one NVIDIA H100."""
