"""Kernel probes: variants of the port's kernels that split a kernel's cost
into its parts. No entry point of the port calls them; ``chip_smoke.py``
launches them beside the kernels they split."""
