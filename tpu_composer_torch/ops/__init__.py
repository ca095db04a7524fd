"""Attention ops and their Hopper kernels (see ``csrc/``)."""
