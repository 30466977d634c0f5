"""Hopper counterparts of the TPU probe scripts (`scripts/probe_dyngather.py`,
`scripts/probe_dyngather2.py`, `scripts/probe_iw_bwd.py`): small kernels that
answer one question about the card each, with their plain versions."""
