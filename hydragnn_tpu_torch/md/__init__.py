"""Molecular dynamics on the served model (counterpart: hydragnn_tpu/md):
the exact-grid velocity-Verlet integrator and the MD-in-the-loop driver."""
