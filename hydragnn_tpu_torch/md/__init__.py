"""Molecular dynamics on the served model (counterpart: hydragnn_tpu/md):
the exact-grid velocity-Verlet integrator, MD in the loop (`loop.run_md`)
and the device-resident trajectory farm."""
