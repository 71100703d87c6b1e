"""Drivers of the JAX package's example scripts, on the port: `gfm` (the
multi-dataset GFM mixture, examples/gfm/train_gfm.py) and `multidataset`
(examples/multidataset/train.py on the members the port reads)."""
