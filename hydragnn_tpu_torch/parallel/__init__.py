"""Data-parallel training across processes (counterpart:
hydragnn_tpu/parallel/, its data-parallel half): `mesh` (the process
group, the shard-count policy, ZeRO's placement rule), `multiprocess`
(data slicing and the small collectives that keep every rank's program
the same) and `spmd` (the train, eval and predict steps of one rank, and
ZeRO's partition of the optimizer state)."""
