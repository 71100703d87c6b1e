"""Multi-device training (counterpart: hydragnn_tpu/parallel/): `mesh`
(the process group, the shard-count policy, ZeRO's placement rule),
`multiprocess` (data slicing and the small collectives that keep every
rank's program the same), `spmd` (the train, eval and predict steps of
one rank, and ZeRO's partition of the optimizer state), `pipeline` and
`pipeline_trainer` (pipeline parallelism, its data axis of pipe rings),
`graph_parallel` (graph slots, the edge-sharded and ring layers) and
`composite` (the (data x graph) grid of `Architecture.graph_shards`)."""
