"""Device meshes for the port: one process per GPU, explicit collectives.

Counterpart of halva_tpu/parallel/. `mesh.py` builds a {data, model} mesh on
a torch `DeviceMesh` and holds the collectives; `partition.py` gives every
leaf its spec (the reference's PartitionSpec, as a tuple) and places this
rank's shard of a tree; `context.py` is context-parallel attention on K1-K3's
`q_offset`.
"""
