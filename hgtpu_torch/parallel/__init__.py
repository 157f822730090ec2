"""The production typing path over a mesh of shards (port of
hgtpu/parallel).

``sharded.Mesh`` is the mesh (shard devices and an optional
``torch.distributed`` group), with hgtpu's step functions;
``e2e.ShardedTyper`` holds one gene's device tables and its place, spell
and count passes, run once per shard (on one CUDA shard, replayed as
CUDA graphs by ``graphs.PassGraphs``); ``production.type_reads_device``
runs them and rescues the punt mask through the host engine;
``multihost`` joins processes and merges their results losslessly.
"""
